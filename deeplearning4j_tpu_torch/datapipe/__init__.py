"""datapipe — the checkpointable sharded input-pipeline subsystem
(counterpart of deeplearning4j_tpu/datapipe; the JAX package's DATA.md
describes it).

The DataVec tier of this stack: composable record
pipelines — sources → map/filter/normalize → windowed shuffle →
deterministic shard → (bucket-)batch → prefetch — presented to the
trainers as an ordinary ``DataSetIterator``, with O(1) checkpointable
state (``Pipeline.state_dict()``) that the resilience supervisor threads
through its checkpoints so ``resilient_fit`` resumes mid-epoch
bit-identically from any shuffled/streaming source.

Typical use::

    from deeplearning4j_tpu_torch import datapipe

    pipe = (datapipe.from_csv("train.csv", label_index=0, num_classes=10)
            .shuffle(window=4096, seed=7)
            .shard()                       # process-aware for multihost
            .normalize()
            .batch(128, drop_last=True)
            .prefetch(2))
    net.resilient_fit(pipe, checkpoint_dir="ckpts", epochs=5)
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.datapipe.core import (Pipeline, PipelineStats, Stage,
                                              decode_record, decode_state_value,
                                              encode_record, encode_state_value)
from deeplearning4j_tpu_torch.datapipe.prefetch import PrefetchStage
from deeplearning4j_tpu_torch.datapipe.sources import (ArraySource, CSVSource,
                                                 LineSource, RecordSource)
from deeplearning4j_tpu_torch.datapipe.stages import (BatchStage, BucketBatchStage,
                                                FilterStage, MapStage,
                                                NormalizeStage,
                                                NormalizerStats, ShardStage,
                                                ShuffleStage)
from deeplearning4j_tpu_torch.datapipe.tokens import (CharTokenizer, TokenizeStage,
                                                WindowStage)

__all__ = [
    "Pipeline", "PipelineStats", "Stage",
    "ArraySource", "CSVSource", "LineSource", "RecordSource",
    "MapStage", "FilterStage", "NormalizeStage", "NormalizerStats",
    "ShuffleStage", "ShardStage", "BatchStage", "BucketBatchStage",
    "PrefetchStage",
    "CharTokenizer", "TokenizeStage", "WindowStage",
    "from_arrays", "from_csv", "from_lines", "from_records", "from_text",
    "encode_record", "decode_record",
    "encode_state_value", "decode_state_value",
]


def from_arrays(features, labels=None, *, name: str = "datapipe") -> Pipeline:
    """Pipeline over in-memory arrays: records are ``(features[i],
    labels[i])`` rows."""
    return Pipeline(ArraySource(features, labels), name=name)


def from_csv(path: str, *, skip_lines: int = 0, delimiter: str = ",",
             label_index=None, num_classes=None,
             name: str = "datapipe") -> Pipeline:
    """Streaming pipeline over a numeric CSV file (DataVec reader
    conventions — see ``datasets/records.py``)."""
    return Pipeline(CSVSource(path, skip_lines=skip_lines,
                              delimiter=delimiter, label_index=label_index,
                              num_classes=num_classes), name=name)


def from_lines(path: str, *, parse=None, skip_lines: int = 0,
               name: str = "datapipe") -> Pipeline:
    """Streaming pipeline over a text file, one record per line."""
    return Pipeline(LineSource(path, parse=parse, skip_lines=skip_lines),
                    name=name)


def from_records(record_reader, *, name: str = "datapipe") -> Pipeline:
    """Pipeline over any ``records.py``-style reader (``.records()``) or
    a plain sequence of record tuples."""
    return Pipeline(RecordSource(record_reader), name=name)


def from_text(texts, *, name: str = "datapipe") -> Pipeline:
    """Pipeline over text documents (a single string or a sequence of
    strings), one ``(text,)`` record per document — the head of the
    ``tokenize → window → bucket_batch`` language-model pipeline::

        tok = datapipe.CharTokenizer.fit(corpus)
        pipe = (datapipe.from_text(corpus)
                .tokenize(tok)
                .window(64, vocab_size=tok.vocab_size)
                .bucket_batch(8))
    """
    if isinstance(texts, str):
        texts = [texts]
    return Pipeline(RecordSource([(t,) for t in texts]), name=name)
