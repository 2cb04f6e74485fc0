"""Multi-process embedding training — the Spark word2vec tier
(counterpart of deeplearning4j_tpu/nlp/distributed.py).

Parity: dl4j-spark-nlp's map-side SkipGram
(spark/dl4j-spark-nlp/.../word2vec/Word2VecPerformer.java:46 applies
word2vec updates inside Spark partitions against driver-broadcast vocab
and weights; FirstIterationFunction/SecondIterationFunction shard the
corpus). Every process builds the IDENTICAL vocab + Huffman tree from the
full corpus (deterministic construction replaces the driver broadcast),
trains the batched SkipGram/CBOW updates (nlp/sequence_vectors.py) on its
strided corpus shard, and the embedding tables (syn0 / syn1 / syn1neg)
are averaged across processes after every epoch: one all-gather a table
on parallel/distributed.py's group (gloo for ranks that share a card),
then the mean in float64 over the ranks in rank order, cast back — the
JAX package's ``process_allgather`` average. The group's collective
timeout (``collective_timeout_s``) bounds every gather; a gather that
fails asks the peers whether they are alive (``check_peers``), so a dead
rank is named.

Equivalence contract (statistical, not bitwise against one process — the
update ORDER differs by construction, as the reference's Hogwild and
Spark modes differ): the processes end bit-identical to EACH OTHER, and
each epoch's tables are the float64 mean of what each shard's training
gives.
"""

from __future__ import annotations

from typing import Iterable, List

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel import distributed
from deeplearning4j_tpu_torch.parallel.stats import TrainingStatsCollector


@torch.no_grad()
def _average_across_processes(table: torch.Tensor) -> torch.Tensor:
    """Replaces ``table``, in place, by its element-wise mean across the
    processes (the processResults aggregate/divide of
    ParameterAveragingTrainingMaster.java:851-877, as one all-gather):
    summed in float64 in rank order, divided by the count, rounded once
    to the table's dtype."""
    buf = table.detach().to(distributed._comm_device()).contiguous()
    got = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    try:
        dist.all_gather(got, buf)
    except RuntimeError as e:
        distributed.check_peers(e, name="nlp_average")
        raise
    acc = got[0].to(torch.float64)
    for g in got[1:]:
        acc += g.to(torch.float64)
    return table.copy_((acc / len(got)).to(table.dtype))


class MultiProcessSequenceVectors:
    """Wrap a SequenceVectors/Word2Vec/ParagraphVectors trainer for
    multi-process corpus-sharded training over the process group that
    ``parallel.distributed.initialize`` joined."""

    def __init__(self, vectors, shard: bool = True):
        self.vectors = vectors
        self.shard = shard
        self.stats = TrainingStatsCollector(
            worker_id=f"worker_{self.process_index}")

    @property
    def process_index(self) -> int:
        return distributed.process_info()["process_index"]

    @property
    def process_count(self) -> int:
        return distributed.process_info()["process_count"]

    def _local_shard(self, sequences: List[List[str]]) -> List[List[str]]:
        if not self.shard or self.process_count == 1:
            return sequences
        return sequences[self.process_index::self.process_count]

    def average_now(self):
        with self.stats.time_phase("average"):
            lt = self.vectors.lookup
            _average_across_processes(lt.syn0)
            if getattr(lt, "syn1", None) is not None:
                _average_across_processes(lt.syn1)
            if getattr(lt, "syn1neg", None) is not None:
                _average_across_processes(lt.syn1neg)
        return self

    def fit(self, sequences: Iterable[List[str]]):
        """Vocab from the FULL corpus on every process (identical by
        determinism), per-epoch training on the local shard, table
        averaging after each epoch."""
        sequences = list(sequences)
        v = self.vectors
        if v.vocab is None:
            with self.stats.time_phase("vocab"):
                v.build_vocab(sequences)
        local = self._local_shard(sequences)
        epochs = v.config.epochs
        lr0 = v.config.learning_rate
        # drive the inner trainer one epoch at a time so the averaging
        # schedule sits between epochs (Word2VecPerformer's per-iteration
        # map/aggregate rounds collapse to this under LocalSGD semantics);
        # each call is handed its WINDOW of the global linear lr schedule
        # so annealing matches a single multi-epoch run
        v.config.epochs = 1
        try:
            for e in range(epochs):
                with self.stats.time_phase("fit"):
                    v.fit(local, lr_range=(lr0 * (1 - e / epochs),
                                           lr0 * (1 - (e + 1) / epochs)))
                    if v.device.type == "cuda":
                        torch.cuda.synchronize(v.device)
                if self.process_count > 1:
                    self.average_now()
        finally:
            v.config.epochs = epochs
        return self

    # convenience delegates
    def similarity(self, a: str, b: str) -> float:
        return self.vectors.similarity(a, b)

    def get_word_vector(self, word: str):
        return self.vectors.get_word_vector(word)
