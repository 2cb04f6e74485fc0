"""Datasets, iterators and record readers (counterpart of
deeplearning4j_tpu/datasets)."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    ArrayDataSetIterator, AsyncDataSetIterator, DataSetIterator,
    DevicePrefetchIterator, IteratorDataSetIterator, ListDataSetIterator,
    MultipleEpochsIterator, ReconstructionDataSetIterator,
    SamplingDataSetIterator)
from deeplearning4j_tpu_torch.datasets.fetchers import (
    CifarDataSetIterator, CurvesDataSetIterator, IrisDataSetIterator,
    LFWDataSetIterator, MnistDataSetIterator)
from deeplearning4j_tpu_torch.datasets.records import (
    CollectionRecordReader, CSVRecordReader, RecordReaderDataSetIterator,
    SequenceRecordReaderDataSetIterator)

__all__ = ["ArrayDataSetIterator", "AsyncDataSetIterator",
           "CifarDataSetIterator", "CollectionRecordReader",
           "CSVRecordReader", "CurvesDataSetIterator", "DataSet",
           "DataSetIterator", "DevicePrefetchIterator",
           "IrisDataSetIterator", "IteratorDataSetIterator",
           "LFWDataSetIterator", "ListDataSetIterator",
           "MnistDataSetIterator", "MultiDataSet", "MultipleEpochsIterator",
           "ReconstructionDataSetIterator", "RecordReaderDataSetIterator", "SamplingDataSetIterator",
           "SequenceRecordReaderDataSetIterator"]
