"""Datasets and iterators (counterpart of deeplearning4j_tpu/datasets)."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    ArrayDataSetIterator, DataSetIterator, ListDataSetIterator)

__all__ = ["ArrayDataSetIterator", "DataSet", "DataSetIterator",
           "ListDataSetIterator", "MultiDataSet"]
