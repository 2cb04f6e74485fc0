"""Clustering suite (counterpart of deeplearning4j_tpu/clustering;
parity: deeplearning4j-core clustering/ — k-means on the card, the
spatial trees and the SPTree on the host)."""

from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_tpu_torch.clustering.sptree import QuadTree, SPTree
from deeplearning4j_tpu_torch.clustering.trees import KDTree, VPTree

__all__ = ["KDTree", "KMeansClustering", "QuadTree", "SPTree", "VPTree"]
