"""Graph embeddings (counterpart of deeplearning4j_tpu/graph; parity:
deeplearning4j-graph, SURVEY.md §2.7): graph API, random-walk iterators,
DeepWalk, and a real node2vec (stub-only in the reference). The walks
are host code with the JAX package's draws; the embeddings train on the
port's SequenceVectors (the card by default)."""

from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.walks import (
    RandomWalkIterator,
    WeightedRandomWalkIterator,
)
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk
from deeplearning4j_tpu_torch.graph.node2vec import Node2Vec, Node2VecWalkIterator
