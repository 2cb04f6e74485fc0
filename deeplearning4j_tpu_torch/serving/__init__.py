"""Serving runtime: micro-batcher, stats and the HTTP model server."""

from deeplearning4j_tpu_torch.serving.batcher import (MicroBatcher,
                                                      QueueFullError,
                                                      next_bucket)
from deeplearning4j_tpu_torch.serving.metrics import ServingStats
from deeplearning4j_tpu_torch.serving.server import ModelServer

__all__ = ["MicroBatcher", "ModelServer", "QueueFullError", "ServingStats",
           "next_bucket"]
