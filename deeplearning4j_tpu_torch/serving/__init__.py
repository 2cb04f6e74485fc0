"""Serving runtime: the micro-batcher, the replica set, stats, the paged
KV pool, the decode engine, the HTTP model server, the publication
store its live reload reads, and the front-door router over N hosts."""

from deeplearning4j_tpu_torch.serving.batcher import (BatcherDeadError,
                                                      MicroBatcher,
                                                      QueueFullError,
                                                      next_bucket)
from deeplearning4j_tpu_torch.serving.decode import (DecodeEngine,
                                                     DecodeSession,
                                                     StreamingKVForward)
from deeplearning4j_tpu_torch.serving.fleet import Replica, ReplicaSet
from deeplearning4j_tpu_torch.serving.kvcache import (CachePoolFullError,
                                                      KVPagePool)
from deeplearning4j_tpu_torch.serving.metrics import ServingStats
from deeplearning4j_tpu_torch.serving.publish import (Publication,
                                                      WeightStore, load_net)
from deeplearning4j_tpu_torch.serving.router import (FrontDoorRouter,
                                                     HostHandle, NoHostsError)
from deeplearning4j_tpu_torch.serving.server import (DeadlineExceededError,
                                                     ModelServer,
                                                     UnknownSessionError,
                                                     serve)

__all__ = ["ModelServer", "serve", "MicroBatcher", "QueueFullError",
           "BatcherDeadError", "DeadlineExceededError",
           "UnknownSessionError", "ServingStats", "Replica", "ReplicaSet",
           "DecodeEngine", "DecodeSession", "StreamingKVForward",
           "KVPagePool", "CachePoolFullError", "next_bucket",
           "FrontDoorRouter", "HostHandle", "NoHostsError",
           "WeightStore", "Publication", "load_net"]
