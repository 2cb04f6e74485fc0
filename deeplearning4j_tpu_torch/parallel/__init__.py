"""Parallel training (counterpart of deeplearning4j_tpu/parallel; parity:
deeplearning4j-scaleout's ParallelWrapper and Spark parameter averaging).

One process per rank on ``torch.distributed``: the mesh (parallel/mesh.py)
names the ranks' axes, the 'data' axis splits the batch, parameters are
replicated, and the gradient average is one all-reduce inside the train
step (parallel/data_parallel.py), captured with it on NCCL. A 'model'
axis shards a MultiLayerNetwork's parameters (parallel/tensor.py: the
layers compute on their shards, Megatron style). There is no parameter
server and no driver. The reference's ParameterAveraging *semantics*
(average every k local steps) is ``ParallelWrapper`` (one process) and
``distributed.MultiProcessLocalSGD`` (across processes).

ComputationGraph tensor parallelism and mesh serving wait for
ROADMAP.md A.5 part 2, pipeline, sequence and expert parallelism for its
part 3; the supervisor's cross-process coordination over
``distributed`` is ported (resilience/).
"""

from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    apply_mesh,
    shard_step,
    shard_batch,
    ParallelWrapper,
)

__all__ = ["make_mesh", "apply_mesh", "shard_step", "shard_batch",
           "ParallelWrapper"]
