"""Device-mesh helpers (counterpart of deeplearning4j_tpu/parallel/mesh.py).

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
process group's ranks, one process (and one device) per rank: the axes are
logical ('data', 'model', ...) and each axis carries the process group its
collectives run in (``axis_group``): on ``{"data": 2, "model": 2}`` ranks
0 and 1 form one model group and ranks 0 and 2 one data group. The
default is one 'data' axis over the world: pure data parallelism, the
reference's only strategy.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "axis_group", "axis_size"]


def make_mesh(axes: dict | None = None, devices=None):
    """A DeviceMesh from {axis_name: size} over ``devices`` (ranks of the
    initialized process group; default all of them), on the kind of this
    rank's device (parallel/distributed.py ``initialize``). Default axes:
    one 'data' axis over every rank. Raises when no process group is up
    (``parallel.distributed.initialize``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from deeplearning4j_tpu_torch.parallel import distributed

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call parallel.distributed."
            "initialize(...) first (a single process is a group of one)")
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    if axes is None:
        axes = {"data": len(ranks)}
    total = math.prod(axes.values())
    if total > len(ranks):
        raise ValueError(
            f"Mesh needs {total} devices but only {len(ranks)} available")
    layout = torch.tensor(ranks[:total]).reshape(list(axes.values()))
    return DeviceMesh(distributed.device().type, layout,
                      mesh_dim_names=tuple(axes))


def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s axis ``axis``."""
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    return dist.get_world_size(axis_group(mesh, axis))

