"""Elastic datapipe resharding: remap a checkpointed shard cursor onto a
different fleet size with no record dropped or doubled (counterpart of
deeplearning4j_tpu/datapipe/reshard.py).

The port runs one process, so ``TrainingSupervisor._load_into`` uses
this when a checkpoint's shard cursor was saved for another ``(n, i)``
than the live pipeline's.

A pipeline checkpoint (``Pipeline.state_dict()``) bakes the fleet size
into its shard stage: ``(n_old, i_old, k)`` where ``k`` is the number of
upstream records the shard stage has scanned this epoch. Resuming that
state on a fleet of a different size would replay the wrong residue
class — :meth:`ShardStage._load_state` refuses it. This module rewrites
the state for the new fleet.

The coverage rule
-----------------

Shard ``i`` of ``n`` owns upstream positions ``j`` with
``j % n == i``. From the checkpointed cursor:

- ``r = ceil((k - i_old) / n_old)`` — records the old shard has
  *emitted* this epoch (its owned positions below ``k``);
- ``b`` — records sitting unconsumed in buffers *downstream* of the
  shard stage (partial batch buffers, in-flight map records), which the
  remap discards;
- ``d = r - b`` — records this shard actually delivered to training;
- ``G = d * n_old`` — the **global low-water mark**: assuming the fleet
  ran in lockstep (every shard at the same consumed depth ``d``, which
  is exactly what supervisor checkpoints at batch boundaries give),
  every upstream position ``< G`` was consumed by exactly one old
  shard, and no position ``>= G`` was consumed by anyone.

The remapped state starts the new shard ``(n_new, i_new)`` at
``k = G`` with the source cursor rewound to ``G``. The new fleet's
shards then cover exactly the positions ``>= G`` in their (new) residue
classes: disjoint and covering by the same modulo argument as a fresh
epoch, so **no record is dropped or doubled** — records that were
buffered-but-unconsumed at the crash are re-read under the new cut.

Constraints (violations raise, naming the stage):

- exactly one shard stage in the chain;
- no shuffle stage anywhere across the shard boundary — a shuffle
  window holds an unbounded sample of positions whose membership cannot
  be re-cut for a different modulus without dropping or doubling;
- no filter between source and shard (a filtered stream breaks the
  source-position ↔ shard-scan-count equality the rewind relies on);
- the source must expose a ``pos`` cursor (all built-in sources do).

An identity remap (same ``(n, i)``) returns the state untouched,
buffers included — resuming on the same fleet stays bit-exact.
"""

from __future__ import annotations

import copy

__all__ = ["remap_state", "remap_for", "shard_position",
           "low_water_mark"]

# stages that may sit downstream of the shard: state key holding their
# buffered-record payload (cleared by the remap, counted into b)
_DOWNSTREAM_BUFFERS = {"batch": "buf", "map": "inflight"}
# stages safe on either side with no positional state of their own
_STATELESS = {"filter", "normalize"}


def _chain(state: dict) -> list:
    """Stage state dicts tail-first (downstream → source)."""
    out, node = [], state["stage"]
    while node is not None:
        out.append(node)
        node = node.get("upstream")
    return out


def shard_position(state: dict):
    """The checkpoint's shard cursor as ``(n, i, k)``, or None when the
    pipeline has no shard stage (single-host run)."""
    for node in _chain(state):
        if node.get("kind") == "shard":
            if "n" not in node:
                return None
            return (int(node["n"]), int(node["i"]), int(node["k"]))
    return None


def low_water_mark(state: dict):
    """The global record index ``G`` at which an elastic remap of this
    checkpointed state would re-cut the stream (see the coverage rule in
    the module docstring: ``G = (r - b) * n_old`` — every upstream
    position ``< G`` was consumed by exactly one old shard, nothing
    ``>= G`` by anyone). None when the pipeline has no shard stage.

    This is the tiling oracle a chaos run asserts against: a resumed
    fleet of ANY size must consume exactly the positions ``[G, N)``."""
    pos = shard_position(state)
    if pos is None:
        return None
    n_old, i_old, k_old = pos
    chain = _chain(state)
    shard = next(n for n in chain if n.get("kind") == "shard")
    b = sum(_buffered_count(n) for n in chain[:chain.index(shard)])
    r = max(0, -(-(k_old - i_old) // n_old))   # ceil over ints
    return max(0, (r - b)) * n_old


def _buffered_count(node: dict) -> int:
    kind = node.get("kind")
    if kind == "bucket_batch":
        return sum(len(v) for v in node.get("bufs", {}).values())
    key = _DOWNSTREAM_BUFFERS.get(kind)
    return len(node.get(key, ())) if key else 0


def _clear_buffers(node: dict):
    kind = node.get("kind")
    if kind == "bucket_batch":
        node["bufs"] = {}
    key = _DOWNSTREAM_BUFFERS.get(kind)
    if key and key in node:
        node[key] = []


def remap_state(state: dict, num_shards: int, index: int) -> dict:
    """A new ``Pipeline.state_dict()`` for shard ``index`` of
    ``num_shards``, derived from a checkpoint saved under any other
    fleet size (see the module docstring for the coverage rule). The
    input dict is not mutated."""
    num_shards, index = int(num_shards), int(index)
    if not 0 <= index < num_shards:
        raise ValueError(f"shard index {index} out of range "
                         f"[0, {num_shards})")
    state = copy.deepcopy(state)
    chain = _chain(state)

    shard_nodes = [n for n in chain if n.get("kind") == "shard"]
    if len(shard_nodes) != 1:
        raise ValueError(
            f"elastic remap needs exactly one shard stage in the "
            f"pipeline, found {len(shard_nodes)}")
    shard = shard_nodes[0]
    if "n" not in shard:
        raise ValueError(
            "shard state predates the elastic format (no (n, i) "
            "recorded) — it cannot be safely remapped; resume on the "
            "original fleet size once to refresh the checkpoint")
    n_old, i_old, k_old = (int(shard["n"]), int(shard["i"]),
                           int(shard["k"]))
    if (n_old, i_old) == (num_shards, index):
        return state                      # identity: buffers kept, bit-exact

    at = chain.index(shard)
    downstream, upstream = chain[:at], chain[at + 1:]

    for node in chain:
        if node.get("kind") == "shuffle":
            raise ValueError(
                "elastic remap cannot re-cut a stream through a shuffle "
                "stage: its window holds records whose shard membership "
                "changes with the modulus. Re-shard without shuffle, or "
                "accept an epoch-boundary resume")

    # b: records the old shard emitted that training never consumed —
    # discarded here, re-read by the new cut
    b = 0
    for node in downstream:
        kind = node.get("kind")
        if kind in _DOWNSTREAM_BUFFERS or kind == "bucket_batch":
            b += _buffered_count(node)
            _clear_buffers(node)
        elif kind not in _STATELESS and _buffered_count(node):
            raise ValueError(f"elastic remap does not know how to drain "
                             f"stage kind {kind!r} downstream of shard")

    # upstream of the shard: only 1:1 stages, ending at a pos-cursor
    # source; anything the rewind cannot reason about raises
    if not upstream:
        raise ValueError("shard stage has no upstream source")
    for node in upstream[:-1]:
        kind = node.get("kind")
        if kind == "map":
            node["inflight"] = []         # re-read under the new cut
        elif kind not in _STATELESS:
            raise ValueError(
                f"elastic remap requires 1:1 stages between source and "
                f"shard, found {kind!r}")
    source = upstream[-1]
    if "pos" not in source:
        raise ValueError(
            f"source stage {source.get('kind')!r} has no 'pos' cursor — "
            "elastic remap cannot rewind it")

    r = max(0, -(-(k_old - i_old) // n_old))   # ceil over ints
    if b > r:
        raise ValueError(
            f"inconsistent checkpoint: {b} records buffered downstream "
            f"but the shard only emitted {r}")
    low_water = (r - b) * n_old

    shard["n"], shard["i"], shard["k"] = num_shards, index, low_water
    source["pos"] = low_water
    return state


def remap_for(pipeline, state: dict) -> dict:
    """``remap_state`` with ``(num_shards, index)`` taken from the live
    pipeline's own shard stage — the relaunch-side entry point: build
    the pipeline for the NEW fleet, then load the OLD checkpoint through
    this."""
    from deeplearning4j_tpu_torch.datapipe.stages import ShardStage

    shards = [s for s in pipeline.tail.chain()
              if isinstance(s, ShardStage)]
    if len(shards) != 1:
        raise ValueError(
            f"elastic remap needs exactly one shard stage in the "
            f"pipeline, found {len(shards)}")
    return remap_state(state, shards[0].num_shards, shards[0].index)
