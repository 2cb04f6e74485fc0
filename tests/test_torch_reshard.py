"""The elastic shard remap (deeplearning4j_tpu_torch/datapipe/reshard.py)
against the JAX package's: for the same checkpointed pipeline states,
``remap_state`` / ``remap_for`` / ``shard_position`` / ``low_water_mark``
give equal dicts and numbers, and the same states are refused with the
same error (type and message, the package name aside). The arithmetic is
integer, so equality is exact. Then the port's remap in use: a stream
cut at the low-water mark and resumed on another shard count reads each
record exactly once."""

import json

import numpy as np
import pytest

from deeplearning4j_tpu import datapipe as jpipe
from deeplearning4j_tpu.datapipe import reshard as jreshard
from deeplearning4j_tpu_torch import datapipe as tpipe
from deeplearning4j_tpu_torch.datapipe import reshard as treshard

N = 50


def _ids():
    return np.arange(N, dtype=np.float32)[:, None]


def _double(rec):
    return (rec[0] * 1.0,)


# name -> (fn(mod, n, i) -> Pipeline, batches to take before the cut)
CHAINS = {
    "plain": (lambda m, n, i: m.from_arrays(_ids()).shard(n, i).batch(3), 2),
    "partial_batch": (lambda m, n, i: m.from_arrays(_ids()).shard(n, i)
                      .map(_double).batch(4), 1),
    "map_before_shard": (lambda m, n, i: m.from_arrays(_ids()).map(_double)
                         .shard(n, i).batch(2), 3),
    "bucket_batch": (lambda m, n, i: m.from_records(
        [(np.ones((1 + j % 5, 2), np.float32),) for j in range(N)])
        .shard(n, i).bucket_batch(3), 2),
}


def _state(mod, chain, n, i):
    build, take = CHAINS[chain]
    p = build(mod, n, i)
    it = iter(p)
    for _ in range(take):
        next(it)
    return json.loads(json.dumps(p.state_dict()))


@pytest.mark.parametrize("to", [(2, 0), (2, 1), (3, 2), (4, 1), (5, 3)])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_remap_state_equals_jax(chain, to):
    state = _state(jpipe, chain, 4, 1)
    assert _state(tpipe, chain, 4, 1) == state
    want = jreshard.remap_state(state, *to)
    got = treshard.remap_state(state, *to)
    assert got == want
    assert treshard.shard_position(got) == jreshard.shard_position(want)
    assert treshard.low_water_mark(state) == jreshard.low_water_mark(state)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_remap_for_takes_the_live_pipelines_shard(chain):
    state = _state(tpipe, chain, 4, 1)
    build = CHAINS[chain][0]
    assert treshard.remap_for(build(tpipe, 3, 2), state) == \
        jreshard.remap_for(build(jpipe, 3, 2), state)
    same = treshard.remap_for(build(tpipe, 4, 1), state)
    assert same == state          # identity: buffers kept, bit-exact


def _refusal(mod, case):
    p_mod = jpipe if mod is jreshard else tpipe
    ids = _ids()
    if case == "shuffle":
        p = p_mod.from_arrays(ids).shuffle(window=4, seed=1).shard(2, 0)
    elif case == "two_shards":
        p = p_mod.from_arrays(ids).shard(2, 0).shard(2, 1)
    elif case == "no_shard":
        p = p_mod.from_arrays(ids).batch(2)
    elif case == "filter_before_shard":
        p = p_mod.from_arrays(ids).filter(lambda r: True).shard(2, 0)
    elif case == "bad_index":
        p = p_mod.from_arrays(ids).shard(2, 0)
    state = p.state_dict()
    if case == "filter_before_shard":
        # the rule: only 1:1 stages between source and shard (a filter
        # is stateless, so put a tokenize-like kind in its place)
        state["stage"]["upstream"]["kind"] = "window"
    try:
        if case == "bad_index":
            mod.remap_state(state, 2, 5)
        else:
            mod.remap_state(state, 3, 0)
    except Exception as e:  # compared below, type and text
        return type(e).__name__, str(e).replace(
            "deeplearning4j_tpu_torch", "deeplearning4j_tpu")
    return None


@pytest.mark.parametrize("case", ["shuffle", "two_shards", "no_shard",
                                  "filter_before_shard", "bad_index"])
def test_refusals_equal_jax(case):
    want = _refusal(jreshard, case)
    assert want is not None and want[0] == "ValueError"
    assert _refusal(treshard, case) == want


def test_shard_stage_refuses_a_foreign_cursor_by_name():
    state = _state(tpipe, "plain", 4, 1)
    p = CHAINS["plain"][0](tpipe, 2, 0)
    with pytest.raises(ValueError, match="remap_state"):
        p.load_state_dict(state)


@pytest.mark.parametrize("n_new", [1, 2, 3, 6])
def test_remapped_fleet_reads_each_record_once(n_new):
    """Four shards read two batches each; a fleet of ``n_new`` resumes
    from the remapped states: the records before the low-water mark were
    consumed by the old fleet, the rest by the new one, each once."""
    consumed = []
    states = []
    for i in range(4):
        p = CHAINS["plain"][0](tpipe, 4, i)
        it = iter(p)
        for _ in range(2):
            consumed += [int(v) for v in next(it).features[:, 0]]
        states.append(json.loads(json.dumps(p.state_dict())))
    low = treshard.low_water_mark(states[0])
    assert sorted(consumed) == list(range(low))
    for i in range(n_new):
        p = CHAINS["plain"][0](tpipe, n_new, i)
        p.load_state_dict(treshard.remap_for(p, states[0]))
        consumed += [int(v) for ds in p for v in ds.features[:, 0]]
    assert sorted(consumed) == list(range(N))


def test_supervisor_resume_re_cuts_a_foreign_shard_cursor(tmp_path):
    """A fit_pipeline run preempted as shard 1 of 4, resumed as shard 0
    of 2: the checkpoint's cursor is re-cut at the low-water mark, the
    run emits a ``reshard`` event, counts it, and its RunReport carries
    the from/to cursors."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updater import Sgd
    from deeplearning4j_tpu_torch.resilience import (
        FaultInjector, SupervisorConfig, TrainingSupervisor)

    def net():
        conf = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(0.1))
                .dtype(DtypePolicy(param_dtype="float32",
                                   compute_dtype="float32")).list()
                .layer(Dense(n_in=1, n_out=3, activation="tanh"))
                .layer(Output(n_out=2, activation="softmax", loss="mcxent"))
                .build())
        return MultiLayerNetwork(conf, device="cpu").init()

    y = np.eye(2, dtype=np.float32)[np.arange(N) % 2]

    def pipe(n, i):
        return tpipe.from_arrays(_ids(), y).shard(n, i).batch(2)

    cfg = SupervisorConfig(checkpoint_dir=str(tmp_path),
                           checkpoint_every_steps=100, handle_sigterm=False)
    inj = FaultInjector()
    inj.preempt_at_step(3)
    first = TrainingSupervisor(net(), cfg, injector=inj)
    res = first.fit_pipeline(pipe(4, 1), epochs=1)
    assert res.status == "preempted"
    from deeplearning4j_tpu_torch.utils.checkpoint import (
        find_latest_checkpoint, read_checkpoint_meta)
    saved = read_checkpoint_meta(find_latest_checkpoint(
        str(tmp_path)))["datapipe"]
    n, i, k = treshard.shard_position(saved)
    assert (n, i) == (4, 1) and k > 0
    second = TrainingSupervisor(net(), cfg)
    res = second.fit_pipeline(pipe(2, 0), epochs=1)
    assert res.status == "completed"
    # the restore re-cuts (as the JAX package's does), then the run
    # reports its resume
    kinds = [e.kind for e in res.events]
    assert kinds[:2] == ["reshard", "resume"]
    assert res.stats["reshards_total"] == 1
    moved = res.report.reshard["datapipe"]
    assert moved["from"] == {"n": 4, "i": 1, "k": k}
    low = treshard.low_water_mark(saved)
    assert moved["to"] == {"n": 2, "i": 0, "k": low} and low > 0
