"""The port's step-directory checkpoint (deeplearning4j_tpu_torch/utils/
checkpoint.py) on the CPU.

- A round trip is bit-exact for every leaf in its own dtype: f32, f64 and
  bf16 parameters and updater slots, Adam's int32 ``t``, the loss scale's
  f32 scale and int32 ``good_steps``, batch-norm running statistics and
  Nesterov velocity, and a hand-made tree of f16, bf16, f32 (NaN
  payloads and -0.0 included), f64, int32/int64 and 0-d leaves.
- A snapshot is a copy: an in-place update after it does not reach what
  it writes.
- Against the JAX package (deeplearning4j_tpu/utils/checkpoint.py, on a
  zip-transplanted F32 net): ``meta.json``'s keys, counters and config,
  and ``layout.json``, are the same; ``find_latest_checkpoint`` and
  ``is_valid_checkpoint`` agree on one directory tree holding both
  packages' saves, partial saves and junk.
- Partial saves, a kind mismatch, a restore onto a mesh, reserved
  ``extra_meta`` keys and a concurrent GC are handled as the JAX package
  handles them, or refused by name.
"""

import json
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.utils import checkpoint as jck
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
from deeplearning4j_tpu_torch.nn.conf.layers_conv import BatchNorm
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam, Nesterovs
from deeplearning4j_tpu_torch.utils import checkpoint as tck
from deeplearning4j_tpu_torch.utils import serialization as tser

POLICIES = {
    "f32": DtypePolicy(param_dtype="float32", compute_dtype="float32"),
    "f64": DtypePolicy(param_dtype="float64", compute_dtype="float64"),
    # bf16 parameters and slots, with a dynamic loss scale (f32 scale,
    # int32 good_steps) beside Adam's int32 t
    "bf16": DtypePolicy(param_dtype="bfloat16", compute_dtype="bfloat16",
                        loss_scale="dynamic"),
}


def _mln(policy, seed=3):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
            .dtype(policy).list()
            .layer(Dense(n_in=5, n_out=7, activation="tanh"))
            .layer(Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return DataSet(rng.normal(size=(n, 5)).astype(np.float32),
                   np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _bits(t):
    """A tensor's raw bits, so NaN payloads and -0.0 compare too."""
    t = t.detach().cpu().contiguous()
    if t.dtype in (torch.float64, torch.int64):
        return t.view(torch.int64)
    if t.dtype in (torch.float32, torch.int32):
        return t.view(torch.int32)
    if t.dtype in (torch.bfloat16, torch.float16, torch.int16):
        return t.view(torch.int16)
    return t


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def assert_trees_bit_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype,
                                                           y.dtype)
        assert torch.equal(_bits(x), _bits(y)), path


def assert_nets_bit_equal(a, b):
    for name in ("params", "state", "opt_state"):
        assert_trees_bit_equal(getattr(a, name) or {}, getattr(b, name) or {})
    assert (a.iteration, a.epoch) == (b.iteration, b.epoch)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_round_trip_is_bit_exact_in_each_dtype(tmp_path, policy):
    net = _mln(POLICIES[policy])
    for _ in range(3):
        net.fit_batch(_data())
    net.epoch = 2
    path = tck.save_checkpoint(net, str(tmp_path / "step_3"))
    back = tck.restore_multi_layer_network(path, device="cpu")
    assert_nets_bit_equal(net, back)
    assert back.opt_state["layer_0"]["t"].dtype == torch.int32
    assert back.opt_state["layer_0"]["t"].dim() == 0
    if policy == "bf16":
        assert back.params["layer_0"]["W"].dtype == torch.bfloat16
        assert back.opt_state["_loss_scale"]["good_steps"].dtype == \
            torch.int32
    # the restored net trains on exactly as the original does
    net.fit_batch(_data(1))
    back.fit_batch(_data(1))
    assert_nets_bit_equal(net, back)


def test_hand_made_tree_round_trips_every_dtype(tmp_path):
    f32 = torch.tensor([1.5, -0.0, float("inf"), float("nan")])
    f32_payload = torch.tensor([0x7FC00123, 0x7F800001], dtype=torch.int32
                               ).view(torch.float32)
    tree = {"a": {"f16": torch.randn(3, 2).half(),
                  "bf16": torch.randn(4).bfloat16(),
                  "f32": f32, "nan_bits": f32_payload},
            "b": {"f64": torch.randn(2, 2, dtype=torch.float64),
                  "i32": torch.tensor(7, dtype=torch.int32),
                  "i64": torch.arange(3)}}
    snap = tck.CheckpointSnapshot(
        kind="multilayer", conf=_mln(POLICIES["f32"]).conf, params=tree,
        state={}, opt_state={"c": {"t": torch.tensor(5, dtype=torch.int32)}},
        iteration=4, epoch=1)
    path = tck.save_checkpoint(snap, str(tmp_path / "step_4"))
    back = tck.read_checkpoint_trees(path, snap, "cpu")
    assert_trees_bit_equal(back["params"], tree)
    assert_trees_bit_equal(back["opt_state"], snap.opt_state)
    # a template of another dtype is refused by name
    wrong = tck.CheckpointSnapshot(
        kind="multilayer", conf=snap.conf,
        params=dict(tree, a=dict(tree["a"], f32=f32.double())), state={},
        opt_state=snap.opt_state, iteration=4, epoch=1)
    with pytest.raises(tck.CheckpointError, match="f32"):
        tck.read_checkpoint_trees(path, wrong, "cpu")


def _bn_graph():
    f32 = POLICIES["f32"]
    conf = (NeuralNetConfiguration.builder().seed(5)
            .updater(Nesterovs(0.05, 0.9)).dtype(f32).graph_builder()
            .add_inputs("in")
            .add_layer("d", Dense(n_in=5, n_out=6, activation="identity"),
                       "in")
            .add_layer("bn", BatchNorm(activation="relu"), "d")
            .add_layer("out", Output(n_out=3, activation="softmax",
                                     loss="mcxent"), "bn")
            .set_outputs("out").build())
    return ComputationGraph(conf, device="cpu").init()


def test_graph_bn_state_and_nesterov_velocity_round_trip(tmp_path):
    net = _bn_graph()
    for _ in range(3):
        net.fit_batch(_data())
    assert net.state["bn"] and "v" in net.opt_state["d"]
    path = tck.save_checkpoint(net, str(tmp_path / "step_3"))
    back = tck.restore_computation_graph(path, device="cpu")
    assert isinstance(back, ComputationGraph)
    assert_nets_bit_equal(net, back)


def test_snapshot_is_a_copy_the_in_place_update_cannot_reach(tmp_path):
    net = _mln(POLICIES["f32"])
    net.fit_batch(_data())
    before = tck.snapshot_for_checkpoint(net)
    expect = {n: {k: v.clone() for k, v in sub.items()}
              for n, sub in net.params.items()}
    net.fit_batch(_data(1))  # writes params and slots in place
    assert not torch.equal(expect["layer_0"]["W"], net.params["layer_0"]["W"])
    path = tck.save_checkpoint(before, str(tmp_path / "step_1"))
    back = tck.restore_multi_layer_network(path, device="cpu")
    assert_trees_bit_equal(back.params, expect)
    assert back.iteration == 1 and before.ready is None


F32J = JDtypePolicy(param_dtype="float32", compute_dtype="float32")


def _jax_net():
    conf = (JNNC.builder().seed(3).updater(JAdam(1e-2)).dtype(F32J).list()
            .layer(JDense(n_in=5, n_out=7, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return JMLN(conf).init()


def test_meta_and_layout_match_the_jax_package(tmp_path):
    jnet = _jax_net()
    jds = _data()
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    for _ in range(2):
        jnet.fit_batch(JDataSet(jds.features, jds.labels))
    zpath = str(tmp_path / "m.zip")
    jser.write_model(jnet, zpath)
    tnet = tser.restore_multi_layer_network(zpath, device="cpu")
    extra = {"datapipe": {"kind": "batch", "upstream": {
        "kind": "shard", "n": 4, "i": 1, "k": 9}}}
    jpath = jck.save_checkpoint(jnet, str(tmp_path / "j" / "step_2"),
                                extra_meta=extra)
    tpath = tck.save_checkpoint(tnet, str(tmp_path / "t" / "step_2"),
                                extra_meta=extra)
    jmeta, tmeta = (json.load(open(os.path.join(p, "meta.json")))
                    for p in (jpath, tpath))
    assert sorted(jmeta) == sorted(tmeta)
    for key in ("kind", "iteration", "epoch", "format_version", "datapipe"):
        assert jmeta[key] == tmeta[key], key
    assert json.loads(jmeta["config"]) == json.loads(tmeta["config"])
    assert tck.read_checkpoint_layout(tpath) == \
        jck.read_checkpoint_layout(jpath)
    assert tck.read_checkpoint_layout(tpath)["datapipe_shards"] == [
        {"n": 4, "i": 1, "k": 9}]


def test_discovery_agrees_with_the_jax_package_on_one_tree(tmp_path):
    jnet = _jax_net()
    tnet = _mln(POLICIES["f32"])
    root = tmp_path / "run"
    jck.save_checkpoint(jnet, str(root / "step_1"))
    tck.save_checkpoint(tnet, str(root / "step_2"))
    jck.save_checkpoint(jnet, str(root / "step_10"))
    tck.save_checkpoint(tnet, str(root / "step_12"))
    os.remove(str(root / "step_12" / "meta.json"))   # port partial save
    jck.save_checkpoint(jnet, str(root / "step_11"))
    os.remove(str(root / "step_11" / "meta.json"))   # JAX partial save
    (root / "step_x").mkdir()
    (root / "not_a_step").mkdir()
    (root / "step_20").mkdir()                        # empty directory
    for name in sorted(os.listdir(root)):
        p = str(root / name)
        assert tck.is_valid_checkpoint(p) == jck.is_valid_checkpoint(p), name
    assert tck.find_latest_checkpoint(str(root)) == \
        jck.find_latest_checkpoint(str(root))
    assert tck.find_latest_checkpoint(str(root)).endswith("step_10")
    assert tck.find_latest_checkpoint(str(tmp_path / "missing")) is None
    assert jck.find_latest_checkpoint(str(tmp_path / "missing")) is None


def test_partial_save_from_the_seam_is_skipped_and_refused(tmp_path):
    net = _mln(POLICIES["f32"])
    tck.save_checkpoint(net, str(tmp_path / "step_0"))

    def crash(path):
        raise KeyboardInterrupt(path)

    tck._POST_COMMIT_HOOK = crash
    try:
        with pytest.raises(KeyboardInterrupt):
            tck.save_checkpoint(net, str(tmp_path / "step_1"))
    finally:
        tck._POST_COMMIT_HOOK = None
    part = str(tmp_path / "step_1")
    assert os.path.isdir(os.path.join(part, "tree"))
    assert not os.path.exists(os.path.join(part, "meta.json"))
    assert not os.path.exists(os.path.join(part, "layout.json"))
    assert not tck.is_valid_checkpoint(part)
    assert tck.find_latest_checkpoint(str(tmp_path)).endswith("step_0")
    with pytest.raises(tck.IncompleteCheckpointError, match="step_1"):
        tck.restore_multi_layer_network(part, device="cpu")


def test_kind_mismatch_and_mesh_restore_are_refused(tmp_path):
    mpath = tck.save_checkpoint(_mln(POLICIES["f32"]),
                                str(tmp_path / "m" / "step_0"))
    gpath = tck.save_checkpoint(_bn_graph(), str(tmp_path / "g" / "step_0"))
    with pytest.raises(ValueError, match="multilayer net, not a graph"):
        tck.restore_computation_graph(mpath, device="cpu")
    with pytest.raises(ValueError, match="graph net, not a multilayer"):
        tck.restore_multi_layer_network(gpath, device="cpu")
    for kw in ({"mesh": object()}, {"model_axis": "model"},
               {"tp_rules": {"['layer_0']['W']": None}}):
        with pytest.raises(NotImplementedError, match="A.5"):
            tck.restore_multi_layer_network(mpath, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="A.5"):
        tck.save_checkpoint(_mln(POLICIES["f32"]),
                            str(tmp_path / "s" / "step_0"), stats=object())


def test_extra_meta_may_not_override_reserved_keys(tmp_path):
    net = _mln(POLICIES["f32"])
    for key in ("kind", "config", "iteration", "epoch", "format_version"):
        with pytest.raises(ValueError, match="reserved"):
            tck.save_checkpoint(net, str(tmp_path / f"step_{key}"),
                                extra_meta={key: 1})
    path = tck.save_checkpoint(net, str(tmp_path / "step_0"),
                               extra_meta={"note": [1, 2]})
    assert tck.read_checkpoint_meta(path)["note"] == [1, 2]


def test_find_latest_survives_a_concurrent_gc(tmp_path, monkeypatch):
    net = _mln(POLICIES["f32"])
    for step in (1, 2, 3):
        tck.save_checkpoint(net, str(tmp_path / f"step_{step}"))
    real = tck.read_checkpoint_meta

    def gc_won(path):
        if path.endswith("step_3"):
            raise FileNotFoundError(path)  # reaped after the listdir
        return real(path)

    monkeypatch.setattr(tck, "read_checkpoint_meta", gc_won)
    assert tck.find_latest_checkpoint(str(tmp_path)).endswith("step_2")


def test_overwriting_a_step_directory_replaces_its_tree(tmp_path):
    net = _mln(POLICIES["f32"])
    path = str(tmp_path / "step_0")
    tck.save_checkpoint(net, path)
    net.fit_batch(_data())
    tck.save_checkpoint(net, path)
    assert_nets_bit_equal(net, tck.restore_multi_layer_network(
        path, device="cpu"))
    assert sorted(os.listdir(path)) == ["layout.json", "meta.json", "tree"]
