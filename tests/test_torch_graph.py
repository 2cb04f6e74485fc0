"""ComputationGraph in the port (deeplearning4j_tpu_torch/nn/graph.py, the
block-fusion pass nn/fusion.py, zoo.resnet50 and the graph zip) against
the JAX package, on the CPU.

The model is small: a ResNet stem (7x7/s2 conv + BN + relu, 3x3/s2 max
pool) on 16 x 16 x 3 images and two bottlenecks with filters = 128 (the
first with a projection shortcut), global average pooling and a softmax
head over 10 classes, b = 6. Both expand convs (128 -> 512) match the
fusion pattern, so with DL4J_TPU_FUSE_BLOCKS=1 two tails fuse in each
package. A graph built by the JAX package crosses to the port through the
zip; both then see the same parameters, BN statistics and updater state.

Tolerances, each with its reason:

- F32 outputs (softmax probabilities, eval walk): 1e-5 absolute (the same
  f32 arithmetic; convolutions and sums in another order).
- F32 scores: 1e-5 relative.
- F32 gradients: 1e-4 of each gradient's largest magnitude. Sums in
  another order, amplified by the train-mode batch norms' 1/sigma over a
  batch of only 6 x 2 x 2 positions at the last stage.
- After 3 Nesterovs(0.01, 0.9) steps (a rate at which this small net
  trains stably; at 0.1 its score rises 3.3 -> 32 in 3 steps and the two
  packages part chaotically): parameters 1e-4 of each tensor's
  largest magnitude plus 1e-6, BN running statistics 1e-4 relative plus
  1e-6 (each step moves a parameter by lr * (1 + mu) * g, so the F32
  gradient tolerance carries through three steps).
- With the fusion pass on, the JAX package runs its ``xla_recompute``
  backend and the port the Pallas function's arithmetic (K4-K7's plain
  versions); under F32 these are the same function, held as above.
- The port's fused step against its own unfused step: the bounds of
  tests/test_fusion_pass.py (score 1e-4 relative, parameters 2e-3
  relative plus 2e-4, BN statistics 1e-3 relative plus 1e-4).
- BF16 (fusion off): the forward's activations are rounded to bf16 after
  every conv and BN on both sides, and each rounding may land the other
  way; probabilities 1e-2 absolute and the score 1e-2 relative.
- A narrow ResNet-18 (basic blocks, filters 8/16/32/64, 16 x 16 images,
  b = 16), F32, fusion off and on (no tail matches: the basic block's
  tail conv is 3x3): the score 1e-5 relative and the gradients 1e-4 of
  each gradient's largest magnitude, as above. Its last two stages are
  1 x 1, so a train-mode BN there normalises over b values; at b = 4 its
  1/sigma carries the f32 rounding order up to 1.4e-4 of a gradient's
  largest, at b = 16 to 8.5e-6. At full width on the card
  (chip_smoke.py's [train_resnet18]) the same F32 step is held in the form
  ROADMAP.md C.4 gives relu/max-pool nets: the score 1e-5 relative card
  vs CPU, and the card's gradients as accurate against an f64 CPU run as
  the CPU's f32 gradients, within a factor of 2 plus 1e-3 (L2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.conf.layers_conv import (
    GlobalPooling as JGlobalPooling, Subsampling as JSubsampling)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu.zoo import models as jmodels
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets import MultiDataSet as TMDS
from deeplearning4j_tpu_torch.nn import fusion as tfusion
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration as TGraphConf)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TInputType
from deeplearning4j_tpu_torch.nn.conf.layers import Output as TOutput
from deeplearning4j_tpu_torch.nn.conf.layers_conv import (
    GlobalPooling as TGlobalPooling, Subsampling as TSubsampling)
from deeplearning4j_tpu_torch.nn.conf.vertices import vertex_from_dict
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.utils import serialization as tser

B, IMG, CLASSES = 6, 16, 10


def _build(pkg, policy="float32"):
    """The small bottleneck graph's configuration in package ``pkg``."""
    if pkg == "jax":
        from deeplearning4j_tpu.nn.conf.core import DtypePolicy
        from deeplearning4j_tpu.nn.updater import Nesterovs
        nnc, m, out, gp, sub, it = (JNNC, jmodels, JOutput, JGlobalPooling,
                                    JSubsampling, JInputType)
    else:
        from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
        from deeplearning4j_tpu_torch.nn.updater import Nesterovs
        from deeplearning4j_tpu_torch.zoo import models as m
        nnc, out, gp, sub, it = (TNNC, TOutput, TGlobalPooling,
                                 TSubsampling, TInputType)
    pol = DtypePolicy(param_dtype="float32", compute_dtype=policy)
    g = (nnc.builder().seed(7).updater(Nesterovs(0.01, 0.9)).dtype(pol)
         .graph_builder().add_inputs("img"))
    x = m._conv_bn(g, "stem", 64, (7, 7), (2, 2), "img")
    g.add_layer("stem_pool", sub(kernel=(3, 3), stride=(2, 2),
                                 pooling="max", mode="same"), x)
    x = m._bottleneck(g, "s0b0", "stem_pool", 128, 1, True)
    x = m._bottleneck(g, "s0b1", x, 128, 1, False)
    g.add_layer("head_pool", gp(pooling="avg"), x)
    g.add_layer("fc", out(n_out=CLASSES, loss="mcxent",
                          activation="softmax"), "head_pool")
    return (g.set_outputs("fc")
            .set_input_types(it.convolutional(IMG, IMG, 3)).build())


def _data(seed=0, b=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, IMG, IMG, 3)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, b)]
    return x, y


@pytest.fixture
def fuse(monkeypatch):
    def set_(on):
        monkeypatch.setenv("DL4J_TPU_FUSE_BLOCKS", "1" if on else "0")
    return set_


def _pair(tmp_path, fuse, on, policy="float32"):
    """A JAX graph and its transplant into the port (via the zip)."""
    fuse(on)
    jnet = JGraph(_build("jax", policy)).init()
    path = tmp_path / f"g_{on}_{policy}.zip"
    jser.write_computation_graph(jnet, str(path))
    tnet = tser.restore_computation_graph(str(path), device="cpu")
    assert len(jnet._fusion_plans) == len(tnet._fusion_plans) == (2 if on
                                                                  else 0)
    return jnet, tnet


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _jgrads(jnet, x, y):
    def loss(p):
        return jnet._loss(p, jnet.state, {"img": jnp.asarray(x)},
                          [jnp.asarray(y)], {}, None, rng=None,
                          train=True)[0]
    val, g = jax.jit(jax.value_and_grad(loss))(jnet.params)
    return float(val), g


def _tgrads(tnet, x, y):
    leaves = {ln: {k: t.detach().clone().requires_grad_()
                   for k, t in lp.items()}
              for ln, lp in tnet.params.items()}
    loss, _ = tnet._loss(leaves, tnet.state,
                         *tnet._batch(TMDS([x], [y])), gen=tnet._gen)
    keys = [(ln, k) for ln in leaves for k in leaves[ln]]
    gs = torch.autograd.grad(loss, [leaves[ln][k] for ln, k in keys])
    return float(loss.detach()), dict(zip(keys, gs))


def _close_max(got, want, rel, what, floor=0.0):
    got, want = _np(got), _np(want)
    err = float(np.abs(got - want).max())
    tol = rel * float(np.abs(want).max()) + floor
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


# ------------------------------------------------------------------ config
def test_graph_json_matches_jax_key_for_key():
    jconf, tconf = _build("jax"), _build("torch")
    assert tconf.to_json() == jconf.to_json()
    again = TGraphConf.from_json(jconf.to_json())
    assert again.to_json() == jconf.to_json()
    assert tconf.topological_order() == jconf.topological_order()


def test_resnet50_config_and_fusion_plans_match_jax(fuse):
    fuse(True)
    jnet = jzoo.resnet50(image_size=32)
    tnet = tzoo.resnet50(image_size=32, device="cpu")
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert tnet.num_params() == jnet.num_params() == 25557032
    assert len(tnet._fusion_plans) == 13
    assert ({k: tuple(vars(v).values()) for k, v in
             tnet._fusion_plans.items()}
            == {k: tuple(vars(v).values()) for k, v in
                jnet._fusion_plans.items()})
    assert not any(n.startswith("s0") for n in tnet._fusion_plans)
    assert tnet._fusion_interior == jnet._fusion_interior


def test_fusion_gate_matches_jax():
    from deeplearning4j_tpu.nn import fusion as jfusion
    from deeplearning4j_tpu.nn.conf.layers_conv import Convolution2D as JC
    from deeplearning4j_tpu_torch.nn.conf.layers_conv import (
        Convolution2D as TC)
    cases = [dict(n_in=256, n_out=64), dict(n_in=64, n_out=256),
             dict(n_in=128, n_out=256), dict(n_in=128, n_out=256,
                                             stride=(2, 2)),
             dict(n_in=128, n_out=256, has_bias=True),
             dict(n_in=128, n_out=256, kernel=(3, 3))]
    for kw in cases:
        for act, default in ((None, "sigmoid"), (None, "identity"),
                             ("identity", "sigmoid")):
            args = dict(dict(kernel=(1, 1), has_bias=False), **kw)
            if act:
                args["activation"] = act
            assert tfusion._conv_matches(TC(**args), default) == \
                jfusion._conv_matches(JC(**args), default), (kw, act, default)


def test_switch_default_off_and_unported_vertices_refused(monkeypatch):
    """The fusion switch is off by default. Every vertex type of the JAX
    package now loads (the merge vertex, refused here before slice 14,
    concatenates on the trailing axis as the JAX package's does); a type
    neither package knows is refused by name."""
    monkeypatch.delenv("DL4J_TPU_FUSE_BLOCKS", raising=False)
    assert not tfusion.enabled()
    assert TGraph(_build("torch"), device="cpu").init()._fusion_plans == {}
    from deeplearning4j_tpu.nn.conf.vertices import MergeVertex as JMerge
    merge = vertex_from_dict({"vertex_type": "merge"})
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 3, 4, 5)), rng.normal(size=(2, 3, 4, 2))
    np.testing.assert_array_equal(
        merge.forward(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(JMerge().forward(jnp.asarray(a), jnp.asarray(b))))
    assert merge.output_type(TInputType.convolutional(3, 4, 5),
                             TInputType.convolutional(3, 4, 2)).to_dict() \
        == JMerge().output_type(JInputType.convolutional(3, 4, 5),
                                JInputType.convolutional(3, 4, 2)).to_dict()
    with pytest.raises(ValueError, match="'no_such_vertex'"):
        vertex_from_dict({"vertex_type": "no_such_vertex"})


# ------------------------------------------------------------- parity
@pytest.mark.parametrize("on", [False, True], ids=["unfused", "fused"])
def test_output_score_and_gradients_match_jax(tmp_path, fuse, on):
    jnet, tnet = _pair(tmp_path, fuse, on)
    x, y = _data(1)
    jout = jnet.output(x)
    tout = tnet.output(x)
    np.testing.assert_allclose(_np(tout), _np(jout), atol=1e-5, rtol=0)
    assert abs(tnet.score(TMDS([x], [y])) - jnet.score(JMDS([x], [y]))) \
        <= 1e-5 * abs(jnet.score(JMDS([x], [y])))
    jl, jg = _jgrads(jnet, x, y)
    tl, tg = _tgrads(tnet, x, y)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert set(tg) == {(ln, k) for ln in jg for k in jg[ln]}
    for (ln, k), g in tg.items():
        _close_max(g, jg[ln][k], 1e-4, f"grad {ln}.{k}")


@pytest.mark.parametrize("on", [False, True], ids=["unfused", "fused"])
def test_three_nesterov_steps_match_jax(tmp_path, fuse, on):
    jnet, tnet = _pair(tmp_path, fuse, on)
    for step in range(3):
        x, y = _data(10 + step)
        js = float(jnet.fit_batch(JMDS([x], [y])))
        ts = float(tnet.fit_batch(TMDS([x], [y])))
        assert abs(ts - js) <= 1e-5 * abs(js), (step, ts, js)
    assert tnet.iteration == jnet.iteration == 3
    for ln, lp in tnet.params.items():
        for k, t in lp.items():
            _close_max(t, jnet.params[ln][k], 1e-4, f"param {ln}.{k}",
                       floor=1e-6)
    for ln, ls in tnet.state.items():
        for k, t in ls.items():
            np.testing.assert_allclose(_np(t), _np(jnet.state[ln][k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"state {ln}.{k}")
    for ln, lo in tnet.opt_state.items():
        for k, t in lo["v"].items():
            _close_max(t, jnet.opt_state[ln]["v"][k], 1e-4,
                       f"velocity {ln}.{k}", floor=1e-6)


def test_fused_step_matches_unfused_step(fuse):
    fuse(True)
    net_f = TGraph(_build("torch"), device="cpu").init()
    fuse(False)
    net_u = TGraph(_build("torch"), device="cpu").init()
    assert len(net_f._fusion_plans) == 2 and not net_u._fusion_plans
    for step in range(3):
        x, y = _data(20 + step)
        s_f = float(net_f.fit_batch(TMDS([x], [y])))
        s_u = float(net_u.fit_batch(TMDS([x], [y])))
        assert abs(s_f - s_u) <= 1e-4 * abs(s_u) + 1e-5
    for ln, lp in net_f.params.items():
        for k, t in lp.items():
            np.testing.assert_allclose(_np(t), _np(net_u.params[ln][k]),
                                       rtol=2e-3, atol=2e-4,
                                       err_msg=f"{ln}.{k}")
    for ln, ls in net_f.state.items():
        for k, t in ls.items():
            np.testing.assert_allclose(_np(t), _np(net_u.state[ln][k]),
                                       rtol=1e-3, atol=1e-4,
                                       err_msg=f"state {ln}.{k}")


def test_f64_gradients_jump_under_a_tiny_input_change(fuse):
    """The gradient of a relu/max-pool net is discontinuous: a change that
    moves a pre-activation across 0, or changes a pool's winner, moves it
    by a finite amount. At this graph's weights one such switch lies
    within 1e-6 of the input: an additive 1e-6 change of it moves the f64
    gradients by thousands of times 1e-6 (L2, relative to each gradient's
    norm), as far as f32 rounding moves them. The full-depth net has
    millions of pre-activations, so chip_smoke.py's [train_resnet] holds
    its first-step gradients, card vs CPU, in L2 and not to 1e-4 of max."""
    import dataclasses
    from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
    fuse(False)
    conf = _build("torch")
    net32 = TGraph(conf, device="cpu").init()
    f64 = DtypePolicy(param_dtype="float64", compute_dtype="float64")
    net64 = TGraph(dataclasses.replace(conf, global_conf=dataclasses.replace(
        conf.global_conf, dtype=f64)), device="cpu").init()
    net64.params = {ln: {k: t.double() for k, t in lp.items()}
                    for ln, lp in net32.params.items()}
    x, y = _data(0)
    x64, y64 = torch.from_numpy(x).double(), torch.from_numpy(y).double()
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(0),
                        dtype=torch.float64)
    _, g = _tgrads(net64, x64, y64)
    _, g_moved = _tgrads(net64, x64 + 1e-6 * noise, y64)
    _, g32 = _tgrads(net32, torch.from_numpy(x), torch.from_numpy(y))

    def worst_l2(got):
        return max(float((got[k].double() - w).norm() / w.norm())
                   for k, w in g.items() if float(w.norm()) > 0)
    moved, rounded = worst_l2(g_moved), worst_l2(g32)
    assert moved > 1e3 * 1e-6, moved
    assert moved > 0.1 * rounded, (moved, rounded)


def test_eval_walk_is_unfused_and_deterministic(fuse, monkeypatch):
    fuse(True)
    net = TGraph(_build("torch"), device="cpu").init()
    calls = []
    real = tfusion.execute_fused_tail
    monkeypatch.setattr(tfusion, "execute_fused_tail",
                        lambda fb, *a: calls.append(fb.out) or real(fb, *a))
    x, y = _data(3)
    net.fit_batch(TMDS([x], [y]))
    assert sorted(calls) == ["s0b0_out", "s0b1_out"]
    calls.clear()
    out1 = net.output(x)
    out2 = net.output(x)
    assert not calls
    assert torch.equal(out1, out2)
    assert out1.shape == (B, CLASSES)
    acts = net.feed_forward(x)
    assert torch.equal(acts["fc"], out1)
    assert net.num_params() == sum(t.numel() for lp in net.params.values()
                                   for t in lp.values())


def test_bf16_output_and_score_match_jax(tmp_path, fuse):
    jnet, tnet = _pair(tmp_path, fuse, False, policy="bfloat16")
    x, y = _data(4)
    np.testing.assert_allclose(_np(tnet.output(x)), _np(jnet.output(x)),
                               atol=1e-2, rtol=0)
    js = jnet.score(JMDS([x], [y]), train=True)
    ts = tnet.score(TMDS([x], [y]), train=True)
    assert abs(ts - js) <= 1e-2 * abs(js)


# --------------------------------------------------------------------- zip
def test_zip_from_the_port_restores_in_jax(tmp_path, fuse):
    fuse(False)
    tnet = TGraph(_build("torch"), device="cpu").init()
    for step in range(2):
        x, y = _data(30 + step)
        tnet.fit_batch(TMDS([x], [y]))
    path = tmp_path / "port.zip"
    tser.write_computation_graph(tnet, str(path))
    jnet = jser.restore_computation_graph(str(path))
    assert jnet.iteration == 2
    x, _ = _data(5)
    np.testing.assert_allclose(_np(jnet.output(x)), _np(tnet.output(x)),
                               atol=1e-5, rtol=0)
    for ln, ls in tnet.state.items():
        for k, t in ls.items():
            np.testing.assert_array_equal(_np(t), _np(jnet.state[ln][k]))
    for ln, lo in tnet.opt_state.items():
        for k, t in lo["v"].items():
            np.testing.assert_array_equal(_np(t),
                                          _np(jnet.opt_state[ln]["v"][k]))
    back = tser.restore_computation_graph(str(path), device="cpu")
    assert back.conf.to_json() == tnet.conf.to_json()
    assert torch.equal(back.output(x), tnet.output(x))


def test_fit_accepts_a_list_and_counts_epochs(fuse):
    fuse(False)
    net = TGraph(_build("torch"), device="cpu").init()
    from deeplearning4j_tpu_torch.datasets import DataSet
    data = [DataSet(*_data(40)), TMDS(*map(lambda a: [a], _data(41)))]
    net.fit(data, epochs=2)
    assert net.iteration == 4 and net.epoch == 2
    assert np.isfinite(float(net.score_value))
    with pytest.raises(TypeError, match="DataSet or MultiDataSet"):
        net.fit_batch((1, 2))
    net.set_lr_scale(0.5)
    with pytest.raises(ValueError, match="lr scale"):
        net.set_lr_scale(0.0)


# ------------------------------------------------------------ truncated BPTT
def _rnn_graph(pkg, tbptt):
    """GravesLSTM(8) -> RnnOutput(5) over 4 features, F32, Sgd(0.1);
    ``tbptt``: truncated BPTT of 4 steps each way, else standard."""
    if pkg == "jax":
        from deeplearning4j_tpu.nn.conf.core import DtypePolicy
        from deeplearning4j_tpu.nn.conf.layers_recurrent import (
            GravesLSTM, RnnOutput)
        from deeplearning4j_tpu.nn.updater import Sgd
        nnc, it = JNNC, JInputType
    else:
        from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
        from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import (
            GravesLSTM, RnnOutput)
        from deeplearning4j_tpu_torch.nn.updater import Sgd
        nnc, it = TNNC, TInputType
    pol = DtypePolicy(param_dtype="float32", compute_dtype="float32")
    g = (nnc.builder().seed(3).updater(Sgd(0.1)).dtype(pol)
         .graph_builder().add_inputs("seq")
         .add_layer("lstm", GravesLSTM(n_out=8, activation="tanh"), "seq")
         .add_layer("out", RnnOutput(n_out=5, loss="mcxent",
                                     activation="softmax"), "lstm")
         .set_outputs("out").set_input_types(it.recurrent(4)))
    if tbptt:
        g = g.backprop_type("tbptt", 4, 4)
    return g.build()


def _rnn_pair(tmp_path, fuse, tbptt):
    fuse(False)
    jnet = JGraph(_rnn_graph("jax", tbptt)).init()
    path = tmp_path / f"rnn_{tbptt}.zip"
    jser.write_computation_graph(jnet, str(path))
    return jnet, tser.restore_computation_graph(str(path), device="cpu")


def _rnn_data(T):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, T, 4)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (3, T))]
    return x, y


def test_graph_standard_backprop_rnn_step_matches_jax(tmp_path, fuse):
    """The twin of the tBPTT refusal below: the same graph with standard
    backprop takes one step as the JAX package does (the same f32 LSTM
    arithmetic over 16 steps): every parameter to 1e-8 absolute plus one
    f32 ulp of its value, for an update that lands the parameter's own
    rounding the other way (out.W reads one ulp at 0.5, 3e-8)."""
    jnet, tnet = _rnn_pair(tmp_path, fuse, tbptt=False)
    x, y = _rnn_data(16)
    js = float(jnet.fit_batch(JMDS([x], [y])))
    ts = float(tnet.fit_batch(TMDS([x], [y])))
    assert abs(ts - js) <= 1e-6 * abs(js), (ts, js)
    for ln, lp in tnet.params.items():
        for k, t in lp.items():
            got, want = _np(t), _np(jnet.params[ln][k])
            tol = 1e-8 + np.spacing(np.abs(want))
            assert (np.abs(got - want) <= tol).all(), f"param {ln}.{k}"


def test_graph_tbptt_batch_longer_than_its_window_is_refused(tmp_path,
                                                             fuse):
    """Refused before slice 14; now such a batch takes truncated BPTT, as
    the JAX package's ``_fit_tbptt`` does: one Sgd step a 4-step window
    (4 windows of 16), the same parameters afterwards, the carries gone
    from the state, one iteration; and a batch inside one window takes
    the standard step, as in the JAX package."""
    jnet, tnet = _rnn_pair(tmp_path, fuse, tbptt=True)
    assert tnet.conf.backprop_type == "tbptt"
    x, y = _rnn_data(16)
    js = float(jnet.fit_batch(JMDS([x], [y])))
    ts = float(tnet.fit_batch(TMDS([x], [y])))
    assert abs(ts - js) <= 1e-5 * abs(js), (ts, js)
    assert tnet.iteration == jnet.iteration == 1
    assert tnet.state == {}
    for ln, lp in tnet.params.items():
        for k, t in lp.items():
            _close_max(t, jnet.params[ln][k], 1e-5, f"param {ln}.{k}")
    x4, y4 = _rnn_data(4)
    js = float(jnet.fit_batch(JMDS([x4], [y4])))
    ts = float(tnet.fit_batch(TMDS([x4], [y4])))
    assert abs(ts - js) <= 1e-5 * abs(js), (ts, js)


# ---------------------------------------------------------------- ResNet-18
def _resnet18_narrow(pkg):
    """ResNet-18's topology (stem, basic-block stages [2, 2, 2, 2]) at
    filters 8/16/32/64 on 16 x 16 x 3 images, F32, Nesterovs(0.01, 0.9):
    the zoo's ``_basic_block`` of each package."""
    if pkg == "jax":
        from deeplearning4j_tpu.nn.conf.core import DtypePolicy
        from deeplearning4j_tpu.nn.updater import Nesterovs
        nnc, m, out, gp, sub, it = (JNNC, jmodels, JOutput, JGlobalPooling,
                                    JSubsampling, JInputType)
    else:
        from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
        from deeplearning4j_tpu_torch.nn.updater import Nesterovs
        from deeplearning4j_tpu_torch.zoo import models as m
        nnc, out, gp, sub, it = (TNNC, TOutput, TGlobalPooling,
                                 TSubsampling, TInputType)
    pol = DtypePolicy(param_dtype="float32", compute_dtype="float32")
    g = (nnc.builder().seed(5).updater(Nesterovs(0.01, 0.9)).dtype(pol)
         .graph_builder().add_inputs("img"))
    x = m._conv_bn(g, "stem", 8, (7, 7), (2, 2), "img")
    g.add_layer("stem_pool", sub(kernel=(3, 3), stride=(2, 2),
                                 pooling="max", mode="same"), x)
    x, filters, in_ch = "stem_pool", 8, 8
    for stage in range(4):
        for b in range(2):
            stride = 2 if (stage > 0 and b == 0) else 1
            project = b == 0 and (stride != 1 or in_ch != filters)
            x = m._basic_block(g, f"s{stage}b{b}", x, filters, stride,
                               project)
            in_ch = filters
        filters *= 2
    g.add_layer("head_pool", gp(pooling="avg"), x)
    g.add_layer("fc", out(n_out=CLASSES, loss="mcxent",
                          activation="softmax"), "head_pool")
    return (g.set_outputs("fc")
            .set_input_types(it.convolutional(IMG, IMG, 3)).build())


@pytest.mark.parametrize("on", [False, True], ids=["unfused", "fused"])
def test_resnet18_narrow_f32_step_matches_jax(tmp_path, fuse, on):
    fuse(on)
    jconf, tconf = _resnet18_narrow("jax"), _resnet18_narrow("torch")
    assert tconf.to_json() == jconf.to_json()
    jnet = JGraph(jconf).init()
    path = tmp_path / "r18.zip"
    jser.write_computation_graph(jnet, str(path))
    tnet = tser.restore_computation_graph(str(path), device="cpu")
    assert tnet._fusion_plans == {} and jnet._fusion_plans == {}
    x, y = _data(50, b=16)
    jl, jg = _jgrads(jnet, x, y)
    tl, tg = _tgrads(tnet, x, y)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert set(tg) == {(ln, k) for ln in jg for k in jg[ln]}
    for (ln, k), g in tg.items():
        _close_max(g, jg[ln][k], 1e-4, f"grad {ln}.{k}")
    js = float(jnet.fit_batch(JMDS([x], [y])))
    ts = float(tnet.fit_batch(TMDS([x], [y])))
    assert abs(ts - js) <= 1e-5 * abs(js)
    for ln, lp in tnet.params.items():
        for k, t in lp.items():
            _close_max(t, jnet.params[ln][k], 1e-4, f"param {ln}.{k}",
                       floor=1e-6)


def test_resnet18_narrow_eval_after_steps_matches_jax(tmp_path, fuse):
    """Eval mode after BN-updating steps: two F32 steps on the narrow
    ResNet-18 (one on each of two batches; the first step's 1/sigma
    rounding, above, grows with each step), then the BN running statistics (1e-4 of each tensor's
    largest magnitude plus 1e-6, as the parameters), the eval-mode
    probabilities on the trained batches and an unseen one (1e-5
    absolute, as every F32 output here) and ``evaluate``'s confusion
    matrix (exactly) against the JAX graph."""
    fuse(False)
    jnet = JGraph(_resnet18_narrow("jax")).init()
    path = tmp_path / "r18.zip"
    jser.write_computation_graph(jnet, str(path))
    tnet = tser.restore_computation_graph(str(path), device="cpu")
    batches = [_data(70 + i, b=16) for i in range(3)]
    for step in range(2):
        x, y = batches[step]
        js = float(jnet.fit_batch(JMDS([x], [y])))
        ts = float(tnet.fit_batch(TMDS([x], [y])))
        assert abs(ts - js) <= 1e-5 * abs(js), (step, ts, js)
    assert set(tnet.state) == set(jnet.state) and len(tnet.state) == 20
    for ln, ls in tnet.state.items():
        for k, t in ls.items():
            _close_max(t, jnet.state[ln][k], 1e-4, f"state {ln}.{k}",
                       floor=1e-6)
    for x, _ in batches:
        np.testing.assert_allclose(_np(tnet.output(x)), _np(jnet.output(x)),
                                   atol=1e-5, rtol=0)
    tev = tnet.evaluate([TMDS([x], [y]) for x, y in batches])
    jev = jnet.evaluate([JMDS([x], [y]) for x, y in batches])
    np.testing.assert_array_equal(tev.confusion.matrix, jev.confusion.matrix)


def test_resnet18_zoo_config_matches_jax(fuse):
    fuse(True)
    jnet = jzoo.resnet18()
    tnet = tzoo.resnet18(device="cpu")
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert tnet.num_params() == jnet.num_params() == 11181642
    assert tnet._fusion_plans == {} == jnet._fusion_plans
    assert tnet.summary() == jnet.summary()


def test_graph_evaluate_summary_and_clone(fuse):
    fuse(False)
    net = TGraph(_build("torch"), device="cpu").init()
    x, y = _data(60, b=12)
    net.fit_batch(TMDS([x], [y]))
    ev = net.evaluate(TMDS([x], [y]))
    want = np.zeros((CLASSES, CLASSES), np.int64)
    np.add.at(want, (y.argmax(1), _np(net.output(x)).argmax(1)), 1)
    np.testing.assert_array_equal(ev.confusion.matrix, want)
    assert net.evaluate([DataSet(x, y)]).accuracy() == ev.accuracy()
    reg = net.evaluate_regression(DataSet(x, y))
    assert reg.num_columns() == CLASSES
    twin = net.clone()
    assert twin.summary() == net.summary()
    for ln, lp in net.params.items():
        for k, t in lp.items():
            assert torch.equal(twin.params[ln][k], t)
            assert twin.params[ln][k].data_ptr() != t.data_ptr()
    s1 = float(net.fit_batch(TMDS([x], [y])))
    s2 = float(twin.fit_batch(TMDS([x], [y])))
    assert s1 == s2
    for ln, ls in net.state.items():
        for k, t in ls.items():
            assert torch.equal(twin.state[ln][k], t)


def test_graph_evaluate_refuses_a_two_output_graph():
    conf = (TNNC.builder().graph_builder().add_inputs("in")
            .add_layer("a", TOutput(n_out=2), "in")
            .add_layer("b", TOutput(n_out=2), "in")
            .set_outputs("a", "b")
            .set_input_types(TInputType.feed_forward(3)).build())
    net = TGraph(conf, device="cpu").init()
    x = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="single-output"):
        net.evaluate(TMDS([x], [x[:, :2], x[:, :2]]))
    with pytest.raises(ValueError, match="evaluate_regression"):
        net.evaluate_regression(TMDS([x], [x[:, :2], x[:, :2]]))
