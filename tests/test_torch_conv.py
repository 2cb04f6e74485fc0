"""The port's convolution, pooling and batch-norm ops and layers
(deeplearning4j_tpu_torch/ops/{convolution,normalization}.py,
nn/layers/{convolution,pooling,normalization}.py) against the JAX
package's, on the CPU, on the same numpy inputs in NHWC / HWIO.

Tolerances, each with its reason:

- f32 outputs and gradients: 1e-5 of the output's largest magnitude (the
  same f32 arithmetic, sums in another order).
- bf16 batch norm: 2 bf16 ulps at the output's largest magnitude. Both
  sides form the statistics in f32 and the normalised output with two
  bf16 roundings (x * scale, then + sh); the JAX CPU lowering may keep the
  intermediate in f32, which moves one rounding by up to an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JPolicy
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf import layers_conv as jconf
from deeplearning4j_tpu.ops import convolution as jconv
from deeplearning4j_tpu.ops import normalization as jnorm
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy as TPolicy
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TInputType
from deeplearning4j_tpu_torch.nn.conf import layers_conv as tconf
from deeplearning4j_tpu_torch.nn.conf.layers import layer_from_dict
from deeplearning4j_tpu_torch.ops import convolution as tconv
from deeplearning4j_tpu_torch.ops import normalization as tnorm


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _close(got, want, what, dtype="float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = float(np.abs(want).max())
    tol = (1e-5 * top if dtype == "float32"
           else 2 * 2.0 ** (np.floor(np.log2(top)) - 7))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("in_size", [1, 7, 8, 16, 112, 224])
@pytest.mark.parametrize("kernel,stride,pad,dil", [
    (1, 1, 0, 1), (1, 2, 0, 1), (3, 1, 1, 1), (3, 2, 0, 1), (7, 2, 3, 1),
    (3, 1, 2, 2)])
def test_shape_math_matches(in_size, kernel, stride, pad, dil):
    assert tconv.pair(kernel) == jconv.pair(kernel)
    assert tconv.pair((kernel, stride)) == jconv.pair((kernel, stride))
    for mode in ("same", "truncate", "strict"):
        try:
            want = jconv.out_size(in_size, kernel, stride, pad, mode, dil)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(":")[0]):
                tconv.out_size(in_size, kernel, stride, pad, mode, dil)
            continue
        assert tconv.out_size(in_size, kernel, stride, pad, mode,
                              dil) == want
        assert tconv.spatial_padding(
            (in_size, in_size + 1), (kernel, kernel), (stride, stride),
            (pad, pad), mode, (dil, dil)) == jconv.spatial_padding(
            (in_size, in_size + 1), (kernel, kernel), (stride, stride),
            (pad, pad), mode, (dil, dil))
    assert tconv._same_pads(in_size, kernel, stride, dil) == \
        jconv._same_pads(in_size, kernel, stride, dil)


@pytest.mark.parametrize("kernel,stride,mode,pad,dil", [
    ((7, 7), (2, 2), "same", (0, 0), (1, 1)),     # the stem: pads (2, 3)
    ((3, 3), (1, 1), "same", (0, 0), (1, 1)),
    ((1, 1), (2, 2), "same", (0, 0), (1, 1)),
    ((3, 3), (2, 2), "truncate", (1, 1), (1, 1)),
    ((3, 2), (1, 2), "truncate", (0, 1), (2, 1)),
])
def test_conv2d_forward_and_gradients(kernel, stride, mode, pad, dil):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 15, 3)).astype(np.float32)
    w = rng.normal(size=kernel + (3, 5)).astype(np.float32)
    pads = jconv.spatial_padding((16, 15), kernel, stride, pad, mode, dil)
    assert pads == tconv.spatial_padding((16, 15), kernel, stride, pad, mode,
                                         dil)
    wts = None

    def jf(x, w):
        return jconv.conv2d_xla(x, w, strides=stride, padding=pads,
                                dilation=dil)

    jy = jf(jnp.asarray(x), jnp.asarray(w))
    wts = np.cos(np.arange(jy.size).reshape(jy.shape)).astype(np.float32)
    jdx, jdw = jax.grad(lambda x, w: jnp.sum(jf(x, w) * wts),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ty = tconv.conv2d(tx, tw, strides=stride, padding=pads, dilation=dil)
    assert ty.is_contiguous()
    (ty * torch.from_numpy(wts)).sum().backward()
    _close(ty, jy, "y")
    _close(tx.grad, jdx, "dx")
    _close(tw.grad, jdw, "dw")


@pytest.mark.parametrize("pool", ["max", "avg"])
@pytest.mark.parametrize("kernel,stride,mode,pad", [
    ((3, 3), (2, 2), "same", (0, 0)),     # the stem pool: pads (0, 1)
    ((2, 2), (2, 2), "truncate", (0, 0)),
    ((3, 3), (1, 1), "truncate", (1, 1)),
])
def test_pooling_forward_and_gradients(pool, kernel, stride, mode, pad):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 9, 4)).astype(np.float32)
    pads = jconv.spatial_padding((8, 9), kernel, stride, pad, mode)
    kw = dict(kernel=kernel, strides=stride, padding=pads)
    jfn = {"max": jconv.max_pool2d_xla, "avg": jconv.avg_pool2d_xla}[pool]
    tfn = {"max": tconv.max_pool2d, "avg": tconv.avg_pool2d}[pool]
    jy = jfn(jnp.asarray(x), **kw)
    wts = np.cos(np.arange(jy.size).reshape(jy.shape)).astype(np.float32)
    jdx = jax.grad(lambda x: jnp.sum(jfn(x, **kw) * wts))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = tfn(tx, **kw)
    (ty * torch.from_numpy(wts)).sum().backward()
    _close(ty, jy, f"{pool} y")
    _close(tx.grad, jdx, f"{pool} dx")


def _graph_layer(pkg, conf, input_type):
    """A runtime layer of each package from the same config."""
    if pkg == "jax":
        gc = JNNC.builder().dtype(JPolicy()).build()
        return conf.with_n_in(input_type).replace(name="l").make_layer(
            input_type, gc, gc.dtype)
    gc = TNNC.builder().dtype(TPolicy()).build()
    return conf.with_n_in(input_type).replace(name="l").make_layer(
        input_type, gc, gc.dtype)


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (2, 6, 5)])
def test_global_pooling_matches(pooling, shape):
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).astype(np.float32)
    kind = ("convolutional" if len(shape) == 4 else "recurrent")
    jit = (JInputType.convolutional(*shape[1:]) if kind == "convolutional"
           else JInputType.recurrent(shape[-1], shape[1]))
    tit = (TInputType.convolutional(*shape[1:]) if kind == "convolutional"
           else TInputType.recurrent(shape[-1], shape[1]))
    jl = _graph_layer("jax", jconf.GlobalPooling(pooling=pooling), jit)
    tl = _graph_layer("torch", tconf.GlobalPooling(pooling=pooling), tit)
    assert tl.output_type.to_dict() == jl.output_type.to_dict()
    jy, _ = jl.apply({}, {}, jnp.asarray(x))
    ty, _ = tl.apply({}, {}, torch.tensor(x))
    _close(ty, jy, "global pool")


def test_global_pooling_refuses_a_masked_time_series():
    """Refused before slice 14; a masked time series now pools over its
    unmasked steps as the JAX package's does (avg divides by the count of
    unmasked steps; all four modes in tests/test_torch_vertices.py)."""
    jl = _graph_layer("jax", jconf.GlobalPooling(pooling="avg"),
                      JInputType.recurrent(5, 6))
    tl = _graph_layer("torch", tconf.GlobalPooling(pooling="avg"),
                      TInputType.recurrent(5, 6))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 5)).astype(np.float32)
    m = np.ones((2, 6), np.float32)
    m[1, 2:] = 0.0
    ty, _ = tl.apply({}, {}, torch.tensor(x), mask=torch.tensor(m))
    jy, _ = jl.apply({}, {}, jnp.asarray(x), mask=jnp.asarray(m))
    _close(ty, jy, "masked avg pool")
    _close(ty[1], x[1, :2].mean(axis=0), "row 1 over its 2 steps")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 3, 3, 8), (16, 6)])
def test_batch_norm_train_forward_and_backward(dtype, shape):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 2.0 + 3.0).astype(np.float32)
    f = shape[-1]
    gamma = rng.uniform(0.5, 1.5, f).astype(np.float32)
    beta = rng.normal(size=f).astype(np.float32)
    shift = rng.normal(size=f).astype(np.float32) + 3.0
    g = rng.normal(size=shape).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def jf(x, gamma, beta):
        y, m, v = jnorm.batch_norm_train(x, gamma, beta, jnp.asarray(shift),
                                         1e-5)
        return jnp.sum(y.astype(jnp.float32) * g), (y, m, v)

    (_, (jy, jm, jv)), jg = jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x, jd), jnp.asarray(gamma), jnp.asarray(beta))
    tx = torch.tensor(x, dtype=td, requires_grad=True)
    tg = torch.tensor(gamma, requires_grad=True)
    tb = torch.tensor(beta, requires_grad=True)
    ty, tm, tv = tnorm.batch_norm_train(tx, tg, tb, torch.tensor(shift),
                                        1e-5)
    assert ty.dtype == td and not tm.requires_grad and not tv.requires_grad
    (ty.float() * torch.from_numpy(g)).sum().backward()
    _close(ty, jy, "y", dtype)
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=1e-5, atol=1e-6)
    for name, t, j in (("dx", tx.grad, jg[0]), ("dgamma", tg.grad, jg[1]),
                       ("dbeta", tb.grad, jg[2])):
        _close(t, j, name, dtype)


def test_batch_norm_layer_train_and_eval_match():
    """BatchNormLayer: the running statistics' update (train) and the
    running-statistics normalisation (eval), port against JAX."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(4, 3, 3, 8)) + 1.0).astype(np.float32)
    it_j, it_t = (JInputType.convolutional(3, 3, 8),
                  TInputType.convolutional(3, 3, 8))
    jl = _graph_layer("jax", jconf.BatchNorm(activation="identity"), it_j)
    tl = _graph_layer("torch", tconf.BatchNorm(activation="identity"), it_t)
    params = {"gamma": rng.uniform(0.5, 1.5, 8).astype(np.float32),
              "beta": rng.normal(size=8).astype(np.float32)}
    state = {"mean": rng.normal(size=8).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = {k: torch.tensor(v) for k, v in state.items()}
    for train in (True, False):
        jy, jns = jl.apply(jp, js, jnp.asarray(x), train=train)
        ty, tns = tl.apply(tp, ts, torch.tensor(x), train=train)
        _close(ty, jy, f"y train={train}")
        assert set(tns) == set(jns)
        for k in tns:
            _close(tns[k], jns[k], f"state {k}")
    assert {k: tuple(v.shape) for k, v in tl.init_state().items()} == \
        {"mean": (8,), "var": (8,)}


@pytest.mark.parametrize("ltype", ["conv1d", "subsampling1d",
                                   "zero_padding", "lrn"])
def test_unported_conv_layers_are_refused_by_name(ltype):
    """Refused before slice 14; each now loads from the JAX package's
    dict, round-trips key for key and gives the JAX package's output type
    and forward (f32; F64 parity and gradients in
    tests/test_torch_vertices.py)."""
    from deeplearning4j_tpu.nn.conf.layers import layer_to_dict as jto
    from deeplearning4j_tpu_torch.nn.conf.layers import layer_to_dict as tto
    jc = {"conv1d": jconf.Convolution1D(n_out=3, kernel=3, stride=2),
          "subsampling1d": jconf.Subsampling1D(kernel=2, stride=2),
          "zero_padding": jconf.ZeroPadding(pad=(1, 0, 2, 1)),
          "lrn": jconf.LocalResponseNormalization(n=4)}[ltype]
    tc = layer_from_dict(jto(jc))
    assert tc.layer_type == ltype and tto(tc) == jto(jc)
    rng = np.random.default_rng(6)
    if ltype in ("conv1d", "subsampling1d"):
        its, shape = (JInputType.recurrent(4, 9),
                      TInputType.recurrent(4, 9)), (2, 9, 4)
    else:
        its, shape = (JInputType.convolutional(5, 6, 4),
                      TInputType.convolutional(5, 6, 4)), (2, 5, 6, 4)
    jl = _graph_layer("jax", jc, its[0])
    tl = _graph_layer("torch", tc, its[1])
    assert tl.output_type.to_dict() == jl.output_type.to_dict()
    x = rng.normal(size=shape).astype(np.float32)
    params = {"W": rng.normal(size=(3, 4, 3)).astype(np.float32),
              "b": rng.normal(size=3).astype(np.float32)} \
        if ltype == "conv1d" else {}
    jy, _ = jl.apply({k: jnp.asarray(v) for k, v in params.items()}, {},
                     jnp.asarray(x))
    ty, _ = tl.apply({k: torch.tensor(v) for k, v in params.items()}, {},
                     torch.tensor(x))
    _close(ty, jy, ltype)


def test_pnorm_subsampling_is_refused_by_name():
    """Refused before slice 14; p-norm subsampling now gives the JAX
    package's (sum |x|^p + eps)^(1/p) (p = 2 here; p = 3 and gradients
    in tests/test_torch_vertices.py)."""
    jl = _graph_layer("jax", jconf.Subsampling(pooling="pnorm"),
                      JInputType.convolutional(4, 4, 2))
    tl = _graph_layer("torch", tconf.Subsampling(pooling="pnorm"),
                      TInputType.convolutional(4, 4, 2))
    x = np.random.default_rng(7).normal(size=(1, 4, 4, 2)).astype(np.float32)
    ty, _ = tl.apply({}, {}, torch.tensor(x))
    jy, _ = jl.apply({}, {}, jnp.asarray(x))
    _close(ty, jy, "pnorm pool")


@pytest.mark.parametrize("dtype,tf32_off", [(torch.float32, True),
                                            (torch.bfloat16, False)],
                         ids=["f32", "bf16"])
def test_conv2d_turns_tf32_off_for_f32_only(monkeypatch, dtype, tf32_off):
    """An F32 convolution enters cuDNN's flags with TF32 off and every
    other flag left as it stands (None), in its forward and again in its
    backward; a bf16 one changes nothing."""
    import contextlib
    calls = []

    def recorder(**kw):
        calls.append(kw)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.backends.cudnn, "flags", recorder)
    x = torch.ones((1, 4, 4, 2), dtype=dtype, requires_grad=True)
    w = torch.ones((3, 3, 2, 3), dtype=dtype, requires_grad=True)
    y = tconv.conv2d(x, w, strides=(1, 1), padding=[(1, 1), (1, 1)])
    assert y.shape == (1, 4, 4, 3) and y.dtype == dtype
    assert len(calls) == (1 if tf32_off else 0)
    y.sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    if tf32_off:
        assert len(calls) == 2
        for kw in calls:
            assert kw.pop("allow_tf32") is False
            assert all(v is None for v in kw.values()), kw
    else:
        assert calls == []
