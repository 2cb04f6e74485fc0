"""The port's streaming path is decode-stable on the CPU: a token's logits
have the same bits whether it came from a one-shot prefill, a chunked
prefill, a single-token step or a row padded into a bucket
(ops/stream_exact.py, serving/decode.py's contract).

At the JAX tests' size (tests/test_transformer.py: V = 23, width 32, 2
blocks, 4 heads, max_len 48, seed 7), the JAX package's gpt_mini is
transplanted into the port through the zip. Token-by-token against one-shot
at t = 3, 8, 9, 16, 17 (across the 8 -> 16 prompt rung), chunked prefill,
a ragged bucket against batch-1 and the BF16 policy are held bit for bit;
the order-fixed plain versions of S1-S3 are held to the JAX package's
``_dense_exact``, ``_causal_mha_exact`` and ``_layer_norm`` at 1e-5 (both
are f32 sums of the same products, each package in its own fixed order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.nn.layers import attention as jlatt
from deeplearning4j_tpu.ops import attention as jatt
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.ops import attention as tatt
from deeplearning4j_tpu_torch.ops import registry
from deeplearning4j_tpu_torch.ops import stream_exact as se
from deeplearning4j_tpu_torch.serving.decode import StreamingKVForward
from deeplearning4j_tpu_torch.utils import serialization as tser

V = 23
F32_TOL = 1e-5
SIZE = dict(vocab_size=V, width=32, n_layers=2, n_heads=4, max_len=48,
            seed=7)


def _ids(n, seed=0):
    return [int(i) for i in np.random.default_rng(seed).integers(0, V, n)]


def _onehot(ids):
    return np.eye(V, dtype=np.float32)[np.asarray(ids)]


def _transplant(policy, tmp_path_factory):
    jnet = jzoo.gpt_mini(dtype=getattr(jzoo.models, policy), **SIZE)
    path = tmp_path_factory.mktemp("decode_exact") / f"{policy}.zip"
    jser.write_model(jnet, str(path))
    return tser.restore_multi_layer_network(str(path), device="cpu")


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    return _transplant("F32", tmp_path_factory)


@pytest.fixture(scope="module")
def bf16_net(tmp_path_factory):
    return _transplant("BF16", tmp_path_factory)


def _stream(net, chunks):
    net.rnn_clear_previous_state()
    try:
        return np.concatenate([net.rnn_time_step(_onehot(c)[None]).numpy()
                               for c in chunks], axis=1)
    finally:
        net.rnn_clear_previous_state()


@pytest.mark.parametrize("t", [3, 8, 9, 16, 17])
def test_token_by_token_matches_one_shot(net, t):
    ids = _ids(t, seed=t)
    full = _stream(net, [ids])
    steps = _stream(net, [[i] for i in ids])
    np.testing.assert_array_equal(steps, full)


def test_chunked_prefill_matches_one_shot(net):
    ids = _ids(20, seed=3)
    np.testing.assert_array_equal(_stream(net, [ids[:9], ids[9:]]),
                                  _stream(net, [ids]))


def test_bf16_policy_keeps_bit_identity(bf16_net):
    ids = _ids(12, seed=5)
    np.testing.assert_array_equal(_stream(bf16_net, [[i] for i in ids]),
                                  _stream(bf16_net, [ids]))


def test_ragged_masked_prefill_matches_batch1(net):
    """The serving prefill: ragged prompts right-padded into one bucket
    with a mask give each row its batch-1 logits, bit for bit."""
    fwd = StreamingKVForward(net)
    lens, bucket = [5, 9, 13, 16], 16
    xs, ms, refs = [], [], []
    for i, t in enumerate(lens):
        ids = _ids(t, seed=10 + i)
        x = np.zeros((bucket, V), np.float32)
        x[:t] = _onehot(ids)
        m = np.zeros(bucket, np.float32)
        m[:t] = 1.0
        xs.append(x)
        ms.append(m)
        refs.append(fwd([_onehot(ids)[None], np.ones((1, t), np.float32)]))
    out = fwd([np.stack(xs), np.stack(ms)])
    for i, t in enumerate(lens):
        np.testing.assert_array_equal(out[0][i], refs[i][0][0])
        # the caches below each row's frontier and its positions; a padded
        # row writes past its frontier, where nothing attends before the
        # row's next tokens overwrite it
        for leaf, ref in zip(out[1:], refs[i][1:]):
            np.testing.assert_array_equal(leaf[i][:t] if leaf.ndim > 1
                                          else leaf[i], ref[0][:t]
                                          if leaf.ndim > 1 else ref[0])


def test_streaming_matches_jax_within_f32(net):
    """The same tokens through the JAX package's streaming path: f32
    tolerance, not bits (each package sums in its own fixed order)."""
    jnet = jzoo.gpt_mini(dtype=jzoo.F32, **SIZE)
    ids = _ids(16, seed=9)
    want = np.asarray(jnet.rnn_time_step(jnp.asarray(_onehot(ids)[None])))
    np.testing.assert_allclose(_stream(net, [ids]), want, atol=F32_TOL,
                               rtol=F32_TOL)


def _rng_f32(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(0.0, scale, shape)
            .astype(np.float32))


@pytest.mark.parametrize("bias", [True, False])
def test_plain_dense_matches_jax_dense_exact(bias):
    x, W = _rng_f32(1, 3, 5, 32), _rng_f32(2, 32, 20, scale=0.2)
    b = _rng_f32(3, 20) if bias else None
    want = np.asarray(jlatt._dense_exact(
        jnp.asarray(x), jnp.asarray(W), None if b is None else jnp.asarray(b)))
    got = se.stream_dense_torch(torch.from_numpy(x), torch.from_numpy(W),
                                None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (3, 5, 20)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("t,pos", [(1, [0, 11]), (3, [0, 7]), (12, [0, 0])])
def test_plain_mha_matches_jax_causal_mha_exact(t, pos):
    q = _rng_f32(4, 2, t, 4, 8)
    kc, vc = _rng_f32(5, 2, 12, 4, 8), _rng_f32(6, 2, 12, 4, 8)
    p = np.asarray(pos, np.int32)
    want = np.asarray(jatt._causal_mha_exact(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(p)))
    got = se.stream_mha_torch(*(torch.from_numpy(a) for a in (q, kc, vc)),
                              torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    # decode_mha runs the same function through the registry
    assert torch.equal(tatt.decode_mha(*(torch.from_numpy(a)
                                         for a in (q, kc, vc)),
                                       torch.from_numpy(p)), got)


def test_plain_rownorm_matches_jax_layer_norm():
    x = _rng_f32(7, 4, 3, 32, scale=3.0)
    g, b = _rng_f32(8, 32, scale=0.1) + 1.0, _rng_f32(9, 32, scale=0.1)
    want = np.asarray(jlatt._layer_norm(jnp.asarray(x), jnp.asarray(g),
                                        jnp.asarray(b), 1e-5))
    got = se.stream_rownorm_torch(*(torch.from_numpy(a) for a in (x, g, b)),
                                  1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("rows", [1, 2, 7])
def test_plain_versions_do_not_move_with_the_row_count(rows):
    """Each row of an order-fixed op has the same bits alone as among
    others (what torch.matmul does not promise)."""
    x, W = _rng_f32(10, 7, 64), _rng_f32(11, 64, 48, scale=0.1)
    xt, Wt = torch.from_numpy(x), torch.from_numpy(W)
    g, b = torch.ones(64), torch.zeros(64)
    assert torch.equal(se.stream_dense_torch(xt[:rows], Wt),
                       se.stream_dense_torch(xt, Wt)[:rows])
    assert torch.equal(se.stream_rownorm_torch(xt[:rows], g, b, 1e-5),
                       se.stream_rownorm_torch(xt, g, b, 1e-5)[:rows])


def test_registry_dispatch_and_cuda_wrappers_refuse_cpu_tensors():
    assert registry.get(se.KERNEL_DENSE, "cpu") is se.stream_dense_torch
    assert registry.get(se.KERNEL_DENSE, "cuda") is se.stream_dense_cuda
    assert registry.get(se.KERNEL_MHA, "cpu") is se.stream_mha_torch
    assert registry.get(se.KERNEL_MHA, "cuda") is se.stream_mha_cuda
    assert registry.get(se.KERNEL_NORM, "cpu") is se.stream_rownorm_torch
    assert registry.get(se.KERNEL_NORM, "cuda") is se.stream_rownorm_cuda
    # the training path's causal_mha keeps its batched-product CPU version
    assert registry.get("causal_mha", "cpu") is tatt.causal_mha_exact
    x = torch.zeros(2, 8)
    registry.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        se.stream_dense_cuda(x, torch.zeros(8, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        se.stream_rownorm_cuda(x, torch.ones(8), torch.zeros(8), 1e-5)
    q = torch.zeros(1, 1, 2, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        se.stream_mha_cuda(q, torch.zeros(1, 4, 2, 4), torch.zeros(1, 4, 2, 4),
                           torch.zeros(1, dtype=torch.int32))
    assert registry.launches() == {}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def test_cuda_kernels_match_plain_bit_for_bit(cuda_device):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 64, generator=g).to(cuda_device)
    W = torch.randn(64, 48, generator=g).to(cuda_device)
    b = torch.randn(48, generator=g).to(cuda_device)
    gam = torch.randn(64, generator=g).to(cuda_device)
    q = torch.randn(2, 3, 4, 16, generator=g).to(cuda_device)
    kc = torch.randn(2, 12, 4, 16, generator=g).to(cuda_device)
    vc = torch.randn(2, 12, 4, 16, generator=g).to(cuda_device)
    pos = torch.tensor([0, 7], dtype=torch.int32, device=cuda_device)
    with torch.inference_mode():
        assert torch.equal(se.stream_dense_cuda(x, W, b),
                           se.stream_dense_torch(x, W, b))
        assert torch.equal(se.stream_rownorm_cuda(x, gam, gam, 1e-5),
                           se.stream_rownorm_torch(x, gam, gam, 1e-5))
        assert torch.equal(se.stream_mha_cuda(q, kc, vc, pos),
                           se.stream_mha_torch(q, kc, vc, pos))
