"""The dense layers' F32 inference route onto S1 (ops/stream_exact.py
``dense_route``, nn/layers/feedforward.py ``dense_product``), on the CPU.

- ``dense_route``: "stream" only for an F32 product on the card with no
  grad; "matmul" for training, the other dtypes and the CPU.
- S1's plain version (``stream_dense_torch``) under column slicing: the
  product with a column slice of W is the whole product's columns bit
  for bit, at mnist_mlp's served layer shapes (784 x 256 and 256 x 128
  at 1, 3, 7 and 29 rows) and VGG-16's head fc3 (4096 x 1000 at 1-4
  rows): each output sums over f in one order whatever the width.
- The layers' plumbing, with the route forced to "stream" on the CPU
  (the card's choice): mnist_mlp's ``net.output`` and the mesh-serving
  walk's column shards give the same bits, each product counted under
  ``dense:route[stream]`` and never among the composed routes; an
  RnnOutput head takes the same route. Unforced, the CPU's products
  stay ``torch.matmul``'s (what the JAX parity tests hold).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.nn.layers import feedforward
from deeplearning4j_tpu_torch.ops import registry, stream_exact

STREAM = "dense:route[stream]"


@pytest.mark.parametrize("dtype,device,train,want", [
    (torch.float32, "cuda", False, "stream"),
    (torch.float32, "cuda:0", False, "stream"),
    (torch.float32, "cuda", True, "matmul"),
    (torch.bfloat16, "cuda", False, "matmul"),
    (torch.float16, "cuda", False, "matmul"),
    (torch.float64, "cuda", False, "matmul"),
    (torch.float32, "cpu", False, "matmul"),
    (torch.float32, "cpu", True, "matmul"),
])
def test_dense_route_choices(dtype, device, train, want):
    assert stream_exact.dense_route(dtype, device, train) == want


@pytest.mark.parametrize("rows", [1, 3, 7, 29])
@pytest.mark.parametrize("f,g", [(784, 256), (256, 128)])
def test_s1_plain_columns_bit_equal_at_mnist_shapes(f, g, rows):
    rng = np.random.default_rng(rows + f)
    x = torch.from_numpy(rng.normal(size=(rows, f)).astype(np.float32))
    W = torch.from_numpy(rng.normal(0, 0.05, (f, g)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, g).astype(np.float32))
    whole = stream_exact.stream_dense_torch(x, W, b)
    for lo, hi in ((0, g // 2), (g // 2, g), (3, g - 5)):
        part = stream_exact.stream_dense_torch(
            x, W[:, lo:hi].contiguous(), b[lo:hi].contiguous())
        assert torch.equal(part, whole[:, lo:hi]), (lo, hi)


@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_s1_plain_columns_bit_equal_at_vgg_fc3(rows):
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.normal(size=(rows, 4096)).astype(np.float32))
    W = torch.from_numpy(rng.normal(0, 0.02, (4096, 1000))
                         .astype(np.float32))
    whole = stream_exact.stream_dense_torch(x, W)
    part = stream_exact.stream_dense_torch(x, W[:, 500:].contiguous())
    assert torch.equal(part, whole[:, 500:])


def _forced(dtype, device, train):
    """The card's choice, taken on the CPU."""
    return "stream" if dtype == torch.float32 and not train else "matmul"


@pytest.mark.parametrize("rows", [2, 8])
def test_forced_route_holds_the_mesh_walk_to_net_output(monkeypatch, rows):
    monkeypatch.setattr(stream_exact, "dense_route", _forced)
    net = zoo.mnist_mlp(seed=5, device="cpu")
    x = torch.from_numpy(np.random.default_rng(rows).normal(
        size=(rows, 784)).astype(np.float32))
    registry.reset_launches()
    out = net.output(x)
    assert registry.launches().get(STREAM) == 3
    assert not registry.routes()
    # the walk of the mesh-serving forward on two column shards of each
    # layer (parallel/inference.py: activations per shard, then a
    # concatenation), the softmax head whole
    h = x
    with torch.inference_mode():
        for layer in net.layers[:2]:
            p = net.params[layer.name]
            n = p["W"].shape[1] // 2
            h = torch.cat([layer.apply(
                {"W": p["W"][:, i * n:(i + 1) * n].contiguous(),
                 "b": p["b"][i * n:(i + 1) * n].contiguous()}, {}, h)[0]
                for i in range(2)], dim=-1)
        walked = net.layers[2].apply(net.params["layer_2"], {}, h)[0]
    assert torch.equal(walked, out)


def test_forced_route_only_without_grad(monkeypatch):
    monkeypatch.setattr(stream_exact, "dense_route", _forced)
    net = zoo.mnist_mlp(seed=5, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 784)).astype(np.float32))
    layer, p = net.layers[0], net.params["layer_0"]
    registry.reset_launches()
    with torch.enable_grad():
        z = layer.preout(p, x)
    assert registry.launches().get(STREAM) is None
    assert torch.equal(z, torch.matmul(x, p["W"]) + p["b"])


def test_forced_route_rnn_output_head(monkeypatch):
    monkeypatch.setattr(stream_exact, "dense_route", _forced)
    net = zoo.char_rnn(vocab_size=12, hidden=16, n_layers=1, device="cpu",
                       dtype=zoo.F32)
    head = net.layers[-1]
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 5, 16)).astype(np.float32))
    p = net.params[head.name]
    registry.reset_launches()
    with torch.inference_mode():
        z = head.preout(p, x)
    assert registry.launches().get(STREAM) == 1
    assert torch.equal(z, stream_exact.stream_dense_torch(x, p["W"],
                                                          p["b"]))


def test_the_cpu_keeps_the_matmul_product():
    net = zoo.mnist_mlp(seed=5, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 784)).astype(np.float32))
    layer, p = net.layers[0], net.params["layer_0"]
    registry.reset_launches()
    with torch.inference_mode():
        z = layer.preout(p, x)
        want = feedforward.dense_product(x, p["W"], p["b"], torch.float32)
    assert registry.launches().get(STREAM) is None
    assert torch.equal(z, torch.matmul(x, p["W"]) + p["b"])
    assert torch.equal(z, want)
