"""Decode on a model axis (deeplearning4j_tpu_torch/serving/decode.py
``StreamingKVForward.refresh_params``) against the unmeshed port engine
and the JAX package's engine, on the CPU.

A fleet of two gloo rank processes on ``{"model": 2}``: each restores
tests/test_torch_decode.py's gpt_mini (V 23, width 32, 2 blocks, 4
heads, max_len 48, seed 7, F32) from the JAX package's zip, places it
with ``gpt_mini_tp_rules`` and builds a ``DecodeEngine`` (the gather of
the shards, a collective of both ranks). The leader decodes four
sessions greedily, recording every logits row; both ranks then call
``refresh_params`` (a collective) and the leader decodes one session
again. Meanwhile this process decodes the same prompts on the unmeshed
port engine and on the JAX package's.

Tolerances: the meshed engine's tokens and logits bit for bit against
the unmeshed port engine's (the gathered params are the whole params);
against the JAX engine tests/test_torch_decode.py's: logits within 1e-5
(tests/test_torch_decode_exact.py) and tokens equal wherever every
emitted position's top-2 margin exceeds 1e-4.
"""

import json

import numpy as np
import pytest

from _torch_fleet import greedy, run_fleets
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.serving import decode as jdecode
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.serving import decode as tdecode
from deeplearning4j_tpu_torch.utils import serialization as tser

PROC_TIMEOUT_S = 300
V, N_NEW = 23, 6
SIZE = dict(vocab_size=V, width=32, n_layers=2, n_heads=4, seed=7)
PROMPTS = {f"s{i}": [int(t) for t in np.random.default_rng(20 + i)
                     .integers(0, V, n)]
           for i, n in enumerate([5, 9, 13, 17])}
MARGIN = 1e-4
LOGITS_ATOL = 1e-5


_WORKER = r"""
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
from _torch_fleet import greedy
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
from deeplearning4j_tpu_torch.utils import serialization as tser
with open(f"{tmp}/prompts.json") as fh:
    PROMPTS, N_NEW = json.load(fh)
res, arrays = {}, {}
try:
    net = tser.restore_multi_layer_network(f"{tmp}/g.zip", device="cpu")
    net.use_mesh(make_mesh({"model": 2}), model_axis="model",
                 tp_rules=zoo.gpt_mini_tp_rules())
    res["wq_shard"] = list(net.params["layer_1"]["Wq"].shape)
    eng = DecodeEngine(net, replicas=1, batch_window_ms=1.0)
    res["wq_engine"] = list(eng.forward._params["layer_1"]["Wq"].shape)
    try:
        if rank == 0:
            for sid, (toks, rows) in greedy(eng, PROMPTS, N_NEW).items():
                res[sid] = toks
                arrays[sid] = np.stack(rows)
        eng.refresh_params()
        if rank == 0:
            again = greedy(eng, {"s0": PROMPTS["s0"]}, N_NEW)["s0"]
            res["again"] = again[0]
            arrays["again"] = np.stack(again[1])
    finally:
        eng.stop()
finally:
    save(res, **arrays)
    D.shutdown()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_decode")
    jnet = jzoo.gpt_mini(max_len=48, dtype=jzoo.F32, **SIZE)
    jser.write_model(jnet, str(tmp / "g.zip"))
    with open(tmp / "prompts.json", "w") as f:
        json.dump([PROMPTS, N_NEW], f)

    def references():
        tnet = tser.restore_multi_layer_network(str(tmp / "g.zip"),
                                                device="cpu")
        out = {}
        for name, mod, net in (("port", tdecode, tnet),
                               ("jax", jdecode, jnet)):
            eng = mod.DecodeEngine(net, replicas=1, batch_window_ms=1.0)
            try:
                out[name] = greedy(eng, PROMPTS, N_NEW)
            finally:
                eng.stop()
        return out

    port, refs = run_fleets([("m2", _WORKER, 2, tmp)], references,
                            PROC_TIMEOUT_S)
    return port["m2"], refs


def test_the_engine_gathers_the_shards_whole(runs):
    fleet, _ = runs
    for res, _ in fleet:
        assert res["wq_shard"] == [32, 16]
        assert res["wq_engine"] == [32, 32]


@pytest.mark.parametrize("sid", sorted(PROMPTS))
def test_meshed_decode_bit_equal_to_the_unmeshed_engine(runs, sid):
    res, arrays = runs[0][0]
    toks, rows = runs[1]["port"][sid]
    assert res[sid] == toks
    assert np.array_equal(arrays[sid], np.stack(rows))


@pytest.mark.parametrize("sid", sorted(PROMPTS))
def test_meshed_decode_within_the_jax_engine_bounds(runs, sid):
    res, arrays = runs[0][0]
    jtoks, jrows = runs[1]["jax"][sid]
    np.testing.assert_allclose(arrays[sid], np.stack(jrows), rtol=0,
                               atol=LOGITS_ATOL)
    margins = [np.diff(np.sort(r)[-2:])[0] for r in jrows]
    if min(margins) > MARGIN:
        assert res[sid] == jtoks


def test_refresh_is_a_collective_that_keeps_the_stream(runs):
    res, arrays = runs[0][0]
    assert res["again"] == res["s0"]
    assert np.array_equal(arrays["again"], arrays["s0"])


def test_a_model_axis_without_a_process_group_raises(monkeypatch):
    import torch.distributed as dist

    from deeplearning4j_tpu_torch import zoo
    net = zoo.gpt_mini(vocab_size=V, width=32, n_layers=2, n_heads=4,
                       max_len=16, device="cpu", dtype=zoo.F32)
    net._tp = object()     # placed on a model axis, no group behind it
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="no process group is up"):
        tdecode.StreamingKVForward(net)
