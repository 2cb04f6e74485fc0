"""The port's fx hazard lint (deeplearning4j_tpu_torch/analysis/fx_lint.py).

The JAX package's jaxpr lint cannot trace its shipped targets under this
jax (``jax.core.Jaxpr`` is gone), so each check is held here to its
formulation: one fixture per code that raises it and a clean counterpart,
the six shipped targets (the JAX package's target names) clean on the
CPU, and the kernel nodes the card's record shows, through a stand-in
wrapper that reports itself as the real ones do.
"""

import pytest
import torch

from deeplearning4j_tpu_torch.analysis import fx_lint
from deeplearning4j_tpu_torch.nn.updater import _map
from deeplearning4j_tpu_torch.ops import attention, registry


def _codes(findings):
    return sorted(f.code for f in findings)


def _fx(fn, *args, params=(), compute="float32"):
    _, nodes = fx_lint.record_fx(fn, args, list(params))
    return fx_lint.check_ir(nodes, "fixture", compute)


def test_target_names_are_the_jax_packages():
    from deeplearning4j_tpu.analysis import jaxpr_lint
    assert fx_lint.list_targets() == jaxpr_lint.list_targets()


@pytest.mark.parametrize("name", fx_lint.list_targets())
def test_shipped_target_is_clean(name):
    assert fx_lint.lint_target(name) == []


def test_j000_a_target_that_fails_is_a_finding():
    def boom(device="cpu"):
        raise RuntimeError("fixture blew up")
    fx_lint.TARGETS["_boom"] = boom
    try:
        findings = fx_lint.lint_target("_boom")
    finally:
        del fx_lint.TARGETS["_boom"]
    assert _codes(findings) == ["DL4J-J000"]
    assert "fixture blew up" in findings[0].message


def test_j001_f32_product_of_master_weights_under_bf16():
    W = torch.randn(4, 3)
    x = torch.randn(2, 4).to(torch.bfloat16)
    upcast = lambda x: torch.mm(x.float(), W)               # noqa: E731
    halved = lambda x: torch.mm(x, W.to(torch.bfloat16))    # noqa: E731
    assert _codes(_fx(upcast, x, params=[W], compute="bfloat16")) == \
        ["DL4J-J001"]
    assert _fx(halved, x, params=[W], compute="bfloat16") == []
    # under an f32 policy the same product is what was asked for
    assert _fx(upcast, x, params=[W], compute="float32") == []
    # f32 products of values cast from bf16 (attention's accumulation)
    # read no master weight
    acc = lambda x: torch.mm(x.float(), x.float().t())      # noqa: E731
    assert _fx(acc, x, params=[W], compute="bfloat16") == []


def test_j001_follows_a_value_computed_from_master_weights():
    W = torch.randn(4, 3)
    x = torch.randn(2, 4).to(torch.bfloat16)
    scaled = lambda x: torch.mm(x.float(), W * 2.0)         # noqa: E731
    assert _codes(_fx(scaled, x, params=[W], compute="bfloat16")) == \
        ["DL4J-J001"]
    nodes = fx_lint.record_dispatch(scaled, (x,), [W])
    assert _codes(fx_lint.check_ir(nodes, "f", "bfloat16")) == ["DL4J-J001"]


def test_j002_float64_output():
    x = torch.randn(3)
    found = _fx(lambda x: x.double() * 2, x)
    assert set(_codes(found)) == {"DL4J-J002"}
    assert sorted(f.message for f in found) == [
        "_to_copy produces float64", "mul produces float64"]
    assert _fx(lambda x: x * 2, x) == []


def test_j003_a_value_baked_into_the_graph():
    """A step that reads a host counter into a Python scalar (a decay by
    the iteration) records another graph at every call; the same
    schedule on a device tensor records one."""
    count = {"it": 0}
    it = torch.zeros(())

    def baked(x):
        count["it"] += 1
        return x * 0.5 ** count["it"]

    def traced(x):
        it.add_(1)
        return x * torch.pow(0.5, it)

    for fn, want in ((baked, ["DL4J-J003"]), (traced, [])):
        ga, _ = fx_lint.record_fx(fn, (torch.full((3,), 0.0),), [])
        gb, _ = fx_lint.record_fx(fn, (torch.full((3,), 0.25),), [])
        assert _codes(fx_lint.check_retrace(ga.code, gb.code, "f")) == want


def test_a_host_read_of_an_input_fails_to_trace():
    """Reading an input's value on the host cannot be recorded at all: a
    target doing it is a J000 finding, never a skip."""
    def boom(device="cpu"):
        t = fx_lint.TARGETS["mnist_mlp.forward"](device)
        t.fn = lambda x: x * float(x.sum())
        return t
    fx_lint.TARGETS["_host_read"] = boom
    try:
        found = fx_lint.lint_target("_host_read")
    finally:
        del fx_lint.TARGETS["_host_read"]
    assert _codes(found) == ["DL4J-J000"]


def test_j003_a_step_graph_that_captures_again():
    assert _codes(fx_lint.check_captures(2, "t")) == ["DL4J-J003"]
    assert fx_lint.check_captures(1, "t") == []


def test_j004_a_fit_step_that_reallocates_its_state():
    t = fx_lint.TARGETS["graph.fit_step"]()
    net, batch = t.net, t.args_a[0]
    t.fn(batch)
    before = fx_lint.storages(net)
    t.fn(batch)
    assert fx_lint.check_realloc(before, fx_lint.storages(net), "g") == []
    net.params = _map(lambda p: p.detach().clone(), net.params)
    t.fn(batch)
    found = fx_lint.check_realloc(before, fx_lint.storages(net), "g")
    assert _codes(found) == ["DL4J-J004"] and "params/" in found[0].message


def test_j005_an_op_outside_the_allowlist():
    x = torch.randn(5)
    assert _codes(_fx(lambda x: torch.cumsum(x, 0), x)) == ["DL4J-J005"]
    assert "cumsum" in _fx(lambda x: torch.cumsum(x, 0), x)[0].message
    assert _fx(lambda x: torch.exp(x).sum(), x) == []


def test_every_allowlist_entry_has_a_reason():
    assert all(isinstance(r, str) and r.strip()
               for r in fx_lint.DETERMINISM_ALLOWLIST.values())


def _fake_flash(q):
    """Reports itself as K3's wrapper does on the card."""
    out = torch.empty_like(q)
    out.copy_(q)
    registry.note_kernel(attention.KERNEL, out, (attention.KERNEL_SM90,))
    return out


def test_a_kernel_is_a_node_of_the_record_with_its_dtype():
    q = torch.randn(2, 8, 2, 64).to(torch.bfloat16)
    nodes = fx_lint.record_dispatch(lambda q: _fake_flash(q) * 2, (q,), [])
    kernels = [n for n in nodes if n.kernels]
    assert [n.op for n in nodes].index("kernel:flash_attn_fwd") < \
        [n.op for n in nodes].index("mul")
    (k,) = kernels
    assert k.out_dtypes == (torch.bfloat16,)
    assert fx_lint.kernel_counts(nodes) == {"flash_attn_fwd": 1,
                                            "flash_attn_fwd_sm90": 1}
    assert "kernel:flash_attn_fwd" not in fx_lint.histogram(nodes)
    assert fx_lint.check_ir(nodes, "k", "bfloat16") == []
    # no recorder open: the report costs nothing and goes nowhere
    _fake_flash(q)


def test_an_unknown_kernel_is_a_j005_finding():
    def launch(x):
        registry.note_kernel("mystery_kernel", x)
        return x
    nodes = fx_lint.record_dispatch(launch, (torch.ones(2),), [])
    found = fx_lint.check_ir(nodes, "k", "float32")
    assert _codes(found) == ["DL4J-J005"]
    assert "kernel 'kernel:mystery_kernel'" in found[0].message


def test_the_device_lint_runs_on_the_cpu_too():
    """``lint_on_device`` (the card's phase) on a tiny gpt_mini on the
    CPU: the dispatch record, J004 over an eager step and the step
    graph's steps (eager here)."""
    t = fx_lint.TARGETS["gpt_mini.fit_step"]()
    findings, info = fx_lint.lint_on_device(t.net, t.args_a[0],
                                            t.args_b[0], "gpt_mini.fit_step",
                                            steps=2)
    assert findings == []
    assert info["ops"]["mm"] > 0 and info["kernels"] == {}
    assert info["captures"] == 0
