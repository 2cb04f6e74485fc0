"""The order the streaming kernels S1 (``stream_dense``), S2
(``stream_mha``) and S3 (``stream_rownorm``) sum in, pinned on the CPU
(ops/stream_exact.py).

An independent numpy float32 reference of each (explicit ascending loops,
every product and every sum rounded to float32 on its own) holds the plain
versions bit for bit: S1 at R = 1, 7 and 33 rows with f ragged against the
kernel's 32-wide chunks; S2 at t = 1 and t = 16 with visible ranges of 1
position, a tile edge and the whole cache. exp is the one function the
reference takes from the device (torch.exp on a float32 CPU tensor, the
plain version's own), since numpy's float32 exp rounds differently from
the CPU's expf in the last bit.

The Hopper kernels' decomposition (``dense_plan``'s row and column tiles
and f-chunks, ``mha_plan``'s query groups and the k/v ring's tiles) is
emulated here in numpy, block by block, and lands on the same bits: a
row's sums do not depend on the tile or the block it falls in. A row's
plain output is bit-equal alone and in batches of 1, 8 and 64 rows. The
wrappers' refusals and the launch plans (tile counts, shared memory, the
cache limit) are checked without a card.

S3 sums each row by one tree fixed by the row's width: lane l of a
32-lane warp sums columns l, l + 32, ... ascending from +0.0, then five
butterfly rounds p + p[l ^ m] (m = 16, 8, 4, 2, 1). Its numpy reference
walks the lanes and the rounds one scalar add at a time and holds the
plain version bit for bit at widths 1, 31, 32, 33, 64 and 256; a row is
bit-equal alone and among 8 and 64 others; its launch plan and its
refusals, the width limit among them, are checked without a card.
"""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import stream_exact as se

F32 = np.float32


def _rng(seed):
    return np.random.default_rng(seed)


def _exp(a):
    """The plain version's exp on this device, applied to a float32
    array."""
    return torch.exp(torch.from_numpy(np.ascontiguousarray(a, F32))).numpy()


# --------------------------------------------------------------- reference
def dense_reference(x, W, b=None):
    """y[r, c] = (sum_i x[r, i] W[i, c]) + b[c]: i ascending from 0.0,
    each product and sum rounded to float32 on its own."""
    acc = np.zeros((x.shape[0], W.shape[1]), F32)
    for i in range(W.shape[0]):
        prod = np.multiply(x[:, i:i + 1], W[i][None, :], dtype=F32)
        acc = np.add(acc, prod, dtype=F32)
    return acc if b is None else np.add(acc, b, dtype=F32)


def mha_reference(q, k, v, pos):
    """Causal MHA of q [b, t, h, dh] against k, v [b, C, h, dh], row i of
    batch row r at position pos[r] + i, visible j <= min(pos[r] + i,
    C - 1), one (r, i, head) at a time: scores summed over d ascending,
    times 1/sqrt(dh); p = exp(s - max); l and o summed over j ascending;
    o / l."""
    b, t, h, dh = q.shape
    C = k.shape[1]
    scale = F32(1.0 / math.sqrt(dh))
    out = np.empty(q.shape, F32)
    for r in range(b):
        for i in range(t):
            last = min(int(pos[r]) + i, C - 1)
            for hd in range(h):
                s = np.zeros(last + 1, F32)
                for d in range(dh):
                    s = np.add(s, np.multiply(q[r, i, hd, d],
                                              k[r, :last + 1, hd, d],
                                              dtype=F32), dtype=F32)
                s = np.multiply(s, scale, dtype=F32)
                p = _exp(np.subtract(s, s.max(), dtype=F32))
                l, o = F32(0.0), np.zeros(dh, F32)
                for j in range(last + 1):
                    l = np.add(l, p[j], dtype=F32)
                    o = np.add(o, np.multiply(p[j], v[r, j, hd], dtype=F32),
                               dtype=F32)
                out[r, i, hd] = np.divide(o, l, dtype=F32)
    return out


# ---------------------------------------------------------------- emulation
def dense_emulation(x, W, b, plan):
    """S1's decomposition: blocks of (32 / tc) rt wb rows by 2 tc
    columns, f staged in DENSE_FK chunks; every (row, column) one chain in
    its thread, extended chunk by chunk."""
    rows, f = x.shape
    g = W.shape[1]
    br, bc = (32 // plan.tc) * plan.rt * plan.wb, 2 * plan.tc
    y = np.full((rows, g), np.nan, F32)
    for bx in range(plan.row_tiles):
        for by in range(plan.col_tiles):
            r0, c0 = bx * br, by * bc
            xr = x[r0:r0 + br]
            Wc = W[:, c0:c0 + bc]
            acc = np.zeros((xr.shape[0], Wc.shape[1]), F32)
            for i0 in range(0, f, se.DENSE_FK):
                for i in range(i0, min(f, i0 + se.DENSE_FK)):
                    acc = np.add(acc, np.multiply(xr[:, i:i + 1], Wc[i],
                                                  dtype=F32), dtype=F32)
            if b is not None:
                acc = np.add(acc, b[c0:c0 + bc], dtype=F32)
            y[r0:r0 + br, c0:c0 + bc] = acc
    return y


def mha_emulation(q, k, v, pos, plan):
    """S2's decomposition: a block per (row, head, group of qg query rows);
    the visible rows [0, L] of k, then of v, in tiles of plan.tj rows; the
    scores tile by tile, the row max, p, then l and o extended tile by
    tile, j ascending within a tile."""
    b, t, h, dh = q.shape
    C = k.shape[1]
    scale = F32(1.0 / math.sqrt(dh))
    out = np.full(q.shape, np.nan, F32)
    for r in range(b):
        for hd in range(h):
            for grp in range(plan.groups):
                i0 = grp * plan.qg
                nq = min(plan.qg, t - i0)
                p0 = int(pos[r]) + i0
                L = min(p0 + nq - 1, C - 1)
                last = [min(p0 + ii, C - 1) for ii in range(nq)]
                ps = np.zeros((nq, C), F32)
                tiles = range(0, L + 1, plan.tj)
                for j0 in tiles:
                    for ii in range(nq):
                        for j in range(j0, min(j0 + plan.tj, last[ii] + 1)):
                            s = F32(0.0)
                            for d in range(dh):
                                s = np.add(s, np.multiply(
                                    q[r, i0 + ii, hd, d], k[r, j, hd, d],
                                    dtype=F32), dtype=F32)
                            ps[ii, j] = np.multiply(s, scale, dtype=F32)
                for ii in range(nq):
                    row = ps[ii, :last[ii] + 1]
                    ps[ii, :last[ii] + 1] = _exp(np.subtract(
                        row, row.max(), dtype=F32))
                o = np.zeros((nq, dh), F32)
                l = np.zeros((nq, 1), F32)
                for j0 in tiles:
                    for ii in range(nq):
                        for j in range(j0, min(j0 + plan.tj, last[ii] + 1)):
                            l[ii] = np.add(l[ii], ps[ii, j], dtype=F32)
                            o[ii] = np.add(o[ii], np.multiply(
                                ps[ii, j], v[r, j, hd], dtype=F32),
                                dtype=F32)
                out[r, i0:i0 + nq, hd] = np.divide(o, l, dtype=F32)
    return out


# ------------------------------------------------------------------ inputs
def _dense_inputs(rows, f, g, seed, bias=True):
    rng = _rng(seed)
    x = rng.normal(size=(rows, f)).astype(F32)
    W = (rng.normal(size=(f, g)) / math.sqrt(f)).astype(F32)
    b = rng.normal(size=(g,)).astype(F32) * F32(0.1) if bias else None
    return x, W, b


def _mha_inputs(b, t, h, dh, C, pos, seed):
    rng = _rng(seed)
    q, k, v = (rng.normal(size=s).astype(F32)
               for s in ((b, t, h, dh), (b, C, h, dh), (b, C, h, dh)))
    return q, k, v, np.asarray(pos, np.int32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _bits_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return got.shape == want.shape and np.array_equal(
        got.view(np.uint32), want.view(np.uint32))


# ------------------------------------------------------ plain vs reference
DENSE_CASES = [  # rows, f, g: f = 37 and 70 leave a ragged 32-wide chunk
    (1, 64, 48), (7, 37, 33), (33, 70, 80), (33, 64, 40)]


@pytest.mark.parametrize("rows,f,g", DENSE_CASES)
@pytest.mark.parametrize("bias", [True, False])
def test_dense_plain_equals_the_numpy_reference(rows, f, g, bias):
    x, W, b = _dense_inputs(rows, f, g, seed=rows * 100 + f, bias=bias)
    got = se.stream_dense_torch(_t(x), _t(W), _t(b))
    assert _bits_equal(got, dense_reference(x, W, b))


# (b, t, C, pos): one visible position; a visible range ending on a tile
# edge of 8 rows and one past it; the whole cache (a last row at C - 1
# and past it, clamped); t = 16 chunks ending inside and at the cache's end
MHA_CASES = [
    (2, 1, 24, [0, 0]),
    (3, 1, 24, [7, 8, 15]),
    (2, 1, 24, [23, 30]),
    (2, 16, 24, [0, 8]),
    (1, 16, 24, [8]),
]


@pytest.mark.parametrize("b,t,C,pos", MHA_CASES)
def test_mha_plain_equals_the_numpy_reference(b, t, C, pos):
    q, k, v, p = _mha_inputs(b, t, 2, 8, C, pos, seed=b * 10 + t + C)
    got = se.stream_mha_torch(_t(q), _t(k), _t(v), torch.from_numpy(p))
    assert _bits_equal(got, mha_reference(q, k, v, p))


# -------------------------------------------- the kernels' decomposition
@pytest.mark.parametrize("rows,f,g", DENSE_CASES + [(64, 40, 72)])
@pytest.mark.parametrize("rt,tc,wb", [(None, None, None), (1, 4, 1),
                                      (2, 16, 4), (4, 4, 2)])
def test_dense_tiles_leave_the_bits_alone(rows, f, g, rt, tc, wb):
    x, W, b = _dense_inputs(rows, f, g, seed=rows + f + g)
    plan = se.dense_plan(rows, f, g, rt=rt, tc=tc, wb=wb)
    assert _bits_equal(dense_emulation(x, W, b, plan),
                       dense_reference(x, W, b))


@pytest.mark.parametrize("b,t,C,pos", MHA_CASES)
@pytest.mark.parametrize("tj,qg", [(8, 1), (5, 3), (24, 16)])
def test_mha_tiles_and_groups_leave_the_bits_alone(b, t, C, pos, tj, qg):
    q, k, v, p = _mha_inputs(b, t, 2, 8, C, pos, seed=b + t + C)
    qg = min(qg, t)
    plan = se.MhaPlan(qg=qg, groups=-(-t // qg), tj=tj, smem=0,
                      blocks=b * 2 * -(-t // qg))
    assert _bits_equal(mha_emulation(q, k, v, p, plan),
                       mha_reference(q, k, v, p))


# ------------------------------------------------ rows alone and in batches
@pytest.mark.parametrize("batch", [1, 8, 64])
def test_dense_row_is_bit_equal_alone_and_in_a_batch(batch):
    x, W, b = _dense_inputs(64, 48, 40, seed=3)
    full = se.stream_dense_torch(_t(x[:batch]), _t(W), _t(b))
    for r in {0, batch // 2, batch - 1}:
        alone = se.stream_dense_torch(_t(x[r:r + 1]), _t(W), _t(b))
        assert torch.equal(alone[0], full[r])


@pytest.mark.parametrize("batch", [1, 8, 64])
def test_mha_row_is_bit_equal_alone_and_in_a_batch(batch):
    C = 20
    pos = _rng(4).integers(0, C, 64).astype(np.int32)
    q, k, v, p = _mha_inputs(64, 1, 2, 8, C, pos, seed=5)
    sl = slice(0, batch)
    full = se.stream_mha_torch(_t(q[sl]), _t(k[sl]), _t(v[sl]),
                               torch.from_numpy(p[sl]))
    for r in {0, batch // 2, batch - 1}:
        one = slice(r, r + 1)
        alone = se.stream_mha_torch(_t(q[one]), _t(k[one]), _t(v[one]),
                                    torch.from_numpy(p[one]))
        assert torch.equal(alone[0], full[r])


# ------------------------------------------------------------ launch plans
# the decode path's shapes at gpt_mini's width: (rows, f, g) -> (rows a
# thread, column threads a warp, warps a block, blocks)
@pytest.mark.parametrize("shape,want", [
    ((32, 256, 256), (1, 4, 2, 64)), ((32, 256, 1024), (1, 16, 4, 128)),
    ((32, 1024, 256), (1, 4, 2, 64)), ((32, 256, 80), (1, 4, 2, 20)),
    ((64, 256, 256), (1, 4, 2, 128)), ((64, 256, 1024), (2, 16, 4, 128)),
    ((256, 256, 1024), (4, 16, 4, 256)), ((256, 1024, 256), (2, 16, 4, 128)),
    ((1, 256, 256), (1, 4, 2, 32)),
])
def test_dense_plan_at_the_decode_shapes(shape, want):
    plan = se.dense_plan(*shape)
    assert (plan.rt, plan.tc, plan.wb, plan.blocks) == want
    br, bc = (32 // plan.tc) * plan.rt * plan.wb, 2 * plan.tc
    assert plan.row_tiles == -(-shape[0] // br)
    assert plan.col_tiles == -(-shape[2] // bc)
    assert plan.smem == 4 * se.DENSE_STAGES * (
        br * se.DENSE_XS + se.DENSE_FK * bc)
    assert plan.smem <= se.SMEM_MAX


@pytest.mark.parametrize("shape,want", [
    # (b, t, h, dh, C) -> (qg, groups, blocks): the decode step fills a
    # wave; chunks and the one-shot prefill split their query rows
    ((32, 1, 4, 64, 256), (1, 1, 128)), ((4, 16, 4, 64, 256), (1, 16, 256)),
    ((1, 16, 4, 64, 256), (1, 16, 64)), ((1, 256, 4, 64, 256), (4, 64, 256)),
])
def test_mha_plan_at_the_decode_shapes(shape, want):
    plan = se.mha_plan(*shape)
    assert (plan.qg, plan.groups, plan.blocks) == want
    b, t, h, dh, C = shape
    assert plan.tj == 128
    # the ring's rows padded to dh + 4; q's, p's rows, the row max and
    # its four per-warp parts for each query row
    assert plan.smem == 4 * (
        se.MHA_STAGES * 128 * (dh + 4) + plan.qg * (dh + C + 5))
    assert plan.smem <= se.SMEM_MAX


def test_mha_cache_limit_is_above_the_first_versions():
    """The first version held p for 4 query rows a block (C up to ~14,000
    at dh 64); the new one holds one row of p beside its ring."""
    for dh, v4 in ((64, True), (128, True), (10, False)):
        limit = se.mha_cache_limit(dh, v4)
        assert limit > 14000
        assert se.mha_plan(1, 1, 4, dh, limit, v4).smem <= se.SMEM_MAX
        with pytest.raises(NotImplementedError, match=f"C <= {limit}"):
            se.mha_plan(1, 1, 4, dh, limit + 1, v4)


def test_mha_plan_bounds_the_outputs_a_thread_holds():
    plan = se.mha_plan(1, 256, 1, 256, 64)
    assert plan.qg * 256 <= se.MHA_MAX_ITEMS * se.MHA_THREADS
    with pytest.raises(NotImplementedError, match="head widths up to 1024"):
        se.mha_plan(1, 1, 1, 1032, 64)


def test_dense_plan_refuses_what_the_grid_cannot_hold():
    plan = se.dense_plan(100000, 8, 8, rt=1, tc=16, wb=1)
    assert plan.row_tiles == 50000     # past the first version's 65,535
    with pytest.raises(NotImplementedError, match="output columns"):
        se.dense_plan(1, 8, se.MAX_COL_TILES * 32 + 1, tc=16)


# ------------------------------------------------------ the wrappers' checks
def test_cuda_wrappers_refuse_cpu_tensors_and_bad_shapes():
    x, W, b = (torch.zeros(s) for s in ((4, 8), (8, 6), (6,)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        se.stream_dense_cuda(x, W, b)
    with pytest.raises(ValueError, match="stream_dense: x"):
        se.stream_dense_cuda(x, W, torch.zeros(5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        se.dense_launch_v1(x, W, b)
    q, kv = torch.zeros(2, 1, 2, 8), torch.zeros(2, 6, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        se.stream_mha_cuda(q, kv, kv, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        se.mha_launch_v1(q, kv, kv, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        se.stream_rownorm_cuda(x, torch.ones(8), torch.zeros(8), 1e-5)


def test_positions_already_int32_are_taken_without_a_copy():
    p = torch.tensor([3, 5], dtype=torch.int32)
    assert se._positions_i32(p, 2, p.device) is p
    got = se._positions_i32(torch.tensor([3, 5]), 2, p.device)
    assert got.dtype == torch.int32 and torch.equal(got, p)
    assert torch.equal(se._positions_i32(4, 3, p.device),
                       torch.full((3,), 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="pos has 3 rows"):
        se._positions_i32([1, 2, 3], 2, p.device)


def test_the_registry_reaches_only_the_new_entry_points():
    from deeplearning4j_tpu_torch.ops import registry
    assert registry.get(se.KERNEL_DENSE, "cuda") is se.stream_dense_cuda
    assert registry.get(se.KERNEL_MHA, "cuda") is se.stream_mha_cuda
    assert registry.get(se.KERNEL_DENSE, "cpu") is se.stream_dense_torch
    assert registry.get(se.KERNEL_MHA, "cpu") is se.stream_mha_torch


# ------------------------------------------------------------------- S3
def _tree_sum(row):
    """One row's sum in S3's order, one scalar float32 add at a time: lane
    l sums columns l, l + 32, ... ascending from +0.0 (a lane with no
    column keeps +0.0), then the butterfly p[l] + p[l ^ m] for m = 16, 8,
    4, 2, 1; lane 0's value."""
    p = [F32(0.0)] * 32
    for lane in range(32):
        for c in range(lane, row.shape[0], 32):
            p[lane] = np.add(p[lane], row[c], dtype=F32)
    for m in (16, 8, 4, 2, 1):
        p = [np.add(p[lane], p[lane ^ m], dtype=F32) for lane in range(32)]
    assert len({v.tobytes() for v in p}) == 1   # every lane, the same bits
    return p[0]


def rownorm_reference(x, gamma, beta, eps):
    """LayerNorm of each row of x [rows, w] in S3's order: mu = tree(x) /
    w, d = x - mu, var = tree(d * d) / w, inv = 1 / sqrt(var + eps), y =
    d * inv * gamma + beta, every operation rounded to float32 on its
    own."""
    rows, w = x.shape
    n, eps = F32(w), F32(eps)
    y = np.empty_like(x)
    for r in range(rows):
        mu = np.divide(_tree_sum(x[r]), n, dtype=F32)
        d = np.subtract(x[r], mu, dtype=F32)
        var = np.divide(_tree_sum(np.multiply(d, d, dtype=F32)), n,
                        dtype=F32)
        inv = np.divide(F32(1.0), np.sqrt(np.add(var, eps, dtype=F32),
                                          dtype=F32), dtype=F32)
        y[r] = np.add(np.multiply(np.multiply(d, inv, dtype=F32), gamma,
                                  dtype=F32), beta, dtype=F32)
    return y


def _norm_inputs(rows, w, seed):
    rng = _rng(seed)
    x = (rng.normal(size=(rows, w)) * 3.0 + 0.5).astype(F32)
    gamma = (rng.normal(size=(w,)) * 0.1 + 1.0).astype(F32)
    beta = (rng.normal(size=(w,)) * 0.1).astype(F32)
    return x, gamma, beta


@pytest.mark.parametrize("w", [1, 31, 32, 33, 64, 256])
@pytest.mark.parametrize("rows", [1, 7, 33])
def test_rownorm_plain_equals_the_numpy_tree_reference(rows, w):
    x, gamma, beta = _norm_inputs(rows, w, seed=rows * 1000 + w)
    got = se.stream_rownorm_torch(_t(x), _t(gamma), _t(beta), 1e-5)
    assert _bits_equal(got, rownorm_reference(x, gamma, beta, 1e-5))


def test_rownorm_tree_is_not_the_ascending_chain():
    """The reference really sums by the tree: on these rows a single
    ascending chain lands on other bits (so the test above could not pass
    with the first version's order)."""
    x, _, _ = _norm_inputs(64, 256, seed=5)
    chain = [np.add.accumulate(row, dtype=F32)[-1] for row in x]
    assert any(_tree_sum(row) != c for row, c in zip(x, chain))


@pytest.mark.parametrize("batch", [1, 8, 64])
def test_rownorm_row_is_bit_equal_alone_and_in_a_batch(batch):
    x, gamma, beta = _norm_inputs(64, 256, seed=17)
    g, b = _t(gamma), _t(beta)
    many = se.stream_rownorm_torch(_t(x[:batch]), g, b, 1e-5)
    for r in (0, batch - 1):
        alone = se.stream_rownorm_torch(_t(x[r:r + 1]), g, b, 1e-5)
        assert torch.equal(alone[0], many[r])
    # the [b, t, w] layout the streaming path gives it
    assert torch.equal(
        se.stream_rownorm_torch(_t(x[:batch]).reshape(batch, 1, 256), g, b,
                                1e-5)[:, 0], many)


@pytest.mark.parametrize("w,want", [(1, 1), (31, 1), (32, 1), (33, 2),
                                    (256, 8), (1000, 32), (1024, 32),
                                    (1025, 0), (4099, 0)])
def test_rownorm_plan_holds_the_row_in_registers_up_to_1024(w, want):
    assert se.rownorm_plan(32, w) == want


def test_rownorm_refusals():
    with pytest.raises(NotImplementedError, match="at most 2147483647 "
                       "columns"):
        se.rownorm_plan(1, 2 ** 31)
    with pytest.raises(NotImplementedError, match="rows"):
        se.rownorm_plan(se.NORM_WARPS * (2 ** 31 - 1) + 1, 256)
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        se.stream_rownorm_cuda(x, torch.ones(8), torch.zeros(8), 1e-5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        se.rownorm_launch_v1(x, torch.ones(8), torch.zeros(8), 1e-5)
    assert registry_get_norm() == (se.stream_rownorm_torch,
                                   se.stream_rownorm_cuda)


def registry_get_norm():
    from deeplearning4j_tpu_torch.ops import registry
    return (registry.get(se.KERNEL_NORM, "cpu"),
            registry.get(se.KERNEL_NORM, "cuda"))
