#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ops/csrc/ (the LSTM forward K1 and
backward K2, the flash-attention forward K3, the fused bottleneck tail's
K4-K7), holds each against its plain PyTorch version on the card, serves
the full-width GravesLSTM char-RNN (vocab 80, hidden 512, 2 layers, BF16)
through ``ModelServer`` ``/predict``, streams through ``rnn_time_step``,
trains the same model with ``fit_batch`` (standard backprop, then
truncated BPTT), then serves and trains the full-width gpt_mini
transformer (vocab 80, width 256, 4 blocks of 4 heads, T = 256, BF16,
Adam) the same way, trains the full-width ResNet-50 (1000 classes,
224 x 224, b = 256, BF16, Nesterovs) with the block-fusion pass on and
off, checks that each path launched its kernels, and times the kernels
and the train steps. Then it trains LeNet (28 x 28 x 1, BF16) through
``MultiLayerNetwork.fit`` with the listeners, early-stops it and evaluates
it, trains the full-width VGG-16 (224 x 224, 1000 classes, BF16) and
ResNet-18 (32 x 32, 10 classes, BF16) and evaluates the graph; these
paths reach none of the port's kernels (cuDNN and cuBLAS only). Then it
captures the train steps ([train_captured]) and runs the fault-tolerant
supervisor, the solvers, gradient checks, transfer learning and
pretraining (--slice12 below), the data-fed observed runs (--slice13),
and slice 14's graph phases (--slice14 below: the skip-connected
char-RNN graph trained with tBPTT and streamed, a vertex-rich F64
graph, ResNet-50's remat spans). Every
phase that fails ends the run with a nonzero exit code. It needs one CUDA
card; without one (or without the package beside it) it exits nonzero
and prints no result.

Output: one line per phase; the card's name and power limit as nvidia-smi
gives them; a JSON line ``{"kernels": [...]}``; and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

    python3 chip_smoke.py --k7-split

times K7 alone, with its split by pass, at ResNet-50's three tail shapes,
for whatever K7 the package beside the script has (copy the script into a
checkout of another commit to measure that commit's K7 the same way), and

    python3 chip_smoke.py --tail-check

runs only [train_resnet]'s check of each fused tail's K4-K7 on the
inputs one BF16 step gives them (run it from a copy with a planted fault
to see the check fail), and

    python3 chip_smoke.py --conv-nets

runs only the three MultiLayerNetwork/ComputationGraph conv phases
([train_lenet], [train_vgg16], [train_resnet18]; one alone:
``python3 -c "import chip_smoke as c; c.phase_device();
c.phase_train_lenet()"``), and

    python3 chip_smoke.py --captured

runs only [train_captured] (the whole train step as one CUDA graph on
the char-RNN, gpt_mini, LeNet, ResNet-18 and the fused ResNet-50: captured
steps against eager ones, launches, step ms, busy share), [mfu] and
[capture_routes], and

    python3 chip_smoke.py --slice12

runs only the fault-tolerance, solver, gradient-check, transfer and
pretrain phases ([resilient]: the char-RNN through chaos_train's fault
schedule on fresh nets, resumed from disk only, bit-identical to an
uninterrupted run, a poisoned step rolled back, a SIGKILLed child
resumed by another, checkpoint and step costs; [resilient_resnet]:
ResNet-50 fused preempted and resumed on a fresh graph; [solvers] on
LeNet; [gradcheck] F64; [transfer] on VGG-16 frozen through its last
conv block; [pretrain] a VAE and an AE/RBM stack), each also alone
(--resilient, --resilient-resnet, --solvers, --gradcheck, --transfer,
--pretrain), and

    python3 chip_smoke.py --slice13

runs only the data-fed, observed training phases ([datapipe_resilient]:
the char-RNN fed by a datapipe (tokenize, window, shuffle over the
epoch, batch, prefetch) through fit_pipeline's crashes, SIGTERM and
relaunches, bit-identical to an uninterrupted run, batch for batch,
with its flight files, RunReports and Chrome trace; [datapipe_feed]:
the pipeline's rate, and fit(pipe) eager and captured beside the same
batches from memory, char-RNN and LeNet; [observability]: the tracer's
and the flight recorder's cost on the step), each also alone
(--datapipe-resilient, --datapipe-feed, --observability); the traces
land in profile_out/, and

    python3 chip_smoke.py --slice14

runs only slice 14's phases ([graph_tbptt]: DL4J's CompGraphLSTMExample
at full width, two GravesLSTM(512) with a skip connection merged into
the head, BF16, Adam(2e-3), tBPTT 50 over 3 batches of b = 32, T =
1000, with K1/K2's launches on the cluster route, the carries spied,
device ms a window and a T = 200 batch held against the plain CPU path;
[graph_stream]: the trained graph sampled one character at a time
through rnn_time_step, against one-shot output (BF16, and the carry
alone under F32); [graph_layers]: a small F64 graph with every vertex
type and each new layer type, card against CPU, and with the two exact
conv rewrites on against off; [remat]: ResNet-50 unfused at b = 256 with
DL4J_TPU_REMAT=s0b,s1b,s2b,s3b against without, bit-equal, step ms and
peak memory, and no span under the fusion pass), each also alone
(--graph-tbptt, --graph-stream, --graph-layers, --remat), and

    python3 chip_smoke.py --k6-split

times K6 alone at the same three shapes, on its sm90 path and on its
mma.sync path in the same run, each split into its GEMM launch and the
sum of its partials, and

    python3 chip_smoke.py --fwd-split

times K4 and K5 the same way, each path twice, in the order mma.sync,
sm90, sm90, mma.sync, and

    python3 chip_smoke.py --lstm-split

times K1 and K2 at the char-RNN's shape (T = 64, b = 32, n = 512, bf16)
on their grid route and their cluster route in turns (grid, cluster,
cluster, grid), each with its T sweep (cost per step, fixed cost), and
K2's cluster route split by launch (chain, dp sum, dWh), and

    python3 chip_smoke.py --lstm-parts

prints where a step of the two cluster kernels goes, in cycles per part
(a build with the kernels' step marks).

K1 and K2 (bf16 at n a multiple of 64 up to 512: thread-block clusters
with Wh resident, DSMEM exchange, wgmma), K3 (bf16) and K4-K7 (bf16,
where TMA can read their operands) run on Hopper kernels (TMA loads,
wgmma products); the phases hold each of those, and the first kernels
kept callable beside them, against the plain versions, and count the new
routes' launches under their own counters (lstm_fwd_sm90, lstm_bwd_sm90,
flash_attn_fwd_sm90, fused_block_stats_sm90, fused_block_apply_sm90,
fused_block_bwd_stats_sm90, fused_block_bwd_apply_sm90).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

SEED = 1234
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core and f32 FLOP/s,
# HBM3 bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# kernel vs plain version on the card. f32: both accumulate 512 products
# in f32 in different orders, compounded over up to 64 dependent steps.
# bf16: outputs are bf16 and h is rounded to bf16 every step, so one
# rounding flip is one ulp; 2 ulps at |y| <= 1 is 2 * 2**-7.
TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
# softmax probabilities of the bf16 model: served rows vs the plain CPU
# path, and streamed vs one-shot (the streamed carry is rounded to bf16
# between calls, the one-shot carry stays f32)
PROB_TOL = 1e-2
# K2 vs plain on the card. f32: as for K1, plus dWh sums T*b = 2048
# products per element in another order. bf16: K2 and the plain loop round
# dz once per step and every output once; an f32 sum in another order can
# land a rounding the other way, so 2 bf16 ulps at each output's largest
# magnitude (bf16_tol).
BWD_F32_TOL = 1e-4
# The train step on the card vs the plain CPU path, same weights and batch,
# BF16. Score: the loss is an f32 mean over 2048 rows of bf16 logits; a
# logit rounding that lands the other way moves its row by ~2**-8 * |z|,
# so 1e-3 relative. Gradients: bf16 roundings that land the other way
# (h, dz, the head's cotangent) at any of 64 dependent steps of 2 layers
# feed every later product, so 8 bf16 ulps at each gradient's largest
# magnitude (GRAD_ULPS).
TRAIN_SCORE_RTOL = 1e-3
GRAD_ULPS = 8
# tBPTT's first batch on the card vs the plain CPU path: chunks 2-4 start
# from parameters that the two paths updated with slightly different
# gradients (above), so the batch score agrees to 1e-2 relative.
TBPTT_SCORE_RTOL = 1e-2
# K3 vs its plain version (causal_mha_dot) on the card. f32: 1e-5 abs and
# rel, the JAX package's own flash forward tolerance (the same f32
# products and sums in another order). bf16: 2 bf16 ulps at the largest
# |v|, which bounds |out| (a convex combination of v's rows): K3 rounds
# p = exp(s - m) to bf16 against each tile's running max and rescales by
# alpha in f32, the plain version against the row's final max, so each
# weight may differ by 2**-8 relative (one ulp at max|v| in out), plus
# each side's final rounding (half an ulp each).
FLASH_F32_TOL = 1e-5
FLASH_BF16_ULPS = 2
# FlashAttentionFn's gradients (recompute through causal_mha_dot) vs
# autograd of causal_mha_exact, f32: the JAX package's own tolerance.
FLASH_GRAD_TOL = 2e-4
# gpt_mini's first train step on the card vs the plain CPU path, BF16:
# the card rounds p to bf16 in K3 and its backward's recompute, the CPU
# path keeps p in f32 (causal_mha_exact), and cuBLAS and the CPU round
# every bf16 GEMM output on their own; a rounding that lands the other
# way at any of ~10 places per block feeds every later product. Score
# 1e-3 relative and gradients 8 bf16 ulps at each gradient's max, as for
# the char-RNN. bk's true gradient is 0 (the softmax removes a key bias),
# so both sides give noise there: held to 2**-8 of the largest Wk
# gradient instead (1e-5 under F32). 16 ulps, not the char-RNN's 8: the
# forward's bf16 streams already differ by up to 3 ulps (GPT_PROB_TOL).
GPT_GRAD_ULPS = 16
# gpt_mini's softmax probabilities under BF16, card vs the plain CPU path
# (and a row served in a batch vs alone): the residual stream grows to
# |x| ~ 7 over 4 blocks, where a bf16 ulp is 2**-5, and a few ulps of
# difference there ([serve_gpt] prints stream_abs_max and
# stream_card_vs_cpu) move a logit by up to ~0.1 and a probability by at
# most p(1-p) * 0.1 <= 0.025. The two plain CPU formulations of attention
# (exact, and p rounded as K3 rounds it) differ by as much on the same
# rows ([serve_gpt] cpu_dot_vs_exact). The path itself is held under F32
# instead: GPT_F32_TOL on the same weights.
GPT_PROB_TOL = 3e-2
GPT_F32_TOL = 1e-5
# gpt_mini's first train step under F32, card vs the plain CPU path: the
# same f32 arithmetic in another order; 1e-4 of each gradient's max.
GPT_F32_GRAD_TOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def phase(name, **fields):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_per_launch(fn, reps, inner=20):
    """Median over ``reps`` samples of the milliseconds per call of
    ``inner`` back-to-back calls of ``fn()`` between two CUDA events, after
    a warm-up: for a kernel of tens of microseconds, so that the host's
    time to issue one call hides behind the previous call's device time
    and is not counted as the kernel's."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_ms_per_call(fn, calls=200):
    """Milliseconds the host takes to issue one call of ``fn()``: ``calls``
    calls with no wait on the card between them, on the host's clock, after
    a warm-up call. Where it is at or above cuda_ms_per_launch's time, that
    time is the host's rate of issue, not the card's."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issued * 1e3 / calls


# the tracer's span names: while a torch.profiler profile records, each
# span is a record_function annotation, listed among the CUDA entries as
# a GPU user annotation (the span's interval on the card, not work)
SPAN_NAMES = frozenset((
    "data_wait", "host_dispatch", "device_step", "score_sync",
    "flops_derive", "checkpoint_snapshot", "checkpoint_write",
    "checkpoint_barrier", "rollback", "restore", "run_start",
    "pipe_shuffle_fill", "pipe_collate", "pipe_prefetch_pull"))


def device_kernels(events):
    """The CUDA entries of a profile's ``key_averages()`` that are device
    work (kernels, copies, memsets), the tracer's annotations left out."""
    return [e for e in events if e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)
            and e.key not in SPAN_NAMES]


def device_events(fn, reps):
    """torch.profiler's per-kernel averages (CUDA only) over ``reps``
    calls of ``fn()``, after a warm-up call. A profile that saw no device
    time at all (the profiler now and then comes back empty) is taken
    again, up to three times in all; then the run fails rather than
    report a time of zero."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = device_kernels(prof.key_averages())
        if sum(e.self_device_time_total for e in events) > 0:
            return events
    raise SmokeFailure("the profiler saw no device time in three profiles")


def device_ms_per_call(fn, reps=20):
    """The device time of one call of ``fn()``, which launches each of its
    kernels once, from torch.profiler over ``reps`` calls: each kernel's
    mean self time over the launches the profiler kept, summed over the
    kernels; and the fewest launches of one kernel that it kept. Late in
    a long process it has kept as few as a tenth, so a sum over ``reps``
    would read short. Unlike cuda_ms_per_launch it does not count the
    gaps where the card waits for the host to issue the next call."""
    events = device_events(fn, reps)
    return (sum(e.self_device_time_total / e.count for e in events) / 1e3,
            min(e.count for e in events))


def lstm_inputs(T, b, n, dtype, masked=False, nonzero_carry=False):
    """Seeded numpy draws at the model's scale, as CUDA tensors."""
    import torch
    rng = np.random.default_rng(SEED + T * 1000 + b)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa: E731
        "cuda", dtype)
    xz = f(rng.normal(0.0, 1.0, (T, b, 4 * n)))
    Wh = f(rng.normal(0.0, np.sqrt(2.0 / (2 * n)), (n, 4 * n)))
    p = f(rng.normal(0.0, 0.1, (3, n)))
    scale = 0.5 if nonzero_carry else 0.0
    h0 = f(scale * rng.normal(0.0, 1.0, (b, n)))
    c0 = f(scale * rng.normal(0.0, 1.0, (b, n)))
    mask = None
    if masked:
        m = (rng.random((T, b)) > 0.3).astype(np.float32)
        m[:, 0] = 1.0
        m[T // 2:, -1] = 0.0
        mask = f(m)
    return xz, h0, c0, Wh, p, mask


def phase_device():
    import torch
    from deeplearning4j_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  nvcc {name}: {line.strip()}", flush=True)
    phase("device", kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, built=sorted(built),
          build_s=f"{build_s:.2f}")
    # K3's bf16 route and K4-K7's bf16 paths run on wgmma fed by TMA: the
    # compiler must have emitted both into the libraries this run loads,
    # and into K4's and K5's instantiations of the mainloop, with K5's TMA
    # stores of y; K1's and K2's cluster kernels run their products on
    # wgmma, and K2's dWh on the mainloop
    for lib, fn, ops in (
            ("lstm_fwd", "lstm_fwd_cluster_kernel", ("HGMMA",)),
            ("lstm_bwd", "lstm_bwd_cluster_kernel", ("HGMMA",)),
            ("lstm_bwd", "DwhEpi", ("HGMMA", "UTMALDG")),
            ("flash_attn_fwd", "", ("HGMMA", "UTMALDG")),
            ("fused_block", "", ("HGMMA", "UTMALDG", "UTMASTG")),
            ("fused_block", "FwdStatsEpi", ("HGMMA", "UTMALDG")),
            ("fused_block", "ApplyEpi", ("HGMMA", "UTMALDG", "UTMASTG"))):
        sass = _build.sass_counts(lib, ops, fn)
        phase("sass", library=lib, function=fn or "all", **sass)
        check(all(sass.values()), f"{lib} {fn}: its SASS holds {sass}: no "
              f"wgmma (HGMMA), no TMA load (UTMALDG) or no TMA store "
              f"(UTMASTG)")
    return card


# K1's cases: (T, b, n, masked, nonzero carry, residuals). b = 33 and 70
# leave the last 32-row cluster ragged; T = 1 is the streaming step.
# (50, 32) is a [graph_tbptt] window after the first, (1, 4) a
# [graph_stream] call.
FWD_CASES = [(64, 32, 512, False, False, True),
             (50, 32, 512, False, True, True),
             (1, 4, 512, False, True, False),
             (64, 32, 512, False, False, False),
             (64, 2, 512, False, True, False),
             (1, 1, 512, False, True, False),
             (7, 3, 512, True, False, True),
             (7, 3, 512, True, True, False),
             (64, 33, 512, False, True, True),
             (64, 70, 512, True, False, True),
             (1, 70, 512, False, True, True)]


def fwd_errors(got, want, tol, what):
    """{field: max abs error} of K1's outputs against the plain version's;
    fails unless every element is within tol + tol * |want| and finite."""
    import torch
    errs = {}
    for field in got._fields:
        g, w = getattr(got, field), getattr(want, field)
        if g is None and w is None:
            continue
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{field}: kernel {g.dtype}{tuple(g.shape)} vs plain "
              f"{w.dtype}{tuple(w.shape)}")
        d = (g.float() - w.float()).abs()
        errs[field] = d.max().item()
        check(torch.isfinite(g.float()).all().item(),
              f"{field} not finite ({what})")
        over = (d / (tol + tol * w.float().abs())).max().item()
        check(over <= 1.0,
              f"lstm_fwd {field} disagrees with the plain version ({what}): "
              f"max abs err {errs[field]:.3e} > {tol} + {tol}*|want|, the "
              f"worst element {over:.1f}x its limit")
    return errs


def short(errs):
    return json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})


def phase_kernel_vs_plain():
    """K1 against its plain version: f32 on the grid route, bf16 on the
    cluster route through the wrapper and on the grid kernel's bf16
    instantiation called directly (not counted), at unchanged limits."""
    import torch
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    from deeplearning4j_tpu_torch.ops import registry
    main_err = None
    n_calls = n_cluster = 0
    registry.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = TOL[dname]
        for T, b, n, masked, carry, save in FWD_CASES:
            args = lstm_inputs(T, b, n, dtype, masked, carry)
            what = (f"T={T} b={b} n={n} {dname} masked={masked} "
                    f"save={save}")
            cluster = lstm_ops.takes_cluster(dtype, n)
            with torch.inference_mode():
                got = lstm_ops.lstm_sequence_cuda(*args, save_residuals=save)
                torch.cuda.synchronize()
                n_calls += 1
                n_cluster += cluster
                want = lstm_ops.lstm_sequence_torch(*args,
                                                    save_residuals=save)
            errs = fwd_errors(got, want, tol, what)
            fields = {}
            if cluster:
                mask = args[5]
                if mask is None:
                    mask = torch.ones((T, b), dtype=dtype, device="cuda")
                with torch.inference_mode():
                    grid = lstm_ops.lstm_fwd_launch(False, *args[:5], mask,
                                                    save)
                    torch.cuda.synchronize()
                fields["grid_max_abs_err"] = short(
                    fwd_errors(grid, want, tol, what + " grid route"))
            if (T, b, dname, save) == (64, 32, "bfloat16", False):
                main_err = errs["y"]
            phase("kernel_vs_plain", kernel="lstm_fwd", dtype=dname, T=T,
                  b=b, n=n, masked=masked, carry=carry, residuals=save,
                  route="cluster" if cluster else "grid", tol=tol,
                  max_abs_err=short(errs), **fields)
    launched = registry.launches()
    check(launched.get("lstm_fwd", 0) == n_calls,
          f"launch counter read {launched} after {n_calls} kernel calls")
    check(launched.get(lstm_ops.FWD_SM90, 0) == n_cluster,
          f"lstm_fwd_sm90 read {launched} after {n_cluster} calls on the "
          f"cluster route")
    return main_err


def bf16_tol(want):
    """Two bf16 ulps at the largest magnitude of ``want``."""
    top = float(want.abs().max())
    return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def ulps_off(got, want):
    """max|got - want| in bf16 ulps at the largest magnitude of ``want``."""
    top = float(want.abs().max())
    if top == 0:
        return 0.0 if float(got.abs().max()) == 0 else math.inf
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    return float((got.float() - want.float()).abs().max()) / ulp


def bwd_inputs(T, b, n, dtype, masked=False, nonzero_carry=False):
    """K2's arguments: K1's residuals on seeded draws, and seeded
    cotangents; plus the forward's arguments."""
    import torch
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    xz, h0, c0, Wh, p, mask = lstm_inputs(T, b, n, dtype, masked,
                                          nonzero_carry)
    if mask is None:
        mask = torch.ones((T, b), dtype=dtype, device="cuda")
    with torch.inference_mode():
        res = lstm_ops.lstm_sequence_cuda(xz, h0, c0, Wh, p, mask,
                                          save_residuals=True)
    rng = np.random.default_rng(SEED + 7 + T * 1000 + b)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa: E731
        "cuda", dtype)
    dy = f(rng.normal(0.0, 1.0, (T, b, n)))
    dhT = f(rng.normal(0.0, 1.0, (b, n)))
    dcT = f(rng.normal(0.0, 1.0, (b, n)))
    return (((res.G, res.h_prev, res.c_prev), mask, Wh, p, dy, dhT, dcT),
            (xz, h0, c0, Wh, p, mask))


def weighted_loss(y, hT, cT):
    import torch
    w = torch.cos(torch.arange(y.numel(), device=y.device,
                               dtype=torch.float32)).reshape(y.shape)
    return ((y.float() * w).sum() + 2.0 * torch.sin(hT.float()).sum()
            + 0.5 * (cT.float() ** 2).sum())


def fn_vs_autograd(fwd_args):
    """Gradients through LstmSequenceFn (K1 with residuals, then K2) vs
    torch.autograd through the plain loop, f32, on the card. Returns the
    largest error relative to each gradient's largest element."""
    import torch
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    *tensors, mask = fwd_args
    worst = 0.0
    leaves_k = [t.detach().clone().requires_grad_() for t in tensors]
    out_k = lstm_ops.lstm_sequence(*leaves_k, mask)
    check(type(out_k.y.grad_fn).__name__ == "LstmSequenceFnBackward",
          "lstm_sequence did not route through LstmSequenceFn")
    got = torch.autograd.grad(weighted_loss(*out_k[:3]), leaves_k)
    leaves_p = [t.detach().clone().requires_grad_() for t in tensors]
    out_p = lstm_ops.lstm_sequence_torch(*leaves_p, mask)
    want = torch.autograd.grad(weighted_loss(*out_p[:3]), leaves_p)
    for name, g, w in zip(("dxz", "dh0", "dc0", "dWh", "dp"), got, want):
        top = float(w.abs().max())
        err = float((g - w).abs().max()) / top if top else 0.0
        check(err <= BWD_F32_TOL,
              f"LstmSequenceFn {name} vs autograd of the plain loop: "
              f"{err:.3e} of max > {BWD_F32_TOL}")
        worst = max(worst, err)
    return worst


# K2's cases: (T, b, n, masked, nonzero carry); (50, 32) is a
# [graph_tbptt] window after the first
BWD_CASES = [(64, 32, 512, False, False), (64, 2, 512, False, True),
             (50, 32, 512, False, True),
             (7, 3, 512, True, False), (1, 1, 512, False, True),
             (64, 33, 512, False, True), (64, 70, 512, True, False),
             (1, 70, 512, True, True)]


def bwd_errors(got, again, want, dtype, what):
    """({name: max abs error}, {name: tolerance}) of K2's outputs against
    the plain version's; fails unless two calls gave the same bits and
    every element is within tol + tol * |want| and finite."""
    import torch
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"lstm_bwd: two identical calls gave different bits ({what})")
    errs, tols = {}, {}
    for name, g, w in zip(("dxz", "dh0", "dc0", "dWh", "dp"), got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name}: kernel {g.dtype}{tuple(g.shape)} vs plain "
              f"{w.dtype}{tuple(w.shape)}")
        check(torch.isfinite(g.float()).all().item(),
              f"lstm_bwd {name} not finite ({what})")
        tol = (BWD_F32_TOL if dtype == torch.float32
               else bf16_tol(w.float()))
        d = (g.float() - w.float()).abs()
        errs[name], tols[name] = d.max().item(), tol
        over = (d / (tol + tol * w.float().abs())).max().item()
        check(over <= 1.0,
              f"lstm_bwd {name} disagrees with the plain version ({what}): "
              f"max abs err {errs[name]:.3e} > {tol:.3e} + {tol:.3e}*|want|, "
              f"the worst element {over:.1f}x its limit")
    return errs, tols


def phase_bwd_vs_plain():
    """K2 against its plain version, as phase_kernel_vs_plain holds K1:
    the bf16 cases on the cluster route and on the grid kernel called
    directly, f32 on the grid route; every call twice, bit-equal."""
    import torch
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    from deeplearning4j_tpu_torch.ops import registry
    main_err = None
    want_launches = n_cluster = 0
    base = registry.launches()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for T, b, n, masked, carry in BWD_CASES:
            args, fwd_args = bwd_inputs(T, b, n, dtype, masked, carry)
            what = f"T={T} b={b} n={n} {dname} masked={masked}"
            cluster = lstm_ops.takes_cluster(dtype, n)
            with torch.inference_mode():
                got = lstm_ops.lstm_sequence_bwd_cuda(*args)
                again = lstm_ops.lstm_sequence_bwd_cuda(*args)
                torch.cuda.synchronize()
                want_launches += 2 * lstm_ops.bwd_launches_per_call(dtype, n)
                n_cluster += 2 * cluster
                want = lstm_ops.lstm_sequence_bwd_torch(*args)
            errs, tols = bwd_errors(got, again, want, dtype, what)
            fields = {}
            if cluster:
                with torch.inference_mode():
                    grid = lstm_ops.lstm_bwd_launch(False, *args)
                    grid2 = lstm_ops.lstm_bwd_launch(False, *args)
                    torch.cuda.synchronize()
                fields["grid_max_abs_err"] = short(bwd_errors(
                    grid, grid2, want, dtype, what + " grid route")[0])
            if dtype == torch.float32:
                fields["fn_vs_autograd_rel_err"] = (
                    f"{fn_vs_autograd(fwd_args):.3e}")
                want_launches += lstm_ops.bwd_launches_per_call(dtype, n)
            if (T, b, dname) == (64, 32, "bfloat16"):
                main_err = max(errs.values())
            phase("kernel_vs_plain", kernel="lstm_bwd", dtype=dname, T=T,
                  b=b, n=n, masked=masked, carry=carry,
                  route="cluster" if cluster else "grid", deterministic=True,
                  max_abs_err=short(errs), tol=short(tols), **fields)
    now = registry.launches()
    launched = now.get("lstm_bwd", 0) - base.get("lstm_bwd", 0)
    check(launched == want_launches, f"lstm_bwd launch counter read "
          f"{launched}, expected {want_launches}")
    sm90 = (now.get(lstm_ops.BWD_SM90, 0)
            - base.get(lstm_ops.BWD_SM90, 0))
    check(sm90 == n_cluster, f"lstm_bwd_sm90 read {sm90} after "
          f"{n_cluster} calls on the cluster route")
    return main_err


def post_json(url, obj, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def get_json(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def phase_serve():
    import torch
    from deeplearning4j_tpu_torch import MultiLayerNetwork, zoo
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.serving import ModelServer

    net = zoo.char_rnn(seed=SEED)      # vocab 80, hidden 512, 2 layers, BF16
    T, V = 64, 80
    clients, per_client = 16, 4
    rng = np.random.default_rng(SEED)
    requests = [[np.eye(V, dtype=np.float32)[rng.integers(0, V, (k, T))]
                 for k in rng.integers(1, 5, per_client)]
                for _ in range(clients)]
    replies = [[None] * per_client for _ in range(clients)]
    errors = []

    registry.reset_launches()
    srv = ModelServer(net, port=0, max_batch=32,
                      input_shapes=[(T, V)]).start()
    try:
        status, health = get_json(srv.url + "/healthz")
        check(status == 200 and health["status"] == "ok",
              f"/healthz answered {status} {health}")

        def client(c):
            try:
                for j, x in enumerate(requests[c]):
                    status, body = post_json(srv.url + "/predict",
                                             {"features": x.tolist()})
                    check(status == 200, f"/predict answered {status}")
                    replies[c][j] = np.asarray(body["predictions"],
                                               np.float32)
            except Exception as e:  # noqa: BLE001 — reported by the main thread
                errors.append(f"client {c}: {type(e).__name__}: {e}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a client hung")
        check(not errors, "; ".join(errors))
        torch.cuda.synchronize()
        counts = registry.launches()
        launches = counts.get("lstm_fwd", 0)
        status, metrics = get_json(srv.url + "/metrics")
        check(status == 200, f"/metrics answered {status}")
    finally:
        srv.stop()
    check(launches > 0, "the served path launched lstm_fwd no time")
    # bf16 at n = 512: every served forward on the cluster route
    check(counts.get("lstm_fwd_sm90", 0) == launches,
          f"served forwards off the cluster route: {counts}")

    rows = sum(x.shape[0] for reqs in requests for x in reqs)
    bit_equal, max_err = True, 0.0
    for c in range(clients):
        for x, y in zip(requests[c], replies[c]):
            check(y.shape == (x.shape[0], T, V),
                  f"reply shape {y.shape} for {x.shape}")
            check(np.isfinite(y).all(), "non-finite reply")
            check(np.allclose(y.sum(-1), 1.0, atol=1e-3),
                  "reply rows are not distributions")
            for i in range(x.shape[0]):
                alone = net.output(x[i:i + 1]).float().cpu().numpy()[0]
                bit_equal &= bool(np.array_equal(alone, y[i]))
                max_err = max(max_err, float(np.abs(alone - y[i]).max()))
    check(max_err <= PROB_TOL,
          f"a coalesced row differs from the same row served alone by "
          f"{max_err:.3e} > {PROB_TOL}")

    # the same weights through the plain CPU path
    cpu = MultiLayerNetwork(net.conf, device="cpu").init()
    cpu.params = {k: {n: t.cpu() for n, t in v.items()}
                  for k, v in net.params.items()}
    x = requests[0][0][:2]
    cpu_err = float(np.abs(cpu.output(x).numpy()
                           - net.output(x).float().cpu().numpy()).max())
    check(cpu_err <= PROB_TOL,
          f"card vs plain CPU path: max abs err {cpu_err:.3e} > {PROB_TOL}")
    phase("serve", model="char_rnn(vocab=80,hidden=512,layers=2,BF16)",
          requests=clients * per_client, rows=rows,
          rows_per_s=f"{rows / wall:.1f}",
          p50_ms=metrics["latency_ms"]["p50"],
          p99_ms=metrics["latency_ms"]["p99"],
          batches=metrics["batches_total"],
          batch_hist=json.dumps(metrics["batch_size_hist"]),
          device_ms_by_bucket=json.dumps(metrics["device_ms_by_bucket"]),
          warmup_s=f"{srv.warmup_s:.2f}", lstm_fwd_launches=launches,
          lstm_fwd_sm90=counts.get("lstm_fwd_sm90", 0),
          rows_bit_equal_alone=bit_equal,
          max_abs_err_vs_alone=f"{max_err:.3e}",
          max_abs_err_vs_cpu_plain=f"{cpu_err:.3e}", tol=PROB_TOL)
    return net, {k: counts.get(k, 0) for k in ("lstm_fwd", "lstm_fwd_sm90")}


def phase_stream(net):
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    rng = np.random.default_rng(SEED + 1)
    T, V = 64, 80
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (2, T))]
    one_shot = net.output(x).float().cpu().numpy()
    registry.reset_launches()
    net.rnn_clear_previous_state()
    steps = [net.rnn_time_step(x[:, t, :]).float().cpu().numpy()
             for t in range(T)]
    torch.cuda.synchronize()
    counts = registry.launches()
    launches = counts.get("lstm_fwd", 0)
    streamed = np.stack(steps, axis=1)
    err = float(np.abs(streamed - one_shot).max())
    check(streamed.shape == one_shot.shape, "stream shape")
    check(launches == 2 * T, f"stream launched lstm_fwd {launches} times, "
          f"expected {2 * T}")
    check(counts.get("lstm_fwd_sm90", 0) == 2 * T,
          f"streamed steps off the cluster route: {counts}")
    check(err <= PROB_TOL,
          f"rnn_time_step vs one-shot output: {err:.3e} > {PROB_TOL}")
    phase("stream", steps=T, lstm_fwd_launches=launches,
          lstm_fwd_sm90=counts.get("lstm_fwd_sm90", 0),
          max_abs_err_vs_one_shot=f"{err:.3e}", tol=PROB_TOL)


def markov_batches(n_batches, b, T, V, seed):
    """One-hot (features, labels) batches of an order-2 Markov chain over
    V symbols: the pair (a, b) is followed by one of 3 successors, with
    probabilities 0.6, 0.3, 0.1, drawn from a table indexed by b and the
    parity of a. The last symbol alone narrows the next to 6 of V, so a
    few steps have something to learn, and the pair to 3."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, V, (V, 2, 3))
    succ = table[:, np.arange(V) % 2].transpose(1, 0, 2)  # [a, b, 3]
    eye = np.eye(V, dtype=np.float32)
    out = []
    for _ in range(n_batches):
        seq = np.empty((b, T + 1), np.int64)
        seq[:, :2] = rng.integers(0, V, (b, 2))
        for t in range(2, T + 1):
            pick = rng.choice(3, size=b, p=[0.6, 0.3, 0.1])
            seq[:, t] = succ[seq[:, t - 2], seq[:, t - 1], pick]
        out.append((eye[seq[:, :-1]], eye[seq[:, 1:]]))
    return out


def loss_and_grads(net, x, y):
    """The training loss and its gradient for every parameter, by autograd
    of the net's loss (the LSTM backward is K2 on the card, the plain loop
    on the CPU)."""
    import torch
    leaves = {ln: {k: t.detach().requires_grad_() for k, t in lp.items()}
              for ln, lp in net.params.items()}
    loss, _ = net._loss(leaves, net.state, net._as_tensor(x),
                        net._as_tensor(y))
    keys = [(ln, k) for ln in leaves for k in leaves[ln]]
    grads = torch.autograd.grad(loss, [leaves[ln][k] for ln, k in keys])
    return float(loss.detach()), dict(zip(keys, grads))


def cpu_copy(net):
    """The same configuration and weights on the CPU (plain versions)."""
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    cpu = MultiLayerNetwork(net.conf, device="cpu").init()
    cpu.params = {ln: {k: t.detach().cpu().clone() for k, t in lp.items()}
                  for ln, lp in net.params.items()}
    return cpu


def on_card(batches):
    import torch
    from deeplearning4j_tpu_torch import DataSet
    return [DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
            for x, y in batches]


def lstm_launches_per_bwd():
    """K2's device launches a call of the char-RNN (bf16, n = 512)."""
    import torch
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    return lstm_ops.bwd_launches_per_call(torch.bfloat16, 512)


def phase_train():
    """30 fit_batch steps of the full-width char-RNN (BF16, Adam 2e-3) at
    b = 32, T = 64; the first step held against the plain CPU path."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.ops import registry
    steps, b, T, V = 30, 32, 64, 80
    net = zoo.char_rnn(seed=SEED)
    pol = net.conf.global_conf.dtype
    check(pol.compute_dtype == "bfloat16" and pol.param_dtype == "float32",
          f"char_rnn policy {pol}")
    check(net.layers[0].resolve("updater").kind == "adam",
          "char_rnn does not train with Adam")
    cpu = cpu_copy(net)
    batches = markov_batches(steps, b, T, V, SEED + 3)

    # the first step's score and gradients vs the plain CPU path
    x0, y0 = batches[0]
    card_loss, card_g = loss_and_grads(net, x0, y0)
    t0 = time.perf_counter()
    cpu_loss, cpu_g = loss_and_grads(cpu, x0, y0)
    cpu_s = time.perf_counter() - t0
    score_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_ulps = {f"{ln}.{k}": ulps_off(card_g[(ln, k)].cpu(), g)
                 for (ln, k), g in cpu_g.items()}
    print(f"  first step vs plain CPU: score {card_loss:.6f} vs "
          f"{cpu_loss:.6f}; gradient error in bf16 ulps at max: "
          + json.dumps({k: round(v, 2) for k, v in grad_ulps.items()}),
          flush=True)
    check(score_err <= TRAIN_SCORE_RTOL,
          f"train score card vs CPU: {score_err:.3e} > {TRAIN_SCORE_RTOL}")
    for name, u in grad_ulps.items():
        check(u <= GRAD_ULPS, f"gradient {name} card vs CPU: {u:.2f} bf16 "
              f"ulps at max > {GRAD_ULPS}")

    data = on_card(batches)
    torch.cuda.synchronize()
    registry.reset_launches()
    scores, events = [], []
    t0 = time.perf_counter()
    for ds in data:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        scores.append(net.fit_batch(ds))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = registry.launches()
    step_ms = [s.elapsed_time(e) for s, e in events]
    scores = [float(s) for s in scores]
    check(all(math.isfinite(s) for s in scores), f"scores {scores}")
    check(abs(scores[0] - card_loss) <= 1e-6 * abs(card_loss),
          f"fit_batch score {scores[0]} != its loss {card_loss}")
    last5 = statistics.mean(scores[-5:])
    check(last5 < scores[0], f"training did not lower the score: first "
          f"{scores[0]:.4f}, mean of last 5 {last5:.4f}")
    # two layers a step, every call on the cluster route (bf16, n = 512);
    # K2 makes three device launches a call there
    per_bwd = lstm_launches_per_bwd()
    for k, want in (("lstm_fwd", 2 * steps), ("lstm_fwd_sm90", 2 * steps),
                    ("lstm_bwd", 2 * per_bwd * steps),
                    ("lstm_bwd_sm90", 2 * steps)):
        check(launches.get(k, 0) == want,
              f"{k} launched {launches.get(k, 0)} times in {steps} train "
              f"steps, expected {want}")
    med = statistics.median(step_ms[-20:])
    # where a step's time goes: K1 and K2 (lstm), the dWh GEMM (gemm), the
    # rest, and how busy the card is over the steps' wall time
    prof = profile_steps(net, data[-3:])
    phase("train", model="char_rnn(vocab=80,hidden=512,layers=2,BF16,"
          "Adam(2e-3))", steps=steps, b=b, T=T,
          first_score=f"{scores[0]:.4f}", last5_mean=f"{last5:.4f}",
          scores=json.dumps([round(s, 4) for s in scores]),
          step_ms_median_last20=f"{med:.4f}",
          step_ms_min=f"{min(step_ms[-20:]):.4f}",
          step_ms_max=f"{max(step_ms[-20:]):.4f}", wall_s=f"{wall:.3f}",
          launches=json.dumps(launches),
          score_vs_cpu_rel=f"{score_err:.3e}",
          grad_vs_cpu_max_ulps=f"{max(grad_ulps.values()):.2f}",
          cpu_first_step_s=f"{cpu_s:.2f}",
          **{k: v for k, v in prof.items() if "flash" not in k})
    return {"launches": launches, "step_ms": med}


@contextlib.contextmanager
def carry_spy(record):
    """Record sum|h0| of every forward-kernel call made through the
    registry (K1 on the card) while the block runs."""
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    from deeplearning4j_tpu_torch.ops import registry
    real = lstm_ops.lstm_sequence_cuda

    def spy(xz_t, h0, c0, *args, **kw):
        record.append(float(h0.float().abs().sum()))
        return real(xz_t, h0, c0, *args, **kw)

    registry.register("lstm_sequence", "cuda")(spy)
    try:
        yield
    finally:
        registry.register("lstm_sequence", "cuda")(real)


def phase_tbptt():
    """The same model with tBPTT at 64 over T = 256 (4 chunks), 3
    batches; the first batch's score held against the plain CPU path."""
    import dataclasses
    import torch
    from deeplearning4j_tpu_torch import DataSet, MultiLayerNetwork, zoo
    from deeplearning4j_tpu_torch.ops import registry
    L, T, b, n_batches = 64, 256, 32, 3
    chunks = T // L
    conf = dataclasses.replace(zoo.char_rnn(seed=SEED + 5).conf,
                               backprop_type="tbptt", tbptt_fwd_length=L,
                               tbptt_bwd_length=L)
    net = MultiLayerNetwork(conf).init()
    cpu = cpu_copy(net)
    batches = markov_batches(n_batches, b, T, 80, SEED + 4)
    data = on_card(batches)
    torch.cuda.synchronize()
    h0_sums = []
    registry.reset_launches()
    with carry_spy(h0_sums):
        scores = [net.fit_batch(ds) for ds in data]
        torch.cuda.synchronize()
    launches = registry.launches()
    scores = [float(s) for s in scores]
    check(all(math.isfinite(s) for s in scores), f"tbptt scores {scores}")
    for k, per_call in (("lstm_fwd", 1), ("lstm_fwd_sm90", 1),
                        ("lstm_bwd", lstm_launches_per_bwd()),
                        ("lstm_bwd_sm90", 1)):
        want = 2 * chunks * n_batches * per_call
        check(launches.get(k, 0) == want,
              f"{k} launched {launches.get(k, 0)} times in tBPTT, "
              f"expected {want}")
    per_batch = 2 * chunks
    check(len(h0_sums) == per_batch * n_batches,
          f"{len(h0_sums)} forward-kernel calls seen")
    for i in range(n_batches):
        got = h0_sums[i * per_batch:(i + 1) * per_batch]
        check(got[0] == 0.0 and got[1] == 0.0,
              f"batch {i}: the first chunk did not start from a zero carry")
        check(all(v > 0.0 for v in got[2:]),
              f"batch {i}: chunks 2-{chunks} did not get a nonzero carry")
    check(net.state == {}, f"carries left in the state: {list(net.state)}")
    x, y = batches[0]
    t0 = time.perf_counter()
    cpu_score = float(cpu.fit_batch(DataSet(x, y)))
    cpu_s = time.perf_counter() - t0
    err = abs(scores[0] - cpu_score) / abs(cpu_score)
    check(err <= TBPTT_SCORE_RTOL,
          f"tBPTT first batch card vs CPU: {err:.3e} > {TBPTT_SCORE_RTOL}")
    phase("tbptt", model="char_rnn(vocab=80,hidden=512,layers=2,BF16)",
          tbptt=L, T=T, b=b, batches=n_batches, chunks=chunks,
          scores=json.dumps([round(s, 4) for s in scores]),
          cpu_first_score=f"{cpu_score:.4f}", score_vs_cpu_rel=f"{err:.3e}",
          carry_h0_abs_sum=json.dumps([round(v, 1)
                                       for v in h0_sums[:per_batch]]),
          launches=json.dumps(launches), cpu_first_batch_s=f"{cpu_s:.2f}")
    return launches


def flash_inputs(b, T, h, dh, dtype, seed=0):
    """Seeded q, k, v [b, T, h, dh] as CUDA tensors."""
    import torch
    rng = np.random.default_rng(SEED + 11 + seed + 7 * T + b)
    return [torch.from_numpy(rng.normal(0.0, 1.0, (b, T, h, dh))
                             .astype(np.float32)).to("cuda", dtype)
            for _ in range(3)]


def flash_grads_vs_exact(q, k, v):
    """Gradients through FlashAttentionFn (K3 forward, recompute backward)
    vs autograd of causal_mha_exact, f32, on the card. Returns the
    largest error over FLASH_GRAD_TOL * (1 + |want|)."""
    import torch
    from deeplearning4j_tpu_torch.ops import attention as att
    leaves_k = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out_k = att.causal_mha(*leaves_k)
    check(type(out_k.grad_fn).__name__ == "FlashAttentionFnBackward",
          "causal_mha on the card did not route through FlashAttentionFn")
    w = torch.cos(torch.arange(out_k.numel(), device=q.device,
                               dtype=torch.float32)).reshape(out_k.shape)
    got = torch.autograd.grad((out_k * w).sum(), leaves_k)
    leaves_p = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out_p = att.causal_mha_exact(*leaves_p)
    want = torch.autograd.grad((out_p * w).sum(), leaves_p)
    worst = 0.0
    for name, g, wt in zip(("dq", "dk", "dv"), got, want):
        ratio = float(((g - wt).abs()
                       / (FLASH_GRAD_TOL * (1.0 + wt.abs()))).max())
        check(ratio <= 1.0, f"FlashAttentionFn {name} vs autograd of "
              f"causal_mha_exact: {ratio:.3f} of the tolerance")
        worst = max(worst, ratio)
    return worst


def flash_fma(q, k, v):
    """K3's first kernel (f32 FMA, dl4j_flash_attn_fwd) on bf16 inputs,
    called through the library directly: the port's wrapper takes the
    sm90 kernel for bf16, and this keeps the FMA kernel's bf16
    instantiation held and timed beside it. Not a launch of the port's
    path, so not counted."""
    import torch
    from deeplearning4j_tpu_torch.ops import attention as att
    lib = att._bind()
    b, T, h, dh = q.shape
    out = torch.empty_like(q)
    rc = lib.dl4j_flash_attn_fwd(1, q.data_ptr(), k.data_ptr(),
                                 v.data_ptr(), out.data_ptr(), b, T, h, dh,
                                 torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"the FMA flash kernel failed: cudaError {rc}")
    return out


def phase_flash_vs_plain():
    """K3 against causal_mha_dot at the served/trained shape, the JAX
    test's shape, ragged T and b = 1, in f32 and bf16, on both kernels:
    bf16 through the port's wrapper (the sm90 route) and through the FMA
    kernel's bf16 instantiation, f32 through the wrapper (the FMA route);
    determinism and batch invariance bit for bit on each; FlashAttentionFn's
    gradients; the launch counters. Returns the sm90 route's max abs error
    at the main shape."""
    import torch
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops import registry
    cases = [(32, 256, 4, 64), (2, 128, 2, 128), (4, 200, 4, 64),
             (2, 200, 2, 128), (4, 1, 4, 64), (1, 256, 4, 64)]
    main_err = None
    n_calls = n_sm90 = 0
    registry.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for b, T, h, dh in cases:
            q, k, v = flash_inputs(b, T, h, dh, dtype)
            with torch.inference_mode():
                want = att.flash_attn_fwd_torch(q, k, v)
            routes = {att.flash_route(dtype): att.flash_attn_fwd_cuda}
            if dtype == torch.bfloat16:
                routes["fma"] = flash_fma
            for route, fn in routes.items():
                counted = fn is att.flash_attn_fwd_cuda
                with torch.inference_mode():
                    got = fn(q, k, v)
                    again = fn(q, k, v)
                    rows = sorted({0, b // 2, b - 1})
                    alone = [fn(q[i:i + 1].contiguous(),
                                k[i:i + 1].contiguous(),
                                v[i:i + 1].contiguous()) for i in rows]
                    torch.cuda.synchronize()
                if counted:
                    n_calls += 2 + len(rows)
                    n_sm90 += (2 + len(rows)) * (route == "sm90")
                what = f"flash_attn_fwd ({route}) ({b},{T},{h},{dh}) {dname}"
                check(got.dtype == want.dtype and got.shape == want.shape,
                      f"{what}: {got.dtype}{tuple(got.shape)} vs plain "
                      f"{want.dtype}{tuple(want.shape)}")
                check(torch.isfinite(got.float()).all().item(),
                      f"{what}: not finite")
                check(torch.equal(got, again),
                      f"{what}: two identical calls gave different bits")
                check(all(torch.equal(a[0], got[i])
                          for a, i in zip(alone, rows)),
                      f"{what}: a row computed alone differs from the same "
                      f"row in a batch of {b}")
                d = (got.float() - want.float()).abs()
                err = d.max().item()
                vmax = float(v.float().abs().max())
                if dtype == torch.float32:
                    tol = f"{FLASH_F32_TOL}+{FLASH_F32_TOL}*|want|"
                    ok = not (d > FLASH_F32_TOL
                              * (1 + want.float().abs())).any()
                else:
                    lim = FLASH_BF16_ULPS * 2.0 ** (
                        math.floor(math.log2(vmax)) - 7)
                    tol = f"{lim:.3e}"
                    ok = err <= lim
                check(bool(ok), f"{what} disagrees with the plain version: "
                      f"max abs err {err:.3e} > {tol}")
                fields = {}
                if dtype == torch.bfloat16:
                    fields["ulps_at_out_max"] = (
                        f"{ulps_off(got, want.float()):.2f}")
                else:
                    fields["grad_err_of_tol"] = (
                        f"{flash_grads_vs_exact(q, k, v):.2e}")
                    n_calls += 1
                if (b, T, h, dh, dname, route) == (32, 256, 4, 64,
                                                   "bfloat16", "sm90"):
                    main_err = err
                phase("kernel_vs_plain", kernel="flash_attn_fwd",
                      route=route, dtype=dname, b=b, T=T, h=h, dh=dh,
                      max_abs_err=f"{err:.3e}", tol=tol, deterministic=True,
                      batch_invariant=True, **fields)
    launched = registry.launches()
    check(launched.get(att.KERNEL, 0) == n_calls,
          f"flash_attn_fwd launch counter read "
          f"{launched.get(att.KERNEL, 0)} after {n_calls} calls")
    check(launched.get(att.KERNEL_SM90, 0) == n_sm90,
          f"flash_attn_fwd_sm90 launch counter read "
          f"{launched.get(att.KERNEL_SM90, 0)} after {n_sm90} bf16 calls")
    check(main_err is not None, "the sm90 route never ran the main shape")
    return main_err


def gpt_rows(clients, per_client, T, V, seed):
    rng = np.random.default_rng(seed)
    return [[np.eye(V, dtype=np.float32)[rng.integers(0, V, (k, T))]
             for k in rng.integers(1, 5, per_client)]
            for _ in range(clients)]


def phase_serve_gpt():
    """The full-width gpt_mini behind ModelServer: 16 client threads x 4
    /predict requests of 1-4 one-hot rows of T = 256."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.serving import ModelServer

    net = zoo.gpt_mini(seed=SEED)   # vocab 80, width 256, 4 x 4 heads, BF16
    T, V = 256, 80
    clients, per_client = 16, 4
    requests = gpt_rows(clients, per_client, T, V, SEED + 8)
    replies = [[None] * per_client for _ in range(clients)]
    errors = []

    registry.reset_launches()
    srv = ModelServer(net, port=0, max_batch=32, input_shapes=[(T, V)])
    check(srv._infer_row_shapes() == [(T, V)], "warm-up row shapes")
    srv.start()
    warm = len(srv.shapes_seen)
    try:
        def client(c):
            try:
                for j, x in enumerate(requests[c]):
                    status, body = post_json(srv.url + "/predict",
                                             {"features": x.tolist()})
                    check(status == 200, f"/predict answered {status}")
                    replies[c][j] = np.asarray(body["predictions"],
                                               np.float32)
            except Exception as e:  # noqa: BLE001 — reported by the main thread
                errors.append(f"client {c}: {type(e).__name__}: {e}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a client hung")
        check(not errors, "; ".join(errors))
        torch.cuda.synchronize()
        launches = registry.launches().get(att.KERNEL, 0)
        sm90_launches = registry.launches().get(att.KERNEL_SM90, 0)
        status, metrics = get_json(srv.url + "/metrics")
        check(status == 200, f"/metrics answered {status}")
    finally:
        srv.stop()
    forwards = warm + metrics["batches_total"]
    check(launches == 4 * forwards,
          f"the served path launched flash_attn_fwd {launches} times in "
          f"{forwards} forwards, expected 4 per forward")
    check(sm90_launches == launches,
          f"the served path (bf16) launched {launches} flash_attn_fwd, "
          f"{sm90_launches} of them on the sm90 route")

    rows = sum(x.shape[0] for reqs in requests for x in reqs)
    bit_equal, max_err = True, 0.0
    for c in range(clients):
        for x, y in zip(requests[c], replies[c]):
            check(y.shape == (x.shape[0], T, V),
                  f"reply shape {y.shape} for {x.shape}")
            check(np.isfinite(y).all(), "non-finite reply")
            check(np.allclose(y.sum(-1), 1.0, atol=1e-3),
                  "reply rows are not distributions")
            for i in range(x.shape[0]):
                alone = net.output(x[i:i + 1]).float().cpu().numpy()[0]
                bit_equal &= bool(np.array_equal(alone, y[i]))
                max_err = max(max_err, float(np.abs(alone - y[i]).max()))
    check(max_err <= GPT_PROB_TOL,
          f"a coalesced row differs from the same row served alone by "
          f"{max_err:.3e} > {GPT_PROB_TOL}")

    # the first request of every client through the plain CPU path
    cpu = cpu_copy(net)
    t0 = time.perf_counter()
    cpu_err = 0.0
    for c in range(clients):
        want = cpu.output(requests[c][0]).numpy()
        cpu_err = max(cpu_err, float(np.abs(want - replies[c][0]).max()))
    cpu_s = time.perf_counter() - t0
    check(cpu_err <= GPT_PROB_TOL,
          f"served rows vs plain CPU path: max abs err {cpu_err:.3e} > "
          f"{GPT_PROB_TOL}")
    # where the BF16 gap comes from: the residual stream at the head's
    # input, and the CPU path with p rounded as K3 rounds it
    x = requests[0][0]
    stream_card = net.feed_forward(x)[-2].float().cpu()
    stream_cpu = cpu.feed_forward(x)[-2].float()
    stream_max = float(stream_cpu.abs().max())
    stream_diff = float((stream_card - stream_cpu).abs().max())
    exact = registry.get("causal_mha", "cpu")
    registry.register("causal_mha", "cpu")(att.causal_mha_dot)
    try:
        cpu_dot = cpu.output(x).numpy()
    finally:
        registry.register("causal_mha", "cpu")(exact)
    forms_diff = float(np.abs(cpu_dot - cpu.output(x).numpy()).max())
    # the same weights under F32: the path, apart from bf16 rounding
    f32 = zoo.gpt_mini(seed=SEED, dtype=zoo.F32)
    f32.params = {ln: {k: t.clone() for k, t in lp.items()}
                  for ln, lp in net.params.items()}
    f32_err = float(np.abs(f32.output(x).cpu().numpy()
                           - cpu_copy(f32).output(x).numpy()).max())
    check(f32_err <= GPT_F32_TOL,
          f"F32 card vs plain CPU path: {f32_err:.3e} > {GPT_F32_TOL}")
    phase("serve_gpt", model="gpt_mini(vocab=80,width=256,blocks=4,heads=4,"
          "T=256,BF16)", requests=clients * per_client, rows=rows,
          rows_per_s=f"{rows / wall:.2f}",
          p50_ms=metrics["latency_ms"]["p50"],
          p99_ms=metrics["latency_ms"]["p99"],
          batches=metrics["batches_total"], warm_forwards=warm,
          batch_hist=json.dumps(metrics["batch_size_hist"]),
          device_ms_by_bucket=json.dumps(metrics["device_ms_by_bucket"]),
          warmup_s=f"{srv.warmup_s:.2f}", flash_attn_fwd_launches=launches,
          flash_attn_fwd_sm90_launches=sm90_launches,
          launches_per_forward=f"{launches / forwards:g}",
          rows_bit_equal_alone=bit_equal,
          max_abs_err_vs_alone=f"{max_err:.3e}",
          max_abs_err_vs_cpu_plain=f"{cpu_err:.3e}", tol=GPT_PROB_TOL,
          f32_max_abs_err_vs_cpu_plain=f"{f32_err:.3e}",
          f32_tol=GPT_F32_TOL, stream_abs_max=f"{stream_max:.4f}",
          stream_card_vs_cpu=f"{stream_diff:.4f}",
          stream_card_vs_cpu_ulps=f"{ulps_off(stream_card, stream_cpu):.2f}",
          cpu_dot_vs_exact=f"{forms_diff:.3e}", cpu_check_s=f"{cpu_s:.2f}")
    return net, {att.KERNEL: launches, att.KERNEL_SM90: sm90_launches}


def gpt_grads_vs_cpu(net, x, y, dtype):
    """The first step's score and gradients on the card vs the plain CPU
    path with the same weights. Returns (relative score error, gradient
    error: bf16 ulps at each gradient's max under BF16, else the error
    over each gradient's max, the card's loss)."""
    card_loss, card_g = loss_and_grads(net, x, y)
    cpu_loss, cpu_g = loss_and_grads(cpu_copy(net), x, y)
    score_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    errs = {}
    for (ln, k), g in cpu_g.items():
        cg = card_g[(ln, k)].cpu()
        if k == "bk":
            rel = 1e-5 if dtype == "float32" else 2.0 ** -8
            lim = rel * float(cpu_g[(ln, "Wk")].abs().max())
            check(float(cg.abs().max()) <= lim
                  and float(g.abs().max()) <= lim,
                  f"{ln}.bk gradient is not noise around 0 ({dtype})")
            continue
        if dtype == "float32":
            errs[f"{ln}.{k}"] = (float((cg - g).abs().max())
                                 / float(g.abs().max()))
        else:
            errs[f"{ln}.{k}"] = ulps_off(cg, g)
    print(f"  gpt first step vs plain CPU ({dtype}): score {card_loss:.6f} "
          f"vs {cpu_loss:.6f}; gradient errors: "
          + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}),
          flush=True)
    return score_err, max(errs.values()), card_loss


# Kernels by kind, from the words in their names (lower case), tried in
# this order (the words read from the kernel listings of VGG-16, LeNet and
# ResNet-18 steps, profile_out/<net>_kernels.json): cuDNN's layout and
# padding transforms; the split-K parts of cuDNN's weight gradients and of
# cuBLAS's products; cuDNN's workspace initialisation; PyTorch's pooling;
# cuDNN's convolutions (forward, data and weight gradients), before the
# GEMM words, which the implicit-GEMM convolutions' names hold too; then
# PyTorch's reductions ("reduce_kernel"), copies, memsets and elementwise
# kernels.
KERNEL_KINDS = (
    ("layout", ("nchwtonhwc", "nhwctonchw", "transpose", "addpadding")),
    ("splitk", ("splitk", "split_k")),
    ("conv_workspace", ("init_device_workspace",)),
    ("pool", ("max_pool", "avg_pool")),
    ("cudnn_conv", ("fprop", "dgrad", "wgrad", "convolve", "conv2d",
                    "winograd")),
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "cublas", "nvjet")),
    ("reduce", ("reduce",)),
    ("copy", ("copy",)),
    ("memset", ("memset",)),
    # torch._foreach_* (the multi-tensor update)
    ("update", ("multi_tensor_apply",)),
    ("elementwise", ("elementwise",)),
)


def kernel_kind(name):
    """The kind a kernel of the profiler's listing is counted under."""
    name = name.lower()
    if "flash_fwd_kernel" in name:
        return "flash_attn_fwd"
    if "lstm_" in name:
        return "lstm"
    for kind, words in KERNEL_KINDS:
        if any(w in name for w in words):
            return kind
    return "other"


def profile_steps(net, data, names_to=None):
    """torch.profiler over len(data) more fit_batch steps: the device's
    kernel time and kernel count per step, its busy share of the steps'
    host-clock wall time, and both by kind of kernel (``kernel_kind``).
    With ``names_to`` (a file name), every kernel's name, kind, launches
    and device ms a step go to profile_out/<names_to> (beside this script)
    as JSON."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for ds in data:
            net.fit_batch(ds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof.key_averages())
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    n = len(data)
    check(sum(dev_us.values()) > 0, "the profiler saw no device time")
    flash_us = sum(v for k, v in dev_us.items() if "flash_fwd_kernel" in k)
    groups, listing = {}, []
    for e in kernels:
        g = kernel_kind(e.key)
        ms, cnt = groups.get(g, (0.0, 0))
        groups[g] = (ms + e.self_device_time_total / 1e3 / n,
                     cnt + e.count // n)
        listing.append({"kind": g, "launches_per_step": e.count / n,
                        "ms_per_step": e.self_device_time_total / 1e3 / n,
                        "name": e.key})
    if names_to is not None:
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "profile_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, names_to), "w") as f:
            json.dump(sorted(listing, key=lambda r: -r["ms_per_step"]), f,
                      indent=1)
    return {
        "prof_by_kind_ms_and_kernels_per_step": json.dumps(
            {g: [round(ms, 4), c] for g, (ms, c) in sorted(groups.items())}),
        "prof_steps": n,
        "prof_wall_ms_per_step": f"{wall_ms / n:.3f}",
        "prof_device_ms_per_step": f"{sum(dev_us.values()) / 1e3 / n:.3f}",
        "prof_device_busy_share": f"{sum(dev_us.values()) / 1e3 / wall_ms:.3f}",
        "prof_kernels_per_step": sum(e.count for e in kernels) // n,
        "prof_flash_attn_fwd_ms_per_step": f"{flash_us / 1e3 / n:.4f}",
    }


def phase_train_gpt():
    """30 fit_batch steps of the full-width gpt_mini (BF16, Adam 3e-4) at
    b = 32, T = 256; the first step held against the plain CPU path."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.ops import registry
    steps, b, T, V = 30, 32, 256, 80
    net = zoo.gpt_mini(seed=SEED + 9)
    pol = net.conf.global_conf.dtype
    check(pol.compute_dtype == "bfloat16" and pol.param_dtype == "float32",
          f"gpt_mini policy {pol}")
    upd = net.layers[1].resolve("updater")
    check(upd.kind == "adam" and upd.learning_rate == 3e-4,
          f"gpt_mini does not train with Adam(3e-4): {upd}")
    batches = markov_batches(steps, b, T, V, SEED + 6)
    x0, y0 = batches[0]

    # the first step under F32 (the path) and BF16 (the run) vs the plain
    # CPU path on the same weights
    f32 = zoo.gpt_mini(seed=SEED + 9, dtype=zoo.F32)
    f32_score, f32_grad, _ = gpt_grads_vs_cpu(f32, x0, y0, "float32")
    check(f32_score <= 1e-6, f"F32 train score card vs CPU: {f32_score:.3e}")
    check(f32_grad <= GPT_F32_GRAD_TOL, f"F32 gradients card vs CPU: "
          f"{f32_grad:.3e} of max > {GPT_F32_GRAD_TOL}")
    t0 = time.perf_counter()
    score_err, grad_ulps, card_loss = gpt_grads_vs_cpu(net, x0, y0,
                                                       "bfloat16")
    cpu_s = time.perf_counter() - t0
    check(score_err <= TRAIN_SCORE_RTOL,
          f"gpt train score card vs CPU: {score_err:.3e} > "
          f"{TRAIN_SCORE_RTOL}")
    check(grad_ulps <= GPT_GRAD_ULPS, f"gpt gradients card vs CPU: "
          f"{grad_ulps:.2f} bf16 ulps at max > {GPT_GRAD_ULPS}")

    data = on_card(batches)
    torch.cuda.synchronize()
    registry.reset_launches()
    scores, events = [], []
    t0 = time.perf_counter()
    for ds in data:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        scores.append(net.fit_batch(ds))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = registry.launches()
    step_ms = [s.elapsed_time(e) for s, e in events]
    scores = [float(s) for s in scores]
    check(all(math.isfinite(s) for s in scores), f"gpt scores {scores}")
    check(abs(scores[0] - card_loss) <= 1e-6 * abs(card_loss),
          f"fit_batch score {scores[0]} != its loss {card_loss}")
    last5 = statistics.mean(scores[-5:])
    check(last5 < scores[0], f"gpt training did not lower the score: first "
          f"{scores[0]:.4f}, mean of last 5 {last5:.4f}")
    for kern in ("flash_attn_fwd", "flash_attn_fwd_sm90"):
        check(launches.get(kern, 0) == 4 * steps,
              f"{kern} launched {launches.get(kern, 0)} times in {steps} "
              f"train steps (bf16), expected {4 * steps}")
    med = statistics.median(step_ms[-20:])
    prof = profile_steps(net, data[:3])
    phase("train_gpt", model="gpt_mini(vocab=80,width=256,blocks=4,heads=4,"
          "BF16,Adam(3e-4))", steps=steps, b=b, T=T,
          first_score=f"{scores[0]:.4f}", last5_mean=f"{last5:.4f}",
          scores=json.dumps([round(s, 4) for s in scores]),
          step_ms_median_last20=f"{med:.4f}",
          step_ms_min=f"{min(step_ms[-20:]):.4f}",
          step_ms_max=f"{max(step_ms[-20:]):.4f}", wall_s=f"{wall:.3f}",
          launches=json.dumps(launches),
          score_vs_cpu_rel=f"{score_err:.3e}",
          grad_vs_cpu_max_ulps=f"{grad_ulps:.2f}",
          f32_score_vs_cpu_rel=f"{f32_score:.3e}",
          f32_grad_vs_cpu_rel=f"{f32_grad:.3e}",
          cpu_first_step_s=f"{cpu_s:.2f}",
          peak_mem_mb=f"{torch.cuda.max_memory_allocated() / 2**20:.0f}",
          **prof)
    return {"launches": launches, "step_ms": med}


def phase_times_flash(card, gnet, errs, launches, gtrain):
    """K3 at the served/trained shape beside its bound, its plain version,
    its first kernel (the FMA kernel's bf16 instantiation) and
    scaled_dot_product_attention (the yardstick only; the port never
    calls it). The two kernels are timed in turns: FMA, sm90, sm90,
    FMA."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import attention as att
    b, T, h, dh = 32, 256, 4, 64
    q, k, v = flash_inputs(b, T, h, dh, torch.bfloat16)
    with torch.inference_mode():
        sm90 = lambda: att.flash_attn_fwd_cuda(q, k, v)  # noqa: E731
        fma = lambda: flash_fma(q, k, v)  # noqa: E731
        fma_ms = [cuda_ms_per_launch(fma, reps=10)]
        sm90_ms = [cuda_ms_per_launch(sm90, reps=10) for _ in range(2)]
        fma_ms.append(cuda_ms_per_launch(fma, reps=10))
        ms, old_ms = statistics.mean(sm90_ms), statistics.mean(fma_ms)
        one_ms = cuda_ms(sm90, reps=50)
        # back to back, a call of ~0.01 ms on the card is issued more slowly
        # than the card runs it: the host's time to issue one call (the
        # wrapper, the entry point straight through ctypes into a
        # preallocated output, SDPA) says how much of each back-to-back
        # time is the host's, and the profiler's device time, taken in
        # turns with SDPA's (sm90, SDPA, three times), is the kernel's
        lib, out = att._bind(), torch.empty_like(q)
        ptrs = [x.data_ptr() for x in (q, k, v, out)]
        stream = torch.cuda.current_stream().cuda_stream
        entry = lambda: lib.dl4j_flash_attn_fwd_sm90(  # noqa: E731
            *ptrs, b, T, h, dh, stream)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True)
        c_ms = cuda_ms_per_launch(entry, reps=10)
        plain_ms = cuda_ms_per_launch(
            lambda: att.flash_attn_fwd_torch(q, k, v), reps=10)
        lib_ms = cuda_ms_per_launch(sdpa, reps=10)
        host_ms = {name: host_ms_per_call(fn) for name, fn in
                   (("sm90", sm90), ("entry_point", entry), ("sdpa", sdpa))}
        dev_readings, dev_lib_readings, kept = [], [], []
        for _ in range(3):
            for readings, fn in ((dev_readings, sm90),
                                 (dev_lib_readings, sdpa)):
                dev, n = device_ms_per_call(fn, reps=100)
                readings.append(dev)
                kept.append(n)
        dev_ms = statistics.median(dev_readings)
        dev_lib_ms = statistics.median(dev_lib_readings)
        dev_fma_ms, n = device_ms_per_call(fma, reps=100)
        kept.append(n)
        lib_err = float((sdpa().transpose(1, 2).float()
            - sm90().float()).abs().max())
    # least work: q, k, v read once and out written once (bf16); the
    # causal products q.k and p.v over the b*h*T*(T+1)/2 visible pairs
    # (the softmax's ~5 ops per pair are under 2% of it)
    pairs = b * h * T * (T + 1) / 2
    flops = 2.0 * 2.0 * dh * pairs
    nbytes = 2 * 4 * b * T * h * dh
    bound_ms, bound_by = bound(flops, nbytes, "bfloat16")
    rng = np.random.default_rng(SEED + 12)
    forward_ms = {}
    for rows in (1, 32):
        x = torch.from_numpy(np.eye(80, dtype=np.float32)[
            rng.integers(0, 80, (rows, T))]).cuda()
        forward_ms[rows] = cuda_ms(lambda: gnet.output(x), reps=20)
    phase("times", kernel="flash_attn_fwd", route="sm90", b=b, T=T, h=h,
          dh=dh, dtype="bfloat16", card=json.dumps(card), ms=f"{ms:.4f}",
          ms_readings=json.dumps([round(t, 5) for t in sm90_ms]),
          fma_bf16_ms=f"{old_ms:.4f}",
          fma_bf16_ms_readings=json.dumps([round(t, 5) for t in fma_ms]),
          ms_one_call_with_host=f"{one_ms:.4f}",
          device_ms=f"{dev_ms:.4f}",
          device_ms_readings=json.dumps([round(t, 5) for t in dev_readings]),
          profiler_kept_of_100=json.dumps(kept),
          fma_bf16_device_ms=f"{dev_fma_ms:.4f}",
          entry_point_ms=f"{c_ms:.4f}",
          library_device_ms=f"{dev_lib_ms:.4f}",
          library_device_ms_readings=json.dumps(
              [round(t, 5) for t in dev_lib_readings]),
          host_issue_ms=json.dumps({k: round(t, 5)
                                    for k, t in host_ms.items()}),
          device_roofline_share=f"{bound_ms / dev_ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
          library="torch.nn.functional.scaled_dot_product_attention"
                  "(is_causal=True)",
          library_max_abs_diff=f"{lib_err:.3e}",
          bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
          flops=f"{flops:.4g}", bytes=f"{nbytes:.4g}",
          roofline_share=f"{bound_ms / ms:.4f}",
          fma_roofline_share=f"{bound_ms / old_ms:.4f}",
          gpt_forward_ms_b1=f"{forward_ms[1]:.4f}",
          gpt_forward_ms_b32=f"{forward_ms[32]:.4f}",
          gpt_train_step_ms=f"{gtrain['step_ms']:.4f}")
    return [{"name": "flash_attn_fwd", "route": "cuda",
             "source": "deeplearning4j_tpu_torch/ops/csrc/flash_attn_fwd.cu",
             "replaces": "deeplearning4j_tpu/ops/attention.py:197",
             "launches": launches["serve_gpt"][att.KERNEL],
             "launches_by_path": {p: v.get(att.KERNEL, 0)
                                  for p, v in launches.items()},
             "launches_sm90_by_path": {p: v.get(att.KERNEL_SM90, 0)
                                       for p, v in launches.items()},
             "path": "bf16: sm90 (TMA loads, wgmma, P from registers); "
                     "f32: FMA",
             "max_abs_err": errs["flash_attn_fwd"], "ms": ms,
             "fma_bf16_ms": old_ms, "device_ms": dev_ms,
             "fma_bf16_device_ms": dev_fma_ms,
             "library_device_ms": dev_lib_ms,
             "host_issue_ms": host_ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": lib_ms}]


def sweep_ms(make_args, fn, T):
    """ms of ``fn(*args)`` at T = 1, 16 and T: the cost per dependent step
    and the fixed cost."""
    import torch
    ms = {}
    for steps in (1, 16, T):
        a = make_args(steps)
        with torch.inference_mode():
            ms[steps] = cuda_ms(lambda: fn(*a), reps=50)
    per_step = (ms[T] - ms[16]) / (T - 16)
    return ms, per_step, ms[1] - per_step


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def sweep_fields(sweep, per_step, fixed, T):
    return dict(ms=f"{sweep[T]:.4f}", ms_T1=f"{sweep[1]:.4f}",
                ms_T16=f"{sweep[16]:.4f}", per_step_us=f"{1e3 * per_step:.2f}",
                fixed_us=f"{1e3 * fixed:.2f}",
                chain_ms=f"{T * per_step:.4f}")


def fwd_on(cluster):
    """K1 through the route ``cluster`` names, uncounted (the grid route's
    bf16 instantiation is not the wrapper's for bf16 at n = 512)."""
    import torch
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops

    def run(xz, h0, c0, Wh, p, mask, save=False):
        if mask is None:
            mask = torch.ones(xz.shape[:2], dtype=xz.dtype, device=xz.device)
        return lstm_ops.lstm_fwd_launch(cluster, xz, h0, c0, Wh, p, mask,
                                        save)
    return run


def bwd_on(cluster):
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    return lambda *a: lstm_ops.lstm_bwd_launch(cluster, *a)


def bwd_split(args):
    """K2's cluster route split by launch (torch.profiler): the chain, the
    sum of dp's partials and dWh on the sm90 mainloop, each kernel's mean
    device ms over the launches the profiler kept."""
    import torch
    names = {"lstm_bwd_cluster_kernel": "chain", "lstm_bwd_dp_sum": "dp_sum",
             "DwhEpi": "dwh"}
    with torch.inference_mode():
        events = device_events(lambda: bwd_on(True)(*args), reps=20)
    split, kept = {}, []
    for e in events:
        for key, name in names.items():
            if key in e.key:
                split[name] = e.self_device_time_total / e.count / 1e3
                kept.append(e.count)
    check(set(split) == set(names.values()),
          f"the profiler did not see every K2 launch: {split}")
    return split, min(kept)


def lstm_times(card, tag="times"):
    """K1 and K2 at (T = 64, b = 32, n = 512, bf16) on the cluster route
    and on the grid route in the same run: ms, the T sweep (per-step and
    fixed cost), the bound, and K2's split by launch. Returns the numbers
    phase_times puts in the kernels line."""
    import torch
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    T, b, n = 64, 32, 512
    dtype = torch.bfloat16
    esize = 2
    no_library = ("none: cuDNN's LSTM has neither peepholes nor this mask "
                  "semantics")
    out = {}
    # clusters of n / 32 blocks each kernel's cluster route fits at once
    # (cudaOccupancyMaxActiveClusters): b above 32 x that runs in waves
    fits = {name: getattr(lstm_ops._bind(name),
                          f"dl4j_{name}_sm90_clusters")(n)
            for name in (lstm_ops.KERNEL, lstm_ops.BWD_KERNEL)}

    # K1: least work, the recurrent products (the gates' elementwise work
    # is ~20 ops per output, 0.05% of it), each input read once, each
    # output written once
    flops = 2.0 * T * b * n * 4 * n
    nbytes = esize * (T * b * 4 * n + T * b + 2 * b * n + n * 4 * n + 3 * n
                      + T * b * n + 2 * b * n)
    bound_ms, bound_by = bound(flops, nbytes, "bfloat16")
    args = lstm_inputs(T, b, n, dtype)
    with torch.inference_mode():
        plain_ms = cuda_ms(lambda: lstm_ops.lstm_sequence_torch(*args),
                           reps=5)
        # as the train path runs it: residuals written for K2
        res_ms = cuda_ms(lambda: fwd_on(True)(*args, True), reps=50)
    for cluster in (False, True, True, False):
        sweep, per_step, fixed = sweep_ms(
            lambda steps: lstm_inputs(steps, b, n, dtype), fwd_on(cluster), T)
        route = "cluster" if cluster else "grid"
        out.setdefault(("fwd", route), []).append(sweep[T])
        phase(tag, kernel="lstm_fwd", route=route, T=T, b=b, n=n,
              dtype="bfloat16", card=json.dumps(card),
              plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.5f}",
              bound_by=bound_by, flops=f"{flops:.4g}", bytes=f"{nbytes:.4g}",
              roofline_share=f"{bound_ms / sweep[T]:.4f}",
              **sweep_fields(sweep, per_step, fixed, T),
              **({"ms_with_residuals": f"{res_ms:.4f}",
                  "active_clusters": fits["lstm_fwd"]} if cluster else {}),
              library=no_library)
    out["fwd"] = dict(ms=min(out[("fwd", "cluster")]), plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by,
                      grid_ms=min(out[("fwd", "grid")]))

    # K2: least work, the chain's dz @ Wh^T and dWh = h_prev^T dz (the
    # elementwise gate work is ~30 ops per element, under 0.1% of it);
    # G, h_prev, c_prev, mask, Wh, p, dy, dhT, dcT read once, dxz, dh0,
    # dc0, dWh, dp written once
    bflops = 2.0 * (2.0 * T * b * n * 4 * n)
    bbytes = esize * (T * b * 4 * n + 2 * T * b * n + T * b + n * 4 * n
                      + 3 * n + T * b * n + 2 * b * n + T * b * 4 * n
                      + 2 * b * n + n * 4 * n + 3 * n)
    bbound_ms, bbound_by = bound(bflops, bbytes, "bfloat16")
    bargs, _ = bwd_inputs(T, b, n, dtype)
    with torch.inference_mode():
        bplain_ms = cuda_ms(lambda: lstm_ops.lstm_sequence_bwd_torch(*bargs),
                            reps=5)
    for cluster in (False, True, True, False):
        sweep, per_step, fixed = sweep_ms(
            lambda steps: bwd_inputs(steps, b, n, dtype)[0], bwd_on(cluster),
            T)
        route = "cluster" if cluster else "grid"
        out.setdefault(("bwd", route), []).append(sweep[T])
        extra = {}
        if cluster:
            split, kept = bwd_split(bargs)
            extra = dict(split_device_ms=json.dumps(
                {k: round(v, 5) for k, v in split.items()}),
                profiler_kept=f"{kept}/20",
                active_clusters=fits["lstm_bwd"])
        phase(tag, kernel="lstm_bwd", route=route, T=T, b=b, n=n,
              dtype="bfloat16", card=json.dumps(card),
              plain_ms=f"{bplain_ms:.4f}", bound_ms=f"{bbound_ms:.5f}",
              bound_by=bbound_by, flops=f"{bflops:.4g}",
              bytes=f"{bbytes:.4g}",
              roofline_share=f"{bbound_ms / sweep[T]:.4f}",
              **sweep_fields(sweep, per_step, fixed, T), **extra,
              library=no_library)
    out["bwd"] = dict(ms=min(out[("bwd", "cluster")]), plain_ms=bplain_ms,
                      bound_ms=bbound_ms, bound_by=bbound_by,
                      grid_ms=min(out[("bwd", "grid")]))
    return out


def phase_times(card, net, errs, launches, train):
    """[times] for K1 and K2 (lstm_times), the whole served forward at
    the smallest and largest bucket, and the kernels line's entries."""
    import torch
    t = lstm_times(card)
    T = 64
    rng = np.random.default_rng(SEED + 2)
    forward_ms = {}
    for rows in (2, 32):
        x = torch.from_numpy(np.eye(80, dtype=np.float32)[
            rng.integers(0, 80, (rows, T))]).cuda()
        forward_ms[rows] = cuda_ms(lambda: net.output(x), reps=20)
    phase("times", kernel="char_rnn", forward_ms_b2=f"{forward_ms[2]:.4f}",
          forward_ms_b32=f"{forward_ms[32]:.4f}",
          train_step_ms=f"{train['step_ms']:.4f}")
    kernels = []
    for name, key, path, line in (("lstm_fwd", "fwd", "serve", 100),
                                  ("lstm_bwd", "bwd", "train", 145)):
        r = t[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/ops/csrc/{name}.cu",
            "replaces": f"deeplearning4j_tpu/ops/lstm.py:{line}",
            "launches": launches[path][name],
            "launches_by_path": {k: v.get(name, 0)
                                 for k, v in launches.items()},
            "cluster_route_calls": launches[path].get(name + "_sm90", 0),
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "grid_route_ms": r["grid_ms"]})
    return kernels


# The parts of a cluster-kernel step between its STEP_MARKs
# (ops/csrc/lstm_cluster.cuh), in order
STEP_PARTS = {"lstm_fwd": ("product", "z_staging", "cell_update",
                           "h_copies_issued", "wait_h"),
              "lstm_bwd": ("phase_a", "wait_readers", "product",
                           "partials_copies_issued", "wait_partials", "sum")}


def phase_lstm_parts():
    """``python3 chip_smoke.py --lstm-parts``: where a step of K1's and
    K2's cluster kernels goes. Builds both libraries once more with
    -DDL4J_LSTM_STEP_MARKS (clock64() at the end of each part of a step,
    block 0, one thread a warpgroup), runs each at (T = 64, b = 32, n =
    512, bf16) and prints each part's median cycles over steps 8-55 and
    the SM clock to read them by."""
    import ctypes
    import torch
    from deeplearning4j_tpu_torch.ops import _build
    out = _build.BUILD_DIR / "step_marks"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    libs = {}
    for name in STEP_PARTS:
        path = out / f"lib{name}_marks.so"
        libs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-DDL4J_LSTM_STEP_MARKS", "-o",
             str(path), str(_build.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            path)
    for name, (proc, _) in libs.items():
        log = proc.communicate()[0]
        check(proc.returncode == 0, f"{name} with step marks: {log[-3000:]}")
    T, b, n = 64, 32, 512
    for name, (_, path) in libs.items():
        lib = ctypes.CDLL(str(path))
        _build._LIBS[name] = lib  # the wrappers bind this build
        try:
            if name == "lstm_fwd":
                args = lstm_inputs(T, b, n, torch.bfloat16)
                fn = lambda: fwd_on(True)(*args)  # noqa: E731
            else:
                bargs, _ = bwd_inputs(T, b, n, torch.bfloat16)
                fn = lambda: bwd_on(True)(*bargs)  # noqa: E731
            with torch.inference_mode():
                ms = cuda_ms(fn, 20)
                fn()
            torch.cuda.synchronize()
            marks = np.zeros((2, 64, 8), np.int64)
            entry = getattr(lib, f"dl4j_{name}_step_marks")
            entry.argtypes = [ctypes.c_void_p]
            check(entry(marks.ctypes.data) == 0, f"{name}: no step marks")
        finally:
            _build._LIBS.pop(name)
        k = len(STEP_PARTS[name])
        for wg in (0, 1):
            m = marks[wg, 8:57, :k + 1].astype(np.float64)
            parts = np.median(np.diff(m[:-1], axis=1), axis=0)
            phase("lstm_parts", kernel=name, T=T, b=b, n=n, warpgroup=wg,
                  ms=f"{ms:.4f}",
                  step_cycles=int(np.median(np.diff(m[:, 0]))),
                  **{p: int(v) for p, v in zip(STEP_PARTS[name], parts)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    phase("lstm_parts", sm_clock=json.dumps(smi.stdout.strip()))


def phase_lstm_split():
    """``python3 chip_smoke.py --lstm-split``: only K1's and K2's times on
    both routes (grid, cluster, cluster, grid) with the T sweep and K2's
    split by launch."""
    from deeplearning4j_tpu_torch.ops import _build
    _build.build(("lstm_fwd", "lstm_bwd"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lstm_times(smi.stdout.strip(), tag="lstm_split")


# --------------------------------------------------------------- K4-K7
# ResNet-50's fused tails at b = 256, 224 x 224: (stage, M = b*H*W, K, N)
RESNET_TAILS = (("s1", 200704, 128, 512), ("s2", 50176, 256, 1024),
                ("s3", 12544, 512, 2048))
RESNET_TAIL_COUNT = {"s1": 4, "s2": 6, "s3": 3}
# K4-K7 vs their plain versions on the card (fused_vs_plain). Outputs
# formed elementwise (y, dx, dshortcut; dx sums over N <= 2048 in f32):
# f32 1e-5 of the output's max (the same f32 products in another order);
# bf16 2 ulps at the output's max (z is the f32 product rounded to bf16,
# and a sum in another order can land that rounding the other way, which
# moves the output by about an ulp; each side rounds once more). Sums over
# M (s1, s2, a, b, dW; M up to 200,704), per column: f32 1e-5 of the
# largest sum of the terms' magnitudes (the error of an f32 sum in any
# order scales with it, not with the sum). bf16 FUSED_SUM_BF16 of it plus
# FUSED_SUM_FLIPS times the most one flipped bf16 rounding of z (of dz for
# dW) can move one term: on an NVIDIA H100 80GB HBM3 the sums read up to
# 1.4e-6 of the magnitudes at M = 200,704, and up to one such flip at
# M = 1000, where a few flips outweigh the f32 order. Each case also
# reads what a kernel that dropped its first m-tile (dW: its first split
# of M) would be off by, and fails unless the limit would catch it.
FUSED_F32_TOL = 1e-5
FUSED_SUM_BF16 = 1e-5
FUSED_SUM_FLIPS = 4
# FusedTailFn's gradients vs autograd of the composed f32 reference (conv,
# batch statistics, normalise, add, relu): 1e-4 of each gradient's max,
# the f32 arithmetic in another order through the BN backward's 1/sigma.
FUSED_GRAD_TOL = 1e-4
# ResNet-50's first train step, same weights and batch (b = 8), fusion on.
# Measured on an NVIDIA H100 80GB HBM3: at this full-depth net's first step
# every f32 path, card or CPU, fused or not, lies 1-2% (L2) and up to ~12%
# (at a gradient's max) from an f64 CPU run of the same step, so two f32
# paths cannot agree to 1e-4 of max. The gradients of a relu/max-pool net
# are discontinuous: a rounding that moves a pre-activation across 0, or
# changes a pool's winner, changes the gradient by a finite amount (on the
# CPU tests' small graph an additive 1e-6 change of the f64 input moves them
# by 0.8% L2, as far as f32 from f64). So each path is held against the f64
# plain CPU path (the unfused walk: the fused op takes f32 and bf16 only):
# the card's gradients, fused, must be as accurate as the plain CPU path's
# and as the card's own unfused step's, in each gradient's L2 error relative
# to its norm, to within a factor RESNET_ACCURACY_RATIO plus 1e-3. Scores:
# F32 1e-5 relative, BF16 1e-2 relative (the loss is an f32 mean over bf16
# activations), card vs CPU and fused vs unfused. Card vs the plain CPU path
# directly, F32: RESNET_F32_GRAD_L2 of each gradient's norm (the f32 paths'
# measured spread, 1.2-2.1e-2, with margin).
RESNET_F32_SCORE_RTOL = 1e-5
RESNET_BF16_SCORE_RTOL = 1e-2
RESNET_ACCURACY_RATIO = 2.0
RESNET_F32_GRAD_L2 = 5e-2
# BF16: the same discontinuities, met at bf16's precision, put the
# gradients of every path 110-160% (L2) from f64, and card vs the plain
# CPU path 0.9-1.2 apart in every block but the last bottleneck and the
# output layer (H100 run). So BF16 is held card vs the plain CPU path (the
# same op and rounding points) on the gradients nearest the loss,
# RESNET_BF16_HEAD: the output layer's (the forward through all 13 K4/K5
# tails feeds it) and the last tail's BN gamma and beta (K6's b and a).
# Measured 0.056, 0.0025, 0.159 and 0.063 of each gradient's norm;
# RESNET_BF16_HEAD_GRAD_L2 is about twice the largest, so a kernel that
# halves any of them, or zeroes it, fails.
RESNET_BF16_HEAD = ("fc.W", "fc.b", "s3b2_c_bn.gamma", "s3b2_c_bn.beta")
RESNET_BF16_HEAD_GRAD_L2 = 0.3
# Fused vs unfused at b = 256, BF16, on the card: the score to 1e-2
# relative; the gradients' L2 distance is reported (the fused epilogue
# runs in f32, the unfused BN in bf16). Eval at b = 32, BF16, card vs the
# plain CPU path: each row's largest probability error over the row's
# largest probability, RESNET_ROW_PROB_TOL (measured 2.05e-2 on an H100:
# a bf16 logit near 16-32 that rounds the other way moves its probability
# by up to 2**-3 of itself; the rows' largest probability averages 0.53).
RESNET_ROW_PROB_TOL = 5e-2


def tail_inputs(M, K, N, dtype, seed=0):
    """Seeded inputs of one fused tail on the card, and the plain
    forward's statistics and y, so each kernel sees the same inputs as
    its plain version."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    rng = np.random.default_rng(SEED + 13 + seed + M + K + N)
    f = lambda a, dt=dtype: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to("cuda", dt)
    x = f(rng.normal(0.0, 1.0, (M, K)))
    W = f(rng.normal(0.0, 1.0 / math.sqrt(K), (K, N)))
    gamma = f(rng.uniform(0.5, 1.5, N), torch.float32)
    beta = f(rng.normal(0.0, 1.0, N), torch.float32)
    sc = f(rng.normal(0.0, 1.0, (M, N)))
    shift = f(rng.normal(0.0, 0.1, N), torch.float32)
    dy = f(rng.normal(0.0, 1.0, (M, N)))
    return dict(x=x, W=W, gamma=gamma, beta=beta, sc=sc, shift=shift, dy=dy)


def tail_plain(t, relu):
    """The plain passes' intermediates (the forward's arithmetic of
    fused_forward, on the plain K4/K5 versions): (y, mean, var, inv,
    scale, sh, ca, cb)."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    M = t["x"].shape[0]
    with torch.no_grad():
        s1, s2 = fb.fused_stats_torch(t["x"], t["W"], t["shift"])
        m1 = s1 / M
        mean = m1 + t["shift"]
        var = torch.clamp(s2 / M - m1 * m1, min=0.0)
        inv = torch.rsqrt(var + 1e-5)
        scale = t["gamma"] * inv
        sh = t["beta"] - mean * scale
        y = fb.fused_apply_torch(t["x"], t["W"], scale, sh, t["sc"], relu)
        a, b = fb.fused_bwd_stats_torch(t["x"], t["W"], mean, inv, t["dy"],
                                        y, relu)
    return dict(y=y, mean=mean, var=var, inv=inv, scale=scale, sh=sh,
                ca=a / M, cb=b / M)


def fused_args(t, p, relu):
    """K4-K7's arguments, as their wrappers take them, from a tail's
    inputs ``t`` and the plain passes' intermediates ``p``."""
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    return {
        fb.STATS: (t["x"], t["W"], t["shift"]),
        fb.APPLY: (t["x"], t["W"], p["scale"], p["sh"], t["sc"], relu),
        fb.BWD_STATS: (t["x"], t["W"], p["mean"], p["inv"], t["dy"], p["y"],
                       relu),
        fb.BWD_APPLY: (t["x"], t["W"], p["mean"], p["inv"], p["scale"],
                       p["ca"], p["cb"], t["dy"], p["y"], relu)}


def bf16_ulp(v):
    """The bf16 ulp at magnitude ``v`` (0 at 0)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7) if v > 0 else 0.0


def sum_limits(t, p, relu):
    """For each sum over M (s1, s2, a, b, dW): (limit, fault). The limit
    is the largest (over columns) sum of its terms' magnitudes times
    FUSED_F32_TOL (f32), or times FUSED_SUM_BF16 plus FUSED_SUM_FLIPS
    times the most one flipped bf16 rounding moves one term (bf16); fault
    is the largest error of a kernel that dropped the first m-tile (dW:
    the first of its splits of M)."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    x, cd = t["x"], t["x"].dtype
    M, K = x.shape
    with torch.no_grad():
        z = fb._z(x, t["W"])
        zs = z - t["shift"]
        g = fb._g(t["dy"], p["y"], relu)
        xhat = (z - p["mean"]) * p["inv"]
        dz = (p["scale"] * (g - p["ca"] - xhat * p["cb"])).to(cd).float()
        xf = x.float()
        uz = bf16_ulp(float(z.abs().max()))
        zs_max = float(zs.abs().max())
        # (terms [M, N], the most one flip moves a term)
        terms = {"s1": (zs, uz), "s2": (zs * zs, (2 * zs_max + uz) * uz),
                 "a": (g, 0.0),
                 "b": (g * xhat, float(g.abs().max()) * uz
                       * float(p["inv"].max()))}
        out = {}
        for nm, (tm, flip) in terms.items():
            out[nm] = (float(tm.abs().sum(0).max()), flip,
                       float(tm[:fb.TILE_M].sum(0).abs().max()))
        sm90 = fb.takes_sm90(x, t["W"], t["dy"], p["y"])
        chunk = fb.dw_splits(M, K, t["W"].shape[1], sm90)[1]
        out["dW"] = (float((xf.abs().t() @ dz.abs()).max()),
                     float(xf.abs().max()) * bf16_ulp(float(dz.abs().max())),
                     float((xf[:chunk].t() @ dz[:chunk]).abs().max()))
    if cd == torch.float32:
        return {nm: (FUSED_F32_TOL * mag, fault)
                for nm, (mag, _, fault) in out.items()}
    return {nm: (FUSED_SUM_BF16 * mag + FUSED_SUM_FLIPS * flip, fault)
            for nm, (mag, flip, fault) in out.items()}


def tail_path(x, W, *mn):
    """The path a fused-tail kernel takes on x, W and the [M, N] tensors
    it reads (K4 none, K5 the shortcut, K6 and K7 dy and y): "sm90" (TMA
    + wgmma, bf16 with rows TMA can read), "mma.sync" (other bf16) or
    "fma" (f32)."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    if fb.takes_sm90(x, W, *mn):
        return "sm90"
    return "mma.sync" if x.dtype == torch.bfloat16 else "fma"


def kernel_path(kern, args):
    """The path kernel ``kern`` takes on its arguments ``args`` (as its
    wrapper gets them)."""
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    mn = {fb.STATS: (), fb.APPLY: args[4:5], fb.BWD_STATS: args[4:6],
          fb.BWD_APPLY: args[7:9]}[kern]
    return tail_path(args[0], args[1], *mn)


def phase_fused_vs_plain():
    """K4-K7 against their plain versions at ResNet-50's s1, s2 and s3
    tail shapes (bf16), at ragged shapes in f32 and bf16, relu on and off;
    two calls bit-equal; FusedTailFn's gradients vs autograd of the
    composed f32 reference. K4-K7 take their sm90 paths on every bf16
    case whose rows TMA can read (K and N multiples of 8) and their
    mma.sync paths on 37 x 5 x 7, each sm90 call counted once more under
    its own counter. Returns each kernel's max abs error at s1 (bf16)."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(200704, 128, 512, bf, True), (50176, 256, 1024, bf, True),
             (12544, 512, 2048, bf, True),
             (1000, 128, 512, f32, True), (1000, 128, 512, f32, False),
             (1000, 128, 512, bf, True), (1000, 128, 512, bf, False),
             (777, 72, 200, f32, True), (777, 72, 200, bf, False),
             (37, 5, 7, f32, True), (37, 5, 7, bf, True)]
    kernels = (fb.STATS, fb.APPLY, fb.BWD_STATS, fb.BWD_APPLY)
    main_err = {}
    expected = dict.fromkeys(
        kernels + tuple(fb.SM90_COUNTER[k] for k in kernels), 0)
    registry.reset_launches()
    for M, K, N, dtype, relu in cases:
        dname = str(dtype).split(".")[-1]
        t = tail_inputs(M, K, N, dtype)
        p = tail_plain(t, relu)
        limits = sum_limits(t, p, relu)
        path = ("fma" if dtype == f32 else "sm90"
                if K % 8 == 0 and N % 8 == 0 else "mma.sync")
        sm90 = path == "sm90"
        sum_ratio, fault_ratio = 0.0, math.inf
        with torch.no_grad():
            args = fused_args(t, p, relu)
            paths = {kern: kernel_path(kern, a) for kern, a in args.items()}
            check(set(paths.values()) == {path}, f"K4-K7 ({M},{K},{N}) "
                  f"{dname} take the paths {paths}, expected {path}")
            names = {fb.STATS: ("s1", "s2"), fb.APPLY: ("y",),
                     fb.BWD_STATS: ("a", "b"),
                     fb.BWD_APPLY: ("dx", "dW", "dshortcut")}
            errs = {}
            for kern, a in args.items():
                cuda_fn = registry.get(kern, "cuda")
                got = cuda_fn(*a)
                again = cuda_fn(*a)
                expected[kern] += 2 * fb.launches_per_call(kern, M, K, N,
                                                           sm90)
                if sm90:
                    expected[fb.SM90_COUNTER[kern]] += 2
                torch.cuda.synchronize()
                want = registry.get(kern, "cpu")(*a)
                got = got if isinstance(got, tuple) else (got,)
                again = again if isinstance(again, tuple) else (again,)
                want = want if isinstance(want, tuple) else (want,)
                for nm, g, g2, w in zip(names[kern], got, again, want):
                    check(g.dtype == w.dtype and g.shape == w.shape,
                          f"{kern} {nm}: kernel {g.dtype}{tuple(g.shape)} vs "
                          f"plain {w.dtype}{tuple(w.shape)}")
                    check(torch.isfinite(g.float()).all().item(),
                          f"{kern} {nm} not finite ({M},{K},{N}) {dname}")
                    check(torch.equal(g, g2), f"{kern} {nm}: two identical "
                          f"calls gave different bits ({M},{K},{N}) {dname}")
                    err = float((g.float() - w.float()).abs().max())
                    if nm in limits:
                        lim, fault = limits[nm]
                        check(fault > lim, f"{kern} {nm} ({M},{K},{N}) "
                              f"{dname}: a kernel that dropped its first "
                              f"m-tile would be off by {fault:.3e}, inside "
                              f"the limit {lim:.3e}")
                        sum_ratio = max(sum_ratio, err / lim)
                        fault_ratio = min(fault_ratio, fault / lim)
                    elif dtype == f32:
                        lim = FUSED_F32_TOL * float(w.float().abs().max())
                    else:
                        lim = bf16_tol(w.float())  # two ulps
                    errs[nm] = err
                    check(err <= lim, f"{kern} {nm} disagrees with the plain "
                          f"version ({M},{K},{N}) {dname} relu={relu}: max "
                          f"abs err {err:.3e} > {lim:.3e}")
                    if (M, dtype) == (200704, bf):
                        main_err[kern] = max(main_err.get(kern, 0.0), err)
        fields = {}
        if (M, K, N, dtype) == (1000, 128, 512, f32):
            gerr = fused_grads_vs_reference(t, relu)
            fields["grad_err_of_max"] = f"{gerr:.2e}"
            for kern in kernels:
                expected[kern] += fb.launches_per_call(kern, M, K, N)
        phase("kernel_vs_plain", kernel="fused_block", dtype=dname, M=M, K=K,
              N=N, relu=relu, k4_k7_path=path, deterministic=True,
              max_abs_err=json.dumps({k: float(f"{v:.3e}")
                                      for k, v in errs.items()}),
              sums_worst_err_over_limit=f"{sum_ratio:.3e}",
              sums_least_dropped_tile_over_limit=f"{fault_ratio:.3e}",
              **fields)
    launched = registry.launches()
    for kern in expected:
        check(launched.get(kern, 0) == expected[kern],
              f"{kern} launch counter read {launched.get(kern, 0)}, "
              f"expected {expected[kern]} device launches")
    return main_err


def fused_grads_vs_reference(t, relu):
    """Gradients through FusedTailFn (K4-K7) vs autograd of the composed
    f32 reference, on the card. Returns the largest error over each
    gradient's max."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    keys = ("x", "W", "gamma", "beta", "sc")
    leaves_k = {k: t[k].detach().clone().requires_grad_() for k in keys}
    y_k, _, _ = fb.conv1x1_bn_add_relu(
        leaves_k["x"], leaves_k["W"], leaves_k["gamma"], leaves_k["beta"],
        leaves_k["sc"], shift=t["shift"], eps=1e-5, relu=relu)
    fns, names = [y_k.grad_fn], set()
    for _ in range(3):
        names.update(type(f).__name__ for f in fns if f is not None)
        fns = [n for f in fns if f is not None for n, _ in f.next_functions]
    check("FusedTailFnBackward" in names,
          f"conv1x1_bn_add_relu did not route through FusedTailFn: {names}")
    w = torch.cos(torch.arange(y_k.numel(), device=y_k.device,
                               dtype=torch.float32)).reshape(y_k.shape)
    got = torch.autograd.grad((y_k * w).sum(), [leaves_k[k] for k in keys])
    leaves_p = {k: t[k].detach().clone().requires_grad_() for k in keys}
    z = leaves_p["x"] @ leaves_p["W"]
    zs = z - t["shift"]
    m1 = zs.mean(0)
    var = torch.clamp((zs * zs).mean(0) - m1 * m1, min=0.0)
    y_p = ((z - (m1 + t["shift"])) * torch.rsqrt(var + 1e-5)
           * leaves_p["gamma"] + leaves_p["beta"] + leaves_p["sc"])
    if relu:
        y_p = torch.relu(y_p)
    want = torch.autograd.grad((y_p * w).sum(), [leaves_p[k] for k in keys])
    worst = 0.0
    for name, g, wt in zip(keys, got, want):
        err = float((g - wt).abs().max()) / float(wt.abs().max())
        check(err <= FUSED_GRAD_TOL, f"FusedTailFn d{name} vs autograd of "
              f"the composed reference: {err:.3e} of max > {FUSED_GRAD_TOL}")
        worst = max(worst, err)
    return worst


def resnet_batches(n, b, seed, size=224, classes=1000):
    """``n`` synthetic batches made on the card from a seed: NHWC images
    of noise plus a per-class colour (something to learn), one-hot
    labels."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    colour = torch.randn((classes, 3), generator=gen, device="cuda")
    out = []
    for _ in range(n):
        lab = torch.randint(0, classes, (b,), generator=gen, device="cuda")
        img = torch.randn((b, size, size, 3), generator=gen, device="cuda")
        img += colour[lab][:, None, None, :]
        out.append((img, torch.nn.functional.one_hot(lab, classes).float()))
    return out


def graph_loss_and_grads(net, x, y):
    """The training loss (fused tails when the pass matched them) and its
    gradient for every parameter, by autograd of the graph's loss."""
    import torch
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    leaves = {ln: {k: t.detach().requires_grad_() for k, t in lp.items()}
              for ln, lp in net.params.items()}
    loss, _ = net._loss(leaves, net.state,
                        *net._batch(MultiDataSet([x], [y])), gen=net._gen)
    keys = [(ln, k) for ln in leaves for k in leaves[ln]]
    grads = torch.autograd.grad(loss, [leaves[ln][k] for ln, k in keys])
    return float(loss.detach()), dict(zip(keys, grads))


def graph_copy(net, device, fuse, dtype=None, opt_state=False):
    """The same configuration, weights and BN state on ``device``, with
    the fusion pass on or off; ``dtype`` ("float64") also changes the
    policy and the weights' type; ``opt_state`` also copies the optimizer
    state and the iteration."""
    import dataclasses
    import os
    import torch
    from deeplearning4j_tpu_torch import ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf.core import TORCH_DTYPES, DtypePolicy
    from deeplearning4j_tpu_torch.nn.updater import _map
    conf, cast = net.conf, None
    if dtype is not None:
        gc = dataclasses.replace(conf.global_conf, dtype=DtypePolicy(
            param_dtype=dtype, compute_dtype=dtype))
        conf = dataclasses.replace(conf, global_conf=gc)
        cast = TORCH_DTYPES[dtype]
    before = os.environ.get("DL4J_TPU_FUSE_BLOCKS")
    os.environ["DL4J_TPU_FUSE_BLOCKS"] = "1" if fuse else "0"
    try:
        cp = ComputationGraph(conf, device=device).init()
    finally:
        if before is None:
            del os.environ["DL4J_TPU_FUSE_BLOCKS"]
        else:
            os.environ["DL4J_TPU_FUSE_BLOCKS"] = before

    def copy(t):
        if not isinstance(t, torch.Tensor):
            return t
        to = cast if t.is_floating_point() else None
        return t.detach().to(device, to).clone()

    cp.params = _map(copy, net.params)
    cp.state = _map(copy, net.state)
    if opt_state:
        cp.opt_state = _map(copy, net.opt_state)
        cp.iteration = net.iteration
    return cp


def grad_errors(got, want, rel_l2=False):
    """Per gradient: max|got - want| over max|want|, or (rel_l2) the L2
    norm of the difference over want's."""
    out = {}
    for key, w in want.items():
        g = got[key].to(w.device).float()
        w = w.float()
        if rel_l2:
            n = float(w.norm())
            out[f"{key[0]}.{key[1]}"] = float((g - w).norm()) / n if n else 0.0
        else:
            top = float(w.abs().max())
            out[f"{key[0]}.{key[1]}"] = (float((g - w).abs().max()) / top
                                         if top else 0.0)
    return out


def worst(errs):
    k = max(errs, key=errs.get)
    return k, errs[k]


def resnet_profile(net, data):
    """torch.profiler over len(data) fit_batch steps: device time and
    kernels per step by kind, and the busy share of the wall time. The
    K4-K7 launches the profiler saw must equal the launch counters'."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry
    torch.cuda.synchronize()
    registry.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for ds in data:
            net.fit_batch(ds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof.key_averages())
    n = len(data)
    total = sum(e.self_device_time_total for e in kernels)
    check(total > 0, "the profiler saw no device time")
    # bwd_stats_kernel before stats_kernel, and K4's, K5's and K6's sm90
    # epilogues (BwdStatsEpi before K4's FwdStatsEpi) before the mainloop's
    # name, which the rest of K7's passes carry: the first name found wins
    fused_names = {"BwdStatsEpi": "K6", "FwdStatsEpi": "K4",
                   "ApplyEpi": "K5",
                   "bwd_stats_kernel": "K6", "stats_kernel": "K4",
                   "apply_kernel": "K5", "dz_kernel": "K7",
                   "gemm_kernel": "K7", "tma_wgmma_gemm": "K7",
                   "sum_splits": "K7",
                   "sum_partials": "K4/K6 partial sums"}
    groups, fused, seen = {}, {}, {}
    for e in kernels:
        name = e.key.lower()
        # PyTorch's multi-tensor kernels (the update's torch._foreach_*
        # ops) carry "apply_kernel" in their names too
        tag = next((v for k, v in fused_names.items()
                    if k.lower() in name and "cutlass" not in name
                    and "multi_tensor_apply" not in name), None)
        if tag is not None:
            g = "fused_K4_K7"
            seen[tag] = seen.get(tag, 0) + e.count
            ms, cnt = fused.get(tag, (0.0, 0))
            fused[tag] = (ms + e.self_device_time_total / 1e3 / n,
                          cnt + e.count // n)
        elif "multi_tensor_apply" in name:
            g = "update"
        elif any(w in name for w in ("conv", "cudnn", "implicit", "fprop",
                                     "dgrad", "wgrad", "winograd", "nhwc",
                                     "xmma", "sm90_xmma")):
            g = "cudnn_conv"
        elif any(w in name for w in ("gemm", "cutlass", "cublas")):
            g = "gemm"
        elif "reduce" in name or "norm" in name:
            g = "bn_reduce"
        elif "elementwise" in name or "vectorized" in name:
            g = "elementwise"
        elif "copy" in name or "memcpy" in name or "memset" in name:
            g = "copy"
        else:
            g = "other"
        ms, cnt = groups.get(g, (0.0, 0))
        groups[g] = (ms + e.self_device_time_total / 1e3 / n,
                     cnt + e.count // n)
    counted = registry.launches()
    pairs = {"K4 + K6 + their partial sums": (
                 seen.get("K4", 0) + seen.get("K6", 0)
                 + seen.get("K4/K6 partial sums", 0),
                 counted.get(fb.STATS, 0) + counted.get(fb.BWD_STATS, 0)),
             "K5": (seen.get("K5", 0), counted.get(fb.APPLY, 0)),
             "K7": (seen.get("K7", 0), counted.get(fb.BWD_APPLY, 0))}
    for what, (prof_n, counter_n) in pairs.items():
        check(prof_n == counter_n and prof_n > 0, f"{what}: the profiler saw "
              f"{prof_n} device launches, the counters read {counter_n}")
    return {
        "prof_by_kind_ms_and_kernels_per_step": json.dumps(
            {g: [round(ms, 3), c] for g, (ms, c) in sorted(groups.items())}),
        "prof_fused_by_kernel_ms_and_launches_per_step": json.dumps(
            {g: [round(ms, 3), c] for g, (ms, c) in sorted(fused.items())}),
        "prof_steps": n,
        "prof_wall_ms_per_step": f"{wall_ms / n:.3f}",
        "prof_device_ms_per_step": f"{total / 1e3 / n:.3f}",
        "prof_device_busy_share": f"{total / 1e3 / wall_ms:.3f}",
        "prof_kernels_per_step": sum(e.count for e in kernels) // n,
    }


def timed_steps(net, data, steps):
    """``steps`` fit_batch steps cycling through ``data``: scores, step
    ms by CUDA events, peak device memory, launches."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    scores, events = [], []
    for i in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        scores.append(net.fit_batch(data[i % len(data)]))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return {"scores": [float(s) for s in scores],
            "step_ms": [s.elapsed_time(e) for s, e in events],
            "peak_mb": torch.cuda.max_memory_allocated() / 2**20,
            "launches": registry.launches()}


def resnet_step_launches(b, sm90):
    """Device launches of K4-K7 that one ResNet-50 train step at batch
    ``b`` (224 x 224) makes: each of the 13 tails calls each kernel once;
    with ``sm90`` (BF16: every tail's rows TMA can read), each call on its
    sm90 path, also counted as such."""
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    out = {}
    for stage, M, K, N in RESNET_TAILS:
        for kern in (fb.STATS, fb.APPLY, fb.BWD_STATS, fb.BWD_APPLY):
            out[kern] = out.get(kern, 0) + RESNET_TAIL_COUNT[stage] * (
                fb.launches_per_call(kern, M * b // 256, K, N, sm90))
    if sm90:
        for counter in fb.SM90_COUNTER.values():
            out[counter] = sum(RESNET_TAIL_COUNT.values())
    return out


def capture_tail_inputs(fn):
    """Runs ``fn()`` with spies on K4-K7's CUDA wrappers that keep a copy
    of every call's inputs (a tail's K4 and K5 share x and W, its K6 and
    K7 x, W, dy and y: each copied once): returns [(k4_args, k5_args,
    k6_args, k7_args)], one a fused tail, in the forward's order. The
    backward meets the tails in the reverse order; each tail's K6 must
    see the x its K4 saw."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry
    kerns = (fb.STATS, fb.APPLY, fb.BWD_STATS, fb.BWD_APPLY)
    real = {k: registry.get(k, "cuda") for k in kerns}
    copies, calls = {}, {k: [] for k in kerns}

    def keep(a):
        if not torch.is_tensor(a):
            return a
        key = (a.data_ptr(), tuple(a.shape), a.dtype)
        if key not in copies:
            copies[key] = a.detach().clone()
        return copies[key]

    def spy(kern):
        def wrapper(*args):
            calls[kern].append(tuple(keep(a) for a in args))
            # K5 and K7 are a tail's last call of its pass: its memory may
            # be reused by the next tail
            if kern in (fb.APPLY, fb.BWD_APPLY):
                copies.clear()
            return real[kern](*args)
        return wrapper

    try:
        for kern in real:
            registry.register(kern, "cuda")(spy(kern))
        fn()
        torch.cuda.synchronize()
    finally:
        for kern, f in real.items():
            registry.register(kern, "cuda")(f)
    n = {kern: len(c) for kern, c in calls.items()}
    check(len(set(n.values())) == 1, f"K4-K7 ran unequal numbers of times: "
          f"{n}")
    tails = list(zip(calls[fb.STATS], calls[fb.APPLY],
                     reversed(calls[fb.BWD_STATS]),
                     reversed(calls[fb.BWD_APPLY])))
    for i, (a4, _, a6, _) in enumerate(tails):
        check(torch.equal(a4[0], a6[0]), f"tail {i}: K6's x is not K4's")
    return tails


def hold_tail_on_its_inputs(a4, a5, a6, a7):
    """K4-K7 on one tail's inputs captured from the main path, against
    their plain versions on the card at fused_vs_plain's limits (the sums
    over M by sum_limits, which also shows that a dropped m-tile or dW
    split would fail; y, dx and dshortcut two bf16 ulps at their max).
    Returns (the tail's path, or each kernel's where they differ, the
    worst error over its limit, a message for each output that
    failed)."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry
    x, W, mean, inv, dy, y, relu = a6
    scale, ca, cb = a7[4:7]
    M = x.shape[0]
    t = dict(x=x, W=W, dy=dy, shift=a4[2])
    p = dict(y=y, mean=mean, inv=inv, scale=scale, ca=ca, cb=cb)
    limits = sum_limits(t, p, relu)
    worst_ratio, failed = 0.0, []
    pairs = ((fb.STATS, a4, ("s1", "s2")), (fb.APPLY, a5, ("y",)),
             (fb.BWD_STATS, a6, ("a", "b")),
             (fb.BWD_APPLY, a7, ("dx", "dW", "dshortcut")))
    with torch.no_grad():
        for kern, args, names in pairs:
            got = registry.get(kern, "cuda")(*args)
            want = registry.get(kern, "cpu")(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for nm, g, w in zip(names, got, want):
                err = float((g.float() - w.float()).abs().max())
                if nm in limits:
                    lim, fault = limits[nm]
                    if not fault > lim:
                        failed.append(f"tail M={M} {kern} {nm}: a dropped "
                                      f"m-tile would be off by {fault:.3e}, "
                                      f"inside the limit {lim:.3e}")
                else:
                    lim = bf16_tol(w.float())
                if not (torch.isfinite(g.float()).all().item()
                        and err <= lim):
                    failed.append(f"tail M={M} K={x.shape[1]} "
                                  f"N={W.shape[1]}: {kern} {nm} on the main "
                                  f"path's inputs disagrees with the plain "
                                  f"version: {err:.3e} > {lim:.3e}")
                worst_ratio = max(worst_ratio, err / lim if lim else 0.0)
    paths = {kernel_path(kern, args) for kern, args, _ in pairs}
    return "/".join(sorted(paths)), worst_ratio, failed


def block_worst(errs):
    """The largest error of each block's gradients ("stem", "s0b0", ...,
    "fc"), in the graph's order."""
    out = {}
    for key, v in errs.items():
        blk = key.split(".")[0].split("_")[0]
        out[blk] = max(out.get(blk, 0.0), v)
    return out


def phase_train_resnet():
    """zoo.resnet50 at full width, BF16, Nesterovs(0.1, 0.9), with the
    block-fusion pass on (DL4J_TPU_FUSE_BLOCKS=1): the first step on the
    card (fused and unfused) and on the plain CPU path against the f64
    plain CPU path (F32 and BF16, b = 8), fused vs unfused on the card at
    b = 256, each fused tail's K4-K7 held against their plain versions on
    the inputs that step gave them, 20 timed steps each way at b = 256,
    224 x 224, the launches of K4-K7 (13 calls each per step, every call
    on its sm90 path; 26, 13, 26 and 52 device launches at b = 256), a
    profile, and one eval forward vs the CPU path."""
    import os
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.updater import (
        _map, apply_layer_updates, apply_layer_updates_plain)
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry
    kernels = (fb.STATS, fb.APPLY, fb.BWD_STATS, fb.BWD_APPLY)
    b, steps, tails = 256, 20, 13
    os.environ["DL4J_TPU_FUSE_BLOCKS"] = "1"
    net = zoo.resnet50(seed=SEED + 20)
    check(len(net._fusion_plans) == tails,
          f"resnet50 matched {len(net._fusion_plans)} tails, expected {tails}")
    pol = net.conf.global_conf.dtype
    check(pol.compute_dtype == "bfloat16" and pol.param_dtype == "float32",
          f"resnet50 policy {pol}")
    upd = net.layers[0].resolve("updater")
    check(upd.kind == "nesterovs" and upd.learning_rate == 0.1
          and upd.momentum == 0.9, f"resnet50 updater {upd}")
    batches = resnet_batches(2, b, SEED + 21)
    x0, y0 = batches[0]
    out = {"model": "resnet50(classes=1000,224x224,BF16,Nesterovs(0.1,0.9),"
                    "DL4J_TPU_FUSE_BLOCKS=1)", "b": b,
           "params": net.num_params(), "fused_tails": len(net._fusion_plans)}

    # the first step on the card, fused and unfused, and on the plain CPU
    # path, against the f64 plain CPU path, same weights and batch
    t0 = time.perf_counter()
    nb = 8
    xs, ys = x0[:nb], y0[:nb]
    ref_net = graph_copy(net, "cpu", False, dtype="float64")
    ref_loss, ref_g = graph_loss_and_grads(ref_net, xs.cpu().double(),
                                           ys.cpu().double())
    del ref_net
    f32 = zoo.resnet50(seed=SEED + 20, dtype=zoo.F32)
    for name, card_net in (("bf16", net), ("f32", f32)):
        registry.reset_launches()
        card_loss, card_g = graph_loss_and_grads(card_net, xs, ys)
        want_launches = resnet_step_launches(nb, name == "bf16")
        check(registry.launches() == want_launches,
              f"the card's {name} step launched {registry.launches()}, "
              f"expected {want_launches}")
        un_loss, un_g = graph_loss_and_grads(
            graph_copy(card_net, "cuda", False), xs, ys)
        cpu_loss, cpu_g = graph_loss_and_grads(
            graph_copy(card_net, "cpu", True), xs.cpu(), ys.cpu())
        errs = {path: worst(grad_errors(g, ref_g, rel_l2=True))
                for path, g in (("card_fused", card_g), ("card_unfused", un_g),
                                ("cpu_fused", cpu_g))}
        direct_all = grad_errors(card_g, cpu_g, rel_l2=True)
        direct = worst(direct_all)
        slim = (RESNET_F32_SCORE_RTOL if name == "f32"
                else RESNET_BF16_SCORE_RTOL)
        score_errs = {"card_vs_cpu": abs(card_loss - cpu_loss) / abs(cpu_loss),
                      "fused_vs_unfused": abs(card_loss - un_loss)
                      / abs(un_loss)}
        print(f"  resnet50 first step ({name}, b={nb}): scores card fused "
              f"{card_loss:.6f}, card unfused {un_loss:.6f}, CPU "
              f"{cpu_loss:.6f}, f64 CPU {ref_loss:.6f}; worst gradient L2 "
              f"error vs f64: " + json.dumps(
                  {k: f"{v[0]}:{v[1]:.3e}" for k, v in errs.items()})
              + f"; card vs CPU {direct[0]}:{direct[1]:.3e}", flush=True)
        for k, v in score_errs.items():
            out[f"first_step_{name}_score_{k}_rel"] = f"{v:.3e}"
            check(v <= slim, f"first step {name} score {k}: {v:.3e} > {slim}")
        for k, v in errs.items():
            out[f"first_step_{name}_grad_l2_vs_f64_{k}"] = f"{v[1]:.3e}"
        out[f"first_step_{name}_grad_l2_card_vs_cpu"] = f"{direct[1]:.3e}"
        if name == "bf16":
            out["first_step_bf16_grad_l2_card_vs_cpu_by_block"] = json.dumps(
                {k: float(f"{v:.3e}")
                 for k, v in block_worst(direct_all).items()})
            out["first_step_bf16_grad_l2_card_vs_cpu_head"] = json.dumps(
                {k: float(f"{direct_all[k]:.3e}") for k in RESNET_BF16_HEAD})
            for k in RESNET_BF16_HEAD:
                check(direct_all[k] <= RESNET_BF16_HEAD_GRAD_L2,
                      f"first step bf16: {k} card vs CPU "
                      f"{direct_all[k]:.3e} (L2) > {RESNET_BF16_HEAD_GRAD_L2}")
        else:
            for other in ("cpu_fused", "card_unfused"):
                lim = RESNET_ACCURACY_RATIO * errs[other][1] + 1e-3
                check(errs["card_fused"][1] <= lim,
                      f"first step f32: the card's fused gradients are "
                      f"{errs['card_fused'][1]:.3e} (L2) from f64, more than "
                      f"{RESNET_ACCURACY_RATIO} x {other}'s "
                      f"{errs[other][1]:.3e}")
            check(direct[1] <= RESNET_F32_GRAD_L2, f"F32 gradient "
                  f"{direct[0]} card vs CPU: L2 {direct[1]:.3e} > "
                  f"{RESNET_F32_GRAD_L2}")
    del f32, card_g, un_g, cpu_g, ref_g
    out["first_step_checks_s"] = f"{time.perf_counter() - t0:.1f}"

    # fused vs unfused on the card at the run's batch, BF16; the fused
    # step's K4-K7 inputs, tail by tail, are kept and each tail's K4-K7
    # are held against their plain versions on them
    unfused = graph_copy(net, "cuda", False)
    check(not unfused._fusion_plans, "the unfused copy matched tails")
    step = {}
    tails_in = capture_tail_inputs(
        lambda: step.update(zip(("loss", "g"),
                                graph_loss_and_grads(net, x0, y0))))
    f_loss, f_g = step["loss"], step["g"]
    check(len(tails_in) == tails, f"captured {len(tails_in)} tails' K4-K7 "
          f"inputs, expected {tails}")
    held = [hold_tail_on_its_inputs(*a) for a in tails_in]
    failed = [m for _, _, msgs in held for m in msgs]
    check(not failed, "; ".join(failed))
    paths = [path for path, _, _ in held]
    check(paths == ["sm90"] * tails, f"K4-K7's paths on the main path's "
          f"tails: {paths}")
    out["tails_k4_k7_vs_plain_worst_err_over_limit"] = (
        f"{max(r for _, r, _ in held):.3e}")
    out["tails_k4_k7_vs_plain_by_tail"] = json.dumps(
        [float(f"{r:.3e}") for _, r, _ in held])
    del tails_in, held
    torch.cuda.empty_cache()
    u_loss, u_g = graph_loss_and_grads(unfused, x0, y0)
    score_err = abs(f_loss - u_loss) / abs(u_loss)
    k, e = worst(grad_errors(f_g, u_g, rel_l2=True))
    print(f"  resnet50 fused vs unfused (bf16, b={b}): score {f_loss:.6f} "
          f"vs {u_loss:.6f}; worst gradient L2 distance {k} {e:.3e}",
          flush=True)
    out["fused_vs_unfused_b256_score_rel"] = f"{score_err:.3e}"
    out["fused_vs_unfused_b256_worst_grad_l2"] = f"{k}:{e:.3e}"
    check(score_err <= RESNET_BF16_SCORE_RTOL, f"fused vs unfused score "
          f"(bf16, b={b}) {score_err:.3e} > {RESNET_BF16_SCORE_RTOL}")
    del f_g, u_g
    torch.cuda.empty_cache()

    # 20 steps each way from the same weights on the same two batches
    data = [DataSet(x, y) for x, y in batches]
    runs = {"fused": timed_steps(net, data, steps)}
    runs["unfused"] = timed_steps(unfused, data, steps)
    per_step = resnet_step_launches(b, True)
    for kern in kernels + tuple(fb.SM90_COUNTER[k] for k in kernels):
        got = runs["fused"]["launches"].get(kern, 0)
        check(got == per_step[kern] * steps, f"{kern} launched {got} times "
              f"in {steps} fused steps, expected {per_step[kern] * steps}")
        check(runs["unfused"]["launches"].get(kern, 0) == 0,
              f"{kern} launched in the unfused run")
    for name, r in runs.items():
        sc = r["scores"]
        check(all(math.isfinite(v) for v in sc), f"{name} scores {sc}")
        last5 = statistics.mean(sc[-5:])
        check(last5 < sc[0], f"{name} training did not lower the score: "
              f"first {sc[0]:.4f}, mean of last 5 {last5:.4f}")
        med = statistics.median(r["step_ms"][-10:])
        out[f"{name}_step_ms_median_last10"] = f"{med:.3f}"
        out[f"{name}_step_ms_min_max_last10"] = (
            f"{min(r['step_ms'][-10:]):.3f}/{max(r['step_ms'][-10:]):.3f}")
        out[f"{name}_images_per_s"] = f"{b / med * 1e3:.1f}"
        out[f"{name}_peak_mem_mb"] = f"{r['peak_mb']:.0f}"
        out[f"{name}_scores"] = json.dumps([round(v, 4) for v in sc])
    out["launches_fused_run"] = json.dumps(runs["fused"]["launches"])
    out["device_launches_per_step"] = json.dumps(
        {k: runs["fused"]["launches"].get(k, 0) // steps for k in kernels})
    out["calls_per_step"] = json.dumps(
        {k: runs["fused"]["launches"].get(k, 0) * tails // per_step[k] // steps
         for k in kernels})
    out["sm90_calls_per_step"] = json.dumps(
        {k: runs["fused"]["launches"].get(fb.SM90_COUNTER[k], 0) // steps
         for k in kernels})

    # the Nesterov update alone, on copies: the multi-tensor path (what
    # the step runs) and the per-tensor path it replaced, reading the
    # iteration from the card as the step does; the update's device time
    # a step is the profile's "update" kind below
    gc = net.conf.global_conf
    params = _map(lambda t: t.detach().clone(), net.params)
    opt = _map(lambda t: t.detach().clone(), net.opt_state)
    grads = _map(lambda t: torch.full_like(t, 1e-3), params)
    it = torch.zeros((), dtype=torch.int32, device="cuda")
    with torch.no_grad():
        upd_ms = cuda_ms(lambda: apply_layer_updates(
            net.layers, gc, params, grads, opt, it), reps=5)
        plain_ms = cuda_ms(lambda: apply_layer_updates_plain(
            net.layers, gc, params, grads, opt, it), reps=5)
    out["nesterov_update_ms"] = f"{upd_ms:.3f}"
    out["nesterov_update_plain_ms"] = f"{plain_ms:.3f}"
    del params, opt, grads
    out.update(resnet_profile(net, data[:1] * 3))

    # one eval forward (unfused walk, running statistics) vs the CPU path
    xe = batches[1][0][:32]
    card_p = net.output(xe).float().cpu()
    cpu_p = graph_copy(net, "cpu", True).output(xe.cpu()).float()
    check(torch.isfinite(card_p).all().item() and card_p.shape == (32, 1000),
          f"eval output {tuple(card_p.shape)} not finite")
    tiny = torch.finfo(torch.float32).tiny
    lp_err = float((card_p.clamp_min(tiny).log()
                    - cpu_p.clamp_min(tiny).log()).abs().max())
    d = (card_p - cpu_p).abs()
    out["eval_b32_prob_vs_cpu"] = f"{float(d.max()):.3e}"
    row_err = float((d.amax(1) / cpu_p.amax(1)).max())
    out["eval_b32_prob_vs_cpu_over_row_max"] = f"{row_err:.3e}"
    out["eval_b32_row_max_prob_mean"] = f"{float(cpu_p.amax(1).mean()):.3e}"
    out["eval_b32_logprob_vs_cpu"] = f"{lp_err:.3e}"
    check(row_err <= RESNET_ROW_PROB_TOL, f"eval probabilities card vs CPU: "
          f"{row_err:.3e} of a row's largest > {RESNET_ROW_PROB_TOL}")
    phase("train_resnet", **out)
    return {"launches": runs["fused"]["launches"],
            "step_ms": float(out["fused_step_ms_median_last10"]),
            "unfused_step_ms": float(out["unfused_step_ms_median_last10"])}


def fused_bound(kern, M, K, N):
    """(flops, bytes) the function needs at bf16: each input read once,
    each output written once."""
    e, v = 2, 4 * N
    mk, kn, mn = M * K * e, K * N * e, M * N * e
    gemm = 2.0 * M * K * N
    if kern == "fused_block_stats":
        return gemm, mk + kn + v + 2 * v
    if kern == "fused_block_apply":
        return gemm, mk + kn + 2 * v + mn + mn
    if kern == "fused_block_bwd_stats":
        return gemm, mk + kn + 2 * v + 2 * mn + 2 * v
    return 3 * gemm, mk + kn + 5 * v + 2 * mn + mk + K * N * 4 + mn


# K7's passes by kernel name, for the profiler's split: the sm90 path's
# epilogues, and the mma.sync path's dz_kernel and gemm_kernel
# instantiations (dx = <T, true, false, T>, dW = <T, false, true, float>);
# the first match wins
K7_PASSES = (("dz", ("DzEpi", "dz_kernel")), ("dx", ("DxEpi", "true, false")),
             ("dW", ("DwEpi", "false, true")), ("sum", ("sum_splits",)))
# K6's launches: the GEMM with its column sums (sm90: the BwdStatsEpi
# epilogue; mma.sync: bwd_stats_kernel) and the sum of its partials
K6_PASSES = (("gemm", ("BwdStatsEpi", "bwd_stats_kernel")),
             ("sum", ("sum_partials",)))
# K4's launches: the tiles' pass with its column sums (FwdStatsEpi,
# stats_kernel) and the same sum; K5's one launch (ApplyEpi, apply_kernel)
K4_PASSES = (("tiles", ("FwdStatsEpi", "stats_kernel")),
             ("sum", ("sum_partials",)))
K5_PASSES = (("apply", ("ApplyEpi", "apply_kernel")),)


class Split(dict):
    """Device ms a call by pass, and ``kept``: the fewest launches of any
    one kernel that the profiler kept of the ``reps`` it was asked to
    time."""
    kept = 0


def pass_split(fn, passes=K7_PASSES, reps=10):
    """A kernel's device ms a call by pass (K7: dz, dx, dW, sum of the dW
    splits; K6: gemm, sum) over ``reps`` calls of ``fn``, from
    torch.profiler, with the kernels it could not place under "other".
    Each kernel of K4-K7 launches once a call, so a pass's time is the
    mean over the launches the profiler kept: a sum over ``reps`` would
    read short if it kept fewer (``kept`` says how many it did)."""
    out = Split({name: 0.0 for name, _ in passes})
    out["other"] = 0.0
    out.kept = reps
    for e in device_events(fn, reps):
        tag = next((name for name, keys in passes
                    if any(k in e.key for k in keys)), "other")
        out[tag] += e.self_device_time_total / 1e3 / e.count
        out.kept = min(out.kept, e.count)
    return out


def k4_mma_sync(x, W, shift):
    """A call of K4's first bf16 path (mma.sync, dl4j_fused_stats) on the
    same inputs, for timing it beside the sm90 path in the same run:
    returns a function that launches it into preallocated outputs."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    lib = fb._bind()
    M, K = x.shape
    N = W.shape[1]
    R = fb.stat_rows(M, N)
    part = torch.empty((2, R, N), dtype=torch.float32, device=x.device)
    out = torch.empty((2, N), dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t in (x, W, shift, part, out)]

    def call():
        rc = lib.dl4j_fused_stats(1, *ptrs, M, K, N, R,
                                  torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"mma.sync K4 failed: cudaError {rc}")
    return call


def k5_mma_sync(x, W, scale, sh, sc, relu):
    """A call of K5's first bf16 path (mma.sync, dl4j_fused_apply) on the
    same inputs, for timing it beside the sm90 path in the same run:
    returns a function that launches it into a preallocated y and returns
    y."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    lib = fb._bind()
    M, K = x.shape
    N = W.shape[1]
    y = torch.empty_like(sc)
    ptrs = [t.data_ptr() for t in (x, W, scale, sh, sc, y)]

    def call():
        rc = lib.dl4j_fused_apply(1, *ptrs, M, K, N, int(relu),
                                  torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"mma.sync K5 failed: cudaError {rc}")
        return y
    return call


def k6_mma_sync(x, W, mean, inv, dy, y, relu):
    """A call of K6's first bf16 path (mma.sync, dl4j_fused_bwd_stats) on
    the same inputs, for timing it beside the sm90 path in the same run:
    returns a function that launches it into preallocated outputs."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    lib = fb._bind()
    M, K = x.shape
    N = W.shape[1]
    R = fb.stat_rows(M, N)
    part = torch.empty((2, R, N), dtype=torch.float32, device=x.device)
    out = torch.empty((2, N), dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t in (x, W, mean, inv, dy, y, part, out)]

    def call():
        rc = lib.dl4j_fused_bwd_stats(
            1, *ptrs, M, K, N, R, int(relu),
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"mma.sync K6 failed: cudaError {rc}")
    return call


def k7_mma_sync(x, W, mean, inv, scale, ca, cb, dy, y, relu):
    """A call of K7's first bf16 path (mma.sync, dl4j_fused_bwd_apply) on
    the same inputs, for timing it beside the sm90 path in the same run:
    returns a function that launches it into preallocated outputs."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    lib = fb._bind()
    M, K = x.shape
    N = W.shape[1]
    S, chunk = fb.dw_splits(M, K, N)
    dz, dsc = torch.empty_like(dy), torch.empty_like(dy)
    dx = torch.empty_like(x)
    dW = torch.empty((K, N), dtype=torch.float32, device=x.device)
    part = torch.empty((S, K, N), dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t in (x, W, mean, inv, scale, ca, cb, dy, y, dz,
                                   dsc, dx, part, dW)]

    def call():
        rc = lib.dl4j_fused_bwd_apply(
            1, *ptrs, M, K, N, S, chunk, int(relu),
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"mma.sync K7 failed: cudaError {rc}")
    return call


def mma_sync_and_passes(kern):
    """Kernel ``kern``'s mma.sync caller (k4_mma_sync ... k7_mma_sync) and
    its launches by name for pass_split."""
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    return {fb.STATS: (k4_mma_sync, K4_PASSES),
            fb.APPLY: (k5_mma_sync, K5_PASSES),
            fb.BWD_STATS: (k6_mma_sync, K6_PASSES),
            fb.BWD_APPLY: (k7_mma_sync, K7_PASSES)}[kern]


def z_bits(t):
    """K5 with scale 1, sh 0, a zero shortcut and no relu gives y =
    round_cd(z) itself: on the sm90 path and on the mma.sync path, on the
    same x and W. Returns the elements of z, how many the two paths round
    differently (so many elements of z K4 and K5 saw otherwise than K6
    and K7 before K4 and K5 moved to the sm90 mainloop), and how many
    each path gives otherwise than torch.matmul's f32 product rounded to
    bf16."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry
    x, W = t["x"], t["W"]
    N = W.shape[1]
    a = (x, W, torch.ones(N, device=x.device),
         torch.zeros(N, device=x.device), torch.zeros_like(t["sc"]), False)
    check(kernel_path(fb.APPLY, a) == "sm90", "z_bits: K5 not on sm90")
    with torch.no_grad():
        z_sm90 = registry.get(fb.APPLY, "cuda")(*a)
        z_mma = k5_mma_sync(*a)()
        z_f32 = fb._z(x, W).to(torch.bfloat16)
        torch.cuda.synchronize()
        return {"elements": z_f32.numel(),
                "mma_sync_vs_sm90": int((z_mma != z_sm90).sum()),
                "sm90_vs_matmul": int((z_sm90 != z_f32).sum()),
                "mma_sync_vs_matmul": int((z_mma != z_f32).sum())}


def phase_times_fused(card, errs, rtrain):
    """K4-K7 at each ResNet-50 stage shape (bf16): 20 launches back to
    back, the plain version, the bound, and torch.matmul of the same
    [M, K] x [K, N] product as a yardstick (no single PyTorch call
    computes these functions). Each (on its sm90 path) also beside its
    mma.sync path on the same inputs, both with their device time and
    split by launch from the profiler; how many elements of z the two
    paths round differently (z_bits)."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry
    rows = {}

    def by_stage(kern, key):
        return {st: rows[(kern, st)][key] for st, _, _, _ in RESNET_TAILS}

    for stage, M, K, N in RESNET_TAILS:
        t = tail_inputs(M, K, N, torch.bfloat16, seed=1)
        p = tail_plain(t, True)
        args = fused_args(t, p, True)
        with torch.no_grad():
            gemm_ms = cuda_ms_per_launch(
                lambda: torch.matmul(t["x"], t["W"]), reps=5)
            for kern, a in args.items():
                cuda_fn = registry.get(kern, "cuda")
                plain_fn = registry.get(kern, "cpu")
                ms = cuda_ms_per_launch(lambda: cuda_fn(*a), reps=5)
                plain_ms = cuda_ms_per_launch(lambda: plain_fn(*a), reps=3,
                                              inner=5)
                flops, nbytes = fused_bound(kern, M, K, N)
                bound_ms, bound_by = bound(flops, nbytes, "bfloat16")
                gemms = 3 if kern == fb.BWD_APPLY else 1
                mma_sync, passes = mma_sync_and_passes(kern)
                old = mma_sync(*a)
                old_ms = cuda_ms_per_launch(old, reps=5)
                split = pass_split(lambda: cuda_fn(*a), passes)
                old_split = pass_split(old, passes)
                device_ms = sum(split.values())
                rows[(kern, stage)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, mma_sync_ms=old_ms, split_ms=split,
                    device_ms=device_ms, path=kernel_path(kern, a))
                check(rows[(kern, stage)]["path"] == "sm90",
                      f"{kern} at {stage} took the "
                      f"{rows[(kern, stage)]['path']} path")
                phase("times", kernel=kern, stage=stage, M=M, K=K, N=N,
                      dtype="bfloat16", card=json.dumps(card),
                      path=rows[(kern, stage)]["path"],
                      ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                      bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
                      flops=f"{flops:.4g}", bytes=f"{nbytes:.4g}",
                      roofline_share=f"{bound_ms / ms:.4f}",
                      device_ms=f"{device_ms:.4f}",
                      device_roofline_share=f"{bound_ms / device_ms:.4f}",
                      tflops=f"{flops / ms / 1e9:.2f}",
                      library="none (no single PyTorch call computes it); "
                              "yardstick torch.matmul of the same product",
                      matmul_ms=f"{gemm_ms:.4f}",
                      matmul_ms_times_products=f"{gemm_ms * gemms:.4f}",
                      split_ms=json.dumps(
                          {k: round(v, 4) for k, v in split.items()}),
                      profiler_kept=f"{split.kept}/{old_split.kept}/10",
                      mma_sync_ms=f"{old_ms:.4f}",
                      mma_sync_device_ms=f"{sum(old_split.values()):.4f}",
                      mma_sync_split_ms=json.dumps(
                          {k: round(v, 4) for k, v in old_split.items()}),
                      mma_sync_roofline_share=f"{bound_ms / old_ms:.4f}")
            phase("times", kernel="z_bits", stage=stage, M=M, K=K, N=N,
                  **z_bits(t))
        del t, p, args
        torch.cuda.empty_cache()
    phase("times", kernel="resnet50_train_step", b=256,
          fused_step_ms=f"{rtrain['step_ms']:.3f}",
          unfused_step_ms=f"{rtrain['unfused_step_ms']:.3f}")
    source = "deeplearning4j_tpu_torch/ops/csrc/fused_block.cu"
    lines = {fb.STATS: 135, fb.APPLY: 156, fb.BWD_STATS: 165,
             fb.BWD_APPLY: 193}
    out = []
    for kern, line in lines.items():
        r = rows[(kern, "s1")]
        out.append({"name": kern, "route": "cuda", "source": source,
                    "replaces":
                        f"deeplearning4j_tpu/ops/fused_block.py:{line}",
                    "launches": rtrain["launches"].get(kern, 0),
                    "max_abs_err": errs[kern], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": None,
                    "shape": "s1 (M=200704, K=128, N=512, bf16)",
                    "path": "sm90: TMA ring feeding wgmma "
                            "(csrc/sm90_gemm.cuh)",
                    "calls_on_sm90_path": rtrain["launches"].get(
                        fb.SM90_COUNTER[kern], 0),
                    "by_stage_ms": by_stage(kern, "ms"),
                    "by_stage_device_ms": by_stage(kern, "device_ms"),
                    "by_stage_split_ms": by_stage(kern, "split_ms"),
                    "by_stage_mma_sync_ms": by_stage(kern, "mma_sync_ms")})
    return out


def phase_tail_check():
    """[train_resnet]'s check of every fused tail's K4-K7 on the
    inputs one BF16 step at b = 256 gives them, alone (``python3
    chip_smoke.py --tail-check``): each tail's path and worst error over
    its limit, and a failure if any output misses its limit. Run from a
    copy of the checkout with a planted fault in a kernel, it shows that
    the check catches it."""
    import os
    from deeplearning4j_tpu_torch import zoo
    os.environ["DL4J_TPU_FUSE_BLOCKS"] = "1"
    net = zoo.resnet50(seed=SEED + 20)
    x0, y0 = resnet_batches(2, 256, SEED + 21)[0]
    tails_in = capture_tail_inputs(lambda: graph_loss_and_grads(net, x0, y0))
    failed = []
    for i, args in enumerate(tails_in):
        path, ratio, msgs = hold_tail_on_its_inputs(*args)
        M, K = args[0][0].shape
        phase("tail_check", tail=i, M=M, K=K, N=args[0][1].shape[1],
              k4_k7_path=path,
              worst_err_over_limit=f"{ratio:.3e}", failed=len(msgs))
        failed += msgs
    check(len(tails_in) == 13, f"captured {len(tails_in)} tails, expected 13")
    check(not failed, "; ".join(failed))


def phase_split(kern):
    """K7 (or K6) alone at ResNet-50's three tail shapes (bf16, relu): ms a
    call over 20 back-to-back launches and the profiler's split by pass,
    for whatever kernel the package beside this script has; for K6 also
    its mma.sync path and K4 (whose partials the same kernel sums) in the
    same run. ``python3 chip_smoke.py --k7-split`` (``--k6-split``) runs
    only this; run from a checkout of another commit it measures that
    commit's kernel with the same code."""
    import torch
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry
    _build.build(("fused_block",))
    k6 = kern == fb.BWD_STATS
    fn = registry.get(kern, "cuda")
    passes = K6_PASSES if k6 else K7_PASSES
    for stage, M, K, N in RESNET_TAILS:
        t = tail_inputs(M, K, N, torch.bfloat16, seed=1)
        p = tail_plain(t, True)
        a = fused_args(t, p, True)[kern]
        path = (tail_path(t["x"], t["W"], t["dy"], p["y"])
                if hasattr(fb, "takes_sm90") else "mma.sync")
        if k6 and not hasattr(fb, "BWD_STATS_SM90"):
            path = "mma.sync"
        extra = {}
        with torch.no_grad():
            ms = cuda_ms_per_launch(lambda: fn(*a), reps=5)
            split = pass_split(lambda: fn(*a), passes)
            if k6:
                old = k6_mma_sync(*a)
                k4 = registry.get(fb.STATS, "cuda")
                a4 = fused_args(t, p, True)[fb.STATS]
                extra = dict(
                    mma_sync_ms=f"{cuda_ms_per_launch(old, reps=5):.4f}",
                    mma_sync_split_ms=json.dumps(
                        {k: round(v, 4)
                         for k, v in pass_split(old, passes).items()}),
                    k4_ms=f"{cuda_ms_per_launch(lambda: k4(*a4), reps=5):.4f}",
                    k4_split_ms=json.dumps(
                        {k: round(v, 4) for k, v in pass_split(
                            lambda: k4(*a4), K4_PASSES).items()}))
        phase("k6_split" if k6 else "k7_split", stage=stage, M=M, K=K, N=N,
              path=path, ms=f"{ms:.4f}",
              split_ms=json.dumps({k: round(v, 4) for k, v in split.items()}),
              **extra)
        del t, p, a
        torch.cuda.empty_cache()


def phase_fwd_split():
    """K4 and K5 alone at ResNet-50's three tail shapes (bf16, relu), each
    on its mma.sync path (before) and its sm90 path (after), ms a call over
    20 back-to-back launches in the order before, after, after, before,
    and the profiler's split by launch of each path. ``python3
    chip_smoke.py --fwd-split`` runs only this."""
    import torch
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry
    _build.build(("fused_block",))
    for stage, M, K, N in RESNET_TAILS:
        t = tail_inputs(M, K, N, torch.bfloat16, seed=1)
        p = tail_plain(t, True)
        args = fused_args(t, p, True)
        for kern in (fb.STATS, fb.APPLY):
            a = args[kern]
            fn = registry.get(kern, "cuda")
            mma_sync, passes = mma_sync_and_passes(kern)
            old = mma_sync(*a)
            with torch.no_grad():
                ms = [cuda_ms_per_launch(f, reps=5)
                      for f in (old, lambda: fn(*a), lambda: fn(*a), old)]
                split = pass_split(lambda: fn(*a), passes)
                old_split = pass_split(old, passes)
            bound_ms, bound_by = bound(*fused_bound(kern, M, K, N),
                                       "bfloat16")
            phase("fwd_split", kernel=kern, stage=stage, M=M, K=K, N=N,
                  path=kernel_path(kern, a),
                  mma_sync_ms=json.dumps([round(ms[0], 4), round(ms[3], 4)]),
                  sm90_ms=json.dumps([round(ms[1], 4), round(ms[2], 4)]),
                  split_ms=json.dumps(
                      {k: round(v, 4) for k, v in split.items()}),
                  mma_sync_split_ms=json.dumps(
                      {k: round(v, 4) for k, v in old_split.items()}),
                  profiler_kept=f"{split.kept}/{old_split.kept}/10",
                  bound_ms=f"{bound_ms:.5f}", bound_by=bound_by)
        del t, p, args
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# The MultiLayerNetwork conv path, evaluation, listeners and early stopping:
# LeNet, VGG-16, ResNet-18. No kernel of the port is on these paths (their
# convolutions and products go to cuDNN and cuBLAS, as the JAX package
# leaves them to XLA); each phase checks that K1-K7 were not launched.
# --------------------------------------------------------------------------

# LeNet's F32 first step (b = 64), card and plain CPU path, each against an
# f64 CPU run of the same step: a relu/max-pool net's gradients are
# discontinuous (ROADMAP.md C.4), so the card's must be as accurate as the
# CPU's f32 gradients, to within CONV_ACCURACY_RATIO plus 1e-3, in each
# gradient's L2 error relative to its norm (worst gradient); the scores
# card vs CPU to CONV_F32_SCORE_RTOL. The same holds ResNet-18's F32 step,
# the form tests/test_torch_graph.py states for it on the card.
CONV_ACCURACY_RATIO = 2.0
CONV_F32_SCORE_RTOL = 1e-5
# LeNet's held-out accuracy after early stopping (10 classes: chance 0.1)
LENET_MIN_ACCURACY = 0.9
# F32 evaluate, card vs CPU on the same weights: rows whose CPU top-two
# probability gap is below LENET_TIE_GAP may take either class on either
# side and are left out (their count is printed); every other row must
# land in the same cell of the confusion matrix
LENET_TIE_GAP = 1e-5
# VGG-16's BF16 steps: at the zoo's Nesterovs(0.01, 0.9) the score of this
# xavier-initialised net (no batch norm) on mean-subtracted 0-255 images
# diverges within 12 steps (NVIDIA H100 80GB HBM3, b = 32: 6.94, 6.88,
# 6.17, 24.9, 12.2, 6.0, 3519, 7.5e12, then NaN), and the JAX package's
# F32 steps diverge alike on the CPU at 64 x 64 with 1000 classes
# (tests/test_torch_mln_vgg.py), so the phase trains at VGG_LR with the
# same momentum
VGG_LR = 1e-3
# VGG-16's F32 forward at b = 2, card vs CPU: each row's largest
# probability error at most VGG_ROW_PROB_TOL of the row's largest
# probability (the same f32 arithmetic, sums in another order; TF32 off
# for the convolutions and the dense products alike)
VGG_ROW_PROB_TOL = 1e-3
# ResNet-18's F32 eval-mode forward on its trained weights and BN state,
# card vs CPU: the same limit as VGG-16's F32 forward (in eval mode BN is
# an affine map of the running statistics; no batch statistics enter)
RESNET18_EVAL_ROW_TOL = VGG_ROW_PROB_TOL
# train-mode walks that refresh ResNet-18's BN running statistics on its
# trained weights (decay 0.9: 0.9^40 = 1.5% of the old statistics remain)
RESNET18_BN_REFRESH_PASSES = 40


def lenet_data(n, seed):
    """``n`` 28 x 28 x 1 images: ten class templates from N(0, 1), each
    image its class's template plus N(0, 2^2) noise (an F32 LeNet reaches
    ~0.91 held-out accuracy after one epoch of 60 steps, ~0.99 after
    three); one-hot labels. Made on the host from a seed."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(0.0, 1.0, (10, 28, 28, 1)).astype(np.float32)
    idx = rng.integers(0, 10, n)
    x = templates[idx] + rng.normal(0.0, 2.0, (n, 28, 28, 1)).astype(
        np.float32)
    return x, np.eye(10, dtype=np.float32)[idx]


def mln_copy(net, device, dtype=None):
    """The same configuration, weights and layer state on ``device``;
    ``dtype`` ("float32", "float64") also sets the policy and casts the
    weights."""
    import dataclasses
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf.core import TORCH_DTYPES, DtypePolicy
    conf, cast = net.conf, None
    if dtype is not None:
        gc = dataclasses.replace(conf.global_conf, dtype=DtypePolicy(
            param_dtype=dtype, compute_dtype=dtype))
        conf = dataclasses.replace(conf, global_conf=gc)
        cast = TORCH_DTYPES[dtype]
    cp = MultiLayerNetwork(conf, device=device).init()
    copy = lambda t: t.detach().to(device, cast).clone()  # noqa: E731
    cp.params = {ln: {k: copy(t) for k, t in lp.items()}
                 for ln, lp in net.params.items()}
    cp.state = {ln: {k: copy(t) for k, t in lp.items()}
                for ln, lp in net.state.items()}
    return cp


def f32_step_vs_f64(card_net, cpu_net, ref_net, grads_fn, xs, ys, what):
    """One F32 step's score and gradients on the card and on the plain CPU
    path, each against the f64 CPU path; fails unless the card is as
    accurate as the CPU (CONV_ACCURACY_RATIO) and the scores agree to
    CONV_F32_SCORE_RTOL. Returns the fields to print."""
    ref_loss, ref_g = grads_fn(ref_net, xs.cpu().double(), ys.cpu().double())
    card_loss, card_g = grads_fn(card_net, xs, ys)
    cpu_loss, cpu_g = grads_fn(cpu_net, xs.cpu(), ys.cpu())
    card_err = worst(grad_errors(card_g, ref_g, rel_l2=True))
    cpu_err = worst(grad_errors(cpu_g, ref_g, rel_l2=True))
    score_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"  {what} F32 first step: scores card {card_loss:.7f}, CPU "
          f"{cpu_loss:.7f}, f64 {ref_loss:.7f}; worst gradient L2 error vs "
          f"f64: card {card_err[0]}:{card_err[1]:.3e}, CPU "
          f"{cpu_err[0]}:{cpu_err[1]:.3e}", flush=True)
    check(score_err <= CONV_F32_SCORE_RTOL, f"{what} F32 first step score "
          f"card vs CPU {score_err:.3e} > {CONV_F32_SCORE_RTOL}")
    lim = CONV_ACCURACY_RATIO * cpu_err[1] + 1e-3
    check(card_err[1] <= lim, f"{what} F32 first step: the card's gradients "
          f"are {card_err[1]:.3e} (L2) from f64, more than "
          f"{CONV_ACCURACY_RATIO} x the CPU's {cpu_err[1]:.3e} + 1e-3")
    return {"score_rel": f"{score_err:.3e}",
            "grad_l2_vs_f64_card": f"{card_err[1]:.3e}",
            "grad_l2_vs_f64_cpu": f"{cpu_err[1]:.3e}"}


def check_no_kernel_launched(what):
    """No kernel of the port (K1-K7) runs on the conv nets' paths."""
    from deeplearning4j_tpu_torch.ops import registry
    launched = {k: v for k, v in registry.launches().items() if v}
    check(not launched, f"{what} launched the port's kernels: {launched}")


def conv_profile(net, data, step_ms, tag):
    """profile_steps over ``data`` (one step a batch), its kernel listing
    written to profile_out/<tag>_kernels.json, and the device time a step
    over ``step_ms``, the step timed without the profiler: the profiler
    slows the host's issue of each kernel, so its own wall time (and the
    busy share over it) reads long where the host bounds the step."""
    prof = profile_steps(net, data, names_to=f"{tag}_kernels.json")
    prof.pop("prof_flash_attn_fwd_ms_per_step")
    prof["device_ms_over_timed_step_ms"] = (
        f"{float(prof['prof_device_ms_per_step']) / step_ms:.3f}")
    return prof


# fit as it ran before the training runtime: one eager step a batch, the
# batch copied in by the step, no prefetch thread
PLAIN_FIT = dict(multi_step=1, device_prefetch=False, async_prefetch=False)


def epoch_ms(net, it, **fit_kw):
    """One fit(it, **fit_kw) epoch's milliseconds per step, by CUDA events
    around the whole epoch (the host's issue and the data's copies
    included)."""
    import torch
    steps0 = net.iteration
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    net.fit(it, **fit_kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (net.iteration - steps0)


def lenet_runtime_epoch(net, it):
    """One epoch through fit's runtime (multi_step="auto": chunks of 8
    through the captured step; device_prefetch="auto": pinned memory and
    a side stream) beside two epochs of the plain loop, from copies of
    one net: epoch ms a step, and the final params bit-identical to the
    plain loop's wherever two plain epochs are (else within twice their
    difference)."""
    plain, plain2, auto = net.clone(), net.clone(), net.clone()
    plain_ms = epoch_ms(plain, it, **PLAIN_FIT)
    auto_ms = epoch_ms(auto, it, multi_step="auto", device_prefetch="auto")
    plain2_ms = epoch_ms(plain2, it, **PLAIN_FIT)
    (sg,) = auto._multi_steps.values()
    check(sg.captures == 1 and sg.replays > 0,
          f"lenet auto epoch: {sg.captures} captures, {sg.replays} replays")
    held = hold_captured_to_eager(tree_max_diffs(plain, plain2),
                                  tree_max_diffs(auto, plain), "lenet epoch")
    return {"runtime_epoch_step_ms_plain": f"{plain_ms:.4f}/{plain2_ms:.4f}",
            "runtime_epoch_step_ms_auto": f"{auto_ms:.4f}",
            "runtime_epoch_replays": sg.replays,
            "runtime_epoch_vs_plain": json.dumps(held)}


class _BothSavers:
    """An early-stopping saver that writes the zip and keeps a clone."""

    def __init__(self, directory):
        from deeplearning4j_tpu_torch.optimize.earlystopping import (
            InMemoryModelSaver, LocalFileModelSaver)
        self.file = LocalFileModelSaver(directory)
        self.memory = InMemoryModelSaver()

    def save_best(self, net):
        self.file.save_best(net)
        self.memory.save_best(net)

    def save_latest(self, net):
        self.file.save_latest(net)
        self.memory.save_latest(net)

    def get_best(self):
        return self.file.get_best()


def phase_train_lenet():
    """zoo.lenet at its published width (28 x 28 x 1, conv 20/50, dense
    500, BF16, Nesterovs(0.01, 0.9)) on synthetic template images: the F32
    first step against f64, fit(iterator) at b = 64 with and without the
    three listeners, a profile, early stopping with EvaluationScoreCalculator
    and LocalFileModelSaver, and F32 evaluate card vs CPU."""
    import io
    import tempfile
    import torch
    from deeplearning4j_tpu_torch import ArrayDataSetIterator, DataSet, zoo
    from deeplearning4j_tpu_torch.eval import Evaluation
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.optimize.earlystopping import (
        EarlyStoppingConfiguration, EarlyStoppingTrainer,
        EvaluationScoreCalculator, MaxEpochsTermination)
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresIterationListener, PerformanceListener,
        ScoreIterationListener)
    t_phase = time.perf_counter()
    b, n_train, n_held = 64, 64 * 60, 2048
    x, y = lenet_data(n_train + n_held, SEED + 30)
    xt, yt, xh, yh = x[:n_train], y[:n_train], x[n_train:], y[n_train:]
    net = zoo.lenet(seed=SEED + 31)
    pol = net.conf.global_conf.dtype
    check(pol.compute_dtype == "bfloat16", f"lenet policy {pol}")
    upd = net.layers[0].resolve("updater")
    check(upd.kind == "nesterovs" and upd.learning_rate == 0.01
          and upd.momentum == 0.9, f"lenet updater {upd}")
    out = {"model": "lenet(28x28x1,conv20/50,dense500,BF16,"
                    "Nesterovs(0.01,0.9))", "b": b,
           "params": net.num_params(),
           "preprocessors": json.dumps(
               [type(p).__name__ if p else None for p in net.preprocessors])}

    # the F32 first step against f64, same weights and batch
    f32 = mln_copy(net, "cuda", "float32")
    xs, ys = torch.from_numpy(xt[:b]).cuda(), torch.from_numpy(yt[:b]).cuda()
    registry.reset_launches()
    out.update({f"first_step_f32_{k}": v for k, v in f32_step_vs_f64(
        f32, mln_copy(net, "cpu", "float32"), mln_copy(net, "cpu", "float64"),
        loss_and_grads, xs, ys, "lenet").items()})
    del f32

    # fit(iterator): a warm-up epoch, then epochs without and with the
    # listeners in turns (without, with, with, without)
    it = ArrayDataSetIterator(xt, yt, batch_size=b, shuffle=True,
                              seed=SEED + 32)
    log = io.StringIO()
    listeners = (ScoreIterationListener(20, out=log),
                 CollectScoresIterationListener(10),
                 PerformanceListener(frequency=20))
    registry.reset_launches()
    warm = CollectScoresIterationListener(5)
    net.set_listeners(warm)
    net.fit(it, **PLAIN_FIT)
    sc = [s for _, s in warm.scores]
    check(all(math.isfinite(v) for v in sc), f"lenet scores {sc}")
    check(statistics.mean(sc[-5:]) < sc[0], f"lenet training did not lower "
          f"the score: first {sc[0]:.4f}, mean of last 5 "
          f"{statistics.mean(sc[-5:]):.4f}")
    out["first_epoch_scores_every_5"] = json.dumps([round(v, 4) for v in sc])
    ms = {"without": [], "with": []}
    for kind in ("without", "with", "with", "without"):
        net.set_listeners(*(listeners if kind == "with" else ()))
        ms[kind].append(epoch_ms(net, it, **PLAIN_FIT))
    net.set_listeners()
    check_no_kernel_launched("lenet fit")
    out.update(lenet_runtime_epoch(net, it))
    steps = net.iteration
    sc = [s for _, s in listeners[1].scores]
    printed = log.getvalue().count("Score at iteration")
    # two epochs of 60 steps with the listeners attached: a score line
    # every 20 iterations, a score every 10, a performance record every 20
    check(printed == 6 and len(sc) == 12 and len(listeners[2].records) == 6,
          f"listener cadence: {printed} score lines, {len(sc)} scores, "
          f"{len(listeners[2].records)} performance records")
    with_ms = statistics.mean(ms["with"])
    without_ms = statistics.mean(ms["without"])
    out["step_ms_with_listeners"] = f"{with_ms:.4f}"
    out["step_ms_without_listeners"] = f"{without_ms:.4f}"
    out["step_ms_by_epoch"] = json.dumps(
        {k: [round(v, 4) for v in vs] for k, vs in ms.items()})
    out["images_per_s"] = f"{b / without_ms * 1e3:.1f}"
    out["listener_examples_per_s"] = json.dumps(
        [round(r["examples_per_sec"], 1) for r in listeners[2].records])
    out["listener_scores_every_10"] = json.dumps([round(v, 4) for v in sc])
    out["steps"] = steps
    data = [DataSet(torch.from_numpy(xt[i * b:(i + 1) * b]).cuda(),
                    torch.from_numpy(yt[i * b:(i + 1) * b]).cuda())
            for i in range(10)]
    out.update(conv_profile(net, data, without_ms, "lenet"))

    # early stopping on a fresh net: max epochs, 1 - accuracy on the
    # held-out split, the best model zipped and read back
    es_net = zoo.lenet(seed=SEED + 33)
    held = ArrayDataSetIterator(xh, yh, batch_size=512)
    with tempfile.TemporaryDirectory() as tmp:
        saver = _BothSavers(tmp)
        cfg = EarlyStoppingConfiguration(
            score_calculator=EvaluationScoreCalculator(held),
            epoch_terminations=[MaxEpochsTermination(3)],
            model_saver=saver)
        t0 = time.perf_counter()
        result = EarlyStoppingTrainer(
            cfg, es_net, ArrayDataSetIterator(xt, yt, batch_size=b,
                                              shuffle=True,
                                              seed=SEED + 34)).fit()
        out["early_stopping_s"] = f"{time.perf_counter() - t0:.2f}"
        best = result.best_model
        check(best.device.type == "cuda", f"best model on {best.device}")
        ev_file = best.evaluate(held)
        ev_mem = saver.memory.get_best().evaluate(held)
    check(np.array_equal(ev_file.confusion.matrix, ev_mem.confusion.matrix),
          "the restored best model's evaluate differs from the in-memory "
          "one's")
    acc = ev_file.accuracy()
    out["early_stopping"] = json.dumps({
        "reason": result.termination_reason, "epochs": result.total_epochs,
        "best_epoch": result.best_model_epoch,
        "score_vs_epoch": {k: round(v, 4)
                           for k, v in result.score_vs_epoch.items()}})
    out["heldout_accuracy"] = f"{acc:.4f}"
    check(result.termination_reason == "MaxEpochsTermination"
          and result.total_epochs == 3, f"early stopping ended with "
          f"{result.termination_reason} after {result.total_epochs}")
    check(abs((1.0 - acc) - result.best_model_score) < 1e-12,
          f"best score {result.best_model_score} vs 1 - accuracy {1 - acc}")
    check(acc >= LENET_MIN_ACCURACY, f"held-out accuracy {acc:.4f} < "
          f"{LENET_MIN_ACCURACY}")

    # F32 evaluate, card vs CPU, on the early-stopped weights
    card32, cpu32 = mln_copy(best, "cuda", "float32"), mln_copy(best, "cpu",
                                                                "float32")
    p_cpu = cpu32.output(xh).float().numpy()
    top2 = np.sort(p_cpu, axis=1)[:, -2:]
    keep = (top2[:, 1] - top2[:, 0]) >= LENET_TIE_GAP
    ev_card, ev_cpu = Evaluation(), Evaluation()
    ev_card.eval(yh, card32.output(xh), mask=keep)
    ev_cpu.eval(yh, p_cpu, mask=keep)
    out["f32_eval_rows_left_out_near_ties"] = int((~keep).sum())
    out["f32_eval_accuracy_card"] = f"{ev_card.accuracy():.4f}"
    check(np.array_equal(ev_card.confusion.matrix, ev_cpu.confusion.matrix),
          "F32 evaluate: the card's confusion matrix differs from the CPU's")
    check_no_kernel_launched("lenet")
    out["phase_s"] = f"{time.perf_counter() - t_phase:.1f}"
    phase("train_lenet", **out)


def vgg_batches(n, b, seed, size=224, classes=1000):
    """``n`` batches made on the card from a seed: 0-255 RGB images of
    noise around a per-class colour, through vgg16_preprocess; one-hot
    labels."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    gen = torch.Generator(device="cuda").manual_seed(seed)
    colour = torch.rand((classes, 3), generator=gen, device="cuda") * 255
    out = []
    for _ in range(n):
        lab = torch.randint(0, classes, (b,), generator=gen, device="cuda")
        img = colour[lab][:, None, None, :] + 40 * torch.randn(
            (b, size, size, 3), generator=gen, device="cuda")
        img = zoo.vgg16_preprocess(img.clamp(0, 255))
        out.append((img, torch.nn.functional.one_hot(lab, classes).float()))
    return out


def phase_train_vgg16():
    """zoo.vgg16 at full width (224 x 224 x 3, 1000 classes, 138 M
    parameters, BF16; Nesterovs(VGG_LR, 0.9)): the F32 forward at b = 2
    card vs the plain CPU path, then 12 BF16 fit_batch steps at b = 32 on
    batches made on the card, a profile by kind of kernel."""
    import torch
    from deeplearning4j_tpu_torch import DataSet, zoo
    from deeplearning4j_tpu_torch.nn.updater import Nesterovs
    from deeplearning4j_tpu_torch.ops import registry
    t_phase = time.perf_counter()
    b, steps = 32, 12
    net = zoo.vgg16(seed=SEED + 40, updater=Nesterovs(VGG_LR, 0.9))
    check(net.num_params() == 138357544, f"vgg16 has {net.num_params()} "
          f"parameters")
    pol = net.conf.global_conf.dtype
    check(pol.compute_dtype == "bfloat16", f"vgg16 policy {pol}")
    out = {"model": f"vgg16(224x224x3,classes=1000,BF16,"
                    f"Nesterovs({VGG_LR},0.9))",
           "b": b, "params": net.num_params()}

    # the F32 forward, card vs the plain CPU path, same weights
    registry.reset_launches()
    xe = vgg_batches(1, 2, SEED + 41)[0][0]
    f32 = mln_copy(net, "cuda", "float32")
    card_p = f32.output(xe).float().cpu()
    del f32
    cpu_p = mln_copy(net, "cpu", "float32").output(xe.cpu()).float()
    check(torch.isfinite(card_p).all().item() and card_p.shape == (2, 1000),
          f"vgg16 output {tuple(card_p.shape)} not finite")
    row_err = float(((card_p - cpu_p).abs().amax(1)
                     / cpu_p.amax(1)).max())
    out["f32_forward_b2_prob_vs_cpu_over_row_max"] = f"{row_err:.3e}"
    out["f32_forward_b2_row_max_prob"] = json.dumps(
        [float(f"{v:.4e}") for v in cpu_p.amax(1)])
    check(row_err <= VGG_ROW_PROB_TOL, f"vgg16 F32 forward card vs CPU: "
          f"{row_err:.3e} of a row's largest probability > "
          f"{VGG_ROW_PROB_TOL}")
    torch.cuda.empty_cache()

    # 12 BF16 steps on two batches made on the card
    data = [DataSet(x, y) for x, y in vgg_batches(2, b, SEED + 42)]
    run = timed_steps(net, data, steps)
    sc = run["scores"]
    check(all(math.isfinite(v) for v in sc), f"vgg16 scores {sc}")
    check(statistics.mean(sc[-5:]) < sc[0], f"vgg16 training did not lower "
          f"the score: first {sc[0]:.4f}, mean of last 5 "
          f"{statistics.mean(sc[-5:]):.4f}")
    med = statistics.median(run["step_ms"][-8:])
    out["step_ms_median_last8"] = f"{med:.3f}"
    out["step_ms_min_max_last8"] = (f"{min(run['step_ms'][-8:]):.3f}/"
                                    f"{max(run['step_ms'][-8:]):.3f}")
    out["images_per_s"] = f"{b / med * 1e3:.1f}"
    out["peak_mem_mb"] = f"{run['peak_mb']:.0f}"
    out["scores"] = json.dumps([round(v, 4) for v in sc])
    out.update(conv_profile(net, data, med, "vgg16"))
    check_no_kernel_launched("vgg16")
    out["phase_s"] = f"{time.perf_counter() - t_phase:.1f}"
    phase("train_vgg16", **out)


def refresh_bn_statistics(net, xs, passes):
    """``passes`` train-mode walks of a graph over ``xs`` in turn, each
    moving the BN running statistics toward that batch's and changing no
    weight."""
    import torch
    with torch.inference_mode():
        for i in range(passes):
            inputs, fmasks = net._prepare_inputs((xs[i % len(xs)],))
            *_, net.state = net._walk(net.params, net.state, inputs,
                                      train=True, gen=net._gen,
                                      fmasks=fmasks)


def phase_train_resnet18():
    """zoo.resnet18 at its defaults (32 x 32 x 3, 10 classes, BF16,
    Nesterovs(0.1, 0.9)) with DL4J_TPU_FUSE_BLOCKS=1 (no tail matches):
    the F32 first step card vs CPU against f64, fusion off and on; 20 BF16
    steps at b = 128; ComputationGraph.evaluate on the card."""
    import os
    import torch
    from deeplearning4j_tpu_torch import DataSet, MultiDataSet, zoo
    from deeplearning4j_tpu_torch.ops import registry
    t_phase = time.perf_counter()
    b, steps = 128, 20
    before = os.environ.get("DL4J_TPU_FUSE_BLOCKS")
    os.environ["DL4J_TPU_FUSE_BLOCKS"] = "1"
    try:
        net = zoo.resnet18(seed=SEED + 50)
    finally:
        if before is None:
            del os.environ["DL4J_TPU_FUSE_BLOCKS"]
        else:
            os.environ["DL4J_TPU_FUSE_BLOCKS"] = before
    check(net._fusion_plans == {}, f"resnet18 matched "
          f"{len(net._fusion_plans)} tails")
    out = {"model": "resnet18(32x32x3,classes=10,BF16,Nesterovs(0.1,0.9),"
                    "DL4J_TPU_FUSE_BLOCKS=1)", "b": b,
           "params": net.num_params(), "fused_tails": 0}
    batches = resnet_batches(3, b, SEED + 51, size=32, classes=10)

    # the F32 first step, fusion off and on, card vs CPU against f64
    nb = 16
    xs, ys = batches[0][0][:nb], batches[0][1][:nb]
    registry.reset_launches()
    ref = graph_copy(net, "cpu", False, dtype="float64")
    for fuse in (False, True):
        card = graph_copy(net, "cuda", fuse, dtype="float32")
        check(card._fusion_plans == {}, "resnet18 F32 copy matched tails")
        fields = f32_step_vs_f64(
            card, graph_copy(net, "cpu", fuse, dtype="float32"), ref,
            graph_loss_and_grads, xs, ys,
            f"resnet18 ({'fusion on' if fuse else 'fusion off'})")
        tag = "on" if fuse else "off"
        out.update({f"first_step_f32_fusion_{tag}_{k}": v
                    for k, v in fields.items()})
    del ref

    # 20 BF16 steps at b = 128 on two batches made on the card
    data = [DataSet(x, y) for x, y in batches[:2]]
    run = timed_steps(net, data, steps)
    sc = run["scores"]
    check(all(math.isfinite(v) for v in sc), f"resnet18 scores {sc}")
    check(statistics.mean(sc[-5:]) < sc[0], f"resnet18 training did not "
          f"lower the score: first {sc[0]:.4f}, mean of last 5 "
          f"{statistics.mean(sc[-5:]):.4f}")
    med = statistics.median(run["step_ms"][-10:])
    out["step_ms_median_last10"] = f"{med:.3f}"
    out["step_ms_min_max_last10"] = (f"{min(run['step_ms'][-10:]):.3f}/"
                                     f"{max(run['step_ms'][-10:]):.3f}")
    out["images_per_s"] = f"{b / med * 1e3:.1f}"
    out["peak_mem_mb"] = f"{run['peak_mb']:.0f}"
    out["scores"] = json.dumps([round(v, 4) for v in sc])
    out.update(conv_profile(net, data, med, "resnet18"))

    # ComputationGraph.evaluate on the card: the trained batches and a
    # third, against the argmax of the graph's own output
    ev = net.evaluate([MultiDataSet([x], [y]) for x, y in batches])
    want = np.zeros((10, 10), np.int64)
    for x, y in batches:
        np.add.at(want, (y.argmax(1).cpu().numpy(),
                         net.output(x).float().argmax(1).cpu().numpy()), 1)
    check(np.array_equal(ev.confusion.matrix, want), "resnet18 evaluate's "
          "confusion matrix differs from its outputs' argmax")
    out["evaluate_accuracy_b384"] = f"{ev.accuracy():.4f}"

    # eval mode on the trained weights and BN state, F32, card vs the plain
    # CPU path: 64 rows of a trained batch and 64 of the unseen one
    rows = torch.cat([batches[0][0][:64], batches[2][0][:64]])
    card_p = graph_copy(net, "cuda", False, dtype="float32").output(
        rows).float().cpu()
    cpu_p = graph_copy(net, "cpu", False, dtype="float32").output(
        rows.cpu()).float()
    row_err = float(((card_p - cpu_p).abs().amax(1)
                     / cpu_p.amax(1)).max())
    out["eval_f32_b128_prob_vs_cpu_over_row_max"] = f"{row_err:.3e}"
    check(row_err <= RESNET18_EVAL_ROW_TOL, f"resnet18 F32 eval card vs "
          f"CPU: {row_err:.3e} of a row's largest probability > "
          f"{RESNET18_EVAL_ROW_TOL}")

    # the eval-mode accuracy by batch (two trained, one unseen), beside the
    # train-mode one (batch statistics) and the eval-mode one after the BN
    # running statistics are refreshed on the trained weights
    def accuracies(g, train):
        return json.dumps([round(float(
            (g.output(x, train=train).float().argmax(1) == y.argmax(1))
            .float().mean()), 4) for x, y in batches])
    out["accuracy_by_batch_eval"] = accuracies(net, False)
    out["accuracy_by_batch_train_mode"] = accuracies(net, True)
    fresh = graph_copy(net, "cuda", False)
    refresh_bn_statistics(fresh, [x for x, _ in batches[:2]],
                          RESNET18_BN_REFRESH_PASSES)
    out["accuracy_by_batch_eval_after_bn_refresh"] = accuracies(fresh,
                                                                False)
    del fresh
    check_no_kernel_launched("resnet18")
    out["phase_s"] = f"{time.perf_counter() - t_phase:.1f}"
    phase("train_resnet18", **out)


# ---------------------------------------------------------------------------
# [train_captured]: the whole train step as one CUDA graph
# ---------------------------------------------------------------------------
# steps of each run (eager, eager again, captured): the captured run's first
# multistep.WARMUP_STEPS are its eager warm-ups, the rest replays
CAPTURED_STEPS = 8
# replays (and eager steps) timed alone by CUDA events, and profiled
CAPTURED_TIMED = 10
CAPTURED_PROFILED = 3


def tree_max_diffs(a, b):
    """{tensor path: max |a - b|} over two nets' params, updater state and
    layer state (same structure), in f64 on the host."""
    from deeplearning4j_tpu_torch.nn import multistep
    out = {}
    for (tn, path, x), (_, _, y) in zip(multistep._tree_paths(a),
                                        multistep._tree_paths(b)):
        d = (x.detach().double() - y.detach().double()).abs()
        out[(tn,) + path] = float(d.max()) if d.numel() else 0.0
    return out


def hold_captured_to_eager(ee, ce, what):
    """Captured vs eager (``ce``) against eager vs eager (``ee``): equal
    bit for bit on every tensor the two eager runs agree on bit for bit;
    where they do not (cuDNN's weight-gradient atomics), at most twice
    their largest difference. Returns the summary printed."""
    exact = [k for k, v in ee.items() if v == 0.0]
    loose = [k for k, v in ee.items() if v != 0.0]
    bad = [".".join(map(str, k)) for k in exact if ce[k] != 0.0]
    check(not bad, f"{what}: captured vs eager differs where two eager "
          f"runs are bit-identical: {bad[:6]} (max "
          f"{max((ce[k] for k in exact), default=0.0):.3e})")
    ee_max = max((ee[k] for k in loose), default=0.0)
    ce_max = max((ce[k] for k in loose), default=0.0)
    check(ce_max <= 2.0 * ee_max, f"{what}: captured vs eager {ce_max:.3e} "
          f"> twice eager vs eager {ee_max:.3e}")
    return {"tensors": len(ee), "bit_identical_eager_vs_eager": len(exact),
            "eager_vs_eager_max": f"{ee_max:.3e}",
            "captured_vs_eager_max": f"{ce_max:.3e}"}


def eager_run(net, data):
    """len(data) fit_batch steps: launches, step ms by CUDA events."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    torch.cuda.synchronize()
    registry.reset_launches()
    events = []
    for ds in data:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        net.fit_batch(ds)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return registry.launches(), [a.elapsed_time(b) for a, b in events]


def replay_ms(net, ds, n):
    """n replays of the captured step (``fit_batch_repeated(ds, 1)``:
    the batch's copy in and one graph launch), each by CUDA events."""
    import torch
    events = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        net.fit_batch_repeated(ds, 1)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def wall_ms_per_step(step, n):
    """Host-clock ms a step over n back-to-back calls of ``step`` (one
    train step each), ending in a synchronize: the rate a training loop
    gets, host gaps between steps included."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def profile_call(fn, steps):
    """torch.profiler over ``fn()`` (``steps`` train steps): device ms,
    kernels and CUDA-graph launches a step, and the device's busy share
    of the host-clock wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    kernels = device_kernels(avgs)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(dev_ms > 0, "the profiler saw no device time in the replays")
    graphs = sum(e.count for e in avgs if e.key == "cudaGraphLaunch")
    return {"prof_device_ms_per_step": f"{dev_ms / steps:.3f}",
            "prof_wall_ms_per_step": f"{wall_ms / steps:.3f}",
            "prof_device_busy_share": f"{dev_ms / wall_ms:.3f}",
            "prof_kernels_per_step": sum(e.count for e in kernels) // steps,
            "prof_graph_launches_per_step": f"{graphs / steps:.2f}"}


def captured_cell(name, model, make, data, expect=()):
    """One cell of [train_captured]: three copies of one net; N eager
    steps, N more, and N through fit(multi_step=N) (warm-ups, capture,
    replays) on the same N batches; equality, launches, times."""
    import torch
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn import multistep
    from deeplearning4j_tpu_torch.ops import registry
    n = len(data)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_cell = time.perf_counter()
    base = make()
    a, b, c = base.clone(), base.clone(), base.clone()
    del base
    la, ms_a = eager_run(a, data)
    lb, ms_b = eager_run(b, data)
    torch.cuda.synchronize()
    registry.reset_launches()
    c.fit(ListDataSetIterator(data), multi_step=n, async_prefetch=False,
          device_prefetch=False)
    torch.cuda.synchronize()
    lc = registry.launches()
    (sg,) = c._multi_steps.values()
    replays = sg.replays
    check(sg.captures == 1 and replays == n - multistep.WARMUP_STEPS,
          f"{name}: {sg.captures} captures, {replays} replays in {n} "
          f"steps")
    check(c.iteration == a.iteration == n, f"{name}: iterations "
          f"{c.iteration} / {a.iteration}")
    # launches: the two eager runs alike, each replayed step as an eager one
    check(la == lb, f"{name}: eager launches {la} vs {lb}")
    per_step = {k: v // n for k, v in la.items()}
    check(all(v % n == 0 for v in la.values()), f"{name}: eager launches "
          f"{la} not a multiple of {n} steps")
    check(sg.launches == per_step, f"{name}: the graph recorded "
          f"{sg.launches}, an eager step launches {per_step}")
    check(lc == la, f"{name}: launches in {n} captured-run steps {lc}, in "
          f"{n} eager steps {la}")
    for kern in expect:
        check(per_step.get(kern, 0) > 0, f"{name}: {kern} not launched by "
              f"the captured step")
    ee, ce = tree_max_diffs(a, b), tree_max_diffs(c, a)
    sa, sb, sc = (float(x.score_value) for x in (a, b, c))
    check(math.isfinite(sc), f"{name}: captured score {sc}")
    ee[("score",)], ce[("score",)] = abs(sa - sb), abs(sc - sa)
    held = hold_captured_to_eager(ee, ce, name)
    del b
    # times: eager steps and replays in turns on the same batch
    ds0 = data[0]
    eager_ms = eager_run(a, [ds0] * CAPTURED_TIMED)[1]
    graph_ms = replay_ms(c, ds0, CAPTURED_TIMED)
    eager_ms2 = eager_run(a, [ds0] * CAPTURED_TIMED)[1]
    graph_ms2 = replay_ms(c, ds0, CAPTURED_TIMED)
    wall = {"eager": [], "captured": []}
    for kind in ("eager", "captured", "captured", "eager"):
        wall[kind].append(wall_ms_per_step(
            (lambda: a.fit_batch(ds0)) if kind == "eager"
            else (lambda: c.fit_batch_repeated(ds0, 1)), CAPTURED_TIMED))
    prof = profile_call(lambda: c.fit_batch_repeated(ds0, CAPTURED_PROFILED),
                        CAPTURED_PROFILED)
    eprof = profile_call(lambda: [a.fit_batch(ds0)
                                  for _ in range(CAPTURED_PROFILED)],
                         CAPTURED_PROFILED)
    med = statistics.median(graph_ms + graph_ms2)
    wall_c, wall_e = min(wall["captured"]), min(wall["eager"])
    dev_c = float(prof["prof_device_ms_per_step"])
    dev_e = float(eprof["prof_device_ms_per_step"])
    out = {"cell": name, "model": model, "steps": n,
           "warmup_steps": multistep.WARMUP_STEPS, "replays": replays,
           "launches_per_step": json.dumps(per_step),
           "graph_launches_recorded": json.dumps(sg.launches),
           **held,
           "captured_step_ms_median": f"{med:.4f}",
           "captured_step_ms_min_max": f"{min(graph_ms + graph_ms2):.4f}/"
                                       f"{max(graph_ms + graph_ms2):.4f}",
           "eager_step_ms_median": f"{statistics.median(eager_ms + eager_ms2):.4f}",
           "eager_step_ms_min_max": f"{min(eager_ms + eager_ms2):.4f}/"
                                    f"{max(eager_ms + eager_ms2):.4f}",
           "captured_wall_ms_per_step": json.dumps(
               [round(v, 4) for v in wall["captured"]]),
           "eager_wall_ms_per_step": json.dumps(
               [round(v, 4) for v in wall["eager"]]),
           # device time a step (profiler) over the host-clock step time
           # without the profiler
           "captured_busy_share": f"{dev_c / wall_c:.3f}",
           "eager_busy_share": f"{dev_e / wall_e:.3f}",
           "capture_ms": f"{sg.capture_ms:.1f}",
           "peak_mem_mb_with_graph_pool":
               f"{torch.cuda.max_memory_allocated() / 2**20:.0f}",
           **prof,
           **{f"eager_{k}": v for k, v in eprof.items()},
           "cell_s": f"{time.perf_counter() - t_cell:.1f}"}
    phase("train_captured", **out)
    return {"net": c, "step_ms": med, "ds": ds0, "wall_ms": wall_c}


def capture_route_probe(what, make, ds, steps=None, lr_scale=0.01):
    """A small net whose step takes a route the cells do not (the f32
    grid LSTM, K3's FMA kernel, K4-K7's f32 path, dropout): captured vs
    eager under ``hold_captured_to_eager``, or, where the route cannot be
    captured, a CaptureError that names it (the step is never run eagerly
    in its place). The rate is scaled (``lr_scale``) so that these small
    nets do not diverge: a diverging run magnifies any difference, and
    where two eager runs differ (the f32 fused path) a chaotic one makes
    the comparison a draw."""
    import torch
    from deeplearning4j_tpu_torch.nn import multistep
    steps = steps or multistep.WARMUP_STEPS + 2
    base = make().set_lr_scale(lr_scale)
    a, b, c = base.clone(), base.clone(), base.clone()
    for _ in range(steps):
        a.fit_batch(ds)
        b.fit_batch(ds)
    try:
        c.fit_batch_repeated(ds, steps)
    except multistep.CaptureError as e:
        msg = str(e)
        check("cannot be captured" in msg, f"{what}: {msg}")
        return {"captures": False, "error": msg[:400]}
    torch.cuda.synchronize()
    (sg,) = c._multi_steps.values()
    check(sg.replays == steps - multistep.WARMUP_STEPS, f"{what}: "
          f"{sg.replays} replays")
    return {"captures": True, **hold_captured_to_eager(
        tree_max_diffs(a, b), tree_max_diffs(c, a), what)}


def capture_routes():
    """[capture_routes]: which of the kernels' other routes capture."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn import multistep
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    seq = on_card(markov_batches(1, 8, 16, 80, SEED + 50))[0]
    out = {
        "lstm_grid_f32": capture_route_probe(
            "char_rnn F32 (K1/K2 grid route)",
            lambda: zoo.char_rnn(seed=SEED, hidden=128, dtype=zoo.F32), seq),
        "lstm_grid_bf16_n96": capture_route_probe(
            "char_rnn BF16 n = 96 (K1/K2 grid route)",
            lambda: zoo.char_rnn(seed=SEED, hidden=96), seq),
        "flash_fma_f32": capture_route_probe(
            "gpt_mini F32 (K3 FMA kernel)",
            lambda: zoo.gpt_mini(seed=SEED, n_layers=1, max_len=16,
                                 dtype=zoo.F32), seq),
    }
    # b = 16: the last stage's batch norm (1 x 1 spatial) over 16 rows;
    # one replay after the warm-ups
    x, y = resnet_batches(1, 16, SEED + 51, size=32, classes=10)[0]
    with fuse_blocks(True):
        out["fused_f32"] = capture_route_probe(
            "resnet50 F32 32x32 (K4-K7 f32 path)",
            lambda: zoo.resnet50(seed=SEED, image_size=32, n_classes=10,
                                 dtype=zoo.F32), DataSet(x, y),
            steps=multistep.WARMUP_STEPS + 1, lr_scale=1e-3)
    f32 = DtypePolicy(param_dtype="float32", compute_dtype="float32")
    conf = (NeuralNetConfiguration.builder().seed(SEED).dtype(f32).list()
            .layer(Dense(n_in=32, n_out=256, activation="relu", dropout=0.5))
            .layer(Output(n_out=10, activation="softmax", loss="mcxent"))
            .build())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 52)
    xd = torch.randn((64, 32), generator=gen, device="cuda")
    yd = torch.nn.functional.one_hot(torch.randint(
        0, 10, (64,), generator=gen, device="cuda"), 10).float()
    out["dropout_generator"] = capture_route_probe(
        "dense + dropout (the net's generator)",
        lambda: MultiLayerNetwork(conf).init(), DataSet(xd, yd))
    check(out["dropout_generator"]["captures"],
          "the dropout net's step did not capture")
    out["host_read_refused"] = host_read_refusal(conf, DataSet(xd, yd))
    out["collector_mid_capture"] = collector_mid_capture(conf,
                                                         DataSet(xd, yd))
    phase("capture_routes", **{k: json.dumps(v) for k, v in out.items()})
    return out


def collector_mid_capture(conf, ds):
    """A captured net left in a dead reference cycle while another net's
    step is captured, with a full collection run as the capture begins
    (as the collector may run at any allocation): the capture succeeds
    and replays. Were the cycle collected inside the capture, destroying
    its CUDA graph would invalidate the capture."""
    import gc
    import torch
    from deeplearning4j_tpu_torch.nn import multistep
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(conf).init()
    net.fit_batch_repeated(ds, multistep.WARMUP_STEPS)   # warm-ups only
    (sg,) = net._multi_steps.values()
    old = MultiLayerNetwork(conf).init()
    old.fit_batch_repeated(ds, multistep.WARMUP_STEPS + 1)
    check(sg.graph is None and old._multi_steps, "collector_mid_capture: "
          "the warm-ups captured, or the first net did not")
    old.cycle = old       # only the collector can free it now
    del old
    cls = torch.cuda.CUDAGraph
    begin = cls.capture_begin

    def begin_then_collect(self, *a, **k):
        begin(self, *a, **k)
        gc.collect()

    cls.capture_begin = begin_then_collect
    try:
        net.fit_batch_repeated(ds, 2)
    finally:
        cls.capture_begin = begin
    torch.cuda.synchronize()
    check(sg.captures == 1 and sg.replays == 2, f"collector_mid_capture: "
          f"{sg.captures} captures, {sg.replays} replays")
    return {"captures": True, "replays": sg.replays}


def host_read_refusal(conf, ds):
    """A step that reads its loss on the host (``float``) cannot be
    captured: fit_batch_repeated runs the eager warm-ups, then raises a
    CaptureError naming ``Tensor.__float__``, and runs no step eagerly in
    the captured step's place."""
    from deeplearning4j_tpu_torch.nn import multistep
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(conf).init()
    loss = net._loss

    def reading_loss(*args, **kwargs):
        out = loss(*args, **kwargs)
        float(out[0])
        return out

    net._loss = reading_loss
    try:
        net.fit_batch_repeated(ds, multistep.WARMUP_STEPS + 2)
    except multistep.CaptureError as e:
        msg = str(e)
    else:
        check(False, "a step reading its loss on the host was captured")
    check("Tensor.__float__" in msg, f"the refusal does not name the "
          f"host read: {msg}")
    check(net._it_twin.value == multistep.WARMUP_STEPS,
          f"{net._it_twin.value} steps ran, expected the "
          f"{multistep.WARMUP_STEPS} warm-ups alone")
    return {"refused": True, "error": msg[:200]}


@contextlib.contextmanager
def fuse_blocks(on):
    before = os.environ.get("DL4J_TPU_FUSE_BLOCKS")
    os.environ["DL4J_TPU_FUSE_BLOCKS"] = "1" if on else "0"
    try:
        yield
    finally:
        if before is None:
            del os.environ["DL4J_TPU_FUSE_BLOCKS"]
        else:
            os.environ["DL4J_TPU_FUSE_BLOCKS"] = before


def phase_train_captured():
    """[train_captured]: the whole train step as one CUDA graph at full
    width on the char-RNN (b = 32, T = 64, BF16, Adam), gpt_mini (b = 32,
    T = 256), LeNet (b = 64), ResNet-18 (b = 128) and ResNet-50 with the
    fusion pass on (b = 256, K4-K7). From one set of weights: N eager
    steps, N more, and N captured steps through fit(multi_step=N); the
    captured params, updater state and BN state bit-identical to the eager
    ones wherever the two eager runs are, else within twice their
    difference; each replayed step's launches equal an eager step's.
    Then [capture_routes] and [mfu]."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.datasets import DataSet
    t0 = time.perf_counter()
    n = CAPTURED_STEPS
    cells = {}
    cells["char_rnn"] = captured_cell(
        "char_rnn", "char_rnn(vocab=80,hidden=512,layers=2,BF16,Adam(2e-3)),"
        "b=32,T=64", lambda: zoo.char_rnn(seed=SEED),
        on_card(markov_batches(n, 32, 64, 80, SEED + 40)),
        expect=("lstm_fwd", "lstm_fwd_sm90", "lstm_bwd", "lstm_bwd_sm90"))
    del cells["char_rnn"]["net"]
    cells["gpt_mini"] = captured_cell(
        "gpt_mini", "gpt_mini(vocab=80,width=256,blocks=4,heads=4,BF16,"
        "Adam(3e-4)),b=32,T=256", lambda: zoo.gpt_mini(seed=SEED + 9),
        on_card(markov_batches(n, 32, 256, 80, SEED + 41)),
        expect=("flash_attn_fwd", "flash_attn_fwd_sm90"))
    del cells["gpt_mini"]["net"]
    xs, ys = lenet_data(64 * n, SEED + 42)
    cells["lenet"] = captured_cell(
        "lenet", "lenet(28x28x1,BF16,Nesterovs(0.01,0.9)),b=64",
        lambda: zoo.lenet(seed=SEED + 31),
        [DataSet(torch.from_numpy(xs[i * 64:(i + 1) * 64]).cuda(),
                 torch.from_numpy(ys[i * 64:(i + 1) * 64]).cuda())
         for i in range(n)])
    del cells["lenet"]["net"]
    with fuse_blocks(True):
        cells["resnet18"] = captured_cell(
            "resnet18", "resnet18(32x32,10 classes,BF16,Nesterovs(0.1,0.9),"
            "DL4J_TPU_FUSE_BLOCKS=1),b=128",
            lambda: zoo.resnet18(seed=SEED + 60),
            [DataSet(x, y) for x, y in resnet_batches(n, 128, SEED + 43,
                                                      size=32, classes=10)])
        del cells["resnet18"]["net"]
        fused = ("fused_block_stats", "fused_block_apply",
                 "fused_block_bwd_stats", "fused_block_bwd_apply",
                 "fused_block_stats_sm90", "fused_block_apply_sm90",
                 "fused_block_bwd_stats_sm90", "fused_block_bwd_apply_sm90")
        cells["resnet50"] = captured_cell(
            "resnet50_fused", "resnet50(224x224,1000 classes,BF16,"
            "Nesterovs(0.1,0.9),DL4J_TPU_FUSE_BLOCKS=1),b=256",
            lambda: zoo.resnet50(seed=SEED + 20),
            [DataSet(x, y) for x, y in resnet_batches(n, 256, SEED + 44)],
            expect=fused)
    phase_mfu(cells["resnet50"])
    del cells
    torch.cuda.empty_cache()
    capture_routes()
    phase("train_captured_total", seconds=f"{time.perf_counter() - t0:.1f}")


def phase_mfu(cell):
    """[mfu]: the ResNet-50 fused step's operations (step_cost_analysis:
    FlopCounterMode plus K4-K7's own counts) at b = 256, 224 x 224; the
    card's count equal to the plain CPU path's at image_size = 32; MFU of
    the captured step against the card's bf16 peak (utils/perf.py); and
    PerformanceListener(report_mfu=True) over eager steps."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.optimize.listeners import (
        PerformanceListener)
    from deeplearning4j_tpu_torch.utils.perf import peak_flops
    net, ds = cell["net"], cell["ds"]
    cost = net.step_cost_analysis(ds)
    kernels = cost["kernel_flops"]
    check(all(kernels.get(k, 0) > 0 for k in (
        "fused_block_stats", "fused_block_apply", "fused_block_bwd_stats",
        "fused_block_bwd_apply")), f"K4-K7 reported no operations: {kernels}")
    peak = peak_flops(torch.device("cuda"))
    check(peak is not None, f"no peak for {torch.cuda.get_device_name(0)}")
    # the host-clock step time of back-to-back replays: what training gets
    mfu = cost["flops"] / (cell["wall_ms"] / 1e3) / peak
    # the count at 32 x 32, card (K4-K7 report theirs) vs the CPU's plain
    # path (FlopCounterMode sees every product)
    x, y = resnet_batches(1, 8, SEED + 45, size=32, classes=10)[0]
    with fuse_blocks(True):
        small = zoo.resnet50(seed=SEED, image_size=32, n_classes=10)
        cpu = graph_copy(small, "cpu", True, dtype="float32")
    card_small = small.step_cost_analysis(DataSet(x, y))
    cpu_small = cpu.step_cost_analysis(DataSet(x.cpu(), y.cpu()))
    check(card_small["flops"] == cpu_small["flops"],
          f"step FLOPs at 32x32: card {card_small['flops']:.6e} vs CPU "
          f"plain path {cpu_small['flops']:.6e}")
    check(cpu_small["kernel_flops"] == {}, "the CPU path reported kernels")
    # the listener, over eager steps of the same net
    lst = PerformanceListener(frequency=1, report_mfu=True)
    net.set_listeners(lst)
    for _ in range(4):
        net.fit_batch(ds)
    torch.cuda.synchronize()
    net.set_listeners()
    mfus = [r.get("mfu") for r in lst.records]
    check(len(mfus) == 3 and all(m is not None and 0 < m <= 1 for m in mfus),
          f"PerformanceListener MFU records {lst.records}")
    phase("mfu", model="resnet50 fused, BF16, b=256, 224x224",
          flops_per_step=f"{cost['flops']:.6e}",
          kernel_flops_per_step=json.dumps(
              {k: f"{v:.4e}" for k, v in sorted(kernels.items())}),
          captured_step_ms_events=f"{cell['step_ms']:.3f}",
          captured_wall_ms_per_step=f"{cell['wall_ms']:.3f}",
          peak_flops=f"{peak:.4e}", mfu_captured=f"{mfu:.4f}",
          listener_mfu_eager=json.dumps([round(m, 4) for m in mfus]),
          flops_32x32_b8_card=f"{card_small['flops']:.6e}",
          flops_32x32_b8_cpu_plain=f"{cpu_small['flops']:.6e}")


def phase_conv_nets():
    phase_train_lenet()
    phase_train_vgg16()
    phase_train_resnet18()


# ---------------------------------------------------------------------------
# Slice 12: checkpoint and resume, the supervisor with fault injection, the
# full-batch solvers, gradient checks, transfer learning with frozen layers
# ---------------------------------------------------------------------------

# chaos_train's schedule (a crash during a save, a transient then a
# preemption, a crash again, a clean launch) at 24 steps, a checkpoint
# every 4: the recovery events (kind, step) each launch must emit, as the
# supervisor emits them on the CPU (tests/test_torch_resilience.py holds
# those to the JAX package's)
RES_STEPS, RES_EVERY = 24, 4
CHAOS_PLAN = [[("crash_save", 1)],
              [("transient", RES_STEPS // 3), ("preempt", RES_STEPS // 2)],
              [("crash_save", 1)],
              []]
CHAOS_EVENTS = [
    [("checkpoint", 0)],
    [("resume", 0), ("checkpoint", 4), ("retry", 8), ("retry", 8),
     ("checkpoint", 8), ("checkpoint", 12), ("gc", 12), ("checkpoint", 13),
     ("gc", 13), ("preempt", 13)],
    [("resume", 13), ("checkpoint", 16), ("gc", 16)],
    [("resume", 16), ("checkpoint", 20), ("gc", 20), ("checkpoint", 24),
     ("gc", 24)]]
CHAOS_OUTCOMES = ["crashed", "preempted", "crashed", "completed"]
# a step poisoned at 10 under the lazy sentinel (a check every 4): read at
# iteration 12, rolled back to step_8, LR scale 0.5
POISON_EVENTS = [("checkpoint", 0), ("checkpoint", 4), ("checkpoint", 8),
                 ("rollback", 8), ("checkpoint", 12), ("gc", 12),
                 ("checkpoint", 16), ("gc", 16), ("checkpoint", 20),
                 ("gc", 20), ("checkpoint", 24), ("gc", 24)]
# the SIGKILL child: 16 steps, killed at the boundary of step 10
KILL_STEPS, KILL_AT = 16, 10
# solvers: the card's first iteration vs the plain CPU path's, F32 LeNet:
# the same loss over 256 images summed in another order (relu and max-pool
# winners may differ at ties), so f_new to 1e-4 relative and the Armijo
# step exactly
SOLVER_FNEW_RTOL = 1e-4
SOLVER_ALGOS = ("lbfgs", "conjugate_gradient", "line_gradient_descent")
# VGG-16's layers: 13 convs and 5 pools (0-17), dense 18, 19, output 20
VGG_LAST_POOL, VGG_OUTPUT = 17, 20


def _arm(faults):
    from deeplearning4j_tpu_torch.resilience import FaultInjector
    inj = FaultInjector()
    for fault, at in faults:
        if fault == "crash_save":
            inj.crash_during_save(at)
        elif fault == "transient":
            inj.fail_step(at, times=2)
        elif fault == "preempt":
            inj.preempt_at_step(at)
        elif fault == "poison":
            inj.poison_step(at)
        elif fault == "kill":
            inj.kill_at_step(at)
    return inj


def _supervisor(net, ckpt, injector=None, **kw):
    from deeplearning4j_tpu_torch.resilience import (SupervisorConfig,
                                                     TrainingSupervisor)
    cfg = dict(checkpoint_every_steps=RES_EVERY, keep_checkpoints=3,
               backoff_initial_s=0.0, handle_sigterm=False,
               async_checkpoints=True)
    cfg.update(kw)
    return TrainingSupervisor(net, SupervisorConfig(checkpoint_dir=ckpt,
                                                    **cfg),
                              injector=injector)


def _host_trees(net):
    """Every tensor of params, state and opt_state, copied to the host."""
    from deeplearning4j_tpu_torch.nn import multistep
    return {(tn,) + path: t.detach().cpu().clone()
            for tn, path, t in multistep._tree_paths(net)}


def _trees_bit_equal(got, want, what):
    check(got.keys() == want.keys(), f"{what}: the trees' keys differ")
    bad = [".".join(map(str, k)) for k in want
           if not (got[k].dtype == want[k].dtype
                   and torch_equal_bits(got[k], want[k]))]
    check(not bad, f"{what}: {len(bad)} of {len(want)} tensors differ from "
          f"the uninterrupted run's, e.g. {bad[:4]}")
    return len(want)


def torch_equal_bits(a, b):
    import torch
    a, b = a.contiguous(), b.contiguous()
    if a.shape != b.shape:
        return False
    if a.dtype.is_floating_point and a.element_size() in (2, 4, 8):
        iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.view(iv), b.view(iv))
    return torch.equal(a, b)


def _dir_mb(path):
    total = 0
    for root, _, files in os.walk(path):
        total += sum(os.path.getsize(os.path.join(root, f)) for f in files)
    return total / 2**20


def _checkpoint_costs(net, ckpt):
    """The step path's snapshot (host ms of the call, ms until its clones
    are done), the writer's ms and MB for it, and the restore's ms into
    the live net."""
    import torch
    from deeplearning4j_tpu_torch.utils.checkpoint import (
        save_checkpoint, snapshot_for_checkpoint)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = snapshot_for_checkpoint(net)
    t1 = time.perf_counter()
    snap.ready.synchronize()
    t2 = time.perf_counter()
    path = os.path.join(ckpt, f"step_{net.iteration}")
    save_checkpoint(snap, path)
    t3 = time.perf_counter()
    sup = _supervisor(net, ckpt)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    sup._load_into(path)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    return snap, {"snapshot_host_ms": f"{(t1 - t0) * 1e3:.3f}",
                  "snapshot_ms": f"{(t2 - t0) * 1e3:.3f}",
                  "write_ms": f"{(t3 - t2) * 1e3:.1f}",
                  "write_mb": f"{_dir_mb(path):.1f}",
                  "restore_ms": f"{(t5 - t4) * 1e3:.1f}"}


def _chaos(make, batch_fn, ckpt, plan, **kw):
    """The plan's launches, each on a fresh net (resume from disk only),
    until one completes: (net, per-launch events, outcomes, per-relaunch
    ms from the new net to its first step read back)."""
    import torch
    from deeplearning4j_tpu_torch.resilience import InjectedCrash
    events, outcomes, first_step_ms, net = [], [], [], None
    for i, faults in enumerate(plan):
        t0 = time.perf_counter()
        net = make()
        inj = _arm(faults)
        sup = _supervisor(net, ckpt, inj, **kw)
        marks = []

        def timed_batch(step, marks=marks):
            marks.append(time.perf_counter())
            return batch_fn(step)

        try:
            with inj.installed():
                res = sup.run(timed_batch, RES_STEPS)
            outcomes.append(res.status)
        except InjectedCrash:
            outcomes.append("crashed")
        torch.cuda.synchronize()
        events.append([(e.kind, e.step) for e in sup.events])
        if i and len(marks) > 1:
            # the second batch is asked for once the first step's score
            # was read (a check every step): the relaunch's first step
            first_step_ms.append((marks[1] - t0) * 1e3)
        if outcomes[-1] == "completed":
            break
        del sup
    return net, events, outcomes, first_step_ms


def resilient_child(ckpt, kill, out):
    """A relaunchable training process for [resilient]: the char-RNN,
    supervised to KILL_STEPS with a checkpoint every RES_EVERY steps, a
    SIGKILL at step ``kill`` (None: none); writes its params to ``out``
    when it completes."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    data = on_card(markov_batches(8, 32, 64, 80, SEED + 50))
    net = zoo.char_rnn(seed=SEED)
    inj = _arm([] if kill is None else [("kill", kill)])
    res = _supervisor(net, ckpt, inj).run(lambda s: data[s % 8], KILL_STEPS)
    torch.save({k: v for k, v in _host_trees(net).items()}, out)
    print(f"CHILD {res.status} {res.final_step} {res.resumed_from}",
          flush=True)


def _run_child(ckpt, kill, out):
    code = (f"import chip_smoke as c; c.resilient_child({ckpt!r}, {kill!r}, "
            f"{out!r})")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))


def _step_cost_ms(make, batch_fn, ckpt, mode):
    """Host-clock ms a step over 32 back-to-back steps of a fresh net,
    after 8: ``mode`` "eager" (fit_batch), "captured" (the replayed step,
    fit_batch_repeated one batch at a time), or "supervised_<k>" (the
    TrainingSupervisor with a NaN check every k steps, no periodic
    checkpoint and a synchronous baseline, so no writer thread runs
    beside the steps timed; from the batch of step 8 to that of step 40,
    which covers the lazy sentinel's reads)."""
    import torch
    net = make()
    if mode.startswith("supervised_"):
        marks = {}

        def timed_batch(step):
            marks[step] = time.perf_counter()
            return batch_fn(step)

        _supervisor(net, ckpt, checkpoint_every_steps=10**6, resume=False,
                    async_checkpoints=False,
                    nan_check_every=int(mode.split("_")[1])).run(
                        timed_batch, 41)
        return (marks[40] - marks[8]) * 1e3 / 32
    step = (net.fit_batch if mode == "eager"
            else lambda ds: net.fit_batch_repeated(ds, 1))
    for i in range(8):
        step(batch_fn(i))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(8, 40):
        step(batch_fn(i))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / 32


STEP_COST_MODES = ("eager", "supervised_1", "supervised_8", "captured")


def phase_resilient():
    """[resilient]: the full-width char-RNN (hidden 512, 2 GravesLSTM,
    BF16, Adam; b = 32, T = 64; K1/K2 on the cluster route) under the
    TrainingSupervisor: chaos_train's schedule over fresh nets (resume
    from disk only, asynchronous checkpoints), the survivor's params equal
    an uninterrupted fit_batch run's bit for bit; a poisoned step rolled
    back with the LR backed off; SIGKILL of a child process and a second
    child resuming it; a restore into a net with a captured step. Then
    the step's cost supervised and not, and the checkpoint's costs."""
    import shutil
    import tempfile
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.ops import registry
    t_phase = time.perf_counter()
    out = {"model": "char_rnn(vocab=80,hidden=512,layers=2,BF16,Adam(2e-3))",
           "b": 32, "T": 64, "steps": RES_STEPS, "every": RES_EVERY}
    root = tempfile.mkdtemp(prefix="dl4j_resilient_")
    data = on_card(markov_batches(8, 32, 64, 80, SEED + 50))
    batch_fn = lambda step: data[step % 8]  # noqa: E731
    make = lambda: zoo.char_rnn(seed=SEED)  # noqa: E731
    try:
        # the uninterrupted run
        ref = make()
        for step in range(RES_STEPS):
            ref.fit_batch(batch_fn(step))
            if step == KILL_STEPS - 1:
                at16 = _host_trees(ref)
        want = _host_trees(ref)

        # the chaos run: the main path, counted
        registry.reset_launches()
        calls = [0]

        def counted(step):
            calls[0] += 1
            return batch_fn(step)

        net, events, outcomes, first_ms = _chaos(
            make, counted, os.path.join(root, "chaos"), CHAOS_PLAN)
        launches = registry.launches()
        check(outcomes == CHAOS_OUTCOMES, f"chaos outcomes {outcomes}")
        check(events == CHAOS_EVENTS, f"chaos events {events} != the "
              f"schedule's {CHAOS_EVENTS}")
        check(net.iteration == RES_STEPS, f"survivor at {net.iteration}")
        out["tensors_bit_identical"] = _trees_bit_equal(
            _host_trees(net), want, "chaos survivor")
        for k in ("lstm_fwd", "lstm_fwd_sm90", "lstm_bwd_sm90"):
            check(launches.get(k, 0) == 2 * calls[0],
                  f"{k} launched {launches.get(k, 0)} times in {calls[0]} "
                  f"supervised steps, expected {2 * calls[0]}")
        check(launches.get("lstm_bwd", 0) == 2 * lstm_launches_per_bwd()
              * calls[0], f"lstm_bwd launched {launches.get('lstm_bwd')}")
        out["chaos_steps_run"] = calls[0]
        out["chaos_launches"] = json.dumps(launches)
        out["relaunch_ms_to_first_step"] = json.dumps(
            [round(v, 1) for v in first_ms])
        del net
        # the survivor's checkpoint restores on the CPU, and a checkpoint
        # saved from the CPU restores on the card, bit for bit
        from deeplearning4j_tpu_torch.utils.checkpoint import (
            find_latest_checkpoint, restore_multi_layer_network,
            save_checkpoint)
        last = find_latest_checkpoint(os.path.join(root, "chaos"))
        on_cpu = restore_multi_layer_network(last, device="cpu")
        _trees_bit_equal(_host_trees(on_cpu), want, "card -> CPU restore")
        back = restore_multi_layer_network(save_checkpoint(
            on_cpu, os.path.join(root, "cpu", "step_24")))
        check(back.device.type == "cuda", f"restored on {back.device}")
        _trees_bit_equal(_host_trees(back), want, "CPU -> card restore")
        out["cross_device_restore"] = "card->cpu->card bit-identical"
        del on_cpu, back

        # a poisoned step: rollback and LR backoff under the lazy sentinel
        pnet, pev, pout, _ = _chaos(make, batch_fn,
                                    os.path.join(root, "poison"),
                                    [[("poison", 10)]], nan_check_every=4)
        check(pout == ["completed"] and pev == [POISON_EVENTS],
              f"poison run {pout} {pev}")
        check(pnet._lr_scale == 0.5, f"lr scale {pnet._lr_scale}")
        check(all(torch.isfinite(t).all().item()
                  for t in _host_trees(pnet).values()
                  if t.dtype.is_floating_point), "poison survived")
        out["poison_rollback"] = "step 10 -> step_8, lr scale 0.5"
        del pnet

        # SIGKILL: a child killed at step KILL_AT, a second one resumes
        kdir = os.path.join(root, "kill")
        first = _run_child(kdir, KILL_AT, os.path.join(root, "a.pt"))
        check(first.returncode == -9 and "CHILD" not in first.stdout,
              f"the killed child exited {first.returncode}: "
              f"{first.stderr[-1500:]}")
        second = _run_child(kdir, None, os.path.join(root, "b.pt"))
        check(second.returncode == 0 and "CHILD completed 16" in
              second.stdout, f"the resuming child: {second.returncode} "
              f"{second.stdout[-500:]} {second.stderr[-1500:]}")
        resumed = second.stdout.split()[-1]
        got = torch.load(os.path.join(root, "b.pt"))
        _trees_bit_equal(got, at16, "SIGKILL + resume")
        out["sigkill_resumed_from"] = os.path.basename(resumed)

        # restore into a net whose step is captured: the replays after it
        # rebind the restored leaves and continue the same trajectory
        cap = make()
        cap.fit_batch_repeated(data[0], 8)
        cpath = save_checkpoint(cap, os.path.join(root, "cap", "step_8"))
        cap.fit_batch_repeated(data[0], 4)
        want12 = _host_trees(cap)
        _supervisor(cap, os.path.join(root, "cap"))._load_into(cpath)
        cap.fit_batch_repeated(data[0], 4)
        sg = next(iter(cap._multi_steps.values()))
        check(sg.captures == 1, f"{sg.captures} captures")
        _trees_bit_equal(_host_trees(cap), want12, "captured after restore")
        out["captured_restore"] = f"bit-identical, {sg.replays} replays"
        del cap
        # a step's cost, in turns (each mode, then each in reverse order)
        costs = {m: [] for m in STEP_COST_MODES}
        for m in STEP_COST_MODES + STEP_COST_MODES[::-1]:
            costs[m].append(_step_cost_ms(make, batch_fn,
                                          os.path.join(root, f"t_{m}"), m))
        for m, v in costs.items():
            out[f"{m}_step_ms"] = "/".join(f"{x:.3f}" for x in v)
        _, ck = _checkpoint_costs(ref, os.path.join(root, "costs"))
        out.update(ck)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = f"{time.perf_counter() - t_phase:.1f}"
    phase("resilient", **out)


def phase_resilient_resnet():
    """[resilient_resnet]: ResNet-50 with the fusion pass (BF16, b = 256,
    13 tails on K4-K7 sm90, Nesterovs): supervised steps with a
    checkpoint, preempted, then a relaunch onto a fresh graph (the first
    freed first); params, BN state and Nesterov velocity after the resumed
    steps bit-identical to uninterrupted ones. Snapshot, write and restore
    costs, and the peak memory of a step with a snapshot held."""
    import shutil
    import tempfile
    import torch
    from deeplearning4j_tpu_torch import DataSet, zoo
    from deeplearning4j_tpu_torch.ops import registry
    t_phase = time.perf_counter()
    steps, b = 6, 256
    out = {"model": "resnet50(224x224,1000 classes,BF16,Nesterovs(0.1,0.9),"
                    "DL4J_TPU_FUSE_BLOCKS=1)", "b": b, "steps": steps}
    root = tempfile.mkdtemp(prefix="dl4j_resilient_resnet_")
    try:
        with fuse_blocks(True):
            make = lambda: zoo.resnet50(seed=SEED + 20)  # noqa: E731
            data = [DataSet(x, y) for x, y in resnet_batches(2, b, SEED + 45)]
            batch_fn = lambda step: data[step % 2]  # noqa: E731
            ref = make()
            check(len(ref._fusion_plans) == 13,
                  f"{len(ref._fusion_plans)} fused tails")
            for step in range(steps):
                ref.fit_batch(batch_fn(step))
            want = _host_trees(ref)
            # the checkpoint's costs, and a step's peak with a snapshot held
            snap, costs = _checkpoint_costs(ref, os.path.join(root, "costs"))
            out.update(costs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ref.fit_batch(batch_fn(0))
            torch.cuda.synchronize()
            out["peak_mb_step_with_snapshot"] = (
                f"{torch.cuda.max_memory_allocated() / 2**20:.0f}")
            del snap
            torch.cuda.reset_peak_memory_stats()
            ref.fit_batch(batch_fn(1))
            torch.cuda.synchronize()
            out["peak_mb_step"] = (
                f"{torch.cuda.max_memory_allocated() / 2**20:.0f}")
            del ref
            torch.cuda.empty_cache()

            registry.reset_launches()
            ckpt = os.path.join(root, "run")
            net = make()
            res = _supervisor(net, ckpt, _arm([("preempt", 3)]),
                              checkpoint_every_steps=3).run(batch_fn, steps)
            check(res.status == "preempted" and res.final_step == 4,
                  f"first launch {res.status} at {res.final_step}")
            del net, res
            torch.cuda.empty_cache()
            marks = {}

            def timed_batch(step):
                marks[step] = time.perf_counter()
                return batch_fn(step)

            t0 = time.perf_counter()
            net = make()
            res = _supervisor(net, ckpt, checkpoint_every_steps=3).run(
                timed_batch, steps)
            # the batch of step 5 is asked for once step 4's score was
            # read: the relaunch's first step is done
            out["relaunch_ms_to_first_step"] = f"{(marks[5] - t0) * 1e3:.1f}"
            check(res.status == "completed" and
                  res.resumed_from.endswith("step_4"),
                  f"relaunch {res.status} from {res.resumed_from}")
            launches = registry.launches()
            for k in ("fused_block_stats_sm90", "fused_block_apply_sm90",
                      "fused_block_bwd_stats_sm90",
                      "fused_block_bwd_apply_sm90"):
                check(launches.get(k, 0) == 13 * steps,
                      f"{k} launched {launches.get(k, 0)} times in {steps} "
                      f"supervised steps, expected {13 * steps}")
            out["launches"] = json.dumps(launches)
            out["tensors_bit_identical"] = _trees_bit_equal(
                _host_trees(net), want, "resnet50 resumed")
            out["events"] = json.dumps([(e.kind, e.step) for e in res.events])
            del net
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    out["phase_s"] = f"{time.perf_counter() - t_phase:.1f}"
    phase("resilient_resnet", **out)


def phase_solvers():
    """[solvers]: L-BFGS, conjugate gradient and line gradient descent on
    LeNet (F32) over one full batch of 256 images: the card's first
    iteration (Armijo step, f_new) held to the plain CPU path's, the loss
    falls; ms and loss evaluations an iteration."""
    import torch
    from deeplearning4j_tpu_torch import DataSet, zoo
    from deeplearning4j_tpu_torch.optimize.solvers import Solver
    from deeplearning4j_tpu_torch.ops import registry
    xs, ys = lenet_data(256, SEED + 70)
    card_ds = DataSet(torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda())
    registry.reset_launches()
    for algo in SOLVER_ALGOS:
        net = zoo.lenet(seed=SEED + 71, dtype=zoo.F32)
        cpu = mln_copy(net, "cpu")
        s0 = net.score(card_ds, train=True)
        first = Solver.ALGOS[algo](cpu, max_iterations=1)
        first.optimize(DataSet(xs, ys))
        solver = Solver.ALGOS[algo](net, max_iterations=20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.optimize(card_ds)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        (a, fnew), (ca, cfnew) = solver.first_step, first.first_step
        check(a == ca and abs(fnew - cfnew) <= SOLVER_FNEW_RTOL * abs(cfnew),
              f"{algo} first iteration: card (step {a}, f {fnew}) vs CPU "
              f"(step {ca}, f {cfnew})")
        check(math.isfinite(res.score) and res.score < s0,
              f"{algo}: score {s0} -> {res.score}")
        phase("solvers", algo=algo, model="lenet(28x28x1,F32)", b=256,
              iterations=res.iterations, converged=res.converged,
              score0=f"{s0:.5f}", score=f"{res.score:.5f}",
              first_step=a, first_f_new=f"{fnew:.6f}",
              first_f_new_cpu=f"{cfnew:.6f}",
              ms_per_iteration=f"{dt / res.iterations:.2f}",
              probes_per_iteration=f"{solver.probes / res.iterations:.2f}")
    check_no_kernel_launched("solvers on lenet")


def _gradcheck_net(device):
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (DtypePolicy, InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu_torch.nn.conf.layers_conv import (
        BatchNorm, Convolution2D, Subsampling)
    from deeplearning4j_tpu_torch.nn.updater import Sgd
    f64 = DtypePolicy(param_dtype="float64", compute_dtype="float64")
    conf = (NeuralNetConfiguration.builder().seed(SEED + 90).updater(Sgd(0.1))
            .dtype(f64).list()
            .layer(Convolution2D(n_out=4, kernel=(3, 3),
                                 activation="identity"))
            .layer(BatchNorm(activation="relu"))
            .layer(Subsampling(kernel=(2, 2), stride=(2, 2), pooling="max"))
            .layer(Dense(n_out=6, activation="tanh"))
            .layer(Output(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 2)).build())
    return MultiLayerNetwork(conf, device=device).init()


def phase_gradcheck():
    """[gradcheck]: central differences against autograd on the card, F64:
    conv 3x3 -> BN relu -> max pool -> dense -> softmax (cuDNN's f64
    convolution and pooling, the composed BN); 0 failures, and a planted
    wrong gradient caught. A GravesLSTM in F64 on the card refuses by name
    (its kernels take f32 and bf16)."""
    import torch
    from deeplearning4j_tpu_torch import DataSet, zoo
    from deeplearning4j_tpu_torch.nn.conf import DtypePolicy
    from deeplearning4j_tpu_torch.nn.precision import tree_grads
    from deeplearning4j_tpu_torch.nn.updater import _map
    from deeplearning4j_tpu_torch.utils.gradient_check import (
        check_network_gradients)
    rng = np.random.default_rng(SEED + 91)
    x = torch.from_numpy(rng.normal(size=(6, 8, 8, 2))).cuda()
    y = torch.from_numpy(np.eye(3)[rng.integers(0, 3, 6)]).cuda()
    net = _gradcheck_net(None)
    ds = DataSet(x, y)
    t0 = time.perf_counter()
    res = check_network_gradients(net, ds, sample_per_leaf=32, seed=0)
    dt = time.perf_counter() - t0
    check(res.passed, f"gradient check failed: {res.failures[:3]}")
    batch = net._step_batch(ds)

    def wrong(params):
        leaves = _map(lambda t: t.detach().clone().requires_grad_(), params)
        loss, _ = net._loss(leaves, net.state, *batch, gen=None, train=True)
        grads = tree_grads(loss, leaves)
        grads["layer_3"]["W"] = grads["layer_3"]["W"] * 1.5
        return grads

    planted = check_network_gradients(net, ds, sample_per_leaf=32, seed=0,
                                      grad_fn=wrong)
    check(planted.total_failed > 0 and {f["param"] for f in
                                        planted.failures}
          == {"['layer_3']['W']"}, f"the planted gradient was not caught "
          f"alone: {planted.total_failed} failures")
    lstm = zoo.char_rnn(hidden=8, vocab_size=6, seed=SEED,
                        dtype=DtypePolicy(param_dtype="float64",
                                          compute_dtype="float64"))
    xr = np.eye(6)[rng.integers(0, 6, (2, 5))]
    try:
        check_network_gradients(lstm, DataSet(xr, xr), sample_per_leaf=2)
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    check(refused is not None and "float32 or bfloat16" in refused,
          f"an F64 GravesLSTM check on the card was not refused: {refused}")
    phase("gradcheck", net="conv3x3(4)-BN-relu-maxpool-dense(6)-softmax,F64,"
          "8x8x2,b=6", checked=res.total_checked, failed=res.total_failed,
          max_rel_error=f"{res.max_rel_error:.3e}", seconds=f"{dt:.2f}",
          planted_failed=f"{planted.total_failed}/{planted.total_checked}",
          lstm_f64="refused")


def phase_transfer():
    """[transfer]: VGG-16 at full width (224 x 224, BF16, b = 32) frozen
    through its last conv block, the output replaced by 10 classes: after
    eager and captured steps the frozen params bit-unchanged, the tail's
    moved; the frozen step beside the whole net's, eager and captured;
    TransferLearningHelper.featurize's ms."""
    import torch
    from deeplearning4j_tpu_torch import DataSet, zoo
    from deeplearning4j_tpu_torch.nn import multistep
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        TransferLearning, TransferLearningHelper)
    from deeplearning4j_tpu_torch.nn.updater import Nesterovs
    from deeplearning4j_tpu_torch.ops import registry
    t_phase = time.perf_counter()
    b = 32
    out = {"model": f"vgg16(224x224x3,BF16,Nesterovs({VGG_LR},0.9))",
           "b": b, "frozen_through": VGG_LAST_POOL, "n_out": 10}
    registry.reset_launches()
    net = zoo.vgg16(seed=SEED + 80, updater=Nesterovs(VGG_LR, 0.9))
    new = (TransferLearning.Builder(net)
           .set_feature_extractor(VGG_LAST_POOL)
           .n_out_replace(VGG_OUTPUT, 10).build())
    frozen = multistep.frozen_layers(new)
    check(len(frozen) == VGG_LAST_POOL + 1, f"{len(frozen)} frozen layers")

    def step_ms(m, data):
        for i in range(3):
            m.fit_batch(data[i % 2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(8):
            m.fit_batch(data[i % 2])
        torch.cuda.synchronize()
        eager = (time.perf_counter() - t0) * 1e3 / 8
        for i in range(5):    # warm-ups, capture, a replay
            m.fit_batch_repeated(data[i % 2], 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(8):
            m.fit_batch_repeated(data[i % 2], 1)
        torch.cuda.synchronize()
        return eager, (time.perf_counter() - t0) * 1e3 / 8

    whole = [DataSet(x, y) for x, y in vgg_batches(2, b, SEED + 81)]
    eager, captured = step_ms(net, whole)
    out["whole_step_ms_eager"] = f"{eager:.3f}"
    out["whole_step_ms_captured"] = f"{captured:.3f}"
    del net, whole
    torch.cuda.empty_cache()

    data = [DataSet(x, y) for x, y in vgg_batches(2, b, SEED + 82,
                                                  classes=10)]
    before = {n: {k: t.clone() for k, t in sub.items()}
              for n, sub in new.params.items()}
    eager, captured = step_ms(new, data)
    out["frozen_step_ms_eager"] = f"{eager:.3f}"
    out["frozen_step_ms_captured"] = f"{captured:.3f}"
    sg = next(iter(new._multi_steps.values()))
    check(sg.captures == 1 and sg.replays >= 8, f"{sg.captures} captures, "
          f"{sg.replays} replays")
    moved = []
    for n, sub in before.items():
        for k, t in sub.items():
            same = torch.equal(new.params[n][k], t)
            if n in frozen:
                check(same, f"frozen {n}.{k} changed")
            elif not same:
                moved.append(f"{n}.{k}")
    check(len(moved) == 6, f"the tail's params that moved: {moved}")
    out["frozen_tensors_unchanged"] = sum(len(before[n]) for n in frozen
                                          if n in before)
    out["tail_tensors_moved"] = len(moved)
    helper = TransferLearningHelper(new, VGG_LAST_POOL)
    helper.featurize(data[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = helper.featurize(data[1])
    torch.cuda.synchronize()
    out["featurize_ms"] = f"{(time.perf_counter() - t0) * 1e3:.3f}"
    check(tuple(feats.features.shape) == (b, 7, 7, 512),
          f"features {tuple(feats.features.shape)}")
    check_no_kernel_launched("transfer on vgg16")
    del new, data, before, helper, feats
    torch.cuda.empty_cache()
    out["phase_s"] = f"{time.perf_counter() - t_phase:.1f}"
    phase("transfer", **out)


def binary_images(n, seed):
    """``n`` 784-pixel binary images: ten random binary class templates,
    5% of each image's pixels flipped. Made on the host from a seed."""
    rng = np.random.default_rng(seed)
    templates = rng.random((10, 784)) > 0.5
    x = templates[rng.integers(0, 10, n)].astype(np.float32)
    flip = rng.random(x.shape) < 0.05
    x[flip] = 1 - x[flip]
    return x


def _pretrain_ms(net, idx, it, epochs):
    """pretrain_layer's ms a step (host clock, ending in a synchronize)."""
    import torch
    steps0 = net.iteration
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.pretrain_layer(idx, it, epochs=epochs)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (net.iteration - steps0)


def phase_pretrain():
    """[pretrain]: a VAE (784 -> 256 -> 256 -> 32, Bernoulli, F32) and an
    AutoEncoder/RBM stack (784 -> 256 -> 128, F32) pretrained layer-wise
    at b = 128 on 1,280 binary template images, on the card: the -ELBO (at
    fixed draws of epsilon), the VAE's reconstruction error and the AE's
    reconstruction loss (at a fixed corruption mask) fall; ms a step."""
    import torch
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import Output
    from deeplearning4j_tpu_torch.nn.conf.layers_pretrain import (
        RBM, AutoEncoder, BernoulliReconstruction, VariationalAutoencoder)
    from deeplearning4j_tpu_torch.nn.updater import Adam
    from deeplearning4j_tpu_torch.ops import registry
    registry.reset_launches()
    b, epochs = 128, 4
    xs = binary_images(1280, SEED + 95)
    x = torch.from_numpy(xs).cuda()
    it = ArrayDataSetIterator(xs, None, batch_size=b)

    conf = (NeuralNetConfiguration.builder().seed(SEED + 96)
            .updater(Adam(1e-3)).list()
            .layer(VariationalAutoencoder(
                n_in=784, n_out=32, encoder_layer_sizes=(256, 256),
                decoder_layer_sizes=(256, 256), activation="tanh",
                reconstruction=BernoulliReconstruction()))
            .layer(Output(n_out=10, activation="softmax", loss="mcxent"))
            .build())
    vnet = MultiLayerNetwork(conf).init()
    vae = vnet.layers[0]
    eps = torch.randn((1, 1280, 32), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(
                          SEED + 97))

    def vae_eval():
        with torch.no_grad():
            p = vnet.params[vae.name]
            return (float(vae.pretrain_loss(p, x, None, eps=eps)),
                    float(vae.reconstruction_error(p, x)))

    elbo0, rec0 = vae_eval()
    vae_ms = _pretrain_ms(vnet, 0, it, epochs)
    elbo1, rec1 = vae_eval()
    check(elbo1 < elbo0 and rec1 < rec0, f"VAE pretraining: -ELBO "
          f"{elbo0:.3f} -> {elbo1:.3f}, reconstruction {rec0:.3f} -> "
          f"{rec1:.3f}")
    phase("pretrain", model="vae(784-256-256-32,Bernoulli,F32,Adam(1e-3))",
          b=b, steps=vnet.iteration, neg_elbo=f"{elbo0:.3f}->{elbo1:.3f}",
          reconstruction_error=f"{rec0:.3f}->{rec1:.3f}",
          ms_per_step=f"{vae_ms:.3f}")

    conf = (NeuralNetConfiguration.builder().seed(SEED + 98)
            .updater(Adam(1e-3)).list()
            .layer(AutoEncoder(n_in=784, n_out=256, activation="sigmoid",
                               corruption_level=0.3, loss="xent"))
            .layer(RBM(n_out=128, k=1))
            .layer(Output(n_out=10, activation="softmax", loss="mcxent"))
            .build())
    snet = MultiLayerNetwork(conf).init()
    ae, rbm = snet.layers[0], snet.layers[1]

    def ae_loss():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 99)
        with torch.no_grad():
            return float(ae.pretrain_loss(snet.params[ae.name], x, gen))

    def rbm_recon():
        with torch.no_grad():
            h = snet.feed_forward(x)[0]
            p = snet.params[rbm.name]
            return float(((rbm._propdown(p, rbm._propup(p, h)) - h) ** 2
                          ).mean())

    ae0 = ae_loss()
    ae_ms = _pretrain_ms(snet, 0, it, epochs)
    ae1 = ae_loss()
    check(ae1 < ae0, f"AutoEncoder pretraining: loss {ae0:.4f} -> {ae1:.4f}")
    rbm0 = rbm_recon()
    rbm_ms = _pretrain_ms(snet, 1, it, epochs)
    rbm1 = rbm_recon()
    check(math.isfinite(rbm1), f"RBM reconstruction {rbm1}")
    check_no_kernel_launched("pretrain")
    phase("pretrain", model="autoencoder(784-256,xent,corruption=0.3)+"
          "rbm(256-128,k=1),F32,Adam(1e-3)", b=b, steps=snet.iteration,
          ae_loss=f"{ae0:.4f}->{ae1:.4f}", ae_ms_per_step=f"{ae_ms:.3f}",
          rbm_reconstruction_mse=f"{rbm0:.5f}->{rbm1:.5f}",
          rbm_ms_per_step=f"{rbm_ms:.3f}")


def phase_slice12():
    """The phases of slice 12, in order."""
    phase_resilient()
    phase_resilient_resnet()
    phase_solvers()
    phase_gradcheck()
    phase_transfer()
    phase_pretrain()


# --------------------------------------------------------------------------
# slice 13: the data-fed, observed training run
# --------------------------------------------------------------------------
# the char-RNN's token stream: 12 batches of b = 32 windows of T = 64 an
# epoch, cut from one text of markov_batches' order-2 chain over 80
# printable symbols (chr(33) ...), shuffled over the whole epoch
DP_V, DP_T, DP_B, DP_BATCHES, DP_EPOCHS, DP_EVERY = 80, 64, 32, 12, 3, 4
DP_SHUFFLE_WINDOW = 512
DP_ALPHABET = "".join(chr(33 + i) for i in range(DP_V))
# the fault schedule over fit_pipeline's 36 steps, one launch each, every
# one on a fresh net and a fresh pipeline, resumed from disk only: a
# crash mid-epoch 1 (step 18 keeps failing past its 3 retries), a crash
# inside the relaunch's second save, a SIGTERM mid-epoch 2 (at step 30),
# a clean relaunch
DP_PLAN = [[("crash_step", 18)], [("crash_save", 1)], [("sigterm", 30)], []]
DP_OUTCOMES = ["crashed", "crashed", "preempted", "completed"]
# the recovery events (kind, step) each launch must emit, as the port's
# supervisor emits them on the CPU for this schedule (the CPU tests hold
# its fit_pipeline events to the JAX package's)
DP_EVENTS = [
    [("checkpoint", 0), ("checkpoint", 4), ("checkpoint", 8),
     ("checkpoint", 12), ("gc", 12), ("retry", 18), ("retry", 18),
     ("retry", 18), ("checkpoint", 16), ("gc", 16)],
    [("resume", 16), ("checkpoint", 20), ("gc", 20)],
    [("resume", 20), ("checkpoint", 24), ("gc", 24), ("checkpoint", 28),
     ("gc", 28), ("checkpoint", 31), ("gc", 31), ("preempt", 31)],
    [("resume", 31), ("checkpoint", 32), ("gc", 32), ("checkpoint", 36),
     ("gc", 36)]]
# the ledger's invariant, as the JAX package's CI holds it
LEDGER_ATTRIBUTED_SHARE = 0.95
# the cost of observing, as the JAX package budgets it (bench.py's
# trace_overhead and identity_overhead): reported against, not gated
TRACE_BUDGET, FLIGHT_BUDGET = 0.03, 0.01
# where the phases' traces go (beside this script, as the kernel listings)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "profile_out")


def markov_text(n, V, seed):
    """``n`` symbols of markov_batches' order-2 chain as one text over V
    printable characters (chr(33) ...)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, V, (V, 2, 3))
    succ = table[:, np.arange(V) % 2].transpose(1, 0, 2)  # [a, b, 3]
    seq = np.empty(n, np.int64)
    seq[:2] = rng.integers(0, V, 2)
    pick = rng.choice(3, size=n, p=[0.6, 0.3, 0.1])
    for t in range(2, n):
        seq[t] = succ[seq[t - 2], seq[t - 1], pick[t]]
    return "".join(chr(33 + int(i)) for i in seq)


def dp_corpus():
    """A text of DP_BATCHES * DP_B full windows of DP_T + 1 tokens each
    (one token shared between neighbours)."""
    return markov_text(DP_BATCHES * DP_B * DP_T + 1, DP_V, SEED + 60)


def dp_pipeline(corpus, depth=2, window=DP_SHUFFLE_WINDOW, t=DP_T, b=DP_B):
    """from_text -> tokenize -> window(T) -> shuffle -> batch(b) ->
    prefetch(depth) (no prefetch stage at depth 0)."""
    from deeplearning4j_tpu_torch import datapipe
    tok = datapipe.CharTokenizer(DP_ALPHABET)
    check(tok.vocab_size == DP_V, f"vocab {tok.vocab_size}")
    pipe = (datapipe.from_text(corpus).tokenize(tok)
            .window(t, vocab_size=DP_V)
            .shuffle(window=window, seed=SEED + 61)
            .batch(b, drop_last=True))
    return pipe.prefetch(depth) if depth else pipe


def batch_hash(ds):
    """sha256 of a batch's features and labels (host arrays)."""
    import hashlib
    h = hashlib.sha256(np.ascontiguousarray(ds.features).tobytes())
    h.update(np.ascontiguousarray(ds.labels).tobytes())
    return h.hexdigest()[:16]


def record_batches(net, kept):
    """Wraps ``net.fit_batch`` so each batch it trains on is kept in
    ``kept`` (a reference; hashed after the run, so the step path pays an
    append)."""
    step = net.fit_batch

    def fit_batch(ds):
        kept.append(ds)
        return step(ds)

    net.fit_batch = fit_batch
    return net


def _arm_dp(faults):
    from deeplearning4j_tpu_torch.resilience import FaultInjector
    inj = FaultInjector()
    for fault, at in faults:
        if fault == "crash_step":
            inj.fail_step(at, times=4)       # past max_step_retries = 3
        elif fault == "crash_save":
            inj.crash_during_save(at)
        elif fault == "sigterm":
            inj.sigterm_at_step(at)
    return inj


def dp_chaos(make, corpus, ckpt, plan=DP_PLAN):
    """DP_PLAN's launches through fit_pipeline, each on a fresh net and a
    fresh pipeline (resume from disk only, the SIGTERM handler installed,
    a new incarnation a relaunch), until one completes. Returns (net,
    per-launch events, outcomes, per-launch batch hashes, reports of the
    launches that returned, the flight files, steps run)."""
    from deeplearning4j_tpu_torch.observability import distributed as odist
    from deeplearning4j_tpu_torch.resilience import (InjectedCrash,
                                                     TransientStepError)
    events, outcomes, hashes, reports, net = [], [], [], [], None
    for i, faults in enumerate(plan):
        if i:
            odist.bump_incarnation()
        kept = []
        net = record_batches(make(), kept)
        inj = _arm_dp(faults)
        sup = _supervisor(net, ckpt, inj, handle_sigterm=True,
                          checkpoint_every_steps=DP_EVERY)
        try:
            with inj.installed():
                res = sup.fit_pipeline(dp_pipeline(corpus), epochs=DP_EPOCHS)
            outcomes.append(res.status)
            reports.append(res.report)
        except (InjectedCrash, TransientStepError):
            outcomes.append("crashed")
        events.append([(e.kind, e.step) for e in sup.events])
        hashes.append([batch_hash(ds) for ds in kept])
        if outcomes[-1] == "completed":
            break
        del sup
    flights = sorted(n for n in os.listdir(ckpt) if n.startswith("flight_"))
    return (net, events, outcomes, hashes, reports, flights,
            sum(len(h) for h in hashes))


def check_report(report, what):
    """A RunReport whose exclusive phases account for its wall time within
    the JAX package's 5%; returns its summary."""
    from deeplearning4j_tpu_torch.observability.goodput import RunReport
    check(isinstance(report, RunReport), f"{what}: report {report!r}")
    share = report.attributed_s / report.wall_s
    check(share >= LEDGER_ATTRIBUTED_SHARE, f"{what}: the ledger attributes "
          f"{share:.4f} of {report.wall_s:.3f} s: {report.phases}")
    return {"wall_s": round(report.wall_s, 4), "attributed": round(share, 4),
            "goodput": report.goodput_fraction and round(
                report.goodput_fraction, 4),
            "steps": report.steps}


def phase_datapipe_resilient(make=None, corpus=None, root=None):
    """[datapipe_resilient]: the full-width char-RNN (hidden 512, 2
    GravesLSTM, BF16, Adam(2e-3); b = 32, T = 64; K1/K2 on the cluster
    route) fed by a datapipe (from_text -> tokenize -> window -> shuffle
    over the epoch -> batch -> prefetch 2) through fit_pipeline: DP_PLAN's
    crashes, SIGTERM and relaunches on fresh nets and pipelines against
    one uninterrupted fit_pipeline run. Gates: params and Adam slots bit
    for bit, the batches trained on (a hash each), the events, the flight
    files, the RunReports' attribution, K1/K2's launches. Also writes the
    uninterrupted run's Chrome trace to profile_out/."""
    import shutil
    import tempfile
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.observability import flightrec
    from deeplearning4j_tpu_torch.observability import trace as otrace
    from deeplearning4j_tpu_torch.ops import registry
    t_phase = time.perf_counter()
    make = make or (lambda: zoo.char_rnn(seed=SEED))
    corpus = corpus or dp_corpus()
    root = root or tempfile.mkdtemp(prefix="dl4j_datapipe_")
    out = {"model": "char_rnn(vocab=80,hidden=512,layers=2,BF16,Adam(2e-3))",
           "pipeline": f"from_text.tokenize.window({DP_T}).shuffle("
                       f"{DP_SHUFFLE_WINDOW}).batch({DP_B}).prefetch(2)",
           "epochs": DP_EPOCHS, "batches_per_epoch": DP_BATCHES,
           "every": DP_EVERY}
    steps = DP_EPOCHS * DP_BATCHES
    try:
        # the step's FLOP count, which a ledger run derives once a net and
        # batch signature (flops_derive): its first call in the process
        # and a second one
        probe = make()
        b0 = next(iter(dp_pipeline(corpus, depth=0)))
        derive_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            flops = probe.step_cost_analysis(b0)["flops"]
            torch.cuda.synchronize()
            derive_s.append(time.perf_counter() - t0)
        out["flops_derive_s_first_second"] = "/".join(
            f"{v:.3f}" for v in derive_s)
        out["step_gflop"] = f"{flops / 1e9:.2f}"
        del probe
        # the uninterrupted run, traced from a fresh ring: its Chrome
        # trace shows the main loop, the prefetch worker and the writer
        tracer = otrace.Tracer()
        prev = otrace.set_tracer(tracer)
        try:
            kept = []
            ref = record_batches(make(), kept)
            ref_res = _supervisor(
                ref, os.path.join(root, "ref"),
                checkpoint_every_steps=DP_EVERY,
                keep_checkpoints=steps).fit_pipeline(
                    dp_pipeline(corpus), epochs=DP_EPOCHS)
        finally:
            otrace.set_tracer(prev)
        check(ref_res.status == "completed" and ref.iteration == steps,
              f"uninterrupted run {ref_res.status} at {ref.iteration}")
        ref_hashes = [batch_hash(ds) for ds in kept]
        del kept
        check(len(set(ref_hashes[:DP_BATCHES])) == DP_BATCHES
              and ref_hashes[:DP_BATCHES] != ref_hashes[DP_BATCHES:
                                                       2 * DP_BATCHES],
              "the epochs' orders repeat")
        want = _host_trees(ref)
        out["uninterrupted_report"] = json.dumps(check_report(
            ref_res.report, "uninterrupted"))
        out["uninterrupted_phases_s"] = json.dumps(
            {k: round(v["seconds"], 4)
             for k, v in ref_res.report.phases.items()})
        trace_doc = tracer.to_chrome_trace()
        lanes = sorted({e["args"]["name"] for e in trace_doc["traceEvents"]
                        if e["ph"] == "M"})
        for lane in ("dl4j-pipe-prefetch", "dl4j-ckpt-writer",
                     threading.current_thread().name):
            check(lane in lanes, f"no {lane} lane in the trace: {lanes}")
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "fit_pipeline_trace.json"),
                  "w") as f:
            json.dump(trace_doc, f)
        out["trace_lanes"] = json.dumps(lanes)
        out["trace_spans"] = len(tracer.spans())
        # meta.json across the run: the pipeline's state is O(window),
        # so it shrinks through each epoch as the shuffle window drains
        sizes = {}
        for name in os.listdir(os.path.join(root, "ref")):
            meta = os.path.join(root, "ref", name, "meta.json")
            if name.startswith("step_") and os.path.isfile(meta):
                sizes[int(name[5:])] = os.path.getsize(meta) / 2**20
        out["meta_json_mb_by_step"] = json.dumps(
            {k: round(v, 2) for k, v in sorted(sizes.items())})
        del ref

        # the chaos run: the main path, counted
        registry.reset_launches()
        net, events, outcomes, hashes, reports, flights, run = dp_chaos(
            make, corpus, os.path.join(root, "chaos"))
        launches = registry.launches()
        check(outcomes == DP_OUTCOMES, f"outcomes {outcomes}")
        check(events == DP_EVENTS, f"events {events} != the schedule's "
              f"{DP_EVENTS}")
        check(net.iteration == steps, f"survivor at {net.iteration}")
        out["tensors_bit_identical"] = _trees_bit_equal(
            _host_trees(net), want, "datapipe chaos survivor")
        resumes = [dict(ev).get("resume", 0) for ev in events]
        for i, got in enumerate(hashes):
            start = resumes[i]
            check(got == ref_hashes[start:start + len(got)],
                  f"launch {i}: the batches trained on differ from the "
                  f"uninterrupted run's from step {start}")
            end = resumes[i + 1] if i + 1 < len(hashes) else steps
            check(start + len(got) >= end, f"launch {i} stopped at "
                  f"{start + len(got)}, the next resumed at {end}")
        check(resumes[-1] + len(hashes[-1]) == steps, "the last launch")
        out["batches_identical"] = run
        for k in ("lstm_fwd", "lstm_fwd_sm90", "lstm_bwd_sm90"):
            check(launches.get(k, 0) == 2 * run,
                  f"{k} launched {launches.get(k, 0)} times in {run} "
                  f"supervised steps, expected {2 * run}")
        check(launches.get("lstm_bwd", 0) == 2 * lstm_launches_per_bwd()
              * run, f"lstm_bwd launched {launches.get('lstm_bwd')}")
        out["steps_run"] = run
        out["chaos_launches"] = json.dumps(launches)
        out["events"] = json.dumps(events)
        # the flight files: one a launch that ended badly, each schema 1
        check(len(flights) >= 3, f"flight files {flights}")
        docs = {}
        for name in flights:
            with open(os.path.join(root, "chaos", name)) as f:
                docs[name] = json.load(f)
            check(docs[name]["schema"] == 1, f"{name} schema")
        preempted = [d for d in docs.values() if d["reason"] == "preemption"]
        check(len(preempted) == 1 and ("preempt", resumes[3]) in [
            (e["kind"], e["step"]) for e in preempted[0]["events"]],
            f"no preemption flight record naming step {resumes[3]}: "
            f"{[(n, d['reason']) for n, d in docs.items()]}")
        out["flight_files"] = json.dumps({n: d["reason"]
                                          for n, d in docs.items()})
        out["reports"] = json.dumps([check_report(r, f"launch {i + 2}")
                                     for i, r in enumerate(reports)])
        del net
    finally:
        flightrec.uninstall_flight_recorder()
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = f"{time.perf_counter() - t_phase:.1f}"
    phase("datapipe_resilient", **out)


def pipeline_rate(pipe, epochs=1):
    """The pipeline alone, consumed as fast as it gives: batches/s and
    MB/s of features and labels, host clock over ``epochs`` epochs."""
    n, nbytes = 0, 0
    t0 = time.perf_counter()
    for _ in range(epochs):
        for ds in pipe:
            n += 1
            nbytes += ds.features.nbytes + ds.labels.nbytes
    dt = time.perf_counter() - t0
    pipe.close()
    return n / dt, nbytes / dt / 1e6


def fit_ms(net, it, epochs=1, **fit_kw):
    """Host-clock ms a step of one ``fit(it, epochs=epochs, **fit_kw)``,
    from a synchronize before to one after."""
    import torch
    steps0 = net.iteration
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(it, epochs=epochs, **fit_kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (net.iteration - steps0)


FEED_MODES = (("eager", dict(multi_step=1)), ("captured", dict(multi_step=8)))
# epochs a timed fit of [datapipe_feed] runs: 84 char-RNN steps, enough
# for a fit's one-time start-up (threads, a stream, the ledger) to
# amortize, as the JAX package's 80-step ledger test has it
FEED_TIMED_EPOCHS = 7


def traced_fit_ms(net, it, epochs=1, **fit_kw):
    """``fit_ms`` with a fresh tracer. Also returns the fit thread's own
    ``data_wait`` seconds (the pipeline's internal spans run on the
    prefetching threads, and the RunReport's phases sum every thread)
    and where the fit thread's time outside every span went: ms before
    its first span, after its last (to fit's return), and the three
    largest stretches between spans, each with the span it follows."""
    import torch
    from deeplearning4j_tpu_torch.observability import trace as otrace
    tracer = otrace.Tracer()
    prev = otrace.set_tracer(tracer)
    steps0 = net.iteration
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(it, epochs=epochs, **fit_kw)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        otrace.set_tracer(prev)
    me = threading.get_ident()
    mine = sorted((sp for sp in tracer.spans() if sp.tid == me),
                  key=lambda sp: sp.ts_us)
    wait = sum(sp.dur_us for sp in mine if sp.name == "data_wait") / 1e6
    at = lambda us: tracer._epoch + us / 1e6  # noqa: E731
    gaps, end, after = [], mine[0].ts_us, "start"
    for sp in mine:
        gaps.append((round((sp.ts_us - end) / 1e3, 3), after))
        if sp.ts_us + sp.dur_us > end:
            end, after = sp.ts_us + sp.dur_us, sp.name
    untracked = {"head_ms": round((at(mine[0].ts_us) - t0) * 1e3, 3),
                 "tail_ms": round((t1 - at(end)) * 1e3, 3),
                 "between_top_ms": sorted(gaps, reverse=True)[:3],
                 "between_sum_ms": round(sum(g for g, _ in gaps), 3),
                 "host_ms": round((t1 - t0) * 1e3, 3)}
    return (t2 - t0) * 1e3 / (net.iteration - steps0), wait, untracked


def profile_kernels(fn, steps, top=6):
    """torch.profiler over ``fn()``: the device's busy share of the host
    clock, device ms a step, and the ``top`` kernels by device time (ms a
    step, by kind)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof.key_averages())
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(dev_ms > 0, "the profiler saw no device time")
    by_kind = {}
    for e in kernels:
        k = kernel_kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3
    return {"busy": round(dev_ms / wall_ms, 3),
            "device_ms": round(dev_ms / steps, 3),
            "wall_ms": round(wall_ms / steps, 3),
            "by_kind_ms": {k: round(v / steps, 3) for k, v in sorted(
                by_kind.items(), key=lambda kv: -kv[1])[:top]}}


def feed_cell(name, make, make_pipe, gate_ledger, timed=FEED_TIMED_EPOCHS):
    """One [datapipe_feed] cell: for eager and captured (chunks of 8)
    steps, two fresh nets, one fed by ``fit(pipe)`` and one by the same
    batches from memory (a twin pipeline's, materialized): epoch 0 warms
    up (and captures), the next ``timed`` epochs are timed (memory, then
    pipeline, one fit each), one more runs under the profiler. Gates:
    after them the two nets' params, updater and layer state are
    bit-identical (the same batches in the same order); with
    ``gate_ledger`` the timed fits' RunReports attribute their wall time
    within 5% (but a captured fit from memory's: reported). Reported: step ms pipeline vs memory, the fit thread's
    data_wait share, the ledger's goodput beside the profiler's busy
    share, the device time by kind."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    twin = make_pipe()
    mem = [list(twin) for _ in range(timed + 2)]
    twin.close()
    steps = len(mem[0])
    out, gates = {}, []
    for mode, kw in FEED_MODES:
        p_net, m_net = make(), make()
        pipe = make_pipe()
        p_net.fit(pipe, epochs=1, **kw)
        m_net.fit(ListDataSetIterator(mem[0]), epochs=1, **kw)
        m_ms, _, m_gaps = traced_fit_ms(m_net, ListDataSetIterator(
            [ds for epoch in mem[1:1 + timed] for ds in epoch]), **kw)
        m_rep = m_net.last_run_report
        p_ms, wait, p_gaps = traced_fit_ms(p_net, pipe, epochs=timed, **kw)
        rep = p_net.last_run_report
        prof = profile_kernels(lambda: p_net.fit(pipe, epochs=1, **kw),
                               steps)
        # the ledger's goodput for the same (profiled) steps
        prof["ledger_goodput"] = round(
            p_net.last_run_report.goodput_fraction or 0.0, 4)
        m_net.fit(ListDataSetIterator(mem[timed + 1]), epochs=1, **kw)
        pipe.close()
        n = _trees_bit_equal(_host_trees(p_net), _host_trees(m_net),
                             f"{name} {mode}: pipeline-fed vs memory-fed")
        reports = {"pipeline": rep, "memory": m_rep}
        shares = {k: r.attributed_s / r.wall_s for k, r in reports.items()}
        if gate_ledger:
            for src, share in shares.items():
                # a captured fit from memory is a host loop of ~1 ms a
                # batch, where the spans' own recording (~30 µs a batch,
                # outside every span) is a few percent: reported only
                if (mode, src) != ("captured", "memory") and \
                        share < LEDGER_ATTRIBUTED_SHARE:
                    gates.append(
                        f"{name} {mode} fit from {src}: the ledger "
                        f"attributes {share:.4f} of "
                        f"{reports[src].wall_s:.4f} s: "
                        f"{reports[src].phases}")
        out[f"{mode}_step_ms_pipeline"] = f"{p_ms:.3f}"
        out[f"{mode}_step_ms_memory"] = f"{m_ms:.3f}"
        out[f"{mode}_ledger"] = json.dumps({
            "fit_thread_data_wait_share": round(wait / rep.wall_s, 4),
            "goodput": rep.goodput_fraction and round(
                rep.goodput_fraction, 4),
            "memory_goodput": m_rep.goodput_fraction and round(
                m_rep.goodput_fraction, 4),
            "attributed": {k: round(v, 4) for k, v in shares.items()},
            "untracked": {"pipeline": p_gaps, "memory": m_gaps}})
        out[f"{mode}_profile"] = json.dumps(prof)
        out[f"{mode}_tensors_bit_identical"] = n
        if mode == "captured":
            out["captured_graphs"] = json.dumps(
                [(sg.captures, sg.replays)
                 for sg in p_net._multi_steps.values()])
        del p_net, m_net
    return out, gates


def bucket_graphs(make, corpus):
    """bucket_batch under capture: documents of varied lengths cut into
    windows of up to T, padded to the power-of-two ladder and batched
    per bucket; fit(multi_step=8) keeps one StepGraph per batch
    signature. Returns (signatures, captures, replays, eager steps)."""
    from deeplearning4j_tpu_torch import datapipe
    rng = np.random.default_rng(SEED + 62)
    cuts = np.sort(rng.choice(np.arange(1, len(corpus)), 47, replace=False))
    docs = [corpus[a:b] for a, b in zip(np.r_[0, cuts], np.r_[cuts,
                                                            len(corpus)])]
    tok = datapipe.CharTokenizer(DP_ALPHABET)
    pipe = (datapipe.from_text(docs).tokenize(tok)
            .window(DP_T, vocab_size=DP_V).bucket_batch(DP_B))
    net = make()
    net.fit(pipe, epochs=1, multi_step=8)
    graphs = list(net._multi_steps.values())
    report = net.last_run_report
    return (len(graphs), sum(g.captures for g in graphs),
            sum(g.replays for g in graphs), net.iteration,
            report.padding.get("datapipe_bucket_batch"))


def phase_datapipe_feed(make_rnn=None, make_lenet=None, corpus=None,
                        lenet_n=64 * 24):
    """[datapipe_feed]: does the pipeline keep the card fed? The
    char-RNN's pipeline alone (batches/s, MB/s; prefetch 0 and 2), then
    fit(pipe) eager and captured beside the same batches from memory; the
    same for LeNet (b = 64) through from_arrays -> shuffle -> normalize ->
    batch(64); bucket_batch's graphs under capture. Reported only, but
    the pipeline-fed and memory-fed nets must end bit-identical."""
    from deeplearning4j_tpu_torch import datapipe, zoo
    t_phase = time.perf_counter()
    make_rnn = make_rnn or (lambda: zoo.char_rnn(seed=SEED))
    make_lenet = make_lenet or (lambda: zoo.lenet(seed=SEED))
    corpus = corpus or dp_corpus()
    out = {}
    for depth in (0, 2, 2, 0):
        rate, mbs = pipeline_rate(dp_pipeline(corpus, depth), epochs=2)
        out.setdefault(f"rnn_pipe_prefetch{depth}_batches_per_s",
                       []).append(round(rate, 1))
        out.setdefault(f"rnn_pipe_prefetch{depth}_mb_per_s",
                       []).append(round(mbs, 1))
    rnn, gates = feed_cell("char-RNN", make_rnn, lambda: dp_pipeline(corpus),
                           gate_ledger=True)
    out.update({f"rnn_{k}": v for k, v in rnn.items()})
    x, y = lenet_data(lenet_n, SEED + 63)

    def lenet_pipe():
        return (datapipe.from_arrays(x, y).shuffle(window=256, seed=SEED + 64)
                .normalize().batch(64))

    rate, mbs = pipeline_rate(lenet_pipe())
    out["lenet_pipe_batches_per_s"] = round(rate, 1)
    out["lenet_pipe_mb_per_s"] = round(mbs, 1)
    lenet, _ = feed_cell("LeNet", make_lenet, lenet_pipe, gate_ledger=False,
                         timed=3)
    out.update({f"lenet_{k}": v for k, v in lenet.items()})
    sigs, caps, reps, it, pad = bucket_graphs(make_rnn, corpus)
    out["bucket_batch_graphs"] = json.dumps(
        {"signatures": sigs, "captures": caps, "replays": reps,
         "steps": it, "padding": pad})
    for k, v in list(out.items()):
        if isinstance(v, list):
            out[k] = "/".join(str(e) for e in v)
    out["phase_s"] = f"{time.perf_counter() - t_phase:.1f}"
    phase("datapipe_feed", **out)
    # the ledger's gate, after the line: its numbers say what missed
    check(not gates, "; ".join(gates))


def phase_observability(make=None, corpus=None):
    """[observability]: the cost of observing. Step ms of the char-RNN
    fit from memory (48 steps a reading), eager and captured, with the
    tracer on and with DL4J_TPU_TRACE=0's tracer, in turns (on, off, off,
    on, twice; the medians compared); then with and without the
    flight recorder installed (tracer on), in turns;
    a torch.profiler trace of an eager epoch in which the fit loop's span
    names appear (profile_out/profiler_trace.json)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.observability import flightrec
    from deeplearning4j_tpu_torch.observability import trace as otrace
    t_phase = time.perf_counter()
    make = make or (lambda: zoo.char_rnn(seed=SEED))
    corpus = corpus or dp_corpus()
    pipe = dp_pipeline(corpus, depth=0)
    mem = list(pipe) + list(pipe)
    prev = otrace.get_tracer()
    out = {}
    flightrec.uninstall_flight_recorder()

    def tracer(on):
        old = os.environ.get("DL4J_TPU_TRACE")
        os.environ["DL4J_TPU_TRACE"] = "1" if on else "0"
        try:
            return otrace._env_default()
        finally:
            if old is None:
                del os.environ["DL4J_TPU_TRACE"]
            else:
                os.environ["DL4J_TPU_TRACE"] = old

    try:
        for mode, kw in FEED_MODES:
            net = make()
            net.fit(ListDataSetIterator(mem), epochs=1, **kw)   # warm-up
            ms = {"on": [], "off": []}
            for which in ("on", "off", "off", "on") * 2:
                otrace.set_tracer(tracer(which == "on"))
                ms[which].append(fit_ms(net, ListDataSetIterator(mem),
                                        epochs=2, **kw))
            otrace.set_tracer(tracer(True))
            fl = {"installed": [], "not": []}
            for which in ("not", "installed", "installed", "not") * 2:
                if which == "installed":
                    flightrec.install_flight_recorder(
                        dir=os.path.join(OUT_DIR, "flight"))
                fl[which].append(fit_ms(net, ListDataSetIterator(mem),
                                        epochs=2, **kw))
                flightrec.uninstall_flight_recorder()
            med = {k: statistics.median(v) for k, v in ms.items()}
            fmed = {k: statistics.median(v) for k, v in fl.items()}
            out[f"{mode}_step_ms_trace_on"] = "/".join(
                f"{v:.3f}" for v in ms["on"])
            out[f"{mode}_step_ms_trace_off"] = "/".join(
                f"{v:.3f}" for v in ms["off"])
            out[f"{mode}_trace_overhead"] = \
                f"{med['on'] / med['off'] - 1:+.4f}"
            out[f"{mode}_step_ms_flight_installed"] = "/".join(
                f"{v:.3f}" for v in fl["installed"])
            out[f"{mode}_step_ms_flight_not"] = "/".join(
                f"{v:.3f}" for v in fl["not"])
            out[f"{mode}_flight_overhead"] = \
                f"{fmed['installed'] / fmed['not'] - 1:+.4f}"
            if mode == "eager":
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    net.fit(ListDataSetIterator(mem[:4]), epochs=1, **kw)
                    torch.cuda.synchronize()
                names = {e.key for e in prof.key_averages()}
                spans = sorted(n for n in ("data_wait", "host_dispatch",
                                           "device_step") if n in names)
                check(len(spans) == 3, f"span names in the profile: {spans}")
                os.makedirs(OUT_DIR, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    OUT_DIR, "profiler_trace.json"))
                out["profiler_span_names"] = json.dumps(spans)
            del net
    finally:
        otrace.set_tracer(prev)
        flightrec.uninstall_flight_recorder()
    out["budgets"] = json.dumps({"trace": TRACE_BUDGET,
                                 "flight": FLIGHT_BUDGET})
    out["phase_s"] = f"{time.perf_counter() - t_phase:.1f}"
    phase("observability", **out)


def phase_slice13():
    """The phases of slice 13, in order."""
    phase_datapipe_resilient()
    phase_datapipe_feed()
    phase_observability()


# --------------------------------------------------------------------------
# slice 14: the ComputationGraph's recurrent path, every vertex type and the
# remaining layer types, remat spans
# --------------------------------------------------------------------------
# DL4J's CompGraphLSTMExample at full width: 80 symbols, two GravesLSTMs of
# 512 with a skip connection (both merged into the head), tBPTT of 50 over
# examples of 1000 characters, b = 32
GT_V, GT_H, GT_L, GT_T, GT_B, GT_BATCHES = 80, 512, 50, 1000, 32, 3
# the extra batch held against the plain CPU path (4 windows: seconds)
GT_CHECK_T = 200
# [graph_stream]: rows, characters each, and the prefix held one-shot
GS_ROWS, GS_STEPS, GS_PREFIX = 4, 300, 32
# streamed vs one-shot probabilities of the trained BF16 graph: PROB_TOL
# (1e-2), [stream]'s bound, for its reason: each call stores the carry c
# in bf16, the one-shot loop keeps it in f32 within the call, and a
# trained net magnifies the rounding. On this graph's trained weights
# (--save-stream, then scripts/stream_vs_one_shot.py) the JAX package's
# Pallas LSTM, which does the same, reads 7.57e-3, the port's plain CPU
# path 7.56e-3 and the card 9.15e-3; the JAX package's XLA scan (bf16
# batches of other than 16k rows) rounds c at every step, one-shot too,
# and reads 8.7e-4; any two of these bf16 paths' one-shot outputs lie
# 8.3e-3 to 1.15e-2 apart. The card's stream is held against the CPU's
# at the same bound (7.61e-3). The char-RNN tests' BF16_PROB_TOL (2e-3,
# tests/test_torch_char_rnn.py, set on random weights) holds the same
# graph before training, and the carry itself is held under F32, where
# nothing is rounded between calls: STREAM_F32_TOL.
BF16_PROB_TOL = 2e-3
STREAM_F32_TOL = 1e-5
# --save-stream (with --slice14): where [graph_stream] writes its graph
# and probabilities (save_stream)
STREAM_OUT = os.path.join("chiprun_out", "graph_stream")
# [graph_layers] card vs CPU (and rewrites on vs off), F64: the same f64
# arithmetic in another order is ~1e-15 off
F64_REL_TOL = 1e-9
# [remat]: ResNet-50 unfused at b = 256, 2 steps an arm
REMAT_SPANS = "s0b,s1b,s2b,s3b"
REMAT_B, REMAT_STEPS = 256, 2


def skip_char_rnn(device=None, seed=SEED, tbptt=GT_L):
    """The skip-connected char-RNN as a ComputationGraph: in -> first ->
    second; merge(first, second) -> out. BF16, Adam(2e-3)."""
    from deeplearning4j_tpu_torch import ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import (
        GravesLSTM, RnnOutput)
    from deeplearning4j_tpu_torch.nn.conf.vertices import MergeVertex
    from deeplearning4j_tpu_torch.nn.updater import Adam
    from deeplearning4j_tpu_torch.zoo.models import BF16
    g = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(2e-3))
         .dtype(BF16).graph_builder().add_inputs("in")
         .add_layer("first", GravesLSTM(n_out=GT_H, activation="tanh"), "in")
         .add_layer("second", GravesLSTM(n_out=GT_H, activation="tanh"),
                    "first")
         .add_vertex("merge", MergeVertex(), "first", "second")
         .add_layer("out", RnnOutput(n_out=GT_V, activation="softmax",
                                     loss="mcxent"), "merge")
         .set_outputs("out").set_input_types(InputType.recurrent(GT_V)))
    if tbptt:
        g = g.backprop_type("tbptt", tbptt, tbptt)
    return ComputationGraph(g.build(), device=device).init()


def mds_on(batches, device="cuda"):
    import torch
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    return [MultiDataSet([torch.from_numpy(x).to(device)],
                         [torch.from_numpy(y).to(device)])
            for x, y in batches]


def phase_graph_tbptt():
    """The skip-connected char-RNN graph trained with tBPTT at full width:
    3 batches of 20 windows through fit_batch, K1/K2 counted on the
    cluster route, the carries spied; one more batch of 4 windows held
    against the plain CPU path. Returns (net, launches)."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    chunks = GT_T // GT_L
    net = skip_char_rnn()
    batches = markov_batches(GT_BATCHES, GT_B, GT_T, GT_V, SEED + 14)
    data = mds_on(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    h0_sums, scores, events = [], [], []
    registry.reset_launches()
    with carry_spy(h0_sums):
        for ds in data:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            scores.append(net.fit_batch(ds))
            end.record()
            events.append((start, end))
            check(net.state == {}, f"carries left in the state after a "
                  f"batch: {list(net.state)}")
        torch.cuda.synchronize()
    launches = registry.launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    batch_ms = [s.elapsed_time(e) for s, e in events]
    scores = [float(s) for s in scores]
    check(all(math.isfinite(s) for s in scores), f"graph tBPTT scores "
          f"{scores}")
    check(net.iteration == GT_BATCHES, f"iteration {net.iteration}")
    for k, per_call in (("lstm_fwd", 1), ("lstm_fwd_sm90", 1),
                        ("lstm_bwd", lstm_launches_per_bwd()),
                        ("lstm_bwd_sm90", 1)):
        want = 2 * chunks * GT_BATCHES * per_call
        check(launches.get(k, 0) == want,
              f"{k} launched {launches.get(k, 0)} times in graph tBPTT, "
              f"expected {want}")
    per_batch = 2 * chunks
    check(len(h0_sums) == per_batch * GT_BATCHES,
          f"{len(h0_sums)} forward-kernel calls seen")
    for i in range(GT_BATCHES):
        got = h0_sums[i * per_batch:(i + 1) * per_batch]
        check(got[0] == 0.0 and got[1] == 0.0,
              f"batch {i}: the first window did not start from a zero carry")
        check(all(v > 0.0 for v in got[2:]),
              f"batch {i}: windows 2-{chunks} did not get a nonzero carry")
    # where a window's device time goes, over one more batch
    prof = profile_steps(net, data[:1])
    by_kind = json.loads(prof["prof_by_kind_ms_and_kernels_per_step"])
    dev_batch = float(prof["prof_device_ms_per_step"])
    lstm_ms = by_kind.get("lstm", [0.0])[0]
    # the extra batch: card and CPU from the same trees
    x, y = markov_batches(1, GT_B, GT_CHECK_T, GT_V, SEED + 15)[0]
    cpu = graph_copy(net, "cpu", fuse=False, opt_state=True)
    card_score = float(net.fit_batch(mds_on([(x, y)])[0]))
    t0 = time.perf_counter()
    cpu_score = float(cpu.fit_batch(mds_on([(x, y)], "cpu")[0]))
    cpu_s = time.perf_counter() - t0
    err = abs(card_score - cpu_score) / abs(cpu_score)
    check(err <= TBPTT_SCORE_RTOL, f"graph tBPTT T = {GT_CHECK_T} card vs "
          f"CPU: {err:.3e} > {TBPTT_SCORE_RTOL}")
    med = statistics.median(batch_ms)
    phase("graph_tbptt", model=f"skip_char_rnn(vocab={GT_V},hidden={GT_H},"
          f"layers=2,merge,BF16,Adam(2e-3))", tbptt=GT_L, T=GT_T, b=GT_B,
          batches=GT_BATCHES, windows=chunks,
          scores=json.dumps([round(s, 4) for s in scores]),
          batch_ms=json.dumps([round(v, 3) for v in batch_ms]),
          window_ms_median=f"{med / chunks:.4f}",
          prof_device_ms_per_window=f"{dev_batch / chunks:.4f}",
          prof_k1_k2_ms_per_window=f"{lstm_ms / chunks:.4f}",
          prof_rest_ms_per_window=f"{(dev_batch - lstm_ms) / chunks:.4f}",
          prof_device_busy_share=prof["prof_device_busy_share"],
          prof_by_kind_ms_and_kernels_per_batch=prof[
              "prof_by_kind_ms_and_kernels_per_step"],
          peak_mb=f"{peak_mb:.0f}",
          carry_h0_abs_sum=json.dumps([round(v, 1)
                                       for v in h0_sums[:6]]),
          launches=json.dumps(launches), check_T=GT_CHECK_T,
          check_score_card=f"{card_score:.5f}",
          check_score_cpu=f"{cpu_score:.5f}", score_vs_cpu_rel=f"{err:.3e}",
          tol=TBPTT_SCORE_RTOL, cpu_check_batch_s=f"{cpu_s:.2f}")
    return net, launches


def stream_probs(net, eye, chars):
    """rnn_time_step over ``chars`` (a list of [rows] index tensors) from a
    cleared stream: the probabilities, [rows, len(chars), V]."""
    import torch
    net.rnn_clear_previous_state()
    out = torch.stack([net.rnn_time_step(eye[c]) for c in chars], dim=1)
    net.rnn_clear_previous_state()
    return out.float()


def save_stream(out_dir, net, seq, streamed, one_shot, cpu_stream,
                cpu_one_shot):
    """The trained graph as a zip both packages read, and the prefix with
    the card's and the plain CPU path's probabilities over it, for
    scripts/stream_vs_one_shot.py."""
    from deeplearning4j_tpu_torch.utils.serialization import (
        write_computation_graph)
    os.makedirs(out_dir, exist_ok=True)
    write_computation_graph(net, os.path.join(out_dir, "skip_char_rnn.zip"))
    np.savez(os.path.join(out_dir, "stream.npz"),
             prefix=seq.cpu().numpy(), card_stream=streamed.cpu().numpy(),
             card_one_shot=one_shot.cpu().numpy(),
             cpu_stream=cpu_stream.numpy(),
             cpu_one_shot=cpu_one_shot.numpy())


def phase_graph_stream(net=None, save_dir=None):
    """The trained graph served one character at a time: GS_ROWS rows of
    GS_STEPS rnn_time_step calls, each sampling the next character from
    the returned probabilities (a seeded generator on the card); the
    first GS_PREFIX steps against one-shot ``output`` on the card, and
    against the plain CPU path's stream; the same prefix under F32 and
    through the graph before training. ``save_dir``: where
    save_stream writes the graph and the probabilities. Returns the
    launches."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    net = net if net is not None else skip_char_rnn(tbptt=None)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    eye = torch.eye(GT_V, device="cuda")
    cur = torch.randint(0, GT_V, (GS_ROWS,), generator=gen, device="cuda")
    chars, probs, host_ms = [cur], [], []
    net.rnn_clear_previous_state()
    torch.cuda.synchronize()
    registry.reset_launches()
    t0 = time.perf_counter()
    for _ in range(GS_STEPS):
        h0 = time.perf_counter()
        p = net.rnn_time_step(eye[cur])
        cur = torch.multinomial(p.float(), 1, generator=gen)[:, 0]
        host_ms.append((time.perf_counter() - h0) * 1e3)
        probs.append(p)
        chars.append(cur)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = registry.launches()
    for k in ("lstm_fwd", "lstm_fwd_sm90"):
        check(launches.get(k, 0) == 2 * GS_STEPS,
              f"{k} launched {launches.get(k, 0)} times in {GS_STEPS} "
              f"streamed calls, expected {2 * GS_STEPS}")
    check(tuple(probs[0].shape) == (GS_ROWS, GT_V),
          f"a single step returned {tuple(probs[0].shape)}")
    check(all(bool(torch.isfinite(p).all()) for p in probs[::50]),
          "streamed probabilities not finite")
    prefix = chars[:GS_PREFIX]
    seq = torch.stack(prefix, dim=1)
    streamed = torch.stack(probs[:GS_PREFIX], dim=1).float()
    one_shot = net.output(eye[seq]).float()
    err = float((streamed - one_shot).abs().max())
    check(err <= PROB_TOL, f"streamed vs one-shot over the first "
          f"{GS_PREFIX} characters: {err:.3e} > {PROB_TOL}")
    net.rnn_clear_previous_state()
    again = net.rnn_time_step(eye[chars[0]])
    check(torch.equal(again, probs[0]), "rnn_clear_previous_state: the "
          "next call differs from a fresh stream's first")
    net.rnn_clear_previous_state()
    # the same prefix on the plain CPU path, and under F32 on the card
    cpu = graph_copy(net, "cpu", fuse=False, opt_state=True)
    eye_c, prefix_c = eye.cpu(), [c.cpu() for c in prefix]
    cpu_stream = stream_probs(cpu, eye_c, prefix_c)
    cpu_one_shot = cpu.output(eye_c[seq.cpu()]).float()
    cpu_err = float((cpu_stream - cpu_one_shot).abs().max())
    card_vs_cpu = float((streamed.cpu() - cpu_stream).abs().max())
    one_shot_vs_cpu = float((one_shot.cpu() - cpu_one_shot).abs().max())
    if save_dir is not None:
        save_stream(save_dir, net, seq, streamed, one_shot, cpu_stream,
                    cpu_one_shot)
    f32 = graph_copy(net, "cuda", fuse=False, dtype="float32")
    f32_err = float((stream_probs(f32, eye, prefix)
                     - f32.output(eye[seq]).float()).abs().max())
    check(f32_err <= STREAM_F32_TOL, f"F32 streamed vs one-shot: "
          f"{f32_err:.3e} > {STREAM_F32_TOL}")
    check(card_vs_cpu <= PROB_TOL, f"the card's stream vs the plain CPU "
          f"path's: {card_vs_cpu:.3e} > {PROB_TOL}")
    fresh = skip_char_rnn(tbptt=None)
    fresh_err = float((stream_probs(fresh, eye, prefix)
                       - fresh.output(eye[seq]).float()).abs().max())
    check(fresh_err <= BF16_PROB_TOL, f"untrained graph: streamed vs "
          f"one-shot {fresh_err:.3e} > {BF16_PROB_TOL}")
    phase("graph_stream", rows=GS_ROWS, steps=GS_STEPS,
          host_ms_per_call_median=f"{statistics.median(host_ms):.4f}",
          chars_per_s=f"{GS_ROWS * GS_STEPS / wall:.1f}",
          wall_s=f"{wall:.3f}", launches=json.dumps(launches),
          prefix=GS_PREFIX, max_abs_err_vs_one_shot=f"{err:.3e}",
          tol=PROB_TOL, cpu_stream_vs_one_shot=f"{cpu_err:.3e}",
          card_vs_cpu_stream=f"{card_vs_cpu:.3e}",
          card_vs_cpu_one_shot=f"{one_shot_vs_cpu:.3e}",
          f32_stream_vs_one_shot=f"{f32_err:.3e}",
          f32_tol=STREAM_F32_TOL,
          untrained_stream_vs_one_shot=f"{fresh_err:.3e}",
          untrained_tol=BF16_PROB_TOL, clear_restarts="equal")
    return launches


def layers_graph(device=None):
    """One small F64 graph with every vertex type and each layer type of
    slice 14 (tests/test_torch_vertices.py's ``_layers_graph``): its stem
    (5x5/s2 on 3 channels) and a 1x1/s2 projection meet the gates of the
    two exact conv rewrites."""
    from deeplearning4j_tpu_torch import ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf import layers_conv as C
    from deeplearning4j_tpu_torch.nn.conf import layers_recurrent as R
    from deeplearning4j_tpu_torch.nn.conf import vertices as V
    from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as it
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
        CnnToFeedForward)
    from deeplearning4j_tpu_torch.nn.updater import Adam
    pol = DtypePolicy(param_dtype="float64", compute_dtype="float64")
    g = (NeuralNetConfiguration.builder().seed(11).updater(Adam(1e-2))
         .dtype(pol).graph_builder()
         .add_inputs("seq", "img", "static", "ids"))
    g.add_layer("c1", C.Convolution1D(n_out=6, kernel=3, mode="same",
                                      activation="tanh"), "seq")
    g.add_layer("sub1", C.Subsampling1D(kernel=2, stride=1, mode="same",
                                        pooling="pnorm", pnorm=2), "c1")
    g.add_layer("tdd", R.TimeDistributedDense(n_out=5, activation="tanh"),
                "sub1")
    g.add_vertex("lts", V.LastTimeStepVertex(mask_input="seq"), "tdd")
    g.add_vertex("dup", V.DuplicateToTimeSeriesVertex(seq_input="seq"),
                 "static")
    g.add_vertex("merge_t", V.MergeVertex(), "tdd", "dup")
    g.add_layer("gp", C.GlobalPooling(pooling="avg"), "merge_t")
    g.add_vertex("subset", V.SubsetVertex(from_index=2, to_index=6), "gp")
    g.add_vertex("stack", V.StackVertex(), "lts", "subset")
    g.add_vertex("un0", V.UnstackVertex(index=0, stack_size=2), "stack")
    g.add_vertex("un1", V.UnstackVertex(index=1, stack_size=2), "stack")
    g.add_vertex("l2", V.L2Vertex(), "un0", "un1")
    g.add_layer("zp", C.ZeroPadding(pad=(1, 1, 1, 1)), "img")
    g.add_layer("stem", C.Convolution2D(n_out=4, kernel=(5, 5),
                                        stride=(2, 2), mode="same",
                                        activation="relu"), "zp")
    g.add_layer("conv", C.Convolution2D(n_out=4, kernel=(3, 3),
                                        mode="same", activation="tanh"),
                "stem")
    g.add_layer("lrn", C.LocalResponseNormalization(n=3, alpha=0.1), "conv")
    g.add_vertex("merge_c", V.MergeVertex(), "lrn", "stem")
    g.add_layer("pool", C.Subsampling(kernel=(3, 3), stride=(2, 2),
                                      pooling="pnorm", pnorm=3), "merge_c")
    g.add_vertex("pv", V.PreprocessorVertex(
        preprocessor=CnnToFeedForward(4, 4, 8)), "pool")
    g.add_layer("proj", C.Convolution2D(n_out=4, kernel=(1, 1),
                                        stride=(2, 2), has_bias=False,
                                        activation="identity"), "merge_c")
    g.add_layer("gpi", C.GlobalPooling(pooling="sum"), "proj")
    g.add_layer("emb", L.Embedding(n_in=7, n_out=3, activation="identity"),
                "ids")
    g.add_vertex("merge_f", V.MergeVertex(), "l2", "pv", "emb", "un0",
                 "gpi")
    g.add_layer("drop", L.Dropout(), "merge_f")
    g.add_vertex("scale", V.ScaleVertex(factor=0.5), "drop")
    g.add_vertex("l2n", V.L2NormalizeVertex(), "scale")
    g.add_vertex("ew", V.ElementWiseVertex(op="add"), "l2n", "scale")
    g.add_layer("dense", L.Dense(n_out=2, activation="tanh"), "ew")
    g.add_layer("out", L.Output(n_out=3, activation="softmax",
                                loss="mcxent"), "ew")
    g.add_layer("loss", L.LossLayer(loss="mse", activation="identity"),
                "dense")
    conf = (g.set_outputs("out", "loss")
            .set_input_types(it.recurrent(4, 6), it.convolutional(16, 16, 3),
                             it.feed_forward(4), it.feed_forward(1))
            .build())
    return ComputationGraph(conf, device=device).init()


def layers_data(device, b=8):
    import torch
    rng = np.random.default_rng(SEED + 17)
    f = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    mask = np.ones((b, 6))
    mask[1, 4:] = 0.0
    mask[2, 2:] = 0.0
    feats = [f(rng.normal(size=(b, 6, 4))), f(rng.normal(size=(b, 16, 16, 3))),
             f(rng.normal(size=(b, 4))),
             f(rng.integers(0, 7, (b, 1)).astype(np.int32))]
    labels = [f(np.eye(3)[rng.integers(0, 3, b)]), f(rng.normal(size=(b, 2)))]
    return feats, labels, [f(mask), None, None, None]


def layers_outputs(net, feats, labels, fmasks):
    """(outputs, score, {param: gradient}) of one training walk."""
    import torch
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    outs = net.output(*feats, masks=fmasks)
    leaves = {ln: {k: t.detach().clone().requires_grad_()
                   for k, t in lp.items()} for ln, lp in net.params.items()}
    loss, _ = net._loss(leaves, net.state,
                        *net._batch(MultiDataSet(feats, labels, fmasks)),
                        gen=net._gen)
    keys = [(ln, k) for ln in leaves for k in leaves[ln]]
    grads = torch.autograd.grad(loss, [leaves[ln][k] for ln, k in keys])
    return outs, loss.detach(), dict(zip(keys, grads))


def rel_err(got, want):
    """max |got - want| over max |want| (0 where want is all zeros)."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    top = float(w.abs().max())
    return float((g - w).abs().max()) / top if top else float(
        (g - w).abs().max())


def phase_graph_layers():
    """The vertex-rich F64 graph on the card against the CPU from the same
    parameters (outputs, score, every gradient), then with both conv
    rewrites on against them off, on the card."""
    import torch
    from deeplearning4j_tpu_torch.ops import convolution as conv_ops
    cpu = layers_graph(device="cpu")
    card = graph_copy(cpu, "cuda", fuse=False, opt_state=True)
    errs = {}
    c_out, c_loss, c_g = layers_outputs(cpu, *layers_data("cpu"))
    d_out, d_loss, d_g = layers_outputs(card, *layers_data("cuda"))
    for i, (a, b) in enumerate(zip(d_out, c_out)):
        errs[f"out{i}"] = rel_err(a, b)
    errs["score"] = rel_err(d_loss, c_loss)
    for key, g in c_g.items():
        errs[".".join(key)] = rel_err(d_g[key], g)
    worst_cpu = max(errs.values())
    check(worst_cpu <= F64_REL_TOL, f"F64 graph card vs CPU: "
          + json.dumps({k: v for k, v in errs.items() if v > F64_REL_TOL}))
    # run to run: with cuDNN's defaults, and with its deterministic flag,
    # where every other op of the graph (the embedding's F.embedding
    # backward, LRN's unfold, the pools) must give the same bits
    _, _, again = layers_outputs(card, *layers_data("cuda"))
    varies = sorted(".".join(k) for k in d_g
                    if not torch.equal(again[k], d_g[k]))
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        det = [layers_outputs(card, *layers_data("cuda"))[2]
               for _ in range(2)]
    det_varies = sorted(".".join(k) for k in d_g
                        if not torch.equal(det[0][k], det[1][k]))
    check(not det_varies, f"gradients differ run to run under cuDNN's "
          f"deterministic flag: {det_varies}")
    taken = {"conv2d_space_to_depth": 0, "conv2d_strided_1x1_as_slice": 0}
    reals = {name: getattr(conv_ops, name) for name in taken}

    def counted(name):
        def call(*a, **k):
            taken[name] += 1
            return reals[name](*a, **k)
        return call

    flags = ("DL4J_TPU_S2D_STEM", "DL4J_TPU_SLICE_1X1")
    before = {f: os.environ.get(f) for f in flags}
    try:
        for name in taken:
            setattr(conv_ops, name, counted(name))
        for f in flags:
            os.environ[f] = "1"
        r_out, r_loss, r_g = layers_outputs(card, *layers_data("cuda"))
    finally:
        for name, fn in reals.items():
            setattr(conv_ops, name, fn)
        for f, v in before.items():
            if v is None:
                os.environ.pop(f, None)
            else:
                os.environ[f] = v
    check(all(v == 2 for v in taken.values()),
          f"the rewrites were not taken once a walk: {taken}")
    rew = {f"out{i}": rel_err(a, b) for i, (a, b) in enumerate(zip(r_out,
                                                                  d_out))}
    rew["score"] = rel_err(r_loss, d_loss)
    for key, g in d_g.items():
        rew[".".join(key)] = rel_err(r_g[key], g)
    worst_rew = max(rew.values())
    check(worst_rew <= F64_REL_TOL, "F64 graph with the rewrites vs "
          "without: " + json.dumps({k: v for k, v in rew.items()
                                     if v > F64_REL_TOL}))
    phase("graph_layers", dtype="float64", vertices=len(card.topo),
          params=card.num_params(), card_vs_cpu_max_rel=f"{worst_cpu:.3e}",
          worst=max(errs, key=errs.get),
          rewrites_vs_plain_max_rel=f"{worst_rew:.3e}",
          rewrites_taken=json.dumps(taken), tol=F64_REL_TOL,
          grads_varying_run_to_run_default_flags=json.dumps(varies),
          grads_deterministic_flag="bit-equal")


@contextlib.contextmanager
def remat_env(spans):
    """DL4J_TPU_REMAT set to ``spans`` (None: unset) while the block runs,
    and a count of the remat spans run in it (yields a one-item list)."""
    from deeplearning4j_tpu_torch.nn import remat
    before = os.environ.get(remat.ENV)
    if spans is None:
        os.environ.pop(remat.ENV, None)
    else:
        os.environ[remat.ENV] = spans
    runs = [0]
    real = remat.run_span

    def counted(fn, *a):
        runs[0] += 1
        return real(fn, *a)

    remat.run_span = counted
    try:
        yield runs
    finally:
        remat.run_span = real
        if before is None:
            os.environ.pop(remat.ENV, None)
        else:
            os.environ[remat.ENV] = before


def remat_arm(base, data, spans, deterministic):
    """A fresh copy of ``base`` (unfused) with DL4J_TPU_REMAT = spans
    (None: unset), REMAT_STEPS fit_batch steps with cuDNN's deterministic
    flag as given: (net, step ms, peak MB, spans run a step, scores)."""
    import torch
    with remat_env(spans) as runs:
        net = graph_copy(base, "cuda", fuse=False)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=deterministic):
            out = timed_steps(net, data, REMAT_STEPS)
    return (net, out["step_ms"], out["peak_mb"], runs[0] / REMAT_STEPS,
            out["scores"])


def remat_dropout_graph():
    """in(64) -> d0, d1 (Dense(256), dropout 0.3) -> out: a remat span
    (DL4J_TPU_REMAT=d) with dropout inside, F32, Adam(1e-3)."""
    from deeplearning4j_tpu_torch import ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu_torch.nn.updater import Adam
    from deeplearning4j_tpu_torch.zoo.models import F32
    conf = (NeuralNetConfiguration.builder().seed(SEED).updater(Adam(1e-3))
            .dtype(F32).graph_builder().add_inputs("in")
            .add_layer("d0", Dense(n_out=256, activation="tanh",
                                   dropout=0.3), "in")
            .add_layer("d1", Dense(n_out=256, activation="relu",
                                   dropout=0.3), "d0")
            .add_layer("out", Output(n_out=10, activation="softmax",
                                     loss="mcxent"), "d1")
            .set_outputs("out").set_input_types(InputType.feed_forward(64))
            .build())
    return ComputationGraph(conf).init()


def captured_remat_span(steps=8):
    """The dropout span eagerly and through the captured step, from one
    parameter set and one generator state: bit-equal after ``steps``
    steps. Returns the captured step's graph captures and replays."""
    import torch
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    x = torch.randn((128, 64), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(torch.randint(
        0, 10, (128,), generator=gen, device="cuda"), 10).float()
    ds = MultiDataSet([x], [y])
    with remat_env("d") as runs:
        eager = remat_dropout_graph()
        captured = eager.clone()
        for _ in range(steps):
            eager.fit_batch(ds)
        captured.fit_batch_repeated(ds, steps)
    diffs = {k: v for k, v in tree_max_diffs(eager, captured).items() if v}
    check(not diffs, f"remat span with dropout, captured vs eager: {diffs}")
    (sg,) = captured._multi_steps.values()
    check(sg.captures == 1 and sg.replays >= 1 and runs[0] >= steps,
          f"captures {sg.captures}, replays {sg.replays}, spans {runs[0]}")
    return sg.captures, sg.replays


def phase_remat():
    """ResNet-50 unfused (224, 1000 classes, BF16, b = 256) with
    DL4J_TPU_REMAT=s0b,s1b,s2b,s3b and without, on fresh copies of one
    parameter set: parameters and optimizer state bit-equal after 2 steps
    (cuDNN deterministic), step ms and peak memory (cuDNN's defaults);
    with the fusion pass on, no span."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    base = zoo.resnet50(seed=SEED)
    data = [MultiDataSet([x], [y]) for x, y in
            resnet_batches(REMAT_STEPS, REMAT_B, SEED + 18)]
    arms = {}
    for name, spans, det in (("remat_det", REMAT_SPANS, True),
                             ("plain_det", None, True),
                             ("remat", REMAT_SPANS, False),
                             ("plain", None, False)):
        arms[name] = remat_arm(base, data, spans, det)
        torch.cuda.empty_cache()
    diffs = tree_max_diffs(arms["remat_det"][0], arms["plain_det"][0])
    unequal = {"/".join(map(str, k)): v for k, v in diffs.items() if v}
    check(arms["remat_det"][3] == 1 and arms["plain_det"][3] == 0,
          f"spans run a step: remat {arms['remat_det'][3]}, plain "
          f"{arms['plain_det'][3]}")
    check(not unequal, f"remat vs plain after {REMAT_STEPS} steps differ "
          f"in {len(unequal)} tensors: largest "
          f"{max(unequal.values(), default=0.0):.3e} at "
          f"{max(unequal, key=unequal.get, default=None)}")
    default_diff = max(tree_max_diffs(arms["remat"][0],
                                      arms["plain"][0]).values())
    for name in arms:
        arms[name] = arms[name][1:]
    # the fusion pass leaves no span
    with remat_env(REMAT_SPANS) as runs:
        fused = graph_copy(base, "cuda", fuse=True)
        x, y = resnet_batches(1, 32, SEED + 19)[0]
        fused_score = float(fused.fit_batch(MultiDataSet([x], [y])))
    check(len(fused._fusion_plans) == 13 and runs[0] == 0
          and fused.remat_prefixes == tuple(REMAT_SPANS.split(",")),
          f"fused graph: {len(fused._fusion_plans)} plans, {runs[0]} spans")
    check(math.isfinite(fused_score), f"fused score {fused_score}")
    captures, replays = captured_remat_span()
    phase("remat", model="resnet50(224,1000,BF16,unfused)", b=REMAT_B,
          steps=REMAT_STEPS, spans=REMAT_SPANS,
          bit_equal_deterministic="yes",
          default_flags_max_diff=f"{default_diff:.3e}",
          **{f"{n}_step_ms": "/".join(f"{v:.3f}" for v in a[0])
             for n, a in arms.items()},
          **{f"{n}_peak_mb": f"{a[1]:.0f}" for n, a in arms.items()},
          spans_per_step=json.dumps({n: a[2] for n, a in arms.items()}),
          scores=json.dumps({n: [round(s, 5) for s in a[3]]
                             for n, a in arms.items()}),
          fused_plans=len(fused._fusion_plans), fused_spans=runs[0],
          captured_dropout_span=f"bit-equal({captures} capture, "
          f"{replays} replays)")


def phase_slice14():
    """The phases of slice 14, in order."""
    net, _ = phase_graph_tbptt()
    phase_graph_stream(net, save_dir=STREAM_OUT if "--save-stream"
                       in sys.argv[1:] else None)
    phase_graph_layers()
    phase_remat()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    # f32 matrix products in full f32 (PyTorch's default, stated); the F32
    # convolutions turn cuDNN's TF32 off themselves (ops/convolution.py)
    torch.backends.cuda.matmul.allow_tf32 = False
    ok_line = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    for flag, split in (
            ("--lstm-split", phase_lstm_split),
            ("--lstm-parts", phase_lstm_parts),
            ("--k7-split", lambda: phase_split("fused_block_bwd_apply")),
            ("--k6-split", lambda: phase_split("fused_block_bwd_stats")),
            ("--fwd-split", phase_fwd_split)):
        if flag in sys.argv[1:]:
            smi = subprocess.run(["nvidia-smi",
                                  "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=60)
            print(smi.stdout.strip(), flush=True)
            split()
            print(ok_line, flush=True)
            return 0
    for flag, only in (("--tail-check", phase_tail_check),
                       ("--conv-nets", phase_conv_nets),
                       ("--captured", phase_train_captured),
                       ("--resilient", phase_resilient),
                       ("--resilient-resnet", phase_resilient_resnet),
                       ("--solvers", phase_solvers),
                       ("--gradcheck", phase_gradcheck),
                       ("--transfer", phase_transfer),
                       ("--pretrain", phase_pretrain),
                       ("--slice12", phase_slice12),
                       ("--datapipe-resilient", phase_datapipe_resilient),
                       ("--datapipe-feed", phase_datapipe_feed),
                       ("--observability", phase_observability),
                       ("--slice13", phase_slice13),
                       ("--graph-tbptt", phase_graph_tbptt),
                       ("--graph-stream", phase_graph_stream),
                       ("--graph-layers", phase_graph_layers),
                       ("--remat", phase_remat),
                       ("--slice14", phase_slice14)):
        if flag in sys.argv[1:]:
            phase_device()
            only()
            print(ok_line, flush=True)
            return 0

    card = phase_device()
    errs = {"lstm_fwd": phase_kernel_vs_plain(),
            "lstm_bwd": phase_bwd_vs_plain(),
            "flash_attn_fwd": phase_flash_vs_plain()}
    errs.update(phase_fused_vs_plain())
    net, serve_launches = phase_serve()
    phase_stream(net)
    train = phase_train()
    launches = {"serve": serve_launches,
                "train": train["launches"], "tbptt": phase_tbptt()}
    gt_net, launches["graph_tbptt"] = phase_graph_tbptt()
    launches["graph_stream"] = phase_graph_stream(gt_net)
    del gt_net
    gnet, gserve_launches = phase_serve_gpt()
    gtrain = phase_train_gpt()
    launches["serve_gpt"] = gserve_launches
    launches["train_gpt"] = gtrain["launches"]
    rtrain = phase_train_resnet()
    kernels = phase_times(card, net, errs, launches, train)
    kernels += phase_times_flash(card, gnet, errs, launches, gtrain)
    kernels += phase_times_fused(card, errs, rtrain)
    phase_conv_nets()
    phase_train_captured()
    phase_slice12()
    phase_slice13()
    phase_graph_layers()
    phase_remat()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(ok_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
