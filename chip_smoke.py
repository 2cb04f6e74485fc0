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
graph, ResNet-50's remat spans), decode serving (--slice15 below) and
live reload (--live-reload below), the front door (--front-door
below), cold start (--cold-start below), the training dashboard
(--dashboard below), the analysis gate (--analysis below) and the
data-parallel tier (--data-parallel below). Every
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

    python3 chip_smoke.py --slice15

runs only slice 15's phases (decode serving): [stream_invariance] (do
PyTorch's LayerNorm statistics, softmax and GELU keep their bits on the
card across 1-2048 rows; cuBLAS beside them; S1 and S2 must keep theirs),
[stream_exact_vs_plain]
(the order-fixed kernels S1 stream_dense, S2 stream_mha and S3
stream_rownorm against their plain versions, bit for bit, and their
gradients), [decode] (gpt_mini at full width, BF16, through DecodeEngine:
32 concurrent sessions with chunked prefill and prefix sharing bit-equal
to the card's sequential greedy decode, evictions recovered bit for bit,
256 tokens one at a time against one-shot, tokens/s, inter-token p50/p99,
prefill ms, bytes moved and the busy share of a decode step),
[decode_spec] (speculative decode with gpt_mini_draft, k = 4, bit-equal to
plain greedy), [decode_http] (serve() with 2 replicas and /decode, and K3
through /predict), [decode_lstm] (the char-RNN engine through K1's cluster
route) and the S kernels' times; the full run ends with the same phases,
and

    python3 chip_smoke.py --stream-split

(also after --slice15's phases when both flags are given, and at the end
of the full run) times S1, S2 and S3, the Hopper redesigns, beside
their first versions at the decode step's shapes
([stream_split]: S1 at [32, 256] x [256, 1024] and [32, 1024] x [1024,
256], S2 at a 32-row step and a 16-token chunk of 4 rows, S3 at [32,
256], [64, 256] and [2048, 256]; first, new and the library call in
turns, back to back by CUDA events, the device time (calls queued
behind a spin), the host's time to issue a call; the plain version, the
bound, S1's chain floor from [stream_floor], the card's own cycles a
dependent add takes; then S1's device time at every launch plan it can
choose), and

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
(a build with the kernels' step marks), and

    python3 chip_smoke.py --profiler-pause

counts which of ten short launches (ten different kernels) torch.profiler
keeps in one profile, with pauses of 0, 20 ms (PROFILE_PAUSE_S, every
profile of this script), 200 ms and 1 s after the profile's start:
first in the process, after 10 s of idle, after 10 s of launches and
after 10 s of profiles; and the device-time method of the [times] rows
(CUDA events around calls queued behind a spin) beside the profiler's
kernel times (the full run takes the same probe first and last), and

    python3 chip_smoke.py --live-reload

runs only [live_reload]: gpt_mini at full width published in
two versions into a WeightStore, served by a ModelServer of 2 replicas to
4 client threads while hot_swap moves it from v1 to v2, bit for bit
against each version's own replies, with no kernel built across the
swap; a NaN-poisoned version counted; rollback and a swap back to v1,
and

    python3 chip_smoke.py --front-door

runs only [front_door]: gpt_mini at full width behind a FrontDoorRouter
in this process over two host processes that share the card (each
restores this process's zip and serves it with 2 replicas, a
DecodeEngine and heartbeats to the router): /predict rows through the
router bit-equal to net.output here, open-loop traffic at twice that rate
with batch and best_effort shed before interactive and one tenant's
quota, 8 /decode sessions bit-equal to the sequential greedy decode
across a SIGKILL of one host, the federation's scheduler and SLO
families and a stitched trace, the survivor's exact K3 and S1-S3
launches with no kernel built, and the autoscaler's bounds, and

    python3 chip_smoke.py --cold-start

runs only [cold_start]: gpt_mini at full width (max_batch 32, a
DecodeEngine) booted in fresh processes against the kernel build cache
(DL4J_TPU_COMPILE_CACHE): cold, warm, against a precompile manifest and
a mismatched one, two processes on one empty dir at once, and with the
tuning report autotune made from open-loop traffic served here; every
arm's /predict row and /decode tokens bit-equal, K3 and S1-S3 launches
exact, 0 builds warm; each arm's time to its first reply, and

    python3 chip_smoke.py --dashboard

runs only [dashboard]: the full-width char-RNN trained 30 steps under a
StatsListener reporting through a RemoteStatsStorageRouter to a UIServer
and into a FileStatsStorage, params bit-equal to a run without it, then
the evaluation report, the trace timeline and the output layer's t-SNE
on the card against the CPU, and

    python3 chip_smoke.py --analysis

runs only K3 and S1-S3 against their plain versions and [analysis]: the
concurrency gate over the port, this script and the port's tests (0
findings, empty baseline), the fx lint of gpt_mini's fit step at full
width under BF16 recorded on the card (the aten op histogram, K3's
kernel nodes, J001-J005 empty, one capture), then [lockorder]: the
port's lock-order detector installed before 32 decode sessions and a
hot swap (0 cycles; edges and long holds), and

    python3 chip_smoke.py --data-parallel

runs only K3 against its plain version and [data_parallel]: gpt_mini at
full width on a 1-rank NCCL mesh bit-equal to the unmeshed captured
step, ParallelWrapper(4 workers, averaging every 2) bit-equal to the
explicit average on the card and within Adam's bound of the CPU path,
and two host processes on the one card over a named gloo group (NCCL
refuses two ranks on one card): ranks bit-equal, within Adam's bound of
one process on the whole batch, their timeline written, and

    python3 chip_smoke.py --wide-kernels

runs only [wide_kernels]: K1/K2 on their wide route (past the grid
kernels' limits) and K3 on its wide kernel (head sizes 256 to the JAX
kernel's budget), each against its plain version with its time, bound
and SDPA's time, and a char-RNN at hidden 1,152 and a dh = 256 gpt_mini
trained 2 steps on those routes, and

    python3 chip_smoke.py --tensor-parallel

runs only K3 against its plain version and [tensor_parallel]: gpt_mini
at full width over a model axis (zoo.gpt_mini_tp_rules), (a) a 1-rank
NCCL mesh captured bit-equal to the unmeshed step, (b) two host
processes on the one card over gloo at {"model": 2} against one process
(ranks bit-equal, K3 on each rank's 2 heads, the collectives counted and
timed, peak memory), (c) the checkpoint restored unmeshed and onto the
mesh, its next step's score matching. The rest of the parallel tier
runs on gloo ranks sharing the card, each phase alone by its flag:

    python3 chip_smoke.py --sequence-parallel   # [sequence_parallel]
    python3 chip_smoke.py --pipeline            # [pipeline]
    python3 chip_smoke.py --experts             # [experts]
    python3 chip_smoke.py --mesh-decode         # [mesh_decode]

char-RNN's first GravesLSTM over {"seq": 2} (K1/K2 on each rank's time
chunk), gpt_mini's four blocks as four pipeline stages (K3 on each),
8 experts at gpt_mini's FFN widths over {"expert": 2}, and gpt_mini's
decode engine on {"model": 2}, each held to one process.

    python3 chip_smoke.py --slice25

runs K1, K2 and S1-S3 against their plain versions, then model import,
clustering and the native loader: [keras_import] (a Keras 2 char-RNN at
the zoo's width from JSON + seeded weights served over HTTP and trained
3 steps on K1/K2, held to its CPU import; the same with Keras's
hard-sigmoid gate on the counted composed route; keras.applications'
VGG-16 as a ComputationGraph served in buckets of 1 and 4 rows, S1 3 a
forward), [dl4j_import] (char_rnn and VGG-16 through the DL4J zip and
back bit for bit, the golden fixture, the model guesser on three
formats), [clustering] (k-means k = 1,000 on 100,000 x 300, each Lloyd
step held to float64; Barnes-Hut t-SNE) and [native_io] (the g++-built
loader feeding a LeNet epoch from MNIST-shaped IDX files); the full run
calls the same phases before [stream_split].

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
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
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


# torch.profiler loses launches. In a young process a short window issued
# just after the profile's start came back with launches missing, and now
# and then with none; the pause after the start below cured that.
# Later in a process (once the card has idled for seconds) its trace drops
# a launch or more from most profiles whatever the pause, as outside the
# trace's window (Kineto's own "Out-of-range" count; --profiler-pause's
# probe, PERF.md section 6). So the [times] rows' device times come from
# device_ms_per_call, which sees every launch; profiles serve where a lost
# launch biases nothing the run gates on (busy shares, kernel kinds)
PROFILE_PAUSE_S = 0.02
# profiles taken by profiled() in this run, and how many of them saw no
# device time and were taken again (the [profiler] line)
PROFILES = {"taken": 0, "empty": 0}
# the process's start on the host's clock (the probes report their age)
PROCESS_T0 = time.perf_counter()


def profiled(body, cpu=False, attempts=5):
    """``body()`` under torch.profiler (the card's activity, and the
    host's with ``cpu``): ``(prof, kernels, wall_ms)``, where ``kernels``
    are the profile's device work (device_kernels) and ``wall_ms`` is
    body's host-clock time. The host waits PROFILE_PAUSE_S after the
    profile starts and before it stops, so that no launch of body falls
    before the start on the card's clock; a profile that still saw no
    device time is taken again (body runs again) with twice the pause,
    since late in a process the trace's clock strays from the host's
    (PERF.md section 6), up to ``attempts`` in all, and then the run
    fails rather than report a time of zero."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for attempt in range(attempts):
        pause = PROFILE_PAUSE_S * 2 ** attempt
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            time.sleep(pause)
            t0 = time.perf_counter()
            body()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(pause)
        PROFILES["taken"] += 1
        kernels = device_kernels(prof.key_averages())
        if sum(e.self_device_time_total for e in kernels) > 0:
            return prof, kernels, wall_ms
        PROFILES["empty"] += 1
    raise SmokeFailure(
        f"the profiler saw no device time in {attempts} profiles")


# the probe's ten launches: ten in-place ops of ten different kernels, so
# that a profile that loses launches says which
PROBE_OPS = ("add_", "mul_", "neg_", "abs_", "exp_", "sin_", "cos_",
             "sqrt_", "reciprocal_", "tanh_")


def probe_launch(x, op):
    getattr(x, op)(*((1.0,) if op in ("add_", "mul_") else ()))


def probe_profile(x, pause):
    """One profile of the ten PROBE_OPS on ``x`` (2^18 f32 on the card),
    ``pause`` seconds of idle after its start and before its stop: {kept:
    the kernels torch.profiler's key_averages() kept, raw: the device
    events in its raw (Kineto) results, order: the raw events' names by
    start, lead_ms: the host's time from the trace's start to the first
    launch, skew_ms: when all ten are kept, the median of (a kernel's
    start on the trace's clock minus the host's clock just before its
    launch)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    launch_ns = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pause)
        for op in PROBE_OPS:
            launch_ns.append(time.time_ns())
            probe_launch(x, op)
        torch.cuda.synchronize()
        time.sleep(pause)
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    raw = sorted((e.start_ns(), e.name()) for e in res.events()
                 if e.device_type() == DeviceType.CUDA
                 and not e.is_user_annotation())
    kept = device_kernels(prof.key_averages())
    out = dict(kept=sum(e.count for e in kept), raw=len(raw),
               order=[n for _, n in raw], lead_ms=(launch_ns[0] - t0) / 1e6,
               skew_ms=None)
    if len(raw) == len(launch_ns):
        out["skew_ms"] = statistics.median(
            (k - h) / 1e6 for (k, _), h in zip(raw, launch_ns))
    return out


def profiler_probe(tag, profiles=20, pauses=(0.0, PROFILE_PAUSE_S),
                   names=None):
    """--profiler-pause's probe: ``profiles`` profiles of the ten
    PROBE_OPS at each pause, in turns. One [profiler_probe] line a pause:
    profiles short of ten, the mean kept, which of the ten were lost
    (by index; ``names`` maps a kernel name to its index, learnt from a
    whole profile), the skew. Returns the names' map."""
    import torch
    x = torch.rand(1 << 18, device="cuda") + 1.0
    for op in PROBE_OPS:
        probe_launch(x, op)
    torch.cuda.synchronize()
    runs = {p: [] for p in pauses}
    for _ in range(profiles):
        for pause, got in runs.items():
            got.append(probe_profile(x, pause))
            if names is None and got[-1]["raw"] == len(PROBE_OPS):
                names = {n: i for i, n in enumerate(got[-1]["order"])}
    for pause, got in runs.items():
        kept = [g["kept"] for g in got]
        skews = [g["skew_ms"] for g in got if g["skew_ms"] is not None]
        lost = [0] * len(PROBE_OPS)
        for g in got:
            seen = {names.get(n) for n in g["order"]} if names else set()
            for i in range(len(PROBE_OPS)):
                lost[i] += i not in seen
        phase("profiler_probe", at=tag, pause_s=pause, profiles=len(got),
              launches_each=len(PROBE_OPS), empty=kept.count(0),
              short=sum(k < len(PROBE_OPS) for k in kept),
              kept_mean=f"{statistics.mean(kept):.4f}",
              raw_short=sum(g["raw"] < len(PROBE_OPS) for g in got),
              lost_by_index=json.dumps(lost if names else None),
              lead_ms=f"{statistics.median(g['lead_ms'] for g in got):.3f}",
              skew_ms=json.dumps([round(min(skews), 3),
                                  round(statistics.median(skews), 3),
                                  round(max(skews), 3)] if skews else None),
              process_s=f"{time.perf_counter() - PROCESS_T0:.1f}")
    return names


def events_vs_profiler():
    """device_ms_per_call (events behind a spin) beside the profiler's
    kernel time for the same calls (the mean over the launches it kept,
    and how many it kept of 50): a one-element add (the events' floor:
    an almost empty launch), an add over 2^18 f32, S3 at [32, 256]."""
    import torch
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    one = torch.zeros(1, device="cuda")
    x = torch.zeros(1 << 18, device="cuda")
    g = torch.Generator(device="cpu").manual_seed(SEED + 162)
    args = norm_time_case(g, 32)[0]
    for name, fn in (("add_1", lambda: one.add_(1.0)),
                     ("add_2^18", lambda: x.add_(1.0)),
                     ("stream_rownorm_32x256",
                      lambda: se.stream_rownorm_cuda(*args))):
        ev = [device_ms_per_call(fn, 50)[0] for _ in range(2)]
        prof = [profiler_ms_per_call(fn, 50) for _ in range(2)]
        phase("events_vs_profiler", call=name,
              events_ms=json.dumps([round(t, 5) for t in ev]),
              profiler_ms_kept=json.dumps([[round(t, 5), k]
                                           for t, k in prof]))


def profiler_ms_per_call(fn, reps=50):
    """torch.profiler's kernel time for one call of ``fn()`` (each
    kernel's mean over the launches it kept, summed) and the fewest
    launches of one kernel it kept of ``reps``."""
    events = device_events(fn, reps)
    return (sum(e.self_device_time_total / e.count for e in events) / 1e3,
            min(e.count for e in events))


def phase_profiler_pause(seconds=10.0):
    """What keeps torch.profiler from seeing a launch, read on one card:
    the probe (profiler_probe) first in the process, at pauses of 0, 20
    ms, 200 ms and 1 s; then after ``seconds`` of idle; after
    ``seconds`` of launches with no profile; after ``seconds`` of many
    short profiles (does it grow with the profiles taken, as filling
    buffers would make it?)."""
    import torch
    pauses = (0.0, PROFILE_PAUSE_S, 0.2, 1.0)
    names = profiler_probe("first", profiles=5, pauses=pauses)
    events_vs_profiler()
    time.sleep(seconds)
    profiler_probe("after_idle", profiles=5, pauses=pauses, names=names)
    x = torch.randn(1 << 20, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(100):
            torch.exp(x)
        torch.cuda.synchronize()
    profiler_probe("after_busy", profiles=5, pauses=pauses, names=names)
    y = torch.empty_like(x)
    taken, short = 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for fn in (lambda: torch.mul(x, 2.0, out=y),
                   lambda: torch.exp(x, out=y),
                   lambda: torch.sum(x)):
            ev = device_events(fn, 50)
            taken += 1
            short += any(e.count != 50 for e in ev)
    phase("profiler_aging", profiles=taken, short=short,
          process_s=f"{time.perf_counter() - PROCESS_T0:.1f}")
    profiler_probe("after_profiles", profiles=5, pauses=pauses, names=names)
    events_vs_profiler()


def device_events(fn, reps):
    """torch.profiler's per-kernel averages (CUDA only) over ``reps``
    calls of ``fn()``, after a warm-up call (profiled)."""
    import torch
    fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(reps):
            fn()
    return profiled(body)[1]


# how the [times] rows' device times are taken (device_ms_per_call)
DEVICE_METHOD = "cuda_events_around_calls_queued_behind_a_spin"
# the card's cycles a second, for sizing a spin (its top SM clock; at a
# lower clock a spin only lasts longer)
SPIN_HZ = 1.98e9


def device_ms_per_call(fn, reps=20, attempts=4):
    """The card's time for one call of ``fn()``: ``reps`` calls queued
    back to back behind a spin kernel (torch.cuda._sleep) long enough for
    the host to issue them all, between two CUDA events recorded after
    the spin and after the last call; the elapsed time over ``reps``.
    So the card runs the calls one after another with no wait on the
    host, and the events see every launch: torch.profiler loses launches
    late in a long process (its own trace drops them as out of range,
    PERF.md section 6), so the [times] rows' device times are taken this
    way. Unlike the profiler's sum of kernel times it counts the gaps the
    card itself leaves between launches (``events_floor`` in [times]).
    If the spin ended before the host had issued every call, the card
    may have waited on the host: the reading is taken again with a spin
    twice as long, up to ``attempts`` times, and then the run fails.
    Returns (ms, calls timed)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_s = 2.0 * reps * issue_s + 2e-4
    for _ in range(attempts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spun = torch.cuda.Event()
        torch.cuda._sleep(int(spin_s * SPIN_HZ))
        spun.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        waited = spun.query()      # the spin ended before the last issue
        end.synchronize()
        if not waited:
            return start.elapsed_time(end) / reps, reps
        spin_s *= 2.0
    raise SmokeFailure(
        f"the host could not issue {reps} calls inside a {spin_s:.4f} s "
        f"spin: the card would have waited on it")


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
    # S1 and S2 (PR 16) stage their operands by cp.async (LDGSTS) and sum
    # on the f32 pipe: no tensor-core op, and no FFMA in S1, whose products
    # and sums are rounded apart (S2's expf has FFMAs of its own)
    for fn in ("stream_dense_kernelI", "stream_mha_kernelI"):
        sass = _build.sass_counts("stream_exact", ("LDGSTS", "HMMA", "HGMMA",
                                                   "FFMA", "FMUL", "FADD"),
                                  fn)
        phase("sass", library="stream_exact", function=fn, **sass)
        check(sass["LDGSTS"] > 0 and sass["HMMA"] == sass["HGMMA"] == 0
              and (fn != "stream_dense_kernelI" or sass["FFMA"] == 0),
              f"stream_exact {fn}: its SASS holds {sass}: no cp.async, a "
              f"tensor-core op or a fused multiply-add")
    return card


# K1's cases: (T, b, n, masked, nonzero carry, residuals). b = 33 and 70
# leave the last 32-row cluster ragged; T = 1 is the streaming step.
# (50, 32) is a [graph_tbptt] window after the first, (1, 4) a
# [graph_stream] call, (512, 32) with a carry the second rank's chunk in
# [sequence_parallel] at T = 1,024.
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
             (1, 70, 512, False, True, True),
             (512, 32, 512, False, True, True)]


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
                    grid = lstm_ops.lstm_fwd_launch("grid", *args[:5], mask,
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
# [graph_tbptt] window after the first, (512, 32) with a carry a rank's
# chunk in [sequence_parallel] at T = 1,024
BWD_CASES = [(64, 32, 512, False, False), (64, 2, 512, False, True),
             (50, 32, 512, False, True),
             (7, 3, 512, True, False), (1, 1, 512, False, True),
             (64, 33, 512, False, True), (64, 70, 512, True, False),
             (1, 70, 512, True, True), (512, 32, 512, False, True)]


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
                    grid = lstm_ops.lstm_bwd_launch("grid", *args)
                    grid2 = lstm_ops.lstm_bwd_launch("grid", *args)
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
        threads = [threading.Thread(target=client, args=(c,), daemon=True)
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
        threads = [threading.Thread(target=client, args=(c,), daemon=True)
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
    def body():
        for ds in data:
            net.fit_batch(ds)
    _, kernels, wall_ms = profiled(body, cpu=True)
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    n = len(data)
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
        # time is the host's, and the device time (calls queued behind a
        # spin, device_ms_per_call), taken in turns with SDPA's (sm90,
        # SDPA, three times), is the card's
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
        dev_readings, dev_lib_readings = [], []
        for _ in range(3):
            for readings, fn in ((dev_readings, sm90),
                                 (dev_lib_readings, sdpa)):
                readings.append(device_ms_per_call(fn, reps=100)[0])
        dev_ms = statistics.median(dev_readings)
        dev_lib_ms = statistics.median(dev_lib_readings)
        dev_fma_ms = device_ms_per_call(fma, reps=100)[0]
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
          device_method=DEVICE_METHOD, device_calls_timed=100,
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


def fwd_on(route):
    """K1 through ``route`` ("grid" or "cluster"), uncounted (the grid route's
    bf16 instantiation is not the wrapper's for bf16 at n = 512)."""
    import torch
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops

    def run(xz, h0, c0, Wh, p, mask, save=False):
        if mask is None:
            mask = torch.ones(xz.shape[:2], dtype=xz.dtype, device=xz.device)
        return lstm_ops.lstm_fwd_launch(route, xz, h0, c0, Wh, p, mask,
                                        save)
    return run


def bwd_on(route):
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    return lambda *a: lstm_ops.lstm_bwd_launch(route, *a)


def bwd_split(args):
    """K2's cluster route split by launch (torch.profiler): the chain, the
    sum of dp's partials and dWh on the sm90 mainloop, each kernel's mean
    device ms over the launches the profiler kept."""
    import torch
    names = {"lstm_bwd_cluster_kernel": "chain", "lstm_bwd_dp_sum": "dp_sum",
             "DwhEpi": "dwh"}
    with torch.inference_mode():
        events = device_events(lambda: bwd_on("cluster")(*args), reps=20)
    split, kept = {}, []
    for e in events:
        for key, name in names.items():
            if key in e.key:
                split[name] = e.self_device_time_total / e.count / 1e3
                kept.append(e.count)
    check(set(split) == set(names.values()) and min(kept) == 20,
          f"the profiler did not see every K2 launch: {split}, kept "
          f"{kept} of 20")
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
        res_ms = cuda_ms(lambda: fwd_on("cluster")(*args, True), reps=50)
    for route in ("grid", "cluster", "cluster", "grid"):
        cluster = route == "cluster"
        sweep, per_step, fixed = sweep_ms(
            lambda steps: lstm_inputs(steps, b, n, dtype), fwd_on(route), T)
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
    for route in ("grid", "cluster", "cluster", "grid"):
        cluster = route == "cluster"
        sweep, per_step, fixed = sweep_ms(
            lambda steps: bwd_inputs(steps, b, n, dtype)[0], bwd_on(route),
            T)
        out.setdefault(("bwd", route), []).append(sweep[T])
        extra = {}
        if cluster:
            extra = dict(active_clusters=fits["lstm_bwd"])
        if cluster and tag != "times":
            # the split by launch needs the profiler's kernel names; the
            # full run's [times] rows leave it out (the profiler loses
            # launches late in a long process), --lstm-split keeps it,
            # and fails if the profiler lost a launch
            split, kept = bwd_split(bargs)
            extra.update(split_device_ms=json.dumps(
                {k: round(v, 5) for k, v in split.items()}),
                profiler_kept=f"{kept}/20")
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
                fn = lambda: fwd_on("cluster")(*args)  # noqa: E731
            else:
                bargs, _ = bwd_inputs(T, b, n, torch.bfloat16)
                fn = lambda: bwd_on("cluster")(*bargs)  # noqa: E731
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
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry

    def body():
        registry.reset_launches()   # counts of the profile that is kept
        for ds in data:
            net.fit_batch(ds)
    _, kernels, wall_ms = profiled(body, cpu=True)
    n = len(data)
    total = sum(e.self_device_time_total for e in kernels)
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
    time (pass_split fails unless it kept them all)."""
    kept = 0


def pass_split(fn, passes=K7_PASSES, reps=10):
    """A kernel's device ms a call by pass (K7: dz, dx, dW, sum of the dW
    splits; K6: gemm, sum) over ``reps`` calls of ``fn``, from
    torch.profiler, with the kernels it could not place under "other".
    Each kernel of K4-K7 launches once a call, so a pass's time is the
    mean over its launches; the run fails if the profiler kept fewer than
    ``reps`` of one (it loses launches late in a long process, so the
    full run's [times] rows do not split by pass; the split modes,
    --k7-split, --k6-split and --fwd-split, do)."""
    out = Split({name: 0.0 for name, _ in passes})
    out["other"] = 0.0
    out.kept = reps
    for e in device_events(fn, reps):
        tag = next((name for name, keys in passes
                    if any(k in e.key for k in keys)), "other")
        out[tag] += e.self_device_time_total / 1e3 / e.count
        out.kept = min(out.kept, e.count)
    check(out.kept == reps, f"the profiler kept {out.kept} of {reps} "
          f"launches of a kernel: the split would be a mean over fewer "
          f"launches than were timed")
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
    mma.sync path on the same inputs, both with their device time (ten
    calls behind a spin, device_ms_per_call; the split by launch is the
    split modes', --k7-split, --k6-split, --fwd-split); how many
    elements of z the two paths round differently (z_bits)."""
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
                mma_sync, _ = mma_sync_and_passes(kern)
                old = mma_sync(*a)
                old_ms = cuda_ms_per_launch(old, reps=5)
                device_ms = device_ms_per_call(lambda: cuda_fn(*a), 10)[0]
                old_device_ms = device_ms_per_call(old, 10)[0]
                rows[(kern, stage)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, mma_sync_ms=old_ms,
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
                      device_method=DEVICE_METHOD, device_calls_timed=10,
                      device_roofline_share=f"{bound_ms / device_ms:.4f}",
                      tflops=f"{flops / ms / 1e9:.2f}",
                      library="none (no single PyTorch call computes it); "
                              "yardstick torch.matmul of the same product",
                      matmul_ms=f"{gemm_ms:.4f}",
                      matmul_ms_times_products=f"{gemm_ms * gemms:.4f}",
                      mma_sync_ms=f"{old_ms:.4f}",
                      mma_sync_device_ms=f"{old_device_ms:.4f}",
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
# discontinuous (ROADMAP.md C.1, first bullet), so the card's must be as
# accurate as the CPU's f32 gradients, to within CONV_ACCURACY_RATIO plus
# 1e-3, in each gradient's L2 error relative to its norm (worst
# gradient); the scores card vs CPU to CONV_F32_SCORE_RTOL. The same
# holds ResNet-18's F32 step, the form tests/test_torch_graph.py states
# for it on the card.
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
    """No kernel of the port (K1-K7) runs on the conv nets' paths. Their
    dense and output layers' F32 inference products run S1 (ROADMAP C.7:
    ``dense:route[stream]``), and nothing else launches S1 there: its
    launches equal the route's count."""
    from deeplearning4j_tpu_torch.ops import registry
    launched = {k: v for k, v in registry.launches().items() if v}
    s1 = launched.pop("stream_dense", 0)
    routed = launched.pop("dense:route[stream]", 0)
    check(not launched and s1 == routed, f"{what} launched the port's "
          f"kernels: {launched}, S1 {s1} times on {routed} dense-route "
          f"products")


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
    prof, kernels, wall_ms = profiled(fn, cpu=True)
    avgs = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
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
    wrong gradient caught. A GravesLSTM in F64 on the card passes its
    check through the composed route (its kernels take f32 and bf16; the
    JAX package sends f64 to XLA), counted as such, K1/K2 not launched."""
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
    from deeplearning4j_tpu_torch.ops import registry
    registry.reset_launches()
    lres = check_network_gradients(lstm, DataSet(xr, xr), sample_per_leaf=2)
    launches = registry.launches()
    check(lres.passed, f"the F64 GravesLSTM's gradient check failed on "
          f"the card: {lres.failures[:3]}")
    check(launches.get("lstm_sequence:composed[dtype=float64]", 0) > 0
          and not any(launches.get(k, 0) for k in ("lstm_fwd", "lstm_bwd")),
          f"the F64 GravesLSTM did not take its composed route: {launches}")
    phase("gradcheck", net="conv3x3(4)-BN-relu-maxpool-dense(6)-softmax,F64,"
          "8x8x2,b=6", checked=res.total_checked, failed=res.total_failed,
          max_rel_error=f"{res.max_rel_error:.3e}", seconds=f"{dt:.2f}",
          planted_failed=f"{planted.total_failed}/{planted.total_checked}",
          lstm_f64=f"composed,checked={lres.total_checked},"
          f"failed={lres.total_failed}")


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
    _, kernels, wall_ms = profiled(fn, cpu=True)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
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
                prof = profiled(lambda: net.fit(
                    ListDataSetIterator(mem[:4]), epochs=1, **kw),
                    cpu=True)[0]
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


# ------------------------------------------------------------------ slice 15
# [stream_invariance]: row counts, and the widths of gpt_mini's LayerNorm
# rows and head softmax rows
SI_ROWS = (1, 8, 64, 2048)
SI_WIDTH, SI_V = 256, 80


def rows_moved(fn, x):
    """How fn's output rows move with the number of rows it is given:
    fn(x[:R]) against fn(x)[:R] for R in SI_ROWS, bit for bit. Returns
    {R: (rows that differ, max abs difference)}."""
    import torch
    full = fn(x)
    out = {}
    for R in SI_ROWS:
        got = fn(x[:R].clone())
        diff = (got != full[:R]).reshape(R, -1).any(dim=1)
        out[R] = (int(diff.sum()),
                  float((got - full[:R]).abs().max()))
    torch.cuda.synchronize()
    return out


def phase_stream_invariance():
    """Whether PyTorch's own ops on the streaming path keep their bits on
    the card whatever the number of rows (1, 8, 64, 2048): LayerNorm's row
    statistics at width 256 (nn/layers/attention.py::_layer_norm) and the
    head's softmax at V = 80, in the 2-D and the [b, t, f] layouts the path
    gives them; GELU (elementwise) beside them. Also reads torch.matmul
    (cuBLAS) at the projection shape [R, 256] x [256, 1024], the product
    the order-fixed kernel S1 replaces. Then reads S1 and S2 the same way
    (their tiles and blocks change with the row count) and S3 (its rows
    land in other blocks), and fails if one moves a bit: S1 at [R, 256] x [256, 1024] and at fc2's [R, 1024] x
    [1024, 256], S2 at a decode step's attention over R batch rows at
    random positions (cache 256), S3 at width 256 and at 4099 (the looped
    kernel). Returns {op: moved?}."""
    import torch
    from deeplearning4j_tpu_torch.nn.layers import attention as natt
    from deeplearning4j_tpu_torch.ops import activations
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    g = torch.Generator(device="cpu").manual_seed(SEED + 15)
    n = max(SI_ROWS)
    x = (torch.randn(n, SI_WIDTH, generator=g) * 3.0).cuda()
    lg = (torch.randn(SI_WIDTH, generator=g) * 0.1 + 1.0).cuda()
    lb = (torch.randn(SI_WIDTH, generator=g) * 0.1).cuda()
    z = (torch.randn(n, SI_V, generator=g) * 4.0).cuda()
    W = (torch.randn(SI_WIDTH, 4 * SI_WIDTH, generator=g) * 0.05).cuda()
    x4 = torch.randn(n, 4 * SI_WIDTH, generator=g).cuda()
    W2 = (torch.randn(4 * SI_WIDTH, SI_WIDTH, generator=g) * 0.03).cuda()
    b2 = (torch.randn(SI_WIDTH, generator=g) * 0.1).cuda()
    hd = DEC_W // DEC_H
    q = torch.randn(n, 1, DEC_H, hd, generator=g).cuda()
    kc, vc = (torch.randn(n, DEC_C, DEC_H, hd, generator=g).cuda()
              for _ in range(2))
    pos = torch.randint(0, DEC_C, (n,), generator=g).to(torch.int32).cuda()
    rows = torch.arange(n, device="cuda")
    xw = (torch.randn(n, NORM_WIDTHS[-1], generator=g) * 3.0).cuda()
    lgw = (torch.randn(NORM_WIDTHS[-1], generator=g) * 0.1 + 1.0).cuda()
    lbw = (torch.randn(NORM_WIDTHS[-1], generator=g) * 0.1).cuda()
    softmax = activations.get("softmax")
    gelu = activations.get("gelu")
    ops = {
        "layernorm_2d": (lambda a: natt._layer_norm(a, lg, lb, 1e-5), x),
        "layernorm_3d": (lambda a: natt._layer_norm(a[:, None], lg, lb,
                                                    1e-5)[:, 0], x),
        "softmax_2d": (softmax, z),
        "softmax_3d": (lambda a: softmax(a[:, None])[:, 0], z),
        "gelu": (gelu, x),
        "matmul_cublas": (lambda a: torch.matmul(a, W), x),
        "stream_dense_fc1": (lambda a: se.stream_dense(a, W), x),
        "stream_dense_fc2": (lambda a: se.stream_dense(a, W2, b2), x4),
        "stream_mha": (lambda i: se.stream_mha(q[i], kc[i], vc[i], pos[i]),
                       rows),
        "stream_rownorm": (lambda a: se.stream_rownorm(a, lg, lb, 1e-5), x),
        "stream_rownorm_looped": (
            lambda a: se.stream_rownorm(a, lgw, lbw, 1e-5), xw),
    }
    moved = {}
    for name, (fn, arg) in ops.items():
        with torch.inference_mode():
            res = rows_moved(fn, arg)
        moved[name] = any(d for d, _ in res.values())
        phase("stream_invariance", op=name, moved=moved[name],
              **{f"rows{R}": f"{d}/{e:.3g}" for R, (d, e) in res.items()})
    for name in ("stream_dense_fc1", "stream_dense_fc2", "stream_mha",
                 "stream_rownorm", "stream_rownorm_looped"):
        check(not moved[name], f"{name} moved bits with the row count; "
              f"it must not")
    return moved


# [stream_exact_vs_plain] holds S1-S3 to their plain versions bit for bit:
# the same products and sums in the same order, each rounded on its own,
# the same correctly rounded division and square root, and on the card the
# plain version's exp is the same expf as S2's.
# gpt_mini at full width (vocab 80, width 256, 4 blocks of 4 heads, dh 64,
# cache 256) and its draft (width 128, 2 blocks of 2 heads)
DEC_V, DEC_W, DEC_L, DEC_H, DEC_C = 80, 256, 4, 4, 256
# S3's widths and row counts in [stream_exact_vs_plain]: 1024 is the widest
# row a lane's registers hold (stream_exact.rownorm_plan), 4099 loops
NORM_WIDTHS = (1, 31, 32, 33, 256, 1024, 4099)
NORM_ROWS = (1, 7, 33, 2048)


def stream_cases():
    """(name, kernel, plain, args) at the decode path's shapes: a step of
    32 rows and a 16-token chunk of 4 rows, each of the four projections
    and the head; attention at those and at a 256-token one-shot prefill;
    the block's LayerNorm. Then the new kernels' edges (PR 16): 1, 7, 33
    and 256 rows (ragged row tiles; 256 a one-shot prefill) at fc1 and at
    fc2's f = 1024; a ragged f, g and the 4-byte copy path; attention at
    positions 0 and C - 1, a 16-token chunk whose last row sees C - 1, the
    visible range ending on a tile edge, and a head width off the 16-byte
    path."""
    import torch
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    g = torch.Generator(device="cpu").manual_seed(SEED + 150)

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).cuda()

    W = DEC_W
    hd = W // DEC_H
    cases = []
    for rows in (32, 64):
        x = r(rows, W)
        for f, n in ((W, W), (W, 4 * W), (4 * W, W), (W, DEC_V)):
            xi = x if f == W else r(rows, f)
            cases.append((f"dense_{rows}x{f}x{n}", se.KERNEL_DENSE,
                          (xi, r(f, n, s=f ** -0.5), r(n, s=0.1))))
        cases.append((f"rownorm_{rows}x{W}", se.KERNEL_NORM,
                      (r(rows, W, s=3.0), r(W, s=0.1) + 1.0, r(W, s=0.1),
                       1e-5)))
    for rows in (1, 7, 33, 256):
        for f, n in ((W, 4 * W), (4 * W, W)):
            cases.append((f"dense_{rows}x{f}x{n}", se.KERNEL_DENSE,
                          (r(rows, f), r(f, n, s=f ** -0.5), r(n, s=0.1))))
    cases.append(("dense_33x1000x80_nobias", se.KERNEL_DENSE,
                  (r(33, 1000), r(1000, DEC_V, s=0.03), None)))
    cases.append(("dense_7x37x33_4byte", se.KERNEL_DENSE,
                  (r(7, 37), r(37, 33, s=0.2), r(33, s=0.1))))

    def mha(name, b, t, pos, dh=hd, C=DEC_C):
        cases.append((name, se.KERNEL_MHA,
                      (r(b, t, DEC_H, dh), r(b, C, DEC_H, dh),
                       r(b, C, DEC_H, dh),
                       torch.tensor(pos, dtype=torch.int32).cuda())))

    for b, t in ((32, 1), (4, 16), (1, DEC_C)):
        pos = torch.randint(0, DEC_C - t + 1, (b,), generator=g)
        if t == DEC_C:
            pos.zero_()
        mha(f"mha_b{b}_t{t}", b, t, pos.tolist())
    tile = se.mha_plan(1, 1, DEC_H, hd, DEC_C).tj
    mha("mha_pos_0_and_last", 2, 1, [0, DEC_C - 1])
    mha("mha_b1_t16_sees_last", 1, 16, [DEC_C - 16])
    mha("mha_tile_edges", 4, 1, [tile - 1, tile, tile + 1, 2 * tile - 1])
    mha("mha_dh10_4byte", 3, 5, [0, 17, 40], dh=10, C=48)
    # S3: widths off, on and past a warp, the decode
    # width, the widest held in registers (1024) and one the looped kernel
    # takes, each at 1 to 2048 rows
    for w in NORM_WIDTHS:
        for rows in NORM_ROWS:
            cases.append((f"rownorm_{rows}x{w}", se.KERNEL_NORM,
                          (r(rows, w, s=3.0) + 0.5, r(w, s=0.1) + 1.0,
                           r(w, s=0.1), 1e-5)))
    return cases


def phase_stream_exact_vs_plain():
    """S1-S3 against their plain versions on the same CUDA inputs at the
    decode path's shapes. Returns {kernel: worst max abs error}."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    plain = {se.KERNEL_DENSE: se.stream_dense_torch,
             se.KERNEL_MHA: se.stream_mha_torch,
             se.KERNEL_NORM: se.stream_rownorm_torch}
    worst = {}
    with torch.inference_mode():
        for name, kern, args in stream_cases():
            got = registry.get(kern, "cuda")(*args)
            want = plain[kern](*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            bits = bool(torch.equal(got, want))
            phase("stream_exact_vs_plain", case=name,
                  max_abs_err=f"{err:.3g}", bit_equal=bits)
            check(bits, f"{name}: {kern} differs from its plain version "
                  f"(max {err:.3g}); it must agree bit for bit")
            worst[kern] = max(worst.get(kern, 0.0), err)
    return worst


def dec_net(dtype="BF16", device="cuda", seed=SEED, draft=False):
    """gpt_mini at full width (or its draft), seeded, BF16 by default."""
    from deeplearning4j_tpu_torch import zoo
    kw = dict(vocab_size=DEC_V, max_len=DEC_C, seed=seed,
              dtype=getattr(zoo, dtype), device=device)
    if draft:
        return zoo.gpt_mini_draft(**kw)
    return zoo.gpt_mini(width=DEC_W, n_layers=DEC_L, n_heads=DEC_H, **kw)


def dec_ids(n, seed):
    return [int(i) for i in np.random.default_rng(seed).integers(0, DEC_V, n)]


def dec_onehot(ids):
    return np.eye(DEC_V, dtype=np.float32)[np.asarray(ids)]


def token_by_token_vs_one_shot(net, n=None, seed=SEED + 151):
    """rnn_time_step over n tokens (default the whole cache) one at a time
    against one call with all n, bit for bit. Returns (positions that
    differ, max abs diff)."""
    import torch
    ids = dec_ids(n or DEC_C, seed)
    net.rnn_clear_previous_state()
    full = net.rnn_time_step(dec_onehot(ids)[None])[0]
    net.rnn_clear_previous_state()
    steps = torch.stack([net.rnn_time_step(dec_onehot([i]))[0]
                         for i in ids])
    net.rnn_clear_previous_state()
    torch.cuda.synchronize()
    diff = (steps != full).any(dim=1)
    return int(diff.sum()), float((steps - full).abs().max())


# [decode]: 32 sessions, prompts of 5-200 tokens (half of those past the
# prefix open with one shared 64-token system prompt), 32 tokens each
DEC_SESSIONS, DEC_TOKENS, DEC_SHARED = 32, 32, 64
DEC_PROMPTS = [int(t) for t in np.linspace(5, 200, DEC_SESSIONS)]
# the pool of the eviction check: 8 sessions of ~100 tokens in 24 pages
DEC_EVICT_SESSIONS, DEC_EVICT_PAGES, DEC_EVICT_STEPS = 8, 24, 6
# [decode_spec]: draft gpt_mini_draft (width 128, 2 blocks of 2 heads)
SPEC_K, SPEC_SESSIONS = 4, 4
# [decode_lstm]: the char-RNN engine's sessions
LSTM_SESSIONS, LSTM_TOKENS = 8, 16


def dec_prompt(i, n):
    """Session i's prompt of n tokens: sessions of even index past the
    shared prefix open with it."""
    ids = dec_ids(n, SEED + 300 + i)
    if i % 2 == 0 and n > DEC_SHARED:
        ids[:DEC_SHARED] = dec_ids(DEC_SHARED, SEED + 299)
    return ids


def greedy_reference(net, ids, n):
    """Sequential greedy decode through rnn_time_step on the net's own
    device: (tokens, the logits row before each token and after the last)
    as host arrays."""
    import torch
    net.rnn_clear_previous_state()
    try:
        with torch.inference_mode():
            rows = [net.rnn_time_step(dec_onehot(ids)[None])[0, -1]
                    .float().cpu().numpy()]
            toks = []
            for _ in range(n):
                toks.append(int(np.argmax(rows[-1])))
                rows.append(net.rnn_time_step(dec_onehot([toks[-1]]))[0]
                            .float().cpu().numpy())
        return toks, rows
    finally:
        net.rnn_clear_previous_state()


def run_threads(fn, args):
    """fn(*a) for each a in args, one thread each; returns the results in
    order, and raises if any thread failed."""
    out, errs = [None] * len(args), []

    def run(i, a):
        try:
            out[i] = fn(*a)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(f"{a[0]}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(i, a), daemon=True)
               for i, a in enumerate(args)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a session thread hung")
    check(not errs, "; ".join(errs))
    return out


def leaf_bytes(eng):
    """Bytes of one session's cache leaves (the host rows a decode ticket
    carries to the card and back)."""
    return sum(int(np.prod(s)) * np.dtype(d).itemsize for s, d in
               zip(eng.forward.carry_row_shapes, eng.forward.carry_np_dtypes))


def profile_forward(fn, reps=5):
    """Wall ms per call of fn() and the card's time in it by the profiler:
    (wall_ms, kernel_ms, copy_ms), each per call."""
    import torch
    fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(reps):
            fn()
    _, events, wall = profiled(body)
    total = sum(e.self_device_time_total for e in events) / 1e3 / reps
    copy = sum(e.self_device_time_total for e in events
               if "memcpy" in e.key.lower()
               or "memset" in e.key.lower()) / 1e3 / reps
    return wall / reps, total - copy, copy


def decode_rates(eng, tag, sessions, prompt_len=32, tokens=None):
    """Prefill ``sessions`` sessions, then decode ``tokens`` steps in each
    from its own thread: tokens/s of the decode and the inter-token
    times (ms) of every step."""
    tokens = tokens or DEC_TOKENS
    prompts = [dec_ids(prompt_len, SEED + 400 + i) for i in range(sessions)]
    sids = [f"{tag}{i}" for i in range(sessions)]
    first = run_threads(lambda s, p: eng.prefill(s, p), list(zip(sids,
                                                                 prompts)))

    def steps(sid, logits):
        times = []
        for _ in range(tokens):
            t0 = time.perf_counter()
            logits = eng.step(sid, int(np.argmax(logits)))
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    t0 = time.perf_counter()
    times = run_threads(steps, list(zip(sids, first)))
    wall = time.perf_counter() - t0
    for s in sids:
        eng.close_session(s)
    flat = sorted(t for ts in times for t in ts)
    return (sessions * tokens / wall,
            flat[len(flat) // 2], flat[min(len(flat) - 1,
                                           int(0.99 * len(flat)))])


def phase_decode():
    """gpt_mini at full width (BF16 policy) through DecodeEngine: 32
    concurrent sessions (prompts of 5-200 tokens, chunked prefill and
    prefix sharing on) bit-equal to the card's sequential greedy decode;
    a small pool's evictions recovered bit for bit; token by token against
    one-shot over 256 tokens; the card against the plain CPU path; then
    tokens/s at 1, 8 and 32 sessions, inter-token p50/p99, prefill ms,
    bytes moved and the card's busy share per decode step. Returns
    (net, {kernel: launches of the 32-session run})."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    from deeplearning4j_tpu_torch.serving import DecodeEngine, ServingStats

    net = dec_net("BF16")
    tbt_diff, tbt_err = token_by_token_vs_one_shot(net)
    check(tbt_diff == 0, f"token by token vs one-shot over {DEC_C} tokens: "
          f"{tbt_diff} positions differ (max {tbt_err:.3g})")
    prompts = [dec_prompt(i, n) for i, n in enumerate(DEC_PROMPTS)]
    t0 = time.perf_counter()
    refs = [greedy_reference(net, p, DEC_TOKENS) for p in prompts]
    ref_s = time.perf_counter() - t0

    stats = ServingStats()
    eng = DecodeEngine(net, n_pages=1024, stats=stats)
    try:
        # the system prompt's first user: its pages are in the pool when
        # the 32 sessions start, so the sessions that open with it adopt
        # them
        eng.prefill("system", dec_prompt(0, DEC_SHARED + 1))
        torch.cuda.synchronize()
        batches0 = stats.batches
        registry.reset_launches()
        t0 = time.perf_counter()
        got = run_threads(lambda s, p: eng.generate(s, p, DEC_TOKENS),
                          [(f"s{i}", p) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = registry.launches()
        d = eng.describe()
        batches = stats.batches - batches0
    finally:
        eng.stop()
    bad = [i for i, (g, r) in enumerate(zip(got, refs)) if g != r[0]]
    check(not bad, f"sessions {bad} differ from the sequential greedy "
          f"decode on the card")
    per_forward = {se.KERNEL_DENSE: 6 * DEC_L + 1, se.KERNEL_MHA: DEC_L,
                   se.KERNEL_NORM: 2 * DEC_L}
    for kern, n in per_forward.items():
        check(launches.get(kern, 0) == n * batches,
              f"{kern}: {launches.get(kern, 0)} launches in {batches} "
              f"forwards, expected {n} a forward")
    check(launches.get("flash_attn_fwd", 0) == 0,
          "the decode path launched flash_attn_fwd")
    check(d["prefix_hits"] > 0 and d["chunked_prefills"] > 0,
          f"sharing or chunking did not run: {d}")

    # a pool too small for its sessions: evictions re-prefilled bit for bit
    ev = DecodeEngine(net, n_pages=DEC_EVICT_PAGES)
    try:
        ev_prompts = [dec_ids(96 + 3 * i, SEED + 500 + i)
                      for i in range(DEC_EVICT_SESSIONS)]
        ev_refs = [greedy_reference(net, p, DEC_EVICT_STEPS)
                   for p in ev_prompts]
        logits = [ev.prefill(f"e{i}", p) for i, p in enumerate(ev_prompts)]
        ev_bits = all(np.array_equal(g, r[1][0])
                      for g, r in zip(logits, ev_refs))
        for k in range(DEC_EVICT_STEPS):
            for i, r in enumerate(ev_refs):
                logits[i] = ev.step(f"e{i}", r[0][k])
                ev_bits &= bool(np.array_equal(logits[i], r[1][k + 1]))
        evictions, reprefills = ev.pool.evictions, ev.reprefills
    finally:
        ev.stop()
    check(ev_bits, "logits after an eviction differ from the sequential "
          "reference")
    check(evictions > 0 and reprefills > 0,
          f"the small pool did not evict ({evictions}, {reprefills})")

    # the card against the plain CPU path on one short session (F32 work:
    # the streaming path runs in f32 under either policy; only exp may
    # differ in its last bit, and PyTorch's GELU and softmax on the CPU)
    cpu = cpu_copy(net)
    short = dec_ids(12, SEED + 600)
    card_rows = greedy_reference(net, short, 3)[1]
    cpu_rows = greedy_reference(cpu, short, 3)[1]
    cpu_err = max(float(np.abs(a - b).max())
                  for a, b in zip(card_rows, cpu_rows))
    check(cpu_err <= GPT_F32_TOL, f"decode logits card vs plain CPU path: "
          f"{cpu_err:.3e} > {GPT_F32_TOL}")

    # rates, latency, prefill, bytes and the busy share of a decode step
    eng = DecodeEngine(net, n_pages=1024)
    try:
        rates = {n: decode_rates(eng, f"r{n}_", n) for n in (1, 8, 32)}
        prefill_ms = {}
        for n in (16, 200):
            p = dec_ids(n, SEED + 700 + n)
            t0 = time.perf_counter()
            eng.prefill(f"pf{n}", p)
            prefill_ms[n] = (time.perf_counter() - t0) * 1e3
            eng.close_session(f"pf{n}")
        rows = 32
        for i in range(rows):
            eng.prefill(f"b{i}", dec_ids(32, SEED + 800 + i))
        leaves = [eng.pool.get(f"b{i}") for i in range(rows)]
        feats = [np.concatenate([dec_onehot([1])[None]] * rows)] + [
            np.concatenate([lv[j] for lv in leaves])
            for j in range(eng.forward.n_carries)]
        step_ms, kern_ms, copy_ms = profile_forward(
            lambda: eng.forward(feats))
        per_row = leaf_bytes(eng)
    finally:
        eng.stop()
    step_bytes = 2 * rows * per_row
    phase("decode", model=f"gpt_mini(vocab={DEC_V},width={DEC_W},"
          f"blocks={DEC_L},heads={DEC_H},cache={DEC_C},BF16)",
          sessions=DEC_SESSIONS, prompts=f"{DEC_PROMPTS[0]}-"
          f"{DEC_PROMPTS[-1]}", tokens=DEC_TOKENS,
          bit_equal_sequential=True, token_by_token_256_bit_equal=True,
          eviction_bit_equal=ev_bits, evictions=evictions,
          reprefills=reprefills, card_vs_cpu=f"{cpu_err:.3e}",
          cpu_tol=GPT_F32_TOL, run_s=f"{wall:.2f}",
          reference_s=f"{ref_s:.2f}", forwards=batches,
          prefill_chunks=d["prefill_chunks"],
          chunked_prefills=d["chunked_prefills"],
          interleaved_prefills=d["interleaved_prefills"],
          prefix_hits=d["prefix_hits"], shared_tokens=d["shared_tokens"],
          dedup_ratio=d["dedup_ratio"],
          tokens_per_s=json.dumps({n: round(r[0], 2)
                                   for n, r in rates.items()}),
          inter_token_p50_ms=json.dumps({n: round(r[1], 3)
                                         for n, r in rates.items()}),
          inter_token_p99_ms=json.dumps({n: round(r[2], 3)
                                         for n, r in rates.items()}),
          prefill_ms=json.dumps({n: round(t, 3)
                                 for n, t in prefill_ms.items()}),
          step_rows=rows, step_ms=f"{step_ms:.3f}",
          step_kernel_ms=f"{kern_ms:.3f}", step_copy_ms=f"{copy_ms:.3f}",
          step_busy_share=f"{(kern_ms + copy_ms) / step_ms:.4f}",
          step_bytes_each_way=step_bytes // 2,
          leaf_bytes_per_row=per_row,
          launches=json.dumps({k: launches.get(k, 0)
                               for k in per_forward}),
          launches_per_forward=json.dumps(per_forward))
    return net, {k: launches.get(k, 0) for k in per_forward}


def phase_decode_spec(net):
    """Speculative decode with gpt_mini_draft proposing k = 4 tokens a
    round: the streams are bit-equal to plain greedy decode; the
    acceptance rate and the target's forwards and launches per token."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    from deeplearning4j_tpu_torch.serving import DecodeEngine, ServingStats
    draft = dec_net("BF16", seed=SEED + 1, draft=True)
    prompts = [dec_ids(20 + 30 * i, SEED + 900 + i)
               for i in range(SPEC_SESSIONS)]
    refs = [greedy_reference(net, p, DEC_TOKENS)[0] for p in prompts]
    stats = ServingStats()
    eng = DecodeEngine(net, n_pages=1024, speculative=SPEC_K,
                       draft_net=draft, stats=stats)
    try:
        registry.reset_launches()
        t0 = time.perf_counter()
        got = run_threads(lambda s, p: eng.generate(s, p, DEC_TOKENS),
                          [(f"k{i}", p) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = registry.launches()
        d = eng.describe()
    finally:
        eng.stop()
    check(got == refs, "the speculative streams differ from plain greedy")
    check(d["spec_rounds"] > 0, f"no speculative round ran: {d}")
    tokens = SPEC_SESSIONS * DEC_TOKENS
    phase("decode_spec", draft="gpt_mini_draft(width=128,blocks=2,heads=2,"
          "BF16)", k=SPEC_K, sessions=SPEC_SESSIONS, tokens=DEC_TOKENS,
          bit_equal_plain=True, rounds=d["spec_rounds"],
          proposed=d["spec_proposed"], accepted=d["spec_accepted"],
          acceptance=f"{d['spec_accepted'] / max(1, d['spec_proposed']):.4f}",
          tokens_per_target_step=d["spec_accept_tokens_per_step"],
          target_forwards_per_token=f"{stats.batches / tokens:.4f}",
          draft_truncations=d["spec_draft_truncations"],
          stream_mha_launches_per_token=
          f"{launches.get(se.KERNEL_MHA, 0) / tokens:.3f}",
          tokens_per_s=f"{tokens / wall:.2f}")


def phase_decode_http(net):
    """serve(net, decode_engine=...) with 2 replicas end to end: four
    clients /decode generate over HTTP (bit-equal to the sequential
    reference), a step for an unknown session is recovered from its
    history or answered 404, and /predict on the same server runs K3."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.serving import DecodeEngine, serve
    prompts = [dec_ids(10 + 7 * i, SEED + 1000 + i) for i in range(4)]
    refs = [greedy_reference(net, p, 16) for p in prompts]
    srv = serve(net, port=0, warmup=False, replicas=2, max_batch=32,
                decode_engine=DecodeEngine(net, replicas=2, n_pages=1024))
    try:
        registry.reset_launches()

        def client(sid, p):
            status, body = post_json(srv.url + "/decode",
                                     {"op": "generate", "sid": sid,
                                      "ids": p, "n_tokens": 16})
            check(status == 200, f"/decode answered {status}")
            return body["tokens"]

        t0 = time.perf_counter()
        got = run_threads(client, [(f"h{i}", p)
                                   for i, p in enumerate(prompts)])
        wall = time.perf_counter() - t0
        check(got == [r[0] for r in refs], "/decode generate differs from "
              "the sequential reference")
        toks, rows = refs[0]
        status, body = post_json(srv.url + "/decode",
                                 {"op": "step", "sid": "moved",
                                  "ids": prompts[0], "token": toks[0]})
        check(status == 200 and body["recovered"] and np.array_equal(
            np.asarray(body["logits"], np.float32), rows[1]),
            "a recovered step differs from the reference")
        try:
            post_json(srv.url + "/decode", {"op": "step", "sid": "ghost",
                                            "token": 1})
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        check(code == 404, f"an unknown session answered {code}, not 404")
        x = dec_onehot(dec_ids(2 * 64, SEED + 1100)).reshape(2, 64, DEC_V)
        status, body = post_json(srv.url + "/predict",
                                 {"features": x.tolist()})
        check(status == 200, f"/predict answered {status}")
        torch.cuda.synchronize()
        launches = registry.launches()
        status, health = get_json(srv.url + "/healthz")
        check(len(health["replicas"]) == 2 and "decode" in health,
              f"/healthz: {health}")
    finally:
        srv.stop()
    check(launches.get("flash_attn_fwd", 0) == DEC_L,
          f"/predict launched flash_attn_fwd "
          f"{launches.get('flash_attn_fwd', 0)} times, expected {DEC_L}")
    check(launches.get("stream_mha", 0) > 0, "/decode ran no stream_mha")
    phase("decode_http", replicas=2, clients=len(prompts), tokens=16,
          bit_equal_sequential=True, recovered_step_bit_equal=True,
          unknown_session=404, tokens_per_s=f"{64 / wall:.2f}",
          launches=json.dumps({k: launches.get(k, 0) for k in (
              "stream_dense", "stream_mha", "stream_rownorm",
              "flash_attn_fwd")}))


def phase_decode_lstm():
    """The char-RNN (vocab 80, hidden 512, 2 layers, BF16) through the
    decode engine: its carries (h, c) have no token axis, so it decodes
    unpaged, through rnn_time_step's streaming K1 on the cluster route.
    Fed the sequential reference's tokens from 8 threads, its logits are
    held to PROB_TOL ([stream]'s limit) and said bit-equal or not."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.serving import DecodeEngine
    net = zoo.char_rnn(seed=SEED)
    prompts = [dec_ids(5 + 8 * i, SEED + 1200 + i)
               for i in range(LSTM_SESSIONS)]
    refs = [greedy_reference(net, p, LSTM_TOKENS) for p in prompts]
    eng = DecodeEngine(net)
    try:
        registry.reset_launches()

        def session(sid, p, ref):
            toks, rows = ref
            got = [eng.prefill(sid, p)]
            for tok in toks:
                got.append(eng.step(sid, tok))
            return [float(np.abs(g - r).max()) for g, r in zip(got, rows)]

        errs = run_threads(session, [(f"l{i}", p, r) for i, (p, r)
                                     in enumerate(zip(prompts, refs))])
        torch.cuda.synchronize()
        launches = registry.launches()
    finally:
        eng.stop()
    err = max(max(e) for e in errs)
    check(err <= PROB_TOL, f"char-RNN engine vs sequential reference: "
          f"{err:.3e} > {PROB_TOL}")
    check(launches.get("lstm_fwd_sm90", 0) > 0
          and launches.get("lstm_fwd_sm90") == launches.get("lstm_fwd"),
          f"the char-RNN engine left K1's cluster route: {launches}")
    phase("decode_lstm", model="char_rnn(vocab=80,hidden=512,layers=2,"
          "BF16)", sessions=LSTM_SESSIONS, tokens=LSTM_TOKENS,
          max_abs_err_vs_sequential=f"{err:.3e}", tol=PROB_TOL,
          bit_equal=err == 0.0, lstm_fwd=launches.get("lstm_fwd", 0),
          lstm_fwd_sm90=launches.get("lstm_fwd_sm90", 0))


def dense_time_case(g, rows, f, n):
    """S1's timing case at x [rows, f] @ W [f, n] + b: (args, library call,
    its name, operations, bytes). The product and the sum are rounded
    apart, two f32 instructions each where an FMA would be one: counted
    as 2 x 2 rows f n flops against the FMA rate (67 TFLOP/s counts an
    FMA as two)."""
    import torch
    r = lambda *s: torch.randn(*s, generator=g).cuda()  # noqa: E731
    x, Wm, b = r(rows, f), r(f, n) * f ** -0.5, r(n)
    return ((x, Wm, b), lambda: torch.addmm(b, x, Wm), "torch.addmm",
            4 * rows * f * n, 4 * (rows * f + f * n + n + rows * n))


def mha_time_case(g, rows, t=1):
    """S2's timing case: q [rows, t, 4, 64] against caches of DEC_C rows at
    random positions 5 ... DEC_C - t (args, masked SDPA, its name,
    operations over every (query row, visible position) and bytes of the
    visible k and v rows, q, the output and the positions)."""
    import torch
    import torch.nn.functional as F
    hd = DEC_W // DEC_H
    r = lambda *s: torch.randn(*s, generator=g).cuda()  # noqa: E731
    q, k, v = r(rows, t, DEC_H, hd), r(rows, DEC_C, DEC_H, hd), \
        r(rows, DEC_C, DEC_H, hd)
    pos = torch.randint(5, DEC_C - t + 1, (rows,), generator=g).to(
        torch.int32)
    kv_rows = int((pos + t).sum())          # k and v rows read
    pairs = int((pos + 1).sum()) * t + rows * t * (t - 1) // 2
    pos = pos.cuda()
    mask = (torch.arange(DEC_C, device="cuda")[None, None, :]
            <= (pos[:, None] + torch.arange(t, device="cuda"))[:, :, None]
            )[:, None]
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    return ((q, k, v, pos), lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask),
        "torch.nn.functional.scaled_dot_product_attention(attn_mask)",
        4 * DEC_H * hd * pairs,
        4 * (2 * rows * t * DEC_H * hd + 2 * DEC_H * hd * kv_rows)
        + 4 * rows)


def norm_time_case(g, rows, w=DEC_W):
    """S3's timing case at x [rows, w]: (args, F.layer_norm, its name,
    operations, bytes: x read and y written once, gamma and beta)."""
    import torch
    import torch.nn.functional as F
    r = lambda *s: torch.randn(*s, generator=g).cuda()  # noqa: E731
    x, ln_g, ln_b = r(rows, w) * 3.0, r(w) * 0.1 + 1.0, r(w) * 0.1
    return ((x, ln_g, ln_b, 1e-5),
            lambda: F.layer_norm(x, (w,), ln_g, ln_b, 1e-5),
            "torch.nn.functional.layer_norm", 8 * rows * w,
            4 * (2 * rows * w + 2 * w))


def rownorm_ascending(x, gamma, beta, eps):
    """LayerNorm in S3's first version's order: each row's two sums one
    ascending chain, the rest as stream_rownorm_torch; what S3's first
    version is held to."""
    import torch
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    w = x.shape[-1]
    s = torch.zeros(x.shape[:-1] + (1,), device=x.device)
    for i in range(w):
        s = torch.add(s, x[..., i:i + 1])
    d = torch.sub(x, se._full_div(s, w))
    ss = torch.zeros_like(s)
    for i in range(w):
        ss = torch.add(ss, torch.mul(d[..., i:i + 1], d[..., i:i + 1]))
    var = torch.add(se._full_div(ss, w), float(eps))
    inv = torch.div(torch.ones_like(var), torch.sqrt(var))
    return torch.add(torch.mul(torch.mul(d, inv), gamma), beta)


def stream_time_cases():
    """(kernel, args, library call, flops, bytes) for the timing of each S
    kernel at the decode step's shape (32 rows): the MLP's up projection,
    the attention at random positions, the block's LayerNorm."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(SEED + 160)
    rows, W = 32, DEC_W
    return {
        "stream_dense": dense_time_case(g, rows, W, 4 * W),
        "stream_mha": mha_time_case(g, rows),
        "stream_rownorm": norm_time_case(g, rows),
    }


def events_floor(card, tag="times"):
    """device_ms_per_call of an almost empty launch (an add to one f32):
    what the device-time method reads for a launch that does nothing,
    the card's own gap between back-to-back launches included."""
    import torch
    one = torch.zeros(1, device="cuda")
    readings = [device_ms_per_call(lambda: one.add_(1.0), 50)[0]
                for _ in range(3)]
    phase(tag, kernel="events_floor", card=json.dumps(card),
          device_ms=f"{statistics.median(readings):.5f}",
          readings=json.dumps([round(t, 5) for t in readings]),
          device_method=DEVICE_METHOD, device_calls_timed=50)


def max_sm_clock_hz():
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6




def phase_times_stream(card, errs, launches):
    """S1-S3 at the decode step's shapes beside their bounds, their plain
    versions and one PyTorch call of the same function (the yardstick
    only; the port never calls it). Returns the kernels' JSON entries."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    plain = {se.KERNEL_DENSE: se.stream_dense_torch,
             se.KERNEL_MHA: se.stream_mha_torch,
             se.KERNEL_NORM: se.stream_rownorm_torch}
    first = {se.KERNEL_DENSE: se.dense_launch_v1,
             se.KERNEL_MHA: se.mha_launch_v1,
             se.KERNEL_NORM: se.rownorm_launch_v1}
    entries = []
    events_floor(card)
    with torch.inference_mode():
        for name, (args, lib, lib_name, flops, nbytes) in \
                stream_time_cases().items():
            kern = registry.get(name, "cuda")
            run = lambda: kern(*args)  # noqa: E731
            ms = cuda_ms_per_launch(run, reps=10)
            plain_ms = cuda_ms(lambda: plain[name](*args), reps=3)
            lib_ms = cuda_ms_per_launch(lib, reps=10)
            # back to back these calls are issued more slowly than the card
            # runs them: the profiler's device times, in turns, and the
            # host's time to issue one call
            dev, dev_lib = [], []
            for _ in range(2):
                dev.append(device_ms_per_call(run, reps=50)[0])
                dev_lib.append(device_ms_per_call(lib, reps=50)[0])
            dev_ms, dev_lib_ms = statistics.mean(dev), statistics.mean(dev_lib)
            host_ms = host_ms_per_call(run)
            bound_ms, bound_by = bound(flops, nbytes, "float32")
            old = {}
            if name in first:   # the first version (PR 15) beside it
                v1 = lambda: first[name](*args)  # noqa: E731
                old = dict(first_version_ms=cuda_ms_per_launch(v1, reps=10),
                           first_version_device_ms=device_ms_per_call(
                               v1, reps=50)[0],
                           first_version_host_issue_ms=host_ms_per_call(v1))
            phase("times", kernel=name, route="cuda", card=json.dumps(card),
                  ms=f"{ms:.4f}", device_ms=f"{dev_ms:.4f}",
                  device_method=DEVICE_METHOD, device_calls_timed=50,
                  device_ms_readings=json.dumps([round(t, 5) for t in dev]),
                  host_issue_ms=f"{host_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                  library=lib_name, library_ms=f"{lib_ms:.4f}",
                  library_device_ms=f"{dev_lib_ms:.4f}",
                  library_device_ms_readings=json.dumps(
                      [round(t, 5) for t in dev_lib]),
                  device_roofline_share=f"{bound_ms / dev_ms:.4f}",
                  bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
                  flops=f"{flops:.4g}", bytes=f"{nbytes:.4g}",
                  roofline_share=f"{bound_ms / ms:.4f}",
                  **{k: f"{t:.4f}" for k, t in old.items()})
            entries.append({
                "name": name, "route": "cuda",
                "source": "deeplearning4j_tpu_torch/ops/csrc/stream_exact.cu",
                "replaces": ("none: deeplearning4j_tpu/nn/layers/attention.py"
                             ":63 _dense_exact (XLA)" if name == "stream_dense"
                             else "none: deeplearning4j_tpu/ops/attention.py"
                             ":91 _causal_mha_exact (XLA)"
                             if name == "stream_mha" else
                             "none: deeplearning4j_tpu/nn/layers/attention."
                             "py:52 _layer_norm (XLA)"),
                "launches": launches.get(name, 0),
                "max_abs_err": errs.get(name, 0.0), "ms": ms,
                "device_ms": dev_ms, "host_issue_ms": host_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
                "library_device_ms": dev_lib_ms, **old})
    return entries


def phase_stream_split():
    """S1, S2 and S3, the redesigned kernels, beside their first versions
    at the decode step's shapes, each in one run: S1 at fc1 [32, 256] x
    [256, 1024] and fc2 [32, 1024] x [1024, 256], S2 at a 32-row step and
    a 16-token chunk of 4 rows, S3 at [32, 256], [64, 256] (a 16-token
    chunk of 4 rows) and [2048, 256]. In turns (first, new, library,
    library, new, first): back to back by CUDA events, the device time
    (device_ms_per_call), the host's time to issue a call; the plain
    version once; the bound, S1's chain floor (f dependent adds at the
    card's top SM clock). The new versions are held bit-equal to the
    plain one, S1's and S2's first versions too, S3's to its own order
    (rownorm_ascending). Then S1's device time at every (rows a thread,
    warps a block) its plan can choose, at fc1 and fc2. The chain floor comes from the card itself
    (stream_exact.chain_cycles: cycles a dependent add takes)."""
    import torch
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    clock = max_sm_clock_hz()
    # a chain step's cycles: a chain of f dependent adds takes at least f
    # times this; and the same step with its operands read from shared
    # memory just before it (what an unhidden read costs)
    step_cycles, step_cycles_smem = se.chain_cycles()
    phase("stream_floor", cycles_per_chain_step=f"{step_cycles:.3f}",
          cycles_per_chain_step_smem_read=f"{step_cycles_smem:.3f}",
          sm_clock_mhz=f"{clock / 1e6:.0f}")
    events_floor(None, tag="stream_floor")
    g = torch.Generator(device="cpu").manual_seed(SEED + 161)
    W = DEC_W
    cases = {
        "dense_fc1_32x256x1024": (se.KERNEL_DENSE,
                                  dense_time_case(g, 32, W, 4 * W)),
        "dense_fc2_32x1024x256": (se.KERNEL_DENSE,
                                  dense_time_case(g, 32, 4 * W, W)),
        "mha_step_b32_t1": (se.KERNEL_MHA, mha_time_case(g, 32)),
        "mha_chunk_b4_t16": (se.KERNEL_MHA, mha_time_case(g, 4, 16)),
        "rownorm_step_32x256": (se.KERNEL_NORM, norm_time_case(g, 32)),
        "rownorm_chunk_64x256": (se.KERNEL_NORM, norm_time_case(g, 64)),
        "rownorm_2048x256": (se.KERNEL_NORM, norm_time_case(g, 2048)),
    }
    fns = {se.KERNEL_DENSE: (se.stream_dense_cuda, se.dense_launch_v1,
                             se.stream_dense_torch),
           se.KERNEL_MHA: (se.stream_mha_cuda, se.mha_launch_v1,
                           se.stream_mha_torch),
           se.KERNEL_NORM: (se.stream_rownorm_cuda, se.rownorm_launch_v1,
                            se.stream_rownorm_torch)}
    # the first version of S3 sums in its own order
    first_ref = {se.KERNEL_NORM: rownorm_ascending}
    with torch.inference_mode():
        for case, (kern, (args, lib, lib_name, flops, nbytes)) in \
                cases.items():
            new, v1, plain = fns[kern]
            for who, fn, ref in (("new", new, plain),
                                 ("first", v1, first_ref.get(kern, plain))):
                got, want = fn(*args), ref(*args)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"{case}: the {who} version "
                      f"differs from {ref.__name__} (max "
                      f"{float((got - want).abs().max()):.3g})")
            run = {"first": lambda: v1(*args), "new": lambda: new(*args),
                   "library": lib}
            b2b = {k: [] for k in run}
            dev = {k: [] for k in run}
            for who in ("first", "new", "library", "library", "new",
                        "first"):
                b2b[who].append(cuda_ms_per_launch(run[who], reps=10))
                dev[who].append(device_ms_per_call(run[who], reps=50)[0])
            host = {k: host_ms_per_call(fn) for k, fn in run.items()}
            plain_ms = cuda_ms(lambda: plain(*args), reps=3)
            bound_ms, bound_by = bound(flops, nbytes, "float32")
            if kern == se.KERNEL_DENSE:
                rows, f = args[0].shape
                plan = se.dense_plan(rows, f, args[1].shape[1])
                floor_ms = f * step_cycles / clock * 1e3
                extra = dict(chain_floor_ms=f"{floor_ms:.5f}")
            elif kern == se.KERNEL_MHA:
                plan = se.mha_plan(*args[0].shape, args[1].shape[1])
                extra = {}
            else:
                plan = None
                extra = dict(cols_a_lane=se.rownorm_plan(*args[0].shape))
            if plan is not None:
                extra["plan"] = json.dumps(plan._asdict())
            phase("stream_split", case=case, kernel=kern,
                  device_method=DEVICE_METHOD, device_calls_timed=50,
                  **{f"{k}_ms": f"{statistics.mean(v):.4f}"
                     for k, v in b2b.items()},
                  **{f"{k}_device_ms": f"{statistics.mean(v):.4f}"
                     for k, v in dev.items()},
                  **{f"{k}_host_issue_ms": f"{t:.4f}"
                     for k, t in host.items()},
                  device_readings=json.dumps(
                      {k: [round(t, 5) for t in v] for k, v in dev.items()}),
                  plain_ms=f"{plain_ms:.4f}", library=lib_name,
                  bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
                  sm_clock_mhz=f"{clock / 1e6:.0f}", **extra)
        sweep_cases = {
            "dense_qkvo_32x256x256": dense_time_case(g, 32, W, W)[0],
            "dense_fc1_32x256x1024": cases["dense_fc1_32x256x1024"][1][0],
            "dense_fc2_32x1024x256": cases["dense_fc2_32x1024x256"][1][0],
            "dense_head_32x256x80": dense_time_case(g, 32, W, DEC_V)[0]}
        for case, (x, Wm, b) in sweep_cases.items():
            want = se.stream_dense_torch(x, Wm, b)
            sweep = {}
            for rt, tc, wb in itertools.product((1, 2, 4), (4, 16),
                                                (1, 2, 4)):
                plan = se.dense_plan(x.shape[0], Wm.shape[0], Wm.shape[1],
                                     rt=rt, tc=tc, wb=wb)
                got = se._dense_launch(x, Wm, b, plan=plan)
                check(torch.equal(got, want),
                      f"{case}: rt={rt}, tc={tc}, wb={wb} moved bits")
                sweep[f"rt{rt}_tc{tc}_wb{wb}"] = round(device_ms_per_call(
                    lambda: se._dense_launch(x, Wm, b, plan=plan),
                    reps=50)[0], 5)
            chosen = se.dense_plan(x.shape[0], Wm.shape[0], Wm.shape[1])
            phase("stream_split", case=f"{case}_plans",
                  chosen=json.dumps(chosen._asdict()),
                  chosen_device_ms=sweep[f"rt{chosen.rt}_tc{chosen.tc}"
                                         f"_wb{chosen.wb}"],
                  fastest=min(sweep, key=sweep.get),
                  device_ms=json.dumps(sweep))


def stream_grads_vs_plain():
    """Gradients through the S kernels' autograd Functions (a truncated
    BPTT step through the streaming path) against autograd of their plain
    versions, on the card: the largest error over FLASH_GRAD_TOL * (1 +
    |want|)."""
    import torch
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    g = torch.Generator(device="cpu").manual_seed(SEED + 170)
    r = lambda *s: torch.randn(*s, generator=g).cuda()  # noqa: E731
    cases = [(se.stream_dense_cuda, se.stream_dense_torch,
              [r(4, 3, 64), r(64, 48) * 0.1, r(48)], ()),
             (se.stream_rownorm_cuda, se.stream_rownorm_torch,
              [r(4, 3, 64) * 3.0, r(64) * 0.1 + 1.0, r(64) * 0.1], (1e-5,)),
             (se.stream_mha_cuda, se.stream_mha_torch,
              [r(2, 3, 4, 16), r(2, 12, 4, 16), r(2, 12, 4, 16)],
              (torch.tensor([0, 7], dtype=torch.int32, device="cuda"),))]
    worst = 0.0
    for fn, ref, args, extra in cases:
        grads = []
        for f in (fn, ref):
            leaves = [a.clone().requires_grad_() for a in args]
            out = f(*leaves, *extra)
            w = torch.cos(torch.arange(out.numel(), device="cuda",
                                       dtype=torch.float32)).reshape(
                out.shape)
            grads.append(torch.autograd.grad((out * w).sum(), leaves))
        for got, want in zip(*grads):
            ratio = float(((got - want).abs()
                           / (FLASH_GRAD_TOL * (1.0 + want.abs()))).max())
            check(ratio <= 1.0, f"{fn.__name__} gradients vs autograd of "
                  f"its plain version: {ratio:.3f} of the tolerance")
            worst = max(worst, ratio)
    phase("stream_grads_vs_plain", worst_ratio=f"{worst:.4f}",
          tol=FLASH_GRAD_TOL)


def phase_slice15(card):
    """The phases of slice 15, in order. Returns the S kernels' JSON
    entries."""
    phase_stream_invariance()
    errs = phase_stream_exact_vs_plain()
    stream_grads_vs_plain()
    net, launches = phase_decode()
    phase_decode_spec(net)
    phase_decode_http(net)
    phase_decode_lstm()
    return phase_times_stream(card, errs, launches)


# ------------------------------------------------------------- live reload
# [live_reload]: 4 clients x LR_REQUESTS one-row requests from a pool of
# LR_POOL distinct rows of T = 256, max_batch 2 (every forward one bucket
# of two rows, so a row's bits are its own and its version's)
LR_CLIENTS, LR_REQUESTS, LR_POOL, LR_T = 4, 24, 8, 256


def phase_live_reload():
    """Live reload at full width: gpt_mini (vocab 80, width 256, 4 blocks
    of 4 heads, BF16) from two seeds, saved as two port checkpoints and
    published into a WeightStore; a ModelServer with 2 replicas warmed on
    v1 (load_net) serves 4 client threads of one-row predict calls while
    hot_swap(publication=v2) runs. Checks: no error, no reply lost or
    doubled; every reply bit-equal to v1's or v2's reply to the same row
    alone, both seen, and every reply after the swap v2's, which equals
    load_net(v2.path)'s output; no kernel built and no kernel-cache miss
    across the traffic and the swap; K3 launched 4 times a served
    forward; a NaN-poisoned net swapped in counted in nan_rows_total;
    rollback() then hot_swap(store.latest()) serves v1's bits again.
    Reported: swap_s, load_net ms, reply p50/p99 before and during the
    swap."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.observability import metrics as obs
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.serving import (ModelServer, WeightStore,
                                                  load_net)
    from deeplearning4j_tpu_torch.utils.checkpoint import save_checkpoint

    V, T = DEC_V, LR_T
    rng = np.random.default_rng(SEED + 171)
    pool = np.eye(V, dtype=np.float32)[rng.integers(0, V, (LR_POOL, 1, T))]
    root = tempfile.mkdtemp(prefix="live_reload_")
    srv = None
    try:
        store = WeightStore(os.path.join(root, "store"), keep=3)
        pubs = []
        for v in (1, 2):
            net = zoo.gpt_mini(seed=SEED + 170 + v)
            ckpt = os.path.join(root, f"train_{v}", "step_10")
            save_checkpoint(net, ckpt)
            pubs.append(store.publish(ckpt))
            del net
        p1, p2 = pubs
        check(p1.fingerprint == p2.fingerprint,
              f"one configuration, two fingerprints: {p1}, {p2}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v2_net = load_net(p2.path)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3

        srv = ModelServer(load_net(p1.path), port=0, max_batch=2,
                          replicas=2, input_shapes=[(T, V)])
        srv.start()

        def served(x):
            return srv.predict(x)
        ref = {1: [served(x) for x in pool]}
        ref[2] = [v2_net.output(np.concatenate([x, np.zeros_like(x)]))
                  .float().cpu().numpy()[:1] for x in pool]
        check(all(not np.array_equal(a, b) for a, b in zip(ref[1], ref[2])),
              "v1 and v2 agree on a row: the check could not tell them "
              "apart")
        torch.cuda.synchronize()

        picks = rng.integers(0, LR_POOL, (LR_CLIENTS, LR_REQUESTS))
        replies = [[None] * LR_REQUESTS for _ in range(LR_CLIENTS)]
        times = [[None] * LR_REQUESTS for _ in range(LR_CLIENTS)]
        errors = []
        half = threading.Event()
        done = [0]
        lock = threading.Lock()

        def client(c):
            for j, i in enumerate(picks[c]):
                t_a = time.perf_counter()
                try:
                    replies[c][j] = served(pool[i])
                except Exception as e:  # noqa: BLE001 — the main thread checks
                    errors.append(f"client {c}: {type(e).__name__}: {e}")
                times[c][j] = (t_a, time.perf_counter())
                with lock:
                    done[0] += 1
                    if done[0] >= LR_CLIENTS * LR_REQUESTS // 3:
                        half.set()

        base = obs.compile_snapshot()
        batches0 = srv.metrics()["batches_total"]
        registry.reset_launches()
        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(LR_CLIENTS)]
        for t in threads:
            t.start()
        half.wait(timeout=300)
        swap_t0 = time.perf_counter()
        rec = srv.hot_swap(publication=p2)
        swap_t1 = time.perf_counter()
        for t in threads:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in threads), "a client hung")
        torch.cuda.synchronize()
        launches = registry.launches().get(att.KERNEL, 0)
        forwards = srv.metrics()["batches_total"] - batches0
        delta = obs.compile_delta(base)
        check(not errors, "; ".join(errors[:5]))
        got = [(picks[c][j], replies[c][j], times[c][j])
               for c in range(LR_CLIENTS) for j in range(LR_REQUESTS)]
        check(all(r is not None for _, r, _ in got) and
              len(got) == LR_CLIENTS * LR_REQUESTS,
              "a reply was lost")
        which = []
        for i, r, (t_a, _) in got:
            v = 1 if np.array_equal(r, ref[1][i]) else \
                2 if np.array_equal(r, ref[2][i]) else None
            check(v is not None, f"a reply of row {i} is neither v1's nor "
                  f"v2's bit for bit")
            check(not (t_a > swap_t1 and v != 2),
                  f"a request sent after the swap got v{v}'s reply")
            which.append(v)
        check(1 in which and 2 in which,
              f"the traffic saw only v{which[0]}: the swap did not land "
              f"mid-traffic")
        check(srv.metrics()["requests_total"] >= len(got) + LR_POOL,
              "the server counted fewer requests than were sent")
        check(rec["fresh_compiles"] == 0 and delta["count"] == 0
              and delta["cache_misses"] == 0,
              f"kernels built across the swap: {rec}, {delta}")
        check(rec["replicas_swapped"] == 2, f"swap receipt {rec}")
        check(launches == 4 * forwards,
              f"K3 launched {launches} times in {forwards} served forwards, "
              f"expected 4 a forward")
        after = [served(x) for x in pool]
        check(all(np.array_equal(a, b) for a, b in zip(after, ref[2])),
              "after the swap a reply differs from load_net(v2)'s output")

        def lat(sel):
            ms = sorted((t_b - t_a) * 1e3 for _, _, (t_a, t_b) in got
                        if sel(t_a, t_b))
            return ([round(float(np.percentile(ms, q)), 3) for q in (50, 99)]
                    if ms else None), len(ms)
        before, n_before = lat(lambda a, b: a < swap_t0)
        during, n_during = lat(lambda a, b: a <= swap_t1 and b >= swap_t0)

        # the NaN sentinel: a poisoned version counts its rows
        poisoned = load_net(p2.path)
        poisoned.params = {ln: {k: torch.full_like(t, float("nan"))
                                for k, t in lp.items()}
                           for ln, lp in poisoned.params.items()}
        nan0 = srv.metrics()["nan_rows_total"]
        srv.hot_swap(net=poisoned, version=99)
        out = served(pool[0])
        nan_rows = srv.metrics()["nan_rows_total"] - nan0
        check(not np.isfinite(out).all() and nan_rows == 1,
              f"the poisoned version's row was not counted ({nan_rows})")
        check(srv.health()[1]["model_version"] == 99,
              "health() does not report the swapped version")
        # roll back: v2 rejected, LATEST v1, swapped back to v1's bits
        back = store.rollback("live_reload check")
        check(back.version == 1 and store.latest().version == 1,
              f"rollback landed on {back}")
        rec1 = srv.hot_swap(publication=store.latest())
        again = [served(x) for x in pool]
        check(all(np.array_equal(a, b) for a, b in zip(again, ref[1])),
              "after rollback the replies are not v1's bits")
        check(rec1["fresh_compiles"] == 0 and srv.model_version == 1
              and srv.swaps_total == 3,
              f"rollback swap {rec1}, version {srv.model_version}, swaps "
              f"{srv.swaps_total}")
        prom = obs.get_registry().render_prometheus()
        check("dl4j_serving_weight_swaps_total" in prom and
              "dl4j_serving_model_version" in prom,
              "the swap families are missing from the registry")
        phase("live_reload", model="gpt_mini(vocab=80,width=256,blocks=4,"
              "heads=4,T=256,BF16)", replicas=2, clients=LR_CLIENTS,
              requests=len(got), forwards=forwards,
              replies_v1=which.count(1), replies_v2=which.count(2),
              errors=len(errors), bit_equal=True,
              swap_s=f"{rec['swap_s']:.6f}", load_net_ms=f"{load_ms:.1f}",
              fresh_compiles=rec["fresh_compiles"],
              cache_misses=delta["cache_misses"],
              flash_attn_fwd_launches=launches,
              launches_per_forward=f"{launches / forwards:g}",
              p50_p99_ms_before=json.dumps(before), requests_before=n_before,
              p50_p99_ms_during=json.dumps(during), requests_during=n_during,
              nan_rows_counted=nan_rows, rollback_swap_s=
              f"{rec1['swap_s']:.6f}", model_version=srv.model_version,
              swaps_total=srv.swaps_total, fingerprint=rec["fingerprint"])
        return {att.KERNEL: launches}
    finally:
        if srv is not None:
            srv.stop()
        shutil.rmtree(root, ignore_errors=True)


# [front_door]: gpt_mini at full width behind a FrontDoorRouter over two
# host processes sharing the one card. Each host serves /predict with 2
# replicas of max_batch 2 (a row's bits depend only on the row, as in
# [live_reload]) and a queue of FD_MAX_QUEUE tickets, so its scheduler's
# class watermarks (best_effort at 1 pending, batch at 2, interactive at
# 4) trip under overload; /decode through a DecodeEngine; a heartbeat to
# the router every FD_PUSH_S.
FD_T, FD_ROWS, FD_CLIENTS, FD_MAX_QUEUE, FD_PUSH_S = 256, 64, 8, 4, 0.5
# the router's stale window and its auto-evict factor
FD_STALE_S, FD_EVICT = 5.0, 2.0
# gate 2: open-loop arrivals at twice gate 1's rows/s for FD_ADMIT_S, the
# class mix, two tenants, t2's quota (rows/s, burst)
FD_ADMIT_S, FD_MIX = 6.0, {"interactive": 0.5, "batch": 0.3,
                           "best_effort": 0.2}
FD_QUOTA = (20.0, 10.0)
# gate 3: sessions, tokens each, the step before which a host is killed
FD_SESSIONS, FD_TOKENS, FD_KILL_AT = 8, 32, 8


def front_door_host(zip_path, push_url, out_path):
    """One host process of [front_door]: restores the parent's gpt_mini
    zip on the card, serves it with a DecodeEngine and pushes heartbeats
    to ``push_url``; prints its URL when it takes traffic. On SIGTERM it
    stops (which stamps RunReport.slo) and writes its launch counts since
    it took traffic, its forwards, its kernel builds and its SLO report to
    ``out_path``."""
    import signal

    import torch
    from deeplearning4j_tpu_torch.observability import distributed as dist
    from deeplearning4j_tpu_torch.observability import metrics as obs
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.serving import (DecodeEngine, ServingStats,
                                                  serve)
    from deeplearning4j_tpu_torch.utils.serialization import \
        restore_multi_layer_network
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    base = obs.compile_snapshot()
    net = restore_multi_layer_network(zip_path)
    dstats = ServingStats()
    srv = serve(net, port=0, max_batch=2, max_queue=FD_MAX_QUEUE,
                replicas=2, input_shapes=[(FD_T, DEC_V)],
                decode_engine=DecodeEngine(net, n_pages=1024, stats=dstats),
                push_url=push_url, push_interval_s=FD_PUSH_S)
    torch.cuda.synchronize()
    registry.reset_launches()
    p0, d0 = srv.stats.batches, dstats.batches
    print(f"FRONT_DOOR_HOST {srv.url}", flush=True)
    while not stop.wait(0.2):
        pass
    srv.stop()
    torch.cuda.synchronize()
    delta = obs.compile_delta(base)
    report = srv.run_report
    with open(out_path, "w") as f:
        json.dump({"url": srv.url, "tag": dist.get_identity().tag,
                   "launches": registry.launches(),
                   "predict_forwards": srv.stats.batches - p0,
                   "decode_forwards": dstats.batches - d0,
                   "builds": delta["count"],
                   "cache_misses": delta["cache_misses"],
                   "slo": report.slo if report is not None else None,
                   "sched": srv.scheduler.snapshot()}, f)


class _Host:
    """A [front_door] host process: its stdout read on a thread, its
    stderr in a file."""

    def __init__(self, i, zip_path, push_url, root):
        self.tag = f"front-door-host-{i}"
        self.out = os.path.join(root, f"host{i}.json")
        self.err = open(os.path.join(root, f"host{i}.err"), "w")
        env = dict(os.environ, DL4J_TPU_INSTANCE=self.tag)
        code = (f"import chip_smoke as c; c.front_door_host({zip_path!r}, "
                f"{push_url!r}, {self.out!r})")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=self.err, text=True, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        self.url = None
        self.ready = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            if line.startswith("FRONT_DOOR_HOST "):
                self.url = line.split()[1]
                self.ready.set()
        self.ready.set()

    def stderr_tail(self):
        self.err.flush()
        with open(self.err.name) as f:
            return f.read()[-2000:]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)
        self.err.close()


def _raw_post(url, body, headers=None, timeout=120):
    """POST raw JSON bytes: (status, headers, body bytes), an error reply
    the same way."""
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _pct(ms, q):
    return round(float(np.percentile(ms, q)), 3) if len(ms) else None


def fd_routing(router, hosts, net, rng):
    """Gate 1: FD_ROWS one-row /predict requests from FD_CLIENTS threads
    through the router, each reply bit-equal to the row through the
    parent's net.output (in a bucket of two, beside a row of zeros), both
    backends seen; the router's added latency against a host called
    directly; one traced request stitched from the router's and a host's
    spans. Returns rows/s."""
    from deeplearning4j_tpu_torch.observability import distributed as dist
    from deeplearning4j_tpu_torch.serving.router import BACKEND_HEADER
    x = np.eye(DEC_V, dtype=np.float32)[rng.integers(0, DEC_V,
                                                     (FD_ROWS, 1, FD_T))]
    bodies = [json.dumps({"features": r.tolist()}).encode() for r in x]
    refs = [net.output(np.concatenate([r, np.zeros_like(r)])).float()
            .cpu().numpy()[:1] for r in x]
    got = [None] * FD_ROWS
    per = FD_ROWS // FD_CLIENTS

    def client(c):
        for i in range(c * per, (c + 1) * per):
            got[i] = _raw_post(router.url + "/predict", bodies[i])

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(FD_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a /predict client hung")
    rate = FD_ROWS / wall
    check(all(g is not None and g[0] == 200 for g in got),
          f"/predict through the router: {[g and g[0] for g in got]}")
    backends = {g[1].get(BACKEND_HEADER) for g in got}
    bad = [i for i, (g, r) in enumerate(zip(got, refs)) if not
           np.array_equal(np.asarray(json.loads(g[2])["predictions"],
                                     np.float32), r)]
    check(not bad, f"rows {bad[:8]} through the router differ from the "
          f"parent's net.output")
    check(backends == {h.url for h in hosts},
          f"the router used {backends}, not both hosts")
    # the router's added latency: the same row direct and routed, in turns
    direct, routed = [], []
    for k in range(32):
        for url, ms in ((hosts[k % 2].url, direct), (router.url, routed)):
            t_a = time.perf_counter()
            st = _raw_post(url + "/predict", bodies[k])[0]
            ms.append((time.perf_counter() - t_a) * 1e3)
            check(st == 200, f"{url}/predict answered {st}")
    # one traced request stitched from the router's and a host's spans
    tid = dist.new_trace_id()
    st = _raw_post(router.url + "/predict", bodies[0],
                   {dist.TRACE_HEADER: tid})[0]
    check(st == 200, f"the traced /predict answered {st}")
    tags = {h.tag for h in hosts}
    wf = {}
    deadline = time.time() + 20
    while time.time() < deadline:
        wf = get_json_code(f"{router.url}/api/trace/{tid}")[1]
        if "router" in wf.get("instances", ()) and \
                tags & set(wf.get("instances", ())):
            break
        time.sleep(0.25)
    check("router" in wf.get("instances", ()) and
          tags & set(wf.get("instances", ())),
          f"/api/trace/{tid} did not stitch the router and a host: {wf}")
    return rate, {
        "rows": FD_ROWS, "clients": FD_CLIENTS, "rows_per_s":
        f"{rate:.2f}", "bit_equal": True, "backends": len(backends),
        "router_added_p50_ms": round(_pct(routed, 50) - _pct(direct, 50), 3),
        "router_added_p99_ms": round(_pct(routed, 99) - _pct(direct, 99), 3),
        "direct_p50_p99_ms": [_pct(direct, 50), _pct(direct, 99)],
        "routed_p50_p99_ms": [_pct(routed, 50), _pct(routed, 99)],
        "trace_instances": wf["instances"],
        "trace_segments": len(wf["segments"])}


def fd_admission(router, hosts, rate, rng):
    """Gate 2: open-loop TrafficModel arrivals through the router at twice
    gate 1's rows/s: every 503 carries Retry-After and X-DL4J-Shed-Class,
    every quota shed is t2's, the hosts shed, and at the hosts batch and
    best_effort shed a larger share of their requests than interactive.
    Returns each class's attainment and the hosts' sheds."""
    from deeplearning4j_tpu_torch.scheduling import (SHED_CLASS_HEADER,
                                                     OpenLoopRunner,
                                                     TrafficModel,
                                                     attainment)
    pool = np.eye(DEC_V, dtype=np.float32)[rng.integers(0, DEC_V,
                                                        (16, 1, FD_T))]
    bodies = [json.dumps({"features": r.tolist()}).encode() for r in pool]
    model = TrafficModel(seed=SEED + 1900, duration_s=FD_ADMIT_S,
                         base_rps=2.0 * rate, diurnal_amplitude=0.0,
                         class_mix=FD_MIX, tenants={"t1": 0.5, "t2": 0.5},
                         max_rows=1)
    arrivals = model.arrivals()

    def submit(a):
        st, h, body = _raw_post(router.url + "/predict",
                                bodies[int(a.t * 1e6) % len(bodies)],
                                a.headers())
        out = {"status": st, "shed_class": h.get(SHED_CLASS_HEADER)}
        if st == 503:
            out["retry_after"] = h.get("Retry-After")
            out["quota"] = b"quota" in body
        return out

    def host_sched():
        return [get_json(h.url + "/metrics")[1]["sched"] for h in hosts]

    sched0 = host_sched()
    rows = OpenLoopRunner(submit, arrivals, max_workers=128).run()
    sched1 = host_sched()
    check(len(rows) == len(arrivals), "an arrival left no row")
    check(all(r["status"] in (200, 503) for r in rows),
          f"statuses {sorted({str(r['status']) for r in rows})}, errors "
          f"{[r['error'] for r in rows if r['error']][:3]}")
    shed = [r for r in rows if r["status"] == 503]
    check(all(r["retry_after"] is not None and r["shed_class"] == r["class"]
              for r in shed), "a 503 lacks Retry-After or its shed class")
    quota = [r for r in shed if r["quota"]]
    check(all(r["tenant"] == "t2" for r in quota),
          "a quota shed of a tenant without a quota")
    frac = {}
    for k in FD_MIX:
        passed = [r for r in rows if r["class"] == k and not r.get("quota")]
        frac[k] = (sum(r["status"] == 503 for r in passed) / len(passed)
                   if passed else 0.0)
    # the hosts' own admissions and sheds over this gate, per class
    host = {k: {"admitted": 0, "shed": 0} for k in FD_MIX}
    for a, b in zip(sched0, sched1):
        for k in FD_MIX:
            host[k]["admitted"] += (b["admitted_total"][k]
                                    - a["admitted_total"][k])
            host[k]["shed"] += b["shed_total"][k] - a["shed_total"][k]
    share = {k: v["shed"] / max(1, v["shed"] + v["admitted"])
             for k, v in host.items()}
    check(sum(v["shed"] for v in host.values()) > 0,
          f"the hosts shed nothing at twice their rate: {host}")
    check(share["batch"] > share["interactive"] and
          share["best_effort"] > share["interactive"],
          f"the hosts' shed shares by class {share}: batch and best_effort "
          f"must shed before interactive")
    att = {}
    for k in FD_MIX:
        a = attainment(rows, k)
        served_rows = sum(r["rows"] for r in rows
                          if r["class"] == k and r["status"] == 200)
        att[k] = {"offered": a["offered"], "served": a["served"],
                  "p50_ms": a["p50_ms"], "p99_ms": a["p99_ms"],
                  "rows_per_s": round(served_rows / FD_ADMIT_S, 2),
                  "shed": sum(r["status"] == 503 for r in rows
                              if r["class"] == k),
                  "quota_shed": sum(1 for r in quota if r["class"] == k),
                  "shed_share": round(frac[k], 4)}
    return {"arrivals": len(arrivals), "offered_rows_per_s":
            f"{2.0 * rate:.2f}", "quota_sheds": len(quota),
            "host_sched": host, "host_shed_share": {
                k: round(v, 4) for k, v in share.items()},
            "attainment": att}


def fd_failover(router, hosts, net):
    """Gate 3: FD_SESSIONS /decode sessions of FD_TOKENS tokens through the
    router; before step FD_KILL_AT the host holding the most sessions is
    SIGKILLed. Every session's tokens and logits are bit-equal to
    greedy_reference on the parent's net; failovers >= the sessions that
    host held; /healthz degraded, then after the stale window one live
    host, as /api/fleet says. Returns (the killed host, the report)."""
    prompts = [dec_ids(12 + 5 * i, SEED + 1950 + i)
               for i in range(FD_SESSIONS)]
    refs = [greedy_reference(net, p, FD_TOKENS) for p in prompts]
    before, after = (threading.Barrier(FD_SESSIONS + 1, timeout=600)
                     for _ in range(2))

    def session(sid, prompt):
        st, _, body = _raw_post(router.url + "/decode", json.dumps(
            {"op": "prefill", "sid": sid, "ids": prompt}).encode())
        check(st == 200, f"{sid} prefill answered {st}")
        rows = [np.asarray(json.loads(body)["logits"], np.float32)]
        toks, steps = [], []
        for k in range(FD_TOKENS):
            if k == FD_KILL_AT:
                before.wait()
                after.wait()
            toks.append(int(np.argmax(rows[-1])))
            t_a = time.perf_counter()
            st, _, body = _raw_post(router.url + "/decode", json.dumps(
                {"op": "step", "sid": sid, "token": toks[-1]}).encode())
            check(st == 200, f"{sid} step {k} answered {st}")
            out = json.loads(body)
            steps.append(((time.perf_counter() - t_a) * 1e3,
                          bool(out.get("recovered"))))
            rows.append(np.asarray(out["logits"], np.float32))
        return toks, rows, steps

    results = [None] * FD_SESSIONS
    errors = []

    def run(i):
        try:
            results[i] = session(f"fd{i}", prompts[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"fd{i}: {type(e).__name__}: {e}")
            before.abort()
            after.abort()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(FD_SESSIONS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    try:
        before.wait()
    except threading.BrokenBarrierError:
        check(False, "a session failed before the kill: "
              + "; ".join(errors[:4]))
    t_kill = time.perf_counter()
    pins = {}
    for sid, h in router._affinity.items():
        pins[h.base_url] = pins.get(h.base_url, 0) + 1
    victim_url = max(pins, key=pins.get)
    victim = next(h for h in hosts if h.url == victim_url)
    victim.proc.kill()
    victim.proc.wait(timeout=60)
    try:
        after.wait()
    except threading.BrokenBarrierError:
        check(False, "a session failed at the kill: " + "; ".join(errors[:4]))
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a session hung")
    check(not errors, "; ".join(errors[:4]))
    for i, ((toks, rows, _), (rtoks, rrows)) in enumerate(zip(results,
                                                             refs)):
        check(toks == rtoks and all(np.array_equal(a, b)
                                    for a, b in zip(rows, rrows)),
              f"session fd{i} differs from the sequential greedy decode")
    d = router.describe()
    check(d["failovers_total"] >= pins[victim_url],
          f"{d['failovers_total']} failovers for {pins[victim_url]} "
          f"sessions on the killed host")
    code, hz = get_json_code(router.url + "/healthz")
    check(code == 200 and hz["status"] == "degraded",
          f"/healthz after the kill: {code} {hz.get('status')}")
    survivor = next(h for h in hosts if h is not victim)
    deadline = time.time() + FD_STALE_S * FD_EVICT + 20
    fleet = {}
    while time.time() < deadline:
        fleet = get_json(router.url + "/api/fleet")[1]
        if fleet["live"] == 1 and len(fleet["instances"]) == 1:
            break
        time.sleep(0.5)
    check(fleet.get("live") == 1 and [r["instance"] for r in
                                      fleet["instances"]] == [survivor.tag],
          f"/api/fleet after the stale window: {fleet.get('instances')}")
    code, hz = get_json_code(router.url + "/healthz")
    live = [r["url"] for r in hz["hosts"] if r["routable"]]
    check(code == 200 and live == [survivor.url] and
          [r["url"] for r in fleet["routing"] if r["routable"]] == live,
          f"/healthz and /api/fleet after the stale window: {live}")
    steps = [s for _, _, ss in results for s in ss]
    plain = sorted(ms for ms, rec in steps if not rec)
    recovered = [round(ms, 3) for ms, rec in steps if rec]
    early = FD_SESSIONS * FD_KILL_AT / (t_kill - t0)
    return victim, {
        "sessions": FD_SESSIONS, "tokens": FD_TOKENS, "bit_equal": True,
        "killed": victim.tag, "sessions_on_killed": pins[victim_url],
        "failovers": d["failovers_total"], "evicted": d["evicted_total"],
        "healthz_after_kill": "degraded",
        "tokens_per_s_8_sessions": f"{FD_SESSIONS * FD_TOKENS / wall:.2f}",
        "tokens_per_s_before_kill": f"{early:.2f}",
        "step_p50_ms": _pct(plain, 50), "step_p99_ms": _pct(plain, 99),
        "reprefill_step_ms": recovered}


def get_json_code(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def fd_autoscaler(net):
    """Gate 6: an in-process ModelServer with 3 replica slots, 2 of them
    parked (ReplicaSetActuator re-lights parked slots: it never adds
    one), under an Autoscaler (min 1, max 3): a held queue-depth breach
    scales up, quiet scales down after the cooldown, at most 2
    scale-ups."""
    from deeplearning4j_tpu_torch.scheduling import (Autoscaler,
                                                     ReplicaSetActuator)
    from deeplearning4j_tpu_torch.serving import ModelServer
    srv = ModelServer(net, port=0, max_batch=2, max_queue=1024, replicas=3,
                      input_shapes=[(FD_T, DEC_V)]).start()
    scaler = None
    try:
        srv.fleet.drain(1)
        srv.fleet.drain(2)
        act = ReplicaSetActuator(srv.fleet)
        scaler = Autoscaler(signals_fn=act.signals, up=act.up, down=act.down,
                            min_size=1, max_size=3, up_queue_depth=8,
                            down_queue_depth=0, breach_n=2, clear_n=5,
                            up_cooldown_s=0.1, down_cooldown_s=0.5,
                            interval_s=0.02)
        check(act.live() == 1, f"{act.live()} live replicas at the start")
        scaler.start()
        row = np.eye(DEC_V, dtype=np.float32)[np.arange(FD_T) % DEC_V][None]
        futs = [srv.fleet.submit([row]) for _ in range(256)]
        peak = 1
        for f in futs:
            out = f.result(timeout=300)
            check(out.shape == (1, FD_T, DEC_V) and np.isfinite(out).all(),
                  "an autoscaled reply is not finite rows of its shape")
            peak = max(peak, act.live())
        deadline = time.time() + 10
        while scaler.snapshot()["scale_downs_total"] == 0 and \
                time.time() < deadline:
            time.sleep(0.05)
        snap = scaler.snapshot()
    finally:
        if scaler is not None:
            scaler.stop()
        srv.stop()
    check(1 <= snap["scale_ups_total"] <= 2 and peak > 1,
          f"the held breach scaled up {snap['scale_ups_total']} times "
          f"(peak {peak} live)")
    check(snap["scale_downs_total"] >= 1, f"quiet did not scale down: {snap}")
    return {"scale_ups": snap["scale_ups_total"],
            "scale_downs": snap["scale_downs_total"], "peak_live": peak,
            "reaction_s": snap["last_reaction_s"],
            "breaches": snap["breaches_total"]}


def phase_front_door(card=None):
    """gpt_mini at full width (vocab 80, width 256, 4 blocks of 4 heads,
    T = 256, BF16) behind a FrontDoorRouter over two host processes that
    share the card, each restoring the parent's zip and serving it with 2
    replicas, a DecodeEngine and heartbeats to the router. Gates: routing
    (bit-equal rows, both backends), admission (class-ordered sheds, t2's
    quota), decode failover after a SIGKILL (bit-equal to the sequential
    greedy decode, degraded then one live host), the federation's
    dl4j_sched_* and dl4j_slo_* families and a stitched trace, the
    survivor's exact K3 and S1-S3 launches with no kernel built and its
    RunReport.slo, and the autoscaler's bounds. Every failure raises."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    from deeplearning4j_tpu_torch.scheduling import SchedulingCore
    from deeplearning4j_tpu_torch.serving import FrontDoorRouter
    from deeplearning4j_tpu_torch.utils.serialization import write_model

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 1800)
    root = tempfile.mkdtemp(prefix="front_door_")
    hosts, router = [], None
    try:
        net = dec_net("BF16")
        zip_path = os.path.join(root, "gpt_mini.zip")
        write_model(net, zip_path)
        router = FrontDoorRouter(
            stale_after_s=FD_STALE_S, evict_after_factor=FD_EVICT,
            scheduler=SchedulingCore(quotas={"t2": FD_QUOTA})).start()
        push = router.url + "/api/metrics_push"
        hosts = [_Host(i, zip_path, push, root) for i in range(2)]
        for h in hosts:
            h.ready.wait(timeout=300)
            check(h.url is not None, f"{h.tag} did not start: "
                  f"{h.stderr_tail()}")
            st, _, body = _raw_post(router.url + "/api/hosts", json.dumps(
                {"url": h.url, "action": "add"}).encode())
            check(st == 200 and json.loads(body)["added"],
                  f"/api/hosts add {h.url}: {st} {body[:200]}")
        deadline = time.time() + 60
        while time.time() < deadline and \
                set(router._fed_rows()) != {h.url for h in hosts}:
            time.sleep(0.1)
        check(set(router._fed_rows()) == {h.url for h in hosts},
              f"the hosts' heartbeats did not reach the router: "
              f"{sorted(router._fed_rows())}")
        t_ready = time.perf_counter() - t_phase
        rate, routing = fd_routing(router, hosts, net, rng)
        admission = fd_admission(router, hosts, rate, rng)
        victim, failover = fd_failover(router, hosts, net)
        survivor = next(h for h in hosts if h is not victim)
        # gate 4: the survivor's families in the router's federation
        text = router.federation.render_prometheus()
        lines = [ln for ln in text.splitlines()
                 if f'instance="{survivor.tag}"' in ln]
        fams = sorted({ln.split("{")[0] for ln in lines
                       if ln.startswith(("dl4j_sched_", "dl4j_slo_"))})
        check(any(f.startswith("dl4j_sched_") for f in fams) and
              any(f.startswith("dl4j_slo_") for f in fams),
              f"the federation renders {fams} of the survivor")
        # gate 5: the survivor's launches, forwards and builds
        survivor.proc.terminate()
        survivor.proc.wait(timeout=120)
        check(survivor.proc.returncode == 0 and os.path.exists(survivor.out),
              f"{survivor.tag} exited {survivor.proc.returncode}: "
              f"{survivor.stderr_tail()}")
        with open(survivor.out) as f:
            rep = json.load(f)
        ln = rep["launches"]
        pf, df = rep["predict_forwards"], rep["decode_forwards"]
        expect = {att.KERNEL: DEC_L * pf, se.KERNEL_DENSE: (6 * DEC_L + 1)
                  * df, se.KERNEL_MHA: DEC_L * df,
                  se.KERNEL_NORM: 2 * DEC_L * df}
        got = {k: ln.get(k, 0) for k in expect}
        check(pf > 0 and df > 0 and got == expect,
              f"{survivor.tag}: launches {got}, expected {expect} for "
              f"{pf} /predict and {df} decode forwards")
        check(rep["builds"] == 0 and rep["cache_misses"] == 0,
              f"{survivor.tag} built {rep['builds']} kernels")
        check(rep["slo"] is not None and rep["slo"]["slos"],
              f"{survivor.tag}'s RunReport.slo is {rep['slo']}")
        torch.cuda.synchronize()
        autoscale = fd_autoscaler(net)
        phase("front_door", model="gpt_mini(vocab=80,width=256,blocks=4,"
              "heads=4,T=256,BF16)", card=card, hosts=2,
              host_replicas=2, host_max_batch=2,
              host_max_queue=FD_MAX_QUEUE, ready_s=f"{t_ready:.1f}",
              routing=json.dumps(routing), admission=json.dumps(admission),
              failover=json.dumps(failover), federation_families=len(fams),
              survivor=json.dumps({k: rep[k] for k in (
                  "tag", "predict_forwards", "decode_forwards", "builds")}),
              survivor_launches=json.dumps(got),
              survivor_slo=json.dumps({k: v["attainment"] for k, v in
                                       rep["slo"]["slos"].items()}),
              autoscaler=json.dumps(autoscale),
              phase_s=f"{time.perf_counter() - t_phase:.1f}")
        return got
    finally:
        for h in hosts:
            h.close()
        if router is not None:
            router.stop()
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ slice 19
# [cold_start]: gpt_mini at full width (BF16, T = 256, max_batch 32, a
# DecodeEngine) booted in fresh processes against the kernel build cache:
# cold (an empty dir), warm (the same dir again), aot (a dir precompile
# filled, with its manifest; then a manifest written for max_batch 16),
# shared (two processes cold-booting one empty dir at once) and tuned (a
# boot with the tuning report autotune made from traffic served here).
# Each boot answers one /predict row and one CS_TOKENS-token /decode.
CS_MAX_BATCH, CS_SMALL_BATCH, CS_TOKENS, CS_PROMPT = 32, 16, 8, 12
# the autotune arm's open-loop traffic: seconds, mean rate, rows
CS_TRAFFIC_S, CS_TRAFFIC_RPS, CS_TRAFFIC_ROWS = 5.0, 40.0, 8


def cs_row():
    """The /predict row every arm answers: one T = 256 one-hot row."""
    return dec_onehot(dec_ids(DEC_C, SEED + 1900))


def cs_prompt():
    return dec_ids(CS_PROMPT, SEED + 1901)


def cold_start_arm(zip_path, out_path, mode, aot_manifest=None,
                   tuning_report=None, max_batch=CS_MAX_BATCH):
    """One [cold_start] boot, in a process of its own, against the build
    cache ``$DL4J_TPU_COMPILE_CACHE`` names. ``mode`` "serve": restore
    the parent's gpt_mini zip, build a DecodeEngine and a ModelServer
    (``aot_manifest``, ``tuning_report``), answer one /predict row and
    one /decode over HTTP, stop; "precompile": precompile_serving into
    the cache dir with the decode engine and save the manifest (then one
    for max_batch CS_SMALL_BATCH beside it). Writes what it measured and
    counted to ``out_path`` as JSON."""
    import warnings

    from deeplearning4j_tpu_torch.observability import metrics as obs
    t_start = obs.process_start_unix()
    import torch

    import deeplearning4j_tpu_torch  # noqa: F401
    from deeplearning4j_tpu_torch.compilecache import manifest as man
    from deeplearning4j_tpu_torch.compilecache.precompile import \
        precompile_serving
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.serving import (DecodeEngine, ModelServer,
                                                  ServingStats)
    from deeplearning4j_tpu_torch.utils.serialization import \
        restore_multi_layer_network
    t_import = time.time()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_cuda = time.time()
    base = obs.compile_snapshot()
    net = restore_multi_layer_network(zip_path)
    dstats = ServingStats()
    eng = DecodeEngine(net, n_pages=256, stats=dstats)
    torch.cuda.synchronize()
    t_engine = time.time()
    cache = os.environ["DL4J_TPU_COMPILE_CACHE"]
    rec = {"mode": mode, "pid": os.getpid(),
           "import_s": t_import - t_start, "cuda_init_s": t_cuda - t_import,
           "engine_s": t_engine - t_cuda}
    if mode == "precompile":
        entry = precompile_serving(net, cache_dir=cache, max_batch=max_batch,
                                   input_shapes=[(DEC_C, DEC_V)],
                                   decode_engine=eng)
        rec["manifest"] = man.save(man.build(net, serving=entry), cache)
        small = precompile_serving(
            net, cache_dir=cache, max_batch=CS_SMALL_BATCH,
            input_shapes=[(DEC_C, DEC_V)], decode_engine=eng)
        rec["manifest_small"] = man.save(
            man.build(net, serving=small),
            os.path.join(cache, f"aot_manifest_{CS_SMALL_BATCH}.json"))
        rec["entry"] = entry
        eng.stop()
    else:
        srv = ModelServer(net, port=0, max_batch=max_batch,
                          input_shapes=[(DEC_C, DEC_V)], decode_engine=eng,
                          aot_manifest=aot_manifest,
                          tuning_report=tuning_report)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            srv.start()
        torch.cuda.synchronize()
        t_up = time.time()
        registry.reset_launches()
        p0, d0 = srv.stats.batches, dstats.batches
        try:
            t0 = time.perf_counter()
            _, pred = post_json(srv.url + "/predict",
                                {"features": [cs_row().tolist()]})
            predict_ms = 1000 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            _, gen = post_json(srv.url + "/decode", {
                "op": "generate", "sid": "cs", "ids": cs_prompt(),
                "n_tokens": CS_TOKENS})
            decode_ms = 1000 * (time.perf_counter() - t0)
            post_json(srv.url + "/decode", {"op": "close", "sid": "cs"})
            torch.cuda.synchronize()
            rec.update(
                launches=registry.launches(),
                predict_forwards=srv.stats.batches - p0,
                decode_forwards=dstats.batches - d0,
                predictions=pred["predictions"], tokens=gen["tokens"],
                predict_ms=predict_ms, decode_ms=decode_ms,
                aot_manifest_ok=srv.aot_manifest_ok,
                warnings=[str(w.message)[:300] for w in caught
                          if issubclass(w.category, RuntimeWarning)],
                max_batch=srv.max_batch,
                batch_window_ms=srv._batcher.batch_window_ms,
                tuned=srv.tuned_config, warmup_s=srv.warmup_s,
                build_s=srv.build_s, start_s=t_up - t_engine)
        finally:
            srv.stop()
        report = srv.run_report
        rec["cold_start_s"] = report.cold_start_s
    delta = obs.compile_delta(base)
    rec.update(builds=delta["count"], build_seconds=delta["seconds"],
               cache_hits=delta["cache_hits"],
               cache_misses=delta["cache_misses"],
               libraries=sorted(os.listdir(cache)))
    with open(out_path, "w") as f:
        json.dump(rec, f)


def _cs_spawn(root, name, cache, zip_path, mode="serve", **kw):
    """Start one [cold_start] arm: (process, its JSON path, stderr file)."""
    out = os.path.join(root, f"{name}.json")
    err = open(os.path.join(root, f"{name}.err"), "w")
    args = ", ".join(f"{k}={v!r}" for k, v in kw.items())
    code = (f"import chip_smoke as c; c.cold_start_arm({zip_path!r}, "
            f"{out!r}, {mode!r}{', ' + args if args else ''})")
    env = dict(os.environ, DL4J_TPU_COMPILE_CACHE=cache,
               DL4J_TPU_INSTANCE=f"cold-start-{name}")
    proc = subprocess.Popen([sys.executable, "-c", code], stderr=err,
                            stdout=subprocess.DEVNULL, env=env,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, out, err


def _cs_wait(root, name, spawned, timeout=600):
    proc, out, err = spawned
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)
        rc = "timeout"
    err.close()
    if rc != 0 or not os.path.exists(out):
        with open(err.name) as f:
            tail = f.read()[-3000:]
        check(False, f"[cold_start] arm {name} exited {rc}: {tail}")
    with open(out) as f:
        return json.load(f)


def _cs_arm(root, name, cache, zip_path, mode="serve", **kw):
    return _cs_wait(root, name, _cs_spawn(root, name, cache, zip_path, mode,
                                          **kw))


def cs_traffic(net, root):
    """The autotune arm's trace: CS_TRAFFIC_S s of seeded open-loop
    traffic (scheduling/loadgen.py) through a ModelServer here, then
    autotune over it. Returns (the tuning report's path, its summary)."""
    import torch
    from deeplearning4j_tpu_torch.compilecache import autotune as at
    from deeplearning4j_tpu_torch.scheduling import OpenLoopRunner, \
        TrafficModel
    from deeplearning4j_tpu_torch.serving import ModelServer
    model = TrafficModel(seed=SEED + 1902, duration_s=CS_TRAFFIC_S,
                         base_rps=CS_TRAFFIC_RPS, max_rows=CS_TRAFFIC_ROWS)
    arrivals = model.arrivals()
    feats = np.stack([dec_onehot(dec_ids(DEC_C, SEED + 1903 + i))
                      for i in range(CS_TRAFFIC_ROWS)])
    srv = ModelServer(net, port=0, max_batch=CS_MAX_BATCH,
                      input_shapes=[(DEC_C, DEC_V)]).start()
    try:
        def submit(a):
            srv.predict(feats[:a.rows], klass=a.klass, tenant=a.tenant)
            return {"status": 200}
        rows = OpenLoopRunner(submit, arrivals, max_workers=32).run()
        torch.cuda.synchronize()
        snap = srv.stats.snapshot(srv.shapes_seen)
    finally:
        srv.stop()
    check(all(r["status"] == 200 for r in rows),
          f"[cold_start] autotune traffic: "
          f"{sum(r['status'] != 200 for r in rows)} of {len(rows)} failed")
    rep = at.autotune(at.bench_results(
        arrivals, snap, max_batch=CS_MAX_BATCH,
        batch_window_ms=srv._batcher.batch_window_ms, concurrency=32))
    check(rep["tuned"]["objective"] <= rep["default"]["objective"],
          f"autotune: tuned {rep['tuned']} worse than default "
          f"{rep['default']}")
    path = os.path.join(root, "tuning.json")
    with open(path, "w") as f:
        json.dump(rep, f)
    return path, {"requests": len(arrivals),
                  "rows": int(sum(a.rows for a in arrivals)),
                  "buckets_ms": snap["device_ms_by_bucket"],
                  "default": {k: rep["default"][k] for k in (
                      "max_batch", "batch_window_ms", "p99_ms",
                      "padding_waste_fraction", "objective")},
                  "tuned": {k: rep["tuned"][k] for k in (
                      "max_batch", "batch_window_ms", "p99_ms",
                      "padding_waste_fraction", "objective")},
                  "objective_ratio": rep["objective_ratio"]}


def _cs_expect(arm, name, ref, libs, builds=None):
    """The gates every serving arm holds: replies bit-equal to the cold
    arm's, K3 and S1-S3 launches exact, the library helper naming exactly
    the libraries launched, and (where given) the builds."""
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    if ref is not None:
        check(arm["predictions"] == ref["predictions"],
              f"[cold_start] {name}: the /predict row differs from the "
              f"cold arm's")
        check(arm["tokens"] == ref["tokens"],
              f"[cold_start] {name}: tokens {arm['tokens']} != the cold "
              f"arm's {ref['tokens']}")
    ln, pf, df = arm["launches"], arm["predict_forwards"], \
        arm["decode_forwards"]
    expect = {att.KERNEL: DEC_L * pf, se.KERNEL_DENSE: (6 * DEC_L + 1) * df,
              se.KERNEL_MHA: DEC_L * df, se.KERNEL_NORM: 2 * DEC_L * df}
    got = {k: ln.get(k, 0) for k in expect}
    check(pf > 0 and df > 0 and got == expect,
          f"[cold_start] {name}: launches {got}, expected {expect} for "
          f"{pf} /predict and {df} decode forwards")
    launched = {_build.COUNTER_LIBRARY[k] for k, v in ln.items() if v}
    check(launched == set(libs),
          f"[cold_start] {name}: launches came from {sorted(launched)}, "
          f"libraries_for names {libs}")
    if builds is not None:
        check(arm["builds"] == builds and arm["cache_misses"] == builds,
              f"[cold_start] {name}: {arm['builds']} builds, "
              f"{arm['cache_misses']} misses (expected {builds})")
    return got


def _cs_times(arm):
    keys = ("cold_start_s", "warmup_s", "build_seconds", "import_s",
            "cuda_init_s", "engine_s", "start_s", "predict_ms",
            "decode_ms")
    out = {k: round(arm[k], 4) for k in keys if arm.get(k) is not None}
    if arm.get("cold_start_s"):
        out["import_cuda_share"] = round(
            (arm["import_s"] + arm["cuda_init_s"]) / arm["cold_start_s"], 4)
    return out


def phase_cold_start(card=None):
    """gpt_mini at full width (vocab 80, width 256, 4 blocks of 4 heads,
    T = 256, BF16, max_batch 32 with a DecodeEngine) booted in fresh
    processes against the kernel build cache: cold, warm, aot (and a
    mismatched manifest), shared (two processes at once on one empty
    dir) and tuned (autotune over traffic served here). Gates: every
    arm's /predict row and /decode tokens bit-equal to the cold arm's, K3
    and S1-S3 launches exact, the library helper naming exactly the
    launched libraries, 2 builds cold and 0 warm and aot,
    aot_manifest_ok true then false, the shared dir whole. Every failure
    raises."""
    import glob
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.compilecache import cache as ccache
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.utils.serialization import write_model
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="cold_start_")
    try:
        net = dec_net("BF16")
        libs = _build.libraries_for(net, decode=True)
        check(libs == ("flash_attn_fwd", "stream_exact"),
              f"libraries_for(gpt_mini, decode=True) = {libs}")
        zip_path = os.path.join(root, "gpt_mini.zip")
        write_model(net, zip_path)
        dirs = {k: os.path.join(root, k) for k in ("cold", "aot", "shared")}
        arms = {"cold": _cs_arm(root, "cold", dirs["cold"], zip_path)}
        cold = arms["cold"]
        _cs_expect(cold, "cold", None, libs, builds=len(libs))
        running = {"precompile": _cs_spawn(root, "precompile", dirs["aot"],
                                           zip_path, "precompile"),
                   "shared_a": _cs_spawn(root, "shared_a", dirs["shared"],
                                         zip_path),
                   "shared_b": _cs_spawn(root, "shared_b", dirs["shared"],
                                         zip_path)}
        for name, sp in running.items():
            arms[name] = _cs_wait(root, name, sp)
        arms["warm"] = _cs_arm(root, "warm", dirs["cold"], zip_path)
        _cs_expect(arms["warm"], "warm", cold, libs, builds=0)
        check(arms["warm"]["cache_hits"] == len(libs),
              f"warm: {arms['warm']['cache_hits']} hits")
        pre = arms["precompile"]
        arms["aot"] = _cs_arm(root, "aot", dirs["aot"], zip_path,
                              aot_manifest=True)
        _cs_expect(arms["aot"], "aot", cold, libs, builds=0)
        check(arms["aot"]["aot_manifest_ok"] is True
              and not arms["aot"]["warnings"],
              f"aot: aot_manifest_ok {arms['aot']['aot_manifest_ok']}, "
              f"warnings {arms['aot']['warnings']}")
        arms["aot_mismatch"] = _cs_arm(root, "aot_mismatch", dirs["aot"],
                                       zip_path,
                                       aot_manifest=pre["manifest_small"])
        mis = arms["aot_mismatch"]
        _cs_expect(mis, "aot_mismatch", cold, libs, builds=0)
        check(mis["aot_manifest_ok"] is False and any(
            "max_batch" in w for w in mis["warnings"]),
              f"aot_mismatch: aot_manifest_ok {mis['aot_manifest_ok']}, "
              f"warnings {mis['warnings']}")
        for name in ("shared_a", "shared_b"):
            _cs_expect(arms[name], name, cold, libs)
        left = sorted(os.listdir(dirs["shared"]))
        tmp = glob.glob(os.path.join(dirs["shared"], "*.tmp")) + glob.glob(
            os.path.join(dirs["shared"], ".*.tmp"))
        meta = ccache.shared_meta(dirs["shared"])
        so_files = [n for n in left if n.endswith(".so")]
        check(not tmp and meta is not None and meta["schema"] == 1
              and left.count(ccache.META_NAME) == 1
              and sorted(n[3:].rsplit("_", 1)[0] for n in so_files)
              == list(libs),
              f"shared dir holds {left} (tmp {tmp}, marker {meta})")
        tuning, tuned = cs_traffic(net, root)
        arms["tuned"] = _cs_arm(root, "tuned", dirs["cold"], zip_path,
                                tuning_report=tuning)
        t = arms["tuned"]
        _cs_expect(t, "tuned", cold, libs, builds=0)
        check(t["max_batch"] == tuned["tuned"]["max_batch"]
              and t["batch_window_ms"] == tuned["tuned"]["batch_window_ms"]
              and t["tuned"] == {k: tuned["tuned"][k] for k in (
                  "max_batch", "batch_window_ms")},
              f"tuned boot serves max_batch {t['max_batch']}, window "
              f"{t['batch_window_ms']}, tuning {tuned['tuned']}")
        phase("cold_start", model="gpt_mini(vocab=80,width=256,blocks=4,"
              "heads=4,T=256,BF16)", card=card, max_batch=CS_MAX_BATCH,
              libraries=",".join(libs),
              builds=json.dumps({k: a["builds"] for k, a in arms.items()}),
              hits=json.dumps({k: a["cache_hits"] for k, a in arms.items()}),
              aot_manifest_ok=json.dumps({
                  k: arms[k]["aot_manifest_ok"]
                  for k in ("aot", "aot_mismatch")}),
              launches=json.dumps({k: a["launches"] for k, a in arms.items()
                                   if "launches" in a}),
              shared_dir=json.dumps(left), autotune=json.dumps(tuned),
              times=json.dumps({k: _cs_times(a) for k, a in arms.items()}),
              phase_s=f"{time.perf_counter() - t_phase:.1f}")
        return arms
    finally:
        shutil.rmtree(root, ignore_errors=True)


# [dashboard]: the char-RNN at full width trained under a StatsListener
# whose reports go through a RemoteStatsStorageRouter to a UIServer and
# into a FileStatsStorage, then the trained net's evaluation report, the
# run's trace timeline and the output layer's t-SNE embedding.
DB_STEPS, DB_FREQ, DB_PROBE_ROWS = 30, 10, 4
DB_B, DB_T, DB_V = 32, 64, 80
# t-SNE of the output layer: the perplexity and iterations
# publish_embedding uses, and P's bound against the plain CPU run
DB_TSNE_PERPLEXITY, DB_TSNE_ITERS, DB_P_TOL = 15.0, 300, 1e-5
# the final KL within 5% of the CPU runs' range. The exaggerated phase
# (learning rate 200, exaggeration 12) grows a one-ulp difference in the
# inputs into another embedding within ~10 iterations (the CPU tests'
# measure), so the CPU reference is DB_TSNE_RUNS runs on inputs moved by
# one ulp each (the card's own rounding is of that size), not one run
DB_KL_RTOL, DB_TSNE_RUNS = 0.05, 6


class _Tee:
    """One StatsStorage surface over several (a router and a file)."""

    def __init__(self, *sinks):
        self.sinks = sinks

    def put_update(self, report):
        for s in self.sinks:
            s.put_update(report)

    def put_static_info(self, session_id, worker_id, info):
        for s in self.sinks:
            s.put_static_info(session_id, worker_id, info)


def _snap_listener(at):
    """A listener reading the params at the iterations ``at`` (host
    copies): the listener-free run's update statistics come from these."""
    from deeplearning4j_tpu_torch.optimize.listeners import \
        TrainingListener

    class Snap(TrainingListener):
        needs_per_iteration = True

        def __init__(self):
            self.at, self.params = set(at), {}

        def iteration_done(self, net, iteration, epoch):
            from deeplearning4j_tpu_torch.ui.stats import host_params
            if iteration in self.at:
                self.params[iteration] = host_params(net.params)
    return Snap()


def _db_fit(zip_path, batches, listeners):
    """A fresh restore of the zip trained over ``batches`` by ``fit``,
    one step a chunk; returns (net, ms a step by the host clock, K1/K2
    launches)."""
    import torch
    from deeplearning4j_tpu_torch.datasets import (DataSet,
                                                   ListDataSetIterator)
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.utils.serialization import \
        restore_multi_layer_network
    net = restore_multi_layer_network(zip_path)
    net.set_listeners(*listeners)
    it = ListDataSetIterator([DataSet(x, y) for x, y in batches])
    torch.cuda.synchronize()
    registry.reset_launches()
    t0 = time.perf_counter()
    net.fit(it, epochs=1, multi_step=1, async_prefetch=False,
            device_prefetch=False)
    torch.cuda.synchronize()
    ms = 1000 * (time.perf_counter() - t0) / len(batches)
    return net, ms, registry.launches()


def phase_dashboard(card=None):
    """The char-RNN at full width (vocab 80, hidden 512, 2 GravesLSTM,
    BF16, b = 32, T = 64) trained DB_STEPS steps with a StatsListener
    (frequency 10, histograms, a 4-row activation probe) reporting
    through a RemoteStatsStorageRouter to a UIServer and into a
    FileStatsStorage. Gates: params bit-equal to a run without it, K1/K2
    launches exact per step with the probe's counted apart, the reports
    at /api/updates and in the file, the update statistics those of one
    step's delta, the evaluation report and the trace timeline written,
    the output layer's t-SNE on the card (P 1e-5 against the CPU, the
    final KL within 5% of the CPU runs' range) served at /api/embedding.
    Every failure raises."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.eval.tools import (
        evaluation_html, export_evaluation_to_html_file)
    from deeplearning4j_tpu_torch.observability.trace import (
        export_trace_html, get_tracer)
    from deeplearning4j_tpu_torch.plot.tsne import Tsne
    from deeplearning4j_tpu_torch.ui import (FileStatsStorage,
                                             RemoteStatsStorageRouter,
                                             StatsListener, UIServer,
                                             publish_embedding)
    from deeplearning4j_tpu_torch.ui.stats import _array_stats, host_params
    from deeplearning4j_tpu_torch.utils.serialization import write_model

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dashboard_")
    os.makedirs(OUT_DIR, exist_ok=True)
    ui = None
    try:
        net0 = zoo.char_rnn(seed=SEED)
        zip_path = os.path.join(root, "char_rnn.zip")
        write_model(net0, zip_path)
        del net0
        batches = markov_batches(DB_STEPS + 1, DB_B, DB_T, DB_V, SEED + 1950)
        held = batches.pop()
        probe = batches[0][0][:DB_PROBE_ROWS]
        reports = [i for i in range(1, DB_STEPS + 1) if i % DB_FREQ == 0]
        # the listener-free runs: one reading params around each reported
        # step (update statistics; it also takes the first fit's one-time
        # costs), one alone (timing, final params)
        snap = _snap_listener({i - d for i in reports for d in (0, 1)})
        _db_fit(zip_path, batches, [snap])
        plain, plain_ms, plain_ln = _db_fit(zip_path, batches, [])
        # the listener's run
        ui = UIServer(port=0)
        router = RemoteStatsStorageRouter(ui.url)
        file_path = os.path.join(root, "stats.jsonl")
        fstore = FileStatsStorage(file_path)
        session = "dashboard"
        listener = StatsListener(_Tee(router, fstore), frequency=DB_FREQ,
                                 histograms=True, session_id=session,
                                 activation_probe=probe)
        get_tracer().clear()
        net, listen_ms, ln = _db_fit(zip_path, batches, [listener])
        spans = get_tracer().spans()
        check(router.flush() >= 0 and router.pending == 0,
              f"router: {router.pending} reports pending")
        # params bit-equal to the run without the listener
        want, got = host_params(plain.params), host_params(net.params)
        bad = [k for k in want if want[k].tobytes() != got[k].tobytes()]
        check(not bad, f"[dashboard] params after {DB_STEPS} steps differ "
              f"from the run without the listener: {bad}")
        # K1/K2 exact: 2 forwards, 2 backward calls (6 device launches) a
        # step; each report's probe forward 2 K1 launches more
        per_bwd = lstm_launches_per_bwd()
        expect_plain = {"lstm_fwd": 2 * DB_STEPS,
                        "lstm_bwd": 2 * per_bwd * DB_STEPS}
        expect = {"lstm_fwd": 2 * DB_STEPS + 2 * len(reports),
                  "lstm_bwd": 2 * per_bwd * DB_STEPS}
        got_plain = {k: plain_ln.get(k, 0) for k in expect_plain}
        got_ln = {k: ln.get(k, 0) for k in expect}
        check(got_plain == expect_plain and got_ln == expect,
              f"[dashboard] launches {got_ln} (without the listener "
              f"{got_plain}), expected {expect} ({expect_plain})")
        # the reports at /api/updates and in the file
        _, upd = get_json(f"{ui.url}api/updates?session={session}")
        check(upd["iterations"] == reports,
              f"/api/updates iterations {upd['iterations']} != {reports}")
        fstore.close()
        back = FileStatsStorage(file_path)
        file_reports = back.get_all_updates(session)
        back.close()
        check([r.iteration for r in file_reports] == reports,
              f"the file holds iterations "
              f"{[r.iteration for r in file_reports]}")
        _, model = get_json(f"{ui.url}api/model?session={session}")
        # update statistics: params(i) - params(i - 1) of the run without
        for r in file_reports:
            i = r.iteration
            delta = {k: snap.params[i][k] - snap.params[i - 1][k]
                     for k in snap.params[i]}
            want_u = {k: _array_stats(d, True, 20) for k, d in delta.items()}
            check(r.update_stats == want_u,
                  f"[dashboard] iteration {i}: update statistics differ "
                  f"from params({i}) - params({i - 1})")
            want_p = {k: _array_stats(a, True, 20)
                      for k, a in snap.params[i].items()}
            check(r.param_stats == want_p,
                  f"[dashboard] iteration {i}: param statistics differ")
            check(set(r.activation_stats) == {"layer_0", "layer_1",
                                              "layer_2"},
                  f"activation stats {sorted(r.activation_stats)}")
        check(model["update_stats"] == file_reports[-1].update_stats,
              "/api/model's update statistics differ from the file's")
        # the router's POST, timed on the last report
        payload = {"type": "update", "report": file_reports[-1].to_dict()}
        post_ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            check(router._post(payload), "router POST failed")
            post_ms.append(1000 * (time.perf_counter() - t0))
        # the trained net's next-character evaluation and the trace
        ev = net.evaluate(DataSet(*held))
        html = evaluation_html(ev)
        ev_path = os.path.join(OUT_DIR, "dashboard_evaluation.html")
        export_evaluation_to_html_file(ev, ev_path)
        tr_path = os.path.join(OUT_DIR, "dashboard_trace.html")
        export_trace_html(spans, tr_path)
        check("Confusion matrix" in html and os.path.getsize(ev_path) > 0
              and os.path.getsize(tr_path) > 0 and len(spans) > 0,
              f"evaluation/trace html: {len(html)} chars, {len(spans)} "
              f"spans")
        # the output layer's embedding on the card
        W = net.params["layer_2"]["W"].detach().float().cpu().numpy().T
        labels = [chr(33 + i) for i in range(DB_V)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xy = publish_embedding(router, session, W, labels,
                               perplexity=DB_TSNE_PERPLEXITY,
                               iterations=DB_TSNE_ITERS)
        router.flush()
        publish_s = time.perf_counter() - t0
        card_t = Tsne(perplexity=DB_TSNE_PERPLEXITY, max_iter=DB_TSNE_ITERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_xy = card_t.fit_transform(W)
        tsne_ms = 1000 * (time.perf_counter() - t0)
        check(np.array_equal(card_xy, xy),
              "publish_embedding's coordinates differ from Tsne's on the "
              "card")
        cpu_t = Tsne(perplexity=DB_TSNE_PERPLEXITY, max_iter=DB_TSNE_ITERS,
                     device="cpu")
        t0 = time.perf_counter()
        cpu_t.fit_transform(W)
        cpu_ms = 1000 * (time.perf_counter() - t0)
        p_err = float((card_t.P.cpu() - cpu_t.P).abs().max())
        kls = [cpu_t.kl]
        ulp = np.spacing(np.abs(W)).astype(np.float32)
        for s in range(1, DB_TSNE_RUNS):
            sign = np.random.default_rng(SEED + 1960 + s).choice(
                [-1.0, 0.0, 1.0], size=W.shape).astype(np.float32)
            t = Tsne(perplexity=DB_TSNE_PERPLEXITY, max_iter=DB_TSNE_ITERS,
                     device="cpu")
            t.fit_transform(W + sign * ulp)
            kls.append(t.kl)
        lo, hi = min(kls) * (1 - DB_KL_RTOL), max(kls) * (1 + DB_KL_RTOL)
        check(p_err <= DB_P_TOL and lo <= card_t.kl <= hi,
              f"[dashboard] t-SNE: P {p_err:.3g} off the CPU's (limit "
              f"{DB_P_TOL}), KL {card_t.kl:.5f} outside [{lo:.5f}, "
              f"{hi:.5f}] (CPU runs {kls})")
        _, emb = get_json(f"{ui.url}api/embedding?session={session}")
        check(emb["labels"] == labels and len(emb["xy"]) == DB_V,
              f"/api/embedding: {len(emb.get('xy', []))} points")
        phase("dashboard", model="char_rnn(vocab=80,hidden=512,layers=2,"
              "BF16)", card=card, params=net.num_params(), b=DB_B, T=DB_T,
              steps=DB_STEPS,
              reports=reports, launches=json.dumps(got_ln),
              launches_without=json.dumps(got_plain),
              step_ms_without=f"{plain_ms:.3f}",
              step_ms_with=f"{listen_ms:.3f}",
              listener_ms_per_step=f"{listen_ms - plain_ms:.3f}",
              router_post_ms=f"{statistics.median(post_ms):.3f}",
              report_kb=len(json.dumps(payload)) // 1024,
              accuracy=f"{ev.accuracy():.4f}", spans=len(spans),
              tsne_ms_card=f"{tsne_ms:.1f}", tsne_ms_cpu=f"{cpu_ms:.1f}",
              publish_s=f"{publish_s:.2f}", tsne_p_err=f"{p_err:.3g}",
              tsne_kl_card=f"{card_t.kl:.5f}",
              tsne_kl_cpu=json.dumps([round(k, 5) for k in kls]),
              phase_s=f"{time.perf_counter() - t_phase:.1f}")
    finally:
        if ui is not None:
            ui.stop()
        shutil.rmtree(root, ignore_errors=True)


# [analysis]: the port's static gate, the fx lint of gpt_mini's fit step at
# full width under BF16 on the card (AN_B rows of T = 256; AN_STEPS step
# graph steps after its warm-ups), and the lock-order detector around a
# 32-session decode and a hot swap
AN_B, AN_STEPS = 8, 4


def phase_analysis(card=None):
    """The analysis gate on the card. (1) The concurrency lint over the
    port, this script and the port's tests: 0 findings against the empty
    baseline. (2) The fx lint of gpt_mini.fit_step (vocab 80, width 256,
    4 blocks of 4 heads, T = 256, BF16) recorded on the card under a
    TorchDispatchMode: the aten op histogram and the kernel nodes (K3 4 a
    step, each on the sm90 route), J001/J002/J005 empty, J004 over an
    eager step and a replay, J003 as one capture of the step graph over
    value-varied batches. (3) The port's lock-order detector installed
    before anything is built, around 32 concurrent decode sessions (S1-S3
    launched) and a hot swap: 0 cycles; edges and long holds reported."""
    import torch
    from deeplearning4j_tpu_torch import DataSet
    from deeplearning4j_tpu_torch.analysis import concurrency, fx_lint
    from deeplearning4j_tpu_torch.analysis import lockorder as lo
    from deeplearning4j_tpu_torch.analysis import __main__ as gate_main
    from deeplearning4j_tpu_torch.nn import multistep
    from deeplearning4j_tpu_torch.observability import trace
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    from deeplearning4j_tpu_torch.serving import DecodeEngine, ModelServer

    t_phase = time.perf_counter()
    # (1) the static gate
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    found = concurrency.lint_tree(root) + concurrency.lint_tests(root)
    problems = gate_main.gate(found, gate_main.load_baseline(
        gate_main.DEFAULT_BASELINE))
    gate_s = time.perf_counter() - t0
    check(not found and not problems,
          "the static gate: " + "; ".join(map(str, found + problems))[:2000])

    # (2) the fx lint on the card
    net = dec_net("BF16", seed=SEED + 700)
    pol = net.conf.global_conf.dtype
    check(pol.compute_dtype == "bfloat16", f"gpt_mini policy {pol}")
    (xa, ya), (xb, yb) = markov_batches(2, AN_B, DEC_C, DEC_V, SEED + 701)
    batch_a = net._step_batch(DataSet(torch.from_numpy(xa).cuda(),
                                      torch.from_numpy(ya).cuda()))
    batch_b = net._step_batch(DataSet(torch.from_numpy(xb).cuda(),
                                      torch.from_numpy(yb).cuda()))
    registry.reset_launches()
    t0 = time.perf_counter()
    findings, info = fx_lint.lint_on_device(net, batch_a, batch_b,
                                            "gpt_mini.fit_step",
                                            steps=AN_STEPS)
    torch.cuda.synchronize()
    lint_s = time.perf_counter() - t0
    launches = registry.launches()
    check(not findings, "fx lint on the card: " +
          "; ".join(map(str, findings)))
    kernels = info["kernels"]
    check(kernels == {"flash_attn_fwd": DEC_L,
                      "flash_attn_fwd_sm90": DEC_L},
          f"the recorded step's kernel nodes {kernels}, expected K3 "
          f"{DEC_L} times on the sm90 route")
    # the eager warm-up, the recorded step, the step graph's steps
    steps = 2 + multistep.WARMUP_STEPS + AN_STEPS
    check(launches.get("flash_attn_fwd") == DEC_L * steps and
          launches.get("flash_attn_fwd_sm90") == DEC_L * steps,
          f"K3 launched {launches} in {steps} steps, expected {DEC_L} a "
          f"step")
    check(info["captures"] == 1, f"step graph captures {info['captures']}")
    ops = info["ops"]
    top = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])
    phase("analysis", model=f"gpt_mini(vocab={DEC_V},width={DEC_W},"
          f"blocks={DEC_L},heads={DEC_H},T={DEC_C},BF16)", b=AN_B,
          gate_findings=len(found), gate_baseline_entries=0,
          gate_s=f"{gate_s:.3f}", fx_findings=len(findings),
          aten_nodes=info["nodes"] - info["kernel_nodes"],
          aten_ops=len(ops), kernel_nodes=json.dumps(kernels),
          captures=info["captures"], lint_s=f"{lint_s:.2f}",
          top_ops=json.dumps(top), card=card)
    phase("analysis_ops", histogram=json.dumps(dict(sorted(ops.items()))))
    del net

    # (3) the lock-order detector: installed before anything is built
    prev = trace.get_tracer()
    tracer = trace.Tracer()
    trace.set_tracer(tracer)
    graph = lo.install()
    graph.clear()
    srv = None
    try:
        net = dec_net("BF16", seed=SEED + 702)
        other = dec_net("BF16", seed=SEED + 703)
        prompts = [dec_prompt(i, n) for i, n in enumerate(DEC_PROMPTS)]
        eng = DecodeEngine(net, n_pages=1024)
        try:
            registry.reset_launches()
            t0 = time.perf_counter()
            got = run_threads(lambda s, p: eng.generate(s, p, DEC_TOKENS),
                              [(f"s{i}", p) for i, p in enumerate(prompts)])
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
            dec_launches = registry.launches()
        finally:
            eng.stop()
        check(all(len(g) == DEC_TOKENS for g in got), "a session stopped "
              "short")
        for kern in (se.KERNEL_DENSE, se.KERNEL_MHA, se.KERNEL_NORM):
            check(dec_launches.get(kern, 0) > 0,
                  f"{kern} did not launch in the locked decode")
        x = dec_onehot(dec_ids(DEC_C, SEED + 704))[None]
        srv = ModelServer(net, port=0, max_batch=2, input_shapes=[(DEC_C,
                                                                   DEC_V)])
        srv.start()
        before = srv.predict(x)
        rec = srv.hot_swap(net=other, version=2)
        after = srv.predict(x)
        check(not np.array_equal(before, after) and rec["replicas_swapped"]
              >= 1, f"the hot swap did not land: {rec}")
    finally:
        if srv is not None:
            srv.stop()
        lo.uninstall()
        trace.set_tracer(prev)
    cycles = graph.cycles()
    edges = graph.edges()
    holds = [s for s in tracer.spans() if s.name == "lock_hold"]
    by_lock = {}
    for s in holds:
        by_lock.setdefault(s.attrs["lock"], []).append(s.dur_us / 1e3)
    check(not cycles, f"lock-order cycles: {cycles}")
    check(edges, "the lock-order graph recorded no edge: the detector saw "
          "no nested acquisition")
    phase("lockorder", sessions=DEC_SESSIONS, tokens=DEC_TOKENS,
          decode_s=f"{decode_s:.2f}", edges=len(edges), cycles=len(cycles),
          long_holds=len(holds), hold_ms_env=os.environ.get(
              "DL4J_TPU_LOCK_HOLD_MS", "50"),
          long_holds_by_lock=json.dumps({k: [len(v), round(max(v), 3)]
                                         for k, v in sorted(by_lock.items())}),
          edge_list=json.dumps(sorted(f"{a} -> {b}" for a, b in edges)),
          s_launches=json.dumps({k: dec_launches.get(k, 0) for k in (
              se.KERNEL_DENSE, se.KERNEL_MHA, se.KERNEL_NORM)}),
          swap_s=f"{rec['swap_s']:.6f}",
          phase_s=f"{time.perf_counter() - t_phase:.1f}", card=card)


# [data_parallel]: gpt_mini at full width (T = 256) on a mesh: a 1-rank
# NCCL group against the unmeshed captured step (MESH_STEPS batches of
# MESH_B rows), ParallelWrapper(4 workers, averaging every 2) on PW_B-row
# batches, and two host processes over a gloo group on the one card
# (GLOO_B rows a global batch, GLOO_STEPS steps)
MESH_B, MESH_STEPS = 16, 3 + 4
PW_WORKERS, PW_FREQ, PW_B = 4, 2, 4
GLOO_B, GLOO_STEPS = 16, 4
# the two-process ranks against one process on the whole batch, and the
# wrapper on the card against the CPU path, both F32 with Adam(3e-4):
# the same gradients summed in another order (~1e-6 relative), except
# where a gradient element is near 0 and its sign flips, where Adam's
# update is ~lr whatever |g| is, so an element may differ by 2 lr a step
ADAM_LR = 3e-4


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# The phases of more than one rank run gloo ranks as child processes
# sharing the card (NCCL takes one rank a card); a child writes its
# numbers to <root>/rank<r>.json and its tensors to <root>/rank<r>.pt.
def spawn_ranks(fn, world, root, *args):
    """``world`` children running ``chip_smoke.<fn>(port, rank, root,
    *args)``: [(process, stderr file)]."""
    port = _free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for r in range(world):
        err = open(os.path.join(root, f"rank{r}.err"), "w")
        call = ", ".join(repr(a) for a in (port, r, root) + args)
        procs.append((subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke as c; c.{fn}({call})"],
            stderr=err, stdout=subprocess.DEVNULL, cwd=here), err))
    return procs


def stop_ranks(procs):
    """Kills every child still running and closes its stderr file."""
    for proc, err in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        err.close()


def collect_ranks(procs, root, what, timeout_s=600):
    """Each child's JSON after it exited 0 (its stderr's tail otherwise);
    every child is stopped, whatever happens."""
    res = []
    try:
        deadline = time.monotonic() + timeout_s
        for r, (proc, err) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            err.flush()
            if rc != 0:
                with open(err.name) as f:
                    check(False, f"[{what}] rank {r} exited {rc}: "
                          f"{f.read()[-3000:]}")
            with open(os.path.join(root, f"rank{r}.json")) as f:
                res.append(json.load(f))
    finally:
        stop_ranks(procs)
    return res


def rank_out(root, rank, res, tensors=None):
    if tensors is not None:
        import torch
        torch.save(tensors, os.path.join(root, f"rank{rank}.pt"))
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _leaf_list(tree):
    from deeplearning4j_tpu_torch.nn.updater import _leaves
    return list(_leaves(tree))


def _bits_equal(a, b):
    return all(torch_equal_bits(x, y) for x, y in zip(_leaf_list(a),
                                                      _leaf_list(b)))


def _max_diff(a, b):
    return max(float((x.detach().cpu().double()
                      - y.detach().cpu().double()).abs().max())
               for x, y in zip(_leaf_list(a), _leaf_list(b)))


def captured_steps(net, batches):
    """Each step batch through the net's step graph (3 eager warm-ups,
    then the capture and replays): (scores, ms of each step by CUDA
    events, captures)."""
    import torch
    from deeplearning4j_tpu_torch.nn import multistep
    sg = multistep.step_graph(net, batches[0])
    scores, events = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sg.load(batch)
        scores.append(sg.step())
        net.iteration += 1
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return ([float(s) for s in scores], [s.elapsed_time(e)
                                         for s, e in events], sg.captures)


def dp_rank(port, rank, root, dtype="F32"):
    """One rank of [data_parallel]'s two host processes on the one card:
    a gloo group named explicitly (NCCL refuses two ranks on one card),
    gpt_mini at full width meshed, GLOO_STEPS fit_batch steps on this
    rank's half of each global batch, the timeline of its fit phases,
    and the time of the step's all-reduce alone. Writes its parameters,
    its numbers and its timeline to <root>/rank<r> (.pt, .json and
    .html)."""
    out_path = os.path.join(root, f"rank{rank}")
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch import DataSet
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.parallel import distributed as D
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.parallel.stats import (
        TrainingStatsCollector, export_timeline_html)
    D.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                 timeout_s=300)
    try:
        net = dec_net(dtype, seed=SEED + 720)
        net.use_mesh(make_mesh())
        half = GLOO_B // 2
        data = [(x[rank * half:(rank + 1) * half],
                 y[rank * half:(rank + 1) * half])
                for x, y in markov_batches(GLOO_STEPS, GLOO_B, DEC_C, DEC_V,
                                           SEED + 721)]
        data = on_card(data)
        st = TrainingStatsCollector(worker_id=f"rank_{rank}")
        torch.cuda.synchronize()
        registry.reset_launches()
        step_ms = []
        for ds in data:
            t0 = time.perf_counter()
            with st.time_phase("fit"):
                score = net.fit_batch(ds)
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = registry.launches()
        n = sum(t.numel() for t in _leaf_list(net.params))
        buf = torch.zeros(n + 1, dtype=torch.float32, device=D.device())
        ar_ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with st.time_phase("average"):
                dist.all_reduce(buf)
                torch.cuda.synchronize()
            ar_ms.append((time.perf_counter() - t0) * 1e3)
        ok = D.sync_check(net.params)
        events = st.gather_across_processes()
        if rank == 0:
            export_timeline_html(events, out_path + ".html")
        torch.save([t.detach().cpu() for t in _leaf_list(net.params)],
                   out_path + ".pt")
        with open(out_path + ".json", "w") as f:
            json.dump({"score": float(score), "step_ms": step_ms,
                       "allreduce_ms": ar_ms[1:], "launches": launches,
                       "sync": ok, "params": n,
                       "workers": sorted({e.worker_id for e in events}),
                       "info": D.process_info()}, f)
    finally:
        D.shutdown()


def phase_data_parallel(card=None):
    """gpt_mini (vocab 80, width 256, 4 blocks of 4 heads, T = 256) on the
    data-parallel tier. (1) use_mesh(make_mesh()) on a 1-rank NCCL group,
    BF16: MESH_STEPS steps through the captured step graph (the gradient
    all-reduce inside it) bit-equal to the unmeshed captured step.
    (2) ParallelWrapper(workers=4, averaging_frequency=2), F32: bit-equal
    to the explicit average of 4 copies' train steps on the card, and
    within the Adam bound of the same wrapper on the CPU path. (3) Two
    host processes on the one card over a named gloo group, F32: ranks
    bit-equal to each other, within the Adam bound of one process on the
    whole batch; the TrainingStatsCollector timeline written. K3 launch
    counts exact in every arm."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch import DataSet
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn import multistep
    from deeplearning4j_tpu_torch.nn.updater import _map
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   distributed, make_mesh)

    t_phase = time.perf_counter()
    # (1) a 1-rank NCCL group: the meshed captured step is the unmeshed one
    info = distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        check(info["backend"] == "nccl", f"group {info}")
        batches = on_card(markov_batches(MESH_STEPS, MESH_B, DEC_C, DEC_V,
                                         SEED + 710))
        arms = {}
        for name in ("unmeshed", "meshed", "meshed_again", "unmeshed_again"):
            net = dec_net("BF16", seed=SEED + 711)
            if name.startswith("meshed"):
                net.use_mesh(make_mesh())
            step_batches = [net._step_batch(ds) for ds in batches]
            torch.cuda.synchronize()
            registry.reset_launches()
            scores, ms, captures = captured_steps(net, step_batches)
            launches = registry.launches()
            check(captures == 1, f"{name}: {captures} captures")
            for kern in ("flash_attn_fwd", "flash_attn_fwd_sm90"):
                check(launches.get(kern, 0) == DEC_L * MESH_STEPS,
                      f"{name}: {kern} launched {launches.get(kern, 0)} "
                      f"times in {MESH_STEPS} steps")
            arms[name] = (net, scores, ms)
        ref_net, ref_scores, _ = arms["unmeshed"]
        for name in ("meshed", "meshed_again", "unmeshed_again"):
            net, scores, _ = arms[name]
            check(scores == ref_scores, f"{name} scores {scores} != "
                  f"{ref_scores}")
            for tree in ("params", "opt_state"):
                check(_bits_equal(getattr(net, tree), getattr(ref_net, tree)),
                      f"{name}: {tree} differ from the unmeshed captured "
                      f"step's")
        replay = {n: statistics.median(arms[n][2][multistep.WARMUP_STEPS
                                                  + 1:]) for n in arms}
        meshed_ms = statistics.mean([replay["meshed"],
                                     replay["meshed_again"]])
        plain_ms = statistics.mean([replay["unmeshed"],
                                    replay["unmeshed_again"]])
        del arms, ref_net, net
    finally:
        distributed.shutdown()
    phase("data_parallel", arm="mesh_1rank_nccl",
          model=f"gpt_mini(vocab={DEC_V},width={DEC_W},blocks={DEC_L},"
          f"heads={DEC_H},T={DEC_C},BF16,Adam(3e-4))", b=MESH_B,
          steps=MESH_STEPS, bit_equal=True, captures=1,
          step_ms_meshed=f"{meshed_ms:.4f}",
          step_ms_unmeshed=f"{plain_ms:.4f}",
          step_ms_by_arm=json.dumps({k: round(v, 4)
                                     for k, v in replay.items()}),
          k3_launches_per_step=DEC_L, card=card)

    # (2) ParallelWrapper: 4 workers, an average every 2 steps
    pw_data = markov_batches(PW_WORKERS * PW_FREQ, PW_B, DEC_C, DEC_V,
                             SEED + 712)
    net = dec_net("F32", seed=SEED + 713)
    cpu = cpu_copy(net)
    copies = [dec_net("F32", seed=SEED + 713) for _ in range(PW_WORKERS)]
    registry.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ParallelWrapper(net, workers=PW_WORKERS, averaging_frequency=PW_FREQ) \
        .fit(ListDataSetIterator(on_card(pw_data)))
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = registry.launches()
    check(launches.get("flash_attn_fwd", 0) == DEC_L * len(pw_data) and
          launches.get("flash_attn_fwd_sm90", 0) == 0,
          f"ParallelWrapper launched {launches} in {len(pw_data)} worker "
          f"steps (F32: the FMA route, {DEC_L} a step)")
    for k in range(PW_FREQ):
        for w, c in enumerate(copies):
            x, y = pw_data[k * PW_WORKERS + w]
            multistep.train_step(c, c._step_batch(DataSet(
                torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())),
                advance=False)
    want = _map(lambda *xs: sum(xs) / len(xs), *[c.params for c in copies])
    check(_bits_equal(net.params, want), "ParallelWrapper's parameters "
          "differ from the explicit average of the workers' train steps")
    ParallelWrapper(cpu, workers=PW_WORKERS, averaging_frequency=PW_FREQ) \
        .fit(ListDataSetIterator([DataSet(x, y) for x, y in pw_data]))
    pw_cpu = _max_diff(net.params, cpu.params)
    pw_bound = 2 * ADAM_LR * PW_FREQ
    check(pw_cpu <= pw_bound, f"ParallelWrapper card vs CPU {pw_cpu:.3e} > "
          f"{pw_bound:.1e}")
    phase("data_parallel", arm="parallel_wrapper", workers=PW_WORKERS,
          averaging_frequency=PW_FREQ, b=PW_B, policy="F32",
          round_s=f"{round_s:.3f}", explicit_average_bit_equal=True,
          card_vs_cpu_max_abs=f"{pw_cpu:.3e}", bound=f"{pw_bound:.1e}",
          k3_launches=launches.get("flash_attn_fwd", 0), card=card)
    del net, cpu, copies, want

    # (3) two host processes on the one card over a named gloo group
    root = tempfile.mkdtemp(prefix="data_parallel_")
    procs = spawn_ranks("dp_rank", 2, root)
    try:
        # one process on the whole batch, meanwhile
        one = dec_net("F32", seed=SEED + 720)
        whole = on_card(markov_batches(GLOO_STEPS, GLOO_B, DEC_C, DEC_V,
                                       SEED + 721))
        registry.reset_launches()
        one_ms = []
        for ds in whole:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one.fit_batch(ds)
            torch.cuda.synchronize()
            one_ms.append((time.perf_counter() - t0) * 1e3)
        one_launches = registry.launches()
        res = collect_ranks(procs, root, "data_parallel")
        p0, p1 = (torch.load(os.path.join(root, f"rank{r}.pt"))
                  for r in range(2))
        check(all(torch.equal(a, b) for a, b in zip(p0, p1)) and
              res[0]["sync"] and res[1]["sync"],
              "the two ranks' parameters differ")
        check(res[0]["score"] == res[1]["score"], "the ranks' scores differ")
        ref = [t.detach().cpu() for t in _leaf_list(one.params)]
        dp2 = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(p0, ref))
        dp2_bound = 2 * ADAM_LR * GLOO_STEPS
        check(dp2 <= dp2_bound, f"two ranks vs one process {dp2:.3e} > "
              f"{dp2_bound:.1e}")
        for r in res:
            check(r["launches"].get("flash_attn_fwd", 0)
                  == DEC_L * GLOO_STEPS, f"a rank launched K3 "
                  f"{r['launches']} in {GLOO_STEPS} steps")
            check(r["workers"] == ["rank_0", "rank_1"], f"timeline workers "
                  f"{r['workers']}")
        check(one_launches.get("flash_attn_fwd", 0) == DEC_L * GLOO_STEPS,
              f"one process launched K3 {one_launches}")
        html = os.path.join(root, "rank0.html")
        check(os.path.getsize(html) > 0, "no timeline written")
        os.makedirs(OUT_DIR, exist_ok=True)
        timeline = os.path.join(OUT_DIR, "data_parallel_timeline.html")
        shutil.copy(html, timeline)
    finally:
        stop_ranks(procs)
        shutil.rmtree(root, ignore_errors=True)
    phase("data_parallel", arm="two_processes_gloo", backend="gloo",
          ranks=2, global_b=GLOO_B, steps=GLOO_STEPS, policy="F32",
          ranks_bit_equal=True, vs_one_process_max_abs=f"{dp2:.3e}",
          bound=f"{dp2_bound:.1e}",
          step_ms_rank0=json.dumps([round(v, 3) for v in res[0]["step_ms"]]),
          step_ms_rank1=json.dumps([round(v, 3) for v in res[1]["step_ms"]]),
          step_ms_one_process=json.dumps([round(v, 3) for v in one_ms]),
          allreduce_ms_median=f"{statistics.median(res[0]['allreduce_ms']):.3f}",
          allreduce_floats=res[0]["params"] + 1,
          timeline=os.path.relpath(timeline),
          phase_s=f"{time.perf_counter() - t_phase:.1f}", card=card)


# ---------------------------------------------------------- meshed BN
MBN_IMG, MBN_CLASSES = 32, 10
MBN_B, MBN_STEPS = 32, 6            # (a): the 1-rank NCCL arm, BF16
MBN_GLOBAL_B, MBN_GLOO_STEPS = 16, 3  # (b): two gloo ranks, F32
MBN_LR = 0.01
# (b): two ranks against one process on the 16-row batch, F32. After the
# first step the BN running statistics are the forward's global-batch
# statistics of the same weights: each tensor's largest difference over
# its largest magnitude plus 1e-6 within MBN_STEP1_TOL (the same f32 sums
# over two partial sums; 1.5e-5 measured on the card, and a one-process
# run on the same rows permuted reads the same). The weights' first
# gradient is chaotic at 32 x 32 (the last stage's BN normalises 16
# values a channel): after MBN_GLOO_STEPS steps a one-process run on the
# rows permuted, whose only change is the order of its sums, lies up to
# ~1.3 (statistics) and ~0.5 (head) from the unpermuted run (NVIDIA H100
# 80GB HBM3, 700 W). So after MBN_GLOO_STEPS steps the ranks are held to
# MBN_CHAOS_FACTOR times the larger distance of two such permuted runs
# plus MBN_CHAOS_FLOOR, the statistics and the head's parameters each.
MBN_STEP1_TOL = 1e-4
MBN_CHAOS_FACTOR = 2.0
MBN_CHAOS_FLOOR = 1e-3
MBN_HEAD = ("fc",)


def mbn_net(dtype, seed):
    """zoo.resnet50 at full width on 32 x 32 images, 10 classes, with its
    13 tails fused, Nesterovs(MBN_LR, 0.9)."""
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn.updater import Nesterovs
    with fuse_blocks(True):
        net = zoo.resnet50(seed=seed, image_size=MBN_IMG,
                           n_classes=MBN_CLASSES, dtype=getattr(zoo, dtype),
                           updater=Nesterovs(MBN_LR, 0.9))
    check(len(net._fusion_plans) == 13,
          f"resnet50 matched {len(net._fusion_plans)} tails, expected 13")
    return net


def mbn_batches(n, b, seed):
    from deeplearning4j_tpu_torch.datasets import DataSet
    return [DataSet(x, y) for x, y in resnet_batches(n, b, seed,
                                                      size=MBN_IMG,
                                                      classes=MBN_CLASSES)]


def mbn_rank(port, rank, root):
    """One rank of [meshed_bn]'s arm (b): a named gloo group of two on the
    one card, ResNet-50 (F32, fused tails) meshed, MBN_GLOO_STEPS
    fit_batch steps on this rank's half of each global batch. The sizes
    of the BN collectives the steps made are recorded, and one step's
    worth of them timed alone afterwards. Writes its trees and numbers to
    <root>/rank<r> (.pt and .json)."""
    out_path = os.path.join(root, f"rank{rank}")
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import normalization as norm
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.parallel import distributed as D
    from deeplearning4j_tpu_torch.parallel import make_mesh
    D.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                 timeout_s=300)
    try:
        sizes = []
        plain = norm.all_reduce_sums

        def recorded(sync, *sums, rows):
            sizes.append(sum(t.numel() for t in sums) + 1)
            return plain(sync, *sums, rows=rows)

        norm.all_reduce_sums = fb.all_reduce_sums = recorded
        net = mbn_net("F32", SEED + 801)
        net.use_mesh(make_mesh())
        half = MBN_GLOBAL_B // 2
        data = [DataSet(ds.features[rank * half:(rank + 1) * half],
                        ds.labels[rank * half:(rank + 1) * half])
                for ds in mbn_batches(MBN_GLOO_STEPS, MBN_GLOBAL_B,
                                      SEED + 802)]
        torch.cuda.synchronize()
        registry.reset_launches()
        step_ms = []
        state1 = None
        for ds in data:
            t0 = time.perf_counter()
            score = net.fit_batch(ds)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if state1 is None:
                state1 = [x.detach().cpu().clone()
                          for x in _leaf_list(net.state)]
        launches = registry.launches()
        per_step = sizes[:len(sizes) // MBN_GLOO_STEPS]
        bufs = [torch.zeros(n, dtype=torch.float32, device=D.device())
                for n in per_step]
        coll_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for buf in bufs:
                dist.all_reduce(buf)
            torch.cuda.synchronize()
            coll_ms.append((time.perf_counter() - t0) * 1e3)
        sync = D.sync_check(net.params) and D.sync_check(net.state)
        trees = {t: [x.detach().cpu() for x in _leaf_list(getattr(net, t))]
                 for t in ("params", "state")}
        trees["state1"] = state1
        torch.save(trees, out_path + ".pt")
        with open(out_path + ".json", "w") as f:
            json.dump({"score": float(score), "step_ms": step_ms,
                       "launches": launches, "sync": sync,
                       "bn_collectives_per_step": len(per_step),
                       "bn_floats_per_step": sum(per_step),
                       "bn_collectives_ms": coll_ms[1:]}, f)
    finally:
        D.shutdown()


def _tree_rel_err(a, b, names=None):
    """{leaf: max |a - b| / (max |b| + 1e-6)} over the leaves of two
    nets' tree dicts (``names``: only layers whose name starts so)."""
    out = {}
    for ln in b:
        if names and not ln.startswith(names):
            continue
        for k in b[ln]:
            x = a[ln][k].detach().cpu().double()
            y = b[ln][k].detach().cpu().double()
            out[f"{ln}.{k}"] = float((x - y).abs().max()
                                     / (y.abs().max() + 1e-6))
    return out


def phase_meshed_bn(card=None):
    """C.5 on the card: batch norm over the global batch when meshed.
    (a) ResNet-50 at full width (32 x 32, 10 classes, BF16, 13 fused
    tails) on a 1-rank NCCL group: the meshed captured step bit-equal to
    the unmeshed one (params, BN state, updater state, scores), K4-K7 13
    calls a step each, on their sm90 paths, in both. (b) Two gloo ranks
    sharing the card, F32, global b = 16 (8 a rank): the ranks' params
    and BN state bit-equal to each other, K4-K7 launched on both, the BN
    running statistics after the first step within MBN_STEP1_TOL of one
    process on the 16-row batch, and after MBN_GLOO_STEPS steps the
    statistics and the head within the chaos yardstick (see
    MBN_STEP1_TOL). Prints each arm's step time and the BN collectives'
    time."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn import multistep
    from deeplearning4j_tpu_torch.nn.updater import _map
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.parallel import distributed, make_mesh

    t_phase = time.perf_counter()
    info = distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        check(info["backend"] == "nccl", f"group {info}")
        batches = mbn_batches(MBN_STEPS, MBN_B, SEED + 800)
        arms = {}
        for name in ("unmeshed", "meshed", "meshed_again",
                     "unmeshed_again"):
            net = mbn_net("BF16", SEED + 801)
            if name.startswith("meshed"):
                net.use_mesh(make_mesh())
            step_batches = [net._step_batch(ds) for ds in batches]
            torch.cuda.synchronize()
            registry.reset_launches()
            scores, ms, captures = captured_steps(net, step_batches)
            launches = registry.launches()
            check(captures == 1, f"{name}: {captures} captures")
            for kern in fb.SM90_COUNTER.values():
                check(launches.get(kern, 0) == 13 * MBN_STEPS,
                      f"{name}: {kern} {launches.get(kern, 0)} in "
                      f"{MBN_STEPS} steps, expected {13 * MBN_STEPS}")
            arms[name] = (net, scores, ms, launches)
        ref, ref_scores, _, ref_launches = arms["unmeshed"]
        for name in ("meshed", "meshed_again", "unmeshed_again"):
            net, scores, _, launches = arms[name]
            check(scores == ref_scores, f"{name} scores {scores} != "
                  f"{ref_scores}")
            check(launches == ref_launches, f"{name} launched {launches}, "
                  f"the unmeshed step {ref_launches}")
            for tree in ("params", "state", "opt_state"):
                check(_bits_equal(getattr(net, tree), getattr(ref, tree)),
                      f"{name}: {tree} differ from the unmeshed captured "
                      f"step's")
        replay = {n: statistics.median(arms[n][2][multistep.WARMUP_STEPS
                                                  + 1:]) for n in arms}
        del arms, ref, net
    finally:
        distributed.shutdown()
    phase("meshed_bn", arm="mesh_1rank_nccl",
          model=f"resnet50(classes={MBN_CLASSES},{MBN_IMG}x{MBN_IMG},BF16,"
          f"Nesterovs({MBN_LR},0.9),DL4J_TPU_FUSE_BLOCKS=1)", b=MBN_B,
          steps=MBN_STEPS, bit_equal=True, captures=1,
          k4_k7_sm90_calls_per_step=13,
          launches_per_step=json.dumps({k: v // MBN_STEPS for k, v in
                                        sorted(ref_launches.items())}),
          step_ms_meshed=f"{statistics.mean([replay['meshed'], replay['meshed_again']]):.4f}",
          step_ms_unmeshed=f"{statistics.mean([replay['unmeshed'], replay['unmeshed_again']]):.4f}",
          card=card)

    root = tempfile.mkdtemp(prefix="meshed_bn_")
    procs = spawn_ranks("mbn_rank", 2, root)
    try:
        one = mbn_net("F32", SEED + 801)
        whole = mbn_batches(MBN_GLOO_STEPS, MBN_GLOBAL_B, SEED + 802)
        registry.reset_launches()
        one_ms, one_state1 = [], None
        for ds in whole:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one.fit_batch(ds)
            torch.cuda.synchronize()
            one_ms.append((time.perf_counter() - t0) * 1e3)
            if one_state1 is None:
                one_state1 = _map(lambda t: t.detach().clone(), one.state)
        one_launches = registry.launches()
        # the chaos yardstick: the same process on the rows permuted
        permuted = []
        for k in range(2):
            perm = mbn_net("F32", SEED + 801)
            idx = torch.randperm(MBN_GLOBAL_B, generator=torch.Generator()
                                 .manual_seed(SEED + 803 + k)).cuda()
            for ds in whole:
                perm.fit_batch(DataSet(ds.features[idx], ds.labels[idx]))
            permuted.append(perm)
        res = collect_ranks(procs, root, "meshed_bn")
        t0_, t1_ = (torch.load(os.path.join(root, f"rank{r}.pt")) for r in range(2))
        for tree in ("params", "state"):
            check(all(torch.equal(a, b) for a, b in zip(t0_[tree],
                                                        t1_[tree])),
                  f"the two ranks' {tree} differ")
        check(res[0]["sync"] and res[1]["sync"], "sync_check failed")
        for r in res:
            for kern in (fb.STATS, fb.APPLY, fb.BWD_STATS, fb.BWD_APPLY):
                check(r["launches"].get(kern, 0) >= 13 * MBN_GLOO_STEPS,
                      f"a rank launched {kern} {r['launches'].get(kern, 0)}"
                      f" times in {MBN_GLOO_STEPS} steps")
        for kern in (fb.STATS, fb.APPLY, fb.BWD_STATS, fb.BWD_APPLY):
            check(res[0]["launches"].get(kern) == res[1]["launches"].get(
                kern), f"the ranks launched {kern} differently")
        # the ranks' trees back into a net's structure (``_fill`` is
        # ``_leaves``' inverse), against one process
        from deeplearning4j_tpu_torch.nn.updater import _fill
        got = {t: _fill(getattr(one, "state" if t == "state1" else t),
                        iter(t0_[t])) for t in ("params", "state", "state1")}
        step1 = max(_tree_rel_err(got["state1"], one_state1).values())
        check(step1 <= MBN_STEP1_TOL, f"two ranks vs one process after the "
              f"first step: BN statistics {step1:.3e} > {MBN_STEP1_TOL}")
        worst_state = max(_tree_rel_err(got["state"], one.state).values())
        worst_head = max(_tree_rel_err(got["params"], one.params,
                                       MBN_HEAD).values())
        chaos_state = max(max(_tree_rel_err(p.state, one.state).values())
                          for p in permuted)
        chaos_head = max(max(_tree_rel_err(p.params, one.params,
                                           MBN_HEAD).values())
                         for p in permuted)
        for what, err, chaos in (("BN statistics", worst_state,
                                  chaos_state),
                                 ("head", worst_head, chaos_head)):
            bound = MBN_CHAOS_FACTOR * chaos + MBN_CHAOS_FLOOR
            check(err <= bound, f"two ranks vs one process after "
                  f"{MBN_GLOO_STEPS} steps: {what} {err:.3e} > {bound:.3e} "
                  f"({MBN_CHAOS_FACTOR} x the permuted runs' {chaos:.3e} "
                  f"+ {MBN_CHAOS_FLOOR})")
        del permuted
    finally:
        stop_ranks(procs)
        shutil.rmtree(root, ignore_errors=True)
    phase("meshed_bn", arm="two_processes_gloo", backend="gloo", ranks=2,
          global_b=MBN_GLOBAL_B, steps=MBN_GLOO_STEPS, policy="F32",
          ranks_bit_equal=True,
          bn_state_step1_vs_one_process=f"{step1:.3e}",
          step1_bound=MBN_STEP1_TOL,
          bn_state_vs_one_process=f"{worst_state:.3e}",
          head_vs_one_process=f"{worst_head:.3e}",
          permuted_one_process_state=f"{chaos_state:.3e}",
          permuted_one_process_head=f"{chaos_head:.3e}",
          step_ms_rank0=json.dumps([round(v, 3) for v in res[0]["step_ms"]]),
          step_ms_rank1=json.dumps([round(v, 3) for v in res[1]["step_ms"]]),
          step_ms_one_process=json.dumps([round(v, 3) for v in one_ms]),
          bn_collectives_per_step=res[0]["bn_collectives_per_step"],
          bn_floats_per_step=res[0]["bn_floats_per_step"],
          bn_collectives_ms_per_step=json.dumps(
              [round(v, 3) for v in res[0]["bn_collectives_ms"]]),
          k4_k7_launches_rank0=json.dumps(
              {k: res[0]["launches"].get(k, 0) for k in
               (fb.STATS, fb.APPLY, fb.BWD_STATS, fb.BWD_APPLY)}),
          k4_k7_launches_one_process=json.dumps(
              {k: one_launches.get(k, 0) for k in
               (fb.STATS, fb.APPLY, fb.BWD_STATS, fb.BWD_APPLY)}),
          phase_s=f"{time.perf_counter() - t_phase:.1f}", card=card)


# ------------------------------------------------- the composed routes
# a composed route's output on the card against the port's CPU run of
# the same weights: F16 rounds every product and activation to 11 bits
# in another order on the card (cuBLAS, cuDNN) than on the CPU, through
# 2-4 layers: probabilities 2e-2 absolute (BF16, hardsigmoid: the same
# bound, 8 bits, where the plain loop's products are f32)
ROUTE_PROB_TOL = 2e-2
ROUTE_STEPS = 2
ROUTE_RNN_B, ROUTE_RNN_T = 32, 64
ROUTE_GPT_B = 8
ROUTE_RES_B = 16


def _rnn_conf_net(gate, dtype, device="cuda", hidden=512, seed=SEED + 820):
    """The zoo's char-RNN (V = 80, 2 x 512) with ``gate`` as its LSTMs'
    gate activation."""
    import dataclasses
    from deeplearning4j_tpu_torch import MultiLayerNetwork, zoo
    net = zoo.char_rnn(hidden=hidden, seed=seed, dtype=getattr(zoo, dtype),
                       device="cpu")
    layers = [dataclasses.replace(l, gate_activation=gate)
              if hasattr(l, "gate_activation") else l
              for l in net.conf.layers]
    conf = dataclasses.replace(net.conf, layers=layers)
    return MultiLayerNetwork(conf, device=device).init()


@contextlib.contextmanager
def counting_calls(op):
    """Counts the calls of ``op``'s CUDA implementation while open."""
    from deeplearning4j_tpu_torch.ops import registry
    impl = registry._IMPLS[op]["cuda"]
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return impl(*a, **kw)

    registry._IMPLS[op]["cuda"] = counted
    try:
        yield calls
    finally:
        registry._IMPLS[op]["cuda"] = impl


def _route_case(name, net, batches, x_out, ops, counters, kernels, cpu_net,
                card):
    """ROUTE_STEPS fit_batch steps and an output on the card: each route
    counter in ``counters`` equals the calls of its op, the kernel
    counters ``kernels`` stay at 0, the scores are finite, and the output
    is within ROUTE_PROB_TOL of ``cpu_net`` (the same weights) on the
    CPU."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    torch.cuda.synchronize()
    registry.reset_launches()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        calls = {op: stack.enter_context(counting_calls(op)) for op in ops}
        scores = [float(net.fit_batch(ds)) for ds in batches]
        probs = net.output(x_out)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = registry.launches()
    routes = registry.routes()
    for op, counter in counters.items():
        check(routes.get(counter, 0) == calls[op][0] > 0,
              f"[routes] {name}: {counter} counted {routes.get(counter, 0)}"
              f", {op} was called {calls[op][0]} times")
    for kern in kernels:
        check(launches.get(kern, 0) == 0, f"[routes] {name}: {kern} "
              f"launched {launches.get(kern, 0)} times on a composed route")
    check(all(math.isfinite(s) for s in scores), f"[routes] {name}: scores "
          f"{scores}")
    cpu_net.params = {ln: {k: t.detach().cpu().clone() for k, t in lp.items()}
                      for ln, lp in net.params.items()}
    cpu_net.state = {ln: {k: t.detach().cpu().clone() for k, t in lp.items()}
                     for ln, lp in (net.state or {}).items()}
    want = cpu_net.output(x_out.cpu())
    err = float((probs.detach().float().cpu() - want.float()).abs().max())
    check(err <= ROUTE_PROB_TOL, f"[routes] {name}: card vs CPU "
          f"{err:.3e} > {ROUTE_PROB_TOL}")
    phase("routes", case=name, routes=json.dumps(routes),
          kernel_launches=json.dumps({k: launches.get(k, 0)
                                      for k in kernels}),
          scores=json.dumps([round(s, 5) for s in scores]),
          out_vs_cpu=f"{err:.3e}", bound=ROUTE_PROB_TOL,
          wall_ms=f"{wall_ms:.1f}", card=card)


def phase_routes(card=None):
    """C.6 on the card: each configuration the JAX package sends to XLA
    and the kernels do not cover trains through its named, counted
    composed route: the char-RNN (V = 80, 2 x 512) with hardsigmoid gates
    (BF16); the char-RNN, gpt_mini (full width) and ResNet-50 (13 fused
    tails, 32 x 32, 10 classes) under zoo.F16; gpt_mini at dh = 32 (8
    heads of width 256, BF16). Then kernel-covered calls of each op, the
    forward ones and with grad the backward ones, move the counters of
    K1-K7."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    from deeplearning4j_tpu_torch.ops import registry

    t_phase = time.perf_counter()
    lstm_k = ("lstm_fwd", "lstm_bwd", "lstm_fwd_sm90", "lstm_bwd_sm90")
    flash_k = ("flash_attn_fwd", "flash_attn_fwd_sm90")
    fused_k = (fb.STATS, fb.APPLY, fb.BWD_STATS, fb.BWD_APPLY)
    rnn = on_card(markov_batches(ROUTE_STEPS, ROUTE_RNN_B, ROUTE_RNN_T, 80,
                                 SEED + 821))
    x_rnn = rnn[0].features[:4]
    for name, gate, dtype, counters in (
            ("char_rnn_hardsigmoid", "hardsigmoid", "BF16",
             {"lstm_sequence":
              "lstm_sequence:composed[gate_act=hardsigmoid]"}),
            ("char_rnn_f16", "sigmoid", "F16",
             {"lstm_sequence": "lstm_sequence:composed[dtype=float16]",
              "lstm_sequence_bwd":
              "lstm_sequence_bwd:composed[dtype=float16]"})):
        net = _rnn_conf_net(gate, dtype)
        _route_case(name, net, rnn, x_rnn, tuple(counters), counters,
                    lstm_k, _rnn_conf_net(gate, dtype, device="cpu"), card)
        del net
    gpt = on_card(markov_batches(ROUTE_STEPS, ROUTE_GPT_B, DEC_C, DEC_V,
                                 SEED + 822))
    x_gpt = gpt[0].features[:2]
    for name, heads, dtype, reason in (
            ("gpt_mini_f16", DEC_H, "F16", "dtype=float16"),
            ("gpt_mini_dh32", DEC_W // 32, "BF16", "dh=32")):
        kw = dict(vocab_size=DEC_V, max_len=DEC_C, seed=SEED + 823,
                  width=DEC_W, n_layers=DEC_L, n_heads=heads,
                  dtype=getattr(zoo, dtype))
        net = zoo.gpt_mini(**kw)
        _route_case(name, net, gpt, x_gpt, ("causal_mha",),
                    {"causal_mha": f"flash_attn:composed[{reason}]"},
                    flash_k, zoo.gpt_mini(device="cpu", **kw), card)
        del net
    res = mbn_batches(ROUTE_STEPS, ROUTE_RES_B, SEED + 824)
    net = mbn_net("F16", SEED + 825)
    cpu = graph_copy(net, "cpu", False)
    _route_case("resnet50_f16", net, res, res[0].features[:4],
                ("conv1x1_bn_add_relu",),
                {"conv1x1_bn_add_relu": "fused_tail:composed[dtype=float16]"},
                fused_k, cpu, card)
    del net, cpu

    # one kernel-covered call of each op moves its kernel counter
    g = torch.Generator(device="cuda").manual_seed(SEED + 826)
    with torch.no_grad():
        registry.reset_launches()
        n, b, T = 512, 32, 8
        xz = torch.randn((T, b, 4 * n), generator=g, device="cuda").bfloat16()
        h0 = torch.zeros((b, n), device="cuda", dtype=torch.bfloat16)
        Wh = (0.05 * torch.randn((n, 4 * n), generator=g,
                                 device="cuda")).bfloat16()
        p = torch.zeros((3, n), device="cuda", dtype=torch.bfloat16)
        lstm_ops.lstm_sequence(xz, h0, h0, Wh, p)
        q = torch.randn((2, 256, 4, 64), generator=g,
                        device="cuda").bfloat16()
        att.causal_mha(q, q, q)
        x = torch.randn((512, 256), generator=g, device="cuda").bfloat16()
        W = (0.05 * torch.randn((256, 256), generator=g,
                                device="cuda")).bfloat16()
        fb.conv1x1_bn_add_relu(x, W, torch.ones(256, device="cuda"),
                               torch.zeros(256, device="cuda"), x,
                               shift=torch.zeros(256, device="cuda"),
                               eps=1e-5)
    # and with grad, the backward kernels: K2 through LstmSequenceFn, K6
    # and K7 through FusedTailFn
    xz.requires_grad_()
    lstm_ops.lstm_sequence(xz, h0, h0, Wh, p).y.float().sum().backward()
    x.requires_grad_()
    fb.conv1x1_bn_add_relu(x, W, torch.ones(256, device="cuda"),
                           torch.zeros(256, device="cuda"), x,
                           shift=torch.zeros(256, device="cuda"),
                           eps=1e-5)[0].float().sum().backward()
    torch.cuda.synchronize()
    moved = registry.launches()
    for kern in ("lstm_fwd", "lstm_bwd", "flash_attn_fwd", fb.STATS,
                 fb.APPLY, fb.BWD_STATS, fb.BWD_APPLY):
        check(moved.get(kern, 0) > 0, f"[routes] a kernel-covered call did "
              f"not launch {kern}: {moved}")
    check(not registry.routes(), f"[routes] a kernel-covered call took a "
          f"composed route: {registry.routes()}")
    phase("routes", case="kernel_covered", launches=json.dumps(moved),
          phase_s=f"{time.perf_counter() - t_phase:.1f}", card=card)


# ------------------------------------------------------- coordination
CO_RECORDS = 64
CO_GLOBAL_B = 8
CO_CKPT_EVERY = 3
CO_POISON_STEP = 4
CO_KILL_STEP = 5
CO_SIGTERM_STEP = 4
CO_TIMEOUT_S = 10.0
CO_SEED = SEED + 840
CO_STEPS = CO_RECORDS // CO_GLOBAL_B


def co_corpus():
    """CO_RECORDS token sequences of DEC_C + 1 tokens from the order-2
    Markov chain (markov_batches), as ids."""
    rng = np.random.default_rng(CO_SEED)
    table = rng.integers(0, DEC_V, (DEC_V, 2, 3))
    succ = table[:, np.arange(DEC_V) % 2].transpose(1, 0, 2)
    seq = np.empty((CO_RECORDS, DEC_C + 1), np.int64)
    seq[:, :2] = rng.integers(0, DEC_V, (CO_RECORDS, 2))
    for t in range(2, DEC_C + 1):
        pick = rng.choice(3, size=CO_RECORDS, p=[0.6, 0.3, 0.1])
        seq[:, t] = succ[seq[:, t - 2], seq[:, t - 1], pick]
    return seq


def co_pipeline(seq, size, rank, seen):
    """Record ids sharded by rank, each mapped to its one-hot (features,
    labels) pair, which also notes the id in ``seen``, then batched."""
    from deeplearning4j_tpu_torch import datapipe
    eye = np.eye(DEC_V, dtype=np.float32)
    ids = np.arange(CO_RECORDS, dtype=np.float32)[:, None]

    def expand(rec):
        i = int(rec[0][0])
        seen.append(i)
        return eye[seq[i, :-1]], eye[seq[i, 1:]]

    return (datapipe.from_arrays(ids, ids).shard(size, rank).map(expand)
            .batch(CO_GLOBAL_B // size))


def co_worker(args):
    """One fleet member of [coordinated] (``chip_smoke.py --coord-worker
    <json>``): a gloo group over the worker's size on the one card,
    gpt_mini at full width (BF16, K3) meshed, the coordinated supervisor
    over ``co_pipeline`` with the arm's fault plan and a statistics
    collector. Writes its params, result and K3 launches to the output
    directory; a lost peer exits PEER_LOST_EXIT."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.parallel import distributed as D
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.parallel.stats import (
        TrainingStatsCollector)
    from deeplearning4j_tpu_torch.resilience import (
        PEER_LOST_EXIT, FaultInjector, SupervisorConfig, TrainingSupervisor)
    a = json.loads(args)
    size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    t0 = time.perf_counter()
    D.initialize(backend="gloo")
    net = dec_net("BF16", seed=CO_SEED + 1)
    net.use_mesh(make_mesh())
    seen = []
    pipe = co_pipeline(co_corpus(), size, rank, seen)
    inj = FaultInjector()
    for kind, (step, r) in a["faults"].items():
        {"poison": inj.poison_step, "kill": inj.kill_at_step,
         "sigterm": inj.sigterm_at_step}[kind](step, rank=r)
    cfg = SupervisorConfig(
        checkpoint_dir=a["ckpt"], checkpoint_every_steps=CO_CKPT_EVERY,
        keep_checkpoints=10, backoff_initial_s=0.01, nan_lr_backoff=1.0,
        coordinate=True, collective_timeout_s=CO_TIMEOUT_S)
    st = TrainingStatsCollector(worker_id=f"worker_{rank}")
    sup = TrainingSupervisor(net, cfg, injector=inj, stats_collector=st)
    registry.reset_launches()
    with inj.installed():
        res = sup.fit_pipeline(pipe, epochs=1)
    torch.cuda.synchronize()
    inc = os.environ.get("DL4J_TPU_INCARNATION", "0")
    out = a["out"]
    torch.save([t.detach().cpu() for t in _leaf_list(net.params)],
               os.path.join(out, f"params_l{inc}_r{rank}.pt"))
    phases = {}
    for e in st.events:
        phases.setdefault(e.phase, [0, 0.0])
        phases[e.phase][0] += 1
        phases[e.phase][1] += e.duration_ms
    doc = {"status": res.status, "final_step": res.final_step, "size": size,
           "resumed_from": res.resumed_from and os.path.basename(
               res.resumed_from),
           "events": [[e.kind, e.step, e.detail] for e in res.events],
           "stats": res.stats, "peer_loss": res.peer_loss, "seen": seen,
           "phases": {k: [n, round(ms, 3)] for k, (n, ms) in phases.items()},
           "k3": registry.launches().get("flash_attn_fwd", 0),
           "k3_sm90": registry.launches().get("flash_attn_fwd_sm90", 0),
           "wall_s": time.perf_counter() - t0,
           "backend": D.process_info()["backend"]}
    with open(os.path.join(out, f"result_l{inc}_r{rank}.json"), "w") as f:
        json.dump(doc, f)
    if res.status == "peer_lost":
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(PEER_LOST_EXIT)
    D.shutdown()
    return 0


def _co_fleet(root, arm, faults, max_launches=1, audit=None):
    """One arm's fleet of two workers on the card through the port's
    launcher (the kernels built before, loaded from the shared build
    directory): (FleetResult, checkpoint dir, output dir, wall s)."""
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.resilience.launcher import FleetLauncher
    ckpt, out = os.path.join(root, f"ckpt{arm}"), os.path.join(root,
                                                               f"out{arm}")
    os.makedirs(out)
    script = os.path.abspath(__file__)

    def build_argv(size, rank, coordinator):
        return [sys.executable, script, "--coord-worker",
                json.dumps({"ckpt": ckpt, "out": out, "faults": faults})]

    class Audited(FleetLauncher):
        def launch_once(self, size, launch_index=0):
            rec = super().launch_once(size, launch_index)
            if audit is not None:
                audit(rec)
            return rec

    t0 = time.perf_counter()
    res = Audited(build_argv, min_size=1, max_launches=max_launches,
                  straggler_grace_s=3 * CO_TIMEOUT_S, launch_timeout_s=600,
                  cwd=os.path.dirname(script), log_dir=out,
                  compile_cache_dir=str(_build.build_dir())).run(2)
    return res, ckpt, out, time.perf_counter() - t0


def _co_doc(out, launch, rank):
    with open(os.path.join(out, f"result_l{launch}_r{rank}.json")) as f:
        return json.load(f)


def _co_params(out, launch, rank):
    import torch
    return torch.load(os.path.join(out, f"params_l{launch}_r{rank}.pt"))


def _co_log(out):
    import glob
    return "\n".join(open(p).read()[-2500:]
                     for p in sorted(glob.glob(os.path.join(out, "*.log"))))


def phase_coordinated(card=None):
    """The port's counterpart of scripts/chaos_multihost.py on the card:
    fleets of two gloo workers sharing it, started by the port's
    FleetLauncher; gpt_mini at full width (BF16, K3), coordinate=True,
    collective_timeout_s = CO_TIMEOUT_S, fit_pipeline over a datapipe
    sharded by rank, a TrainingStatsCollector on each rank. Arm A: a NaN
    param leaf on rank 0 alone at step 4, both ranks roll back, params
    bit-equal across ranks and to a no-fault control fleet. Arm B:
    SIGKILL on rank 1 at step 5, rank 0 names it within the deadline,
    writes a peer_lost flight record and no further checkpoint, exits
    PEER_LOST_EXIT; the launcher relaunches one process, which restores
    the two-process checkpoint (reshard) and lands bit for bit on a
    one-process control restoring the same checkpoint here, its records
    tiling the epoch from the low-water mark. Arm C: SIGTERM on rank 1,
    both ranks stop at one step with one barriered checkpoint and both
    run reports. The four fleets run at once."""
    import glob
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.datapipe.reshard import (low_water_mark,
                                                           remap_for)
    from deeplearning4j_tpu_torch.resilience.launcher import PEER_LOST_EXIT
    from deeplearning4j_tpu_torch.utils.checkpoint import (
        find_latest_checkpoint, read_checkpoint_meta,
        restore_multi_layer_network)

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="coordinated_")
    state = {}

    def audit(rec):
        if rec.peer_lost_ranks:
            latest = find_latest_checkpoint(os.path.join(root, "ckptB"))
            state["latest"] = latest
            state["meta"] = read_checkpoint_meta(latest)
            state["t_detect"] = time.perf_counter()

    plans = {"A": ({"poison": [CO_POISON_STEP, 0]}, {}),
             "A0": ({}, {}),
             "B": ({"kill": [CO_KILL_STEP, 1]},
                   {"max_launches": 3, "audit": audit}),
             "C": ({"sigterm": [CO_SIGTERM_STEP, 1]}, {})}
    done = {}

    def run(arm, faults, kw):
        try:
            done[arm] = _co_fleet(root, arm, faults, **kw)
        except BaseException as e:  # raised below, on the main thread
            done[arm] = e

    try:
        threads = [threading.Thread(target=run, args=(arm, f, kw),
                                    daemon=True)
                   for arm, (f, kw) in plans.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=1800)
        for arm in plans:
            check(arm in done, f"[coordinated] arm {arm} did not finish")
            if isinstance(done[arm], BaseException):
                raise done[arm]
        walls = {arm: done[arm][3] for arm in plans}

        # arm A: lockstep rollback, bit-equal across ranks and to A0
        resA, _, outA, _ = done["A"]
        resA0, _, outA0, _ = done["A0"]
        check(resA.status == "completed" and resA0.status == "completed",
              f"[coordinated] A {resA.status} A0 {resA0.status}:\n"
              f"{_co_log(outA)}")
        dA = [_co_doc(outA, 0, r) for r in (0, 1)]
        for d in dA:
            check(d["status"] == "completed" and d["final_step"] == CO_STEPS
                  and d["stats"]["rollbacks_total"] == 1,
                  f"[coordinated] arm A rank: {d['status']} at "
                  f"{d['final_step']}, {d['stats']}")
            check(d["backend"] == "gloo" and d["k3"] > 0
                  and d["k3_sm90"] == d["k3"], f"[coordinated] arm A: K3 "
                  f"{d['k3']} ({d['k3_sm90']} sm90) on {d['backend']}")
        pA = [_co_params(outA, 0, r) for r in (0, 1)]
        pA0 = _co_params(outA0, 0, 0)
        check(all(torch.equal(a, b) for a, b in zip(pA[0], pA[1])),
              "[coordinated] arm A: the ranks' params differ")
        check(all(torch.equal(a, b) for a, b in zip(pA[0], pA0)),
              "[coordinated] arm A: params differ from the no-fault fleet")
        phase("coordinated", arm="A_lockstep_rollback",
              rollbacks=[d["stats"]["rollbacks_total"] for d in dA],
              bit_equal_ranks=True, bit_equal_control=True,
              k3_launches=[d["k3"] for d in dA],
              phases_rank0=json.dumps(dA[0]["phases"]),
              wall_s=f"{walls['A']:.1f}",
              control_wall_s=f"{walls['A0']:.1f}", card=card)

        # arm B: the peer's death named, the relaunch restores and matches
        resB, ckptB, outB, _ = done["B"]
        check(resB.status == "completed" and resB.final_size == 1
              and len(resB.launches) == 2,
              f"[coordinated] arm B {resB}:\n{_co_log(outB)}")
        first = resB.launches[0]
        check(first.peer_lost_ranks == [0]
              and first.workers[0].returncode == PEER_LOST_EXIT
              and first.workers[1].returncode < 0,
              f"[coordinated] arm B first launch {first.workers}")
        d0 = _co_doc(outB, 0, 0)
        check(d0["status"] == "peer_lost"
              and d0["peer_loss"]["lost_ranks"] == [1]
              and d0["peer_loss"]["detection_s"] <= CO_TIMEOUT_S + 5,
              f"[coordinated] arm B survivor {d0['status']} "
              f"{d0['peer_loss']}")
        flights = [p for p in glob.glob(os.path.join(ckptB, "flight_*"))
                   if json.load(open(p)).get("reason") == "peer_lost"]
        check(flights, "[coordinated] arm B: no peer_lost flight record")
        step = int(os.path.basename(state["latest"]).split("_")[1])
        check(step == (CO_KILL_STEP // CO_CKPT_EVERY) * CO_CKPT_EVERY,
              f"[coordinated] arm B: newest checkpoint {state['latest']}")
        d1 = _co_doc(outB, 1, 0)
        low = low_water_mark(state["meta"]["datapipe"])
        check(d1["status"] == "completed" and d1["size"] == 1
              and d1["resumed_from"] == os.path.basename(state["latest"])
              and any(e[0] == "reshard" for e in d1["events"])
              and d1["seen"] == list(range(low, CO_RECORDS))
              and d1["final_step"] == CO_STEPS,
              f"[coordinated] arm B relaunch {d1['status']} "
              f"{d1['resumed_from']} seen {d1['seen'][:4]}.. low {low}")
        control = restore_multi_layer_network(state["latest"])
        seen = []
        pipe = co_pipeline(co_corpus(), 1, 0, seen)
        pipe.load_state_dict(remap_for(pipe, state["meta"]["datapipe"]))
        for ds in pipe.stream(1):
            control.fit_batch(ds)
        torch.cuda.synchronize()
        check(seen == d1["seen"], "[coordinated] arm B: the control read "
              "other records")
        check(all(torch.equal(a, b.detach().cpu()) for a, b in zip(
            _co_params(outB, 1, 0), _leaf_list(control.params))),
            "[coordinated] arm B: the survivor's params differ from the "
            "one-process control's")
        del control
        phase("coordinated", arm="B_peer_loss_relaunch",
              lost_ranks=d0["peer_loss"]["lost_ranks"],
              detection_s=f"{d0['peer_loss']['detection_s']:.3f}",
              collective_timeout_s=CO_TIMEOUT_S,
              exit_codes=[w.returncode for w in first.workers],
              newest_checkpoint=os.path.basename(state["latest"]),
              low_water=low, relaunch_size=resB.final_size,
              bit_equal_control=True,
              k3_launches=[d0["k3"], d1["k3"]],
              phases_relaunch=json.dumps(d1["phases"]),
              wall_s=f"{walls['B']:.1f}", card=card)

        # arm C: SIGTERM on rank 1 stops both at one step
        resC, ckptC, outC, _ = done["C"]
        check(resC.status == "completed", f"[coordinated] arm C {resC}:\n"
              f"{_co_log(outC)}")
        dC = [_co_doc(outC, 0, r) for r in (0, 1)]
        check(all(d["status"] == "preempted" for d in dC)
              and dC[0]["final_step"] == dC[1]["final_step"] < CO_STEPS,
              f"[coordinated] arm C {[(d['status'], d['final_step']) for d in dC]}")
        latest = find_latest_checkpoint(ckptC)
        check(latest.endswith(f"step_{dC[0]['final_step']}")
              and os.path.exists(os.path.join(ckptC, "run_report.json"))
              and os.path.exists(os.path.join(ckptC, "run_report.r1.json")),
              f"[coordinated] arm C: {latest}, {os.listdir(ckptC)}")
        pC = [_co_params(outC, 0, r) for r in (0, 1)]
        check(all(torch.equal(a, b) for a, b in zip(pC[0], pC[1])),
              "[coordinated] arm C: the ranks' params differ")
        phase("coordinated", arm="C_sigterm_broadcast",
              final_steps=[d["final_step"] for d in dC],
              checkpoint=os.path.basename(latest),
              run_reports=["run_report.json", "run_report.r1.json"],
              k3_launches=[d["k3"] for d in dC],
              wall_s=f"{walls['C']:.1f}",
              phase_s=f"{time.perf_counter() - t_phase:.1f}", card=card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------- slice 22
# [wide_kernels]: K1/K2 and K3 at the widths past their first kernels'
# limits that the JAX package's Pallas kernels take (ROADMAP C.6). K1/K2:
# b = 32, T = 64, f32 n = 1024 (K1 past its grid kernel, K2's still
# holds it), 1152 (the char-RNN below: both past their grid kernels) and
# 2048, bf16 n = 2048; each held against its plain version under
# [kernel_vs_plain]'s limits. K3: b = 4, h = 2 at T = 256 for dh 256,
# 512 and 1024, and at T = 128 for the largest head size the JAX
# kernel's VMEM budget takes (2,944 f32, 5,248 bf16); plus the wide-head
# gpt_mini's own shape (b = 8, T = 256, h = 2, dh = 256, F32).
WIDE_T, WIDE_B = 64, 32
WIDE_LSTM = [("float32", 1024), ("float32", 1152), ("float32", 2048),
             ("bfloat16", 2048)]
WIDE_RNN_N = 1152
WIDE_ATT_B, WIDE_ATT_H = 4, 2
WIDE_DH_BUDGET = {"float32": 2944, "bfloat16": 5248}
WIDE_GPT = dict(width=512, n_layers=2, n_heads=2, b=8)   # dh = 256


def lstm_bytes(T, b, n, elem, backward):
    """Bytes K1 (K2) must move: each input read once, each output written
    once (no residuals for K1)."""
    if not backward:   # xz, Wh, p, h0, c0, mask in; y, hT, cT out
        return elem * (T * b * 4 * n + 4 * n * n + 3 * n + 4 * b * n
                       + T * b + T * b * n)
    # G, h_prev, c_prev, mask, Wh, p, dy, dhT, dcT in; dxz, dh0, dc0,
    # dWh, dp out
    return elem * (2 * T * b * 4 * n + 3 * T * b * n + T * b
                   + 2 * 4 * n * n + 2 * 3 * n + 4 * b * n)


def wide_lstm_case(dtype, n):
    """K1 and K2 on the wide route at (T, b) = (WIDE_T, WIDE_B), called
    directly (uncounted), held against their plain versions; where the
    wrapper's route is wide too, the wrapper's call (counted) equals the
    direct one bit for bit. Returns the two kernels' fields."""
    import torch
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    td = getattr(torch, dtype)
    T, b = WIDE_T, WIDE_B
    xz, h0, c0, Wh, p, _ = lstm_inputs(T, b, n, td)
    mask = torch.ones((T, b), dtype=td, device="cuda")
    fwd = (xz, h0, c0, Wh, p, mask)
    what = f"T={T} b={b} n={n} {dtype} wide route"
    out = {}
    with torch.inference_mode():
        got = lstm_ops.lstm_fwd_launch("wide", *fwd, True)
        torch.cuda.synchronize()
        want = lstm_ops.lstm_sequence_torch(*fwd, save_residuals=True)
        errs = fwd_errors(got, want, TOL[dtype], what)
        routes = {"fwd": lstm_ops.kernel_route(td, n),
                  "bwd": lstm_ops.kernel_route(td, n, backward=True)}
        if routes["fwd"] == "wide":
            via = lstm_ops.lstm_sequence_cuda(*fwd, save_residuals=True)
            check(all(torch.equal(a, c) for a, c in zip(via, got)),
                  f"lstm_fwd {what}: the wrapper's call differs from the "
                  f"wide launch")
        ms = device_ms_per_call(
            lambda: lstm_ops.lstm_fwd_launch("wide", *fwd, False), reps=5)[0]
        plain_ms = cuda_ms(lambda: lstm_ops.lstm_sequence_torch(*fwd),
                           reps=3)
        elem = 2 if dtype == "bfloat16" else 4
        bound_ms, bound_by = bound(lstm_ops.fwd_flops(T, b, n),
                                   lstm_bytes(T, b, n, elem, False), dtype)
        out["lstm_fwd_wide"] = dict(max_abs_err=max(errs.values()), ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by)
        phase("wide_kernels", kernel="lstm_fwd", route="wide",
              wrapper_route=routes["fwd"], dtype=dtype, T=T, b=b, n=n,
              tol=TOL[dtype], max_abs_err=short(errs), ms=f"{ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.5f}",
              bound_by=bound_by, library_ms=None)

        rng = np.random.default_rng(SEED + 2200 + n)
        f = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa
            "cuda", td)
        bwd = ((got.G, got.h_prev, got.c_prev), mask, Wh, p,
               f(rng.normal(0.0, 1.0, (T, b, n))),
               f(rng.normal(0.0, 1.0, (b, n))),
               f(rng.normal(0.0, 1.0, (b, n))))
        g1 = lstm_ops.lstm_bwd_launch("wide", *bwd)
        g2 = lstm_ops.lstm_bwd_launch("wide", *bwd)
        torch.cuda.synchronize()
        gwant = lstm_ops.lstm_sequence_bwd_torch(*bwd)
        berrs, btols = bwd_errors(g1, g2, gwant, td, what)
        if routes["bwd"] == "wide":
            via = lstm_ops.lstm_sequence_bwd_cuda(*bwd)
            check(all(torch.equal(a, c) for a, c in zip(via, g1)),
                  f"lstm_bwd {what}: the wrapper's call differs from the "
                  f"wide launch")
        ms = device_ms_per_call(
            lambda: lstm_ops.lstm_bwd_launch("wide", *bwd), reps=5)[0]
        plain_ms = cuda_ms(lambda: lstm_ops.lstm_sequence_bwd_torch(*bwd),
                           reps=3)
        bound_ms, bound_by = bound(lstm_ops.bwd_flops(T, b, n),
                                   lstm_bytes(T, b, n, elem, True), dtype)
        out["lstm_bwd_wide"] = dict(max_abs_err=max(berrs.values()), ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by)
        phase("wide_kernels", kernel="lstm_bwd", route="wide",
              wrapper_route=routes["bwd"], dtype=dtype, T=T, b=b, n=n,
              deterministic=True, max_abs_err=short(berrs), tol=short(btols),
              ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              bound_ms=f"{bound_ms:.5f}", bound_by=bound_by, library_ms=None)
    return out


def wide_attention_case(dtype, b, T, h, dh, grads=False):
    """K3 on the wide route through the port's wrapper (counted), twice,
    bit-equal, held against causal_mha_exact under K3's limits (f32
    FLASH_F32_TOL; bf16 FLASH_BF16_ULPS at max|v|), beside the plain
    version (causal_mha_dot) and SDPA (is_causal=True) at the same shape.
    The wide counter must move by the calls made before the timing."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops import registry
    td = getattr(torch, dtype)
    base = registry.launches().get(att.KERNEL_WIDE, 0)
    q, k, v = flash_inputs(b, T, h, dh, td, seed=dh)
    what = f"flash_attn_fwd (wide) ({b},{T},{h},{dh}) {dtype}"
    check(att.attention_route(td, T, T, dh) == "kernel"
          and att.flash_route(td, dh) == "wide", f"{what}: not the wide "
          f"route")
    with torch.inference_mode():
        got = att.flash_attn_fwd_cuda(q, k, v)
        again = att.flash_attn_fwd_cuda(q, k, v)
        torch.cuda.synchronize()
        exact = att.causal_mha_exact(q, k, v)
        dot = att.flash_attn_fwd_torch(q, k, v)
    check(torch.isfinite(got.float()).all().item(), f"{what}: not finite")
    check(torch.equal(got, again), f"{what}: two calls differ")
    d = (got.float() - exact.float()).abs()
    err = d.max().item()
    dot_err = float((got.float() - dot.float()).abs().max())
    if dtype == "float32":
        tol = f"{FLASH_F32_TOL}+{FLASH_F32_TOL}*|want|"
        ok = not (d > FLASH_F32_TOL * (1 + exact.float().abs())).any()
    else:
        vmax = float(v.float().abs().max())
        lim = FLASH_BF16_ULPS * 2.0 ** (math.floor(math.log2(vmax)) - 7)
        tol, ok = f"{lim:.3e}", err <= lim
    check(bool(ok), f"{what} disagrees with causal_mha_exact: max abs err "
          f"{err:.3e} > {tol}")
    calls = 2
    fields = {}
    if grads:
        fields["grad_err_of_tol"] = f"{flash_grads_vs_exact(q, k, v):.2e}"
        calls += 1
    counted = registry.launches().get(att.KERNEL_WIDE, 0) - base
    check(counted == calls, f"{what}: flash_attn_fwd_wide moved by "
          f"{counted} in {calls} calls")
    with torch.inference_mode():
        ms = device_ms_per_call(lambda: att.flash_attn_fwd_cuda(q, k, v),
                                reps=10)[0]
        plain_ms = cuda_ms(lambda: att.flash_attn_fwd_torch(q, k, v),
                           reps=5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = device_ms_per_call(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True),
            reps=10)[0]
    elem = 2 if dtype == "bfloat16" else 4
    # the causal work: T (T + 1) / 2 score and weight pairs a head
    flops = 4 * b * h * dh * T * (T + 1) // 2
    bound_ms, bound_by = bound(flops, 4 * b * T * h * dh * elem, dtype)
    phase("wide_kernels", kernel="flash_attn_fwd", route="wide",
          dtype=dtype, b=b, T=T, h=h, dh=dh, max_abs_err=f"{err:.3e}",
          vs_plain_dot=f"{dot_err:.3e}", tol=tol, deterministic=True,
          ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
          library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound_ms:.5f}",
          bound_by=bound_by, roofline_share=f"{bound_ms / ms:.4f}",
          **fields)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


def wide_train(make, batches, counters, what):
    """Two fit_batch steps of ``make()`` on one batch, the launch counters
    set to 0 just before and read just after: (counts, scores)."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    net = make()
    ds = on_card(batches)[0]
    torch.cuda.synchronize()
    registry.reset_launches()
    scores = [float(net.fit_batch(ds)) for _ in range(2)]
    torch.cuda.synchronize()
    launches = registry.launches()
    counts = {c: launches.get(c, 0) for c in counters}
    check(scores[1] < scores[0] and all(map(math.isfinite, scores)),
          f"{what}: the score did not fall over 2 steps: {scores}")
    check(not registry.routes(), f"{what}: composed calls "
          f"{registry.routes()}")
    return counts, scores


def phase_wide_kernels(card=None):
    """[wide_kernels] (ROADMAP C.6): the wide K1/K2 and K3 routes at the
    widths WIDE_LSTM and the head sizes above, each against its plain
    version, its time beside its bound (and SDPA's beside K3); a
    GravesLSTM char-RNN (n = WIDE_RNN_N, F32) and a wide-head gpt_mini
    (dh = 256, F32) take 2 fit_batch steps each with the wide kernels
    launched and counted. Nothing falls back: a failed build or launch
    fails the phase. Returns the kernels JSON entries."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    from deeplearning4j_tpu_torch.ops import registry
    t_phase = time.perf_counter()
    lstm_main = {}
    for dtype, n in WIDE_LSTM:
        fields = wide_lstm_case(dtype, n)
        if (dtype, n) == ("float32", WIDE_RNN_N):
            lstm_main = fields
    att_main = None
    for dtype in ("float32", "bfloat16"):
        shapes = [(WIDE_ATT_B, 256, WIDE_ATT_H, dh) for dh in (256, 512,
                                                               1024)]
        shapes.append((WIDE_ATT_B, 128, WIDE_ATT_H, WIDE_DH_BUDGET[dtype]))
        if dtype == "float32":
            shapes.append((WIDE_GPT["b"], 256, WIDE_GPT["n_heads"],
                           WIDE_GPT["width"] // WIDE_GPT["n_heads"]))
        for b, T, h, dh in shapes:
            fields = wide_attention_case(
                dtype, b, T, h, dh, grads=(dtype, T, dh) == ("float32",
                                                             256, 256))
            if (b, dtype) == (WIDE_GPT["b"], "float32"):
                att_main = fields

    # the training paths, counted from 0
    rnn_counts, rnn_scores = wide_train(
        lambda: zoo.char_rnn(hidden=WIDE_RNN_N, dtype=zoo.F32,
                             device="cuda"),
        markov_batches(1, WIDE_B, WIDE_T, 80, SEED + 2210),
        (lstm_ops.KERNEL, lstm_ops.FWD_WIDE, lstm_ops.BWD_KERNEL,
         lstm_ops.BWD_WIDE), "char-RNN n=1152")
    check(rnn_counts[lstm_ops.FWD_WIDE] == rnn_counts[lstm_ops.KERNEL] == 4
          and rnn_counts[lstm_ops.BWD_WIDE] == 4
          and rnn_counts[lstm_ops.BWD_KERNEL] == 8,
          f"char-RNN n={WIDE_RNN_N}: launches {rnn_counts} in 2 steps of 2 "
          f"layers (K1 4 wide calls, K2 4 wide calls of 2 launches)")
    phase("wide_kernels", path="train_char_rnn", n=WIDE_RNN_N, layers=2,
          policy="F32", b=WIDE_B, T=WIDE_T, steps=2,
          scores=json.dumps([round(x, 6) for x in rnn_scores]),
          launches=json.dumps(rnn_counts))
    gpt_counts, gpt_scores = wide_train(
        lambda: zoo.gpt_mini(width=WIDE_GPT["width"],
                             n_layers=WIDE_GPT["n_layers"],
                             n_heads=WIDE_GPT["n_heads"], max_len=256,
                             vocab_size=80, dtype=zoo.F32, device="cuda"),
        markov_batches(1, WIDE_GPT["b"], 256, 80, SEED + 2211),
        (att.KERNEL, att.KERNEL_WIDE), "gpt_mini dh=256")
    want = 2 * WIDE_GPT["n_layers"]
    check(gpt_counts[att.KERNEL_WIDE] == gpt_counts[att.KERNEL] == want,
          f"gpt_mini dh=256: K3 launches {gpt_counts} in 2 steps, want "
          f"{want} on the wide route")
    phase("wide_kernels", path="train_gpt_mini_dh256",
          width=WIDE_GPT["width"], heads=WIDE_GPT["n_heads"], dh=256,
          blocks=WIDE_GPT["n_layers"], policy="F32", b=WIDE_GPT["b"], T=256,
          steps=2, scores=json.dumps([round(x, 6) for x in gpt_scores]),
          launches=json.dumps(gpt_counts),
          phase_s=f"{time.perf_counter() - t_phase:.1f}", card=card)
    entries = []
    for name, launches, src, rep in (
            ("lstm_fwd_wide", rnn_counts[lstm_ops.FWD_WIDE], "lstm_fwd.cu",
             "deeplearning4j_tpu/ops/lstm.py:239"),
            ("lstm_bwd_wide", rnn_counts[lstm_ops.BWD_WIDE], "lstm_bwd.cu",
             "deeplearning4j_tpu/ops/lstm.py:289")):
        f = lstm_main[name]
        entries.append({"name": name, "route": "cuda",
                        "source": f"deeplearning4j_tpu_torch/ops/csrc/{src}",
                        "replaces": rep, "launches": launches,
                        "max_abs_err": f["max_abs_err"], "ms": f["ms"],
                        "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
                        "bound_by": f["bound_by"], "library_ms": None})
    entries.append({"name": "flash_attn_fwd_wide", "route": "cuda",
                    "source": "deeplearning4j_tpu_torch/ops/csrc/"
                              "flash_attn_fwd.cu",
                    "replaces": "deeplearning4j_tpu/ops/attention.py:252",
                    "launches": gpt_counts[att.KERNEL_WIDE], **att_main})
    return entries


# [tensor_parallel]: gpt_mini at full width (width 256, 4 blocks of 4
# heads, T = 256) over a model axis (parallel/tensor.py,
# zoo.gpt_mini_tp_rules). (a) a 1-rank NCCL mesh {"data": 1, "model": 1},
# BF16, b = 32, captured; (b) two gloo ranks sharing the card on
# {"model": 2}, F32, b = 8, TP_STEPS eager Adam steps against one process;
# (c) (b)'s checkpoint restored unmeshed and onto {"model": 2} again.
TP_A_B, TP_B, TP_STEPS = 32, 8, 3
# (b)'s bounds: every step's score, and the next step's after them,
# within 1e-4 relative of one process's (the same forward summed in
# another order over the model axis; from step 2 on it reads the
# updates, so it holds the TP backward); the first step's Adam first
# moment (0.1 g: the gradient with its scale and sign, which Adam's
# update itself hides) within 1e-4 of one process's, relative to the L2
# norm of its layer's moments (F32 sums reordered over the model axis
# are ~1e-6 apart; a wrong scale or sign of a leaf is its share of the
# layer's norm, ~1e-2 or more; a leaf's own norm will not do, since a
# key bias's gradient is 0 but for rounding: softmax ignores it); and,
# as a looser second check, the gathered parameters within Adam's 2 lr a
# step of one process's (a sign flip of a near-0 gradient moves a leaf
# by 2 lr, as in [data_parallel]). (c) the next step's score after a restore within
# 1e-5 relative of the continued run's (tests/test_parallel.py:181-199).
TP_SCORE_RTOL, TP_GRAD_RTOL, TP_NEXT_RTOL = 1e-4, 1e-4, 1e-5


def adam_m(net):
    """A copy of the net's Adam first moments, {layer: {param: m}}."""
    return {k: {p: v.detach().clone() for p, v in sub["m"].items()}
            for k, sub in (net.opt_state or {}).items()
            if isinstance(sub, dict) and "m" in sub}


def tp_rank(port, rank, root, ck_dir):
    """One rank of [tensor_parallel] (b) and (c): gpt_mini F32 over
    {"model": 2} on a gloo group shared with the other rank on the one
    card, TP_STEPS fit_batch steps on the whole batch (the model group's
    rows), K3's head count spied, the step's collectives counted and an
    activation-sized all-reduce and gather timed alone; then the
    checkpoint, the next step, and the restore onto the mesh with its next
    step. Writes its whole parameters and its numbers to <root>/rank<r>
    (.pt and .json)."""
    out_path = os.path.join(root, f"rank{rank}")
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.ops import attention  # noqa: F401 (K3)
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.parallel import distributed as D
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.utils import checkpoint as tck
    D.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                 timeout_s=300)
    try:
        heads = []
        k3 = registry.get("flash_attn_fwd", "cuda")

        def spy(q, k, v):
            heads.append(int(q.shape[2]))
            return k3(q, k, v)
        registry.register("flash_attn_fwd", "cuda")(spy)
        rules = zoo.gpt_mini_tp_rules()
        mesh = make_mesh({"model": 2})
        base = torch.cuda.memory_allocated()
        net = dec_net("F32", seed=SEED + 2230)
        net.use_mesh(mesh, model_axis="model", tp_rules=rules)
        tp = net._tp
        rendered = {l.name: l.tp.rendered for l in net.layers
                    if l.tp is not None}
        data = on_card(markov_batches(TP_STEPS + 1, TP_B, DEC_C, DEC_V,
                                      SEED + 2231))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        registry.reset_launches()
        calls0, bytes0, secs0 = tp.mg.calls, tp.mg.bytes, tp.mg.seconds
        step_ms, scores = [], []
        for ds in data[:TP_STEPS]:
            t0 = time.perf_counter()
            scores.append(float(net.fit_batch(ds)))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if len(scores) == 1:
                m1 = adam_m(net)    # this rank's shards, gathered below
        launches = registry.launches()
        peak = torch.cuda.max_memory_allocated() - base
        calls = (tp.mg.calls - calls0) / TP_STEPS
        sent = (tp.mg.bytes - bytes0) / TP_STEPS
        coll_ms = (tp.mg.seconds - secs0) * 1e3 / TP_STEPS
        whole = tp.gathered(net.params, tp.specs)
        o_specs = tp.opt_specs(net.opt_state)
        m1 = tp.gathered(m1, {k: o_specs[k]["m"] for k in m1})
        local = {f"{k}/{p}": v.detach().cpu() for k, sub in net.params.items()
                 for p, v in sub.items()}
        act = torch.ones(TP_B, DEC_C, DEC_W, device=D.device())
        half = act[..., :DEC_W // 2].contiguous()
        ar_ms, ag_ms = [], []
        for _ in range(6):
            for fn, sink in ((lambda: tp.mg.all_reduce(act.clone()), ar_ms),
                             (lambda: tp.mg.all_gather(half, -1), ag_ms)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                sink.append((time.perf_counter() - t0) * 1e3)
        # (c) the checkpoint (whole arrays), the next step, the restore
        tck.save_checkpoint(net, ck_dir)
        cont = float(net.fit_batch(data[TP_STEPS]))
        back = tck.restore_multi_layer_network(
            ck_dir, mesh=mesh, model_axis="model", tp_rules=rules,
            device=D.device())
        restored_shard = tuple(back.params["layer_1"]["Wq"].shape)
        rest = float(back.fit_batch(data[TP_STEPS]))
        # gloo's all_gather_into_tensor on CUDA tensors, which the port's
        # gather runs (parallel/tensor.py), on a flat tensor alone
        try:
            out = torch.empty(2 * half.numel(), device=D.device())
            dist.all_gather_into_tensor(out, half.reshape(-1),
                                        group=tp.mg.group)
            torch.cuda.synchronize()
            probe = "ok"
        except Exception as e:  # recorded: the steps above ran it already
            probe = f"{type(e).__name__}: {str(e)[:160]}"
        torch.save({"whole": {f"{k}/{p}": v.detach().cpu()
                              for k, sub in whole.items()
                              for p, v in sub.items()},
                    "local": local,
                    "m1": {f"{k}/{p}": v.detach().cpu()
                           for k, sub in m1.items()
                           for p, v in sub.items()}}, out_path + ".pt")
        with open(out_path + ".json", "w") as f:
            json.dump({"scores": scores, "step_ms": step_ms,
                       "launches": launches, "heads": sorted(set(heads)),
                       "k3_calls": len(heads), "peak_bytes": peak,
                       "collectives_per_step": calls,
                       "bytes_per_step": sent, "rendered": rendered,
                       "collective_ms_per_step": coll_ms,
                       "allreduce_ms": ar_ms[1:], "gather_ms": ag_ms[1:],
                       "cont": cont, "rest": rest,
                       "restored_shard": restored_shard, "probe": probe,
                       "info": D.process_info()}, f)
    finally:
        D.shutdown()


def phase_tensor_parallel(card=None):
    """[tensor_parallel] (ROADMAP A.5 part 2, training): gpt_mini at full
    width over a model axis, arms (a)-(c) above. K3 runs on each rank's
    local heads: 4 launches a step, h = 2 in (b)."""
    import gc
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn import multistep
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.parallel import distributed, make_mesh
    from deeplearning4j_tpu_torch.utils import checkpoint as tck

    t_phase = time.perf_counter()
    # (a) a 1-rank NCCL mesh with a model axis of one: the captured step
    # is the unmeshed one bit for bit (a model group of one runs no
    # model-axis collective; the data axis's all-reduce is in the graph)
    info = distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        check(info["backend"] == "nccl", f"group {info}")
        batches = on_card(markov_batches(MESH_STEPS, TP_A_B, DEC_C, DEC_V,
                                         SEED + 2220))
        arms = {}
        for name in ("unmeshed", "meshed", "meshed_again", "unmeshed_again"):
            net = dec_net("BF16", seed=SEED + 2221)
            if name.startswith("meshed"):
                net.use_mesh(make_mesh({"data": 1, "model": 1}),
                             model_axis="model",
                             tp_rules=zoo.gpt_mini_tp_rules())
                check(net._mesh_detail["model_axis"] == "model",
                      f"mesh_detail {net._mesh_detail}")
            step_batches = [net._step_batch(ds) for ds in batches]
            torch.cuda.synchronize()
            registry.reset_launches()
            scores, ms, captures = captured_steps(net, step_batches)
            launches = registry.launches()
            check(captures == 1, f"{name}: {captures} captures")
            for kern in ("flash_attn_fwd", "flash_attn_fwd_sm90"):
                check(launches.get(kern, 0) == DEC_L * MESH_STEPS,
                      f"{name}: {kern} launched {launches.get(kern, 0)} "
                      f"times in {MESH_STEPS} steps")
            arms[name] = (net, scores, ms)
        ref_net, ref_scores, _ = arms["unmeshed"]
        for name in ("meshed", "meshed_again", "unmeshed_again"):
            net, scores, _ = arms[name]
            check(scores == ref_scores, f"{name} scores {scores} != "
                  f"{ref_scores}")
            for tree in ("params", "opt_state"):
                check(_bits_equal(getattr(net, tree), getattr(ref_net, tree)),
                      f"{name}: {tree} differ from the unmeshed captured "
                      f"step's")
        replay = {n: statistics.median(arms[n][2][multistep.WARMUP_STEPS
                                                  + 1:]) for n in arms}
        del arms, ref_net, net
    finally:
        distributed.shutdown()
    phase("tensor_parallel", arm="a_mesh_1rank_nccl",
          mesh=json.dumps({"data": 1, "model": 1}),
          model=f"gpt_mini(vocab={DEC_V},width={DEC_W},blocks={DEC_L},"
          f"heads={DEC_H},T={DEC_C},BF16,Adam(3e-4))",
          rules="gpt_mini_tp_rules", b=TP_A_B, steps=MESH_STEPS,
          bit_equal=True, captures=1,
          step_ms_meshed=f"{statistics.mean([replay['meshed'], replay['meshed_again']]):.4f}",
          step_ms_unmeshed=f"{statistics.mean([replay['unmeshed'], replay['unmeshed_again']]):.4f}",
          step_ms_by_arm=json.dumps({k: round(v, 4)
                                     for k, v in replay.items()}),
          k3_launches_per_step=DEC_L, k3_route="sm90", card=card)

    # (b) two ranks on the one card over gloo, {"model": 2}, eager
    root = tempfile.mkdtemp(prefix="tensor_parallel_")
    ck_dir = os.path.join(root, "ck", "step_3")
    procs = spawn_ranks("tp_rank", 2, root, ck_dir)
    try:
        gc.collect()     # arm (a)'s nets and their graphs' pools
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        one = dec_net("F32", seed=SEED + 2230)
        data = on_card(markov_batches(TP_STEPS + 1, TP_B, DEC_C, DEC_V,
                                      SEED + 2231))
        torch.cuda.synchronize()
        registry.reset_launches()
        one_ms, one_scores = [], []
        for ds in data[:TP_STEPS]:
            t0 = time.perf_counter()
            one_scores.append(float(one.fit_batch(ds)))
            torch.cuda.synchronize()
            one_ms.append((time.perf_counter() - t0) * 1e3)
            if len(one_scores) == 1:
                one_m1 = {f"{k}/{p}": v.cpu()
                          for k, sub in adam_m(one).items()
                          for p, v in sub.items()}
        one_peak = torch.cuda.max_memory_allocated() - base
        one_launches = registry.launches()
        ref = {f"{k}/{p}": v.detach().cpu().clone()
               for k, sub in one.params.items() for p, v in sub.items()}
        one_cont = float(one.fit_batch(data[TP_STEPS]))
        res = collect_ranks(procs, root, "tensor_parallel")
        p0 = torch.load(os.path.join(root, "rank0.pt"))
        p1 = torch.load(os.path.join(root, "rank1.pt"))
        check(all(torch.equal(p0["whole"][k], p1["whole"][k])
                  for k in p0["whole"]), "the ranks' gathered parameters "
              "differ")
        replicated = [k for k in p0["local"]
                      if p0["local"][k].shape == p0["whole"][k].shape]
        check(all(torch.equal(p0["local"][k], p1["local"][k])
                  for k in replicated), "a replicated leaf differs between "
              "the ranks")
        check(res[0]["scores"] == res[1]["scores"], "the ranks' scores "
              "differ")
        tp_max = max(float((p0["whole"][k].double() - ref[k].double()).abs()
                           .max()) for k in ref)
        bound = 2 * ADAM_LR * TP_STEPS
        check(tp_max <= bound, f"two TP ranks vs one process: {tp_max:.3e} "
              f"> {bound:.1e}")
        s_err = max(abs(a - b) / abs(b)
                    for a, b in zip(res[0]["scores"], one_scores))
        check(len(res[0]["scores"]) == len(one_scores) == TP_STEPS
              and s_err <= TP_SCORE_RTOL, f"scores {res[0]['scores']} vs "
              f"one process {one_scores}: {s_err:.2e}")
        check(set(p0["m1"]) == set(one_m1), f"Adam moments' leaves "
              f"{sorted(set(p0['m1']) ^ set(one_m1))}")
        layer_norm = {}
        for k, want in one_m1.items():
            ln = k.split("/")[0]
            layer_norm[ln] = layer_norm.get(ln, 0.0) + float(
                want.double().square().sum())
        m_err = {k: float((p0["m1"][k].double() - want.double()).norm())
                 / max(layer_norm[k.split("/")[0]] ** 0.5, 1e-30)
                 for k, want in one_m1.items()}
        m_worst = max(m_err, key=m_err.get)
        check(m_err[m_worst] <= TP_GRAD_RTOL, f"first step's Adam first "
              f"moment (the gradient) vs one process: {m_worst} "
              f"{m_err[m_worst]:.2e}")
        for r in res:
            # the spy also sees the FLOP count's uncounted forward
            check(r["launches"].get("flash_attn_fwd", 0) == DEC_L * TP_STEPS
                  and r["heads"] == [DEC_H // 2], f"a rank's K3: launches "
                  f"{r['launches']}, heads {r['heads']}")
            check(all(r["rendered"].values()), f"layers on the gather "
                  f"route: {r['rendered']}")
            check(not {k: v for k, v in r["launches"].items()
                       if registry.COMPOSED in k}, f"composed calls "
                  f"{r['launches']}")
        check(one_launches.get("flash_attn_fwd", 0) == DEC_L * TP_STEPS,
              f"one process launched K3 {one_launches}")
        # (c) the checkpoint restored unmeshed in this process
        back = tck.restore_multi_layer_network(ck_dir)
        check(tuple(back.params["layer_1"]["Wq"].shape) == (DEC_W, DEC_W),
              "the checkpoint does not hold whole arrays")
        unmeshed = float(back.fit_batch(data[TP_STEPS]))
        layout = tck.read_checkpoint_layout(ck_dir)
        check(layout["mesh_detail"]["model_axis"] == "model",
              f"layout {layout['mesh_detail']}")
        nxt = {"continued": res[0]["cont"], "restored_mesh": res[0]["rest"],
               "restored_unmeshed": unmeshed}
        check(all(abs(v - res[0]["cont"]) <= TP_NEXT_RTOL
                  * abs(res[0]["cont"]) for v in nxt.values()),
              f"(c) next step's score {nxt}")
        nxt["one_process"] = one_cont
        cont_err = abs(res[0]["cont"] - one_cont) / abs(one_cont)
        check(cont_err <= TP_SCORE_RTOL, f"the next step's score "
              f"{res[0]['cont']} vs one process {one_cont}: {cont_err:.2e}")
        check(tuple(res[0]["restored_shard"]) == (DEC_W, DEC_W // 2),
              f"restored onto the mesh: Wq shard {res[0]['restored_shard']}")
    finally:
        stop_ranks(procs)
        shutil.rmtree(root, ignore_errors=True)
    med = lambda xs: statistics.median(xs)  # noqa: E731
    phase("tensor_parallel", arm="b_two_ranks_gloo", backend="gloo",
          mesh=json.dumps({"model": 2}), rules="gpt_mini_tp_rules",
          policy="F32", b=TP_B, steps=TP_STEPS, replicated_bit_equal=True,
          scores=json.dumps([round(x, 6) for x in res[0]["scores"]]),
          one_process_scores=json.dumps([round(x, 6) for x in one_scores]),
          vs_one_process_max_abs=f"{tp_max:.3e}", bound=f"{bound:.1e}",
          score_rel_err=f"{s_err:.2e}", score_rtol=TP_SCORE_RTOL,
          step1_grad_rel_err=f"{m_err[m_worst]:.2e}",
          step1_grad_worst_leaf=m_worst, grad_rtol=TP_GRAD_RTOL,
          k3_launches_per_step=DEC_L, k3_heads=DEC_H // 2, k3_route="fma",
          collectives_per_step=res[0]["collectives_per_step"],
          collective_mb_per_step=f"{res[0]['bytes_per_step'] / 1e6:.2f}",
          collective_ms_per_step=json.dumps(
              [round(r["collective_ms_per_step"], 2) for r in res]),
          allreduce_ms=f"{med(res[0]['allreduce_ms']):.3f}",
          gather_ms=f"{med(res[0]['gather_ms']):.3f}",
          activation_mb=f"{TP_B * DEC_C * DEC_W * 4 / 1e6:.2f}",
          step_ms_ranks=json.dumps([[round(x, 2) for x in r["step_ms"]]
                                    for r in res]),
          step_ms_one_process=json.dumps([round(x, 2) for x in one_ms]),
          peak_mb_ranks=json.dumps([round(r["peak_bytes"] / 2**20, 1)
                                    for r in res]),
          peak_mb_one_process=f"{one_peak / 2**20:.1f}",
          gloo_all_gather_into_tensor_cuda=json.dumps(res[0]["probe"]),
          card=card)
    phase("tensor_parallel", arm="c_checkpoint", saved_at="model=2",
          next_scores=json.dumps({k: round(v, 7) for k, v in nxt.items()}),
          rtol=TP_NEXT_RTOL, whole_arrays=True,
          next_vs_one_process_rel_err=f"{cont_err:.2e}",
          restored_wq_shard=json.dumps(res[0]["restored_shard"]),
          phase_s=f"{time.perf_counter() - t_phase:.1f}")


# ------------------------------------------- graph tensor parallelism
# [graph_tensor_parallel] (ROADMAP A.5 part 2, the graph half): ResNet-50
# at full width (32 x 32, 10 classes, its 13 tails fused), as [meshed_bn]
# builds it. (a) a 1-rank NCCL mesh {"data": 1, "model": 1}, BF16,
# b = GTP_A_B, captured; (b) two gloo ranks sharing the card on
# {"model": 2}, F32, b = GTP_B, GTP_STEPS eager steps; (c) the tails'
# column-shard shapes (M, K, N/2) at (a)'s batch through K4-K7's sm90
# path against their plain versions; (d) (b)'s checkpoint restored.
GTP_A_B = 32
GTP_B, GTP_STEPS = 8, 3
# (b) against one process on the same batch, F32. Step 1's score within
# GTP_SCORE_RTOL relative ([tensor_parallel]'s bound: the same weights).
# Later scores, and step 1's gradient (the Nesterov velocity after step 1,
# v = -lr g from zero, leaf by leaf in L2 over its layer's norm, the
# worst leaf), within GTP_GRAD_RTOL or, where it is larger,
# MBN_CHAOS_FACTOR times the larger distance of GTP_CHAOS_RUNS
# one-process runs on the same rows permuted (which changes only the
# order of their sums) plus MBN_CHAOS_FLOOR: at b = 8 the last stage's
# BN normalises 8 values a channel and the gradient of the relu /
# max-pool net is discontinuous, so any reordering (TP's all-reduced dx
# is one) moves it: a permuted run lies 1.4-2.2% of a layer's norm off
# at step 1 and 17% off in score at step 2 on the CPU, and on an H100 a
# 1e-4 bound failed at step 3 with 3.84e-3 (PERF.md). A backward
# that dropped a rank's half of dx lies O(1) away.
GTP_SCORE_RTOL, GTP_GRAD_RTOL, GTP_NEXT_RTOL = 1e-4, 1e-4, 1e-5
GTP_CHAOS_RUNS = 2


def _gtp_spy(shapes):
    """Wrap K4-K7's CUDA wrappers so each call's (kernel, M, K, N) is
    appended to ``shapes``; the calls go through unchanged."""
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry
    for kern in (fb.STATS, fb.APPLY, fb.BWD_STATS, fb.BWD_APPLY):
        fn = registry.get(kern, "cuda")

        def spy(x2, W, *rest, _fn=fn, _k=kern):
            shapes.append((_k, int(x2.shape[0]), int(W.shape[0]),
                           int(W.shape[1])))
            return _fn(x2, W, *rest)
        registry.register(kern, "cuda")(spy)


def gtp_rank(port, rank, root, ck_dir):
    """One rank of [graph_tensor_parallel]'s arm (b): a named gloo group
    of two on the one card, ResNet-50 (F32, 13 fused tails) on
    {"model": 2}, GTP_STEPS fit_batch steps on the whole batch, the
    launch shapes of K4-K7, the collectives, the peak memory, then (d)
    the checkpoint, the continued step and the restore onto the mesh.
    Writes to <root>/rank<r> (.pt and .json)."""
    out_path = os.path.join(root, f"rank{rank}")
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.parallel import distributed as D
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.utils import checkpoint as tck
    D.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                 timeout_s=300)
    try:
        shapes = []
        _gtp_spy(shapes)
        mesh = make_mesh({"model": 2})
        base = torch.cuda.memory_allocated()
        net = mbn_net("F32", SEED + 2301)
        net.use_mesh(mesh, model_axis="model")
        tp = net._tp
        data = mbn_batches(GTP_STEPS + 1, GTP_B, SEED + 2302)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        registry.reset_launches()
        calls0, bytes0, secs0 = tp.mg.calls, tp.mg.bytes, tp.mg.seconds
        step_ms, scores = [], []
        for ds in data[:GTP_STEPS]:
            t0 = time.perf_counter()
            scores.append(float(net.fit_batch(ds)))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if len(scores) == 1:
                v1 = {k: {"v": dict(s["v"])} for k, s in
                      net.opt_state.items() if "v" in s}
                v1 = _map_clone(v1)
        launches = registry.launches()
        routes = registry.routes()
        step_shapes = list(shapes)     # the GTP_STEPS steps' calls only
        peak = torch.cuda.max_memory_allocated() - base
        calls = (tp.mg.calls - calls0) / GTP_STEPS
        sent = (tp.mg.bytes - bytes0) / GTP_STEPS
        coll_ms = (tp.mg.seconds - secs0) * 1e3 / GTP_STEPS
        o_specs = tp.opt_specs(net.opt_state)
        v1 = tp.gathered(v1, {k: {"v": o_specs[k]["v"]} for k in v1})
        whole = tp.gathered(net.params, tp.specs)
        local = {f"{k}/{p}": v.detach().cpu() for k, sub in net.params.items()
                 for p, v in sub.items()}
        state = {f"{k}/{p}": v.detach().cpu() for k, sub in net.state.items()
                 for p, v in sub.items()}
        tck.save_checkpoint(net, ck_dir)
        cont = float(net.fit_batch(data[GTP_STEPS]))
        back = tck.restore_computation_graph(ck_dir, mesh=mesh,
                                             model_axis="model",
                                             device=D.device())
        restored_shard = tuple(back.params["s1b0_c_conv"]["W"].shape)
        rest = float(back.fit_batch(data[GTP_STEPS]))
        torch.save({"whole": {f"{k}/{p}": v.detach().cpu()
                              for k, sub in whole.items()
                              for p, v in sub.items()},
                    "local": local, "state": state,
                    "v1": {f"{k}/{p}": v.detach().cpu()
                           for k, sub in v1.items()
                           for p, v in sub["v"].items()}}, out_path + ".pt")
        with open(out_path + ".json", "w") as f:
            json.dump({"scores": scores, "step_ms": step_ms,
                       "launches": launches, "routes": routes,
                       "shapes": step_shapes[:len(step_shapes)
                                             // GTP_STEPS],
                       "calls_total": len(step_shapes), "peak_bytes": peak,
                       "collectives_per_step": calls,
                       "bytes_per_step": sent,
                       "collective_ms_per_step": coll_ms,
                       "cont": cont, "rest": rest,
                       "restored_shard": restored_shard}, f)
    finally:
        D.shutdown()


def _map_clone(tree):
    from deeplearning4j_tpu_torch.nn.updater import _map
    return _map(lambda t: t.detach().clone(), tree)


def gtp_velocity_err(got, one_v1):
    """{leaf: L2 of (got - want) / L2 of the leaf's layer} over the
    first-step velocities (``layer/param`` keys)."""
    layer_norm = {}
    for k, want in one_v1.items():
        ln = k.split("/")[0]
        layer_norm[ln] = layer_norm.get(ln, 0.0) + float(
            want.double().square().sum())
    return {k: float((got[k].double() - want.double()).norm())
            / max(layer_norm[k.split("/")[0]] ** 0.5, 1e-30)
            for k, want in one_v1.items()}


def gtp_one_process(data, perm_seed=None):
    """One process's F32 run of (b)'s steps: (net, scores, step ms, the
    first step's velocities by ``layer/param``); ``perm_seed`` permutes
    each batch's rows (the chaos yardstick)."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    net = mbn_net("F32", SEED + 2301)
    scores, ms, v1 = [], [], None
    for ds in data:
        if perm_seed is not None:
            idx = torch.randperm(GTP_B, generator=torch.Generator()
                                 .manual_seed(perm_seed)).cuda()
            ds = DataSet(ds.features[idx], ds.labels[idx])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores.append(float(net.fit_batch(ds)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if v1 is None:
            v1 = {f"{k}/{p}": v.detach().cpu().clone()
                  for k, s in net.opt_state.items() if "v" in s
                  for p, v in s["v"].items()}
    return net, scores, ms, v1


def phase_graph_tensor_parallel(card=None):
    """[graph_tensor_parallel]: arms (a)-(d) above."""
    import gc
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.nn import multistep
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.parallel import distributed, make_mesh
    from deeplearning4j_tpu_torch.utils import checkpoint as tck

    t_phase = time.perf_counter()
    kernels = (fb.STATS, fb.APPLY, fb.BWD_STATS, fb.BWD_APPLY)
    # (a) a model axis of one on a 1-rank NCCL mesh: the captured step is
    # the unmeshed one bit for bit
    info = distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        check(info["backend"] == "nccl", f"group {info}")
        batches = mbn_batches(MBN_STEPS, GTP_A_B, SEED + 2300)
        arms = {}
        for name in ("unmeshed", "meshed", "meshed_again",
                     "unmeshed_again"):
            net = mbn_net("BF16", SEED + 2301)
            if name.startswith("meshed"):
                net.use_mesh(make_mesh({"data": 1, "model": 1}),
                             model_axis="model")
            step_batches = [net._step_batch(ds) for ds in batches]
            torch.cuda.synchronize()
            registry.reset_launches()
            scores, ms, captures = captured_steps(net, step_batches)
            launches = registry.launches()
            check(captures == 1, f"{name}: {captures} captures")
            for kern in fb.SM90_COUNTER.values():
                check(launches.get(kern, 0) == 13 * MBN_STEPS,
                      f"{name}: {kern} {launches.get(kern, 0)} in "
                      f"{MBN_STEPS} steps, expected {13 * MBN_STEPS}")
            arms[name] = (net, scores, ms, launches)
        ref, ref_scores, _, ref_launches = arms["unmeshed"]
        for name in ("meshed", "meshed_again", "unmeshed_again"):
            net, scores, _, launches = arms[name]
            check(scores == ref_scores, f"{name} scores {scores} != "
                  f"{ref_scores}")
            check(launches == ref_launches, f"{name} launched {launches}, "
                  f"the unmeshed step {ref_launches}")
            for tree in ("params", "state", "opt_state"):
                check(_bits_equal(getattr(net, tree), getattr(ref, tree)),
                      f"{name}: {tree} differ from the unmeshed captured "
                      f"step's")
        replay = {n: statistics.median(arms[n][2][multistep.WARMUP_STEPS
                                                  + 1:]) for n in arms}
        del arms, ref, net
    finally:
        distributed.shutdown()
    phase("graph_tensor_parallel", arm="a_mesh_1rank_nccl",
          mesh=json.dumps({"data": 1, "model": 1}),
          model=f"resnet50(classes={MBN_CLASSES},{MBN_IMG}x{MBN_IMG},BF16,"
          f"Nesterovs({MBN_LR},0.9),DL4J_TPU_FUSE_BLOCKS=1)", b=GTP_A_B,
          steps=MBN_STEPS, bit_equal=True, captures=1,
          k4_k7_sm90_calls_per_step=13,
          step_ms_meshed=f"{statistics.mean([replay['meshed'], replay['meshed_again']]):.4f}",
          step_ms_unmeshed=f"{statistics.mean([replay['unmeshed'], replay['unmeshed_again']]):.4f}",
          card=card)

    # (b) two ranks on the one card over gloo, {"model": 2}, eager F32
    root = tempfile.mkdtemp(prefix="graph_tp_")
    ck_dir = os.path.join(root, "ck", f"step_{GTP_STEPS}")
    procs = spawn_ranks("gtp_rank", 2, root, ck_dir)
    try:
        gc.collect()
        data = mbn_batches(GTP_STEPS + 1, GTP_B, SEED + 2302)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        registry.reset_launches()
        one, one_scores, one_ms, one_v1 = gtp_one_process(data[:GTP_STEPS])
        one_peak = torch.cuda.max_memory_allocated() - base
        one_launches = registry.launches()
        ref = {f"{k}/{p}": v.detach().cpu().clone()
               for k, sub in one.params.items() for p, v in sub.items()}
        ref_state = {f"{k}/{p}": v.detach().cpu().clone()
                     for k, sub in one.state.items() for p, v in sub.items()}
        one_cont = float(one.fit_batch(data[GTP_STEPS]))
        del one
        chaos_v, chaos_s = 0.0, [0.0] * GTP_STEPS
        for k in range(GTP_CHAOS_RUNS):
            _, p_scores, _, p_v1 = gtp_one_process(
                data[:GTP_STEPS], perm_seed=SEED + 2303 + k)
            chaos_v = max(chaos_v, max(gtp_velocity_err(p_v1,
                                                        one_v1).values()))
            chaos_s = [max(c, abs(a - b) / abs(b)) for c, a, b in
                       zip(chaos_s, p_scores, one_scores)]
        res = collect_ranks(procs, root, "graph_tensor_parallel")
        p0 = torch.load(os.path.join(root, "rank0.pt"))
        p1 = torch.load(os.path.join(root, "rank1.pt"))
        check(all(torch.equal(p0["whole"][k], p1["whole"][k])
                  for k in p0["whole"]), "the ranks' gathered parameters "
              "differ")
        replicated = [k for k in p0["local"]
                      if p0["local"][k].shape == p0["whole"][k].shape]
        check(all(torch.equal(p0["local"][k], p1["local"][k])
                  for k in replicated), "a replicated leaf differs between "
              "the ranks")
        check(all(torch.equal(p0["state"][k], p1["state"][k])
                  for k in p0["state"]), "the ranks' BN state differs")
        check(res[0]["scores"] == res[1]["scores"], "the ranks' scores "
              "differ")
        check(len(res[0]["scores"]) == len(one_scores) == GTP_STEPS,
              f"scores {res[0]['scores']}")
        s_err = [abs(a - b) / abs(b)
                 for a, b in zip(res[0]["scores"], one_scores)]
        s_bound = [GTP_SCORE_RTOL] + [
            max(GTP_GRAD_RTOL, MBN_CHAOS_FACTOR * c + MBN_CHAOS_FLOOR)
            for c in chaos_s[1:]]
        check(all(e <= b for e, b in zip(s_err, s_bound)), f"scores "
              f"{res[0]['scores']} vs one process {one_scores}: relative "
              f"{s_err} > {s_bound} (permuted runs {chaos_s})")
        v_err = gtp_velocity_err(p0["v1"], one_v1)
        worst = max(v_err, key=v_err.get)
        v_bound = max(GTP_GRAD_RTOL, MBN_CHAOS_FACTOR * chaos_v
                      + MBN_CHAOS_FLOOR)
        check(v_err[worst] <= v_bound, f"first step's gradient (Nesterov "
              f"velocity) vs one process: {worst} {v_err[worst]:.3e} > "
              f"{v_bound:.3e} (permuted runs {chaos_v:.3e})")
        over_1e4 = sorted(k for k, e in v_err.items() if e > GTP_GRAD_RTOL)
        params_max = max(float((p0["whole"][k].double() - ref[k].double())
                               .abs().max()) for k in ref)
        state_max = max(float((p0["state"][k].double()
                                - ref_state[k].double()).abs().max())
                        for k in ref_state)
        tails = {(M, K, N) for _, M, K, N in res[0]["shapes"]}
        for r in res:
            check(r["routes"] == {}, f"a rank's gather routes {r['routes']}")
            per_step = r["shapes"]
            for kern in kernels:
                got = [(M, K, N) for k, M, K, N in per_step if k == kern]
                check(len(got) == 13, f"a rank called {kern} {len(got)} "
                      f"times in a step, expected 13")
            full = {(M, K, 2 * N) for _, M, K, N in per_step}
            want = {(GTP_B * s * s, K, N) for s, K, N in
                    ((4, 128, 512), (2, 256, 1024), (1, 512, 2048))}
            check(full == want, f"K4-K7 launch shapes (M, K, 2 x N) {full},"
                  f" expected the tails' N/2 shards of {want}")
            check(r["calls_total"] == 13 * 4 * GTP_STEPS, f"K4-K7 calls "
                  f"{r['calls_total']} in {GTP_STEPS} steps")
            for kern in kernels:
                check(r["launches"].get(kern, 0) > 0 and one_launches.get(
                    kern, 0) > 0, f"{kern}: device launches "
                      f"{r['launches'].get(kern)}, one process "
                      f"{one_launches.get(kern)}")
        # (d) the checkpoint restored unmeshed in this process
        back = tck.restore_computation_graph(ck_dir)
        check(tuple(back.params["s1b0_c_conv"]["W"].shape)
              == (1, 1, 128, 512), "the checkpoint does not hold whole "
              "arrays")
        unmeshed = float(back.fit_batch(data[GTP_STEPS]))
        del back
        nxt = {"continued": res[0]["cont"], "restored_mesh": res[0]["rest"],
               "restored_unmeshed": unmeshed}
        check(all(abs(v - res[0]["cont"]) <= GTP_NEXT_RTOL
                  * abs(res[0]["cont"]) for v in nxt.values()),
              f"(d) next step's score {nxt}")
        check(tuple(res[0]["restored_shard"]) == (1, 1, 128, 256),
              f"restored onto the mesh: shard {res[0]['restored_shard']}")
        nxt["one_process"] = one_cont
    finally:
        stop_ranks(procs)
        shutil.rmtree(root, ignore_errors=True)
    phase("graph_tensor_parallel", arm="b_two_ranks_gloo", backend="gloo",
          mesh=json.dumps({"model": 2}), policy="F32", b=GTP_B,
          steps=GTP_STEPS, replicated_and_bn_state_bit_equal=True,
          scores=json.dumps([round(x, 7) for x in res[0]["scores"]]),
          one_process_scores=json.dumps([round(x, 7) for x in one_scores]),
          score_rel_err=json.dumps([float(f"{e:.3e}") for e in s_err]),
          score_bounds=json.dumps([float(f"{b:.3e}") for b in s_bound]),
          permuted_score_rel=json.dumps([float(f"{c:.3e}")
                                         for c in chaos_s]),
          step1_grad_rel_err=f"{v_err[worst]:.2e}",
          step1_grad_worst_leaf=worst, step1_grad_bound=f"{v_bound:.2e}",
          step1_grad_permuted_max=f"{chaos_v:.2e}",
          leaves_over_1e4=len(over_1e4), leaves=len(v_err),
          params_vs_one_process_max_abs=f"{params_max:.3e}",
          bn_state_vs_one_process_max_abs=f"{state_max:.3e}",
          k4_k7_calls_per_step=13,
          k4_k7_shapes_mkn=json.dumps(sorted(tails)),
          collectives_per_step=res[0]["collectives_per_step"],
          collective_mb_per_step=f"{res[0]['bytes_per_step'] / 1e6:.2f}",
          collective_ms_per_step=json.dumps(
              [round(r["collective_ms_per_step"], 2) for r in res]),
          step_ms_ranks=json.dumps([[round(x, 2) for x in r["step_ms"]]
                                    for r in res]),
          step_ms_one_process=json.dumps([round(x, 2) for x in one_ms]),
          peak_mb_ranks=json.dumps([round(r["peak_bytes"] / 2**20, 1)
                                    for r in res]),
          peak_mb_one_process=f"{one_peak / 2**20:.1f}", card=card)
    phase("graph_tensor_parallel", arm="d_checkpoint", saved_at="model=2",
          next_scores=json.dumps({k: round(v, 7) for k, v in nxt.items()}),
          rtol=GTP_NEXT_RTOL, whole_arrays=True,
          restored_shard=json.dumps(res[0]["restored_shard"]))
    gtp_column_shards(card)
    phase("graph_tensor_parallel", arm="done",
          phase_s=f"{time.perf_counter() - t_phase:.1f}")


def gtp_column_shards(card):
    """(c): each tail's (M, K, N/2) at (a)'s batch, bf16, through K4-K7's
    sm90 path against their plain versions under [fused_vs_plain]'s
    limits, with the time, the plain version's time and the bound."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_block as fb
    from deeplearning4j_tpu_torch.ops import registry
    counts = {}
    for s, K, N, tails in ((4, 128, 512, 4), (2, 256, 1024, 6),
                           (1, 512, 2048, 3)):
        counts[(GTP_A_B * s * s, K, N // 2)] = tails
    registry.reset_launches()
    for (M, K, N), tails in counts.items():
        t = tail_inputs(M, K, N, torch.bfloat16, seed=2)
        p = tail_plain(t, True)
        limits = sum_limits(t, p, True)
        args = fused_args(t, p, True)
        names = {fb.STATS: ("s1", "s2"), fb.APPLY: ("y",),
                 fb.BWD_STATS: ("a", "b"),
                 fb.BWD_APPLY: ("dx", "dW", "dshortcut")}
        row = {}
        with torch.no_grad():
            for kern, a in args.items():
                check(kernel_path(kern, a) == "sm90", f"{kern} at "
                      f"({M},{K},{N}) takes {kernel_path(kern, a)}")
                cuda_fn = registry.get(kern, "cuda")
                got = cuda_fn(*a)
                want = registry.get(kern, "cpu")(*a)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                worst = 0.0
                for nm, g, w in zip(names[kern], got, want):
                    err = float((g.float() - w.float()).abs().max())
                    lim = (limits[nm][0] if nm in limits
                           else bf16_tol(w.float()))
                    check(err <= lim, f"{kern} {nm} at ({M},{K},{N}) bf16: "
                          f"{err:.3e} > {lim:.3e}")
                    worst = max(worst, err / lim) if lim else worst
                ms = cuda_ms_per_launch(lambda: cuda_fn(*a), reps=5)
                plain_fn = registry.get(kern, "cpu")
                plain_ms = cuda_ms_per_launch(lambda: plain_fn(*a), reps=3,
                                              inner=5)
                flops, nbytes = fused_bound(kern, M, K, N)
                bound_ms, bound_by = bound(flops, nbytes, "bfloat16")
                row[kern] = {"ms": round(ms, 5),
                             "plain_ms": round(plain_ms, 5),
                             "bound_ms": round(bound_ms, 6),
                             "bound_by": bound_by,
                             "worst_err_over_limit": round(worst, 4)}
        phase("graph_tensor_parallel", arm="c_column_shards", M=M, K=K,
              N_shard=N, N_whole=2 * N, tails=tails, dtype="bfloat16",
              path="sm90", rows=json.dumps(row), card=json.dumps(card))
        del t, p, args
    launched = registry.launches()
    for kern in (fb.STATS, fb.APPLY, fb.BWD_STATS, fb.BWD_APPLY):
        check(launched.get(fb.SM90_COUNTER[kern], 0) > 0,
              f"(c): {kern} never counted on its sm90 path")


# ------------------------------------------------------- mesh serving
# [mesh_serving] (ROADMAP A.5 part 2, the serving half): two gloo ranks
# sharing the card on {"model": 2}; rank 0 serves HTTP, driven from this
# process. zoo.mnist_mlp at its zoo widths (the JAX test's bucket slices)
# and zoo.vgg16 at 224 x 224 x 3, 1000 classes (buckets of 1 and 4 rows),
# F32. Each reply is held bit for bit against the unmeshed net.output of
# the same padded bucket on the card (what an unmeshed server replies).
# Since ROADMAP C.7's repair a served dense layer's F32 inference product
# runs on S1 (ops/stream_exact.py dense_route), whose sums over K run in
# one order whatever the output width: the probe below runs each layer's
# column shards through the layer's own route and must find 0
# differences; ms_s1_columns holds S1's columns at every served shape.
MS_MLP_SLICES = ((0, 1), (1, 4), (4, 11), (11, 40))
MS_VGG_ROWS = (1, 4)
MS_REPS = 5
MS_TIMEOUT_S = 120.0
# S1's column invariance at the served dense shapes: mnist_mlp's layers
# at 1/3/7/29 rows, VGG-16's fc1-fc3 at 1-4 rows
MS_S1_SHAPES = {"mnist_mlp": ((784, 256), (256, 128), (128, 10)),
                "vgg16": ((25088, 4096), (4096, 4096), (4096, 1000))}
MS_S1_ROWS = {"mnist_mlp": (1, 3, 7, 29), "vgg16": (1, 2, 3, 4)}


def ms_nets(which):
    from deeplearning4j_tpu_torch import zoo
    if which == "mlp":
        return zoo.mnist_mlp(seed=SEED + 2310, dtype=zoo.F32)
    return zoo.vgg16(seed=SEED + 2311, n_classes=1000, image_size=224,
                     dtype=zoo.F32)


def ms_rank(port, rank, root):
    """One rank of [mesh_serving]: the meshed server over mnist_mlp, then
    VGG-16 (the leader writes its url and waits for this process's done
    file, the follower waits in its loop), the refusals, and a leader
    that dies with its follower in the loop."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.parallel import distributed as D
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.serving.server import ModelServer
    os.environ["DL4J_TPU_COLLECTIVE_TIMEOUT_S"] = str(MS_TIMEOUT_S)
    D.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    mesh = make_mesh({"model": 2})
    res = {}
    try:
        for which in ("mlp", "vgg"):
            net = ms_nets(which)
            server = ModelServer(net, port=0, max_batch=32, mesh=mesh,
                                 warmup=which == "mlp")
            grp = server._group
            fwd, mg = grp.forward, grp.forward.model_group
            log = []

            def logged(feats, _fwd=fwd, _mg=mg, _log=log):
                s0, t0 = _mg.seconds, time.perf_counter()
                out = _fwd(feats)
                torch.cuda.synchronize()
                _log.append((int(np.shape(feats[0])[0]),
                             time.perf_counter() - t0, _mg.seconds - s0))
                return out
            grp.forward = logged
            server.start()
            if server.is_follower:
                stopped = server.wait(timeout=MS_TIMEOUT_S * 4)
                res[which] = {"stopped": stopped, "log": log}
            else:
                with open(os.path.join(root, f"url_{which}"), "w") as f:
                    f.write(server.url)
                done = os.path.join(root, f"done_{which}")
                t_end = time.monotonic() + 900
                while not os.path.exists(done):
                    check(time.monotonic() < t_end, f"no {done}")
                    time.sleep(0.05)
                res[which] = {"log": log, "gathers": mg.calls,
                              "specs": {k: {p: list(s) for p, s in v.items()}
                                        for k, v in
                                        fwd.specs.items()}}
                server.stop()
            if which == "mlp":
                res["refusals"] = ms_refusals(server, net, mesh)
            del net, server, grp, fwd
            torch.cuda.empty_cache()
        # the leader dies with its follower in the loop
        net = ms_nets("mlp")
        server = ModelServer(net, port=0, max_batch=8, mesh=mesh).start()
        if not server.is_follower:
            server.predict(np.zeros((1, 784), np.float32))
            with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
                json.dump(res, f)
            os._exit(0)
        t0 = time.monotonic()
        try:
            server.wait(timeout=MS_TIMEOUT_S * 2)
            res["lost"] = ["none", time.monotonic() - t0, ""]
        except Exception as e:  # what the follower raised, by type
            res["lost"] = [type(e).__name__, time.monotonic() - t0,
                           f"{getattr(e, 'lost_ranks', None)} {e}"[:400]]
    finally:
        if rank != 0:
            with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
                json.dump(res, f)
    os._exit(0)


def ms_refusals(server, net, mesh):
    """The JAX package's refusals on the card: a graph, compute_dtype=,
    hot_swap on a meshed server; (type, message) of each."""
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.serving.server import ModelServer
    out = {}
    graph = zoo.resnet18(seed=SEED, dtype=zoo.F32)
    for name, fn in (
            ("graph", lambda: ModelServer(graph, port=0, mesh=mesh)),
            ("compute_dtype", lambda: ModelServer(
                net, port=0, mesh=mesh, compute_dtype="bfloat16")),
            ("hot_swap", lambda: server.hot_swap(net=net))):
        try:
            fn()
            out[name] = None
        except Exception as e:
            out[name] = [type(e).__name__, str(e)[:200]]
    return out


def ms_probe(net, rows_list):
    """For each served layer with a column-sharded weight, at each bucket
    size: the largest difference between this rank's shard's product and
    the whole product's columns on the card, each through the layer's own
    inference route (S1 for dense layers, cuDNN for convolutions), on
    seeded inputs of the layer's input shape, and the dense route's
    count (a dense product off S1 fails the phase)."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.parallel.inference import (
        serving_param_specs)
    specs = serving_param_specs(net.params, {"model": 2}, "model",
                                layers=net.layers)
    rng = np.random.default_rng(SEED + 2312)
    out = []
    for layer in net.layers:
        ps = net.params.get(layer.name, {})
        sharded = specs.get(layer.name, {}).get("W", ())
        if "W" not in ps or not sharded or sharded[-1] != "model":
            continue
        W = ps["W"]
        it = layer.input_type
        x_shape = ((W.shape[0],) if W.dim() == 2
                   else (it.height, it.width, it.channels))
        n = W.shape[-1] // 2
        for rows in rows_list:
            x = torch.from_numpy(rng.normal(size=(rows,) + x_shape)
                                 .astype(np.float32)).cuda()
            registry.reset_launches()
            with torch.inference_mode():
                whole = layer.apply({"W": W}, {}, x)[0]
                halves = [layer.apply({"W": W[..., h * n:(h + 1) * n]
                                       .contiguous()}, {}, x)[0]
                          for h in range(2)]
            torch.cuda.synchronize()
            routed = registry.launches().get("dense:route[stream]", 0)
            if W.dim() == 2:
                check(routed == 3, f"[mesh_serving] {layer.name}: "
                      f"{routed} of 3 dense products on S1's route")
            diff = max(float((halves[h] - whole[..., h * n:(h + 1) * n])
                             .abs().max()) for h in range(2))
            out.append({"layer": layer.name, "type": layer.conf.layer_type,
                        "W": list(W.shape), "rows": rows,
                        "route": "stream" if W.dim() == 2 else "cudnn",
                        "max_abs_diff": diff})
    return out


def ms_s1_columns(card):
    """S1 at every served dense shape: stream_dense(x, W)[:, a:b] against
    stream_dense(x, W[:, a:b]) bit for bit, for the two halves (the
    shards) and a ragged slice; S1's time whole and on a half beside
    addmm's (the library's product of the same function, the route S1
    replaced), by CUDA events; the bound at the card's f32 peak and its
    bytes. Returns the rows."""
    import torch
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    g = torch.Generator(device="cuda").manual_seed(SEED + 2314)
    rows_out = []
    for model, shapes in MS_S1_SHAPES.items():
        for f, n in shapes:
            W = torch.randn(f, n, generator=g, device="cuda") * f ** -0.5
            b = torch.randn(n, generator=g, device="cuda") * 0.1
            cuts = ((0, n // 2), (n // 2, n), (3, n - 5))
            Wc = {c: W[:, c[0]:c[1]].contiguous() for c in cuts}
            bc = {c: b[c[0]:c[1]].contiguous() for c in cuts}
            for rows in MS_S1_ROWS[model]:
                x = torch.randn(rows, f, generator=g, device="cuda")
                with torch.inference_mode():
                    whole = se.stream_dense(x, W, b)
                    bits = all(torch.equal(se.stream_dense(x, Wc[c], bc[c]),
                                           whole[:, c[0]:c[1]])
                               for c in cuts)
                    half = cuts[0]
                    ms = device_ms_per_call(
                        lambda: se.stream_dense(x, W, b), reps=20)[0]
                    half_ms = device_ms_per_call(
                        lambda: se.stream_dense(x, Wc[half], bc[half]),
                        reps=20)[0]
                    lib_ms = device_ms_per_call(
                        lambda: torch.addmm(b, x, W), reps=20)[0]
                    lib_half_ms = device_ms_per_call(
                        lambda: torch.addmm(bc[half], x, Wc[half]),
                        reps=20)[0]
                check(bits, f"[mesh_serving] S1 at {model} [{rows}, {f}] x "
                      f"[{f}, {n}]: a column slice's product differs from "
                      f"the whole product's columns")
                flops = se.dense_flops(rows, f, n)
                nbytes = 4 * (rows * f + f * n + n + rows * n)
                bound_ms, bound_by = bound(flops, nbytes, "float32")
                rows_out.append({
                    "model": model, "rows": rows, "f": f, "g": n,
                    "columns_bit_equal": bits, "s1_ms": round(ms, 5),
                    "s1_half_ms": round(half_ms, 5),
                    "addmm_ms": round(lib_ms, 5),
                    "addmm_half_ms": round(lib_half_ms, 5),
                    "bound_ms": round(bound_ms, 6), "bound_by": bound_by})
            del W, Wc
    phase("mesh_serving", arm="s1_columns", device_method=DEVICE_METHOD,
          shapes=json.dumps(rows_out), card=json.dumps(card))
    return rows_out


# S1's cost past the served buckets: F32 dense products at an evaluate's
# and a training batch's row counts, and the unmeshed F32 net.output of
# both served models with its dense layers on S1 (the route) and on
# torch.matmul (the route forced back, as before ROADMAP C.7's repair)
MS_COST_ROWS = (256, 4096)
MS_COST_SHAPES = ((784, 256), (256, 128), (128, 10), (25088, 4096))
MS_COST_OUTPUT_ROWS = {"mlp": (256, 4096), "vgg": (4, 32)}
MS_COST_REPS = 5


def ms_dense_cost(card):
    """S1 against addmm at MS_COST_ROWS rows (device ms by CUDA events),
    and net.output's host ms (the card synchronized) with the dense route
    on S1 and forced onto torch.matmul, taken S1, matmul, matmul, S1; the
    outputs of the two routes compared. Returns the rows."""
    import torch
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    g = torch.Generator(device="cuda").manual_seed(SEED + 2315)
    products = []
    for f, n in MS_COST_SHAPES:
        W = torch.randn(f, n, generator=g, device="cuda") * f ** -0.5
        b = torch.randn(n, generator=g, device="cuda") * 0.1
        for rows in MS_COST_ROWS:
            x = torch.randn(rows, f, generator=g, device="cuda")
            reps = 3 if f * n * rows > 2 ** 34 else 20
            with torch.inference_mode():
                ms = device_ms_per_call(lambda: se.stream_dense(x, W, b),
                                        reps=reps)[0]
                lib_ms = device_ms_per_call(lambda: torch.addmm(b, x, W),
                                            reps=reps)[0]
            bound_ms, bound_by = bound(se.dense_flops(rows, f, n),
                                       4 * (rows * f + f * n + n + rows * n),
                                       "float32")
            products.append({"rows": rows, "f": f, "g": n,
                             "s1_ms": round(ms, 5),
                             "addmm_ms": round(lib_ms, 5),
                             "s1_over_addmm": round(ms / lib_ms, 3),
                             "bound_ms": round(bound_ms, 6),
                             "bound_by": bound_by})
        del W
    outputs = []
    plain_route = se.dense_route
    try:
        for which, row_list in MS_COST_OUTPUT_ROWS.items():
            net = ms_nets(which)
            shape = (784,) if which == "mlp" else (224, 224, 3)
            for rows in row_list:
                x = torch.randn((rows,) + shape, generator=g, device="cuda")
                times = {"stream": [], "matmul": []}
                outs = {}
                for route in ("stream", "matmul", "matmul", "stream"):
                    se.dense_route = (plain_route if route == "stream"
                                      else lambda *a: "matmul")
                    outs[route] = net.output(x)
                    for _ in range(MS_COST_REPS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        net.output(x)
                        torch.cuda.synchronize()
                        times[route].append((time.perf_counter() - t0) * 1e3)
                se.dense_route = plain_route
                med = {k: statistics.median(v) for k, v in times.items()}
                outputs.append({
                    "model": which, "rows": rows,
                    "output_ms_s1": round(med["stream"], 3),
                    "output_ms_matmul": round(med["matmul"], 3),
                    "s1_over_matmul": round(med["stream"] / med["matmul"],
                                            3),
                    "max_abs_s1_vs_matmul": float(
                        (outs["stream"] - outs["matmul"]).abs().max())})
            del net
            torch.cuda.empty_cache()
    finally:
        se.dense_route = plain_route
    phase("mesh_serving", arm="s1_cost", device_method=DEVICE_METHOD,
          products=json.dumps(products), net_output=json.dumps(outputs),
          card=json.dumps(card))
    return products, outputs


def _ms_post(url, rows):
    import urllib.request
    body = json.dumps({"features": rows.tolist()}).encode()
    req = urllib.request.Request(url + "/predict", data=body,
                                 headers={"Content-Type":
                                          "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        out = np.asarray(json.loads(r.read())["predictions"], np.float32)
    return out, (time.perf_counter() - t0) * 1e3


def phase_mesh_serving(card=None):
    """[mesh_serving]: the two models through the meshed server, each
    bucket's replies against the unmeshed output on the card, the probe,
    the refusals and the lost leader."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.serving.batcher import next_bucket

    t_phase = time.perf_counter()
    ms_dense_cost(card)     # before the ranks start: alone on the card
    root = tempfile.mkdtemp(prefix="mesh_serving_")
    procs = spawn_ranks("ms_rank", 2, root)
    try:
        rng = np.random.default_rng(SEED + 2313)
        inputs = {"mlp": rng.normal(size=(40, 784)).astype(np.float32),
                  "vgg": rng.normal(0.0, 50.0, size=(4, 224, 224, 3))
                  .astype(np.float32)}
        slices = {"mlp": MS_MLP_SLICES,
                  "vgg": tuple((0, n) for n in MS_VGG_ROWS)}
        report = {}
        ms_s1_columns(card)     # while the ranks start
        for which in ("mlp", "vgg"):
            net = ms_nets(which)
            x = inputs[which]
            buckets = sorted({next_bucket(hi - lo, 32, 2)
                              for lo, hi in slices[which]})
            probe = ms_probe(net, buckets)
            differs = [p for p in probe if p["max_abs_diff"] > 0]
            check(not differs, f"[mesh_serving] {which}: a column shard's "
                  f"product differs from the whole product's columns "
                  f"through the layer's route: {differs}")
            whole40 = net.output(torch.from_numpy(x).cuda()).float().cpu() \
                .numpy()
            url_file = os.path.join(root, f"url_{which}")
            t_end = time.monotonic() + 600
            while not os.path.exists(url_file):
                check(time.monotonic() < t_end and all(
                    p.poll() is None for p, _ in procs),
                    f"[mesh_serving] no leader url for {which}")
                time.sleep(0.05)
            url = open(url_file).read()
            rows = []
            for lo, hi in slices[which]:
                n = hi - lo
                b = next_bucket(n, 32, 2)
                pad = np.zeros((b,) + x.shape[1:], np.float32)
                pad[:n] = x[lo:hi]
                want = net.output(torch.from_numpy(pad).cuda()).float() \
                    .cpu().numpy()[:n]
                times, got = [], None
                for _ in range(MS_REPS):
                    got, ms = _ms_post(url, x[lo:hi])
                    times.append(ms)
                bits = bool(np.array_equal(got, want))
                rel = float(np.abs(got - want).max()
                            / max(float(np.abs(want).max()), 1e-30))
                check(bits, f"{which} rows {lo}:{hi} differ from the "
                      f"unmeshed output ({rel:.3e} relative)")
                p50 = statistics.median(times)
                rows.append({"rows": n, "bucket": b, "bit_equal": bits,
                             "rel_err": rel, "p50_ms": round(p50, 3),
                             "rows_per_s": round(n / p50 * 1e3, 2),
                             "equal_to_whole_batch_output": bool(
                                 np.array_equal(got, whole40[lo:hi]))})
            open(os.path.join(root, f"done_{which}"), "w").write("1")
            report[which] = {"rows": rows, "probe": probe,
                             "probe_differs": differs}
            del net
            torch.cuda.empty_cache()
        res = collect_ranks(procs, root, "mesh_serving", timeout_s=900)
    finally:
        stop_ranks(procs)
        shutil.rmtree(root, ignore_errors=True)
    lead, follow = res
    for which in ("mlp", "vgg"):
        check(follow[which]["stopped"], f"{which}: the follower did not "
              f"end on the leader's stop")
        check([e[0] for e in lead[which]["log"]]
              == [e[0] for e in follow[which]["log"]],
              f"{which}: the ranks ran other buckets")
        gather_ms = {}
        for n_rows, fwd_s, gather_s in lead[which]["log"]:
            gather_ms.setdefault(n_rows, []).append(
                (fwd_s * 1e3, gather_s * 1e3))
        for row in report[which]["rows"]:
            g = gather_ms.get(row["bucket"], [])
            row["forward_ms_p50"] = round(statistics.median(
                [a for a, _ in g]), 3) if g else None
            row["gather_ms_p50"] = round(statistics.median(
                [b for _, b in g]), 3) if g else None
        phase("mesh_serving", model=which, backend="gloo",
              mesh=json.dumps({"model": 2}), policy="F32",
              buckets=json.dumps(report[which]["rows"]),
              probe_max_abs_diff=json.dumps(
                  {f"{p['layer']}@{p['rows']}": p["max_abs_diff"]
                   for p in report[which]["probe"]}),
              probe_bit_equal=not report[which]["probe_differs"],
              probe_differing_pairs=len(report[which]["probe_differs"]),
              rows_held_to="bits",
              sharded_layers=json.dumps(sorted(
                  k for k, v in lead[which]["specs"].items()
                  if any(s and s[-1] == "model" for s in v.values()))),
              card=card)
    ref = lead["refusals"]
    for name, text in (("graph", "serve ComputationGraph models "
                        "replicated"), ("compute_dtype", "bit-identity"),
                       ("hot_swap", "mesh serving shards params")):
        got = ref.get(name)
        check(got is not None and got[0] == "ValueError" and text in got[1],
              f"refusal {name}: {got}")
    kind, waited, msg = follow["lost"]
    check(kind in ("CollectiveTimeoutError", "PeerLostError"),
          f"a follower whose leader died: {follow['lost']}")
    check(waited <= MS_TIMEOUT_S, f"the follower raised after {waited:.1f} "
          f"s, past its timeout {MS_TIMEOUT_S}")
    phase("mesh_serving", arm="refusals_and_lost_leader",
          refusals=json.dumps({k: v[0] for k, v in ref.items()}),
          follower_error=kind, follower_raised_after_s=f"{waited:.3f}",
          timeout_s=MS_TIMEOUT_S, follower_message=json.dumps(msg[:160]),
          phase_s=f"{time.perf_counter() - t_phase:.1f}")


# ------------------------------------- A.5 parts 3-4: pipeline, sequence,
# expert parallelism and decode on a model axis
def timed_exchange():
    """Wraps parallel/mesh.py's hop exchange to time each call on the host
    clock (the card synchronized before and after): returns the list the
    times (ms) go to."""
    import torch
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh
    inner, times = pmesh._exchange, []

    def timed(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    pmesh._exchange = timed
    return times


def peak_mb(fn):
    """(fn(), MB the card's allocator peaked above its level at the
    call)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


# [sequence_parallel]: char-RNN's first GravesLSTM at full width (n_in 80,
# n 512) over {"seq": 2} on two gloo ranks sharing the card, b = 32, one
# step (forward and backward) at each T, BF16 on K1/K2's cluster route;
# an F32 forward at T = 64 against one process's whole-T lstm_sequence
SP_B, SP_N, SP_TS, SP_REPS = 32, 512, (64, 1024), 3
# the BF16 arm against one process's whole-T forward: the carry (h, c)
# crosses the ranks in bf16, as the JAX package's ppermute carries it,
# where one process's K1 keeps c in f32 between steps; one rounding of c
# (2**-9 relative) at the chunk boundary moves the later h by about as
# much, a few bf16 ulps of |y| <= 1 after the roundings K1 makes anyway:
# 4 ulps at 1, 2**-6
SP_BF16_TOL = 2 ** -6
# every leaf's gradient on a rank (its chunk's K2, the cotangents handed
# back through the hops, the flat all-reduce of the replicated leaves)
# against one process's whole-T gradient, relative L2: the bf16 carry
# moves dWh 3.0-3.2e-3; a rank that lost the other rank's share of a
# gradient, or the cotangent of a hop, is off by that share, which the
# loss's terms on every step of both chunks keep of the order of 1
SP_GRAD_RTOL = 2e-2


def sp_rank(port, rank, root):
    """One rank of [sequence_parallel]: the F32 forward arm, then for each
    T the BF16 step on this rank's time chunk beside one process's
    whole-T step (this process, after its ranks' step), K1/K2's launches
    counted around the sharded step, each hop timed, peak memory read."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.parallel import distributed as D
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.parallel.sequence import (
        sequence_parallel_lstm, shard_sequence)
    D.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                 timeout_s=300)
    res = {}
    try:
        mesh = make_mesh({"seq": 2})
        hops = timed_exchange()
        net = zoo.char_rnn(seed=SEED + 2400, dtype=zoo.F32)
        params = net.params["layer_0"]
        rng = np.random.default_rng(SEED + 2401)

        def chars(T):
            return np.eye(DEC_V, dtype=np.float32)[
                rng.integers(0, DEC_V, (SP_B, T))]

        def whole(p, x, h0, c0):
            xz = (torch.matmul(x, p["Wx"]) + p["b"]).transpose(0, 1) \
                .contiguous()
            out = lstm_ops.lstm_sequence(xz, h0, c0, p["Wh"], p["p"])
            return out.y.transpose(0, 1), out.hT, out.cT

        # F32: the sharded forward against one process's, on the chunk's
        # own projection (the recurrence alone) and on the whole one
        x = torch.from_numpy(chars(64)).cuda()
        zeros = torch.zeros(SP_B, SP_N, device="cuda")
        with torch.no_grad():
            y, hT, cT = sequence_parallel_lstm(
                mesh, "seq", params, shard_sequence(mesh, "seq", x),
                zeros, zeros)
            wy, whT, wcT = whole(params, x, zeros, zeros)
            k = 64 // 2
            # the chunks' own projections, the carry handed on in f32
            h, c, ys = zeros, zeros, []
            for s in range(2):
                ys_s, h, c = whole(params, x[:, s * k:(s + 1) * k], h, c)
                ys.append(ys_s)
        torch.cuda.synchronize()
        mine = slice(rank * k, (rank + 1) * k)
        res["f32"] = {
            "route": lstm_ops.kernel_route(torch.float32, SP_N),
            "bits_chunk_projection": bool(torch.equal(y, ys[rank]))
            and bool(torch.equal(hT, h)) and bool(torch.equal(cT, c)),
            "bits_whole_projection": bool(torch.equal(y, wy[:, mine]))
            and bool(torch.equal(hT, whT)),
            "max_abs_whole_projection": max(
                float((y - wy[:, mine]).abs().max()),
                float((hT - whT).abs().max()))}

        bf = {k: v.to(torch.bfloat16).detach() for k, v in params.items()}
        for T in SP_TS:
            x = torch.from_numpy(chars(T)).cuda().to(torch.bfloat16)
            h0 = torch.zeros(SP_B, SP_N, device="cuda",
                             dtype=torch.bfloat16)
            w = torch.from_numpy(rng.normal(size=(SP_B, T, SP_N))
                                 .astype(np.float32)).cuda()
            xl = shard_sequence(mesh, "seq", x)
            wl = shard_sequence(mesh, "seq", w)

            def sharded():
                p = {k: v.clone().requires_grad_() for k, v in bf.items()}
                y, hT, cT = sequence_parallel_lstm(mesh, "seq", p, xl, h0,
                                                   h0)
                loss = (y.float() * wl).sum() + hT.float().sum()
                loss.backward()
                return y.detach(), hT.detach(), {k: v.grad
                                                 for k, v in p.items()}

            def one():
                p = {k: v.clone().requires_grad_() for k, v in bf.items()}
                y, hT, _ = whole(p, x, h0, h0)
                loss = (y.float() * w).sum() + hT.float().sum()
                loss.backward()
                return y.detach(), hT.detach(), {k: v.grad
                                                 for k, v in p.items()}

            sharded()
            one()
            torch.cuda.synchronize()
            registry.reset_launches()
            del hops[:]
            (y, hT, grads), mb = peak_mb(sharded)
            launches = registry.launches()
            hop_ms = list(hops)
            ms = []
            for _ in range(SP_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sharded()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            (wy, whT, wgrads), one_mb = peak_mb(one)
            one_ms = []
            for _ in range(SP_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one()
                torch.cuda.synchronize()
                one_ms.append((time.perf_counter() - t0) * 1e3)
            k = T // 2
            mine = slice(rank * k, (rank + 1) * k)
            res[f"bf16_T{T}"] = {
                "launches": launches, "hop_ms": hop_ms,
                "step_ms": ms, "one_process_ms": one_ms,
                "peak_mb": mb, "one_process_peak_mb": one_mb,
                "max_abs_y": float((y.float() - wy[:, mine].float())
                                   .abs().max()),
                "max_abs_hT": float((hT.float() - whT.float()).abs().max()),
                "grad_rel_l2": {
                    k: float((g.float() - wgrads[k].float()).norm()
                             / wgrads[k].float().norm())
                    for k, g in grads.items()}}
    finally:
        rank_out(root, rank, res)
        D.shutdown()


def phase_sequence_parallel(card=None):
    """[sequence_parallel] (ROADMAP A.5 part 3): the rank children above,
    then the checks: the F32 forward bit-equal to one process's on the
    same projection (the chunks' K1 route is the whole run's: it depends
    on dtype and n only); the BF16 chunks within SP_BF16_TOL of one
    process's whole-T forward, every leaf's gradient within SP_GRAD_RTOL
    of one process's; K1 once and K2 once a rank a step, both on the
    cluster route."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="sequence_parallel_")
    try:
        res = collect_ranks(spawn_ranks("sp_rank", 2, root), root,
                            "sequence_parallel")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    f32 = [r["f32"] for r in res]
    check(all(f["bits_chunk_projection"] for f in f32),
          f"[sequence_parallel] F32 chunks differ from one process's "
          f"recurrence on the same projection: {f32}")
    phase("sequence_parallel", arm="f32_forward", T=64, b=SP_B,
          n_in=DEC_V, n=SP_N, mesh=json.dumps({"seq": 2}), backend="gloo",
          k1_route=f32[0]["route"],
          bit_equal_same_projection=True,
          bit_equal_whole_projection=all(f["bits_whole_projection"]
                                         for f in f32),
          max_abs_whole_projection=json.dumps(
              [f"{f['max_abs_whole_projection']:.3g}" for f in f32]),
          card=card)
    med = statistics.median
    for T in SP_TS:
        arms = [r[f"bf16_T{T}"] for r in res]
        for r, a in enumerate(arms):
            ln = a["launches"]
            check(ln.get("lstm_fwd") == 1 and ln.get("lstm_fwd_sm90") == 1
                  and ln.get("lstm_bwd_sm90") == 1
                  and ln.get("lstm_bwd") == 3,
                  f"[sequence_parallel] T={T} rank {r}: K1 and K2 once a "
                  f"step on the cluster route expected, launched {ln}")
            check(a["max_abs_y"] <= SP_BF16_TOL
                  and a["max_abs_hT"] <= SP_BF16_TOL,
                  f"[sequence_parallel] T={T} rank {r}: BF16 chunk vs one "
                  f"process y {a['max_abs_y']:.3g}, hT "
                  f"{a['max_abs_hT']:.3g} > {SP_BF16_TOL}")
            g = a["grad_rel_l2"]
            check(set(g) == {"Wx", "Wh", "b", "p"}
                  and max(g.values()) <= SP_GRAD_RTOL,
                  f"[sequence_parallel] T={T} rank {r}: gradients vs one "
                  f"process (relative L2) {g}, bound {SP_GRAD_RTOL}")
        phase("sequence_parallel", arm="bf16_step", T=T, b=SP_B,
              n_in=DEC_V, n=SP_N, policy="BF16", route="cluster",
              k1_launches_per_rank=1, k2_calls_per_rank=1,
              k2_device_launches_per_rank=3,
              max_abs_y=json.dumps([f"{a['max_abs_y']:.3g}" for a in arms]),
              max_abs_hT=json.dumps([f"{a['max_abs_hT']:.3g}"
                                     for a in arms]),
              bound=f"{SP_BF16_TOL:.4g}",
              grad_rel_l2_vs_one_process=json.dumps(
                  [{k: f"{v:.3g}" for k, v in a["grad_rel_l2"].items()}
                   for a in arms]),
              grad_bound=SP_GRAD_RTOL,
              step_ms_ranks=json.dumps([round(med(a["step_ms"]), 3)
                                        for a in arms]),
              step_ms_one_process=json.dumps(
                  [round(med(a["one_process_ms"]), 3) for a in arms]),
              hop_ms=json.dumps([[round(t, 3) for t in a["hop_ms"]]
                                 for a in arms]),
              hops_per_step_per_rank=len(arms[0]["hop_ms"]),
              peak_mb_ranks=json.dumps([round(a["peak_mb"], 1)
                                        for a in arms]),
              peak_mb_one_process=json.dumps(
                  [round(a["one_process_peak_mb"], 1) for a in arms]),
              card=card)
    phase("sequence_parallel", phase_s=f"{time.perf_counter() - t_phase:.1f}")


# [pipeline]: gpt_mini's four TransformerBlocks at full width (256, 4
# heads, T = 256) as four stages on {"pipe": 4} (four gloo ranks sharing
# the card), b = 32 as 16 microbatches of 2, F32 and BF16; one SGD step
PP_B, PP_MICRO, PP_LR = 32, 16, 0.1
# the SGD step against the blocks applied in turn in one process: the
# JAX test's bounds (tests/test_pipeline.py:83-84), params rtol and atol
PP_STEP_TOL = 1e-5
# the step's update (new - old params) against the update of the blocks
# in turn, relative L2 over each leaf: a stage whose params did not move
# reads 1 here, where PP_STEP_TOL alone may pass it when lr * grad is
# below 1e-5 (the phase reports what an unmoved stage reads there too)
PP_UPDATE_RTOL = 1e-3


def pp_rank(port, rank, root):
    """One rank (stage) of [pipeline]: for each policy the pipelined
    forward (K3 launches counted, each stage call and each hop timed),
    one SGD step, and on this process the blocks in turn over each
    microbatch (rank 0: the forward; every rank: its stage's step)."""
    import torch
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.parallel import distributed as D
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        pipeline_forward, pipeline_train_step, shard_stages,
        split_microbatches, stack_stage_params)
    D.initialize(f"127.0.0.1:{port}", 4, rank, backend="gloo",
                 timeout_s=300)
    res = {}
    try:
        mesh = make_mesh({"pipe": 4})
        hops = timed_exchange()
        for policy in ("F32", "BF16"):
            net = dec_net(policy, seed=SEED + 2410)
            block = net.layers[1]
            blocks = [net.params[f"layer_{i}"] for i in range(1, 5)]
            cd = block.compute_dtype
            rng = np.random.default_rng(SEED + 2411)
            x = torch.from_numpy(rng.normal(size=(PP_B, DEC_C, DEC_W))
                                 .astype(np.float32)).cuda().to(cd)
            lab = torch.from_numpy(rng.normal(size=(PP_B, DEC_C, DEC_W))
                                   .astype(np.float32)).cuda()
            xm = split_microbatches(x, PP_MICRO)
            lm = split_microbatches(lab, PP_MICRO)
            stage_ms = []

            def stage(p, h):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = block.apply(p, {}, h)[0]
                torch.cuda.synchronize()
                stage_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            def mse(y, l):
                return ((y.float() - l) ** 2).mean()

            mine = shard_stages(mesh, "pipe", stack_stage_params(blocks))
            # this rank's block alone, forward and backward on one
            # microbatch, twice: what a first backward costs off the
            # pipeline
            alone = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                leaf = {k: v.detach().requires_grad_()
                        for k, v in blocks[rank].items()}
                mse(block.apply(leaf, {}, xm[0])[0], lm[0]).backward()
                torch.cuda.synchronize()
                alone.append((time.perf_counter() - t0) * 1e3)
            with torch.no_grad():
                pipeline_forward(mesh, "pipe", mine, xm, stage)   # warm
                torch.cuda.synchronize()
                registry.reset_launches()
                del stage_ms[:], hops[:]
                t0 = time.perf_counter()
                y = pipeline_forward(mesh, "pipe", mine, xm, stage)
                torch.cuda.synchronize()
                fwd_ms = (time.perf_counter() - t0) * 1e3
            launches = registry.launches()
            out = {"launches": launches, "forward_ms": fwd_ms,
                   "block_alone_ms": alone,
                   "stage_ms": list(stage_ms), "hop_ms": list(hops),
                   "ticks": PP_MICRO + 3}
            if rank == 0:
                with torch.no_grad():
                    seq = []
                    for mb in xm:
                        h = mb
                        for p in blocks:
                            h = block.apply(p, {}, h)[0]
                        seq.append(h)
                    seq = torch.stack(seq)
                torch.cuda.synchronize()
                out["forward_bit_equal"] = bool(torch.equal(y, seq))
                out["forward_max_abs"] = float((y.float() - seq.float())
                                               .abs().max())
            step = pipeline_train_step(mesh, "pipe", stage, mse, lr=PP_LR)
            steps_ms = []
            for _ in range(2):      # the same step twice: the second timed
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new, loss = step(mine, xm, lm)
                torch.cuda.synchronize()
                steps_ms.append((time.perf_counter() - t0) * 1e3)
            out["step_ms"] = steps_ms[1]
            out["first_step_ms"] = steps_ms[0]
            out["loss"] = float(loss)
            leaves = [{k: v.detach().clone().requires_grad_()
                       for k, v in p.items()} for p in blocks]
            seq_loss = 0.0
            for mb, lb in zip(xm, lm):
                h = mb
                for p in leaves:
                    h = block.apply(p, {}, h)[0]
                seq_loss = seq_loss + mse(h, lb) / PP_MICRO
            seq_loss.backward()
            err, upd, still, upd_sq = 0.0, 0.0, -math.inf, 0.0
            for name, v in new.items():
                ref = leaves[rank][name]
                want = (ref - PP_LR * ref.grad.to(ref.dtype)).detach()
                got = v[0]
                err = max(err, float(((got - want).abs()
                                      - PP_STEP_TOL * want.abs()).max()))
                # what the same check reads of the stage's params unmoved
                still = max(still, float(((blocks[rank][name] - want).abs()
                                          - PP_STEP_TOL * want.abs()).max()))
                d_ref = (want - blocks[rank][name]).float()
                d_got = (got - blocks[rank][name]).float()
                upd_sq += float(d_ref.norm()) ** 2
                upd = max(upd, float((d_got - d_ref).norm()
                                     / max(float(d_ref.norm()), 1e-30)))
            out["step_excess_over_rtol"] = err
            out["unmoved_excess_over_rtol"] = still
            out["update_rel_l2"] = upd
            out["update_l2"] = upd_sq ** 0.5
            out["seq_loss"] = float(seq_loss)
            res[policy] = out
            del net, blocks, leaves, mine, new
            torch.cuda.empty_cache()
    finally:
        rank_out(root, rank, res)
        D.shutdown()


def phase_pipeline(card=None):
    """[pipeline] (ROADMAP A.5 part 3): the stage children above, then
    the checks: the forward bit-equal to the blocks in turn on each
    microbatch; K3 16 times a rank a forward (each stage its block's
    attention on each of its 16 microbatches); the SGD step within the
    JAX test's 1e-5 of the blocks in turn (params rtol and atol) and its
    update within PP_UPDATE_RTOL of theirs."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="pipeline_")
    try:
        res = collect_ranks(spawn_ranks("pp_rank", 4, root), root,
                            "pipeline")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    med = statistics.median
    ticks = PP_MICRO + 3
    for policy in ("F32", "BF16"):
        arms = [r[policy] for r in res]
        check(arms[0]["forward_bit_equal"], f"[pipeline] {policy}: the "
              f"pipelined forward differs from the blocks in turn "
              f"({arms[0]['forward_max_abs']:.3g})")
        for r, a in enumerate(arms):
            k3 = a["launches"].get("flash_attn_fwd", 0)
            check(k3 == PP_MICRO, f"[pipeline] {policy} stage {r}: K3 "
                  f"launched {k3} times in a forward, expected {PP_MICRO}")
            if policy == "BF16":
                check(a["launches"].get("flash_attn_fwd_sm90", 0)
                      == PP_MICRO, f"[pipeline] stage {r}: K3 off its "
                      f"sm90 route: {a['launches']}")
            check(a["step_excess_over_rtol"] <= PP_STEP_TOL,
                  f"[pipeline] {policy} stage {r}: the SGD step is "
                  f"{a['step_excess_over_rtol']:.3g} past rtol "
                  f"{PP_STEP_TOL} + atol {PP_STEP_TOL}")
            check(a["update_rel_l2"] <= PP_UPDATE_RTOL and a["update_l2"] > 0,
                  f"[pipeline] {policy} stage {r}: the step's update is "
                  f"{a['update_rel_l2']:.3g} (relative L2) from the blocks "
                  f"in turn's, bound {PP_UPDATE_RTOL}; its norm "
                  f"{a['update_l2']:.3g}")
            check(abs(a["loss"] - a["seq_loss"]) <= 1e-5 * abs(a["seq_loss"]),
                  f"[pipeline] {policy} stage {r}: loss {a['loss']} vs the "
                  f"blocks in turn {a['seq_loss']}")
        busy = [sum(a["stage_ms"]) / a["forward_ms"] for a in arms]
        phase("pipeline", policy=policy, stages=4, b=PP_B,
              microbatches=PP_MICRO, mb=PP_B // PP_MICRO, T=DEC_C,
              width=DEC_W, heads=DEC_H, mesh=json.dumps({"pipe": 4}),
              backend="gloo", forward_bit_equal=True,
              k3_launches_per_rank=PP_MICRO,
              k3_route="sm90" if policy == "BF16" else "fma",
              step_rtol=PP_STEP_TOL,
              step_excess_over_rtol=json.dumps(
                  [f"{a['step_excess_over_rtol']:.3g}" for a in arms]),
              update_rel_l2=json.dumps([f"{a['update_rel_l2']:.3g}"
                                        for a in arms]),
              update_bound=PP_UPDATE_RTOL,
              update_l2=json.dumps([f"{a['update_l2']:.4g}" for a in arms]),
              unmoved_stage_excess_over_rtol=json.dumps(
                  [f"{a['unmoved_excess_over_rtol']:.3g}" for a in arms]),
              loss=f"{arms[0]['loss']:.7g}",
              forward_ms=json.dumps([round(a["forward_ms"], 2)
                                     for a in arms]),
              tick_ms=f"{med([a['forward_ms'] for a in arms]) / ticks:.3f}",
              stage_call_ms=json.dumps([round(med(a["stage_ms"]), 3)
                                        for a in arms]),
              bubble_share_schedule=f"{3 / ticks:.4f}",
              idle_share_ranks=json.dumps([round(1 - b, 4) for b in busy]),
              hop_ms_median=json.dumps([round(med(a["hop_ms"]), 3)
                                        if a["hop_ms"] else None
                                        for a in arms]),
              hops_per_forward=json.dumps([len(a["hop_ms"]) for a in arms]),
              step_ms=json.dumps([round(a["step_ms"], 2) for a in arms]),
              first_step_ms=json.dumps([round(a["first_step_ms"], 2)
                                        for a in arms]),
              block_alone_fwd_bwd_ms=json.dumps(
                  [[round(t, 2) for t in a["block_alone_ms"]]
                   for a in arms]),
              card=card)
    phase("pipeline", phase_s=f"{time.perf_counter() - t_phase:.1f}")


# [experts]: 8 experts at gpt_mini's FFN widths (256 -> 1,024 -> 256) over
# 8,192 tokens, top-2, the default capacity (2 * 2 * 8192 / 8 = 4,096),
# F32, on {"expert": 2}; 3 SGD steps on the sharded params
EP_E, EP_TOKENS, EP_TOPK, EP_STEPS, EP_LR = 8, 8192, 2, 3, 0.1
# one backward on the shard against one process's: every leaf's gradient
# (a rank's slice of the experts') and x's, relative L2. The leaves'
# come from the same products on the gathered cotangent's slice; x's
# sums the two ranks' experts' shares in one all-reduce, where one
# process accumulates them one expert at a time: f32 rounding only
EP_GRAD_RTOL = 1e-6


def ep_rank(port, rank, root):
    """One rank of [experts]: its experts' shard against one process's
    moe_ffn (this process) on the same tokens, timed and its peak memory
    read; then EP_STEPS SGD steps on the shard; the router written."""
    import torch
    from deeplearning4j_tpu_torch.parallel import distributed as D
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.parallel.experts import (
        ExpertShard, init_moe_params, moe_ffn, shard_experts)
    D.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                 timeout_s=300)
    res = {}
    try:
        mesh = make_mesh({"expert": 2})
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2420)
        params = init_moe_params(gen, EP_E, DEC_W, 4 * DEC_W)
        x = torch.randn(EP_TOKENS, DEC_W, generator=gen, device="cuda")
        target = torch.tanh(x @ torch.randn(DEC_W, DEC_W, generator=gen,
                                            device="cuda") * 0.1)
        mine = shard_experts(mesh, "expert", params)

        def run(p):
            with torch.no_grad():
                return moe_ffn(p, x, top_k=EP_TOPK)

        run(mine)
        run(params)
        mine.mg.calls = mine.mg.bytes = 0
        mine.mg.seconds = 0.0
        (y, aux), mb = peak_mb(lambda: run(mine))
        gather_mb = mine.mg.bytes / 1e6
        gather_ms = mine.mg.seconds * 1e3
        (y1, aux1), one_mb = peak_mb(lambda: run(params))
        ms, one_ms = [], []
        for p, sink in ((mine, ms), (params, one_ms)) * 3:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(p)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0) * 1e3)
        res.update(
            bit_equal_y=bool(torch.equal(y, y1)),
            bit_equal_aux=bool(torch.equal(aux, aux1)),
            max_abs_y=float((y - y1).abs().max()),
            aux=float(aux), peak_mb=mb, one_process_peak_mb=one_mb,
            gather_mb=gather_mb, gather_ms=gather_ms, ms=ms,
            one_process_ms=one_ms,
            shard=list(mine["W1"].shape))

        def grads(p):
            leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
            xg = x.clone().requires_grad_()
            y, aux = moe_ffn(ExpertShard(leaves, p.mg) if p is mine
                             else leaves, xg, top_k=EP_TOPK)
            (((y - target) ** 2).mean() + 0.01 * aux).backward()
            return {"x": xg.grad, **{k: v.grad for k, v in leaves.items()}}

        g, g1 = grads(mine), grads(params)
        part = EP_E // 2
        for k in ("W1", "b1", "W2", "b2"):
            g1[k] = g1[k][rank * part:(rank + 1) * part]
        res["grad_rel_l2"] = {
            k: float((g[k] - g1[k]).norm() / g1[k].norm()) for k in g}
        res["grad_bit_equal"] = sorted(k for k in g
                                       if torch.equal(g[k], g1[k]))
        p = ExpertShard({k: v.clone().requires_grad_()
                         for k, v in mine.items()}, mine.mg)
        losses = []
        for _ in range(EP_STEPS):
            y, aux = moe_ffn(p, x, top_k=EP_TOPK)
            loss = ((y - target) ** 2).mean() + 0.01 * aux
            loss.backward()
            with torch.no_grad():
                for v in p.values():
                    v -= EP_LR * v.grad
                    v.grad = None
            losses.append(float(loss))
        res["losses"] = losses
        rank_out(root, rank, res, {"router": p["router"].detach().cpu()})
    finally:
        if not os.path.exists(os.path.join(root, f"rank{rank}.json")):
            rank_out(root, rank, res)
        D.shutdown()


def phase_experts(card=None):
    """[experts] (ROADMAP A.5 part 3): the children above, then the
    checks: each rank's output and aux loss bit-equal to one process's
    (no partial sum crosses the ranks: each rank's experts run one
    process's products, the combine runs whole after the gather); one
    backward's gradients within EP_GRAD_RTOL of one process's; the router
    leaves bit-equal on both ranks after EP_STEPS SGD steps."""
    import shutil
    import tempfile

    import torch
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="experts_")
    try:
        res = collect_ranks(spawn_ranks("ep_rank", 2, root), root,
                            "experts")
        routers = [torch.load(os.path.join(root, f"rank{r}.pt"))["router"]
                   for r in range(2)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for r, a in enumerate(res):
        check(a["bit_equal_y"] and a["bit_equal_aux"], f"[experts] rank "
              f"{r}: the sharded output differs from one process's "
              f"({a['max_abs_y']:.3g})")
        check(a["shard"] == [EP_E // 2, DEC_W, 4 * DEC_W],
              f"[experts] rank {r}: W1 shard {a['shard']}")
        g = a["grad_rel_l2"]
        check(set(g) == {"x", "router", "W1", "b1", "W2", "b2"}
              and max(g.values()) <= EP_GRAD_RTOL,
              f"[experts] rank {r}: gradients vs one process (relative "
              f"L2) {g}, bound {EP_GRAD_RTOL}")
    check(torch.equal(routers[0], routers[1]), "[experts] the router "
          "leaves differ between the ranks after training")
    check(res[0]["losses"] == res[1]["losses"] and all(
        math.isfinite(v) for v in res[0]["losses"]),
        f"[experts] the ranks' losses {res[0]['losses']}, "
        f"{res[1]['losses']}")
    med = statistics.median
    phase("experts", experts=EP_E, f_in=DEC_W, f_hidden=4 * DEC_W,
          tokens=EP_TOKENS, top_k=EP_TOPK,
          capacity=max(2 * EP_TOPK * EP_TOKENS // EP_E, 4), policy="F32",
          mesh=json.dumps({"expert": 2}), backend="gloo",
          bit_equal_to_one_process=True, router_bit_equal_after=EP_STEPS,
          grad_rel_l2_vs_one_process=json.dumps(
              [{k: f"{v:.3g}" for k, v in a["grad_rel_l2"].items()}
               for a in res]),
          grad_bound=EP_GRAD_RTOL,
          grad_bit_equal=json.dumps([a["grad_bit_equal"] for a in res]),
          aux=f"{res[0]['aux']:.7g}",
          losses=json.dumps([round(v, 6) for v in res[0]["losses"]]),
          ms_ranks=json.dumps([round(med(a["ms"]), 2) for a in res]),
          ms_one_process=json.dumps([round(med(a["one_process_ms"]), 2)
                                     for a in res]),
          gather_mb=f"{res[0]['gather_mb']:.2f}",
          gather_ms=json.dumps([round(a["gather_ms"], 2) for a in res]),
          peak_mb_ranks=json.dumps([round(a["peak_mb"], 1) for a in res]),
          peak_mb_one_process=json.dumps(
              [round(a["one_process_peak_mb"], 1) for a in res]),
          phase_s=f"{time.perf_counter() - t_phase:.1f}", card=card)


# [mesh_decode]: gpt_mini at full width (BF16 policy) on {"model": 2} with
# gpt_mini_tp_rules, its DecodeEngine built on both ranks (the shards'
# gather), 8 sessions of 32 greedy tokens on the leader
MD_SESSIONS, MD_TOKENS = 8, 32


def md_prompts():
    return {f"m{i}": dec_ids(8 + 11 * i, SEED + 2430 + i)
            for i in range(MD_SESSIONS)}


def md_greedy(eng, prompts, n):
    """{sid: (tokens, [logits rows])} of greedy decode, session by
    session."""
    out = {}
    for sid, ids in prompts.items():
        logits = np.asarray(eng.prefill(sid, ids))
        toks, rows = [], []
        for _ in range(n):
            rows.append(logits)
            toks.append(int(np.argmax(logits)))
            logits = np.asarray(eng.step(sid, toks[-1]))
        out[sid] = (toks, np.stack(rows))
        eng.close_session(sid)
    return out


def md_rank(port, rank, root):
    """One rank of [mesh_decode]: the tensor-parallel net, the engine
    (the gather, a collective of both ranks), and on the leader the
    sessions with the S kernels' launches and the forwards counted."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.parallel import distributed as D
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
    D.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                 timeout_s=300)
    res, tensors = {}, {}
    try:
        net = dec_net(seed=SEED + 2431)
        net.use_mesh(make_mesh({"model": 2}), model_axis="model",
                     tp_rules=zoo.gpt_mini_tp_rules())
        res["wq_shard"] = list(net.params["layer_1"]["Wq"].shape)
        mg = net._tp.mg
        c0, s0 = mg.calls, mg.seconds
        t0 = time.perf_counter()
        eng = DecodeEngine(net, replicas=1, batch_window_ms=1.0)
        res.update(engine_s=time.perf_counter() - t0,
                   gather_calls=mg.calls - c0,
                   gather_ms=(mg.seconds - s0) * 1e3,
                   wq_engine=list(eng.forward._params["layer_1"]["Wq"]
                                  .shape))
        try:
            if rank == 0:
                runs = [0]
                inner = eng.forward._run

                def counted(*a):
                    runs[0] += 1
                    return inner(*a)
                eng.forward._run = counted
                torch.cuda.synchronize()
                registry.reset_launches()
                t0 = time.perf_counter()
                out = md_greedy(eng, md_prompts(), MD_TOKENS)
                torch.cuda.synchronize()
                res.update(decode_s=time.perf_counter() - t0,
                           launches=registry.launches(), forwards=runs[0],
                           tokens={s: t for s, (t, _) in out.items()})
                tensors = {s: torch.from_numpy(r) for s, (_, r) in
                           out.items()}
        finally:
            eng.stop()
    finally:
        rank_out(root, rank, res, tensors if rank == 0 else None)
        D.shutdown()


def phase_mesh_decode(card=None):
    """[mesh_decode] (ROADMAP A.5 part 4): the rank children above and,
    meanwhile in this process, the unmeshed engine over the same net;
    then the checks: tokens and logits rows bit-equal, S1/S2/S3 25/4/8
    launches a forward."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mesh_decode_")
    try:
        procs = spawn_ranks("md_rank", 2, root)
        try:
            ref_net = dec_net(seed=SEED + 2431)
            eng = DecodeEngine(ref_net, replicas=1, batch_window_ms=1.0)
            try:
                t0 = time.perf_counter()
                ref = md_greedy(eng, md_prompts(), MD_TOKENS)
                ref_s = time.perf_counter() - t0
            finally:
                eng.stop()
            del ref_net, eng
            torch.cuda.empty_cache()
        finally:
            res = collect_ranks(procs, root, "mesh_decode")
        rows = torch.load(os.path.join(root, "rank0.pt"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lead = res[0]
    for sid, (toks, want) in ref.items():
        check(lead["tokens"][sid] == toks, f"[mesh_decode] {sid}: tokens "
              f"{lead['tokens'][sid]} != the unmeshed engine's {toks}")
        check(np.array_equal(rows[sid].numpy(), want), f"[mesh_decode] "
              f"{sid}: logits differ from the unmeshed engine's")
    fw = lead["forwards"]
    per = {se.KERNEL_DENSE: 6 * DEC_L + 1, se.KERNEL_MHA: DEC_L,
           se.KERNEL_NORM: 2 * DEC_L}
    got = {k: lead["launches"].get(k, 0) for k in per}
    check(fw > 0 and got == {k: v * fw for k, v in per.items()},
          f"[mesh_decode] S launches {got} in {fw} forwards, expected "
          f"{per} a forward")
    for r, a in enumerate(res):
        check(a["wq_shard"] == [DEC_W, DEC_W // 2]
              and a["wq_engine"] == [DEC_W, DEC_W],
              f"[mesh_decode] rank {r}: shard {a['wq_shard']}, engine "
              f"{a['wq_engine']}")
    tokens = MD_SESSIONS * MD_TOKENS
    phase("mesh_decode", mesh=json.dumps({"model": 2}), backend="gloo",
          rules="gpt_mini_tp_rules", policy="BF16", sessions=MD_SESSIONS,
          tokens_each=MD_TOKENS, bit_equal_to_unmeshed=True,
          forwards=fw, s_launches_per_forward=json.dumps(per),
          gather_calls=json.dumps([a["gather_calls"] for a in res]),
          gather_ms=json.dumps([round(a["gather_ms"], 2) for a in res]),
          engine_build_s=json.dumps([round(a["engine_s"], 3)
                                     for a in res]),
          tokens_per_s_meshed=f"{tokens / lead['decode_s']:.2f}",
          tokens_per_s_unmeshed=f"{tokens / ref_s:.2f}",
          phase_s=f"{time.perf_counter() - t_phase:.1f}", card=card)


# ---------------------------------------------------------------- slice 25
# Model import, clustering and the native loader (ROADMAP.md A.6.1, the
# clustering of A.6.2, A.6.3), each phase through the entry points a user
# calls, on the card. [keras_import] imports Keras models from JSON +
# numpy-seeded weights (h5py is not on the card's machine; the HDF5
# reader is held in tests/test_torch_keras_import.py on the CPU): a
# Keras 2 Sequential char-RNN at the zoo's width (input (64, 80),
# LSTM(512, return_sequences) x 2, TimeDistributed(Dense(80, softmax)))
# and keras.applications.VGG16's functional graph (224 x 224 x 3, 1000
# classes, 138,357,544 parameters).
KI_T, KI_V, KI_H, KI_B = 64, 80, 512, 32
KI_REQUESTS = 4
KI_STEPS = 3
# the imported F32 char-RNN's served probabilities, card vs the CPU
# import: K1 (f32 grid route) and the plain loop sum each gate's 512
# products in their own orders over 64 dependent steps (K1 holds to
# TOL["float32"] = 1e-4 on y), and S1 and the CPU's matmul the head's;
# a probability moves by at most its logits' error
KI_PROB_TOL = 1e-4
# the hard-sigmoid import: the composed route runs the plain loop on the
# card's tensors (cuBLAS's products against the CPU's), the head on S1
KI_HARD_TOL = 1e-5
# the first train step's score, card vs the CPU import (F32)
KI_SCORE_RTOL = 1e-4
KI_VGG_ROWS = (1, 4)
KI_VGG_REPS = 3
KI_VGG_SIZE = 224
KERAS_VGG_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
# [clustering]: word-vector-sized k-means (N points of D around K latent
# centres), each Lloyd step held against a float64 evaluation of the same
# step from the same centroids on the card. Assignments are held where
# the two nearest centroids' f64 distances differ by more than
# KM_GAP_RTOL relative (f32's expansion |x|^2 - 2 x.c + |c|^2 errs by
# ~1e-6 relative there); centroids of clusters no near-tie moved within
# KM_CENTROID_TOL (a mean of ~100 f32 rows); the cost (a sum of 1e5 f32
# minima) within KM_COST_RTOL.
KM_N, KM_D, KM_K, KM_ITERS = 100_000, 300, 1000, 10
KM_GAP_RTOL = 1e-4
KM_CENTROID_TOL = 1e-5
KM_COST_RTOL = 1e-5
# t-SNE: theta = 0 against the exact Tsne on the card; theta = 0.5 on
# the host (the JAX package's float64 path, ~1.5 s an iteration at
# n = 1,000 in Python), a few iterations to report its cost
TSNE_EXACT_N, TSNE_EXACT_ITERS = 500, 100
BH_N, BH_ITERS = 1000, 3
# [native_io]: IDX files in MNIST's shape, one zoo.lenet epoch
NI_N, NI_SIDE, NI_CLASSES, NI_B = 60_000, 28, 10, 64


def keras_lstm_weights(rng, n_in, units):
    """Keras's LSTM initializers: a glorot-uniform kernel, an orthogonal
    recurrent kernel, a zero bias with the forget gate's at 1 (Keras's
    (i, f, c, o) gate order)."""
    lim = math.sqrt(6.0 / (n_in + 4 * units))
    kernel = ((rng.random((n_in, 4 * units), dtype=np.float32) * 2 - 1)
              * lim)
    q, _ = np.linalg.qr(rng.standard_normal((4 * units, units)))
    bias = np.zeros(4 * units, np.float32)
    bias[units:2 * units] = 1.0
    return [kernel, q.T.astype(np.float32), bias]


def keras_char_rnn(gate="sigmoid", seed=SEED + 2500):
    """(model JSON, weights) of a Keras 2 Sequential char-RNN at the
    zoo's width; ``gate`` is the LSTMs' recurrent_activation."""
    rng = np.random.default_rng(seed)

    def lstm(name, first):
        cfg = {"name": name, "units": KI_H, "activation": "tanh",
               "recurrent_activation": gate, "return_sequences": True}
        if first:
            cfg["batch_input_shape"] = [None, KI_T, KI_V]
        return {"class_name": "LSTM", "config": cfg}
    config = {"class_name": "Sequential", "config": {
        "name": "char_rnn", "layers": [
            lstm("lstm", True), lstm("lstm_1", False),
            {"class_name": "TimeDistributed", "config": {
                "name": "time_distributed", "layer": {
                    "class_name": "Dense", "config": {
                        "name": "dense", "units": KI_V,
                        "activation": "softmax"}}}}]}}
    lim = math.sqrt(6.0 / (KI_H + KI_V))
    weights = {"lstm": keras_lstm_weights(rng, KI_V, KI_H),
               "lstm_1": keras_lstm_weights(rng, KI_H, KI_H),
               "time_distributed": [
                   (rng.random((KI_H, KI_V), dtype=np.float32) * 2 - 1)
                   * lim, np.zeros(KI_V, np.float32)]}
    return json.dumps(config), weights


def keras_vgg16(seed=SEED + 2510):
    """(model JSON, weights) of keras.applications.VGG16's functional
    graph (its layer names and configs, the top included, 224 x 224 x 3,
    1000 classes): glorot-uniform kernels, zero biases."""
    rng = np.random.default_rng(seed)
    side = KI_VGG_SIZE
    layers = [{"class_name": "InputLayer", "name": "input_1",
               "config": {"name": "input_1", "dtype": "float32",
                          "batch_input_shape": [None, side, side, 3]},
               "inbound_nodes": []}]
    weights = {}
    prev = ["input_1"]

    def add(cls, name, cfg, fan=None):
        layers.append({"class_name": cls, "name": name,
                       "config": dict(cfg, name=name),
                       "inbound_nodes": [[[prev[0], 0, 0, {}]]]})
        prev[0] = name
        if fan is not None:
            shape, fan_in, fan_out = fan
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            weights[name] = [
                (rng.random(shape, dtype=np.float32) * 2 - 1) * lim,
                np.zeros(shape[-1], np.float32)]
    c_in = 3
    for bi, (n, ch) in enumerate(KERAS_VGG_BLOCKS, 1):
        for ci in range(1, n + 1):
            add("Conv2D", f"block{bi}_conv{ci}",
                {"filters": ch, "kernel_size": [3, 3], "strides": [1, 1],
                 "padding": "same", "data_format": "channels_last",
                 "activation": "relu", "use_bias": True},
                ((3, 3, c_in, ch), 9 * c_in, 9 * ch))
            c_in = ch
        add("MaxPooling2D", f"block{bi}_pool",
            {"pool_size": [2, 2], "strides": [2, 2], "padding": "valid",
             "data_format": "channels_last"})
    add("Flatten", "flatten", {"data_format": "channels_last"})
    flat = (side // 32) ** 2 * 512
    for name, f_in, f_out, act in (("fc1", flat, 4096, "relu"),
                                   ("fc2", 4096, 4096, "relu"),
                                   ("predictions", 4096, 1000, "softmax")):
        add("Dense", name, {"units": f_out, "activation": act,
                            "use_bias": True}, ((f_in, f_out), f_in, f_out))
    config = {"class_name": "Functional", "config": {
        "name": "vgg16", "layers": layers,
        "input_layers": [["input_1", 0, 0]],
        "output_layers": [["predictions", 0, 0]]}}
    return json.dumps(config), weights


def params_bit_equal(a, b):
    """Every parameter of net ``a`` equals ``b``'s bit for bit (on
    ``a``'s device)."""
    import torch
    return all(torch.equal(t, b.params[name][k].to(t.device))
               for name, leaves in a.params.items()
               for k, t in leaves.items())


def ki_char_rnn_arm(card):
    """[keras_import] arm=char_rnn: the sigmoid-gated import served and
    trained on the card, held to the CPU import."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.modelimport import (
        import_keras_sequential_model_and_weights as import_seq)
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    from deeplearning4j_tpu_torch.serving import ModelServer
    model_json, weights = keras_char_rnn()
    t0 = time.perf_counter()
    net = import_seq(model_json, weights)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    cpu = import_seq(model_json, weights, device="cpu")
    check(net.device.type == "cuda" and params_bit_equal(cpu, net),
          "[keras_import] char_rnn: the card's import differs from the "
          "CPU's")
    check(net.conf.layers[0].gate_activation == "sigmoid",
          f"char_rnn gate {net.conf.layers[0].gate_activation}")
    route = lstm_ops.lstm_route(torch.float32, KI_B, KI_H)
    check(route == "kernel", f"[keras_import] lstm_route says {route}")
    rng = np.random.default_rng(SEED + 2501)
    eye = np.eye(KI_V, dtype=np.float32)
    reqs = [eye[rng.integers(0, KI_V, (KI_B, KI_T))]
            for _ in range(KI_REQUESTS)]
    srv = ModelServer(net, port=0, max_batch=KI_B,
                      input_shapes=[(KI_T, KI_V)]).start()
    try:
        torch.cuda.synchronize()
        registry.reset_launches()
        b0 = srv.metrics()["batches_total"]
        t0 = time.perf_counter()
        replies = []
        for x in reqs:
            status, body = post_json(srv.url + "/predict",
                                     {"features": x.tolist()})
            check(status == 200, f"/predict answered {status}")
            replies.append(np.asarray(body["predictions"], np.float32))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = registry.launches()
        forwards = srv.metrics()["batches_total"] - b0
    finally:
        srv.stop()
    check(forwards == KI_REQUESTS, f"[keras_import] {forwards} forwards "
          f"for {KI_REQUESTS} requests of {KI_B} rows")
    k1, s1 = counts.get(lstm_ops.KERNEL, 0), counts.get(se.KERNEL_DENSE, 0)
    check(k1 == 2 * forwards and s1 == forwards,
          f"[keras_import] K1 {k1} and S1 {s1} launches in {forwards} "
          f"forwards: expected 2 and 1 a forward ({counts})")
    err, bits = 0.0, True
    for x, got in zip(reqs, replies):
        check(got.shape == (KI_B, KI_T, KI_V) and np.isfinite(got).all(),
              f"reply {got.shape}")
        bits &= bool(np.array_equal(got, net.output(x).cpu().numpy()))
        err = max(err, float(np.abs(got - cpu.output(x).numpy()).max()))
    check(bits, "[keras_import] a reply differs from net.output of its "
          "bucket")
    check(err <= KI_PROB_TOL, f"[keras_import] served char_rnn vs the CPU "
          f"import: {err:.3e} > {KI_PROB_TOL}")

    # 3 train steps on the card; the first against the CPU import's
    ds = DataSet(reqs[0], eye[rng.integers(0, KI_V, (KI_B, KI_T))])
    cpu_score = float(cpu.fit_batch(ds))
    before = {(n, k): t.clone() for n, leaves in net.params.items()
              for k, t in leaves.items()}
    torch.cuda.synchronize()
    registry.reset_launches()
    scores, step_ms = [], []
    for _ in range(KI_STEPS):
        t0 = time.perf_counter()
        scores.append(float(net.fit_batch(ds)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    counts = registry.launches()
    per_call = lstm_ops.bwd_launches_per_call(torch.float32, KI_H)
    k2_calls = counts.get(lstm_ops.BWD_KERNEL, 0) / per_call
    check(k2_calls == 2 * KI_STEPS
          and counts.get(lstm_ops.KERNEL, 0) == 2 * KI_STEPS,
          f"[keras_import] {KI_STEPS} steps: {counts} (K2 {per_call} "
          f"launches a call; expected 2 calls of K1 and K2 a step)")
    rel = abs(scores[0] - cpu_score) / abs(cpu_score)
    check(rel <= KI_SCORE_RTOL, f"[keras_import] first step's score "
          f"{scores[0]:.6f} vs the CPU import's {cpu_score:.6f}: {rel:.3e} "
          f"> {KI_SCORE_RTOL}")
    still = [f"{n}/{k}" for (n, k), t in before.items()
             if torch.equal(t, net.params[n][k])]
    check(not still, f"[keras_import] params unmoved by {KI_STEPS} steps: "
          f"{still}")
    check(all(math.isfinite(s) for s in scores), f"scores {scores}")
    phase("keras_import", arm="char_rnn",
          model=f"keras Sequential LSTM({KI_H})x2+TimeDistributed(Dense("
                f"{KI_V}))", policy="F32", params=net.num_params(),
          import_s=f"{import_s:.3f}", lstm_route=route,
          requests=KI_REQUESTS, rows=KI_REQUESTS * KI_B,
          rows_per_s=f"{KI_REQUESTS * KI_B / wall:.1f}", forwards=forwards,
          k1_per_forward=k1 // forwards, s1_per_forward=s1 // forwards,
          replies_bit_equal_to_output=bits,
          max_abs_err_vs_cpu=f"{err:.3e}", tol=KI_PROB_TOL,
          k2_calls_per_step=k2_calls / KI_STEPS,
          k1_per_step=counts.get(lstm_ops.KERNEL, 0) // KI_STEPS,
          first_score=f"{scores[0]:.6f}", cpu_first_score=f"{cpu_score:.6f}",
          score_rel_err=f"{rel:.3e}",
          scores=json.dumps([round(s, 6) for s in scores]),
          step_ms=json.dumps([round(m, 2) for m in step_ms]),
          params_moved=True, card=card)
    del net, cpu


def ki_hard_sigmoid_arm(card):
    """[keras_import] arm=hard_sigmoid: Keras 2's default gate takes the
    counted composed route; K1 launches no time."""
    import torch
    from deeplearning4j_tpu_torch.modelimport import (
        import_keras_sequential_model_and_weights as import_seq)
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    from deeplearning4j_tpu_torch.ops import registry
    model_json, weights = keras_char_rnn(gate="hard_sigmoid",
                                         seed=SEED + 2502)
    net = import_seq(model_json, weights)
    cpu = import_seq(model_json, weights, device="cpu")
    check(net.conf.layers[0].gate_activation == "hardsigmoid",
          f"gate {net.conf.layers[0].gate_activation}")
    route = lstm_ops.lstm_route(torch.float32, KI_B, KI_H,
                                gate_act="hardsigmoid")
    x = np.eye(KI_V, dtype=np.float32)[np.random.default_rng(
        SEED + 2503).integers(0, KI_V, (KI_B, KI_T))]
    torch.cuda.synchronize()
    registry.reset_launches()
    got = net.output(x).cpu().numpy()
    torch.cuda.synchronize()
    counts, routes = registry.launches(), registry.routes()
    name = "lstm_sequence:composed[gate_act=hardsigmoid]"
    check(route == "composed" and routes.get(name) == 2
          and counts.get(lstm_ops.KERNEL, 0) == 0,
          f"[keras_import] hard_sigmoid: route {route}, composed "
          f"{routes}, launches {counts}")
    err = float(np.abs(got - cpu.output(x).numpy()).max())
    check(np.isfinite(got).all() and err <= KI_HARD_TOL,
          f"[keras_import] hard_sigmoid vs the CPU import: {err:.3e} > "
          f"{KI_HARD_TOL}")
    phase("keras_import", arm="hard_sigmoid", lstm_route=route,
          composed_calls=routes.get(name), k1_launches=0,
          max_abs_err_vs_cpu=f"{err:.3e}", tol=KI_HARD_TOL, card=card)


def ki_vgg16_arm(card):
    """[keras_import] arm=vgg16: the functional VGG-16 imported into a
    ComputationGraph and served in buckets of 1 and 4 rows."""
    import torch
    from deeplearning4j_tpu_torch.modelimport import (
        import_keras_model_and_weights)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    from deeplearning4j_tpu_torch.serving import ModelServer
    from deeplearning4j_tpu_torch.serving.batcher import next_bucket
    model_json, weights = keras_vgg16()
    mb = sum(a.nbytes for arrays in weights.values() for a in arrays) / 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for arrays in weights.values():       # what the import's copies move
        for a in arrays:
            torch.from_numpy(a).to("cuda")
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    net = import_keras_model_and_weights(model_json, weights)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    check(isinstance(net, ComputationGraph)
          and net.num_params() == 138357544,
          f"[keras_import] vgg16: {type(net).__name__} of "
          f"{net.num_params()} params")
    rng = np.random.default_rng(SEED + 2511)
    x = rng.normal(0.0, 50.0, (max(KI_VGG_ROWS), KI_VGG_SIZE, KI_VGG_SIZE,
                               3)).astype(np.float32)
    srv = ModelServer(net, port=0, max_batch=max(KI_VGG_ROWS)).start()
    rows = []
    try:
        torch.cuda.synchronize()
        registry.reset_launches()
        b0 = srv.metrics()["batches_total"]
        for n in KI_VGG_ROWS:
            times, got = [], None
            for _ in range(KI_VGG_REPS):
                t0 = time.perf_counter()
                got = srv.predict(x[:n])
                times.append(time.perf_counter() - t0)
            b = next_bucket(n, max(KI_VGG_ROWS), 2)
            pad = np.zeros((b,) + x.shape[1:], np.float32)
            pad[:n] = x[:n]
            want = net.output(pad).cpu().numpy()[:n]
            p50 = statistics.median(times)
            rows.append({"rows": n, "bucket": b,
                         "bit_equal": bool(np.array_equal(got, want)),
                         "p50_ms": round(p50 * 1e3, 2),
                         "rows_per_s": round(n / p50, 2)})
        torch.cuda.synchronize()
        counts = registry.launches()
        forwards = srv.metrics()["batches_total"] - b0
    finally:
        srv.stop()
    check(all(r["bit_equal"] for r in rows), f"[keras_import] vgg16 "
          f"served rows differ from net.output of the bucket: {rows}")
    s1 = counts.get(se.KERNEL_DENSE, 0)
    # the reference outputs above ran 2 forwards of their own
    fwd_all = forwards + len(KI_VGG_ROWS)
    check(s1 == 3 * fwd_all, f"[keras_import] vgg16: S1 {s1} launches in "
          f"{fwd_all} forwards, expected 3 a forward ({counts})")
    card_p = net.output(x).cpu()
    del net
    torch.cuda.empty_cache()
    cpu = import_keras_model_and_weights(model_json, weights, device="cpu")
    cpu_p = cpu.output(x)
    row_err = float(((card_p - cpu_p).abs().amax(1)
                     / cpu_p.amax(1)).max())
    check(torch.isfinite(card_p).all().item()
          and row_err <= VGG_ROW_PROB_TOL, f"[keras_import] vgg16 card vs "
          f"the CPU import: {row_err:.3e} of a row's largest probability "
          f"> {VGG_ROW_PROB_TOL}")
    phase("keras_import", arm="vgg16",
          model="keras.applications.VGG16 functional (224x224x3, 1000)",
          policy="F32", params=138357544, weights_mb=f"{mb:.1f}",
          import_s=f"{import_s:.3f}", host_to_card_ms=f"{h2d_ms:.1f}",
          buckets=json.dumps(rows), forwards=fwd_all,
          s1_per_forward=s1 // fwd_all,
          prob_vs_cpu_over_row_max=f"{row_err:.3e}", tol=VGG_ROW_PROB_TOL,
          row_max_prob=json.dumps([float(f"{v:.4e}")
                                   for v in cpu_p.amax(1)]), card=card)


def phase_keras_import(card=None):
    """[keras_import]: the three arms (module docstring of slice 25)."""
    t0 = time.perf_counter()
    ki_char_rnn_arm(card)
    ki_hard_sigmoid_arm(card)
    ki_vgg16_arm(card)
    return time.perf_counter() - t0


def golden_numpy_forward(x):
    """The hand-packed DL4J fixture's MLP (tests/fixtures/
    build_dl4j_golden.py's FLAT) forward in float64 numpy."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fixtures", "build_dl4j_golden.py")
    spec = importlib.util.spec_from_file_location("build_dl4j_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    flat = mod.FLAT.astype(np.float64)
    h = np.tanh(x @ flat[:12].reshape(3, 4, order="F") + flat[12:16])
    z = h @ flat[16:24].reshape(4, 2, order="F") + flat[24:26]
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def phase_dl4j_import(card=None):
    """[dl4j_import]: the port's char_rnn and VGG-16 (F32) through the
    DL4J zip and back onto the card bit for bit; the golden fixture's
    forward; the model guesser on three formats."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.modelimport import dl4j
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.utils import checkpoint as ck
    from deeplearning4j_tpu_torch.utils import model_guesser as guess
    from deeplearning4j_tpu_torch.utils import serialization as ser
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 2520)
    root = tempfile.mkdtemp(prefix="dl4j_import_")
    try:
        cases = (
            ("char_rnn", lambda: zoo.char_rnn(seed=SEED + 2521,
                                              dtype=zoo.F32),
             np.eye(KI_V, dtype=np.float32)[rng.integers(0, KI_V,
                                                         (4, KI_T))],
             None),
            ("vgg16", lambda: zoo.vgg16(seed=SEED + 2522, dtype=zoo.F32,
                                        image_size=KI_VGG_SIZE),
             rng.normal(0.0, 50.0, (2, KI_VGG_SIZE, KI_VGG_SIZE, 3))
             .astype(np.float32),
             InputType.convolutional(KI_VGG_SIZE, KI_VGG_SIZE, 3)))
        zips, kept = {}, None
        for name, make, x, input_type in cases:
            net = make()
            p = os.path.join(root, f"{name}_dl4j.zip")
            t0 = time.perf_counter()
            dl4j.write_dl4j_zip(net, p)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = dl4j.restore_multi_layer_network_from_dl4j(
                p, input_type=input_type, dtype=zoo.F32)
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t0
            check(back.device.type == "cuda" and params_bit_equal(net, back),
                  f"[dl4j_import] {name}: the restored params differ")
            out_bits = bool(torch.equal(net.output(x), back.output(x)))
            check(out_bits, f"[dl4j_import] {name}: outputs differ")
            zips[name] = p
            phase("dl4j_import", model=name, policy="F32",
                  params=net.num_params(),
                  zip_mb=f"{os.path.getsize(p) / 1e6:.1f}",
                  write_s=f"{write_s:.3f}", read_s=f"{read_s:.3f}",
                  params_bit_equal=True, outputs_bit_equal=out_bits,
                  card=card)
            if name == "char_rnn":
                kept = (net, x)
            else:
                del net, back
                torch.cuda.empty_cache()

        # the hand-packed golden fixture, on the card (F32 default policy)
        golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "fixtures", "dl4j_mlp_golden.zip")
        gnet = dl4j.restore_multi_layer_network_from_dl4j(golden)
        xg = np.asarray([[0.3, -0.1, 0.8], [1.0, 0.5, -0.25]], np.float32)
        g_err = float(np.abs(gnet.output(xg).cpu().numpy()
                             - golden_numpy_forward(xg.astype(np.float64)))
                      .max())
        check(gnet.device.type == "cuda" and g_err <= 1e-6,
              f"[dl4j_import] golden forward vs numpy: {g_err:.3e} > 1e-6")

        # the guesser: each format through load_model and its own entry
        net, x = kept
        tz = os.path.join(root, "char_rnn.zip")
        ser.write_model(net, tz)
        ckdir = ck.save_checkpoint(net, os.path.join(root, "ck"))
        formats = {}
        for path, fmt, direct, kw in (
                (tz, "tpu_zip", ser.restore_model, {}),
                (zips["char_rnn"], "dl4j_zip",
                 dl4j.restore_multi_layer_network_from_dl4j,
                 {"dtype": zoo.F32}),
                (ckdir, "orbax", ck.restore_multi_layer_network, {})):
            got_fmt = guess.guess_format(path)
            a = guess.load_model(path, **kw)
            b = direct(path, **kw)
            check(a.device.type == "cuda", f"[dl4j_import] load_model put "
                  f"{fmt} on {a.device}")
            same = (bool(torch.equal(a.output(x), b.output(x)))
                    and bool(torch.equal(a.output(x), net.output(x))))
            check(got_fmt == fmt and same, f"[dl4j_import] guesser: {path} "
                  f"-> {got_fmt} (expected {fmt}), replies equal: {same}")
            formats[fmt] = same
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase("dl4j_import", arm="golden_and_guesser",
          golden_max_abs_err_vs_numpy=f"{g_err:.3e}", golden_tol=1e-6,
          guesser_replies_equal=json.dumps(formats),
          keras_h5="CPU tests only (h5py)",
          phase_s=f"{time.perf_counter() - t_phase:.1f}", card=card)


def word_vectors(seed):
    """KM_N f32 points of KM_D around KM_K unit-normal centres (noise
    0.5): clusters the size of a vocabulary's word vectors."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((KM_K, KM_D), dtype=np.float32)
    idx = rng.integers(0, KM_K, KM_N)
    return centres[idx] + np.float32(0.5) * rng.standard_normal(
        (KM_N, KM_D), dtype=np.float32)


def hold_lloyd_step(step, x64, c32, k, out):
    """A card Lloyd step's (centroids, assignments, cost) against the
    same step evaluated in float64 from the same centroids on the card."""
    import torch
    c64 = c32.double()
    nc64, a64, cost64 = step(x64, c64, k)
    nc32, a32, cost32 = out
    d2 = ((x64 * x64).sum(1, keepdim=True) - 2.0 * x64 @ c64.T
          + (c64 * c64).sum(1))
    two = torch.topk(d2, 2, dim=1, largest=False).values
    del d2
    gap = (two[:, 1] - two[:, 0]) / two[:, 0].abs().clamp_min(1e-30)
    flips = a32 != a64
    clear = gap > KM_GAP_RTOL
    bad = int((flips & clear).sum())
    check(bad == 0, f"[clustering] {bad} assignments differ from f64 where "
          f"the two nearest centroids differ by > {KM_GAP_RTOL} relative")
    keep = torch.ones(k, dtype=torch.bool, device=a32.device)
    keep[a32[flips]] = False
    keep[a64[flips]] = False
    c_err = float((nc32.double() - nc64).abs()[keep].max())
    check(c_err <= KM_CENTROID_TOL, f"[clustering] centroids {c_err:.3e} "
          f"from f64 > {KM_CENTROID_TOL}")
    cost_rel = abs(float(cost32) - float(cost64)) / float(cost64)
    check(cost_rel <= KM_COST_RTOL, f"[clustering] cost {cost_rel:.3e} "
          f"relative from f64 > {KM_COST_RTOL}")
    return {"flips": int(flips.sum()), "near_ties": int((~clear).sum()),
            "centroid_err": c_err, "cost_rel": cost_rel,
            "moved_clusters": int((~keep).sum())}


def phase_clustering(card=None):
    """[clustering]: k-means (k = 1,000) on 100,000 word-vector-sized
    points, each Lloyd step held to float64 on the card; Barnes-Hut
    t-SNE at theta 0 against the exact Tsne, and at theta 0.5."""
    import torch
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.clustering import kmeans as km_mod
    from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne
    t_phase = time.perf_counter()
    x_host = word_vectors(SEED + 2530)
    x = torch.from_numpy(x_host).cuda()
    x64 = x.double()
    km = KMeansClustering(k=KM_K, max_iterations=KM_ITERS, tol=0.0,
                          seed=SEED + 2531)
    seeding = {}
    seed_indices = km._seed_indices

    def timed_seeding(xs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = seed_indices(xs)
        seeding["s"] = time.perf_counter() - t0
        seeding["distinct"] = len(set(idx))
        return idx
    km._seed_indices = timed_seeding
    step, held = km_mod._lloyd_step, []

    def held_step(xs, c, k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(xs, c, k)
        end.record()
        end.synchronize()
        held.append(dict(hold_lloyd_step(step, x64, c, k, out),
                         ms=start.elapsed_time(end)))
        return out
    km_mod._lloyd_step = held_step
    try:
        t0 = time.perf_counter()
        km.fit(x)
        fit_s = time.perf_counter() - t0
    finally:
        km_mod._lloyd_step = step
    check(len(held) == KM_ITERS and km.centroids.shape == (KM_K, KM_D)
          and math.isfinite(km.cost), f"[clustering] {len(held)} steps, "
          f"cost {km.cost}")
    check(seeding["distinct"] == KM_K, f"seeding picked "
          f"{seeding['distinct']} distinct points")
    ms = [h["ms"] for h in held]
    del x64
    torch.cuda.empty_cache()
    phase("clustering", arm="kmeans", n=KM_N, d=KM_D, k=KM_K,
          iterations=KM_ITERS, seeding_s=f"{seeding['s']:.3f}",
          step_ms=json.dumps([round(v, 3) for v in ms]),
          step_ms_median=f"{statistics.median(ms):.3f}",
          fit_s=f"{fit_s:.2f}", cost=f"{km.cost:.6e}",
          flips_vs_f64=json.dumps([h["flips"] for h in held]),
          near_ties=json.dumps([h["near_ties"] for h in held]),
          max_centroid_err_vs_f64=f"{max(h['centroid_err'] for h in held):.3e}",
          max_cost_rel_vs_f64=f"{max(h['cost_rel'] for h in held):.3e}",
          tol=json.dumps({"gap_rtol": KM_GAP_RTOL,
                          "centroids": KM_CENTROID_TOL,
                          "cost_rtol": KM_COST_RTOL}), card=card)

    xt = x_host[:TSNE_EXACT_N]
    kw = dict(max_iter=TSNE_EXACT_ITERS, seed=SEED + 2532)
    bh0 = BarnesHutTsne(theta=0.0, **kw)
    ex = Tsne(**kw)
    t0 = time.perf_counter()
    y_bh0 = bh0.fit_transform(xt)
    exact_s = time.perf_counter() - t0
    same = bool(np.array_equal(y_bh0, ex.fit_transform(xt))
                and bh0.kl == ex.kl)
    check(same, "[clustering] BarnesHutTsne(theta=0) differs from Tsne")
    bh = BarnesHutTsne(theta=0.5, max_iter=BH_ITERS, seed=SEED + 2533)
    t0 = time.perf_counter()
    y = bh.fit_transform(x_host[:BH_N])
    bh_s = time.perf_counter() - t0
    check(y.shape == (BH_N, 2) and np.isfinite(y).all()
          and math.isfinite(bh.kl), f"[clustering] Barnes-Hut {y.shape}")
    phase("clustering", arm="tsne", exact_n=TSNE_EXACT_N,
          exact_iters=TSNE_EXACT_ITERS, theta0_bit_equal_to_tsne=same,
          theta0_s=f"{exact_s:.3f}", theta0_kl=f"{bh0.kl:.6f}",
          bh_n=BH_N, bh_theta=0.5, bh_iters=BH_ITERS, bh_s=f"{bh_s:.2f}",
          bh_s_per_iter=f"{bh_s / BH_ITERS:.3f}", bh_kl=f"{bh.kl:.6f}",
          bh_device="host (float64 numpy)",
          phase_s=f"{time.perf_counter() - t_phase:.1f}", card=card)


def write_idx_u8(path, arr):
    """An IDX file of unsigned bytes (MNIST's format)."""
    import struct
    arr = np.ascontiguousarray(arr, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x00000800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def mnist_shaped_idx(root, seed):
    """IDX files in MNIST's shape: NI_N 28 x 28 u8 images and their u8
    labels. Each image is noise with a bright 6 x 6 block at a place its
    label picks, so an epoch has something to learn."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NI_CLASSES, NI_N).astype(np.uint8)
    img = rng.integers(0, 96, (NI_N, NI_SIDE, NI_SIDE), dtype=np.uint8)
    for lab in range(NI_CLASSES):
        r, c = 4 + 12 * (lab // 5), 1 + 5 * (lab % 5)
        img[labels == lab, r:r + 6, c:c + 6] = 255
    paths = (os.path.join(root, "train-images-idx3-ubyte"),
             os.path.join(root, "train-labels-idx1-ubyte"))
    write_idx_u8(paths[0], img)
    write_idx_u8(paths[1], labels)
    return paths


def row_hashes(x):
    import hashlib
    flat = np.ascontiguousarray(x).reshape(x.shape[0], -1)
    return [hashlib.blake2b(r.tobytes(), digest_size=8).digest()
            for r in flat]


def phase_native_io(card=None):
    """[native_io]: the C++ loader built by g++ into the port's build
    dir, MNIST-shaped IDX files read by it, and one zoo.lenet epoch on
    the card fed by NativeDataSetIterator through fit's
    DevicePrefetchIterator, its rows hashed as they pass; then, for the
    time, an epoch from the same loader unhashed and one from the same
    arrays in memory (ArrayDataSetIterator); and the batches/s of fit's
    input stack without a step: the loader alone, under
    AsyncDataSetIterator, under DevicePrefetchIterator over that, and the
    in-memory iterator alone."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator,
                                                   DataSet, DataSetIterator)
    from deeplearning4j_tpu_torch.datasets import native_io
    from deeplearning4j_tpu_torch.datasets.iterator import (
        AsyncDataSetIterator, DevicePrefetchIterator, NativeDataSetIterator)
    from deeplearning4j_tpu_torch.ops import _build

    class Recorded(DataSetIterator):
        """The base iterator's batches, each row's hash recorded."""

        def __init__(self, base):
            self.base, self.hashes = base, []

        def __iter__(self):
            for ds in self.base:
                self.hashes.extend(row_hashes(ds.features))
                yield ds

        def __len__(self):
            return len(self.base)

        def reset(self):
            self.base.reset()

        @property
        def batch_size(self):
            return self.base.batch_size

    t_phase = time.perf_counter()
    lib = _build.host_library_path(native_io.LIBRARY)
    prebuilt = lib.exists()
    t0 = time.perf_counter()
    check(native_io.available(), "[native_io] the loader did not build")
    build_s = time.perf_counter() - t0
    check(lib.exists() and lib.parent == _build.build_dir(),
          f"[native_io] the library is not in the port's build dir: {lib}")
    root = tempfile.mkdtemp(prefix="native_io_")
    its = []
    try:
        img_path, lab_path = mnist_shaped_idx(root, SEED + 2540)
        t0 = time.perf_counter()
        images = native_io.read_idx(img_path)
        labels = native_io.read_idx(lab_path, normalize=False)
        read_s = time.perf_counter() - t0
        check(images.shape == (NI_N, NI_SIDE, NI_SIDE)
              and labels.shape == (NI_N,), f"[native_io] read "
              f"{images.shape} {labels.shape}")
        x = images.reshape(NI_N, NI_SIDE, NI_SIDE, 1)
        y = np.eye(NI_CLASSES, dtype=np.float32)[labels.astype(np.int64)]
        file_rows = sorted(row_hashes(x))
        kw = dict(batch_size=NI_B, shuffle=True, seed=SEED + 2541,
                  drop_last=False)
        alone = NativeDataSetIterator(x, y, **kw)
        fed = NativeDataSetIterator(x, y, **kw)
        its += [alone, fed]
        t0 = time.perf_counter()
        batches = [ds.features for ds in alone]
        alone_s = time.perf_counter() - t0
        n_alone = len(batches)
        alone_rows = [h for b in batches for h in row_hashes(b)]
        del batches
        net = zoo.lenet(seed=SEED + 2542)
        probe = DataSet(x[:1024], y[:1024])
        s0 = net.score(probe)
        rec = Recorded(fed)
        t0 = time.perf_counter()
        step_ms, wait, _ = traced_fit_ms(net, rec, epochs=1)
        epoch_s = time.perf_counter() - t0
        rep, steps = net.last_run_report, net.iteration
        s1 = net.score(probe)
        timed = {}
        for src, it in (("native", fed), ("memory", ArrayDataSetIterator(
                x, y, batch_size=NI_B, shuffle=True, seed=SEED + 2541))):
            t0 = time.perf_counter()
            ms, w, _ = traced_fit_ms(net, it, epochs=1)
            timed[src] = {"epoch_s": round(time.perf_counter() - t0, 3),
                          "step_ms": round(ms, 3), "data_wait_share": round(
                              w / net.last_run_report.wall_s, 4)}
        graphs = [(sg.captures, sg.replays)
                  for sg in net._multi_steps.values()]
        stack = {"native_alone": round(n_alone / alone_s, 1)}
        for name, it in (
                ("native_async", AsyncDataSetIterator(fed)),
                ("native_async_device", DevicePrefetchIterator(
                    AsyncDataSetIterator(fed), device=net.device)),
                ("memory_alone", ArrayDataSetIterator(
                    x, y, batch_size=NI_B, shuffle=True, seed=SEED + 2541))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = sum(1 for _ in it)
            torch.cuda.synchronize()
            stack[name] = round(n / (time.perf_counter() - t0), 1)
    finally:
        for it in its:
            it.close()
        shutil.rmtree(root, ignore_errors=True)
    n_batches = -(-NI_N // NI_B)
    check(sorted(rec.hashes) == file_rows, "[native_io] the fed epoch is "
          "not a permutation of the file's rows")
    check(rec.hashes == alone_rows, "[native_io] two iterators with one "
          "seed gave different batches")
    check(steps == n_batches, f"[native_io] {steps} steps, expected "
          f"{n_batches}")
    check(s1 < s0, f"[native_io] lenet's score did not fall: {s0:.4f} -> "
          f"{s1:.4f}")
    phase("native_io", library=lib.name, prebuilt=prebuilt,
          build_s=f"{build_s:.2f}", images=json.dumps(list(images.shape)),
          idx_mb=f"{(NI_N * NI_SIDE * NI_SIDE + NI_N) / 1e6:.1f}",
          read_s=f"{read_s:.3f}", batch=NI_B, batches=n_batches,
          batches_per_s_alone=f"{n_batches / alone_s:.1f}",
          stack_batches_per_s=json.dumps(stack),
          model="lenet(28x28x1,BF16)", epoch_s=f"{epoch_s:.2f}",
          step_ms=f"{step_ms:.3f}",
          data_wait_share=f"{wait / rep.wall_s:.4f}",
          score_before=f"{s0:.4f}", score_after=f"{s1:.4f}",
          permutation_of_file=True, iterators_bit_equal=True,
          unhashed_epoch=json.dumps(timed["native"]),
          memory_epoch=json.dumps(timed["memory"]),
          captured_graphs=json.dumps(graphs),
          phase_s=f"{time.perf_counter() - t_phase:.1f}", card=card)


def phase_slice25(card=None):
    """Slice 25's phases, in order; their seconds together."""
    t0 = time.perf_counter()
    phase_keras_import(card)
    phase_dl4j_import(card)
    phase_clustering(card)
    phase_native_io(card)
    phase("slice25", phases_s=f"{time.perf_counter() - t0:.1f}", card=card)


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
    if "--coord-worker" in sys.argv[1:]:
        return co_worker(sys.argv[sys.argv.index("--coord-worker") + 1])
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
            ("--fwd-split", phase_fwd_split),
            ("--profiler-pause", phase_profiler_pause),
            ("--stream-split", phase_stream_split)):
        if flag in sys.argv[1:] and not (flag == "--stream-split"
                                         and "--slice15" in sys.argv[1:]):
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
                       ("--slice14", phase_slice14),
                       ("--live-reload", phase_live_reload)):
        if flag in sys.argv[1:]:
            phase_device()
            only()
            print(ok_line, flush=True)
            return 0
    for flag, only in (("--analysis", phase_analysis),
                       ("--data-parallel", phase_data_parallel)):
        if flag in sys.argv[1:]:
            card = phase_device()
            # the kernels the phase's path runs, each against its plain
            # version, as in the full run
            phase_flash_vs_plain()
            if flag == "--analysis":
                phase_stream_exact_vs_plain()
            only(card)
            print(ok_line, flush=True)
            return 0
    if "--wide-kernels" in sys.argv[1:]:
        kernels = phase_wide_kernels(phase_device())
        print(json.dumps({"kernels": kernels}), flush=True)
        print(ok_line, flush=True)
        return 0
    if "--tensor-parallel" in sys.argv[1:]:
        card = phase_device()
        phase_flash_vs_plain()      # K3, the kernel the phase's path runs
        phase_tensor_parallel(card)
        print(ok_line, flush=True)
        return 0
    if "--graph-tensor-parallel" in sys.argv[1:]:
        card = phase_device()
        phase_fused_vs_plain()      # K4-K7, the kernels the phase's path runs
        phase_graph_tensor_parallel(card)
        print(ok_line, flush=True)
        return 0
    if "--mesh-serving" in sys.argv[1:]:
        phase_mesh_serving(phase_device())
        print(ok_line, flush=True)
        return 0
    # A.5 parts 3-4: each phase after the kernels its path runs, against
    # their plain versions, as in the full run
    for flag, before, only in (
            ("--sequence-parallel",
             (phase_kernel_vs_plain, phase_bwd_vs_plain),
             phase_sequence_parallel),
            ("--pipeline", (phase_flash_vs_plain,), phase_pipeline),
            ("--experts", (), phase_experts),
            ("--mesh-decode", (phase_stream_exact_vs_plain,),
             phase_mesh_decode)):
        if flag in sys.argv[1:]:
            card = phase_device()
            for fn in before:
                fn()
            only(card)
            print(ok_line, flush=True)
            return 0
    for flag, only in (("--front-door", phase_front_door),
                       ("--cold-start", phase_cold_start),
                       ("--dashboard", phase_dashboard),
                       ("--meshed-bn", phase_meshed_bn),
                       ("--routes", phase_routes),
                       ("--coordinated", phase_coordinated)):
        if flag in sys.argv[1:]:
            only(phase_device())
            print(ok_line, flush=True)
            return 0
    if "--slice25" in sys.argv[1:]:
        card = phase_device()
        # the kernels the slice's paths run, against their plain versions
        phase_kernel_vs_plain()
        phase_bwd_vs_plain()
        phase_stream_exact_vs_plain()
        phase_slice25(card)
        print(ok_line, flush=True)
        return 0
    if "--slice15" in sys.argv[1:]:
        kernels = phase_slice15(phase_device())
        if "--stream-split" in sys.argv[1:]:
            phase_stream_split()
        print(json.dumps({"kernels": kernels}), flush=True)
        print(ok_line, flush=True)
        return 0

    card = phase_device()
    # C.3.2: the profiler's probe first in the process, and again after
    # every other phase (PERF.md section 6)
    names = profiler_probe("first", profiles=5)
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
    kernels += phase_slice15(card)
    phase_live_reload()
    phase_front_door(card)
    phase_cold_start(card)
    phase_dashboard(card)
    phase_analysis(card)
    phase_data_parallel(card)
    phase_meshed_bn(card)
    phase_routes(card)
    phase_coordinated(card)
    kernels += phase_wide_kernels(card)
    phase_tensor_parallel(card)
    phase_graph_tensor_parallel(card)
    phase_mesh_serving(card)
    phase_sequence_parallel(card)
    phase_pipeline(card)
    phase_experts(card)
    phase_mesh_decode(card)
    phase_slice25(card)
    phase_stream_split()
    profiler_probe("after_all", profiles=5, names=names)
    phase("profiler", pause_s=PROFILE_PAUSE_S, **PROFILES)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(ok_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
