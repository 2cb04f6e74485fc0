#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ops/csrc/ (the LSTM forward K1 and
backward K2), holds each against its plain PyTorch version on the card,
serves the full-width GravesLSTM char-RNN (vocab 80, hidden 512, 2 layers,
BF16) through ``ModelServer`` ``/predict``, streams through
``rnn_time_step``, trains the same model with ``fit_batch`` (standard
backprop, then truncated BPTT), checks that each path launched the
kernels, and times the kernels and the train step. Every phase that fails
ends the run with a nonzero exit code. It needs one CUDA card; without one
(or without the package beside it) it exits nonzero and prints no result.

Output: one line per phase; the card's name and power limit as nvidia-smi
gives them; a JSON line ``{"kernels": [...]}``; and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
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
    return card


def phase_kernel_vs_plain():
    import torch
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    from deeplearning4j_tpu_torch.ops import registry
    cases = [(64, 32, 512, False, False, True),
             (64, 32, 512, False, False, False),
             (64, 2, 512, False, True, False),
             (1, 1, 512, False, True, False),
             (7, 3, 512, True, False, True),
             (7, 3, 512, True, True, False)]
    main_err = None
    n_calls = 0
    registry.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = TOL[dname]
        for T, b, n, masked, carry, save in cases:
            args = lstm_inputs(T, b, n, dtype, masked, carry)
            with torch.inference_mode():
                got = lstm_ops.lstm_sequence_cuda(*args, save_residuals=save)
                torch.cuda.synchronize()
                n_calls += 1
                want = lstm_ops.lstm_sequence_torch(*args,
                                                    save_residuals=save)
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
                bad = d > tol + tol * w.float().abs()
                check(torch.isfinite(g.float()).all().item(),
                      f"{field} not finite (T={T} b={b} {dname})")
                check(not bad.any().item(),
                      f"lstm_fwd {field} disagrees with the plain version "
                      f"(T={T} b={b} n={n} {dname} masked={masked} "
                      f"save={save}): max abs err {errs[field]:.3e} > "
                      f"{tol} + {tol}*|want|")
            if (T, b, dname, save) == (64, 32, "bfloat16", False):
                main_err = errs["y"]
            phase("kernel_vs_plain", kernel="lstm_fwd", dtype=dname, T=T,
                  b=b, n=n, masked=masked, carry=carry, residuals=save,
                  tol=tol,
                  max_abs_err=json.dumps({k: float(f"{v:.3e}")
                                          for k, v in errs.items()}))
    launched = registry.launches().get("lstm_fwd", 0)
    check(launched == n_calls,
          f"launch counter read {launched} after {n_calls} kernel calls")
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


def phase_bwd_vs_plain():
    import torch
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    from deeplearning4j_tpu_torch.ops import registry
    cases = [(64, 32, 512, False, False), (64, 2, 512, False, True),
             (7, 3, 512, True, False), (1, 1, 512, False, True)]
    names = ("dxz", "dh0", "dc0", "dWh", "dp")
    main_err = None
    n_calls = 0
    base = registry.launches().get("lstm_bwd", 0)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for T, b, n, masked, carry in cases:
            args, fwd_args = bwd_inputs(T, b, n, dtype, masked, carry)
            with torch.inference_mode():
                got = lstm_ops.lstm_sequence_bwd_cuda(*args)
                again = lstm_ops.lstm_sequence_bwd_cuda(*args)
                torch.cuda.synchronize()
                n_calls += 2
                want = lstm_ops.lstm_sequence_bwd_torch(*args)
            check(all(torch.equal(g, a) for g, a in zip(got, again)),
                  f"lstm_bwd: two identical calls gave different bits "
                  f"(T={T} b={b} {dname})")
            errs, tols = {}, {}
            for name, g, w in zip(names, got, want):
                check(g.dtype == w.dtype and g.shape == w.shape,
                      f"{name}: kernel {g.dtype}{tuple(g.shape)} vs plain "
                      f"{w.dtype}{tuple(w.shape)}")
                check(torch.isfinite(g.float()).all().item(),
                      f"lstm_bwd {name} not finite (T={T} b={b} {dname})")
                tol = (BWD_F32_TOL if dtype == torch.float32
                       else bf16_tol(w.float()))
                d = (g.float() - w.float()).abs()
                errs[name], tols[name] = d.max().item(), tol
                check(not (d > tol + tol * w.float().abs()).any().item(),
                      f"lstm_bwd {name} disagrees with the plain version "
                      f"(T={T} b={b} n={n} {dname} masked={masked}): max "
                      f"abs err {errs[name]:.3e} > {tol:.3e} + "
                      f"{tol:.3e}*|want|")
            fields = {}
            if dtype == torch.float32:
                fields["fn_vs_autograd_rel_err"] = (
                    f"{fn_vs_autograd(fwd_args):.3e}")
                n_calls += 1
            if (T, b, dname) == (64, 32, "bfloat16"):
                main_err = max(errs.values())
            phase("kernel_vs_plain", kernel="lstm_bwd", dtype=dname, T=T,
                  b=b, n=n, masked=masked, carry=carry, deterministic=True,
                  max_abs_err=json.dumps({k: float(f"{v:.3e}")
                                          for k, v in errs.items()}),
                  tol=json.dumps({k: float(f"{v:.3e}")
                                  for k, v in tols.items()}), **fields)
    launched = registry.launches().get("lstm_bwd", 0) - base
    check(launched == n_calls,
          f"lstm_bwd launch counter read {launched} after {n_calls} calls")
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
        launches = registry.launches().get("lstm_fwd", 0)
        status, metrics = get_json(srv.url + "/metrics")
        check(status == 200, f"/metrics answered {status}")
    finally:
        srv.stop()
    check(launches > 0, "the served path launched lstm_fwd no time")

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
          rows_bit_equal_alone=bit_equal,
          max_abs_err_vs_alone=f"{max_err:.3e}",
          max_abs_err_vs_cpu_plain=f"{cpu_err:.3e}", tol=PROB_TOL)
    return net, launches


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
    launches = registry.launches().get("lstm_fwd", 0)
    streamed = np.stack(steps, axis=1)
    err = float(np.abs(streamed - one_shot).max())
    check(streamed.shape == one_shot.shape, "stream shape")
    check(launches == 2 * T, f"stream launched lstm_fwd {launches} times, "
          f"expected {2 * T}")
    check(err <= PROB_TOL,
          f"rnn_time_step vs one-shot output: {err:.3e} > {PROB_TOL}")
    phase("stream", steps=T, lstm_fwd_launches=launches,
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
    for k in ("lstm_fwd", "lstm_bwd"):
        check(launches.get(k, 0) == 2 * steps,
              f"{k} launched {launches.get(k, 0)} times in {steps} train "
              f"steps, expected {2 * steps}")
    med = statistics.median(step_ms[-20:])
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
          cpu_first_step_s=f"{cpu_s:.2f}")
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
    for k in ("lstm_fwd", "lstm_bwd"):
        want = 2 * chunks * n_batches
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


def phase_times(card, net, errs, launches, train):
    import torch
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    T, b, n = 64, 32, 512
    dtype = torch.bfloat16
    esize = 2
    no_library = ("none: cuDNN's LSTM has neither peepholes nor this mask "
                  "semantics")

    # K1
    args = lstm_inputs(T, b, n, dtype)
    with torch.inference_mode():
        plain_ms = cuda_ms(lambda: lstm_ops.lstm_sequence_torch(*args),
                           reps=5)
        # as the train path runs it: residuals written for K2
        res_ms = cuda_ms(lambda: lstm_ops.lstm_sequence_cuda(
            *args, save_residuals=True), reps=50)
    sweep, per_step, fixed = sweep_ms(
        lambda steps: lstm_inputs(steps, b, n, dtype),
        lstm_ops.lstm_sequence_cuda, T)
    ms = sweep[T]
    # the whole served forward (2 LSTM layers + projections + head) at
    # the largest and smallest bucket
    rng = np.random.default_rng(SEED + 2)
    forward_ms = {}
    for rows in (2, 32):
        x = torch.from_numpy(np.eye(80, dtype=np.float32)[
            rng.integers(0, 80, (rows, T))]).cuda()
        forward_ms[rows] = cuda_ms(lambda: net.output(x), reps=20)
    # least work: the recurrent products (the gates' elementwise work is
    # ~20 ops per output, 0.05% of it) and each input read once, each
    # output written once
    flops = 2.0 * T * b * n * 4 * n
    nbytes = esize * (T * b * 4 * n + T * b + 2 * b * n + n * 4 * n + 3 * n
                      + T * b * n + 2 * b * n)
    bound_ms, bound_by = bound(flops, nbytes, "bfloat16")
    phase("times", kernel="lstm_fwd", T=T, b=b, n=n, dtype="bfloat16",
          card=json.dumps(card), ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
          bound_ms=f"{bound_ms:.5f}", flops=f"{flops:.4g}",
          bytes=f"{nbytes:.4g}", roofline_share=f"{bound_ms / ms:.4f}",
          ms_T1=f"{sweep[1]:.4f}", ms_T16=f"{sweep[16]:.4f}",
          per_step_us=f"{1e3 * per_step:.2f}", fixed_us=f"{1e3 * fixed:.2f}",
          ms_with_residuals=f"{res_ms:.4f}",
          forward_ms_b2=f"{forward_ms[2]:.4f}",
          forward_ms_b32=f"{forward_ms[32]:.4f}", library=no_library)
    kernels = [{"name": "lstm_fwd", "route": "cuda",
                "source": "deeplearning4j_tpu_torch/ops/csrc/lstm_fwd.cu",
                "replaces": "deeplearning4j_tpu/ops/lstm.py:100",
                "launches": launches["serve"]["lstm_fwd"],
                "launches_by_path": {k: v.get("lstm_fwd", 0)
                                     for k, v in launches.items()},
                "max_abs_err": errs["lstm_fwd"], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}]

    # K2
    bargs, _ = bwd_inputs(T, b, n, dtype)
    with torch.inference_mode():
        bplain_ms = cuda_ms(lambda: lstm_ops.lstm_sequence_bwd_torch(*bargs),
                            reps=5)
    bsweep, bper_step, bfixed = sweep_ms(
        lambda steps: bwd_inputs(steps, b, n, dtype)[0],
        lstm_ops.lstm_sequence_bwd_cuda, T)
    bms = bsweep[T]
    # least work: the chain's dz @ Wh^T and dWh = h_prev^T dz (the
    # elementwise gate work is ~30 ops per element, under 0.1% of it);
    # G, h_prev, c_prev, mask, Wh, p, dy, dhT, dcT read once, dxz, dh0,
    # dc0, dWh, dp written once
    bflops = 2.0 * (2.0 * T * b * n * 4 * n)
    bbytes = esize * (T * b * 4 * n + 2 * T * b * n + T * b + n * 4 * n
                      + 3 * n + T * b * n + 2 * b * n + T * b * 4 * n
                      + 2 * b * n + n * 4 * n + 3 * n)
    bbound_ms, bbound_by = bound(bflops, bbytes, "bfloat16")
    phase("times", kernel="lstm_bwd", T=T, b=b, n=n, dtype="bfloat16",
          card=json.dumps(card), ms=f"{bms:.4f}", plain_ms=f"{bplain_ms:.4f}",
          bound_ms=f"{bbound_ms:.5f}", flops=f"{bflops:.4g}",
          bytes=f"{bbytes:.4g}", roofline_share=f"{bbound_ms / bms:.4f}",
          ms_T1=f"{bsweep[1]:.4f}", ms_T16=f"{bsweep[16]:.4f}",
          per_step_us=f"{1e3 * bper_step:.2f}",
          fixed_us=f"{1e3 * bfixed:.2f}",
          train_step_ms=f"{train['step_ms']:.4f}", library=no_library)
    kernels.append({
        "name": "lstm_bwd", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/ops/csrc/lstm_bwd.cu",
        "replaces": "deeplearning4j_tpu/ops/lstm.py:145",
        "launches": launches["train"]["lstm_bwd"],
        "launches_by_path": {k: v.get("lstm_bwd", 0)
                             for k, v in launches.items()},
        "max_abs_err": errs["lstm_bwd"], "ms": bms, "plain_ms": bplain_ms,
        "bound_ms": bbound_ms, "bound_by": bbound_by, "library_ms": None})
    return kernels


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_device()
    errs = {"lstm_fwd": phase_kernel_vs_plain(),
            "lstm_bwd": phase_bwd_vs_plain()}
    net, serve_launches = phase_serve()
    phase_stream(net)
    train = phase_train()
    launches = {"serve": {"lstm_fwd": serve_launches},
                "train": train["launches"], "tbptt": phase_tbptt()}
    kernels = phase_times(card, net, errs, launches, train)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
