#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ops/csrc/, holds each against its
plain PyTorch version on the card, serves the full-width GravesLSTM
char-RNN (vocab 80, hidden 512, 2 layers, BF16) through ``ModelServer``
``/predict``, checks that the served path launched the kernels, streams
through ``rnn_time_step``, and times the kernels. Every phase that fails
ends the run with a nonzero exit code. It needs one CUDA card; without one
(or without the package beside it) it exits nonzero and prints no result.

Output: one line per phase; the card's name and power limit as nvidia-smi
gives them; a JSON line ``{"kernels": [...]}``; and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
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


def phase_times(card, net, main_err, main_launches):
    import torch
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    T, b, n = 64, 32, 512
    dtype = torch.bfloat16
    args = lstm_inputs(T, b, n, dtype)
    with torch.inference_mode():
        ms = cuda_ms(lambda: lstm_ops.lstm_sequence_cuda(*args), reps=50)
        plain_ms = cuda_ms(lambda: lstm_ops.lstm_sequence_torch(*args),
                           reps=5)
    # T-sweep: K1's fixed cost and its cost per dependent time step
    sweep = {}
    for steps in (1, 16):
        a = lstm_inputs(steps, b, n, dtype)
        with torch.inference_mode():
            sweep[steps] = cuda_ms(lambda: lstm_ops.lstm_sequence_cuda(*a),
                                   reps=50)
    sweep[T] = ms
    per_step_ms = (sweep[T] - sweep[16]) / (T - 16)
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
    esize = 2
    nbytes = esize * (T * b * 4 * n + T * b + 2 * b * n + n * 4 * n + 3 * n
                      + T * b * n + 2 * b * n)
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    phase("times", kernel="lstm_fwd", T=T, b=b, n=n, dtype="bfloat16",
          card=json.dumps(card), ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
          bound_ms=f"{bound_ms:.5f}", flops=f"{flops:.4g}",
          bytes=f"{nbytes:.4g}", roofline_share=f"{bound_ms / ms:.4f}",
          ms_T1=f"{sweep[1]:.4f}", ms_T16=f"{sweep[16]:.4f}",
          per_step_us=f"{1e3 * per_step_ms:.2f}",
          fixed_us=f"{1e3 * (sweep[1] - per_step_ms):.2f}",
          forward_ms_b2=f"{forward_ms[2]:.4f}",
          forward_ms_b32=f"{forward_ms[32]:.4f}",
          library="none: cuDNN's LSTM has neither peepholes nor this mask "
                  "semantics")
    return [{"name": "lstm_fwd", "route": "cuda",
             "source": "deeplearning4j_tpu_torch/ops/csrc/lstm_fwd.cu",
             "replaces": "deeplearning4j_tpu/ops/lstm.py:100",
             "launches": main_launches, "max_abs_err": main_err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "library_ms": None}]


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
    main_err = phase_kernel_vs_plain()
    net, launches = phase_serve()
    phase_stream(net)
    kernels = phase_times(card, net, main_err, launches)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
