"""Traffic-trace-driven autotuning of the serving schedule knobs
(counterpart of deeplearning4j_tpu/compilecache/autotune.py; host only).

The bucket ladder cap (``max_batch``) and linger window
(``batch_window_ms``) are schedule choices: bigger buckets amortize
dispatch but pad more and wait longer to fill; a longer linger raises
coalescing at the direct cost of tail latency. The right point depends
on the traffic SHAPE — so, per the TVM stance (PAPERS.md: measured
search over schedules, not a hand model), we replay a recorded
trace offline (``serve_bench --out``'s shape; :func:`bench_results`
builds it from a run of the port's server) against a simulator of the
dispatcher and search the grid.

The simulator replays the micro-batcher's exact dispatch semantics
(serving/batcher.py): one device thread; the oldest pending ticket
starts a batch; compatible arrivals coalesce until the bucket fills or
the linger window closes (the window is waited out even when the queue
goes empty — that IS the linger cost at low concurrency); the batch
pads to the next power-of-two bucket; service time comes from a
per-bucket model fitted to the trace's own measured device times
(``device_ms_by_bucket``), linear in the bucket via weighted least
squares — measured, not assumed.

Objective: ``p99_ms * (1 + padding_waste_fraction)`` — the search's
"p99 x padding waste" made non-degenerate (a raw product is 0 whenever
waste is 0, which would declare any zero-waste config perfect no
matter its latency; the ``1 +`` keeps p99 in charge and prices waste
as a multiplicative penalty on it).

The winning config ships as a tuning report the server loads via
``ModelServer(tuning_report=...)``; the default config is always a
grid point, so the tuned objective is <= the default's BY CONSTRUCTION
on the replayed trace.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.serving.batcher import next_bucket

SCHEMA_VERSION = 1

#: default search grids: ladder caps (powers of two) and linger windows
#: (ms). 0.0 window = launch as soon as the device is free.
DEFAULT_MAX_BATCH_GRID = (4, 8, 16, 32, 64, 128)
DEFAULT_WINDOW_GRID_MS = (0.0, 0.5, 1.0, 2.0, 4.0, 8.0)


# ------------------------------------------------------------- trace intake
def extract_trace(results: dict) -> dict:
    """Pull the replayable trace out of a ``serve_bench --out`` file:
    arrivals, the measured per-bucket device times, and the config the
    bench ran with (the 'default' the search must beat)."""
    trace = results.get("trace")
    if not trace or not trace.get("arrivals"):
        raise ValueError(
            "no 'trace' in results — rerun scripts/serve_bench.py "
            "(its --out report embeds the arrival trace)")
    metrics = results.get("metrics") or {}
    return {
        "arrivals": [(float(t), int(r)) for t, r in trace["arrivals"]],
        "concurrency": trace.get("concurrency"),
        "device_ms_by_bucket": {
            int(k): float(v) for k, v in
            (metrics.get("device_ms_by_bucket") or {}).items()},
        "bucket_counts": {
            int(k): int(v) for k, v in
            (metrics.get("batch_size_hist") or {}).items()},
        "default": {"max_batch": int(results.get("max_batch", 1024)),
                    "batch_window_ms": float(
                        results.get("batch_window_ms", 2.0))},
    }


def bench_results(arrivals, stats_snapshot: dict, *, max_batch: int,
                  batch_window_ms: float, concurrency=None) -> dict:
    """A served run in ``scripts/serve_bench.py --out``'s shape, the
    input of :func:`autotune`: ``arrivals`` are ``(t_seconds, rows)``
    pairs (or scheduling.loadgen ``Arrival``s), ``stats_snapshot`` the
    server's ``ServingStats.snapshot()`` over the same run, and the
    (max_batch, batch_window_ms) it served with (the default the search
    must beat)."""
    pairs = sorted((float(a.t), int(a.rows)) if hasattr(a, "t")
                   else (float(a[0]), int(a[1])) for a in arrivals)
    return {"trace": {"arrivals": [[round(t, 6), r] for t, r in pairs],
                      "concurrency": concurrency},
            "metrics": {
                "device_ms_by_bucket":
                    dict(stats_snapshot.get("device_ms_by_bucket") or {}),
                "batch_size_hist":
                    dict(stats_snapshot.get("batch_size_hist") or {})},
            "max_batch": int(max_batch),
            "batch_window_ms": float(batch_window_ms)}


# ----------------------------------------------------------- service model
def fit_service_model(device_ms_by_bucket: dict,
                      bucket_counts: Optional[dict] = None
                      ) -> Tuple[float, float]:
    """Fit ``service_ms(bucket) = a + c * bucket`` to the measured
    per-bucket mean device times, weighted by how often each bucket
    executed. The linear form matches the weight-streaming serving
    regime (fixed dispatch + per-row compute); with a single observed
    bucket the split is fixed at 80% dispatch / 20% per-row, the
    conservative end (discourages the search from assuming big buckets
    are nearly free)."""
    pts = sorted(device_ms_by_bucket.items())
    if not pts:
        raise ValueError("empty device_ms_by_bucket — nothing to fit")
    if len(pts) == 1:
        b, ms = pts[0]
        return 0.8 * ms, 0.2 * ms / max(1, b)
    w = [float((bucket_counts or {}).get(b, 1)) for b, _ in pts]
    sw = sum(w)
    mb = sum(wi * b for wi, (b, _) in zip(w, pts)) / sw
    mm = sum(wi * ms for wi, (_, ms) in zip(w, pts)) / sw
    var = sum(wi * (b - mb) ** 2 for wi, (b, _) in zip(w, pts))
    if var <= 0:
        b, ms = pts[0]
        return 0.8 * ms, 0.2 * ms / max(1, b)
    c = sum(wi * (b - mb) * (ms - mm) for wi, (b, ms) in zip(w, pts)) / var
    c = max(c, 0.0)  # per-row cost can't be negative
    a = max(mm - c * mb, 0.0)
    if a == 0.0 and c == 0.0:
        a = mm
    return a, c


# --------------------------------------------------------------- simulator
def simulate(arrivals: Sequence[Tuple[float, int]], *, max_batch: int,
             batch_window_ms: float, min_batch: int, service_ms) -> dict:
    """Replay *arrivals* (sorted ``(t_seconds, rows)``) through the
    dispatcher semantics under one (max_batch, window) config.
    ``service_ms(bucket)`` models the device forward. Returns p99/mean
    latency and the padding waste the config would have produced."""
    evts = sorted((float(t), min(int(r), max_batch)) for t, r in arrivals)
    n = len(evts)
    window_s = batch_window_ms / 1000.0
    lat: List[float] = []
    real = padded = 0
    t_free = 0.0
    i = 0
    while i < n:
        t_start = max(t_free, evts[i][0])
        rows = 0
        j = i
        # everything already queued at t_start that fits
        while j < n and evts[j][0] <= t_start and rows + evts[j][1] <= max_batch:
            rows += evts[j][1]
            j += 1
        launch = t_start
        if window_s > 0 and rows < max_batch:
            # linger: coalesce stragglers until the bucket fills or the
            # window closes; the window is waited out even if no one
            # else arrives (batcher.py _gather_locked cond.wait)
            deadline = t_start + window_s
            launch = deadline
            while j < n and evts[j][0] <= deadline \
                    and rows + evts[j][1] <= max_batch:
                rows += evts[j][1]
                if rows >= max_batch:
                    launch = evts[j][0]  # full bucket launches NOW
                j += 1
        bucket = next_bucket(rows, max_batch, min_batch)
        done = launch + service_ms(bucket) / 1000.0
        for k in range(i, j):
            lat.append(done - evts[k][0])
        real += rows
        padded += bucket - rows
        t_free = done
        i = j
    s = sorted(lat)

    def pct(q):
        return 1000.0 * s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]

    waste = padded / (real + padded) if real + padded else 0.0
    return {
        "p50_ms": round(pct(0.50), 3),
        "p99_ms": round(pct(0.99), 3),
        "mean_ms": round(1000.0 * sum(s) / len(s), 3) if s else 0.0,
        "padding_waste_fraction": round(waste, 4),
    }


def objective(p99_ms: float, waste_fraction: float) -> float:
    """p99 x (1 + padding waste): tail latency priced up by the share
    of device work the schedule burned on filler rows."""
    return p99_ms * (1.0 + waste_fraction)


# ------------------------------------------------------------------ search
def autotune(results: dict, *, min_batch: int = 2,
             max_batch_grid: Optional[Sequence[int]] = None,
             window_grid_ms: Optional[Sequence[float]] = None) -> dict:
    """Grid-search (max_batch, batch_window_ms) over the replayed trace;
    returns the tuning report (schema'd dict) with the tuned config,
    the default config's numbers, and the full scored grid."""
    trace = extract_trace(results)
    arrivals = trace["arrivals"]
    a, c = fit_service_model(trace["device_ms_by_bucket"],
                             trace["bucket_counts"])

    def svc(bucket: int) -> float:
        return a + c * bucket

    default = trace["default"]
    caps = list(max_batch_grid or DEFAULT_MAX_BATCH_GRID)
    windows = list(window_grid_ms or DEFAULT_WINDOW_GRID_MS)
    if default["max_batch"] not in caps:
        caps.append(default["max_batch"])
    if default["batch_window_ms"] not in windows:
        windows.append(default["batch_window_ms"])

    grid = []
    for cap in sorted(set(caps)):
        for win in sorted(set(windows)):
            sim = simulate(arrivals, max_batch=int(cap),
                           batch_window_ms=float(win), min_batch=min_batch,
                           service_ms=svc)
            grid.append({"max_batch": int(cap),
                         "batch_window_ms": float(win), **sim,
                         "objective": round(objective(
                             sim["p99_ms"],
                             sim["padding_waste_fraction"]), 3)})
    # deterministic winner: lowest objective, then smallest knobs
    grid.sort(key=lambda g: (g["objective"], g["max_batch"],
                             g["batch_window_ms"]))
    tuned = grid[0]
    default_row = next(
        g for g in grid
        if g["max_batch"] == default["max_batch"]
        and g["batch_window_ms"] == default["batch_window_ms"])
    return {
        "schema_version": SCHEMA_VERSION,
        "config": "serving_autotune",
        "created_unix": round(time.time(), 3),
        "trace": {"requests": len(arrivals),
                  "span_s": round(arrivals[-1][0] - arrivals[0][0], 3)
                  if len(arrivals) > 1 else 0.0,
                  "concurrency": trace.get("concurrency")},
        "service_model_ms": {"dispatch": round(a, 4),
                             "per_row": round(c, 6),
                             "observed_buckets":
                                 {str(k): v for k, v in sorted(
                                     trace["device_ms_by_bucket"].items())}},
        "default": default_row,
        "tuned": tuned,
        # <= 1.0 by construction (the default is a grid point)
        "objective_ratio": round(
            tuned["objective"] / default_row["objective"], 4)
        if default_row["objective"] else 1.0,
        "grid": grid[:16],
    }


def load_tuned(report) -> dict:
    """The (max_batch, batch_window_ms) a server should boot with, from
    a tuning report dict or a path to one. Raises on a report that
    doesn't carry a tuned config (fail loud — a server silently falling
    back to defaults would defeat the receipt)."""
    if isinstance(report, (str, os.PathLike)):
        with open(report) as f:
            report = json.load(f)
    tuned = report.get("tuned") or {}
    if "max_batch" not in tuned or "batch_window_ms" not in tuned:
        raise ValueError("tuning report has no tuned config "
                         "(expected report['tuned']['max_batch'/"
                         "'batch_window_ms'])")
    return {"max_batch": int(tuned["max_batch"]),
            "batch_window_ms": float(tuned["batch_window_ms"])}
