"""Continuous-batching HTTP inference server (counterpart of
deeplearning4j_tpu/serving/server.py).

HTTP handler threads enqueue tickets; a replica set (serving/fleet.py) of
batcher device threads (serving/batcher.py) coalesces what is pending
into padded power-of-two bucket forwards through ``net.output`` and
scatters the rows back. On a CUDA net that forward runs the port's
kernels. With ``decode_engine=`` the server also serves sessionful decode
(serving/decode.py).

Endpoints:
- ``POST /predict`` {"features": [[...]]} -> {"predictions": ...}
- ``POST /decode`` (with ``decode_engine=``): {"op": "prefill" | "step" |
  "generate" | "close", "sid": ..., "ids": [history], "token": t,
  "n_tokens": n}. A ``step`` for a session this server does not hold is
  recovered by re-prefilling the ``ids`` it carries (bit-identical); with
  no ``ids`` it answers 404 (``UnknownSessionError``).
- ``GET /healthz``  liveness, the replicas' rows, and ``decode``
- ``GET /metrics``  the ServingStats snapshot with the replicas and
  ``decode`` (JSON); with ``Accept: text/plain`` or ``?format=prometheus``
  the unified registry in Prometheus text instead

Each POST carries ``X-DL4J-Trace-Id`` (the client's, or one minted here)
onto its handler span and batcher tickets and echoes it back; the
scheduling headers ``X-DL4J-Priority`` / ``-Tenant`` / ``-Deadline-Ms``
go into fleet admission and are echoed back normalized.

``start()`` warms the bucket ladder from ``input_shapes`` (or the row
shape the configuration implies) before it accepts traffic. A shed or a
full queue answers 503 with ``Retry-After`` and ``X-DL4J-Shed-Class``;
``stop()`` drains accepted work first and closes the serving goodput
ledger (``run_report``, with the SLO engine's ``slo`` report).

Traffic engine: ``scheduler=None`` builds a default ``SchedulingCore``
(no quotas; class watermarks shed batch first), ``False`` turns
admission scheduling off, an instance is used as given; its
``dl4j_sched_*`` families go on the registry. ``slos=None`` builds the
default SLO pair (``default_serving_slos``, p99 bound
``$DL4J_TPU_SLO_P99_MS`` or 500 ms), a falsy list none; its
``dl4j_slo_*`` families are evaluated at each scrape. ``push_url=``
pushes this host's snapshot (with ``server_url`` and its request-scoped
spans) to a router's or aggregator's ``/api/metrics_push`` every
``push_interval_s``.

``compute_dtype=`` serves through a shadow net over the same parameters
with only the policy's compute dtype replaced: its rows hold a tolerance
against the net's own, not bit-identity.

``hot_swap(publication)`` reloads the served weights with no gap: a
rolling ``ReplicaSet.swap_forward`` onto a forward bound to the
published weights (serving/publish.py), one structure-only net object a
version, so requests still finishing on the old weights never see a
mutated net. A warmed server builds no kernel across a swap.

Cold start (compilecache/): ``compile_cache_dir`` (or
``$DL4J_TPU_COMPILE_CACHE``) points the kernel builds at a build cache,
possibly one a fleet shares, so a second boot loads the libraries the
first built; ``start()`` builds the libraries the net's forward (and
its decode engine) needs, all at once, before it warms the ladder, and a
failed build stops the boot. ``aot_manifest`` names a precompile
manifest (``True``: the one in the cache dir), validated at ``start()``
into ``aot_manifest_ok``; a mismatch warns and the boot builds what it
lacks at first use (the same ``nvcc`` and the same kernels). A
``tuning_report`` (compilecache/autotune.py) sets ``max_batch`` and
``batch_window_ms``.

Mesh-parallel serving (``mesh=``, ``model_axis=``, ``data_axis=``,
``tp_rules=``; parallel/inference.py): every rank of the mesh builds the
server over the same weights. The mesh's first rank runs the HTTP front,
the batcher and the fleet; for each coalesced bucket it broadcasts a
header and the bucket, every rank runs the tensor-parallel serving walk
(column shards, arithmetic-free gathers), and it replies. The other
ranks (followers) run the broadcast buckets on a daemon thread from
``start()`` until the leader's ``stop()``; ``wait(timeout)`` joins it
and raises what it raised (``CollectiveTimeoutError`` when the leader is
gone). F32 rows are held bit for bit against the unmeshed ``net.output``
(chip_smoke.py ``--mesh-serving`` probes the card's libraries). As in
the JAX package, a ComputationGraph, ``compute_dtype=`` and ``hot_swap``
on a meshed server raise ``ValueError``; ``min_batch`` is twice the
data axis's size, so each rank's share of a bucket keeps the unmeshed
floor of two rows.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.updater import _map
from deeplearning4j_tpu_torch.observability import distributed as _dist
from deeplearning4j_tpu_torch.observability import goodput as _goodput
from deeplearning4j_tpu_torch.observability import metrics as _obs_metrics
from deeplearning4j_tpu_torch.observability import slo as _slo
from deeplearning4j_tpu_torch.observability import trace as _obs_trace
from deeplearning4j_tpu_torch.scheduling import core as _sched
from deeplearning4j_tpu_torch.serving.batcher import (BatcherDeadError,
                                                      MicroBatcher,
                                                      QueueFullError,
                                                      next_bucket)
from deeplearning4j_tpu_torch.serving.fleet import ReplicaSet
from deeplearning4j_tpu_torch.serving.metrics import (ServingStats,
                                                      decode_metric_families)

_ = MicroBatcher  # re-exported (seed name); replicas are built by ReplicaSet

_next_bucket = next_bucket  # back-compat alias (seed name)

class DeadlineExceededError(RuntimeError):
    """The per-request deadline expired before the result came (HTTP 504)."""


class UnknownSessionError(KeyError):
    """A decode op named a session this server does not hold and carried
    no token history to recover it from (HTTP 404)."""

    def __str__(self):
        return self.args[0] if self.args else ""


class _ServingHTTPServer(ThreadingHTTPServer):
    # a burst of concurrent clients overflows the default backlog of 5
    request_queue_size = 128
    daemon_threads = True


class ModelServer:
    def __init__(self, net, host: str = "127.0.0.1", port: int = 9500,
                 max_batch: int = 1024, batch_window_ms: float = 2.0,
                 max_queue: int = 1024, warmup: bool = True,
                 input_shapes=None, request_timeout_s: float = 300.0,
                 compute_dtype=None, replicas: int = 1, mesh=None,
                 model_axis: str = "model", data_axis=None, tp_rules=None,
                 compile_cache_dir=None, aot_manifest=None,
                 tuning_report=None, decode_engine=None,
                 push_url=None, push_interval_s: float = 2.0,
                 slos=None, scheduler=None):
        if mesh is None and (data_axis is not None
                             or tp_rules is not None):
            raise ValueError("data_axis= and tp_rules= place a mesh-served "
                             "net: pass mesh=")
        if mesh is not None and hasattr(net.conf, "network_inputs"):
            raise ValueError(
                "mesh-parallel serving supports sequential layer stacks; "
                "serve ComputationGraph models replicated")
        if mesh is not None and compute_dtype is not None:
            raise ValueError(
                "mesh serving is the f32 bit-identity path; combine with "
                "compute_dtype via a bf16-policy net instead")
        from deeplearning4j_tpu_torch.compilecache import cache as _ccache
        self.compile_cache_dir = _ccache.configure(compile_cache_dir)
        self.aot_manifest = aot_manifest
        self.aot_manifest_ok = None  # set by start() when a manifest loads
        if tuning_report is not None:
            from deeplearning4j_tpu_torch.compilecache import autotune as _at
            tuned = _at.load_tuned(tuning_report)
            max_batch = tuned["max_batch"]
            batch_window_ms = tuned["batch_window_ms"]
            self.tuned_config = tuned
        else:
            self.tuned_config = None
        self.build_s = None      # start()'s kernel builds, seconds
        self.net = net
        self.host = host
        self.port = port
        self.max_batch = int(max_batch)
        self.warmup = warmup
        self.input_shapes = input_shapes
        self.request_timeout_s = float(request_timeout_s)
        self.warmup_s = None
        self.run_report = None   # goodput RunReport, set by stop()
        self.model_version = 0
        self.swaps_total = 0
        self._swap_lock = threading.Lock()
        self.compute_dtype = compute_dtype
        self._serving_net = None
        if (compute_dtype is not None and compute_dtype
                != net.conf.global_conf.dtype.compute_dtype):
            self._serving_net = self._build_serving_net(compute_dtype)
        self.stats = ServingStats()
        self.mesh = mesh
        self._group = None        # parallel/inference.py, on a mesh
        self._follower = None     # a follower rank's thread
        self.follower_error = None
        min_batch = 2
        forward = self._device_forward
        if mesh is not None:
            from deeplearning4j_tpu_torch.parallel import inference
            self._group = inference.ServingGroup(
                inference.build_tp_output_fn(net, mesh, model_axis,
                                             data_axis=data_axis,
                                             rules=tp_rules), mesh)
            forward = self._group.lead
            if data_axis is not None:
                # power-of-two buckets divide over the axis, each rank's
                # share at least the unmeshed floor of 2 rows (a one-row
                # product can take another GEMM path, and other bits)
                from deeplearning4j_tpu_torch.parallel.mesh import \
                    axis_size
                min_batch = max(min_batch, 2 * axis_size(mesh, data_axis))
        if scheduler is False:
            self.scheduler = None
        elif scheduler is None:
            self.scheduler = _sched.SchedulingCore()
        else:
            self.scheduler = scheduler
        self._fleet = ReplicaSet(
            forward, int(replicas), max_batch=max_batch,
            batch_window_ms=batch_window_ms, max_queue=max_queue,
            min_batch=min_batch, stats=self.stats, scheduler=self.scheduler)
        self.shapes_seen = self._fleet.shapes_seen
        self.decode_engine = decode_engine
        if slos is None:
            slos = _slo.default_serving_slos(p99_bound_ms=float(
                os.environ.get("DL4J_TPU_SLO_P99_MS", "500")))
        self.slo_engine = _slo.SLOEngine(slos) if slos else None
        self.push_url = push_url
        self.push_interval_s = float(push_interval_s)
        self._pusher = None
        self._span_push = None
        self._httpd = None
        self._thread = None
        self._ledger = None
        self._collectors = []

    @property
    def _batcher(self):
        """Replica 0's batcher (the single-batcher surface)."""
        return self._fleet.replicas[0].batcher

    @property
    def fleet(self) -> ReplicaSet:
        return self._fleet

    # ------------------------------------------------------------ device side
    def _build_serving_net(self, compute_dtype):
        """A shadow net over the same configuration with only the policy's
        compute dtype replaced. It holds no parameters of its own:
        ``_device_forward`` hands it the net's live ones each call."""
        gc = self.net.conf.global_conf
        # replace() validates the policy again: an unknown dtype fails here
        gc2 = dataclasses.replace(gc, dtype=dataclasses.replace(
            gc.dtype, compute_dtype=compute_dtype))
        conf2 = dataclasses.replace(self.net.conf, global_conf=gc2)
        return type(self.net)(conf2, device=self.net.device).init(
            structure_only=True)

    @property
    def serving_compute_dtype(self) -> str:
        """The dtype the serving forward computes in."""
        if self.compute_dtype is not None:
            return self.compute_dtype
        return self.net.conf.global_conf.dtype.compute_dtype

    def _device_forward(self, feats):
        """Runs only on a batcher's device thread (and in warm-up)."""
        net = self.net
        if self._serving_net is not None:
            self._serving_net.params = self.net.params
            self._serving_net.state = self.net.state
            net = self._serving_net
        out = net.output(feats[0])
        return out.float().cpu().numpy()

    # ----------------------------------------------------------- live reload
    def _versioned_forward(self, params, state):
        """A forward bound to published weights: a structure-only net of
        the serving configuration (the shadow's when ``compute_dtype``
        is set) of its own, holding ``params`` and ``state``. Nothing on
        the live net is assigned, so replicas mid-swap, some on the old
        version and some on the new, never share a mutated net; and the
        forward runs the kernels the warm-up built."""
        like = self._serving_net if self._serving_net is not None \
            else self.net
        net = type(like)(like.conf, device=self.net.device).init(
            structure_only=True)
        net.params, net.state = params, state

        def forward(feats):
            return net.output(feats[0]).float().cpu().numpy()
        return forward

    def hot_swap(self, publication=None, *, net=None, version=None):
        """Reload the served weights with no gap: a rolling
        ``swap_forward`` over every live replica, each publishing a
        batcher over the new weights and then draining the old one, so
        requests in flight finish on the old weights and new ones run on
        the new.

        ``publication``: a serving.publish.Publication, restored here
        (``load_net``) unless a restored ``net`` is passed. Its
        fingerprint must equal the serving net's (the same parameter
        structure). Refused with a decode engine (its sessions hold KV
        state of the old weights: drain the host instead) and on a mesh
        (its shards are cut when the server is built: boot a replacement).
        Returns ``{version, fingerprint,
        replicas_swapped, swap_s, fresh_compiles}``: ``fresh_compiles``
        is the kernel builds during the swap, 0 on a warmed server."""
        if self.mesh is not None:
            raise ValueError(
                "hot_swap is the single-host replica path; mesh serving "
                "shards params at build time: drain this host and boot "
                "a replacement off the shared compile cache instead")
        if self.decode_engine is not None:
            raise ValueError(
                "hot_swap cannot re-weight live decode sessions (their KV "
                "caches hold the old weights' state): drain the host and "
                "re-prefill the sessions elsewhere")
        from deeplearning4j_tpu_torch.compilecache.manifest import (
            model_fingerprint)
        from deeplearning4j_tpu_torch.serving import publish as _publish
        with self._swap_lock:
            if publication is not None:
                if net is None:
                    net = _publish.load_net(publication.path,
                                            device=self.net.device)
                if version is None:
                    version = publication.version
                expect = publication.fingerprint
            else:
                if net is None:
                    raise ValueError("hot_swap needs a publication or a "
                                     "restored net")
                expect = model_fingerprint(net)
            serving_fp = model_fingerprint(self.net)
            if expect is not None and expect != serving_fp:
                raise ValueError(
                    f"published fingerprint {expect} does not match the "
                    f"serving net's {serving_fp}: a hot swap binds only "
                    "weights of the same parameter structure (another "
                    "architecture needs a new server)")
            dev = self.net.device
            params = _map(lambda t: t.to(dev), net.params)
            state = _map(lambda t: t.to(dev), net.state or {})
            forward = self._versioned_forward(params, state)
            compile0 = _obs_metrics.compile_snapshot()
            t0 = time.perf_counter()
            swapped = 0
            for r in list(self._fleet.replicas):
                if r.status == "dead":
                    continue    # an evicted slot keeps its slot semantics
                self._fleet.swap_forward(r.index, forward)
                swapped += 1
            self.model_version = int(version) if version is not None \
                else self.model_version + 1
            self.swaps_total += 1
            delta = _obs_metrics.compile_delta(compile0)
            return {"version": self.model_version,
                    "fingerprint": serving_fp,
                    "replicas_swapped": swapped,
                    "swap_s": round(time.perf_counter() - t0, 6),
                    "fresh_compiles": delta["count"]}

    def _infer_row_shapes(self):
        """Per-input row shapes for warm-up: ``input_shapes`` if given,
        else what the configuration's input types imply, else the first
        feed-forward layer's ``n_in`` (the JAX package's inference); None
        when nothing says (a recurrent input without a fixed length)."""
        if self.input_shapes is not None:
            return [tuple(s) for s in self.input_shapes]
        from deeplearning4j_tpu_torch.nn.conf.layers import \
            FeedForwardLayerConfig
        from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import \
            BaseRecurrentConfig

        def from_itype(it):
            if it is None:
                return None
            if it.kind in ("feed_forward", "convolutional_flat"):
                return (it.size,)
            if it.kind == "convolutional":
                return (it.height, it.width, it.channels)
            if it.kind == "recurrent" and it.timesteps:
                return (it.timesteps, it.size)
            return None

        def from_conf(lc):
            if (isinstance(lc, FeedForwardLayerConfig)
                    and not isinstance(lc, BaseRecurrentConfig)
                    and getattr(lc, "n_in", None)):
                return (lc.n_in,)
            return None

        conf = self.net.conf
        if hasattr(conf, "network_inputs"):
            its = getattr(conf, "input_types", None)
            if its:
                shapes = [from_itype(it) for it in its]
                return None if any(s is None for s in shapes) else shapes
            shapes = []
            for name in conf.network_inputs:
                s = None
                for v, ins in conf.vertex_inputs.items():
                    if name in ins:
                        s = from_conf(self.net._resolved_confs.get(v))
                        if s is not None:
                            break
                if s is None:
                    return None
                shapes.append(s)
            return shapes
        s = from_itype(getattr(conf, "input_type", None))
        if s is None and getattr(conf, "layers", None):
            s = from_conf(conf.layers[0])
        return None if s is None else [s]

    # ------------------------------------------------------------ inference
    def predict(self, features, trace_id=None, klass=None, tenant=None,
                deadline_ms=None):
        """Enqueue one request and wait for its rows. Requests larger than
        ``max_batch`` go as ``max_batch`` chunks. ``klass`` / ``tenant`` /
        ``deadline_ms`` are the scheduling headers, passed to fleet
        admission. Raises QueueFullError (or its ShedError subclass
        naming the shed class) when admission refuses (HTTP 503)."""
        t0 = time.perf_counter()
        feats = np.asarray(features, np.float32)
        n = feats.shape[0]
        self._fleet.start()
        futures = [self._fleet.submit([feats[i:i + self.max_batch]],
                                      trace_id=trace_id, klass=klass,
                                      tenant=tenant, deadline_ms=deadline_ms)
                   for i in range(0, max(n, 1), self.max_batch)]
        deadline = t0 + self.request_timeout_s
        chunks = []
        for f in futures:
            try:
                chunks.append(f.result(
                    timeout=max(0.0, deadline - time.perf_counter())))
            except _FutureTimeout:
                self.stats.record_timeout()
                raise DeadlineExceededError(
                    f"request exceeded {self.request_timeout_s:g}s "
                    "deadline") from None
        out = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        # the serving NaN sentinel: rows with a non-finite value
        flat = out.reshape(out.shape[0], -1)
        nan_rows = int((~np.isfinite(flat).all(axis=1)).sum())
        if nan_rows:
            self.stats.record_nan_rows(nan_rows)
        self.stats.record_request(n, time.perf_counter() - t0)
        return out

    def decode_op(self, payload, trace_id=None):
        """One ``/decode`` op. The request carries the session's whole
        token history (``ids``), so a ``step`` for a session this server
        does not hold is answered after re-prefilling that history
        (bit-identical, serving/decode.py); with no history it raises
        ``UnknownSessionError``."""
        eng = self.decode_engine
        op = payload.get("op")
        sid = payload["sid"]
        if op == "prefill":
            logits = eng.prefill(sid, payload["ids"], trace_id=trace_id)
            return {"logits": np.asarray(logits).tolist()}
        if op == "step":
            recovered = False
            if sid not in eng.sessions:
                ids = payload.get("ids") or ()
                if not ids:
                    raise UnknownSessionError(
                        f"unknown decode session '{sid}' and no ids "
                        "history to recover from")
                eng.prefill(sid, ids, trace_id=trace_id)
                recovered = True
            logits = eng.step(sid, int(payload["token"]), trace_id=trace_id)
            return {"logits": np.asarray(logits).tolist(),
                    "recovered": recovered}
        if op == "generate":
            ids = payload.get("ids") or ()
            if not ids:
                raise KeyError(f"decode generate for '{sid}' needs ids")
            toks = eng.generate(sid, [int(i) for i in ids],
                                int(payload.get("n_tokens", 0)),
                                trace_id=trace_id)
            return {"tokens": [int(t) for t in toks],
                    "speculative": bool(eng.spec_k)}
        if op == "close":
            return {"closed": eng.close_session(sid)}
        raise ValueError(f"unknown decode op {op!r}")

    def metrics(self) -> dict:
        """The ``/metrics`` JSON payload: the stats snapshot, the replicas'
        rows, the requeue count and the decode engine's ``describe()``."""
        snap = self.stats.snapshot(self.shapes_seen)
        snap["batcher_healthy"] = self._fleet.healthy
        snap["replicas"] = self._fleet.describe()
        snap["requeued_total"] = self._fleet.requeued
        snap["model_version"] = self.model_version
        snap["weight_swaps_total"] = self.swaps_total
        if self.scheduler is not None:
            snap["sched"] = self.scheduler.snapshot()
        if self.decode_engine is not None:
            snap["decode"] = self.decode_engine.describe()
        return snap

    def _push_health(self) -> dict:
        """The health payload each federation push carries: readiness,
        ``server_url`` (the key a FrontDoorRouter joins pushed gauges to
        its proxy target by) and the counters a router's canary gates
        difference."""
        snap = self.stats.snapshot(self.shapes_seen)
        health = {"batcher_healthy": self._fleet.healthy,
                  "server_url": self.url,
                  "model_version": self.model_version,
                  "replicas": self._fleet.describe(),
                  "serving": {
                      "requests_total": snap["requests_total"],
                      "errors_total": snap["errors_total"],
                      "timeouts_total": snap["timeouts_total"],
                      "nan_rows_total": snap["nan_rows_total"],
                      "latency_p99_ms": snap["latency_ms"]["p99"],
                  }}
        if self.decode_engine is not None:
            health["decode"] = self.decode_engine.describe()
        return health

    def health(self):
        """(status code, ``/healthz`` payload)."""
        rows = self._fleet.describe()
        if not self._fleet.healthy:
            return 503, {"status": "unhealthy",
                         "reason": "batcher device thread dead",
                         "replicas": rows}
        n_live = sum(1 for r in rows if r["status"] == "live")
        body = {"status": "ok" if n_live == len(rows) else "degraded",
                "params": int(self.net.num_params()),
                "device": str(self.net.device),
                "model_version": self.model_version,
                "replicas": rows}
        if self.decode_engine is not None:
            body["decode"] = self.decode_engine.describe()
        return 200, body

    # ------------------------------------------------------------ registry
    def _attach_collectors(self):
        """The stats, the replicas' gauges and (with a decode engine) the
        decode families on the unified registry, read at render time."""
        from deeplearning4j_tpu_torch.observability.metrics import \
            MetricFamily
        addr = f"{self.host}:{self.port}"
        self.stats.attach_to_registry(
            labels={"server": addr,
                    "compute_dtype": self.serving_compute_dtype},
            shapes_fn=lambda: self.shapes_seen)
        score = {"live": 1.0, "draining": 0.5, "dead": 0.0}

        def fleet_families():
            tag = _dist.get_identity().tag
            depth = MetricFamily(
                "dl4j_serving_replica_queue_depth", "gauge",
                "Tickets pending per fleet replica (the routing signal)")
            up = MetricFamily(
                "dl4j_serving_replica_up", "gauge",
                "Replica status: 1 live, 0.5 draining, 0 dead")
            for row in self._fleet.describe():
                labels = {"instance": f"{tag}/r{row['replica']}",
                          "server": addr}
                depth.add(row["queue_depth"], labels)
                up.add(score.get(row["status"], 0.0),
                       {**labels, "status": row["status"]})
            requeued = MetricFamily(
                "dl4j_serving_requeued_total", "counter",
                "Tickets resubmitted onto survivors after an eviction")
            requeued.add(self._fleet.requeued, {"server": addr})
            version = MetricFamily(
                "dl4j_serving_model_version", "gauge",
                "Published weight version currently serving (0 = boot "
                "weights, never hot-swapped)")
            version.add(self.model_version, {"server": addr})
            swaps = MetricFamily(
                "dl4j_serving_weight_swaps_total", "counter",
                "Completed zero-downtime weight hot swaps")
            swaps.add(self.swaps_total, {"server": addr})
            return [depth, up, requeued, version, swaps]

        collectors = [fleet_families]
        if self.decode_engine is not None:
            collectors.append(lambda: decode_metric_families(
                self.decode_engine.describe(), {"server": addr}))
        if self.slo_engine is not None:
            def slo_families():
                # each render advances the sliding windows
                self.slo_engine.ingest(self.stats.snapshot(self.shapes_seen))
                return self.slo_engine.families()
            collectors.append(slo_families)
        if self.scheduler is not None:
            collectors.append(
                lambda: self.scheduler.metric_families({"server": addr}))
        reg = _obs_metrics.get_registry()
        for fn in collectors:
            reg.register_collector(fn)
            self._collectors.append((reg, fn))

    def _detach_collectors(self):
        self.stats.detach_from_registry()
        for reg, fn in self._collectors:
            reg.unregister_collector(fn)
        self._collectors = []

    # -------------------------------------------------------------- server
    def _validate_aot_manifest(self, row_shapes):
        """Check the precompile manifest (a path or dict, or ``True``: the
        one in the cache dir) against THIS boot's serving configuration
        and set ``aot_manifest_ok``. A mismatch means the cached libraries
        were built for another program: warn (a boot that believes it is
        warm but builds is a silent cost) and build at first use. Never
        raises."""
        import warnings

        from deeplearning4j_tpu_torch.compilecache import manifest as _man
        from deeplearning4j_tpu_torch.serving.batcher import bucket_ladder
        src = self.aot_manifest
        auto = os.path.join(self.compile_cache_dir, _man.MANIFEST_NAME) \
            if self.compile_cache_dir else None
        if src is None and auto and os.path.exists(auto):
            src = auto
        if src is None:
            return
        try:
            if src is True:
                if auto is None:
                    raise ValueError("aot_manifest=True names the manifest "
                                     "in the compile cache dir; none is set")
                src = auto
            man = src if isinstance(src, dict) else _man.load(src)
            mb = self._batcher
            mismatches = _man.validate_serving(
                man, self.net, row_shapes=row_shapes or (),
                ladder=bucket_ladder(mb.min_batch, mb.max_batch),
                max_batch=mb.max_batch, min_batch=mb.min_batch,
                compute_dtype=self.serving_compute_dtype, mesh=self.mesh)
        except Exception as e:
            mismatches = [f"unreadable manifest: {type(e).__name__}: {e}"]
        self.aot_manifest_ok = not mismatches
        if mismatches:
            warnings.warn(
                "AOT precompile manifest does not match this serving "
                "config — falling back to lazy compile (this boot builds "
                "its kernels at first use): " + "; ".join(mismatches),
                RuntimeWarning, stacklevel=3)

    def _build_kernels(self):
        """Build (or find in the cache) every library the net's forward
        and the decode engine reach, all ``nvcc`` processes at once; a
        failed build raises and stops the boot."""
        from deeplearning4j_tpu_torch.ops import _build
        if self.net.device.type != "cuda":
            return
        t0 = time.perf_counter()
        _build.build(_build.libraries_for(
            self.net, decode=self.decode_engine is not None))
        self.build_s = time.perf_counter() - t0

    @property
    def is_follower(self) -> bool:
        """A mesh rank that runs the leader's buckets and serves no HTTP."""
        return self._group is not None and not self._group.is_leader

    def _follow(self):
        try:
            self._group.follow()
        except BaseException as e:  # noqa: BLE001  re-raised by wait()
            self.follower_error = e

    def wait(self, timeout=None) -> bool:
        """A follower: wait up to ``timeout`` seconds for its loop to end
        on the leader's stop; raises what the loop raised
        (``CollectiveTimeoutError`` when the leader is gone). True when
        it has ended."""
        t = self._follower
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                return False
        if self.follower_error is not None:
            raise self.follower_error
        return True

    def start(self):
        """Build the kernels and warm the bucket ladder (errors propagate:
        a kernel that cannot build or run must stop the boot, not surface
        on the first request), then start the device threads and the HTTP
        listener. A mesh follower starts its loop instead (a daemon
        thread) and returns: the leader's warm-up drives it."""
        compile0 = _obs_metrics.compile_snapshot()
        self._build_kernels()
        if self.is_follower:
            self._follower = threading.Thread(
                target=self._follow, daemon=True, name="mesh-follower")
            self._follower.start()
            return self
        if self.warmup:
            shapes = self._infer_row_shapes()
            self._validate_aot_manifest(shapes)
            if shapes is not None:
                t_warm = time.perf_counter()
                self._fleet.warm(shapes)
                if self.net.device.type == "cuda":
                    torch.cuda.synchronize(self.net.device)
                self.warmup_s = time.perf_counter() - t_warm
        self._fleet.start()
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, *args):
                pass

            def _send(self, body: bytes, code, content_type, headers=()):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200, headers=()):
                self._send(json.dumps(obj).encode(), code,
                           "application/json", headers)

            def do_GET(self):  # noqa: N802
                if self.path.startswith("/healthz"):
                    code, body = server.health()
                    self._json(body, code)
                elif self.path.startswith("/metrics"):
                    if _obs_metrics.wants_prometheus(
                            self.headers.get("Accept", ""), self.path):
                        self._send(_obs_metrics.get_registry()
                                   .render_prometheus().encode(), 200,
                                   _obs_metrics.PROMETHEUS_CONTENT_TYPE)
                    else:
                        self._json(server.metrics())
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):  # noqa: N802
                is_decode = (self.path.startswith("/decode")
                             and server.decode_engine is not None)
                if not self.path.startswith("/predict") and not is_decode:
                    self._json({"error": "not found"}, 404)
                    return
                trace_id = (self.headers.get(_dist.TRACE_HEADER)
                            or _dist.new_trace_id())
                echo = ((_dist.TRACE_HEADER, trace_id),)
                sched = _sched.parse_sched_headers(self.headers)
                echo += ((_sched.PRIORITY_HEADER, sched["klass"]),)
                if sched["tenant"]:
                    echo += ((_sched.TENANT_HEADER, sched["tenant"]),)
                if sched["deadline_ms"] is not None:
                    echo += ((_sched.DEADLINE_HEADER,
                              f"{sched['deadline_ms']:g}"),)
                with _obs_trace.get_tracer().span(
                        "decode_op" if is_decode else "predict_handler",
                        trace_id=trace_id, server_url=server.url):
                    self._handle_post(is_decode, trace_id, echo, sched)

            def _handle_post(self, is_decode, trace_id, echo, sched):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n).decode())
                    if is_decode:
                        self._json(server.decode_op(payload,
                                                    trace_id=trace_id),
                                   headers=echo)
                        return
                    out = server.predict(payload["features"],
                                         trace_id=trace_id, **sched)
                    self._json({"predictions": out.tolist()}, headers=echo)
                except QueueFullError as e:
                    # the shed class: the ShedError's, else a plain
                    # full-queue reject sheds the request's own class
                    shed_k = e.klass if isinstance(e, _sched.ShedError) \
                        else sched["klass"]
                    if not isinstance(e, _sched.ShedError) \
                            and server.scheduler is not None:
                        server.scheduler.record_shed(shed_k)
                    self._json({"error": f"overloaded: {e}"}, 503,
                               headers=(("Retry-After",
                                         f"{server.stats.retry_after_s():g}"
                                         ),
                                        (_sched.SHED_CLASS_HEADER, shed_k))
                               + echo)
                except BatcherDeadError as e:
                    self._json({"error": f"unhealthy: {e}"}, 503,
                               headers=echo)
                except DeadlineExceededError as e:
                    self._json({"error": str(e)}, 504, headers=echo)
                except UnknownSessionError as e:
                    # a routing miss, not a malformed request
                    self._json({"error": str(e)}, 404, headers=echo)
                except Exception as e:  # a bad request: answer 400, keep serving
                    server.stats.record_error()
                    self._json({"error": f"{type(e).__name__}: {e}"}, 400,
                               headers=echo)

        self._httpd = _ServingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        _obs_metrics.install_runtime_metrics()
        self._attach_collectors()
        self._ledger = _goodput.start_run("serving", net=self.net)
        self._ledger.rebase_compile(compile0)
        if self.warmup_s is not None:
            self._ledger.annotate(warmup_s=round(self.warmup_s, 6))
        _dist.stamp_run_marker("serving")
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="model-server-http")
        self._thread.start()
        if self._group is not None:
            self._group.start_heartbeat()
        if self.push_url:
            # request-scoped spans ride the heartbeat pushes, so the
            # router's TraceStore can stitch this host into waterfalls
            self._span_push = _dist.SpanPushBuffer().install()
            self._pusher = _dist.HeartbeatPusher(
                self.push_url, self.push_interval_s,
                health_fn=self._push_health,
                spans_fn=self._span_push.payload).start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self):
        """Stop accepting, then drain: every accepted ticket completes
        before the device threads exit. Closes the serving goodput ledger
        (``run_report``, its ``slo`` the SLO engine's final report). On a
        mesh the leader then sends its followers the stop header; a
        follower waits for its loop (at most the collective timeout)."""
        if self.is_follower:
            self.wait(self._group.timeout_s)
            return
        if self._pusher is not None:
            self._pusher.stop()
            self._pusher = None
        if self._span_push is not None:
            self._span_push.remove()
            self._span_push = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self.decode_engine is not None:
            self.decode_engine.stop()
        self._fleet.stop()
        if self._group is not None:
            self._group.stop()
        self._detach_collectors()
        ledger = self._ledger
        if ledger is not None and self.slo_engine is not None:
            self.slo_engine.ingest(self.stats.snapshot(self.shapes_seen))
            ledger.annotate(slo=self.slo_engine.report())
        if ledger is not None and self.stats.first_reply_unix is not None:
            ledger.annotate(cold_start_s=round(
                self.stats.first_reply_unix
                - _obs_metrics.process_start_unix(), 6))
        report = _goodput.end_run(ledger) if ledger is not None else None
        self._ledger = None
        if report is not None:
            self.run_report = report


def serve(net, host: str = "127.0.0.1", port: int = 9500,
          max_batch: int = 1024, batch_window_ms: float = 2.0,
          max_queue: int = 1024, warmup: bool = True,
          input_shapes=None, request_timeout_s: float = 300.0,
          compute_dtype=None, replicas: int = 1, mesh=None,
          model_axis: str = "model", data_axis=None,
          tp_rules=None, compile_cache_dir=None, aot_manifest=None,
          tuning_report=None, decode_engine=None, push_url=None,
          push_interval_s: float = 2.0, slos=None,
          scheduler=None) -> ModelServer:
    """One-call serving entry point: ``serve(net).url`` is live."""
    return ModelServer(net, host, port, max_batch,
                       batch_window_ms=batch_window_ms, max_queue=max_queue,
                       warmup=warmup, input_shapes=input_shapes,
                       request_timeout_s=request_timeout_s,
                       compute_dtype=compute_dtype, replicas=replicas,
                       mesh=mesh, model_axis=model_axis,
                       data_axis=data_axis, tp_rules=tp_rules,
                       compile_cache_dir=compile_cache_dir,
                       aot_manifest=aot_manifest,
                       tuning_report=tuning_report,
                       decode_engine=decode_engine, push_url=push_url,
                       push_interval_s=push_interval_s,
                       slos=slos, scheduler=scheduler).start()
