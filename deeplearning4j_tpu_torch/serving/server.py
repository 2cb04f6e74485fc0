"""Continuous-batching HTTP inference server (counterpart of
deeplearning4j_tpu/serving/server.py, with one batcher: no replica set,
mesh, decode engine, hot swap, scheduler or Prometheus exposition yet).

HTTP handler threads enqueue tickets into a bounded queue; one device
thread (serving/batcher.py) coalesces what is pending into one padded
power-of-two bucket forward through ``net.output`` and scatters the rows
back. On a CUDA net that forward runs the port's kernels.

Endpoints:
- ``POST /predict`` {"features": [[...]]} -> {"predictions": ...}
- ``GET /healthz``  liveness + parameter count
- ``GET /metrics``  the ServingStats snapshot (JSON)

``start()`` warms the bucket ladder from ``input_shapes`` (or the row
shape the configuration implies) before it accepts traffic. A full queue
answers 503 with ``Retry-After``; ``stop()`` drains accepted work first.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.batcher import (BatcherDeadError,
                                                      MicroBatcher,
                                                      QueueFullError)
from deeplearning4j_tpu_torch.serving.metrics import ServingStats


class DeadlineExceededError(RuntimeError):
    """The per-request deadline expired before the result came (HTTP 504)."""


class _ServingHTTPServer(ThreadingHTTPServer):
    # a burst of concurrent clients overflows the default backlog of 5
    request_queue_size = 128
    daemon_threads = True


class ModelServer:
    def __init__(self, net, host: str = "127.0.0.1", port: int = 9500,
                 max_batch: int = 1024, batch_window_ms: float = 2.0,
                 max_queue: int = 1024, warmup: bool = True,
                 input_shapes=None, request_timeout_s: float = 300.0):
        self.net = net
        self.host = host
        self.port = port
        self.max_batch = int(max_batch)
        self.warmup = warmup
        self.input_shapes = input_shapes
        self.request_timeout_s = float(request_timeout_s)
        self.warmup_s = None
        self.stats = ServingStats()
        self._batcher = MicroBatcher(
            self._device_forward, max_batch=max_batch,
            batch_window_ms=batch_window_ms, max_queue=max_queue,
            min_batch=2, stats=self.stats)
        self.shapes_seen = self._batcher.shapes_seen
        self._httpd = None
        self._thread = None

    # ------------------------------------------------------------ device side
    def _device_forward(self, feats):
        """Runs only on the batcher's device thread (and in warm-up)."""
        out = self.net.output(feats[0])
        return out.float().cpu().numpy()

    def _infer_row_shapes(self):
        """Per-input row shapes for warm-up: ``input_shapes`` if given,
        else what the configuration's input type implies; None when
        neither says (a recurrent input without a fixed length)."""
        if self.input_shapes is not None:
            return [tuple(s) for s in self.input_shapes]
        it = getattr(self.net.conf, "input_type", None)
        if it is None:
            return None
        if it.kind in ("feed_forward", "convolutional_flat"):
            return [(it.size,)]
        if it.kind == "recurrent" and it.timesteps:
            return [(it.timesteps, it.size)]
        return None

    # ------------------------------------------------------------ inference
    def predict(self, features):
        """Enqueue one request and wait for its rows. Requests larger than
        ``max_batch`` go as ``max_batch`` chunks. Raises QueueFullError
        when admission control refuses (HTTP 503)."""
        t0 = time.perf_counter()
        feats = np.asarray(features, np.float32)
        n = feats.shape[0]
        self._batcher.start()
        futures = [self._batcher.submit([feats[i:i + self.max_batch]])
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
        self.stats.record_request(n, time.perf_counter() - t0)
        return out

    def metrics(self) -> dict:
        snap = self.stats.snapshot(self.shapes_seen)
        snap["batcher_healthy"] = self._batcher.healthy
        return snap

    # -------------------------------------------------------------- server
    def start(self):
        """Warm the bucket ladder (errors propagate: a kernel that cannot
        run must stop the boot, not surface on the first request), then
        start the device thread and the HTTP listener."""
        if self.warmup:
            shapes = self._infer_row_shapes()
            if shapes is not None:
                t_warm = time.perf_counter()
                self._batcher.warm(shapes)
                if self.net.device.type == "cuda":
                    torch.cuda.synchronize(self.net.device)
                self.warmup_s = time.perf_counter() - t_warm
        self._batcher.start()
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, *args):
                pass

            def _json(self, obj, code=200, headers=()):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path.startswith("/healthz"):
                    if not server._batcher.healthy:
                        self._json({"status": "unhealthy",
                                    "reason": "batcher device thread dead"},
                                   503)
                        return
                    self._json({"status": "ok",
                                "params": int(server.net.num_params()),
                                "device": str(server.net.device)})
                elif self.path.startswith("/metrics"):
                    self._json(server.metrics())
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):  # noqa: N802
                if not self.path.startswith("/predict"):
                    self._json({"error": "not found"}, 404)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n).decode())
                    out = server.predict(payload["features"])
                    self._json({"predictions": out.tolist()})
                except QueueFullError as e:
                    self._json({"error": f"overloaded: {e}"}, 503,
                               headers=(("Retry-After",
                                         f"{server.stats.retry_after_s():g}"
                                         ),))
                except BatcherDeadError as e:
                    self._json({"error": f"unhealthy: {e}"}, 503)
                except DeadlineExceededError as e:
                    self._json({"error": str(e)}, 504)
                except Exception as e:  # a bad request: answer 400, keep serving
                    server.stats.record_error()
                    self._json({"error": f"{type(e).__name__}: {e}"}, 400)

        self._httpd = _ServingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="model-server-http")
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self):
        """Stop accepting, then drain: every accepted ticket completes
        before the device thread exits."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._batcher.stop()
