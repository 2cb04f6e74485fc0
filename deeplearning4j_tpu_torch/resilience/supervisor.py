"""Fault-tolerant training: a supervisor around ``fit_batch``
(counterpart of deeplearning4j_tpu/resilience/supervisor.py).

- **Periodic checkpointing** to fresh ``step_<n>`` directories
  (utils/checkpoint.py's crash-atomic discipline), an atomically renamed
  ``LATEST`` pointer, and retention GC that keeps the newest
  ``keep_checkpoints`` valid steps.
- **Auto-resume**: a relaunched supervisor restores the newest *valid*
  checkpoint (``find_latest_checkpoint`` skips partial saves) into the
  live net and continues to the same absolute target step.
- **Transient-step retry** with exponential backoff.
- **NaN/Inf sentinel**: a non-finite loss rolls the net back to the last
  good checkpoint and backs off the learning rate (``set_lr_scale``);
  poisoned parameters are never checkpointed. Scores stay 0-d device
  tensors until a check is due, so ``nan_check_every > 1`` reads nothing
  from the card on the step path.
- **Preemption (SIGTERM)**: the in-flight step finishes, a final
  checkpoint is written, and ``run`` returns with status ``preempted``.
- **Asynchronous checkpoints**: the step path pays a device-side
  snapshot (every leaf cloned, a CUDA event recorded after the clones);
  a writer thread waits on the event, copies to the host on a stream of
  its own and writes. The update writes parameters and updater slots in
  place, so the snapshot is this package's counterpart of the JAX
  package's donation-safe copy. Writer errors, injected crashes
  included, surface at the next drain.

- **Streaming sources** (:meth:`TrainingSupervisor.fit_pipeline`): a
  ``datapipe.Pipeline``'s ``state_dict()`` rides in every checkpoint's
  ``meta.json``, taken at the step boundary of the snapshot, so a resume
  or rollback restores the data position with the parameters and a
  relaunched run trains on the record sequence an uninterrupted one
  would. The supervisor pulls batches from the pipeline itself, with no
  prefetching wrapper of its own, so the only batches taken ahead of the
  step are the prefetch stage's, and they are part of the state.

Every recovery action is a :class:`RecoveryEvent`, passed to the net's
listeners (``TrainingListener.on_recovery``), counted in
:class:`ResilienceStats` (rendered by the metrics registry while a run
is attached) and recorded by the crash flight recorder, which flushes
``flight_<tag>.json`` into the checkpoint directory on SIGTERM, NaN
rollback, preemption and crash. A run is a goodput ledger run
(``resilient_fit``): ``SupervisorResult.report`` is its RunReport, also
written as ``run_report.json`` in the checkpoint directory. Spans:
``restore``, ``rollback``, ``checkpoint_snapshot``, ``checkpoint_write``
(on the writer thread when asynchronous) and ``checkpoint_barrier``.

Not ported yet, refused by name (``NotImplementedError``): cross-process
coordination (``coordinate=True``, ``collective_timeout_s``) and the
statistics collector (ROADMAP.md A.5; ``coordinate="auto"`` resolves to
single-process, as the JAX package's does in one process) and the
compile cache (A.4).
"""

from __future__ import annotations

import logging
import math
import os
import shutil
import signal
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.observability import goodput as _goodput
from deeplearning4j_tpu_torch.observability import metrics as _obs_metrics
from deeplearning4j_tpu_torch.observability.trace import (
    get_tracer as _get_tracer)

logger = logging.getLogger("deeplearning4j_tpu_torch")

_LATEST_POINTER = "LATEST"


class TrainingDivergedError(RuntimeError):
    """The NaN sentinel exhausted ``max_nan_rollbacks``: training keeps
    producing non-finite losses even after rollback and LR backoff."""


@dataclass(frozen=True)
class RecoveryEvent:
    """One supervisor action: kind is ``resume`` | ``checkpoint`` |
    ``retry`` | ``rollback`` | ``preempt`` | ``gc`` | ``reshard``."""
    kind: str
    step: int
    detail: str = ""

    def __str__(self):
        return f"[{self.kind} @ step {self.step}] {self.detail}"


class ResilienceStats:
    """Thread-safe recovery counters; ``snapshot()`` is the dict a
    dashboard polls, with the JAX package's keys (``peer_losses_total``
    stays 0 in one process), and ``attach_to_registry`` renders them as
    ``dl4j_resilience_*`` families at scrape time."""

    def __init__(self):
        self._lock = threading.Lock()
        self.resumes = 0
        self.checkpoints = 0
        self.retries = 0
        self.rollbacks = 0
        self.preemptions = 0
        self.gc_removed = 0
        self.nan_check_lag = 0
        self.reshards = 0
        self.peer_losses = 0

    def bump(self, counter: str, n: int = 1):
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)

    def note_nan_check_lag(self, lag: int):
        """Record how many steps behind the lazy NaN sentinel was when it
        read a score (max over the run; 0 = checked at the step
        boundary)."""
        with self._lock:
            self.nan_check_lag = max(self.nan_check_lag, int(lag))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "resumes_total": self.resumes,
                "checkpoints_total": self.checkpoints,
                "retries_total": self.retries,
                "rollbacks_total": self.rollbacks,
                "preemptions_total": self.preemptions,
                "checkpoints_gc_total": self.gc_removed,
                "nan_check_lag_max": self.nan_check_lag,
                "reshards_total": self.reshards,
                "peer_losses_total": self.peer_losses,
            }

    # ------------------------------------------- unified-registry bridge
    # the counters stay the source of truth; the registry renders them
    # at scrape time

    _HELP = {
        "resumes_total": "Runs resumed from a checkpoint",
        "checkpoints_total": "Checkpoints committed",
        "retries_total": "Transient step failures retried",
        "rollbacks_total": "NaN/Inf rollbacks to the last good checkpoint",
        "preemptions_total": "Clean preemption exits",
        "checkpoints_gc_total": "Old/partial checkpoints removed by GC",
        "nan_check_lag_max": "Max steps the lazy NaN sentinel lagged",
        "reshards_total": "Resumes that re-laid the run onto a "
                          "different fleet size",
        "peer_losses_total": "Consensus timeouts naming a dead peer "
                             "(the run exited with status peer_lost)",
    }

    def metric_families(self, labels=None):
        from deeplearning4j_tpu_torch.observability.metrics import (
            MetricFamily)

        L = dict(labels or {})
        out = []
        for key, value in self.snapshot().items():
            kind = "gauge" if key == "nan_check_lag_max" else "counter"
            out.append(MetricFamily(f"dl4j_resilience_{key}", kind,
                                    self._HELP[key]).add(value, L))
        return out

    def attach_to_registry(self, registry=None, *, labels=None):
        from deeplearning4j_tpu_torch.observability.metrics import (
            get_registry)

        self.detach_from_registry()
        reg = registry if registry is not None else get_registry()

        def _collect():
            return self.metric_families(labels)

        reg.register_collector(_collect)
        self._registry, self._collector = reg, _collect
        return reg

    def detach_from_registry(self):
        reg = getattr(self, "_registry", None)
        if reg is not None:
            reg.unregister_collector(self._collector)
            self._registry = self._collector = None


def _default_retry_on():
    from deeplearning4j_tpu_torch.resilience.faultinject import (
        TransientStepError)
    return (TransientStepError,)


@dataclass
class SupervisorConfig:
    """Knobs for one supervised run (the JAX package's fields and
    defaults)."""

    checkpoint_dir: str
    checkpoint_every_steps: int = 100
    keep_checkpoints: int = 3
    resume: bool = True
    #: exception types treated as transient and retried with backoff;
    #: anything else propagates immediately
    retry_on: tuple = field(default_factory=_default_retry_on)
    max_step_retries: int = 3
    backoff_initial_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 5.0
    #: multiply the learning rate by this after each NaN rollback
    nan_lr_backoff: float = 0.5
    max_nan_rollbacks: int = 3
    #: check the loss for NaN/Inf every n steps. Scores stay 0-d device
    #: tensors and are read (a wait on the card) only at the check
    #: boundary, before every checkpoint snapshot (so poison is never
    #: checkpointed) and at exit; 1 checks every step, larger values
    #: trade detection lag (``nan_check_lag_max``) for a step path that
    #: never waits on the card. 0 disables the sentinel.
    nan_check_every: int = 1
    #: write checkpoints on a background thread; the step path pays only
    #: the device-side snapshot. The write is drained (joined, its error
    #: raised) at the next save, NaN rollback, preemption and exit.
    async_checkpoints: bool = True
    handle_sigterm: bool = True
    #: keep a crash flight recorder (observability.flightrec) installed
    #: for the run: recent spans + recovery events, flushed atomically
    #: to flight_<instance>.json in checkpoint_dir on SIGTERM, NaN
    #: rollback, preemption and crash
    flight_recorder: bool = True
    #: the compile cache waits for ROADMAP.md A.4; a value raises
    compile_cache_dir: Optional[str] = None
    #: cross-process consensus waits for ROADMAP.md A.5 (parallel/):
    #: "auto" and False run single-process, True raises
    coordinate: object = "auto"
    #: the consensus deadline waits for ROADMAP.md A.5; a value raises
    collective_timeout_s: Optional[float] = None
    #: injectable for tests (real runs sleep through backoff)
    sleep_fn: Callable[[float], None] = time.sleep

    def __post_init__(self):
        if self.coordinate is True:
            raise NotImplementedError(
                "SupervisorConfig(coordinate=True): cross-process "
                "consensus waits for ROADMAP.md A.5 (parallel/)")
        if self.collective_timeout_s is not None:
            raise NotImplementedError(
                "SupervisorConfig(collective_timeout_s=...): the consensus "
                "deadline waits for ROADMAP.md A.5 (parallel/)")
        if self.compile_cache_dir is not None:
            raise NotImplementedError(
                "SupervisorConfig(compile_cache_dir=...): the compile "
                "cache waits for ROADMAP.md A.4 (compilecache/)")


@dataclass
class SupervisorResult:
    status: str                    # "completed" | "preempted"
    final_step: int
    resumed_from: Optional[str]
    events: List[RecoveryEvent]
    stats: dict
    #: goodput.RunReport for the whole supervised run (None when the
    #: goodput engine is disabled); also saved as run_report.json in the
    #: checkpoint dir
    report: Optional[object] = None
    #: a lost peer is a multi-process outcome (ROADMAP.md A.5): always None
    peer_loss: Optional[dict] = None


class TrainingSupervisor:
    """Wraps ``fit_batch`` of a MultiLayerNetwork or ComputationGraph in
    the checkpoint/recovery loop. The core entry point is :meth:`run` (a
    deterministic ``batch_fn(step) -> DataSet`` and an absolute target
    step: exactly resumable, because the data of step *i* does not depend
    on how many times the process died); :meth:`fit` adapts the (data,
    labels, epochs, batch_size) surface onto it."""

    def __init__(self, net, config: SupervisorConfig, *, injector=None,
                 stats_collector=None):
        if stats_collector is not None:
            raise NotImplementedError(
                "TrainingSupervisor(stats_collector=...): the training "
                "statistics collector waits for ROADMAP.md A.5 (parallel/)")
        self.net = net
        self.config = config
        self.injector = injector
        self.stats = ResilienceStats()
        self.events: List[RecoveryEvent] = []
        self._preempt_requested = False
        self._last_good: Optional[str] = None
        #: the background writer: at most ONE write in flight
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_pending: Optional[dict] = None
        #: (step, 0-d device score) pairs not yet NaN-checked
        self._pending_scores: List[tuple] = []
        #: datapipe.Pipeline being supervised (fit_pipeline): its
        #: state_dict rides in every checkpoint's meta.json and is
        #: restored alongside the net on resume/rollback
        self._pipeline = None
        self._resumed_from: Optional[str] = None
        #: goodput ledger of the active run (a reshard lands on the
        #: RunReport through it)
        self._ledger = None
        os.makedirs(config.checkpoint_dir, exist_ok=True)
        #: crash flight recorder (black box): best-effort, its absence
        #: must never break training
        self.flight = None
        if config.flight_recorder:
            try:
                from deeplearning4j_tpu_torch.observability.flightrec import (
                    install_flight_recorder)
                self.flight = install_flight_recorder(
                    dir=config.checkpoint_dir)
            except Exception:
                self.flight = None

    def _flight_flush(self, reason: str, exc=None) -> Optional[str]:
        """Flush the black box (best-effort; returns the artifact path)."""
        if self.flight is None:
            return None
        try:
            return self.flight.flush(reason, exc=exc)
        except Exception:
            return None

    def _preempt_exit(self, detail: str):
        """After the preemption's save: its event and the black box, timed
        with the save's barrier (the flush writes the flight file, which
        the ledger would otherwise leave untracked)."""
        with _get_tracer().span("checkpoint_barrier"):
            self._emit("preempt", self.net.iteration, detail,
                       counter="preemptions")
            self._flight_flush("preemption")

    # --------------------------------------------------------------- events
    def _emit(self, kind: str, step: int, detail: str = "",
              counter: Optional[str] = None):
        ev = RecoveryEvent(kind, step, detail)
        self.events.append(ev)
        if counter:
            self.stats.bump(counter)
        if self.flight is not None:
            try:  # the black box sees every recovery event
                self.flight.record_event(kind, step, detail)
            except Exception:
                pass
        logger.info("resilience %s", ev)
        for l in getattr(self.net, "listeners", ()):
            on_recovery = getattr(l, "on_recovery", None)
            if on_recovery is not None:
                on_recovery(self.net, ev)
        return ev

    # ----------------------------------------------------------- checkpoint
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.config.checkpoint_dir, f"step_{step}")

    def _write_latest_pointer(self, path: str):
        # the rename is the commit point: the pointer never names a
        # half-written checkpoint
        tmp = os.path.join(self.config.checkpoint_dir,
                           "." + _LATEST_POINTER + ".tmp")
        with open(tmp, "w") as f:
            f.write(os.path.basename(path))
        os.replace(tmp, os.path.join(self.config.checkpoint_dir,
                                     _LATEST_POINTER))

    def _checkpoint(self, step: int, reason: str, wait: bool = False) -> str:
        """Checkpoint the net's current state. With ``async_checkpoints``
        the step path pays only ``snapshot_for_checkpoint``; the write,
        the meta.json rename and the LATEST pointer happen on a writer
        thread. The previous write is drained first (one writer at a
        time), and ``wait=True`` (preemption and final saves) drains this
        one too. Writer errors, injected crashes from the faultinject
        seam included, surface at the next drain, as a synchronous save's
        would in place."""
        from deeplearning4j_tpu_torch.utils.checkpoint import (
            save_checkpoint, snapshot_for_checkpoint)
        tracer = _get_tracer()
        self._drain_checkpoint()
        path = self._step_dir(step)
        if not self.config.async_checkpoints:
            with tracer.span("checkpoint_write", step=step, reason=reason):
                save_checkpoint(self.net, path, extra_meta=self._extra_meta())
                self._write_latest_pointer(path)
                self._commit_checkpoint(step, reason, path)
            return path
        pending = {"step": step, "reason": reason, "path": path,
                   "error": None}
        with tracer.span("checkpoint_snapshot", step=step):
            # the data half of the snapshot: the pipeline's state is taken
            # here on the main thread, at the step boundary of the
            # device-side copy, so the writer gets plain data
            extra = self._extra_meta()
            snap = snapshot_for_checkpoint(self.net)

            def write():
                # runs on dl4j-ckpt-writer: its span lands in that
                # thread's trace lane, beside the main loop's steps
                try:
                    with tracer.span("checkpoint_write", step=step,
                                     reason=reason):
                        save_checkpoint(snap, path, extra_meta=extra)
                        self._write_latest_pointer(path)
                except BaseException as e:  # kept for the drain barrier
                    pending["error"] = e

            # the hand-off is part of the step path's cost: the new
            # writer takes the interpreter lock at once and the main
            # thread gets it back only after a switch interval (~5 ms)
            t = threading.Thread(target=write, name="dl4j-ckpt-writer",
                                 daemon=True)
            self._ckpt_pending = pending
            self._ckpt_thread = t
            t.start()
        if wait:
            self._drain_checkpoint()
        return path

    def _extra_meta(self):
        """The checkpoint's ``extra_meta``: the supervised pipeline's
        ``state_dict()`` (fit_pipeline), else None."""
        if self._pipeline is None:
            return None
        return {"datapipe": self._pipeline.state_dict()}

    def _commit_checkpoint(self, step: int, reason: str, path: str):
        """Post-write bookkeeping (main thread only): rollback target,
        event and counter, retention GC."""
        self._last_good = path
        self._emit("checkpoint", step, f"{reason} -> {path}",
                   counter="checkpoints")
        self._gc(step)

    def _drain_checkpoint(self, raise_errors: bool = True):
        """Barrier on the in-flight background write (a no-op when idle).
        On success the checkpoint becomes the rollback target; on failure
        the stored exception (e.g. an InjectedCrash between the tree
        commit and the meta rename) is raised here."""
        t, pending = self._ckpt_thread, self._ckpt_pending
        if t is None:
            return
        timeout_s = float(os.environ.get(
            "DL4J_TPU_CKPT_JOIN_TIMEOUT_S", "600"))
        with _get_tracer().span("checkpoint_barrier"):
            t.join(timeout=timeout_s)
            self._ckpt_thread = None
            self._ckpt_pending = None
            if t.is_alive():
                # a wedged writer (dead filesystem) must not freeze
                # training: fail the drain and leave the daemon thread to
                # the interpreter
                err = TimeoutError(
                    f"checkpoint writer did not finish within {timeout_s:g}s"
                    " (DL4J_TPU_CKPT_JOIN_TIMEOUT_S)")
            else:
                err = pending["error"]
            if err is None:
                # the commit's bookkeeping and retention GC are the
                # barrier's main-thread work
                self._commit_checkpoint(pending["step"], pending["reason"],
                                        pending["path"])
        if err is not None:
            if raise_errors:
                raise err
            logger.error("async checkpoint write for %s failed: %r",
                         pending["path"], err)

    def _gc(self, current_step: int):
        """Retention: keep the newest ``keep_checkpoints`` valid steps, and
        sweep partial saves older than the newest valid one (they can never
        be resumed from)."""
        from deeplearning4j_tpu_torch.utils.checkpoint import (
            _STEP_DIR, is_valid_checkpoint)
        root = self.config.checkpoint_dir
        entries = []
        for name in os.listdir(root):
            m = _STEP_DIR.match(name)
            if m:
                entries.append((int(m.group(1)), os.path.join(root, name)))
        entries.sort()
        valid = [(s, p) for s, p in entries if is_valid_checkpoint(p)]
        keep = {p for _, p in valid[-max(1, self.config.keep_checkpoints):]}
        newest_valid = valid[-1][0] if valid else -1
        removed = 0
        for step, path in entries:
            partial = not is_valid_checkpoint(path)
            if path in keep or (partial and step >= newest_valid):
                continue
            shutil.rmtree(path, ignore_errors=True)
            removed += 1
        if removed:
            self.stats.bump("gc_removed", removed)
            self._emit("gc", current_step,
                       f"removed {removed} old/partial checkpoint(s)")

    def _load_into(self, path: str):
        """Restore ``path`` INTO the live net: its trees are replaced by
        the checkpoint's (on the net's device) and its counters set, so
        user references to the net stay valid. A captured step copies the
        replaced leaves into its own tensors before its next replay, and
        the device iteration refills from ``net.iteration``
        (nn/multistep.py).

        Under ``fit_pipeline`` the pipeline's state comes back too. A
        shard cursor saved for another ``(n, i)`` than the live
        pipeline's is re-cut at the coverage rule's low-water mark
        (datapipe/reshard.py), emitted as a ``reshard`` event and stamped
        onto the RunReport."""
        from deeplearning4j_tpu_torch.utils.checkpoint import (
            _checked_meta, _net_kind, read_checkpoint_trees)
        net = self.net
        meta = _checked_meta(os.path.abspath(path), _net_kind(net))
        trees = read_checkpoint_trees(path, net, net.device)
        net.params = trees["params"]
        net.state = trees["state"]
        net.opt_state = trees["opt_state"]
        net.iteration = int(meta["iteration"])
        net.epoch = int(meta["epoch"])
        self._last_good = path
        if self._pipeline is None:
            return
        if "datapipe" not in meta:
            logger.warning(
                "checkpoint %s carries no datapipe state; the pipeline "
                "keeps its current position", path)
            return
        from deeplearning4j_tpu_torch.datapipe.reshard import (
            remap_for, shard_position)
        dp_state = meta["datapipe"]
        old_pos = shard_position(dp_state)
        try:
            self._pipeline.load_state_dict(dp_state)
            return
        except ValueError:
            # a shard cursor baked for another fleet size: re-cut the
            # stream at the coverage rule's low-water mark
            remapped = remap_for(self._pipeline, dp_state)
        self._pipeline.load_state_dict(remapped)
        new_pos = shard_position(remapped)
        detail = {"datapipe": {"from": old_pos and dict(zip("nik", old_pos)),
                               "to": new_pos and dict(zip("nik", new_pos))}}
        self._emit("reshard", net.iteration,
                   f"datapipe shard cursor {old_pos} re-cut to {new_pos} "
                   f"from {path}", counter="reshards")
        if self._ledger is not None:
            self._ledger.annotate(reshard=detail)

    # ------------------------------------------------------------- stepping
    def request_preemption(self):
        """Ask for a clean stop at the next step boundary (what the
        SIGTERM handler calls; tests and the fault injector call it
        directly)."""
        self._preempt_requested = True

    def _sigterm(self, signum, frame):
        logger.warning("SIGTERM received: will checkpoint and exit at "
                       "the next step boundary")
        # flush the black box NOW: if the sender escalates to SIGKILL
        # before the clean boundary, the post-mortem already exists
        self._flight_flush("sigterm")
        self.request_preemption()

    def _attempt_step(self, ds, step: int):
        """One fit_batch with transient-failure retry and exponential
        backoff. The injector's before_step hook runs inside the retried
        region, so injected transients exercise this exact path."""
        cfg = self.config
        delay = cfg.backoff_initial_s
        attempt = 0
        while True:
            try:
                if self.injector is not None:
                    self.injector.before_step(self, self.net, step)
                return self.net.fit_batch(ds)
            except cfg.retry_on as e:
                err = e
            attempt += 1
            if attempt > cfg.max_step_retries:
                raise err
            self._emit(
                "retry", step,
                f"attempt {attempt}/{cfg.max_step_retries} after "
                f"{type(err).__name__}: {err}; backoff {delay:.3f}s",
                counter="retries")
            cfg.sleep_fn(delay)
            delay = min(delay * cfg.backoff_factor, cfg.backoff_max_s)

    def _flush_nan_checks(self):
        """Read every pending score (the wait on the card happens HERE,
        not on the step path) and return the first non-finite ``(step,
        value)``, or None. The detection lag, how many steps ran past a
        score before it was read, goes to ``nan_check_lag``. The reads
        are a ``score_sync`` span, the fit loops' name for the host's
        wait on a score, so the ledger attributes the wait."""
        pending, self._pending_scores = self._pending_scores, []
        bad = None
        now = self.net.iteration
        with _get_tracer().span("score_sync", steps=len(pending)):
            for step, score in pending:
                self.stats.note_nan_check_lag(now - (step + 1))
                if bad is None and not math.isfinite(float(score)):
                    bad = (step, float(score))
        return bad

    def _agreed_bad(self):
        """The NaN decision: in one process, the local flush."""
        return self._flush_nan_checks()

    def _rollback(self, step: int, score: float, rollbacks: int):
        cfg = self.config
        # the poisoned trajectory's unread scores are moot after the
        # restore, and the writer must be idle before _last_good is read
        self._pending_scores.clear()
        self._drain_checkpoint()
        if rollbacks > cfg.max_nan_rollbacks:
            raise TrainingDivergedError(
                f"loss is non-finite ({score}) at step {step} even after "
                f"{cfg.max_nan_rollbacks} rollback(s) with LR backoff "
                f"x{cfg.nan_lr_backoff} each; giving up rather than "
                "checkpointing poisoned parameters")
        if self._last_good is None:
            raise TrainingDivergedError(
                f"loss is non-finite ({score}) at step {step} and no good "
                "checkpoint exists to roll back to")
        new_scale = getattr(self.net, "_lr_scale", 1.0) * cfg.nan_lr_backoff
        with _get_tracer().span("rollback", step=step):
            self._load_into(self._last_good)
        if hasattr(self.net, "set_lr_scale"):
            self.net.set_lr_scale(new_scale)
        self._emit("rollback", self.net.iteration,
                   f"non-finite loss ({score}) at step {step}; restored "
                   f"{self._last_good}, lr scale now {new_scale:g}",
                   counter="rollbacks")
        self._flight_flush("nan_rollback")

    # ------------------------------------------------------------ main loop
    def _open_run(self):
        """What a run starts with: the runtime metrics, this supervisor's
        counters in the registry (attached after the run too, so a later
        scrape still reports them), the goodput ledger and, with
        ``resume``, the newest valid checkpoint restored. Returns the
        ledger and the checkpoint resumed from (or None)."""
        from deeplearning4j_tpu_torch.utils.checkpoint import (
            find_latest_checkpoint)
        cfg = self.config
        _obs_metrics.install_runtime_metrics()
        self.stats.attach_to_registry(
            labels={"job": os.path.basename(
                os.path.normpath(cfg.checkpoint_dir))})
        ledger = _goodput.start_run("resilient_fit", net=self.net)
        self._ledger = ledger
        if cfg.resume:
            # the search reads the newest meta.json (with a pipeline's
            # state, megabytes): it is part of the restore's span
            t0 = time.perf_counter()
            latest = find_latest_checkpoint(cfg.checkpoint_dir)
            if latest is not None:
                self._load_into(latest)
                _get_tracer().record("restore", t0, time.perf_counter())
                return ledger, latest
        return ledger, None

    def _close_run(self, ledger, status: str) -> SupervisorResult:
        report = _goodput.end_run(
            ledger, status=status, save_to=self._report_path())
        return SupervisorResult(
            status=status, final_step=self.net.iteration,
            resumed_from=self._resumed_from, events=list(self.events),
            stats=self.stats.snapshot(), report=report)

    def _on_exit(self, ledger):
        """The exit barrier of a run's ``finally``: with an exception
        already propagating, the writer's own error must not mask it
        (join and log only), the black box is flushed and the ledger
        closed as failed."""
        self._drain_checkpoint(raise_errors=False)
        if sys.exc_info()[0] is not None:
            self._flight_flush("exception", exc=sys.exc_info()[1])
            _goodput.end_run(ledger, status="failed")

    def _signal_handler(self):
        """Installs the SIGTERM handler (main thread only); returns what
        to restore, or None."""
        if not (self.config.handle_sigterm
                and threading.current_thread() is threading.main_thread()):
            return None
        return (signal.signal(signal.SIGTERM, self._sigterm),)

    def run(self, batch_fn: Callable[[int], object],
            target_step: int) -> SupervisorResult:
        """Train until ``net.iteration == target_step``, feeding
        ``batch_fn(step)`` at each step. Resumable: relaunching with the
        same arguments continues from the newest valid checkpoint to the
        same final step."""
        cfg = self.config
        net = self.net
        ledger, self._resumed_from = self._open_run()
        if self._resumed_from is not None:
            self._emit("resume", net.iteration,
                       f"restored {self._resumed_from}", counter="resumes")

        old_handler = self._signal_handler()
        rollbacks = 0
        status = "completed"
        try:
            if self._last_good is None and net.iteration < target_step:
                # baseline save: the NaN sentinel needs a rollback target
                # from the first step, and a crash before the first
                # periodic save must not lose the initialization
                self._checkpoint(net.iteration, "baseline")

            while True:
                if self._preempt_requested:
                    status = "preempted"
                    break
                if net.iteration >= target_step:
                    # tail flush: the last chunk of unread scores may hold
                    # poison; a rollback rewinds the iteration and
                    # re-enters
                    bad = self._agreed_bad()
                    if bad is not None:
                        rollbacks += 1
                        self._rollback(bad[0], bad[1], rollbacks)
                        continue
                    break
                step = net.iteration
                score = self._attempt_step(batch_fn(step), step)
                if cfg.nan_check_every > 0:
                    self._pending_scores.append((step, score))
                due_check = (cfg.nan_check_every > 0
                             and net.iteration % cfg.nan_check_every == 0)
                due_ckpt = (net.iteration % cfg.checkpoint_every_steps == 0
                            and net.iteration < target_step)
                if (due_check or due_ckpt) and self._pending_scores:
                    # every score up to here is read and finite BEFORE a
                    # snapshot is taken: poison is never checkpointed
                    bad = self._agreed_bad()
                    if bad is not None:
                        rollbacks += 1
                        self._rollback(bad[0], bad[1], rollbacks)
                        continue
                if due_ckpt:
                    self._checkpoint(net.iteration, "periodic")

            if status == "preempted":
                bad = self._agreed_bad()
                if bad is not None:
                    # never checkpoint poison, even on the way out
                    rollbacks += 1
                    self._rollback(bad[0], bad[1], rollbacks)
                self._checkpoint(net.iteration, "preemption", wait=True)
                self._preempt_exit(f"clean exit at step {net.iteration} of "
                                   f"{target_step}")
            else:
                self._drain_checkpoint()  # settle _last_good first
                if self._last_good != self._step_dir(net.iteration):
                    self._checkpoint(net.iteration, "final", wait=True)
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler[0])
            self._on_exit(ledger)
        return self._close_run(ledger, status)

    def _report_path(self) -> str:
        """``run_report.json`` in the checkpoint dir (rank-suffixed off
        rank 0 in a multi-process run)."""
        from deeplearning4j_tpu_torch.observability.distributed import (
            rank_suffix)
        return os.path.join(self.config.checkpoint_dir,
                            f"run_report{rank_suffix()}.json")

    # ------------------------------------------------------- pipeline loop
    def fit_pipeline(self, pipeline, *, epochs: int = 1) -> SupervisorResult:
        """Supervise training over a ``datapipe.Pipeline``, the
        streaming-source twin of :meth:`run`. The pipeline's
        ``state_dict()`` rides in every checkpoint's ``meta.json``
        (taken at the step boundary of the snapshot), so resume and NaN
        rollback restore the data position (epoch, source cursor,
        shuffle RNG and window, partial batch buffers, prefetched
        batches) alongside the parameters: a killed-and-relaunched run
        trains on the exact record sequence an uninterrupted one would.
        Completion is data-driven (the stream runs out of epochs) rather
        than an absolute target step.

        Before a restore or rollback the live stream is closed (its
        prefetch worker stopped), so no batch taken from the old stream
        is trained on after it; the batches the worker had buffered are
        in the checkpoint's state and come back from there."""
        cfg = self.config
        net = self.net
        self._pipeline = pipeline
        ledger, self._resumed_from = self._open_run()
        if self._resumed_from is not None:
            self._emit("resume", net.iteration,
                       f"restored {self._resumed_from} (datapipe epoch "
                       f"{pipeline.epoch})", counter="resumes")

        old_handler = self._signal_handler()
        stream = None

        def invalidate_stream():
            # close the live generator chain FIRST (stops the prefetch
            # worker mid-pull), so a restore never races a worker still
            # mutating upstream stage state
            nonlocal stream
            if stream is not None:
                stream.close()
                stream = None

        rollbacks = 0
        status = "completed"
        try:
            if self._last_good is None:
                # baseline save: a rollback target from the first step,
                # with the pipeline's start-of-run state
                self._checkpoint(net.iteration, "baseline")

            while True:
                if self._preempt_requested:
                    status = "preempted"
                    break
                if stream is None:
                    stream = pipeline.stream(epochs)
                ds = next(stream, None)
                if ds is None:
                    # stream exhausted, but the unread scores may hold
                    # poison; a rollback rewinds the data position too
                    # and re-enters with a new stream
                    bad = self._agreed_bad()
                    if bad is not None:
                        rollbacks += 1
                        invalidate_stream()
                        self._rollback(bad[0], bad[1], rollbacks)
                        continue
                    break
                step = net.iteration
                score = self._attempt_step(ds, step)
                if cfg.nan_check_every > 0:
                    self._pending_scores.append((step, score))
                due_check = (cfg.nan_check_every > 0
                             and net.iteration % cfg.nan_check_every == 0)
                due_ckpt = net.iteration % cfg.checkpoint_every_steps == 0
                if (due_check or due_ckpt) and self._pending_scores:
                    bad = self._agreed_bad()
                    if bad is not None:
                        rollbacks += 1
                        invalidate_stream()
                        self._rollback(bad[0], bad[1], rollbacks)
                        continue
                if due_ckpt:
                    self._checkpoint(net.iteration, "periodic")

            if status == "preempted":
                bad = self._agreed_bad()
                if bad is not None:
                    rollbacks += 1
                    invalidate_stream()
                    self._rollback(bad[0], bad[1], rollbacks)
                # park the prefetch worker so the saved pipeline state is
                # the final word on the data position
                invalidate_stream()
                self._checkpoint(net.iteration, "preemption", wait=True)
                self._preempt_exit(f"clean exit at step {net.iteration} "
                                   f"(datapipe epoch {pipeline.epoch} of "
                                   f"{epochs})")
            else:
                self._drain_checkpoint()  # settle _last_good first
                if self._last_good != self._step_dir(net.iteration):
                    self._checkpoint(net.iteration, "final", wait=True)
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler[0])
            invalidate_stream()
            # the pipeline reports only while consumed: back-to-back runs
            # over fresh pipelines must not pile stale families up
            pipeline.stats.detach_from_registry()
            self._on_exit(ledger)
        return self._close_run(ledger, status)

    # ----------------------------------------------------------- fit facade
    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 32) -> SupervisorResult:
        """The ``fit``-shaped entry: materializes the batch sequence and
        supervises to the absolute step ``epochs * len(batches)``, so a
        killed-and-relaunched run lands on the SAME final step as an
        uninterrupted one. A ``datapipe.Pipeline`` goes to
        :meth:`fit_pipeline` instead (streamed, never materialized; its
        data position checkpointed)."""
        from deeplearning4j_tpu_torch.datapipe.core import Pipeline
        if isinstance(data, Pipeline):
            return self.fit_pipeline(data, epochs=epochs)
        batches = _materialize_batches(data, labels, batch_size)
        if not batches:
            raise ValueError("no training batches")
        target = epochs * len(batches)
        return self.run(lambda step: batches[step % len(batches)], target)


def _materialize_batches(data, labels, batch_size):
    """(data, labels) | DataSet | MultiDataSet | iterator -> list of
    batches, so ``batch_fn(step)`` is the same across restarts."""
    from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                           MultiDataSet)
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ArrayDataSetIterator, DataSetIterator)
    if isinstance(data, (DataSet, MultiDataSet)):
        return [data]
    if isinstance(data, DataSetIterator):
        batches = list(data)
        data.reset()
        return batches
    return list(ArrayDataSetIterator(data, labels, batch_size=batch_size))


def resilient_fit(net, data, labels=None, *, checkpoint_dir: str,
                  epochs: int = 1, batch_size: int = 32, injector=None,
                  stats_collector=None, **config_kw) -> SupervisorResult:
    """One-call supervised training: ``resilient_fit(net, x, y,
    checkpoint_dir=...)`` trains with checkpoint/resume, retry, NaN
    rollback and preemption handling. ``config_kw`` feeds
    SupervisorConfig (checkpoint_every_steps, keep_checkpoints, ...)."""
    cfg = SupervisorConfig(checkpoint_dir=checkpoint_dir, **config_kw)
    sup = TrainingSupervisor(net, cfg, injector=injector,
                             stats_collector=stats_collector)
    return sup.fit(data, labels, epochs=epochs, batch_size=batch_size)
