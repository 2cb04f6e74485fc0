"""Deterministic fault injection for the resilience runtime (counterpart
of deeplearning4j_tpu/resilience/faultinject.py).

Every recovery path the TrainingSupervisor implements is exercised by
tests through this harness rather than hoped for:

- :meth:`FaultInjector.crash_during_save` — raise :class:`InjectedCrash`
  between the tree commit and the ``meta.json`` rename (the
  ``_POST_COMMIT_HOOK`` seam in utils/checkpoint.py), leaving exactly
  the partial-save footprint a real preemption leaves.
- :meth:`FaultInjector.fail_step` — raise :class:`TransientStepError`
  the first *times* attempts of a given step (exercises
  retry-with-backoff).
- :meth:`FaultInjector.poison_step` — replace one parameter leaf with
  NaN before a given step, so the step produces a non-finite loss
  (exercises the sentinel rollback + LR backoff).
- :meth:`FaultInjector.preempt_at_step` — request a clean preemption at
  a step boundary (exercises the SIGTERM path without relying on signal
  delivery timing); :meth:`sigterm_at_step` delivers a real SIGTERM to
  the process instead.
- :meth:`FaultInjector.kill_at_step` / :meth:`hang_at_step` — REAL
  process death (SIGKILL: no handlers, no cleanup) and a stall longer
  than the collective timeout; with ``rank=`` these target one fleet
  member.

Every planner accepts ``rank=`` (default None = every process): the
fault fires only on the process whose rank in the process group matches
(parallel/distributed.py; rank 0 when no group is up), so one plan,
built the same way on every rank, expresses "kill rank 1 at step 5"
without per-process branching.

Faults are keyed by absolute step / save index, so a plan replays
identically across process restarts: a chaos run (chip_smoke.py's
``[resilient]``) relies on that to land on the uninterrupted run's exact
parameters.
"""

from __future__ import annotations

import signal as _signal
from contextlib import contextmanager


def _on_this_rank(rank) -> bool:
    """True when a fault planned for ``rank`` should fire here (None =
    everywhere): this process's rank in the group, 0 without one."""
    if rank is None:
        return True
    from deeplearning4j_tpu_torch.parallel import distributed
    return distributed.process_info()["process_index"] == int(rank)


class InjectedCrash(BaseException):
    """Simulated process death. Deliberately a BaseException: nothing in
    the supervisor (or any library ``except Exception``) may swallow it,
    exactly like a real SIGKILL."""


class TransientStepError(RuntimeError):
    """A step failure worth retrying (the injected stand-in for flaky
    device/runtime errors)."""


class FaultInjector:
    """A deterministic fault plan. Plan with the ``*_at``/``*_step``
    methods, pass the injector to the TrainingSupervisor, and wrap the
    run in :meth:`installed` when the plan includes save crashes (that
    arms the checkpoint post-commit hook)."""

    def __init__(self):
        self._step_failures = {}      # step -> [remaining raises, rank]
        self._poison_steps = {}       # step -> [remaining poisons, rank]
        self._preempt_steps = {}      # step -> rank (clean preemption)
        self._sigterm_steps = {}      # step -> rank (real SIGTERM)
        self._kill_steps = {}         # step -> (rank, signal)
        self._hang_steps = {}         # step -> (seconds, rank)
        self._crash_saves = set()     # save index -> crash post-commit
        self._save_index = 0
        self.log: list[tuple] = []    # (fault, step/index) actually fired

    # ------------------------------------------------------------- planning
    def fail_step(self, step: int, times: int = 1, rank=None):
        """Raise TransientStepError on the first ``times`` attempts of
        ``step`` (attempt times+1 then succeeds — retry fodder). With
        ``rank=k`` only process k raises (its peers must still back off
        with it — the coordinated-retry path)."""
        self._step_failures[int(step)] = [int(times), rank]
        return self

    def poison_step(self, step: int, times: int = 1, rank=None):
        """Before ``step`` (its first ``times`` attempts), set one
        parameter leaf to NaN — the fused step then yields a non-finite
        loss, like a gradient blow-up or corrupted device buffer. With
        ``rank=k`` only process k is poisoned (its peers must still roll
        back with it in lockstep)."""
        self._poison_steps[int(step)] = [int(times), rank]
        return self

    def preempt_at_step(self, step: int, rank=None):
        """Request a clean preemption once ``step`` is reached (the
        supervisor finishes the in-flight step, checkpoints, exits).
        With ``rank=k`` the request lands on one process; consensus
        broadcasts it fleet-wide."""
        self._preempt_steps[int(step)] = rank
        return self

    def sigterm_at_step(self, step: int, rank=None):
        """Deliver a real SIGTERM to this process at ``step`` — the
        supervisor's installed handler must turn it into a clean
        checkpoint-and-exit."""
        self._sigterm_steps[int(step)] = rank
        return self

    def kill_at_step(self, step: int, rank=None, sig=_signal.SIGKILL):
        """REAL process death at ``step``: SIGKILL (default) gives no
        handler a chance — exactly the footprint of an OOM-killed or
        hard-preempted fleet member. Fires at the step boundary (before
        the step's collective), so surviving peers detect the loss as a
        consensus timeout, not a wedged psum."""
        self._kill_steps[int(step)] = (rank, sig)
        return self

    def hang_at_step(self, step: int, seconds: float, rank=None):
        """Stall this process ``seconds`` at ``step`` — longer than the
        collective timeout, a hang is indistinguishable from death to
        the peers (and the hung process finds them gone when it wakes)."""
        self._hang_steps[int(step)] = (float(seconds), rank)
        return self

    def crash_during_save(self, save_index: int):
        """Crash the ``save_index``-th checkpoint save (0-based, counted
        while :meth:`installed` is active) between the tree commit and
        the meta.json rename — the window that yields a partial save."""
        self._crash_saves.add(int(save_index))
        return self

    # ------------------------------------------------------ checkpoint seam
    @contextmanager
    def installed(self):
        """Arm the utils/checkpoint.py post-commit hook for the duration
        of the block (save-crash faults only fire while armed)."""
        from deeplearning4j_tpu_torch.utils import checkpoint
        prev = checkpoint._POST_COMMIT_HOOK
        checkpoint._POST_COMMIT_HOOK = self._post_commit
        try:
            yield self
        finally:
            checkpoint._POST_COMMIT_HOOK = prev

    def _post_commit(self, path: str):
        idx = self._save_index
        self._save_index += 1
        if idx in self._crash_saves:
            self._crash_saves.discard(idx)
            self.log.append(("crash_save", idx))
            raise InjectedCrash(
                f"injected crash between tree commit and meta rename "
                f"(save #{idx}, {path})")

    # -------------------------------------------------------- step-time hook
    def before_step(self, supervisor, net, step: int):
        """Called by the supervisor inside the retried region, once per
        attempt of ``step``. Rank-targeted faults fire only on their
        process; the plan itself is identical everywhere."""
        if step in self._hang_steps:
            seconds, rank = self._hang_steps.pop(step)
            if _on_this_rank(rank):
                self.log.append(("hang", step))
                import time
                time.sleep(seconds)
        if step in self._kill_steps:
            rank, sig = self._kill_steps.pop(step)
            if _on_this_rank(rank):
                self.log.append(("kill", step))
                import os
                os.kill(os.getpid(), sig)
        if step in self._sigterm_steps:
            rank = self._sigterm_steps.pop(step)
            if _on_this_rank(rank):
                self.log.append(("sigterm", step))
                import os
                os.kill(os.getpid(), _signal.SIGTERM)
        if step in self._preempt_steps:
            rank = self._preempt_steps.pop(step)
            if _on_this_rank(rank):
                self.log.append(("preempt", step))
                supervisor.request_preemption()
        poison = self._poison_steps.get(step)
        if poison is not None and poison[0] > 0:
            poison[0] -= 1
            if _on_this_rank(poison[1]):
                self.log.append(("poison", step))
                _poison_params(net)
        fail = self._step_failures.get(step)
        if fail is not None and fail[0] > 0:
            fail[0] -= 1
            if _on_this_rank(fail[1]):
                self.log.append(("transient", step))
                raise TransientStepError(f"injected transient failure at "
                                         f"step {step}")


def _poison_params(net):
    """Replace one parameter leaf (first layer, first tensor) with NaN, as
    a new tensor in a new tree: a captured step copies a replaced leaf in
    before its next replay (nn/multistep.py's ``_rebind``)."""
    import torch
    params = dict(net.params)
    name = next(iter(params))
    sub = dict(params[name])
    key = next(iter(sub))
    sub[key] = torch.full_like(sub[key], float("nan"))
    params[name] = sub
    net.params = params
