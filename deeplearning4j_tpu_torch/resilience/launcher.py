"""Elastic fleet launcher: spawn, watch, and relaunch a coordinated
multi-process training fleet — shrinking it when workers die
(counterpart of deeplearning4j_tpu/resilience/launcher.py).

The single-process supervisor (``supervisor.py``) survives faults
*inside* one process. This module owns the layer above: a parent that
spawns ``N`` coordinator-addressed worker processes, watches their
exits, and — when the fleet fails — relaunches it at a (possibly
smaller) size so training resumes from the last fleet-wide checkpoint
via the elastic reshard path (the supervisor's restore +
``datapipe/reshard.remap_for``).

Division of labour on a worker death:

- the **dead** worker leaves nothing behind (no partial checkpoint —
  the barriered meta commit in ``utils/checkpoint.py`` guarantees the
  last *complete* checkpoint is the newest restorable one);
- each **surviving** worker detects the loss as a consensus timeout
  (``parallel.distributed.PeerLostError``), flushes a ``peer_lost``
  flight record, and exits with :data:`PEER_LOST_EXIT` — it does NOT
  attempt a solo checkpoint, which would fork history;
- the **launcher** (this module) observes the non-zero exits, gives
  stragglers a short grace window to notice the loss themselves, kills
  any that don't, then relaunches the fleet at
  ``max(min_size, size // 2)`` with a fresh coordinator port and a
  bumped ``DL4J_TPU_INCARNATION`` (so consensus keys from the dead
  incarnation can never collide with the new one).

Per-worker environment (set on top of the parent's):

- ``DL4J_TPU_RUN_ID`` — one id for the whole fleet across relaunches,
  so observability artifacts correlate;
- ``DL4J_TPU_INSTANCE=worker-<rank>`` — per-member identity;
- ``DL4J_TPU_INCARNATION=<launch index>`` — consensus key namespace;
- ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` — what
  ``parallel.distributed.initialize()`` reads when it is called without
  arguments (workers may still pass the argv coordinates explicitly);
- ``CUDA_VISIBLE_DEVICES`` when ``total_devices`` is set — the launcher
  keeps the *global* card count constant across shrinks: each of
  ``size`` workers sees ``K = total_devices // size`` cards, worker
  ``r`` the cards ``[r K, (r + 1) K)``. ``total_devices=None`` leaves
  the variable alone, so every worker sees every card (two workers on
  one card share it over gloo);
- ``DL4J_TPU_COMPILE_CACHE`` when ``compile_cache_dir`` is set — the
  fleet shares one kernel build cache (compilecache/), so a worker loads
  the libraries an earlier build left there instead of running ``nvcc``
  itself (build them before the launch, so workers never compile at
  once), and relaunched workers boot warm.

The launcher itself never imports torch: worker argv construction is
delegated to a ``build_argv(size, rank, coordinator)`` callable, so the
monitoring/relaunch logic is unit-testable with plain ``python -c``
workers (``tests/test_torch_launcher.py``). The end-to-end drill with
real workers is ``chip_smoke.py``'s ``[coordinated]`` phase
(``python3 chip_smoke.py --coordinated``).
"""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = [
    "PEER_LOST_EXIT",
    "WorkerRecord",
    "LaunchRecord",
    "FleetResult",
    "FleetLauncher",
    "free_port",
]

logger = logging.getLogger(__name__)

#: exit status a worker uses when it detected a LOST PEER (consensus
#: timeout) and shut down cleanly without checkpointing. Distinct from
#: a generic failure so the launcher (and operators reading logs) can
#: tell "I died" from "somebody else died and I noticed".
PEER_LOST_EXIT = 43


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (the usual bind-then-close race is
    fine here: each launch gets a fresh port, collisions just fail the
    launch and the next relaunch picks another)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


@dataclass
class WorkerRecord:
    """One worker process within one launch."""
    rank: int
    pid: int
    returncode: Optional[int] = None
    duration_s: Optional[float] = None
    #: True when the launcher had to SIGKILL it (straggler past grace)
    killed: bool = False

    @property
    def peer_lost(self) -> bool:
        return self.returncode == PEER_LOST_EXIT


@dataclass
class LaunchRecord:
    """One spawn-to-exit cycle of the whole fleet."""
    index: int                  # launch number == DL4J_TPU_INCARNATION
    size: int
    coordinator: str
    workers: List[WorkerRecord] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return bool(self.workers) and all(
            w.returncode == 0 for w in self.workers)

    @property
    def failed_ranks(self) -> List[int]:
        return [w.rank for w in self.workers if w.returncode != 0]

    @property
    def peer_lost_ranks(self) -> List[int]:
        return [w.rank for w in self.workers if w.peer_lost]


@dataclass
class FleetResult:
    """Outcome of :meth:`FleetLauncher.run`."""
    status: str                 # "completed" | "failed"
    final_size: int
    launches: List[LaunchRecord]

    @property
    def relaunches(self) -> int:
        return max(0, len(self.launches) - 1)


class FleetLauncher:
    """Spawn ``size`` coordinated workers, monitor them, and relaunch
    (shrunk) on failure.

    ``build_argv(size, rank, coordinator)`` returns the argv for one
    worker; everything else — ports, env, monitoring, shrink policy —
    is the launcher's job.
    """

    def __init__(self, build_argv: Callable[[int, int, str], List[str]],
                 *,
                 min_size: int = 1,
                 max_launches: int = 8,
                 shrink_on_failure: bool = True,
                 straggler_grace_s: float = 30.0,
                 launch_timeout_s: float = 600.0,
                 poll_interval_s: float = 0.05,
                 total_devices: Optional[int] = None,
                 host: str = "127.0.0.1",
                 run_id: Optional[str] = None,
                 extra_env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None,
                 log_dir: Optional[str] = None,
                 compile_cache_dir: Optional[str] = None):
        self.build_argv = build_argv
        self.min_size = max(1, int(min_size))
        self.max_launches = int(max_launches)
        self.shrink_on_failure = bool(shrink_on_failure)
        self.straggler_grace_s = float(straggler_grace_s)
        self.launch_timeout_s = float(launch_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self.total_devices = total_devices
        self.host = host
        self.run_id = run_id or f"fleet-{os.getpid()}-{int(time.time())}"
        self.extra_env = dict(extra_env or {})
        self.cwd = cwd
        self.log_dir = log_dir
        self.compile_cache_dir = compile_cache_dir

    # ------------------------------------------------------------- env
    def _worker_env(self, size: int, rank: int, launch_index: int,
                    coordinator: Optional[str] = None) -> dict:
        env = dict(os.environ)
        env.update(self.extra_env)
        env["DL4J_TPU_RUN_ID"] = self.run_id
        env["DL4J_TPU_INSTANCE"] = f"worker-{rank}"
        env["DL4J_TPU_INCARNATION"] = str(launch_index)
        env["WORLD_SIZE"] = str(size)
        env["RANK"] = str(rank)
        if coordinator is not None:
            addr, _, port = coordinator.rpartition(":")
            env["MASTER_ADDR"] = addr
            env["MASTER_PORT"] = port
        if self.compile_cache_dir:
            # the whole fleet shares ONE kernel build cache: the parent's
            # (or the first worker's) builds are every later worker's,
            # and every RELAUNCHED worker's, loads
            env["DL4J_TPU_COMPILE_CACHE"] = self.compile_cache_dir
        if self.total_devices:
            if self.total_devices % size:
                raise ValueError(
                    f"total_devices={self.total_devices} not divisible "
                    f"by fleet size {size}")
            k = self.total_devices // size
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                str(c) for c in range(rank * k, (rank + 1) * k))
        return env

    # ----------------------------------------------------------- launch
    def launch_once(self, size: int, launch_index: int = 0) -> LaunchRecord:
        """One spawn-to-exit cycle: start ``size`` workers against a
        fresh coordinator port, wait for all of them, killing stragglers
        once the grace window after the first failure expires."""
        size = int(size)
        coord = f"{self.host}:{free_port(self.host)}"
        rec = LaunchRecord(index=launch_index, size=size, coordinator=coord)
        logger.info("fleet launch %d: %d worker(s), coordinator %s",
                    launch_index, size, coord)

        procs: List[subprocess.Popen] = []
        logs = []
        start = time.monotonic()
        try:
            for rank in range(size):
                argv = self.build_argv(size, rank, coord)
                out = None
                if self.log_dir:
                    os.makedirs(self.log_dir, exist_ok=True)
                    out = open(os.path.join(
                        self.log_dir,
                        f"worker-l{launch_index}-r{rank}.log"), "wb")
                    logs.append(out)
                procs.append(subprocess.Popen(
                    argv, env=self._worker_env(size, rank, launch_index,
                                               coord),
                    cwd=self.cwd, stdout=out,
                    stderr=subprocess.STDOUT if out else None))
                rec.workers.append(WorkerRecord(rank=rank,
                                                pid=procs[-1].pid))

            self._monitor(procs, rec, start)
        finally:
            for fh in logs:
                fh.close()
        dur = time.monotonic() - start
        logger.info("fleet launch %d finished in %.1fs: codes %s%s",
                    launch_index, dur,
                    [w.returncode for w in rec.workers],
                    (f" (peer_lost on ranks {rec.peer_lost_ranks})"
                     if rec.peer_lost_ranks else ""))
        return rec

    def _monitor(self, procs, rec: LaunchRecord, start: float) -> None:
        grace_deadline = None
        hard_deadline = start + self.launch_timeout_s
        while True:
            now = time.monotonic()
            alive = False
            for proc, w in zip(procs, rec.workers):
                if w.returncode is not None:
                    continue
                code = proc.poll()
                if code is None:
                    alive = True
                    continue
                w.returncode = code
                w.duration_s = now - start
                if code != 0 and grace_deadline is None:
                    # first casualty: peers get a grace window to detect
                    # the loss via consensus timeout and exit themselves
                    # (with PEER_LOST_EXIT) before we resort to SIGKILL
                    grace_deadline = now + self.straggler_grace_s
                    logger.warning(
                        "worker rank %d exited %d; giving peers %.1fs "
                        "to detect the loss", w.rank, code,
                        self.straggler_grace_s)
            if not alive:
                return
            past_grace = grace_deadline is not None and now > grace_deadline
            if past_grace or now > hard_deadline:
                for proc, w in zip(procs, rec.workers):
                    if w.returncode is None and proc.poll() is None:
                        logger.error(
                            "killing straggler rank %d (pid %d)",
                            w.rank, proc.pid)
                        proc.kill()
                        proc.wait()
                        w.returncode = proc.returncode
                        w.duration_s = time.monotonic() - start
                        w.killed = True
                return
            time.sleep(self.poll_interval_s)

    # -------------------------------------------------------------- run
    def next_size(self, size: int) -> int:
        """The fleet size after a failed launch at ``size``."""
        if not self.shrink_on_failure:
            return size
        return max(self.min_size, size // 2)

    def run(self, initial_size: int) -> FleetResult:
        """Launch the fleet and keep relaunching (shrunk on failure)
        until a launch completes cleanly or ``max_launches`` is spent.
        Workers are expected to resume from the shared checkpoint dir
        themselves (``SupervisorConfig.resume=True`` + elastic reshard
        restore), so each relaunch continues rather than restarts."""
        size = max(self.min_size, int(initial_size))
        launches: List[LaunchRecord] = []
        for index in range(self.max_launches):
            rec = self.launch_once(size, launch_index=index)
            launches.append(rec)
            if rec.ok:
                return FleetResult(status="completed", final_size=size,
                                   launches=launches)
            new_size = self.next_size(size)
            logger.warning(
                "fleet launch %d failed (ranks %s); relaunching at "
                "size %d", index, rec.failed_ranks, new_size)
            size = new_size
        return FleetResult(status="failed", final_size=size,
                           launches=launches)


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m deeplearning4j_tpu_torch.resilience.launcher -n 2 --
    CMD``
    — run ``CMD`` as each worker, with ``{size}``, ``{rank}`` and
    ``{coordinator}`` placeholders substituted in its arguments."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("-n", "--size", type=int, default=2)
    ap.add_argument("--min-size", type=int, default=1)
    ap.add_argument("--max-launches", type=int, default=8)
    ap.add_argument("--total-devices", type=int, default=None)
    ap.add_argument("--compile-cache-dir", default=None,
                    help="shared kernel build cache dir exported to every "
                         "worker as DL4J_TPU_COMPILE_CACHE")
    ap.add_argument("--grace", type=float, default=30.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="worker command (after --)")
    args = ap.parse_args(argv)
    cmd = [c for c in args.cmd if c != "--"]
    if not cmd:
        ap.error("no worker command given (put it after --)")

    def build_argv(size, rank, coordinator):
        subs = {"size": size, "rank": rank, "coordinator": coordinator}
        return [c.format(**subs) for c in cmd]

    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    result = FleetLauncher(
        build_argv, min_size=args.min_size,
        max_launches=args.max_launches, total_devices=args.total_devices,
        compile_cache_dir=args.compile_cache_dir,
        straggler_grace_s=args.grace).run(args.size)
    print(f"[launcher] {result.status} after {len(result.launches)} "
          f"launch(es), final size {result.final_size}")
    return 0 if result.status == "completed" else 1


if __name__ == "__main__":
    sys.exit(main())
