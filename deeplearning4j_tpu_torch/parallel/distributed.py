"""Multi-process distributed training on ``torch.distributed``
(counterpart of deeplearning4j_tpu/parallel/distributed.py, the DP-2 tier).

Replaces the reference's Spark parameter-averaging scaleout
(ParameterAveragingTrainingMaster.executeTraining: broadcast params ->
workers fit local minibatches -> aggregate -> divide -> rebroadcast) with
one process per rank, each on its own device, running the SAME train
step on its local slice of the batch; the gradients are averaged by one
all-reduce inside the step (parallel/data_parallel.py). There is no
driver and no parameter copy per round.

**The backend is named, never switched.** NCCL when each rank has a card
of its own; gloo on the CPU. NCCL refuses two ranks on one card, so ranks
that share a card run gloo over CUDA tensors, and only where the caller
names ``backend="gloo"``: ``initialize`` raises rather than pick another
backend than the one asked for or implied.

**Consensus** (``agree_decision``, ``any_process``, ``barrier``) runs on
the process group's key-value store with a deadline
(``collective_timeout_s``, ``DL4J_TPU_COLLECTIVE_TIMEOUT_S``): a dead peer
raises :class:`PeerLostError` naming it instead of hanging forever. Keys
are scoped by ``DL4J_TPU_INCARNATION`` and a per-name round counter, so
every process derives the same round without talking. The store is
hosted by rank 0's process: when it is gone, a round fails at once and
names rank 0.

**Collectives with a dead peer.** The group is created with the
collective timeout as its own (``initialize``), so a gloo or NCCL
collective whose peer died raises within the deadline rather than after
gloo's 30 minutes; ``check_peers`` turns such an error into
:class:`PeerLostError` by asking every peer for a consensus round.
``shutdown`` lets rank 0, the store's host, leave last.
"""

from __future__ import annotations

import datetime
import logging
import os
import threading
import time
import warnings

import torch
import torch.distributed as dist

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = [
    "initialize", "shutdown", "process_info", "is_multiprocess",
    "sync_check", "device", "agree_decision", "any_process", "barrier",
    "check_peers",
    "collective_timeout_s", "consensus_available",
    "CollectiveTimeoutError", "PeerLostError", "MultiProcessLocalSGD",
    "DEFAULT_COLLECTIVE_TIMEOUT_S",
]

#: default for DL4J_TPU_COLLECTIVE_TIMEOUT_S — how long a consensus
#: round waits for every peer before declaring one lost
DEFAULT_COLLECTIVE_TIMEOUT_S = 60.0


class CollectiveTimeoutError(RuntimeError):
    """A cross-process consensus call did not complete within the
    collective timeout (``DL4J_TPU_COLLECTIVE_TIMEOUT_S``)."""


class PeerLostError(CollectiveTimeoutError):
    """A consensus round timed out waiting for specific peer processes
    — they are presumed dead (crashed, killed, or hung past the
    collective timeout)."""

    def __init__(self, msg: str, *, lost_ranks=(), elapsed_s=None,
                 round_name: str = ""):
        super().__init__(msg)
        self.lost_ranks = list(lost_ranks)
        self.elapsed_s = elapsed_s
        self.round_name = round_name


def collective_timeout_s() -> float:
    """The consensus/barrier deadline: env ``DL4J_TPU_COLLECTIVE_TIMEOUT_S``
    (seconds), else :data:`DEFAULT_COLLECTIVE_TIMEOUT_S`."""
    raw = os.environ.get("DL4J_TPU_COLLECTIVE_TIMEOUT_S")
    if raw:
        try:
            return max(0.1, float(raw))
        except ValueError:
            logger.warning("ignoring malformed "
                           "DL4J_TPU_COLLECTIVE_TIMEOUT_S=%r", raw)
    return DEFAULT_COLLECTIVE_TIMEOUT_S


# ------------------------------------------------------------ the group
_DEVICE = None
_ALREADY_UP_WARNED = False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               device=None, timeout_s: float | None = None):
    """Join the process group: ``coordinator_address`` ("host:port", else
    ``MASTER_ADDR``/``MASTER_PORT``), ``num_processes`` (else
    ``WORLD_SIZE``, else 1) and ``process_id`` (else ``RANK``, else 0).

    ``device`` is this rank's device: default the card
    ``cuda:<rank % cards>``; "cpu" on request. ``backend`` defaults to
    NCCL on a card and gloo on the CPU; NCCL with more ranks than cards
    raises (name ``backend="gloo"`` for ranks sharing a card).
    ``timeout_s`` is the group's collective timeout, by default
    ``collective_timeout_s()``. Returns :func:`process_info`. Idempotent: a second call warns once and
    returns the running group's info."""
    global _DEVICE, _ALREADY_UP_WARNED
    if dist.is_initialized():
        if not _ALREADY_UP_WARNED:
            _ALREADY_UP_WARNED = True
            warnings.warn(
                "parallel.distributed.initialize(): the process group is "
                "already up; returning its process_info()", RuntimeWarning,
                stacklevel=2)
        return process_info()
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}"
                               f":{os.environ.get('MASTER_PORT', '29500')}")
    from deeplearning4j_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and (device is None or dev.index is None):
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend='nccl' runs on cards; this rank's "
                             f"device is {dev}")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"NCCL needs a card per rank: {world} ranks, {cards} "
                f"card(s). Ranks that share a card must name "
                f"backend='gloo'")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # the group's own timeout is the collective timeout: a collective
    # with a dead peer raises within the deadline, not gloo's 30 minutes
    if timeout_s is None:
        timeout_s = collective_timeout_s()
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev
    _reset_rounds()
    return process_info()


def shutdown() -> None:
    """Leave the process group (no-op when none is up). Rank 0 hosts the
    store, so it leaves last: every other rank marks its exit in the
    store and rank 0 waits for the marks (at most the collective
    timeout; a dead peer's missing mark only costs the wait)."""
    global _DEVICE
    if dist.is_initialized():
        if is_multiprocess():
            base = f"dl4j/{_key_prefix()}/exit"
            rank, count = dist.get_rank(), dist.get_world_size()
            try:
                store = _store()
                if rank != 0:
                    store.set(f"{base}/{rank}", "1")
                else:
                    store.wait([f"{base}/{p}" for p in range(1, count)],
                               datetime.timedelta(
                                   seconds=collective_timeout_s()))
            except Exception as e:
                logger.warning("shutdown: exit marks incomplete (%s)", e)
        dist.destroy_process_group()
    _DEVICE = None


def device() -> torch.device:
    """This rank's device (the one ``initialize`` chose); the CPU when no
    group is up."""
    return _DEVICE if _DEVICE is not None else torch.device("cpu")


def _comm_device() -> torch.device:
    """Where a collective's buffers live: the card under NCCL, else the
    CPU (gloo takes CUDA tensors only for all_reduce and broadcast)."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return device()
    return torch.device("cpu")


def process_info() -> dict:
    up = dist.is_initialized()
    return {"process_index": dist.get_rank() if up else 0,
            "process_count": dist.get_world_size() if up else 1,
            "backend": dist.get_backend() if up else None,
            "device": str(device())}


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def consensus_available() -> bool:
    """True when the consensus layer can talk: more than one process in
    an initialized group."""
    return is_multiprocess()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).contiguous().view(torch.uint8)


def sync_check(tree) -> bool:
    """True iff every process holds bit-identical leaves (COLLECTIVE)."""
    from deeplearning4j_tpu_torch.nn.updater import _leaves
    ok = True
    comm = _comm_device()
    for leaf in _leaves(tree):
        if leaf is None:
            continue
        t = leaf.detach().to(comm).contiguous()
        got = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(got, t)
        ok = ok and all(torch.equal(_bits(g), _bits(got[0])) for g in got)
    return ok


# -------------------------------------------------------------- consensus
# Round counters: every process makes the SAME sequence of consensus
# calls per name (SPMD discipline), so a per-process monotonic counter
# yields the same round number everywhere without any coordination.
_round_lock = threading.Lock()
_rounds: dict = {}


def _next_round(name: str) -> int:
    with _round_lock:
        n = _rounds.get(name, 0)
        _rounds[name] = n + 1
        return n


def _reset_rounds() -> None:
    """Forget round counters (a fresh group)."""
    with _round_lock:
        _rounds.clear()


def _key_prefix() -> str:
    # incarnation-scoped so a relaunched fleet reusing one store never
    # collides with a previous launch's keys
    return os.environ.get("DL4J_TPU_INCARNATION", "0")


def _store():
    return dist.distributed_c10d._get_default_store()


def _lost(store, keys) -> list:
    """The ranks whose key is missing; [0] when the store itself cannot
    be reached (its host, rank 0, is gone)."""
    try:
        return [i for i, k in enumerate(keys) if not store.check([k])]
    except Exception:
        return [0]


def _rendezvous(base: str, value: str, timeout_s: float, what: str,
                name: str):
    """Publish ``value`` under ``base/<rank>`` and wait for every rank's
    key. Raises :class:`PeerLostError` naming the ranks not heard from
    within ``timeout_s`` (rank 0 when the store is unreachable). Returns
    (store, keys)."""
    count, rank = dist.get_world_size(), dist.get_rank()
    keys = [f"{base}/{p}" for p in range(count)]
    t0 = time.monotonic()
    store = None
    try:
        store = _store()
        store.set(f"{base}/{rank}", value)
        store.wait(keys, datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        lost = [0] if store is None else _lost(store, keys)
        elapsed = time.monotonic() - t0
        raise PeerLostError(
            f"{what} did not complete within {timeout_s:.1f}s (waited "
            f"{elapsed:.1f}s, {type(e).__name__}) — process(es) {lost} "
            f"presumed lost", lost_ranks=lost, elapsed_s=elapsed,
            round_name=name) from None
    return store, keys


def agree_decision(code: int, *, name: str = "decision",
                   timeout_s: float | None = None) -> list[int]:
    """Allgather one small integer across every process through the
    group's store: each process publishes ``code`` and reads every
    peer's, returning ``[code_0, ..., code_{n-1}]`` (the same on every
    process). A peer not heard from within the collective timeout raises
    :class:`PeerLostError` naming it. Single process: ``[code]``."""
    code = int(code)
    if not is_multiprocess():
        return [code]
    if timeout_s is None:
        timeout_s = collective_timeout_s()
    rank = dist.get_rank()
    rnd = _next_round(name)
    base = f"dl4j/agree/{_key_prefix()}/{name}/{rnd}"
    store, keys = _rendezvous(base, str(code), timeout_s,
                              f"consensus round {name!r}#{rnd}", name)
    try:
        codes = [int(store.get(k)) for k in keys]
    except Exception as e:
        raise PeerLostError(
            f"consensus round {name!r}#{rnd}: the store went away while "
            f"its codes were read ({type(e).__name__}) — process(es) [0] "
            f"presumed lost", lost_ranks=[0], elapsed_s=0.0,
            round_name=name) from None
    if rnd >= 2:
        # every peer reaching round rnd has read round rnd-1, hence rnd-2
        try:
            store.delete_key(f"dl4j/agree/{_key_prefix()}/{name}/"
                             f"{rnd - 2}/{rank}")
        except Exception:
            pass
    return codes


def any_process(flag: bool, *, name: str = "flag",
                timeout_s: float | None = None) -> bool:
    """True iff ``flag`` is truthy on ANY process (the broadcast-OR a
    preemption uses: one SIGTERM anywhere stops every process at the
    same step boundary)."""
    return any(agree_decision(1 if flag else 0, name=name,
                              timeout_s=timeout_s))


def barrier(name: str, *, timeout_s: float | None = None) -> None:
    """Cross-process barrier with a deadline on the group's store: a dead
    peer raises :class:`PeerLostError` instead of hanging forever. No-op
    single-process."""
    if not is_multiprocess():
        return
    if timeout_s is None:
        timeout_s = collective_timeout_s()
    rnd = _next_round(f"barrier/{name}")
    base = f"dl4j/{_key_prefix()}/barrier/{name}/{rnd}"
    _rendezvous(base, "1", timeout_s, f"barrier {name!r}#{rnd}", name)


def check_peers(exc: BaseException, *, name: str = "collective",
                timeout_s: float | None = None) -> None:
    """After a collective raised ``exc`` (a dead peer closes gloo's
    connections, or the group's timeout expires): one consensus round
    asks every process whether it is still there. A peer that does not
    answer raises :class:`PeerLostError` naming it, chained from
    ``exc``; when every peer answers this returns, and the caller raises
    ``exc`` itself. Every rank that saw the error takes the same round.
    Single process: returns."""
    if not is_multiprocess():
        return
    try:
        agree_decision(1, name=f"alive/{name}", timeout_s=timeout_s)
    except PeerLostError as lost:
        raise lost from exc


# ------------------------------------------------------------- local SGD
class MultiProcessLocalSGD:
    """The DP-3 substitution for the reference's asynchronous parameter
    server: communication-avoiding LOCAL SGD. Each process trains its own
    replica on its local data for ``averaging_frequency`` steps with no
    cross-process traffic, then parameters (and optionally updater state)
    are averaged across processes. ``averaging_frequency=1`` is
    synchronous parameter averaging. The net must NOT be meshed (each
    process holds its own replica)."""

    def __init__(self, net, averaging_frequency: int = 1,
                 average_updaters: bool = True):
        if averaging_frequency < 1:
            raise ValueError("averaging_frequency must be >= 1")
        self.net = net
        self.averaging_frequency = averaging_frequency
        self.average_updaters = average_updaters
        self._local_steps = 0
        #: surplus local batches the windowed agreement dropped when the
        #: global-minimum count ended an epoch
        self.dropped_batches = 0
        from deeplearning4j_tpu_torch.parallel.stats import \
            TrainingStatsCollector
        rank = dist.get_rank() if dist.is_initialized() else 0
        self.stats = TrainingStatsCollector(worker_id=f"worker_{rank}")

    def _average_tree(self, tree):
        """Each leaf replaced, in place, by its mean over the processes
        (summed in float64, rounded once to the leaf's dtype)."""
        from deeplearning4j_tpu_torch.nn.updater import _leaves
        n = dist.get_world_size()
        comm = _comm_device()
        with torch.no_grad():
            for leaf in _leaves(tree):
                if leaf is None:
                    continue
                buf = leaf.detach().to(comm, torch.float64)
                dist.all_reduce(buf)
                leaf.copy_((buf / n).to(leaf.dtype))
        return tree

    def average_now(self):
        """Cross-process parameter (+ updater-state) average: the
        aggregate/divide step, as one all-reduce a leaf."""
        with self.stats.time_phase("average"):
            self._average_tree(self.net.params)
            if self.average_updaters and self.net.opt_state is not None:
                self._average_tree(self.net.opt_state)
        return self.net

    def fit_batch(self, ds):
        """One local step; averages every ``averaging_frequency`` steps.
        The periodic average is a COLLECTIVE: driving ``fit_batch``
        directly, every process must take the same number of steps."""
        with self.stats.time_phase("fit"):
            score = self.net.fit_batch(ds)
            float(score)    # the timed span covers the device's work
        self._local_steps += 1
        if self._local_steps % self.averaging_frequency == 0:
            self.average_now()
        return score

    def _note_dropped(self, n: int):
        self.dropped_batches += n
        from deeplearning4j_tpu_torch.observability.metrics import \
            get_registry
        get_registry().counter(
            "dl4j_localsgd_dropped_batches_total",
            "Surplus local batches dropped when the global-minimum "
            "count ended a LocalSGD epoch (uneven shards)").inc(n)
        logger.warning(
            "MultiProcessLocalSGD.fit: dropping %d surplus local "
            "batch(es) on process %d — a peer ran out of data first "
            "(uneven shards; %d dropped total this trainer)",
            n, dist.get_rank(), self.dropped_batches)

    def fit(self, iterator, *, epochs: int = 1, window: int | None = None):
        """Epoch loop over a LOCAL iterator; processes may hold uneven
        batch counts. Each round every process pulls up to ``window``
        batches, the counts' global minimum is trained on everywhere
        (one all-reduce MIN), and the leftovers carry into the next
        round. ``window`` defaults to max(averaging_frequency, 16)."""
        if window is None:
            window = max(self.averaging_frequency, 16)
        if window < 1:
            raise ValueError("window must be >= 1")
        comm = _comm_device()
        for _ in range(epochs):
            it = iter(iterator)
            pending: list = []
            exhausted = False
            while True:
                while len(pending) < window and not exhausted:
                    try:
                        pending.append(next(it))
                    except StopIteration:
                        exhausted = True
                n_t = torch.tensor([len(pending)], device=comm)
                dist.all_reduce(n_t, op=dist.ReduceOp.MIN)
                n = int(n_t.item())
                if n == 0:
                    if pending:
                        self._note_dropped(len(pending))
                    break
                for ds in pending[:n]:
                    self.fit_batch(ds)
                pending = pending[n:]
            if hasattr(iterator, "reset"):
                iterator.reset()
        if self._local_steps % self.averaging_frequency != 0:
            self.average_now()
        return self.net
