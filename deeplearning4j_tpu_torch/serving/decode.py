"""Autoregressive decode serving: the prefill/decode phase split over the
micro-batcher, session state in a paged KV pool, session-affine routing
(counterpart of deeplearning4j_tpu/serving/decode.py).

The streaming path (nn/layers/attention.py) is a function of (parameters,
cache state, next tokens), so decode serving rides the batching runtime
by making each session's cache part of its ticket:

- **Phase split.** ``MicroBatcher`` coalesces only tickets whose per-input
  row shapes match. Prefill tickets are ``[x [1, T, V], mask [1, T]]``,
  decode tickets ``[x [1, 1, V], *cache leaves]``, extend tickets
  ``[x [1, s, V], mask [1, s], *leaves]`` and verify tickets ``[mask
  [1, s], x [1, s, V], *leaves]``, so the batcher's own compatibility key
  keeps the phases apart: decode steps of many sessions coalesce into one
  bucket forward, prompts with prompts of the same rung.
- **Prompt ladder.** Prompts are right-padded (masked) to a power-of-two
  rung, so nearby lengths share a batch.
- **Chunked prefill** (``DL4J_TPU_PREFILL_CHUNK_PAGES``, default 1 page a
  chunk, 0 turns it off): the first chunk is a masked prefill, each later
  chunk an extend ticket from the cache's frontier, so other sessions'
  decode steps dispatch between one session's chunks.
- **Prefix sharing** (``DL4J_TPU_KV_PREFIX_SHARING``, default on): a new
  session adopts the longest resident page chain of its prompt
  (``KVPagePool.match_prefix``) and prefills only the rest.
- **State travels with the ticket.** Each session's cache leaves (per
  layer k/v [1, C, H, dh] f32 and pos [1] int32; for an LSTM net h/c
  [1, n]) are host rows that the batcher concatenates like features; the
  forward returns the advanced leaves, sliced back per row. The forward
  is stateless, so replicas are interchangeable and the fleet's requeue
  applies to decode tickets unchanged.
- **Affinity** (``ReplicaSet.submit(..., session=sid)``) pins a session's
  steps to one replica; it is a routing hint only.
- **Recoverable eviction.** Between steps the leaves live in a
  ``KVPagePool``; when it evicts an idle session, the session's token
  history (kept here) re-prefills it on its next step (``reprefills``).
- **Speculative decode** (``draft_net=`` with ``speculative=k``, env
  ``DL4J_TPU_SPECULATIVE_K``, default 0 = off): each ``generate`` round the
  draft proposes k tokens and the target checks them all in one verify
  forward (logits at every fed position). Acceptance is exact argmax
  match; the first mismatch ends the round, the target's own logits give
  the corrected token, and the rejected positions roll back, so the
  emitted stream is the plain greedy stream.

**The port's decode contract.** Within the port, on either device, the
following are bit-identical:

- a session decoded token by token against the same tokens fed one-shot
  (``rnn_time_step``), and chunked prefill against one-shot prefill;
- a row in a ragged, padded bucket against the same row alone;
- the engine's greedy stream against sequential ``rnn_time_step`` greedy
  decode, before and after an eviction and its re-prefill;
- the speculative stream against the plain greedy stream.

This holds because every sum on the streaming path runs in one fixed
order whatever the number of rows, the query length or the position
(ops/stream_exact.py: ordered loops on the CPU, the order-fixed kernels
S1-S3 on the card); the rest of the path is elementwise, a gather, or
PyTorch's softmax over a row, which keeps its bits across row counts on
the card (chip_smoke.py ``[stream_invariance]``). Against the JAX package
the same tokens' logits agree to f32 tolerance, not bit for bit: both
packages are exact in their own order, and the orders differ (ROADMAP
C.1). Against the training forward (``net.output``) streaming keeps the
usual compute-dtype tolerance.

The forward is plain eager PyTorch on the net's device, through its own
copy of the net's layers with streaming on (``StreamingKVForward``), over
the net's live parameters; the engine runs on the device its net was
built on. A net with recurrent carries that have no token axis (an LSTM's
h/c) decodes through the same engine unpaged: chunking, sharing and
speculation stay off for it, as in the JAX package.

``scheduler=`` (a scheduling.SchedulingCore) goes to the engine's
``ReplicaSet``: its decode tickets are admitted at the interactive tier,
so under overload the fleet sheds batch work first.
"""

from __future__ import annotations

import copy
import os
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis.guards import guarded_by
from deeplearning4j_tpu_torch.nn.layers.recurrent import (CARRY_KEYS,
                                                          set_streaming)
from deeplearning4j_tpu_torch.observability.metrics import DEFAULT_BUCKETS
from deeplearning4j_tpu_torch.observability.trace import \
    get_tracer as _get_tracer
from deeplearning4j_tpu_torch.serving.batcher import next_bucket
from deeplearning4j_tpu_torch.serving.fleet import ReplicaSet
from deeplearning4j_tpu_torch.serving.kvcache import KVPagePool

__all__ = ["StreamingKVForward", "DecodeEngine", "DecodeSession"]


def _leaf_out(t: torch.Tensor) -> np.ndarray:
    """A carry as a host row block: bf16 travels as its int16 bits (numpy
    has no bf16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _leaf_in(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A host row block back as a carry of ``dtype``: bf16 bits come back
    as bf16; warm-up's float32 zero rows are cast."""
    t = torch.as_tensor(np.asarray(a))
    if dtype == torch.bfloat16 and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    return t.to(device=device, dtype=dtype)


def _host_dtype(dtype: torch.dtype):
    """The numpy dtype a carry of ``dtype`` travels as."""
    if dtype == torch.bfloat16:
        return np.dtype(np.int16)
    return torch.empty((), dtype=dtype).numpy().dtype


class StreamingKVForward:
    """Stateless feats-list forward over a streaming net, shaped for
    ``MicroBatcher``: the arity and order of the inputs are the phase.

    - prefill ``[x [b,T,V], mask [b,T]]``: the masked one-shot streaming
      forward from a fresh fixed-extent cache; returns ``[last-real-token
      logits [b,V], *cache leaves]``;
    - decode ``[x [b,1,V], *leaves]``: advances every row one token;
      returns ``[logits [b,V], *new leaves]``;
    - extend ``[x [b,s,V], mask [b,s], *leaves]``: advances each row's
      cache by its masked segment from the row's frontier (chunked
      prefill); returns the segment's last-real-token logits and the
      leaves;
    - verify ``[mask [b,s], x [b,s,V], *leaves]`` (mask first, at extend's
      arity): extend that returns the logits at every fed position, ``[
      logits [b,s,V], *leaves]``, for speculative decode.

    Each row's logits are bit-identical to what the single-token decode
    would give at that position (decode.py's contract). Leaves are
    ordered by layer name, then carry name. The forward runs through a
    copy of the net's layers with streaming on, over the net's live
    parameters, under ``torch.inference_mode``, on the net's device; the
    net's own layers are never switched, so ``net.output`` may run beside
    it. A tensor-parallel net's shards are gathered whole once, at
    construction (``refresh_params``, a collective of its model group),
    and the engine streams over that copy: the params as of then."""

    def __init__(self, net):
        self.net = net
        self.device = net.device
        self._params = None
        if getattr(net, "_tp", None) is not None:
            self.refresh_params()
        self._stream_net = copy.copy(net)
        self._stream_net._tp = None
        self._stream_net._build_layers()
        set_streaming(self._stream_net.layers, True)
        self.vocab_size = int(net.layers[0].conf.n_in)
        # a 1-row probe fixes the leaves' order, dtypes and row shapes
        probe = self._run(torch.zeros((1, 1, self.vocab_size)),
                          torch.ones((1, 1)), None, "prefill")
        self._leaf_keys = probe[1]
        self.n_carries = len(self._leaf_keys)
        self._carry_dtypes = [t.dtype for t in probe[2]]
        #: numpy dtypes the leaves travel as (bf16 as int16 bits)
        self.carry_np_dtypes = [_host_dtype(d) for d in self._carry_dtypes]
        #: per-row shapes of the decode ticket's leaves (for warm-up)
        self.carry_row_shapes = [tuple(t.shape[1:]) for t in probe[2]]

    def refresh_params(self):
        """A tensor-parallel net (on a model axis, parallel/tensor.py):
        gather its shards whole, once, through the model group, as the
        gather route does for ``rnn_time_step``; the engine then streams
        on S1-S3 over that copy, bit for bit as over the unmeshed net's
        params. So it serves the params as of its construction, or of
        its last call here: a collective, which every rank of the model
        group calls (after a step, to serve the new params). Raises
        where the gather cannot run: a net on a model axis with no
        process group up."""
        tp = getattr(self.net, "_tp", None)
        if tp is None:
            return
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(
                "decode on a model axis gathers the net's shards through "
                "its model group, and no process group is up "
                "(parallel.distributed.initialize); every rank of the "
                "model group builds the engine")
        with torch.no_grad():
            self._params = tp.gathered(self.net.params, tp.specs)

    # ------------------------------------------------------------- internals
    def _state_with(self, leaves):
        state = {ln: dict(sub) for ln, sub in (self.net.state or {}).items()}
        for (ln, key), t in zip(self._leaf_keys, leaves):
            state.setdefault(ln, {})[key] = t
        return state

    def _run(self, x, mask, leaves, phase):
        """One forward: (logits or all-position logits, leaf keys, new
        leaves as tensors)."""
        dev = self.device
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32).to(dev)
        state = (self.net.state or {}) if leaves is None \
            else self._state_with(leaves)
        with torch.inference_mode():
            params = self.net.params if self._params is None \
                else self._params
            out, ns = self._stream_net._forward(params, state, x,
                                                train=False, fmask=mask)
            keys, new = [], []
            for ln in sorted(ns):
                for key in sorted(ns[ln]):
                    if key in CARRY_KEYS:
                        keys.append((ln, key))
                        new.append(ns[ln][key])
            if phase == "decode":
                logits = out[:, 0, :]
            elif phase == "verify":
                logits = out
            else:
                lengths = torch.clamp(
                    torch.sum(mask.to(torch.int64), dim=1), min=1)
                rows = torch.arange(out.shape[0], device=out.device)
                logits = out[rows, lengths - 1]
        return logits, keys, new

    # ----------------------------------------------------------------- entry
    def __call__(self, feats: list):
        n = len(feats)
        if n == 2:
            phase, x, mask, leaves = "prefill", feats[0], feats[1], None
        elif n == 2 + self.n_carries and np.ndim(feats[0]) == 2:
            phase, mask, x, leaves = "verify", feats[0], feats[1], feats[2:]
        elif n == 2 + self.n_carries:
            phase, x, mask, leaves = "extend", feats[0], feats[1], feats[2:]
        else:
            phase, x, mask, leaves = "decode", feats[0], None, feats[1:]
        if leaves is not None:
            leaves = [_leaf_in(a, dt, self.device)
                      for a, dt in zip(leaves, self._carry_dtypes)]
        logits, _, new = self._run(x, mask, leaves, phase)
        return ([logits.float().cpu().numpy()]
                + [_leaf_out(t) for t in new])


class DecodeSession:
    """Host-side session record: the token history (the recovery source
    after a pool eviction) and bookkeeping. The cache leaves live in the
    ``KVPagePool``."""

    __slots__ = ("sid", "ids", "created", "last_step")

    def __init__(self, sid: str, ids: List[int]):
        self.sid = sid
        self.ids = list(ids)
        self.created = time.time()
        self.last_step = self.created

    @property
    def tokens(self) -> int:
        return len(self.ids)


@guarded_by("_lock", "_sessions", "prefills", "decode_steps", "reprefills",
            "prefill_chunks", "chunked_prefills", "interleaved_prefills",
            "prefix_hits", "shared_tokens", "spec_rounds", "spec_proposed",
            "spec_accepted", "spec_rejected", "_itok_buckets", "_itok_sum",
            "_itok_count")
class DecodeEngine:
    """Sessionful autoregressive decode over a ``ReplicaSet``.

    ``prefill(sid, ids)`` admits a session (a masked prompt forward in
    page-aligned chunks, the cache leaves into the pool) and returns the
    next-token logits; ``step(sid, token)`` extends it one token. Both are
    synchronous per session; sessions driven from threads coalesce into
    one bucket forward per step.

    Knobs, each with a kill switch, as in the JAX package:

    - ``prefill_chunk_pages`` (env ``DL4J_TPU_PREFILL_CHUNK_PAGES``,
      default 1; 0 prefills one-shot);
    - ``prefix_sharing`` (env ``DL4J_TPU_KV_PREFIX_SHARING``, default on);
    - ``speculative`` (env ``DL4J_TPU_SPECULATIVE_K``, default 0) with
      ``draft_net=``: a draft whose vocab differs, whose cache extent is
      shorter than the target's, or an explicit ``speculative`` without a
      draft raise ``ValueError``.

    The three need token-axis cache carries (attention's [1, C, H, dh])
    and stay off for nets without them (an LSTM's h/c)."""

    def __init__(self, net, *, replicas: int = 1, pool: KVPagePool = None,
                 n_pages: int = 256, page_tokens: int = 16,
                 max_batch: int = 64, batch_window_ms: float = 2.0,
                 max_queue: int = 1024, min_batch: int = 2,
                 min_prompt_bucket: int = 8, stats=None,
                 request_timeout_s: float = 300.0,
                 prefix_sharing: Optional[bool] = None,
                 prefill_chunk_pages: Optional[int] = None,
                 speculative: Optional[int] = None, draft_net=None,
                 scheduler=None):
        self.forward = StreamingKVForward(net)
        self.scheduler = scheduler
        self.fleet = ReplicaSet(self.forward, replicas, max_batch=max_batch,
                                batch_window_ms=batch_window_ms,
                                max_queue=max_queue, min_batch=min_batch,
                                stats=stats, scheduler=scheduler)
        if prefix_sharing is None:
            prefix_sharing = os.environ.get(
                "DL4J_TPU_KV_PREFIX_SHARING", "1").lower() \
                not in ("0", "false", "no", "off")
        if prefill_chunk_pages is None:
            prefill_chunk_pages = int(os.environ.get(
                "DL4J_TPU_PREFILL_CHUNK_PAGES", "1"))
        self.pool = pool if pool is not None \
            else KVPagePool(n_pages, page_tokens,
                            prefix_sharing=bool(prefix_sharing))
        self.min_prompt_bucket = int(min_prompt_bucket)
        self.max_prompt = self._max_prompt(net)
        # chunking and sharing need carries with a token axis
        rs = self.forward.carry_row_shapes
        can_page = (any(len(s) >= 2 for s in rs)
                    and all(len(s) == 0 or len(s) >= 2 for s in rs))
        self._sharing = (bool(prefix_sharing) and can_page
                         and self.pool.prefix_sharing)
        self._chunk_tokens = (max(0, int(prefill_chunk_pages))
                              * self.pool.page_tokens if can_page else 0)
        self._sessions: Dict[str, DecodeSession] = {}
        self._lock = threading.Lock()
        self.request_timeout_s = float(request_timeout_s)
        self.prefills = 0
        self.decode_steps = 0
        self.reprefills = 0            # evicted sessions re-admitted
        self.prefill_chunks = 0        # prompt segments submitted
        self.chunked_prefills = 0      # prefills split into >= 2 segments
        self.interleaved_prefills = 0  # ...during which decode advanced
        self.prefix_hits = 0           # prefills that adopted shared pages
        self.shared_tokens = 0         # prefill tokens skipped by sharing
        self.spec_rounds = 0           # draft-propose/target-verify rounds
        self.spec_proposed = 0         # draft tokens proposed
        self.spec_accepted = 0         # proposals matching the target
        self.spec_rejected = 0         # proposals cut at a mismatch
        # inter-token latency histogram (seconds), one observation per
        # emitted token (a speculative round's time is spread over the
        # tokens it emitted)
        self._itok_le = tuple(sorted(DEFAULT_BUCKETS))
        self._itok_buckets = {b: 0 for b in self._itok_le}
        self._itok_sum = 0.0
        self._itok_count = 0
        explicit_spec = speculative is not None
        if speculative is None:
            speculative = int(os.environ.get(
                "DL4J_TPU_SPECULATIVE_K", "0") or 0)
        k = max(0, int(speculative))
        if k and draft_net is None and explicit_spec:
            raise ValueError(
                f"speculative={k} needs a draft_net= to propose with — "
                "pass one (zoo.gpt_mini_draft matches zoo.gpt_mini) or "
                "set speculative=0")
        self.spec_k = 0
        self._draft: Optional["DecodeEngine"] = None
        if k and draft_net is not None and can_page:
            dv = int(draft_net.layers[0].conf.n_in)
            if dv != self.forward.vocab_size:
                raise ValueError(
                    f"speculative draft/target vocab mismatch: the draft "
                    f"proposes over {dv} tokens but the target verifies "
                    f"over {self.forward.vocab_size} — exact-argmax "
                    "acceptance needs the same vocab on both nets; build "
                    "the draft with zoo.gpt_mini_draft("
                    f"vocab_size={self.forward.vocab_size})")
            draft_ext = self._max_prompt(draft_net)
            if draft_ext < self.max_prompt:
                raise ValueError(
                    f"speculative draft cache extent {draft_ext} is "
                    f"shorter than the target's {self.max_prompt} — the "
                    "draft must track the whole session; build it with "
                    f"max_cache_len={self.max_prompt} (or longer)")
            # the draft rides its own single-replica engine (own pool, no
            # nested speculation)
            self._draft = DecodeEngine(
                draft_net, replicas=1, n_pages=self.pool.n_pages,
                page_tokens=self.pool.page_tokens, max_batch=max_batch,
                batch_window_ms=batch_window_ms, max_queue=max_queue,
                min_batch=min_batch, min_prompt_bucket=min_prompt_bucket,
                request_timeout_s=request_timeout_s,
                prefix_sharing=prefix_sharing,
                prefill_chunk_pages=prefill_chunk_pages,
                speculative=0)
            self.spec_k = k

    @staticmethod
    def _max_prompt(net) -> int:
        caps = [int(getattr(ly, "cache_len", 0) or 0) for ly in net.layers]
        caps = [c for c in caps if c > 0]
        return min(caps) if caps else 256

    # --------------------------------------------------------------- helpers
    def _one_hot(self, ids: Sequence[int], t: int) -> np.ndarray:
        x = np.zeros((1, t, self.forward.vocab_size), np.float32)
        for j, i in enumerate(ids):
            x[0, j, int(i)] = 1.0
        return x

    def _extend_seg(self) -> int:
        """Segment size (tokens) of extend tickets: the chunk size, or one
        page when chunking is off but a shared prefix still needs
        extending from mid-sequence."""
        seg = self._chunk_tokens if self._chunk_tokens \
            else self.pool.page_tokens
        return min(seg, self.max_prompt)

    def _rungs(self, cap: int) -> List[int]:
        """Every value ``next_bucket(seg, cap, min_prompt_bucket)`` takes
        for seg in 1..cap."""
        t, rungs = self.min_prompt_bucket, []
        while t < cap:
            rungs.append(t)
            t *= 2
        rungs.append(cap)
        return rungs

    def warm(self):
        """Run every phase's ladder once: decode, each prefill rung, the
        extend rungs when chunking or sharing is on (the cache extent's
        edge rung too), the verify rungs and the draft's ladders when
        speculation is on. Each ladder passes ``skip=()``: the fleet's
        ``shapes_seen`` records bucket sizes only. Returns the buckets
        run."""
        v = self.forward.vocab_size
        carry = list(self.forward.carry_row_shapes)
        ran = list(self.fleet.warm([(1, v)] + carry, skip=()))
        pf_cap = min(self._chunk_tokens, self.max_prompt) \
            if self._chunk_tokens else self.max_prompt
        for t in self._rungs(pf_cap):
            ran += self.fleet.warm([(t, v), (t,)], skip=())
        if self._sharing or self._chunk_tokens:
            ext = self._extend_seg()
            ext_rungs = set(self._rungs(ext))
            if self.max_prompt % ext:
                ext_rungs.add(self.max_prompt % ext)
            for t in sorted(ext_rungs):
                ran += self.fleet.warm([(t, v), (t,)] + carry, skip=())
        if self.spec_k:
            vr = set()
            for cap in range(2, self.spec_k + 2):
                for seg in range(2, cap + 1):
                    vr.add(next_bucket(seg, cap, self.min_prompt_bucket))
            for t in sorted(vr):
                ran += self.fleet.warm([(t,), (t, v)] + carry, skip=())
            ran += self._draft.warm()
        return sorted(set(ran))

    def refresh_params(self):
        """Gather a tensor-parallel target's (and draft's) shards anew
        (``StreamingKVForward.refresh_params``): a collective that every
        rank of the model group calls; sessions keep their caches."""
        self.forward.refresh_params()
        if self._draft is not None:
            self._draft.refresh_params()

    def _await(self, fut, sid: str, what: str):
        try:
            return fut.result(timeout=self.request_timeout_s)
        except _FutureTimeout:
            from deeplearning4j_tpu_torch.serving.server import \
                DeadlineExceededError
            raise DeadlineExceededError(
                f"decode {what} for session '{sid}' exceeded "
                f"request_timeout_s={self.request_timeout_s:g}s") from None

    # ------------------------------------------------------------- lifecycle
    def _leaves_from_partial(self, partial: dict, shared_t: int):
        """A full leaf list from an adopted shared-page prefix: token-axis
        carries get the shared slices below the frontier (zeros above,
        never attended before they are written), position carries the
        frontier itself."""
        leaves = []
        for i, rs in enumerate(self.forward.carry_row_shapes):
            dt = self.forward.carry_np_dtypes[i]
            if i in partial:
                arr = np.zeros((1,) + tuple(rs), dt)
                arr[:, :shared_t] = partial[i]
            else:
                arr = np.full((1,) + tuple(rs), shared_t, dt)
            leaves.append(arr)
        return leaves

    def _observe_inter_token(self, dt: float, n: int = 1) -> None:
        with self._lock:
            for b in self._itok_le:
                if dt <= b:
                    self._itok_buckets[b] += n
                    break
            self._itok_sum += dt * n
            self._itok_count += n

    @staticmethod
    def _tid_attrs(trace_id, **attrs) -> dict:
        if trace_id:
            attrs["trace_id"] = str(trace_id)
        return attrs

    def _run_prefill(self, sid: str, ids: List[int],
                     trace_id: Optional[str] = None):
        t = len(ids)
        if t < 1:
            raise ValueError("prefill needs at least one prompt token")
        if t > self.max_prompt:
            raise ValueError(f"prompt of {t} tokens exceeds the cache "
                             f"extent {self.max_prompt}")
        with _get_tracer().span(
                "decode_prefill",
                **self._tid_attrs(trace_id, sid=sid, tokens=t)):
            return self._run_prefill_inner(sid, ids, t, trace_id)

    def _run_prefill_inner(self, sid: str, ids: List[int], t: int,
                           trace_id: Optional[str]):
        ext = self._extend_seg()
        pos, leaves, logits = 0, None, None
        if self._sharing:
            # adopt the longest resident page chain of this prompt; the
            # alignment keeps the later extend buckets on the ladder
            shared_t, partial = self.pool.match_prefix(
                sid, ids, align_tokens=ext)
            if shared_t:
                leaves = self._leaves_from_partial(partial, shared_t)
                pos = shared_t
                with self._lock:
                    self.prefix_hits += 1
                    self.shared_tokens += shared_t
        ds0 = self.decode_steps
        chunks = 0
        while pos < t:
            if leaves is None:
                # fresh cache: masked prefill (the prompt, or its first
                # chunk when chunking is on)
                cap = min(self._chunk_tokens, self.max_prompt) \
                    if self._chunk_tokens else self.max_prompt
                seg = min(t, cap)
                bt = next_bucket(seg, cap, self.min_prompt_bucket)
                x = self._one_hot(ids[:seg], bt)
                mask = np.zeros((1, bt), np.float32)
                mask[0, :seg] = 1.0
                feats = [x, mask]
            else:
                # extend the cache by one page-aligned segment; the bucket
                # never overruns the cache extent
                cap = min(ext, self.max_prompt - pos)
                seg = min(t - pos, cap)
                bt = next_bucket(seg, cap, self.min_prompt_bucket)
                x = self._one_hot(ids[pos:pos + seg], bt)
                mask = np.zeros((1, bt), np.float32)
                mask[0, :seg] = 1.0
                feats = [x, mask] + list(leaves)
            res = self._await(self.fleet.submit(feats, session=sid,
                                                trace_id=trace_id),
                              sid, "prefill")
            logits, leaves = res[0], list(res[1:])
            pos += seg
            chunks += 1
        with self._lock:
            self.prefill_chunks += chunks
            if chunks > 1:
                self.chunked_prefills += 1
                if self.decode_steps > ds0:
                    self.interleaved_prefills += 1
        self.pool.put(sid, t, leaves,
                      ids=ids if self._sharing else None)
        return logits[0], leaves

    def prefill(self, sid: str, ids: Sequence[int],
                trace_id: Optional[str] = None) -> np.ndarray:
        """Admit session ``sid`` with a prompt of token ids; returns the
        next-token logits row [V]. ``trace_id`` rides the engine's spans
        and the batcher tickets."""
        ids = [int(i) for i in ids]
        with self._lock:
            self._sessions[sid] = DecodeSession(sid, ids)
            self.prefills += 1
        return self._run_prefill(sid, ids, trace_id=trace_id)[0]

    def step(self, sid: str, token: int,
             trace_id: Optional[str] = None) -> np.ndarray:
        """Feed one decoded token into session ``sid``; returns the
        next-token logits row [V]. Re-prefills from the token history when
        the pool evicted the session between steps."""
        t_start = time.perf_counter()
        with self._lock:
            sess = self._sessions.get(sid)
        if sess is None:
            raise KeyError(f"unknown decode session '{sid}'")
        if sess.tokens + 1 > self.max_prompt:
            # the session can never advance again: give its pages back
            # (the host record stays for close_session)
            self.pool.drop(sid)
            raise ValueError(f"session '{sid}' is at the cache extent "
                             f"{self.max_prompt}")
        leaves = self.pool.get(sid)
        if leaves is None:
            with self._lock:
                self.reprefills += 1
            leaves = self._run_prefill(sid, sess.ids, trace_id=trace_id)[1]
        x = self._one_hot([token], 1)
        with _get_tracer().span("decode_step",
                                **self._tid_attrs(trace_id, sid=sid)):
            res = self._await(self.fleet.submit([x] + list(leaves),
                                                session=sid,
                                                trace_id=trace_id),
                              sid, "step")
        logits, new_leaves = res[0], res[1:]
        sess.ids.append(int(token))
        sess.last_step = time.time()
        with self._lock:
            self.decode_steps += 1
        self.pool.put(sid, sess.tokens, new_leaves,
                      ids=sess.ids if self._sharing else None)
        self._observe_inter_token(time.perf_counter() - t_start)
        return logits[0]

    # ---------------------------------------------------------- speculative
    def _rollback(self, sid: str, to_tokens: int) -> bool:
        """Roll session ``sid`` back to its first ``to_tokens`` tokens:
        ``pool.truncate`` (position carries move to the new frontier) and
        the history trimmed. False when the pool cannot truncate (a dense
        entry, or evicted): the caller re-prefills instead."""
        with self._lock:
            sess = self._sessions.get(sid)
        if sess is None or to_tokens < 1 or to_tokens > sess.tokens:
            return False
        others = {}
        for i, rs in enumerate(self.forward.carry_row_shapes):
            if len(rs) < 2:
                others[i] = np.full((1,) + tuple(rs), to_tokens,
                                    self.forward.carry_np_dtypes[i])
        if not self.pool.truncate(sid, to_tokens, others=others):
            return False
        del sess.ids[to_tokens:]
        return True

    def _sync_logits(self, sid: str, want: List[int],
                     trace_id: Optional[str] = None) -> np.ndarray:
        """Next-token logits with session ``sid``'s history equal to
        ``want`` (the draft's resync between rounds): steps the missing
        suffix when the history is a prefix of ``want``, rolls a diverged
        tail back first, and otherwise prefills."""
        with self._lock:
            sess = self._sessions.get(sid)
        if sess is not None:
            have = list(sess.ids)
            n = 0
            for a, b in zip(have, want):
                if a != b:
                    break
                n += 1
            if n < len(have):
                have = have[:n] if n >= 1 and self._rollback(sid, n) \
                    else None
            if have is not None and len(have) < len(want):
                logits = None
                for t in want[len(have):]:
                    logits = self.step(sid, t, trace_id=trace_id)
                return logits
        return self.prefill(sid, want, trace_id=trace_id)

    def _propose(self, sid: str, want: List[int], k: int,
                 trace_id: Optional[str] = None) -> List[int]:
        """``k`` greedy draft proposals continuing ``want``, on the draft
        engine; the last proposal is left unfed."""
        d = self._draft
        logits = d._sync_logits(sid, want, trace_id=trace_id)
        props: List[int] = []
        for _ in range(k):
            t = int(np.argmax(logits))
            props.append(t)
            if len(props) < k:
                logits = d.step(sid, t, trace_id=trace_id)
        return props

    def _spec_round(self, sid: str, nxt: int, max_new: int,
                    trace_id: Optional[str] = None):
        """One draft-propose / target-verify round. Returns ``(emitted,
        next_token)``, ``emitted`` starting with ``nxt``, or None when the
        cache extent leaves no room and the caller takes a plain step."""
        with self._lock:
            sess = self._sessions.get(sid)
        if sess is None:
            raise KeyError(f"unknown decode session '{sid}'")
        base = sess.tokens
        k = min(self.spec_k, int(max_new), self.max_prompt - base - 1)
        if k < 1:
            return None
        props = self._propose(sid, sess.ids + [int(nxt)], k,
                              trace_id=trace_id)
        leaves = self.pool.get(sid)
        if leaves is None:
            with self._lock:
                self.reprefills += 1
            leaves = self._run_prefill(sid, sess.ids, trace_id=trace_id)[1]
        seq = [int(nxt)] + props
        cap = min(self.spec_k + 1, self.max_prompt - base)
        bt = next_bucket(len(seq), cap, self.min_prompt_bucket)
        x = self._one_hot(seq, bt)
        mask = np.zeros((1, bt), np.float32)
        mask[0, :len(seq)] = 1.0
        # mask first marks the verify (all-position logits) variant
        with _get_tracer().span(
                "decode_verify",
                **self._tid_attrs(trace_id, sid=sid, proposed=k)):
            res = self._await(self.fleet.submit([mask, x] + list(leaves),
                                                session=sid,
                                                trace_id=trace_id),
                              sid, "verify")
        rows, new_leaves = res[0][0], list(res[1:])
        emitted = [int(nxt)]
        accepted = 0
        nxt2 = None
        for i in range(k):
            g = int(np.argmax(rows[i]))
            if props[i] == g:
                emitted.append(g)
                accepted += 1
            else:
                nxt2 = g    # the target's own corrected token
                break
        if nxt2 is None:
            # full accept: the last row is a free plain step
            nxt2 = int(np.argmax(rows[k]))
        kept = base + len(emitted)
        if len(emitted) < len(seq):
            # back to the accept frontier: the position carries move back;
            # the cache's stale tail is written again before anything
            # attends there, and the pool stores only kept tokens
            for i, rs in enumerate(self.forward.carry_row_shapes):
                if len(rs) < 2:
                    new_leaves[i] = np.full(
                        (1,) + tuple(rs), kept,
                        self.forward.carry_np_dtypes[i])
        sess.ids.extend(emitted)
        sess.last_step = time.time()
        with self._lock:
            self.spec_rounds += 1
            self.spec_proposed += k
            self.spec_accepted += accepted
            self.spec_rejected += k - accepted
        self.pool.put(sid, sess.tokens, new_leaves,
                      ids=sess.ids if self._sharing else None)
        return emitted, nxt2

    def generate(self, sid: str, ids: Sequence[int], n_tokens: int,
                 *, step_times: Optional[list] = None,
                 trace_id: Optional[str] = None) -> List[int]:
        """Greedy decode: prefill, then ``n_tokens`` argmax tokens, by
        plain steps or by speculative rounds (the same stream). Returns
        the generated ids; ``step_times`` collects the wall seconds of
        each token."""
        n = int(n_tokens)
        logits = self.prefill(sid, ids, trace_id=trace_id)
        out: List[int] = []
        if n <= 0:
            return out
        nxt = int(np.argmax(logits))
        while len(out) < n:
            left = n - len(out)
            if self.spec_k and left >= 2:
                t0 = time.perf_counter()
                r = self._spec_round(sid, nxt, left - 1,
                                     trace_id=trace_id)
                if r is not None:
                    emitted, nxt = r
                    dt = (time.perf_counter() - t0) / len(emitted)
                    self._observe_inter_token(dt, n=len(emitted))
                    if step_times is not None:
                        step_times.extend([dt] * len(emitted))
                    out.extend(emitted)
                    continue
            out.append(nxt)
            t0 = time.perf_counter()
            logits = self.step(sid, nxt, trace_id=trace_id)
            if step_times is not None:
                step_times.append(time.perf_counter() - t0)
            if len(out) < n:
                # the final step's argmax would be discarded
                nxt = int(np.argmax(logits))
        return out

    def close_session(self, sid: str) -> bool:
        with self._lock:
            known = self._sessions.pop(sid, None) is not None
        self.pool.drop(sid)
        self.fleet.forget_session(sid)
        if self._draft is not None:
            self._draft.close_session(sid)
        return known

    # ----------------------------------------------------------------- state
    @property
    def sessions(self) -> List[str]:
        with self._lock:
            return list(self._sessions)

    def describe(self) -> dict:
        d = self.pool.describe()
        d.update(prefills=self.prefills, decode_steps=self.decode_steps,
                 reprefills=self.reprefills,
                 affinity_hits=self.fleet.affinity_hits,
                 affinity_misses=self.fleet.affinity_misses,
                 sessions_live=len(self._sessions),
                 prefill_chunks=self.prefill_chunks,
                 chunked_prefills=self.chunked_prefills,
                 interleaved_prefills=self.interleaved_prefills,
                 prefix_hits=self.prefix_hits,
                 shared_tokens=self.shared_tokens,
                 prefill_chunk_tokens=self._chunk_tokens,
                 prefix_sharing=self._sharing)
        with self._lock:
            if self._itok_count:
                d["inter_token_hist"] = {
                    "buckets": {str(b): c
                                for b, c in self._itok_buckets.items()},
                    "sum": round(self._itok_sum, 6),
                    "count": self._itok_count,
                }
        steps = self.decode_steps + self.spec_rounds
        d.update(speculative_k=self.spec_k,
                 spec_rounds=self.spec_rounds,
                 spec_proposed=self.spec_proposed,
                 spec_accepted=self.spec_accepted,
                 spec_rejected=self.spec_rejected,
                 # tokens emitted per target decode launch
                 spec_accept_tokens_per_step=(
                     round((steps + self.spec_accepted) / steps, 4)
                     if (self.spec_k and steps) else None),
                 spec_draft_truncations=(
                     self._draft.pool.truncations
                     if self._draft is not None else None))
        return d

    def stop(self):
        if self._draft is not None:
            self._draft.stop()
        self.fleet.stop()
