"""Paged KV-cache pool for decode sessions: block-granular admission,
copy-on-write prefix sharing and refcounted LRU eviction (counterpart of
deeplearning4j_tpu/serving/kvcache.py; the port keeps its own copy, since
that module is host-only numpy but lives in the JAX package).

Capacity is fixed in pages of ``page_tokens`` tokens. Every session is
charged for the pages backing the prefix it has decoded so far, and when
an allocation would overflow the pool the least-recently-used *other*
session is released: its private state is dropped, its references on
shared pages are decremented, and only pages nobody still holds return to
the free pool.

- **Prefix sharing.** Sessions that begin with the same tokens produce the
  same cache pages bit for bit (the streaming path sums in a fixed order,
  ops/stream_exact.py), so full pages are keyed by the exact token history
  that produced them, ``tuple(ids[:page_end])``. A ``put`` that seals a
  page whose key exists takes a reference on it instead of storing a
  second copy; ``match_prefix`` lets a new session adopt the longest
  resident chain of its prompt and skip that much prefill. Shared pages
  are immutable: each session's growing edge lives in a private tail (the
  partial last page and the leaves that cannot be paged, such as
  positions), so a session that diverges mid-page seals its own page.
- **Eviction is recoverable and refcounted.** A page survives while any
  holder remains. The engine keeps each session's token history and
  re-prefills an evicted session on its next step, re-adopting whatever
  pages its peers kept alive.
- **Dense fallback.** A ``put`` without ``ids``, or with leaves the pool
  cannot page (no ``[1, extent, ...]`` axis, such as LSTM ``h``/``c``
  carries), keeps the leaves as they are, with page-count accounting only.

The pool holds host rows (numpy), as the JAX package's does: a decode
ticket carries its session's full-extent cache to the device and back.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.analysis.guards import guarded_by

__all__ = ["KVPagePool", "CachePoolFullError"]


class CachePoolFullError(RuntimeError):
    """A single session needs more pages than the whole pool holds —
    admission must reject it (no amount of eviction can fit it)."""


class _Page:
    """One immutable shared page: a refcount plus, per pageable leaf,
    the ``[1, page_tokens, ...]`` slice of that leaf's token axis."""

    __slots__ = ("ref", "slices")

    def __init__(self, slices):
        self.ref = 1
        self.slices = slices


class _Entry:
    """Per-session pool record. ``dense`` holds the legacy verbatim
    leaves; paged sessions instead hold a chain of shared-page keys plus
    a private tail (partial-page slices + non-pageable leaves)."""

    __slots__ = ("tokens", "dense", "chain", "tail", "others")

    def __init__(self):
        self.tokens = 0
        self.dense = None            # legacy verbatim leaves (or None)
        self.chain: List[tuple] = []  # shared-page keys, page order
        self.tail = None             # per-pageable-leaf [1, r, ...] slices
        self.others: List[Tuple[int, object]] = []  # (leaf idx, leaf)

    @property
    def paged(self) -> bool:
        return self.dense is None


@guarded_by("_lock", "_table", "_shared", "_layout", "evictions",
            "evicted_pages", "page_hits", "prefix_matches", "truncations",
            "truncated_pages")
class KVPagePool:
    """Fixed-capacity page accounting + copy-on-write store for
    decode-session cache state.

    ``put`` charges/extends a session and stores its cache leaves
    (deduplicating sealed full pages against the shared store when
    ``ids`` is given), evicting least-recently-used other sessions as
    needed; ``get`` reassembles (and LRU-touches) them; a ``get``
    returning ``None`` means the session was evicted and must be
    re-prefilled from history. ``match_prefix`` adopts an existing
    sessions' pages for a new prompt sharing their prefix.
    """

    def __init__(self, n_pages: int = 256, page_tokens: int = 16,
                 prefix_sharing: bool = True):
        if n_pages < 1 or page_tokens < 1:
            raise ValueError("n_pages and page_tokens must be >= 1")
        self.n_pages = int(n_pages)
        self.page_tokens = int(page_tokens)
        self.prefix_sharing = bool(prefix_sharing)
        self._lock = threading.Lock()
        # sid -> _Entry; insertion order = LRU order
        self._table: "OrderedDict[str, _Entry]" = OrderedDict()
        # exact token-prefix tuple -> shared _Page
        self._shared: Dict[tuple, _Page] = {}
        # (n_leaves, pageable idx tuple, per-pageable extent, dtypes) —
        # pinned by the first paged put; one pool serves one model
        self._layout = None
        self.evictions = 0          # sessions dropped to free pages
        self.evicted_pages = 0      # pages actually freed by those drops
        self.page_hits = 0          # sealed pages deduped against peers
        self.prefix_matches = 0     # match_prefix adoptions
        self.truncations = 0        # speculative-reject rollbacks
        self.truncated_pages = 0    # pages freed by those rollbacks

    # ------------------------------------------------------------ accounting
    def pages_for(self, tokens: int) -> int:
        return max(1, -(-int(tokens) // self.page_tokens))

    def _physical_locked(self) -> int:
        """Distinct pages actually held: each shared page once, plus
        every session's private tail / dense charge."""
        used = len(self._shared)
        for ent in self._table.values():
            if ent.paged:
                used += 1 if ent.tail is not None else 0
            else:
                used += self.pages_for(ent.tokens)
        return used

    def _logical_locked(self) -> int:
        """Page charge as if nothing were shared — the numerator of the
        dedup ratio."""
        return sum(self.pages_for(ent.tokens)
                   for ent in self._table.values())

    @property
    def pages_used(self) -> int:
        with self._lock:
            return self._physical_locked()

    @property
    def occupancy(self) -> float:
        return self.pages_used / self.n_pages

    @property
    def sessions(self) -> List[str]:
        with self._lock:
            return list(self._table)

    def describe(self) -> dict:
        with self._lock:
            used = self._physical_locked()
            logical = self._logical_locked()
            shared = sum(1 for p in self._shared.values() if p.ref >= 2)
            return {"n_pages": self.n_pages, "page_tokens": self.page_tokens,
                    "pages_used": used, "occupancy": used / self.n_pages,
                    "sessions": len(self._table),
                    "evictions": self.evictions,
                    "prefix_sharing": self.prefix_sharing,
                    "shared_pages": shared,
                    "store_pages": len(self._shared),
                    "logical_pages": logical,
                    "dedup_ratio": (round(logical / used, 4) if used
                                    else None),
                    "page_hits": self.page_hits,
                    "prefix_matches": self.prefix_matches,
                    "truncations": self.truncations,
                    "truncated_pages": self.truncated_pages}

    # ------------------------------------------------------------- internals
    def _pageable_layout(self, tokens: int, leaves) -> Optional[tuple]:
        """Detect the pageable leaves: ``[1, extent, ...]`` arrays whose
        token axis covers this session. Returns the layout tuple, or
        ``None`` when nothing is pageable (dense fallback)."""
        idx, extents, dtypes = [], [], []
        for i, leaf in enumerate(leaves):
            shape = getattr(leaf, "shape", None)
            if (shape is not None and getattr(leaf, "ndim", 0) >= 3
                    and shape[0] == 1 and shape[1] >= tokens):
                idx.append(i)
                extents.append(int(shape[1]))
                dtypes.append(leaf.dtype)
        if not idx:
            return None
        return (len(list(leaves)), tuple(idx), tuple(extents),
                tuple(dtypes))

    def _release_locked(self, ent: _Entry) -> int:
        """Drop a session's holdings: decrement its chain refs (freeing
        pages at zero), drop its tail/dense charge. Returns pages freed."""
        freed = 0
        if not ent.paged:
            return self.pages_for(ent.tokens)
        for key in ent.chain:
            page = self._shared.get(key)
            if page is None:
                continue
            page.ref -= 1
            if page.ref <= 0:
                del self._shared[key]
                freed += 1
        if ent.tail is not None:
            freed += 1
        ent.chain, ent.tail, ent.others = [], None, []
        return freed

    def _evict_locked(self, keep_sid: str) -> None:
        """LRU-release other sessions until the pool fits. A victim all
        of whose pages are shared frees nothing by itself — survivors
        keep those pages — so the sweep continues to the next victim."""
        while self._physical_locked() > self.n_pages:
            victim = next((s for s in self._table if s != keep_sid), None)
            if victim is None:
                break   # only keep_sid remains; its own charge fits
            ent = self._table.pop(victim)
            self.evictions += 1
            self.evicted_pages += self._release_locked(ent)

    # ----------------------------------------------------------------- store
    def put(self, sid: str, tokens: int, leaves, ids=None) -> None:
        """Store/refresh ``sid``'s cache leaves and charge it for
        ``tokens`` decoded tokens, evicting LRU peers if the pool is
        full. With ``ids`` (the session's full token history, one id per
        token) and pageable leaves, sealed full pages are deduplicated
        against the shared store by exact prefix key. Raises
        ``CachePoolFullError`` when the session alone exceeds pool
        capacity."""
        need = self.pages_for(tokens)
        if need > self.n_pages:
            raise CachePoolFullError(
                f"session '{sid}' needs {need} pages "
                f"({tokens} tokens @ {self.page_tokens}/page) but the "
                f"pool holds {self.n_pages}")
        tokens = int(tokens)
        layout = None
        if self.prefix_sharing and ids is not None and len(ids) == tokens:
            layout = self._pageable_layout(tokens, leaves)
        with self._lock:
            ent = self._table.pop(sid, None)
            if layout is None:
                # legacy dense path (accounting-only, leaves verbatim)
                if ent is not None:
                    self._release_locked(ent)
                ent = _Entry()
                ent.tokens, ent.dense = tokens, leaves
                self._table[sid] = ent
                self._evict_locked(sid)
                return
            if self._layout is None:
                self._layout = layout
            if ent is None or not ent.paged:
                if ent is not None:
                    self._release_locked(ent)
                ent = _Entry()
            pt = self.page_tokens
            idst = tuple(int(i) for i in ids)
            n_full = tokens // pt
            # a re-prefill with a DIFFERENT history (sid reuse) must not
            # extend the stale chain — release and rebuild
            if ent.chain and (len(ent.chain) > n_full or ent.chain[-1]
                              != idst[:len(ent.chain) * pt]):
                self.evicted_pages += self._release_locked(ent)
            # the old tail is superseded by this put's fresh slices
            ent.tail = None
            pageable = layout[1]
            for p in range(len(ent.chain), n_full):
                key = idst[:(p + 1) * pt]
                page = self._shared.get(key)
                if page is not None:
                    page.ref += 1
                    self.page_hits += 1
                else:
                    page = _Page([np.ascontiguousarray(
                        leaves[i][:, p * pt:(p + 1) * pt])
                        for i in pageable])
                    self._shared[key] = page
                ent.chain.append(key)
            rem = tokens - n_full * pt
            if rem or not ent.chain:
                # always hold >= the admission floor of one page
                ent.tail = [np.ascontiguousarray(
                    leaves[i][:, n_full * pt:tokens]) for i in pageable]
            ent.others = [(i, leaves[i]) for i in range(layout[0])
                          if i not in pageable]
            ent.tokens = tokens
            ent.dense = None
            self._table[sid] = ent
            self._evict_locked(sid)

    def get(self, sid: str):
        """Cache leaves for ``sid`` (LRU-touched), or ``None`` if the
        session was evicted (caller re-prefills from token history).
        Paged sessions are reassembled to full-extent arrays; positions
        beyond the token frontier are zeros, which the fixed-extent
        attention never reads before overwriting."""
        with self._lock:
            ent = self._table.pop(sid, None)
            if ent is None:
                return None
            self._table[sid] = ent   # move to MRU end
            if not ent.paged:
                return ent.dense
            n_leaves, pageable, extents, dtypes = self._layout
            leaves: List[object] = [None] * n_leaves
            pt = self.page_tokens
            for j, i in enumerate(pageable):
                parts = [self._shared[key].slices[j] for key in ent.chain]
                if ent.tail is not None:
                    parts.append(ent.tail[j])
                row = parts[0].shape[2:]
                arr = np.zeros((1, extents[j]) + tuple(row), dtypes[j])
                if ent.tokens:
                    arr[:, :ent.tokens] = np.concatenate(parts, axis=1) \
                        if len(parts) > 1 else parts[0]
                leaves[i] = arr
            for i, leaf in ent.others:
                leaves[i] = leaf
            return leaves

    def match_prefix(self, sid: str, ids, align_tokens: Optional[int] = None
                     ) -> Tuple[int, Optional[dict]]:
        """Adopt the longest resident page chain matching a prefix of
        ``ids`` for a NEW session ``sid``: takes a reference on each
        matched page and installs the session's chain, so the caller can
        skip prefill compute for the covered tokens. Returns
        ``(n_tokens_covered, {leaf idx: [1, n, ...] partial})`` — or
        ``(0, None)`` when nothing matches. Always leaves at least one
        prompt token uncovered (the caller still needs logits for the
        last prompt token), and caps coverage at a multiple of
        ``align_tokens`` so the caller's segment ladder stays on its
        warmed rungs."""
        if not self.prefix_sharing:
            return 0, None
        with self._lock:
            if self._layout is None:
                return 0, None
            pt = self.page_tokens
            idst = tuple(int(i) for i in ids)
            limit = (len(idst) - 1) // pt
            if align_tokens:
                step = max(1, int(align_tokens) // pt)
                limit -= limit % step
            chain = []
            for p in range(limit):
                page = self._shared.get(idst[:(p + 1) * pt])
                if page is None:
                    break
                chain.append(idst[:(p + 1) * pt])
            if align_tokens:
                step = max(1, int(align_tokens) // pt)
                chain = chain[:len(chain) - (len(chain) % step)]
            if not chain:
                return 0, None
            # take the new references BEFORE releasing any old entry for
            # this sid: a live session re-prefilling over its own sealed
            # pages (repeat wire-op generate, speculative resync) would
            # otherwise free the very pages the chain just matched
            for key in chain:
                self._shared[key].ref += 1
            old = self._table.pop(sid, None)
            if old is not None:
                self._release_locked(old)
            ent = _Entry()
            ent.chain = list(chain)
            ent.tokens = len(chain) * pt
            self._table[sid] = ent
            self.prefix_matches += 1
            _, pageable, _, _ = self._layout
            partial = {}
            for j, i in enumerate(pageable):
                parts = [self._shared[key].slices[j] for key in chain]
                partial[i] = (np.concatenate(parts, axis=1)
                              if len(parts) > 1 else parts[0])
            return ent.tokens, partial

    def truncate(self, sid: str, to_tokens: int, others=None) -> bool:
        """Roll session ``sid`` back to its first ``to_tokens`` tokens —
        the speculative-decode reject path (serving/decode.py): positions
        fed past the accept point must leave the store. Drops the private
        partial tail past the accept point, decrements references on (and
        frees, at refcount zero) every sealed page wholly beyond it, and
        re-slices the boundary page's prefix into a fresh private tail
        when the accept point lands mid-page. COW-safe by construction:
        shared pages are immutable and only ever de-referenced here, so a
        page another session still holds survives untouched. ``others``
        (optional ``{leaf idx: replacement leaf}``) overwrites the
        non-pageable leaves — the pool treats them as opaque, so the
        caller owns their semantics (the decode engine moves its position
        carries back to the new frontier). Returns ``False`` when the
        session is absent, stored dense (opaque — the caller re-prefills
        from history instead), or ``to_tokens`` is not a shrink within
        the admission floor of one token."""
        to_tokens = int(to_tokens)
        with self._lock:
            ent = self._table.get(sid)
            if (ent is None or not ent.paged or to_tokens < 1
                    or to_tokens > ent.tokens):
                return False
            if to_tokens < ent.tokens:
                pt = self.page_tokens
                n_full = to_tokens // pt
                rem = to_tokens - n_full * pt
                tail = None
                if rem:
                    if len(ent.chain) > n_full:
                        boundary = self._shared[ent.chain[n_full]]
                        tail = [np.ascontiguousarray(s[:, :rem])
                                for s in boundary.slices]
                    elif ent.tail is not None:
                        tail = [np.ascontiguousarray(t[:, :rem])
                                for t in ent.tail]
                    else:       # nothing backs the boundary tokens
                        return False
                freed = 1 if ent.tail is not None else 0
                for key in ent.chain[n_full:]:
                    page = self._shared.get(key)
                    if page is None:
                        continue
                    page.ref -= 1
                    if page.ref <= 0:
                        del self._shared[key]
                        freed += 1
                if tail is not None:
                    freed -= 1   # the rebuilt tail still charges a page
                ent.chain = ent.chain[:n_full]
                ent.tail = tail
                ent.tokens = to_tokens
                self.truncations += 1
                self.truncated_pages += max(0, freed)
            if others:
                merged = dict(ent.others)
                merged.update({int(i): v for i, v in others.items()})
                ent.others = sorted(merged.items())
            return True

    def drop(self, sid: str) -> bool:
        """Voluntary release (session closed) — decrements this
        session's page references and frees whatever nobody else still
        holds, without counting as an eviction."""
        with self._lock:
            ent = self._table.pop(sid, None)
            if ent is None:
                return False
            self._release_locked(ent)
            return True
