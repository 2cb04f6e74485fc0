"""Stats storage backends (counterpart of deeplearning4j_tpu/ui/storage.py;
host only, and the same JSONL records, so a file either package writes
reads in the other).

Parity: deeplearning4j-ui-model storage/ — the StatsStorage API
(BaseCollectionStatsStorage.java) decouples stat producers (listeners)
from consumers (the web server): sessions hold per-worker streams of
timestamped updates plus one static-info record. `InMemoryStatsStorage`
keeps everything in maps (InMemoryStatsStorage.java parity);
`FileStatsStorage` persists every record so a dashboard can be pointed at
a finished/crashed run (FileStatsStorage.java parity — MapDB there,
append-only JSONL here: human-greppable, crash-safe, no native deps).

Storage listeners receive (event_type, session_id, worker_id) callbacks
(StatsStorageListener analogue) so a live server can push/poll updates.
"""

from __future__ import annotations

import json
import os
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.ui.stats import StatsReport

# storage event types (StatsStorageListener.EventType analogue)
NEW_SESSION = "new_session"
NEW_WORKER = "new_worker"
POST_UPDATE = "post_update"
POST_STATIC = "post_static"


class BaseStatsStorage:
    """Session -> worker -> ordered updates, plus per-session static info."""

    def __init__(self):
        self._lock = threading.RLock()
        # {session: {worker: [StatsReport, ...]}}
        self._updates: Dict[str, Dict[str, List[StatsReport]]] = (
            defaultdict(dict))
        # {session: {worker: dict}} — model/config metadata posted once
        self._static: Dict[str, Dict[str, dict]] = defaultdict(dict)
        self._listeners: List[Callable[[str, str, str], None]] = []

    # ----------------------------------------------------------- producers
    def put_update(self, report: StatsReport) -> None:
        with self._lock:
            sess, worker = report.session_id, report.worker_id
            new_session = sess not in self._updates
            new_worker = not new_session and worker not in self._updates[sess]
            self._updates[sess].setdefault(worker, []).append(report)
            self._persist_update(report)
        if new_session:
            self._notify(NEW_SESSION, sess, worker)
        if new_session or new_worker:
            self._notify(NEW_WORKER, sess, worker)
        self._notify(POST_UPDATE, sess, worker)

    def put_static_info(self, session_id: str, worker_id: str,
                        info: dict) -> None:
        with self._lock:
            # MERGE by key: independent producers share one worker slot
            # (StatsListener posts {"model": ...}, the distributed
            # trainers post {"phase_stats": ...}; replacement would make
            # them clobber each other)
            merged = dict(self._static[session_id].get(worker_id) or {})
            merged.update(info)
            self._static[session_id][worker_id] = merged
            self._persist_static(session_id, worker_id, info)
        self._notify(POST_STATIC, session_id, worker_id)

    # ----------------------------------------------------------- consumers
    def list_session_ids(self) -> List[str]:
        with self._lock:
            return sorted(set(self._updates) | set(self._static))

    def list_worker_ids_for_session(self, session_id: str) -> List[str]:
        with self._lock:
            return sorted(set(self._updates.get(session_id, {}))
                          | set(self._static.get(session_id, {})))

    def get_all_updates(self, session_id: str,
                        worker_id: Optional[str] = None) -> List[StatsReport]:
        with self._lock:
            workers = self._updates.get(session_id, {})
            if worker_id is not None:
                return list(workers.get(worker_id, []))
            out: List[StatsReport] = []
            for reports in workers.values():
                out.extend(reports)
            out.sort(key=lambda r: (r.iteration, r.timestamp))
            return out

    def get_all_updates_after(self, session_id: str, timestamp: float,
                              worker_id: Optional[str] = None
                              ) -> List[StatsReport]:
        return [r for r in self.get_all_updates(session_id, worker_id)
                if r.timestamp > timestamp]

    def get_latest_update(self, session_id: str,
                          worker_id: Optional[str] = None
                          ) -> Optional[StatsReport]:
        updates = self.get_all_updates(session_id, worker_id)
        return updates[-1] if updates else None

    def get_static_info(self, session_id: str,
                        worker_id: str) -> Optional[dict]:
        with self._lock:
            return self._static.get(session_id, {}).get(worker_id)

    def num_updates(self, session_id: str,
                    worker_id: Optional[str] = None) -> int:
        return len(self.get_all_updates(session_id, worker_id))

    # ----------------------------------------------------------- listeners
    def register_listener(self,
                          fn: Callable[[str, str, str], None]) -> None:
        self._listeners.append(fn)

    def deregister_listener(self,
                            fn: Callable[[str, str, str], None]) -> None:
        self._listeners = [l for l in self._listeners if l is not fn]

    def _notify(self, event: str, session_id: str, worker_id: str) -> None:
        for fn in list(self._listeners):
            fn(event, session_id, worker_id)

    # ------------------------------------------------------- persistence
    def _persist_update(self, report: StatsReport) -> None:
        pass

    def _persist_static(self, session_id: str, worker_id: str,
                        info: dict) -> None:
        pass

    def close(self) -> None:
        pass


class InMemoryStatsStorage(BaseStatsStorage):
    """Purely in-memory (InMemoryStatsStorage.java parity)."""


class FileStatsStorage(BaseStatsStorage):
    """Append-only JSONL-backed storage. Records survive process death and
    an existing file is fully reloaded on open, so a dashboard can attach
    to a past run (FileStatsStorage.java capability parity)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._file = None
        if os.path.exists(path):
            self._load()
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._file = open(path, "a", encoding="utf-8")

    def _load(self) -> None:
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail write after a crash
                kind = rec.get("kind")
                if kind == "update":
                    r = StatsReport.from_dict(rec["report"])
                    self._updates[r.session_id].setdefault(
                        r.worker_id, []).append(r)
                elif kind == "static":
                    # merge-by-key replay, matching put_static_info's
                    # semantics — records are persisted PARTIAL (one
                    # producer's keys each), so replacement would let the
                    # last producer clobber the others on reload
                    slot = self._static[rec["session_id"]]
                    merged = dict(slot.get(rec["worker_id"]) or {})
                    merged.update(rec["info"])
                    slot[rec["worker_id"]] = merged

    def _write(self, rec: dict) -> None:
        if self._file is None:
            return
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def _persist_update(self, report: StatsReport) -> None:
        self._write({"kind": "update", "report": report.to_dict()})

    def _persist_static(self, session_id: str, worker_id: str,
                        info: dict) -> None:
        self._write({"kind": "static", "session_id": session_id,
                     "worker_id": worker_id, "info": dict(info)})

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
