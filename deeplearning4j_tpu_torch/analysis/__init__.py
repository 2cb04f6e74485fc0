"""Correctness analysis (counterpart of deeplearning4j_tpu/analysis):
the checks that hold the port's fragile contracts before a run trips
over them.

- :mod:`~deeplearning4j_tpu_torch.analysis.concurrency`: an AST pass
  over the port's sources, ``chip_smoke.py`` and its tests: unguarded
  ``acquire()``, untimed blocking calls (worse while a lock is held),
  non-daemon threads, and writes to ``@guarded_by`` attributes outside
  their lock.
- :mod:`~deeplearning4j_tpu_torch.analysis.fx_lint`: records the
  production train steps and forwards of the shipped models as aten
  graphs (``make_fx`` on the CPU, a ``TorchDispatchMode`` record on the
  card, the hand-written kernels as nodes of their own) and walks them
  for dtype hazards, values baked into the graph, re-allocated state
  and ops outside the determinism allowlist.
- :mod:`~deeplearning4j_tpu_torch.analysis.lockorder`: an opt-in
  instrumented lock wrapper recording the cross-thread acquisition-order
  graph; cycles are would-be deadlocks, long holds land in the span
  tracer.

Everything reports :class:`Finding`; ``python -m
deeplearning4j_tpu_torch.analysis`` gates them against the committed
``analysis/baseline.json``. This module stays import-light: the
threaded serving and datapipe modules import ``guards`` through it.
"""

from __future__ import annotations

import dataclasses
from typing import List

from deeplearning4j_tpu_torch.analysis.guards import guarded_by

__all__ = ["Finding", "guarded_by", "CODES", "sort_findings"]

#: finding code -> one-line meaning (the JAX package's codes and numbers)
CODES = {
    "DL4J-C001": "lock acquire() without a guaranteed release "
                 "(use `with` or try/finally)",
    "DL4J-C002": "untimed blocking call while a lock is held",
    "DL4J-C003": "untimed blocking call (no timeout/deadline)",
    "DL4J-C004": "non-daemon thread with no join-on-shutdown",
    "DL4J-C005": "write to a @guarded_by attribute outside its lock",
    "DL4J-J000": "analysis target failed to trace",
    "DL4J-J001": "f32 mm/addmm/bmm/convolution on f32 master weights "
                 "under a half-precision compute policy",
    "DL4J-J002": "float64 value in the aten graph",
    "DL4J-J003": "a value baked into the graph (value-varied calls of "
                 "one shape record different graphs, or capture again)",
    "DL4J-J004": "fit step re-allocates params/optimizer state",
    "DL4J-J005": "aten op outside the determinism allowlist",
    "DL4J-L001": "lock acquisition-order cycle (would-be deadlock)",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis finding. ``fingerprint()`` leaves the line number out
    so the committed baseline survives edits that shift code."""

    code: str      #: DL4J-Cxxx / DL4J-Jxxx / DL4J-L001
    path: str      #: repo-relative source path, or "<fx>" for a target
    line: int      #: 1-based line (0 when not tied to a source line)
    symbol: str    #: enclosing Class.method / function / target name
    message: str   #: human-readable detail (stable: no line numbers)

    def fingerprint(self) -> str:
        return f"{self.code}|{self.path}|{self.symbol}|{self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Finding":
        return Finding(code=d["code"], path=d["path"],
                       line=int(d.get("line", 0)),
                       symbol=d.get("symbol", ""),
                       message=d.get("message", ""))

    def __str__(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{self.code} {loc} [{self.symbol}] {self.message}"


def sort_findings(findings: List[Finding]) -> List[Finding]:
    """Stable report order: by code, then path, then line."""
    return sorted(findings, key=lambda f: (f.code, f.path, f.line,
                                           f.symbol, f.message))
