"""The port's correctness-analysis gate (counterpart of
scripts/static_check.py): run the analysis passes and diff the findings
against the committed ``analysis/baseline.json``.

Two passes run:

- the **concurrency lint** (analysis/concurrency.py): an AST sweep over
  deeplearning4j_tpu_torch/, chip_smoke.py and tests/test_torch_*.py;
- the **fx hazard lint** (analysis/fx_lint.py): records the fit steps and
  forwards of the shipped models on the CPU (``make_fx`` over the plain
  versions, a few seconds) and walks the graphs for dtype leaks, baked-in
  values, re-allocated state and ops outside the determinism allowlist.

The gate is a ratchet:

- a finding NOT in the baseline (or exceeding its baselined count)
  **fails**: new hazards don't land;
- a baselined finding that no longer occurs also **fails** ("stale
  baseline") until the baseline is shrunk with ``--update-baseline``:
  fixed hazards can't silently come back.

Baseline entries key on ``code|path|symbol|message`` (no line numbers).
The shipped baseline is empty.

Usage:
    python -m deeplearning4j_tpu_torch.analysis                  # the gate
    python -m deeplearning4j_tpu_torch.analysis --json out.json  # findings
    python -m deeplearning4j_tpu_torch.analysis --update-baseline
    python -m deeplearning4j_tpu_torch.analysis --skip-fx        # AST only

Exit status 0 = findings match the baseline, 1 = new or stale findings
(each printed on its own line), 2 = usage / unreadable baseline.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(_HERE))
DEFAULT_BASELINE = os.path.join(_HERE, "baseline.json")


def collect_findings(skip_fx: bool = False, repo: str = REPO):
    from deeplearning4j_tpu_torch.analysis import concurrency, sort_findings

    findings = concurrency.lint_tree(repo) + concurrency.lint_tests(repo)
    if not skip_fx:
        from deeplearning4j_tpu_torch.analysis import fx_lint
        findings.extend(fx_lint.lint_all())
    return sort_findings(findings)


def _counts(findings) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        fp = f.fingerprint()
        out[fp] = out.get(fp, 0) + 1
    return out


def load_baseline(path: str) -> Dict[str, int]:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {k: int(v) for k, v in data.get("findings", {}).items()}


def write_baseline(path: str, counts: Dict[str, int]) -> None:
    data = {
        "_comment": "Committed findings the analysis gate tolerates "
                    "(fingerprint -> count). New findings fail; fixed "
                    "findings must be removed here (--update-baseline) "
                    "so they cannot return.",
        "findings": {k: counts[k] for k in sorted(counts)},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)
        f.write("\n")


def gate(findings, baseline: Dict[str, int]) -> List[str]:
    """-> violation lines (empty == gate passes)."""
    found = _counts(findings)
    by_fp = {}
    for f in findings:
        by_fp.setdefault(f.fingerprint(), f)
    problems = []
    for fp, n in sorted(found.items()):
        base = baseline.get(fp, 0)
        if n > base:
            problems.append(f"NEW ({n} > baseline {base}): {by_fp[fp]}")
    for fp, base in sorted(baseline.items()):
        n = found.get(fp, 0)
        if n < base:
            problems.append(
                f"STALE baseline entry ({n} < baseline {base}) — fixed? "
                f"shrink it with --update-baseline: {fp}")
    return problems


def main(argv=None, repo: str = REPO) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON (default analysis/baseline.json)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the findings as JSON to PATH "
                         "('-' for stdout)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to the current findings")
    ap.add_argument("--skip-fx", action="store_true",
                    help="run only the AST pass (no model recording)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0

    try:
        baseline = load_baseline(args.baseline)
    except (OSError, ValueError) as e:
        print(f"unreadable baseline {args.baseline}: {e}", file=sys.stderr)
        return 2

    findings = collect_findings(skip_fx=args.skip_fx, repo=repo)

    if args.json:
        payload = json.dumps([f.to_dict() for f in findings], indent=2)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w", encoding="utf-8") as f:
                f.write(payload + "\n")

    if args.update_baseline:
        write_baseline(args.baseline, _counts(findings))
        print(f"baseline updated: {len(findings)} finding(s) -> "
              f"{args.baseline}")
        return 0

    problems = gate(findings, baseline)
    if problems:
        for line in problems:
            print(line)
        print(f"analysis: {len(problems)} problem(s) "
              f"({len(findings)} finding(s) vs baseline "
              f"{os.path.basename(args.baseline)})")
        return 1
    print(f"analysis: OK ({len(findings)} finding(s), all baselined; "
          f"baseline entries: {len(baseline)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
