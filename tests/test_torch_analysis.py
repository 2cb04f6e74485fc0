"""The port's concurrency lint and its gate (deeplearning4j_tpu_torch/
analysis/concurrency.py and __main__.py) against the JAX package's.

The port's ``lint_source`` must give the JAX one's findings, field for
field, on every fixture of tests/test_analysis.py (read from that file,
so a fixture added there is held here too) and on every source file of
both packages, chip_smoke.py and the port's tests. The port's tree and
tests lint clean: a new unbounded wait in a port test fails here at
once, before it can hold a test worker past the run's time limit.
"""

import ast
import json
from pathlib import Path

import pytest

from deeplearning4j_tpu.analysis import concurrency as jconc
from deeplearning4j_tpu_torch.analysis import (CODES, Finding, concurrency,
                                               fx_lint, sort_findings)
from deeplearning4j_tpu_torch.analysis import __main__ as gate_main

ROOT = Path(__file__).resolve().parents[1]


def _fixtures():
    """Every ``src = \"\"\"...\"\"\"`` of tests/test_analysis.py's
    concurrency tests, by test name, and the wrong-code suppression
    variant that file derives from one."""
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)
                    and any(getattr(t, "id", None) == "src"
                            for t in node.targets)):
                out[fn.name] = node.value.value
    src = out["test_suppression_comment_silences_a_finding"]
    out["suppression_for_another_code"] = src.replace("C003", "C001")
    out["syntax_error"] = "def broken(:\n"
    return out


FIXTURES = _fixtures()


def _fields(findings):
    return [(f.code, f.path, f.line, f.symbol, f.message) for f in findings]


def test_every_concurrency_fixture_is_read():
    assert {"test_c001_acquire_without_guaranteed_release",
            "test_c002_untimed_http_call_while_lock_held",
            "test_c003_untimed_blocking_calls", "test_c004_non_daemon_thread",
            "test_c005_guarded_attr_written_outside_lock",
            "test_clean_module_negative"} <= set(FIXTURES)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_equal_the_jax_lint(name):
    src = FIXTURES[name]
    got = _fields(concurrency.lint_source(src, "fix.py"))
    assert got == _fields(jconc.lint_source(src, "fix.py"))


@pytest.mark.parametrize("code", ["C001", "C002", "C003", "C004", "C005"])
def test_each_code_has_a_fixture_that_raises_it(code):
    found = {f.code for src in FIXTURES.values()
             for f in concurrency.lint_source(src, "fix.py")}
    assert "DL4J-" + code in found


def _sources(root):
    return sorted(p for p in (ROOT / root).rglob("*.py")
                  if "__pycache__" not in p.parts)


@pytest.mark.parametrize("root", ["deeplearning4j_tpu_torch",
                                  "deeplearning4j_tpu", "tests", "scripts"])
def test_every_source_file_lints_as_the_jax_lint_does(root):
    for p in _sources(root):
        rel = str(p.relative_to(ROOT))
        src = p.read_text(encoding="utf-8")
        assert _fields(concurrency.lint_source(src, rel)) == \
            _fields(jconc.lint_source(src, rel)), rel


def test_the_port_tree_lints_clean():
    findings = concurrency.lint_tree(str(ROOT))
    assert findings == [], "\n".join(str(f) for f in findings)


def test_the_port_tests_lint_clean():
    """Every port test file: no non-daemon thread, no untimed join, get
    or result (a blocked one keeps its test worker from exiting)."""
    findings = concurrency.lint_tests(str(ROOT))
    assert findings == [], "\n".join(str(f) for f in findings)
    assert len({f for f in ROOT.glob(concurrency.TEST_GLOB)}) > 50


def test_default_roots_are_the_port_and_chip_smoke():
    assert concurrency.DEFAULT_ROOTS == ("deeplearning4j_tpu_torch",
                                         "chip_smoke.py")


def test_codes_keep_the_jax_numbers():
    from deeplearning4j_tpu.analysis import CODES as JCODES
    assert set(CODES) == set(JCODES)
    assert "aten" in CODES["DL4J-J005"]


def test_finding_roundtrip_and_ordering():
    a = Finding("DL4J-C003", "b.py", 9, "f", "m")
    b = Finding("DL4J-C001", "z.py", 1, "g", "m")
    assert Finding.from_dict(a.to_dict()) == a
    assert sort_findings([a, b]) == [b, a]
    assert "9" not in a.fingerprint()
    assert str(a) == "DL4J-C003 b.py:9 [f] m"


# ------------------------------------------------------------- the gate
def _repo(tmp_path, module_src):
    pkg = tmp_path / "deeplearning4j_tpu_torch"
    pkg.mkdir()
    (pkg / "mod.py").write_text(module_src)
    (tmp_path / "chip_smoke.py").write_text("")
    return str(tmp_path)


def test_gate_passes_on_the_shipped_tree(capsys):
    assert gate_main.main(["--skip-fx"]) == 0
    assert "analysis: OK" in capsys.readouterr().out
    assert gate_main.load_baseline(gate_main.DEFAULT_BASELINE) == {}


def test_gate_fails_on_an_untimed_join(tmp_path, capsys):
    repo = _repo(tmp_path, "def stop(t):\n    t.join()\n")
    base = tmp_path / "baseline.json"
    gate_main.write_baseline(str(base), {})
    assert gate_main.main(["--skip-fx", "--baseline", str(base)],
                          repo=repo) == 1
    assert "NEW" in capsys.readouterr().out
    (tmp_path / "timed").mkdir()
    timed = _repo(tmp_path / "timed",
                  "def stop(t):\n    t.join(timeout=5)\n")
    assert gate_main.main(["--skip-fx", "--baseline", str(base)],
                          repo=timed) == 0


def test_gate_fails_on_a_stale_entry_until_updated(tmp_path, capsys):
    repo = _repo(tmp_path, "X = 1\n")
    base = tmp_path / "baseline.json"
    gate_main.write_baseline(str(base), {"DL4J-C003|gone.py|f|m": 1})
    assert gate_main.main(["--skip-fx", "--baseline", str(base)],
                          repo=repo) == 1
    assert "STALE" in capsys.readouterr().out
    assert gate_main.main(["--skip-fx", "--baseline", str(base),
                           "--update-baseline"], repo=repo) == 0
    assert gate_main.load_baseline(str(base)) == {}
    assert gate_main.main(["--skip-fx", "--baseline", str(base)],
                          repo=repo) == 0


def test_gate_usage_and_unreadable_baseline_exit_2(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert gate_main.main(["--skip-fx", "--baseline", str(bad)]) == 2
    assert gate_main.main(["--no-such-flag"]) == 2


def test_gate_runs_the_fx_lint_unless_skipped(tmp_path, monkeypatch,
                                              capsys):
    repo = _repo(tmp_path, "X = 1\n")
    base = tmp_path / "baseline.json"
    gate_main.write_baseline(str(base), {})
    calls = []
    found = Finding("DL4J-J005", "<fx>", 0, "t", "aten op 'x'")
    monkeypatch.setattr(fx_lint, "lint_all",
                        lambda: calls.append(1) or [found])
    assert gate_main.main(["--baseline", str(base)], repo=repo) == 1
    assert gate_main.main(["--skip-fx", "--baseline", str(base)],
                          repo=repo) == 0
    assert calls == [1]
    out = tmp_path / "f.json"
    gate_main.main(["--baseline", str(base), "--json", str(out)], repo=repo)
    assert json.loads(out.read_text()) == [found.to_dict()]
