"""The port's fleet launcher (deeplearning4j_tpu_torch/resilience/
launcher.py) against the JAX package's, on the launcher cases of
``tests/test_crossproc.py``: each case runs through both launchers on the
same ``python -c`` argv, and their records are compared field by field
(pids, durations and coordinator ports aside, which differ by nature).

The workers read the fleet coordinates from whichever launcher started
them: the JAX package exports ``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID`` and
keeps the global device count through ``XLA_FLAGS``; the port exports
what ``parallel.distributed.initialize`` reads (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) and keeps the global card count through
``CUDA_VISIBLE_DEVICES``.
"""

import socket
import sys
import time

import pytest

from deeplearning4j_tpu.resilience import launcher as jl
from deeplearning4j_tpu_torch.resilience import launcher as tl

SIZE = ("int(os.environ.get('JAX_NUM_PROCESSES') "
        "or os.environ['WORLD_SIZE'])")
RANK = "(os.environ.get('JAX_PROCESS_ID') or os.environ['RANK'])"


def _sh(code):
    def build_argv(size, rank, coordinator):
        return [sys.executable, "-c", code]
    return build_argv


def _worker_fields(w):
    return (w.rank, w.returncode, w.killed, w.peer_lost)


def _launch_fields(rec):
    return (rec.index, rec.size, rec.ok, rec.failed_ranks,
            rec.peer_lost_ranks, [_worker_fields(w) for w in rec.workers])


def _both(method, code, *args, **kw):
    """``method`` of each package's launcher on the same argv: (jax, port)
    records."""
    out = []
    for mod in (jl, tl):
        launcher = mod.FleetLauncher(_sh(code), launch_timeout_s=60.0, **kw)
        out.append(getattr(launcher, method)(*args))
    for rec in out:
        for launch in getattr(rec, "launches", [rec]):
            assert launch.coordinator.startswith("127.0.0.1:")
            assert all(w.pid > 0 and w.duration_s is not None
                       for w in launch.workers)
    return out


def _same_fleet(j, t):
    assert (j.status, j.final_size, j.relaunches) == \
        (t.status, t.final_size, t.relaunches)
    assert [_launch_fields(r) for r in j.launches] == \
        [_launch_fields(r) for r in t.launches]


def test_launcher_clean_fleet_completes():
    j, t = _both("run", "import sys; sys.exit(0)", 2,
                 straggler_grace_s=5.0)
    _same_fleet(j, t)
    assert t.status == "completed" and t.final_size == 2
    assert t.relaunches == 0 and t.launches[0].ok


def test_launcher_shrinks_on_failure_until_success():
    code = f"import os, sys; sys.exit(1 if {SIZE} > 1 else 0)"
    j, t = _both("run", code, 4, min_size=1, max_launches=4,
                 straggler_grace_s=1.0)
    _same_fleet(j, t)
    assert [rec.size for rec in t.launches] == [4, 2, 1]


def test_launcher_classifies_peer_lost_exits():
    code = (f"import os, sys; sys.exit({tl.PEER_LOST_EXIT} "
            f"if {RANK} == '0' else 7)")
    j, t = _both("launch_once", code, 2, straggler_grace_s=1.0)
    assert _launch_fields(j) == _launch_fields(t)
    assert t.peer_lost_ranks == [0] and sorted(t.failed_ranks) == [0, 1]
    assert tl.PEER_LOST_EXIT == jl.PEER_LOST_EXIT


def test_launcher_kills_stragglers_after_grace():
    code = (f"import os, sys, time; sys.exit(2) if {RANK} == '0' "
            "else time.sleep(60)")
    t0 = time.monotonic()
    j, t = _both("launch_once", code, 2, straggler_grace_s=0.3)
    assert time.monotonic() - t0 < 30.0
    assert [(w.rank, w.killed) for w in j.workers] == \
        [(w.rank, w.killed) for w in t.workers]
    straggler = t.workers[1]
    assert straggler.killed and straggler.returncode not in (0, None)
    assert t.workers[0].returncode == 2 and not t.workers[0].killed


def test_launcher_keeps_global_device_count_constant():
    # K = total_devices // size devices a worker: the JAX package's in
    # XLA_FLAGS, the port's as the cards CUDA_VISIBLE_DEVICES names
    code = ("import os, sys; "
            "f = os.environ.get('XLA_FLAGS', ''); "
            "c = os.environ.get('CUDA_VISIBLE_DEVICES', ''); "
            "sys.exit(0 if '--xla_force_host_platform_device_count=2' in f "
            "or len(c.split(',')) == 2 else 3)")
    j, t = _both("run", code, 2, total_devices=4, straggler_grace_s=1.0)
    _same_fleet(j, t)
    assert t.status == "completed", t.launches[0].workers
    env = tl.FleetLauncher(_sh("pass"), total_devices=4)._worker_env(2, 1, 0)
    assert env["CUDA_VISIBLE_DEVICES"] == "2,3"


def test_launcher_rejects_indivisible_device_count():
    for mod in (jl, tl):
        launcher = mod.FleetLauncher(_sh("pass"), total_devices=4)
        with pytest.raises(ValueError, match="not divisible"):
            launcher._worker_env(3, 0, 0)


def test_launcher_env_identity():
    got = {}
    for mod in (jl, tl):
        launcher = mod.FleetLauncher(_sh("pass"), run_id="fleet-X",
                                     extra_env={"EXTRA": "1"})
        got[mod] = launcher._worker_env(2, 1, 5)
    keys = ("DL4J_TPU_RUN_ID", "DL4J_TPU_INSTANCE", "DL4J_TPU_INCARNATION",
            "EXTRA")
    assert [got[jl][k] for k in keys] == [got[tl][k] for k in keys] == \
        ["fleet-X", "worker-1", "5", "1"]
    assert (got[jl]["JAX_NUM_PROCESSES"], got[jl]["JAX_PROCESS_ID"]) == \
        (got[tl]["WORLD_SIZE"], got[tl]["RANK"]) == ("2", "1")
    env = tl.FleetLauncher(_sh("pass"))._worker_env(2, 1, 0,
                                                    "127.0.0.1:4242")
    assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("127.0.0.1", "4242")


def test_free_port_is_bindable():
    for mod in (jl, tl):
        port = mod.free_port()
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))


def test_launcher_imports_no_torch():
    """The launcher is testable without the framework: importing it
    imports neither torch nor the JAX package."""
    import subprocess
    code = ("import sys; sys.path.insert(0, '.'); "
            "import importlib.util as u, os; "
            "spec = u.spec_from_file_location('l', os.path.join("
            "'deeplearning4j_tpu_torch', 'resilience', 'launcher.py')); "
            "m = u.module_from_spec(spec); sys.modules['l'] = m; "
            "spec.loader.exec_module(m); "
            "print(sorted(k for k in ('torch', 'jax', 'deeplearning4j_tpu')"
            " if k in sys.modules))")
    from pathlib import Path
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60,
                       cwd=str(Path(__file__).resolve().parents[1]))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_launcher_cli_substitutes_the_coordinates(tmp_path):
    """``python -m deeplearning4j_tpu_torch.resilience.launcher -n 2 --
    CMD``: each worker's argv gets its size, rank and coordinator."""
    out = tmp_path / "w"
    code = ("import sys; open(sys.argv[1] + sys.argv[3], 'w').write("
            "' '.join(sys.argv[2:]))")
    rc = tl.main(["-n", "2", "--grace", "1", "--", sys.executable, "-c",
                  code, str(out), "{size}", "{rank}", "{coordinator}"])
    assert rc == 0
    for r in (0, 1):
        size, rank, coord = (out.parent / f"w{r}").read_text().split()
        assert (size, rank) == ("2", str(r))
        assert coord.startswith("127.0.0.1:")
