"""Gloo rank processes on the CPU for the port's parallel tests: start a
fleet of ``world`` ranks running a worker script, let the test process
compute its references meanwhile, then wait for every rank (bounded) and
read what each wrote. Every process is killed in ``finally``. No JAX
import here: the rank processes import this module too."""

import json
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: put first in a worker script: joins the group on the CPU
PRELUDE = r"""
import json, os, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
port, world, rank, tmp = int(sys.argv[2]), int(sys.argv[3]), \
    int(sys.argv[4]), sys.argv[5]
from deeplearning4j_tpu_torch.parallel import distributed as D, make_mesh
D.initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=120)

def save(res, **arrays):
    np.savez(f"{tmp}/w{world}r{rank}.npz", **arrays)
    with open(f"{tmp}/w{world}r{rank}.json", "w") as fh:
        json.dump(res, fh)
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Fleet:
    """``world`` ranks of ``PRELUDE + body`` writing into ``tmp``."""

    def __init__(self, body, world, tmp):
        self.world, self.tmp = world, Path(tmp)
        port = free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", PRELUDE + body, str(ROOT), str(port),
             str(world), str(rank), str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(ROOT)) for rank in range(world)]

    def results(self, deadline):
        """[(json, npz arrays)] by rank, after every rank exited 0 by
        ``deadline`` (time.monotonic)."""
        import numpy as np
        logs = []
        for p in self.procs:
            _, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs.append((p.returncode, err[-3000:]))
        for rank, (rc, err) in enumerate(logs):
            assert rc == 0, f"rank {rank} of {self.world} exited {rc}:\n{err}"
        out = []
        for rank in range(self.world):
            base = self.tmp / f"w{self.world}r{rank}"
            with open(f"{base}.json") as f:
                res = json.load(f)
            out.append((res, dict(np.load(f"{base}.npz"))))
        return out

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def run_fleets(fleets, reference, timeout_s):
    """Start every (name, body, world, tmp) fleet, call ``reference()``
    while they run, and return ({name: results}, reference's value)."""
    started = {}
    try:
        for name, body, world, tmp in fleets:
            started[name] = Fleet(body, world, tmp)
        ref = reference()
        deadline = time.monotonic() + timeout_s
        return ({name: f.results(deadline) for name, f in started.items()},
                ref)
    finally:
        for f in started.values():
            f.kill()


def greedy(eng, prompts, n):
    """Greedy decode of each prompt on a decode engine (either
    package's): {sid: (tokens, [the logits row before each token])}."""
    import numpy as np
    out = {}
    for sid, ids in prompts.items():
        logits = np.asarray(eng.prefill(sid, ids), np.float64)
        toks, rows = [], []
        for _ in range(n):
            rows.append(logits)
            toks.append(int(np.argmax(logits)))
            logits = np.asarray(eng.step(sid, toks[-1]), np.float64)
        out[sid] = (toks, rows)
        eng.close_session(sid)
    return out
