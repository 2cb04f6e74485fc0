"""The supervisor's cross-process coordination and the fleet launcher
(deeplearning4j_tpu_torch/resilience) on the CPU: the port's counterpart
of the JAX package's ``scripts/chaos_multihost.py``.

Each arm is a real fleet of two gloo worker processes started by the
port's ``FleetLauncher``: a small F32 MLN transplanted from the JAX
package, meshed over both ranks, fed by ``fit_pipeline`` over a datapipe
sharded by rank, supervised with ``coordinate=True``. One fault plan is
built the same way on every rank and fires where it is targeted.

- Arm A: a NaN param leaf on rank 0 alone at step 4. Both ranks roll
  back to the same checkpoint; the finished params are bit-equal across
  ranks and to a no-fault control fleet, and within f32 tolerance of the
  JAX package's one-process supervised run of the same net and plan
  (2e-5 absolute, 2e-4 relative: the two ranks' gradients summed against
  one process's batch gradient, over 8 Adam steps at lr 1e-2).
- Arm B: SIGKILL on rank 1 at step 5. Rank 0 names it within the
  collective deadline, writes a ``peer_lost`` flight record and no
  further checkpoint, and exits ``PEER_LOST_EXIT``; the launcher
  relaunches one process, which restores the two-process checkpoint
  (a ``reshard`` event), consumes the records from the low-water mark
  exactly, and lands bit for bit on a one-process control that restores
  the same checkpoint.
- Arm C: SIGTERM on rank 1 only. Both ranks stop at the same step and
  write one barriered checkpoint; each rank's params equal the
  checkpoint's, restored in this process, bit for bit.
- A kill of rank 0, the store's host, ends rank 1 with
  ``PEER_LOST_EXIT`` within the deadline as well.
"""

import glob
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu import datapipe as jdatapipe
from deeplearning4j_tpu import resilience as jres
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import datapipe
from deeplearning4j_tpu_torch.datapipe.reshard import (low_water_mark,
                                                       remap_for)
from deeplearning4j_tpu_torch.resilience.launcher import (PEER_LOST_EXIT,
                                                          FleetLauncher)
from deeplearning4j_tpu_torch.utils.checkpoint import (
    find_latest_checkpoint, read_checkpoint_meta,
    restore_multi_layer_network)

ROOT = Path(__file__).resolve().parents[1]
SEED = 17
N_RECORDS = 64
GLOBAL_BATCH = 8
CKPT_EVERY = 3
POISON_STEP = 4
KILL_STEP = 5
SIGTERM_STEP = 4
TIMEOUT_S = 4.0          # the fleets' collective deadline
LAUNCH_TIMEOUT_S = 120.0
STEPS = N_RECORDS // GLOBAL_BATCH

_WORKER = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
root, zipp, ckpt, out, arm, size, rank, coord = sys.argv[1:9]
faults = json.loads(sys.argv[9])
size, rank = int(size), int(rank)
from deeplearning4j_tpu_torch import datapipe
from deeplearning4j_tpu_torch.parallel import distributed as D
from deeplearning4j_tpu_torch.parallel import make_mesh
from deeplearning4j_tpu_torch.parallel.stats import TrainingStatsCollector
from deeplearning4j_tpu_torch.resilience import (
    PEER_LOST_EXIT, FaultInjector, SupervisorConfig, TrainingSupervisor)
from deeplearning4j_tpu_torch.utils import serialization as tser

D.initialize(coord, size, rank, device="cpu")
net = tser.restore_multi_layer_network(zipp, device="cpu")
net.use_mesh(make_mesh())
d = np.load(os.path.join(out, "..", "data.npz"))
seen = []

def track(rec):
    seen.append(int(round(float(rec[0][0]))))
    return rec

pipe = (datapipe.from_arrays(d["x"], d["y"]).shard(size, rank)
        .map(track).batch(%(batch)d // size))
inj = FaultInjector()
if "poison" in faults:
    inj.poison_step(faults["poison"][0], rank=faults["poison"][1])
if "kill" in faults:
    inj.kill_at_step(faults["kill"][0], rank=faults["kill"][1])
if "sigterm" in faults:
    inj.sigterm_at_step(faults["sigterm"][0], rank=faults["sigterm"][1])
cfg = SupervisorConfig(checkpoint_dir=ckpt, checkpoint_every_steps=%(every)d,
                       keep_checkpoints=10, backoff_initial_s=0.01,
                       nan_lr_backoff=1.0, coordinate=True,
                       collective_timeout_s=%(timeout)r)
st = TrainingStatsCollector(worker_id=f"worker_{rank}")
sup = TrainingSupervisor(net, cfg, injector=inj, stats_collector=st)
with inj.installed():
    res = sup.fit_pipeline(pipe, epochs=1)
inc = os.environ.get("DL4J_TPU_INCARNATION", "0")
np.savez(os.path.join(out, f"params_l{inc}_r{rank}.npz"),
         **{f"{k}/{p}": v.detach().numpy() for k, s in net.params.items()
            for p, v in s.items()})
doc = {"status": res.status, "final_step": res.final_step, "size": size,
       "resumed_from": res.resumed_from and os.path.basename(
           res.resumed_from),
       "events": [[e.kind, e.step, e.detail] for e in res.events],
       "stats": res.stats, "peer_loss": res.peer_loss, "seen": seen,
       "phases": sorted({e.phase for e in st.events}),
       "env": {k: os.environ.get(k) for k in ("WORLD_SIZE", "RANK",
               "MASTER_ADDR", "MASTER_PORT", "DL4J_TPU_INSTANCE")}}
with open(os.path.join(out, f"result_l{inc}_r{rank}.json"), "w") as f:
    json.dump(doc, f)
if res.status == "peer_lost":
    sys.stdout.flush(); sys.stderr.flush()
    os._exit(PEER_LOST_EXIT)
D.shutdown()
""" % {"batch": GLOBAL_BATCH, "every": CKPT_EVERY, "timeout": TIMEOUT_S}

F32J = JDtypePolicy(param_dtype="float32", compute_dtype="float32")


def _jax_net():
    conf = (JNNC.builder().seed(SEED).updater(JAdam(1e-2)).dtype(F32J)
            .list()
            .layer(JDense(n_in=12, n_out=16, activation="tanh"))
            .layer(JOutput(n_out=4, activation="softmax", loss="mcxent"))
            .build())
    return JMLN(conf).init()


def _data():
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(N_RECORDS, 12)).astype(np.float32)
    x[:, 0] = np.arange(N_RECORDS)   # the record id rides in column 0
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, N_RECORDS)]
    return x, y


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The start zip and the data, shared by every arm."""
    root = tmp_path_factory.mktemp("coordinated")
    x, y = _data()
    np.savez(root / "data.npz", x=x, y=y)
    jser.write_model(_jax_net(), str(root / "start.zip"))
    return root


def _fleet(root, arm, faults, *, max_launches=1, audit=None):
    """One arm's fleet through the port's launcher; returns (FleetResult,
    checkpoint dir, output dir)."""
    ckpt, out = root / f"ckpt{arm}", root / f"out{arm}"
    out.mkdir()

    def build_argv(size, rank, coordinator):
        return [sys.executable, "-c", _WORKER, str(ROOT),
                str(root / "start.zip"), str(ckpt), str(out), arm,
                str(size), str(rank), coordinator, json.dumps(faults)]

    class Audited(FleetLauncher):
        def launch_once(self, size, launch_index=0):
            rec = super().launch_once(size, launch_index)
            if audit is not None:
                audit(rec)
            return rec

    res = Audited(build_argv, min_size=1, max_launches=max_launches,
                  straggler_grace_s=3 * TIMEOUT_S,
                  launch_timeout_s=LAUNCH_TIMEOUT_S, cwd=str(ROOT),
                  log_dir=str(out)).run(2)
    return res, ckpt, out


def _result(out, launch, rank):
    return json.loads((out / f"result_l{launch}_r{rank}.json").read_text())


def _params(out, launch, rank):
    return dict(np.load(out / f"params_l{launch}_r{rank}.npz"))


def _logs(out):
    return "\n".join(Path(p).read_text()[-2000:]
                     for p in sorted(glob.glob(str(out / "*.log"))))


def _assert_bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def _kinds(doc, kind):
    return [e for e in doc["events"] if e[0] == kind]


def _net_params(net):
    return {f"{k}/{p}": v.detach().numpy() for k, s in net.params.items()
            for p, v in s.items()}


@pytest.fixture(scope="module")
def fleets(drill):
    """Every arm's fleet, started at once on daemon threads (each bounded
    by the launcher's own timeout and a join with a deadline): {arm:
    (FleetResult, checkpoint dir, output dir, seconds)}, and arm B's
    audit of the checkpoint the kill left."""
    state = {}

    def audit(rec):
        if rec.peer_lost_ranks:
            latest = find_latest_checkpoint(str(drill / "ckptB"))
            state["latest"] = latest
            state["meta"] = read_checkpoint_meta(latest)

    plans = {"A": ({"poison": [POISON_STEP, 0]}, {}),
             "A0": ({}, {}),
             "B": ({"kill": [KILL_STEP, 1]},
                   {"max_launches": 3, "audit": audit}),
             "C": ({"sigterm": [SIGTERM_STEP, 1]}, {}),
             "K0": ({"kill": [KILL_STEP, 0]}, {})}
    done = {}

    def run(arm, faults, kw):
        t0 = time.monotonic()
        try:
            done[arm] = _fleet(drill, arm, faults, **kw) + (
                time.monotonic() - t0,)
        except BaseException as e:  # reported by the test that reads it
            done[arm] = e

    threads = [threading.Thread(target=run, args=(arm, f, kw), daemon=True)
               for arm, (f, kw) in plans.items()]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 3 * LAUNCH_TIMEOUT_S
    for t in threads:
        t.join(timeout=max(1.0, deadline - time.monotonic()))
    for arm in plans:
        if isinstance(done.get(arm), BaseException):
            raise done[arm]
        assert arm in done, f"arm {arm} did not finish"
    return done, state


@pytest.fixture(scope="module")
def arm_a(fleets):
    done = fleets[0]
    res, ckpt, out, _ = done["A"]
    ctl, _, cout, _ = done["A0"]
    return res, ckpt, out, ctl, cout


def test_arm_a_lockstep_rollback_on_every_rank(arm_a):
    res, _, out, ctl, cout = arm_a
    assert res.status == "completed", _logs(out)
    assert ctl.status == "completed", _logs(cout)
    docs = [_result(out, 0, r) for r in (0, 1)]
    for doc in docs:
        assert doc["status"] == "completed"
        assert doc["final_step"] == STEPS
        assert doc["stats"]["rollbacks_total"] == 1
        assert _kinds(doc, "rollback")
        assert {"rollback", "checkpoint_write", "checkpoint_barrier",
                "score_sync"} <= set(doc["phases"])
    # the healthy rank rolled back to the same checkpoint
    assert _kinds(docs[0], "rollback")[0][2].split("restored ")[1] == \
        _kinds(docs[1], "rollback")[0][2].split("restored ")[1]
    p = [_params(out, 0, r) for r in (0, 1)]
    _assert_bits(p[0], p[1])
    _assert_bits(p[0], _params(cout, 0, 0))


def test_arm_a_matches_the_jax_supervisor(arm_a, drill):
    """The JAX package's one-process supervised run of the same net, data
    and fault plan (its whole batch in one process) reaches the port's
    two-rank params to f32 tolerance."""
    _, _, out, _, _ = arm_a
    jnet = jser.restore_multi_layer_network(str(drill / "start.zip"))
    d = np.load(drill / "data.npz")
    pipe = jdatapipe.from_arrays(d["x"], d["y"]).shard(1, 0).batch(
        GLOBAL_BATCH)
    inj = jres.FaultInjector()
    inj.poison_step(POISON_STEP)
    cfg = jres.SupervisorConfig(
        checkpoint_dir=str(drill / "jaxA"), checkpoint_every_steps=CKPT_EVERY,
        keep_checkpoints=10, backoff_initial_s=0.01, nan_lr_backoff=1.0)
    with inj.installed():
        res = jres.TrainingSupervisor(jnet, cfg, injector=inj).fit_pipeline(
            pipe, epochs=1)
    assert res.status == "completed" and res.stats["rollbacks_total"] == 1
    got = _params(out, 0, 0)
    for ln, sub in jnet.params.items():
        for pn, v in sub.items():
            np.testing.assert_allclose(got[f"{ln}/{pn}"], np.asarray(v),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"{ln}/{pn}")


# ------------------------------------------------------------------ arm B
@pytest.fixture(scope="module")
def arm_b(fleets):
    done, state = fleets
    res, ckpt, out, took = done["B"]
    return res, ckpt, out, state, took


def test_arm_b_peer_loss_is_named_and_nothing_is_saved(arm_b):
    res, ckpt, out, state, _ = arm_b
    assert res.status == "completed", _logs(out)
    assert res.final_size == 1 and len(res.launches) == 2
    first = res.launches[0]
    assert first.peer_lost_ranks == [0]
    assert first.workers[0].returncode == PEER_LOST_EXIT
    assert first.workers[1].returncode < 0           # the SIGKILL
    doc = _result(out, 0, 0)
    assert doc["status"] == "peer_lost"
    assert doc["peer_loss"]["lost_ranks"] == [1]
    assert doc["peer_loss"]["detection_s"] <= TIMEOUT_S + 2.0
    assert doc["stats"]["peer_losses_total"] == 1
    # the newest restorable checkpoint is the last one complete on both
    # ranks: no save after the kill
    step = int(os.path.basename(state["latest"]).split("_")[1])
    assert step == (KILL_STEP // CKPT_EVERY) * CKPT_EVERY
    flights = [p for p in glob.glob(str(ckpt / "flight_*"))
               if json.load(open(p)).get("reason") == "peer_lost"]
    assert flights
    # the launcher's per-worker identity
    assert doc["env"]["WORLD_SIZE"] == "2" and doc["env"]["RANK"] == "0"
    assert doc["env"]["DL4J_TPU_INSTANCE"] == "worker-0"


def test_arm_b_survivor_restores_and_matches_a_one_process_control(arm_b):
    res, ckpt, out, state, _ = arm_b
    doc = _result(out, 1, 0)
    assert doc["status"] == "completed" and doc["size"] == 1
    assert doc["resumed_from"] == os.path.basename(state["latest"])
    assert "restore" in doc["phases"]
    assert _kinds(doc, "reshard")
    low = low_water_mark(state["meta"]["datapipe"])
    assert low == int(os.path.basename(state["latest"]).split("_")[1]) \
        * GLOBAL_BATCH
    assert doc["seen"] == list(range(low, N_RECORDS))
    assert doc["final_step"] == STEPS
    # the control: this process restores the same checkpoint and replays
    net = restore_multi_layer_network(state["latest"], device="cpu")
    x, y = _data()
    pipe = datapipe.from_arrays(x, y).shard(1, 0).map(lambda r: r).batch(
        GLOBAL_BATCH)
    pipe.load_state_dict(remap_for(pipe, state["meta"]["datapipe"]))
    for ds in pipe.stream(1):
        net.fit_batch(ds)
    _assert_bits(_params(out, 1, 0), _net_params(net))


# ------------------------------------------------------------------ arm C
def test_arm_c_sigterm_on_one_rank_stops_both(fleets):
    res, ckpt, out, _ = fleets[0]["C"]
    assert res.status == "completed", _logs(out)
    docs = [_result(out, 0, r) for r in (0, 1)]
    for doc in docs:
        assert doc["status"] == "preempted"
        assert _kinds(doc, "preempt")
    assert docs[0]["final_step"] == docs[1]["final_step"] < STEPS
    latest = find_latest_checkpoint(str(ckpt))
    assert latest.endswith(f"step_{docs[0]['final_step']}")
    assert (ckpt / "run_report.json").exists()
    assert (ckpt / "run_report.r1.json").exists()
    restored = _net_params(restore_multi_layer_network(latest, device="cpu"))
    for r in (0, 1):
        _assert_bits(_params(out, 0, r), restored)


# --------------------------------------------------------- rank 0 killed
def test_a_dead_store_host_ends_its_peer_within_the_deadline(fleets):
    """Rank 0 hosts the consensus store: its death ends rank 1 with
    PEER_LOST_EXIT, naming rank 0, without hanging."""
    res, _, out, took = fleets[0]["K0"]
    rec = res.launches[0]
    assert rec.workers[0].returncode < 0, _logs(out)
    assert rec.workers[1].returncode == PEER_LOST_EXIT, _logs(out)
    assert not rec.workers[1].killed
    doc = _result(out, 0, 1)
    assert doc["status"] == "peer_lost"
    assert doc["peer_loss"]["lost_ranks"] == [0]
    assert doc["peer_loss"]["detection_s"] <= TIMEOUT_S + 2.0
    assert took < LAUNCH_TIMEOUT_S
