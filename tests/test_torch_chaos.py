"""The PyTorch port's farm under seeded fault schedules, on the CPU: the
counterparts of tests/test_chaos.py. Synchronous deterministic drivers
(no subprocesses, no sleeps beyond lease aging): a `FaultPlan` is active
while broker.step()/worker.step() run by hand, `InjectedCrash` kills a
worker mid-protocol and the driver respawns a fresh one. The bar is
bit-identity with the fault-free local run, column for column; the
same schedule fires the same faults in the port's farm as in the
reference's; and `python -m repro_torch.farm chaos` passes all three
schedules. Also pinned: quarantine past the attempts budget, a corrupt
status rebuilt from the manifest, and torn-result patience."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.api as rapi
import repro.farm as rfarm
import repro.faults as rfaults
from repro.core.workloads import Op as ROp
from repro_torch.api import Study, preset_grid
from repro_torch.core.workloads import Op
from repro_torch.farm import Broker, FarmClient, Worker
from repro_torch.farm.queue import SHARDS_TOPIC, FarmDirs, FileSpool
from repro_torch.faults import (CHAOS_SCHEDULES, FaultPlan, FaultRule,
                                InjectedCrash)

OPS = [Op("a", 256, 1024, 512), Op("b", 128, 512, 256)]


def mk_study(name="chaostest"):
    return (Study(name).designs(preset_grid(array=[8, 16]))
            .workloads({"wa": OPS[:1], "wb": OPS[1:]}).fidelity("fast"))


def mk_ref_study(name="chaostest"):
    ops = [ROp(o.name, o.M, o.N, o.K) for o in OPS]
    return (rapi.Study(name).designs(rapi.preset_grid(array=[8, 16]))
            .workloads({"wa": ops[:1], "wb": ops[1:]}).fidelity("fast"))


def chaos_drive(root, sid, *, n_workers=2, max_rounds=400,
                lease_seconds=0.0, max_shard_attempts=8, pkg=None):
    """Broker + worker pool stepped round-robin under the active plan;
    InjectedCrash respawns the worker. `pkg` = the reference's farm
    module drives the reference's farm instead. Returns (broker, final
    state, kills)."""
    if pkg is None:
        B, C = Broker, FarmClient

        def W(wid):
            return Worker(root, wid, device="cpu")
        crash = InjectedCrash
    else:
        B, C = pkg.Broker, pkg.FarmClient

        def W(wid):
            return pkg.Worker(root, wid)
        crash = rfaults.InjectedCrash
    broker = B(root, max_shard_cells=2, lease_seconds=lease_seconds,
               max_shard_attempts=max_shard_attempts)
    client = C(root)
    workers = [W(f"cw{i}") for i in range(n_workers)]
    kills = 0
    for _ in range(max_rounds):
        broker.step()
        for i, w in enumerate(workers):
            try:
                while w.step():
                    pass
            except crash:
                kills += 1
                workers[i] = W(f"cw{i}r{kills}")
            except OSError:
                pass
        state = client.status(sid).get("state")
        if state in ("done", "canceled", "error"):
            broker.step()
            return broker, client.status(sid).get("state"), kills
    raise AssertionError(
        f"chaos farm did not settle: {client.status(sid)}")


@pytest.mark.parametrize("schedule", sorted(CHAOS_SCHEDULES))
def test_schedule_terminates_bit_identical(tmp_path, schedule):
    local = mk_study().run(device="cpu")
    root = str(tmp_path / "farm")
    plan = CHAOS_SCHEDULES[schedule](seed=0)
    with plan.active():
        client = FarmClient(root)
        sid = client.submit(mk_study())
        _, state, _ = chaos_drive(root, sid)
        assert state == "done"
        res = client.result(sid, timeout=5)
    assert res.equals(local)
    for k in local.columns:
        assert np.array_equal(res[k], local[k]), k
    assert not res.failed_cells
    assert plan.report()["total_injected"] > 0


def test_worker_kills_schedule_actually_requeues(tmp_path):
    root = str(tmp_path / "farm")
    plan = CHAOS_SCHEDULES["worker-kills"](seed=0)
    with plan.active():
        client = FarmClient(root)
        sid = client.submit(mk_study())
        broker, state, kills = chaos_drive(root, sid)
    assert state == "done" and kills > 0
    rep = plan.report()
    assert rep["total_injected"] > 0
    assert broker.metrics()["requeued_shards"] > 0
    assert broker.metrics()["quarantined_shards"] == 0


def test_same_seed_same_fault_schedule_same_frame(tmp_path):
    frames, reports = [], []
    for run in ("a", "b"):
        root = str(tmp_path / run)
        plan = CHAOS_SCHEDULES["torn-writes"](seed=7)
        with plan.active():
            client = FarmClient(root)
            sid = client.submit(mk_study())
            _, state, _ = chaos_drive(root, sid)
            assert state == "done"
            frames.append(client.result(sid, timeout=5))
        reports.append(plan.report()["injected"])
    assert frames[0].equals(frames[1])
    assert reports[0] == reports[1]


@pytest.mark.parametrize("schedule", sorted(CHAOS_SCHEDULES))
def test_schedule_fires_the_reference_s_faults(tmp_path, schedule):
    """The same schedule over the same synchronous drive makes the same
    decisions in the port's farm as in the reference's: the two farms
    route the same writes, crash points and clock reads through the
    shims in the same order."""
    got = {}
    for name, pkg, plan_of, study in (
            ("port", None, CHAOS_SCHEDULES[schedule], mk_study),
            ("ref", rfarm, rfaults.CHAOS_SCHEDULES[schedule],
             mk_ref_study)):
        root = str(tmp_path / name)
        plan = plan_of(seed=3)
        with plan.active():
            client = (FarmClient(root) if pkg is None
                      else pkg.FarmClient(root))
            sid = client.submit(study())
            broker, state, kills = chaos_drive(root, sid, pkg=pkg)
            assert state == "done"
            frame = client.result(sid, timeout=5)
        got[name] = (plan.report(), kills, broker.metrics()[
            "requeued_shards"], frame)
    assert got["port"][:3] == got["ref"][:3]
    port, ref = got["port"][3], got["ref"][3]
    for c in ref.column_names():
        if c not in ("design", "workload", "fidelity"):
            np.testing.assert_allclose(np.asarray(port[c], float),
                                       np.asarray(ref[c], float),
                                       rtol=1e-3, err_msg=c)


# ---- quarantine: the poison-shard budget ------------------------------------

def test_poison_shard_quarantined_into_failed_cells(tmp_path):
    root = str(tmp_path / "farm")
    client = FarmClient(root)
    sid = client.submit(mk_study())
    plan = FaultPlan(0, {"worker.claimed": FaultRule("crash", p=1.0)})
    with plan.active():
        broker, state, _ = chaos_drive(root, sid, max_shard_attempts=3)
    assert state == "done"
    assert broker.metrics()["quarantined_shards"] >= 1
    res = client.result(sid, timeout=5)
    assert len(res) == 4
    failed = res.failed_cells
    assert failed == [0, 1, 2, 3] and len(res.ok()) == 0
    assert all(res["cell_status"][i] == 1.0 for i in failed)
    st = client.status(sid)
    assert st["cells_failed"] == len(failed)
    assert st["cells_done"] == 4


# ---- broker recovery machinery ----------------------------------------------

def test_corrupt_status_rebuilt_from_manifest(tmp_path):
    root = str(tmp_path / "farm")
    client = FarmClient(root)
    local = mk_study().run(device="cpu")
    sid = client.submit(mk_study())
    Broker(root, max_shard_cells=2).step()
    dirs = FarmDirs(root)
    with open(dirs.status_path(sid), "w") as f:
        f.write('{"study_id": "x", "state": "runn')
    broker2 = Broker(root, max_shard_cells=2)
    st = client.status(sid)
    assert st.get("state") == "running" and "recovered_at" in st
    workers = [Worker(root, "w0", device="cpu")]
    for _ in range(50):
        if client.status(sid).get("state") != "running":
            break
        for w in workers:
            w.step()
        broker2.step()
    assert client.status(sid)["state"] == "done"
    assert client.result(sid, timeout=5).equals(local)


def test_done_status_torn_after_the_fact_is_self_healed(tmp_path):
    root = str(tmp_path / "farm")
    client = FarmClient(root)
    sid = client.submit(mk_study())
    broker = Broker(root, max_shard_cells=2)
    workers = [Worker(root, "w0", device="cpu")]
    broker.step()
    while client.status(sid).get("state") == "running":
        if not workers[0].step():
            broker.step()
    assert client.status(sid)["state"] == "done"
    dirs = FarmDirs(root)
    with open(dirs.status_path(sid), "w") as f:
        f.write('{"study_id"')
    assert client.status(sid).get("state") == "queued"
    broker.step()
    assert client.status(sid)["state"] == "done"


def test_unreadable_result_patience_then_reenqueue(tmp_path):
    root = str(tmp_path / "farm")
    client = FarmClient(root)
    local = mk_study().run(device="cpu")
    sid = client.submit(mk_study())
    broker = Broker(root, max_shard_cells=2, result_patience=2)
    broker.step()
    spool, dirs = FileSpool(root), FarmDirs(root)
    item = spool.claim(SHARDS_TOPIC, "sick")
    assert item is not None
    shard = int(item.payload["shard"])
    os.makedirs(dirs.results_dir(sid), exist_ok=True)
    with open(dirs.shard_result_path(sid, shard), "w") as f:
        f.write('{"study_id": "torn')
    spool.ack(item)
    w = Worker(root, "healthy", device="cpu")
    for _ in range(30):
        if client.status(sid).get("state") != "running":
            break
        while w.step():
            pass
        broker.step()
    assert client.status(sid)["state"] == "done"
    assert client.result(sid, timeout=5).equals(local)
    att = client.status(sid).get("attempts", {})
    assert att.get(str(shard), 0) >= 1


def test_error_shard_requeued_within_budget(tmp_path):
    root = str(tmp_path / "farm")
    client = FarmClient(root)
    local = mk_study().run(device="cpu")
    sid = client.submit(mk_study())
    broker = Broker(root, max_shard_cells=2)
    broker.step()
    spool, dirs = FileSpool(root), FarmDirs(root)
    item = spool.claim(SHARDS_TOPIC, "sick")
    shard = int(item.payload["shard"])
    os.makedirs(dirs.results_dir(sid), exist_ok=True)
    with open(dirs.shard_result_path(sid, shard), "w") as f:
        json.dump({"study_id": sid, "shard": shard, "worker": "sick",
                   "error": "RuntimeError: transient"}, f)
    spool.ack(item)
    w = Worker(root, "healthy", device="cpu")
    for _ in range(30):
        if client.status(sid).get("state") != "running":
            break
        while w.step():
            pass
        broker.step()
    assert client.status(sid)["state"] == "done"
    assert client.result(sid, timeout=5).equals(local)


# ---- the CLI soak --------------------------------------------------------------

def test_chaos_cli_passes_all_three_schedules(tmp_path):
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    report = str(tmp_path / "FAULTS_report.json")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.farm", "chaos", "--smoke",
         "--device", "cpu", "--root", str(tmp_path / "chaos"),
         "--report", report],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all schedules PASS" in proc.stdout
    rep = json.load(open(report))
    assert sorted(rep) == sorted(CHAOS_SCHEDULES)
    for name, entry in rep.items():
        assert entry["ok"] and entry["bit_identical"] and entry["claims_ok"]
        assert entry["faults"]["total_injected"] > 0, name
    assert rep["worker-kills"]["worker_kills"] > 0
