"""The PyTorch port's run-farm (`repro_torch.farm`) and its `dist` copies,
on the CPU: the counterparts of tests/test_farm.py (spool atomics, the
wire format, broker scheduling, worker execution, client reassembly,
driven synchronously by hand) and tests/test_dist_units.py, each held
against the reference where both packages compute the same thing: the
farm frame equals the port's local run bit for bit under every shard
split, and lies within 1e-3 per column of the reference's local frame."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.dist as rdist
from repro.core.workloads import Op as ROp
from repro_torch.api import Study, get_preset, preset_grid, studies
from repro_torch.api.study import StudyResult
from repro_torch.core.workloads import Op
from repro_torch.dist import StragglerDetector, plan_elastic_remesh
from repro_torch.farm import Broker, FarmClient, Worker
from repro_torch.farm.queue import SHARDS_TOPIC, FileSpool
from repro_torch.trace.generator import TraceSpec

CPU = torch.device("cpu")
OPS_A = [Op("a", 256, 1024, 512), Op("b", 512, 197, 768, count=3.0)]
OPS_B = [Op("c", 128, 512, 256)]


def mk_study(name="farmtest"):
    """2 designs x 2 workloads = 4 cells in 2 batched groups."""
    return (Study(name).designs(preset_grid(array=[8, 16]))
            .workloads({"wa": OPS_A, "wb": OPS_B}).fidelity("fast"))


def mk_ref_study(name="farmtest"):
    """The same study in the reference package."""
    def ops(xs):
        return [ROp(o.name, o.M, o.N, o.K, count=o.count) for o in xs]
    return (rapi.Study(name).designs(rapi.preset_grid(array=[8, 16]))
            .workloads({"wa": ops(OPS_A), "wb": ops(OPS_B)})
            .fidelity("fast"))


def mk_kernel_study(name="farmkern"):
    """Three designs per group, layout stage on, at fast and trace: every
    group a batched call of 3 designs through both kernels' plain
    versions, so a shard of 1 or 2 designs makes a different batch."""
    return (Study(name)
            .designs({f"a{a}": get_preset("table-v-corner", array=a,
                                          layout_banks=16)
                      for a in (32, 64, 128)})
            .workloads({"w": [Op("q", 768, 197, 768),
                              Op("m", 3072, 197, 768)]})
            .fidelity("fast", "trace")
            .options(trace_spec=TraceSpec(cap=256)))


def drive(broker, workers, client, sid, max_rounds=50):
    """Synchronous farm: alternate worker/broker steps to completion."""
    broker.step()
    for _ in range(max_rounds):
        if client.status(sid).get("state") != "running":
            return
        for w in workers:
            w.step()
        broker.step()
    raise AssertionError(f"farm did not settle: {client.status(sid)}")


def workers_on(root, n=2):
    return [Worker(root, f"w{i}", device="cpu") for i in range(n)]


@pytest.fixture()
def farm(tmp_path):
    root = str(tmp_path / "farm")
    return (FarmClient(root), Broker(root, max_shard_cells=2),
            workers_on(root))


# ---- the file spool ---------------------------------------------------------

def test_spool_put_claim_ack_priority_order(tmp_path):
    sp = FileSpool(str(tmp_path))
    sp.put("t", {"x": 2}, priority=200)
    sp.put("t", {"x": 0}, priority=50)
    sp.put("t", {"x": 1}, priority=50)          # FIFO within a priority
    assert sp.depth("t") == 3
    got = [sp.claim("t", "me").payload["x"] for _ in range(3)]
    assert got == [0, 1, 2]
    assert sp.claim("t", "me") is None
    assert len(sp.claimed_items("t")) == 3


def test_spool_claim_is_exclusive_and_requeue_restores(tmp_path):
    sp = FileSpool(str(tmp_path))
    sp.put("t", {"x": 1})
    a = sp.claim("t", "w0")
    assert a is not None and sp.claim("t", "w1") is None
    assert sp.requeue_stale("t", lease_seconds=0.0) == [a.item_id]
    b = sp.claim("t", "w1")
    assert b is not None and b.payload == {"x": 1}
    sp.ack(b)
    assert sp.requeue_stale("t", lease_seconds=0.0) == []
    assert sp.depth("t") == 0


def test_spool_drop_pending_and_poison(tmp_path):
    sp = FileSpool(str(tmp_path))
    sp.put("t", {"sid": "a"})
    sp.put("t", {"sid": "b"})
    assert sp.drop_pending("t", lambda p: p["sid"] == "a") == 1
    _, pending, _ = sp._dirs("t")
    with open(os.path.join(pending, "p0000-0-bad.json"), "w") as f:
        f.write("{not json")
    got = sp.claim("t", "me")
    assert got is not None and got.payload == {"sid": "b"}


def test_spool_layout_is_the_reference_s(tmp_path):
    """One spool format: the reference's spool claims what the port's put,
    and the other way round."""
    from repro.farm.queue import FileSpool as RSpool
    port, ref = FileSpool(str(tmp_path)), RSpool(str(tmp_path))
    port.put("t", {"from": "port"}, priority=5)
    ref.put("t", {"from": "ref"}, priority=1)
    assert ref.claim("t", "r").payload == {"from": "ref"}
    assert ref.claim("t", "r").payload == {"from": "port"}
    assert port.requeue_stale("t", 0.0) and len(ref.pending_ids("t")) == 2


# ---- study spec wire format -------------------------------------------------

def test_inline_spec_roundtrip_preserves_plan_and_cell_hashes():
    s = (mk_study().fidelity("fast", "trace")
         .options(core_index=0, force_fallback=False))
    spec = json.loads(json.dumps(s.to_spec()))
    back = Study.from_spec(spec)
    p0, p1 = s.plan(), back.plan()
    assert [(c.design, c.workload, c.fidelity) for c in p0.cells] == \
        [(c.design, c.workload, c.fidelity) for c in p1.cells]
    assert [s._cell_hash(c, CPU) for c in p0.cells] == \
        [back._cell_hash(c, CPU) for c in p1.cells]


def test_registry_spec_keeps_claims_and_evaluator():
    s = studies.edp_array_size(smoke=True)
    spec = json.loads(json.dumps(s.to_spec()))
    assert spec["ref"] == {"study": "edp_array_size",
                           "kwargs": {"smoke": True}}
    back = Study.from_spec(spec)
    assert [n for n, _ in back._claims] == [n for n, _ in s._claims]
    ev = studies.multicore_contention(channels=(1, 2))
    assert Study.from_spec(ev.to_spec())._evaluator is not None
    with pytest.raises(ValueError):
        mk_study().evaluator(lambda c, o, f, *, device: {"m": 1.0}).to_spec()


def test_spec_rejects_bad_payloads():
    with pytest.raises(ValueError):
        Study.from_spec({"kind": "nope"})
    spec = mk_study().to_spec()
    spec["schema_version"] = "v0-bogus"
    with pytest.raises(ValueError):
        Study.from_spec(spec)


# ---- end-to-end: bit-identity ------------------------------------------------

def test_farm_frame_bit_identical_to_local_run(farm):
    client, broker, workers = farm
    local = mk_study().run(device="cpu")
    sid = client.submit(mk_study())
    drive(broker, workers, client, sid)
    st = client.status(sid)
    assert st["shards_total"] >= 2
    res = client.result(sid, timeout=5)
    assert res.equals(local)
    for k in res.columns:
        assert np.array_equal(res[k], local[k]), k
    assert res.executed_cells == len(local) and res.cache_hits == 0
    assert res.meta["device"] == "cpu"
    done_workers = {w.worker_id for w in workers if w.shards_done}
    assert len(done_workers) == 2, "both workers should process shards"


@pytest.mark.parametrize("max_shard_cells", [1, 2, 8])
def test_farm_frame_equals_local_under_every_shard_split(tmp_path,
                                                         max_shard_cells):
    """A batched group of 3 designs split into shards of 1, 2 or all of
    them, through both kernels' plain versions: the frame equals the local
    run bit for bit, so no design's values depend on the batch."""
    root = str(tmp_path / "farm")
    client = FarmClient(root)
    broker = Broker(root, max_shard_cells=max_shard_cells)
    local = mk_kernel_study().run(device="cpu")
    sid = client.submit(mk_kernel_study())
    drive(broker, workers_on(root), client, sid)
    want = {1: 6, 2: 4, 8: 2}[max_shard_cells]   # 2 groups of 3 designs
    assert client.status(sid)["shards_total"] == want
    res = client.result(sid, timeout=5)
    assert res.equals(local)
    for k in local.columns:
        assert np.array_equal(res[k], local[k]), k
    assert res.meta["engine"] == local.meta["engine"] == "torch:plain"
    assert not res.failed_cells


def test_farm_frame_within_1e3_of_the_reference(farm):
    client, broker, workers = farm
    sid = client.submit(mk_study())
    drive(broker, workers, client, sid)
    res = client.result(sid, timeout=5)
    ref = mk_ref_study().run()
    assert [list(res[a]) for a in ("design", "workload", "fidelity")] == \
        [list(ref[a]) for a in ("design", "workload", "fidelity")]
    assert res.column_names() == ref.column_names()
    for c in ref.column_names():
        if c in ("design", "workload", "fidelity"):
            continue
        np.testing.assert_allclose(np.asarray(res[c], float),
                                   np.asarray(ref[c], float), rtol=1e-3,
                                   err_msg=c)


def test_registry_study_claims_survive_farm_roundtrip(farm):
    client, broker, workers = farm
    sid = client.submit(studies.edp_array_size(smoke=True))
    drive(broker, workers, client, sid)
    res = client.result(sid, timeout=5)
    assert res.claims_ok(), res.check_claims()
    local = studies.edp_array_size(smoke=True).run(device="cpu")
    assert res.equals(local)


# ---- the fleet-shared dedup cache ---------------------------------------------

def test_prewarmed_cache_executes_zero_cells_across_submissions(farm):
    client, broker, workers = farm
    mk_study().run(device="cpu", cache=broker.dirs.cache_dir())
    for sid in [client.submit(mk_study()), client.submit(mk_study())]:
        drive(broker, workers, client, sid)
        res = client.result(sid, timeout=5)
        assert res.executed_cells == 0
        assert res.cache_hits == len(res) == 4
    m = broker.metrics()
    assert sum(w.get("cache_hits", 0)
               for w in m["workers"].values()) == 8


def test_cold_farm_then_warm_local_run(farm):
    client, broker, workers = farm
    sid = client.submit(mk_study())
    drive(broker, workers, client, sid)
    res = client.result(sid, timeout=5)
    local = mk_study().run(device="cpu", cache=broker.dirs.cache_dir())
    assert local.executed_cells == 0 and local.cache_hits == 4
    assert local.equals(res)


# ---- failure paths --------------------------------------------------------------

def test_killed_worker_shard_requeued_and_study_completes(tmp_path):
    root = str(tmp_path / "farm")
    client = FarmClient(root)
    broker = Broker(root, max_shard_cells=2, lease_seconds=0.0)
    local = mk_study().run(device="cpu")
    sid = client.submit(mk_study())
    broker.step()
    spool = FileSpool(root)
    dead = spool.claim(SHARDS_TOPIC, "dead-worker")
    assert dead is not None
    out = broker.step()
    assert out["requeued"] == 1
    survivor = Worker(root, "survivor", device="cpu")
    while client.status(sid).get("state") == "running":
        if not survivor.step():
            broker.step()
    res = client.result(sid, timeout=5)
    assert res.equals(local)
    assert broker.metrics()["requeued_shards"] == 1


def test_lease_expiry_race_folds_exactly_one_result(tmp_path):
    root = str(tmp_path / "farm")
    client = FarmClient(root)
    broker = Broker(root, max_shard_cells=2, lease_seconds=0.0)
    local = mk_study().run(device="cpu")
    sid = client.submit(mk_study())
    broker.step()
    spool = FileSpool(root)
    slow = spool.claim(SHARDS_TOPIC, "slow-worker")
    assert slow is not None
    out = broker.step()
    assert out["requeued"] == 1
    fast = Worker(root, "fast-worker", device="cpu")
    while client.status(sid).get("state") == "running":
        if not fast.step():
            broker.step()
    assert client.status(sid)["state"] == "done"
    assert client.status(sid)["cells_done"] == 4
    shard = int(slow.payload["shard"])
    path = broker.dirs.shard_result_path(sid, shard)
    dup = json.load(open(path))
    dup["worker"] = "slow-worker"
    with open(path + ".tmp", "w") as f:
        json.dump(dup, f)
    os.replace(path + ".tmp", path)
    spool.ack(slow)
    broker.step()
    st = client.status(sid)
    assert st["state"] == "done" and st["cells_done"] == 4
    assert client.result(sid, timeout=5).equals(local)


def test_requeue_stale_reads_the_fault_clock(tmp_path):
    from repro_torch.faults import FaultPlan, FaultRule
    sp = FileSpool(str(tmp_path))
    sp.put("t", {"x": 1})
    a = sp.claim("t", "w0")
    assert sp.requeue_stale("t", lease_seconds=3600.0) == []
    plan = FaultPlan(0, {"clock": FaultRule("skew", skew=1e6, p=1.0)})
    with plan.active():
        assert sp.requeue_stale("t", lease_seconds=3600.0) == [a.item_id]
    b = sp.claim("t", "w1")
    assert b is not None and b.payload == {"x": 1}


def test_cancellation_drops_pending_shards(farm):
    client, broker, workers = farm
    sid = client.submit(mk_study())
    broker.step()
    assert broker.spool.depth(SHARDS_TOPIC) >= 2
    client.cancel(sid)
    broker.step()
    assert client.status(sid)["state"] == "canceled"
    assert broker.spool.depth(SHARDS_TOPIC) == 0
    assert not workers[0].step(), "no work left for workers"
    with pytest.raises(RuntimeError, match="canceled"):
        client.result(sid, timeout=1)


def test_cancel_before_ingest_drops_the_job(farm):
    client, broker, workers = farm
    sid = client.submit(mk_study(), study_id="early-cancel")
    client.cancel(sid)
    broker.step()
    broker.step()
    assert client.status(sid)["state"] == "canceled"
    assert broker.spool.depth(SHARDS_TOPIC) == 0


def test_bad_spec_marks_study_error(farm):
    client, broker, workers = farm
    spec = mk_study().to_spec()
    spec["workloads"] = {}
    sid = client.submit(spec)
    broker.step()
    assert client.status(sid)["state"] == "error"
    with pytest.raises(RuntimeError, match="failed"):
        client.result(sid, timeout=1)


# ---- streaming + scheduling ------------------------------------------------------

def test_partial_frames_stream_in_plan_order(farm):
    client, broker, workers = farm
    sid = client.submit(mk_study())
    broker.step()
    assert client.partial_result(sid) is not None
    assert len(client.partial_result(sid)) == 0
    workers[0].step()
    broker.step()
    part = client.partial_result(sid)
    assert 0 < len(part) < 4
    assert isinstance(part, StudyResult)
    drive(broker, workers, client, sid)
    full = client.result(sid, timeout=5)
    rows = {tuple(r[a] for a in ("design", "workload", "fidelity")):
            r["total_cycles"] for r in full.rows()}
    for r in part.rows():
        key = tuple(r[a] for a in ("design", "workload", "fidelity"))
        assert rows[key] == r["total_cycles"]


def test_priority_orders_shard_claims(farm):
    client, broker, workers = farm
    slow = client.submit(mk_study("background"), priority=500)
    urgent = client.submit(mk_study("urgent"), priority=1)
    broker.step()
    w = workers[0]
    w.step()
    broker.step()
    assert client.status(urgent)["cells_done"] > 0
    assert client.status(slow)["cells_done"] == 0
    drive(broker, workers, client, urgent)
    drive(broker, workers, client, slow)
    assert client.result(slow, timeout=5).equals(
        client.result(urgent, timeout=5))


def test_broker_restart_resumes_inflight_study(tmp_path):
    root = str(tmp_path / "farm")
    client = FarmClient(root)
    sid = client.submit(mk_study())
    Broker(root, max_shard_cells=2).step()
    broker2 = Broker(root, max_shard_cells=2)
    drive(broker2, workers_on(root, 1), client, sid)
    assert client.result(sid, timeout=5).equals(mk_study().run(device="cpu"))


def test_worker_device_is_explicit(farm, tmp_path):
    """The port's counterpart of the reference's mesh mode: one worker, one
    device, named in its heartbeat and results; CUDA unless it is asked
    for the CPU, and never a quiet fallback."""
    client, broker, workers = farm
    sid = client.submit(mk_study())
    drive(broker, workers, client, sid)
    hb = json.load(open(broker.dirs.worker_path("w0")))
    assert hb["device"] == "cpu" and hb["mesh"] is None
    shard = json.load(open(broker.dirs.shard_result_path(sid, 0)))
    assert shard["device"] == "cpu" and shard["mesh"] is None
    # the client needs no card: the frame names the workers' device
    frame = FarmClient(broker.dirs.root).result(sid, timeout=5)
    assert frame.meta["device"] == "cpu"
    if torch.cuda.is_available():
        assert Worker(str(tmp_path / "x"), "g").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Worker(str(tmp_path / "x"), "g")


def test_client_labels_frames_with_the_shards_device(farm):
    """The reassembled frame's labels come from the shard results: none
    before a shard ran, the workers' device type after, and shards of one
    study on different device types are an error, not a frame."""
    client, broker, workers = farm
    sid = client.submit(mk_kernel_study())
    broker.step()
    empty = client.partial_result(sid)
    assert len(empty) == 0 and "device" not in empty.meta
    drive(broker, workers, client, sid)
    res = client.result(sid, timeout=5)
    assert res.meta["device"] == "cpu"
    assert res.meta["engine"] == "torch:plain"
    path = broker.dirs.shard_result_path(sid, 0)
    shard = json.load(open(path))
    shard["device"] = "cuda"
    with open(path, "w") as f:
        json.dump(shard, f)
    with pytest.raises(RuntimeError, match="different device types"):
        FarmClient(broker.dirs.root).result(sid, timeout=5)


def test_smoke_cli_spawns_workers_on_the_named_device(tmp_path):
    """`python -m repro_torch.farm smoke`: a broker thread and two worker
    subprocesses on `--device cpu` run edp_array_size, claims gated."""
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    metrics = str(tmp_path / "FARM_metrics.json")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.farm", "smoke", "--smoke",
         "--device", "cpu", "--root", str(tmp_path / "farm"),
         "--metrics", metrics, "--timeout", "120"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("claim PASS") == 4
    m = json.load(open(metrics))
    assert m["studies"] and set(m["studies"].values()) == {"done"}
    assert sum(w.get("cells_done", 0) for w in m["workers"].values()) >= 3
    # the submission waits for every worker's heartbeat
    hb = [json.load(open(os.path.join(str(tmp_path / "farm"), "workers", n)))
          for n in os.listdir(str(tmp_path / "farm" / "workers"))]
    assert {h["device"] for h in hb} == {"cpu"}
    assert {h["worker"] for h in hb} == {"smoke-w0", "smoke-w1"}
    assert m["smoke"]["device"] == "cpu" and m["smoke"]["cells"] == 3


# ---- dist: StragglerDetector and plan_elastic_remesh ---------------------------

def feed(det, host, value, n):
    for _ in range(n):
        det.record(host, value)


def test_threshold_must_exceed_one():
    with pytest.raises(ValueError):
        StragglerDetector(threshold=1.0)
    with pytest.raises(ValueError):
        StragglerDetector(threshold=0.5)


def test_single_host_never_flags_itself():
    det = StragglerDetector(threshold=3.0, patience=2)
    feed(det, 0, 100.0, 8)
    assert det.stragglers() == []


def test_median_of_means_flags_the_slow_host():
    det = StragglerDetector(threshold=3.0, patience=2)
    feed(det, 0, 1.0, 4)
    feed(det, 1, 1.0, 4)
    feed(det, 2, 10.0, 4)
    assert det.stragglers() == [2]


def test_even_host_count_averages_the_middle_means():
    det = StragglerDetector(threshold=3.0, patience=1)
    for host, v in enumerate((1.0, 3.0, 3.0, 100.0)):
        det.record(host, v)
    assert det.stragglers() == [3]


def test_patience_requires_consecutive_slow_samples():
    det = StragglerDetector(threshold=3.0, patience=2)
    feed(det, 0, 1.0, 8)
    feed(det, 1, 1.0, 2)
    det.record(1, 50.0)
    assert det.stragglers() == []
    det.record(1, 50.0)
    assert det.stragglers() == [1]
    det.record(1, 1.0)
    assert det.stragglers() == []


def test_window_forgets_ancient_history():
    det = StragglerDetector(threshold=2.0, patience=2, window=4)
    feed(det, 0, 1.0, 8)
    feed(det, 1, 1.0, 8)
    feed(det, 2, 100.0, 2)
    assert det.stragglers() == [2]
    feed(det, 2, 1.0, 4)
    assert det.stragglers() == []


def test_reset_one_host_and_all():
    det = StragglerDetector(threshold=3.0, patience=1)
    feed(det, 0, 1.0, 4)
    feed(det, 1, 1.0, 4)
    feed(det, 2, 10.0, 4)
    assert det.stragglers() == [2]
    det.reset(2)
    assert det.stragglers() == []
    feed(det, 2, 10.0, 4)
    det.reset()
    assert det.stragglers() == [] and det._samples == {}


def test_straggler_flags_equal_the_reference():
    rng = np.random.default_rng(3)
    kw = dict(threshold=2.5, patience=3, window=8)
    port, ref = StragglerDetector(**kw), rdist.StragglerDetector(**kw)
    for step in range(200):
        host = int(rng.integers(6))
        secs = float(rng.lognormal(0.0, 1.0)) * (4.0 if host == 5 else 1.0)
        port.record(host, secs)
        ref.record(host, secs)
        assert port.stragglers() == ref.stragglers(), step


def test_plain_data_parallel_plan():
    p = plan_elastic_remesh(8, global_batch=16)
    assert (p.dp, p.tp) == (8, 1)
    assert p.mesh_shape == (8, 1) and p.mesh_axes == ("data", "model")
    assert p.per_device_batch == 2 and p.grad_accum == 1
    assert p.global_batch == 16


def test_tp_halves_until_it_divides_the_fleet():
    p = plan_elastic_remesh(6, global_batch=12, tp=4)
    assert p.tp == 2 and p.dp == 3
    assert p.global_batch >= 12
    p = plan_elastic_remesh(8, global_batch=8, tp=4)
    assert p.tp == 4 and p.dp == 2


def test_fleet_shrink_absorbed_by_grad_accum():
    big = plan_elastic_remesh(8, global_batch=64, max_per_device_batch=8)
    small = plan_elastic_remesh(2, global_batch=64, max_per_device_batch=8)
    assert big.global_batch == small.global_batch == 64
    assert small.grad_accum > big.grad_accum
    assert small.per_device_batch <= 8


def test_fleet_grow_keeps_batch_and_caps_pdb():
    for n in (1, 2, 3, 4, 8, 16):
        p = plan_elastic_remesh(n, global_batch=32,
                                max_per_device_batch=4)
        assert p.global_batch >= 32, n
        assert 1 <= p.per_device_batch <= 4
        assert p.dp * p.tp <= n


def test_prefer_pod_splits_the_data_axis():
    p = plan_elastic_remesh(16, global_batch=16, tp=2, prefer_pod=4)
    assert p.mesh_shape == (4, 2, 2)
    assert p.mesh_axes == ("pod", "data", "model")
    p = plan_elastic_remesh(16, global_batch=16, tp=2, prefer_pod=3)
    assert p.mesh_axes == ("data", "model")


def test_rejects_empty_fleet():
    with pytest.raises(ValueError):
        plan_elastic_remesh(0, global_batch=8)


def test_elastic_plans_equal_the_reference():
    for n in (1, 2, 3, 4, 6, 8, 12, 16):
        for gb in (1, 3, 8, 17, 64):
            for tp in (1, 2, 4):
                for pod in (None, 2, 4):
                    kw = dict(global_batch=gb, tp=tp, prefer_pod=pod,
                              max_per_device_batch=4)
                    a, b = plan_elastic_remesh(n, **kw), \
                        rdist.plan_elastic_remesh(n, **kw)
                    assert (a.mesh_shape, a.mesh_axes, a.dp, a.tp,
                            a.per_device_batch, a.grad_accum) == \
                        (b.mesh_shape, b.mesh_axes, b.dp, b.tp,
                         b.per_device_batch, b.grad_accum)


def test_farm_shard_sizing_contract():
    for n_workers in (1, 2, 4):
        for n_cells in (1, 3, 8, 16, 33):
            p = plan_elastic_remesh(n_workers, global_batch=n_cells,
                                    max_per_device_batch=8)
            size = max(1, p.per_device_batch)
            n_shards = -(-n_cells // size)
            assert size <= 8
            if n_cells >= n_workers:
                assert n_shards >= min(n_workers, n_cells)


def test_broker_splits_like_the_reference(tmp_path):
    """The same plan, the same live fleet and the same cap give the same
    shard -> cells manifest in both packages."""
    from repro.farm import Broker as RBroker
    for cap in (1, 2, 8):
        port = Broker(str(tmp_path / f"p{cap}"), max_shard_cells=cap)
        ref = RBroker(str(tmp_path / f"r{cap}"), max_shard_cells=cap)
        assert port._split(mk_study().plan()) == \
            ref._split(mk_ref_study().plan())
        assert port._split(studies.edp_array_size().plan()) == \
            ref._split(rapi.studies.edp_array_size().plan())
