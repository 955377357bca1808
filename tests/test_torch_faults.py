"""The PyTorch port's fault plane (`repro_torch.faults`) against the
reference's (`repro.faults`): the counterparts of tests/test_faults.py on
the port's own copy (seeded schedules, the fs shims, retry/backoff, the
spool's torn-write hardening, the schedule registry); the same seed gives
the same decision sequence, `report()` and wire format in both packages,
so one schedule replays on either fleet; and the port's cell cache writes
through the `cache.store` site, whose corrupt entries load as misses and
whose crash points are never absorbed as failed cells."""
import errno
import json
import os
import random
import time

import numpy as np
import pytest

import repro.faults as rfaults
import repro_torch.api.study as tstudy
import repro_torch.faults as tfaults
from repro_torch.api.presets import preset_grid
from repro_torch.core.workloads import Op
from repro_torch.farm.queue import FileSpool
from repro_torch.faults import (CHAOS_SCHEDULES, FaultPlan, FaultRule,
                                InjectedCrash, active_plan, backoff_delays,
                                chaos_schedule, with_retries)
from repro_torch.faults import fs as ffs
from repro_torch.faults.plan import ENV_VAR

PLAN_MOD = "repro_torch.faults.plan"


# ---- FaultPlan decision procedure ------------------------------------------

def _schedule(plan, site, kinds, n):
    return [plan.decide(site, kinds) is not None for _ in range(n)]


def test_same_seed_replays_identical_schedule():
    mk = lambda: FaultPlan(7, {"x": FaultRule("os_error", p=0.5)})
    a = _schedule(mk(), "x", ("os_error",), 64)
    b = _schedule(mk(), "x", ("os_error",), 64)
    assert a == b
    assert any(a) and not all(a)       # p=0.5 actually branches
    c = _schedule(FaultPlan(8, {"x": FaultRule("os_error", p=0.5)}),
                  "x", ("os_error",), 64)
    assert a != c                      # different seed, different schedule


def test_times_caps_total_injections():
    plan = FaultPlan(0, {"x": FaultRule("crash", p=1.0, times=3)})
    fired = _schedule(plan, "x", ("crash",), 10)
    assert sum(fired) == 3 and fired[:3] == [True] * 3


def test_after_skips_the_first_calls():
    plan = FaultPlan(0, {"x": FaultRule("torn", p=1.0, after=2, times=1)})
    fired = _schedule(plan, "x", ("torn",), 5)
    assert fired == [False, False, True, False, False]


def test_site_globs_and_kind_filter():
    plan = FaultPlan(0, {"worker.*": FaultRule("crash", p=1.0)})
    assert plan.decide("worker.claimed", ("crash",)) is not None
    assert plan.decide("broker.status", ("crash",)) is None
    assert plan.decide("worker.result", ("os_error", "torn")) is None


def test_report_counts_what_fired():
    plan = FaultPlan(0, {"x": FaultRule("os_error", p=1.0, times=2)})
    _schedule(plan, "x", ("os_error",), 5)
    rep = plan.report()
    assert rep["injected"] == {"x:os_error": 2}
    assert rep["total_injected"] == 2 and rep["seed"] == 0


def test_rule_validation():
    with pytest.raises(ValueError, match="kind"):
        FaultRule("meltdown")
    with pytest.raises(ValueError, match="probability"):
        FaultRule("torn", p=1.5)
    with pytest.raises(ValueError, match="times"):
        FaultRule("torn", times=-1)


def test_json_round_trip_and_env_activation(monkeypatch):
    plan = FaultPlan(3, {"spool.put": [FaultRule("torn", p=0.5, times=2)],
                         "clock": FaultRule("skew", skew=100.0)})
    back = FaultPlan.from_json(plan.to_json())
    assert back.seed == 3 and back.rules == plan.rules
    monkeypatch.setenv(ENV_VAR, plan.to_json())
    monkeypatch.setattr(f"{PLAN_MOD}._ACTIVE", None)
    monkeypatch.setattr(f"{PLAN_MOD}._ENV_CHECKED", False)
    got = active_plan()
    assert got is not None and got.seed == 3
    monkeypatch.setattr(f"{PLAN_MOD}._ACTIVE", None)
    monkeypatch.setattr(f"{PLAN_MOD}._ENV_CHECKED", True)
    assert active_plan() is None


def test_bad_env_schedule_is_no_schedule(monkeypatch):
    monkeypatch.setenv(ENV_VAR, "{not json")
    monkeypatch.setattr(f"{PLAN_MOD}._ACTIVE", None)
    monkeypatch.setattr(f"{PLAN_MOD}._ENV_CHECKED", False)
    assert active_plan() is None


# ---- the same schedule in both packages ------------------------------------

_SITES = ["spool.put", "worker.result", "cache.store", "clock",
          "worker.claimed", "worker.pre_ack", "broker.status",
          "worker.heartbeat"]
_KINDS = [("os_error", "torn", "corrupt"), ("crash",), ("skew",),
          ("os_error",), None]


def _mixed_rules(mod):
    R = mod.FaultRule
    return {"spool.*": [R("os_error", p=0.4, times=5),
                        R("torn", p=0.3, after=1)],
            "worker.*": [R("crash", p=0.5, times=4),
                         R("corrupt", p=0.25)],
            "cache.store": R("os_error", p=0.6, err=errno.EIO),
            "clock": R("skew", p=0.5, skew=1e7, times=3),
            "*": R("torn", p=0.1, times=6)}


def _decisions(plan, calls):
    out = []
    for site, kinds in calls:
        r = plan.decide(site, kinds)
        out.append(None if r is None else (r.kind, r.p, r.times, r.after,
                                           r.err, r.skew))
    return out


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_decision_sequence_and_report_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    calls = [(_SITES[int(rng.integers(len(_SITES)))],
              _KINDS[int(rng.integers(len(_KINDS)))]) for _ in range(400)]
    port = FaultPlan(seed, _mixed_rules(tfaults))
    ref = rfaults.FaultPlan(seed, _mixed_rules(rfaults))
    got = _decisions(port, calls)
    assert got == _decisions(ref, calls)
    assert any(got) and not all(got)
    assert port.report() == ref.report()
    assert port.report()["total_injected"] > 0
    # one wire format: either package replays the other's schedule
    assert port.to_json() == ref.to_json()
    cross = FaultPlan.from_json(ref.to_json())
    again = rfaults.FaultPlan(seed, _mixed_rules(rfaults))
    assert _decisions(cross, calls) == _decisions(again, calls)


@pytest.mark.parametrize("name", sorted(CHAOS_SCHEDULES))
def test_chaos_schedules_equal_the_reference(name):
    for seed in (0, 5):
        port, ref = chaos_schedule(name, seed), rfaults.chaos_schedule(
            name, seed)
        assert port.to_json() == ref.to_json()
        calls = [(s, k) for s in _SITES for k in _KINDS] * 3
        assert _decisions(port, calls) == _decisions(ref, calls)
        assert port.report() == ref.report()


def test_backoff_and_retry_equal_the_reference():
    from repro.faults.retry import backoff_delays as r_backoff
    assert backoff_delays(6, 0.01, 3.0, rng=random.Random(4)) == \
        r_backoff(6, 0.01, 3.0, rng=random.Random(4))
    assert backoff_delays(3, rng=random.Random(0)) == \
        r_backoff(3, rng=random.Random(0))


# ---- fs shims ---------------------------------------------------------------

def test_shims_are_passthrough_without_a_plan(tmp_path):
    p = tmp_path / "a.json"
    ffs.write_text(str(p), '{"v": 1}', site="anything")
    assert json.load(open(p)) == {"v": 1}
    ffs.crash_point("worker.claimed")          # no-op
    assert abs(ffs.now() - time.time()) < 5.0


def test_torn_and_corrupt_writes_land_unparseable_bytes(tmp_path):
    plan = FaultPlan(0, {"t": FaultRule("torn", p=1.0, times=1),
                         "c": FaultRule("corrupt", p=1.0, times=1)})
    text = json.dumps({"k": list(range(50))})
    with plan.active():
        ffs.write_text(str(tmp_path / "t.json"), text, site="t")
        ffs.write_text(str(tmp_path / "c.json"), text, site="c")
    torn = open(tmp_path / "t.json").read()
    assert torn == text[:len(torn)] and 0 < len(torn) < len(text)
    for name in ("t.json", "c.json"):
        with pytest.raises(ValueError):
            json.load(open(tmp_path / name))
    # the same bytes the reference's shim lands
    ref = rfaults.FaultPlan(0, {"t": rfaults.FaultRule("torn", p=1.0),
                                "c": rfaults.FaultRule("corrupt", p=1.0)})
    from repro.faults import fs as rfs
    with ref.active():
        rfs.write_text(str(tmp_path / "rt.json"), text, site="t")
        rfs.write_text(str(tmp_path / "rc.json"), text, site="c")
    for a, b in (("t.json", "rt.json"), ("c.json", "rc.json")):
        assert open(tmp_path / a).read() == open(tmp_path / b).read()


def test_crash_point_is_base_exception():
    plan = FaultPlan(0, {"x": FaultRule("crash", p=1.0, times=1)})
    with plan.active():
        with pytest.raises(InjectedCrash):
            try:
                ffs.crash_point("x")
            except Exception:  # noqa: BLE001 — the guard under test
                pytest.fail("InjectedCrash must not be an Exception")
    assert not issubclass(InjectedCrash, Exception)


def test_clock_skew_applies_per_scheduled_read():
    plan = FaultPlan(0, {"clock": FaultRule("skew", skew=1e6, p=1.0,
                                            times=1)})
    with plan.active():
        assert ffs.now() - time.time() > 9e5       # skewed once
        assert abs(ffs.now() - time.time()) < 5.0  # budget spent


def test_atomic_write_json_retries_transient_errors(tmp_path):
    p = tmp_path / "out.json"
    plan = FaultPlan(0, {"s": FaultRule("os_error", p=1.0, times=3)})
    with plan.active():
        ffs.atomic_write_json(str(p), {"ok": 1}, site="s")
    assert json.load(open(p)) == {"ok": 1}
    assert plan.report()["injected"] == {"s:os_error": 3}
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]


def test_atomic_write_json_exhausts_retries_loudly(tmp_path):
    plan = FaultPlan(0, {"s": FaultRule("os_error", p=1.0)})  # unbounded
    with plan.active():
        with pytest.raises(OSError) as ei:
            ffs.atomic_write_json(str(tmp_path / "x.json"), {}, site="s",
                                  retries=2)
    assert ei.value.errno == errno.ENOSPC
    assert not os.path.exists(tmp_path / "x.json")


# ---- retry/backoff ----------------------------------------------------------

def test_backoff_delays_grow_with_bounded_jitter():
    d = backoff_delays(retries=5, base=0.01, factor=2.0,
                       rng=random.Random(0))
    assert len(d) == 5
    for i, x in enumerate(d):
        nominal = 0.01 * 2.0 ** i
        assert 0.5 * nominal <= x < 1.5 * nominal
    assert d == backoff_delays(retries=5, base=0.01, factor=2.0,
                               rng=random.Random(0))


def test_with_retries_passes_through_and_reraises():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError(errno.EIO, "eio")
        return "ok"

    assert with_retries(flaky, sleep=lambda s: None) == "ok"
    assert len(calls) == 3
    with pytest.raises(ValueError):   # non-retryable passes straight out
        with_retries(lambda: (_ for _ in ()).throw(ValueError("x")),
                     sleep=lambda s: None)


# ---- spool put hardening ----------------------------------------------------

def test_spool_put_survives_torn_staging_write(tmp_path):
    sp = FileSpool(str(tmp_path))
    plan = FaultPlan(0, {"spool.put": FaultRule("torn", p=1.0, times=2)})
    with plan.active():
        item_id = sp.put("t", {"study_id": "s", "cells": list(range(40))})
    assert plan.report()["injected"] == {"spool.put:torn": 2}
    got = sp.claim("t", "w")
    assert got is not None and got.item_id == item_id
    assert got.payload["cells"] == list(range(40))


def test_spool_claim_drops_wrong_shape_payloads(tmp_path):
    sp = FileSpool(str(tmp_path))
    sp.put("t", {"ok": True})
    pending = os.path.join(str(tmp_path), "t", "pending")
    with open(os.path.join(pending, "p0000-0-zz.json"), "w") as f:
        f.write("[1, 2, 3]")
    got = sp.claim("t", "w")
    assert got is not None and got.payload == {"ok": True}
    assert sp.depth("t") == 0


# ---- schedule registry ------------------------------------------------------

def test_chaos_schedule_registry():
    assert set(CHAOS_SCHEDULES) == {"worker-kills", "torn-writes",
                                    "lease-storms"}
    for name in CHAOS_SCHEDULES:
        plan = chaos_schedule(name, 5)
        assert plan.seed == 5
        assert all(r.times is not None for _, r in plan.rules)
    with pytest.raises(KeyError):
        chaos_schedule("surprise")


# ---- the port's cell cache through the cache.store site -----------------------

def _cache_study():
    """2 arrays x 2 dataflows at fast: 4 cells in 2 batched groups."""
    return (tstudy.Study("faultcache")
            .designs(preset_grid(array=[8, 16], dataflow=["ws", "os"]))
            .workloads({"w": [Op("a", 256, 1024, 512),
                              Op("b", 128, 512, 256, count=2.0)]})
            .fidelity("fast"))


def test_corrupt_cache_store_entries_load_as_misses(tmp_path):
    cache = str(tmp_path / "cells")
    clean = _cache_study().run(device="cpu")
    plan = FaultPlan(0, {"cache.store": FaultRule("corrupt", p=1.0)})
    with plan.active():
        first = _cache_study().run(device="cpu", cache=cache)
    assert plan.report()["injected"] == {"cache.store:corrupt": 4}
    assert first.equals(clean) and first.executed_cells == 4
    files = sorted(os.listdir(cache))
    assert len(files) == 4
    for name in files:                  # the entries landed, as garbage
        with pytest.raises(ValueError):
            json.load(open(os.path.join(cache, name)))
    # every corrupt entry is a miss, never a crash: the cells rerun and
    # (no plan now) land clean, so a third run is all hits
    second = _cache_study().run(device="cpu", cache=cache)
    assert second.cache_hits == 0 and second.executed_cells == 4
    assert second.equals(clean)
    third = _cache_study().run(device="cpu", cache=cache)
    assert third.cache_hits == 4 and third.equals(clean)


def test_a_failing_cache_store_never_fails_a_computed_cell(tmp_path):
    cache = str(tmp_path / "cells")
    plan = FaultPlan(0, {"cache.store": FaultRule("os_error", p=1.0)})
    with plan.active():
        res = _cache_study().run(device="cpu", cache=cache)
    assert not res.failed_cells and res.executed_cells == 4
    assert res.equals(_cache_study().run(device="cpu"))
    assert plan.report()["injected"]["cache.store:os_error"] == 4 * 6
    assert os.listdir(cache) == []      # every attempt failed to land


def test_injected_crash_is_never_absorbed_as_failed_cells(tmp_path,
                                                          monkeypatch):
    """A crash point must kill the process, not become failed cells: the
    study's group and per-cell handlers catch `Exception` only."""
    plan = FaultPlan(0, {"cache.store": FaultRule("crash", p=1.0)})
    with plan.active():
        with pytest.raises(InjectedCrash):
            _cache_study().run(device="cpu", cache=str(tmp_path / "c"))

    def dies(*a, **k):
        raise InjectedCrash("inside the batched call")

    monkeypatch.setattr(tstudy, "_sweep_batched", dies)
    with pytest.raises(InjectedCrash):
        _cache_study().run(device="cpu")
    monkeypatch.undo()
    ev = _cache_study().evaluator(
        lambda cfg, ops, fid, *, device: (_ for _ in ()).throw(
            InjectedCrash("inside an evaluator cell")))
    with pytest.raises(InjectedCrash):
        ev.run(device="cpu")
    # an ordinary exception there is a failed cell, as before
    ev = _cache_study().evaluator(
        lambda cfg, ops, fid, *, device: (_ for _ in ()).throw(
            RuntimeError("a bad cell")))
    assert ev.run(device="cpu").failed_cells == [0, 1, 2, 3]
