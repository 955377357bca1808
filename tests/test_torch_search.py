"""The PyTorch port's search layer (`repro_torch.search`) on the CPU: the
counterparts of tests/test_search.py (deterministic sampling, successive
halving, frontier proposals, the SearchDriver's invariants: seeded replay,
resume from cache, the budget, the checkpoint, a `cycle` rung and a
farm-executed search equal to the local one), each held against the
reference on the same seed: the same samples, labels, valid sizes,
neighbours, proposals and promotions, and the same `SearchLog` cohorts and
parents round for round, with the best rows within 1e-3. (Log digests are
not compared across packages: they hash the metrics' float values.) The
registry's `search_edp` carries the reference's seven claims, which hold
on the port's smoke run through the CLI."""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.search as rsearch
from repro.core.accelerator import CoreConfig as RCore
from repro.core.workloads import Op as ROp
from repro_torch.api import StudyResult, get_preset, get_study
from repro_torch.core.accelerator import CoreConfig
from repro_torch.core.workloads import Op
from repro_torch import search as tsearch
from repro_torch.search import (FarmExecutor, SearchDriver, SearchLog,
                                promote, propose, rung_sizes, table_v_space)
from repro_torch.search.space import hash_u64

OPS = [Op("g", 64, 64, 64)]
AXES = ("design", "workload", "fidelity")


def _apply_sram(cfg, kb):
    sram = int(kb) * 1024 // 3
    return cfg.with_(memory=dataclasses.replace(
        cfg.memory, ifmap_sram_bytes=sram, filter_sram_bytes=sram,
        ofmap_sram_bytes=sram))


def _space(mod, preset, core, name):
    axes = [
        mod.choice("array", (8, 16),
                   lambda c, v: c.with_(cores=(core(rows=v, cols=v),)),
                   short="a"),
        mod.int_log_range("sram_kb", 48, 384, 8, _apply_sram, short="s"),
        mod.choice("dataflow", ("ws", "os"),
                   lambda c, v: c.with_(dataflow=v), short=""),
    ]
    validity = [lambda v: not (v["array"] == 16 and v["sram_kb"] < 96)]
    return mod.SearchSpace(name, preset("edge-8"), axes, validity)


def tiny_space(name="tiny"):
    return _space(tsearch, get_preset, CoreConfig, name)


def ref_tiny_space(name="tiny"):
    return _space(rsearch, rapi.get_preset, RCore, name)


def mk_driver(space, cache, **kw):
    kw.setdefault("seed", 0)
    kw.setdefault("metric", "edp")
    kw.setdefault("ladder", ("fast",))
    kw.setdefault("screen", 8)
    kw.setdefault("eta", 4.0)
    kw.setdefault("explore_rounds", 2)
    kw.setdefault("device", "cpu")
    return SearchDriver(space, {"g64": OPS}, cache=cache, **kw)


def labels(space, pts):
    return [space.label(p) for p in pts]


# ---- space -----------------------------------------------------------------

def test_space_sampling_is_deterministic_and_valid():
    sp = tiny_space()
    a = sp.sample(6, seed=0)
    b = sp.sample(6, seed=0)
    assert labels(sp, a) == labels(sp, b)
    assert all(sp.is_valid(p) for p in a)
    assert len(set(labels(sp, a))) == 6
    c = sp.sample(6, seed=1)
    assert labels(sp, a) != labels(sp, c)
    d = sp.sample(6, seed=0, exclude=[sp.label(a[0])])
    assert sp.label(a[0]) not in set(labels(sp, d))


def test_space_valid_size_neighbors_and_exhaustion():
    sp = tiny_space()
    brute = sum(1 for p in sp.points() if sp.is_valid(p))
    assert sp.valid_size() == brute < len(sp)
    p = sp.sample(1, seed=3)[0]
    for nb in sp.neighbors(p):
        assert sum(i != j for i, j in zip(p.idx, nb.idx)) == 1
        assert all(0 <= i < len(a.values)
                   for i, a in zip(nb.idx, sp.axes))
    everything = sp.sample(10 * len(sp), seed=0)
    assert len(everything) == sp.valid_size()


def test_config_compiles_axis_values():
    sp = tiny_space()
    p = sp.sample(1, seed=7)[0]
    vals = sp.values(p)
    cfg = sp.config(p)
    assert cfg.cores[0].rows == vals["array"]
    assert cfg.dataflow == vals["dataflow"]
    assert cfg.memory.ifmap_sram_bytes == vals["sram_kb"] * 1024 // 3


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_sampling_labels_and_neighbours_equal_the_reference(seed):
    sp, rsp = tiny_space(), ref_tiny_space()
    assert len(sp) == len(rsp) and sp.valid_size() == rsp.valid_size()
    a, b = sp.sample(12, seed=seed, salt=3), rsp.sample(12, seed=seed,
                                                        salt=3)
    assert [p.idx for p in a] == [p.idx for p in b]
    assert labels(sp, a) == labels(rsp, b)
    for p, q in zip(a, b):
        assert [n.idx for n in sp.neighbors(p)] == \
            [n.idx for n in rsp.neighbors(q)]
        assert sp.config(p).to_dict() == rsp.config(q).to_dict()
    ex = labels(sp, a[:4])
    assert labels(sp, sp.sample(8, seed=seed, exclude=ex)) == \
        labels(rsp, rsp.sample(8, seed=seed, exclude=ex))
    assert [rsearch.space.hash_u64(f"k{seed}:{i}") for i in range(8)] == \
        [hash_u64(f"k{seed}:{i}") for i in range(8)]


@pytest.mark.parametrize("round_idx", [1, 2])
def test_propose_equals_the_reference(round_idx):
    sp, rsp = tiny_space(), ref_tiny_space()
    parents = sp.sample(3, seed=round_idx)
    rparents = rsp.sample(3, seed=round_idx)
    ex = labels(sp, parents)
    for n in (2, 5, 20):
        got = propose(sp, parents, n, seed=4, round_idx=round_idx,
                      exclude=ex)
        want = rsearch.propose(rsp, rparents, n, seed=4,
                               round_idx=round_idx, exclude=ex)
        assert labels(sp, got) == labels(rsp, want)


def test_table_v_space_equals_the_reference():
    sp, rsp = table_v_space(), rsearch.table_v_space()
    assert sp.valid_size() == rsp.valid_size() >= 100_000
    assert {a.name for a in sp.axes} == {"array", "sram_kb", "dataflow",
                                         "channels", "bw", "layout_banks"}
    assert [a.values for a in sp.axes] == [a.values for a in rsp.axes]
    a, b = sp.sample(64, seed=0), rsp.sample(64, seed=0)
    assert labels(sp, a) == labels(rsp, b)
    for p, q in zip(a[:16], b[:16]):
        assert sp.config(p).to_dict() == rsp.config(q).to_dict()


# ---- halving ---------------------------------------------------------------

@pytest.fixture()
def rung_frame():
    # a: fast+hungry, b: balanced (best edp), c: slow+frugal — all three
    # pareto-optimal; d dominated by b; e failed (NaN)
    cols = {
        "design": np.array(list("abcde"), dtype=object),
        "workload": np.array(["w"] * 5, dtype=object),
        "fidelity": np.array(["fast"] * 5, dtype=object),
        "total_cycles": np.array([1e6, 2e6, 8e6, 3e6, np.nan]),
        "energy_pj": np.array([9e9, 2e9, 1e9, 3e9, np.nan]),
        "edp": np.array([9e6, 4e6, 8e6, 9e6, np.nan]),
        "cell_status": np.array([0, 0, 0, 0, 1.0]),
    }
    axes = {"design": list("abcde"), "workload": ["w"],
            "fidelity": ["fast"]}
    return StudyResult(cols, axes)


def test_rung_sizes_are_ceil_halving():
    assert rung_sizes(64, 4, 3) == [64, 16, 4]
    assert rung_sizes(9, 3, 4) == [9, 3, 1, 1]
    assert rung_sizes(10, 4, 2) == [10, math.ceil(10 / 4)]
    with pytest.raises(ValueError):
        rung_sizes(0, 4, 2)
    with pytest.raises(ValueError):
        rung_sizes(8, 1, 2)


def test_promote_exact_counts_and_nan_safety(rung_frame):
    assert promote(rung_frame, 2, metric="edp") == ["b", "c"]
    assert promote(rung_frame, 10, metric="edp") == ["b", "c", "a", "d"]
    objs = ("total_cycles", "energy_pj")
    assert promote(rung_frame, 3, pareto=objs) == ["b", "c", "a"]
    assert promote(rung_frame, 4, pareto=objs) == ["b", "c", "a", "d"]
    assert promote(rung_frame, 0, pareto=objs) == []


@pytest.mark.parametrize("seed", [0, 5])
def test_promote_equals_the_reference_on_one_frame(seed):
    """One frame, held by both packages' StudyResult: the same labels for
    every k, by scalar metric and by Pareto rank (ties included)."""
    rng = np.random.default_rng(seed)
    n = 40
    cyc = rng.integers(1, 12, n).astype(float) * 1e5   # many exact ties
    en = rng.integers(1, 12, n).astype(float) * 1e8
    cyc[3] = np.nan
    cols = {"design": np.array([f"d{i}" for i in range(n)], dtype=object),
            "workload": np.array(["w"] * n, dtype=object),
            "fidelity": np.array(["fast"] * n, dtype=object),
            "total_cycles": cyc, "energy_pj": en, "edp": cyc * en,
            "cell_status": np.isnan(cyc).astype(float)}
    axes = {"design": list(cols["design"]), "workload": ["w"],
            "fidelity": ["fast"]}
    port = StudyResult({k: v.copy() for k, v in cols.items()}, axes)
    ref = rapi.StudyResult({k: v.copy() for k, v in cols.items()}, axes)
    for k in (1, 3, 7, 20, 40):
        assert promote(port, k, metric="edp") == \
            rsearch.promote(ref, k, metric="edp")
        assert promote(port, k, pareto=("total_cycles", "energy_pj")) == \
            rsearch.promote(ref, k, pareto=("total_cycles", "energy_pj"))


def test_proposer_is_deterministic_and_tops_up():
    sp = tiny_space()
    parents = sp.sample(2, seed=0)
    labs = labels(sp, parents)
    a = propose(sp, parents, 4, seed=0, round_idx=1, exclude=labs)
    b = propose(sp, parents, 4, seed=0, round_idx=1, exclude=labs)
    assert labels(sp, a) == labels(sp, b)
    assert len(a) == 4
    assert not (set(labels(sp, a)) & set(labs))
    big = propose(sp, parents, 20, seed=0, round_idx=1, exclude=labs)
    assert len(big) == 20
    assert len(set(labels(sp, big))) == 20


# ---- driver invariants -----------------------------------------------------

def test_same_seed_same_winner_log_and_frame(tmp_path):
    sp = tiny_space()
    r1 = mk_driver(sp, str(tmp_path / "c1")).run()
    r2 = mk_driver(sp, str(tmp_path / "c2")).run()
    assert r1.log.digest() == r2.log.digest()
    assert r1.frame.equals(r2.frame)
    assert r1.winner == r2.winner
    assert [e["cohort"] for e in r1.log.rounds] == \
        [e["cohort"] for e in r2.log.rounds]
    r3 = mk_driver(sp, str(tmp_path / "c3"), seed=1).run()
    assert r3.log.rounds[0]["cohort"] != r1.log.rounds[0]["cohort"]
    assert SearchLog.from_json(r1.log.to_json()).digest() == \
        r1.log.digest()
    assert r1.frame.meta["device"] == "cpu"


def test_killed_search_resumes_executing_only_new_cells(tmp_path):
    sp = tiny_space()
    cache = str(tmp_path / "shared")
    part = mk_driver(sp, cache, budget=8).run()
    assert part.spent_evals == 8
    assert part.executed_cells == 8 and part.cache_hits == 0
    full = mk_driver(sp, cache).run()
    assert full.cache_hits == 8
    assert full.executed_cells == full.spent_evals - 8
    cold = mk_driver(sp, str(tmp_path / "cold")).run()
    assert full.frame.equals(cold.frame)
    assert full.log.digest() == cold.log.digest()


def test_budget_is_a_hard_cap(tmp_path):
    sp = tiny_space()
    res = mk_driver(sp, str(tmp_path / "c"), budget=5).run()
    assert res.spent_evals == 5
    assert len(res.frame) == 5
    assert res.log.rounds[-1]["spent_evals"] == 5


def _ladder_kw():
    return dict(screen=8, eta=4.0, explore_rounds=1,
                ladder=("fast", "trace"), rung_sizes=(3,))


def test_driver_promotes_ceil_n_over_eta_and_rung_sizes(tmp_path):
    sp = tiny_space()
    res = mk_driver(sp, str(tmp_path / "c"), **_ladder_kw()).run()
    kinds = [(e["kind"], e["fidelity"], len(e["cohort"]),
              len(e["parents"])) for e in res.log.rounds]
    assert kinds[0] == ("screen", "fast", 8, 0)
    assert kinds[1] == ("propose", "fast", 2, 2)
    assert kinds[2] == ("rung", "trace", 3, 3)
    trace = res.frame.filter(fidelity="trace")
    fast_designs = set(res.frame.filter(fidelity="fast")["design"])
    assert set(trace["design"]) <= fast_designs
    assert res.winner["fidelity"] == "trace"
    assert res.frame.meta["engine"] == "torch:plain"


def test_search_log_cohorts_equal_the_reference(tmp_path):
    """The reference's tiny search with a trace rung and the port's, same
    seed: the same cohorts and parents round for round (the promotions
    see metrics that agree to ~1e-7, and no near tie flips one), and the
    best rows within 1e-3."""
    sp, rsp = tiny_space(), ref_tiny_space()
    kw = dict(_ladder_kw(), explore_rounds=2)
    port = mk_driver(sp, str(tmp_path / "p"), **kw).run()
    ref = rsearch.SearchDriver(
        rsp, {"g64": [ROp("g", 64, 64, 64)]}, seed=0, metric="edp",
        cache=str(tmp_path / "r"), **kw).run()
    assert len(port.log.rounds) == len(ref.log.rounds) == 4
    for a, b in zip(port.log.rounds, ref.log.rounds):
        for key in ("round", "kind", "fidelity", "cohort", "parents",
                    "spent_evals"):
            assert a[key] == b[key], (a["round"], key)
        assert a["best"]["design"] == b["best"]["design"]
        for m, v in b["best"].items():
            if m not in AXES:
                assert a["best"][m] == pytest.approx(v, rel=1e-3), m
    assert port.log.meta == ref.log.meta
    assert port.winner["design"] == ref.winner["design"]
    assert port.spent_evals == ref.spent_evals
    assert port.exhaustive_cells == ref.exhaustive_cells
    assert [list(port.frame[a]) for a in AXES] == \
        [list(ref.frame[a]) for a in AXES]
    for c in ("total_cycles", "energy_pj", "edp", "stall_cycles"):
        np.testing.assert_allclose(port.frame[c], ref.frame[c], rtol=1e-3,
                                   err_msg=c)


def test_cycle_rung_runs_per_op(tmp_path):
    sp = tiny_space("tiny-cycle")
    res = mk_driver(sp, str(tmp_path / "c"), screen=4, explore_rounds=0,
                    ladder=("fast", "cycle"), rung_sizes=(1,)).run()
    cyc = res.frame.filter(fidelity="cycle")
    assert len(cyc) == 1
    assert (cyc["batched"] == 0.0).all()
    assert np.isfinite(cyc["total_cycles"]).all()


def test_farm_executed_search_matches_local_bitwise(tmp_path):
    from repro_torch.farm import Broker, Worker
    sp = tiny_space()
    local = mk_driver(sp, str(tmp_path / "local"), explore_rounds=1).run()

    root = str(tmp_path / "farm")
    broker = Broker(root, max_shard_cells=4)
    workers = [Worker(root, f"w{i}", device="cpu") for i in range(2)]

    def pump():
        for w in workers:
            w.step()
        broker.step()

    ex = FarmExecutor(root, pump=pump)
    farm = SearchDriver(sp, {"g64": OPS}, seed=0, metric="edp",
                        ladder=("fast",), screen=8, eta=4.0,
                        explore_rounds=1, cache=ex.cache_dir,
                        executor=ex).run()
    assert farm.log.digest() == local.log.digest()
    assert list(farm.frame.columns) == list(local.frame.columns)
    for k in farm.frame.columns:
        assert np.array_equal(farm.frame[k], local.frame[k]), k
    assert farm.executed_cells == local.executed_cells


def test_checkpoint_records_progress(tmp_path):
    sp = tiny_space()
    ckpt = tmp_path / "ckpt.json"
    res = mk_driver(sp, str(tmp_path / "c"), explore_rounds=1,
                    checkpoint=str(ckpt)).run()
    d = json.loads(ckpt.read_text())
    assert d["rounds_done"] == len(res.log.rounds)
    assert d["spent_evals"] == res.spent_evals
    assert d["log_digest"] == res.log.digest()


def test_checkpoint_writes_through_the_fault_shim(tmp_path):
    from repro_torch.faults import FaultPlan, FaultRule, InjectedCrash
    plan = FaultPlan(0, {"search.checkpoint": FaultRule("crash", p=1.0)})
    with plan.active():
        with pytest.raises(InjectedCrash):
            mk_driver(tiny_space(), str(tmp_path / "c"),
                      checkpoint=str(tmp_path / "ckpt.json")).run()
    assert plan.report()["injected"] == {"search.checkpoint:crash": 1}


def test_driver_defaults_to_cuda_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        assert SearchDriver(tiny_space(), {"g64": OPS}).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchDriver(tiny_space(), {"g64": OPS})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_study("search_edp", smoke=True).run()


# ---- the registry study ----------------------------------------------------

def test_search_edp_is_registered_with_the_reference_s_claims():
    s = get_study("search_edp", smoke=True)
    names = [n for n, _ in s._claims]
    assert names == [n for n, _ in
                     rapi.get_study("search_edp", smoke=True)._claims]
    assert len(names) == 7
    assert "edp_winner_is_64x64" in names
    assert "seeded_replay_bit_identical" in names
    with pytest.raises(ValueError):
        s.plan()


def test_search_edp_smoke_cli_holds_its_claims(tmp_path, capsys):
    """`python -m repro_torch.api` run in this process (its `_main` with
    the command line's argv) on one intra-op thread: a child process on
    every core waited on six test workers sharing the same cores."""
    from repro_torch.api.study import _main
    log = str(tmp_path / "LOG.json")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = _main(["--study", "search_edp", "--smoke", "--device", "cpu",
                    "--search-log", log])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert out.count("claim PASS") == 7
        assert "row dump suppressed" in out
        d = SearchLog.from_json(open(log).read())
        assert [(e["kind"], e["fidelity"], len(e["cohort"]))
                for e in d.rounds] == [("screen", "fast", 768),
                                       ("propose", "fast", 192),
                                       ("propose", "fast", 48),
                                       ("rung", "trace", 12)]
        # a non-search study has no log to write
        rc = _main(["--study", "edp_array_size", "--smoke", "--device",
                    "cpu", "--search-log", str(tmp_path / "none.json")])
        out = capsys.readouterr().out
        assert rc == 1 and "not a search study" in out
    finally:
        torch.set_num_threads(n)
