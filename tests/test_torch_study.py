"""The PyTorch port's Study layer end to end on the CPU against the JAX
reference: the paper's named studies and a mixed trace-fidelity grid give
frames that match per column within 1e-3 and whose claims hold; cells on
NoC pods run the routed path; `cycle` and `force_fallback` cells run
through the per-op engine; the cell cache, the wire format, frame
operations, sharded execution and the CLI behave as the reference's; a
group whose kernel call raises gives failed cells; and the port never
imports JAX or the reference package."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.api.study as rstudy
import repro.core.workloads as rwl
import repro.trace.generator as rgen
from repro.api.presets import preset_grid as r_preset_grid
import repro_torch as rt
import repro_torch.api.study as tstudy
from repro_torch.core.workloads import Op as TOp

AXES = ("design", "workload", "fidelity")


def assert_frames_match(ref, port, rtol=1e-3):
    for a in AXES:
        assert list(port[a]) == list(ref[a]), a
    assert port.column_names() == ref.column_names()
    for c in ref.column_names():
        if c in AXES:
            continue
        np.testing.assert_allclose(np.asarray(port[c], float),
                                   np.asarray(ref[c], float), rtol=rtol,
                                   err_msg=c)


@pytest.mark.parametrize("name,kw", [("edp_array_size", dict(smoke=True)),
                                     ("edp_array_size", {}),
                                     ("dataflow_dram_flip", {})],
                         ids=["edp_smoke", "edp_full", "dataflow_flip"])
def test_named_study_matches_reference_and_claims_hold(name, kw):
    ref = getattr(rstudy.studies, name)(**kw).run()
    port = getattr(tstudy.studies, name)(**kw).run(device="cpu")
    assert_frames_match(ref, port)
    claims = port.check_claims()
    assert len(claims) == 4 and all(claims.values()), claims
    assert port.check_claims() == ref.check_claims()
    if name == "dataflow_dram_flip":
        assert port.meta["engine"] == "torch:plain"
    else:
        assert "engine" not in port.meta          # fast fidelity replays nothing


def test_mixed_trace_grid_matches_reference():
    """3 arrays x 2 SRAM sizes x {ws, os, is} at trace fidelity, small cap:
    three dataflow groups, shared streams deduplicated per group."""
    kw = dict(array=[16, 32, 64], sram_mb=[0.25, 1.0],
              dataflow=["ws", "os", "is"])
    ops = rwl.resnet18_six_layers()
    ref = (rstudy.Study().designs(r_preset_grid(**kw))
           .workloads({"r6": ops}).fidelity("fast", "trace")
           .options(trace_spec=rgen.TraceSpec(cap=512)).run())
    port = (rt.Study().designs(rt.preset_grid(**kw))
            .workloads({"r6": [TOp(**dataclasses.asdict(o)) for o in ops]})
            .fidelity("fast", "trace")
            .options(trace_spec=rt.TraceSpec(cap=512)).run(device="cpu"))
    assert len(port) == 36
    assert_frames_match(ref, port)


def test_frame_operations_and_csv_round_trip(tmp_path):
    res = tstudy.studies.dataflow_dram_flip().run(device="cpu")
    assert res.best("compute_cycles")["design"] == "ws"
    per_fid = res.best("total_cycles", by="fidelity")
    assert per_fid["trace"]["design"] == "os"
    assert len(res.pareto("total_cycles", "energy_pj")) >= 1
    ratios = res.compare("total_cycles", axis="design", baseline="ws")
    assert ratios["os"].shape == (2,)
    assert res.claims_ok()
    path = str(tmp_path / "flip.csv")
    res.to_csv(path)
    back = tstudy.StudyResult.from_csv(path)
    for c in res.column_names():
        assert list(back[c]) == list(res[c]), c
    with pytest.raises(ValueError):
        back.claims_ok()                     # claims do not survive CSV


def test_plan_groups_cells_by_flavor():
    s = (rt.Study().designs(rt.preset_grid(array=[16, 32],
                                           dataflow=["ws", "os"]))
         .workloads("resnet18").fidelity("fast", "trace"))
    plan = s.plan()
    assert len(plan) == 8 and len(plan.groups) == 4
    assert {(g.fidelity, g.dataflow) for g in plan.groups} == {
        ("fast", "ws"), ("fast", "os"), ("trace", "ws"), ("trace", "os")}
    assert all((g.dram is None) == (g.fidelity == "fast")
               for g in plan.groups)


def _pod(cfg, cores=4):
    from repro_torch.api.presets import with_pod
    return with_pod(cfg, cores)


# Sparse, per-op N:M, multi-core and layout designs on a NoC pod, and a
# plain NoC pod: each runs through the routed path of the batched sweep.
NOC_PODS = [
    ("sparse", lambda: rt.Study().designs({"s": _pod(rt.get_preset(
        "ws-64-sparse-2:4"))})),
    ("op_nm", lambda: rt.Study().designs({"d": _pod(rt.get_preset(
        "paper-32"))}).workloads(
        {"w": [TOp("g", 64, 64, 64, sparsity_nm=(2, 4))]})),
    ("multicore", lambda: rt.Study().designs({"m": _pod(rt.get_preset(
        "multicore-16x32"), 16)})),
    ("layout", lambda: rt.Study().designs({"l": _pod(rt.get_preset(
        "table-v-corner", layout_banks=16))})),
    ("noc", lambda: rt.Study().designs({"n": rt.get_preset(
        "pod-mesh", cores=16)})),
]


@pytest.mark.parametrize("name,make", NOC_PODS, ids=[r[0] for r in NOC_PODS])
def test_cells_on_noc_pods_match_the_reference(name, make):
    """The port's frame equals the reference's within 1e-3 per column, the
    routed NoC columns included; sparse ops gate the NoC stall to 0."""
    from repro.core.accelerator import AcceleratorConfig as RConfig
    from repro.core.workloads import Op as ROp
    s = make()
    if not s._workloads:
        s = s.workloads({"w": [TOp("g", 64, 64, 64),
                               TOp("h", 256, 512, 128)]})
    ref = rstudy.Study().designs(
        {k: RConfig.from_dict(c.to_dict()) for k, c in s._designs}) \
        .workloads({k: [ROp(**dataclasses.asdict(o)) for o in v]
                    for k, v in s._workloads.items()})
    port = s.run(device="cpu")
    assert port.fraction_batched == 1.0 and "noc_stall_cycles" in \
        port.column_names()
    assert_frames_match(ref.run(), port)
    if name in ("sparse", "op_nm"):
        assert float(port["noc_stall_cycles"][0]) == 0.0


def test_cycle_fidelity_runs_through_the_per_op_engine():
    """'cycle' cells go to the plan's per-op list and run there, one replay
    of the plain version per gemm op on the CPU."""
    ops = [TOp("g", 64, 64, 64), TOp("v", kind="vector", vector_elems=512.0)]
    s = rt.Study().designs({"d": "paper-32"}).fidelity("cycle") \
        .workloads({"w": ops})
    plan = s.plan()
    assert plan.fallback == [0] and not plan.groups and plan.n_batched == 0
    res = s.run(device="cpu")
    assert res.meta["engine"] == "torch:plain" and not res.failed_cells
    assert res["batched"][0] == 0.0
    rep = rt.Simulator("paper-32", fidelity="cycle", device="cpu").run(ops)
    assert res["total_cycles"][0] == rep.total_cycles
    assert rep.ops[0].dram_stats["row_hits"] > 0


def test_force_fallback_runs_every_cell_per_op():
    """`force_fallback=True` sends every cell to the per-op engine, whose
    frame agrees with the batched one within 1e-3 and keeps the claims.
    The options take the reference's keywords only (`trace_spec=`)."""
    batched = tstudy.studies.edp_array_size(smoke=True).run(device="cpu")
    s = tstudy.studies.edp_array_size(smoke=True).options(
        force_fallback=True)
    plan = s.plan()
    assert not plan.groups and plan.fallback == [0, 1, 2]
    res = s.run(device="cpu")
    assert res.fraction_batched == 0.0 and res.claims_ok()
    for c in tstudy.METRIC_COLUMNS:
        np.testing.assert_allclose(res[c], batched[c], rtol=1e-3, err_msg=c)
    with pytest.raises(TypeError):
        s.options(spec=rt.TraceSpec())


def test_run_defaults_to_cuda_and_never_falls_back():
    s = tstudy.studies.edp_array_size(smoke=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default run would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.run()


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import torch\n"
        "import repro_torch\n"
        "from repro_torch.core.energy import instantaneous_power_trace\n"
        "from repro_torch.core.sparsity import sample_rowwise_counts\n"
        "from repro_torch.kernels.ellpack import pack_with_report\n"
        "from repro_torch.kernels.systolic import simulate_fold\n"
        "r = repro_torch.studies.dataflow_dram_flip().run(device='cpu')\n"
        "assert r.claims_ok()\n"
        "f = simulate_fold(torch.ones(5, 4), torch.ones(4, 3))\n"
        "instantaneous_power_trace(f.active, repro_torch.tpu_like_config())\n"
        "sample_rowwise_counts(torch.Generator().manual_seed(0), 4, 16, 8)\n"
        "pack_with_report(torch.ones(4, 16), m=8)\n"
        "import repro_torch.configs, repro_torch.models.zoo\n"
        "from repro_torch.launch import serve\n"
        "assert serve.main(['--smoke', '--device', 'cpu', '--requests', '1',"
        " '--batch', '1', '--prompt-len', '4', '--gen-len', '2']) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print('LEAKED', bad)\n"
        "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_custom_energy_table_matches_reference():
    import repro.core.energy as ren
    import repro_torch.core.energy as ten
    kw = dict(dram_per_byte=16.0, mac_random=0.2)
    ref = rstudy.studies.edp_array_size(smoke=True).options(
        ert=ren.ERT(**kw)).run()
    port = tstudy.studies.edp_array_size(smoke=True).options(
        ert=ten.ERT(**kw)).run(device="cpu")
    assert_frames_match(ref, port)
    base = tstudy.studies.edp_array_size(smoke=True).run(device="cpu")
    assert np.all(port["energy_pj"] > base["energy_pj"])


# --------------------------------------------------------------------------
# The cell cache, the wire format, frame operations, sharded execution,
# the CLI and the failure semantics
# --------------------------------------------------------------------------

def _small_study(name="small"):
    ops = [TOp("a", 128, 256, 192), TOp("v", kind="vector",
                                        vector_elems=4096.0)]
    return (rt.Study(name).designs(rt.preset_grid(array=[16, 32],
                                                  dataflow=["ws", "os"]))
            .workloads({"w": ops}).fidelity("fast", "trace", "cycle")
            .options(trace_spec=rt.TraceSpec(cap=512)))


def test_cache_hits_replay_a_bit_identical_frame(tmp_path):
    cache = str(tmp_path / "cells")
    first = _small_study().cache(cache).run(device="cpu")
    assert first.executed_cells == 12 and first.cache_hits == 0
    second = _small_study().cache(cache).run(device="cpu")
    assert second.cache_hits == 12 and second.executed_cells == 0
    assert first.equals(second)              # every column, bit for bit
    # a corrupt (torn) cache file is a miss, never a crash
    victim = sorted(os.listdir(cache))[0]
    with open(os.path.join(cache, victim), "w") as f:
        f.write('{"schema_version": 1, "metr')
    third = _small_study().cache(cache).run(device="cpu")
    assert third.cache_hits == 11 and third.executed_cells == 1
    assert first.equals(third)
    # the per-op oracle never aliases the batched cells
    oracle = _small_study().options(force_fallback=True).run(
        device="cpu", cache=cache)
    assert oracle.cache_hits == 0 and oracle.executed_cells == 12
    assert not [f for f in os.listdir(cache) if f.endswith(".tmp")]


def test_cell_hash_is_the_port_s_own():
    from repro.core.accelerator import AcceleratorConfig as RConfig
    from repro.core.workloads import Op as ROp
    port = _small_study()
    ref = (rstudy.Study("small")
           .designs({k: RConfig.from_dict(c.to_dict())
                     for k, c in port._designs})
           .workloads({"w": [ROp(**dataclasses.asdict(o))
                             for o in port._workloads["w"]]})
           .fidelity("fast", "trace", "cycle")
           .options(trace_spec=rgen.TraceSpec(cap=512)))
    rcells, pcells = ref.plan().cells, port.plan().cells
    cpu = torch.device("cpu")
    hashes = {port._cell_hash(c, cpu) for c in pcells}
    assert len(hashes) == len(pcells)
    assert not hashes & {ref._cell_hash(c) for c in rcells}
    # the device type is part of the key: card and CPU cells never alias
    assert port._cell_hash(pcells[0], torch.device("cuda")) not in hashes


def test_spec_round_trip():
    s = _small_study().options(force_fallback=True).metrics(
        "total_cycles", "energy")
    spec = json.loads(json.dumps(s.to_spec()))
    back = tstudy.Study.from_spec(spec)
    cpu = torch.device("cpu")
    assert [s._cell_hash(c, cpu) for c in s.plan().cells] == \
        [back._cell_hash(c, cpu) for c in back.plan().cells]
    assert back.run(device="cpu").equals(s.run(device="cpu"))
    # a registry study travels by reference, claims and evaluator intact
    reg = tstudy.studies.multicore_contention(channels=[1, 2])
    spec = reg.to_spec()
    assert spec["ref"] == {"study": "multicore_contention",
                           "kwargs": {"channels": [1, 2]}}
    back = tstudy.Study.from_spec(spec)
    assert back._evaluator is not None and len(back._claims) == 3
    with pytest.raises(ValueError, match="evaluator"):
        rt.Study().evaluator(lambda c, o, f, device: {}).to_spec()
    with pytest.raises(ValueError, match="study spec"):
        tstudy.Study.from_spec({"kind": "other"})


def test_frame_operations_match_reference():
    ref = rstudy.studies.dataflow_dram_flip().run()
    port = tstudy.studies.dataflow_dram_flip().run(device="cpu")
    for k in (1, 3, 10):
        assert list(port.topk("total_cycles", k)["design"]) == \
            list(ref.topk("total_cycles", k)["design"])
    assert list(port.topk("edp", 2)["fidelity"]) == \
        list(ref.topk("edp", 2)["fidelity"])
    # to_json / from_json: the port's frame reads back identically, and
    # the reference reads it (one schema)
    back = tstudy.StudyResult.from_json(port.to_json())
    assert back.equals(port) and not back.equals(ref)
    assert_frames_match(ref, rstudy.StudyResult.from_json(port.to_json()))
    both = tstudy.StudyResult.concat([port, port.filter(fidelity="fast")])
    rboth = rstudy.StudyResult.concat([ref, ref.filter(fidelity="fast")])
    assert len(both) == len(rboth) == 6
    assert both.column_names() == rboth.column_names()
    assert both.axes == rboth.axes
    lines, rlines = port.summary().splitlines(), ref.summary().splitlines()
    assert lines[0] == rlines[0] and len(lines) == len(rlines)
    assert [ln.split(":")[0] for ln in lines] == \
        [ln.split(":")[0] for ln in rlines]
    # metrics() restricts the columns as the reference does
    only = tstudy.studies.dataflow_dram_flip().metrics("latency", "energy")
    assert only.run(device="cpu").column_names() == [
        "design", "workload", "fidelity", "total_cycles", "energy_pj",
        "batched", "cell_status"]
    assert port.ok().equals(port)


def test_shards_and_assemble_frame_equal_run():
    s = _small_study()
    plan = s.plan()
    results, executed, hits = {}, 0, 0
    for shard in ([0, 5, 9, 2], [1, 3, 4, 6, 7, 8, 10, 11]):
        r, e, h = s._execute_cells(plan, shard, device="cpu")
        assert set(r) == set(shard)
        results.update(r)
        executed += e
        hits += h
    frame = s.assemble_frame(results, executed_cells=executed,
                             cache_hits=hits, plan=plan, device="cpu")
    assert frame.equals(s.run(device="cpu"))
    assert frame.meta["engine"] == "torch:plain"
    part = s.assemble_frame({i: results[i] for i in (0, 1)}, partial=True,
                            device="cpu")
    assert len(part) == 2
    with pytest.raises(ValueError, match="missing"):
        s.assemble_frame({0: results[0]}, device="cpu")
    with pytest.raises(IndexError):
        s._execute_cells(plan, [12], device="cpu")


def test_cli_runs_a_named_study(tmp_path):
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = str(tmp_path / "edp.json")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.api", "--study",
         "edp_array_size", "--smoke", "--device", "cpu", "--json", out],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("claim PASS") == 4
    frame = tstudy.StudyResult.from_json(open(out).read())
    assert len(frame) == 3


def test_a_group_whose_kernel_raises_gives_failed_cells(monkeypatch):
    """A replay that raises (a kernel that does not build or launch, here
    its plain version) fails the cells of its batched group and the
    per-op cells that reach it, with NaN metrics; it is not a frame of
    numbers, and nothing reruns elsewhere."""
    from repro_torch.kernels.replay import megakernel as mk

    def broken(*a, **k):
        raise RuntimeError("replay kernel failed to launch")

    monkeypatch.setattr(mk, "run_plain", broken)
    res = _small_study().run(device="cpu")
    fast = list(res["fidelity"] == "fast")
    assert res.failed_cells == [i for i, f in enumerate(fast) if not f]
    assert np.isnan(res["total_cycles"][~np.array(fast)]).all()
    assert np.isfinite(res["total_cycles"][np.array(fast)]).all()
    assert len(res.ok()) == 4
