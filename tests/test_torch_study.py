"""The PyTorch port's Study layer end to end on the CPU against the JAX
reference: the paper's named studies and a mixed trace-fidelity grid give
frames that match per column within 1e-3 and whose claims hold; cells on
NoC pods run the routed path; cells outside the ported slice are
refused, never silently run dense; and the port never imports JAX or the
reference package."""
import dataclasses
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


def test_cells_outside_the_slice_raise():
    """'cycle' fidelity runs through the per-op engine, not ported yet."""
    s = rt.Study().designs({"d": "paper-32"}).fidelity("cycle") \
        .workloads({"w": [TOp("g", 64, 64, 64)]})
    with pytest.raises(NotImplementedError, match="module item 8"):
        s.run(device="cpu")


def test_custom_evaluator_is_refused():
    """Custom evaluators are ported; what stays refused with them is the
    per-op engine's `force_fallback`, which names module item 8. The
    options take the reference's keywords only (`trace_spec=`)."""
    s = rt.Study().evaluator(lambda cfg, ops, fid, device: {})
    with pytest.raises(NotImplementedError, match="module item 8"):
        s.options(force_fallback=True)
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
