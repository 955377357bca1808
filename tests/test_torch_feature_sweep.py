"""The PyTorch port's feature sweep on the CPU against the JAX reference:
randomized design grids mixing dense / layer-wise N:M / row-wise N:M
sparsity, per-op N:M overrides, the data-layout stage and multi-core
partitioning give `Study` frames that match the reference's per column
within 1e-3 at `fast` fidelity (`trace` fidelity:
`test_torch_feature_trace.py`); `sparse_speedup` holds its claims; what
the reference refuses, the port refuses; and a NoC pod runs beside
NoC-free designs."""
import dataclasses

import numpy as np
import pytest

import repro.api.study as rstudy
from repro.api.presets import as_sparsity as r_as_sparsity
from repro.api.presets import get_preset as r_get_preset
from repro.api.presets import preset_grid as r_preset_grid
from repro.api.presets import with_cores as r_with_cores
from repro.core.accelerator import LayoutConfig as RLayoutConfig
from repro.core.workloads import Op as ROp
import repro_torch as rt
import repro_torch.api.study as tstudy
from repro_torch.api.presets import as_sparsity, get_preset, with_cores
from repro_torch.core.accelerator import LayoutConfig
from repro_torch.core.workloads import Op

PARITY_COLUMNS = ("total_cycles", "compute_cycles", "stall_cycles",
                  "dram_bytes", "energy_pj", "utilization", "edp",
                  "energy_mac_pj", "energy_sram_pj", "energy_dram_pj",
                  "energy_static_pj")

# the last gemm carries a per-op N:M override; (1, 4) stays legal when the
# design's SparsityConfig is row-wise (N <= M/2)
OPS = [Op("a", 256, 1024, 512), Op("b", 512, 197, 768, count=3.0),
       Op("v", kind="vector", vector_elems=8192.0, count=2.0),
       Op("c", 384, 256, 1024, sparsity_nm=(1, 4))]

SPARSITIES = (None, "2:4", "1:4", "2:8", "1:4-rw", "2:8-rw")


def _ref_ops(ops):
    return [ROp(**dataclasses.asdict(o)) for o in ops]


def _mixed_designs(seed: int, n: int, arrays=(8, 16, 32),
                   core_counts=(1, 4)):
    """The same numpy-seeded grid built in both packages: {label: (port
    config, reference config)}."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        kw = dict(array=int(rng.choice(arrays)),
                  sram_mb=float(rng.choice([0.25, 1.0])))
        df = str(rng.choice(["ws", "os", "is"]))
        cfg = get_preset("tpu-like", **kw).with_(dataflow=df)
        ref = r_get_preset("tpu-like", **kw).with_(dataflow=df)
        cores = int(rng.choice(core_counts))
        if cores > 1:
            cfg, ref = with_cores(cfg, cores), r_with_cores(ref, cores)
        sp = SPARSITIES[int(rng.integers(len(SPARSITIES)))]
        if sp is not None:
            cfg = cfg.with_(sparsity=as_sparsity(sp))
            ref = ref.with_(sparsity=r_as_sparsity(sp))
        if rng.random() < 0.5:
            cfg = cfg.with_(layout=LayoutConfig(enabled=True))
            ref = ref.with_(layout=RLayoutConfig(enabled=True))
        out[f"d{i}-{cores}c-{sp}"] = (cfg, ref)
    return out


def _studies(designs, workloads, fidelity, spec=None):
    port = (rt.Study().designs({k: v[0] for k, v in designs.items()})
            .workloads(workloads).fidelity(fidelity))
    ref = (rstudy.Study().designs({k: v[1] for k, v in designs.items()})
           .workloads({k: _ref_ops(v) for k, v in workloads.items()})
           .fidelity(fidelity))
    if spec is not None:
        port = port.options(
            trace_spec=rt.TraceSpec(**dataclasses.asdict(spec)))
        ref = ref.options(trace_spec=spec)
    return port, ref


def _assert_parity(port, ref, columns=PARITY_COLUMNS, tol=1e-3):
    assert len(port) == len(ref)
    for a in ("design", "workload", "fidelity"):
        assert list(port[a]) == list(ref[a]), a
    for col in columns:
        a = np.asarray(port[col], float)
        b = np.asarray(ref[col], float)
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
        i = int(rel.argmax()) if len(rel) else 0
        assert rel.max(initial=0.0) <= tol, \
            (col, port.row(i)["design"], a[i], b[i], float(rel.max()))


@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_mixed_grid_parity_fast(seed):
    designs = _mixed_designs(seed, n=14)
    port, ref = _studies(designs, {"w": OPS, "w2": OPS[:2]}, "fast")
    res = port.run(device="cpu")
    assert res.fraction_batched == 1.0 and not res.failed_cells
    _assert_parity(res, ref.run())


def test_acceptance_grid_dense_sparse_cores_layout():
    """{dense, 2:4 layer-wise, 1:4 row-wise} x {1, 4} cores x layout on/off
    with the per-op override and the vector op, at fast fidelity: the
    layout stage only ever adds cycles."""
    kw = dict(array=[32], sparsity=[None, "2:4", "1:4-rw"], cores=[1, 4])
    designs = {}
    for i, (c, r) in enumerate(zip(rt.preset_grid(**kw),
                                   r_preset_grid(**kw))):
        for lay in (False, True):
            designs[f"g{i}{'-lay' if lay else ''}"] = (
                c.with_(layout=LayoutConfig(enabled=lay)),
                r.with_(layout=RLayoutConfig(enabled=lay)))
    port, ref = _studies(designs, {"w": OPS}, "fast")
    res = port.run(device="cpu")
    _assert_parity(res, ref.run())
    tot = dict(zip(res["design"], res["total_cycles"]))
    assert all(tot[f"g{i}-lay"] >= tot[f"g{i}"] for i in range(6))
    assert any(tot[f"g{i}-lay"] > tot[f"g{i}"] for i in range(6))


def test_plan_groups_by_core_grid_layout_and_representation():
    grid = rt.preset_grid(array=[16, 32], sparsity=[None, "2:4"],
                          cores=[1, 4])
    designs = grid + [c.with_(layout=LayoutConfig(enabled=True))
                      for c in grid]
    plan = rt.Study().designs(designs).workloads("resnet18") \
        .fidelity("fast").plan()
    assert len(plan) == 16 and len(plan.groups) == 4
    for g in plan.groups:
        cfgs = [plan.cells[i].config for i in g.cells]
        assert len({(c.mesh_rows, c.mesh_cols) for c in cfgs}) == 1
        assert len({c.layout.enabled for c in cfgs}) == 1


def test_sparse_speedup_study_claims():
    port = tstudy.studies.sparse_speedup(smoke=True).run(device="cpu")
    claims = port.check_claims()
    assert len(claims) == 5 and all(claims.values()), claims
    assert port.fraction_batched == 1.0
    ref = rstudy.studies.sparse_speedup(smoke=True).run()
    _assert_parity(port, ref)


def test_invalid_per_op_override_raises_as_in_the_reference():
    """An Op.sparsity_nm override that cannot form a valid SparsityConfig
    with a design's row_wise flag raises, as in the reference."""
    cfg = get_preset("tpu-like", array=16).with_(
        sparsity=as_sparsity("2:8-rw"))
    ops = [Op("g", 128, 128, 256, sparsity_nm=(3, 4))]   # 3 > 4//2
    with pytest.raises(ValueError):
        rt.Study().designs({"d": cfg}).workloads({"w": ops}) \
            .fidelity("fast").run(device="cpu")
    rcfg = r_get_preset("tpu-like", array=16).with_(
        sparsity=r_as_sparsity("2:8-rw"))
    with pytest.raises(ValueError):
        rstudy.Study().designs({"d": rcfg}) \
            .workloads({"w": _ref_ops(ops)}).fidelity("fast").run()


def test_noc_designs_run_in_the_mixed_sweep():
    """A 16-core NoC pod beside NoC-free multi-core designs of the same
    grid: its own group, batched, with the reference's frame."""
    pod = get_preset("pod-mesh", cores=16, link_bw=2.0, channels=2)
    plain = with_cores(get_preset("tpu-like", array=32), 16)
    designs = {"pod": (pod, r_get_preset("pod-mesh", cores=16, link_bw=2.0,
                                         channels=2)),
               "plain": (plain, r_with_cores(r_get_preset("tpu-like",
                                                          array=32), 16))}
    port, ref = _studies(designs, {"w": OPS}, "fast")
    assert len(port.plan().groups) == 2
    res = port.run(device="cpu")
    assert res.fraction_batched == 1.0 and not res.failed_cells
    _assert_parity(res, ref.run())
    stall = np.asarray(res["noc_stall_cycles"], float)
    assert stall[0] > 0 and np.isnan(stall[1])
