"""The port's form of `tests/test_sweep_parity.py`: on seeded design grids
mixing dense / layer-wise N:M / row-wise N:M sparsity, layout modeling,
multi-core partitioning and NoC pods, the port's batched sweep
(`fraction_batched == 1.0`) agrees with its per-op engine
(`force_fallback=True`) within 1e-3 per column, and the per-op frames
agree with the JAX package's per-op frames within 1e-3, at `fast`,
`trace` and `cycle`. On the CPU, with the kernels' plain versions."""
import numpy as np
import pytest

import repro.api.study as rstudy
from repro.core.accelerator import AcceleratorConfig as RConfig
from repro.core.workloads import Op as ROp
import repro_torch as rt
from repro_torch.api.presets import as_sparsity, get_preset, with_cores
from repro_torch.core.accelerator import LayoutConfig
from repro_torch.core.workloads import Op
from repro_torch.trace.generator import TraceSpec

CPU = "cpu"
AXES = ("design", "workload", "fidelity")
PARITY_COLUMNS = ("total_cycles", "compute_cycles", "stall_cycles",
                  "dram_bytes", "energy_pj", "utilization", "edp",
                  "energy_mac_pj", "energy_sram_pj", "energy_dram_pj",
                  "energy_static_pj")
NOC_COLUMNS = ("noc_stall_cycles", "noc_link_util", "allreduce_cycles")

# the last gemm carries a per-op N:M override (stages.resolve_sparsity in
# both paths); (1, 4) stays legal when a design is row-wise
OPS = [Op("a", 256, 1024, 512), Op("b", 512, 197, 768, count=3.0),
       Op("v", kind="vector", vector_elems=8192.0, count=2.0),
       Op("c", 384, 256, 1024, sparsity_nm=(1, 4))]

SPARSITIES = (None, "2:4", "1:4", "2:8", "1:4-rw", "2:8-rw")


def _mixed_designs(seed: int, n: int, arrays=(8, 16, 32),
                   core_counts=(1, 4)):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        cfg = get_preset("tpu-like", array=int(rng.choice(arrays)),
                         sram_mb=float(rng.choice([0.25, 1.0])))
        cfg = cfg.with_(dataflow=str(rng.choice(["ws", "os", "is"])))
        cores = int(rng.choice(core_counts))
        if cores > 1:
            cfg = with_cores(cfg, cores)
        sp = SPARSITIES[int(rng.integers(len(SPARSITIES)))]
        if sp is not None:
            cfg = cfg.with_(sparsity=as_sparsity(sp))
        if rng.random() < 0.5:
            cfg = cfg.with_(layout=LayoutConfig(enabled=True))
        out[f"d{i}-{cores}c-{sp}"] = cfg
    return out


def _assert_parity(port, ref, columns=PARITY_COLUMNS, tol=1e-3):
    assert len(port) == len(ref)
    for a in AXES:
        assert list(port[a]) == list(ref[a]), a
    for col in columns:
        a = np.asarray(port[col], float)
        b = np.asarray(ref[col], float)
        nan = np.isnan(b)
        assert np.array_equal(np.isnan(a), nan), col
        rel = np.abs(a[~nan] - b[~nan]) / np.maximum(np.abs(b[~nan]), 1.0)
        assert rel.max(initial=0.0) <= tol, (col, float(rel.max()))


def _reference_study(study):
    """The same study in the JAX package (configs through to_dict)."""
    return (rstudy.Study(study.name)
            .designs({k: RConfig.from_dict(c.to_dict())
                      for k, c in study._designs})
            .workloads({k: [ROp(o.name, o.M, o.N, o.K, o.count, o.kind,
                                o.vector_elems, o.sparsity_nm) for o in v]
                        for k, v in study._workloads.items()})
            .fidelity(*study._fidelities))


@pytest.mark.parametrize("seed", [0, 1])
def test_mixed_grid_fallback_matches_batched_fast(seed):
    designs = _mixed_designs(seed, n=12)

    def mk():
        return (rt.Study().designs(designs)
                .workloads({"w": OPS, "w2": OPS[:2]}).fidelity("fast"))
    res = mk().run(device=CPU)
    assert res.fraction_batched == 1.0
    oracle = mk().options(force_fallback=True).run(device=CPU)
    assert oracle.fraction_batched == 0.0 and not oracle.failed_cells
    _assert_parity(res, oracle)


def test_mixed_grid_fallback_matches_batched_trace():
    designs = _mixed_designs(7, n=6, arrays=(16, 32))
    spec = TraceSpec(cap=1024)

    def mk():
        return (rt.Study().designs(designs).workloads({"w": OPS[:2]})
                .fidelity("trace").options(trace_spec=spec))
    res = mk().run(device=CPU)
    assert res.fraction_batched == 1.0
    oracle = mk().options(force_fallback=True).run(device=CPU)
    assert oracle.meta["engine"] == res.meta["engine"] == "torch:plain"
    _assert_parity(res, oracle)


@pytest.mark.parametrize("fid", ["fast", "trace"])
def test_noc_pods_fallback_matches_batched(fid):
    """Mesh and torus pods of 16 and 64 cores: the routed columns of the
    batched tensor model against the per-op numpy router."""
    designs = {f"{topo}-{p}c": get_preset("pod-mesh", cores=p, array=16,
                                          topology=topo, link_bw=4.0)
               for topo in ("mesh", "torus") for p in (16, 64)}
    designs["single"] = get_preset("tpu-like", array=16)

    def mk():
        return (rt.Study().designs(designs).workloads({"w": OPS[:2]})
                .fidelity(fid).options(trace_spec=TraceSpec(cap=1024)))
    res = mk().run(device=CPU)
    oracle = mk().options(force_fallback=True).run(device=CPU)
    _assert_parity(res, oracle, PARITY_COLUMNS + NOC_COLUMNS)
    assert np.isnan(res["noc_stall_cycles"][-1])      # the NoC-free design


def test_fallback_frame_matches_reference_fallback():
    designs = _mixed_designs(3, n=6)
    port = (rt.Study().designs(designs).workloads({"w": OPS})
            .fidelity("fast").options(force_fallback=True))
    ref = _reference_study(port).options(force_fallback=True).run()
    _assert_parity(port.run(device=CPU), ref)


def test_cycle_study_matches_reference():
    """`cycle` cells run through the per-op engine in both packages; small
    ops keep the reference's compiles (one per stream length) few."""
    designs = {"ws": get_preset("tpu-like", array=16, sram_mb=0.25),
               "os": get_preset("tpu-like", array=16, dataflow="os",
                                sram_mb=0.25)}
    ops = [Op("a", 128, 256, 192), Op("v", kind="vector",
                                      vector_elems=4096.0)]
    port = (rt.Study("cyc").designs(designs).workloads({"w": ops})
            .fidelity("fast", "cycle"))
    res = port.run(device=CPU)
    assert res.meta["engine"] == "torch:plain"
    assert list(res["batched"]) == [1.0, 1.0, 0.0, 0.0]
    ref = _reference_study(port).run()
    _assert_parity(res, ref)


def test_invalid_per_op_override_raises_in_both_paths():
    """An Op.sparsity_nm override that cannot form a valid SparsityConfig
    with a design's row_wise flag raises in the batched path and the
    per-op oracle alike (a ValueError is never a failed cell)."""
    cfg = get_preset("tpu-like", array=16).with_(
        sparsity=as_sparsity("2:8-rw"))
    ops = [Op("g", 128, 128, 256, sparsity_nm=(3, 4))]   # 3 > 4 // 2

    def mk(**kw):
        return (rt.Study().designs({"d": cfg}).workloads({"w": ops})
                .fidelity("fast").options(**kw))
    with pytest.raises(ValueError):
        mk().run(device=CPU)
    with pytest.raises(ValueError):
        mk(force_fallback=True).run(device=CPU)
