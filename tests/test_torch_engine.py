"""The PyTorch port's per-op engine on the CPU against the JAX reference:
the stage pipeline stage by stage, `simulate_op`/`simulate_network` on
dense, layer-wise and row-wise sparse, multi-core, layout-on, NoC-pod and
vector ops at `fast`, `cycle` and `trace` (fields within 1e-3, row-buffer
counts exact), `simulate_dram` over the three synthetic stream builders,
`trace_op`/`trace_op_stats`, the summaries, `lm_ops`, the `Simulator`
facade and the report's serialized columns.

The ops are small (at `cycle` their DRAM bytes give at most about 1,000
requests), so most of the time is the reference's compilation."""
import csv
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.core.dataflow as rdf
import repro.core.dram as rdram
import repro.core.engine as reng
import repro.core.stages as rst
import repro.core.workloads as rwl
import repro.trace.generator as rgen
from repro.api.presets import as_sparsity, get_preset, with_cores
from repro.configs import get_config
from repro.core.accelerator import DramConfig as RDram
from repro.core.accelerator import LayoutConfig
from repro.core.workloads import Op as ROp
import repro_torch as rt
import repro_torch.core.dataflow as tdf
import repro_torch.core.dram as tdram
import repro_torch.core.engine as teng
import repro_torch.core.stages as tst
import repro_torch.core.workloads as twl
import repro_torch.trace.generator as tgen
from repro_torch.core.accelerator import AcceleratorConfig as TConfig
from repro_torch.core.accelerator import DramConfig as TDram
from repro_torch.core.workloads import Op as TOp

CPU = "cpu"
RTOL = 1e-3
COUNTS = ("row_hits", "row_misses", "row_conflicts")
FIELDS = ("compute_cycles", "stall_cycles", "layout_extra_cycles",
          "total_cycles", "utilization", "macs", "sram_reads",
          "sram_writes", "dram_bytes", "energy_pj", "noc_stall_cycles")

# the last gemm carries a per-op N:M override (resolve_sparsity); (1, 4)
# stays legal when a design's SparsityConfig is row-wise
OPS = [ROp("a", 128, 256, 192), ROp("b", 96, 100, 160, count=2.0),
       ROp("v", kind="vector", vector_elems=4096.0, count=3.0),
       ROp("c", 64, 128, 256, sparsity_nm=(1, 4))]

DESIGNS = {
    "dense": get_preset("tpu-like", array=16, sram_mb=0.25),
    "lw-2:4": get_preset("tpu-like", array=16, sram_mb=0.25).with_(
        sparsity=as_sparsity("2:4")),
    "rw-1:4": get_preset("tpu-like", array=16, sram_mb=0.25).with_(
        sparsity=as_sparsity("1:4-rw")),
    "4-cores": with_cores(get_preset("tpu-like", array=16, dataflow="os",
                                     sram_mb=0.25), 4),
    "layout": get_preset("tpu-like", array=16, dataflow="is",
                         sram_mb=0.25).with_(
        layout=LayoutConfig(enabled=True)),
    "noc-pod": get_preset("pod-mesh", cores=16, array=16, link_bw=4.0),
}
# every design at fast and trace; cycle (one compile of the reference's
# replay per stream length) on three of them
CASES = ([(d, f) for f in ("fast", "trace") for d in DESIGNS]
         + [(d, "cycle") for d in ("dense", "4-cores", "layout")])


def tcfg(rcfg):
    return TConfig.from_dict(rcfg.to_dict())


def top(o):
    return TOp(**dataclasses.asdict(o))


def close(a, b, what, rtol=RTOL):
    assert abs(a - b) <= rtol * max(abs(b), 1e-30), (what, a, b)


def assert_op_matches(port, ref):
    assert (port.name, port.kind, port.scheme) == (ref.name, ref.kind,
                                                   ref.scheme)
    for f in FIELDS:
        close(getattr(port, f), getattr(ref, f), (ref.name, f))
    for d in ("dram_stats", "sparse_storage", "energy_by_action",
              "noc_stats"):
        a, b = getattr(port, d), getattr(ref, d)
        assert (a is None) == (b is None), (ref.name, d)
        if b is None:
            continue
        assert set(a) == set(b), (ref.name, d)
        for k, v in b.items():
            if isinstance(v, str):
                assert a[k] == v
            elif k in COUNTS:
                assert a[k] == int(v), (ref.name, k, a[k], v)   # exact
            else:
                close(float(a[k]), float(v), (ref.name, d, k))


def assert_report_matches(port, ref):
    assert len(port.ops) == len(ref.ops)
    for a, b in zip(port.ops, ref.ops):
        assert_op_matches(a, b)
    for f in ("total_cycles", "compute_cycles", "stall_cycles",
              "layout_extra_cycles", "dram_bytes", "energy_pj",
              "avg_power_w", "edp", "utilization", "noc_stall_cycles"):
        close(getattr(port, f), getattr(ref, f), f)
    assert set(port.energy_breakdown) == set(ref.energy_breakdown)


@pytest.mark.parametrize("fid", ["fast", "cycle", "trace"])
def test_pipeline_stage_names(fid):
    ref = [s.name for s in rst.build_pipeline(fid)]
    port = tst.build_pipeline(fid, device=CPU)
    assert [s.name for s in port] == ref
    assert rt.Simulator(fidelity=fid, device=CPU).stage_names() == ref
    assert tst.pipeline_engine(port) == ("" if fid == "fast"
                                         else "torch:plain")
    with pytest.raises(ValueError):
        tst.build_pipeline("exact", device=CPU)


@pytest.mark.parametrize("design,fid", CASES,
                         ids=[f"{d}-{f}" for d, f in CASES])
def test_network_matches_reference(design, fid):
    rcfg = DESIGNS[design]
    ref = reng.simulate_network(rcfg, OPS, dram_fidelity=fid)
    port = teng.simulate_network(tcfg(rcfg), [top(o) for o in OPS],
                                 dram_fidelity=fid, device=CPU)
    assert_report_matches(port, ref)
    assert port.engine == ("" if fid == "fast" else "torch:plain")
    if design == "layout":
        assert port.layout_extra_cycles > 0.0
    if design == "noc-pod":
        assert any(o.noc_stats for o in port.ops)


@pytest.mark.parametrize("design,fid", [("noc-pod", "trace"),
                                        ("layout", "trace"),
                                        ("rw-1:4", "fast")])
def test_each_stage_matches_reference(design, fid):
    """The OpContext after every stage of the pipeline, stage by stage."""
    rcfg, op = DESIGNS[design], OPS[0]
    rpipe = rst.build_pipeline(fid)
    tpipe = tst.build_pipeline(fid, device=CPU)
    rctx = rst.OpContext(cfg=rcfg, op=op, ert=rst.DEFAULT_ERT,
                         sp=rst.resolve_sparsity(rcfg, op))
    tctx = tst.OpContext(cfg=tcfg(rcfg), op=top(op), ert=tst.DEFAULT_ERT,
                         sp=tst.resolve_sparsity(tcfg(rcfg), top(op)))
    for rs, ts in zip(rpipe, tpipe):
        rs.apply(rctx)
        ts.apply(tctx)
        for f in ("comp", "util", "filter_shrink", "dram_elems",
                  "dram_bytes", "stall", "layout_extra", "noc_extra",
                  "total", "energy_total"):
            close(getattr(tctx, f), getattr(rctx, f), (rs.name, f))
        assert tctx.scheme == rctx.scheme, rs.name
        if rctx.sram is not None:
            for k, v in rctx.sram.items():
                close(float(tctx.sram[k]), float(v), (rs.name, k))
    assert tctx.dram_stats is None or all(
        tctx.dram_stats[k] == int(rctx.dram_stats[k]) for k in COUNTS)


def test_vector_op_and_default_pipeline():
    rcfg, op = DESIGNS["dense"], OPS[2]
    ref = reng.simulate_op(rcfg, op)
    assert_op_matches(teng.simulate_op(tcfg(rcfg), top(op), device=CPU), ref)
    assert ref.kind == "vector" and ref.macs == 0.0


@pytest.mark.parametrize("trace", ["linear", "strided", "tile_prefetch"])
def test_simulate_dram_matches_reference(trace):
    def build(mod, **dev):
        if trace == "linear":
            return mod.linear_trace(600, issue_gap=0.25, write_every=4,
                                    **dev)
        if trace == "strided":
            return mod.strided_trace(500, 8192, issue_gap=2.0, **dev)
        return mod.tile_prefetch_trace(16 * 1024, 24, 300.0, gran_bytes=64,
                                       **dev)
    configs = [dict()]
    if trace == "tile_prefetch":          # the queue sweep's knobs
        configs.append(dict(channels=2, read_queue=8, write_queue=8))
    for kw in configs:
        ref = rdram.simulate_dram(*build(rdram), RDram(**kw))
        t, a, w = build(tdram, device=CPU)
        for x, y in zip((t, a, w), build(rdram)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        port = tdram.simulate_dram(t, a, w, TDram(**kw))
        for k in COUNTS:
            assert int(getattr(port, k)) == int(getattr(ref, k)), k
        for k in ("stall_cycles", "total_cycles", "bytes_moved",
                  "throughput"):
            close(float(getattr(port, k)), float(getattr(ref, k)), k)
        close(float(port.latency.mean()), float(np.mean(ref.latency)),
              "latency")


def test_simulate_dram_refuses_addresses_past_int32():
    t, a, w = tdram.linear_trace(4, start_addr=2 ** 31 - 128, device=CPU)
    with pytest.raises(ValueError, match="address space"):
        tdram.simulate_dram(t, a, w, TDram())


@pytest.mark.parametrize("design", ["dense", "4-cores", "layout"])
def test_trace_op_and_stats_match_reference(design):
    rcfg, op = DESIGNS[design], OPS[1]
    spec, tspec = rgen.DEFAULT_SPEC, tgen.DEFAULT_SPEC
    ref = rgen.trace_op(rcfg, op, spec)
    port = tgen.trace_op(tcfg(rcfg), top(op), tspec, device=CPU)
    for x, y in zip(port, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    rs = rgen.trace_op_stats(rcfg, op, spec)
    ps = tgen.trace_op_stats(tcfg(rcfg), top(op), tspec, device=CPU)
    assert set(ps) == set(rs)
    for k, v in rs.items():
        if k in COUNTS:
            assert int(ps[k]) == int(v), k
        else:
            close(float(ps[k]), float(v), k)


def test_summaries_match_reference():
    rcfg = DESIGNS["dense"]
    for o in (OPS[0], OPS[1], ROp("x", 1000, 1, 512)):
        ref = rdf.gemm_summary(rcfg, o.M, o.N, o.K)
        port = tdf.gemm_summary(tcfg(rcfg), o.M, o.N, o.K)
        assert set(port) == set(ref)
        for k, v in ref.items():
            close(float(port[k]), float(v), k)
        for df in ("ws", "os", "is"):
            close(tdf.mapping_occupancy(df, o.M, o.N, o.K, 16, 24),
                  float(rdf.mapping_occupancy(df, o.M, o.N, o.K, 16, 24)),
                  df)
    R = np.array([8.0, 16.0, 32.0, 128.0], np.float32)
    ref = reng.gemm_summary_traced("ws", 256, 197, 768, R, R,
                                   sram_elems=65536.0,
                                   bw_bytes_per_cycle=32.0)
    port = teng.gemm_summary_traced("ws", 256, 197, 768, torch.tensor(R),
                                    torch.tensor(R), sram_elems=65536.0,
                                    bw_bytes_per_cycle=32.0)
    for k, v in ref.items():
        np.testing.assert_allclose(port[k].numpy(), np.asarray(v),
                                   rtol=RTOL, err_msg=k)
    comp = np.asarray(ref["compute_cycles"])
    e_ref = reng.energy_traced(comp, 256.0 * 197 * 768,
                               np.asarray(ref["dram_bytes"]), R, R)
    e_port = teng.energy_traced(torch.tensor(comp), 256.0 * 197 * 768,
                                port["dram_bytes"], torch.tensor(R),
                                torch.tensor(R))
    np.testing.assert_allclose(e_port.numpy(), np.asarray(e_ref), rtol=RTOL)


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-1.5b", dict(seq=64, batch=2, mode="train")),
    ("mixtral-8x7b", dict(seq=32, batch=1, mode="prefill")),
    ("qwen2-1.5b", dict(seq=64, batch=4, mode="decode", cache_len=128)),
    ("zamba2-7b", dict(seq=32, batch=1, mode="prefill")),
    ("whisper-base", dict(seq=32, batch=1, mode="decode", cache_len=64)),
    ("xlstm-1.3b", dict(seq=32, batch=1, mode="train")),
], ids=["dense-train", "moe-prefill", "dense-decode", "hybrid", "audio",
        "ssm"])
def test_lm_ops_match_reference(arch, kw):
    cfg = get_config(arch, smoke=True)
    ref = rwl.lm_ops(cfg, **kw)
    port = twl.lm_ops(cfg, **kw)
    assert [dataclasses.asdict(o) for o in port] == \
        [dataclasses.asdict(o) for o in ref]


def test_simulator_facade_matches_reference():
    rsim = rapi.Simulator("paper-32", fidelity="trace")
    tsim = rt.Simulator("paper-32", fidelity="trace", device=CPU)
    assert tsim.device == torch.device("cpu") and tsim.engine == "megakernel"
    assert_op_matches(tsim.run_op(top(OPS[0])), rsim.run_op(OPS[0]))
    # with_ keeps the session (device, fidelity, spec)
    rlay = rsim.with_(layout=LayoutConfig(enabled=True))
    tlay = tsim.with_(layout=rt.core.LayoutConfig(enabled=True))
    assert tlay.device == tsim.device and tlay.fidelity == "trace"
    assert_report_matches(tlay.run([top(o) for o in OPS[:2]]),
                          rlay.run(OPS[:2]))
    # from_preset forwards preset keywords
    rpre = rapi.Simulator.from_preset("tpu-like", array=16, sram_mb=0.25)
    tpre = rt.Simulator.from_preset("tpu-like", array=16, sram_mb=0.25,
                                    device=CPU)
    assert tpre.config.to_dict() == rpre.config.to_dict()
    rrep = rpre.run(OPS)
    trep = tpre.run([top(o) for o in OPS])
    assert_report_matches(trep, rrep)
    assert tpre.seconds(2e9) == rpre.seconds(2e9)
    assert rt.Simulator.wave_cost(trep, trep, 5) == pytest.approx(
        rapi.Simulator.wave_cost(rrep, rrep, 5), rel=RTOL)
    # run_lm through lm_ops
    cfg = get_config("qwen2-1.5b", smoke=True)
    close(tpre.run_lm(cfg, seq=32, batch=1, mode="prefill").total_cycles,
          rpre.run_lm(cfg, seq=32, batch=1, mode="prefill").total_cycles,
          "run_lm")


def test_simulator_sweep_matches_reference():
    grid = [DESIGNS["dense"], DESIGNS["lw-2:4"], DESIGNS["4-cores"]]
    ref = rapi.Simulator().sweep(grid, OPS)
    port = rt.Simulator(device=CPU).sweep([tcfg(c) for c in grid],
                                          [top(o) for o in OPS])
    fb = rt.Simulator(device=CPU).sweep([tcfg(c) for c in grid],
                                        [top(o) for o in OPS],
                                        force_fallback=True)
    assert port.batched and not fb.batched and len(port) == 3
    for k in ("total_cycles", "compute_cycles", "stall_cycles",
              "dram_bytes", "energy_pj", "utilization", "edp"):
        np.testing.assert_allclose(getattr(port, k), getattr(ref, k),
                                   rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(getattr(fb, k), getattr(ref, k),
                                   rtol=RTOL, err_msg=k)
    assert port.argbest("edp") == ref.argbest("edp")
    assert len(rt.Simulator(device=CPU).sweep([], OPS)) == 0


def test_simulator_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.Simulator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.build_pipeline("cycle")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdram.linear_trace(8)


def test_report_serialization_matches_reference(tmp_path):
    rcfg = DESIGNS["dense"]
    ref = reng.simulate_network(rcfg, OPS, dram_fidelity="cycle")
    port = teng.simulate_network(tcfg(rcfg), [top(o) for o in OPS],
                                 dram_fidelity="cycle", device=CPU)
    rj, pj = json.loads(ref.to_json()), json.loads(port.to_json())
    assert list(pj) == list(rj) and pj["schema_version"] == \
        rj["schema_version"]
    assert [list(o) for o in pj["ops"]] == [list(o) for o in rj["ops"]]
    assert pj["engine"] == "torch:plain" and rj["engine"] == "xla"
    ref.write_csv(str(tmp_path / "ref.csv"))
    port.write_csv(str(tmp_path / "port.csv"))
    with open(tmp_path / "ref.csv") as f:
        rrows = list(csv.reader(f))
    with open(tmp_path / "port.csv") as f:
        prows = list(csv.reader(f))
    assert prows[0] == rrows[0] and len(prows) == len(rrows)
    for a, b in zip(prows[1:], rrows[1:]):
        assert a[:2] == b[:2]
        np.testing.assert_allclose(np.array(a[2:], float),
                                   np.array(b[2:], float), rtol=RTOL)
