"""The PyTorch port's config layer against the JAX reference: presets,
workloads, validation, dict round-trips, and the elementwise models
(dataflow, energy) bit for bit on the same float32 inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api.presets as rpre
import repro.core.accelerator as racc
import repro.core.dataflow as rdf
import repro.core.energy as ren
import repro.core.workloads as rwl
import repro.trace.generator as rgen
import repro_torch.api.presets as tpre
import repro_torch.core.accelerator as tacc
import repro_torch.core.dataflow as tdf
import repro_torch.core.energy as ten
import repro_torch.core.workloads as twl
import repro_torch.trace.generator as tgen


def test_preset_registries_match():
    assert tpre.list_presets() == rpre.list_presets()


@pytest.mark.parametrize("name", rpre.list_presets())
def test_preset_to_dict_equal(name):
    ref = rpre.get_preset(name).to_dict()
    assert tpre.get_preset(name).to_dict() == ref
    # from_dict accepts the reference's dict and round-trips it exactly
    assert tacc.AcceleratorConfig.from_dict(ref).to_dict() == ref


def test_preset_grid_matches():
    kw = dict(array=[16, 32, 64, 128], sram_mb=[0.25, 8],
              dataflow=["ws", "os", "is"])
    ref = [c.to_dict() for c in rpre.preset_grid(**kw)]
    assert [c.to_dict() for c in tpre.preset_grid(**kw)] == ref
    ref = [c.to_dict() for c in rpre.preset_grid(
        preset=["paper-32", "edge-8"], cores=[1, 4], sparsity=["dense", "2:4"])]
    assert [c.to_dict() for c in tpre.preset_grid(
        preset=["paper-32", "edge-8"], cores=[1, 4],
        sparsity=["dense", "2:4"])] == ref


def test_reference_configs_from_dict_round_trip():
    refs = [racc.tpu_like_config(32, sram_mb=0.4),
            racc.tpu_like_config(64, cores=6, dataflow="os"),
            racc.AcceleratorConfig(
                dram=racc.DramConfig(channels=4, read_queue=8),
                layout=racc.LayoutConfig(enabled=True, num_banks=16),
                noc=racc.NocConfig(topology="torus"))]
    for ref in refs:
        d = ref.to_dict()
        port = tacc.AcceleratorConfig.from_dict(d)
        assert port.to_dict() == d
        assert racc.AcceleratorConfig.from_dict(port.to_dict()) == ref
    assert tacc.near_square_grid(12) == racc.near_square_grid(12)


WORKLOADS = [
    ("resnet18", lambda m: m.resnet18()),
    ("resnet18_six_layers", lambda m: m.resnet18_six_layers()),
    ("alexnet", lambda m: m.alexnet()),
    ("resnet50", lambda m: m.resnet50()),
    ("vit_base", lambda m: m.vit_base()),
    ("vit_small", lambda m: m.vit_small()),
    ("vit_large", lambda m: m.vit_large()),
    ("vit_linear", lambda m: m.vit_linear(768, 2, 3072)),
    ("vit_base_linear", lambda m: m.vit_base_linear()),
    ("vit_ffn_only", lambda m: m.vit_ffn_only()),
    ("rcnn", lambda m: m.rcnn()),
]


@pytest.mark.parametrize("name,make", WORKLOADS, ids=[w[0] for w in WORKLOADS])
def test_workload_op_lists_identical(name, make):
    ref, port = make(rwl), make(twl)
    assert [dataclasses.asdict(o) for o in port] == \
        [dataclasses.asdict(o) for o in ref]
    # the port's Op rebuilds from the reference's asdict
    assert [twl.Op(**dataclasses.asdict(o)) for o in ref] == port
    assert twl.total_macs(port) == rwl.total_macs(ref)


def test_paper_workload_registry_matches():
    assert sorted(twl.PAPER_WORKLOADS) == sorted(rwl.PAPER_WORKLOADS)


BAD = [
    ("core_shape", lambda a: a.CoreConfig(rows=0)),
    ("nop_hops", lambda a: a.CoreConfig(nop_hops=-1)),
    ("dram_channels", lambda a: a.DramConfig(channels=0)),
    ("dram_queue", lambda a: a.DramConfig(read_queue=0)),
    ("dram_timing", lambda a: a.DramConfig(tRCD=0)),
    ("dram_bw", lambda a: a.DramConfig(bandwidth_bytes_per_cycle=0.0)),
    ("sparsity_nm", lambda a: a.SparsityConfig(enabled=True, n=5, m=4)),
    ("sparsity_rw_half", lambda a: a.SparsityConfig(enabled=True, n=3, m=4,
                                                    row_wise=True)),
    ("sparsity_rw_m", lambda a: a.SparsityConfig(enabled=True, n=1, m=256,
                                                 row_wise=True)),
    ("noc_topology", lambda a: a.NocConfig(topology="tree")),
    ("noc_bw", lambda a: a.NocConfig(link_bandwidth_bytes_per_cycle=0.0)),
    ("noc_flit", lambda a: a.NocConfig(flit_bytes=0)),
    ("noc_buffer", lambda a: a.NocConfig(buffer_flits=0)),
    ("dataflow", lambda a: a.AcceleratorConfig(dataflow="rs")),
    ("nop_cycles", lambda a: a.AcceleratorConfig(nop_cycles_per_hop=-1.0)),
    ("core_count", lambda a: a.AcceleratorConfig(
        cores=(a.CoreConfig(), a.CoreConfig()), mesh_rows=1, mesh_cols=3)),
    ("grid", lambda a: a.near_square_grid(0)),
]


@pytest.mark.parametrize("name,make", BAD, ids=[b[0] for b in BAD])
def test_bad_configs_raise_in_both(name, make):
    with pytest.raises(ValueError):
        make(racc)
    with pytest.raises(ValueError):
        make(tacc)


@pytest.mark.parametrize("kw", [dict(cap=0), dict(gran_bytes=0),
                                dict(layout="zigzag"), dict(tile_r=0),
                                dict(stride_elems=0)])
def test_bad_trace_specs_raise_in_both(kw):
    with pytest.raises(ValueError):
        rgen.TraceSpec(**kw)
    with pytest.raises(ValueError):
        tgen.TraceSpec(**kw)
    assert dataclasses.asdict(tgen.DEFAULT_SPEC) == \
        dataclasses.asdict(rgen.DEFAULT_SPEC)


def test_unknown_preset_and_sparsity_raise_in_both():
    for mod in (rpre, tpre):
        with pytest.raises(KeyError):
            mod.get_preset("no-such-preset")
        with pytest.raises(ValueError):
            mod.as_sparsity("two:four")
        with pytest.raises(ValueError):
            mod.preset_grid(cores=[1], pods=[4])


# ---- elementwise models, bit for bit ------------------------------------

def _dims(seed, n=64):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(M=rng.integers(1, 5000, n).astype(f32),
                N=rng.integers(1, 20000, n).astype(f32),
                K=rng.integers(1, 5000, n).astype(f32),
                R=rng.choice([8, 16, 32, 64, 128], n).astype(f32),
                C=rng.choice([8, 16, 32, 64, 128], n).astype(f32),
                sram=rng.uniform(1e4, 1e7, n).astype(f32))


@pytest.mark.parametrize("df", ["ws", "os", "is"])
def test_dataflow_models_bit_identical(df):
    d = _dims({"ws": 0, "os": 1, "is": 2}[df])
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.from_numpy(v) for k, v in d.items()}

    def mem(x, pkg):
        return pkg.MemoryConfig(ifmap_sram_bytes=x["sram"],
                                filter_sram_bytes=x["sram"] * 0.5,
                                ofmap_sram_bytes=x["sram"] * 0.25,
                                word_bytes=2)

    def eq(a, b):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    args_j = (df, j["M"], j["N"], j["K"], j["R"], j["C"])
    args_t = (df, t["M"], t["N"], t["K"], t["R"], t["C"])
    eq(rdf.compute_cycles(*args_j), tdf.compute_cycles(*args_t))
    eq(rdf.pe_utilization(*args_j), tdf.pe_utilization(*args_t))
    for k, v in rdf.sram_traffic(*args_j).items():
        eq(jnp.broadcast_to(v, j["M"].shape),
           torch.broadcast_to(tdf.sram_traffic(*args_t)[k], t["M"].shape))
    rd = rdf.dram_traffic(*args_j, mem(j, racc))
    td = tdf.dram_traffic(*args_t, mem(t, tacc))
    for k in rd:
        eq(rd[k], td[k])
    eq(rdf.simd_cycles(j["N"], j["R"], 1.5),
       tdf.simd_cycles(t["N"], t["R"], 1.5))
    assert tdf.unmap_gemm(df, *tdf.map_gemm(df, 3, 5, 7)) == (3, 5, 7)


def test_energy_counts_and_pj_match():
    d = _dims(3)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.from_numpy(v) for k, v in d.items()}

    def counts(x, mod):
        return mod.action_counts_raw(
            pes=x["R"] * x["C"], dim32=x["R"] / 32.0, sram_kib=x["sram"],
            word_bytes=2, cycles=x["N"] * 3.0, macs=x["M"] * x["K"],
            ifmap_reads=x["K"], filter_reads=x["M"], ofmap_writes=x["N"],
            ofmap_reads=x["M"] * 0.5, dram_bytes=x["N"] * 4.0,
            l2_reads=x["K"] * 2.0)

    rc, tc = counts(j, ren), counts(t, ten)
    assert list(rc) == list(tc)
    re_, te_ = ren.energy_pj(rc), ten.energy_pj(tc)
    for k in re_:
        np.testing.assert_allclose(np.asarray(te_[k], np.float64),
                                   np.asarray(re_[k], np.float64),
                                   rtol=1e-6)
    assert dataclasses.asdict(ten.DEFAULT_ERT) == \
        dataclasses.asdict(ren.DEFAULT_ERT)
    assert ten.edp(2.0e9, 3.0) == ren.edp(2.0e9, 3.0)
    assert ten.repeat_fraction(64, 2) == ren.repeat_fraction(64, 2)


def test_traced_gemm_stats_and_vector_stats_match():
    """The legacy traced pair (`traced_memory` without an ofmap size ->
    psums never spill) and the SIMD sidecar, bit for bit."""
    import repro.core.stages as rst
    import repro_torch.core.stages as tst
    d = _dims(4)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    for df in ("ws", "os", "is"):
        r = rst.traced_gemm_stats(df, j["M"], j["N"], j["K"], j["R"], j["C"],
                                  rst.traced_memory(j["sram"]), 19.2 * 2)
        p = tst.traced_gemm_stats(df, t["M"], t["N"], t["K"], t["R"], t["C"],
                                  tst.traced_memory(t["sram"]), 19.2 * 2)
        for k in r:
            np.testing.assert_array_equal(
                p[k].numpy(), np.asarray(jnp.broadcast_to(r[k], j["M"].shape)),
                err_msg=f"{df} {k}")
    rv = rst.traced_vector_stats(j["N"], j["R"], 2.0, 2)
    tv = tst.traced_vector_stats(t["N"], t["R"], 2.0, 2)
    for k in rv:
        np.testing.assert_array_equal(tv[k].numpy(), np.asarray(rv[k]))


def test_frame_schema_matches():
    import repro.core.engine as reng
    import repro_torch.core.engine as teng
    assert teng.RESULT_SCHEMA_VERSION == reng.RESULT_SCHEMA_VERSION
    assert teng.ENERGY_GROUP_COLUMNS == reng.ENERGY_GROUP_COLUMNS
    by_action = {"mac_random": 1.5, "pe_leak": 2.0, "dram_bytes": 4.0,
                 "sram_idle_kib_cycles": 0.25, "l2_write": 8.0}
    assert teng.energy_group_totals(by_action) == \
        reng.energy_group_totals(by_action)
    assert teng.energy_group_totals(None) == reng.energy_group_totals(None)
