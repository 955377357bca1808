"""The PyTorch port's trace generator and address decode against the JAX
reference: the demand streams and their (bank, channel, row) decode must
come out bit-identical for every op of the paper workloads, on each
dataflow and layout, with the same float32 inputs, both from
`gemm_request_stream`'s sort + `decode_requests` ("sort") and from the
streams layer's dispatch on the CPU, `kernels.streams.
decoded_request_streams` ("decoded"); the issue times rise within each
region, the premise of the streams kernel's merge; and the port's
streams conserve bytes against the capacity model."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.accelerator as racc
import repro.core.dataflow as rdf
import repro.core.dram as rdram
import repro.core.workloads as rwl
import repro.trace.generator as rgen
import repro_torch.core.accelerator as tacc
import repro_torch.core.dram as tdram
import repro_torch.core.stages as tst
import repro_torch.core.workloads as twl
import repro_torch.kernels.streams as tks
import repro_torch.trace.generator as tgen

F32 = np.float32

DESIGNS = {
    "paper-32": racc.tpu_like_config(32),
    "paper-64": racc.tpu_like_config(64),
    "tpu32-0.4MB": racc.tpu_like_config(32, sram_mb=0.4),
}
WORKLOADS = {
    "resnet18_six_layers": rwl.resnet18_six_layers(),
    "vit_linear": rwl.vit_linear(768, 2, 3072),
}


def _inputs(cfg, ops):
    gem = [o for o in ops if o.kind == "gemm"]
    arr = {k: np.array([getattr(o, k) for o in gem], F32) for k in "MNK"}
    core, m = cfg.cores[0], cfg.memory
    arr["R"], arr["C"] = F32(core.rows), F32(core.cols)
    arr["mem"] = [F32(m.ifmap_sram_bytes), F32(m.filter_sram_bytes),
                  F32(m.ofmap_sram_bytes)]
    return arr


def _reference(df, a, spec):
    """The reference's sweep path: dataflow model -> vmapped generator ->
    one flat decode."""
    j = {k: jnp.asarray(a[k]) for k in ("M", "N", "K", "R", "C")}
    mem = racc.MemoryConfig(*(jnp.asarray(x) for x in a["mem"]),
                            l2_sram_bytes=jnp.float32(0), word_bytes=2)
    comp = rdf.compute_cycles(df, j["M"], j["N"], j["K"], j["R"], j["C"])
    dr = rdf.dram_traffic(df, j["M"], j["N"], j["K"], j["R"], j["C"], mem)

    def per_op(m, n, k, c, di, dfl, dow, dor):
        return rgen.gemm_request_stream(df, m, n, k, j["R"], j["C"], c, di,
                                        dfl, dow, dor, 2, spec)

    out = jax.vmap(per_op)(j["M"], j["N"], j["K"], comp, dr["dram_ifmap"],
                           dr["dram_filter"], dr["dram_ofmap_writes"],
                           dr["dram_ofmap_reads"])
    return [np.asarray(x) for x in out]


def _port_args(df, a):
    t = {k: torch.from_numpy(np.asarray(a[k])) for k in
         ("M", "N", "K", "R", "C")}
    mem = tacc.MemoryConfig(*(torch.tensor(x) for x in a["mem"]),
                            l2_sram_bytes=torch.tensor(F32(0)), word_bytes=2)
    comp, _, dr, _ = tst.traced_comp_traffic(df, t["M"], t["N"], t["K"],
                                             t["R"], t["C"], mem)
    return (t["M"], t["N"], t["K"], t["R"], t["C"], comp, dr["dram_ifmap"],
            dr["dram_filter"], dr["dram_ofmap_writes"],
            dr["dram_ofmap_reads"]), dr


def _port(df, a, spec):
    args, dr = _port_args(df, a)
    out = tgen.gemm_request_stream(df, *args, 2, spec)
    return [x.numpy() for x in out], dr


def _assert_streams_identical(df, cfg, ops, layout="row", path="sort"):
    a = _inputs(cfg, ops)
    rspec = rgen.TraceSpec(layout=layout)
    tspec = tgen.TraceSpec(**dataclasses.asdict(rspec))
    ref = _reference(df, a, rspec)
    dcfg = cfg.dram
    tcfg = tacc.DramConfig(**dataclasses.asdict(dcfg))
    rdec = rdram.decode_requests(jnp.asarray(ref[1]), dcfg)
    if path == "sort":
        port, _ = _port(df, a, tspec)
        tdec = tdram.decode_requests(torch.from_numpy(port[1]), tcfg)
    else:
        # what the sweep's `decoded_streams` calls: generated, sorted and
        # decoded from one prologue
        args, _ = _port_args(df, a)
        (t, fb, ch, row, w, v), scale = tks.decoded_request_streams(
            df, *args, 2, tspec, tcfg)
        port = [t.numpy(), ref[1], w.numpy(), v.numpy(), scale.numpy()]
        tdec = (fb, ch, row)
    for name, r, p in zip(("t_issue", "addr", "is_write", "valid", "scale"),
                          ref, port):
        assert r.shape == p.shape, name
        np.testing.assert_array_equal(p, r.astype(p.dtype), err_msg=name)
    for name, r, p in zip(("flat_bank", "ch", "row"), rdec, tdec):
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("path", ["sort", "decoded"])
@pytest.mark.parametrize("df", ["ws", "os", "is"])
@pytest.mark.parametrize("design", list(DESIGNS))
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_streams_and_decode_bit_identical(workload, design, df, path):
    cfg = DESIGNS[design].with_(dataflow=df)
    _assert_streams_identical(df, cfg, WORKLOADS[workload], path=path)


@pytest.mark.parametrize("path", ["sort", "decoded"])
@pytest.mark.parametrize("layout", ["col", "tiled", "strided"])
def test_layouts_bit_identical(layout, path):
    op = [rwl.resnet18()[2]]
    _assert_streams_identical("ws", DESIGNS["paper-32"], op, layout=layout,
                              path=path)


@pytest.mark.parametrize("df,array,sram_mb", [("ws", 32, 0.5), ("os", 64, 2.0),
                                              ("is", 128, 8.0)])
def test_merge_equals_sort_at_the_benchmark_cap(df, array, sram_mb):
    """At cap 65,536 over resnet18's 21 gemm ops on tpu-like designs, the
    premise under which the streams kernel's rank by the reference's
    4-way merge is the stable sort: the valid slots are a prefix, the
    regions run in order, and the issue time is non-decreasing within
    each region. The CPU dispatch equals `gemm_request_stream`'s sort +
    `decode_requests` bit for bit."""
    cfg = tacc.tpu_like_config(array, dataflow=df, sram_mb=sram_mb)
    ops = [o for o in twl.resnet18() if o.kind == "gemm"]
    a = _inputs(cfg, ops)
    args, _ = _port_args(df, a)
    spec = tgen.TraceSpec(cap=65536)
    t, _, _, valid, region = tgen.stream_slots(
        tgen.stream_prologue(df, *args, 2, spec))
    assert int(valid.sum()) > 0 and not bool(valid.all())
    assert not bool((valid[..., 1:] & ~valid[..., :-1]).any())
    assert bool((region[..., 1:] >= region[..., :-1]).all())
    same = valid[..., 1:] & (region[..., 1:] == region[..., :-1])
    assert not bool((same & (t[..., 1:] < t[..., :-1])).any())
    st, addr, w, v, scale = tgen.gemm_request_stream(df, *args, 2, spec)
    want = (st,) + tdram.decode_requests(addr, cfg.dram) + (w, v, scale)
    (mt, fb, ch, row, mw, mv), mscale = tks.decoded_request_streams(
        df, *args, 2, spec, cfg.dram)
    for name, p, r in zip(("t", "flat_bank", "ch", "row", "is_write",
                           "valid", "scale"),
                          (mt, fb, ch, row, mw, mv, mscale), want):
        assert p.dtype == r.dtype and torch.equal(p, r), name


@pytest.mark.parametrize("df", ["ws", "os", "is"])
def test_request_byte_conservation(df):
    """sum(valid) * gran * scale == the capacity model's byte total."""
    cfg = racc.tpu_like_config(32, dataflow=df, sram_mb=0.5)
    ops = [rwl.Op("g", 384, 1500, 640), rwl.Op("h", 64, 100, 64)]
    port, dr = _port(df, _inputs(cfg, ops), tgen.TraceSpec(cap=2048))
    _, _, _, valid, scale = port
    expect = sum(v.numpy().astype(np.float64) for v in dr.values()) * 2
    got = valid.sum(-1) * 64 * scale.astype(np.float64)
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    t = port[0]
    for row, v in zip(t, valid):        # sorted by issue time, valid first
        assert np.all(np.diff(row[v]) >= 0) and not v[v.sum():].any()


def test_generator_batches_designs_by_ops():
    """A (designs, ops) batch equals the per-design generator runs."""
    ops = WORKLOADS["resnet18_six_layers"]
    spec = tgen.TraceSpec(cap=256)
    rows = []
    for cfg in DESIGNS.values():
        port, _ = _port("ws", _inputs(cfg, ops), spec)
        rows.append(port)
    a = [_inputs(c, ops) for c in DESIGNS.values()]
    t = {k: torch.from_numpy(np.asarray(a[0][k])) for k in ("M", "N", "K")}
    R = torch.tensor([[x["R"]] for x in a])
    C = torch.tensor([[x["C"]] for x in a])
    mem = tacc.MemoryConfig(*(torch.tensor([[x["mem"][i]] for x in a])
                              for i in range(3)),
                            l2_sram_bytes=torch.zeros(3, 1), word_bytes=2)
    comp, _, dr, _ = tst.traced_comp_traffic("ws", t["M"], t["N"], t["K"],
                                             R, C, mem)
    out = tgen.gemm_request_stream(
        "ws", t["M"], t["N"], t["K"], R, C, comp, dr["dram_ifmap"],
        dr["dram_filter"], dr["dram_ofmap_writes"], dr["dram_ofmap_reads"],
        2, spec)
    for k in range(5):
        np.testing.assert_array_equal(
            out[k].numpy(), np.stack([r[k] for r in rows]))


def test_address_guard_raises():
    with pytest.raises(ValueError):
        tdram.decode_requests(torch.tensor([0, -64]), tacc.DramConfig())
    with pytest.raises(ValueError):
        tdram.decode_requests(torch.tensor([2 ** 31]), tacc.DramConfig())
