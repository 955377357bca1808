"""The PyTorch port's shared-DRAM contention path on the CPU against the JAX
reference: `simulate_shared_dram` against the reference's per-request
shared scan, the replay's plain version in its multi-core,
per-channel-queue mode against the interpret-mode Pallas megakernel, the
private-channel decomposition, `multicore_contention` and the named study
`multicore_contention`; and the two repairs that came with it
(`Study.options(core_index=)` on a heterogeneous mesh, out-of-range bank
ids in the bank-conflict kernel's plain version).

Counts are order-only and must match exactly; stalls, completions and
makespans agree within 1e-3 relative (the chunk closures re-associate
float32 sums), the decomposition within 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.accelerator as racc
import repro.core.dram as rdram
import repro.trace.contention as rcont
from repro.api import study as rstudy
from repro.kernels.conflict import conflict_slowdown as r_pallas_conflict
from repro.kernels.replay import replay_megakernel as jax_megakernel
from repro.trace import TraceSpec as RTraceSpec
import repro_torch as rt
import repro_torch.core.accelerator as tacc
import repro_torch.core.dram as tdram
import repro_torch.trace.contention as tcont
from repro_torch.api import study as tstudy
from repro_torch.core.multicore import (contention_summary,
                                        simulate_multicore_contention)
from repro_torch.kernels.conflict import conflict_slowdown_reference
from repro_torch.kernels.replay import megakernel as tmk

RTOL, ATOL = 1e-3, 5e-2


def _tcfg(cfg):
    return tacc.DramConfig(**dataclasses.asdict(cfg))


def merged_stream(seed, n, *, cores=4, span=1 << 20, t_max=1000.0,
                  p_write=0.3, p_valid=0.9):
    """The reference suite's merged stream, from numpy: sorted issue
    times, burst-aligned addresses, a core id per request."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, t_max, n)).astype(np.float32)
    addr = ((rng.integers(0, span, n) // 64) * 64).astype(np.int64)
    w = rng.random(n) < p_write
    cid = rng.integers(0, cores, n).astype(np.int32)
    v = rng.random(n) < p_valid
    return t, addr, w, cid, v


def _port_shared(t, addr, w, cid, v, n_cores, cfg, **kw):
    r = tcont.simulate_shared_dram(
        torch.from_numpy(t), torch.from_numpy(addr), torch.from_numpy(w),
        torch.from_numpy(cid), torch.from_numpy(v), n_cores, _tcfg(cfg),
        **kw)
    return {f.name: getattr(r, f.name).numpy()
            for f in dataclasses.fields(r)}


def _ref_shared(t, addr, w, cid, v, n_cores, cfg, **kw):
    r = rcont.simulate_shared_dram(
        jnp.asarray(t), jnp.asarray(addr.astype(np.int32)), jnp.asarray(w),
        jnp.asarray(cid), jnp.asarray(v), n_cores, cfg, **kw)
    return {f.name: np.asarray(getattr(r, f.name))
            for f in dataclasses.fields(r)}


def _assert_shared_match(out, ref, rtol=RTOL, atol=ATOL):
    for k in ("row_hits", "row_misses", "row_conflicts"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    for k in ("per_core_stall", "per_core_last", "total_cycles"):
        np.testing.assert_allclose(out[k], ref[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("engine", [None, "reference"])
def test_shared_dram_matches_reference_scan(engine):
    """n = 600, 4 cores, 2 channels, queues 8 / 4 (the reference's
    `test_replay.py::test_shared_dram_matches_reference`): the chunked
    replay's plain version and the port's own per-request scan against
    the reference's per-request scan."""
    t, a, w, cid, v = merged_stream(11, 600)
    cfg = racc.DramConfig(channels=2, read_queue=8, write_queue=4)
    ref = _ref_shared(t, a, w, cid, v, 4, cfg, engine="reference")
    out = _port_shared(t, a, w, cid, v, 4, cfg, engine=engine)
    assert out["per_core_stall"].shape == (4,)
    assert float(ref["per_core_stall"].max()) > 0.0
    if engine == "reference":
        _assert_shared_match(out, ref, rtol=1e-6, atol=0.0)
    else:
        _assert_shared_match(out, ref)


@pytest.mark.parametrize("case", ["q8_4_c64", "q4_2_c32_cap1", "ch4_q6_3_c64"])
def test_plain_version_matches_interpret_mode_megakernel(case):
    """`run_plain` with n_cores = 4 and a queue group per channel against
    the Pallas megakernel (`n_cores=4, core_id=..., per_channel_queues=
    True`) interpreted on the CPU: counts exact, completions and per-core
    shifts within 1e-3. Short rings put queue heads inside the chunk; a
    pass cap of 1 stops both short of the fixed point."""
    channels, (qr, qw), C, cap = {
        "q8_4_c64": (2, (8, 4), 64, None),
        "q4_2_c32_cap1": (2, (4, 2), 32, 1),
        "ch4_q6_3_c64": (4, (6, 3), 64, None)}[case]
    t, a, w, cid, v = merged_stream(len(case), 160, span=1 << 14,
                                    t_max=60.0)
    cfg = racc.DramConfig(channels=channels, read_queue=qr, write_queue=qw)
    fb, ch, row = rdram.decode_requests(jnp.asarray(a.astype(np.int32)), cfg)
    ref = jax_megakernel(
        jnp.asarray(t), fb, ch, row, jnp.asarray(w.astype(np.int32)),
        jnp.asarray(v.astype(np.int32)), cfg, chunk=C, max_passes=cap,
        tol=0.25, n_cores=4, core_id=jnp.asarray(cid),
        per_channel_queues=True, interpret=True)
    tcfg = _tcfg(cfg)
    tfb, tch, trow = tdram.decode_requests(torch.from_numpy(a), tcfg)
    ins = tmk.prepare(torch.from_numpy(t), tfb, tch, trow,
                      torch.from_numpy(w), torch.from_numpy(v), C,
                      torch.from_numpy(cid))
    done, shift, cnt, _ = tmk.run_plain(
        ins, cfg=tcfg, busy=64 / 19.2, C=C, max_passes=cap, tol=0.25,
        n_cores=4, n_qg=channels)
    for j, k in enumerate(("hits", "misses", "conflicts")):
        assert int(cnt[0, j]) == int(ref[k]), k
    np.testing.assert_allclose(done[0, :160].numpy() * v,
                               np.asarray(ref["done"]) * v,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(shift[0].numpy(), np.asarray(ref["shift"]),
                               rtol=RTOL, atol=ATOL)
    assert float(shift.max()) > 0.0


def test_single_core_single_group_is_the_sweep_replay():
    """n_cores = n_qg = 1 through the multi-core entry (core ids given,
    all zero) is exactly the single-core replay."""
    t, a, w, _, v = merged_stream(3, 300, span=1 << 12, t_max=100.0)
    tcfg = tacc.DramConfig(read_queue=8, write_queue=4)
    fb, ch, row = tdram.decode_requests(torch.from_numpy(a), tcfg)
    args = (torch.from_numpy(t), fb, ch, row, torch.from_numpy(w),
            torch.from_numpy(v))
    kw = dict(cfg=tcfg, busy=64 / 19.2, C=64, max_passes=None, tol=0.25)
    one = tmk.run_plain(tmk.prepare(*args, 64), **kw)
    cid = torch.zeros(300, dtype=torch.int32)
    new = tmk.run_plain(tmk.prepare(*args, 64, cid), n_cores=1, n_qg=1,
                        **kw)
    for x, y in zip(one, new):
        assert torch.equal(x, y)


def test_wrapper_refuses_modes_beyond_the_kernel_limits():
    tcfg = tacc.DramConfig(channels=2)
    ins = tmk.prepare(torch.zeros(64), *(torch.zeros(64, dtype=torch.int32)
                                         for _ in range(5)), 64)
    kw = dict(cfg=tcfg, busy=3.3, C=64, max_passes=None, tol=0.25)
    for bad in (dict(n_cores=tmk.MAX_CORES + 1), dict(n_cores=0),
                dict(n_qg=3)):
        with pytest.raises(ValueError, match="n_cores|n_qg"):
            tmk.launch_cuda(ins, **kw, **bad)
        with pytest.raises(ValueError, match="n_cores|n_qg"):
            tmk.run_plain(ins, **kw, **bad)
    wide = tacc.DramConfig(channels=tmk.MAX_QUEUE_GROUPS + 1)
    with pytest.raises(ValueError, match="queue groups"):
        tmk.run_plain(ins, **dict(kw, cfg=wide),
                      n_qg=tmk.MAX_QUEUE_GROUPS + 1)
    # a valid request whose core id is past n_cores never reaches a launch
    ins = ins[:5] + (torch.ones(1, 64, dtype=torch.int32),) + \
        (torch.full((1, 64), 2, dtype=torch.int32),)
    with pytest.raises(ValueError, match="core_id"):
        tmk._check_ids(ins, n_banks=32, ch_n=2, n_cores=2)


def test_private_channel_decomposition():
    """Two cores pinned to their own channels: the merged replay equals
    the isolated runs within 1e-6 relative (max_passes=64, tol=0.0, the
    contract `multicore_contention` relies on;
    `test_replay_fuzz.py::test_shared_dram_private_channel_invariant_all_engines`)."""
    cfg = racc.DramConfig(channels=2, banks_per_channel=4)
    n = 256
    rng = np.random.default_rng(3)
    cores = []
    for core in range(2):
        t = np.sort(rng.uniform(0, 200.0, n)).astype(np.float32)
        b = rng.integers(0, 1 << 14, n)
        addr = ((b * cfg.channels + core) * cfg.burst_bytes).astype(np.int64)
        cores.append((t, addr, rng.random(n) < 0.3))
    kw = dict(max_passes=64, tol=0.0)
    ones = np.ones(n, bool)
    iso = [_port_shared(t, a, w, np.zeros(n, np.int32), ones, 1, cfg, **kw)
           for t, a, w in cores]
    t = np.concatenate([c[0] for c in cores])
    order = np.argsort(t, kind="stable")
    merged = [np.concatenate([c[j] for c in cores])[order] for j in (1, 2)]
    cid = np.repeat(np.arange(2, dtype=np.int32), n)[order]
    shared = _port_shared(t[order], merged[0], merged[1], cid,
                          np.ones(2 * n, bool), 2, cfg, **kw)
    got = shared["per_core_stall"]
    want = np.array([i["per_core_stall"][0] for i in iso])
    assert want.min() > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


def _mesh_cfgs(channels, cores=2):
    mem = dict(ifmap_sram_bytes=1 << 17, filter_sram_bytes=1 << 17,
               ofmap_sram_bytes=1 << 17)
    ref = racc.AcceleratorConfig(
        cores=(racc.CoreConfig(rows=32, cols=32),), mesh_rows=cores,
        mesh_cols=1, memory=racc.MemoryConfig(**mem),
        dram=racc.DramConfig(channels=channels))
    return ref, tacc.AcceleratorConfig.from_dict(ref.to_dict())


@pytest.mark.parametrize("private", [False, True])
def test_multicore_contention_matches_reference(private):
    """A 2-core mesh over 2 channels at cap 1,024, shared and private
    routing (the reference's `test_trace.py` contention cases)."""
    rcfg, tcfg = _mesh_cfgs(2)
    ref = rcont.multicore_contention(rcfg, 512, 2048, 1024,
                                     private_channels=private,
                                     spec=RTraceSpec(cap=1024))
    out = simulate_multicore_contention(tcfg, 512, 2048, 1024,
                                        private_channels=private,
                                        spec=rt.TraceSpec(cap=1024),
                                        device="cpu")
    for k in ("row_hits", "row_misses", "row_conflicts", "scheme",
              "private_channels", "per_core_compute", "scaled_by"):
        assert getattr(out, k) == getattr(ref, k), k
    for k in ("per_core_stall_isolated", "per_core_stall_shared"):
        np.testing.assert_allclose(getattr(out, k), getattr(ref, k),
                                   rtol=RTOL, err_msg=k)
    for k in ("makespan_isolated", "makespan_shared"):
        assert getattr(out, k) == pytest.approx(getattr(ref, k), rel=RTOL)
    if private:
        np.testing.assert_allclose(out.per_core_stall_shared,
                                   out.per_core_stall_isolated, rtol=1e-6)
    else:
        assert out.makespan_shared >= out.makespan_isolated
    summary = contention_summary(tcfg, 512, 2048, 1024,
                                 private_channels=private,
                                 spec=rt.TraceSpec(cap=1024), device="cpu")
    assert summary["makespan_shared"] == out.makespan_shared


def test_named_study_matches_reference_and_claims_hold():
    """`studies.multicore_contention` at 1 and 4 channels on a smaller
    GEMM (the reference's `test_study.py::test_contention_study_claims`):
    the three claims hold on both frames, which agree within 1e-3."""
    kw = dict(channels=(1, 4), gemm=(256, 512, 512))
    ref = rstudy.studies.multicore_contention(
        spec=RTraceSpec(cap=1024), **kw).run()
    port = tstudy.studies.multicore_contention(
        spec=rt.TraceSpec(cap=1024), **kw).run(device="cpu")
    assert port.column_names() == ref.column_names()
    for c in ref.column_names():
        if c in ("design", "workload", "fidelity"):
            assert list(port[c]) == list(ref[c]), c
        else:
            np.testing.assert_allclose(np.asarray(port[c], float),
                                       np.asarray(ref[c], float),
                                       rtol=RTOL, err_msg=c)
    claims = port.check_claims()
    assert len(claims) == 3 and all(claims.values()), claims
    assert (port["batched"] == 0.0).all()
    assert port.meta["engine"] == "torch:plain"


def test_evaluator_cells_fail_alone_and_value_errors_propagate():
    """An evaluator that raises fails its own cell (`cell_status` 1.0);
    a ValueError, an invalid configuration, propagates."""
    def ev(cfg, ops, fidelity, *, device):
        if cfg.cores[0].rows == 32:
            raise RuntimeError("boom")
        return {"x": 1.0}

    s = (rt.Study().designs({"a": "paper-32", "b": "paper-64"})
         .workloads({"w": [rt.Op("g", 64, 64, 64)]}).evaluator(ev))
    res = s.run(device="cpu")
    assert list(res["cell_status"]) == [1.0, 0.0]
    assert np.isnan(res["x"][0]) and res["x"][1] == 1.0

    def bad(cfg, ops, fidelity, *, device):
        raise ValueError("invalid")

    with pytest.raises(ValueError, match="invalid"):
        s.evaluator(bad).run(device="cpu")


def _hetero():
    """One 32x32 and one 64x64 core on a 1 x 2 grid."""
    from repro.core.accelerator import CoreConfig, tpu_like_config
    base = tpu_like_config(array=32, cores=2, sram_mb=1.0)
    return dataclasses.replace(base, cores=(CoreConfig(rows=32, cols=32),
                                            CoreConfig(rows=64, cols=64)))


def test_core_index_on_a_heterogeneous_mesh():
    """`options(core_index=1)` analyses the 64x64 core, in both packages;
    the frames agree at fast and trace fidelity and differ from
    core 0's."""
    from repro.core.workloads import resnet18_six_layers
    rcfg = _hetero()
    tcfg = tacc.AcceleratorConfig.from_dict(rcfg.to_dict())
    ops = resnet18_six_layers()[:3]
    tops = [rt.Op(**dataclasses.asdict(o)) for o in ops]
    frames = {}
    for ci in (0, 1):
        ref = (rstudy.Study().designs({"h": rcfg}).workloads({"w": ops})
               .fidelity("fast", "trace")
               .options(trace_spec=RTraceSpec(cap=256), core_index=ci).run())
        port = (rt.Study().designs({"h": tcfg}).workloads({"w": tops})
                .fidelity("fast", "trace")
                .options(trace_spec=rt.TraceSpec(cap=256), core_index=ci)
                .run(device="cpu"))
        assert port.column_names() == ref.column_names()
        for c in ref.column_names():
            if c not in ("design", "workload", "fidelity"):
                np.testing.assert_allclose(
                    np.asarray(port[c], float), np.asarray(ref[c], float),
                    rtol=RTOL, err_msg=f"core_index={ci} {c}")
        frames[ci] = port
    assert not np.allclose(frames[0]["total_cycles"],
                           frames[1]["total_cycles"])


def test_conflict_plain_version_drops_out_of_range_bank_ids():
    """Bank ids >= num_banks and < 0 count in no bank, as the Pallas
    kernel's one-hot drops them (interpret mode): a row of lines 0..3 all
    in bank 5 of 4 gives 1, and random rows with a third of their ids out
    of range match exactly."""
    rng = np.random.default_rng(9)
    banks, k = 4, 48
    line = rng.integers(0, 9, (64, k)).astype(np.int32)
    bank = rng.integers(-3, banks + 3, (64, k)).astype(np.int32)
    line[0], bank[0] = np.arange(k) % 4, 5
    line[1], bank[1] = np.arange(k), -1
    line[2], bank[2] = np.arange(k), np.where(np.arange(k) % 2, 0, banks)
    for ports in (1, 2):
        want = np.asarray(r_pallas_conflict(
            jnp.asarray(line), jnp.asarray(bank), num_banks=banks,
            ports=ports, interpret=True))
        got = conflict_slowdown_reference(
            torch.from_numpy(line), torch.from_numpy(bank), num_banks=banks,
            ports=ports).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"ports={ports}")
    assert got[0] == 1 and got[1] == 1
