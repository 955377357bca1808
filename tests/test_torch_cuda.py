"""Tests of the port that need an NVIDIA card: the CUDA replay (single-
and multi-core), bank-conflict, fold matmul, wavefront, ELLPACK and
streams kernels against their plain PyTorch versions (both ELLPACK paths;
for the streams, the generator's sort + decode), the fold plane,
the contention path and NoC pods against the CPU, studies on the
default device, and the served and trained models against the CPU.
Each skips (inside the test) on a machine without CUDA; run them on the
card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.accelerator import DramConfig
from repro_torch.core.dram import decode_requests
from repro_torch.kernels.replay import megakernel as mk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _streams(seed, n, dev, *, burst=None, batch=(), t_scale=1.0):
    rng = np.random.default_rng(seed)
    shape = tuple(batch) + (n,)
    t = np.sort(rng.uniform(0, 3.0 * n, shape), axis=-1) * t_scale
    addr = (rng.integers(0, burst, shape) * 64 if burst is not None
            else (rng.integers(0, 1 << 22, shape) // 64) * 64)
    return (torch.tensor(t.astype(np.float32), device=dev),
            torch.tensor(addr, device=dev),
            torch.tensor(rng.random(shape) < 0.3, device=dev),
            torch.tensor(rng.random(shape) < 0.9, device=dev))


# (name, chunk C, DramConfig kwargs, queue-saturating traffic, tol, cap)
_REPLAY_CASES = [
    ("random", 64, {}, False, 0.25, None),
    ("queue_saturation", 64, dict(read_queue=8, write_queue=8), True, 0.25,
     None),
    ("chunk_65", 64, {}, False, 0.25, None),
] + [(f"chunk_c{c}", c, {}, False, 0.25, None)
     for c in (1, 16, 31, 32, 33, 64, 65, 128, 1024)] + [
    # in-flight rings shorter than the chunk: the in-chunk queue heads
    ("small_queue_c64", 64, dict(read_queue=4, write_queue=2), True, 0.25,
     None),
    ("small_queue_c33", 33, dict(read_queue=8, write_queue=8), True, 0.25,
     None),
    ("small_queue_c128", 128, dict(read_queue=16, write_queue=4), True, 0.25,
     None),
] + [(f"tol0_cap{cap}", 64, dict(channels=1, banks_per_channel=1), True,
      0.0, cap) for cap in (1, 2, None)]


@pytest.mark.parametrize("case", [c[0] for c in _REPLAY_CASES])
def test_kernel_matches_plain_version(dev, case):
    _, C, dram, saturate, tol, cap = next(c for c in _REPLAY_CASES
                                          if c[0] == case)
    cfg = DramConfig(**dram)
    n = 65 if case == "chunk_65" else 512
    t, addr, w, v = _streams(1, n, dev, batch=(4,),
                             burst=64 if saturate else None,
                             t_scale=0.01 if saturate else 1.0)
    fb, ch, row = decode_requests(addr, cfg)
    ins = mk.prepare(t, fb, ch, row, w, v, C)
    kw = dict(cfg=cfg, busy=64 / 19.2, C=C, max_passes=cap, tol=tol)
    before = mk.LAUNCHES
    dk, sk, ck = mk.launch_cuda(ins, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES == before + 1
    dp, sp, cp, _ = mk.run_plain(ins, **kw)
    assert torch.equal(ck, cp)
    torch.testing.assert_close(dk, dp, rtol=1e-3, atol=5e-2)
    torch.testing.assert_close(sk, sp, rtol=1e-3, atol=5e-2)


def _merged(seed, n, S, cores, dev, *, saturate):
    """Seeded merged streams of `cores` cores: (t, addr, w, v, cid)."""
    rng = np.random.default_rng(seed)
    shape = (S, n)
    t = np.sort(rng.uniform(0, 3.0 * n, shape), axis=-1)
    if saturate:
        t, addr = t * 0.01, rng.integers(0, 64, shape) * 64
    else:
        addr = (rng.integers(0, 1 << 22, shape) // 64) * 64
    return (torch.tensor(t.astype(np.float32), device=dev),
            torch.tensor(addr, device=dev),
            torch.tensor(rng.random(shape) < 0.3, device=dev),
            torch.tensor(rng.random(shape) < 0.9, device=dev),
            torch.tensor(rng.integers(0, cores, shape).astype(np.int32),
                         device=dev))


# (chunk C, cores, channels = queue groups, queues): both instances
# (C = 32 and 64 in registers, 128 in shared memory), up to the 16 cores
# of the contention path and a private 16-channel case
_MC_CASES = [(C, cores, ch, q) for C in (32, 64, 128) for cores in (2, 4, 16)
             for ch in (1, 2, 4, 16) for q in ((8, 4), (128, 128))]


@pytest.mark.parametrize("C,cores,channels,queues", _MC_CASES)
def test_multicore_kernel_matches_plain_version(dev, C, cores, channels,
                                                queues):
    """The multi-core, per-channel-queue mode against `run_plain` on the
    card: counts exact, done and per-core shift within 1e-3."""
    cfg = DramConfig(channels=channels, read_queue=queues[0],
                     write_queue=queues[1])
    t, addr, w, v, cid = _merged(C + cores * 10 + channels, 400, 4, cores,
                                 dev, saturate=queues == (8, 4))
    fb, ch, row = decode_requests(addr, cfg)
    ins = mk.prepare(t, fb, ch, row, w, v, C, cid)
    kw = dict(cfg=cfg, busy=64 / 19.2, C=C, max_passes=None, tol=0.25,
              n_cores=cores, n_qg=channels)
    before = mk.LAUNCHES
    dk, sk, ck = mk.launch_cuda(ins, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES == before + 1 and sk.shape == (4, cores)
    dp, sp, cp, _ = mk.run_plain(ins, **kw)
    assert torch.equal(ck, cp)
    torch.testing.assert_close(dk, dp, rtol=1e-3, atol=5e-2)
    torch.testing.assert_close(sk, sp, rtol=1e-3, atol=5e-2)


@pytest.mark.parametrize("C", [32, 64, 128, 1024])
def test_multicore_instance_at_one_core_is_the_single_core_one(dev, C):
    """n_cores = n_qg = 1 through the multi-core instance (`grouped`)
    equals the single-core instance bit for bit."""
    for saturate, q in ((True, (8, 4)), (False, (128, 128))):
        cfg = DramConfig(read_queue=q[0], write_queue=q[1])
        t, addr, w, v, cid = _merged(C, 1500, 6, 1, dev, saturate=saturate)
        fb, ch, row = decode_requests(addr, cfg)
        ins = mk.prepare(t, fb, ch, row, w, v, C, cid)
        kw = dict(cfg=cfg, busy=64 / 19.2, C=C, max_passes=None, tol=0.25)
        one = mk.launch_cuda(ins, **kw)
        grouped = mk.launch_cuda(ins, grouped=True, **kw)
        torch.cuda.synchronize()
        for a, b in zip(one, grouped):
            assert torch.equal(a, b), (C, q)


def test_kernel_refuses_modes_beyond_its_limits(dev):
    """The wrapper refuses n_cores and n_qg beyond the kernel's stated
    limits with ValueError; the C entry point refuses them too, with
    cudaErrorInvalidValue, before launching."""
    import ctypes
    cfg = DramConfig(channels=2)
    ins = mk.prepare(torch.zeros((1, 64), device=dev),
                     *(torch.zeros((1, 64), dtype=torch.int32, device=dev)
                       for _ in range(5)), 64)
    kw = dict(cfg=cfg, busy=64 / 19.2, C=64, max_passes=None, tol=0.25)
    for bad in (dict(n_cores=mk.MAX_CORES + 1), dict(n_cores=0),
                dict(n_qg=3)):
        with pytest.raises(ValueError, match="n_cores|n_qg"):
            mk.launch_cuda(ins, **kw, **bad)
    wide = DramConfig(channels=mk.MAX_QUEUE_GROUPS + 1)
    with pytest.raises(ValueError, match="queue groups"):
        mk.launch_cuda(ins, **dict(kw, cfg=wide),
                       n_qg=mk.MAX_QUEUE_GROUPS + 1)
    done = torch.empty((1, 64), device=dev)
    shift = torch.empty((1, 64), device=dev)
    cnt = torch.empty((1, 4), dtype=torch.int32, device=dev)
    launch = mk.build()
    stream = torch.cuda.current_stream().cuda_stream
    for n_cores, n_qg, channels in ((mk.MAX_CORES + 1, 1, 2), (2, 3, 2),
                                    (1, mk.MAX_QUEUE_GROUPS + 1,
                                     mk.MAX_QUEUE_GROUPS + 1)):
        err = launch(*(x.data_ptr() for x in ins), done.data_ptr(),
                     shift.data_ptr(), cnt.data_ptr(), 1, 1, 64, channels,
                     cfg.banks_per_channel, cfg.tRCD, cfg.tRP, cfg.tCAS,
                     cfg.read_queue, cfg.write_queue, n_cores, n_qg, 1, -1,
                     ctypes.c_float(64 / 19.2), ctypes.c_float(0.25), stream)
        assert err == 1, (n_cores, n_qg, err)


def test_contention_on_the_card_matches_the_cpu(dev):
    """`multicore_contention` on the card (two kernel launches) against
    the same call on the CPU, shared and private routing."""
    import repro_torch as rt
    from repro_torch.core.multicore import simulate_multicore_contention
    cfg = rt.get_preset("mcm-4x32", channels=4)
    for private in (False, True):
        before = mk.LAUNCHES
        gpu = simulate_multicore_contention(cfg, 512, 2048, 1024,
                                            private_channels=private,
                                            spec=rt.TraceSpec(cap=1024))
        assert mk.LAUNCHES == before + 2
        cpu = simulate_multicore_contention(cfg, 512, 2048, 1024,
                                            private_channels=private,
                                            spec=rt.TraceSpec(cap=1024),
                                            device="cpu")
        assert (gpu.row_hits, gpu.row_misses, gpu.row_conflicts) == \
            (cpu.row_hits, cpu.row_misses, cpu.row_conflicts)
        np.testing.assert_allclose(gpu.per_core_stall_shared,
                                   cpu.per_core_stall_shared, rtol=1e-3)
        np.testing.assert_allclose(gpu.per_core_stall_isolated,
                                   cpu.per_core_stall_isolated, rtol=1e-3)


def test_study_runs_on_the_card_by_default(dev):
    from repro_torch.api.study import studies
    res = studies.dataflow_dram_flip().run()
    assert res.meta["engine"] == "cuda" and res.claims_ok()


def _stream_args(cfgs, ops, df, dev):
    """The generator's arguments for every design x gemm op, as the
    sweep's `decoded_streams` builds them: (designs, ops) float32."""
    from repro_torch.core.accelerator import MemoryConfig
    from repro_torch.core.stages import traced_comp_traffic
    gem = [o for o in ops if o.kind == "gemm"]
    M, N, K = (torch.tensor([float(getattr(o, k)) for o in gem],
                            device=dev) for k in "MNK")

    def col(vals):
        return torch.tensor(vals, dtype=torch.float32, device=dev)[:, None]

    R = col([c.cores[0].rows for c in cfgs])
    C = col([c.cores[0].cols for c in cfgs])
    mem = MemoryConfig(col([c.memory.ifmap_sram_bytes for c in cfgs]),
                       col([c.memory.filter_sram_bytes for c in cfgs]),
                       col([c.memory.ofmap_sram_bytes for c in cfgs]),
                       l2_sram_bytes=col([0.0] * len(cfgs)), word_bytes=2)
    comp, _, dr, _ = traced_comp_traffic(df, M, N, K, R, C, mem)
    return (M, N, K, R, C, comp, dr["dram_ifmap"], dr["dram_filter"],
            dr["dram_ofmap_writes"], dr["dram_ofmap_reads"])


def _streams_both_ways(df, args, spec, dram):
    """(kernel, sort): the streams kernel and its plain version,
    `gemm_request_stream` + `decode_requests`, on the card, each ((t, fb,
    ch, row, is_write, valid), scale); and the unsorted slots."""
    from repro_torch.kernels.streams import streams as sk
    from repro_torch.trace.generator import (gemm_request_stream,
                                             stream_prologue, stream_slots)
    pro = stream_prologue(df, *args, 2, spec)
    before = sk.LAUNCHES
    kernel = sk.request_streams(pro, dram)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + 1
    t, addr, w, v, scale = gemm_request_stream(df, *args, 2, spec)
    fb, ch, row = decode_requests(addr, dram)
    return kernel, ((t, fb, ch, row, w, v), scale), stream_slots(pro)


def _assert_streams_equal(kernel, sort):
    names = ("t", "flat_bank", "ch", "row", "is_write", "valid")
    for name, k, s in zip(names, kernel[0], sort[0]):
        assert k.dtype == s.dtype and k.shape == s.shape, name
        assert torch.equal(k, s), f"{name}: kernel != sort"
    assert torch.equal(kernel[1], sort[1])


_STREAM_SPECS = {
    "row": dict(layout="row"), "col": dict(layout="col"),
    "tiled": dict(layout="tiled"), "strided": dict(layout="strided"),
    # a tile that is no power of two: PyTorch's floor division by it
    "tiled_24x48": dict(layout="tiled", tile_r=24, tile_c=48),
    "strided_3": dict(layout="strided", stride_elems=3),
}


@pytest.mark.parametrize("cap", [1, 64, 4096, 65536])
@pytest.mark.parametrize("layout", list(_STREAM_SPECS))
@pytest.mark.parametrize("df", ["ws", "os", "is"])
def test_streams_kernel_matches_plain_and_sort(dev, df, layout, cap):
    """The streams kernel's six outputs and scale, bit for bit its plain
    version's, the generator's sort + decode (the per-stream factors
    evaluated on the card, and on the host), over vit_base's and
    resnet18's gemm ops (and one tiny op) on tpu-like designs; the
    batch holds streams with n_model == cap, with reads tied at time 0
    across regions (cap > 1), and (at the larger caps) almost all
    invalid tail."""
    from repro_torch.core.accelerator import tpu_like_config
    from repro_torch.core.workloads import Op, resnet18, vit_base
    from repro_torch.trace.generator import TraceSpec
    cfgs = [tpu_like_config(32, dataflow=df, sram_mb=0.5),
            tpu_like_config(128, dataflow=df, sram_mb=4.0)]
    ops = vit_base() + resnet18() + [Op("tiny", 2, 3, 4)]
    spec = TraceSpec(cap=cap, **_STREAM_SPECS[layout])
    args = _stream_args(cfgs, ops, df, dev)
    kernel, sort, slots = _streams_both_ways(df, args, spec, DramConfig())
    _assert_streams_equal(kernel, sort)
    # the factors evaluated on the host, as the sweep does, then copied
    from repro_torch.kernels.streams import streams as sk
    from repro_torch.trace.generator import stream_prologue
    host = stream_prologue(df, *(a.cpu() for a in args), 2, spec)
    _assert_streams_equal(sk.request_streams(host, DramConfig(), dev), sort)
    valid = kernel[0][5]
    n_valid = valid.sum(-1)
    assert bool((n_valid == cap).any())                  # n_model == cap
    t, _, _, v, region = slots
    tie = (v & (t == 0))
    if cap > 1:                              # ifmap and filter reads at 0
        assert bool(((tie & (region == 0)).any(-1)
                     & (tie & (region == 1)).any(-1)).any())
    if cap >= 4096:
        assert bool((n_valid * 100 < cap).any())         # mostly tail


def test_streams_kernel_on_other_dram_shapes(dev):
    """Another DRAM decode (8 channels, 4 banks, 1 KiB rows, 32-byte
    bursts) and word size 4: the kernel equals the generator's sort +
    decode."""
    from repro_torch.core.accelerator import tpu_like_config
    from repro_torch.core.workloads import resnet18
    from repro_torch.kernels.streams import streams as sk
    from repro_torch.trace.generator import (TraceSpec, gemm_request_stream,
                                             stream_prologue)
    dram = DramConfig(channels=8, banks_per_channel=4, row_bytes=1024,
                      burst_bytes=32)
    cfgs = [tpu_like_config(64, dataflow="ws", sram_mb=1.0)]
    args = _stream_args(cfgs, resnet18(), "ws", dev)
    spec = TraceSpec(cap=8192, gran_bytes=32)
    pro = stream_prologue("ws", *args, 4, spec)
    kernel = sk.request_streams(pro, dram)
    t, addr, w, v, scale = gemm_request_stream("ws", *args, 4, spec)
    sort = ((t,) + decode_requests(addr, dram) + (w, v), scale)
    _assert_streams_equal(kernel, sort)


def test_streams_kernel_refuses_what_it_does_not_take(dev):
    from repro_torch.core.accelerator import tpu_like_config
    from repro_torch.core.workloads import resnet18
    from repro_torch.kernels.streams import streams as sk
    from repro_torch.trace.generator import TraceSpec, stream_prologue
    args = _stream_args([tpu_like_config(32)], resnet18()[:2], "ws", "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        sk.request_streams(stream_prologue("ws", *args, 2, TraceSpec()),
                           DramConfig())
    args = [a.to(dev) for a in args]
    with pytest.raises(ValueError, match="exceeds"):
        sk.request_streams(stream_prologue("ws", *args, 2,
                                           TraceSpec(cap=(1 << 24) + 1)),
                           DramConfig())


def test_trace_study_launches_the_streams_kernel_once_a_group(dev,
                                                              monkeypatch):
    """A trace Study on the card: one streams-kernel launch for each
    `decoded_streams` call, and every cell done."""
    from repro_torch.api import simulator as sim
    from repro_torch.api.study import Study
    from repro_torch.core.accelerator import tpu_like_config
    from repro_torch.core.workloads import resnet18
    from repro_torch.kernels.streams import streams as sk
    from repro_torch.trace.generator import TraceSpec
    calls = []
    orig = sim.decoded_streams

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(sim, "decoded_streams", counted)
    designs = [tpu_like_config(a, dataflow=df, sram_mb=m)
               for a in (32, 128) for df in ("ws", "os", "is")
               for m in (0.5, 4.0)]
    study = (Study("streams").designs(designs)
             .workloads({"resnet18": resnet18()}).fidelity("trace")
             .options(trace_spec=TraceSpec(cap=16384)))
    before = sk.LAUNCHES
    res = study.run(device="cuda")
    assert len(res) == len(designs)
    assert res.meta["engine"] == "cuda"
    assert not np.any(res.columns["cell_status"])
    assert len(calls) >= 3
    assert sk.LAUNCHES - before == len(calls)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 65, 127, 128, 129, 256,
                               257, 1024])
def test_conflict_kernel_matches_plain_version(dev, k):
    """k across every instance boundary: the register widths 32, 64, 128
    and 256 and the shared-memory instance past them; rows with bank ids
    outside [0, num_banks), negative ones included, which count in no
    bank, through every instance that can take k."""
    from repro_torch.kernels.conflict import conflict as ck
    from repro_torch.kernels.conflict import conflict_slowdown_reference
    for ports in (1, 2, 4):
        for banks in (2, 8, 32):
            rng = np.random.default_rng(k * 10 + ports)
            line = rng.integers(0, 11, (300, k))
            bank = rng.integers(0, banks, (300, k))
            j = np.arange(k)
            line[0], bank[0] = j, 0                  # all in one bank
            line[1], bank[1] = j // banks, j % banks  # all pairs distinct
            line[2], bank[2] = 7, banks - 1          # one pair repeated
            line[3], bank[3] = j, banks              # all past the banks
            line[4], bank[4] = j, np.where(j % 2, -1, 0)  # half negative
            bank[5:40] = rng.integers(-3, banks + 3, (35, k))
            lt = torch.tensor(line, dtype=torch.int32, device=dev)
            bt = torch.tensor(bank, dtype=torch.int32, device=dev)
            before = ck.LAUNCHES
            got = ck.conflict_slowdown(lt, bt, num_banks=banks, ports=ports)
            torch.cuda.synchronize()
            assert ck.LAUNCHES == before + 1
            want = conflict_slowdown_reference(lt, bt, num_banks=banks,
                                               ports=ports)
            assert torch.equal(got, want), (k, ports, banks)
            for inst in [w for w in ck.INSTANCES if w == -1 or w >= k]:
                got = ck.conflict_slowdown(lt, bt, num_banks=banks,
                                           ports=ports, instance=inst)
                assert torch.equal(got, want), (k, ports, banks, inst)


def _wide_rows(k, banks, seed, rows=257):
    """Rows of 64-bit keys (lines up to 2^31 - 1, banks up to banks - 1),
    rows of 32-bit keys, and the edge rows of the CPU model's tests."""
    rng = np.random.default_rng(seed)
    top = 2 ** 31 - 1
    line = rng.integers(0, 11, (rows, k))
    bank = rng.integers(0, banks, (rows, k))
    half = rows // 2
    line[:half] = rng.integers(0, top, (half, k), endpoint=True)
    line[half:half + 20] = rng.integers(0, 40, (20, k)) * (top // 40)
    j = np.arange(k)
    line[-1], bank[-1] = top, banks - 1              # one pair, wide
    line[-2], bank[-2] = top - j, banks - 1 - j % 2  # all distinct, wide
    line[-3], bank[-3] = np.where(j % 2, top, 0), banks - 1
    line[-4], bank[-4] = j // banks, j % banks       # distinct, narrow
    return line, bank


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 65, 127, 128, 129, 256,
                               257])
@pytest.mark.parametrize("shifted", [False, True])
def test_conflict_kernel_instances_wide_ids_and_misaligned_rows(dev, k,
                                                                shifted):
    """Every instance that can take k (each register width >= k and shared
    memory) equals the plain version on rows of 64-bit and 32-bit keys,
    num_banks 1,024, lines up to 2^31 - 1; `shifted` puts the ids one
    element into a buffer (data_ptr not 16-byte aligned), which takes the
    element loads, as a k % 4 != 0 row pitch does."""
    from repro_torch.kernels.conflict import conflict as ck
    from repro_torch.kernels.conflict import conflict_slowdown_reference
    banks = 1024
    line, bank = _wide_rows(k, banks, seed=k)

    def ids(a):
        buf = torch.zeros(a.size + 1, dtype=torch.int32, device=dev)
        t = buf[1:] if shifted else buf[:-1]
        t.copy_(torch.tensor(a.reshape(-1), dtype=torch.int32))
        return t.view(a.shape)

    lt, bt = ids(line), ids(bank)
    assert (lt.data_ptr() % 16 != 0) == shifted and lt.is_contiguous()
    widths = [w for w in ck.INSTANCES if w == -1 or w >= k]
    assert ck.instance_for(k) == (widths[0] if k <= 256 else -1)
    for ports in (1, 3):
        want = conflict_slowdown_reference(lt, bt, num_banks=banks,
                                           ports=ports)
        for inst in [0] + widths:
            got = ck.conflict_slowdown(lt, bt, num_banks=banks, ports=ports,
                                       instance=inst)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (k, shifted, ports, inst)


def test_conflict_kernel_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels.conflict import conflict as ck
    x = torch.zeros((4, 33), dtype=torch.int32, device=dev)
    for inst in (32, 7, 512):
        with pytest.raises(ValueError, match="instance"):
            ck.conflict_slowdown(x, x, num_banks=8, instance=inst)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ck.conflict_slowdown(x.cpu(), x.cpu(), num_banks=8)
    with pytest.raises(ValueError, match="int32"):
        ck.conflict_slowdown(x.long(), x.long(), num_banks=8)
    with pytest.raises(ValueError, match="contiguous"):
        ck.conflict_slowdown(x.t(), x.t(), num_banks=8)
    wide = torch.zeros((2, ck.MAX_K + 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared-memory limit"):
        ck.conflict_slowdown(wide, wide, num_banks=8)
    # the C entry point refuses a register instance narrower than k
    launch = ck.build()
    out = torch.empty(4, dtype=torch.int32, device=dev)
    err = launch(x.data_ptr(), x.data_ptr(), out.data_ptr(), 4, 33, 8, 1, 32,
                 torch.cuda.current_stream().cuda_stream)
    assert err == 1                           # cudaErrorInvalidValue


def test_layout_study_runs_on_the_card(dev):
    import repro_torch as rt
    from repro_torch.core.accelerator import LayoutConfig
    from repro_torch.kernels.conflict import conflict as ck
    grid = rt.preset_grid(array=[32, 64], sparsity=[None, "2:4"],
                          cores=[1, 4])
    grid = grid + [c.with_(layout=LayoutConfig(enabled=True)) for c in grid]
    s = rt.Study().designs(grid).workloads("resnet18") \
        .fidelity("fast", "trace")
    before = ck.LAUNCHES
    res = s.run()
    assert res.meta["engine"] == "cuda" and not res.failed_cells
    assert ck.LAUNCHES - before == 4        # one per layout-on group
    cpu = s.run(device="cpu")
    for c in ("total_cycles", "compute_cycles", "stall_cycles", "energy_pj"):
        np.testing.assert_allclose(res[c], cpu[c], rtol=1e-3, err_msg=c)


@pytest.mark.parametrize("T,R,C", [(197, 128, 128), (300, 32, 130),
                                   (1, 128, 128), (0, 8, 8), (65, 17, 1)] + [
    (T, R, C) for T in (1, 196, 197, 300) for R in (1, 3, 127, 128, 129, 300)
    for C in (1, 128, 130)])
@pytest.mark.parametrize("xd,wd", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("float16", "float16"),
                                   ("float32", "bfloat16"),
                                   ("bfloat16", "float16")])
def test_systolic_matmul_kernel_matches_plain_version(dev, T, R, C, xd, wd):
    from repro_torch.kernels.systolic import systolic as sk
    from repro_torch.kernels.systolic.ref import systolic_matmul_reference
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(T * 7 + R)
    x = torch.randn((T, R), generator=g, device=dev).to(getattr(torch, xd))
    w = torch.randn((R, C), generator=g, device=dev).to(getattr(torch, wd))
    before = sk.MATMUL_LAUNCHES
    got = sk.systolic_matmul(x, w)
    torch.cuda.synchronize()
    assert sk.MATMUL_LAUNCHES == before + (1 if T else 0)
    want = systolic_matmul_reference(x, w)
    assert got.dtype == want.dtype == torch.promote_types(x.dtype, w.dtype)
    tol = dict(rtol=1e-5, atol=1e-4) if got.dtype == torch.float32 \
        else dict(rtol=2e-2, atol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", ["x", "w", "both"])
def test_systolic_matmul_kernel_takes_misaligned_operands(dev, dt, offset):
    """Operands whose data_ptr is not 16-byte aligned (contiguous views one
    element into a larger buffer) take the kernel's element-wise loads and
    give the plain version's result."""
    from repro_torch.kernels.systolic import systolic as sk
    from repro_torch.kernels.systolic.ref import systolic_matmul_reference
    torch.backends.cuda.matmul.allow_tf32 = False
    T, R, C = 197, 128, 128
    g = torch.Generator(device=dev).manual_seed(7)
    dtype = getattr(torch, dt)

    def operand(rows, cols, shifted):
        buf = torch.randn(rows * cols + 1, generator=g, device=dev).to(dtype)
        return (buf[1:] if shifted else buf[:-1]).view(rows, cols)

    x = operand(T, R, offset in ("x", "both"))
    w = operand(R, C, offset in ("w", "both"))
    assert (x.data_ptr() % 16 != 0) == (offset in ("x", "both"))
    assert (w.data_ptr() % 16 != 0) == (offset in ("w", "both"))
    got = sk.systolic_matmul(x, w)
    torch.cuda.synchronize()
    want = systolic_matmul_reference(x, w)
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _int_operand(shape, dt, g, dev, lo=None, hi=None):
    info = torch.iinfo(dt)
    return torch.randint(info.min if lo is None else lo,
                         (info.max if hi is None else hi) + 1, shape,
                         generator=g, device=dev, dtype=torch.int64).to(dt)


_INT_PAIRS = [("int8", "int8"), ("uint8", "uint8"), ("int16", "int16"),
              ("int32", "int32"), ("int8", "uint8"), ("uint8", "int16"),
              ("int8", "int32"), ("int16", "int32"), ("int8", "float32"),
              ("float32", "int8"), ("uint8", "bfloat16"),
              ("int16", "float16"), ("int32", "float32")]


@pytest.mark.parametrize("T,R,C", [(197, 128, 128), (1, 3, 1), (65, 17, 130),
                                   (300, 300, 33), (0, 8, 8)])
@pytest.mark.parametrize("xd,wd", _INT_PAIRS,
                         ids=["-".join(p) for p in _INT_PAIRS])
def test_systolic_matmul_kernel_takes_integers(dev, T, R, C, xd, wd):
    """The cast kernel: integer pairs over their full range (sums wrapping
    modulo 2^bits of the promoted type) and integer x float pairs whose
    float operand holds small integers (every partial sum exact in
    float32, so any summation order gives the same bits): equal to the
    plain version bit for bit."""
    from repro_torch.kernels.systolic import systolic as sk
    from repro_torch.kernels.systolic.ref import systolic_matmul_reference
    g = torch.Generator(device=dev).manual_seed(T + R + C)
    ops = []
    for dt, shape in ((getattr(torch, xd), (T, R)),
                      (getattr(torch, wd), (R, C))):
        if dt.is_floating_point:
            ops.append(_int_operand(shape, torch.int32, g, dev, -8, 8)
                       .to(dt))
        elif xd.startswith(("float", "bfloat")) or wd.startswith(
                ("float", "bfloat")):
            ops.append(_int_operand(shape, dt, g, dev,
                                    max(torch.iinfo(dt).min, -120),
                                    min(torch.iinfo(dt).max, 120)))
        else:
            ops.append(_int_operand(shape, dt, g, dev))
    before = sk.MATMUL_LAUNCHES
    got = sk.systolic_matmul(*ops)
    torch.cuda.synchronize()
    assert sk.MATMUL_LAUNCHES == before + (1 if T else 0)
    want = systolic_matmul_reference(*ops)
    assert got.dtype == want.dtype == torch.promote_types(*(o.dtype
                                                          for o in ops))
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt,want", [("int8", 0), ("int32", 19200)])
def test_systolic_matmul_kernel_wraps_int8(dev, dt, want):
    """100 x 3 over 64 rows is 19,200: int8 keeps it modulo 256, as the
    reference does."""
    from repro_torch.kernels.systolic import systolic as sk
    dtype = getattr(torch, dt)
    got = sk.systolic_matmul(torch.full((2, 64), 100, dtype=dtype,
                                        device=dev),
                             torch.full((64, 3), 3, dtype=dtype, device=dev))
    assert torch.equal(got.cpu(), torch.full((2, 3), want, dtype=dtype))


def test_systolic_kernels_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels.ellpack import ellpack as ek
    from repro_torch.kernels.systolic import systolic as sk
    xi = torch.ones((4, 4), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError, match="64-bit"):
        sk.systolic_matmul(xi, xi)
    with pytest.raises(TypeError, match="bool"):
        sk.systolic_matmul(xi.bool(), xi.int())
    with pytest.raises(ValueError, match="CUDA tensor"):
        sk.systolic_matmul(torch.ones(4, 4), torch.ones(4, 4))
    with pytest.raises(TypeError):
        sk.wavefront_activity_batched(torch.ones(3, device=dev), R=4, C=4,
                                      n_cycles=10)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sk.wavefront_activity_batched(torch.ones(3, dtype=torch.int32),
                                      R=4, C=4, n_cycles=10)
    with pytest.raises(TypeError, match="64-bit"):
        ek.ellpack_pack(xi.double(), m=4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ek.ellpack_pack(torch.ones(4, 8), m=4)


@pytest.mark.parametrize("T,C,blocks", [
    (197, 128, 104), (196, 128, 104), (1, 128, 8), (1, 1, 1), (17, 130, 18),
    (2 ** 31 - 1, 2 ** 31 - 1, 2 ** 54)])
def test_systolic_matmul_grid_has_one_block_per_tile(dev, T, C, blocks):
    from repro_torch.kernels.systolic import systolic as sk
    assert sk.matmul_blocks(T, C) == blocks


@pytest.mark.parametrize("Ts,R,C,n_cycles", [
    ([197], 128, 128, 197 + 254), ([1], 128, 128, 300),
    ([16, 32, 64, 100, 0], 8, 8, 78), ([], 8, 8, 10),
    (list(range(1, 400, 7)), 64, 32, 512),
    ([5, 9, 13, -2, 0], 7, 3, 41),           # n_cycles % 4 != 0, T < 0
    ([60_000], 2, 3, 70_001)])                # terms past int32
def test_wavefront_kernel_matches_plain_version(dev, Ts, R, C, n_cycles):
    from repro_torch.kernels.systolic import systolic as sk
    from repro_torch.kernels.systolic.ref import (wavefront_activity_plain,
                                                  wavefront_closed_form)
    t = torch.tensor(Ts, dtype=torch.int32, device=dev)
    before = sk.WAVEFRONT_LAUNCHES
    got = sk.wavefront_activity_batched(t, R=R, C=C, n_cycles=n_cycles)
    torch.cuda.synchronize()
    assert sk.WAVEFRONT_LAUNCHES == before + (1 if Ts else 0)
    want = wavefront_activity_plain(t, R=R, C=C, n_cycles=n_cycles)
    assert torch.equal(got, want)
    assert torch.equal(got, wavefront_closed_form(t, R=R, C=C,
                                                  n_cycles=n_cycles))
    if len(Ts) == 1:
        one = sk.wavefront_activity(Ts[0], R=R, C=C, n_cycles=n_cycles,
                                    device=dev)
        assert torch.equal(one, got[0])


@pytest.mark.parametrize("T", [-3, 0, 1, 197, 60_000])
@pytest.mark.parametrize("n_cycles", [1, 3, 450, 451, 70_002])
def test_wavefront_scalar_entry_matches_batched_and_plain(dev, T, n_cycles):
    """The one-fold entry (T a kernel argument) against the batched entry
    and the plain version; one counted launch each."""
    from repro_torch.kernels.systolic import systolic as sk
    from repro_torch.kernels.systolic.ref import wavefront_activity_plain
    t = torch.tensor([T], dtype=torch.int32, device=dev)
    before = sk.WAVEFRONT_LAUNCHES
    one = sk.wavefront_activity(T, R=128, C=96, n_cycles=n_cycles,
                                device=dev)
    many = sk.wavefront_activity_batched(t, R=128, C=96, n_cycles=n_cycles)
    torch.cuda.synchronize()
    assert sk.WAVEFRONT_LAUNCHES == before + 2
    assert one.shape == (n_cycles,) and one.dtype == torch.int32
    assert torch.equal(one, many[0])
    assert torch.equal(one, wavefront_activity_plain(
        t, R=128, C=96, n_cycles=n_cycles)[0])


def test_wavefront_kernel_unaligned_output_and_launch_floor(dev):
    """An output one element into a buffer takes the scalar stores; the
    empty kernel launches."""
    from repro_torch.kernels.systolic import systolic as sk
    from repro_torch.kernels.systolic.ref import wavefront_activity_plain
    Ts = torch.tensor([3, 50, 17], dtype=torch.int32, device=dev)
    buf = torch.full((3 * 61 + 1,), -7, dtype=torch.int32, device=dev)
    launch = sk.build_wavefront()
    err = launch(Ts.data_ptr(), buf[1:].data_ptr(), 3, 61, 9, 5,
                 torch.cuda.current_stream().cuda_stream)
    assert err == 0
    sk.launch_floor()
    torch.cuda.synchronize()
    assert int(buf[0]) == -7
    assert torch.equal(buf[1:].view(3, 61), wavefront_activity_plain(
        Ts, R=9, C=5, n_cycles=61))
    with pytest.raises(ValueError, match="CUDA device"):
        sk.wavefront_activity(5, R=4, C=4, n_cycles=10, device="cpu")


@pytest.mark.parametrize("rows,K,m,keep,dt", [
    (768, 3072, 4, 0, "float32"), (33, 48, 4, 0, "float32"),
    (64, 64, 8, 0, "bfloat16"), (40, 64, 8, 6, "float16"),
    (16, 32, 4, 3, "float32"), (0, 32, 4, 0, "float32")])
def test_ellpack_kernel_matches_plain_version(dev, rows, K, m, keep, dt):
    from repro_torch.kernels.ellpack import ellpack as ek
    from repro_torch.kernels.ellpack.ref import (ellpack_pack_plain,
                                                 ellpack_pack_reference)
    g = torch.Generator(device=dev).manual_seed(rows + K)
    w = torch.randn((rows, K), generator=g, device=dev)
    w = torch.where(torch.rand((rows, K), generator=g, device=dev) < 0.5, w,
                    0.0).to(getattr(torch, dt))
    if rows:
        w[0] = 1.0                           # blocks with more than keep
    before = ek.LAUNCHES
    got = ek.ellpack_pack(w, m=m, keep=keep)
    torch.cuda.synchronize()
    assert ek.LAUNCHES == before + (1 if rows else 0)
    for want in (ellpack_pack_plain(w, m=m, keep=keep),
                 ellpack_pack_reference(w, m=m, keep=keep)):
        assert got[0].dtype == w.dtype and got[1].dtype == torch.int32
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# (dtype, m, keep, the path of an aligned w)
_ELLPACK_PATHS = [(torch.float32, 4, 2, "vector"),
                  (torch.float32, 8, 4, "vector"),
                  (torch.float32, 16, 4, "vector"),
                  (torch.float32, 2, 1, "vector"),
                  (torch.float32, 16, 2, "vector"),
                  (torch.bfloat16, 4, 2, "vector"),
                  (torch.bfloat16, 8, 4, "vector"),
                  (torch.float16, 16, 4, "vector"),
                  (torch.float16, 8, 1, "vector"),
                  (torch.float32, 4, 3, "scalar"),
                  (torch.bfloat16, 8, 6, "scalar"),
                  (torch.float32, 6, 3, "scalar"),
                  (torch.int32, 4, 2, "vector"),
                  (torch.int16, 8, 4, "vector"),
                  (torch.int32, 8, 3, "scalar"),
                  (torch.int8, 8, 2, "scalar"),
                  (torch.uint8, 4, 2, "scalar")]


@pytest.mark.parametrize("dt,m,keep,path", _ELLPACK_PATHS,
                         ids=[f"{str(c[0])[6:]}-m{c[1]}-k{c[2]}"
                              for c in _ELLPACK_PATHS])
def test_ellpack_kernel_paths_match_plain_version(dev, dt, m, keep, path):
    """The path the kernel takes for an aligned w (`path`) and the scalar
    path it takes for a view one element into its buffer, odd row counts
    (a ragged last warp tile), full, empty and negative-zero blocks: bits
    equal to the plain version's."""
    from repro_torch.kernels.ellpack import ellpack as ek
    from repro_torch.kernels.ellpack.ref import ellpack_pack_plain
    g = torch.Generator(device=dev).manual_seed(m * 10 + keep)
    rows, K = 777, 24 * m
    buf = torch.randn(rows * K + 1, generator=g, device=dev)
    buf = torch.where(torch.rand(rows * K + 1, generator=g, device=dev)
                      < 0.5, buf, 0.0)
    buf = buf.to(dt) if dt.is_floating_point else (buf * 40).to(dt)
    aligned = buf[:-1].view(rows, K)
    aligned[0] = 1
    aligned[1] = 0
    aligned[2, ::2] = -0.0 if dt.is_floating_point else torch.iinfo(dt).min
    offset = buf[1:].view(rows, K)
    bits = {4: torch.int32, 2: torch.int16, 1: torch.int8}[buf.element_size()]
    for w, want_path in ((aligned, path), (offset, "scalar")):
        assert ek.path_for(w, m, keep) == want_path
        got = ek.ellpack_pack(w, m=m, keep=keep)
        torch.cuda.synchronize()
        want = ellpack_pack_plain(w, m=m, keep=keep)
        assert torch.equal(got[1], want[1]), want_path
        assert torch.equal(got[0].view(bits), want[0].view(bits)), want_path


def test_noc_pod_study_on_the_card_matches_the_cpu(dev):
    """`nop_bound(smoke=True)` and a trace-fidelity pod sweep on the card:
    the claims hold, the zero-load pair is bit for bit, the frames agree
    with the CPU's within 1e-3 (NaN only in the NoC columns of the
    NoC-free rows)."""
    import repro_torch as rt
    from repro_torch.api.study import studies
    from repro_torch.noc.topology import noc_kind
    s = studies.nop_bound(smoke=True)
    pods = rt.Study().designs(rt.preset_grid(
        "pod-mesh", pods=[16, 64], link_bw=[4.0, 256.0])) \
        .workloads("resnet18").fidelity("trace")
    for study in (s, pods):
        card, cpu = study.run(), study.run(device="cpu")
        assert card.fraction_batched == 1.0
        kind = dict(study._designs)
        noc_free = np.array([noc_kind(kind[d]) is None
                             for d in card["design"]])
        for c in card.column_names():
            if c in ("design", "workload", "fidelity"):
                continue
            a, b = (np.asarray(r[c], float) for r in (card, cpu))
            nan = (noc_free if c in ("noc_stall_cycles", "noc_link_util",
                                     "allreduce_cycles")
                   else np.zeros(len(a), bool))
            assert np.array_equal(np.isnan(a), nan), c
            assert np.array_equal(np.isnan(b), nan), c
            ok = ~nan
            np.testing.assert_allclose(a[ok], b[ok], rtol=1e-3, err_msg=c)
    res = s.run()
    assert all(res.check_claims().values())
    tot = dict(zip(res["design"], res["total_cycles"]))
    assert tot["noc-zero-load"] == tot["legacy-hops"]


def test_fold_plane_on_the_card_matches_the_cpu(dev):
    from repro_torch.core.energy import instantaneous_power_trace
    from repro_torch.core.accelerator import tpu_like_config
    from repro_torch.kernels.systolic import simulate_fold
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn((197, 128), generator=g), torch.randn((128, 128),
                                                             generator=g)
    cpu = simulate_fold(x, w)
    card = simulate_fold(x.to(dev), w.to(dev))
    assert card.cycles == cpu.cycles
    assert torch.equal(card.active.cpu(), cpu.active)
    assert float(card.utilization) == float(cpu.utilization)
    torch.testing.assert_close(card.out.cpu(), cpu.out, rtol=1e-5, atol=1e-4)
    cfg = tpu_like_config(array=128)
    torch.testing.assert_close(
        instantaneous_power_trace(card.active, cfg).cpu(),
        instantaneous_power_trace(cpu.active, cfg), rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("fid", ["cycle", "trace"])
def test_per_op_engine_on_the_card_matches_the_cpu(dev, fid):
    """Every op of resnet18 (layout on) through the per-op engine on the
    card against the same run on the CPU: fields within 1e-3, row-buffer
    counts exact, one replay and one conflict launch per gemm op."""
    import repro_torch as rt
    from repro_torch.core.accelerator import LayoutConfig
    from repro_torch.core.workloads import resnet18
    from repro_torch.kernels.conflict import conflict as ck
    ops = resnet18()
    n_gemm = sum(o.kind == "gemm" for o in ops)
    sim = rt.Simulator("paper-32", fidelity=fid).with_(
        layout=LayoutConfig(enabled=True))
    assert sim.device.type == "cuda"
    before = (mk.LAUNCHES, ck.LAUNCHES)
    card = sim.run(ops)
    assert (mk.LAUNCHES - before[0], ck.LAUNCHES - before[1]) == \
        (n_gemm, n_gemm)
    assert card.engine == "cuda"
    cpu = rt.Simulator("paper-32", fidelity=fid, device="cpu").with_(
        layout=LayoutConfig(enabled=True)).run(ops)
    for a, b in zip(card.ops, cpu.ops):
        for f in ("compute_cycles", "stall_cycles", "layout_extra_cycles",
                  "total_cycles", "dram_bytes", "energy_pj"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=1e-3, err_msg=(a.name, f))
        for k in ("row_hits", "row_misses", "row_conflicts"):
            assert a.dram_stats[k] == b.dram_stats[k], (a.name, k)


def test_simulator_resolves_to_the_card(dev):
    import repro_torch as rt
    sim = rt.Simulator("paper-32", fidelity="cycle")
    assert sim.device.type == "cuda"
    assert {s.device.type for s in sim.pipeline if hasattr(s, "device")} \
        == {"cuda"}
    assert sim.run("resnet18").engine == "cuda"
    t, a, w = rt.linear_trace(256)
    assert t.is_cuda and a.is_cuda and w.is_cuda


def test_a_kernel_that_fails_to_launch_gives_failed_cells(dev, monkeypatch):
    """The launch wrapper raising (a kernel that does not build or launch)
    fails the cells that reach it: never a frame of numbers, never a
    rerun on the CPU."""
    import repro_torch as rt
    from repro_torch.core.workloads import Op

    def broken(*a, **k):
        raise RuntimeError("replay megakernel launch failed")

    monkeypatch.setattr(mk, "launch_cuda", broken)
    s = (rt.Study().designs({"d": "paper-32"})
         .workloads({"w": [Op("g", 128, 256, 192)]})
         .fidelity("fast", "trace", "cycle"))
    res = s.run()
    assert res.failed_cells == [1, 2]
    assert np.isnan(res["total_cycles"][1:]).all()
    assert np.isfinite(res["total_cycles"][0])


def _farm_kernel_study():
    """Three designs per group, layout stage on, at fast and trace: each
    group one batched call through both kernels."""
    import repro_torch as rt
    from repro_torch.core.workloads import Op
    return (rt.Study("farm-card")
            .designs({f"a{a}": rt.get_preset("table-v-corner", array=a,
                                             layout_banks=16)
                      for a in (32, 64, 128)})
            .workloads({"w": [Op("q", 768, 197, 768),
                              Op("m", 3072, 197, 768)]})
            .fidelity("fast", "trace")
            .options(trace_spec=rt.TraceSpec(cap=1024)))


@pytest.mark.parametrize("max_shard_cells", [1, 2])
def test_farm_worker_on_the_card_equals_the_local_card_run(
        dev, tmp_path, max_shard_cells):
    """Shards of 1 or 2 of a group's 3 designs, run by a worker on the
    card: the frame equals the local card run bit for bit, so no design's
    values depend on which designs share the batched call."""
    from repro_torch.farm import Broker, FarmClient, Worker
    local = _farm_kernel_study().run()
    assert local.meta["engine"] == "cuda"
    root = str(tmp_path / "farm")
    client, broker = FarmClient(root), Broker(
        root, max_shard_cells=max_shard_cells)
    worker = Worker(root, "card")
    assert worker.device.type == "cuda"
    sid = client.submit(_farm_kernel_study())
    broker.step()
    for _ in range(50):
        if client.status(sid).get("state") != "running":
            break
        worker.step()
        broker.step()
    res = client.result(sid, timeout=60)
    assert client.status(sid)["shards_total"] == {1: 6, 2: 4}[
        max_shard_cells]
    assert res.equals(local)
    assert (res.meta["device"], res.meta["engine"]) == ("cuda", "cuda")
    for k in local.columns:
        assert np.array_equal(res[k], local[k]), k


def test_search_on_the_card_has_the_cpu_cohorts(dev, tmp_path):
    import dataclasses

    import repro_torch as rt
    from repro_torch.core.accelerator import CoreConfig
    from repro_torch.core.workloads import Op
    from repro_torch.search import SearchDriver, SearchSpace, choice

    def sram(cfg, kb):
        b = int(kb) * 1024 // 3
        return cfg.with_(memory=dataclasses.replace(
            cfg.memory, ifmap_sram_bytes=b, filter_sram_bytes=b,
            ofmap_sram_bytes=b))

    space = SearchSpace("card-tiny", rt.get_preset("table-v-corner"), [
        choice("array", (16, 32, 64),
               lambda c, v: c.with_(cores=(CoreConfig(rows=v, cols=v),)),
               short="a"),
        choice("sram_kb", (96, 384, 1536), sram, short="s"),
        choice("dataflow", ("ws", "os", "is"),
               lambda c, v: c.with_(dataflow=v), short="")])
    logs = {}
    for device in ("cuda", "cpu"):
        res = SearchDriver(
            space, {"g": [Op("g", 512, 197, 768)]}, seed=0, screen=12,
            eta=4.0, explore_rounds=2, ladder=("fast", "trace"),
            rung_sizes=(3,), cache=str(tmp_path / device),
            device=device).run()
        logs[device] = res.log
        if device == "cuda":
            assert res.frame.meta["engine"] == "cuda"
    for a, b in zip(logs["cuda"].rounds, logs["cpu"].rounds):
        assert (a["cohort"], a["parents"]) == (b["cohort"], b["parents"])
        for m, v in b["best"].items():
            if m not in ("design", "workload", "fidelity"):
                assert a["best"][m] == pytest.approx(v, rel=1e-3), m
    assert len(logs["cuda"].rounds) == len(logs["cpu"].rounds) == 4


# ---- the workload plane: the model zoo and the serve loop -----------------

def _card_and_cpu_models(arch, seed=0):
    """The SMOKE config in float32, the same weights on the CPU and on the
    card (TF32 off: full float32 products)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import params as pm
    from repro_torch.models.transformer import LanguageModel
    from repro_torch.models.zoo import ModelBundle
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype="float32")
    bundle = ModelBundle(cfg)
    tree = pm.init_params(bundle.defs, torch.Generator().manual_seed(seed))
    return bundle, {"cpu": LanguageModel(cfg, tree),
                    "cuda": LanguageModel(cfg, pm.tree_map(
                        lambda t: t.to("cuda"), tree))}


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def _close(a, b, tol=1e-3):
    a, b = a.cpu().double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) < tol


@pytest.mark.parametrize("arch", ["whisper-base", "mixtral-8x7b",
                                  "granite-moe-3b-a800m", "yi-34b",
                                  "qwen2-72b", "qwen2-1.5b", "glm4-9b",
                                  "zamba2-7b", "xlstm-1.3b", "internvl2-1b"])
def test_smoke_model_on_the_card_matches_the_cpu(dev, arch):
    """Prefill, three decode steps and the loss: within 1e-3 of the CPU,
    the same greedy tokens."""
    bundle, models = _card_and_cpu_models(arch)
    cfg = bundle.cfg
    rng = np.random.default_rng(3)
    x = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24))),
         "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))}
    if cfg.family == "audio":
        x["frames"] = torch.randn(2, 24, cfg.d_model,
                                  generator=torch.Generator().manual_seed(4))
    if cfg.family == "vlm":
        x["patches"] = torch.randn(2, cfg.frontend_tokens, cfg.d_model,
                                   generator=torch.Generator().manual_seed(4))
    out = {}
    with torch.inference_mode():
        for d, m in models.items():
            xd = {k: v.to(d) for k, v in x.items()}
            logits, cache = bundle.prefill(
                m, {k: v for k, v in xd.items() if k != "labels"})
            steps = [logits]
            for s in range(3):
                logits, cache = bundle.decode(
                    m, cache, logits.argmax(-1)[:, None], 24 + s)
                steps.append(logits)
            out[d] = (steps, cache, bundle.loss(m, xd))
    for g, c in zip(out["cuda"][0], out["cpu"][0]):
        assert _close(g, c)
        assert torch.equal(g.argmax(-1).cpu(), c.argmax(-1))
    for g, c in zip(_flat(out["cuda"][1]), _flat(out["cpu"][1])):
        assert g.device.type == "cuda" and _close(g, c)
    assert _close(out["cuda"][2], out["cpu"][2])


def test_serve_on_the_card_matches_the_cpu(dev):
    from repro_torch.launch import serve
    bundle, models = _card_and_cpu_models("qwen2-1.5b", seed=1)
    prompts = serve.make_prompts(bundle.cfg, requests=3, prompt_len=20)
    res = {d: serve.serve_requests(m, prompts, batch=2, gen_len=6)
           for d, m in models.items()}
    assert res["cuda"].logits_finite and res["cuda"].done == 3
    for g, c in zip(res["cuda"].waves, res["cpu"].waves):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), c)


def test_serve_entry_point_runs_on_the_card_by_default(dev, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--smoke", "--requests", "2", "--batch", "2",
                       "--prompt-len", "8", "--gen-len", "3"]) == 0
    assert "on cuda" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m",
                                  "zamba2-7b", "whisper-base"])
def test_train_step_on_the_card_matches_the_cpu(dev, arch):
    """One train step from the same float32 weights: loss, gradient norm
    and moments within 1e-3 of the CPU's, the updated parameters within
    1e-3 wherever the CPU's gradient is at least 100 x AdamW's eps (see
    `tests/test_torch_train.py`), within 2 lr elsewhere."""
    from repro_torch.models.zoo import params_tree
    bundle, models = _card_and_cpu_models(arch, seed=2)
    cfg = bundle.cfg
    rng = np.random.default_rng(5)
    x = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24))),
         "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))}
    if cfg.family == "audio":
        x["frames"] = torch.randn(2, 24, cfg.d_model,
                                  generator=torch.Generator().manual_seed(6))
    out = {}
    for d, m in models.items():
        _, opt, met = bundle.train_step(lr=1e-2)(
            m, bundle.opt_init(m), {k: v.to(d) for k, v in x.items()})
        out[d] = (met, opt, params_tree(m))
    (gm, go, gp), (cm, co, cp) = out["cuda"], out["cpu"]
    assert go.step.device.type == "cuda"
    assert _close(gm["loss"], cm["loss"]) and _close(gm["grad_norm"],
                                                     cm["grad_norm"])
    for tree_g, tree_c in ((go.m, co.m), (go.v, co.v)):
        for g, c in zip(_flat(tree_g), _flat(tree_c)):
            assert g.device.type == "cuda" and _close(g, c)
    for g, c, m in zip(_flat(gp), _flat(cp), _flat(co.m)):
        err = (g.cpu().double() - c.double()).abs()
        sure = m.double().abs() / 0.1 >= 1e-6
        if sure.any():
            assert float(err[sure].max()) <= 1e-3 * float(c.abs().max())
        if (~sure).any():
            assert float(err[~sure].max()) <= 2 * 1e-2


def test_train_entry_point_runs_on_the_card_by_default(dev, capsys,
                                                       tmp_path):
    from repro_torch.launch import train
    assert train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq",
                       "16", "--ckpt-dir", str(tmp_path)]) == 0
    assert "done. " in capsys.readouterr().out


def test_checkpoint_restores_onto_the_card(dev, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    tree = {"w": torch.arange(6, dtype=torch.bfloat16),
            "s": torch.tensor(3, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=True)
    got = mgr.restore(tree, device="cuda")
    assert got["w"].device.type == "cuda" and got["s"].shape == ()
    assert torch.equal(got["w"].cpu(), tree["w"])
    like = {k: v.to("cuda") for k, v in tree.items()}
    assert mgr.restore(like)["s"].device.type == "cuda"


def test_sharded_world_of_one_on_the_card_equals_one_device(dev, tmp_path):
    """An NCCL world of one process, a 1 x 1 mesh: the sharded train step,
    prefill and decode of qwen2-1.5b's SMOKE config (bfloat16) equal the
    single-device ones bit for bit (a size-1 axis takes the single-device
    code paths and moves nothing), under deterministic algorithms (the
    embedding's backward otherwise adds with atomics in no fixed order)."""
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_mesh_ctx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.zoo import ModelBundle, params_tree
    bundle = ModelBundle(get_config("qwen2-1.5b", smoke=True))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 512, (2, 32))).to(dev)
    batch = {"tokens": x, "labels": x.roll(1, 1)}
    mesh = make_host_mesh(1, backend="nccl", rank=0, world_size=1,
                          init_method="file://" + str(tmp_path / "store"))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ctx = make_mesh_ctx(mesh)
        out = {}
        for name, c in (("one", None), ("mesh", ctx)):
            model = bundle.init(torch.Generator(device=dev).manual_seed(0), c)
            opt = bundle.opt_init(model)
            _, opt, m = bundle.train_step(c, lr=1e-3)(model, opt, batch)
            logits, cache = bundle.prefill_step(c)(model, {"tokens": x})
            nxt, _ = bundle.decode_step(c)(model, cache, x[:, :1], 31)
            out[name] = (m, params_tree(model), logits, nxt)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    (m1, p1, l1, n1), (m2, p2, l2, n2) = out["one"], out["mesh"]
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    for (n, a), (_, b) in zip(flatten_with_paths(p1), flatten_with_paths(p2)):
        assert a.device.type == "cuda" and torch.equal(a, b), n
    assert torch.equal(l1, l2) and torch.equal(n1, n2)


# ---- several cards: the kernels off card 0, the sweep over a device mesh --

@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs at least 2 CUDA devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.parametrize("kernel", ["replay", "conflict", "matmul",
                                    "wavefront", "ellpack", "streams"])
def test_kernel_on_the_last_card_matches_plain_version(cards, kernel):
    """Each kernel launched on the last card while card 0 is the current
    device: the wrapper makes the tensors' card current for the launch
    (and the kernels' shared-memory attribute is set there), the result
    lies on that card and equals the plain version's."""
    from repro_torch.kernels.conflict import conflict as ck
    from repro_torch.kernels.conflict import conflict_slowdown_reference
    from repro_torch.kernels.ellpack import ellpack as ek
    from repro_torch.kernels.ellpack.ref import ellpack_pack_plain
    from repro_torch.kernels.systolic import systolic as sk
    from repro_torch.kernels.systolic.ref import (systolic_matmul_reference,
                                                  wavefront_activity_plain)
    last = cards[-1]
    torch.cuda.set_device(cards[0])
    g = torch.Generator(device=last).manual_seed(3)
    if kernel == "replay":
        cfg = DramConfig()
        t, addr, w, v = _streams(5, 512, last, batch=(4,))
        fb, ch, row = decode_requests(addr, cfg)
        # a chunk of 128 takes the shared-memory instance
        ins = mk.prepare(t, fb, ch, row, w, v, 128)
        kw = dict(cfg=cfg, busy=64 / 19.2, C=128, max_passes=None, tol=0.25)
        before = mk.LAUNCHES_BY_CARD[last.index]
        got = mk.launch_cuda(ins, **kw)
        assert mk.LAUNCHES_BY_CARD[last.index] == before + 1
        want = mk.run_plain(ins, **kw)[:3]
        assert torch.equal(got[2], want[2])
        for a, b in zip(got[:2], want[:2]):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=5e-2)
    elif kernel == "conflict":
        # k = 2,048: the shared-memory instance, past the 48 KB a block
        # takes without the attribute
        line = torch.randint(0, 11, (64, 2048), generator=g, device=last,
                             dtype=torch.int32)
        bank = torch.randint(-2, 34, (64, 2048), generator=g, device=last,
                             dtype=torch.int32)
        before = ck.LAUNCHES_BY_CARD[last.index]
        got = ck.conflict_slowdown(line, bank, num_banks=32, ports=2)
        assert ck.LAUNCHES_BY_CARD[last.index] == before + 1
        want = conflict_slowdown_reference(line, bank, num_banks=32, ports=2)
        got = (got,)
        want = (want,)
    elif kernel == "matmul":
        x = torch.randn((197, 128), generator=g, device=last)
        w = torch.randn((128, 128), generator=g, device=last)
        got = sk.systolic_matmul(x, w)
        torch.testing.assert_close(got, systolic_matmul_reference(x, w),
                                   rtol=1e-5, atol=1e-4)
        got = want = (got,)
    elif kernel == "wavefront":
        ts = torch.tensor([1, 197, 300], dtype=torch.int32, device=last)
        got = (sk.wavefront_activity_batched(ts, R=128, C=128,
                                             n_cycles=700),)
        want = (wavefront_activity_plain(ts, R=128, C=128, n_cycles=700),)
    elif kernel == "streams":
        from repro_torch.core.accelerator import tpu_like_config
        from repro_torch.core.workloads import resnet18
        from repro_torch.kernels.streams import streams as stk
        from repro_torch.trace.generator import (TraceSpec,
                                                 gemm_request_stream,
                                                 stream_prologue)
        args = _stream_args([tpu_like_config(64)], resnet18(), "ws", last)
        spec = TraceSpec(cap=4096)
        pro = stream_prologue("ws", *args, 2, spec)
        before = stk.LAUNCHES_BY_CARD[last.index]
        got, _ = stk.request_streams(pro, DramConfig())
        assert stk.LAUNCHES_BY_CARD[last.index] == before + 1
        t, addr, w, v, _ = gemm_request_stream("ws", *args, 2, spec)
        want = (t,) + decode_requests(addr, DramConfig()) + (w, v)
    else:
        w = torch.randn((768, 3072), generator=g, device=last)
        got = ek.ellpack_pack(w, m=4, keep=2)
        want = ellpack_pack_plain(w, m=4, keep=2)
    torch.cuda.synchronize(last)
    for a, b in zip(got, want):
        assert a.device == last
        if kernel != "replay":
            assert torch.equal(a, b)


def test_mesh_sweep_over_all_cards_equals_one_card(cards):
    """The study over a mesh of every card: one block of each group's
    designs a card (padded with copies of the last design), every card
    launching the replay, conflict and streams kernels, the frame one
    card's bit for bit."""
    from repro_torch.kernels.conflict import conflict as ck
    from repro_torch.kernels.streams import streams as stk
    from repro_torch.launch.mesh import make_device_mesh
    one = _farm_kernel_study().run(device=cards[0])
    mk.LAUNCHES_BY_CARD.clear()
    ck.LAUNCHES_BY_CARD.clear()
    stk.LAUNCHES_BY_CARD.clear()
    mesh = make_device_mesh()
    assert mesh.devices == tuple(cards)
    res = _farm_kernel_study().run(mesh=mesh)
    assert res.meta["engine"] == "cuda"
    assert res.equals(one)
    for c in cards:
        assert mk.LAUNCHES_BY_CARD[c.index] >= 1, dict(mk.LAUNCHES_BY_CARD)
        assert ck.LAUNCHES_BY_CARD[c.index] >= 1, dict(ck.LAUNCHES_BY_CARD)
        assert stk.LAUNCHES_BY_CARD[c.index] >= 1, dict(
            stk.LAUNCHES_BY_CARD)
    with pytest.raises(ValueError, match="not one of the mesh's"):
        _farm_kernel_study().run(mesh=make_device_mesh([str(cards[-1])]),
                                 device=cards[0])
