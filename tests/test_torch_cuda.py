"""Tests of the port that need an NVIDIA card: the CUDA replay and
bank-conflict kernels against their plain PyTorch versions, and studies on
the default device.
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


@pytest.mark.parametrize("case", ["random", "queue_saturation", "chunk_65"])
def test_kernel_matches_plain_version(dev, case):
    cfg = DramConfig(read_queue=8, write_queue=8) \
        if case == "queue_saturation" else DramConfig()
    n = 65 if case == "chunk_65" else 512
    t, addr, w, v = _streams(1, n, dev, batch=(4,),
                             burst=64 if case == "queue_saturation" else None,
                             t_scale=0.01 if case == "queue_saturation"
                             else 1.0)
    fb, ch, row = decode_requests(addr, cfg)
    ins = mk.prepare(t, fb, ch, row, w, v, 64)
    kw = dict(cfg=cfg, busy=64 / 19.2, C=64, max_passes=None, tol=0.25)
    before = mk.LAUNCHES
    dk, sk, ck = mk.launch_cuda(ins, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES == before + 1
    dp, sp, cp, _ = mk.run_plain(ins, **kw)
    assert torch.equal(ck, cp)
    torch.testing.assert_close(dk, dp, rtol=1e-3, atol=5e-2)
    torch.testing.assert_close(sk, sp, rtol=1e-3, atol=5e-2)


def test_study_runs_on_the_card_by_default(dev):
    from repro_torch.api.study import studies
    res = studies.dataflow_dram_flip().run()
    assert res.meta["engine"] == "cuda" and res.claims_ok()


@pytest.mark.parametrize("k", [1, 31, 32, 33, 128])
def test_conflict_kernel_matches_plain_version(dev, k):
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
            lt = torch.tensor(line, dtype=torch.int32, device=dev)
            bt = torch.tensor(bank, dtype=torch.int32, device=dev)
            before = ck.LAUNCHES
            got = ck.conflict_slowdown(lt, bt, num_banks=banks, ports=ports)
            torch.cuda.synchronize()
            assert ck.LAUNCHES == before + 1
            want = conflict_slowdown_reference(lt, bt, num_banks=banks,
                                               ports=ports)
            assert torch.equal(got, want), (k, ports, banks)


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
