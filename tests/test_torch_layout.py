"""The PyTorch port's layout stage on the CPU against the JAX reference: the
bank-conflict kernel's plain version equals the Pallas kernel (interpret
mode) and its jnp reference exactly, on the reference's own cases and on
adversarial rows; so does a plain model of the CUDA kernel's register
formulation (packed keys, a bitonic sort, run counts by scans); the
streaming layout model and `evaluate_layout` match within 1e-6 relative.
The CUDA kernel itself is held against the plain version on the card
(`test_torch_cuda.py`, `chip_smoke.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as rlay
from repro.core.accelerator import LayoutConfig as RLayoutConfig
from repro.kernels.conflict import conflict_slowdown as r_pallas
from repro.kernels.conflict import conflict_slowdown_reference as r_ref
from repro.kernels.conflict import layout_slowdown as r_layout_slowdown
from repro_torch.core import layout as tlay
from repro_torch.core.accelerator import LayoutConfig
from repro_torch.kernels.conflict import (conflict_slowdown,
                                          conflict_slowdown_reference,
                                          layout_slowdown,
                                          per_cycle_slowdown)


def _ids(seed, cycles, k, banks, lines=11):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, lines, (cycles, k)).astype(np.int32),
            rng.integers(0, banks, (cycles, k)).astype(np.int32))


def _adversarial(k, banks, seed=0):
    """Random rows plus an all-same-bank row (k distinct lines in bank 0),
    an all-distinct row (every (bank, line) pair different), a row of one
    repeated pair, and a row cycling through every bank on one line."""
    line, bank = _ids(seed, 12, k, banks)
    j = np.arange(k, dtype=np.int32)
    extra_l = np.stack([j, j, np.full(k, 7, np.int32), np.zeros(k, np.int32)])
    extra_b = np.stack([np.zeros(k, np.int32), j % banks,
                        np.full(k, banks - 1, np.int32), j % banks])
    # all-distinct: line j // banks, bank j % banks never repeats a pair
    extra_l[1] = j // banks
    return (np.concatenate([line, extra_l]), np.concatenate([bank, extra_b]))


def _port(line, bank, banks, ports):
    return conflict_slowdown_reference(
        torch.from_numpy(line), torch.from_numpy(bank), num_banks=banks,
        ports=ports).numpy()


@pytest.mark.parametrize("cycles,k,banks,ports", [
    (64, 16, 8, 1), (96, 48, 16, 2), (128, 24, 4, 1), (32, 64, 32, 4)])
def test_plain_version_equals_pallas_kernel_reference_cases(cycles, k, banks,
                                                            ports):
    """The cases of the reference's kernel tests (`test_kernels.py`,
    `test_layout.py`)."""
    line, bank = _ids(cycles + k, cycles, k, banks)
    want = np.asarray(r_pallas(jnp.asarray(line), jnp.asarray(bank),
                               num_banks=banks, ports=ports, interpret=True))
    got = _port(line, bank, banks, ports)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(r_ref(jnp.asarray(line), jnp.asarray(bank),
                              num_banks=banks, ports=ports)))


@pytest.mark.parametrize("k", [1, 31, 32, 33, 128])
def test_plain_version_equals_pallas_kernel_adversarial(k):
    """k across the warp width and the layout stage's 128, every
    ports x banks pair, adversarial rows: exact against the interpret-mode
    Pallas kernel and its jnp reference."""
    for ports in (1, 2, 4):
        for banks in (2, 8, 32):
            line, bank = _adversarial(k, banks, seed=k * 10 + ports)
            got = _port(line, bank, banks, ports)
            jl, jb = jnp.asarray(line), jnp.asarray(bank)
            np.testing.assert_array_equal(
                got, np.asarray(r_ref(jl, jb, num_banks=banks, ports=ports)),
                err_msg=f"k={k} ports={ports} banks={banks}")
            np.testing.assert_array_equal(
                got, np.asarray(r_pallas(jl, jb, num_banks=banks,
                                         ports=ports, interpret=True)),
                err_msg=f"k={k} ports={ports} banks={banks}")


def _register_model(line, bank, ports, num_banks=None):
    """The CUDA kernel's register instances in plain PyTorch, on (rows, k)
    int32 ids with 1 <= k <= 256: with `num_banks`, an id whose bank lies
    outside [0, num_banks) first becomes the pair (num_banks, 0); rows
    padded to K = 32 E with element 0's key; per row, 32-bit keys bank << lbits | line when the ids are
    non-negative and fit in 31 bits together, else 64-bit keys with the
    bank in the high word; the kernel's one-direction bitonic network on
    the element index (its in-lane and shuffle steps are the same
    compare-exchanges, whichever lane holds an element);
    firsts where a key differs from its predecessor; P their inclusive
    count, M the max-scan of P at bank-run starts; slowdown max(1,
    ceil(max (P - M + 1) / ports)). Returns (slowdowns, rows that took
    32-bit keys)."""
    line = torch.as_tensor(line, dtype=torch.int32).to(torch.int64)
    bank = torch.as_tensor(bank, dtype=torch.int32).to(torch.int64)
    if num_banks is not None:
        out = (bank < 0) | (bank >= num_banks)
        line = torch.where(out, 0, line)
        bank = torch.where(out, num_banks, bank)
    rows, k = line.shape
    K = 32
    while K < k:
        K *= 2
    assert K <= 256
    pad = torch.arange(K) >= k
    idx = torch.where(pad, 0, torch.arange(K).clamp_max(k - 1))
    line, bank = line[:, idx], bank[:, idx]
    lbits = torch.tensor([int(v).bit_length() for v in
                          (line[:, :k] & 0xFFFFFFFF).max(1).values])
    bbits = torch.tensor([int(v).bit_length() for v in
                          (bank[:, :k] & 0xFFFFFFFF).max(1).values])
    narrow = lbits + bbits <= 31
    shift = torch.where(narrow, lbits, 32)[:, None]
    key = ((bank & 0xFFFFFFFF) << shift) | (line & 0xFFFFFFFF)
    i = torch.arange(K)
    s = 2
    while s <= K:
        # the mirror i ^ (s - 1), then i ^ j for j = s / 4 .. 1; the
        # smaller key goes to the lower index
        steps, j = [(i ^ (s - 1), s // 2)], s // 4
        while j:
            steps.append((i ^ j, j))
            j //= 2
        for partner, low_bit in steps:
            p = key[:, partner]
            key = torch.where((i & low_bit) == 0, torch.minimum(key, p),
                              torch.maximum(key, p))
        s *= 2
    assert bool((key[:, 1:] >= key[:, :-1]).all())
    prev = torch.cat([key[:, :1] - 1, key[:, :-1]], 1)
    b, pb = key >> shift, prev >> shift
    b[:, 0], pb[:, 0] = 0, -1                      # element 0 starts a run
    P = torch.cumsum((key != prev).to(torch.int64), 1)
    M = torch.cummax(torch.where(b != pb, P, 0), 1).values
    worst = (P - M + 1).max(1).values
    return (torch.clamp_min(-(-worst // ports), 1).to(torch.int32).numpy(),
            narrow.numpy())


def _register_rows(k, banks, seed):
    """Random rows, then: lines at 0 and 2^31 - 1, a bank at banks - 1,
    an all-equal row, an all-distinct row (in one bank and spread),
    and random lines up to 2^31 - 1 (64-bit keys)."""
    rng = np.random.default_rng(seed)
    line = rng.integers(0, 11, (14, k))
    bank = rng.integers(0, banks, (14, k))
    j = np.arange(k)
    top = 2 ** 31 - 1
    line[0], bank[0] = np.where(j % 2, top, 0), banks - 1
    line[1], bank[1] = 0, 0                              # all equal
    line[2], bank[2] = top, banks - 1                    # all equal, wide
    line[3], bank[3] = j, 0                              # distinct, one bank
    line[4], bank[4] = j // banks, j % banks             # distinct, spread
    line[5], bank[5] = top - j, banks - 1 - j % 2        # distinct, wide
    line[6] = rng.integers(0, top, k, endpoint=True)     # wide random
    line[7], bank[7] = line[6], banks - 1
    line[8] = np.where(j % 3 == 0, top, line[8])
    return line.astype(np.int32), bank.astype(np.int32)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 65, 128, 129, 256])
def test_register_formulation_equals_pallas_kernel(k):
    """The packed-key sort and the sorted-run counts give the interpret-mode
    Pallas kernel's and the plain version's slowdown exactly, for ports
    1-4, with both key widths reached."""
    banks = 1024
    line, bank = _register_rows(k, banks, seed=k)
    narrow_seen = set()
    for ports in (1, 2, 3, 4):
        got, narrow = _register_model(line, bank, ports)
        narrow_seen.update(narrow.tolist())
        want = np.asarray(r_pallas(jnp.asarray(line), jnp.asarray(bank),
                                   num_banks=banks, ports=ports,
                                   interpret=True))
        np.testing.assert_array_equal(got, want, err_msg=f"ports={ports}")
        np.testing.assert_array_equal(got, _port(line, bank, banks, ports),
                                      err_msg=f"ports={ports}")
    assert narrow_seen == {True, False}


def test_plain_version_known_rows():
    k, banks = 8, 4
    line, bank = _adversarial(k, banks)
    got = _port(line, bank, banks, 1)
    assert got[-4] == k                 # k distinct lines in one bank
    assert got[-3] == k // banks        # every pair distinct, spread evenly
    assert got[-2] == 1                 # one pair repeated
    assert got[-1] == 1                 # one line across every bank
    assert list(_port(line[-4:-3], bank[-4:-3], banks, 2)) == [k // 2]


def test_plain_version_int64_key_past_int32():
    """Line ids up to 2^28 with 32 banks: the composite key bank *
    (max(line) + 1) + line passes int32, which the int64 key keeps exact
    (checked against a direct count)."""
    rng = np.random.default_rng(5)
    line = rng.integers(0, 1 << 28, (40, 64))
    line[:, 32:] = line[:, :32]                      # repeated pairs
    bank = rng.integers(0, 32, (40, 64))
    bank[:, 32:] = bank[:, :32]
    got = conflict_slowdown_reference(torch.from_numpy(line),
                                      torch.from_numpy(bank), num_banks=32,
                                      ports=2).numpy()
    want = []
    for lr, br in zip(line, bank):
        pairs = set(zip(br.tolist(), lr.tolist()))
        per_bank = np.bincount([b for b, _ in pairs], minlength=32)
        want.append(max(1, int(-(-per_bank.max() // 2))))
    np.testing.assert_array_equal(got, want)


def test_dispatch_runs_the_plain_version_on_the_cpu():
    from repro_torch.kernels.conflict import conflict as ck
    line, bank = _ids(3, 20, 16, 8)
    before = ck.LAUNCHES
    got = per_cycle_slowdown(torch.from_numpy(line), torch.from_numpy(bank),
                             num_banks=8, ports=1)
    assert ck.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), _port(line, bank, 8, 1))
    # the CUDA wrapper takes CUDA tensors only: it never runs on the CPU
    with pytest.raises(ValueError, match="CUDA tensor"):
        conflict_slowdown(torch.from_numpy(line), torch.from_numpy(bank),
                          num_banks=8)


def test_id_maps_match_reference():
    cfg, rcfg = (LayoutConfig(enabled=True, c1_step=8, h1_step=2, w1_step=4,
                              num_banks=8, line_bytes=16),
                 RLayoutConfig(enabled=True, c1_step=8, h1_step=2, w1_step=4,
                               num_banks=8, line_bytes=16))
    c, h, w = np.meshgrid(np.arange(16), np.arange(8), np.arange(8),
                          indexing="ij")
    for a, b in zip(tlay.chw_ids(torch.from_numpy(c), torch.from_numpy(h),
                                 torch.from_numpy(w), 8, 8, cfg),
                    rlay.chw_ids(jnp.asarray(c), jnp.asarray(h),
                                 jnp.asarray(w), 8, 8, rcfg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idx = np.arange(0, 200_000, 37)
    for a, b in zip(tlay.flat_ids(torch.from_numpy(idx), cfg, 2),
                    rlay.flat_ids(jnp.asarray(idx), rcfg, 2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("R,n_cycles,lead,elem", [(32, 128, 1, 197),
                                                  (8, 5, 3, 151_936)])
def test_streaming_access_pattern_matches_reference(R, n_cycles, lead, elem):
    """On the CPU when asked (the default is the card)."""
    got = tlay.streaming_access_pattern(R, n_cycles, lead, elem,
                                        device="cpu")
    want = rlay.streaming_access_pattern(R, n_cycles, lead, elem)
    assert got.shape == (n_cycles, R) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("banks,R,stride", [(2, 32, 197), (16, 32, 197),
                                            (32, 128, 1), (32, 64, 768)])
def test_evaluate_layout_and_layout_slowdown_match(banks, R, stride):
    kw = dict(num_banks=banks, line_bytes=max(2, 512 // banks))
    cfg, rcfg = (LayoutConfig(enabled=True, **kw),
                 RLayoutConfig(enabled=True, **kw))
    got = tlay.evaluate_layout(cfg, R=R, n_cycles=128, lead_stride=1,
                               elem_stride=stride, device="cpu")
    want = rlay.evaluate_layout(rcfg, R=R, n_cycles=128, lead_stride=1,
                                elem_stride=stride)
    for f in ("mean_slowdown", "max_slowdown", "extra_cycles"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, err_msg=f)
    sd = layout_slowdown(cfg, R=R, n_cycles=96, lead_stride=1,
                         elem_stride=stride, device="cpu")
    rsd = r_layout_slowdown(rcfg, R=R, n_cycles=96, lead_stride=1,
                            elem_stride=stride, interpret=True)
    np.testing.assert_array_equal(sd.numpy(), np.asarray(rsd))


@pytest.mark.parametrize("banks,ports,word", [(32, 1, 2), (8, 2, 2),
                                              (16, 1, 4)])
def test_streaming_layout_extra_matches(banks, ports, word):
    """The batched layout model (designs x ops, one call) against the
    reference's scalar model per (design, op), including a 151k-element
    stride (an LM vocabulary) and windows shorter than 8 cycles, exactly
    512, and longer."""
    cfg = LayoutConfig(enabled=True, num_banks=banks, ports_per_bank=ports)
    rcfg = RLayoutConfig(enabled=True, num_banks=banks, ports_per_bank=ports)
    R = np.array([[8.0], [32.0], [128.0], [64.0]], np.float32)
    N = np.array([1.0, 7.0, 197.0, 768.0, 3072.0, 151_936.0], np.float32)
    rng = np.random.default_rng(banks)
    comp = rng.choice([3.0, 8.0, 100.5, 511.0, 512.0, 4096.0, 1e7],
                      (4, 6)).astype(np.float32)
    stride = np.maximum(N, 1.0)
    got = tlay.streaming_layout_extra(
        cfg, torch.from_numpy(R), torch.from_numpy(comp),
        torch.from_numpy(stride), word, r_cap=128).numpy()
    assert got.shape == (4, 6)
    for i in range(4):
        for j in range(6):
            want = float(rlay.streaming_layout_extra(
                rcfg, jnp.float32(R[i, 0]), jnp.float32(comp[i, j]),
                jnp.float32(stride[j]), word, r_cap=128))
            np.testing.assert_allclose(got[i, j], want, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{i},{j}")
    assert (got >= 0).all() and (got > 0).any()
    # a scalar call, r_cap taken from R
    one = tlay.streaming_layout_extra(cfg, torch.tensor(32.0),
                                      torch.tensor(300.0),
                                      torch.tensor(197.0), word)
    want = rlay.streaming_layout_extra(rcfg, 32, jnp.float32(300.0),
                                       jnp.float32(197.0), word)
    np.testing.assert_allclose(float(one), float(want), rtol=1e-6)
