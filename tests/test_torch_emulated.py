"""The CUDA sources of the replay, bank-conflict and ELLPACK kernels,
compiled with the host C++ compiler against `tools/cuda_emulator.h` and
run on the CPU, against their plain PyTorch versions.

The emulator runs every lane as a thread and every warp intrinsic as an
exchange between barriers, so the kernels' own code paths (the single-
and multi-core replay instances in registers and in shared memory, every
conflict instance, both ELLPACK paths) run here, slowly, on small
inputs. It does not model
timing, memory ordering beyond the warp, or the card's float rounding of
fused operations; the kernels are held against the same plain versions
on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`. Each test
skips when no C++20 compiler is found.

Tolerances as on the card: counts, slowdowns and ELLPACK values and
indices exact, completions and shifts within 1e-3 relative.
"""
import ctypes
import hashlib
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core.accelerator import DramConfig
from repro_torch.core.dram import decode_requests
from repro_torch.kernels.conflict import conflict as ck
from repro_torch.kernels.conflict import conflict_slowdown_reference
from repro_torch.kernels.ellpack import ellpack as ek
from repro_torch.kernels.ellpack.ref import ellpack_pack_plain
from repro_torch.kernels.replay import megakernel as mk

ROOT = pathlib.Path(__file__).resolve().parents[1]
HEADER = ROOT / "tools" / "cuda_emulator.h"
BUILD = ROOT / "build" / "emulated"


def _host_source(src: str) -> str:
    """What a host compiler cannot take, rewritten: `cp.async` as a plain
    4-byte copy, its commit and wait as nothing, `extern __shared__`
    arrays as the emulator's buffer, `<<<...>>>` as `mock_launch`."""
    src = src.replace("#include <cuda_runtime.h>",
                      f'#include "{HEADER}"')
    src = re.sub(r'(void cp_async4\(void\* dst, const void\* src\) \{).*?'
                 r'\n\}', r'\1\n  std::memcpy(dst, src, 4);\n}', src,
                 flags=re.S)
    src = re.sub(r'asm volatile\("cp\.async\.(commit_group|wait_group 1);'
                 r'\\n"[^;]*;', ";", src)
    src = re.sub(r'extern __shared__ (?:__align__\(16\) )?([\w ]+?) '
                 r'smem\[\];', r'\1* smem = reinterpret_cast<\1*>(mock_smem);',
                 src)
    src = re.sub(r'(\w+(?:<[^<>;]*>)?)<<<([^>]*)>>>\(', r'mock_launch(\1, \2, ',
                 src)
    if "asm" in src:
        raise AssertionError("inline assembly left in the emulated source")
    return src


@pytest.fixture(scope="module")
def emulated():
    """name -> ctypes library of that csrc kernel, built for the CPU."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    libs = {}

    def load(name):
        if name not in libs:
            src = _host_source((ROOT / "src" / "repro_torch" / "csrc"
                                / f"{name}.cu").read_text())
            tag = hashlib.sha256(
                (src + HEADER.read_text()).encode()).hexdigest()[:16]
            so = BUILD / f"{name}-{tag}.so"
            if not so.exists():
                BUILD.mkdir(parents=True, exist_ok=True)
                cpp = so.with_suffix(".cpp")
                cpp.write_text(src)
                proc = subprocess.run(
                    [cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                     "-pthread", "-w", "-o", str(so), str(cpp)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    if "c++20" in proc.stderr or "barrier" in proc.stderr:
                        pytest.skip(f"{cxx} cannot build C++20: "
                                    f"{proc.stderr[:200]}")
                    raise AssertionError(f"the emulated {name} did not "
                                         f"build:\n{proc.stderr}")
            libs[name] = ctypes.CDLL(str(so))
        return libs[name]
    return load


def _replay(lib, ins, kw, grouped=False):
    """The emulated kernel on prepared CPU inputs: (done, shift, cnt)."""
    fn = lib.replay_megakernel_launch
    fn.argtypes = mk._LIB.argtypes
    fn.restype = ctypes.c_int
    cfg, C = kw["cfg"], kw["C"]
    n_cores, n_qg = kw.get("n_cores", 1), kw.get("n_qg", 1)
    S, npad = ins[0].shape
    done = torch.full((S, npad), -7.0)
    shift = torch.full((S, n_cores), -7.0)
    cnt = torch.full((S, 4), -7, dtype=torch.int32)
    cap = kw["max_passes"]
    err = fn(*(x.data_ptr() for x in ins), done.data_ptr(), shift.data_ptr(),
             cnt.data_ptr(), S, npad // C, C, cfg.channels,
             cfg.banks_per_channel, cfg.tRCD, cfg.tRP, cfg.tCAS,
             cfg.read_queue, cfg.write_queue, n_cores, n_qg,
             int(grouped or n_cores > 1 or n_qg > 1),
             -1 if cap is None else cap, kw["busy"], kw["tol"], None)
    assert err == 0, err
    return done, shift, cnt


def _streams(seed, n, S, cores, cfg, C, *, saturate):
    rng = np.random.default_rng(seed)
    shape = (S, n)
    t = np.sort(rng.uniform(0.0, 3.0 * n, shape), axis=-1)
    if saturate:
        t, addr = t * 0.01, rng.integers(0, 64, shape) * 64
    else:
        addr = (rng.integers(0, 1 << 22, shape) // 64) * 64
    fb, ch, row = decode_requests(torch.from_numpy(addr), cfg)
    return mk.prepare(torch.from_numpy(t.astype(np.float32)), fb, ch, row,
                      torch.from_numpy(rng.random(shape) < 0.3),
                      torch.from_numpy(rng.random(shape) < 0.9), C,
                      torch.from_numpy(rng.integers(0, cores, shape)
                                       .astype(np.int32)))


def _assert_matches_plain(got, ins, kw):
    dp, sp, cp, _ = mk.run_plain(ins, **kw)
    dk, sk, ckk = got
    assert torch.equal(ckk, cp)
    torch.testing.assert_close(dk, dp, rtol=1e-3, atol=5e-2)
    torch.testing.assert_close(sk, sp, rtol=1e-3, atol=5e-2)


@pytest.mark.parametrize("C,queues,cap,tol", [
    (16, (8, 4), None, 0.25), (33, (128, 128), None, 0.25),
    (64, (8, 4), None, 0.25), (64, (4, 2), 1, 0.0), (64, (8, 8), 2, 0.0),
    (128, (16, 4), None, 0.25)])
def test_single_core_replay_matches_plain(emulated, C, queues, cap, tol):
    """The sweep's single-core instance (registers for C <= 64, shared
    memory above), and the multi-core instance at one core and one queue
    group, which must equal it bit for bit."""
    cfg = DramConfig(read_queue=queues[0], write_queue=queues[1])
    ins = _streams(C, 300, 3, 1, cfg, C, saturate=queues != (128, 128))
    kw = dict(cfg=cfg, busy=64 / 19.2, C=C, max_passes=cap, tol=tol)
    lib = emulated("replay_megakernel")
    one = _replay(lib, ins, kw)
    _assert_matches_plain(one, ins, kw)
    grouped = _replay(lib, ins, kw, grouped=True)
    for a, b in zip(one, grouped):
        assert torch.equal(a, b)


@pytest.mark.parametrize("C,cores,channels,queues", [
    (32, 2, 1, (8, 4)), (32, 16, 16, (128, 128)), (64, 4, 2, (8, 4)),
    (64, 16, 2, (8, 4)), (64, 4, 16, (8, 4)), (33, 4, 4, (6, 3)),
    (128, 16, 4, (8, 4)), (128, 2, 16, (128, 128))])
def test_multicore_replay_matches_plain(emulated, C, cores, channels,
                                        queues):
    """The multi-core, per-channel-queue mode in both instances."""
    cfg = DramConfig(channels=channels, read_queue=queues[0],
                     write_queue=queues[1])
    ins = _streams(C * 100 + cores + channels, 300, 2, cores, cfg, C,
                   saturate=queues != (128, 128))
    kw = dict(cfg=cfg, busy=64 / 19.2, C=C, max_passes=None, tol=0.25,
              n_cores=cores, n_qg=channels)
    got = _replay(emulated("replay_megakernel"), ins, kw)
    assert got[1].shape == (2, cores)
    _assert_matches_plain(got, ins, kw)


@pytest.mark.parametrize("k", [1, 33, 128, 257])
def test_conflict_kernel_matches_plain(emulated, k):
    """Every instance that can take k, bank ids inside and outside
    [0, num_banks), lines up to 2^31 - 1 (64-bit keys)."""
    lib = emulated("conflict_slowdown")
    fn = lib.conflict_slowdown_launch
    fn.argtypes = ck._LIB.argtypes
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(k)
    banks, rows = 16, 40
    line = rng.integers(0, 11, (rows, k)).astype(np.int32)
    bank = rng.integers(-3, banks + 3, (rows, k)).astype(np.int32)
    line[:8] = rng.integers(0, 2 ** 31 - 1, (8, k))
    bank[8] = rng.integers(0, banks, k)
    bank[9] = banks
    lt, bt = torch.from_numpy(line), torch.from_numpy(bank)
    for ports in (1, 3):
        want = conflict_slowdown_reference(lt, bt, num_banks=banks,
                                           ports=ports)
        for inst in [0] + [w for w in ck.INSTANCES if w == -1 or w >= k]:
            out = torch.full((rows,), -9, dtype=torch.int32)
            assert fn(lt.data_ptr(), bt.data_ptr(), out.data_ptr(), rows, k,
                      banks, ports, inst, None) == 0
            assert torch.equal(out, want), (k, ports, inst)


ELLPACK_CASES = [
    # (dtype, m, keep, the path of an aligned w): the vector instances
    # (float32 m = 2 .. 16, 2-byte types m = 4 .. 16, keep 1, 2, 4) and the
    # scalar path's (keep 3, 6, 8, m = 3, 6, 2-byte m = 2)
    (torch.float32, 4, 2, "vector"), (torch.float32, 8, 4, "vector"),
    (torch.float32, 16, 4, "vector"), (torch.float32, 2, 1, "vector"),
    (torch.float32, 16, 1, "vector"), (torch.float32, 8, 2, "vector"),
    (torch.bfloat16, 4, 2, "vector"), (torch.bfloat16, 8, 4, "vector"),
    (torch.float16, 16, 4, "vector"), (torch.float16, 8, 1, "vector"),
    (torch.bfloat16, 16, 2, "vector"),
    (torch.float32, 4, 3, "scalar"), (torch.float16, 8, 6, "scalar"),
    (torch.float32, 3, 1, "scalar"), (torch.bfloat16, 6, 3, "scalar"),
    (torch.float32, 8, 8, "scalar"), (torch.bfloat16, 2, 1, "scalar"),
    # integers: the vector instances' integer forms, and 1-byte elements
    # (the scalar path only)
    (torch.int32, 4, 2, "vector"), (torch.int32, 16, 4, "vector"),
    (torch.int16, 8, 4, "vector"), (torch.int16, 4, 1, "vector"),
    (torch.int32, 4, 3, "scalar"), (torch.int8, 8, 2, "scalar"),
    (torch.uint8, 4, 2, "scalar"), (torch.int8, 16, 4, "scalar")]


@pytest.mark.parametrize("dt,m,keep,path", ELLPACK_CASES,
                         ids=[f"{str(c[0])[6:]}-m{c[1]}-k{c[2]}"
                              for c in ELLPACK_CASES])
def test_ellpack_kernel_matches_plain(emulated, dt, m, keep, path):
    """The path the C entry picks for an aligned w (`path`) and the scalar
    path it picks for a view one element into its buffer: values and
    indices equal the plain version's; full blocks (more than keep
    nonzeros), empty blocks and negative zeros among them (for an integer
    type, its most negative value: the sign bit alone, nonzero)."""
    lib = emulated("ellpack_pack")
    fn = lib.ellpack_pack_launch
    fn.argtypes = ek._LIB.argtypes
    fn.restype = ctypes.c_int
    path_for = lib.ellpack_path_for
    path_for.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    path_for.restype = ctypes.c_int
    rng = np.random.default_rng(m * 10 + keep)
    rows, K = 40, 12 * m
    buf = torch.from_numpy(rng.standard_normal(rows * K + 1)
                           .astype(np.float32))
    buf[torch.from_numpy(rng.random(rows * K + 1) < 0.5)] = 0.0
    if dt.is_floating_point:
        buf = buf.to(dt)
    else:
        buf = (buf * 40).to(dt)
    aligned = buf[:-1].view(rows, K)
    aligned[0] = 1                                 # every block full
    aligned[1] = 0                                 # every block empty
    aligned[2, ::2] = (-0.0 if dt.is_floating_point
                       else torch.iinfo(dt).min)  # negative zeros
    offset = buf[1:].view(rows, K)
    runs = [(aligned, path), (offset, "scalar")]
    for w, want_path in runs:
        vector = path_for(w.data_ptr(), m, keep, w.element_size())
        assert vector == (want_path == "vector"), want_path
        vals = torch.full((rows, K // m, keep), 7, dtype=dt)
        idx = torch.full((rows, K // m, keep), -9, dtype=torch.int32)
        assert fn(w.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                  rows * (K // m), m, keep, w.element_size(),
                  int(not dt.is_floating_point), None) == 0
        pv, pi = ellpack_pack_plain(w, m=m, keep=keep)
        assert torch.equal(idx, pi), want_path
        bits = {4: torch.int32, 2: torch.int16, 1: torch.int8}[
            w.element_size()]
        assert torch.equal(vals.view(bits), pv.view(bits)), path
