"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit. Phases, each reported on its
own line; any failure exits non-zero before the final result line:

  1. environment: Python, torch and CUDA versions, the card's name and
     power limit (nvidia-smi);
  2. build: the replay megakernel and the bank-conflict kernel compiled
     from `src/repro_torch/csrc`, both nvcc runs started together;
  3. kernel vs plain: the CUDA replay kernel against its plain PyTorch
     version (and the per-request reference scan) on adversarial streams
     and on 256 random streams of 4,096 requests: counts exact, completion
     times within 1e-3 relative; the bank-conflict kernel against its
     plain version on adversarial rows and on 1,000,000 random rows of
     k = 128: exactly equal;
  4. the paper's named studies on the card (`edp_array_size`,
     `dataflow_dram_flip`, `sparse_speedup`): every claim holds, the
     frames agree with the same studies run on the CPU, the replay engine
     is "cuda" and the kernel launched;
  5. the first slice's path: the dense sweep, 72 designs x {resnet18,
     vit_base} x {fast, trace}, once with the replay launch count reset
     just before it (one launch per trace group); its whole frame against
     the same sweep on the CPU, per column; the wall time per fidelity
     (three runs each), a profiled trace sweep, and the replay kernel
     against its plain version on the vit_base trace group's launch
     (1,776 streams);
  6. this slice's path: the feature sweep, 162 designs (3 arrays x 3 SRAM
     sizes x 3 dataflows x {dense, 2:4, 1:4 row-wise} x {1, 4} cores),
     each with the layout stage off and on, x {resnet18, vit_base} x
     {fast, trace}: 1,296 rows, once with both kernels' launch counts
     reset just before it (one conflict launch per layout-on group, one
     replay launch per trace group); layout-on rows never faster than
     their layout-off twins; the whole frame against the same sweep on
     the CPU, per column; the wall time per fidelity (three runs each),
     profiled fast and trace sweeps, and the conflict kernel against its
     plain version, timed, on the largest layout group's launch;
  7. a `{"kernels": [...]}` line, the nvidia-smi line, and last
     `{"ok": true, "device": {...}}`.

Writes the measurements to chiprun_out/chip_smoke.json as well.
"""
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the float32 rate
# outside the tensor cores; the replay kernel does float32 compare-selects.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
RTOL = 1e-3


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def phase(name: str, **kv):
    print(f"phase {name}: " + json.dumps(kv, default=str), flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max(|b|, 1)."""
    if a.numel() == 0:
        return 0.0
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


def frame_rel_err(res, ref) -> dict:
    """Per metric column of two study frames: max |a - b| / |b|."""
    out = {}
    for c in res.column_names():
        if c in ("design", "workload", "fidelity"):
            continue
        a, b = np.asarray(res[c], float), np.asarray(ref[c], float)
        out[c] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    return out


def timed_cuda(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn`, by CUDA events (after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_run(fn) -> dict:
    """Wall time of one `fn()` under torch.profiler, the device busy time
    (kernels and copies) and the top device operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: the host ops that launch them report the
    # same device time again
    dev_ms = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            dev_ms[e.key] = (dev_ms.get(e.key, (0.0, 0))[0] + us / 1e3,
                             e.count)
    busy_ms = sum(v[0] for v in dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(profiled_wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                device_busy_share=(busy_ms / (wall * 1e3)) if busy_ms
                else None,
                top_device_ops=[dict(name=k[:80], ms=v[0], calls=v[1])
                                for k, v in top])


def host_ms(fn, reps: int) -> float:
    """Median host milliseconds of `fn()` ending in a synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def check_frame(name, frame, rows: int):
    """Finite values of the expected shape, no failed cell, the CUDA
    engine; returns the metric column names."""
    cols = [c for c in frame.column_names()
            if c not in ("design", "workload", "fidelity")]
    finite = all(bool(np.isfinite(np.asarray(frame[c], float)).all())
                 for c in cols)
    if len(frame) != rows or not finite or frame.failed_cells:
        fail(f"{name}: {len(frame)} rows (expected {rows}), finite={finite}, "
             f"failed={frame.failed_cells}")
    if frame.meta.get("engine") != "cuda":
        fail(f"{name}: engine {frame.meta.get('engine')!r}")
    return cols




def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "the port on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    from repro_torch.api import simulator as sim
    from repro_torch.api.study import studies
    from repro_torch.core import layout as tlay
    from repro_torch.core.accelerator import DramConfig, LayoutConfig
    from repro_torch.core.dram import decode_requests, replay_requests
    from repro_torch.core.workloads import resnet18, vit_base
    from repro_torch.kernels.conflict import conflict as ck
    from repro_torch.kernels.conflict.ref import conflict_slowdown_reference
    from repro_torch.kernels.replay import megakernel as mk
    from repro_torch.trace.generator import DEFAULT_SPEC

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report = {}

    # ---- 1. environment ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    env = dict(python=sys.version.split()[0], torch=torch.__version__,
               cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
               capability=torch.cuda.get_device_capability(0),
               device_count=torch.cuda.device_count(), card=card)
    phase("environment", **env)
    report["environment"] = env

    # ---- 2. build: one nvcc per source, started together --------------------
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(mk.build), pool.submit(ck.build)]:
            f.result()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in (("replay_megakernel", mk.BUILD_LOG),
                               ("conflict_slowdown", ck.BUILD_LOG))}
    phase("build", seconds=round(build_s, 3), ptxas=ptxas)
    report["build"] = dict(seconds=build_s, ptxas=ptxas)

    # ---- 3a. replay kernel vs plain (and the per-request scan) ---------------
    def streams(seed, n, *, span=1 << 22, p_write=0.3, p_valid=0.9,
                burst=None, batch=(), t_scale=1.0):
        rng = np.random.default_rng(seed)
        shape = tuple(batch) + (n,)
        t = np.sort(rng.uniform(0.0, 3.0 * n, shape), axis=-1) * t_scale
        if burst is not None:
            addr = rng.integers(0, burst, shape) * 64
        else:
            addr = (rng.integers(0, span, shape) // 64) * 64
        return (torch.tensor(t.astype(np.float32), device=dev),
                torch.tensor(addr, device=dev),
                torch.tensor(rng.random(shape) < p_write, device=dev),
                torch.tensor(rng.random(shape) < p_valid, device=dev))

    def kernel_vs_plain(name, t, addr, w, v, cfg, *, chunk=64, tol=0.25,
                        max_passes=None, scan=True):
        fb, ch, row = decode_requests(addr, cfg)
        C = max(1, min(chunk, t.shape[-1]))
        ins = mk.prepare(t, fb, ch, row, w, v, C)
        kw = dict(cfg=cfg, busy=max(1.0, 64 / cfg.bandwidth_bytes_per_cycle),
                  C=C, max_passes=max_passes, tol=tol)
        dk, sk, ck_ = mk.launch_cuda(ins, **kw)
        torch.cuda.synchronize()
        dp, sp, cp, _ = mk.run_plain(ins, **kw)
        if not torch.equal(ck_, cp):
            fail(f"{name}: kernel counts {ck_.sum(0).tolist()} != plain "
                 f"{cp.sum(0).tolist()}")
        err = rel_err(dk, dp)
        if err > RTOL or rel_err(sk, sp) > RTOL:
            fail(f"{name}: kernel done/shift differ from plain by {err:.3g}")
        row_ = dict(name=name, streams=ins[0].shape[0], n=t.shape[-1],
                    max_abs=float((dk - dp).abs().max()), max_rel=err)
        if scan:     # the per-request oracle, on the card
            ref = replay_requests(t, fb, ch, row, w, v, cfg,
                                  engine="reference")
            n = t.shape[-1]
            dk_n = dk.reshape(ref.complete.shape[:-1] + (-1,))[..., :n]
            ck_n = ck_.reshape(ref.row_hits.shape + (4,))
            for j, k in enumerate(("row_hits", "row_misses",
                                   "row_conflicts")):
                if not torch.equal(ck_n[..., j], getattr(ref, k)):
                    fail(f"{name}: kernel {k} differ from the reference scan")
            vm = v.to(torch.bool)
            diff = (torch.where(vm, dk_n, 0) - torch.where(vm, ref.complete,
                                                           0)).abs()
            lim = 5e-2 + RTOL * ref.complete.abs()
            if bool((diff > lim).any()):
                fail(f"{name}: kernel done differ from the reference scan")
            row_["scan_max_abs"] = float(diff.max())
        return row_

    cfg0 = DramConfig()
    checks = []
    for s in range(3):
        checks.append(kernel_vs_plain(f"random{s}", *streams(s, 512), cfg0))
    n = 384
    checks.append(kernel_vs_plain(
        "same_bank_chain",
        torch.arange(n, dtype=torch.float32, device=dev) * 0.5,
        (torch.arange(n, device=dev) % 2) * (1 << 21),
        torch.zeros(n, dtype=torch.bool, device=dev),
        torch.ones(n, dtype=torch.bool, device=dev),
        DramConfig(channels=1, banks_per_channel=1)))
    for name, burst, q in (("queue_sat_8", 64, (8, 8)),
                           ("queue_sat_4_2", 4, (4, 2))):
        checks.append(kernel_vs_plain(
            name, *streams(7 + burst, 512, burst=burst, p_valid=0.95,
                           t_scale=0.01),
            DramConfig(read_queue=q[0], write_queue=q[1])))
    for n in (1, 63, 64, 65, 200):
        for c in (16, 64):
            checks.append(kernel_vs_plain(
                f"chunk_n{n}_c{c}", *streams(n * 1000 + c, n), cfg0,
                chunk=c))
    checks.append(kernel_vs_plain("batched_3", *streams(10, 256, batch=(3,)),
                                  cfg0))
    one_bank = DramConfig(channels=1, banks_per_channel=1)
    checks.append(kernel_vs_plain(
        "tol0", *streams(5, 256, burst=2, p_valid=1.0), one_bank, tol=0.0))
    checks.append(kernel_vs_plain(
        "max_passes_1", *streams(5, 256, burst=2, p_valid=1.0), one_bank,
        tol=0.0, max_passes=1, scan=False))
    checks.append(kernel_vs_plain(
        "random_256x4096", *streams(11, 4096, batch=(256,)), cfg0,
        scan=False))
    phase("kernel_vs_plain", cases=len(checks),
          max_rel=max(c["max_rel"] for c in checks),
          max_abs=max(c["max_abs"] for c in checks),
          scan_max_abs=max(c.get("scan_max_abs", 0.0) for c in checks))
    report["kernel_vs_plain"] = checks

    # ---- 3b. conflict kernel vs plain: exactly equal -------------------------
    def conflict_case(name, line, bank, banks, ports):
        lt = torch.as_tensor(line, dtype=torch.int32, device=dev).contiguous()
        bt = torch.as_tensor(bank, dtype=torch.int32, device=dev).contiguous()
        got = ck.conflict_slowdown(lt, bt, num_banks=banks, ports=ports)
        torch.cuda.synchronize()
        want = conflict_slowdown_reference(lt, bt, num_banks=banks,
                                           ports=ports)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"conflict {name}: kernel differs from plain in {bad} rows")
        return dict(name=name, rows=int(lt.shape[0]), k=int(lt.shape[1]),
                    banks=banks, ports=ports,
                    max_slowdown=int(got.max()) if got.numel() else 0)

    ccases = []
    for k in (1, 31, 32, 33, 128, 1024):
        for ports in (1, 2, 4):
            for banks in (2, 8, 32):
                rng = np.random.default_rng(k * 100 + ports * 10 + banks)
                line = rng.integers(0, 11, (300, k))
                bank = rng.integers(0, banks, (300, k))
                j = np.arange(k)
                line[0], bank[0] = j, 0                  # all in one bank
                line[1], bank[1] = j // banks, j % banks  # all pairs distinct
                line[2], bank[2] = 7, banks - 1          # one pair repeated
                line[3], bank[3] = 0, j % banks          # one line, all banks
                ccases.append(conflict_case(f"k{k}_p{ports}_b{banks}", line,
                                            bank, banks, ports))
    ccases.append(conflict_case("empty", np.zeros((0, 128)),
                                np.zeros((0, 128)), 32, 1))
    g = torch.Generator(device=dev).manual_seed(0)
    big_line = torch.randint(0, 64, (1_000_000, 128), generator=g,
                             device=dev, dtype=torch.int32)
    big_bank = torch.randint(0, 32, (1_000_000, 128), generator=g,
                             device=dev, dtype=torch.int32)
    ccases.append(conflict_case("random_1000000x128", big_line, big_bank,
                                32, 1))
    big_ms = timed_cuda(lambda: ck.conflict_slowdown(
        big_line, big_bank, num_banks=32, ports=1), reps=5)
    del big_line, big_bank
    phase("conflict_vs_plain", cases=len(ccases), all_equal=True,
          random_1M_kernel_ms=big_ms)
    report["conflict_vs_plain"] = dict(cases=ccases,
                                       random_1M_kernel_ms=big_ms)

    # ---- 4. the named studies -------------------------------------------------
    named = {}
    for name, study in (("edp_array_size", studies.edp_array_size()),
                        ("dataflow_dram_flip",
                         studies.dataflow_dram_flip()),
                        ("sparse_speedup", studies.sparse_speedup())):
        before = mk.LAUNCHES
        res = study.run()                       # the default: the card
        claims = res.check_claims()
        if not claims or not all(claims.values()):
            fail(f"{name}: claims {claims}")
        if "trace" in res.axes["fidelity"]:
            if res.meta.get("engine") != "cuda":
                fail(f"{name}: engine {res.meta.get('engine')!r}")
            if mk.LAUNCHES <= before:
                fail(f"{name}: the replay kernel did not launch")
        worst = max(frame_rel_err(res, study.run(device="cpu")).values())
        if worst > RTOL:
            fail(f"{name}: card frame differs from the CPU frame by {worst}")
        named[name] = dict(claims=claims, engine=res.meta.get("engine"),
                           launches=mk.LAUNCHES - before,
                           max_rel_vs_cpu=worst)
        phase(f"study {name}", **named[name])
    report["named_studies"] = named

    # ---- 5. the first slice's path: the dense sweep ---------------------------
    grid = rt.preset_grid(array=[16, 32, 64, 128],
                          sram_mb=[0.25, 0.5, 1, 2, 4, 8],
                          dataflow=["ws", "os", "is"])
    wl = {"resnet18": resnet18(), "vit_base": vit_base()}
    sweep = rt.Study("full_sweep").designs(grid).workloads(wl) \
        .fidelity("fast", "trace")
    trace_groups = sum(g.fidelity == "trace" for g in sweep.plan().groups)
    mk.LAUNCHES = 0                     # counts reset just before ...
    t0 = time.perf_counter()
    frame = sweep.run()
    both_s = time.perf_counter() - t0
    dense_launches = mk.LAUNCHES        # ... and read just after
    if dense_launches != trace_groups:
        fail(f"the dense sweep launched the replay kernel {dense_launches} "
             f"times, expected one launch per trace group ({trace_groups})")
    check_frame("dense sweep", frame, 288)
    t0 = time.perf_counter()
    cpu_frame = sweep.run(device="cpu")
    cpu_s = time.perf_counter() - t0
    if cpu_frame.meta.get("engine") != "torch:plain":
        fail(f"CPU sweep engine {cpu_frame.meta.get('engine')!r}")
    col_err = frame_rel_err(frame, cpu_frame)
    bad = {c: e for c, e in col_err.items() if not e <= RTOL}
    if bad:
        fail(f"dense sweep: card frame differs from the CPU frame: {bad}")
    runs = {"fast": [], "trace": []}
    for _ in range(3):                          # alternate the fidelities
        for fid in runs:
            t0 = time.perf_counter()
            sweep.fidelity(fid).run()
            runs[fid].append(time.perf_counter() - t0)
    walls = {f: float(np.median(r)) for f, r in runs.items()}
    sweep_info = dict(
        rows=len(frame), first_run_both_s=both_s,
        launches_per_sweep=dense_launches, trace_groups=trace_groups,
        cpu_run_s=cpu_s, max_rel_vs_cpu=max(col_err.values()),
        max_rel_vs_cpu_by_column=col_err,
        wall_s_runs=runs, wall_s_median=walls,
        designs_per_s={f: len(grid) / s for f, s in walls.items()})
    phase("full_sweep", **sweep_info)
    report["full_sweep"] = sweep_info
    prof = profile_run(lambda: sweep.fidelity("trace").run())
    phase("trace_sweep_profile", **prof)
    report["trace_sweep_profile"] = prof

    # ---- the vit_base trace group's launch: kernel vs plain, timed ---------
    ws = [c for c in grid if c.dataflow == "ws"]
    t0 = time.perf_counter()
    strm, scale, smap = sim.decoded_streams(ws, wl["vit_base"], "ws", 2,
                                            DramConfig(), DEFAULT_SPEC, dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    ins = mk.prepare(*strm, 64)
    S, npad = ins[0].shape
    kw = dict(cfg=DramConfig(), busy=max(1.0, 64 / 19.2), C=64,
              max_passes=None, tol=0.25)
    kernel_ms = timed_cuda(lambda: mk.launch_cuda(ins, **kw), reps=20)
    dk, sk, ck_ = mk.launch_cuda(ins, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp, sp, cp, passes = mk.run_plain(ins, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(ck_, cp):
        fail("vit_base group: kernel counts differ from the plain version")
    err = rel_err(dk, dp)
    if err > RTOL or rel_err(sk, sp) > RTOL:
        fail(f"vit_base group: kernel done/shift differ from plain by {err}")
    max_abs = float((dk - dp).abs().max())

    # the streams generated on the card equal the CPU's, bit for bit
    # (the first designs' unique streams lead the batch, in design order)
    cpu_strm, cpu_scale, _ = sim.decoded_streams(
        ws[:4], wl["vit_base"], "ws", 2, DramConfig(), DEFAULT_SPEC, "cpu")
    u = cpu_strm[0].shape[0]
    for a, b in zip(strm + (scale,), cpu_strm + (cpu_scale,)):
        if not torch.equal(a[:u].cpu(), b):
            fail("demand streams generated on the card differ from the CPU's")

    # the least time: each input byte of the kernel's int32 interface read
    # once (the all-zero core id and the w/v bits widened to int32
    # included), each output byte written once; one f32 operation per
    # (consumer, producer) pair of each O(C^2) triangular reduction: 8
    # table loops per chunk plus 3 per fixed-point pass, over the valid
    # requests of each chunk and this run's passes
    nv = ins[5].reshape(S, npad // 64, 64).sum(-1).to(torch.float64)
    pairs = nv * (nv + 1) / 2
    ops = float(((8 + 3 * passes.to(torch.float64)) * pairs).sum())
    nbytes = S * npad * (4 + 6 * 4) + S * npad * 4 + S * (4 + 16)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # the same without the core id and with w/v as one bit each: what the
    # function itself must move (recorded, not used for bound_ms)
    fn_bytes = S * npad * (4 + 3 * 4) + S * npad // 4 + S * npad * 4 \
        + S * (4 + 16)
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    replay_group = dict(
        streams=S, requests_per_stream=npad,
        valid_requests=int(ins[5].sum()), gen_decode_s=gen_s,
        kernel_ms=kernel_ms, plain_ms=plain_ms, max_abs_err=max_abs,
        max_rel_err=err, mean_passes=float(passes.double().mean()),
        max_passes=int(passes.max()), bytes=nbytes, ops=ops,
        bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        function_bytes=fn_bytes,
        function_bytes_ms=fn_bytes / HBM_BYTES_PER_S * 1e3)
    phase("vit_base_trace_group", **replay_group)
    report["vit_base_trace_group"] = replay_group
    del ins, strm, dk, dp

    # ---- 6. this slice's path: the feature sweep ------------------------------
    base = rt.preset_grid(array=[32, 64, 128], sram_mb=[0.5, 2, 8],
                          dataflow=["ws", "os", "is"],
                          sparsity=[None, "2:4", "1:4-rw"], cores=[1, 4])
    lay_cfg = LayoutConfig(enabled=True)
    feat = base + [c.with_(layout=lay_cfg) for c in base]
    fsweep = rt.Study("feature_sweep").designs(feat).workloads(wl) \
        .fidelity("fast", "trace")
    plan = fsweep.plan()
    layout_groups = sum(plan.cells[g.cells[0]].config.layout.enabled
                        for g in plan.groups)
    ftrace_groups = sum(g.fidelity == "trace" for g in plan.groups)
    mk.LAUNCHES = ck.LAUNCHES = 0       # counts reset just before ...
    t0 = time.perf_counter()
    fframe = fsweep.run()
    fboth_s = time.perf_counter() - t0
    feat_launches = dict(replay_megakernel=mk.LAUNCHES,
                         conflict_slowdown=ck.LAUNCHES)   # ... read just after
    if feat_launches["conflict_slowdown"] != layout_groups:
        fail(f"the feature sweep launched the conflict kernel "
             f"{feat_launches['conflict_slowdown']} times, expected one "
             f"launch per layout-on group ({layout_groups})")
    if feat_launches["replay_megakernel"] != ftrace_groups:
        fail(f"the feature sweep launched the replay kernel "
             f"{feat_launches['replay_megakernel']} times, expected one "
             f"launch per trace group ({ftrace_groups})")
    n_rows = len(feat) * len(wl) * 2
    check_frame("feature sweep", fframe, n_rows)
    # layout-on rows never beat their layout-off twins (same position in
    # the second half of the design axis)
    tot = np.asarray(fframe["total_cycles"], float).reshape(
        2, len(wl), 2, len(base))
    if not (tot[:, :, 1] >= tot[:, :, 0]).all():
        fail("feature sweep: a layout-on design is faster than its twin")
    t0 = time.perf_counter()
    fcpu = fsweep.run(device="cpu")
    fcpu_s = time.perf_counter() - t0
    fcol_err = frame_rel_err(fframe, fcpu)
    bad = {c: e for c, e in fcol_err.items() if not e <= RTOL}
    if bad:
        fail(f"feature sweep: card frame differs from the CPU frame: {bad}")
    fruns = {"fast": [], "trace": []}
    for _ in range(3):
        for fid in fruns:
            t0 = time.perf_counter()
            fsweep.fidelity(fid).run()
            fruns[fid].append(time.perf_counter() - t0)
    fwalls = {f: float(np.median(r)) for f, r in fruns.items()}
    feat_info = dict(
        rows=len(fframe), designs=len(feat), groups=len(plan.groups),
        layout_groups=layout_groups, trace_groups=ftrace_groups,
        launches=feat_launches, first_run_both_s=fboth_s,
        cpu_run_s=fcpu_s, rows_held_vs_cpu=len(fcpu),
        max_rel_vs_cpu=max(fcol_err.values()),
        max_rel_vs_cpu_by_column=fcol_err,
        layout_extra_share=float(np.mean(tot[:, :, 1] / tot[:, :, 0]) - 1),
        wall_s_runs=fruns, wall_s_median=fwalls,
        designs_per_s={f: len(feat) / s for f, s in fwalls.items()})
    phase("feature_sweep", **feat_info)
    report["feature_sweep"] = feat_info
    for fid in ("fast", "trace"):
        prof = profile_run(lambda: fsweep.fidelity(fid).run())
        phase(f"feature_{fid}_profile", **prof)
        report[f"feature_{fid}_profile"] = prof

    # ---- the largest layout group's launch: kernel vs plain, timed ---------
    # vit_base x ws x one core x layout on: the rows the layout stage hands
    # the kernel (one row set per distinct array-rows value and gemm op)
    gcfgs = [c for c in feat if c.layout.enabled and c.dataflow == "ws"
             and c.num_cores == 1]
    gemms = [o for o in wl["vit_base"] if o.kind == "gemm"]
    R = torch.tensor(sorted({float(c.cores[0].rows) for c in gcfgs}),
                     device=dev)
    stride = torch.clamp_min(torch.tensor([float(o.N) for o in gemms],
                                          device=dev), 1.0)
    r_cap = sim._pow2_cap(int(R.max()))
    line, bank = tlay.streaming_ids(lay_cfg, R, stride, 2, r_cap=r_cap)
    line, bank = line.reshape(-1, r_cap), bank.reshape(-1, r_cap)
    rows = int(line.shape[0])
    kwc = dict(num_banks=lay_cfg.num_banks, ports=lay_cfg.ports_per_bank)
    conflict_ms = timed_cuda(lambda: ck.conflict_slowdown(line, bank, **kwc),
                             reps=20)
    got = ck.conflict_slowdown(line, bank, **kwc)
    conflict_plain_ms = host_ms(
        lambda: conflict_slowdown_reference(line, bank, **kwc), reps=5)
    want = conflict_slowdown_reference(line, bank, **kwc)
    if not torch.equal(got, want):
        fail("largest layout group: conflict kernel differs from plain")
    # the least time: each id read once (line and bank, int32), each
    # slowdown written once; one operation per (j', j < j) pair test of the
    # first-occurrence formulation, at the float32 non-tensor rate (the
    # card's integer compares issue on the same pipes at no higher rate)
    c_bytes = rows * r_cap * 8 + rows * 4
    c_ops = rows * r_cap * (r_cap - 1) / 2
    c_bytes_ms = c_bytes / HBM_BYTES_PER_S * 1e3
    c_ops_ms = c_ops / FP32_OPS_PER_S * 1e3
    layout_group = dict(
        designs=len(gcfgs), gemms=len(gemms), distinct_rows=R.tolist(),
        rows=rows, k=r_cap, kernel_ms=conflict_ms,
        plain_ms=conflict_plain_ms, max_abs_err=0,
        mean_slowdown=float(got.double().mean()), bytes=c_bytes, ops=c_ops,
        bytes_ms=c_bytes_ms, ops_ms=c_ops_ms,
        bound_ms=max(c_bytes_ms, c_ops_ms),
        bound_by="bytes" if c_bytes_ms >= c_ops_ms else "operations")
    phase("largest_layout_group", **layout_group)
    report["largest_layout_group"] = layout_group

    kernels = {"kernels": [
        dict(name="replay_megakernel", route="cuda",
             source="src/repro_torch/csrc/replay_megakernel.cu",
             replaces="src/repro/kernels/replay/megakernel.py:96",
             launches=feat_launches["replay_megakernel"],
             max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
             bound_ms=replay_group["bound_ms"],
             bound_by=replay_group["bound_by"], library_ms=None),
        dict(name="conflict_slowdown", route="cuda",
             source="src/repro_torch/csrc/conflict_slowdown.cu",
             replaces="src/repro/kernels/conflict/conflict.py:42",
             launches=feat_launches["conflict_slowdown"],
             max_abs_err=0, ms=conflict_ms, plain_ms=conflict_plain_ms,
             bound_ms=layout_group["bound_ms"],
             bound_by=layout_group["bound_by"], library_ms=None)]}
    report["kernels"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                    default=str))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
