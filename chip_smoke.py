"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit. Phases, each reported on its
own line; any failure exits non-zero before the final result line:

  1. environment: Python, torch and CUDA versions, the card's name and
     power limit (nvidia-smi);
  2. build: the replay megakernel, the bank-conflict kernel, the fold
     matmul, the wavefront kernel and the ELLPACK packer compiled from
     `src/repro_torch/csrc`, all five nvcc runs started together;
  3. kernel vs plain: the CUDA replay kernel against its plain PyTorch
     version (and the per-request reference scan) on adversarial streams
     and on 256 random streams of 4,096 requests: counts exact, completion
     times within 1e-3 relative; the replay kernel's multi-core,
     per-channel-queue mode against its plain version on seeded merged
     streams (2, 4 and 16 cores; 1, 2, 4 and 16 channels, a queue group
     each; chunks of 32, 64 and 128; queues 8 / 4 and 128 / 128), and its
     multi-core instance at one core and one group against the
     single-core instance, bit for bit; the bank-conflict kernel against its
     plain version on adversarial rows at k across every instance
     boundary (1 to 1,024), on rows of 64-bit keys (lines up to
     2^31 - 1, 1,024 banks), on ids one element into a buffer, on bank
     ids outside [0, num_banks) and on 1,000,000 random rows of k = 128:
     exactly equal; the fold matmul
     (float32 within 1e-5, bfloat16 and float16 within 2e-2), the
     wavefront kernel (both entries, and its closed form) and the ELLPACK
     packer (exactly equal, each case aligned and as a view one element
     into its buffer, which takes the scalar path: float32 m = 2, 4, 8,
     16, bfloat16 and float16 m = 4, 8, 16, keep 3 and 6) against their plain
     versions on edge shapes: empty inputs, B = 1, T = 1, T < 0,
     n_cycles % 4 != 0, T = 60,000, ragged tiles, mixed dtypes;
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
  6. the second slice's path: the feature sweep, 162 designs (3 arrays x
     3 SRAM sizes x 3 dataflows x {dense, 2:4, 1:4 row-wise} x {1, 4}
     cores),
     each with the layout stage off and on, x {resnet18, vit_base} x
     {fast, trace}: 1,296 rows, once with both kernels' launch counts
     reset just before it (one conflict launch per layout-on group, one
     replay launch per trace group); layout-on rows never faster than
     their layout-off twins; the whole frame against the same sweep on
     the CPU (its batch groups split over four processes and put
     together as a farm client does), per column; the wall time per
     fidelity (three runs each),
     profiled fast and trace sweeps (the conflict kernel's device time
     among them), and the conflict kernel against its plain version,
     timed, on the largest layout group's launch; then each conflict
     instance that can take the rows (register widths and shared memory)
     timed on that launch and on random rows of 128 M ids at k = 32, 64,
     128 and 256, with 32-bit and with 64-bit keys;
  7. this slice's path, the fold plane: every fold of every GEMM instance
     of vit_base on a 128 x 128 WS array (5,844 `simulate_fold` calls,
     float32 operands from a seeded numpy generator), each with one
     matmul and one wavefront launch (counts reset just before it), and a
     power trace per op instance; per op the folds' cycles equal
     `compute_cycles` x count, every fold's activity the closed form, the
     summed K-folds the whole product within 1e-4 (relative to each
     element or, if larger, the product's rms), every power trace lies
     between the leakage floor and full occupancy; one fold of each shape
     against the plain version and the per-cycle scan (float32 1e-5,
     bfloat16 2e-2); a profiled first encoder layer;
  8. `batched_fold_activity`: one launch per (workload, array) for
     {resnet18, vit_base} x {32, 64, 128} (counts reset just before),
     equal to the plain version and the closed form, each row summing to
     T R C;
  9. ELLPACK on all 50 vit_base weight matrices pruned exactly 2:4, 4:8
     and row-wise (m = 8), one `pack_with_report` launch each (count
     reset just before): values and indices equal to the plain version,
     the exact cases' bytes equal to `storage_report`, the row-wise mean
     kept count within 1 % of its expectation;
  10. the three kernels timed at their path shapes (CUDA graphs of 20
     calls, CUDA events), beside their plain versions, `torch.matmul`
     and their bounds; the ELLPACK packer's vector path on the mlp2
     weight (2:4 float32) beside the same weight one element into its
     buffer (the scalar path), 4:8 float32 and bfloat16 at m = 8; the
     matmul also at each distinct fold shape of
     the fold pass, with its grid's block count; the wavefront kernel
     also on one qkv fold through its one-fold entry, beside the same
     fold through the batched entry and beside the launch floor, an
     empty kernel launched the same way (graph replay and host loop);
  11. the fourth slice's path, shared-DRAM contention: the named study
     `multicore_contention` (mcm-4x32 at 1, 2 and 4 channels, GEMM
     512 x 2048 x 1024, cap 4,096) with the replay launch count reset just
     before it (two launches per cell): its three claims, the "cuda"
     engine, its frame against the same study on the CPU; the two replays
     of its 4-channel cell and of 16 cores (`multicore-16x32`, shared
     routing over 2 channels and private routing over 16) held against the
     plain version on the card, timed beside their bounds; shared never
     below isolated, and the private-channel decomposition's gap;
  12. the fifth slice's path, the routed NoC plane: the named study
     `nop_bound` at its defaults (pods of 64, 256 and 1,024 cores, GEMMs
     of 2,048): its six claims, the zero-load pair bit for bit, its frame
     against the same study on the CPU, its wall (three runs) and a
     profile; a fast-fidelity pod sweep of 22 designs up to 4,096 cores
     (mesh, torus and ring) on vit_base and a trace-fidelity pod sweep of
     6 designs on resnet18 (replay count reset just before: one launch per
     group), each frame against the CPU's; the contention path on a
     16-core NoC pod, whose routed skew must add queueing delay to the
     hop offsets, both replays held to 1e-5 against the plain version on
     the card;
  13. the sixth slice's path, the per-op engine: `Simulator("paper-128",
     fidelity=f).run(vit_base())` at full width for f in fast, cycle and
     trace (74 gemm and 36 vector ops; the replay count reset just before
     each run: 0, 74 and 74 launches, engine "cuda" at cycle and trace),
     host walls (three runs each), the card's busy share (a profile), and
     every OpResult against the same run on the card machine's CPU
     (fields within 1e-3, row-buffer counts exact); the replay kernel at
     the per-op shapes (1 x 4,096 at trace, vit_base's largest cycle
     stream, 1 x 16,384 at the cycle cap) against its plain version,
     timed beside its bound;
  14. resnet18 on paper-32 at trace with the layout stage on: 21 replay
     and 21 conflict launches, the same CPU comparison, the layout
     cycles; the conflict kernel at the per-op shape (one op window)
     against its plain version, timed beside its bound;
  15. the paper's Fig. 5, Fig. 9, Fig. 10, Table VI and Fig. 15 claims
     through `simulate_network` / `simulate_dram` on the card;
  16. `force_fallback` parity: 24 seeded mixed designs (arrays 8/16/32,
     ws/os/is, dense / 2:4 / 1:4 / 2:8 row-wise, 1 or 4 cores, layout on
     or off) on resnet18 at fast and trace, and `pod-mesh` pods of 16 and
     64 cores (mesh and torus) at fast: the per-op frame against the
     batched one within 1e-3 (the NoC columns too), both runs' launches;
  17. a Study of `dataflow_dram_flip`'s two designs on the six resnet18
     layers at fast, cycle and trace: 14 replay launches, the frame
     against the CPU's within 1e-3, then run with `.cache(dir)` twice:
     every cell a hit the second time, both frames equal to the first;
  18. the seventh slice's path, the design-space search: `search_edp` at
     full width (12 vit_base layers, a screen of 1,536; 2,032 cells a
     pass over the ~10^5-cell Table-V space) with both kernels' counts
     reset just before it: its seven claims (seeded replay bit for bit
     among them), the "cuda" engine, conflict launches on the layout
     groups and replay launches on the trace rung; one more cold pass
     under the profiler (the card's busy share) with each round and the
     host's promotions timed; the smoke search on the card against the
     card machine's CPU (the same cohorts and parents every round, best
     rows within 1e-3); the trace rung's designs and 96 screened designs
     cut into shards of 1, 2 and 5 through `_execute_cells`, each frame
     equal to the local run bit for bit;
  19. the run-farm: a broker thread and two `python -m repro_torch.farm
     worker --device cuda` processes run `edp_array_size` at full width
     (shards of at most 2 cells): the frame equal to the local card run
     bit for bit, the four claims, cells per worker;
  20. the chaos soak in process on the card (`python -m repro_torch.farm
     chaos --device cuda`, `edp_array_size` at full width): each of the
     worker-kills, torn-writes and lease-storms schedules done,
     bit-identical to the fault-free run, the claims holding, at least
     one kill under worker-kills;
  21. the eighth slice's path, the workload plane's serving path:
     `python -m repro_torch.launch.serve --arch qwen2-1.5b --requests 8
     --batch 4 --prompt-len 512 --gen-len 32 --sim-accel paper-128` in
     process on the default device (28 layers, d 1,536, bfloat16; every
     kernel count reset just before: none launched), then the same
     weights (seed 0) served three more times: every logit finite, every
     token in [0, vocab_padded), the same greedy tokens every run and as
     the CLI's samples; prefill ms, decode ms per token and served
     tokens/s beside their bounds (weight bytes over 3.35 TB/s; 2 x body
     parameters x tokens over 989 TFLOP/s), peak memory and the card's
     busy share (a profile); the `--sim-accel` wave cost (prefill and
     decode `run_lm`) on the card within 1e-3 of the CPU's;
  22. qwen2-1.5b at full width, 2 layers, float32, the same weights on
     the card and the card machine's CPU (TF32 off): prefill logits and
     caches, one decode step, within 1e-3, and a served wave (batch 2,
     prompt 128, gen 8) with the same greedy tokens;
  23. granite-moe-3b-a800m at full width (32 layers, 40 experts, top 8):
     one wave of batch 4, prompt 512, gen 16, twice: logits finite, the
     same greedy tokens, tokens/s;
  24. all 10 SMOKE configs in float32, prefill + 4 decode steps + the
     loss on the card against the card machine's CPU: within 1e-3, the
     same greedy tokens;
  25. the ninth slice's path, training: qwen2-1.5b at full width and
     depth (bfloat16), 6 steps of `ModelBundle.train_step` at batch 8 x
     seq 1,024 (a cosine schedule peaking at 3e-4, random weights from
     seed 0; every kernel count reset just before: none launched): every
     loss and gradient norm finite, the first loss within 1.5 of
     ln(vocab), every leaf's gradient nonzero and every leaf changed that
     bfloat16 can move; step ms (median of steps 2-6) beside the step's
     bound, tokens/s, peak memory, the card's busy share over one more
     step (a profile); then `python -m repro_torch.launch.train --steps
     6 --batch 8 --seq 1024 --sim-accel paper-128` as a subprocess: it
     prints `done.`, and its modeled step equals the card's and the card
     machine's CPU's co-simulation within 1e-3;
  26. qwen2-1.5b at full width, 2 layers, float32: one train step from
     the same weights on the card and the card machine's CPU (TF32 off):
     loss, gradient norm, both moments and the updated parameters within
     1e-3 (parameters where the gradient is at least 100 x AdamW's eps;
     within 2 lr elsewhere, see `step_errors`);
  27. the same one-step comparison for all 10 SMOKE configs in float32;
  28. save (async), restore and replay on the card (qwen2 and granite
     SMOKE configs, 6 steps, restored at 3) under deterministic
     algorithms: parameters and moments bit for bit;
  29. granite-moe-3b-a800m at full width, 3 steps of batch 4 x seq 512,
     checked as in 25;
  30. the tenth slice's path, sharding (`sharding_phases`; no kernel):
     NCCL refuses two processes on one card (its message recorded); an
     NCCL world of one, a 1 x 1 mesh: qwen2-1.5b at full width and depth
     (bf16) served (batch 4, prompt 512, 32 greedy tokens) and trained (3
     steps of batch 8 x 1,024) through `prefill_step`, `decode_step` and
     `train_step(ctx)`, equal to the same on one device (losses and
     gradient norms within 1e-6, tokens equal), step ms beside it;
  31. four processes of this script (`--sharded-rank`) share the card as
     a 2 x 2 gloo mesh (the backend printed): qwen2-1.5b at full width,
     depth cut to 4 layers, in megatron (head tensor parallelism) and
     weightgather (sequence-sharded attention) modes, a prefill and 16
     decode steps on an S-sharded cache teacher-forced on one device's
     greedy stream at the same depth (logits within 3e-2, the greedy
     token equal wherever one device's top-2 margin exceeds twice the
     step's logit difference), then 3 train steps (losses and gradient
     norms within 3e-2 of one device's); each rank's step ms,
     collective seconds (the device synchronized around each) and bytes,
     their share of the step, bytes staged through the host, peak
     memory; a 2-layer float32 twin on the card and, side by side, on the
     card machine's CPU (2 x 2 gloo, CPU tensors): loss, gradient norm
     and logits within 1e-5, tokens equal, the updated parameters under
     AdamW's first-step rule (1e-4 of a leaf's largest magnitude where
     the gradient is at least 1e-6, 2 lr elsewhere);
  32. granite-moe-3b-a800m at full width, 4 layers, global batch 4 x
     2,048 = 8,192 tokens (the sharded MoE path, per-shard capacity), 2
     train steps on the 2 x 2 gloo mesh: finite, losses and gradient
     norms within 3e-2 of one device's at the same depth; a 2-layer
     float32 twin at 8 x 520 tokens card vs CPU as in 31;
  33. `launch/train.py --arch whisper-base --tp 2 --backend gloo` as four
     processes (`repro_torch.launch.spawn`) at full width and depth, 2
     steps of batch 8 x 256 and its final checkpoint (streamed by rank
     0): rank 0 prints the mesh and `done.`;
  34. the eleventh slice's path, the dry run (`dryrun_phases`; no
     kernel): qwen2-1.5b `train` at batch 8 x 1,024, full width and
     depth, counted by `launch/dryrun.py` on a 1 x 1 dry mesh (meta
     tensors, nothing allocated) and the same step run for real on the
     card under the same `OpCounter`: counted FLOPs equal (relative gap
     <= 1e-6), argument bytes equal to the byte, the dry peak within 10 %
     of `max_memory_allocated` over the step, the measured step at or
     above the dry run's roofline bound; its compute term beside
     `train_bound`'s GEMM bound (they differ by the recompute);
  35. three production cells on meta (`DRY_CELLS`: qwen2-72b `train_4k`
     on the pod, mixtral-8x7b `decode_32k` on the multipod, zamba2-7b
     `long_500k` on the pod) under the reference's artifact checks, with
     each cell's host seconds;
  36. `run_cell(..., sim_accel="paper-128")` on the card against the
     CPU, within 1e-3;
  37. a `{"workload_plane": {...}}` line (the numbers of 21-24), a
     `{"training": {...}}` line (25-29), a `{"sharding": {...}}` line
     (30-33), a `{"dryrun": {...}}` line (34-36), a `{"kernels": [...]}`
     line (all five kernels), the nvidia-smi line, and last `{"ok": true,
     "device": {...}}`.

`python3 chip_smoke.py --sharded-rank JOBS.json` is one rank of phase
31-32's worlds (started by the script itself).

Writes the measurements to chiprun_out/chip_smoke.json as well.
"""
import json
import math
import os
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
# and the dense bfloat16 tensor-core rate (the served model's products)
BF16_OPS_PER_S = 989e12
RTOL = 1e-3
# 16 cores on 16 private channels: the largest per-core gap between the
# merged and the isolated replays this script accepts (the contract's
# 1e-6 is reported beside it; see the contention_16_cores phase)
PRIVATE_GAP_LIMIT = 1e-4


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def phase(name: str, **kv):
    print(f"phase {name}: " + json.dumps(kv, default=str), flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max(|b|, 1)."""
    if a.numel() == 0:
        return 0.0
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


# the metric columns a NoC-free design's row leaves NaN
NOC_COLUMNS = ("noc_stall_cycles", "noc_link_util", "allreduce_cycles")


def frame_rel_err(res, ref, noc_free=()) -> dict:
    """Per metric column of two study frames: max |a - b| / |b|; inf where
    a value is NaN in either frame, except in the NoC columns on the rows
    of the designs named in `noc_free` (designs without a NoC), which
    must be NaN in both."""
    out = {}
    skip = np.isin(np.asarray(res["design"]), list(noc_free))
    for c in res.column_names():
        if c in ("design", "workload", "fidelity"):
            continue
        a, b = np.asarray(res[c], float), np.asarray(ref[c], float)
        if a.shape != b.shape:
            out[c] = float("inf")
            continue
        nan = skip if c in NOC_COLUMNS else np.zeros(len(a), bool)
        if not (np.isnan(a[nan]).all() and np.isnan(b[nan]).all()) \
                or np.isnan(a[~nan]).any() or np.isnan(b[~nan]).any():
            out[c] = float("inf")
            continue
        out[c] = float(np.max(np.abs(a[~nan] - b[~nan])
                              / np.maximum(np.abs(b[~nan]), 1e-30),
                              initial=0.0))
    return out


def feature_sweep_study(wl=None):
    """Phase 6's feature sweep: 162 designs (array, SRAM, dataflow,
    sparsity, cores) and their layout-on twins over resnet18 and vit_base
    (`wl`, built here when None) at fast and trace. Returns (the base
    designs, all designs, the study)."""
    import repro_torch as rt
    from repro_torch.core.accelerator import LayoutConfig
    from repro_torch.core.workloads import resnet18, vit_base
    if wl is None:
        wl = {"resnet18": resnet18(), "vit_base": vit_base()}
    base = rt.preset_grid(array=[32, 64, 128], sram_mb=[0.5, 2, 8],
                          dataflow=["ws", "os", "is"],
                          sparsity=[None, "2:4", "1:4-rw"], cores=[1, 4])
    lay_cfg = LayoutConfig(enabled=True)
    feat = base + [c.with_(layout=lay_cfg) for c in base]
    study = rt.Study("feature_sweep").designs(feat).workloads(wl) \
        .fidelity("fast", "trace")
    return base, feat, study


def feature_cpu_cells(shard: int, n: int, threads: int) -> dict:
    """Shard `shard` of n of the feature sweep's cells, run on the CPU in
    this process (one of `cpu_feature_frame`'s): whole batch groups, every
    n-th of them ordered by fidelity (so each shard gets its share of the
    costly trace groups), and the fallback cells on shard 0."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(threads)
    _, _, study = feature_sweep_study()
    plan = study.plan()
    order = sorted(range(len(plan.groups)),
                   key=lambda g: plan.groups[g].fidelity)
    cells = [c for g in order[shard::n] for c in plan.groups[g].cells]
    if shard == 0:
        cells += list(plan.fallback)
    res, _, _ = study._execute_cells(plan, cells, device="cpu")
    return res


def cpu_feature_frame(study, n: int = 4, threads: int = 2):
    """The feature sweep's whole frame on the CPU, its cells split over n
    spawned processes and put together by `Study.assemble_frame` (a farm
    client's path: with every cell present, a local run's frame). One
    process took 150-221 s of the script's time limit."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(
            n, mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = list(pool.map(feature_cpu_cells, range(n), [n] * n,
                              [threads] * n))
    results = {}
    for part in parts:
        results.update(part)
    return study.assemble_frame(results, executed_cells=len(results),
                                plan=study.plan(), device="cpu")


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


def profile_run(fn, kernels=()) -> dict:
    """Wall time of one `fn()` under torch.profiler, the device busy time
    (kernels and copies), the top device operations, and for each name in
    `kernels` the device ms and calls of the operations whose name holds
    it (`kernel_ms`). The device alone is traced: host-op tracing adds
    its overhead to the wall, and a run of hundreds of thousands of host
    operations takes the profiler a minute to aggregate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    kernel_ms = {name: dict(ms=sum(v[0] for k, v in dev_ms.items()
                                   if name in k),
                            calls=sum(v[1] for k, v in dev_ms.items()
                                      if name in k))
                 for name in kernels}
    return dict(profiled_wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                device_busy_share=(busy_ms / (wall * 1e3)) if busy_ms
                else None,
                top_device_ops=[dict(name=k[:80], ms=v[0], calls=v[1])
                                for k, v in top], kernel_ms=kernel_ms)


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


def timed_graph(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean milliseconds of the device work of one `fn()` call, by CUDA
    events around replays of a CUDA graph of `reps` calls (after a warm-up
    call and a warm-up replay): the host's launch cost, which exceeds a
    small kernel's time, is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (reps * replays)
    del graph
    return ms


def within(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float):
    """(all |a - b| <= atol + rtol |b|, max |a - b|), compared in float32."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    if a.shape != b.shape:
        return False, float("inf")
    if a.numel() == 0:
        return True, 0.0
    d = (a - b).abs()
    return bool((d <= atol + rtol * b.abs()).all()), float(d.max())


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




def replay_shape_info(mk, ins, kw) -> dict:
    """One replay launch at a path's shape (prepared (S, npad) inputs):
    ms per launch through the wrapper (CUDA events; its id check syncs),
    the kernel alone (graph replays without the check), the plain version
    on the card, counts equal and completions within RTOL of it, and the
    least time: the bytes the function must move, each once (issue time,
    bank, channel and row as 4-byte words, the write and valid flags as a
    bit each, the completion out, shift and counts per stream) against the
    operations it needs (8 order-only tables per valid request and chunk,
    3 keyed maxima per fixed-point pass, over this run's passes)."""
    S, npad = ins[0].shape
    C = kw["C"]
    ms = timed_cuda(lambda: mk.launch_cuda(ins, **kw), reps=20)
    graph_ms = timed_graph(lambda: mk.launch_cuda(ins, check_ids=False, **kw))
    dk, sk, ck_ = mk.launch_cuda(ins, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp, sp, cp, passes = mk.run_plain(ins, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(ck_, cp):
        fail(f"replay at {S} x {npad}: kernel counts differ from plain")
    err = max(rel_err(dk, dp), rel_err(sk, sp))
    if err > RTOL:
        fail(f"replay at {S} x {npad}: kernel differs from plain by {err}")
    nv = ins[5].reshape(S, npad // C, C).sum(-1).to(torch.float64)
    ops = float(((8 + 3 * passes.to(torch.float64)) * nv).sum())
    nbytes = S * npad * (4 + 3 * 4) + S * npad // 4 + S * npad * 4 \
        + S * (4 + 16)
    bms = nbytes / HBM_BYTES_PER_S * 1e3
    oms = ops / FP32_OPS_PER_S * 1e3
    return dict(streams=S, requests_per_stream=npad,
                valid_requests=int(ins[5].sum()), ms=ms, graph_ms=graph_ms,
                plain_ms=plain_ms, max_abs_err=float((dk - dp).abs().max()),
                max_rel_err=err, mean_passes=float(passes.double().mean()),
                max_passes=int(passes.max()), bytes=nbytes, ops=ops,
                bytes_ms=bms, ops_ms=oms, bound_ms=max(bms, oms),
                bound_by="bytes" if bms >= oms else "operations")


def perop_phases(report: dict) -> dict:
    """The sixth slice's path: the per-op engine (`Simulator`, `cycle`
    fidelity, `force_fallback`) on the card. Returns the launches of its
    counted runs and the two kernels' times at the per-op shapes."""
    import tempfile

    import repro_torch as rt
    from repro_torch.api.presets import as_sparsity, get_preset, with_cores
    from repro_torch.core.accelerator import (DramConfig, LayoutConfig,
                                              SparsityConfig,
                                              tpu_like_config)
    from repro_torch.core.dram import (linear_trace, simulate_dram,
                                       tile_prefetch_trace)
    from repro_torch.core.engine import simulate_network
    from repro_torch.core.workloads import (resnet18, resnet18_six_layers,
                                            vit_base, vit_base_linear)
    from repro_torch.kernels.conflict import conflict as ck
    from repro_torch.kernels.conflict.ref import conflict_slowdown_reference
    from repro_torch.kernels.replay import megakernel as mk

    out = dict(replay=0, conflict=0)
    op_fields = ("compute_cycles", "stall_cycles", "layout_extra_cycles",
                 "total_cycles", "utilization", "sram_reads", "sram_writes",
                 "dram_bytes", "energy_pj", "noc_stall_cycles")
    counts = ("row_hits", "row_misses", "row_conflicts")

    def report_vs_cpu(name, card, cpu, n_ops=None):
        """Every OpResult (the first `n_ops`) of a card run against the
        CPU's: fields within RTOL, energies by action within RTOL,
        row-buffer counts exact."""
        worst = 0.0
        for a, b in list(zip(card.ops, cpu.ops))[:n_ops]:
            pairs = [(getattr(a, f), getattr(b, f)) for f in op_fields]
            pairs += [(a.energy_by_action[k], v)
                      for k, v in (b.energy_by_action or {}).items()]
            if b.dram_stats:
                if any(a.dram_stats[k] != b.dram_stats[k] for k in counts):
                    fail(f"{name}: {a.name} row counts "
                         f"{[a.dram_stats[k] for k in counts]} on the card, "
                         f"{[b.dram_stats[k] for k in counts]} on the CPU")
                pairs += [(a.dram_stats[k], v)
                          for k, v in b.dram_stats.items()]
            for x, y in pairs:
                e = abs(x - y) / max(abs(y), 1e-30) if x != y else 0.0
                worst = max(worst, e)
        if not worst <= RTOL:
            fail(f"{name}: card ops differ from the CPU's by {worst}")
        return worst

    def counted_run(sim, ops):
        """One run with both kernels' counts set to 0 just before it and
        read just after; host wall."""
        mk.LAUNCHES = ck.LAUNCHES = 0
        t0 = time.perf_counter()
        rep = sim.run(ops)
        wall = time.perf_counter() - t0
        return rep, wall, mk.LAUNCHES, ck.LAUNCHES

    def capture(fn, mod, attr):
        """Run fn() with `mod.attr` recording the arguments of its largest
        call (the path's own inputs, to time the kernel at that shape)."""
        orig, seen = getattr(mod, attr), {}

        def rec(*a, **k):
            first = a[0][0] if isinstance(a[0], tuple) else a[0]
            size = first.numel()
            if size > seen.get("size", -1):
                seen.update(size=size, args=a, kw=k)
            return orig(*a, **k)

        setattr(mod, attr, rec)
        try:
            fn()
        finally:
            setattr(mod, attr, orig)
        return seen["args"], seen["kw"]

    # ---- 13. vit_base through the per-op engine, full width ---------------
    ops = vit_base()
    n_gemm = sum(o.kind == "gemm" for o in ops)
    info, shapes = {}, {}
    for fid in ("fast", "cycle", "trace"):
        sim = rt.Simulator("paper-128", fidelity=fid)
        rep, wall, launches, _ = counted_run(sim, ops)
        want = 0 if fid == "fast" else n_gemm
        if launches != want:
            fail(f"perop_vit_base {fid}: {launches} replay launches, "
                 f"expected {want}")
        if rep.engine != ("" if fid == "fast" else "cuda"):
            fail(f"perop_vit_base {fid}: engine {rep.engine!r}")
        if not np.isfinite(rep.total_cycles) or rep.total_cycles <= 0:
            fail(f"perop_vit_base {fid}: total cycles {rep.total_cycles}")
        out["replay"] += launches
        walls = [wall]
        for _ in range(2):
            t0 = time.perf_counter()
            sim.run(ops)
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        cpu = rt.Simulator("paper-128", fidelity=fid, device="cpu").run(ops)
        cpu_s = time.perf_counter() - t0
        worst = report_vs_cpu(f"perop_vit_base {fid}", rep, cpu)
        prof = profile_run(lambda: sim.run(ops), kernels=("replay",))
        info[fid] = dict(
            ops=len(ops), gemm_ops=n_gemm, launches=launches,
            engine=rep.engine, total_cycles=rep.total_cycles,
            stall_cycles=rep.stall_cycles, energy_pj=rep.energy_pj,
            wall_s_runs=walls, wall_s_median=float(np.median(walls)),
            host_ms_per_op=float(np.median(walls)) * 1e3 / len(ops),
            cpu_wall_s=cpu_s, ops_held_vs_cpu=len(cpu.ops),
            max_rel_vs_cpu=worst,
            requests_per_op=[o.dram_stats and int(
                o.dram_stats["row_hits"] + o.dram_stats["row_misses"]
                + o.dram_stats["row_conflicts"]) for o in rep.ops
                if o.kind == "gemm"][:8],
            device_busy_share=prof["device_busy_share"],
            device_busy_ms=prof["device_busy_ms"],
            profiled_wall_ms=prof["profiled_wall_ms"],
            replay_device_ms=prof["kernel_ms"]["replay"],
            top_device_ops=prof["top_device_ops"][:4])
        phase(f"perop_vit_base_{fid}", **info[fid])
        if fid != "fast":
            shapes[f"{fid}_vit_base"] = capture(lambda: sim.run(ops), mk,
                                                "launch_cuda")
    report["perop_vit_base"] = info

    # the replay kernel at the per-op shapes: a trace stream (1 x cap =
    # 4,096), vit_base's largest cycle stream, and a cycle stream at the
    # cap (1 x 16,384: resnet18's conv1 on paper-128, scaled past it)
    shapes["cycle_cap"] = capture(lambda: rt.Simulator(
        "paper-128", fidelity="cycle").run_op(resnet18()[0]), mk,
        "launch_cuda")
    per_op = {}
    for fid, (args, kw) in shapes.items():
        per_op[fid] = replay_shape_info(mk, args[0], kw)
    phase("replay_per_op_shapes", **per_op)
    report["replay_per_op_shapes"] = per_op

    # ---- 14. resnet18 with the layout stage at trace --------------------------
    lsim = rt.Simulator("paper-32", fidelity="trace").with_(
        layout=LayoutConfig(enabled=True))
    r18 = resnet18()
    r18_gemm = sum(o.kind == "gemm" for o in r18)
    rep, wall, rl, cl = counted_run(lsim, r18)
    if (rl, cl) != (r18_gemm, r18_gemm):
        fail(f"perop_layout_resnet18: {rl} replay and {cl} conflict "
             f"launches, expected {r18_gemm} each")
    out["replay"] += rl
    out["conflict"] += cl
    t0 = time.perf_counter()
    lcpu = rt.Simulator("paper-32", fidelity="trace", device="cpu").with_(
        layout=LayoutConfig(enabled=True)).run(r18)
    lcpu_s = time.perf_counter() - t0
    lworst = report_vs_cpu("perop_layout_resnet18", rep, lcpu)
    if rep.layout_extra_cycles <= 0.0:
        fail("perop_layout_resnet18: no layout cycles")
    linfo = dict(ops=len(r18), replay_launches=rl, conflict_launches=cl,
                 engine=rep.engine, wall_s=wall, cpu_wall_s=lcpu_s,
                 layout_extra_cycles=rep.layout_extra_cycles,
                 layout_share=rep.layout_extra_cycles / rep.total_cycles,
                 total_cycles=rep.total_cycles, max_rel_vs_cpu=lworst)
    phase("perop_layout_resnet18", **linfo)
    report["perop_layout_resnet18"] = linfo
    # the conflict kernel at the per-op shape: one op's window
    (line, bank), ckw = capture(lambda: lsim.run(r18), ck, "conflict_slowdown")
    c_ms = timed_graph(lambda: ck.conflict_slowdown(line, bank, **ckw))
    if not torch.equal(ck.conflict_slowdown(line, bank, **ckw),
                       conflict_slowdown_reference(line, bank, **ckw)):
        fail("conflict kernel at the per-op shape differs from plain")
    c_plain = host_ms(lambda: conflict_slowdown_reference(line, bank, **ckw),
                      reps=5)
    rows, k = line.shape
    cb = rows * k * 8 + rows * 4
    co = rows * k * np.log2(max(k, 2))
    cbm, com = cb / HBM_BYTES_PER_S * 1e3, co / FP32_OPS_PER_S * 1e3
    conflict_op = dict(rows=int(rows), k=int(k), ms=c_ms, plain_ms=c_plain,
                       bytes=cb, ops=co, bound_ms=max(cbm, com),
                       bound_by="bytes" if cbm >= com else "operations")
    phase("conflict_per_op_shape", **conflict_op)
    report["conflict_per_op_shape"] = conflict_op

    # ---- 15. the paper's claims through the per-op engine, on the card ------
    claims = {}
    base = {}
    for nm in (None, (2, 4), (1, 4)):
        cfg = tpu_like_config(array=32, sram_mb=0.5)
        if nm:
            cfg = cfg.with_(sparsity=SparsityConfig(enabled=True, n=nm[0],
                                                    m=nm[1]))
        base[nm] = simulate_network(cfg, r18).total_cycles
    small = simulate_network(tpu_like_config(array=32, sram_mb=0.25),
                             r18).total_cycles
    big = simulate_network(tpu_like_config(array=32, sram_mb=4.0),
                           r18).total_cycles
    claims["fig5_sparser_is_faster"] = base[(1, 4)] < base[(2, 4)] < base[None]
    claims["fig5_more_sram_is_faster"] = big < small
    t, a, w = linear_trace(4096, issue_gap=0.25)
    th1 = float(simulate_dram(t, a, w, DramConfig(channels=1)).throughput)
    th8 = float(simulate_dram(t, a, w, DramConfig(channels=8)).throughput)
    claims["fig9_8_channels_over_5x_1"] = th8 > 5 * th1
    t, a, w = tile_prefetch_trace(tile_bytes=20 * 1024, n_tiles=64,
                                  compute_per_tile=400, gran_bytes=64)
    tot = {q: float(simulate_dram(t, a, w, DramConfig(
        channels=2, read_queue=q, write_queue=q)).total_cycles)
        for q in (32, 128, 512)}
    claims["fig10_queue_steps_shrink"] = (
        tot[32] > tot[128] >= tot[512]
        and (tot[32] - tot[128]) > (tot[128] - tot[512]))
    gaps = {}
    for cores, arr in ((1, 128), (16, 32)):
        lat = {df: simulate_network(tpu_like_config(
            array=arr, cores=cores, dataflow=df),
            vit_base_linear()).compute_cycles for df in ("ws", "is")}
        gaps[cores] = lat["is"] / lat["ws"]
    claims["table6_multicore_narrows_gap"] = \
        abs(1 - gaps[16]) < 0.5 * abs(1 - gaps[1])
    wins, energies = 0, {}
    for arr in (32, 64):
        e = {df: simulate_network(tpu_like_config(array=arr, dataflow=df),
                                  r18).energy_pj for df in ("ws", "is", "os")}
        energies[arr] = e
        wins += e["os"] <= min(e["ws"], e["is"]) * 1.02
    claims["fig15_os_wins_energy"] = wins >= 1
    cinfo = dict(claims=claims, fig5_total_cycles={str(k): v for k, v in
                                                   base.items()},
                 fig5_sram_025_vs_4=[small, big], fig9_throughput=[th1, th8],
                 fig10_total_cycles=tot, table6_gaps=gaps,
                 fig15_energy_pj=energies)
    phase("paper_claims_perop", **cinfo)
    report["paper_claims_perop"] = cinfo
    if not all(claims.values()):
        fail(f"paper_claims_perop: {claims}")

    # ---- 16. force_fallback parity: the per-op oracle on the card ----------
    rng = np.random.default_rng(18)
    mixed = {}
    for i in range(24):
        cfg = get_preset("tpu-like", array=int(rng.choice([8, 16, 32])),
                         sram_mb=float(rng.choice([0.25, 1.0])))
        cfg = cfg.with_(dataflow=str(rng.choice(["ws", "os", "is"])))
        cores = int(rng.choice([1, 4]))
        if cores > 1:
            cfg = with_cores(cfg, cores)
        sp = [None, "2:4", "1:4", "2:8-rw"][int(rng.integers(4))]
        if sp is not None:
            cfg = cfg.with_(sparsity=as_sparsity(sp))
        if rng.random() < 0.5:
            cfg = cfg.with_(layout=LayoutConfig(enabled=True))
        mixed[f"d{i}-{cores}c-{sp}"] = cfg
    pods = {f"{topo}-{p}c": get_preset("pod-mesh", cores=p, topology=topo)
            for topo in ("mesh", "torus") for p in (16, 64)}
    parity_cols = ("total_cycles", "compute_cycles", "stall_cycles",
                   "dram_bytes", "energy_pj", "utilization", "edp",
                   "energy_mac_pj", "energy_sram_pj", "energy_dram_pj",
                   "energy_static_pj")
    pinfo = {}
    for name, designs, fid, cols in (
            ("mixed_fast", mixed, "fast", parity_cols),
            ("mixed_trace", mixed, "trace", parity_cols),
            ("pods_fast", pods, "fast", parity_cols + NOC_COLUMNS)):
        def mk_study():
            return (rt.Study(name).designs(designs)
                    .workloads({"resnet18": r18}).fidelity(fid))
        runs = {}
        for mode in ("batched", "per_op"):
            s = mk_study().options(force_fallback=mode == "per_op")
            mk.LAUNCHES = ck.LAUNCHES = 0
            t0 = time.perf_counter()
            fr = s.run()
            wall = time.perf_counter() - t0
            runs[mode] = (fr, dict(wall_s=wall, replay_launches=mk.LAUNCHES,
                                   conflict_launches=ck.LAUNCHES))
            out["replay"] += mk.LAUNCHES
            out["conflict"] += ck.LAUNCHES
            if fr.failed_cells or len(fr) != len(designs):
                fail(f"force_fallback_parity {name} {mode}: "
                     f"{len(fr)} rows, failed {fr.failed_cells}")
        fb, fo = runs["batched"][0], runs["per_op"][0]
        if fb.fraction_batched != 1.0 or fo.fraction_batched != 0.0:
            fail(f"force_fallback_parity {name}: batched shares "
                 f"{fb.fraction_batched}, {fo.fraction_batched}")
        errs = {}
        for c in cols:
            a, b = np.asarray(fb[c], float), np.asarray(fo[c], float)
            if not np.array_equal(np.isnan(a), np.isnan(b)) \
                    or (c not in NOC_COLUMNS and np.isnan(a).any()):
                fail(f"force_fallback_parity {name}: NaN pattern of {c}")
            ok = ~np.isnan(b)
            errs[c] = float(np.max(np.abs(a[ok] - b[ok])
                                   / np.maximum(np.abs(b[ok]), 1.0),
                                   initial=0.0))
        if max(errs.values()) > RTOL:
            fail(f"force_fallback_parity {name}: {errs}")
        pinfo[name] = dict(designs=len(designs), fidelity=fid,
                           batched=runs["batched"][1],
                           per_op=runs["per_op"][1],
                           max_rel=max(errs.values()), max_rel_by_column=errs)
        phase(f"force_fallback_parity_{name}", **pinfo[name])
    report["force_fallback_parity"] = pinfo

    # ---- 17. a cycle-fidelity Study, its CPU twin and its cache -------------
    flip = rt.studies.dataflow_dram_flip()
    cstudy = (rt.Study("cycle_study").designs(dict(flip._designs))
              .workloads({"resnet18-6": resnet18_six_layers()})
              .fidelity("fast", "cycle", "trace"))
    mk.LAUNCHES = ck.LAUNCHES = 0
    t0 = time.perf_counter()
    cres = cstudy.run()
    cwall = time.perf_counter() - t0
    c_launches = mk.LAUNCHES
    out["replay"] += c_launches
    if c_launches != 2 * 6 + 2:       # 6 gemm ops per cycle cell, 2 groups
        fail(f"cycle_study: {c_launches} replay launches, expected 14")
    check_frame("cycle_study", cres, 6)
    t0 = time.perf_counter()
    ccpu = cstudy.run(device="cpu")
    ccpu_s = time.perf_counter() - t0
    cerr = frame_rel_err(cres, ccpu)
    if max(cerr.values()) > RTOL:
        fail(f"cycle_study: card frame differs from the CPU's: {cerr}")
    cache_root = ROOT / "build"
    cache_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cache_root) as tmp:
        fill = cstudy.cache(tmp).run()
        again = cstudy.run()
    if fill.executed_cells != 6 or again.cache_hits != 6 \
            or again.executed_cells != 0 or not again.equals(cres) \
            or not fill.equals(cres):
        fail(f"cycle_study cache: filled {fill.executed_cells}, then "
             f"{again.cache_hits} hits / {again.executed_cells} executed, "
             f"equal {again.equals(cres)}")
    sinfo = dict(rows=len(cres), launches=c_launches, wall_s=cwall,
                 cpu_wall_s=ccpu_s, engine=cres.meta["engine"],
                 max_rel_vs_cpu=max(cerr.values()),
                 max_rel_vs_cpu_by_column=cerr,
                 cache_filled=fill.executed_cells,
                 cache_hits=again.cache_hits, cached_frame_equal=True,
                 total_cycles=dict(zip(
                     [f"{d}/{f}" for d, f in zip(cres["design"],
                                                cres["fidelity"])],
                     cres["total_cycles"])))
    phase("cycle_study", **sinfo)
    report["cycle_study"] = sinfo
    out.update(replay_per_op=per_op, conflict_per_op=conflict_op)
    return out


def search_rounds(log_json: str):
    """[(kind, fidelity, cohort, parents, best row)] of a SearchLog."""
    return [(e["kind"], e["fidelity"], e["cohort"], e["parents"], e["best"])
            for e in json.loads(log_json)["rounds"]]


def orchestration_phases(report: dict) -> dict:
    """The seventh slice's path: the design-space search, the run-farm and
    the chaos soak on the card. Returns the replay and conflict launches
    of its counted runs."""
    import os
    import tempfile

    import repro_torch as rt
    import repro_torch.search.driver as sdrv
    from repro_torch.core.workloads import vit_linear
    from repro_torch.farm import __main__ as farm_cli
    from repro_torch.kernels.conflict import conflict as ck
    from repro_torch.kernels.replay import megakernel as mk
    from repro_torch.search import table_v_space

    out = dict(replay=0, conflict=0)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    cuda = torch.device("cuda")

    # ---- 18. search_edp at full width: 12 layers, a screen of 1,536 ---------
    study = rt.studies.search_edp()
    mk.LAUNCHES = ck.LAUNCHES = 0
    t0 = time.perf_counter()
    res = study.run()                   # the default: the card
    wall = time.perf_counter() - t0
    launches = dict(replay=mk.LAUNCHES, conflict=ck.LAUNCHES)
    out["replay"] += launches["replay"]
    out["conflict"] += launches["conflict"]
    claims = res.check_claims()
    if len(claims) != 7 or not all(claims.values()):
        fail(f"search_edp_full: claims {claims}")
    if res.meta.get("engine") != "cuda" or res.meta.get("device") != "cuda":
        fail(f"search_edp_full: engine {res.meta.get('engine')!r} on "
             f"{res.meta.get('device')!r}")
    if not launches["replay"] or not launches["conflict"]:
        fail(f"search_edp_full: launches {launches}")
    if res.failed_cells or len(res) != int(res.meta["spent_evals"]):
        fail(f"search_edp_full: {len(res)} rows, failed {res.failed_cells}")
    for c in ("total_cycles", "energy_pj", "edp", "stall_cycles"):
        if not np.isfinite(np.asarray(res[c], float)).all():
            fail(f"search_edp_full: non-finite {c}")
    rounds = search_rounds(res.meta["search_log"])

    # one more cold pass of the driver under the profiler (the card's busy
    # share), each round's cells and the host's promotions and proposals
    # timed on their own
    timed, host = [], dict(promote_s=0.0, propose_s=0.0)

    def timer(fn, key):
        def run(*a, **k):
            t1 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[key] += time.perf_counter() - t1
        return run

    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        drv = study._make_driver(tmp, cuda)
        inner = drv._eval_cohort

        def eval_timed(round_idx, fid, points):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = inner(round_idx, fid, points)
            torch.cuda.synchronize()
            timed.append(dict(round=round_idx, fidelity=fid,
                              cells=len(points),
                              wall_s=time.perf_counter() - t1))
            return r

        drv._eval_cohort = eval_timed
        promote, propose = sdrv.promote, sdrv.propose
        sdrv.promote = timer(promote, "promote_s")
        sdrv.propose = timer(propose, "propose_s")
        cold = {}
        try:
            prof = profile_run(lambda: cold.update(r=drv.run()),
                               kernels=("replay", "conflict"))
        finally:
            sdrv.promote, sdrv.propose = promote, propose
    if cold["r"].log.digest() != res.meta["search_log_digest"]:
        fail("search_edp_full: a second cold pass logged another search")
    sinfo = dict(claims=claims, rows=len(res), wall_s_two_passes=wall,
                 cold_pass_s=prof["profiled_wall_ms"] / 1e3, **host,
                 screen_s=sum(r["wall_s"] for r in timed
                              if r["round"] == 0),
                 propose_rounds_s=sum(r["wall_s"] for r in timed
                                      if r["round"] > 0
                                      and r["fidelity"] == "fast"),
                 trace_rung_s=sum(r["wall_s"] for r in timed
                                  if r["fidelity"] == "trace"),
                 rounds=timed, launches=launches, engine=res.meta["engine"],
                 winner=res.meta["winner"],
                 spent_evals=res.meta["spent_evals"],
                 exhaustive_cells=res.meta["exhaustive_cells"],
                 replay_identical=res.meta["replay_identical"],
                 cohorts=[(k, f, len(c)) for k, f, c, _, _ in rounds],
                 device_busy_share=prof["device_busy_share"], profile=prof)
    phase("search_edp_full", **{k: v for k, v in sinfo.items()
                                if k != "profile"})
    report["search_edp_full"] = sinfo

    # the smoke search on the card and on the card machine's CPU: the same
    # cohorts and parents round for round, the best rows within RTOL
    smoke = rt.studies.search_edp(smoke=True)
    mk.LAUNCHES = ck.LAUNCHES = 0
    t0 = time.perf_counter()
    card = smoke.run()
    card_s = time.perf_counter() - t0
    smoke_launches = dict(replay=mk.LAUNCHES, conflict=ck.LAUNCHES)
    out["replay"] += mk.LAUNCHES
    out["conflict"] += ck.LAUNCHES
    t0 = time.perf_counter()
    cpu = smoke.run(device="cpu")
    cpu_s = time.perf_counter() - t0
    ra, rb = (search_rounds(card.meta["search_log"]),
              search_rounds(cpu.meta["search_log"]))
    if len(ra) != len(rb) or not all(card.check_claims().values()):
        fail(f"search_edp smoke: {len(ra)} rounds on the card, {len(rb)} "
             f"on the CPU; claims {card.check_claims()}")
    worst = 0.0
    for a, b in zip(ra, rb):
        if a[:4] != b[:4]:
            fail(f"search_edp smoke: the {a[0]} round at {a[1]}: cohorts "
                 f"or parents differ between the card and the CPU")
        for m, v in b[4].items():
            if m not in ("design", "workload", "fidelity"):
                worst = max(worst, abs(a[4][m] - v) / max(abs(v), 1e-30))
    if worst > RTOL:
        fail(f"search_edp smoke: best rows differ by {worst}")
    minfo = dict(card_wall_s=card_s, cpu_wall_s=cpu_s, rounds=len(ra),
                 cohorts_and_parents_equal=True, best_max_rel_vs_cpu=worst,
                 launches=smoke_launches)
    phase("search_edp_smoke_vs_cpu", **minfo)
    report["search_edp_smoke_vs_cpu"] = minfo

    # shard splits on the search path: the trace rung's 16 designs and 96
    # screened designs, each batched group cut into shards of 1, 2 and 5
    # through `_execute_cells`, equal one local run bit for bit
    space = table_v_space()
    log = json.loads(res.meta["search_log"])["rounds"]
    want = {"trace": log[-1]["cohort"], "fast": log[0]["cohort"][:96]}
    wanted = set(want["trace"]) | set(want["fast"])
    configs = {}
    for p in space.points():
        lab = space.label(p)
        if lab in wanted:
            configs[lab] = space.config(p)
    ops = vit_linear(768, 12, 3072, prefix="vitb")
    splits = {}
    for fid, labels in want.items():
        s = (rt.Study(f"splits-{fid}")
             .designs({lab: configs[lab] for lab in labels})
             .workloads({"vit-base": ops}).fidelity(fid))
        plan = s.plan()
        mk.LAUNCHES = ck.LAUNCHES = 0
        local = s.run()
        for size in (1, 2, 5):
            got, n = {}, 0
            for grp in plan.groups:
                for i in range(0, len(grp.cells), size):
                    r, _, _ = s._execute_cells(plan, grp.cells[i:i + size])
                    got.update(r)
                    n += 1
            frame = s.assemble_frame(got, plan=plan, device=cuda)
            bad = [c for c in local.columns
                   if not np.array_equal(np.asarray(frame[c]),
                                         np.asarray(local[c]))]
            if bad or not frame.equals(local):
                fail(f"search shard splits, {fid} in shards of {size}: "
                     f"{bad} differ from the local run")
            splits[f"{fid}_shards_of_{size}"] = dict(
                designs=len(labels), groups=len(plan.groups), shards=n,
                bit_identical=True)
        out["replay"] += mk.LAUNCHES
        out["conflict"] += ck.LAUNCHES
    phase("search_shard_splits", **splits)
    report["search_shard_splits"] = splits

    # ---- 19. the farm: a broker thread, two worker processes on the card ----
    # `farm smoke --compare-local` runs edp_array_size locally on the card,
    # then through both workers once each has sent a heartbeat, and exits
    # non-zero unless the frame equals the local run bit for bit
    with tempfile.TemporaryDirectory(dir=scratch) as root:
        path = os.path.join(root, "FARM_metrics.json")
        rc = farm_cli._main(["smoke", "--root", os.path.join(root, "farm"),
                             "--device", "cuda", "--compare-local",
                             "--metrics", path, "--timeout", "600"])
        metrics = json.loads(open(path).read())
    sm = metrics["smoke"]
    if rc != 0 or not sm.get("bit_identical"):
        fail(f"farm_smoke: rc {rc}, columns "
             f"{sm.get('mismatched_columns')} differ from the local card run")
    if len(sm["claims"]) != 4 or not all(sm["claims"].values()):
        fail(f"farm_smoke: claims {sm['claims']}")
    per_worker = {w: dict(cells=st.get("cells_done", 0),
                          shards=st.get("shards_done", 0),
                          busy_s=st.get("busy_seconds", 0.0))
                  for w, st in metrics["workers"].items()}
    finfo = dict(wall_s_submit_to_frame=sm["seconds"],
                 workers_start_s=sm["workers_start_s"], shards=sm["shards"],
                 per_worker=per_worker,
                 requeued=metrics["requeued_shards"], claims=sm["claims"],
                 bit_identical=True, engine=sm["engine"],
                 device=sm["device"])
    phase("farm_smoke", **finfo)
    report["farm_smoke"] = finfo

    # ---- 20. the chaos soak in process on the card ---------------------------
    with tempfile.TemporaryDirectory(dir=scratch) as root:
        path = os.path.join(root, "FAULTS_report.json")
        mk.LAUNCHES = ck.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = farm_cli._main(["chaos", "--root", root, "--device", "cuda",
                             "--report", path, "--timeout", "300"])
        chaos_s = time.perf_counter() - t0
        out["replay"] += mk.LAUNCHES
        out["conflict"] += ck.LAUNCHES
        chaos = json.loads(open(path).read())
    if rc != 0 or sorted(chaos) != ["lease-storms", "torn-writes",
                                    "worker-kills"]:
        fail(f"farm_chaos: rc {rc}, schedules {sorted(chaos)}")
    for name, e in chaos.items():
        if not (e["ok"] and e["bit_identical"] and e["claims_ok"]):
            fail(f"farm_chaos {name}: {e}")
    if chaos["worker-kills"]["worker_kills"] < 1:
        fail("farm_chaos: no worker was killed under worker-kills")
    cinfo = dict(wall_s=chaos_s, schedules={
        name: dict(seconds=e["seconds"], rounds=e["rounds"],
                   worker_kills=e["worker_kills"],
                   requeued=e["requeued_shards"],
                   injected=e["faults"]["total_injected"],
                   bit_identical=e["bit_identical"])
        for name, e in chaos.items()})
    phase("farm_chaos", **cinfo)
    report["farm_chaos"] = cinfo
    return out


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| over two tensors of one shape (in float64 on
    the CPU); inf where the shapes differ or a value is not finite."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    if a.shape != b.shape or not (torch.isfinite(a).all()
                                  and torch.isfinite(b).all()):
        return float("inf")
    if a.numel() == 0:
        return 0.0
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def tree_rel(a, b) -> float:
    """The largest `max_rel` over the leaves of two cache trees."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return float("inf")
        return max(tree_rel(a[k], b[k]) for k in a)
    return max_rel(a, b)


def all_within(errs: dict, tol: float = RTOL) -> bool:
    """Every error finite and at most `tol` (a NaN fails)."""
    return all(math.isfinite(v) and v <= tol for v in errs.values())


def reset_launch_counts():
    """Every kernel wrapper's launch count to 0."""
    from repro_torch.kernels.conflict import conflict as ck
    from repro_torch.kernels.ellpack import ellpack as ek
    from repro_torch.kernels.replay import megakernel as mk
    from repro_torch.kernels.systolic import systolic as syk
    mk.LAUNCHES = ck.LAUNCHES = ek.LAUNCHES = 0
    syk.MATMUL_LAUNCHES = syk.WAVEFRONT_LAUNCHES = 0


def launch_counts() -> dict:
    from repro_torch.kernels.conflict import conflict as ck
    from repro_torch.kernels.ellpack import ellpack as ek
    from repro_torch.kernels.replay import megakernel as mk
    from repro_torch.kernels.systolic import systolic as syk
    return dict(replay=mk.LAUNCHES, conflict=ck.LAUNCHES,
                ellpack=ek.LAUNCHES, matmul=syk.MATMUL_LAUNCHES,
                wavefront=syk.WAVEFRONT_LAUNCHES)


def no_launches(name, c):
    """The workload plane and the co-simulation launch no kernel."""
    if any(c.values()):
        fail(f"{name}: kernel launches {c}, expected none")


def workload_phases(report: dict) -> dict:
    """The eighth slice's path: the workload plane's serving path on the
    card. Returns the `workload_plane` line's numbers."""
    import contextlib
    import dataclasses
    import gc
    import io

    from repro_torch.api import Simulator
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch import serve
    from repro_torch.models import params as pm
    from repro_torch.models.transformer import LanguageModel
    from repro_torch.models.zoo import ModelBundle

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wp = dict(card=report["environment"]["card"])

    reset_counts, counts = reset_launch_counts, launch_counts

    def check_tokens(name, res, cfg):
        toks = torch.cat(res.waves)
        if not res.logits_finite:
            fail(f"{name}: a logit is not finite")
        if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_padded:
            fail(f"{name}: a token outside [0, {cfg.vocab_padded})")
        return int((toks >= cfg.vocab).sum())

    def serve_numbers(runs, cfg, bundle, B, P):
        weight_bytes = bundle.param_bytes()
        isz = pm.torch_dtype(cfg.param_dtype).itemsize
        # the bytes a decode step of B tokens must read: every weight
        # once, but only B rows of the embedding table and, in a MoE
        # layer, at most B * top_k of its experts
        unread = (cfg.vocab_padded - B) * cfg.d_model * isz
        if cfg.num_experts > 1:
            unread += cfg.layers * (cfg.num_experts - min(
                cfg.num_experts, B * cfg.top_k)) * 3 * cfg.d_model \
                * cfg.d_ff * isz
        step_bytes = weight_bytes - unread
        # the products a prefill token needs: the blocks' parameters
        # (a MoE token reaches top_k of its experts), not the embeddings
        body = bundle.param_count() - 2 * cfg.vocab_padded * cfg.d_model \
            - cfg.layers * (cfg.num_experts - cfg.top_k) * 3 * cfg.d_model \
            * cfg.d_ff * (cfg.num_experts > 1)
        prefill = [ms for r in runs for ms in r.prefill_ms]
        decode = [ms for r in runs for ms in r.decode_ms_per_token]
        return dict(
            prefill_ms=float(np.median(prefill)), prefill_ms_all=prefill,
            decode_ms_per_token=float(np.median(decode)),
            decode_ms_all=decode,
            tokens_per_s=[r.tokens_per_s for r in runs],
            wall_s=[r.wall_s for r in runs],
            weight_bytes=weight_bytes, body_params=body,
            decode_step_bytes=step_bytes,
            decode_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
            decode_bound_ms_all_weights=weight_bytes / HBM_BYTES_PER_S * 1e3,
            prefill_bound_ms=2 * body * B * P / BF16_OPS_PER_S * 1e3,
            prefill_bound_by="operations", decode_bound_by="bytes")

    # ---- 21. qwen2-1.5b served at full width through the entry point --------
    arch, B, P, G, R = "qwen2-1.5b", 4, 512, 32, 8
    argv = ["--arch", arch, "--requests", str(R), "--batch", str(B),
            "--prompt-len", str(P), "--gen-len", str(G),
            "--sim-accel", "paper-128"]
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)              # the default device: the card
    cli_s = time.perf_counter() - t0
    cli_launches = counts()
    no_launches("serve_qwen2_full (CLI)", cli_launches)
    lines = buf.getvalue().splitlines()
    waves = [ln for ln in lines if ln.startswith("wave done: ")]
    if rc != 0 or len(waves) != 2 or not all(
            ln.startswith(f"wave done: {B} seqs x {G} tokens")
            for ln in waves):
        fail(f"serve_qwen2_full: rc {rc}, lines {lines}")
    if not any(ln.startswith(f"served {R} requests, {R * G} tokens in ")
               and ln.endswith("on cuda") for ln in lines):
        fail(f"serve_qwen2_full: lines {lines}")
    cfg = get_config(arch)
    bundle = ModelBundle(cfg)
    t0 = time.perf_counter()
    model = bundle.init(torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = serve.make_prompts(cfg, requests=R, prompt_len=P, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    runs = [serve.serve_requests(model, prompts, batch=B, gen_len=G)
            for _ in range(3)]
    runs_s = time.perf_counter() - t0
    no_launches("serve_qwen2_full", counts())
    peak = torch.cuda.max_memory_allocated()
    padded = check_tokens("serve_qwen2_full", runs[0], cfg)
    for r in runs[1:]:
        check_tokens("serve_qwen2_full", r, cfg)
        if not all(torch.equal(a, b) for a, b in zip(r.waves,
                                                     runs[0].waves)):
            fail("serve_qwen2_full: greedy tokens differ between runs")
    # the CLI drew the same weights from the same seed: its samples are
    # the first 8 tokens of each wave's first row
    for ln, out in zip(waves, runs[0].waves):
        if not ln.endswith(f"sample: {out[0, :8].tolist()}"):
            fail(f"serve_qwen2_full: the CLI's tokens differ: {ln} vs "
                 f"{out[0, :8].tolist()}")
    # the card's busy share over one wave (some 12,000 host operations a
    # decode step: the device alone is traced)
    t0 = time.perf_counter()
    prof = profile_run(lambda: serve.serve_requests(
        model, prompts[:B], batch=B, gen_len=G))
    profile_s = time.perf_counter() - t0
    qinfo = dict(arch=arch, requests=R, batch=B, prompt_len=P, gen_len=G,
                 layers=cfg.layers, d_model=cfg.d_model,
                 vocab_padded=cfg.vocab_padded, dtype=cfg.param_dtype,
                 cli_s=cli_s, init_s=init_s, runs_s=runs_s,
                 profile_s=profile_s, cli_launches=cli_launches,
                 padded_vocab_tokens=padded, peak_memory_bytes=peak,
                 device_busy_share=prof["device_busy_share"],
                 profiled_wall_ms=prof["profiled_wall_ms"],
                 device_busy_ms=prof["device_busy_ms"],
                 top_device_ops=prof["top_device_ops"],
                 **serve_numbers(runs, cfg, bundle, B, P))
    phase("serve_qwen2_full", **qinfo)
    wp["serve_qwen2_full"] = qinfo

    # the co-simulation: the --sim-accel wave cost on the card and the CPU
    sims = {}
    for name, dev in (("cuda", cuda), ("cpu", cpu)):
        reset_counts()
        t0 = time.perf_counter()
        sim = Simulator("paper-128", device=dev)
        pre, dec, cyc, pj = serve.sim_wave_cost(sim, cfg, prompt_len=P,
                                                batch=B, gen_len=G)
        sims[name] = dict(prefill_cycles=pre.total_cycles,
                          decode_cycles=dec.total_cycles,
                          wave_cycles=cyc, wave_pj=pj,
                          seconds=time.perf_counter() - t0,
                          launches=counts())
        no_launches(f"serve_sim_accel ({name})", sims[name]["launches"])
    errs = {k: abs(sims["cuda"][k] - sims["cpu"][k]) / abs(sims["cpu"][k])
            for k in ("prefill_cycles", "decode_cycles", "wave_cycles",
                      "wave_pj")}
    if not all_within(errs):
        fail(f"serve_sim_accel: card vs CPU {errs}")
    c = sims["cuda"]
    want = (f"[sim:paper-128] modeled wave: "
            f"{sim.seconds(c['wave_cycles']) * 1e3:.2f} ms")
    if not lines[-1].startswith(want):
        fail(f"serve_sim_accel: the CLI printed {lines[-1]!r}, want {want}")
    sinfo = dict(preset="paper-128", card=sims["cuda"], cpu=sims["cpu"],
                 rel_err=errs, cli_line=lines[-1])
    phase("serve_sim_accel", **sinfo)
    wp["serve_sim_accel"] = sinfo
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 22. full width, 2 layers, float32: the card against its CPU --------
    cfg2 = dataclasses.replace(cfg, layers=2, param_dtype="float32")
    b2 = ModelBundle(cfg2)
    t2 = time.perf_counter()
    tree = pm.init_params(b2.defs, torch.Generator().manual_seed(0))
    m_cpu = LanguageModel(cfg2, tree)
    m_gpu = LanguageModel(cfg2, pm.tree_map(lambda t: t.to(cuda), tree))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg2.vocab, (2, 128)))
    t0 = time.perf_counter()
    with torch.inference_mode():
        lc, cc = b2.prefill(m_cpu, {"tokens": toks})
        lg, cg = b2.prefill(m_gpu, {"tokens": toks.to(cuda)})
        e = dict(prefill_logits=max_rel(lg, lc), prefill_cache=tree_rel(cg, cc))
        tok_c, tok_g = lc.argmax(-1)[:, None], lg.argmax(-1)[:, None]
        same = torch.equal(tok_c, tok_g.cpu())
        lc, cc = b2.decode(m_cpu, cc, tok_c, 128)
        lg, cg = b2.decode(m_gpu, cg, tok_g, 128)
        e.update(decode_logits=max_rel(lg, lc), decode_cache=tree_rel(cg, cc))
        same &= torch.equal(lc.argmax(-1), lg.argmax(-1).cpu())
    p2 = serve.make_prompts(cfg2, requests=2, prompt_len=128, seed=0)
    rc_ = serve.serve_requests(m_cpu, p2, batch=2, gen_len=8)
    rg_ = serve.serve_requests(m_gpu, p2, batch=2, gen_len=8)
    same_serve = torch.equal(rc_.waves[0], rg_.waves[0].cpu())
    if not all_within(e) or not same or not same_serve:
        fail(f"serve_qwen2_2l_f32_vs_cpu: errors {e}, greedy tokens equal "
             f"{same} (steps), {same_serve} (served)")
    finfo = dict(arch=arch, layers=2, dtype="float32", batch=2,
                 prompt_len=128, gen_len=8, tf32=False, rel_err=e,
                 greedy_equal=True, seconds=time.perf_counter() - t0,
                 with_init_s=time.perf_counter() - t2,
                 card_decode_ms_per_token=rg_.decode_ms_per_token[0],
                 cpu_decode_ms_per_token=rc_.decode_ms_per_token[0])
    phase("serve_qwen2_2l_f32_vs_cpu", **finfo)
    wp["serve_qwen2_2l_f32_vs_cpu"] = finfo
    del m_cpu, m_gpu, tree, cc, cg
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 23. the MoE family at published width ------------------------------
    garch, gB, gP, gG = "granite-moe-3b-a800m", 4, 512, 16
    gcfg = get_config(garch)
    gb = ModelBundle(gcfg)
    t0 = time.perf_counter()
    gm = gb.init(torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    ginit_s = time.perf_counter() - t0
    gprompts = serve.make_prompts(gcfg, requests=gB, prompt_len=gP, seed=0)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    gruns = [serve.serve_requests(gm, gprompts, batch=gB, gen_len=gG)
             for _ in range(2)]
    glaunches = counts()
    no_launches("serve_granite_moe_full", glaunches)
    gpadded = check_tokens("serve_granite_moe_full", gruns[0], gcfg)
    check_tokens("serve_granite_moe_full", gruns[1], gcfg)
    if not torch.equal(gruns[0].waves[0], gruns[1].waves[0]):
        fail("serve_granite_moe_full: greedy tokens differ between runs")
    ginfo = dict(arch=garch, layers=gcfg.layers, experts=gcfg.num_experts,
                 top_k=gcfg.top_k, batch=gB, prompt_len=gP, gen_len=gG,
                 dtype=gcfg.param_dtype, launches=glaunches,
                 init_s=ginit_s,
                 padded_vocab_tokens=gpadded,
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 **serve_numbers(gruns, gcfg, gb, gB, gP))
    phase("serve_granite_moe_full", **ginfo)
    wp["serve_granite_moe_full"] = ginfo
    del gm, gruns
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 24. every family's SMOKE config: the card against its CPU ----------
    fam = {}
    t0 = time.perf_counter()
    for a in list_archs():
        c = dataclasses.replace(get_config(a, smoke=True),
                                param_dtype="float32")
        b = ModelBundle(c)
        tree = pm.init_params(b.defs, torch.Generator().manual_seed(1))
        models = {"cpu": LanguageModel(c, tree),
                  "cuda": LanguageModel(c, pm.tree_map(lambda t: t.to(cuda),
                                                     tree))}
        rng = np.random.default_rng(2)
        x = {"tokens": torch.from_numpy(rng.integers(0, c.vocab, (2, 40))),
             "labels": torch.from_numpy(rng.integers(0, c.vocab, (2, 40))),
             "loss_mask": torch.ones(2, 40)}
        if c.family == "audio":
            x["frames"] = torch.from_numpy(
                rng.standard_normal((2, 40, c.d_model)).astype(np.float32))
        if c.family == "vlm":
            x["patches"] = torch.from_numpy(rng.standard_normal(
                (2, c.frontend_tokens, c.d_model)).astype(np.float32))
        out = {}
        with torch.inference_mode():
            for d, m in models.items():
                xd = {k: v.to(m.device) for k, v in x.items()}
                pre = {k: v for k, v in xd.items()
                       if k in ("tokens", "frames", "patches")}
                logits, cache = b.prefill(m, pre)
                steps = [logits]
                for s in range(4):
                    tok = logits.argmax(-1)[:, None]
                    logits, cache = b.decode(m, cache, tok, 40 + s)
                    steps.append(logits)
                out[d] = dict(steps=steps, cache=cache, loss=b.loss(m, xd))
        e = dict(
            logits=max(max_rel(g, cc) for g, cc in
                       zip(out["cuda"]["steps"], out["cpu"]["steps"])),
            cache=tree_rel(out["cuda"]["cache"], out["cpu"]["cache"]),
            loss=max_rel(out["cuda"]["loss"], out["cpu"]["loss"]))
        greedy = all(torch.equal(g.argmax(-1).cpu(), cc.argmax(-1)) for g, cc
                     in zip(out["cuda"]["steps"], out["cpu"]["steps"]))
        if not all_within(e) or not greedy:
            fail(f"smoke_families_vs_cpu {a}: errors {e}, greedy {greedy}")
        fam[a] = dict(family=c.family, rel_err=e, greedy_equal=greedy)
    sfinfo = dict(archs=fam, steps="prefill + 4 decode steps + loss",
                  dtype="float32", seconds=time.perf_counter() - t0)
    phase("smoke_families_vs_cpu", **sfinfo)
    wp["smoke_families_vs_cpu"] = sfinfo
    report["workload_plane"] = wp
    return wp


def train_bound(cfg, bundle, B, L) -> dict:
    """The least time of one train step of B x L tokens: the products of
    the forward and backward over 989 TFLOP/s (6 x the parameters a token
    reaches, the unembedding's included, the embedding's not; attention's
    scores and context 4 B L^2 H hd a layer, three times) plus the
    optimizer's bytes over 3.35 TB/s (each parameter read and written, its
    gradient read, both float32 moments read and written). The optimizer
    waits for the last gradient, so the two add."""
    isz = bundle.param_bytes() / bundle.param_count()
    inactive = cfg.layers * (cfg.num_experts - cfg.top_k) * 3 \
        * cfg.d_model * cfg.d_ff if cfg.num_experts > 1 else 0
    reached = bundle.param_count() - cfg.vocab_padded * cfg.d_model \
        - inactive
    tokens = B * L
    attn = 3 * 4 * B * L * L * cfg.heads * cfg.head_dim * cfg.layers
    flops = 6 * reached * tokens + attn
    opt_bytes = bundle.param_count() * (3 * isz + 16)
    ms = flops / BF16_OPS_PER_S * 1e3 + opt_bytes / HBM_BYTES_PER_S * 1e3
    return dict(flops=flops, attention_flops=attn, optimizer_bytes=opt_bytes,
                gemm_bound_ms=flops / BF16_OPS_PER_S * 1e3,
                optimizer_bound_ms=opt_bytes / HBM_BYTES_PER_S * 1e3,
                step_bound_ms=ms)


def step_errors(card: dict, cpu: dict, lr: float) -> dict:
    """One train step on the card against the same step on the CPU: the
    loss and the gradient norm (relative), each moment (max |a - b| over
    the leaf's max |b|), and the updated parameters relative to the leaf's
    largest magnitude wherever the CPU's clipped gradient (the first
    moment / (1 - 0.9)) is at least 100 x AdamW's eps of 1e-8. AdamW's
    first step moves a parameter by lr g / (|g| + 1e-8): a gradient near
    1e-8 moves it anywhere in [-lr, lr] on rounding alone, so there the
    parameters are held, as `params_eps_share`, to the 2 lr every update
    keeps. Each a dict of tensors: loss, grad_norm, params, m, v."""
    from repro_torch.models.params import tree_leaves
    e = dict(loss=max_rel(card["loss"], cpu["loss"]),
             grad_norm=max_rel(card["grad_norm"], cpu["grad_norm"]),
             m=tree_rel(card["m"], cpu["m"]), v=tree_rel(card["v"], cpu["v"]))
    sure_err, eps_err = 0.0, 0.0
    for a, b, m in zip(tree_leaves(card["params"]),
                       tree_leaves(cpu["params"]), tree_leaves(cpu["m"])):
        a, b = a.detach().cpu().double(), b.detach().double()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            return dict(e, params=float("inf"))
        err = (a - b).abs()
        sure = m.double().abs() / 0.1 >= 100 * 1e-8
        scale = b.abs().max().clamp_min(1e-30)
        if sure.any():
            sure_err = max(sure_err, float(err[sure].max() / scale))
        if (~sure).any():
            eps_err = max(eps_err, float(err[~sure].max()) / (2 * lr))
    return dict(e, params=sure_err, params_eps_share=eps_err)


def training_phases(report: dict) -> dict:
    """The ninth slice's path: the training step on the card. Returns the
    `training` line's numbers."""
    import dataclasses
    import gc
    import shutil
    import tempfile
    import warnings

    from repro_torch.api import Simulator
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.configs import get_config, list_archs
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.models import params as pm
    from repro_torch.models.transformer import LanguageModel
    from repro_torch.models.zoo import ModelBundle, params_tree
    from repro_torch.optim import cosine_schedule

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = dict(card=report["environment"]["card"])
    build = ROOT / "build"
    build.mkdir(exist_ok=True)

    def batches(cfg, B, L, n, seed=0):
        ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=L,
                                           global_batch=B, seed=seed))
        return [{k: torch.from_numpy(v).to(cuda)
                 for k, v in ds.global_batch_at(i).items()}
                for i in range(n)]

    def full_width(name, arch, B, L, steps, profile):
        """`steps` train steps of the arch at full width and depth from
        seed 0's weights at a cosine schedule peaking at 3e-4: every loss
        and gradient norm finite, the first loss within 1.5 of
        ln(vocab), every leaf's gradient nonzero, every leaf changed that
        bfloat16 can move, no kernel launched; step times, tokens/s, peak
        memory, the bound, and with `profile` the card's busy share over
        one more step."""
        cfg = get_config(arch)
        bundle = ModelBundle(cfg)
        t0 = time.perf_counter()
        model = bundle.init(torch.Generator(device=cuda).manual_seed(0))
        opt = bundle.opt_init(model)
        before = pm.tree_map(torch.clone, params_tree(model))
        data = batches(cfg, B, L, steps)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        lr_max = 3e-4
        step = bundle.train_step(lr=cosine_schedule(lr_max, 1, steps))
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        ms, losses, gnorms = [], [], []
        for batch in data:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, opt, m = step(model, opt, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        launches = launch_counts()
        no_launches(name, launches)
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses + gnorms):
            fail(f"{name}: losses {losses}, grad norms {gnorms}")
        if abs(losses[0] - math.log(cfg.vocab)) >= 1.5:
            fail(f"{name}: first loss {losses[0]}, ln(vocab) "
                 f"{math.log(cfg.vocab)}")
        after = dict(flatten_with_paths(params_tree(model)))
        same = [n for n, a in flatten_with_paths(before)
                if torch.equal(a, after[n])]
        # the gradient reached every leaf; every leaf moved but those
        # bfloat16 cannot move: an element moves only if its step, at most
        # lr (1.17 + 0.1 |p|) in AdamW (b1 0.9, b2 0.95, decay 0.1),
        # reaches half its spacing, at least |p| 2^-9, so a leaf whose
        # every |p| exceeds 1.17 lr / (2^-9 - 0.1 lr) stays (the norm
        # gains at 1.0, at lr 3e-4)
        floor = 1.17 * lr_max / (2 ** -9 - 0.1 * lr_max)
        rounded = [n for n in same if after[n].dtype == torch.bfloat16
                   and bool((after[n].abs() > floor).all())]
        dead = [n for n, mt in flatten_with_paths(opt.m) if not mt.any()]
        if dead or set(same) - set(rounded):
            fail(f"{name}: leaves without a gradient {dead}; unchanged by "
                 f"{steps} steps {same}, of which bfloat16 cannot move "
                 f"{rounded}")
        if int(opt.step) != steps:
            fail(f"{name}: optimizer step {int(opt.step)}")
        del before
        steady = float(np.median(ms[1:]))
        info = dict(arch=arch, layers=cfg.layers, d_model=cfg.d_model,
                    dtype=cfg.param_dtype, batch=B, seq=L, steps=steps,
                    params=bundle.param_count(),
                    weight_bytes=bundle.param_bytes(), init_s=init_s,
                    launches=launches, losses=losses, grad_norms=gnorms,
                    unchanged_bf16_leaves=rounded,
                    step_ms_all=ms, step_ms=steady,
                    tokens_per_s=B * L / steady * 1e3,
                    peak_memory_bytes=peak, **train_bound(cfg, bundle, B, L))
        info["step_over_bound"] = steady / info["step_bound_ms"]
        if profile:
            t0 = time.perf_counter()
            prof = profile_run(lambda: step(model, opt, data[0]))
            info.update(profile_s=time.perf_counter() - t0,
                        device_busy_share=prof["device_busy_share"],
                        profiled_wall_ms=prof["profiled_wall_ms"],
                        device_busy_ms=prof["device_busy_ms"],
                        top_device_ops=prof["top_device_ops"])
        phase(name, **info)
        del model, opt, data
        gc.collect()
        torch.cuda.empty_cache()
        return info

    # ---- 25. qwen2-1.5b trained at full width, then through the CLI -------
    arch, B, L = "qwen2-1.5b", 8, 1024
    t0 = time.perf_counter()
    qinfo = full_width("train_qwen2_full", arch, B, L, 6, profile=True)
    ck = build / "train_cli_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    pp = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src")
               + (os.pathsep + pp if pp else ""))
    tc = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--steps", "6", "--batch", str(B), "--seq", str(L), "--sim-accel",
         "paper-128", "--ckpt-dir", str(ck)], capture_output=True,
        text=True, timeout=900, env=env, cwd=str(ROOT))
    cli_s = time.perf_counter() - tc
    ck_bytes = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file()) \
        if ck.exists() else 0
    shutil.rmtree(ck, ignore_errors=True)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines or \
            not lines[-1].startswith("done. loss "):
        fail(f"train CLI: rc {proc.returncode}, out {lines[-8:]}, err "
             f"{proc.stderr[-2000:]}")
    sims = {}
    for dname, dev in (("cuda", cuda), ("cpu", cpu)):
        reset_launch_counts()
        ts = time.perf_counter()
        sim = Simulator("paper-128", device=dev)
        rep = sim.run_lm(get_config(arch), seq=L, batch=B, mode="train")
        sims[dname] = dict(cycles=rep.total_cycles, pj=rep.energy_pj,
                           ms=sim.seconds(rep.total_cycles) * 1e3,
                           utilization=rep.utilization,
                           seconds=time.perf_counter() - ts,
                           launches=launch_counts())
        no_launches(f"train sim-accel ({dname})", sims[dname]["launches"])
    cli_ms = float(lines[0].split("modeled train step: ")[1].split(" ms")[0]) \
        if lines[0].startswith("[sim:paper-128] modeled train step: ") \
        else float("nan")
    errs = dict(cycles=abs(sims["cuda"]["cycles"] - sims["cpu"]["cycles"])
                / sims["cpu"]["cycles"],
                pj=abs(sims["cuda"]["pj"] - sims["cpu"]["pj"])
                / sims["cpu"]["pj"],
                cli_ms=abs(cli_ms - sims["cpu"]["ms"]) / sims["cpu"]["ms"])
    if not all_within(errs):
        fail(f"train CLI sim-accel: card / CLI vs CPU {errs}, "
             f"line {lines[0]!r}")
    qinfo.update(cli=dict(seconds=cli_s, checkpoint_bytes=ck_bytes,
                          lines=lines, sim_card=sims["cuda"],
                          sim_cpu=sims["cpu"], sim_rel_err=errs))
    qinfo["phase_s"] = time.perf_counter() - t0
    phase("train_qwen2_cli", **qinfo["cli"])
    tr["train_qwen2_full"] = qinfo

    # ---- 26. full width, 2 layers, float32: the card against its CPU -------
    def one_step_both(cfg, tree, batch, lr):
        """One train step from the same weights on the card and the CPU;
        returns each side's loss, grad norm, params and moments."""
        out = {}
        for dname, dev in (("cuda", cuda), ("cpu", cpu)):
            model = LanguageModel(cfg, pm.tree_map(
                lambda t: t.to(dev, copy=True), tree))
            bundle = ModelBundle(cfg)
            b = {k: v.to(dev) for k, v in batch.items()}
            ts = time.perf_counter()
            _, opt, m = bundle.train_step(lr=lr)(model, bundle.opt_init(model),
                                                 b)
            loss = m["loss"].cpu()
            out[dname] = dict(loss=loss, grad_norm=m["grad_norm"],
                              params=params_tree(model), m=opt.m, v=opt.v,
                              seconds=time.perf_counter() - ts)
        return out

    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(get_config(arch), layers=2,
                               param_dtype="float32")
    tree = pm.init_params(ModelBundle(cfg2).defs,
                          torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg2.vocab, (2, 128))),
             "labels": torch.from_numpy(rng.integers(0, cfg2.vocab, (2, 128)))}
    both = one_step_both(cfg2, tree, batch, 1e-2)
    e = step_errors(both["cuda"], both["cpu"], 1e-2)
    eps_share = e.pop("params_eps_share")
    if not all_within(e) or not eps_share <= 1.0:
        fail(f"train_qwen2_2layer_f32: card vs CPU {e}, "
             f"eps share {eps_share}")
    finfo = dict(arch=arch, layers=2, dtype="float32", batch=2, seq=128,
                 lr=1e-2, tf32=False, rel_err=e, params_eps_share=eps_share,
                 card_step_s=both["cuda"]["seconds"],
                 cpu_step_s=both["cpu"]["seconds"],
                 seconds=time.perf_counter() - t0)
    phase("train_qwen2_2layer_f32", **finfo)
    tr["train_qwen2_2layer_f32"] = finfo
    del both, tree
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 27. every family's SMOKE config: one step, card against CPU -------
    fam = {}
    t0 = time.perf_counter()
    for a in list_archs():
        c = dataclasses.replace(get_config(a, smoke=True),
                                param_dtype="float32")
        tree = pm.init_params(ModelBundle(c).defs,
                              torch.Generator().manual_seed(1))
        rng = np.random.default_rng(2)
        x = {"tokens": torch.from_numpy(rng.integers(0, c.vocab, (2, 40))),
             "labels": torch.from_numpy(rng.integers(0, c.vocab, (2, 40))),
             "loss_mask": torch.from_numpy(
                 (rng.random((2, 40)) < 0.9).astype(np.float32))}
        if c.family == "audio":
            x["frames"] = torch.from_numpy(
                rng.standard_normal((2, 40, c.d_model)).astype(np.float32))
        if c.family == "vlm":
            x["patches"] = torch.from_numpy(rng.standard_normal(
                (2, c.frontend_tokens, c.d_model)).astype(np.float32))
        reset_launch_counts()
        both = one_step_both(c, tree, x, 1e-2)
        no_launches(f"train_families {a}", launch_counts())
        e = step_errors(both["cuda"], both["cpu"], 1e-2)
        eps_share = e.pop("params_eps_share")
        if not all_within(e) or not eps_share <= 1.0:
            fail(f"train_families {a}: card vs CPU {e}, eps share "
                 f"{eps_share}")
        fam[a] = dict(family=c.family, rel_err=e,
                      params_eps_share=eps_share)
    sfinfo = dict(archs=fam, dtype="float32", batch=2, seq=40, lr=1e-2,
                  seconds=time.perf_counter() - t0)
    phase("train_families", **sfinfo)
    tr["train_families"] = sfinfo

    # ---- 28. save (async), restore and replay: exact under determinism -----
    # Plain CUDA adds the embedding gather's and the MoE scatter's
    # gradients with atomics, in no fixed order; deterministic algorithms
    # (CUBLAS_WORKSPACE_CONFIG is set before cuBLAS starts, in main) make a
    # replay bit for bit
    t0 = time.perf_counter()
    rinfo = dict(deterministic=True, steps=6, saved_at=3, archs={})
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for a in ("qwen2-1.5b", "granite-moe-3b-a800m"):
                bundle = ModelBundle(get_config(a, smoke=True))
                model = bundle.init(torch.Generator(device=cuda).manual_seed(0))
                opt = bundle.opt_init(model)
                step = bundle.train_step(lr=1e-3)
                data = batches(bundle.cfg, 4, 64, 6, seed=2)
                with tempfile.TemporaryDirectory(dir=build) as d:
                    mgr = CheckpointManager(d)
                    for i in range(6):
                        if i == 3:
                            mgr.save(3, {"p": params_tree(model), "o": opt})
                        _, opt, _ = step(model, opt, data[i])
                    model2 = bundle.init(
                        torch.Generator(device=cuda).manual_seed(7))
                    state = mgr.restore({"p": params_tree(model2),
                                         "o": bundle.opt_init(model2)})
                params_tree(model2, state["p"])
                opt2 = state["o"]
                for i in range(3, 6):
                    _, opt2, _ = step(model2, opt2, data[i])
                diff = [n for (n, x), (_, y) in zip(
                    flatten_with_paths({"p": params_tree(model), "o": opt}),
                    flatten_with_paths({"p": params_tree(model2),
                                        "o": opt2}))
                    if not torch.equal(x, y)]
                if diff:
                    fail(f"train_restart {a}: the replay differs in {diff}")
                rinfo["archs"][a] = dict(dtype=bundle.cfg.param_dtype,
                                         exact=True)
        rinfo["nondeterministic_warnings"] = sorted(
            {str(w.message)[:120] for w in caught})
    finally:
        torch.use_deterministic_algorithms(False)
    rinfo["seconds"] = time.perf_counter() - t0
    phase("train_restart", **rinfo)
    tr["train_restart"] = rinfo

    # ---- 29. the MoE family at full width -----------------------------------
    t0 = time.perf_counter()
    ginfo = full_width("train_granite_moe_full", "granite-moe-3b-a800m", 4,
                       512, 3, profile=False)
    ginfo["phase_s"] = time.perf_counter() - t0
    tr["train_granite_moe_full"] = ginfo
    report["training"] = tr
    return tr


# ---------------------------------------------------------------------------
# the tenth slice: the sharded workload plane (phases 30-33)
# ---------------------------------------------------------------------------

def sharded_job(job: dict) -> dict:
    """One job of a rank of a sharded world (`--sharded-rank`): the model
    at the job's width, depth and dtype on the job's device, sharded on
    the world's (dp, tp) mesh; a prefill and `gen` greedy decode steps on
    an S-sharded cache from the initial weights, then `steps` train steps.
    Returns this rank's numbers; rank 0's carry the losses, gradient
    norms, tokens and logits."""
    import dataclasses

    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.dist import collectives as col
    from repro_torch.dist.sharding import make_mesh_ctx
    from repro_torch.models import params as pm
    from repro_torch.models.zoo import ModelBundle
    from repro_torch.optim import cosine_schedule

    mesh = job["mesh_obj"]
    ctx = make_mesh_ctx(mesh)
    dev = torch.device(job["device"])
    cfg = get_config(job["arch"])
    over = {k: job[k] for k in ("layers", "param_dtype", "sp_mode")
            if job.get(k) is not None}
    cfg = dataclasses.replace(cfg, **over)
    bundle = ModelBundle(cfg)

    def make(serve):
        """The job's weights from its seed, this rank's blocks of them cut
        by `param_shardings(ctx, serve=serve)`."""
        if not job.get("init_cpu"):
            return bundle.init(torch.Generator(device=dev).manual_seed(
                job["seed"]), ctx, serve=serve)
        tree = pm.init_params(bundle.defs,
                              torch.Generator().manual_seed(job["seed"]))
        return bundle.shard(pm.tree_map(lambda t: t.to(dev), tree), ctx,
                            serve=serve)
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" \
        else (lambda: None)
    out = dict(rank=mesh.rank, backend=mesh.backend, mesh=dict(mesh.shape))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    st = col.stats(mesh)
    pre = job.get("prefill")
    if pre:
        # serving: weights TP-resident, replicated over data
        model = make(serve=True)
        ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=pre["L"],
                                           global_batch=pre["B"], seed=1))
        toks = torch.from_numpy(ds.global_batch_at(0)["tokens"]).to(dev)
        st.reset()
        t0 = time.perf_counter()
        logits, cache = bundle.prefill_step(ctx)(model, {"tokens": toks})
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        cache = grow_sharded(bundle, ctx, cache, pre["B"], pre["L"],
                             pre["gen"], dev)
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None].to(
            torch.int32)
        gen, dl, step_ms = [tok[:, 0].cpu()], [logits.cpu()], []
        # teacher forcing: step i reads the given token i (another run's
        # greedy stream), so every step of both runs sees the same input
        force = pre.get("force")
        for i in range(pre["gen"]):
            if force is not None:
                tok = torch.tensor([row[i] for row in force],
                                   dtype=torch.int32, device=dev)[:, None]
            t0 = time.perf_counter()
            logits, cache = bundle.decode_step(ctx)(model, cache, tok,
                                                    pre["L"] + i)
            tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None].to(
                torch.int32)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            gen.append(tok[:, 0].cpu())
            dl.append(logits.cpu())
        out.update(prefill_ms=prefill_ms, decode_ms=float(np.median(step_ms)),
                   tokens=torch.stack(gen, 1).tolist(),
                   serve_collectives=st.as_dict(),
                   kv_sharded=bool(cache.specs["k"][2] is not None))
        out["logits"] = torch.stack(dl).numpy()
        del cache, model
    if job.get("steps"):
        model = make(serve=False)
        ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=job["L"],
                                           global_batch=job["B"], seed=0))
        step = bundle.train_step(ctx, lr=cosine_schedule(
            job.get("lr", 3e-4), 1, job["steps"]))
        opt = bundle.opt_init(model)
        losses, gnorms, ms, coll = [], [], [], []
        for i in range(job["steps"]):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in ds.global_batch_at(i).items()}
            st.reset()
            sync()
            t0 = time.perf_counter()
            _, opt, m = step(model, opt, batch)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            coll.append(st.as_dict())
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out.update(losses=losses, grad_norms=gnorms, step_ms_all=ms,
                   step_ms=float(np.median(ms[1:] if len(ms) > 1 else ms)),
                   train_collectives=coll[-1])
        if job.get("keep_params"):
            # each whole leaf's largest magnitude and every k-th element
            # (at most 65,536 of them), of the updated parameters and of
            # the step's clipped gradient (the first moment over 1 - b1
            # after one step): enough to hold two worlds' steps against
            # each other under AdamW's first-step rule without writing
            # the model
            out["params"] = {}
            whole = {"param/": bundle.unshard(model),
                     "grad/": pm.gather_tree(opt.m, model.specs, model.mesh)}
            for pre, tree in whole.items():
                for n, t in flatten_with_paths(tree):
                    flat = t.float().flatten()
                    if pre == "grad/":
                        flat = flat / (1 - 0.9)
                    k = max(1, flat.numel() // 65536)
                    out["params"][pre + n] = np.concatenate([
                        [float(flat.abs().max())], flat[::k].cpu().numpy()])
        del model, opt
    if dev.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


def grow_sharded(bundle, ctx, cache, B, L, gen, dev):
    """A sharded prefill cache of length L as one of length L + gen, the
    prefill's rows in place (through whole leaves): the decode's room."""
    from repro_torch.models import params as pm
    whole = pm.gather_tree(dict(cache), cache.specs, ctx.mesh)
    big = bundle.init_cache(batch=B, cache_len=L + gen, device=dev, ctx=ctx)
    full = {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, gen))
            for k, t in whole.items()}
    local = pm.shard_tree(full, big.specs, ctx.mesh)
    for k in big:
        big[k].copy_(local[k])
    return big


def sharded_rank_main(jobs_path: str) -> int:
    """A rank of a sharded world started by `repro_torch.launch.spawn`:
    the jobs of `jobs_path` in order, each result written as
    <out>/<name>.rank<r>.npz (arrays) and .json (numbers)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import bind_mesh, init_world
    from repro_torch.launch.spawn import world_from_env
    with open(jobs_path) as f:
        spec = json.load(f)
    torch.set_num_threads(int(spec.get("threads", 2)))
    w = world_from_env()
    if spec["device"] == "cuda":
        torch.cuda.set_device(0)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cuda.matmul.allow_tf32 = False
    init_world(backend=spec["backend"], init_method=w["init_method"],
               rank=w["rank"], world_size=w["world_size"], timeout_s=600)
    mesh = bind_mesh(tuple(spec["mesh"]), ("data", "model"))
    for job in spec["jobs"]:
        res = sharded_job(dict(job, device=spec["device"], mesh_obj=mesh))
        base = os.path.join(spec["out"], f"{job['name']}.rank{mesh.rank}")
        arrays = {"logits": res.pop("logits")} if "logits" in res else {}
        arrays.update(res.pop("params", {}))
        if arrays:
            np.savez(base + ".npz", **arrays)
        with open(base + ".json", "w") as f:
            json.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def run_world(name: str, spec: dict, nprocs: int = 4,
              timeout: float = 900) -> dict:
    """Spawn a world of `nprocs` ranks of this script on `spec`; returns
    {job name: [each rank's result dict, rank 0's arrays]}."""
    out = ROOT / "build" / "sharded" / name
    out.mkdir(parents=True, exist_ok=True)
    spec = dict(spec, out=str(out))
    path = out / "jobs.json"
    path.write_text(json.dumps(spec))
    pp = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src")
               + (os.pathsep + pp if pp else ""),
               OMP_NUM_THREADS=str(spec.get("threads", 2)))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.spawn", "--nprocs",
         str(nprocs), "--timeout", str(timeout), "--", str(ROOT /
                                                         "chip_smoke.py"),
         "--sharded-rank", str(path)], env=env, cwd=str(ROOT),
        capture_output=True, text=True, timeout=timeout + 60)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{name}: the world of {nprocs} exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    res = {}
    for job in spec["jobs"]:
        ranks = [json.loads((out / f"{job['name']}.rank{r}.json").read_text())
                 for r in range(nprocs)]
        arr = out / f"{job['name']}.rank0.npz"
        arrays = dict(np.load(arr)) if arr.exists() else {}
        res[job["name"]] = (ranks, arrays)
    res["_seconds"] = secs
    return res


def run_worlds(*worlds):
    """`run_world` on each (name, spec), the worlds side by side (a card
    world and its CPU twin: one waits on the card and the host's copies,
    the other on the CPU)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(worlds)) as pool:
        futs = [pool.submit(run_world, n, s) for n, s in worlds]
        return [f.result() for f in futs]


def greedy_agreement(got: np.ndarray, ref: np.ndarray, vocab: int) -> dict:
    """A teacher-forced decode's logits (steps, B, V) against the run whose
    greedy stream it was fed. Passes when the logits agree within 3e-2 of
    their largest magnitude (bfloat16) and each step's greedy token is
    the reference's wherever the reference's top-2 margin exceeds twice
    that step's largest logit difference: a closer pair is a tie at
    bfloat16's resolution, which either run may break either way."""
    g, r = got[..., :vocab].astype(np.float64), ref[..., :vocab].astype(
        np.float64)
    err = np.abs(g - r).max(axis=-1)                     # (steps, B)
    top2 = np.sort(r, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    same = g.argmax(-1) == r.argmax(-1)
    decided = margin > 2 * err
    scale = float(np.abs(r).max())
    out = dict(steps=int(g.shape[0]), rows=int(g.shape[1]),
               logits_rel_err=float(err.max()) / scale,
               tokens_equal=int(same.sum()), tokens=int(same.size),
               decided=int(decided.sum()),
               differing_margins=[float(x) for x in margin[~same]],
               differing_errors=[float(x) for x in err[~same]])
    out["ok"] = bool(out["logits_rel_err"] <= 3e-2
                     and (same | ~decided).all())
    return out


def twin_params_err(got: dict, ref: dict, lr: float) -> dict:
    """Two float32 worlds' parameters after one train step (`sharded_job`'s
    samples) under AdamW's first-step rule: within 1e-4 of the leaf's
    largest magnitude where the reference's clipped gradient is at least
    1e-6, within 2 lr elsewhere (a near-zero gradient's rounding decides
    a move of up to lr either way). Returns the largest of each share and
    whether both hold."""
    big_err, small_err = 0.0, 0.0
    for k in ref:
        if not k.startswith("param/"):
            continue
        a, b = got[k][1:], ref[k][1:]
        g = ref["grad/" + k[len("param/"):]][1:]
        d = np.abs(a - b)
        big = np.abs(g) >= 1e-6
        scale = max(float(ref[k][0]), 1e-30)
        big_err = max(big_err, float(d[big].max(initial=0)) / scale)
        small_err = max(small_err, float(d[~big].max(initial=0)))
    return dict(rel_err_where_grad_big=big_err,
                abs_err_elsewhere=small_err, lr=lr,
                ok=bool(big_err <= 1e-4 and small_err <= 2 * lr))


def world_summary(ranks: list) -> dict:
    """The per-rank numbers of a job: step ms, collective host seconds and
    bytes, staged bytes, peak memory, each as a list by rank."""
    out = {}
    for key in ("step_ms", "prefill_ms", "decode_ms", "peak_memory_bytes"):
        if key in ranks[0]:
            out[key + "_by_rank"] = [r[key] for r in ranks]
    for key in ("train_collectives", "serve_collectives"):
        if key in ranks[0]:
            out[key + "_by_rank"] = [r[key] for r in ranks]
    if "train_collectives" in ranks[0]:
        # the last step's seconds in collectives over its wall time
        out["collective_share_by_rank"] = [
            r["train_collectives"]["seconds"] * 1e3 / r["step_ms_all"][-1]
            for r in ranks]
    return out


def sharding_phases(report: dict) -> dict:
    """The tenth slice's path: the sharded train, prefill and decode steps
    on the card. Returns the `sharding` line's numbers."""
    import gc
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.dist import collectives as col
    from repro_torch.dist.sharding import make_mesh_ctx
    from repro_torch.launch.mesh import bind_mesh, init_world
    from repro_torch.models.zoo import ModelBundle
    from repro_torch.optim import cosine_schedule

    import dataclasses

    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    DEPTH = 4
    sh = dict(card=report["environment"]["card"],
              note="four processes share one card; gloo goes through the "
                   "host: these times are not those of four cards")
    build = ROOT / "build"
    pp = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src")
               + (os.pathsep + pp if pp else ""))

    # ---- 30. NCCL refuses two ranks on one card; a world of one ------------
    t0 = time.perf_counter()
    probe = ("import os, datetime, torch, torch.distributed as d\n"
             "torch.cuda.set_device(0)\n"
             "d.init_process_group('nccl', init_method=os.environ["
             "'INIT_METHOD'], rank=int(os.environ['RANK']), world_size=2, "
             "timeout=datetime.timedelta(seconds=60))\n"
             "x = torch.ones(1, device='cuda')\n"
             "try:\n    d.all_reduce(x); torch.cuda.synchronize()\n"
             "except Exception as e:\n"
             "    print('REFUSED', str(e).splitlines()[-1][:300]); "
             "raise SystemExit(3)\n"
             "print('ACCEPTED')\n")
    pr = subprocess.run([sys.executable, "-m", "repro_torch.launch.spawn",
                         "--nprocs", "2", "--timeout", "120", "--", "-c",
                         probe], env=env, capture_output=True, text=True,
                        timeout=180)
    refused = [ln for ln in pr.stdout.splitlines() if ln.startswith("REFUSED")]
    if pr.returncode == 0 or not refused:
        fail(f"sharded_one_rank: NCCL took two ranks on one card? rc "
             f"{pr.returncode} {pr.stdout[-800:]} {pr.stderr[-800:]}")
    nccl_msg = refused[0][len("REFUSED "):]

    arch, B, L, steps = "qwen2-1.5b", 8, 1024, 3
    PB, PL, GEN = 4, 512, 32
    cfg = get_config(arch)
    bundle = ModelBundle(cfg)

    def run_single(make, ctx, bundle, gen=GEN):
        """Prefill + `gen` greedy tokens from the initial weights (served
        with `param_shardings(serve=True)`), then `steps` train steps, on
        `ctx` (None: one device). "logits": each step's, on the host."""
        cfg = bundle.cfg
        model = make(True)
        ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=PL,
                                           global_batch=PB, seed=1))
        toks = torch.from_numpy(ds.global_batch_at(0)["tokens"]).to(cuda)
        with torch.no_grad():
            if ctx is None:
                logits, cache = bundle.prefill(model, {"tokens": toks})
                cache = {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, gen))
                         for k, t in cache.items()}
            else:
                logits, cache = bundle.prefill_step(ctx)(model,
                                                         {"tokens": toks})
                cache = grow_sharded(bundle, ctx, cache, PB, PL, gen, cuda)
            tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None].to(
                torch.int32)
            toks_out, lg = [tok[:, 0]], [logits.cpu()]
            for i in range(gen):
                logits, cache = (bundle.decode(model, cache, tok, PL + i)
                                 if ctx is None else bundle.decode_step(ctx)(
                                     model, cache, tok, PL + i))
                tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None].to(
                    torch.int32)
                toks_out.append(tok[:, 0])
                lg.append(logits.cpu())
        del cache, model
        model = make(False)
        ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=L,
                                           global_batch=B, seed=0))
        step = bundle.train_step(ctx, lr=cosine_schedule(3e-4, 1, steps))
        opt = bundle.opt_init(model)
        losses, gnorms, ms = [], [], []
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(cuda)
                     for k, v in ds.global_batch_at(i).items()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, opt, m = step(model, opt, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        del opt, model
        return dict(tokens=torch.stack(toks_out, 1).cpu().tolist(),
                    logits=torch.stack(lg).numpy(), losses=losses,
                    grad_norms=gnorms, step_ms_all=ms,
                    step_ms=float(np.median(ms[1:])))

    reset_launch_counts()
    single = run_single(lambda serve: bundle.init(
        torch.Generator(device=cuda).manual_seed(0)), None, bundle)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build) as d:
        init_world(backend="nccl", init_method="file://" + d + "/store",
                   rank=0, world_size=1, timeout_s=300)
        try:
            mesh = bind_mesh((1, 1), ("data", "model"))
            ctx = make_mesh_ctx(mesh)
            col.stats(mesh).reset()
            one = run_single(lambda serve: bundle.init(
                torch.Generator(device=cuda).manual_seed(0), ctx,
                serve=serve), ctx, bundle)
            one["collectives"] = col.stats(mesh).as_dict()
        finally:
            dist.destroy_process_group()
    no_launches("sharded_one_rank", launch_counts())
    single.pop("logits")
    one.pop("logits")
    errs = dict(loss=max(abs(a - b) / abs(b) for a, b in
                         zip(one["losses"], single["losses"])),
                grad_norm=max(abs(a - b) / abs(b) for a, b in
                              zip(one["grad_norms"], single["grad_norms"])))
    if not (errs["loss"] <= 1e-6 and errs["grad_norm"] <= 1e-6) or \
            one["tokens"] != single["tokens"] or \
            not all(math.isfinite(x) for x in one["losses"]):
        fail(f"sharded_one_rank: 1 x 1 NCCL mesh vs one device {errs}, "
             f"tokens equal {one['tokens'] == single['tokens']}")
    info = dict(arch=arch, layers=cfg.layers, d_model=cfg.d_model,
                dtype=cfg.param_dtype, batch=B, seq=L, steps=steps,
                prefill_batch=PB, prompt=PL, gen=GEN,
                nccl_two_ranks_one_card=nccl_msg, backend="nccl",
                mesh=[1, 1], rel_err=errs, single=single, sharded=one,
                seconds=time.perf_counter() - t0)
    phase("sharded_one_rank", **info)
    sh["sharded_one_rank"] = info
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 31. a 2 x 2 gloo mesh of four processes on the one card -----------
    # full width, depth cut to DEPTH layers: four processes share the card
    # and gloo's host path, ~20 s a full-depth step on an H100 (8 layers:
    # 6.3-11.2 s)
    t0 = time.perf_counter()
    cut = ModelBundle(dataclasses.replace(cfg, layers=DEPTH))
    single = run_single(lambda serve: cut.init(
        torch.Generator(device=cuda).manual_seed(0)), None, cut, gen=16)
    ref_logits = single.pop("logits")
    gc.collect()
    torch.cuda.empty_cache()
    jobs = [dict(name=f"qwen2_{m}", arch=arch, layers=DEPTH, sp_mode=m,
                 seed=0, B=B, L=L, steps=steps,
                 prefill=dict(B=PB, L=PL, gen=16, force=single["tokens"]))
            for m in ("megatron", "weightgather")]
    f32 = dict(name="qwen2_2layer_f32", arch=arch, layers=2,
               param_dtype="float32", seed=0, init_cpu=True, B=2, L=128,
               steps=1, lr=1e-2, keep_params=True,
               prefill=dict(B=2, L=64, gen=4))
    card, cpu = run_worlds(
        ("sharded_2x2_one_card", dict(backend="gloo", device="cuda",
                                      mesh=[2, 2], threads=1,
                                      jobs=jobs + [f32])),
        ("sharded_2x2_cpu", dict(backend="gloo", device="cpu", mesh=[2, 2],
                                 threads=1, jobs=[f32])))
    modes = {}
    for m in ("megatron", "weightgather"):
        ranks, arrays = card[f"qwen2_{m}"]
        r0 = ranks[0]
        e = max(abs(a - b) / abs(b) for a, b in
                zip(r0["losses"], single["losses"]))
        ge = max(abs(a - b) / abs(b) for a, b in
                 zip(r0["grad_norms"], single["grad_norms"]))
        dec = greedy_agreement(arrays["logits"], ref_logits, cfg.vocab)
        if not (e <= 3e-2 and ge <= 3e-2) or not dec["ok"] or \
                not all(math.isfinite(x) for x in r0["losses"]):
            fail(f"sharded_2x2_one_card {m}: loss vs one device {e}, "
                 f"gradient norm {ge}, decode {dec}")
        if not r0["kv_sharded"]:
            fail(f"sharded_2x2_one_card {m}: the decode cache is not "
                 "S-sharded")
        modes[m] = dict(loss_rel_err=e, grad_norm_rel_err=ge, decode=dec,
                        losses=r0["losses"], grad_norms=r0["grad_norms"],
                        step_ms=r0["step_ms"],
                        staged_bytes=max(r["train_collectives"]
                                         ["staged_bytes"] for r in ranks),
                        **world_summary(ranks))
    (cr, ca), (pr_, pa) = card["qwen2_2layer_f32"], cpu["qwen2_2layer_f32"]
    fe = dict(loss=abs(cr[0]["losses"][0] - pr_[0]["losses"][0])
              / abs(pr_[0]["losses"][0]),
              grad_norm=abs(cr[0]["grad_norms"][0] - pr_[0]["grad_norms"][0])
              / abs(pr_[0]["grad_norms"][0]),
              logits=float(np.abs(ca["logits"] - pa["logits"]).max()
                           / np.abs(pa["logits"]).max()))
    pe = twin_params_err(ca, pa, f32["lr"])
    if not all(v <= 1e-5 for v in fe.values()) or not pe["ok"] or \
            cr[0]["tokens"] != pr_[0]["tokens"]:
        fail(f"sharded_2x2_one_card 2-layer f32: card vs CPU {fe}, "
             f"parameters {pe}, tokens {cr[0]['tokens']} vs "
             f"{pr_[0]['tokens']}")
    info = dict(backend="gloo", mesh=[2, 2], arch=arch, layers=DEPTH,
                batch=B, seq=L, steps=steps, prefill_batch=PB, prompt=PL,
                gen=16, single_device=single, modes=modes,
                f32_2layer=dict(rel_err=fe, params=pe, batch=2, seq=128),
                world_seconds=card["_seconds"], cpu_seconds=cpu["_seconds"],
                seconds=time.perf_counter() - t0)
    phase("sharded_2x2_one_card", **info)
    sh["sharded_2x2_one_card"] = info

    # ---- 32. granite-moe at 8,192 tokens: the sharded MoE path -------------
    t0 = time.perf_counter()
    g_arch, GB, GL, gsteps = "granite-moe-3b-a800m", 4, 2048, 2
    gcfg = dataclasses.replace(get_config(g_arch), layers=DEPTH)
    gbundle = ModelBundle(gcfg)
    model = gbundle.init(torch.Generator(device=cuda).manual_seed(0))
    ds = SyntheticLMDataset(DataConfig(vocab=gcfg.vocab, seq_len=GL,
                                       global_batch=GB, seed=0))
    step = gbundle.train_step(lr=cosine_schedule(3e-4, 1, gsteps))
    opt = gbundle.opt_init(model)
    glosses, ggnorms = [], []
    for i in range(gsteps):
        batch = {k: torch.from_numpy(v).to(cuda)
                 for k, v in ds.global_batch_at(i).items()}
        _, opt, m = step(model, opt, batch)
        glosses.append(float(m["loss"]))
        ggnorms.append(float(m["grad_norm"]))
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    # the float32 twin at 8 x 520 = 4,160 tokens: still past 4,096, so
    # still the sharded MoE path, at an eighth of the CPU's attention work
    gf32 = dict(name="granite_2layer_f32", arch=g_arch, layers=2,
                param_dtype="float32", seed=0, init_cpu=True, B=8, L=520,
                steps=1, lr=1e-2, keep_params=True)
    gcard, gcpu = run_worlds(
        ("sharded_granite_moe_2x2", dict(
            backend="gloo", device="cuda", mesh=[2, 2], threads=1,
            jobs=[dict(name="granite", arch=g_arch, layers=DEPTH, seed=0,
                       B=GB, L=GL, steps=gsteps), gf32])),
        ("sharded_granite_cpu", dict(backend="gloo", device="cpu",
                                     mesh=[2, 2], threads=1, jobs=[gf32])))
    ranks, _ = gcard["granite"]
    r0 = ranks[0]
    e = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], glosses))
    gne = max(abs(a - b) / abs(b) for a, b in zip(r0["grad_norms"], ggnorms))
    if not all(math.isfinite(x) for x in r0["losses"] + r0["grad_norms"]) \
            or not (e <= 3e-2 and gne <= 3e-2):
        fail(f"sharded_granite_moe_2x2: losses {r0['losses']} vs one device "
             f"{glosses} ({e}), gradient norms {r0['grad_norms']} vs "
             f"{ggnorms} ({gne})")
    (cr, ca), (pr_, pa) = gcard["granite_2layer_f32"], gcpu[
        "granite_2layer_f32"]
    ge = dict(loss=abs(cr[0]["losses"][0] - pr_[0]["losses"][0])
              / abs(pr_[0]["losses"][0]),
              grad_norm=abs(cr[0]["grad_norms"][0] - pr_[0]["grad_norms"][0])
              / abs(pr_[0]["grad_norms"][0]))
    gpe = twin_params_err(ca, pa, gf32["lr"])
    if not all(v <= 1e-5 for v in ge.values()) or not gpe["ok"]:
        fail(f"sharded_granite_moe_2x2 2-layer f32: card vs CPU {ge}, "
             f"parameters {gpe}")
    t_loc = GB * GL // 2
    info = dict(backend="gloo", mesh=[2, 2], arch=g_arch, layers=DEPTH,
                batch=GB, seq=GL,
                tokens=GB * GL, tokens_per_dp_shard=t_loc,
                per_shard_capacity=max(1, int(t_loc * gcfg.top_k
                                              / gcfg.num_experts
                                              * gcfg.moe_capacity_factor)),
                steps=gsteps, losses=r0["losses"], grad_norms=r0["grad_norms"],
                single_device_losses=glosses, loss_rel_err=e,
                single_device_grad_norms=ggnorms, grad_norm_rel_err=gne,
                step_ms=r0["step_ms"], f32_2layer=dict(rel_err=ge,
                                                       params=gpe),
                world_seconds=gcard["_seconds"], cpu_seconds=gcpu["_seconds"],
                **world_summary(ranks), seconds=time.perf_counter() - t0)
    phase("sharded_granite_moe_2x2", **info)
    sh["sharded_granite_moe_2x2"] = info

    # ---- 33. the train CLI with --tp 2 on the 2 x 2 gloo mesh --------------
    # whisper-base at its full width and depth: the encoder-decoder family
    # through the CLI, and a final checkpoint of 0.9 GB, not qwen2's 17.8
    t0 = time.perf_counter()
    cli_arch = "whisper-base"
    ck = build / "sharded_cli_ckpt"
    import shutil
    shutil.rmtree(ck, ignore_errors=True)
    met = build / "sharded_cli_metrics.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.spawn", "--nprocs", "4",
         "--timeout", "600", "--", "-m", "repro_torch.launch.train",
         "--arch", cli_arch, "--tp", "2", "--backend", "gloo", "--steps", "2",
         "--batch", "8", "--seq", "256", "--ckpt-every", "0", "--ckpt-dir",
         str(ck), "--metrics", str(met), "--log-every", "1"],
        capture_output=True, text=True, timeout=700,
        env=dict(env, OMP_NUM_THREADS="2"), cwd=str(ROOT))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "sharded_train_cli.log").write_text(
        proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    lines = proc.stdout.splitlines()
    ck_bytes = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file()) \
        if ck.exists() else 0
    shutil.rmtree(ck, ignore_errors=True)
    if proc.returncode != 0 or not any(ln.startswith("done. loss ")
                                       for ln in lines) \
            or "mesh {'data': 2, 'model': 2} on gloo" not in proc.stdout:
        fail(f"sharded_train_cli: rc {proc.returncode}, out {lines[-8:]}, "
             f"err {proc.stderr[-2000:]}")
    metrics = json.loads(met.read_text())
    info = dict(backend="gloo", mesh=[2, 2], arch=cli_arch, steps=2,
                batch=8, seq=256, lines=lines, checkpoint_bytes=ck_bytes,
                losses=metrics["losses"], seconds=time.perf_counter() - t0)
    phase("sharded_train_cli", **info)
    sh["sharded_train_cli"] = info
    report["sharding"] = sh
    return sh


# production cells of the dry run's phase: one per family kind, each the
# most expensive of its mode that fits the phase's budget
DRY_CELLS = (("qwen2-72b", "train_4k", "pod"),
             ("mixtral-8x7b", "decode_32k", "multipod"),
             ("zamba2-7b", "long_500k", "pod"))
DRY_TERMS = ("compute_s", "memory_s", "collective_s")


def check_dry_cell(name: str, c: dict):
    """The reference's artifact checks on one cell's JSON."""
    t = c["terms"]
    if not (c.get("ok") and all(v >= 0 for v in t.values())
            and c["op_flops_per_device"] > 0 and c["dominant"] in DRY_TERMS
            and 0 < c["useful_flops_ratio"] < 5):
        fail(f"dry run {name}: {json.dumps(c, default=str)[:2000]}")


def dryrun_phases(report: dict) -> dict:
    """The eleventh slice's path: the dry run (`launch/dryrun.py`, its
    `OpCounter`) held against a real train step on the card, three
    production cells on meta, `--sim-accel` card against CPU. Returns the
    `dryrun` line's numbers."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.launch import dryrun as dr
    from repro_torch.models.zoo import ModelBundle

    cuda = torch.device("cuda")
    total = torch.cuda.get_device_properties(0).total_memory
    dp = dict(card=report["environment"]["card"], total_memory=total,
              hbm_bytes_constant=dr.HBM_BYTES)
    if total != dr.HBM_BYTES:
        print(f"note: this card has {total} bytes, dryrun.HBM_BYTES is "
              f"{dr.HBM_BYTES}", flush=True)

    # ---- 34. the validation cell: the dry run against a real step -------
    arch, B, L = "qwen2-1.5b", 8, 1024
    cfg = get_config(arch)
    reset_launch_counts()
    t0 = time.perf_counter()
    dry = dr.count_cell(cfg, dr.dry_mesh((1, 1), ("data", "model")), seq=L,
                        batch=B, mode="train")
    dry_s = time.perf_counter() - t0
    terms, dominant, bound_s = dr.roofline(dry)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    bundle = ModelBundle(cfg)
    model = bundle.init(torch.Generator(device=cuda).manual_seed(0))
    opt = bundle.opt_init(model)
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=L,
                                       global_batch=B, seed=0))
    data = [{k: torch.from_numpy(v).to(cuda)
             for k, v in ds.global_batch_at(i).items()} for i in range(3)]
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - base \
        - sum(t.untyped_storage().nbytes() for b in data[1:]
              for t in b.values())
    step = bundle.train_step()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    real = dr.count_step(step, (model, opt, data[0]), None)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    # the counted step's peak, less what the card held before the model
    # and the two batches of the timed steps
    peak = torch.cuda.max_memory_allocated() - base \
        - sum(t.untyped_storage().nbytes() for b in data[1:]
              for t in b.values())
    ms = []
    for b in data[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, opt, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    no_launches("dryrun_validation", launch_counts())
    gemm = train_bound(cfg, bundle, B, L)
    flops_gap = abs(real["flops"] - dry["flops"]) / dry["flops"]
    vinfo = dict(
        arch=arch, batch=B, seq=L, layers=cfg.layers, mesh="1 x 1 dry",
        dry_host_s=dry_s, counted_step_host_s=counted_s,
        dry_flops=dry["flops"], real_flops=real["flops"],
        flops_rel_gap=flops_gap,
        dry_hbm_bytes=dry["hbm_bytes"], real_hbm_bytes=real["hbm_bytes"],
        dry_arg_bytes=dry["arg_bytes"], real_arg_bytes=real["arg_bytes"],
        real_allocated_for_args=allocated,
        dry_peak_bytes=dry["peak_bytes"], real_peak_bytes=peak,
        peak_ratio=dry["peak_bytes"] / peak,
        real_counted_peak_bytes=real["peak_bytes"],
        terms=terms, dominant=dominant, roofline_bound_ms=bound_s * 1e3,
        step_ms_all=ms, step_ms=min(ms),
        step_over_bound=min(ms) / (bound_s * 1e3),
        compute_ms=terms["compute_s"] * 1e3,
        gemm_bound_ms=gemm["gemm_bound_ms"],
        compute_over_gemm_bound=terms["compute_s"] * 1e3
        / gemm["gemm_bound_ms"],
        top_ops={k: v for k, v in sorted(
            dry["ops"].items(), key=lambda kv: -kv[1]["flops"])[:4]})
    phase("dryrun_validation", **vinfo)
    if flops_gap > 1e-6:
        fail(f"dryrun_validation: counted FLOPs {real['flops']} on the card, "
             f"{dry['flops']} dry")
    if dry["arg_bytes"] != real["arg_bytes"]:
        fail(f"dryrun_validation: argument bytes {dry['arg_bytes']} dry, "
             f"{real['arg_bytes']} on the card")
    if abs(vinfo["peak_ratio"] - 1) > 0.1:
        fail(f"dryrun_validation: dry peak {dry['peak_bytes']}, the card's "
             f"{peak}")
    if min(ms) < bound_s * 1e3:
        fail(f"dryrun_validation: a step of {min(ms)} ms under the roofline "
             f"bound {bound_s * 1e3} ms")
    dp["validation"] = vinfo
    del model, opt, data, real
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 35. production cells on meta -----------------------------------
    cells = {}
    for arch_, shape, mesh in DRY_CELLS:
        reset_launch_counts()
        t0 = time.perf_counter()
        c = dr.run_cell(arch_, shape, mesh)
        wall = time.perf_counter() - t0
        name = f"{arch_}__{shape}__{mesh}"
        no_launches(f"dry run {name}", launch_counts())
        check_dry_cell(name, c)
        cells[name] = dict(wall_s=wall, **{k: c[k] for k in (
            "host_s", "chips", "op_flops_per_device", "op_bytes_per_device",
            "collective_bytes_per_chip", "arg_bytes_per_device",
            "peak_bytes_per_device", "fits_hbm", "useful_flops_ratio",
            "terms", "dominant", "roofline_bound_s")})
    phase("dryrun_production_cells", **cells)
    dp["production_cells"] = cells

    # ---- 36. --sim-accel on the card against the CPU ---------------------
    sims = {}
    for dname in ("cuda", "cpu"):
        reset_launch_counts()
        t0 = time.perf_counter()
        c = dr.run_cell("qwen2-1.5b", "decode_32k", "pod",
                        sim_accel="paper-128", device=dname)
        no_launches(f"dry run sim-accel ({dname})", launch_counts())
        sims[dname] = dict(c["sim_accel"], wall_s=time.perf_counter() - t0,
                           op_flops_per_device=c["op_flops_per_device"])
    errs = {k: abs(sims["cuda"][k] - sims["cpu"][k])
            / max(abs(sims["cpu"][k]), 1e-30)
            for k in ("total_cycles", "stall_cycles", "energy_pj",
                      "utilization", "modeled_s")}
    sinfo = dict(cell="qwen2-1.5b__decode_32k__pod", card=sims["cuda"],
                 cpu=sims["cpu"], rel_err=errs)
    phase("dryrun_sim_accel", **sinfo)
    if not all_within(errs) or sims["cuda"]["device"] != "cuda" or \
            sims["cuda"]["op_flops_per_device"] != \
            sims["cpu"]["op_flops_per_device"]:
        fail(f"dryrun_sim_accel: card vs CPU {errs}")
    dp["sim_accel"] = sinfo
    return dp


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "the port on the GPU", file=sys.stderr)
        return 2
    # a deterministic cuBLAS workspace for the restart phase: read when
    # cuBLAS starts, before the first product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    from repro_torch.kernels.ellpack import ellpack as ek
    from repro_torch.kernels.replay import megakernel as mk
    from repro_torch.kernels.systolic import systolic as syk
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
    builds = (("replay_megakernel", mk.build), ("conflict_slowdown", ck.build),
              ("systolic_matmul", syk.build_matmul),
              ("wavefront_activity", syk.build_wavefront),
              ("ellpack_pack", ek.build))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        for f in [pool.submit(b) for _, b in builds]:
            f.result()
    build_s = time.perf_counter() - t0
    logs = dict(replay_megakernel=mk.BUILD_LOG, conflict_slowdown=ck.BUILD_LOG,
                systolic_matmul=syk.MATMUL_BUILD_LOG,
                wavefront_activity=syk.WAVEFRONT_BUILD_LOG,
                ellpack_pack=ek.BUILD_LOG)
    ptxas = {name: sorted({ln.split(":", 1)[-1].strip()
                           for ln in logs[name].splitlines()
                           if "registers" in ln or "spill" in ln})
             for name, _ in builds}
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

    # ---- 3a'. the replay kernel's multi-core, per-channel-queue mode -------
    # seeded random merged streams (4 streams of 400 requests each) with
    # n_cores in {2, 4, 16}, a queue group per channel for 1, 2, 4 and 16
    # channels, chunks of 32 and 64 (registers) and 128 (shared memory),
    # queues 8 / 4 under saturating traffic and 128 / 128 under spread
    # traffic: counts exact, done and shift within 1e-3; then the
    # multi-core instance at n_cores = n_qg = 1 against the single-core
    # one, bit for bit
    def mc_case(seed, n, S, cores, cfg, C, saturate, *, n_qg, grouped=False):
        rng = np.random.default_rng(seed)
        shape = (S, n)
        t = np.sort(rng.uniform(0.0, 3.0 * n, shape), axis=-1)
        if saturate:
            t, addr = t * 0.01, rng.integers(0, 64, shape) * 64
        else:
            addr = (rng.integers(0, 1 << 22, shape) // 64) * 64
        w = rng.random(shape) < 0.3
        v = rng.random(shape) < 0.9
        cid = rng.integers(0, cores, shape).astype(np.int32)
        fb, ch, row = decode_requests(torch.tensor(addr, device=dev), cfg)
        ins = mk.prepare(torch.tensor(t.astype(np.float32), device=dev), fb,
                         ch, row, torch.tensor(w, device=dev),
                         torch.tensor(v, device=dev), C,
                         torch.tensor(cid, device=dev))
        return ins, dict(cfg=cfg, busy=max(1.0, 64 / 19.2), C=C,
                         max_passes=None, tol=0.25, n_cores=cores,
                         n_qg=n_qg)

    mc_checks = []
    for C in (32, 64, 128):
        for cores in (2, 4, 16):
            for channels in (1, 2, 4, 16):
                for q in ((8, 4), (128, 128)):
                    cfg = DramConfig(channels=channels, read_queue=q[0],
                                     write_queue=q[1])
                    sat = q == (8, 4)
                    ins, kw = mc_case(C * 1000 + cores * 100 + channels,
                                      400, 4, cores, cfg, C, sat,
                                      n_qg=channels)
                    dk, sk, ck_ = mk.launch_cuda(ins, **kw)
                    torch.cuda.synchronize()
                    dp, sp, cp, _ = mk.run_plain(ins, **kw)
                    name = f"C{C}_cores{cores}_ch{channels}_q{q[0]}_{q[1]}"
                    if not torch.equal(ck_, cp):
                        fail(f"multi-core {name}: kernel counts "
                             f"{ck_.sum(0).tolist()} != plain "
                             f"{cp.sum(0).tolist()}")
                    err = max(rel_err(dk, dp), rel_err(sk, sp))
                    if err > RTOL:
                        fail(f"multi-core {name}: kernel done/shift differ "
                             f"from plain by {err:.3g}")
                    mc_checks.append(dict(
                        name=name, max_rel=err,
                        max_abs=float((dk - dp).abs().max()),
                        max_shift=float(sp.max())))
    bitwise = []
    for C in (32, 64, 128):
        for sat, q in ((True, (8, 4)), (False, (128, 128))):
            cfg = DramConfig(read_queue=q[0], write_queue=q[1])
            ins, kw = mc_case(C + 7, 1500, 6, 1, cfg, C, sat, n_qg=1)
            one = mk.launch_cuda(ins, **kw)
            grp = mk.launch_cuda(ins, grouped=True, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(one, grp)):
                fail(f"the multi-core instance at one core and one queue "
                     f"group differs from the single-core one (C={C}, "
                     f"queues {q})")
            bitwise.append(f"C{C}_q{q[0]}_{q[1]}")
    try:
        mk.launch_cuda(ins, **dict(kw, n_cores=mk.MAX_CORES + 1))
        fail("the replay wrapper took more cores than the kernel's limit")
    except ValueError:
        pass
    mc_info = dict(cases=len(mc_checks),
                   max_rel=max(c["max_rel"] for c in mc_checks),
                   max_abs=max(c["max_abs"] for c in mc_checks),
                   saturated_cases_with_shift=sum(
                       c["max_shift"] > 0 for c in mc_checks),
                   bit_for_bit_one_core=bitwise)
    phase("replay_multicore_kernel_vs_plain", **mc_info)
    report["replay_multicore_kernel_vs_plain"] = dict(mc_info,
                                                      checks=mc_checks)

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
    for k in (1, 31, 32, 33, 64, 65, 127, 128, 129, 256, 257, 1024):
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
    # bank ids outside [0, num_banks), negative ones included, count in
    # no bank, as in the Pallas kernel
    for k in (1, 32, 33, 128, 256, 257):
        rng = np.random.default_rng(k + 7)
        bank = rng.integers(-3, 35, (300, k))
        bank[0] = 32                                # every id out of range
        ccases.append(conflict_case(f"out_of_range_k{k}",
                                    rng.integers(0, 11, (300, k)), bank, 32,
                                    1))
    # 64-bit keys: lines up to 2^31 - 1 and 1,024 banks, at every
    # instance width; and ids one element into a buffer (element loads)
    for k in (32, 64, 128, 256, 257):
        rng = np.random.default_rng(k)
        line = rng.integers(0, 2 ** 31 - 1, (300, k), endpoint=True)
        line[::3] = rng.integers(0, 64, (100, k)) * (2 ** 31 // 64)
        bank = rng.integers(0, 1024, (300, k))
        line[0], bank[0] = 2 ** 31 - 1, 1023
        ccases.append(conflict_case(f"wide_k{k}", line, bank, 1024, 2))
    for k in (32, 128, 256):
        rng = np.random.default_rng(k + 1)
        buf_l = torch.zeros(300 * k + 1, dtype=torch.int32, device=dev)
        buf_b = torch.zeros_like(buf_l)
        buf_l[1:] = torch.as_tensor(rng.integers(0, 11, 300 * k),
                                    dtype=torch.int32)
        buf_b[1:] = torch.as_tensor(rng.integers(0, 32, 300 * k),
                                    dtype=torch.int32)
        ccases.append(conflict_case(f"misaligned_k{k}",
                                    buf_l[1:].view(300, k),
                                    buf_b[1:].view(300, k), 32, 1))
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

    # ---- 3c. the fold and ELLPACK kernels vs plain -------------------------
    from repro_torch.kernels.ellpack.ref import (ellpack_pack_plain,
                                                 ellpack_pack_reference)
    from repro_torch.kernels.systolic import ref as sref
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain matmul
    g = torch.Generator(device=dev).manual_seed(13)
    ncases = {"systolic_matmul": 0, "wavefront_activity": 0,
              "ellpack_pack": 0}
    mm_err = {}
    for T, R, C in ((197, 128, 128), (300, 32, 130), (1, 128, 128),
                    (0, 8, 8), (65, 17, 1)):
        for xd, wd in ((torch.float32, torch.float32),
                       (torch.bfloat16, torch.bfloat16),
                       (torch.float16, torch.float16),
                       (torch.float32, torch.bfloat16),
                       (torch.bfloat16, torch.float16)):
            x = torch.randn((T, R), generator=g, device=dev).to(xd)
            w = torch.randn((R, C), generator=g, device=dev).to(wd)
            got = syk.systolic_matmul(x, w)
            torch.cuda.synchronize()
            want = sref.systolic_matmul_reference(x, w)
            f32 = want.dtype == torch.float32
            ok, err = within(got, want, 1e-5 if f32 else 2e-2, 1e-4)
            if not ok or got.dtype != want.dtype:
                fail(f"systolic_matmul {T}x{R}x{C} {xd}x{wd}: max abs "
                     f"{err} from the plain version ({got.dtype})")
            key = "float32" if f32 else "half"
            mm_err[key] = max(mm_err.get(key, 0.0), err)
            ncases["systolic_matmul"] += 1
    try:
        syk.systolic_matmul(x.to(torch.int32), w.to(torch.int32))
        fail("systolic_matmul took int32 operands")
    except TypeError:
        pass
    for Ts, R, C, n_cycles in (([197], 128, 128, 451), ([1], 128, 128, 300),
                               ([16, 32, 64, 100, 0], 8, 8, 78),
                               ([], 8, 8, 10),
                               (list(range(1, 400, 7)), 64, 32, 512),
                               ([5, 9, 13, -2, 0], 7, 3, 41),
                               ([60_000], 2, 3, 70_001),
                               ([0], 128, 128, 3), ([1], 1, 1, 1)):
        t = torch.tensor(Ts, dtype=torch.int32, device=dev)
        got = syk.wavefront_activity_batched(t, R=R, C=C, n_cycles=n_cycles)
        one = (syk.wavefront_activity(Ts[0], R=R, C=C, n_cycles=n_cycles,
                                      device=dev) if len(Ts) == 1 else None)
        torch.cuda.synchronize()
        want = sref.wavefront_activity_plain(t, R=R, C=C, n_cycles=n_cycles)
        if not (torch.equal(got, want) and torch.equal(
                got, sref.wavefront_closed_form(t, R=R, C=C,
                                                n_cycles=n_cycles))):
            fail(f"wavefront kernel differs from plain for Ts={Ts[:4]}...")
        if one is not None and not torch.equal(one, want[0]):
            fail(f"one-fold wavefront entry differs from plain for T={Ts}")
        ncases["wavefront_activity"] += 1
    # each case aligned (the vector path where the kernel has an instance
    # for it) and as a view one element into its buffer (the scalar path)
    ell_paths = {"vector": 0, "scalar": 0}
    for rows, K, m, keep, dt in ((768, 3072, 4, 0, torch.float32),
                                 (33, 48, 4, 0, torch.float32),
                                 (64, 64, 8, 0, torch.bfloat16),
                                 (40, 64, 8, 6, torch.float16),
                                 (16, 32, 4, 3, torch.float32),
                                 (0, 32, 4, 0, torch.float32),
                                 (77, 96, 4, 0, torch.bfloat16),
                                 (300, 256, 4, 0, torch.float16),
                                 (129, 512, 16, 0, torch.float32),
                                 (65, 512, 16, 4, torch.bfloat16),
                                 (130, 64, 8, 4, torch.float32),
                                 (99, 64, 2, 1, torch.float32),
                                 (50, 96, 8, 4, torch.float32)):
        buf = torch.randn(rows * K + 1, generator=g, device=dev)
        buf = torch.where(torch.rand(rows * K + 1, generator=g, device=dev)
                          < 0.5, buf, 0.0).to(dt)
        if rows:
            buf[:K] = 1.0                       # blocks with more than keep
            buf[K + 1: K + 1 + K // 2] = -0.0   # negative zeros are zeros
        bits = torch.int32 if dt == torch.float32 else torch.int16
        for view in (False, True):
            w = (buf[1:] if view else buf[:-1]).view(rows, K)
            path = ek.path_for(w, m, keep or max(1, m // 2))
            if view and rows and path != "scalar":
                fail(f"ELLPACK: a view one element into its buffer took "
                     f"the {path} path ({rows}x{K}, m={m}, {dt})")
            got = ek.ellpack_pack(w, m=m, keep=keep)
            torch.cuda.synchronize()
            # bit for bit against the plain version; against the sort-based
            # reference by value (its padding may keep a block's -0.0)
            plain = ellpack_pack_plain(w, m=m, keep=keep)
            ref = ellpack_pack_reference(w, m=m, keep=keep)
            if not (torch.equal(got[0].view(bits), plain[0].view(bits))
                    and torch.equal(got[1], plain[1])
                    and torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1])):
                fail(f"ELLPACK kernel ({path} path) differs from plain "
                     f"({rows}x{K}, m={m}, keep={keep}, {dt}, view={view})")
            ell_paths[path] += 1
            ncases["ellpack_pack"] += 1
    phase("fold_ellpack_kernels_vs_plain", cases=ncases,
          ellpack_paths=ell_paths, matmul_max_abs=mm_err)
    report["fold_ellpack_kernels_vs_plain"] = dict(
        cases=ncases, ellpack_paths=ell_paths, matmul_max_abs=mm_err)

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
    # through the wrapper, the kernel alone (graph replays of launches
    # without the id check's device sync), the plain version, the bound
    grp = replay_shape_info(mk, ins, kw)
    kernel_ms, kernel_graph_ms = grp["ms"], grp["graph_ms"]
    plain_ms, max_abs = grp["plain_ms"], grp["max_abs_err"]

    # the streams generated on the card equal the CPU's, bit for bit
    # (the first designs' unique streams lead the batch, in design order)
    cpu_strm, cpu_scale, _ = sim.decoded_streams(
        ws[:4], wl["vit_base"], "ws", 2, DramConfig(), DEFAULT_SPEC, "cpu")
    u = cpu_strm[0].shape[0]
    for a, b in zip(strm + (scale,), cpu_strm + (cpu_scale,)):
        if not torch.equal(a[:u].cpu(), b):
            fail("demand streams generated on the card differ from the CPU's")

    # what the kernel's int32 interface moves: six words in per request
    # (the core id is not read), one out (recorded, not used for bound_ms)
    io_bytes = S * npad * (6 * 4 + 4) + S * (4 + 16)
    replay_group = dict(
        gen_decode_s=gen_s, kernel_ms=kernel_ms,
        kernel_graph_ms=kernel_graph_ms,
        **{k: v for k, v in grp.items() if k not in ("ms", "graph_ms")},
        interface_bytes=io_bytes,
        interface_bytes_ms=io_bytes / HBM_BYTES_PER_S * 1e3)
    # the same streams in chunks of 128: the kernel's shared-memory
    # instance (C > 64), which no path of the port runs, timed beside it
    ins2 = mk.prepare(*strm, 128)
    kw2 = dict(kw, C=128)
    k2_ms = timed_cuda(lambda: mk.launch_cuda(ins2, **kw2), reps=20)
    dk2, sk2, ck2 = mk.launch_cuda(ins2, **kw2)
    dp2, sp2, cp2, passes2 = mk.run_plain(ins2, **kw2)
    if not torch.equal(ck2, cp2):
        fail("vit_base group, C = 128: kernel counts differ from plain")
    err2 = max(rel_err(dk2, dp2), rel_err(sk2, sp2))
    if err2 > RTOL:
        fail(f"vit_base group, C = 128: kernel differs from plain by {err2}")
    replay_group["chunk_128"] = dict(
        kernel_ms=k2_ms, max_rel_err=err2,
        mean_passes=float(passes2.double().mean()))
    phase("vit_base_trace_group", **replay_group)
    report["vit_base_trace_group"] = replay_group
    del ins, ins2, strm, dk2, dp2

    # ---- 6. the second slice's path: the feature sweep --------------------
    base, feat, fsweep = feature_sweep_study(wl)
    lay_cfg = LayoutConfig(enabled=True)
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
    fcpu = cpu_feature_frame(fsweep)
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
        prof = profile_run(lambda: fsweep.fidelity(fid).run(),
                           kernels=("conflict",))
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
    # device time by graph replay; `loop_ms` by events around a host loop
    # (the earlier measure, from when the kernel outlasted a launch)
    conflict_ms = timed_graph(lambda: ck.conflict_slowdown(line, bank, **kwc))
    conflict_loop_ms = timed_cuda(
        lambda: ck.conflict_slowdown(line, bank, **kwc), reps=20)
    got = ck.conflict_slowdown(line, bank, **kwc)
    conflict_plain_ms = host_ms(
        lambda: conflict_slowdown_reference(line, bank, **kwc), reps=5)
    want = conflict_slowdown_reference(line, bank, **kwc)
    if not torch.equal(got, want):
        fail("largest layout group: conflict kernel differs from plain")
    # the least time: each id read once (line and bank, int32), each
    # slowdown written once; the k log2 k compares of a comparison sort per
    # row, at the float32 non-tensor rate (the card's integer compares
    # issue on the same pipes at no higher rate)
    c_bytes = rows * r_cap * 8 + rows * 4
    c_ops = rows * r_cap * np.log2(r_cap)
    c_bytes_ms = c_bytes / HBM_BYTES_PER_S * 1e3
    c_ops_ms = c_ops / FP32_OPS_PER_S * 1e3
    layout_group = dict(
        designs=len(gcfgs), gemms=len(gemms), distinct_rows=R.tolist(),
        rows=rows, k=r_cap, kernel_ms=conflict_ms,
        loop_ms=conflict_loop_ms, plain_ms=conflict_plain_ms, max_abs_err=0,
        mean_slowdown=float(got.double().mean()), bytes=c_bytes, ops=c_ops,
        bytes_ms=c_bytes_ms, ops_ms=c_ops_ms,
        bound_ms=max(c_bytes_ms, c_ops_ms),
        bound_by="bytes" if c_bytes_ms >= c_ops_ms else "operations")
    phase("largest_layout_group", **layout_group)
    report["largest_layout_group"] = layout_group

    # ---- each conflict instance, timed: the largest layout group, then
    # random rows of 128 M ids at k = 32 / 64 / 128 / 256 with small ids
    # (32-bit keys) and with lines up to 2^31 - 1 (64-bit keys); every
    # instance that can take k, each equal to the plain version; device
    # time by graph replay
    def instance_times(lt, bt, banks, reps):
        k = int(lt.shape[1])
        want = conflict_slowdown_reference(lt, bt, num_banks=banks, ports=1)
        out = {}
        for inst in [w for w in ck.INSTANCES if w == -1 or w >= k]:
            got = ck.conflict_slowdown(lt, bt, num_banks=banks,
                                       instance=inst)
            if not torch.equal(got, want):
                fail(f"conflict instance {inst}, k={k}: differs from plain")
            out["smem" if inst == -1 else f"regs{inst}"] = timed_graph(
                lambda: ck.conflict_slowdown(lt, bt, num_banks=banks,
                                             instance=inst), reps=reps)
        return out

    cinst = dict(default=dict((str(k), ck.instance_for(k))
                              for k in (32, 64, 128, 129, 256, 257)),
                 largest_layout_group=instance_times(
                     line, bank, lay_cfg.num_banks, 20))
    g = torch.Generator(device=dev).manual_seed(1)
    for k in (32, 64, 128, 256):
        n = (1 << 27) // k
        for ids in ("narrow", "wide"):
            hi = 64 if ids == "narrow" else 2 ** 31 - 1
            lt = torch.randint(0, hi, (n, k), generator=g, device=dev,
                               dtype=torch.int32)
            bt = torch.randint(0, 32, (n, k), generator=g, device=dev,
                               dtype=torch.int32)
            t = instance_times(lt, bt, 32, 5)
            t["bound_ms"] = (n * k * 8 + n * 4) / HBM_BYTES_PER_S * 1e3
            cinst[f"random_{n}x{k}_{ids}"] = t
            del lt, bt
    phase("conflict_instances", **cinst)
    report["conflict_instances"] = cinst

    # ---- 7. this slice's path: every vit_base fold on a 128 x 128 WS array
    from repro_torch.core.accelerator import SparsityConfig, tpu_like_config
    from repro_torch.core.dataflow import cdiv, compute_cycles, map_gemm
    from repro_torch.core.energy import instantaneous_power_trace
    from repro_torch.core.sparsity import (expected_rowwise_n,
                                           sample_rowwise_counts,
                                           storage_report)
    from repro_torch.kernels.ellpack import ops as eops
    from repro_torch.kernels.systolic import ops as sops
    A = 128
    pcfg = tpu_like_config(array=A)
    fold_ops = [o for o in wl["vit_base"] if o.kind == "gemm"]
    # set-up: seeded operands for every instance of every op, (Sr, Sc, T)
    # = (K, M, N) under ws; x (T, Sr) and w (Sr, Sc) cut into folds
    # zero-padded to the array: xf (fr, T, A), wf (fr, fc, A, A)
    rng = np.random.default_rng(13)
    t0 = time.perf_counter()
    jobs = []
    for op in fold_ops:
        Sr, Sc, T = map_gemm("ws", op.M, op.N, op.K)
        fr, fc = cdiv(Sr, A), cdiv(Sc, A)
        for _ in range(int(op.count)):
            X = torch.from_numpy(rng.standard_normal(
                (T, Sr), dtype=np.float32)).to(dev)
            W = torch.from_numpy(rng.standard_normal(
                (Sr, Sc), dtype=np.float32)).to(dev)
            xf = torch.zeros((T, fr * A), device=dev)
            xf[:, :Sr] = X
            wf = torch.zeros((fr * A, fc * A), device=dev)
            wf[:Sr, :Sc] = W
            jobs.append((op, X, W,
                         xf.reshape(T, fr, A).transpose(0, 1).contiguous(),
                         wf.reshape(fr, A, fc, A).permute(0, 2, 1, 3)
                         .contiguous()))
    torch.cuda.synchronize()
    fold_setup_s = time.perf_counter() - t0

    def fold_pass(todo):
        """simulate_fold on every fold of every job, the K-folds of each
        output column block summed; one power trace per op instance over
        its folds' activity."""
        out = []
        for op, X, W, xf, wf in todo:
            fr, fc = wf.shape[:2]
            cols, acts, utils, cycles = [], [], [], 0
            for j in range(fc):
                acc = None
                for i in range(fr):
                    f = sops.simulate_fold(xf[i], wf[i, j])
                    acc = f.out if acc is None else acc + f.out
                    acts.append(f.active)
                    utils.append(f.utilization)
                    cycles += f.cycles
                cols.append(acc)
            act = torch.stack(acts)
            out.append((torch.cat(cols, 1), act,
                         instantaneous_power_trace(act, pcfg), cycles,
                         torch.stack(utils)))
        return out

    syk.MATMUL_LAUNCHES = syk.WAVEFRONT_LAUNCHES = 0   # reset just before ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    folded = fold_pass(jobs)
    torch.cuda.synchronize()
    fold_wall_s = time.perf_counter() - t0
    fold_launches = dict(systolic_matmul=syk.MATMUL_LAUNCHES,
                         wavefront_activity=syk.WAVEFRONT_LAUNCHES)  # ... after
    n_folds = sum(int(j[4].shape[0] * j[4].shape[1]) for j in jobs)
    if fold_launches != dict(systolic_matmul=n_folds,
                             wavefront_activity=n_folds):
        fail(f"the fold pass launched {fold_launches}, expected one matmul "
             f"and one wavefront launch per fold ({n_folds})")
    floor, full = instantaneous_power_trace(
        torch.tensor([0, A * A], device=dev), pcfg).tolist()
    # a float32 sum's rounding error scales with the output's typical
    # size (sqrt(K) here), so each element's error is taken relative to
    # max(|whole|, rms(whole)); `max_rel_floor1` is the same against
    # max(|whole|, 1), recorded only
    cycles_by_op, fold_err, fold_err1 = {}, 0.0, 0.0
    for (op, X, W, _, _), (out, act, power, cycles, utils) in zip(jobs,
                                                                  folded):
        T = X.shape[0]
        cycles_by_op[op.name] = cycles_by_op.get(op.name, 0) + cycles
        want_act = torch.cat([torch.full((A,), A, dtype=torch.int32,
                                         device=dev),
                              sref.wavefront_activity_reference(
                                  T, A, A, device=dev)])
        if not torch.equal(act, want_act.expand_as(act)):
            fail(f"{op.name}: a fold's activity differs from the closed form")
        whole = sref.systolic_matmul_reference(X, W)
        diff = (out[:, :W.shape[1]] - whole).abs()
        err = float((diff / torch.maximum(
            whole.abs(), whole.square().mean().sqrt())).max())
        fold_err = max(fold_err, err)
        fold_err1 = max(fold_err1, rel_err(out[:, :W.shape[1]], whole))
        if err > 1e-4:
            fail(f"{op.name}: summed folds differ from the whole product by "
                 f"{err}")
        if float(power.min()) < floor or float(power.max()) > full:
            fail(f"{op.name}: power trace outside [{floor}, {full}] W")
        if not bool(((utils > 0) & (utils <= 1)).all()):
            fail(f"{op.name}: a fold's utilization outside (0, 1]")
    # controls for the summed-fold limit, read by the same measure: each
    # fold in TF32 (`torch.matmul` with TF32 on), and each fold from
    # bfloat16 operands rounded to bfloat16 as the port's bf16 fold is;
    # the limit must reject the bfloat16 control
    ctrl = dict(tf32=0.0, bf16=0.0)
    for op, X, W, xf, wf in jobs:
        whole = sref.systolic_matmul_reference(X, W)
        scale = torch.maximum(whole.abs(), whole.square().mean().sqrt())
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = torch.matmul(xf[:, None], wf)
        torch.backends.cuda.matmul.allow_tf32 = False
        bf16 = torch.matmul(xf[:, None].bfloat16().float(),
                            wf.bfloat16().float()).bfloat16().float()
        for key, y in (("tf32", tf32), ("bf16", bf16)):
            y = y.sum(0).transpose(0, 1).reshape(X.shape[0], -1)
            ctrl[key] = max(ctrl[key], float(
                ((y[:, :W.shape[1]] - whole).abs() / scale).max()))
    if ctrl["bf16"] <= 1e-4:
        fail(f"the summed-fold limit 1e-4 passes bfloat16 folds "
             f"({ctrl['bf16']})")
    for op in fold_ops:
        want = compute_cycles("ws", op.M, op.N, op.K, A, A) * int(op.count)
        if cycles_by_op[op.name] != want:
            fail(f"{op.name}: folds sum to {cycles_by_op[op.name]} cycles, "
                 f"compute_cycles x count = {want}")
    # one fold of each distinct shape against the plain version and the
    # per-cycle scan, in float32 and bfloat16
    shape_checks = []
    for T in sorted({j[1].shape[0] for j in jobs}):
        _, _, _, xf, wf = next(j for j in jobs if j[1].shape[0] == T)
        for dt, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            x, w = xf[0].to(dt), wf[0, 0].to(dt)
            got = sops.simulate_fold(x, w).out
            scan_out, scan_act = sref.systolic_ws_reference(x, w)
            ok1, e1 = within(got, sref.systolic_matmul_reference(x, w),
                             rtol, 1e-4)
            ok2, e2 = within(got, scan_out, rtol, 1e-4)
            if not (ok1 and ok2) or not torch.equal(
                    scan_act, sref.wavefront_activity_reference(
                        T, A, A, device=dev)):
                fail(f"fold {T}x{A}x{A} {dt}: vs plain {e1}, vs scan {e2}")
            shape_checks.append(dict(T=T, dtype=str(dt), max_abs_vs_plain=e1,
                                     max_abs_vs_scan=e2))
    fold_info = dict(
        ops=len(fold_ops), op_instances=len(jobs), folds=n_folds,
        launches=fold_launches, setup_s=fold_setup_s, wall_s=fold_wall_s,
        wall_ms_per_fold=fold_wall_s * 1e3 / n_folds,
        max_rel_summed_vs_whole=fold_err,
        max_rel_floor1_summed_vs_whole=fold_err1,
        max_rel_summed_tf32_control=ctrl["tf32"],
        max_rel_summed_bf16_control=ctrl["bf16"], shape_checks=shape_checks,
        power_floor_w=floor, power_full_w=full,
        total_cycles=sum(cycles_by_op.values()))
    phase("vit_base_fold_pass", **fold_info)
    report["vit_base_fold_pass"] = fold_info
    layer0 = [j for j in jobs if j[0].name.startswith("vitb_0_")]
    prof = profile_run(lambda: fold_pass(layer0),
                       kernels=("wavefront", "matmul_kernel"))
    prof["folds"] = sum(int(j[4].shape[0] * j[4].shape[1]) for j in layer0)
    phase("fold_pass_layer0_profile", **prof)
    report["fold_pass_layer0_profile"] = prof

    # ---- 8. batched_fold_activity: one launch per (workload, array) --------
    syk.WAVEFRONT_LAUNCHES = 0                        # reset just before ...
    batched = []
    for wname in ("resnet18", "vit_base"):
        Ts = [map_gemm("ws", o.M, o.N, o.K)[2] for o in wl[wname]
              if o.kind == "gemm"]
        tt = torch.tensor(Ts, dtype=torch.int32, device=dev)
        for arr in (32, 64, 128):
            n_cycles = max(Ts) + 2 * arr - 2
            act = sops.batched_fold_activity(tt, R=arr, C=arr,
                                             n_cycles=n_cycles)
            plain = sref.wavefront_activity_plain(tt, R=arr, C=arr,
                                                  n_cycles=n_cycles)
            if not torch.equal(act, plain) or not torch.equal(
                    act, sref.wavefront_closed_form(tt, R=arr, C=arr,
                                                    n_cycles=n_cycles)):
                fail(f"batched activity {wname} {arr}: kernel != plain or "
                     f"the closed form")
            if not torch.equal(act.sum(1, dtype=torch.int64),
                               tt.to(torch.int64) * arr * arr):
                fail(f"batched activity {wname} {arr}: a row does not sum "
                     f"to T R C")
            batched.append(dict(workload=wname, array=arr, folds=len(Ts),
                                n_cycles=n_cycles))
    batched_launches = syk.WAVEFRONT_LAUNCHES         # ... read just after
    if batched_launches != len(batched):
        fail(f"batched_fold_activity launched {batched_launches} times for "
             f"{len(batched)} calls")
    phase("batched_fold_activity", launches=batched_launches, calls=batched)
    report["batched_fold_activity"] = dict(launches=batched_launches,
                                           calls=batched)

    # ---- 9. ELLPACK on every vit_base weight matrix ------------------------
    mats = [("embed", 768, 768)] + [
        (f"{l}_{n}", r, k) for l in range(12)
        for n, r, k in (("qkv", 2304, 768), ("proj", 768, 768),
                        ("mlp1", 3072, 768), ("mlp2", 768, 3072))] + [
        ("head", 1000, 768)]
    gen = torch.Generator(device=dev).manual_seed(13)

    def pruned(rows, K, m, kept):
        """A (rows, K) float32 matrix, no value within 0.5 of 0, of which
        each m-block keeps `kept` (an int, or per-block counts) randomly
        placed nonzeros."""
        v = torch.randn((rows, K), generator=gen, device=dev)
        v = v + torch.where(v >= 0, 0.5, -0.5)
        rank = torch.rand((rows, K // m, m), generator=gen,
                          device=dev).argsort(-1).argsort(-1)
        if isinstance(kept, torch.Tensor):
            kept = kept[..., None]
        return torch.where((rank < kept).reshape(rows, K), v, 0.0)

    ek.LAUNCHES = 0                                  # reset just before ...
    t0 = time.perf_counter()
    ell = {}
    for label, n, m in (("2:4", 2, 4), ("4:8", 4, 8), ("rowwise:8", None, 8)):
        kept_sum = blocks = 0
        worst = 0.0
        values = 0
        for name, rows, K in mats:
            kept = n if n is not None else sample_rowwise_counts(gen, rows,
                                                                 K, m)
            w = pruned(rows, K, m, kept)
            vals, idx, rep = eops.pack_with_report(w, m=m)
            pv, pi = ellpack_pack_plain(w, m=m)
            if not (torch.equal(vals, pv) and torch.equal(idx, pi)):
                fail(f"ELLPACK {label} {name}: kernel differs from plain")
            values += rows * K
            if n is not None:
                want = storage_report(rows, K, SparsityConfig(
                    enabled=True, n=n, m=m, representation="ellpack_block"),
                    word_bytes=4)
                for k in ("original_bytes", "values_bytes", "metadata_bytes",
                          "total_bytes"):
                    e = abs(rep[k] - want[k]) / max(abs(want[k]), 1e-30)
                    worst = max(worst, e)
                    if e > 1e-6:
                        fail(f"ELLPACK {label} {name}: {k} {rep[k]} vs "
                             f"storage_report {want[k]}")
            else:
                kept_sum += int((idx >= 0).sum())
                blocks += rows * (K // m)
        row = dict(matrices=len(mats), values=values,
                   max_rel_vs_storage_report=worst)
        if n is None:
            mean = kept_sum / blocks
            row.update(mean_kept=mean, expected=expected_rowwise_n(m))
            if abs(mean / expected_rowwise_n(m) - 1) > 0.01:
                fail(f"ELLPACK row-wise: mean kept {mean} vs "
                     f"{expected_rowwise_n(m)}")
        ell[label] = row
    torch.cuda.synchronize()
    ell_wall_s = time.perf_counter() - t0
    ell_launches = ek.LAUNCHES                       # ... read just after
    if ell_launches != 3 * len(mats):
        fail(f"the ELLPACK pass launched {ell_launches} times, expected one "
             f"per matrix ({3 * len(mats)})")
    ell_info = dict(launches=ell_launches, wall_s=ell_wall_s, passes=ell)
    phase("vit_base_ellpack", **ell_info)
    report["vit_base_ellpack"] = ell_info

    # ---- 10. the new kernels at their path shapes, timed --------------------
    # device time per call by CUDA events around CUDA-graph replays (the
    # host's launch cost is longer than these kernels); `loop_ms` is the
    # same by events around a host loop of calls, launch cost included
    x0, w0 = next(j for j in jobs if j[0].name == "vitb_0_qkv")[3:5]
    x0, w0 = x0[0], w0[0, 0]                 # one qkv fold, 197 x 128 x 128
    T0 = x0.shape[0]
    mm = dict(ms=timed_graph(lambda: syk.systolic_matmul(x0, w0)),
              loop_ms=timed_cuda(lambda: syk.systolic_matmul(x0, w0), 50),
              plain_ms=timed_graph(
                  lambda: sref.systolic_matmul_reference(x0, w0)),
              library_ms=timed_graph(lambda: torch.matmul(x0, w0)),
              blocks=syk.matmul_blocks(T0, A))
    if mm["blocks"] <= 8:
        fail(f"the qkv fold's matmul runs on {mm['blocks']} blocks")
    # every distinct fold shape of the fold pass, each timed in turn
    # (kernel, torch.matmul, plain, kernel) beside its bound
    mm_shapes = []
    for T in sorted({j[1].shape[0] for j in jobs}, reverse=True):
        xs_, ws_ = next(j for j in jobs if j[1].shape[0] == T)[3:5]
        xs_, ws_ = xs_[0], ws_[0, 0]
        k1 = timed_graph(lambda: syk.systolic_matmul(xs_, ws_))
        lib = timed_graph(lambda: torch.matmul(xs_, ws_))
        pl = timed_graph(lambda: sref.systolic_matmul_reference(xs_, ws_))
        k2 = timed_graph(lambda: syk.systolic_matmul(xs_, ws_))
        ok, e = within(syk.systolic_matmul(xs_, ws_),
                       sref.systolic_matmul_reference(xs_, ws_), 1e-5, 1e-4)
        if not ok:
            fail(f"fold {T}x{A}x{A}: kernel vs plain max abs {e}")
        b_ms = (T * A + A * A + T * A) * 4 / HBM_BYTES_PER_S * 1e3
        o_ms = 2 * T * A * A / FP32_OPS_PER_S * 1e3
        mm_shapes.append(dict(shape=[T, A, A], blocks=syk.matmul_blocks(T, A),
                              ms_runs=[k1, k2], ms=min(k1, k2),
                              library_ms=lib, plain_ms=pl, max_abs_err=e,
                              bound_ms=max(b_ms, o_ms),
                              bound_by="bytes" if b_ms >= o_ms
                              else "operations"))
    mm["fold_shapes"] = mm_shapes
    mm_ok, mm_abs = within(syk.systolic_matmul(x0, w0),
                           sref.systolic_matmul_reference(x0, w0), 1e-5,
                           1e-4)
    if not mm_ok:
        fail(f"qkv fold: kernel vs plain max abs {mm_abs}")
    mm_bytes = (T0 * A + A * A + T0 * A) * 4
    mm_ops = 2 * T0 * A * A
    rs = [map_gemm("ws", o.M, o.N, o.K)[2] for o in wl["resnet18"]
          if o.kind == "gemm"]
    big_t = torch.tensor(rs, dtype=torch.int32, device=dev)
    big_n = max(rs) + 2 * A - 2
    wave_kw = dict(R=A, C=A, n_cycles=big_n)
    wv = dict(ms=timed_graph(
        lambda: syk.wavefront_activity_batched(big_t, **wave_kw)),
        loop_ms=timed_cuda(
            lambda: syk.wavefront_activity_batched(big_t, **wave_kw), 50),
        plain_ms=timed_graph(
            lambda: sref.wavefront_activity_plain(big_t, **wave_kw)))
    # the function needs O(1) work per (fold, cycle): active(n) counts the
    # points t + r + c = n of the T x R x C box, by inclusion-exclusion
    # over its three upper faces, eight terms g(n - offset) with g(k) =
    # C(k + 2, 2) the non-negative triples summing to k; held equal to the
    # kernel here, so the bound counts these operations, not the row loop
    got_wv = syk.wavefront_activity_batched(big_t, **wave_kw)
    if not torch.equal(got_wv, sref.wavefront_closed_form(big_t,
                                                          **wave_kw)):
        fail("wavefront kernel differs from the inclusion-exclusion form")
    # each fold's T read once, each count written once
    wv_bytes = len(rs) * 4 + len(rs) * big_n * 4
    # per (fold, cycle) and term: the offset subtracted, one added, the
    # clamp at 0, one added, a multiply, a halving and the accumulation
    wv_ops = len(rs) * big_n * 8 * 7
    # one vit_base qkv fold's wavefront launch on the fold pass: the
    # one-fold entry (T an argument), and the batched entry on a one-element
    # T tensor made per call as the fold pass made it before; beside them
    # the floor, an empty kernel launched the same way (ctypes, the
    # library's own entry), by graph replay and by host loop
    fold_wv_n = T0 + 2 * A - 2
    fold_wv_bound_ms = max((4 + fold_wv_n * 4) / HBM_BYTES_PER_S,
                           fold_wv_n * 8 * 7 / FP32_OPS_PER_S) * 1e3
    one_kw = dict(R=A, C=A, n_cycles=fold_wv_n)
    if not torch.equal(syk.wavefront_activity(T0, device=dev, **one_kw),
                       sref.wavefront_activity_reference(T0, A, A,
                                                         device=dev)):
        fail("qkv fold: the one-fold wavefront entry differs from the "
             "closed form")

    def one_fold():
        syk.wavefront_activity(T0, device=dev, **one_kw)

    def one_tensor():
        syk.wavefront_activity_batched(
            torch.full((1,), T0, dtype=torch.int32, device=dev), **one_kw)

    floor_kw = {}
    for name, fn in (("floor", syk.launch_floor), ("scalar_T", one_fold),
                     ("tensor_T", one_tensor), ("floor_2", syk.launch_floor),
                     ("scalar_T_2", one_fold)):
        floor_kw[name] = dict(graph_ms=timed_graph(fn),
                              loop_ms=timed_cuda(fn, 200))
    wv_one = dict(T=T0, n_cycles=fold_wv_n, bound_ms=fold_wv_bound_ms,
                  runs=floor_kw,
                  ms=min(floor_kw["scalar_T"]["graph_ms"],
                         floor_kw["scalar_T_2"]["graph_ms"]),
                  floor_ms=min(floor_kw["floor"]["graph_ms"],
                               floor_kw["floor_2"]["graph_ms"]))
    er, eK, em = 768, 3072, 4                # the mlp2 weight, 2:4
    mlp2 = pruned(er, eK, em, 2)
    if ek.path_for(mlp2, em, em // 2) != "vector":
        fail("the mlp2 weight does not take the ELLPACK vector path")
    # the matrix read once; keep = m / 2 values and their int32 indices
    # written per block
    ep_bytes = er * eK * 4 + er * (eK // em) * (em // 2) * (4 + 4)
    ep_ops = er * eK * 2             # a compare and a count per element

    def ellpack_case(w, m):
        """One packer input timed in turns (kernel, plain, kernel) beside
        its bytes bound, on the path the kernel picks for it. `ms` is
        cold: the graph's calls rotate over copies of w, one rotation
        moving over 100 MB (twice the L2), and keep every output, so each
        call reads and writes device memory as the bound assumes;
        `warm_ms` repeats the one input, whose bytes then stay in L2 (as
        on the ELLPACK pass, which packs each matrix right after making
        it)."""
        keep = max(1, m // 2)
        rows, K = w.shape
        eb = w.element_size()
        nbytes = rows * K * eb + rows * (K // m) * keep * (eb + 4)
        copies = [w.clone() if w.data_ptr() % 16 == 0 else
                  torch.empty(w.numel() + 1, dtype=w.dtype,
                              device=dev)[1:].view_as(w).copy_(w)
                  for _ in range(max(2, -(-100_000_000 // nbytes)))]
        turn = iter(range(1 << 30))

        def cold():
            x = copies[next(turn) % len(copies)]
            kept.append(ek.ellpack_pack(x, m=m))

        runs = {}
        for name in ("kernel", "plain", "kernel_2"):
            kept = []
            if name == "plain":
                runs[name] = timed_graph(lambda: ellpack_pack_plain(w, m=m))
                continue
            runs[name] = dict(
                warm_ms=timed_graph(lambda: ek.ellpack_pack(w, m=m)),
                cold_ms=timed_graph(cold))
        del kept
        return dict(shape=[rows, K], dtype=str(w.dtype)[6:], m=m, keep=keep,
                    path=ek.path_for(w, m, keep),
                    copies=len(copies), runs=runs,
                    ms=min(runs[k]["cold_ms"] for k in ("kernel", "kernel_2")),
                    warm_ms=min(runs[k]["warm_ms"]
                                for k in ("kernel", "kernel_2")),
                    plain_ms=runs["plain"], bytes=nbytes,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)

    # the mlp2 weight pruned 4:8, in bfloat16 at m = 8, and one element into
    # a buffer (the scalar path: the per-block thread of the earlier
    # design) beside the vector path, in turns
    ebuf = torch.empty(er * eK + 1, device=dev)
    ebuf[1:] = mlp2.reshape(-1)
    ell_cases = dict(
        f32_m4_vector=ellpack_case(mlp2, 4),
        f32_m4_unaligned=ellpack_case(ebuf[1:].view(er, eK), 4),
        f32_m4_vector_2=ellpack_case(mlp2, 4),
        f32_m8=ellpack_case(pruned(er, eK, 8, 4), 8),
        bf16_m8=ellpack_case(pruned(er, eK, 8, 4).to(torch.bfloat16), 8))
    if ell_cases["f32_m4_unaligned"]["path"] != "scalar":
        fail("an unaligned view took the ELLPACK vector path")
    # the kernel line's time: the vector path on the mlp2 weight, cold
    ep = dict(ms=min(ell_cases[k]["ms"] for k in ("f32_m4_vector",
                                                   "f32_m4_vector_2")),
              warm_ms=min(ell_cases[k]["warm_ms"]
                          for k in ("f32_m4_vector", "f32_m4_vector_2")),
              loop_ms=timed_cuda(lambda: ek.ellpack_pack(mlp2, m=em), 50),
              plain_ms=ell_cases["f32_m4_vector"]["plain_ms"])
    timings = {}
    for name, t, nbytes, ops in (("systolic_matmul", mm, mm_bytes, mm_ops),
                                 ("wavefront_activity", wv, wv_bytes, wv_ops),
                                 ("ellpack_pack", ep, ep_bytes, ep_ops)):
        bms = nbytes / HBM_BYTES_PER_S * 1e3
        oms = ops / FP32_OPS_PER_S * 1e3
        t.update(bytes=nbytes, ops=ops, bytes_ms=bms, ops_ms=oms,
                 bound_ms=max(bms, oms),
                 bound_by="bytes" if bms >= oms else "operations")
        timings[name] = t
    timings["systolic_matmul"].update(shape=[T0, A, A], max_abs_err=mm_abs)
    timings["wavefront_activity"].update(
        folds=len(rs), n_cycles=big_n, R=A, C=A,
        qkv_fold_n_cycles=fold_wv_n, qkv_fold_bound_ms=fold_wv_bound_ms,
        qkv_fold=wv_one)
    timings["ellpack_pack"].update(shape=[er, eK], m=em, keep=em // 2,
                                   path="vector", cases=ell_cases)
    phase("fold_ellpack_timings", **timings)
    report["fold_ellpack_timings"] = timings

    # ---- 11. this slice's path: shared-DRAM multi-core contention ---------
    import dataclasses
    from repro_torch.trace.contention import (contention_streams,
                                              shared_dram_result)
    cstudy = studies.multicore_contention()
    mk.LAUNCHES = 0                     # counts reset just before ...
    t0 = time.perf_counter()
    cres = cstudy.run()                 # the default: the card
    cstudy_s = time.perf_counter() - t0
    cont_launches = mk.LAUNCHES         # ... and read just after
    cclaims = cres.check_claims()
    if len(cclaims) != 3 or not all(cclaims.values()):
        fail(f"multicore_contention: claims {cclaims}")
    check_frame("multicore_contention", cres, 3)
    if cont_launches != 2 * len(cres):
        fail(f"multicore_contention launched the replay kernel "
             f"{cont_launches} times, expected 2 per cell (isolated batch, "
             f"merged stream)")
    t0 = time.perf_counter()
    ccpu = cstudy.run(device="cpu")
    ccpu_s = time.perf_counter() - t0
    if ccpu.meta.get("engine") != "torch:plain":
        fail(f"CPU contention study engine {ccpu.meta.get('engine')!r}")
    ccol_err = frame_rel_err(cres, ccpu)
    bad = {c: e for c, e in ccol_err.items() if not e <= RTOL}
    if bad:
        fail(f"multicore_contention: card frame differs from the CPU frame: "
             f"{bad}")
    cstudy_info = dict(
        claims=cclaims, engine=cres.meta.get("engine"),
        launches=cont_launches, wall_s=cstudy_s, cpu_wall_s=ccpu_s,
        max_rel_vs_cpu=max(ccol_err.values()),
        max_rel_vs_cpu_by_column=ccol_err,
        makespan_shared=list(cres["makespan_shared"]),
        makespan_isolated=list(cres["makespan_isolated"]),
        contention_slowdown=list(cres["contention_slowdown"]))
    phase("multicore_contention_study", **cstudy_info)
    report["multicore_contention_study"] = cstudy_info
    prof = profile_run(lambda: cstudy.run(), kernels=("replay",))
    phase("multicore_contention_profile", **prof)
    report["multicore_contention_profile"] = prof

    def contention_replays(cfg, private, tol=RTOL):
        """The two replays of `multicore_contention` (the isolated batch
        and the merged stream) by the kernel and by the plain version, both
        on the card, on the same inputs: counts exact, done and shift
        within `tol`; each run's per-core stalls from both; the kernel timed
        by CUDA events (through the wrapper, and by graph replay without
        the id check's sync) beside its bound."""
        st = contention_streams(cfg, 512, 2048, 1024, "spatial", private,
                                DEFAULT_SPEC, dev)
        scale = st["common_scale"]
        busy = max(1.0, 64 / cfg.dram.bandwidth_bytes_per_cycle)
        out = {}
        for run, n_cores in (("isolated", 1), ("shared", cfg.num_cores)):
            t, a, w, v, cid = st[run]
            fb, ch, row = decode_requests(a, cfg.dram)
            ins = mk.prepare(t, fb, ch, row, w, v, 64, cid)
            S, npad = ins[0].shape
            kw = dict(cfg=cfg.dram, busy=busy, C=64, max_passes=None,
                      tol=0.0, n_cores=n_cores, n_qg=cfg.dram.channels)
            ms = timed_cuda(lambda: mk.launch_cuda(ins, **kw), reps=5)
            graph_ms = timed_graph(
                lambda: mk.launch_cuda(ins, check_ids=False, **kw), reps=5,
                replays=2)
            dk, sk, ck_ = mk.launch_cuda(ins, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dp, sp, cp, passes = mk.run_plain(ins, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            if not torch.equal(ck_, cp):
                fail(f"contention {run} ({cfg.num_cores} cores, "
                     f"{cfg.dram.channels} channels): kernel counts differ "
                     f"from the plain version")
            err = max(rel_err(dk, dp), rel_err(sk, sp))
            if err > tol:
                fail(f"contention {run}: kernel differs from plain by {err}")
            vm = v.to(torch.bool).reshape(S, -1)
            res = [shared_dram_result(
                ins[0].reshape(S, -1)[:, :t.shape[-1]],
                vm, cid.reshape(S, -1),
                torch.where(vm, d.reshape(S, -1)[:, :t.shape[-1]], 0.0), sh,
                c[:, 0], c[:, 1], c[:, 2], n_cores, cfg.dram,
                torch.tensor(busy, dtype=torch.float32, device=dev))
                for d, sh, c in ((dk, sk, ck_), (dp, sp, cp))]
            stall_k = (res[0].per_core_stall.reshape(-1) * scale).tolist()
            stall_p = (res[1].per_core_stall.reshape(-1) * scale).tolist()
            serr = max(abs(a_ - b_) / max(abs(b_), 1.0)
                       for a_, b_ in zip(stall_k, stall_p))
            if serr > tol:
                fail(f"contention {run}: per-core stalls differ from the "
                     f"plain version's by {serr}")
            # the least time, as for the sweep's replay row, with the core
            # id a fifth word in and the shift per core out
            nv = ins[5].reshape(S, npad // 64, 64).sum(-1).double()
            ops = float(((8 + 3 * passes.double()) * nv).sum())
            nbytes = S * npad * (4 + 4 * 4) + S * npad // 4 + S * npad * 4 \
                + S * (4 * n_cores + 16)
            bms = nbytes / HBM_BYTES_PER_S * 1e3
            oms = ops / FP32_OPS_PER_S * 1e3
            out[run] = dict(
                streams=S, requests_per_stream=npad, n_cores=n_cores,
                queue_groups=cfg.dram.channels, kernel_ms=ms,
                graph_ms=graph_ms, plain_ms=plain_ms,
                max_abs_err=float((dk - dp).abs().max()), max_rel_err=err,
                stall_rel_err=serr, mean_passes=float(passes.double().mean()),
                max_passes=int(passes.max()), bytes=nbytes, ops=ops,
                bytes_ms=bms, ops_ms=oms, bound_ms=max(bms, oms),
                bound_by="bytes" if bms >= oms else "operations",
                interface_bytes=S * npad * (7 * 4 + 4),
                stall_kernel=stall_k, stall_plain=stall_p)
        comps, nop = st["compute"], st["skew"]

        def makespan(stalls):
            return max(c + o + x for c, o, x in zip(comps, nop, stalls))

        for who in ("kernel", "plain"):
            iso = out["isolated"][f"stall_{who}"]
            shr = out["shared"][f"stall_{who}"]
            out[f"makespan_{who}"] = dict(isolated=makespan(iso),
                                          shared=makespan(shr))
            out[f"per_core_rel_gap_{who}"] = max(
                abs(a_ - b_) / b_ for a_, b_ in zip(shr, iso))
        return out

    # the shared stream of mcm-4x32 at 4 channels (the study's last cell)
    mcm = contention_replays(rt.get_preset("mcm-4x32", channels=4), False)
    phase("contention_mcm_4ch_replays",
          **{k: v for k, v in mcm.items() if k not in ("isolated", "shared")},
          isolated={k: v for k, v in mcm["isolated"].items()
                    if not k.startswith("stall_")},
          shared={k: v for k, v in mcm["shared"].items()
                  if not k.startswith("stall_")})
    report["contention_mcm_4ch_replays"] = mcm

    # 16 cores: shared routing over the preset's 2 channels, and private
    # routing over 16 channels (one core each), through the entry point,
    # then both replays held against the plain version on the card
    from repro_torch.core.multicore import simulate_multicore_contention
    base16 = rt.get_preset("multicore-16x32")
    c16 = {}
    for name, cfg16, private in (
            ("shared", base16, False),
            ("private", dataclasses.replace(
                base16, dram=DramConfig(channels=16)), True)):
        mk.LAUNCHES = 0
        t0 = time.perf_counter()
        r16 = simulate_multicore_contention(cfg16, 512, 2048, 1024,
                                            private_channels=private)
        wall = time.perf_counter() - t0
        launches = mk.LAUNCHES
        if launches != 2:
            fail(f"16 cores, {name}: {launches} replay launches, expected 2")
        reps = contention_replays(cfg16, private)
        stall_k = reps["shared"]["stall_kernel"]
        # the entry point's result is the kernel's replay
        if max(abs(a_ - b_) / max(abs(b_), 1.0) for a_, b_ in
               zip(r16.per_core_stall_shared, stall_k)) > 1e-6:
            fail(f"16 cores, {name}: the entry point's stalls differ from "
                 f"the kernel replay's")
        gap = max(abs(a_ - b_) / b_ for a_, b_ in
                  zip(r16.per_core_stall_shared, r16.per_core_stall_isolated))
        info = dict(wall_s=wall, launches=launches,
                    makespan_shared=r16.makespan_shared,
                    makespan_isolated=r16.makespan_isolated,
                    row_hits=r16.row_hits, row_misses=r16.row_misses,
                    row_conflicts=r16.row_conflicts,
                    per_core_rel_gap_shared_vs_isolated=gap,
                    per_core_rel_gap_plain=reps["per_core_rel_gap_plain"],
                    plain_makespans=reps["makespan_plain"],
                    isolated={k: v for k, v in reps["isolated"].items()
                              if not k.startswith("stall_")},
                    shared={k: v for k, v in reps["shared"].items()
                            if not k.startswith("stall_")})
        if not private:
            if r16.makespan_shared < r16.makespan_isolated:
                fail("16 cores, shared routing: the shared makespan is below "
                     "the isolated one")
        else:
            # one core per channel: the merged replay decomposes into the
            # isolated runs. The contract is 1e-6 relative per core; at
            # this stream length float32 sums taken in other chunk
            # groupings miss it, the plain version as much as the kernel
            # (2.6e-5, PERF.md), so the check holds the kernel to 1e-4
            # and reports whether 1e-6 was met
            info["meets_1e-6"] = gap <= 1e-6
            if gap > PRIVATE_GAP_LIMIT:
                fail(f"16 cores, private channels: shared differs from "
                     f"isolated by {gap:.3g} relative per core")
        c16[name] = info
        phase(f"contention_16_cores_{name}", **info)
    report["contention_16_cores"] = c16

    # ---- 12. this slice's path: the routed NoC plane ------------------------
    from repro_torch.noc.topology import noc_kind

    def frame_vs_cpu(name, study, frame):
        """The study on the card machine's CPU, timed, and the card frame
        against it per column (the NoC columns NaN on the NoC-free rows
        only)."""
        t0 = time.perf_counter()
        cpu = study.run(device="cpu")
        cpu_s = time.perf_counter() - t0
        col_err = frame_rel_err(frame, cpu, noc_free=[
            label for label, cfg in study._designs if noc_kind(cfg) is None])
        bad = {c: e for c, e in col_err.items() if not e <= RTOL}
        if bad:
            fail(f"{name}: card frame differs from the CPU frame: {bad}")
        return dict(cpu_wall_s=cpu_s, max_rel_vs_cpu=max(col_err.values()),
                    max_rel_vs_cpu_by_column=col_err)

    def noc_frame_checks(name, frame, rows):
        """Rows, no failed cell, every cell batched, finite canonical
        columns, finite NoC columns on the NoC rows."""
        if len(frame) != rows or frame.failed_cells \
                or frame.fraction_batched != 1.0:
            fail(f"{name}: {len(frame)} rows (expected {rows}), failed "
                 f"{frame.failed_cells}, batched {frame.fraction_batched}")
        for c in ("total_cycles", "stall_cycles", "energy_pj"):
            if not np.isfinite(np.asarray(frame[c], float)).all():
                fail(f"{name}: non-finite {c}")
        stall = np.asarray(frame["noc_stall_cycles"], float)
        if not np.isfinite(stall[~np.isnan(stall)]).all() \
                or np.isnan(stall).all():
            fail(f"{name}: NoC stall column {stall}")

    nstudy = studies.nop_bound()        # 17 designs: pods 64-1,024, mm 2,048
    t0 = time.perf_counter()
    nres = nstudy.run()                 # the default: the card
    nwall = time.perf_counter() - t0
    nclaims = nres.check_claims()
    if len(nclaims) != 6 or not all(nclaims.values()):
        fail(f"nop_bound: claims {nclaims}")
    noc_frame_checks("nop_bound", nres, 17)
    ntot = dict(zip(nres["design"], nres["total_cycles"]))
    if ntot["noc-zero-load"] != ntot["legacy-hops"]:
        fail(f"nop_bound: zero-load {ntot['noc-zero-load']!r} vs legacy "
             f"{ntot['legacy-hops']!r}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        nstudy.run()
        walls.append(time.perf_counter() - t0)
    nop_info = dict(claims=nclaims, designs=len(nres), wall_s=nwall,
                    wall_s_runs=walls, wall_s_median=float(np.median(walls)),
                    zero_load_total_cycles=ntot["noc-zero-load"],
                    **frame_vs_cpu("nop_bound", nstudy, nres),
                    noc_link_util=dict(zip(nres["design"],
                                           nres["noc_link_util"])),
                    noc_stall_cycles=dict(zip(nres["design"],
                                              nres["noc_stall_cycles"])))
    phase("nop_bound_study", **nop_info)
    report["nop_bound_study"] = nop_info
    prof = profile_run(lambda: nstudy.run())
    phase("nop_bound_profile", **prof)
    report["nop_bound_profile"] = prof

    # pods up to 4,096 cores at fast fidelity: the mesh grid (with_pod
    # remeshes onto the default mesh, so the grid takes no topology axis),
    # a torus pod of each size and one 256-core ring
    pod_designs = rt.preset_grid("pod-mesh", pods=[256, 1024, 4096],
                                 link_bw=[4.0, 32.0, 256.0], channels=[1, 8])
    pod_designs += [rt.get_preset("pod-mesh", cores=p, topology="torus")
                    for p in (256, 1024, 4096)]
    pod_designs.append(rt.get_preset("pod-mesh", cores=256, topology="ring"))
    psweep = rt.Study("pod_sweep_fast").designs(pod_designs) \
        .workloads({"vit_base": vit_base()}).fidelity("fast")
    t0 = time.perf_counter()
    pres = psweep.run()
    pwall = time.perf_counter() - t0
    noc_frame_checks("pod_sweep_fast", pres, 22)
    pwalls = []
    for _ in range(3):
        t0 = time.perf_counter()
        psweep.run()
        pwalls.append(time.perf_counter() - t0)
    pod_info = dict(designs=len(pres), groups=len(psweep.plan().groups),
                    max_cores=max(c.num_cores for c in pod_designs),
                    first_wall_s=pwall, wall_s_runs=pwalls,
                    wall_s_median=float(np.median(pwalls)),
                    **frame_vs_cpu("pod_sweep_fast", psweep, pres))
    phase("pod_sweep_fast", **pod_info)
    report["pod_sweep_fast"] = pod_info
    prof = profile_run(lambda: psweep.run())
    phase("pod_sweep_fast_profile", **prof)
    report["pod_sweep_fast_profile"] = prof

    # routed hops into the trace generator: each pod's group replays its
    # streams in one kernel launch
    tsweep = rt.Study("pod_sweep_trace").designs(rt.preset_grid(
        "pod-mesh", pods=[16, 64, 256], link_bw=[4.0, 256.0])) \
        .workloads({"resnet18": resnet18()}).fidelity("trace")
    tgroups = len(tsweep.plan().groups)
    mk.LAUNCHES = 0                     # counts reset just before ...
    t0 = time.perf_counter()
    tres = tsweep.run()
    twall = time.perf_counter() - t0
    pod_launches = mk.LAUNCHES          # ... and read just after
    if pod_launches != tgroups:
        fail(f"pod_sweep_trace launched the replay kernel {pod_launches} "
             f"times, expected one per group ({tgroups})")
    noc_frame_checks("pod_sweep_trace", tres, 6)
    if tres.meta.get("engine") != "cuda":
        fail(f"pod_sweep_trace: engine {tres.meta.get('engine')!r}")
    tpod_info = dict(designs=len(tres), groups=tgroups,
                     launches=pod_launches, wall_s=twall,
                     **frame_vs_cpu("pod_sweep_trace", tsweep, tres))
    phase("pod_sweep_trace", **tpod_info)
    report["pod_sweep_trace"] = tpod_info

    # the contention path on a 16-core NoC pod: routed hops plus router
    # queueing (`noc_arrival_skew`) skew the merged stream the replay's
    # multi-core mode runs; both replays held to 1e-5 against the plain
    # version on the card
    from repro_torch.core.multicore import effective_nop_hops
    pod16 = rt.get_preset("pod-mesh", cores=16)
    mk.LAUNCHES = 0
    t0 = time.perf_counter()
    rpod = simulate_multicore_contention(pod16, 512, 2048, 1024)
    podc_wall = time.perf_counter() - t0
    podc_launches = mk.LAUNCHES
    if podc_launches != 2:
        fail(f"16-core NoC pod: {podc_launches} replay launches, expected 2")
    preps = contention_replays(pod16, False, tol=1e-5)
    if max(abs(a_ - b_) / max(abs(b_), 1.0) for a_, b_ in
           zip(rpod.per_core_stall_shared,
               preps["shared"]["stall_kernel"])) > 1e-6:
        fail("16-core NoC pod: the entry point's stalls differ from the "
             "kernel replay's")
    skew = contention_streams(pod16, 512, 2048, 1024, "spatial", False,
                              DEFAULT_SPEC, dev)["skew"]
    hops_only = effective_nop_hops(pod16) * pod16.nop_cycles_per_hop
    if not np.all(np.asarray(skew) >= hops_only) or \
            not np.any(np.asarray(skew) > hops_only):
        fail("16-core NoC pod: the routed skew adds no queueing delay")
    podc_info = dict(
        wall_s=podc_wall, launches=podc_launches,
        makespan_shared=rpod.makespan_shared,
        makespan_isolated=rpod.makespan_isolated,
        skew=[float(x) for x in skew],
        zero_load_skew=[float(x) for x in hops_only],
        isolated={k: v for k, v in preps["isolated"].items()
                  if not k.startswith("stall_")},
        shared={k: v for k, v in preps["shared"].items()
                if not k.startswith("stall_")})
    phase("contention_noc_pod", **podc_info)
    report["contention_noc_pod"] = podc_info

    # ---- 13-17. the sixth slice's path: the per-op engine -----------------
    t0 = time.perf_counter()
    perop = perop_phases(report)
    report["perop_phases_s"] = time.perf_counter() - t0
    phase("perop_phases", seconds=report["perop_phases_s"])

    # ---- 18-20. the seventh slice's path: search, farm, chaos --------------
    t0 = time.perf_counter()
    orch = orchestration_phases(report)
    report["orchestration_phases_s"] = time.perf_counter() - t0
    phase("orchestration_phases", seconds=report["orchestration_phases_s"])

    # ---- 21-24. the eighth slice's path: the workload plane's serving ------
    t0 = time.perf_counter()
    workload = workload_phases(report)
    report["workload_phases_s"] = time.perf_counter() - t0
    phase("workload_phases", seconds=report["workload_phases_s"])

    # ---- 25-29. the ninth slice's path: training ---------------------------
    t0 = time.perf_counter()
    training = training_phases(report)
    report["training_phases_s"] = time.perf_counter() - t0
    phase("training_phases", seconds=report["training_phases_s"])

    # ---- 30-33. the tenth slice's path: the sharded workload plane --------
    t0 = time.perf_counter()
    sharding = sharding_phases(report)
    report["sharding_phases_s"] = time.perf_counter() - t0
    phase("sharding_phases", seconds=report["sharding_phases_s"])

    # ---- 34-36. the eleventh slice's path: the dry run --------------------
    t0 = time.perf_counter()
    dryrun = dryrun_phases(report)
    report["dryrun_phases_s"] = time.perf_counter() - t0
    phase("dryrun_phases", seconds=report["dryrun_phases_s"])

    kernels = {"kernels": [
        dict(name="replay_megakernel", route="cuda",
             source="src/repro_torch/csrc/replay_megakernel.cu",
             replaces="src/repro/kernels/replay/megakernel.py:96",
             launches=(dense_launches + feat_launches["replay_megakernel"]
                       + cont_launches + pod_launches + podc_launches
                       + perop["replay"] + orch["replay"]),
             max_abs_err=max(max_abs, mcm["shared"]["max_abs_err"]),
             ms=kernel_ms, plain_ms=plain_ms,
             bound_ms=replay_group["bound_ms"],
             bound_by=replay_group["bound_by"], library_ms=None,
             modes=dict(
                 single_core=dict(
                     path="dense and feature sweeps (vit_base group)",
                     launches=dense_launches
                     + feat_launches["replay_megakernel"],
                     ms=kernel_ms, graph_ms=kernel_graph_ms),
                 multi_core=dict(
                     path="multicore_contention (mcm-4x32, 4 channels, "
                          "merged stream)",
                     launches=cont_launches,
                     ms=mcm["shared"]["kernel_ms"],
                     graph_ms=mcm["shared"]["graph_ms"],
                     plain_ms=mcm["shared"]["plain_ms"],
                     bound_ms=mcm["shared"]["bound_ms"],
                     bound_by=mcm["shared"]["bound_by"],
                     max_abs_err=mcm["shared"]["max_abs_err"]),
                 per_op={
                     shape: dict(
                         path=f"per-op engine, {shape} on paper-128",
                         **{k: v[k] for k in (
                             "streams", "requests_per_stream", "ms",
                             "graph_ms", "plain_ms", "bound_ms", "bound_by",
                             "max_abs_err")})
                     for shape, v in perop["replay_per_op"].items()})),
        dict(name="conflict_slowdown", route="cuda",
             source="src/repro_torch/csrc/conflict_slowdown.cu",
             replaces="src/repro/kernels/conflict/conflict.py:42",
             launches=(feat_launches["conflict_slowdown"] + perop["conflict"]
                       + orch["conflict"]),
             max_abs_err=0, ms=conflict_ms, plain_ms=conflict_plain_ms,
             bound_ms=layout_group["bound_ms"],
             bound_by=layout_group["bound_by"], library_ms=None,
             per_op=dict(path="per-op layout stage (one op window)",
                         **perop["conflict_per_op"])),
        dict(name="systolic_matmul", route="cuda",
             source="src/repro_torch/csrc/systolic_matmul.cu",
             replaces="src/repro/kernels/systolic/systolic.py:40",
             launches=fold_launches["systolic_matmul"], max_abs_err=mm_abs,
             ms=mm["ms"], plain_ms=mm["plain_ms"], bound_ms=mm["bound_ms"],
             bound_by=mm["bound_by"], library_ms=mm["library_ms"]),
        dict(name="wavefront_activity", route="cuda",
             source="src/repro_torch/csrc/wavefront_activity.cu",
             replaces="src/repro/kernels/systolic/systolic.py:79",
             launches=fold_launches["wavefront_activity"] + batched_launches,
             max_abs_err=0, ms=wv["ms"], plain_ms=wv["plain_ms"],
             bound_ms=wv["bound_ms"], bound_by=wv["bound_by"],
             library_ms=None),
        dict(name="ellpack_pack", route="cuda",
             source="src/repro_torch/csrc/ellpack_pack.cu",
             replaces="src/repro/kernels/ellpack/ellpack.py:38",
             launches=ell_launches, max_abs_err=0, ms=ep["ms"],
             plain_ms=ep["plain_ms"], bound_ms=ep["bound_ms"],
             bound_by=ep["bound_by"], library_ms=None)]}
    report["kernels"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                    default=str))
    print(json.dumps({"workload_plane": workload}, default=str))
    print(json.dumps({"training": training}, default=str))
    print(json.dumps({"sharding": sharding}, default=str))
    print(json.dumps({"dryrun": dryrun}, default=str))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank_main(sys.argv[2]))
    sys.exit(main())
