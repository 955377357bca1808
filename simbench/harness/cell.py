"""One run of one cell: set-up, the measured window, the traced passes, the
reference, the comparison, and the result line's fields.

The window drives the program as a user's script does: one client runs
one study (a pass) after another, back to back, each built anew:

    Study(cell).designs(sample).workloads({config: ops})
        .fidelity("trace").options(trace_spec=TraceSpec(...)).run(device=)

cycling through the run's design samples (`designs.samples`). Set-up runs
one pass of every sample first, so every shape the window uses has been
run once. With `trace` the window runs under spans that synchronise the
device at each boundary, and one more cycle of samples runs under
torch.profiler for the device's busy time and idle gaps. Once the window
has closed and the device's peak is read, the program's state is freed
and the plain reference computes every design of the run's samples.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import sim
from . import check, designs as dz
from .profile import profile_passes
from .registry import Cell
from .spans import Tracer

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)


def log(msg: str) -> None:
    print(f"[simbench] {msg}", file=sys.stderr, flush=True)


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names of loaded modules (`sys.modules` by default) that
    the process printing a result must not hold: compared whole, so
    `repro_torch` is not `repro`."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".")[0] for name in list(names)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def validate_mix(mix: dict) -> None:
    """The reference covers dense, single-core, layout-off designs at
    trace fidelity with row-major operands; refuse anything else."""
    want = dict(cores=1, sparsity="dense", layout=False, fidelity="trace")
    for k, v in want.items():
        if mix.get(k) != v:
            raise ValueError(f"mix {mix['name']}: {k} = {mix.get(k)!r}, "
                             f"the reference covers only {v!r}")
    if mix["trace_spec"].get("layout", "row") != "row":
        raise ValueError("the reference covers row-major operands only")


class Program:
    """The system under test, set up for one cell: the design samples as
    accelerator configs, the op list, the trace spec."""

    def __init__(self, cell: Cell, samples: List[List[dict]], device):
        from repro_torch.api.presets import get_preset
        from repro_torch.core.accelerator import DramConfig
        from repro_torch.core.workloads import Op
        from repro_torch.trace.generator import TraceSpec
        mix = cell.mix
        dram = DramConfig(**mix["dram"])
        self.spec = TraceSpec(**mix["trace_spec"])
        self.ops = [Op(name=o["name"], M=o["M"], N=o["N"], K=o["K"],
                       count=o["count"], kind=o["kind"],
                       vector_elems=o["vector_elems"])
                    for o in cell.config["ops"]]
        self.configs = [{dz.label(d): get_preset(mix["preset"], **d)
                         .with_(dram=dram) for d in s} for s in samples]
        self.name = cell.name
        self.workload = cell.config["name"]
        self.fidelity = mix["fidelity"]
        self.device = device

    def run_pass(self, k: int) -> Dict[str, np.ndarray]:
        """One study over sample k; its frame's columns on the host."""
        from repro_torch.api.study import Study
        frame = (Study(self.name)
                 .designs(self.configs[k % len(self.configs)])
                 .workloads({self.workload: self.ops})
                 .fidelity(self.fidelity)
                 .options(trace_spec=self.spec)
                 .run(device=self.device))
        have = set(frame.column_names())
        n = len(frame)
        # a failed group's cells carry no metric columns: NaN, failed
        cols = {c: (np.asarray(frame[c], np.float64) if c in have
                    else np.full(n, np.nan))
                for c in sim.METRIC_COLUMNS + ("cell_status",)}
        cols["design"] = list(frame["design"])
        return cols


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: Cell, *, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: Optional[float] = None) -> Dict:
    """Run the cell once; returns the result line's fields, the checks
    last."""
    t_start = time.perf_counter() if t_start is None else t_start
    mix = cell.mix
    validate_mix(mix)
    samples = dz.samples(mix, seed)
    keys = {dz.label(d): sim.design_key(d) for s in samples for d in s}
    prog = Program(cell, samples, device)
    on_card = torch.device(device).type == "cuda"

    for k in range(len(samples)):                 # every shape, once
        prog.run_pass(k)
    _sync(device)

    tracer = (Tracer(cell.spans(), cell.counters(), sync=True)
              if trace else None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    frames: List[Dict] = []
    walls: List[float] = []
    pass_samples: List[int] = []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    try:
        while time.perf_counter() - t0 < seconds:
            k = len(frames)
            if tracer is not None:
                tracer.start_pass(k)
            p0 = time.perf_counter()
            frames.append(prog.run_pass(k))
            walls.append((time.perf_counter() - p0) * 1e3)
            pass_samples.append(k % len(samples))
        t1 = time.perf_counter()
    finally:
        if tracer is not None:
            tracer.close()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    window_s = t1 - t0
    n_designs = sum(len(f["design"]) for f in frames)
    log(f"setup {setup_s:.3f} s; window {window_s:.3f} s, {len(frames)} "
        f"passes, {n_designs} designs; peak {peak / GIB:.3f} GiB")

    out: Dict = {}
    device_info = dict(
        platform="gpu" if on_card else torch.device(device).type,
        kind=torch.cuda.get_device_name(0) if on_card else "cpu",
        count=cell.chips if on_card else 1, memory_peak_bytes=int(peak))
    if trace:
        prof = None
        if on_card:
            prof, prof_frames = _profile(cell, prog, len(samples))
            frames += prof_frames
            device_info.update(busy_s=prof["busy_s"],
                               window_s=prof["window_s"])
            out["breakdown"] = dict(device_ops=prof["device_ops"],
                                    idle_gaps=prof["idle_gaps"])
        data = dict(
            passes=[dict(sample=s, designs=samples[s], wall_ms=w,
                         spans=sp, counts=ct)
                    for s, w, sp, ct in zip(
                        pass_samples, walls, tracer.span_ms(len(walls)),
                        tracer.counts + [{}] * len(walls))],
            ops=cell.config["ops"], mix=mix, profile=prof)
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(data)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        values = dict(
            designs_per_s=n_designs / window_s,
            frame_ms_p90=(statistics.quantiles(walls, n=10)[-1]
                          if len(walls) >= 2 else walls[0]),
            device_peak_gib=peak / GIB,
            setup_s=setup_s)
        metrics = {m["name"]: dict(value=float(values[m["name"]]),
                                   unit=m["unit"])
                   for m in cell.end_to_end}
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    union = [d for s in samples for d in s]
    ref = sim.reference_frame(union, cell.config["ops"],
                              spec=mix["trace_spec"], dram=mix["dram"],
                              device=device)
    _sync(device)
    log(f"reference {time.perf_counter() - r0:.3f} s over {len(ref)} "
        f"designs")
    checks, failed, rows = check.compare(frames, keys, ref,
                                         mix.get("limits", {}))
    out.update(correct=failed == 0, attempted=rows, failed=failed,
               metrics=metrics, device=device_info, checks=checks)
    return out


def _profile(cell: Cell, prog: Program, n: int):
    """One cycle of samples under torch.profiler, the host spans only
    timestamped; returns the profile and the passes' frames."""
    spans = Tracer(cell.spans(), sync=False)
    frames: List[Dict] = []
    passes: List = []

    def run_cycle():
        for k in range(n):
            spans.start_pass(k)
            p0 = time.perf_counter()
            frames.append(prog.run_pass(k))
            passes.append(("pass (plan + frame)", p0, time.perf_counter()))

    try:
        prof = profile_passes(
            run_cycle,
            lambda: passes + [(s, a, b) for s, _, a, b in spans.records])
    finally:
        spans.close()
    return prof, frames
