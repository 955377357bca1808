"""The device's timeline over a few steady passes, from torch.profiler.

After `chip_smoke.py::profile_run`: the device alone is traced (tracing
host operations adds their cost to the wall and makes the trace slow to
read). From the trace come the seconds in which an operation ran on the
device (the union of the operations' intervals), the operations that took
the most time, and the idle gaps between them. A gap is labelled by the
innermost benchmark span the host was in at the gap's midpoint; the
device clock is tied to the host clock by a `spin_kernel` marker launched
on an idle device just before the passes.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

# Names of the idle gaps by what the host was doing, innermost span first.
OUTSIDE = "between passes"


def _device_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start_us, end_us) of every device operation in the trace."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        tr = e.time_range
        if tr.end > tr.start:
            out.append((e.name, float(tr.start), float(tr.end)))
    return out


def _union(events) -> List[Tuple[float, float]]:
    spans = sorted((s, e) for _, s, e in events)
    merged: List[List[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _label(t: float, spans: List[Tuple[str, float, float]]) -> str:
    """The shortest (innermost) span holding host time t."""
    best, width = OUTSIDE, float("inf")
    for name, s, e in spans:
        if s <= t <= e and e - s < width:
            best, width = name, e - s
    return best


def profile_passes(run: Callable[[], None], host_spans: Callable[[], List]
                   ) -> Dict:
    """Trace the device while `run()` runs a few passes; `host_spans()`
    then returns the (name, start, end) host spans recorded meanwhile, on
    `time.perf_counter`. Returns busy and window seconds, the top device
    operations and the idle seconds by host span."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_mark = time.perf_counter()
        torch.cuda._sleep(1000)          # the clock marker
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    events = _device_events(prof)
    marker = [s for name, s, _ in events if "spin_kernel" in name]
    # device microseconds -> host seconds; without the marker, the first
    # device operation is taken to start with the passes
    if marker:
        offset = t_mark - marker[0] * 1e-6
    else:
        offset = t0 - min(s for _, s, _ in events) * 1e-6
    ev = [(n, s * 1e-6 + offset, e * 1e-6 + offset) for n, s, e in events
          if "spin_kernel" not in n]
    ev = [(n, max(s, t0), min(e, t1)) for n, s, e in ev if e > t0 and s < t1]
    busy = _union(ev)
    busy_s = sum(e - s for s, e in busy)
    by_op: Dict[str, float] = {}
    for n, s, e in ev:
        by_op[n] = by_op.get(n, 0.0) + (e - s)
    spans = host_spans()
    gaps: Dict[str, float] = {}
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            lab = _label((s + e) / 2, spans)
            gaps[lab] = gaps.get(lab, 0.0) + (e - s)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy_s, window_s=t1 - t0,
                device_ops=[[n[:120], s] for n, s in top],
                idle_gaps=[[n, s] for n, s in idle])
