"""Spans and counters taken from the benchmark's side, around the calls
into the program's layers.

`Tracer.wrap` replaces a module attribute that the program looks up at
call time (`"repro_torch.core.dram:replay_requests"`) with a wrapper that
records (span, pass, start, end) on the host clock and runs the counter
hooks the metric readers asked for. With `sync=True` (the `--trace 1`
window) the wrapper synchronises the device at both boundaries, so a span
holds the device work its call enqueued; with `sync=False` it only
timestamps, which is how the profiled passes label the device's idle
gaps. `close` puts every attribute back.
"""
from __future__ import annotations

import importlib
import time
from typing import Callable, Dict, List, Tuple

import torch


class Tracer:
    def __init__(self, targets: Dict[str, str], counters=(), *,
                 sync: bool):
        self.sync = sync and torch.cuda.is_available()
        self.records: List[Tuple[str, int, float, float]] = []
        self.counts: List[Dict[str, float]] = []
        self.pass_index = -1
        self._hooks: Dict[str, List[Callable]] = {}
        for span, fn in counters:
            self._hooks.setdefault(span, []).append(fn)
        self._restore = []
        for span, target in targets.items():
            self.wrap(span, target)

    def wrap(self, span: str, target: str) -> None:
        mod_name, attr = target.split(":")
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)
        hooks = self._hooks.get(span, [])

        def wrapper(*args, **kwargs):
            if self.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            if self.sync:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.records.append((span, self.pass_index, t0, t1))
            if hooks and self.pass_index >= 0:
                acc = self.counts[self.pass_index]
                for fn in hooks:
                    for k, v in fn(args, kwargs, out).items():
                        acc[k] = acc.get(k, 0.0) + float(v)
            return out

        setattr(mod, attr, wrapper)
        self._restore.append((mod, attr, orig))

    def start_pass(self, index: int) -> None:
        self.pass_index = index
        while len(self.counts) <= index:
            self.counts.append({})

    def close(self) -> None:
        for mod, attr, orig in reversed(self._restore):
            setattr(mod, attr, orig)
        self._restore.clear()

    def span_ms(self, n_passes: int) -> List[Dict[str, float]]:
        """Per pass: {span: milliseconds summed over its calls}."""
        out: List[Dict[str, float]] = [{} for _ in range(n_passes)]
        for span, i, t0, t1 in self.records:
            if 0 <= i < n_passes:
                out[i][span] = out[i].get(span, 0.0) + (t1 - t0) * 1e3
        return out
