"""Straggler detection over per-host step times (paper-scale training runs
lose whole pods to one slow host; the trainer remeshes around it).

Hosts report wall-clock step durations via `record`; a host is a straggler
once its last `patience` samples all exceed `threshold` x the median of the
per-host means. A single-host run can never flag itself (its own median).
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, List


class StragglerDetector:
    def __init__(self, threshold: float = 3.0, patience: int = 2,
                 window: int = 16):
        if threshold <= 1.0:
            raise ValueError("threshold must be > 1.0")
        self.threshold = float(threshold)
        self.patience = int(patience)
        self.window = int(window)
        self._samples: Dict[int, Deque[float]] = {}

    def record(self, host: int, seconds: float) -> None:
        self._samples.setdefault(
            int(host), collections.deque(maxlen=self.window)).append(
                float(seconds))

    def _median_of_means(self) -> float:
        means = sorted(sum(s) / len(s) for s in self._samples.values() if s)
        if not means:
            return 0.0
        mid = len(means) // 2
        if len(means) % 2:
            return means[mid]
        return 0.5 * (means[mid - 1] + means[mid])

    def stragglers(self) -> List[int]:
        med = self._median_of_means()
        if med <= 0.0:
            return []
        out = []
        for host, s in sorted(self._samples.items()):
            if len(s) < self.patience:
                continue
            recent = list(s)[-self.patience:]
            if all(x > self.threshold * med for x in recent):
                out.append(host)
        return out

    def reset(self, host: int = None) -> None:
        if host is None:
            self._samples.clear()
        else:
            self._samples.pop(int(host), None)
