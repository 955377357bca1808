"""Successive-halving / Hyperband primitives: rung sizing + promotion.

The multi-fidelity schedule: screen a wide cohort at the cheapest
fidelity, promote the top 1/η fraction to the next rung, and so on up the
ladder (`fast` → `trace` → `cycle`). Promotion is either by a scalar
metric (lowest-k) or by Pareto rank over several objectives — rank
promotion keeps the *frontier endpoints* alive (the latency-optimal and
energy-optimal corners), not just the scalar elbow, which is what lets a
single search recover all three of the paper's Table-V verdicts.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["rung_sizes", "promote"]


def rung_sizes(n0: int, eta: float, rungs: int) -> List[int]:
    """Cohort size at each rung of a successive-halving bracket:
    `ceil(n0 / eta**i)`, never below 1. `rungs` includes the base rung,
    so `rung_sizes(64, 4, 3) == [64, 16, 4]`."""
    if n0 < 1:
        raise ValueError(f"initial cohort must be >= 1, got {n0}")
    if rungs < 1:
        raise ValueError(f"need >= 1 rung, got {rungs}")
    if eta <= 1:
        raise ValueError(f"eta must be > 1, got {eta}")
    return [max(1, math.ceil(n0 / eta ** i)) for i in range(rungs)]


def promote(frame, k: int, *, metric: str = "edp",
            pareto: Optional[Sequence[str]] = None) -> List[str]:
    """The `k` survivors of a rung, as design labels in promotion order.

    `pareto=None`: the k lowest-`metric` rows (NaN-safe `topk`; failed
    cells never promote). `pareto=(objectives...)`: Pareto-rank peeling —
    repeatedly take the non-dominated front of the remaining rows, order
    within a front by `metric`, and truncate the last front to land on
    exactly k. Rows are assumed unique per design label (one workload and
    fidelity per rung frame — the driver's invariant); duplicate labels
    promote once.

    Returns exactly `min(k, finite designs)` labels.
    """
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    out: List[str] = []
    if k == 0 or not len(frame):
        return out
    if pareto is None:
        ranked = frame.topk(metric, len(frame))
        for lab in ranked["design"]:
            if lab not in out:
                out.append(str(lab))
                if len(out) == k:
                    break
        return out
    rem = frame
    while len(out) < k and len(rem):
        front = rem.pareto(*pareto)
        if not len(front):
            break  # only non-finite rows left — nothing can promote
        for lab in front.topk(metric, len(front))["design"]:
            if lab not in out:
                out.append(str(lab))
                if len(out) == k:
                    break
        mask = ~np.isin(rem["design"], list(set(front["design"])))
        rem = rem._subset(mask)
    return out
