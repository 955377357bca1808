"""The comparison that decides `correct`.

Every metric column of every design row of every frame the timed passes
produced is held against the plain reference's value for that design:
the gap is |program - reference| / |reference| (inf where either is not
finite), and each column has its own limit, from the mix's `limits`. A
row is failed when the program marked it failed (`cell_status` 1) or
when one of its columns is over its limit; `correct` is no failed row.
How each limit was set from readings is in PERF.md.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from ..reference.sim import METRIC_COLUMNS, design_key
from .designs import label


def gap(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def compare(frames: Sequence[Dict], keys: Dict[str, Tuple],
            ref: Dict[Tuple, Dict[str, float]], limits: Dict[str, float]
            ) -> Tuple[Dict[str, Dict[str, float]], int, int]:
    """(checks, failed rows, rows) of the frames ({column: values},
    "design" holding labels; `keys` maps a label to its reference key).
    `checks` gives each column's widest gap beside its limit, and the
    program's own failed cells beside 0."""
    widest = {c: 0.0 for c in METRIC_COLUMNS}
    failed = rows = marked = 0
    for fr in frames:
        for i, lab in enumerate(fr["design"]):
            r = ref[keys[lab]]
            bad = fr["cell_status"][i] != 0
            marked += int(bad)
            for c in METRIC_COLUMNS:
                g = gap(float(fr[c][i]), r[c])
                widest[c] = max(widest[c], g)
                bad = bad or not g <= limits.get(c, 0.0)
            failed += int(bad)
            rows += 1
    checks = {c: dict(gap=widest[c], limit=float(limits.get(c, 0.0)))
              for c in METRIC_COLUMNS}
    checks["failed_cells"] = dict(gap=float(marked), limit=0.0)
    return checks, failed, rows


def frame_of(values: Dict[Tuple, Dict[str, float]], designs: Sequence[Dict]
             ) -> Dict:
    """A frame, as a pass returns it, of per-design `values` ({design
    key: {column: value}}, the reference's form) over `designs`: how the
    control is put in the program's place."""
    fr = {c: [values[design_key(d)][c] for d in designs]
          for c in METRIC_COLUMNS}
    fr["design"] = [label(d) for d in designs]
    fr["cell_status"] = [0.0] * len(designs)
    return fr


def check_lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {name}: {v['gap']!r} limit {v['limit']!r}"
            for name, v in checks.items()]
