"""The design samples of a run, drawn from its seed.

A mix's design grid is the product of its `axes`. A run cuts it into
`samples` design sets that together hold every point the same number of
times: each stratum (the points of one value of the `stratify` axis,
dataflow here) is shuffled and split into `samples` blocks, and sample k
leaves out block k of every stratum. So every sample has as many designs
of each stratum, and a whole cycle of samples simulates every point
`samples - 1` times, whatever the seed: the seed changes which designs
share a pass and in what order they come, never the work of a cycle.
"""
from __future__ import annotations

import itertools
import random
from typing import Dict, List


def grid(mix: dict) -> List[Dict]:
    axes = mix["axes"]
    keys = list(axes)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(axes[k] for k in keys))]


def samples(mix: dict, seed: int) -> List[List[Dict]]:
    """`mix["samples"]` design lists of `mix["designs_per_pass"]` distinct
    points each, in the order a run cycles through them."""
    rng = random.Random(int(seed))
    points = grid(mix)
    n = int(mix["samples"])
    by = mix["stratify"]
    strata: Dict[object, List[Dict]] = {}
    for p in points:
        strata.setdefault(p[by], []).append(p)
    out: List[List[Dict]] = [[] for _ in range(n)]
    for members in strata.values():
        if len(members) % n:
            raise ValueError(f"a stratum of {len(members)} points does not "
                             f"split into {n} samples")
        members = list(members)
        rng.shuffle(members)
        per = len(members) // n
        for k in range(n):
            out[k] += members[:k * per] + members[(k + 1) * per:]
    for s in out:
        rng.shuffle(s)
    rng.shuffle(out)
    want = int(mix["designs_per_pass"])
    if any(len(s) != want for s in out):
        raise ValueError(f"samples of {len(out[0])} designs, the mix asks "
                         f"for {want}")
    return out


def label(d: Dict) -> str:
    """The design's label in the study's frame."""
    return f"{d['array']}x{d['array']}-{d['dataflow']}@{d['sram_mb']}MB"
