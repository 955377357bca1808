"""Frontier-perturbation proposals between search rounds.

The initial screen only sees a hash-uniform sample of the space; to
escape it, each refinement round perturbs the current Pareto frontier —
every ±1-step neighbor of every frontier point along every axis — and
evaluates the most promising `n` of them. "Most promising" is decided by
a counter-keyed hash shuffle (deterministic, replayable), not an RNG:
neighborhoods are small enough that coverage matters more than ordering,
and determinism is what makes the whole search resumable.

When a neighborhood runs dry (frontier boxed into corners, everything
already evaluated), the proposer tops up with fresh deterministic samples
on a per-round salt so rounds never stall.
"""
from __future__ import annotations

from typing import List, Sequence

from .space import SearchPoint, SearchSpace, hash_u64

__all__ = ["propose"]


def propose(space: SearchSpace, parents: Sequence[SearchPoint], n: int, *,
            seed: int = 0, round_idx: int = 0,
            exclude: Sequence[str] = ()) -> List[SearchPoint]:
    """Up to `n` new candidate points derived from `parents`.

    Candidates = valid, unseen ±1-axis neighbors of the parents (first
    occurrence wins when parents share neighbors), ordered by a
    hash keyed on `(space, seed, round, label)`, truncated to `n`; the
    shortfall, if any, is filled with fresh `space.sample` draws salted
    by the round index. Pure function of its arguments — same frontier,
    same seed, same round ⇒ same proposals.
    """
    if n <= 0:
        return []
    seen = set(exclude)
    cand: List[tuple] = []
    for parent in parents:
        for nb in space.neighbors(parent):
            lab = space.label(nb)
            if lab in seen:
                continue
            seen.add(lab)
            if not space.is_valid(nb):
                continue
            cand.append((hash_u64(
                f"{space.name}:prop:{seed}:{round_idx}:{lab}"), lab, nb))
    cand.sort()
    out = [nb for _, _, nb in cand[:n]]
    if len(out) < n:
        out.extend(space.sample(n - len(out), seed=seed,
                                salt=1_000_000 + round_idx, exclude=seen))
    return out
