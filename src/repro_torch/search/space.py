"""Declarative design-space descriptions for the search layer.

A `SearchSpace` is a named product of `Axis` domains — each axis a finite
ordered set of values plus an `apply` transform folding the chosen value
into an `AcceleratorConfig` — with optional validity predicates pruning
combinations that make no physical sense (e.g. more layout banks than the
SRAM can hold).

Enumeration is lazy: a point is a mixed-radix index tuple, decoded on
demand, so a 10^5..10^6-cell space costs nothing to hold. Sampling is a
pure function of `(space name, seed, salt, counter)` through a
counter-keyed hash — there is no RNG object and no global state, which is
what makes every run replayable bit-for-bit and a killed search resumable
mid-round: the sample stream's prefix is always the same.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.accelerator import AcceleratorConfig

__all__ = ["Axis", "SearchPoint", "SearchSpace", "choice", "int_log_range"]


def hash_u64(key: str) -> int:
    """The search layer's only randomness source: 64 bits of a keyed
    blake2b digest. Deterministic across processes and platforms."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One search dimension: name, ordered finite domain, config transform.

    `short` is the label prefix ("a" -> "a64"); it defaults to the axis
    name and may be "" for self-describing values like dataflows.
    """
    name: str
    values: Tuple
    apply: Callable[[AcceleratorConfig, object], AcceleratorConfig]
    short: Optional[str] = None

    def __post_init__(self):
        if not self.values:
            raise ValueError(f"axis {self.name!r} has an empty domain")
        if len(set(self.values)) != len(self.values):
            raise ValueError(f"axis {self.name!r} has duplicate values")

    @property
    def tag(self) -> str:
        return self.name if self.short is None else self.short


def choice(name: str, values: Sequence,
           apply: Callable[[AcceleratorConfig, object], AcceleratorConfig],
           short: Optional[str] = None) -> Axis:
    """A categorical axis over an explicit value list."""
    return Axis(name, tuple(values), apply, short)


def int_log_range(name: str, lo: int, hi: int, steps: int,
                  apply: Callable[[AcceleratorConfig, object],
                                  AcceleratorConfig],
                  short: Optional[str] = None) -> Axis:
    """`steps` log-spaced integers spanning [lo, hi] (rounded, deduplicated,
    ascending) — near-continuous hardware sizes (SRAM KB, queue depths)."""
    if not (1 <= lo <= hi):
        raise ValueError(f"need 1 <= lo <= hi, got [{lo}, {hi}]")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if steps == 1 or lo == hi:
        vals: Tuple[int, ...] = (int(lo),)
    else:
        ratio = hi / lo
        raw = [int(round(lo * ratio ** (i / (steps - 1))))
               for i in range(steps)]
        vals = tuple(sorted(set(raw)))
    return Axis(name, vals, apply, short)


@dataclasses.dataclass(frozen=True)
class SearchPoint:
    """One cell of the space: an index per axis (hashable, orderable)."""
    idx: Tuple[int, ...]


class SearchSpace:
    """A named product space over `Axis` domains with validity predicates.

    Predicates receive the point's `{axis name: value}` dict and return
    False to prune the combination; `valid_size()` is the exhaustive cell
    count the search budgets against.
    """

    def __init__(self, name: str, base: AcceleratorConfig,
                 axes: Sequence[Axis],
                 validity: Sequence[Callable[[Dict[str, object]], bool]] = ()):
        names = [a.name for a in axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names: {names}")
        if not axes:
            raise ValueError("a SearchSpace needs at least one axis")
        self.name = str(name)
        self.base = base
        self.axes: Tuple[Axis, ...] = tuple(axes)
        self.validity = tuple(validity)
        self._radix = tuple(len(a.values) for a in self.axes)
        self._valid_size: Optional[int] = None

    def __len__(self) -> int:
        n = 1
        for r in self._radix:
            n *= r
        return n

    # ---- points ------------------------------------------------------------
    def point(self, flat: int) -> SearchPoint:
        """Mixed-radix decode of a flat index into a SearchPoint."""
        if not (0 <= flat < len(self)):
            raise IndexError(f"flat index {flat} outside {len(self)}-cell "
                             f"space {self.name!r}")
        idx: List[int] = []
        for r in reversed(self._radix):
            idx.append(flat % r)
            flat //= r
        return SearchPoint(tuple(reversed(idx)))

    def points(self) -> Iterator[SearchPoint]:
        """Lazy enumeration of every point (valid or not)."""
        for flat in range(len(self)):
            yield self.point(flat)

    def values(self, point: SearchPoint) -> Dict[str, object]:
        return {a.name: a.values[i] for a, i in zip(self.axes, point.idx)}

    def is_valid(self, point: SearchPoint) -> bool:
        vals = self.values(point)
        return all(bool(p(vals)) for p in self.validity)

    def valid_size(self) -> int:
        """Exact count of valid cells — the exhaustive cost a search is
        measured against. Walks the whole space once (cheap at ~1e5-1e6
        cells) and caches the count."""
        if self._valid_size is None:
            if not self.validity:
                self._valid_size = len(self)
            else:
                self._valid_size = sum(
                    1 for p in self.points() if self.is_valid(p))
        return self._valid_size

    def config(self, point: SearchPoint) -> AcceleratorConfig:
        """Compile a point into a config: axis transforms applied in axis
        order over the base config."""
        cfg = self.base
        for a, i in zip(self.axes, point.idx):
            cfg = a.apply(cfg, a.values[i])
        return cfg

    def label(self, point: SearchPoint) -> str:
        """Stable human-readable identity, e.g. 'a64-s4096-ws-ch2-bw19.2'.
        Used as the Study design label; the cell cache keys on config
        *content*, so labels never affect cache identity."""
        return "-".join(f"{a.tag}{a.values[i]}"
                        for a, i in zip(self.axes, point.idx))

    # ---- deterministic sampling --------------------------------------------
    def sample(self, n: int, *, seed: int = 0, salt: int = 0,
               exclude: Sequence[str] = ()) -> List[SearchPoint]:
        """The first `n` valid, previously-unseen points of the
        deterministic stream keyed by `(name, seed, salt)`.

        Rejection sampling over counter-keyed hashes: counter i maps to
        flat index `hash(name:seed:salt:i) % len(space)`; invalid points
        and labels in `exclude` are skipped, duplicates are drawn once.
        Any prefix of the stream is reproducible, so a resumed search
        re-derives exactly the cohorts it already ran.
        """
        if n <= 0:
            return []
        out: List[SearchPoint] = []
        seen = set(exclude)
        total = len(self)
        # enough counter head-room to drain even a mostly-excluded space;
        # a space with no valid unseen points left simply returns short
        for counter in range(64 * total + 1024):
            if len(out) >= n:
                break
            flat = hash_u64(f"{self.name}:{seed}:{salt}:{counter}") % total
            p = self.point(flat)
            lab = self.label(p)
            if lab in seen:
                continue
            seen.add(lab)
            if not self.is_valid(p):
                continue
            out.append(p)
        return out

    def neighbors(self, point: SearchPoint) -> List[SearchPoint]:
        """±1-step moves along each axis — the proposer's neighborhood.
        Returns every in-bounds move (validity is the caller's filter,
        so the proposer can count pruned candidates if it wants)."""
        out: List[SearchPoint] = []
        for d, (a, i) in enumerate(zip(self.axes, point.idx)):
            for j in (i - 1, i + 1):
                if 0 <= j < len(a.values):
                    idx = list(point.idx)
                    idx[d] = j
                    out.append(SearchPoint(tuple(idx)))
        return out
