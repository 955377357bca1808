"""Interconnect coordinate maps and dimension-ordered routing tables; a
copy of `repro.noc.topology` (plain numpy, no framework).

Everything here is *static* (plain numpy, hashable inputs): the topology
kind and mesh shape are part of the batched sweep's flavor key, so routing
tables are order-only precompute shared by every design in a sweep group.

The memory controller sits at core 0 (grid position (0, 0)).  Dimension-
ordered (XY) routing gives every core a unique next hop toward the MC, so
the union of all routes is a *tree* rooted at the MC: link `l` is core
`l`'s single outgoing link toward its parent.  That tree structure is what
makes the router's contention closure a single scatter over static
(core, ancestor-link) pairs -- see router.py.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

from ..core.accelerator import NOC_TOPOLOGIES


def noc_kind(cfg) -> Optional[str]:
    """The routed topology of an AcceleratorConfig that is a NoC pod (the
    NoC plane on and more than one core), else None: the one rule the
    plan key, the sweep's flavor, the routed hops and the arrival skew
    share."""
    return (cfg.noc.topology if cfg.noc.enabled and cfg.num_cores > 1
            else None)


def _check(topology: str, pr: int, pc: int) -> None:
    if topology not in NOC_TOPOLOGIES:
        raise ValueError(
            f"topology must be one of {NOC_TOPOLOGIES}, got {topology!r}")
    if pr < 1 or pc < 1:
        raise ValueError(f"mesh shape must be >= 1x1, got {pr}x{pc}")


def _frozen(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


@functools.lru_cache(maxsize=None)
def parent_links(topology: str, pr: int, pc: int) -> np.ndarray:
    """Next-hop core index toward the MC at core 0, per core. parent[0] = 0.

    mesh:  XY order -- retire the column offset first, then the row.
    torus: XY order with wraparound, always stepping along the shorter arc
           (ties break toward decreasing index, so routes stay acyclic).
    ring:  cores form an N-ring regardless of (pr, pc); shorter arc wins.
    """
    _check(topology, pr, pc)
    n = pr * pc
    parent = np.zeros(n, dtype=np.int64)
    if topology == "ring":
        for i in range(1, n):
            parent[i] = i - 1 if i <= n // 2 else (i + 1) % n
        return _frozen(parent)
    for i in range(1, n):
        r, c = divmod(i, pc)
        if c > 0:
            if topology == "torus" and c > pc // 2:
                nr, nc = r, (c + 1) % pc
            else:
                nr, nc = r, c - 1
        else:
            if topology == "torus" and r > pr // 2:
                nr, nc = (r + 1) % pr, 0
            else:
                nr, nc = r - 1, 0
        parent[i] = nr * pc + nc
    return _frozen(parent)


@functools.lru_cache(maxsize=None)
def routed_hop_counts(topology: str, pr: int, pc: int) -> np.ndarray:
    """Hops from each core to the MC along the dimension-ordered route.

    mesh: r + c; torus: min(c, Pc-c) + min(r, Pr-r); ring: min(i, N-i).
    """
    parent = parent_links(topology, pr, pc)
    n = pr * pc
    hops = np.zeros(n, dtype=np.int64)
    # walk parents; tree depth <= pr + pc so this terminates
    order = np.argsort(_depth_key(topology, pr, pc))
    for i in order:
        if i:
            hops[i] = hops[parent[i]] + 1
    return _frozen(hops)


def _depth_key(topology: str, pr: int, pc: int) -> np.ndarray:
    """A key that sorts parents before children (distance lower bound)."""
    n = pr * pc
    i = np.arange(n)
    if topology == "ring":
        return np.minimum(i, n - i)
    r, c = np.divmod(i, pc)
    if topology == "torus":
        return np.minimum(r, pr - r) + np.minimum(c, pc - c)
    return r + c


@functools.lru_cache(maxsize=None)
def route_pairs(topology: str, pr: int, pc: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Static (core, link) pairs: core u crosses link l on its route to MC.

    Link l is core l's outgoing link, so core u's route = [u, parent(u),
    parent^2(u), ...] stopping before core 0 (the MC has no outgoing link).
    The pair list has sum(hops) entries -- the router's order-only
    precompute, analogous to replay.py's per-bank sort permutation.
    """
    parent = parent_links(topology, pr, pc)
    cores, links = [], []
    for u in range(1, pr * pc):
        v = u
        while v != 0:
            cores.append(u)
            links.append(v)
            v = int(parent[v])
    return (_frozen(np.asarray(cores, dtype=np.int64)),
            _frozen(np.asarray(links, dtype=np.int64)))


@functools.lru_cache(maxsize=None)
def subtree_sizes(topology: str, pr: int, pc: int) -> np.ndarray:
    """Cores whose route crosses link l (= size of the subtree under l)."""
    pc_, pl_ = route_pairs(topology, pr, pc)
    sizes = np.zeros(pr * pc, dtype=np.int64)
    np.add.at(sizes, pl_, 1)
    return _frozen(sizes)


@functools.lru_cache(maxsize=None)
def link_fanin(topology: str, pr: int, pc: int) -> np.ndarray:
    """Child links feeding each core's router (for credit sharing)."""
    parent = parent_links(topology, pr, pc)
    fanin = np.zeros(pr * pc, dtype=np.int64)
    for i in range(1, pr * pc):
        fanin[parent[i]] += 1
    return _frozen(fanin)
