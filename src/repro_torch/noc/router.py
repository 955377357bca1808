"""Flit/credit-level link contention model over the static routing tree;
PyTorch port of `repro.noc.router`.

An *order-only precompute* (the static (core, ancestor-link) route pairs
from topology.py) turns the contention fixed point into closed-form
scatter reductions over tensors with any leading batch shape, so the
batched sweep evaluates every design and op of a group at once.

Model, per design and per op:

  load[l]   = sum of flits injected by cores whose route crosses link l
              (one scatter-add over the route pairs; flit conservation
              load[l] = flits[l] + sum_children load[c] holds by
              construction)
  s         = per-flit service interval = max(flit_bytes / link_bw,
              2 * hop_cycles / buffer_flits): a link is either
              bandwidth-limited or credit-round-trip-limited
  busy[l]   = load[l] * s            (link serialization time)
  route[u]  = max busy over links on u's route       (bottleneck closure)
  tree[u]   = max busy over the whole subtree hanging off u's route
              (full head-of-line coupling). Both closures are one
              scatter-max over the same static pairs.
  eff[u]    = route[u] + kappa * relu(tree[u] - route[u]),
              kappa = s_credit / s in (0, 1]
  extra[u]  = relu(eff[u] - window): queueing delay past the injection
              window (the op's compute makespan). At zero load this is
              exactly 0.0, which makes the routed model reproduce the
              legacy hop-offset cycles bit for bit.

`noc_delay_model` is the float32 tensor model the sweep runs (on the
tensors' device); its route-pair tables go to that device once per
(topology, grid, device). The loads are an `index_add_`, which on a CUDA
device sums with atomics, so float32 loads there may differ from the
CPU's in the last bits. `eager_noc_delay` (the float64 numpy twin) and
`windowed_link_sim` (a per-window flit/credit simulation for invariant
tests) are copies of the reference's numpy code.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from .topology import link_fanin, parent_links, route_pairs


def service_interval(link_bw, flit_bytes, buffer_flits, hop_cycles,
                     xp=torch):
    """Per-flit acceptance interval: bandwidth- or credit-limited. Returns
    (s, s_credit); with `xp=torch` both are float32 tensors."""
    s_bw = flit_bytes / link_bw
    s_credit = 2.0 * hop_cycles / buffer_flits
    if xp is np:
        return np.maximum(s_bw, s_credit), s_credit
    s_bw = torch.as_tensor(s_bw, dtype=torch.float32)
    s_credit = torch.as_tensor(s_credit, dtype=torch.float32)
    return torch.maximum(s_bw, s_credit), s_credit


@functools.lru_cache(maxsize=None)
def _pairs_on(topology: str, pr: int, pc: int, device: str):
    """The route pairs as int64 tensors on `device` (cached)."""
    pair_core, pair_link = route_pairs(topology, pr, pc)
    return (torch.as_tensor(np.array(pair_core), device=device),
            torch.as_tensor(np.array(pair_link), device=device))


def _scatter(n: int, src: torch.Tensor, index: torch.Tensor,
             reduce: str) -> torch.Tensor:
    """zeros(..., n) with `src` (..., P) summed ("sum") or maxed ("amax")
    into the positions `index` (P,) of the last axis."""
    out = torch.zeros(src.shape[:-1] + (n,), dtype=src.dtype,
                      device=src.device)
    if reduce == "sum":
        return out.index_add_(-1, index, src)
    return out.scatter_reduce_(-1, index.expand(src.shape), src,
                               reduce="amax", include_self=True)


def link_loads(topology: str, pr: int, pc: int, flits, xp=torch):
    """Flits crossing each link (scatter-add over the static route pairs).

    `flits` has shape (..., n_cores); returns (..., n_links) with
    n_links == n_cores (link l = core l's outgoing link; load[0] == 0).
    With `xp=np` the sum is numpy float64, else a tensor of flits' dtype.
    """
    n = pr * pc
    if xp is np:
        pair_core, pair_link = route_pairs(topology, pr, pc)
        load = np.zeros(np.shape(flits)[:-1] + (n,), dtype=np.float64)
        np.add.at(load, (..., pair_link), np.asarray(flits)[..., pair_core])
        return load
    pair_core, pair_link = _pairs_on(topology, pr, pc, str(flits.device))
    return _scatter(n, flits[..., pair_core], pair_link, "sum")


def noc_delay_model(topology: str, pr: int, pc: int, flits, link_bw,
                    flit_bytes, buffer_flits, hop_cycles, window
                    ) -> Dict[str, torch.Tensor]:
    """The contention closure on float32 tensors. flits: (..., n); the
    other operands broadcast against (...,).

    Returns per-core `extra` (..., n), design-level `stall` = max extra,
    `max_busy` (busiest-link serialization time) and `link_util`
    (demand utilization max_busy / window; > 1 means the NoP is the
    binding constraint).
    """
    n = pr * pc
    flits = torch.as_tensor(flits, dtype=torch.float32)
    dev = flits.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    pair_core, pair_link = _pairs_on(topology, pr, pc, str(dev))
    window = f32(window)
    s, s_credit = service_interval(f32(link_bw), f32(flit_bytes),
                                   f32(buffer_flits), f32(hop_cycles))
    busy = link_loads(topology, pr, pc, flits) * s[..., None]
    # bottleneck closure: busiest link on each core's own route
    route = _scatter(n, busy[..., pair_link], pair_core, "amax")
    # subtree closure: busiest link anywhere under each route link, then
    # max over the route -- full head-of-line coupling
    sub = _scatter(n, busy[..., pair_core], pair_link, "amax")
    tree = _scatter(n, sub[..., pair_link], pair_core, "amax")
    kappa = (s_credit / s)[..., None]
    eff = route + kappa * torch.clamp_min(tree - route, 0.0)
    extra = torch.clamp_min(eff - window[..., None], 0.0)
    max_busy = busy.max(dim=-1).values
    return dict(
        extra=extra,
        stall=extra.max(dim=-1).values,
        max_busy=max_busy,
        link_util=max_busy / torch.clamp_min(window, 1.0),
    )


def eager_noc_delay(topology: str, pr: int, pc: int, flits, link_bw,
                    flit_bytes, buffer_flits, hop_cycles, window
                    ) -> Dict[str, np.ndarray]:
    """Pure-numpy float64 twin of `noc_delay_model` (differential oracle)."""
    pair_core, pair_link = route_pairs(topology, pr, pc)
    flits = np.asarray(flits, dtype=np.float64)
    s_bw = float(flit_bytes) / float(link_bw)
    s_credit = 2.0 * float(hop_cycles) / float(buffer_flits)
    s = max(s_bw, s_credit)
    busy = link_loads(topology, pr, pc, flits, xp=np) * s
    route = np.zeros_like(busy)
    np.maximum.at(route, (..., pair_core), busy[..., pair_link])
    sub = np.zeros_like(busy)
    np.maximum.at(sub, (..., pair_link), busy[..., pair_core])
    tree = np.zeros_like(busy)
    np.maximum.at(tree, (..., pair_core), sub[..., pair_link])
    kappa = s_credit / s
    eff = route + kappa * np.maximum(tree - route, 0.0)
    extra = np.maximum(eff - np.asarray(window, np.float64)[..., None], 0.0)
    max_busy = busy.max(axis=-1)
    return dict(
        extra=extra,
        stall=extra.max(axis=-1),
        max_busy=max_busy,
        link_util=max_busy / np.maximum(np.asarray(window, np.float64), 1.0),
    )


def windowed_link_sim(topology: str, pr: int, pc: int, flits, *,
                      cap_per_window: float, buffer_flits: int,
                      windows: int) -> Dict[str, np.ndarray]:
    """Reference per-window flit/credit simulation (numpy, test-only).

    Every link has a `buffer_flits`-deep input buffer at its parent
    router; a link may forward at most `cap_per_window` flits per window
    and only into remaining parent credits (children share the parent's
    free space by its static fan-in, so occupancy can never exceed the
    buffer -- the credit non-negativity invariant).  Source cores inject
    their whole payload into an unbounded local queue up front; flits
    advance one hop per window.

    Returns per-window histories for the invariant tests:
      occupancy (W, n), credits (W, n), sink_served (W,), source_left (W,).
    """
    parent = parent_links(topology, pr, pc)
    fanin = link_fanin(topology, pr, pc)
    n = pr * pc
    B = float(buffer_flits)
    q = np.zeros(n)                       # buffer occupancy per link
    u = np.asarray(flits, dtype=np.float64).copy()  # source backlog
    u[0] = 0.0                            # core 0 sits at the MC: free
    occ, cred, sink, left = [], [], [], []
    sink_total = 0.0
    for _ in range(windows):
        # serve from pre-window state: into parent credits (root -> MC sink
        # is unbounded), children share parent space by fan-in
        space = np.maximum(B - q[parent], 0.0) / np.maximum(fanin[parent], 1)
        space[parent == 0] = np.inf
        srv = np.minimum(np.minimum(q, cap_per_window), space)
        srv[0] = 0.0
        entered = np.zeros(n)
        np.add.at(entered, parent[1:], srv[1:])
        entered[0] = 0.0                  # flits reaching core 0 hit the MC
        sink_total += srv[(parent == 0) & (np.arange(n) > 0)].sum()
        q = q - srv + entered
        # source admission into own link's buffer, after children landed
        adm = np.minimum(u, np.maximum(B - q, 0.0))
        adm = np.minimum(adm, cap_per_window)
        adm[0] = 0.0
        q += adm
        u -= adm
        occ.append(q.copy())
        cred.append(B - q)
        sink.append(sink_total)
        left.append(u.sum())
    return dict(occupancy=np.asarray(occ), credits=np.asarray(cred),
                sink_served=np.asarray(sink), source_left=np.asarray(left))
