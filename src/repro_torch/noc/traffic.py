"""Injection synthesis: turn the tile schedule into NoP traffic; PyTorch
port of `repro.noc.traffic`.

Three traffic classes (topology and mesh shape are static; byte counts
and link parameters are tensors or scalars):

  memory_flits          memory-bound NoP traffic: each core's share of the
                        op's DRAM demand, serialized into flits toward the
                        memory controller at core 0 (a uniform split, as
                        the partition layer equalizes work).
  halo_exchange_cycles  nearest-neighbor exchange (spatial partitions share
                        ifmap halos); gated by the busiest router degree.
  allreduce_cycles      ring all-reduce makespan for output reduction:
                        2(N-1) steps of payload/N chunks over an embedded
                        ring. torus/ring embed with unit-hop edges; a mesh
                        serpentine must close with a multi-hop return path
                        that doubles up on serpentine links -- which is why
                        torus beats mesh at fixed link budget
                        (studies.nop_bound claim c).
"""
from __future__ import annotations

import torch

from .router import service_interval


def memory_flits(dram_bytes, num_cores: int, flit_bytes):
    """Per-core flits toward the MC for an op's DRAM demand (uniform split)."""
    return dram_bytes / (num_cores * flit_bytes)


def _degree(topology: str, pr: int, pc: int) -> int:
    """Max router degree for neighbor exchange (static)."""
    n = pr * pc
    if topology == "ring":
        return 2 if n >= 3 else max(n - 1, 0)

    def axis_deg(p: int, wrap: bool) -> int:
        if p <= 1:
            return 0
        if p == 2:
            return 1
        return 2 if (wrap or p >= 3) else 1

    torus = topology == "torus"
    return axis_deg(pr, torus) + axis_deg(pc, torus)


def halo_exchange_cycles(topology: str, pr: int, pc: int, halo_bytes,
                         link_bw, flit_bytes, buffer_flits, hop_cycles):
    """Makespan of one nearest-neighbor halo exchange round (float32)."""
    deg = _degree(topology, pr, pc)
    if deg == 0:
        return torch.zeros_like(torch.as_tensor(halo_bytes,
                                                dtype=torch.float32))
    s, _ = service_interval(link_bw, flit_bytes, buffer_flits, hop_cycles)
    flits = halo_bytes / flit_bytes
    return deg * flits * s + hop_cycles


def _ring_embedding(topology: str, pr: int, pc: int):
    """(max_edge_hops, congestion) of the N-ring embedded in the topology.

    torus/ring: every ring edge is a physical link (1 hop, no sharing).
    mesh: serpentine rows give unit edges, but the ring must close from
    the serpentine's last cell back to (0,0); that return path is
    (pr-1) hops (+ pc-1 when pr is odd) and runs over links the
    serpentine already uses, so contended links carry two chunks/step.
    """
    n = pr * pc
    if topology in ("torus", "ring") or n <= 2:
        return 1, 1.0
    closing = (pr - 1) + ((pc - 1) if pr % 2 else 0)
    closing = max(closing, 1)
    return closing, (2.0 if closing > 1 else 1.0)


def allreduce_cycles(topology: str, pr: int, pc: int, payload_bytes,
                     link_bw, flit_bytes, buffer_flits, hop_cycles):
    """Ring all-reduce makespan (reduce-scatter + all-gather), float32."""
    n = pr * pc
    payload = torch.as_tensor(payload_bytes, dtype=torch.float32)
    if n == 1:
        return torch.zeros_like(payload)
    s, _ = service_interval(link_bw, flit_bytes, buffer_flits, hop_cycles)
    chunk_flits = payload / (n * flit_bytes)
    edge_hops, congestion = _ring_embedding(topology, pr, pc)
    step = congestion * chunk_flits * s + edge_hops * hop_cycles
    return 2.0 * (n - 1) * step
