"""Energy modeling (paper Sec. VII) — Accelergy's ERT, embedded; PyTorch port
of `repro.core.energy`.

Two stages, as in the paper: (1) simulator statistics become *action
counts* per component (`action_counts_raw`, elementwise on tensors of any
broadcastable shape; `action_counts` for a concrete config); (2) an Energy
Reference Table (ERT) maps each action to pJ (`energy_pj`). The fold
plane's per-cycle activity becomes a power trace
(`instantaneous_power_trace`). The ERT defaults are the reference's
calibrated 65nm-class constants, field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .accelerator import AcceleratorConfig


@dataclasses.dataclass(frozen=True)
class ERT:
    """Energy reference table, pJ per action (65nm-class defaults).

    `mac_wire_per_dim32` models operand-delivery (array NoC) energy that
    grows with array dimension: effective per-MAC energy on an RxC array is
    mac_random + mac_wire_per_dim32 * (max(R, C) / 32).
    """
    mac_random: float = 0.10         # 16-bit MAC @ 65nm, new operands
    mac_wire_per_dim32: float = 0.90  # operand delivery per MAC per 32 lanes
    mac_gated: float = 0.006         # clock-gated PE, per cycle (static only)
    pe_leak_per_cycle: float = 0.03   # per-PE leakage every cycle
    spad_read: float = 0.03          # per-PE register-file scratchpads
    spad_write: float = 0.045
    sram_read_random: float = 3.1    # L1 SRAM, per access (word)
    sram_read_repeat: float = 1.2    # same-row repeated access (>2x cheaper)
    sram_write_random: float = 3.5
    sram_write_repeat: float = 1.4
    sram_idle_per_cycle: float = 0.0005  # per KiB of SRAM per cycle
    l2_read: float = 6.0
    l2_write: float = 6.8
    dram_per_byte: float = 8.0       # ~64 pJ/bit HBM-class
    noc_per_byte_hop: float = 0.35

    def replace(self, **kw) -> "ERT":
        return dataclasses.replace(self, **kw)


DEFAULT_ERT = ERT()


def repeat_fraction(row_bytes: int = 64, word_bytes: int = 2) -> float:
    """Fraction of streaming SRAM accesses hitting the open row buffer
    (Sec. VII-C 'row size' knob)."""
    per_row = max(1, row_bytes // word_bytes)
    return 1.0 - 1.0 / per_row


def action_counts_raw(*, pes, dim32, sram_kib, word_bytes: int,
                      cycles, macs, ifmap_reads, filter_reads,
                      ofmap_writes, ofmap_reads, dram_bytes,
                      l2_reads=0.0, l2_writes=0.0, noc_byte_hops=0.0,
                      row_bytes: int = 64) -> Dict[str, torch.Tensor]:
    """Stage 1: simulator statistics -> Accelergy-style action counts.

    `cycles`, `macs` and `pes` are tensors (any broadcastable shape); the
    other statistics may be tensors or Python numbers. Same formulas, in
    the same order, as the reference.
    """
    util = torch.clamp(macs / torch.clamp_min(pes * cycles, 1.0), 0.0, 1.0)
    rf = repeat_fraction(row_bytes, word_bytes)
    sram_reads = ifmap_reads + filter_reads + ofmap_reads
    sram_writes = ofmap_writes
    return dict(
        mac_random=pes * cycles * util,
        mac_wire=pes * cycles * util * dim32,
        mac_gated=pes * cycles * (1.0 - util),
        pe_leak=pes * cycles,
        spad_read=3.0 * macs,                       # if/w/psum reads per MAC
        spad_write=ifmap_reads + filter_reads + macs,
        sram_read_random=sram_reads * (1 - rf),
        sram_read_repeat=sram_reads * rf,
        sram_write_random=sram_writes * (1 - rf),
        sram_write_repeat=sram_writes * rf,
        sram_idle_kib_cycles=cycles * sram_kib,
        l2_read=l2_reads, l2_write=l2_writes,
        dram_bytes=dram_bytes, noc_byte_hops=noc_byte_hops,
    )


def _config_scalars(cfg: AcceleratorConfig):
    """(total PEs, max array dimension / 32, SRAM KiB) of a config."""
    pes = sum(c.num_pes for c in cfg.cores)
    dim32 = max(max(c.rows, c.cols) for c in cfg.cores) / 32.0
    sram_kib = (cfg.memory.ifmap_sram_bytes + cfg.memory.filter_sram_bytes
                + cfg.memory.ofmap_sram_bytes) / 1024.0
    return pes, dim32, sram_kib


def action_counts(cfg: AcceleratorConfig, *, cycles, macs, ifmap_reads,
                  filter_reads, ofmap_writes, ofmap_reads, dram_bytes,
                  l2_reads=0.0, l2_writes=0.0, noc_byte_hops=0.0,
                  row_bytes: int = 64) -> Dict[str, torch.Tensor]:
    """Stage 1 for a concrete config. `cycles` and `macs` are tensors or
    Python numbers (a number becomes a float32 scalar, as the reference's
    jnp math makes it); the other statistics may be either."""
    pes, dim32, sram_kib = _config_scalars(cfg)
    dev = next((x.device for x in (cycles, macs)
                if isinstance(x, torch.Tensor)), torch.device("cpu"))
    cycles, macs = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in (cycles, macs))
    return action_counts_raw(
        pes=pes, dim32=dim32, sram_kib=sram_kib,
        word_bytes=cfg.memory.word_bytes, cycles=cycles, macs=macs,
        ifmap_reads=ifmap_reads, filter_reads=filter_reads,
        ofmap_writes=ofmap_writes, ofmap_reads=ofmap_reads,
        dram_bytes=dram_bytes, l2_reads=l2_reads, l2_writes=l2_writes,
        noc_byte_hops=noc_byte_hops, row_bytes=row_bytes)


_ACTION_TO_ERT = dict(
    mac_random="mac_random", mac_wire="mac_wire_per_dim32",
    mac_gated="mac_gated", pe_leak="pe_leak_per_cycle",
    spad_read="spad_read", spad_write="spad_write",
    sram_read_random="sram_read_random", sram_read_repeat="sram_read_repeat",
    sram_write_random="sram_write_random", sram_write_repeat="sram_write_repeat",
    sram_idle_kib_cycles="sram_idle_per_cycle",
    l2_read="l2_read", l2_write="l2_write",
    dram_bytes="dram_per_byte", noc_byte_hops="noc_per_byte_hop",
)


def energy_pj(counts: Dict[str, object], ert: ERT = DEFAULT_ERT
              ) -> Dict[str, object]:
    """Stage 2: action counts x ERT -> per-component pJ + total."""
    out = {k: counts[k] * getattr(ert, _ACTION_TO_ERT[k]) for k in counts}
    out["total"] = sum(out.values())
    return out


def edp(total_pj, cycles):
    """Energy-delay product in mJ * cycles (paper Table V units)."""
    return total_pj * 1e-9 * cycles


def power_w(total_pj, cycles, clock_ghz: float = 1.0):
    """Average power: pJ / cycle * GHz = mW, so * 1e-3 for W."""
    return total_pj / max(cycles, 1.0) * clock_ghz * 1e-3


def instantaneous_power_trace(active_pes: torch.Tensor,
                              cfg: AcceleratorConfig, ert: ERT = DEFAULT_ERT,
                              clock_ghz: float = 1.0) -> torch.Tensor:
    """Per-cycle power trace in watts (paper Table I: instantaneous power),
    float32, elementwise on the tensor's device.

    active_pes: active-PE counts per cycle, as `kernels.systolic`'s
    `simulate_fold` and `batched_fold_activity` produce them (any shape).
    Active PEs draw MAC + delivery + scratchpad energy; idle PEs draw
    gated energy; every PE leaks."""
    pes, dim32, _ = _config_scalars(cfg)
    a = active_pes.to(torch.float32)
    pj_per_cycle = (a * (ert.mac_random + ert.mac_wire_per_dim32 * dim32
                         + 3 * ert.spad_read)
                    + (pes - a) * ert.mac_gated
                    + pes * ert.pe_leak_per_cycle)
    return pj_per_cycle * clock_ghz * 1e-3        # pJ/ns = W
