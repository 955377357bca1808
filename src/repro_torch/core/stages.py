"""The traced stage twins of `repro.core.stages`, ported to PyTorch: the
stage pipeline's math (mapping -> sram -> dram[fast] -> energy) on float32
tensors with a leading design axis, which is what the batched sweep runs.

Only the dense single-core branch is in this slice: sparsity, the
multi-core partition and the layout stage are refused by the Study layer
(`api/study.py`) until the traced feature models are ported, so the
feature dictionaries the reference threads through (`sparsity=`,
`multicore=`, `layout=`) must be None here.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import dataflow as dfm
from .accelerator import MemoryConfig
from .energy import action_counts_raw

FIDELITIES = ("fast", "cycle", "trace")

_NO_SPILL_BYTES = 1 << 62     # "infinite" psum SRAM: legacy traced semantics


def _dense_only(**features) -> None:
    for name, v in features.items():
        if v is not None:
            raise NotImplementedError(
                f"the {name} stage model is not ported yet (module item 5 "
                f"of the port, 'traced feature models'); this slice runs "
                f"dense single-core designs with layout off")


def traced_memory(sram_elems, word_bytes=2, *, ifmap_elems=None,
                  filter_elems=None, ofmap_elems=None,
                  l2_bytes=0) -> MemoryConfig:
    """A MemoryConfig whose fields may be tensors. With only `sram_elems`,
    reproduces the legacy traced model: both operand SRAMs sized to
    sram_elems, psums never spill."""
    wb = word_bytes
    return MemoryConfig(
        ifmap_sram_bytes=(ifmap_elems if ifmap_elems is not None
                          else sram_elems) * wb,
        filter_sram_bytes=(filter_elems if filter_elems is not None
                           else sram_elems) * wb,
        ofmap_sram_bytes=(ofmap_elems * wb if ofmap_elems is not None
                          else _NO_SPILL_BYTES),
        l2_sram_bytes=l2_bytes, word_bytes=wb)


def traced_gemm_stats(dataflow: str, M, N, K, R, C, mem: MemoryConfig,
                      bw_bytes_per_cycle) -> Dict[str, torch.Tensor]:
    """mapping + sram + dram(fast) stages on tensors."""
    comp = dfm.compute_cycles(dataflow, M, N, K, R, C)
    util = dfm.pe_utilization(dataflow, M, N, K, R, C)
    sram = dfm.sram_traffic(dataflow, M, N, K, R, C)
    dram = dfm.dram_traffic(dataflow, M, N, K, R, C, mem)
    dram_elems = (dram["dram_ifmap"] + dram["dram_filter"]
                  + dram["dram_ofmap_writes"] + dram["dram_ofmap_reads"])
    dram_bytes = dram_elems * mem.word_bytes
    stall = dfm.dram_stall_cycles_simple(dram_bytes, comp,
                                         bw_bytes_per_cycle)
    return dict(compute_cycles=comp, stall_cycles=stall,
                total_cycles=comp + stall, utilization=util,
                dram_bytes=dram_bytes, dram_elems=dram_elems, **sram)


def traced_vector_stats(elems, lanes, latency, word_bytes
                        ) -> Dict[str, torch.Tensor]:
    """SIMD sidecar (per instance; callers scale by count)."""
    cyc = dfm.simd_cycles(elems, lanes, latency)
    return dict(compute_cycles=cyc, dram_bytes=elems * word_bytes)


def traced_energy_counts(*, R, C, mem: MemoryConfig, cycles, macs,
                         ifmap_reads, filter_reads, ofmap_writes,
                         ofmap_reads, dram_bytes, l2_reads=0.0,
                         row_bytes: int = 64, pes=None,
                         dim32=None) -> Dict[str, torch.Tensor]:
    """The energy stage's action counts with tensor-valued config fields;
    identical formulas to the reference's `energy.action_counts`. `mem`
    must carry real SRAM sizes (not the no-spill sentinel)."""
    sram_kib = (mem.ifmap_sram_bytes + mem.filter_sram_bytes
                + mem.ofmap_sram_bytes) / 1024.0
    if pes is None:
        pes = R * C
    if dim32 is None:
        dim32 = torch.maximum(R, C) / 32.0
    return action_counts_raw(
        pes=pes, dim32=dim32, sram_kib=sram_kib,
        word_bytes=mem.word_bytes, cycles=cycles, macs=macs,
        ifmap_reads=ifmap_reads, filter_reads=filter_reads,
        ofmap_writes=ofmap_writes, ofmap_reads=ofmap_reads,
        dram_bytes=dram_bytes, l2_reads=l2_reads, row_bytes=row_bytes)


def traced_comp_traffic(dataflow: str, M, N, K, R, C, mem: MemoryConfig, *,
                        sparsity: Optional[Dict] = None,
                        multicore: Optional[Dict] = None):
    """Effective compute cycles + SRAM/DRAM traffic (dense single core).
    Returns (comp, sram dict, dram dict, filter_shrink)."""
    _dense_only(sparsity=sparsity, multicore=multicore)
    comp = dfm.compute_cycles(dataflow, M, N, K, R, C)
    sram = dfm.sram_traffic(dataflow, M, N, K, R, C)
    dram = dfm.dram_traffic(dataflow, M, N, K, R, C, mem)
    # the dense filter shrink is exactly 1: the reference multiplies by
    # f32(1.0), which changes no value
    return comp, sram, dram, 1.0


def traced_op_stats(dataflow: str, M, N, K, R, C, mem: MemoryConfig,
                    bw_bytes_per_cycle, *,
                    sparsity: Optional[Dict] = None,
                    multicore: Optional[Dict] = None,
                    layout: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The fast-fidelity gemm pipeline on tensors (per op instance;
    callers scale by count)."""
    _dense_only(layout=layout)
    comp, sram, dram, shrink = traced_comp_traffic(
        dataflow, M, N, K, R, C, mem, sparsity=sparsity,
        multicore=multicore)
    dram_elems = (dram["dram_ifmap"] + dram["dram_filter"]
                  + dram["dram_ofmap_writes"] + dram["dram_ofmap_reads"])
    dram_bytes = dram_elems * mem.word_bytes
    stall = dfm.dram_stall_cycles_simple(dram_bytes, comp,
                                         bw_bytes_per_cycle)
    return dict(compute_cycles=comp, stall_cycles=stall,
                layout_extra_cycles=torch.zeros_like(comp),
                dram_bytes=dram_bytes, dram_elems=dram_elems,
                filter_shrink=shrink, **sram)
