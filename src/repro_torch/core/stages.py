"""The traced stage twins of `repro.core.stages`, ported to PyTorch: the
stage pipeline's math (mapping -> partition -> sparsity -> sram ->
dram[fast] -> layout -> energy) on float32 tensors with a leading design
axis, which is what the batched sweep runs.

Every feature is data (`torch.where` on 0/1 selectors) or a static flavor
of the call: the `sparsity=` and `multicore=` dicts and `layout=` carry
the layer-wise and row-wise N:M models, the multi-core partition and the
bank-conflict layout stage, so one call evaluates a mixed dense / sparse /
multi-core design group.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import dataflow as dfm
from .accelerator import MemoryConfig
from .energy import action_counts_raw
from .layout import streaming_layout_extra
from .multicore import best_multicore_cycles_model
from .sparsity import sparse_compute_cycles_model, storage_bytes_model

FIDELITIES = ("fast", "cycle", "trace")

_NO_SPILL_BYTES = 1 << 62     # "infinite" psum SRAM: legacy traced semantics


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
    """Effective compute cycles + (shrunk) SRAM/DRAM traffic.

    Mirrors the stage pipeline's feature composition exactly: the
    partition stage overrides single-core compute when the design has
    multiple cores, and the sparsity stage overrides both (paper
    semantics: sparse runs use the single-core compressed stream).

    sparsity:  {'en', 'n', 'm', 'rw'} tensors (en/rw are 0/1 selectors)
               plus the static 'representation' string.
    multicore: {'rows', 'cols', 'hops'} per-core tensors (core axis last,
               length Pr*Pc), 'nop' cycles-per-hop, and static 'Pr'/'Pc'
               grid shape.

    Returns (comp, sram dict, dram dict, filter_shrink).
    """
    comp = dfm.compute_cycles(dataflow, M, N, K, R, C)
    if multicore is not None:
        comp = best_multicore_cycles_model(
            dataflow, M, N, K, multicore["rows"], multicore["cols"],
            multicore["hops"], multicore["nop"], multicore["Pr"],
            multicore["Pc"])
    shrink = 1.0
    sram = dfm.sram_traffic(dataflow, M, N, K, R, C)
    dram = dfm.dram_traffic(dataflow, M, N, K, R, C, mem)
    if sparsity is not None:
        en, n, m, rw = (sparsity["en"], sparsity["n"], sparsity["m"],
                        sparsity["rw"])
        comp_sp = sparse_compute_cycles_model(dataflow, M, N, K, R, C,
                                              n, m, rw, enabled=en)
        comp = torch.where(torch.as_tensor(en) != 0, comp_sp, comp)
        orig, _, _, total = storage_bytes_model(
            M, K, n, m, rw, sparsity["representation"], mem.word_bytes,
            enabled=en)
        shrink = total / torch.clamp_min(orig, 1.0)
        sram = dict(sram, filter_reads=sram["filter_reads"] * shrink)
        dram = dict(dram, dram_filter=dram["dram_filter"] * shrink)
    # without sparsity the filter shrink is exactly 1: the reference
    # multiplies by f32(1.0), which changes no value
    return comp, sram, dram, shrink


def traced_op_stats(dataflow: str, M, N, K, R, C, mem: MemoryConfig,
                    bw_bytes_per_cycle, *,
                    sparsity: Optional[Dict] = None,
                    multicore: Optional[Dict] = None,
                    layout: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The fast-fidelity gemm pipeline on tensors (per op instance;
    callers scale by count). `layout`: {'cfg': LayoutConfig (static),
    'r_cap': static bound on R}, or None to skip the layout stage. See
    `traced_comp_traffic` for the sparsity/multicore parameters."""
    comp, sram, dram, shrink = traced_comp_traffic(
        dataflow, M, N, K, R, C, mem, sparsity=sparsity,
        multicore=multicore)
    dram_elems = (dram["dram_ifmap"] + dram["dram_filter"]
                  + dram["dram_ofmap_writes"] + dram["dram_ofmap_reads"])
    dram_bytes = dram_elems * mem.word_bytes
    stall = dfm.dram_stall_cycles_simple(dram_bytes, comp,
                                         bw_bytes_per_cycle)
    extra = torch.zeros_like(comp)
    if layout is not None:
        stride = torch.clamp_min(1.0 * N, 1.0)
        extra = streaming_layout_extra(layout["cfg"], R, comp, stride,
                                       mem.word_bytes, r_cap=layout["r_cap"])
    return dict(compute_cycles=comp, stall_cycles=stall,
                layout_extra_cycles=extra, dram_bytes=dram_bytes,
                dram_elems=dram_elems, filter_shrink=shrink, **sram)
