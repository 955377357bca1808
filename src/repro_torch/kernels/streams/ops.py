"""The streams layer's one dispatch: a batch of GEMMs' demand-request
streams, generated, sorted by issue time and decoded.

Where it runs follows the tensors: CUDA tensors launch the CUDA kernel
(`streams.py`), which launches or raises; CPU tensors run the generator's
stable sort (`trace.generator.sorted_stream`) and `core.dram.
decode_requests`, the kernel's plain version, which on the CPU is faster
than ranking every slot by the merge.
"""
from __future__ import annotations

import torch

from ...core.accelerator import DramConfig


def decoded_request_streams(dataflow: str, M, N, K, R, C, comp,
                            ifmap_elems, filter_elems, ofmap_write_elems,
                            ofmap_read_elems, word_bytes: int, spec,
                            dram: DramConfig, device=None):
    """`gemm_request_stream` (same arguments, each GEMM its own scale)
    followed by `decode_requests` under `dram`: returns ((t, flat_bank,
    ch, row, is_write, valid), scale) on `device` (default: the
    arguments'), bit for bit theirs, each stream tensor of the batch shape
    + (spec.cap,). The per-stream factors are evaluated where the
    arguments lie; a CUDA `device` launches the kernel, the CPU sorts."""
    from ...trace.generator import sorted_stream, stream_prologue
    pro = stream_prologue(dataflow, M, N, K, R, C, comp, ifmap_elems,
                          filter_elems, ofmap_write_elems, ofmap_read_elems,
                          word_bytes, spec)
    dev = pro.n_model.device if device is None else torch.device(device)
    if dev.type == "cuda":
        from .streams import request_streams
        return request_streams(pro, dram, dev)
    from ...core.dram import decode_requests
    t, addr, is_write, valid, scale = sorted_stream(pro)
    return (t,) + decode_requests(addr, dram) + (is_write, valid), scale
