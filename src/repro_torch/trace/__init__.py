"""Dataflow-aware DRAM demand-trace generation (PyTorch port), with the
shared-DRAM multi-core contention path over merged per-core traces."""
from .contention import (ContentionResult, SharedDramResult, core_subgemm,
                         multicore_contention, simulate_shared_dram)
from .generator import (DEFAULT_SPEC, REGION_SPAN, TraceSpec,
                        gemm_request_stream, gemm_trace_stats, trace_op,
                        trace_op_stats)

__all__ = [
    "DEFAULT_SPEC", "REGION_SPAN", "TraceSpec", "gemm_request_stream",
    "gemm_trace_stats", "trace_op", "trace_op_stats",
    "ContentionResult", "SharedDramResult", "core_subgemm",
    "multicore_contention", "simulate_shared_dram",
]
