"""Simulation core of the PyTorch port: configs, workloads, the dataflow,
sparsity, energy and layout models, the DRAM timing model and its replay,
the multi-core partition with its shared-DRAM contention path, and the
per-op stage pipeline and engine (`stages`, `engine`). The `Simulator`
facade over this layer lives in `repro_torch.api`."""
from .accelerator import (AcceleratorConfig, CoreConfig, DramConfig,
                          LayoutConfig, MemoryConfig, NocConfig,
                          SparsityConfig, tpu_like_config)
from .dataflow import (compute_cycles, dram_traffic, gemm_summary, map_gemm,
                       mapping_occupancy, pe_utilization, sram_traffic,
                       unmap_gemm)
from .dram import (DramResult, decode_requests, linear_trace,
                   replay_requests, simulate_dram, strided_trace,
                   tile_prefetch_trace)
from .replay import DEFAULT_ENGINE, ENGINES, resolve_device, resolve_engine
from .energy import (DEFAULT_ERT, ERT, action_counts, action_counts_raw,
                     edp, energy_pj, power_w)
from .engine import (NetworkReport, OpResult, energy_traced,
                     gemm_summary_traced, simulate_network, simulate_op)
from .stages import (FIDELITIES, OpContext, Stage, build_pipeline,
                     pipeline_engine, traced_gemm_stats)
from .layout import (evaluate_layout, flat_ids, operand_linear_index,
                     slowdown_per_cycle)
from .multicore import (best_multicore, contention_summary,
                        simulate_multicore, simulate_multicore_contention)
from .partition import (best_plan, enumerate_plans, partition_cycles,
                        partition_footprint)
from .sparsity import (effective_K, pack_ellpack_block, sparse_compute_cycles,
                       storage_report)
from .workloads import PAPER_WORKLOADS, Op, lm_ops, total_macs

__all__ = [
    "AcceleratorConfig", "CoreConfig", "DramConfig", "LayoutConfig",
    "MemoryConfig", "NocConfig", "SparsityConfig", "tpu_like_config",
    "compute_cycles", "dram_traffic", "gemm_summary", "map_gemm",
    "mapping_occupancy", "pe_utilization", "sram_traffic", "unmap_gemm",
    "DramResult", "decode_requests", "linear_trace", "replay_requests",
    "simulate_dram", "strided_trace", "tile_prefetch_trace",
    "DEFAULT_ENGINE", "ENGINES", "resolve_device", "resolve_engine",
    "DEFAULT_ERT", "ERT", "action_counts", "action_counts_raw", "edp",
    "energy_pj", "power_w", "NetworkReport", "OpResult", "energy_traced",
    "gemm_summary_traced", "simulate_network", "simulate_op", "FIDELITIES",
    "OpContext", "Stage", "build_pipeline", "pipeline_engine",
    "traced_gemm_stats", "evaluate_layout", "flat_ids",
    "operand_linear_index", "slowdown_per_cycle", "best_multicore",
    "contention_summary", "simulate_multicore",
    "simulate_multicore_contention", "best_plan", "enumerate_plans",
    "partition_cycles", "partition_footprint", "effective_K",
    "pack_ellpack_block", "sparse_compute_cycles", "storage_report",
    "PAPER_WORKLOADS", "Op", "lm_ops", "total_macs",
]
