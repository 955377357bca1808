"""SCALE-Sim v3 simulation plane in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

A port of the JAX package `repro`, slice by slice; the JAX package is the
reference it is tested against, and this package imports nothing from it
(nor JAX). Entry points run on the CUDA device unless the caller passes
`device="cpu"`, where each kernel's plain PyTorch version runs instead.

    from repro_torch import Simulator, Study, studies, preset_grid
    Simulator("paper-32").run("resnet18")         # per-op engine, on the GPU
    Simulator("paper-32", fidelity="cycle", device="cpu").run("resnet18")
    res = studies.edp_array_size().run()          # batched Study, on the GPU
    res = studies.dataflow_dram_flip().run(device="cpu")

The public simulation API is `repro_torch.api`, the stage/engine layer
`repro_torch.core`; the trace tool chain is exported here too.
"""
from .api import (NetworkReport, OpResult, Simulator, Study, StudyResult,
                  SweepResult, get_preset, get_study, list_presets,
                  list_studies, preset_grid, studies)
from .core.accelerator import (AcceleratorConfig, CoreConfig, DramConfig,
                               MemoryConfig, tpu_like_config)
from .core.dram import linear_trace, strided_trace, tile_prefetch_trace
from .core.engine import simulate_network, simulate_op
from .core.stages import FIDELITIES, build_pipeline
from .core.workloads import Op
from .trace.contention import multicore_contention
from .trace.generator import (DEFAULT_SPEC, TraceSpec, gemm_request_stream,
                              gemm_trace_stats, trace_op, trace_op_stats)

__all__ = ["Study", "StudyResult", "get_preset", "get_study",
           "list_presets", "list_studies", "preset_grid", "studies",
           "Simulator", "SweepResult", "NetworkReport", "OpResult",
           "FIDELITIES", "build_pipeline", "simulate_network", "simulate_op",
           "AcceleratorConfig", "CoreConfig", "DramConfig", "MemoryConfig",
           "tpu_like_config", "Op", "DEFAULT_SPEC", "TraceSpec",
           "gemm_request_stream", "gemm_trace_stats", "trace_op",
           "trace_op_stats", "linear_trace", "strided_trace",
           "tile_prefetch_trace", "multicore_contention"]
