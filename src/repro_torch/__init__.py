"""SCALE-Sim v3 simulation plane in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

A port of the JAX package `repro`, slice by slice; the JAX package is the
reference it is tested against, and this package imports nothing from it
(nor JAX). Entry points run on the CUDA device unless the caller passes
`device="cpu"`, where each kernel's plain PyTorch version runs instead.

    from repro_torch import Study, studies, preset_grid
    res = studies.edp_array_size().run()          # on the GPU
    res = studies.dataflow_dram_flip().run(device="cpu")
"""
from .api import (Study, StudyResult, get_preset, get_study, list_presets,
                  list_studies, preset_grid, studies)
from .core.accelerator import (AcceleratorConfig, CoreConfig, DramConfig,
                               MemoryConfig, tpu_like_config)
from .core.workloads import Op
from .trace.contention import multicore_contention
from .trace.generator import DEFAULT_SPEC, TraceSpec

__all__ = ["Study", "StudyResult", "get_preset", "get_study",
           "list_presets", "list_studies", "preset_grid", "studies",
           "AcceleratorConfig", "CoreConfig", "DramConfig", "MemoryConfig",
           "tpu_like_config", "Op", "DEFAULT_SPEC", "TraceSpec",
           "multicore_contention"]
