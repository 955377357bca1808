"""User-facing API of the PyTorch port: the `Simulator` session facade over
the per-op stage pipeline, the accelerator preset registry, and the
declarative Study layer (cross-product experiment plans -> columnar
result frames). Entry points run on the GPU unless the caller passes
`device="cpu"`.

    from repro_torch.api import Simulator, Study, preset_grid, studies

    Simulator("paper-32").run("resnet18")               # one config
    Simulator(fidelity="cycle").run_op(op)              # cycle-accurate DRAM
    Simulator("paper-32", device="cpu").run("resnet18") # plain versions

    res = (Study()                                      # batched DSE study
           .designs(preset_grid(array=[16, 32, 64], sram_mb=[1, 8]))
           .workloads("resnet18")
           .fidelity("fast", "trace")
           .run())
    res.best("edp")

    studies.edp_array_size().run().check_claims()       # paper claims
    studies.search_edp().run(device="cpu")              # Table-V search
"""
from ..core.accelerator import AcceleratorConfig
from ..core.engine import NetworkReport, OpResult
from ..core.stages import FIDELITIES, build_pipeline
from .presets import (as_sparsity, get_preset, list_presets, preset_grid,
                      register_preset, with_cores)
from .simulator import Simulator, SweepResult, as_config, as_workload
from .study import (Study, StudyPlan, StudyResult, get_study, list_studies,
                    register_study, studies)
# the search layer registers its studies (studies.search_edp) on import;
# imported last so repro_torch.search's own imports of repro_torch.api.*
# submodules find them already initialized
from .. import search as _search  # noqa: E402,F401

__all__ = [
    "AcceleratorConfig", "FIDELITIES", "NetworkReport", "OpResult",
    "Simulator", "Study", "StudyPlan", "StudyResult", "SweepResult",
    "as_config", "as_sparsity", "as_workload", "build_pipeline",
    "get_preset", "get_study", "list_presets", "list_studies",
    "preset_grid", "register_preset", "register_study", "studies",
    "with_cores",
]
