"""Autonomous multi-fidelity design-space search, on the PyTorch port's
Study (the reference's `repro.search`; rounds run on the driver's
`device`, CUDA unless it is asked for the CPU).

Drives Study evaluations instead of cross-producting them: a declarative
`SearchSpace` (deterministic counter-keyed-hash sampling, no RNG state),
successive-halving promotion up the `fast` → `trace` → `cycle` fidelity
ladder by scalar metric or Pareto rank (`halving`), Pareto-frontier
perturbation between rounds (`proposer`), and a `SearchDriver` compiling
each round into an ad-hoc `Study` so every cell flows through the batched
sweep and its CUDA kernels, the content-hash cell cache and — via
`FarmExecutor` — the
broker/worker fleet. `studies.search_edp` is the claims-gated flagship.
"""
from .driver import (FarmExecutor, SearchDriver, SearchLog,  # noqa: F401
                     SearchResult)
from .halving import promote, rung_sizes  # noqa: F401
from .proposer import propose  # noqa: F401
from .space import (Axis, SearchPoint, SearchSpace, choice,  # noqa: F401
                    int_log_range)
from .studies import SearchStudy, search_edp, table_v_space  # noqa: F401

__all__ = [
    "Axis", "SearchPoint", "SearchSpace", "choice", "int_log_range",
    "promote", "rung_sizes", "propose",
    "SearchDriver", "SearchLog", "SearchResult", "FarmExecutor",
    "SearchStudy", "search_edp", "table_v_space",
]
