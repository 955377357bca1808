"""User-facing API of the PyTorch port: presets, the batched sweep and the
declarative Study layer."""
from .presets import get_preset, list_presets, preset_grid, register_preset
from .study import (Study, StudyResult, get_study, list_studies,
                    register_study, studies)

__all__ = ["get_preset", "list_presets", "preset_grid", "register_preset",
           "Study", "StudyResult", "get_study", "list_studies",
           "register_study", "studies"]
