"""Architecture registry: one module per assigned architecture.

Each module exports ARCH (exact published config) and SMOKE (reduced config
of the same family for CPU tests). `get_config(id)` / `list_archs()` are the
public API; shape cells live in `shapes.py`.
"""
from __future__ import annotations

import importlib
from typing import List

from ..models.config import ModelConfig
from .shapes import SHAPES, cell_mode, runnable_cells, skip_reason

_ARCH_MODULES = [
    "whisper_base", "mixtral_8x7b", "granite_moe_3b_a800m", "yi_34b",
    "qwen2_72b", "qwen2_1_5b", "glm4_9b", "zamba2_7b", "xlstm_1_3b",
    "internvl2_1b",
]

_IDS = {m.replace("_", "-"): m for m in _ARCH_MODULES}
# canonical ids as assigned
_CANON = {
    "whisper-base": "whisper_base",
    "mixtral-8x7b": "mixtral_8x7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "yi-34b": "yi_34b",
    "qwen2-72b": "qwen2_72b",
    "qwen2-1.5b": "qwen2_1_5b",
    "glm4-9b": "glm4_9b",
    "zamba2-7b": "zamba2_7b",
    "xlstm-1.3b": "xlstm_1_3b",
    "internvl2-1b": "internvl2_1b",
}


def list_archs() -> List[str]:
    return list(_CANON.keys())


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    mod_name = _CANON.get(arch_id, arch_id.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.SMOKE if smoke else mod.ARCH
