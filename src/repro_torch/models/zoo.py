"""ModelBundle: one object per architecture exposing what the serving
launcher, the tests and the simulation plane need (the reference's
`repro/models/zoo.py`, serving part: the training step, the optimizer and
the sharding trees wait for later slices)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch

from ..data.pipeline import make_batch_specs
from . import decode as decode_mod
from . import params as pm
from .config import ModelConfig
from .transformer import LanguageModel, lm_loss, model_defs

PyTree = Any


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig

    def __post_init__(self):
        self.defs = model_defs(self.cfg)

    # ---- parameters --------------------------------------------------------
    def init(self, generator: torch.Generator) -> LanguageModel:
        """Random weights drawn from `generator`, on its device."""
        return LanguageModel(self.cfg, pm.init_params(self.defs, generator))

    def param_count(self) -> int:
        return pm.param_count(self.defs)

    def param_bytes(self) -> int:
        return pm.param_bytes(self.defs)

    # ---- steps -------------------------------------------------------------
    def prefill(self, model: LanguageModel, batch):
        return decode_mod.prefill(model, batch)

    def decode(self, model: LanguageModel, cache, token, cache_len: int):
        return decode_mod.decode(model, cache, token, cache_len)

    def loss(self, model: LanguageModel, batch) -> torch.Tensor:
        return lm_loss(model, batch)

    # ---- caches and specs --------------------------------------------------
    def batch_specs(self, *, seq: int, batch: int, mode: str) -> Dict:
        return make_batch_specs(self.cfg, seq=seq, batch=batch, mode=mode)

    def cache_defs(self, *, batch: int, cache_len: int):
        return decode_mod.cache_defs(self.cfg, batch, cache_len)

    def init_cache(self, *, batch: int, cache_len: int, device=None) -> PyTree:
        """A zero cache on `device` (CUDA unless the caller asks for the
        CPU; raises without a card)."""
        from ..core.replay import resolve_device
        return decode_mod.zeros_cache(
            self.cache_defs(batch=batch, cache_len=cache_len),
            resolve_device(device))


@functools.lru_cache(maxsize=None)
def get_bundle(arch_id: str, smoke: bool = False) -> ModelBundle:
    from ..configs import get_config
    return ModelBundle(get_config(arch_id, smoke=smoke))
