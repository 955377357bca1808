"""Deterministic, resumable, shardable synthetic LM data pipeline (numpy
only; the reference's `repro/data/pipeline.py`, bit for bit).

Every batch is a pure function of (seed, step): restart from a checkpoint at
step k reproduces the identical stream with no iterator state to persist.
Batches are generated host-side per data shard (each host materializes only
its shard rows) and carry a loss mask.

The token stream is a mixture of Zipf-distributed ids with Markov-ish
repetition so a real model exhibits a decreasing loss curve rather than
memorizing uniform noise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..models.params import torch_dtype


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.3


class SyntheticLMDataset:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf-ish categorical over a capped alphabet (cheap + heavy-tailed)
        alpha = min(cfg.vocab, 4096)
        w = 1.0 / np.arange(1, alpha + 1) ** cfg.zipf_a
        self._probs = w / w.sum()
        self._alpha = alpha

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1
                 ) -> Dict[str, np.ndarray]:
        """Rows [shard::num_shards] of the global batch for `step`."""
        cfg = self.cfg
        rows = cfg.global_batch // num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        base = rng.choice(self._alpha, size=(rows, cfg.seq_len + 1),
                          p=self._probs).astype(np.int32)
        # Markov repetition: with prob repeat_p, copy the previous token
        rep = rng.random((rows, cfg.seq_len)) < cfg.repeat_p
        toks = base.copy()
        for t in range(1, cfg.seq_len + 1):
            toks[:, t] = np.where(rep[:, t - 1], toks[:, t - 1], toks[:, t])
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "loss_mask": np.ones((rows, cfg.seq_len), np.float32),
        }

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return self.batch_at(step, 0, 1)


def make_batch_specs(cfg, *, seq: int, batch: int, mode: str = "train"
                     ) -> Dict[str, torch.Tensor]:
    """Meta-device tensors of one step's inputs (shapes and dtypes only).

    cfg: ModelConfig. Frontends are stubs: audio provides precomputed frame
    embeddings, vlm provides patch embeddings.
    """
    dt = torch_dtype(cfg.param_dtype)
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    out: Dict[str, torch.Tensor] = {}
    if mode in ("train", "prefill"):
        out["tokens"] = meta((batch, seq), torch.int32)
        if mode == "train":
            out["labels"] = meta((batch, seq), torch.int32)
            out["loss_mask"] = meta((batch, seq), torch.float32)
        if cfg.family == "audio":
            out["frames"] = meta((batch, seq, cfg.d_model), dt)
        if cfg.family == "vlm":
            out["patches"] = meta((batch, cfg.frontend_tokens, cfg.d_model),
                                  dt)
    elif mode == "decode":
        out["token"] = meta((batch, 1), torch.int32)
    else:
        raise ValueError(mode)
    return out
