"""Assigned input-shape cells (seq_len x global_batch) and skip policy.

  train_4k    : train_step,   seq 4096,   batch 256
  prefill_32k : prefill_step, seq 32768,  batch 32
  decode_32k  : decode_step,  1 new token, 32k KV cache, batch 128
  long_500k   : decode_step,  524288 context, batch 1 — sub-quadratic archs
                only (SSM / hybrid / windowed attention); full-attention
                archs are skipped per DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

SHAPES: Dict[str, Dict] = {
    "train_4k": dict(seq=4096, batch=256, mode="train"),
    "prefill_32k": dict(seq=32768, batch=32, mode="prefill"),
    "decode_32k": dict(seq=32768, batch=128, mode="decode"),
    "long_500k": dict(seq=524288, batch=1, mode="decode"),
}


def cell_mode(shape_id: str) -> str:
    return SHAPES[shape_id]["mode"]


def skip_reason(cfg, shape_id: str) -> Optional[str]:
    if shape_id == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: 500k-context decode has no "
                "sub-quadratic state; skipped per DESIGN.md")
    return None


def runnable_cells(cfg) -> List[str]:
    return [s for s in SHAPES if skip_reason(cfg, s) is None]
