"""The element types the fold and ELLPACK kernels take: the reference's
under JAX's default config (`jax_enable_x64` off), which turns a 64-bit
input into its 32-bit type, so it has no 64-bit path to match."""
from __future__ import annotations

import torch

FLOATS = (torch.float32, torch.bfloat16, torch.float16)
INTS = (torch.int8, torch.uint8, torch.int16, torch.int32)
DTYPES = FLOATS + INTS


def refusal(dtype: torch.dtype) -> str:
    """Why a kernel of the fold or ELLPACK plane refuses `dtype`."""
    if dtype in (torch.float64, torch.int64, torch.uint64):
        return ("a 64-bit type: the reference, under JAX's default config, "
                "makes such an input its 32-bit type and has no 64-bit path "
                "to match")
    if dtype == torch.bool:
        return "bool is a mask, not a number to multiply or pack"
    if dtype.is_complex:
        return "complex values have no kernel here"
    return ("not one of float32, bfloat16, float16, int8, uint8, int16 or "
            "int32")
