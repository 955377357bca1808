"""The bank-conflict kernel (CUDA), its plain PyTorch version, and the
dispatch between them."""
from .conflict import conflict_slowdown
from .ops import layout_slowdown, per_cycle_slowdown
from .ref import conflict_slowdown_reference
