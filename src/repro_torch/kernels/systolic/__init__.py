"""The systolic fold kernels (CUDA), their plain PyTorch versions, the
per-cycle oracle, and the fold plane built on them."""
from .ops import FoldSim, batched_fold_activity, fold_output, simulate_fold
from .ref import (systolic_matmul_reference, systolic_ws_reference,
                  total_cycles_ws, wavefront_activity_plain,
                  wavefront_activity_reference, wavefront_closed_form)
from .systolic import (systolic_matmul, wavefront_activity,
                       wavefront_activity_batched)
