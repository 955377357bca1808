"""Published peaks of one NVIDIA H100 (SXM part, 80 GB HBM3; NVIDIA's
data sheet, dense rates, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12     # HBM3 bandwidth
FP32_OPS_PER_S = 67e12        # float32 outside the tensor cores
