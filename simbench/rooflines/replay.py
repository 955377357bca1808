"""The work of one DRAM replay call, counted from the shapes it receives
(after `chip_smoke.py::replay_shape_info`, where 1,776 streams of 4,096
requests come to 147,344,064 bytes).

A call gets S streams of n requests, padded with invalid requests to
npad, a whole number of 64-request chunks. The least it must move, each
byte once:
- in, per request: issue time, flat bank, channel and row as 4-byte
  words (16 bytes), the write and valid flags as one bit each (npad / 4
  bytes a stream);
- out, per request: the completion time (4 bytes); per stream: the
  backpressure shift (4 bytes) and four 4-byte counters (16 bytes).
The least it must compute: one fixed-point pass per valid request, that
is 8 order-only table entries (same-bank and same-channel links, their
latencies, the queue indices) and 3 keyed maxima.
"""
from __future__ import annotations

from .peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S

CHUNK = 64
OPS_PER_VALID_REQUEST = 8 + 3


def replay_bytes(S: int, n: int) -> int:
    npad = -(-n // CHUNK) * CHUNK
    return S * npad * (4 + 3 * 4) + S * npad // 4 + S * npad * 4 \
        + S * (4 + 16)


def replay_least_s(S: int, n: int, valid: int) -> float:
    """The larger of the bytes over HBM bandwidth and the operations over
    the float32 rate (the bytes bound it at every shape here)."""
    return max(replay_bytes(S, n) / HBM_BYTES_PER_S,
               OPS_PER_VALID_REQUEST * valid / FP32_OPS_PER_S)
