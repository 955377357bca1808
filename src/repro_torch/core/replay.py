"""Chunked bank-parallel DRAM replay: engine resolution and the dispatcher.

The reference (`repro.core.replay`) carries two chunked formulations: an
XLA scan driver and the fused Pallas megakernel. The port follows the
megakernel's: streams are cut into chunks of C requests; per chunk the
order-only tables are built and the completion times are iterated to the
fixed point of the monotone closure operator, under the contract of
`kernels.replay.chunkmath.iterate_fixed_point` (two passes, then more
while any completion moved by more than `tol`, capped at `max_passes`, or
C + 2 when none is given).

Where it runs follows the tensors, and the label says so:
  "cuda"         CUDA tensors -> the hand-written CUDA megakernel
                 (`kernels.replay.megakernel`, one warp per stream);
  "torch:plain"  CPU tensors  -> the kernel's plain PyTorch version;
  "reference"    the per-request loop `core.dram._reference_scan`, the
                 semantics oracle (requested by name, tests only).
"""
from __future__ import annotations

from typing import Optional

import torch

from .accelerator import DramConfig

ENGINES = ("megakernel", "reference")
DEFAULT_ENGINE = "megakernel"
# Fixed-point stopping threshold (cycles): a pass that moves no completion
# by more than this ends the iteration.  tol=0.0 = exact fixed point.
DEFAULT_TOL = 0.25


def resolve_engine(engine: Optional[str]) -> str:
    eng = DEFAULT_ENGINE if engine is None else engine
    if eng not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    return eng


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Never falls back quietly: without a CUDA device, `None`
    raises."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; this entry point runs on the GPU "
            "by default. Pass device='cpu' to run the plain PyTorch version "
            "on the CPU.")
    return device


def resolve_engine_runtime(engine: Optional[str],
                           device: torch.device) -> str:
    """The engine that actually executes on `device`: "cuda" or
    "torch:plain" for the megakernel, "reference" for the oracle.
    `replay_decoded` dispatches on this label and result metadata records
    it."""
    eng = resolve_engine(engine)
    if eng == "reference":
        return eng
    return "cuda" if torch.device(device).type == "cuda" else "torch:plain"


def replay_decoded(t_issue, flat_bank, ch, row, is_write, valid,
                   cfg: DramConfig, gran_bytes: int = 64, *,
                   chunk: Optional[int] = None,
                   max_passes: Optional[int] = None,
                   tol: float = DEFAULT_TOL, n_cores: int = 1,
                   core_id=None, per_channel_queues: bool = False):
    """Chunked replay of pre-decoded request streams of shape (..., n),
    one stream per leading index: one CUDA kernel launch for CUDA tensors
    (which launches or raises), the kernel's plain PyTorch version for
    CPU tensors.

    A stream may merge `n_cores` cores: `core_id` (..., n) names each
    request's core (None: all core 0), and each core keeps its own
    backpressure shift. `per_channel_queues` gives every channel its own
    in-flight read and write rings (the shared-DRAM semantics of
    `trace.contention.simulate_shared_dram`); the default is one global
    ring pair, `simulate_dram`'s.

    Returns a dict: the raw per-request completion `done` (0 where
    ~valid; callers substitute their no-op value), the round-trip
    `latency`, the per-core backpressure `shift` (..., n_cores) and the
    exact row hit/empty/conflict counters.
    """
    from ..kernels.replay import megakernel as mk
    n = t_issue.shape[-1]
    batch = t_issue.shape[:-1]
    C = 64 if chunk is None else int(chunk)
    C = max(1, min(C, max(n, 1)))
    busy = max(1.0, gran_bytes / cfg.bandwidth_bytes_per_cycle)
    passes = None if max_passes is None else max(1, int(max_passes))
    n_qg = cfg.channels if per_channel_queues else 1
    kw = dict(cfg=cfg, busy=float(busy), C=C, max_passes=passes,
              tol=float(tol), n_cores=int(n_cores), n_qg=n_qg)
    ins = mk.prepare(t_issue, flat_bank, ch, row, is_write, valid, C,
                     core_id)
    if resolve_engine_runtime(None, t_issue.device) == "cuda":
        done, shift, cnt = mk.launch_cuda(ins, **kw)
    else:
        done, shift, cnt, _ = mk.run_plain(ins, **kw)

    done = done.reshape(batch + (-1,))[..., :n]
    vmask = torch.broadcast_to(valid, batch + (n,)).to(torch.bool)
    ti = t_issue.to(torch.float32)
    cnt = cnt.reshape(batch + (4,))
    return dict(done=done, latency=torch.where(vmask, done - ti, 0.0),
                shift=shift.reshape(batch + (int(n_cores),)),
                hits=cnt[..., 0], misses=cnt[..., 1], conflicts=cnt[..., 2])
