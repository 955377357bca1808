"""Bounded retries with exponential backoff + deterministic jitter.

The farm's transient-I/O hardening: every durable write in the
claim/execute/write-result path retries through here, so an injected
(or real) ENOSPC/EIO burst degrades to a short stall instead of a lost
shard. Jitter comes from a module-level seeded RNG — retry timing never
perturbs a fault schedule's decision sequence (the plan has its own
RNG), and backoff sequences are reproducible across runs.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Sequence, Tuple, Type, TypeVar

__all__ = ["backoff_delays", "with_retries"]

T = TypeVar("T")

# deterministic jitter source, independent of any FaultPlan RNG
_JITTER = random.Random(0x5eed)

DEFAULT_RETRIES = 5
DEFAULT_BASE = 0.002          # seconds; doubles per attempt
DEFAULT_FACTOR = 2.0


def backoff_delays(retries: int = DEFAULT_RETRIES,
                   base: float = DEFAULT_BASE,
                   factor: float = DEFAULT_FACTOR,
                   rng: random.Random = _JITTER) -> Sequence[float]:
    """Exponential backoff schedule with multiplicative jitter in
    [0.5, 1.5) — bounded, monotone in expectation, never zero."""
    return [base * (factor ** k) * (0.5 + rng.random())
            for k in range(retries)]


def with_retries(fn: Callable[[], T], *,
                 retries: int = DEFAULT_RETRIES,
                 base: float = DEFAULT_BASE,
                 factor: float = DEFAULT_FACTOR,
                 retry_on: Tuple[Type[BaseException], ...] = (OSError,),
                 sleep: Callable[[float], None] = time.sleep) -> T:
    """Call `fn`; on a `retry_on` exception, back off and retry up to
    `retries` times. The final failure re-raises the last exception —
    callers decide whether a persistently-failing write is fatal (a
    shard result) or best-effort (a cache entry, a heartbeat)."""
    delays = backoff_delays(retries, base, factor)
    for delay in delays:
        try:
            return fn()
        except retry_on:
            sleep(delay)
    return fn()
