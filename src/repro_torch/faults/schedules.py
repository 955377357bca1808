"""The three CI-gated chaos schedules (and their registry).

Each factory returns a seeded `FaultPlan` whose rules are **bounded**
(`times` caps everywhere): a chaos run is guaranteed to stop injecting,
so termination reduces to the farm's own liveness — which is what the
soak gates. Under every schedule the farm run of a study must terminate
AND produce a frame bit-identical per column to the fault-free local
`Study.run()` (at-least-once delivery + idempotent folding + a shared
dedup cache make re-execution invisible in the output).

    worker-kills   workers die right after claiming and right before
                   acking; lease expiry requeues, duplicates fold once
    torn-writes    ENOSPC/EIO bursts on put/result/cache/heartbeat
                   writes plus torn result and status files; retries +
                   reader-side recovery (result-patience re-enqueue,
                   manifest status rebuild, cache-miss degradation)
    lease-storms   the lease clock jumps forward so healthy in-flight
                   shards requeue while their owner is still finishing;
                   idempotent per-shard folding keeps exactly one result
"""
from __future__ import annotations

from typing import Callable, Dict, List

from .plan import FaultPlan, FaultRule

__all__ = ["CHAOS_SCHEDULES", "chaos_schedule"]


def worker_kills(seed: int = 0) -> FaultPlan:
    return FaultPlan(seed, {
        # claimed-kills (no result yet) force a lease-expiry requeue
        # and full re-execution; pre-ack kills leave a durable result
        # plus an orphan lease the broker must retire
        "worker.claimed": FaultRule("crash", p=0.6, times=3),
        "worker.pre_ack": FaultRule("crash", p=0.35, times=2),
    })


def torn_writes(seed: int = 0) -> FaultPlan:
    return FaultPlan(seed, {
        "spool.put": [FaultRule("os_error", p=0.4, times=4),
                      FaultRule("torn", p=0.3, times=2)],
        "worker.result": [FaultRule("os_error", p=0.4, times=4),
                          FaultRule("torn", p=0.5, times=2)],
        "broker.status": FaultRule("torn", p=0.3, times=3),
        "cache.store": [FaultRule("corrupt", p=0.4, times=3),
                        FaultRule("os_error", p=0.4, times=3)],
        "worker.heartbeat": FaultRule("os_error", p=0.5, times=4),
    })


def lease_storms(seed: int = 0) -> FaultPlan:
    return FaultPlan(seed, {
        # every clock read during a storm window sees a huge skew, so
        # all claimed shards look stale at once and requeue mid-flight
        "clock": FaultRule("skew", skew=1e7, p=0.5, times=6),
        # a claimed-kill guarantees at least one shard is alive only as
        # a lease when the storm hits — it must requeue to complete
        "worker.claimed": FaultRule("crash", p=0.4, times=2),
        "worker.pre_ack": FaultRule("crash", p=0.3, times=1),
    })


CHAOS_SCHEDULES: Dict[str, Callable[[int], FaultPlan]] = {
    "worker-kills": worker_kills,
    "torn-writes": torn_writes,
    "lease-storms": lease_storms,
}


def chaos_schedule(name: str, seed: int = 0) -> FaultPlan:
    if name not in CHAOS_SCHEDULES:
        raise KeyError(f"unknown chaos schedule {name!r}; "
                       f"available: {sorted(CHAOS_SCHEDULES)}")
    return CHAOS_SCHEDULES[name](seed)


def schedule_names() -> List[str]:
    return sorted(CHAOS_SCHEDULES)
