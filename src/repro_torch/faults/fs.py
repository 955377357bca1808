"""Filesystem/clock shims: the seams the fault plane injects through.

Production code (`farm/queue.py`, `farm/broker.py`, `farm/worker.py`,
`api/study.py::_cache_store`) routes its durable writes and lease-clock
reads through these functions instead of calling `os`/`time` directly —
no monkeypatching anywhere. With no active `FaultPlan` every shim is a
single global-`None` check away from the real syscall, so the hot path
cost is nil; with a plan installed, each call consults the plan's
seeded schedule and may raise a transient `OSError`, land a torn or
garbage write, simulate a process kill (`InjectedCrash`), or skew the
clock.

`atomic_write_json` is the one durable-write primitive the whole farm
uses: temp file + `os.replace`, transient `OSError`s retried with
backoff + jitter (`repro_torch.faults.retry`). Torn/corrupt faults are
deliberately NOT retried — they model silent corruption that the
*reader-side* hardening (tolerant parsers, broker re-fold/re-enqueue
recovery) must absorb, and the chaos soak exercises exactly that.
"""
from __future__ import annotations

import json
import os
import time
import uuid
from typing import Optional

from . import plan as _plan
from .retry import with_retries

__all__ = ["atomic_write_json", "crash_point", "now", "replace",
           "utime", "write_text"]


def _decide(site: str, kinds) -> Optional[_plan.FaultRule]:
    p = _plan.active_plan()
    return p.decide(site, kinds) if p is not None else None


# ---- crash points -------------------------------------------------------------

def crash_point(site: str) -> None:
    """Raise `InjectedCrash` if the active plan schedules a kill here.
    A no-op without a plan (and for sites the plan doesn't name)."""
    rule = _decide(site, ("crash",))
    if rule is not None:
        raise _plan.InjectedCrash(site)


# ---- the lease clock ----------------------------------------------------------

def now(site: str = "clock") -> float:
    """`time.time()`, plus any scheduled skew — the only clock the
    spool's lease-age computations read, so a `skew` rule turns every
    claimed shard stale at once (a lease storm)."""
    rule = _decide(site, ("skew",))
    return time.time() + (rule.skew if rule is not None else 0.0)


# ---- primitive ops ------------------------------------------------------------

def write_text(path: str, text: str, *, site: str) -> None:
    """Write `text` to `path`, subject to os_error/torn/corrupt faults.
    A torn write lands a truncated prefix; a corrupt write lands junk
    bytes — both *succeed* from the writer's point of view."""
    rule = _decide(site, ("os_error", "torn", "corrupt"))
    if rule is not None and rule.kind == "os_error":
        raise OSError(rule.err, os.strerror(rule.err), path)
    if rule is not None and rule.kind == "torn":
        text = text[:max(1, len(text) // 3)]
    elif rule is not None and rule.kind == "corrupt":
        text = '{"__corrupt__": tr'
    with open(path, "w") as f:
        f.write(text)


def replace(src: str, dst: str, *, site: str) -> None:
    rule = _decide(site, ("os_error",))
    if rule is not None:
        raise OSError(rule.err, os.strerror(rule.err), dst)
    os.replace(src, dst)


def utime(path: str, *, site: str) -> None:
    rule = _decide(site, ("os_error",))
    if rule is not None:
        raise OSError(rule.err, os.strerror(rule.err), path)
    os.utime(path)


# ---- the durable-write primitive ----------------------------------------------

def atomic_write_json(path: str, obj, *, site: str = "fs.write",
                      indent: Optional[int] = 1,
                      retries: int = 5) -> None:
    """Temp-file + `os.replace` JSON write with bounded retries.

    Readers see all-or-nothing (modulo injected torn/corrupt faults,
    which model post-write media corruption and are recovered on the
    read side). A crash fault at `site` fires before any bytes land —
    the caller's protocol must tolerate "wrote nothing, died"."""
    crash_point(site)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    text = json.dumps(obj, indent=indent)

    def _write() -> None:
        tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:6]}"
        try:
            write_text(tmp, text, site=site)
            replace(tmp, path, site=site)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    with_retries(_write, retries=retries)
