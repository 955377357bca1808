"""Deterministic, seeded fault plans: the chaos plane's schedule object.

A `FaultPlan` is a seeded RNG plus a set of named **injection sites** —
the filesystem/process seams the farm and the Study executor already
route through (`repro_torch.faults.fs`). Production code never imports this
module's internals; it calls the `fs` shims, which consult the active
plan (if any) and otherwise cost one global-`None` check.

Determinism contract: a plan owns one `random.Random(seed)` consumed in
decision order, so the same seed driving the same call sequence replays
the exact same fault schedule — which is what lets the chaos soak and
the synchronous farm tests assert *bit-identical* outcomes under faults
rather than merely "it didn't crash".

Sites wired in the port (the reference's; DESIGN.md "Failure semantics"
holds the site x fault x expected-behavior matrix)::

    spool.put          FileSpool.put staging write + replace
    worker.result      shard result file write
    worker.claimed     crash point right after a shard claim
    worker.pre_ack     crash point after the result write, before ack
    worker.heartbeat   heartbeat writes
    broker.status      per-study status.json writes
    broker.manifest    per-study manifest.json writes
    broker.spec        spec.json writes
    broker.quarantine  broker-written quarantine shard results
    cache.store        Study cell-cache writes (study.py::_cache_store)
    search.checkpoint  SearchDriver checkpoint writes
    clock              lease clock reads (FileSpool stale-claim ages)

Fault kinds:

    os_error   the op raises a transient ``OSError`` (disk-full, EIO)
    torn       a write lands truncated (reader sees invalid JSON)
    corrupt    a write lands as garbage bytes (valid file, junk content)
    crash      ``InjectedCrash`` is raised — simulated process death
    skew       ``fs.now()`` returns ``time.time() + skew`` (lease storms)

Activation: ``with plan.active(): ...`` for in-process (synchronous
tests, the chaos driver), or the ``REPRO_FAULTS`` environment variable
(``plan.to_json()``) for real multi-process fleets — each subprocess
builds its own plan from the env, seeded independently deterministic.
"""
from __future__ import annotations

import contextlib
import dataclasses
import errno
import fnmatch
import json
import os
import random
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["FAULT_KINDS", "FaultPlan", "FaultRule", "InjectedCrash",
           "active_plan", "deactivate", "install"]

FAULT_KINDS = ("os_error", "torn", "corrupt", "crash", "skew")

ENV_VAR = "REPRO_FAULTS"


class InjectedCrash(BaseException):
    """Simulated process death at a crash point.

    Deliberately a ``BaseException`` (like ``KeyboardInterrupt``): the
    worker's and Study executor's ``except Exception`` guards must NOT
    absorb a simulated kill — the whole point is that the process dies
    mid-protocol and the farm's lease/requeue machinery recovers.
    """


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injectable fault at a site (or site glob pattern).

    p:      probability per eligible call (drawn from the plan's RNG —
            every eligible call consumes exactly one draw, pass or fail,
            so schedules replay deterministically).
    times:  cap on total injections for this rule (None = unlimited).
            Bounded rules are what make chaos runs provably terminate.
    after:  skip the first `after` matching calls (hit the Nth write).
    err:    errno for `os_error` faults.
    skew:   seconds added to `fs.now()` for `skew` faults.
    """
    kind: str
    p: float = 1.0
    times: Optional[int] = None
    after: int = 0
    err: int = errno.ENOSPC
    skew: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault probability must be in [0, 1], "
                             f"got {self.p}")
        if self.times is not None and self.times < 0:
            raise ValueError(f"times must be >= 0, got {self.times}")


RulesLike = Dict[str, Union[FaultRule, Sequence[FaultRule]]]


class _RuleState:
    __slots__ = ("calls", "fired")

    def __init__(self):
        self.calls = 0
        self.fired = 0


class FaultPlan:
    def __init__(self, seed: int = 0, rules: Optional[RulesLike] = None):
        self.seed = int(seed)
        self.rules: List[Tuple[str, FaultRule]] = []
        for pattern, rs in (rules or {}).items():
            if isinstance(rs, FaultRule):
                rs = [rs]
            for r in rs:
                self.rules.append((str(pattern), r))
        self._rng = random.Random(self.seed)
        self._state = [_RuleState() for _ in self.rules]
        self._injected: Dict[str, int] = {}
        self._lock = threading.Lock()

    # ---- the decision procedure -------------------------------------------
    def decide(self, site: str,
               kinds: Optional[Sequence[str]] = None
               ) -> Optional[FaultRule]:
        """First rule that matches `site` (glob patterns allowed), is
        within its `after`/`times` window, and wins its probability
        draw. At most one rule fires per call."""
        with self._lock:
            for (pattern, rule), state in zip(self.rules, self._state):
                if kinds is not None and rule.kind not in kinds:
                    continue
                if not fnmatch.fnmatchcase(site, pattern):
                    continue
                state.calls += 1
                if state.calls <= rule.after:
                    continue
                if rule.times is not None and state.fired >= rule.times:
                    continue
                if self._rng.random() >= rule.p:
                    continue
                state.fired += 1
                key = f"{site}:{rule.kind}"
                self._injected[key] = self._injected.get(key, 0) + 1
                return rule
        return None

    # ---- activation ---------------------------------------------------------
    @contextlib.contextmanager
    def active(self):
        """Install this plan as the process-wide active plan."""
        install(self)
        try:
            yield self
        finally:
            deactivate()

    # ---- introspection ------------------------------------------------------
    def report(self) -> dict:
        """What actually fired: the chaos soak's per-schedule artifact."""
        with self._lock:
            return {"seed": self.seed,
                    "rules": len(self.rules),
                    "injected": dict(sorted(self._injected.items())),
                    "total_injected": sum(self._injected.values())}

    # ---- wire format (REPRO_FAULTS) -----------------------------------------
    def to_json(self) -> str:
        rules: Dict[str, List[dict]] = {}
        for pattern, r in self.rules:
            rules.setdefault(pattern, []).append(dataclasses.asdict(r))
        return json.dumps({"seed": self.seed, "rules": rules})

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        d = json.loads(s)
        rules: RulesLike = {
            pattern: [FaultRule(**r) for r in rs]
            for pattern, rs in d.get("rules", {}).items()}
        return cls(seed=int(d.get("seed", 0)), rules=rules)


# ---- the process-wide active plan ---------------------------------------------

_ACTIVE: Optional[FaultPlan] = None
_ENV_CHECKED = False


def install(plan: FaultPlan) -> None:
    global _ACTIVE
    _ACTIVE = plan


def deactivate() -> None:
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = None
    _ENV_CHECKED = True      # an explicit deactivate wins over the env


def active_plan() -> Optional[FaultPlan]:
    """The installed plan; on first call, `REPRO_FAULTS` (a
    `FaultPlan.to_json()` payload) is honored so worker *subprocesses*
    of a real fleet inherit the chaos schedule."""
    global _ACTIVE, _ENV_CHECKED
    if _ACTIVE is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        env = os.environ.get(ENV_VAR)
        if env:
            try:
                _ACTIVE = FaultPlan.from_json(env)
            except (ValueError, TypeError, KeyError):
                _ACTIVE = None       # a bad env schedule is no schedule
    return _ACTIVE
