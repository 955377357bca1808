"""SearchDriver: autonomous multi-fidelity rounds over a SearchSpace.

Each round is compiled into an *ad-hoc Study* — the cohort as the design
axis, one fidelity — so every evaluation flows through the existing
machinery unchanged: `_sweep_batched` flavor groups (one batched call per
static flavor, on the driver's device), the content-hash cell cache, and,
with a farm
executor, the broker/worker fleet (warming the same shared cache in both
directions, since cells are keyed by config *content*, not by study or
round).

The schedule:

    round 0            screen: `screen` hash-sampled points at ladder[0]
    rounds 1..R        propose: promote ceil(n/η) by Pareto rank, perturb
                       that frontier (proposer), evaluate the new points
                       at ladder[0]
    rungs              for each higher fidelity: promote `rung_sizes[i]`
                       survivors of the previous fidelity and re-evaluate

Everything the schedule decides is recorded in a `SearchLog` whose
entries are pure functions of (space, seed, knobs) plus the evaluated
metrics — deterministic bit-for-bit, so `log.digest()` is the replay
identity: same seed ⇒ same digest, locally or through the farm, cold
cache or warm, on one device type. (The digest hashes the `best` rows'
float values, so it is no identity across packages or device types:
compare cohorts and parents there.) Execution accounting (executed vs cache-hit cells) is
deliberately *outside* the log — it differs between a cold run and its
warm-cache resume while the search itself is identical.

Resume = determinism + the cell cache: a killed search re-run with the
same seed re-derives the same cohorts and finds the already-executed
cells in the cache, so only not-yet-run cells execute. The optional
checkpoint file records per-round progress (atomic write) for
inspection/accounting; it is evidence, not state the resume depends on.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..api.study import Study, StudyResult
from ..core.replay import resolve_device
from ..faults import fs as _fs
from .halving import promote
from .proposer import propose
from .space import SearchPoint, SearchSpace

__all__ = ["SearchLog", "SearchResult", "SearchDriver", "FarmExecutor",
           "SEARCH_LOG_SCHEMA_VERSION"]

SEARCH_LOG_SCHEMA_VERSION = 1


class SearchLog:
    """Replayable record of a search: one entry per round.

    Entries hold only deterministic content — round kind, fidelity,
    cohort labels, promoted parents, the round's best row — so
    `digest()` is a seed-stable identity across reruns, farm/local
    execution and cold/warm caches.
    """

    def __init__(self, meta: Optional[Dict[str, object]] = None,
                 rounds: Optional[List[Dict[str, object]]] = None):
        self.meta: Dict[str, object] = dict(meta or {})
        self.rounds: List[Dict[str, object]] = list(rounds or [])

    def append(self, **entry) -> None:
        self.rounds.append(entry)

    def to_json(self) -> str:
        return json.dumps({"schema_version": SEARCH_LOG_SCHEMA_VERSION,
                           "meta": self.meta, "rounds": self.rounds},
                          sort_keys=True, indent=1)

    @classmethod
    def from_json(cls, s: str) -> "SearchLog":
        d = json.loads(s)
        if d.get("schema_version") != SEARCH_LOG_SCHEMA_VERSION:
            raise ValueError(
                f"search log schema_version {d.get('schema_version')!r} "
                f"!= supported {SEARCH_LOG_SCHEMA_VERSION}")
        return cls(meta=d.get("meta"), rounds=d.get("rounds"))

    def digest(self) -> str:
        """sha256 over the canonical JSON — the search's replay identity."""
        blob = json.dumps({"schema_version": SEARCH_LOG_SCHEMA_VERSION,
                           "meta": self.meta, "rounds": self.rounds},
                          sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()


@dataclasses.dataclass
class SearchResult:
    """What a search run produced.

    frame: every evaluated cell across all rounds and fidelities, one
    `StudyResult` (concat of the round frames; a design promoted up the
    ladder appears once per fidelity). winner: the best-`metric` row at
    the final rung's fidelity. spent_evals: evaluations the schedule
    *requested* (the budget currency); executed_cells/cache_hits split
    those into actually-run vs cache-served. exhaustive_cells: the valid
    size of the space — the cost exhaustion would have paid.
    """
    frame: StudyResult
    log: SearchLog
    winner: Dict[str, object]
    spent_evals: int
    executed_cells: int
    cache_hits: int
    exhaustive_cells: int


class FarmExecutor:
    """Round executor dispatching each ad-hoc Study to a `repro_torch.farm`
    fleet. `pump`, when given, is called between status polls — in-process
    tests pass a closure stepping the broker and workers synchronously;
    against a live fleet leave it None and the executor just polls.
    Placement is the workers' (each runs on its own `--device`), and the
    reassembled frames name the device type the workers report.

    Point the driver's cache at `self.cache_dir` (the farm's shared dedup
    cache) and warm cells flow both ways between local and farm rounds.
    """

    def __init__(self, root: str, *, pump: Optional[Callable[[], None]] = None,
                 poll_s: float = 0.05, timeout_s: float = 600.0):
        from ..farm.client import FarmClient
        from ..farm.queue import FarmDirs
        self.root = root
        self.pump = pump
        self.poll_s = poll_s
        self.timeout_s = timeout_s
        self.cache_dir = FarmDirs(root).cache_dir()
        os.makedirs(self.cache_dir, exist_ok=True)
        self._client = FarmClient(root)

    def __call__(self, study: Study) -> StudyResult:
        sid = self._client.submit(study)
        deadline = time.monotonic() + self.timeout_s
        # a fresh submission sits "queued" until the broker shards it
        while self._client.status(sid).get("state") not in (
                "done", "error", "canceled"):
            if self.pump is not None:
                self.pump()
            else:
                time.sleep(self.poll_s)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"farm round {study.name!r} ({sid}) still running "
                    f"after {self.timeout_s}s")
        return self._client.result(sid, timeout=self.timeout_s)


class SearchDriver:
    """Drives the screen → propose → promote schedule over a space.

    workloads: {name: ops} — the workload axis of every round study.
    ladder: fidelity per rung, cheapest first (ladder[0] is where the
    screen and all proposal rounds run). rung_sizes: cohort size for each
    ladder[1:] rung; defaults to continued halving of the last base-rung
    cohort. budget: hard cap on total requested evaluations — cohorts
    truncate to the remaining budget and the search stops when it hits 0.
    executor: callable(Study) -> StudyResult (None = `study.run()`
    locally; see `FarmExecutor`). device: where local rounds run (CUDA
    unless "cpu"; raises without a card).
    """

    def __init__(self, space: SearchSpace, workloads: Dict[str, object], *,
                 seed: int = 0, metric: str = "edp",
                 objectives: Sequence[str] = ("total_cycles", "energy_pj"),
                 ladder: Sequence[str] = ("fast",), screen: int = 64,
                 eta: float = 4.0, explore_rounds: int = 1,
                 rung_sizes: Optional[Sequence[int]] = None,
                 budget: Optional[int] = None,
                 cache: Optional[str] = None,
                 checkpoint: Optional[str] = None,
                 executor: Optional[Callable[[Study], StudyResult]] = None,
                 device=None):
        if screen < 1:
            raise ValueError(f"screen cohort must be >= 1, got {screen}")
        if eta <= 1:
            raise ValueError(f"eta must be > 1, got {eta}")
        if not ladder:
            raise ValueError("ladder needs at least one fidelity")
        if explore_rounds < 0:
            raise ValueError(f"explore_rounds must be >= 0, "
                             f"got {explore_rounds}")
        if rung_sizes is not None and len(rung_sizes) != len(ladder) - 1:
            raise ValueError(
                f"rung_sizes needs one entry per ladder[1:] rung "
                f"({len(ladder) - 1}), got {len(rung_sizes)}")
        self.space = space
        self.workloads = dict(workloads)
        self.seed = int(seed)
        self.metric = metric
        self.objectives = tuple(objectives)
        self.ladder = tuple(ladder)
        self.screen = int(screen)
        self.eta = float(eta)
        self.explore_rounds = int(explore_rounds)
        self.rung_sizes = (None if rung_sizes is None
                           else [int(k) for k in rung_sizes])
        self.budget = None if budget is None else int(budget)
        self.cache = cache
        self.checkpoint = checkpoint
        self.executor = executor
        # a farm executor's rounds run where its workers run
        self.device = device if executor is not None else \
            resolve_device(device)

    # ---- internals ---------------------------------------------------------
    def _eval_cohort(self, round_idx: int, fidelity: str,
                     points: Sequence[SearchPoint]) -> StudyResult:
        study = Study(f"{self.space.name}-r{round_idx}-{fidelity}")
        study.designs({self.space.label(p): self.space.config(p)
                       for p in points})
        study.workloads(self.workloads)
        study.fidelity(fidelity)
        if self.cache is not None:
            study.cache(self.cache)
        if self.executor is not None:
            return self.executor(study)
        return study.run(device=self.device)

    def _checkpoint(self, log: SearchLog, spent: int, executed: int,
                    hits: int) -> None:
        if self.checkpoint is None:
            return
        _fs.atomic_write_json(
            self.checkpoint,
            {"schema_version": SEARCH_LOG_SCHEMA_VERSION,
             "space": self.space.name, "seed": self.seed,
             "rounds_done": len(log.rounds), "spent_evals": spent,
             "executed_cells": executed, "cache_hits": hits,
             "log_digest": log.digest(),
             "log": json.loads(log.to_json())},
            site="search.checkpoint", indent=None)

    # ---- the schedule ------------------------------------------------------
    def run(self) -> SearchResult:
        log = SearchLog(meta={
            "space": self.space.name, "seed": self.seed,
            "metric": self.metric, "objectives": list(self.objectives),
            "ladder": list(self.ladder), "screen": self.screen,
            "eta": self.eta, "explore_rounds": self.explore_rounds,
            "workloads": sorted(self.workloads),
        })
        frames: List[StudyResult] = []
        base_frames: List[StudyResult] = []
        evaluated: Dict[str, SearchPoint] = {}
        spent = executed = hits = 0
        budget_left = (math.inf if self.budget is None else self.budget)
        base_fid = self.ladder[0]

        def run_round(round_idx: int, kind: str, fid: str,
                      points: Sequence[SearchPoint],
                      parents: Sequence[str]) -> Optional[StudyResult]:
            nonlocal spent, executed, hits, budget_left
            points = list(points)[:int(min(budget_left, len(points)))]
            if not points:
                return None
            res = self._eval_cohort(round_idx, fid, points)
            frames.append(res)
            if fid == base_fid:
                base_frames.append(res)
            for p in points:
                evaluated.setdefault(self.space.label(p), p)
            spent += len(points)
            budget_left -= len(points)
            executed += res.executed_cells
            hits += res.cache_hits
            ok = res.ok()
            best = (ok.best(self.metric) if len(ok) else None)
            log.append(round=round_idx, kind=kind, fidelity=fid,
                       cohort=[self.space.label(p) for p in points],
                       parents=list(parents), best=best,
                       spent_evals=spent)
            self._checkpoint(log, spent, executed, hits)
            return res

        # round 0: the deterministic screen
        run_round(0, "screen", base_fid,
                  self.space.sample(self.screen, seed=self.seed, salt=0),
                  parents=[])

        # refinement rounds: perturb the Pareto frontier of everything
        # evaluated at the base fidelity so far
        last_cohort = self.screen
        for r in range(1, self.explore_rounds + 1):
            if budget_left <= 0 or not base_frames:
                break
            base = StudyResult.concat(base_frames)
            k = max(1, math.ceil(last_cohort / self.eta))
            parents = promote(base, k, metric=self.metric,
                              pareto=self.objectives)
            props = propose(self.space, [evaluated[l] for l in parents], k,
                            seed=self.seed, round_idx=r,
                            exclude=list(evaluated))
            if not props:
                break
            run_round(r, "propose", base_fid, props, parents=parents)
            last_cohort = k

        # fidelity rungs: promote survivors up the ladder
        sizes = self.rung_sizes
        if sizes is None:
            sizes, k = [], last_cohort
            for _ in self.ladder[1:]:
                k = max(1, math.ceil(k / self.eta))
                sizes.append(k)
        prev = (StudyResult.concat(base_frames) if base_frames else None)
        for i, fid in enumerate(self.ladder[1:]):
            if budget_left <= 0 or prev is None or not len(prev):
                break
            labels = promote(prev, sizes[i], metric=self.metric,
                             pareto=self.objectives)
            if not labels:
                break
            prev = run_round(self.explore_rounds + 1 + i, "rung", fid,
                             [evaluated[l] for l in labels],
                             parents=labels)

        if not frames:
            raise ValueError(
                f"search over {self.space.name!r} evaluated nothing "
                f"(budget={self.budget}, screen={self.screen})")
        frame = StudyResult.concat(frames)
        # the rounds' labels (device, and the replay engine of any round
        # that replayed DRAM streams) carry over to the whole frame
        for f in frames:
            frame.meta.update(f.meta)
        final_fid = str(frame["fidelity"][-1])
        final = frame.filter(fidelity=final_fid).ok()
        winner = final.best(self.metric)
        log.meta["winner"] = winner["design"]
        log.meta["winner_fidelity"] = final_fid
        self._checkpoint(log, spent, executed, hits)
        return SearchResult(frame=frame, log=log, winner=winner,
                            spent_evals=spent, executed_cells=executed,
                            cache_hits=hits,
                            exhaustive_cells=self.space.valid_size())
