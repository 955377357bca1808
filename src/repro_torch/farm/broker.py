"""Broker: the farm's manager process (FireSim manager / run-farm shape).

One scheduling pass (`step`) does, in order:

1. **ingest** — claim submitted jobs from the `jobs` spool, rebuild each
   study from its spec (`Study.from_spec`), compile the plan, split it
   into **cell-group shards** and enqueue them on the `shards` spool at
   the study's priority. Shard sizing reuses `repro_torch.dist`'s elastic
   planner: the group's cell count is the "global batch" spread over the
   currently-alive worker fleet, capped at `max_shard_cells` per shard —
   so a fleet of M workers gets ≥ M concurrently-claimable slices of any
   non-trivial group, and the split re-plans as workers join or leave.
   An immutable `manifest.json` (shard -> cell indices) lands on disk
   before any shard is claimable — it is the recovery root for every
   failure path below.
2. **collect** — fold worker-written shard results into each study's
   `status.json` (cells done/failed, executed vs cache-hit counts,
   per-worker stats); a study whose every shard reported flips to
   `done`. Unreadable result files are tolerated for `result_patience`
   passes (a mid-write race), then deleted so the reconcile pass
   re-enqueues the shard. A worker-reported shard *error* is re-enqueued
   (bounded by the attempts budget), not allowed to poison the study.
3. **cancel** — apply `control/<sid>.cancel` requests: pending shards
   are dropped from the spool, the status flips to `canceled` (claimed
   shards finish idempotently; their results are simply ignored).
4. **requeue** — move claimed shards whose lease expired back to
   pending, **budgeted**: every requeue/re-enqueue/error counts against
   the shard's attempts; a shard that exceeds `max_shard_attempts` is
   *quarantined* — the broker writes a shard result marking its cells
   failed (they surface as `cell_status == 1` frame rows), so a poison
   shard degrades to failed cells instead of an infinite requeue loop.

Per-worker shard wall times feed a `StragglerDetector`
(median-of-means, see repro_torch.dist.straggler); flagged workers are
surfaced in `metrics()` so an operator (or the CI smoke gate) can see a
sick host without grepping logs.

The broker holds no authoritative state: everything lives in the spool
and the per-study JSON files, so a restarted broker resumes where the
old one died — in-flight studies are re-discovered from `status.json`,
and a *corrupt or missing* status is rebuilt from `manifest.json` by
re-folding the shard results on disk.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from ..api.study import Study, StudyPlan
from ..dist import StragglerDetector, plan_elastic_remesh
from .queue import (JOBS_TOPIC, SHARDS_TOPIC, FarmDirs, FileSpool,
                    read_json, write_json_atomic)

__all__ = ["Broker"]

# states a study's status.json can be in
ACTIVE, DONE, CANCELED, ERROR = "running", "done", "canceled", "error"


class Broker:
    def __init__(self, root: str, *, lease_seconds: float = 120.0,
                 max_shard_cells: int = 8,
                 heartbeat_timeout: float = 30.0,
                 max_shard_attempts: int = 5,
                 result_patience: int = 3,
                 straggler: Optional[StragglerDetector] = None):
        self.dirs = FarmDirs(root)
        self.spool = FileSpool(root)
        self.lease_seconds = float(lease_seconds)
        self.max_shard_cells = int(max_shard_cells)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.max_shard_attempts = int(max_shard_attempts)
        self.result_patience = int(result_patience)
        self.straggler = straggler or StragglerDetector(threshold=3.0,
                                                        patience=2)
        self._t0 = time.time()
        self._status: Dict[str, dict] = {}       # sid -> status dict
        self._seen_shards: Dict[str, set] = {}   # sid -> collected shard ids
        self._shards: Dict[str, List[List[int]]] = {}  # manifest cache
        self._bad_results: Dict[tuple, int] = {}  # (sid, file) -> passes
        self._worker_stats: Dict[str, dict] = {}
        self._worker_hosts: Dict[str, int] = {}  # wid -> straggler host int
        self._requeued_total = 0
        self._quarantined_total = 0
        # a restarted broker re-adopts in-flight studies from disk; a
        # corrupt/missing status.json with an intact manifest is rebuilt
        # (the shard results on disk re-fold on the next collect pass)
        for sid in self.dirs.study_ids():
            st = read_json(self.dirs.status_path(sid))
            if isinstance(st, dict) and st.get("state") == ACTIVE:
                self._status[sid] = st
                self._seen_shards[sid] = set(st.get("shards_done", []))
            elif not isinstance(st, dict):
                recovered = self._recover_status(sid)
                if recovered is not None:
                    self._write_status(sid, recovered)
                    self._seen_shards[sid] = set()

    # ---- one scheduling pass -------------------------------------------------
    def step(self) -> Dict[str, object]:
        ingested = self._ingest_jobs()
        collected = self._collect_results()
        canceled = self._apply_cancels()
        self._repair_statuses()
        # a broker that died mid-ingest leaves its job claim leased;
        # the successor (or a later pass) re-delivers it
        self.spool.requeue_stale(JOBS_TOPIC, self.lease_seconds)
        requeued = self._requeue_stale_budgeted()
        self._requeued_total += requeued
        if requeued:
            # a lease-expired shard of an already-canceled study must not
            # come back from the dead
            self._drop_canceled_pending()
        return {"ingested": ingested, "collected": collected,
                "canceled": canceled, "requeued": requeued,
                "queue_depth": self.spool.depth(SHARDS_TOPIC)}

    def serve(self, *, poll: float = 0.5, stop_event=None,
              max_steps: Optional[int] = None,
              metrics_path: Optional[str] = None) -> None:
        """Run `step` in a loop (the `python -m repro_torch.farm serve` body)."""
        steps = 0
        while True:
            self.step()
            if metrics_path:
                write_json_atomic(metrics_path, self.metrics())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return
            if stop_event is not None and stop_event.wait(poll):
                return
            if stop_event is None:
                time.sleep(poll)

    # ---- 1. ingest -------------------------------------------------------------
    def _ingest_jobs(self) -> List[str]:
        out: List[str] = []
        while True:
            item = self.spool.claim(JOBS_TOPIC, "broker")
            if item is None:
                return out
            sid = str(item.payload.get("study_id", item.item_id))
            priority = int(item.payload.get("priority", 100))
            existing = read_json(self.dirs.status_path(sid))
            if existing is not None:
                # duplicate submission, or canceled before ingest: the
                # job is dropped, the existing status stands
                self.spool.ack(item)
                continue
            try:
                study = Study.from_spec(item.payload["spec"])
                plan = study.plan()
            except Exception as e:  # noqa: BLE001 — bad spec = study error
                self._write_status(sid, {
                    "study_id": sid, "state": ERROR, "priority": priority,
                    "error": f"{type(e).__name__}: {e}",
                    "ingested_at": time.time()})
                self.spool.ack(item)
                out.append(sid)
                continue
            # a predecessor broker that died mid-ingest left a manifest:
            # reuse ITS split (re-enqueued duplicates execute to
            # identical bytes and fold once), never re-split — two
            # different splits under one study id would collide
            shards = self._manifest_shards(sid)
            if shards is None:
                # spec lands on disk BEFORE any shard is claimable: a
                # worker that can claim a shard can always rebuild the
                # study; the manifest lands before the shards for the
                # same reason (recovery needs it)
                write_json_atomic(self.dirs.spec_path(sid),
                                  item.payload["spec"], site="broker.spec")
                shards = self._split(plan)
                write_json_atomic(
                    self.dirs.manifest_path(sid),
                    {"study_id": sid, "priority": priority,
                     "cells_total": len(plan.cells),
                     "shards": [[int(i) for i in cells]
                                for cells in shards]},
                    site="broker.manifest")
                self._shards[sid] = [list(c) for c in shards]
            for k, cells in enumerate(shards):
                self.spool.put(SHARDS_TOPIC,
                               {"study_id": sid, "shard": k,
                                "cells": [int(i) for i in cells]},
                               priority=priority)
            self._write_status(sid, {
                "study_id": sid, "state": ACTIVE, "priority": priority,
                "shards_total": len(shards),
                "cells_total": len(plan.cells),
                "shards_done": [], "cells_done": 0, "cells_failed": 0,
                "executed_cells": 0, "cache_hits": 0,
                "attempts": {},
                "ingested_at": time.time()})
            self._seen_shards[sid] = set()
            self.spool.ack(item)
            out.append(sid)

    def _split(self, plan: StudyPlan) -> List[List[int]]:
        """Slice the plan into shards: whole-group slices sized by the
        elastic planner over the live worker fleet. A slice of a batched
        group still executes as one batched call on the worker; fallback
        (per-op) cells are chunked the same way."""
        n_workers = max(1, len(self.active_workers()))
        shards: List[List[int]] = []

        def slices(cells: List[int]) -> None:
            if not cells:
                return
            ep = plan_elastic_remesh(
                n_workers, global_batch=len(cells),
                max_per_device_batch=self.max_shard_cells)
            size = max(1, ep.per_device_batch)
            shards.extend(cells[i:i + size]
                          for i in range(0, len(cells), size))

        for grp in plan.groups:
            slices(list(grp.cells))
        slices(list(plan.fallback))
        return shards

    # ---- recovery helpers -------------------------------------------------------
    def _manifest_shards(self, sid: str) -> Optional[List[List[int]]]:
        """The ingest-time shard -> cells split, from cache or disk."""
        if sid in self._shards:
            return self._shards[sid]
        m = read_json(self.dirs.manifest_path(sid))
        if isinstance(m, dict) and isinstance(m.get("shards"), list):
            self._shards[sid] = [[int(i) for i in cells]
                                 for cells in m["shards"]]
            return self._shards[sid]
        return None

    def _recover_status(self, sid: str) -> Optional[dict]:
        """Rebuild a corrupt/missing status.json from the manifest.
        Counts restart at zero; the next collect pass re-folds every
        shard result on disk, so a recovered study converges to the
        same terminal state it was heading for."""
        shards = self._manifest_shards(sid)
        if shards is None:
            return None
        m = read_json(self.dirs.manifest_path(sid), {})
        return {"study_id": sid, "state": ACTIVE,
                "priority": int(m.get("priority", 100)),
                "shards_total": len(shards),
                "cells_total": int(m.get("cells_total",
                                         sum(len(c) for c in shards))),
                "shards_done": [], "cells_done": 0, "cells_failed": 0,
                "executed_cells": 0, "cache_hits": 0,
                "attempts": {}, "recovered_at": time.time()}

    def _bump_attempts(self, status: dict, shard: int) -> int:
        att = status.setdefault("attempts", {})
        key = str(int(shard))
        att[key] = int(att.get(key, 0)) + 1
        return att[key]

    def _quarantine(self, sid: str, shard: int, status: dict, *,
                    reason: str) -> None:
        """Fail a shard permanently: write a quarantine result marking
        its manifest cells failed. The normal collect pass folds it —
        the study completes with `cell_status == 1` rows instead of
        looping on a poison shard forever."""
        shards = self._manifest_shards(sid) or []
        cells = shards[shard] if 0 <= shard < len(shards) else []
        write_json_atomic(
            self.dirs.shard_result_path(sid, shard),
            {"study_id": sid, "shard": int(shard), "worker": "broker",
             "quarantined": True, "reason": reason,
             "failed_cells": [int(i) for i in cells]},
            site="broker.quarantine")
        self._quarantined_total += 1

    def _reconcile(self, sid: str, status: dict) -> int:
        """Re-enqueue shards that vanished: not folded, no result file,
        and (the caller guarantees) nothing pending or claimed in the
        spool — e.g. a result file deleted after `result_patience`
        unreadable passes, or a shard lost to a broker crash between
        manifest write and enqueue. Bounded by the attempts budget."""
        shards = self._manifest_shards(sid)
        if shards is None:
            return 0
        seen = self._seen_shards.get(sid, set())
        n = 0
        for k in range(len(shards)):
            if k in seen:
                continue
            if os.path.exists(self.dirs.shard_result_path(sid, k)):
                continue              # written (or under patience)
            attempts = self._bump_attempts(status, k)
            if attempts > self.max_shard_attempts:
                self._quarantine(sid, k, status,
                                 reason=f"lost {attempts}x")
            else:
                self.spool.put(SHARDS_TOPIC,
                               {"study_id": sid, "shard": k,
                                "cells": [int(i) for i in shards[k]]},
                               priority=int(status.get("priority", 100)))
            n += 1
        if n:
            self._write_status(sid, status)
        return n

    # ---- 2. collect -------------------------------------------------------------
    def _collect_results(self) -> int:
        new = 0
        spool_empty = None               # lazily computed, once per pass
        for sid in [s for s, st in self._status.items()
                    if st.get("state") == ACTIVE]:
            status = self._status[sid]
            seen = self._seen_shards.setdefault(sid, set())
            changed = False
            rdir = self.dirs.results_dir(sid)
            for name in (sorted(os.listdir(rdir))
                         if os.path.isdir(rdir) else []):
                if not (name.startswith("shard-")
                        and name.endswith(".json")):
                    continue
                path = os.path.join(rdir, name)
                payload = read_json(path)
                if not isinstance(payload, dict):
                    # mid-write — or torn for good. Tolerate it for
                    # `result_patience` passes, then delete so the
                    # reconcile pass re-enqueues the shard.
                    key = (sid, name)
                    self._bad_results[key] = \
                        self._bad_results.get(key, 0) + 1
                    if self._bad_results[key] > self.result_patience:
                        try:
                            os.unlink(path)
                        except OSError:
                            pass
                        del self._bad_results[key]
                    continue
                self._bad_results.pop((sid, name), None)
                shard = int(payload.get("shard", -1))
                if shard in seen:
                    continue
                wid = str(payload.get("worker", "?"))
                if payload.get("quarantined"):
                    seen.add(shard)
                    changed = True
                    new += 1
                    failed = payload.get("failed_cells", [])
                    status["cells_done"] += len(failed)
                    status["cells_failed"] = (
                        int(status.get("cells_failed", 0)) + len(failed))
                    status["shards_done"] = sorted(seen)
                    continue
                if "error" in payload:
                    # a worker exception is a failed ATTEMPT, not a
                    # poisoned study: re-enqueue within the budget,
                    # quarantine past it (legacy dirs without a
                    # manifest keep the old whole-study error)
                    shards = self._manifest_shards(sid)
                    if shards is None:
                        status["state"] = ERROR
                        status["error"] = (f"shard {shard} on {wid}: "
                                           f"{payload['error']}")
                        changed = True
                        continue
                    attempts = self._bump_attempts(status, shard)
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    if attempts > self.max_shard_attempts:
                        self._quarantine(
                            sid, shard, status,
                            reason=f"failed {attempts}x, last: "
                                   f"{payload['error']}")
                    elif 0 <= shard < len(shards):
                        self.spool.put(
                            SHARDS_TOPIC,
                            {"study_id": sid, "shard": shard,
                             "cells": [int(i) for i in shards[shard]]},
                            priority=int(status.get("priority", 100)))
                    changed = True
                    continue
                seen.add(shard)
                changed = True
                new += 1
                status["cells_done"] += len(payload.get("cells", {}))
                status["executed_cells"] += int(
                    payload.get("executed_cells", 0))
                status["cache_hits"] += int(payload.get("cache_hits", 0))
                status["shards_done"] = sorted(seen)
                self._record_worker(wid, payload)
            if (status["state"] == ACTIVE
                    and len(seen) < status.get("shards_total", 0)):
                # shards unaccounted for: if the whole spool is idle,
                # they are lost (deleted-after-patience, crashed mid-
                # enqueue) — re-enqueue them from the manifest
                if spool_empty is None:
                    spool_empty = (
                        self.spool.depth(SHARDS_TOPIC) == 0
                        and not self.spool.claimed_items(SHARDS_TOPIC))
                if spool_empty:
                    if self._reconcile(sid, status):
                        spool_empty = None       # queue refilled
            if changed:
                if (status["state"] == ACTIVE
                        and len(seen) >= status["shards_total"]):
                    status["state"] = DONE
                    status["done_at"] = time.time()
                self._write_status(sid, status)
        return new

    def _record_worker(self, wid: str, payload: dict) -> None:
        s = self._worker_stats.setdefault(
            wid, {"shards_done": 0, "cells_done": 0, "executed_cells": 0,
                  "cache_hits": 0, "busy_seconds": 0.0})
        s["shards_done"] += 1
        s["cells_done"] += len(payload.get("cells", {}))
        s["executed_cells"] += int(payload.get("executed_cells", 0))
        s["cache_hits"] += int(payload.get("cache_hits", 0))
        s["busy_seconds"] += float(payload.get("seconds", 0.0))
        host = self._worker_hosts.setdefault(wid, len(self._worker_hosts))
        self.straggler.record(host, float(payload.get("seconds", 0.0)))

    # ---- 3. cancel -------------------------------------------------------------
    def _apply_cancels(self) -> List[str]:
        cdir = self.dirs.control_dir()
        if not os.path.isdir(cdir):
            return []
        out: List[str] = []
        for name in sorted(os.listdir(cdir)):
            if not name.endswith(".cancel"):
                continue
            sid = name[:-len(".cancel")]
            status = self._status.get(sid) or read_json(
                self.dirs.status_path(sid))
            if not isinstance(status, dict):
                # canceled before ingest (or over a corrupt status):
                # park a canceled status so the job is dropped when
                # (if) it arrives
                status = {"study_id": sid, "state": CANCELED,
                          "canceled_at": time.time()}
            elif status.get("state") == ACTIVE:
                status["state"] = CANCELED
                status["canceled_at"] = time.time()
            self._write_status(sid, status)
            self.spool.drop_pending(
                SHARDS_TOPIC, lambda p, s=sid: p.get("study_id") == s)
            try:
                os.unlink(os.path.join(cdir, name))
            except OSError:
                pass
            out.append(sid)
        return out

    def _drop_canceled_pending(self) -> int:
        dead = {s for s, st in self._status.items()
                if st.get("state") in (CANCELED, ERROR)}
        if not dead:
            return 0
        return self.spool.drop_pending(
            SHARDS_TOPIC, lambda p: p.get("study_id") in dead)

    # ---- 4. budgeted requeue -----------------------------------------------------
    def _requeue_stale_budgeted(self) -> int:
        """Expired-lease shards go back to pending — each requeue is an
        attempt, and a shard past the budget is quarantined instead
        (the infinite-requeue-loop breaker for poison shards)."""
        requeued = 0
        touched: Dict[str, dict] = {}
        for item_id, _owner, _age, path in self.spool.stale_claims(
                SHARDS_TOPIC, self.lease_seconds):
            payload = read_json(path)
            if not isinstance(payload, dict):
                # unreadable claimed shard: drop the lease; reconcile
                # re-enqueues it from the manifest once the spool idles
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            sid = str(payload.get("study_id", "?"))
            shard = int(payload.get("shard", -1))
            status = self._status.get(sid)
            if status is None or status.get("state") != ACTIVE:
                try:
                    os.unlink(path)   # canceled/unknown: the lease dies
                except OSError:
                    pass
                continue
            attempts = self._bump_attempts(status, shard)
            touched[sid] = status
            if attempts > self.max_shard_attempts:
                self._quarantine(sid, shard, status,
                                 reason=f"lease expired {attempts}x")
                try:
                    os.unlink(path)
                except OSError:
                    pass
            elif self.spool.requeue(SHARDS_TOPIC, item_id, path):
                requeued += 1
        for sid, status in touched.items():
            self._write_status(sid, status)
        return requeued

    # ---- bookkeeping -------------------------------------------------------------
    def _repair_statuses(self) -> int:
        """Self-heal torn status files. The broker's in-memory copy is
        authoritative while it lives, and status is only written on
        change — so a torn write landing on a study's *terminal*
        transition would otherwise leave it unobservable to clients
        forever (the chaos torn-writes schedule catches exactly this)."""
        n = 0
        for sid, status in self._status.items():
            if not isinstance(read_json(self.dirs.status_path(sid)),
                              dict):
                self._write_status(sid, status)
                n += 1
        return n

    def _write_status(self, sid: str, status: dict) -> None:
        self._status[sid] = status
        write_json_atomic(self.dirs.status_path(sid), status,
                          site="broker.status")

    def active_workers(self) -> List[str]:
        """Worker ids with a fresh, *readable* heartbeat — a torn or
        garbage heartbeat file means dead worker, never a crash."""
        wdir = self.dirs.workers_dir()
        if not os.path.isdir(wdir):
            return []
        now = time.time()
        out = []
        for name in sorted(os.listdir(wdir)):
            if not name.endswith(".json"):
                continue
            hb = read_json(os.path.join(wdir, name))
            if not isinstance(hb, dict):
                continue
            try:
                t = float(hb.get("time", 0))
            except (TypeError, ValueError):
                continue
            if now - t < self.heartbeat_timeout:
                out.append(str(hb.get("worker", name[:-len(".json")])))
        return out

    def metrics(self) -> dict:
        """Fleet metrics: per-worker work done + cache hits, queue depth,
        straggler flags, study states — the CI smoke job's artifact."""
        host_to_wid = {h: w for w, h in self._worker_hosts.items()}
        workers = {}
        for wid, s in self._worker_stats.items():
            workers[wid] = dict(s)
        for wid in self.active_workers():
            workers.setdefault(wid, {})["alive"] = True
        return {
            "wall_seconds": time.time() - self._t0,
            "queue_depth": self.spool.depth(SHARDS_TOPIC),
            "claimed_shards": len(self.spool.claimed_items(SHARDS_TOPIC)),
            "requeued_shards": self._requeued_total,
            "quarantined_shards": self._quarantined_total,
            "workers": workers,
            "stragglers": [host_to_wid[h]
                           for h in self.straggler.stragglers()
                           if h in host_to_wid],
            "studies": {sid: st.get("state", "?")
                        for sid, st in self._status.items()},
        }
