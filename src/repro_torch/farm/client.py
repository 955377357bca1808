"""Client: submit studies to the farm, stream results back.

`submit` serializes a `Study` to its spec (`Study.to_spec`) and drops it
on the `jobs` spool; the broker shards it, workers fill in cell metrics,
and the client reassembles frames straight from the worker-written shard
files — the broker is a scheduler, not a data plane, so result bytes
flow client <- worker with no middleman copy.

`stream` yields *partial* `StudyResult` frames as shards complete
(monotonically growing row counts, rows in plan order); `result` blocks
for the final frame, which is **bit-identical** to a local
`Study.run()` of the same plan: reassembly rebuilds the study from the
same spec, re-derives the same deterministic plan, and routes the
collected per-cell metrics through the exact `_frame` code path `run()`
uses. Registry-submitted studies (`get_study` / `studies.*`) keep their
machine-checkable claims across the round-trip. The frame's labels
(`meta["device"]`, `meta["engine"]`) name the device type the workers
report in their shard results, so the client needs no card; shards that
ran on different device types make the frame an error.
"""
from __future__ import annotations

import os
import time
import uuid
from typing import Dict, Iterator, List, Optional, Tuple

from ..api.study import Study, StudyPlan, StudyResult
from .queue import (JOBS_TOPIC, FarmDirs, FileSpool, read_json,
                    write_json_atomic)

__all__ = ["FarmClient"]

_FINAL = ("done", "canceled", "error")


class FarmClient:
    def __init__(self, root: str):
        self.dirs = FarmDirs(root)
        self.spool = FileSpool(root)
        self._studies: Dict[str, Tuple[Study, StudyPlan]] = {}

    # ---- submission -----------------------------------------------------------
    def submit(self, study, *, priority: int = 100,
               study_id: Optional[str] = None) -> str:
        """Submit a `Study` (or an already-serialized spec dict).
        Lower `priority` values are scheduled first. Returns the study
        id used for status/stream/result/cancel."""
        spec = study.to_spec() if isinstance(study, Study) else dict(study)
        base = (spec["ref"]["study"] if spec.get("ref")
                else spec.get("name", "study"))
        sid = study_id or (f"{FileSpool._safe(base)}"
                           f"-{time.time_ns():x}-{uuid.uuid4().hex[:4]}")
        self.spool.put(JOBS_TOPIC,
                       {"study_id": sid, "spec": spec,
                        "priority": int(priority),
                        "submitted_at": time.time()},
                       priority=priority)
        return sid

    def cancel(self, study_id: str) -> None:
        """Request cancellation: pending shards are dropped on the
        broker's next pass; in-flight shards finish idempotently."""
        write_json_atomic(self.dirs.cancel_path(study_id),
                          {"requested_at": time.time()})

    # ---- status -----------------------------------------------------------------
    def status(self, study_id: str) -> dict:
        return read_json(self.dirs.status_path(study_id),
                         {"study_id": study_id, "state": "queued"})

    def list_studies(self) -> Dict[str, str]:
        return {sid: self.status(sid).get("state", "?")
                for sid in self.dirs.study_ids()}

    # ---- result collection --------------------------------------------------------
    def _study(self, study_id: str) -> Optional[Tuple[Study, StudyPlan]]:
        """The rebuilt study + plan (None until the broker ingested it)."""
        if study_id not in self._studies:
            spec = read_json(self.dirs.spec_path(study_id))
            if spec is None:
                return None
            study = Study.from_spec(spec)
            self._studies[study_id] = (study, study.plan())
        return self._studies[study_id]

    def _collect(self, study_id: str
                 ) -> Tuple[Dict[int, Dict[str, float]], int, int,
                            List[str], Optional[str]]:
        """Fold worker shard files into ({cell: metrics}, executed,
        hits, errors, device): `device` is the device type the shards'
        workers report (None before any shard ran); shards of one study
        that ran on different device types raise. Shard results are
        keyed by shard id, so a requeued shard that ran twice counts
        once."""
        rdir = self.dirs.results_dir(study_id)
        results: Dict[int, Dict[str, float]] = {}
        executed = hits = 0
        errors: List[str] = []
        devices = set()
        if not os.path.isdir(rdir):
            return results, executed, hits, errors, None
        for name in sorted(os.listdir(rdir)):
            if not (name.startswith("shard-") and name.endswith(".json")):
                continue
            payload = read_json(os.path.join(rdir, name))
            if not isinstance(payload, dict):
                continue                      # mid-write; next poll sees it
            if payload.get("quarantined"):
                # broker gave up on this shard: its cells surface as
                # failed frame rows (cell_status == 1), not an exception
                for i in payload.get("failed_cells", []):
                    results[int(i)] = {"cell_status": 1.0}
                continue
            if "error" in payload:
                errors.append(f"shard {payload.get('shard')}: "
                              f"{payload['error']}")
                continue
            for i, m in payload.get("cells", {}).items():
                results[int(i)] = {k: float(v) for k, v in m.items()}
            executed += int(payload.get("executed_cells", 0))
            hits += int(payload.get("cache_hits", 0))
            devices.add(payload["device"])
        if len(devices) > 1:
            raise RuntimeError(
                f"study {study_id}: shards ran on different device types "
                f"{sorted(devices)}; one study's frame comes from one")
        device = devices.pop() if devices else None
        return results, executed, hits, errors, device

    def partial_result(self, study_id: str) -> Optional[StudyResult]:
        """Frame over the cells completed so far (rows in plan order),
        or None before the broker has ingested the study."""
        built = self._study(study_id)
        if built is None:
            return None
        study, plan = built
        results, executed, hits, _, device = self._collect(study_id)
        return study.assemble_frame(results, executed_cells=executed,
                                    cache_hits=hits, plan=plan,
                                    partial=True, device=device)

    def stream(self, study_id: str, *, poll: float = 0.2,
               timeout: float = 300.0) -> Iterator[StudyResult]:
        """Yield partial frames as their row count grows; the last yield
        is the complete frame. Raises on study error; a canceled study
        ends the stream after its final partial frame."""
        t0 = time.time()
        seen_rows = -1
        while True:
            state = self.status(study_id).get("state")
            frame = self.partial_result(study_id)
            if frame is not None and len(frame) > seen_rows:
                seen_rows = len(frame)
                yield frame
            if state == "error":
                raise RuntimeError(
                    f"study {study_id} failed: "
                    f"{self.status(study_id).get('error')}")
            if state in ("done", "canceled"):
                return
            if time.time() - t0 > timeout:
                raise TimeoutError(
                    f"study {study_id} still {state!r} after {timeout}s "
                    f"({seen_rows} rows streamed)")
            time.sleep(poll)

    def wait(self, study_id: str, *, poll: float = 0.1,
             timeout: float = 300.0) -> dict:
        """Block until the study reaches a final state; returns status."""
        t0 = time.time()
        while True:
            st = self.status(study_id)
            if st.get("state") in _FINAL:
                return st
            if time.time() - t0 > timeout:
                raise TimeoutError(f"study {study_id} still "
                                   f"{st.get('state')!r} after {timeout}s")
            time.sleep(poll)

    def result(self, study_id: str, *, poll: float = 0.1,
               timeout: float = 300.0) -> StudyResult:
        """Block for the final frame (bit-identical to a local
        `Study.run()` of the same plan). Raises RuntimeError on a failed
        or canceled study."""
        st = self.wait(study_id, poll=poll, timeout=timeout)
        if st.get("state") == "error":
            raise RuntimeError(f"study {study_id} failed: "
                               f"{st.get('error')}")
        if st.get("state") == "canceled":
            raise RuntimeError(f"study {study_id} was canceled")
        study, plan = self._study(study_id)
        results, executed, hits, errors, device = self._collect(study_id)
        if errors:
            raise RuntimeError(f"study {study_id} shard errors: "
                               + "; ".join(errors))
        return study.assemble_frame(results, executed_cells=executed,
                                    cache_hits=hits, plan=plan,
                                    device=device)
