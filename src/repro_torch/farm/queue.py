"""File-spool job queue: the farm's lock-free, daemon-free transport.

Every message is one JSON file. The two primitives the whole farm rests
on are both single-syscall-atomic on POSIX:

  * **put** writes a private temp file, then `os.replace`s it into
    `pending/` — a consumer never observes a torn write;
  * **claim** `os.rename`s `pending/<item>` into `claimed/` — when N
    consumers race on one item, exactly one rename succeeds and the
    rest get `FileNotFoundError` and move on.

Delivery is **at-least-once**: a claimed item whose owner dies is moved
back to `pending/` once its lease expires (`requeue_stale`, driven by
the broker). Consumers must therefore be idempotent — farm workers are,
because simulation cells are deterministic and the shared dedup cache
absorbs re-execution.

Spool layout (per topic)::

    <root>/<topic>/tmp/       in-flight writes (never read)
    <root>/<topic>/pending/   claimable items, name-ordered
    <root>/<topic>/claimed/   leased items; claim time = file mtime

Item names are ``p{priority:04d}-{t_ns:020d}-{uid}`` so a plain sorted
directory listing *is* the schedule: lower priority value first, FIFO
within a priority class.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from ..faults import fs as _fs
from ..faults.retry import with_retries

__all__ = ["FarmDirs", "FileSpool", "JOBS_TOPIC", "QueueItem",
           "SHARDS_TOPIC", "read_json", "write_json_atomic"]

# the two spool topics: study submissions (client -> broker) and cell
# shards (broker -> workers)
JOBS_TOPIC = "jobs"
SHARDS_TOPIC = "shards"


def write_json_atomic(path: str, obj, *, site: str = "fs.write") -> None:
    """Temp-file + `os.replace` JSON write (readers see all or nothing),
    with bounded retries on transient `OSError`. `site` names the write
    for the fault-injection plane (`repro_torch.faults`) — a no-op unless a
    `FaultPlan` is active."""
    _fs.atomic_write_json(path, obj, site=site)


def read_json(path: str, default=None):
    """Tolerant JSON read: missing/corrupt/in-flight files -> default."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return default


@dataclasses.dataclass(frozen=True)
class QueueItem:
    """A claimed message: ack it (delete) when the work is durable."""
    item_id: str
    payload: dict
    path: str                 # current location (claimed/ file)
    owner: str


class FileSpool:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    # ---- layout -------------------------------------------------------------
    def _dirs(self, topic: str) -> Tuple[str, str, str]:
        base = os.path.join(self.root, topic)
        dirs = tuple(os.path.join(base, d)
                     for d in ("tmp", "pending", "claimed"))
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        return dirs

    @staticmethod
    def _safe(name: str) -> str:
        return "".join(c if (c.isalnum() or c in "-.") else "-"
                       for c in str(name))

    # ---- producer -------------------------------------------------------------
    def put(self, topic: str, payload: dict, *, priority: int = 100) -> str:
        """Enqueue one message; lower `priority` values are claimed
        first (FIFO within a priority class). Returns the item id.

        Hardened against transient I/O and torn staging writes: the
        staging file must parse back to JSON before it is renamed into
        `pending/` (a torn write would otherwise become a poison
        message, silently dropped by `claim` — a lost shard), and the
        whole write retries with backoff on `OSError`."""
        if not 0 <= int(priority) <= 9999:
            raise ValueError("priority must be in [0, 9999]")
        tmp, pending, _ = self._dirs(topic)
        item_id = (f"p{int(priority):04d}-{time.time_ns():020d}"
                   f"-{uuid.uuid4().hex[:8]}")
        staging = os.path.join(tmp, item_id + ".json")
        text = json.dumps(payload)

        def _write() -> None:
            _fs.crash_point("spool.put")
            try:
                _fs.write_text(staging, text, site="spool.put")
                with open(staging) as f:   # torn-write read-back check
                    json.load(f)
            except ValueError as e:
                raise OSError(f"torn staging write for {item_id}: {e}") \
                    from e
            _fs.replace(staging, os.path.join(pending, item_id + ".json"),
                        site="spool.put")

        try:
            # 9 attempts: a put must outlast a worst-case burst of
            # transient errors AND torn stagings back to back (the
            # chaos torn-writes schedule injects up to 6 in a row)
            with_retries(_write, retries=8)
        finally:
            if os.path.exists(staging):
                os.unlink(staging)
        return item_id

    # ---- consumer -------------------------------------------------------------
    def claim(self, topic: str, owner: str) -> Optional[QueueItem]:
        """Atomically claim the schedulable head of the queue (or None).

        The rename into `claimed/` is the mutual exclusion: concurrent
        claimants racing on one item see exactly one winner. The claimed
        file's mtime is reset to *now* — it is the lease clock that
        `requeue_stale` reads.
        """
        _, pending, claimed = self._dirs(topic)
        owner = self._safe(owner)
        for name in sorted(os.listdir(pending)):
            if not name.endswith(".json"):
                continue
            item_id = name[:-len(".json")]
            dst = os.path.join(claimed, f"{item_id}__{owner}.json")
            try:
                os.rename(os.path.join(pending, name), dst)
            except OSError:
                continue              # another claimant won this item
            os.utime(dst)             # lease starts now, not at put()
            payload = read_json(dst)
            if not isinstance(payload, dict):
                # poison message (torn, or valid JSON of the wrong
                # shape): drop it, keep going — never crash a consumer
                try:
                    os.unlink(dst)
                except OSError:
                    pass
                continue
            return QueueItem(item_id=item_id, payload=payload, path=dst,
                             owner=owner)
        return None

    def ack(self, item: QueueItem) -> None:
        """Delete a claimed item — the work it described is durable.
        A lost race against `requeue_stale` (file already moved back to
        pending) is fine: at-least-once delivery, idempotent consumers."""
        try:
            os.unlink(item.path)
        except OSError:
            pass

    # ---- broker-side maintenance ----------------------------------------------
    def stale_claims(self, topic: str, lease_seconds: float
                     ) -> List[Tuple[str, str, float, str]]:
        """[(item_id, owner, age, path)] for claimed items whose lease
        expired. Ages are measured against the *fault clock*
        (`faults.fs.now`), so an injected skew turns every claim stale
        at once — the lease-storm schedule. Read-only: the broker
        decides per item whether to requeue or quarantine."""
        _, _, claimed = self._dirs(topic)
        now = _fs.now("clock")
        out: List[Tuple[str, str, float, str]] = []
        for name in sorted(os.listdir(claimed)):
            if not name.endswith(".json") or "__" not in name:
                continue
            src = os.path.join(claimed, name)
            try:
                age = now - os.path.getmtime(src)
            except OSError:
                continue              # owner acked while we listed
            if age < lease_seconds:
                continue
            item_id, owner = name[:-len(".json")].split("__", 1)
            out.append((item_id, owner, age, src))
        return out

    def requeue(self, topic: str, item_id: str, path: str) -> bool:
        """Move one claimed item back to pending/ (its owner is presumed
        dead). False if it was acked or re-claimed under us."""
        _, pending, _ = self._dirs(topic)
        try:
            os.rename(path, os.path.join(pending, item_id + ".json"))
            return True
        except OSError:
            return False

    def requeue_stale(self, topic: str, lease_seconds: float) -> List[str]:
        """Move every claimed item older than the lease back to
        pending/. Returns the requeued item ids. (The broker uses the
        budgeted per-item path via `stale_claims`; this convenience
        wrapper is the unbudgeted whole-topic sweep.)"""
        out: List[str] = []
        for item_id, _owner, _age, path in self.stale_claims(
                topic, lease_seconds):
            if self.requeue(topic, item_id, path):
                out.append(item_id)
        return out

    def drop_pending(self, topic: str,
                     pred: Callable[[dict], bool]) -> int:
        """Remove pending items whose payload satisfies `pred`
        (cancellation). Items claimed mid-scan are simply skipped."""
        _, pending, _ = self._dirs(topic)
        dropped = 0
        for name in sorted(os.listdir(pending)):
            if not name.endswith(".json"):
                continue
            path = os.path.join(pending, name)
            payload = read_json(path)
            if payload is None or not pred(payload):
                continue
            try:
                os.unlink(path)
                dropped += 1
            except OSError:
                pass
        return dropped

    # ---- introspection ----------------------------------------------------------
    def depth(self, topic: str) -> int:
        _, pending, _ = self._dirs(topic)
        return sum(1 for n in os.listdir(pending) if n.endswith(".json"))

    def pending_ids(self, topic: str) -> List[str]:
        _, pending, _ = self._dirs(topic)
        return sorted(n[:-len(".json")] for n in os.listdir(pending)
                      if n.endswith(".json"))

    def claimed_items(self, topic: str) -> List[Tuple[str, str, float]]:
        """[(item_id, owner, lease_age_seconds)] for leased items."""
        _, _, claimed = self._dirs(topic)
        now = time.time()        # introspection only: the real clock
        out = []
        for name in sorted(os.listdir(claimed)):
            if not name.endswith(".json") or "__" not in name:
                continue
            item_id, owner = name[:-len(".json")].split("__", 1)
            try:
                age = now - os.path.getmtime(os.path.join(claimed, name))
            except OSError:
                continue
            out.append((item_id, owner, age))
        return out

    def stats(self, topic: str) -> Dict[str, int]:
        return {"pending": self.depth(topic),
                "claimed": len(self.claimed_items(topic))}


class FarmDirs:
    """The farm root's on-disk layout, shared by broker/worker/client.

    Everything outside the two spool topics is plain last-write-wins
    state written with `write_json_atomic`::

        <root>/studies/<sid>/spec.json     the submitted study spec
        <root>/studies/<sid>/manifest.json immutable shard->cells map
        <root>/studies/<sid>/status.json   broker-owned progress/state
        <root>/results/<sid>/shard-*.json  worker-written shard results
        <root>/control/<sid>.cancel        client cancellation requests
        <root>/workers/<wid>.json          worker heartbeats
        <root>/cache/                      fleet-shared dedup cell cache
                                           (Study._cache_* format)
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def study_dir(self, study_id: str) -> str:
        return os.path.join(self.root, "studies", FileSpool._safe(study_id))

    def spec_path(self, study_id: str) -> str:
        return os.path.join(self.study_dir(study_id), "spec.json")

    def status_path(self, study_id: str) -> str:
        return os.path.join(self.study_dir(study_id), "status.json")

    def manifest_path(self, study_id: str) -> str:
        """Immutable ingest-time record (shard -> cell indices, totals,
        priority): written once before any shard is claimable, it is
        what lets a broker rebuild a corrupt/missing `status.json` by
        re-folding shard results, re-enqueue lost or unreadable shards,
        and quarantine a shard into its exact failed cells."""
        return os.path.join(self.study_dir(study_id), "manifest.json")

    def results_dir(self, study_id: str) -> str:
        return os.path.join(self.root, "results",
                            FileSpool._safe(study_id))

    def shard_result_path(self, study_id: str, shard: int) -> str:
        return os.path.join(self.results_dir(study_id),
                            f"shard-{int(shard):05d}.json")

    def control_dir(self) -> str:
        return os.path.join(self.root, "control")

    def cancel_path(self, study_id: str) -> str:
        return os.path.join(self.control_dir(),
                            FileSpool._safe(study_id) + ".cancel")

    def workers_dir(self) -> str:
        return os.path.join(self.root, "workers")

    def worker_path(self, worker_id: str) -> str:
        return os.path.join(self.workers_dir(),
                            FileSpool._safe(worker_id) + ".json")

    def cache_dir(self) -> str:
        return os.path.join(self.root, "cache")

    def study_ids(self) -> List[str]:
        base = os.path.join(self.root, "studies")
        if not os.path.isdir(base):
            return []
        return sorted(os.listdir(base))
