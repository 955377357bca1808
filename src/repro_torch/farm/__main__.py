"""`python -m repro_torch.farm`: the run-farm CLI of the PyTorch port.
Workers, the smoke and the chaos soak run on `--device` (default cuda,
which raises without a card; `--device cpu` runs the kernels' plain
versions).

    # one broker, one worker per card, then submit studies:
    PYTHONPATH=src python -m repro_torch.farm serve  --root farm &
    PYTHONPATH=src python -m repro_torch.farm worker --root farm \
        --device cuda:0 &
    # or one worker over every card of the host, each batched group's
    # designs split over the cards (slower: every block repeats the
    # group's host-bound dispatch; 4.5x one card's wall on four H100s,
    # PERF.md; one worker a card is the fast layout, and the mesh is
    # the reference's `worker --mesh`):
    PYTHONPATH=src python -m repro_torch.farm worker --root farm --mesh &
    PYTHONPATH=src python -m repro_torch.farm submit \
        studies.edp_array_size --root farm --smoke --wait --csv FRAME.csv

    PYTHONPATH=src python -m repro_torch.farm status --root farm [STUDY_ID]
    PYTHONPATH=src python -m repro_torch.farm cancel --root farm STUDY_ID

    # self-contained end-to-end pass (CI): broker thread + N worker
    # subprocesses + one submission, gated on the study's claims
    PYTHONPATH=src python -m repro_torch.farm smoke --root /tmp/farm \
        --workers 2 --study edp_array_size --smoke --device cpu \
        --metrics FARM_metrics.json [--compare-local]

    # chaos soak: the three fault schedules, bit-identity gated
    PYTHONPATH=src python -m repro_torch.farm chaos --root /tmp/chaos \
        --smoke --device cpu
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import threading
import time
from typing import Optional, Sequence

from .broker import Broker
from .client import FarmClient
from .queue import write_json_atomic
from .worker import Worker


def _study_kwargs(name: str, smoke: bool) -> dict:
    from ..api.study import _STUDIES
    factory = _STUDIES.get(name)
    kw = {}
    if smoke and factory is not None \
            and "smoke" in inspect.signature(factory).parameters:
        kw["smoke"] = True
    return kw


def _build_study(name: str, smoke: bool):
    from ..api.study import get_study
    name = name[len("studies."):] if name.startswith("studies.") else name
    return get_study(name, **_study_kwargs(name, smoke))


# ---- subcommands ------------------------------------------------------------

def _cmd_serve(args) -> int:
    broker = Broker(args.root, lease_seconds=args.lease,
                    max_shard_cells=args.max_shard_cells)
    print(f"farm broker serving root={broker.dirs.root} "
          f"(lease={args.lease}s, poll={args.poll}s)", flush=True)
    broker.serve(poll=args.poll,
                 max_steps=1 if args.once else None,
                 metrics_path=args.metrics)
    return 0


def _cmd_worker(args) -> int:
    worker = Worker(args.root, args.id, device=args.device,
                    use_mesh=args.mesh,
                    cache=None if args.no_cache else "auto")
    where = (f"a mesh {worker.mesh_shape} of {worker.device.type}"
             if args.mesh else str(worker.device))
    print(f"farm worker {worker.worker_id} serving "
          f"root={worker.dirs.root} on {where}", flush=True)
    if args.once:
        worker.step()
    else:
        worker.serve(poll=args.poll, idle_exit=args.idle_exit)
    print(f"farm worker {worker.worker_id} exiting: "
          f"{worker.shards_done} shards, {worker.cells_done} cells "
          f"({worker.cache_hits} cache hits)", flush=True)
    return 0


def _cmd_submit(args) -> int:
    study = _build_study(args.study, args.smoke)
    client = FarmClient(args.root)
    sid = client.submit(study, priority=args.priority)
    print(f"submitted {sid} (priority {args.priority})")
    if not args.wait:
        return 0
    last = 0
    res = None
    for frame in client.stream(sid, timeout=args.timeout):
        if len(frame) > last:
            print(f"  {len(frame)} cells complete", flush=True)
            last = len(frame)
        res = frame
    st = client.status(sid)
    if st.get("state") != "done":
        print(f"study ended {st.get('state')!r}")
        return 1
    res = client.result(sid, timeout=args.timeout)
    print(f"study {sid}: done, executed {res.executed_cells} cells "
          f"({res.cache_hits} cache hits)")
    print(res.summary())
    if args.csv:
        res.to_csv(args.csv)
        print(f"wrote {args.csv}")
    claims = res.check_claims()
    for name, ok in claims.items():
        print(f"claim {'PASS' if ok else 'FAIL'}: {name}")
    return 0 if all(claims.values()) else 1


def _cmd_status(args) -> int:
    client = FarmClient(args.root)
    if args.study_id:
        print(json.dumps(client.status(args.study_id), indent=1))
    else:
        studies = client.list_studies()
        if not studies:
            print("no studies submitted")
        for sid, state in studies.items():
            print(f"{state:>9}  {sid}")
    return 0


def _cmd_cancel(args) -> int:
    FarmClient(args.root).cancel(args.study_id)
    print(f"cancel requested for {args.study_id}")
    return 0


def _cmd_smoke(args) -> int:
    """End-to-end farm pass: broker thread + N worker subprocesses,
    one named-study submission once every worker has sent a heartbeat
    (so the broker sizes shards for the whole fleet), claims gating the
    exit code, and the broker's per-worker metrics written as a JSON
    artifact with the pass's own numbers under "smoke". With
    `--compare-local` the study also runs locally on `--device` first,
    and the farm frame must equal that run bit for bit. Each worker is
    its own process (fork + exec, so none inherits a CUDA context),
    inheriting the environment with this package's directory put first
    on `PYTHONPATH`."""
    import numpy as np

    import repro_torch

    root = args.root
    study = _build_study(args.study, args.smoke)
    local = study.run(device=args.device) if args.compare_local else None
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    stop = threading.Event()
    broker = Broker(root, lease_seconds=args.lease,
                    max_shard_cells=args.max_shard_cells)
    thread = threading.Thread(
        target=broker.serve, kwargs=dict(poll=0.1, stop_event=stop),
        daemon=True)
    thread.start()
    t_spawn = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.farm", "worker", "--root",
         root, "--id", f"smoke-w{i}", "--poll", "0.1",
         "--idle-exit", str(args.timeout), "--device", args.device],
        env=env) for i in range(args.workers)]
    rc, info = 1, {}
    try:
        while len(broker.active_workers()) < args.workers:
            if time.time() - t_spawn > args.timeout or any(
                    p.poll() is not None for p in procs):
                print(f"smoke: {len(broker.active_workers())} of "
                      f"{args.workers} workers came up")
                return 1
            time.sleep(0.1)
        info["workers_start_s"] = time.time() - t_spawn
        client = FarmClient(root)
        t0 = time.time()
        sid = client.submit(study)
        print(f"smoke: submitted {sid} to {args.workers} workers")
        res = client.result(sid, timeout=args.timeout)
        dt = time.time() - t0
        claims = res.check_claims()
        print(f"smoke: {len(res)} cells in {dt:.1f}s "
              f"(executed {res.executed_cells}, "
              f"{res.cache_hits} cache hits)")
        for name, ok in claims.items():
            print(f"claim {'PASS' if ok else 'FAIL'}: {name}")
        ok = bool(claims) and all(claims.values())
        info.update(seconds=dt, cells=len(res),
                    shards=client.status(sid).get("shards_total"),
                    claims=claims, engine=res.meta.get("engine"),
                    device=res.meta.get("device"))
        if local is not None:
            bad = [c for c in local.columns
                   if not np.array_equal(local.columns[c],
                                         res.columns.get(c, np.array([])))]
            same = res.equals(local) and not bad
            print(f"smoke: bit_identical={same} with the local run"
                  f"{f' (columns {bad} differ)' if bad else ''}")
            info.update(bit_identical=same, mismatched_columns=bad)
            ok = ok and same
        rc = 0 if ok else 1
    finally:
        stop.set()
        thread.join(timeout=10)
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        metrics = dict(broker.metrics(), smoke=info)
        write_json_atomic(args.metrics, metrics)
        print(f"smoke: wrote {args.metrics} "
              f"(queue_depth={metrics['queue_depth']}, "
              f"requeued={metrics['requeued_shards']})")
    return rc


def _cmd_chaos(args) -> int:
    """CI chaos soak: run one study through the farm under each seeded
    fault schedule and require (a) termination, (b) a frame whose every
    column is bit-identical to a fault-free local `Study.run()`, and
    (c) the study's claims. One process, synchronous deterministic
    driver: the broker and an N-worker pool are stepped round-robin, an
    `InjectedCrash` kills a worker mid-protocol and a fresh one is
    spawned (exactly what a process kill + respawn does, minus the
    fork cost and flakiness). Real fleets get the same schedules via
    the REPRO_FAULTS env var (see repro_torch.faults). The reference run,
    the workers and the reassembly all run on `--device`."""
    import numpy as np

    from ..faults import CHAOS_SCHEDULES, InjectedCrash, chaos_schedule

    names = args.schedules or sorted(CHAOS_SCHEDULES)
    study = _build_study(args.study, args.smoke)
    print(f"chaos: fault-free reference run of {args.study}"
          f"{' --smoke' if args.smoke else ''} on {args.device}", flush=True)
    ref = study.run(device=args.device)

    report, ok_all = {}, True
    for name in names:
        plan = chaos_schedule(name, args.seed)
        root = os.path.join(args.root, name)
        t0 = time.time()
        kills = rounds = 0
        res = None
        with plan.active():
            # short lease so crashed claims re-deliver within the soak;
            # a raised attempts budget keeps bounded injection bursts
            # from quarantining healthy shards (quarantine semantics
            # have their own unit tests)
            broker = Broker(root, lease_seconds=0.2, max_shard_cells=2,
                            max_shard_attempts=8)
            client = FarmClient(root)
            workers = [Worker(root, f"chaos-w{i}", device=args.device)
                       for i in range(args.workers)]
            sid = client.submit(study)
            state = "running"
            while time.time() - t0 < args.timeout:
                rounds += 1
                broker.step()
                for i, w in enumerate(workers):
                    try:
                        while w.step():
                            pass
                    except InjectedCrash:
                        kills += 1           # respawn, like a supervisor
                        workers[i] = Worker(root, f"chaos-w{i}r{kills}",
                                            device=args.device)
                    except OSError:
                        pass                 # injected I/O at claim time
                state = client.status(sid).get("state")
                if state in ("done", "canceled", "error"):
                    break
                time.sleep(0.02)             # age the short leases
            broker.step()                    # final fold
            state = client.status(sid).get("state")
            if state == "done":
                res = client.result(sid, timeout=30)
        m = broker.metrics()
        bad_cols = ([] if res is None else
                    [c for c in ref.columns
                     if not np.array_equal(ref.columns[c],
                                           res.columns.get(
                                               c, np.array([])))])
        claims = res.check_claims() if res is not None else {}
        entry = {
            "ok": state == "done",
            "bit_identical": res is not None and res.equals(ref)
            and not bad_cols,
            "claims_ok": bool(claims) and all(claims.values()),
            "state": state, "seconds": round(time.time() - t0, 2),
            "rounds": rounds, "worker_kills": kills,
            "requeued_shards": m["requeued_shards"],
            "quarantined_shards": m["quarantined_shards"],
            "mismatched_columns": bad_cols,
            "faults": plan.report(),
        }
        report[name] = entry
        good = (entry["ok"] and entry["bit_identical"]
                and entry["claims_ok"])
        ok_all = ok_all and good
        print(f"chaos[{name}]: {'PASS' if good else 'FAIL'} "
              f"state={state} kills={kills} "
              f"requeued={entry['requeued_shards']} "
              f"injected={entry['faults']['total_injected']} "
              f"bit_identical={entry['bit_identical']} "
              f"({entry['seconds']}s)", flush=True)
    write_json_atomic(args.report, report)
    print(f"chaos: wrote {args.report}; "
          f"{'all schedules PASS' if ok_all else 'FAILURES above'}")
    return 0 if ok_all else 1


# ---- argument plumbing --------------------------------------------------------

def _main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.farm",
        description="Study run-farm: broker, workers, submissions")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--root", default=os.environ.get("FARM_ROOT",
                                                        "farm"),
                       help="farm root directory (spool + state + cache)")

    def device(p):
        p.add_argument("--device", default="cuda",
                       help="where cells run (default cuda, e.g. cuda:1; "
                            "cpu runs the kernels' plain versions)")

    p = sub.add_parser("serve", help="run the broker")
    common(p)
    p.add_argument("--poll", type=float, default=0.5)
    p.add_argument("--lease", type=float, default=120.0,
                   help="seconds before a claimed shard is re-queued")
    p.add_argument("--max-shard-cells", type=int, default=8)
    p.add_argument("--once", action="store_true",
                   help="one scheduling pass, then exit")
    p.add_argument("--metrics", default=None,
                   help="write broker metrics JSON here every pass")
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("worker", help="run one worker")
    common(p)
    p.add_argument("--id", default=None, help="worker id (default: pid)")
    p.add_argument("--poll", type=float, default=0.2)
    p.add_argument("--idle-exit", type=float, default=None,
                   help="exit after this many idle seconds")
    device(p)
    p.add_argument("--mesh", action="store_true",
                   help="shard batched groups over a mesh of this "
                        "process's devices (every card; the one CPU with "
                        "--device cpu)")
    p.add_argument("--no-cache", action="store_true",
                   help="skip the shared dedup cache (bench cold runs)")
    p.add_argument("--once", action="store_true")
    p.set_defaults(fn=_cmd_worker)

    p = sub.add_parser("submit", help="submit a named study")
    common(p)
    p.add_argument("study",
                   help="registry study, e.g. studies.edp_array_size")
    p.add_argument("--smoke", action="store_true",
                   help="shrink the study where the factory supports it")
    p.add_argument("--priority", type=int, default=100,
                   help="lower = scheduled first")
    p.add_argument("--wait", action="store_true",
                   help="stream until done; exit code gates the claims")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--csv", help="write the final frame as CSV")
    p.set_defaults(fn=_cmd_submit)

    p = sub.add_parser("status", help="show study states")
    common(p)
    p.add_argument("study_id", nargs="?", default=None)
    p.set_defaults(fn=_cmd_status)

    p = sub.add_parser("cancel", help="cancel a study")
    common(p)
    p.add_argument("study_id")
    p.set_defaults(fn=_cmd_cancel)

    p = sub.add_parser("smoke",
                       help="self-contained broker+workers+submit pass")
    common(p)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--study", default="edp_array_size")
    p.add_argument("--smoke", action="store_true",
                   help="use the study factory's smoke variant")
    p.add_argument("--timeout", type=float, default=480.0)
    p.add_argument("--lease", type=float, default=120.0)
    p.add_argument("--max-shard-cells", type=int, default=2,
                   help="small shards so every worker sees work")
    p.add_argument("--metrics", default="FARM_metrics.json")
    p.add_argument("--compare-local", action="store_true",
                   help="also run the study locally on --device and "
                        "require the farm frame to equal it bit for bit")
    device(p)
    p.set_defaults(fn=_cmd_smoke)

    p = sub.add_parser(
        "chaos",
        help="CI chaos soak: seeded fault schedules, bit-identity gated")
    common(p)
    p.add_argument("--study", default="edp_array_size")
    p.add_argument("--smoke", action="store_true",
                   help="use the study factory's smoke variant")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timeout", type=float, default=300.0,
                   help="per-schedule wall ceiling (seconds)")
    p.add_argument("--schedules", nargs="*", default=None,
                   help="subset of schedules (default: all three)")
    p.add_argument("--report", default="FAULTS_report.json")
    device(p)
    p.set_defaults(fn=_cmd_chaos)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(_main())
