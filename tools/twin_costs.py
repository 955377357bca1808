"""Time the CPU twins of `chip_smoke.py` one job at a time, in this
process, at a given number of intra-op threads.

    PYTHONPATH=src python tools/twin_costs.py [--threads 1] \
        [--only feature_sweep/] [--skip train_] [--out twin_costs.json]

`chip_smoke.py` runs these jobs in its twin pool (`submit_twins`: a
study as one job a batch group, in the order the phases join them). Here
each job runs alone, in order, and its seconds are printed as it ends;
the last line is one JSON object {job: seconds}, written to `--out` too.
`--only` keeps the jobs whose names start with one of its prefixes,
`--skip` drops them (the qwen2-1.5b float32 train step,
`train_qwen2_2layer_f32`, holds ~12 GB). Run it at 1, 2 and 4 threads to
see how a job's time falls with the threads it is given: the twins'
total is the cores' time, not one job's.
"""
import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


class JobList:
    """Records `submit_twins`' jobs in place of a `TwinPool`."""

    def __init__(self):
        self.jobs = []

    def submit(self, name, fn, *args):
        self.jobs.append((name, fn, args))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--only", default="",
                    help="comma-separated job name prefixes to keep")
    ap.add_argument("--skip", default="",
                    help="comma-separated job name prefixes to drop")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke
    torch.set_num_threads(args.threads)
    only = tuple(p for p in args.only.split(",") if p)
    skip = tuple(p for p in args.skip.split(",") if p)
    with tempfile.TemporaryDirectory() as build:
        jobs = JobList()
        chip_smoke.submit_twins(jobs, pathlib.Path(build))
        seconds = {}
        for name, fn, fargs in jobs.jobs:
            if (only and not name.startswith(only)) or \
                    (skip and name.startswith(skip)):
                continue
            t0 = time.perf_counter()
            fn(*fargs)
            seconds[name] = time.perf_counter() - t0
            print(f"{name}: {seconds[name]:.3f} s", flush=True)
    result = dict(threads=args.threads, cpu_count=len(os.sched_getaffinity(0)),
                  seconds=seconds, total_s=sum(seconds.values()))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
