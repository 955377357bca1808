"""The readings that the end-to-end bounds are set from, for one cell.

    python3 simbench/spread.py --workload vit_base.trace64k \\
        --first-seed 2147483700 --runs 6 --out spread.json

Runs `simbench/run.py --trace 0` once a seed, each run a process of its
own as a check runs it: two sets of `--runs` seeds, the same seeds in
both, one set after the other, with `--seconds` (by default
`BENCHMARK.json`'s `run_seconds`). For each set and end-to-end metric
it gives the median and the quartile spread
(`statistics.quantiles(values, n=4)`, third less first quartile, as a
share of the median); for each metric the widest over the sets, five
times that rounded up to the next hundredth, never under 0.01, and the
trimmed spread that a bound must stay over twice: the mean over the
sets of the spread with each set's run farthest from its median left
out. Writes one JSON file and prints a summary. The benchmark's own
runs never run this.
"""
import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(statistics.median(values))


def trimmed(values) -> float:
    """The spread of `values` less the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def one_run(workload: str, seed: int, seconds: float) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "simbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=seconds + 600)
    wall = time.perf_counter() - t0
    row = dict(seed=seed, rc=p.returncode, wall_s=wall,
               stderr_tail=p.stderr[-1500:])
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        res = json.loads(lines[-1])
        row.update(correct=res["correct"], attempted=res["attempted"],
                   failed=res["failed"],
                   metrics={k: v["value"] for k, v in res["metrics"].items()})
    return row


def summarise(sets) -> dict:
    names = sorted({k for s in sets for r in s if "metrics" in r
                    for k in r["metrics"]})
    out = {}
    for name in names:
        per_set = []
        for s in sets:
            vals = [r["metrics"][name] for r in s if "metrics" in r]
            if len(vals) >= 3:
                per_set.append(dict(median=statistics.median(vals),
                                    spread=spread(vals),
                                    trimmed=trimmed(vals), n=len(vals)))
        widest = max((p["spread"] for p in per_set), default=None)
        out[name] = dict(sets=per_set, widest=widest, rule_bound=(
            None if widest is None
            else max(0.01, math.ceil(5 * widest * 100 - 1e-9) / 100)),
            trimmed=(statistics.mean(p["trimmed"] for p in per_set)
                     if per_set else None))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seconds = args.seconds
    if seconds is None:
        seconds = json.loads((ROOT / "BENCHMARK.json").read_text())[
            "run_seconds"]
    seeds = [args.first_seed + i for i in range(args.runs)]
    sets = []
    for label in "AB":
        rows = []
        for seed in seeds:
            row = one_run(args.workload, seed, seconds)
            row["set"] = label
            rows.append(row)
            print(json.dumps({x: row.get(x) for x in (
                "set", "seed", "rc", "correct", "metrics", "wall_s")}), flush=True)
        sets.append(rows)
    summary = summarise(sets)
    report = dict(workload=args.workload, seconds=seconds, seeds=seeds,
                  runs=[r for s in sets for r in s], summary=summary)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(dict(workload=args.workload, summary=summary)))
    bad = [r["seed"] for s in sets for r in s if not r.get("correct")]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
