"""The readings that `correct`'s limits are set from, for one cell, in one
process on the card.

    python3 simbench/limits.py --workload vit_base.trace64k \\
        --first-seed 5000 --seeds 12 --control-seeds 3

Lower readings: for each of `--seeds` seeds, one cycle of the run's
design samples through the program, exactly as a run's window drives it,
each column's widest gap to the float32 reference. Upper readings: the
control, the same reference computed in bfloat16 (the precision below
the float32 the sweep states) put in the program's place, on
`--control-seeds` seeds, each column's widest gap over the seed's
samples. Prints one JSON line. The benchmark's own runs never run this.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from simbench.harness import cell as cm
    from simbench.harness import check, designs as dz
    from simbench.harness.registry import Cell
    from simbench.reference import sim
    cell = Cell(args.workload, ROOT)
    if args.device == "cuda":
        from repro_torch.kernels import _build
        _build.BUILD_DIR = ROOT / "build" / "kernels"
    mix = cell.mix
    seeds = [args.first_seed + i for i in range(args.seeds)]
    runs = {}
    t0 = time.perf_counter()
    for seed in seeds:
        samples = dz.samples(mix, seed)
        prog = cm.Program(cell, samples, args.device)
        runs[seed] = (samples, [prog.run_pass(k)
                                for k in range(len(samples))])
        del prog
    t1 = time.perf_counter()
    union = [d for s in runs[seeds[0]][0] for d in s]
    kw = dict(spec=mix["trace_spec"], dram=mix["dram"], device=args.device)
    ref = sim.reference_frame(union, cell.config["ops"], **kw)
    t2 = time.perf_counter()
    lower = {}
    for seed, (samples, frames) in runs.items():
        keys = {dz.label(d): sim.design_key(d) for s in samples for d in s}
        checks, _, rows = check.compare(frames, keys, ref, {})
        lower[seed] = {c: v["gap"] for c, v in checks.items()}
    control = {}
    ctl_s = []
    for seed in seeds[:args.control_seeds]:
        samples = runs[seed][0]
        c0 = time.perf_counter()
        ctl = sim.reference_frame([d for s in samples for d in s],
                                  cell.config["ops"], dtype=torch.bfloat16,
                                  **kw)
        ctl_s.append(time.perf_counter() - c0)
        frames = [check.frame_of(ctl, s) for s in samples]
        keys = {dz.label(d): sim.design_key(d) for s in samples for d in s}
        checks, _, _ = check.compare(frames, keys, ref, {})
        control[seed] = {c: v["gap"] for c, v in checks.items()}
    cols = list(sim.METRIC_COLUMNS)
    out = dict(
        workload=cell.name, seeds=seeds,
        program_s=t1 - t0, reference_s=t2 - t1, control_s=ctl_s,
        lower={c: max(lower[s][c] for s in lower) for c in cols},
        upper={c: min(control[s][c] for s in control) for c in cols},
        lower_by_seed=lower, control_by_seed=control)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
