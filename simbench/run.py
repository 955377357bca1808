"""Run one benchmark cell once and print its result line.

    python3 simbench/run.py --workload vit_base.trace64k --seed 7 \\
        --seconds 30 --trace 0

Run from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each compared number beside its limit (also the last
lines of standard error). Without a card, with fewer cards than the cell
asks for, or when anything fails, it prints no result and exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_dirs()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from simbench.harness import cell as cellmod
    from simbench.harness.registry import Cell
    cell = Cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.BUILD_DIR = ROOT / "build" / "kernels"
    res = cellmod.run(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda",
                      t_start=T_START)
    bad = cellmod.forbidden_loaded()
    if bad:
        print(f"loaded in the measured process: {bad}", file=sys.stderr)
        return 1
    import json
    from simbench.harness.check import check_lines
    for line in check_lines(res["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 -- a failed run prints no result
        traceback.print_exc()
        code = 1
    sys.exit(code)
