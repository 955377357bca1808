"""Summarize a directory of the port's dry-run cells
(`python -m repro_torch.launch.dryrun --all --out DIR`): how many of the
reference's 66 cells are `ok`, which are missing, the dominant roofline
term per family and shape, how many fit in the card's HBM, and the host
seconds per cell.

    PYTHONPATH=src python tools/dryrun_summary.py DIR [--json OUT.json]
"""
import argparse
import collections
import glob
import json
import os
import sys


def summarize(directory: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import cell_list
    cells = {}
    for path in glob.glob(os.path.join(directory, "*__*__*.json")):
        with open(path) as f:
            c = json.load(f)
        if "arch" in c:
            cells[(c["arch"], c["shape"], c["mesh"])] = c
    want = cell_list()
    ok = [cells[k] for k in want if cells.get(k, {}).get("ok")]
    dominant = collections.defaultdict(collections.Counter)
    for c in ok:
        fam = get_config(c["arch"]).family
        dominant[f"{fam} {c['shape']}"][c["dominant"]] += 1
    host = sorted(((c["host_s"], f"{c['arch']}__{c['shape']}__{c['mesh']}")
                   for c in ok), reverse=True)
    return dict(
        cells=len(want), ok=len(ok),
        missing=[f"{a}__{s}__{m}" for a, s, m in want
                 if not cells.get((a, s, m), {}).get("ok")],
        fits_hbm=sum(bool(c["fits_hbm"]) for c in ok),
        dominant={k: dict(v) for k, v in sorted(dominant.items())},
        host_s_total=sum(h for h, _ in host),
        host_s_slowest=host[:8])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("directory")
    ap.add_argument("--json", help="also write the summary here")
    args = ap.parse_args(argv)
    s = summarize(args.directory)
    print(json.dumps(s, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(s, f, indent=1)
    return 0 if s["ok"] == s["cells"] else 1


if __name__ == "__main__":
    sys.exit(main())
