"""Run the four examples of the PyTorch port (`examples/torch_*.py`) one
after another on the default device (the card) and print each one's
exit code, wall seconds (host clock around the process) and output.

    PYTHONPATH=src python tools/run_examples.py [--out chiprun_out/examples.json]
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = (
    ["examples/torch_quickstart.py"],
    ["examples/torch_dse_sweep.py", "--arch", "qwen2-1.5b"],
    ["examples/torch_serve_batch.py", "--arch", "qwen2-1.5b"],
    ["examples/torch_train_lm.py"],
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the runs as JSON here")
    args = ap.parse_args(argv)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs, rc = [], 0
    with tempfile.TemporaryDirectory() as ck:
        for ex in EXAMPLES:
            cmd = [sys.executable, *ex]
            if ex[0].endswith("train_lm.py"):
                cmd += ["--ckpt-dir", ck]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                  text=True, timeout=900)
            wall = time.perf_counter() - t0
            runs.append(dict(cmd=" ".join(ex), rc=proc.returncode,
                             wall_s=wall, stdout=proc.stdout,
                             stderr=proc.stderr[-3000:]))
            print(f"== {' '.join(ex)}: rc {proc.returncode}, "
                  f"{wall:.3f} s wall", flush=True)
            print(proc.stdout, flush=True)
            if proc.returncode:
                print(proc.stderr[-3000:], flush=True)
                rc = 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
