"""Launch N processes of one program as a `torch.distributed` world on
this host (what `torchrun --standalone` does, with a file store).

  PYTHONPATH=src python -m repro_torch.launch.spawn --nprocs 4 -- \\
      -m repro_torch.launch.train --smoke --device cpu --tp 2 --steps 3

Each process gets RANK, WORLD_SIZE, LOCAL_RANK and INIT_METHOD (a
`file://` store in a fresh temporary directory) in its environment;
`world_from_env` reads them back. The launcher waits for all processes,
and when one fails it stops the others and exits with its code. Its own
output is the processes' output, unchanged.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional


def world_from_env() -> Optional[dict]:
    """{rank, world_size, init_method} of a process this launcher (or
    torchrun, through env://) started, None outside such a world."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    return {"rank": int(os.environ["RANK"]),
            "world_size": int(os.environ["WORLD_SIZE"]),
            "init_method": os.environ.get("INIT_METHOD", "env://")}


def run(nprocs: int, cmd: List[str], *, env: Optional[dict] = None,
        timeout_s: Optional[float] = None) -> int:
    """Run `python <cmd>` as `nprocs` processes of one world; returns 0,
    or the first failing process's exit code (the others are stopped)."""
    with tempfile.TemporaryDirectory(prefix="spawn_") as d:
        base = dict(os.environ if env is None else env)
        procs = []
        for r in range(nprocs):
            e = dict(base, RANK=str(r), LOCAL_RANK=str(r),
                     WORLD_SIZE=str(nprocs),
                     INIT_METHOD="file://" + os.path.join(d, "store"))
            procs.append(subprocess.Popen([sys.executable] + cmd, env=e))
        t0 = time.monotonic()
        rc = 0
        try:
            while procs:
                for p in list(procs):
                    code = p.poll()
                    if code is None:
                        continue
                    procs.remove(p)
                    if code != 0 and rc == 0:
                        rc = code
                if rc != 0:
                    break
                if timeout_s is not None and time.monotonic() - t0 > timeout_s:
                    rc = 124
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                p.kill()
                p.wait()
        return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- then the program's python arguments")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no program given")
    return run(args.nprocs, cmd, timeout_s=args.timeout)


if __name__ == "__main__":
    raise SystemExit(main())
