"""Training launcher: the reference's fault-tolerant loop
(`repro/launch/train.py`), on one device or sharded over a world of
processes.

Wires together the model zoo, the synthetic data pipeline, AdamW with
global-norm clipping and a cosine schedule, async and atomic
checkpointing with preemption handling, straggler detection, and
optional int8 gradient compression. Runs on the CUDA device unless
`--device cpu` is given. As in the reference, `--compress-pod-grads`
compresses each step's gradients afresh (no residual is carried), and a
preempted run saves the parameters after step `step` under the label
`step`, one behind the periodic save's `step + 1`, so a resumed run
replays one batch.

Launched as a world (`repro_torch.launch.spawn`, or torchrun's env://),
the processes build the reference's host mesh, (n / tp, tp) over
(data, model) with tp clamped to n, on the backend `--backend` names
(nccl on CUDA and gloo on the CPU unless given). Every process draws the
whole initial tree from `--seed` and keeps its blocks; each step's
global batch is read on every process and each keeps its dp rows; the
process of rank 0 alone prints and writes the checkpoints (gathered from
the blocks, the reference's format). Alone, `--tp` is clamped to the one
process, as the reference clamps it to its devices.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --smoke --device cpu --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.spawn --nprocs 4 -- \
      -m repro_torch.launch.train --smoke --device cpu --tp 2 --steps 3
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..core.replay import resolve_device
from ..models.params import torch_dtype


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--sim-accel", default="",
                    help="accelerator preset (repro_torch.api): report the "
                         "modeled per-step hardware cost before training")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda by default)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random initial weights")
    ap.add_argument("--backend", default="",
                    help="torch.distributed backend of a launched world "
                         "(default: nccl on cuda, gloo on the cpu)")
    ap.add_argument("--metrics", default="",
                    help="write each step's loss and gradient norm to this "
                         "JSON file (rank 0)")
    args = ap.parse_args(argv)

    from ..checkpoint import CheckpointManager, PreemptionHandler
    from ..configs import get_config
    from ..data.pipeline import DataConfig, SyntheticLMDataset
    from ..dist.straggler import StragglerDetector
    from ..dist.sharding import make_mesh_ctx
    from ..models.zoo import ModelBundle, params_tree, value_and_grad
    from ..optim import (adamw_update, clip_by_global_norm,
                         compress_decompress, cosine_schedule)
    from .mesh import make_host_mesh
    from .spawn import world_from_env

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    bundle = ModelBundle(cfg)
    world = world_from_env()
    ctx, rank = None, 0
    if world is not None:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
            torch.cuda.set_device(device)
        backend = args.backend or ("nccl" if device.type == "cuda"
                                   else "gloo")
        # a long timeout: rank 0 alone writes the checkpoints while the
        # others wait at a barrier
        mesh = make_host_mesh(tp=args.tp, backend=backend, timeout_s=1800,
                              device=device, **world)
        ctx = make_mesh_ctx(mesh) if mesh.size > 1 else None
        rank = mesh.rank
        if rank == 0:
            print(f"mesh {mesh.shape} on {backend}", flush=True)
    else:
        args.tp = min(args.tp, 1)       # one process: no tensor parallelism
    say = print if rank == 0 else (lambda *a, **k: None)

    if args.sim_accel and rank == 0:
        # co-simulation: the modeled cost of one train step of the
        # FULL-SIZE arch on the chosen accelerator preset
        from ..api import Simulator
        sim = Simulator(args.sim_accel, device=device)
        rep = sim.run_lm(get_config(args.arch), seq=args.seq,
                         batch=args.batch, mode="train")
        print(f"[sim:{args.sim_accel}] modeled train step: "
              f"{sim.seconds(rep.total_cycles) * 1e3:.2f} ms"
              f", {rep.energy_pj * 1e-9:.1f} mJ, "
              f"util={rep.utilization:.2f}", flush=True)

    model = bundle.init(torch.Generator(device=device).manual_seed(args.seed),
                        ctx)
    opt = bundle.opt_init(model)
    ck_sh = None                        # a sharded checkpoint's placements
    if ctx is not None:
        sh = bundle.opt_shardings(ctx)
        ck_sh = {"params": sh.m, "opt": sh}
    lr = cosine_schedule(args.lr, warmup=max(5, args.steps // 20),
                         total=args.steps)

    data = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                         global_batch=args.batch))
    ckpt = CheckpointManager(args.ckpt_dir, keep_last=2)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore({"params": params_tree(model), "opt": opt},
                             shardings=ck_sh)
        params_tree(model, state["params"])
        opt = state["opt"]
        start = ckpt.latest_step()
        say(f"resumed from step {start}")

    def full_step(opt_state, batch):
        loss, grads = value_and_grad(model, batch, ctx=ctx)
        if args.compress_pod_grads:
            grads, _ = compress_decompress(grads, specs=model.specs,
                                           mesh=model.mesh)
        grads, gnorm = clip_by_global_norm(grads, 1.0, model.specs,
                                           model.mesh)
        _, opt_state = adamw_update(grads, opt_state, params_tree(model),
                                    lr=lr)
        return opt_state, {"loss": loss, "grad_norm": gnorm}

    step = start
    pre = PreemptionHandler(lambda: ckpt.save(
        step, {"params": params_tree(model), "opt": opt}, blocking=True,
        shardings=ck_sh))
    det = StragglerDetector()
    dt_in = torch_dtype(cfg.param_dtype)

    losses, gnorms = [], []
    for step in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.global_batch_at(step).items()}
        if cfg.family == "audio":
            batch["frames"] = torch.zeros((args.batch, args.seq, cfg.d_model),
                                          dtype=dt_in, device=device)
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros(
                (args.batch, cfg.frontend_tokens, cfg.d_model), dtype=dt_in,
                device=device)
        opt, metrics = full_step(opt, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        dt = time.time() - t0
        det.record(rank, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step}: loss={losses[-1]:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s",
                flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params_tree(model), "opt": opt},
                      shardings=ck_sh)
        if pre.checkpoint_if_preempted():
            say("preempted: checkpoint saved, exiting cleanly")
            return 0
    ckpt.save(args.steps, {"params": params_tree(model), "opt": opt},
              blocking=True, shardings=ck_sh)
    if args.metrics and rank == 0:
        with open(args.metrics, "w") as f:
            json.dump({"losses": losses, "grad_norms": gnorms}, f)
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    say(f"done. loss {first:.4f} -> {last:.4f} "
        f"({'DECREASED' if last < first else 'no improvement'})")
    if world is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
