"""Training launcher: the reference's fault-tolerant loop
(`repro/launch/train.py`) on one device.

Wires together the model zoo, the synthetic data pipeline, AdamW with
global-norm clipping and a cosine schedule, async and atomic
checkpointing with preemption handling, straggler detection, and
optional int8 gradient compression. Runs on the CUDA device unless
`--device cpu` is given. As in the reference, `--compress-pod-grads`
compresses each step's gradients afresh (no residual is carried), and a
preempted run saves the parameters after step `step` under the label
`step`, one behind the periodic save's `step + 1`, so a resumed run
replays one batch. `--tp` is clamped to the one device; no mesh is built
(ROADMAP 10c).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --smoke --device cpu --steps 50 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
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
    args = ap.parse_args(argv)

    from ..checkpoint import CheckpointManager, PreemptionHandler
    from ..configs import get_config
    from ..data.pipeline import DataConfig, SyntheticLMDataset
    from ..dist.straggler import StragglerDetector
    from ..models.zoo import ModelBundle, params_tree, value_and_grad
    from ..optim import (adamw_update, clip_by_global_norm,
                         compress_decompress, cosine_schedule)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    bundle = ModelBundle(cfg)
    args.tp = min(args.tp, 1)           # one device: no tensor parallelism

    if args.sim_accel:
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

    model = bundle.init(torch.Generator(device=device).manual_seed(args.seed))
    opt = bundle.opt_init(model)
    lr = cosine_schedule(args.lr, warmup=max(5, args.steps // 20),
                         total=args.steps)

    data = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                         global_batch=args.batch))
    ckpt = CheckpointManager(args.ckpt_dir, keep_last=2)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore({"params": params_tree(model), "opt": opt})
        params_tree(model, state["params"])
        opt = state["opt"]
        start = ckpt.latest_step()
        print(f"resumed from step {start}")

    def full_step(opt_state, batch):
        loss, grads = value_and_grad(model, batch)
        if args.compress_pod_grads:
            grads, _ = compress_decompress(grads)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        _, opt_state = adamw_update(grads, opt_state, params_tree(model),
                                    lr=lr)
        return opt_state, {"loss": loss, "grad_norm": gnorm}

    step = start
    pre = PreemptionHandler(lambda: ckpt.save(
        step, {"params": params_tree(model), "opt": opt}, blocking=True))
    det = StragglerDetector()
    dt_in = torch_dtype(cfg.param_dtype)

    losses = []
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
        dt = time.time() - t0
        det.record(0, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step}: loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s",
                  flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params_tree(model), "opt": opt})
        if pre.checkpoint_if_preempted():
            print("preempted: checkpoint saved, exiting cleanly")
            return 0
    ckpt.save(args.steps, {"params": params_tree(model), "opt": opt},
              blocking=True)
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    print(f"done. loss {first:.4f} -> {last:.4f} "
          f"({'DECREASED' if last < first else 'no improvement'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
