"""End-to-end training on the PyTorch port (the twin of
`examples/train_lm.py`).

Trains a qwen2-family model on the synthetic pipeline with the full
substrate stack (AdamW + cosine, clipping, async checkpointing) from
random weights drawn from `--seed`, and verifies the loss decreases.
Defaults are the reference's (~20M params, 120 steps); pass --full for
the ~100M variant.

    PYTHONPATH=src python examples/torch_train_lm.py
    PYTHONPATH=src python examples/torch_train_lm.py --full --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.replay import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.models.zoo import ModelBundle, params_tree
from repro_torch.optim import cosine_schedule


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="~100M-param variant")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--seed", type=int, default=0,
                    help="the random weights' seed")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    base = get_config("qwen2-1.5b")
    if args.full:
        cfg = dataclasses.replace(base, layers=8, d_model=512, heads=8,
                                  kv_heads=2, d_ff=2048, vocab=32000,
                                  arch_id="qwen2-100m")
    else:
        cfg = dataclasses.replace(base, layers=4, d_model=256, heads=4,
                                  kv_heads=2, d_ff=1024, vocab=8192,
                                  arch_id="qwen2-20m")
    bundle = ModelBundle(cfg)
    print(f"model: {cfg.arch_id} ({bundle.param_count()/1e6:.1f}M params), "
          f"{args.steps} steps of {args.batch}x{args.seq}")

    model = bundle.init(torch.Generator(device=dev).manual_seed(args.seed))
    opt = bundle.opt_init(model)
    lr = cosine_schedule(args.lr, warmup=args.steps // 10, total=args.steps)
    step_fn = bundle.train_step(lr=lr)

    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                       global_batch=args.batch, seed=0))
    ckpt = CheckpointManager(args.ckpt_dir, keep_last=2)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.global_batch_at(step).items()}
        _, opt, m = step_fn(model, opt, batch)
        losses.append(float(m["loss"]))
        if step % 10 == 0:
            tok_s = args.batch * args.seq * (step + 1) / (time.time() - t0)
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"gnorm {float(m['grad_norm']):.2f} ({tok_s:.0f} tok/s)",
                  flush=True)
        if (step + 1) % 50 == 0:
            ckpt.save(step + 1, {"params": params_tree(model), "opt": opt})
    ckpt.save(args.steps, {"params": params_tree(model), "opt": opt},
              blocking=True)

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"\nloss: {first:.4f} -> {last:.4f} "
          f"({(first - last) / first * 100:.1f}% reduction)")
    if last >= first:
        print("ERROR: loss did not decrease", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
