"""How far rounding alone moves the losses and gradient norms of a few
train steps on one device: `chip_smoke.py` phase 39's training check
(mixtral-8x7b at full width, `TRAIN_LAYERS` layers, `TRAIN_STEPS` steps
of `TRAIN_B` x `TRAIN_L` tokens, seed 0, in `--dtype`) run as phase
39's one-card reference runs it, then again under perturbations of
rounding's size.

    PYTHONPATH=src python tools/train_drift.py [--nudges 3] \
        [--dtype bfloat16|float32] [--device cuda] [--smoke] \
        [--out chiprun_out/train_drift.json]

The runs: `baseline`; `repeat` (the same again: what the card's atomics
leave to chance); `deterministic` (`torch.use_deterministic_algorithms`);
`no_reduced_reduction` (cuBLAS's bfloat16 products without reduced-
precision reductions); and `nudge_k` for k < `--nudges` (every weight
moved one ulp of its dtype up or down, a coin a weight from seed k: in
float32 by `chip_smoke.nudge`, the rule of phase 39's envelope). Each
run's losses and gradient norms, the relative gap of each to the
baseline's at each step (|a - b| / |b|, as phase 39 measures a world
against one card), their largest, and the envelope: at each step the
nudged runs' largest gap. Prints one JSON object and writes it
to `--out`. `--smoke` runs the SMOKE config (on the CPU with
`--device cpu`).
"""
import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def nudge_bf16(model, seed: int) -> None:
    """Move every bfloat16 weight one ulp up or down in magnitude (a coin
    a weight, from `seed`); a zero moves up."""
    import torch

    from repro_torch.models import params as pm
    for i, t in enumerate(pm.tree_leaves(model.tree)):
        if t.dtype != torch.bfloat16:
            continue
        g = torch.Generator(device=t.device).manual_seed(seed * 1000 + i)
        bits = t.view(torch.int16)
        up = (torch.rand(bits.shape, generator=g, device=t.device) < 0.5) \
            | ((bits & 0x7FFF) == 0)
        bits.add_(torch.where(up, 1, -1).to(torch.int16))


def train_run(cfg, dev, variant: str) -> dict:
    """Phase 39's one-card training: TRAIN_STEPS steps from seed 0."""
    import torch

    import chip_smoke as cs
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.models.zoo import ModelBundle
    from repro_torch.optim import cosine_schedule
    bundle = ModelBundle(cfg)
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    if variant.startswith("nudge_"):
        k = int(variant.split("_")[1])
        if cfg.param_dtype == "float32":
            cs.nudge(model, k)
        else:
            nudge_bf16(model, k)
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=cs.TRAIN_L,
                                       global_batch=cs.TRAIN_B, seed=0))
    step = bundle.train_step(lr=cosine_schedule(3e-4, 1, cs.TRAIN_STEPS))
    opt = bundle.opt_init(model)
    losses, gnorms = [], []
    ctx = contextlib.nullcontext()
    if variant == "deterministic":
        ctx = deterministic()
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = \
        variant != "no_reduced_reduction" and reduced
    try:
        with ctx:
            for i in range(cs.TRAIN_STEPS):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in ds.global_batch_at(i).items()}
                _, opt, m = step(model, opt, batch)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
    return dict(losses=losses, grad_norms=gnorms)


@contextlib.contextmanager
def deterministic():
    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nudges", type=int, default=3)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(cs.MIX_ARCH, smoke=args.smoke),
                              layers=cs.TRAIN_LAYERS, param_dtype=args.dtype)
    variants = ["baseline", "repeat", "deterministic",
                "no_reduced_reduction"] + [f"nudge_{k}"
                                           for k in range(args.nudges)]
    runs = {}
    for v in variants:
        t0 = time.perf_counter()
        runs[v] = train_run(cfg, dev, v)
        base = runs["baseline"]
        for key in ("losses", "grad_norms"):
            gaps = [abs(a - b) / abs(b)
                    for a, b in zip(runs[v][key], base[key])]
            runs[v][f"{key}_rel_gaps"] = gaps
            runs[v][f"{key}_rel_gap"] = max(gaps)
        runs[v]["seconds"] = time.perf_counter() - t0
        print(v, json.dumps(runs[v]), flush=True)
    out = dict(arch=cfg.name if hasattr(cfg, "name") else cs.MIX_ARCH,
               layers=cfg.layers, dtype=cfg.param_dtype, batch=cs.TRAIN_B,
               seq=cs.TRAIN_L, steps=cs.TRAIN_STEPS, device=str(dev),
               device_name=(torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
               runs=runs,
               largest_grad_norm_gap=max(r["grad_norms_rel_gap"]
                                         for r in runs.values()),
               largest_loss_gap=max(r["losses_rel_gap"]
                                    for r in runs.values()),
               envelope={key: [max((runs[v][f"{key}_rel_gaps"][s]
                                    for v in variants
                                    if v.startswith("nudge_")), default=0.0)
                               for s in range(cs.TRAIN_STEPS)]
                         for key in ("losses", "grad_norms")})
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
