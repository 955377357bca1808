"""Batched serving on the PyTorch port (the twin of
`examples/serve_batch.py`): prefill + decode of a SMOKE-sized model with
random weights drawn from `--seed`, with a co-simulation twist — every
served wave is ALSO fed to the simulation plane, reporting what the same
batch would cost on a modeled systolic accelerator.

    PYTHONPATH=src python examples/torch_serve_batch.py --arch qwen2-1.5b
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.api import Simulator
from repro_torch.configs import get_config
from repro_torch.core.replay import resolve_device
from repro_torch.models.params import torch_dtype
from repro_torch.models.zoo import ModelBundle


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--sim-array", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0,
                    help="the random weights' seed")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the simulation run (default "
                         "cuda; cpu runs the plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    bundle = ModelBundle(cfg)
    model = bundle.init(torch.Generator(device=dev).manual_seed(args.seed))
    B = args.batch
    max_len = args.prompt_len + args.gen_len

    prefill = bundle.prefill_step(None)
    decode = bundle.decode_step(None)

    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, min(cfg.vocab, 512), size=(B, args.prompt_len),
        dtype=np.int32)).to(dev)}
    dt = torch_dtype(cfg.param_dtype)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((B, args.prompt_len, cfg.d_model),
                                      dtype=dt, device=dev)
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros((B, cfg.frontend_tokens, cfg.d_model),
                                       dtype=dt, device=dev)

    t0 = time.time()
    logits, _ = prefill(model, batch)
    cache = bundle.init_cache(batch=B, cache_len=max_len, device=dev)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    outs = [tok]
    for i in range(args.gen_len - 1):
        logits, cache = decode(model, cache, tok, args.prompt_len + i)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        outs.append(tok)
    gen = torch.cat(outs, 1).cpu().numpy()
    wall = time.time() - t0
    print(f"served {B} seqs x {args.gen_len} tokens in {wall:.2f}s "
          f"({B * args.gen_len / wall:.1f} tok/s on {dev.type.upper()})")
    print("sample:", gen[0, :10].tolist())

    # co-simulation: cost of the same wave on modeled silicon
    full_cfg = get_config(args.arch)          # full-size arch for the model
    sim = Simulator.from_preset("tpu-like", array=args.sim_array, device=dev)
    rp = sim.run_lm(full_cfg, seq=args.prompt_len, batch=B, mode="prefill")
    rd = sim.run_lm(full_cfg, seq=args.prompt_len, batch=B, mode="decode",
                    cache_len=max_len)
    tot_cyc, tot_e = sim.wave_cost(rp, rd, args.gen_len)
    print(f"\nsimulated on {args.sim_array}x{args.sim_array} WS @1GHz "
          f"({full_cfg.arch_id} full size):")
    print(f"  prefill {rp.total_cycles:.3e} cyc; decode "
          f"{rd.total_cycles:.3e} cyc/step")
    print(f"  wave total: {tot_cyc/1e6:.1f} Mcycles = {tot_cyc/1e9*1000:.1f} ms, "
          f"{tot_e*1e-9:.1f} mJ, "
          f"{tot_e*1e-12/(B*args.gen_len)*1000:.3f} mJ/token")


if __name__ == "__main__":
    main()
