"""Serving launcher: batched prefill + decode, wave by wave.

Requests arrive with prompts and are taken from the queue a batch at a
time; each wave is prefilled once, then decoded token by token (a short
wave is padded with all-zero prompts). As in the reference
(`repro/launch/serve.py`), the wave decodes against a fresh zero cache of
prompt_len + gen_len slots at positions prompt_len + i, not against the
prefill's cache. Runs on the CUDA device unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --smoke --device cpu --requests 8 --gen-len 16
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.replay import resolve_device
from ..models import decode as decode_mod
from ..models.params import torch_dtype


@dataclasses.dataclass
class ServeResult:
    waves: List[torch.Tensor]        # generated tokens per wave, (B, gen_len)
    done: int                        # requests served (non-padding prompts)
    tokens_out: int                  # tokens generated, padding rows included
    wall_s: float                    # whole loop, host clock
    prefill_ms: List[float]          # per wave
    decode_ms_per_token: List[float]  # per wave, over gen_len - 1 steps
    logits_finite: bool              # every prefill and decode logit finite

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s > 0 else 0.0


def make_prompts(cfg, *, requests: int, prompt_len: int, seed: int = 0
                 ) -> List[np.ndarray]:
    """The reference's prompts: ids in [1, min(vocab, 1000)) from
    `np.random.default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, min(cfg.vocab, 1000), size=prompt_len,
                         dtype=np.int32) for _ in range(requests)]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve_requests(model, prompts: Sequence[np.ndarray], *,
                   batch: int, gen_len: int, temperature: float = 0.0,
                   generator: Optional[torch.Generator] = None
                   ) -> ServeResult:
    """Serve `prompts` (equal-length int arrays) with `model` (a
    `LanguageModel`) on its device. The first token of a wave is the
    prefill's argmax; later ones are greedy at temperature 0 and drawn
    from `generator` (on the model's device) at temperature > 0."""
    cfg = model.cfg
    dev = model.device
    if temperature > 0 and generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator")
    B = batch
    prompt_len = len(prompts[0]) if len(prompts) else 0
    max_len = prompt_len + gen_len
    dt = torch_dtype(cfg.param_dtype)
    queue = list(prompts)
    requests = len(queue)
    done = tokens_out = 0
    waves, prefill_ms, decode_ms = [], [], []
    finite = torch.ones((), dtype=torch.bool, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    while queue or done < requests:
        wave = [queue.pop(0) for _ in range(min(B, len(queue)))]
        if not wave:
            break
        while len(wave) < B:                     # pad the batch
            wave.append(np.zeros(prompt_len, np.int32))
        inputs = {"tokens": torch.from_numpy(np.stack(wave)).to(dev)}
        if cfg.family == "audio":
            inputs["frames"] = torch.zeros((B, prompt_len, cfg.d_model),
                                           dtype=dt, device=dev)
        if cfg.family == "vlm":
            inputs["patches"] = torch.zeros(
                (B, cfg.frontend_tokens, cfg.d_model), dtype=dt, device=dev)
        tp = time.perf_counter()
        logits, _ = decode_mod.prefill(model, inputs)
        finite &= torch.isfinite(logits).all()
        # decode against a fresh fixed-size cache (the reference's loop
        # drops the prefill cache, sized to the prompt)
        cache = decode_mod.zeros_cache(
            decode_mod.cache_defs(cfg, B, max_len), dev)
        tok = torch.argmax(logits, -1)[:, None]
        _sync(dev)
        td = time.perf_counter()
        prefill_ms.append((td - tp) * 1e3)
        generated = [tok]
        for i in range(gen_len - 1):
            logits, cache = decode_mod.decode(model, cache, tok,
                                              prompt_len + i)
            finite &= torch.isfinite(logits).all()
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
            else:
                tok = torch.argmax(logits, -1)[:, None]
            generated.append(tok)
        out = torch.cat(generated, 1)
        _sync(dev)
        decode_ms.append((time.perf_counter() - td) * 1e3
                         / max(gen_len - 1, 1))
        done += len([w for w in wave if w.any()])
        tokens_out += int(out.numel())
        waves.append(out)
    wall = time.perf_counter() - t0
    return ServeResult(waves=waves, done=done, tokens_out=tokens_out,
                       wall_s=wall, prefill_ms=prefill_ms,
                       decode_ms_per_token=decode_ms,
                       logits_finite=bool(finite))


def sim_wave_cost(sim, full_cfg, *, prompt_len: int, batch: int,
                  gen_len: int):
    """Co-simulation: (prefill report, decode report, wave cycles, wave
    pJ) of one wave of the full-size architecture on `sim`'s accelerator."""
    pre = sim.run_lm(full_cfg, seq=prompt_len, batch=batch, mode="prefill")
    dec = sim.run_lm(full_cfg, seq=prompt_len, batch=batch, mode="decode",
                     cache_len=prompt_len + gen_len)
    cycles, pj = sim.wave_cost(pre, dec, gen_len)
    return pre, dec, cycles, pj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--sim-accel", default="",
                    help="accelerator preset (repro_torch.api): report the "
                         "modeled hardware cost of the served traffic")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda by default)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, prompts and sampling")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..models.zoo import ModelBundle

    device = resolve_device(args.device)
    sim = None
    if args.sim_accel:
        from ..api import Simulator
        sim = Simulator(args.sim_accel, device=device)   # fail fast

    cfg = get_config(args.arch, smoke=args.smoke)
    bundle = ModelBundle(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = bundle.init(gen)
    prompts = make_prompts(cfg, requests=args.requests,
                           prompt_len=args.prompt_len, seed=args.seed)
    res = serve_requests(model, prompts, batch=args.batch,
                         gen_len=args.gen_len, temperature=args.temperature,
                         generator=gen)
    if not res.logits_finite:
        raise SystemExit("serve: a logit is not finite")
    for out in res.waves:
        print(f"wave done: {out.shape[0]} seqs x {out.shape[1]} tokens; "
              f"sample: {out[0, :8].tolist()}", flush=True)
    print(f"served {res.done} requests, {res.tokens_out} tokens in "
          f"{res.wall_s:.2f}s ({res.tokens_per_s:.1f} tok/s) on "
          f"{device.type}")

    if sim is not None:
        # what the same traffic costs on modeled silicon (full-size arch,
        # not the smoke config)
        B = args.batch
        _, _, per_wave, e_wave = sim_wave_cost(
            sim, get_config(args.arch), prompt_len=args.prompt_len,
            batch=B, gen_len=args.gen_len)
        print(f"[sim:{args.sim_accel}] modeled wave: "
              f"{sim.seconds(per_wave) * 1e3:.2f} ms, "
              f"{e_wave * 1e-9:.1f} mJ "
              f"({e_wave * 1e-12 / max(B * args.gen_len, 1) * 1e3:.3f} "
              f"mJ/token)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
