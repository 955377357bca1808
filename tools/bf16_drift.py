"""How far a model's bfloat16 logits drift from the same weights in float32,
by depth, on one device and on a sharded world.

    PYTHONPATH=src python tools/bf16_drift.py [--arch mixtral-8x7b] \
        [--depths 1,2,4,8] [--batch 4] [--prompt 512] [--gen 8] \
        [--world-depths 2,8] [--world-f32-depths 2] [--f32-nudges 0] \
        [--device cuda] [--smoke] [--out chiprun_out/bf16_drift.json]

For each depth the model is drawn in float32 from seed 0
(`ModelBundle.init`: a depth's layers are the first layers of any deeper
draw), prefilled on `--batch` x `--prompt` synthetic tokens and decoded
`--gen` greedy tokens; the same weights cast to bfloat16 then run
teacher-forced on the float32 stream. Then a 2 x 2 (data, model) gloo
world of four processes on the same device (`chip_smoke.py`'s worlds)
runs the `--world-depths` in bfloat16 and the `--world-f32-depths` in
float32 on the serving shardings, teacher-forced on the same streams.
Each comparison is `chip_smoke.py::greedy_agreement` against the
one-device float32 run: the largest logit difference over the largest
float32 logit (prefill and decode steps; the prefill step alone too),
the greedy tokens equal, and the steps whose top-2 margin decides them.
A sharded bfloat16 run that is no further from float32 than one device's
bfloat16 run is rounding; one much further is a fault of the sharded
path. With `--f32-nudges n` each depth's float32 weights are also moved
one ulp at random (`chip_smoke.py::nudge`, n seeds) and run
teacher-forced: how far rounding alone moves float32 logits at that
depth (a route at a near tie flips). Prints one JSON object and writes it to `--out`. A full-width
mixtral-8x7b at 8 layers needs 46 GB for its float32 draw: run it on the
card (`--device cuda`); `--smoke` runs the SMOKE config on the CPU.
"""
import argparse
import dataclasses
import gc
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (decode_run, greedy_agreement, nudge,  # noqa
                        run_world, to_bf16)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset  # noqa
from repro_torch.models.zoo import ModelBundle  # noqa: E402


def agreement(got, ref, vocab):
    out = greedy_agreement(got, ref, vocab)
    pre = greedy_agreement(got[:1], ref[:1], vocab)
    return dict(logits_rel_err=out["logits_rel_err"],
                prefill_rel_err=pre["logits_rel_err"],
                row_rel_errs=out["row_rel_errs"],
                tokens_equal=out["tokens_equal"], tokens=out["tokens"],
                decided=out["decided"], ok_3e2=out["ok"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--depths", default="1,2,4,8")
    ap.add_argument("--world-depths", default="2,8")
    ap.add_argument("--world-f32-depths", default="2")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--f32-nudges", type=int, default=0,
                    help="also run each depth's float32 weights moved by "
                         "one ulp (`nudge`) this many times, seeds 0..n-1")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "bf16_drift.json"))
    a = ap.parse_args()
    t_all = time.perf_counter()
    dev = torch.device(a.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config(a.arch, smoke=a.smoke)
    toks = torch.from_numpy(SyntheticLMDataset(DataConfig(
        vocab=base.vocab, seq_len=a.prompt, global_batch=a.batch,
        seed=1)).global_batch_at(0)["tokens"]).to(dev)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    depths = ints(a.depths)
    wdepths, wf32 = ints(a.world_depths), ints(a.world_f32_depths)
    out = dict(arch=a.arch, smoke=a.smoke, batch=a.batch, prompt=a.prompt,
               gen=a.gen, device=str(dev), one_device={}, world_2x2={})
    refs = {}
    for d in sorted(set(depths) | set(wdepths) | set(wf32)):
        t0 = time.perf_counter()
        bundle = ModelBundle(dataclasses.replace(base, layers=d,
                                                 param_dtype="float32"))
        gen = (torch.Generator(device=dev) if dev.type == "cuda"
               else torch.Generator()).manual_seed(0)
        model = bundle.init(gen, device=dev)
        tokens, lg32 = decode_run(bundle, model, toks, a.gen)
        refs[d] = (tokens, lg32)
        if d in depths and a.f32_nudges:
            nudged = []
            for k in range(a.f32_nudges):
                if k:       # the weights drawn anew for each seed
                    del model
                    gc.collect()
                    model = bundle.init((torch.Generator(device=dev)
                                         if dev.type == "cuda" else
                                         torch.Generator()).manual_seed(0),
                                        device=dev)
                nudge(model, k)
                _, lgn = decode_run(bundle, model, toks, a.gen,
                                    force=tokens)
                nudged.append(agreement(lgn, lg32, base.vocab))
            out.setdefault("f32_nudged", {})[d] = nudged
            print(json.dumps({"f32_nudged": {d: nudged}}), flush=True)
            del model
            gc.collect()
            model = bundle.init((torch.Generator(device=dev)
                                 if dev.type == "cuda" else
                                 torch.Generator()).manual_seed(0),
                                device=dev)
        if d in depths:
            b16, m16 = to_bf16(model)
            del model
            _, lg16 = decode_run(b16, m16, toks, a.gen, force=tokens)
            del m16
            out["one_device"][d] = dict(
                agreement(lg16, lg32, base.vocab),
                seconds=time.perf_counter() - t0)
            print(json.dumps({"one_device": {d: out["one_device"][d]}}),
                  flush=True)
        else:
            del model
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    jobs = [dict(name=f"bf16_d{d}", arch=a.arch, layers=d, seed=0,
                 prefill=dict(B=a.batch, L=a.prompt, gen=a.gen,
                              force=refs[d][0]))
            for d in wdepths]
    jobs += [dict(name=f"f32_d{d}", arch=a.arch, layers=d, seed=0,
                  param_dtype="float32",
                  prefill=dict(B=a.batch, L=a.prompt, gen=a.gen,
                               force=refs[d][0]))
             for d in wf32]
    if jobs:
        if a.smoke:
            for j in jobs:
                j["smoke"] = True
        w = run_world("bf16_drift_2x2", dict(
            backend="gloo", device=dev.type, mesh=[2, 2], threads=2,
            jobs=jobs), nprocs=4, timeout=600)
        for j in jobs:
            d = j["layers"]
            _, arrays = w[j["name"]]
            out["world_2x2"][j["name"]] = agreement(arrays["logits"],
                                                    refs[d][1], base.vocab)
        out["world_seconds"] = w["_seconds"]
    out["seconds"] = time.perf_counter() - t_all
    pathlib.Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(a.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
