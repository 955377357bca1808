"""The PyTorch port's serving path against the JAX reference:
`serve_requests` at smoke size against the reference's serve loop driven
through `repro`'s ModelBundle here (the same prompts, the reference's
weights carried across, float32: the same greedy tokens); the synthetic
data pipeline bit for bit; the batch specs; the co-simulated wave cost
against the reference's `Simulator`; `python -m repro_torch.launch.serve`
as a subprocess on the CPU (its lines equal to the reference's where they
must be); the entry point raising without a card; and no jax or `repro`
module loaded by the port's workload plane."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as rapi
from repro.configs import get_config as rget
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLMDataset as RDataset
from repro.data.pipeline import make_batch_specs as rspecs
from repro.models.zoo import ModelBundle as RBundle
import repro_torch as rt
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.launch import serve as tserve
from repro_torch.models.params import params_from_reference
from repro_torch.models.zoo import get_bundle

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir,
                                   "src"))


def reference_serve(rb, params, prompts, *, batch, gen_len):
    """The reference's serve loop (`repro/launch/serve.py`), greedy."""
    cfg = rb.cfg
    prefill = jax.jit(rb.prefill_step(None))
    decode = jax.jit(rb.decode_step(None))
    prompt_len = len(prompts[0])
    dt = jnp.dtype(cfg.param_dtype)
    queue, waves = list(prompts), []
    while queue:
        wave = [queue.pop(0) for _ in range(min(batch, len(queue)))]
        while len(wave) < batch:
            wave.append(np.zeros(prompt_len, np.int32))
        inputs = {"tokens": jnp.asarray(np.stack(wave))}
        if cfg.family == "audio":
            inputs["frames"] = jnp.zeros((batch, prompt_len, cfg.d_model), dt)
        if cfg.family == "vlm":
            inputs["patches"] = jnp.zeros(
                (batch, cfg.frontend_tokens, cfg.d_model), dt)
        logits, _ = prefill(params, inputs)
        cache = rb.init_cache(batch=batch, cache_len=prompt_len + gen_len)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        generated = [tok]
        for i in range(gen_len - 1):
            logits, cache = decode(params, cache, tok,
                                   jnp.int32(prompt_len + i))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            generated.append(tok)
        waves.append(np.asarray(jnp.concatenate(generated, 1)))
    return waves


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m",
                                  "zamba2-7b", "whisper-base"])
def test_serve_requests_matches_the_reference_loop(arch):
    rcfg = dataclasses.replace(rget(arch, smoke=True), param_dtype="float32")
    tcfg = dataclasses.replace(tget(arch, smoke=True), param_dtype="float32")
    rb = RBundle(rcfg)
    params = rb.init(jax.random.PRNGKey(1))
    model = params_from_reference(
        tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), params),
        device="cpu")
    prompts = tserve.make_prompts(tcfg, requests=3, prompt_len=12, seed=2)
    want = reference_serve(rb, params, prompts, batch=2, gen_len=5)
    res = tserve.serve_requests(model, prompts, batch=2, gen_len=5)
    assert len(res.waves) == len(want) == 2
    for got, ref in zip(res.waves, want):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert res.done == 3 and res.tokens_out == 2 * 2 * 5
    assert res.logits_finite
    assert len(res.prefill_ms) == len(res.decode_ms_per_token) == 2


def test_serve_samples_from_the_generator():
    bundle = get_bundle("qwen2-1.5b", smoke=True)
    model = bundle.init(torch.Generator().manual_seed(0))
    prompts = tserve.make_prompts(bundle.cfg, requests=2, prompt_len=8)
    runs = [tserve.serve_requests(
        model, prompts, batch=2, gen_len=6, temperature=0.8,
        generator=torch.Generator().manual_seed(s)).waves[0]
        for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and \
        int(runs[0].max()) < bundle.cfg.vocab_padded
    with pytest.raises(ValueError, match="generator"):
        tserve.serve_requests(model, prompts, batch=2, gen_len=2,
                              temperature=0.8)


def test_prompts_are_the_reference_s():
    cfg = tget("qwen2-1.5b", smoke=True)
    rng = np.random.default_rng(0)
    want = [rng.integers(1, min(cfg.vocab, 1000), size=16, dtype=np.int32)
            for _ in range(3)]
    got = tserve.make_prompts(cfg, requests=3, prompt_len=16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(vocab=512, seq_len=33, global_batch=4, seed=0),
    dict(vocab=50304, seq_len=17, global_batch=6, seed=7, zipf_a=1.1,
         repeat_p=0.5),
], ids=["smoke-vocab", "capped-alphabet"])
def test_synthetic_dataset_is_bit_for_bit(kw):
    port, ref = SyntheticLMDataset(DataConfig(**kw)), \
        RDataset(RDataConfig(**kw))
    for step, shard, n in ((0, 0, 1), (3, 1, 2), (11, 2, 3)):
        a, b = port.batch_at(step, shard, n), ref.batch_at(step, shard, n)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    for k, v in port.global_batch_at(4).items():
        np.testing.assert_array_equal(v, ref.global_batch_at(4)[k])


@pytest.mark.parametrize("arch", list_archs())
def test_batch_specs_match_reference(arch):
    for mode in ("train", "prefill", "decode"):
        got = get_bundle(arch).batch_specs(seq=64, batch=2, mode=mode)
        want = rspecs(rget(arch), seq=64, batch=2, mode=mode)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


def test_wave_cost_matches_the_reference_simulator():
    """The co-simulation of the chip path's wave (qwen2-1.5b at full
    width, prompt 512, batch 4, gen 32) on paper-128."""
    sim = rt.Simulator("paper-128", device="cpu")
    pre, dec, cycles, pj = tserve.sim_wave_cost(
        sim, tget("qwen2-1.5b"), prompt_len=512, batch=4, gen_len=32)
    rsim = rapi.Simulator("paper-128")
    rpre = rsim.run_lm(rget("qwen2-1.5b"), seq=512, batch=4, mode="prefill")
    rdec = rsim.run_lm(rget("qwen2-1.5b"), seq=512, batch=4, mode="decode",
                       cache_len=544)
    rcyc, rpj = rsim.wave_cost(rpre, rdec, 32)
    assert cycles == pytest.approx(rcyc, rel=1e-3)
    assert pj == pytest.approx(rpj, rel=1e-3)
    assert pre.total_cycles == pytest.approx(rpre.total_cycles, rel=1e-3)
    assert dec.total_cycles == pytest.approx(rdec.total_cycles, rel=1e-3)


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, *args], env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_serve_cli_on_the_cpu():
    proc = _run(["-m", "repro_torch.launch.serve", "--smoke", "--device",
                 "cpu", "--sim-accel", "paper-32"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert sum(ln.startswith("wave done: 4 seqs x 16 tokens") for ln in
               lines) == 2
    assert any(ln.startswith("served 8 requests, 128 tokens in ")
               and ln.endswith("on cpu") for ln in lines)
    # the co-simulated line: the reference's numbers for the same traffic
    rsim = rapi.Simulator("paper-32")
    cfg = rget("qwen2-1.5b")
    pre = rsim.run_lm(cfg, seq=32, batch=4, mode="prefill")
    dec = rsim.run_lm(cfg, seq=32, batch=4, mode="decode", cache_len=48)
    cyc, pj = rsim.wave_cost(pre, dec, 16)
    want = (f"[sim:paper-32] modeled wave: {rsim.seconds(cyc) * 1e3:.2f} ms,"
            f" {pj * 1e-9:.1f} mJ ({pj * 1e-12 / 64 * 1e3:.3f} mJ/token)")
    assert lines[-1] == want


def test_serve_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--smoke", "--requests", "1", "--gen-len", "2"])
    proc = _run(["-m", "repro_torch.launch.serve", "--smoke"])
    assert proc.returncode != 0
    assert "served" not in proc.stdout


def test_workload_plane_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.configs, repro_torch.models.zoo\n"
        "import repro_torch.models.decode, repro_torch.data.pipeline\n"
        "from repro_torch.launch import serve\n"
        "assert serve.main(['--smoke', '--device', 'cpu', '--requests', '2',"
        " '--batch', '2', '--prompt-len', '8', '--gen-len', '3',"
        " '--sim-accel', 'paper-32']) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print('LEAKED', bad)\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout
