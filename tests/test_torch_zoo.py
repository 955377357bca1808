"""The PyTorch port's model zoo against the JAX reference (`repro.models`,
`repro.configs`): all 10 SMOKE architectures with the reference's own
initial weights carried across by `params_from_reference`, in float32
(`param_dtype="float32"` on both sides): prefill logits and caches, decode
from the reference's prefill cache (through `cache_from_reference`) and
from a zero cache, and the loss, each within 1e-4 of the reference's
largest magnitude, greedy tokens equal. Then the configs field for field,
the assignment and parameter-count checks of `tests/test_models_smoke.py`
on the port's copies, the parameter and cache trees, and `lm_ops` on the
port's own full configs. (`tests/test_torch_zoo_bf16.py` holds the same
runs in bfloat16.)"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.workloads as rwl
import repro.models.decode as rdec
import repro.models.transformer as rtr
from repro.configs import get_config as rget
from repro.configs import list_archs as rlist
from repro.configs import shapes as rshapes
from repro.models.zoo import ModelBundle as RBundle
import repro_torch.core.workloads as twl
import repro_torch.models.decode as tdec
import repro_torch.models.transformer as ttr
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs as tlist
from repro_torch.configs import shapes as tshapes
from repro_torch.models.decode import cache_from_reference
from repro_torch.models.params import params_from_reference, tree_map
from repro_torch.models.zoo import ModelBundle as TBundle
from repro_torch.models.zoo import get_bundle

ARCHS = rlist()
B, L = 2, 40           # L > the smoke windows (32): the windowed caches cut
F32_TOL = 1e-4


def rel(port, ref) -> float:
    """max |port - ref| / max |ref| (port a tensor, ref anything numpy
    takes)."""
    a = port.to(torch.float64).numpy()
    b = np.asarray(ref, np.float32).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b), initial=0.0)
                 / max(np.max(np.abs(b), initial=0.0), 1e-30))


def np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def paired(port_tree, ref_tree):
    """(port leaf, reference leaf) pairs over the port's tree."""
    if isinstance(port_tree, dict):
        assert set(port_tree) == set(ref_tree), (set(port_tree),
                                                 set(ref_tree))
        return [p for k in port_tree for p in paired(port_tree[k],
                                                     ref_tree[k])]
    return [(port_tree, ref_tree)]


def inputs(cfg, seed=0):
    """Seeded numpy inputs of one prefill and the loss."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    out = {"tokens": tokens,
           "labels": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32),
           "loss_mask": (rng.random((B, L)) < 0.9).astype(np.float32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((B, L, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    out["token"] = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    return out


def jbatch(x, dtype, keys):
    return {k: (jnp.asarray(x[k]) if x[k].dtype == np.int32
                else jnp.asarray(x[k], jnp.dtype(dtype)))
            for k in keys if k in x}


def tbatch(x, dtype, keys):
    return {k: (torch.from_numpy(x[k]).long() if x[k].dtype == np.int32
                else torch.from_numpy(x[k]).to(getattr(torch, dtype)))
            for k in keys if k in x}


PREFILL_KEYS = ("tokens", "frames", "patches")
LOSS_KEYS = PREFILL_KEYS + ("labels", "loss_mask")


def reference_run(arch, dtype):
    """The reference's prefill, two decodes and loss on its own weights,
    as numpy float32 trees."""
    cfg = dataclasses.replace(rget(arch, smoke=True), param_dtype=dtype)
    rb = RBundle(cfg)
    params = rb.init(jax.random.PRNGKey(0))
    x = inputs(cfg)
    logits, cache = jax.jit(rb.prefill_step(None))(
        params, jbatch(x, dtype, PREFILL_KEYS))
    dec = jax.jit(rb.decode_step(None))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    d_logits, d_cache = dec(params, cache, tok, jnp.int32(L))
    zero = rb.init_cache(batch=B, cache_len=L)
    z_logits, z_cache = dec(params, zero, jnp.asarray(x["token"]),
                            jnp.int32(5))
    loss = jax.jit(rb.loss_fn(None))(params, jbatch(x, dtype, LOSS_KEYS))
    return dict(params=np32(params), x=x, logits=np32(logits),
                cache=np32(cache), d_logits=np32(d_logits),
                d_cache=np32(d_cache), z_logits=np32(z_logits),
                z_cache=np32(z_cache), loss=float(loss))


@pytest.fixture(scope="module")
def runs():
    memo = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in memo:
            memo[arch, dtype] = reference_run(arch, dtype)
        return memo[arch, dtype]
    return get


def port_model(arch, dtype, ref):
    cfg = dataclasses.replace(tget(arch, smoke=True), param_dtype=dtype)
    return TBundle(cfg), params_from_reference(cfg, ref["params"],
                                               device="cpu")


def check_tree(port, ref, tol):
    for a, b in paired(port, ref):
        assert rel(a, b) < tol


def check_logits(port, ref, tol):
    assert rel(port, ref) < tol
    np.testing.assert_array_equal(port.argmax(-1).numpy(),
                                  np.asarray(ref).argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(runs, arch):
    ref = runs(arch)
    bundle, model = port_model(arch, "float32", ref)
    with torch.inference_mode():
        logits, cache = bundle.prefill(
            model, tbatch(ref["x"], "float32", PREFILL_KEYS))
    assert logits.dtype == torch.float32
    check_logits(logits, ref["logits"], F32_TOL)
    check_tree(cache, ref["cache"], F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_the_reference_prefill_cache(runs, arch):
    ref = runs(arch)
    bundle, model = port_model(arch, "float32", ref)
    cache = cache_from_reference(bundle.cfg, ref["cache"], device="cpu")
    tok = torch.from_numpy(np.asarray(ref["logits"]).argmax(-1))[:, None]
    with torch.inference_mode():
        logits, new = bundle.decode(model, cache, tok, L)
    assert new is cache                     # updated in place
    check_logits(logits, ref["d_logits"], F32_TOL)
    check_tree(new, ref["d_cache"], F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_a_zero_cache(runs, arch):
    ref = runs(arch)
    bundle, model = port_model(arch, "float32", ref)
    cache = bundle.init_cache(batch=B, cache_len=L, device="cpu")
    with torch.inference_mode():
        logits, new = bundle.decode(model, cache,
                                    torch.from_numpy(ref["x"]["token"]), 5)
    check_logits(logits, ref["z_logits"], F32_TOL)
    check_tree(new, ref["z_cache"], F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(runs, arch):
    ref = runs(arch)
    bundle, model = port_model(arch, "float32", ref)
    with torch.inference_mode():
        loss = bundle.loss(model, tbatch(ref["x"], "float32", LOSS_KEYS))
    assert abs(float(loss) - ref["loss"]) <= F32_TOL * abs(ref["loss"])


# --------------------------------------------------------------------------
# configs, trees, counts
# --------------------------------------------------------------------------

PROPS = ("vocab_padded", "decoder_layers", "d_inner", "ssm_heads",
         "is_encdec", "sub_quadratic")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    assert tlist() == rlist()
    for smoke in (False, True):
        t, r = tget(arch, smoke=smoke), rget(arch, smoke=smoke)
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        for p in PROPS:
            assert getattr(t, p) == getattr(r, p), p
        assert t.param_count() == r.param_count()
        assert t.active_param_count() == r.active_param_count()
    full = tget(arch)
    assert tshapes.SHAPES == rshapes.SHAPES
    for s in tshapes.SHAPES:
        assert tshapes.cell_mode(s) == rshapes.cell_mode(s)
        assert tshapes.skip_reason(full, s) == rshapes.skip_reason(
            rget(arch), s)
    assert tshapes.runnable_cells(full) == rshapes.runnable_cells(rget(arch))


def defs_dict(defs, fields=("shape", "logical", "init", "scale", "dtype")):
    if isinstance(defs, dict):
        return {k: defs_dict(v) for k, v in defs.items()}
    return tuple(getattr(defs, f) for f in fields)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_and_cache_trees_equal_reference(arch):
    """The port's ParamDef trees are the reference's leaf for leaf (full
    configs: no memory is allocated), and so are the counts."""
    t, r = tget(arch), rget(arch)
    assert defs_dict(ttr.model_defs(t)) == defs_dict(rtr.model_defs(r))
    assert defs_dict(tdec.cache_defs(t, 3, 100)) == \
        defs_dict(rdec.cache_defs(r, 3, 100))
    tb, rb = TBundle(t), RBundle(r)
    assert tb.param_count() == rb.param_count()
    assert tb.param_bytes() == sum(
        int(np.prod(d.shape)) * jnp.dtype(d.dtype).itemsize
        for d in jax.tree.leaves(rb.defs, is_leaf=lambda x: hasattr(
            x, "logical")))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_ops_on_the_port_s_own_configs(arch):
    t, r = tget(arch), rget(arch)
    for kw in (dict(seq=256, batch=2, mode="train"),
               dict(seq=512, batch=4, mode="prefill"),
               dict(seq=512, batch=4, mode="decode", cache_len=544)):
        assert [dataclasses.asdict(o) for o in twl.lm_ops(t, **kw)] == \
            [dataclasses.asdict(o) for o in rwl.lm_ops(r, **kw)]


def test_exact_configs_match_assignment():
    """The full (non-smoke) configs carry the assigned numbers (the
    reference's `tests/test_models_smoke.py` check on the port's copy)."""
    spec = {
        "whisper-base": dict(d_model=512, heads=8, kv_heads=8, d_ff=2048,
                             vocab=51865),
        "mixtral-8x7b": dict(layers=32, d_model=4096, heads=32, kv_heads=8,
                             d_ff=14336, vocab=32000, num_experts=8, top_k=2),
        "granite-moe-3b-a800m": dict(layers=32, d_model=1536, heads=24,
                                     kv_heads=8, d_ff=512, vocab=49155,
                                     num_experts=40, top_k=8),
        "yi-34b": dict(layers=60, d_model=7168, heads=56, kv_heads=8,
                       d_ff=20480, vocab=64000),
        "qwen2-72b": dict(layers=80, d_model=8192, heads=64, kv_heads=8,
                          d_ff=29568, vocab=152064, qkv_bias=True),
        "qwen2-1.5b": dict(layers=28, d_model=1536, heads=12, kv_heads=2,
                           d_ff=8960, vocab=151936, qkv_bias=True),
        "glm4-9b": dict(layers=40, d_model=4096, heads=32, kv_heads=2,
                        d_ff=13696, vocab=151552),
        "zamba2-7b": dict(layers=81, d_model=3584, heads=32, kv_heads=32,
                          d_ff=14336, vocab=32000, ssm_state=64),
        "xlstm-1.3b": dict(layers=48, d_model=2048, heads=4, kv_heads=4,
                           d_ff=0, vocab=50304),
        "internvl2-1b": dict(layers=24, d_model=896, heads=14, kv_heads=2,
                             d_ff=4864, vocab=151655),
    }
    for arch, want in spec.items():
        cfg = tget(arch)
        for k, v in want.items():
            assert getattr(cfg, k) == v, (arch, k, getattr(cfg, k), v)


def test_param_counts_in_expected_range():
    expect = {"qwen2-72b": (65e9, 85e9), "yi-34b": (30e9, 38e9),
              "mixtral-8x7b": (42e9, 50e9), "glm4-9b": (8e9, 12e9),
              "qwen2-1.5b": (1.2e9, 2.1e9), "xlstm-1.3b": (1.0e9, 1.8e9),
              "zamba2-7b": (5.5e9, 9e9), "internvl2-1b": (0.4e9, 1.2e9),
              "granite-moe-3b-a800m": (2.5e9, 4.2e9),
              "whisper-base": (0.05e9, 0.12e9)}
    for arch, (lo, hi) in expect.items():
        n = tget(arch).param_count()
        assert lo < n < hi, (arch, n)
    g = tget("granite-moe-3b-a800m")
    assert g.active_param_count() < 0.5 * g.param_count()


def test_init_draws_the_reference_s_distribution():
    """Random weights from a torch.Generator: each ParamDef's shape,
    dtype and init (normal at its scale, zeros, ones), the same weights
    for the same seed."""
    bundle = get_bundle("zamba2-7b", smoke=True)
    m1 = bundle.init(torch.Generator().manual_seed(3))
    m2 = bundle.init(torch.Generator().manual_seed(3))
    for (n, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n
    assert m1.embed.dtype == torch.bfloat16
    assert abs(float(m1.embed.float().std()) - 1.0) < 0.05
    blk = m1.mamba_groups[0][0]
    assert blk["A_log"].dtype == torch.float32
    assert torch.equal(blk["D"], torch.ones_like(blk["D"]))
    assert torch.equal(blk["dt_bias"], torch.zeros_like(blk["dt_bias"]))
    assert abs(float(blk["in_proj"].float().std()) - 0.02) < 0.004
    assert sum(p.numel() for p in m1.parameters()) == bundle.param_count()
    assert len(m1.mamba_groups) == 2 and len(m1.mamba_groups[0]) == 2
    assert len(m1.mamba_tail) == 1          # 7 = 2 x 3 + 1


def test_hybrid_stack_always_has_a_tail_block():
    """6 layers in groups of 3: two groups and, as in the reference, one
    tail block."""
    rcfg = dataclasses.replace(rget("zamba2-7b", smoke=True), layers=6)
    tcfg = dataclasses.replace(tget("zamba2-7b", smoke=True), layers=6)
    assert ttr.hybrid_layout(tcfg) == (2, 2, 1)
    assert rtr.model_defs(rcfg)["mamba_tail"]["ln"].shape[0] == 1
    model = TBundle(tcfg).init(torch.Generator().manual_seed(0))
    assert len(model.mamba_tail) == 1


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_bundle("qwen2-1.5b", smoke=True).init_cache(batch=1,
                                                        cache_len=4)
    bundle = get_bundle("qwen2-1.5b", smoke=True)

    def zeros(defs):
        return tree_map(lambda d: np.zeros(d.shape, np.float32), defs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference(bundle.cfg, zeros(bundle.defs))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cache_from_reference(bundle.cfg,
                             zeros(bundle.cache_defs(batch=1, cache_len=4)))
