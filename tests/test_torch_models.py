"""The workload plane's model pieces in the PyTorch port against the JAX
reference (`repro.models`), module by module, on seeded numpy inputs:
norms, RoPE and SwiGLU; attention (causal, windowed, GQA, and L = 320 for
the chunked path with its padded ragged tail); decode attention across a
ring-buffer wrap; MoE dispatch with capacity drops and tied gates; the
Mamba2, mLSTM and sLSTM blocks at L = 256 (two chunks) and one decode
step; chunked cross-entropy at L = 600, where the reference skips the
last L % 512 tokens. Float32 within 1e-5 of the reference's largest
magnitude, bfloat16 within 2e-2 (one bfloat16 rounding or two)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as rattn
import repro.models.common as rcom
import repro.models.ffn as rffn
import repro.models.ssm as rssm
import repro.models.transformer as rtr
from repro.models.config import ModelConfig as RConfig
import repro_torch.models.attention as tattn
import repro_torch.models.common as tcom
import repro_torch.models.ffn as tffn
import repro_torch.models.ssm as tssm
from repro_torch.models.config import ModelConfig as TConfig

F32_TOL = 1e-5
BF16_TOL = 2e-2


def rel(port, ref) -> float:
    """max |port - ref| / max |ref|."""
    a = port.to(torch.float64).numpy() if torch.is_tensor(port) \
        else np.asarray(port, np.float64)
    b = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b), initial=0.0)
                 / max(np.max(np.abs(b), initial=0.0), 1e-30))


def cfgs(**kw):
    base = dict(arch_id="t", family="dense", layers=2, d_model=32, heads=4,
                kv_heads=2, d_ff=48, vocab=64)
    base.update(kw)
    return RConfig(**base), TConfig(**base)


def make_params(defs, seed, dtype="float32"):
    """Random leaves for a ParamDef dict (numpy, float32): normal leaves at
    their scale (at least 0.1, so products are not tiny), the zeros/ones
    leaves perturbed so that every parameter matters."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, d in defs.items():
        r = rng.standard_normal(d.shape).astype(np.float32)
        if d.init == "normal":
            out[k] = r * max(d.scale, 0.1)
        else:
            out[k] = (1.0 if d.init == "ones" else 0.0) + 0.1 * r
    return out


def both(tree, dtype):
    """numpy float32 dict -> (jnp dict, torch dict) in `dtype`."""
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    return ({k: jnp.asarray(v, jdt) for k, v in tree.items()},
            {k: torch.from_numpy(v).to(tdt) for k, v in tree.items()})


def arr(rng, shape, dtype="float32", scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


# --------------------------------------------------------------------------
# common
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_rms_norm_rope_swiglu(dtype, tol):
    rng = np.random.default_rng(0)
    jx, tx = arr(rng, (2, 10, 4, 16), dtype)
    jg, tg = arr(rng, (16,), dtype)
    assert rel(tcom.rms_norm(tx, tg, 1e-5), rcom.rms_norm(jx, jg, 1e-5)) \
        < tol
    pos = rng.integers(0, 5000, (2, 10))
    assert rel(tcom.rope(tx, torch.from_numpy(pos), 1e6),
               rcom.rope(jx, jnp.asarray(pos, jnp.int32), 1e6)) < tol
    assert rel(tcom.swiglu(tx), rcom.swiglu(jx)) < tol
    assert rel(tcom.gelu(tx), rcom.gelu(jx)) < tol


def test_chunked_cross_entropy_drops_the_tail():
    """L = 600: one chunk of 512 counts, the last 88 tokens do not."""
    rng = np.random.default_rng(1)
    B, L, d, V, true_vocab = 2, 600, 16, 40, 37
    jx, tx = arr(rng, (B, L, d))
    jw, tw = arr(rng, (d, V), scale=0.5)
    labels = rng.integers(0, true_vocab, (B, L))
    mask = (rng.random((B, L)) < 0.8).astype(np.float32)
    ref = rcom.chunked_cross_entropy(jx, jw, jnp.asarray(labels, jnp.int32),
                                     true_vocab=true_vocab,
                                     mask=jnp.asarray(mask))
    port = tcom.chunked_cross_entropy(tx, tw, torch.from_numpy(labels),
                                      true_vocab=true_vocab,
                                      mask=torch.from_numpy(mask))
    assert rel(port, ref) < F32_TOL
    # the tail's labels do not move the loss
    labels2 = labels.copy()
    labels2[:, 512:] = (labels2[:, 512:] + 1) % true_vocab
    port2 = tcom.chunked_cross_entropy(tx, tw, torch.from_numpy(labels2),
                                       true_vocab=true_vocab,
                                       mask=torch.from_numpy(mask))
    assert float(port2) == float(port)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

ATTN_CASES = {
    "causal-gqa": dict(kw=dict(), L=24, causal=True),
    "mha": dict(kw=dict(kv_heads=4), L=24, causal=True),
    "windowed": dict(kw=dict(attn_window=7), L=24, causal=True),
    "bidirectional-bias": dict(kw=dict(qkv_bias=True), L=24, causal=False),
    "chunked-320": dict(kw=dict(), L=320, causal=True),
    "chunked-320-windowed": dict(kw=dict(attn_window=100), L=320,
                                 causal=True),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_reference(case):
    c = ATTN_CASES[case]
    rcfg, tcfg = cfgs(**c["kw"])
    rng = np.random.default_rng(2)
    jp, tp = both(make_params(rtr.attn_defs(rcfg, "float32"), 3),
                  "float32")
    jx, tx = arr(rng, (2, c["L"], rcfg.d_model))
    ry, (rk, rv) = rattn.attention(jp, jx, cfg=rcfg, ctx=None,
                                   causal=c["causal"])
    ty, (tk, tv) = tattn.attention(tp, tx, cfg=tcfg, causal=c["causal"])
    assert rel(ty, ry) < F32_TOL
    assert rel(tk, rk) < F32_TOL and rel(tv, rv) < F32_TOL


def test_cross_attention_matches_reference():
    rcfg, tcfg = cfgs(kv_heads=4)
    rng = np.random.default_rng(4)
    jp, tp = both(make_params(rtr.attn_defs(rcfg, "float32"), 5), "float32")
    jx, tx = arr(rng, (2, 3, rcfg.d_model))
    je, te = arr(rng, (2, 11, rcfg.d_model))
    ry, _ = rattn.attention(jp, jx, cfg=rcfg, ctx=None, causal=False,
                            kv_x=je, use_rope=False)
    ty, _ = tattn.attention(tp, tx, cfg=tcfg, causal=False, kv_x=te,
                            use_rope=False)
    assert rel(ty, ry) < F32_TOL


def test_gqa_scores_ctx_chunked_tail_equals_one_pass():
    """The padded ragged tail gives the rows a single pass gives."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 300, 4, 8)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 300, 2, 8)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 300, 2, 8)).astype(
        np.float32))
    a = tattn.gqa_scores_ctx(q, k, v, causal=True, window=0, q_offset=0)
    b = tattn.gqa_scores_ctx(q, k, v, causal=True, window=0, q_offset=0,
                             chunk=512)
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window,cache_len", [(8, 13), (8, 5), (0, 9),
                                              (0, 40)],
                         ids=["ring-wrap", "ring-fill", "plain",
                              "past-the-end"])
def test_decode_attention_matches_reference(window, cache_len):
    """A windowed cache ring-buffers (slot cache_len % S); a plain one
    clamps the slot to S - 1."""
    rcfg, tcfg = cfgs(attn_window=window, qkv_bias=True)
    rng = np.random.default_rng(7)
    jp, tp = both(make_params(rtr.attn_defs(rcfg, "float32"), 8), "float32")
    S = 8 if window else 16
    jx, tx = arr(rng, (2, 1, rcfg.d_model))
    jk, tk = arr(rng, (2, S, rcfg.kv_heads, rcfg.head_dim))
    jv, tv = arr(rng, (2, S, rcfg.kv_heads, rcfg.head_dim))
    ry, (rk, rv) = rattn.decode_attention(jp, jx, jk, jv,
                                          jnp.int32(cache_len), cfg=rcfg,
                                          ctx=None)
    ty, (tk2, tv2) = tattn.decode_attention(tp, tx, tk, tv, cache_len,
                                            cfg=tcfg)
    assert rel(ty, ry) < F32_TOL
    assert rel(tk2, rk) < F32_TOL and rel(tv2, rv) < F32_TOL


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def ref_dispatch(x, wr, top_k, capacity):
    """The dispatch lines of `repro.models.ffn._moe_local`, in jnp."""
    E = wr.shape[1]
    gates = jax.nn.softmax(jnp.einsum("td,de->te", x, wr,
                                      preferred_element_type=jnp.float32),
                           axis=-1)
    topv, topi = jax.lax.top_k(gates, top_k)
    flat_e = topi.reshape(-1)
    oh = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(oh, axis=0) - oh
    pos = (pos * oh).sum(-1)
    return np.asarray(flat_e), np.asarray(pos), np.asarray(pos < capacity)


@pytest.mark.parametrize("case", ["drops", "tied-gates", "no-drops",
                                  "decode-cap-1"])
def test_moe_dispatch_and_output_match_reference(case):
    kw = dict(family="moe", num_experts=4, top_k=2)
    B, L = 2, 8
    if case == "drops":
        kw["moe_capacity_factor"] = 0.5          # cap 4 for 32 pairs
    if case == "no-drops":
        kw["moe_capacity_factor"] = 4.0
    if case == "decode-cap-1":
        kw.update(num_experts=8, top_k=4)        # granite-like, 4 tokens
        B, L = 4, 1
    rcfg, tcfg = cfgs(**kw)
    tree = make_params(rtr.ffn_defs(rcfg, "float32"), 9)
    if case == "tied-gates":                     # columns 2, 3 copy 1, 0
        tree["wr"][:, 2] = tree["wr"][:, 1]
        tree["wr"][:, 3] = tree["wr"][:, 0]
    jp, tp = both(tree, "float32")
    rng = np.random.default_rng(10)
    jx, tx = arr(rng, (B, L, rcfg.d_model))
    T = B * L
    cap = tffn.moe_capacity(T, tcfg)
    assert cap == max(1, int(T * rcfg.top_k / rcfg.num_experts
                             * rcfg.moe_capacity_factor))
    fe, pos, keep = ref_dispatch(jx.reshape(T, -1), jp["wr"], rcfg.top_k,
                                 cap)
    tfe, tpos, tkeep, _ = tffn.moe_dispatch(tx.reshape(T, -1), tp["wr"],
                                            k=tcfg.top_k, capacity=cap)
    np.testing.assert_array_equal(tfe.numpy(), fe)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    if case in ("drops", "decode-cap-1"):
        assert not keep.all()
    if case == "no-drops":
        assert keep.all()
    ry = rffn.moe_ffn(jp, jx, cfg=rcfg, ctx=None)
    ty = tffn.moe_ffn(tp, tx, cfg=tcfg)
    assert rel(ty, ry) < F32_TOL


def test_top_k_breaks_ties_to_the_lower_index():
    g = torch.tensor([[0.1, 0.3, 0.3, 0.3, 0.0], [0.2, 0.2, 0.2, 0.2, 0.2]])
    v, i = tffn.top_k(g, 2)
    rv, ri = jax.lax.top_k(jnp.asarray(g.numpy()), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(i.numpy(), [[1, 2], [0, 1]])


def test_dense_ffn_matches_reference():
    rcfg, tcfg = cfgs()
    jp, tp = both(make_params(rtr.ffn_defs(rcfg, "float32"), 11), "float32")
    rng = np.random.default_rng(12)
    jx, tx = arr(rng, (2, 5, rcfg.d_model))
    assert rel(tffn.dense_ffn(tp, tx), rffn.dense_ffn(jp, jx, None)) \
        < F32_TOL


# --------------------------------------------------------------------------
# SSM blocks: two chunks of 128, then one decode step from the final state
# --------------------------------------------------------------------------

SSM_CFG = dict(family="ssm", d_model=32, heads=2, kv_heads=2, d_ff=0,
               ssm_state=8, ssm_headdim=16)
SSM_BLOCKS = {
    "mamba2": (rtr.mamba_defs, rssm.mamba2_forward, rssm.mamba2_decode,
               tssm.mamba2_forward, tssm.mamba2_decode),
    "mlstm": (rtr.mlstm_defs, rssm.mlstm_forward, rssm.mlstm_decode,
              tssm.mlstm_forward, tssm.mlstm_decode),
    "slstm": (rtr.slstm_defs, rssm.slstm_forward, rssm.slstm_decode,
              tssm.slstm_forward, tssm.slstm_decode),
}


@pytest.mark.parametrize("block", list(SSM_BLOCKS))
@pytest.mark.parametrize("L", [256, 40], ids=["two-chunks", "one-chunk"])
def test_ssm_block_forward_and_decode_match_reference(block, L):
    defs, rfwd, rdec, tfwd, tdec = SSM_BLOCKS[block]
    rcfg, tcfg = cfgs(**SSM_CFG)
    tree = make_params(defs(rcfg, "float32"), 13)
    jp, tp = both(tree, "float32")
    rng = np.random.default_rng(14)
    jx, tx = arr(rng, (2, L, rcfg.d_model))
    ry, rs = rfwd(jp, jx, cfg=rcfg)
    ty, ts = tfwd(tp, tx, cfg=tcfg)
    assert rel(ty, ry) < F32_TOL
    for a, b in zip(ts, rs):
        assert rel(a, b) < F32_TOL
    jx1, tx1 = arr(rng, (2, 1, rcfg.d_model))
    ry1, rs1 = rdec(jp, jx1, rs, cfg=rcfg)
    ty1, ts1 = tdec(tp, tx1, ts, cfg=tcfg)
    assert rel(ty1, ry1) < F32_TOL
    for a, b in zip(ts1, rs1):
        assert rel(a, b) < F32_TOL


def test_mamba2_forward_ignores_the_conv_state():
    """As in the reference: a given state's conv buffer is not read."""
    rcfg, tcfg = cfgs(**SSM_CFG)
    _, tp = both(make_params(rtr.mamba_defs(rcfg, "float32"), 15),
                 "float32")
    rng = np.random.default_rng(16)
    _, tx = arr(rng, (1, 8, rcfg.d_model))
    y0, (S, conv) = tssm.mamba2_forward(tp, tx, cfg=tcfg)
    y1, _ = tssm.mamba2_forward(tp, tx, cfg=tcfg, state=(S, conv + 1.0))
    y2, _ = tssm.mamba2_forward(tp, tx, cfg=tcfg, state=(S, conv))
    assert torch.equal(y1, y2)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(17)
    jx, tx = arr(rng, (2, 9, 6))
    jw, tw = arr(rng, (4, 6))
    assert rel(tssm.causal_conv(tx, tw), rssm.causal_conv(jx, jw)) < F32_TOL


def test_ssm_sequence_must_be_whole_chunks():
    """L > 128 and L % 128 != 0 fails in both (the reference reshapes L
    into L // 128 chunks)."""
    rcfg, tcfg = cfgs(**SSM_CFG)
    tree = make_params(rtr.mlstm_defs(rcfg, "float32"), 18)
    jp, tp = both(tree, "float32")
    rng = np.random.default_rng(19)
    jx, tx = arr(rng, (1, 130, rcfg.d_model))
    with pytest.raises(Exception):
        rssm.mlstm_forward(jp, jx, cfg=rcfg)
    with pytest.raises(RuntimeError):
        tssm.mlstm_forward(tp, tx, cfg=tcfg)
