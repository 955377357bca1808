"""State-space blocks: Mamba2 (chunked SSD), mLSTM (chunked matrix memory),
sLSTM (scanned scalar memory with exponential gating).

Each has a parallel prefill form (a loop over sequence chunks carrying
O(1) state) and a single-token decode form carrying explicit recurrent
state, as in the reference (`repro/models/ssm.py`), whose `lax.scan`s are
Python loops here. Under autograd the Mamba2 and mLSTM chunks are
recomputed in the backward, where the reference checkpoints its chunk
bodies; inside a recomputed block the Mamba2 chunk is not checkpointed
again (`common.flat`), as XLA's compiled reference does not run it a
third time. As there, a sequence longer than a chunk must be a whole
number of chunks, and `mamba2_forward` reads only the SSM part of a
given state (not its conv buffer).

Under a mesh the blocks run on a model rank's heads (`transformer.py`,
`_residual`): `cfg` then carries the rank's `d_inner` and head counts and
`p` the rank's slices of the weights, and hooks stand in for the
collectives: Mamba2's `norm` (its gate norm over the whole d_inner) and
`gather` (its whole B and C from the ranks' blocks of columns), the
mLSTM's `mix` (its whole x before the q/k/v and gate projections) and
the sLSTM's `gather` (its whole h before each recurrent product). The last
projection's output is then this rank's partial sum.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .common import F32, flat, remat, rms_norm


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. x: (B, L, D), w: (K, D)."""
    K = w.shape[0]
    y = x * w[K - 1]
    for k in range(1, K):
        y = y + F.pad(x, (0, 0, k, 0))[:, :-k] * w[K - 1 - k]
    return y


def _chunks(t: torch.Tensor, nc: int, chunk: int):
    """(B, L, ...) -> nc tensors (B, chunk, ...); L must be nc * chunk."""
    t = t.reshape(t.shape[0], nc, chunk, *t.shape[2:])
    return [t[:, c] for c in range(nc)]


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def _mamba_in(p, x, cfg, gather=None):
    di, N = cfg.d_inner, cfg.ssm_state
    zx = torch.matmul(x, p["in_proj"])
    z, xin = zx[..., :di], zx[..., di:]
    bc_dt = torch.matmul(x, p["bc_proj"])
    if gather is not None:
        bc_dt = gather(bc_dt)
    conv_in = torch.cat([xin, bc_dt[..., :2 * N]], -1)
    dt = F.softplus(torch.matmul(x, p["dt_proj"]).to(F32) + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(F32))                        # (H,)
    return z, conv_in, dt, A


def _mamba_out(p, y, z, x, cfg, norm=rms_norm):
    y = norm(y * F.silu(z.to(F32)).to(x.dtype), p["gate_norm"],
             cfg.norm_eps)
    return torch.matmul(y, p["out_proj"])


# flat: XLA's compiled reference runs the chunk's forward twice in a
# training step (the forward and the backward's recompute), where nested
# checkpoints would run it three times (`tests/test_torch_dryrun.py`)
@flat
def _mamba_chunk(S, xq, dq, bq, cq, A):
    """One SSD chunk: (B,Q,H,hd) (B,Q,H) (B,Q,N) (B,Q,N) and the carried
    state S -> (new S, the chunk's y)."""
    xq = xq.to(F32)
    Q = xq.shape[1]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xq.device))
    dA = dq * A                                                # (B,Q,H)
    cums = torch.cumsum(dA, dim=1)
    seg = torch.exp(cums[:, :, None, :] - cums[:, None, :, :])  # (B,i,j,H)
    scores = torch.einsum("bin,bjn->bij", cq, bq)              # shared heads
    w = torch.where(mask[None, :, :, None], seg, 0.0) \
        * scores[..., None] * dq[:, None, :, :]                # (B,i,j,H)
    y_intra = torch.einsum("bijh,bjhp->bihp", w, xq)
    decay_out = torch.exp(cums)                                # (B,Q,H)
    y_inter = torch.einsum("bin,bhpn,bih->bihp", cq, S, decay_out)
    tail = torch.exp(cums[:, -1:, :] - cums)                   # (B,Q,H)
    contrib = torch.einsum("bjn,bjh,bjhp->bhpn", bq, tail * dq, xq)
    S = S * torch.exp(cums[:, -1])[:, :, None, None] + contrib
    return S, y_intra + y_inter


def mamba2_forward(p, x, *, cfg, chunk: int = 128,
                   state: Optional[Tuple] = None, norm=rms_norm,
                   gather=None):
    """x: (B, L, d) -> (y, (S (B,H,hd,N), conv_buf (B,K-1,di+2N)))."""
    B, L, d = x.shape
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hd = di // H
    chunk = max(1, min(chunk, L))
    z, conv_in, dt, A = _mamba_in(p, x, cfg, gather)
    conv_out = causal_conv(conv_in, p["conv_w"])
    conv_out = F.silu(conv_out.to(F32)).to(x.dtype)
    xin = conv_out[..., :di]
    Bm = conv_out[..., di:di + N].to(F32)
    Cm = conv_out[..., di + N:].to(F32)

    nc = L // chunk
    S = (torch.zeros((B, H, hd, N), dtype=F32, device=x.device)
         if state is None else state[0])
    ys = []
    for xq, dq, bq, cq in zip(_chunks(xin.reshape(B, L, H, hd), nc, chunk),
                              _chunks(dt, nc, chunk), _chunks(Bm, nc, chunk),
                              _chunks(Cm, nc, chunk)):
        S, y = remat(_mamba_chunk, S, xq, dq, bq, cq, A)
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, L, H, hd)
    y = y + p["D"][None, None, :, None].to(F32) \
        * xin.reshape(B, L, H, hd).to(F32)
    y = y.reshape(B, L, di).to(x.dtype)
    out = _mamba_out(p, y, z, x, cfg, norm)
    K = p["conv_w"].shape[0]
    return out, (S, conv_in[:, -(K - 1):, :])


def mamba2_decode(p, x, state, *, cfg, norm=rms_norm, gather=None):
    """Single token: x (B, 1, d); state = (S, conv_buf)."""
    B = x.shape[0]
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hd = di // H
    S, conv_buf = state
    z, conv_in, dt, A = _mamba_in(p, x, cfg, gather)  # conv_in: (B,1,ch)
    window = torch.cat([conv_buf, conv_in], dim=1)             # (B,K,ch)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"])[:, None, :]
    conv_out = F.silu(conv_out.to(F32)).to(x.dtype)
    xin = conv_out[..., :di]
    Bm = conv_out[..., di:di + N].to(F32)
    Cm = conv_out[..., di + N:].to(F32)
    dA = torch.exp(dt[:, 0] * A)                               # (B,H)
    xh = xin.reshape(B, H, hd).to(F32)
    S = S * dA[:, :, None, None] \
        + torch.einsum("bn,bh,bhp->bhpn", Bm[:, 0], dt[:, 0], xh)
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], S) \
        + p["D"][None, :, None].to(F32) * xh
    y = y.reshape(B, 1, di).to(x.dtype)
    return _mamba_out(p, y, z, x, cfg, norm), (S, window[:, 1:])


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, chunkwise)
# ---------------------------------------------------------------------------

def _mlstm_in(p, x, cfg, mix=None):
    B, L, _ = x.shape
    di, H = cfg.d_inner, cfg.heads
    up = torch.matmul(x, p["up_proj"])
    z, xin = up[..., :di], up[..., di:]
    if mix is not None:
        xin = mix(xin)
    qkv = torch.matmul(xin, p["w_qkv"])
    q, k, v = [t.reshape(B, L, H, di // H) for t in qkv.chunk(3, dim=-1)]
    gates = torch.matmul(xin, p["w_gates"]).to(F32)
    return z, q, k, v, gates


def _mlstm_out(p, y, z, x):
    y = y * F.silu(z.to(F32)).to(x.dtype)
    return torch.matmul(y, p["down_proj"])


def _mlstm_chunk(S, n, qc, kc, vc, lic, lfc, scale):
    """One mLSTM chunk: q/k/v (B,Q,H,hd), log gates (B,Q,H) and the
    carried (S, n) -> (new S, new n, the chunk's y)."""
    qc, kc, vc = qc.to(F32), kc.to(F32), vc.to(F32)
    Q = qc.shape[1]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=qc.device))[None, :, :, None]
    cums = torch.cumsum(lfc, dim=1)                            # (B,Q,H)
    dmat = torch.exp(cums[:, :, None, :] - cums[:, None, :, :]
                     + lic[:, None, :, :])                     # (B,i,j,H)
    dmat = torch.where(mask, dmat, 0.0)
    scores = torch.einsum("bihp,bjhp->bijh", qc, kc) * scale
    w = scores * dmat
    y_intra = torch.einsum("bijh,bjhp->bihp", w, vc)
    dec = torch.exp(cums)
    y_inter = torch.einsum("bihp,bhpk,bih->bihk", qc, S, dec) * scale
    n_inter = torch.einsum("bihp,bhp,bih->bih", qc, n, dec) * scale
    n_intra = torch.einsum("bijh,bjhp,bihp->bih", w, kc, qc) * scale
    denom = torch.clamp(torch.abs(n_intra + n_inter), min=1.0)[..., None]
    tail = torch.exp(cums[:, -1:, :] - cums + lic)
    S = S * torch.exp(cums[:, -1])[..., None, None] \
        + torch.einsum("bjh,bjhp,bjhk->bhpk", tail, kc, vc)
    n = n * torch.exp(cums[:, -1])[..., None] \
        + torch.einsum("bjh,bjhp->bhp", tail, kc)
    return S, n, (y_intra + y_inter) / denom


def mlstm_forward(p, x, *, cfg, chunk: int = 128,
                  state: Optional[Tuple] = None, mix=None):
    """x: (B, L, d) -> (y, (S, n)). Matrix state per head (hd x hd)."""
    B, L, d = x.shape
    di, H = cfg.d_inner, cfg.heads
    hd = di // H
    chunk = max(1, min(chunk, L))
    z, q, k, v, gates = _mlstm_in(p, x, cfg, mix)
    logi = F.logsigmoid(gates[..., :H])                        # (B,L,H)
    logf = F.logsigmoid(gates[..., H:])
    scale = hd ** -0.5

    nc = L // chunk
    S = (torch.zeros((B, H, hd, hd), dtype=F32, device=x.device)
         if state is None else state[0])
    n = (torch.zeros((B, H, hd), dtype=F32, device=x.device)
         if state is None else state[1])
    ys = []
    for qc, kc, vc, lic, lfc in zip(*(_chunks(t, nc, chunk)
                                      for t in (q, k, v, logi, logf))):
        S, n, y = remat(_mlstm_chunk, S, n, qc, kc, vc, lic, lfc, scale)
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, L, di).to(x.dtype)
    return _mlstm_out(p, y, z, x), (S, n)


def mlstm_decode(p, x, state, *, cfg, mix=None):
    B = x.shape[0]
    di, H = cfg.d_inner, cfg.heads
    hd = di // H
    S, n = state
    z, q, k, v, gates = _mlstm_in(p, x, cfg, mix)
    q, k, v = (t[:, 0].to(F32) for t in (q, k, v))             # (B,H,hd)
    gates = gates[:, 0]
    i = torch.exp(F.logsigmoid(gates[..., :H]))
    f = torch.exp(F.logsigmoid(gates[..., H:]))
    S = S * f[..., None, None] + i[..., None, None] \
        * torch.einsum("bhp,bhk->bhpk", k, v)
    n = n * f[..., None] + i[..., None] * k
    scale = hd ** -0.5
    y = torch.einsum("bhp,bhpk->bhk", q, S) * scale
    denom = torch.clamp(
        torch.abs(torch.einsum("bhp,bhp->bh", q, n) * scale), min=1.0)
    y = (y / denom[..., None]).reshape(B, 1, di).to(x.dtype)
    return _mlstm_out(p, y, z, x), (S, n)


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, scanned)
# ---------------------------------------------------------------------------

def slstm_forward(p, x, *, cfg, state: Optional[Tuple] = None,
                  gather=None):
    """x: (B, L, d). Stabilized exponential gating; recurrent h feedback.
    Returns (y, (h, c, n, m)); the state has the width of `w_rec`'s four
    gate blocks (d, or a model rank's d / tp under a mesh)."""
    B, L, _ = x.shape
    d = p["w_rec"].shape[1] // 4
    gx = torch.matmul(x, p["w_in"]).to(F32)                   # (B,L,4d)
    w_rec = p["w_rec"].to(F32)
    if state is None:
        z0 = torch.zeros((B, d), dtype=F32, device=x.device)
        state = (z0, z0, z0, z0)
    h, c, n, m = state
    hs = []
    for t in range(L):
        g = gx[:, t] + torch.matmul(h if gather is None else gather(h),
                                    w_rec)
        ii, ff, zz, oo = g.chunk(4, dim=-1)
        m_new = torch.maximum(ff + m, ii)
        i_t = torch.exp(ii - m_new)
        f_t = torch.exp(ff + m - m_new)
        c = f_t * c + i_t * torch.tanh(zz)
        n = f_t * n + i_t
        h = torch.sigmoid(oo) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)
    return torch.matmul(y, p["w_out"]), (h, c, n, m)


def slstm_decode(p, x, state, *, cfg, gather=None):
    return slstm_forward(p, x, cfg=cfg, state=state, gather=gather)
