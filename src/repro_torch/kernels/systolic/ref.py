"""Plain PyTorch versions of the systolic fold kernels, and the
cycle-accurate oracle they are held against.

- `systolic_ws_reference` is the port of the reference's per-cycle scan
  (`repro.kernels.systolic.ref`): weights W[r, c] stay in PE(r, c); stream
  element x[t, r] enters row r at cycle t + r and shifts one column right
  per cycle; each PE adds its product to the psum arriving from above, and
  psums shift one row down per cycle; o[t, c] leaves the bottom of column c
  at cycle t + (R - 1) + c. A Python loop over cycles, for tests only.
- `wavefront_activity_reference` and `total_cycles_ws`: the closed forms.
- `systolic_matmul_reference` and `wavefront_activity_plain`: the plain
  versions of the two CUDA kernels (`systolic.py`), which `ops.py` runs
  for CPU tensors.
- `wavefront_closed_form`: the wavefront kernel's own formulation, O(1)
  per (fold, cycle) in 64-bit arithmetic, held against the plain version
  in the tests and against the kernel on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .._dtypes import DTYPES, refusal

# the input dtypes the fold plane takes (the CUDA kernel's too), in any
# mix
MATMUL_DTYPES = DTYPES


def check_matmul_dtypes(x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    """The output dtype, promote_types(x, w) (equal to jnp.promote_types
    on every accepted pair); TypeError, saying why, for an input dtype the
    fold plane does not take."""
    for t, name in ((x, "x"), (w, "w")):
        if t.dtype not in MATMUL_DTYPES:
            raise TypeError(f"{name} is {t.dtype}: {refusal(t.dtype)}")
    return torch.promote_types(x.dtype, w.dtype)


def systolic_matmul_reference(x: torch.Tensor, w: torch.Tensor
                              ) -> torch.Tensor:
    """O = x @ w for x (T, R), w (R, C) in out = promote_types(x, w), each
    operand first cast to out (as the reference's `jnp.dot` promotes).
    A float out: float32 accumulation, rounded once to out. An integer
    out: exact sums, narrowed to out at the end, which is the reference's
    arithmetic modulo 2^bits (an int8 product of 100 x 3 over 64 rows is
    19,200 mod 256 = 0)."""
    out_dtype = check_matmul_dtypes(x, w)
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"chain")
    if out_dtype.is_floating_point:
        return torch.matmul(x.to(out_dtype).to(torch.float32),
                            w.to(out_dtype).to(torch.float32)).to(out_dtype)
    # modulo 2^32 in int64, 16 rows at a time: a product of two int32
    # values is exact in int64 and its low 32 bits are all an int32 (or
    # narrower) out keeps; torch has no integer matmul on the card
    low = 0xFFFFFFFF
    xl, wl = x.to(out_dtype).long(), w.to(out_dtype).long()
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64,
                      device=x.device)
    for k in range(0, x.shape[1], 16):
        prod = (xl[:, k:k + 16, None] * wl[None, k:k + 16, :]) & low
        acc = (acc + prod.sum(1)) & low
    return acc.to(out_dtype)


def systolic_ws_reference(x: torch.Tensor, w: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(functional result (T, C), active PEs per wavefront cycle
    (T + R + C - 2,) int32), by moving operands through PE registers one
    cycle at a time."""
    T, R = x.shape
    R2, C = w.shape
    if R != R2:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"chain")
    dev = x.device
    n_cycles = T + R + C - 2
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    acc = torch.promote_types(out_dtype, torch.float32)
    wf = w.to(acc)
    rows = torch.arange(R, device=dev)
    x_buf = torch.zeros((R, C), dtype=x.dtype, device=dev)
    v_buf = torch.zeros((R, C), dtype=torch.bool, device=dev)
    psum = torch.zeros((R, C), dtype=acc, device=dev)
    top = torch.zeros((1, C), dtype=acc, device=dev)
    bottoms = torch.empty((n_cycles, C), dtype=acc, device=dev)
    active = torch.empty((n_cycles,), dtype=torch.int32, device=dev)
    for n in range(n_cycles):
        # skewed injection at column 0: row r receives x[n - r, r]
        t_idx = n - rows
        valid_in = (t_idx >= 0) & (t_idx < T)
        x_in = torch.where(valid_in, x[t_idx.clamp(0, T - 1), rows],
                           torch.zeros((), dtype=x.dtype, device=dev))
        # shift right one column
        x_buf = torch.cat([x_in[:, None], x_buf[:, :-1]], dim=1)
        v_buf = torch.cat([valid_in[:, None], v_buf[:, :-1]], dim=1)
        prod = x_buf.to(acc) * wf * v_buf
        # psums shift down one row, accumulating this cycle's products
        psum = torch.cat([top, psum[:-1, :]], dim=0) + prod
        bottoms[n] = psum[-1, :]
        active[n] = v_buf.sum()
    t = torch.arange(T, device=dev)[:, None]
    c = torch.arange(C, device=dev)[None, :]
    out = bottoms[t + (R - 1) + c, c]
    return out.to(out_dtype), active


def wavefront_activity_reference(T: int, R: int, C: int,
                                 device="cpu") -> torch.Tensor:
    """Closed form of active(n) = |{(t, r, c): t + r + c = n}| over the
    fold's T + R + C - 2 wavefront cycles, int32."""
    n = torch.arange(T + R + C - 2, device=device)[:, None]
    r = torch.arange(R, device=device)[None, :]
    lo = torch.clamp_min(n - r - (C - 1), 0)
    hi = torch.clamp_max(n - r, T - 1)
    return torch.clamp_min(hi - lo + 1, 0).sum(dim=1).to(torch.int32)


def wavefront_activity_plain(Ts: torch.Tensor, *, R: int, C: int,
                             n_cycles: int) -> torch.Tensor:
    """The wavefront kernel's function on tensors: (B,) int32 stream lengths
    -> (B, n_cycles) int32 active PEs per cycle, the clamp-sum over rows in
    int32 (cycles past a fold's end are 0)."""
    Ts = Ts.to(torch.int32)
    n = torch.arange(n_cycles, dtype=torch.int32, device=Ts.device)[None, :]
    t_last = Ts[:, None] - 1
    act = torch.zeros((Ts.shape[0], n_cycles), dtype=torch.int32,
                      device=Ts.device)
    for r in range(R):
        lo = torch.clamp_min(n - r - (C - 1), 0)
        hi = torch.minimum(t_last, n - r)
        act += torch.clamp_min(hi - lo + 1, 0)
    return act


def wavefront_closed_form(Ts: torch.Tensor, *, R: int, C: int,
                          n_cycles: int) -> torch.Tensor:
    """Active PEs per cycle, (B,) T -> (B, n_cycles) int32, as the CUDA
    kernel computes it: the points (t, r, c) with t + r + c = n inside the
    T x R x C box (T < 0 taken as 0), by inclusion-exclusion over its three
    upper faces, eight terms g(n - off) with g(k) = (k + 1)(k + 2) / 2 the
    non-negative triples summing to k. The terms are int64 (they pass
    int32 once n - off exceeds about 46,000); cut to int32 their sum equals
    the kernel's, which adds the same terms modulo 2^32, grouped as
    F(n) - F(n - T)."""
    n = torch.arange(n_cycles, dtype=torch.int64, device=Ts.device)[None, :]
    T = Ts.to(torch.int64).clamp_min(0)[:, None]
    act = torch.zeros((Ts.shape[0], n_cycles), dtype=torch.int64,
                      device=Ts.device)
    for sign, off in ((1, 0), (-1, T), (-1, R), (-1, C), (1, T + R),
                      (1, T + C), (1, R + C), (-1, T + R + C)):
        a = torch.clamp_min(n - off + 1, 0)
        act += sign * (a * (a + 1) // 2)
    return act.to(torch.int32)


def total_cycles_ws(T: int, R: int, C: int) -> int:
    """Fold runtime incl. R preload cycles: 2R + C + T - 2 (paper Eq. 1)."""
    return 2 * R + C + T - 2
