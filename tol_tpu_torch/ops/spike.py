"""Partitioned block-tridiagonal solves (SPIKE / nested block dissection;
port of ``tol_tpu/ops/spike.py``).

The chain of n blocks is cut into K segments of length L (identity-padded
to K*L).  The L-1 interior blocks of every segment are eliminated by one
sequential sweep of L-1 steps that runs over all segments (and lanes) at
once; that leaves the K segment separators, a block-tridiagonal chain of
length K solved by cyclic reduction (``ops/blocktri.py``).  The
elimination depth is O(L + log K), against O(n) for the sequential chain.

Plain torch, no kernel of its own.  Blocks sit on axis -3: ``M``, ``O``
(..., n, b, b), ``f`` (..., n, b, m); leading axes are batch.  Same
symmetric convention as ``cr_factor``:
``O_{i-1}^T x_{i-1} + M_i x_i + O_i x_{i+1} = f_i``.  Non-SPD pivots
surface as NaN.
"""

from __future__ import annotations

import torch

from tol_tpu_torch.ops.blocktri import cr_factor, cr_solve
from tol_tpu_torch.ops.smallalg import bmm, bmm_tn, spd_inverse


def _pad_blocks(x, count, eye=False):
    """Append ``count`` zero (or identity) blocks on the block axis (-3)."""
    if count == 0:
        return x
    pad = torch.zeros(*x.shape[:-3], count, *x.shape[-2:], dtype=x.dtype,
                      device=x.device)
    if eye:
        pad = pad + torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=-3)


def spike_factor(M, O, L: int = 10):
    """Factor the chain.  ``M``: (..., n, b, b) diagonal blocks; ``O``:
    (..., n, b, b) with ``O[i]`` coupling x_i to x_{i+1} (``O[n-1]``
    ignored).  ``L``: segment length (the last block of each segment is a
    separator).  Returns an opaque factor for :func:`spike_solve`."""
    if L < 2:
        raise ValueError("segment length L must be >= 2 (every segment needs "
                         "at least one interior block; use cr_factor for a "
                         "pure separator chain)")
    n, b = M.shape[-3], M.shape[-1]
    lead = M.shape[:-3]
    K = -(-n // L)
    M = _pad_blocks(M, K * L - n, eye=True)
    O = _pad_blocks(O, K * L - n).clone()
    O[..., K * L - 1, :, :] = 0.0
    zeros = lambda *s: torch.zeros(*lead, *s, dtype=M.dtype, device=M.device)

    Mk = M.reshape(*lead, K, L, b, b)
    Ok = O.reshape(*lead, K, L, b, b)
    # interior couplings j -> j+1 (none for the last interior row)
    Oi = Ok[..., : L - 1, :, :].clone()
    Oi[..., L - 2, :, :] = 0.0
    UR = Ok[..., L - 2, :, :]                   # row L-2 -> separator s_k
    ULT = torch.cat([zeros(1, b, b),            # O[kL-1]^T; none for segment 0
                     Ok[..., :-1, L - 1, :, :].transpose(-1, -2)], dim=-3)
    Ms = Mk[..., L - 1, :, :]

    # Column block W_j (..., K, b, 2b): [UL^T at j = 0 | UR at j = L-2].
    W = zeros(K, L - 1, b, 2 * b)
    W[..., 0, :, :b] = ULT
    W[..., L - 2, :, b:] += UR

    dcorr, wcorr = zeros(K, b, b), zeros(K, b, 2 * b)
    S2 = zeros(K, 2 * b, 2 * b)
    Dinvs, t2s, tWs = [], [], []
    for j in range(L - 1):
        Oj = Oi[..., j, :, :]
        Wt = W[..., j, :, :] - wcorr
        Dinv = spd_inverse(Mk[..., j, :, :] - dcorr)
        tW = bmm(Dinv, Wt)
        t2 = bmm(Dinv, Oj)
        S2 = S2 + bmm_tn(Wt, tW)
        dcorr, wcorr = bmm_tn(Oj, t2), bmm_tn(Oj, tW)
        Dinvs.append(Dinv)
        t2s.append(t2)
        tWs.append(tW)

    # Reduced separator chain from the Schur blocks.
    S2n = torch.cat([S2[..., 1:, :, :], zeros(1, 2 * b, 2 * b)], dim=-3)
    Mred = Ms - S2[..., b:, b:] - S2n[..., :b, :b]
    Ored = -S2n[..., :b, b:]                    # couples s_k -> s_{k+1}
    return (n, K, L, Dinvs, t2s, tWs, Oi, cr_factor(Mred, Ored))


def spike_solve(factor, f):
    """Solve the factored chain for ``f``: (..., n, b, m) -> (..., n, b, m)."""
    n, K, L, Dinvs, t2s, tWs, Oi, red = factor
    b, m = f.shape[-2], f.shape[-1]
    lead = f.shape[:-3]
    zeros = lambda *s: torch.zeros(*lead, *s, dtype=f.dtype, device=f.device)
    fk = _pad_blocks(f, K * L - n).reshape(*lead, K, L, b, m)

    rcorr, acc = zeros(K, b, m), zeros(K, 2 * b, m)
    trs = []
    for j in range(L - 1):
        rt = fk[..., j, :, :] - rcorr
        tr = bmm(Dinvs[j], rt)
        # W~^T D^-1 r~ = (D^-1 W~)^T r~ (D symmetric)
        acc = acc + bmm_tn(tWs[j], rt)
        rcorr = bmm_tn(Oi[..., j, :, :], tr)
        trs.append(tr)

    accn = torch.cat([acc[..., 1:, :, :], zeros(1, 2 * b, m)], dim=-3)
    g = fk[..., L - 1, :, :] - acc[..., b:, :] - accn[..., :b, :]
    s = cr_solve(red, g)                        # (..., K, b, m) separators

    # beta = [s_{k-1}; s_k] per segment for the interior back-substitution
    beta = torch.cat([torch.cat([zeros(1, b, m), s[..., :-1, :, :]], dim=-3),
                      s], dim=-2)
    x = zeros(K, b, m)
    xs = [None] * (L - 1)
    for j in range(L - 2, -1, -1):
        x = trs[j] - bmm(tWs[j], beta) - bmm(t2s[j], x)
        xs[j] = x
    X = torch.stack(xs + [s], dim=-3)           # (..., K, L, b, m)
    return X.reshape(*lead, K * L, b, m)[..., :n, :, :]
