"""Block-tridiagonal solves by cyclic reduction (port of
``tol_tpu/ops/blocktri.py``).

The chain ``O_{i-1}^T x_{i-1} + M_i x_i + O_i x_{i+1} = f_i`` is reduced by
eliminating all odd blocks per level (log2(n) levels).  Blocks sit on axis
-3: ``M``, ``O`` (..., n, b, b), ``f`` (..., n, b, m); leading axes are
batch.  This is the plain reference that the crp kernels are checked
against.
"""

from __future__ import annotations

import torch

from tol_tpu_torch.ops.smallalg import bmm, bmm_tn, spd_inverse


def _pad_pow2(M, O, n):
    """Pad the chain to a power of two with identity blocks."""
    p = 1
    while p < n:
        p *= 2
    if p == n:
        return M, O, n
    b = M.shape[-1]
    lead = M.shape[:-3]
    eye = torch.eye(b, dtype=M.dtype, device=M.device).expand(*lead, p - n, b, b)
    M = torch.cat([M, eye], dim=-3)
    O = torch.cat([O, torch.zeros(*lead, p - n, b, b, dtype=M.dtype,
                                  device=M.device)], dim=-3)
    return M, O, p


def _add_from_second(x, d):
    """``x.at[1:].add(d)`` on the block axis (-3)."""
    return torch.cat([x[..., :1, :, :], x[..., 1:, :, :] + d], dim=-3)


def cr_factor(M, O):
    """Factor the chain; ``O[i]`` couples x_i to x_{i+1} (``O[n-1]`` is
    ignored).  Returns an opaque factor for :func:`cr_solve`."""
    n = M.shape[-3]
    M, O, p = _pad_pow2(M, O, n)
    O = O.clone()
    O[..., p - 1, :, :] = 0.0
    levels = []
    while p > 1:
        Minv = spd_inverse(M[..., 1::2, :, :])
        OL = O[..., 0::2, :, :]
        OR = O[..., 1::2, :, :]
        MinvOLT = bmm(Minv, OL.transpose(-1, -2))
        MinvOR = bmm(Minv, OR)
        M_next = M[..., 0::2, :, :] - bmm(OL, MinvOLT)
        M_next = _add_from_second(
            M_next, -bmm_tn(OR[..., :-1, :, :], MinvOR[..., :-1, :, :]))
        O_next = -bmm(OL, MinvOR)
        levels.append((Minv, OL, OR))
        M, O = M_next, O_next
        p //= 2
    root_inv = spd_inverse(M[..., 0, :, :])
    return (n, levels, root_inv)


def cr_solve(factor, f):
    """Solve the factored chain for ``f`` (..., n, b, m)."""
    n, levels, root_inv = factor
    b = f.shape[-2]
    p = (2 ** len(levels)) if levels else 1
    if p != n:
        f = torch.cat([f, torch.zeros(*f.shape[:-3], p - n, b, f.shape[-1],
                                      dtype=f.dtype, device=f.device)], dim=-3)
    stack = []
    for (Minv, OL, OR) in levels:
        g = bmm(Minv, f[..., 1::2, :, :])
        f_even = f[..., 0::2, :, :] - bmm(OL, g)
        f_even = _add_from_second(
            f_even, -bmm_tn(OR[..., :-1, :, :], g[..., :-1, :, :]))
        stack.append(f)
        f = f_even
    x = bmm(root_inv, f[..., 0, :, :])[..., None, :, :]
    for (Minv, OL, OR), f_orig in zip(reversed(levels), reversed(stack)):
        rhs = f_orig[..., 1::2, :, :] - bmm_tn(OL, x)
        rhs = torch.cat([rhs[..., :-1, :, :]
                         - bmm(OR[..., :-1, :, :], x[..., 1:, :, :]),
                         rhs[..., -1:, :, :]], dim=-3)
        x_odd = bmm(Minv, rhs)
        m = f_orig.shape[-3]
        x = torch.stack([x, x_odd], dim=-3).reshape(*x.shape[:-3], m, b, -1)
    return x[..., :n, :, :]
