"""Dense KKT backend, the correctness oracle (port of
``tol_tpu/solver/kkt_dense.py``).

Solves, per lane,

    [ H + Sigma + delta_w I    J^T          ] [dv]   [rhs_v]
    [ J                        -delta_c I   ] [dy] = [rhs_c]

with exact derivatives.  O((n+m)^3): for float64 CPU checks only.
"""

from __future__ import annotations

import torch
from torch.func import grad

from tol_tpu_torch.solver.canonical import CanonicalNLP, jacfwd_lanes


def make_dense_kkt(can: CanonicalNLP):
    """Returns kkt_solve(v, y, sigma, delta_w, delta_c, rhs_v, rhs_c) -> (dv, dy)
    over lanes: ``v`` (B, n), ``y`` (B, m)."""

    def hess(v, y, inst):
        lag = lambda vv: (can.f(vv, inst) + (can.c(vv, inst) * y).sum(-1)).sum()
        return jacfwd_lanes(grad(lag), v)

    def jac(v, inst):
        return jacfwd_lanes(lambda vv: can.c(vv, inst), v)

    def kkt_solve(v, y, sigma, delta_w, delta_c, rhs_v, rhs_c, inst=None):
        """``delta_w`` scalar or (B,); ``delta_c`` scalar, (B,) or (B, m)."""
        inst = can.nlp._inst(inst)
        _, _, fixed = can.bounds(inst)
        B, n, m = v.shape[0], can.n, can.m
        H = hess(v, y, inst)
        J = jac(v, inst)
        dw = torch.as_tensor(delta_w, dtype=v.dtype, device=v.device)
        dw = torch.broadcast_to(dw.reshape(-1, 1), (B, 1))
        dc = torch.as_tensor(delta_c, dtype=v.dtype, device=v.device)
        dc = torch.broadcast_to(dc if dc.dim() == 2 else dc.reshape(-1, 1),
                                (B, m))

        K = torch.zeros(B, n + m, n + m, dtype=v.dtype, device=v.device)
        K[:, :n, :n] = H + torch.diag_embed(sigma + dw)
        K[:, :n, n:] = J.transpose(1, 2)
        K[:, n:, :n] = J
        K[:, n:, n:] = -torch.diag_embed(dc)

        fmask = torch.cat([fixed, torch.zeros(m, dtype=torch.bool,
                                              device=v.device)])
        K = torch.where(fmask[:, None] | fmask[None, :], 0.0, K)
        K = K + torch.diag(fmask.to(v.dtype))
        rhs = torch.cat([torch.where(fixed, 0.0, rhs_v), rhs_c], dim=-1)
        sol = torch.linalg.solve(K, rhs)
        return sol[:, :n], sol[:, n:]

    return kkt_solve
