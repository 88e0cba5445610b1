"""Structured KKT backend: an O(T) block factorization of the full
collocation saddle system (port of ``tol_tpu/solver/kkt_structured.py``).

The unknowns are ordered as a chain of per-interval blocks
``v_i = (dy_{i-1}, dz_i)`` (19 = 8 duals + 11 primals) bordered by the
coupling set ``beta = (dz_0, d_dt, ds, dw)``: a block-tridiagonal +
arrowhead system.  One forward sweep eliminates the chain (per step one
11x11 Cholesky of the node block Q_i, one 8x8 Cholesky of the negated dual
Schur block ``Y_i - (Q_i^-1)[:8, :8]``, a few small products) and
accumulates the Schur complement on the border; a small dense solve and a
backward sweep recover the step.  Unlike the condensed backend it takes
``delta_c = 0``.

Plain torch, no kernel of its own; the sweeps are loops over the T blocks
on (B, ...) tensors.  Every tensor carries the lane axis B first.
"""

from __future__ import annotations

import numpy as np
import torch

from tol_tpu_torch.models.dynamics import NUM_STATES, NUM_VARS
from tol_tpu_torch.ops.smallalg import chol_unrolled, tri_solve_unrolled
from tol_tpu_torch.solver.canonical import CanonicalNLP
from tol_tpu_torch.solver.kkt_condensed import derivative_blocks

NS, NV = NUM_STATES, NUM_VARS
NBLK = NS + NV  # 19


def _cho_solve(L, X):
    """Solve A X = B given L = chol(A) (lower)."""
    return tri_solve_unrolled(L, tri_solve_unrolled(L, X, lower=True),
                              lower=True, trans=True)


def make_structured_kkt(can: CanonicalNLP, convexify: bool = True):
    """Returns kkt_solve(v, y, sigma, delta_w, delta_c, rhs_v, rhs_c) ->
    (dv, dy) over lanes.

    ``convexify`` (default) makes each per-node Hessian block positive
    definite by a saddle-free eigenvalue flip (|lambda| with a floor): the
    chain factorization needs PD node blocks, and with an exact indefinite
    Hessian its Cholesky gives NaN.  Pass False to compare the exact system
    with the dense backend."""
    nlp = can.nlp
    T, nb, n_s = nlp.T, nlp.nb, can.n_slack
    nB = NV + 1 + n_s + nb  # border width: z0, dt, s, w
    sl_z0 = slice(0, NV)
    sl_dt = NV
    sl_s = slice(NV + 1, NV + 1 + n_s)
    sl_w = slice(NV + 1 + n_s, nB)

    Gs_np = np.zeros((nb, n_s))
    for j, r in enumerate(np.flatnonzero(nlp.boundary_is_ineq)):
        Gs_np[r, j] = 1.0

    node_hess, border_hess, defect_jac, bnd_jac = derivative_blocks(nlp)

    def kkt_solve(v, y_all, sigma, delta_w, delta_c, rhs_v, rhs_c, inst=None):
        """``delta_w`` scalar or (B,); ``delta_c`` scalar, (B,) or (B, m)."""
        inst = can.nlp._inst(inst)
        _, _, fixed_all = can.bounds(inst)
        dtype, dev = v.dtype, v.device
        B = v.shape[0]
        m0 = (~fixed_all[1:1 + NV]).to(dtype)
        tt = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
        zeros = lambda *s: torch.zeros(B, *s, dtype=dtype, device=dev)
        eye = torch.eye(NV, dtype=dtype, device=dev)

        dw = torch.broadcast_to(tt(delta_w).reshape(-1), (B,))
        dc = tt(delta_c)
        dc = torch.broadcast_to(dc if dc.dim() == 2 else dc.reshape(-1, 1),
                                (B, NS * T + nb))
        dc_def = dc[:, :NS * T].reshape(B, T, NS)
        dc_bnd = dc[:, NS * T:]
        Z, dt, _ = can.split(v)
        y = y_all[:, :NS * T].reshape(B, T, NS)
        w = y_all[:, NS * T:]

        sig_dt = sigma[:, 0]
        sig_z = sigma[:, 1:1 + (T + 1) * NV].reshape(B, T + 1, NV)
        sig_s = sigma[:, 1 + (T + 1) * NV:]

        r_dt = rhs_v[:, 0]
        r_z = rhs_v[:, 1:1 + (T + 1) * NV].reshape(B, T + 1, NV)
        r_s = rhs_v[:, 1 + (T + 1) * NV:]
        r_c = rhs_c[:, :NS * T].reshape(B, T, NS)
        r_b = rhs_c[:, NS * T:]

        # ---- derivative blocks ----
        u_nodes = torch.cat([Z, dt[:, None, None].expand(B, T + 1, 1)], dim=2)
        y_pad = torch.cat([y, zeros(1, NS)], dim=1)
        Hn = node_hess(u_nodes.reshape(-1, NV + 1), y_pad.reshape(-1, NS),
                       inst).reshape(B, T + 1, NV + 1, NV + 1)
        Q = Hn[..., :NV, :NV]
        if convexify:
            Q = 0.5 * (Q + Q.transpose(-1, -2))
            lam, V = torch.linalg.eigh(Q)
            floor = 1e-8 * (1.0 + lam.abs().amax(-1, keepdim=True))
            lam = torch.maximum(lam.abs(), floor)
            Q = torch.einsum("...ij,...j,...kj->...ik", V, lam, V)
        Q = Q + torch.diag_embed(sig_z) + dw[:, None, None, None] * eye
        qdt = Hn[..., :NV, NV]                      # (B, T+1, 11)
        sig_nodes = Hn[..., NV, NV]                 # (B, T+1)

        A, d = defect_jac(Z[:, :-1].reshape(-1, NV), Z[:, 1:].reshape(-1, NV),
                          dt[:, None].expand(B, T).reshape(-1), inst)
        A = A.reshape(B, T, NS, NV)
        d = d.reshape(B, T, NS)

        Hb = border_hess(torch.cat([Z[:, 0], Z[:, -1], dt[:, None]], dim=1),
                         w, inst)                   # (B, 23, 23)
        G0, GT, Gdt = bnd_jac(Z[:, 0], Z[:, -1], dt, inst)
        Gs = tt(Gs_np)

        # ---- fixed-variable masking on node 0 ----
        Q0_eff = ((Q[:, 0] + Hb[:, :NV, :NV]) * torch.outer(m0, m0)
                  + torch.diag(1.0 - m0))
        q0_eff = (qdt[:, 0] + Hb[:, :NV, 2 * NV]) * m0
        P_T0 = Hb[:, NV:2 * NV, :NV] * m0           # (zT rows, z0 cols)
        A0_eff = A[:, 0] * m0
        G0_eff = G0 * m0

        # ---- border diagonal block ----
        Bd = zeros(nB, nB)
        Bd[:, sl_z0, sl_z0] = Q0_eff
        Bd[:, sl_z0, sl_dt] = q0_eff
        Bd[:, sl_dt, sl_z0] = q0_eff
        Bd[:, sl_dt, sl_dt] = (sig_nodes.sum(1) + Hb[:, 2 * NV, 2 * NV]
                               + sig_dt + dw)
        if n_s:
            Bd[:, sl_s, sl_s] = torch.diag_embed(sig_s + dw[:, None])
            Bd[:, sl_s, sl_w] = Gs.T
            Bd[:, sl_w, sl_s] = Gs
        Bd[:, sl_z0, sl_w] = G0_eff.transpose(1, 2)
        Bd[:, sl_w, sl_z0] = G0_eff
        Bd[:, sl_dt, sl_w] = Gdt
        Bd[:, sl_w, sl_dt] = Gdt
        Bd[:, sl_w, sl_w] = -torch.diag_embed(dc_bnd)

        rB = torch.cat([r_z[:, 0] * m0, r_dt[:, None], r_s, r_b], dim=1)

        # ---- chain inputs, blocks i = 1..T ----
        # W_i: (19, nB + 1) border columns with the rhs column stacked last.
        W = zeros(T, NBLK, nB + 1)
        # y-rows (defect i-1): dt column = d[i-1]; i = 1 gets A0 in z0 cols.
        W[:, :, :NS, sl_dt] = d
        W[:, 0, :NS, sl_z0] = A0_eff
        # z-rows: dt column = q[i]; the last block also carries the border
        # Hessian's (zT, dt) coupling, the z0 corner and the boundary
        # Jacobian.
        W[:, :, NS:, sl_dt] = qdt[:, 1:]
        W[:, T - 1, NS:, sl_dt] += Hb[:, NV:2 * NV, 2 * NV]
        W[:, T - 1, NS:, sl_z0] = P_T0
        W[:, T - 1, NS:, sl_w] = GT.transpose(1, 2)
        W[:, :, :NS, nB] = r_c
        W[:, :, NS:, nB] = r_z[:, 1:]

        # Border-lagrangian curvature on the final node (zT x zT block).
        Q_chain = Q[:, 1:].clone()
        Q_chain[:, T - 1] += Hb[:, NV:2 * NV, NV:2 * NV]
        A_next = torch.cat([A[:, 1:], zeros(1, NS, NV)], dim=1)
        # The carry built at chain step i opens block i+1, whose dual rows
        # are defect i: feed dc shifted by one (the last entry is unused).
        dc_next = torch.cat([dc_def[:, 1:], dc_def[:, -1:]], dim=1)
        # E^T = d defect / d z_{i+1}, transposed: (11, 8)
        Et = torch.eye(NV, NS, dtype=dtype, device=dev).expand(B, NV, NS)

        # ---- forward sweep ----
        Y = -torch.diag_embed(dc_def[:, 0])
        dUy = zeros(NS, nB + 1)
        S_acc = zeros(nB + 1, nB + 1)
        t1s, t2s = [], []
        for i in range(T):
            Ai = A_next[:, i]
            # Apply the pending y-row correction of the previous elimination.
            Wi = torch.cat([W[:, i, :NS] - dUy, W[:, i, NS:]], dim=1)
            L_Q = chol_unrolled(Q_chain[:, i])
            Qinv_b = _cho_solve(L_Q, Wi[:, NS:])            # (11, nB+1)
            Qinv_E = _cho_solve(L_Q, Et)                    # (11, 8)
            L_S = chol_unrolled(Qinv_E[:, :NS] - Y)         # -(Y - Q^-1[:8,:8])
            # t1 = D^-1 W_i
            dy = -_cho_solve(L_S, Wi[:, :NS] - Qinv_b[:, :NS])
            dz = Qinv_b - Qinv_E @ dy
            t1 = torch.cat([dy, dz], dim=1)                 # (19, nB+1)
            # t2 = D^-1 [0; A_i^T]
            Qinv_A = _cho_solve(L_Q, Ai.transpose(1, 2))    # (11, 8)
            dy2 = _cho_solve(L_S, Qinv_A[:, :NS])
            dz2 = Qinv_A - Qinv_E @ dy2
            t2 = torch.cat([dy2, dz2], dim=1)               # (19, 8)
            S_acc = S_acc - Wi.transpose(1, 2) @ t1
            Y = -torch.diag_embed(dc_next[:, i]) - Ai @ dz2
            dUy = Ai @ dz
            t1s.append(t1)
            t2s.append(t2)

        S_border = Bd + S_acc[:, :nB, :nB]
        rhs_border = rB + S_acc[:, :nB, nB]
        # no singularity check: a NaN lane stays NaN and raises nothing
        d_beta = torch.linalg.solve_ex(S_border, rhs_border)[0]

        # ---- backward sweep ----
        dy_next = zeros(NS)
        dvs = [None] * T
        for i in range(T - 1, -1, -1):
            t1, t2 = t1s[i], t2s[i]
            dvs[i] = (t1[:, :, nB]
                      - (t1[:, :, :nB] @ d_beta[..., None])[..., 0]
                      - (t2 @ dy_next[..., None])[..., 0])
            dy_next = dvs[i][:, :NS]
        dvs = torch.stack(dvs, dim=1)                        # (B, T, 19)

        dz0 = d_beta[:, sl_z0] * m0
        dZ = torch.cat([dz0[:, None], dvs[:, :, NS:]], dim=1)
        dv_out = torch.cat([d_beta[:, sl_dt, None], dZ.reshape(B, -1),
                            d_beta[:, sl_s]], dim=1)
        dy_out = torch.cat([dvs[:, :, :NS].reshape(B, -1), d_beta[:, sl_w]],
                           dim=1)
        return dv_out, dy_out

    return kkt_solve
