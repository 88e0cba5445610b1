"""Structured KKT backend: an O(T) block factorization of the full
collocation saddle system (port of ``tol_tpu/solver/kkt_structured.py``).

The unknowns are ordered as a chain of per-interval blocks
``v_i = (dy_{i-1}, dz_i)`` (19 = 8 duals + 11 primals) bordered by the
coupling set ``beta = (dz_0, d_dt, ds, dw)``: a block-tridiagonal +
arrowhead system.  One forward sweep eliminates the chain (per step one
11x11 Cholesky of the node block Q_i, one 8x8 Cholesky of the negated dual
Schur block ``Y_i - (Q_i^-1)[:8, :8]``, a few small products) and
accumulates the Schur complement on the border; a small dense solve and a
backward sweep recover the step.

Plain torch, no kernel of its own.  The work of a block that does not
depend on the sweep's carry (the node block's Cholesky and its solves)
runs for all T blocks at once; the loop over the blocks keeps only the
carried 8x8 factorization.  Every tensor carries the lane axis B first.
Nothing in a solve reads the device from the host: a NaN or non-PD block
gives NaN in its lane (the solver's inertia signal) and raises nothing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tol_tpu_torch.models.dynamics import NUM_STATES, NUM_VARS
from tol_tpu_torch.ops.smallalg import (cho_solve_outer, chol_outer,
                                        chol_unrolled, solve_unchecked,
                                        tri_solve_unrolled)
from tol_tpu_torch.solver.canonical import CanonicalNLP
from tol_tpu_torch.solver.kkt_condensed import derivative_blocks

NS, NV = NUM_STATES, NUM_VARS
NBLK = NS + NV  # 19
JACOBI_SWEEPS = {torch.float64: 10, torch.float32: 6}   # fixed: no host test


def _cho_solve(L, X):
    """Solve A X = B given L = chol(A) (lower)."""
    return tri_solve_unrolled(L, tri_solve_unrolled(L, X, lower=True),
                              lower=True, trans=True)


def _round_robin(n: int):
    """The parallel (Brent-Luk) order of ``n`` (even) indices: ``n - 1``
    rounds of ``n / 2`` disjoint pairs, every pair once."""
    ring = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append([tuple(sorted((ring[k], ring[n - 1 - k])))
                       for k in range(n // 2)])
        ring = [ring[0], ring[-1]] + ring[1:-1]
    return rounds


@functools.lru_cache(maxsize=None)
def _jacobi_indices(n: int, device: torch.device):
    """Per round of :func:`_round_robin` over ``n`` (even): the flat (n*n)
    positions of the pairs' (p, p), (q, q), (p, q) entries, and of the
    rotation's (p, p), (q, q), (p, q), (q, p) entries.  Made once per
    device: a tensor built from host data is a copy the stream waits for."""
    out = []
    for pairs in _round_robin(n):
        P = [p for p, _ in pairs]
        Q = [q for _, q in pairs]
        read = ([p * n + p for p in P] + [q * n + q for q in Q]
                + [p * n + q for p, q in pairs])
        write = read + [q * n + p for p, q in pairs]
        out.append((torch.tensor(read, device=device),
                    torch.tensor(write, device=device)))
    return out


def jacobi_eigh(A: torch.Tensor, sweeps: int):
    """Eigenvalues (..., n) and eigenvectors (..., n, n) of the symmetric
    ``A`` (..., n, n) by cyclic Jacobi in the parallel order, a fixed number
    of sweeps and no convergence test (nothing is read back).  An odd n is
    padded by one decoupled zero row and column, which every rotation
    leaves alone (its pairs have a zero off-diagonal: c = 1, s = 0
    exactly).  The order and signs of the eigenvectors are not
    ``eigh``'s; ``V diag(f(lam)) V^T`` is the same.  A NaN block gives NaN."""
    n = A.shape[-1]
    lead = A.shape[:-2]
    N = int(np.prod(lead)) if lead else 1
    m = n + (n % 2)
    a = torch.nn.functional.pad(A.reshape(N, n, n), (0, m - n, 0, m - n))
    V = torch.eye(m, dtype=A.dtype, device=A.device).expand(N, m, m)
    rounds = _jacobi_indices(m, A.device)
    h = m // 2
    for _ in range(sweeps):
        for read, write in rounds:
            g = a.reshape(N, m * m).index_select(1, read)
            app, aqq, apq = g[:, :h], g[:, h:2 * h], g[:, 2 * h:]
            # the rotation that zeroes a_pq: t = tan(theta), the smaller root
            tau = (aqq - app) / (2.0 * apq)
            at = tau.abs()
            t = 1.0 / (at + torch.sqrt(1.0 + at * at))
            t = torch.where(tau < 0, -t, t)
            t = torch.where(apq == 0, 0.0, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            J = torch.zeros(N, m * m, dtype=A.dtype, device=A.device)
            J = J.index_copy(1, write, torch.cat([c, c, s, -s], dim=1))
            J = J.reshape(N, m, m)
            a = J.mT @ a @ J
            V = V @ J
    lam = a.diagonal(dim1=-2, dim2=-1)[:, :n]
    return lam.reshape(*lead, n), V[:, :n, :n].reshape(*lead, n, n)


def convexify_blocks(Q: torch.Tensor) -> torch.Tensor:
    """The reference's saddle-free flip of symmetric blocks (..., n, n):
    ``V max(|lam|, floor) V^T`` with ``floor = 1e-8 (1 + max |lam|)``."""
    lam, V = jacobi_eigh(Q, JACOBI_SWEEPS[Q.dtype])
    floor = 1e-8 * (1.0 + lam.abs().amax(-1, keepdim=True))
    lam = torch.maximum(lam.abs(), floor)
    return torch.einsum("...ij,...j,...kj->...ik", V, lam, V)


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
    # on the device once: kkt_solve runs inside every step
    z_lo0 = nlp.inst0.z_lo
    Gs = torch.as_tensor(Gs_np, dtype=z_lo0.dtype, device=z_lo0.device)

    node_blocks, border_hess, _, bnd_jac = derivative_blocks(can)

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
        Hn, A, d = node_blocks(Z, dt, y, inst)
        Q = Hn[..., :NV, :NV]
        if convexify:
            Q = convexify_blocks(0.5 * (Q + Q.transpose(-1, -2)))
        Q = Q + torch.diag_embed(sig_z) + dw[:, None, None, None] * eye
        qdt = Hn[..., :NV, NV]                      # (B, T+1, 11)
        sig_nodes = Hn[..., NV, NV]                 # (B, T+1)

        Hb = border_hess(torch.cat([Z[:, 0], Z[:, -1], dt[:, None]], dim=1),
                         w, inst)                   # (B, 23, 23)
        G0, GT, Gdt = bnd_jac(Z[:, 0], Z[:, -1], dt, inst)

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
        Et = torch.eye(NV, NS, dtype=dtype, device=dev).expand(B, T, NV, NS)

        # ---- what no carry enters, all T blocks at once ----
        # Q_i^-1 [W_i's z-rows | E^T | A_i^T]
        L_Q = chol_unrolled(Q_chain)
        QX = _cho_solve(L_Q, torch.cat([W[:, :, NS:], Et,
                                        A_next.transpose(-1, -2)], dim=-1))
        Qinv_E = QX[..., nB + 1:nB + 1 + NS]                 # (B, T, 11, 8)
        Qinv_bA = torch.cat([QX[..., :nB + 1], QX[..., nB + 1 + NS:]], dim=-1)
        Qinv_b8 = QX[:, :, :NS, :nB + 1]
        nQinv_A8 = -QX[:, :, :NS, nB + 1 + NS:]
        Y_next = -torch.diag_embed(dc_next)

        # ---- forward sweep: the carried 8x8 factorization ----
        Y = -torch.diag_embed(dc_def[:, 0])
        dUy = zeros(NS, nB + 1)
        Wys, dyys, dzzs = [], [], []
        for i in range(T):
            # Apply the pending y-row correction of the previous elimination.
            Wy = W[:, i, :NS] - dUy
            L_S = chol_outer(Qinv_E[:, i, :NS] - Y)     # -(Y - Q^-1[:8,:8])
            # [dy | dy2] = -(L_S L_S^T)^-1 [W_y - Qinv_b | -Qinv_A]
            dyy = -cho_solve_outer(L_S, torch.cat(
                [Wy - Qinv_b8[:, i], nQinv_A8[:, i]], dim=-1))
            dzz = Qinv_bA[:, i] - Qinv_E[:, i] @ dyy      # [dz | dz2]
            AZ = A_next[:, i] @ dzz
            dUy = AZ[..., :nB + 1]
            Y = Y_next[:, i] - AZ[..., nB + 1:]
            Wys.append(Wy)
            dyys.append(dyy)
            dzzs.append(dzz)
        # t1 = D^-1 W_i and t2 = D^-1 [0; A_i^T], side by side
        t12 = torch.cat([torch.stack(dyys, dim=1), torch.stack(dzzs, dim=1)],
                        dim=2)                            # (B, T, 19, nB+9)
        Wfull = torch.cat([torch.stack(Wys, dim=1), W[:, :, NS:]], dim=2)
        S_acc = -(Wfull.transpose(-1, -2) @ t12[..., :nB + 1]).sum(1)

        S_border = Bd + S_acc[:, :nB, :nB]
        rhs_border = rB + S_acc[:, :nB, nB]
        # no singularity check: a NaN lane stays NaN and raises nothing
        d_beta = solve_unchecked(S_border, rhs_border)

        # ---- backward sweep ----
        t1b = t12[..., nB] - (t12[..., :nB] @ d_beta[:, None, :, None])[..., 0]
        t2s = t12[..., nB + 1:]
        dy_next = zeros(NS)
        dvs = [None] * T
        for i in range(T - 1, -1, -1):
            dvs[i] = t1b[:, i] - (t2s[:, i] @ dy_next[..., None])[..., 0]
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
