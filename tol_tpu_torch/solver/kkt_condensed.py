"""Condensed-primal structured KKT backend (port of
``tol_tpu/solver/kkt_condensed.py``).

Solves, per lane, the regularized saddle system

    [ H + Sigma + delta_w I   J^T          ] [dv]   [rhs_v]
    [ J                       -diag(Gamma) ] [dy] = [rhs_c]

by eliminating the duals first, leaving the condensed primal system
``(H~ + J^T Gamma^-1 J) dv = rhs_v + J^T Gamma^-1 rhs_c``: block-tridiagonal
in the node variables plus a small border (z_0, dt, slacks).  ``chain``
names how the block-tridiagonal part is factored and solved:

    "crp"     cyclic reduction through the CUDA pass kernels K1-K3
              (``ops/crkern.py``), the border columns eliminated in the
              factor pass; the flagship's chain
    "pallas"  the fused sequential chain through the CUDA kernels K6-K8
              (``ops/chainkern.py``); the name is the one the reference's
              configurations carry for its Pallas kernels
    "scan"    the same sequential elimination as a loop over the blocks in
              plain torch
    "cr"      cyclic reduction in plain torch (``ops/blocktri.py``)
    "spike"   partitioned elimination in plain torch (``ops/spike.py``)

``refine`` saddle-level refinement passes reuse the factor.

Every tensor carries the lane axis B first.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad

from tol_tpu_torch.models.dynamics import NUM_STATES, NUM_VARS
from tol_tpu_torch.ops.blocktri import cr_factor, cr_solve
from tol_tpu_torch.ops.chainkern import (chain_back_sub, chain_eliminate,
                                         chain_rhs_forward)
from tol_tpu_torch.ops.crkern import crp_factor_solve, crp_pad_rhs, crp_solve
from tol_tpu_torch.ops.smallalg import (bmm_tn, bmv, bmv_t, cho_solve_outer,
                                        chol_outer, chol_unrolled,
                                        tri_solve_unrolled)
from tol_tpu_torch.ops.spike import spike_factor, spike_solve
from tol_tpu_torch.solver.canonical import CanonicalNLP, jacfwd_lanes
from tol_tpu_torch.utils.profiling import span

NS, NV = NUM_STATES, NUM_VARS


CHAINS = ("crp", "pallas", "scan", "cr", "spike")


def derivative_blocks(nlp):
    """The per-node and border derivative blocks of the collocation KKT
    system, all lanes (and nodes) at once: gradients by reverse mode over
    the lane sum, Jacobians/Hessians by one forward-mode pass over a replica
    axis (canonical.jacfwd_lanes).  Returns (node_hess, border_hess,
    defect_jac, bnd_jac)."""
    def node_hess(u, y, inst):
        """(N, 12) node points [z, dt], (N, 8) defect multipliers ->
        (N, 12, 12) Hessians of node_cost + y . defect(z, 0, dt)."""
        def lag_grad(uu):
            def lag(w):
                z, dt = w[..., :NV], w[..., NV]
                return (nlp.node_cost(z, dt, inst) + (y * nlp.defect(
                    z, torch.zeros_like(z), dt, inst)).sum(-1)).sum()
            return grad(lag)(uu)
        return jacfwd_lanes(lag_grad, u)

    def border_hess(u, w, inst):
        """(B, 23) [z0, zT, dt], (B, nb) -> (B, 23, 23)."""
        def lag_grad(uu):
            def lag(x):
                z0, zT, dt = x[..., :NV], x[..., NV:2 * NV], x[..., 2 * NV]
                return (nlp.global_cost(z0, zT, dt, inst)
                        + (w * nlp.boundary(z0, zT, dt, inst)).sum(-1)).sum()
            return grad(lag)(uu)
        return jacfwd_lanes(lag_grad, u)

    def defect_jac(z_i, z_ip1, dt, inst):
        """(N, 11), (N, 11), (N,) -> dDefect/dz_i (N, 8, 11), dDefect/ddt (N, 8)."""
        J = jacfwd_lanes(lambda u: nlp.defect(u[..., :NV], z_ip1, u[..., NV],
                                              inst),
                         torch.cat([z_i, dt[:, None]], dim=1))
        return J[..., :NV], J[..., NV]

    def bnd_jac(z0, zT, dt, inst):
        """(B, 11), (B, 11), (B,) -> boundary Jacobian blocks G0, GT, Gdt."""
        J = jacfwd_lanes(lambda u: nlp.boundary(u[..., :NV], u[..., NV:2 * NV],
                                                u[..., 2 * NV], inst),
                         torch.cat([z0, zT, dt[:, None]], dim=1))
        return J[..., :NV], J[..., NV:2 * NV], J[..., 2 * NV]
    return node_hess, border_hess, defect_jac, bnd_jac


def make_condensed_kkt(can: CanonicalNLP, refine: int = 2, chain: str = "crp"):
    """Condensed KKT solver; ``chain`` is one of :data:`CHAINS` (see the
    module docstring)."""
    if chain not in CHAINS:
        raise ValueError(f"unknown chain {chain!r}; expected one of {CHAINS}")
    nlp = can.nlp
    T, nb, n_s = nlp.T, nlp.nb, can.n_slack
    nB = NV + 1 + n_s
    n_pad = 1
    while n_pad < T:
        n_pad *= 2

    ineq_idx = np.flatnonzero(nlp.boundary_is_ineq)
    Gs_np = np.zeros((nb, n_s))
    for j, r in enumerate(ineq_idx):
        Gs_np[r, j] = 1.0
    # on the device once: prepare() runs inside every step
    z_lo0 = nlp.inst0.z_lo
    Gs_dev = torch.as_tensor(Gs_np, dtype=z_lo0.dtype, device=z_lo0.device)

    node_hess, border_hess, defect_jac, bnd_jac = derivative_blocks(nlp)

    def kkt_prepare(v, y_all, sigma, delta_w, delta_c, inst=None):
        """Assemble + factorize at the current iterates ``v`` (B, n);
        returns ``apply(rhs_v, rhs_c) -> (dv, dy)`` solving against the
        stored factorization with ``refine`` refinement passes.
        ``delta_w`` is a scalar or (B,); ``delta_c`` a scalar, (B,) or
        (B, m), strictly positive."""
        with span("kkt.blocks"):
            inst = can.nlp._inst(inst)
            _, _, fixed_all = can.bounds(inst)
            dtype, dev = v.dtype, v.device
            B = v.shape[0]
            m0 = (~fixed_all[1:1 + NV]).to(dtype)
            eye = torch.eye(NV, dtype=dtype, device=dev)
            tt = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)

            dw = torch.broadcast_to(tt(delta_w).reshape(-1), (B,))
            dc = tt(delta_c)
            gam = torch.broadcast_to(dc if dc.dim() == 2 else dc.reshape(-1, 1),
                                     (B, NS * T + nb))
            Gd = gam[:, :NS * T].reshape(B, T, NS)
            Gb = gam[:, NS * T:]
            Dd = 1.0 / Gd
            Db = 1.0 / Gb

            Z, dt, s = can.split(v)
            y = y_all[:, :NS * T].reshape(B, T, NS)
            w = y_all[:, NS * T:]

            sig_dt = sigma[:, 0]
            sig_z = sigma[:, 1:1 + (T + 1) * NV].reshape(B, T + 1, NV)
            sig_s = sigma[:, 1 + (T + 1) * NV:]

            # ---- Lagrangian/Jacobian blocks ----
            u_nodes = torch.cat([Z, dt[:, None, None].expand(B, T + 1, 1)], dim=2)
            y_pad = torch.cat([y, torch.zeros(B, 1, NS, dtype=dtype, device=dev)],
                              dim=1)
            Hn = node_hess(u_nodes.reshape(-1, NV + 1), y_pad.reshape(-1, NS),
                           inst).reshape(B, T + 1, NV + 1, NV + 1)
            Q = (Hn[..., :NV, :NV] + torch.diag_embed(sig_z)
                 + dw[:, None, None, None] * eye)
            qdt = Hn[..., :NV, NV]
            sig_nodes = Hn[..., NV, NV]

            A, d = defect_jac(Z[:, :-1].reshape(-1, NV), Z[:, 1:].reshape(-1, NV),
                              dt[:, None].expand(B, T).reshape(-1), inst)
            A = A.reshape(B, T, NS, NV)
            d = d.reshape(B, T, NS)

            ub_pt = torch.cat([Z[:, 0], Z[:, -1], dt[:, None]], dim=1)
            Hb = border_hess(ub_pt, w, inst)
            G0, GT, Gdt = bnd_jac(Z[:, 0], Z[:, -1], dt, inst)
            G0 = G0 * m0
            Gs = Gs_dev.to(dtype=dtype, device=dev)
            A = torch.cat([A[:, :1] * m0, A[:, 1:]], dim=1)

            mm0 = torch.outer(m0, m0)
            Hb00 = Hb[:, :NV, :NV] * mm0
            HbTT = Hb[:, NV:2 * NV, NV:2 * NV]
            HbT0 = Hb[:, NV:2 * NV, :NV] * m0
            Hb0dt = Hb[:, :NV, 2 * NV] * m0
            HbTdt = Hb[:, NV:2 * NV, 2 * NV]
            sig_dt_tot = sig_nodes.sum(1) + Hb[:, 2 * NV, 2 * NV] + sig_dt + dw

        # ---------------- saddle operator application ----------------

        def apply_saddle(dv, dy):
            dZ = dv[:, 1:1 + (T + 1) * NV].reshape(B, T + 1, NV)
            dZ = torch.cat([dZ[:, :1] * m0, dZ[:, 1:]], dim=1)
            ddt = dv[:, 0]
            ds = dv[:, 1 + (T + 1) * NV:]
            dyd = dy[:, :NS * T].reshape(B, T, NS)
            dyb = dy[:, NS * T:]

            r1_z = bmv(Q, dZ) + qdt * ddt[:, None, None]
            r1_z[:, :-1] += bmv_t(A, dyd)
            r1_z[:, 1:, :NS] += dyd
            r1_z[:, 0] += (bmv(Hb00, dZ[:, 0]) + bmv_t(HbT0, dZ[:, T])
                           + Hb0dt * ddt[:, None] + bmv_t(G0, dyb))
            r1_z[:, T] += (bmv(HbTT, dZ[:, T]) + bmv(HbT0, dZ[:, 0])
                           + HbTdt * ddt[:, None] + bmv_t(GT, dyb))
            r1_z[:, 0] *= m0
            r1_dt = ((qdt * dZ).sum((1, 2)) + sig_dt_tot * ddt
                     + (Hb0dt * dZ[:, 0]).sum(1) + (HbTdt * dZ[:, T]).sum(1)
                     + (d * dyd).sum((1, 2)) + (Gdt * dyb).sum(1))
            r1_s = (sig_s + dw[:, None]) * ds + bmv_t(Gs, dyb)
            r2_d = (bmv(A, dZ[:, :-1]) + dZ[:, 1:, :NS]
                    + d * ddt[:, None, None] - Gd * dyd)
            r2_b = (bmv(G0, dZ[:, 0]) + bmv(GT, dZ[:, T]) + Gdt * ddt[:, None]
                    - Gb * dyb)
            if n_s:
                r2_b = r2_b + bmv(Gs, ds)
            r1 = torch.cat([r1_dt[:, None], r1_z.reshape(B, -1), r1_s], dim=1)
            r2 = torch.cat([r2_d.reshape(B, -1), r2_b], dim=1)
            return r1, r2

        # -------- condensed factorization (rhs-independent, done once) ----

        with span("kkt.condense"):
            ADd = A * Dd[..., None]
            AtDdA = bmm_tn(A, ADd)
            AtDd_d = bmv_t(A, Dd * d)
            zpad = torch.zeros(B, T, NV - NS, dtype=dtype, device=dev)
            EtDd_d = torch.cat([Dd * d, zpad], dim=2)
            dtd = (Dd * d * d).sum((1, 2))

            G0Db = G0 * Db[..., None]
            GTDb = GT * Db[..., None]
            GsDb = Gs * Db[..., None]
            GdtDb = Gdt * Db

            diagD = torch.zeros(B, T + 1, NV, NV, dtype=dtype, device=dev)
            diagD[:, :-1] += AtDdA
            diagD[:, 1:] += torch.diag_embed(torch.cat([Dd, zpad], dim=2))
            M = Q + diagD
            M[:, T] += HbTT + bmm_tn(GT, GTDb)

            qcol = qdt.clone()
            qcol[:, :-1] += AtDd_d
            qcol[:, 1:] += EtDd_d
            qcol[:, T] += HbTdt + bmv_t(GT, GdtDb)

            O = torch.cat([ADd.transpose(2, 3),
                           torch.zeros(B, T, NV, NV - NS, dtype=dtype, device=dev)],
                          dim=3)

            B0 = torch.zeros(B, nB, nB, dtype=dtype, device=dev)
            Q0_eff = ((M[:, 0] + Hb00 + bmm_tn(G0, G0Db)) * mm0
                      + torch.diag(1.0 - m0))
            q0_eff = (qcol[:, 0] + Hb0dt + bmv_t(G0, GdtDb)) * m0
            B0[:, :NV, :NV] = Q0_eff
            B0[:, :NV, NV] = q0_eff
            B0[:, NV, :NV] = q0_eff
            B0[:, NV, NV] = sig_dt_tot + dtd + (GdtDb * Gdt).sum(1)
            if n_s:
                B0[:, NV + 1:, NV + 1:] = (torch.diag_embed(sig_s + dw[:, None])
                                           + bmm_tn(Gs, GsDb))
                z0s = bmm_tn(G0, GsDb) * m0[:, None]
                B0[:, :NV, NV + 1:] = z0s
                B0[:, NV + 1:, :NV] = z0s.transpose(1, 2)
                sdt_s = bmv_t(Gs, GdtDb)
                B0[:, NV + 1:, NV] = sdt_s
                B0[:, NV, NV + 1:] = sdt_s

            Wc = torch.zeros(B, T, NV, nB, dtype=dtype, device=dev)
            Wc[:, :, :, NV] = qcol[:, 1:]
            Wc[:, 0, :, :NV] = (O[:, 0] * m0[:, None]).transpose(1, 2)
            Wc[:, T - 1, :, :NV] += (HbT0 + bmm_tn(GT, G0Db)) * m0
            if n_s:
                Wc[:, T - 1, :, NV + 1:] += bmm_tn(GT, GsDb)

            M_chain = M[:, 1:]
            O_chain = torch.cat([O[:, 1:], torch.zeros(B, 1, NV, NV, dtype=dtype,
                                                       device=dev)], dim=1)

        def condense_rhs(rhs_v_, rhs_c_):
            r_dt = rhs_v_[:, 0]
            rz = rhs_v_[:, 1:1 + (T + 1) * NV].reshape(B, T + 1, NV).clone()
            r_s = rhs_v_[:, 1 + (T + 1) * NV:]
            rc_d = rhs_c_[:, :NS * T].reshape(B, T, NS)
            rc_b = rhs_c_[:, NS * T:]
            rz[:, :-1] += bmv_t(A, Dd * rc_d)
            rz[:, 1:] += torch.cat([Dd * rc_d, zpad], dim=2)
            rz[:, T] += bmv_t(GT, Db * rc_b)
            rz[:, 0] += bmv_t(G0, Db * rc_b)
            rz[:, 0] *= m0
            r_dt_c = r_dt + (Dd * d * rc_d).sum((1, 2)) + (GdtDb * rc_b).sum(1)
            r_s_c = r_s + bmv_t(Gs, Db * rc_b)
            rB = torch.cat([rz[:, 0], r_dt_c[:, None], r_s_c], dim=1)
            return rz, rB, rc_d, rc_b

        def border_solve(L_border, rB_acc):
            yb_ = tri_solve_unrolled(L_border, rB_acc[..., None], lower=True)
            return tri_solve_unrolled(L_border, yb_, lower=True,
                                      trans=True)[..., 0]

        with span("kkt.chain"):
            # Each branch factors the chain once with the rhs-independent
            # border columns Wc and leaves chain_solve(r_chain (B, T, NV),
            # rB (B, nB)) -> (dZ_chain (B, T, NV), d_beta (B, nB)).
            if chain in ("crp", "cr", "spike"):
                if chain == "crp":
                    # Fused factor + border-column elimination (K1 eliminates
                    # Wc in the same pass over the level data).
                    fac_levels, fac_root, Yall = crp_factor_solve(M_chain, O_chain,
                                                                  Wc)
                    YW = Yall[:, :T]

                    def tri_solve_chain(F):
                        return crp_solve(fac_levels, fac_root,
                                         crp_pad_rhs(F, n_pad))[:, :T]
                else:
                    factor, solve = ((cr_factor, cr_solve) if chain == "cr"
                                     else (spike_factor, spike_solve))
                    fac = factor(M_chain, O_chain)
                    tri_solve_chain = lambda F: solve(fac, F)
                    YW = tri_solve_chain(Wc)
                # Schur complement of the border: S = B0 - W^T Mtri^-1 W.
                L_border = chol_unrolled(B0 - bmm_tn(Wc, YW).sum(1))

                def chain_solve(r_chain, rB):
                    Yr = tri_solve_chain(r_chain[..., None])[..., 0]
                    d_beta = border_solve(L_border, rB - bmv_t(Wc, Yr).sum(1))
                    return Yr - bmv(YW, d_beta[:, None, :]), d_beta

            elif chain == "pallas":
                # Factor once (K6, border columns eliminated together); every
                # solve then runs the O(n^2)-per-block rhs forward pass (K7)
                # and the back-substitution (K8).
                Dinv_p, t2p, tRw_p, Sw_p = chain_eliminate(M_chain, O_chain, Wc)
                L_border = chol_unrolled(B0 - Sw_p)

                def chain_solve(r_chain, rB):
                    tr_p, sb_r = chain_rhs_forward(Dinv_p, O_chain, tRw_p, r_chain)
                    d_beta = border_solve(L_border, rB - sb_r)
                    coef = torch.cat([-d_beta, torch.ones(B, 1, dtype=dtype,
                                                          device=dev)], dim=1)
                    return chain_back_sub(
                        torch.cat([tRw_p, tr_p[..., None]], dim=3), t2p,
                        coef), d_beta

            else:  # "scan": the sequential elimination, block by block
                # Each block's inverse by the outer-product Cholesky and whole
                # (B, 11, k) products: a few operations a block where the
                # unrolled recurrences take hundreds (each is a graph node).
                eye = torch.eye(NV, dtype=dtype, device=dev).expand(B, NV, NV)
                Dcorr = torch.zeros(B, NV, NV, dtype=dtype, device=dev)
                Wcorr = torch.zeros(B, NV, nB, dtype=dtype, device=dev)
                Dinvs, Wts, tt2s = [], [], []
                for i in range(T):
                    Wt = Wc[:, i] - Wcorr
                    Dinv = cho_solve_outer(chol_outer(M_chain[:, i] - Dcorr), eye)
                    tt2 = Dinv @ torch.cat([Wt, O_chain[:, i]], dim=2)
                    corr = O_chain[:, i].mT @ tt2       # O^T D~^-1 [W~ | O]
                    Wcorr, Dcorr = corr[..., :nB], corr[..., nB:]
                    Dinvs.append(Dinv)
                    Wts.append(Wt)
                    tt2s.append(tt2)
                Dinv_s = torch.stack(Dinvs, dim=1)      # (B, T, 11, 11)
                Wt_s = torch.stack(Wts, dim=1)          # (B, T, 11, nB)
                tt2_s = torch.stack(tt2s, dim=1)        # [D~^-1 W~ | D~^-1 O]
                tW_s, t2_s = tt2_s[..., :nB], tt2_s[..., nB:]
                L_border = chol_unrolled(B0 - (Wt_s.mT @ tW_s).sum(1))

                def chain_solve(r_chain, rB):
                    rcorr = torch.zeros(B, NV, 1, dtype=dtype, device=dev)
                    trs = []
                    for i in range(T):
                        tr = Dinv_s[:, i] @ (r_chain[:, i, :, None] - rcorr)
                        rcorr = O_chain[:, i].mT @ tr
                        trs.append(tr)
                    tr_s = torch.cat(trs, dim=2).mT      # (B, T, 11): D~^-1 r~
                    rB_acc = rB - (Wt_s.mT @ tr_s[..., None]).sum(1)[..., 0]
                    d_beta = border_solve(L_border, rB_acc)
                    base = tr_s - (tW_s @ d_beta[:, None, :, None])[..., 0]
                    dv_next = torch.zeros(B, NV, 1, dtype=dtype, device=dev)
                    dZs = [None] * T
                    for i in range(T - 1, -1, -1):
                        dv_next = base[:, i, :, None] - t2_s[:, i] @ dv_next
                        dZs[i] = dv_next
                    return torch.cat(dZs, dim=2).mT, d_beta

        def solve_once(rhs_v_, rhs_c_):
            rz, rB, rc_d, rc_b = condense_rhs(rhs_v_, rhs_c_)
            dZ_chain, d_beta = chain_solve(rz[:, 1:], rB)
            dz0 = d_beta[:, :NV] * m0
            ddt = d_beta[:, NV]
            ds = d_beta[:, NV + 1:]
            dZ = torch.cat([dz0[:, None], dZ_chain], dim=1)
            dv_out = torch.cat([ddt[:, None], dZ.reshape(B, -1), ds], dim=1)
            Jd = bmv(A, dZ[:, :-1]) + dZ[:, 1:, :NS] + d * ddt[:, None, None]
            dy_d = Dd * (Jd - rc_d)
            Jb = bmv(G0, dz0) + bmv(GT, dZ[:, T]) + Gdt * ddt[:, None]
            if n_s:
                Jb = Jb + bmv(Gs, ds)
            dy_b = Db * (Jb - rc_b)
            return dv_out, torch.cat([dy_d.reshape(B, -1), dy_b], dim=1)

        def apply_fn(rhs_v, rhs_c):
            with span("kkt.solve"):
                rhs_v_eff = torch.where(fixed_all, 0.0, rhs_v)
                dv, dy = solve_once(rhs_v_eff, rhs_c)
                for _ in range(refine):
                    a1, a2 = apply_saddle(dv, dy)
                    e1 = torch.where(fixed_all, 0.0, rhs_v_eff - a1)
                    cv, cy = solve_once(e1, rhs_c - a2)
                    dv = dv + cv
                    dy = dy + cy
                return dv, dy

        return apply_fn

    def kkt_solve(v, y_all, sigma, delta_w, delta_c, rhs_v, rhs_c, inst=None):
        """``delta_c`` (Gamma) must be strictly positive."""
        return kkt_prepare(v, y_all, sigma, delta_w, delta_c, inst)(rhs_v, rhs_c)

    kkt_solve.prepare = kkt_prepare
    return kkt_solve
