"""Augmented-Lagrangian interior-point solver (port of
``tol_tpu/solver/alm.py``; the method and every rule in it are explained
there).

    outer loop:  yhat <- yhat + c/gamma, penalty gamma and barrier mu annealing
    inner loop:  damped Newton descent on
        AL_mu(v) = f(v) + yhat^T c(v) + ||c(v)||^2 / (2 gamma)
                   + rho/2 ||v - v_ref||^2 - mu * sum(log-barrier terms)

The JAX package runs one ``lax.while_loop`` per lane under ``vmap``.  Here
one loop steps a (B, ...) batch of lanes in lock-step: before each step a
lane is *active* while ``~converged & it < max_iter``, the step is computed
for every lane, and each state field keeps its new value only where the
lane was active — as JAX's batched while loop leaves a finished lane
untouched.  The host tests "all lanes done" only every ``_CHECK_EVERY``
steps, or sooner when the lanes' iteration budget runs out (each test is a
device sync); a frozen lane does not move, so results do not depend on
``_CHECK_EVERY``.

On the card the loop's unit is a captured program, the counterpart of the
JAX package's jitted ``while_loop``: one masked step (``active``, the
Newton step, the select) that writes its result back into static state
buffers, captured once as a CUDA graph per (program, lanes, dtype, static
structure) and replayed between the host's checks (:class:`_StepProgram`,
:class:`ProgramCache`).  The state, the ``ALMParams``/``Phase1`` tensors
and the Instance's tensors are the graph's inputs, refilled by ``copy_``,
so one graph serves every group, budget and airframe of one structure.
With ``opts.trace`` the program also writes each step's six records into
static (B, ``max_iter``) buffers at a device step index, the counterpart of
the JAX package's fixed-length ``lax.scan``.  The eager loop runs on the
CPU, for ``opts.verbose`` (a graph cannot print), and when ``solve``'s
private ``_loop="eager"`` asks for it.

Every reduction is per lane (over the last axis); no value crosses lanes.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, jvp, vjp

from tol_tpu_torch.ops import chainkern, crkern
from tol_tpu_torch.solver.canonical import CanonicalNLP
from tol_tpu_torch.utils import profiling
from tol_tpu_torch.utils.profiling import span

_BIG = 1e19
_CHECK_EVERY = 8    # solver steps between the host's "all lanes done" tests
_PROGRAMS_KEPT = 8  # step programs a ProgramCache keeps (a grouped solver
                    # needs three: dive, endgame, drain)


class ALMOptions(NamedTuple):
    """Static solver structure + default numeric values (see the JAX
    module for what each field does)."""

    tol: float = 1e-8
    feas_tol: float = 0.0
    mu_init: float = 0.1
    gamma_init: float = 0.1
    gamma_min: float = 1e-6
    gamma_shrink: float = 0.5
    mu_shrink: float = 0.2
    mu_min: float = 0.0
    theta_mu: float = 1.2
    kappa_inner: float = 1.0
    tau_min: float = 0.99
    max_iter: int = 400
    max_ls: int = 12
    eta: float = 1e-4
    delta_w_min: float = 1e-12
    delta_w_max: float = 1e6
    kappa_sigma: float = 1e10
    bound_push: float = 1e-2
    s_max: float = 100.0
    delta_decay: float = 0.2
    stagnation_outer: bool = True
    trace: bool = False          # record per-iteration scalars (solve())
    prox: float = 0.0
    dual_refine_k: int = 0
    gamma_eager: bool = False
    factor_reuse: int = 1
    verbose: bool = False


class ALMParams(NamedTuple):
    """Runtime solver numerics, each a 0-d tensor (``max_iter`` int32)."""

    tol: torch.Tensor
    feas_tol: torch.Tensor
    mu_init: torch.Tensor
    mu_min: torch.Tensor
    mu_shrink: torch.Tensor
    theta_mu: torch.Tensor
    gamma_init: torch.Tensor
    gamma_min: torch.Tensor
    gamma_shrink: torch.Tensor
    prox: torch.Tensor
    eta: torch.Tensor
    tau_min: torch.Tensor
    kappa_inner: torch.Tensor
    delta_decay: torch.Tensor
    gamma_eager: torch.Tensor
    max_iter: torch.Tensor

    @staticmethod
    def from_options(opts: ALMOptions, dtype=torch.float32,
                     device=None) -> "ALMParams":
        feas = opts.feas_tol if opts.feas_tol > 0 else opts.tol
        mu_min = (opts.mu_min if opts.mu_min > 0
                  else min(opts.tol / 10.0, opts.mu_init))
        f = lambda x: torch.tensor(x, dtype=dtype, device=device)
        return ALMParams(
            tol=f(opts.tol), feas_tol=f(feas), mu_init=f(opts.mu_init),
            mu_min=f(mu_min), mu_shrink=f(opts.mu_shrink),
            theta_mu=f(opts.theta_mu), gamma_init=f(opts.gamma_init),
            gamma_min=f(opts.gamma_min), gamma_shrink=f(opts.gamma_shrink),
            prox=f(opts.prox), eta=f(opts.eta), tau_min=f(opts.tau_min),
            kappa_inner=f(opts.kappa_inner), delta_decay=f(opts.delta_decay),
            gamma_eager=f(1.0 if opts.gamma_eager else 0.0),
            max_iter=torch.tensor(opts.max_iter, dtype=torch.int32,
                                  device=device),
        )


class Phase1(NamedTuple):
    """In-loop continuation: per-lane exploration phase before the endgame."""

    params: ALMParams
    n_max: torch.Tensor      # int32
    exit_df: torch.Tensor
    patience: int = 3


class ALMState(NamedTuple):
    """Solver state of B lanes: vectors (B, n|m), scalars (B,)."""

    v: torch.Tensor
    v_ref: torch.Tensor
    yhat: torch.Tensor
    y_ls: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    mu: torch.Tensor
    gamma: torch.Tensor
    delta_w: torch.Tensor
    theta_ref: torch.Tensor
    it: torch.Tensor         # int32
    converged: torch.Tensor  # bool
    kkt_err: torch.Tensor
    phase: torch.Tensor      # int32: 0 = exploration, 1 = endgame
    f_prev: torch.Tensor
    slow: torch.Tensor       # int32
    n0: torch.Tensor         # int32


class ALMResult(NamedTuple):
    v: torch.Tensor
    y: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    f: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    kkt_err: torch.Tensor
    constr_viol: torch.Tensor
    phase1_iters: torch.Tensor | None = None
    trace: tuple | None = None
    state: ALMState | None = None


_INT_FIELDS = ("it", "phase", "slow", "n0")


def alm_params_from_numpy(fields: dict, device=None,
                          dtype=torch.float64) -> ALMParams:
    """ALMParams from a JAX ALMParams' fields as numpy (``_asdict()``)."""
    return ALMParams(**{
        k: torch.as_tensor(np.array(fields[k]),
                           dtype=torch.int32 if k == "max_iter" else dtype,
                           device=device)
        for k in ALMParams._fields})


def alm_state_from_numpy(fields: dict, device=None,
                         dtype=torch.float64) -> ALMState:
    """ALMState from stacked numpy fields (leading lane axis B)."""
    def conv(k):
        dt = (torch.int32 if k in _INT_FIELDS
              else torch.bool if k == "converged" else dtype)
        return torch.as_tensor(np.array(fields[k]), dtype=dt, device=device)
    return ALMState(**{k: conv(k) for k in ALMState._fields})


def _inf_norm(x):
    """Per-lane max-abs over the last axis."""
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return x.abs().amax(-1)


def _col(x):
    """Per-lane scalars (B,) -> (B, 1) for broadcasting against vectors."""
    return x[..., None]


def _fmax(x, lo):
    """``jnp.maximum(x, lo)`` for a float ``lo`` (NaN propagates)."""
    return torch.maximum(x, torch.full_like(x, lo))


def _div(x, d):
    """``x / d`` for a 0-d tensor ``d`` on ``x``'s device, with the bits of
    ``x / float(d)``: PyTorch's CUDA division by a host scalar multiplies
    by the scalar's reciprocal, its CPU division divides."""
    return x * (1.0 / d) if x.is_cuda else x / d


def _select(mask, a: NamedTuple, b: NamedTuple):
    """Field-wise ``where(mask, a, b)`` over lanes; mask (B,)."""
    out = []
    for x, y in zip(a, b):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        out.append(torch.where(m, x, y))
    return type(a)(*out)


def phase_switch_state(can: CanonicalNLP, st: ALMState, p2: ALMParams,
                       inst=None) -> ALMState:
    """Exploration -> endgame transition on saved states: absorb the AL
    multiplier view, restart the barrier/penalty schedules, re-center the
    prox reference and the bound duals."""
    inst = can.nlp._inst(inst)
    lb, ub, fixed = can.bounds(inst)
    has_lb = (lb > -_BIG) & ~fixed
    has_ub = (ub < _BIG) & ~fixed
    dtype = st.v.dtype
    B = st.v.shape[0]
    cv = can.c(st.v, inst)
    y = st.yhat + cv / _col(st.gamma)
    mu2 = p2.mu_init.to(dtype).expand(B)
    dl = torch.where(has_lb, st.v - lb, 1.0)
    du = torch.where(has_ub, ub - st.v, 1.0)
    return st._replace(
        yhat=y, mu=mu2, gamma=p2.gamma_init.to(dtype).expand(B),
        v_ref=st.v, theta_ref=_inf_norm(cv),
        zl=torch.where(has_lb, _col(mu2) / dl, 0.0),
        zu=torch.where(has_ub, _col(mu2) / du, 0.0),
        delta_w=torch.zeros_like(st.delta_w),
        phase=torch.ones_like(st.phase),
        f_prev=can.f(st.v, inst),
        slow=torch.zeros_like(st.slow),
    )


def _cg(Aop, b, x0, k):
    """k fixed CG steps per lane on the (consistent, PSD) systems A x = b."""
    dot = lambda a, c: (a * c).sum(-1)
    x = x0
    r = b - Aop(x)
    p = r
    rs = dot(r, r)
    for _ in range(k):
        Ap = Aop(p)
        denom = dot(p, Ap)
        alpha = torch.where(denom > 0, rs / _fmax(denom, 1e-30), 0.0)
        x = x + _col(alpha) * p
        r = r - _col(alpha) * Ap
        rs_new = dot(r, r)
        beta = rs_new / _fmax(rs, 1e-30)
        p = r + _col(beta) * p
        rs = rs_new
    return torch.where(torch.isfinite(x).all(-1, keepdim=True), x, x0)


class _Kernel(NamedTuple):
    """init + one damped-Newton substep over B lanes (see the JAX module)."""

    init_state: Callable   # (p_start, p2, in_phase1) -> ALMState
    substep: Callable      # (st, ap_stale, p1, p2, phase1) -> (ALMState, ap)
    kkt_errors: Callable   # (v, y, zl, zu, mu) -> (err, viol, e_d, e_c)
    f_fn: Callable
    c_fn: Callable
    rebind: Callable       # () -> None: bounds recomputed from inst in place


def make_kernel(can: CanonicalNLP, kkt_solve: Callable, opts: ALMOptions,
                inst, v0: torch.Tensor, y0: torch.Tensor | None = None) -> _Kernel:
    """Solver kernel closures for lanes ``v0`` (B, n) sharing ``inst``."""
    inst = can.nlp._inst(inst)
    lb, ub, fixed = can.bounds(inst)
    has_lb = (lb > -_BIG) & ~fixed
    has_ub = (ub < _BIG) & ~fixed
    dtype, dev = v0.dtype, v0.device
    zero = torch.zeros((), dtype=dtype, device=dev)   # mu of the plain error

    def bound_counts(has_lb, has_ub):
        """max(1, m + nz) and max(1, nz), nz the finite, non-fixed bounds:
        the scaling counts of the KKT error, on the device, since nz
        depends on the Instance's values (as the JAX package traces it)."""
        nz = (has_lb.sum() + has_ub.sum()).to(dtype)
        return torch.clamp(nz + can.m, min=1.0), torch.clamp(nz, min=1.0)

    n_md, n_z = bound_counts(has_lb, has_ub)

    def rebind():
        """Recompute the bound tensors from ``inst`` in place: a step
        program refills ``inst``'s tensors between solves, and its graph
        reads these tensors."""
        lb_n, ub_n, fixed_n = can.bounds(inst)
        hl, hu = (lb_n > -_BIG) & ~fixed_n, (ub_n < _BIG) & ~fixed_n
        for buf, x in zip((lb, ub, fixed, has_lb, has_ub, n_md, n_z),
                          (lb_n, ub_n, fixed_n, hl, hu,
                           *bound_counts(hl, hu))):
            buf.copy_(x)

    f_fn = lambda v: can.f(v, inst)
    c_fn = lambda v: can.c(v, inst)
    # Lanes are independent, so the gradient of the lane sum is the
    # per-lane gradient.
    grad_f = grad(lambda v: f_fn(v).sum())
    grad_lag = grad(lambda v, y: (f_fn(v) + (c_fn(v) * y).sum(-1)).sum())

    def interior_push(v):
        bp = opts.bound_push
        pl = torch.where(has_lb, lb + bp * _fmax(lb.abs(), 1.0), -torch.inf)
        pu = torch.where(has_ub, ub - bp * _fmax(ub.abs(), 1.0), torch.inf)
        mid = 0.5 * (lb + ub)
        both = has_lb & has_ub & (pl > pu)
        v = torch.minimum(torch.maximum(v, pl), pu)
        v = torch.where(both, mid, v)
        return torch.where(fixed, lb, v)

    def barrier(v):
        dl = torch.where(has_lb, v - lb, 1.0)
        du = torch.where(has_ub, ub - v, 1.0)
        ok = (dl > 0).all(-1) & (du > 0).all(-1)
        val = (torch.where(has_lb, torch.log(dl), 0.0).sum(-1)
               + torch.where(has_ub, torch.log(du), 0.0).sum(-1))
        return val, ok

    def al_of(f_v, cv, v, v_ref, rho, yhat, gamma, mu):
        """AL merit from precomputed f(v), c(v); lane scalars shaped like f_v."""
        bar, ok = barrier(v)
        pv = v - v_ref
        val = (f_v + (yhat * cv).sum(-1) + (cv * cv).sum(-1) / (2.0 * gamma)
               + 0.5 * rho * (pv * pv).sum(-1) - mu * bar)
        return torch.where(ok, val, torch.inf)

    def _kkt_parts(v, y, zl, zu):
        dl = torch.where(has_lb, v - lb, 1.0)
        du = torch.where(has_ub, ub - v, 1.0)
        r_d = (grad_lag(v, y) - torch.where(has_lb, zl, 0.0)
               + torch.where(has_ub, zu, 0.0))
        r_d = torch.where(fixed, 0.0, r_d)
        theta = c_fn(v)
        comp_l = torch.where(has_lb, zl * dl, 0.0)
        comp_u = torch.where(has_ub, zu * du, 0.0)
        s_d = _fmax(_div(y.abs().sum(-1) + zl.abs().sum(-1)
                         + zu.abs().sum(-1), n_md), opts.s_max) / opts.s_max
        s_c = _fmax(_div(zl.abs().sum(-1) + zu.abs().sum(-1), n_z),
                    opts.s_max) / opts.s_max
        return r_d, theta, comp_l, comp_u, s_d, s_c

    def _errors_at(parts, mu):
        """``mu``: a tensor on the lanes' device, (B,) or 0-d."""
        r_d, theta, comp_l, comp_u, s_d, s_c = parts
        mu = mu.reshape(-1, 1)
        comp = torch.maximum(
            _inf_norm(torch.where(has_lb, comp_l - mu, 0.0)),
            _inf_norm(torch.where(has_ub, comp_u - mu, 0.0)))
        e_d = _inf_norm(r_d) / s_d
        e_p = _inf_norm(theta)
        e_c = comp / s_c
        return torch.maximum(torch.maximum(e_d, e_p), e_c), e_p, e_d, e_c

    def kkt_errors(v, y, zl, zu, mu):
        """KKT error of the original NLP at multiplier estimate y; ``mu`` a
        tensor or a Python float."""
        if not isinstance(mu, torch.Tensor):
            mu = torch.full((), mu, dtype=dtype, device=dev)
        return _errors_at(_kkt_parts(v, y, zl, zu), mu)

    def init_state(p0: ALMParams, p2: ALMParams, in_phase1: bool) -> ALMState:
        B = v0.shape[0]
        v = interior_push(v0)
        mu = p0.mu_init.to(dtype).expand(B)
        dl = torch.where(has_lb, v - lb, 1.0)
        du = torch.where(has_ub, ub - v, 1.0)
        zl = torch.where(has_lb, _col(mu) / dl, 0.0)
        zu = torch.where(has_ub, _col(mu) / du, 0.0)
        yhat = (torch.zeros(B, can.m, dtype=dtype, device=dev) if y0 is None
                else torch.as_tensor(y0, dtype=dtype, device=dev).expand(B, can.m))
        cv = c_fn(v)
        err = kkt_errors(v, yhat, zl, zu, zero)[0]
        izero = torch.zeros(B, dtype=torch.int32, device=dev)
        return ALMState(
            v=v, v_ref=v, yhat=yhat, y_ls=yhat, zl=zl, zu=zu, mu=mu,
            gamma=p0.gamma_init.to(dtype).expand(B),
            delta_w=torch.zeros(B, dtype=dtype, device=dev),
            theta_ref=_inf_norm(cv), it=izero,
            converged=(err <= p2.tol) & (not in_phase1),
            kkt_err=err,
            phase=izero + (0 if in_phase1 else 1),
            f_prev=f_fn(v), slow=izero, n0=izero,
        )

    def substep(st: ALMState, ap_stale, p1: ALMParams, p2: ALMParams,
                phase1: Phase1 | None):
        """One damped-Newton step of every lane.  ``ap_stale``: a KKT apply
        closure from an earlier factorization (chord step) or None.
        Returns (new_state, apply_closure)."""
        with span("step.residuals"):
            B = st.v.shape[0]
            if phase1 is not None:
                ph0 = st.phase == 0
                eff = ALMParams(*[torch.where(ph0, a, b) for a, b in zip(p1, p2)])
            else:
                eff = ALMParams(*[x.expand(B) for x in p2])
            eff = eff._replace(**{k: getattr(eff, k).to(dtype)
                                  for k in ALMParams._fields if k != "max_iter"})
            rho = eff.prox

            v, yhat, zl, zu = st.v, st.yhat, st.zl, st.zu
            mu, gamma = st.mu, st.gamma
            dl = torch.where(has_lb, v - lb, 1.0)
            du = torch.where(has_ub, ub - v, 1.0)
            sigma = (torch.where(has_lb, zl / dl, 0.0)
                     + torch.where(has_ub, zu / du, 0.0))

            f_v = f_fn(v)
            cv = c_fn(v)
            y_al = yhat + cv / _col(gamma)

            g_al = (grad_lag(v, y_al)
                    + _col(rho) * (v - st.v_ref)
                    - torch.where(has_lb, _col(mu) / dl, 0.0)
                    + torch.where(has_ub, _col(mu) / du, 0.0))
            rhs_v = torch.where(fixed, 0.0, -g_al)
            rhs_c = torch.zeros(B, can.m, dtype=dtype, device=dev)

        delta_w = st.delta_w
        gamma_rows = _col(gamma).expand(B, can.m)
        if ap_stale is not None:
            ap = ap_stale
            dv, dw = ap(rhs_v, rhs_c)
        elif hasattr(kkt_solve, "prepare"):
            ap = kkt_solve.prepare(v, y_al, sigma, delta_w + rho, gamma_rows,
                                   inst)
            dv, dw = ap(rhs_v, rhs_c)
        else:
            ap = None
            dv, dw = kkt_solve(v, y_al, sigma, delta_w + rho, gamma_rows,
                               rhs_v, rhs_c, inst)

        with span("step.armijo"):
            # NaN from a non-SPD pivot is decided per lane.
            bad = ~(torch.isfinite(dv).all(-1) & torch.isfinite(dw).all(-1))
            dv = torch.where(_col(bad), 0.0, dv)
            dw = torch.where(_col(bad), 0.0, dw)

            d_al = (g_al * dv).sum(-1)
            curv_ok = d_al < 0.0

            tau = torch.maximum(eff.tau_min, 1.0 - mu)

            def ftb(slack, dslack):
                neg = dslack < 0
                ratio = torch.where(neg, -_col(tau) * slack
                                    / torch.where(neg, dslack, -1.0), 1.0)
                r = torch.where(torch.isfinite(ratio), ratio, 1.0).amin(-1)
                return torch.clamp(r, max=1.0)

            a_max = torch.minimum(
                ftb(torch.where(has_lb, dl, 1.0), torch.where(has_lb, dv, 0.0)),
                ftb(torch.where(has_ub, du, 1.0), torch.where(has_ub, -dv, 0.0)))

            # Plain Armijo on the AL merit, max_ls trials per lane in parallel
            # on a second batch axis; each trial keeps its (f, c).
            al0 = al_of(f_v, cv, v, st.v_ref, rho, yhat, gamma, mu)
            halves = 0.5 ** torch.arange(opts.max_ls, dtype=dtype, device=dev)
            alphas = _col(a_max) * halves                         # (B, max_ls)
            vt = v[:, None, :] + alphas[..., None] * dv[:, None, :]
            f_tr = f_fn(vt)
            c_tr = c_fn(vt)
            al_vals = al_of(f_tr, c_tr, vt, st.v_ref[:, None], _col(rho),
                            yhat[:, None], _col(gamma), _col(mu))
            ok = al_vals <= _col(al0) + _col(eff.eta) * alphas * _col(d_al)
            any_ok = ok.any(-1)
            first = ok.to(torch.int8).argmax(-1)                  # first accepted
            alpha = torch.where(any_ok, alphas.gather(1, first[:, None])[:, 0], 0.0)
            # Sub-noise regime: take the full step unconditionally.
            eps_m = torch.finfo(dtype).eps
            noise = 30.0 * eps_m * (1.0 + al0.abs())
            sub_noise = d_al.abs() * a_max <= noise
            alpha = torch.where(sub_noise, a_max, alpha)
            any_ok = any_ok | sub_noise
            alpha = torch.where(bad | (~curv_ok & ~sub_noise), 0.0, alpha)

            reject = bad | (~curv_ok & ~sub_noise) | ~any_ok
            delta_grown = torch.where(
                bad, _fmax(delta_w * 30.0, 1e-2),
                torch.where(delta_w == 0.0, 1e-6, delta_w * 10.0))
            decayed = delta_w * eff.delta_decay
            delta_next = torch.where(
                reject, torch.clamp(delta_grown, max=opts.delta_w_max),
                torch.where(decayed < opts.delta_w_min, 0.0, decayed))

        with span("step.update"):
            v_n = v + _col(alpha) * dv

            # Bound-dual updates along the realized move.
            muc = _col(mu)
            dzl = torch.where(has_lb,
                              (muc - zl * dl) / dl - zl / dl * (v_n - v), 0.0)
            dzu = torch.where(has_ub,
                              (muc - zu * du) / du + zu / du * (v_n - v), 0.0)
            a_dual = torch.minimum(
                ftb(torch.where(has_lb, zl, 1.0), torch.where(has_lb, dzl, 0.0)),
                ftb(torch.where(has_ub, zu, 1.0), torch.where(has_ub, dzu, 0.0)))
            zl_n = zl + _col(a_dual) * dzl
            zu_n = zu + _col(a_dual) * dzu
            dl_n = torch.where(has_lb, v_n - lb, 1.0)
            du_n = torch.where(has_ub, ub - v_n, 1.0)
            ks = opts.kappa_sigma
            zl_n = torch.where(has_lb, torch.minimum(
                torch.maximum(zl_n, muc / (ks * dl_n)), ks * muc / dl_n), 0.0)
            zu_n = torch.where(has_ub, torch.minimum(
                torch.maximum(zu_n, muc / (ks * du_n)), ks * muc / du_n), 0.0)

            # (f, c) at v_n come from the accepted trial (alpha is alphas[sel]
            # or 0 for a rejection).
            sel = torch.where(sub_noise, 0, first)
            took = alpha > 0.0
            f_n = torch.where(took, f_tr.gather(1, sel[:, None])[:, 0], f_v)
            c_sel = c_tr.gather(1, sel[:, None, None].expand(B, 1, can.m))[:, 0]
            c_n = torch.where(_col(took), c_sel, cv)
            y_n = yhat + c_n / _col(gamma)
            parts_n = _kkt_parts(v_n, y_n, zl_n, zu_n)
            err_in, th_in, e_d_in, e_c_in = _errors_at(parts_n, mu)

            # ---- least-squares dual refinement (see ALMOptions) ----
            if opts.dual_refine_k > 0:
                jvp_c = lambda t: jvp(c_fn, (v_n,), (t,))[1]
                _, vjp_fn = vjp(c_fn, v_n)
                vjp_c = lambda yy: vjp_fn(yy)[0]
                g0 = (grad_f(v_n) - torch.where(has_lb, zl_n, 0.0)
                      + torch.where(has_ub, zu_n, 0.0))
                sig_n = (torch.where(has_lb, zl_n / dl_n, 0.0)
                         + torch.where(has_ub, zu_n / du_n, 0.0))
                w2 = torch.where(fixed, 0.0, 1.0 / (1.0 + sig_n))
                Nop = lambda yy: jvp_c(w2 * vjp_c(yy))
                y_ls = _cg(Nop, -jvp_c(w2 * g0), y_n, opts.dual_refine_k)
                r_ls = torch.where(fixed, 0.0, g0 + vjp_c(y_ls))
                cap = _col(0.5 * eff.tol)
                d_l = torch.where(has_lb, torch.minimum(
                    torch.maximum(r_ls, -zl_n),
                    torch.clamp(cap / dl_n - zl_n, min=0.0)), 0.0)
                left = r_ls - d_l
                d_u = torch.where(has_ub, torch.minimum(
                    torch.maximum(-left, -zu_n),
                    torch.clamp(cap / du_n - zu_n, min=0.0)), 0.0)
                r_ls = r_ls - d_l + d_u
                zl_ls = zl_n + d_l
                zu_ls = zu_n + d_u
                comp_l_ls = torch.where(has_lb, zl_ls * dl_n, 0.0)
                comp_u_ls = torch.where(has_ub, zu_ls * du_n, 0.0)
                s_d_ls = _fmax(_div(y_ls.abs().sum(-1) + zl_ls.abs().sum(-1)
                                    + zu_ls.abs().sum(-1), n_md),
                               opts.s_max) / opts.s_max
                s_c_ls = _fmax(_div(zl_ls.abs().sum(-1) + zu_ls.abs().sum(-1),
                                    n_z), opts.s_max) / opts.s_max
                parts_ls = (r_ls, parts_n[1], comp_l_ls, comp_u_ls, s_d_ls, s_c_ls)
            else:
                y_ls = st.y_ls
                parts_ls = None
            inner_err = torch.maximum(e_d_in, e_c_in)
            inner_done = inner_err <= eff.kappa_inner * mu
            if opts.stagnation_outer:
                stagnated = (~bad) & (_inf_norm(dv) <= 1e-5 * (1.0 + _inf_norm(v)))
                inner_done = inner_done | stagnated

            # ---- outer updates, applied only when the inner problem is done ----
            theta_now = th_in
            feas_target = eff.feas_tol
            stalled = (theta_now > 0.9 * st.theta_ref) | (eff.gamma_eager > 0)
            need_feas = theta_now > feas_target
            need_more = need_feas | (st.kkt_err > eff.tol)
            gamma_n = torch.where(
                inner_done & stalled & need_more,
                torch.maximum(eff.gamma_min, gamma * eff.gamma_shrink), gamma)
            gamma_n = torch.where(
                inner_done & (theta_now <= 0.02 * feas_target) & ~need_more,
                torch.minimum(gamma_n * 2.0, eff.gamma_init), gamma_n)
            mu_n = torch.where(
                inner_done,
                torch.maximum(eff.mu_min, torch.minimum(eff.mu_shrink * mu,
                                                        mu ** eff.theta_mu)),
                mu)
            yhat_n = torch.where(_col(inner_done), y_n, yhat)
            theta_ref_n = torch.where(inner_done, theta_now, st.theta_ref)
            v_ref_n = torch.where(_col(inner_done), v_n, st.v_ref)

            err0, viol, _, _ = _errors_at(parts_n, zero)
            if parts_ls is not None:
                err0 = torch.minimum(err0, _errors_at(parts_ls, zero)[0])
            conv = (err0 <= eff.tol) & (viol <= feas_target) & (st.phase == 1)

            # ---- phase-0 exit: cost-descent stall detection ----
            if phase1 is not None:
                rel_df = (st.f_prev - f_n) / _fmax(f_n.abs(), 1e-12)
                is_slow = rel_df < phase1.exit_df.to(dtype)
                slow_n = torch.where(
                    reject, st.slow,
                    torch.where(is_slow, st.slow + 1, 0)).to(torch.int32)
                leave = (st.phase == 0) & ((slow_n >= phase1.patience)
                                           | (st.it + 1 >= phase1.n_max))
                mu2 = p2.mu_init.to(dtype)
                phase_n = torch.where(leave, 1, st.phase).to(torch.int32)
                yhat_n = torch.where(_col(leave), y_n, yhat_n)
                mu_n = torch.where(leave, mu2, mu_n)
                gamma_n = torch.where(leave, p2.gamma_init.to(dtype), gamma_n)
                v_ref_n = torch.where(_col(leave), v_n, v_ref_n)
                theta_ref_n = torch.where(leave, theta_now, theta_ref_n)
                zl_n = torch.where(_col(leave) & has_lb, mu2 / dl_n, zl_n)
                zu_n = torch.where(_col(leave) & has_ub, mu2 / du_n, zu_n)
            else:
                phase_n = st.phase
                slow_n = st.slow

            if opts.verbose:
                print(f"it={st.it[0].item()} ph={st.phase[0].item()} "
                      f"mu={mu[0].item():.1e} gam={gamma[0].item():.1e} "
                      f"err0={err0[0].item():.3e} th={viol[0].item():.3e} "
                      f"a={alpha[0].item():.2e} dw={delta_w[0].item():.1e} "
                      f"f={f_n[0].item():.6e}")

            new = ALMState(
                v=v_n, v_ref=v_ref_n, yhat=yhat_n, y_ls=y_ls,
                zl=zl_n, zu=zu_n, mu=mu_n, gamma=gamma_n,
                delta_w=delta_next, theta_ref=theta_ref_n, it=st.it + 1,
                converged=conv, kkt_err=err0,
                phase=phase_n, f_prev=f_n, slow=slow_n,
                n0=st.n0 + (st.phase == 0).to(torch.int32),
            )
            return _select(st.converged, st._replace(it=st.it + 1), new), ap

    return _Kernel(init_state=init_state, substep=substep,
                   kkt_errors=kkt_errors, f_fn=f_fn, c_fn=c_fn, rebind=rebind)


def _newton_step(kern: _Kernel, opts: ALMOptions, st: ALMState,
                 p1: ALMParams, p2: ALMParams,
                 phase1: Phase1 | None) -> ALMState:
    """One solver step: a substep, then ``factor_reuse - 1`` chord
    substeps against its factorization."""
    st_n, ap = kern.substep(st, None, p1, p2, phase1)
    for _ in range(max(0, opts.factor_reuse - 1)):
        st_n, _ = kern.substep(st_n, ap, p1, p2, phase1)
    return st_n


def _record(kern: _Kernel, st: ALMState) -> tuple:
    """One step's trace record: ``(kkt_err, mu, gamma, delta_w,
    constraint violation, f)``, each (B,)."""
    return (st.kkt_err, st.mu, st.gamma, st.delta_w,
            _inf_norm(kern.c_fn(st.v)), st.f_prev)


def _steps_left(active: torch.Tensor, max_iter: torch.Tensor,
                it: torch.Tensor) -> int:
    """Steps until the last active lane reaches its budget; 0 when no lane
    is active (one device sync)."""
    with span("alm.check"):
        return profiling.synced_int(torch.where(active, max_iter - it,
                                                0).max())


def _trace_buffers(v: torch.Tensor, max_iter: int) -> tuple:
    """The six (B, ``max_iter``) record buffers of ``opts.trace``."""
    return tuple(torch.zeros(v.shape[0], max_iter, dtype=v.dtype,
                             device=v.device) for _ in range(6))


def _pad_trace(trace: tuple, kern: _Kernel, st: ALMState, steps: int) -> None:
    """The columns after the last step repeat the final state's record."""
    if steps < trace[0].shape[1]:
        for buf, x in zip(trace, _record(kern, st)):
            buf[:, steps:] = x[:, None]


# ---------------------------------------------------------------------------
# the captured loop program
# ---------------------------------------------------------------------------


def _tensors(tree):
    """The tensor leaves of a tree of NamedTuples, dataclasses (the
    Instance's WindConfig) and tensors, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for x in tree:
            yield from _tensors(x)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _static_copy(tree):
    """``tree`` with every tensor leaf copied into a fresh contiguous
    buffer; the other leaves are shared."""
    if isinstance(tree, torch.Tensor):
        return tree.clone(memory_format=torch.contiguous_format)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_static_copy(x) for x in tree])
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _static_copy(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def _signature(tree):
    """What a captured program fixes of a tree: each tensor's shape, dtype
    and device, and the value of every other leaf (the wind model's Python
    floats, ``Phase1.patience``)."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, str(tree.device))
    if isinstance(tree, tuple):
        return (type(tree).__name__,) + tuple(_signature(x) for x in tree)
    if dataclasses.is_dataclass(tree):
        return (type(tree).__name__,) + tuple(
            _signature(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return tree


_COUNTED = crkern.KERNELS + chainkern.KERNELS   # wrappers with ``.launches``


def _launch_counts() -> dict:
    return {k: k.launches for k in _COUNTED}


def _recorded_launches(before: dict) -> dict:
    """The launches the wrappers counted since ``before`` (a capture's:
    none of them ran), with every count set back to ``before``."""
    delta = {k: k.launches - n for k, n in before.items() if k.launches != n}
    for k, n in before.items():
        k.launches = n
    return delta


def _add_launches(delta: dict) -> None:
    """Count one replay of a program whose capture recorded ``delta``."""
    for k, n in delta.items():
        k.launches += n


class _StepProgram:
    """The loop's unit over static buffers: ``active = ~converged & it <
    max_iter`` on the device, the Newton step, ``_select(active, new, st)``,
    and the result copied back into the static state buffers, so that
    consecutive runs chain with no host work between them.

    The inputs are static buffers as well: every ALMState field, every
    ``ALMParams``/``Phase1`` tensor and every tensor of the Instance
    (:meth:`load` fills them by ``copy_``; the bound tensors derived from
    the Instance are recomputed in place).  On a CUDA device the first
    :meth:`run` is an eager step on a side stream (the warm-up: it builds
    and loads the kernels, raises their shared-memory limits and fills the
    cached index tensors, none of which may happen under capture); the
    second captures the unit as a CUDA graph, and every run from then on
    replays it.  A capture or replay that fails raises.  On the CPU the
    unit runs eagerly, through the same code.

    A capture launches nothing, so the kernel wrappers' launch counts are
    set back after it; each replay adds the launches the capture recorded.

    With ``opts.trace`` each step also writes its record (:func:`_record`)
    into column ``k`` of six static (B, ``opts.max_iter``) buffers and
    advances ``k``, a device index that :meth:`load` sets to 0: it counts
    the steps of one solve, not ``it``.  The caller runs at most
    ``opts.max_iter`` steps.

    """

    def __init__(self, can: CanonicalNLP, kkt_solve: Callable,
                 opts: ALMOptions, inst, st: ALMState, p2: ALMParams,
                 phase1: Phase1 | None):
        self.opts = opts
        self.inst = _static_copy(inst)
        self.st = _static_copy(st)
        self.p2 = _static_copy(p2)
        self.phase1 = _static_copy(phase1)
        self.p1 = self.phase1.params if phase1 is not None else self.p2
        self.kern = make_kernel(can, kkt_solve, opts, self.inst, self.st.v)
        self.records = None
        if opts.trace:
            self.records = _trace_buffers(self.st.v, opts.max_iter)
            self.k = torch.zeros(1, dtype=torch.int64, device=self.st.v.device)
        self.graph = None
        self.warm = False
        self.launches: dict = {}     # one replay's launches per wrapper
        self.capture_s = 0.0

    def load(self, inst, st: ALMState, p2: ALMParams,
             phase1: Phase1 | None) -> None:
        """Fill the static buffers for a new solve."""
        for bufs, tree in ((self.inst, inst), (self.st, st), (self.p2, p2),
                           (self.phase1, phase1)):
            for buf, x in zip(_tensors(bufs), _tensors(tree)):
                buf.copy_(x)
        self.kern.rebind()
        if self.records is not None:
            self.k.zero_()

    def step(self) -> None:
        """One masked step with write-back, eagerly."""
        st = self.st
        active = (~st.converged) & (st.it < self.p2.max_iter)
        new = _select(active, _newton_step(self.kern, self.opts, st, self.p1,
                                           self.p2, self.phase1), st)
        for buf, x in zip(st, new):
            buf.copy_(x)
        if self.records is not None:
            for buf, x in zip(self.records, _record(self.kern, st)):
                buf.index_copy_(1, self.k, x[:, None])
            self.k.add_(1)

    def steps_left(self) -> int:
        st = self.st
        active = (~st.converged) & (st.it < self.p2.max_iter)
        return _steps_left(active, self.p2.max_iter, st.it)

    def run(self) -> None:
        """One step: a replay, or eagerly on the CPU (see the class)."""
        cuda = self.st.v.device.type == "cuda"
        if cuda and self.warm and self.graph is None:
            self.capture()
        with profiling.replay(self.st.v.shape[0], self.graph is not None):
            if self.graph is not None:
                self.graph.replay()
                _add_launches(self.launches)
            elif not cuda:
                self.step()
            else:
                dev = self.st.v.device
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    self.step()
                torch.cuda.current_stream(dev).wait_stream(side)
                self.warm = True

    def capture(self) -> None:
        """Capture :meth:`step` as a CUDA graph (reads and writes nothing
        on the device)."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        try:
            with span("alm.capture"), torch.cuda.graph(graph):
                self.step()
        finally:
            self.launches = _recorded_launches(before)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0


class ProgramCache:
    """Step programs by (program, lanes, dtype, static structure), as
    ``jax.jit`` keeps its loop programs: a grouped solver or a mission leg
    solver holds one for its lifetime.  At most ``_PROGRAMS_KEPT`` are
    kept, the least recently used dropped first."""

    def __init__(self):
        self.programs: OrderedDict = OrderedDict()
        self._dropped_s = 0.0
        self._dropped_n = 0

    def get(self, key, make: Callable) -> _StepProgram:
        prog = self.programs.pop(key, None)
        self.programs[key] = prog if prog is not None else make()
        while len(self.programs) > _PROGRAMS_KEPT:
            _, old = self.programs.popitem(last=False)
            self._dropped_s += old.capture_s
            self._dropped_n += old.graph is not None
        return self.programs[key]

    @property
    def capture_s(self) -> float:
        """Seconds spent capturing graphs, dropped programs included."""
        return self._dropped_s + sum(p.capture_s
                                     for p in self.programs.values())

    @property
    def captures(self) -> int:
        return self._dropped_n + sum(p.graph is not None
                                     for p in self.programs.values())


def solve(can: CanonicalNLP, kkt_solve: Callable,
          opts: ALMOptions = ALMOptions(), inst=None,
          v0: torch.Tensor | None = None, y0: torch.Tensor | None = None,
          params: ALMParams | None = None, phase1: Phase1 | None = None,
          state0: ALMState | None = None,
          keep_state: bool = False, _loop: str | None = None,
          _programs: ProgramCache | None = None) -> ALMResult:
    """Solve B lanes of one canonical NLP instance in lock-step.

    ``v0`` (B, n) seeds (default: one lane at ``can.initial_point``);
    ``state0`` resumes saved states exactly (the per-lane iteration counter
    continues, so ``params.max_iter`` stays a total budget).  The host
    checks for "every lane done" once per ``_CHECK_EVERY`` steps.

    With ``opts.trace`` at most ``opts.max_iter`` steps run and
    ``result.trace`` holds, per step, ``(kkt_err, mu, gamma, delta_w,
    constraint violation, f)`` as six (B, ``opts.max_iter``) tensors; a
    finished lane repeats its last values.

    On a CUDA device the steps run as a captured program
    (:class:`_StepProgram`) taken from ``_programs`` (a cache of this call
    alone when None), ``opts.trace`` included; on the CPU, and with
    ``opts.verbose`` (a graph cannot print), the eager loop runs.
    ``_loop`` ("eager" or "program"; private) overrides the choice, for
    comparisons: "program" on the CPU runs the program's unit eagerly.
    """
    # The counterpart of jax.default_matmul_precision("highest"): every
    # float32 product of the Newton pipeline runs in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    inst = can.nlp._inst(inst)
    if v0 is None:
        v0 = state0.v if state0 is not None else can.initial_point(inst)[None]
    dtype, dev = v0.dtype, v0.device

    p2 = params if params is not None else ALMParams.from_options(opts, dtype,
                                                                  dev)
    p1 = phase1.params if phase1 is not None else p2

    with span("alm.init"):
        kern = make_kernel(can, kkt_solve, opts, inst, v0, y0)
        st = (kern.init_state(p1 if phase1 is not None else p2, p2,
                              phase1 is not None)
              if state0 is None else state0)

    loop = _loop or ("program" if dev.type == "cuda" else "eager")
    if opts.verbose:
        loop = "eager"
    if loop not in ("eager", "program"):
        raise ValueError(f"unknown loop {loop!r}")

    trace = (_trace_buffers(v0, opts.max_iter)
             if opts.trace and loop == "eager" else None)
    steps = 0           # this call's steps: at most opts.max_iter traced
    until_check = 0
    if loop == "program":
        programs = _programs if _programs is not None else ProgramCache()
        key = (id(can), id(kkt_solve), opts,
               _signature((inst, st, p2, phase1)))
        prog = programs.get(key, lambda: _StepProgram(
            can, kkt_solve, opts, inst, st, p2, phase1))
        with span("alm.load"):
            prog.load(inst, st, p2, phase1)
        while True:
            if until_check == 0:
                left = prog.steps_left()
                if opts.trace:
                    left = min(left, opts.max_iter - steps)
                if left == 0:
                    break
                until_check = min(_CHECK_EVERY, left)
            prog.run()
            steps += 1
            until_check -= 1
    while loop == "eager":
        active = (~st.converged) & (st.it < p2.max_iter)
        if opts.trace and steps == opts.max_iter:
            break
        if until_check == 0:
            # no lane can run past its budget: check again no later than
            # when the last active lane reaches max_iter
            left = _steps_left(active, p2.max_iter, st.it)
            if left == 0:
                break
            until_check = min(_CHECK_EVERY, left)
        st = _select(active, _newton_step(kern, opts, st, p1, p2, phase1), st)
        if opts.trace:
            for buf, x in zip(trace, _record(kern, st)):
                buf[:, steps] = x
        steps += 1
        until_check -= 1

    with span("alm.finish"):
        if loop == "program":
            st = ALMState(*[x.clone() for x in prog.st])
            if opts.trace:
                trace = tuple(x.clone() for x in prog.records)
        if opts.trace:
            _pad_trace(trace, kern, st, steps)
        cv = kern.c_fn(st.v)
        y_fin = (st.y_ls if opts.dual_refine_k > 0
                 else st.yhat + cv / _col(st.gamma))
        _, viol, _, _ = kern.kkt_errors(st.v, y_fin, st.zl, st.zu, 0.0)
        return ALMResult(
            v=st.v, y=y_fin, zl=st.zl, zu=st.zu, f=kern.f_fn(st.v),
            iterations=st.it, converged=st.converged, kkt_err=st.kkt_err,
            constr_viol=viol, phase1_iters=st.n0, trace=trace,
            state=st if keep_state else None,
        )
