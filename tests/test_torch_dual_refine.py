"""The least-squares dual refinement on the constraint Jacobian's blocks
(``canonical.constraint_jacobian``, ``alm.make_kernel``'s ``dual_refine``).

Port only: the oracle is the route through ``torch.func.jvp``/``vjp`` of
``can.c``, written out here.  Float64 on the CPU, two lanes at a seeded
interior point, on S10 / tempest, G7 / skywalker (two slack rows) and the
S10 storm (wind model 3, whose defect Jacobian goes through the generic
``jacfwd_lanes``).  The block products agree with the jvp and vjp to 1e-12
relative (the scaled defect's derivative in z_{k+1} is [I 0] up to one
rounding); one endgame substep's duals to 1e-10.  An op count holds the
block route under a quarter of the torch.func route's aten operations.
"""

import functools

import numpy as np
import pytest
import torch
from torch.func import grad, jvp, vjp

from tol_tpu_torch.api import make_problem
from tol_tpu_torch.io.storm import make_demo_storm_grid
from tol_tpu_torch.models.wind import WindConfig
from tol_tpu_torch.solver import alm
from tol_tpu_torch.solver.canonical import canonicalize, constraint_jacobian
from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt
from tol_tpu_torch.tools import kkt_ops

TS = 8
END = dict(max_iter=2000, dual_refine_k=4, max_ls=8)
PROBLEMS = ("s10", "g7", "storm")


@functools.lru_cache(maxsize=None)
def _can(name, dtype=torch.float64, ts=TS):
    if name == "s10":
        nlp = make_problem("S10", "tempest", ts=ts, wind_model=1, dtype=dtype,
                           device="cpu")
    elif name == "g7":
        nlp = make_problem("G7", "skywalker", ts=ts, wind_model=1, dtype=dtype,
                           device="cpu")
    else:
        wind = WindConfig(model=3, grid=make_demo_storm_grid(device="cpu"),
                          order=2, east0=17400.0, north0=25800.0, up0=200.0)
        nlp = make_problem("S10", "tempest", ts=ts, wind_model=3, wind=wind,
                           dtype=dtype, device="cpu")
    return canonicalize(nlp, scaling="auto")


def _point(can, n=2, seed=0):
    lb, ub, fixed = can.bounds(can.nlp.inst0)
    dv = torch.as_tensor(0.01 * np.random.default_rng(seed).standard_normal(
        (n, can.n)), dtype=lb.dtype)
    v = torch.minimum(torch.maximum(can.initial_point() + dv, lb), ub)
    return torch.where(fixed, lb, v)


def _params():
    """bench.py's endgame numerics in float64."""
    p = dict(tol=5e-3, feas_tol=1e-4, mu_init=6e-5, mu_min=1e-5,
             mu_shrink=0.1, theta_mu=1.2, gamma_init=0.01, gamma_min=1e-6,
             gamma_shrink=0.2, prox=2.5e-3, eta=1e-4, tau_min=0.99,
             kappa_inner=2.0, delta_decay=0.2, gamma_eager=1.0)
    return alm.ALMParams(**{k: torch.tensor(v, dtype=torch.float64)
                            for k, v in p.items()},
                         max_iter=torch.tensor(250, dtype=torch.int32))


def _bound_parts(can, inst, v):
    lb, ub, fixed = can.bounds(inst)
    has_lb = (lb > -alm._BIG) & ~fixed
    has_ub = (ub < alm._BIG) & ~fixed
    dl = torch.where(has_lb, v - lb, 1.0)
    du = torch.where(has_ub, ub - v, 1.0)
    return has_lb, has_ub, fixed, dl, du


def torch_func_refine(can, inst, v, y, zl, zu, k):
    """The refinement as it ran before the blocks: every product with J
    a ``jvp`` or a ``vjp`` through ``can.c``.  Returns (y_ls, r_ls)."""
    has_lb, has_ub, fixed, dl, du = _bound_parts(can, inst, v)
    c_fn = lambda x: can.c(x, inst)
    jvp_c = lambda t: jvp(c_fn, (v,), (t,))[1]
    _, vjp_fn = vjp(c_fn, v)
    vjp_c = lambda yy: vjp_fn(yy)[0]
    g0 = (grad(lambda x: can.f(x, inst).sum())(v)
          - torch.where(has_lb, zl, 0.0) + torch.where(has_ub, zu, 0.0))
    sig = (torch.where(has_lb, zl / dl, 0.0)
           + torch.where(has_ub, zu / du, 0.0))
    w2 = torch.where(fixed, 0.0, 1.0 / (1.0 + sig))
    y_ls = alm._cg(lambda yy: jvp_c(w2 * vjp_c(yy)), -jvp_c(w2 * g0), y, k)
    return y_ls, torch.where(fixed, 0.0, g0 + vjp_c(y_ls))


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1.0))


@pytest.mark.parametrize("name", PROBLEMS)
def test_block_route_matches_the_torch_func_route(name):
    """At a seeded interior point: ``J t`` and ``J^T y`` from the blocks
    against ``jvp``/``vjp`` through ``can.c``; then one endgame substep
    (``dual_refine_k`` = 4), whose ``y_ls`` and the kernel's ``r_ls`` at the
    substep's new point match the torch.func route run there."""
    can = _can(name)
    inst = can.nlp.inst0
    v = _point(can)
    gen = torch.Generator().manual_seed(1)
    t = torch.randn(v.shape, generator=gen, dtype=v.dtype)
    y = torch.randn(2, can.m, generator=gen, dtype=v.dtype)
    jv, jtv = constraint_jacobian(can)(v, inst)
    c_fn = lambda x: can.c(x, inst)
    assert _rel(jv(t), jvp(c_fn, (v,), (t,))[1]) < 1e-12
    assert _rel(jtv(y), vjp(c_fn, v)[1](y)[0]) < 1e-12

    opts = alm.ALMOptions(**END)
    kern = alm.make_kernel(can, make_condensed_kkt(can, refine=1), opts, inst,
                           v)
    p = _params()
    st = kern.init_state(p, p, False)
    new, _ = kern.substep(st, None, p, p, None)
    y_n = st.yhat + can.c(new.v, inst) / st.gamma[:, None]
    y_ls, r_ls = torch_func_refine(can, inst, new.v, y_n, new.zl, new.zu,
                                   opts.dual_refine_k)
    assert not torch.equal(new.y_ls, y_n)      # the refinement moved y
    assert _rel(new.y_ls, y_ls) < 1e-10
    _, _, _, dl, du = _bound_parts(can, inst, new.v)
    y_b, r_b = kern.dual_refine(new.v, y_n, new.zl, new.zu, dl, du)
    assert _rel(y_b, y_ls) < 1e-10
    assert _rel(r_b, r_ls) < 1e-10


def test_block_route_runs_a_quarter_of_the_torch_func_ops():
    """S10 / tempest at ts=100, float32, two lanes: one dual refinement
    (k = 4) on the blocks runs at most a quarter of the aten operations
    (views excepted) of the torch.func route at the same point; the count
    is ``tools/kkt_ops.py``'s ``dual_refine``."""
    can = _can("s10", torch.float32, 100)
    kern, args = kkt_ops.refine_point(can, 2)
    blocks = kkt_ops.count_ops(kern.dual_refine, *args)
    v, y, zl, zu = args[:4]
    oracle = kkt_ops.count_ops(torch_func_refine, can, can.nlp.inst0, v, y,
                               zl, zu, 4)
    assert 4 * blocks <= oracle, (blocks, oracle)
