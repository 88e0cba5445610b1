"""The port's G7 mission against tol_tpu's on the same inputs (float64, CPU,
G7 / skywalker / wind model 1): seed path, boundary rows, the canonical form
with its two slacks, the default scaling, and an ALM solve with its trace.

G7's last boundary row (dist - dmax) has a Jacobian that depends on the
point, and the two packages perturb the seed with different random draws
before they take the row norms, so their default scalings differ in that
row.  Every parity test below therefore hands tol_tpu's Scaling to the
port (scaling_from_numpy): both packages then solve the same scaled
problem.  test_default_scalings_differ_only_in_the_dist_row measures the
difference itself.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tol_tpu import api as japi
from tol_tpu.io import params as jparams
from tol_tpu.problems import seed as jseed
from tol_tpu.solver import alm as jalm
from tol_tpu.solver import canonicalize as jcanonicalize
from tol_tpu.solver.kkt_condensed import make_condensed_kkt as jcondensed
from tol_tpu_torch import api as tapi
from tol_tpu_torch.io import params as tparams
from tol_tpu_torch.problems import seed as tseed
from tol_tpu_torch.solver import alm as talm
from tol_tpu_torch.solver.canonical import (canonicalize as tcanonicalize,
                                            scaling_from_numpy)
from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt as tcondensed

TOL = 1e-12
TS = 8


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def g7_pair(ts=TS):
    """(tol_tpu NLP, port NLP, tol_tpu canonical, port canonical with
    tol_tpu's scaling carried across)."""
    jn = japi.make_problem("G7", "skywalker", ts=ts, wind_model=1)
    tn = tapi.make_problem("G7", "skywalker", ts=ts, wind_model=1,
                           device="cpu")
    jc = jcanonicalize(jn, scaling="auto")
    sc = scaling_from_numpy(
        jax.tree_util.tree_map(np.asarray, jc.scaling)._asdict(), device="cpu")
    return jn, tn, jc, tcanonicalize(tn, scaling=sc)


def g7_seeds(jc, n):
    """bench.py's seeds (numpy noise for both packages)."""
    lb, ub, fixed = [np.asarray(x) for x in jc.bounds(jc.nlp.inst0)]
    v0 = np.asarray(jc.initial_point())
    dv = 0.01 * np.random.default_rng(1).standard_normal((n, jc.n))
    return np.where(fixed, lb, np.clip(v0 + dv, lb, ub))


def g7_params(**kw):
    """bench.py's G7 endgame numerics in float64 for both packages."""
    base = dict(tol=5e-3, feas_tol=1e-4, mu_init=6e-5, mu_min=1e-5,
                mu_shrink=0.1, theta_mu=1.2, gamma_init=0.01, gamma_min=5e-6,
                gamma_shrink=0.12, prox=2.5e-3, eta=1e-4, tau_min=0.99,
                kappa_inner=2.0, delta_decay=0.2, gamma_eager=1.0,
                max_iter=600)
    base.update(kw)
    mi = base.pop("max_iter")
    pj = jalm.ALMParams(**{k: jnp.asarray(v, jnp.float64)
                           for k, v in base.items()},
                        max_iter=jnp.asarray(mi, jnp.int32))
    pt = talm.alm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, pj)._asdict(), device="cpu")
    return pj, pt


def test_g7_seed_path_and_inversion_match():
    ac = jparams.load_aircraft("skywalker", jparams.assets_root())
    act = tparams.load_aircraft("skywalker", tparams.assets_root())
    chi = 0.7
    for kw in (dict(vamin=ac.Vamin, vamax=ac.Vamax), dict()):
        jpath = jseed.g7_seed_path(24, jnp.asarray(chi), **kw)
        tpath = tseed.g7_seed_path(24, chi, **kw)
        for a, b in zip(tpath, jpath):
            _close(a, b)
        Zt, dtt = tseed.invert_flight_mechanics(tpath, act, False)
        Zj, dtj = jseed.invert_flight_mechanics(jpath, ac, False)
        _close(Zt, Zj)
        _close(dtt, dtj)


def test_g7_rows_cost_and_inequalities_match():
    jn, tn, _, _ = g7_pair()
    assert tn.nb == jn.nb == 12
    assert tn.boundary_is_ineq.tolist() == jn.boundary_is_ineq.tolist()
    assert np.flatnonzero(tn.boundary_is_ineq).tolist() == [1, 11]
    Zj, dtj = jn.seed()
    Zt, dtt = tn.seed()
    _close(Zt, Zj)
    _close(dtt, dtj)
    rng = np.random.default_rng(2)
    Z = np.asarray(Zj) + rng.normal(scale=0.05, size=Zj.shape)
    dt = float(dtj) * 1.03
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)
    for Zp, dp in [(np.asarray(Zj), float(dtj)), (Z, dt)]:
        a, b = f64(Zp), jnp.asarray(Zp)
        _close(tn.boundary(a[0], a[-1], f64(dp)),
               jn.boundary(b[0], b[-1], jnp.asarray(dp)))
        _close(tn.constraints(a, f64(dp)), jn.constraints(b, jnp.asarray(dp)))
        _close(tn.total_cost(a, f64(dp)), jn.total_cost(b, jnp.asarray(dp)))
    _close(tn.z_lo, jn.z_lo)
    _close(tn.z_up, jn.z_up)
    # batched evaluation = per-lane evaluation
    Zb = f64(np.stack([Z, Z + 0.01]))
    dtb = f64([dt, dt * 1.01])
    for i in range(2):
        _close(tn.constraints(Zb, dtb)[i], tn.constraints(Zb[i], dtb[i]))


def test_g7_canonical_form_matches_with_scaling_carried():
    _, _, jc, tc = g7_pair()
    assert (tc.n, tc.m, tc.n_slack) == (jc.n, jc.m, jc.n_slack)
    assert tc.n_slack == 2
    for a, b in zip(tc.bounds(tc.nlp.inst0), jc.bounds(jc.nlp.inst0)):
        _close(a, b)
    v0j = jc.initial_point()
    _close(tc.initial_point(), v0j)         # includes the interior slacks
    V = g7_seeds(jc, 3)
    fj = jax.vmap(lambda v: jc.f(v, jc.nlp.inst0))(jnp.asarray(V))
    cj = jax.vmap(lambda v: jc.c(v, jc.nlp.inst0))(jnp.asarray(V))
    _close(tc.f(torch.tensor(V), tc.nlp.inst0), fj)
    _close(tc.c(torch.tensor(V), tc.nlp.inst0), cj)
    Zj, dtj, sj = jc.split(jnp.asarray(V[0]))
    Zt, dtt, st = tc.split(torch.tensor(V))
    _close(Zt[0], Zj)
    _close(dtt[0], dtj)
    _close(st[0], sj)
    _close(tc.join(Zt, dtt, st), V)
    _close(tc.v_scale(), jc.v_scale())
    _close(tc.to_physical(torch.tensor(V))[1], jc.to_physical(jnp.asarray(V[1])))


@pytest.mark.parametrize("ts,dtype,factor", [(8, "float64", 1.1747),
                                             (100, "float64", 1.1747),
                                             (100, "float32", 0.9953)])
def test_default_scalings_differ_only_in_the_dist_row(ts, dtype, factor):
    """The two default scalings of G7 / skywalker, row by row.  Rows 0-10
    are linear in the point (the displacement pair in its reformulated
    form, the periodicity rows), so their norms do not see the packages'
    different perturbations and agree to round-off.  Row 11, dist - dmax,
    does.  tol_tpu draws other PRNGKey(0) numbers for float32 than for
    float64, the port one torch.Generator(0) draw for both: the port's row
    scale is 1.1747 times tol_tpu's in float64 and 0.9953 times in float32
    (the type the solves on the card run in), at ts=8 and at ts=100 alike
    (the seed path's end points do not depend on ts).  A factor above 2
    would be a fault of the port's draw; these are not."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = TOL if dtype == "float64" else 1e-6
    jn = japi.make_problem("G7", "skywalker", ts=ts, wind_model=1, dtype=jd)
    tn = tapi.make_problem("G7", "skywalker", ts=ts, wind_model=1, dtype=td,
                           device="cpu")
    sj = jcanonicalize(jn, scaling="auto").scaling
    st = tcanonicalize(tn, scaling="auto").scaling
    assert st.r_b.dtype == td
    _close(st.d_z, sj.d_z, tol)
    _close(st.d_dt, sj.d_dt, tol)
    _close(st.s_f, sj.s_f, tol)
    ratio = st.r_b.double().numpy() / np.asarray(sj.r_b, np.float64)
    np.testing.assert_allclose(ratio[:11], 1.0, rtol=0, atol=tol)
    assert 0.5 < ratio[11] < 2.0
    assert abs(ratio[11] - factor) < 1e-3


def test_g7_alm_solve_and_trace_end_where_jax_ends():
    """Three lanes of G7 at ts=8 with bench.py's G7 numerics (endgame body:
    8 Armijo trials, dual CG k=4, refine=1) for a budget of 40 iterations,
    which both packages spend in full.  tol_tpu runs in trace mode (a
    fixed-length scan), which also gives the per-iteration record that the
    port's ALMOptions.trace must reproduce.  Tolerance: 40 Newton steps,
    each amplifying round-off by the dual recovery's 1/gamma."""
    _, _, jc, tc = g7_pair()
    N = 40
    V = g7_seeds(jc, 3)
    pj, pt = g7_params(max_iter=N)
    kw = dict(max_iter=N, dual_refine_k=4, max_ls=8, trace=True)
    kj = jcondensed(jc, refine=1, chain="crp")
    rj = jax.jit(jax.vmap(lambda v: jalm.solve(
        jc, kj, jalm.ALMOptions(**kw), v0=v, params=pj)))(jnp.asarray(V))
    kt = tcondensed(tc, refine=1, chain="crp")
    rt = talm.solve(tc, kt, talm.ALMOptions(**kw), v0=torch.tensor(V),
                    params=pt)
    assert rt.iterations.tolist() == np.asarray(rj.iterations).tolist() == [N] * 3
    assert rt.converged.tolist() == np.asarray(rj.converged).tolist()
    _close(rt.v, rj.v, 1e-7)
    _close(rt.f, rj.f, 1e-7)
    _close(rt.constr_viol, rj.constr_viol, 1e-7)
    assert len(rt.trace) == len(rj.trace) == 6
    for name, a, b in zip(("kkt", "mu", "gamma", "delta_w", "viol", "f"),
                          rt.trace, rj.trace):
        assert a.shape == (3, N), name
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=1e-6,
            atol=1e-7 * max(1.0, np.abs(np.asarray(b)).max()), err_msg=name)
    # without trace the port's loop gives the same lanes, bit for bit
    r0 = talm.solve(tc, kt, talm.ALMOptions(**dict(kw, trace=False)),
                    v0=torch.tensor(V), params=pt)
    assert r0.trace is None
    assert torch.equal(r0.v, rt.v) and torch.equal(r0.f, rt.f)
    # a finished lane repeats its last record: budget 3 inside a trace of 5
    r5 = talm.solve(tc, kt, talm.ALMOptions(**dict(kw, max_iter=5)),
                    v0=torch.tensor(V),
                    params=pt._replace(max_iter=torch.tensor(
                        3, dtype=torch.int32)))
    assert r5.iterations.tolist() == [3] * 3
    for a in r5.trace:
        assert a.shape == (3, 5)
        assert torch.equal(a[:, 2], a[:, 3]) and torch.equal(a[:, 2], a[:, 4])
    assert torch.equal(r5.trace[5][:, :3], rt.trace[5][:, :3])


@pytest.mark.slow
def test_g7_float32_ts100_needs_no_more_iterations_than_jax():
    """G7 at the bench's size (ts=100) in float32, four lanes, the endgame
    body with bench.py's G7 numerics and a budget of 600 iterations, each
    package with its own default scaling.  Float32 solves of the two
    packages part ways after some 40 iterations, so lanes are compared by
    their counts: every lane of the port converges, and its median count is
    within a quarter of tol_tpu's.

    This holds the Cholesky column to the quotient s / sqrt(p)
    (ops/crkern.py, csrc/crkern_block.cuh): with s * (1 / sqrt(p)) the same
    lanes need 496-600 iterations against tol_tpu's 299-423."""
    N, budget = 4, 600
    jn = japi.make_problem("G7", "skywalker", ts=100, wind_model=1,
                           dtype=jnp.float32)
    tn = tapi.make_problem("G7", "skywalker", ts=100, wind_model=1,
                           dtype=torch.float32, device="cpu")
    jc = jcanonicalize(jn, scaling="auto")
    tc = tcanonicalize(tn, scaling="auto")
    V = g7_seeds(jc, N).astype(np.float32)
    pj, pt = g7_params(max_iter=budget)
    pj = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.float64 else x, pj)
    pt = talm.alm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, pj)._asdict(), device="cpu")
    kw = dict(max_iter=2000, dual_refine_k=4, max_ls=8, factor_reuse=1)
    kj = jcondensed(jc, refine=1, chain="crp")
    rj = jax.jit(jax.vmap(lambda v: jalm.solve(
        jc, kj, jalm.ALMOptions(**kw), v0=v, params=pj)))(jnp.asarray(V))
    rt = talm.solve(tc, tcondensed(tc, refine=1, chain="crp"),
                    talm.ALMOptions(**kw), v0=torch.tensor(V), params=pt)
    assert rt.v.dtype == torch.float32 and rj.v.dtype == jnp.float32
    assert np.asarray(rj.converged).all()
    assert rt.converged.all()
    assert (rt.constr_viol < 1e-4).all()
    it_j = np.median(np.asarray(rj.iterations))
    it_t = np.median(rt.iterations.numpy())
    assert it_t <= 1.25 * it_j, (rt.iterations.tolist(),
                                 np.asarray(rj.iterations).tolist())
