"""The port's condensed KKT backend (chain "crp") against tol_tpu's at the
same iterate, and against the port's dense oracle (float64, CPU).

The state is the one tests/test_kkt_backends.py uses: the unscaled S10
problem at a perturbed seed, random multipliers and barrier diagonal, a
large primal shift so that the condensed system is SPD.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tol_tpu.api import make_problem as jmake_problem
from tol_tpu.solver import canonicalize as jcanonicalize
from tol_tpu.solver.kkt_condensed import make_condensed_kkt as jcondensed
from tol_tpu_torch.api import make_problem as tmake_problem
from tol_tpu_torch.solver.canonical import canonicalize as tcanonicalize
from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt as tcondensed
from tol_tpu_torch.solver.kkt_dense import make_dense_kkt as tdense

TS, B = 12, 2


@functools.lru_cache(maxsize=None)
def _problem():
    jc = jcanonicalize(jmake_problem("S10", "tempest", ts=TS, wind_model=1))
    tc = tcanonicalize(tmake_problem("S10", "tempest", ts=TS, wind_model=1,
                                     device="cpu"))
    rng = np.random.default_rng(0)
    lb, ub, fixed = [np.asarray(x) for x in jc.bounds(jc.nlp.inst0)]
    v0 = np.asarray(jc.initial_point())
    V = np.where(fixed, lb, np.clip(v0 + rng.normal(scale=0.01, size=(B, jc.n)),
                                    lb, ub))
    Y = rng.normal(scale=0.3, size=(B, jc.m))
    S = rng.uniform(0.1, 2.0, size=(B, jc.n))
    RV = np.where(fixed, 0.0, rng.normal(size=(B, jc.n)))
    RC = rng.normal(size=(B, jc.m))
    dw = np.array([300.0, 120.0])          # per-lane primal shift
    dc = np.array([0.05, 0.02])            # per-lane Gamma
    return jc, tc, (V, Y, S, RV, RC, dw, dc)


def _jax_solve(refine):
    jc, _, (V, Y, S, RV, RC, dw, dc) = _problem()
    kkt = jcondensed(jc, refine=refine, chain="crp")
    # B is not a multiple of 128: crp takes its reference path under vmap,
    # as tol_tpu's own tests run it on the CPU.
    dv, dy = jax.jit(jax.vmap(
        lambda v, y, s, w, c, rv, rc: kkt(v, y, s, w, jnp.full(jc.m, c), rv,
                                           rc)))(
        *[jnp.asarray(a) for a in (V, Y, S, dw, dc, RV, RC)])
    return np.asarray(dv), np.asarray(dy)


def _torch_args():
    _, tc, arrs = _problem()
    return tc, [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("refine", [1, 0])
def test_condensed_crp_matches_jax(refine):
    """Same factorization order on both sides; float64 round-off only."""
    tc, (V, Y, S, RV, RC, dw, dc) = _torch_args()
    kkt = tcondensed(tc, refine=refine, chain="crp")
    dv, dy = kkt.prepare(V, Y, S, dw, dc)(RV, RC)
    dv_j, dy_j = _jax_solve(refine)
    assert np.isfinite(dv_j).all()
    np.testing.assert_allclose(dv.numpy(), dv_j, rtol=0,
                               atol=1e-12 * np.abs(dv_j).max())
    # dy = Gamma^-1 (J dv - rhs_c) amplifies dv's round-off by 1/Gamma
    np.testing.assert_allclose(dy.numpy(), dy_j, rtol=0,
                               atol=1e-11 * np.abs(dy_j).max())
    # kkt_solve = prepare(...)(...) in one call
    dv2, _ = kkt(V, Y, S, dw, dc, RV, RC)
    assert torch.equal(dv2, dv)


def test_condensed_crp_matches_dense_oracle():
    """refine=1 against the dense O((n+m)^3) solve of the same saddle system
    (tolerance: the condensed system's conditioning ~ ||J||^2 / Gamma)."""
    tc, (V, Y, S, RV, RC, dw, dc) = _torch_args()
    dv, dy = tcondensed(tc, refine=1, chain="crp").prepare(V, Y, S, dw, dc)(RV,
                                                                           RC)
    dv_d, dy_d = tdense(tc)(V, Y, S, dw, dc, RV, RC)
    assert (dv - dv_d).abs().max() <= 1e-9 * dv_d.abs().max()
    assert (dy - dy_d).abs().max() <= 1e-9 * dy_d.abs().max()


def test_other_chains_raise_until_ported():
    tc, _ = _torch_args()
    for chain in ("scan", "cr", "pallas", "spike"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tcondensed(tc, chain=chain)
