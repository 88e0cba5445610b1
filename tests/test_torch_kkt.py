"""The port's condensed KKT backend (chains "crp", "pallas", "scan", "cr",
"spike")
against tol_tpu's at the same iterate, and against the port's dense oracle
(float64, CPU).

The state is the one tests/test_kkt_backends.py uses: the unscaled problem
(S10, and G7 with its two slacks) at a perturbed seed, random multipliers
and barrier diagonal, a large primal shift so that the condensed system is
SPD.
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
from tol_tpu.solver.kkt_structured import make_structured_kkt as jstructured
from tol_tpu_torch.api import make_problem as tmake_problem
from tol_tpu_torch.solver.canonical import canonicalize as tcanonicalize
from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt as tcondensed
from tol_tpu_torch.solver.kkt_dense import make_dense_kkt as tdense
from tol_tpu_torch.solver.kkt_structured import make_structured_kkt as tstructured

TS, B = 12, 2


AIRCRAFT = {"S10": "tempest", "G7": "skywalker"}


@functools.lru_cache(maxsize=None)
def _problem(mission="S10", ts=TS):
    jc = jcanonicalize(jmake_problem(mission, AIRCRAFT[mission], ts=ts,
                                     wind_model=1))
    tc = tcanonicalize(tmake_problem(mission, AIRCRAFT[mission], ts=ts,
                                     wind_model=1, device="cpu"))
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


def _jax_solve(refine, chain="crp", mission="S10", ts=TS):
    jc, _, (V, Y, S, RV, RC, dw, dc) = _problem(mission, ts)
    kkt = jcondensed(jc, refine=refine, chain=chain)
    # B is not a multiple of 128: crp and pallas take their reference paths
    # under vmap, as tol_tpu's own tests run them on the CPU.
    dv, dy = jax.jit(jax.vmap(
        lambda v, y, s, w, c, rv, rc: kkt(v, y, s, w, jnp.full(jc.m, c), rv,
                                           rc)))(
        *[jnp.asarray(a) for a in (V, Y, S, dw, dc, RV, RC)])
    return np.asarray(dv), np.asarray(dy)


def _torch_args(mission="S10", ts=TS):
    _, tc, arrs = _problem(mission, ts)
    return tc, [torch.as_tensor(a) for a in arrs]


@functools.lru_cache(maxsize=None)
def _dense(mission, ts):
    tc, (V, Y, S, RV, RC, dw, dc) = _torch_args(mission, ts)
    return tdense(tc)(V, Y, S, dw, dc, RV, RC)


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


@pytest.mark.parametrize("mission", ["S10", "G7"])
@pytest.mark.parametrize("chain", ["crp", "pallas", "scan", "cr", "spike"])
def test_condensed_chains_match_jax_and_dense(mission, chain):
    """Every chain at ts=8, refine=1, on S10 (border 12) and on G7 (two
    slacks, border 14).  Against tol_tpu: the same elimination, whose block
    products XLA may sum in another order (1e-9 of the solution's size).
    Against the dense solve of the same saddle system: the condensed
    system's conditioning ~ ||J||^2 / Gamma (1e-8)."""
    tc, (V, Y, S, RV, RC, dw, dc) = _torch_args(mission, 8)
    assert tc.n_slack == (2 if mission == "G7" else 0)
    dv, dy = tcondensed(tc, refine=1, chain=chain).prepare(V, Y, S, dw, dc)(
        RV, RC)
    dv_j, dy_j = _jax_solve(1, chain, mission, 8)
    assert np.isfinite(dv_j).all()
    np.testing.assert_allclose(dv.numpy(), dv_j, rtol=0,
                               atol=1e-9 * np.abs(dv_j).max())
    np.testing.assert_allclose(dy.numpy(), dy_j, rtol=0,
                               atol=1e-9 * np.abs(dy_j).max())
    dv_d, dy_d = _dense(mission, 8)
    assert (dv - dv_d).abs().max() <= 1e-8 * dv_d.abs().max()
    assert (dy - dy_d).abs().max() <= 1e-8 * dy_d.abs().max()


@pytest.mark.parametrize("mission", ["S10", "G7"])
@pytest.mark.parametrize("convexify", [False, True])
def test_structured_matches_jax_and_dense(mission, convexify):
    """The structured backend at ts=8 on S10 and on G7 (two slacks in the
    border).  Against tol_tpu's: the same sweeps, whose Cholesky solves XLA
    runs through LAPACK and the port through its unrolled recurrences
    (1e-9 of the solution's size).  With the exact Hessian
    (convexify=False) it solves the dense backend's system (1e-8); with the
    eigenvalue flip it solves another system where a node block is
    indefinite, so only tol_tpu is the reference."""
    jc, tc, (V, Y, S, RV, RC, dw, dc) = _problem(mission, 8)
    kkt = jstructured(jc, convexify=convexify)
    dv_j, dy_j = [np.asarray(x) for x in jax.jit(jax.vmap(kkt))(
        *[jnp.asarray(a) for a in (V, Y, S, dw, dc, RV, RC)])]
    assert np.isfinite(dv_j).all()
    dv, dy = tstructured(tc, convexify=convexify)(
        *[torch.as_tensor(a) for a in (V, Y, S, dw, dc, RV, RC)])
    np.testing.assert_allclose(dv.numpy(), dv_j, rtol=0,
                               atol=1e-9 * np.abs(dv_j).max())
    np.testing.assert_allclose(dy.numpy(), dy_j, rtol=0,
                               atol=1e-9 * np.abs(dy_j).max())
    if not convexify:
        dv_d, dy_d = _dense(mission, 8)
        assert (dv - dv_d).abs().max() <= 1e-8 * dv_d.abs().max()
        assert (dy - dy_d).abs().max() <= 1e-8 * dy_d.abs().max()


def test_other_chains_raise_until_ported():
    """Every chain of tol_tpu is ported; a chain neither package has is a
    ValueError that names the ones there are."""
    tc, _ = _torch_args()
    for chain in ("scan", "cr", "pallas", "spike"):
        assert callable(tcondensed(tc, chain=chain))
    with pytest.raises(ValueError, match="unknown chain.*spike"):
        tcondensed(tc, chain="qr")
