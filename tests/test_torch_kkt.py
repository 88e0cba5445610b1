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


# ---------------------------------------------------------------------------
# a bad lane: NaN, not an exception, and the reference's step elsewhere
# ---------------------------------------------------------------------------


def _bad_lanes(kind):
    """Three lanes at ts=8 (S10): lane 0 the good lane of ``_problem``,
    lane 1 a NaN iterate, lane 2 a singular system for the dense KKT (no
    multipliers, barrier or regularization at the initial point: the
    Hessian block is zero and J has fewer rows than free columns) or
    node blocks that are not positive definite for the structured one (a
    primal shift of -1e6)."""
    jc, tc, (V, Y, S, RV, RC, dw, dc) = _problem("S10", 8)
    V = np.stack([V[0], V[1], np.asarray(jc.initial_point())])
    V[1, 5] = np.nan
    Y = np.stack([Y[0], Y[1], np.zeros(jc.m)])
    S = np.stack([S[0], S[1], np.zeros(jc.n) if kind == "dense" else S[0]])
    RV, RC = np.stack([RV[0], RV[1], RV[0]]), np.stack([RC[0], RC[1], RC[0]])
    if kind == "dense":
        dw, dc = np.array([dw[0], dw[1], 0.0]), np.array([dc[0], dc[1], 0.0])
    else:
        dw, dc = np.array([dw[0], dw[1], -1e6]), np.array([dc[0], dc[1],
                                                          dc[0]])
    return jc, tc, (V, Y, S, dw, dc, RV, RC)


def _assert_bad_lanes_match(got, want):
    """(dv, dy): in lanes 1 and 2 the same NaN and inf entries, and a
    non-finite dv; lane 0 within the file's 1e-9."""
    for lane in (1, 2):
        assert not np.isfinite(want[0][lane]).all()
    for g, w in zip(got, want):
        for lane in (1, 2):
            np.testing.assert_array_equal(np.isnan(g[lane]), np.isnan(w[lane]))
            np.testing.assert_array_equal(np.isinf(g[lane]), np.isinf(w[lane]))
        assert np.isfinite(w[0]).all()
        np.testing.assert_allclose(g[0], w[0], rtol=0,
                                   atol=1e-9 * np.abs(w[0]).max())


def test_dense_singular_and_nan_lanes_match_jax():
    """``jnp.linalg.solve`` returns nan/inf on a singular or NaN K; the
    port's dense KKT gives the same entries in that lane and raises
    nothing, and the good lane is untouched."""
    from tol_tpu.solver.kkt_dense import make_dense_kkt as jdense

    jc, tc, (V, Y, S, dw, dc, RV, RC) = _bad_lanes("dense")
    kkt = jdense(jc)
    want = [np.asarray(x) for x in jax.jit(jax.vmap(
        lambda v, y, s, w, c, rv, rc: kkt(v, y, s, w, jnp.full(jc.m, c), rv,
                                           rc)))(
        *[jnp.asarray(a) for a in (V, Y, S, dw, dc, RV, RC)])]
    assert np.isinf(want[0][2]).any()         # a zero pivot: inf, not only NaN
    got = [x.numpy() for x in tdense(tc)(
        *[torch.as_tensor(a) for a in (V, Y, S, dw, dc, RV, RC)])]
    _assert_bad_lanes_match(got, want)


@pytest.mark.parametrize("convexify", [True, False])
def test_structured_nan_and_indefinite_lanes_match_jax(convexify):
    """A NaN iterate (whose node Hessians are NaN: ``torch.linalg.eigh``
    raised on them) and node blocks that are not positive definite give a
    NaN lane in both packages, and the good lane the reference's step."""
    jc, tc, (V, Y, S, dw, dc, RV, RC) = _bad_lanes("structured")
    kkt = jstructured(jc, convexify=convexify)
    want = [np.asarray(x) for x in jax.jit(jax.vmap(kkt))(
        *[jnp.asarray(a) for a in (V, Y, S, dw, dc, RV, RC)])]
    got = [x.numpy() for x in tstructured(tc, convexify=convexify)(
        *[torch.as_tensor(a) for a in (V, Y, S, dw, dc, RV, RC)])]
    _assert_bad_lanes_match(got, want)


# ---------------------------------------------------------------------------
# the structured KKT's eigensolver
# ---------------------------------------------------------------------------


def _symmetric_blocks(n_blocks, n=11, seed=3):
    """Random symmetric blocks with eigenvalues over six decades, both
    signs; every third has a fourfold eigenvalue, every third one
    eigenvalue of 1e-14 and one of -1e-12, and one block is diagonal."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_blocks):
        Qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3)
        if k % 3 == 0:
            lam[:4] = lam[0]
        elif k % 3 == 1:
            lam[2], lam[5] = 1e-14, -1e-12
        out.append((Qm * lam) @ Qm.T)
    out[-1] = np.diag(rng.standard_normal(n))
    A = np.stack(out)
    return 0.5 * (A + A.transpose(0, 2, 1))


def test_jacobi_convexification_matches_eigh():
    """The port's cyclic Jacobi flip ``V max(|lam|, floor) V^T`` equals the
    one the reference builds from ``jnp.linalg.eigh`` within 1e-12 of each
    block's largest entry, with repeated and near-zero eigenvalues; its
    eigenvalues are ``eigh``'s; a NaN block gives a NaN block."""
    from tol_tpu_torch.solver.kkt_structured import (JACOBI_SWEEPS,
                                                     convexify_blocks,
                                                     jacobi_eigh)

    A = _symmetric_blocks(120)
    lam_j, V_j = jnp.linalg.eigh(jnp.asarray(A))
    floor = 1e-8 * (1.0 + jnp.max(jnp.abs(lam_j), axis=-1, keepdims=True))
    want = np.asarray(jnp.einsum("nij,nj,nkj->nik", V_j,
                                 jnp.maximum(jnp.abs(lam_j), floor), V_j))
    got = convexify_blocks(torch.as_tensor(A)).numpy()
    scale = np.abs(want).max((1, 2), keepdims=True)
    assert (np.abs(got - want) / scale).max() <= 1e-12
    lam, _ = jacobi_eigh(torch.as_tensor(A), JACOBI_SWEEPS[torch.float64])
    assert (np.abs(np.sort(lam.numpy(), -1) - np.asarray(lam_j))
            / scale[:, :, 0]).max() <= 1e-12
    bad = torch.as_tensor(A[:2]).clone()
    bad[1, 3, 3] = float("nan")
    out = convexify_blocks(bad)
    assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()
    # (B, T+1, 11, 11) stacks, as the KKT passes them
    got4 = convexify_blocks(torch.as_tensor(A[:6]).reshape(2, 3, 11, 11))
    assert torch.equal(got4.reshape(6, 11, 11), convexify_blocks(
        torch.as_tensor(A[:6])))
