"""The port's sequential-chain ops and crp_factor against tol_tpu's on the
same seeded inputs (float64, CPU).

The JAX side runs as tol_tpu's own tests run it on the CPU: a 128-wide
batch under vmap drives the Pallas kernels in interpret mode.  The port's
side runs the plain twins of K5-K8 (CPU tensors), and the kernels'
__host__ __device__ block routines built for the host with g++.
"""

import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tol_tpu.ops import chainkern as jch
from tol_tpu.ops import crkern as jck
from tol_tpu.ops import spike as jspike
from tol_tpu_torch.ops import chainkern as tch
from tol_tpu_torch.ops import crkern as tck
from tol_tpu_torch.ops import spike as tspike

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tol_tpu_torch", "csrc")

# Same arithmetic in the same order on both sides, float64.
TOL = 1e-12
NB = 11
NAN_LANE = 5


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _bordered_chains(rng, B, T, nC, nan_lane=None):
    """B diagonally dominant SPD chains of T 11x11 blocks with nC border
    columns; ``nan_lane`` gets an indefinite pivot at block 2."""
    A = rng.normal(size=(B, T, NB, NB))
    M = A @ np.swapaxes(A, -1, -2) + NB * np.eye(NB)
    O = 0.3 * rng.normal(size=(B, T, NB, NB))
    O[:, -1] = 0.0
    R = rng.normal(size=(B, T, NB, nC))
    if nan_lane is not None:
        M[nan_lane, 2] = -np.eye(NB)
    return M, O, R


def _close(got, want, tol=TOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                               atol=tol * max(1.0, np.abs(want[ok]).max()))


@pytest.mark.parametrize("nC,T", [(12, 8), (14, 13)])
def test_chain_ops_match_pallas_kernels_in_interpret_mode(nC, T):
    """chain_eliminate, chain_rhs_forward and chain_back_sub, 128 lanes, one
    of them with an indefinite pivot: NaN there from that block on and in S,
    in both packages, and nowhere else."""
    rng = np.random.default_rng(10 + nC)
    B = 128
    M, O, R = _bordered_chains(rng, B, T, nC, nan_lane=NAN_LANE)
    r = rng.normal(size=(B, T, NB))
    coef = rng.normal(size=(B, nC + 1))
    j = lambda *xs: [jnp.asarray(x) for x in xs]

    Dj, t2j, tRj, Sj = jax.vmap(jch.chain_eliminate)(*j(M, O, R))
    Dt, t2t, tRt, St = tch.chain_eliminate(_t(M), _t(O), _t(R))
    for got, want in [(Dt, Dj), (t2t, t2j), (tRt, tRj), (St, Sj)]:
        _close(got, want)
    nan = torch.isnan(Dt).flatten(2).any(2)               # (B, T)
    assert nan[NAN_LANE].tolist() == [False, False] + [True] * (T - 2)
    assert int(nan.any(1).sum()) == 1
    assert torch.isnan(St).flatten(1).any(1).tolist() == \
        [i == NAN_LANE for i in range(B)]

    trj, sbj = jax.vmap(jch.chain_rhs_forward)(Dj, jnp.asarray(O), tRj,
                                               jnp.asarray(r))
    trt, sbt = tch.chain_rhs_forward(Dt, _t(O), tRt, _t(r))
    _close(trt, trj)
    _close(sbt, sbj)

    tRfull_j = jnp.concatenate([tRj, trj[..., None]], axis=3)
    xj = jax.vmap(jch.chain_back_sub)(tRfull_j, t2j, jnp.asarray(coef))
    xt = tch.chain_back_sub(torch.cat([tRt, trt[..., None]], dim=3), t2t,
                            _t(coef))
    _close(xt, xj)
    assert torch.isnan(xt).flatten(1).any(1).tolist() == \
        [i == NAN_LANE for i in range(B)]


def test_chain_twins_match_the_scan_references():
    """A batch that is not a multiple of 128 takes tol_tpu's unbatched scan
    path; the port has one path for every B."""
    rng = np.random.default_rng(12)
    B, T, nC = 3, 8, 12
    M, O, R = _bordered_chains(rng, B, T, nC)
    r = rng.normal(size=(B, T, NB))
    coef = rng.normal(size=(B, nC + 1))
    Dt, t2t, tRt, St = tch.chain_eliminate(_t(M), _t(O), _t(R))
    trt, sbt = tch.chain_rhs_forward(Dt, _t(O), tRt, _t(r))
    xt = tch.chain_back_sub(torch.cat([tRt, trt[..., None]], dim=3), t2t,
                            _t(coef))
    for i in range(B):
        Dj, t2j, tRj, Sj = jch._scan_eliminate(*[jnp.asarray(a[i])
                                                 for a in (M, O, R)])
        trj, sbj = jch._scan_rhs_forward(Dj, jnp.asarray(O[i]), tRj,
                                         jnp.asarray(r[i]))
        xj = jch._scan_back_sub(jnp.concatenate([tRj, trj[..., None]], axis=2),
                                t2j, jnp.asarray(coef[i]))
        # the scan references sum in XLA's order, not the kernels'
        for got, want in [(Dt[i], Dj), (t2t[i], t2j), (tRt[i], tRj),
                          (St[i], Sj), (trt[i], trj), (sbt[i], sbj),
                          (xt[i], xj)]:
            _close(got, want, tol=1e-10)


def test_chain_solves_the_bordered_system():
    """The three ops together solve [[K, W], [W^T, B0]] [x; beta] = [r; rB]
    as kkt_condensed uses them, against a dense solve."""
    rng = np.random.default_rng(13)
    B, T, nB = 2, 8, 12
    M, O, W = _bordered_chains(rng, B, T, nB)
    r = rng.normal(size=(B, T, NB))
    A0 = rng.normal(size=(B, nB, nB))
    B0 = A0 @ np.swapaxes(A0, 1, 2) + 40.0 * np.eye(nB)
    rB = rng.normal(size=(B, nB))
    Dinv, t2, tRw, Sw = tch.chain_eliminate(_t(M), _t(O), _t(W))
    tr, sb = tch.chain_rhs_forward(Dinv, _t(O), tRw, _t(r))
    beta = torch.linalg.solve(_t(B0) - Sw, _t(rB) - sb)
    coef = torch.cat([-beta, torch.ones(B, 1, dtype=beta.dtype)], dim=1)
    x = tch.chain_back_sub(torch.cat([tRw, tr[..., None]], dim=3), t2, coef)
    for i in range(B):
        K = np.zeros((T * NB + nB, T * NB + nB))
        for k in range(T):
            s = slice(k * NB, (k + 1) * NB)
            K[s, s] = M[i, k]
            K[s, T * NB:] = W[i, k]
            K[T * NB:, s] = W[i, k].T
            if k + 1 < T:
                t = slice((k + 1) * NB, (k + 2) * NB)
                K[s, t] = O[i, k]
                K[t, s] = O[i, k].T
        K[T * NB:, T * NB:] = B0[i]
        want = np.linalg.solve(K, np.concatenate([r[i].ravel(), rB[i]]))
        np.testing.assert_allclose(x[i].numpy().ravel(), want[:T * NB],
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(beta[i].numpy(), want[T * NB:], rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("N", [10, 16])
def test_crp_factor_matches_pallas_kernels_in_interpret_mode(N):
    """crp_factor + crp_solve (the K5 path) against tol_tpu's pair under a
    128-wide vmap, with a NaN lane; and crp_factor's factor is the one
    crp_factor_solve returns."""
    rng = np.random.default_rng(14)
    B, b = 128, 11
    A = rng.normal(size=(B, N, b, b))
    M = A @ np.swapaxes(A, -1, -2) + b * np.eye(b)
    O = 0.3 * rng.normal(size=(B, N, b, b))
    O[:, -1] = 0.0
    M[NAN_LANE, 3] = -np.eye(b)
    F = rng.normal(size=(B, 16, b, 2))
    F[:, N:] = 0.0

    def jax_pair(M, O, F):
        lv, ri = jck.crp_factor(M, O)
        return jck.crp_solve(lv, ri, F)

    Xj = jax.vmap(jax_pair)(jnp.asarray(M), jnp.asarray(O), jnp.asarray(F))
    lv, ri = tck.crp_factor(_t(M), _t(O))
    X = tck.crp_solve(lv, ri, _t(F))
    _close(X, Xj)
    assert torch.isnan(X).flatten(1).any(1).tolist() == \
        [i == NAN_LANE for i in range(B)]
    lv2, ri2, _ = tck.crp_factor_solve(_t(M), _t(O), _t(F[:, :N]))
    for (a, b_, c), (a2, b2, c2) in zip(lv, lv2):
        for u, v in ((a, a2), (b_, b2), (c, c2)):
            assert torch.equal(torch.nan_to_num(u), torch.nan_to_num(v))
    assert torch.equal(torch.nan_to_num(ri), torch.nan_to_num(ri2))


@pytest.mark.parametrize("n,L", [(23, 10), (8, 3), (10, 10), (7, 2)])
def test_spike_matches_jax_and_solves_the_chain(n, L):
    """spike_factor + spike_solve, batch-first, against tol_tpu's under vmap
    (same elimination; XLA may sum the block products in another order:
    1e-11) and against the dense solve of the chain; a lane with an
    indefinite pivot is NaN alone."""
    rng = np.random.default_rng(17)
    B, m = 3, 2
    M, O, _ = _bordered_chains(rng, B, n, 1)
    f = rng.normal(size=(B, n, NB, m))
    Xj = jax.vmap(lambda M, O, f: jspike.spike_solve(
        jspike.spike_factor(M, O, L), f))(*[jnp.asarray(a) for a in (M, O, f)])
    X = tspike.spike_solve(tspike.spike_factor(_t(M), _t(O), L), _t(f))
    _close(X, Xj, tol=1e-11)
    for i in range(B):
        K = np.zeros((n * NB, n * NB))
        for k in range(n):
            s = slice(k * NB, (k + 1) * NB)
            K[s, s] = M[i, k]
            if k + 1 < n:
                t = slice((k + 1) * NB, (k + 2) * NB)
                K[s, t] = O[i, k]
                K[t, s] = O[i, k].T
        want = np.linalg.solve(K, f[i].reshape(n * NB, m))
        np.testing.assert_allclose(X[i].numpy().reshape(n * NB, m), want,
                                   rtol=0, atol=1e-10)
    M[1, 0] = -np.eye(NB)
    Xn = tspike.spike_solve(tspike.spike_factor(_t(M), _t(O), L), _t(f))
    assert torch.isnan(Xn).flatten(1).any(1).tolist() == [False, True, False]
    with pytest.raises(ValueError, match="L must be >= 2"):
        tspike.spike_factor(_t(M), _t(O), 1)


_SHIM = r"""
#include <vector>
#include "chainkern_block.cuh"
typedef const double* In;
typedef double* Out;
using crk::NB;
// K6 over B lanes by the block-step routines: the three phases, the
// columns of each phase in turn, per-lane scratch at stride 1.
template <typename T>
void chain_factor_steps(const T* M, const T* O, const T* R, T* Dinv, T* t2,
                        T* tR, T* S, int Tn, int nC, long B) {
  const int n2 = NB * NB;
  for (long b = 0; b < B; ++b) {
    std::vector<T> Lc(n2), Dv(n2), dcorr(n2, T(0)), Rt(NB * nC),
        rcorr(NB * nC, T(0)), sacc(nC * nC, T(0));
    for (int i = 0; i < Tn; ++i) {
      const T* Mi = M + (long)i * n2 * B + b;
      const T* Oi = O + (long)i * n2 * B + b;
      const T* Ri = R + (long)i * NB * nC * B + b;
      crk::chain_chol<T>(Mi, B, dcorr.data(), 1, Lc.data(), 1);
      for (int q = 0; q < nC; ++q)
        crk::chain_rt_column<T>(Ri, B, rcorr.data(), 1, Rt.data(), 1, nC, q);
      for (int c = 0; c < NB; ++c)
        crk::chain_inverse_column<T>(Lc.data(), 1, c, Dv.data(), 1,
                                     Dinv + (long)i * n2 * B + b, B);
      for (int q = 0; q < NB + nC; ++q)
        crk::chain_factor_column<T>(
            Dv.data(), 1, Oi, B, Rt.data(), 1, t2 + (long)i * n2 * B + b,
            tR + (long)i * NB * nC * B + b, B, dcorr.data(), 1, rcorr.data(), 1,
            sacc.data(), 1, nC, q);
    }
    for (int e = 0; e < nC * nC; ++e) S[(long)e * B + b] = sacc[e];
  }
}
// K6 by the whole-chain routine, lane group after lane group.
template <typename T>
void chain_factor_pass(const T* M, const T* O, const T* R, T* Dinv, T* t2,
                       T* tR, T* S, int Tn, int nC, long B, int G) {
  std::vector<T> smem(G * crk::chain_factor_floats(nC));
  for (long l0 = 0; l0 < B; l0 += G)
    crk::chain_factor_pass(crk::SerialChainTeam{}, M, O, R, Dinv, t2, tR, S,
                           Tn, nC, B, l0, G, smem.data());
}
// K7 by the block-step routine.
template <typename T>
void rhs_forward_steps(const T* Dinv, const T* O, const T* tRw, const T* r,
                       T* tr, T* sb, int Tn, int nB, long B) {
  const int n2 = NB * NB;
  for (long b = 0; b < B; ++b) {
    T rcorr[NB] = {0};
    std::vector<T> acc(nB, T(0));
    for (int i = 0; i < Tn; ++i)
      crk::chain_rhs_forward_block<T>(
          Dinv + (long)i * n2 * B + b, O + (long)i * n2 * B + b,
          tRw + (long)i * NB * nB * B + b, r + (long)i * NB * B + b,
          tr + (long)i * NB * B + b, B, rcorr, acc.data(), 1, nB);
    for (int p = 0; p < nB; ++p) sb[(long)p * B + b] = acc[p];
  }
}
// K7 by the whole-chain routine, C steps a chunk.
template <typename T>
void rhs_forward_pass(const T* Dinv, const T* O, const T* tRw, const T* r,
                      T* tr, T* sb, int Tn, int nB, long B, int G, int C) {
  std::vector<T> smem(G * crk::rhs_forward_floats(nB, C));
  for (long l0 = 0; l0 < B; l0 += G)
    crk::rhs_forward_pass(crk::SerialChainTeam{}, Dinv, O, tRw, r, tr, sb, Tn,
                          nB, B, l0, G, C, smem.data());
}
// K8 by the block-step routine.
template <typename T>
void back_sub_steps(const T* tR, const T* t2, const T* coef, T* x, int Tn,
                    int nC, long B) {
  const int n2 = NB * NB;
  for (long b = 0; b < B; ++b) {
    T xn[NB] = {0};
    for (int i = Tn - 1; i >= 0; --i)
      crk::chain_back_sub_block<T>(
          tR + (long)i * NB * nC * B + b, t2 + (long)i * n2 * B + b, coef + b, B,
          x + (long)i * NB * B + b, B, xn, nC);
  }
}
// K8 by the whole-chain routine, Tc steps a chunk.
template <typename T>
void back_sub_pass(const T* tR, const T* t2, const T* coef, T* x, int Tn,
                   int nC, long B, int G, int Tc) {
  std::vector<T> smem(G * crk::back_sub_floats(Tc));
  for (long l0 = 0; l0 < B; l0 += G)
    crk::back_sub_pass(crk::SerialChainTeam{}, tR, t2, coef, x, Tn, nC, B, l0,
                       G, Tc, smem.data());
}
extern "C" {
// K5 over L columns.
void h_factor(In Mo, In Me, In OL, In OR, Out a, Out b, Out c, Out d, long L) {
  for (long k = 0; k < L; ++k) {
    double inv[NB * NB];
    crk::factor_column<double>(Mo + k, Me + k, OL + k, OR + k, a + k, b + k,
                               c + k, d + k, L, inv);
  }
}
void h_chain_factor(In M, In O, In R, Out Dinv, Out t2, Out tR, Out S, int Tn,
                    int nC, long B) {
  chain_factor_steps(M, O, R, Dinv, t2, tR, S, Tn, nC, B);
}
// K7 over B lanes.
void h_chain_rhs_forward(In Dinv, In O, In tRw, In r, Out tr, Out sb, int Tn,
                         int nB, long B) {
  rhs_forward_steps(Dinv, O, tRw, r, tr, sb, Tn, nB, B);
}
void h_chain_back_sub(In tR, In t2, In coef, Out x, int Tn, int nC, long B) {
  back_sub_steps(tR, t2, coef, x, Tn, nC, B);
}
void h_chain_factor_pass(In M, In O, In R, Out Dinv, Out t2, Out tR, Out S,
                         int Tn, int nC, long B, int G) {
  chain_factor_pass(M, O, R, Dinv, t2, tR, S, Tn, nC, B, G);
}
void h_rhs_forward_pass(In Dinv, In O, In tRw, In r, Out tr, Out sb, int Tn,
                        int nB, long B, int G, int C) {
  rhs_forward_pass(Dinv, O, tRw, r, tr, sb, Tn, nB, B, G, C);
}
void h_back_sub_pass(In tR, In t2, In coef, Out x, int Tn, int nC, long B,
                     int G, int Tc) {
  back_sub_pass(tR, t2, coef, x, Tn, nC, B, G, Tc);
}
// float32, as the card runs them (built without contraction into FMAs)
typedef const float* Fi;
typedef float* Fo;
void f_chain_factor(Fi M, Fi O, Fi R, Fo Dinv, Fo t2, Fo tR, Fo S, int Tn,
                    int nC, long B) {
  chain_factor_steps(M, O, R, Dinv, t2, tR, S, Tn, nC, B);
}
void f_chain_factor_pass(Fi M, Fi O, Fi R, Fo Dinv, Fo t2, Fo tR, Fo S, int Tn,
                         int nC, long B, int G) {
  chain_factor_pass(M, O, R, Dinv, t2, tR, S, Tn, nC, B, G);
}
void f_chain_rhs_forward(Fi Dinv, Fi O, Fi tRw, Fi r, Fo tr, Fo sb, int Tn,
                         int nB, long B) {
  rhs_forward_steps(Dinv, O, tRw, r, tr, sb, Tn, nB, B);
}
void f_rhs_forward_pass(Fi Dinv, Fi O, Fi tRw, Fi r, Fo tr, Fo sb, int Tn,
                        int nB, long B, int G, int C) {
  rhs_forward_pass(Dinv, O, tRw, r, tr, sb, Tn, nB, B, G, C);
}
void f_chain_back_sub(Fi tR, Fi t2, Fi coef, Fo x, int Tn, int nC, long B) {
  back_sub_steps(tR, t2, coef, x, Tn, nC, B);
}
void f_back_sub_pass(Fi tR, Fi t2, Fi coef, Fo x, int Tn, int nC, long B, int G,
                     int Tc) {
  back_sub_pass(tR, t2, coef, x, Tn, nC, B, G, Tc);
}
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The block routines of K5-K8, built for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("chainkern_host")
    src = d / "shim.cpp"
    src.write_text(_SHIM)
    lib = d / "libchainkern_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-std=c++17", "-I", CSRC, "-o", str(lib), str(src)],
                   check=True)
    so = ctypes.CDLL(str(lib))
    P, Li, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    so.h_factor.argtypes = [P] * 8 + [Li]
    for prefix in ("h_", "f_"):
        getattr(so, prefix + "chain_rhs_forward").argtypes = [P] * 6 + [I, I, Li]
        getattr(so, prefix + "rhs_forward_pass").argtypes = [P] * 6 + [I, I, Li, I, I]
        getattr(so, prefix + "chain_factor").argtypes = [P] * 7 + [I, I, Li]
        getattr(so, prefix + "chain_factor_pass").argtypes = [P] * 7 + [I, I, Li, I]
        getattr(so, prefix + "chain_back_sub").argtypes = [P] * 4 + [I, I, Li]
        getattr(so, prefix + "back_sub_pass").argtypes = [P] * 4 + [I, I, Li, I, I]
    return so


def _call(fn, ins, outs, *tail):
    fn(*[t.data_ptr() for t in ins], *[t.data_ptr() for t in outs], *tail)
    return outs


def _assert_all_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w.numpy())


@pytest.mark.parametrize("nC,T", [(12, 8), (14, 13)])
def test_chain_kernel_device_math_matches_twins(host_kernels, nC, T):
    """K6-K8's block routines, compiled for the host in float64 and walked
    in the kernels' phase order, against the plain twins; lane 1 has an
    indefinite pivot."""
    rng = np.random.default_rng(15)
    B = 3
    M, O, R = _bordered_chains(rng, B, T, nC, nan_lane=1)
    M, O, R = [tch._lanes_last(_t(a)) for a in (M, O, R)]
    z = lambda *s: torch.zeros(*s, dtype=torch.float64)
    got = _call(host_kernels.h_chain_factor, [M, O, R],
                [z(T, NB, NB, B), z(T, NB, NB, B), z(T, NB, nC, B),
                 z(nC, nC, B)], T, nC, B)
    want = tch.factor_eliminate_plain(M, O, R)
    _assert_all_close(got, want)
    assert torch.isnan(got[3]).any(0).any(0).tolist() == [False, True, False]

    Dinv, t2, tRw, _ = want
    r = _t(rng.normal(size=(T, NB, 1, B)))
    got = _call(host_kernels.h_chain_rhs_forward, [Dinv, O, tRw, r],
                [z(T, NB, 1, B), z(nC, 1, B)], T, nC, B)
    want = tch.rhs_forward_plain(Dinv, O, tRw, r)
    _assert_all_close(got, want)

    tR = torch.cat([tRw, want[0]], dim=2).contiguous()
    coef = _t(rng.normal(size=(nC + 1, 1, B)))
    got = _call(host_kernels.h_chain_back_sub, [tR, t2, coef], [z(T, NB, B)],
                T, nC + 1, B)
    _assert_all_close(got, [tch.back_substitute_plain(tR, t2, coef)])


def test_factor_level_device_math_matches_twin(host_kernels):
    """K5's column routine on one CR level (h = 4 blocks x 3 lanes)."""
    rng = np.random.default_rng(16)
    L = 12
    A = rng.normal(size=(2, L, NB, NB))
    spd = A @ np.swapaxes(A, -1, -2) + NB * np.eye(NB)
    Mo, Me = [_t(np.ascontiguousarray(np.moveaxis(m, 0, -1))) for m in spd]
    OL, OR = _t(rng.normal(size=(NB, NB, L))), _t(rng.normal(size=(NB, NB, L)))
    blk = lambda: torch.empty(NB, NB, L, dtype=torch.float64)
    got = _call(host_kernels.h_factor, [Mo, Me, OL, OR],
                [blk(), blk(), blk(), blk()], L)
    _assert_all_close(got, tck.factor_level_plain(Mo, Me, OL, OR))


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("nC,T", [(12, 8), (14, 13)])
def test_chain_pass_math_matches_twins(host_kernels, nC, T, G):
    """K6's, K7's and K8's whole-chain routines (g++, float64) in the card's
    lane groups against the plain twins.  B = 3 leaves the last group
    partial for G = 2 and makes one partial group for G = 4, 8; lane 1 has
    an indefinite pivot.  K7 runs at border width nC in one chunk and in
    chunks of 3 steps, K8 at border width nC + 1 (13 and 15, as the solves
    use it) in one chunk and in chunks of 3 steps."""
    rng = np.random.default_rng(18)
    B = 3
    M, O, R = _bordered_chains(rng, B, T, nC, nan_lane=1)
    M, O, R = [tch._lanes_last(_t(a)) for a in (M, O, R)]
    z = lambda *s: torch.zeros(*s, dtype=torch.float64)
    got = _call(host_kernels.h_chain_factor_pass, [M, O, R],
                [z(T, NB, NB, B), z(T, NB, NB, B), z(T, NB, nC, B),
                 z(nC, nC, B)], T, nC, B, G)
    want = tch.factor_eliminate_plain(M, O, R)
    _assert_all_close(got, want)
    nan = torch.isnan(got[0]).flatten(1, 2).any(1)           # (T, B)
    assert nan[:, 1].tolist() == [False, False] + [True] * (T - 2)
    assert not nan[:, [0, 2]].any()
    assert torch.isnan(got[3]).any(0).any(0).tolist() == [False, True, False]

    Dinv, t2, tRw, _ = want
    r = _t(rng.normal(size=(T, NB, 1, B)))
    want_r = tch.rhs_forward_plain(Dinv, O, tRw, r)
    for C in (T, 3):
        got = _call(host_kernels.h_rhs_forward_pass, [Dinv, O, tRw, r],
                    [z(T, NB, 1, B), z(nC, 1, B)], T, nC, B, G, C)
        _assert_all_close(got, want_r)
        assert torch.isnan(got[1]).any(0).any(0).tolist() == [False, True, False]
    tR = torch.cat([tRw, _t(rng.normal(size=(T, NB, 1, B)))], dim=2).contiguous()
    coef = _t(rng.normal(size=(nC + 1, 1, B)))
    want_x = tch.back_substitute_plain(tR, t2, coef)
    for Tc in (T, 3):
        got = _call(host_kernels.h_back_sub_pass, [tR, t2, coef], [z(T, NB, B)],
                    T, nC + 1, B, G, Tc)
        _assert_all_close(got, [want_x])


def _same_bits(got, want):
    return torch.equal(got.contiguous().view(torch.int32),
                       want.contiguous().view(torch.int32))


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("nC", [12, 14])
def test_chain_passes_are_the_block_steps_bitwise(host_kernels, nC, G):
    """Same arithmetic, not only the same values: in float32, with no
    contraction into FMAs, K6's, K7's and K8's whole-chain routines give the
    very bits of the block-step routines walked step by step (chain_chol,
    chain_rt_column, chain_inverse_column, chain_factor_column;
    chain_rhs_forward_block; chain_back_sub_block), NaN lane included (lane
    1, indefinite at block 2); K7 and K8 in one chunk and in chunks of 4
    steps."""
    rng = np.random.default_rng(19)
    B, T = 3, 9
    so = host_kernels
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    M, O, R = [tch._lanes_last(f32(a))
               for a in _bordered_chains(rng, B, T, nC, nan_lane=1)]
    e = lambda *s: torch.empty(*s, dtype=torch.float32)
    outs = lambda: [e(T, NB, NB, B), e(T, NB, NB, B), e(T, NB, nC, B),
                    e(nC, nC, B)]
    want = _call(so.f_chain_factor, [M, O, R], outs(), T, nC, B)
    got = _call(so.f_chain_factor_pass, [M, O, R], outs(), T, nC, B, G)
    assert torch.isnan(want[3]).any()
    for g, w in zip(got, want, strict=True):
        assert _same_bits(g, w)

    Dinv, t2, tRw, _ = want
    r = f32(rng.normal(size=(T, NB, 1, B)))
    rhs = lambda: [e(T, NB, 1, B), e(nC, 1, B)]
    want_r = _call(so.f_chain_rhs_forward, [Dinv, O, tRw, r], rhs(), T, nC, B)
    assert torch.isnan(want_r[1]).any()
    for C in (T, 4):
        got = _call(so.f_rhs_forward_pass, [Dinv, O, tRw, r], rhs(), T, nC, B,
                    G, C)
        for g, w in zip(got, want_r, strict=True):
            assert _same_bits(g, w)
    tR = torch.cat([tRw, f32(rng.normal(size=(T, NB, 1, B)))], dim=2).contiguous()
    coef = f32(rng.normal(size=(nC + 1, 1, B)))
    want = _call(so.f_chain_back_sub, [tR, t2, coef], [e(T, NB, B)], T, nC + 1,
                 B)[0]
    for Tc in (T, 4):
        got = _call(so.f_back_sub_pass, [tR, t2, coef], [e(T, NB, B)], T,
                    nC + 1, B, G, Tc)[0]
        assert _same_bits(got, want)
