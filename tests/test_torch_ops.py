"""tol_tpu_torch.ops against tol_tpu.ops on the same seeded inputs (float64).

Covers the small-matrix algebra, the plain cyclic reduction, the crp cyclic
reduction (its plain twins on the CPU against the Pallas kernels run in
interpret mode, and against the JAX reference path at the flagship's block
shapes), the NaN-lane rule, and the CUDA kernels' device math built for the
host with g++.
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

from tol_tpu.ops import blocktri as jbt
from tol_tpu.ops import crkern as jck
from tol_tpu.ops import smallalg as jsa
from tol_tpu_torch.ops import blocktri as tbt
from tol_tpu_torch.ops import crkern as tck
from tol_tpu_torch.ops import smallalg as tsa

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tol_tpu_torch", "csrc")

# Same arithmetic in the same order on both sides, float64: agreement to a
# few ulps of the operands' magnitude.
TOL = 1e-12


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _spd(rng, shape, n):
    A = rng.normal(size=shape + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def _chains(rng, B, N, b, m):
    """B SPD block-tridiagonal chains (diagonally dominant) + rhs."""
    M = _spd(rng, (B, N), b)
    O = 0.3 * rng.normal(size=(B, N, b, b))
    O[:, -1] = 0.0
    F = rng.normal(size=(B, N, b, m))
    return M, O, F


def _dense_solve(M, O, F):
    N, b = M.shape[0], M.shape[1]
    K = np.zeros((N * b, N * b))
    for i in range(N):
        K[i * b:(i + 1) * b, i * b:(i + 1) * b] = M[i]
        if i + 1 < N:
            K[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = O[i]
            K[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = O[i].T
    return np.linalg.solve(K, F.reshape(N * b, -1)).reshape(F.shape)


@pytest.mark.parametrize("fn", ["bmm", "bmm_tn", "bmv", "bmv_t"])
def test_products_match_jax(fn):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(3, 4, 11, 11))
    x = rng.normal(size=(3, 4, 11, 5)) if fn.startswith("bmm") \
        else rng.normal(size=(3, 4, 11))
    got = getattr(tsa, fn)(_t(A), _t(x)).numpy()
    want = np.asarray(getattr(jsa, fn)(jnp.asarray(A), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("lower,trans", [(True, False), (True, True),
                                         (False, False), (False, True)])
def test_cholesky_and_triangular_solves_match_jax(lower, trans):
    rng = np.random.default_rng(1)
    A = _spd(rng, (5,), 11)
    L = np.asarray(jsa.chol_unrolled(jnp.asarray(A)))
    np.testing.assert_allclose(tsa.chol_unrolled(_t(A)).numpy(), L,
                               rtol=0, atol=TOL * np.abs(L).max())
    Lt = L if lower else np.swapaxes(L, -1, -2)
    B = rng.normal(size=(5, 11, 3))
    got = tsa.tri_solve_unrolled(_t(Lt), _t(B), lower=lower, trans=trans).numpy()
    want = np.asarray(jsa.tri_solve_unrolled(jnp.asarray(Lt), jnp.asarray(B),
                                             lower=lower, trans=trans))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_spd_solve_and_inverse_match_jax():
    rng = np.random.default_rng(2)
    A = _spd(rng, (4,), 12)
    B = rng.normal(size=(4, 12, 3))
    for got, want in [
            (tsa.spd_solve(_t(A), _t(B)), jsa.spd_solve(jnp.asarray(A),
                                                       jnp.asarray(B))),
            (tsa.spd_inverse(_t(A)), jsa.spd_inverse(jnp.asarray(A)))]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max())
    # an indefinite matrix is a NaN (the solvers' inertia signal)
    assert torch.isnan(tsa.chol_unrolled(_t(np.diag([1.0, -1.0, 2.0])))).any()


@pytest.mark.parametrize("N", [13, 16])
def test_blocktri_cr_matches_jax(N):
    rng = np.random.default_rng(3)
    M, O, F = _chains(rng, 3, N, 5, 2)
    X = tbt.cr_solve(tbt.cr_factor(_t(M), _t(O)), _t(F)).numpy()
    for i in range(3):
        want = np.asarray(jbt.cr_solve(jbt.cr_factor(jnp.asarray(M[i]),
                                                     jnp.asarray(O[i])),
                                       jnp.asarray(F[i])))
        np.testing.assert_allclose(X[i], want, rtol=0, atol=TOL)
        np.testing.assert_allclose(X[i], _dense_solve(M[i], O[i], F[i]),
                                   rtol=0, atol=1e-10)


def test_crp_twins_match_pallas_kernels_in_interpret_mode():
    """B=128 drives the JAX package's Pallas level kernels (interpret mode on
    the CPU, as tests/test_chains.py runs them); small blocks keep it fast."""
    rng = np.random.default_rng(4)
    B, N, b, m = 128, 10, 4, 2
    M, O, F = _chains(rng, B, N, b, m)
    F2 = rng.normal(size=(B, 16, b, 1))
    F2[:, N:] = 0.0

    def jax_pair(M, O, F, F2):
        lv, ri, X = jck.crp_factor_solve(M, O, F)
        return X, jck.crp_solve(lv, ri, F2)

    Xj, X2j = jax.vmap(jax_pair)(jnp.asarray(M), jnp.asarray(O), jnp.asarray(F),
                                 jnp.asarray(F2))
    lv, ri, X = tck.crp_factor_solve(_t(M), _t(O), _t(F))
    X2 = tck.crp_solve(lv, ri, _t(F2))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0, atol=TOL)
    np.testing.assert_allclose(X2.numpy(), np.asarray(X2j), rtol=0, atol=TOL)


@pytest.mark.parametrize("m", [12, 1])
def test_crp_matches_jax_reference_at_flagship_shapes(m):
    """b=11, T=100 chain blocks padded to 128 (7 CR levels), m = 12 border
    columns / 1 Newton rhs, against tol_tpu's reference CR path."""
    rng = np.random.default_rng(5)
    B, N, b = 2, 100, 11
    M, O, F = _chains(rng, B, N, b, m)
    f2 = rng.normal(size=(B, N, b, 1))
    lv, ri, X = tck.crp_factor_solve(_t(M), _t(O), _t(F))
    x2 = tck.crp_solve(lv, ri, tck.crp_pad_rhs(_t(f2), 128))
    assert X.shape == (B, 128, b, m)
    for i in range(B):
        jl, jr, jX = jck._factor_solve_ref(jnp.asarray(M[i]), jnp.asarray(O[i]),
                                           jnp.asarray(F[i]))
        jx2 = jck._solve_ref(list(jl), jr, jck.crp_pad_rhs(jnp.asarray(f2[i]),
                                                           128))
        np.testing.assert_allclose(X[i].numpy(), np.asarray(jX), rtol=0, atol=TOL)
        np.testing.assert_allclose(x2[i].numpy(), np.asarray(jx2), rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(X[0, :N].numpy(), _dense_solve(M[0], O[0], F[0]),
                               rtol=0, atol=1e-10)


def test_crp_indefinite_pivot_is_nan_in_that_lane_only():
    rng = np.random.default_rng(6)
    B, N, b = 3, 12, 11
    M, O, F = _chains(rng, B, N, b, 2)
    M[1, 5] = -np.eye(b)                   # lane 1: an odd (level-0) pivot
    lv, ri, X = tck.crp_factor_solve(_t(M), _t(O), _t(F))
    x2 = tck.crp_solve(lv, ri, tck.crp_pad_rhs(_t(F[..., :1]), 16))
    for out in (X, x2):
        nan = torch.isnan(out).flatten(1).any(1)
        assert nan.tolist() == [False, True, False]
    np.testing.assert_allclose(X[0, :N].numpy(), _dense_solve(M[0], O[0], F[0]),
                               rtol=0, atol=1e-10)


_SHIM = r"""
#include <vector>
#include "crkern_block.cuh"
template <typename T>
void factor_fwd(const T* Mo, const T* Me, const T* OL, const T* OR,
                const T* Fo, const T* Fe, T* a, T* b, T* c, T* d, T* e, T* f,
                long L, int m) {
  for (long k = 0; k < L; ++k)
    crk::factor_fwd_column<T>(Mo + k, Me + k, OL + k, OR + k, Fo + k, Fe + k,
                              a + k, b + k, c + k, d + k, e + k, f + k, L, m);
}
template <typename T>
void bwd(const T* Mi, const T* OL, const T* OR, const T* fo, const T* xe,
         const T* xs, T* xo, long L, int m) {
  for (long k = 0; k < L; ++k)
    crk::bwd_column<T>(Mi + k, OL + k, OR + k, fo + k, xe + k, xs + k, xo + k,
                       L, m);
}
// The whole passes, lane (or lane group) after lane, each step's items in
// order.
template <typename T>
void factor_fwd_pass(const T* M, const T* O, const T* F, T** minv, T** ol,
                     T** orr, T** fo, T* Ri, T* X, long B, int n_pad, int m) {
  crk::LevelPtrs<T*> out{};
  for (int l = 0; l < crk::log2_exact(n_pad); ++l) {
    out.minv[l] = minv[l]; out.ol[l] = ol[l];
    out.orr[l] = orr[l]; out.fo[l] = fo[l];
  }
  std::vector<T> smem(crk::factor_fwd_pass_floats(n_pad, m) + 1);
  for (long n = 0; n < B; ++n)
    crk::factor_fwd_pass(
        crk::SerialTeam{}, crk::lanes_first_view(M, crk::NB, n, n_pad),
        crk::lanes_first_view(O, crk::NB, n, n_pad),
        crk::lanes_first_view(F, m, n, n_pad), out, Ri, X, B, n, n_pad, m,
        smem.data());
}
// K5: K1's pass with no rhs, as the kernel calls it.
template <typename T>
void factor_pass(const T* M, const T* O, T** minv, T** ol, T** orr, T* Ri,
                 long B, int n_pad) {
  crk::LevelPtrs<T*> out{};
  for (int l = 0; l < crk::log2_exact(n_pad); ++l) {
    out.minv[l] = minv[l]; out.ol[l] = ol[l]; out.orr[l] = orr[l];
  }
  std::vector<T> smem(crk::factor_fwd_pass_floats(n_pad, 0) + 1);
  for (long n = 0; n < B; ++n)
    crk::factor_fwd_pass<T>(
        crk::SerialTeam{}, crk::lanes_first_view(M, crk::NB, n, n_pad),
        crk::lanes_first_view(O, crk::NB, n, n_pad),
        crk::Unit<const T>{nullptr, 1, 0}, out, Ri, nullptr, B, n, n_pad, 0,
        smem.data());
}
template <typename T>
void fwd_pass(const T** minv, const T** ol, const T** orr, const T* Ri,
              const T* f, T** fo, T* x, long B, int n_pad, int m, int G) {
  crk::LevelPtrs<const T*> lv{};
  crk::LevelPtrs<T*> out{};
  for (int l = 0; l < crk::log2_exact(n_pad); ++l) {
    lv.minv[l] = minv[l]; lv.ol[l] = ol[l]; lv.orr[l] = orr[l];
    out.fo[l] = fo[l];
  }
  std::vector<T> smem(G * crk::fwd_pass_floats(n_pad, m) + 1);
  for (long n0 = 0; n0 < B; n0 += G)
    crk::fwd_pass(crk::SerialTeam{}, lv, Ri, f, out, x, B, n0, G, n_pad, m,
                  smem.data());
}
template <typename T>
void bwd_pass(const T** minv, const T** ol, const T** orr, const T** fo,
              const T* x0, T* X, long B, int n_pad, int m) {
  crk::LevelPtrs<const T*> lv{};
  for (int l = 0; l < crk::log2_exact(n_pad); ++l) {
    lv.minv[l] = minv[l]; lv.ol[l] = ol[l];
    lv.orr[l] = orr[l]; lv.fo[l] = fo[l];
  }
  std::vector<T> smem(crk::bwd_pass_floats(n_pad, m) + 1);
  for (long n = 0; n < B; ++n)
    crk::bwd_pass<T>(crk::SerialTeam{}, lv, {x0 + n, B, 0},
                     X + n * n_pad * crk::NB * m, B, n, n_pad, m, smem.data());
}
typedef const double* In;
typedef double* Out;
extern "C" {
void h_factor_fwd(In Mo, In Me, In OL, In OR, In Fo, In Fe, Out a, Out b,
                  Out c, Out d, Out e, Out f, long L, int m) {
  factor_fwd(Mo, Me, OL, OR, Fo, Fe, a, b, c, d, e, f, L, m);
}
void h_fwd(In Mi, In OL, In OR, In fo, In fe, Out fe2, Out br, long L, int m) {
  for (long k = 0; k < L; ++k)
    crk::fwd_column<double>(Mi + k, OL + k, OR + k, fo + k, fe + k, fe2 + k,
                            br + k, L, m);
}
void h_bwd(In Mi, In OL, In OR, In fo, In xe, In xs, Out xo, long L, int m) {
  bwd(Mi, OL, OR, fo, xe, xs, xo, L, m);
}
void h_root(In A, In F, Out R, Out X, long L, int m, int inv) {
  for (long k = 0; k < L; ++k)
    crk::root_column<double>(A + k, F + k, inv ? R + k : nullptr, X + k, L, m,
                             inv);
}
void h_factor_fwd_pass(In M, In O, In F, Out* minv, Out* ol, Out* orr,
                       Out* fo, Out Ri, Out X, long B, int n_pad, int m) {
  factor_fwd_pass(M, O, F, minv, ol, orr, fo, Ri, X, B, n_pad, m);
}
void h_factor_pass(In M, In O, Out* minv, Out* ol, Out* orr, Out Ri, long B,
                   int n_pad) {
  factor_pass(M, O, minv, ol, orr, Ri, B, n_pad);
}
void h_fwd_pass(In* minv, In* ol, In* orr, In Ri, In f, Out* fo, Out x, long B,
                int n_pad, int m, int G) {
  fwd_pass(minv, ol, orr, Ri, f, fo, x, B, n_pad, m, G);
}
// the lanes per thread block the kernel takes
int fwd_group(int n_pad, int m) { return crk::fwd_pass_group(n_pad, m); }
void h_bwd_pass(In* minv, In* ol, In* orr, In* fo, In x0, Out X, long B,
                int n_pad, int m) {
  bwd_pass(minv, ol, orr, fo, x0, X, B, n_pad, m);
}
// float32, as the card runs them (built without contraction into FMAs)
void f_factor_fwd(const float* Mo, const float* Me, const float* OL,
                  const float* OR, const float* Fo, const float* Fe, float* a,
                  float* b, float* c, float* d, float* e, float* f, long L,
                  int m) {
  factor_fwd(Mo, Me, OL, OR, Fo, Fe, a, b, c, d, e, f, L, m);
}
void f_bwd(const float* Mi, const float* OL, const float* OR, const float* fo,
           const float* xe, const float* xs, float* xo, long L, int m) {
  bwd(Mi, OL, OR, fo, xe, xs, xo, L, m);
}
void f_fwd(const float* Mi, const float* OL, const float* OR, const float* fo,
           const float* fe, float* fe2, float* br, long L, int m) {
  for (long k = 0; k < L; ++k)
    crk::fwd_column<float>(Mi + k, OL + k, OR + k, fo + k, fe + k, fe2 + k,
                           br + k, L, m);
}
void f_root(const float* A, const float* F, float* R, float* X, long L, int m,
            int inv) {
  for (long k = 0; k < L; ++k)
    crk::root_column<float>(A + k, F + k, inv ? R + k : nullptr, X + k, L, m,
                            inv);
}
void f_factor_fwd_pass(const float* M, const float* O, const float* F,
                       float** minv, float** ol, float** orr, float** fo,
                       float* Ri, float* X, long B, int n_pad, int m) {
  factor_fwd_pass(M, O, F, minv, ol, orr, fo, Ri, X, B, n_pad, m);
}
void f_factor_pass(const float* M, const float* O, float** minv, float** ol,
                   float** orr, float* Ri, long B, int n_pad) {
  factor_pass(M, O, minv, ol, orr, Ri, B, n_pad);
}
void f_fwd_pass(const float** minv, const float** ol, const float** orr,
                const float* Ri, const float* f, float** fo, float* x, long B,
                int n_pad, int m, int G) {
  fwd_pass(minv, ol, orr, Ri, f, fo, x, B, n_pad, m, G);
}
void f_bwd_pass(const float** minv, const float** ol, const float** orr,
                const float** fo, const float* x0, float* X, long B, int n_pad,
                int m) {
  bwd_pass(minv, ol, orr, fo, x0, X, B, n_pad, m);
}
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The kernels' __host__ __device__ column routines, built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("crkern_host")
    src = d / "shim.cpp"
    src.write_text(_SHIM)
    lib = d / "libcrkern_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-std=c++17", "-I", CSRC, "-o", str(lib), str(src)],
                   check=True)
    so = ctypes.CDLL(str(lib))
    P, Li, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    so.h_factor_fwd.argtypes = [P] * 12 + [Li, I]
    so.h_fwd.argtypes = [P] * 7 + [Li, I]
    so.h_bwd.argtypes = [P] * 7 + [Li, I]
    so.h_root.argtypes = [P] * 4 + [Li, I, I]
    for prefix in ("h_", "f_"):
        getattr(so, prefix + "factor_fwd_pass").argtypes = [P] * 9 + [Li, I, I]
        getattr(so, prefix + "factor_pass").argtypes = [P] * 6 + [Li, I]
        getattr(so, prefix + "fwd_pass").argtypes = [P] * 7 + [Li, I, I, I]
        getattr(so, prefix + "bwd_pass").argtypes = [P] * 6 + [Li, I, I]
    so.f_factor_fwd.argtypes = [P] * 12 + [Li, I]
    so.f_fwd.argtypes = [P] * 7 + [Li, I]
    so.f_bwd.argtypes = [P] * 7 + [Li, I]
    so.f_root.argtypes = [P] * 4 + [Li, I, I]
    so.fwd_group.argtypes = [I, I]
    so.fwd_group.restype = I
    return so


def _slab_spd(rng, L):
    return torch.as_tensor(np.ascontiguousarray(
        np.moveaxis(_spd(rng, (L,), 11), 0, -1)))


def _slab(rng, w, L):
    return torch.as_tensor(rng.normal(size=(11, w, L)))


def _call(fn, ins, outs, *tail):
    fn(*[t.data_ptr() for t in ins], *[t.data_ptr() for t in outs], *tail)
    return outs


@pytest.mark.parametrize("m", [12, 1])
def test_kernel_device_math_matches_twins(host_kernels, m):
    """One CR level (h=4 blocks x 3 lanes) through each kernel's column
    routines, compiled for the host in float64, against the plain twins."""
    rng = np.random.default_rng(7)
    L = 12
    Mo, Me = _slab_spd(rng, L), _slab_spd(rng, L)
    OL, OR, Minv = _slab(rng, 11, L), _slab(rng, 11, L), _slab(rng, 11, L)
    Fo, Fe, xs = _slab(rng, m, L), _slab(rng, m, L), _slab(rng, m, L)
    blk = lambda: torch.empty(11, 11, L, dtype=torch.float64)
    rhs = lambda: torch.empty(11, m, L, dtype=torch.float64)

    got = _call(host_kernels.h_factor_fwd, [Mo, Me, OL, OR, Fo, Fe],
                [blk(), blk(), blk(), blk(), rhs(), rhs()], L, m)
    want = tck.factor_fwd_level_plain(Mo, Me, OL, OR, Fo, Fe)
    got += _call(host_kernels.h_fwd, [Minv, OL, OR, Fo, Fe], [rhs(), rhs()], L, m)
    want += tck.fwd_level_plain(Minv, OL, OR, Fo, Fe)
    got += _call(host_kernels.h_bwd, [Minv, OL, OR, Fo, Fe, xs], [rhs()], L, m)
    want += (tck.bwd_level_plain(Minv, OL, OR, Fo, Fe, xs),)
    got += _call(host_kernels.h_root, [Mo, Fo], [blk(), rhs()], L, m, 1)
    Rinv = tck.root_plain(Mo)
    want += (Rinv, tck._mm(Rinv, Fo))
    got += _call(host_kernels.h_root, [Minv, Fo], [blk(), rhs()], L, m, 0)[1:]
    want += (tck._mm(Minv, Fo),)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=TOL * max(1.0, w.abs().max().item()))


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _host_factor_fwd_pass(so, M, O, F, prefix="h_"):
    """K1's pass routine (g++; float64, or float32 with ``prefix="f_"``) on
    batch-first M, O, F -> (levels, stack, root_inv, x) as the twin returns
    them."""
    B, n_pad, _, m = F.shape
    new = lambda w, h: torch.empty(11, w, h * B, dtype=F.dtype)
    hs = [n_pad >> (l + 1) for l in range(n_pad.bit_length() - 1)]
    levels = [(new(11, h), new(11, h), new(11, h)) for h in hs]
    stack = [new(m, h) for h in hs]
    Ri, x = new(11, 1), new(m, 1)
    getattr(so, prefix + "factor_fwd_pass")(
        M.data_ptr(), O.data_ptr(), F.data_ptr(),
        *[_ptrs([lv[i] for lv in levels]) for i in range(3)], _ptrs(stack),
        Ri.data_ptr(), x.data_ptr(), B, n_pad, m)
    return levels, stack, Ri, x


def _host_factor_pass(so, M, O, prefix="h_"):
    """K5's pass routine (K1's with no rhs) on batch-first M, O ->
    (levels, root_inv) as the twin returns them."""
    B, n_pad = M.shape[:2]
    new = lambda h: torch.empty(11, 11, h * B, dtype=M.dtype)
    levels = [(new(h), new(h), new(h))
              for h in (n_pad >> (l + 1) for l in range(n_pad.bit_length() - 1))]
    Ri = new(1)
    getattr(so, prefix + "factor_pass")(
        M.data_ptr(), O.data_ptr(),
        *[_ptrs([lv[i] for lv in levels]) for i in range(3)], Ri.data_ptr(), B,
        n_pad)
    return levels, Ri


def _host_fwd_pass(so, levels, root_inv, f, G, prefix="h_"):
    """K2's pass routine (g++) over lane groups of G on the batch-first rhs
    f -> (stack, x) as the twin returns them."""
    B, n_pad, _, m = f.shape
    stack = [torch.empty(11, m, lv[0].shape[2], dtype=f.dtype) for lv in levels]
    x = torch.empty(11, m, B, dtype=f.dtype)
    getattr(so, prefix + "fwd_pass")(
        *[_ptrs([lv[i] for lv in levels]) for i in range(3)],
        root_inv.data_ptr(), f.data_ptr(), _ptrs(stack), x.data_ptr(), B,
        n_pad, m, G)
    return stack, x


def _host_bwd_pass(so, levels, stack, x, prefix="h_"):
    B, m = x.shape[2], x.shape[1]
    n_pad = 1 << len(levels)
    X = torch.empty(B, n_pad, 11, m, dtype=x.dtype)
    getattr(so, prefix + "bwd_pass")(
        *[_ptrs([lv[i] for lv in levels]) for i in range(3)], _ptrs(stack),
        x.data_ptr(), X.data_ptr(), B, n_pad, m)
    return X


def _flat(levels, stack, *rest):
    return [t for lv in levels for t in lv] + list(stack) + list(rest)


def _assert_close(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=TOL * max(1.0, w.abs().max().item()))


@pytest.mark.parametrize("m", [12, 1])
def test_kernel_pass_math_matches_pass_twins(host_kernels, m):
    """K1's, K5's, K2's and K3's whole-pass routines (n_pad = 16: 4 levels,
    3 lanes; K2 in the lane groups of the kernel, one partial group here),
    compiled for the host in float64 and run step by step, against
    factor_fwd_pass_plain (K1's root tail included), factor_pass_plain (K5:
    the same pass with no rhs), fwd_pass_plain and bwd_pass_plain."""
    rng = np.random.default_rng(11)
    B, n_pad = 3, 16
    M, O, F = (torch.as_tensor(x) for x in _chains(rng, B, n_pad, 11, m))
    want = tck.factor_fwd_pass_plain(tck._to_slab(M), tck._to_slab(O),
                                     tck._to_slab(F), B)
    got = _host_factor_fwd_pass(host_kernels, M, O, F)
    _assert_close(_flat(*got), _flat(*want))
    got = _host_factor_pass(host_kernels, M, O)
    levels0, root0 = tck.factor_pass_plain(tck._to_slab(M), tck._to_slab(O), B)
    _assert_close(_flat(got[0], [], got[1]), _flat(levels0, [], root0))
    levels, stack, root_inv, _ = want
    f = torch.as_tensor(rng.normal(size=(B, n_pad, 11, m)))
    G = host_kernels.fwd_group(n_pad, m)
    assert B % G != 0
    got = _host_fwd_pass(host_kernels, levels, root_inv, f, G)
    want = tck.fwd_pass_plain(levels, root_inv, tck._to_slab(f), B)
    _assert_close(_flat([], *got), _flat([], *want))
    x = torch.as_tensor(rng.normal(size=(11, m, B)))
    got = _host_bwd_pass(host_kernels, levels, stack, x)
    want = tck._from_slab(tck.bwd_pass_plain(levels, stack, x, B), B)
    _assert_close([got], [want])


@pytest.mark.parametrize("G", [1, 2, 4])
def test_kernel_fwd_pass_math_holds_for_any_lane_group(host_kernels, G):
    """K2's pass routine over 3 lanes in groups of G (whole groups, a full
    one and a partial one, one partial one) gives the twin's values."""
    rng = np.random.default_rng(18)
    B, n_pad, m = 3, 16, 2
    M, O, F = (torch.as_tensor(x) for x in _chains(rng, B, n_pad, 11, m))
    levels, _, root_inv, _ = tck.factor_fwd_pass_plain(
        tck._to_slab(M), tck._to_slab(O), tck._to_slab(F), B)
    f = torch.as_tensor(rng.normal(size=(B, n_pad, 11, m)))
    got = _host_fwd_pass(host_kernels, levels, root_inv, f, G)
    want = tck.fwd_pass_plain(levels, root_inv, tck._to_slab(f), B)
    _assert_close(_flat([], *got), _flat([], *want))


def _nan_lanes(t, B):
    return torch.isnan(t).reshape(-1, B).any(0).tolist()


def test_kernel_pass_math_keeps_an_indefinite_pivot_in_its_lane(host_kernels):
    """Lane 1 has an indefinite level-0 pivot: every output of the host-built
    passes is NaN in lane 1 or nowhere, and the root and the solution are
    NaN there; lanes 0 and 2 stay finite and agree with the twins."""
    rng = np.random.default_rng(12)
    B, n_pad, m = 3, 16, 2
    M, O, F = (torch.as_tensor(x) for x in _chains(rng, B, n_pad, 11, m))
    M[1, 5] = -torch.eye(11, dtype=torch.float64)
    levels, stack, Ri, xr = _host_factor_fwd_pass(host_kernels, M, O, F)
    x = torch.as_tensor(rng.normal(size=(11, m, B)))
    X = _host_bwd_pass(host_kernels, levels, stack, x)
    slabs = _flat(levels, stack, Ri, xr)
    for t in slabs:
        assert _nan_lanes(t, B) in ([False, True, False], [False] * 3)
    for t in (Ri, xr):
        assert _nan_lanes(t, B) == [False, True, False]
    assert torch.isnan(X).flatten(1).any(1).tolist() == [False, True, False]
    want = tck.factor_fwd_pass_plain(tck._to_slab(M), tck._to_slab(O),
                                     tck._to_slab(F), B)
    for g, w in zip(slabs, _flat(*want), strict=True):
        keep = ~torch.isnan(w)
        assert torch.equal(torch.isnan(g), ~keep)
        np.testing.assert_allclose(g[keep].numpy(), w[keep].numpy(), rtol=0,
                                   atol=TOL * max(1.0, w[keep].abs().max().item()))


@pytest.mark.parametrize("G", [1, 2])
def test_kernel_fwd_pass_math_keeps_a_nan_lane_in_its_lane(host_kernels, G):
    """K2 on a factor whose lane 1 is NaN from level 1 on (what K1 hands on
    from an indefinite pivot there): the saved rhs of levels >= 1 and the
    root solution are NaN in lane 1 alone, in lane groups of 1 and 2; lanes
    0 and 2 agree with the twin."""
    rng = np.random.default_rng(19)
    B, n_pad, m = 3, 16, 1
    M, O, F = (torch.as_tensor(x) for x in _chains(rng, B, n_pad, 11, m))
    levels, _, root_inv, _ = tck.factor_fwd_pass_plain(
        tck._to_slab(M), tck._to_slab(O), tck._to_slab(F), B)
    for Minv, _, _ in levels[1:]:
        Minv.view(11, 11, -1, B)[:, :, :, 1] = float("nan")
    root_inv[:, :, 1] = float("nan")
    f = torch.as_tensor(rng.normal(size=(B, n_pad, 11, m)))
    stack, x = _host_fwd_pass(host_kernels, levels, root_inv, f, G)
    assert _nan_lanes(stack[0], B) == [False] * 3
    for t in stack[2:] + [x]:
        assert _nan_lanes(t, B) == [False, True, False]
    want = tck.fwd_pass_plain(levels, root_inv, tck._to_slab(f), B)
    for g, w in zip(_flat([], stack, x), _flat([], *want), strict=True):
        keep = ~torch.isnan(w)
        assert torch.equal(torch.isnan(g), ~keep)
        np.testing.assert_allclose(g[keep].numpy(), w[keep].numpy(), rtol=0,
                                   atol=TOL * max(1.0, w[keep].abs().max().item()))


@pytest.mark.parametrize("m", [12, 1])
def test_kernel_passes_are_the_level_loop_bitwise(host_kernels, m):
    """Same arithmetic, not only the same values: in float32, with no
    contraction into FMAs, the pass routines give the very bits of the
    per-level column routines driven level by level with the even/odd split,
    shifts and interleave in torch (n_pad = 16: 4 levels, 3 lanes): K1 those
    of factor_fwd_column and of root_column's invert branch, K5 (K1's pass
    with no rhs) those of the same levels' factor and root inverse, K2 (in
    the kernel's lane groups) those of fwd_column and of root_column's apply
    branch, K3 those of bwd_column."""
    rng = np.random.default_rng(17)
    B, n_pad = 3, 16
    M, O, F = (torch.as_tensor(x, dtype=torch.float32)
               for x in _chains(rng, B, n_pad, 11, m))
    so = host_kernels
    blk = lambda: torch.empty(11, 11, B, dtype=torch.float32)
    rhs = lambda: torch.empty(11, m, B, dtype=torch.float32)
    # the level loop
    Ms, Os, Fs = tck._to_slab(M), tck._to_slab(O), tck._to_slab(F)
    levels, stack = [], []
    while Ms.shape[2] > B:
        (Me, Mo), (OL, OR), (Fe, Fo) = (tck._split_oe(t, B) for t in (Ms, Os, Fs))
        outs = [torch.empty_like(t) for t in (Mo, Mo, Mo, Mo, Fo, Fo)]
        Minv, Mhalf, Onext, S, Fe2, brF = _call(
            so.f_factor_fwd, [Mo, Me, OL, OR, Fo, Fe], outs, Mo.shape[2], m)
        Ms = (Mhalf - tck._shift_fwd(S, B)).contiguous()
        Os = Onext
        Fs = (Fe2 - tck._shift_fwd(brF, B)).contiguous()
        levels.append((Minv, OL, OR))
        stack.append(Fo)
    Ri, xr = _call(so.f_root, [Ms, Fs], [blk(), rhs()], B, m, 1)
    got = _host_factor_fwd_pass(so, M, O, F, prefix="f_")
    for g, w in zip(_flat(*got), _flat(levels, stack, Ri, xr), strict=True):
        assert torch.equal(g, w)
    got = _host_factor_pass(so, M, O, prefix="f_")
    for g, w in zip(_flat(got[0], [], got[1]), _flat(levels, [], Ri),
                    strict=True):
        assert torch.equal(g, w)
    # K2 against the same factor
    f = torch.as_tensor(rng.normal(size=(B, n_pad, 11, m)), dtype=torch.float32)
    got = _host_fwd_pass(so, levels, Ri, f, so.fwd_group(n_pad, m), prefix="f_")
    fs, saved = tck._to_slab(f), []
    for Minv, OL, OR in levels:
        fe, fo = tck._split_oe(fs, B)
        fe2, br = _call(so.f_fwd, [Minv, OL, OR, fo, fe],
                        [torch.empty_like(fo), torch.empty_like(fo)],
                        fo.shape[2], m)
        fs = (fe2 - tck._shift_fwd(br, B)).contiguous()
        saved.append(fo)
    xf = _call(so.f_root, [Ri, fs], [blk(), rhs()], B, m, 0)[1]
    for g, w in zip(_flat([], *got), _flat([], saved, xf), strict=True):
        assert torch.equal(g, w)
    x = torch.as_tensor(rng.normal(size=(11, m, B)), dtype=torch.float32)
    X = _host_bwd_pass(so, levels, stack, x, prefix="f_")
    for (Minv, OL, OR), fo in zip(reversed(levels), reversed(stack)):
        xs = tck._shift_bwd(x, B).contiguous()
        xo = _call(so.f_bwd, [Minv, OL, OR, fo, x, xs], [torch.empty_like(fo)],
                   fo.shape[2], m)[0]
        x = tck._interleave(x, xo, B)
    assert torch.equal(X, tck._from_slab(x, B))
