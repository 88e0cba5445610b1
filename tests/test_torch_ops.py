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
#include "crkern_block.cuh"
typedef const double* In;
typedef double* Out;
extern "C" {
void h_factor_fwd(In Mo, In Me, In OL, In OR, In Fo, In Fe, Out a, Out b,
                  Out c, Out d, Out e, Out f, long L, int m) {
  for (long k = 0; k < L; ++k)
    crk::factor_fwd_column<double>(Mo + k, Me + k, OL + k, OR + k, Fo + k,
                                   Fe + k, a + k, b + k, c + k, d + k, e + k,
                                   f + k, L, m);
}
void h_fwd(In Mi, In OL, In OR, In fo, In fe, Out fe2, Out br, long L, int m) {
  for (long k = 0; k < L; ++k)
    crk::fwd_column<double>(Mi + k, OL + k, OR + k, fo + k, fe + k, fe2 + k,
                            br + k, L, m);
}
void h_bwd(In Mi, In OL, In OR, In fo, In xe, In xs, Out xo, long L, int m) {
  for (long k = 0; k < L; ++k)
    crk::bwd_column<double>(Mi + k, OL + k, OR + k, fo + k, xe + k, xs + k,
                            xo + k, L, m);
}
void h_root(In A, In F, Out R, Out X, long L, int m, int inv) {
  for (long k = 0; k < L; ++k)
    crk::root_column<double>(A + k, F + k, inv ? R + k : nullptr, X + k, L, m,
                             inv);
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
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    P, Li, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    so.h_factor_fwd.argtypes = [P] * 12 + [Li, I]
    so.h_fwd.argtypes = [P] * 7 + [Li, I]
    so.h_bwd.argtypes = [P] * 7 + [Li, I]
    so.h_root.argtypes = [P] * 4 + [Li, I, I]
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
    want += tck.root_plain(Mo, Fo, True)
    got += _call(host_kernels.h_root, [Minv, Fo], [blk(), rhs()], L, m, 0)[1:]
    want += tck.root_plain(Minv, Fo, False)[1:]
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=TOL * max(1.0, w.abs().max().item()))
