// Per-column block routines of the cyclic-reduction (CR) level kernels
// K1-K5 (the sequential-chain kernels K6-K8 build on them in
// chainkern_block.cuh).
//
// A "column" is one (block k, lane n) pair of a CR level.  Every operand is
// a slab of shape (a, b, L) in the batch-last layout of
// tol_tpu/ops/crkern.py: entry (i, j) of column c lies at
// p[(i * b + j) * L + c], so the routines below take a pointer already
// offset by c and the column stride L.  Neighbouring columns are
// neighbouring addresses, which is what makes a warp's loads coalesce.
//
// The routines are __host__ __device__: the CUDA kernels in crkern.cu call
// them with T = float, and a host build of this header (g++, T = double)
// is checked against the plain PyTorch twins in tests/test_torch_ops.py.
//
// Arithmetic follows the Pallas kernels term by term: the Cholesky column
// is s over the correctly rounded sqrt of its pivot (chainkern._chol_slab),
// the inverse solves L Y = I then L^T X = Y column by column
// (chainkern._spd_inverse_slab), and every product sums its terms in index
// order (chainkern._mm_slab / _mm_tn_slab, crkern._mm_nt_slab).  A
// non-positive pivot yields NaN, which then fills that column's outputs.
//
// One departure, on purpose: the Pallas body scales the column by the
// reciprocal, s * (1 / sqrt(p)); here it is the quotient s / sqrt(p), as in
// the JAX package's plain path (smallalg.chol_unrolled).  In IEEE float32
// the reciprocal form costs a second rounding per entry and leaves
// L_jj != sqrt(p).  On G7's stiff endgame, where the condensed blocks carry
// 1 / gamma ~ 2e5, that is enough to make the factorization break down at
// about three times the primal shift, and the solve then needs nearly twice
// the iterations (PERF.md, findings of the second slice).
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define CRK_HD __host__ __device__ __forceinline__
#define CRK_UNROLL _Pragma("unroll")
#else
#define CRK_HD inline
#define CRK_UNROLL
#endif

namespace crk {

constexpr int NB = 11;  // block size: the 11 decision variables of a node

CRK_HD float crk_sqrt(float x) { return sqrtf(x); }
CRK_HD double crk_sqrt(double x) { return sqrt(x); }

// y[i] = sum_l A(i, l) * x(l), i < N, l < K, summed in l order.
// A(i, l) = A[i * si + l * sl] and x(l) = x[l * sx]: with the strides of a
// slab this one routine gives all three product shapes of the Pallas
// kernels — A @ B (column q of B as x), A^T @ B (swap si and sl) and
// A @ B^T (row q of B as x).
template <int N, int K, typename T>
CRK_HD void matvec(const T* __restrict__ A, long si, long sl,
                   const T* __restrict__ x, long sx, T* __restrict__ y) {
  CRK_UNROLL
  for (int i = 0; i < N; ++i) {
    T acc = A[i * si] * x[0];
    CRK_UNROLL
    for (int l = 1; l < K; ++l) acc = acc + A[i * si + l * sl] * x[l * sx];
    y[i] = acc;
  }
}

// Element (i, j) of an NB x NB block of one slab column (stride s), and of
// the difference of two such blocks: what chol_lower factors.
template <typename T>
struct SlabBlock {
  const T* p;
  long s;
  CRK_HD T operator()(int i, int j) const { return p[(i * NB + j) * s]; }
};

template <typename T>
struct SlabBlockDiff {
  const T* p;
  long s;
  const T* q;
  long t;
  CRK_HD T operator()(int i, int j) const {
    return p[(i * NB + j) * s] - q[(i * NB + j) * t];
  }
};

// Cholesky columns of the SPD block a(i, j), by chainkern._chol_slab:
// Lc[j][i] is row i >= j of column j (the entries above the diagonal are
// left unset and never read).  Only the lower triangle of a is read.
template <typename T, typename Load>
CRK_HD void chol_lower(const Load& a, T (&Lc)[NB][NB]) {
  CRK_UNROLL
  for (int j = 0; j < NB; ++j) {
    T s[NB];
    CRK_UNROLL
    for (int i = j; i < NB; ++i) s[i] = a(i, j);
    CRK_UNROLL
    for (int k = 0; k < j; ++k) {
      CRK_UNROLL
      for (int i = j; i < NB; ++i) s[i] = s[i] - Lc[k][j] * Lc[k][i];
    }
    const T r = crk_sqrt(s[j]);  // NaN for a negative pivot
    CRK_UNROLL
    for (int i = j; i < NB; ++i) Lc[j][i] = s[i] / r;
  }
}

// Column c of the inverse from the Cholesky columns: L y = e_c, then
// L^T x = y (chainkern._spd_inverse_slab, one unit column).
template <typename T>
CRK_HD void inverse_column(const T (&Lc)[NB][NB], int c, T (&x)[NB]) {
  T y[NB];
  CRK_UNROLL
  for (int i = 0; i < NB; ++i) {
    const T e = (i == c) ? T(1) : T(0);
    T num = e;
    if (i > 0) {
      T s = Lc[0][i] * y[0];
      CRK_UNROLL
      for (int k = 1; k < i; ++k) s = s + Lc[k][i] * y[k];
      num = e - s;
    }
    y[i] = num / Lc[i][i];
  }
  CRK_UNROLL
  for (int i = NB - 1; i >= 0; --i) {
    T num = y[i];
    if (i < NB - 1) {
      T s = Lc[i][i + 1] * x[i + 1];
      CRK_UNROLL
      for (int k = i + 2; k < NB; ++k) s = s + Lc[i][k] * x[k];
      num = y[i] - s;
    }
    x[i] = num / Lc[i][i];
  }
}

// X = A^-1 (row-major NB x NB) for the SPD block A of one slab column,
// by the unrolled Cholesky of chainkern._spd_inverse_slab.  Only the
// lower triangle of A is read.
template <typename T>
CRK_HD void spd_inverse(const T* __restrict__ A, long L, T* __restrict__ X) {
  T Lc[NB][NB];
  chol_lower(SlabBlock<T>{A, L}, Lc);
  CRK_UNROLL
  for (int c = 0; c < NB; ++c) {
    T x[NB];
    inverse_column(Lc, c, x);
    CRK_UNROLL
    for (int i = 0; i < NB; ++i) X[i * NB + c] = x[i];
  }
}

// Slab strides of an NB x w block: row i, column j at (i * w + j) * L.
#define CRK_AT(p, i, j, w) (p)[((long)(i) * (w) + (j)) * L]

// K5 — one CR level without rhs (crkern._factor_kernel):
//   Minv = Mo^-1, Mhalf = Me - OL Minv OL^T, Onext = -OL Minv OR,
//   S = OR^T Minv OR.
// Minv is also left in the caller's row-major array, for K1's rhs part.
template <typename T>
CRK_HD void factor_column(const T* __restrict__ Mo, const T* __restrict__ Me,
                          const T* __restrict__ OL, const T* __restrict__ OR,
                          T* __restrict__ Minv_o, T* __restrict__ Mhalf_o,
                          T* __restrict__ Onext_o, T* __restrict__ S_o, long L,
                          T* __restrict__ Minv) {
  spd_inverse(Mo, L, Minv);
  CRK_UNROLL
  for (int e = 0; e < NB * NB; ++e) Minv_o[e * L] = Minv[e];
  T t[NB], u[NB];
  for (int q = 0; q < NB; ++q) {
    // t = Minv @ OR[:, q];  Onext[:, q] = -(OL @ t);  S[:, q] = OR^T @ t
    matvec<NB, NB>(Minv, NB, 1, &CRK_AT(OR, 0, q, NB), NB * L, t);
    matvec<NB, NB>(&CRK_AT(OL, 0, 0, NB), NB * L, L, t, 1, u);
    CRK_UNROLL
    for (int i = 0; i < NB; ++i) CRK_AT(Onext_o, i, q, NB) = -u[i];
    matvec<NB, NB>(&CRK_AT(OR, 0, 0, NB), L, NB * L, t, 1, u);
    CRK_UNROLL
    for (int i = 0; i < NB; ++i) CRK_AT(S_o, i, q, NB) = u[i];
    // t = (Minv @ OL^T)[:, q] = Minv @ OL[q, :];  Mhalf[:, q] = Me[:, q] - OL @ t
    matvec<NB, NB>(Minv, NB, 1, &CRK_AT(OL, q, 0, NB), L, t);
    matvec<NB, NB>(&CRK_AT(OL, 0, 0, NB), NB * L, L, t, 1, u);
    CRK_UNROLL
    for (int i = 0; i < NB; ++i)
      CRK_AT(Mhalf_o, i, q, NB) = CRK_AT(Me, i, q, NB) - u[i];
  }
}

// K1 — one CR level, factor fused with the forward elimination of m rhs
// columns (crkern._factor_fwd_kernel): K5's outputs, then
//   g = Minv Fo, Fe2 = Fe - OL g, brF = OR^T g.
template <typename T>
CRK_HD void factor_fwd_column(const T* __restrict__ Mo, const T* __restrict__ Me,
                              const T* __restrict__ OL, const T* __restrict__ OR,
                              const T* __restrict__ Fo, const T* __restrict__ Fe,
                              T* __restrict__ Minv_o, T* __restrict__ Mhalf_o,
                              T* __restrict__ Onext_o, T* __restrict__ S_o,
                              T* __restrict__ Fe2_o, T* __restrict__ brF_o,
                              long L, int m) {
  T Minv[NB * NB];
  factor_column(Mo, Me, OL, OR, Minv_o, Mhalf_o, Onext_o, S_o, L, Minv);
  T t[NB], u[NB];
  for (int j = 0; j < m; ++j) {
    matvec<NB, NB>(Minv, NB, 1, &CRK_AT(Fo, 0, j, m), (long)m * L, t);
    matvec<NB, NB>(&CRK_AT(OL, 0, 0, NB), NB * L, L, t, 1, u);
    CRK_UNROLL
    for (int i = 0; i < NB; ++i)
      CRK_AT(Fe2_o, i, j, m) = CRK_AT(Fe, i, j, m) - u[i];
    matvec<NB, NB>(&CRK_AT(OR, 0, 0, NB), L, NB * L, t, 1, u);
    CRK_UNROLL
    for (int i = 0; i < NB; ++i) CRK_AT(brF_o, i, j, m) = u[i];
  }
}

// K2 — forward elimination of m new rhs columns against a stored level
// (crkern._fwd_kernel): g = Minv fo, fe2 = fe - OL g, br = OR^T g.  g is
// consumed here and not stored (the solve never reads it back).
template <typename T>
CRK_HD void fwd_column(const T* __restrict__ Minv, const T* __restrict__ OL,
                       const T* __restrict__ OR, const T* __restrict__ fo,
                       const T* __restrict__ fe, T* __restrict__ fe2_o,
                       T* __restrict__ br_o, long L, int m) {
  T t[NB], u[NB];
  for (int j = 0; j < m; ++j) {
    matvec<NB, NB>(&CRK_AT(Minv, 0, 0, NB), NB * L, L, &CRK_AT(fo, 0, j, m),
                   (long)m * L, t);
    matvec<NB, NB>(&CRK_AT(OL, 0, 0, NB), NB * L, L, t, 1, u);
    CRK_UNROLL
    for (int i = 0; i < NB; ++i)
      CRK_AT(fe2_o, i, j, m) = CRK_AT(fe, i, j, m) - u[i];
    matvec<NB, NB>(&CRK_AT(OR, 0, 0, NB), L, NB * L, t, 1, u);
    CRK_UNROLL
    for (int i = 0; i < NB; ++i) CRK_AT(br_o, i, j, m) = u[i];
  }
}

// K3 — back-substitution of one level (crkern._bwd_kernel):
//   xo = Minv (fo - OL^T xe - OR xs),  xs = x_even shifted back one block.
template <typename T>
CRK_HD void bwd_column(const T* __restrict__ Minv, const T* __restrict__ OL,
                       const T* __restrict__ OR, const T* __restrict__ fo,
                       const T* __restrict__ xe, const T* __restrict__ xs,
                       T* __restrict__ xo_o, long L, int m) {
  T a[NB], b[NB], r[NB];
  for (int j = 0; j < m; ++j) {
    matvec<NB, NB>(&CRK_AT(OL, 0, 0, NB), L, NB * L, &CRK_AT(xe, 0, j, m),
                   (long)m * L, a);
    matvec<NB, NB>(&CRK_AT(OR, 0, 0, NB), NB * L, L, &CRK_AT(xs, 0, j, m),
                   (long)m * L, b);
    CRK_UNROLL
    for (int i = 0; i < NB; ++i) r[i] = (CRK_AT(fo, i, j, m) - a[i]) - b[i];
    matvec<NB, NB>(&CRK_AT(Minv, 0, 0, NB), NB * L, L, r, 1, a);
    CRK_UNROLL
    for (int i = 0; i < NB; ++i) CRK_AT(xo_o, i, j, m) = a[i];
  }
}

// K4 — the root block (crkern._root_kernel + _root_solve_kernel).
// invert != 0: Rinv = A^-1 is computed and stored, then X = Rinv F.
// invert == 0: A already holds the stored inverse; X = A F.
template <typename T>
CRK_HD void root_column(const T* __restrict__ A, const T* __restrict__ F,
                        T* __restrict__ Rinv_o, T* __restrict__ X_o, long L,
                        int m, int invert) {
  T R[NB * NB];
  if (invert) {
    spd_inverse(A, L, R);
    CRK_UNROLL
    for (int e = 0; e < NB * NB; ++e) Rinv_o[e * L] = R[e];
  } else {
    CRK_UNROLL
    for (int e = 0; e < NB * NB; ++e) R[e] = A[e * L];
  }
  T u[NB];
  for (int j = 0; j < m; ++j) {
    matvec<NB, NB>(R, NB, 1, &CRK_AT(F, 0, j, m), (long)m * L, u);
    CRK_UNROLL
    for (int i = 0; i < NB; ++i) CRK_AT(X_o, i, j, m) = u[i];
  }
}

#undef CRK_AT

}  // namespace crk
