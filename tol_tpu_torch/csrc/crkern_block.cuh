// Block routines of the cyclic-reduction (CR) kernels K1-K3, K5 (the
// sequential-chain kernels K6-K8 build on them in chainkern_block.cuh):
// per-column routines first, then the whole-pass routines of K1, K2 and K3,
// which run the same arithmetic item by item (see "Whole-pass routines").
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

// One CR level without rhs for one column (crkern._factor_kernel):
//   Minv = Mo^-1, Mhalf = Me - OL Minv OL^T, Onext = -OL Minv OR,
//   S = OR^T Minv OR.
// Minv is also left in the caller's row-major array, for K1's rhs part.
// No kernel calls it since K5 became K1's pass with no rhs; with
// factor_fwd_column it states the arithmetic that pass is held to.
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

// One level of K1 for one (block, lane) column, factor fused with the
// forward elimination of m rhs columns (crkern._factor_fwd_kernel):
// factor_column's outputs, then g = Minv Fo, Fe2 = Fe - OL g, brF = OR^T g.  No kernel
// calls it since K1 became a whole pass; it stays as the column-by-column
// statement of the arithmetic that factor_fwd_level spreads over items: the
// host build holds it against the twin, and the pass against it bit for bit
// in float32.
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

// One level of K2 for one column: forward elimination of m new rhs columns
// against a stored level (crkern._fwd_kernel): g = Minv fo, fe2 = fe - OL g,
// br = OR^T g.  g is consumed here and not stored (the solve never reads it
// back).  Like factor_fwd_column, the column-by-column statement of what
// fwd_pass computes item by item; no kernel calls it.
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

// Back-substitution of one level for one column (crkern._bwd_kernel):
//   xo = Minv (fo - OL^T xe - OR xs),  xs = x_even shifted back one block.
// Like factor_fwd_column, the column-by-column statement of what bwd_pass
// computes item by item, checked the same ways; no kernel calls it.
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

// The root block (crkern._root_kernel + _root_solve_kernel).
// invert != 0: Rinv = A^-1 is computed and stored, then X = Rinv F.
// invert == 0: A already holds the stored inverse; X = A F.
// No kernel calls it: the invert branch is the column statement of the
// root tail of K1 (with rhs) and of K5 (m = 0), the apply branch that of the
// K2 pass's last step; the host tests hold the passes against both.
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

// ---------------------------------------------------------------------------
// Whole-pass routines: K1 crp_factor_fwd_pass, K2 crp_fwd_pass and K3
// crp_bwd_pass.
//
// One team of threads runs every CR level of one lane (K1, K3) or of a
// group of lanes (K2).  A pass is a fixed sequence of steps; a step is a set
// of independent work items (each item computes a few output entries with
// the column routines' arithmetic) and ends at a barrier.  Team::each(n, f)
// runs items 0..n-1, Team::sync() is the barrier: on the card a thread
// block strides over the items and syncs (BlockTeam); on the host one
// thread runs them in order (SerialTeam), so the g++ build of this header
// runs the same steps in the same order.
// ---------------------------------------------------------------------------

struct SerialTeam {
  template <typename F>
  CRK_HD void each(int n, F&& f) const {
    for (int i = 0; i < n; ++i) f(i);
  }
  CRK_HD void sync() const {}
};

#ifdef __CUDACC__
struct BlockTeam {
  template <typename F>
  CRK_HD void each(int n, F&& f) const {
#ifdef __CUDA_ARCH__
    for (int i = threadIdx.x; i < n; i += blockDim.x) f(i);
#endif
  }
  CRK_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
};
#endif

// The blocks of one level of one lane: entry e (= i * width + j) of block k
// at p[e * es + k * bs].  Batch-first tensors and shared memory have
// es = 1 (Unit: fixed at compile time, so operand addresses are constant
// offsets), bs = block size; a batch-last slab (a, b, h * B) offset by the
// lane (Slab: the factor K1 writes and K3 reads) has es = h * B, bs = B.
template <typename T, bool kUnit>
struct View {
  T* p;
  long es, bs;
  CRK_HD long stride() const { return kUnit ? 1 : es; }
  CRK_HD T* blk(int k) const { return p + k * bs; }
  CRK_HD T& at(int k, int e) const { return p[e * stride() + k * bs]; }
};
template <typename T>
using Unit = View<T, true>;
template <typename T>
using Slab = View<T, false>;

// Level 0 of lane n for K1, batch-first (B, n_pad, NB, w).
template <typename T>
CRK_HD Unit<const T> lanes_first_view(const T* p, int w, long n, int n_pad) {
  return {p + n * n_pad * NB * w, 1, (long)NB * w};
}

// Per-level slabs of a factor, level l holding n_pad >> (l + 1) blocks.
constexpr int kMaxLevels = 16;
template <typename P>
struct LevelPtrs {
  P minv[kMaxLevels];
  P ol[kMaxLevels];
  P orr[kMaxLevels];
  P fo[kMaxLevels];
};

CRK_HD int log2_exact(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// Shared floats K1 needs per lane: the M, O, F blocks of levels 1, 2, ...
// ping-pong between a region of n_pad / 2 and one of n_pad / 4 blocks, the
// pivot inverses of one level (n_pad / 2 blocks), and the root block's
// Cholesky columns and inverse.
CRK_HD long factor_fwd_pass_floats(int n_pad, int m) {
  const long blk = 2 * NB * NB + (long)NB * m;
  return (n_pad / 2 + n_pad / 4) * blk + (long)(n_pad / 2 + 2) * NB * NB;
}

// Shared floats K2 needs per lane: f of levels 1, 2, ... (ping-pong between
// n_pad / 2 and n_pad / 4 blocks) and t = Minv fo of one level (n_pad / 2
// blocks), NB x m each.  Level 0 is read from device memory.
CRK_HD long fwd_pass_floats(int n_pad, int m) {
  return (long)(n_pad / 2 + n_pad / 4 + n_pad / 2) * NB * m;
}

// Lanes per thread block of K2: kFwdGroup, halved while the group's shared
// memory would pass the 227 KB a block may have.  Two lanes took least time
// at B = 128, m = 1 (1, 4 and 8 took 14-67% more; PERF.md, findings on
// the forward pass).
constexpr int kFwdGroup = 2;
constexpr long kMaxSmemBytes = 232448;
CRK_HD int fwd_pass_group(int n_pad, int m) {
  int G = kFwdGroup;
  while (G > 1 && G * fwd_pass_floats(n_pad, m) * (long)sizeof(float) >
                      kMaxSmemBytes)
    G /= 2;
  return G;
}

// Shared floats K3 needs per lane: x of two levels (ping-pong) and the
// residuals r of one level, n_pad / 2 blocks of NB x m each.
CRK_HD long bwd_pass_floats(int n_pad, int m) {
  return 3L * (n_pad / 2) * NB * m;
}

// Row i of column j of the Cholesky factor of block k of a (only its lower
// triangle is read), given columns 0..j-1: Lc[j * NB + i] (i >= j).  Every
// item recomputes the pivot s_j itself, so one barrier per column suffices;
// the arithmetic is chol_lower's.
template <typename T, typename V>
CRK_HD void chol_entry(const V& a, int k, T* __restrict__ Lc, int j, int i) {
  T si = a.at(k, i * NB + j), sj = a.at(k, j * NB + j);
  CRK_UNROLL
  for (int c = 0; c < NB - 1; ++c) {
    if (c < j) {
      si = si - Lc[c * NB + j] * Lc[c * NB + i];
      sj = sj - Lc[c * NB + j] * Lc[c * NB + j];
    }
  }
  Lc[j * NB + i] = si / crk_sqrt(sj);  // NaN for a negative pivot
}

// One level of K1 for one lane: the current level (cM, cO, cF; 2h blocks)
// -> its Minv, OL, OR, Fo slabs (o*) and the next level (nM, nO, nF; h
// blocks, shared memory), with W (h blocks) for the pivot inverses.  As
// factor_fwd_column:
//   Minv = Mo^-1; next M_k = (Me - OL Minv OL^T)_k - (OR^T Minv OR)_{k-1};
//   next O_k = -OL Minv OR;  next F_k = (Fe - OL g)_k - (OR^T g)_{k-1},
//   g = Minv Fo.
// The slab writes are one float each, B floats apart, and cost the SM
// several cycles apiece: they are spread as extra items over the steps
// (the level's OL, OR, Fo over the Cholesky columns, Minv over the two
// product steps), and each step's items are ordered by kind so that a
// warp's items take one branch.
template <typename T, typename Team>
CRK_HD void factor_fwd_level(const Team& team, const Unit<const T>& cM,
                             const Unit<const T>& cO, const Unit<const T>& cF,
                             const Unit<T>& nM, const Unit<T>& nO,
                             const Unit<T>& nF, const Slab<T>& oMinv,
                             const Slab<T>& oOL, const Slab<T>& oOR,
                             const Slab<T>& oFo, T* __restrict__ W, int h,
                             int m) {
  constexpr int N2 = NB * NB;
  const int wF = NB * m, hN = h * NB, hN2 = h * N2;
  const long es = cO.stride(), esF = cF.stride();
  // entry `it` of this level's OL, OR, Fo slabs (h N2 + h N2 + h wF)
  auto copy_level = [&](int it) {
    if (it < 2 * hN2) {
      const int k = (it % hN2) / N2, e = it % N2;
      (it < hN2 ? oOL : oOR).at(k, e) = cO.at(2 * k + (it >= hN2), e);
    } else {
      const int k = (it - 2 * hN2) / wF, e = (it - 2 * hN2) % wF;
      oFo.at(k, e) = cF.at(2 * k + 1, e);
    }
  };
  auto copy_minv = [&](int it) { oMinv.at(it / N2, it % N2) = W[it]; };
  const int n_copy = 2 * hN2 + h * wF;

  // Cholesky of the odd pivots M_{2k+1}, column by column, into the (still
  // free) slot of next M_k; a twelfth of the level's OL, OR, Fo entries go
  // out beside each column (the rest in the last step).
  for (int j = 0; j < NB; ++j) {
    const int nj = h * (NB - j), c0 = n_copy * j / 12,
              c1 = n_copy * (j + 1) / 12;
    team.each(nj + c1 - c0, [&](int it) {
      if (it < nj) {
        const int k = it / (NB - j);
        chol_entry(cM, 2 * k + 1, nM.blk(k), j, j + it % (NB - j));
      } else {
        copy_level(c0 + it - nj);
      }
    });
    team.sync();
  }
  // Column q of the pivot inverse (inverse_column) -> W.
  team.each(hN, [&](int it) {
    const int k = it / NB, q = it % NB;
    T x[NB];
    inverse_column(*reinterpret_cast<const T(*)[NB][NB]>(nM.blk(k)), q, x);
    CRK_UNROLL
    for (int i = 0; i < NB; ++i) W[k * N2 + i * NB + q] = x[i];
  });
  team.sync();
  // Column q of S_k = OR^T Minv OR, then column j of brF_k = OR^T Minv Fo,
  // parked in slot k + 1 of the next level (S and brF of the last block
  // fall off the chain); half of the Minv slab goes out.
  team.each(hN + h * m + hN2 / 2, [&](int it) {
    T t[NB], u[NB];
    if (it < hN) {
      const int k = it / NB, q = it % NB;
      const T* OR = cO.blk(2 * k + 1);
      matvec<NB, NB>(W + k * N2, NB, 1, OR + q * es, NB * es, t);
      matvec<NB, NB>(OR, es, NB * es, t, 1, u);
      if (k + 1 < h) {
        CRK_UNROLL
        for (int i = 0; i < NB; ++i) nM.at(k + 1, i * NB + q) = u[i];
      }
    } else if (it < hN + h * m) {
      const int k = (it - hN) / m, j = (it - hN) % m;
      matvec<NB, NB>(W + k * N2, NB, 1, cF.blk(2 * k + 1) + j * esF, m * esF,
                     t);
      matvec<NB, NB>(cO.blk(2 * k + 1), es, NB * es, t, 1, u);
      if (k + 1 < h) {
        CRK_UNROLL
        for (int i = 0; i < NB; ++i) nF.at(k + 1, i * m + j) = u[i];
      }
    } else {
      copy_minv(it - hN - h * m);
    }
  });
  team.sync();
  // Column q of next O_k, of next M_k, then column j of next F_k; the
  // other half of the Minv slab and the last twelfth of OL, OR, Fo.
  const int n_math = 2 * hN + h * m, n_minv = hN2 - hN2 / 2,
            c0 = n_copy * 11 / 12;
  team.each(n_math + n_minv + n_copy - c0, [&](int it) {
    T t[NB], u[NB];
    if (it < n_math) {
      const int kind = it < hN ? 0 : it < 2 * hN ? 1 : 2;
      const int r = it - kind * hN;
      const int k = kind < 2 ? r / NB : r / m, q = kind < 2 ? r % NB : r % m;
      const T* Wk = W + k * N2;
      const T* OL = cO.blk(2 * k);
      if (kind == 0) {
        matvec<NB, NB>(Wk, NB, 1, cO.blk(2 * k + 1) + q * es, NB * es, t);
        matvec<NB, NB>(OL, NB * es, es, t, 1, u);
        CRK_UNROLL
        for (int i = 0; i < NB; ++i) nO.at(k, i * NB + q) = -u[i];
      } else if (kind == 1) {
        matvec<NB, NB>(Wk, NB, 1, OL + q * NB * es, es, t);
        matvec<NB, NB>(OL, NB * es, es, t, 1, u);
        CRK_UNROLL
        for (int i = 0; i < NB; ++i) {
          const T mh = cM.at(2 * k, i * NB + q) - u[i];
          T& d = nM.at(k, i * NB + q);
          d = k > 0 ? mh - d : mh;
        }
      } else {
        matvec<NB, NB>(Wk, NB, 1, cF.blk(2 * k + 1) + q * esF, m * esF, t);
        matvec<NB, NB>(OL, NB * es, es, t, 1, u);
        CRK_UNROLL
        for (int i = 0; i < NB; ++i) {
          const T fe2 = cF.at(2 * k, i * m + q) - u[i];
          T& d = nF.at(k, i * m + q);
          d = k > 0 ? fe2 - d : fe2;
        }
      }
    } else if (it < n_math + n_minv) {
      copy_minv(hN2 / 2 + it - n_math);
    } else {
      copy_level(c0 + it - n_math - n_minv);
    }
  });
  team.sync();
}

// K1 — the whole fused factor + forward elimination of one lane
// (crkern._factor_fwd_kernel at every level, with the even/odd split, the
// one-block shifts and the subtractions between levels as index
// arithmetic), then the root block (crkern._root_kernel).  Level 0 is read
// from M0, O0, F0; each level's Minv, OL, OR, Fo go to the slabs of `out`
// (lane column `lane` of B), levels >= 1 live in shared memory, and the
// root's inverse and solution go to the slabs Rinv (NB, NB, B) and X
// (NB, m, B).  With m = 0 (K5: the factor alone) F0, Fo and X are neither
// read nor written.
template <typename T, typename Team>
CRK_HD void factor_fwd_pass(const Team& team, const Unit<const T>& M0,
                            const Unit<const T>& O0, const Unit<const T>& F0,
                            const LevelPtrs<T*>& out, T* Rinv, T* X, long B,
                            long lane, int n_pad, int m, T* smem) {
  constexpr int N2 = NB * NB;
  const int wF = NB * m;
  T* const region1 = smem + (long)(n_pad / 2) * (2 * N2 + wF);
  T* const W = region1 + (long)(n_pad / 4) * (2 * N2 + wF);  // Minv of a level
  T* const Lc = W + (long)(n_pad / 2) * N2;  // the root's Cholesky columns
  T* const R = Lc + N2;                      // and its inverse
  Unit<const T> cM = M0, cO = O0, cF = F0;
  int l = 0;
  for (int h = n_pad / 2; h >= 1; h /= 2, ++l) {
    T* const base = (l & 1) ? region1 : smem;
    const long c = (l & 1) ? n_pad / 4 : n_pad / 2;
    const Unit<T> nM{base, 1, N2}, nO{base + c * N2, 1, N2},
        nF{base + 2 * c * N2, 1, wF};
    const long L = h * B;
    const Slab<T> oMinv{out.minv[l] + lane, L, B}, oOL{out.ol[l] + lane, L, B},
        oOR{out.orr[l] + lane, L, B}, oFo{m ? out.fo[l] + lane : nullptr, L, B};
    factor_fwd_level(team, cM, cO, cF, nM, nO, nF, oMinv, oOL, oOR, oFo, W, h,
                     m);
    cM = {nM.p, 1, N2};
    cO = {nO.p, 1, N2};
    cF = {nF.p, 1, wF};
  }
  // The root, as root_column's invert branch: the Cholesky columns, one
  // barrier each; the columns of the inverse; then X = Rinv F.
  for (int j = 0; j < NB; ++j) {
    team.each(NB - j, [&](int it) { chol_entry(cM, 0, Lc, j, j + it); });
    team.sync();
  }
  team.each(NB, [&](int q) {
    T x[NB];
    inverse_column(*reinterpret_cast<const T(*)[NB][NB]>(Lc), q, x);
    CRK_UNROLL
    for (int i = 0; i < NB; ++i) {
      R[i * NB + q] = x[i];
      Rinv[(i * NB + q) * B + lane] = x[i];
    }
  });
  team.sync();
  team.each(wF, [&](int e) {
    const int i = e / m, j = e % m;
    T acc = R[i * NB] * cF.at(0, j);
    CRK_UNROLL
    for (int c = 1; c < NB; ++c) acc = acc + R[i * NB + c] * cF.at(0, c * m + j);
    X[e * B + lane] = acc;
  });
}

// The blocks of one level for a group of lanes: entry e of block k of lane
// g at p[g * gs + k * bs + e * es].  A batch-last slab (a, b, h * B) offset
// by the group's first lane has gs = 1, bs = B, es = h * B; the batch-first
// rhs (B, n_pad, NB, m) gs = n_pad * NB * m, bs = NB * m, es = 1; K2's
// shared memory, lanes fastest, gs = 1, bs = NB * m * G, es = G.
template <typename T>
struct Lanes {
  T* p;
  long gs, bs, es;
  CRK_HD T& at(int g, int k, int e) const { return p[g * gs + k * bs + e * es]; }
};

// Items of a lane group: item r of lane g is run as f(g, r), for the `ng`
// lanes present out of G (a power of two), r * G + g in order, so that
// neighbouring threads take neighbouring lanes.
template <typename Team>
struct LaneGroup {
  const Team& team;
  int G, gsh, ng;
  template <typename F>
  CRK_HD void each(int n, F&& f) const {
    team.each(n << gsh, [&](int it) {
      const int g = it & (G - 1);
      if (g < ng) f(g, it >> gsh);
    });
  }
};

// K2 — the whole forward elimination of m new rhs columns against a stored
// factor, for the lanes lane0 .. lane0 + G - 1 (crkern._fwd_kernel at every
// level, with the even/odd split, the one-block shift and the subtraction
// between levels as index arithmetic), then the root solution
// (crkern._root_solve_kernel).  Per level, as fwd_column:
//   t_k = Minv_k fo_k;  next f_k = (fe_k - OL_k t_k) - OR_{k-1}^T t_{k-1},
// fo_k, fe_k the blocks 2k + 1, 2k of the level's f; then x = Rinv f_root.
// Level 0 is read from the batch-first f (B, n_pad, NB, m); the factor's
// slabs lv (minv, ol, orr) and Rinv (NB, NB, B) are read batch-last, a
// slab entry of the group's lanes by neighbouring threads; each level's fo
// goes to the slab out.fo[l], x to the slab (NB, m, B).
template <typename T, typename Team>
CRK_HD void fwd_pass(const Team& team, const LevelPtrs<const T*>& lv,
                     const T* Rinv, const T* f, const LevelPtrs<T*>& out,
                     T* x, long B, long lane0, int G, int n_pad, int m,
                     T* smem) {
  const int w = NB * m, nl = log2_exact(n_pad);
  const LaneGroup<Team> grp{team, G, log2_exact(G),
                            (int)(B - lane0 < G ? B - lane0 : G)};
  const long cap0 = n_pad / 2, cap1 = n_pad / 4, bs = (long)w * G;
  const Lanes<T> t{smem + (cap0 + cap1) * bs, 1, bs, G};
  Lanes<const T> cur{f + lane0 * n_pad * w, (long)n_pad * w, w, 1};
  for (int l = 0, h = n_pad / 2; l < nl; ++l, h /= 2) {
    const long L = h * B;
    const Lanes<const T> Minv{lv.minv[l] + lane0, 1, B, L},
        OL{lv.ol[l] + lane0, 1, B, L}, OR{lv.orr[l] + lane0, 1, B, L};
    const Lanes<T> fo{out.fo[l] + lane0, 1, B, L};
    const Lanes<T> nf{smem + (l & 1) * cap0 * bs, 1, bs, G};
    // t_k(i, j) = (Minv_k fo_k)(i, j); fo_k(i, j) goes to the stack
    grp.each(h * w, [&](int g, int r) {
      const int k = r / w, e = r % w, i = e / m, j = e % m;
      T acc = Minv.at(g, k, i * NB) * cur.at(g, 2 * k + 1, j);
      CRK_UNROLL
      for (int c = 1; c < NB; ++c)
        acc = acc + Minv.at(g, k, i * NB + c) * cur.at(g, 2 * k + 1, c * m + j);
      t.at(g, k, e) = acc;
      fo.at(g, k, e) = cur.at(g, 2 * k + 1, e);
    });
    team.sync();
    // next f_k(i, j) = (fe_k - OL_k t_k)(i, j) - (OR_{k-1}^T t_{k-1})(i, j)
    grp.each(h * w, [&](int g, int r) {
      const int k = r / w, e = r % w, i = e / m, j = e % m;
      T u = OL.at(g, k, i * NB) * t.at(g, k, j);
      CRK_UNROLL
      for (int c = 1; c < NB; ++c)
        u = u + OL.at(g, k, i * NB + c) * t.at(g, k, c * m + j);
      const T fe2 = cur.at(g, 2 * k, e) - u;
      if (k > 0) {
        T b = OR.at(g, k - 1, i) * t.at(g, k - 1, j);
        CRK_UNROLL
        for (int c = 1; c < NB; ++c)
          b = b + OR.at(g, k - 1, c * NB + i) * t.at(g, k - 1, c * m + j);
        nf.at(g, k, e) = fe2 - b;
      } else {
        nf.at(g, k, e) = fe2;
      }
    });
    team.sync();
    cur = {nf.p, 1, bs, G};
  }
  // x(i, j) = (Rinv f_root)(i, j)
  const Lanes<const T> R{Rinv + lane0, 1, 0, B};
  grp.each(w, [&](int g, int e) {
    const int i = e / m, j = e % m;
    T acc = R.at(g, 0, i * NB) * cur.at(g, 0, j);
    CRK_UNROLL
    for (int c = 1; c < NB; ++c)
      acc = acc + R.at(g, 0, i * NB + c) * cur.at(g, 0, c * m + j);
    x[e * B + lane0 + g] = acc;
  });
}

// K3 — the whole back-substitution of one lane (crkern._bwd_kernel at every
// level, with the backward shift and the interleave as index arithmetic),
// from the root solution x0 (one block of the slab (NB, m, B)) to X, the
// lane's (n_pad, NB, m) batch-first solution, written once.  Per level, as
// bwd_column:
//   xo_k = Minv_k ((fo_k - OL_k^T x_k) - OR_k x_{k+1}),  x_h = 0;
//   next x_{2k} = x_k, next x_{2k+1} = xo_k.
template <typename T, typename Team>
CRK_HD void bwd_pass(const Team& team, const LevelPtrs<const T*>& lv,
                     const Slab<const T>& x0, T* X, long B, long lane,
                     int n_pad, int m, T* smem) {
  const int w = NB * m;
  const long cap = n_pad / 2;
  T* const R = smem + 2 * cap * w;
  const int nl = log2_exact(n_pad);
  // the root solution, into the ping-pong buffer the root level leaves free
  const Unit<T> root{nl > 0 ? smem + (nl & 1) * cap * w : X, 1, w};
  team.each(w, [&](int e) { root.at(0, e) = x0.at(0, e); });
  team.sync();
  Unit<const T> cx{root.p, 1, w};
  for (int l = nl - 1, h = 1; l >= 0; --l, h *= 2) {
    const long L = h * B;
    const Slab<const T> Minv{lv.minv[l] + lane, L, B},
        OL{lv.ol[l] + lane, L, B}, OR{lv.orr[l] + lane, L, B},
        fo{lv.fo[l] + lane, L, B};
    const Unit<T> nx{l == 0 ? X : smem + (l & 1) * cap * w, 1, w};
    // r_k(i, j) = (fo - OL^T x_k - OR x_{k+1})(i, j), each sum in index order
    team.each(h * w, [&](int it) {
      const int k = it / w, e = it % w, i = e / m, j = e % m;
      T a = OL.at(k, i) * cx.at(k, j);
      CRK_UNROLL
      for (int c = 1; c < NB; ++c)
        a = a + OL.at(k, c * NB + i) * cx.at(k, c * m + j);
      const bool last = k + 1 == h;
      T b = OR.at(k, i * NB) * (last ? T(0) : cx.at(k + 1, j));
      CRK_UNROLL
      for (int c = 1; c < NB; ++c)
        b = b + OR.at(k, i * NB + c) * (last ? T(0) : cx.at(k + 1, c * m + j));
      R[k * w + e] = (fo.at(k, e) - a) - b;
    });
    team.sync();
    team.each(h * w, [&](int it) {
      const int k = it / w, e = it % w, i = e / m, j = e % m;
      const T* r = R + k * w + j;
      T y = Minv.at(k, i * NB) * r[0];
      CRK_UNROLL
      for (int c = 1; c < NB; ++c) y = y + Minv.at(k, i * NB + c) * r[c * m];
      nx.at(2 * k + 1, e) = y;
      nx.at(2 * k, e) = cx.at(k, e);
    });
    team.sync();
    cx = {nx.p, 1, w};
  }
}

}  // namespace crk
