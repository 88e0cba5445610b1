// Per-node routine of the collocation node-block kernel (nodekern.cu).
//
// The defect of node i is z_{i+1}[:8] - z_i[:8] - DT f(Z_i), f the point-mass
// dynamics (tol_tpu_torch/models/dynamics.py state_derivatives), written in
// the scaled NLP's variables: Z = d_z * z, DT = d_dt * dt, rows over
// r = d_z[:8] (solver/canonical.py _scale_nlp; all scales 1 unscaled).  Under
// a wind field affine in position, W(p) = W0 + G p with G constant, this
// routine gives in closed form what the solver otherwise takes by torch.func
// transforms (solver/canonical.py constraint_jac_blocks, solver/
// kkt_condensed.py derivative_blocks):
//
//   Hn (12, 12)  Hessian over [z_i, dt] of y . defect(z_i, 0, dt)
//   A  (8, 11)   d defect / d z_i
//   d  (8,)      d defect / d dt
//
// How.  f depends on p only through W, and is affine in W, so with
// K = G G:  df/dp = G for the rows x, y, z; -e_a^T K, e_gam^T K / Va and
// -e_chi^T K / (Va cos gam) for Va, gam, chi; d^2 f / dp^2 = 0.  T, dphi
// and dCL enter linearly.  What is left nonlinear is a function of the five
// states s = (Va, gam, chi, phi, CL), z[3..7]: f is evaluated over a
// second-order jet in s (value, gradient, packed Hessian: 21 numbers), and
// the rows of df/dp over a first-order one, whose gradient is the p-s block
// of the Hessian.  No transcendental is written twice: the wind enters only
// through W0 and G, which the caller takes from the wind model itself
// (models/wind.py affine_wind).  Under the gridded storm field (wind model
// 3 at order 2) a second node_blocks, on a Grid in place of the Field,
// gives the same blocks with p in the jet (below).
//
// The routine is __host__ __device__: nodekern.cu runs it with T = float,
// and tests/test_torch_nodekern.py builds it with g++ in float64 and float32
// against the transforms.  Every operation is a plain IEEE one (no fast
// math); the card's compiler may contract a product and a sum into an FMA.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define NK_HD __host__ __device__ __forceinline__
#define NK_UNROLL _Pragma("unroll")
#else
#define NK_HD inline
#define NK_UNROLL
#endif

namespace nk {

constexpr int NV = 11;                 // node variables
constexpr int NS = 8;                  // dynamic states (defect rows)
constexpr int NU = NV + 1;             // [z, dt]
constexpr int NJ = 5;                  // jet variables: z[3..7]
constexpr int J0 = 3;                  // z index of the first jet variable
constexpr int NP = NJ * (NJ + 1) / 2;  // packed Hessian entries
constexpr int H_FLOATS = NU * NU;      // Hn
constexpr int A_FLOATS = NS * NV;      // A
constexpr int D_FLOATS = NS;           // d
constexpr int PAR_FLOATS = 17;         // mm, SS, Cd0, AR, ee, d_z (11), d_dt

// the floats one node writes: [Hn | A | d], or [A | d] without the Hessian
NK_HD constexpr int out_floats(bool hess) {
  return (hess ? H_FLOATS : 0) + A_FLOATS + D_FLOATS;
}

constexpr double kPi = 3.14159265358979323846;

NK_HD float nk_sin(float x) { return ::sinf(x); }
NK_HD double nk_sin(double x) { return ::sin(x); }
NK_HD float nk_cos(float x) { return ::cosf(x); }
NK_HD double nk_cos(double x) { return ::cos(x); }

// packed index of the Hessian entry (i, j), i <= j < N
template <int N = NJ>
NK_HD constexpr int tri(int i, int j) { return i * N - i * (i - 1) / 2 + (j - i); }

// value, gradient over N jet variables (the five states by default) and
// (H) the packed Hessian
template <typename T, bool H, int N = NJ>
struct Jet {
  T v;
  T g[N];
  T h[H ? N * (N + 1) / 2 : 1];
};

template <typename T, bool H, int N = NJ>
NK_HD Jet<T, H, N> constant(T c) {
  Jet<T, H, N> r;
  r.v = c;
  NK_UNROLL for (int i = 0; i < N; ++i) r.g[i] = T(0);
  if constexpr (H) {
    NK_UNROLL for (int p = 0; p < N * (N + 1) / 2; ++p) r.h[p] = T(0);
  }
  return r;
}

template <typename T, bool H>
NK_HD Jet<T, H> variable(T x, int k) {
  Jet<T, H> r = constant<T, H>(x);
  r.g[k] = T(1);
  return r;
}

// a * x + b * y, x and y jets, a and b numbers
template <typename T, bool H, int N>
NK_HD Jet<T, H, N> lin(T a, const Jet<T, H, N>& x, T b,
                       const Jet<T, H, N>& y) {
  Jet<T, H, N> r;
  r.v = a * x.v + b * y.v;
  NK_UNROLL for (int i = 0; i < N; ++i) r.g[i] = a * x.g[i] + b * y.g[i];
  if constexpr (H) {
    NK_UNROLL for (int p = 0; p < N * (N + 1) / 2; ++p)
      r.h[p] = a * x.h[p] + b * y.h[p];
  }
  return r;
}

template <typename T, bool H, int N>
NK_HD Jet<T, H, N> operator+(const Jet<T, H, N>& x, const Jet<T, H, N>& y) {
  return lin(T(1), x, T(1), y);
}

template <typename T, bool H, int N>
NK_HD Jet<T, H, N> operator-(const Jet<T, H, N>& x, const Jet<T, H, N>& y) {
  return lin(T(1), x, T(-1), y);
}

template <typename T, bool H, int N>
NK_HD Jet<T, H, N> operator*(T a, const Jet<T, H, N>& x) {
  Jet<T, H, N> r;
  r.v = a * x.v;
  NK_UNROLL for (int i = 0; i < N; ++i) r.g[i] = a * x.g[i];
  if constexpr (H) {
    NK_UNROLL for (int p = 0; p < N * (N + 1) / 2; ++p) r.h[p] = a * x.h[p];
  }
  return r;
}

template <typename T, bool H, int N>
NK_HD Jet<T, H, N> operator-(const Jet<T, H, N>& x) {
  return T(-1) * x;
}

template <typename T, bool H, int N>
NK_HD Jet<T, H, N> operator+(T c, const Jet<T, H, N>& x) {
  Jet<T, H, N> r = x;
  r.v = c + x.v;
  return r;
}

template <typename T, bool H>
NK_HD Jet<T, H> operator*(const Jet<T, H>& x, const Jet<T, H>& y) {
  Jet<T, H> r;
  r.v = x.v * y.v;
  NK_UNROLL for (int i = 0; i < NJ; ++i) r.g[i] = x.g[i] * y.v + x.v * y.g[i];
  if constexpr (H) {
    NK_UNROLL for (int i = 0; i < NJ; ++i) {
      NK_UNROLL for (int j = i; j < NJ; ++j) {
        const int p = tri(i, j);
        r.h[p] = x.h[p] * y.v + x.v * y.h[p] + x.g[i] * y.g[j] +
                 x.g[j] * y.g[i];
      }
    }
  }
  return r;
}

// phi(x) from phi's value f0 and derivatives f1, f2 at x.v
template <typename T, bool H>
NK_HD Jet<T, H> chain(const Jet<T, H>& x, T f0, T f1, T f2) {
  Jet<T, H> r;
  r.v = f0;
  NK_UNROLL for (int i = 0; i < NJ; ++i) r.g[i] = f1 * x.g[i];
  if constexpr (H) {
    NK_UNROLL for (int i = 0; i < NJ; ++i) {
      NK_UNROLL for (int j = i; j < NJ; ++j) {
        const int p = tri(i, j);
        r.h[p] = f1 * x.h[p] + f2 * x.g[i] * x.g[j];
      }
    }
  }
  return r;
}

// sin and cos of one jet, each number taken once
template <typename T, bool H>
NK_HD void sincos(const Jet<T, H>& x, Jet<T, H>& sx, Jet<T, H>& cx) {
  const T s = nk_sin(x.v), c = nk_cos(x.v);
  sx = chain(x, s, c, -s);
  cx = chain(x, c, -s, -c);
}

// 1 / y
template <typename T, bool H>
NK_HD Jet<T, H> recip(const Jet<T, H>& y) {
  const T inv = T(1) / y.v;
  return chain(y, inv, -inv * inv, T(2) * inv * inv * inv);
}

template <typename T, bool H>
NK_HD Jet<T, H> operator/(const Jet<T, H>& x, const Jet<T, H>& y) {
  return x * recip(y);
}

// the first-order part of a jet
template <typename T>
NK_HD Jet<T, false> first(const Jet<T, true>& x) {
  Jet<T, false> r;
  r.v = x.v;
  NK_UNROLL for (int i = 0; i < NJ; ++i) r.g[i] = x.g[i];
  return r;
}

template <typename T>
NK_HD Jet<T, false> first(const Jet<T, false>& x) {
  return x;
}

// The launch's constants: air density, gravity, the affine wind W0 (3), G
// (3x3, G[c][j] = dW_c / dp_j, row-major) and K = G G.
template <typename T>
struct Field {
  T rho, grav;
  T W0[3];
  T G[9];
  T K[9];
};

// rho, grav, W0 (3), G (9) as doubles -> Field (K in double, then rounded)
template <typename T>
NK_HD Field<T> make_field(const double* c) {
  Field<T> F;
  F.rho = T(c[0]);
  F.grav = T(c[1]);
  for (int i = 0; i < 3; ++i) F.W0[i] = T(c[2 + i]);
  for (int i = 0; i < 9; ++i) F.G[i] = T(c[5 + i]);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0.0;
      for (int k = 0; k < 3; ++k) s += c[5 + 3 * i + k] * c[5 + 3 * k + j];
      F.K[3 * i + j] = T(s);
    }
  return F;
}

// The blocks of one node.  z (11) and dt in the scaled NLP's variables, y
// (8) the defect multipliers (ignored without the Hessian), par the
// PAR_FLOATS airframe and scale numbers.  Writes out_floats(H) numbers to
// out, unit stride: [Hn row-major | A row-major | d].
template <typename T, bool H>
NK_HD void node_blocks(const T* z, T dt, const T* y, const T* par,
                       const Field<T>& F, T* out) {
  using J = Jet<T, H>;
  using J1 = Jet<T, false>;
  const T mm = par[0];
  const T qk = T(0.5) * F.rho * par[1];
  const T Cd0 = par[2];
  const T cdk = T(kPi) * par[3] * par[4];
  const T* dz = par + 5;
  const T ddt = par[16];

  T Zp[NV];
  NK_UNROLL for (int j = 0; j < NV; ++j) Zp[j] = dz[j] * z[j];
  const T DT = ddt * dt;

  // Jac[k][j] = d f_k / d Z_j (physical); rows 6, 7 are set below
  T Jac[NS][NV];
  NK_UNROLL for (int k = 0; k < NS; ++k) {
    NK_UNROLL for (int j = 0; j < NV; ++j) Jac[k][j] = T(0);
  }
  T fv[NS];

  // 1 / r, so that a row scale costs one division, not one per entry
  T rinv[NS];
  NK_UNROLL for (int k = 0; k < NS; ++k) rinv[k] = T(1) / dz[k];
  // Lagrangian l = sum_k yt_k f_k, yt = y / r: its packed s-s Hessian and
  // its p-s block
  T yt[NS];
  NK_UNROLL for (int k = 0; k < NS; ++k) yt[k] = H ? y[k] * rinv[k] : T(0);
  T Hss[NP];
  T Hps[3][NJ];
  NK_UNROLL for (int p = 0; p < NP; ++p) Hss[p] = T(0);
  NK_UNROLL for (int j = 0; j < 3; ++j) {
    NK_UNROLL for (int i = 0; i < NJ; ++i) Hps[j][i] = T(0);
  }

  // row k of f: value, s-gradient into Jac, and (H) its Hessian into Hss
  auto take = [&](int k, const J& f) {
    fv[k] = f.v;
    NK_UNROLL for (int i = 0; i < NJ; ++i) Jac[k][J0 + i] = f.g[i];
    if constexpr (H) {
      NK_UNROLL for (int p = 0; p < NP; ++p) Hss[p] += yt[k] * f.h[p];
    }
  };
  // df_k/dp = sum_c a_c K[c][.] (first-order jets a): into Jac and Hps
  auto take_p = [&](int k, const J1 (&a)[3]) {
    NK_UNROLL for (int j = 0; j < 3; ++j) {
      J1 m = lin(F.K[j], a[0], F.K[3 + j], a[1]);
      m = lin(T(1), m, F.K[6 + j], a[2]);
      Jac[k][j] = m.v;
      if constexpr (H) {
        NK_UNROLL for (int i = 0; i < NJ; ++i) Hps[j][i] += yt[k] * m.g[i];
      }
    }
  };

  T W[3];
  NK_UNROLL for (int c = 0; c < 3; ++c)
    W[c] = F.W0[c] + F.G[3 * c] * Zp[0] + F.G[3 * c + 1] * Zp[1] +
           F.G[3 * c + 2] * Zp[2];

  const J Va = variable<T, H>(Zp[3], 0);
  const J gam = variable<T, H>(Zp[4], 1);
  const J chi = variable<T, H>(Zp[5], 2);
  const J phi = variable<T, H>(Zp[6], 3);
  const J CL = variable<T, H>(Zp[7], 4);
  J cg, sg, cc, sc, cp, sp;
  sincos(gam, sg, cg);
  sincos(chi, sc, cc);
  sincos(phi, sp, cp);
  const J ea[3] = {cc * cg, sc * cg, -sg};
  const J eg[3] = {cc * sg, sc * sg, cg};

  // f_0..2: the ground velocity W + Va e_a
  J vg[3];
  NK_UNROLL for (int c = 0; c < 3; ++c) {
    vg[c] = W[c] + Va * ea[c];
    take(c, vg[c]);
    NK_UNROLL for (int j = 0; j < 3; ++j) Jac[c][j] = F.G[3 * c + j];
  }
  // the wind rate G v_g
  J wr[3];
  NK_UNROLL for (int c = 0; c < 3; ++c)
    wr[c] = lin(T(1), lin(F.G[3 * c], vg[0], F.G[3 * c + 1], vg[1]),
                F.G[3 * c + 2], vg[2]);

  const J q = qk * (Va * Va);
  const J L = q * CL;
  const J D = q * (Cd0 + (T(1) / cdk) * (CL * CL));

  // f_3: Va_dot
  {
    const J ew = ea[0] * wr[0] + ea[1] * wr[1] + ea[2] * wr[2];
    J f = (Zp[10] / mm) + (-F.grav * sg - (T(1) / mm) * D - ew);
    take(3, f);
    Jac[3][10] = T(1) / mm;
    const J1 a[3] = {-first(ea[0]), -first(ea[1]), -first(ea[2])};
    take_p(3, a);
  }
  // f_4: gam_dot
  {
    const J ew = eg[0] * wr[0] + eg[1] * wr[1] + eg[2] * wr[2];
    const J num = (T(1) / mm) * (L * cp) - F.grav * cg + ew;
    take(4, num / Va);
    const J1 iv = first(constant<T, H>(T(1)) / Va);
    const J1 a[3] = {first(eg[0]) * iv, first(eg[1]) * iv, first(eg[2]) * iv};
    take_p(4, a);
  }
  // f_5: chi_dot, e_chi = (-sin chi, cos chi, 0)
  {
    const J ew = cc * wr[1] - sc * wr[0];
    const J num = (T(1) / mm) * (L * sp) - ew;
    const J den = Va * cg;
    take(5, num / den);
    const J1 iv = first(constant<T, H>(T(1)) / den);
    const J1 a[3] = {first(sc) * iv, -(first(cc) * iv),
                     constant<T, false>(T(0))};
    take_p(5, a);
  }
  // f_6, f_7: the rates
  fv[6] = Zp[8];
  fv[7] = Zp[9];
  Jac[6][8] = T(1);
  Jac[7][9] = T(1);

  T* Hn = out;
  T* A = out + (H ? H_FLOATS : 0);
  T* d = A + A_FLOATS;
  NK_UNROLL for (int k = 0; k < NS; ++k) {
    d[k] = -(ddt * fv[k]) * rinv[k];
    const T c = -(DT * rinv[k]);
    NK_UNROLL for (int j = 0; j < NV; ++j)
      A[k * NV + j] = c * (Jac[k][j] * dz[j]) - (j == k ? T(1) : T(0));
  }
  if constexpr (H) {
    // dl/dZ_j, for the z-dt row
    T gl[NV];
    NK_UNROLL for (int j = 0; j < NV; ++j) {
      T s = T(0);
      NK_UNROLL for (int k = 0; k < NS; ++k) s += yt[k] * Jac[k][j];
      gl[j] = s;
    }
    // Hl over physical z: the p-s and s-s blocks, zero elsewhere
    NK_UNROLL for (int i = 0; i < NU * NU; ++i) Hn[i] = T(0);
    auto put = [&](int i, int j, T h) {
      const T v = -(DT * (dz[i] * dz[j])) * h;
      Hn[i * NU + j] = v;
      Hn[j * NU + i] = v;
    };
    NK_UNROLL for (int i = 0; i < NJ; ++i) {
      NK_UNROLL for (int j = i; j < NJ; ++j) put(J0 + i, J0 + j, Hss[tri(i, j)]);
      NK_UNROLL for (int p = 0; p < 3; ++p) put(p, J0 + i, Hps[p][i]);
    }
    NK_UNROLL for (int j = 0; j < NV; ++j) {
      const T v = -(ddt * dz[j]) * gl[j];
      Hn[j * NU + NV] = v;
      Hn[NV * NU + j] = v;
    }
  }
}

// ---- The gridded storm field: wind model 3 at order 2 ----
//
// Under models/wind.py's quadratic B-spline W is no longer affine in p:
// f depends on p through W(p) and through the wind rate grad W(p) v_g, so p
// rides the jet beside the five states (NG = 8 variables, slot k = z[k] for
// k < 8).  W_c and grad W_c enter as second-order jets in p alone (PJet),
// taken in closed form from the 27-node stencil: each axis gives its three
// weights w and their derivatives w', w'' (w''' = 0), so every partial
// derivative of order <= 3 with no axis above order 2 (17 a component, the
// mixed third ones among them) is one weighted stencil sum.  The states'
// own parts (e_a, e_gam, lift, drag, the divisions) stay five-variable jets
// and are multiplied into the eight-variable ones by muls; p-jets by mulp.

constexpr int NG = 8;                  // grid jets: p (3), then z[3..7]
constexpr int NGP = NG * (NG + 1) / 2;

// a jet in p alone: value, gradient (3), packed Hessian (tri<3>)
template <typename T>
struct PJet {
  T v;
  T g[3];
  T h[6];
};

// The launch's constants under the grid: air density, gravity, the
// field-ENU position of the local origin (east0, north0, up0) and the grid
// as the device holds it (models/wind.py WindGrid): the samples u, v, w
// (float32, (n[0], n[1], n[2]), x-major), origin and spacing (3, in T) and
// the live mask (3, float32), read at every launch.
template <typename T>
struct Grid {
  T rho, grav;
  T enu0[3];
  const float* f[3];
  const T* origin;
  const T* spacing;
  const float* live;
  int n[3];
};

// rho, grav, east0, north0, up0 as doubles, the grid's pointers and sizes
template <typename T>
NK_HD Grid<T> make_grid(const double* c, const float* u, const float* v,
                        const float* w, const T* origin, const T* spacing,
                        const float* live, int nx, int ny, int nz) {
  Grid<T> F;
  F.rho = T(c[0]);
  F.grav = T(c[1]);
  for (int i = 0; i < 3; ++i) F.enu0[i] = T(c[2 + i]);
  F.f[0] = u;
  F.f[1] = v;
  F.f[2] = w;
  F.origin = origin;
  F.spacing = spacing;
  F.live = live;
  F.n[0] = nx;
  F.n[1] = ny;
  F.n[2] = nz;
  return F;
}

NK_HD float nk_rint(float x) { return ::rintf(x); }
NK_HD double nk_rint(double x) { return ::rint(x); }

// W (3) and its gradient G[c][j] = dW_c / dp_j (3x3) at the NED position p
// (Zp[0..2]) as jets in p, as models/wind.py wind_ned takes them: the
// field-ENU position (x_e, y_n, z_u) = (p_1 + east0, p_0 + north0,
// -p_2 + up0); per axis rel = (x - origin) / spacing, the stencil's centre
// jc = clip(round(rel), 1, n - 2) (round half to even, as torch.round; a
// position outside the grid extrapolates from the clamped stencil), f =
// rel - jc; the field cast to T and the components times live; NED
// (W_x, W_y, W_z) = (v, u, -w).  Every axis needs n >= 3.
template <typename T>
NK_HD void grid_wind(const Grid<T>& F, const T* Zp, PJet<T> (&W)[3],
                     PJet<T> (&G)[3][3]) {
  const T pe[3] = {Zp[1] + F.enu0[0], Zp[0] + F.enu0[1], -Zp[2] + F.enu0[2]};
  long base[3];
  T w[3][3][3];    // [ENU axis][order][stencil node], in ENU metres
  NK_UNROLL for (int a = 0; a < 3; ++a) {
    const T rel = (pe[a] - F.origin[a]) / F.spacing[a];
    long j = (long)nk_rint(rel);
    j = j < 1 ? 1 : j;
    j = j > F.n[a] - 2 ? F.n[a] - 2 : j;
    base[a] = j - 1;
    const T f = rel - T(j);
    const T is = T(1) / F.spacing[a];
    const T lo = T(0.5) - f, hi = T(0.5) + f;
    w[a][0][0] = T(0.5) * (lo * lo);
    w[a][0][1] = T(0.75) - f * f;
    w[a][0][2] = T(0.5) * (hi * hi);
    w[a][1][0] = -lo * is;
    w[a][1][1] = T(-2) * f * is;
    w[a][1][2] = hi * is;
    w[a][2][0] = is * is;
    w[a][2][1] = T(-2) * (is * is);
    w[a][2][2] = is * is;
  }
  // D[q][kx][ky][kz]: the ENU derivative of ENU component q, kx + ky + kz
  // <= 3; z contracted first, then y, then x
  T D[3][3][3][3];
  const long n1 = F.n[1], n2 = F.n[2];
  NK_UNROLL for (int q = 0; q < 3; ++q) {
    const float* fq = F.f[q];
    const T lv = T(F.live[q]);
    T sy[3][3][3];   // [x node][ky][kz]
    NK_UNROLL for (int ix = 0; ix < 3; ++ix) {
      T sz[3][3];    // [y node][kz]
      NK_UNROLL for (int iy = 0; iy < 3; ++iy) {
        const float* col =
            fq + ((base[0] + ix) * n1 + (base[1] + iy)) * n2 + base[2];
        const T c0 = T(col[0]), c1 = T(col[1]), c2 = T(col[2]);
        NK_UNROLL for (int kz = 0; kz < 3; ++kz)
          sz[iy][kz] = w[2][kz][0] * c0 + w[2][kz][1] * c1 + w[2][kz][2] * c2;
      }
      NK_UNROLL for (int ky = 0; ky < 3; ++ky) {
        NK_UNROLL for (int kz = 0; kz < 3; ++kz) {
          if (ky + kz > 3) continue;
          sy[ix][ky][kz] = w[1][ky][0] * sz[0][kz] + w[1][ky][1] * sz[1][kz] +
                           w[1][ky][2] * sz[2][kz];
        }
      }
    }
    NK_UNROLL for (int kx = 0; kx < 3; ++kx) {
      NK_UNROLL for (int ky = 0; ky < 3; ++ky) {
        NK_UNROLL for (int kz = 0; kz < 3; ++kz) {
          if (kx + ky + kz > 3) continue;
          D[q][kx][ky][kz] =
              (w[0][kx][0] * sy[0][ky][kz] + w[0][kx][1] * sy[1][ky][kz] +
               w[0][kx][2] * sy[2][ky][kz]) *
              lv;
        }
      }
    }
  }
  // the NED derivative of NED component c along the NED axes a, b, e
  // (3: none): NED axis 0 is ENU 1, 1 is 0, 2 is -2; component 0 is v,
  // 1 is u, 2 is -w
  auto at = [&](int c, int a, int b, int e) -> T {
    const int k0 = (a == 0) + (b == 0) + (e == 0);
    const int k1 = (a == 1) + (b == 1) + (e == 1);
    const int k2 = (a == 2) + (b == 2) + (e == 2);
    if (k0 > 2 || k1 > 2 || k2 > 2) return T(0);   // w''' = 0
    const int q = c == 0 ? 1 : (c == 1 ? 0 : 2);
    const T s = D[q][k1][k0][k2];
    return ((c == 2) != (k2 % 2 == 1)) ? -s : s;
  };
  NK_UNROLL for (int c = 0; c < 3; ++c) {
    W[c].v = at(c, 3, 3, 3);
    NK_UNROLL for (int j = 0; j < 3; ++j) {
      W[c].g[j] = at(c, j, 3, 3);
      G[c][j].v = at(c, j, 3, 3);
      NK_UNROLL for (int k = 0; k < 3; ++k) {
        G[c][j].g[k] = at(c, j, k, 3);
        if (k >= j) W[c].h[tri<3>(j, k)] = at(c, j, k, 3);
        NK_UNROLL for (int l = k; l < 3; ++l)
          G[c][j].h[tri<3>(k, l)] = at(c, j, k, l);
      }
    }
  }
}

// a p-jet plus a state jet, as one eight-variable jet
template <typename T, bool H>
NK_HD Jet<T, H, NG> join(const PJet<T>& a, const Jet<T, H>& s) {
  Jet<T, H, NG> r;
  r.v = a.v + s.v;
  NK_UNROLL for (int i = 0; i < 3; ++i) r.g[i] = a.g[i];
  NK_UNROLL for (int i = 0; i < NJ; ++i) r.g[3 + i] = s.g[i];
  if constexpr (H) {
    NK_UNROLL for (int i = 0; i < NG; ++i) {
      NK_UNROLL for (int j = i; j < NG; ++j) {
        r.h[tri<NG>(i, j)] = j < 3   ? a.h[tri<3>(i, j)]
                             : i < 3 ? T(0)
                                     : s.h[tri(i - 3, j - 3)];
      }
    }
  }
  return r;
}

// a state jet as an eight-variable one (nothing in p)
template <typename T, bool H>
NK_HD Jet<T, H, NG> lift(const Jet<T, H>& s) {
  Jet<T, H, NG> r;
  r.v = s.v;
  NK_UNROLL for (int i = 0; i < 3; ++i) r.g[i] = T(0);
  NK_UNROLL for (int i = 0; i < NJ; ++i) r.g[3 + i] = s.g[i];
  if constexpr (H) {
    NK_UNROLL for (int i = 0; i < NG; ++i) {
      NK_UNROLL for (int j = i; j < NG; ++j)
        r.h[tri<NG>(i, j)] = i < 3 ? T(0) : s.h[tri(i - 3, j - 3)];
    }
  }
  return r;
}

// a p-jet times an eight-variable jet
template <typename T, bool H>
NK_HD Jet<T, H, NG> mulp(const PJet<T>& a, const Jet<T, H, NG>& x) {
  Jet<T, H, NG> r;
  r.v = a.v * x.v;
  NK_UNROLL for (int i = 0; i < NG; ++i)
    r.g[i] = i < 3 ? a.v * x.g[i] + a.g[i] * x.v : a.v * x.g[i];
  if constexpr (H) {
    NK_UNROLL for (int i = 0; i < NG; ++i) {
      NK_UNROLL for (int j = i; j < NG; ++j) {
        const int p = tri<NG>(i, j);
        T h = a.v * x.h[p];
        if (i < 3) h += a.g[i] * x.g[j];
        if (j < 3) h += a.g[j] * x.g[i] + a.h[tri<3>(i, j)] * x.v;
        r.h[p] = h;
      }
    }
  }
  return r;
}

// a state jet times an eight-variable jet
template <typename T, bool H>
NK_HD Jet<T, H, NG> muls(const Jet<T, H>& a, const Jet<T, H, NG>& x) {
  Jet<T, H, NG> r;
  r.v = a.v * x.v;
  NK_UNROLL for (int i = 0; i < NG; ++i)
    r.g[i] = i < 3 ? a.v * x.g[i] : a.v * x.g[i] + a.g[i - 3] * x.v;
  if constexpr (H) {
    NK_UNROLL for (int i = 0; i < NG; ++i) {
      NK_UNROLL for (int j = i; j < NG; ++j) {
        const int p = tri<NG>(i, j);
        T h = a.v * x.h[p];
        if (j >= 3) h += a.g[j - 3] * x.g[i];
        if (i >= 3) h += a.g[i - 3] * x.g[j] + a.h[tri(i - 3, j - 3)] * x.v;
        r.h[p] = h;
      }
    }
  }
  return r;
}

// The blocks of one node under the gridded field; arguments and output as
// the affine node_blocks above.
template <typename T, bool H>
NK_HD void node_blocks(const T* z, T dt, const T* y, const T* par,
                       const Grid<T>& F, T* out) {
  using J = Jet<T, H>;
  using J8 = Jet<T, H, NG>;
  const T mm = par[0];
  const T qk = T(0.5) * F.rho * par[1];
  const T Cd0 = par[2];
  const T cdk = T(kPi) * par[3] * par[4];
  const T* dz = par + 5;
  const T ddt = par[16];

  T Zp[NV];
  NK_UNROLL for (int j = 0; j < NV; ++j) Zp[j] = dz[j] * z[j];
  const T DT = ddt * dt;

  // Jac[k][j] = d f_k / d Z_j (physical); rows 6, 7 are set below
  T Jac[NS][NV];
  NK_UNROLL for (int k = 0; k < NS; ++k) {
    NK_UNROLL for (int j = 0; j < NV; ++j) Jac[k][j] = T(0);
  }
  T fv[NS];
  T rinv[NS];
  NK_UNROLL for (int k = 0; k < NS; ++k) rinv[k] = T(1) / dz[k];
  // Lagrangian l = sum_k yt_k f_k, yt = y / r: its packed Hessian over
  // z[0..7]
  T yt[NS];
  NK_UNROLL for (int k = 0; k < NS; ++k) yt[k] = H ? y[k] * rinv[k] : T(0);
  T Hl[H ? NGP : 1];
  if constexpr (H) {
    NK_UNROLL for (int p = 0; p < NGP; ++p) Hl[p] = T(0);
  }

  // row k of f: value, gradient into Jac, and (H) its Hessian into Hl
  auto take = [&](int k, const J8& f) {
    fv[k] = f.v;
    NK_UNROLL for (int i = 0; i < NG; ++i) Jac[k][i] = f.g[i];
    if constexpr (H) {
      NK_UNROLL for (int p = 0; p < NGP; ++p) Hl[p] += yt[k] * f.h[p];
    }
  };

  PJet<T> W[3], G[3][3];
  grid_wind(F, Zp, W, G);

  const J Va = variable<T, H>(Zp[3], 0);
  const J gam = variable<T, H>(Zp[4], 1);
  const J chi = variable<T, H>(Zp[5], 2);
  const J phi = variable<T, H>(Zp[6], 3);
  const J CL = variable<T, H>(Zp[7], 4);
  J cg, sg, cc, sc, cp, sp;
  sincos(gam, sg, cg);
  sincos(chi, sc, cc);
  sincos(phi, sp, cp);
  const J ea[3] = {cc * cg, sc * cg, -sg};
  const J eg[3] = {cc * sg, sc * sg, cg};

  // f_0..2: the ground velocity W(p) + Va e_a
  J8 vg[3];
  NK_UNROLL for (int c = 0; c < 3; ++c) {
    vg[c] = join(W[c], Va * ea[c]);
    take(c, vg[c]);
  }
  // the wind rate grad W(p) v_g
  J8 wr[3];
  NK_UNROLL for (int c = 0; c < 3; ++c)
    wr[c] = mulp(G[c][0], vg[0]) + mulp(G[c][1], vg[1]) +
            mulp(G[c][2], vg[2]);

  const J q = qk * (Va * Va);
  const J L = q * CL;
  const J D = q * (Cd0 + (T(1) / cdk) * (CL * CL));

  // f_3: Va_dot
  {
    const J8 ew = muls(ea[0], wr[0]) + muls(ea[1], wr[1]) + muls(ea[2], wr[2]);
    take(3, lift((Zp[10] / mm) + (-F.grav * sg - (T(1) / mm) * D)) - ew);
    Jac[3][10] = T(1) / mm;
  }
  // f_4: gam_dot
  {
    const J8 ew = muls(eg[0], wr[0]) + muls(eg[1], wr[1]) + muls(eg[2], wr[2]);
    const J8 num = lift((T(1) / mm) * (L * cp) - F.grav * cg) + ew;
    take(4, muls(recip(Va), num));
  }
  // f_5: chi_dot, e_chi = (-sin chi, cos chi, 0)
  {
    const J8 ew = muls(cc, wr[1]) - muls(sc, wr[0]);
    const J8 num = lift((T(1) / mm) * (L * sp)) - ew;
    take(5, muls(recip(Va * cg), num));
  }
  // f_6, f_7: the rates
  fv[6] = Zp[8];
  fv[7] = Zp[9];
  Jac[6][8] = T(1);
  Jac[7][9] = T(1);

  T* Hn = out;
  T* A = out + (H ? H_FLOATS : 0);
  T* d = A + A_FLOATS;
  NK_UNROLL for (int k = 0; k < NS; ++k) {
    d[k] = -(ddt * fv[k]) * rinv[k];
    const T c = -(DT * rinv[k]);
    NK_UNROLL for (int j = 0; j < NV; ++j)
      A[k * NV + j] = c * (Jac[k][j] * dz[j]) - (j == k ? T(1) : T(0));
  }
  if constexpr (H) {
    // dl/dZ_j, for the z-dt row
    T gl[NV];
    NK_UNROLL for (int j = 0; j < NV; ++j) {
      T s = T(0);
      NK_UNROLL for (int k = 0; k < NS; ++k) s += yt[k] * Jac[k][j];
      gl[j] = s;
    }
    // Hl over physical z[0..7], zero elsewhere
    NK_UNROLL for (int i = 0; i < NU * NU; ++i) Hn[i] = T(0);
    NK_UNROLL for (int i = 0; i < NG; ++i) {
      NK_UNROLL for (int j = i; j < NG; ++j) {
        const T v = -(DT * (dz[i] * dz[j])) * Hl[tri<NG>(i, j)];
        Hn[i * NU + j] = v;
        Hn[j * NU + i] = v;
      }
    }
    NK_UNROLL for (int j = 0; j < NV; ++j) {
      const T v = -(ddt * dz[j]) * gl[j];
      Hn[j * NU + NV] = v;
      Hn[NV * NU + j] = v;
    }
  }
}

// Node g of B * npl nodes, node i = g % npl of lane b = g / npl: z at
// Z + b * ldz + 11 i, dt at dt[b * lddt], y at Y + b * ldy + 8 i for i < T
// (zero from node T on, and without the Hessian Y is not read).  Writes the
// node's out_floats(H) numbers to out.  Fld is the wind: Field (affine) or
// Grid (the gridded storm field).
template <typename T, bool H, typename Fld>
NK_HD void node_at(long g, const T* Z, long ldz, const T* dt, long lddt,
                   const T* Y, long ldy, int npl, int Tn, const T* par,
                   const Fld& F, T* out) {
  const long b = g / npl;
  const int i = (int)(g - b * npl);
  T z[NV], y[NS];
  const T* zi = Z + b * ldz + (long)NV * i;
  NK_UNROLL for (int j = 0; j < NV; ++j) z[j] = zi[j];
  NK_UNROLL for (int k = 0; k < NS; ++k)
    y[k] = (H && i < Tn) ? Y[b * ldy + (long)NS * i + k] : T(0);
  node_blocks<T, H>(z, dt[b * lddt], y, par, F, out);
}

}  // namespace nk
