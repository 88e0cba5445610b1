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
// (models/wind.py affine_wind).
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

// packed index of the Hessian entry (i, j), i <= j < NJ
NK_HD constexpr int tri(int i, int j) { return i * NJ - i * (i - 1) / 2 + (j - i); }

// value, gradient over the NJ jet variables and (H) the packed Hessian
template <typename T, bool H>
struct Jet {
  T v;
  T g[NJ];
  T h[H ? NP : 1];
};

template <typename T, bool H>
NK_HD Jet<T, H> constant(T c) {
  Jet<T, H> r;
  r.v = c;
  NK_UNROLL for (int i = 0; i < NJ; ++i) r.g[i] = T(0);
  if constexpr (H) {
    NK_UNROLL for (int p = 0; p < NP; ++p) r.h[p] = T(0);
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
template <typename T, bool H>
NK_HD Jet<T, H> lin(T a, const Jet<T, H>& x, T b, const Jet<T, H>& y) {
  Jet<T, H> r;
  r.v = a * x.v + b * y.v;
  NK_UNROLL for (int i = 0; i < NJ; ++i) r.g[i] = a * x.g[i] + b * y.g[i];
  if constexpr (H) {
    NK_UNROLL for (int p = 0; p < NP; ++p) r.h[p] = a * x.h[p] + b * y.h[p];
  }
  return r;
}

template <typename T, bool H>
NK_HD Jet<T, H> operator+(const Jet<T, H>& x, const Jet<T, H>& y) {
  return lin(T(1), x, T(1), y);
}

template <typename T, bool H>
NK_HD Jet<T, H> operator-(const Jet<T, H>& x, const Jet<T, H>& y) {
  return lin(T(1), x, T(-1), y);
}

template <typename T, bool H>
NK_HD Jet<T, H> operator*(T a, const Jet<T, H>& x) {
  Jet<T, H> r;
  r.v = a * x.v;
  NK_UNROLL for (int i = 0; i < NJ; ++i) r.g[i] = a * x.g[i];
  if constexpr (H) {
    NK_UNROLL for (int p = 0; p < NP; ++p) r.h[p] = a * x.h[p];
  }
  return r;
}

template <typename T, bool H>
NK_HD Jet<T, H> operator-(const Jet<T, H>& x) {
  return T(-1) * x;
}

template <typename T, bool H>
NK_HD Jet<T, H> operator+(T c, const Jet<T, H>& x) {
  Jet<T, H> r = x;
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

template <typename T, bool H>
NK_HD Jet<T, H> operator/(const Jet<T, H>& x, const Jet<T, H>& y) {
  const T inv = T(1) / y.v;
  return x * chain(y, inv, -inv * inv, T(2) * inv * inv * inv);
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

// Node g of B * npl nodes, node i = g % npl of lane b = g / npl: z at
// Z + b * ldz + 11 i, dt at dt[b * lddt], y at Y + b * ldy + 8 i for i < T
// (zero from node T on, and without the Hessian Y is not read).  Writes the
// node's out_floats(H) numbers to out.
template <typename T, bool H>
NK_HD void node_at(long g, const T* Z, long ldz, const T* dt, long lddt,
                   const T* Y, long ldy, int npl, int Tn, const T* par,
                   const Field<T>& F, T* out) {
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
