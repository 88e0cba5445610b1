// clock64 traces of the sequential-chain kernels K6-K8, and the latency of
// the operations on their chain, for tools/chain_clock.py.
//
// - old_k6 / old_k7 / old_k8: the K6, K7 and K8 kernels of the second slice
//   (K6: 13 warps share 32 lanes' steps column by column; K7, K8: one
//   thread per lane), copied from that version of chainkern.cu with clock
//   stamps between phases or steps.
// - pass_k6 / pass_k7 / pass_k8: the kernels that ship
//   (crk::chain_factor_pass, crk::rhs_forward_pass, crk::back_sub_pass) run
//   by a team whose mark() stamps the clock after every barrier.
// - latency: dependent chains of one operation on one thread.
// Stamps are taken by thread 0 of thread block 0 (old K6: the first thread
// of warp 0 and of the Cholesky warp) and summed over the chain steps.  A
// stamp after a phase waits for that phase's last result where the text
// says "consumed".
#include <cuda_runtime.h>

#include <type_traits>

#include "chainkern_block.cuh"

namespace {

constexpr int NB = crk::NB;
constexpr int NB2 = NB * NB;
constexpr int kLanes = 32, kGroups = 13;

// Wait until x is computed (an instruction that reads it), then stamp.
__device__ __forceinline__ long long stamp_after(float x) {
  float y;
  asm volatile("add.f32 %0, %1, 0f00000000;" : "=f"(y) : "f"(x));
  asm volatile("" ::"f"(y));
  return clock64();
}

// old K6; out[w * 7 + k]: for w = 0 (warp 0) and 1 (the Cholesky warp) the
// cycles summed over the steps of: 0 phase A (Cholesky / R~ columns), 1 the
// barrier after it, 2 phase B (inverse columns), 3 its barrier, 4 phase C
// ([O | R~] columns), 5 its barrier; 6 the whole loop.
__global__ void __launch_bounds__(kLanes * kGroups)
old_k6_kernel(const float* __restrict__ M, const float* __restrict__ O,
              const float* __restrict__ R, float* __restrict__ Dinv,
              float* __restrict__ t2, float* __restrict__ tR,
              float* __restrict__ S, int T, int nC, long B,
              long long* __restrict__ out) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x, g = threadIdx.y;
  const long b = (long)blockIdx.x * kLanes + lane;
  const bool live = b < B;
  const bool rec = blockIdx.x == 0 && lane == 0 && (g == 0 || g == kGroups - 1);
  const int w = g == 0 ? 0 : 1;
  long long acc[6] = {0, 0, 0, 0, 0, 0};
  float* Lc = sm + lane;
  float* Dv = Lc + NB2 * kLanes;
  float* dcorr = Dv + NB2 * kLanes;
  float* Rt = dcorr + NB2 * kLanes;
  float* rcorr = Rt + NB * nC * kLanes;
  float* s_acc = rcorr + NB * nC * kLanes;
  for (int e = g; e < NB2; e += kGroups) dcorr[e * kLanes] = 0.0f;
  for (int e = g; e < NB * nC; e += kGroups) rcorr[e * kLanes] = 0.0f;
  for (int e = g; e < nC * nC; e += kGroups) s_acc[e * kLanes] = 0.0f;
  __syncthreads();
  const long long t_begin = clock64();
  for (int i = 0; i < T; ++i) {
    const float* Mi = M + (long)i * NB2 * B + b;
    const float* Oi = O + (long)i * NB2 * B + b;
    const float* Ri = R + (long)i * NB * nC * B + b;
    long long t0 = clock64();
    if (live) {
      if (g == kGroups - 1) crk::chain_chol<float>(Mi, B, dcorr, kLanes, Lc, kLanes);
      for (int q = g; q < nC; q += kGroups)
        crk::chain_rt_column<float>(Ri, B, rcorr, kLanes, Rt, kLanes, nC, q);
    }
    long long t1 = stamp_after(Lc[NB2 * kLanes - kLanes]);
    __syncthreads();
    long long t2s = clock64();
    if (live) {
      for (int c = g; c < NB; c += kGroups)
        crk::chain_inverse_column<float>(Lc, kLanes, c, Dv, kLanes,
                                         Dinv + (long)i * NB2 * B + b, B);
    }
    long long t3 = stamp_after(Dv[0]);
    __syncthreads();
    long long t4 = clock64();
    if (live) {
      for (int q = g; q < NB + nC; q += kGroups)
        crk::chain_factor_column<float>(
            Dv, kLanes, Oi, B, Rt, kLanes, t2 + (long)i * NB2 * B + b,
            tR + (long)i * NB * nC * B + b, B, dcorr, kLanes, rcorr, kLanes,
            s_acc, kLanes, nC, q);
    }
    long long t5 = stamp_after(dcorr[0]);
    __syncthreads();
    long long t6 = clock64();
    acc[0] += t1 - t0; acc[1] += t2s - t1; acc[2] += t3 - t2s;
    acc[3] += t4 - t3; acc[4] += t5 - t4; acc[5] += t6 - t5;
  }
  const long long t_end = clock64();
  if (live) {
    for (int e = g; e < nC * nC; e += kGroups) S[(long)e * B + b] = s_acc[e * kLanes];
  }
  if (rec) {
    for (int k = 0; k < 6; ++k) out[w * 7 + k] = acc[k];
    out[w * 7 + 6] = t_end - t_begin;
  }
}

// old K8; out: cycles summed over the steps of 0 the a-term (consumed),
// 1 the product with t2 (consumed), 2 the stores; 3 the whole loop.
__global__ void __launch_bounds__(kLanes)
old_k8_kernel(const float* __restrict__ tR, const float* __restrict__ t2,
              const float* __restrict__ coef, float* __restrict__ x, int T,
              int nC, long B, long long* __restrict__ out) {
  const long b = (long)blockIdx.x * kLanes + threadIdx.x;
  if (b >= B) return;
  float xn[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) xn[k] = 0.0f;
  long long acc[3] = {0, 0, 0};
  const long long t_begin = clock64();
  for (int i = T - 1; i >= 0; --i) {
    const float* tRi = tR + (long)i * NB * nC * B + b;
    const float* t2i = t2 + (long)i * NB2 * B + b;
    float* xo = x + (long)i * NB * B + b;
    long long t0 = clock64();
    float a[NB], c[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      float s = tRi[(long)n * nC * B] * coef[b];
      for (int k = 1; k < nC; ++k) s = s + tRi[((long)n * nC + k) * B] * coef[k * B + b];
      a[n] = s;
    }
    long long t1 = stamp_after(a[NB - 1]);
    crk::matvec<NB, NB>(t2i, NB * B, B, xn, 1, c);
    long long t2c = stamp_after(c[NB - 1]);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      xn[n] = a[n] - c[n];
      xo[n * B] = xn[n];
    }
    long long t3 = clock64();
    acc[0] += t1 - t0; acc[1] += t2c - t1; acc[2] += t3 - t2c;
  }
  const long long t_end = clock64();
  if (b == 0) {
    for (int k = 0; k < 3; ++k) out[k] = acc[k];
    out[3] = t_end - t_begin;
  }
}

// old K7 (one thread per lane, 32 lanes a block, chain_rhs_forward_block
// on every step; launched without a synchronise, so that CUDA events time
// it): out[0] the cycles summed over the steps (stamped when the
// step's rcorr is consumed).  kShared: the same steps with every operand
// read from shared memory, step 0's operands of the lane staged there once
// (tr to a shared scratch): what the steps take without waiting on device
// memory.
template <bool kShared>
__global__ void __launch_bounds__(kLanes)
old_k7_kernel(const float* __restrict__ Dinv, const float* __restrict__ O,
              const float* __restrict__ tRw, const float* __restrict__ r,
              float* __restrict__ tr, int T, int nB, long B,
              long long* __restrict__ out) {
  extern __shared__ float sm[];
  const long b = (long)blockIdx.x * kLanes + threadIdx.x;
  if (b >= B) return;
  float* acc = sm + threadIdx.x;          // entry p at [p * kLanes]
  float* ops = acc + nB * kLanes;         // Dinv, O, tRw, r, tr of step 0
  float* sO = ops + NB2 * kLanes;
  float* sW = sO + NB2 * kLanes;
  float* sr = sW + NB * nB * kLanes;
  float* st = sr + NB * kLanes;
  for (int p = 0; p < nB; ++p) acc[p * kLanes] = 0.0f;
  if (kShared) {
    for (int e = 0; e < NB2; ++e) {
      ops[e * kLanes] = Dinv[(long)e * B + b];
      sO[e * kLanes] = O[(long)e * B + b];
    }
    for (int e = 0; e < NB * nB; ++e) sW[e * kLanes] = tRw[(long)e * B + b];
    for (int e = 0; e < NB; ++e) sr[e * kLanes] = r[(long)e * B + b];
  }
  float rcorr[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) rcorr[k] = 0.0f;
  long long tot = 0;
  for (int i = 0; i < T; ++i) {
    const long long t0 = clock64();
    if (kShared)
      crk::chain_rhs_forward_block<float>(ops, sO, sW, sr, st, kLanes, rcorr,
                                          acc, kLanes, nB);
    else
      crk::chain_rhs_forward_block<float>(
          Dinv + (long)i * NB2 * B + b, O + (long)i * NB2 * B + b,
          tRw + (long)i * NB * nB * B + b, r + (long)i * NB * B + b,
          tr + (long)i * NB * B + b, B, rcorr, acc, kLanes, nB);
    tot += stamp_after(rcorr[NB - 1]) - t0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = tot;
}

// The shipped passes with a team that stamps after every barrier: out[0]
// is the clock at the start of thread 0 of block 0, out[k] at its k-th
// mark.
// kChainOut, 2 kChainOut: when thread 0 of block 0 has finished its part of
// invert or rhs_chain (the chain) and when the first thread past the
// chain's warps has finished its items, in the step whose next mark is at
// the same index; 3 kChainOut: when that thread started them.
constexpr int kChainOut = 1024;
template <bool kApart>
struct TraceTeamT : crk::BlockChainTeam {
  long long* out;
  mutable int n = 0;
  __host__ __device__ void mark(int) const {
#ifdef __CUDA_ARCH__
    if (blockIdx.x == 0 && threadIdx.x == 0) out[n] = clock64();
#endif
    ++n;
  }
  template <typename T>
  __host__ __device__ void invert(int t, int G, int ng, const T* Dt,
                                  T* Dv) const {
    crk::BlockChainTeam::invert(t, G, ng, Dt, Dv);
#ifdef __CUDA_ARCH__
    if (blockIdx.x == 0 && t == 0) out[kChainOut + n] = clock64();
#endif
  }
  template <typename T, typename Ops, typename Rv, typename Rc>
  __host__ __device__ void rhs_chain(int t, int ng, int w, long wst, Ops&& ops,
                                     Rv&& rv, Rc&& rc) const {
    crk::BlockChainTeam::rhs_chain<T>(t, ng, w, wst, ops, rv, rc);
#ifdef __CUDA_ARCH__
    if (blockIdx.x == 0 && t == 0) out[kChainOut + n] = clock64();
#endif
  }
  // kApart: the chain's part first, then a barrier, then the rest on all
  // threads (the chain without the rest beside it; the results are the
  // same).
  template <typename FA, typename FB>
  __host__ __device__ void each_split(int na, FA&& fa, int nb, FB&& fb) const {
#ifdef __CUDA_ARCH__
    if (blockIdx.x == 0 && (int)threadIdx.x == na)
      out[3 * kChainOut + n] = clock64();
    if (kApart) {
      if ((int)threadIdx.x < na) fa(threadIdx.x);
      __syncthreads();
      for (int i = threadIdx.x; i < nb; i += blockDim.x) fb(i);
    } else {
      crk::BlockChainTeam::each_split(na, fa, nb, fb);
    }
    if (blockIdx.x == 0 && (int)threadIdx.x == na)
      out[2 * kChainOut + n] = clock64();
#endif
  }
};
using TraceTeam = TraceTeamT<false>;

template <int G>
__global__ void __launch_bounds__(256, 1)
pass_k6_kernel(const float* __restrict__ M, const float* __restrict__ O,
               const float* __restrict__ R, float* __restrict__ Dinv,
               float* __restrict__ t2, float* __restrict__ tR,
               float* __restrict__ S, int T, int nC, long B,
               long long* __restrict__ out) {
  extern __shared__ float sm[];
  TraceTeam team;
  team.out = out;
  team.n = 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = clock64();
  crk::chain_factor_pass<float>(team, M, O, R, Dinv, t2, tR, S, T, nC, B,
                                (long)blockIdx.x * G, G, sm);
}

template <int G>
__global__ void __launch_bounds__(256, 1)
pass_k6_apart_kernel(const float* __restrict__ M, const float* __restrict__ O,
                     const float* __restrict__ R, float* __restrict__ Dinv,
                     float* __restrict__ t2, float* __restrict__ tR,
                     float* __restrict__ S, int T, int nC, long B,
                     long long* __restrict__ out) {
  extern __shared__ float sm[];
  TraceTeamT<true> team;
  team.out = out;
  team.n = 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = clock64();
  crk::chain_factor_pass<float>(team, M, O, R, Dinv, t2, tR, S, T, nC, B,
                                (long)blockIdx.x * G, G, sm);
}

// kApart: the chain, a barrier, then the rest (the chain without the
// copies beside it).
template <int G, bool kApart>
__global__ void __launch_bounds__(512, 1)
pass_k7_kernel(const float* __restrict__ Dinv, const float* __restrict__ O,
               const float* __restrict__ tRw, const float* __restrict__ r,
               float* __restrict__ tr, float* __restrict__ sb, int T, int nB,
               long B, int C, long long* __restrict__ out) {
  extern __shared__ float sm[];
  TraceTeamT<kApart> team;
  team.out = out;
  team.n = 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = clock64();
  crk::rhs_forward_pass<float>(team, Dinv, O, tRw, r, tr, sb, T, nB, B,
                               (long)blockIdx.x * G, G, C, sm);
}

// One warp inverts the SPD block A (G lanes of the same block) n times, each
// time after the last: out = cycles for n inverts.
__global__ void invert_kernel(const float* __restrict__ A, int G, int n,
                              long long* __restrict__ out,
                              float* __restrict__ sink) {
  __shared__ float Dt[NB2 * 8], Dv[NB2 * 8];
  for (int e = threadIdx.x; e < NB2 * G; e += blockDim.x) Dt[e] = A[e / G];
  __syncwarp();
  const crk::BlockChainTeam team;
  const long long t0 = clock64();
  for (int k = 0; k < n; ++k) {
    team.invert((int)threadIdx.x, G, G, Dt, Dv);
    __syncwarp();
    if (threadIdx.x == 0) Dt[0] = Dt[0] + Dv[0] * 0.0f;
    __syncwarp();
  }
  const long long t1 = stamp_after(Dt[0]);
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    sink[0] = Dv[threadIdx.x];
  }
}

template <int G>
__global__ void __launch_bounds__(512, 1)
pass_k8_kernel(const float* __restrict__ tR, const float* __restrict__ t2,
               const float* __restrict__ coef, float* __restrict__ x, int T,
               int nC, long B, int Tc, long long* __restrict__ out) {
  extern __shared__ float sm[];
  TraceTeam team;
  team.out = out;
  team.n = 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = clock64();
  crk::back_sub_pass<float>(team, tR, t2, coef, x, T, nC, B,
                            (long)blockIdx.x * G, G, Tc, sm);
}

// Dependent chains on one thread; out[k] = cycles for n links of:
// 0 x + c, 1 fma(x, a, c), 2 sqrt(x) + c, 3 c / x + c' (IEEE quotient),
// 4 chol_lower of an 11x11 block, 5 chol_lower + one inverse_column,
// 6 (0 * x) / w + x with w != 0.
__global__ void latency_kernel(const float* __restrict__ A, float seed, int n,
                               long long* __restrict__ out,
                               float* __restrict__ sink) {
  float x = seed;
  long long t0 = clock64();
  for (int k = 0; k < n; ++k) x = x + 1e-7f;
  long long t1 = stamp_after(x);
  out[0] = t1 - t0;
  float y = seed;
  t0 = clock64();
  for (int k = 0; k < n; ++k) y = fmaf(y, 0.999f, 0.001f);
  t1 = stamp_after(y);
  out[1] = t1 - t0;
  float z = seed;
  t0 = clock64();
  for (int k = 0; k < n; ++k) z = sqrtf(z) + 1.0f;
  t1 = stamp_after(z);
  out[2] = t1 - t0;
  float q = seed;
  t0 = clock64();
  for (int k = 0; k < n; ++k) q = 1.5f / q + 1.0f;
  t1 = stamp_after(q);
  out[3] = t1 - t0;
  float a[NB2];
#pragma unroll
  for (int e = 0; e < NB2; ++e) a[e] = A[e];
  const int m = n / 64;
  float L[NB][NB], v[NB];
  t0 = clock64();
  for (int k = 0; k < m; ++k) {
    crk::chol_lower(crk::SlabBlock<float>{a, 1}, L);
    a[0] = a[0] + L[NB - 1][NB - 1] * 0.0f;
  }
  t1 = stamp_after(a[0]);
  out[4] = (t1 - t0) * 64;
  t0 = clock64();
  for (int k = 0; k < m; ++k) {
    crk::chol_lower(crk::SlabBlock<float>{a, 1}, L);
    crk::inverse_column(L, 0, v);
    a[0] = a[0] + v[0] * 0.0f;
  }
  t1 = stamp_after(a[0]);
  out[5] = (t1 - t0) * 64;
  // 6: zero / w + q, the quotient of a zero numerator (the slow path)
  float zq = seed;
  const float zero = seed * 0.0f, w = seed + 0.5f;
  t0 = clock64();
  for (int k = 0; k < n; ++k) zq = (zero * zq) / w + zq;
  t1 = stamp_after(zq);
  out[6] = t1 - t0;
  sink[0] = x + y + z + q + a[0] + zq;
}

// FastOps against the library's IEEE sqrtf and quotient on n log-uniform
// operands each (sqrt: positive, 2^-120 .. 2^120; quotient: signed,
// 2^-70 .. 2^70, and a zero numerator one time in 64): out[0], out[2] the
// operands inside FastOps' range whose bits differ, out[1], out[3] how many
// were inside it.
__device__ __forceinline__ unsigned hash32(unsigned x) {
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu;
  return x ^ (x >> 16);
}
__device__ __forceinline__ float log_uniform(unsigned h, int emax) {
  const float e = (float)((int)(h % (unsigned)(2 * emax)) - emax);
  return exp2f(e + (float)(hash32(h) & 0xffffff) / 16777216.0f);
}
__global__ void fast_ops_kernel(long n, unsigned long long* __restrict__ out) {
  unsigned long long c[4] = {0, 0, 0, 0};
  for (long k = (long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (long)gridDim.x * blockDim.x) {
    const unsigned h = hash32((unsigned)k * 3u + 1u);
    const float x = log_uniform(h, 120);
    bool ok = true;
    const float fs = crk::FastOps::sqrt(x, ok);
    if (ok) {
      c[1] += 1;
      c[0] += __float_as_uint(fs) != __float_as_uint(sqrtf(x));
    }
    const unsigned h2 = hash32(h ^ 0x9e3779b9u), h3 = hash32(h2);
    float a = log_uniform(h2, 70), b = log_uniform(h3, 70);
    if (h2 & 1u) a = -a;
    if (h3 & 1u) b = -b;
    if ((h3 >> 8) % 64u == 0u) a = 0.0f;
    bool okq = true;
    const float fq = crk::FastOps::quot(a, b, okq);
    if (okq && b > 0.0f) {   // pivot divisors are positive
      c[3] += 1;
      c[2] += __float_as_uint(fq) != __float_as_uint(a / b);
    }
  }
  for (int i = 0; i < 4; ++i) atomicAdd(out + i, c[i]);
}

// f(integral_constant<int, G>) for G = 1, 2, 4, 8, as chainkern.cu launches.
template <typename F>
int by_group(int G, F&& f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

}  // namespace

extern "C" {

int fast_ops_check(long n, unsigned long long* out) {
  fast_ops_kernel<<<264, 256>>>(n, out);
  return (int)cudaDeviceSynchronize();
}


int old_k6(const float* M, const float* O, const float* R, float* Dinv,
           float* t2, float* tR, float* S, int T, int nC, long B,
           long long* out) {
  const long smem = (long)(3 * NB2 + 2 * NB * nC + nC * nC) * kLanes * 4;
  cudaError_t err = cudaFuncSetAttribute(
      old_k6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  old_k6_kernel<<<(int)((B + kLanes - 1) / kLanes), dim3(kLanes, kGroups),
                  smem>>>(M, O, R, Dinv, t2, tR, S, T, nC, B, out);
  return (int)cudaDeviceSynchronize();
}

int old_k8(const float* tR, const float* t2, const float* coef, float* x, int T,
           int nC, long B, long long* out) {
  old_k8_kernel<<<(int)((B + kLanes - 1) / kLanes), kLanes>>>(tR, t2, coef, x,
                                                              T, nC, B, out);
  return (int)cudaDeviceSynchronize();
}

int pass_k6(const float* M, const float* O, const float* R, float* Dinv,
            float* t2, float* tR, float* S, int T, int nC, long B, int G,
            int threads, long long* out) {
  const long smem = G * crk::chain_factor_floats(nC) * 4;
  return by_group(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    cudaError_t err = cudaFuncSetAttribute(
        pass_k6_kernel<kG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    pass_k6_kernel<kG><<<(int)((B + G - 1) / G), threads, smem>>>(
        M, O, R, Dinv, t2, tR, S, T, nC, B, out);
    return (int)cudaDeviceSynchronize();
  });
}

int pass_k6_apart(const float* M, const float* O, const float* R, float* Dinv,
                  float* t2, float* tR, float* S, int T, int nC, long B, int G,
                  int threads, long long* out) {
  const long smem = G * crk::chain_factor_floats(nC) * 4;
  return by_group(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    cudaError_t err = cudaFuncSetAttribute(
        pass_k6_apart_kernel<kG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    pass_k6_apart_kernel<kG><<<(int)((B + G - 1) / G), threads, smem>>>(
        M, O, R, Dinv, t2, tR, S, T, nC, B, out);
    return (int)cudaDeviceSynchronize();
  });
}

int old_k7(const float* Dinv, const float* O, const float* tRw, const float* r,
           float* tr, int T, int nB, long B, int shared, long long* out) {
  const long smem = (long)(nB + 2 * NB2 + NB * nB + 2 * NB) * kLanes * 4;
  auto run = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(int)((B + kLanes - 1) / kLanes), kLanes, smem>>>(
        Dinv, O, tRw, r, tr, T, nB, B, out);
    return (int)cudaGetLastError();
  };
  return shared ? run(old_k7_kernel<true>) : run(old_k7_kernel<false>);
}

int pass_k7(const float* Dinv, const float* O, const float* tRw,
            const float* r, float* tr, float* sb, int T, int nB, long B, int G,
            int threads, int apart, long long* out) {
  const int C = crk::rhs_forward_chunk(nB, G);
  const long smem = G * crk::rhs_forward_floats(nB, C) * 4;
  return by_group(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    auto run = [&](auto kernel) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<(int)((B + G - 1) / G), threads, smem>>>(
          Dinv, O, tRw, r, tr, sb, T, nB, B, C, out);
      return (int)cudaDeviceSynchronize();
    };
    return apart ? run(pass_k7_kernel<kG, true>) : run(pass_k7_kernel<kG, false>);
  });
}

int invert_loop(const float* A, int G, int n, long long* out, float* sink) {
  invert_kernel<<<1, 32>>>(A, G, n, out, sink);
  return (int)cudaDeviceSynchronize();
}

int pass_k8(const float* tR, const float* t2, const float* coef, float* x,
            int T, int nC, long B, int G, int threads, long long* out) {
  const long smem = G * crk::back_sub_floats(T) * 4;
  return by_group(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    cudaError_t err = cudaFuncSetAttribute(
        pass_k8_kernel<kG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    pass_k8_kernel<kG><<<(int)((B + G - 1) / G), threads, smem>>>(
        tR, t2, coef, x, T, nC, B, T, out);
    return (int)cudaDeviceSynchronize();
  });
}

int latency(const float* A, int n, long long* out, float* sink) {
  latency_kernel<<<1, 1>>>(A, 1.25f, n, out, sink);
  return (int)cudaDeviceSynchronize();
}

}  // extern "C"
