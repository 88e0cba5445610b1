// Sequential-chain kernels for Hopper (sm_90a): K6-K8.
//
// They replace the Pallas TPU kernels of tol_tpu/ops/chainkern.py:
//   K6 chain_factor       <- chainkern.py:_factor_kernel
//   K7 chain_rhs_forward  <- chainkern.py:_rhs_forward_kernel
//   K8 chain_back_sub     <- chainkern.py:_bwd_kernel
// Operands are batch-last, (T, a, b, B), as in Pallas: neighbouring lanes
// are neighbouring addresses, so a warp of 32 lanes reads 32 consecutive
// floats of every operand entry.
//
// Pallas runs grid=(T,) in order and carries dcorr / rcorr / s_acc in VMEM
// scratch from one grid step to the next.  CUDA blocks run in no order, so
// here the loop over the T chain blocks is inside the kernel and the
// carries live in the thread block.
//
// What bounds them on an H100: neither bytes nor operations but the chain
// itself — T dependent steps per lane, each an 11x11 Cholesky inverse (K6)
// or two dependent 11x11 products (K7, K8), with only B lanes of
// parallelism (128 lanes are four warps' worth).  Bytes are the larger of
// the two roofline terms (every operand is read once and every result
// written once) but stay far below the time the dependent steps take.
//
// K6 design: a thread block owns 32 lanes (threadIdx.x) and kGroups warps
// (threadIdx.y) share each lane's step by columns.  The carries need
// 121 + 11 nC + nC^2 floats per lane (471 at nC = 14) beside the inverse,
// more than one thread's registers hold, so they sit in shared memory as
// [entry][lane] (conflict-free).  Per chain block: one warp factors
// D~ = M_i - dcorr (Cholesky, the sequential part) while the others form
// R~ = R_i - rcorr; the 11 columns of D~^-1 are solved by 11 warps; then
// the 11 + nC columns of [O_i | R~] each get their product with D~^-1,
// their share of s_acc and their column of the next carries.  Three
// barriers per chain block.  nC is a run-time width (12 for S10, 14 for
// G7).
//
// K7, K8 design: one thread per lane, 32 lanes per thread block; the
// 11-vector carry is in registers, K7's border accumulator (nB run-time
// entries) in shared memory.
//
// Each entry point launches on the given stream, allocates nothing and
// returns the CUDA error of the launch (0 on success).
#include <cuda_runtime.h>

#include "chainkern_block.cuh"

namespace {

constexpr int kLanes = 32;    // lanes per thread block (one warp wide)
constexpr int kGroups = 13;   // K6: warps per thread block; 11 + nC columns
                              // in two rounds for nC <= 15
constexpr int NB = crk::NB;
constexpr int NB2 = NB * NB;

__global__ void __launch_bounds__(kLanes * kGroups)
chain_factor_kernel(const float* __restrict__ M, const float* __restrict__ O,
                    const float* __restrict__ R, float* __restrict__ Dinv,
                    float* __restrict__ t2, float* __restrict__ tR,
                    float* __restrict__ S, int T, int nC, long B) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x, g = threadIdx.y;
  const long b = (long)blockIdx.x * kLanes + lane;
  const bool live = b < B;
  // per-lane arrays, entry e of lane l at [e * kLanes + l]
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
  for (int i = 0; i < T; ++i) {
    const float* Mi = M + (long)i * NB2 * B + b;
    const float* Oi = O + (long)i * NB2 * B + b;
    const float* Ri = R + (long)i * NB * nC * B + b;
    if (live) {
      if (g == kGroups - 1) crk::chain_chol<float>(Mi, B, dcorr, kLanes, Lc, kLanes);
      for (int q = g; q < nC; q += kGroups)
        crk::chain_rt_column<float>(Ri, B, rcorr, kLanes, Rt, kLanes, nC, q);
    }
    __syncthreads();
    if (live) {
      for (int c = g; c < NB; c += kGroups)
        crk::chain_inverse_column<float>(Lc, kLanes, c, Dv, kLanes,
                                         Dinv + (long)i * NB2 * B + b, B);
    }
    __syncthreads();
    if (live) {
      for (int q = g; q < NB + nC; q += kGroups)
        crk::chain_factor_column<float>(
            Dv, kLanes, Oi, B, Rt, kLanes, t2 + (long)i * NB2 * B + b,
            tR + (long)i * NB * nC * B + b, B, dcorr, kLanes, rcorr, kLanes,
            s_acc, kLanes, nC, q);
    }
    __syncthreads();
  }
  if (live) {
    for (int e = g; e < nC * nC; e += kGroups) S[(long)e * B + b] = s_acc[e * kLanes];
  }
}

__global__ void __launch_bounds__(kLanes)
chain_rhs_forward_kernel(const float* __restrict__ Dinv,
                         const float* __restrict__ O,
                         const float* __restrict__ tRw,
                         const float* __restrict__ r, float* __restrict__ tr,
                         float* __restrict__ sb, int T, int nB, long B) {
  extern __shared__ float sm[];
  const long b = (long)blockIdx.x * kLanes + threadIdx.x;
  if (b >= B) return;
  float* acc = sm + threadIdx.x;          // entry p at [p * kLanes]
  for (int p = 0; p < nB; ++p) acc[p * kLanes] = 0.0f;
  float rcorr[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) rcorr[k] = 0.0f;
  for (int i = 0; i < T; ++i) {
    crk::chain_rhs_forward_block<float>(
        Dinv + (long)i * NB2 * B + b, O + (long)i * NB2 * B + b,
        tRw + (long)i * NB * nB * B + b, r + (long)i * NB * B + b,
        tr + (long)i * NB * B + b, B, rcorr, acc, kLanes, nB);
  }
  for (int p = 0; p < nB; ++p) sb[(long)p * B + b] = acc[p * kLanes];
}

__global__ void __launch_bounds__(kLanes)
chain_back_sub_kernel(const float* __restrict__ tR, const float* __restrict__ t2,
                      const float* __restrict__ coef, float* __restrict__ x,
                      int T, int nC, long B) {
  const long b = (long)blockIdx.x * kLanes + threadIdx.x;
  if (b >= B) return;
  float xn[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) xn[k] = 0.0f;
  for (int i = T - 1; i >= 0; --i) {
    crk::chain_back_sub_block<float>(
        tR + (long)i * NB * nC * B + b, t2 + (long)i * NB2 * B + b, coef + b, B,
        x + (long)i * NB * B + b, B, xn, nC);
  }
}

inline int lane_blocks(long B) { return (int)((B + kLanes - 1) / kLanes); }

}  // namespace

extern "C" {

// Shared memory K6 needs for a border width nC, in bytes.
long chain_factor_smem_bytes(int nC) {
  return (long)(3 * NB2 + 2 * NB * nC + nC * nC) * kLanes * sizeof(float);
}

int chain_factor(const float* M, const float* O, const float* R, float* Dinv,
                 float* t2, float* tR, float* S, int T, int nC, long B,
                 void* stream) {
  const long smem = chain_factor_smem_bytes(nC);
  cudaError_t err = cudaFuncSetAttribute(
      chain_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  chain_factor_kernel<<<lane_blocks(B), dim3(kLanes, kGroups), smem,
                        (cudaStream_t)stream>>>(M, O, R, Dinv, t2, tR, S, T, nC, B);
  return (int)cudaGetLastError();
}

int chain_rhs_forward(const float* Dinv, const float* O, const float* tRw,
                      const float* r, float* tr, float* sb, int T, int nB,
                      long B, void* stream) {
  chain_rhs_forward_kernel<<<lane_blocks(B), kLanes,
                             (size_t)nB * kLanes * sizeof(float),
                             (cudaStream_t)stream>>>(Dinv, O, tRw, r, tr, sb, T,
                                                     nB, B);
  return (int)cudaGetLastError();
}

int chain_back_sub(const float* tR, const float* t2, const float* coef, float* x,
                   int T, int nC, long B, void* stream) {
  chain_back_sub_kernel<<<lane_blocks(B), kLanes, 0, (cudaStream_t)stream>>>(
      tR, t2, coef, x, T, nC, B);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
