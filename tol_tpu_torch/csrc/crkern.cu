// Cyclic-reduction level kernels for Hopper (sm_90a): K1-K5.
//
// They replace the Pallas TPU kernels of tol_tpu/ops/crkern.py:
//   K5 crp_factor_level      <- crkern.py:_factor_kernel (K1 without rhs)
//   K1 crp_factor_fwd_level  <- crkern.py:_factor_fwd_kernel
//   K2 crp_fwd_level         <- crkern.py:_fwd_kernel
//   K3 crp_bwd_level         <- crkern.py:_bwd_kernel
//   K4 crp_root              <- crkern.py:_root_kernel + _root_solve_kernel
// and inline the slab helpers those call (chainkern.py:_chol_slab,
// _spd_inverse_slab, _mm_slab, _mm_tn_slab; crkern.py:_mm_nt_slab) as the
// __host__ __device__ routines of crkern_block.cuh.
//
// What bounds them on an H100: bytes.  K1 moves 1,441 floats per
// (block, lane) column at m = 12 (reads of Mo's lower triangle, Me, OL, OR,
// Fo, Fe and writes of Minv, Mhalf, Onext, S, Fe2, brF) against ~12 kFLOP
// of fp32 arithmetic: ~2 FLOP per byte, far below the ~20 FLOP per byte at which
// the card's fp32 units (67 TFLOP/s) would take over from its memory
// (3.35 TB/s).  K2-K4 are lighter still; K5 moves 913 floats per column
// for K1's factor arithmetic without the rhs part.
//
// Design: one thread per slab column (block k, lane n), in the batch-last
// slab layout (i, j, k*B + n) of the JAX package, so the 32 threads of a
// warp read 32 consecutive floats of every operand entry and each load
// coalesces into full 128-byte lines.  Every input is read from device
// memory once and every output written once; the 11x11 pivot inverse
// lives in registers (what does not fit spills to thread-local memory,
// which ptxas reports at build time).  Nothing is staged in shared memory
// and nothing is synchronised.  Known limits, left to later work: the
// narrow last levels (1-4 blocks x B lanes) leave most SMs idle, and one
// launch per level per pass pays launch latency 7 times per solve.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() (0 on success).
#include <cuda_runtime.h>

#include "crkern_block.cuh"

namespace {

constexpr int kThreads = 128;

inline int blocks_for(long L) { return (int)((L + kThreads - 1) / kThreads); }

__global__ void __launch_bounds__(kThreads)
factor_fwd_level_kernel(const float* __restrict__ Mo, const float* __restrict__ Me,
                        const float* __restrict__ OL, const float* __restrict__ OR,
                        const float* __restrict__ Fo, const float* __restrict__ Fe,
                        float* __restrict__ Minv, float* __restrict__ Mhalf,
                        float* __restrict__ Onext, float* __restrict__ S,
                        float* __restrict__ Fe2, float* __restrict__ brF,
                        long L, int m) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= L) return;
  crk::factor_fwd_column<float>(Mo + c, Me + c, OL + c, OR + c, Fo + c, Fe + c,
                                Minv + c, Mhalf + c, Onext + c, S + c, Fe2 + c,
                                brF + c, L, m);
}

__global__ void __launch_bounds__(kThreads)
factor_level_kernel(const float* __restrict__ Mo, const float* __restrict__ Me,
                    const float* __restrict__ OL, const float* __restrict__ OR,
                    float* __restrict__ Minv, float* __restrict__ Mhalf,
                    float* __restrict__ Onext, float* __restrict__ S, long L) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= L) return;
  float inv[crk::NB * crk::NB];
  crk::factor_column<float>(Mo + c, Me + c, OL + c, OR + c, Minv + c, Mhalf + c,
                            Onext + c, S + c, L, inv);
}

__global__ void __launch_bounds__(kThreads)
fwd_level_kernel(const float* __restrict__ Minv, const float* __restrict__ OL,
                 const float* __restrict__ OR, const float* __restrict__ fo,
                 const float* __restrict__ fe, float* __restrict__ fe2,
                 float* __restrict__ br, long L, int m) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= L) return;
  crk::fwd_column<float>(Minv + c, OL + c, OR + c, fo + c, fe + c, fe2 + c,
                         br + c, L, m);
}

__global__ void __launch_bounds__(kThreads)
bwd_level_kernel(const float* __restrict__ Minv, const float* __restrict__ OL,
                 const float* __restrict__ OR, const float* __restrict__ fo,
                 const float* __restrict__ xe, const float* __restrict__ xs,
                 float* __restrict__ xo, long L, int m) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= L) return;
  crk::bwd_column<float>(Minv + c, OL + c, OR + c, fo + c, xe + c, xs + c,
                         xo + c, L, m);
}

__global__ void __launch_bounds__(kThreads)
root_kernel(const float* __restrict__ A, const float* __restrict__ F,
            float* __restrict__ Rinv, float* __restrict__ X, long L, int m,
            int invert) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= L) return;
  crk::root_column<float>(A + c, F + c, invert ? Rinv + c : nullptr, X + c, L,
                          m, invert);
}

}  // namespace

extern "C" {

int crp_factor_fwd_level(const float* Mo, const float* Me, const float* OL,
                         const float* OR, const float* Fo, const float* Fe,
                         float* Minv, float* Mhalf, float* Onext, float* S,
                         float* Fe2, float* brF, long L, int m, void* stream) {
  factor_fwd_level_kernel<<<blocks_for(L), kThreads, 0, (cudaStream_t)stream>>>(
      Mo, Me, OL, OR, Fo, Fe, Minv, Mhalf, Onext, S, Fe2, brF, L, m);
  return (int)cudaGetLastError();
}

int crp_factor_level(const float* Mo, const float* Me, const float* OL,
                     const float* OR, float* Minv, float* Mhalf, float* Onext,
                     float* S, long L, void* stream) {
  factor_level_kernel<<<blocks_for(L), kThreads, 0, (cudaStream_t)stream>>>(
      Mo, Me, OL, OR, Minv, Mhalf, Onext, S, L);
  return (int)cudaGetLastError();
}

int crp_fwd_level(const float* Minv, const float* OL, const float* OR,
                  const float* fo, const float* fe, float* fe2, float* br,
                  long L, int m, void* stream) {
  fwd_level_kernel<<<blocks_for(L), kThreads, 0, (cudaStream_t)stream>>>(
      Minv, OL, OR, fo, fe, fe2, br, L, m);
  return (int)cudaGetLastError();
}

int crp_bwd_level(const float* Minv, const float* OL, const float* OR,
                  const float* fo, const float* xe, const float* xs, float* xo,
                  long L, int m, void* stream) {
  bwd_level_kernel<<<blocks_for(L), kThreads, 0, (cudaStream_t)stream>>>(
      Minv, OL, OR, fo, xe, xs, xo, L, m);
  return (int)cudaGetLastError();
}

int crp_root(const float* A, const float* F, float* Rinv, float* X, long L,
             int m, int invert, void* stream) {
  root_kernel<<<blocks_for(L), kThreads, 0, (cudaStream_t)stream>>>(
      A, F, Rinv, X, L, m, invert);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
