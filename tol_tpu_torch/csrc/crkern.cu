// Cyclic-reduction kernels for Hopper (sm_90a): K1-K3 and K5.
//
// They replace the Pallas TPU kernels of tol_tpu/ops/crkern.py:
//   K1 crp_factor_fwd_pass  <- crkern.py:_factor_fwd_kernel, all levels,
//                              then _root_kernel
//   K2 crp_fwd_pass         <- crkern.py:_fwd_kernel, all levels, then
//                              _root_solve_kernel
//   K3 crp_bwd_pass         <- crkern.py:_bwd_kernel, all levels
//   K5 crp_factor_pass      <- crkern.py:_factor_kernel, all levels, then
//                              _root_kernel (K1 without rhs)
// and inline the slab helpers those call (chainkern.py:_chol_slab,
// _spd_inverse_slab, _mm_slab, _mm_tn_slab; crkern.py:_mm_nt_slab) as the
// __host__ __device__ routines of crkern_block.cuh.
//
// All four are whole-pass kernels: one launch runs every CR level of a
// pass and the root step.  The Pallas kernels they replace run one grid per
// level, with the even/odd split, the one-block shifts and the interleave
// between levels done by XLA, and the root in kernels of its own; a lane's
// levels depend only on that lane, so here a __syncthreads() takes the
// place of the launch boundary and that plumbing is index arithmetic.  A
// factor + solve is two launches (K1, K3), a solve with a stored factor two
// (K2, K3), a factor alone one (K5: K1's pass with no rhs, m = 0).
//
// What bounds them on an H100: by the bytes a pass must move, memory
// (about 2 FLOP per byte against the ~20 at which the 67 TFLOP/s fp32 units
// would take over from the 3.35 TB/s HBM): level-0 inputs read once
// (K1: M, O, F; K5: M, O; K2: the factor and f; K3: the factor, the saved
// rhs, the root solution) and outputs written once (K1: every level's Minv,
// OL, OR, Fo and the root's inverse and solution; K5: the same without Fo
// and solution; K2: the saved rhs and the root solution; K3: the
// solution).  What bounds them in fact is the layout of
// the factor: K2 and K3 read it as batch-last slabs (i, j, k*B + n), so
// with one lane per thread block (K1, K3) every slab entry is a lone 4-byte
// access, which costs an SM several cycles as a store and about a third of
// that as a load (PERF.md, findings on the whole-pass kernels).  What the
// design does:
//   - Levels >= 1 never touch device memory: K1 keeps each level's M, O, F
//     in shared memory, ping-ponging between a region of n_pad/2 and one of
//     n_pad/4 blocks, beside the level's pivot inverses (176 KB at n_pad =
//     128, m = 12; 184 KB at m = 14; K5 125 KB); K2 keeps f and t = Minv fo (7 KB a
//     lane at m = 1, 85 KB at m = 12); K3 keeps x and the residuals (118 KB
//     at m = 14).
//   - Work is spread over a block's threads by output entry, not by
//     (block, lane) column: a Cholesky column is one item per row (one
//     barrier per column), then one item per inverse column, per column of
//     S, Onext, Mhalf, and per rhs column of brF, Fe2 (K1); one item per
//     entry of t and of the next f (K2) and of the solution (K3).
//     Per-thread state is a few 11-vectors, not an 11x11 inverse in
//     registers.
//   - K2, which streams the whole factor (363 floats a block and lane) for
//     2 FLOP a float, runs crk::kFwdGroup = 2 lanes per thread block, lanes
//     the fastest index of a warp's items, so that a warp's read of one slab
//     entry covers neighbouring lanes.  What bounds it is latency, not
//     bytes: each of its 15 steps waits for one round of dependent loads and
//     a barrier (about 2k cycles at the narrow levels), and the wide levels
//     add the load pipe's time for lines that carry a few lanes each.  More
//     lanes per block (4, 8) or clusters of blocks sharing a lane group's
//     items took longer or saved at most 15% (PERF.md, findings on the
//     forward pass).
//   - K1 hides what it can of its slab stores behind latency-bound steps
//     (crkern_block.cuh) and reads level 0 batch-first (B, n_pad, 11, .),
//     which coalesces and drops _to_slab (a batch-last read of level 0 took
//     38% more device time; PERF.md).  K2 reads level 0 of f batch-first too.
//   - Contiguous operands (shared memory, batch-first input) of K1 and K3
//     have a stride of 1 fixed at compile time, so their addresses are
//     constant offsets.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() (0 on success).
#include <cuda_runtime.h>

#include "crkern_block.cuh"
#include "launch.cuh"

namespace {

// one thread block per lane (K1, K3, K5) or lane group (K2)
constexpr int kPassThreads = 512;

// K1: thread block n runs the factor pass of lane n, from the batch-first
// level 0 M, O (B, n_pad, 11, 11) and F (B, n_pad, 11, m).
__global__ void __launch_bounds__(kPassThreads, 1)
factor_fwd_pass_kernel(const float* __restrict__ M, const float* __restrict__ O,
                       const float* __restrict__ F,
                       const crk::LevelPtrs<float*> out, float* __restrict__ Rinv,
                       float* __restrict__ X, long B, int n_pad, int m) {
  extern __shared__ float smem[];
  const long n = blockIdx.x;
  crk::factor_fwd_pass(crk::BlockTeam{},
                       crk::lanes_first_view(M, crk::NB, n, n_pad),
                       crk::lanes_first_view(O, crk::NB, n, n_pad),
                       crk::lanes_first_view(F, m, n, n_pad), out, Rinv, X, B,
                       n, n_pad, m, smem);
}

// K5: thread block n runs the factor pass of lane n with no rhs (m = 0):
// every level's Minv, OL, OR and the root's inverse.
__global__ void __launch_bounds__(kPassThreads, 1)
factor_pass_kernel(const float* __restrict__ M, const float* __restrict__ O,
                   const crk::LevelPtrs<float*> out, float* __restrict__ Rinv,
                   long B, int n_pad) {
  extern __shared__ float smem[];
  const long n = blockIdx.x;
  crk::factor_fwd_pass<float>(crk::BlockTeam{},
                              crk::lanes_first_view(M, crk::NB, n, n_pad),
                              crk::lanes_first_view(O, crk::NB, n, n_pad),
                              crk::Unit<const float>{nullptr, 1, 0}, out, Rinv,
                              nullptr, B, n, n_pad, 0, smem);
}

// K2: thread block b runs the forward pass of lanes b*G .. b*G + G - 1.
__global__ void __launch_bounds__(kPassThreads, 1)
fwd_pass_kernel(const crk::LevelPtrs<const float*> lv,
                const float* __restrict__ Rinv, const float* __restrict__ f,
                const crk::LevelPtrs<float*> out, float* __restrict__ x, long B,
                int G, int n_pad, int m) {
  extern __shared__ float smem[];
  crk::fwd_pass(crk::BlockTeam{}, lv, Rinv, f, out, x, B, (long)blockIdx.x * G,
                G, n_pad, m, smem);
}

// K3: thread block n back-substitutes lane n into X (B, n_pad, 11, m).
__global__ void __launch_bounds__(kPassThreads, 1)
bwd_pass_kernel(const crk::LevelPtrs<const float*> lv,
                const float* __restrict__ x0, float* __restrict__ X, long B,
                int n_pad, int m) {
  extern __shared__ float smem[];
  const long n = blockIdx.x;
  crk::bwd_pass<float>(crk::BlockTeam{}, lv, {x0 + n, B, 0},
                       X + n * n_pad * crk::NB * m, B, n, n_pad, m, smem);
}

using crk::allow_smem;
using crk::kMaxDevices;

long factor_fwd_pass_smem[kMaxDevices] = {};
long factor_pass_smem[kMaxDevices] = {};
long fwd_pass_smem[kMaxDevices] = {};
long bwd_pass_smem[kMaxDevices] = {};

// Per-level slab pointers; a null array leaves its field null.
template <typename P>
crk::LevelPtrs<P> level_ptrs(P const* minv, P const* ol, P const* orr,
                             P const* fo, int n_levels) {
  crk::LevelPtrs<P> lv{};
  for (int l = 0; l < n_levels; ++l) {
    if (minv) lv.minv[l] = minv[l];
    if (ol) lv.ol[l] = ol[l];
    if (orr) lv.orr[l] = orr[l];
    if (fo) lv.fo[l] = fo[l];
  }
  return lv;
}

}  // namespace

extern "C" {

// K1 over B lanes of an n_pad-block chain (n_pad a power of two, at most
// 2^kMaxLevels), level 0 batch-first.  minv, ol, orr, fo: per level l, the
// (11, w, h_l * B) slabs to fill, h_l = n_pad >> (l + 1); Rinv (11, 11, B)
// and X (11, m, B) the root's inverse and solution.
int crp_factor_fwd_pass(const float* M, const float* O, const float* F,
                        float* const* minv, float* const* ol, float* const* orr,
                        float* const* fo, float* Rinv, float* X, long B,
                        int n_pad, int m, void* stream) {
  const long smem = crk::factor_fwd_pass_floats(n_pad, m) * (long)sizeof(float);
  cudaError_t err =
      allow_smem(factor_fwd_pass_kernel, smem, factor_fwd_pass_smem);
  if (err != cudaSuccess) return (int)err;
  factor_fwd_pass_kernel<<<(int)B, kPassThreads, smem, (cudaStream_t)stream>>>(
      M, O, F, level_ptrs(minv, ol, orr, fo, crk::log2_exact(n_pad)), Rinv, X,
      B, n_pad, m);
  return (int)cudaGetLastError();
}

// K5 over B lanes: K1 with no rhs; the slabs minv, ol, orr as K1's, Rinv
// (11, 11, B) the root's inverse.
int crp_factor_pass(const float* M, const float* O, float* const* minv,
                    float* const* ol, float* const* orr, float* Rinv, long B,
                    int n_pad, void* stream) {
  const long smem = crk::factor_fwd_pass_floats(n_pad, 0) * (long)sizeof(float);
  cudaError_t err = allow_smem(factor_pass_kernel, smem, factor_pass_smem);
  if (err != cudaSuccess) return (int)err;
  factor_pass_kernel<<<(int)B, kPassThreads, smem, (cudaStream_t)stream>>>(
      M, O,
      level_ptrs(minv, ol, orr, (float* const*)nullptr, crk::log2_exact(n_pad)),
      Rinv, B, n_pad);
  return (int)cudaGetLastError();
}

// K2 over B lanes: the factor's per-level slabs (minv, ol, orr) and root
// inverse Rinv (11, 11, B), the batch-first rhs f (B, n_pad, 11, m) -> per
// level the slab fo (11, m, h_l * B) of the blocks the solve saves, and the
// root solution x (11, m, B).
int crp_fwd_pass(const float* const* minv, const float* const* ol,
                 const float* const* orr, const float* Rinv, const float* f,
                 float* const* fo, float* x, long B, int n_pad, int m,
                 void* stream) {
  const int G = crk::fwd_pass_group(n_pad, m);
  const long smem = G * crk::fwd_pass_floats(n_pad, m) * (long)sizeof(float);
  cudaError_t err = allow_smem(fwd_pass_kernel, smem, fwd_pass_smem);
  if (err != cudaSuccess) return (int)err;
  const int n_levels = crk::log2_exact(n_pad);
  fwd_pass_kernel<<<(int)((B + G - 1) / G), kPassThreads, smem,
                    (cudaStream_t)stream>>>(
      level_ptrs(minv, ol, orr, (const float* const*)nullptr, n_levels), Rinv,
      f,
      level_ptrs((float* const*)nullptr, (float* const*)nullptr,
                 (float* const*)nullptr, fo, n_levels),
      x, B, G, n_pad, m);
  return (int)cudaGetLastError();
}

// K3 over B lanes: the factor's per-level slabs, the root solution x0
// (11, m, B) -> X (B, n_pad, 11, m).
int crp_bwd_pass(const float* const* minv, const float* const* ol,
                 const float* const* orr, const float* const* fo,
                 const float* x0, float* X, long B, int n_pad, int m,
                 void* stream) {
  const long smem = crk::bwd_pass_floats(n_pad, m) * (long)sizeof(float);
  cudaError_t err = allow_smem(bwd_pass_kernel, smem, bwd_pass_smem);
  if (err != cudaSuccess) return (int)err;
  bwd_pass_kernel<<<(int)B, kPassThreads, smem, (cudaStream_t)stream>>>(
      level_ptrs(minv, ol, orr, fo, crk::log2_exact(n_pad)), x0, X, B, n_pad,
      m);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
