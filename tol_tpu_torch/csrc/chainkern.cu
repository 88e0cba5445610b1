// Sequential-chain kernels for Hopper (sm_90a): K6-K8.
//
// They replace the Pallas TPU kernels of tol_tpu/ops/chainkern.py:
//   K6 chain_factor       <- chainkern.py:_factor_kernel
//   K7 chain_rhs_forward  <- chainkern.py:_rhs_forward_kernel
//   K8 chain_back_sub     <- chainkern.py:_bwd_kernel
// Operands are batch-last, (T, a, b, B), as in Pallas: neighbouring lanes
// are neighbouring addresses, so the lanes of a thread block read
// neighbouring floats of every operand entry.
//
// Pallas runs grid=(T,) in order and carries dcorr / rcorr / s_acc in VMEM
// scratch from one grid step to the next.  CUDA blocks run in no order, so
// here the loop over the T chain blocks is inside the kernel and the
// carries live in the thread block.
//
// What bounds them on an H100: neither bytes nor operations but the chain
// itself — T dependent steps per lane, each an 11x11 Cholesky inverse (K6)
// or two dependent 11x11 products (K7, K8), with only B lanes of
// parallelism.  Bytes are the larger of the two roofline terms (every
// operand is read once and every result written once) but stay far below
// the time the dependent steps take.  So the designs keep every load and
// every barrier they can off the chain's critical path.
//
// K6 design (crk::chain_factor_pass): a thread block runs G lanes (a power
// of two, lanes the fastest index of its items), so B lanes spread over
// B / G SMs.  Per chain step three barrier steps.  P1 inverts D~: each of a
// lane's 11 Cholesky threads factors the block itself in registers and
// solves one column of the inverse, with the correctly rounded square roots
// and quotients as the library's fast-path instruction sequences and no
// branch (crk::FastOps; out of their range the warp redoes it with the
// library routines).  Meanwhile the other warps do all that is off the
// chain: the previous step's share of s_acc, this step's R~, the stores of
// Dinv and t2, and the copies (cp.async) of step i + 2's M, O, R into a
// four-step ring of shared memory.  P2 forms t2 = Dinv O, P3 the next D~
// and tR, one thread per entry.  So the chain reads nothing from device
// memory and waits on no store.  The ring, the carries and the scratch take
// 10 KB a lane at nC = 14.
//
// K7 design (crk::rhs_forward_pass): G lanes per thread block, the steps
// in chunks of C.  Per step the chain is two dependent 11-term sums: row k
// of lane g's Dinv r~ on thread 16 g + k, then row k of O^T tr, r~ and tr
// passed from row to row through shared memory under a warp barrier, with
// no block barrier and no device load.  Per chunk one block barrier:
// meanwhile the other warps copy (cp.async) chunk c + 2's Dinv, O, r and
// tRw into a four-chunk ring, lane by lane, with each row padded to 16
// bytes (O transposed), add chunk c - 1's border terms tRw^T r~ to sb (one
// thread per border entry, lagging the chain) and write chunk c - 1's tr
// out.  Shared memory takes 53.9 KB a lane at C = 8, nB = 12.  What bounds
// it is that staging: every batch-last float is a 32-byte sector of its
// own at G = 1 (385 a lane and step), and the copies share the load/store
// unit with the chain, which runs 2.4 times slower beside them (PERF.md).
//
// K8 design (crk::back_sub_pass): G lanes per thread block.  The part of
// each step that does not depend on the chain, a_i = tR_i coef, is computed
// for every step at once while the lane group's t2 is staged into shared
// memory by cp.async (53 KB a lane at T = 100; longer chains go in chunks);
// then one thread per row of x walks the T steps, the 11 threads of a lane
// in one warp, x_{i+1} passed by shuffles: no barrier and no device load
// per step.
//
// nC is a run-time width (K6: 12 for S10, 14 for G7; K8: one more).  Each
// entry point launches on the given stream, allocates nothing and returns
// the CUDA error of the launch (0 on success).
#include <cuda_runtime.h>

#include <type_traits>

#include "chainkern_block.cuh"
#include "launch.cuh"

namespace {

// Most threads a block may have: K6 keeps its Cholesky factor in registers
// (up to 255 a thread with 256 threads), K7 and K8 need fewer.
constexpr int kFactorThreads = 256;
constexpr int kRhsThreads = 512;
constexpr int kBackSubThreads = 512;
constexpr int NB = crk::NB;
constexpr int NB2 = NB * NB;

// K6: thread block b runs the chains of lanes b*G .. b*G + G - 1.  G is a
// template constant, so shared-memory offsets are immediates.
template <int G>
__global__ void __launch_bounds__(kFactorThreads, 1)
chain_factor_kernel(const float* __restrict__ M, const float* __restrict__ O,
                    const float* __restrict__ R, float* __restrict__ Dinv,
                    float* __restrict__ t2, float* __restrict__ tR,
                    float* __restrict__ S, int T, int nC, long B) {
  extern __shared__ float sm[];
  crk::chain_factor_pass<float>(crk::BlockChainTeam{}, M, O, R, Dinv, t2, tR,
                                S, T, nC, B, (long)blockIdx.x * G, G, sm);
}

// K7: thread block b runs the forward pass of lanes b*G .. b*G + G - 1, C
// steps a chunk.
template <int G>
__global__ void __launch_bounds__(kRhsThreads, 1)
chain_rhs_forward_kernel(const float* __restrict__ Dinv,
                         const float* __restrict__ O,
                         const float* __restrict__ tRw,
                         const float* __restrict__ r, float* __restrict__ tr,
                         float* __restrict__ sb, int T, int nB, long B, int C) {
  extern __shared__ float sm[];
  crk::rhs_forward_pass<float>(crk::BlockChainTeam{}, Dinv, O, tRw, r, tr, sb,
                               T, nB, B, (long)blockIdx.x * G, G, C, sm);
}

// K8: thread block b back-substitutes lanes b*G .. b*G + G - 1, Tc steps a
// chunk.
template <int G>
__global__ void __launch_bounds__(kBackSubThreads, 1)
chain_back_sub_kernel(const float* __restrict__ tR, const float* __restrict__ t2,
                      const float* __restrict__ coef, float* __restrict__ x,
                      int T, int nC, long B, int Tc) {
  extern __shared__ float sm[];
  crk::back_sub_pass<float>(crk::BlockChainTeam{}, tR, t2, coef, x, T, nC, B,
                            (long)blockIdx.x * G, G, Tc, sm);
}

inline bool lane_group_ok(int G) { return G >= 1 && G <= 8 && !(G & (G - 1)); }

// K6-K8 may ask for any dynamic shared memory up to what a block can
// have: the limit is raised to that once per device and lane group size.
long chain_factor_smem[4][crk::kMaxDevices] = {};
long rhs_forward_smem[4][crk::kMaxDevices] = {};
long back_sub_smem[4][crk::kMaxDevices] = {};

// The entry (0-3) of lane group size G (1, 2, 4, 8) in the tables above,
// and a launch of the kernel instance of G.
inline int group_index(int G) { return G == 1 ? 0 : G == 2 ? 1 : G == 4 ? 2 : 3; }

template <typename Launch>
cudaError_t launch_group(int G, Launch&& launch) {
  switch (G) {
    case 1: return launch(std::integral_constant<int, 1>{});
    case 2: return launch(std::integral_constant<int, 2>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    default: return launch(std::integral_constant<int, 8>{});
  }
}

}  // namespace

extern "C" {

// K6 over B lanes, G lanes (1, 2, 4 or 8) per thread block of `threads`
// threads (a multiple of 32, at most 256, more than the warps of the G
// lanes' Cholesky threads: 16 G rounded up to a warp).
int chain_factor(const float* M, const float* O, const float* R, float* Dinv,
                 float* t2, float* tR, float* S, int T, int nC, long B, int G,
                 int threads, void* stream) {
  const long smem = G * crk::chain_factor_floats(nC) * (long)sizeof(float);
  if (!lane_group_ok(G) || threads % 32 || threads > kFactorThreads ||
      threads <= crk::chain_threads(G) || T < 1 || nC < 1 || B < 1 ||
      smem > crk::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  return (int)launch_group(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    cudaError_t err = crk::allow_smem(chain_factor_kernel<kG>,
                                      crk::kMaxSmemBytes,
                                      chain_factor_smem[group_index(kG)]);
    if (err != cudaSuccess) return err;
    chain_factor_kernel<kG><<<(int)((B + kG - 1) / kG), threads, smem,
                              (cudaStream_t)stream>>>(M, O, R, Dinv, t2, tR, S,
                                                      T, nC, B);
    return cudaGetLastError();
  });
}

// K7 over B lanes, G lanes (1, 2, 4 or 8) per thread block of `threads`
// threads (a multiple of 32, at most 512, more than the warps of the G
// lanes' row threads).
int chain_rhs_forward(const float* Dinv, const float* O, const float* tRw,
                      const float* r, float* tr, float* sb, int T, int nB,
                      long B, int G, int threads, void* stream) {
  const int C = lane_group_ok(G) ? crk::rhs_forward_chunk(nB, G) : 0;
  if (C < 1 || threads % 32 || threads > kRhsThreads ||
      threads <= crk::chain_threads(G) || T < 1 || nB < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const long smem = G * crk::rhs_forward_floats(nB, C) * (long)sizeof(float);
  return (int)launch_group(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    cudaError_t err = crk::allow_smem(chain_rhs_forward_kernel<kG>,
                                      crk::kMaxSmemBytes,
                                      rhs_forward_smem[group_index(kG)]);
    if (err != cudaSuccess) return err;
    chain_rhs_forward_kernel<kG><<<(int)((B + kG - 1) / kG), threads, smem,
                                   (cudaStream_t)stream>>>(
        Dinv, O, tRw, r, tr, sb, T, nB, B, C);
    return cudaGetLastError();
  });
}

// K8 over B lanes, G lanes (1, 2, 4 or 8) per thread block of `threads`
// threads (a multiple of 32, at most 512, at least 16 G rounded up to a
// warp); as many steps a chunk as shared memory holds.
int chain_back_sub(const float* tR, const float* t2, const float* coef, float* x,
                   int T, int nC, long B, int G, int threads, void* stream) {
  if (!lane_group_ok(G) || threads % 32 || threads > kBackSubThreads ||
      threads < crk::chain_threads(G) || T < 1 || nC < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const long fit = (crk::kMaxSmemBytes / (long)sizeof(float) / G - NB) /
                   (NB2 + NB);
  const int Tc = (int)(T < fit ? T : fit);
  const long smem = G * crk::back_sub_floats(Tc) * (long)sizeof(float);
  return (int)launch_group(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    cudaError_t err = crk::allow_smem(chain_back_sub_kernel<kG>,
                                      crk::kMaxSmemBytes,
                                      back_sub_smem[group_index(kG)]);
    if (err != cudaSuccess) return err;
    chain_back_sub_kernel<kG><<<(int)((B + kG - 1) / kG), threads, smem,
                                (cudaStream_t)stream>>>(tR, t2, coef, x, T, nC,
                                                        B, Tc);
    return cudaGetLastError();
  });
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
