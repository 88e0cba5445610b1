// Collocation node-block kernel for Hopper (sm_90a): K9 node_blocks.
//
// It replaces no Pallas kernel: the JAX package, like the port off this
// path, takes these blocks by automatic differentiation (jax.hessian /
// jax.jacfwd there, torch.func here).  On the card the transforms cost
// about 3 k small kernels in every Newton step's kkt.blocks and again in
// every dual refinement; under a wind field affine in position the blocks
// have a closed form (nodekern_block.cuh), and this kernel writes all of
// them in one launch:
//   node_blocks    Hn (12, 12), A (8, 11), d (8) of every node
//   defect_blocks  A, d alone (the dual refinement's Jacobian)
// in float, and as node_blocks_f64 / defect_blocks_f64 in double (a
// float64 problem on the card takes the same path).  Under the gridded
// storm field (wind model 3 at order 2) node_blocks_grid and
// defect_blocks_grid (and their _f64) give the same blocks with the
// quadratic B-spline's W, grad W and their derivatives taken in closed form
// from the 27-node stencil inside the per-node routine; the grid is read
// from the device at every launch.
//
// What bounds it on an H100: the stores.  A node reads 11 + 1 + 8 floats
// and writes 240 (96 without Hn), against a few thousand floating-point
// operations in registers, so at 12928 nodes (128 lanes of ts = 100) the
// least time is about 4.0 us (1.65 us without Hn) of 3.35 TB/s HBM.  What
// the design does: one thread per node computes its blocks in registers and
// leaves them in shared memory (one warp's nodes per thread block in float,
// 16 in double; a row of out_floats + 1 numbers a node, so the threads'
// rows fall on distinct banks), then the block's threads copy each output's rows out in order:
// consecutive threads store consecutive addresses, and a block's rows are
// one contiguous run of Hn (and of A and d).
//
// Under the grid a node also reads its 27-node stencil of each component
// (81 float32 samples, from L1: the grid is a few KB) and does about 9.5 k
// operations against the affine routine's 6.4 k, over jets of 8 variables:
// still bound by the stores (about 4.0 us) but in practice by the latency
// of one thread's long dependent chain, since 12928 nodes fill only about
// 3 warps of an SM.  The grid keeps the affine launch shape (one node a
// thread, the same staging and copy-out) and the full 255 registers a
// thread that __launch_bounds__(32) leaves it: fewer threads a block or
// more a node would not add warps an SM at this node count.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() (0 on success).
#include <cuda_runtime.h>

#include "nodekern_block.cuh"

namespace {

// nodes (threads) per thread block: one warp's in float, half of one in
// double, so that a block's staged rows stay within 48 KB of shared memory
template <typename T>
constexpr int kNodes = 128 / (int)sizeof(T);

// Copy `width` numbers of each of the block's n staged rows (row stride ld,
// from column off) to dst, whose rows are contiguous.
template <typename T>
__device__ __forceinline__ void copy_rows(const T* s, int ld, int off,
                                          int width, int n, T* dst) {
#pragma unroll 4
  for (int e = threadIdx.x; e < n * width; e += kNodes<T>) {
    const int row = e / width;
    dst[e] = s[row * ld + off + (e - row * width)];
  }
}

// One node per thread (nk::node_at: node g of B * npl), staged in shared
// memory; then the block's rows of Hn (H only), A and d are copied out.
template <typename T, bool H, typename Fld>
__device__ __forceinline__ void blocks(const T* __restrict__ Z, long ldz,
                                       const T* __restrict__ dt, long lddt,
                                       const T* __restrict__ Y, long ldy,
                                       const T* __restrict__ par,
                                       const Fld& F, long B, int npl,
                                       int Tn, T* __restrict__ Hn,
                                       T* __restrict__ A, T* __restrict__ d) {
  constexpr int NN = kNodes<T>;
  constexpr int NO = nk::out_floats(H);
  constexpr int LD = NO + 1;
  __shared__ T s[NN * LD];
  __shared__ T p[nk::PAR_FLOATS];
  for (int e = threadIdx.x; e < nk::PAR_FLOATS; e += NN) p[e] = par[e];
  __syncthreads();

  const long N = B * npl;
  const long g0 = (long)blockIdx.x * NN;
  const long g = g0 + threadIdx.x;
  if (g < N)
    nk::node_at<T, H>(g, Z, ldz, dt, lddt, Y, ldy, npl, Tn, p, F,
                      s + threadIdx.x * LD);
  __syncthreads();

  const int n = (int)min((long)NN, N - g0);
  int off = 0;
  if constexpr (H) {
    copy_rows(s, LD, off, nk::H_FLOATS, n, Hn + g0 * nk::H_FLOATS);
    off += nk::H_FLOATS;
  }
  copy_rows(s, LD, off, nk::A_FLOATS, n, A + g0 * nk::A_FLOATS);
  copy_rows(s, LD, off + nk::A_FLOATS, nk::D_FLOATS, n, d + g0 * nk::D_FLOATS);
}

// Fld: nk::Field<T> (affine wind) or nk::Grid<T> (the gridded field)
template <typename T, typename Fld>
__global__ void __launch_bounds__(kNodes<T>)
    node_blocks_kernel(const T* __restrict__ Z, long ldz,
                       const T* __restrict__ dt, long lddt,
                       const T* __restrict__ Y, long ldy,
                       const T* __restrict__ par, Fld F, long B,
                       int npl, int Tn, T* __restrict__ Hn, T* __restrict__ A,
                       T* __restrict__ d) {
  blocks<T, true>(Z, ldz, dt, lddt, Y, ldy, par, F, B, npl, Tn, Hn, A, d);
}

template <typename T, typename Fld>
__global__ void __launch_bounds__(kNodes<T>)
    defect_blocks_kernel(const T* __restrict__ Z, long ldz,
                         const T* __restrict__ dt, long lddt,
                         const T* __restrict__ par, Fld F, long B,
                         int Tn, T* __restrict__ A, T* __restrict__ d) {
  blocks<T, false>(Z, ldz, dt, lddt, nullptr, 0, par, F, B, Tn, Tn, nullptr,
                   A, d);
}

int grid(long N, int nodes) { return (int)((N + nodes - 1) / nodes); }

template <typename T, typename Fld>
int launch_node(const T* Z, long ldz, const T* dt, long lddt, const T* Y,
                long ldy, const T* par, const Fld& F, long B, int npl,
                int Tn, T* Hn, T* A, T* d, void* stream) {
  if (B * npl <= 0) return (int)cudaSuccess;
  node_blocks_kernel<T, Fld><<<grid(B * npl, kNodes<T>), kNodes<T>, 0,
                               (cudaStream_t)stream>>>(
      Z, ldz, dt, lddt, Y, ldy, par, F, B, npl, Tn, Hn, A, d);
  return (int)cudaGetLastError();
}

template <typename T, typename Fld>
int launch_defect(const T* Z, long ldz, const T* dt, long lddt, const T* par,
                  const Fld& F, long B, int Tn, T* A, T* d, void* stream) {
  if (B * Tn <= 0) return (int)cudaSuccess;
  defect_blocks_kernel<T, Fld><<<grid(B * Tn, kNodes<T>), kNodes<T>, 0,
                                 (cudaStream_t)stream>>>(
      Z, ldz, dt, lddt, par, F, B, Tn, A, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Hn (B * npl, 12, 12), A (B * npl, 8, 11), d (B * npl, 8) of the first npl
// nodes of each of B lanes (npl = T + 1: every node, the last with y = 0).
// par: nk::PAR_FLOATS device numbers; field: rho, grav, W0 (3), G (9) as
// host doubles.  node_blocks_f64 is the same in double.
int node_blocks(const float* Z, long ldz, const float* dt, long lddt,
                const float* Y, long ldy, const float* par,
                const double* field, long B, int npl, int T, float* Hn,
                float* A, float* d, void* stream) {
  return launch_node(Z, ldz, dt, lddt, Y, ldy, par,
                     nk::make_field<float>(field), B, npl, T, Hn, A, d,
                     stream);
}

int node_blocks_f64(const double* Z, long ldz, const double* dt, long lddt,
                    const double* Y, long ldy, const double* par,
                    const double* field, long B, int npl, int T, double* Hn,
                    double* A, double* d, void* stream) {
  return launch_node(Z, ldz, dt, lddt, Y, ldy, par,
                     nk::make_field<double>(field), B, npl, T, Hn, A, d,
                     stream);
}

// A (B * T, 8, 11), d (B * T, 8) of the first T nodes of each lane;
// defect_blocks_f64 the same in double.
int defect_blocks(const float* Z, long ldz, const float* dt, long lddt,
                  const float* par, const double* field, long B, int T,
                  float* A, float* d, void* stream) {
  return launch_defect(Z, ldz, dt, lddt, par, nk::make_field<float>(field), B,
                       T, A, d, stream);
}

int defect_blocks_f64(const double* Z, long ldz, const double* dt, long lddt,
                      const double* par, const double* field, long B, int T,
                      double* A, double* d, void* stream) {
  return launch_defect(Z, ldz, dt, lddt, par, nk::make_field<double>(field),
                       B, T, A, d, stream);
}

// The same under the gridded field: consts = rho, grav, east0, north0, up0
// as host doubles; u, v, w the float32 samples (nx, ny, nz) on the device,
// origin and spacing (3) in the entry point's type, live (3) float32.
int node_blocks_grid(const float* Z, long ldz, const float* dt, long lddt,
                     const float* Y, long ldy, const float* par,
                     const double* consts, const float* u, const float* v,
                     const float* w, const float* origin,
                     const float* spacing, const float* live, int nx, int ny,
                     int nz, long B, int npl, int T, float* Hn, float* A,
                     float* d, void* stream) {
  return launch_node(Z, ldz, dt, lddt, Y, ldy, par,
                     nk::make_grid<float>(consts, u, v, w, origin, spacing,
                                          live, nx, ny, nz),
                     B, npl, T, Hn, A, d, stream);
}

int node_blocks_grid_f64(const double* Z, long ldz, const double* dt,
                         long lddt, const double* Y, long ldy,
                         const double* par, const double* consts,
                         const float* u, const float* v, const float* w,
                         const double* origin, const double* spacing,
                         const float* live, int nx, int ny, int nz, long B,
                         int npl, int T, double* Hn, double* A, double* d,
                         void* stream) {
  return launch_node(Z, ldz, dt, lddt, Y, ldy, par,
                     nk::make_grid<double>(consts, u, v, w, origin, spacing,
                                           live, nx, ny, nz),
                     B, npl, T, Hn, A, d, stream);
}

int defect_blocks_grid(const float* Z, long ldz, const float* dt, long lddt,
                       const float* par, const double* consts,
                       const float* u, const float* v, const float* w,
                       const float* origin, const float* spacing,
                       const float* live, int nx, int ny, int nz, long B,
                       int T, float* A, float* d, void* stream) {
  return launch_defect(Z, ldz, dt, lddt, par,
                       nk::make_grid<float>(consts, u, v, w, origin, spacing,
                                            live, nx, ny, nz),
                       B, T, A, d, stream);
}

int defect_blocks_grid_f64(const double* Z, long ldz, const double* dt,
                           long lddt, const double* par, const double* consts,
                           const float* u, const float* v, const float* w,
                           const double* origin, const double* spacing,
                           const float* live, int nx, int ny, int nz, long B,
                           int T, double* A, double* d, void* stream) {
  return launch_defect(Z, ldz, dt, lddt, par,
                       nk::make_grid<double>(consts, u, v, w, origin, spacing,
                                             live, nx, ny, nz),
                       B, T, A, d, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
