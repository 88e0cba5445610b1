// Host-side launch helpers shared by crkern.cu and chainkern.cu.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace crk {

// Raise a kernel's dynamic shared-memory limit (48 KB by default) to
// `bytes`, once per device and size: `allowed` keeps the largest limit set
// so far on each device.  The attribute call fails for more than the card
// has.
constexpr int kMaxDevices = 64;
template <typename K>
cudaError_t allow_smem(K kernel, long bytes, long (&allowed)[kMaxDevices]) {
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < kMaxDevices && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

}  // namespace crk
