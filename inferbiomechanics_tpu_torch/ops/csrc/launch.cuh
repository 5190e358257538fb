// Host-side launch helper shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

// Raise `kernel`'s dynamic shared memory cap, a per-device setting, whenever
// a launch needs more than that device was given so far. The state is per
// `Tag` (one type for each kernel); the mutex keeps two host threads from
// lowering each other's cap.
template <typename Tag, typename Kernel>
cudaError_t ensure_dynamic_smem(Kernel kernel, size_t bytes) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static size_t cap[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  if (bytes > cap[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    cap[dev] = bytes;
  }
  return cudaSuccess;
}
