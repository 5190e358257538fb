// Host-side launch helpers shared by the port's kernels.
#pragma once

#include <cuda.h>
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

// Launch `kernel` as thread-block clusters of `cluster` blocks along x
// (`grid` a multiple of it; 1 is an ordinary launch) with `smem` bytes of
// dynamic shared memory on `stream`. Returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), unsigned grid, unsigned block,
                           unsigned cluster, size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// A tensor map for TMA over a dense 2-D array of `rows` rows of `cols`
// elements of `type` (`elem_bytes` each; 16-byte aligned, rows a multiple of
// 16 bytes apart), cut into boxes of [box_rows, box_cols] that land dense in
// shared memory (mma.cuh::tma_load_2d), laid out by `swizzle`; what lies
// outside the array arrives as zeros. The encoder, cuTensorMapEncodeTiled,
// lives in libcuda: it is looked up at run time, so nothing links against
// that library.
inline cudaError_t encode_tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                                        unsigned elem_bytes, const void* data,
                                        unsigned long long cols, unsigned long long rows,
                                        unsigned box_cols, unsigned box_rows,
                                        CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(data), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The f32 form, boxes dense (`cols` a multiple of 4).
inline cudaError_t make_tensor_map_2d(CUtensorMap* map, const float* data,
                                      unsigned long long cols, unsigned long long rows,
                                      unsigned box_cols, unsigned box_rows) {
  return encode_tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, data, cols, rows,
                              box_cols, box_rows, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The bf16 form for wgmma's MN-major operands (mma.cuh::wgmma_desc_sw128_mn):
// boxes of 64 columns (128 bytes) by `box_rows` rows in the 128-byte
// swizzle, which needs the box to land at a multiple of 1024 bytes (`cols` a
// multiple of 8).
inline cudaError_t make_tensor_map_2d_bf16_sw128(CUtensorMap* map, const void* data,
                                                 unsigned long long cols,
                                                 unsigned long long rows, unsigned box_rows) {
  return encode_tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, data, cols, rows, 64,
                              box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}
