// A probe, not a kernel of the port: how fast a block pulls a region of
// device memory that lies in L2 (2.75 MB, about the weights one row tile of
// the encoder's backward multiplies by) into shared memory through a ring of
// tiles behind mbarriers, as the port's kernels do. Built and run by
// ../../stream_probe.py; prints one line a configuration.
//
// mode 0: thread 0 brings a tile in with one bulk copy; mode 1: lane 0 of
// each of `split` warps brings in a `split`-th of it; mode 2: every thread
// brings in 16 bytes at a time with cp.async, which arrive on the barrier.
// Every warp waits for a tile, reads a word of it and gives the slot back;
// the tile `depth` further on is asked for as soon as the slot is free.
// mode 3 has no barriers: every thread loads 16 bytes at a time into
// registers, two tiles ahead of the one it stores to shared memory, and the
// block meets at __syncthreads once a tile.
// Modes 4-6 test the ring itself. mode 4: as mode 0, but the copies come from
// lane 0 of a producer warp of its own that never consumes (the 17th warp;
// the shape of K1's and CUTLASS's TMA pipelines). mode 5: as mode 0, every
// wait a spin on test_wait alone (mma.cuh::mbar_wait falls back on
// try_wait, which may suspend the warp). mode 6: no consumer at all: thread 0
// asks for `depth` tiles at once and, as each lands, for the one `depth`
// further on, so that `depth` copies are always in flight.
#include <cuda_runtime.h>

#include <cstdio>
#include <vector>

#include "../mma.cuh"

constexpr int kThreads = 512;      // the consumers; mode 4 adds a producer warp
constexpr int kLaunch = kThreads + 32;
constexpr int kMaxDepth = 32;
constexpr int kMaxSmem = 232448;
constexpr long long kRegion = 2752512;

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// A wait that only ever tests (never try_wait), for mode 5.
__device__ __forceinline__ void mbar_spin(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__global__ void __launch_bounds__(kLaunch, 1)
stream(const unsigned char* src, int tile_bytes, int depth, int n_tiles, int mode, int split,
       long long* cycles, float* sink) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const unsigned sbase = smem_u32(smem);
  const unsigned full = sbase, empty = sbase + 8 * kMaxDepth;
  const unsigned slots = sbase + 1024;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto wait = [&](unsigned bar, unsigned parity) {
    if (mode == 5) {
      mbar_spin(bar, parity);
    } else {
      mbar_wait(bar, parity);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < depth; ++i) {
      mbar_init(full + 8 * i, mode == 2 ? kThreads : (mode == 1 ? split : 1));
      mbar_init(empty + 8 * i, kThreads / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  auto fetch = [&](int j) {
    const int slot = j % depth;
    const unsigned phase = (j / depth) & 1;
    const long long off = (static_cast<long long>(j) * tile_bytes) % kRegion;
    if (mode == 2) {
      if (lane == 0) wait(empty + 8 * slot, phase ^ 1);
      __syncwarp();
      for (int c = threadIdx.x * 16; c < tile_bytes; c += kThreads * 16) {
        cp_async16(slots + slot * tile_bytes + c, src + off + c);
      }
      cp_async_arrive(full + 8 * slot);
    } else if (lane == 0 && (mode == 4 ? warp == kThreads / 32 : warp < (mode == 1 ? split : 1))) {
      const int part = tile_bytes / (mode == 1 ? split : 1);
      const int at = (mode == 1 ? warp : 0) * part;
      wait(empty + 8 * slot, phase ^ 1);
      mbar_arrive_expect_tx(full + 8 * slot, part);
      bulk_copy_g2s(slots + slot * tile_bytes + at, src + off + at, part, full + 8 * slot);
    }
  };
  float acc = 0.f;
  if (threadIdx.x >= kThreads && mode != 4) return;   // the producer warp is mode 4's
  if (mode == 6) {
    if (threadIdx.x == 0) {
      const long long t0 = clock64();
      for (int j = 0; j < n_tiles; ++j) {
        const int slot = j % depth;
        if (j >= depth) mbar_wait(full + 8 * slot, ((j / depth) - 1) & 1);
        const long long off = (static_cast<long long>(j) * tile_bytes) % kRegion;
        mbar_arrive_expect_tx(full + 8 * slot, tile_bytes);
        bulk_copy_g2s(slots + slot * tile_bytes, src + off, tile_bytes, full + 8 * slot);
      }
      for (int j = n_tiles - min(depth, n_tiles); j < n_tiles; ++j) {
        mbar_wait(full + 8 * (j % depth), (j / depth) & 1);
      }
      acc = *reinterpret_cast<const float*>(smem + 1024);
      cycles[blockIdx.x] = clock64() - t0;
      if (acc == 123.456f) sink[0] = acc;
    }
    return;
  }
  if (mode == 4 && threadIdx.x >= kThreads) {          // the producer: fetches only
    const long long t0 = clock64();
    for (int j = 0; j < n_tiles; ++j) fetch(j);
    if (lane == 0) cycles[gridDim.x + blockIdx.x] = clock64() - t0;
    return;
  }
  if (mode == 3) {
    constexpr int kAhead = 2, kMaxPieces = 4;      // tiles in flight; 16-byte pieces a thread
    const int pieces = tile_bytes / (kThreads * 16);
    uint4 regs[kAhead + 1][kMaxPieces];
    auto load = [&](int j, uint4 (&to)[kMaxPieces]) {
      const long long off = (static_cast<long long>(j) * tile_bytes) % kRegion;
#pragma unroll
      for (int i = 0; i < kMaxPieces; ++i) {
        if (i < pieces) {
          to[i] = __ldg(reinterpret_cast<const uint4*>(src + off) + i * kThreads + threadIdx.x);
        }
      }
    };
    const long long t0 = clock64();
#pragma unroll
    for (int a = 0; a < kAhead; ++a) load(a, regs[a]);
    for (int j0 = 0; j0 < n_tiles; j0 += kAhead + 1) {
#pragma unroll
      for (int a = 0; a <= kAhead; ++a) {            // tile j0 + a lies in regs[a]
        const int j = j0 + a;
        if (j < n_tiles) {
          if (j + kAhead < n_tiles) load(j + kAhead, regs[(a + kAhead) % (kAhead + 1)]);
          uint4* slot = reinterpret_cast<uint4*>(smem + 1024 + (j & 1) * tile_bytes);
#pragma unroll
          for (int i = 0; i < kMaxPieces; ++i) {
            if (i < pieces) slot[i * kThreads + threadIdx.x] = regs[a][i];
          }
          __syncthreads();
          acc += *reinterpret_cast<const float*>(smem + 1024 + (j & 1) * tile_bytes +
                                                 (threadIdx.x * 4 + 64) % tile_bytes);
        }
      }
    }
    const long long t1 = clock64();
    if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
    if (acc == 123.456f) sink[0] = acc;
    return;
  }
  const long long t0 = clock64();
  if (mode != 4) {
    for (int j = 0; j < depth && j < n_tiles; ++j) fetch(j);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int slot = j % depth;
    wait(full + 8 * slot, (j / depth) & 1);
    acc += *reinterpret_cast<const float*>(smem + 1024 + slot * tile_bytes +
                                           (threadIdx.x * 4) % tile_bytes);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
    if (mode != 4 && j + depth < n_tiles) fetch(j + depth);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  if (acc == 123.456f) sink[0] = acc;       // keeps the reads alive
}

int main() {
  unsigned char* src;
  long long* cycles;
  float* sink;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  if (cudaMalloc(&src, kRegion) != cudaSuccess || sms < 1 || sms > 256) return 1;
  cudaMemset(src, 1, kRegion);
  cudaMalloc(&cycles, 2 * 256 * sizeof(long long));
  cudaMalloc(&sink, sizeof(float));
  cudaFuncSetAttribute(stream, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  struct Config {
    int mode, tile, depth, split;
  };
  const std::vector<Config> configs = {
      {0, 4096, 12, 1},  {0, 4096, 32, 1},  {0, 8192, 6, 1},   {0, 8192, 24, 1}, {0, 16384, 2, 1},
      {0, 16384, 3, 1},  {0, 16384, 8, 1},  {0, 16384, 12, 1}, {0, 32768, 3, 1}, {0, 32768, 6, 1},
      {0, 65536, 2, 1},  {0, 65536, 3, 1},  {1, 16384, 3, 4},  {1, 16384, 8, 4}, {1, 16384, 8, 16},
      {2, 8192, 6, 1},   {2, 16384, 3, 1},  {2, 16384, 8, 1},  {2, 32768, 4, 1},
      {3, 8192, 2, 1},   {3, 16384, 2, 1},  {3, 32768, 2, 1},
      {4, 4096, 12, 1},  {4, 8192, 6, 1},   {4, 8192, 24, 1},  {4, 16384, 3, 1}, {4, 16384, 8, 1},
      {4, 32768, 6, 1},  {5, 8192, 6, 1},   {5, 16384, 3, 1},  {5, 16384, 8, 1},
      {6, 4096, 1, 1},   {6, 4096, 12, 1},  {6, 8192, 1, 1},   {6, 8192, 6, 1},  {6, 8192, 24, 1},
      {6, 16384, 1, 1},  {6, 16384, 3, 1},  {6, 16384, 8, 1},  {6, 32768, 6, 1},
  };
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (const int grid : {1, sms}) {
    for (const Config& c : configs) {
      const int n_tiles = static_cast<int>(4 * kRegion / c.tile);
      const size_t smem = 1024 + static_cast<size_t>(c.tile) * c.depth;
      if (smem > kMaxSmem) continue;
      float ms = 0.f;
      for (int rep = 0; rep < 2; ++rep) {   // the second run is the one that counts
        cudaEventRecord(e0);
        stream<<<grid, kLaunch, smem>>>(src, c.tile, c.depth, n_tiles, c.mode, c.split, cycles,
                                         sink);
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
        cudaEventElapsedTime(&ms, e0, e1);
      }
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) {
        printf("error: %s\n", cudaGetErrorString(err));
        return 1;
      }
      long long host[256];
      cudaMemcpy(host, cycles, grid * sizeof(long long), cudaMemcpyDeviceToHost);
      long long worst = 0;
      for (int i = 0; i < grid; ++i) worst = host[i] > worst ? host[i] : worst;
      const double bytes = static_cast<double>(n_tiles) * c.tile;
      printf("{\"blocks\": %d, \"mode\": %d, \"tile_bytes\": %d, \"depth\": %d, \"split\": %d, "
             "\"us\": %.1f, \"bytes_per_clock_per_sm\": %.2f, \"gb_per_s_per_sm\": %.1f, "
             "\"tb_per_s_all\": %.2f, \"clocks_per_tile\": %.0f}\n",
             grid, c.mode, c.tile, c.depth, c.split, ms * 1e3, bytes / worst,
             bytes / (ms * 1e-3) / 1e9, bytes * grid / (ms * 1e-3) / 1e12,
             static_cast<double>(worst) / n_tiles);
    }
  }
  return 0;
}
