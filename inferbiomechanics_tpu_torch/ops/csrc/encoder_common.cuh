// Device-side pieces that the encoder layer's forward (fused_encoder.cu)
// and backward (fused_encoder_bwd.cu) kernels share: the block's shape, the
// column blocks a block of a cluster owns, the softmax attention of a group
// of heads, and the weight ring of the pair shapes (two blocks of a cluster
// fed by one stream of weights).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;             // elements added to every shared-memory row
constexpr int kMaxT = 48;           // frames per window
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use
constexpr float kLnEps = 1e-6f;

// The 16-column blocks of a product's output that a block computes: block j
// of them is global block base + (j / run) * stride + j % run (runs of `run`
// consecutive blocks, `stride` apart: a group of heads' q, k and v columns).
struct Cols {
  int n, run, stride, base;
  __device__ __forceinline__ int block(int j) const {
    return base + (j / run) * stride + j % run;
  }
};

// Softmax attention within each window of the row tile for a group of gh
// heads, in f32: qkv holds [q * dh^-0.5 | k | v] of the group per row, each
// gh * dh wide; the mix of head hh goes, as bf16, to columns (h0 + hh) dh ..
// of dst. `sub` lanes take a (window, head, query frame), each a slice of dh,
// and add their partial scores by shuffles. kT > 0 fixes the frame count at
// compile time (scores in registers); kT == 0 takes it from t_rt.
template <int kT>
__device__ __forceinline__ void attention(const float* qkv, int ld_q, int t_rt, int dh, int gh,
                                          int windows, bf16* dst, int ld_dst, int h0) {
  const int t = kT > 0 ? kT : t_rt;
  const int gw = gh * dh;
  const int items = windows * gh * t;
  int sub = 8;                               // lanes an item: all the block's threads in one round
  while (sub > 1 && (dh % (2 * sub) != 0 || items * sub > kThreads)) sub >>= 1;
  const int total = items * sub;
  const int rounds = (total + kThreads - 1) / kThreads;
  for (int round = 0; round < rounds; ++round) {
    const int tid = round * kThreads + threadIdx.x;
    const bool active = tid < total;
    const int it = active ? tid / sub : 0;   // lanes past the end shadow item 0
    const int sl = tid % sub;
    const int tq = it % t;
    const int wh = it / t;
    const int hh = wh % gh;
    const int row0 = (wh / gh) * t;          // the window's first row in the tile
    const float* q = qkv + (row0 + tq) * ld_q + hh * dh;
    const float* kw = qkv + row0 * ld_q + gw + hh * dh;
    const float* vw = kw + gw;
    const int skew = (8 * hh) % dh;          // even; spreads the heads over the banks
    float p[kT > 0 ? kT : kMaxT];
#pragma unroll
    for (int j = 0; j < t; ++j) p[j] = 0.f;
    for (int ii = 2 * sl; ii < dh; ii += 2 * sub) {
      const int i = ii + skew < dh ? ii + skew : ii + skew - dh;
      const float2 qi = *reinterpret_cast<const float2*>(q + i);
#pragma unroll
      for (int j = 0; j < t; ++j) {
        const float2 kj = *reinterpret_cast<const float2*>(kw + j * ld_q + i);
        p[j] = fmaf(qi.x, kj.x, fmaf(qi.y, kj.y, p[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < t; ++j) {
      for (int o = sub >> 1; o > 0; o >>= 1) p[j] += __shfl_xor_sync(0xffffffffu, p[j], o);
    }
    float mx = p[0];
#pragma unroll
    for (int j = 1; j < t; ++j) mx = fmaxf(mx, p[j]);
    float z = 0.f;
#pragma unroll
    for (int j = 0; j < t; ++j) {
      p[j] = expf(p[j] - mx);
      z += p[j];
    }
    const float inv_z = 1.f / z;
    bf16* o = dst + (row0 + tq) * ld_dst + (h0 + hh) * dh;
    for (int ii = 2 * sl; ii < dh; ii += 2 * sub) {
      const int i = ii + skew < dh ? ii + skew : ii + skew - dh;
      float o0 = 0.f, o1 = 0.f;
#pragma unroll
      for (int j = 0; j < t; ++j) {
        const float2 vj = *reinterpret_cast<const float2*>(vw + j * ld_q + i);
        o0 = fmaf(p[j], vj.x, o0);
        o1 = fmaf(p[j], vj.y, o1);
      }
      if (active) {
        *reinterpret_cast<__nv_bfloat162*>(o + i) =
            __floats2bfloat162_rn(o0 * inv_z, o1 * inv_z);
      }
    }
  }
}

__device__ __forceinline__ void attention_any_t(const float* qkv, int ld_q, int t, int dh, int gh,
                                                int windows, bf16* dst, int ld_dst, int h0) {
  switch (t) {
    case 10:
      attention<10>(qkv, ld_q, t, dh, gh, windows, dst, ld_dst, h0);
      break;
    case 4:
      attention<4>(qkv, ld_q, t, dh, gh, windows, dst, ld_dst, h0);
      break;
    default:
      attention<0>(qkv, ld_q, t, dh, gh, windows, dst, ld_dst, h0);
  }
}

// ---- the pair shapes' weight ring ----
//
// Weights in fragment order ([n / 16][nk][32 lanes] x 16 bytes) reach both
// blocks of a cluster of two through a ring of kSlots slots in each block's
// shared memory; a fill is kKs k-steps of 16 column blocks (kKs x 8 KB), one
// slot. A producer warp in each block copies every other column block of a
// fill into both blocks' slot (multicast); it refills a slot once the
// consumer warps of both blocks that read it gave it back (one arrival each
// on this block's empty mbarrier). The other block's copies may reach this
// block's full mbarrier before its producer announces the fill's bytes: the
// transaction count runs below zero until then, and the phase completes only
// once the producer has arrived too. Slot i's full mbarrier lies at full +
// 8 i, its empty one at empty + 8 i.
template <int kSlotCount, int kSlotSteps>
struct WeightRing {
  static constexpr int kSlots = kSlotCount;
  static constexpr int kKs = kSlotSteps;
  static constexpr int kSlotBytes = 16 * kKs * 512;

  // Thread 0 of each block, before the cluster's first barrier; `readers`:
  // the consumer warps of a block that read each fill.
  static __device__ __forceinline__ void init(unsigned full, unsigned empty, int readers) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 2 * readers);
      // the first fill of each slot waits for nothing
      for (int k = 0; k < 2 * readers; ++k) mbar_arrive(empty + 8 * i);
    }
    mbar_init_fence();
  }

  // The consumers' view: the slot of the next fill they read and the
  // parity of its phase; they read every stride-th fill. Every consumer
  // thread steps it alike.
  struct Reader {
    const unsigned char* base;
    unsigned full, empty, peer_empty;
    int slot;
    unsigned phase;
    int stride = 1;

    // Wait for the next fill; `waited` (or null) gets the cycles waited.
    __device__ __forceinline__ const uint4* take(long long* waited) {
      if (waited != nullptr) {
        const long long t0 = clock64();
        mbar_wait(full + 8 * slot, phase);
        *waited += clock64() - t0;
      } else {
        mbar_wait(full + 8 * slot, phase);
      }
      return reinterpret_cast<const uint4*>(base + slot * kSlotBytes);
    }

    // The warp is done with the slot: one arrival on its empty mbarrier in
    // both blocks of the pair.
    __device__ __forceinline__ void give() {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) {
        mbar_arrive(empty + 8 * slot);
        mbar_arrive_cluster(peer_empty + 8 * slot);
      }
      slot += stride;
      if (slot >= kSlots) {
        slot -= kSlots;
        phase ^= 1;
      }
    }
  };

  // The producer warp's view (every lane calls put, in the consumers' order).
  struct Writer {
    unsigned ring, full, empty;
    int rank;
    int slot;
    unsigned fill;                   // fills of this slot so far

    // One fill: column blocks b0 .. b0 + 15 of a weight of nk k-steps,
    // k-steps ks .. ks + kKs - 1.
    __device__ __forceinline__ void put(const bf16* src, int nk, int b0, int ks) {
      const int lane = threadIdx.x & 31;
      const unsigned bar = full + 8 * slot;
      if (lane == 0) {
        if (fill > 0) mbar_wait(bar, (fill - 1) & 1);   // its last fill was consumed here
        mbar_arrive_expect_tx(bar, kSlotBytes);
        mbar_wait(empty + 8 * slot, fill & 1);
      }
      __syncwarp();
      if (lane < 8) {
        const int i = 2 * lane + rank;
        bulk_copy_g2s_multicast(ring + slot * kSlotBytes + i * kKs * 512,
                                src + (static_cast<long long>(b0 + i) * nk + ks) * 256,
                                kKs * 512, bar, 0x3);
      }
      if (++slot == kSlots) {
        slot = 0;
        ++fill;
      }
    }

    // k_steps k-steps from ks0 of column blocks b0 .. b0 + 15, fill by fill.
    __device__ __forceinline__ void put_all(const bf16* src, int nk, int b0, int ks0,
                                            int k_steps) {
      for (int ks = ks0; ks < ks0 + k_steps; ks += kKs) put(src, nk, b0, ks);
    }
  };
};

}  // namespace

