// Fused MLP forward for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes; see ../_build.py and ../fused_mlp.py).
//
// Replaces inferbiomechanics_tpu/ops/pallas_mlp.py::_fused_kernel, the TPU
// kernel behind fused_mlp_forward. It computes the same function:
//
//   h = bf16(x)
//   for each layer i:  h = h @ W_i + b_i     (bf16 operands, f32 accumulate
//                                              and bias)
//                      h = act(h)            (not on the last layer)
//                      h = bf16(h)           (every layer, the last one too)
//   out = f32(h)
//
// What bounds it on an H100. At a small batch the bytes of the weights
// (2.4 MB for 1770->512->512->30), which one SM cannot pull fast enough, and
// the latency of a chain of dependent steps; at a large batch the operations
// (2.4 MFLOP a row): as measured, the products themselves, a wgmma of 64 x 64
// x 16 with both operands in shared memory running far below the tensor
// rate, more than the weight bytes that every row tile streams from L2.
//
// Design. One kernel body, two shapes of launch (fused_mlp.py::plan_mlp picks
// from the batch and the widths alone).
//
//  - A cluster of C blocks owns a tile of kRows batch rows and runs the whole
//    layer chain for it. Every layer's output columns are cut into blocks of
//    64; the cluster's block of rank r owns column blocks r, r + C, ... and
//    pulls only their weights.
//  - The products run on wgmma, transposed: out^T [64 columns, kRows] =
//    W^T tile [64, K] . h^T [K, kRows], so that the 64-row side of the
//    instruction is the weight and the batch side can be as narrow as 8.
//    Both operands lie K-major in shared memory in the 128-byte-swizzled
//    layout (mma.cuh::wgmma_desc_sw128). pack_mlp_params stores every
//    64 x 64 weight tile already swizzled and contiguous, so one thread of a
//    producer warp brings a tile in with one 8 KB bulk copy that completes
//    on an mbarrier; a ring of such tiles runs ahead of the consumers, across
//    layer boundaries too, since weights wait for no activation.
//  - The first layer's input is streamed in chunks of columns as well. A
//    row of 1770 floats is no multiple of 16 bytes, which a TMA tensor map
//    needs of its strides, so the map describes x as rows of G = 2 (or 1, or
//    4) batch rows laid end to end: one box of [kRows / G, chunk + 4] brings
//    in the chunk of every G-th row of the tile, from the 16-byte boundary at
//    or before it, G boxes the whole chunk, each one instruction of one
//    thread; rows past the batch arrive as zeros. The
//    up to G - 1 rows that the map cannot hold at the end of the batch are
//    read with plain loads. The consumer warps themselves convert what has
//    landed in the f32 staging ring to bf16 into the swizzled operand panels,
//    a few rows a warp, meet at a barrier, and start the chunk's products,
//    which run on the tensor cores while the warps convert the next chunk.
//    (Three loader warps of their own for this were no faster, a lone warp
//    waiting out every instruction's latency, and cost two more rings of
//    barriers.)
//  - Hidden activations stay in shared memory as bf16 panels [kRows, 64],
//    two buffers used in turn. A column block of 64 is exactly one panel of
//    the next layer's operand, so a block writes its panels into its own
//    buffer and hands each to every other block of the cluster with one bulk
//    copy from shared memory to shared memory that completes on the
//    receiver's mbarrier; a block starts a layer when all panels have landed.
//    A panel's arrival also tells that its sender has finished reading the
//    buffer the next layer overwrites.
//  - The epilogue (bias, activation, bf16) is compiled once per activation,
//    so that it is free of branches and a thread's values overlap.
//
//  small batch: kRows = 8, C = 8. One forward's weights are spread over 8
//    SMs (more clusters for more rows). All of x is staged at once. Products
//    this narrow are bound by the latency of dependent wgmma, so the two
//    consumer warpgroups split K between them (even and odd chunks, each
//    with two accumulators used in turn) and add their sums through shared
//    memory.
//  large batch: kRows = 64 (32 when a layer is wider than 512), C = 2: 128
//    blocks at B = 4096, a weight byte feeds 64 rows, and each of the two
//    consumer warpgroups owns every other one of the block's column blocks.
//
// Padding. Widths are padded to multiples of 64 when the weights are packed.
// Padded input columns are zero and rows past the batch may hold anything
// (no other row's output reads them, and they are never stored); padded hidden
// columns see act(0) (0.5 for sigmoid), but the next layer's padded weight
// rows are zero, so they add nothing -- the argument at
// pallas_mlp.py:104-107. Padded output columns and rows are never stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "launch.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 8;
constexpr int kThreads = 384;        // two consumer warpgroups and a producer one
constexpr int kConsumers = 256;
constexpr int kTile = 64;            // columns a block of outputs, columns a K chunk
constexpr int kTileBytes = kTile * kTile * 2;
constexpr int kMaxChunks = 32;       // K chunks of the first layer at most
constexpr int kMaxDepth = 24;        // weight tiles in the ring
constexpr int kMaxSmem = 232448;     // bytes of shared memory a block may use
constexpr int kBarBytes = 2048;      // the barriers' share, ahead of the buffers
constexpr int kBarrierId = 1;        // named barrier of the consumers; 2, 3: of one warpgroup

// What fused_mlp.py::plan_mlp decides, byte offsets from the 1024-aligned
// start of the block's shared memory.
struct MlpPlan {
  int n_layers;
  int pdims[kMaxLayers + 1];        // padded widths, multiples of 64
  long long w_off[kMaxLayers];      // offset of layer i in the weight buffer
  int b_off[kMaxLayers];            // offset of layer i in the bias buffer
  int cluster;                      // blocks a row tile
  int depth;                        // weight tiles in the ring
  int stage_cols;                   // columns of x a staged chunk (a unit) holds: 64 or 192
  int stage_bytes;                  // bytes between staged chunks
  int stages;                       // f32 chunks of x in the staging ring
  int units;                        // chunks of x in the ring of bf16 operand panels
  int x_group;                      // G: batch rows a row of the tensor map of x
  int x_mapped;                     // batch rows the tensor map holds, a multiple of G
  int off_h[2];                     // hidden activations of even / odd layers
  int off_stage, off_panel, off_red, off_ring;
};

template <int kRows>
struct FusedMlpTag {};              // keys a kernel's shared-memory cap (launch.cuh)

// Activation ids; fused_mlp.py holds the same table. kIdentity is the last
// layer's.
enum Activation { kRelu = 0, kTanh = 1, kSigmoid = 2, kGelu = 3, kElu = 4, kIdentity = 5 };

// tanh from the fast exponential: exact limits at both ends, an absolute
// error near 1e-7, far below the bf16 rounding that follows.
__device__ __forceinline__ float fast_tanh(float v) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));
}

template <int kAct>
__device__ __forceinline__ float activate(float v) {
  if constexpr (kAct == kRelu) {
    return fmaxf(v, 0.f);
  } else if constexpr (kAct == kTanh) {
    return fast_tanh(v);
  } else if constexpr (kAct == kSigmoid) {
    return __fdividef(1.f, 1.f + __expf(-v));
  } else if constexpr (kAct == kGelu) {   // tanh form, as jax.nn.gelu's default
    const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.f + fast_tanh(u));
  } else if constexpr (kAct == kElu) {    // alpha 1
    return v > 0.f ? v : __expf(v) - 1.f;
  } else {
    return v;
  }
}

// Byte offset of element (row, k) in a 128-byte-swizzled panel of 64 columns.
__device__ __forceinline__ unsigned swizzled(int row, int k) {
  return row * 128 + ((((k >> 3) ^ row) & 7) << 4) + (k & 7) * 2;
}

// Column blocks of a layer `nb` wide that the block of rank `rank` owns.
__device__ __forceinline__ int blocks_of_rank(int nb, int rank, int cluster) {
  return rank < nb ? (nb - rank + cluster - 1) / cluster : 0;
}

// kSplitK: the two consumer warpgroups share every column block of the block
// and split the K chunks (the small-batch launch); otherwise each owns every
// other column block over all of K.
template <int kRows, int kMaxBlk, bool kSplitK>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const __grid_constant__ CUtensorMap x_map, const float* __restrict__ x, int batch,
                 int c_in, const bf16* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ out, int c_out, int act, MlpPlan s) {
  constexpr int kPanelBytes = kRows * 128;
  constexpr int kAccs = kSplitK ? 2 : 1;       // accumulators a column block, used in turn
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  // mbarriers: a weight tile has landed / may be overwritten, a staged chunk
  // of x has landed / may be overwritten, the other blocks' shares of a layer
  // have landed (two, for even and odd layers)
  const unsigned w_full = base;
  const unsigned w_empty = w_full + 8 * kMaxDepth;
  const unsigned s_full = w_empty + 8 * kMaxDepth;
  const unsigned s_empty = s_full + 8 * kMaxChunks;
  const unsigned h_ready = s_empty + 8 * kMaxChunks;
  static_assert(8 * (2 * kMaxDepth + 2 * kMaxChunks + 2) <= kBarBytes, "barriers outgrow their share");

  const int cluster = s.cluster;
  const int rank = static_cast<int>(cluster_ctarank());
  const int row0 = (blockIdx.x / cluster) * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = warp >> 2;               // 0, 1: consumers; 2: producers

  for (int i = threadIdx.x; i < kMaxChunks; i += kThreads) {
    if (i < s.depth) {
      mbar_init(w_full + 8 * i, 1);          // the producer's expect_tx
      mbar_init(w_empty + 8 * i, 4);         // the four warps of the tile's warpgroup
    }
    if (i < s.stages) {
      mbar_init(s_full + 8 * i, 1);          // the fetching lane's expect_tx
      mbar_init(s_empty + 8 * i, kConsumers / 32);
    }
    if (i < 2) mbar_init(h_ready + 8 * i, 1);   // this block's expect_tx
  }
  mbar_init_fence();
  __syncthreads();
  cluster_sync_all();   // no block touches another's barriers before they exist

  if (group == 2) {
    // ===================== producers =====================
    setmaxnreg_dec<72>();
    if (warp == 8) {
      // the weight ring: every tile this block's consumers will ask for, in
      // their order (layer, K chunk, owned column block)
      if (lane == 0) {
        unsigned seq = 0;
        for (int l = 0; l < s.n_layers; ++l) {
          const int nk = s.pdims[l] / kTile;
          const int mine = blocks_of_rank(s.pdims[l + 1] / kTile, rank, cluster);
          const bf16* wl = w + s.w_off[l];
          for (int kc = 0; kc < nk; ++kc) {
            for (int b = 0; b < mine; ++b, ++seq) {
              const unsigned slot = seq % s.depth;
              const unsigned use = seq / s.depth;
              mbar_wait(w_empty + 8 * slot, (use & 1) ^ 1);
              mbar_arrive_expect_tx(w_full + 8 * slot, kTileBytes);
              const long long tile = static_cast<long long>(rank + b * cluster) * nk + kc;
              bulk_copy_g2s(base + s.off_ring + slot * kTileBytes, wl + tile * (kTile * kTile),
                            kTileBytes, w_full + 8 * slot);
            }
          }
        }
      }
    } else if (warp == 9 && lane == 0) {
      // x, a unit of stage_cols columns at a time: TMA boxes into the f32
      // staging ring, each slot as soon as the consumers have converted what
      // it held. A box holds stage_cols + 4 columns, from the 16-byte
      // boundary at or before the chunk's first, for every G-th row of the
      // tile; boxes lie 128-byte aligned in the slot.
      const int n_units = (s.pdims[0] + s.stage_cols - 1) / s.stage_cols;
      const int grp = s.x_group;
      const unsigned box_bytes = (kRows / grp) * (s.stage_cols + 4) * 4;
      const unsigned box_stride = (box_bytes + 127u) & ~127u;
      for (int u = 0; u < n_units; ++u) {
        const int st = u % s.stages;
        mbar_wait(s_empty + 8 * st, ((u / s.stages) & 1) ^ 1);
        if (row0 < s.x_mapped) {
          mbar_arrive_expect_tx(s_full + 8 * st, grp * box_bytes);
          for (int q = 0; q < grp; ++q) {
            tma_load_2d(base + s.off_stage + st * s.stage_bytes + q * box_stride, &x_map,
                        (q * c_in + u * s.stage_cols) & ~3, row0 / grp, s_full + 8 * st);
          }
        } else {
          mbar_arrive(s_full + 8 * st);
        }
      }
    }
  } else {
    // ===================== consumers =====================
    setmaxnreg_inc<216>();
    const int wq = warp & 3;                    // warp of the warpgroup
    const int g = lane >> 2;
    const int c = lane & 3;
    const int kstart = kSplitK ? group : 0;
    const int kstep = kSplitK ? 2 : 1;
    float acc[kMaxBlk][kAccs][kRows / 2];
    unsigned seq_base = 0;

    // The conversion of x. The warps that read a panel convert it together:
    // all eight, or (kSplitK) the four of the warpgroup whose chunk it is;
    // warp cw of them takes kConvRows rows. Row r of the tile is row r / G of
    // box q = r % G of the staged chunk, and its data starts (q c_in) % 4
    // floats into the box's rows. A row past the batch may hold anything: no
    // other row's output reads it.
    constexpr int kConvWarps = kSplitK ? 4 : kConsumers / 32;
    constexpr int kConvRows = kRows / kConvWarps;
    const int cw = kSplitK ? wq : warp;
    const int ppu = s.stage_cols / kTile;                 // panels a unit of x
    const int grp = s.x_group;
    const int lg = grp >> 1;                              // log2 of 1, 2, 4
    const int box_cols = s.stage_cols + 4;
    const unsigned box_stride = ((kRows / grp) * box_cols * 4 + 127u) & ~127u;
    const unsigned lane_sw = lane >> 2, lane_in = (lane & 3) * 4;   // swizzled(r, 2 * lane)
    // The rows the tensor map cannot hold (fewer than G, at the batch's end)
    // come by plain loads: where all panels stay (kSplitK), before anything
    // else and all at once; otherwise a chunk ahead of their use.
    const int staged_rows = min(kRows, s.x_mapped - row0);
    auto plain_pair = [&](int r, int col) {
      const float* xr = x + static_cast<long long>(row0 + r) * c_in + col;
      return make_float2(col < c_in ? __ldg(xr) : 0.f, col + 1 < c_in ? __ldg(xr + 1) : 0.f);
    };
    auto store_pair = [&](int panel, int r, float2 v) {
      *reinterpret_cast<__nv_bfloat162*>(sm + s.off_panel + panel * kPanelBytes + r * 128 +
                                         (((lane_sw ^ r) & 7) << 4) + lane_in) =
          __floats2bfloat162_rn(v.x, v.y);
    };
    const bool has_plain = row0 + cw * kConvRows + kConvRows > s.x_mapped &&
                           row0 + cw * kConvRows < batch;
    float2 ahead[kConvRows] = {};
    if (has_plain) {
      if constexpr (kSplitK) {
        // this warpgroup's chunks of a row: all loads first, then the stores
        const int nk = s.pdims[0] / kTile;
        for (int i = 0; i < kConvRows; ++i) {
          const int r = cw * kConvRows + i;
          if (r >= staged_rows && row0 + r < batch) {
            float2 v[kMaxChunks / 2];
#pragma unroll
            for (int k = 0; k < kMaxChunks / 2; ++k) {
              if (group + 2 * k < nk) v[k] = plain_pair(r, (group + 2 * k) * kTile + 2 * lane);
            }
#pragma unroll
            for (int k = 0; k < kMaxChunks / 2; ++k) {
              if (group + 2 * k < nk) store_pair(group + 2 * k, r, v[k]);
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kConvRows; ++i) {
          const int r = cw * kConvRows + i;
          if (r >= staged_rows && row0 + r < batch) ahead[i] = plain_pair(r, 2 * lane);
        }
      }
    }
    // chunk kc of x into its panel
    auto convert = [&](int kc, int panel) {
      const int unit = kc / ppu;
      const unsigned char* src = sm + s.off_stage + (unit % s.stages) * s.stage_bytes +
                                 ((kc % ppu) * kTile + 2 * lane) * 4;
      const int col = kc * kTile + 2 * lane;             // this lane's pair of columns
      const bool whole = (c_in & 1) == 0 && (kc + 1) * kTile <= c_in;
      float2 v[kConvRows];
#pragma unroll
      for (int i = 0; i < kConvRows; ++i) {
        const int r = cw * kConvRows + i;
        const int q = r & (grp - 1);
        const unsigned char* sp = src + q * box_stride + ((r >> lg) * box_cols + ((q * c_in) & 3)) * 4;
        if (whole) {
          v[i] = *reinterpret_cast<const float2*>(sp);   // inside x, 8-byte aligned
        } else {
          // zero past c_in: what a box holds there is the next row's
          v[i].x = col < c_in ? *reinterpret_cast<const float*>(sp) : 0.f;
          v[i].y = col + 1 < c_in ? *reinterpret_cast<const float*>(sp + 4) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kConvRows; ++i) {
        const int r = cw * kConvRows + i;
        if constexpr (kSplitK) {
          if (r < staged_rows) store_pair(panel, r, v[i]);
        } else {
          const bool plain = has_plain && r >= staged_rows && row0 + r < batch;
          store_pair(panel, r, plain ? ahead[i] : v[i]);
          if (plain && (kc + 1) * kTile < s.pdims[0]) ahead[i] = plain_pair(r, col + kTile);
        }
      }
    };

    for (int l = 0; l < s.n_layers; ++l) {
      const bool first = l == 0;
      const bool last = l == s.n_layers - 1;
      const int nk = s.pdims[l] / kTile;
      const int mine = blocks_of_rank(s.pdims[l + 1] / kTile, rank, cluster);
      // this warpgroup's column blocks among the block's owned ones: all of
      // them, or group, group + 2, ...
      const int my_n = kSplitK ? mine : (mine > group ? (mine - group + 1) / 2 : 0);
      const int own0 = kSplitK ? 0 : group;
      const int own_step = kSplitK ? 1 : 2;
      const unsigned in_base = first ? base + s.off_panel : base + s.off_h[(l - 1) & 1];
      const float* bl = bias + s.b_off[l];
      // this thread holds columns m and m + 8 of a column block (mma.cuh::Wgmma)
      float bv[kMaxBlk][2];
#pragma unroll
      for (int j = 0; j < kMaxBlk; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gb = rank + (own0 + own_step * j) * cluster;
          bv[j][half] = j < my_n ? __ldg(bl + gb * kTile + 16 * wq + g + 8 * half) : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kAccs; ++a) {
#pragma unroll
          for (int i = 0; i < kRows / 2; ++i) acc[j][a][i] = 0.f;
        }
      }
      int prev_slot = -1;
      int last_unit = -1;

      for (int kc = kstart; kc < nk; kc += kstep) {
        uint64_t b_desc;
        if (first) {
          // the chunk of x: once its unit has landed, the warps convert it
          // together and meet; the slot of a unit whose last chunk that was
          // goes back to the fetching lane. A panel is written again three
          // chunks later, when the products that read it are done: every
          // warp has by then waited for all its groups but its newest.
          const int unit = kc / ppu;
          const int panel = kSplitK ? kc : kc % (s.units * ppu);
          if (unit != last_unit) mbar_wait(s_full + 8 * (unit % s.stages), (unit / s.stages) & 1);
          last_unit = unit;
          convert(kc, panel);
          fence_proxy_async_smem();
          if constexpr (kSplitK) {
            named_barrier_sync(kBarrierId + 1 + group, kConsumers / 2);
          } else {
            named_barrier_sync(kBarrierId, kConsumers);
          }
          if (lane == 0 && (kc + kstep >= nk || (kc + kstep) / ppu != unit)) {
            mbar_arrive(s_empty + 8 * (unit % s.stages));
          }
          b_desc = wgmma_desc_sw128(in_base + panel * kPanelBytes);
        } else {
          b_desc = wgmma_desc_sw128(in_base + kc * kPanelBytes);
        }
#pragma unroll
        for (int j = 0; j < kMaxBlk; ++j) {
          if (j < my_n) {
            const unsigned seq = seq_base + kc * mine + own0 + own_step * j;
            const unsigned slot = seq % s.depth;
            mbar_wait(w_full + 8 * slot, (seq / s.depth) & 1);
            const uint64_t a_desc = wgmma_desc_sw128(base + s.off_ring + slot * kTileBytes);
            wgmma_fence();
#pragma unroll
            for (int k4 = 0; k4 < kTile / 16; ++k4) {
              Wgmma<kRows>::mma(acc[j][k4 % kAccs], a_desc + 2 * k4, b_desc + 2 * k4, 1);
            }
            wgmma_commit();
            // every group but this one is done: the last tile's slot is
            // free. (Keeping three groups in flight instead was slower on
            // the card: the slots they hold starve the ring.)
            wgmma_wait<1>();
            if (lane == 0 && prev_slot >= 0) mbar_arrive(w_empty + 8 * prev_slot);
            prev_slot = static_cast<int>(slot);
          }
        }
      }
      wgmma_wait<0>();
      if (lane == 0 && prev_slot >= 0) mbar_arrive(w_empty + 8 * prev_slot);
      seq_base += nk * mine;

      if constexpr (kSplitK) {
        // the second warpgroup's sums join the first's through shared memory
        float* red = reinterpret_cast<float*>(sm + s.off_red);
        const int tw = threadIdx.x & 127;
#pragma unroll
        for (int j = 0; j < kMaxBlk; ++j) {
#pragma unroll
          for (int i = 0; i < kRows / 2; ++i) {
            acc[j][0][i] += acc[j][kAccs - 1][i];
            if (group == 1 && j < my_n) red[(j * (kRows / 2) + i) * 128 + tw] = acc[j][0][i];
          }
        }
        named_barrier_sync(kBarrierId, kConsumers);
        if (group == 0) {
#pragma unroll
          for (int j = 0; j < kMaxBlk; ++j) {
#pragma unroll
            for (int i = 0; i < kRows / 2; ++i) {
              if (j < my_n) acc[j][0][i] += red[(j * (kRows / 2) + i) * 128 + tw];
            }
          }
        }
      }

      // bias, activation, bf16: rows 8 i + 2 c, + 1 of columns m, m + 8
      unsigned char* const h_out = sm + s.off_h[l & 1];
      auto epilogue = [&](auto tag) {
        constexpr int kAct = decltype(tag)::value;
#pragma unroll
        for (int j = 0; j < kMaxBlk; ++j) {
          if (j < my_n) {
            const int gb = rank + (own0 + own_step * j) * cluster;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int m = 16 * wq + g + 8 * half;
              const int col = gb * kTile + m;
#pragma unroll
              for (int i = 0; i < kRows / 8; ++i) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int n = 8 * i + 2 * c + e;
                  const bf16 hv = __float2bfloat16(
                      activate<kAct>(acc[j][0][4 * i + 2 * half + e] + bv[j][half]));
                  if constexpr (kAct != kIdentity) {
                    *reinterpret_cast<bf16*>(h_out + gb * kPanelBytes + swizzled(n, m)) = hv;
                  } else if (row0 + n < batch && col < c_out) {
                    out[static_cast<long long>(row0 + n) * c_out + col] = __bfloat162float(hv);
                  }
                }
              }
            }
          }
        }
      };
      if (!kSplitK || group == 0) {
        if (last) {
          epilogue(std::integral_constant<int, kIdentity>{});
        } else {
          switch (act) {
            case kRelu:
              epilogue(std::integral_constant<int, kRelu>{});
              break;
            case kTanh:
              epilogue(std::integral_constant<int, kTanh>{});
              break;
            case kSigmoid:
              epilogue(std::integral_constant<int, kSigmoid>{});
              break;
            case kGelu:
              epilogue(std::integral_constant<int, kGelu>{});
              break;
            default:
              epilogue(std::integral_constant<int, kElu>{});
          }
        }
      }
      if (!last) {
        // every column block is a whole panel of the next layer's operand:
        // one bulk copy hands it to each other block of the cluster, and
        // this block waits for theirs
        const unsigned bar = h_ready + 8 * (l & 1);
        fence_proxy_async_smem();
        named_barrier_sync(kBarrierId, kConsumers);
        if (threadIdx.x == 0) {
          mbar_arrive_expect_tx(bar, (s.pdims[l + 1] / kTile - mine) * kPanelBytes);
          for (int b = 0; b < mine; ++b) {
            const unsigned src = base + s.off_h[l & 1] + (rank + b * cluster) * kPanelBytes;
            for (int q = 0; q < cluster; ++q) {
              if (q != rank) {
                bulk_copy_s2c(cluster_map(src, q), src, kPanelBytes, cluster_map(bar, q));
              }
            }
          }
        }
        mbar_wait(bar, (l >> 1) & 1);
      }
    }
  }
}

template <int kRows, int kMaxBlk, bool kSplitK>
cudaError_t launch(MlpPlan& s, size_t smem, const float* x, int batch, int c_in, const bf16* w,
                   const float* bias, float* out, int c_out, int act, cudaStream_t stream) {
  auto kernel = fused_mlp_kernel<kRows, kMaxBlk, kSplitK>;
  // every warpgroup's share of a layer has to fit its accumulators, and a
  // launch that splits K keeps all of x's panels
  for (int l = 0; l < s.n_layers; ++l) {
    const int mine = (s.pdims[l + 1] / kTile + s.cluster - 1) / s.cluster;
    if ((kSplitK ? mine : (mine + 1) / 2) > kMaxBlk) return cudaErrorInvalidValue;
  }
  if (kSplitK && s.units * s.stage_cols < s.pdims[0]) return cudaErrorInvalidValue;
  if (kRows * (s.stage_cols + 4) * 4 + 4 * 128 > s.stage_bytes) return cudaErrorInvalidValue;
  cudaError_t err = ensure_dynamic_smem<FusedMlpTag<kRows>>(kernel, smem);
  if (err != cudaSuccess) return err;

  // x as [batch / G, G c_in]: G batch rows a row, so that the row stride is
  // a multiple of 16 bytes whatever c_in is
  const int grp = c_in % 4 == 0 ? 1 : (c_in % 2 == 0 ? 2 : 4);
  s.x_group = grp;
  s.x_mapped = batch / grp * grp;
  CUtensorMap x_map{};
  if (s.x_mapped > 0) {
    err = make_tensor_map_2d(&x_map, x, static_cast<unsigned long long>(grp) * c_in,
                             static_cast<unsigned long long>(batch / grp), s.stage_cols + 4,
                             kRows / grp);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (batch + kRows - 1) / kRows;
  return launch_cluster(kernel, tiles * s.cluster, kThreads, s.cluster, smem, stream, x_map, x,
                        batch, c_in, w, bias, out, c_out, act, s);
}

}  // namespace

extern "C" {

// x [batch, c_in] f32; w: the packed bf16 weights, layer i as swizzled
// 64 x 64 tiles (fused_mlp.py::pack_mlp_params) over padded widths
// [pdims[i], pdims[i+1]]; bias: the packed f32 biases; pdims: n_layers + 1
// padded widths (host memory); out [batch, c_out] f32; x 16-byte aligned.
// plan: the fourteen ints of fused_mlp.py::plan_mlp (rows, cluster, depth,
// stage_cols, stage_bytes, stages, units, off_h0, off_h1, off_stage, off_panel, off_red,
// off_ring, smem_bytes). Launches on `stream` and returns the launch's error
// (0 on success).
int ib_fused_mlp_forward(const void* x, int batch, int c_in, const void* w,
                         const void* bias, const int* pdims, int n_layers, void* out,
                         int c_out, int act, const int* plan, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || batch < 1 || act < kRelu || act > kElu) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l <= n_layers; ++l) {
    if (pdims[l] < kTile || pdims[l] % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (c_in > pdims[0] || c_in <= pdims[0] - kTile || c_out > pdims[n_layers] ||
      pdims[0] > kMaxChunks * kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  MlpPlan s{};
  s.n_layers = n_layers;
  long long w_off = 0;
  int b_off = 0;
  for (int l = 0; l < n_layers; ++l) {
    s.pdims[l] = pdims[l];
    s.w_off[l] = w_off;
    s.b_off[l] = b_off;
    w_off += static_cast<long long>(pdims[l]) * pdims[l + 1];
    b_off += pdims[l + 1];
  }
  s.pdims[n_layers] = pdims[n_layers];
  const int rows = plan[0];
  s.cluster = plan[1];
  s.depth = plan[2];
  s.stage_cols = plan[3];
  s.stage_bytes = plan[4];
  s.stages = plan[5];
  s.units = plan[6];
  s.off_h[0] = plan[7];
  s.off_h[1] = plan[8];
  s.off_stage = plan[9];
  s.off_panel = plan[10];
  s.off_red = plan[11];
  s.off_ring = plan[12];
  const int smem = plan[13];
  const int offs[6] = {s.off_h[0], s.off_h[1], s.off_stage, s.off_panel, s.off_red, s.off_ring};
  for (int off : offs) {
    if (off < kBarBytes || off % 1024 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s.cluster < 1 || s.cluster > 8 || s.depth < 2 || s.depth > kMaxDepth || s.stages < 1 ||
      s.stages > kMaxChunks || s.units < 1 || s.units > kMaxChunks ||
      (s.stage_cols != kTile && s.stage_cols != 3 * kTile) || s.stage_bytes % 1024 != 0 || smem > kMaxSmem ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      s.off_ring + s.depth * kTileBytes + 1024 > smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  const float* xf = static_cast<const float*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (rows == 8) {
    err = launch<8, 2, true>(s, smem, xf, batch, c_in, wb, bf, of, c_out, act, st);
  } else if (rows == 32) {
    err = launch<32, 4, false>(s, smem, xf, batch, c_in, wb, bf, of, c_out, act, st);
  } else if (rows == 64) {
    err = launch<64, 2, false>(s, smem, xf, batch, c_in, wb, bf, of, c_out, act, st);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}


const char* ib_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
