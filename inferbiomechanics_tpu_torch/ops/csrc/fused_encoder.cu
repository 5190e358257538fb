// Fused pre-LN transformer encoder layer for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; see ../_build.py and
// ../fused_encoder.py).
//
// Replaces inferbiomechanics_tpu/ops/pallas_encoder.py::encoder_layer_pallas
// (kernels _encoder_kernel and _encoder_kernel_v2, which differ only in how
// they lay the attention core out for a 2-D vector unit). One launch computes
// the whole layer for x [B, T, d] f32:
//
//   y   = bf16(LN(x; g1, b1))                       LN in f32, eps 1e-6
//   qkv = y @ Wqkv + bqkv                           bf16 operands, f32 sum and bias
//   q, k, v = split(qkv) as [q | k | v], each [H, dh];  q *= dh^-0.5   (f32)
//   p   = softmax_j(q_i . k_j)  per window and head, over the T frames  (f32)
//   a   = bf16(sum_j p_ij v_j)
//   h   = x + a @ Wproj + bproj                     f32 residual stream
//   y   = bf16(LN(h; g2, b2))
//   u   = bf16(gelu_tanh(y @ W1 + bm1))
//   out = h + u @ W2 + bm2
//
// What bounds it on an H100 (d = 256, T = 10, 4d MLP): not the tensor cores
// (15.7 MFLOP a window) but the weights, 1.5 MiB of bf16 that every row tile
// takes in (pack_encoder_params lays each matrix out in mma.sync fragment
// order: one coalesced 16-byte load a lane for a 16-column block and k-step)
// at the few tens of bytes a clock one multiprocessor reaches, and for one
// window the chain of dependent phases around them.
//
// Three shapes of launch (fused_encoder.py::plan_encoder picks from the
// shape alone), the first two one kernel body:
//
//  small (kSplit): a cluster of C blocks (8 at d = 256, H = 8) shares a row
//    tile of whole windows, 1..3 mma row tiles of 16 rows, as few as the
//    batch needs (one window: one row tile, an instantiation of its own).
//    Every block owns 1/C of every product's output columns and streams only
//    their weights (192 KB at d = 256): whole heads of q/k/v (the columns
//    [q | k | v] are head-major, so a head's are three runs of dh), so that
//    attention stays in the block, and d/C columns of the projection and of
//    W2, m/C of W1. Each product's first weights are asked for before the
//    phase ahead of it. What the others need -- the attention output a, the
//    residual h and the MLP hidden u -- a block hands over with one bulk copy
//    a row and block from its shared memory into theirs, which completes on
//    an mbarrier of the receiver (one for each of a, h and u, expecting its
//    bytes from the start); LN2 runs on full rows in every block, and each
//    block stores its own columns of the output.
//
//  large (!kSplit): the same body with C = 1: one block a row tile of up to
//    3 row tiles (48 rows at d = 256: 4 windows of 10 frames) and all the
//    columns; the f32 q/k/v of all heads [rows, 3d] is what caps the tile,
//    so the attention output takes the LayerNorm output's place and the MLP
//    hidden the q/k/v's. (An 80-row tile with q/k/v a head at a time and the
//    MLP a chunk of hidden columns at a time was slower: PERF.md.)
//
//  pair (fused_encoder_kernel_pair, a kernel of its own): at d = 256 (T <=
//    16, heads 16, 32 or 64 wide, m 512 or 1024), from PAIR_BATCH_MIN
//    windows, clusters of two blocks walk over pairs of 32-row tiles, each
//    block its own tile with all the columns. What bounds the large tile is
//    its weight stream: 1.5 MiB from L2 into registers a 48-row tile (40
//    valid rows at T = 10). Here one stream feeds both blocks, so a weight
//    byte read from L2 serves 64 rows (60 valid): a producer warp (its
//    warpgroup gives its registers to the consumers by setmaxnreg) fills a
//    ring of two 32 KB slots, each 4 k-steps of 16 column blocks in fragment
//    order, every block copying half of a fill into both blocks' rings
//    (multicast; WeightRing, encoder_common.cuh). The 16 consumer warps form
//    two groups of 8 that take alternate fills, one slot each: a warp takes
//    two column blocks of a fill for both row tiles, so that shared memory
//    serves each byte of A and B once a group (ldmatrix for A, 16-byte loads
//    for B, mma.sync), and gives its slot back once the weights are in
//    registers. q and k, and W1's column groups, go a group each; v, the
//    projection and W2 go every other fill to a group, the second group's
//    sums added in place before the first group's epilogue. The next tile's
//    x lands by one bulk copy past the MLP hidden while the block works, and
//    LN1 reads it from there. The arithmetic is the other shapes': q/k/v,
//    the scale and the softmax in f32 (the f32 q/k/v of all heads, 98.8 KB,
//    are what leave room for two slots only), the attention output in the
//    LayerNorm output's place, the MLP hidden in q/k/v's.
//
// Products (small and large): each warp owns 16-column blocks of a product's
// output for all row tiles, its weight loads kDepth k-steps ahead in
// registers. In the small shape, where a product has fewer column blocks
// than warps, the warps split its K steps as well; the partial sums meet in
// shared memory, where all the block's threads add them and run the
// epilogue. The f32 rows (LayerNorm's, and the biases where there is room)
// are staged in shared memory with x. The attention core is T x T dot
// products of length dh per window and head, in f32 from shared memory, a
// few lanes a (window, head, query frame) where there are fewer of those than
// threads; T = 10 and T = 4 keep the scores in registers, any other T up to
// kMaxT takes the same code with the scores in local memory. Padding rows
// and windows past the batch hold zeros, run through the same arithmetic
// (finite everywhere) and are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "encoder_common.cuh"
#include "launch.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxCluster = 8;
constexpr int kRowTiles = 3;        // 16-row mma tiles a row tile holds at most

// What fused_encoder.py::plan_encoder decides (EncoderPlan.as_ints, in this
// order after the shape). Strides are in elements, offsets in bytes from the
// start of the block's shared memory, where the f32 residual [rows][d + 8]
// lies; the LayerNorm output and the attention output are bf16 [rows][d + 8].
struct EncPlan {
  int batch, t, d, m, heads;
  int cluster;        // blocks that share a row tile: C (small), 1 (large)
  int row_tiles;      // 16-row mma tiles of the row tile
  int windows;        // whole windows a row tile
  int ld_q, ld_u;     // strides of this block's q/k/v (f32) and of the MLP hidden (bf16)
  int off_y, off_a, off_q, off_u, off_s;   // LN out, attention out, q/k/v, hidden, scratch
  int scratch_floats; // room for partial sums of products split along K
  int off_v;          // the f32 rows staged: LayerNorm's (4 d), then the biases (5 d + m)
  int off_b;          // three mbarriers (small)
  int staged;         // 0: none (read from device memory), 1: LayerNorm's, 2: all
  float q_scale;      // dh^-0.5
};

// Phases that the cycle counters time (ib_fused_encoder_forward's `clocks`):
// stage x and LN1, q/k/v, attention, the exchange of a, projection, the
// exchange of h, LN2, W1, the exchange of u, W2.
constexpr int kPhases = 10;

template <int kRows, bool kSplit>
struct FusedEncoderTag {};          // keys a kernel's shared-memory cap (launch.cuh)

// tanh from the fast exponential: exact limits at both ends, an absolute
// error near 1e-7, far below the bf16 rounding that follows.
__device__ __forceinline__ float gelu_tanh(float v) {
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (2.f - __fdividef(2.f, 1.f + __expf(2.f * u)));
}

// LayerNorm of every row of src (f32, stride ld_src) into dst as bf16: one
// warp per row, mean and biased variance in f32, two passes over the row;
// scale and bias lie in shared memory.
__device__ __forceinline__ void layernorm_rows(const float* src, int ld_src, int rows, int d,
                                               const float* scale, const float* bias, bf16* dst,
                                               int ld_dst) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float inv_d = 1.f / static_cast<float>(d);
  for (int r = warp; r < rows; r += kWarps) {
    const float* x = src + r * ld_src;
    float sum = 0.f;
    for (int i = lane; i < d; i += 32) sum += x[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum * inv_d;
    float sq = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float c = x[i] - mean;
      sq = fmaf(c, c, sq);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rs = rsqrtf(sq * inv_d + kLnEps);
    bf16* y = dst + r * ld_dst;
    for (int i = lane; i < d; i += 32) {
      y[i] = __float2bfloat16((x[i] - mean) * rs * scale[i] + bias[i]);
    }
  }
}

// The weights of one product: w [16 nk, n], packed in fragment order
// [n / 16][nk][32 lanes] x 16 bytes, for the column blocks `cols`.
struct Weights {
  const bf16* w;
  int nk;
  Cols cols;
};

// How a product's work falls to the warps, the same in every thread: where
// there are fewer column blocks than warps, the warps also split the k-steps
// (a power of two that divides nk, as far as the scratch holds every part's
// partial sums). Warp i takes items i, i + kWarps, ...; item = part * n + j.
__device__ __forceinline__ int split_of(const Weights& wt, int row_tiles, int scratch_floats) {
  int split = 1;
  while (2 * split * wt.cols.n <= kWarps && wt.nk % (2 * split) == 0 &&
         2 * split * wt.cols.n * row_tiles * 256 <= scratch_floats) {
    split *= 2;
  }
  return split;
}

// This lane's first weight load of an item.
__device__ __forceinline__ const uint4* item_weights(const Weights& wt, int split, int item) {
  const int j = item % wt.cols.n;
  const int part = item / wt.cols.n;
  return reinterpret_cast<const uint4*>(wt.w) +
         (static_cast<long long>(wt.cols.block(j)) * wt.nk + part * (wt.nk / split)) * 32 +
         (threadIdx.x & 31);
}

// Ask for the first kDepth k-steps of this warp's first item of a product,
// ahead of it: the loads need no activation, so they fly while the block
// does the work before the product.
template <int kDepth>
__device__ __forceinline__ void prefetch(uint4 (&ring)[kDepth], const Weights& wt, int row_tiles,
                                         int scratch_floats) {
  const int split = split_of(wt, row_tiles, scratch_floats);
  const int warp = threadIdx.x >> 5;
  if (warp < wt.cols.n * split) {
    const uint4* wp = item_weights(wt, split, warp);
    const int part_nk = wt.nk / split;
#pragma unroll
    for (int dd = 0; dd < kDepth; ++dd) {
      if (dd < part_nk) ring[dd] = __ldg(wp + dd * 32);
    }
  }
}

// One product for the block's row tiles: a [16 * row_tiles, 16 * nk] bf16 in
// shared memory (stride lda) times the weights `wt`; with `prefetched`,
// `ring` holds the first k-steps already (prefetch, same arguments).
// epi(row, global col, v0, v1) receives every pair of neighbouring sums (col
// even) exactly once. With a split along K, every part stores its partial
// sums in the scratch and, after a barrier, all the block's threads add them
// up and run the epilogue, a pair each (kMaySplit; without it no product
// splits). Every thread of the block calls it.
template <int kRT, bool kMaySplit, int kDepth, typename Epilogue>
__device__ __forceinline__ void product(const bf16* a, int lda, int row_tiles, const Weights& wt,
                                        uint4 (&ring)[kDepth], bool prefetched, float* scratch,
                                        int scratch_floats, Epilogue epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;           // fragment row group
  const int c = lane & 3;            // fragment column pair
  const Cols cols = wt.cols;
  const int split = kMaySplit ? split_of(wt, row_tiles, scratch_floats) : 1;
  const int part_nk = wt.nk / split;
  // this lane's ldmatrix row pointer into the first row tile
  const bf16* a0 = a + (lane & 15) * lda + (lane >> 4) * 8;
  float acc[kRT][2][4];              // [row tile][n8 tile][fragment]

  for (int item = warp; item < cols.n * split; item += kWarps) {
    const int j = item % cols.n;
    const int part = item / cols.n;
    const uint4* wp = item_weights(wt, split, item);
    const bf16* ap = a0 + 16 * part * part_nk;
#pragma unroll
    for (int rt = 0; rt < kRT; ++rt) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[rt][e >> 2][e & 3] = 0.f;
    }
    if (!prefetched || item != warp) {
#pragma unroll
      for (int dd = 0; dd < kDepth; ++dd) {
        if (dd < part_nk) ring[dd] = __ldg(wp + dd * 32);
      }
    }
    for (int kb = 0; kb < part_nk; kb += kDepth) {
#pragma unroll
      for (int dd = 0; dd < kDepth; ++dd) {
        const int ks = kb + dd;
        if (ks < part_nk) {
          const uint4 b = ring[dd];
          if (ks + kDepth < part_nk) ring[dd] = __ldg(wp + (ks + kDepth) * 32);
#pragma unroll
          for (int rt = 0; rt < kRT; ++rt) {
            if (rt < row_tiles) {      // the same for every thread of the block
              unsigned af[4];
              ldmatrix_x4(af, ap + rt * 16 * lda + 16 * ks);
              mma_bf16(acc[rt][0], af, b.x, b.y);
              mma_bf16(acc[rt][1], af, b.z, b.w);
            }
          }
        }
      }
    }
    const int nb = cols.block(j);
#pragma unroll
    for (int rt = 0; rt < kRT; ++rt) {
      if (rt < row_tiles) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!kMaySplit || split == 1) {
              epi(16 * rt + g + 8 * h, 16 * nb + 8 * jj + 2 * c, acc[rt][jj][2 * h],
                  acc[rt][jj][2 * h + 1]);
            } else {
              // partial sums as pairs: [part][j][row tile][row][column pair]
              *reinterpret_cast<float2*>(
                  scratch + (((part * cols.n + j) * row_tiles + rt) * 16 + g + 8 * h) * 16 +
                  8 * jj + 2 * c) = make_float2(acc[rt][jj][2 * h], acc[rt][jj][2 * h + 1]);
            }
          }
        }
      }
    }
  }
  if (kMaySplit && split > 1) {
    __syncthreads();
    const int pairs = cols.n * row_tiles * 16 * 8;
    const int per_part = pairs * 2;
    for (int i = threadIdx.x; i < pairs; i += kThreads) {
      const int cp = i & 7;          // column pair of the block's 16
      const int r = (i >> 3) % (16 * row_tiles);
      const int j = (i >> 3) / (16 * row_tiles);
      const float* src = scratch + ((j * row_tiles * 16 + r) * 8 + cp) * 2;
      float2 v = *reinterpret_cast<const float2*>(src);
      for (int part = 1; part < split; ++part) {
        const float2 q = *reinterpret_cast<const float2*>(src + part * per_part);
        v.x += q.x;
        v.y += q.y;
      }
      epi(r, 16 * cols.block(j) + 2 * cp, v.x, v.y);
    }
  }
}

template <int kRT, int kDepth, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
fused_encoder_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const bf16* __restrict__ w, const float* __restrict__ vec, EncPlan s,
                     long long* __restrict__ clocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = s.d, m = s.m;
  const int dh = d / s.heads;
  const int rows = 16 * s.row_tiles;
  const int ld_r = d + kPad;         // the residual (f32), LN out and attention out (bf16)
  const int ld_q = s.ld_q, ld_u = s.ld_u;
  float* const resid = reinterpret_cast<float*>(smem);
  bf16* const ybuf = reinterpret_cast<bf16*>(smem + s.off_y);
  bf16* const abuf = reinterpret_cast<bf16*>(smem + s.off_a);
  float* const qbuf = reinterpret_cast<float*>(smem + s.off_q);
  bf16* const ubuf = reinterpret_cast<bf16*>(smem + s.off_u);
  float* const scratch = reinterpret_cast<float*>(smem + s.off_s);
  float* const rows_s = reinterpret_cast<float*>(smem + s.off_v);
  const int n_scr = s.scratch_floats;

  // weights, each in fragment order, end to end: Wqkv, Wproj, W1, W2
  const bf16* const w_qkv = w;
  const bf16* const w_proj = w_qkv + static_cast<long long>(d) * 3 * d;
  const bf16* const w_mlp1 = w_proj + static_cast<long long>(d) * d;
  const bf16* const w_mlp2 = w_mlp1 + static_cast<long long>(d) * m;
  // f32 rows in device memory, end to end: g1, b1, bqkv, bproj, g2, b2, bm1,
  // bm2. With s.staged >= 1 the LayerNorm rows are staged in shared memory as
  // g1, b1, g2, b2, and with 2 the biases after them as bqkv, bproj, bm1, bm2.
  const bool ln_s = s.staged >= 1, bias_s = s.staged >= 2;
  const float* const ln1_g = ln_s ? rows_s : vec;
  const float* const ln1_b = ln1_g + d;
  const float* const ln2_g = ln_s ? rows_s + 2 * d : vec + 6 * d;
  const float* const ln2_b = ln2_g + d;
  const float* const b_qkv = bias_s ? rows_s + 4 * d : vec + 2 * d;
  const float* const b_proj = b_qkv + 3 * d;
  const float* const b_mlp1 = bias_s ? b_proj + d : vec + 8 * d;
  const float* const b_mlp2 = b_mlp1 + m;

  // with clocks, thread 0 of each block times the phases (kPhases a block)
  long long t_last = 0;
  auto lap = [&](int phase) {
    if (clocks != nullptr && threadIdx.x == 0) {
      const long long now = clock64();
      if (phase > 0) {
        clocks[static_cast<long long>(blockIdx.x) * kPhases + phase - 1] = now - t_last;
      }
      t_last = now;
    }
  };
  lap(0);

  const int peers = kSplit ? s.cluster : 1;
  const int rank = kSplit ? static_cast<int>(cluster_ctarank()) : 0;
  const int nk_d = d / 16;
  const int mine = s.heads / peers;
  const int hb = mine * dh / 16;
  const int nd = nk_d / peers;
  const int nm = m / 16 / peers;
  // Small: three mbarriers, on which the other blocks' parts of a, h and u
  // land; each expects its bytes from the start. Every block of the cluster
  // has started and set them up before any copy into another's shared
  // memory (the first are attention's).
  const unsigned bars = smem_u32(smem + s.off_b);
  const unsigned bar_a = bars, bar_h = bars + 8, bar_u = bars + 16;
  if constexpr (kSplit) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
      mbar_init_fence();
      const unsigned in_rows = (peers - 1) * rows;
      mbar_arrive_expect_tx(bar_a, in_rows * hb * 32);
      mbar_arrive_expect_tx(bar_h, in_rows * nd * 64);
      mbar_arrive_expect_tx(bar_u, in_rows * nm * 32);
    }
    cluster_arrive();
  }
  // This block's part of a buffer [rows] x `bytes` (row pitch `pitch`) to the
  // same place in every other block of the cluster, a bulk copy a row and
  // block, which completes on the receiver's barrier `bar`. The threads that
  // wrote the part fence it for the copies' (asynchronous) proxy first.
  auto send = [&](const void* part, int pitch, int bytes, unsigned bar) {
    fence_proxy_async_smem();
    __syncthreads();
    const unsigned src = smem_u32(part);
    for (int i = threadIdx.x; i < (peers - 1) * rows; i += kThreads) {
      const unsigned q = (rank + 1 + i / rows) % peers;
      const unsigned at = src + (i % rows) * pitch;
      bulk_copy_s2c(cluster_map(at, q), at, bytes, cluster_map(bar, q));
    }
  };

  // This block's columns of every product: its heads' q, k and v (three runs
  // of mine * dh columns, d apart), d / C columns of the projection and of
  // W2, m / C of W1.
  const Weights wt_qkv{w_qkv, nk_d, Cols{3 * hb, hb, nk_d, rank * hb}};
  const Weights wt_proj{w_proj, nk_d, Cols{nd, nd, 0, rank * nd}};
  const Weights wt_mlp1{w_mlp1, nk_d, Cols{nm, nm, 0, rank * nm}};
  const Weights wt_mlp2{w_mlp2, m / 16, Cols{nd, nd, 0, rank * nd}};
  // Small: each product's first weights are asked for ahead of the phase
  // before it, so that they fly across its barriers. (The large shape has
  // no registers to spare for that, and its blocks overlap one another.)
  uint4 ring[kDepth];
  const int tile = static_cast<int>(blockIdx.x) / peers;
  const int win0 = tile * s.windows;
  const int n_win = min(s.windows, s.batch - win0);
  const int valid = n_win * s.t;                 // rows that are loaded and stored
  const long long base = static_cast<long long>(win0) * s.t * d;
  const int d4 = d / 4;

  // Stage the tile of x into resid, zero-filled past the valid rows, and the
  // f32 rows into shared memory.
  // (All of a thread's loads of a round are asked for before its stores.)
  {
    constexpr int kX = 4, kV = 8;     // loads in flight a thread
    const float4* xs = reinterpret_cast<const float4*>(x + base);
    for (int i0 = 0; i0 < rows * d4; i0 += kX * kThreads) {
      float4 v[kX];
#pragma unroll
      for (int k = 0; k < kX; ++k) {
        const int i = i0 + k * kThreads + threadIdx.x;
        v[k] = i < valid * d4 ? __ldg(xs + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      // q/k/v's first weights queue behind the first of x, not ahead of it
      if constexpr (kSplit) {
        if (i0 == 0) prefetch(ring, wt_qkv, s.row_tiles, n_scr);
      }
#pragma unroll
      for (int k = 0; k < kX; ++k) {
        const int i = i0 + k * kThreads + threadIdx.x;
        if (i < rows * d4) {
          *reinterpret_cast<float4*>(resid + (i / d4) * ld_r + 4 * (i % d4)) = v[k];
        }
      }
    }
    // staged: g1 b1 g2 b2 | bqkv bproj bm1 bm2 (device: g1 b1 bqkv bproj g2 b2 bm1 bm2)
    const int n_rows = s.staged == 2 ? 9 * d + m : s.staged == 1 ? 4 * d : 0;
    for (int i0 = 0; i0 < n_rows; i0 += kV * kThreads) {
      float v[kV];
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        const int i = i0 + k * kThreads + threadIdx.x;
        const int src = i < 2 * d ? i : i < 4 * d ? i + 4 * d : i < 8 * d ? i - 2 * d : i;
        v[k] = i < n_rows ? __ldg(vec + src) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        const int i = i0 + k * kThreads + threadIdx.x;
        if (i < n_rows) rows_s[i] = v[k];
      }
    }
  }
  __syncthreads();
  layernorm_rows(resid, ld_r, rows, d, ln1_g, ln1_b, ybuf, ld_r);
  __syncthreads();
  lap(1);

  // q/k/v of this block's heads, [q | k | v] each head-major, q scaled
  {
    const float scale = s.q_scale;
    const int gw = mine * dh;
    const int q0 = rank * gw;
    product<kRT, kSplit>(ybuf, ld_r, s.row_tiles, wt_qkv, ring, kSplit, scratch, n_scr,
                 [=](int r, int n, float v0, float v1) {
                   v0 += b_qkv[n];
                   v1 += b_qkv[n + 1];
                   if (n < d) {   // q: scaled after the bias, in f32
                     v0 *= scale;
                     v1 *= scale;
                   }
                   // n = part * d + q0 + i  ->  local column part * gw + i
                   const int part = n / d;
                   *reinterpret_cast<float2*>(qbuf + r * ld_q + part * gw + n - part * d - q0) =
                       make_float2(v0, v1);
                 });
  }
  if constexpr (kSplit) prefetch(ring, wt_proj, s.row_tiles, n_scr);
  __syncthreads();
  lap(2);
  if constexpr (kSplit) cluster_wait();
  attention_any_t(qbuf, ld_q, s.t, dh, mine, s.windows, abuf, ld_r, rank * mine);
  lap(3);
  if constexpr (kSplit) {                        // a, from every block
    send(abuf + rank * mine * dh, ld_r * 2, hb * 32, bar_a);
    mbar_wait(bar_a, 0);
  } else {
    __syncthreads();
  }
  lap(4);

  // h = x + a Wproj + bproj: this block's columns
  product<kRT, kSplit>(abuf, ld_r, s.row_tiles, wt_proj, ring, kSplit, scratch, n_scr,
                       [=](int r, int n, float v0, float v1) {
                         float2* at = reinterpret_cast<float2*>(resid + r * ld_r + n);
                         float2 hv = *at;
                         hv.x += v0 + b_proj[n];
                         hv.y += v1 + b_proj[n + 1];
                         *at = hv;
                       });
  lap(5);
  if constexpr (kSplit) {                        // h, from every block
    send(resid + rank * nd * 16, ld_r * 4, nd * 64, bar_h);
    prefetch(ring, wt_mlp1, s.row_tiles, n_scr);
    mbar_wait(bar_h, 0);
  } else {
    __syncthreads();
  }
  lap(6);

  layernorm_rows(resid, ld_r, rows, d, ln2_g, ln2_b, ybuf, ld_r);
  __syncthreads();
  lap(7);

  // u = gelu(y W1 + bm1): this block's columns
  product<kRT, kSplit>(ybuf, ld_r, s.row_tiles, wt_mlp1, ring, kSplit, scratch, n_scr,
                       [=](int r, int n, float v0, float v1) {
                         v0 = gelu_tanh(v0 + b_mlp1[n]);
                         v1 = gelu_tanh(v1 + b_mlp1[n + 1]);
                         *reinterpret_cast<__nv_bfloat162*>(ubuf + r * ld_u + n) =
                             __floats2bfloat162_rn(v0, v1);
                       });
  lap(8);
  if constexpr (kSplit) {                        // u, from every block
    send(ubuf + rank * nm * 16, ld_u * 2, nm * 32, bar_u);
    prefetch(ring, wt_mlp2, s.row_tiles, n_scr);
    mbar_wait(bar_u, 0);
    // this block has all it was sent; the others may end once every block
    // has, when no copy reads their shared memory any more
    cluster_arrive_relaxed();
  } else {
    __syncthreads();
  }
  lap(9);

  // out = h + u W2 + bm2: this block's columns, straight to device memory
  float* const dst = out + base;
  product<kRT, kSplit>(ubuf, ld_u, s.row_tiles, wt_mlp2, ring, kSplit, scratch, n_scr,
               [=](int r, int n, float v0, float v1) {
                 if (r < valid) {
                   const float2 hv = *reinterpret_cast<const float2*>(resid + r * ld_r + n);
                   *reinterpret_cast<float2*>(dst + r * d + n) =
                       make_float2(hv.x + v0 + b_mlp2[n], hv.y + v1 + b_mlp2[n + 1]);
                 }
               });
  lap(10);
  if constexpr (kSplit) cluster_wait();
}

template <int kRT, int kDepth, bool kSplit>
cudaError_t launch(const EncPlan& s, size_t smem, const float* x, float* out, const bf16* w,
                   const float* vec, long long* clocks, cudaStream_t stream) {
  auto kernel = fused_encoder_kernel<kRT, kDepth, kSplit>;
  const cudaError_t err = ensure_dynamic_smem<FusedEncoderTag<kRT, kSplit>>(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (s.batch + s.windows - 1) / s.windows;
  return launch_cluster(kernel, tiles * s.cluster, kThreads, s.cluster, smem, stream, x, out, w,
                        vec, s, clocks);
}


// ---- the pair shape: two blocks of a cluster share one weight stream ----

// Its layout at d = 256 (fused_encoder.py::_pair_layout is the same):
// offsets in bytes, strides in elements.
constexpr int kFD = 256;                       // the width the pair shape takes
constexpr int kFRows = 32;                     // a block's row tile
constexpr int kFMaxT = 16;                     // frames a window
constexpr int kFLdR = kFD + 4;                 // f32 residual [rows][d]
constexpr int kFLdY = kFD + kPad;              // bf16 LayerNorm / attention output
constexpr int kFLdQ = 3 * kFD + 4;             // f32 q/k/v
using FwdRing = WeightRing<2, 4>;              // two slots of 4 k-steps (32 KB), one a group
constexpr int kFOffR = 0;                                       // x, then h
constexpr int kFOffY = kFOffR + kFRows * kFLdR * 4;             // y1, a, y2
constexpr int kFOffQ = kFOffY + kFRows * kFLdY * 2;             // q/k/v; u, the next x
constexpr int kFOffRing = kFOffQ + kFRows * kFLdQ * 4;          // the ring's slots
constexpr int kFOffBar = kFOffRing + FwdRing::kSlots * FwdRing::kSlotBytes;   // full, empty, x
constexpr int kFSmem = kFOffBar + (2 * FwdRing::kSlots + 1) * 8;
// the widest MLP whose hidden [rows][m + 8] (bf16) leaves room for the next
// tile's x [rows][d] (f32) in q/k/v's place
constexpr int kFMaxM = ((kFRows * kFLdQ - kFRows * kFD) * 4 / (kFRows * 2) - kPad) / 512 * 512;
constexpr int kPairPlanInts = 7;
constexpr int kPairThreads = kThreads + 128;   // 4 consumer warpgroups and the producer's
constexpr int kGroupWarps = kWarps / 2;        // consumer warps that read a fill
// Registers a thread after setmaxnreg: the producer warpgroup gives what the
// consumers take, within the block's 640 x 96 (ptxas's launch count).
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 112;
static_assert(4 * kProducerRegs + 16 * kConsumerRegs <= 20 * 96, "setmaxnreg over budget");
static_assert(kFSmem <= kMaxSmem, "the pair shape's layout exceeds shared memory");
static_assert(kFOffRing % 128 == 0, "the ring's slots must be aligned for bulk copies");
// Phases the pair shape's cycle counters time, summed over a block's tiles,
// and last the cycles its warp 0 waited for weights within them.
constexpr int kPairPhases = 8;

struct FusedEncoderPairTag {};

struct PairShape {
  int batch, t, m, heads, windows;
  float q_scale;
};

// LayerNorm of the tile's rows of src (f32, stride ld_src; rows from
// `valid` on read as zeros) into dst (bf16, stride kFLdY), a warp a row held
// in registers, which also go to `copy` (f32, stride kFLdR) unless it is
// null; the sums in layernorm_rows's order, so the results are its own.
__device__ __forceinline__ void pair_layernorm(const float* src, int ld_src, int valid,
                                               float* copy, bf16* dst,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  constexpr float inv_d = 1.f / kFD;
  for (int r = threadIdx.x >> 5; r < kFRows; r += kWarps) {
    float v[kFD / 32];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kFD / 32; ++i) {
      v[i] = r < valid ? src[r * ld_src + lane + 32 * i] : 0.f;
      if (copy != nullptr) copy[r * kFLdR + lane + 32 * i] = v[i];
      sum += v[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kFD / 32; ++i) sq = fmaf(v[i] - mean, v[i] - mean, sq);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rs = rsqrtf(sq * inv_d + kLnEps);
#pragma unroll
    for (int i = 0; i < kFD / 32; ++i) {
      const int col = lane + 32 * i;
      dst[r * kFLdY + col] =
          __float2bfloat16((v[i] - mean) * rs * __ldg(scale + col) + __ldg(bias + col));
    }
  }
}

// The producer warp: the weights every tile multiplies by, fill by fill, in
// the order the consumers take them (fused_encoder.py::pair_stream): the
// fills alternate between the two groups of consumer warps, so q and k, and
// two W1 column groups at a time, go interleaved, a group each; v, the
// projection and W2 go in order, every other fill to a group.
__device__ __forceinline__ void pair_produce(const bf16* w, int m, int tiles, FwdRing::Writer wr) {
  constexpr int kKs = FwdRing::kKs;
  const bf16* const w_qkv = w;
  const bf16* const w_proj = w_qkv + 3LL * kFD * kFD;
  const bf16* const w_mlp1 = w_proj + 1LL * kFD * kFD;
  const bf16* const w_mlp2 = w_mlp1 + 1LL * kFD * m;
  auto both = [&](const bf16* src, int b0) {    // column groups b0 and b0 + 16, interleaved
    for (int ks = 0; ks < 16; ks += kKs) {
      wr.put(src, 16, b0, ks);
      wr.put(src, 16, b0 + 16, ks);
    }
  };
  for (int tile = 0; tile < tiles; ++tile) {
    both(w_qkv, 0);                               // q, k
    wr.put_all(w_qkv, 16, 32, 0, 16);             // v
    wr.put_all(w_proj, 16, 0, 0, 16);
    for (int c0 = 0; c0 < m; c0 += 512) both(w_mlp1, c0 / 16);
    wr.put_all(w_mlp2, m / 16, 0, 0, m / 16);
  }
}

// acc = A (32 rows, bf16 in shared memory, stride lda) x the next n_fills
// fills of this warp's group: its j-th holds k-steps kKs (j kstride + koff)
// .. + kKs - 1 of A (kstride 1: the group's own column group; 2: every other
// fill of a product the two groups split). The warp takes column blocks
// 2 wg and 2 wg + 1 of each fill (wg: its place in the group) for both row
// tiles, and gives the slot back as soon as the weights are in registers.
// acc[rt][cb][n8][e]: row 16 rt + g (+ 8 for e >= 2), column 16 (2 wg + cb) +
// 8 n8 + 2 c (+ 1 for odd e).
__device__ __forceinline__ void group_mma(FwdRing::Reader& r, const bf16* a, int lda,
                                          int n_fills, int kstride, int koff,
                                          float (&acc)[2][2][2][4], long long* waited) {
  constexpr int kKs = FwdRing::kKs;
  const int lane = threadIdx.x & 31;
  const int wg = (threadIdx.x >> 5) % kGroupWarps;
  const bf16* const a0 = a + (lane & 15) * lda + (lane >> 4) * 8;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i >> 4][(i >> 3) & 1][(i >> 2) & 1][i & 3] = 0.f;
  for (int j = 0; j < n_fills; ++j) {
    const uint4* w = r.take(waited) + 2 * wg * kKs * 32 + lane;
    uint4 b[2][kKs];
#pragma unroll
    for (int cb = 0; cb < 2; ++cb) {
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks) b[cb][ks] = w[(cb * kKs + ks) * 32];
    }
    r.give();
    const bf16* const aj = a0 + 16 * kKs * (j * kstride + koff);
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        unsigned af[4];
        ldmatrix_x4(af, aj + rt * 16 * lda + 16 * ks);
#pragma unroll
        for (int cb = 0; cb < 2; ++cb) {
          mma_bf16(acc[rt][cb][0], af, b[cb][ks].x, b[cb][ks].y);
          mma_bf16(acc[rt][cb][1], af, b[cb][ks].z, b[cb][ks].w);
        }
      }
    }
  }
}

// epi(row, column of the group's 256, v0, v1) for every pair of neighbouring
// sums of acc (group_mma's layout) once.
template <typename Epilogue>
__device__ __forceinline__ void each_pair(const float (&acc)[2][2][2][4], Epilogue epi) {
  const int lane = threadIdx.x & 31;
  const int wg = (threadIdx.x >> 5) % kGroupWarps;
  const int r0 = lane >> 2, n0 = 32 * wg + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int rt = i >> 3, cb = (i >> 2) & 1, n8 = (i >> 1) & 1, hh = i & 1;
    epi(16 * rt + r0 + 8 * hh, n0 + 16 * cb + 8 * n8, acc[rt][cb][n8][2 * hh],
        acc[rt][cb][n8][2 * hh + 1]);
  }
}

// The pair shape at d = 256: clusters of two blocks, each block its own
// tile of 32 rows (whole windows) with all the columns, the pair walking
// over pairs of tiles; one stream of weights feeds both blocks. The order
// and the arithmetic are the other shapes'; padding rows and windows past
// the batch hold zeros, run through the same arithmetic and are never
// stored.
__global__ void __launch_bounds__(kPairThreads, 1)
fused_encoder_kernel_pair(const float* __restrict__ x, float* __restrict__ out,
                          const bf16* __restrict__ w, const float* __restrict__ vec, PairShape s,
                          long long* __restrict__ clocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(cluster_ctarank());
  const int t = s.t, m = s.m;
  const int n_pairs = ((s.batch + s.windows - 1) / s.windows + 1) / 2;
  const int cluster = static_cast<int>(blockIdx.x) / 2, clusters = static_cast<int>(gridDim.x) / 2;
  const int tiles = cluster < n_pairs ? (n_pairs - 1 - cluster) / clusters + 1 : 0;
  const unsigned full = smem_u32(smem + kFOffBar);
  const unsigned empty = full + 8 * FwdRing::kSlots;
  long long* const clk =
      clocks != nullptr && threadIdx.x == 0 ? clocks + blockIdx.x * kPairPhases : nullptr;

  const unsigned xbar = empty + 8 * FwdRing::kSlots;   // the next tile's x has landed
  if (threadIdx.x == 0) {
    FwdRing::init(full, empty, kGroupWarps);
    mbar_init(xbar, 1);
  }
  if (clk != nullptr) {
    for (int i = 0; i < kPairPhases; ++i) clk[i] = 0;
  }
  cluster_sync_all();

  if (warp >= kWarps) {                         // the producer warpgroup: one warp copies
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kWarps) {
      pair_produce(w, m, tiles,
                   FwdRing::Writer{smem_u32(smem + kFOffRing), full, empty, rank, 0, 0});
    }
    cluster_sync_all();
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // ---- the consumers ----
  long long t_last = 0, waited = 0;
  long long* const wait_at = clk != nullptr ? &waited : nullptr;
  auto lap = [&](int phase) {
    if (clk != nullptr) {
      const long long now = clock64();
      if (phase > 0) clk[phase - 1] += now - t_last;
      t_last = now;
    }
  };
  auto sync = [] { named_barrier_sync(1, kThreads); };
  // the two groups of consumer warps read alternate fills (the ring's two slots)
  const int group = warp / kGroupWarps;
  FwdRing::Reader rg{smem + kFOffRing, full, empty, cluster_map(empty, rank ^ 1), group, 0, 2};

  float* const resid = reinterpret_cast<float*>(smem + kFOffR);
  bf16* const ybuf = reinterpret_cast<bf16*>(smem + kFOffY);
  float* const qbuf = reinterpret_cast<float*>(smem + kFOffQ);
  bf16* const ubuf = reinterpret_cast<bf16*>(smem + kFOffQ);
  const int ld_u = m + kPad;
  // the next tile's x lands past the MLP hidden in q/k/v's place, once the
  // attention is done with them
  float* const xnext = reinterpret_cast<float*>(smem + kFOffQ + kFRows * ld_u * 2);
  // f32 rows in device memory, end to end: g1, b1, bqkv, bproj, g2, b2, bm1, bm2
  const float* const ln1_g = vec;
  const float* const ln1_b = ln1_g + kFD;
  const float* const b_qkv = ln1_b + kFD;
  const float* const b_proj = b_qkv + 3 * kFD;
  const float* const ln2_g = b_proj + kFD;
  const float* const ln2_b = ln2_g + kFD;
  const float* const b_mlp1 = ln2_b + kFD;
  const float* const b_mlp2 = b_mlp1 + m;
  constexpr int kKs = FwdRing::kKs;
  // The rows of this block's tile `it`: the first element and how many are
  // valid (none past the batch).
  auto tile_rows = [&](int it, long long& base, int& valid) {
    const int win0 = (2 * (cluster + it * clusters) + rank) * s.windows;
    valid = max(0, min(s.windows, s.batch - win0)) * t;
    base = static_cast<long long>(win0) * t * kFD;
  };
  // Thread 0 asks for tile it's valid rows of x (one bulk copy onto xbar).
  auto fetch_x = [&](int it) {
    if (threadIdx.x == 0) {
      long long from;
      int rows;
      tile_rows(it, from, rows);
      mbar_arrive_expect_tx(xbar, rows * kFD * 4);
      if (rows > 0) bulk_copy_g2s(smem_u32(xnext), x + from, rows * kFD * 4, xbar);
    }
  };
  if (tiles > 0) fetch_x(0);

  for (int it = 0; it < tiles; ++it) {
    lap(0);
    long long base;
    int valid;
    tile_rows(it, base, valid);
    // LN1 of the tile's x from where it landed (zero past the valid rows),
    // which goes to the residual on the way
    mbar_wait(xbar, it & 1);
    pair_layernorm(xnext, kFD, valid, resid, ybuf, ln1_g, ln1_b);
    sync();
    lap(1);

    float acc[2][2][2][4];
    // q (scaled; group 0) and k (group 1), f32
    group_mma(rg, ybuf, kFLdY, 16 / kKs, 1, 0, acc, wait_at);
    each_pair(acc, [&](int r, int n, float v0, float v1) {
      n += group * kFD;
      v0 += __ldg(b_qkv + n);
      v1 += __ldg(b_qkv + n + 1);
      if (group == 0) {                          // q: scaled after the bias
        v0 *= s.q_scale;
        v1 *= s.q_scale;
      }
      *reinterpret_cast<float2*>(qbuf + r * kFLdQ + n) = make_float2(v0, v1);
    });
    // v, every other fill a group: group 1's sums meet group 0's in place
    group_mma(rg, ybuf, kFLdY, 16 / kKs / 2, 2, group, acc, wait_at);
    if (group == 1) {
      each_pair(acc, [&](int r, int n, float v0, float v1) {
        *reinterpret_cast<float2*>(qbuf + r * kFLdQ + 2 * kFD + n) = make_float2(v0, v1);
      });
    }
    sync();
    if (group == 0) {
      each_pair(acc, [&](int r, int n, float v0, float v1) {
        float2* at = reinterpret_cast<float2*>(qbuf + r * kFLdQ + 2 * kFD + n);
        const float2 other = *at;
        *at = make_float2(other.x + v0 + __ldg(b_qkv + 2 * kFD + n),
                          other.y + v1 + __ldg(b_qkv + 2 * kFD + n + 1));
      });
    }
    sync();
    lap(2);
    attention_any_t(qbuf, kFLdQ, t, kFD / s.heads, s.heads, s.windows, ybuf, kFLdY, 0);
    sync();
    if (it + 1 < tiles) fetch_x(it + 1);         // q/k/v are dead: the next x may land
    lap(3);
    // h = x + a Wproj + bproj, every other fill a group: group 1's sums first
    group_mma(rg, ybuf, kFLdY, 16 / kKs / 2, 2, group, acc, wait_at);
    if (group == 1) {
      each_pair(acc, [&](int r, int n, float v0, float v1) {
        float2* at = reinterpret_cast<float2*>(resid + r * kFLdR + n);
        const float2 hv = *at;
        *at = make_float2(hv.x + v0, hv.y + v1);
      });
    }
    sync();
    if (group == 0) {
      each_pair(acc, [&](int r, int n, float v0, float v1) {
        float2* at = reinterpret_cast<float2*>(resid + r * kFLdR + n);
        const float2 hv = *at;
        *at = make_float2(hv.x + (v0 + __ldg(b_proj + n)), hv.y + (v1 + __ldg(b_proj + n + 1)));
      });
    }
    sync();
    lap(4);
    pair_layernorm(resid, kFLdR, kFRows, nullptr, ybuf, ln2_g, ln2_b);
    sync();
    lap(5);
    for (int c0 = 0; c0 < m; c0 += 2 * kFD) {    // u = gelu(y W1 + bm1), a column group a group
      group_mma(rg, ybuf, kFLdY, 16 / kKs, 1, 0, acc, wait_at);
      each_pair(acc, [&](int r, int n, float v0, float v1) {
        n += c0 + group * kFD;
        *reinterpret_cast<__nv_bfloat162*>(ubuf + r * ld_u + n) =
            __floats2bfloat162_rn(gelu_tanh(v0 + __ldg(b_mlp1 + n)),
                                  gelu_tanh(v1 + __ldg(b_mlp1 + n + 1)));
      });
    }
    sync();
    lap(6);
    // out = h + u W2 + bm2, the valid rows; every other fill a group, group
    // 1's sums first into h
    group_mma(rg, ubuf, ld_u, m / 16 / kKs / 2, 2, group, acc, wait_at);
    if (group == 1) {
      each_pair(acc, [&](int r, int n, float v0, float v1) {
        float2* at = reinterpret_cast<float2*>(resid + r * kFLdR + n);
        const float2 hv = *at;
        *at = make_float2(hv.x + v0, hv.y + v1);
      });
    }
    sync();
    if (group == 0) {
      float* const dst = out + base;
      each_pair(acc, [&](int r, int n, float v0, float v1) {
        if (r < valid) {
          const float2 hv = *reinterpret_cast<const float2*>(resid + r * kFLdR + n);
          *reinterpret_cast<float2*>(dst + r * kFD + n) =
              make_float2(hv.x + v0 + __ldg(b_mlp2 + n), hv.y + v1 + __ldg(b_mlp2 + n + 1));
        }
      });
    }
    sync();                                      // h read: the next tile may stage x
    lap(7);
  }
  if (clk != nullptr) clk[kPairPhases - 1] = waited;
  cluster_sync_all();
}

}  // namespace

extern "C" {

// x, out [batch, t, d] f32, contiguous, 16-byte aligned; w: the four bf16
// weights in fragment order, end to end (Wqkv [d, 3d], Wproj [d, d], W1 [d, m],
// W2 [m, d]); vec: the f32 rows end to end (g1, b1, bqkv, bproj, g2, b2, bm1,
// bm2) (fused_encoder.py::pack_encoder_params). plan: the fifteen ints of
// fused_encoder.py::plan_encoder (small, cluster, row_tiles, windows, ld_q,
// ld_u, off_y, off_a, off_q, off_u, off_s, scratch_floats, off_v, staged,
// off_b); smem: its bytes of shared memory. clocks: null, or room for
// kPhases int64 a block, which get each phase's cycles (thread 0's clock64).
// Launches on `stream` and returns the launch's error (0 on success).
int ib_fused_encoder_forward(const void* x, int batch, int t, int d, int m, int heads,
                             const void* w, const void* vec, void* out, const int* plan,
                             int smem, void* clocks, void* stream) {
  if (batch < 1 || t < 1 || t > kMaxT || d < 128 || d % 128 != 0 || m < 128 ||
      m % 128 != 0 || heads < 1 || d % heads != 0 || (d / heads) % 2 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool small = plan[0] != 0;
  EncPlan s{};
  s.batch = batch;
  s.t = t;
  s.d = d;
  s.m = m;
  s.heads = heads;
  s.cluster = plan[1];
  s.row_tiles = plan[2];
  s.windows = plan[3];
  s.ld_q = plan[4];
  s.ld_u = plan[5];
  s.off_y = plan[6];
  s.off_a = plan[7];
  s.off_q = plan[8];
  s.off_u = plan[9];
  s.off_s = plan[10];
  s.scratch_floats = plan[11];
  s.off_v = plan[12];
  s.staged = plan[13];
  s.off_b = plan[14];
  const int dh = d / heads;
  s.q_scale = 1.f / sqrtf(static_cast<float>(dh));
  const int rows = 16 * s.row_tiles;
  const int gw = heads / (s.cluster > 0 ? s.cluster : 1) * dh;   // q columns of a block
  const bool ok =
      s.row_tiles >= 1 && s.row_tiles <= kRowTiles && s.windows >= 1 && s.windows * t <= rows &&
      s.cluster >= 1 && s.cluster <= kMaxCluster && (small || s.cluster == 1) &&
      heads % s.cluster == 0 && gw % 16 == 0 && (d / 16) % s.cluster == 0 &&
      (m / 16) % s.cluster == 0 && s.ld_q >= 3 * gw && s.ld_q % 2 == 0 && s.ld_u >= m &&
      s.ld_u % 8 == 0 && s.scratch_floats >= 0 && smem <= kMaxSmem &&
      s.off_y >= rows * (d + kPad) * 4 && s.off_y % 16 == 0 && s.off_a % 16 == 0 &&
      s.off_q % 16 == 0 && s.off_u % 16 == 0 && s.off_s % 16 == 0 &&
      s.off_y + rows * (d + kPad) * 2 <= smem && s.off_a + rows * (d + kPad) * 2 <= smem &&
      s.off_q + rows * s.ld_q * 4 <= smem && s.off_u + rows * s.ld_u * 2 <= smem &&
      s.off_s + s.scratch_floats * 4 <= smem && s.off_v % 16 == 0 && s.staged >= 0 &&
      s.staged <= 2 && s.off_v + (s.staged == 2 ? 9 * d + m : s.staged * 4 * d) * 4 <= smem &&
      (!small || (s.off_b % 8 == 0 && s.off_b + 24 <= smem));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const bf16* wb = static_cast<const bf16*>(w);
  const float* vf = static_cast<const float*>(vec);
  long long* cl = static_cast<long long*>(clocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one window (one row tile) has an instantiation of its own: the chain of
  // a lone window runs a third of the code and keeps its registers
  const cudaError_t err =
      !small                ? launch<kRowTiles, 8, false>(s, smem, xf, of, wb, vf, cl, st)
      : s.row_tiles == 1    ? launch<1, 8, true>(s, smem, xf, of, wb, vf, cl, st)
                            : launch<kRowTiles, 8, true>(s, smem, xf, of, wb, vf, cl, st);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The same layer through the pair shape (d = 256, at most 16 frames, a head
// width of 16, 32 or 64, m 512 or 1024): clusters of two
// blocks, a 32-row tile a block, one stream of weights into both
// (fused_encoder.py::plan_encoder). plan: the seven ints of
// EncoderPlan.as_ints (windows, off_y, off_q, off_ring, off_b, slot_bytes,
// slots), which must be this file's layout; smem: its bytes. grid: an even
// number of blocks, at most one pair a pair of tiles. clocks: null, or room
// for kPairPhases int64 a block, which get the block's cycles by phase over
// its tiles. Launches on `stream` and returns the launch's error (0 on
// success).
int ib_fused_encoder_forward_pair(const void* x, int batch, int t, int d, int m, int heads,
                                  const void* w, const void* vec, void* out, const int* plan,
                                  int smem, int grid, void* clocks, void* stream) {
  if (batch < 1 || t < 1 || t > kFMaxT || d != kFD || m < 512 || m % 512 != 0 || m > kFMaxM ||
      (heads != 4 && heads != 8 && heads != 16) || plan == nullptr || smem != kFSmem ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int layout[kPairPlanInts] = {kFRows / t, kFOffY,   kFOffQ,         kFOffRing,
                                     kFOffBar,   FwdRing::kSlotBytes, FwdRing::kSlots};
  for (int i = 0; i < kPairPlanInts; ++i) {
    if (plan[i] != layout[i]) return static_cast<int>(cudaErrorInvalidValue);
  }
  const PairShape s{batch, t, m, heads, kFRows / t, 1.f / sqrtf(static_cast<float>(d / heads))};
  const int n_pairs = ((batch + s.windows - 1) / s.windows + 1) / 2;
  if (grid < 2 || grid % 2 != 0 || grid / 2 > n_pairs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = ensure_dynamic_smem<FusedEncoderPairTag>(fused_encoder_kernel_pair, kFSmem);
  if (err == cudaSuccess) {
    err = launch_cluster(fused_encoder_kernel_pair, grid, kPairThreads, 2, kFSmem, st,
                         static_cast<const float*>(x), static_cast<float*>(out),
                         static_cast<const bf16*>(w), static_cast<const float*>(vec), s,
                         static_cast<long long*>(clocks));
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
