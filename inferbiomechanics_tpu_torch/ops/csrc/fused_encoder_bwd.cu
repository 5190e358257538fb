// Backward of the fused pre-LN transformer encoder layer for Hopper (sm_90a),
// bound to Python through a plain C interface (ctypes; see ../_build.py and
// ../fused_encoder.py).
//
// Replaces inferbiomechanics_tpu/ops/pallas_encoder.py::encoder_layer_bwd_pallas
// (kernel _encoder_bwd_kernel -> _encoder_bwd_math). From x and the upstream
// gradient g (both [B, T, d] f32) and the layer's 12 parameters it recomputes
// the forward that fused_encoder.cu computes and applies the hand-derived
// VJP: dx [B, T, d] f32 and the 12 parameter gradients, f32, summed over the
// whole batch. Matrix operands are bf16, sums f32, as in the forward:
//
//   recompute  y1 = bf16(LN1(x)); qkv = y1 Wqkv + bqkv; P = softmax(q k^T);
//              a = bf16(P v); h2 = x + a Wproj + bproj; y2 = bf16(LN2(h2));
//              z1 = y2 W1 + bm1; u = bf16(gelu(z1))
//   MLP        dW2 = u^T bf16(g); dbm2 = sum g; dz1 = (bf16(g) W2^T) gelu'(z1);
//              dW1 = y2^T bf16(dz1); dbm1 = sum dz1; dy2 = bf16(dz1) W1^T
//   LN2        dh2 = g + LN2'(dy2); dg2 = sum dy2 xhat2; db2 = sum dy2
//   proj       dWproj = a^T bf16(dh2); dbproj = sum dh2; da = bf16(dh2) Wproj^T
//   attention  dv_j = sum_i P_ij da_i; dp_ij = da_i . v_j;
//              dS = P (dp - sum_j P dp); dk_j = sum_i dS_ij q_i;
//              dq_i = dh^-0.5 sum_j dS_ij k_j          (q carries the scale)
//   qkv        dWqkv = y1^T bf16(dqkv); dbqkv = sum dqkv; dy1 = bf16(dqkv) Wqkv^T
//   LN1        dx = dh2 + LN1'(dy1); dg1 = sum dy1 xhat1; db1 = sum dy1
//
// Design: three launches a layer, every sum in a fixed order, so two calls on
// the same inputs give bitwise equal results (no floating-point atomics).
// The tile kernel has three shapes, which fused_encoder.py::plan_encoder_bwd
// picks from the call's shape; the two launches after it are the same for
// all of them.
//
// 1. The tile kernel recomputes the forward of a tile of whole windows and
//    runs the VJP: dx, and the row operands of the four weight gradients
//    (y1, dqkv, a, dh2, y2, dz1, u, g as bf16) into a workspace in device
//    memory; the eight vector gradients are summed over the tile's rows into
//    the block's own slab of partial sums. The transposes are packed beside
//    the weights (fused_encoder.py::pack_encoder_params).
//    small (encoder_bwd_tile_kernel_cluster): up to BWD_SMALL_BATCH_MAX
//      windows a cluster of C blocks (8 at d = 256, H = 8) shares a row tile
//      of 1..3 mma row tiles (one window: one row tile, an instantiation of
//      its own). Block `rank` owns heads rank H/C .., the columns rank d/C ..
//      of every d-wide output (the same columns of q, k and v) and rank m/C
//      .. of the hidden ones, and streams only those weights from L2 into
//      registers in mma fragment order, 1/C of each (320 KB a block at d =
//      256): attention stays in the block; dz1 splits by W2^T's and W1's
//      hidden columns, so no block needs another's u or gelu'. Six
//      exchanges hand what the next phase reads to every block -- a, h2,
//      dz1, dy2, dqkv and dy1 -- by one bulk copy a row (three for dqkv) and
//      peer from shared memory into shared memory, completing on an mbarrier
//      of the receiver; the LayerNorms and their VJPs run on full rows in
//      every block. Each product's items (column blocks, and parts of K
//      where there are fewer blocks than warps) go to the 16 warps; partial
//      sums meet in shared memory and are added in a fixed order. Buffers
//      share room only where the order of the exchanges keeps them apart in
//      time (the plan's layout).
//    pair (encoder_bwd_tile_kernel_pair): from BWD_PAIR_BATCH_MIN windows at
//      d = 256 (T <= 16, heads 16, 32 or 64 wide, m whole chunks of 256),
//      clusters of two blocks walk over pairs of 32-row tiles, each block its
//      own tile with all the columns. What bounded the large tile was its
//      weight stream (2.6 MB from L2 a 32-row tile, into registers 8 k-steps
//      ahead, idle through the f32 passes) and the f32 passes themselves.
//      Here one stream feeds both blocks, so a weight byte read from L2
//      serves 64 rows: a producer warpgroup (one warp copies, setmaxnreg
//      hands its registers to the consumers) fills a ring of three 32 KB
//      slots, each 4 k-steps of 16 column blocks in fragment order, every
//      block copying half of a fill into both blocks' rings (multicast;
//      WeightRing, encoder_common.cuh); a slot is refilled once the 32
//      consumer warps of the pair gave it back, so the ring fills ahead
//      through the f32 passes. The 16 consumer warps take B from the ring
//      and A from the tile (mma.sync), a 16-column block each. q/k/v stay bf16 in shared
//      memory over the MLP (no round trip through device memory); the
//      attention, forward and backward, runs on mma a (window, head) a warp
//      with P and dS in registers (the window's frames padded to a 16 x 16
//      tile; movmatrix transposes P and dS), so q/k/v, P, dS and the mix's
//      gradient are bf16 operands where the other shapes keep the attention
//      in f32 (within the same tolerance); dy2 accumulates in registers
//      over the MLP's chunks; six of the eight vector gradients are summed
//      in the epilogues that make their terms, by shuffles in a fixed order.
//    large (encoder_bwd_tile_kernel): the shapes the others do not take (d =
//      128, 384, 512; T = 17 .. 48; one or two heads) and the batches between
//      the thresholds: a fixed number of persistent blocks (one an SM at
//      most) each walk over 16..48-row tiles with all the columns, streaming
//      the weights into registers as the small shape does. q/k/v are parked
//      in a per-block scratch in device memory (it stays in L2) over the MLP
//      phase, which runs in chunks of the hidden width; dh2 is parked in dx.
// 2. encoder_wgrad_kernel. The four A^T G products over all B T rows from
//    the workspace: persistent blocks walk (product, 128 x 256 or 128 x 128
//    output tile, range of rows) items, a producer warp feeding the
//    operands by TMA into a ring that two warpgroups read by wgmma, each
//    item's partial tile written out (fused_encoder.py::plan_wgrad).
// 3. encoder_bwd_reduce_kernel. Adds the row ranges' partial tiles in range
//    order and the tile kernel's blocks' slabs in a fixed order into the
//    flat gradient.
//
// What bounds it on an H100 at d = 256, T = 10, 4d MLP: operations (64 d^2
// flops a row on the tensor cores, 172 GFLOP at B = 4096, beside 8 KB a row
// of workspace written and read once) at large batches; at small ones the
// chain of dependent phases, each a few thousand cycles, which the small
// shape shortens by splitting every phase's work over a cluster. Measured
// times by shape and batch are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "encoder_common.cuh"
#include "launch.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxRowTiles = 3;     // 16-row mma tiles a block may own
constexpr int kDepth = 8;           // weight k-steps in flight per warp

struct EncoderBwdTag {};            // keys the tile kernel's shared-memory cap (launch.cuh)

struct BwdShape {
  int batch, t, d, m, heads;
  int row_tiles;                    // 16-row mma tiles per block
  int windows;                      // whole windows per tile
  int chunk;                        // hidden columns per MLP chunk
  int n_tiles;
  int ld_d, ld_q, ld_c;             // row strides of [rows, d], [rows, 3d], [rows, chunk] buffers
  // byte offsets into shared memory
  int off_ab, off_big, off_x2, off_ps, off_stats, off_gb, off_z, off_dz;
  float q_scale;                    // dh^-0.5
};

// gelu (tanh form) and its derivative at v
__device__ __forceinline__ void gelu_tanh_both(float v, float& act, float& grad) {
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  const float th = tanhf(u);
  const float du = 0.7978845608028654f * (1.f + 3.f * 0.044715f * v * v);
  act = 0.5f * v * (1.f + th);
  grad = 0.5f * (1.f + th) + 0.5f * v * (1.f - th * th) * du;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The two column sums of a LayerNorm's VJP over the tile's rows, one thread
// a column: dscale += sum_r dy xhat, dbias += sum_r dy.
__device__ __forceinline__ void layernorm_bwd_columns(const float* dy, const float* x, int ld,
                                                      int rows, int d, const float* mean,
                                                      const float* rstd, float* dscale,
                                                      float* dbias) {
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float v = dy[r * ld + col];
      sg = fmaf(v, (x[r * ld + col] - mean[r]) * rstd[r], sg);
      sb += v;
    }
    dscale[col] += sg;
    dbias[col] += sb;
  }
}

// sums[col] += sum over the rows of src[r][col], one thread a column
__device__ __forceinline__ void add_column_sums(const float* src, int ld, int rows, int n,
                                                float* sums) {
  for (int col = threadIdx.x; col < n; col += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += src[r * ld + col];
    sums[col] += s;
  }
}

// The first `valid` rows of a bf16 [rows][width] buffer in shared memory
// (stride ld, width a multiple of 8) to device memory, rows dst_ld apart, 16
// bytes a store.
__device__ __forceinline__ void store_block(const bf16* src, int ld, int valid, int width,
                                            bf16* dst, long long dst_ld) {
  const int w8 = width / 8;
  for (int i = threadIdx.x; i < valid * w8; i += kThreads) {
    const int r = i / w8;
    const int c8 = i - r * w8;
    *reinterpret_cast<uint4*>(dst + r * dst_ld + 8 * c8) =
        *reinterpret_cast<const uint4*>(src + r * ld + 8 * c8);
  }
}

// One product for the block's row tiles: a [16 * row_tiles, 16 * nk] bf16 in
// shared memory (stride lda) times nk k-steps, starting at k-step ks0, of a
// weight packed in fragment order [n / 16][w_nk][32 lanes] x 16 bytes, for
// n_blocks 16-column blocks. nk is a multiple of kDepth. epi(row, col, v0,
// v1) receives every pair of neighbouring sums (col even) exactly once.
template <typename Epilogue>
__device__ __forceinline__ void product(const bf16* a, int lda, int row_tiles,
                                        const bf16* __restrict__ w, int w_nk, int ks0, int nk,
                                        int n_blocks, Epilogue epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const uint4* wl = reinterpret_cast<const uint4*>(w);
  const bf16* a0 = a + (lane & 15) * lda + (lane >> 4) * 8;

  for (int nb = warp; nb < n_blocks; nb += kWarps) {
    float acc[kMaxRowTiles][2][4] = {};
    const uint4* wp = wl + (static_cast<long long>(nb) * w_nk + ks0) * 32 + lane;
    uint4 ring[kDepth];
#pragma unroll
    for (int dd = 0; dd < kDepth; ++dd) ring[dd] = __ldg(wp + dd * 32);
    for (int kb = 0; kb < nk; kb += kDepth) {
#pragma unroll
      for (int dd = 0; dd < kDepth; ++dd) {
        const int ks = kb + dd;
        const uint4 b = ring[dd];
        if (ks + kDepth < nk) ring[dd] = __ldg(wp + (ks + kDepth) * 32);
#pragma unroll
        for (int rt = 0; rt < kMaxRowTiles; ++rt) {
          if (rt < row_tiles) {
            unsigned af[4];
            ldmatrix_x4(af, a0 + rt * 16 * lda + 16 * ks);
            mma_bf16(acc[rt][0], af, b.x, b.y);
            mma_bf16(acc[rt][1], af, b.z, b.w);
          }
        }
      }
    }
#pragma unroll
    for (int rt = 0; rt < kMaxRowTiles; ++rt) {
      if (rt < row_tiles) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            epi(16 * rt + g + 8 * h, nb * 16 + 8 * j + 2 * c, acc[rt][j][2 * h],
                acc[rt][j][2 * h + 1]);
          }
        }
      }
    }
  }
}

// LayerNorm of `rows` rows of src (f32) into dst as bf16 (the same stride),
// one warp a row; each row's mean and 1/std to mean[] and rstd[].
__device__ __forceinline__ void layernorm_rows(const float* src, int ld, int rows, int d,
                                                    const float* scale, const float* bias,
                                                    bf16* dst, float* mean, float* rstd) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float inv_d = 1.f / static_cast<float>(d);
  for (int r = warp; r < rows; r += kWarps) {
    const float* x = src + r * ld;
    float sum = 0.f;
    for (int i = lane; i < d; i += 32) sum += x[i];
    const float mu = warp_sum(sum) * inv_d;
    float sq = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float c = x[i] - mu;
      sq = fmaf(c, c, sq);
    }
    const float rs = rsqrtf(warp_sum(sq) * inv_d + kLnEps);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
    for (int i = lane; i < d; i += 32) dst[r * ld + i] = __float2bfloat16((x[i] - mu) * rs * scale[i] + bias[i]);
  }
}

// Attention backward of a group of gh heads (all of them in the large tile),
// in place, in f32, in three passes: P and dS a (window, head, query frame);
// dv and dk a (window, head, key frame); dq a (window, head, query frame).
// `sub` lanes take an item where there are fewer items than threads: in the
// first pass they split the head's dh columns and add their partial dot
// products by shuffles, in the other two each lane takes its own columns.
// In: qkv = [q * dh^-0.5 | k | v] of the group (each gh dh wide, stride
// ld_q) and da ([rows][ld]); out: qkv = [dq | k | dv] and dk in dkbuf
// ([rows][ld]). probs and dsc hold P and dS, [windows * gh * t][t] each. A
// barrier ends each pass.
template <int kT>
__device__ __forceinline__ void attention_bwd_lanes(float* qkv, int ld_q, const float* da,
                                                    float* dkbuf, int ld, float* probs,
                                                    float* dsc, int t_rt, int dh, int gh,
                                                    int windows, float q_scale) {
  const int t = kT > 0 ? kT : t_rt;
  constexpr int kArr = kT > 0 ? kT : kMaxT;
  const int gw = gh * dh;
  const int items = windows * gh * t;
  int sub = 8;                                   // lanes an item
  while (sub > 1 && (dh % (2 * sub) != 0 || items * sub > kThreads)) sub >>= 1;
  const int rounds = (items * sub + kThreads - 1) / kThreads;

  // P and dS, a (window, head, query frame) each
  for (int round = 0; round < rounds; ++round) {
    const int tid = round * kThreads + threadIdx.x;
    const bool active = tid < items * sub;
    const int it = active ? tid / sub : 0;       // lanes past the end shadow item 0
    const int sl = tid % sub;
    const int tq = it % t;
    const int wh = it / t;
    const int h = wh % gh;
    const int row0 = (wh / gh) * t;
    const float* q = qkv + (row0 + tq) * ld_q + h * dh;
    const float* kw = qkv + row0 * ld_q + gw + h * dh;
    const float* vw = kw + gw;
    const float* dai = da + (row0 + tq) * ld + h * dh;
    const int skew = (8 * h) % dh;
    float p[kArr], dp[kArr];
#pragma unroll
    for (int j = 0; j < t; ++j) {
      p[j] = 0.f;
      dp[j] = 0.f;
    }
    for (int ii = 2 * sl; ii < dh; ii += 2 * sub) {
      const int i = ii + skew < dh ? ii + skew : ii + skew - dh;
      const float2 qi = *reinterpret_cast<const float2*>(q + i);
      const float2 di = *reinterpret_cast<const float2*>(dai + i);
#pragma unroll
      for (int j = 0; j < t; ++j) {
        const float2 kj = *reinterpret_cast<const float2*>(kw + j * ld_q + i);
        const float2 vj = *reinterpret_cast<const float2*>(vw + j * ld_q + i);
        p[j] = fmaf(qi.x, kj.x, fmaf(qi.y, kj.y, p[j]));
        dp[j] = fmaf(di.x, vj.x, fmaf(di.y, vj.y, dp[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < t; ++j) {
      for (int o = sub >> 1; o > 0; o >>= 1) {
        p[j] += __shfl_xor_sync(0xffffffffu, p[j], o);
        dp[j] += __shfl_xor_sync(0xffffffffu, dp[j], o);
      }
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
    float tot = 0.f;
#pragma unroll
    for (int j = 0; j < t; ++j) {
      p[j] *= inv_z;
      tot = fmaf(p[j], dp[j], tot);
    }
    if (active && sl == 0) {
#pragma unroll
      for (int j = 0; j < t; ++j) {
        probs[it * t + j] = p[j];
        dsc[it * t + j] = p[j] * (dp[j] - tot);
      }
    }
  }
  __syncthreads();

  // dv and dk, a (window, head, key frame) each, the lanes on its columns
  for (int round = 0; round < rounds; ++round) {
    const int tid = round * kThreads + threadIdx.x;
    const bool active = tid < items * sub;
    const int it = active ? tid / sub : 0;
    const int sl = tid % sub;
    const int tj = it % t;
    const int wh = it / t;
    const int h = wh % gh;
    const int row0 = (wh / gh) * t;
    const float* qw = qkv + row0 * ld_q + h * dh;
    const float* daw = da + row0 * ld + h * dh;
    float* vj = qkv + (row0 + tj) * ld_q + 2 * gw + h * dh;
    float* dkj = dkbuf + (row0 + tj) * ld + h * dh;
    const int skew = (8 * h) % dh;
    float p[kArr], ds[kArr];
#pragma unroll
    for (int i = 0; i < t; ++i) {
      p[i] = probs[(wh * t + i) * t + tj];
      ds[i] = dsc[(wh * t + i) * t + tj];
    }
    for (int cc = 2 * sl; cc < dh; cc += 2 * sub) {
      const int c = cc + skew < dh ? cc + skew : cc + skew - dh;
      float v0 = 0.f, v1 = 0.f, k0 = 0.f, k1 = 0.f;
#pragma unroll
      for (int i = 0; i < t; ++i) {
        const float2 di = *reinterpret_cast<const float2*>(daw + i * ld + c);
        const float2 qi = *reinterpret_cast<const float2*>(qw + i * ld_q + c);
        v0 = fmaf(p[i], di.x, v0);
        v1 = fmaf(p[i], di.y, v1);
        k0 = fmaf(ds[i], qi.x, k0);
        k1 = fmaf(ds[i], qi.y, k1);
      }
      if (active) {
        *reinterpret_cast<float2*>(vj + c) = make_float2(v0, v1);
        *reinterpret_cast<float2*>(dkj + c) = make_float2(k0, k1);
      }
    }
  }
  __syncthreads();

  // dq, a (window, head, query frame) each, the lanes on its columns
  for (int round = 0; round < rounds; ++round) {
    const int tid = round * kThreads + threadIdx.x;
    const bool active = tid < items * sub;
    const int it = active ? tid / sub : 0;
    const int sl = tid % sub;
    const int tq = it % t;
    const int wh = it / t;
    const int h = wh % gh;
    const int row0 = (wh / gh) * t;
    float* qi = qkv + (row0 + tq) * ld_q + h * dh;
    const float* kw = qkv + row0 * ld_q + gw + h * dh;
    const int skew = (8 * h) % dh;
    float ds[kArr];
#pragma unroll
    for (int j = 0; j < t; ++j) ds[j] = dsc[it * t + j];
    for (int cc = 2 * sl; cc < dh; cc += 2 * sub) {
      const int c = cc + skew < dh ? cc + skew : cc + skew - dh;
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int j = 0; j < t; ++j) {
        const float2 kj = *reinterpret_cast<const float2*>(kw + j * ld_q + c);
        q0 = fmaf(ds[j], kj.x, q0);
        q1 = fmaf(ds[j], kj.y, q1);
      }
      if (active) *reinterpret_cast<float2*>(qi + c) = make_float2(q0 * q_scale, q1 * q_scale);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void attention_bwd_lanes_any_t(float* qkv, int ld_q, const float* da,
                                                          float* dkbuf, int ld, float* probs,
                                                          float* dsc, int t, int dh, int gh,
                                                          int windows, float q_scale) {
  switch (t) {
    case 10:
      attention_bwd_lanes<10>(qkv, ld_q, da, dkbuf, ld, probs, dsc, t, dh, gh, windows, q_scale);
      break;
    case 4:
      attention_bwd_lanes<4>(qkv, ld_q, da, dkbuf, ld, probs, dsc, t, dh, gh, windows, q_scale);
      break;
    default:
      attention_bwd_lanes<0>(qkv, ld_q, da, dkbuf, ld, probs, dsc, t, dh, gh, windows, q_scale);
  }
}

// Workspace of row operands, bf16, dense arrays end to end over n = B T rows:
// y1 [n, d] | dqkv [n, 3d] | a [n, d] | dh2 [n, d] | y2 [n, d] | dz1 [n, m] |
// u [n, m] | g [n, d].
struct Workspace {
  bf16 *y1, *dqkv, *attn, *dh2, *y2, *dz1, *u, *g;
};

__device__ __host__ __forceinline__ Workspace carve_workspace(bf16* ws, long long n, int d,
                                                              int m) {
  Workspace w;
  w.y1 = ws;
  w.dqkv = w.y1 + n * d;
  w.attn = w.dqkv + n * 3 * d;
  w.dh2 = w.attn + n * d;
  w.y2 = w.dh2 + n * d;
  w.dz1 = w.y2 + n * d;
  w.u = w.dz1 + n * m;
  w.g = w.u + n * m;
  return w;
}

__global__ void __launch_bounds__(kThreads, 1)
encoder_bwd_tile_kernel(const float* __restrict__ x, const float* __restrict__ gout,
                        const bf16* __restrict__ w, const bf16* __restrict__ wt,
                        const float* __restrict__ vec, float* dx, bf16* ws_base,
                        float* scratch_base, float* vpart_base, BwdShape s) {
  // Shared memory (f32 unless noted), rows = 16 * row_tiles:
  //   hbuf [rows][ld_d]        x, then h2, then dh2, then dk, then x again
  //   abuf bf16 [rows][ld_d]   the current product's operand
  //     (hbuf and abuf together hold bf16 dqkv [rows][ld_q] for the last product)
  //   big [rows][ld_q]         q/k/v, later dq/dk/dv; over the MLP phase
  //                            gb bf16 [rows][ld_d] | z [rows][ld_c] | dz bf16 [rows][ld_c]
  //   x2 [rows][ld_d]          dy2, then the gradient of the mix, then dy1
  //   probs, dsc               P and dS of the attention backward
  //   mean1, rstd1, mean2, rstd2 [rows]
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = s.d, m = s.m, t = s.t;
  const int rows = 16 * s.row_tiles;
  const int ld_d = s.ld_d, ld_q = s.ld_q, ld_c = s.ld_c;
  float* const hbuf = reinterpret_cast<float*>(smem);
  bf16* const abuf = reinterpret_cast<bf16*>(smem + s.off_ab);
  bf16* const dqkv_b = reinterpret_cast<bf16*>(smem);
  float* const big = reinterpret_cast<float*>(smem + s.off_big);
  bf16* const gb = reinterpret_cast<bf16*>(smem + s.off_gb);
  float* const zbuf = reinterpret_cast<float*>(smem + s.off_z);
  bf16* const dzb = reinterpret_cast<bf16*>(smem + s.off_dz);
  float* const x2 = reinterpret_cast<float*>(smem + s.off_x2);
  float* const probs = reinterpret_cast<float*>(smem + s.off_ps);
  float* const dsc = probs + s.windows * s.heads * t * t;
  float* const mean1 = reinterpret_cast<float*>(smem + s.off_stats);
  float* const rstd1 = mean1 + rows;
  float* const mean2 = rstd1 + rows;
  float* const rstd2 = mean2 + rows;

  // weights in fragment order, end to end: Wqkv, Wproj, W1, W2 (w) and
  // Wqkv^T [3d, d], Wproj^T [d, d], W1^T [m, d], W2^T [d, m] (wt)
  const bf16* const w_qkv = w;
  const bf16* const w_proj = w_qkv + static_cast<long long>(d) * 3 * d;
  const bf16* const w_mlp1 = w_proj + static_cast<long long>(d) * d;
  const bf16* const wt_qkv = wt;
  const bf16* const wt_proj = wt_qkv + static_cast<long long>(d) * 3 * d;
  const bf16* const wt_mlp1 = wt_proj + static_cast<long long>(d) * d;
  const bf16* const wt_mlp2 = wt_mlp1 + static_cast<long long>(d) * m;
  // f32 rows, end to end: g1, b1, bqkv, bproj, g2, b2, bm1, bm2
  const float* const g1 = vec;
  const float* const b1 = g1 + d;
  const float* const b_qkv = b1 + d;
  const float* const b_proj = b_qkv + 3 * d;
  const float* const g2 = b_proj + d;
  const float* const b2 = g2 + d;
  const float* const b_mlp1 = b2 + d;
  // this block's slab of partial vector gradients, in the same order
  const int n_vec = 9 * d + m;
  float* const vp = vpart_base + static_cast<long long>(blockIdx.x) * n_vec;
  float* const dg1 = vp;
  float* const db1 = dg1 + d;
  float* const db_qkv = db1 + d;
  float* const db_proj = db_qkv + 3 * d;
  float* const dg2 = db_proj + d;
  float* const db2 = dg2 + d;
  float* const db_mlp1 = db2 + d;
  float* const db_mlp2 = db_mlp1 + m;
  float* const scratch = scratch_base + static_cast<long long>(blockIdx.x) * rows * 3 * d;
  const Workspace ws = carve_workspace(ws_base, static_cast<long long>(s.batch) * t, d, m);

  for (int i = threadIdx.x; i < n_vec; i += kThreads) vp[i] = 0.f;
  __syncthreads();

  const int d4 = d / 4;
  const int q4 = 3 * d / 4;
  const int tile_rows = s.windows * t;           // rows of a tile that belong to a window

  for (int tile = blockIdx.x; tile < s.n_tiles; tile += gridDim.x) {
    const int win0 = tile * s.windows;
    const int n_win = min(s.windows, s.batch - win0);
    const int valid = n_win * t;                 // rows that exist in the batch
    const long long grow0 = static_cast<long long>(win0) * t;   // first row, in the batch
    const long long base = grow0 * d;
    const float4* const xs = reinterpret_cast<const float4*>(x + base);
    const float4* const gs = reinterpret_cast<const float4*>(gout + base);

    // ---- recompute the forward ----
    for (int i = threadIdx.x; i < rows * d4; i += kThreads) {
      const int r = i / d4;
      const int c4 = i - r * d4;
      const float4 v = r < valid ? __ldg(xs + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(hbuf + r * ld_d + 4 * c4) = v;
    }
    __syncthreads();
    layernorm_rows(hbuf, ld_d, rows, d, g1, b1, abuf, mean1, rstd1);
    __syncthreads();
    store_block(abuf, ld_d, valid, d, ws.y1 + grow0 * d, d);
    {
      const float scale = s.q_scale;
      product(abuf, ld_d, s.row_tiles, w_qkv, d / 16, 0, d / 16, 3 * d / 16,
              [=](int r, int n, float v0, float v1) {
                v0 += __ldg(b_qkv + n);
                v1 += __ldg(b_qkv + n + 1);
                if (n < d) {
                  v0 *= scale;
                  v1 *= scale;
                }
                *reinterpret_cast<float2*>(big + r * ld_q + n) = make_float2(v0, v1);
              });
    }
    __syncthreads();
    attention_any_t(big, ld_q, t, d / s.heads, s.heads, s.windows, abuf, ld_d, 0);
    __syncthreads();
    store_block(abuf, ld_d, valid, d, ws.attn + grow0 * d, d);
    // park q/k/v in this block's scratch over the MLP phase
    for (int i = threadIdx.x; i < rows * q4; i += kThreads) {
      const int r = i / q4;
      const int c4 = i - r * q4;
      reinterpret_cast<float4*>(scratch)[i] =
          *reinterpret_cast<const float4*>(big + r * ld_q + 4 * c4);
    }
    product(abuf, ld_d, s.row_tiles, w_proj, d / 16, 0, d / 16, d / 16,
            [=](int r, int n, float v0, float v1) {
              float2* h = reinterpret_cast<float2*>(hbuf + r * ld_d + n);
              float2 hv = *h;
              hv.x += v0 + __ldg(b_proj + n);
              hv.y += v1 + __ldg(b_proj + n + 1);
              *h = hv;
            });
    __syncthreads();
    layernorm_rows(hbuf, ld_d, rows, d, g2, b2, abuf, mean2, rstd2);
    // g as a bf16 operand, zero past the valid rows; dy2 starts at zero
    for (int i = threadIdx.x; i < rows * d4; i += kThreads) {
      const int r = i / d4;
      const int c4 = i - r * d4;
      const float4 v = r < valid ? __ldg(gs + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(gb + r * ld_d + 4 * c4);
      o[0] = __floats2bfloat162_rn(v.x, v.y);
      o[1] = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<float4*>(x2 + r * ld_d + 4 * c4) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int col = threadIdx.x; col < d; col += kThreads) {
      float sum = 0.f;
      for (int r = 0; r < valid; ++r) sum += __ldg(gout + base + static_cast<long long>(r) * d + col);
      db_mlp2[col] += sum;
    }
    __syncthreads();
    store_block(abuf, ld_d, valid, d, ws.y2 + grow0 * d, d);
    store_block(gb, ld_d, valid, d, ws.g + grow0 * d, d);

    // ---- the MLP, forward and backward, a chunk of hidden columns at a time ----
    const int chunk = s.chunk;
    for (int c0 = 0; c0 < m; c0 += chunk) {
      // z = gelu'(y2 W1 + bm1) for the chunk; u = bf16(gelu(.)) to the workspace
      product(abuf, ld_d, s.row_tiles, w_mlp1 + static_cast<long long>(c0) * d, d / 16, 0,
              d / 16, chunk / 16, [=](int r, int n, float v0, float v1) {
                float a0, a1, d0, d1;
                gelu_tanh_both(v0 + __ldg(b_mlp1 + c0 + n), a0, d0);
                gelu_tanh_both(v1 + __ldg(b_mlp1 + c0 + n + 1), a1, d1);
                *reinterpret_cast<float2*>(zbuf + r * ld_c + n) = make_float2(d0, d1);
                if (r < valid) {
                  *reinterpret_cast<__nv_bfloat162*>(ws.u + (grow0 + r) * m + c0 + n) =
                      __floats2bfloat162_rn(a0, a1);
                }
              });
      __syncthreads();
      // dz1 = (bf16(g) W2^T) * gelu'
      product(gb, ld_d, s.row_tiles, wt_mlp2 + static_cast<long long>(c0) * d, d / 16, 0,
              d / 16, chunk / 16, [=](int r, int n, float v0, float v1) {
                float2* z = reinterpret_cast<float2*>(zbuf + r * ld_c + n);
                float2 zv = *z;
                zv.x *= v0;
                zv.y *= v1;
                *z = zv;
                const __nv_bfloat162 zb = __floats2bfloat162_rn(zv.x, zv.y);
                *reinterpret_cast<__nv_bfloat162*>(dzb + r * ld_c + n) = zb;
                if (r < valid) {
                  *reinterpret_cast<__nv_bfloat162*>(ws.dz1 + (grow0 + r) * m + c0 + n) = zb;
                }
              });
      __syncthreads();
      add_column_sums(zbuf, ld_c, rows, chunk, db_mlp1 + c0);
      // dy2 += bf16(dz1) W1^T[chunk rows]
      product(dzb, ld_c, s.row_tiles, wt_mlp1, m / 16, c0 / 16, chunk / 16, d / 16,
              [=](int r, int n, float v0, float v1) {
                float2* y = reinterpret_cast<float2*>(x2 + r * ld_d + n);
                float2 yv = *y;
                yv.x += v0;
                yv.y += v1;
                *y = yv;
              });
      __syncthreads();
    }

    // ---- LayerNorm 2 backward; dh2 = g + LN2'(dy2) ----
    layernorm_bwd_columns(x2, hbuf, ld_d, rows, d, mean2, rstd2, dg2, db2);
    __syncthreads();
    // bring q/k/v back (the MLP phase's buffers in `big` are done with)
    for (int i = threadIdx.x; i < rows * q4; i += kThreads) {
      const int r = i / q4;
      const int c4 = i - r * q4;
      *reinterpret_cast<float4*>(big + r * ld_q + 4 * c4) =
          reinterpret_cast<const float4*>(scratch)[i];
    }
    {
      const int warp = threadIdx.x >> 5;
      const int lane = threadIdx.x & 31;
      const float inv_d = 1.f / static_cast<float>(d);
      for (int r = warp; r < rows; r += kWarps) {
        float* hr = hbuf + r * ld_d;
        const float* dy = x2 + r * ld_d;
        const float mu = mean2[r], rs = rstd2[r];
        float s1 = 0.f, s2 = 0.f;
        for (int i = lane; i < d; i += 32) {
          const float dxh = dy[i] * __ldg(g2 + i);
          s1 += dxh;
          s2 = fmaf(dxh, (hr[i] - mu) * rs, s2);
        }
        const float m1 = warp_sum(s1) * inv_d;
        const float m2 = warp_sum(s2) * inv_d;
        for (int i = lane; i < d; i += 32) {
          const float dxh = dy[i] * __ldg(g2 + i);
          const float xh = (hr[i] - mu) * rs;
          const float gv = r < valid ? __ldg(gout + base + static_cast<long long>(r) * d + i) : 0.f;
          const float dh2 = gv + rs * (dxh - m1 - xh * m2);
          hr[i] = dh2;
          abuf[r * ld_d + i] = __float2bfloat16(dh2);
          if (r < valid) dx[base + static_cast<long long>(r) * d + i] = dh2;   // parked; finished below
        }
      }
    }
    __syncthreads();
    add_column_sums(hbuf, ld_d, rows, d, db_proj);
    store_block(abuf, ld_d, valid, d, ws.dh2 + grow0 * d, d);
    // gradient of the attention mix = bf16(dh2) Wproj^T
    product(abuf, ld_d, s.row_tiles, wt_proj, d / 16, 0, d / 16, d / 16,
            [=](int r, int n, float v0, float v1) {
              *reinterpret_cast<float2*>(x2 + r * ld_d + n) = make_float2(v0, v1);
            });
    __syncthreads();

    // ---- attention backward: big = [dq | k | dv], dk in hbuf ----
    attention_bwd_lanes_any_t(big, ld_q, x2, hbuf, ld_d, probs, dsc, t, d / s.heads, s.heads,
                              s.windows, s.q_scale);
    // dk over k; rows of the tile past its windows hold no gradient
    for (int i = threadIdx.x; i < rows * d4; i += kThreads) {
      const int r = i / d4;
      const int c4 = i - r * d4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < tile_rows) {
        v = *reinterpret_cast<const float4*>(hbuf + r * ld_d + 4 * c4);
      } else {
        *reinterpret_cast<float4*>(big + r * ld_q + 4 * c4) = v;
        *reinterpret_cast<float4*>(big + r * ld_q + 2 * d + 4 * c4) = v;
      }
      *reinterpret_cast<float4*>(big + r * ld_q + d + 4 * c4) = v;
    }
    __syncthreads();
    add_column_sums(big, ld_q, rows, 3 * d, db_qkv);
    for (int i = threadIdx.x; i < rows * q4; i += kThreads) {
      const int r = i / q4;
      const int c4 = i - r * q4;
      const float4 v = *reinterpret_cast<const float4*>(big + r * ld_q + 4 * c4);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dqkv_b + r * ld_q + 4 * c4);
      o[0] = __floats2bfloat162_rn(v.x, v.y);
      o[1] = __floats2bfloat162_rn(v.z, v.w);
    }
    __syncthreads();
    store_block(dqkv_b, ld_q, valid, 3 * d, ws.dqkv + grow0 * 3 * d, 3 * d);
    // dy1 = bf16(dqkv) Wqkv^T
    product(dqkv_b, ld_q, s.row_tiles, wt_qkv, 3 * d / 16, 0, 3 * d / 16, d / 16,
            [=](int r, int n, float v0, float v1) {
              *reinterpret_cast<float2*>(x2 + r * ld_d + n) = make_float2(v0, v1);
            });
    __syncthreads();

    // ---- LayerNorm 1 backward; dx = dh2 + LN1'(dy1) ----
    for (int i = threadIdx.x; i < rows * d4; i += kThreads) {
      const int r = i / d4;
      const int c4 = i - r * d4;
      const float4 v = r < valid ? __ldg(xs + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(hbuf + r * ld_d + 4 * c4) = v;
    }
    __syncthreads();
    layernorm_bwd_columns(x2, hbuf, ld_d, rows, d, mean1, rstd1, dg1, db1);
    {
      const int warp = threadIdx.x >> 5;
      const int lane = threadIdx.x & 31;
      const float inv_d = 1.f / static_cast<float>(d);
      for (int r = warp; r < valid; r += kWarps) {
        const float* xr = hbuf + r * ld_d;
        const float* dy = x2 + r * ld_d;
        float* dxr = dx + base + static_cast<long long>(r) * d;
        const float mu = mean1[r], rs = rstd1[r];
        float s1 = 0.f, s2 = 0.f;
        for (int i = lane; i < d; i += 32) {
          const float dxh = dy[i] * __ldg(g1 + i);
          s1 += dxh;
          s2 = fmaf(dxh, (xr[i] - mu) * rs, s2);
        }
        const float m1 = warp_sum(s1) * inv_d;
        const float m2 = warp_sum(s2) * inv_d;
        for (int i = lane; i < d; i += 32) {
          const float dxh = dy[i] * __ldg(g1 + i);
          const float xh = (xr[i] - mu) * rs;
          dxr[i] += rs * (dxh - m1 - xh * m2);
        }
      }
    }
    __syncthreads();
  }
}

// ---- the four weight gradients: out = A^T G over the workspace's rows ----
//
// dWqkv = y1^T dqkv, dWproj = a^T dh2, dW1 = y2^T dz1 and dW2 = u^T g, each
// summed over the n = B T rows of the workspace: what the Pallas kernel adds
// into its accumulators at the end of every grid step
// (pallas_encoder.py::_encoder_bwd_kernel). Here blocks run at once, so the
// rows are cut into ranges of whole 64-row boxes (splits); an item is one
// (product, output tile, range), a tile 128 rows of A's columns by tile_n
// (256, or 128 at small n) of G's, the last of a product's row of tiles 128
// wide where 256 does not divide. A fixed number of persistent blocks walk
// the items in index order (range-major, so the blocks at work at once read
// the same rows), each writing its partial tile (with one range, the
// gradient itself); the reduce adds the ranges' tiles in index order. The
// plan (fused_encoder.py::plan_wgrad, which wg_tile mirrors) depends on the
// shape alone, so the order of every sum is fixed. Each range adds a
// partial gradient written and read back, which on an H100 costs more than
// idle multiprocessors: the plan takes few ranges (96 items at B = 64 and
// 4096 at the served width, PERF.md).
//
// What bounds it on an H100: the workspace's bytes (8 d + 2 m bf16 a row,
// 8 KB at d = 256, m = 1024: 100 us at B = 4096) beside 2 (4 d^2 + 2 d m)
// flops a row (65 us). A producer warp brings each item's operands in by TMA
// (64-row boxes of 64 columns, 128-byte swizzle) into a ring of kWgStages
// stages of 48 KB; two consumer warpgroups, 64 of the tile's rows each,
// multiply them where they land by wgmma with both operands MN-major (the
// rows are the sum's index, so no transposing copy), one box in flight
// while the next is waited for; the ring runs on into the next item while
// the consumers store a tile. A 128 x 256 tile takes 384 columns of
// operand a row for 32 768 sums (the first design's 128 x 128: 256 for
// 16 384), so half as many operand bytes cross L2 an output. Measured at B =
// 4096: the workspace read at ~2.8 TB/s, 84% of the bound.

constexpr int kWgBox = 64;                         // rows of a box, and its columns (128 bytes)
constexpr int kWgBoxBytes = kWgBox * kWgBox * 2;
constexpr int kWgM = 128;                          // output rows of a tile: 64 a warpgroup
constexpr int kWgMaxN = 256;                       // output columns of a tile
constexpr int kWgStageBytes = (kWgM + kWgMaxN) / kWgBox * kWgBoxBytes;
constexpr int kWgStages = 4;
constexpr int kWgConsumers = 256;                  // two warpgroups
constexpr int kWgThreads = kWgConsumers + 32;      // and the producer warp
constexpr int kWgSmem = 1024 + kWgStages * kWgStageBytes + 16 * kWgStages;
static_assert(kWgSmem <= kMaxSmem, "the weight-gradient ring exceeds shared memory");

struct EncoderWgradTag {};          // keys the weight-gradient kernel's shared-memory cap

struct WgradShape {
  int n, d, m;
  int tile_n;                       // 256 or 128
  int splits, boxes_per_split;      // row ranges, whole boxes each (the last may be short)
  int tiles, items;                 // tiles x splits items
  long long w_total;                // 4 d^2 + 2 d m
};

// The eight workspace arrays as TMA tensor maps, in carve_workspace's order:
// product p multiplies map 2 p (A) by map 2 p + 1 (G).
struct WgradMaps {
  CUtensorMap map[8];
};

// One output tile: product, first output row (A's column) and column (G's),
// columns, the product's row stride and its offset in the flat gradient.
struct WgTile {
  int product, i0, j0, nw, ld;
  long long out_off;
};

__host__ __device__ __forceinline__ int wg_tiles(int rows, int cols, int tile_n) {
  return (rows / kWgM) * ((cols + tile_n - 1) / tile_n);
}

__host__ __device__ __forceinline__ int wg_tile_count(int d, int m, int tile_n) {
  return wg_tiles(d, 3 * d, tile_n) + wg_tiles(d, d, tile_n) + wg_tiles(d, m, tile_n) +
         wg_tiles(m, d, tile_n);
}

// Tile t of the list: the products in the flat gradient's order, then
// 128-row blocks, then tile_n-column blocks.
__device__ __forceinline__ WgTile wg_tile(int t, int d, int m, int tile_n) {
  WgTile w;
  const int n0 = wg_tiles(d, 3 * d, tile_n);
  const int n1 = wg_tiles(d, d, tile_n);
  const int n2 = wg_tiles(d, m, tile_n);
  if (t < n0) {
    w.product = 0; w.ld = 3 * d; w.out_off = 0;
  } else if (t < n0 + n1) {
    t -= n0;
    w.product = 1; w.ld = d; w.out_off = 3LL * d * d;
  } else if (t < n0 + n1 + n2) {
    t -= n0 + n1;
    w.product = 2; w.ld = m; w.out_off = 4LL * d * d;
  } else {
    t -= n0 + n1 + n2;
    w.product = 3; w.ld = d; w.out_off = 4LL * d * d + static_cast<long long>(d) * m;
  }
  const int tj = (w.ld + tile_n - 1) / tile_n;
  w.i0 = (t / tj) * kWgM;
  w.j0 = (t % tj) * tile_n;
  w.nw = min(tile_n, w.ld - w.j0);
  return w;
}

// One item's `boxes` boxes into acc (kN columns): consumer warpgroup `wg`
// multiplies its 64 columns of A by kN of G, box by box, one box's wgmma in
// flight; a stage goes back to the producer once the products that read it
// are done. A box's rows past n arrived as zeros and add nothing.
template <int kN, int kSize>
__device__ __forceinline__ void wgrad_item(float (&acc)[kSize], unsigned base, unsigned full,
                                           unsigned empty, unsigned seq, int boxes, int wg,
                                           int lane) {
  int prev = -1;
  for (int b = 0; b < boxes; ++b, ++seq) {
    const unsigned slot = seq % kWgStages;
    mbar_wait(full + 8 * slot, (seq / kWgStages) & 1);
    const unsigned stage = base + slot * kWgStageBytes;
    const uint64_t a_desc = wgmma_desc_sw128_mn(stage + wg * kWgBoxBytes, kWgBoxBytes);
    const uint64_t g_desc = wgmma_desc_sw128_mn(stage + 2 * kWgBoxBytes, kWgBoxBytes);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kWgBox / 16; ++k) {
      // 16 rows a k-step: 2048 bytes on, 128 in the descriptor; the first
      // k-step of an item overwrites the sums
      WgmmaMN<kN>::mma(acc, a_desc + 128 * k, g_desc + 128 * k, b > 0 || k > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (lane == 0 && prev >= 0) mbar_arrive(empty + 8 * prev);
    prev = static_cast<int>(slot);
  }
  wgmma_wait<0>();
  if (lane == 0 && prev >= 0) mbar_arrive(empty + 8 * prev);
}

__global__ void __launch_bounds__(kWgThreads, 1)
encoder_wgrad_kernel(const __grid_constant__ WgradMaps maps, float* __restrict__ wpart,
                     WgradShape s) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;               // the swizzle's alignment
  const unsigned full = base + kWgStages * kWgStageBytes;     // a stage has landed
  const unsigned empty = full + 8 * kWgStages;                // a stage may be overwritten
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < kWgStages) {
    mbar_init(full + 8 * threadIdx.x, 1);                     // the producer's expect_tx
    mbar_init(empty + 8 * threadIdx.x, kWgConsumers / 32);    // every consumer warp
  }
  mbar_init_fence();
  __syncthreads();
  const int n_boxes = (s.n + kWgBox - 1) / kWgBox;

  if (warp == kWgConsumers / 32) {
    // the producer: every box of this block's items, in the consumers' order
    if (lane < 8) prefetch_tensor_map(&maps.map[lane]);
    if (lane == 0) {
      unsigned seq = 0;
      for (int item = blockIdx.x; item < s.items; item += gridDim.x) {
        const int split = item / s.tiles;
        const WgTile w = wg_tile(item % s.tiles, s.d, s.m, s.tile_n);
        const CUtensorMap* a_map = &maps.map[2 * w.product];
        const CUtensorMap* g_map = &maps.map[2 * w.product + 1];
        const unsigned bytes = (kWgM + w.nw) / kWgBox * kWgBoxBytes;
        const int b1 = min(n_boxes, (split + 1) * s.boxes_per_split);
        for (int box = split * s.boxes_per_split; box < b1; ++box, ++seq) {
          const unsigned slot = seq % kWgStages;
          mbar_wait(empty + 8 * slot, ((seq / kWgStages) & 1) ^ 1);
          const unsigned dst = base + slot * kWgStageBytes;
          const unsigned bar = full + 8 * slot;
          const int row = box * kWgBox;
          mbar_arrive_expect_tx(bar, bytes);
          tma_load_2d(dst, a_map, w.i0, row, bar);
          tma_load_2d(dst + kWgBoxBytes, a_map, w.i0 + kWgBox, row, bar);
          for (int q = 0; q < w.nw / kWgBox; ++q) {
            tma_load_2d(dst + (2 + q) * kWgBoxBytes, g_map, w.j0 + q * kWgBox, row, bar);
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns the tile's rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2;
  const int wq = warp & 3;
  float acc[kWgMaxN / 2];
  unsigned seq = 0;
  for (int item = blockIdx.x; item < s.items; item += gridDim.x) {
    const int split = item / s.tiles;
    const WgTile w = wg_tile(item % s.tiles, s.d, s.m, s.tile_n);
    const int b0 = split * s.boxes_per_split;
    const int boxes = min(n_boxes, b0 + s.boxes_per_split) - b0;
    if (w.nw == kWgMaxN) {
      wgrad_item<kWgMaxN>(acc, base, full, empty, seq, boxes, wg, lane);
    } else {
      wgrad_item<kWgMaxN / 2>(acc, base, full, empty, seq, boxes, wg, lane);
    }
    seq += boxes;
    // the partial tile: a thread holds rows 16 wq + lane / 4 and + 8 of the
    // warpgroup's 64, columns 8 i + 2 (lane % 4) and + 1
    float* out = wpart + split * s.w_total + w.out_off +
                 static_cast<long long>(w.i0 + 64 * wg + 16 * wq + (lane >> 2)) * w.ld + w.j0 +
                 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < kWgMaxN / 8; ++i) {
      if (i < w.nw / 8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(out + 8LL * h * w.ld + 8 * i) =
              make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        }
      }
    }
  }
}

// The flat gradient: out[e] for e < w_total the sum over the row ranges of
// wpart, in range order, four floats a thread of the first w_blocks blocks;
// out[w_total + v] the sum over the tile kernel's `slabs` blocks of vpart,
// kRedCols elements a block of the others: warp w adds the slabs w, w + 8,
// ... in order, then the eight warps' sums are added in warp order (each
// thread of the few blocks that would hold a vector element alone would
// wait on a long chain of loads).
constexpr int kRedThreads = 256;
constexpr int kRedCols = 32;

__global__ void __launch_bounds__(kRedThreads)
encoder_bwd_reduce_kernel(const float4* __restrict__ wpart, int splits, long long w4,
                          int w_blocks, const float* __restrict__ vpart, int slabs, int n_vec,
                          float* __restrict__ out) {
  if (static_cast<int>(blockIdx.x) < w_blocks) {
    const long long e = static_cast<long long>(blockIdx.x) * kRedThreads + threadIdx.x;
    if (e >= w4) return;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sidx = 0; sidx < splits; ++sidx) {
      const float4 p = wpart[sidx * w4 + e];
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    reinterpret_cast<float4*>(out)[e] = sum;
    return;
  }
  __shared__ float part[kRedThreads / 32][kRedCols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int v = (blockIdx.x - w_blocks) * kRedCols + lane;
  float sum = 0.f;
  if (v < n_vec) {
#pragma unroll 4
    for (int b = warp; b < slabs; b += kRedThreads / 32) {
      sum += vpart[static_cast<long long>(b) * n_vec + v];
    }
  }
  part[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && v < n_vec) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kRedThreads / 32; ++w) total += part[w][lane];
    out[4 * w4 + v] = total;
  }
}

// Shared-memory layout of the tile kernel for `row_tiles` row tiles; returns
// its size in bytes.
size_t plan_bwd_smem(BwdShape& s, int row_tiles) {
  s.row_tiles = row_tiles;
  s.windows = 16 * row_tiles / s.t;
  s.chunk = (s.d >= 256 && s.m % 256 == 0) ? 256 : 128;
  s.ld_d = s.d + kPad;
  s.ld_q = 3 * s.d + kPad;
  s.ld_c = s.chunk + kPad;
  const size_t rows = 16 * static_cast<size_t>(row_tiles);
  const size_t h_bytes = rows * s.ld_d * sizeof(float);
  const size_t ab_bytes = rows * s.ld_d * sizeof(bf16);
  const size_t qkv_bytes = rows * s.ld_q * sizeof(float);
  const size_t z_bytes = rows * s.ld_c * sizeof(float);
  const size_t dz_bytes = rows * s.ld_c * sizeof(bf16);
  const size_t mlp_bytes = ab_bytes + z_bytes + dz_bytes;
  const size_t big_bytes = qkv_bytes > mlp_bytes ? qkv_bytes : mlp_bytes;
  size_t ps_bytes = 2 * sizeof(float) * s.windows * s.heads * s.t * s.t;
  ps_bytes = (ps_bytes + 15) / 16 * 16;
  s.off_ab = static_cast<int>(h_bytes);
  s.off_big = static_cast<int>(h_bytes + ab_bytes);
  s.off_gb = s.off_big;
  s.off_z = static_cast<int>(s.off_gb + ab_bytes);
  s.off_dz = static_cast<int>(s.off_z + z_bytes);
  s.off_x2 = static_cast<int>(s.off_big + big_bytes);
  s.off_ps = static_cast<int>(s.off_x2 + h_bytes);
  s.off_stats = static_cast<int>(s.off_ps + ps_bytes);
  return s.off_stats + 4 * rows * sizeof(float);
}


// ---- the small shape: a cluster of blocks splits every product's columns ----

// What fused_encoder.py::plan_encoder_bwd decides for the small shape
// (BwdPlan.as_ints, in this order after the call's shape). Strides are in
// elements, offsets in bytes from the start of the block's shared memory,
// where the f32 residual [rows][d + 8] lies.
struct SmallPlan {
  int batch, t, d, m, heads;
  int cluster, row_tiles, windows;
  int ld_q, ld_z, ld_dq;      // this block's q/k/v (f32), the full dz1 and dqkv (bf16)
  int off_y;                  // y1, y2, dh2 (bf16 [rows][d + 8]); then da (f32)
  int off_a;                  // a, then g (bf16 [rows][d + 8]); then dk (f32)
  int off_q, off_z, off_f;    // q/k/v; dz1, then dqkv; dy2, then dy1 (f32 [rows][d + 8])
  int off_s, scratch_floats;  // the products' partial sums
  int off_v, off_p, off_st, off_bar;   // the f32 rows, P and dS, LN statistics, mbarriers
  float q_scale;              // dh^-0.5
};

constexpr int kSmallPlanInts = 17;
constexpr int kExchanges = 6;       // a, h2, dz1, dy2, dqkv, dy1: one mbarrier each
// Phases the small shape's cycle counters time (ib_fused_encoder_backward_cluster's
// `clocks`): stage and LN1, q/k/v, attention, a exchanged, projection, h2
// exchanged, LN2 and g, the MLP products, dz1 exchanged, dy2, dy2 exchanged,
// LN2's VJP, da, attention backward, dqkv exchanged, dy1, dy1 exchanged,
// LN1's VJP.
constexpr int kBwdPhases = 18;

template <int kRT>
struct EncoderBwdClusterTag {};     // keys each instantiation's shared-memory cap

// Parts a product's nk k-steps are split into where its `items` (products x
// 16-column blocks) leave warps idle: the most with which every part still
// has a warp and is whole chunks of 4 k-steps (fused_encoder.py::bwd_split).
__host__ __device__ __forceinline__ int small_split(int items, int nk) {
  int best = 1;
  for (int sp = 2; sp <= kWarps; ++sp) {
    if (items * sp <= kWarps && nk % sp == 0 && (nk / sp) % 4 == 0) best = sp;
  }
  return best;
}

// A product's row operand in shared memory ([16 kRT rows][16 nk] bf16,
// stride lda) and its weights in fragment order ([n / 16][nk][32 lanes] x 16
// bytes).
struct Operand {
  const bf16* a;
  int lda;
  const bf16* w;
};

// n_prod (1 or 2) products of the block's row tiles with the same column
// blocks `cols` and nk k-steps, split along K into small_split parts; each
// warp takes items (product, part, column block) and streams their weights
// kDepth k-steps ahead in registers, checking the end once a chunk of 4
// k-steps. Partial sums go to scratch [product][part][block][16 kRT][16];
// returns the split. Every thread calls it, with the operands and
// the scratch ready; it ends with a barrier, after which pair_sum reads them.
template <int kRT>
__device__ __forceinline__ int product_parts(Operand op0, Operand op1, int n_prod, int nk,
                                             Cols cols, float* scratch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int split = small_split(n_prod * cols.n, nk);
  const int part_nk = nk / split;
  const int items = n_prod * split * cols.n;
  for (int item = warp; item < items; item += kWarps) {
    const int j = item % cols.n;
    const int pp = item / cols.n;                // product * split + part
    const int part = pp % split;
    const Operand op = pp < split ? op0 : op1;
    const uint4* wp = reinterpret_cast<const uint4*>(op.w) +
                      (static_cast<long long>(cols.block(j)) * nk + part * part_nk) * 32 + lane;
    const bf16* ap = op.a + (lane & 15) * op.lda + (lane >> 4) * 8 + 16 * part * part_nk;
    float acc[kRT][2][4];
#pragma unroll
    for (int rt = 0; rt < kRT; ++rt) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[rt][e >> 2][e & 3] = 0.f;
    }
    uint4 ring[kDepth];
#pragma unroll
    for (int h = 0; h < kDepth / 4; ++h) {
      if (4 * h < part_nk) {                     // part_nk is whole chunks of 4
#pragma unroll
        for (int q = 0; q < 4; ++q) ring[4 * h + q] = __ldg(wp + (4 * h + q) * 32);
      }
    }
    for (int kb = 0; kb < part_nk; kb += kDepth) {
#pragma unroll
      for (int h = 0; h < kDepth / 4; ++h) {
        const int k0 = kb + 4 * h;
        if (k0 < part_nk) {                      // the end, once a chunk of 4 k-steps
          const bool refill = k0 + kDepth < part_nk;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint4 b = ring[4 * h + q];
            if (refill) ring[4 * h + q] = __ldg(wp + (k0 + q + kDepth) * 32);
#pragma unroll
            for (int rt = 0; rt < kRT; ++rt) {
              unsigned af[4];
              ldmatrix_x4(af, ap + rt * 16 * op.lda + 16 * (k0 + q));
              mma_bf16(acc[rt][0], af, b.x, b.y);
              mma_bf16(acc[rt][1], af, b.z, b.w);
            }
          }
        }
      }
    }
    float* const dst = scratch + (pp * cols.n + j) * (kRT * 256);
#pragma unroll
    for (int rt = 0; rt < kRT; ++rt) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(dst + (rt * 16 + g + 8 * h) * 16 + 8 * jj + 2 * c) =
              make_float2(acc[rt][jj][2 * h], acc[rt][jj][2 * h + 1]);
        }
      }
    }
  }
  __syncthreads();
  return split;
}

// Product `prod`'s sums at (column block j, row r, columns 2 cp and 2 cp + 1
// of the block): its parts added in their order.
template <int kRT>
__device__ __forceinline__ float2 pair_sum(const float* scratch, int prod, int split, int n,
                                           int j, int r, int cp) {
  const float* src = scratch + (prod * split * n + j) * (kRT * 256) + r * 16 + 2 * cp;
  float2 v = *reinterpret_cast<const float2*>(src);
  for (int part = 1; part < split; ++part) {
    const float2 q = *reinterpret_cast<const float2*>(src + part * n * (kRT * 256));
    v.x += q.x;
    v.y += q.y;
  }
  return v;
}

// f(j, r, cp) for every row and column pair of n column blocks, a pair a
// thread: the epilogue of product_parts.
template <int kRT, typename F>
__device__ __forceinline__ void each_pair(int n, F f) {
  for (int i = threadIdx.x; i < n * kRT * 128; i += kThreads) {
    f(i / (kRT * 128), (i >> 3) % (kRT * 16), i & 7);
  }
}

// This block's part of a buffer -- `runs` runs of `bytes`, run_stride bytes
// apart, in each of `rows` rows `pitch` bytes apart, from `part` -- to the
// same place in every other block of the cluster, one bulk copy a run, row
// and peer, which completes on the receiver's mbarrier `bar`. Every thread
// calls it; the threads that wrote the part fence it for the copies'
// (asynchronous) proxy first.
__device__ __forceinline__ void send_part(const void* part, int pitch, int bytes, int runs,
                                          int run_stride, int rows, unsigned bar, int rank,
                                          int peers) {
  fence_proxy_async_smem();
  __syncthreads();
  const unsigned src = smem_u32(part);
  const int per_peer = rows * runs;
  for (int i = threadIdx.x; i < (peers - 1) * per_peer; i += kThreads) {
    const unsigned q = (rank + 1 + i / per_peer) % peers;
    const int k = i % per_peer;
    const unsigned at = src + (k / runs) * pitch + (k % runs) * run_stride;
    bulk_copy_s2c(cluster_map(at, q), at, bytes, cluster_map(bar, q));
  }
}

// The tile kernel's small shape: a cluster of C blocks shares a row tile of
// whole windows (kRT mma row tiles); block `rank` owns heads rank H/C ..,
// the columns rank d/C .. of every d-wide output (the same columns of q, k
// and v) and rank m/C .. of the hidden ones, and streams only those
// weights. It recomputes the forward and runs the VJP in the large shape's
// order; what another block needs it hands over in six exchanges (a, h2,
// dz1, dy2, dqkv, dy1), by bulk copies onto the receiver's mbarriers. The
// LayerNorms and their VJPs run on full rows in every block. Each block
// writes its own columns of the workspace and of dx, and sums its own
// columns of the vector gradients over the tile's valid rows into its slab.
template <int kRT>
__global__ void __launch_bounds__(kThreads, 1)
encoder_bwd_tile_kernel_cluster(const float* __restrict__ x, const float* __restrict__ gout,
                                const bf16* __restrict__ w, const bf16* __restrict__ wt,
                                const float* __restrict__ vec, float* __restrict__ dx,
                                bf16* ws_base, float* vpart_base, SmallPlan s,
                                long long* __restrict__ clocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int rows = 16 * kRT;
  // with clocks, thread 0 of each block times the phases (kBwdPhases a block)
  long long t_last = 0;
  auto lap = [&](int phase) {
    if (clocks != nullptr && threadIdx.x == 0) {
      const long long now = clock64();
      if (phase > 0) clocks[static_cast<long long>(blockIdx.x) * kBwdPhases + phase - 1] = now - t_last;
      t_last = now;
    }
  };
  lap(0);
  const int d = s.d, m = s.m, t = s.t;
  const int peers = s.cluster;
  const int rank = static_cast<int>(cluster_ctarank());
  const int mine = s.heads / peers;              // heads of this block
  const int dh = d / s.heads;
  const int gw = d / peers;                      // its columns of a d-wide output
  const int nd = gw / 16;
  const int nm = m / 16 / peers;
  const int own0 = rank * gw, m0 = rank * nm * 16;
  const int ld_r = d + kPad, ld_g = gw + kPad / 2;
  const int ld_q = s.ld_q, ld_z = s.ld_z, ld_dq = s.ld_dq;
  const int nk_d = d / 16;

  float* const resid = reinterpret_cast<float*>(smem);          // x, h2, then dh2
  bf16* const ybuf = reinterpret_cast<bf16*>(smem + s.off_y);   // y1, y2, then dh2
  float* const da = reinterpret_cast<float*>(smem + s.off_y);   // the mix's gradient [rows][ld_g]
  float* const xs = reinterpret_cast<float*>(smem + s.off_y);   // x for LN1's VJP, over y and a
  bf16* const abuf = reinterpret_cast<bf16*>(smem + s.off_a);   // a, then g
  float* const dk = reinterpret_cast<float*>(smem + s.off_a);   // dk [rows][ld_g]
  float* const qbuf = reinterpret_cast<float*>(smem + s.off_q); // [q | k | v], then [dq | k | dv]
  bf16* const dzf = reinterpret_cast<bf16*>(smem + s.off_z);    // dz1 [rows][ld_z]
  bf16* const dqf = reinterpret_cast<bf16*>(smem + s.off_z);    // dqkv [rows][ld_dq]
  float* const fbuf = reinterpret_cast<float*>(smem + s.off_f); // dy2, then dy1
  float* const scratch = reinterpret_cast<float*>(smem + s.off_s);
  float* const rows_s = reinterpret_cast<float*>(smem + s.off_v);
  float* const probs = reinterpret_cast<float*>(smem + s.off_p);
  float* const dsc = probs + s.windows * mine * t * t;
  float* const mean1 = reinterpret_cast<float*>(smem + s.off_st);
  float* const rstd1 = mean1 + rows;
  float* const mean2 = rstd1 + rows;
  float* const rstd2 = mean2 + rows;
  const unsigned bars = smem_u32(smem + s.off_bar);
  const unsigned bar_a = bars, bar_h = bars + 8, bar_dz = bars + 16, bar_dy2 = bars + 24,
                 bar_dq = bars + 32, bar_dy1 = bars + 40;

  // weights as in the large shape; the f32 rows staged in shared memory in
  // their device order: g1, b1, bqkv, bproj, g2, b2, bm1, bm2
  const bf16* const w_qkv = w;
  const bf16* const w_proj = w_qkv + static_cast<long long>(d) * 3 * d;
  const bf16* const w_mlp1 = w_proj + static_cast<long long>(d) * d;
  const bf16* const wt_qkv = wt;
  const bf16* const wt_proj = wt_qkv + static_cast<long long>(d) * 3 * d;
  const bf16* const wt_mlp1 = wt_proj + static_cast<long long>(d) * d;
  const bf16* const wt_mlp2 = wt_mlp1 + static_cast<long long>(d) * m;
  const float* const g1 = rows_s;
  const float* const b1 = g1 + d;
  const float* const b_qkv = b1 + d;
  const float* const b_proj = b_qkv + 3 * d;
  const float* const g2 = b_proj + d;
  const float* const b2 = g2 + d;
  const float* const b_mlp1 = b2 + d;
  const int n_vec = 9 * d + m;
  float* const vp = vpart_base + static_cast<long long>(blockIdx.x) * n_vec;
  float* const dg1 = vp;
  float* const db1 = dg1 + d;
  float* const db_qkv = db1 + d;
  float* const db_proj = db_qkv + 3 * d;
  float* const dg2 = db_proj + d;
  float* const db2 = dg2 + d;
  float* const db_mlp1 = db2 + d;
  float* const db_mlp2 = db_mlp1 + m;
  const Workspace ws = carve_workspace(ws_base, static_cast<long long>(s.batch) * t, d, m);
  // the six products: operands and this block's column blocks
  const Operand none{};
  const Operand op_qkv{ybuf, ld_r, w_qkv}, op_proj{abuf, ld_r, w_proj};
  const Operand op_z1{ybuf, ld_r, w_mlp1}, op_gw2{abuf, ld_r, wt_mlp2};
  const Operand op_dy2{dzf, ld_z, wt_mlp1}, op_da{ybuf, ld_r, wt_proj};
  const Operand op_dy1{dqf, ld_dq, wt_qkv};
  const Cols cols_qkv{3 * nd, nd, nk_d, rank * nd}, cols_d{nd, nd, 0, rank * nd};
  const Cols cols_m{nm, nm, 0, rank * nm};

  const int tile = static_cast<int>(blockIdx.x) / peers;
  const int win0 = tile * s.windows;
  const int valid = min(s.windows, s.batch - win0) * t;   // rows that exist in the batch
  const int tile_rows = s.windows * t;                     // rows of whole windows
  const long long grow0 = static_cast<long long>(win0) * t;
  const long long base = grow0 * d;
  const int d4 = d / 4;

  // Six mbarriers, on which the other blocks' parts of a, h2, dz1, dy2, dqkv
  // and dy1 land; each expects its bytes from the start and is used once.
  // Every block of the cluster has set them up before any copy into another.
  if (threadIdx.x == 0) {
    for (int i = 0; i < kExchanges; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init_fence();
    const unsigned in_rows = (peers - 1) * rows;
    mbar_arrive_expect_tx(bar_a, in_rows * gw * 2);
    mbar_arrive_expect_tx(bar_h, in_rows * gw * 4);
    mbar_arrive_expect_tx(bar_dz, in_rows * nm * 32);
    mbar_arrive_expect_tx(bar_dy2, in_rows * gw * 4);
    mbar_arrive_expect_tx(bar_dq, 3 * in_rows * gw * 2);
    mbar_arrive_expect_tx(bar_dy1, in_rows * gw * 4);
  }
  cluster_arrive();

  // ---- recompute the forward ----
  // x (zeros past the valid rows), the f32 rows, a zero slab, and zeros in
  // this block's columns of a below the tile's windows
  {
    const float4* xg = reinterpret_cast<const float4*>(x + base);
    for (int i = threadIdx.x; i < rows * d4; i += kThreads) {
      const int r = i / d4;
      *reinterpret_cast<float4*>(resid + r * ld_r + 4 * (i - r * d4)) =
          r < valid ? __ldg(xg + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = threadIdx.x; i < n_vec; i += kThreads) {
      rows_s[i] = __ldg(vec + i);
      vp[i] = 0.f;
    }
    for (int i = threadIdx.x; i < (rows - tile_rows) * gw; i += kThreads) {
      abuf[(tile_rows + i / gw) * ld_r + own0 + i % gw] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();
  layernorm_rows(resid, ld_r, rows, d, g1, b1, ybuf, mean1, rstd1);
  __syncthreads();
  store_block(ybuf + own0, ld_r, valid, gw, ws.y1 + base + own0, d);
  lap(1);

  // q/k/v of this block's heads, [q | k | v] each gw wide, q scaled
  {
    const Cols cols = cols_qkv;
    const int split = product_parts<kRT>(op_qkv, none, 1, nk_d, cols, scratch);
    const float scale = s.q_scale;
    each_pair<kRT>(cols.n, [&](int j, int r, int cp) {
      const float2 v = pair_sum<kRT>(scratch, 0, split, cols.n, j, r, cp);
      const int n = 16 * cols.block(j) + 2 * cp;
      const int part = n / d;
      float v0 = v.x + b_qkv[n], v1 = v.y + b_qkv[n + 1];
      if (part == 0) {
        v0 *= scale;
        v1 *= scale;
      }
      *reinterpret_cast<float2*>(qbuf + r * ld_q + part * gw + n - part * d - own0) =
          make_float2(v0, v1);
    });
  }
  __syncthreads();
  lap(2);
  cluster_wait();
  attention_any_t(qbuf, ld_q, t, dh, mine, s.windows, abuf, ld_r, rank * mine);
  lap(3);
  send_part(abuf + own0, ld_r * 2, gw * 2, 1, 0, rows, bar_a, rank, peers);   // a, to all
  store_block(abuf + own0, ld_r, valid, gw, ws.attn + base + own0, d);
  mbar_wait(bar_a, 0);
  lap(4);

  // h2 = x + a Wproj + bproj: this block's columns
  {
    const Cols cols = cols_d;
    const int split = product_parts<kRT>(op_proj, none, 1, nk_d, cols, scratch);
    each_pair<kRT>(cols.n, [&](int j, int r, int cp) {
      const float2 v = pair_sum<kRT>(scratch, 0, split, cols.n, j, r, cp);
      const int n = own0 + 16 * j + 2 * cp;
      float2* at = reinterpret_cast<float2*>(resid + r * ld_r + n);
      float2 hv = *at;
      hv.x += v.x + b_proj[n];
      hv.y += v.y + b_proj[n + 1];
      *at = hv;
    });
  }
  lap(5);
  send_part(resid + own0, ld_r * 4, gw * 4, 1, 0, rows, bar_h, rank, peers);  // h2, to all
  mbar_wait(bar_h, 0);
  lap(6);
  layernorm_rows(resid, ld_r, rows, d, g2, b2, ybuf, mean2, rstd2);
  // g as a bf16 operand over a (every block has had its copies of a: they
  // all sent h2 after theirs arrived), zeros past the valid rows
  {
    const float4* gg = reinterpret_cast<const float4*>(gout + base);
    for (int i = threadIdx.x; i < rows * d4; i += kThreads) {
      const int r = i / d4;
      const float4 v = r < valid ? __ldg(gg + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(abuf + r * ld_r + 4 * (i - r * d4));
      o[0] = __floats2bfloat162_rn(v.x, v.y);
      o[1] = __floats2bfloat162_rn(v.z, v.w);
    }
    for (int col = threadIdx.x; col < gw; col += kThreads) {
      float sum = 0.f;
      for (int r = 0; r < valid; ++r) sum += __ldg(gout + base + static_cast<long long>(r) * d + own0 + col);
      db_mlp2[own0 + col] += sum;
    }
  }
  __syncthreads();
  store_block(ybuf + own0, ld_r, valid, gw, ws.y2 + base + own0, d);
  store_block(abuf + own0, ld_r, valid, gw, ws.g + base + own0, d);
  lap(7);

  // ---- the MLP: z1 = y2 W1 + bm1 and g W2^T, this block's hidden columns,
  // as one list of items; u = bf16(gelu(z1)), dz1 = (g W2^T) gelu'(z1) ----
  {
    const Cols cols = cols_m;
    const int split = product_parts<kRT>(op_z1, op_gw2, 2, nk_d, cols, scratch);
    each_pair<kRT>(cols.n, [&](int j, int r, int cp) {
      const float2 z = pair_sum<kRT>(scratch, 0, split, cols.n, j, r, cp);
      const float2 gw2 = pair_sum<kRT>(scratch, 1, split, cols.n, j, r, cp);
      const int n = m0 + 16 * j + 2 * cp;
      float a0, a1, d0, d1;
      gelu_tanh_both(z.x + b_mlp1[n], a0, d0);
      gelu_tanh_both(z.y + b_mlp1[n + 1], a1, d1);
      const float2 dz = make_float2(gw2.x * d0, gw2.y * d1);
      // the f32 dz1 over its first part's sums, for the column sums below
      *reinterpret_cast<float2*>(scratch + j * (kRT * 256) + r * 16 + 2 * cp) = dz;
      const __nv_bfloat162 zb = __floats2bfloat162_rn(dz.x, dz.y);
      *reinterpret_cast<__nv_bfloat162*>(dzf + r * ld_z + n) = zb;
      if (r < valid) {
        *reinterpret_cast<__nv_bfloat162*>(ws.u + (grow0 + r) * m + n) =
            __floats2bfloat162_rn(a0, a1);
        *reinterpret_cast<__nv_bfloat162*>(ws.dz1 + (grow0 + r) * m + n) = zb;
      }
    });
    __syncthreads();
    for (int col = threadIdx.x; col < nm * 16; col += kThreads) {
      const float* src = scratch + (col / 16) * (kRT * 256) + col % 16;
      float sum = 0.f;
      for (int r = 0; r < valid; ++r) sum += src[r * 16];
      db_mlp1[m0 + col] += sum;
    }
  }
  lap(8);
  send_part(dzf + m0, ld_z * 2, nm * 32, 1, 0, rows, bar_dz, rank, peers);    // dz1, to all
  mbar_wait(bar_dz, 0);
  lap(9);

  // dy2 = dz1 W1^T: this block's columns
  {
    const Cols cols = cols_d;
    const int split = product_parts<kRT>(op_dy2, none, 1, m / 16, cols, scratch);
    each_pair<kRT>(cols.n, [&](int j, int r, int cp) {
      *reinterpret_cast<float2*>(fbuf + r * ld_r + own0 + 16 * j + 2 * cp) =
          pair_sum<kRT>(scratch, 0, split, cols.n, j, r, cp);
    });
  }
  lap(10);
  send_part(fbuf + own0, ld_r * 4, gw * 4, 1, 0, rows, bar_dy2, rank, peers); // dy2, to all
  mbar_wait(bar_dy2, 0);
  lap(11);

  // ---- LayerNorm 2 backward: its column sums over this block's columns,
  // then dh2 = g + LN2'(dy2) on full rows ----
  layernorm_bwd_columns(fbuf + own0, resid + own0, ld_r, valid, gw, mean2, rstd2, dg2 + own0,
                        db2 + own0);
  __syncthreads();
  {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float inv_d = 1.f / static_cast<float>(d);
    for (int r = warp; r < rows; r += kWarps) {
      float* hr = resid + r * ld_r;
      const float* dy = fbuf + r * ld_r;
      const float mu = mean2[r], rs = rstd2[r];
      float s1 = 0.f, s2 = 0.f;
      for (int i = lane; i < d; i += 32) {
        const float dxh = dy[i] * g2[i];
        s1 += dxh;
        s2 = fmaf(dxh, (hr[i] - mu) * rs, s2);
      }
      const float m1 = warp_sum(s1) * inv_d;
      const float m2 = warp_sum(s2) * inv_d;
      for (int i = lane; i < d; i += 32) {
        const float dxh = dy[i] * g2[i];
        const float xh = (hr[i] - mu) * rs;
        const float gv = r < valid ? __ldg(gout + base + static_cast<long long>(r) * d + i) : 0.f;
        const float v = gv + rs * (dxh - m1 - xh * m2);
        hr[i] = v;
        ybuf[r * ld_r + i] = __float2bfloat16(v);
      }
    }
  }
  __syncthreads();
  add_column_sums(resid + own0, ld_r, valid, gw, db_proj + own0);
  store_block(ybuf + own0, ld_r, valid, gw, ws.dh2 + base + own0, d);
  lap(12);

  // the mix's gradient for this block's heads: da = bf16(dh2) Wproj^T
  {
    const Cols cols = cols_d;
    const int split = product_parts<kRT>(op_da, none, 1, nk_d, cols, scratch);
    each_pair<kRT>(cols.n, [&](int j, int r, int cp) {
      *reinterpret_cast<float2*>(da + r * ld_g + 16 * j + 2 * cp) =
          pair_sum<kRT>(scratch, 0, split, cols.n, j, r, cp);
    });
  }
  __syncthreads();
  lap(13);

  // ---- attention backward of this block's heads: qbuf = [dq | k | dv], dk apart ----
  attention_bwd_lanes_any_t(qbuf, ld_q, da, dk, ld_g, probs, dsc, t, dh, mine, s.windows,
                            s.q_scale);
  // dqkv as bf16 into this block's columns of the full buffer (zeros below
  // the windows), and its f32 column sums
  for (int i = threadIdx.x; i < rows * 3 * (gw / 2); i += kThreads) {
    const int r = i / (3 * (gw / 2));
    const int k = 2 * (i - r * 3 * (gw / 2));
    const int part = k / gw, c = k - part * gw;
    float2 v = make_float2(0.f, 0.f);
    if (r < tile_rows) {
      v = *reinterpret_cast<const float2*>(part == 1 ? dk + r * ld_g + c
                                                     : qbuf + r * ld_q + part * gw + c);
    }
    *reinterpret_cast<__nv_bfloat162*>(dqf + r * ld_dq + part * d + own0 + c) =
        __floats2bfloat162_rn(v.x, v.y);
  }
  for (int k = threadIdx.x; k < 3 * gw; k += kThreads) {
    const int part = k / gw, c = k - part * gw;
    float sum = 0.f;
    for (int r = 0; r < valid; ++r) sum += part == 1 ? dk[r * ld_g + c] : qbuf[r * ld_q + k];
    db_qkv[part * d + own0 + c] += sum;
  }
  lap(14);
  send_part(dqf + own0, ld_dq * 2, gw * 2, 3, d * 2, rows, bar_dq, rank, peers);   // dqkv
  // x again, for LN1's VJP, over ybuf and abuf (da and dk are done with)
  {
    const float4* xg = reinterpret_cast<const float4*>(x + base);
    for (int i = threadIdx.x; i < valid * d4; i += kThreads) {
      const int r = i / d4;
      *reinterpret_cast<float4*>(xs + r * ld_r + 4 * (i - r * d4)) = __ldg(xg + i);
    }
  }
  for (int part = 0; part < 3; ++part) {
    const int c0 = part * d + own0;
    store_block(dqf + c0, ld_dq, valid, gw, ws.dqkv + grow0 * 3 * d + c0, 3 * d);
  }
  mbar_wait(bar_dq, 0);
  lap(15);

  // dy1 = bf16(dqkv) Wqkv^T: this block's columns
  {
    const Cols cols = cols_d;
    const int split = product_parts<kRT>(op_dy1, none, 1, 3 * nk_d, cols, scratch);
    each_pair<kRT>(cols.n, [&](int j, int r, int cp) {
      *reinterpret_cast<float2*>(fbuf + r * ld_r + own0 + 16 * j + 2 * cp) =
          pair_sum<kRT>(scratch, 0, split, cols.n, j, r, cp);
    });
  }
  lap(16);
  send_part(fbuf + own0, ld_r * 4, gw * 4, 1, 0, rows, bar_dy1, rank, peers); // dy1, to all
  mbar_wait(bar_dy1, 0);
  lap(17);
  // this block has all it was sent; the others may end once every block
  // has, when no copy reads their shared memory any more
  cluster_arrive_relaxed();

  // ---- LayerNorm 1 backward; dx = dh2 + LN1'(dy1), this block's columns ----
  layernorm_bwd_columns(fbuf + own0, xs + own0, ld_r, valid, gw, mean1, rstd1, dg1 + own0,
                        db1 + own0);
  {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float inv_d = 1.f / static_cast<float>(d);
    for (int r = warp; r < valid; r += kWarps) {
      const float* xr = xs + r * ld_r;
      const float* dy = fbuf + r * ld_r;
      const float mu = mean1[r], rs = rstd1[r];
      float s1 = 0.f, s2 = 0.f;
      for (int i = lane; i < d; i += 32) {
        const float dxh = dy[i] * g1[i];
        s1 += dxh;
        s2 = fmaf(dxh, (xr[i] - mu) * rs, s2);
      }
      const float m1 = warp_sum(s1) * inv_d;
      const float m2 = warp_sum(s2) * inv_d;
      float* dxr = dx + base + static_cast<long long>(r) * d;
      for (int i = own0 + lane; i < own0 + gw; i += 32) {
        const float dxh = dy[i] * g1[i];
        const float xh = (xr[i] - mu) * rs;
        dxr[i] = resid[r * ld_r + i] + rs * (dxh - m1 - xh * m2);
      }
    }
  }
  __syncthreads();
  lap(18);
  cluster_wait();
}

// Scratch the small shape's products need at most (floats), for the check of
// the plan: every product's items x parts x 256 floats a row tile.
int small_scratch_floats(int d, int m, int cluster, int row_tiles) {
  const int nd = d / 16 / cluster, nm = m / 16 / cluster;
  const int prods[6][3] = {{1, 3 * nd, d / 16}, {1, nd, d / 16}, {2, nm, d / 16},
                           {1, nd, m / 16},     {1, nd, d / 16}, {1, nd, 3 * d / 16}};
  int most = 0;
  for (const auto& p : prods) {
    const int need = p[0] * p[1] * small_split(p[0] * p[1], p[2]) * row_tiles * 256;
    most = need > most ? need : most;
  }
  return most;
}

template <int kRT>
cudaError_t launch_cluster_tile(const SmallPlan& s, size_t smem, const float* x, const float* g,
                                const bf16* w, const bf16* wt, const float* vec, float* dx,
                                bf16* ws, float* vpart, long long* clocks,
                                cudaStream_t stream) {
  auto kernel = encoder_bwd_tile_kernel_cluster<kRT>;
  const cudaError_t err = ensure_dynamic_smem<EncoderBwdClusterTag<kRT>>(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (s.batch + s.windows - 1) / s.windows;
  return launch_cluster(kernel, tiles * s.cluster, kThreads, s.cluster, smem, stream, x, g, w,
                        wt, vec, dx, ws, vpart, s, clocks);
}

// ---- the pair shape: two blocks of a cluster share one weight stream ----

// Its layout at d = 256 (fused_encoder.py::_bwd_pair_layout is the same):
// offsets in bytes, strides in elements. Rows of f32 [rows][d] buffers are
// d + 4 wide; the 4 columns past d hold the row's LN statistics (mean1,
// rstd1, mean2, rstd2).
constexpr int kPD = 256;                      // the width the pair shape takes
constexpr int kPRows = 32;                    // a block's row tile
constexpr int kPLdF = kPD + 4;
constexpr int kPLdB = kPD + 8;                // bf16 [rows][d]
constexpr int kPLdQ = 3 * kPD + 8;            // bf16 q/k/v
constexpr int kPChunk = 256;                  // hidden columns an MLP chunk
using PairRing = WeightRing<3, 4>;           // three slots of 4 k-steps (32 KB)
constexpr int kSlotBytes = PairRing::kSlotBytes;
constexpr int kSlots = PairRing::kSlots;
constexpr int kPairThreads = kThreads + 128;  // 4 consumer warpgroups and the producer's
// Registers a thread after setmaxnreg: the producer warpgroup gives what the
// consumers take, within the block's 640 x 96 (ptxas's launch count).
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 112;
static_assert(4 * kProducerRegs + 16 * kConsumerRegs <= 20 * 96, "setmaxnreg over budget");
constexpr int kPOffF = 0;                                   // x, h2, dh2, x again (f32)
constexpr int kPOffB = kPOffF + kPRows * kPLdF * 4;         // y1, a, y2, dh2 (bf16)
constexpr int kPOffQ = kPOffB + kPRows * kPLdB * 2;         // q/k/v, then dq/dk/dv (bf16)
constexpr int kPOffM = kPOffQ + kPRows * kPLdQ * 2;         // g (bf16); dy2, dy1 (f32); da (bf16)
constexpr int kPOffDz = kPOffM + kPRows * kPLdB * 2;        // a chunk of dz1 (bf16)
constexpr int kPOffRing = kPOffDz + kPRows * kPLdB * 2;     // kSlots slots of weights
constexpr int kPOffBar = kPOffRing + kSlots * kSlotBytes;   // full[kSlots], empty[kSlots]
constexpr int kPSmem = kPOffBar + 2 * kSlots * 8;
constexpr int kPairPlanInts = 9;
static_assert(kPOffM + kPRows * kPLdF * 4 <= kPOffRing, "dy2 overruns the ring");
static_assert(kPSmem <= kMaxSmem, "the pair shape's layout exceeds shared memory");
// Phases the pair shape's cycle counters time, summed over a block's tiles,
// and last the cycles its warp 0 waited for weights within them.
constexpr int kPairPhases = 14;

struct EncoderBwdPairTag {};

struct PairShape {
  int batch, t, m, heads, windows;
  float q_scale;
};

// acc += A (32 rows, bf16 in shared memory, stride lda) x the next n_slots
// slots of the stream, this warp's 16-column block (block `warp` of every
// slot), slot j holding k-steps 4 j .. 4 j + 3 of A. acc[rt][j][e] is row
// 16 rt + g (+ 8 for e >= 2), column 8 j + 2 c (+ 1 for odd e).
__device__ __forceinline__ void stream_mma(PairRing::Reader& r, const bf16* a, int lda,
                                           int n_slots, float (&acc)[2][2][4],
                                           long long* waited) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bf16* a0 = a + (lane & 15) * lda + (lane >> 4) * 8;
  for (int j = 0; j < n_slots; ++j) {
    const uint4* w = r.take(waited) + warp * PairRing::kKs * 32 + lane;
    uint4 b[PairRing::kKs];
#pragma unroll
    for (int ks = 0; ks < PairRing::kKs; ++ks) b[ks] = w[ks * 32];
#pragma unroll
    for (int ks = 0; ks < PairRing::kKs; ++ks) {
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        unsigned af[4];
        ldmatrix_x4(af, a0 + rt * 16 * lda + 16 * (PairRing::kKs * j + ks));
        mma_bf16(acc[rt][0], af, b[ks].x, b[ks].y);
        mma_bf16(acc[rt][1], af, b[ks].z, b[ks].w);
      }
    }
    r.give();
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][2][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i >> 3][(i >> 2) & 1][i & 3] = 0.f;
}

// s[j][e] summed over the warp's 8 lane rows (lanes of one c) by shuffles in
// a fixed order; lanes 0..3 then add column 8 j + 2 c + e's sum to dst.
__device__ __forceinline__ void fold_columns(float (&s)[2][2], float* dst) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = s[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      s[j][e] = v;
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      dst[8 * j + 2 * lane] += s[j][0];
      dst[8 * j + 2 * lane + 1] += s[j][1];
    }
  }
}

// LayerNorm of the tile's rows of src (f32, stride kPLdF) into dst (bf16,
// stride kPLdB), a warp a row; the mean and 1/std go to columns d + stat
// and d + stat + 1 of the row.
__device__ __forceinline__ void pair_layernorm(float* src, bf16* dst,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias, int stat) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr float inv_d = 1.f / kPD;
  for (int r = warp; r < kPRows; r += kWarps) {
    float* x = src + r * kPLdF;
    float v[kPD / 32];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPD / 32; ++i) {
      v[i] = x[lane + 32 * i];
      sum += v[i];
    }
    const float mu = warp_sum(sum) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kPD / 32; ++i) sq = fmaf(v[i] - mu, v[i] - mu, sq);
    const float rs = rsqrtf(warp_sum(sq) * inv_d + kLnEps);
    if (lane == 0) {
      x[kPD + stat] = mu;
      x[kPD + stat + 1] = rs;
    }
#pragma unroll
    for (int i = 0; i < kPD / 32; ++i) {
      const int col = lane + 32 * i;
      dst[r * kPLdB + col] =
          __float2bfloat16((v[i] - mu) * rs * __ldg(scale + col) + __ldg(bias + col));
    }
  }
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Scores and probabilities of one (window, head) on mma: rows are the
// window's frames padded to 16 (from row r0; rows past the buffer read its
// last row), columns its frames as keys. p[nt][e]: query g (+ 8 for e >=
// 2), key 8 nt + 2 c (+ 1 for odd e); keys past t get 0, queries past t a
// row of 0.
template <int kDh>
__device__ __forceinline__ void window_probs(const bf16* q, int r0, int t, int h,
                                             float (&p)[2][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const bf16* qa = q + min(r0 + (lane & 15), kPRows - 1) * kPLdQ + h * kDh + (lane >> 4) * 8;
  const bf16* kb = q + min(r0 + (lane & 7) + ((lane >> 4) << 3), kPRows - 1) * kPLdQ + kPD +
                   h * kDh + ((lane >> 3) & 1) * 8;
  float s[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    unsigned af[4], bfr[4];
    ldmatrix_x4(af, qa + 16 * kk);
    ldmatrix_x4(bfr, kb + 16 * kk);
    mma_bf16(s[0], af, bfr[0], bfr[1]);
    mma_bf16(s[1], af, bfr[2], bfr[3]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * nt + 2 * c + e < t) mx = fmaxf(mx, s[nt][2 * hh + e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float z = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = 8 * nt + 2 * c + e < t ? expf(s[nt][2 * hh + e] - mx) : 0.f;
        p[nt][2 * hh + e] = v;
        z += v;
      }
    }
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    const float inv_z = g + 8 * hh < t ? 1.f / z : 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      p[nt][2 * hh] *= inv_z;
      p[nt][2 * hh + 1] *= inv_z;
    }
  }
}

// a = P v for one (window, head), as bf16 into the window's rows of dst.
template <int kDh>
__device__ __forceinline__ void window_attention(const bf16* q, bf16* dst, int r0, int t,
                                                 int h) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  float p[2][4];
  window_probs<kDh>(q, r0, t, h, p);
  const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                          pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
  const bf16* vb = q + min(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, kPRows - 1) * kPLdQ +
                   2 * kPD + h * kDh + (lane >> 4) * 8;
#pragma unroll
  for (int nn = 0; nn < kDh / 16; ++nn) {
    unsigned bfr[4];
    ldmatrix_x4_trans(bfr, vb + 16 * nn);
    float o[2][4] = {};
    mma_bf16(o[0], pa, bfr[0], bfr[1]);
    mma_bf16(o[1], pa, bfr[2], bfr[3]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (g + 8 * hh < t) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dst + (r0 + g + 8 * hh) * kPLdB + h * kDh +
                                             16 * nn + 8 * j + 2 * c) =
              __floats2bfloat162_rn(o[j][2 * hh], o[j][2 * hh + 1]);
        }
      }
    }
  }
}

// o[j][e] (rows g and g + 8 of a 16 x 16 tile, columns 8 j + 2 c + e) as
// bf16 into rows r0 + row < r0 + t of dst at column col0, and their sum over
// those rows into sums[col0 ..] (a fixed order).
__device__ __forceinline__ void window_out(const float (&o)[2][4], bf16* dst, int r0, int t,
                                          int col0, float* sums) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  float s[2][2] = {};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (g + 8 * hh < t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dst + (r0 + g + 8 * hh) * kPLdQ + col0 + 8 * j +
                                           2 * c) =
            __floats2bfloat162_rn(o[j][2 * hh], o[j][2 * hh + 1]);
        s[j][0] += o[j][2 * hh];
        s[j][1] += o[j][2 * hh + 1];
      }
    }
  }
  fold_columns(s, sums + col0);
}

// The attention backward of one (window, head) on mma, in place: q/k/v of
// the window's rows become dq/dk/dv (bf16) and their column sums go to
// dbqkv. da: the gradient of the mix (bf16 [rows][kPLdB]).
template <int kDh>
__device__ __forceinline__ void window_attention_bwd(bf16* q, const bf16* da, int r0, int t,
                                                     int h, float q_scale, float* dbqkv) {
  const int lane = threadIdx.x & 31;
  float p[2][4];
  window_probs<kDh>(q, r0, t, h, p);
  // dp = da v^T
  float dp[2][4] = {};
  {
    const bf16* aa = da + min(r0 + (lane & 15), kPRows - 1) * kPLdB + h * kDh + (lane >> 4) * 8;
    const bf16* vb = q + min(r0 + (lane & 7) + ((lane >> 4) << 3), kPRows - 1) * kPLdQ +
                     2 * kPD + h * kDh + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      unsigned af[4], bfr[4];
      ldmatrix_x4(af, aa + 16 * kk);
      ldmatrix_x4(bfr, vb + 16 * kk);
      mma_bf16(dp[0], af, bfr[0], bfr[1]);
      mma_bf16(dp[1], af, bfr[2], bfr[3]);
    }
  }
  // dS = P (dp - sum_j P dp), rows of queries
  float ds[2][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float tot = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      tot = fmaf(p[nt][2 * hh], dp[nt][2 * hh], tot);
      tot = fmaf(p[nt][2 * hh + 1], dp[nt][2 * hh + 1], tot);
    }
    tot += __shfl_xor_sync(0xffffffffu, tot, 1);
    tot += __shfl_xor_sync(0xffffffffu, tot, 2);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      ds[nt][2 * hh] = p[nt][2 * hh] * (dp[nt][2 * hh] - tot);
      ds[nt][2 * hh + 1] = p[nt][2 * hh + 1] * (dp[nt][2 * hh + 1] - tot);
    }
  }
  // P and dS as A operands (queries x keys), and transposed (keys x queries)
  const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                          pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
  const unsigned sa[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                          pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
  const unsigned pt[4] = {movmatrix_trans(pa[0]), movmatrix_trans(pa[2]),
                          movmatrix_trans(pa[1]), movmatrix_trans(pa[3])};
  const unsigned st[4] = {movmatrix_trans(sa[0]), movmatrix_trans(sa[2]),
                          movmatrix_trans(sa[1]), movmatrix_trans(sa[3])};
  // B operands [frames][dh] by transposed loads, 16 columns of the head at a time
  const int row = min(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, kPRows - 1);
  const bf16* dab = da + row * kPLdB + h * kDh + (lane >> 4) * 8;
  const bf16* qb = q + row * kPLdQ + h * kDh + (lane >> 4) * 8;
#pragma unroll
  for (int nn = 0; nn < kDh / 16; ++nn) {
    const int col = h * kDh + 16 * nn;
    unsigned b_da[4], b_q[4], b_k[4];
    ldmatrix_x4_trans(b_da, dab + 16 * nn);
    ldmatrix_x4_trans(b_q, qb + 16 * nn);
    ldmatrix_x4_trans(b_k, qb + kPD + 16 * nn);
    float dv[2][4] = {}, dk[2][4] = {}, dq[2][4] = {};
    mma_bf16(dv[0], pt, b_da[0], b_da[1]);       // dv = P^T da
    mma_bf16(dv[1], pt, b_da[2], b_da[3]);
    mma_bf16(dk[0], st, b_q[0], b_q[1]);         // dk = dS^T q (q carries the scale)
    mma_bf16(dk[1], st, b_q[2], b_q[3]);
    mma_bf16(dq[0], sa, b_k[0], b_k[1]);         // dq = dS k dh^-0.5
    mma_bf16(dq[1], sa, b_k[2], b_k[3]);
#pragma unroll
    for (int i = 0; i < 8; ++i) dq[i >> 2][i & 3] *= q_scale;
    __syncwarp();                                // every lane has read q and k of these columns
    window_out(dq, q, r0, t, col, dbqkv);
    window_out(dk, q, r0, t, kPD + col, dbqkv);
    window_out(dv, q, r0, t, 2 * kPD + col, dbqkv);
  }
}

// Every (window, head) of the tile's n_win windows: a warp takes heads
// warp, warp + 16, .. and their windows in order.
template <int kDh>
__device__ __forceinline__ void pair_attention(bf16* q, bf16* dst, const bf16* da, int n_win,
                                               int t, int heads, float q_scale, float* dbqkv,
                                               bool backward) {
  for (int h = threadIdx.x >> 5; h < heads; h += kWarps) {
    for (int w = 0; w < n_win; ++w) {
      if (backward) {
        window_attention_bwd<kDh>(q, da, w * t, t, h, q_scale, dbqkv);
      } else {
        window_attention<kDh>(q, dst, w * t, t, h);
      }
    }
  }
}

__device__ __forceinline__ void pair_attention_any(bf16* q, bf16* dst, const bf16* da, int n_win,
                                                   int t, int heads, float q_scale,
                                                   float* dbqkv, bool backward) {
  switch (kPD / heads) {
    case 16:
      pair_attention<16>(q, dst, da, n_win, t, heads, q_scale, dbqkv, backward);
      break;
    case 32:
      pair_attention<32>(q, dst, da, n_win, t, heads, q_scale, dbqkv, backward);
      break;
    default:
      pair_attention<64>(q, dst, da, n_win, t, heads, q_scale, dbqkv, backward);
  }
}

// The producer warp: the weights every tile multiplies by, in the order the
// consumers take them (fused_encoder.py::bwd_pair_stream), fill by fill
// into the ring (WeightRing, encoder_common.cuh).
__device__ __forceinline__ void pair_produce(const bf16* w, const bf16* wt, int m, int tiles,
                                             unsigned ring, unsigned full, unsigned empty,
                                             int rank) {
  const bf16* const w_qkv = w;
  const bf16* const w_proj = w_qkv + 3LL * kPD * kPD;
  const bf16* const w_mlp1 = w_proj + 1LL * kPD * kPD;
  const bf16* const wt_qkv = wt;
  const bf16* const wt_proj = wt_qkv + 3LL * kPD * kPD;
  const bf16* const wt_mlp1 = wt_proj + 1LL * kPD * kPD;
  const bf16* const wt_mlp2 = wt_mlp1 + 1LL * kPD * m;
  PairRing::Writer wr{ring, full, empty, rank, 0, 0};
  for (int tile = 0; tile < tiles; ++tile) {
    for (int grp = 0; grp < 3; ++grp) wr.put_all(w_qkv, 16, 16 * grp, 0, 16);
    wr.put_all(w_proj, 16, 0, 0, 16);
    for (int c0 = 0; c0 < m; c0 += kPChunk) {
      wr.put_all(w_mlp1, 16, c0 / 16, 0, 16);
      wr.put_all(wt_mlp2, 16, c0 / 16, 0, 16);
      wr.put_all(wt_mlp1, m / 16, 0, c0 / 16, 16);
    }
    wr.put_all(wt_proj, 16, 0, 0, 16);
    wr.put_all(wt_qkv, 48, 0, 0, 48);
  }
}

// The tile kernel's pair shape at d = 256: clusters of two blocks, each
// block its own tile of 32 rows (whole windows) with all the columns, the
// pair walking over pairs of tiles. One stream of weights feeds both
// blocks: the producer warps copy each fill once into both blocks' rings,
// so a weight byte read from L2 serves 64 rows. Consumers take B from the
// ring, A from their tile (mma.sync); q/k/v stay bf16 in shared memory over
// the MLP; the attention, forward and backward, runs on mma a (window,
// head) a warp; six of the eight vector gradients are summed in the
// epilogues that produce their terms. The order is the large shape's, and
// every sum is in a fixed order.
__global__ void __launch_bounds__(kPairThreads, 1)
encoder_bwd_tile_kernel_pair(const float* __restrict__ x, const float* __restrict__ gout,
                             const bf16* __restrict__ w, const bf16* __restrict__ wt,
                             const float* __restrict__ vec, float* dx, bf16* ws_base,
                             float* vpart_base, PairShape s, long long* __restrict__ clocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int rank = static_cast<int>(cluster_ctarank());
  const int t = s.t, m = s.m;
  const int n_pairs = ((s.batch + s.windows - 1) / s.windows + 1) / 2;
  const int cluster = static_cast<int>(blockIdx.x) / 2, clusters = static_cast<int>(gridDim.x) / 2;
  const int tiles = cluster < n_pairs ? (n_pairs - 1 - cluster) / clusters + 1 : 0;
  const unsigned ring = smem_u32(smem + kPOffRing);
  const unsigned full = smem_u32(smem + kPOffBar);
  const unsigned empty = full + 8 * kSlots;
  const int n_vec = 9 * kPD + m;
  float* const vp = vpart_base + static_cast<long long>(blockIdx.x) * n_vec;
  long long* const clk =
      clocks != nullptr && threadIdx.x == 0 ? clocks + blockIdx.x * kPairPhases : nullptr;

  if (threadIdx.x == 0) PairRing::init(full, empty, kWarps);
  for (int i = threadIdx.x; i < n_vec; i += kPairThreads) vp[i] = 0.f;
  if (clk != nullptr) {
    for (int i = 0; i < kPairPhases; ++i) clk[i] = 0;
  }
  cluster_sync_all();

  if (warp >= kWarps) {                         // the producer warpgroup: one warp copies
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kWarps) {
      pair_produce(w, wt, m, tiles, ring, full, empty, rank);
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
  PairRing::Reader rg{smem + kPOffRing, full, empty, cluster_map(empty, rank ^ 1), 0, 0};

  float* const hb = reinterpret_cast<float*>(smem + kPOffF);
  bf16* const ab = reinterpret_cast<bf16*>(smem + kPOffB);
  bf16* const qb = reinterpret_cast<bf16*>(smem + kPOffQ);
  bf16* const gb = reinterpret_cast<bf16*>(smem + kPOffM);
  bf16* const dab = reinterpret_cast<bf16*>(smem + kPOffM);
  float* const fb = reinterpret_cast<float*>(smem + kPOffM);
  bf16* const dzb = reinterpret_cast<bf16*>(smem + kPOffDz);

  const float* const g1 = vec;
  const float* const b1 = g1 + kPD;
  const float* const b_qkv = b1 + kPD;
  const float* const b_proj = b_qkv + 3 * kPD;
  const float* const g2 = b_proj + kPD;
  const float* const b2 = g2 + kPD;
  const float* const b_mlp1 = b2 + kPD;
  float* const dg1 = vp;
  float* const db1 = dg1 + kPD;
  float* const db_qkv = db1 + kPD;
  float* const db_proj = db_qkv + 3 * kPD;
  float* const dg2 = db_proj + kPD;
  float* const db2 = dg2 + kPD;
  float* const db_mlp1 = db2 + kPD;
  float* const db_mlp2 = db_mlp1 + m;
  const Workspace ws = carve_workspace(ws_base, static_cast<long long>(s.batch) * t, kPD, m);
  constexpr int d4 = kPD / 4;
  const int n0 = 16 * warp;                  // this warp's columns of a 256-wide output

  for (int it = 0; it < tiles; ++it) {
    lap(0);
    const int tile = 2 * (cluster + it * clusters) + rank;
    const int win0 = tile * s.windows;
    const int n_win = max(0, min(s.windows, s.batch - win0));
    const int valid = n_win * t;
    const long long grow0 = static_cast<long long>(win0) * t;
    const long long base = grow0 * kPD;
    const float4* const xs = reinterpret_cast<const float4*>(x + base);

    // ---- recompute the forward ----
    for (int i = threadIdx.x; i < kPRows * d4; i += kThreads) {
      const int r = i / d4;
      *reinterpret_cast<float4*>(hb + r * kPLdF + 4 * (i - r * d4)) =
          r < valid ? __ldg(xs + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    sync();
    pair_layernorm(hb, ab, g1, b1, 0);
    sync();
    store_block(ab, kPLdB, valid, kPD, ws.y1 + base, kPD);
    lap(1);
    for (int grp = 0; grp < 3; ++grp) {          // q (scaled), k, v: 256 columns each
      float acc[2][2][4];
      zero_acc(acc);
      stream_mma(rg, ab, kPLdB, 4, acc, wait_at);
      const float scale = grp == 0 ? s.q_scale : 1.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rt = i >> 2, j = (i >> 1) & 1, hh = i & 1;
        const int n = grp * kPD + n0 + 8 * j + 2 * c;
        *reinterpret_cast<__nv_bfloat162*>(qb + (16 * rt + g + 8 * hh) * kPLdQ + n) =
            __floats2bfloat162_rn((acc[rt][j][2 * hh] + __ldg(b_qkv + n)) * scale,
                                  (acc[rt][j][2 * hh + 1] + __ldg(b_qkv + n + 1)) * scale);
      }
    }
    sync();
    lap(2);
    pair_attention_any(qb, ab, nullptr, n_win, t, s.heads, s.q_scale, nullptr, false);
    sync();
    store_block(ab, kPLdB, valid, kPD, ws.attn + base, kPD);
    lap(3);
    {                                            // h2 = x + a Wproj + bproj
      float acc[2][2][4];
      zero_acc(acc);
      stream_mma(rg, ab, kPLdB, 4, acc, wait_at);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rt = i >> 2, j = (i >> 1) & 1, hh = i & 1;
        const int n = n0 + 8 * j + 2 * c;
        float2* at = reinterpret_cast<float2*>(hb + (16 * rt + g + 8 * hh) * kPLdF + n);
        float2 hv = *at;
        hv.x += acc[rt][j][2 * hh] + __ldg(b_proj + n);
        hv.y += acc[rt][j][2 * hh + 1] + __ldg(b_proj + n + 1);
        *at = hv;
      }
    }
    sync();
    lap(4);
    pair_layernorm(hb, ab, g2, b2, 2);
    {                                            // g as a bf16 operand; its column sums
      const float4* gs = reinterpret_cast<const float4*>(gout + base);
      for (int i = threadIdx.x; i < kPRows * d4; i += kThreads) {
        const int r = i / d4;
        const float4 v = r < valid ? __ldg(gs + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(gb + r * kPLdB + 4 * (i - r * d4));
        o[0] = __floats2bfloat162_rn(v.x, v.y);
        o[1] = __floats2bfloat162_rn(v.z, v.w);
      }
      if (threadIdx.x < kPD) {
        float sum = 0.f;
        for (int r = 0; r < valid; ++r) sum += __ldg(gout + base + r * kPD + threadIdx.x);
        db_mlp2[threadIdx.x] += sum;
      }
    }
    sync();
    store_block(ab, kPLdB, valid, kPD, ws.y2 + base, kPD);
    store_block(gb, kPLdB, valid, kPD, ws.g + base, kPD);
    lap(5);

    // ---- the MLP a chunk of hidden columns at a time; dy2 stays in registers ----
    float dy2[2][2][4];
    zero_acc(dy2);
    for (int c0 = 0; c0 < m; c0 += kPChunk) {
      float z[2][2][4], gw[2][2][4];
      zero_acc(z);
      zero_acc(gw);
      stream_mma(rg, ab, kPLdB, 4, z, wait_at);    // y2 W1
      stream_mma(rg, gb, kPLdB, 4, gw, wait_at);   // bf16(g) W2^T
      float cs[2][2] = {};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rt = i >> 2, j = (i >> 1) & 1, hh = i & 1;
        const int r = 16 * rt + g + 8 * hh;
        const int n = n0 + 8 * j + 2 * c;
        float a0, a1, d0, d1;
        gelu_tanh_both(z[rt][j][2 * hh] + __ldg(b_mlp1 + c0 + n), a0, d0);
        gelu_tanh_both(z[rt][j][2 * hh + 1] + __ldg(b_mlp1 + c0 + n + 1), a1, d1);
        const float dz0 = gw[rt][j][2 * hh] * d0, dz1 = gw[rt][j][2 * hh + 1] * d1;
        *reinterpret_cast<__nv_bfloat162*>(dzb + r * kPLdB + n) = __floats2bfloat162_rn(dz0, dz1);
        if (r < valid) {
          *reinterpret_cast<__nv_bfloat162*>(ws.u + (grow0 + r) * m + c0 + n) =
              __floats2bfloat162_rn(a0, a1);
          cs[j][0] += dz0;
          cs[j][1] += dz1;
        }
      }
      fold_columns(cs, db_mlp1 + c0 + n0);
      sync();
      store_block(dzb, kPLdB, valid, kPChunk, ws.dz1 + grow0 * m + c0, m);
      stream_mma(rg, dzb, kPLdB, 4, dy2, wait_at); // dy2 += bf16(dz1) W1^T[chunk]
      sync();
    }
    lap(6);
    {                                            // dy2 to shared memory; LN2's column sums
      float sg[2][2] = {}, sb[2][2] = {};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rt = i >> 2, j = (i >> 1) & 1, hh = i & 1;
        const int r = 16 * rt + g + 8 * hh;
        const int n = n0 + 8 * j + 2 * c;
        const float v0 = dy2[rt][j][2 * hh], v1 = dy2[rt][j][2 * hh + 1];
        *reinterpret_cast<float2*>(fb + r * kPLdF + n) = make_float2(v0, v1);
        if (r < valid) {
          const float* hr = hb + r * kPLdF;
          const float mu = hr[kPD + 2], rs = hr[kPD + 3];
          sg[j][0] = fmaf(v0, (hr[n] - mu) * rs, sg[j][0]);
          sg[j][1] = fmaf(v1, (hr[n + 1] - mu) * rs, sg[j][1]);
          sb[j][0] += v0;
          sb[j][1] += v1;
        }
      }
      fold_columns(sg, dg2 + n0);
      fold_columns(sb, db2 + n0);
    }
    sync();
    lap(7);
    // ---- LayerNorm 2 backward: dh2 = g + LN2'(dy2), parked in dx ----
    for (int r = warp; r < kPRows; r += kWarps) {
      float* hr = hb + r * kPLdF;
      const float* dy = fb + r * kPLdF;
      const float mu = hr[kPD + 2], rs = hr[kPD + 3];
      float dxh[kPD / 32], xh[kPD / 32];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < kPD / 32; ++i) {
        const int col = lane + 32 * i;
        dxh[i] = dy[col] * __ldg(g2 + col);
        xh[i] = (hr[col] - mu) * rs;
        s1 += dxh[i];
        s2 = fmaf(dxh[i], xh[i], s2);
      }
      const float m1 = warp_sum(s1) * (1.f / kPD);
      const float m2 = warp_sum(s2) * (1.f / kPD);
#pragma unroll
      for (int i = 0; i < kPD / 32; ++i) {
        const int col = lane + 32 * i;
        const float gv = r < valid ? __ldg(gout + base + r * kPD + col) : 0.f;
        const float v = gv + rs * (dxh[i] - m1 - xh[i] * m2);
        hr[col] = v;
        ab[r * kPLdB + col] = __float2bfloat16(v);
        if (r < valid) dx[base + r * kPD + col] = v;
      }
    }
    sync();
    add_column_sums(hb, kPLdF, valid, kPD, db_proj);
    store_block(ab, kPLdB, valid, kPD, ws.dh2 + base, kPD);
    lap(8);
    {                                            // the mix's gradient da = bf16(dh2) Wproj^T
      float acc[2][2][4];
      zero_acc(acc);
      stream_mma(rg, ab, kPLdB, 4, acc, wait_at);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rt = i >> 2, j = (i >> 1) & 1, hh = i & 1;
        *reinterpret_cast<__nv_bfloat162*>(dab + (16 * rt + g + 8 * hh) * kPLdB + n0 + 8 * j +
                                           2 * c) =
            __floats2bfloat162_rn(acc[rt][j][2 * hh], acc[rt][j][2 * hh + 1]);
      }
    }
    sync();
    lap(9);
    pair_attention_any(qb, nullptr, dab, n_win, t, s.heads, s.q_scale, db_qkv, true);
    sync();
    lap(10);
    store_block(qb, kPLdQ, valid, 3 * kPD, ws.dqkv + grow0 * 3 * kPD, 3 * kPD);
    for (int i = threadIdx.x; i < kPRows * d4; i += kThreads) {   // x again, for LN1's VJP
      const int r = i / d4;
      *reinterpret_cast<float4*>(hb + r * kPLdF + 4 * (i - r * d4)) =
          r < valid ? __ldg(xs + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    sync();
    lap(11);
    {                                            // dy1 = bf16(dqkv) Wqkv^T; LN1's column sums
      float acc[2][2][4];
      zero_acc(acc);
      stream_mma(rg, qb, kPLdQ, 12, acc, wait_at);
      float sg[2][2] = {}, sb[2][2] = {};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rt = i >> 2, j = (i >> 1) & 1, hh = i & 1;
        const int r = 16 * rt + g + 8 * hh;
        const int n = n0 + 8 * j + 2 * c;
        const float v0 = acc[rt][j][2 * hh], v1 = acc[rt][j][2 * hh + 1];
        *reinterpret_cast<float2*>(fb + r * kPLdF + n) = make_float2(v0, v1);
        if (r < valid) {
          const float* xr = hb + r * kPLdF;
          const float mu = xr[kPD], rs = xr[kPD + 1];
          sg[j][0] = fmaf(v0, (xr[n] - mu) * rs, sg[j][0]);
          sg[j][1] = fmaf(v1, (xr[n + 1] - mu) * rs, sg[j][1]);
          sb[j][0] += v0;
          sb[j][1] += v1;
        }
      }
      fold_columns(sg, dg1 + n0);
      fold_columns(sb, db1 + n0);
    }
    sync();
    lap(12);
    // ---- LayerNorm 1 backward; dx = dh2 + LN1'(dy1) ----
    for (int r = warp; r < valid; r += kWarps) {
      const float* xr = hb + r * kPLdF;
      const float* dy = fb + r * kPLdF;
      float* dxr = dx + base + r * kPD;
      const float mu = xr[kPD], rs = xr[kPD + 1];
      float dxh[kPD / 32], xh[kPD / 32];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < kPD / 32; ++i) {
        const int col = lane + 32 * i;
        dxh[i] = dy[col] * __ldg(g1 + col);
        xh[i] = (xr[col] - mu) * rs;
        s1 += dxh[i];
        s2 = fmaf(dxh[i], xh[i], s2);
      }
      const float m1 = warp_sum(s1) * (1.f / kPD);
      const float m2 = warp_sum(s2) * (1.f / kPD);
#pragma unroll
      for (int i = 0; i < kPD / 32; ++i) {
        const int col = lane + 32 * i;
        dxr[col] += rs * (dxh[i] - m1 - xh[i] * m2);
      }
    }
    sync();
    lap(13);
  }
  if (clk != nullptr) clk[kPairPhases - 1] = waited;
  cluster_sync_all();
}

// The weight-gradient kernel and the ordered reduce, after any shape of the
// tile kernel (`slabs` blocks wrote vector partial sums of n_vec floats;
// none for the stage alone). plan: WgradPlan.as_ints (tile_n, splits,
// boxes_per_split, blocks), checked against the shape. With one range the
// kernel writes the weight gradients into grads itself (wpart unused) and
// the reduce adds the vector slabs alone, if there are any.
cudaError_t launch_wgrad_and_reduce(const bf16* ws, float* wpart, const float* vpart, int slabs,
                                    int n_vec, int n, int d, int m, const int* plan,
                                    float* grads, cudaStream_t st) {
  if (plan == nullptr || n < 1) return cudaErrorInvalidValue;
  WgradShape s{};
  s.n = n;
  s.d = d;
  s.m = m;
  s.tile_n = plan[0];
  s.splits = plan[1];
  s.boxes_per_split = plan[2];
  const int blocks = plan[3];
  const int n_boxes = (n + kWgBox - 1) / kWgBox;
  if ((s.tile_n != kWgMaxN && s.tile_n != kWgMaxN / 2) || s.boxes_per_split < 1 ||
      s.splits != (n_boxes + s.boxes_per_split - 1) / s.boxes_per_split) {
    return cudaErrorInvalidValue;     // every range holds at least one box
  }
  s.tiles = wg_tile_count(d, m, s.tile_n);
  s.items = s.tiles * s.splits;
  if (blocks < 1 || blocks > s.items) return cudaErrorInvalidValue;
  s.w_total = 4LL * d * d + 2LL * d * m;
  WgradMaps maps;
  const Workspace w = carve_workspace(const_cast<bf16*>(ws), n, d, m);
  const bf16* arrays[8] = {w.y1, w.dqkv, w.attn, w.dh2, w.y2, w.dz1, w.u, w.g};
  const int cols[8] = {d, 3 * d, d, d, d, m, m, d};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 8 && err == cudaSuccess; ++i) {
    err = make_tensor_map_2d_bf16_sw128(&maps.map[i], arrays[i], cols[i], n, kWgBox);
  }
  if (err == cudaSuccess) err = ensure_dynamic_smem<EncoderWgradTag>(encoder_wgrad_kernel, kWgSmem);
  if (err != cudaSuccess) return err;
  encoder_wgrad_kernel<<<blocks, kWgThreads, kWgSmem, st>>>(maps, s.splits > 1 ? wpart : grads,
                                                              s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int w_blocks =
      s.splits > 1 ? static_cast<int>((s.w_total / 4 + kRedThreads - 1) / kRedThreads) : 0;
  const int v_blocks = (n_vec + kRedCols - 1) / kRedCols;
  if (w_blocks + v_blocks == 0) return cudaSuccess;
  encoder_bwd_reduce_kernel<<<w_blocks + v_blocks, kRedThreads, 0, st>>>(
      reinterpret_cast<const float4*>(wpart), s.splits, s.w_total / 4, w_blocks, vpart, slabs,
      n_vec, grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Backward of one encoder layer. x, g, dx [batch, t, d] f32, contiguous; w: the
// four bf16 weights in fragment order, end to end (Wqkv, Wproj, W1, W2); wt:
// their transposes likewise (Wqkv^T, Wproj^T, W1^T, W2^T); vec: the f32 rows
// end to end (fused_encoder.py::pack_encoder_params). grads: f32
// [4 d^2 + 2 d m + 9 d + m], the gradients of Wqkv, Wproj, W1, W2 ([in, out],
// row-major) and then of g1, b1, bqkv, bproj, g2, b2, bm1, bm2.
// Scratch the caller allocates (fused_encoder.py::plan_bwd_tile sizes it):
// ws bf16 [batch t (8 d + 2 m)], scratch f32 [grid][16 row_tiles][3 d],
// vpart f32 [grid][9 d + m], wpart f32 [splits][4 d^2 + 2 d m] (none with
// one range). row_tiles
// must fit the shared memory; grid <= the number of tiles. wgrad_plan: the
// four ints of the weight-gradient stage's plan
// (fused_encoder.py::WgradPlan.as_ints: tile_n, splits, boxes_per_split,
// blocks). Three launches on `stream`; returns the first CUDA error (0 on
// success).
int ib_fused_encoder_backward(const void* x, const void* g, int batch, int t, int d, int m,
                              int heads, const void* w, const void* wt, const void* vec,
                              void* dx, void* grads, void* ws, void* scratch, void* vpart,
                              void* wpart, int row_tiles, int grid, const int* wgrad_plan,
                              void* stream) {
  if (batch < 1 || t < 1 || t > kMaxT || d < 128 || d % 128 != 0 || m < 128 || m % 128 != 0 ||
      heads < 1 || d % heads != 0 || (d / heads) % 2 != 0 || row_tiles < 1 ||
      row_tiles > kMaxRowTiles || 16 * row_tiles < t || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdShape s{};
  s.batch = batch;
  s.t = t;
  s.d = d;
  s.m = m;
  s.heads = heads;
  s.q_scale = 1.f / sqrtf(static_cast<float>(d / heads));
  const size_t smem = plan_bwd_smem(s, row_tiles);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  s.n_tiles = (batch + s.windows - 1) / s.windows;
  if (grid > s.n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = ensure_dynamic_smem<EncoderBwdTag>(encoder_bwd_tile_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  encoder_bwd_tile_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<const bf16*>(w),
      static_cast<const bf16*>(wt), static_cast<const float*>(vec), static_cast<float*>(dx),
      static_cast<bf16*>(ws), static_cast<float*>(scratch), static_cast<float*>(vpart), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_wgrad_and_reduce(
      static_cast<const bf16*>(ws), static_cast<float*>(wpart), static_cast<const float*>(vpart),
      grid, 9 * d + m, batch * t, d, m, wgrad_plan, static_cast<float*>(grads), st));
}

// The same backward through the tile kernel's small shape: a cluster of
// blocks a row tile of whole windows, each block its share of the columns
// (fused_encoder.py::plan_encoder_bwd). plan: the seventeen ints of
// BwdPlan.as_ints (cluster, row_tiles, windows, ld_q, ld_z, ld_dq, off_y,
// off_a, off_q, off_z, off_f, off_s, scratch_floats, off_v, off_p, off_st,
// off_bar); smem: its bytes of shared memory. ws, vpart, wpart and
// wgrad_plan as for ib_fused_encoder_backward, with grid = the plan's tiles x
// cluster blocks;
// no per-block scratch in device memory. clocks: null, or room for
// kBwdPhases int64 a block, which get each phase's cycles (thread 0's
// clock64). Three launches on `stream`; returns the first CUDA error (0 on
// success).
int ib_fused_encoder_backward_cluster(const void* x, const void* g, int batch, int t, int d,
                                      int m, int heads, const void* w, const void* wt,
                                      const void* vec, void* dx, void* grads, void* ws,
                                      void* vpart, void* wpart, const int* plan, int smem,
                                      const int* wgrad_plan, void* clocks, void* stream) {
  if (batch < 1 || t < 1 || t > kMaxT || d < 128 || d % 128 != 0 || m < 128 || m % 128 != 0 ||
      heads < 1 || d % heads != 0 || (d / heads) % 2 != 0 || plan == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SmallPlan s{};
  s.batch = batch;
  s.t = t;
  s.d = d;
  s.m = m;
  s.heads = heads;
  int* const fields[kSmallPlanInts] = {
      &s.cluster, &s.row_tiles, &s.windows, &s.ld_q,  &s.ld_z,           &s.ld_dq,
      &s.off_y,   &s.off_a,     &s.off_q,   &s.off_z, &s.off_f,          &s.off_s,
      &s.scratch_floats,        &s.off_v,   &s.off_p, &s.off_st,         &s.off_bar};
  for (int i = 0; i < kSmallPlanInts; ++i) *fields[i] = plan[i];
  s.q_scale = 1.f / sqrtf(static_cast<float>(d / heads));
  const int c = s.cluster;
  const int rows = 16 * s.row_tiles;
  const int gw = c > 0 ? d / c : 0;
  const long long r_f32 = static_cast<long long>(rows) * (d + kPad) * 4;
  const bool ok =
      c >= 2 && c <= 8 && heads % c == 0 && d % c == 0 && gw % 16 == 0 && (m / 16) % c == 0 &&
      s.row_tiles >= 1 && s.row_tiles <= kMaxRowTiles && s.windows >= 1 &&
      s.windows * t <= rows && smem <= kMaxSmem && s.ld_q >= 3 * gw && s.ld_q % 2 == 0 &&
      s.ld_z >= m && s.ld_z % 8 == 0 && s.ld_dq >= 3 * d && s.ld_dq % 8 == 0 &&
      s.off_y == r_f32 && s.off_a == s.off_y + r_f32 / 2 && s.off_q >= s.off_y + r_f32 &&
      s.off_q % 16 == 0 && s.off_z >= s.off_q + rows * s.ld_q * 4 && s.off_z % 16 == 0 &&
      s.off_f >= s.off_z + rows * 2 * (s.ld_z > s.ld_dq ? s.ld_z : s.ld_dq) &&
      s.off_f % 16 == 0 && s.off_s >= s.off_f + r_f32 && s.off_s % 16 == 0 &&
      s.scratch_floats >= small_scratch_floats(d, m, c, s.row_tiles) &&
      s.off_v >= s.off_s + 4LL * s.scratch_floats && s.off_v % 16 == 0 &&
      s.off_p >= s.off_v + 4LL * (9 * d + m) && s.off_p % 16 == 0 &&
      s.off_st >= s.off_p + 8LL * s.windows * (heads / c) * t * t && s.off_st % 16 == 0 &&
      s.off_bar >= s.off_st + 16 * rows && s.off_bar % 8 == 0 &&
      s.off_bar + 8 * kExchanges <= smem;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* wtb = static_cast<const bf16*>(wt);
  const float* vf = static_cast<const float*>(vec);
  float* dxf = static_cast<float*>(dx);
  bf16* wsb = static_cast<bf16*>(ws);
  float* vpf = static_cast<float*>(vpart);
  long long* cl = static_cast<long long*>(clocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one row tile (one window at T = 10) has an instantiation of its own
  cudaError_t err =
      s.row_tiles == 1 ? launch_cluster_tile<1>(s, smem, xf, gf, wb, wtb, vf, dxf, wsb, vpf, cl, st)
      : s.row_tiles == 2
          ? launch_cluster_tile<2>(s, smem, xf, gf, wb, wtb, vf, dxf, wsb, vpf, cl, st)
          : launch_cluster_tile<3>(s, smem, xf, gf, wb, wtb, vf, dxf, wsb, vpf, cl, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (batch + s.windows - 1) / s.windows;
  return static_cast<int>(launch_wgrad_and_reduce(wsb, static_cast<float*>(wpart), vpf,
                                                  tiles * c, 9 * d + m, batch * t, d, m,
                                                  wgrad_plan, static_cast<float*>(grads), st));
}

// The same backward through the tile kernel's pair shape (d = 256, at most
// 16 frames, a head width of 16, 32 or 64, m a multiple of 256): clusters of
// two blocks, a 32-row tile a block, one stream of weights into both
// (fused_encoder.py::plan_encoder_bwd). plan: the nine ints of
// BwdPlan.as_ints (windows, off_b, off_q, off_m, off_dz, off_ring, off_bar,
// slot_bytes, slots), which must be this file's layout; smem: its bytes.
// grid: an even number of blocks, at most one pair a pair of tiles. ws,
// wpart and wgrad_plan as for ib_fused_encoder_backward, vpart a slab a
// block. clocks: null,
// or room for kPairPhases int64 a block, which get the block's cycles by
// phase over its tiles. Three launches on `stream`; returns the first CUDA
// error (0 on success).
int ib_fused_encoder_backward_pair(const void* x, const void* g, int batch, int t, int d, int m,
                                   int heads, const void* w, const void* wt, const void* vec,
                                   void* dx, void* grads, void* ws, void* vpart, void* wpart,
                                   const int* plan, int smem, int grid, const int* wgrad_plan,
                                   void* clocks, void* stream) {
  if (batch < 1 || t < 1 || t > 16 || d != kPD || m < kPChunk || m % kPChunk != 0 ||
      (heads != 4 && heads != 8 && heads != 16) || plan == nullptr ||
      smem != kPSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int layout[kPairPlanInts] = {kPRows / t, kPOffB,   kPOffQ,     kPOffM, kPOffDz,
                                     kPOffRing,  kPOffBar, kSlotBytes, kSlots};
  for (int i = 0; i < kPairPlanInts; ++i) {
    if (plan[i] != layout[i]) return static_cast<int>(cudaErrorInvalidValue);
  }
  PairShape s{batch, t, m, heads, kPRows / t, 1.f / sqrtf(static_cast<float>(d / heads))};
  const int n_pairs = ((batch + s.windows - 1) / s.windows + 1) / 2;
  if (grid < 2 || grid % 2 != 0 || grid / 2 > n_pairs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = ensure_dynamic_smem<EncoderBwdPairTag>(encoder_bwd_tile_kernel_pair, kPSmem);
  if (err == cudaSuccess) {
    err = launch_cluster(encoder_bwd_tile_kernel_pair, grid, kPairThreads, 2, kPSmem, st,
                         static_cast<const float*>(x), static_cast<const float*>(g),
                         static_cast<const bf16*>(w), static_cast<const bf16*>(wt),
                         static_cast<const float*>(vec), static_cast<float*>(dx),
                         static_cast<bf16*>(ws), static_cast<float*>(vpart), s,
                         static_cast<long long*>(clocks));
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_wgrad_and_reduce(
      static_cast<const bf16*>(ws), static_cast<float*>(wpart), static_cast<const float*>(vpart),
      grid, 9 * d + m, batch * t, d, m, wgrad_plan, static_cast<float*>(grads), st));
}

// The weight-gradient stage alone: the four products of the bf16 workspace
// ws of n rows (carve_workspace's layout, as the tile kernels write it) into
// out, f32 [4 d^2 + 2 d m] (dWqkv, dWproj, dW1, dW2, [in, out] row-major).
// wgrad_plan and wpart as for ib_fused_encoder_backward. Two launches on
// `stream` (one where the plan has one range); returns the first CUDA error
// (0 on success).
int ib_encoder_wgrad(const void* ws, int n, int d, int m, const int* wgrad_plan, void* wpart,
                     void* out, void* stream) {
  if (n < 1 || d < 128 || d % 128 != 0 || m < 128 || m % 128 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_wgrad_and_reduce(
      static_cast<const bf16*>(ws), static_cast<float*>(wpart), nullptr, 0, 0, n, d, m,
      wgrad_plan, static_cast<float*>(out), static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
