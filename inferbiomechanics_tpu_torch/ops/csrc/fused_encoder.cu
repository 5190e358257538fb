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
// Design. One block owns a tile of whole windows (attention mixes only the T
// rows of one window): `windows` = floor(16 * row_tiles / T) of them, where
// row_tiles (1..3 mma row tiles of 16) is the most that fits the 227 KB of
// shared memory a block may use; at d = 256, T = 10 that is 4 windows, 40
// rows padded to 48. Padding rows and windows past the batch hold zeros,
// run through the same arithmetic (finite everywhere) and are never stored.
// The tile's f32 residual stream, its f32 q/k/v, and one bf16 operand buffer
// live in shared memory from the load of x to the store of out, so no
// intermediate touches device memory. The MLP hidden (bf16, 4d wide) takes
// over the q/k/v space once attention is done. The four weight matrices do
// not fit beside them (1.5 MiB at d = 256), so they stream from L2 straight
// into registers: pack_encoder_params lays each out in mma.sync fragment
// order (one coalesced 16-byte load a lane for a 16-column block and k-step),
// and each warp keeps kDepth such loads in flight. Each warp owns 16-column
// blocks of a product's output for all row tiles; warps share nothing within
// a product, so there is one barrier between stages.
//
// The attention core is T x T dot products of length dh per window and head,
// in f32 from shared memory: one thread per (window, head, query frame),
// query frames fastest, so that the lanes of a warp that share a window and
// head read the same k and v addresses (a broadcast); the column order is
// rotated per head to spread the heads over the banks. T = 10 and T = 4 keep
// the scores in registers (the loops over frames unroll); any other T up to
// kMaxT takes the same code with the scores in local memory.
//
// What bounds it on an H100, d = 256, T = 10, 4d MLP:
//  - B = 4096 (1024 blocks): 15.7 MFLOP a window on the tensor cores, 64 GFLOP
//    in all, while each block streams all 1.5 MiB of weights from L2, 1.5 GiB
//    of L2 traffic in all. Larger row tiles (which needs q/k/v head by head
//    and the MLP hidden in column chunks), TMA multicast of weights across a
//    cluster and wgmma are the later steps.
//  - small batch (B <= 4 is one block): the weights streamed through a single
//    SM. Splitting a product's columns over the blocks of a cluster is the
//    next step for latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "launch.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRowTiles = 3;     // 16-row mma tiles a block may own
constexpr int kDepth = 8;           // weight k-steps in flight per warp
constexpr int kPad = 8;             // elements added to every shared-memory row
constexpr int kMaxT = 48;           // frames per window (= 16 * kMaxRowTiles)
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use
constexpr float kLnEps = 1e-6f;

struct FusedEncoderTag {};          // keys this kernel's shared-memory cap (launch.cuh)

struct EncShape {
  int batch, t, d, m, heads;
  int row_tiles;                    // 16-row mma tiles per block
  int windows;                      // whole windows per block
  int ld_r, ld_q, ld_h, ld_a;       // row strides: resid f32, qkv f32, hidden bf16, operand bf16
  int big_bytes;                    // bytes of the q/k/v space (the hidden aliases it)
  float q_scale;                    // dh^-0.5
};

__device__ __forceinline__ float gelu_tanh(float v) {
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(u));
}

// LayerNorm of every row of src (f32, stride ld_src) into dst as bf16: one
// warp per row, mean and biased variance in f32, two passes over the row.
__device__ __forceinline__ void layernorm_rows(const float* src, int ld_src, int rows, int d,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias,
                                               __nv_bfloat16* dst, int ld_dst) {
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
    __nv_bfloat16* y = dst + r * ld_dst;
    for (int i = lane; i < d; i += 32) {
      y[i] = __float2bfloat16((x[i] - mean) * rs * __ldg(scale + i) + __ldg(bias + i));
    }
  }
}

// One product of the layer for the block's row tiles: a [16 * row_tiles, k]
// bf16 in shared memory (stride lda) times w [k, n], packed in fragment
// order [n / 16][k / 16][32 lanes] x 16 bytes. k is a multiple of
// 16 * kDepth and n of 16. epi(row, col, v0, v1) receives every pair of
// neighbouring sums (col even) exactly once.
template <typename Epilogue>
__device__ __forceinline__ void product(const __nv_bfloat16* a, int lda, int row_tiles,
                                        const __nv_bfloat16* __restrict__ w, int k, int n,
                                        Epilogue epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;           // fragment row group
  const int c = lane & 3;            // fragment column pair
  const int nk = k / 16;
  const int n_blocks = n / 16;
  const uint4* wl = reinterpret_cast<const uint4*>(w);
  // this lane's ldmatrix row pointer into the first row tile
  const __nv_bfloat16* a0 = a + (lane & 15) * lda + (lane >> 4) * 8;

  for (int nb = warp; nb < n_blocks; nb += kWarps) {
    float acc[kMaxRowTiles][2][4] = {};   // [row tile][n8 tile][fragment]
    const uint4* wp = wl + static_cast<long long>(nb) * nk * 32 + lane;
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
          if (rt < row_tiles) {      // the same for every thread of the block
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

// Softmax attention within each window of the tile, per head, in f32. qkv
// holds [q * dh^-0.5 | k | v] per row; the mix goes to dst as bf16. kT > 0
// fixes the frame count at compile time (scores in registers); kT == 0 takes
// it from t_rt.
template <int kT>
__device__ __forceinline__ void attention(const float* qkv, int ld_q, __nv_bfloat16* dst,
                                          int ld_dst, int t_rt, int d, int heads, int windows) {
  const int t = kT > 0 ? kT : t_rt;
  const int dh = d / heads;
  const int items = windows * heads * t;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int tq = it % t;
    const int wh = it / t;
    const int h = wh % heads;
    const int row0 = (wh / heads) * t;            // the window's first row in the tile
    const float* q = qkv + (row0 + tq) * ld_q + h * dh;
    const float* kw = qkv + row0 * ld_q + d + h * dh;
    const float* vw = kw + d;
    const int skew = (8 * h) % dh;                // even; spreads the heads over the banks
    float p[kT > 0 ? kT : kMaxT];
#pragma unroll
    for (int j = 0; j < t; ++j) p[j] = 0.f;
    for (int ii = 0; ii < dh; ii += 2) {
      int i = ii + skew;
      if (i >= dh) i -= dh;
      const float2 qi = *reinterpret_cast<const float2*>(q + i);
#pragma unroll
      for (int j = 0; j < t; ++j) {
        const float2 kj = *reinterpret_cast<const float2*>(kw + j * ld_q + i);
        p[j] = fmaf(qi.x, kj.x, fmaf(qi.y, kj.y, p[j]));
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
    __nv_bfloat16* o = dst + (row0 + tq) * ld_dst + h * dh;
    for (int ii = 0; ii < dh; ii += 2) {
      int i = ii + skew;
      if (i >= dh) i -= dh;
      float o0 = 0.f, o1 = 0.f;
#pragma unroll
      for (int j = 0; j < t; ++j) {
        const float2 vj = *reinterpret_cast<const float2*>(vw + j * ld_q + i);
        o0 = fmaf(p[j], vj.x, o0);
        o1 = fmaf(p[j], vj.y, o1);
      }
      *reinterpret_cast<__nv_bfloat162*>(o + i) = __floats2bfloat162_rn(o0 * inv_z, o1 * inv_z);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_encoder_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const __nv_bfloat16* __restrict__ w, const float* __restrict__ vec,
                     EncShape s) {
  // shared memory: resid f32 [rows][ld_r] | q/k/v f32 [rows][ld_q], later the
  // MLP hidden bf16 [rows][ld_h] | operand bf16 [rows][ld_a]
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = s.d, m = s.m;
  const int rows = 16 * s.row_tiles;
  float* const resid = reinterpret_cast<float*>(smem);
  float* const qkv = resid + rows * s.ld_r;
  __nv_bfloat16* const hid = reinterpret_cast<__nv_bfloat16*>(qkv);
  __nv_bfloat16* const abuf = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<unsigned char*>(qkv) + s.big_bytes);

  // weights, each in fragment order, end to end: Wqkv, Wproj, W1, W2
  const __nv_bfloat16* const w_qkv = w;
  const __nv_bfloat16* const w_proj = w_qkv + static_cast<long long>(d) * 3 * d;
  const __nv_bfloat16* const w_mlp1 = w_proj + static_cast<long long>(d) * d;
  const __nv_bfloat16* const w_mlp2 = w_mlp1 + static_cast<long long>(d) * m;
  // f32 rows, end to end: g1, b1, bqkv, bproj, g2, b2, bm1, bm2
  const float* const g1 = vec;
  const float* const b1 = g1 + d;
  const float* const b_qkv = b1 + d;
  const float* const b_proj = b_qkv + 3 * d;
  const float* const g2 = b_proj + d;
  const float* const b2 = g2 + d;
  const float* const b_mlp1 = b2 + d;
  const float* const b_mlp2 = b_mlp1 + m;

  const int win0 = blockIdx.x * s.windows;
  const int n_win = min(s.windows, s.batch - win0);
  const int valid = n_win * s.t;                 // rows that are loaded and stored
  const long long base = static_cast<long long>(win0) * s.t * d;
  const int d4 = d / 4;

  // Stage the tile of x into resid, zero-filled past the valid rows.
  {
    const float4* xs = reinterpret_cast<const float4*>(x + base);
    for (int i = threadIdx.x; i < rows * d4; i += kThreads) {
      const int r = i / d4;
      const int c4 = i - r * d4;
      const float4 v = r < valid ? __ldg(xs + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(resid + r * s.ld_r + 4 * c4) = v;
    }
  }
  __syncthreads();

  layernorm_rows(resid, s.ld_r, rows, d, g1, b1, abuf, s.ld_a);
  __syncthreads();

  {
    const float scale = s.q_scale;
    const int ld_q = s.ld_q;
    product(abuf, s.ld_a, s.row_tiles, w_qkv, d, 3 * d,
            [=](int r, int n, float v0, float v1) {
              v0 += __ldg(b_qkv + n);
              v1 += __ldg(b_qkv + n + 1);
              if (n < d) {           // q: scaled after the bias, in f32
                v0 *= scale;
                v1 *= scale;
              }
              *reinterpret_cast<float2*>(qkv + r * ld_q + n) = make_float2(v0, v1);
            });
  }
  __syncthreads();

  switch (s.t) {
    case 10:
      attention<10>(qkv, s.ld_q, abuf, s.ld_a, s.t, d, s.heads, s.windows);
      break;
    case 4:
      attention<4>(qkv, s.ld_q, abuf, s.ld_a, s.t, d, s.heads, s.windows);
      break;
    default:
      attention<0>(qkv, s.ld_q, abuf, s.ld_a, s.t, d, s.heads, s.windows);
  }
  __syncthreads();

  {
    const int ld_r = s.ld_r;
    product(abuf, s.ld_a, s.row_tiles, w_proj, d, d,
            [=](int r, int n, float v0, float v1) {
              float2* h = reinterpret_cast<float2*>(resid + r * ld_r + n);
              float2 hv = *h;
              hv.x += v0 + __ldg(b_proj + n);
              hv.y += v1 + __ldg(b_proj + n + 1);
              *h = hv;
            });
  }
  __syncthreads();

  layernorm_rows(resid, s.ld_r, rows, d, g2, b2, abuf, s.ld_a);
  __syncthreads();

  {
    const int ld_h = s.ld_h;
    product(abuf, s.ld_a, s.row_tiles, w_mlp1, d, m,
            [=](int r, int n, float v0, float v1) {
              v0 = gelu_tanh(v0 + __ldg(b_mlp1 + n));
              v1 = gelu_tanh(v1 + __ldg(b_mlp1 + n + 1));
              *reinterpret_cast<__nv_bfloat162*>(hid + r * ld_h + n) =
                  __floats2bfloat162_rn(v0, v1);
            });
  }
  __syncthreads();

  {
    const int ld_r = s.ld_r;
    product(hid, s.ld_h, s.row_tiles, w_mlp2, m, d,
            [=](int r, int n, float v0, float v1) {
              float2* h = reinterpret_cast<float2*>(resid + r * ld_r + n);
              float2 hv = *h;
              hv.x += v0 + __ldg(b_mlp2 + n);
              hv.y += v1 + __ldg(b_mlp2 + n + 1);
              *h = hv;
            });
  }
  __syncthreads();

  {
    float4* os = reinterpret_cast<float4*>(out + base);
    for (int i = threadIdx.x; i < valid * d4; i += kThreads) {
      const int r = i / d4;
      const int c4 = i - r * d4;
      os[i] = *reinterpret_cast<const float4*>(resid + r * s.ld_r + 4 * c4);
    }
  }
}

// Shared memory for `row_tiles` mma row tiles; fills the strides of `s`.
size_t plan_smem(EncShape& s, int row_tiles) {
  s.row_tiles = row_tiles;
  s.ld_r = s.d + kPad;
  s.ld_q = 3 * s.d + kPad;
  s.ld_h = s.m + kPad;
  s.ld_a = s.d + kPad;
  const size_t rows = 16 * static_cast<size_t>(row_tiles);
  const size_t qkv_bytes = rows * s.ld_q * sizeof(float);
  const size_t hid_bytes = rows * s.ld_h * sizeof(__nv_bfloat16);
  const size_t big = qkv_bytes > hid_bytes ? qkv_bytes : hid_bytes;
  s.big_bytes = static_cast<int>(big);
  return rows * s.ld_r * sizeof(float) + big + rows * s.ld_a * sizeof(__nv_bfloat16);
}

}  // namespace

extern "C" {

// x, out [batch, t, d] f32, contiguous; w: the four bf16 weights in fragment
// order, end to end (Wqkv [d, 3d], Wproj [d, d], W1 [d, m], W2 [m, d]); vec:
// the f32 rows end to end (g1, b1, bqkv, bproj, g2, b2, bm1, bm2)
// (fused_encoder.py::pack_encoder_params). d and m are multiples of 128, d
// divides by heads into an even head width, and t <= 48 with at least one
// window fitting the shared memory (fused_encoder.py::plan_tile computes the
// same plan). Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int ib_fused_encoder_forward(const void* x, int batch, int t, int d, int m, int heads,
                             const void* w, const void* vec, void* out, void* stream) {
  if (batch < 1 || t < 1 || t > kMaxT || d < 128 || d % 128 != 0 || m < 128 ||
      m % 128 != 0 || heads < 1 || d % heads != 0 || (d / heads) % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EncShape s{};
  s.batch = batch;
  s.t = t;
  s.d = d;
  s.m = m;
  s.heads = heads;
  s.q_scale = 1.f / sqrtf(static_cast<float>(d / heads));
  size_t smem = 0;
  int row_tiles = kMaxRowTiles;
  for (; row_tiles >= 1; --row_tiles) {
    smem = plan_smem(s, row_tiles);
    if (smem <= static_cast<size_t>(kMaxSmem)) break;
  }
  if (row_tiles < 1 || 16 * row_tiles < t) return static_cast<int>(cudaErrorInvalidValue);
  s.windows = 16 * row_tiles / t;

  const cudaError_t err = ensure_dynamic_smem<FusedEncoderTag>(fused_encoder_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + s.windows - 1) / s.windows);
  fused_encoder_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(vec), s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
