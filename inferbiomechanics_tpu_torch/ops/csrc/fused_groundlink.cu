// Fused GroundLink forward for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; see ../_build.py and ../fused_groundlink.py).
//
// Replaces inferbiomechanics_tpu/ops/pallas_groundlink.py::fused_groundlink_forward
// (kernel _gl_kernel -> _gl_forward_math). One launch computes the whole
// forward for x [B, T, C_in] f32:
//
//   h = x
//   for each conv (k taps, replicate padding along the T frames of a window):
//     h[w, t] = elu(sum_j bf16(h[w, clamp(t + j - k/2, 0, T-1)]) @ W[j] + b)
//   last_frame: keep only frame T-1 of every window
//   for each hidden FC layer:  h = elu(bf16(h) @ W + b)
//   out = bf16(h) @ W_head                      (no bias, no activation)
//
// bf16 operands, f32 sums, f32 bias and ELU (exp(min(z, 0)) - 1) on the f32
// sum, one rounding to bf16 before the next product, f32 output: the
// arithmetic of _gl_forward_math with its default compute and activation
// types.
//
// Design. One block owns a tile of whole windows (a conv mixes only the T
// frames of one window): 16 * row_tiles rows (1..4 mma row tiles), so 6
// windows of T = 10 in 64 rows. The tile's activations live in shared memory
// as bf16 rows [window * T + frame][channel], ping-ponging between two
// buffers, from the load of x to the store of the head: a conv reads frames
// t-3..t+3 of its input, so it cannot write in place. Each conv is ONE
// product with K = taps * C_in against the [taps * C_in, C_out] weight, and
// the shift is address arithmetic: ldmatrix takes one row address per lane,
// so for tap j the lane that feeds output row (w, t) points at row
// (w, clamp(t + j - k/2, 0, T-1)). Replicate padding costs nothing and no
// shifted copy is built (the TPU kernel concatenates T lane slices per tap).
// Channels are padded to what mma.m16n8k16 wants (177 -> 192, 30 -> 32), not
// to the TPU's 128 lanes. The weights (2.2 MB at full width) do not fit
// beside the tile, so they stream from L2 straight into registers:
// pack_groundlink_params lays each layer out in mma.sync fragment order (one
// coalesced 16-byte load a lane for a 16-column block and k-step), and each
// warp keeps kDepth such loads in flight. Each warp owns 16-column blocks of
// a layer's output for all row tiles; warps share nothing within a layer, so
// there is one barrier per layer.
//
// Rows that are padding (past windows * T in the tile) read row 0 of the tile
// in the convs, so they hold finite values and never read past the tile;
// windows past the batch are zero-filled at the load. Neither is ever stored.
// In last_frame mode the convs run on all T frames and the FC head gathers
// row (w, T-1) of each window, so its M is the number of windows (one row
// tile).
//
// What bounds it on an H100 at full width (177 -> 128 -> 128 -> 256 -> 256,
// k = 7, T = 10, fc_depth 3):
//  - B = 4096 (683 blocks): ~20 MFLOP a window on the tensor cores, 80-90
//    GFLOP in all, while each block streams all 2.2 MB of weights from L2,
//    1.5 GB of L2 traffic. Larger row tiles, trimming the late convs to the
//    frames the last one needs (last_frame), TMA multicast of weights across
//    a cluster and wgmma are the later steps.
//  - B = 1 (one block): the weights streamed through a single SM, layer after
//    layer. Splitting a layer's columns over the blocks of a cluster is the
//    next step for latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRowTiles = 4;     // 16-row mma tiles a block may own
constexpr int kDepth = 8;           // weight k-steps in flight per warp
constexpr int kChunk = 4;           // k-steps per tap are a multiple of this
constexpr int kPad = 8;             // bf16 elements added to every shared-memory row
constexpr int kMaxLayers = 12;      // convs + FC layers + head
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use

struct FusedGroundlinkTag {};       // keys this kernel's shared-memory cap (launch.cuh)

struct GlShape {
  int batch, t, c_in, c_out;
  int n_conv, n_layers, taps, last_frame;
  int row_tiles;                    // 16-row mma tiles per block
  int windows;                      // whole windows per block
  int ld;                           // row stride of both buffers (bf16 elements)
  int width[kMaxLayers + 1];        // padded widths: width[l] in, width[l + 1] out of layer l
  long long w_off[kMaxLayers];      // offset of layer l in the weight buffer
  int b_off[kMaxLayers];            // offset of layer l in the bias buffer
};

// How a layer finds the source row of output row r for tap j.
enum RowMode {
  kConvRows = 0,    // (w, clamp(t + j - taps/2)); padding rows read row 0
  kLastRows = 1,    // output row r is window r: its last frame
  kSameRows = 2,    // row r
};

__device__ __forceinline__ int source_row(int mode, int r, int tap, int t, int half,
                                          int windows) {
  if (mode == kConvRows) {
    if (r >= windows * t) r = 0;
    const int w = r / t;
    const int f = r - w * t;
    return w * t + min(max(f + tap - half, 0), t - 1);
  }
  if (mode == kLastRows) return (r < windows ? r : 0) * t + t - 1;
  return r;
}

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expf(v) - 1.f;     // exp(min(v, 0)) - 1, not expm1
}

__global__ void __launch_bounds__(kThreads, 2)
fused_groundlink_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ out, GlShape s) {
  // shared memory: P [rows][ld] | Q [rows][ld], bf16
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = 16 * s.row_tiles;
  __nv_bfloat16* const buf_p = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const buf_q = buf_p + rows * s.ld;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;           // fragment row group
  const int c = lane & 3;            // fragment column pair
  const int t = s.t;
  const int win0 = blockIdx.x * s.windows;
  const int n_win = min(s.windows, s.batch - win0);

  // Stage the tile of x into P as bf16, zero-filled past the block's windows
  // and past c_in (up to the padded width the first weight has rows for).
  {
    const int k0 = s.width[0];
    const int valid = n_win * t;
    const float* xs = x + static_cast<long long>(win0) * t * s.c_in;
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * k0; i += kThreads) {
      const int r = i / k0;
      const int k = i - r * k0;
      const float v = (r < valid && k < s.c_in) ? __ldg(xs + r * s.c_in + k) : 0.f;
      buf_p[r * s.ld + k] = __float2bfloat16(v);
    }
  }
  __syncthreads();

  const __nv_bfloat16* in = buf_p;
  __nv_bfloat16* nxt = buf_q;
  int row_tiles = s.row_tiles;
  for (int l = 0; l < s.n_layers; ++l) {
    const bool conv = l < s.n_conv;
    const bool last = l == s.n_layers - 1;
    const int taps = conv ? s.taps : 1;
    const int half = taps / 2;
    int mode = kConvRows;
    if (!conv) {
      mode = (l == s.n_conv && s.last_frame) ? kLastRows : kSameRows;
      if (s.last_frame) row_tiles = (s.windows + 15) / 16;
    }
    const int nkc = s.width[l] / 16;     // k-steps per tap, a multiple of kChunk
    const int nk = taps * nkc;
    const int n_blocks = s.width[l + 1] / 16;
    // layer l in fragment order: [n_blocks][nk][32 lanes] x 16 bytes
    const uint4* wl = reinterpret_cast<const uint4*>(w + s.w_off[l]);
    const float* bl = bias + s.b_off[l];
    // rows of the head that are stored, and where
    const int valid_out = s.last_frame ? n_win : n_win * t;
    float* const out0 = out + static_cast<long long>(s.last_frame ? win0 : win0 * t) * s.c_out;

    for (int nb = warp; nb < n_blocks; nb += kWarps) {
      float acc[kMaxRowTiles][2][4] = {};   // [row tile][n8 tile][fragment]
      const uint4* wp = wl + static_cast<long long>(nb) * nk * 32 + lane;
      uint4 ring[kDepth];
#pragma unroll
      for (int dd = 0; dd < kDepth; ++dd) {
        if (dd < nk) ring[dd] = __ldg(wp + dd * 32);
      }
      // this lane's ldmatrix row pointers for the current tap, one a row tile
      const __nv_bfloat16* ap[kMaxRowTiles];
      int tap = 0;
      int kc = 0;                           // k-step within the tap
#pragma unroll
      for (int rt = 0; rt < kMaxRowTiles; ++rt) {
        ap[rt] = in + source_row(mode, 16 * rt + (lane & 15), 0, t, half, s.windows) * s.ld +
                 (lane >> 4) * 8;
      }
      for (int kb = 0; kb < nk; kb += kDepth) {
#pragma unroll
        for (int ch = 0; ch < kDepth / kChunk; ++ch) {
          if (kb + ch * kChunk < nk) {      // the same for every thread of the block
#pragma unroll
            for (int dd = 0; dd < kChunk; ++dd) {
              const int ks = kb + ch * kChunk + dd;
              const uint4 b = ring[ch * kChunk + dd];
              if (ks + kDepth < nk) ring[ch * kChunk + dd] = __ldg(wp + (ks + kDepth) * 32);
#pragma unroll
              for (int rt = 0; rt < kMaxRowTiles; ++rt) {
                if (rt < row_tiles) {
                  unsigned af[4];
                  ldmatrix_x4(af, ap[rt] + 16 * (kc + dd));
                  mma_bf16(acc[rt][0], af, b.x, b.y);
                  mma_bf16(acc[rt][1], af, b.z, b.w);
                }
              }
            }
            kc += kChunk;
            if (kc == nkc && tap + 1 < taps) {   // the next tap: shifted rows
              kc = 0;
              ++tap;
#pragma unroll
              for (int rt = 0; rt < kMaxRowTiles; ++rt) {
                ap[rt] = in +
                         source_row(mode, 16 * rt + (lane & 15), tap, t, half, s.windows) * s.ld +
                         (lane >> 4) * 8;
              }
            }
          }
        }
      }
      // f32 bias and ELU, then one rounding to bf16 for the next product; the
      // head has neither and its f32 sums are the output. This lane holds
      // rows g and g + 8, columns n and n + 1 of each 16x8 tile.
#pragma unroll
      for (int rt = 0; rt < kMaxRowTiles; ++rt) {
        if (rt < row_tiles) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = nb * 16 + 8 * j + 2 * c;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 16 * rt + g + 8 * h;
              const float v0 = acc[rt][j][2 * h];
              const float v1 = acc[rt][j][2 * h + 1];
              if (!last) {
                *reinterpret_cast<__nv_bfloat162*>(nxt + r * s.ld + n) = __floats2bfloat162_rn(
                    elu(v0 + __ldg(bl + n)), elu(v1 + __ldg(bl + n + 1)));
              } else if (r < valid_out) {
                float* o = out0 + static_cast<long long>(r) * s.c_out;
                if (n < s.c_out) o[n] = v0;
                if (n + 1 < s.c_out) o[n + 1] = v1;
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the next layer reads what every warp wrote
    const __nv_bfloat16* done = in;
    in = nxt;
    nxt = const_cast<__nv_bfloat16*>(done);
  }
}

}  // namespace

extern "C" {

// x [batch, t, c_in] f32, contiguous; w: the packed bf16 weights, layer l in
// fragment order over padded widths [taps_l * pwidths[l], pwidths[l + 1]]
// (taps_l = taps for the n_conv convs, 1 for the n_fc FC layers, of which the
// last is the head); bias: the packed f32 biases of every layer but the head;
// pwidths: n_conv + n_fc + 1 padded widths (host memory), multiples of 64 but
// for the head's output, a multiple of 16
// (fused_groundlink.py::pack_groundlink_params); out [batch, t or 1, c_out]
// f32. Launches on `stream` and returns cudaGetLastError() (0 on success).
int ib_fused_groundlink_forward(const void* x, int batch, int t, int c_in, const void* w,
                                const void* bias, const int* pwidths, int n_conv, int n_fc,
                                int taps, int last_frame, void* out, int c_out, void* stream) {
  const int n_layers = n_conv + n_fc;
  if (batch < 1 || t < 1 || t > 16 * kMaxRowTiles || n_conv < 1 || n_fc < 1 ||
      n_layers > kMaxLayers || taps < 1 || taps % 2 != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l <= n_layers; ++l) {
    const int unit = l < n_layers ? 16 * kChunk : 16;
    if (pwidths[l] < unit || pwidths[l] % unit != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (c_in > pwidths[0] || c_out > pwidths[n_layers]) return static_cast<int>(cudaErrorInvalidValue);

  GlShape s{};
  s.batch = batch;
  s.t = t;
  s.c_in = c_in;
  s.c_out = c_out;
  s.n_conv = n_conv;
  s.n_layers = n_layers;
  s.taps = taps;
  s.last_frame = last_frame ? 1 : 0;
  long long w_off = 0;
  int b_off = 0;
  int widest = 0;
  for (int l = 0; l < n_layers; ++l) {
    s.width[l] = pwidths[l];
    s.w_off[l] = w_off;
    s.b_off[l] = b_off;
    w_off += static_cast<long long>(l < n_conv ? taps : 1) * pwidths[l] * pwidths[l + 1];
    b_off += pwidths[l + 1];
    widest = pwidths[l] > widest ? pwidths[l] : widest;
  }
  s.width[n_layers] = pwidths[n_layers];
  s.ld = widest + kPad;
  // as many row tiles as the batch fills, at least one whole window
  const long long all_rows = static_cast<long long>(batch) * t;
  int row_tiles = all_rows >= 16 * kMaxRowTiles ? kMaxRowTiles : static_cast<int>((all_rows + 15) / 16);
  if (16 * row_tiles < t) row_tiles = (t + 15) / 16;
  s.row_tiles = row_tiles;
  s.windows = 16 * row_tiles / t;
  const size_t smem = 2 * static_cast<size_t>(16 * row_tiles) * s.ld * sizeof(__nv_bfloat16);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);

  const cudaError_t err = ensure_dynamic_smem<FusedGroundlinkTag>(fused_groundlink_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + s.windows - 1) / s.windows);
  fused_groundlink_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
