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
// Design. One block owns a tile of kRowsPerBlock rows and runs the whole
// layer chain for it in one launch. The tile's input rows (converted to bf16)
// and its hidden activations live in shared memory, ping-ponging between two
// buffers, so no intermediate touches device memory -- the point of the TPU
// kernel. The TPU kernel also keeps every weight resident in VMEM (~2.4 MB
// for 1770->512->512->30); one SM has at most 227 KB, so here the weights
// stream from L2 straight into registers. pack_mlp_params lays each layer out
// in mma.sync fragment order: for every 16-column block and 16-deep k-step,
// the 32 lanes' B fragments (two n8 tiles) are 512 contiguous bytes, so a
// warp fetches one k-step with one coalesced 16-byte load a lane, and keeps
// kDepth such loads in flight ahead of its tensor-core work. Activations are
// read from shared memory with ldmatrix. Each warp owns one 16-column block
// of a layer's output for both 16-row halves of the tile; the warps of a
// block share nothing within a layer, so there is one barrier per layer.
//
// What bounds it on an H100:
//  - small batch (B=1 is one block): the 2.4 MB of weights streamed from L2
//    through a single SM. Nothing here splits the output columns across
//    blocks for small B yet; that is the next step for latency.
//  - B=4096 (128 blocks): each block streams all weights from L2, about
//    310 MB of L2 traffic in all, next to ~2.4 MFLOP a row (9.8 GFLOP) on the
//    tensor cores. Larger row tiles (fewer weight re-reads, which needs the
//    input tile streamed too), TMA multicast of weights across a cluster and
//    wgmma are the later steps.
//
// Padding. Widths are padded to multiples of 16 when the weights are packed.
// The input is read as f32 with masked loads, so c_in need not be aligned;
// columns >= c_in and rows >= batch are zero-filled. Padded hidden columns
// see act(0) (0.5 for sigmoid), but the next layer's padded weight rows are
// zero, so they add nothing -- the argument at pallas_mlp.py:104-107. Padded
// output columns and rows are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "mma.cuh"

namespace {

constexpr int kRowsPerBlock = 32;   // two 16-row mma tiles
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLayers = 8;
constexpr int kSmemPad = 8;         // bf16 elements added to each smem row
constexpr int kDepth = 16;          // weight k-steps in flight per warp

struct MlpShape {
  int n_layers;
  int pdims[kMaxLayers + 1];        // padded widths, multiples of 16
  long long w_off[kMaxLayers];      // offset of layer i in the weight buffer
  int b_off[kMaxLayers];            // offset of layer i in the bias buffer
  int ld_p;                         // row stride of buffer P (input, odd layers' outputs)
  int ld_q;                         // row stride of buffer Q (even layers' outputs)
};

struct FusedMlpTag {};              // keys this kernel's shared-memory cap (launch.cuh)

// Activation ids; fused_mlp.py holds the same table.
enum Activation { kRelu = 0, kTanh = 1, kSigmoid = 2, kGelu = 3, kElu = 4 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(v, 0.f);
    case kTanh:
      return tanhf(v);
    case kSigmoid:
      return 1.f / (1.f + expf(-v));
    case kGelu: {  // tanh form, as jax.nn.gelu's default
      const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.f + tanhf(u));
    }
    default:       // elu, alpha 1
      return v > 0.f ? v : expm1f(v);
  }
}

// Bias, activation and bf16 rounding of one warp's 16x8 accumulator tile:
// this lane holds rows g and g + 8, columns n and n + 1. Hidden layers write
// bf16 pairs into the next shared buffer; the last layer writes f32 to
// `out`, masked to the real rows and columns.
__device__ __forceinline__ void epilogue(const float (&acc)[4], int r0, int n,
                                         const float* __restrict__ bias, bool last,
                                         int act, __nv_bfloat16* nxt, int ld_nxt,
                                         float* __restrict__ out, int row0, int batch,
                                         int c_out) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    float v0 = acc[2 * h] + bias[n];
    float v1 = acc[2 * h + 1] + bias[n + 1];
    if (!last) {
      v0 = activate(v0, act);
      v1 = activate(v1, act);
    }
    const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
    if (!last) {
      *reinterpret_cast<__nv_bfloat162*>(nxt + r * ld_nxt + n) = hv;
    } else if (row0 + r < batch) {
      float* o = out + static_cast<long long>(row0 + r) * c_out;
      if (n < c_out) o[n] = __low2float(hv);
      if (n + 1 < c_out) o[n + 1] = __high2float(hv);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const float* __restrict__ x, int batch, int c_in,
                 const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ out, int c_out, int act, MlpShape s) {
  // shared memory: P [32][ld_p] | Q [32][ld_q]
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* const buf_p = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const buf_q = buf_p + kRowsPerBlock * s.ld_p;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;           // fragment row group
  const int c = lane & 3;            // fragment column pair
  const int row0 = blockIdx.x * kRowsPerBlock;
  // the second 16-row half holds real rows only when the batch reaches it
  const bool two_halves = row0 + 16 < batch;

  // Stage the row tile of x into P as bf16, zero-filled past the batch and
  // past c_in (up to the padded width the first weight has rows for).
  const int k0 = s.pdims[0];
#pragma unroll 8
  for (int i = threadIdx.x; i < kRowsPerBlock * k0; i += kThreads) {
    const int r = i / k0;
    const int k = i - r * k0;
    const int row = row0 + r;
    const float v = (row < batch && k < c_in) ? x[static_cast<long long>(row) * c_in + k] : 0.f;
    buf_p[r * s.ld_p + k] = __float2bfloat16(v);
  }
  __syncthreads();

  for (int l = 0; l < s.n_layers; ++l) {
    const bool odd = l & 1;
    const __nv_bfloat16* in = odd ? buf_q : buf_p;
    const int ld_in = odd ? s.ld_q : s.ld_p;
    __nv_bfloat16* nxt = odd ? buf_p : buf_q;
    const int ld_nxt = odd ? s.ld_p : s.ld_q;
    const int nk = s.pdims[l] / 16;          // k-steps
    const int n_blocks = s.pdims[l + 1] / 16;
    // layer l in fragment order: [n_blocks][nk][32 lanes] x 16 bytes
    const uint4* wl = reinterpret_cast<const uint4*>(w + s.w_off[l]);
    const float* bl = bias + s.b_off[l];
    const bool last = l == s.n_layers - 1;
    // this lane's ldmatrix row pointers into the two 16-row halves
    const __nv_bfloat16* a_lo = in + (lane & 15) * ld_in + (lane >> 4) * 8;
    const __nv_bfloat16* a_hi = a_lo + 16 * ld_in;

    for (int nb = warp; nb < n_blocks; nb += kWarps) {
      float acc[2][2][4] = {};      // [row half][n8 tile][fragment]
      const uint4* wp = wl + static_cast<long long>(nb) * nk * 32 + lane;
      uint4 ring[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        if (d < nk) ring[d] = __ldg(wp + d * 32);
      }
      for (int kb = 0; kb < nk; kb += kDepth) {
#pragma unroll
        for (int d = 0; d < kDepth; ++d) {
          const int k = kb + d;
          if (k < nk) {
            const uint4 b = ring[d];
            if (k + kDepth < nk) ring[d] = __ldg(wp + (k + kDepth) * 32);
            unsigned a[4];
            ldmatrix_x4(a, a_lo + 16 * k);
            mma_bf16(acc[0][0], a, b.x, b.y);
            mma_bf16(acc[0][1], a, b.z, b.w);
            if (two_halves) {
              ldmatrix_x4(a, a_hi + 16 * k);
              mma_bf16(acc[1][0], a, b.x, b.y);
              mma_bf16(acc[1][1], a, b.z, b.w);
            }
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          epilogue(acc[half][j], 16 * half + g, nb * 16 + 8 * j + 2 * c, bl, last, act,
                   nxt, ld_nxt, out, row0, batch, c_out);
        }
      }
    }
    __syncthreads();  // the next layer reads what every warp wrote
  }
}

}  // namespace

extern "C" {

// x [batch, c_in] f32; w: the packed bf16 weights, layer i in fragment order
// (fused_mlp.py::pack_mlp_params) over padded widths [pdims[i], pdims[i+1]];
// bias: the packed f32 biases; pdims: n_layers + 1 padded widths (host
// memory); out [batch, c_out] f32. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int ib_fused_mlp_forward(const void* x, int batch, int c_in, const void* w,
                         const void* bias, const int* pdims, int n_layers, void* out,
                         int c_out, int act, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l <= n_layers; ++l) {
    if (pdims[l] < 16 || pdims[l] % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (c_in > pdims[0] || c_out > pdims[n_layers]) return static_cast<int>(cudaErrorInvalidValue);

  MlpShape s{};
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
  int max_hidden = 0;
  for (int l = 1; l < n_layers; ++l) max_hidden = pdims[l] > max_hidden ? pdims[l] : max_hidden;
  s.ld_p = (pdims[0] > max_hidden ? pdims[0] : max_hidden) + kSmemPad;
  s.ld_q = max_hidden + kSmemPad;
  // fused_mlp.py caps the widths (MAX_IN, MAX_WIDTH) so that this stays
  // under the 227 KB a block may use: at most 197,632 bytes.
  const size_t smem = static_cast<size_t>(kRowsPerBlock) * (s.ld_p + s.ld_q) *
                      sizeof(__nv_bfloat16);

  const cudaError_t err = ensure_dynamic_smem<FusedMlpTag>(fused_mlp_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + kRowsPerBlock - 1) / kRowsPerBlock);
  fused_mlp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), batch, c_in, static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), c_out, act, s);
  return static_cast<int>(cudaGetLastError());
}

const char* ib_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
