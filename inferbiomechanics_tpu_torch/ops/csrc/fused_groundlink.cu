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
// What bounds it on an H100 (177 -> 128 -> 128 -> 256 -> 256, k = 7, T = 10,
// fc_depth 3): not the tensor cores but the weights, 2.2 MB of bf16 that do
// not fit beside the activations, so every tile of windows streams them from
// L2 into registers (pack_groundlink_params lays each layer out in mma.sync
// fragment order: one coalesced 16-byte load a lane for a 16-column block and
// k-step). The weight bytes a window costs set the time at large batches, and
// the chain of seven dependent layers through one multiprocessor at small ones.
//
// One kernel body, two shapes of launch (fused_groundlink.py::plan_groundlink
// picks from the shape alone):
//
//  small (kSplit): a cluster of C blocks (8 at full width) shares a tile of
//    whole windows, 1..4 mma row tiles of 16 rows (one row tile: an
//    instantiation of its own). Every block owns a contiguous 1/C of every
//    layer's 16-column blocks (a balanced split, so the 2 column blocks of the
//    head fall to two blocks and every output is stored once) and streams only
//    their weights (~280 KB a block at full width). Where a block owns fewer
//    column blocks than it has warps, the warps split the k-steps too, and the
//    partial sums meet in shared memory in a fixed order. After each layer a
//    block hands its columns of the output to every other block with one bulk
//    copy between shared memories a peer, which completes on an mbarrier of
//    the receiver; there is one barrier a layer, each expecting its bytes from
//    the start and used once (parity 0). Each layer's first weights are asked
//    for before the exchange ahead of it.
//
//  large (!kSplit): one block a tile of many windows (up to 16 of T = 10 in
//    last_frame, 6 in all_frames), all the columns; the warps split a layer's
//    row tiles into groups of at most kRT = 4 where there are more,
//    neighbouring warps taking the same column block at the same time, so
//    that their weight loads meet in L1.
//
// Both shapes trim the convs in last_frame mode: the head reads frame T-1
// only, and conv l (of n) must produce only the last
// min(T, 1 + (n - 1 - l) * (k / 2)) frames of each window (10, 7, 4, 1 at
// T = 10, k = 7), x only the last min(T, 1 + n * (k / 2)). Layer l's rows are
// (window, its last keep_l frames); tap j of frame f reads frame
// clamp(f + j - k/2, 0, T - 1), which the previous layer kept. The frames left
// out never reach the output, so the result is the same.
//
// Activations live in shared memory as bf16 in two ping-pong buffers, laid out
// [16-column block][row][16] (a block's columns of a layer are one contiguous
// run, one bulk copy a peer), the two 16-byte halves of a 32-byte row swapped
// on every other group of four rows, so that an 8-row ldmatrix phase touches
// every bank once. Each conv is ONE product with K = taps * C_in against the
// [taps * C_in, C_out] weight, and the shift is address arithmetic: ldmatrix
// takes one row address a lane, so for tap j the lane that feeds output row
// (w, f) points at the input row of frame clamp(f + j - k/2). Replicate
// padding costs nothing. Rows that are padding (past windows * keep in the
// tile) read row 0, so they hold finite values and are never stored; windows
// past the batch are zero-filled at the load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 4;           // k-steps a tap are a multiple of this (widths of 64)
constexpr int kMaxLayers = 12;      // convs + FC layers + head
constexpr int kMaxCluster = 8;
constexpr int kMaxT = 64;
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use
constexpr int kPhases = 1 + 2 * kMaxLayers;   // stage x; then each layer's product and exchange

template <int kRT, int kDepth, bool kSplit, int kMinBlocks>
struct FusedGroundlinkTag {};       // keys a kernel's shared-memory cap (launch.cuh)

struct GlPlan {
  int batch, t, c_in, c_out, n_conv, n_layers, taps;
  int cluster;                      // blocks that share a tile: C (small), 1 (large)
  int windows;                      // whole windows a tile
  int keep_in;                      // frames of each window of x that are staged (the last ones)
  int rows_x;                       // rows of the staged x, a multiple of 16
  int off_q, off_v, off_s, scratch_floats, off_b;   // bytes: Q, the biases, the scratch, the mbarriers
  int n_bias;                       // f32 biases of all layers but the head, end to end
  int width[kMaxLayers + 1];        // padded widths: width[l] in, width[l + 1] out of layer l
  int keep[kMaxLayers];             // frames of each window in layer l's output rows
  int rows[kMaxLayers];             // rows of layer l's output, a multiple of 16
  long long w_off[kMaxLayers];      // offset of layer l in the weight buffer
  int b_off[kMaxLayers];            // offset of layer l in the bias buffer
};

__host__ __device__ __forceinline__ int own_begin(int ncb, int cluster, int rank) {
  return rank * ncb / cluster;      // the balanced split of ncb column blocks
}

// Where a layer's work falls in a block: its column blocks, its row tiles in
// groups of at most kRT, and (small shape) the split of its k-steps.
struct Work {
  const uint4* w;                   // the layer in fragment order: [ncb][nk][32 lanes] x 16 bytes
  int nkc, nk;                      // k-steps a tap, in all
  int cb0, n_own;                   // this block's column blocks
  int row_tiles, groups, split;
};

// Parts a block's k-steps of a layer are split into (small shape): one warp
// an item, each part a whole number of chunks.
__host__ __device__ __forceinline__ int layer_split(int n_own, int nk) {
  if (n_own <= 0) return 1;
  const int s = kWarps / n_own;
  const int chunks = nk / kChunk;
  return s < 1 ? 1 : (s > chunks ? chunks : s);
}

__device__ __forceinline__ Work layer_work(const GlPlan& s, const bf16* w, int l, int rank,
                                           int kRT, bool split) {
  Work k;
  const int taps = l < s.n_conv ? s.taps : 1;
  const int ncb = s.width[l + 1] / 16;
  k.w = reinterpret_cast<const uint4*>(w + s.w_off[l]);
  k.nkc = s.width[l] / 16;
  k.nk = taps * k.nkc;
  k.cb0 = own_begin(ncb, s.cluster, rank);
  k.n_own = own_begin(ncb, s.cluster, rank + 1) - k.cb0;
  k.row_tiles = s.rows[l] / 16;
  k.groups = (k.row_tiles + kRT - 1) / kRT;
  k.split = split ? layer_split(k.n_own, k.nk) : 1;
  return k;
}

// Item i of a layer (warp i takes items i, i + kWarps, ...): column block j of
// the block's, row group g, k-step part p. Neighbouring items share a column
// block, so that warps that stream the same weights run side by side.
struct Item {
  int j, g, part, ks0, len;
};

__device__ __forceinline__ Item item_of(const Work& k, int item) {
  Item it;
  it.part = item % k.split;
  const int rest = item / k.split;
  it.g = rest % k.groups;
  it.j = rest / k.groups;
  const int chunks = k.nk / kChunk;
  it.ks0 = it.part * chunks / k.split * kChunk;
  it.len = (it.part + 1) * chunks / k.split * kChunk - it.ks0;
  return it;
}

__device__ __forceinline__ const uint4* item_weights(const Work& k, const Item& it) {
  return k.w + (static_cast<long long>(k.cb0 + it.j) * k.nk + it.ks0) * 32 + (threadIdx.x & 31);
}

// Ask for the first kDepth k-steps of this warp's first item of a layer ahead
// of it: the loads need no activation, so they fly across the barrier or the
// exchange before the layer.
template <int kDepth>
__device__ __forceinline__ void prefetch(uint4 (&ring)[kDepth], const Work& k) {
  const int warp = threadIdx.x >> 5;
  if (warp < k.n_own * k.groups * k.split) {
    const Item it = item_of(k, warp);
    const uint4* wp = item_weights(k, it);
#pragma unroll
    for (int dd = 0; dd < kDepth; ++dd) {
      if (dd < it.len) ring[dd] = __ldg(wp + dd * 32);
    }
  }
}

// Element offset of (row, 16-byte half) inside a column block [rows][16].
__device__ __forceinline__ int swz(int row, int half) {
  return row * 16 + ((half ^ ((row >> 2) & 1)) << 3);
}

// Which input row output row r of a layer reads for tap `tap`.
struct RowMap {
  int t, keep_in, keep_out, valid, half;
  bool conv;
  __device__ __forceinline__ int source(int r, int tap) const {
    if (!conv) return r;
    if (r >= valid) r = 0;
    const int w = r / keep_out;
    const int f = t - keep_out + (r - w * keep_out);
    const int sf = min(max(f + tap - half, 0), t - 1);
    return w * keep_in + sf - (t - keep_in);
  }
};

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expf(v) - 1.f;     // exp(min(v, 0)) - 1, not expm1
}

// One layer for the block's tile: `in` ([width / 16][rows_in][16] bf16) times
// the layer's weights, for the block's column blocks. emit(row, col, v0, v1)
// receives every pair of neighbouring f32 sums (col even) exactly once. With
// `prefetched`, `ring` holds the first k-steps of this warp's first item
// (prefetch). With a split along K, every part stores its partial sums in the
// scratch and, after a barrier, all the block's threads add them in part order
// and run the epilogue. Every thread of the block calls it.
template <int kRT, int kDepth, typename Emit>
__device__ __forceinline__ void product(const bf16* in, int rows_in, const Work& k,
                                        const RowMap& m, uint4 (&ring)[kDepth], bool prefetched,
                                        float* scratch, Emit emit) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2;          // fragment row group
  const int c = lane & 3;            // fragment column pair
  const int n_items = k.n_own * k.groups * k.split;
  const int per = (k.row_tiles + k.groups - 1) / k.groups;
  const int step = rows_in * 16;     // elements from one input column block to the next
  for (int item = warp; item < n_items; item += kWarps) {
    const Item it = item_of(k, item);
    const int rt0 = it.g * per;
    const int nrt = min(per, k.row_tiles - rt0);
    const uint4* wp = item_weights(k, it);
    if (!prefetched || item != warp) {
#pragma unroll
      for (int dd = 0; dd < kDepth; ++dd) {
        if (dd < it.len) ring[dd] = __ldg(wp + dd * 32);
      }
    }
    int tap = it.ks0 / k.nkc;
    int kc = it.ks0 - tap * k.nkc;   // k-step within the tap, a multiple of kChunk
    int off[kRT];                    // this lane's ldmatrix row offset, one a row tile
#pragma unroll
    for (int rt = 0; rt < kRT; ++rt) {
      const int src = m.source(16 * (rt0 + rt) + (lane & 15), tap);
      off[rt] = swz(src, lane >> 4);
    }
    float acc[kRT][2][4];            // [row tile][n8 tile][fragment]
#pragma unroll
    for (int rt = 0; rt < kRT; ++rt) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[rt][e >> 2][e & 3] = 0.f;
    }
    // chunks of kChunk k-steps: a tap is a whole number of them, so the
    // checks run once a chunk and the chunk's addresses are immediates
    for (int kb = 0; kb < it.len; kb += kDepth) {
#pragma unroll
      for (int ch = 0; ch < kDepth / kChunk; ++ch) {
        if (kb + ch * kChunk < it.len) {   // the same for every lane of the warp
          if (kc == k.nkc) {         // the next tap: shifted rows
            kc = 0;
            ++tap;
#pragma unroll
            for (int rt = 0; rt < kRT; ++rt) {
              const int src = m.source(16 * (rt0 + rt) + (lane & 15), tap);
              off[rt] = swz(src, lane >> 4);
            }
          }
          const bf16* a = in + kc * step;
#pragma unroll
          for (int dd = 0; dd < kChunk; ++dd) {
            const int ks = kb + ch * kChunk + dd;
            const uint4 b = ring[ch * kChunk + dd];
            if (ks + kDepth < it.len) ring[ch * kChunk + dd] = __ldg(wp + (ks + kDepth) * 32);
#pragma unroll
            for (int rt = 0; rt < kRT; ++rt) {
              if (rt < nrt) {
                unsigned af[4];
                ldmatrix_x4(af, a + dd * step + off[rt]);
                mma_bf16(acc[rt][0], af, b.x, b.y);
                mma_bf16(acc[rt][1], af, b.z, b.w);
              }
            }
          }
          kc += kChunk;
        }
      }
    }
    // this lane holds rows g8 and g8 + 8, columns 2c and 2c + 1 of each 16x8 tile
    const int nb = k.cb0 + it.j;
#pragma unroll
    for (int rt = 0; rt < kRT; ++rt) {
      if (rt < nrt) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * (rt0 + rt) + g8 + 8 * h;
            if (k.split == 1) {
              emit(r, 16 * nb + 8 * jj + 2 * c, acc[rt][jj][2 * h], acc[rt][jj][2 * h + 1]);
            } else {
              // partial sums: [part][j][row][16 columns]
              *reinterpret_cast<float2*>(
                  scratch + ((it.part * k.n_own + it.j) * 16 * k.row_tiles + r) * 16 + 8 * jj +
                  2 * c) = make_float2(acc[rt][jj][2 * h], acc[rt][jj][2 * h + 1]);
            }
          }
        }
      }
    }
  }
  if (k.split > 1) {
    __syncthreads();
    const int rows = 16 * k.row_tiles;
    const int pairs = k.n_own * rows * 8;
    const int per_part = k.n_own * rows * 16;
    for (int i = threadIdx.x; i < pairs; i += kThreads) {
      const int cp = i & 7;          // column pair of the block's 16
      const int r = (i >> 3) % rows;
      const int j = (i >> 3) / rows;
      const float* src = scratch + (j * rows + r) * 16 + 2 * cp;
      float2 v = *reinterpret_cast<const float2*>(src);
      for (int part = 1; part < k.split; ++part) {
        const float2 q = *reinterpret_cast<const float2*>(src + part * per_part);
        v.x += q.x;
        v.y += q.y;
      }
      emit(r, 16 * (k.cb0 + j) + 2 * cp, v.x, v.y);
    }
  }
}

template <int kRT, int kDepth, bool kSplit, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_groundlink_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ out, GlPlan s,
                        long long* __restrict__ clocks) {
  // shared memory: P [.. off_q) | Q [off_q .. off_v) | biases | scratch | mbarriers
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const buf_p = reinterpret_cast<bf16*>(smem);
  bf16* const buf_q = reinterpret_cast<bf16*>(smem + s.off_q);
  float* const bias_s = reinterpret_cast<float*>(smem + s.off_v);
  float* const scratch = reinterpret_cast<float*>(smem + s.off_s);
  const unsigned bars = smem_u32(smem + s.off_b);

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
  const int win0 = static_cast<int>(blockIdx.x) / peers * s.windows;
  const int n_win = min(s.windows, s.batch - win0);
  // Small: one mbarrier a layer but the head, on which the other blocks'
  // columns of its output land; each expects its bytes from the start. Every
  // block of the cluster has set them up before any copy into another's
  // shared memory (after layer 0).
  if constexpr (kSplit) {
    if (threadIdx.x == 0) {
      for (int l = 0; l + 1 < s.n_layers; ++l) mbar_init(bars + 8 * l, 1);
      mbar_init_fence();
      for (int l = 0; l + 1 < s.n_layers; ++l) {
        const int ncb = s.width[l + 1] / 16;
        const int mine = own_begin(ncb, peers, rank + 1) - own_begin(ncb, peers, rank);
        mbar_arrive_expect_tx(bars + 8 * l, static_cast<unsigned>((ncb - mine) * s.rows[l] * 32));
      }
    }
    cluster_arrive();
  }

  uint4 ring[kDepth];
  Work k = layer_work(s, w, 0, rank, kRT, kSplit);

  // Stage the tile's x (the last keep_in frames of each window) into P as
  // bf16, zero-filled past the block's windows and past c_in, and the biases
  // into shared memory; all of a thread's loads of a round before its stores.
  {
    constexpr int kX = 8;             // loads in flight a thread
    const int kin = s.keep_in;
    const int k0 = s.width[0];
    const int valid = n_win * kin;
    const int n = s.rows_x * k0;
    const float* xs = x + static_cast<long long>(win0) * s.t * s.c_in;
    for (int i0 = 0; i0 < n; i0 += kX * kThreads) {
      float v[kX];
#pragma unroll
      for (int e = 0; e < kX; ++e) {
        const int i = i0 + e * kThreads + threadIdx.x;
        const int r = i / k0;
        const int col = i - r * k0;
        v[e] = 0.f;
        if (i < n && r < valid && col < s.c_in) {
          const int wi = r / kin;
          const int f = s.t - kin + (r - wi * kin);
          v[e] = __ldg(xs + (static_cast<long long>(wi) * s.t + f) * s.c_in + col);
        }
      }
      // layer 0's first weights queue behind the first of x, not ahead of it
      if (i0 == 0) prefetch(ring, k);
#pragma unroll
      for (int e = 0; e < kX; ++e) {
        const int i = i0 + e * kThreads + threadIdx.x;
        const int r = i / k0;
        const int col = i - r * k0;
        if (i < n) {
          buf_p[(col >> 4) * s.rows_x * 16 + swz(r, (col >> 3) & 1) + (col & 7)] =
              __float2bfloat16(v[e]);
        }
      }
    }
    for (int i0 = 0; i0 < s.n_bias; i0 += kX * kThreads) {
      float v[kX];
#pragma unroll
      for (int e = 0; e < kX; ++e) {
        const int i = i0 + e * kThreads + threadIdx.x;
        v[e] = i < s.n_bias ? __ldg(bias + i) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < kX; ++e) {
        const int i = i0 + e * kThreads + threadIdx.x;
        if (i < s.n_bias) bias_s[i] = v[e];
      }
    }
  }
  __syncthreads();
  lap(1);

  const bf16* in = buf_p;
  bf16* nxt = buf_q;
  int rows_in = s.rows_x;
  int keep_in = s.keep_in;
  for (int l = 0; l < s.n_layers; ++l) {
    const bool conv = l < s.n_conv;
    const bool last = l == s.n_layers - 1;
    const RowMap m{s.t, keep_in, s.keep[l], s.windows * s.keep[l], (conv ? s.taps : 1) / 2, conv};
    const float* bl = bias_s + s.b_off[l];
    const int rows_out = s.rows[l];
    const int valid_out = n_win * s.keep[l];
    float* const out0 = out + static_cast<long long>(win0) * s.keep[l] * s.c_out;
    const int c_out = s.c_out;
    bf16* const dst = nxt;
    // f32 bias and ELU, then one rounding to bf16 for the next product; the
    // head has neither and its f32 sums are the output
    product<kRT, kDepth>(in, rows_in, k, m, ring, true, scratch,
                         [=](int r, int n, float v0, float v1) {
                           if (!last) {
                             *reinterpret_cast<__nv_bfloat162*>(
                                 dst + (n >> 4) * rows_out * 16 + swz(r, (n >> 3) & 1) + (n & 7)) =
                                 __floats2bfloat162_rn(elu(v0 + bl[n]), elu(v1 + bl[n + 1]));
                           } else if (r < valid_out) {
                             float* o = out0 + static_cast<long long>(r) * c_out;
                             if (n < c_out) o[n] = v0;
                             if (n + 1 < c_out) o[n + 1] = v1;
                           }
                         });
    lap(2 + 2 * l);
    if (!last) {
      const Work kn = layer_work(s, w, l + 1, rank, kRT, kSplit);
      if constexpr (kSplit) {
        // this block's columns of the output to every other block, one bulk
        // copy a peer onto the receiver's barrier of this layer
        fence_proxy_async_smem();
        __syncthreads();
        if (l == 0) cluster_wait();
        if (k.n_own > 0 && static_cast<int>(threadIdx.x) < peers - 1) {
          const unsigned q = (rank + 1 + threadIdx.x) % peers;
          const unsigned src = smem_u32(nxt + k.cb0 * rows_out * 16);
          bulk_copy_s2c(cluster_map(src, q), src, static_cast<unsigned>(k.n_own * rows_out * 32),
                        cluster_map(bars + 8 * l, q));
        }
        prefetch(ring, kn);
        mbar_wait(bars + 8 * l, 0);
        // after the last exchange this block has all it was sent; the others
        // may end once every block has, when no copy reads their memory
        if (l + 2 == s.n_layers) cluster_arrive_relaxed();
      } else {
        prefetch(ring, kn);
        __syncthreads();  // the next layer reads what every warp wrote
      }
      k = kn;
    }
    lap(3 + 2 * l);
    in = nxt;
    nxt = nxt == buf_q ? buf_p : buf_q;
    rows_in = rows_out;
    keep_in = s.keep[l];
  }
  if constexpr (kSplit) cluster_wait();
}

template <int kRT, int kDepth, bool kSplit, int kMinBlocks>
cudaError_t launch(const GlPlan& s, size_t smem, const float* x, const bf16* w, const float* b,
                   float* out, long long* clocks, cudaStream_t stream) {
  auto kernel = fused_groundlink_kernel<kRT, kDepth, kSplit, kMinBlocks>;
  const cudaError_t err =
      ensure_dynamic_smem<FusedGroundlinkTag<kRT, kDepth, kSplit, kMinBlocks>>(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (s.batch + s.windows - 1) / s.windows;
  if constexpr (!kSplit) {         // an ordinary launch: no cluster attribute
    kernel<<<tiles, kThreads, smem, stream>>>(x, w, b, out, s, clocks);
    return cudaSuccess;
  }
  return launch_cluster(kernel, tiles * s.cluster, kThreads, s.cluster, smem, stream, x, w, b,
                        out, s, clocks);
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
// f32. plan: the 11 + kMaxLayers ints of fused_groundlink.py::plan_groundlink
// (small, cluster, windows, row tiles a warp, ring depth, keep_in, off_q,
// off_v, off_s, scratch_floats, off_b, then the frames each layer keeps);
// smem: its bytes.
// clocks: null, or room for kPhases int64 a block, which get each phase's
// cycles (thread 0's clock64). Launches on `stream` and returns the launch's
// error (0 on success).
int ib_fused_groundlink_forward(const void* x, int batch, int t, int c_in, const void* w,
                                const void* bias, const int* pwidths, int n_conv, int n_fc,
                                int taps, int last_frame, void* out, int c_out, const int* plan,
                                int smem, void* clocks, void* stream) {
  const int n_layers = n_conv + n_fc;
  if (batch < 1 || t < 1 || t > kMaxT || n_conv < 1 || n_fc < 1 || n_layers > kMaxLayers ||
      taps < 1 || taps % 2 != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l <= n_layers; ++l) {
    const int unit = l < n_layers ? 64 : 16;
    if (pwidths[l] < unit || pwidths[l] % unit != 0 || pwidths[l] > 512) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (c_in > pwidths[0] || c_out > pwidths[n_layers]) return static_cast<int>(cudaErrorInvalidValue);

  const bool small = plan[0] != 0;
  const int rt_warp = plan[3];
  const int depth = plan[4];
  GlPlan s{};
  s.batch = batch;
  s.t = t;
  s.c_in = c_in;
  s.c_out = c_out;
  s.n_conv = n_conv;
  s.n_layers = n_layers;
  s.taps = taps;
  s.cluster = plan[1];
  s.windows = plan[2];
  s.keep_in = plan[5];
  s.off_q = plan[6];
  s.off_v = plan[7];
  s.off_s = plan[8];
  s.scratch_floats = plan[9];
  s.off_b = plan[10];
  const int half = taps / 2;
  bool ok = s.cluster >= 1 && s.cluster <= kMaxCluster && (small || s.cluster == 1) &&
            s.windows >= 1 && s.keep_in >= 1 && s.keep_in <= t &&
            (small ? (rt_warp == 1 || rt_warp == 4) && depth == 16
                   : rt_warp == 4 && (depth == 8 || depth == 16)) &&
            smem <= kMaxSmem &&
            s.off_q % 16 == 0 && s.off_v % 16 == 0 && s.off_s % 16 == 0 && s.off_b % 8 == 0 &&
            s.scratch_floats >= 0 && s.off_s + s.scratch_floats * 4 <= smem &&
            (!small || s.off_b + 8 * (n_layers - 1) <= smem) &&
            (!small || s.off_b >= s.off_s + s.scratch_floats * 4);
  s.rows_x = (s.windows * s.keep_in + 15) / 16 * 16;
  ok = ok && s.rows_x * pwidths[0] * 2 <= s.off_q;
  long long w_off = 0;
  int b_off = 0;
  int keep_prev = s.keep_in;
  for (int l = 0; l < n_layers && ok; ++l) {
    const bool conv = l < n_conv;
    s.width[l] = pwidths[l];
    s.w_off[l] = w_off;
    s.b_off[l] = b_off;
    w_off += static_cast<long long>(conv ? taps : 1) * pwidths[l] * pwidths[l + 1];
    b_off += pwidths[l + 1];
    s.keep[l] = plan[11 + l];
    // a conv's frames must lie within the frames the layer before it kept;
    // an FC layer keeps the rows it is given
    const int need = conv ? (s.keep[l] + half < t ? s.keep[l] + half : t) : keep_prev;
    ok = ok && s.keep[l] >= 1 && s.keep[l] <= t && (conv ? keep_prev >= need : s.keep[l] == keep_prev);
    ok = ok && (!last_frame || l < n_conv - 1 || s.keep[l] == 1) &&
         (last_frame || s.keep[l] == t);
    s.rows[l] = (s.windows * s.keep[l] + 15) / 16 * 16;
    const int rt = s.rows[l] / 16;
    if (l + 1 < n_layers) {   // the buffer this layer writes: Q for even l, P for odd
      const int bytes = s.rows[l] * pwidths[l + 1] * 2;
      ok = ok && (l % 2 == 0 ? s.off_q + bytes <= s.off_v : bytes <= s.off_q);
    }
    if (small) {
      ok = ok && rt <= rt_warp;
      const int ncb = pwidths[l + 1] / 16;
      const int nk = (conv ? taps : 1) * pwidths[l] / 16;
      for (int r = 0; r < s.cluster && ok; ++r) {
        const int n_own = own_begin(ncb, s.cluster, r + 1) - own_begin(ncb, s.cluster, r);
        const int split = layer_split(n_own, nk);
        ok = split == 1 || split * n_own * rt * 256 <= s.scratch_floats;
      }
    }
    keep_prev = s.keep[l];
  }
  s.width[n_layers] = pwidths[n_layers];
  s.n_bias = b_off - pwidths[n_layers];   // the head has no bias
  ok = ok && s.off_v + s.n_bias * 4 <= s.off_s;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  const float* xf = static_cast<const float*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  long long* cl = static_cast<long long*>(clocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // One row tile has an instantiation of its own: a quarter of the unrolled
  // product code, and its registers. The large shape where one block has a
  // multiprocessor (a grid of at most one block each, or a tile whose shared
  // memory leaves room for no second block) keeps 16 k-steps of weights in
  // flight a warp; where two blocks share one (128 registers), 8. (8 row
  // tiles a warp, so that fewer warps stream the same weights, was slower:
  // warps that share a column block meet in L1.)
  const cudaError_t err =
      small ? (rt_warp == 1 ? launch<1, 16, true, 1>(s, smem, xf, wb, bf, of, cl, st)
                            : launch<4, 16, true, 1>(s, smem, xf, wb, bf, of, cl, st))
      : depth == 8 ? launch<4, 8, false, 2>(s, smem, xf, wb, bf, of, cl, st)
                   : launch<4, 16, false, 1>(s, smem, xf, wb, bf, of, cl, st);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
