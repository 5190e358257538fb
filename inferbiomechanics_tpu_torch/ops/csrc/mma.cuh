// Device-side helpers shared by the port's kernels (built for sm_90a).
//  - ldmatrix, movmatrix and mma.sync m16n8k16 on bf16 operands with f32
//    accumulators (sm_80 and later);
//  - Hopper's own: mbarriers, bulk copies from device memory into shared
//    memory that complete on an mbarrier, wgmma (operands in shared memory
//    in the 128-byte-swizzled K-major layout, f32 accumulators in
//    registers), and the cluster primitives (rank, barrier, bulk copies
//    into another block's shared memory or multicast into several, arrivals
//    on another block's mbarriers).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

// A fragment of mma.m16n8k16 (row-major 16x16 bf16) from shared memory. Lane
// l points at row l % 16, columns (l / 16) * 8 .. + 7 of the tile.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same load with each 8x8 matrix transposed: for operands that lie in
// shared memory with the product's k index along the rows (A^T G products).
// Lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a * b for one 16x8 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The transpose of an 8x8 b16 matrix held as one mma fragment register a
// lane (lane l: row l / 4, elements 2 (l % 4) and + 1).
__device__ __forceinline__ unsigned movmatrix_trans(unsigned a) {
  unsigned d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// ---------------------------------------------------------------------------
// Hopper (sm_90a)
// ---------------------------------------------------------------------------

// The 32-bit shared-memory address of a generic pointer into shared memory.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (8 bytes each in shared memory, addressed by smem_u32) ----

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

// After the last mbar_init and before any other thread, of this block or of
// its cluster, touches the barriers.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also announces `bytes` of bulk copies to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A wait that has spun this often can only be a deadlock: the kernel traps,
// so that the launch fails instead of hanging the card.
constexpr unsigned kMbarSpinLimit = 1u << 24;

// Spin until the barrier's phase of this parity has completed. A new
// barrier passes parity 1 at once and parity 0 after its first completion.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done, spins = 0;
  // a phase that is complete already is seen fastest by a test that cannot block
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++spins > kMbarSpinLimit) __trap();
  }
}

// ---- copies into shared memory ----

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this block's shared memory; completes on `bar` (see
// mbar_arrive_expect_tx). One thread starts it.
__device__ __forceinline__ void bulk_copy_g2s(unsigned dst, const void* src, unsigned bytes,
                                              unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The same copy into the shared memory of every block of the cluster whose
// rank is set in `mask`, at the same offset `dst` as in this block, each
// completing on its own mbarrier at this block's offset `bar`.
__device__ __forceinline__ void bulk_copy_g2s_multicast(unsigned dst, const void* src,
                                                        unsigned bytes, unsigned bar,
                                                        unsigned short mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// One box of a 2-D tensor map (launch.cuh::make_tensor_map_2d) at element
// coordinates (c0 along the rows, c1 across them) into this block's shared
// memory at `dst` (128-byte aligned), dense, rows of the box end to end;
// what lies outside the tensor arrives as zeros. Completes on `bar` with the
// whole box's bytes. One thread starts it.
__device__ __forceinline__ void tma_load_2d(unsigned dst, const void* tensor_map, int c0, int c1,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(tensor_map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Brings a tensor map (a kernel parameter, or in global memory) into the
// cache the TMA unit reads descriptors from, ahead of its first copy.
__device__ __forceinline__ void prefetch_tensor_map(const void* tensor_map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(tensor_map))
               : "memory");
}

// Makes this thread's earlier writes to shared memory visible to the
// asynchronous proxy, through which wgmma and bulk copies read. Before the
// barrier that hands the data over.
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ----

// Descriptor of a K-major bf16 operand tile in shared memory in the
// 128-byte-swizzled layout: rows of 64 elements (128 bytes), groups of 8
// rows 1024 bytes apart, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8); the tile starts at a multiple of 1024 bytes. Adding 2 to the
// descriptor moves 16 elements (32 bytes) along K within the row.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(unsigned smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// d (+)= A B for one warpgroup: A is 64 x 16 and B is 16 x kN, both bf16 in
// shared memory behind descriptors, both K-major (B lies as [kN][K]); d is
// the 64 x kN f32 accumulator, kN / 2 registers a thread: thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 and that + 8, and for each
// 8-column block i the columns 8 i + 2 (t % 4) and + 1, as
// d[4 i + 2 (row half) + (column)]. scale_d = 0 overwrites d.
template <int kN>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// Descriptor of an MN-major bf16 operand tile in the 128-byte-swizzled
// layout, as TMA boxes of 64 columns (128 bytes) land with
// CU_TENSOR_MAP_SWIZZLE_128B: the product's K index runs down the box's rows
// (128 bytes apart, groups of 8 rows 1024 bytes apart, the 16-byte chunk c of
// row r stored at chunk c ^ (r % 8)) and its M or N index along a row, 64 a
// box; boxes that continue along M or N lie `lbo` bytes apart. The tile
// starts at a multiple of 1024 bytes; adding 128 to the descriptor moves 16
// rows (one k-step of 16) down.
__device__ __forceinline__ uint64_t wgmma_desc_sw128_mn(unsigned smem_addr, unsigned lbo) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
}

// d (+)= A B as Wgmma, both operands MN-major (wgmma_desc_sw128_mn): A is
// 64 x 16 stored as 16 rows of 64 M values, B is 16 x kN stored as 16 rows
// of kN N values (kN / 64 boxes). For A^T G over row-major arrays whose rows
// are the sum's index. d as for Wgmma, in the first kN / 2 registers of the
// array.
template <int kN>
struct WgmmaMN;

template <>
struct WgmmaMN<128> {
  template <int kSize>
  static __device__ __forceinline__ void mma(float (&d)[kSize], uint64_t a, uint64_t b,
                                             int scale_d) {
    static_assert(kSize >= 64, "accumulator too small");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaMN<256> {
  template <int kSize>
  static __device__ __forceinline__ void mma(float (&d)[kSize], uint64_t a, uint64_t b,
                                             int scale_d) {
    static_assert(kSize >= 128, "accumulator too small");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Barrier over `threads` threads of the block (a multiple of 32), id 1..15.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- thread-block clusters ----

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The address, in the cluster's shared window, of this block's shared-memory
// address `addr` in the block of rank `rank`.
__device__ __forceinline__ unsigned cluster_map(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// `bytes` (a multiple of 16) from this block's shared memory to the same or
// another block's, both given as by cluster_map; completes on the mbarrier
// `cluster_bar` of the receiving block, which expects the bytes (see
// mbar_arrive_expect_tx). The source must have been fenced for the
// asynchronous proxy. One thread starts it.
__device__ __forceinline__ void bulk_copy_s2c(unsigned cluster_dst, unsigned src, unsigned bytes,
                                              unsigned cluster_bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(cluster_dst), "r"(src), "r"(bytes), "r"(cluster_bar)
      : "memory");
}

// The two halves of cluster_sync_all, for work between them: every thread of
// every block of the cluster arrives, then waits for all the others.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One arrival on an mbarrier of a block of the cluster, given as by
// cluster_map (release at the block's scope, as for a local arrival).
__device__ __forceinline__ void mbar_arrive_cluster(unsigned cluster_bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(cluster_bar) : "memory");
}

// An arrival without release semantics: it orders nothing that came before.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
