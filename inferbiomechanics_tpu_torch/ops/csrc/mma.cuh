// Tensor-core helpers shared by the port's kernels: ldmatrix and
// mma.sync m16n8k16 on bf16 operands with f32 accumulators (sm_80 and later;
// the kernels are built for sm_90a).
#pragma once

#include <cuda_bf16.h>

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
