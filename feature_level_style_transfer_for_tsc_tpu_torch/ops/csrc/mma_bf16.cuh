// The native bf16 building blocks shared by the tensor-core kernels on bf16
// operands, for Hopper (sm_90a): tap_gemm_bf16.cuh (the OS conv under
// compute_dtype="bfloat16"), wn_fwd_bf16.cuh and wn_bwd_bf16.cuh (the WN
// under FLSTTSC_WN_MXU=bf16).  The m16n8k16 bf16 mma with f32 accumulators, a
// cp.async of part of a 16-byte granule, and ldmatrix of four transposed
// 8 x 8 bf16 matrices.
//
// A bf16 product is exact in f32; only the sums round.  The tensor core's
// accumulate truncates, so a long sum is taken in stages, each into zeroed
// registers, added to the running total with one rounded f32 add
// (mma_tf32.cuh says the same of the TF32 products).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// Internal linkage (static), as mma_tf32.cuh: each library keeps its own copy.
namespace bf16mma {

static __device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                                uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of the first ``bytes`` (0-16) of a 16-byte granule, the rest zero-filled.
static __device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory, each transposed: lane l gives
// the address of row l % 8 of matrix l / 8 (16 bytes) and receives elements
// (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of each, the first in the low
// half.  So a matrix stored (reduction, column) row by row loads as the mma's
// A fragment of its transpose, or as its B fragment.
static __device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

}  // namespace bf16mma
