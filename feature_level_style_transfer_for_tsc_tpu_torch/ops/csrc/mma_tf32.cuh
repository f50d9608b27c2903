// The 3xTF32 building blocks shared by the tensor-core kernels of
// tap_gemm.cuh (the conv tap GEMM) and wn_fused.cu (the WN's f32 kernels),
// for Hopper (sm_90a): the TF32 split of an f32 value, the bf16 rounding of
// the WN's FP32 FMA row products on bf16 operands, the m16n8k8 TF32 mma,
// ldmatrix of two or four 8 x 4-word matrices, and cp.async.
//
// An f32 product a*b is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b with
// hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi) (the dropped lo*lo is
// below f32 rounding).  The tensor core's accumulate truncates, so a long
// sum is taken in stages, each into zeroed registers, added to the running
// total with one rounded f32 add (tap_gemm.cuh says what it measured).
//
// The bf16 OS conv and both bf16 WN directions (the JAX package's
// compute_dtype="bfloat16" and FLSTTSC_WN_MXU=bf16) have native bf16
// products (tap_gemm_bf16.cuh, wn_fwd_bf16.cuh, wn_bwd_bf16.cuh;
// mma_bf16.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// Internal linkage (static), as tap_gemm.cuh: each library keeps its own
// copy.  No anonymous namespace here: a using-directive for it beside the
// includer's own would make nvcc's host stubs ambiguous.
namespace tf32x3 {

static __device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// v rounded to bf16 (to nearest, ties to even), widened back to f32 bits.
static __device__ __forceinline__ uint32_t round_bf16(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v))) << 16;
}

static __device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 4-word matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 and receives word l % 4 of row l / 4 of each.
static __device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint32_t* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Two of them: lanes 0-15 give the addresses (matrix l / 8), as ldmatrix_x4's.
static __device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const uint32_t* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// cp.async of 4 or 16 bytes; an invalid source copies nothing and zero-fills.
static __device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

static __device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

static __device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

static __device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;"); }

}  // namespace tf32x3
