// Register-level tensor-core helpers for the stack's backward walk
// (csrc/mp_stack_bwd.cu) and its grouped weight-gradient contraction
// (csrc/wgrad_group.cuh): 16-byte cp.async copies, ldmatrix fragment loads
// from shared memory and mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..)
//   B (16 x 8):             b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8, fp32):       c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8q..8q+7 give the row addresses of matrix q.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// A fragment of the 16 x 16 tile at (m0, k0) of a row-major [m][k] buffer.
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const __nv_bfloat16* buf, int ld, int m0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldsm4(a, buf + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (n0, n0 + 8), k0..k0+15, of a [k][n] buffer
// (rows are k): b[0], b[1] for n0, b[2], b[3] for n0 + 8.
__device__ __forceinline__ void frag_b_kn(unsigned (&b)[4], const __nv_bfloat16* buf, int ld,
                                          int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm4t(b, buf + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// The same two B fragments from an [n][k] buffer (rows are n).
__device__ __forceinline__ void frag_b_nk(unsigned (&b)[4], const __nv_bfloat16* buf, int ld,
                                          int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm4(b, buf + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// c (16 x 8, fp32) += a (16 x 16) * b (16 x 8), bf16 operands; registers
// only, left for the compiler to schedule.
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

}  // namespace
