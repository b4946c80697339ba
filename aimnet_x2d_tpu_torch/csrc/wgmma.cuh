// Hopper warpgroup products (wgmma.mma_async) for the port's kernels:
// shared-memory matrix descriptors of the canonical layouts without
// swizzle, the fence, commit and wait of the asynchronous groups, and
// m64nNk16 bf16 products with fp32 accumulators in registers, for the N
// the kernels take (multiples of 32 up to 160, and 80); and what the wgmma
// kernels (csrc/mp_ext.cu, csrc/mp_stack_bwd.cu) share around them: the
// consumers' mbarrier waits and arrivals, named barriers, the epilogues'
// bf16 pair arithmetic and the operand layouts.
//
// Without swizzle an operand is a grid of core matrices of 8 rows of 16
// bytes (128 contiguous bytes); the descriptor gives the byte stride between
// core matrices adjacent in K (LBO) and adjacent in M or N (SBO).  K-major
// (a row of a core matrix is 8 consecutive K elements; A = [atom][feature],
// B = [out][in] for the weights) takes tnsp 0, MN-major (a row is 8
// consecutive M or N elements; A = the feature-major input tile, or B = a
// weight read as [in][out]) tnsp 1.
//
// Accumulators of m64nNk16 (PTX ISA, wgmma register fragments): thread T of
// the warpgroup, warp w = T / 32, g = (T % 32) / 4, t = T % 4, holds
// d[4j + 2h + q] = D(row 16w + g + 8h, column 8j + 2t + q), j < N / 8.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>

#include "mma.cuh"

namespace {

// Descriptor of a no-swizzle operand at p (16-byte aligned) with core-matrix
// strides lbo (K) and sbo (M or N) in bytes.
__device__ __forceinline__ uint64_t wg_desc(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Ties the accumulators to this point of the program: the compiler moves
// no use of them across it (after a wait, before the epilogue reads them).
template <int R> __device__ __forceinline__ void wg_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32) = (scale_d ? d : 0) + A (64 x 16) B (16 x N), bf16
// operands from shared memory by descriptor; TA: A MN-major; TB: B
// MN-major (a row of a core matrix is 8 consecutive N elements).
template <int N, int TA, int TB = 0> struct Wgmma;
template <int TA, int TB> struct Wgmma<32, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<64, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<80, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[40], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, %43, %44;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<96, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[48], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<128, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<160, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[80], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, %83, %84;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

// The consumers' mbarrier wait: the polling loop inside one asm block, so
// the compiler sees no data-dependent branch before the wgmma that follow
// (it serialises wgmma in a path it takes for divergent).  A wait that
// polls 2^26 times (seconds) is a fault: it traps, as mbar_wait does.
__device__ __forceinline__ void wg_wait_bar(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 67108864;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One arrival on bar where pred holds, as one predicated instruction (no
// branch around it).
__device__ __forceinline__ void wg_arrive_if(unsigned long long* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"((int)pred)
      : "memory");
}

// A barrier of the n threads (a multiple of 32; a warpgroup by default)
// that name barrier id.
__device__ __forceinline__ void named_bar(int id, int n = 128) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void st_u32(unsigned char* p, unsigned v) {
  *reinterpret_cast<unsigned*>(p) = v;
}

__device__ __forceinline__ unsigned ld_u32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// K-major A (h or v, [atom][feature]) of K-step k16: core matrices of 8
// atoms x 8 features, 16 DP bytes between atom groups.
template <int DP> struct KMajor {
  const unsigned char* p;
  __device__ uint64_t operator()(int k16) const { return wg_desc(p + k16 * 256, 128, 16 * DP); }
};

// The epilogues' bf16 pair arithmetic.  rnd(rnd(a0) + b) is one bf16 add
// of the rounded pair and the bias pair, as are the residual adds (the fp32
// sum of two bf16 values, rounded to bf16, is their bf16 sum bit for bit);
// rnd(rnd(a) * scale) one bf16 multiply by the scale, a bf16 value (the
// product of two bf16 values is exact in fp32).
__device__ __forceinline__ __nv_bfloat162 pair(unsigned v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}
__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bias_add(float a0, float a1, const __nv_bfloat16* b) {
  return __hadd2(__floats2bfloat162_rn(a0, a1), *reinterpret_cast<const __nv_bfloat162*>(b));
}

// The accumulator pair (4j + 2h, + 1) of thread (w, g, t) of a warpgroup:
// atom row 16w + g + 8h, features 8j + 2t, + 1.  Its byte offset in a
// K-major [atom][feature] tile (core matrices of 8 atoms x 8 features).
template <int DP>
__device__ __forceinline__ int kmajor_off(int w, int g, int t, int j, int h) {
  return (2 * w + h) * 16 * DP + j * 128 + g * 16 + t * 4;
}

// MN-major A (xa's tile, [feature][atom]) of K-step k16: core matrices of
// 8 features x 8 atoms, 128 bytes apart along the atoms, 1024 along the
// features.
struct MNMajor {
  const unsigned char* p;
  __device__ uint64_t operator()(int k16) const { return wg_desc(p + k16 * 2048, 1024, 128); }
};

}  // namespace
