// Device helpers shared by the port's kernels: dtype conversions, the
// activations and their derivatives, the dropout hash, a warp sum, and the
// tile product the stack, attention-pool and inject kernels are built from.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

// 10 warps: one 16-row strip each at the flagship width (Dp = 160), so no
// warp waits on another's second strip.  The fp32 products use 256 of them.
constexpr int kThreads = 320;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;           // atoms per column tile
constexpr int kLdT = kTile + 8;     // padded row stride of the tile buffers
constexpr int kAhead = 4;           // weight fragments a warp keeps in flight
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round to the compute dtype (identity in fp32).
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// Activation codes: utils/activation.py ACTIVATION_CODES.
__device__ __forceinline__ float act_fn(int act, float u) {
  switch (act) {
    case 0: return u / (1.0f + expf(-u));
    case 1: return fmaxf(u, 0.0f);
    case 2: return u >= 0.0f ? u : 0.01f * u;
    case 3: return u > 0.0f ? u : expm1f(u);
    default: return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
  }
}

// Derivative in fp32 (utils/activation.py activation_grad); callers round.
__device__ __forceinline__ float act_grad(int act, float u) {
  switch (act) {
    case 0: {  // the correctly rounded reciprocal: 1 / x to the bit, without a division
      const float s = __frcp_rn(1.0f + expf(-u));
      return s * (1.0f + u * (1.0f - s));
    }
    case 1: return u > 0.0f ? 1.0f : 0.0f;
    case 2: return u >= 0.0f ? 1.0f : 0.01f;
    case 3: return u > 0.0f ? 1.0f : expf(u);
    default:
      return 0.5f * (1.0f + erff(u * 0.70710678118654752f)) +
             u * 0.3989422804014327f * expf(-0.5f * u * u);
  }
}

// In-kernel dropout: keep iff the murmur3 fmix32 hash of (feature row i,
// global atom column j, mix = seed + tag * 0x9E3779B9) is at least thresh =
// floor(rate * 2^32) -- bit-equal to the JAX package's _dropout_mask.
__device__ __forceinline__ bool drop_keep(unsigned i, unsigned j, unsigned mix, unsigned thresh) {
  unsigned x = (i * 0x85EBCA6Bu) ^ (j * 0xC2B2AE35u) ^ mix;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

// Sum over the 32 lanes of a warp, in a fixed order; every lane gets it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// C (M x kTile) = A (M x K) * B (K x kTile), where rows k < ksplit of B
// come from B0 and the rest from B1 (row stride ldb).  A is row-major with
// row stride lda, or, when a_tiled, tile-major: its 16 x 16 tiles stored
// one after another (row of tiles by row of tiles), each 512 contiguous
// bytes, as the wrapper lays out the bf16 weights so that a warp's fragment
// load reads whole sectors.  M, K and ksplit are multiples of 16.  Pointers
// may be shared or global memory.  Calls epi(row, col, acc) once per
// element of C.  bf16: tensor cores; each warp owns 16-row strips.
template <class Epi>
__device__ void gemm_tile(const __nv_bfloat16* A, int lda, bool a_tiled, int M, int K,
                          const __nv_bfloat16* B0, const __nv_bfloat16* B1, int ldb,
                          int ksplit, float* stage, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = stage + warp * 256;
  for (int m0 = warp * 16; m0 < M; m0 += kWarps * 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTile / 16];
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
    // A may be a weight matrix in global memory (L2): keep the fragments of
    // the next kAhead k-steps in flight, to overlap their latency
    const __nv_bfloat16* arow = A + (size_t)m0 * (a_tiled ? K : lda);
    const int a_step = a_tiled ? 256 : 16, a_ld = a_tiled ? 16 : lda;
    const int nk = K / 16;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[kAhead];
#pragma unroll
    for (int s = 0; s < kAhead; ++s)
      if (s < nk) wmma::load_matrix_sync(a[s], arow + a_step * s, a_ld);
    for (int k0 = 0; k0 < nk; k0 += kAhead) {
#pragma unroll
      for (int s = 0; s < kAhead; ++s) {
        const int k = k0 + s;
        if (k < nk) {
          const __nv_bfloat16* brow =
              16 * k < ksplit ? B0 + (size_t)16 * k * ldb : B1 + (size_t)(16 * k - ksplit) * ldb;
#pragma unroll
          for (int j = 0; j < kTile / 16; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(b, brow + j * 16, ldb);
            wmma::mma_sync(acc[j], a[s], b, acc[j]);
          }
          if (k + kAhead < nk) wmma::load_matrix_sync(a[s], arow + a_step * (k + kAhead), a_ld);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = lane + 32 * i;
        epi(m0 + e / 16, j * 16 + e % 16, st[e]);
      }
      __syncwarp();
    }
  }
}

// fp32: full-precision FMA on the CUDA cores, A row-major (fp32 weights are
// not tiled).  256 threads as 16 x 16 (the rest idle); each thread owns a
// 4 x 4 block of C per 64-row pass.
template <class Epi>
__device__ void gemm_tile(const float* A, int lda, bool /*a_tiled*/, int M, int K, const float* B0,
                          const float* B1, int ldb, int ksplit, float* /*stage*/, Epi epi) {
  if (threadIdx.x >= 256) return;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int m0 = 0; m0 < M; m0 += 64) {
    float acc[4][4];
    int rows[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rows[i] = min(m0 + ty * 4 + i, M - 1);  // clamped reads; writes guarded below
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    }
    // unrolled so that the loads of several k-steps are in flight together
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float* brow = k < ksplit ? B0 + (size_t)k * ldb : B1 + (size_t)(k - ksplit) * ldb;
      const float4 b = *reinterpret_cast<const float4*>(brow + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = A[(size_t)rows[i] * lda + k];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty * 4 + i;
      if (r < M) {
#pragma unroll
        for (int j = 0; j < 4; ++j) epi(r, tx * 4 + j, acc[i][j]);
      }
    }
  }
}

// A bf16 gemm_tile epilogue, clocked for the marks builds: gemm_tile calls
// it for each 16-row strip first at (m0, 0) and last at (m0 + 14, kTile -
// 16) in lane 0, so lane 0 of each warp adds the clocks from the strip's
// start (the product's, or the last strip's end) to its first element to
// clk[0] (the products, the strip's first staging store with them), and
// those to its last element to clk[1] (the epilogue); clk is in shared
// memory.  fp32 products are not clocked.
template <typename T, class Epi>
__device__ __forceinline__ auto clocked(unsigned long long* clk, Epi epi) {
  if constexpr (sizeof(T) != 2) return epi;
  else return [epi, clk, t0 = clock64(), t1 = 0ll](int r, int c, float v) mutable {
    const bool lead = (threadIdx.x & 31) == 0;
    if (lead && c == 0 && r % 16 == 0) t1 = clock64();
    epi(r, c, v);
    if (lead && c == kTile - 16 && r % 16 == 14) {
      const long long t2 = clock64();
      atomicAdd(&clk[0], (unsigned long long)(t1 - t0));
      atomicAdd(&clk[1], (unsigned long long)(t2 - t1));
      t0 = t2;
    }
  };
}

}  // namespace
