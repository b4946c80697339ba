// The fixed-order pieces of the weight-gradient contraction over the atom
// axis (csrc/wgrad_group.cuh contracts the backward kernels' products):
//
//     part[c] = [ dY[:, chunk c] X[:, chunk c]^T  (M x N),  rowsum(bias_src or dY) (M) ]
//
// dY (M, A) and X (N, A) feature-major with row stride A; bias_src, when
// given, an fp32 (M, A) array.  Here: the fp32 output tile on the CUDA
// cores (16 x 64 outputs a block over one chunk of atoms, through shared
// memory, X read by a loader functor), the bias row sums, and sum_partials,
// which adds the chunks' partials in a fixed order, so the gradients are the
// same from run to run (no atomics).
#pragma once

#include "common.cuh"
#include "vocab.cuh"

namespace {

constexpr int kWgThreads = 128;  // 4 warps, one 16 x 16 output fragment each

template <typename T>
__device__ void wgrad_bias(const T* dY, const float* bsrc, float* out, int m0, int A, int a0,
                           int a1) {
  // 8 threads per row, interleaved over the chunk, then a fixed-order shuffle sum
  const int row = threadIdx.x / 8, part = threadIdx.x % 8;
  const size_t base = (size_t)(m0 + row) * A;
  float s = 0.0f;
  for (int a = a0 + part; a < a1; a += 8) s += bsrc ? bsrc[base + a] : to_f(dY[base + a]);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  if (part == 0) out[m0 + row] = s;
}

// X[n, a] of a row-major (N, A) array
struct DenseX {
  const float* X;
  __device__ float operator()(int n, size_t a, int A) const { return X[(size_t)n * A + a]; }
};

// X[n, a] looked up from the code rows and the table (the embedding fold)
struct VocabX {
  const int* codes;
  const float* bd;
  Vocab voc;
  __device__ float operator()(int n, size_t a, int A) const {
    return vocab_emb(codes, bd, voc, n, a, A);
  }
};

// The shared tiles of wgrad_tile_f32, declared by its kernel (one copy for
// every loader the kernel instantiates it with)
struct WgTilesF32 {
  float ys[16][33];
  float xs[64][33];
};

// One block's 16 x 64 output tile (rows m0.., columns n0..) over atoms
// [a0, a1), fp32 on the CUDA cores through the shared tiles sh, written to
// the partial P (row-major M x N), for the grouped contraction's fp32 form
// (csrc/wgrad_group.cuh).
template <class XL>
__device__ void wgrad_tile_f32(const float* __restrict__ dY, XL X, float* __restrict__ P, int M,
                               int N, int A, int m0, int n0, int a0, int a1,
                               WgTilesF32& sh) {
  float (&ys)[16][33] = sh.ys;
  float (&xs)[64][33] = sh.xs;
  const int tn = threadIdx.x % 64, tm = threadIdx.x / 64;  // 8 rows each: tm*8 .. tm*8+7
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  for (int a = a0; a < a1; a += 32) {
    for (int e = threadIdx.x; e < 16 * 32; e += kWgThreads) {
      const int r = e / 32, k = e % 32;
      ys[r][k] = a + k < a1 ? dY[(size_t)(m0 + r) * A + a + k] : 0.0f;
    }
    for (int e = threadIdx.x; e < 64 * 32; e += kWgThreads) {
      const int r = e / 32, k = e % 32;
      xs[r][k] = (n0 + r < N && a + k < a1) ? X(n0 + r, (size_t)a + k, A) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      const float xv = xs[tn][k];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(ys[tm * 8 + i][k], xv, acc[i]);
    }
    __syncthreads();
  }
  if (n0 + tn < N) {
#pragma unroll
    for (int i = 0; i < 8; ++i) P[(size_t)(m0 + tm * 8 + i) * N + n0 + tn] = acc[i];
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int n,
                                    long long size) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int c = 0; c < n; ++c) s += part[(size_t)c * size + i];
    out[i] = s;
  }
}

int launch_sum_partials(const void* part, void* out, int n, long long size, cudaStream_t s) {
  const long long blocks = size / 256 + 1;
  sum_partials_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, size);
  return (int)cudaGetLastError();
}

}  // namespace
