// Weight-gradient contraction over the atom axis, shared by the backward
// kernels of the stack (csrc/mp_stack_bwd.cu) and the attention pool
// (csrc/attnpool.cu):
//
//     part[c] = [ dY[:, chunk c] X[:, chunk c]^T  (M x N),  rowsum(bias_src or dY) (M) ]
//
// dY (M, A) and X (N, A) in the compute dtype, feature-major with row
// stride A; bias_src, when given, is an fp32 (M, A) array.  Each block
// contracts one 16 x 64 output tile over one chunk of atoms and writes its
// fp32 partial; sum_partials then adds the chunks in a fixed order, so the
// gradients are the same from run to run (no atomics).  bf16 products run
// on the tensor cores (wmma, fp32 accumulators) with fragments loaded
// straight from global memory; fp32 runs on the CUDA cores through shared
// memory tiles.  M and N are multiples of 16, A of 16.
//
// The embedding fold's d_kb (wgrad_vocab) is the same contraction with X
// the embeddings looked up from the code rows and the table
// (csrc/vocab.cuh): each warp gathers its 16 x 16 fragment of X into shared
// memory (bf16) or the block its 64 x 32 tile (fp32), so the (E, A) array
// is never formed; the sums are the same as over the looked-up array.
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

__global__ void __launch_bounds__(kWgThreads)
wgrad_kernel_bf16(const __nv_bfloat16* __restrict__ dY, const __nv_bfloat16* __restrict__ X,
                  const float* __restrict__ bsrc, float* __restrict__ part, int M, int N, int A,
                  int chunk) {
  const int warp = threadIdx.x / 32;
  const int m0 = blockIdx.x * 16, n0 = blockIdx.y * 64 + warp * 16;
  const int a0 = blockIdx.z * chunk, a1 = min(A, a0 + chunk);
  float* P = part + (size_t)blockIdx.z * ((size_t)M * N + M);
  if (n0 < N) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    const __nv_bfloat16* pa = dY + (size_t)m0 * A;
    const __nv_bfloat16* pb = X + (size_t)n0 * A;
    for (int a = a0; a < a1; a += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, pa + a, A);
      wmma::load_matrix_sync(fb, pb + a, A);  // (a, n) at X[n * A + a]
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(P + (size_t)m0 * N + n0, acc, N, wmma::mem_row_major);
  }
  if (blockIdx.y == 0) wgrad_bias(dY, bsrc, P + (size_t)M * N, m0, A, a0, a1);
}

// X[n, a] of a row-major (N, A) array
struct DenseX {
  const float* X;
  __device__ float operator()(int n, size_t a, int A) const { return X[(size_t)n * A + a]; }
};

// X[n, a] looked up from the code rows and the table (the embedding fold)
template <typename T>
struct VocabX {
  const int* codes;
  const T* bd;
  Vocab voc;
  __device__ float operator()(int n, size_t a, int A) const {
    return to_f(vocab_emb(codes, bd, voc, n, a, A));
  }
};

// One block's 16 x 64 output tile (rows m0.., columns n0..) over atoms
// [a0, a1), fp32 on the CUDA cores through shared-memory tiles, written to
// the partial P (row-major M x N).  Shared by wgrad_kernel_f32 and the
// grouped contraction (csrc/wgrad_group.cuh).
template <class XL>
__device__ void wgrad_tile_f32(const float* __restrict__ dY, XL X, float* __restrict__ P, int M,
                               int N, int A, int m0, int n0, int a0, int a1) {
  __shared__ float ys[16][33];
  __shared__ float xs[64][33];
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

template <class XL>
__global__ void __launch_bounds__(kWgThreads)
wgrad_kernel_f32(const float* __restrict__ dY, XL X, const float* __restrict__ bsrc,
                 float* __restrict__ part, int M, int N, int A, int chunk) {
  const int m0 = blockIdx.x * 16, n0 = blockIdx.y * 64;
  const int a0 = blockIdx.z * chunk, a1 = min(A, a0 + chunk);
  float* P = part + (size_t)blockIdx.z * ((size_t)M * N + M);
  wgrad_tile_f32(dY, X, P, M, N, A, m0, n0, a0, a1);
  if (blockIdx.y == 0) wgrad_bias(dY, bsrc, P + (size_t)M * N, m0, A, a0, a1);
}

// wgrad_kernel_bf16 with X looked up: each warp gathers its fragment
__global__ void __launch_bounds__(kWgThreads)
wgrad_vocab_kernel_bf16(const __nv_bfloat16* __restrict__ dY, VocabX<__nv_bfloat16> X,
                        const float* __restrict__ bsrc, float* __restrict__ part, int M, int N,
                        int A, int chunk) {
  __shared__ __align__(32) __nv_bfloat16 xs[kWgThreads / 32][16 * 16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * 16, n0 = blockIdx.y * 64 + warp * 16;
  const int a0 = blockIdx.z * chunk, a1 = min(A, a0 + chunk);
  float* P = part + (size_t)blockIdx.z * ((size_t)M * N + M);
  if (n0 < N) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    const __nv_bfloat16* pa = dY + (size_t)m0 * A;
    __nv_bfloat16* xw = xs[warp];
    for (int a = a0; a < a1; a += 16) {
      for (int i = lane; i < 256; i += 32)  // (a, n) at xw[n * 16 + a]: col-major, ld 16
        xw[i] = vocab_emb(X.codes, X.bd, X.voc, n0 + i / 16, (size_t)a + i % 16, A);
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, pa + a, A);
      wmma::load_matrix_sync(fb, xw, 16);
      wmma::mma_sync(acc, fa, fb, acc);
      __syncwarp();
    }
    wmma::store_matrix_sync(P + (size_t)m0 * N + n0, acc, N, wmma::mem_row_major);
  }
  if (blockIdx.y == 0) wgrad_bias(dY, bsrc, P + (size_t)M * N, m0, A, a0, a1);
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

int launch_wgrad(const void* dY, const void* X, const void* bsrc, void* part, int bf16, int M,
                 int N, int A, int chunk, cudaStream_t s) {
  if (M % 16 || N % 16 || A % 16 || chunk % 32 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(M / 16, (N + 63) / 64, (A + chunk - 1) / chunk);
  if (bf16)
    wgrad_kernel_bf16<<<grid, kWgThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dY), static_cast<const __nv_bfloat16*>(X),
        static_cast<const float*>(bsrc), static_cast<float*>(part), M, N, A, chunk);
  else
    wgrad_kernel_f32<<<grid, kWgThreads, 0, s>>>(
        static_cast<const float*>(dY), DenseX{static_cast<const float*>(X)},
        static_cast<const float*>(bsrc), static_cast<float*>(part), M, N, A, chunk);
  return (int)cudaGetLastError();
}

// wgrad with X (N = E rows) looked up from codes and the table bd
int launch_wgrad_vocab(const void* dY, const void* codes, const void* bd, const Vocab& voc,
                       const void* bsrc, void* part, int bf16, int M, int N, int A, int chunk,
                       cudaStream_t s) {
  if (M % 16 || N % 16 || A % 16 || chunk % 32 || chunk <= 0 || N != voc.F * voc.Df)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(M / 16, (N + 63) / 64, (A + chunk - 1) / chunk);
  const int* c = static_cast<const int*>(codes);
  if (bf16)
    wgrad_vocab_kernel_bf16<<<grid, kWgThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dY),
        VocabX<__nv_bfloat16>{c, static_cast<const __nv_bfloat16*>(bd), voc},
        static_cast<const float*>(bsrc), static_cast<float*>(part), M, N, A, chunk);
  else
    wgrad_kernel_f32<<<grid, kWgThreads, 0, s>>>(
        static_cast<const float*>(dY), VocabX<float>{c, static_cast<const float*>(bd), voc},
        static_cast<const float*>(bsrc), static_cast<float*>(part), M, N, A, chunk);
  return (int)cudaGetLastError();
}

int launch_sum_partials(const void* part, void* out, int n, long long size, cudaStream_t s) {
  const long long blocks = size / 256 + 1;
  sum_partials_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, size);
  return (int)cudaGetLastError();
}

}  // namespace
