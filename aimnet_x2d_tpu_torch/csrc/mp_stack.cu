// Fused message-passing stack, forward, for the bin-packed layout.
//
// Replaces the TPU kernel aimnet_x2d_tpu/ops/bin_mp.py::_make_stack_op
// (fwd_kernel, pallas_call of ``forward``) with residual=True, proj=False,
// dropout=0.  For every 256-atom bin and every layer it computes, in the
// feature-major layout (features on rows, the bin's atoms on columns):
//
//     agg = x adj^T                      per bin, int8 multiplicities
//     t   = W_in [x; agg] + b_in ;  h = act(t)
//     s   = W_s  [x; agg] + b_s
//     n_blocks x:  h = (W2 act(W1 h + b1) + b2) + h
//     x   = (h + s) + x
//
// with the cast points of the JAX package: every product accumulates in
// fp32, is rounded to the compute dtype, and the bias add, the activation
// and every residual add round to the compute dtype again.  Weights arrive
// prepped by the wrapper (ops/bin_mp.py::prep_layer): [W0;W1]^T stacked as
// (Dp, 2Dp), biases as columns, cast to the compute dtype once, with D padded
// to Dp (a multiple of 16) by zero rows and columns.  Padded feature rows of
// x stay exactly zero through every layer, so they never reach the output.
//
// What bounds it on an H100: at the serving shape (D = 153, ab = 256,
// 3 layers, 2 blocks) a bin needs ~350 MFLOP against ~220 KB of traffic, so
// it is bound by tensor-core throughput, not by memory.  Only the
// aggregation mixes atoms, and only inside a bin, but layer l+1's
// aggregation needs all of layer l's output for the bin.
//
// Design: one thread block per bin loops over the layers, so a bin's
// activations never leave the SM between layers.  In bf16 the bin's x and
// agg (Dp x 264 each, 82.5 KB) live in shared memory; when they do not fit
// (fp32, or a wider model) they live in global scratch that stays in L2.
// The aggregation for the whole bin is computed first (its input is the
// unmodified x); the post-aggregation chain then runs on 64-atom column
// tiles, which only read and write their own columns of x, so x is updated
// in place.  bf16 products run on the tensor cores through wmma (16x16x16,
// fp32 accumulators); fp32 products run on the CUDA cores in full fp32.
// Each output fragment's epilogue (cast, bias, activation, residual) is
// applied by its warp from a 1 KB staging tile, with the layer's biases
// copied to shared memory once per layer.  The weights stay in global
// memory: all blocks read the same ~0.4 MB per layer, so they hit L2, but
// the SM keeps only ~30 KB of L1 beside the block's shared memory, so each
// 64-atom tile reads them from L2 again.  The bf16 weights therefore come
// tile-major (each 16 x 16 fragment 512 contiguous bytes, no partial
// sectors), and each warp keeps its next kAhead weight fragments in flight.
// The adjacency, x and the output move in 16-byte vectors.  Not yet done
// (later work): wgmma/TMA, weight tiles in shared memory, and more than
// one bin in flight per SM (one 218 KB block per SM, so 160 bins take two
// waves on 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

// 10 warps: one 16-row strip each at the flagship width (Dp = 160), so no
// warp waits on another's second strip.  The fp32 products use 256 of them.
constexpr int kThreads = 320;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;           // atoms per post-aggregation column tile
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

// C (M x kTile) = A (M x K) * B (K x kTile), where rows k < ksplit of B
// come from B0 and the rest from B1 (row stride ldb).  A is row-major with
// row stride lda, or, when a_tiled, tile-major: its 16 x 16 tiles stored
// one after another (row of tiles by row of tiles), each 512 contiguous
// bytes, as the wrapper lays out the bf16 weights so that a warp's fragment
// load reads whole sectors.  M, K and ksplit are multiples of 16.  Calls
// epi(row, col, acc) once per element of C.  bf16: tensor cores; each warp
// owns 16-row strips.
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

template <typename T>
size_t smem_bytes(int Dp, int ab, int n_blocks, int global_mode) {
  size_t b = (size_t)kWarps * 256 * sizeof(float);                      // epilogue staging
  if (!global_mode) b += 2 * (size_t)Dp * (ab + 8) * sizeof(T);           // x, agg
  const int rows = ab > 2 * Dp ? ab : 2 * Dp;
  b += (size_t)rows * kLdT * sizeof(T);  // adj^T chunk, or the h and v tiles
  b += (size_t)(2 + 2 * n_blocks) * Dp * sizeof(T);  // the layer's biases
  return b;
}

// One block per bin.  x_in (D, A) and out are feature-major with A = nb*ab
// columns.  global_mode: out is (Dp, A) and also holds the bin's x while
// the block works; agg_g is a (Dp, A) scratch.  Otherwise x and agg live
// in shared memory and out is (D, A).
template <typename T>
__global__ void __launch_bounds__(kThreads)
mp_stack_kernel(const T* __restrict__ x_in, T* out, T* agg_g, const int8_t* __restrict__ adj,
                const T* __restrict__ w, int D, int Dp, int A, int ab, int n_layers,
                int n_blocks, int act, int global_mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bin = blockIdx.x;
  const size_t col0 = (size_t)bin * ab;
  unsigned char* p = smem;
  float* stage = reinterpret_cast<float*>(p);
  p += (size_t)kWarps * 256 * sizeof(float);
  T* xb;
  T* ag;
  int ld;
  if (global_mode) {
    xb = out + col0;
    ag = agg_g + col0;
    ld = A;
  } else {
    ld = ab + 8;
    xb = reinterpret_cast<T*>(p);
    p += (size_t)Dp * ld * sizeof(T);
    ag = reinterpret_cast<T*>(p);
    p += (size_t)Dp * ld * sizeof(T);
  }
  T* scratch = reinterpret_cast<T*>(p);  // adj^T chunk during aggregation
  T* hbuf = scratch;                     // then the h and v column tiles
  T* vbuf = scratch + (size_t)Dp * kLdT;
  const int rows = ab > 2 * Dp ? ab : 2 * Dp;
  // b_in, b_s, then b1, b2 of each block: read by every epilogue element
  T* bias = scratch + (size_t)rows * kLdT;

  // 16-byte loads and stores (ab, A and the row strides are multiples of 8)
  constexpr int V = 16 / sizeof(T);
  for (int e = threadIdx.x; e < Dp * ab / V; e += kThreads) {
    const int r = e / (ab / V), c = e % (ab / V) * V;
    int4 v = make_int4(0, 0, 0, 0);  // padded rows: +0.0
    if (r < D) v = *reinterpret_cast<const int4*>(x_in + (size_t)r * A + col0 + c);
    *reinterpret_cast<int4*>(xb + (size_t)r * ld + c) = v;
  }
  __syncthreads();

  const int K2 = 2 * Dp;
  const bool tiled = sizeof(T) == 2;  // bf16 weight matrices are tile-major
  const size_t mat2 = (size_t)Dp * K2, mat1 = (size_t)Dp * Dp;
  const size_t block_sz = 2 * mat1 + 2 * (size_t)Dp;
  const size_t layer_sz = 2 * mat2 + 2 * (size_t)Dp + (size_t)n_blocks * block_sz;
  const int8_t* adj_b = adj + (size_t)bin * ab * ab;
  const T* b_in = bias;
  const T* b_s = bias + Dp;

  for (int l = 0; l < n_layers; ++l) {
    const T* w_in = w + (size_t)l * layer_sz;
    const T* w_s = w_in + mat2 + Dp;
    const T* blocks = w_s + mat2 + Dp;

    // biases to shared memory (the aggregation's first barrier publishes them)
    for (int e = threadIdx.x; e < (2 + 2 * n_blocks) * Dp; e += kThreads) {
      const int seg = e / Dp, r = e % Dp;
      const T* blk = blocks + (size_t)(seg / 2 - 1) * block_sz;  // used for seg >= 2
      const T* src = seg == 0 ? w_in + mat2
                   : seg == 1 ? w_s + mat2
                   : blk + (seg % 2 ? 2 * mat1 + Dp : mat1);
      bias[e] = src[r];
    }

    // agg[:, i] = sum_j x[:, j] adj[i, j], one 64-atom chunk of i at a time
    for (int c0 = 0; c0 < ab; c0 += kTile) {
      for (int e = threadIdx.x; e < kTile * ab / 16; e += kThreads) {  // 16 per load
        const int il = e / (ab / 16), j0 = e % (ab / 16) * 16;
        const int4 v = *reinterpret_cast<const int4*>(adj_b + (size_t)(c0 + il) * ab + j0);
        const int8_t* m = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int t = 0; t < 16; ++t) scratch[(size_t)(j0 + t) * kLdT + il] = from_f<T>((float)m[t]);
      }
      __syncthreads();
      gemm_tile(xb, ld, false, Dp, ab, scratch, scratch, kLdT, ab, stage,
                [&](int r, int c, float v) { ag[(size_t)r * ld + c0 + c] = from_f<T>(v); });
      __syncthreads();
    }

    for (int c0 = 0; c0 < ab; c0 += kTile) {
      const T* bx = xb + c0;
      const T* ba = ag + c0;
      gemm_tile(w_in, K2, tiled, Dp, K2, bx, ba, ld, Dp, stage, [&](int r, int c, float v) {
        const float t = rnd<T>(rnd<T>(v) + to_f(b_in[r]));
        hbuf[r * kLdT + c] = from_f<T>(act_fn(act, t));
      });
      __syncthreads();
      for (int i = 0; i < n_blocks; ++i) {
        const T* w1 = blocks + (size_t)i * block_sz;
        const T* w2 = w1 + mat1 + Dp;
        const T* b1 = bias + (2 + 2 * i) * Dp;
        const T* b2 = b1 + Dp;
        gemm_tile(w1, Dp, tiled, Dp, Dp, hbuf, hbuf, kLdT, Dp, stage, [&](int r, int c, float v) {
          const float u = rnd<T>(rnd<T>(v) + to_f(b1[r]));
          vbuf[r * kLdT + c] = from_f<T>(act_fn(act, u));
        });
        __syncthreads();
        gemm_tile(w2, Dp, tiled, Dp, Dp, vbuf, vbuf, kLdT, Dp, stage, [&](int r, int c, float v) {
          const float y = rnd<T>(rnd<T>(v) + to_f(b2[r]));
          hbuf[r * kLdT + c] = from_f<T>(y + to_f(hbuf[r * kLdT + c]));
        });
        __syncthreads();
      }
      // skip projection; (h + s) goes to v, since this product still reads x
      gemm_tile(w_s, K2, tiled, Dp, K2, bx, ba, ld, Dp, stage, [&](int r, int c, float v) {
        const float s = rnd<T>(rnd<T>(v) + to_f(b_s[r]));
        vbuf[r * kLdT + c] = from_f<T>(to_f(hbuf[r * kLdT + c]) + s);
      });
      __syncthreads();
      for (int e = threadIdx.x; e < Dp * kTile; e += kThreads) {
        const int r = e / kTile, c = e % kTile;
        T* px = xb + (size_t)r * ld + c0 + c;
        *px = from_f<T>(to_f(vbuf[r * kLdT + c]) + to_f(*px));
      }
      __syncthreads();
    }
  }

  if (!global_mode) {
    for (int e = threadIdx.x; e < D * ab / V; e += kThreads) {
      const int r = e / (ab / V), c = e % (ab / V) * V;
      *reinterpret_cast<int4*>(out + (size_t)r * A + col0 + c) =
          *reinterpret_cast<const int4*>(xb + (size_t)r * ld + c);
    }
  }
}

template <typename T>
int launch(const void* x, void* out, void* agg, const void* adj, const void* w, int D, int Dp,
           int A, int nb, int ab, int n_layers, int n_blocks, int act, int global_mode,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>(Dp, ab, n_blocks, global_mode);
  if (bytes > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mp_stack_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  mp_stack_kernel<T><<<nb, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(agg),
      static_cast<const int8_t*>(adj), static_cast<const T*>(w), D, Dp, A, ab, n_layers,
      n_blocks, act, global_mode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; the wrapper takes global_mode = 1 when
// the shared-memory layout would exceed what a block may use.
long long mp_stack_smem_bytes(int bf16, int Dp, int ab, int n_blocks, int global_mode) {
  return bf16 ? (long long)smem_bytes<__nv_bfloat16>(Dp, ab, n_blocks, global_mode)
              : (long long)smem_bytes<float>(Dp, ab, n_blocks, global_mode);
}

long long mp_stack_smem_limit() { return kSmemLimit; }

// Returns cudaGetLastError() after the launch (0 on success).
int mp_stack_fwd(const void* x, void* out, void* agg, const void* adj, const void* w, int bf16,
                 int D, int Dp, int A, int nb, int ab, int n_layers, int n_blocks, int act,
                 int global_mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, out, agg, adj, w, D, Dp, A, nb, ab, n_layers, n_blocks,
                                      act, global_mode, s)
              : launch<float>(x, out, agg, adj, w, D, Dp, A, nb, ab, n_layers, n_blocks, act,
                              global_mode, s);
}

const char* mp_stack_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
