// Weighted per-molecule pool, forward and backward, for the bin-packed
// layout.
//
// Forward: replaces the TPU kernel aimnet_x2d_tpu/ops/bin_wpool.py::
// _make_wpool_op (fwd_kernel, pallas_call of ``forward``).  It computes
//
//     out[d, b*mb + m] = sum_a  rnd(x[d, b*ab + a] * rnd(w[b*ab + a])) * pm[b, m, a]
//
// where rnd rounds to the compute dtype of x (bf16 or fp32): the weight is
// cast to that dtype and the product is rounded in it, as in the JAX
// package; the sum over atoms accumulates in fp32 and the output is fp32.
// pm is the int8 molecule-membership matrix (nb, mb, ab); any mb is taken.
//
// What bounds it on an H100: it reads x once (D*A elements) and does 2
// operations per element and molecule slot, so it is bound by memory
// traffic.  Design: one block per (bin, 32-row feature tile).  The block
// stages the weighted tile (32 x ab, fp32) and the bin's membership matrix
// (transposed, int8) in shared memory, reading x exactly once with
// coalesced loads; each thread then forms whole output sums from shared
// memory.  Later work: use the one-molecule-per-atom structure of pm to
// skip the zero products.
//
// Backward: replaces the same op's bwd_kernel (pallas_call of
// ``backward_call``, the custom VJP).  From the fp32 cotangent g (D, nb*mb):
//
//     gatom[d, a] = sum_m  rnd(g[d, b*mb + m]) * pm[b, m, a]     (fp32)
//     dx[d, a]    = (T)(gatom[d, a] * w[a])                       (w not rounded)
//     dw[a]       = sum_d  gatom[d, a] * x[d, a]                  (fp32)
//
// with rnd the cast to x's dtype, as in the JAX package.  It is bound by
// memory traffic too (x read, dx written, g read, once each).  Design: one
// block per (bin, 32-row feature tile), one thread per atom column; the
// block stages the tile's rounded g columns and the bin's pm in shared
// memory, and each thread keeps its 32 gatom values in registers, adding
// only the molecule slots whose pm entry is not zero (an atom has one).
// dw: each block writes its tile's per-column partial sum, and a second
// pass adds the tiles' partials in tile order: no atomics, the same bits
// every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // feature rows per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

size_t smem_bytes(int mb, int ab) {
  return (size_t)kRows * ab * sizeof(float) + (size_t)ab * mb;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wpool_kernel(const T* __restrict__ x, const float* __restrict__ w, const int8_t* __restrict__ pm,
             float* __restrict__ out, int D, int A, int nb, int mb, int ab) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xw = reinterpret_cast<float*>(smem);                    // [kRows][ab]
  int8_t* pmT = reinterpret_cast<int8_t*>(xw + (size_t)kRows * ab);  // [ab][mb]
  const int b = blockIdx.x, d0 = blockIdx.y * kRows;
  const size_t col0 = (size_t)b * ab;

  for (int e = threadIdx.x; e < kRows * ab; e += kThreads) {
    const int r = e / ab, a = e % ab;
    float v = 0.0f;
    if (d0 + r < D) v = rnd<T>(to_f(x[(size_t)(d0 + r) * A + col0 + a]) * rnd<T>(w[col0 + a]));
    xw[e] = v;
  }
  const int8_t* pmb = pm + (size_t)b * mb * ab;
  for (int e = threadIdx.x; e < mb * ab; e += kThreads) {
    const int m = e / ab, a = e % ab;
    pmT[(size_t)a * mb + m] = pmb[e];
  }
  __syncthreads();

  const size_t ldo = (size_t)nb * mb;
  for (int o = threadIdx.x; o < kRows * mb; o += kThreads) {
    const int r = o / mb, m = o % mb;
    if (d0 + r >= D) continue;
    const float* xr = xw + (size_t)r * ab;
    float acc = 0.0f;
    for (int a = 0; a < ab; ++a) acc = fmaf(xr[a], (float)pmT[(size_t)a * mb + m], acc);
    out[(size_t)(d0 + r) * ldo + (size_t)b * mb + m] = acc;
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* pm, void* out, int D, int A, int nb, int mb,
           int ab, cudaStream_t stream) {
  const size_t bytes = smem_bytes(mb, ab);
  cudaError_t err = cudaFuncSetAttribute(wpool_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, (D + kRows - 1) / kRows);
  wpool_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const int8_t*>(pm),
      static_cast<float*>(out), D, A, nb, mb, ab);
  return (int)cudaGetLastError();
}

// ---- backward ----

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

size_t bwd_smem_bytes(int mb, int ab) {
  return (size_t)kRows * mb * sizeof(float) + (size_t)mb * ab;
}

// part (D-tiles, A) fp32 gets each tile's dw partial; null skips dw.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wpool_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const int8_t* __restrict__ pm, const float* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ part, int D, int A, int nb, int mb, int ab) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);                         // [kRows][mb]
  int8_t* pms = reinterpret_cast<int8_t*>(gs + (size_t)kRows * mb);   // [mb][ab]
  const int b = blockIdx.x, d0 = blockIdx.y * kRows;
  const int rows = min(kRows, D - d0);
  const size_t ldg = (size_t)nb * mb, col0 = (size_t)b * ab;

  for (int e = threadIdx.x; e < kRows * mb; e += kThreads) {
    const int r = e / mb, m = e % mb;
    gs[e] = r < rows ? rnd<T>(g[(size_t)(d0 + r) * ldg + (size_t)b * mb + m]) : 0.0f;
  }
  const int8_t* pmb = pm + (size_t)b * mb * ab;
  for (int e = threadIdx.x; e < mb * ab; e += kThreads) pms[e] = pmb[e];
  __syncthreads();

  for (int a = threadIdx.x; a < ab; a += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int m = 0; m < mb; ++m) {
      const float p = (float)pms[(size_t)m * ab + a];
      if (p != 0.0f) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(gs[r * mb + m], p, acc[r]);
      }
    }
    const size_t col = col0 + a;
    const float wa = w[col];
    float dwa = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const size_t i = (size_t)(d0 + r) * A + col;
        store(dx + i, acc[r] * wa);
        if (part) dwa = fmaf(acc[r], to_f(x[i]), dwa);
      }
    }
    if (part) part[(size_t)blockIdx.y * A + col] = dwa;
  }
}

__global__ void wpool_dw_reduce(const float* __restrict__ part, float* __restrict__ dw, int A,
                                int tiles) {
  const size_t col = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= (size_t)A) return;
  float s = 0.0f;
  for (int j = 0; j < tiles; ++j) s += part[(size_t)j * A + col];
  dw[col] = s;
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* pm, const void* g, void* dx, void* part,
               void* dw, int D, int A, int nb, int mb, int ab, cudaStream_t stream) {
  const size_t bytes = bwd_smem_bytes(mb, ab);
  cudaError_t err = cudaFuncSetAttribute(wpool_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (D + kRows - 1) / kRows;
  wpool_bwd_kernel<T><<<dim3(nb, tiles), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const int8_t*>(pm),
      static_cast<const float*>(g), static_cast<T*>(dx), static_cast<float*>(part), D, A, nb, mb,
      ab);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return (int)err;
  wpool_dw_reduce<<<(A + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), A, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long wpool_smem_bytes(int mb, int ab) { return (long long)smem_bytes(mb, ab); }

long long wpool_bwd_smem_bytes(int mb, int ab) { return (long long)bwd_smem_bytes(mb, ab); }

// Feature rows per block of the backward: the dw scratch holds
// ceil(D / rows) partial rows of A.
int wpool_bwd_tile_rows() { return kRows; }

// Returns cudaGetLastError() after the launches (0 on success).  part and dw
// are both null (no dw) or both set.
int wpool_bwd(const void* x, const void* w, const void* pm, const void* g, void* dx, void* part,
              void* dw, int bf16, int D, int A, int nb, int mb, int ab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(x, w, pm, g, dx, part, dw, D, A, nb, mb, ab, s)
              : launch_bwd<float>(x, w, pm, g, dx, part, dw, D, A, nb, mb, ab, s);
}

// Returns cudaGetLastError() after the launch (0 on success).
int wpool_fwd(const void* x, const void* w, const void* pm, void* out, int bf16, int D, int A,
              int nb, int mb, int ab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, w, pm, out, D, A, nb, mb, ab, s)
              : launch<float>(x, w, pm, out, D, A, nb, mb, ab, s);
}

const char* wpool_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
