// Weighted per-molecule pool, forward, for the bin-packed layout.
//
// Replaces the TPU kernel aimnet_x2d_tpu/ops/bin_wpool.py::_make_wpool_op
// (fwd_kernel, pallas_call of ``forward``).  It computes
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

}  // namespace

extern "C" {

long long wpool_smem_bytes(int mb, int ab) { return (long long)smem_bytes(mb, ab); }

// Returns cudaGetLastError() after the launch (0 on success).
int wpool_fwd(const void* x, const void* w, const void* pm, void* out, int bf16, int D, int A,
              int nb, int mb, int ab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, w, pm, out, D, A, nb, mb, ab, s)
              : launch<float>(x, w, pm, out, D, A, nb, mb, ab, s);
}

const char* wpool_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
