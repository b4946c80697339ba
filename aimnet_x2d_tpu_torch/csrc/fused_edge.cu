// Edge aggregation of the flat (non-binned) layout, and the windowed segment
// sum.
//
// Kernel 7 (edge_agg): replaces the TPU kernel aimnet_x2d_tpu/ops/
// fused_edge.py::_kernel (pallas_call in ``_run``), forward and backward.
// It computes
//
//     out[a, :] = sum over the CSR row a of rnd(x[col[e], :])      (fp32)
//
// where the row's entries are the real edges whose destination is a
// (forward: col = source) or, on the transposed layout, whose source is a
// (backward: col = destination, x = the cotangent).  rnd rounds a value to
// bf16 when ``round_bf16`` is set (bf16 models: the forward's x is bf16
// already, the backward's fp32 cotangent is rounded here, as the TPU kernel
// rounds its operand at default precision) and is the identity otherwise.
//
// What bounds it on an H100: it moves x once, the output once and the CSR
// once (bytes), but reads a source row per edge, E*D values, mostly from
// L2 (x of a 2048-molecule batch is ~12-25 MB, inside the 50 MB L2).  The
// TPU layout (256-atom destination windows, one contiguous source block per
// window, one-hot MXU products) exists because the TPU's row gather is slow;
// the card gathers rows directly.  Design: one warp per destination row; the
// lanes stride over the D columns (lane + 32 j), each lane keeping its
// columns' fp32 sums in registers, and the warp loads 32 column indices at a
// time and broadcasts them with shuffles.  Each row is written once, by one
// warp, summing its edges in CSR order: no atomics, the same bits every run.
// Rows with no edges (and padding atoms) are written as zeros.  Loads are
// one element a lane: the flagship widths (153, 359) are odd, so in bf16 a
// source row starts 4-byte aligned only every other row.
//
// Kernel 8 (wseg_sum): replaces aimnet_x2d_tpu/ops/pallas_segment.py::
// _segment_kernel.  With ``data`` (W*cap, D) fp32 gathered by the caller
// and ``seg`` (W*cap,) the window-local destination of each slot (``window``
// for padding slots, which are dropped):
//
//     out[w*window + s, :] = sum over slots i of window w with seg[i] == s of rnd(data[i, :])
//
// It is bound by memory traffic (data read once, the output written once).
// Design: one block per (window, 64-column tile), the window's fp32 sums for
// the tile in shared memory (window x 64 x 4 bytes, 64 KB at window 256).
// Thread t owns column t % 64 of the output rows s with s % 4 == t / 64, and
// walks the window's slots in order, so every output element is summed by
// one thread in slot order: no atomics, the same bits every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kCols = 8;  // columns per lane per pass: 256 columns a pass
constexpr int kSegThreads = 256;
constexpr int kSegTile = 64;  // output columns per block
constexpr int kSegGroups = kSegThreads / kSegTile;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float rnd_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
edge_agg_kernel(const T* __restrict__ x, const int* __restrict__ row_ptr,
                const int* __restrict__ col, float* __restrict__ out, int A, int D,
                int round_bf16) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a = blockIdx.x * kWarpsPerBlock + warp;
  if (a >= A) return;
  const int e_begin = row_ptr[a], e_end = row_ptr[a + 1];
  float* orow = out + (size_t)a * D;
  for (int c0 = 0; c0 < D; c0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
    for (int e0 = e_begin; e0 < e_end; e0 += 32) {
      const int mine = e0 + lane < e_end ? col[e0 + lane] : 0;
      const int n = min(32, e_end - e0);
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const int s = __shfl_sync(0xffffffffu, mine, k);
        const T* xrow = x + (size_t)s * D;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < D) {
            float v = to_f(xrow[c]);
            if (round_bf16) v = rnd_bf16(v);
            acc[j] += v;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < D) orow[c] = acc[j];
    }
  }
}

__global__ void __launch_bounds__(kSegThreads)
wseg_sum_kernel(const float* __restrict__ data, const int* __restrict__ seg,
                float* __restrict__ out, int D, int window, int cap, int round_bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);          // [window][kSegTile]
  int* segs = reinterpret_cast<int*>(acc + (size_t)window * kSegTile);  // [kSegThreads]
  const int w = blockIdx.x, c0 = blockIdx.y * kSegTile;
  const int tc = threadIdx.x % kSegTile, grp = threadIdx.x / kSegTile;
  const int c = c0 + tc;
  for (int i = threadIdx.x; i < window * kSegTile; i += kSegThreads) acc[i] = 0.0f;
  const size_t slot0 = (size_t)w * cap;
  for (int i0 = 0; i0 < cap; i0 += kSegThreads) {
    __syncthreads();  // the accumulators are zeroed / the previous chunk's ids are used
    const int n = min(kSegThreads, cap - i0);
    if (threadIdx.x < n) segs[threadIdx.x] = seg[slot0 + i0 + threadIdx.x];
    __syncthreads();
    if (c < D) {
      for (int k = 0; k < n; ++k) {
        const int s = segs[k];
        if (s < window && s % kSegGroups == grp) {
          float v = data[(slot0 + i0 + k) * D + c];
          if (round_bf16) v = rnd_bf16(v);
          acc[(size_t)s * kSegTile + tc] += v;
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < window * kSegTile; i += kSegThreads) {
    const int s = i / kSegTile, cc = c0 + i % kSegTile;
    if (cc < D) out[((size_t)w * window + s) * D + cc] = acc[i];
  }
}

size_t wseg_smem_bytes(int window) {
  return (size_t)window * kSegTile * sizeof(float) + kSegThreads * sizeof(int);
}

}  // namespace

extern "C" {

// out (A, D) fp32; x (A_src, D) fp32 (bf16 = 0) or bf16 (bf16 = 1); row_ptr
// (A + 1,) and col (E,) int32.  Returns cudaGetLastError() after the launch.
int edge_agg(const void* x, const void* row_ptr, const void* col, void* out, int bf16, int A,
             int D, int round_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (A + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (bf16) {
    edge_agg_kernel<__nv_bfloat16><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(row_ptr),
        static_cast<const int*>(col), static_cast<float*>(out), A, D, 0);
  } else {
    edge_agg_kernel<float><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(row_ptr),
        static_cast<const int*>(col), static_cast<float*>(out), A, D, round_bf16);
  }
  return (int)cudaGetLastError();
}

// out (W*window, D) fp32; data (W*cap, D) fp32; seg (W*cap,) int32.
// Returns the error of cudaFuncSetAttribute when the window's accumulators
// exceed one block's shared memory, else cudaGetLastError() after the launch.
int wseg_sum(const void* data, const void* seg, void* out, int W, int D, int window, int cap,
             int round_bf16, void* stream) {
  const size_t bytes = wseg_smem_bytes(window);
  cudaError_t err = cudaFuncSetAttribute(wseg_sum_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(W, (D + kSegTile - 1) / kSegTile);
  wseg_sum_kernel<<<grid, kSegThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(seg), static_cast<float*>(out), D,
      window, cap, round_bf16);
  return (int)cudaGetLastError();
}

const char* fused_edge_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
