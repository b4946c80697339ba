// Binned attention pooling of row-major atom arrays, forward and backward:
// per-atom scores, a per-molecule masked softmax, the head-mean weight, the
// two weighted pools and the coverage, for the bin-packed layout.
//
// Replaces the TPU kernel aimnet_x2d_tpu/ops/bin_pool.py::_make_pool_op
// (fwd_kernel and bwd_kernel).  Per bin (one block), with xs (ab, Ds) and
// xo (ab, Do) the bin's rows in the compute dtype T:
//
//   forward   s = (xs ks + xo ko) + b                       (ab, H) fp32
//             attn = per-molecule masked softmax of s        (-1e30 mask,
//                    max shift, exp only on covered atoms, 1e-16 floor)
//             w = mean_h attn (fp32);  ps[m] = sum over m's atoms of
//             rnd(xs * rnd(w)) (fp32 sums), po alike;  cov[m] = sum of w
//   backward  reads the forward's attn; g_atom = the atom's molecule's
//             cotangent (fp32); dw = (g_s . xs + g_o . xo) + g_cov;
//             ds = rnd(attn dw/H - attn t_mol), t_mol = sum over the
//             molecule of attn dw/H; dxs = rnd(g_s w + ds ks^T), dxo alike;
//             per-bin fp32 partials of d_ks = xs^T ds, d_ko = xo^T ds and
//             d_b = sum of ds, summed over bins in a fixed order by
//             sum_partials (wgrad.cuh): no atomics, two runs bit-equal.
//
// ks and ko arrive as fp32 values already rounded to T, b in fp32, as the
// JAX op casts them.  Each atom belongs to at most one molecule of its bin
// (the loaders' pool_mat has one 1 per covered column), so the block looks
// each atom's molecule up once, lists each molecule's atoms in atom order,
// and turns every membership product of the TPU kernel (built for its
// matrix unit) into a sum over one molecule's atoms.
//
// What bounds it on an H100: every step is a pass over the bin's rows with
// a few operations per element, so it is bound by memory traffic (xs and
// xo read twice per direction, the second pass mostly from L2).  This first
// version reads rows with one warp per atom for the per-atom reductions and
// one thread per feature column for the pools and the gradients.

#include "wgrad.cuh"

namespace {

constexpr int kPoolThreads = 256;
constexpr int kPoolWarps = kPoolThreads / 32;
constexpr int kPoolMaxH = 8;  // heads a thread keeps in registers

struct PoolSmem {
  float* S;      // H x ab: scores, then attn
  float* ds;     // H x ab: rounded softmax cotangent (backward)
  float* wbar;   // ab
  float* dwbar;  // ab (backward)
  float* red;    // 2 x H x mb: per-molecule max and sum, or t_mol
  int* molof;    // ab: molecule of each atom, -1 for none
  int* order;    // ab: the atoms of molecule 0, then of molecule 1, ...
  int* start;    // mb + 1: each molecule's first entry in order
};

size_t pool_smem_bytes(int H, int mb, int ab) {
  return (2 * (size_t)H * ab + 2 * (size_t)ab + 2 * (size_t)H * mb) * sizeof(float) +
         (2 * (size_t)ab + mb + 1) * sizeof(int);
}

__device__ PoolSmem pool_carve(unsigned char* base, int H, int mb, int ab) {
  PoolSmem s;
  float* p = reinterpret_cast<float*>(base);
  s.S = p; p += (size_t)H * ab;
  s.ds = p; p += (size_t)H * ab;
  s.wbar = p; p += ab;
  s.dwbar = p; p += ab;
  s.red = p; p += 2 * (size_t)H * mb;
  s.molof = reinterpret_cast<int*>(p);
  s.order = s.molof + ab;
  s.start = s.order + ab;
  return s;
}

__device__ __forceinline__ float pool_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Each atom's molecule, and the molecules' atom lists in atom order.
__device__ void pool_members(const PoolSmem& s, const int8_t* pm, int mb, int ab) {
  const int8_t* pmb = pm + (size_t)blockIdx.x * mb * ab;
  for (int a = threadIdx.x; a < ab; a += kPoolThreads) {
    int m = -1;
    for (int mm = 0; mm < mb; ++mm)
      if (pmb[(size_t)mm * ab + a] != 0) {
        m = mm;
        break;
      }
    s.molof[a] = m;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < mb; m += kPoolThreads) {
    int c = 0;
    for (int a = 0; a < ab; ++a) c += s.molof[a] == m;
    s.start[m + 1] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s.start[0] = 0;
    for (int m = 0; m < mb; ++m) s.start[m + 1] += s.start[m];
  }
  __syncthreads();
  for (int m = threadIdx.x; m < mb; m += kPoolThreads) {
    int k = s.start[m];
    for (int a = 0; a < ab; ++a)
      if (s.molof[a] == m) s.order[k++] = a;
  }
  __syncthreads();
}

// w = mean over heads of attn (S), per atom
__device__ void pool_head_mean(const PoolSmem& s, int H, int ab) {
  for (int a = threadIdx.x; a < ab; a += kPoolThreads) {
    float acc = 0.0f;
    for (int h = 0; h < H; ++h) acc += s.S[h * ab + a];
    s.wbar[a] = acc / (float)H;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
bin_pool_fwd_kernel(const T* __restrict__ xs, const T* __restrict__ xo,
                    const int8_t* __restrict__ pm, const float* __restrict__ score,
                    float* __restrict__ ps, float* __restrict__ po, float* __restrict__ cov,
                    float* __restrict__ attn_out, int Ds, int Do, int H, int A, int mb, int ab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PoolSmem s = pool_carve(smem, H, mb, ab);
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t col0 = (size_t)b * ab, mol0 = (size_t)b * mb;
  const float* ks = score;
  const float* ko = score + (size_t)Ds * H;
  const float* sb = ko + (size_t)Do * H;
  pool_members(s, pm, mb, ab);

  // scores: one warp per atom, lanes over the feature columns
  for (int a = warp; a < ab; a += kPoolWarps) {
    const T* rs = xs + (col0 + a) * Ds;
    const T* ro = xo + (col0 + a) * Do;
    float as[kPoolMaxH], ao[kPoolMaxH];
#pragma unroll
    for (int h = 0; h < kPoolMaxH; ++h) as[h] = ao[h] = 0.0f;
    for (int d = lane; d < Ds; d += 32) {
      const float x = to_f(rs[d]);
#pragma unroll
      for (int h = 0; h < kPoolMaxH; ++h)
        if (h < H) as[h] = fmaf(x, ks[d * H + h], as[h]);
    }
    for (int d = lane; d < Do; d += 32) {
      const float x = to_f(ro[d]);
#pragma unroll
      for (int h = 0; h < kPoolMaxH; ++h)
        if (h < H) ao[h] = fmaf(x, ko[d * H + h], ao[h]);
    }
#pragma unroll
    for (int h = 0; h < kPoolMaxH; ++h)
      if (h < H) {
        const float v = (warp_sum(as[h]) + warp_sum(ao[h])) + sb[h];
        if (lane == 0) s.S[h * ab + a] = v;
      }
  }
  __syncthreads();

  // per-molecule max and denominator, one warp per (head, molecule)
  float* smax = s.red;
  float* den = s.red + (size_t)H * mb;
  for (int p = warp; p < H * mb; p += kPoolWarps) {
    const int h = p / mb, m = p % mb;
    float mx = -1e30f;
    for (int k = s.start[m] + lane; k < s.start[m + 1]; k += 32)
      mx = fmaxf(mx, s.S[h * ab + s.order[k]]);
    mx = pool_warp_max(mx);
    float e = 0.0f;
    for (int k = s.start[m] + lane; k < s.start[m + 1]; k += 32)
      e += expf(s.S[h * ab + s.order[k]] - mx);
    e = warp_sum(e);
    if (lane == 0) {
      smax[p] = mx;
      den[p] = e;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H * ab; e += kPoolThreads) {
    const int h = e / ab, a = e % ab, m = s.molof[a];
    float at = 0.0f;
    if (m >= 0) at = expf(s.S[e] - smax[h * mb + m]) / fmaxf(den[h * mb + m], 1e-16f);
    s.S[e] = at;
    attn_out[(size_t)h * A + col0 + a] = at;
  }
  __syncthreads();
  pool_head_mean(s, H, ab);
  for (int m = threadIdx.x; m < mb; m += kPoolThreads) {
    float acc = 0.0f;
    for (int k = s.start[m]; k < s.start[m + 1]; ++k) acc += s.wbar[s.order[k]];
    cov[mol0 + m] = acc;
  }

  // pools: one thread per (molecule, column), the molecule's atoms in order
  for (int part = 0; part < 2; ++part) {
    const T* x = part == 0 ? xs : xo;
    float* out = part == 0 ? ps : po;
    const int D = part == 0 ? Ds : Do;
    for (int i = threadIdx.x; i < mb * D; i += kPoolThreads) {
      const int m = i / D, d = i % D;
      float acc = 0.0f;
      for (int k = s.start[m]; k < s.start[m + 1]; ++k) {
        const int a = s.order[k];
        acc += rnd<T>(to_f(x[(col0 + a) * D + d]) * rnd<T>(s.wbar[a]));
      }
      out[(mol0 + m) * D + d] = acc;
    }
  }
}

// part: per bin [d_ks (Ds x H), d_ko (Do x H), d_b (H)]
template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
bin_pool_bwd_kernel(const T* __restrict__ xs, const T* __restrict__ xo,
                    const int8_t* __restrict__ pm, const float* __restrict__ score,
                    const float* __restrict__ attn_in, const float* __restrict__ gps,
                    const float* __restrict__ gpo, const float* __restrict__ gcov,
                    T* __restrict__ dxs, T* __restrict__ dxo, float* __restrict__ part, int Ds,
                    int Do, int H, int A, int mb, int ab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PoolSmem s = pool_carve(smem, H, mb, ab);
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t col0 = (size_t)b * ab, mol0 = (size_t)b * mb;
  const float* ks = score;
  const float* ko = score + (size_t)Ds * H;
  float* pb = part + (size_t)b * ((size_t)(Ds + Do) * H + H);
  pool_members(s, pm, mb, ab);
  for (int e = threadIdx.x; e < H * ab; e += kPoolThreads)
    s.S[e] = attn_in[(size_t)(e / ab) * A + col0 + e % ab];
  __syncthreads();
  pool_head_mean(s, H, ab);

  // dw = (g_s . xs + g_o . xo) + g_cov at the atom's molecule, one warp per atom
  for (int a = warp; a < ab; a += kPoolWarps) {
    const int m = s.molof[a];
    float s1 = 0.0f, s2 = 0.0f;
    if (m >= 0) {
      const float* gs = gps + (mol0 + m) * Ds;
      const float* go = gpo + (mol0 + m) * Do;
      const T* rs = xs + (col0 + a) * Ds;
      const T* ro = xo + (col0 + a) * Do;
      for (int d = lane; d < Ds; d += 32) s1 = fmaf(gs[d], to_f(rs[d]), s1);
      for (int d = lane; d < Do; d += 32) s2 = fmaf(go[d], to_f(ro[d]), s2);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) s.dwbar[a] = m >= 0 ? (s1 + s2) + gcov[mol0 + m] : 0.0f;
  }
  __syncthreads();

  // softmax backward: t_mol, then ds rounded to T, and d_b's partial
  float* tmol = s.red;
  for (int p = threadIdx.x; p < H * mb; p += kPoolThreads) {
    const int h = p / mb, m = p % mb;
    float acc = 0.0f;
    for (int k = s.start[m]; k < s.start[m + 1]; ++k) {
      const int a = s.order[k];
      acc += s.S[h * ab + a] * (s.dwbar[a] / (float)H);
    }
    tmol[p] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H * ab; e += kPoolThreads) {
    const int h = e / ab, a = e % ab, m = s.molof[a];
    const float at = s.S[e], dat = s.dwbar[a] / (float)H;
    const float tm = m >= 0 ? tmol[h * mb + m] : 0.0f;
    s.ds[e] = rnd<T>(at * dat - at * tm);
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += kPoolThreads) {
    float acc = 0.0f;
    for (int a = 0; a < ab; ++a) acc += s.ds[h * ab + a];
    pb[(size_t)(Ds + Do) * H + h] = acc;
  }

  // dx and the score-weight partials: one thread per column of [xs | xo],
  // walking the bin's atoms in order
  for (int c = threadIdx.x; c < Ds + Do; c += kPoolThreads) {
    const bool self = c < Ds;
    const int d = self ? c : c - Ds, D = self ? Ds : Do;
    const T* x = self ? xs : xo;
    const float* g = self ? gps : gpo;
    const float* kw = (self ? ks : ko) + (size_t)d * H;
    T* dx = self ? dxs : dxo;
    float k[kPoolMaxH], acc[kPoolMaxH];
#pragma unroll
    for (int h = 0; h < kPoolMaxH; ++h) {
      k[h] = h < H ? kw[h] : 0.0f;
      acc[h] = 0.0f;
    }
    for (int a = 0; a < ab; ++a) {
      const size_t o = (col0 + a) * D + d;
      const int m = s.molof[a];
      const float xv = to_f(x[o]);
      const float gv = m >= 0 ? g[(mol0 + m) * D + d] : 0.0f;
      float dsum = 0.0f;
#pragma unroll
      for (int h = 0; h < kPoolMaxH; ++h)
        if (h < H) {
          const float dsv = s.ds[h * ab + a];
          dsum = fmaf(dsv, k[h], dsum);
          acc[h] = fmaf(xv, dsv, acc[h]);
        }
      dx[o] = from_f<T>(gv * s.wbar[a] + dsum);
    }
    float* pw = pb + (self ? 0 : (size_t)Ds * H) + (size_t)d * H;
    for (int h = 0; h < H; ++h) pw[h] = acc[h];
  }
}

template <typename T>
int launch_pool_fwd(const void* xs, const void* xo, const void* pm, const void* score, void* ps,
                    void* po, void* cov, void* attn, int Ds, int Do, int H, int nb, int mb, int ab,
                    cudaStream_t st) {
  const size_t bytes = pool_smem_bytes(H, mb, ab);
  if (bytes > (size_t)kSmemLimit || H > kPoolMaxH) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bin_pool_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  bin_pool_fwd_kernel<T><<<nb, kPoolThreads, bytes, st>>>(
      static_cast<const T*>(xs), static_cast<const T*>(xo), static_cast<const int8_t*>(pm),
      static_cast<const float*>(score), static_cast<float*>(ps), static_cast<float*>(po),
      static_cast<float*>(cov), static_cast<float*>(attn), Ds, Do, H, nb * ab, mb, ab);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pool_bwd(const void* xs, const void* xo, const void* pm, const void* score,
                    const void* attn, const void* gps, const void* gpo, const void* gcov,
                    void* dxs, void* dxo, void* part, int Ds, int Do, int H, int nb, int mb,
                    int ab, cudaStream_t st) {
  const size_t bytes = pool_smem_bytes(H, mb, ab);
  if (bytes > (size_t)kSmemLimit || H > kPoolMaxH) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bin_pool_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  bin_pool_bwd_kernel<T><<<nb, kPoolThreads, bytes, st>>>(
      static_cast<const T*>(xs), static_cast<const T*>(xo), static_cast<const int8_t*>(pm),
      static_cast<const float*>(score), static_cast<const float*>(attn),
      static_cast<const float*>(gps), static_cast<const float*>(gpo),
      static_cast<const float*>(gcov), static_cast<T*>(dxs), static_cast<T*>(dxo),
      static_cast<float*>(part), Ds, Do, H, nb * ab, mb, ab);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long bin_pool_smem_bytes(int H, int mb, int ab) {
  return H > kPoolMaxH ? (long long)kSmemLimit + 1 : (long long)pool_smem_bytes(H, mb, ab);
}

// Each returns cudaGetLastError() after its launch (0 on success).
int bin_pool_fwd(const void* xs, const void* xo, const void* pm, const void* score, void* ps,
                 void* po, void* cov, void* attn, int bf16, int Ds, int Do, int H, int nb, int mb,
                 int ab, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_pool_fwd<__nv_bfloat16>(xs, xo, pm, score, ps, po, cov, attn, Ds, Do, H,
                                               nb, mb, ab, st)
              : launch_pool_fwd<float>(xs, xo, pm, score, ps, po, cov, attn, Ds, Do, H, nb, mb,
                                       ab, st);
}

int bin_pool_bwd(const void* xs, const void* xo, const void* pm, const void* score,
                 const void* attn, const void* gps, const void* gpo, const void* gcov, void* dxs,
                 void* dxo, void* part, int bf16, int Ds, int Do, int H, int nb, int mb, int ab,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_pool_bwd<__nv_bfloat16>(xs, xo, pm, score, attn, gps, gpo, gcov, dxs, dxo,
                                               part, Ds, Do, H, nb, mb, ab, st)
              : launch_pool_bwd<float>(xs, xo, pm, score, attn, gps, gpo, gcov, dxs, dxo, part,
                                       Ds, Do, H, nb, mb, ab, st);
}

// Column sums of the (n, size) per-bin partials, bins in order.
int bin_pool_sum_partials(const void* part, void* out, int n, long long size, void* stream) {
  return launch_sum_partials(part, out, n, size, static_cast<cudaStream_t>(stream));
}

const char* bin_pool_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
