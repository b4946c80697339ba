// Fused attention pooling with the x_self projection folded in, forward and
// backward, for the bin-packed layout.
//
// Replaces the TPU kernel aimnet_x2d_tpu/ops/bin_attnpool.py::
// _make_attnpool_op (fwd_kernel and bwd_kernel).  Per bin (one block),
// feature-major with the bin's atoms on columns:
//
//   forward   v = act(rnd(rnd(kb^T emb) + bb))          (Ds rows)
//             s = (sb + ks^T v) + ko^T x_other          (H, ab) fp32
//             attn = per-molecule masked softmax of s   (-1e30 mask, 1e-16 floor)
//             w = mean_h attn;  pooled = sum over each molecule's atoms of
//             rnd(x * rnd(w)) (fp32 sums);  coverage = sum of w
//   backward  reads the forward's attn, recomputes t and v, and forms
//             dw, the softmax backward ds = attn dattn - attn t_mol,
//             dv = g_atom w + ks ds, dt = dv act'(t), demb = rnd(kb rnd(dt)),
//             dx_other = rnd(g_atom w + ko ds), and per-bin fp32 partials of
//             d_bb, d_ks, d_ko, d_sb (summed over bins in a fixed order by
//             sum_partials; d_kb by the split-K contraction of wgrad.cuh, both in
//             csrc/mp_stack_bwd.cu).
//
// ks and ko arrive rounded to the compute dtype (as fp32 values), sb in
// fp32, as the JAX op casts them.  Each atom belongs to at most one molecule
// of its bin (the loaders' pool_mat has one 1 per covered column), so the
// kernels look each atom's molecule up once and turn every membership
// product into a sum over that molecule's atoms.
//
// What bounds it on an H100: the x_self projection (E x Ds per atom) is
// most of the operations; the rest is a few passes over (Ds + Do) x A
// elements, so at the flagship shape it is bound by memory traffic.  This
// first version writes v (and in the backward t and dt) to global work
// slabs that stay in L2 while the bin is worked on, and does the per-atom
// work with one warp per feature row (coalesced over atoms).
//
// Embedding fold (attnpool_fwd_vocab / attnpool_bwd_vocab, kernel 1c-vocab:
// the TPU op's vocab_sizes, bin_attnpool.py:187-200, :301-322).  emb is
// then never read: each 64-atom tile's embeddings are looked up from the
// code rows and the table into shared memory (csrc/vocab.cuh) and the
// projection reads them there (the same values and order, so t and v are
// the emb form's bit for bit).  The backward computes rnd(kb dt) per tile
// into the same shared tile instead of a global demb and adds each atom's
// value at its code into the bin's compact d_bd partial (one thread per
// table row, atoms in order), written after the bin's other partials.

#include "common.cuh"
#include "vocab.cuh"

namespace {

constexpr int kMaxH = 8;  // heads a block handles in registers
constexpr int kPoolRows = 32;

struct Smem {
  float* stage;
  float* bb;     // Dsp
  float* S;      // H x ab: scores, then attn
  float* dsc;    // H x ab: rounded softmax cotangent (backward)
  int* molof;    // ab: molecule of each atom, -1 for none
  float* wbar;   // ab
  float* dwbar;  // ab
  float* red0;   // H x mb
  float* red1;   // H x mb
  float* xw;     // kPoolRows x ab
  void* etile;   // the fold: E x kLdT looked-up embeddings, then rnd(kb dt)
  float* acc;    // the fold's backward: the bin's compact d_bd partial
};

__host__ __device__ inline size_t smem_bytes(int Dsp, int H, int mb, int ab) {
  return ((size_t)kWarps * 256 + Dsp + 2 * (size_t)H * ab + 4 * (size_t)ab + 2 * (size_t)H * mb +
          (size_t)kPoolRows * ab) * sizeof(float);
}

// with the fold: the tile (128-byte aligned) and n_acc partial floats
size_t vocab_smem_bytes(int Dsp, int H, int mb, int ab, int E, size_t tsize, size_t n_acc) {
  return (smem_bytes(Dsp, H, mb, ab) + 127) / 128 * 128 + (size_t)E * kLdT * tsize +
         n_acc * sizeof(float);
}

__device__ Smem carve(unsigned char* base, int Dsp, int H, int mb, int ab,
                      size_t tile_bytes = 0) {
  Smem s;
  float* p = reinterpret_cast<float*>(base);
  s.stage = p; p += kWarps * 256;
  s.bb = p; p += Dsp;
  s.S = p; p += (size_t)H * ab;
  s.dsc = p; p += (size_t)H * ab;
  s.molof = reinterpret_cast<int*>(p); p += ab;
  s.wbar = p; p += ab;
  s.dwbar = p; p += ab;
  s.red0 = p; p += (size_t)H * mb;
  s.red1 = p; p += (size_t)H * mb;
  s.xw = p;
  unsigned char* q = base + (smem_bytes(Dsp, H, mb, ab) + 127) / 128 * 128;
  s.etile = q;
  s.acc = reinterpret_cast<float*>(q + tile_bytes);
  return s;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// bb to shared memory and each atom's molecule
template <typename T>
__device__ void setup_bin(const Smem& s, const T* w, const int8_t* pm, int Dsp, int E, int mb,
                          int ab) {
  for (int e = threadIdx.x; e < Dsp; e += kThreads) s.bb[e] = to_f(w[(size_t)Dsp * E + e]);
  const int8_t* pmb = pm + (size_t)blockIdx.x * mb * ab;
  for (int a = threadIdx.x; a < ab; a += kThreads) {
    int m = -1;
    for (int mm = 0; mm < mb; ++mm)
      if (pmb[(size_t)mm * ab + a] != 0) {
        m = mm;
        break;
      }
    s.molof[a] = m;
  }
  __syncthreads();
}

// t = rnd(rnd(kb^T emb) + bb), v = act(t) over the bin, tile by tile; under
// the fold (kVocab) each tile's emb is looked up into s.etile first.  The
// fold is a template parameter so that the emb form compiles as it did
// without it: with a runtime choice of the B operand (shared tile or global
// emb) both emb-form kernels measured ~25% slower on an H100.
template <typename T, bool kVocab>
__device__ void proj_bin(const Smem& s, const T* emb, const T* w, T* tbuf, T* vbuf, int Dsp, int E,
                         int A, int ab, int act, const int* codes, const T* bd, const Vocab& voc) {
  const size_t col0 = (size_t)blockIdx.x * ab;
  const bool tiled = sizeof(T) == 2;
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    const size_t cc = col0 + c0;
    auto epi = [&](int r, int c, float v) {
      const size_t o = (size_t)r * A + cc + c;
      const float t = rnd<T>(rnd<T>(v) + s.bb[r]);
      if (tbuf) tbuf[o] = from_f<T>(t);
      vbuf[o] = from_f<T>(act_fn(act, t));
    };
    if constexpr (kVocab) {
      T* et = static_cast<T*>(s.etile);
      vocab_tile(et, codes, bd, voc, E, cc, A);
      __syncthreads();
      gemm_tile(w, E, tiled, Dsp, E, et, et, kLdT, E, s.stage, epi);
      __syncthreads();  // the next tile overwrites s.etile
    } else {
      gemm_tile(w, E, tiled, Dsp, E, emb + cc, emb + cc, A, E, s.stage, epi);
    }
  }
  __syncthreads();
}

// sum over the atoms of molecule m of f(a), one warp per (h, m) pair
template <class F>
__device__ void per_molecule(const Smem& s, int H, int mb, int ab, float* out, F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < H * mb; p += kWarps) {
    const int h = p / mb, m = p % mb;
    float acc = 0.0f;
    for (int a = lane; a < ab; a += 32)
      if (s.molof[a] == m) acc += f(h, a);
    acc = warp_sum(acc);
    if (lane == 0) out[p] = acc;
  }
  __syncthreads();
}

template <typename T, bool kVocab>
__global__ void __launch_bounds__(kThreads)
attnpool_fwd_kernel(const T* __restrict__ emb, const T* __restrict__ xo,
                    const int8_t* __restrict__ pm, const T* __restrict__ w,
                    const float* __restrict__ score, T* vbuf, float* ps, float* po, float* cov,
                    float* attn_out, int Ds, int Dsp, int Do, int E, int H, int A, int mb, int ab,
                    int act, const int* __restrict__ codes, const T* __restrict__ bd, Vocab voc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem, Dsp, H, mb, ab);
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t col0 = (size_t)b * ab, B = (size_t)gridDim.x * mb;
  const float* ks = score;
  const float* ko = score + (size_t)Ds * H;
  const float* sb = ko + (size_t)Do * H;
  setup_bin(s, w, pm, Dsp, E, mb, ab);
  proj_bin<T, kVocab>(s, emb, w, nullptr, vbuf, Dsp, E, A, ab, act, codes, bd, voc);

  // scores, one thread per atom
  for (int a = threadIdx.x; a < ab; a += kThreads) {
    float sv[kMaxH], so[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) sv[h] = so[h] = 0.0f;
    for (int d = 0; d < Ds; ++d) {
      const float x = to_f(vbuf[(size_t)d * A + col0 + a]);
#pragma unroll
      for (int h = 0; h < kMaxH; ++h)
        if (h < H) sv[h] = fmaf(ks[d * H + h], x, sv[h]);
    }
    for (int d = 0; d < Do; ++d) {
      const float x = to_f(xo[(size_t)d * A + col0 + a]);
#pragma unroll
      for (int h = 0; h < kMaxH; ++h)
        if (h < H) so[h] = fmaf(ko[d * H + h], x, so[h]);
    }
#pragma unroll
    for (int h = 0; h < kMaxH; ++h)
      if (h < H) s.S[h * ab + a] = (sb[h] + sv[h]) + so[h];
  }
  __syncthreads();

  // per-molecule masked softmax: max, then the denominator
  for (int p = warp; p < H * mb; p += kWarps) {
    const int h = p / mb, m = p % mb;
    float mx = -1e30f;
    for (int a = lane; a < ab; a += 32)
      if (s.molof[a] == m) mx = fmaxf(mx, s.S[h * ab + a]);
    mx = warp_max(mx);
    float den = 0.0f;
    for (int a = lane; a < ab; a += 32)
      if (s.molof[a] == m) den += expf(s.S[h * ab + a] - mx);
    den = warp_sum(den);
    if (lane == 0) {
      s.red0[p] = mx;
      s.red1[p] = den;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H * ab; e += kThreads) {
    const int h = e / ab, a = e % ab, m = s.molof[a];
    float at = 0.0f;
    if (m >= 0) at = expf(s.S[e] - s.red0[h * mb + m]) / fmaxf(s.red1[h * mb + m], 1e-16f);
    s.S[e] = at;
    attn_out[(size_t)h * A + col0 + a] = at;
  }
  __syncthreads();
  for (int a = threadIdx.x; a < ab; a += kThreads) {
    float acc = 0.0f;
    for (int h = 0; h < H; ++h) acc += s.S[h * ab + a];
    s.wbar[a] = acc / (float)H;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < mb; m += kThreads) {
    float acc = 0.0f;
    for (int a = 0; a < ab; ++a)
      if (s.molof[a] == m) acc += s.wbar[a];
    cov[(size_t)b * mb + m] = acc;
  }

  // pools: stage 32 rows of rnd(x * rnd(w)), then per-molecule sums
  for (int part = 0; part < 2; ++part) {
    const T* x = part == 0 ? vbuf : xo;
    float* out = part == 0 ? ps : po;
    const int rows = part == 0 ? Ds : Do;
    for (int d0 = 0; d0 < rows; d0 += kPoolRows) {
      for (int e = threadIdx.x; e < kPoolRows * ab; e += kThreads) {
        const int r = e / ab, a = e % ab;
        s.xw[e] = d0 + r < rows
                      ? rnd<T>(to_f(x[(size_t)(d0 + r) * A + col0 + a]) * rnd<T>(s.wbar[a]))
                      : 0.0f;
      }
      __syncthreads();
      for (int o = threadIdx.x; o < kPoolRows * mb; o += kThreads) {
        const int r = o / mb, m = o % mb;
        if (d0 + r >= rows) continue;
        float acc = 0.0f;
        for (int a = 0; a < ab; ++a)
          if (s.molof[a] == m) acc += s.xw[r * ab + a];
        out[(size_t)(d0 + r) * B + (size_t)b * mb + m] = acc;
      }
      __syncthreads();
    }
  }
}

// work: three (Dsp, A) slabs: t, v, dt.  part: per bin [d_bb (Dsp),
// d_ks (Ds x H), d_ko (Do x H), d_sb (H)], then under the fold the compact
// d_bd partial (Df x sum of V).
template <typename T, bool kVocab>
__global__ void __launch_bounds__(kThreads)
attnpool_bwd_kernel(const T* __restrict__ emb, const T* __restrict__ xo,
                    const int8_t* __restrict__ pm, const T* __restrict__ w,
                    const T* __restrict__ wt, const float* __restrict__ score,
                    const float* __restrict__ attn_in, const float* __restrict__ gps,
                    const float* __restrict__ gpo, const float* __restrict__ gcov, T* work,
                    float* part, T* demb, T* dxo, int Ds, int Dsp, int Do, int E, int H, int A,
                    int mb, int ab, int act, const int* __restrict__ codes,
                    const T* __restrict__ bd, Vocab voc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem, Dsp, H, mb, ab, (size_t)E * kLdT * sizeof(T));
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t col0 = (size_t)b * ab, B = (size_t)gridDim.x * mb, S = (size_t)Dsp * A;
  const float* ks = score;
  const float* ko = score + (size_t)Ds * H;
  T* Tw = work;
  T* Vw = work + S;
  T* DTC = work + 2 * S;
  const size_t head = (size_t)Dsp + (size_t)(Ds + Do) * H + H;
  const size_t n_acc = kVocab ? (size_t)vocab_acc_size(voc) : 0;
  float* pb = part + (size_t)b * (head + n_acc);
  setup_bin(s, w, pm, Dsp, E, mb, ab);
  for (int e = threadIdx.x; e < H * ab; e += kThreads)
    s.S[e] = attn_in[(size_t)(e / ab) * A + col0 + e % ab];
  for (size_t i = threadIdx.x; i < n_acc; i += kThreads) s.acc[i] = 0.0f;
  proj_bin<T, kVocab>(s, emb, w, Tw, Vw, Dsp, E, A, ab, act, codes, bd, voc);  // ends with a barrier
  for (int a = threadIdx.x; a < ab; a += kThreads) {
    float acc = 0.0f;
    for (int h = 0; h < H; ++h) acc += s.S[h * ab + a];
    s.wbar[a] = acc / (float)H;
    // dw = sum_d g_self v + sum_d g_other x_other + g_cov, at the atom's molecule
    const int m = s.molof[a];
    float s1 = 0.0f, s2 = 0.0f, gc = 0.0f;
    if (m >= 0) {
      const size_t mc = (size_t)b * mb + m;
      for (int d = 0; d < Ds; ++d)
        s1 += rnd<T>(gps[(size_t)d * B + mc]) * to_f(Vw[(size_t)d * A + col0 + a]);
      for (int d = 0; d < Do; ++d)
        s2 += rnd<T>(gpo[(size_t)d * B + mc]) * to_f(xo[(size_t)d * A + col0 + a]);
      gc = gcov[mc];
    }
    s.dwbar[a] = (s1 + s2) + gc;
  }
  __syncthreads();
  per_molecule(s, H, mb, ab, s.red0,
               [&](int h, int a) { return s.S[h * ab + a] * (s.dwbar[a] / (float)H); });
  for (int e = threadIdx.x; e < H * ab; e += kThreads) {
    const int h = e / ab, a = e % ab, m = s.molof[a];
    const float at = s.S[e], dat = s.dwbar[a] / (float)H;
    const float tm = m >= 0 ? s.red0[h * mb + m] : 0.0f;
    s.dsc[e] = rnd<T>(at * dat - at * tm);
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float acc = 0.0f;
    for (int a = 0; a < ab; ++a) acc += s.dsc[h * ab + a];
    pb[Dsp + (size_t)(Ds + Do) * H + h] = acc;
  }

  // x_self rows (one warp per row): dt and the d_bb, d_ks partials
  for (int d = warp; d < Dsp; d += kWarps) {
    float abb = 0.0f, aks[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) aks[h] = 0.0f;
    for (int a = lane; a < ab; a += 32) {
      const size_t o = (size_t)d * A + col0 + a;
      const int m = s.molof[a];
      float dv = 0.0f;
      if (d < Ds) {
        const float gs = m >= 0 ? rnd<T>(gps[(size_t)d * B + (size_t)b * mb + m]) : 0.0f;
        float dsum = 0.0f;
#pragma unroll
        for (int h = 0; h < kMaxH; ++h)
          if (h < H) dsum = fmaf(ks[d * H + h], s.dsc[h * ab + a], dsum);
        dv = gs * s.wbar[a] + dsum;
        const float x = to_f(Vw[o]);
#pragma unroll
        for (int h = 0; h < kMaxH; ++h)
          if (h < H) aks[h] = fmaf(x, s.dsc[h * ab + a], aks[h]);
      }
      const float dt32 = dv * rnd<T>(act_grad(act, to_f(Tw[o])));
      DTC[o] = from_f<T>(dt32);
      abb += dt32;
    }
    abb = warp_sum(abb);
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) aks[h] = warp_sum(aks[h]);
    if (lane == 0) {
      pb[d] = abb;
      if (d < Ds)
        for (int h = 0; h < H; ++h) pb[Dsp + (size_t)d * H + h] = aks[h];
    }
  }
  // x_other rows: dx_other and the d_ko partials
  for (int d = warp; d < Do; d += kWarps) {
    float ako[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) ako[h] = 0.0f;
    for (int a = lane; a < ab; a += 32) {
      const size_t o = (size_t)d * A + col0 + a;
      const int m = s.molof[a];
      const float go = m >= 0 ? rnd<T>(gpo[(size_t)d * B + (size_t)b * mb + m]) : 0.0f;
      const float x = to_f(xo[o]);
      float dsum = 0.0f;
#pragma unroll
      for (int h = 0; h < kMaxH; ++h)
        if (h < H) {
          dsum = fmaf(ko[d * H + h], s.dsc[h * ab + a], dsum);
          ako[h] = fmaf(x, s.dsc[h * ab + a], ako[h]);
        }
      dxo[o] = from_f<T>(go * s.wbar[a] + dsum);
    }
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) ako[h] = warp_sum(ako[h]);
    if (lane == 0)
      for (int h = 0; h < H; ++h) pb[Dsp + (size_t)Ds * H + (size_t)d * H + h] = ako[h];
  }
  __syncthreads();

  // demb = rnd(kb dt), kb (E x Dsp); under the fold per tile into s.etile,
  // then added at each atom's code into the d_bd partial
  const bool tiled = sizeof(T) == 2;
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    const size_t cc = col0 + c0;
    if constexpr (kVocab) {
      T* et = static_cast<T*>(s.etile);
      gemm_tile(wt, Dsp, tiled, E, Dsp, DTC + cc, DTC + cc, A, Dsp, s.stage,
                [&](int r, int c, float v) { et[(size_t)r * kLdT + c] = from_f<T>(v); });
      __syncthreads();
      vocab_accumulate(s.acc, et, codes, voc, E, cc, A);
      __syncthreads();
    } else {
      gemm_tile(wt, Dsp, tiled, E, Dsp, DTC + cc, DTC + cc, A, Dsp, s.stage,
                [&](int r, int c, float v) { demb[(size_t)r * A + cc + c] = from_f<T>(v); });
    }
  }
  for (size_t i = threadIdx.x; i < n_acc; i += kThreads) pb[head + i] = s.acc[i];
}

template <typename T>
int launch_fwd(const void* emb, const void* xo, const void* pm, const void* w, const void* score,
               void* vbuf, void* ps, void* po, void* cov, void* attn, int Ds, int Dsp, int Do,
               int E, int H, int nb, int mb, int ab, int act, cudaStream_t st,
               const void* codes = nullptr, const void* bd = nullptr, Vocab voc = Vocab{}) {
  const size_t bytes = codes ? vocab_smem_bytes(Dsp, H, mb, ab, E, sizeof(T), 0)
                             : smem_bytes(Dsp, H, mb, ab);
  if (bytes > (size_t)kSmemLimit || H > kMaxH) return (int)cudaErrorInvalidValue;
  auto kernel = codes ? attnpool_fwd_kernel<T, true> : attnpool_fwd_kernel<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nb, kThreads, bytes, st>>>(
      static_cast<const T*>(emb), static_cast<const T*>(xo), static_cast<const int8_t*>(pm),
      static_cast<const T*>(w), static_cast<const float*>(score), static_cast<T*>(vbuf),
      static_cast<float*>(ps), static_cast<float*>(po), static_cast<float*>(cov),
      static_cast<float*>(attn), Ds, Dsp, Do, E, H, nb * ab, mb, ab, act,
      static_cast<const int*>(codes), static_cast<const T*>(bd), voc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* emb, const void* xo, const void* pm, const void* w, const void* wt,
               const void* score, const void* attn, const void* gps, const void* gpo,
               const void* gcov, void* work, void* part, void* demb, void* dxo, int Ds, int Dsp,
               int Do, int E, int H, int nb, int mb, int ab, int act, cudaStream_t st,
               const void* codes = nullptr, const void* bd = nullptr, Vocab voc = Vocab{}) {
  const size_t bytes =
      codes ? vocab_smem_bytes(Dsp, H, mb, ab, E, sizeof(T), (size_t)vocab_acc_size(voc))
            : smem_bytes(Dsp, H, mb, ab);
  if (bytes > (size_t)kSmemLimit || H > kMaxH) return (int)cudaErrorInvalidValue;
  auto kernel = codes ? attnpool_bwd_kernel<T, true> : attnpool_bwd_kernel<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nb, kThreads, bytes, st>>>(
      static_cast<const T*>(emb), static_cast<const T*>(xo), static_cast<const int8_t*>(pm),
      static_cast<const T*>(w), static_cast<const T*>(wt), static_cast<const float*>(score),
      static_cast<const float*>(attn), static_cast<const float*>(gps),
      static_cast<const float*>(gpo), static_cast<const float*>(gcov), static_cast<T*>(work),
      static_cast<float*>(part), static_cast<T*>(demb), static_cast<T*>(dxo), Ds, Dsp, Do, E, H,
      nb * ab, mb, ab, act, static_cast<const int*>(codes), static_cast<const T*>(bd), voc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long attnpool_smem_bytes(int Dsp, int H, int mb, int ab) {
  return H > kMaxH ? (long long)kSmemLimit + 1 : (long long)smem_bytes(Dsp, H, mb, ab);
}

// Returns cudaGetLastError() after the launch (0 on success).
int attnpool_fwd(const void* emb, const void* xo, const void* pm, const void* w,
                 const void* score, void* vbuf, void* ps, void* po, void* cov, void* attn,
                 int bf16, int Ds, int Dsp, int Do, int E, int H, int nb, int mb, int ab, int act,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(emb, xo, pm, w, score, vbuf, ps, po, cov, attn, Ds, Dsp,
                                          Do, E, H, nb, mb, ab, act, st)
              : launch_fwd<float>(emb, xo, pm, w, score, vbuf, ps, po, cov, attn, Ds, Dsp, Do, E,
                                  H, nb, mb, ab, act, st);
}

int attnpool_bwd(const void* emb, const void* xo, const void* pm, const void* w, const void* wt,
                 const void* score, const void* attn, const void* gps, const void* gpo,
                 const void* gcov, void* work, void* part, void* demb, void* dxo, int bf16,
                 int Ds, int Dsp, int Do, int E, int H, int nb, int mb, int ab, int act,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(emb, xo, pm, w, wt, score, attn, gps, gpo, gcov, work,
                                          part, demb, dxo, Ds, Dsp, Do, E, H, nb, mb, ab, act, st)
              : launch_bwd<float>(emb, xo, pm, w, wt, score, attn, gps, gpo, gcov, work, part,
                                  demb, dxo, Ds, Dsp, Do, E, H, nb, mb, ab, act, st);
}

// Shared memory of the folded kernels: n_acc = 0 for the forward, the
// compact d_bd size (Df * sum of vocabularies) for the backward.
long long attnpool_vocab_smem_bytes(int bf16, int Dsp, int H, int mb, int ab, int E, int n_acc) {
  return H > kMaxH ? (long long)kSmemLimit + 1
                   : (long long)vocab_smem_bytes(Dsp, H, mb, ab, E, bf16 ? 2 : 4, (size_t)n_acc);
}

// The folded forward: codes (F, A) int32 and the table bd (E, sum of
// sizes) in the compute dtype replace emb.  Returns cudaGetLastError().
int attnpool_fwd_vocab(const void* codes, const void* bd, const int* sizes, int F, const void* xo,
                       const void* pm, const void* w, const void* score, void* vbuf, void* ps,
                       void* po, void* cov, void* attn, int bf16, int Ds, int Dsp, int Do, int E,
                       int H, int nb, int mb, int ab, int act, void* stream) {
  Vocab voc;
  if (!make_vocab(sizes, F, E, &voc)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(nullptr, xo, pm, w, score, vbuf, ps, po, cov, attn, Ds,
                                          Dsp, Do, E, H, nb, mb, ab, act, st, codes, bd, voc)
              : launch_fwd<float>(nullptr, xo, pm, w, score, vbuf, ps, po, cov, attn, Ds, Dsp, Do,
                                  E, H, nb, mb, ab, act, st, codes, bd, voc);
}

// The folded backward: part holds per bin [d_bb, d_ks, d_ko, d_sb, then the
// compact d_bd partial]; there is no demb.  Returns cudaGetLastError().
int attnpool_bwd_vocab(const void* codes, const void* bd, const int* sizes, int F, const void* xo,
                       const void* pm, const void* w, const void* wt, const void* score,
                       const void* attn, const void* gps, const void* gpo, const void* gcov,
                       void* work, void* part, void* dxo, int bf16, int Ds, int Dsp, int Do, int E,
                       int H, int nb, int mb, int ab, int act, void* stream) {
  Vocab voc;
  if (!make_vocab(sizes, F, E, &voc)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(nullptr, xo, pm, w, wt, score, attn, gps, gpo, gcov,
                                          work, part, nullptr, dxo, Ds, Dsp, Do, E, H, nb, mb, ab,
                                          act, st, codes, bd, voc)
              : launch_bwd<float>(nullptr, xo, pm, w, wt, score, attn, gps, gpo, gcov, work, part,
                                  nullptr, dxo, Ds, Dsp, Do, E, H, nb, mb, ab, act, st, codes, bd,
                                  voc);
}

const char* attnpool_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
