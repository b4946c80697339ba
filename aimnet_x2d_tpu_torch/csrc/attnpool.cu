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
//             sum_partials; d_kb by the grouped contraction of
//             csrc/wgrad_group.cuh, both in csrc/mp_stack_bwd.cu).
//
// ks and ko arrive rounded to the compute dtype (as fp32 values), sb in
// fp32, as the JAX op casts them.  Each atom belongs to at most one molecule
// of its bin (the loaders' pool_mat has one 1 per covered column), so the
// kernels look each atom's molecule up once and turn every membership
// product into a sum over that molecule's atoms.
//
// What bounds it on an H100: the x_self projection (E x Ds per atom) is
// most of the operations; the rest is a few passes over (Ds + Do) x A
// elements, so at the flagship shape it is bound by memory traffic.  The
// forward, and the backward in fp32, write v (and in the backward t and dt)
// to global work slabs that stay in L2 while the bin is worked on, and do
// the per-atom work with one warp per feature row (coalesced over atoms).
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
//
// The bf16 backward on tiles (attnpool_bwd_tile_kernel, both forms): one
// 320-thread block per 64-atom tile, the ab / 64 tiles of a bin one
// thread-block cluster.  The one-block-a-bin kernel writes t, v and dt to
// three (Dsp, A) slabs (36 MB each at the training batch, past the L2 all
// together) and reads them back, and its per-atom passes wait on global
// loads; the tile keeps its operands on chip:
// - t = rnd(rnd(kb^T emb) + bb) on mma.sync (csrc/walk.cuh ring_product) in
//   row blocks of at most 160, kb^T and then kb streamed through the walk's
//   cp.async ring in fragment order (ops/bin_attnpool.py::pool_stream), the
//   emb tile (cp.async, or looked up under the fold) the B operand; v =
//   rnd(act(t)) is formed from t where it is read, and dt = rnd(dv
//   rnd(act'(t))) overwrites t in place; the activation is a template
//   argument;
// - g_self and g_other of the bin's molecules, the score weights and the
//   tile's attn arrive by cp.async; once t is formed, the x_other tile takes
//   the emb tile's buffer;
// - dw sums each column's rows in five row groups, added in order;
// - the softmax backward's per-molecule sums t_mol are per-tile partials,
//   added in rank order through distributed shared memory after a cluster
//   barrier (molecules cross tile borders);
// - the x_self and x_other rows: eight threads a row, eight atoms a thread,
//   the row's sums over its atoms a fixed xor-shuffle;
// - demb = rnd(kb dt) on mma.sync from the same ring, into the emb tile's
//   buffer: the dense form stores it, the fold adds it at each atom's code
//   into the tile's d_bd partial;
// - the per-tile partials (d_bb, d_ks, d_ko, d_sb, the fold's d_bd) are
//   summed over the cluster in rank order, so each bin writes one row, as
//   the one-block-a-bin kernel does;
// - dt is written once, by 16-byte stores, for d_kb, which the grouped
//   contraction (csrc/wgrad_group.cuh) forms from (dt, emb) or, under the
//   fold, from dt and the embeddings gathered from the code rows.
// No atomics: reruns are bit-equal.  fp32, and bf16 shapes past it (H > 8,
// Do > E, ab > 512, shared memory), take attnpool_bwd_kernel.
//
// Built with -DATTNPOOL_MARKS, both backward kernels record a %globaltimer
// mark per block at each phase boundary (attnpool_bwd_marks; chip_smoke.py's
// [train-kernel] and [fold-kernel] phases read them).

#include "vocab.cuh"
#include "walk.cuh"

namespace {

// 4-byte async copy global -> shared (cp_async16's small sibling)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

#ifdef ATTNPOOL_MARKS
constexpr int kMarks = 10;  // marks a block may record
__device__ unsigned long long* g_marks;  // (blocks, kMarks), set by attnpool_bwd_marks
#define MARK(i)                                                                     \
  do {                                                                              \
    __syncthreads();                                                                \
    if (threadIdx.x == 0) {                                                         \
      unsigned long long t_;                                                        \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                       \
      g_marks[(size_t)blockIdx.x * kMarks + (i)] = t_;                             \
    }                                                                               \
  } while (0)
#else
#define MARK(i) \
  do {          \
  } while (0)
#endif

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
  MARK(0);
  setup_bin(s, w, pm, Dsp, E, mb, ab);
  for (int e = threadIdx.x; e < H * ab; e += kThreads)
    s.S[e] = attn_in[(size_t)(e / ab) * A + col0 + e % ab];
  for (size_t i = threadIdx.x; i < n_acc; i += kThreads) s.acc[i] = 0.0f;
  MARK(1);
  proj_bin<T, kVocab>(s, emb, w, Tw, Vw, Dsp, E, A, ab, act, codes, bd, voc);  // ends with a barrier
  MARK(2);
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
  MARK(3);
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
  MARK(4);

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
  MARK(5);
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
  MARK(6);

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
  MARK(7);
}

// ---- the bf16 backward on tiles: one block per 64-atom tile, a cluster per bin ----

constexpr int kPoolGroups = kWalkThreads / kTile;  // row groups of dw's per-atom sums

// Ring stages: the recompute (kb^T in row blocks of <= 160 over K = E), then
// demb (kb in row blocks of <= 160 over K = Dsp); each stage holds 160 rows'
// worth (a shorter block's stage is padded), so the ring's slots are one size.
__host__ __device__ inline int pool_stages(int Dsp, int E) {
  const int bt = (Dsp + kWalkMaxDp - 1) / kWalkMaxDp, be = (E + kWalkMaxDp - 1) / kWalkMaxDp;
  return (bt * kpad(E) + be * kpad(Dsp)) / kKc;
}

// d_bb (Dsp), d_ks (Ds x H), d_ko (Do x H), d_sb (H): a bin's partial row
__host__ __device__ inline size_t pool_head(int Dsp, int Ds, int Do, int H) {
  return (size_t)Dsp + (size_t)(Ds + Do) * H + H;
}

struct PoolTileSmem {
  bf16* tb;     // Dsp x kLdT: t, then dt in place
  bf16* et;     // E x kLdT: the emb tile, then rnd(kb dt)
  bf16* ring;   // kRing x 160 x kKc: kb^T, then kb
  float* bb;    // Dsp
  float* at;    // H x kTile: attn
  float* dsc;   // H x kTile: the rounded softmax cotangent
  float* wbar;  // kTile
  float* dat;   // kTile: dw / H
  float* red;   // 2 kPoolGroups x kTile: dw's partial sums
  float* tmp;   // H x mb: this tile's partial t_mol
  float* tm;    // H x mb: t_mol over the bin
  float* head;  // this tile's partial of the bin's row (pool_head)
  float* ksm;   // Ds x H, then ko: Do x H (the score weights)
  float* gsm;   // Ds x mb: g_self of the bin's molecules
  float* gom;   // Do x mb: g_other
  float* acc;   // the fold: this tile's compact d_bd partial
  int* molof;   // kTile: the tile's atoms' molecules, -1 for none
};

size_t pool_tile_smem_bytes(int Dsp, int E, int H, int Ds, int Do, int mb, long long n_acc) {
  return ((size_t)(Dsp + E) * kLdT + (size_t)kRing * kWalkMaxDp * kKc) * sizeof(bf16) +
         kTile * sizeof(int) +
         ((size_t)Dsp + 2 * (size_t)H * kTile + (2 + 2 * kPoolGroups) * kTile +
          2 * (size_t)H * mb + pool_head(Dsp, Ds, Do, H) + (size_t)(Ds + Do) * (H + mb) +
          (size_t)n_acc) * sizeof(float);
}

__device__ PoolTileSmem carve_pool_tiles(unsigned char* base, int Dsp, int E, int H, int Ds,
                                         int Do, int mb) {
  PoolTileSmem t;
  bf16* h = reinterpret_cast<bf16*>(base);
  t.tb = h; h += (size_t)Dsp * kLdT;
  t.et = h; h += (size_t)E * kLdT;
  t.ring = h; h += (size_t)kRing * kWalkMaxDp * kKc;
  t.molof = reinterpret_cast<int*>(h);
  float* f = reinterpret_cast<float*>(t.molof + kTile);
  t.bb = f; f += Dsp;
  t.at = f; f += (size_t)H * kTile;
  t.dsc = f; f += (size_t)H * kTile;
  t.wbar = f; f += kTile;
  t.dat = f; f += kTile;
  t.red = f; f += 2 * kPoolGroups * kTile;
  t.tmp = f; f += (size_t)H * mb;
  t.tm = f; f += (size_t)H * mb;
  t.head = f; f += pool_head(Dsp, Ds, Do, H);
  t.ksm = f; f += (size_t)(Ds + Do) * H;
  t.gsm = f; f += (size_t)Ds * mb;
  t.gom = f; f += (size_t)Do * mb;
  t.acc = f;
  return t;
}

// As attnpool_bwd_kernel (bf16), one block per 64-atom tile, grid nb * C,
// clusters of C = ab / 64: ws is kb^T's and kb's stream (ops/bin_attnpool.py::
// pool_stream), w the forward's weights (for bb); dtc (Dsp, A) receives dt
// for the d_kb contraction; part per bin [d_bb, d_ks, d_ko, d_sb, then the
// fold's compact d_bd partial]; demb (dense form) as the one-block kernel's.
template <int ACT, bool kVocab>
__global__ void __launch_bounds__(kWalkThreads, 1)
attnpool_bwd_tile_kernel(const bf16* __restrict__ emb, const bf16* __restrict__ xo,
                         const int8_t* __restrict__ pm, const bf16* __restrict__ w,
                         const bf16* __restrict__ ws, const float* __restrict__ score,
                         const float* __restrict__ attn_in, const float* __restrict__ gps,
                         const float* __restrict__ gpo, const float* __restrict__ gcov,
                         bf16* __restrict__ dtc, float* __restrict__ part,
                         bf16* __restrict__ demb, bf16* __restrict__ dxo, int Ds, int Dsp, int Do,
                         int E, int H, int A, int mb, int ab,
                         const int* __restrict__ codes, const bf16* __restrict__ bd, Vocab voc) {
  constexpr int act = ACT;
  namespace cgr = cooperative_groups;
  cgr::cluster_group cluster = cgr::this_cluster();
  const int C = ab / kTile, rank = (int)cluster.block_rank();
  const int bin = blockIdx.x / C, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t col0 = (size_t)bin * ab, cc = col0 + (size_t)rank * kTile;
  const size_t B = (size_t)(gridDim.x / C) * mb, mc0 = (size_t)bin * mb;
  extern __shared__ __align__(128) unsigned char smem[];
  const PoolTileSmem t = carve_pool_tiles(smem, Dsp, E, H, Ds, Do, mb);
  const float* ks = t.ksm;
  const float* ko = t.ksm + (size_t)Ds * H;
  MARK(0);

  // the emb tile (dense: cp.async; the fold: looked up, 8 atoms of a row a
  // thread), the score weights, the bin's molecules' cotangents and the
  // tile's attn by cp.async, committed ahead of the ring's stages so that
  // the first stage's wait covers them; bb, the tile's molecules, wbar
  for (int e = threadIdx.x; e < (Ds + Do) * H; e += kWalkThreads) cp_async4(t.ksm + e, score + e);
  for (int e = threadIdx.x; e < (Ds + Do) * mb; e += kWalkThreads) {
    const int d = e / mb, m = e % mb;  // gom follows gsm
    cp_async4(t.gsm + e,
              d < Ds ? gps + (size_t)d * B + mc0 + m : gpo + (size_t)(d - Ds) * B + mc0 + m);
  }
  for (int e = threadIdx.x; e < H * kTile; e += kWalkThreads)
    cp_async4(t.at + e, attn_in + (size_t)(e / kTile) * A + cc + e % kTile);
  if constexpr (kVocab) {
#pragma unroll 4
    for (int e = threadIdx.x; e < E * (kTile / 8); e += kWalkThreads) {
      const int r = e / (kTile / 8), c = e % (kTile / 8) * 8, f = r / voc.Df;
      const int V = voc.off[f + 1] - voc.off[f];
      const int4* cp = reinterpret_cast<const int4*>(codes + (size_t)f * A + cc + c);
      const int4 k0 = cp[0], k1 = cp[1];
      const int k[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      const bf16* row = bd + (size_t)r * voc.SV + voc.off[f];
      __align__(16) bf16 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = (k[q] >= 0 && k[q] < V) ? row[k[q]] : from_f<bf16>(0.0f);
      *reinterpret_cast<int4*>(t.et + r * kLdT + c) = *reinterpret_cast<const int4*>(v);
    }
  } else {
    for (int e = threadIdx.x; e < E * (kTile / 8); e += kWalkThreads) {
      const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
      cp_async16(t.et + r * kLdT + c, emb + (size_t)r * A + cc + c);
    }
    cp_async_commit();
  }
  Ring ring{ws, t.ring, kWalkMaxDp * kKc, pool_stages(Dsp, E), 0, 0};
  ring.start();
  for (int e = threadIdx.x; e < Dsp; e += kWalkThreads) t.bb[e] = to_f(w[(size_t)Dsp * E + e]);
  const int8_t* pmb = pm + (size_t)bin * mb * ab + (size_t)rank * kTile;
  for (int c = threadIdx.x; c < kTile; c += kWalkThreads) {
    int m = -1;  // the first slot holding the atom: independent loads, no early exit
#pragma unroll 16
    for (int mm = mb - 1; mm >= 0; --mm)
      if (pmb[(size_t)mm * ab + c] != 0) m = mm;
    t.molof[c] = m;
  }
  if constexpr (kVocab)
    for (long long i = threadIdx.x; i < vocab_acc_size(voc); i += kWalkThreads) t.acc[i] = 0.0f;
  MARK(1);

  // t = rnd(rnd(kb^T emb) + bb), row blocks of <= 160
  float acc[2][4][4];
  for (int r0 = 0; r0 < Dsp; r0 += kWalkMaxDp) {
    const int R = min(kWalkMaxDp, Dsp - r0);
    ring_product(ring, R, E, t.et, t.et, E, acc);
    epilogue(acc, R, [&](int r, int c, float v0, float v1) {
      const float b = t.bb[r0 + r];
      st2(t.tb, r0 + r, c, rnd<bf16>(rnd<bf16>(v0) + b), rnd<bf16>(rnd<bf16>(v1) + b));
    });
  }
  // the emb tile is read: the x_other tile takes its buffer (Do <= E) until demb
  __syncthreads();
  bf16* xs = t.et;
  for (int e = threadIdx.x; e < Do * (kTile / 8); e += kWalkThreads) {
    const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
    cp_async16(xs + r * kLdT + c, xo + (size_t)r * A + cc + c);
  }
  cp_async_commit();
  for (int c = threadIdx.x; c < kTile; c += kWalkThreads) {
    float s = 0.0f;
    for (int h = 0; h < H; ++h) s += t.at[h * kTile + c];
    t.wbar[c] = s / (float)H;
  }
  cp_async_wait<0>();
  __syncthreads();
  MARK(2);

  // dw = sum_d rnd(g_self) v + sum_d rnd(g_other) x_other + g_cov at the
  // atom's molecule: each column's rows in kPoolGroups ranges, added in order
  {
    const int c = threadIdx.x % kTile, g = threadIdx.x / kTile, m = t.molof[c];
    float s1 = 0.0f, s2 = 0.0f;
    if (m >= 0) {
      const int n1 = (Ds + kPoolGroups - 1) / kPoolGroups;
      const int n2 = (Do + kPoolGroups - 1) / kPoolGroups;
#pragma unroll 4
      for (int d = g * n1; d < min(Ds, (g + 1) * n1); ++d)
        s1 += rnd<bf16>(t.gsm[d * mb + m]) * rnd<bf16>(act_fn(act, to_f(t.tb[d * kLdT + c])));
#pragma unroll 4
      for (int d = g * n2; d < min(Do, (g + 1) * n2); ++d)
        s2 += rnd<bf16>(t.gom[d * mb + m]) * to_f(xs[d * kLdT + c]);
    }
    t.red[g * kTile + c] = s1;
    t.red[(kPoolGroups + g) * kTile + c] = s2;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kTile; c += kWalkThreads) {
    const int m = t.molof[c];
    float s1 = 0.0f, s2 = 0.0f;
    for (int g = 0; g < kPoolGroups; ++g) {
      s1 += t.red[g * kTile + c];
      s2 += t.red[(kPoolGroups + g) * kTile + c];
    }
    t.dat[c] = ((s1 + s2) + (m >= 0 ? gcov[mc0 + m] : 0.0f)) / (float)H;
  }
  __syncthreads();
  MARK(3);

  // the softmax backward: t_mol = sum over a molecule's atoms of attn dat,
  // per tile, then over the cluster in rank order; dsc; d_sb's partial
  for (int p = warp; p < H * mb; p += kWarps) {
    const int h = p / mb, m = p % mb;
    float v = 0.0f;
    for (int c = lane; c < kTile; c += 32)
      if (t.molof[c] == m) v += t.at[h * kTile + c] * t.dat[c];
    v = warp_sum(v);
    if (lane == 0) t.tmp[p] = v;
  }
  cluster.sync();
  for (int p = threadIdx.x; p < H * mb; p += kWalkThreads) {
    float v = 0.0f;
    for (int r = 0; r < C; ++r) v += cluster.map_shared_rank(t.tmp, r)[p];
    t.tm[p] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H * kTile; e += kWalkThreads) {
    const int h = e / kTile, c = e % kTile, m = t.molof[c];
    const float at = t.at[e], dat = t.dat[c];
    const float tm = m >= 0 ? t.tm[h * mb + m] : 0.0f;
    t.dsc[e] = rnd<bf16>(at * dat - at * tm);
  }
  __syncthreads();
  for (int h = warp; h < H; h += kWarps) {
    const float v = warp_sum(t.dsc[h * kTile + lane] + t.dsc[h * kTile + lane + 32]);
    if (lane == 0) t.head[Dsp + (size_t)(Ds + Do) * H + h] = v;
  }
  MARK(4);

  // the rows: eight threads a row, eight atoms a thread (16-byte accesses,
  // eight independent elements), kRowsAtOnce rows at once; a row's sums over
  // its atoms are the thread's sums in atom order, then a fixed xor-shuffle
  // over its eight threads
  constexpr int kRowThreads = kTile / 8, kRowsAtOnce = kWalkThreads / kRowThreads;
  const int c0 = threadIdx.x % kRowThreads * 8;
  int mol[8];
  float wb[8], dsr[kMaxH][8];  // the thread's atoms' molecules, wbar and dsc
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mol[i] = t.molof[c0 + i];
    wb[i] = t.wbar[c0 + i];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) dsr[h][i] = h < H ? t.dsc[h * kTile + c0 + i] : 0.0f;
  }
  auto row_sum = [](float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v + __shfl_xor_sync(0xffffffffu, v, 4);
  };

  // x_self rows: dt over t in place, d_bb's and d_ks's partials
  for (int base = 0; base < Dsp; base += kRowsAtOnce) {
    const int d = base + threadIdx.x / kRowThreads;
    const bool live = d < Dsp;
    float abb = 0.0f, aks[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) aks[h] = 0.0f;
    if (live) {
      const uint4 raw = *reinterpret_cast<const uint4*>(t.tb + d * kLdT + c0);
      const unsigned rw[4] = {raw.x, raw.y, raw.z, raw.w};
      unsigned out[4];
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2) {
        const float2 tv = unpack_bf16(rw[i2]);
        float dt2[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = 2 * i2 + q;
          const float u = q ? tv.y : tv.x;
          float dv = 0.0f;
          if (d < Ds) {
            const float gs = mol[i] >= 0 ? rnd<bf16>(t.gsm[d * mb + mol[i]]) : 0.0f;
            const float v = rnd<bf16>(act_fn(act, u));
            float dsum = 0.0f;
#pragma unroll
            for (int h = 0; h < kMaxH; ++h)
              if (h < H) {
                dsum = fmaf(ks[d * H + h], dsr[h][i], dsum);
                aks[h] = fmaf(v, dsr[h][i], aks[h]);
              }
            dv = gs * wb[i] + dsum;
          }
          dt2[q] = dv * rnd<bf16>(act_grad(act, u));
          abb += dt2[q];
        }
        out[i2] = pack_bf16(dt2[0], dt2[1]);
      }
      *reinterpret_cast<uint4*>(t.tb + d * kLdT + c0) = make_uint4(out[0], out[1], out[2], out[3]);
    }
    abb = row_sum(abb);
#pragma unroll
    for (int h = 0; h < kMaxH; ++h)
      if (h < H) aks[h] = row_sum(aks[h]);
    if (live && c0 == 0) {
      t.head[d] = abb;
      if (d < Ds)
        for (int h = 0; h < H; ++h) t.head[Dsp + (size_t)d * H + h] = aks[h];
    }
  }
  __syncthreads();
  MARK(5);

  // x_other rows: dx_other and d_ko's partials
  for (int base = 0; base < Do; base += kRowsAtOnce) {
    const int d = base + threadIdx.x / kRowThreads;
    const bool live = d < Do;
    float ako[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) ako[h] = 0.0f;
    if (live) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + d * kLdT + c0);
      const unsigned rw[4] = {raw.x, raw.y, raw.z, raw.w};
      unsigned out[4];
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2) {
        const float2 xv = unpack_bf16(rw[i2]);
        float o2[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = 2 * i2 + q;
          const float x = q ? xv.y : xv.x;
          const float go = mol[i] >= 0 ? rnd<bf16>(t.gom[d * mb + mol[i]]) : 0.0f;
          float dsum = 0.0f;
#pragma unroll
          for (int h = 0; h < kMaxH; ++h)
            if (h < H) {
              dsum = fmaf(ko[d * H + h], dsr[h][i], dsum);
              ako[h] = fmaf(x, dsr[h][i], ako[h]);
            }
          o2[q] = go * wb[i] + dsum;
        }
        out[i2] = pack_bf16(o2[0], o2[1]);
      }
      *reinterpret_cast<uint4*>(dxo + (size_t)d * A + cc + c0) =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
#pragma unroll
    for (int h = 0; h < kMaxH; ++h)
      if (h < H) ako[h] = row_sum(ako[h]);
    if (live && c0 == 0)
      for (int h = 0; h < H; ++h) t.head[Dsp + (size_t)Ds * H + (size_t)d * H + h] = ako[h];
  }
  MARK(6);

  // dt to its slab; demb = rnd(kb dt), row blocks of <= 160, into et (the
  // epilogue's writes follow the first stage's barrier: x_other is read)
  store_slab(dtc, A, cc, t.tb, Dsp);
  for (int e0 = 0; e0 < E; e0 += kWalkMaxDp) {
    const int R = min(kWalkMaxDp, E - e0);
    ring_product(ring, R, Dsp, t.tb, t.tb, Dsp, acc);
    epilogue(acc, R, [&](int r, int c, float v0, float v1) { st2(t.et, e0 + r, c, v0, v1); });
  }
  __syncthreads();
  if constexpr (kVocab) {
    vocab_accumulate(t.acc, t.et, codes, voc, E, cc, A);
  } else {
    for (int e = threadIdx.x; e < E * (kTile / 8); e += kWalkThreads) {
      const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
      *reinterpret_cast<int4*>(demb + (size_t)r * A + cc + c) =
          *reinterpret_cast<const int4*>(t.et + r * kLdT + c);
    }
  }
  MARK(7);

  // the bin's partial row: the tiles' partials in rank order, the columns
  // spread over the cluster
  cluster.sync();
  const long long nh = (long long)pool_head(Dsp, Ds, Do, H);
  const long long n = nh + (kVocab ? vocab_acc_size(voc) : 0);
  float* pb = part + (size_t)bin * n;
#pragma unroll 2
  for (long long i = (long long)rank * kWalkThreads + threadIdx.x; i < n;
       i += (long long)C * kWalkThreads) {
    const float* src = i < nh ? t.head + i : t.acc + (i - nh);
    float part_r[kWalkMaxCluster];
#pragma unroll
    for (int r = 0; r < kWalkMaxCluster; ++r)
      part_r[r] = r < C ? *cluster.map_shared_rank(src, r) : 0.0f;
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < kWalkMaxCluster; ++r)
      if (r < C) v += part_r[r];
    pb[i] = v;
  }
  cluster.sync();  // the other tiles' reads of this block's partials are done
  MARK(8);
}

bool pool_tiles_fit(int Dsp, int E, int H, int Ds, int Do, int mb, int ab, long long n_acc) {
  return H >= 1 && H <= kMaxH && Dsp % 16 == 0 && E % 16 == 0 && Ds <= Dsp && Do <= E &&
         ab % kTile == 0 &&
         ab / kTile >= 1 && ab / kTile <= kWalkMaxCluster &&
         pool_tile_smem_bytes(Dsp, E, H, Ds, Do, mb, n_acc) <= (size_t)kSmemLimit;
}

bool pool_tiles_configured[5][2][kMaxDevices];

template <int ACT, bool kVocab>
int launch_bwd_tiles(const void* emb, const void* xo, const void* pm, const void* w,
                     const void* ws, const void* score, const void* attn, const void* gps,
                     const void* gpo, const void* gcov, void* dtc, void* part, void* demb,
                     void* dxo, int Ds, int Dsp, int Do, int E, int H, int nb, int mb, int ab,
                     cudaStream_t st, const void* codes, const void* bd, Vocab voc) {
  const long long n_acc = kVocab ? vocab_acc_size(voc) : 0;
  if (!pool_tiles_fit(Dsp, E, H, Ds, Do, mb, ab, n_acc)) return (int)cudaErrorInvalidValue;
  const int err =
      configure(attnpool_bwd_tile_kernel<ACT, kVocab>, pool_tiles_configured[ACT][kVocab]);
  if (err) return err;
  const int C = ab / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * C);
  cfg.blockDim = dim3(kWalkThreads);
  cfg.dynamicSmemBytes = pool_tile_smem_bytes(Dsp, E, H, Ds, Do, mb, n_acc);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, attnpool_bwd_tile_kernel<ACT, kVocab>, static_cast<const bf16*>(emb),
      static_cast<const bf16*>(xo), static_cast<const int8_t*>(pm), static_cast<const bf16*>(w),
      static_cast<const bf16*>(ws), static_cast<const float*>(score),
      static_cast<const float*>(attn), static_cast<const float*>(gps),
      static_cast<const float*>(gpo), static_cast<const float*>(gcov), static_cast<bf16*>(dtc),
      static_cast<float*>(part), static_cast<bf16*>(demb), static_cast<bf16*>(dxo), Ds, Dsp, Do, E,
      H, nb * ab, mb, ab, static_cast<const int*>(codes), static_cast<const bf16*>(bd), voc);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The activation as a template argument (a runtime switch in the per-element
// passes ran markedly slower on an H100, as in the stack's walk).
template <bool kVocab>
int launch_bwd_tiles_act(int act, const void* emb, const void* xo, const void* pm, const void* w,
                         const void* ws, const void* score, const void* attn, const void* gps,
                         const void* gpo, const void* gcov, void* dtc, void* part, void* demb,
                         void* dxo, int Ds, int Dsp, int Do, int E, int H, int nb, int mb, int ab,
                         cudaStream_t st, const void* codes, const void* bd, Vocab voc) {
#define POOL_TILES(a)                                                                          \
  launch_bwd_tiles<a, kVocab>(emb, xo, pm, w, ws, score, attn, gps, gpo, gcov, dtc, part, demb, \
                              dxo, Ds, Dsp, Do, E, H, nb, mb, ab, st, codes, bd, voc)
  switch (act) {  // activation codes: utils/activation.py ACTIVATION_CODES
    case 0: return POOL_TILES(0);
    case 1: return POOL_TILES(1);
    case 2: return POOL_TILES(2);
    case 3: return POOL_TILES(3);
    case 4: return POOL_TILES(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef POOL_TILES
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

// Shared memory of the tiled bf16 backward at these shapes (n_acc 0 for the
// dense form, the compact d_bd size under the fold), or -1 where it does not
// take them (the wrapper then launches attnpool_bwd or attnpool_bwd_vocab).
long long attnpool_bwd_tiles_smem_bytes(int Dsp, int E, int H, int Ds, int Do, int mb, int ab,
                                        int n_acc) {
  return pool_tiles_fit(Dsp, E, H, Ds, Do, mb, ab, n_acc)
             ? (long long)pool_tile_smem_bytes(Dsp, E, H, Ds, Do, mb, n_acc)
             : -1;
}

// Elements of the tiled backward's weight stream (see pool_stages).
long long attnpool_bwd_tiles_stream_elems(int Dsp, int E) {
  return (long long)pool_stages(Dsp, E) * kWalkMaxDp * kKc;
}

// The tiled bf16 backward (attnpool_bwd_tile_kernel): emb (E, A), or, when
// codes is not null, the fold (codes (F, A) int32, the table bd, sizes) with
// emb and demb unused; ws the weight stream; dtc (Dsp, A) receives dt; part
// per bin as attnpool_bwd's or attnpool_bwd_vocab's.  Returns
// cudaGetLastError() after the launch.
int attnpool_bwd_tiles(const void* emb, const void* codes, const void* bd, const int* sizes,
                       int F, const void* xo, const void* pm, const void* w, const void* ws,
                       const void* score, const void* attn, const void* gps, const void* gpo,
                       const void* gcov, void* dtc, void* part, void* demb, void* dxo, int Ds,
                       int Dsp, int Do, int E, int H, int nb, int mb, int ab, int act,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!codes)
    return launch_bwd_tiles_act<false>(act, emb, xo, pm, w, ws, score, attn, gps, gpo, gcov, dtc,
                                       part, demb, dxo, Ds, Dsp, Do, E, H, nb, mb, ab, st, nullptr,
                                       nullptr, Vocab{});
  Vocab voc;
  if (!make_vocab(sizes, F, E, &voc)) return (int)cudaErrorInvalidValue;
  return launch_bwd_tiles_act<true>(act, nullptr, xo, pm, w, ws, score, attn, gps, gpo, gcov, dtc,
                                    part, nullptr, dxo, Ds, Dsp, Do, E, H, nb, mb, ab, st, codes,
                                    bd, voc);
}

#ifdef ATTNPOOL_MARKS
// Points the backward kernels' phase marks at marks ((blocks, 10) uint64).
int attnpool_bwd_marks(void* marks) {
  return (int)cudaMemcpyToSymbol(g_marks, &marks, sizeof(marks));
}
#endif

const char* attnpool_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
