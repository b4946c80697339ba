// Config-3 inject (charge equilibration + cis/trans + tetrahedral polynomial
// + stereo projection), forward and backward, for the bin-packed layout.
//
// Replaces the inject half of the TPU kernel aimnet_x2d_tpu/ops/bin_inject.py::
// _make_inject_layer_op (fwd_kernel, bwd_kernel); the layer half, layer(pre)
// + pre, is kernel 1d (csrc/mp_stack.cu, csrc/mp_stack_bwd.cu at one layer),
// launched by the wrapper (ops/bin_inject.py) after this kernel.  Per bin (one
// block), feature-major with the bin's atoms on columns:
//
//   forward   x'  = x with rows 0/1 equilibrated per molecule:
//                   f0 = max(f, 1e-6), F = max(sum f0 + 1e-6, 1e-6),
//                   f' = f0 / F, q' = q + f' (Q - sum q); padding atoms f' = 0
//             cct = x' + rnd(x' S^T)          S: signed int8 cis/trans counts
//             tet = m (x' + rnd(delta))       delta: each centre's polynomial
//                   added into its 4 neighbour columns; m = 0 off them when
//                   any centre is in the batch (any_tet), else 1
//             pre = rnd(rnd(kb^T [x'; cct; tet]) + b)   one K = 3Dp product
//   backward  from dpre (the fp32 cotangent of pre rounded, kernel 1d's):
//             [dx'; dcct; dtet] = kb dpre (fp32), then
//             dx' += dcct + rnd(dcct) S + m dtet + the polynomial's backward,
//             then the equilibration's backward (rows 0/1; zero where the
//             1e-6 clip binds).  kb and b's gradients come from the split-K
//             contraction of csrc/wgrad.cuh over [x'; cct; tet] and dpre.
//
// Each atom belongs to at most one molecule of its bin (the loaders' pool
// matrix), so each block looks every atom's molecule up once and the
// per-molecule sums are one warp per molecule.  A tetrahedral centre's four
// neighbours are in its bin (molecules are packed whole): one warp per centre
// slot of the bin's table (the host-built tet_bin, -1 padding) forms its
// polynomial in fp32 and writes it, per neighbour, to a global scratch; the
// columns then sum their entries through per-column lists built in shared
// memory, in a fixed order, so there are no atomics and the result is the same
// from run to run.
//
// What bounds it on an H100: the K = 3Dp projection (and kb dpre in the
// backward), 2 * 3D * D operations per atom, with the cis/trans aggregation
// beside it; the rest is a few passes over Dp x ab elements.  Tensor-core work
// at these sizes is small, so the first version is bound by its global-memory
// passes: x', cct and tet are written to a (3Dp, A) array (L2-resident while
// the bin is worked on) that the projection reads back and that training
// keeps for the backward and the weight gradients.

#include "common.cuh"

namespace {

struct InjSmem {
  float* stage;  // kWarps x 256: gemm epilogue staging
  float* msum;   // 4 x mb: sum q, F; then (backward) dQFq, dF per molecule
  float* row0;   // ab: backward, the cotangent of q'
  float* row1;   // ab: backward, the cotangent of f'
  float* bias;   // Dp
  int* molof;    // ab: each atom's molecule, -1 for none
  int* head;     // ab: first table entry naming the column, -1 for none
  int* next;     // 4 x Tc: the next entry naming the same column
  int* cols;     // 4 x Tc: the bin's centre table, k-major
  void* scratch;  // ab x kLdT of T: the adjacency chunk of a product
};

template <typename T>
size_t inj_smem_bytes(int Dp, int mb, int ab, int Tc) {
  size_t b = ((size_t)kWarps * 256 + 4 * (size_t)mb + 2 * (size_t)ab + Dp) * sizeof(float);
  b += (2 * (size_t)ab + 8 * (size_t)Tc) * sizeof(int);
  b = (b + 127) / 128 * 128;  // wmma loads the scratch tiles: 32-byte aligned
  return b + (size_t)ab * kLdT * sizeof(T);
}

template <typename T>
__device__ InjSmem carve(unsigned char* base, int Dp, int mb, int ab, int Tc) {
  InjSmem s;
  float* p = reinterpret_cast<float*>(base);
  s.stage = p; p += kWarps * 256;
  s.msum = p; p += 4 * mb;
  s.row0 = p; p += ab;
  s.row1 = p; p += ab;
  s.bias = p; p += Dp;
  int* q = reinterpret_cast<int*>(p);
  s.molof = q; q += ab;
  s.head = q; q += ab;
  s.next = q; q += 4 * Tc;
  s.cols = q; q += 4 * Tc;
  const size_t off = (reinterpret_cast<unsigned char*>(q) - base + 127) / 128 * 128;
  s.scratch = base + off;
  return s;
}

// Each atom's molecule, the bin's centre table and its per-column lists,
// the biases (b, or nothing when w is null), and the per-molecule sums of
// the equilibration: msum[m] = sum q, msum[mb + m] = F.
template <typename T>
__device__ void setup_bin(const InjSmem& s, const T* x, const int8_t* pool, const int* tbin,
                          const T* bias_src, int Dp, int A, int mb, int ab, int Tc) {
  const int bin = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t col0 = (size_t)bin * ab;
  const int8_t* pmb = pool + (size_t)bin * mb * ab;
  for (int a = threadIdx.x; a < ab; a += kThreads) {
    int m = -1;
    for (int mm = 0; mm < mb; ++mm)
      if (pmb[(size_t)mm * ab + a] != 0) {
        m = mm;
        break;
      }
    s.molof[a] = m;
    s.head[a] = -1;
  }
  for (int e = threadIdx.x; e < 4 * Tc; e += kThreads) s.cols[e] = tbin[(size_t)bin * 4 * Tc + e];
  if (bias_src)
    for (int e = threadIdx.x; e < Dp; e += kThreads) s.bias[e] = to_f(bias_src[e]);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int e = 0; e < 4 * Tc; ++e) {
      const int c = s.cols[e];
      if (c >= 0 && c < ab) {
        s.next[e] = s.head[c];
        s.head[c] = e;
      } else {
        s.next[e] = -1;
      }
    }
  }
  for (int m = warp; m < mb; m += kWarps) {
    float sq = 0.0f, sf = 0.0f;
    for (int a = lane; a < ab; a += 32)
      if (s.molof[a] == m) {
        sq += to_f(x[col0 + a]);
        sf += fmaxf(to_f(x[(size_t)A + col0 + a]), 1e-6f);
      }
    sq = warp_sum(sq);
    sf = warp_sum(sf);
    if (lane == 0) {
      s.msum[m] = sq;
      s.msum[mb + m] = fmaxf(sf + 1e-6f, 1e-6f);
    }
  }
  __syncthreads();
}

struct Charge {
  float f0, inv, dQ, fnew, qnew;
};

// The equilibration at atom a of the block's bin (setup_bin's sums).
template <typename T>
__device__ Charge charge_at(const InjSmem& s, const T* x, const float* tca, int A, int mb,
                           size_t col0, int a) {
  const size_t o = col0 + a;
  Charge c;
  const float q = to_f(x[o]);
  c.f0 = fmaxf(to_f(x[(size_t)A + o]), 1e-6f);
  const int m = s.molof[a];
  c.inv = m >= 0 ? 1.0f / s.msum[mb + m] : 0.0f;
  c.dQ = tca[o] - (m >= 0 ? s.msum[m] : 0.0f);
  c.fnew = c.f0 * c.inv;
  c.qnew = q + c.fnew * c.dQ;
  return c;
}

// m of column c: any_tet * (c neighbours a centre) + (1 - any_tet)
__device__ __forceinline__ float col_mask(const InjSmem& s, float anyt, int c) {
  return anyt * (s.head[c] >= 0 ? 1.0f : 0.0f) + (1.0f - anyt);
}

// The sum over the table entries that name column c of their row-r values.
__device__ __forceinline__ float col_sum(const InjSmem& s, const float* chb, int Dp, int c, int r) {
  float v = 0.0f;
  for (int j = s.head[c]; j >= 0; j = s.next[j]) v += chb[(size_t)j * Dp + r];
  return v;
}

// The neighbour columns of centre slot t and their norms; false when the
// slot is padding.
template <typename T>
__device__ bool centre(const InjSmem& s, const T* xp, int t, int Tc, int D, int A, size_t col0,
                       int lane, int col[4], float mags[4], float mc[4]) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    col[k] = s.cols[k * Tc + t];
    any |= col[k] >= 0;
  }
  if (!any) return false;
  float ss[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int d = lane; d < D; d += 32)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float e = col[k] >= 0 ? to_f(xp[(size_t)d * A + col0 + col[k]]) : 0.0f;
      ss[k] += e * e;
    }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    mags[k] = sqrtf(warp_sum(ss[k]));
    mc[k] = fmaxf(mags[k], 1e-8f);
  }
  return true;
}

template <typename T>
__device__ __forceinline__ void normed(const T* xp, const int col[4], const float mc[4], int d,
                                       int A, size_t col0, float eN[4], float sq[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float e = col[k] >= 0 ? to_f(xp[(size_t)d * A + col0 + col[k]]) : 0.0f;
    eN[k] = e / mc[k];
    sq[k] = eN[k] * eN[k];
  }
}

// P_k = sq_{k+1} (eN_{k+2} - eN_{k+3}) + sq_{k+2} (eN_{k+3} - eN_{k+1})
//     + sq_{k+3} (eN_{k+1} - eN_{k+2}), indices mod 4
__device__ __forceinline__ float poly(const float eN[4], const float sq[4], int k) {
  const int a1 = (k + 1) & 3, a2 = (k + 2) & 3, a3 = (k + 3) & 3;
  return sq[a1] * (eN[a2] - eN[a3]) + sq[a2] * (eN[a3] - eN[a1]) + sq[a3] * (eN[a1] - eN[a2]);
}

// d(loss)/d eN_k through the normalised square and the polynomial, from
// dP_k = dchir_k * scale (the JAX backward's accumulation, term by term).
__device__ __forceinline__ void poly_bwd(const float eN[4], const float sq[4], const float dP[4],
                                         float dEt[4]) {
  float d_sq[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d_eN[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int a1 = (k + 1) & 3, a2 = (k + 2) & 3, a3 = (k + 3) & 3;
    d_sq[a1] += dP[k] * (eN[a2] - eN[a3]);
    d_sq[a2] += dP[k] * (eN[a3] - eN[a1]);
    d_sq[a3] += dP[k] * (eN[a1] - eN[a2]);
    d_eN[a2] += dP[k] * sq[a1];
    d_eN[a3] -= dP[k] * sq[a1];
    d_eN[a3] += dP[k] * sq[a2];
    d_eN[a1] -= dP[k] * sq[a2];
    d_eN[a1] += dP[k] * sq[a3];
    d_eN[a2] -= dP[k] * sq[a3];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) dEt[k] = d_eN[k] + 2.0f * eN[k] * d_sq[k];
}

// The aggregation chunk: scratch[j][i] = adj[c0 + i][j] (the B operand of
// x adj^T for columns c0 .. c0 + 63), or, transposed, scratch[i][j] =
// adj[i][c0 + j] (the B operand of v adj).
template <typename T>
__device__ void load_adj(T* scratch, const int8_t* adj_b, int ab, int c0, bool transposed) {
  if (!transposed) {
    for (int e = threadIdx.x; e < kTile * ab / 16; e += kThreads) {
      const int il = e / (ab / 16), j0 = e % (ab / 16) * 16;
      const int4 v = *reinterpret_cast<const int4*>(adj_b + (size_t)(c0 + il) * ab + j0);
      const int8_t* m = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int t = 0; t < 16; ++t) scratch[(size_t)(j0 + t) * kLdT + il] = from_f<T>((float)m[t]);
    }
  } else {
    for (int e = threadIdx.x; e < ab * (kTile / 16); e += kThreads) {
      const int i = e / (kTile / 16), j0 = e % (kTile / 16) * 16;
      const int4 v = *reinterpret_cast<const int4*>(adj_b + (size_t)i * ab + c0 + j0);
      const int8_t* m = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int t = 0; t < 16; ++t) scratch[(size_t)i * kLdT + j0 + t] = from_f<T>((float)m[t]);
    }
  }
  __syncthreads();
}

// x (D, A) the layer input; w = [kb^T (Dp x 3Dp), b (Dp)]; pre (D, A); xct
// (3Dp, A) receives [x'; cct; tet] with zero padded rows; ch a
// (nb, 4, Tc, Dp) fp32 scratch for the centres' polynomials.
template <typename T>
__global__ void __launch_bounds__(kThreads)
inject_fwd_kernel(const T* __restrict__ x, const float* __restrict__ tca,
                  const int8_t* __restrict__ pool, const int* __restrict__ tbin,
                  const float* __restrict__ anyt_p, const int8_t* __restrict__ sadj,
                  const T* __restrict__ w, T* pre, T* xct, float* ch, int D, int Dp, int A, int mb,
                  int ab, int Tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const InjSmem s = carve<T>(smem, Dp, mb, ab, Tc);
  T* scratch = static_cast<T*>(s.scratch);
  const int bin = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t col0 = (size_t)bin * ab, S = (size_t)Dp * A;
  T* XP = xct;
  T* CCT = xct + S;
  T* TET = xct + 2 * S;
  float* chb = ch + (size_t)bin * 4 * Tc * Dp;
  const float anyt = *anyt_p;
  setup_bin(s, x, pool, tbin, w + (size_t)Dp * 3 * Dp, Dp, A, mb, ab, Tc);

  // x': rows 0/1 equilibrated, the others copied, padded rows zero
  for (int e = threadIdx.x; e < Dp * ab; e += kThreads) {
    const int r = e / ab, c = e % ab;
    const size_t o = (size_t)r * A + col0 + c;
    T v = from_f<T>(0.0f);
    if (r < 2) {
      const Charge cg = charge_at(s, x, tca, A, mb, col0, c);
      v = from_f<T>(r == 0 ? cg.qnew : cg.fnew);
    } else if (r < D) {
      v = x[o];
    }
    XP[o] = v;
  }
  __syncthreads();

  // cct = x' + rnd(x' S^T), one 64-atom chunk of columns at a time
  const int8_t* adj_b = sadj + (size_t)bin * ab * ab;
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    load_adj(scratch, adj_b, ab, c0, false);
    gemm_tile(XP + col0, A, false, Dp, ab, scratch, scratch, kLdT, ab, s.stage,
              [&](int r, int c, float v) {
                const size_t o = (size_t)r * A + col0 + c0 + c;
                CCT[o] = from_f<T>(to_f(XP[o]) + rnd<T>(v));
              });
    __syncthreads();
  }

  // each centre's chir_k = P_k * tanh(sum_k |e_k| / 12) * any_tet
  for (int t = warp; t < Tc; t += kWarps) {
    int col[4];
    float mags[4], mc[4];
    if (!centre(s, XP, t, Tc, D, A, col0, lane, col, mags, mc)) continue;
    const float scale = tanhf((mags[0] + mags[1] + mags[2] + mags[3]) * (1.0f / 12.0f)) * anyt;
    for (int d = lane; d < D; d += 32) {
      float eN[4], sq[4];
      normed(XP, col, mc, d, A, col0, eN, sq);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (col[k] >= 0) chb[((size_t)k * Tc + t) * Dp + d] = poly(eN, sq, k) * scale;
    }
  }
  __syncthreads();

  // tet = m (x' + rnd(delta)), delta the column's entries summed
  for (int e = threadIdx.x; e < Dp * ab; e += kThreads) {
    const int r = e / ab, c = e % ab;
    const size_t o = (size_t)r * A + col0 + c;
    float v = 0.0f;
    if (r < D) {
      const float t = rnd<T>(to_f(XP[o]) + rnd<T>(col_sum(s, chb, Dp, c, r)));
      v = t * rnd<T>(col_mask(s, anyt, c));
    }
    TET[o] = from_f<T>(v);
  }
  __syncthreads();

  // pre = rnd(rnd(kb^T [x'; cct; tet]) + b)
  const bool tiled = sizeof(T) == 2;
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    gemm_tile(w, 3 * Dp, tiled, Dp, 3 * Dp, xct + col0 + c0, xct + col0 + c0, A, 3 * Dp, s.stage,
              [&](int r, int c, float v) {
                if (r < D) pre[(size_t)r * A + col0 + c0 + c] = from_f<T>(rnd<T>(rnd<T>(v) + s.bias[r]));
              });
  }
}

// wt = kb (3Dp x Dp); xct the forward's; dpre (Dp, A) the rounded cotangent
// of pre; w32 a (3Dp, A) fp32 scratch, dcct a (Dp, A) scratch, ch as in the
// forward; dx (D, A).
template <typename T>
__global__ void __launch_bounds__(kThreads)
inject_bwd_kernel(const T* __restrict__ x, const float* __restrict__ tca,
                  const int8_t* __restrict__ pool, const int* __restrict__ tbin,
                  const float* __restrict__ anyt_p, const int8_t* __restrict__ sadj,
                  const T* __restrict__ wt, const T* __restrict__ xct, const T* __restrict__ dpre,
                  float* w32, T* dcct, float* ch, T* dx, int D, int Dp, int A, int mb, int ab,
                  int Tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const InjSmem s = carve<T>(smem, Dp, mb, ab, Tc);
  T* scratch = static_cast<T*>(s.scratch);
  const int bin = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t col0 = (size_t)bin * ab, S = (size_t)Dp * A;
  const T* XP = xct;
  float* chb = ch + (size_t)bin * 4 * Tc * Dp;
  const float anyt = *anyt_p;
  const bool tiled = sizeof(T) == 2;
  setup_bin<T>(s, x, pool, tbin, nullptr, Dp, A, mb, ab, Tc);

  // [dx'; dcct; dtet] = kb dpre in fp32, and rnd(dcct)
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    gemm_tile(wt, Dp, tiled, 3 * Dp, Dp, dpre + col0 + c0, dpre + col0 + c0, A, Dp, s.stage,
              [&](int r, int c, float v) {
                const size_t o = (size_t)r * A + col0 + c0 + c;
                w32[o] = v;
                if (r >= Dp && r < 2 * Dp) dcct[o - S] = from_f<T>(v);
              });
  }
  __syncthreads();

  // dx' += rnd(dcct) S, the cis/trans aggregation's transpose
  const int8_t* adj_b = sadj + (size_t)bin * ab * ab;
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    load_adj(scratch, adj_b, ab, c0, true);
    gemm_tile(dcct + col0, A, false, Dp, ab, scratch, scratch, kLdT, ab, s.stage,
              [&](int r, int c, float v) { w32[(size_t)r * A + col0 + c0 + c] += v; });
    __syncthreads();
  }

  // each centre: the cotangent of its neighbours' embeddings, d_e_k
  for (int t = warp; t < Tc; t += kWarps) {
    int col[4];
    float mags[4], mc[4];
    if (!centre(s, XP, t, Tc, D, A, col0, lane, col, mags, mc)) continue;
    const float th = tanhf((mags[0] + mags[1] + mags[2] + mags[3]) * (1.0f / 12.0f));
    const float scale = th * anyt;
    float mk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) mk[k] = col[k] >= 0 ? col_mask(s, anyt, col[k]) : 0.0f;
    // dchir_k = m dtet at the neighbour's column; dscale = sum dchir_k P_k
    auto dchir = [&](int d, float out[4]) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out[k] = col[k] >= 0 ? w32[2 * S + (size_t)d * A + col0 + col[k]] * mk[k] : 0.0f;
    };
    float ds = 0.0f;
    for (int d = lane; d < D; d += 32) {
      float eN[4], sq[4], dc[4];
      normed(XP, col, mc, d, A, col0, eN, sq);
      dchir(d, dc);
#pragma unroll
      for (int k = 0; k < 4; ++k) ds += dc[k] * poly(eN, sq, k);
    }
    const float du = warp_sum(ds) * (1.0f - th * th) * anyt * (1.0f / 12.0f);
    float pm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int d = lane; d < D; d += 32) {
      float eN[4], sq[4], dc[4], dP[4], dEt[4];
      normed(XP, col, mc, d, A, col0, eN, sq);
      dchir(d, dc);
#pragma unroll
      for (int k = 0; k < 4; ++k) dP[k] = dc[k] * scale;
      poly_bwd(eN, sq, dP, dEt);
#pragma unroll
      for (int k = 0; k < 4; ++k) pm[k] += dEt[k] * eN[k];
    }
    float dmags[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float dmclip = -warp_sum(pm[k]) / mc[k];
      dmags[k] = (mags[k] >= 1e-8f ? dmclip : 0.0f) + du;
    }
    for (int d = lane; d < D; d += 32) {
      float eN[4], sq[4], dc[4], dP[4], dEt[4];
      normed(XP, col, mc, d, A, col0, eN, sq);
      dchir(d, dc);
#pragma unroll
      for (int k = 0; k < 4; ++k) dP[k] = dc[k] * scale;
      poly_bwd(eN, sq, dP, dEt);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (col[k] >= 0) chb[((size_t)k * Tc + t) * Dp + d] = dEt[k] / mc[k] + dmags[k] * eN[k];
    }
  }
  __syncthreads();

  // dx' = kb-part + agg-part + dcct + m dtet + the centres' d_e; rows >= 2 are dx
  for (int e = threadIdx.x; e < D * ab; e += kThreads) {
    const int r = e / ab, c = e % ab;
    const size_t o = (size_t)r * A + col0 + c;
    const float v = w32[o] + w32[S + o] + w32[2 * S + o] * col_mask(s, anyt, c) +
                    col_sum(s, chb, Dp, c, r);
    if (r == 0)
      s.row0[c] = v;
    else if (r == 1)
      s.row1[c] = v;
    else
      dx[o] = from_f<T>(v);
  }
  __syncthreads();

  // the equilibration's backward: per-molecule sums, then rows 0/1
  for (int m = warp; m < mb; m += kWarps) {
    float sq = 0.0f, sf = 0.0f;
    for (int a = lane; a < ab; a += 32)
      if (s.molof[a] == m) {
        const Charge cg = charge_at(s, x, tca, A, mb, col0, a);
        const float dqn = s.row0[a];
        sq += dqn * cg.fnew;
        sf += (s.row1[a] + dqn * cg.dQ) * cg.f0;
      }
    sq = warp_sum(sq);
    sf = warp_sum(sf);
    if (lane == 0) {
      const float F = s.msum[mb + m];
      s.msum[2 * mb + m] = -sq;            // d sum q
      s.msum[3 * mb + m] = -sf / (F * F);  // dF (F's clip never binds)
    }
  }
  __syncthreads();
  for (int a = threadIdx.x; a < ab; a += kThreads) {
    const Charge cg = charge_at(s, x, tca, A, mb, col0, a);
    const int m = s.molof[a];
    const float dqn = s.row0[a];
    const float dfn = s.row1[a] + dqn * cg.dQ;
    const float dq = dqn + (m >= 0 ? s.msum[2 * mb + m] : 0.0f);
    float df = dfn * cg.inv + (m >= 0 ? s.msum[3 * mb + m] : 0.0f);
    if (!(to_f(x[(size_t)A + col0 + a]) >= 1e-6f)) df = 0.0f;  // the clip binds
    dx[col0 + a] = from_f<T>(dq);
    dx[(size_t)A + col0 + a] = from_f<T>(df);
  }
}

template <typename K>
int prepare(K kernel, size_t bytes) {
  if (bytes > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_fwd(const void* x, const void* tca, const void* pool, const void* tbin,
               const void* anyt, const void* sadj, const void* w, void* pre, void* xct, void* ch,
               int D, int Dp, int A, int nb, int mb, int ab, int Tc, cudaStream_t st) {
  const size_t bytes = inj_smem_bytes<T>(Dp, mb, ab, Tc);
  const int err = prepare(inject_fwd_kernel<T>, bytes);
  if (err) return err;
  inject_fwd_kernel<T><<<nb, kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(tca), static_cast<const int8_t*>(pool),
      static_cast<const int*>(tbin), static_cast<const float*>(anyt),
      static_cast<const int8_t*>(sadj), static_cast<const T*>(w), static_cast<T*>(pre),
      static_cast<T*>(xct), static_cast<float*>(ch), D, Dp, A, mb, ab, Tc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* tca, const void* pool, const void* tbin,
               const void* anyt, const void* sadj, const void* wt, const void* xct,
               const void* dpre, void* w32, void* dcct, void* ch, void* dx, int D, int Dp, int A,
               int nb, int mb, int ab, int Tc, cudaStream_t st) {
  const size_t bytes = inj_smem_bytes<T>(Dp, mb, ab, Tc);
  const int err = prepare(inject_bwd_kernel<T>, bytes);
  if (err) return err;
  inject_bwd_kernel<T><<<nb, kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(tca), static_cast<const int8_t*>(pool),
      static_cast<const int*>(tbin), static_cast<const float*>(anyt),
      static_cast<const int8_t*>(sadj), static_cast<const T*>(wt), static_cast<const T*>(xct),
      static_cast<const T*>(dpre), static_cast<float*>(w32), static_cast<T*>(dcct),
      static_cast<float*>(ch), static_cast<T*>(dx), D, Dp, A, mb, ab, Tc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long inject_smem_bytes(int bf16, int Dp, int mb, int ab, int Tc) {
  return bf16 ? (long long)inj_smem_bytes<__nv_bfloat16>(Dp, mb, ab, Tc)
              : (long long)inj_smem_bytes<float>(Dp, mb, ab, Tc);
}

// Returns cudaGetLastError() after the launch (0 on success).
int inject_fwd(const void* x, const void* tca, const void* pool, const void* tbin,
               const void* anyt, const void* sadj, const void* w, void* pre, void* xct, void* ch,
               int bf16, int D, int Dp, int A, int nb, int mb, int ab, int Tc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, tca, pool, tbin, anyt, sadj, w, pre, xct, ch, D, Dp,
                                          A, nb, mb, ab, Tc, st)
              : launch_fwd<float>(x, tca, pool, tbin, anyt, sadj, w, pre, xct, ch, D, Dp, A, nb,
                                  mb, ab, Tc, st);
}

int inject_bwd(const void* x, const void* tca, const void* pool, const void* tbin,
               const void* anyt, const void* sadj, const void* wt, const void* xct,
               const void* dpre, void* w32, void* dcct, void* ch, void* dx, int bf16, int D, int Dp,
               int A, int nb, int mb, int ab, int Tc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(x, tca, pool, tbin, anyt, sadj, wt, xct, dpre, w32,
                                          dcct, ch, dx, D, Dp, A, nb, mb, ab, Tc, st)
              : launch_bwd<float>(x, tca, pool, tbin, anyt, sadj, wt, xct, dpre, w32, dcct, ch, dx,
                                  D, Dp, A, nb, mb, ab, Tc, st);
}

const char* inject_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
