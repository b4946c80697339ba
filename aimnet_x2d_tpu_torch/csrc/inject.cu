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
//             1e-6 clip binds).  kb and b's gradients come from the grouped
//             contraction (csrc/wgrad_group.cuh) over [x'; cct; tet] and dpre.
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
// beside it; the rest is a few passes over Dp x ab elements.  Tensor-core
// work at these sizes is small, so the forward is bound by its
// global-memory passes: x', cct and tet are written to a (3Dp, A) array
// (L2-resident while the bin is worked on) that the projection reads back
// and that training keeps for the backward and the weight gradients.
//
// The bf16 backward (inject_bwd_tile_kernel) keeps a tile's fp32
// cotangents on chip instead of a (3Dp, A) fp32 scratch in device memory
// (94 MB at the training batch, read back in three passes):
// - one 320-thread block per 64-atom tile, the ab / 64 tiles of a bin one
//   thread-block cluster (as the stack's walk, csrc/walk.cuh);
// - kb dpre on mma.sync (csrc/walk.cuh ring_product): kb's three (Dp x Dp)
//   parts stream through a cp.async ring in fragment order, the dpre tile is
//   the B operand in shared memory; dx' + dcct and dtet stay in fp32 in
//   shared memory, rnd(dcct) in bf16;
// - the cis/trans transpose (dx' += rnd(dcct) S) reads the other tiles'
//   rnd(dcct) through distributed shared memory after a cluster barrier, in
//   rank order (csrc/walk.cuh cluster_transpose);
// - each centre (one warp; the bin's centres spread over the cluster) keeps
//   its neighbours' x' (from xct, L2) and dtet (from the owning tile's
//   shared memory) in registers for its three passes, and writes its d_e to
//   the bin's scratch; the columns then sum their entries in a fixed order;
// - the equilibration's per-molecule sums are per-tile partials, added in
//   rank order through distributed shared memory.
// No atomics: reruns are bit-equal.  It takes Dp <= 160 and ab <= 512 while
// its buffers fit one block's shared memory; fp32, and bf16 shapes past
// that, take inject_bwd_kernel, one block per bin over a global fp32
// scratch.  The kernel's d_kb and d_b come from the grouped contraction
// (csrc/wgrad_group.cuh), launched with kernel 1d's own products.
//
// The bf16 forward (inject_fwd_tile_kernel) keeps a tile's x', cct and tet
// in shared memory instead of writing the (3Dp, A) xct and reading it back
// for the projection: one 320-thread block per 64-atom tile, no cluster.
// What a tile needs from the rest of its bin it forms from x: each block
// forms the bin's per-molecule sums itself (setup_bin), so
// - the cis/trans product x' S^T reads the bin's x' 64 source atoms a chunk,
//   each chunk's rows >= 2 copied from x by cp.async and rows 0/1
//   equilibrated in place, on mma.sync (the walk's aggregation);
// - each centre that touches the tile's columns (a centre across a tile
//   border is formed by both tiles, identically) is one warp, lanes over
//   the features, x' read along each feature row (the tile's own from
//   shared memory, a neighbour in another tile from x): its four norms,
//   then its polynomial added into the tile's fp32 column sums in passes by
//   each entry's place in its column, so that no two warps add to one
//   column at once and every column sums in col_sum's order;
// - pre = kb^T [x'; cct; tet] is one ring_product of K = 3Dp, kb^T streamed
//   in fragment order (ops/bin_inject.py::kbT_stream);
// xct is written by 16-byte stores only where the caller keeps it (the
// backward reads it; serving passes null).  No atomics and no global
// scratch: reruns are bit-equal, x' is the old kernel's bit for bit and
// tet's sums keep its terms and order.  fp32 and bf16 shapes past it
// (Dp > 160, ab > 512, shared memory) take inject_fwd_kernel.
//
// Built with -DINJECT_MARKS, the backward and forward kernels record a
// %globaltimer mark per block at each phase boundary (inject_bwd_marks;
// chip_smoke.py's [c3-kernel] phase reads them): the instrumented build that
// splits each kernel's time by phase.

#include "common.cuh"
#include "walk.cuh"

namespace {

#ifdef INJECT_MARKS
constexpr int kMarks = 8;  // marks a block may record
__device__ unsigned long long* g_marks;  // (blocks, kMarks), set by inject_bwd_marks
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
                          const T* bias_src, int Dp, int A, int mb, int ab, int Tc, int bin) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t col0 = (size_t)bin * ab;
  const int8_t* pmb = pool + (size_t)bin * mb * ab;
  for (int a = threadIdx.x; a < ab; a += kThreads) {
    int m = -1;  // the first slot holding the atom: independent loads, no early exit
#pragma unroll 16
    for (int mm = mb - 1; mm >= 0; --mm)
      if (pmb[(size_t)mm * ab + a] != 0) m = mm;
    s.molof[a] = m;
    s.head[a] = -1;
  }
  for (int e = threadIdx.x; e < 4 * Tc; e += kThreads) s.cols[e] = tbin[(size_t)bin * 4 * Tc + e];
  if (bias_src)
    for (int e = threadIdx.x; e < Dp; e += kThreads) s.bias[e] = to_f(bias_src[e]);
  __syncthreads();
  // each column's entries, last first: head[c] the last entry naming c,
  // next[e] the entry before e naming its column (-1: none); a warp an entry
  for (int e = warp; e < 4 * Tc; e += kWarps) {
    const int c = s.cols[e];
    int prev = -1;
    bool last = true;
    if (c >= 0 && c < ab)
      for (int j0 = 0; j0 < 4 * Tc; j0 += 32) {
        const int j = j0 + lane;
        const bool hit = j < 4 * Tc && s.cols[j] == c;
        prev = max(prev, __reduce_max_sync(0xffffffffu, hit && j < e ? j : -1));
        last = last && !__any_sync(0xffffffffu, hit && j > e);
      }
    if (lane == 0) {
      s.next[e] = prev;
      if (c >= 0 && c < ab && last) s.head[c] = e;
    }
  }
  for (int m = warp; m < mb; m += kWarps) {
    float sq = 0.0f, sf = 0.0f;
#pragma unroll 8
    for (int a = lane; a < ab; a += 32) {
      const float q = to_f(x[col0 + a]), f0 = fmaxf(to_f(x[(size_t)A + col0 + a]), 1e-6f);
      if (s.molof[a] == m) {
        sq += q;
        sf += f0;
      }
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
  MARK(0);
  setup_bin(s, x, pool, tbin, w + (size_t)Dp * 3 * Dp, Dp, A, mb, ab, Tc, bin);
  MARK(1);

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
  MARK(2);

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
  MARK(3);

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
  MARK(4);

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
  MARK(5);

  // pre = rnd(rnd(kb^T [x'; cct; tet]) + b)
  const bool tiled = sizeof(T) == 2;
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    gemm_tile(w, 3 * Dp, tiled, Dp, 3 * Dp, xct + col0 + c0, xct + col0 + c0, A, 3 * Dp, s.stage,
              [&](int r, int c, float v) {
                if (r < D) pre[(size_t)r * A + col0 + c0 + c] = from_f<T>(rnd<T>(rnd<T>(v) + s.bias[r]));
              });
  }
  MARK(6);
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
  MARK(0);
  setup_bin<T>(s, x, pool, tbin, nullptr, Dp, A, mb, ab, Tc, bin);
  MARK(1);

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
  MARK(2);

  // dx' += rnd(dcct) S, the cis/trans aggregation's transpose
  const int8_t* adj_b = sadj + (size_t)bin * ab * ab;
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    load_adj(scratch, adj_b, ab, c0, true);
    gemm_tile(dcct + col0, A, false, Dp, ab, scratch, scratch, kLdT, ab, s.stage,
              [&](int r, int c, float v) { w32[(size_t)r * A + col0 + c0 + c] += v; });
    __syncthreads();
  }
  MARK(3);

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
  MARK(4);

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
  MARK(5);

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
  MARK(6);
}

// ---- the bf16 backward on tiles: one block per 64-atom tile, a cluster per bin ----

constexpr int kTileLdW = kTile + 4;                // fp32 row stride of a tile's cotangents
constexpr int kCentreDs = (kWalkMaxDp + 31) / 32;  // features of a centre per lane (D <= 160)

struct TileSmem {
  bf16* ring;    // kRing x Dp x kKc: kb's parts
  bf16* bop;     // Dp x kLdT: the dpre tile; then a copy of another tile's rnd(dcct)
  bf16* dc;      // Dp x kLdT: rnd(dcct), read by the cluster's transposes
  bf16* adjb;    // kTile x kLdT: a block of the cis/trans adjacency
  float* w32x;   // Dp x kTileLdW: dx' + dcct, then + the transposes
  float* w32t;   // Dp x kTileLdW: dtet, read by the cluster's centres
  float* part;   // 2 mb: this tile's partial sums of the equilibration's backward
  InjSmem s;     // the bin's tables (row0, row1: this tile's 64 columns)
};

size_t tile_smem_bytes(int Dp, int mb, int ab, int Tc) {
  return ((size_t)kRing * Dp * kKc + (2 * (size_t)Dp + kTile) * kLdT) * sizeof(bf16) +
         (2 * (size_t)Dp * kTileLdW + 6 * (size_t)mb + 2 * kTile) * sizeof(float) +
         (2 * (size_t)ab + 8 * (size_t)Tc) * sizeof(int);
}

__device__ TileSmem carve_tiles(unsigned char* base, int Dp, int mb, int ab, int Tc) {
  TileSmem t;
  bf16* h = reinterpret_cast<bf16*>(base);
  t.ring = h; h += (size_t)kRing * Dp * kKc;
  t.bop = h; h += (size_t)Dp * kLdT;
  t.dc = h; h += (size_t)Dp * kLdT;
  t.adjb = h; h += (size_t)kTile * kLdT;
  float* f = reinterpret_cast<float*>(h);
  t.w32x = f; f += (size_t)Dp * kTileLdW;
  t.w32t = f; f += (size_t)Dp * kTileLdW;
  t.part = f; f += 2 * mb;
  t.s.stage = nullptr;
  t.s.bias = nullptr;
  t.s.scratch = nullptr;
  t.s.msum = f; f += 4 * mb;
  t.s.row0 = f; f += kTile;
  t.s.row1 = f; f += kTile;
  int* q = reinterpret_cast<int*>(f);
  t.s.molof = q; q += ab;
  t.s.head = q; q += ab;
  t.s.next = q; q += 4 * Tc;
  t.s.cols = q;
  return t;
}

// As inject_bwd_kernel (bf16), one block per 64-atom tile, grid nb * C,
// clusters of C = ab / 64: kbs is kb's x', cct and tet parts (Dp x Dp each)
// in the walk's stream order (ops/bin_inject.py::kb_stream); ch the bin's
// centre scratch (nb, 4, Tc, Dp) fp32; no other scratch.
__global__ void __launch_bounds__(kWalkThreads, 1)
inject_bwd_tile_kernel(const bf16* __restrict__ x, const float* __restrict__ tca,
                       const int8_t* __restrict__ pool, const int* __restrict__ tbin,
                       const float* __restrict__ anyt_p, const int8_t* __restrict__ sadj,
                       const bf16* __restrict__ kbs, const bf16* __restrict__ xct,
                       const bf16* __restrict__ dpre, float* __restrict__ ch,
                       bf16* __restrict__ dx, int D, int Dp, int A, int mb, int ab, int Tc) {
  namespace cgr = cooperative_groups;
  cgr::cluster_group cluster = cgr::this_cluster();
  const int C = ab / kTile, rank = (int)cluster.block_rank();
  const int bin = blockIdx.x / C, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t col0 = (size_t)bin * ab, cc = col0 + (size_t)rank * kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const TileSmem t = carve_tiles(smem, Dp, mb, ab, Tc);
  const InjSmem& s = t.s;
  float* chb = ch + (size_t)bin * 4 * Tc * Dp;
  const float anyt = *anyt_p;
  MARK(0);

  // kb's parts through the ring; the dpre tile into bop; the bin's tables
  Ring ring{kbs, t.ring, Dp * kKc, 3 * kpad(Dp) / kKc, 0, 0};
  ring.start();
  for (int e = threadIdx.x; e < Dp * (kTile / 8); e += kWalkThreads) {
    const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
    cp_async16(t.bop + r * kLdT + c, dpre + (size_t)r * A + cc + c);
  }
  cp_async_commit();
  setup_bin<bf16>(s, x, pool, tbin, nullptr, Dp, A, mb, ab, Tc, bin);
  cp_async_wait<0>();
  __syncthreads();
  MARK(1);

  // [dx'; dcct; dtet] = kb dpre in fp32: dx' + dcct and dtet kept, rnd(dcct) to dc
  float acc[2][4][4];
  ring_product(ring, Dp, Dp, t.bop, t.bop, Dp, acc);
  epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(t.w32x + r * kTileLdW + c) = make_float2(v0, v1);
  });
  ring_product(ring, Dp, Dp, t.bop, t.bop, Dp, acc);
  epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
    float2* p = reinterpret_cast<float2*>(t.w32x + r * kTileLdW + c);
    const float2 o = *p;
    *p = make_float2(o.x + v0, o.y + v1);
    st2(t.dc, r, c, v0, v1);
  });
  ring_product(ring, Dp, Dp, t.bop, t.bop, Dp, acc);
  epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(t.w32t + r * kTileLdW + c) = make_float2(v0, v1);
  });
  cluster.sync();  // every tile's rnd(dcct) and dtet are in place
  MARK(2);

  // dx' += rnd(dcct) S over the bin, source tiles in rank order
  zero(acc);
  cluster_transpose(cluster, t.dc, t.bop, t.adjb, sadj + (size_t)bin * ab * ab, ab, Dp, acc);
  epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
    float2* p = reinterpret_cast<float2*>(t.w32x + r * kTileLdW + c);
    const float2 o = *p;
    *p = make_float2(o.x + v0, o.y + v1);
  });
  MARK(3);

  // each centre of the bin (one warp; the centres spread over the cluster):
  // the cotangent d_e_k of its neighbours' embeddings, into the scratch.  A
  // lane holds features lane, lane + 32, ... of the four neighbours' x'
  // (from xct) and m dtet (from the owning tile) for the three passes.
  for (int ct = rank * kWarps + warp; ct < Tc; ct += C * kWarps) {
    int col[4];
    bool any = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      col[k] = s.cols[k * Tc + ct];
      any |= col[k] >= 0;
    }
    if (!any) continue;
    float e[kCentreDs][4], dc[kCentreDs][4], ss[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* rt = nullptr;
      float mk = 0.0f;
      if (col[k] >= 0) {
        rt = cluster.map_shared_rank(t.w32t, col[k] / kTile) + col[k] % kTile;
        mk = col_mask(s, anyt, col[k]);
      }
#pragma unroll
      for (int i = 0; i < kCentreDs; ++i) {
        const int d = lane + 32 * i;
        const bool in = d < D && col[k] >= 0;
        e[i][k] = in ? to_f(xct[(size_t)d * A + col0 + col[k]]) : 0.0f;
        dc[i][k] = in ? rt[d * kTileLdW] * mk : 0.0f;
        ss[k] += e[i][k] * e[i][k];
      }
    }
    float mags[4], mc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      mags[k] = sqrtf(warp_sum(ss[k]));
      mc[k] = fmaxf(mags[k], 1e-8f);
    }
    const float th = tanhf((mags[0] + mags[1] + mags[2] + mags[3]) * (1.0f / 12.0f));
    const float scale = th * anyt;
    // dscale = sum_k dchir_k P_k
    float ds = 0.0f;
#pragma unroll
    for (int i = 0; i < kCentreDs; ++i) {
      float eN[4], sq[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        eN[k] = e[i][k] / mc[k];
        sq[k] = eN[k] * eN[k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) ds += dc[i][k] * poly(eN, sq, k);
    }
    const float du = warp_sum(ds) * (1.0f - th * th) * anyt * (1.0f / 12.0f);
    float pm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kCentreDs; ++i) {
      float eN[4], sq[4], dP[4], dEt[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        eN[k] = e[i][k] / mc[k];
        sq[k] = eN[k] * eN[k];
        dP[k] = dc[i][k] * scale;
      }
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
#pragma unroll
    for (int i = 0; i < kCentreDs; ++i) {
      const int d = lane + 32 * i;
      if (d >= D) break;
      float eN[4], sq[4], dP[4], dEt[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        eN[k] = e[i][k] / mc[k];
        sq[k] = eN[k] * eN[k];
        dP[k] = dc[i][k] * scale;
      }
      poly_bwd(eN, sq, dP, dEt);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (col[k] >= 0) chb[((size_t)k * Tc + ct) * Dp + d] = dEt[k] / mc[k] + dmags[k] * eN[k];
    }
  }
  __threadfence();
  cluster.sync();  // every centre's d_e is in the scratch; the reads of dtet are done
  MARK(4);

  // dx' = (dx' + dcct + the transposes) + (m dtet + the centres' d_e) on the
  // tile's columns; rows 0/1 kept for the equilibration, the others are dx.
  // A thread keeps one column: its first kEnt entries (col_sum's order) in
  // registers, so its rows' loads of the scratch are independent.
  constexpr int kEnt = 4, kRowStep = kWalkThreads / kTile;
  {
    const int c = threadIdx.x % kTile, a = rank * kTile + c;
    const float mask = col_mask(s, anyt, a);
    int ent[kEnt], ne = 0, more = s.head[a];
    while (more >= 0 && ne < kEnt) {
      ent[ne++] = more;
      more = s.next[more];
    }
#pragma unroll 4
    for (int r = threadIdx.x / kTile; r < D; r += kRowStep) {
      float cs = 0.0f;
#pragma unroll
      for (int j = 0; j < kEnt; ++j)
        if (j < ne) cs += chb[(size_t)ent[j] * Dp + r];
      for (int j = more; j >= 0; j = s.next[j]) cs += chb[(size_t)j * Dp + r];
      const float v = t.w32x[r * kTileLdW + c] + (t.w32t[r * kTileLdW + c] * mask + cs);
      if (r == 0)
        s.row0[c] = v;
      else if (r == 1)
        s.row1[c] = v;
      else
        dx[(size_t)r * A + cc + c] = from_f<bf16>(v);
    }
  }
  __syncthreads();
  MARK(5);

  // the equilibration's backward: this tile's per-molecule partial sums,
  // their sums over the bin in rank order, then rows 0/1
  for (int m = warp; m < mb; m += kWarps) {
    float sq = 0.0f, sf = 0.0f;
    for (int c = lane; c < kTile; c += 32) {
      const int a = rank * kTile + c;
      if (s.molof[a] == m) {
        const Charge chg = charge_at(s, x, tca, A, mb, col0, a);
        const float dqn = s.row0[c];
        sq += dqn * chg.fnew;
        sf += (s.row1[c] + dqn * chg.dQ) * chg.f0;
      }
    }
    sq = warp_sum(sq);
    sf = warp_sum(sf);
    if (lane == 0) {
      t.part[m] = sq;
      t.part[mb + m] = sf;
    }
  }
  cluster.sync();
  for (int m = threadIdx.x; m < mb; m += kWalkThreads) {
    float sq = 0.0f, sf = 0.0f;
    for (int r = 0; r < C; ++r) {
      const float* p = cluster.map_shared_rank(t.part, r);
      sq += p[m];
      sf += p[mb + m];
    }
    const float F = s.msum[mb + m];
    s.msum[2 * mb + m] = -sq;            // d sum q
    s.msum[3 * mb + m] = -sf / (F * F);  // dF (F's clip never binds)
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kTile; c += kWalkThreads) {
    const int a = rank * kTile + c;
    const Charge chg = charge_at(s, x, tca, A, mb, col0, a);
    const int m = s.molof[a];
    const float dqn = s.row0[c];
    const float dfn = s.row1[c] + dqn * chg.dQ;
    const float dq = dqn + (m >= 0 ? s.msum[2 * mb + m] : 0.0f);
    float df = dfn * chg.inv + (m >= 0 ? s.msum[3 * mb + m] : 0.0f);
    if (!(to_f(x[(size_t)A + col0 + a]) >= 1e-6f)) df = 0.0f;  // the clip binds
    dx[cc + c] = from_f<bf16>(dq);
    dx[(size_t)A + cc + c] = from_f<bf16>(df);
  }
  MARK(6);
  cluster.sync();  // the other tiles' reads of this block's partials are done
}

// ---- the bf16 forward on tiles: one block per 64-atom tile, no cluster ----

struct FwdTileSmem {
  bf16* xct;     // 3 Dp x kLdT: the tile's x', cct and tet (the projection's B operand)
  bf16* xs[2];   // Dp x kLdT each: x' chunks of the cis/trans product; then pre
  bf16* adjb[2];  // kTile x kLdT each: blocks of the cis/trans adjacency
  bf16* ring;    // kRing x Dp x kKc: kb^T
  float* delta;  // kTile x (Dp + 1): each column's sum of its entries' polynomials
  float* cen;    // 5 Tc: each centre's clipped norms (4) and scale
  int* rank;     // 4 Tc: an entry's place in its column's sum (col_sum's order), -1 off the tile
  InjSmem s;     // the bin's tables and sums, the bias
};

size_t fwd_tile_smem_bytes(int Dp, int mb, int ab, int Tc) {
  return ((size_t)5 * Dp * kLdT + 2 * kTile * kLdT + (size_t)kRing * Dp * kKc) * sizeof(bf16) +
         ((size_t)kTile * (Dp + 1) + 5 * (size_t)Tc + 2 * (size_t)mb + Dp) * sizeof(float) +
         (2 * (size_t)ab + 12 * (size_t)Tc + 1) * sizeof(int);
}

__device__ FwdTileSmem carve_fwd_tiles(unsigned char* base, int Dp, int mb, int ab, int Tc) {
  FwdTileSmem t;
  bf16* h = reinterpret_cast<bf16*>(base);
  t.xct = h; h += (size_t)3 * Dp * kLdT;
  t.xs[0] = h; h += (size_t)Dp * kLdT;
  t.xs[1] = h; h += (size_t)Dp * kLdT;
  t.adjb[0] = h; h += (size_t)kTile * kLdT;
  t.adjb[1] = h; h += (size_t)kTile * kLdT;
  t.ring = h; h += (size_t)kRing * Dp * kKc;
  float* f = reinterpret_cast<float*>(h);
  t.delta = f; f += (size_t)kTile * (Dp + 1);
  t.cen = f; f += 5 * Tc;
  t.s.stage = nullptr;
  t.s.row0 = nullptr;
  t.s.row1 = nullptr;
  t.s.scratch = nullptr;
  t.s.msum = f; f += 2 * mb;
  t.s.bias = f; f += Dp;
  int* q = reinterpret_cast<int*>(f);
  t.s.molof = q; q += ab;
  t.s.head = q; q += ab;
  t.s.next = q; q += 4 * Tc;
  t.s.cols = q; q += 4 * Tc;
  t.rank = q;  // then the passes' count
  return t;
}

// As inject_fwd_kernel (bf16), one block per 64-atom tile, grid nb * ab / 64:
// kbs is kb^T (Dp x 3Dp) in the walk's stream order
// (ops/bin_inject.py::kbT_stream), bias b (Dp); xct receives the tile's
// [x'; cct; tet] columns unless it is null.
__global__ void __launch_bounds__(kWalkThreads, 1)
inject_fwd_tile_kernel(const bf16* __restrict__ x, const float* __restrict__ tca,
                       const int8_t* __restrict__ pool, const int* __restrict__ tbin,
                       const float* __restrict__ anyt_p, const int8_t* __restrict__ sadj,
                       const bf16* __restrict__ kbs, const bf16* __restrict__ bias,
                       bf16* __restrict__ pre, bf16* __restrict__ xct, int D, int Dp, int A,
                       int mb, int ab, int Tc) {
  const int C = ab / kTile, bin = blockIdx.x / C, rank = blockIdx.x % C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t col0 = (size_t)bin * ab, cc = col0 + (size_t)rank * kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdTileSmem t = carve_fwd_tiles(smem, Dp, mb, ab, Tc);
  const InjSmem& s = t.s;
  bf16* XP = t.xct;
  bf16* CCT = XP + (size_t)Dp * kLdT;
  bf16* TET = CCT + (size_t)Dp * kLdT;
  const float anyt = *anyt_p;
  MARK(0);

  // kb^T through the ring; the bin's tables, its per-molecule sums, b
  Ring ring{kbs, t.ring, Dp * kKc, kpad(3 * Dp) / kKc, 0, 0};
  ring.start();
  setup_bin<bf16>(s, x, pool, tbin, bias, Dp, A, mb, ab, Tc, bin);
  MARK(1);

  // x' of source chunk `chunk` into dst: rows >= 2 from x by cp.async
  // (rows past D zero-filled), rows 0/1 equilibrated
  auto load_xp = [&](bf16* dst, int chunk) {
    const bf16* xc = x + col0 + (size_t)chunk * kTile;
    for (int e = threadIdx.x; e < (Dp - 2) * (kTile / 8); e += kWalkThreads) {
      const int r = 2 + e / (kTile / 8), c = e % (kTile / 8) * 8;
      const bool in = r < D;
      cp_async16(dst + r * kLdT + c, in ? xc + (size_t)r * A + c : x, in ? 16 : 0);
    }
    for (int c = threadIdx.x; c < kTile; c += kWalkThreads) {
      const Charge cg = charge_at(s, x, tca, A, mb, col0, chunk * kTile + c);
      dst[c] = from_f<bf16>(cg.qnew);
      dst[kLdT + c] = from_f<bf16>(cg.fnew);
    }
  };

  // cct = x' + rnd(x' S^T): the bin's x' 64 source atoms a chunk (the tile's
  // own chunk is XP), double-buffered, as the walk's aggregation
  const int8_t* adj_b = sadj + (size_t)bin * ab * ab;
  float acc[2][4][4];
  zero(acc);
  load_xp(XP, rank);
  if (rank != 0) load_xp(t.xs[0], 0);
  cp_async_commit();
  adj_store(t.adjb[0], adj_load(adj_b, ab, rank * kTile, 0));
  for (int c = 0; c < C; ++c) {
    int4 next_adj = make_int4(0, 0, 0, 0);
    if (c + 1 < C) {
      if (c + 1 != rank) load_xp(t.xs[(c + 1) & 1], c + 1);
      next_adj = adj_load(adj_b, ab, rank * kTile, (c + 1) * kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (c == 0) MARK(2);
    smem_product(c == rank ? XP : t.xs[c & 1], t.adjb[c & 1], true, Dp, acc);
    if (c + 1 < C) adj_store(t.adjb[(c + 1) & 1], next_adj);
    __syncthreads();
  }
  epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
    const float2 xp = ld2(XP, r, c);
    st2(CCT, r, c, xp.x + rnd<bf16>(v0), xp.y + rnd<bf16>(v1));
  });
  MARK(3);

  // x' at row d < D of bin column col: the tile's own from shared memory,
  // another tile's from x (rows 0/1 equilibrated and rounded, as XP holds them)
  auto xp_at = [&](int d, int col) -> float {
    const int l = col - rank * kTile;
    if ((unsigned)l < (unsigned)kTile) return to_f(XP[d * kLdT + l]);
    if (d >= 2) return to_f(x[(size_t)d * A + col0 + col]);
    const Charge cg = charge_at(s, x, tca, A, mb, col0, col);
    return rnd<bf16>(d == 0 ? cg.qnew : cg.fnew);
  };

  // each entry naming one of the tile's columns: its place in the column's
  // sum (col_sum's order: the last entry first), the number of passes
  int* n_pass = t.rank + 4 * Tc;
  if (threadIdx.x == 0) *n_pass = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < 4 * Tc; e += kWalkThreads) {
    const int c = s.cols[e];
    int place = -1;
    if (c >= 0 && c / kTile == rank) {  // e's place in its column's list, from the head
      place = 0;
      for (int j = s.head[c]; j != e; j = s.next[j]) ++place;
      atomicMax(n_pass, place + 1);
    }
    t.rank[e] = place;
  }
  for (int e = threadIdx.x; e < kTile * (Dp + 1); e += kWalkThreads) t.delta[e] = 0.0f;
  __syncthreads();

  // the clipped norms and the scale of every centre that touches the tile's
  // columns, one warp a centre (centre()'s sums, in its order)
  for (int ct = warp; ct < Tc; ct += kWarps) {
    int col[4];
    bool mine = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      col[k] = s.cols[k * Tc + ct];
      mine |= t.rank[k * Tc + ct] >= 0;
    }
    if (!mine) continue;
    float ss[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int d = lane; d < D; d += 32)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float e = col[k] >= 0 ? xp_at(d, col[k]) : 0.0f;
        ss[k] += e * e;
      }
    float mags[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) mags[k] = sqrtf(warp_sum(ss[k]));
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) t.cen[5 * ct + k] = fmaxf(mags[k], 1e-8f);
      t.cen[5 * ct + 4] =
          tanhf((mags[0] + mags[1] + mags[2] + mags[3]) * (1.0f / 12.0f)) * anyt;
    }
  }
  __syncthreads();

  // each entry's polynomial, one warp a centre, lanes over the features,
  // added into its column's delta pass by pass: in pass p the entries of
  // place p, so that no two warps add to one column at once and each column
  // sums its entries in col_sum's order
  const int passes = *n_pass;
  for (int p = 0; p < passes; ++p) {
    for (int ct = warp; ct < Tc; ct += kWarps) {
      int col[4];
      bool now = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        col[k] = s.cols[k * Tc + ct];
        now |= t.rank[k * Tc + ct] == p;
      }
      if (!now) continue;
      const float* cn = t.cen + 5 * ct;
      for (int d = lane; d < D; d += 32) {
        float eN[4], sq[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          eN[k] = (col[k] >= 0 ? xp_at(d, col[k]) : 0.0f) / cn[k];
          sq[k] = eN[k] * eN[k];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (t.rank[k * Tc + ct] == p)
            t.delta[(col[k] - rank * kTile) * (Dp + 1) + d] += poly(eN, sq, k) * cn[4];
      }
    }
    __syncthreads();
  }
  MARK(4);

  // tet = m (x' + rnd(delta))
  for (int e = threadIdx.x; e < Dp * kTile; e += kWalkThreads) {
    const int r = e / kTile, c = e % kTile;
    float v = 0.0f;
    if (r < D)
      v = rnd<bf16>(to_f(XP[r * kLdT + c]) + rnd<bf16>(t.delta[c * (Dp + 1) + r])) *
          rnd<bf16>(col_mask(s, anyt, rank * kTile + c));
    TET[r * kLdT + c] = from_f<bf16>(v);
  }
  __syncthreads();
  MARK(5);
  if (xct) store_slab(xct, A, cc, XP, 3 * Dp);

  // pre = rnd(rnd(kb^T [x'; cct; tet]) + b), staged in xs[0] for 16-byte stores
  ring_product(ring, Dp, 3 * Dp, XP, XP, 3 * Dp, acc);
  bf16* PRE = t.xs[0];
  epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
    const float b = s.bias[r];
    st2(PRE, r, c, rnd<bf16>(rnd<bf16>(v0) + b), rnd<bf16>(rnd<bf16>(v1) + b));
  });
  __syncthreads();
  for (int e = threadIdx.x; e < D * (kTile / 8); e += kWalkThreads) {
    const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
    *reinterpret_cast<int4*>(pre + (size_t)r * A + cc + c) =
        *reinterpret_cast<const int4*>(PRE + r * kLdT + c);
  }
  MARK(6);
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

bool tiles_fit(int Dp, int mb, int ab, int Tc) {
  return Dp % 16 == 0 && Dp <= kWalkMaxDp && ab % kTile == 0 && ab / kTile >= 1 &&
         ab / kTile <= kWalkMaxCluster && tile_smem_bytes(Dp, mb, ab, Tc) <= (size_t)kSmemLimit;
}

bool tiles_configured[kMaxDevices];

int launch_tiles(const void* x, const void* tca, const void* pool, const void* tbin,
                 const void* anyt, const void* sadj, const void* kbs, const void* xct,
                 const void* dpre, void* ch, void* dx, int D, int Dp, int A, int nb, int mb,
                 int ab, int Tc, cudaStream_t st) {
  if (!tiles_fit(Dp, mb, ab, Tc) || D < 2 || D > Dp || A != nb * ab)
    return (int)cudaErrorInvalidValue;
  const int err = configure(inject_bwd_tile_kernel, tiles_configured);
  if (err) return err;
  const int C = ab / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * C);
  cfg.blockDim = dim3(kWalkThreads);
  cfg.dynamicSmemBytes = tile_smem_bytes(Dp, mb, ab, Tc);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, inject_bwd_tile_kernel, static_cast<const bf16*>(x), static_cast<const float*>(tca),
      static_cast<const int8_t*>(pool), static_cast<const int*>(tbin),
      static_cast<const float*>(anyt), static_cast<const int8_t*>(sadj),
      static_cast<const bf16*>(kbs), static_cast<const bf16*>(xct), static_cast<const bf16*>(dpre),
      static_cast<float*>(ch), static_cast<bf16*>(dx), D, Dp, A, mb, ab, Tc);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool fwd_tiles_fit(int Dp, int mb, int ab, int Tc) {
  return Dp % 16 == 0 && Dp <= kWalkMaxDp && ab % kTile == 0 && ab / kTile >= 1 &&
         ab / kTile <= kWalkMaxCluster &&
         fwd_tile_smem_bytes(Dp, mb, ab, Tc) <= (size_t)kSmemLimit;
}

bool fwd_tiles_configured[kMaxDevices];

int launch_fwd_tiles(const void* x, const void* tca, const void* pool, const void* tbin,
                     const void* anyt, const void* sadj, const void* kbs, const void* bias,
                     void* pre, void* xct, int D, int Dp, int A, int nb, int mb, int ab, int Tc,
                     cudaStream_t st) {
  if (!fwd_tiles_fit(Dp, mb, ab, Tc) || D < 2 || D > Dp || A != nb * ab)
    return (int)cudaErrorInvalidValue;
  const int err = configure(inject_fwd_tile_kernel, fwd_tiles_configured);
  if (err) return err;
  inject_fwd_tile_kernel<<<nb * (ab / kTile), kWalkThreads, fwd_tile_smem_bytes(Dp, mb, ab, Tc),
                           st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(tca),
      static_cast<const int8_t*>(pool), static_cast<const int*>(tbin),
      static_cast<const float*>(anyt), static_cast<const int8_t*>(sadj),
      static_cast<const bf16*>(kbs), static_cast<const bf16*>(bias), static_cast<bf16*>(pre),
      static_cast<bf16*>(xct), D, Dp, A, mb, ab, Tc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of the tiled bf16 forward at these shapes, or -1 where it
// does not take them (the wrapper then launches inject_fwd).
long long inject_fwd_tiles_smem_bytes(int Dp, int mb, int ab, int Tc) {
  return fwd_tiles_fit(Dp, mb, ab, Tc) ? (long long)fwd_tile_smem_bytes(Dp, mb, ab, Tc) : -1;
}

// The tiled bf16 forward (inject_fwd_tile_kernel): pre (D, A) from x, kb^T's
// stream kbs and the bias b (Dp); xct (3Dp, A) receives [x'; cct; tet]
// unless it is null.  Returns cudaGetLastError() after the launch.
int inject_fwd_tiles(const void* x, const void* tca, const void* pool, const void* tbin,
                     const void* anyt, const void* sadj, const void* kbs, const void* bias,
                     void* pre, void* xct, int D, int Dp, int A, int nb, int mb, int ab, int Tc,
                     void* stream) {
  return launch_fwd_tiles(x, tca, pool, tbin, anyt, sadj, kbs, bias, pre, xct, D, Dp, A, nb, mb,
                          ab, Tc, static_cast<cudaStream_t>(stream));
}

// Shared memory of the tiled bf16 backward at these shapes, or -1 where it
// does not take them (the wrapper then launches inject_bwd).
long long inject_bwd_tiles_smem_bytes(int Dp, int mb, int ab, int Tc) {
  return tiles_fit(Dp, mb, ab, Tc) ? (long long)tile_smem_bytes(Dp, mb, ab, Tc) : -1;
}

// The tiled bf16 backward (inject_bwd_tile_kernel): dx (D, A) from xct,
// dpre and kb's stream kbs; ch the centres' scratch.  Returns
// cudaGetLastError() after the launch.
int inject_bwd_tiles(const void* x, const void* tca, const void* pool, const void* tbin,
                     const void* anyt, const void* sadj, const void* kbs, const void* xct,
                     const void* dpre, void* ch, void* dx, int D, int Dp, int A, int nb, int mb,
                     int ab, int Tc, void* stream) {
  return launch_tiles(x, tca, pool, tbin, anyt, sadj, kbs, xct, dpre, ch, dx, D, Dp, A, nb, mb,
                      ab, Tc, static_cast<cudaStream_t>(stream));
}

#ifdef INJECT_MARKS
// Points the kernels' phase marks at marks ((blocks, 8) uint64).
int inject_bwd_marks(void* marks) {
  return (int)cudaMemcpyToSymbol(g_marks, &marks, sizeof(marks));
}
#endif

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
