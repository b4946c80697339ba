// Fused message-passing stack, backward, for the bin-packed layout.
//
// Replaces the TPU kernel aimnet_x2d_tpu/ops/bin_mp.py::_make_stack_op
// (bwd_kernel :659, pallas_call of ``backward_call`` :869) in its save_xs
// form, with the proj=True fold (kernel 1c) and in-kernel dropout; at one
// layer it is kernel 1d's backward (binned_mp_layer_t :1278,
// binned_mp_layer :927).  The forward (csrc/mp_stack.cu, training form)
// saved every layer's input; here, per layer l = L-1 .. 0, the walk
//
//   1. recomputes the layer from its saved input (grad_only: no skip
//      product, no last block output): xa = [x ; adj x], t = W_in xa + b_in,
//      h0 = act(t), u_i = W1_i h_i + b1_i, v_i = drop(act(u_i)),
//      h_{i+1} = W2_i v_i + b2_i + h_i;
//   2. walks back with the JAX cast points: g = rnd(g32);
//      du_i = rnd(drop(rnd(W2_i^T dh_{i+1})) * rnd(act'(u_i)));
//      dh_i = rnd(dh_{i+1} + W1_i^T du_i); dt = rnd(dh_0 * rnd(act'(t)));
//      dxa = [W_s^T | W_in^T] [g ; dt] in fp32;
//   3. adds the input cotangent to the fp32 carry, residual included:
//      g32 += dxa[:Dp] + rnd(dxa[Dp:]) adj  (the aggregation's transpose).
//
// It writes the per-atom operands of the weight gradients (xa, h_i, v_i
// and the cotangents g, dh_i, du_i, dt) to slabs of a work buffer, and the
// grouped split-K contraction of csrc/wgrad_group.cuh then forms the fp32
// weight and bias gradients of the layer's six products in one launch,
// chunk partials summed in a fixed order by one more (deterministic; no
// atomics).  With the fold, mp_stack_bwd_proj finally recomputes
// t0 = rnd(kb^T emb) + bb, forms dt0 = g32 * act'(t0) (kept in fp32 for the
// bias gradient) and demb = rnd(kb rnd(dt0)).
//
// The bf16 walk (bwd_walk_kernel, csrc/walk.cuh: one block per 64-atom
// tile, the tiles of a bin one cluster, the chain in shared memory, weights
// streamed by cp.async, mma.sync) takes Dp <= 160 and ab <= 512 while its
// buffers fit one block's shared memory; fp32, and bf16 shapes past those
// limits, take bwd_layer_kernel, the CUDA-core (fp32) or wmma (bf16) walk of
// one block per bin over slabs (fp32 tiles would take twice the shared
// memory).
//
// Embedding fold (mp_stack_bwd_proj_vocab, kernel 1c-vocab: the TPU op's
// vocab_sizes backward, bin_mp.py:726-746).  The walk is unchanged; the
// fold's backward looks each 64-atom tile's embeddings up from the codes
// into shared memory (csrc/vocab.cuh) to recompute t0, forms dt0 and
// rnd(dt0) as above, then rnd(kb rnd(dt0)) into the same shared tile
// instead of a global demb, and one thread per table row adds each atom's
// value at its code into the bin's compact d_bd partial, atoms in order.
// There is no dx (codes have no cotangent).  d_kb is a gathered product of
// the grouped contraction; the bin partials are summed in bin order.
//
// The fold's backward on wgmma (proj_bwd_wg_kernel, bf16, Dp 64, 128 or
// 160, E 128 or 256; both forms).  bwd_proj_kernel spent, on an H100 at the
// training shape (-DMP_STACK_BWD_MARKS), 63% of a block in kb^T emb with
// its epilogue (its warps' clocks 43% in the epilogue: g32 read, dt0 and
// dtc written, in HBM) and 37% in kb dtc (91% the wmma products, kb read
// from L2 for each 16-row strip); the fold's kernel a quarter more in its
// lookup.  What bounds the function is its bytes (emb and g32 read, demb
// and dtc written: ~98 MB, ~0.03 ms at the training shape).  The design:
// - both products on wgmma with a tile's 64 atoms as M: t0^T = emb^T kb
//   (N = Dp, K = E; emb's tile MN-major) and demb^T = dtc^T kb^T (N = E in
//   halves of 128, one accumulator at a time, K = Dp; dtc K-major, written
//   so by the first epilogue);
// - one resident copy of kb in core matrices of 8 d by 8 consecutive e
//   (bin_mp.py::proj_wg_index), read K-major by the first product and
//   MN-major by the second (wgmma's transpose bit for B);
// - persistent blocks, one an SM, over the tiles in a static order; two
//   consumer warpgroups, each on half of a tile's features (kb^T emb) and
//   half its e (kb dtc), so eight warps share the epilogues (the first
//   build, one consumer warpgroup of four warps, spent 58% of its time in
//   the first epilogue), and a producer warpgroup: one warp lands kb once
//   and each tile's g32 rows by bulk copies on an mbarrier (rows padded to
//   68 floats, so the epilogue's reads meet no bank conflict; two buffers
//   where they fit, each then staging its tile's demb), three warps
//   fill emb's tile as its buffer frees (cp.async; under the fold looked
//   up from the code rows, bit-equal to the emb form, each feature's codes
//   sorted for the accumulation);
// - the epilogues on the accumulators at _proj_bwd_plain's cast points;
//   dt0 is summed over each tile's atoms into the block's rows for d_bb
//   (per-block partials in block order, so dt0 no longer goes back over g32
//   and the contraction reads no bias source), dtc stored for the
//   contraction (4 bytes a store, neighbouring lanes trading halves); demb
//   through a swizzled staging tile as 16-byte stores, or, under the fold, each run of
//   one code's demb rows summed in atom order into the block's compact
//   d_bd partial, a row and half the sorted atoms a task.
// No atomics: reruns are bit-equal.  d_kb stays the grouped contraction of
// dtc.  fp32 and the other shapes keep the kernels of one block a bin.
//
// Work slabs (Dp, A) of wk, in order: xa (two: x rows, agg rows), h_i,
// v_i, dh_i (dh_{n-1} = g), du_i, dt -- what the contraction reads; then,
// for bwd_layer_kernel only, t, u_i and the agg-part cotangent dA.

#include "common.cuh"
#include "ring.cuh"
#include "vocab.cuh"
#include "walk.cuh"
#include "wgmma.cuh"
#include "wgrad.cuh"
#include "wgrad_group.cuh"

namespace {

// Built with -DMP_STACK_BWD_MARKS, the fold's backward kernels (bwd_proj_kernel,
// bwd_proj_vocab_kernel and proj_bwd_wg_kernel) sum, per block, the time of
// each phase over the block's tiles, read from %globaltimer after a block
// barrier, and write them as cumulative marks (mark 0 the block's start,
// then kProjPhases phase sums); from mark 8 on, the two products' SM clocks
// summed over the warps (bwd_proj*_kernel: each strip's product and its
// epilogue, as csrc/mp_ext.cu clocks them; proj_bwd_wg_kernel: its phases'
// clocks, see there).  chip_smoke.py's "mp_stack_bwd_proj phases" lines
// read them (mp_stack_bwd_marks).
#ifdef MP_STACK_BWD_MARKS
constexpr int kProjMarks = 16;  // marks a block may record
constexpr int kProjPhases = 6;  // the start, the lookup, kb^T emb with its epilogue, kb dtc
                                // with its epilogue, the table accumulation, the partials' store
__device__ unsigned long long* g_proj_marks;  // (blocks, kProjMarks), set by mp_stack_bwd_marks
__shared__ unsigned long long proj_clk[4];     // the products' and epilogues' clocks
__device__ __forceinline__ unsigned long long proj_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Thread 0's phase sums.
struct ProjMarks {
  unsigned long long t0, last, acc[kProjPhases];
  __device__ void start() {
    if (threadIdx.x < 4) proj_clk[threadIdx.x] = 0;
    if (threadIdx.x == 0) {
      t0 = last = proj_now();
      for (int k = 0; k < kProjPhases; ++k) acc[k] = 0;
    }
  }
  __device__ void phase(int k) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned long long t = proj_now();
      acc[k] += t - last;
      last = t;
    }
  }
  __device__ void write() {
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long* m = g_proj_marks + (size_t)blockIdx.x * kProjMarks;
      m[0] = t0;
      for (int k = 0; k < kProjPhases; ++k) m[k + 1] = m[k] + acc[k];
      for (int k = 0; k < 4; ++k) m[8 + k] = proj_clk[k];
    }
  }
};
// product p's clocks into proj_clk[2p] (the products), proj_clk[2p + 1] (the epilogues)
#define PROJ_EPI(p, ...) clocked<T>(proj_clk + 2 * (p), __VA_ARGS__)
#else
struct ProjMarks {
  __device__ void start() {}
  __device__ void phase(int) {}
  __device__ void write() {}
};
#define PROJ_EPI(p, ...) __VA_ARGS__
#endif

template <typename T>
size_t bwd_smem_bytes(int Dp, int ab, int n_blocks) {
  return (size_t)kWarps * 256 * sizeof(float) + (size_t)ab * kLdT * sizeof(T) +
         (size_t)(2 + 2 * n_blocks) * Dp * sizeof(T);
}

// One block per bin.  wk holds 5 * n_blocks + 5 slabs of (Dp, A), in the
// order at the top of this file.  w / wT point at this layer's prepped
// weights and their transposes ([W_s^T | W_in^T], then W1^T, W2^T per
// block).
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_layer_kernel(const T* __restrict__ x_l, T* wk, float* g32, const int8_t* __restrict__ adj,
                 const T* __restrict__ w, const T* __restrict__ wT, int D, int Dp, int A, int ab,
                 int n_blocks, int act, int dropout, int layer, unsigned seed, unsigned thresh,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  T* scratch = reinterpret_cast<T*>(smem + (size_t)kWarps * 256 * sizeof(float));
  T* bias = scratch + (size_t)ab * kLdT;
  const int bin = blockIdx.x;
  const size_t col0 = (size_t)bin * ab;
  const size_t S = (size_t)Dp * A;
  T* XA = wk;
  T* H = wk + 2 * S;
  T* Vs = H + n_blocks * S;
  T* DH = Vs + n_blocks * S;
  T* DU = DH + n_blocks * S;
  T* DT = DU + n_blocks * S;
  T* Tb = DT + S;
  T* U = Tb + S;
  T* DA = U + n_blocks * S;
  T* G = DH + (size_t)(n_blocks - 1) * S;

  const bool tiled = sizeof(T) == 2;
  const int K2 = 2 * Dp;
  const size_t mat2 = (size_t)Dp * K2, mat1 = (size_t)Dp * Dp;
  const size_t block_sz = 2 * mat1 + 2 * (size_t)Dp;
  const T* w_in = w;
  const T* w_s = w_in + mat2 + Dp;
  const T* blocks = w_s + mat2 + Dp;
  const int8_t* adj_b = adj + (size_t)bin * ab * ab;

  // x (zero-padded rows) into xa, and the layer's biases into shared memory
  constexpr int V = 16 / sizeof(T);
  for (int e = threadIdx.x; e < Dp * ab / V; e += kThreads) {
    const int r = e / (ab / V), c = e % (ab / V) * V;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < D) v = *reinterpret_cast<const int4*>(x_l + (size_t)r * A + col0 + c);
    *reinterpret_cast<int4*>(XA + (size_t)r * A + col0 + c) = v;
  }
  for (int e = threadIdx.x; e < (2 + 2 * n_blocks) * Dp; e += kThreads) {
    const int seg = e / Dp, r = e % Dp;
    const T* blk = blocks + (size_t)(seg / 2 - 1) * block_sz;
    const T* src = seg == 0 ? w_in + mat2 : seg == 1 ? w_s + mat2
                 : blk + (seg % 2 ? 2 * mat1 + Dp : mat1);
    bias[e] = src[r];
  }
  __syncthreads();

  // agg rows of xa: agg[:, i] = sum_j x[:, j] adj[i, j]
  T* AG = XA + (size_t)Dp * A;
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    for (int e = threadIdx.x; e < kTile * ab / 16; e += kThreads) {
      const int il = e / (ab / 16), j0 = e % (ab / 16) * 16;
      const int4 v = *reinterpret_cast<const int4*>(adj_b + (size_t)(c0 + il) * ab + j0);
      const int8_t* m = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int t = 0; t < 16; ++t) scratch[(size_t)(j0 + t) * kLdT + il] = from_f<T>((float)m[t]);
    }
    __syncthreads();
    gemm_tile(XA + col0, A, false, Dp, ab, scratch, scratch, kLdT, ab, stage,
              [&](int r, int c, float v) { AG[(size_t)r * A + col0 + c0 + c] = from_f<T>(v); });
    __syncthreads();
  }

  const T* b_in = bias;
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    const size_t cc = col0 + c0;
    // --- recompute (grad_only)
    gemm_tile(w_in, K2, tiled, Dp, K2, XA + cc, XA + cc, A, K2, stage, [&](int r, int c, float v) {
      const size_t o = (size_t)r * A + cc + c;
      const float t = rnd<T>(rnd<T>(v) + to_f(b_in[r]));
      Tb[o] = from_f<T>(t);
      H[o] = from_f<T>(act_fn(act, t));
    });
    __syncthreads();
    for (int i = 0; i < n_blocks; ++i) {
      const T* w1 = blocks + (size_t)i * block_sz;
      const T* w2 = w1 + mat1 + Dp;
      const T* b1 = bias + (2 + 2 * i) * Dp;
      const T* b2 = b1 + Dp;
      T* Hi = H + i * S;
      T* Ui = U + i * S;
      T* Vi = Vs + i * S;
      const unsigned mix = seed + (unsigned)(layer * n_blocks + i) * 0x9E3779B9u;
      gemm_tile(w1, Dp, tiled, Dp, Dp, Hi + cc, Hi + cc, A, Dp, stage, [&](int r, int c, float v) {
        const size_t o = (size_t)r * A + cc + c;
        const float u = rnd<T>(rnd<T>(v) + to_f(b1[r]));
        float a = act_fn(act, u);
        if (dropout) a = drop_keep(r, (unsigned)(cc + c), mix, thresh) ? rnd<T>(a) * scale : 0.0f;
        Ui[o] = from_f<T>(u);
        Vi[o] = from_f<T>(a);
      });
      __syncthreads();
      if (i + 1 < n_blocks) {
        T* Hn = Hi + S;
        gemm_tile(w2, Dp, tiled, Dp, Dp, Vi + cc, Vi + cc, A, Dp, stage, [&](int r, int c, float v) {
          const size_t o = (size_t)r * A + cc + c;
          Hn[o] = from_f<T>(rnd<T>(rnd<T>(v) + to_f(b2[r])) + to_f(Hi[o]));
        });
        __syncthreads();
      }
    }
    // --- walk back
    for (int e = threadIdx.x; e < Dp * kTile; e += kThreads) {
      const size_t o = (size_t)(e / kTile) * A + cc + e % kTile;
      G[o] = from_f<T>(g32[o]);
    }
    __syncthreads();
    for (int i = n_blocks - 1; i >= 0; --i) {
      const T* w1T = wT + 4 * mat1 + (size_t)i * 2 * mat1;
      const T* w2T = w1T + mat1;
      const T* Ui = U + i * S;
      T* DHi = DH + i * S;
      T* DUi = DU + i * S;
      const unsigned mix = seed + (unsigned)(layer * n_blocks + i) * 0x9E3779B9u;
      gemm_tile(w2T, Dp, tiled, Dp, Dp, DHi + cc, DHi + cc, A, Dp, stage, [&](int r, int c, float v) {
        const size_t o = (size_t)r * A + cc + c;
        float dv = rnd<T>(v);
        if (dropout) dv = drop_keep(r, (unsigned)(cc + c), mix, thresh) ? rnd<T>(dv * scale) : 0.0f;
        DUi[o] = from_f<T>(dv * rnd<T>(act_grad(act, to_f(Ui[o]))));
      });
      __syncthreads();
      gemm_tile(w1T, Dp, tiled, Dp, Dp, DUi + cc, DUi + cc, A, Dp, stage, [&](int r, int c, float v) {
        const size_t o = (size_t)r * A + cc + c;
        const float dh = rnd<T>(to_f(DHi[o]) + v);
        if (i > 0)
          DHi[o - S] = from_f<T>(dh);
        else
          DT[o] = from_f<T>(dh * rnd<T>(act_grad(act, to_f(Tb[o]))));
      });
      __syncthreads();
    }
    // dxa = [W_s^T | W_in^T] [g ; dt]: x rows to the carry, agg rows to dA
    gemm_tile(wT, K2, tiled, K2, K2, G + cc, DT + cc, A, Dp, stage, [&](int r, int c, float v) {
      if (r < Dp)
        g32[(size_t)r * A + cc + c] += v;
      else
        DA[(size_t)(r - Dp) * A + cc + c] = from_f<T>(v);
    });
    __syncthreads();
  }

  // g32[:, j] += sum_i dA[:, i] adj[i, j]
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    for (int e = threadIdx.x; e < ab * (kTile / 16); e += kThreads) {
      const int i = e / (kTile / 16), j0 = e % (kTile / 16) * 16;
      const int4 v = *reinterpret_cast<const int4*>(adj_b + (size_t)i * ab + c0 + j0);
      const int8_t* m = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int t = 0; t < 16; ++t) scratch[(size_t)i * kLdT + j0 + t] = from_f<T>((float)m[t]);
    }
    __syncthreads();
    gemm_tile(DA + col0, A, false, Dp, ab, scratch, scratch, kLdT, ab, stage,
              [&](int r, int c, float v) { g32[(size_t)r * A + col0 + c0 + c] += v; });
    __syncthreads();
  }
}

// The fold's backward, one block per bin: t0 = rnd(rnd(kb^T emb) + bb);
// g32 <- dt0 = g32 * rnd(act'(t0)) (fp32, for the bias gradient);
// dtc <- rnd(dt0); demb = rnd(kb dtc).  pw = [kb^T (Dp x E), bb], pwT = kb
// (E x Dp).
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_proj_kernel(const T* __restrict__ emb, float* g32, const T* __restrict__ pw,
                const T* __restrict__ pwT, T* dtc, T* demb, int Dp, int E, int A, int ab,
                int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  T* bias = reinterpret_cast<T*>(smem + (size_t)kWarps * 256 * sizeof(float));
  const size_t col0 = (size_t)blockIdx.x * ab;
  const bool tiled = sizeof(T) == 2;
  ProjMarks marks;
  marks.start();
  for (int e = threadIdx.x; e < Dp; e += kThreads) bias[e] = pw[(size_t)Dp * E + e];
  __syncthreads();
  marks.phase(0);
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    const size_t cc = col0 + c0;
    gemm_tile(pw, E, tiled, Dp, E, emb + cc, emb + cc, A, E, stage,
              PROJ_EPI(0, [&](int r, int c, float v) {
                const size_t o = (size_t)r * A + cc + c;
                const float t0 = rnd<T>(rnd<T>(v) + to_f(bias[r]));
                const float d = g32[o] * rnd<T>(act_grad(act, t0));
                g32[o] = d;
                dtc[o] = from_f<T>(d);
              }));
    __syncthreads();
    marks.phase(2);
    gemm_tile(pwT, Dp, tiled, E, Dp, dtc + cc, dtc + cc, A, Dp, stage,
              PROJ_EPI(1, [&](int r, int c, float v) {
                demb[(size_t)r * A + cc + c] = from_f<T>(v);
              }));
    __syncthreads();
    marks.phase(3);
  }
  marks.write();
}

// The fold's backward under the embedding fold, one block per bin: as
// bwd_proj_kernel with emb looked up per tile into shared memory, and the
// bin's compact d_bd partial (vocab_acc_size floats) in place of demb.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_proj_vocab_kernel(const int* __restrict__ codes, const T* __restrict__ bd, Vocab voc,
                      float* g32, const T* __restrict__ pw, const T* __restrict__ pwT, T* dtc,
                      float* part, int Dp, int E, int A, int ab, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  float* acc = stage + kWarps * 256;
  const size_t n_acc = (size_t)voc.Df * voc.SV;
  T* tile = reinterpret_cast<T*>(acc + ((n_acc + 31) / 32) * 32);  // E x kLdT
  T* bias = tile + (size_t)E * kLdT;
  const size_t col0 = (size_t)blockIdx.x * ab;
  const bool tiled = sizeof(T) == 2;
  ProjMarks marks;
  marks.start();
  for (int e = threadIdx.x; e < Dp; e += kThreads) bias[e] = pw[(size_t)Dp * E + e];
  for (size_t i = threadIdx.x; i < n_acc; i += kThreads) acc[i] = 0.0f;
  marks.phase(0);
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    const size_t cc = col0 + c0;
    vocab_tile(tile, codes, bd, voc, E, cc, A);
    __syncthreads();
    marks.phase(1);
    gemm_tile(pw, E, tiled, Dp, E, tile, tile, kLdT, E, stage,
              PROJ_EPI(0, [&](int r, int c, float v) {
                const size_t o = (size_t)r * A + cc + c;
                const float t0 = rnd<T>(rnd<T>(v) + to_f(bias[r]));
                const float d = g32[o] * rnd<T>(act_grad(act, t0));
                g32[o] = d;
                dtc[o] = from_f<T>(d);
              }));
    __syncthreads();
    marks.phase(2);
    gemm_tile(pwT, Dp, tiled, E, Dp, dtc + cc, dtc + cc, A, Dp, stage,
              PROJ_EPI(1, [&](int r, int c, float v) {
                tile[(size_t)r * kLdT + c] = from_f<T>(v);
              }));
    __syncthreads();
    marks.phase(3);
    vocab_accumulate(acc, tile, codes, voc, E, cc, A);
    __syncthreads();
    marks.phase(4);
  }
  float* pb = part + (size_t)blockIdx.x * n_acc;
  for (size_t i = threadIdx.x; i < n_acc; i += kThreads) pb[i] = acc[i];
  marks.phase(5);
  marks.write();
}

template <typename T>
size_t proj_vocab_smem_bytes(int Dp, int E, const Vocab& voc) {
  const size_t n_acc = ((size_t)vocab_acc_size(voc) + 31) / 32 * 32;
  return ((size_t)kWarps * 256 + n_acc) * sizeof(float) + ((size_t)E * kLdT + Dp) * sizeof(T);
}

template <typename T>
int launch_proj_vocab(const void* codes, const void* bd, const Vocab& voc, void* g32,
                      const void* pw, const void* pwT, void* dtc, void* part, int Dp, int E,
                      int A, int nb, int ab, int act, cudaStream_t s) {
  const size_t bytes = proj_vocab_smem_bytes<T>(Dp, E, voc);
  if (bytes > (size_t)kSmemLimit || E % 16 || Dp % 16 || ab % kTile)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bwd_proj_vocab_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  bwd_proj_vocab_kernel<T><<<nb, kThreads, bytes, s>>>(
      static_cast<const int*>(codes), static_cast<const T*>(bd), voc, static_cast<float*>(g32),
      static_cast<const T*>(pw), static_cast<const T*>(pwT), static_cast<T*>(dtc),
      static_cast<float*>(part), Dp, E, A, ab, act);
  return (int)cudaGetLastError();
}

bool layer_configured[2][kMaxDevices], walk_configured[5][kMaxDevices],
    group_configured[kMaxDevices];

template <typename T>
int launch_layer(const void* x_l, void* wk, void* g32, const void* adj, const void* w,
                 const void* wT, int D, int Dp, int A, int nb, int ab, int n_blocks, int act,
                 int dropout, int layer, unsigned seed, unsigned thresh, float scale,
                 cudaStream_t s) {
  const size_t bytes = bwd_smem_bytes<T>(Dp, ab, n_blocks);
  if (bytes > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const int err = configure(bwd_layer_kernel<T>, layer_configured[sizeof(T) == 2]);
  if (err) return err;
  bwd_layer_kernel<T><<<nb, kThreads, bytes, s>>>(
      static_cast<const T*>(x_l), static_cast<T*>(wk), static_cast<float*>(g32),
      static_cast<const int8_t*>(adj), static_cast<const T*>(w), static_cast<const T*>(wT), D, Dp,
      A, ab, n_blocks, act, dropout, layer, seed, thresh, scale);
  return (int)cudaGetLastError();
}

bool walk_fits(int Dp, int ab, int n_blocks) {
  return Dp % 16 == 0 && Dp <= kWalkMaxDp && ab % kTile == 0 && ab / kTile >= 1 &&
         ab / kTile <= kWalkMaxCluster && n_blocks >= 1 &&
         walk_smem_bytes(Dp, n_blocks) <= (size_t)kSmemLimit;
}

template <int ACT>
int launch_walk(const void* x_l, void* wk, void* g32, const void* adj, const void* wstream, int D,
                int Dp, int A, int nb, int ab, int n_blocks, int dropout, int layer,
                unsigned seed, unsigned thresh, float scale, cudaStream_t s) {
  const int err = configure(bwd_walk_kernel<ACT, false>, walk_configured[ACT]);
  if (err) return err;
  const int C = ab / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * C);
  cfg.blockDim = dim3(kWalkThreads);
  cfg.dynamicSmemBytes = walk_smem_bytes(Dp, n_blocks);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, bwd_walk_kernel<ACT, false>, static_cast<const bf16*>(x_l), static_cast<bf16*>(wk),
      static_cast<float*>(g32), static_cast<const int8_t*>(adj),
      static_cast<const bf16*>(wstream), static_cast<const bf16*>(nullptr),
      static_cast<bf16*>(nullptr), D, Dp, A, ab, n_blocks, dropout, layer, seed, thresh, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch_walk(const void* x_l, void* wk, void* g32, const void* adj, const void* wstream, int D,
                int Dp, int A, int nb, int ab, int n_blocks, int act, int dropout, int layer,
                unsigned seed, unsigned thresh, float scale, cudaStream_t s) {
  if (!walk_fits(Dp, ab, n_blocks) || D > Dp || A != nb * ab) return (int)cudaErrorInvalidValue;
  switch (act) {  // activation codes: utils/activation.py ACTIVATION_CODES
    case 0: return launch_walk<0>(x_l, wk, g32, adj, wstream, D, Dp, A, nb, ab, n_blocks, dropout,
                                  layer, seed, thresh, scale, s);
    case 1: return launch_walk<1>(x_l, wk, g32, adj, wstream, D, Dp, A, nb, ab, n_blocks, dropout,
                                  layer, seed, thresh, scale, s);
    case 2: return launch_walk<2>(x_l, wk, g32, adj, wstream, D, Dp, A, nb, ab, n_blocks, dropout,
                                  layer, seed, thresh, scale, s);
    case 3: return launch_walk<3>(x_l, wk, g32, adj, wstream, D, Dp, A, nb, ab, n_blocks, dropout,
                                  layer, seed, thresh, scale, s);
    case 4: return launch_walk<4>(x_l, wk, g32, adj, wstream, D, Dp, A, nb, ab, n_blocks, dropout,
                                  layer, seed, thresh, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_proj(const void* emb, void* g32, const void* pw, const void* pwT, void* dtc,
                void* demb, int Dp, int E, int A, int nb, int ab, int act, cudaStream_t s) {
  const size_t bytes = (size_t)kWarps * 256 * sizeof(float) + (size_t)Dp * sizeof(T);
  bwd_proj_kernel<T><<<nb, kThreads, bytes, s>>>(
      static_cast<const T*>(emb), static_cast<float*>(g32), static_cast<const T*>(pw),
      static_cast<const T*>(pwT), static_cast<T*>(dtc), static_cast<T*>(demb), Dp, E, A, ab, act);
  return (int)cudaGetLastError();
}

// ---- the fold's backward on wgmma (proj_bwd_wg_kernel) ----------------------

constexpr int kPwThreads = 384;    // warpgroups 0 and 1 consume; warpgroup 2 produces
constexpr int kPwConsumers = 256;  // consumer threads
constexpr int kPwFill = 96;        // producer threads that fill emb's tile (warps 9-11)
constexpr int kPwG32Ld = 68;       // floats a row of the g32 tile: 64 atoms, padded
constexpr unsigned kPwNoCode = 0x3FFFFFF;  // the sort key's code of a code outside its vocabulary

// Byte offsets in proj_bwd_wg_kernel's shared memory: its seven mbarriers,
// kb and bb (the stream), emb's tile (MN-major), ng buffers of g32's tile
// (padded rows; each also stages its tile's demb once the first epilogue
// is done with it), dtc's tile (K-major), then under the fold the table
// partial, the tiles' sorted codes (two buffers) and the tile's code rows;
// last the block's sums of dt0 (4 x Dp floats: a row a consumer warp of
// each warpgroup, over its atoms and tiles).  Two g32 buffers where they
// fit (the emb form at Dp 160, E 256), so a tile's g32 lands while the
// tile before it is still in its products.
struct PwSmem {
  long long kb, emb, g32, g32b, dtc, part, keys, codes, bbs, total;
  int ng;
};

__host__ __device__ inline long long pw_up(long long b) { return (b + 127) / 128 * 128; }

// n_acc: the table partial's floats under the fold; -1 for the emb form.
__host__ __device__ inline PwSmem pw_smem(int Dp, int E, int F, long long n_acc) {
  PwSmem s;
  s.kb = 128;
  s.emb = s.kb + pw_up((long long)(Dp * E + Dp) * 2);
  s.g32 = s.emb + pw_up((long long)E * kTile * 2);
  // g32's rows, or the demb staging: [e][atom] (emb form), [atom][E + 8] (fold)
  const long long rows = (long long)Dp * kPwG32Ld * 4;
  const long long stage = n_acc < 0 ? (long long)E * kTile * 2 : (long long)kTile * (E + 8) * 2;
  s.g32b = pw_up(rows > stage ? rows : stage);
  for (s.ng = 2; s.ng >= 1; --s.ng) {
    s.dtc = s.g32 + s.ng * s.g32b;
    s.part = s.dtc + pw_up((long long)Dp * kTile * 2);
    if (n_acc < 0) {
      s.keys = s.codes = s.bbs = s.part;
    } else {
      s.keys = s.part + pw_up(n_acc * 4);
      s.codes = s.keys + pw_up(2LL * F * kTile * 4);
      s.bbs = s.codes + pw_up((long long)F * kTile * 4);
    }
    s.total = s.bbs + pw_up(4LL * Dp * 4);
    if (s.total <= kSmemLimit) break;
  }
  if (s.ng < 1) s.ng = 1;  // past the limit: pw_fits refuses the shape
  return s;
}

bool pw_fits(int Dp, int E, int F, long long n_acc) {
  return (Dp == 64 || Dp == 128 || Dp == 160) && (E == 128 || E == 256) &&
         pw_smem(Dp, E, F, n_acc).total <= kSmemLimit;
}

#ifdef MP_STACK_BWD_MARKS
// proj_bwd_wg_kernel's clocks, per block in g_proj_marks: the consumer
// warpgroup's SM clocks summed over its tiles at 0 (waits for emb's and
// g32's tiles), 1 (kb^T emb), 2 (its epilogue), 3 (kb dtc, both halves),
// 4 (their epilogues), 5 (the demb store or the table accumulation), 6 (its
// span), 7 (its tiles); the g32 warp's at 8 (waits for a free buffer), 9
// (its span); the fill warps' (warp 5's) at 10 (waits), 11 (span).
struct PwClock {
  long long acc[7], t;
  __device__ void start() {
    for (int k = 0; k < 7; ++k) acc[k] = 0;
    acc[6] = t = clock64();
  }
  __device__ void lap(int k) {
    const long long n = clock64();
    acc[k] += n - t;
    t = n;
  }
  __device__ void write(int base, int n, long long tiles) {
    acc[6] = clock64() - acc[6];
    unsigned long long* m = g_proj_marks + (size_t)blockIdx.x * kProjMarks;
    for (int k = 0; k < n; ++k) m[base + k] = acc[k];
    m[base + n] = acc[6];
    if (tiles >= 0) m[7] = tiles;
  }
};
#else
struct PwClock {
  __device__ void start() {}
  __device__ void lap(int) {}
  __device__ void write(int, int, long long) {}
};
#endif

// The embedding fold's accumulation of one tile: d_bd's compact partial
// (part, in shared memory) += each atom's demb row (staged [atom][E + 8],
// rounded to bf16) at its code.  keys holds each feature's 64 sort keys
// (code << 6 | atom, kPwNoCode for a code outside the vocabulary) in
// ascending order, so each run of one code is its atoms in atom order.  A
// task is a row e and one half of its feature's sorted atoms, the halves
// split at the first run boundary from position 32: a run's sum, in atom
// order, is added once to its cell, and no cell has two writers.
__device__ void pw_accumulate(float* part, const unsigned* keys, const bf16* stage,
                              const Vocab& voc, int E) {
  for (int task = threadIdx.x; task < 2 * E; task += kPwConsumers) {
    const int e = task % E, half = task / E;
    const int f = e / voc.Df, V = voc.off[f + 1] - voc.off[f];
    const unsigned* kf = keys + f * kTile;
    int split = kTile / 2;
    while (split < kTile && (kf[split] >> 6) == (kf[split - 1] >> 6)) ++split;
    float* row = part + (size_t)voc.Df * voc.off[f] + (size_t)(e - f * voc.Df) * V;
    const int end = half ? kTile : split;
    float run = 0.0f;
    for (int p = half ? split : 0; p < end; ++p) {
      const unsigned key = kf[p], c = key >> 6;
      run += __bfloat162float(stage[(key & 63) * (E + 8) + e]);
      if (p + 1 == end || (kf[p + 1] >> 6) != c) {
        if (c < (unsigned)V) row[c] += run;
        run = 0.0f;
      }
    }
  }
}

// The consumer warpgroups (see proj_bwd_wg_kernel): warpgroup wg forms t0
// for features [wg DP / 2, (wg + 1) DP / 2) and demb for the halves of 128
// e from the wg-th on.
template <int DP, int ACT, bool VOCAB>
__device__ void pw_consumer(unsigned char* sm, const PwSmem& L, const Vocab& voc,
                            bf16* __restrict__ dtc, bf16* __restrict__ demb,
                            float* __restrict__ part, int E, int A, long long n_acc) {
  constexpr int NH = DP / 2;  // the warpgroup's features
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sm);
  const unsigned char* kbs = sm + L.kb;
  const bf16* bias = reinterpret_cast<const bf16*>(sm + L.kb) + (size_t)DP * E;
  const unsigned char* embs = sm + L.emb;
  unsigned char* dtcs = sm + L.dtc;
  float* tpart = reinterpret_cast<float*>(sm + L.part);
  // the warpgroup, uniform across its warps as the compiler sees it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int T = threadIdx.x & 127, w = T >> 5, g = (T & 31) >> 2, t = T & 3;
  const bool lead = T == 0;
  const int n_tiles = A / kTile, f0 = wg * NH;
  float* bbs = reinterpret_cast<float*>(sm + L.bbs);  // [warp][feature]: dt0's sums
  if (VOCAB) {
    for (long long i = threadIdx.x; i < n_acc; i += kPwConsumers) tpart[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < 4 * DP; i += kPwConsumers) bbs[i] = 0.0f;
  named_bar(1, kPwConsumers);
  PwClock clk;
  clk.start();
  wg_wait_bar(bars, 0);  // kb and bb
  int k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
    const unsigned ph = k & 1;
    const size_t col0 = (size_t)tile * kTile;
    wg_wait_bar(bars + 1, ph);  // emb's tile
    fence_async_smem();
    clk.lap(0);
    // t0^T = emb^T kb for the warpgroup's features: M the tile's atoms,
    // N = DP / 2, K = E
    float acc[NH / 2];
    wg_fence_acc(acc);
    wg_fence();
    for (int s = 0; s < E / 16; ++s)
      Wgmma<NH, 1, 0>::run(acc, wg_desc(embs + s * 2048, 1024, 128),
                           wg_desc(kbs + s * 32 * DP + wg * 8 * DP, 16 * DP, 128), s > 0);
    wg_commit();
    wg_wait<0>();
    wg_fence_acc(acc);
    wg_arrive_if(bars + 2, lead);  // this warpgroup is done with emb's buffer
    clk.lap(1);
    // tile k's g32 buffer, which also stages its demb
    const int gb = k % L.ng;
    const unsigned gph = (k / L.ng) & 1;
    const float* g32s = reinterpret_cast<const float*>(sm + L.g32 + gb * L.g32b);
    unsigned char* stage = sm + L.g32 + gb * L.g32b;
    wg_wait_bar(bars + 3 + gb, gph);  // g32's tile
    clk.lap(0);
    // t0 = rnd(rnd(acc) + bb); dt0 = g32 rnd(act'(t0)) in fp32; dtc = rnd(dt0),
    // to the K-major tile and to dtc (DP, A) for the contraction: lanes g
    // and g ^ 1 trade halves, so that each stores one feature at two
    // neighbouring atoms as 4 bytes; dt0 summed over the tile's atoms (the
    // thread's two, then its warp's lanes of one t) into the warp's row
    const bool even = (g & 1) == 0;
#pragma unroll
    for (int j = 0; j < NH / 8; ++j) {
      const int f = f0 + 8 * j + 2 * t;
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h, atom = 16 * w + g + 8 * h;
        const float2 t0 = __bfloat1622float2(bias_add(acc[i], acc[i + 1], bias + f));
        const float d0 = g32s[f * kPwG32Ld + atom] * rnd<bf16>(act_grad(ACT, t0.x));
        const float d1 = g32s[(f + 1) * kPwG32Ld + atom] * rnd<bf16>(act_grad(ACT, t0.y));
        s0 += d0;
        s1 += d1;
        const unsigned mine = bits(__floats2bfloat162_rn(d0, d1));
        st_u32(dtcs + kmajor_off<DP>(w, g, t, wg * (NH / 8) + j, h), mine);
        const unsigned other = __shfl_xor_sync(0xffffffffu, mine, 4);
        *reinterpret_cast<unsigned*>(dtc + (size_t)(even ? f : f + 1) * A + col0 + (atom & ~1)) =
            even ? __byte_perm(mine, other, 0x5410) : __byte_perm(other, mine, 0x7632);
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == 0) {
        bbs[w * DP + f] += s0;
        bbs[w * DP + f + 1] += s1;
      }
    }
    fence_async_smem();
    named_bar(1, kPwConsumers);  // dtc's tile is whole; g32's rows are read
    clk.lap(2);
    // demb^T = dtc^T kb^T: N = E in halves of 128, the wg-th on, K = DP; kb
    // MN-major
    for (int c = wg; c < E / 128; c += 2) {
      float acc2[64];
      wg_fence_acc(acc2);
      wg_fence();
#pragma unroll
      for (int s = 0; s < DP / 16; ++s)
        Wgmma<128, 0, 1>::run(acc2, wg_desc(dtcs + s * 256, 128, 16 * DP),
                              wg_desc(kbs + 256 * c * DP + 256 * s, 128, 16 * DP), s > 0);
      wg_commit();
      wg_wait<0>();
      wg_fence_acc(acc2);
      clk.lap(3);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 128 * c + 8 * j + 2 * t, i = 4 * j + 2 * h, atom = 16 * w + g + 8 * h;
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc2[i], acc2[i + 1]);
          if (VOCAB) {  // [atom][E + 8]
            st_u32(stage + ((size_t)atom * (E + 8) + e) * 2, bits(v));
          } else {  // [e][atom], the 16-byte chunks of row e swizzled by e % 8
            const int ao = (atom & 7) * 2;
            *reinterpret_cast<bf16*>(stage + e * 128 + (((atom >> 3) ^ (e & 7)) << 4) + ao) = v.x;
            *reinterpret_cast<bf16*>(stage + (e + 1) * 128 + (((atom >> 3) ^ ((e + 1) & 7)) << 4) +
                                     ao) = v.y;
          }
        }
      clk.lap(4);
    }
    named_bar(1, kPwConsumers);
    if (VOCAB) {
      pw_accumulate(tpart, reinterpret_cast<const unsigned*>(sm + L.keys) + ph * voc.F * kTile,
                    reinterpret_cast<const bf16*>(stage), voc, E);
    } else {
      for (int q = threadIdx.x; q < E * 8; q += kPwConsumers) {  // demb (E, A), 16-byte stores
        const int e = q >> 3, ch = q & 7;
        *reinterpret_cast<int4*>(demb + (size_t)e * A + col0 + ch * 8) =
            *reinterpret_cast<const int4*>(stage + e * 128 + ((ch ^ (e & 7)) << 4));
      }
    }
    named_bar(1, kPwConsumers);
    wg_arrive_if(bars + 5 + gb, lead && wg == 0);  // the g32 buffer (the staging) is free
    clk.lap(5);
  }
  // the block's partial row [d_bb | compact d_bd]: the warps' rows in order
  named_bar(1, kPwConsumers);
  float* pb = part + (size_t)blockIdx.x * (DP + (VOCAB ? n_acc : 0));
  for (int f = threadIdx.x; f < DP; f += kPwConsumers)
    pb[f] = ((bbs[f] + bbs[DP + f]) + bbs[2 * DP + f]) + bbs[3 * DP + f];
  if (VOCAB) {
    for (long long i = threadIdx.x; i < n_acc; i += kPwConsumers) pb[DP + i] = tpart[i];
  }
  if (threadIdx.x == 0) clk.write(0, 6, k);
}

// The projection fold's backward on wgmma (kernels 1c and, with VOCAB,
// 1c-vocab): persistent blocks, one an SM, each walking the 64-atom tiles
// blockIdx.x, + gridDim.x, ... (a static order, so the per-block partials
// and their sums in block order are the same from run to run).
// Warpgroups 0 and 1 consume, each half of a tile's products and epilogues:
// kb^T emb for half the features, then, once dtc's tile is whole, kb dtc
// for half the e (the epilogues on the accumulators, the fold's
// accumulation and the demb store on all their threads).  Warpgroup 2
// produces: warp 8 lands kb and bb once (one bulk copy of the stream,
// bin_mp.py::proj_wg_weights) and each tile's g32 rows (a bulk copy a row,
// into rows padded to 68 floats) on its buffer's mbarrier as the buffer
// frees; warps 9-11 fill emb's tile (MN-major) as its buffer frees: by
// cp.async from emb, or, under the fold, looked up from the tile's code
// rows (bit-equal to the emb form), with each feature's codes sorted for
// the accumulation.  part: one row a block, [d_bb (DP) | the compact d_bd
// partial (n_acc)].
template <int DP, bool VOCAB>
__global__ void __launch_bounds__(kPwThreads, 1)
proj_bwd_wg_kernel(const bf16* __restrict__ emb, const int* __restrict__ codes,
                   const bf16* __restrict__ bd, Vocab voc, const float* __restrict__ g32,
                   const bf16* __restrict__ ws, bf16* __restrict__ dtc, bf16* __restrict__ demb,
                   float* __restrict__ part, int E, int A, long long n_acc, int act) {
  extern __shared__ __align__(128) unsigned char sm[];
  const PwSmem L = pw_smem(DP, E, voc.F, VOCAB ? n_acc : -1);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sm);
  // kb full, emb full (the fill threads), emb empty (both consumer
  // warpgroups), g32 full (two buffers), g32 empty (two buffers)
  if (threadIdx.x < 7)
    mbar_init(bars + threadIdx.x, threadIdx.x == 1 ? kPwFill : threadIdx.x == 2 ? 2 : 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  const int n_tiles = A / kTile;
  if (threadIdx.x < kPwConsumers) {
    switch (act) {  // activation codes: utils/activation.py ACTIVATION_CODES
      case 0: pw_consumer<DP, 0, VOCAB>(sm, L, voc, dtc, demb, part, E, A, n_acc); break;
      case 1: pw_consumer<DP, 1, VOCAB>(sm, L, voc, dtc, demb, part, E, A, n_acc); break;
      case 2: pw_consumer<DP, 2, VOCAB>(sm, L, voc, dtc, demb, part, E, A, n_acc); break;
      case 3: pw_consumer<DP, 3, VOCAB>(sm, L, voc, dtc, demb, part, E, A, n_acc); break;
      default: pw_consumer<DP, 4, VOCAB>(sm, L, voc, dtc, demb, part, E, A, n_acc); break;
    }
    return;
  }
  const int pt = threadIdx.x - kPwConsumers, pwarp = pt >> 5, lane = pt & 31;
  PwClock clk;
  clk.start();
  if (pwarp == 0) {  // warp 8: kb and bb once, then each tile's g32 rows
    const unsigned kb_bytes = (unsigned)(DP * E + DP) * 2;
    if (lane == 0) bulk_copy(sm + L.kb, ws, kb_bytes, bars);
    int k = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
      const size_t col0 = (size_t)tile * kTile;
      const int gb = k % L.ng;
      float* g32s = reinterpret_cast<float*>(sm + L.g32 + gb * L.g32b);
      if (lane == 0) {
        clk.lap(1);
        mbar_wait(bars + 5 + gb, ((k / L.ng) & 1) ^ 1);
        clk.lap(0);
        mbar_expect(bars + 3 + gb, DP * kTile * 4);
      }
      __syncwarp();
      for (int d = lane; d < DP; d += 32)
        bulk_load(g32s + d * kPwG32Ld, g32 + (size_t)d * A + col0, kTile * 4, bars + 3 + gb);
    }
    if (lane == 0) clk.write(8, 1, -1);
    return;
  }
  // warps 9-11: emb's tile
  const int ft = pt - 32;
  unsigned char* embs = sm + L.emb;
  int k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
    const size_t col0 = (size_t)tile * kTile;
    if (lane == 0) {
      clk.lap(1);
      mbar_wait(bars + 2, (k & 1) ^ 1);
      clk.lap(0);
    }
    __syncwarp();
    if (!VOCAB) {
      for (int q = ft; q < E * 8; q += kPwFill) {
        const int e = q >> 3, ch = q & 7;
        cp_async16(embs + (e >> 3) * 1024 + ch * 128 + (e & 7) * 16,
                   emb + (size_t)e * A + col0 + ch * 8);
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bars + 1))
                   : "memory");
      continue;
    }
    // the tile's code rows, then each feature's codes sorted (a key's rank
    // is the number of smaller keys: the keys are distinct), then the lookup
    int* cs = reinterpret_cast<int*>(sm + L.codes);
    unsigned* keys = reinterpret_cast<unsigned*>(sm + L.keys) + (k & 1) * voc.F * kTile;
    named_bar(2, kPwFill);  // the last tile's lookup is done with the code rows
    for (int q = ft; q < voc.F * kTile; q += kPwFill)
      cs[q] = codes[(size_t)(q / kTile) * A + col0 + q % kTile];
    named_bar(2, kPwFill);
    auto key_of = [&](int f, int a) {
      const int c = cs[f * kTile + a], V = voc.off[f + 1] - voc.off[f];
      return ((c >= 0 && c < V) ? (unsigned)c : kPwNoCode) << 6 | (unsigned)a;
    };
    for (int q = ft; q < voc.F * kTile; q += kPwFill) {
      const int f = q / kTile, a = q % kTile;
      const unsigned key = key_of(f, a);
      int rank = 0;
      for (int b = 0; b < kTile; ++b) rank += key_of(f, b) < key;
      keys[f * kTile + rank] = key;
    }
    for (int q = ft; q < E * 8; q += kPwFill) {
      const int e = q >> 3, ch = q & 7, f = e / voc.Df, V = voc.off[f + 1] - voc.off[f];
      const bf16* row = bd + (size_t)e * voc.SV + voc.off[f];
      const int* cf = cs + f * kTile + ch * 8;
      const bf16 zero = __float2bfloat16(0.0f);
      unsigned u[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int c0 = cf[2 * p], c1 = cf[2 * p + 1];
        u[p] = bits(__halves2bfloat162((c0 >= 0 && c0 < V) ? row[c0] : zero,
                                       (c1 >= 0 && c1 < V) ? row[c1] : zero));
      }
      *reinterpret_cast<uint4*>(embs + (e >> 3) * 1024 + ch * 128 + (e & 7) * 16) =
          make_uint4(u[0], u[1], u[2], u[3]);
    }
    fence_async_smem();
    mbar_arrive(bars + 1);
  }
  if (ft == 0) clk.write(10, 1, -1);
}

template <int DP, bool VOCAB>
int launch_pw(const void* emb, const void* codes, const void* bd, const Vocab& voc,
              const void* g32, const void* ws, void* dtc, void* demb, void* part, int E, int A,
              int blocks, long long n_acc, int act, cudaStream_t s) {
  static bool done[kMaxDevices];
  const int err = configure(proj_bwd_wg_kernel<DP, VOCAB>, done);
  if (err) return err;
  proj_bwd_wg_kernel<DP, VOCAB><<<blocks, kPwThreads, pw_smem(DP, E, voc.F, n_acc).total, s>>>(
      static_cast<const bf16*>(emb), static_cast<const int*>(codes), static_cast<const bf16*>(bd),
      voc, static_cast<const float*>(g32), static_cast<const bf16*>(ws), static_cast<bf16*>(dtc),
      static_cast<bf16*>(demb), static_cast<float*>(part), E, A, n_acc, act);
  return (int)cudaGetLastError();
}

template <bool VOCAB>
int launch_pw(int Dp, const void* emb, const void* codes, const void* bd, const Vocab& voc,
              const void* g32, const void* ws, void* dtc, void* demb, void* part, int E, int A,
              int blocks, long long n_acc, int act, cudaStream_t s) {
  switch (Dp) {
    case 64: return launch_pw<64, VOCAB>(emb, codes, bd, voc, g32, ws, dtc, demb, part, E, A,
                                         blocks, n_acc, act, s);
    case 128: return launch_pw<128, VOCAB>(emb, codes, bd, voc, g32, ws, dtc, demb, part, E, A,
                                           blocks, n_acc, act, s);
    default: return launch_pw<160, VOCAB>(emb, codes, bd, voc, g32, ws, dtc, demb, part, E, A,
                                          blocks, n_acc, act, s);
  }
}

}  // namespace

extern "C" {

// Shared memory of the bf16 walk at (Dp, ab, n_blocks), or -1 where the walk
// does not take the shape (the wrapper then launches mp_stack_bwd_layer).
long long mp_stack_bwd_walk_smem_bytes(int Dp, int ab, int n_blocks) {
  return walk_fits(Dp, ab, n_blocks) ? (long long)walk_smem_bytes(Dp, n_blocks) : -1;
}

// Elements of one layer's weight stream and biases (the wrapper lays them
// out; see walk_stages).
long long mp_stack_bwd_walk_stream_elems(int Dp, int n_blocks) {
  return (long long)walk_stages(Dp, n_blocks) * Dp * kKc + (long long)(1 + 2 * n_blocks) * Dp;
}

// One layer of the bf16 walk (bwd_walk_kernel).  Returns cudaGetLastError()
// after the launch.
int mp_stack_bwd_walk(const void* x_l, void* wk, void* g32, const void* adj, const void* wstream,
                      int D, int Dp, int A, int nb, int ab, int n_blocks, int act, int dropout,
                      int layer, unsigned seed, unsigned thresh, float scale, void* stream) {
  return launch_walk(x_l, wk, g32, adj, wstream, D, Dp, A, nb, ab, n_blocks, act, dropout, layer,
                     seed, thresh, scale, static_cast<cudaStream_t>(stream));
}

// The grouped weight-gradient contraction (csrc/wgrad_group.cuh) of n
// products: arrays of their dY, X and bias-source pointers (null: the row
// sums of dY), M, N and output offsets; part (ceil(A / chunk), stride) fp32.
// A product with a null X is gathered from the code rows codes (F, A) int32
// and the table bd (E = its N, sum of sizes) in the compute dtype.
int wgrad_group(int n, const void* const* dY, const void* const* X, const void* const* bsrc,
                const int* M, const int* N, const long long* off, void* part, long long stride,
                int bf16, int A, int chunk, const void* codes, const void* bd, const int* sizes,
                int F, void* stream) {
  Vocab voc{};
  for (int p = 0; p < n && codes; ++p)
    if (X[p] == nullptr) {
      if (!make_vocab(sizes, F, N[p], &voc)) return (int)cudaErrorInvalidValue;
      break;
    }
  if (bf16) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!group_configured[dev]) {
      err = cudaFuncSetAttribute(wgrad_group_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 group_smem_bytes());
      if (err != cudaSuccess) return (int)err;
      group_configured[dev] = true;
    }
  }
  return launch_wgrad_group(n, dY, X, bsrc, M, N, off, part, stride, bf16, A, chunk,
                            static_cast<const int*>(codes), bd, voc,
                            static_cast<cudaStream_t>(stream));
}

long long mp_stack_bwd_smem_bytes(int bf16, int Dp, int ab, int n_blocks) {
  return bf16 ? (long long)bwd_smem_bytes<__nv_bfloat16>(Dp, ab, n_blocks)
              : (long long)bwd_smem_bytes<float>(Dp, ab, n_blocks);
}

// One layer of the walk (see the top of this file).  Returns
// cudaGetLastError() after the launch.
int mp_stack_bwd_layer(const void* x_l, void* wk, void* g32, const void* adj, const void* w,
                       const void* wT, int bf16, int D, int Dp, int A, int nb, int ab,
                       int n_blocks, int act, int dropout, int layer, unsigned seed,
                       unsigned thresh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_layer<__nv_bfloat16>(x_l, wk, g32, adj, w, wT, D, Dp, A, nb, ab, n_blocks,
                                            act, dropout, layer, seed, thresh, scale, s)
              : launch_layer<float>(x_l, wk, g32, adj, w, wT, D, Dp, A, nb, ab, n_blocks, act,
                                    dropout, layer, seed, thresh, scale, s);
}

// Shared memory of the fold's backward on wgmma at (Dp, E) -- under the
// embedding fold with a table partial of n_acc floats, n_acc -1 without --
// or -1 where it does not take the shape (the wrapper then launches
// mp_stack_bwd_proj or mp_stack_bwd_proj_vocab).
long long mp_stack_bwd_proj_wg_smem_bytes(int Dp, int E, long long n_acc) {
  return pw_fits(Dp, E, kMaxF, n_acc) ? pw_smem(Dp, E, kMaxF, n_acc).total : -1;
}

// The fold's backward on wgmma (proj_bwd_wg_kernel), emb (E, A) in, or,
// with emb null, the code rows codes (F, A) int32 and the table bd (E, sum
// of sizes); g32 (Dp, A) fp32 is read, not written; ws the weights
// (bin_mp.py::proj_wg_weights); dtc (Dp, A) receives rnd(dt0), demb (E, A)
// the embeddings' cotangent (emb form), part (blocks, Dp [+ the table
// partial's floats]) each block's [d_bb | compact d_bd].  Returns
// cudaGetLastError().
int mp_stack_bwd_proj_wg(const void* emb, const void* codes, const void* bd, const int* sizes,
                         int F, const void* g32, const void* ws, void* dtc, void* demb,
                         void* part, int Dp, int E, int A, int blocks, int act, void* stream) {
  const bool vocab = emb == nullptr;
  Vocab voc{};
  if (vocab && !make_vocab(sizes, F, E, &voc)) return (int)cudaErrorInvalidValue;
  const long long n_acc = vocab ? vocab_acc_size(voc) : -1;
  if (!pw_fits(Dp, E, voc.F, n_acc) || A % kTile || blocks < 1 || act < 0 || act > 4 ||
      (!vocab && demb == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vocab ? launch_pw<true>(Dp, emb, codes, bd, voc, g32, ws, dtc, demb, part, E, A, blocks,
                                 n_acc, act, s)
               : launch_pw<false>(Dp, emb, codes, bd, voc, g32, ws, dtc, demb, part, E, A, blocks,
                                  n_acc, act, s);
}

int mp_stack_bwd_proj(const void* emb, void* g32, const void* pw, const void* pwT, void* dtc,
                      void* demb, int bf16, int Dp, int E, int A, int nb, int ab, int act,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_proj<__nv_bfloat16>(emb, g32, pw, pwT, dtc, demb, Dp, E, A, nb, ab, act, s)
              : launch_proj<float>(emb, g32, pw, pwT, dtc, demb, Dp, E, A, nb, ab, act, s);
}

// The fold's backward under the embedding fold (see the top of this file):
// codes (F, A) int32, bd (E, sum of sizes) in the compute dtype; g32 is
// overwritten with dt0, dtc receives rnd(dt0), part (nb, Df * sum of sizes)
// the bins' compact d_bd partials.  Returns cudaGetLastError().
int mp_stack_bwd_proj_vocab(const void* codes, const void* bd, const int* sizes, void* g32, int F,
                            const void* pw, const void* pwT, void* dtc, void* part, int bf16,
                            int Dp, int E, int A, int nb, int ab, int act, void* stream) {
  Vocab voc;
  if (!make_vocab(sizes, F, E, &voc)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_proj_vocab<__nv_bfloat16>(codes, bd, voc, g32, pw, pwT, dtc, part, Dp, E,
                                                 A, nb, ab, act, s)
              : launch_proj_vocab<float>(codes, bd, voc, g32, pw, pwT, dtc, part, Dp, E, A, nb, ab,
                                         act, s);
}

int sum_partials(const void* part, void* out, int n, long long size, void* stream) {
  return launch_sum_partials(part, out, n, size, static_cast<cudaStream_t>(stream));
}

#ifdef MP_STACK_BWD_MARKS
// Points the fold's backward kernels' phase marks at marks ((blocks, 16) uint64).
int mp_stack_bwd_marks(void* marks) {
  return (int)cudaMemcpyToSymbol(g_proj_marks, &marks, sizeof(marks));
}
#endif

const char* mp_stack_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
