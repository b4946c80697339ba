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
// What bounds it on an H100: the products, about 829,000 FLOP per atom
// column and layer at Dp 160 with two blocks (41 GFLOP a layer at the
// training batch, 0.04 ms at the bf16 tensor-core rate), so tensor-core
// throughput, with the slab writes (11 slabs of (Dp, A), 0.05 ms at the HBM
// rate) second.
//
// The bf16 walk (bwd_walk_kernel) is built around that:
// - one 320-thread block per 64-atom tile, the ab / 64 tiles of a bin one
//   thread-block cluster (768 blocks at the training batch, about six waves
//   of one block an SM, where one block a bin gave 1.45 waves);
// - the chain in shared memory: xa, h_i, v_i and, for the walk back,
//   rnd(act'(t)) and rnd(act'(u_i)) (formed where t and u_i are, so the walk
//   back's epilogues evaluate no activation) stay there, and the cotangents
//   replace them in place once their last reader is done (g and dh_i over
//   xa, dt over act'(t), du_i over act'(u_i), dA over h); every
//   product reads its activation operand with ldmatrix from shared memory
//   and multiplies with mma.sync m16n8k16 (fp32 accumulate), the epilogues
//   work on the accumulator registers (bias, activation, dropout, casts);
// - weights ahead of the products: the wrapper lays each layer's matrices
//   out as one stream, in the order the walk uses them and in mma fragment
//   order (32-column stages, 16 x 16 tiles k-major), and a 4-stage ring of
//   16-byte cp.async copies keeps three stages in flight across product
//   boundaries, so each warp reads its A fragment with one 16-byte load;
// - the aggregation: each block forms its own columns of agg from the
//   bin's x (L2-resident), 64 source atoms a chunk, double-buffered; the
//   transpose reads the cluster's other dA tiles from distributed shared
//   memory after a cluster barrier, in rank order, so t, u_i and dA never
//   reach device memory, and the slab writes are 16-byte streaming stores
//   of the operands the weight gradients read.
// mma.sync, not wgmma: wgmma takes 64-row tiles, and Dp 160 is 2.5 of
// them; m16n8k16 tiles cover it exactly with 10 warps of 32 x 32 outputs.
// The walk takes Dp <= 160 and ab <= 512 (clusters of up to 8) while its
// buffers fit one block's shared memory (up to 3 MLP blocks at Dp 160);
// fp32, and bf16 shapes past those limits, take bwd_layer_kernel, the
// CUDA-core (fp32) or wmma (bf16) walk of one block per bin over slabs
// (fp32 tiles would take twice the shared memory).
//
// Embedding fold (mp_stack_bwd_proj_vocab, kernel 1c-vocab: the TPU op's
// vocab_sizes backward, bin_mp.py:726-746).  The walk is unchanged; the
// fold's backward looks each 64-atom tile's embeddings up from the codes
// into shared memory (csrc/vocab.cuh) to recompute t0, forms dt0 and
// rnd(dt0) as above, then rnd(kb rnd(dt0)) into the same shared tile
// instead of a global demb, and one thread per table row adds each atom's
// value at its code into the bin's compact d_bd partial, atoms in order.
// There is no dx (codes have no cotangent).  d_kb is the gathered split-K
// contraction (wgrad_vocab); the bin partials are summed in bin order.
//
// Work slabs (Dp, A) of wk, in order: xa (two: x rows, agg rows), h_i,
// v_i, dh_i (dh_{n-1} = g), du_i, dt -- what the contraction reads; then,
// for bwd_layer_kernel only, t, u_i and the agg-part cotangent dA.

#include <cooperative_groups.h>

#include "common.cuh"
#include "vocab.cuh"
#include "wgrad.cuh"
#include "wgrad_group.cuh"

namespace {

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

// ---- the bf16 walk: one block per 64-atom tile, a cluster per bin ----

using bf16 = __nv_bfloat16;
constexpr int kWalkThreads = 320;  // 10 warps: 5 row groups of 32 x 2 column halves of 32
constexpr int kWalkMaxDp = 160;    // 5 row groups of 32
constexpr int kWalkMaxCluster = 8;  // portable cluster size: ab <= 512
constexpr int kKc = 32;            // weight columns per ring stage
constexpr int kRing = 4;           // ring stages (three in flight)

__host__ __device__ __forceinline__ int kpad(int k) { return (k + kKc - 1) / kKc * kKc; }

// Tile-buffer rows (of kLdT elements): the chain, (5 + n_blocks) Dp; during
// the aggregation xa, two x chunks and two adjacency blocks; during the
// transpose the 64-row adjacency block past the first 5 Dp rows.
__host__ __device__ __forceinline__ int walk_rows(int Dp, int n_blocks) {
  const int chain = (5 + n_blocks) * Dp, agg = 4 * Dp + 2 * kTile, tr = 5 * Dp + kTile;
  return chain > agg ? (chain > tr ? chain : tr) : (agg > tr ? agg : tr);
}

// Ring stages of one layer's weight stream: W_in, W1_0, W2_0, ..., W1_{n-1}
// (recompute), W2_{n-1}^T, W1_{n-1}^T, ..., W2_0^T, W1_0^T (walk back), then
// the agg rows and the x rows of [W_s^T | W_in^T] (dxa); each Dp rows, its
// columns padded to a multiple of kKc.
__host__ __device__ __forceinline__ int walk_stages(int Dp, int n_blocks) {
  return (kpad(2 * Dp) + (4 * n_blocks - 1) * kpad(Dp) + 2 * kpad(2 * Dp)) / kKc;
}

size_t walk_smem_bytes(int Dp, int n_blocks) {
  return ((size_t)walk_rows(Dp, n_blocks) * kLdT + (size_t)kRing * Dp * kKc +
          (size_t)(1 + 2 * n_blocks) * Dp) * sizeof(bf16);
}

// The weight stream through the shared-memory ring.  Every thread takes
// part in every call, in the same order.  Stage s lands in slot s % kRing;
// acquire() waits for the next stage, and the barrier in it also ends every
// read of the slot that the stage it then issues overwrites.  cp.async
// groups committed elsewhere between calls only make the waits stricter.
struct Ring {
  const bf16* src;
  bf16* buf;
  int stage_elems, total, next, cur;

  __device__ void issue() {
    if (next < total) {
      const bf16* s = src + (size_t)next * stage_elems;
      bf16* d = buf + (size_t)(next % kRing) * stage_elems;
      for (int e = threadIdx.x; e < stage_elems / 8; e += kWalkThreads)
        cp_async16(d + 8 * e, s + 8 * e);
    }
    cp_async_commit();
    ++next;
  }
  __device__ void start() {
    for (int i = 0; i < kRing - 1; ++i) issue();
  }
  __device__ const bf16* acquire() {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    const bf16* p = buf + (size_t)(cur % kRing) * stage_elems;
    ++cur;
    issue();
    return p;
  }
};

// A warp's 32 x 32 block of a (Dp x 64) product: rows 16 mt0 .., columns n0 ..
struct WarpTile {
  int mt0, n0, MT;
  __device__ WarpTile(int Dp) {
    const int warp = threadIdx.x / 32;
    mt0 = (warp >> 1) * 2;
    n0 = (warp & 1) * 32;
    MT = Dp / 16;
  }
};

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
}

__device__ __forceinline__ void mma_row(float (&acc)[4][4], const unsigned (&a)[4],
                                        const unsigned (&b)[2][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    mma16816(acc[j], a, b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
}

// acc = W (Dp x K, from the ring) * B (K x 64): B's rows k < ksplit from
// B0, the rest from B1 (row k - ksplit); both [k][n] buffers of stride kLdT.
// (Loading the fragments a k-step ahead takes 168 registers with spills,
// against 156 without, and ran slower on an H100.)
__device__ void ring_product(Ring& ring, int Dp, int K, const bf16* B0, const bf16* B1, int ksplit,
                             float (&acc)[2][4][4]) {
  const WarpTile w(Dp);
  const int lane = threadIdx.x & 31;
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += kKc) {
    const bf16* st = ring.acquire();
#pragma unroll
    for (int kk = 0; kk < kKc / 16; ++kk) {
      const int k = k0 + 16 * kk;
      if (k < K && w.mt0 < w.MT) {
        const bf16* Bp = k < ksplit ? B0 + (size_t)k * kLdT : B1 + (size_t)(k - ksplit) * kLdT;
        unsigned b[2][4];
        frag_b_kn(b[0], Bp, kLdT, 0, w.n0);
        frag_b_kn(b[1], Bp, kLdT, 0, w.n0 + 16);
        const uint4* ap =
            reinterpret_cast<const uint4*>(st + ((size_t)kk * w.MT + w.mt0) * 256) + lane;
        uint4 q = ap[0];
        unsigned a[4] = {q.x, q.y, q.z, q.w};
        mma_row(acc[0], a, b);
        if (w.mt0 + 1 < w.MT) {
          q = ap[32];
          unsigned a1[4] = {q.x, q.y, q.z, q.w};
          mma_row(acc[1], a1, b);
        }
      }
    }
  }
}

// acc += A (Dp x 64, an [m][k] buffer) * B (64 x 64), B an [n][k] buffer
// when nk, else a [k][n] one.
__device__ void smem_product(const bf16* Abuf, const bf16* Bbuf, bool nk, int Dp,
                             float (&acc)[2][4][4]) {
  const WarpTile w(Dp);
  if (w.mt0 >= w.MT) return;
#pragma unroll
  for (int k = 0; k < kTile; k += 16) {
    unsigned b[2][4], a[4];
    if (nk) {
      frag_b_nk(b[0], Bbuf, kLdT, w.n0, k);
      frag_b_nk(b[1], Bbuf, kLdT, w.n0 + 16, k);
    } else {
      frag_b_kn(b[0], Bbuf, kLdT, k, w.n0);
      frag_b_kn(b[1], Bbuf, kLdT, k, w.n0 + 16);
    }
    frag_a(a, Abuf, kLdT, 16 * w.mt0, k);
    mma_row(acc[0], a, b);
    if (w.mt0 + 1 < w.MT) {
      frag_a(a, Abuf, kLdT, 16 * w.mt0 + 16, k);
      mma_row(acc[1], a, b);
    }
  }
}

// f(row, col, v0, v1) for each pair of neighbouring columns of the warp's
// accumulators (the thread's own: row g (+8), columns 2t, 2t + 1).
template <class F>
__device__ __forceinline__ void epilogue(const float (&acc)[2][4][4], int Dp, F f) {
  const WarpTile w(Dp);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (w.mt0 + i < w.MT)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(16 * (w.mt0 + i) + g + 8 * h, w.n0 + 8 * j + 2 * t, acc[i][j][2 * h],
            acc[i][j][2 * h + 1]);
}

__device__ __forceinline__ float2 ld2(const bf16* buf, int r, int c) {
  return unpack_bf16(*reinterpret_cast<const unsigned*>(buf + r * kLdT + c));
}

__device__ __forceinline__ void st2(bf16* buf, int r, int c, float v0, float v1) {
  *reinterpret_cast<unsigned*>(buf + r * kLdT + c) = pack_bf16(v0, v1);
}

// rows x 64 of a tile buffer to a slab's columns cc.., 16-byte streaming
// stores (evict-first: the slabs are read once, by the contraction, and
// would otherwise push the weight stream and the bins' x out of L2)
__device__ void store_slab(bf16* slab, size_t A, size_t cc, const bf16* buf, int rows) {
  for (int e = threadIdx.x; e < rows * (kTile / 8); e += kWalkThreads) {
    const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
    __stcs(reinterpret_cast<int4*>(slab + r * A + cc + c),
           *reinterpret_cast<const int4*>(buf + r * kLdT + c));
  }
}

// 64 x 64 int8 block of adj (rows row0.., columns col0..; row stride ab)
// as bf16 into a buffer of stride kLdT: one 16-byte load a thread.
__device__ __forceinline__ int4 adj_load(const int8_t* adj_b, int ab, int row0, int col0) {
  const int e = threadIdx.x;
  if (e >= kTile * kTile / 16) return make_int4(0, 0, 0, 0);
  return *reinterpret_cast<const int4*>(adj_b + (size_t)(row0 + e / 4) * ab + col0 + e % 4 * 16);
}

__device__ __forceinline__ void adj_store(bf16* buf, int4 v) {
  const int e = threadIdx.x;
  if (e >= kTile * kTile / 16) return;
  const int8_t* m = reinterpret_cast<const int8_t*>(&v);
  unsigned p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = pack_bf16((float)m[2 * i], (float)m[2 * i + 1]);
  int4* d = reinterpret_cast<int4*>(buf + (e / 4) * kLdT + e % 4 * 16);
  d[0] = make_int4(p[0], p[1], p[2], p[3]);
  d[1] = make_int4(p[4], p[5], p[6], p[7]);
}

// One layer's walk, bf16 (see the top of this file), for activation code
// ACT (a template argument: with a runtime switch the epilogues ran
// markedly slower on an H100).  Grid nb * C blocks, clusters of
// C = ab / 64 (the tiles of a bin, by cluster rank).  wstream is the
// layer's weight stream (walk_stages * Dp * kKc elements), then its biases
// b_in, b1_0, b2_0, b1_1, ... ((1 + 2 n_blocks) Dp).
template <int ACT>
__global__ void __launch_bounds__(kWalkThreads, 1)
bwd_walk_kernel(const bf16* __restrict__ x_l, bf16* __restrict__ wk, float* __restrict__ g32,
                const int8_t* __restrict__ adj, const bf16* __restrict__ wstream, int D, int Dp,
                int A, int ab, int n_blocks, int dropout, int layer, unsigned seed,
                unsigned thresh, float scale) {
  constexpr int act = ACT;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = ab / kTile;
  const int rank = (int)cluster.block_rank();
  const int bin = blockIdx.x / C;
  const size_t col0 = (size_t)bin * ab, cc = col0 + (size_t)rank * kTile;
  const size_t S = (size_t)Dp * A;
  bf16* XAs = wk;
  bf16* Hs = wk + 2 * S;
  bf16* Vs = Hs + n_blocks * S;
  bf16* DHs = Vs + n_blocks * S;
  bf16* DUs = DHs + n_blocks * S;
  bf16* DTs = DUs + n_blocks * S;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  bf16* XA = tiles;                       // [x ; agg] (2 Dp rows); then G (x rows), DH (agg rows)
  bf16* G = XA;
  bf16* DH = XA + (size_t)Dp * kLdT;
  bf16* TB = XA + (size_t)2 * Dp * kLdT;  // rnd(act'(t)), then dt
  bf16* HB = TB + (size_t)Dp * kLdT;      // h_i, then dA
  bf16* VB = HB + (size_t)Dp * kLdT;      // v_i, then a copy of another tile's dA
  bf16* UB = VB + (size_t)Dp * kLdT;      // rnd(act'(u_i)) (n_blocks), then du_i; then the
                                          // adjacency block
  bf16* SC[2] = {TB, HB};                 // x chunks of the aggregation
  bf16* AB[2] = {tiles + (size_t)4 * Dp * kLdT, tiles + (size_t)(4 * Dp + kTile) * kLdT};
  bf16* ring_buf = tiles + (size_t)walk_rows(Dp, n_blocks) * kLdT;
  bf16* bias = ring_buf + (size_t)kRing * Dp * kKc;
  const int n_stages = walk_stages(Dp, n_blocks);
  Ring ring{wstream, ring_buf, Dp * kKc, n_stages, 0, 0};
  ring.start();
  const bf16* wbias = wstream + (size_t)n_stages * Dp * kKc;
  for (int e = threadIdx.x; e < (1 + 2 * n_blocks) * Dp; e += kWalkThreads) bias[e] = wbias[e];

  // --- agg[:, i] = sum_j x[:, j] adj[i, j] over the bin, 64 source atoms a chunk
  const bf16* xbin = x_l + col0;
  const int8_t* adj_b = adj + (size_t)bin * ab * ab;
  auto load_x = [&](bf16* dst, int chunk) {  // rows >= D zero-filled
    for (int e = threadIdx.x; e < Dp * (kTile / 8); e += kWalkThreads) {
      const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
      const bool in = r < D;
      cp_async16(dst + r * kLdT + c, in ? xbin + (size_t)r * A + chunk * kTile + c : x_l,
                 in ? 16 : 0);
    }
  };
  float acc[2][4][4];
  zero(acc);
  load_x(XA, rank);
  if (rank != 0) load_x(SC[0], 0);
  cp_async_commit();
  adj_store(AB[0], adj_load(adj_b, ab, rank * kTile, 0));
  for (int c = 0; c < C; ++c) {
    int4 next_adj = make_int4(0, 0, 0, 0);
    if (c + 1 < C) {
      if (c + 1 != rank) load_x(SC[(c + 1) & 1], c + 1);
      next_adj = adj_load(adj_b, ab, rank * kTile, (c + 1) * kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    smem_product(c == rank ? XA : SC[c & 1], AB[c & 1], true, Dp, acc);
    if (c + 1 < C) adj_store(AB[(c + 1) & 1], next_adj);
    __syncthreads();
  }
  epilogue(acc, Dp, [&](int r, int c, float v0, float v1) { st2(XA, Dp + r, c, v0, v1); });
  __syncthreads();
  store_slab(XAs, A, cc, XA, 2 * Dp);

  // --- recompute (grad_only)
  const bf16* b_in = bias;
  ring_product(ring, Dp, 2 * Dp, XA, XA, 2 * Dp, acc);
  epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
    const float b = to_f(b_in[r]);
    const float t0 = rnd<bf16>(rnd<bf16>(v0) + b), t1 = rnd<bf16>(rnd<bf16>(v1) + b);
    st2(TB, r, c, act_grad(act, t0), act_grad(act, t1));  // kept as rnd(act'(t))
    st2(HB, r, c, act_fn(act, t0), act_fn(act, t1));
  });
  __syncthreads();
  store_slab(Hs, A, cc, HB, Dp);
  for (int i = 0; i < n_blocks; ++i) {
    bf16* Ui = UB + (size_t)i * Dp * kLdT;
    const bf16* b1 = bias + (size_t)(1 + 2 * i) * Dp;
    const bf16* b2 = b1 + Dp;
    const unsigned mix = seed + (unsigned)(layer * n_blocks + i) * 0x9E3779B9u;
    ring_product(ring, Dp, Dp, HB, HB, Dp, acc);
    epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
      const float b = to_f(b1[r]);
      const float u[2] = {rnd<bf16>(rnd<bf16>(v0) + b), rnd<bf16>(rnd<bf16>(v1) + b)};
      float a[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        a[q] = act_fn(act, u[q]);
        if (dropout)
          a[q] = drop_keep(r, (unsigned)(cc + c + q), mix, thresh) ? rnd<bf16>(a[q]) * scale : 0.0f;
      }
      st2(Ui, r, c, act_grad(act, u[0]), act_grad(act, u[1]));  // kept as rnd(act'(u_i))
      st2(VB, r, c, a[0], a[1]);
    });
    __syncthreads();
    store_slab(Vs + i * S, A, cc, VB, Dp);
    if (i + 1 < n_blocks) {
      ring_product(ring, Dp, Dp, VB, VB, Dp, acc);
      epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
        const float b = to_f(b2[r]);
        const float2 h = ld2(HB, r, c);
        st2(HB, r, c, rnd<bf16>(rnd<bf16>(v0) + b) + h.x, rnd<bf16>(rnd<bf16>(v1) + b) + h.y);
      });
      __syncthreads();
      store_slab(Hs + (i + 1) * S, A, cc, HB, Dp);
    }
  }

  // --- walk back: g = rnd(g32), also the slab of dh_{n-1}
  for (int e = threadIdx.x; e < Dp * (kTile / 8); e += kWalkThreads) {
    const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
    const float4* src = reinterpret_cast<const float4*>(g32 + (size_t)r * A + cc + c);
    const float4 lo = src[0], hi = src[1];
    const int4 v = make_int4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                             pack_bf16(hi.z, hi.w));
    *reinterpret_cast<int4*>(G + r * kLdT + c) = v;
    __stcs(reinterpret_cast<int4*>(DHs + (n_blocks - 1) * S + (size_t)r * A + cc + c), v);
  }
  __syncthreads();
  const bf16* DHcur = G;
  for (int i = n_blocks - 1; i >= 0; --i) {
    bf16* Ui = UB + (size_t)i * Dp * kLdT;
    const unsigned mix = seed + (unsigned)(layer * n_blocks + i) * 0x9E3779B9u;
    ring_product(ring, Dp, Dp, DHcur, DHcur, Dp, acc);  // W2_i^T dh_{i+1}
    epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
      const float2 ga = ld2(Ui, r, c);  // rnd(act'(u_i))
      float dv[2] = {rnd<bf16>(v0), rnd<bf16>(v1)};
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (dropout)
          dv[q] = drop_keep(r, (unsigned)(cc + c + q), mix, thresh) ? rnd<bf16>(dv[q] * scale)
                                                                    : 0.0f;
      st2(Ui, r, c, dv[0] * ga.x, dv[1] * ga.y);
    });
    __syncthreads();
    store_slab(DUs + i * S, A, cc, Ui, Dp);
    ring_product(ring, Dp, Dp, Ui, Ui, Dp, acc);  // W1_i^T du_i
    if (i > 0) {
      const bf16* src = DHcur;
      epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
        const float2 d = ld2(src, r, c);
        st2(DH, r, c, rnd<bf16>(d.x + v0), rnd<bf16>(d.y + v1));
      });
      __syncthreads();
      store_slab(DHs + (i - 1) * S, A, cc, DH, Dp);
      DHcur = DH;
    } else {
      const bf16* src = DHcur;
      epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
        const float2 d = ld2(src, r, c), ga = ld2(TB, r, c);  // rnd(act'(t))
        st2(TB, r, c, rnd<bf16>(d.x + v0) * ga.x, rnd<bf16>(d.y + v1) * ga.y);
      });
      __syncthreads();
      store_slab(DTs, A, cc, TB, Dp);
    }
  }

  // --- dxa = [W_s^T | W_in^T] [g ; dt]: the agg rows, rounded, to dA
  bf16* DA = HB;
  ring_product(ring, Dp, 2 * Dp, G, TB, Dp, acc);
  epilogue(acc, Dp, [&](int r, int c, float v0, float v1) { st2(DA, r, c, v0, v1); });
  cluster.sync();
  // the x rows, kept in fp32; then + sum_i dA[:, i] adj[i, j] over the bin
  ring_product(ring, Dp, 2 * Dp, G, TB, Dp, acc);
  // source tile s: its dA (another block's, through distributed shared
  // memory, into VB) and adj's block (its atoms' rows, this tile's
  // columns, into ADJ); the next tile's are loaded into registers while
  // the current one's product runs
  bf16* ADJ = UB;
  constexpr int kPer = (kWalkMaxDp * (kTile / 8) + kWalkThreads - 1) / kWalkThreads;
  int4 rem_v[kPer], adj_v;
  auto fetch = [&](int s) {
    if (s != rank) {
      const bf16* rem = cluster.map_shared_rank(DA, s);
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int e = threadIdx.x + q * kWalkThreads;
        if (e < Dp * (kTile / 8))
          rem_v[q] =
              *reinterpret_cast<const int4*>(rem + (e / (kTile / 8)) * kLdT + e % (kTile / 8) * 8);
      }
    }
    adj_v = adj_load(adj_b, ab, s * kTile, rank * kTile);
  };
  auto put = [&](int s) {
    if (s != rank) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int e = threadIdx.x + q * kWalkThreads;
        if (e < Dp * (kTile / 8))
          *reinterpret_cast<int4*>(VB + (e / (kTile / 8)) * kLdT + e % (kTile / 8) * 8) = rem_v[q];
      }
    }
    adj_store(ADJ, adj_v);
  };
  fetch(0);
  put(0);
  for (int s = 0; s < C; ++s) {
    __syncthreads();
    if (s + 1 < C) fetch(s + 1);
    smem_product(s == rank ? DA : VB, ADJ, false, Dp, acc);
    __syncthreads();
    if (s + 1 < C) put(s + 1);
  }
  epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
    float2* p = reinterpret_cast<float2*>(g32 + (size_t)r * A + cc + c);
    const float2 o = *p;
    *p = make_float2(o.x + v0, o.y + v1);
  });
  cluster.sync();  // the other tiles' reads of this block's dA are done
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
  for (int e = threadIdx.x; e < Dp; e += kThreads) bias[e] = pw[(size_t)Dp * E + e];
  __syncthreads();
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    const size_t cc = col0 + c0;
    gemm_tile(pw, E, tiled, Dp, E, emb + cc, emb + cc, A, E, stage, [&](int r, int c, float v) {
      const size_t o = (size_t)r * A + cc + c;
      const float t0 = rnd<T>(rnd<T>(v) + to_f(bias[r]));
      const float d = g32[o] * rnd<T>(act_grad(act, t0));
      g32[o] = d;
      dtc[o] = from_f<T>(d);
    });
    __syncthreads();
    gemm_tile(pwT, Dp, tiled, E, Dp, dtc + cc, dtc + cc, A, Dp, stage,
              [&](int r, int c, float v) { demb[(size_t)r * A + cc + c] = from_f<T>(v); });
    __syncthreads();
  }
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
  for (int e = threadIdx.x; e < Dp; e += kThreads) bias[e] = pw[(size_t)Dp * E + e];
  for (size_t i = threadIdx.x; i < n_acc; i += kThreads) acc[i] = 0.0f;
  for (int c0 = 0; c0 < ab; c0 += kTile) {
    const size_t cc = col0 + c0;
    vocab_tile(tile, codes, bd, voc, E, cc, A);
    __syncthreads();
    gemm_tile(pw, E, tiled, Dp, E, tile, tile, kLdT, E, stage, [&](int r, int c, float v) {
      const size_t o = (size_t)r * A + cc + c;
      const float t0 = rnd<T>(rnd<T>(v) + to_f(bias[r]));
      const float d = g32[o] * rnd<T>(act_grad(act, t0));
      g32[o] = d;
      dtc[o] = from_f<T>(d);
    });
    __syncthreads();
    gemm_tile(pwT, Dp, tiled, E, Dp, dtc + cc, dtc + cc, A, Dp, stage,
              [&](int r, int c, float v) { tile[(size_t)r * kLdT + c] = from_f<T>(v); });
    __syncthreads();
    vocab_accumulate(acc, tile, codes, voc, E, cc, A);
    __syncthreads();
  }
  float* pb = part + (size_t)blockIdx.x * n_acc;
  for (size_t i = threadIdx.x; i < n_acc; i += kThreads) pb[i] = acc[i];
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

constexpr int kMaxDevices = 64;

// Sets a kernel's dynamic shared-memory ceiling once per device.
template <typename K> int configure(K kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
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
  const int err = configure(bwd_walk_kernel<ACT>, walk_configured[ACT]);
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
      &cfg, bwd_walk_kernel<ACT>, static_cast<const bf16*>(x_l), static_cast<bf16*>(wk),
      static_cast<float*>(g32), static_cast<const int8_t*>(adj),
      static_cast<const bf16*>(wstream), D, Dp, A, ab, n_blocks, dropout, layer, seed, thresh,
      scale);
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
int wgrad_group(int n, const void* const* dY, const void* const* X, const void* const* bsrc,
                const int* M, const int* N, const long long* off, void* part, long long stride,
                int bf16, int A, int chunk, void* stream) {
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

// part: (ceil(A / chunk), M * N + M) fp32 partials (see wgrad.cuh).
int wgrad(const void* dY, const void* X, const void* bsrc, void* part, int bf16, int M, int N,
          int A, int chunk, void* stream) {
  return launch_wgrad(dY, X, bsrc, part, bf16, M, N, A, chunk, static_cast<cudaStream_t>(stream));
}

// wgrad with X the (N = E, A) embeddings looked up from codes and bd.
int wgrad_vocab(const void* dY, const void* codes, const void* bd, const int* sizes, int F,
                const void* bsrc, void* part, int bf16, int M, int N, int A, int chunk,
                void* stream) {
  Vocab voc;
  if (!make_vocab(sizes, F, N, &voc)) return (int)cudaErrorInvalidValue;
  return launch_wgrad_vocab(dY, codes, bd, voc, bsrc, part, bf16, M, N, A, chunk,
                            static_cast<cudaStream_t>(stream));
}

int sum_partials(const void* part, void* out, int n, long long size, void* stream) {
  return launch_sum_partials(part, out, n, size, static_cast<cudaStream_t>(stream));
}

const char* mp_stack_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
