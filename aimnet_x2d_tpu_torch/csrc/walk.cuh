// The stack backward's bf16 walk (kernels 1b and 1d backward,
// csrc/mp_stack_bwd.cu) and, in its EXT form, kernel 5's backward
// (csrc/mp_ext.cu): one layer, recomputed from its input and walked back
// with the JAX cast points, on one 64-atom tile a block.
//
// What bounds it on an H100: the products, about 829,000 FLOP per atom
// column and layer at Dp 160 with two blocks, so tensor-core throughput,
// with the slab writes (11 slabs of (Dp, A)) second.  The design:
// - one 320-thread block per 64-atom tile; for the stack the ab / 64 tiles
//   of a bin are one thread-block cluster (768 blocks at the training batch,
//   about six waves of one block an SM), for kernel 5 there is no cluster;
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
// - the stack's aggregation: each block forms its own columns of agg from
//   the bin's x (L2-resident), 64 source atoms a chunk, double-buffered; the
//   transpose reads the cluster's other dA tiles from distributed shared
//   memory after a cluster barrier, in rank order, so t, u_i and dA never
//   reach device memory; kernel 5's caller has aggregated already and
//   transposes its own aggregation, so its walk loads xa's tile by cp.async
//   and writes both halves of dxa, rounded, itself;
// - the slab writes are 16-byte streaming stores of the operands the
//   weight gradients read (csrc/wgrad_group.cuh contracts them in one launch
//   a layer).
// mma.sync, not wgmma: wgmma takes 64-row tiles, and Dp 160 is 2.5 of
// them; m16n8k16 tiles cover it exactly with 10 warps of 32 x 32 outputs.
// The walk takes Dp <= 160 and ab <= 512 (clusters of up to 8) while its
// buffers fit one block's shared memory (up to 3 MLP blocks at Dp 160).
//
// Its device pieces (the weight ring, the warp tiles, ring_product,
// smem_product, epilogue, the adjacency blocks) are also the building
// blocks of kernel 4's tiled kernels (csrc/inject.cu), the attention pool's
// tiled backward (csrc/attnpool.cu) and the stack's tiled forward
// (csrc/mp_stack.cu).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

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

// acc += sum over the cluster's tiles s, in rank order, of T_s adj_s: T_s
// the (Dp x 64) [m][k] tile at `own` in block s (another block's read
// through distributed shared memory into `copy`), adj_s the 64 x 64 block
// of the bin's adjacency adj_b (ab x ab int8) with s's atoms as rows and
// this block's as columns (into `adjbuf`) -- the transpose of a per-bin
// aggregation, without atomics.  The next tile's operands are loaded into
// registers while the current product runs.  `own` has the same offset in
// every block of the cluster, and is not written until a later cluster
// barrier.
__device__ void cluster_transpose(cooperative_groups::cluster_group& cluster, const bf16* own,
                                  bf16* copy, bf16* adjbuf, const int8_t* adj_b, int ab, int Dp,
                                  float (&acc)[2][4][4]) {
  const int C = ab / kTile, rank = (int)cluster.block_rank();
  constexpr int kPer = (kWalkMaxDp * (kTile / 8) + kWalkThreads - 1) / kWalkThreads;
  int4 rem_v[kPer], adj_v;
  auto fetch = [&](int s) {
    if (s != rank) {
      const bf16* rem = cluster.map_shared_rank(own, s);
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
          *reinterpret_cast<int4*>(copy + (e / (kTile / 8)) * kLdT + e % (kTile / 8) * 8) =
              rem_v[q];
      }
    }
    adj_store(adjbuf, adj_v);
  };
  fetch(0);
  put(0);
  for (int s = 0; s < C; ++s) {
    __syncthreads();
    if (s + 1 < C) fetch(s + 1);
    smem_product(s == rank ? own : copy, adjbuf, false, Dp, acc);
    __syncthreads();
    if (s + 1 < C) put(s + 1);
  }
}

// One layer's walk, bf16 (see the top of this file), for activation code
// ACT (a template argument: with a runtime switch the epilogues ran
// markedly slower on an H100).  wstream is the layer's weight stream
// (walk_stages * Dp * kKc elements), then its biases b_in, b1_0, b2_0, b1_1,
// ... ((1 + 2 n_blocks) Dp).
// - EXT false, the stack (kernel 1b, 1d backward): grid nb * C blocks,
//   clusters of C = ab / 64 (the tiles of a bin, by cluster rank); x_l the
//   layer's input (D, A), g32 the fp32 carry (Dp, A), updated in place; gin
//   and dxa unused.
// - EXT true, kernel 5's backward (csrc/mp_ext.cu): grid A / 64 blocks, no
//   cluster (ab = 64); x_l is the caller's xa = [x ; agg] (2D, A), gin the
//   bf16 cotangent g (D, A) of the layer's output, and dxa (2D, A) receives
//   rnd([W_s^T | W_in^T] [g ; dt]); no aggregation, no transpose, g32 and
//   adj unused.  layer = 0, so the dropout tags are kernel 5's.
template <int ACT, bool EXT>
__global__ void __launch_bounds__(kWalkThreads, 1)
bwd_walk_kernel(const bf16* __restrict__ x_l, bf16* __restrict__ wk, float* __restrict__ g32,
                const int8_t* __restrict__ adj, const bf16* __restrict__ wstream,
                const bf16* __restrict__ gin, bf16* __restrict__ dxa, int D, int Dp, int A,
                int ab, int n_blocks, int dropout, int layer, unsigned seed, unsigned thresh,
                float scale) {
  constexpr int act = ACT;
  namespace cg = cooperative_groups;
  const int C = EXT ? 1 : ab / kTile;
  int rank = 0;
  if constexpr (!EXT) rank = (int)cg::this_cluster().block_rank();
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
  bf16* HB = TB + (size_t)Dp * kLdT;      // h_i, then dA (EXT: dxa's agg half)
  bf16* VB = HB + (size_t)Dp * kLdT;      // v_i, then a copy of another tile's dA (EXT: dxa's
                                          // x half)
  bf16* UB = VB + (size_t)Dp * kLdT;      // rnd(act'(u_i)) (n_blocks), then du_i; then the
                                          // adjacency block
  bf16* ring_buf = tiles + (size_t)walk_rows(Dp, n_blocks) * kLdT;
  bf16* bias = ring_buf + (size_t)kRing * Dp * kKc;
  const int n_stages = walk_stages(Dp, n_blocks);
  Ring ring{wstream, ring_buf, Dp * kKc, n_stages, 0, 0};
  ring.start();
  const bf16* wbias = wstream + (size_t)n_stages * Dp * kKc;
  for (int e = threadIdx.x; e < (1 + 2 * n_blocks) * Dp; e += kWalkThreads) bias[e] = wbias[e];

  float acc[2][4][4];
  if constexpr (EXT) {
    // --- xa's tile: rows D..Dp of each half zero-filled
    for (int e = threadIdx.x; e < 2 * Dp * (kTile / 8); e += kWalkThreads) {
      const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
      const int half = r >= Dp, rr = r - half * Dp;
      const bool in = rr < D;
      cp_async16(XA + r * kLdT + c, in ? x_l + (size_t)(half * D + rr) * A + cc + c : x_l,
                 in ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  } else {
    // --- agg[:, i] = sum_j x[:, j] adj[i, j] over the bin, 64 source atoms a chunk
    const int8_t* adj_b = adj + (size_t)bin * ab * ab;
    bf16* SC[2] = {TB, HB};  // x chunks of the aggregation
    bf16* AB[2] = {tiles + (size_t)4 * Dp * kLdT, tiles + (size_t)(4 * Dp + kTile) * kLdT};
    const bf16* xbin = x_l + col0;
    auto load_x = [&](bf16* dst, int chunk) {  // rows >= D zero-filled
      for (int e = threadIdx.x; e < Dp * (kTile / 8); e += kWalkThreads) {
        const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
        const bool in = r < D;
        cp_async16(dst + r * kLdT + c, in ? xbin + (size_t)r * A + chunk * kTile + c : x_l,
                   in ? 16 : 0);
      }
    };
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
  }
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

  // --- walk back: g = rnd(g32) (EXT: g, rows past D zero), also the slab of dh_{n-1}
  for (int e = threadIdx.x; e < Dp * (kTile / 8); e += kWalkThreads) {
    const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
    int4 v = make_int4(0, 0, 0, 0);
    if constexpr (EXT) {
      if (r < D) v = *reinterpret_cast<const int4*>(gin + (size_t)r * A + cc + c);
    } else {
      const float4* src = reinterpret_cast<const float4*>(g32 + (size_t)r * A + cc + c);
      const float4 lo = src[0], hi = src[1];
      v = make_int4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                    pack_bf16(hi.z, hi.w));
    }
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
  if constexpr (EXT) {
    // the x rows, rounded, to VB; both halves' real rows to dxa
    ring_product(ring, Dp, 2 * Dp, G, TB, Dp, acc);
    epilogue(acc, Dp, [&](int r, int c, float v0, float v1) { st2(VB, r, c, v0, v1); });
    __syncthreads();
    for (int e = threadIdx.x; e < 2 * D * (kTile / 8); e += kWalkThreads) {
      const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
      const bf16* src = r < D ? VB + r * kLdT : DA + (r - D) * kLdT;
      *reinterpret_cast<int4*>(dxa + (size_t)r * A + cc + c) =
          *reinterpret_cast<const int4*>(src + c);
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    // the x rows, kept in fp32; then + sum_i dA[:, i] adj[i, j] over the bin
    ring_product(ring, Dp, 2 * Dp, G, TB, Dp, acc);
    cluster_transpose(cluster, DA, VB, UB, adj + (size_t)bin * ab * ab, ab, Dp, acc);
    epilogue(acc, Dp, [&](int r, int c, float v0, float v1) {
      float2* p = reinterpret_cast<float2*>(g32 + (size_t)r * A + cc + c);
      const float2 o = *p;
      *p = make_float2(o.x + v0, o.y + v1);
    });
    cluster.sync();  // the other tiles' reads of this block's dA are done
  }
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

}  // namespace
