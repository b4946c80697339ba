// One shell-convolution layer on a pre-aggregated input, forward and
// backward: kernel 5 of the port, the layer of halo graph-partitioned
// training.
//
// Replaces the TPU kernel aimnet_x2d_tpu/ops/bin_mp.py::_make_ext_layer_op
// (fwd_kernel, pallas_call of ``forward`` at :1167; bwd_kernel, pallas_call of
// ``backward_call`` at :1196), reached through binned_mp_layer_ext_t.  The
// caller has already built the aggregation -- the local per-bin product plus
// the halo rows' contribution (ops/halo.py) -- and hands the layer
// xa = [x ; agg] (2D, A) in the compute dtype, feature-major (features on
// rows, the rank's atoms on columns).  Per atom column:
//
//     t = W_in xa + b_in ;  h = act(t)
//     n_blocks x:  u = W1 h + b1 ; v = drop(act(u)) ; h = (W2 v + b2) + h
//     out = h + (W_s xa + b_s)                     (no residual: the caller adds it)
//
// with the JAX cast points (every product accumulates in fp32 and is rounded
// to the compute dtype, then the bias add, the activation and every add round
// again) and the JAX kernel's dropout: the murmur3 hash of (feature row, the
// rank's local atom column, block tag i, seed), bit-equal to its mask.  The
// backward recomputes the chain from xa (grad_only: no skip product, no last
// W2), walks it back with the same cast points as the stack's backward and
// writes dxa = rnd([W_s^T | W_in^T] [g ; dt]) whole -- the caller transposes
// its aggregation -- and every per-atom operand of the weight gradients to
// slabs of a work buffer, in the stack walk's slab order (ops/bin_mp.py::
// bwd_slabs); the wrapper then forms the fp32 weight and bias gradients of
// the layer's 2 + 2 n_blocks products in one launch of the grouped split-K
// contraction (csrc/wgrad_group.cuh), chunk partials summed in a fixed
// order, so reruns are bit-equal (no atomics).
//
// What bounds it on an H100: the products, 2 * A * sum|W| FLOP forward
// (~2.0 GFLOP at D = 153, 2 blocks, 12k atoms) against ~2 x 2D x A bytes, so
// tensor-core throughput, not memory.  Nothing mixes atoms, so one block per
// 64-atom column tile.  The forward keeps the tile's xa (2Dp x 64), h and v
// in shared memory (104 KB in bf16, 198 KB in fp32) and reads the weights
// from L2 (tile-major in bf16, as the stack kernel): ext_fwd_kernel, for
// fp32 and the bf16 shapes the wgmma kernel does not take.
//
// The bf16 forward on wgmma (ext_fwd_wg_kernel; Dp a multiple of 32 up to
// 160, at least one block).  ext_fwd_kernel's phase split on an H100
// (-DMP_EXT_MARKS) put half of a tile's product time in the epilogues, with
// the tensor cores idle, and the rest in mma.sync chains waiting on weight
// loads from L2.  The design:
// - the products with the atoms as rows, out^T = xa^T W^T on
//   wgmma.mma_async m64nDpk16 (M the tile's 64 atoms, N = Dp, fp32
//   accumulators in registers, Dp / 2 a thread): A is xa's tile (MN-major:
//   xa is feature-major) or h and v (K-major, written so by the epilogues),
//   B the weights, all from shared memory without swizzle (csrc/wgmma.cuh);
// - W_s first, then W_in, both on xa's tile, s kept rounded and packed in
//   registers, so xa's buffer frees after the second product;
// - warp specialisation: persistent blocks, one an SM, of three
//   warpgroups; a producer warp loads each consumer's next xa tile by
//   cp.async onto an mbarrier (the padded rows zero-filled) as soon as its
//   buffer frees, another streams the weights (one stream a layer,
//   ops/bin_mp.py::ext_wg_stream_index: stages of 32 K-rows in wgmma's
//   layout) by cp.async.bulk into a ring with a full and an empty mbarrier a
//   slot (csrc/ring.cuh); the producers hand registers to the consumers by
//   setmaxnreg (40 / 232), each product has one accumulator of Dp / 2
//   registers (an H100 build with two, W_in and W_s together, spilled),
//   and the consumers wait in asm loops (ptxas serialises a wgmma that
//   follows a branch it cannot prove uniform);
// - tiles round-robin over the blocks, so a last round of fewer tiles
//   than blocks x 2 falls to as many blocks, one tile each;
// - ping-pong: the two consumer warpgroups each run their own tile, so one's
//   epilogue runs under the other's wgmma, and both read every stage of the
//   one ring, so a weight stage crosses L2 once for two tiles;
// - the epilogues on the accumulator registers: bias, activation, the
//   dropout keep (the murmur3 hash of (feature, the rank's local atom
//   column, block tag, seed), bit-equal to the JAX mask, indexed through
//   the accumulator layout) and every cast where ext_fwd_kernel applies
//   them; out = rnd(h + s) goes through a swizzled staging tile to (D, A)
//   by 16-byte stores.
// No atomics: reruns are bit-equal.  The bf16 backward is
// the stack's walk (csrc/walk.cuh, bwd_walk_kernel in its EXT form: the
// chain in shared memory, the weights streamed through a cp.async ring in
// fragment order, mma.sync; no aggregation, no transpose, no cluster) while
// Dp <= 160 and its buffers fit one block (mp_ext_bwd_walk); fp32, and bf16
// shapes past that, take ext_bwd_kernel, which streams its operands through
// L2-resident global slabs (mp_ext_bwd).

#include <type_traits>

#include "common.cuh"
#include "ring.cuh"
#include "walk.cuh"
#include "wgmma.cuh"

namespace {

// Built with -DMP_EXT_MARKS, ext_fwd_kernel records per block a
// %globaltimer mark after a block barrier at each phase boundary (marks
// 0 .. 4 + 2 n_blocks: start, the xa tile, the biases, W_in, W1_i and W2_i
// of each block, W_s with the output store) and, from mark kExtClocks on,
// each product's SM clocks summed over its warps' strips, in the products
// and in their epilogues (two per product); chip_smoke.py's [halo-kernel]
// "mp_ext_fwd phases" lines read them (mp_ext_marks).
#ifdef MP_EXT_MARKS
constexpr int kExtMarks = 40;   // marks a block may record
constexpr int kExtClocks = 16;  // the first product's clocks
__device__ unsigned long long* g_ext_marks;  // (blocks, kExtMarks), set by mp_ext_marks
__shared__ unsigned long long ext_clk[2];     // the current product's mma and epilogue clocks
// A bf16 product's epilogue, clocked: the bf16 gemm_tile calls it for each
// 16-row strip first at (m0, 0) and last at (m0 + 14, kTile - 16) in lane
// 0, so lane 0 of each warp adds the clocks from the strip's start (the
// product's, or the last strip's end) to its first element to the products
// (the strip's first staging store with them), and those to its last
// element to the epilogue.  fp32 products are not clocked.
template <typename T, class Epi> __device__ __forceinline__ auto clocked(Epi epi) {
  if constexpr (!std::is_same_v<T, __nv_bfloat16>) return epi;
  else return [epi, t0 = clock64(), t1 = 0ll](int r, int c, float v) mutable {
    const bool lead = (threadIdx.x & 31) == 0;
    if (lead && c == 0 && r % 16 == 0) t1 = clock64();
    epi(r, c, v);
    if (lead && c == kTile - 16 && r % 16 == 14) {
      const long long t2 = clock64();
      atomicAdd(&ext_clk[0], (unsigned long long)(t1 - t0));
      atomicAdd(&ext_clk[1], (unsigned long long)(t2 - t1));
      t0 = t2;
    }
  };
}
#define EXT_EPI(...) clocked<T>(__VA_ARGS__)
__device__ __forceinline__ void ext_mark(int i) {
  __syncthreads();
  if (threadIdx.x == 0 && i < kExtMarks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_ext_marks[(size_t)blockIdx.x * kExtMarks + i] = t;
  }
}
// after product p's barrier: its clocks to the marks, the sums reset
__device__ __forceinline__ void ext_product_done(int p) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const int i = kExtClocks + 2 * p;
    if (i + 1 < kExtMarks) {
      g_ext_marks[(size_t)blockIdx.x * kExtMarks + i] = ext_clk[0];
      g_ext_marks[(size_t)blockIdx.x * kExtMarks + i + 1] = ext_clk[1];
    }
    ext_clk[0] = ext_clk[1] = 0;
  }
  __syncthreads();
}
#else
__device__ __forceinline__ void ext_mark(int) {}
__device__ __forceinline__ void ext_product_done(int) {}
// The epilogue goes to gemm_tile as written: passed through even an
// identity function, the fp32 kernel ran ~13% slower on an H100.
#define EXT_EPI(...) __VA_ARGS__
#endif

template <typename T>
size_t ext_fwd_smem_bytes(int Dp, int n_blocks) {
  return (size_t)kWarps * 256 * sizeof(float) + (size_t)4 * Dp * kLdT * sizeof(T) +
         (size_t)(2 + 2 * n_blocks) * Dp * sizeof(T);
}

template <typename T>
size_t ext_bwd_smem_bytes(int Dp, int n_blocks) {
  return (size_t)kWarps * 256 * sizeof(float) + (size_t)(2 + 2 * n_blocks) * Dp * sizeof(T);
}

// The layer's biases, b_in, b_s, then b1, b2 of each block, into shared memory.
template <typename T>
__device__ void load_biases(T* bias, const T* w, int Dp, int n_blocks) {
  const size_t mat2 = (size_t)Dp * 2 * Dp, mat1 = (size_t)Dp * Dp;
  const size_t block_sz = 2 * mat1 + 2 * (size_t)Dp;
  const T* w_in = w;
  const T* w_s = w_in + mat2 + Dp;
  const T* blocks = w_s + mat2 + Dp;
  for (int e = threadIdx.x; e < (2 + 2 * n_blocks) * Dp; e += kThreads) {
    const int seg = e / Dp, r = e % Dp;
    const T* blk = blocks + (size_t)(seg / 2 - 1) * block_sz;  // used for seg >= 2
    const T* src = seg == 0 ? w_in + mat2 : seg == 1 ? w_s + mat2
                 : blk + (seg % 2 ? 2 * mat1 + Dp : mat1);
    bias[e] = src[r];
  }
}

// Row r of the padded [x ; agg] (2Dp rows) in the caller's (2D, A) xa, or -1
// for a padded row.
__device__ __forceinline__ int xa_row(int r, int D, int Dp) {
  if (r < Dp) return r < D ? r : -1;
  return r - Dp < D ? D + r - Dp : -1;
}

// One block per 64-atom tile.  xa (2D, A), out (D, A); w is the layer's
// prepped weights (ops/bin_mp.py::prep_layer, tile-major in bf16).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ext_fwd_kernel(const T* __restrict__ xa, T* __restrict__ out, const T* __restrict__ w, int D,
               int Dp, int A, int n_blocks, int act, int dropout, unsigned seed,
               unsigned thresh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  T* xs = reinterpret_cast<T*>(smem + (size_t)kWarps * 256 * sizeof(float));  // 2Dp x kLdT
  T* hbuf = xs + (size_t)2 * Dp * kLdT;
  T* vbuf = hbuf + (size_t)Dp * kLdT;
  T* bias = vbuf + (size_t)Dp * kLdT;
  const size_t col0 = (size_t)blockIdx.x * kTile;
  const bool tiled = sizeof(T) == 2;
  const int K2 = 2 * Dp;
  const size_t mat2 = (size_t)Dp * K2, mat1 = (size_t)Dp * Dp;
  const size_t block_sz = 2 * mat1 + 2 * (size_t)Dp;
  const T* w_in = w;
  const T* w_s = w_in + mat2 + Dp;
  const T* blocks = w_s + mat2 + Dp;
#ifdef MP_EXT_MARKS
  if (threadIdx.x == 0) ext_clk[0] = ext_clk[1] = 0;
#endif
  ext_mark(0);

  // the tile of xa, padded rows zero, in 16-byte vectors
  constexpr int V = 16 / sizeof(T);
  for (int e = threadIdx.x; e < K2 * kTile / V; e += kThreads) {
    const int r = e / (kTile / V), c = e % (kTile / V) * V;
    const int src = xa_row(r, D, Dp);
    int4 v = make_int4(0, 0, 0, 0);
    if (src >= 0) v = *reinterpret_cast<const int4*>(xa + (size_t)src * A + col0 + c);
    *reinterpret_cast<int4*>(xs + (size_t)r * kLdT + c) = v;
  }
  ext_mark(1);
  load_biases(bias, w, Dp, n_blocks);
  __syncthreads();
  ext_mark(2);

  const T* b_in = bias;
  const T* b_s = bias + Dp;
  gemm_tile(w_in, K2, tiled, Dp, K2, xs, xs, kLdT, K2, stage, EXT_EPI([&](int r, int c, float v) {
    hbuf[r * kLdT + c] = from_f<T>(act_fn(act, rnd<T>(rnd<T>(v) + to_f(b_in[r]))));
  }));
  __syncthreads();
  ext_product_done(0);
  ext_mark(3);
  for (int i = 0; i < n_blocks; ++i) {
    const T* w1 = blocks + (size_t)i * block_sz;
    const T* w2 = w1 + mat1 + Dp;
    const T* b1 = bias + (2 + 2 * i) * Dp;
    const T* b2 = b1 + Dp;
    const unsigned mix = seed + (unsigned)i * 0x9E3779B9u;
    gemm_tile(w1, Dp, tiled, Dp, Dp, hbuf, hbuf, kLdT, Dp, stage, EXT_EPI([&](int r, int c, float v) {
      float a = act_fn(act, rnd<T>(rnd<T>(v) + to_f(b1[r])));
      if (dropout) a = drop_keep(r, (unsigned)(col0 + c), mix, thresh) ? rnd<T>(a) * scale : 0.0f;
      vbuf[r * kLdT + c] = from_f<T>(a);
    }));
    __syncthreads();
    ext_product_done(1 + 2 * i);
    ext_mark(4 + 2 * i);
    gemm_tile(w2, Dp, tiled, Dp, Dp, vbuf, vbuf, kLdT, Dp, stage, EXT_EPI([&](int r, int c, float v) {
      const float y = rnd<T>(rnd<T>(v) + to_f(b2[r]));
      hbuf[r * kLdT + c] = from_f<T>(y + to_f(hbuf[r * kLdT + c]));
    }));
    __syncthreads();
    ext_product_done(2 + 2 * i);
    ext_mark(5 + 2 * i);
  }
  // skip projection; out = h + s, the real rows only
  gemm_tile(w_s, K2, tiled, Dp, K2, xs, xs, kLdT, K2, stage, EXT_EPI([&](int r, int c, float v) {
    if (r < D) {
      const float s = rnd<T>(rnd<T>(v) + to_f(b_s[r]));
      out[(size_t)r * A + col0 + c] = from_f<T>(to_f(hbuf[r * kLdT + c]) + s);
    }
  }));
  ext_product_done(1 + 2 * n_blocks);
  ext_mark(4 + 2 * n_blocks);
}

// One block per 64-atom tile.  wk holds 5 * n_blocks + 4 slabs of (Dp, A):
// xa (two slabs: the x rows, then the agg rows, padded), h_i, v_i, dh_i
// (dh_{n-1} = g), du_i, dt -- the walk's slabs, which the contraction reads
// -- then t and u_i.  g (D, A) is the cotangent of out; dxa
// (2D, A) receives the cotangent of xa.  wT: [W_s^T | W_in^T], then W1^T, W2^T
// of each block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ext_bwd_kernel(const T* __restrict__ xa, const T* __restrict__ g, T* __restrict__ dxa, T* wk,
               const T* __restrict__ w, const T* __restrict__ wT, int D, int Dp, int A,
               int n_blocks, int act, int dropout, unsigned seed, unsigned thresh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  T* bias = reinterpret_cast<T*>(smem + (size_t)kWarps * 256 * sizeof(float));
  const size_t cc = (size_t)blockIdx.x * kTile;
  const size_t S = (size_t)Dp * A;
  T* XA = wk;
  T* H = wk + 2 * S;
  T* Vs = H + n_blocks * S;
  T* DH = Vs + n_blocks * S;
  T* DU = DH + n_blocks * S;
  T* DT = DU + n_blocks * S;
  T* Tb = DT + S;
  T* U = Tb + S;
  T* G = DH + (size_t)(n_blocks - 1) * S;

  const bool tiled = sizeof(T) == 2;
  const int K2 = 2 * Dp;
  const size_t mat2 = (size_t)Dp * K2, mat1 = (size_t)Dp * Dp;
  const size_t block_sz = 2 * mat1 + 2 * (size_t)Dp;
  const T* w_in = w;
  const T* blocks = w_in + 2 * (mat2 + Dp);

  // the padded xa and g tiles into their slabs
  constexpr int V = 16 / sizeof(T);
  for (int e = threadIdx.x; e < (K2 + Dp) * kTile / V; e += kThreads) {
    const int r = e / (kTile / V), c = e % (kTile / V) * V;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < K2) {
      const int src = xa_row(r, D, Dp);
      if (src >= 0) v = *reinterpret_cast<const int4*>(xa + (size_t)src * A + cc + c);
      *reinterpret_cast<int4*>(XA + (size_t)r * A + cc + c) = v;
    } else {
      const int rr = r - K2;
      if (rr < D) v = *reinterpret_cast<const int4*>(g + (size_t)rr * A + cc + c);
      *reinterpret_cast<int4*>(G + (size_t)rr * A + cc + c) = v;
    }
  }
  load_biases(bias, w, Dp, n_blocks);
  __syncthreads();

  // --- recompute (grad_only)
  const T* b_in = bias;
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
    const unsigned mix = seed + (unsigned)i * 0x9E3779B9u;
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
  for (int i = n_blocks - 1; i >= 0; --i) {
    const T* w1T = wT + 4 * mat1 + (size_t)i * 2 * mat1;
    const T* w2T = w1T + mat1;
    const T* Ui = U + i * S;
    T* DHi = DH + i * S;
    T* DUi = DU + i * S;
    const unsigned mix = seed + (unsigned)i * 0x9E3779B9u;
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
  // dxa = rnd([W_s^T | W_in^T] [g ; dt]), the real rows
  gemm_tile(wT, K2, tiled, K2, K2, G + cc, DT + cc, A, Dp, stage, [&](int r, int c, float v) {
    const int dst = xa_row(r, D, Dp);
    if (dst >= 0) dxa[(size_t)dst * A + cc + c] = from_f<T>(v);
  });
}

template <typename T>
int launch_fwd(const void* xa, void* out, const void* w, int D, int Dp, int A, int n_blocks,
               int act, int dropout, unsigned seed, unsigned thresh, float scale,
               cudaStream_t s) {
  const size_t bytes = ext_fwd_smem_bytes<T>(Dp, n_blocks);
  if (bytes > (size_t)kSmemLimit || A % kTile || Dp % 16 || D > Dp)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ext_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ext_fwd_kernel<T><<<A / kTile, kThreads, bytes, s>>>(
      static_cast<const T*>(xa), static_cast<T*>(out), static_cast<const T*>(w), D, Dp, A,
      n_blocks, act, dropout, seed, thresh, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* xa, const void* g, void* dxa, void* wk, const void* w, const void* wT,
               int D, int Dp, int A, int n_blocks, int act, int dropout, unsigned seed,
               unsigned thresh, float scale, cudaStream_t s) {
  const size_t bytes = ext_bwd_smem_bytes<T>(Dp, n_blocks);
  if (bytes > (size_t)kSmemLimit || A % kTile || Dp % 16 || D > Dp || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  ext_bwd_kernel<T><<<A / kTile, kThreads, bytes, s>>>(
      static_cast<const T*>(xa), static_cast<const T*>(g), static_cast<T*>(dxa),
      static_cast<T*>(wk), static_cast<const T*>(w), static_cast<const T*>(wT), D, Dp, A,
      n_blocks, act, dropout, seed, thresh, scale);
  return (int)cudaGetLastError();
}

// ---- the bf16 forward on wgmma (ext_fwd_wg_kernel) ------------------------

constexpr int kWgThreads = 384;  // consumer warpgroups 0 and 1, the producer warpgroup 2
constexpr int kWgSlots = 6;      // weight-ring slots
constexpr int kWgKc = 32;        // K of a weight stage
constexpr int kWgHead = 256;     // bytes of barriers at the head of shared memory

// Per Dp: R accumulators a thread, the bytes of a warpgroup's xa tile, of its
// h or v tile and of a weight stage, the stages of the products on xa (W_s,
// then W_in) and of W1 or W2.
template <int DP> struct ExtWg {
  static constexpr int R = DP / 2;
  static constexpr int XA = 2 * DP * kTile * 2;
  static constexpr int HV = DP * kTile * 2;
  static constexpr int STAGE = kWgKc * DP * 2;
  static constexpr int P1 = 4 * DP / kWgKc;
  static constexpr int PB = DP / kWgKc;
};

// Stages of the layer's stream (ops/bin_mp.py::ext_wg_stream_index): W_s,
// W_in, then W1_i and W2_i of each block.
__host__ __device__ __forceinline__ int ext_wg_stages(int Dp, int n_blocks) {
  return (4 * Dp + 2 * n_blocks * Dp) / kWgKc;
}

size_t ext_wg_smem_bytes(int Dp, int n_blocks) {
  return kWgHead + (size_t)2 * 4 * Dp * kTile * sizeof(bf16) +
         (size_t)kWgSlots * kWgKc * Dp * sizeof(bf16) + (size_t)(2 + 2 * n_blocks) * Dp * sizeof(bf16);
}

bool ext_wg_fits(int Dp, int n_blocks) {
  return Dp % kWgKc == 0 && Dp >= 32 && Dp <= 160 && n_blocks >= 1 &&
         ext_wg_smem_bytes(Dp, n_blocks) <= (size_t)kSmemLimit;
}

// The consumers' mbarrier wait: the polling loop inside one asm block, so
// the compiler sees no data-dependent branch before the wgmma that follow
// (it serialises wgmma in a path it takes for divergent).  A wait that
// polls 2^26 times (seconds) is a fault: it traps, as mbar_wait does.
__device__ __forceinline__ void wg_wait_bar(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 67108864;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One arrival on bar where pred holds, as one predicated instruction (no
// branch around it).
__device__ __forceinline__ void wg_arrive_if(unsigned long long* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"((int)pred)
      : "memory");
}

__device__ __forceinline__ void named_bar(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void st_u32(unsigned char* p, unsigned v) {
  *reinterpret_cast<unsigned*>(p) = v;
}

__device__ __forceinline__ unsigned ld_u32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

#ifdef MP_EXT_MARKS
// The new kernel's marks: per consumer warpgroup w, SM clocks summed over its
// tiles at w * 8 + (0 xa waits, 1 weight waits, 2 products without the
// waits, 3 epilogues, 4 output store, 5 tiles, 6 the warpgroup's span);
// the weight producer's at 16 + (0 waits for a free slot, 6 its span), the
// xa producer's at 24 + (1 waits for a free xa buffer, 6 its span).
struct WgClock {
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
  __device__ void tile() { acc[5] += 1; }
  __device__ void write(int base) {
    acc[6] = clock64() - acc[6];
    for (int k = 0; k < 7; ++k) g_ext_marks[(size_t)blockIdx.x * kExtMarks + base + k] = acc[k];
  }
};
#else
struct WgClock {
  __device__ void start() {}
  __device__ void lap(int) {}
  __device__ void tile() {}
  __device__ void write(int) {}
};
#endif

// One warpgroup's product acc (64 x DP) = A (64 x 32 kc chunks) W^T from the
// ring's next nk stages, two wgmma of K 16 a stage; a_desc(k16) the A
// descriptor of K-step k16.  One commit group a stage, one in flight: a
// stage's slot is given back once the group after it is issued and it has
// completed.
template <int DP, int TA, class ADesc>
__device__ __forceinline__ void wg_product(float (&acc)[DP / 2], int nk, ADesc a_desc,
                                           unsigned char* ring, unsigned long long* full,
                                           unsigned long long* empty, int& c, bool lead,
                                           WgClock& clk) {
  using L = ExtWg<DP>;
  wg_fence_acc(acc);
  wg_fence();
  for (int kc = 0; kc < nk; ++kc, ++c) {
    const int slot = c % kWgSlots;
    clk.lap(2);
    wg_wait_bar(full + slot, (c / kWgSlots) & 1);
    clk.lap(1);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      Wgmma<DP, TA>::run(acc, a_desc(2 * kc + kk),
                         wg_desc(ring + slot * L::STAGE + kk * 256, 128, 512), kc + kk > 0);
    wg_commit();
    if (kc > 0) {
      wg_wait<1>();
      wg_arrive_if(empty + (c - 1) % kWgSlots, lead);
    }
  }
  wg_wait<0>();
  wg_arrive_if(empty + (c - 1) % kWgSlots, lead);
  wg_fence_acc(acc);
  clk.lap(2);
}

// K-major A (h or v, [atom][feature]) of K-step k16: core matrices of 8
// atoms x 8 features, 16 DP bytes between atom groups.
template <int DP> struct KMajor {
  const unsigned char* p;
  __device__ uint64_t operator()(int k16) const { return wg_desc(p + k16 * 256, 128, 16 * DP); }
};

// The activation of the wgmma kernel's epilogues: SiLU by the fast exp and
// division, the others as act_fn.  Its values round to bf16 at once, and
// differ from act_fn's by at most a bf16 step where the rounding falls
// between the two.  act_fn's exact form made the layer much slower on an
// H100, with the same largest error against the plain version (PERF.md,
// PR 15).
template <int ACT> __device__ __forceinline__ float wg_act(float u) {
  if constexpr (ACT == 0) return __fdividef(u, 1.0f + __expf(-u));
  return act_fn(ACT, u);
}

// The epilogues' bf16 pair arithmetic.  rnd(rnd(a0) + b) is one bf16 add
// of the rounded pair and the bias pair, as are the residual adds (the fp32
// sum of two bf16 values, rounded to bf16, is their bf16 sum bit for bit);
// rnd(rnd(a) * scale) one bf16 multiply by the scale, a bf16 value (the
// product of two bf16 values is exact in fp32).
__device__ __forceinline__ __nv_bfloat162 pair(unsigned v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}
__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bias_add(float a0, float a1, const bf16* b) {
  return __hadd2(__floats2bfloat162_rn(a0, a1), *reinterpret_cast<const __nv_bfloat162*>(b));
}
template <int ACT> __device__ __forceinline__ __nv_bfloat162 act2(__nv_bfloat162 u) {
  const float2 f = __bfloat1622float2(u);
  return __floats2bfloat162_rn(wg_act<ACT>(f.x), wg_act<ACT>(f.y));
}

// The accumulator pair (4j + 2h, + 1) of thread (w, g, t) of a warpgroup:
// atom row 16w + g + 8h, features 8j + 2t, + 1.  Its byte offset in a
// K-major [atom][feature] tile (core matrices of 8 atoms x 8 features).
template <int DP>
__device__ __forceinline__ int kmajor_off(int w, int g, int t, int j, int h) {
  return (2 * w + h) * 16 * DP + j * 128 + g * 16 + t * 4;
}

// MN-major A (xa's tile, [feature][atom]) of K-step k16: core matrices of
// 8 features x 8 atoms, 128 bytes apart along the atoms, 1024 along the
// features.
struct MNMajor {
  const unsigned char* p;
  __device__ uint64_t operator()(int k16) const { return wg_desc(p + k16 * 2048, 1024, 128); }
};

// The layer's chain on the consumer warpgroup's tiles (see
// ext_fwd_wg_kernel).
template <int DP, int ACT>
__device__ void ext_wg_consumer(bf16* __restrict__ out, unsigned char* xs, unsigned char* hs,
                                unsigned char* vs, unsigned char* ring, unsigned long long* bars,
                                const bf16* bias, int D, int A, int n_blocks, int dropout,
                                unsigned seed, unsigned thresh, float scale) {
  using L = ExtWg<DP>;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);  // the scale is a bf16 value
  const bf16 zero = __float2bfloat16(0.0f);
  unsigned long long* full = bars;
  unsigned long long* empty = bars + kWgSlots;
  // the warpgroup, uniform across its warps as the compiler sees it (wgmma
  // in a path it takes for divergent is serialised)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0), T = threadIdx.x & 127;
  unsigned long long* xa_full = bars + 2 * kWgSlots + wg;
  unsigned long long* xa_empty = bars + 2 * kWgSlots + 2 + wg;
  const int w = T >> 5, g = (T & 31) >> 2, t = T & 3;
  const bool lead = T == 0;
  const int n_tiles = A / kTile;
  const int n_stages = ext_wg_stages(DP, n_blocks);
  WgClock clk;
  clk.start();
  float acc[L::R];
  unsigned spk[L::R / 2];  // s = rnd(rnd(W_s xa) + b_s), packed bf16 pairs
  int c = 0, xk = 0;
  for (int t0 = blockIdx.x; t0 < n_tiles; t0 += 2 * gridDim.x) {
    const int tile = t0 + wg * gridDim.x;
    if (tile >= n_tiles) {  // no tile here: pass the round's stages on
      for (int i = 0; i < n_stages; ++i, ++c) {
        wg_wait_bar(full + c % kWgSlots, (c / kWgSlots) & 1);
        wg_arrive_if(empty + c % kWgSlots, lead);
      }
      continue;
    }
    const unsigned col0 = (unsigned)tile * kTile;
    wg_wait_bar(xa_full, xk & 1);
    ++xk;
    fence_async_smem();
    clk.lap(0);

    // s = rnd(rnd(W_s xa) + b_s), kept packed
    wg_product<DP, 1>(acc, 2 * L::PB, MNMajor{xs}, ring, full, empty, c, lead, clk);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = 8 * j + 2 * t, i = 4 * j + 2 * h;
        spk[2 * j + h] = bits(bias_add(acc[i], acc[i + 1], bias + DP + f));
      }
    clk.lap(3);
    // h = act(rnd(rnd(W_in xa) + b_in))
    wg_product<DP, 1>(acc, 2 * L::PB, MNMajor{xs}, ring, full, empty, c, lead, clk);
    wg_arrive_if(xa_empty, lead);  // the producer may load the next tile's xa
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = 8 * j + 2 * t, i = 4 * j + 2 * h;
        st_u32(hs + kmajor_off<DP>(w, g, t, j, h),
               bits(act2<ACT>(bias_add(acc[i], acc[i + 1], bias + f))));
      }
    fence_async_smem();
    named_bar(1 + wg);
    clk.lap(3);

    for (int b = 0; b < n_blocks; ++b) {
      const bf16* b1 = bias + (2 + 2 * b) * DP;
      const bf16* b2 = b1 + DP;
      const unsigned mix = seed + (unsigned)b * 0x9E3779B9u;
      // v = drop(act(rnd(rnd(W1 h) + b1))): kept, rnd(rnd(a) * scale)
      wg_product<DP, 0>(acc, L::PB, KMajor<DP>{hs}, ring, full, empty, c, lead, clk);
      auto v_epilogue = [&](auto drop) {
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int f = 8 * j + 2 * t, i = 4 * j + 2 * h;
            __nv_bfloat162 a = act2<ACT>(bias_add(acc[i], acc[i + 1], b1 + f));
            if constexpr (decltype(drop)::value) {
              const unsigned atom = col0 + 16 * w + g + 8 * h;
              a = __hmul2(a, scale2);
              if (!drop_keep(f, atom, mix, thresh)) a.x = zero;
              if (!drop_keep(f + 1, atom, mix, thresh)) a.y = zero;
            }
            st_u32(vs + kmajor_off<DP>(w, g, t, j, h), bits(a));
          }
      };
      if (dropout)
        v_epilogue(std::true_type());
      else
        v_epilogue(std::false_type());
      fence_async_smem();
      named_bar(1 + wg);
      clk.lap(3);
      // h = rnd(rnd(rnd(W2 v) + b2) + h), on the last block out = rnd(h + s)
      wg_product<DP, 0>(acc, L::PB, KMajor<DP>{vs}, ring, full, empty, c, lead, clk);
      const bool last = b + 1 == n_blocks;
      if (last) named_bar(1 + wg);  // every warp's W2 product is done with v
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 8 * j + 2 * t, i = 4 * j + 2 * h;
          unsigned char* hp = hs + kmajor_off<DP>(w, g, t, j, h);
          const __nv_bfloat162 hn = __hadd2(bias_add(acc[i], acc[i + 1], b2 + f), pair(ld_u32(hp)));
          if (!last) {
            st_u32(hp, bits(hn));
          } else {
            // out^T into v as a staging tile: row f of 128 bytes, its 16-byte
            // chunks (8 atoms) swizzled by f % 8
            const __nv_bfloat162 o = __hadd2(hn, pair(spk[2 * j + h]));
            const int atom = 16 * w + g + 8 * h;
            const int fo = f * 128 + (atom & 7) * 2;
            *reinterpret_cast<bf16*>(vs + fo + (((atom >> 3) ^ (f & 7)) << 4)) = o.x;
            *reinterpret_cast<bf16*>(vs + fo + 128 + (((atom >> 3) ^ ((f + 1) & 7)) << 4)) = o.y;
          }
        }
      if (!last) fence_async_smem();
      named_bar(1 + wg);
      clk.lap(3);
    }
    // the real rows of out (D, A), 16-byte stores
    for (int e = T; e < D * (kTile / 8); e += 128) {
      const int f = e >> 3, ch = e & 7;
      *reinterpret_cast<int4*>(out + (size_t)f * A + col0 + ch * 8) =
          *reinterpret_cast<const int4*>(vs + f * 128 + ((ch ^ (f & 7)) << 4));
    }
    clk.lap(4);
    clk.tile();
  }
  if (lead) clk.write(8 * wg);
}

// The bf16 layer forward, warp-specialised on wgmma: persistent blocks of
// three warpgroups walk over rounds of two 64-atom tiles (block b's round r:
// consumer w's tile b + (2r + w) G, G blocks), so a last round of fewer
// tiles than 2G falls to as many blocks with one tile each.  Warpgroup 2
// produces: its first warp streams the layer's weights (ws,
// ops/bin_mp.py::ext_wg_stream_index) stage by stage by cp.async.bulk into
// a ring of kWgSlots slots, each with a full and an empty mbarrier; its
// second loads each consumer's xa tiles by cp.async (MN-major, the padded
// rows zero-filled) onto that consumer's xa barrier as its buffer frees.
// Warpgroups 0 and 1 are the consumers, each on its own tile, both reading
// every stage (a slot is free once both have given it back).
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
ext_fwd_wg_kernel(const bf16* __restrict__ xa, bf16* __restrict__ out,
                  const bf16* __restrict__ ws, int D, int A, int n_blocks, int act, int dropout,
                  unsigned seed, unsigned thresh, float scale) {
  using L = ExtWg<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* xs = smem + kWgHead;       // two xa tiles
  unsigned char* hs = xs + 2 * L::XA;       // two h tiles
  unsigned char* vs = hs + 2 * L::HV;       // two v tiles
  unsigned char* ring = vs + 2 * L::HV;     // kWgSlots weight stages
  bf16* bias = reinterpret_cast<bf16*>(ring + kWgSlots * L::STAGE);
  const int n_stages = ext_wg_stages(DP, n_blocks);
  const int nbias = (2 + 2 * n_blocks) * DP;  // b_in, b_s, b1_0, b2_0, ...
  for (int e = threadIdx.x; e < nbias; e += kWgThreads)
    bias[e] = ws[(size_t)n_stages * kWgKc * DP + e];
  if (threadIdx.x < kWgSlots) {
    mbar_init(bars + threadIdx.x, 1);                 // full: the producer's expect
    mbar_init(bars + kWgSlots + threadIdx.x, 2);      // empty: both consumers
  }
  if (threadIdx.x < 2) {
    mbar_init(bars + 2 * kWgSlots + threadIdx.x, 32);     // xa full: the producer's lanes
    mbar_init(bars + 2 * kWgSlots + 2 + threadIdx.x, 1);  // xa empty: its consumer
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  if (__shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) == 2) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int pw = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
    const int lane = threadIdx.x & 31;
    const int n_tiles = A / kTile;
    WgClock clk;
    clk.start();
    if (pw == 0) {  // warp 8: the weight stages, each round's in turn
      unsigned long long* empty = bars + kWgSlots;
      int c = 0;
      for (int u = blockIdx.x; u < n_tiles; u += 2 * gridDim.x)
        for (int i = 0; i < n_stages; ++i, ++c)
          if (lane == 0) {
            const int slot = c % kWgSlots;
            clk.lap(2);
            mbar_wait(empty + slot, ((c / kWgSlots) & 1) ^ 1);
            clk.lap(0);
            bulk_copy(ring + slot * L::STAGE, ws + (size_t)i * kWgKc * DP, L::STAGE, bars + slot);
          }
    } else if (pw == 1) {  // warp 9: each consumer's xa tiles, as its buffer frees
      int xl[2] = {0, 0};
      for (int u = blockIdx.x; u < n_tiles; u += 2 * gridDim.x)
        for (int w = 0; w < 2; ++w) {
          const int tile = u + w * gridDim.x;
          if (tile >= n_tiles) continue;
          clk.lap(2);
          mbar_wait(bars + 2 * kWgSlots + 2 + w, (xl[w] & 1) ^ 1);
          clk.lap(1);
          ++xl[w];
          unsigned char* dst = xs + w * L::XA;
          const size_t col0 = (size_t)tile * kTile;
          for (int e = lane; e < 2 * DP * (kTile / 8); e += 32) {
            const int r = e >> 3, ch = e & 7, src = xa_row(r, D, DP);
            cp_async16(dst + (r >> 3) * 1024 + ch * 128 + (r & 7) * 16,
                       src >= 0 ? xa + (size_t)src * A + col0 + ch * 8 : xa, src >= 0 ? 16 : 0);
          }
          asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                           smem_u32(bars + 2 * kWgSlots + w))
                       : "memory");
        }
    }
    if (pw < 2 && lane == 0) {
      clk.lap(2);
      clk.write(16 + 8 * pw);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  unsigned char* x_w = xs + wg * L::XA;
  unsigned char* h_w = hs + wg * L::HV;
  unsigned char* v_w = vs + wg * L::HV;
  switch (act) {  // activation codes: utils/activation.py ACTIVATION_CODES
    case 0: ext_wg_consumer<DP, 0>(out, x_w, h_w, v_w, ring, bars, bias, D, A, n_blocks, dropout,
                                   seed, thresh, scale); break;
    case 1: ext_wg_consumer<DP, 1>(out, x_w, h_w, v_w, ring, bars, bias, D, A, n_blocks, dropout,
                                   seed, thresh, scale); break;
    case 2: ext_wg_consumer<DP, 2>(out, x_w, h_w, v_w, ring, bars, bias, D, A, n_blocks, dropout,
                                   seed, thresh, scale); break;
    case 3: ext_wg_consumer<DP, 3>(out, x_w, h_w, v_w, ring, bars, bias, D, A, n_blocks, dropout,
                                   seed, thresh, scale); break;
    default: ext_wg_consumer<DP, 4>(out, x_w, h_w, v_w, ring, bars, bias, D, A, n_blocks,
                                    dropout, seed, thresh, scale); break;
  }
}

template <int DP>
int launch_wg(const void* xa, void* out, const void* ws, int D, int A, int n_blocks, int act,
              int dropout, unsigned seed, unsigned thresh, float scale, cudaStream_t s) {
  static bool done[kMaxDevices];
  int err = configure(ext_fwd_wg_kernel<DP>, done);
  if (err) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const int units = (A / kTile + 1) / 2;
  ext_fwd_wg_kernel<DP><<<units < sms ? units : sms, kWgThreads,
                          ext_wg_smem_bytes(DP, n_blocks), s>>>(
      static_cast<const bf16*>(xa), static_cast<bf16*>(out), static_cast<const bf16*>(ws), D, A,
      n_blocks, act, dropout, seed, thresh, scale);
  return (int)cudaGetLastError();
}

bool ext_walk_fits(int Dp, int n_blocks) {
  return Dp % 16 == 0 && Dp <= kWalkMaxDp && n_blocks >= 1 &&
         walk_smem_bytes(Dp, n_blocks) <= (size_t)kSmemLimit;
}

bool ext_walk_configured[5][kMaxDevices];

template <int ACT>
int launch_walk(const void* xa, const void* g, void* dxa, void* wk, const void* wstream, int D,
                int Dp, int A, int n_blocks, int dropout, unsigned seed, unsigned thresh,
                float scale, cudaStream_t s) {
  const int err = configure(bwd_walk_kernel<ACT, true>, ext_walk_configured[ACT]);
  if (err) return err;
  bwd_walk_kernel<ACT, true><<<A / kTile, kWalkThreads, walk_smem_bytes(Dp, n_blocks), s>>>(
      static_cast<const bf16*>(xa), static_cast<bf16*>(wk), nullptr, nullptr,
      static_cast<const bf16*>(wstream), static_cast<const bf16*>(g), static_cast<bf16*>(dxa), D,
      Dp, A, kTile, n_blocks, dropout, 0, seed, thresh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of kernel 5's bf16 walk at (Dp, n_blocks), or -1 where the
// walk does not take the shape (the wrapper then launches mp_ext_bwd).
long long mp_ext_bwd_walk_smem_bytes(int Dp, int n_blocks) {
  return ext_walk_fits(Dp, n_blocks) ? (long long)walk_smem_bytes(Dp, n_blocks) : -1;
}

// Elements of the layer's weight stream and biases (ops/bin_mp.py::
// walk_weights lays them out).
long long mp_ext_bwd_walk_stream_elems(int Dp, int n_blocks) {
  return (long long)walk_stages(Dp, n_blocks) * Dp * kKc + (long long)(1 + 2 * n_blocks) * Dp;
}

// The bf16 layer backward on the walk: xa (2D, A) and g (D, A) bf16 in,
// dxa (2D, A) out, the contraction's slabs (3 + 4 n_blocks of (Dp, A)) in
// wk; wstream the layer's weight stream.  Returns cudaGetLastError().
int mp_ext_bwd_walk(const void* xa, const void* g, void* dxa, void* wk, const void* wstream, int D,
                    int Dp, int A, int n_blocks, int act, int dropout, unsigned seed,
                    unsigned thresh, float scale, void* stream) {
  if (!ext_walk_fits(Dp, n_blocks) || A % kTile || D > Dp) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {  // activation codes: utils/activation.py ACTIVATION_CODES
    case 0: return launch_walk<0>(xa, g, dxa, wk, wstream, D, Dp, A, n_blocks, dropout, seed,
                                  thresh, scale, s);
    case 1: return launch_walk<1>(xa, g, dxa, wk, wstream, D, Dp, A, n_blocks, dropout, seed,
                                  thresh, scale, s);
    case 2: return launch_walk<2>(xa, g, dxa, wk, wstream, D, Dp, A, n_blocks, dropout, seed,
                                  thresh, scale, s);
    case 3: return launch_walk<3>(xa, g, dxa, wk, wstream, D, Dp, A, n_blocks, dropout, seed,
                                  thresh, scale, s);
    case 4: return launch_walk<4>(xa, g, dxa, wk, wstream, D, Dp, A, n_blocks, dropout, seed,
                                  thresh, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared memory of the bf16 forward on wgmma at (Dp, n_blocks), or -1 where
// it does not take the shape (the wrapper then launches mp_ext_fwd).
long long mp_ext_fwd_wg_smem_bytes(int Dp, int n_blocks) {
  return ext_wg_fits(Dp, n_blocks) ? (long long)ext_wg_smem_bytes(Dp, n_blocks) : -1;
}

// Elements of its weight stream and biases (ops/bin_mp.py::ext_wg_weights).
long long mp_ext_fwd_wg_stream_elems(int Dp, int n_blocks) {
  return (long long)ext_wg_stages(Dp, n_blocks) * kWgKc * Dp + (long long)(2 + 2 * n_blocks) * Dp;
}

// The bf16 layer forward on wgmma (ext_fwd_wg_kernel): xa (2D, A) bf16 in,
// out (D, A), ws the layer's stream.  Returns cudaGetLastError().
int mp_ext_fwd_wg(const void* xa, void* out, const void* ws, int D, int Dp, int A, int n_blocks,
                  int act, int dropout, unsigned seed, unsigned thresh, float scale,
                  void* stream) {
  if (!ext_wg_fits(Dp, n_blocks) || A % kTile || D > Dp || D < 1 || act < 0 || act > 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dp) {
    case 32: return launch_wg<32>(xa, out, ws, D, A, n_blocks, act, dropout, seed, thresh, scale, s);
    case 64: return launch_wg<64>(xa, out, ws, D, A, n_blocks, act, dropout, seed, thresh, scale, s);
    case 96: return launch_wg<96>(xa, out, ws, D, A, n_blocks, act, dropout, seed, thresh, scale, s);
    case 128:
      return launch_wg<128>(xa, out, ws, D, A, n_blocks, act, dropout, seed, thresh, scale, s);
    default:
      return launch_wg<160>(xa, out, ws, D, A, n_blocks, act, dropout, seed, thresh, scale, s);
  }
}

long long mp_ext_fwd_smem_bytes(int bf16, int Dp, int n_blocks) {
  return bf16 ? (long long)ext_fwd_smem_bytes<__nv_bfloat16>(Dp, n_blocks)
              : (long long)ext_fwd_smem_bytes<float>(Dp, n_blocks);
}

// The layer forward (see the top of this file).  Returns cudaGetLastError().
int mp_ext_fwd(const void* xa, void* out, const void* w, int bf16, int D, int Dp, int A,
               int n_blocks, int act, int dropout, unsigned seed, unsigned thresh, float scale,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(xa, out, w, D, Dp, A, n_blocks, act, dropout, seed,
                                          thresh, scale, s)
              : launch_fwd<float>(xa, out, w, D, Dp, A, n_blocks, act, dropout, seed, thresh,
                                  scale, s);
}

// The layer backward on slabs (fp32, and bf16 shapes the walk does not
// take): dxa and the weight gradients' operand slabs in wk (see
// ext_bwd_kernel).  Returns cudaGetLastError().
int mp_ext_bwd(const void* xa, const void* g, void* dxa, void* wk, const void* w, const void* wT,
               int bf16, int D, int Dp, int A, int n_blocks, int act, int dropout, unsigned seed,
               unsigned thresh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(xa, g, dxa, wk, w, wT, D, Dp, A, n_blocks, act,
                                          dropout, seed, thresh, scale, s)
              : launch_bwd<float>(xa, g, dxa, wk, w, wT, D, Dp, A, n_blocks, act, dropout, seed,
                                  thresh, scale, s);
}

#ifdef MP_EXT_MARKS
// Points ext_fwd_kernel's phase marks at marks ((blocks, 40) uint64).
int mp_ext_marks(void* marks) {
  return (int)cudaMemcpyToSymbol(g_ext_marks, &marks, sizeof(marks));
}
#endif

const char* mp_ext_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
