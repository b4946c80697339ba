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
// from L2 (tile-major in bf16, as the stack kernel).  The bf16 backward is
// the stack's walk (csrc/walk.cuh, bwd_walk_kernel in its EXT form: the
// chain in shared memory, the weights streamed through a cp.async ring in
// fragment order, mma.sync; no aggregation, no transpose, no cluster) while
// Dp <= 160 and its buffers fit one block (mp_ext_bwd_walk); fp32, and bf16
// shapes past that, take ext_bwd_kernel, which streams its operands through
// L2-resident global slabs (mp_ext_bwd).

#include "common.cuh"
#include "walk.cuh"

namespace {

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

  // the tile of xa, padded rows zero, in 16-byte vectors
  constexpr int V = 16 / sizeof(T);
  for (int e = threadIdx.x; e < K2 * kTile / V; e += kThreads) {
    const int r = e / (kTile / V), c = e % (kTile / V) * V;
    const int src = xa_row(r, D, Dp);
    int4 v = make_int4(0, 0, 0, 0);
    if (src >= 0) v = *reinterpret_cast<const int4*>(xa + (size_t)src * A + col0 + c);
    *reinterpret_cast<int4*>(xs + (size_t)r * kLdT + c) = v;
  }
  load_biases(bias, w, Dp, n_blocks);
  __syncthreads();

  const T* b_in = bias;
  const T* b_s = bias + Dp;
  gemm_tile(w_in, K2, tiled, Dp, K2, xs, xs, kLdT, K2, stage, [&](int r, int c, float v) {
    hbuf[r * kLdT + c] = from_f<T>(act_fn(act, rnd<T>(rnd<T>(v) + to_f(b_in[r]))));
  });
  __syncthreads();
  for (int i = 0; i < n_blocks; ++i) {
    const T* w1 = blocks + (size_t)i * block_sz;
    const T* w2 = w1 + mat1 + Dp;
    const T* b1 = bias + (2 + 2 * i) * Dp;
    const T* b2 = b1 + Dp;
    const unsigned mix = seed + (unsigned)i * 0x9E3779B9u;
    gemm_tile(w1, Dp, tiled, Dp, Dp, hbuf, hbuf, kLdT, Dp, stage, [&](int r, int c, float v) {
      float a = act_fn(act, rnd<T>(rnd<T>(v) + to_f(b1[r])));
      if (dropout) a = drop_keep(r, (unsigned)(col0 + c), mix, thresh) ? rnd<T>(a) * scale : 0.0f;
      vbuf[r * kLdT + c] = from_f<T>(a);
    });
    __syncthreads();
    gemm_tile(w2, Dp, tiled, Dp, Dp, vbuf, vbuf, kLdT, Dp, stage, [&](int r, int c, float v) {
      const float y = rnd<T>(rnd<T>(v) + to_f(b2[r]));
      hbuf[r * kLdT + c] = from_f<T>(y + to_f(hbuf[r * kLdT + c]));
    });
    __syncthreads();
  }
  // skip projection; out = h + s, the real rows only
  gemm_tile(w_s, K2, tiled, Dp, K2, xs, xs, kLdT, K2, stage, [&](int r, int c, float v) {
    if (r < D) {
      const float s = rnd<T>(rnd<T>(v) + to_f(b_s[r]));
      out[(size_t)r * A + col0 + c] = from_f<T>(to_f(hbuf[r * kLdT + c]) + s);
    }
  });
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

const char* mp_ext_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
