// Fused message-passing stack, forward, for the bin-packed layout.
//
// Replaces the TPU kernel aimnet_x2d_tpu/ops/bin_mp.py::_make_stack_op
// (fwd_kernel, pallas_call of ``forward``, residual=True): serving form
// (mp_stack_fwd) and training form (mp_stack_fwd_train: in-block dropout,
// the proj=True x_other projection fold, each layer's input saved for the
// backward in csrc/mp_stack_bwd.cu).  For every 256-atom bin and every
// layer it computes, in the
// feature-major layout (features on rows, the bin's atoms on columns):
//
//     agg = x adj^T                      per bin, int8 multiplicities
//     t   = W_in [x; agg] + b_in ;  h = act(t)
//     s   = W_s  [x; agg] + b_s
//     n_blocks x:  h = (W2 act(W1 h + b1) + b2) + h
//     x   = (h + s) + x
//
// with the cast points of the JAX package: every product accumulates in
// fp32, is rounded to the compute dtype, and the bias add, the activation
// and every residual add round to the compute dtype again.  Weights arrive
// prepped by the wrapper (ops/bin_mp.py::prep_layer): [W0;W1]^T stacked as
// (Dp, 2Dp), biases as columns, cast to the compute dtype once, with D padded
// to Dp (a multiple of 16) by zero rows and columns.  Padded feature rows of
// x stay exactly zero through every layer, so they never reach the output.
//
// What bounds it on an H100: at the serving shape (D = 153, ab = 256,
// 3 layers, 2 blocks) a bin needs ~350 MFLOP against ~220 KB of traffic, so
// it is bound by tensor-core throughput, not by memory.  Only the
// aggregation mixes atoms, and only inside a bin, but layer l+1's
// aggregation needs all of layer l's output for the bin.
//
// Design: one thread block per bin loops over the layers, so a bin's
// activations never leave the SM between layers.  In bf16 the bin's x and
// agg (Dp x 264 each, 82.5 KB) live in shared memory; when they do not fit
// (fp32, or a wider model) they live in global scratch that stays in L2.
// The aggregation for the whole bin is computed first (its input is the
// unmodified x); the post-aggregation chain then runs on 64-atom column
// tiles, which only read and write their own columns of x, so x is updated
// in place.  bf16 products run on the tensor cores through wmma (16x16x16,
// fp32 accumulators); fp32 products run on the CUDA cores in full fp32.
// Each output fragment's epilogue (cast, bias, activation, residual) is
// applied by its warp from a 1 KB staging tile, with the layer's biases
// copied to shared memory once per layer.  The weights stay in global
// memory: all blocks read the same ~0.4 MB per layer, so they hit L2, but
// the SM keeps only ~30 KB of L1 beside the block's shared memory, so each
// 64-atom tile reads them from L2 again.  The bf16 weights therefore come
// tile-major (each 16 x 16 fragment 512 contiguous bytes, no partial
// sectors), and each warp keeps its next kAhead weight fragments in flight.
// The adjacency, x and the output move in 16-byte vectors.  Not yet done
// (later work): wgmma/TMA, weight tiles in shared memory, and more than
// one bin in flight per SM (one 218 KB block per SM, so 160 bins take two
// waves on 132 SMs).
//
// Training form.  Dropout follows the activation of each block's first
// product (v = rnd(act(u)); kept -> rnd(v * scale), else 0), with the mask
// drawn from the hash of (real feature row, global atom column, layer and
// block tag, seed), bit-equal to the JAX mask; padded rows have v = 0, so
// their mask bits never matter.  With the fold, a prologue computes
// x0 = act(rnd(kb^T emb) + bb) per 64-atom tile straight into the bin's x.
// Before each layer l runs, its input is copied to the saved-inputs array
// (its real D rows), which the backward reads instead of recomputing the
// chain.  The serving instantiation compiles none of this.
//
// Embedding fold (mp_stack_fwd_train_vocab, kernel 1c-vocab: the TPU op's
// vocab_sizes).  The fold's input is then the code rows (F, A) int32 and
// the block-diagonal table instead of emb: per 64-atom tile the prologue
// looks each atom's embedding up (csrc/vocab.cuh) into the adjacency
// scratch, which is free until the first aggregation, and the projection
// reads its B operand from there instead of from global emb -- the same
// values in the same order, so x0 is the emb form's bit for bit.  The
// (E, A) embedding array never exists; a tile costs E x 64 table reads
// from L1/L2 (the table is 72 KB in bf16).

#include "common.cuh"
#include "vocab.cuh"

namespace {

template <typename T>
size_t smem_bytes(int Dp, int ab, int n_blocks, int global_mode) {
  size_t b = (size_t)kWarps * 256 * sizeof(float);                      // epilogue staging
  if (!global_mode) b += 2 * (size_t)Dp * (ab + 8) * sizeof(T);           // x, agg
  const int rows = ab > 2 * Dp ? ab : 2 * Dp;
  b += (size_t)rows * kLdT * sizeof(T);  // adj^T chunk, or the h and v tiles
  b += (size_t)(2 + 2 * n_blocks) * Dp * sizeof(T);  // the layer's biases
  return b;
}

// One block per bin.  x_in (D, A) and out are feature-major with A = nb*ab
// columns.  global_mode: out is (Dp, A) and also holds the bin's x while
// the block works; agg_g is a (Dp, A) scratch.  Otherwise x and agg live
// in shared memory and out is (D, A).
// Training arguments (read only when kTrain): pw = [kb^T (Dp x E), bb (Dp)]
// of the fold (E > 0) with x_in then the embeddings (E, A); xs the saved
// inputs, slot l - xs_first for layer l >= xs_first; dropout with mask
// threshold and the scale rounded to the compute dtype.  codes (non-null:
// the embedding fold) holds the code rows (F, A) and bd the table, and
// x_in is unused.
template <typename T, bool kTrain>
__global__ void __launch_bounds__(kThreads)
mp_stack_kernel(const T* __restrict__ x_in, T* out, T* agg_g, const int8_t* __restrict__ adj,
                const T* __restrict__ w, int D, int Dp, int A, int ab, int n_layers,
                int n_blocks, int act, int global_mode, const T* __restrict__ pw, T* xs, int E,
                int xs_first, int dropout, unsigned seed, unsigned thresh, float scale,
                const int* __restrict__ codes, const T* __restrict__ bd, Vocab voc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bin = blockIdx.x;
  const size_t col0 = (size_t)bin * ab;
  unsigned char* p = smem;
  float* stage = reinterpret_cast<float*>(p);
  p += (size_t)kWarps * 256 * sizeof(float);
  T* xb;
  T* ag;
  int ld;
  if (global_mode) {
    xb = out + col0;
    ag = agg_g + col0;
    ld = A;
  } else {
    ld = ab + 8;
    xb = reinterpret_cast<T*>(p);
    p += (size_t)Dp * ld * sizeof(T);
    ag = reinterpret_cast<T*>(p);
    p += (size_t)Dp * ld * sizeof(T);
  }
  T* scratch = reinterpret_cast<T*>(p);  // adj^T chunk during aggregation
  T* hbuf = scratch;                     // then the h and v column tiles
  T* vbuf = scratch + (size_t)Dp * kLdT;
  const int rows = ab > 2 * Dp ? ab : 2 * Dp;
  // b_in, b_s, then b1, b2 of each block: read by every epilogue element
  T* bias = scratch + (size_t)rows * kLdT;

  // 16-byte loads and stores (ab, A and the row strides are multiples of 8)
  constexpr int V = 16 / sizeof(T);
  const bool tiled = sizeof(T) == 2;  // bf16 weight matrices are tile-major
  if (kTrain && E > 0) {
    // fold: x0 = act(rnd(kb^T emb) + bb), tile by tile, into the bin's x
    for (int e = threadIdx.x; e < Dp; e += kThreads) bias[e] = pw[(size_t)Dp * E + e];
    __syncthreads();
    for (int c0 = 0; c0 < ab; c0 += kTile) {
      if (codes) {  // the embedding fold: look the tile up into the scratch
        vocab_tile(scratch, codes, bd, voc, E, col0 + c0, A);
        __syncthreads();
      }
      const T* be = codes ? scratch : x_in + col0 + c0;
      const int ldb = codes ? kLdT : A;
      gemm_tile(pw, E, tiled, Dp, E, be, be, ldb, E, stage, [&](int r, int c, float v) {
        xb[(size_t)r * ld + c0 + c] = from_f<T>(act_fn(act, rnd<T>(rnd<T>(v) + to_f(bias[r]))));
      });
      if (codes) __syncthreads();  // the next tile overwrites the scratch
    }
    __syncthreads();
  } else {
    for (int e = threadIdx.x; e < Dp * ab / V; e += kThreads) {
      const int r = e / (ab / V), c = e % (ab / V) * V;
      int4 v = make_int4(0, 0, 0, 0);  // padded rows: +0.0
      if (r < D) v = *reinterpret_cast<const int4*>(x_in + (size_t)r * A + col0 + c);
      *reinterpret_cast<int4*>(xb + (size_t)r * ld + c) = v;
    }
    __syncthreads();
  }

  const int K2 = 2 * Dp;
  const size_t mat2 = (size_t)Dp * K2, mat1 = (size_t)Dp * Dp;
  const size_t block_sz = 2 * mat1 + 2 * (size_t)Dp;
  const size_t layer_sz = 2 * mat2 + 2 * (size_t)Dp + (size_t)n_blocks * block_sz;
  const int8_t* adj_b = adj + (size_t)bin * ab * ab;
  const T* b_in = bias;
  const T* b_s = bias + Dp;

  for (int l = 0; l < n_layers; ++l) {
    const T* w_in = w + (size_t)l * layer_sz;
    const T* w_s = w_in + mat2 + Dp;
    const T* blocks = w_s + mat2 + Dp;

    if (kTrain && l >= xs_first) {  // this layer's input, for the backward
      T* dst = xs + (size_t)(l - xs_first) * D * A + col0;
      for (int e = threadIdx.x; e < D * ab / V; e += kThreads) {
        const int r = e / (ab / V), c = e % (ab / V) * V;
        *reinterpret_cast<int4*>(dst + (size_t)r * A + c) =
            *reinterpret_cast<const int4*>(xb + (size_t)r * ld + c);
      }
    }

    // biases to shared memory (the aggregation's first barrier publishes them)
    for (int e = threadIdx.x; e < (2 + 2 * n_blocks) * Dp; e += kThreads) {
      const int seg = e / Dp, r = e % Dp;
      const T* blk = blocks + (size_t)(seg / 2 - 1) * block_sz;  // used for seg >= 2
      const T* src = seg == 0 ? w_in + mat2
                   : seg == 1 ? w_s + mat2
                   : blk + (seg % 2 ? 2 * mat1 + Dp : mat1);
      bias[e] = src[r];
    }

    // agg[:, i] = sum_j x[:, j] adj[i, j], one 64-atom chunk of i at a time
    for (int c0 = 0; c0 < ab; c0 += kTile) {
      for (int e = threadIdx.x; e < kTile * ab / 16; e += kThreads) {  // 16 per load
        const int il = e / (ab / 16), j0 = e % (ab / 16) * 16;
        const int4 v = *reinterpret_cast<const int4*>(adj_b + (size_t)(c0 + il) * ab + j0);
        const int8_t* m = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int t = 0; t < 16; ++t) scratch[(size_t)(j0 + t) * kLdT + il] = from_f<T>((float)m[t]);
      }
      __syncthreads();
      gemm_tile(xb, ld, false, Dp, ab, scratch, scratch, kLdT, ab, stage,
                [&](int r, int c, float v) { ag[(size_t)r * ld + c0 + c] = from_f<T>(v); });
      __syncthreads();
    }

    for (int c0 = 0; c0 < ab; c0 += kTile) {
      const T* bx = xb + c0;
      const T* ba = ag + c0;
      gemm_tile(w_in, K2, tiled, Dp, K2, bx, ba, ld, Dp, stage, [&](int r, int c, float v) {
        const float t = rnd<T>(rnd<T>(v) + to_f(b_in[r]));
        hbuf[r * kLdT + c] = from_f<T>(act_fn(act, t));
      });
      __syncthreads();
      for (int i = 0; i < n_blocks; ++i) {
        const T* w1 = blocks + (size_t)i * block_sz;
        const T* w2 = w1 + mat1 + Dp;
        const T* b1 = bias + (2 + 2 * i) * Dp;
        const T* b2 = b1 + Dp;
        const unsigned mix = seed + (unsigned)(l * n_blocks + i) * 0x9E3779B9u;
        gemm_tile(w1, Dp, tiled, Dp, Dp, hbuf, hbuf, kLdT, Dp, stage, [&](int r, int c, float v) {
          const float u = rnd<T>(rnd<T>(v) + to_f(b1[r]));
          float a = act_fn(act, u);
          if (kTrain && dropout)
            a = drop_keep(r, (unsigned)(col0 + c0 + c), mix, thresh) ? rnd<T>(a) * scale : 0.0f;
          vbuf[r * kLdT + c] = from_f<T>(a);
        });
        __syncthreads();
        gemm_tile(w2, Dp, tiled, Dp, Dp, vbuf, vbuf, kLdT, Dp, stage, [&](int r, int c, float v) {
          const float y = rnd<T>(rnd<T>(v) + to_f(b2[r]));
          hbuf[r * kLdT + c] = from_f<T>(y + to_f(hbuf[r * kLdT + c]));
        });
        __syncthreads();
      }
      // skip projection; (h + s) goes to v, since this product still reads x
      gemm_tile(w_s, K2, tiled, Dp, K2, bx, ba, ld, Dp, stage, [&](int r, int c, float v) {
        const float s = rnd<T>(rnd<T>(v) + to_f(b_s[r]));
        vbuf[r * kLdT + c] = from_f<T>(to_f(hbuf[r * kLdT + c]) + s);
      });
      __syncthreads();
      for (int e = threadIdx.x; e < Dp * kTile; e += kThreads) {
        const int r = e / kTile, c = e % kTile;
        T* px = xb + (size_t)r * ld + c0 + c;
        *px = from_f<T>(to_f(vbuf[r * kLdT + c]) + to_f(*px));
      }
      __syncthreads();
    }
  }

  if (!global_mode) {
    for (int e = threadIdx.x; e < D * ab / V; e += kThreads) {
      const int r = e / (ab / V), c = e % (ab / V) * V;
      *reinterpret_cast<int4*>(out + (size_t)r * A + col0 + c) =
          *reinterpret_cast<const int4*>(xb + (size_t)r * ld + c);
    }
  }
}

template <typename T, bool kTrain>
int launch(const void* x, void* out, void* agg, const void* adj, const void* w, int D, int Dp,
           int A, int nb, int ab, int n_layers, int n_blocks, int act, int global_mode,
           cudaStream_t stream, const void* pw = nullptr, void* xs = nullptr, int E = 0,
           int xs_first = 1, int dropout = 0, unsigned seed = 0, unsigned thresh = 0,
           float scale = 1.0f, const void* codes = nullptr, const void* bd = nullptr,
           Vocab voc = Vocab{}) {
  const size_t bytes = smem_bytes<T>(Dp, ab, n_blocks, global_mode);
  if (bytes > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  // the fold's tile borrows the scratch rows (max(ab, 2 Dp) of them)
  if (codes && (E > (ab > 2 * Dp ? ab : 2 * Dp) || E % 16 || E % voc.F))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mp_stack_kernel<T, kTrain>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  mp_stack_kernel<T, kTrain><<<nb, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(agg),
      static_cast<const int8_t*>(adj), static_cast<const T*>(w), D, Dp, A, ab, n_layers,
      n_blocks, act, global_mode, static_cast<const T*>(pw), static_cast<T*>(xs), E, xs_first,
      dropout, seed, thresh, scale, static_cast<const int*>(codes), static_cast<const T*>(bd), voc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; the wrapper takes global_mode = 1 when
// the shared-memory layout would exceed what a block may use.
long long mp_stack_smem_bytes(int bf16, int Dp, int ab, int n_blocks, int global_mode) {
  return bf16 ? (long long)smem_bytes<__nv_bfloat16>(Dp, ab, n_blocks, global_mode)
              : (long long)smem_bytes<float>(Dp, ab, n_blocks, global_mode);
}

long long mp_stack_smem_limit() { return kSmemLimit; }

// Returns cudaGetLastError() after the launch (0 on success).
int mp_stack_fwd(const void* x, void* out, void* agg, const void* adj, const void* w, int bf16,
                 int D, int Dp, int A, int nb, int ab, int n_layers, int n_blocks, int act,
                 int global_mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, false>(x, out, agg, adj, w, D, Dp, A, nb, ab, n_layers,
                                             n_blocks, act, global_mode, s)
              : launch<float, false>(x, out, agg, adj, w, D, Dp, A, nb, ab, n_layers, n_blocks,
                                     act, global_mode, s);
}

// Training form: pw = [kb^T, bb] of the fold (E > 0) or null; xs receives
// the inputs of layers xs_first.. (D rows each).  Returns cudaGetLastError().
int mp_stack_fwd_train(const void* x, void* out, void* agg, const void* adj, const void* w,
                       const void* pw, void* xs, int bf16, int D, int Dp, int E, int A, int nb,
                       int ab, int n_layers, int n_blocks, int act, int global_mode, int xs_first,
                       int dropout, unsigned seed, unsigned thresh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, true>(x, out, agg, adj, w, D, Dp, A, nb, ab, n_layers,
                                            n_blocks, act, global_mode, s, pw, xs, E, xs_first,
                                            dropout, seed, thresh, scale)
              : launch<float, true>(x, out, agg, adj, w, D, Dp, A, nb, ab, n_layers, n_blocks,
                                    act, global_mode, s, pw, xs, E, xs_first, dropout, seed,
                                    thresh, scale);
}

// Training form under the embedding fold: codes (F, A) int32 and the table
// bd (E, sum of sizes) in the compute dtype replace the embeddings; every
// layer's input is saved (xs_first = 0).  Returns cudaGetLastError().
int mp_stack_fwd_train_vocab(const void* codes, const void* bd, const int* sizes, int F,
                             void* out, void* agg, const void* adj, const void* w, const void* pw,
                             void* xs, int bf16, int D, int Dp, int E, int A, int nb, int ab,
                             int n_layers, int n_blocks, int act, int global_mode, int dropout,
                             unsigned seed, unsigned thresh, float scale, void* stream) {
  Vocab voc;
  if (!make_vocab(sizes, F, E, &voc)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, true>(nullptr, out, agg, adj, w, D, Dp, A, nb, ab, n_layers,
                                            n_blocks, act, global_mode, s, pw, xs, E, 0, dropout,
                                            seed, thresh, scale, codes, bd, voc)
              : launch<float, true>(nullptr, out, agg, adj, w, D, Dp, A, nb, ab, n_layers,
                                    n_blocks, act, global_mode, s, pw, xs, E, 0, dropout, seed,
                                    thresh, scale, codes, bd, voc);
}

const char* mp_stack_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
