// Fused message-passing stack, forward, for the bin-packed layout.
//
// Replaces the TPU kernel aimnet_x2d_tpu/ops/bin_mp.py::_make_stack_op
// (:566; fwd_kernel :639, pallas_call of ``forward`` :814, residual=True,
// with its vocab_sizes and n_layers = 1 forms :927, :1278): serving form
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
//
// The bf16 forward on tiles (stack_fwd_tile_kernel) runs every bf16 form
// above -- serving, training, the projection fold, the embedding fold and
// kernel 1d (one layer) -- where the shape fits it; mp_stack_kernel stays
// for fp32 and the bf16 shapes it does not take (Dp > 160, ab > 512, E
// past its buffers), chosen by shape, never as a fallback.  What held the
// kernel above back on an H100 (its phase split, -DMP_STACK_MARKS, at the
// training shape): one 218 KB block per bin (192 bins on 132 SMs is 1.45
// waves), and the products, 72% of a block's time, with every 64-atom
// tile rereading the weights from L2 through the register file and a block
// barrier and a staging round-trip around every wmma product.  The tile
// kernel's design:
// - one 320-thread block per 64-atom tile, the ab / 64 tiles of a bin one
//   thread-block cluster (768 blocks at the training batch, not 192);
// - the tile's x, agg, h_i and v_i live in shared memory across all layers
//   (rows of kLdT); only the saved layer inputs (training; 16-byte
//   streaming stores) and the output reach device memory;
// - layer l's aggregation: after a cluster barrier each block forms its
//   own columns of agg from the whole bin's layer-l x, reading the other
//   tiles' x through distributed shared memory in rank order (the next
//   one prefetched into registers, copies landing in h and v, which are
//   free then) against 64 x 64 blocks of the adjacency on mma.sync; a
//   second cluster barrier keeps every block from overwriting its x before
//   the others have read it (both split into arrive and wait, the saved
//   input's stores and the products between them);
// - every product on mma.sync m16n8k16 (csrc/walk.cuh's warp tiles,
//   smem_product, epilogue): bias, activation, the dropout keep (bit-equal
//   to the JAX mask) and every cast on the accumulator registers;
// - the weights as one stream in the forward's use order (the fold's
//   kb^T, then per layer W_in, W1_i, W2_i, W_s in the walk's fragment
//   order and 32-column stages, then the biases; ops/bin_mp.py
//   fwd_stream_index) through a ring of Hopper bulk async copies
//   (cp.async.bulk, completion on an mbarrier per slot) with a slot more
//   than the longest product has stages: at the block barrier after each
//   product's epilogue one thread starts the copies of the stages the freed
//   slots can take, so a product's weights are all on their way when it starts and
//   no warp waits on another between its stages; the ring runs on across
//   products and layers, so the next layer's weights load during the
//   aggregation;
// - under the fold, a prologue forms x0 = act(rnd(kb^T emb) + bb) per tile
//   with one product of K = E, emb's tile loaded by cp.async or, under the
//   embedding fold, looked up from the code rows (csrc/vocab.cuh) into the
//   same buffer: the same values, so x0 is the emb form's bit for bit.
// No atomics in the sums: reruns are bit-equal, and the training form
// without dropout is the serving form bit for bit (and, as measured, the
// kernel above's too).  What bounds the tiles now (PERF.md): not the
// weights -- a warp waits on landed stages ~4% of its time, and neither a
// deeper ring nor multicasting each stage to the cluster (one L2 read a
// bin) ran faster -- but the epilogues' activation and dropout arithmetic,
// while the tensor cores idle, and the latency of each stage's loads and
// mma.sync chain in 10 warps.  wgmma is not used, for csrc/walk.cuh's
// reason (Dp 160 is 2.5 of its 64-row tiles).
//
// Built with -DMP_STACK_MARKS, both kernels sum, per block, the time spent
// in each phase (prologue, saved inputs and biases, the cluster barrier,
// aggregation, the products W_in .. W_s, the residual, the output store)
// and write it as cumulative %globaltimer marks, and the tile kernel its
// ring's waits (mp_stack_marks; chip_smoke.py's [train-kernel] phase reads
// them).

#include "common.cuh"
#include "ring.cuh"
#include "vocab.cuh"
#include "walk.cuh"

namespace {

#ifdef MP_STACK_MARKS
constexpr int kPhases = 7;       // prologue, saved inputs, cluster barrier, aggregation, products,
                                 // residual, output
constexpr int kStackMarks = 11;  // marks a block may record; 8-10: the tile ring's
__device__ unsigned long long* g_marks;  // (blocks, kStackMarks), set by mp_stack_marks
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Per-phase sums of one block (thread 0's), after a block barrier.
struct PhaseClock {
  unsigned long long t0, last, acc[kPhases];
  __device__ void start() {
    __syncthreads();
    if (threadIdx.x == 0) {
      t0 = last = globaltimer();
      for (int p = 0; p < kPhases; ++p) acc[p] = 0;
    }
  }
  __device__ void end(int p) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned long long t = globaltimer();
      acc[p] += t - last;
      last = t;
    }
  }
  // the sums as cumulative marks: mark p + 1 - mark p is phase p's time
  __device__ void write() {
    if (threadIdx.x == 0) {
      unsigned long long* m = g_marks + (size_t)blockIdx.x * kStackMarks;
      m[0] = t0;
      for (int p = 0; p < kPhases; ++p) m[p + 1] = m[p] + acc[p];
    }
  }
};
#else
struct PhaseClock {
  __device__ void start() {}
  __device__ void end(int) {}
  __device__ void write() {}
};
#endif
enum { kPrologue, kSaved, kBarrier, kAggregation, kProducts, kResidual, kOutput };

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
  PhaseClock phases;
  phases.start();
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
  phases.end(kPrologue);

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
    phases.end(kSaved);
    phases.end(kBarrier);  // (no cluster)

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
    phases.end(kAggregation);

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
      phases.end(kProducts);
      for (int e = threadIdx.x; e < Dp * kTile; e += kThreads) {
        const int r = e / kTile, c = e % kTile;
        T* px = xb + (size_t)r * ld + c0 + c;
        *px = from_f<T>(to_f(vbuf[r * kLdT + c]) + to_f(*px));
      }
      __syncthreads();
      phases.end(kResidual);
    }
  }

  if (!global_mode) {
    for (int e = threadIdx.x; e < D * ab / V; e += kThreads) {
      const int r = e / (ab / V), c = e % (ab / V) * V;
      *reinterpret_cast<int4*>(out + (size_t)r * A + col0 + c) =
          *reinterpret_cast<const int4*>(xb + (size_t)r * ld + c);
    }
  }
  phases.end(kOutput);
  phases.write();
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

// ---- the bf16 forward on tiles (stack_fwd_tile_kernel) ---------------------

// Tile-buffer rows: x, agg, h, v (Dp each) and two 64-row adjacency blocks.
// The fold's input tile (E rows) borrows the rows from agg on.
__host__ __device__ __forceinline__ int fwd_tile_rows(int Dp) { return 4 * Dp + 2 * kTile; }

// Ring stages of the whole stream: the fold's kb^T (K = E), then per layer
// W_in (K = 2Dp), W1_i and W2_i (K = Dp) of each block, W_s (K = 2Dp).
__host__ __device__ __forceinline__ int fwd_stages(int Dp, int n_blocks, int n_layers, int E) {
  return ((E > 0 ? kpad(E) : 0) +
          n_layers * (2 * kpad(2 * Dp) + 2 * n_blocks * kpad(Dp))) / kKc;
}

// The stream's elements: the stages, then the biases (bb under the fold,
// then per layer b_in, b1_0, b2_0, ..., b_s).
size_t fwd_stream_elems(int Dp, int n_blocks, int n_layers, int E) {
  return (size_t)fwd_stages(Dp, n_blocks, n_layers, E) * Dp * kKc +
         (size_t)(E > 0 ? Dp : 0) + (size_t)n_layers * (2 + 2 * n_blocks) * Dp;
}

// Shared memory: the ring's mbarriers (and three counters of the marked
// build), the tile buffers, the ring, the layer's biases.
constexpr size_t kHeadBytes = 128;
static_assert(kFwdRing * 8 + 3 * 8 <= kHeadBytes, "ring barriers");

size_t fwd_tile_smem_bytes(int Dp, int n_blocks) {
  return kHeadBytes + ((size_t)fwd_tile_rows(Dp) * kLdT + (size_t)kFwdRing * Dp * kKc +
                       (size_t)(2 + 2 * n_blocks) * Dp) * sizeof(bf16);
}

bool fwd_tiles_fit(int Dp, int ab, int n_blocks, int E) {
  return Dp % 16 == 0 && Dp > 0 && Dp <= kWalkMaxDp && ab % kTile == 0 && ab / kTile >= 1 &&
         ab / kTile <= kWalkMaxCluster && n_blocks >= 0 && E % 16 == 0 && E >= 0 &&
         E <= 3 * Dp + 2 * kTile && kpad(E) / kKc <= kFwdRing &&
         kpad(2 * Dp) / kKc <= kFwdRing && fwd_tile_smem_bytes(Dp, n_blocks) <= (size_t)kSmemLimit;
}

// acc = W (Dp x K, from the ring) * B (K x 64), as csrc/walk.cuh's
// ring_product (B's rows k < ksplit from B0, the rest from B1).
// (Loading the next stage's B fragments ahead of the wait needs more than
// the 168 registers a 320-thread block may have, and spills: slower on an
// H100.)
__device__ void fwd_product(FwdRing& ring, int Dp, int K, const bf16* B0, const bf16* B1,
                            int ksplit, float (&acc)[2][4][4]) {
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

// f(row, col, v0, v1, b) for each pair of neighbouring columns of the
// warp's accumulators (csrc/walk.cuh epilogue), with b the row's bias.
template <class F>
__device__ __forceinline__ void bias_epilogue(const float (&acc)[2][4][4], int Dp, const bf16* bias,
                                              F f) {
  const WarpTile w(Dp);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (w.mt0 + i < w.MT)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * (w.mt0 + i) + g + 8 * h;
        const float b = to_f(bias[r]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          f(r, w.n0 + 8 * j + 2 * t, acc[i][j][2 * h], acc[i][j][2 * h + 1], b);
      }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");  // release
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // acquire
}

// acc = agg's columns of this tile: the sum over the cluster's tiles s, in
// rank order, of x_s (Dp x 64, block s's X, another block's read through
// distributed shared memory into copy[s & 1]) times the 64 x 64 block of
// the bin's adjacency adj_b with this tile's atoms as rows and s's as
// columns (into adjb[s & 1]) -- the next tile's operands are loaded into
// registers while the current product runs.  Every block's X holds layer
// l's input.
__device__ void cluster_aggregate(cooperative_groups::cluster_group& cluster, const bf16* X,
                                  bf16* const (&copy)[2], bf16* const (&adjb)[2],
                                  const int8_t* adj_b, int ab, int Dp, float (&acc)[2][4][4]) {
  const int C = ab / kTile, rank = (int)cluster.block_rank();
  constexpr int kPer = (kWalkMaxDp * (kTile / 8) + kWalkThreads - 1) / kWalkThreads;
  int4 rem_v[kPer], adj_v;
  auto fetch = [&](int s) {
    if (s != rank) {
      const bf16* rem = cluster.map_shared_rank(X, s);
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int e = threadIdx.x + q * kWalkThreads;
        if (e < Dp * (kTile / 8))
          rem_v[q] =
              *reinterpret_cast<const int4*>(rem + (e / (kTile / 8)) * kLdT + e % (kTile / 8) * 8);
      }
    }
    adj_v = adj_load(adj_b, ab, rank * kTile, s * kTile);
  };
  auto put = [&](int s) {
    if (s != rank) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int e = threadIdx.x + q * kWalkThreads;
        if (e < Dp * (kTile / 8))
          *reinterpret_cast<int4*>(copy[s & 1] + (e / (kTile / 8)) * kLdT + e % (kTile / 8) * 8) =
              rem_v[q];
      }
    }
    adj_store(adjb[s & 1], adj_v);
  };
  zero(acc);
  fetch(0);
  put(0);
  for (int s = 0; s < C; ++s) {
    __syncthreads();  // s's operands are in place; s - 1's buffers are free
    if (s + 1 < C) fetch(s + 1);
    smem_product(s == rank ? X : copy[s & 1], adjb[s & 1], true, Dp, acc);
    if (s + 1 < C) put(s + 1);
  }
}

// The stack forward, bf16, one 64-atom tile a block, the ab / 64 tiles of
// a bin one cluster (grid nb * ab / 64), for activation code ACT (a
// template argument, as in the walk).  ws is the weight stream
// (fwd_stream_elems).  x_in (D, A) is the input, or with E > 0 the fold's
// emb (E, A) -- or, when codes is not null (the embedding fold), the code
// rows (F, A) with the table bd.  xs receives the inputs of layers
// xs_first.. (D rows each) unless it is null; out (D, A) the output.
template <int ACT>
__global__ void __launch_bounds__(kWalkThreads, 1)
stack_fwd_tile_kernel(const bf16* __restrict__ x_in, const int* __restrict__ codes,
                      const bf16* __restrict__ bd, Vocab voc, bf16* __restrict__ out,
                      bf16* __restrict__ xs, const int8_t* __restrict__ adj,
                      const bf16* __restrict__ ws, int D, int Dp, int E, int A, int ab,
                      int n_layers, int n_blocks, int xs_first, int dropout, unsigned seed,
                      unsigned thresh, float scale) {
  namespace cg = cooperative_groups;
  constexpr int act = ACT;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = ab / kTile, rank = (int)cluster.block_rank();
  const int bin = blockIdx.x / C;
  const size_t col0 = (size_t)bin * ab, cc = col0 + (size_t)rank * kTile;

  extern __shared__ __align__(128) unsigned char smem[];
  PhaseClock phases;
  phases.start();
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  bf16* X = reinterpret_cast<bf16*>(smem + kHeadBytes);
  bf16* AG = X + (size_t)Dp * kLdT;
  bf16* H = AG + (size_t)Dp * kLdT;
  bf16* V = H + (size_t)Dp * kLdT;
  bf16* ADJ = V + (size_t)Dp * kLdT;  // two 64-row adjacency blocks
  bf16* ring_buf = X + (size_t)fwd_tile_rows(Dp) * kLdT;
  bf16* bias = ring_buf + (size_t)kFwdRing * Dp * kKc;

  const int n_stages = fwd_stages(Dp, n_blocks, n_layers, E);
  FwdRing ring{ws, ring_buf, full, Dp * kKc, n_stages, 0, 0};
#ifdef MP_STACK_MARKS
  ring.waits = full + kFwdRing;
  if (threadIdx.x < 3) ring.waits[threadIdx.x] = threadIdx.x == 2 ? clock64() : 0;
#endif
  if (threadIdx.x < kFwdRing) mbar_init(full + threadIdx.x, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  ring.refill();
  const bf16* wbias = ws + (size_t)n_stages * Dp * kKc;
  const int nbias = (2 + 2 * n_blocks) * Dp;  // b_in, b1_0, b2_0, ..., b_s

  float acc[2][4][4];
  if (E > 0) {
    // x0 = act(rnd(kb^T emb) + bb): emb's tile (E rows) from agg's rows on
    bf16* T = AG;
    if (codes) {
      vocab_tile(T, codes, bd, voc, E, cc, A);
    } else {
      for (int e = threadIdx.x; e < E * (kTile / 8); e += kWalkThreads) {
        const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
        cp_async16(T + r * kLdT + c, x_in + (size_t)r * A + cc + c);
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    for (int e = threadIdx.x; e < Dp; e += kWalkThreads) bias[e] = wbias[e];
    wbias += Dp;
    __syncthreads();
    fwd_product(ring, Dp, E, T, T, E, acc);
    bias_epilogue(acc, Dp, bias, [&](int r, int c, float v0, float v1, float b) {
      st2(X, r, c, act_fn(act, rnd<bf16>(rnd<bf16>(v0) + b)),
          act_fn(act, rnd<bf16>(rnd<bf16>(v1) + b)));
    });
  } else {
    for (int e = threadIdx.x; e < Dp * (kTile / 8); e += kWalkThreads) {  // rows >= D: zeros
      const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
      const bool in = r < D;
      cp_async16(X + r * kLdT + c, in ? x_in + (size_t)r * A + cc + c : x_in, in ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  ring.refill();
  phases.end(kPrologue);
  cluster_arrive();  // this block's x holds layer 0's input

  const int8_t* adj_b = adj + (size_t)bin * ab * ab;
  bf16* const copies[2] = {H, V};
  bf16* const adjb[2] = {ADJ, ADJ + (size_t)kTile * kLdT};
  for (int l = 0; l < n_layers; ++l) {
    if (xs && l >= xs_first) {  // this layer's input, for the backward
      bf16* dst = xs + (size_t)(l - xs_first) * D * A;
      for (int e = threadIdx.x; e < D * (kTile / 8); e += kWalkThreads) {
        const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
        __stcs(reinterpret_cast<int4*>(dst + (size_t)r * A + cc + c),
               *reinterpret_cast<const int4*>(X + r * kLdT + c));
      }
    }
    for (int e = threadIdx.x; e < nbias; e += kWalkThreads) bias[e] = wbias[(size_t)l * nbias + e];
    phases.end(kSaved);

    // --- agg over the bin, once every block's x holds this layer's input
    cluster_wait();
    phases.end(kBarrier);
    cluster_aggregate(cluster, X, copies, adjb, adj_b, ab, Dp, acc);
    epilogue(acc, Dp, [&](int r, int c, float v0, float v1) { st2(AG, r, c, v0, v1); });
    cluster_arrive();  // this block's reads of the other tiles' x are done
    __syncthreads();
    phases.end(kAggregation);

    // --- h = act(rnd(W_in [x ; agg]) + b_in)
    fwd_product(ring, Dp, 2 * Dp, X, AG, Dp, acc);
    bias_epilogue(acc, Dp, bias, [&](int r, int c, float v0, float v1, float b) {
      st2(H, r, c, act_fn(act, rnd<bf16>(rnd<bf16>(v0) + b)),
          act_fn(act, rnd<bf16>(rnd<bf16>(v1) + b)));
    });
    __syncthreads();
    ring.refill();
    for (int i = 0; i < n_blocks; ++i) {
      const bf16* b1 = bias + (size_t)(1 + 2 * i) * Dp;
      const unsigned mix = seed + (unsigned)(l * n_blocks + i) * 0x9E3779B9u;
      fwd_product(ring, Dp, Dp, H, H, Dp, acc);  // v = drop(act(rnd(W1 h) + b1))
      bias_epilogue(acc, Dp, b1, [&](int r, int c, float v0, float v1, float b) {
        float a[2] = {act_fn(act, rnd<bf16>(rnd<bf16>(v0) + b)),
                      act_fn(act, rnd<bf16>(rnd<bf16>(v1) + b))};
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (dropout)
            a[q] = drop_keep(r, (unsigned)(cc + c + q), mix, thresh) ? rnd<bf16>(a[q]) * scale
                                                                     : 0.0f;
        st2(V, r, c, a[0], a[1]);
      });
      __syncthreads();
      ring.refill();
      fwd_product(ring, Dp, Dp, V, V, Dp, acc);  // h = (rnd(W2 v) + b2) + h
      bias_epilogue(acc, Dp, b1 + Dp, [&](int r, int c, float v0, float v1, float b) {
        const float2 h = ld2(H, r, c);
        st2(H, r, c, rnd<bf16>(rnd<bf16>(v0) + b) + h.x, rnd<bf16>(rnd<bf16>(v1) + b) + h.y);
      });
      __syncthreads();
      ring.refill();
    }
    // --- s = rnd(W_s [x ; agg]) + b_s; h + s over h (each thread its own)
    fwd_product(ring, Dp, 2 * Dp, X, AG, Dp, acc);
    bias_epilogue(acc, Dp, bias + (size_t)(1 + 2 * n_blocks) * Dp,
                  [&](int r, int c, float v0, float v1, float b) {
                    const float2 h = ld2(H, r, c);
                    st2(H, r, c, h.x + rnd<bf16>(rnd<bf16>(v0) + b),
                        h.y + rnd<bf16>(rnd<bf16>(v1) + b));
                  });
    __syncthreads();  // every warp is done reading x
    ring.refill();
    phases.end(kProducts);

    // --- x = (h + s) + x, once the other tiles have read this one's x
    cluster_wait();
    for (int e = threadIdx.x; e < Dp * (kTile / 2); e += kWalkThreads) {
      const int r = e / (kTile / 2), c = e % (kTile / 2) * 2;
      const float2 hs = ld2(H, r, c), x = ld2(X, r, c);
      st2(X, r, c, hs.x + x.x, hs.y + x.y);
    }
    __syncthreads();
    if (l + 1 < n_layers) cluster_arrive();  // this block's x holds layer l + 1's input
    phases.end(kResidual);
  }

  for (int e = threadIdx.x; e < D * (kTile / 8); e += kWalkThreads) {
    const int r = e / (kTile / 8), c = e % (kTile / 8) * 8;
    *reinterpret_cast<int4*>(out + (size_t)r * A + cc + c) =
        *reinterpret_cast<const int4*>(X + r * kLdT + c);
  }
  phases.end(kOutput);
  phases.write();
#ifdef MP_STACK_MARKS
  if (threadIdx.x == 0) {
    ring.waits[2] = clock64() - ring.waits[2];
    for (int q = 0; q < 3; ++q) g_marks[(size_t)blockIdx.x * kStackMarks + 8 + q] = ring.waits[q];
  }
#endif
}

template <int ACT>
int launch_tiles_act(cudaLaunchConfig_t* cfg, const bf16* x, const int* codes, const bf16* bd,
                     Vocab voc, bf16* out, bf16* xs, const int8_t* adj, const bf16* ws, int D,
                     int Dp, int E, int A, int ab, int n_layers, int n_blocks, int xs_first,
                     int dropout, unsigned seed, unsigned thresh, float scale) {
  static bool done[kMaxDevices];
  const int err = configure(stack_fwd_tile_kernel<ACT>, done);
  if (err) return err;
  const cudaError_t e = cudaLaunchKernelEx(cfg, stack_fwd_tile_kernel<ACT>, x, codes, bd, voc, out,
                                           xs, adj, ws, D, Dp, E, A, ab, n_layers, n_blocks,
                                           xs_first, dropout, seed, thresh, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch_tiles(const void* x, const void* codes, const void* bd, const int* sizes, int F,
                 void* out, void* xs, const void* adj, const void* ws, int D, int Dp, int E, int A,
                 int nb, int ab, int n_layers, int n_blocks, int act, int xs_first, int dropout,
                 unsigned seed, unsigned thresh, float scale, cudaStream_t st) {
  if (!fwd_tiles_fit(Dp, ab, n_blocks, E) || D < 1 || D > Dp || A != nb * ab || n_layers < 1 ||
      act < 0 || act > 4)
    return (int)cudaErrorInvalidValue;
  Vocab voc{};
  if (codes && (E == 0 || !make_vocab(sizes, F, E, &voc))) return (int)cudaErrorInvalidValue;
  const int C = ab / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * C);
  cfg.blockDim = dim3(kWalkThreads);
  cfg.dynamicSmemBytes = fwd_tile_smem_bytes(Dp, n_blocks);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bf16* xb = static_cast<const bf16*>(x);
  const int* cd = static_cast<const int*>(codes);
  const bf16* bdb = static_cast<const bf16*>(bd);
  bf16* o = static_cast<bf16*>(out);
  bf16* s = static_cast<bf16*>(xs);
  const int8_t* a = static_cast<const int8_t*>(adj);
  const bf16* w = static_cast<const bf16*>(ws);
  switch (act) {
    case 0: return launch_tiles_act<0>(&cfg, xb, cd, bdb, voc, o, s, a, w, D, Dp, E, A, ab,
                                       n_layers, n_blocks, xs_first, dropout, seed, thresh, scale);
    case 1: return launch_tiles_act<1>(&cfg, xb, cd, bdb, voc, o, s, a, w, D, Dp, E, A, ab,
                                       n_layers, n_blocks, xs_first, dropout, seed, thresh, scale);
    case 2: return launch_tiles_act<2>(&cfg, xb, cd, bdb, voc, o, s, a, w, D, Dp, E, A, ab,
                                       n_layers, n_blocks, xs_first, dropout, seed, thresh, scale);
    case 3: return launch_tiles_act<3>(&cfg, xb, cd, bdb, voc, o, s, a, w, D, Dp, E, A, ab,
                                       n_layers, n_blocks, xs_first, dropout, seed, thresh, scale);
    default: return launch_tiles_act<4>(&cfg, xb, cd, bdb, voc, o, s, a, w, D, Dp, E, A, ab,
                                        n_layers, n_blocks, xs_first, dropout, seed, thresh,
                                        scale);
  }
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

// Shared memory of the bf16 forward on tiles at these shapes, or -1 where
// it does not take them (the wrapper then launches mp_stack_kernel).
long long mp_stack_tiles_smem_bytes(int Dp, int ab, int n_blocks, int E) {
  return fwd_tiles_fit(Dp, ab, n_blocks, E) ? (long long)fwd_tile_smem_bytes(Dp, n_blocks) : -1;
}

// Elements of the forward's weight stream (ops/bin_mp.py fwd_weights).
long long mp_stack_tiles_stream_elems(int Dp, int n_blocks, int n_layers, int E) {
  return (long long)fwd_stream_elems(Dp, n_blocks, n_layers, E);
}

// The bf16 forward on tiles (stack_fwd_tile_kernel), every form: x (D, A),
// or with E > 0 the fold's emb (E, A), or with codes (F, A) int32 and the
// table bd the embedding fold (x unused); ws the weight stream; out (D, A);
// xs, unless null, receives the inputs of layers xs_first.. (D rows each);
// dropout with mask threshold and the scale rounded to bf16.  Returns
// cudaGetLastError() after the launch.
int mp_stack_tiles(const void* x, const void* codes, const void* bd, const int* sizes, int F,
                   void* out, void* xs, const void* adj, const void* ws, int D, int Dp, int E,
                   int A, int nb, int ab, int n_layers, int n_blocks, int act, int xs_first,
                   int dropout, unsigned seed, unsigned thresh, float scale, void* stream) {
  return launch_tiles(x, codes, bd, sizes, F, out, xs, adj, ws, D, Dp, E, A, nb, ab, n_layers,
                      n_blocks, act, xs_first, dropout, seed, thresh, scale,
                      static_cast<cudaStream_t>(stream));
}

#ifdef MP_STACK_MARKS
// Points both kernels' phase marks at marks ((blocks, 11) uint64).
int mp_stack_marks(void* marks) {
  return (int)cudaMemcpyToSymbol(g_marks, &marks, sizeof(marks));
}
#endif

const char* mp_stack_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
