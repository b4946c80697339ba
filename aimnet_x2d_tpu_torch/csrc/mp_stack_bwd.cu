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
// Work slabs (Dp, A) of wk, in order: xa (two: x rows, agg rows), h_i,
// v_i, dh_i (dh_{n-1} = g), du_i, dt -- what the contraction reads; then,
// for bwd_layer_kernel only, t, u_i and the agg-part cotangent dA.

#include "common.cuh"
#include "vocab.cuh"
#include "walk.cuh"
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

const char* mp_stack_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
