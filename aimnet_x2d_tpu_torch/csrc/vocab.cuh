// The embedding fold (kernel 1c-vocab): the lookup and the table cotangent
// shared by the stack's training kernels (csrc/mp_stack.cu,
// csrc/mp_stack_bwd.cu), the attention pool's (csrc/attnpool.cu) and the
// gathered products of the grouped weight-gradient contraction
// (csrc/wgrad_group.cuh).
//
// Replaces the one-hot products of aimnet_x2d_tpu/ops/embed.py::onehot_rows
// inside the TPU kernels (bin_mp.py:605-626, :736-742; bin_attnpool.py:
// 187-200, :301-306).  The TPU builds a (sum of V, lanes) one-hot with iota
// compares and multiplies it by the block-diagonal table on its matrix
// unit; on the card that product is a gather.  The table bd (E x SV, row
// stride SV, in the compute dtype) is block-diagonal: feature f owns rows
// [f Df, (f + 1) Df) and columns [off[f], off[f + 1]), so
//
//   emb[e, a] = bd[e, off[f] + code[f, a]]   (f = e / Df; 0 when the code
//                                             lies outside [0, V_f))
//
// which is the one-hot product exactly (one nonzero term).  The backward's
// cotangent d_bd[e, v] = sum over the atoms a whose code selects v of
// rnd(kb dt)[e, a] needs only the diagonal blocks (the tables receive
// nothing else): Df x V_f values per feature, kept compact, feature by
// feature, row-major, at acc + Df off[f].  One thread owns each row e and
// walks the tile's atoms in order, so the sums are the same from run to run
// (no atomics); the kernels write one such partial per bin, summed across
// bins in bin order by sum_partials (csrc/wgrad.cuh).
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxF = 8;  // features a table may have

struct Vocab {
  int F, Df, SV;
  int off[kMaxF + 1];  // off[f] .. off[f + 1]: feature f's columns
};

// Host side: the layout of E rows over the F vocabularies in sizes.
// Returns false when it cannot hold them.
bool make_vocab(const int* sizes, int F, int E, Vocab* v) {
  if (F < 1 || F > kMaxF || E % F) return false;
  v->F = F;
  v->Df = E / F;
  v->off[0] = 0;
  for (int f = 0; f < F; ++f) {
    if (sizes[f] < 0) return false;
    v->off[f + 1] = v->off[f] + sizes[f];
  }
  v->SV = v->off[F];
  return true;
}

// Compact diagonal-block floats of one partial (Df * SV).
__host__ __device__ inline long long vocab_acc_size(const Vocab& v) { return (long long)v.Df * v.SV; }

template <typename T>
__device__ __forceinline__ T vocab_emb(const int* __restrict__ codes, const T* __restrict__ bd,
                                       const Vocab& v, int e, size_t col, int A) {
  const int f = e / v.Df;
  const int k = codes[(size_t)f * A + col];
  const int V = v.off[f + 1] - v.off[f];
  return (k >= 0 && k < V) ? bd[(size_t)e * v.SV + v.off[f] + k] : from_f<T>(0.0f);
}

// tile[e * kLdT + c] = emb[e, cc + c] for the kTile atoms from column cc.
// The caller synchronises before the tile is read.
template <typename T>
__device__ void vocab_tile(T* tile, const int* __restrict__ codes, const T* __restrict__ bd,
                           const Vocab& v, int E, size_t cc, int A) {
  for (int i = threadIdx.x; i < E * kTile; i += blockDim.x) {
    const int e = i / kTile, c = i % kTile;
    tile[(size_t)e * kLdT + c] = vocab_emb(codes, bd, v, e, cc + c, A);
  }
}

// acc (compact diagonal blocks) += the tile's values tile[e * kLdT + c]
// (rnd(kb dt) in the compute dtype) at each atom's code, one thread per row,
// atoms in order.  The caller synchronises before and after.
template <typename T>
__device__ void vocab_accumulate(float* acc, const T* tile, const int* __restrict__ codes,
                                 const Vocab& v, int E, size_t cc, int A) {
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int f = e / v.Df, V = v.off[f + 1] - v.off[f];
    float* row = acc + (size_t)v.Df * v.off[f] + (size_t)(e - f * v.Df) * V;
    const int* cf = codes + (size_t)f * A + cc;
    for (int c = 0; c < kTile; ++c) {
      const int k = cf[c];
      if (k >= 0 && k < V) row[k] += to_f(tile[(size_t)e * kLdT + c]);
    }
  }
}

}  // namespace
