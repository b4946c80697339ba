// Helpers of the pools' tile kernels, a cluster of 64-atom tiles a bin:
// the attention pool's forward and backward (csrc/attnpool.cu) and kernel
// 6's forward (csrc/bin_pool.cu).  Each tile looks its atoms' molecules up
// in its columns of the bin's pool matrix, and sums over the bin are the
// tiles' partials added in rank order through distributed shared memory.
#pragma once

#include "walk.cuh"

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// molof[c]: the molecule of the tile's atom c (the first slot of pm_t, the
// tile's columns of the bin's (mb, ab) matrix, that holds it; -1 for none):
// independent loads, no early exit
__device__ void tile_molecules(int* molof, const int8_t* __restrict__ pm_t, int mb, int ab) {
  for (int c = threadIdx.x; c < kTile; c += blockDim.x) {
    int m = -1;
#pragma unroll 16
    for (int mm = mb - 1; mm >= 0; --mm)
      if (pm_t[(size_t)mm * ab + c] != 0) m = mm;
    molof[c] = m;
  }
}

// The sum over the cluster's C blocks, in rank order, of the float at p (the
// same offset in each block's shared memory): every rank's value is loaded
// first, so the remote loads are in flight together.
__device__ __forceinline__ float rank_sum(cooperative_groups::cluster_group& cluster,
                                          const float* p, int C) {
  float part[kWalkMaxCluster];
#pragma unroll
  for (int r = 0; r < kWalkMaxCluster; ++r)
    part[r] = r < C ? *cluster.map_shared_rank(p, r) : 0.0f;
  float v = 0.0f;
#pragma unroll
  for (int r = 0; r < kWalkMaxCluster; ++r)
    if (r < C) v += part[r];
  return v;
}

}  // namespace
