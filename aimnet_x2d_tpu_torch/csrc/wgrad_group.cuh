// Grouped weight-gradient contraction of the stack's backward walk
// (csrc/mp_stack_bwd.cu): up to kGroupMax products in one launch,
//
//     part[c][off_p : off_p + M_p N_p + M_p] =
//         [ dY_p[:, chunk c] X_p[:, chunk c]^T (M_p x N_p),  rowsum(bsrc_p or dY_p) (M_p) ]
//
// dY_p (M_p, A) and X_p (N_p, A) in the compute dtype, feature-major with
// row stride A; bsrc_p, when given, an fp32 (M_p, A) array.  One layer's six
// products (dt xa^T, g xa^T, du_i h_i^T, dh_i v_i^T) go in one launch, the
// fold's dt0 emb^T in another; sum_partials (csrc/wgrad.cuh) then adds the
// chunks in a fixed order, so reruns are bit-equal (no atomics).
//
// What bounds it on an H100: one layer at the training shapes is 20 GFLOP
// and 170 MB of slab reads, 0.02 ms of tensor-core time against 0.05 ms of
// HBM time: bytes, with the products kept on the tensor cores.  Each block
// reads its dY rows and X rows over its chunk, so every operand is re-read
// once per output tile of the other: tall tiles, which hold all Dp = 160
// rows of dY, read about 40% less than 64 x 64 tiles at the walk's shapes.
// bf16 design: a 320-thread block per 160 x 64 output tile and chunk of
// atoms (the chunk count is chosen so that the grid fills the card about
// twice over, two blocks an SM); dY and X stream through a 3-stage
// shared-memory ring of 64-atom stages by 16-byte cp.async copies (rows
// past M or N zero-filled), each of 10 warps owns 32 x 32 outputs and
// multiplies with mma.sync m16n8k16 (fragments by ldmatrix), and the blocks
// of the first column tile add the bias row sums from the same stages (two
// threads a row, a fixed order).
// fp32 keeps the CUDA-core tile of wgrad.cuh (16 x 64 outputs a block).
#pragma once

#include "mma.cuh"
#include "wgrad.cuh"

namespace {

constexpr int kGroupMax = 16;      // products of one launch
constexpr int kWgbThreads = 320;   // 10 warps, 32 x 32 outputs each
constexpr int kWgbTileM = 160;     // output rows of a block (dY rows)
constexpr int kWgbTileN = 64;      // output columns of a block (X rows)
constexpr int kWgbK = 64;          // atoms per ring stage
constexpr int kWgbStages = 3;
constexpr int kWgbLd = kWgbK + 8;  // padded row stride (elements): ldmatrix without conflicts
constexpr int kWgbRows = kWgbTileM + kWgbTileN;  // a stage: 160 dY rows, then 64 X rows
constexpr int kWgbStage = kWgbRows * kWgbLd;

struct WgProduct {
  const void* dY;
  const void* X;
  const float* bsrc;
  int M, N, tiles_n, tile0;
  long long off;
};

struct WgGroup {
  WgProduct p[kGroupMax];
  int n;
};

__device__ __forceinline__ const WgProduct& find_product(const WgGroup& grp, int tile) {
  int p = 0;
  while (p + 1 < grp.n && grp.p[p + 1].tile0 <= tile) ++p;
  return grp.p[p];
}

// Row sums of bsrc (fp32) over [a0, a1) for the block's rows from m0, 8
// threads a row, a fixed-order shuffle sum.
__device__ void group_bias_src(const float* bsrc, float* out, int m0, int M, int A, int a0,
                               int a1) {
  for (int rb = 0; rb < kWgbTileM; rb += kWgbThreads / 8) {
    const int row = m0 + rb + threadIdx.x / 8, part = threadIdx.x % 8;
    float s = 0.0f;
    if (row < M)
      for (int a = a0 + part; a < a1; a += 8) s += bsrc[(size_t)row * A + a];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (part == 0 && row < M) out[row] = s;
  }
}

__global__ void __launch_bounds__(kWgbThreads, 2)
wgrad_group_bf16(const __grid_constant__ WgGroup grp, float* __restrict__ part,
                 long long stride, int A, int chunk) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const WgProduct& P = find_product(grp, blockIdx.x);
  const int local = blockIdx.x - P.tile0, M = P.M, N = P.N;
  const int m0 = local / P.tiles_n * kWgbTileM, n0 = local % P.tiles_n * kWgbTileN;
  const int a0 = blockIdx.y * chunk, a1 = min(A, a0 + chunk), nk = (a1 - a0) / kWgbK;
  const bf16* dY = static_cast<const bf16*>(P.dY);
  const bf16* X = static_cast<const bf16*>(P.X);

  auto issue = [&](int s) {
    if (s < nk) {
      bf16* st = ring + (s % kWgbStages) * kWgbStage;
      const size_t a = (size_t)a0 + (size_t)s * kWgbK;
      for (int e = threadIdx.x; e < kWgbRows * (kWgbK / 8); e += kWgbThreads) {
        const int r = e / (kWgbK / 8), c = e % (kWgbK / 8) * 8;
        const int row = r < kWgbTileM ? m0 + r : n0 + r - kWgbTileM;
        const bool in = row < (r < kWgbTileM ? M : N);
        const bf16* src = r < kWgbTileM ? dY : X;
        cp_async16(st + r * kWgbLd + c, in ? src + (size_t)row * A + a + c : src, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kWgbStages - 1; ++s) issue(s);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const bool active = m0 + wm < M;  // warps past M's rows multiply nothing
  const bool row_sums = n0 == 0 && P.bsrc == nullptr;
  const int brow = threadIdx.x >> 1, bhalf = (threadIdx.x & 1) * (kWgbK / 2);
  float bsum = 0.0f;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  for (int s = 0; s < nk; ++s) {
    cp_async_wait<kWgbStages - 2>();
    __syncthreads();
    issue(s + kWgbStages - 1);
    const bf16* Ys = ring + (s % kWgbStages) * kWgbStage;
    const bf16* Xs = Ys + kWgbTileM * kWgbLd;
#pragma unroll
    for (int k = 0; k < kWgbK && active; k += 16) {
      unsigned a[2][4], b[2][4];
      frag_a(a[0], Ys, kWgbLd, wm, k);
      frag_a(a[1], Ys, kWgbLd, wm + 16, k);
      frag_b_nk(b[0], Xs, kWgbLd, wn, k);
      frag_b_nk(b[1], Xs, kWgbLd, wn + 16, k);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], a[i], b[j >> 1][(j & 1) * 2],
                                             b[j >> 1][(j & 1) * 2 + 1]);
    }
    if (row_sums) {
      const uint4* p = reinterpret_cast<const uint4*>(Ys + brow * kWgbLd + bhalf);
#pragma unroll
      for (int v = 0; v < kWgbK / 16; ++v) {
        const uint4 q = p[v];
        const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16(w[e]);
          bsum += f.x;
          bsum += f.y;
        }
      }
    }
  }

  float* out = part + (size_t)blockIdx.y * stride + P.off;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + 16 * i + g + 8 * h;
      if (r < M) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + wn + 8 * j + 2 * t;
          if (c < N)
            *reinterpret_cast<float2*>(out + (size_t)r * N + c) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
  if (n0 == 0) {
    if (P.bsrc != nullptr) {
      group_bias_src(P.bsrc, out + (size_t)M * N, m0, M, A, a0, a1);
    } else {
      bsum += __shfl_xor_sync(0xffffffffu, bsum, 1);
      if (bhalf == 0 && m0 + brow < M) out[(size_t)M * N + m0 + brow] = bsum;
    }
  }
}

__global__ void __launch_bounds__(kWgThreads)
wgrad_group_f32(const __grid_constant__ WgGroup grp, float* __restrict__ part, long long stride,
                int A, int chunk) {
  const WgProduct& P = find_product(grp, blockIdx.x);
  const int local = blockIdx.x - P.tile0;
  const int m0 = local / P.tiles_n * 16, n0 = local % P.tiles_n * 64;
  const int a0 = blockIdx.y * chunk, a1 = min(A, a0 + chunk);
  float* out = part + (size_t)blockIdx.y * stride + P.off;
  const float* dY = static_cast<const float*>(P.dY);
  wgrad_tile_f32(dY, DenseX{static_cast<const float*>(P.X)}, out, P.M, P.N, A, m0, n0, a0, a1);
  if (n0 == 0) wgrad_bias(dY, P.bsrc, out + (size_t)P.M * P.N, m0, A, a0, a1);
}

int group_smem_bytes() { return kWgbStages * kWgbStage * (int)sizeof(__nv_bfloat16); }

// Launches the contraction of n products over (ceil(A / chunk)) chunks.
// part holds (chunks, stride) fp32; product p writes columns [off_p,
// off_p + M_p N_p + M_p).  Returns cudaGetLastError().
int launch_wgrad_group(int n, const void* const* dY, const void* const* X,
                       const void* const* bsrc, const int* M, const int* N, const long long* off,
                       void* part, long long stride, int bf16, int A, int chunk, cudaStream_t s) {
  if (n < 1 || n > kGroupMax || chunk <= 0 || chunk % (bf16 ? kWgbK : 32) ||
      A % (bf16 ? kWgbK : 16))
    return (int)cudaErrorInvalidValue;
  WgGroup grp;
  grp.n = n;
  int tiles = 0;
  for (int p = 0; p < n; ++p) {
    if (M[p] % 16 || N[p] % 16 || off[p] < 0 || off[p] + (long long)M[p] * N[p] + M[p] > stride)
      return (int)cudaErrorInvalidValue;
    const int tm = bf16 ? (M[p] + kWgbTileM - 1) / kWgbTileM : M[p] / 16;
    const int tn = (N[p] + 63) / 64;
    grp.p[p] = WgProduct{dY[p], X[p], static_cast<const float*>(bsrc[p]), M[p], N[p], tn, tiles,
                         off[p]};
    tiles += tm * tn;
  }
  const dim3 grid(tiles, (A + chunk - 1) / chunk);
  if (bf16)
    wgrad_group_bf16<<<grid, kWgbThreads, group_smem_bytes(), s>>>(
        grp, static_cast<float*>(part), stride, A, chunk);
  else
    wgrad_group_f32<<<grid, kWgThreads, 0, s>>>(grp, static_cast<float*>(part), stride, A, chunk);
  return (int)cudaGetLastError();
}

}  // namespace
