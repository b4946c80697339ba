// Binned attention pooling of row-major atom arrays, forward and backward:
// per-atom scores, a per-molecule masked softmax, the head-mean weight, the
// two weighted pools and the coverage, for the bin-packed layout.
//
// Replaces the TPU kernel aimnet_x2d_tpu/ops/bin_pool.py::_make_pool_op
// (fwd_kernel and bwd_kernel).  Per bin (one block), with xs (ab, Ds) and
// xo (ab, Do) the bin's rows in the compute dtype T:
//
//   forward   s = (xs ks + xo ko) + b                       (ab, H) fp32
//             attn = per-molecule masked softmax of s        (-1e30 mask,
//                    max shift, exp only on covered atoms, 1e-16 floor)
//             w = mean_h attn (fp32);  ps[m] = sum over m's atoms of
//             rnd(xs * rnd(w)) (fp32 sums), po alike;  cov[m] = sum of w
//   backward  reads the forward's attn; g_atom = the atom's molecule's
//             cotangent (fp32); dw = (g_s . xs + g_o . xo) + g_cov;
//             ds = rnd(attn dw/H - attn t_mol), t_mol = sum over the
//             molecule of attn dw/H; dxs = rnd(g_s w + ds ks^T), dxo alike;
//             per-bin fp32 partials of d_ks = xs^T ds, d_ko = xo^T ds and
//             d_b = sum of ds, summed over bins in a fixed order by
//             sum_partials (wgrad.cuh): no atomics, two runs bit-equal.
//
// ks and ko arrive as fp32 values already rounded to T, b in fp32, as the
// JAX op casts them.  Each atom belongs to at most one molecule of its bin
// (the loaders' pool_mat has one 1 per covered column), so the block looks
// each atom's molecule up once, lists each molecule's atoms in atom order,
// and turns every membership product of the TPU kernel (built for its
// matrix unit) into a sum over one molecule's atoms.
//
// What bounds it on an H100: every step is a pass over the bin's rows with
// a few operations per element, so it is bound by memory traffic (xs and
// xo read twice per direction, the second pass mostly from L2).  The
// kernels of one block a bin read rows with one warp per atom for the
// per-atom reductions and one thread per feature column for the pools and
// the gradients; the backward, and the forward where the tiles do not take
// the shape (H > 8, ab > 512, shared memory), run them.
//
// The forward on tiles (bin_pool_fwd_tile_kernel, bf16 and fp32).  The
// kernel of one block a bin spent, on an H100 at the training shape
// (-DBIN_POOL_MARKS), two thirds of a block in the scores (a warp an atom,
// strided 2-byte loads) and a quarter in the pools (a thread a (molecule,
// column), xs and xo read again), with 192 blocks on 132 SMs.  The design:
// - one 512-thread block per 64-atom tile, two an SM, the ab / 64 tiles of
//   a bin one thread-block cluster (768 blocks at the training batch);
// - the tile's rows of xs and xo, contiguous in the row-major arrays, land
//   in shared memory by two bulk async copies on one mbarrier (the wrapper
//   checks their 16-byte alignment), so each input byte crosses HBM once;
// - each atom's molecule from the tile's columns of the pool matrix
//   (csrc/pool_tiles.cuh tile_molecules), not a serial scan;
// - the scores on all threads: eight a tile's atom, each an eighth of the
//   columns, the eighths added in a fixed order by shuffles;
// - the masked softmax over molecules that cross tiles in one exchange: per
//   tile and (head, molecule) a partial maximum and the denominator at it,
//   combined over the cluster through distributed shared memory -- the
//   bin's maximum, the partial denominators rescaled to it and added in
//   rank order; each tile writes its attn columns;
// - the pools and coverage as per-tile fp32 partials, mb x (Ds + Do + 1),
//   a thread a column adding each run of one molecule's atoms (the runs
//   found once a tile by a warp's ballots) to that molecule's partial,
//   summed over the cluster in rank order (four partials a remote load),
//   each rank writing its share of the molecule rows.
// No atomics: reruns are bit-equal.

#include "pool_tiles.cuh"
#include "ring.cuh"
#include "wgrad.cuh"

namespace {

// Built with -DBIN_POOL_MARKS, bin_pool_fwd_kernel records a %globaltimer
// mark per block after a block barrier at each phase boundary (start,
// membership, scores, softmax, attn write, head mean and coverage, x_self
// pools, x_other pools; bin_pool_marks; chip_smoke.py's [pool6-kernel]
// "bin_pool_fwd phases" lines read them).
#ifdef BIN_POOL_MARKS
constexpr int kPoolMarks = 10;  // marks a block may record
__device__ unsigned long long* g_pool_marks;  // (blocks, kPoolMarks), set by bin_pool_marks
#define POOL_MARK(i)                                                        \
  do {                                                                      \
    __syncthreads();                                                        \
    if (threadIdx.x == 0) {                                                 \
      unsigned long long t_;                                                \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));               \
      g_pool_marks[(size_t)blockIdx.x * kPoolMarks + (i)] = t_;            \
    }                                                                       \
  } while (0)
#else
#define POOL_MARK(i) \
  do {               \
  } while (0)
#endif

constexpr int kPoolThreads = 256;
constexpr int kPoolWarps = kPoolThreads / 32;
constexpr int kPoolMaxH = 8;  // heads a thread keeps in registers

struct PoolSmem {
  float* S;      // H x ab: scores, then attn
  float* ds;     // H x ab: rounded softmax cotangent (backward)
  float* wbar;   // ab
  float* dwbar;  // ab (backward)
  float* red;    // 2 x H x mb: per-molecule max and sum, or t_mol
  int* molof;    // ab: molecule of each atom, -1 for none
  int* order;    // ab: the atoms of molecule 0, then of molecule 1, ...
  int* start;    // mb + 1: each molecule's first entry in order
};

size_t pool_smem_bytes(int H, int mb, int ab) {
  return (2 * (size_t)H * ab + 2 * (size_t)ab + 2 * (size_t)H * mb) * sizeof(float) +
         (2 * (size_t)ab + mb + 1) * sizeof(int);
}

__device__ PoolSmem pool_carve(unsigned char* base, int H, int mb, int ab) {
  PoolSmem s;
  float* p = reinterpret_cast<float*>(base);
  s.S = p; p += (size_t)H * ab;
  s.ds = p; p += (size_t)H * ab;
  s.wbar = p; p += ab;
  s.dwbar = p; p += ab;
  s.red = p; p += 2 * (size_t)H * mb;
  s.molof = reinterpret_cast<int*>(p);
  s.order = s.molof + ab;
  s.start = s.order + ab;
  return s;
}

__device__ __forceinline__ float pool_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Each atom's molecule, and the molecules' atom lists in atom order.
__device__ void pool_members(const PoolSmem& s, const int8_t* pm, int mb, int ab) {
  const int8_t* pmb = pm + (size_t)blockIdx.x * mb * ab;
  for (int a = threadIdx.x; a < ab; a += kPoolThreads) {
    int m = -1;
    for (int mm = 0; mm < mb; ++mm)
      if (pmb[(size_t)mm * ab + a] != 0) {
        m = mm;
        break;
      }
    s.molof[a] = m;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < mb; m += kPoolThreads) {
    int c = 0;
    for (int a = 0; a < ab; ++a) c += s.molof[a] == m;
    s.start[m + 1] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s.start[0] = 0;
    for (int m = 0; m < mb; ++m) s.start[m + 1] += s.start[m];
  }
  __syncthreads();
  for (int m = threadIdx.x; m < mb; m += kPoolThreads) {
    int k = s.start[m];
    for (int a = 0; a < ab; ++a)
      if (s.molof[a] == m) s.order[k++] = a;
  }
  __syncthreads();
}

// w = mean over heads of attn (S), per atom
__device__ void pool_head_mean(const PoolSmem& s, int H, int ab) {
  for (int a = threadIdx.x; a < ab; a += kPoolThreads) {
    float acc = 0.0f;
    for (int h = 0; h < H; ++h) acc += s.S[h * ab + a];
    s.wbar[a] = acc / (float)H;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
bin_pool_fwd_kernel(const T* __restrict__ xs, const T* __restrict__ xo,
                    const int8_t* __restrict__ pm, const float* __restrict__ score,
                    float* __restrict__ ps, float* __restrict__ po, float* __restrict__ cov,
                    float* __restrict__ attn_out, int Ds, int Do, int H, int A, int mb, int ab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PoolSmem s = pool_carve(smem, H, mb, ab);
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t col0 = (size_t)b * ab, mol0 = (size_t)b * mb;
  const float* ks = score;
  const float* ko = score + (size_t)Ds * H;
  const float* sb = ko + (size_t)Do * H;
  POOL_MARK(0);
  pool_members(s, pm, mb, ab);
  POOL_MARK(1);

  // scores: one warp per atom, lanes over the feature columns
  for (int a = warp; a < ab; a += kPoolWarps) {
    const T* rs = xs + (col0 + a) * Ds;
    const T* ro = xo + (col0 + a) * Do;
    float as[kPoolMaxH], ao[kPoolMaxH];
#pragma unroll
    for (int h = 0; h < kPoolMaxH; ++h) as[h] = ao[h] = 0.0f;
    for (int d = lane; d < Ds; d += 32) {
      const float x = to_f(rs[d]);
#pragma unroll
      for (int h = 0; h < kPoolMaxH; ++h)
        if (h < H) as[h] = fmaf(x, ks[d * H + h], as[h]);
    }
    for (int d = lane; d < Do; d += 32) {
      const float x = to_f(ro[d]);
#pragma unroll
      for (int h = 0; h < kPoolMaxH; ++h)
        if (h < H) ao[h] = fmaf(x, ko[d * H + h], ao[h]);
    }
#pragma unroll
    for (int h = 0; h < kPoolMaxH; ++h)
      if (h < H) {
        const float v = (warp_sum(as[h]) + warp_sum(ao[h])) + sb[h];
        if (lane == 0) s.S[h * ab + a] = v;
      }
  }
  __syncthreads();
  POOL_MARK(2);

  // per-molecule max and denominator, one warp per (head, molecule)
  float* smax = s.red;
  float* den = s.red + (size_t)H * mb;
  for (int p = warp; p < H * mb; p += kPoolWarps) {
    const int h = p / mb, m = p % mb;
    float mx = -1e30f;
    for (int k = s.start[m] + lane; k < s.start[m + 1]; k += 32)
      mx = fmaxf(mx, s.S[h * ab + s.order[k]]);
    mx = pool_warp_max(mx);
    float e = 0.0f;
    for (int k = s.start[m] + lane; k < s.start[m + 1]; k += 32)
      e += expf(s.S[h * ab + s.order[k]] - mx);
    e = warp_sum(e);
    if (lane == 0) {
      smax[p] = mx;
      den[p] = e;
    }
  }
  __syncthreads();
  POOL_MARK(3);
  for (int e = threadIdx.x; e < H * ab; e += kPoolThreads) {
    const int h = e / ab, a = e % ab, m = s.molof[a];
    float at = 0.0f;
    if (m >= 0) at = expf(s.S[e] - smax[h * mb + m]) / fmaxf(den[h * mb + m], 1e-16f);
    s.S[e] = at;
    attn_out[(size_t)h * A + col0 + a] = at;
  }
  __syncthreads();
  POOL_MARK(4);
  pool_head_mean(s, H, ab);
  for (int m = threadIdx.x; m < mb; m += kPoolThreads) {
    float acc = 0.0f;
    for (int k = s.start[m]; k < s.start[m + 1]; ++k) acc += s.wbar[s.order[k]];
    cov[mol0 + m] = acc;
  }
  POOL_MARK(5);

  // pools: one thread per (molecule, column), the molecule's atoms in order
  for (int part = 0; part < 2; ++part) {
    const T* x = part == 0 ? xs : xo;
    float* out = part == 0 ? ps : po;
    const int D = part == 0 ? Ds : Do;
    for (int i = threadIdx.x; i < mb * D; i += kPoolThreads) {
      const int m = i / D, d = i % D;
      float acc = 0.0f;
      for (int k = s.start[m]; k < s.start[m + 1]; ++k) {
        const int a = s.order[k];
        acc += rnd<T>(to_f(x[(col0 + a) * D + d]) * rnd<T>(s.wbar[a]));
      }
      out[(mol0 + m) * D + d] = acc;
    }
    POOL_MARK(6 + part);
  }
}

// part: per bin [d_ks (Ds x H), d_ko (Do x H), d_b (H)]
template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
bin_pool_bwd_kernel(const T* __restrict__ xs, const T* __restrict__ xo,
                    const int8_t* __restrict__ pm, const float* __restrict__ score,
                    const float* __restrict__ attn_in, const float* __restrict__ gps,
                    const float* __restrict__ gpo, const float* __restrict__ gcov,
                    T* __restrict__ dxs, T* __restrict__ dxo, float* __restrict__ part, int Ds,
                    int Do, int H, int A, int mb, int ab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PoolSmem s = pool_carve(smem, H, mb, ab);
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t col0 = (size_t)b * ab, mol0 = (size_t)b * mb;
  const float* ks = score;
  const float* ko = score + (size_t)Ds * H;
  float* pb = part + (size_t)b * ((size_t)(Ds + Do) * H + H);
  pool_members(s, pm, mb, ab);
  for (int e = threadIdx.x; e < H * ab; e += kPoolThreads)
    s.S[e] = attn_in[(size_t)(e / ab) * A + col0 + e % ab];
  __syncthreads();
  pool_head_mean(s, H, ab);

  // dw = (g_s . xs + g_o . xo) + g_cov at the atom's molecule, one warp per atom
  for (int a = warp; a < ab; a += kPoolWarps) {
    const int m = s.molof[a];
    float s1 = 0.0f, s2 = 0.0f;
    if (m >= 0) {
      const float* gs = gps + (mol0 + m) * Ds;
      const float* go = gpo + (mol0 + m) * Do;
      const T* rs = xs + (col0 + a) * Ds;
      const T* ro = xo + (col0 + a) * Do;
      for (int d = lane; d < Ds; d += 32) s1 = fmaf(gs[d], to_f(rs[d]), s1);
      for (int d = lane; d < Do; d += 32) s2 = fmaf(go[d], to_f(ro[d]), s2);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) s.dwbar[a] = m >= 0 ? (s1 + s2) + gcov[mol0 + m] : 0.0f;
  }
  __syncthreads();

  // softmax backward: t_mol, then ds rounded to T, and d_b's partial
  float* tmol = s.red;
  for (int p = threadIdx.x; p < H * mb; p += kPoolThreads) {
    const int h = p / mb, m = p % mb;
    float acc = 0.0f;
    for (int k = s.start[m]; k < s.start[m + 1]; ++k) {
      const int a = s.order[k];
      acc += s.S[h * ab + a] * (s.dwbar[a] / (float)H);
    }
    tmol[p] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H * ab; e += kPoolThreads) {
    const int h = e / ab, a = e % ab, m = s.molof[a];
    const float at = s.S[e], dat = s.dwbar[a] / (float)H;
    const float tm = m >= 0 ? tmol[h * mb + m] : 0.0f;
    s.ds[e] = rnd<T>(at * dat - at * tm);
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += kPoolThreads) {
    float acc = 0.0f;
    for (int a = 0; a < ab; ++a) acc += s.ds[h * ab + a];
    pb[(size_t)(Ds + Do) * H + h] = acc;
  }

  // dx and the score-weight partials: one thread per column of [xs | xo],
  // walking the bin's atoms in order
  for (int c = threadIdx.x; c < Ds + Do; c += kPoolThreads) {
    const bool self = c < Ds;
    const int d = self ? c : c - Ds, D = self ? Ds : Do;
    const T* x = self ? xs : xo;
    const float* g = self ? gps : gpo;
    const float* kw = (self ? ks : ko) + (size_t)d * H;
    T* dx = self ? dxs : dxo;
    float k[kPoolMaxH], acc[kPoolMaxH];
#pragma unroll
    for (int h = 0; h < kPoolMaxH; ++h) {
      k[h] = h < H ? kw[h] : 0.0f;
      acc[h] = 0.0f;
    }
    for (int a = 0; a < ab; ++a) {
      const size_t o = (col0 + a) * D + d;
      const int m = s.molof[a];
      const float xv = to_f(x[o]);
      const float gv = m >= 0 ? g[(mol0 + m) * D + d] : 0.0f;
      float dsum = 0.0f;
#pragma unroll
      for (int h = 0; h < kPoolMaxH; ++h)
        if (h < H) {
          const float dsv = s.ds[h * ab + a];
          dsum = fmaf(dsv, k[h], dsum);
          acc[h] = fmaf(xv, dsv, acc[h]);
        }
      dx[o] = from_f<T>(gv * s.wbar[a] + dsum);
    }
    float* pw = pb + (self ? 0 : (size_t)Ds * H) + (size_t)d * H;
    for (int h = 0; h < H; ++h) pw[h] = acc[h];
  }
}

// ---- the forward on tiles: one block per 64-atom tile, a cluster per bin ----

constexpr int kTileThreads = 512;  // eight threads an atom for the scores, two blocks an SM
constexpr int kTileHead = 16;      // bytes of the tile's mbarrier

// Shared memory of a tile: its xs and xo rows (as they lie in the row-major
// arrays), the score weights, its atoms' molecules, scores and weights, the
// softmax's per-(head, molecule) partials and the bin's values, and its
// pool partials (mb x (Ds + Do + 1): x_self, x_other, coverage).
__host__ __device__ __forceinline__ int pool_hp(int H) { return H <= 4 ? 4 : 8; }
// the partials' floats, padded to whole float4s
__host__ __device__ __forceinline__ int pool_part4(int Ds, int Do, int mb) {
  return (mb * (Ds + Do + 1) + 3) / 4 * 4;
}

template <typename T>
size_t pool_tile_smem_bytes(int Ds, int Do, int H, int mb) {
  return kTileHead + (size_t)kTile * (Ds + Do) * sizeof(T) +
         ((size_t)(Ds + Do + 1) * pool_hp(H) + (size_t)H * kTile + 2 * kTile +
          4 * (size_t)H * mb + pool_part4(Ds, Do, mb)) * sizeof(float) +
         3 * (kTile + 1) * sizeof(int);
}

template <typename T>
bool pool_tiles_fit(int Ds, int Do, int H, int mb, int ab) {
  return H >= 1 && H <= kPoolMaxH && mb >= 1 && Ds >= 1 && Do >= 1 && ab % kTile == 0 &&
         ab / kTile >= 1 && ab / kTile <= kWalkMaxCluster &&
         pool_tile_smem_bytes<T>(Ds, Do, H, mb) <= (size_t)kSmemLimit;
}

// As bin_pool_fwd_kernel, one block per 64-atom tile, grid nb * C, clusters
// of C = ab / 64.  The tile's rows of xs and xo (contiguous in the
// row-major arrays) arrive by two bulk async copies on one mbarrier; the
// scores, softmax and pools read them from shared memory.
template <typename T>
__global__ void __launch_bounds__(kTileThreads, 2)
bin_pool_fwd_tile_kernel(const T* __restrict__ xs, const T* __restrict__ xo,
                         const int8_t* __restrict__ pm, const float* __restrict__ score,
                         float* __restrict__ ps, float* __restrict__ po, float* __restrict__ cov,
                         float* __restrict__ attn_out, int Ds, int Do, int H, int A, int mb,
                         int ab) {
  namespace cgr = cooperative_groups;
  cgr::cluster_group cluster = cgr::this_cluster();
  const int C = ab / kTile, rank = (int)cluster.block_rank();
  const int bin = blockIdx.x / C, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t cc = (size_t)bin * ab + (size_t)rank * kTile, mol0 = (size_t)bin * mb;
  const int K = Ds + Do;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Hp = pool_hp(H), n4 = pool_part4(Ds, Do, mb);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  T* xst = reinterpret_cast<T*>(smem + kTileHead);  // 64 x Ds
  T* xot = xst + (size_t)kTile * Ds;                // 64 x Do
  // ks, ko (rows of Hp, zero past H), then b
  float* ksm = reinterpret_cast<float*>(xot + (size_t)kTile * Do);
  float* sc = ksm + (size_t)(K + 1) * Hp;  // H x 64: scores, then attn
  float* wbar = sc + (size_t)H * kTile;
  float* wr = wbar + kTile;             // rnd(wbar)
  float* pmax = wr + kTile;             // H x mb: this tile's partial max
  float* pden = pmax + (size_t)H * mb;  // H x mb: its partial denominator at that max
  float* gmax = pden + (size_t)H * mb;  // H x mb: the bin's max
  float* gden = gmax + (size_t)H * mb;  // H x mb: the bin's denominator
  float* part = gden + (size_t)H * mb;  // mb x (K + 1), padded to n4: the pools' and coverage's partials
  int* molof = reinterpret_cast<int*>(part + n4);
  int* rstart = molof + kTile;       // runs of atoms of one molecule: first atoms,
  int* rmol = rstart + kTile + 1;    // their molecules, and the count at rmol[kTile]
  POOL_MARK(0);

  // the tile's rows by bulk async copies; meanwhile the score weights, the
  // molecules of its atoms and zeroed partials
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const unsigned bs = kTile * Ds * sizeof(T), bo = kTile * Do * sizeof(T);
    mbar_expect(bar, bs + bo);
    bulk_load(xst, xs + cc * Ds, bs, bar);
    bulk_load(xot, xo + cc * Do, bo, bar);
  }
  for (int e = threadIdx.x; e < (K + 1) * Hp; e += kTileThreads) {
    const int d = e / Hp, h = e % Hp;
    ksm[e] = h < H ? score[(size_t)d * H + h] : 0.0f;
  }
  for (int e = threadIdx.x; e < n4; e += kTileThreads) part[e] = 0.0f;
  tile_molecules(molof, pm + (size_t)bin * mb * ab + (size_t)rank * kTile, mb, ab);
  __syncthreads();
  if (warp == 0) {  // the runs: an atom opens one where its molecule differs from the last's
    const int m0 = molof[lane], m1 = molof[lane + 32];
    const bool o0 = lane == 0 || m0 != molof[lane - 1], o1 = m1 != molof[lane + 31];
    const unsigned b0 = __ballot_sync(0xffffffffu, o0), b1 = __ballot_sync(0xffffffffu, o1);
    const unsigned below = (1u << lane) - 1u;
    if (o0) {
      rstart[__popc(b0 & below)] = lane;
      rmol[__popc(b0 & below)] = m0;
    }
    if (o1) {
      rstart[__popc(b0) + __popc(b1 & below)] = lane + 32;
      rmol[__popc(b0) + __popc(b1 & below)] = m1;
    }
    if (lane == 0) {
      const int n = __popc(b0) + __popc(b1);
      rstart[n] = kTile;
      rmol[kTile] = n;
    }
  }
  mbar_wait(bar, 0);
  __syncthreads();
  POOL_MARK(1);

  // s = (xs ks + xo ko) + b: eight threads an atom, each an eighth of the
  // columns (c = p, p + 8, ...); the eighths summed in a fixed order by
  // shuffles
  {
    const int a = threadIdx.x >> 3, p = threadIdx.x & 7;
    float vs[kPoolMaxH], vo[kPoolMaxH];
#pragma unroll
    for (int h = 0; h < kPoolMaxH; ++h) vs[h] = vo[h] = 0.0f;
    // a row of the score weights as one or two float4 loads
    auto fma_row = [&](float (&v)[kPoolMaxH], float x, const float* kr) {
      const float4 k0 = *reinterpret_cast<const float4*>(kr);
      v[0] = fmaf(x, k0.x, v[0]);
      v[1] = fmaf(x, k0.y, v[1]);
      v[2] = fmaf(x, k0.z, v[2]);
      v[3] = fmaf(x, k0.w, v[3]);
      if (Hp == 8) {
        const float4 k1 = *reinterpret_cast<const float4*>(kr + 4);
        v[4] = fmaf(x, k1.x, v[4]);
        v[5] = fmaf(x, k1.y, v[5]);
        v[6] = fmaf(x, k1.z, v[6]);
        v[7] = fmaf(x, k1.w, v[7]);
      }
    };
    const T* rs = xst + (size_t)a * Ds;
#pragma unroll 4
    for (int d = p; d < Ds; d += 8) fma_row(vs, to_f(rs[d]), ksm + (size_t)d * Hp);
    const T* ro = xot + (size_t)a * Do;
#pragma unroll 4
    for (int d = p; d < Do; d += 8) fma_row(vo, to_f(ro[d]), ksm + (size_t)(Ds + d) * Hp);
#pragma unroll
    for (int h = 0; h < kPoolMaxH; ++h)
      if (h < H) {
        // ((q0 + q1) + (q2 + q3)) + ((q4 + q5) + (q6 + q7)), the same on
        // the eight lanes
        float s1 = vs[h], s2 = vo[h];
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        if (p == 0) sc[h * kTile + a] = (s1 + s2) + ksm[(size_t)K * Hp + h];
      }
  }
  __syncthreads();
  POOL_MARK(2);

  // the per-molecule masked softmax over molecules that cross tiles, one
  // exchange: each tile's partial max per (head, molecule) and its partial
  // denominator at that max; the bin's max over the ranks (exact in any
  // order), its denominator the ranks' partials rescaled to it, summed in
  // rank order
  for (int q = warp; q < H * mb; q += kTileThreads / 32) {
    const int h = q / mb, m = q % mb;
    const float s0 = molof[lane] == m ? sc[h * kTile + lane] : -1e30f;
    const float s1 = molof[lane + 32] == m ? sc[h * kTile + lane + 32] : -1e30f;
    const float mx = warp_max(fmaxf(s0, s1));
    float e = (molof[lane] == m ? expf(s0 - mx) : 0.0f) +
              (molof[lane + 32] == m ? expf(s1 - mx) : 0.0f);
    e = warp_sum(e);
    if (lane == 0) {
      pmax[q] = mx;
      pden[q] = e;
    }
  }
  cluster.sync();
  for (int q = threadIdx.x; q < H * mb; q += kTileThreads) {
    float pm_r[kWalkMaxCluster], pd_r[kWalkMaxCluster];
#pragma unroll
    for (int r = 0; r < kWalkMaxCluster; ++r)
      if (r < C) {
        pm_r[r] = cluster.map_shared_rank(pmax, r)[q];
        pd_r[r] = cluster.map_shared_rank(pden, r)[q];
      }
    float mx = -1e30f;
#pragma unroll
    for (int r = 0; r < kWalkMaxCluster; ++r)
      if (r < C) mx = fmaxf(mx, pm_r[r]);
    float den = 0.0f;
#pragma unroll
    for (int r = 0; r < kWalkMaxCluster; ++r)
      if (r < C) den += pd_r[r] * expf(pm_r[r] - mx);
    gmax[q] = mx;
    gden[q] = den;
  }
  __syncthreads();
  POOL_MARK(3);
  for (int e = threadIdx.x; e < H * kTile; e += kTileThreads) {
    const int h = e / kTile, c = e % kTile, m = molof[c];
    const float at =
        m >= 0 ? expf(sc[e] - gmax[h * mb + m]) / fmaxf(gden[h * mb + m], 1e-16f) : 0.0f;
    sc[e] = at;
    attn_out[(size_t)h * A + cc + c] = at;
  }
  __syncthreads();
  // wbar = the mean over heads (summed in head order)
  for (int c = threadIdx.x; c < kTile; c += kTileThreads) {
    float v = 0.0f;
    for (int h = 0; h < H; ++h) v += sc[h * kTile + c];
    wbar[c] = v / (float)H;
    wr[c] = rnd<T>(v / (float)H);
  }
  __syncthreads();
  POOL_MARK(4);

  // the tile's partials: a thread a column of [xs | xo | 1] sums
  // rnd(x rnd(wbar)) (coverage: wbar) over each run of atoms of one
  // molecule, in atom order, and adds each run's sum to its molecule's
  // partial (its own column: no other thread writes it)
  const int n_runs = rmol[kTile];
  for (int col = threadIdx.x; col <= K; col += kTileThreads) {
    const bool self = col < Ds;
    const T* xc = self ? xst + col : xot + (col - Ds);
    const int ld = self ? Ds : Do;
    for (int r = 0; r < n_runs; ++r) {
      const int m = rmol[r];
      if (m < 0) continue;
      float run = 0.0f;
#pragma unroll 4
      for (int c = rstart[r]; c < rstart[r + 1]; ++c)
        run += col < K ? rnd<T>(to_f(xc[(size_t)c * ld]) * wr[c]) : wbar[c];
      part[(size_t)m * (K + 1) + col] += run;
    }
  }
  POOL_MARK(5);

  // the bin's ps, po and cov: the tiles' partials in rank order, the
  // elements spread over the cluster
  cluster.sync();
  const int n = mb * (K + 1);
  for (int i4 = rank * kTileThreads + threadIdx.x; i4 < n4 / 4; i4 += C * kTileThreads) {
    float4 pr[kWalkMaxCluster];
#pragma unroll
    for (int r = 0; r < kWalkMaxCluster; ++r)
      if (r < C) pr[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r) + 4 * i4);
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < kWalkMaxCluster; ++r)
      if (r < C) {
        v[0] += pr[r].x;
        v[1] += pr[r].y;
        v[2] += pr[r].z;
        v[3] += pr[r].w;
      }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * i4 + k;
      if (i >= n) break;
      const int m = i / (K + 1), col = i % (K + 1);
      if (col < Ds)
        ps[(mol0 + m) * Ds + col] = v[k];
      else if (col < K)
        po[(mol0 + m) * Do + col - Ds] = v[k];
      else
        cov[mol0 + m] = v[k];
    }
  }
  cluster.sync();  // the other tiles' reads of this block's partials are done
  POOL_MARK(6);
}

bool pool_tiles_configured[2][kMaxDevices];

template <typename T>
int launch_pool_fwd_tiles(const void* xs, const void* xo, const void* pm, const void* score,
                          void* ps, void* po, void* cov, void* attn, int Ds, int Do, int H, int nb,
                          int mb, int ab, cudaStream_t st) {
  if (!pool_tiles_fit<T>(Ds, Do, H, mb, ab)) return (int)cudaErrorInvalidValue;
  const int err = configure(bin_pool_fwd_tile_kernel<T>, pool_tiles_configured[sizeof(T) == 4]);
  if (err) return err;
  const int C = ab / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * C);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = pool_tile_smem_bytes<T>(Ds, Do, H, mb);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, bin_pool_fwd_tile_kernel<T>, static_cast<const T*>(xs), static_cast<const T*>(xo),
      static_cast<const int8_t*>(pm), static_cast<const float*>(score), static_cast<float*>(ps),
      static_cast<float*>(po), static_cast<float*>(cov), static_cast<float*>(attn), Ds, Do, H,
      nb * ab, mb, ab);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pool_fwd(const void* xs, const void* xo, const void* pm, const void* score, void* ps,
                    void* po, void* cov, void* attn, int Ds, int Do, int H, int nb, int mb, int ab,
                    cudaStream_t st) {
  const size_t bytes = pool_smem_bytes(H, mb, ab);
  if (bytes > (size_t)kSmemLimit || H > kPoolMaxH) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bin_pool_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  bin_pool_fwd_kernel<T><<<nb, kPoolThreads, bytes, st>>>(
      static_cast<const T*>(xs), static_cast<const T*>(xo), static_cast<const int8_t*>(pm),
      static_cast<const float*>(score), static_cast<float*>(ps), static_cast<float*>(po),
      static_cast<float*>(cov), static_cast<float*>(attn), Ds, Do, H, nb * ab, mb, ab);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pool_bwd(const void* xs, const void* xo, const void* pm, const void* score,
                    const void* attn, const void* gps, const void* gpo, const void* gcov,
                    void* dxs, void* dxo, void* part, int Ds, int Do, int H, int nb, int mb,
                    int ab, cudaStream_t st) {
  const size_t bytes = pool_smem_bytes(H, mb, ab);
  if (bytes > (size_t)kSmemLimit || H > kPoolMaxH) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bin_pool_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  bin_pool_bwd_kernel<T><<<nb, kPoolThreads, bytes, st>>>(
      static_cast<const T*>(xs), static_cast<const T*>(xo), static_cast<const int8_t*>(pm),
      static_cast<const float*>(score), static_cast<const float*>(attn),
      static_cast<const float*>(gps), static_cast<const float*>(gpo),
      static_cast<const float*>(gcov), static_cast<T*>(dxs), static_cast<T*>(dxo),
      static_cast<float*>(part), Ds, Do, H, nb * ab, mb, ab);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long bin_pool_smem_bytes(int H, int mb, int ab) {
  return H > kPoolMaxH ? (long long)kSmemLimit + 1 : (long long)pool_smem_bytes(H, mb, ab);
}

// Shared memory of the forward on tiles at these shapes, or -1 where it
// does not take them (the wrapper then launches bin_pool_fwd).
long long bin_pool_tiles_smem_bytes(int bf16, int Ds, int Do, int H, int mb, int ab) {
  if (bf16)
    return pool_tiles_fit<__nv_bfloat16>(Ds, Do, H, mb, ab)
               ? (long long)pool_tile_smem_bytes<__nv_bfloat16>(Ds, Do, H, mb) : -1;
  return pool_tiles_fit<float>(Ds, Do, H, mb, ab)
             ? (long long)pool_tile_smem_bytes<float>(Ds, Do, H, mb) : -1;
}

// The forward on tiles (bin_pool_fwd_tile_kernel): the arguments and
// outputs of bin_pool_fwd; xs and xo 16-byte aligned.
int bin_pool_fwd_tiles(const void* xs, const void* xo, const void* pm, const void* score,
                       void* ps, void* po, void* cov, void* attn, int bf16, int Ds, int Do, int H,
                       int nb, int mb, int ab, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_pool_fwd_tiles<__nv_bfloat16>(xs, xo, pm, score, ps, po, cov, attn, Ds,
                                                     Do, H, nb, mb, ab, st)
              : launch_pool_fwd_tiles<float>(xs, xo, pm, score, ps, po, cov, attn, Ds, Do, H, nb,
                                             mb, ab, st);
}

// Each returns cudaGetLastError() after its launch (0 on success).
int bin_pool_fwd(const void* xs, const void* xo, const void* pm, const void* score, void* ps,
                 void* po, void* cov, void* attn, int bf16, int Ds, int Do, int H, int nb, int mb,
                 int ab, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_pool_fwd<__nv_bfloat16>(xs, xo, pm, score, ps, po, cov, attn, Ds, Do, H,
                                               nb, mb, ab, st)
              : launch_pool_fwd<float>(xs, xo, pm, score, ps, po, cov, attn, Ds, Do, H, nb, mb,
                                       ab, st);
}

int bin_pool_bwd(const void* xs, const void* xo, const void* pm, const void* score,
                 const void* attn, const void* gps, const void* gpo, const void* gcov, void* dxs,
                 void* dxo, void* part, int bf16, int Ds, int Do, int H, int nb, int mb, int ab,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_pool_bwd<__nv_bfloat16>(xs, xo, pm, score, attn, gps, gpo, gcov, dxs, dxo,
                                               part, Ds, Do, H, nb, mb, ab, st)
              : launch_pool_bwd<float>(xs, xo, pm, score, attn, gps, gpo, gcov, dxs, dxo, part,
                                       Ds, Do, H, nb, mb, ab, st);
}

// Column sums of the (n, size) per-bin partials, bins in order.
int bin_pool_sum_partials(const void* part, void* out, int n, long long size, void* stream) {
  return launch_sum_partials(part, out, n, size, static_cast<cudaStream_t>(stream));
}

#ifdef BIN_POOL_MARKS
// Points the forward kernels' phase marks at marks ((blocks, 10) uint64).
int bin_pool_marks(void* marks) {
  return (int)cudaMemcpyToSymbol(g_pool_marks, &marks, sizeof(marks));
}
#endif

const char* bin_pool_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
