// Weighted per-molecule pool of the bin-packed layout, forward (kernel 2)
// and backward (kernel 2b).
//
// Forward, wpool_fwd_kernel: replaces the TPU kernel
// aimnet_x2d_tpu/ops/bin_wpool.py:83 (fwd_kernel of _make_wpool_op,
// pallas_call :158).  From x (D, A = nb*ab) in bf16 or fp32, w (A,) fp32 and
// the int8 membership matrix pm (nb, mb, ab):
//
//     out[d, b*mb + m] = sum_a  rnd(x[d, b*ab + a] * rnd(w[b*ab + a])) * pm[b, m, a]
//
// rnd rounds to x's dtype, as the JAX package does; the sum is fp32 and so
// is the output.  Any int8 pm is taken (an atom may sit in several slots
// or carry another value than 1), any mb.
//
// What bounds it: bytes.  It reads x once (D*A elements) and writes an
// output mb/ab as wide; the useful sums are D*nnz(pm) FMAs, far below the
// card's rate.  Design: one block of 4 warps per bin, group of up to 64
// slots and run of 64-row tiles.  Each warp streams its 16 rows of x as
// 64-atom chunks through its own ring (4 stages, fp32 2) of 16-byte
// cp.async copies (rows past D and atoms past ab zero filled), so the next
// chunks' loads overlap the current chunk's sums with no block-wide
// barrier in the loop.
// The sums run on the tensor cores (mma.sync m16n8k16, fp32 accumulate):
// the warp's A fragments come from its ring with ldmatrix and are
// multiplied by rnd(w) and rounded in the fragment (bf16x2 multiply), so
// the product is rounded where JAX rounds it; pm, exact in bf16, is the B
// operand, laid out in fragment order in shared memory once per block.
// fp32 x takes the same path: each rounded fp32 product is split exactly
// into three bf16 parts (hi + mid + lo) and the three products are summed.
// The dense product does D*mb*ab multiply-adds instead of D*nnz(pm), a few
// percent of the time at the card's tensor-core rate, and it needs no
// per-slot lists: walking those from shared memory column by column hits
// one bank in four (rows placed at 16-byte steps reach 8 of the 32 banks)
// and would make the sums, not the copies, the limit.
//
// Backward, wpool_bwd_kernel: replaces :98 (bwd_kernel, pallas_call :172,
// the custom VJP :187-199).  From the fp32 cotangent g (D, nb*mb):
//
//     gatom[d, a] = sum_m  rnd(g[d, b*mb + m]) * pm[b, m, a]     (fp32)
//     dx[d, a]    = (T)(gatom[d, a] * w[a])                       (w not rounded)
//     dw[a]       = sum_d  gatom[d, a] * x[d, a]                  (fp32, when asked)
//
// What bounds it: bytes (dx written, g read; with dw also x read).  Design:
// one block of 256 threads per 128-atom strip of a bin, over all D rows,
// so dw is finished inside the block in a fixed order: no scratch, no
// second launch, reruns bit-equal.  Each thread owns 16 bytes of a row per
// pass (8 bf16 or 4 fp32 atoms) and stores their dx as one 16-byte vector,
// neighbouring threads on neighbouring addresses.  The bin's g rows stream
// through a 2-stage shared-memory ring of cp.async copies (16 bytes when mb
// is a multiple of 4), rounded to x's dtype once in place.  Each atom's
// (slot, value) comes from pm once per block: an atom in one slot (every
// real batch) reads one g value a row; an atom in several slots sums them
// in slot order from pm's copy in shared memory.  gatom sums on the CUDA
// cores in fp32, as the plain version does, so dx rounds from the same
// fp32 value (tensor-core sums round otherwise).  x is read, a pass ahead,
// only when dw is asked for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kSmemLimit = 232448;  // bytes of shared memory one block may use
constexpr int kMaxDevices = 64;

template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bf2(unsigned v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// D (16 x 8, fp32) += A (16 x 16, bf16, row-major) * B (16 x 8, bf16); a
// register-only instruction, left for the compiler to schedule.
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], uint2 b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Sets a kernel's dynamic shared-memory ceiling once per device; sms, when
// given, gets the device's SM count (asked once too).
int device_sms[kMaxDevices];

template <typename K> int configure(K kernel, bool (&done)[kMaxDevices], int* sms = nullptr) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && device_sms[dev] == 0)
      err = cudaDeviceGetAttribute(&device_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  if (sms) *sms = device_sms[dev];
  return 0;
}

// ---- forward ----

constexpr int kFwdThreads = 128;  // 4 warps, 16 rows each
constexpr int kFwdRows = 64;      // feature rows per block
constexpr int kChunk = 64;        // atoms per ring stage
constexpr int kLdS = kChunk + 8;  // padded row stride of a stage (elements)
// ring stages of each warp: fp32 stages are twice the bytes, and two keep
// more blocks on an SM (measured faster than three or four)
template <typename T> constexpr int kStages = sizeof(T) == 2 ? 4 : 2;
constexpr int kSlotGroup = 64;    // molecule slots per block (8 n-tiles of 8)
constexpr int kNT = kSlotGroup / 8;

// Weight pairs of a chunk as the A fragments use them: rounded to x's dtype.
template <typename T> struct WPair;
template <> struct WPair<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct WPair<float> { using type = float2; };

// pm's rows of a slot group, padded so that the B-fragment build reads
// them without bank conflicts, and 8-byte aligned for the async copies.
__host__ __device__ __forceinline__ int pm_stride(int ab) { return ab + 8; }

template <typename T>
size_t fwd_smem_bytes(int mb, int ab) {
  const int chunks = (ab + kChunk - 1) / kChunk;
  const int nt = mb < kSlotGroup ? (mb + 7) / 8 : kNT;
  return (size_t)kStages<T> * kFwdRows * kLdS * sizeof(T)             // ring
         + (size_t)chunks * (kChunk / 16) * nt * 32 * sizeof(uint2)  // B fragments
         + (size_t)chunks * (kChunk / 2) * sizeof(typename WPair<T>::type)  // rnd(w) pairs
         + (size_t)ab * sizeof(float)                               // w's copy
         + (size_t)8 * nt * pm_stride(ab);                          // pm's copy
}

// Splits two fp32 values exactly into bf16x2 parts hi + mid + lo.
__device__ __forceinline__ void split3(float2 p, unsigned& hi, unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p.x, p.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(p.x - hf.x, p.y - hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r.x, r.y);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r.x - mf.x, r.y - mf.y));
}

// One 16-atom k-step of a warp's 16 rows: the weighted, rounded A fragments
// times each n-tile's B fragment.
template <typename T> struct KStep;

template <> struct KStep<__nv_bfloat16> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* stage, int row0, int kk,
                                             const __nv_bfloat162* wp, const uint2* bf, int nt,
                                             float (&acc)[kNT][4]) {
    const int lane = threadIdx.x & 31;
    // ldmatrix x4: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15) = a0..a3
    const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8, c = kk * 16 + (lane >> 4) * 8;
    unsigned a[4];
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(smem_addr(stage + r * kLdS + c)));
    const int t = lane & 3;
    const __nv_bfloat162 wlo = wp[kk * 8 + t], whi = wp[kk * 8 + t + 4];
    a[0] = bits(__hmul2(bf2(a[0]), wlo));
    a[1] = bits(__hmul2(bf2(a[1]), wlo));
    a[2] = bits(__hmul2(bf2(a[2]), whi));
    a[3] = bits(__hmul2(bf2(a[3]), whi));
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      if (j < nt) mma16816(acc[j], a, bf[j * 32 + lane]);
  }
};

template <> struct KStep<float> {
  __device__ __forceinline__ static void run(const float* stage, int row0, int kk,
                                             const float2* wp, const uint2* bf, int nt,
                                             float (&acc)[kNT][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* p0 = stage + (row0 + g) * kLdS + kk * 16 + 2 * t;
    const float* p1 = p0 + 8 * kLdS;
    const float2 wlo = wp[kk * 8 + t], whi = wp[kk * 8 + t + 4];
    float2 v[4] = {*reinterpret_cast<const float2*>(p0), *reinterpret_cast<const float2*>(p1),
                   *reinterpret_cast<const float2*>(p0 + 8),
                   *reinterpret_cast<const float2*>(p1 + 8)};
    unsigned hi[4], mid[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 w2 = i < 2 ? wlo : whi;
      // __fmul_rn: the rounded product, never contracted into the split
      split3(make_float2(__fmul_rn(v[i].x, w2.x), __fmul_rn(v[i].y, w2.y)), hi[i], mid[i],
             lo[i]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j < nt) {
        const uint2 b = bf[j * 32 + lane];
        mma16816(acc[j], hi, b);
        mma16816(acc[j], mid, b);
        mma16816(acc[j], lo, b);
      }
    }
  }
};

// Each block walks row tiles [tile0, tile0 + tiles) of its bin: the ring
// streams their chunks back to back, so one tile's stores overlap the next
// tile's loads and the bin's B fragments are built once.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
wpool_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const int8_t* __restrict__ pm, float* __restrict__ out, int D, int A, int nb,
                 int mb, int ab, int tiles_per_block) {
  using WP = typename WPair<T>::type;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kPieces = kChunk / kVec;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int b = blockIdx.x, m0 = blockIdx.z * kSlotGroup;
  const int nt = min(kNT, (mb - m0 + 7) / 8), rows_pm = min(kSlotGroup, mb - m0);
  const int chunks = (ab + kChunk - 1) / kChunk, ksteps = chunks * (kChunk / 16);
  const int tile0 = blockIdx.y * tiles_per_block;
  const int ntile = min(tiles_per_block, (D + kFwdRows - 1) / kFwdRows - tile0);
  const int nq = ntile * chunks;  // chunks this block streams
  uint2* bfrag = reinterpret_cast<uint2*>(ring + kStages<T> * kFwdRows * kLdS);
  WP* wpair = reinterpret_cast<WP*>(bfrag + (size_t)ksteps * nt * 32);
  float* wcopy = reinterpret_cast<float*>(wpair + chunks * (kChunk / 2));
  int8_t* pmcopy = reinterpret_cast<int8_t*>(wcopy + ab);
  const int pld = pm_stride(ab);
  const size_t col0 = (size_t)b * ab;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // chunk q of this warp's 16 rows into its part of stage q % kStages
  auto load_chunk = [&](int q) {
    T* st = ring + ((q % kStages<T>) * kFwdRows + warp * 16) * kLdS;
    const int d0 = (tile0 + q / chunks) * kFwdRows + warp * 16, a0 = (q % chunks) * kChunk;
#pragma unroll
    for (int k = 0; k < 16 * kPieces / 32; ++k) {
      const int i = lane + 32 * k, r = i / kPieces, a = a0 + (i % kPieces) * kVec;
      const bool ok = d0 + r < D && a < ab;
      const T* src = ok ? x + (size_t)(d0 + r) * A + col0 + a : x;
      cp_async16(st + r * kLdS + (i % kPieces) * kVec, src, ok ? 16 : 0);
    }
  };
  // group 0: w's and pm's slices of the bin; the first chunks' groups follow
  for (int i = tid; i < ab / 4; i += kFwdThreads)
    cp_async16(wcopy + 4 * i, w + col0 + 4 * i, 16);
  const int8_t* pmb = pm + ((size_t)b * mb + m0) * ab;
  for (int i = tid; i < rows_pm * (ab / 8); i += kFwdThreads) {
    const int m = i / (ab / 8), a = (i % (ab / 8)) * 8;
    cp_async8(pmcopy + m * pld + a, pmb + (size_t)m * ab + a);
  }
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages<T> - 1; ++s) {
    if (s < nq) load_chunk(s);
    cp_async_commit();
  }
  cp_async_wait<kStages<T> - 1>();
  __syncthreads();  // group 0 landed for every thread; the chunks are in flight
  // rnd(w) in pairs, and pm's B fragments (n = slot, k = atom; zero past
  // mb and ab) in fragment order
  for (int p = tid; p < chunks * (kChunk / 2); p += kFwdThreads) {
    const int a = 2 * p;
    const float w0 = a < ab ? rnd<T>(wcopy[a]) : 0.0f;
    const float w1 = a < ab ? rnd<T>(wcopy[a + 1]) : 0.0f;  // ab is even
    if constexpr (sizeof(T) == 2) {
      wpair[p] = __floats2bfloat162_rn(w0, w1);
    } else {
      wpair[p] = make_float2(w0, w1);
    }
  }
  for (int e = tid; e < ksteps * nt * 32; e += kFwdThreads) {
    const int l = e & 31, j = (e >> 5) % nt, ks = (e >> 5) / nt;
    const int m = j * 8 + (l >> 2), k = ks * 16 + (l & 3) * 2;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (m < rows_pm) {
      const int8_t* row = pmcopy + m * pld;
      if (k < ab) v[0] = row[k], v[1] = row[k + 1];
      if (k + 8 < ab) v[2] = row[k + 8], v[3] = row[k + 9];
    }
    bfrag[e] = make_uint2(bits(__floats2bfloat162_rn(v[0], v[1])),
                          bits(__floats2bfloat162_rn(v[2], v[3])));
  }
  __syncthreads();

  const size_t ldo = (size_t)nb * mb;
  const int g = lane >> 2, t = lane & 3;
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  // each warp streams its own rows: no block-wide barrier from here on
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<kStages<T> - 2>();  // this thread's copies of chunk q have landed
    __syncwarp();                     // the warp's have; its chunk q-1 stage is free
    if (q + kStages<T> - 1 < nq) load_chunk(q + kStages<T> - 1);
    cp_async_commit();
    const int c = q % chunks;
    const T* st = ring + (q % kStages<T>) * kFwdRows * kLdS;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      KStep<T>::run(st, warp * 16, kk, wpair + c * (kChunk / 2),
                    bfrag + (size_t)(c * (kChunk / 16) + kk) * nt * 32, nt, acc);
    if (c != chunks - 1) continue;
    // the tile's last chunk: C fragment (row g, slots 2t, 2t+1) and (row
    // g + 8, the same slots)
    const int d0 = (tile0 + q / chunks) * kFwdRows + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int m = m0 + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = d0 + 8 * h;
        if (j < nt && d < D) {
          float* o = out + (size_t)d * ldo + (size_t)b * mb + m;
          if (m + 1 < mb && (mb & 1) == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
          } else {
            if (m < mb) o[0] = acc[j][2 * h];
            if (m + 1 < mb) o[1] = acc[j][2 * h + 1];
          }
        }
        acc[j][2 * h] = acc[j][2 * h + 1] = 0.0f;
      }
    }
  }
}

bool fwd_done_bf16[kMaxDevices], fwd_done_f32[kMaxDevices];

template <typename T>
int launch_fwd(const void* x, const void* w, const void* pm, void* out, int D, int A, int nb,
               int mb, int ab, cudaStream_t stream, bool (&done)[kMaxDevices]) {
  int sms = 0;
  int err = configure(wpool_fwd_kernel<T>, done, &sms);
  if (err) return err;
  // row tiles per block: about four blocks for each SM, the rest walked
  const int tiles = (D + kFwdRows - 1) / kFwdRows, groups = (mb + kSlotGroup - 1) / kSlotGroup;
  const long long work = (long long)nb * tiles * groups;
  const long long want = 4LL * std::max(1, sms);
  const int per = (int)std::min<long long>(tiles, (work + want - 1) / want);
  const dim3 grid(nb, (tiles + per - 1) / per, groups);
  const size_t bytes = fwd_smem_bytes<T>(mb, ab);
  wpool_fwd_kernel<T><<<grid, kFwdThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const int8_t*>(pm),
      static_cast<float*>(out), D, A, nb, mb, ab, per);
  return (int)cudaGetLastError();
}

// ---- backward ----

constexpr int kBwdThreads = 256;
constexpr int kStrip = 128;            // atoms per block
constexpr int kGStage = 16 * 1024;     // bytes of a g stage, at most
constexpr int kMulti = 1 << 30;        // entry of an atom in several slots

// Rows a pass covers: each thread stores 16 bytes of dx (8 bf16 or 4 fp32
// atoms), the strip's row takes kStrip / that many threads.
__host__ __device__ constexpr int bwd_rows(int itemsize) {
  return kBwdThreads / (kStrip * itemsize / 16);
}

// Padded row stride of a g stage (floats): column mb stays 0 (atoms of no
// slot read it); a multiple of 4 for 16-byte copies when mb is one, else
// odd (neighbouring rows on other banks).
__host__ __device__ __forceinline__ int g_stride(int mb) {
  return mb % 4 == 0 ? mb + 4 : (mb + 1) | 1;
}

// Rows of a g stage: whole passes, within kGStage bytes when it can.
__host__ __device__ __forceinline__ int g_rows(int mb, int itemsize) {
  const int pass = bwd_rows(itemsize);
  const int rows = kGStage / (g_stride(mb) * 4) / pass * pass;
  return rows < pass ? pass : rows;
}

size_t bwd_smem_bytes(int mb, int itemsize, bool dw) {
  return (size_t)2 * g_rows(mb, itemsize) * g_stride(mb) * sizeof(float)  // g ring
         + (size_t)mb * kStrip                                             // pm's strip
         + (size_t)kStrip * sizeof(int)                                    // entries
         + (dw ? (size_t)bwd_rows(itemsize) * kStrip * sizeof(float) : 0);  // dw partials
}

template <typename T> struct Vec;  // the 16 bytes of a row a thread owns
template <> struct Vec<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float get(int k) const {
    const unsigned u = (&v.x)[k >> 1];
    return __uint_as_float((k & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&f)[8]) {
    uint4 o;
    o.x = bits(__floats2bfloat162_rn(f[0], f[1]));
    o.y = bits(__floats2bfloat162_rn(f[2], f[3]));
    o.z = bits(__floats2bfloat162_rn(f[4], f[5]));
    o.w = bits(__floats2bfloat162_rn(f[6], f[7]));
    *reinterpret_cast<uint4*>(p) = o;
  }
};
template <> struct Vec<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float get(int k) const { return (&v.x)[k]; }
  __device__ __forceinline__ static void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// kDw: dw is summed (x read); else x is never read.
template <typename T, bool kDw>
__global__ void __launch_bounds__(kBwdThreads)
wpool_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const int8_t* __restrict__ pm, const float* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ dw, int D, int A, int nb, int mb, int ab) {
  constexpr int V = 16 / sizeof(T);           // atoms a thread owns
  constexpr int kCpr = kStrip / V;            // threads of a row
  constexpr int kRows = bwd_rows(sizeof(T));  // rows a pass
  extern __shared__ __align__(128) unsigned char smem[];
  const int gld = g_stride(mb), grows = g_rows(mb, sizeof(T));
  float* gring = reinterpret_cast<float*>(smem);                      // [2][grows][gld]
  int8_t* pms = reinterpret_cast<int8_t*>(gring + 2 * grows * gld);   // [mb][kStrip]
  int* ents = reinterpret_cast<int*>(pms + (size_t)mb * kStrip);       // [kStrip]
  float* red = reinterpret_cast<float*>(ents + kStrip);                // [kRows][kStrip]
  const int strips = (ab + kStrip - 1) / kStrip;
  const int b = blockIdx.x / strips, a0 = (blockIdx.x % strips) * kStrip;
  const int width = min(kStrip, ab - a0);
  const int tid = threadIdx.x, j = tid % kCpr, r = tid / kCpr;
  const bool active = V * j < width;
  const size_t ldg = (size_t)nb * mb, col = (size_t)b * ab + a0 + V * j;
  const bool gvec = mb % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;

  // g's rows [c * grows, +grows) of the bin's mb columns into stage c & 1
  auto load_g = [&](int c) {
    float* st = gring + (c & 1) * grows * gld;
    const int rows = min(grows, D - c * grows);
    const float* src = g + (size_t)c * grows * ldg + (size_t)b * mb;
    if (gvec) {
      const int q = mb / 4;
      for (int e = tid; e < rows * q; e += kBwdThreads) {
        const int rr = e / q, m = (e - rr * q) * 4;
        cp_async16(st + rr * gld + m, src + rr * ldg + m, 16);
      }
    } else {
      for (int e = tid; e < rows * mb; e += kBwdThreads) {
        const int rr = e / mb, m = e - rr * mb;
        cp_async4(st + rr * gld + m, src + rr * ldg + m);
      }
    }
  };
  load_g(0);
  cp_async_commit();

  for (int rr = tid; rr < 2 * grows; rr += kBwdThreads) gring[rr * gld + mb] = 0.0f;
  const int8_t* pmb = pm + (size_t)b * mb * ab + a0;
  for (int e = tid; e < mb * kStrip; e += kBwdThreads) {
    const int m = e / kStrip, aa = e % kStrip;
    pms[e] = aa < width ? pmb[(size_t)m * ab + aa] : 0;
  }
  float wv[V];
  if (active) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(w + col) + q);
      wv[4 * q] = w4.x, wv[4 * q + 1] = w4.y, wv[4 * q + 2] = w4.z, wv[4 * q + 3] = w4.w;
    }
  }
  __syncthreads();
  // each atom's entry: -1 (no slot), slot << 8 | value byte (one slot), or
  // kMulti (several, summed in slot order from pms)
  if (tid < kStrip) {
    int e = -1, n = 0;
    for (int m = 0; m < mb; ++m) {
      const int v = pms[m * kStrip + tid];
      if (v != 0) {
        if (n == 0) e = (m << 8) | (v & 0xff);
        ++n;
      }
    }
    ents[tid] = n > 1 ? kMulti : e;
  }
  __syncthreads();
  // this thread's atoms: the g column each reads (mb, the zero column, for
  // no slot or several) and its value
  int idx[V];
  float val[V];
  bool multi = false;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int e = ents[V * j + k];
    const bool one = e >= 0 && e != kMulti;
    multi |= e == kMulti;
    idx[k] = one ? e >> 8 : mb;
    val[k] = one ? (float)(int8_t)(e & 0xff) : 0.0f;
  }

  float dwacc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) dwacc[k] = 0.0f;
  Vec<T> xv, xn;
  if (kDw && active && r < D) xv.load(x + (size_t)r * A + col);
  const int chunks = (D + grows - 1) / grows;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // stage c landed for every thread; stage c - 1 is free
    if (c + 1 < chunks) load_g(c + 1);
    cp_async_commit();
    float* st = gring + (c & 1) * grows * gld;
    const int rows = min(grows, D - c * grows);
    if constexpr (sizeof(T) == 2) {  // rnd(g) once, in place (pads too: never read)
      for (int e = tid; e < rows * gld; e += kBwdThreads) st[e] = rnd<T>(st[e]);
      __syncthreads();
    }
    if (!active) continue;
    for (int p = r; p < rows; p += kRows) {
      const int d = c * grows + p;
      if (kDw && d + kRows < D) xn.load(x + (size_t)(d + kRows) * A + col);
      const float* grow = st + p * gld;
      float ga[V];
#pragma unroll
      for (int k = 0; k < V; ++k) ga[k] = grow[idx[k]] * val[k];
      if (multi) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (ents[V * j + k] != kMulti) continue;
          float sum = 0.0f;
          for (int m = 0; m < mb; ++m) {
            const int v = pms[m * kStrip + V * j + k];
            if (v != 0) sum = fmaf(grow[m], (float)v, sum);
          }
          ga[k] = sum;
        }
      }
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = ga[k] * wv[k];
      Vec<T>::store(dx + (size_t)d * A + col, o);
      if constexpr (kDw) {
#pragma unroll
        for (int k = 0; k < V; ++k) dwacc[k] = fmaf(ga[k], xv.get(k), dwacc[k]);
        xv = xn;
      }
    }
  }
  if constexpr (kDw) {
    // fixed-order sum of the row lanes' partials, one thread per atom
#pragma unroll
    for (int k = 0; k < V; ++k) red[r * kStrip + V * j + k] = dwacc[k];
    __syncthreads();
    if (tid < width) {
      float sum = 0.0f;
      for (int rr = 0; rr < kRows; ++rr) sum += red[rr * kStrip + tid];
      dw[(size_t)b * ab + a0 + tid] = sum;
    }
  }
}

bool bwd_done[2][2][kMaxDevices];  // [bf16][dw]

template <typename T, bool kDw>
int launch_bwd_dw(const void* x, const void* w, const void* pm, const void* g, void* dx,
                  void* dw, int D, int A, int nb, int mb, int ab, cudaStream_t stream) {
  int err = configure(wpool_bwd_kernel<T, kDw>, bwd_done[sizeof(T) == 2][kDw]);
  if (err) return err;
  const int strips = (ab + kStrip - 1) / kStrip;
  const size_t bytes = bwd_smem_bytes(mb, sizeof(T), kDw);
  wpool_bwd_kernel<T, kDw><<<nb * strips, kBwdThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const int8_t*>(pm),
      static_cast<const float*>(g), static_cast<T*>(dx), static_cast<float*>(dw), D, A, nb, mb,
      ab);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* pm, const void* g, void* dx, void* dw,
               int D, int A, int nb, int mb, int ab, cudaStream_t stream) {
  return dw ? launch_bwd_dw<T, true>(x, w, pm, g, dx, dw, D, A, nb, mb, ab, stream)
            : launch_bwd_dw<T, false>(x, w, pm, g, dx, dw, D, A, nb, mb, ab, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a launch (bytes): the wrapper refuses shapes
// over one block's limit.
long long wpool_smem_bytes(int bf16, int mb, int ab) {
  return (long long)(bf16 ? fwd_smem_bytes<__nv_bfloat16>(mb, ab) : fwd_smem_bytes<float>(mb, ab));
}

long long wpool_bwd_smem_bytes(int bf16, int mb, int ab) {
  (void)ab;
  return (long long)bwd_smem_bytes(mb, bf16 ? 2 : 4, true);
}

// Each returns cudaGetLastError() after its launch (0 on success).  x, w,
// g, dx and out start on 16-byte boundaries and ab is a multiple of 8
// (the wrapper checks); dw null skips dw.
int wpool_fwd(const void* x, const void* w, const void* pm, void* out, int bf16, int D, int A,
              int nb, int mb, int ab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, w, pm, out, D, A, nb, mb, ab, s, fwd_done_bf16)
              : launch_fwd<float>(x, w, pm, out, D, A, nb, mb, ab, s, fwd_done_f32);
}

int wpool_bwd(const void* x, const void* w, const void* pm, const void* g, void* dx, void* dw,
              int bf16, int D, int A, int nb, int mb, int ab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(x, w, pm, g, dx, dw, D, A, nb, mb, ab, s)
              : launch_bwd<float>(x, w, pm, g, dx, dw, D, A, nb, mb, ab, s);
}

const char* wpool_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
