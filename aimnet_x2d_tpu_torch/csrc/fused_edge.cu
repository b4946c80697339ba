// Edge aggregation of the flat (non-binned) layout, and the windowed segment
// sum.
//
// Kernel 7 (edge_agg): replaces the TPU kernel aimnet_x2d_tpu/ops/
// fused_edge.py::_kernel (pallas_call in ``_run``), forward and backward.
// It computes
//
//     out[a, :] = sum over the CSR row a of rnd(x[col[e], :])      (fp32)
//
// where the row's entries are the real edges whose destination is a
// (forward: col = source) or, on the transposed layout, whose source is a
// (backward: col = destination, x = the cotangent).  rnd rounds a value to
// bf16 where the kernel rounds (bf16 models: the forward's x is bf16
// already, the backward's fp32 cotangent is rounded here, as the TPU kernel
// rounds its operand at default precision) and is the identity otherwise.
//
// What bounds it on an H100: bytes -- x read once, the fp32 output written
// once, the CSR read once (14 us for the flat serving batch, bf16 x, D 153).
// The first kernel (one warp a row) gathered a source row from L2 per edge,
// E * D values, one 2-byte load a lane, a row's edges in series: split by
// phase on the card, 81% of a warp's clocks were those gathers, about 480
// clocks an edge.  The TPU kernel's own observation removes the gather:
// collate packs molecules contiguously and no edge crosses molecules, so
// the sources of a tile of consecutive destination rows lie in a few runs
// of x's rows.  The design:
// - the layout (ops/fused_edge.py::tile_intervals, on the host, once per
//   batch) lists each tile's source rows (tiles of 32 rows) as intervals of
//   whole 8-row groups (a gap of more than one empty group starts a new
//   interval: a tile of a long alkane's carbons reads its carbons and, a
//   molecule's length away, their hydrogens) and gives every edge its
//   source's row in the tile's image of those intervals (col_local);
// - the span route (edge_agg_kernel), when every tile's image fits the
//   staging budget: one 256-thread block a tile copies its image, its row
//   offsets and its edges' image rows into shared memory, in two rounds of
//   dependent loads -- cp.async where the image keeps x's type; for the
//   backward's fp32 cotangent of a bf16 model 16-byte loads rounded to bf16
//   in registers, so g is read and rounded once per tile, not per edge --
//   then each warp sums its rows from shared memory, four edges' loads
//   before their adds.  An interval starts on an 8-row group, so its copies
//   are 16-byte aligned on both sides whatever D is;
// - the direct route (edge_agg_row_kernel), when some tile's image exceeds
//   the budget (fp32 or wide rows of the large molecules): one warp a row
//   gathers from device memory, no shared memory.  A launch takes one route
//   (the wrapper's plan): mixing the two in one launch ran slower than
//   either;
// - each row is written once, by one warp, summing its edges in CSR order
//   from zero: the first kernel's bits, the same bits every run, no
//   atomics.  Rows with no edges are written as zeros.
//
// Kernel 8 (wseg_sum): replaces aimnet_x2d_tpu/ops/pallas_segment.py::
// _segment_kernel.  With ``data`` (W*cap, D) fp32 gathered by the caller
// and ``seg`` (W*cap,) the window-local destination of each slot (``window``
// or any id outside [0, window) for padding slots, which are dropped):
//
//     out[w*window + s, :] = sum over slots i of window w with seg[i] == s of rnd(data[i, :])
//
// What bounds it: bytes -- the real slots' data read once, the ids, the
// output written once (94 us for the flat serving batch at D 153).  The
// first kernel kept a window's sums for 64 columns in shared memory and had
// every thread walk all the window's slots, three in four skipping each
// one, one 4-byte load in flight (split on the card: 47% in the id reads
// and skips, 48% in the loads).  Summing runs of one id along a column in
// slot order, a warp a column group, was latency-bound on the card
// (about 60 clocks a slot with 5-12 such chains an SM, 0.25-0.29 ms however
// the slots were staged).  The design: one block a window and a part of
// its segments (six blocks an SM) sorts the window's slots by segment in
// shared memory (a stable counting sort, no atomics), then sums each
// segment's rows from device memory a warp a segment, as kernel 7's direct
// route sums a CSR row: every data row is read once, padding never, each
// output row written once; each segment's slots are summed from zero in
// slot order whatever the order of the ids, so the sums are the first
// kernel's bits and the same every run.
//
// Built with -DFUSED_EDGE_MARKS, the kernels record %globaltimer marks per
// block after block barriers (fused_edge_marks; chip_smoke.py's
// [flat-kernel] "phases" lines): kernel 7's tile blocks at the start, after
// the staging and after the sums, with their warps' clocks in the gathers
// and adds and in the stores; kernel 8's blocks at the start, after the
// list of slots and after the sums.

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kAggWarps = 8;  // kernels 7 and 8: 256-thread blocks
constexpr int kAggThreads = kAggWarps * 32;
constexpr int kEdgesAhead = 4;   // rows whose loads a lane issues before their adds (span route, 8)
constexpr int kDirectAhead = 2;  // the same on kernel 7's direct route
constexpr int kIvAhead = 3;      // a tile's intervals whose bounds load together
constexpr int kStageUnroll = 8;  // 16-byte loads a thread issues before their stores

// 4-byte async copy global -> shared (cp.async.ca: the .cg form takes 16).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// Shared-memory layout of a kernel 7 block: the image, then the tile's row
// offsets, then its edges' indices (16-byte aligned parts).
__host__ __device__ __forceinline__ int image_bytes(int stage_bytes) {
  return (stage_bytes + 15) & ~15;
}
__host__ __device__ __forceinline__ int row_slots(int tile_rows) { return (tile_rows + 4) & ~3; }

#ifdef FUSED_EDGE_MARKS
constexpr int kEdgeMarks = 8;  // values a block records
__device__ unsigned long long* g_edge_marks;  // (blocks, kEdgeMarks), set by fused_edge_marks
__device__ __forceinline__ void edge_mark(int i, unsigned long long v) {
  g_edge_marks[(size_t)(blockIdx.y * gridDim.x + blockIdx.x) * kEdgeMarks + i] = v;
}
__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define EDGE_MARK(i)                                        \
  do {                                                      \
    __syncthreads();                                        \
    if (threadIdx.x == 0) edge_mark((i), global_timer());   \
  } while (0)
#else
#define EDGE_MARK(i) \
  do {               \
  } while (0)
#endif

// ---- kernel 7 ---------------------------------------------------------- //

// The staged image's rows (shared memory) and x's rows (device memory, the
// direct route, rounded to bf16 where ROUND), as fp32 values.
template <typename St>
struct StagedRows {
  const St* s;
  int D;
  __device__ __forceinline__ float operator()(int r, int c) const { return to_f(s[r * D + c]); }
};
template <typename In, bool ROUND>
struct GlobalRows {
  const In* x;
  int D;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const float v = to_f(__ldg(x + r * D + c));
    return ROUND ? rnd<__nv_bfloat16>(v) : v;
  }
};

// The row's sum over its edges [eb, ee) in CSR order, for the lane's columns
// c0 + lane + 32 j (j < NC), written to orow; idx[e - off] gives edge e's
// row of ``rows`` (the tile's indices in shared memory, or the layout's).
template <int NC, int AHEAD, class Rows>
__device__ __forceinline__ void sum_row(const Rows& rows, const int* idx, int off, int eb, int ee,
                                        int c0, int D, float* __restrict__ orow,
                                        long long* clk) {
  const int lane = threadIdx.x & 31;
  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.0f;
  for (int e0 = eb; e0 < ee; e0 += 32) {
    const int mine = e0 + lane < ee ? idx[e0 + lane - off] : 0;
    const int n = min(32, ee - e0);
    int k = 0;
    for (; k + AHEAD <= n; k += AHEAD) {
      float v[AHEAD][NC];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int s = __shfl_sync(0xffffffffu, mine, k + u);
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = c0 + lane + 32 * j;
          v[u][j] = c < D ? rows(s, c) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] += v[u][j];
      }
    }
    for (; k < n; ++k) {
      const int s = __shfl_sync(0xffffffffu, mine, k);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < D) acc[j] += rows(s, c);
      }
    }
  }
#ifdef FUSED_EDGE_MARKS
  const long long t0 = clock64();
#endif
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = c0 + lane + 32 * j;
    if (c < D) orow[c] = acc[j];
  }
#ifdef FUSED_EDGE_MARKS
  if (clk) {
    clk[0] += t0;
    clk[1] += clock64() - t0;
  }
#endif
}

// Stages x's elements [g0, g1) at stage[g + shift]: 16-byte copies where x
// is 16-byte aligned (g0 and shift are multiples of 8: intervals start on
// 8-row groups), element by element for the rest.  Unrounded (St is In) by
// cp.async; rounded (fp32 x to a bf16 image) through registers.
template <typename In, typename St, bool ROUND>
__device__ __forceinline__ void stage_rows(const In* __restrict__ x, St* stage, int g0, int g1,
                                           int shift) {
  constexpr int V = 16 / sizeof(In);  // elements a 16-byte copy
  const int nv = (reinterpret_cast<uintptr_t>(x) & 15) == 0 ? (g1 - g0) / V : 0;
  if constexpr (!ROUND) {
    static_assert(std::is_same<In, St>::value, "an unrounded image keeps x's type");
    for (int q = threadIdx.x; q < nv; q += kAggThreads)
      cp_async16(stage + g0 + shift + q * V, x + g0 + q * V);
  } else {
    static_assert(std::is_same<In, float>::value && std::is_same<St, __nv_bfloat16>::value,
                  "a rounded image is fp32 x in bf16");
#pragma unroll kStageUnroll
    for (int q = threadIdx.x; q < nv; q += kAggThreads) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(x + g0 + q * V));
      *reinterpret_cast<uint2*>(stage + g0 + shift + q * V) =
          make_uint2(pack_bf16(f.x, f.y), pack_bf16(f.z, f.w));
    }
  }
  for (int g = g0 + nv * V + threadIdx.x; g < g1; g += kAggThreads)
    stage[g + shift] = from_f<St>(to_f(x[g]));
}

// The span route: one block a tile of tile_rows destination rows, its image
// in shared memory.  tile_iv (tiles + 1,) indexes iv (intervals, 3): an
// interval's first source row (a multiple of 8), its rows, its first row in
// the tile's image; col_local (E,) each edge's source row in the image.
// ROUND: fp32 x rounded to a bf16 image (else the image is x's type).
// Shared memory: the
// image (stage_bytes, which every tile's image fits), the tile's row
// offsets, and its edges' indices where they number at most idx_cap.
template <typename In, bool ROUND, int NC>
__global__ void __launch_bounds__(kAggThreads, ROUND ? 5 : 4)  // 51 or 64 registers a thread
edge_agg_kernel(const In* __restrict__ x, const int* __restrict__ row_ptr,
                const int* __restrict__ col_local, const int* __restrict__ tile_iv,
                const int* __restrict__ iv, float* __restrict__ out, int A, int D,
                int tile_rows, int stage_bytes, int idx_cap) {
  using St = std::conditional_t<ROUND, __nv_bfloat16, In>;  // the image's type
  extern __shared__ __align__(128) unsigned char smem[];
  St* stage = reinterpret_cast<St*>(smem);
  int* rows_s = reinterpret_cast<int*>(smem + image_bytes(stage_bytes));
  int* idx_s = rows_s + row_slots(tile_rows);
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x, r0 = t * tile_rows, r1 = min(r0 + tile_rows, A);
  EDGE_MARK(0);
  // Everything the tile reads lands in shared memory by async copies, issued
  // in as few rounds of dependent loads as the addresses allow: the row
  // offsets (no load needed), then the intervals and the edges' image rows
  // (after the tile's first interval and first edge), then the image.
  for (int i = threadIdx.x; i <= r1 - r0; i += kAggThreads) cp_async4(rows_s + i, row_ptr + r0 + i);
  const int k0 = __ldg(tile_iv + t), k1 = __ldg(tile_iv + t + 1);
  const int e_first = __ldg(row_ptr + r0), e_last = __ldg(row_ptr + r1);
  const bool local = e_last - e_first <= idx_cap;
  int ivr[3 * kIvAhead];  // the first intervals, loaded together
#pragma unroll
  for (int q = 0; q < 3 * kIvAhead; ++q) ivr[q] = k0 + q / 3 < k1 ? __ldg(iv + 3 * k0 + q) : 0;
  const int* idx = col_local;
  if (local) {
    for (int e = threadIdx.x; e < e_last - e_first; e += kAggThreads)
      cp_async4(idx_s + e, col_local + e_first + e);
    idx = idx_s;
  }
  const int off = local ? e_first : 0;
#pragma unroll
  for (int q = 0; q < kIvAhead; ++q) {
    if (k0 + q < k1) {
      const int a = ivr[3 * q], n = min(ivr[3 * q + 1], A - a), base = ivr[3 * q + 2];
      stage_rows<In, St, ROUND>(x, stage, a * D, (a + n) * D, (base - a) * D);
    }
  }
  for (int k = k0 + kIvAhead; k < k1; ++k) {
    const int a = iv[3 * k], n = min(iv[3 * k + 1], A - a), base = iv[3 * k + 2];
    stage_rows<In, St, ROUND>(x, stage, a * D, (a + n) * D, (base - a) * D);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  EDGE_MARK(1);
  long long clk[2] = {0, 0};  // the marked build's clocks: gathers and adds, stores
  for (int a = r0 + warp; a < r1; a += kAggWarps) {
#ifdef FUSED_EDGE_MARKS
    clk[0] -= clock64();  // sum_row adds the stores' start: the gathers and adds
#endif
    const int eb = rows_s[a - r0], ee = rows_s[a - r0 + 1];
    float* orow = out + (size_t)a * D;
    for (int c0 = 0; c0 < D; c0 += 32 * NC)
      sum_row<NC, kEdgesAhead>(StagedRows<St>{stage, D}, idx, off, eb, ee, c0, D, orow, clk);
  }
  EDGE_MARK(2);
#ifdef FUSED_EDGE_MARKS
  __shared__ unsigned long long sums[2];
  if (threadIdx.x < 2) sums[threadIdx.x] = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&sums[0], (unsigned long long)clk[0]);
    atomicAdd(&sums[1], (unsigned long long)clk[1]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    edge_mark(3, sums[0]);
    edge_mark(4, sums[1]);
    edge_mark(5, (unsigned long long)(e_last - e_first));
  }
#endif
}

// The direct route, where some tile's image exceeds the budget: one warp a
// row, each row's sources gathered from device memory with kDirectAhead
// edges' loads issued before their adds, as the first kernel did with one
// edge.  No shared memory, so the blocks an SM holds are bound by registers
// alone.
template <typename In, bool ROUND, int NC>
__global__ void __launch_bounds__(kAggThreads)
edge_agg_row_kernel(const In* __restrict__ x, const int* __restrict__ row_ptr,
                    const int* __restrict__ col, float* __restrict__ out, int A, int D) {
  const int a = blockIdx.x * kAggWarps + (threadIdx.x >> 5);
  if (a >= A) return;
  const int eb = __ldg(row_ptr + a), ee = __ldg(row_ptr + a + 1);
  float* orow = out + (size_t)a * D;
  for (int c0 = 0; c0 < D; c0 += 32 * NC)
    sum_row<NC, kDirectAhead>(GlobalRows<In, ROUND>{x, D}, col, 0, eb, ee, c0, D, orow, nullptr);
}

template <typename In, bool ROUND, int NC>
int launch_agg(const void* x, const int* row_ptr, const int* col, const int* col_local,
               const int* tile_iv, const int* iv, float* out, int A, int D, int tile_rows,
               int stage_bytes, int idx_cap, cudaStream_t s) {
  if (stage_bytes < 0) {  // the direct route
    edge_agg_row_kernel<In, ROUND, NC><<<(A + kAggWarps - 1) / kAggWarps, kAggThreads, 0, s>>>(
        static_cast<const In*>(x), row_ptr, col, out, A, D);
    return (int)cudaGetLastError();
  }
  auto kernel = edge_agg_kernel<In, ROUND, NC>;
  const int bytes = image_bytes(stage_bytes) + 4 * (row_slots(tile_rows) + idx_cap);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)  // as many tiles an SM as its shared memory holds
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(A + tile_rows - 1) / tile_rows, kAggThreads, bytes, s>>>(
      static_cast<const In*>(x), row_ptr, col_local, tile_iv, iv, out, A, D, tile_rows,
      stage_bytes, idx_cap);
  return (int)cudaGetLastError();
}

template <typename In, bool ROUND>
int launch_agg_nc(const void* x, const int* row_ptr, const int* col, const int* col_local,
                  const int* tile_iv, const int* iv, float* out, int A, int D, int tile_rows,
                  int stage_bytes, int idx_cap, cudaStream_t s) {
  // columns a lane: D <= 64, <= 160 (the flagship's 153), else passes of 192
  // (the flagship's 359 in two)
  if (D <= 64)
    return launch_agg<In, ROUND, 2>(x, row_ptr, col, col_local, tile_iv, iv, out, A, D,
                                        tile_rows, stage_bytes, idx_cap, s);
  if (D <= 160)
    return launch_agg<In, ROUND, 5>(x, row_ptr, col, col_local, tile_iv, iv, out, A, D,
                                        tile_rows, stage_bytes, idx_cap, s);
  return launch_agg<In, ROUND, 6>(x, row_ptr, col, col_local, tile_iv, iv, out, A, D,
                                      tile_rows, stage_bytes, idx_cap, s);
}

// ---- kernel 8 ---------------------------------------------------------- //

// One block a window and a part of its segments (grid: windows x parts).
// The block first builds, in shared memory, the list of its segments'
// slots, each segment's slots in slot order (a stable counting sort of the
// window's ids: each warp counts, then places, a contiguous eighth of the
// slots, so no atomics are needed and the order is fixed); then each warp
// sums a segment's rows from data, a row's columns over the lanes, as
// kernel 7's direct route sums a CSR row: every output row is written once,
// by one warp, its slots summed in slot order from zero.
template <bool ROUND, int NC>
__global__ void __launch_bounds__(kAggThreads)
wseg_sum_kernel(const float* __restrict__ data, const int* __restrict__ seg,
                float* __restrict__ out, int D, int window, int cap, int per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, w = blockIdx.x;
  const int s0 = blockIdx.y * per_block, n_seg = max(0, min(per_block, window - s0));
  int* counts = reinterpret_cast<int*>(smem);  // [warp][segment]: then each warp's cursor
  int* start = counts + kAggWarps * per_block;  // [segment + 1]: first list entry
  int* list = start + per_block + 1;           // the slots, segment by segment
  const size_t slot0 = (size_t)w * cap;
  const int span = (cap + kAggWarps - 1) / kAggWarps;  // a warp's slots: [lo, hi)
  const int lo = min(cap, warp * span), hi = min(cap, lo + span);
  EDGE_MARK(0);
  for (int i = threadIdx.x; i < kAggWarps * per_block; i += kAggThreads) counts[i] = 0;
  __syncthreads();
  // the key of a slot: its segment's place in the block's part, or -1
  auto key_of = [&](int i) {
    const int id = i < hi ? __ldg(seg + slot0 + i) - s0 : -1;
    return (unsigned)id < (unsigned)n_seg ? id : -1;
  };
  int* mine = counts + warp * per_block;
  for (int i0 = lo; i0 < hi; i0 += 32) {  // each warp counts its slots
    const int key = key_of(i0 + lane);
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1) mine[key] += __popc(peers);
  }
  __syncthreads();
  if (warp == 0) {  // the segments' starts (an exclusive scan), then each warp's cursor
    int carry = 0;
    for (int b = 0; b < n_seg; b += 32) {
      const int sg = b + lane;
      int total = 0;
      for (int v = 0; v < kAggWarps && sg < n_seg; ++v) {
        const int c = counts[v * per_block + sg];
        counts[v * per_block + sg] = total;  // the slots of warps before v
        total += c;
      }
      int incl = total;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (sg < n_seg) start[sg] = carry + incl - total;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) start[n_seg] = carry;
  }
  __syncthreads();
  for (int i0 = lo; i0 < hi; i0 += 32) {  // each warp places its slots, in order
    const int key = key_of(i0 + lane);
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0) {
      const int rank = __popc(peers & ((1u << lane) - 1u));
      list[start[key] + mine[key] + rank] = i0 + lane;
    }
    __syncwarp();
    if (key >= 0 && lane == __ffs(peers) - 1) mine[key] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  EDGE_MARK(1);
  // each warp sums its segments' rows: zero for a segment no slot names
  const float* rows = data + slot0 * D;
  for (int sg = warp; sg < n_seg; sg += kAggWarps) {
    float* orow = out + ((size_t)w * window + s0 + sg) * D;
    for (int c0 = 0; c0 < D; c0 += 32 * NC)
      sum_row<NC, kEdgesAhead>(GlobalRows<float, ROUND>{rows, D}, list, 0, start[sg],
                               start[sg + 1], c0, D, orow, nullptr);
  }
  EDGE_MARK(2);
#ifdef FUSED_EDGE_MARKS
  if (threadIdx.x == 0) edge_mark(3, (unsigned long long)start[n_seg]);  // the part's real slots
#endif
}

// The segments a block takes: enough blocks for about six an SM (parts of
// at least 8 segments).
int seg_per_block(int W, int window) {
  static int sms = 0;
  if (!sms) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int parts = std::max(1, std::min(window / 8, (6 * sms + W - 1) / std::max(W, 1)));
  return (window + parts - 1) / parts;
}

}  // namespace

extern "C" {

// out (A, D) fp32; x (A, D) fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1), staged
// and summed as bf16 when stage_bf16 (x fp32: rounded), as x's type
// otherwise; row_ptr (A + 1,), col (E,) and col_local (E,) int32; tile_iv
// (ceil(A / tile_rows) + 1,) and iv (intervals, 3) int32 (see
// edge_agg_kernel).  stage_bytes >= 0: the span route, every tile's image
// in at most stage_bytes of shared memory (edge_agg_kernel; a tile's edges'
// indices from device memory where they are more than idx_cap); < 0: the
// direct route (edge_agg_row_kernel).  Returns the error of
// cudaFuncSetAttribute, else cudaGetLastError() after the launch.
int edge_agg(const void* x, const void* row_ptr, const void* col, const void* col_local,
             const void* tile_iv, const void* iv, void* out, int x_bf16, int stage_bf16, int A,
             int D, int tile_rows, int stage_bytes, int idx_cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* c = static_cast<const int*>(col);
  const int* cl = static_cast<const int*>(col_local);
  const int* ti = static_cast<const int*>(tile_iv);
  const int* ivs = static_cast<const int*>(iv);
  float* o = static_cast<float*>(out);
  if (x_bf16)
    return launch_agg_nc<__nv_bfloat16, false>(x, rp, c, cl, ti, ivs, o, A, D, tile_rows,
                                               stage_bytes, idx_cap, s);
  if (stage_bf16)
    return launch_agg_nc<float, true>(x, rp, c, cl, ti, ivs, o, A, D, tile_rows, stage_bytes,
                                      idx_cap, s);
  return launch_agg_nc<float, false>(x, rp, c, cl, ti, ivs, o, A, D, tile_rows, stage_bytes,
                                     idx_cap, s);
}

// out (W*window, D) fp32; data (W*cap, D) fp32; seg (W*cap,) int32; a
// window's list of slots must fit a block's shared memory (cap up to about
// 50,000).  Returns the error of cudaFuncSetAttribute, else
// cudaGetLastError() after the launch.
int wseg_sum(const void* data, const void* seg, void* out, int W, int D, int window, int cap,
             int round_bf16, void* stream) {
  const int per = seg_per_block(W, window);
  const int bytes = 4 * (kAggWarps * per + per + 1 + cap);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  const dim3 grid(W, (window + per - 1) / per);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(data);
  const int* sg = static_cast<const int*>(seg);
  float* o = static_cast<float*>(out);
  auto go = [&](auto kernel) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kAggThreads, bytes, s>>>(d, sg, o, D, window, cap, per);
    return (int)cudaGetLastError();
  };
  if (round_bf16) {
    if (D <= 64) return go(wseg_sum_kernel<true, 2>);
    if (D <= 160) return go(wseg_sum_kernel<true, 5>);
    return go(wseg_sum_kernel<true, 6>);
  }
  if (D <= 64) return go(wseg_sum_kernel<false, 2>);
  if (D <= 160) return go(wseg_sum_kernel<false, 5>);
  return go(wseg_sum_kernel<false, 6>);
}

#ifdef FUSED_EDGE_MARKS
// Points the kernels' phase marks at marks ((blocks, 8) uint64).
int fused_edge_marks(void* marks) {
  return (int)cudaMemcpyToSymbol(g_edge_marks, &marks, sizeof(marks));
}
#endif

const char* fused_edge_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
