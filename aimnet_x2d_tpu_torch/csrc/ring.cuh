// Hopper bulk async copies into an mbarrier ring of shared-memory slots:
// the mbarrier helpers, a bulk copy that completes on a slot's barrier, and
// the ring of the stack's tiled forward (csrc/mp_stack.cu), which every warp
// acquires stage by stage and one thread refills at block barriers.
// Kernel 5's warp-specialised forward (csrc/mp_ext.cu) drives the same
// helpers from one producer warp, with an empty barrier a slot.
#pragma once

#include "walk.cuh"

namespace {

constexpr int kFwdRing = 11;  // ring slots: the longest product's stages (2Dp / 32 at Dp 160), + 1

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of bulk-copy data in this phase
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.  A
// wait that has not ended after ~2^35 clocks (tens of seconds) is a fault
// of the kernel: it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// One thread: bytes (a multiple of 16) from global src to shared dst by a
// bulk async copy, whose completion counts against bar's expected bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One thread: bytes (a multiple of 16) from shared src to global dst by a
// bulk async copy in this thread's bulk group (after fence_async_smem and a
// barrier that order the rows' writes before it).
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Waits until this thread's committed bulk stores have read their source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// The same, with bar's one arrival of this phase expecting the bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  mbar_expect(bar, bytes);
  bulk_load(dst, src, bytes, bar);
}

// The forward's weight stream through a ring of kFwdRing slots, as many as
// the longest product has stages, plus one.  Stage s lands in slot
// s % kFwdRing by one bulk async copy (cp.async.bulk: no registers, no
// instructions per element); the slot's mbarrier completes when its bytes
// have landed (one arrival, which expects them).  Every warp takes every
// stage by acquire(), in the same order, and gives nothing back stage by
// stage: at the block barrier after each product's epilogue, refill()
// starts the copies of the stages that the slots the product used can
// take.  So a product's stages are all on their way when it starts, and no
// warp waits for another between its stages.
struct FwdRing {
  const bf16* src;
  bf16* buf;
  unsigned long long* full;
  int stage_elems, total, cur, requested;
#ifdef MP_STACK_MARKS
  unsigned long long* waits;  // full-wait clocks of all warps, refills, the block's clocks
#endif

  __device__ void copy_stage(int s) {  // one thread: the bulk copy of stage s into its free slot
    const int slot = s % kFwdRing;
    bulk_copy(buf + (size_t)slot * stage_elems, src + (size_t)s * stage_elems,
              stage_elems * sizeof(bf16), full + slot);
  }
  // Every thread, after a block barrier that ends every warp's reads of the
  // stages before cur (the barriers are initialised before the first call).
  __device__ void refill() {
    const int upto = min(cur + kFwdRing, total);
    if (threadIdx.x == 0) {
      for (int s = requested; s < upto; ++s) copy_stage(s);
#ifdef MP_STACK_MARKS
      waits[1] += upto - requested;
#endif
    }
    requested = upto;
  }
  // One lane polls the slot's barrier; the warp barrier after it orders the
  // other lanes' reads of the stage after that lane's wait.
  __device__ const bf16* acquire() {
    const int slot = cur % kFwdRing;
    if ((threadIdx.x & 31) == 0) {
#ifdef MP_STACK_MARKS
      const long long t0 = clock64();
#endif
      mbar_wait(full + slot, (cur / kFwdRing) & 1);
#ifdef MP_STACK_MARKS
      atomicAdd(waits, (unsigned long long)(clock64() - t0));
#endif
    }
    __syncwarp();
    ++cur;
    return buf + (size_t)slot * stage_elems;
  }
};

}  // namespace
