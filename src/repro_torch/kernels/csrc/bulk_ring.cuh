// A ring of shared-memory stages filled by Hopper's 1-D bulk copies (TMA
// without a tensor map), shared by the streaming kernels (va.cu, gemv.cu).
//
// One elected producer thread issues
// `cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes` for a
// stage after `mbarrier.arrive.expect_tx` on the stage's `full` barrier; the
// copy engine writes the bytes into shared memory and counts them off that
// barrier. Consumer warps wait on `full`'s phase, use the stage, and arrive on
// its `empty` barrier; the producer waits on `empty` before it refills the
// stage. So a block keeps up to STAGES stages of bytes in flight with no
// per-element address arithmetic and no registers spent on loads.
//
// Phases: use j of stage s (the ring's iteration i = j * STAGES + s) waits on
// full[s] with parity j & 1; the producer's fill j >= 1 waits on empty[s]
// with parity (j - 1) & 1.
//
// Layout of the dynamic shared memory: the 2 * STAGES barriers in the first
// kBarrierBytes, then the stages (each 16-byte aligned, as bulk copies need).
//
// The launch plans (the cut of the work over the persistent blocks, the
// stage sizes, the routes) are computed in Python: repro_torch/kernels/
// bulk_ring.py, va.py and gemv.py.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk_ring {

constexpr int kBarrierBytes = 128;      // room for 2 * 8 barriers of 8 bytes
constexpr int kMaxSmem = 232448;        // an H100 block's opt-in maximum

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the copy engine
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ bool try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// A wait that outlasts kWaitCycles (seconds; a stage arrives in
// microseconds) traps, so that a ring that never fills ends the kernel
// with an error instead of hanging the card.
constexpr long long kWaitCycles = 1LL << 33;

__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  while (!try_wait(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned; completion is counted off `bar`'s transaction count
__device__ __forceinline__ void load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16) from shared `src` to global `dst`, as one bulk
// group of the calling thread; order the generic proxy's writes of `src`
// before it with fence_proxy_async
__device__ __forceinline__ void store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the calling thread's bulk stores but the newest N have read their source
template <int N>
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// the calling thread's bulk stores are complete
__device__ __forceinline__ void store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` over `threads` threads (a multiple of 32): the producer
// warp arrives without waiting, the consumers wait
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The ring's barriers, at the start of the dynamic shared memory.
template <int STAGES>
struct Ring {
  static_assert(2 * STAGES * 8 <= kBarrierBytes, "barriers do not fit");
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ explicit Ring(unsigned char* smem)
      : full(reinterpret_cast<uint64_t*>(smem)), empty(full + STAGES) {}

  // by one thread, before any other thread uses the barriers: `full` waits
  // for the producer's one arrival and the bytes, `empty` for `consumers`
  // arrivals
  __device__ __forceinline__ void init_barriers(uint32_t consumers) {
    for (int s = 0; s < STAGES; ++s) {
      init(full + s, 1);
      init(empty + s, consumers);
    }
    fence_init();
  }

  // producer: before filling iteration i's stage, with `bytes` expected
  __device__ __forceinline__ uint64_t* acquire(long long i, uint32_t bytes) {
    const int s = static_cast<int>(i % STAGES);
    if (i >= STAGES) wait(empty + s, static_cast<uint32_t>((i / STAGES - 1) & 1));
    arrive_expect_tx(full + s, bytes);
    return full + s;
  }

  // consumer: wait until iteration i's stage has arrived
  __device__ __forceinline__ void wait_full(long long i) {
    wait(full + i % STAGES, static_cast<uint32_t>((i / STAGES) & 1));
  }

  // consumer warp, all lanes: iteration i's stage is no longer read. The
  // generic proxy's reads of the stage are ordered before the async proxy's
  // refill by a proxy fence (without it, a refill has been measured to
  // overwrite a stage before all of a warp's reads had returned)
  __device__ __forceinline__ void release(long long i) {
    fence_proxy_async();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) arrive(empty + i % STAGES);
  }
};

// The contiguous range of units [first, first + count) of block `b` when
// `per_block` units go to every block and one more to the first `extra`
// (bulk_ring.block_range in Python).
__device__ __forceinline__ void block_range(long long b, long long per_block, long long extra,
                                            long long* first, long long* count) {
  *first = b * per_block + (b < extra ? b : extra);
  *count = per_block + (b < extra ? 1 : 0);
}

}  // namespace bulk_ring
