// Vector addition o = a + b over n elements (PrIM VA, the paper's simplest
// memory-bound workload).
//
// Replaces: src/repro/kernels/va.py, va_2d (body _va_kernel), and with it the
// wrapper's padding to whole (256, 128) tiles (src/repro/kernels/ops.py, va):
// this kernel takes the flat (n,) arrays and masks its own ragged tail, so
// nothing is copied.
//
// Bound on the H100: bytes. One add per 12 bytes (int32/f32) or 6 bytes
// (bf16) moved is far below the card's ridge, so the kernel can only be as
// fast as HBM: read a and b once, write o once.
//
// Two routes, chosen by the launcher (kernels/va.py, `plan`) from the
// pointers:
// - ring (every pointer 16-byte aligned): each block streams a contiguous
//   range of whole 8 KB stages of a and of b through a 4-stage ring of bulk
//   copies (bulk_ring.cuh): one producer thread keeps the block's stages in
//   flight, 8 consumer warps add a stage's words from shared memory and
//   write o through two shared buffers per warp and bulk stores (no slower
//   than 16-byte st.global from registers: PERF.md, ring_sweep.py, which
//   builds that variant). The grid is not persistent: 128 short ranges
//   per SM, cut by the launcher, so that the hardware's block scheduler
//   gives an SM that draws more of HBM's bandwidth more ranges (with one
//   range per SM, the first blocks end at two thirds of the kernel's time:
//   PERF.md, ring_sweep.py). The last block also does the tail past the
//   last whole stage with plain loads.
// - stride (the first kernel, kept for unaligned views): a grid-stride
//   loop over 16-byte vectors, two loads in flight per thread and step;
//   arrays whose pointers are not 16-byte aligned take its scalar loop.
// int32 adds are done unsigned (two's-complement wrap, as XLA's int32 add;
// signed overflow is undefined in C++). bf16 adds in f32 and rounds once to
// nearest even, which is what the plain version (and XLA) computes, bit for
// bit; every route does the same adds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

constexpr int kThreads = 256;

// ring route: kStageBytes of a and of b per stage (kernels/va.py mirrors
// these three)
constexpr int kStages = 4;
constexpr int kStageBytes = 8192;
constexpr int kConsumerWarps = 8;
constexpr int kRingThreads = (kConsumerWarps + 1) * 32;
constexpr int kWarpBytes = kStageBytes / kConsumerWarps;   // a warp's slice
constexpr int kLaneVecs = kWarpBytes / 16 / 32;            // uint4 per lane
static_assert(kLaneVecs * 16 * 32 == kWarpBytes, "slice is not whole vectors");

__device__ __forceinline__ unsigned add_word_i32(unsigned a, unsigned b) {
  return a + b;
}
__device__ __forceinline__ unsigned add_word_f32(unsigned a, unsigned b) {
  return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
}
__device__ __forceinline__ unsigned add_word_bf16(unsigned a, unsigned b) {
  // two bf16 per 32-bit word: widen each to f32 (a shift), add, round once
  const float lo = __fadd_rn(__uint_as_float(a << 16), __uint_as_float(b << 16));
  const float hi = __fadd_rn(__uint_as_float(a & 0xffff0000u),
                             __uint_as_float(b & 0xffff0000u));
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&r);
}

struct I32 {
  using T = unsigned;
  static __device__ __forceinline__ unsigned word(unsigned a, unsigned b) { return add_word_i32(a, b); }
  static __device__ __forceinline__ T one(T a, T b) { return a + b; }
};
struct F32 {
  using T = float;
  static __device__ __forceinline__ unsigned word(unsigned a, unsigned b) { return add_word_f32(a, b); }
  static __device__ __forceinline__ T one(T a, T b) { return __fadd_rn(a, b); }
};
struct BF16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ unsigned word(unsigned a, unsigned b) { return add_word_bf16(a, b); }
  static __device__ __forceinline__ T one(T a, T b) {
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
};

template <typename Op>
__global__ void __launch_bounds__(kThreads)
va_kernel(const typename Op::T* __restrict__ a, const typename Op::T* __restrict__ b,
          typename Op::T* __restrict__ o, long long n, int vectorized) {
  using T = typename Op::T;
  constexpr int V = 16 / sizeof(T);
  const long long nvec = vectorized ? n / V : 0;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  uint4* o4 = reinterpret_cast<uint4*>(o);
  for (long long i = tid; i < nvec; i += stride) {
    const uint4 x = __ldcs(a4 + i), y = __ldcs(b4 + i);
    uint4 r;
    r.x = Op::word(x.x, y.x);
    r.y = Op::word(x.y, y.y);
    r.z = Op::word(x.z, y.z);
    r.w = Op::word(x.w, y.w);
    __stcs(o4 + i, r);
  }
  for (long long i = nvec * V + tid; i < n; i += stride) o[i] = Op::one(a[i], b[i]);
}

template <typename Op>
__device__ __forceinline__ uint4 add_vec(const uint4& x, const uint4& y) {
  uint4 r;
  r.x = Op::word(x.x, y.x);
  r.y = Op::word(x.y, y.y);
  r.z = Op::word(x.z, y.z);
  r.w = Op::word(x.w, y.w);
  return r;
}

// Block b streams whole stages [first, first + count) (bulk_ring::block_range
// of per_block, extra); the last block then adds elements [units * E, n).
template <typename Op>
__global__ void __launch_bounds__(kRingThreads)
va_ring_kernel(const typename Op::T* __restrict__ a, const typename Op::T* __restrict__ b,
               typename Op::T* __restrict__ o, long long n, long long units,
               long long per_block, long long extra) {
  using T = typename Op::T;
  constexpr int E = kStageBytes / sizeof(T);   // elements of a stage
  extern __shared__ __align__(128) unsigned char smem[];
  bulk_ring::Ring<kStages> ring(smem);
  unsigned char* stages = smem + bulk_ring::kBarrierBytes;   // a, then b
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long first, count;
  bulk_ring::block_range(blockIdx.x, per_block, extra, &first, &count);

  if (warp == kConsumerWarps) {   // the producer warp
    if (lane == 0) ring.init_barriers(kConsumerWarps);
    __syncwarp();
    bulk_ring::named_arrive(1, kRingThreads);
    if (lane == 0) {
      for (long long i = 0; i < count; ++i) {
        uint64_t* full = ring.acquire(i, 2 * kStageBytes);
        unsigned char* st = stages + (i % kStages) * 2 * kStageBytes;
        const long long off = (first + i) * E;
        bulk_ring::load(st, a + off, kStageBytes, full);
        bulk_ring::load(st + kStageBytes, b + off, kStageBytes, full);
      }
    }
    return;
  }

  bulk_ring::named_sync(1, kRingThreads);   // the barriers are initialised
  uint4* out_buf = reinterpret_cast<uint4*>(stages + kStages * 2 * kStageBytes) +
                   warp * 2 * (kWarpBytes / 16);   // two buffers per warp
  for (long long i = 0; i < count; ++i) {
    ring.wait_full(i);
    const uint4* sa = reinterpret_cast<const uint4*>(stages + (i % kStages) * 2 * kStageBytes) +
                      warp * (kWarpBytes / 16);
    const uint4* sb = sa + kStageBytes / 16;
    uint4 r[kLaneVecs];
#pragma unroll
    for (int j = 0; j < kLaneVecs; ++j) r[j] = add_vec<Op>(sa[j * 32 + lane], sb[j * 32 + lane]);
    ring.release(i);
    T* dst = o + (first + i) * E + warp * (kWarpBytes / sizeof(T));
    uint4* buf = out_buf + (i & 1) * (kWarpBytes / 16);
    if (lane == 0) bulk_ring::store_wait_read<1>();   // buf's store of i - 2
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kLaneVecs; ++j) buf[j * 32 + lane] = r[j];
    bulk_ring::fence_proxy_async();
    __syncwarp();
    if (lane == 0) bulk_ring::store(dst, buf, kWarpBytes);
  }
  if (lane == 0) bulk_ring::store_wait_all();
  if (blockIdx.x == gridDim.x - 1)
    for (long long k = units * E + threadIdx.x; k < n; k += kConsumerWarps * 32)
      o[k] = Op::one(a[k], b[k]);
}

template <typename Op>
int launch_stride(const void* a, const void* b, void* o, long long n, int blocks,
                  cudaStream_t st) {
  using T = typename Op::T;
  const bool vectorized = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                            reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  va_kernel<Op><<<blocks, kThreads, 0, st>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                            static_cast<T*>(o), n, vectorized ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename Op>
int launch_ring(const void* a, const void* b, void* o, long long n, int blocks,
                long long per_block, long long extra, cudaStream_t st) {
  using T = typename Op::T;
  constexpr int E = kStageBytes / sizeof(T);
  constexpr int smem = bulk_ring::kBarrierBytes + kStages * 2 * kStageBytes +
                       kConsumerWarps * 2 * kWarpBytes;
  static bool opted_in = false;   // once, so that no launch under capture sets it
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(va_ring_kernel<Op>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  if (((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(o)) & 15) != 0 ||
      (long long)blocks * per_block + extra != n / E || (extra > 0 && extra >= blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  va_ring_kernel<Op><<<blocks, kRingThreads, smem, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(o), n, n / E,
      per_block, extra);
  return static_cast<int>(cudaGetLastError());
}

template <typename Op>
int launch(const void* a, const void* b, void* o, long long n, int route, int blocks,
           long long per_block, long long extra, cudaStream_t st) {
  switch (route) {
    case 0: return launch_stride<Op>(a, b, o, n, blocks, st);
    case 1: return launch_ring<Op>(a, b, o, n, blocks, per_block, extra, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a, b, o: contiguous (n,) arrays of one type. dtype: 0 int32, 1 f32, 2 bf16.
// route: 0 stride, 1 ring; blocks: the grid; per_block, extra:
// the ring's cut of the n / (kStageBytes / size) whole stages over the blocks.
extern "C" int va(const void* a, const void* b, void* o, long long n, int dtype, int route,
                  int blocks, long long per_block, long long extra, void* stream) {
  if (n < 0 || blocks < 1 || per_block < 0 || extra < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<I32>(a, b, o, n, route, blocks, per_block, extra, st);
    case 1: return launch<F32>(a, b, o, n, route, blocks, per_block, extra, st);
    case 2: return launch<BF16>(a, b, o, n, route, blocks, per_block, extra, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
