// Sum of every element of an (n,) array into one value (PrIM RED, the
// bank-local phase; SCAN-RSS's first phase): into an f32 (the f32 route),
// or, for int32, into an int32 that wraps at 2^32 (the int32 route).
//
// Replaces: src/repro/kernels/reduction.py, reduce_2d (body _red_kernel),
// and the wrapper's padding to whole (512, 128) tiles
// (src/repro/kernels/ops.py, reduction). The TPU kernel carries its sum in a
// (1, 1) output block that stays resident across a grid that runs in order;
// on the H100 blocks run in parallel and in no order, so nothing can carry
// between them. The int32 route computes what the reference's PrIM RED
// computes with x64 off (src/repro/prim/red.py: jnp.sum of int32 data, which
// wraps): f32 is exact only below 2^24, so the f32 route would round it.
//
// Bound on the H100: bytes. One add per element read (4 or 2 bytes), far
// below the card's ridge: the kernel can only be as fast as reading x once.
//
// Design: two passes and no atomics. Pass 1 runs a fixed number of blocks
// for a given n; each thread sums its grid-stride share of 16-byte vectors
// in the accumulator type (on the f32 route elements are cast to f32 first,
// as the reference's `sum(x.astype(f32))`; on the int32 route the adds are
// unsigned 32-bit, so they wrap as int32 does), then the block reduces its
// 256 threads with warp shuffles in a fixed tree and writes one partial.
// Pass 2, one block, reduces the partials in the same fixed order and
// writes the 0-dim result. Every add happens in an order fixed by n alone,
// so two launches on the same data give the same bits (on the int32 route
// any order gives them: addition mod 2^32 is associative). The result stays
// on the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;   // the wrapper's scratch holds this many partials

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// the accumulator of each element type: f32, or unsigned for the int32 route
template <typename T> struct Acc { using type = float; };
template <> struct Acc<unsigned> { using type = unsigned; };
__device__ __forceinline__ unsigned to_acc(unsigned x) { return x; }
template <typename T> __device__ __forceinline__ float to_acc(T x) { return to_f32(x); }

// sum of the elements packed in one 32-bit word, in element order; the
// int32 route (T = unsigned) adds the word as it is, wrapping
__device__ __forceinline__ unsigned word_sum(unsigned acc, unsigned w, unsigned) {
  return acc + w;
}
__device__ __forceinline__ float word_sum(float acc, unsigned w, float) {
  return acc + __uint_as_float(w);
}
__device__ __forceinline__ float word_sum(float acc, unsigned w, int) {
  return acc + static_cast<float>(static_cast<int>(w));
}
__device__ __forceinline__ float word_sum(float acc, unsigned w, __nv_bfloat16) {
  acc += __uint_as_float(w << 16);
  return acc + __uint_as_float(w & 0xffff0000u);
}

// all 256 threads call it; thread 0 gets the block's sum
template <typename A>
__device__ __forceinline__ A block_sum(A v) {
  __shared__ A warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = A(0);
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : A(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

template <typename T, typename A = typename Acc<T>::type>
__global__ void __launch_bounds__(kThreads)
partial_sums(const T* __restrict__ x, long long n, int vectorized,
             A* __restrict__ partials) {
  constexpr int V = 16 / sizeof(T);
  const long long nvec = vectorized ? n / V : 0;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  A acc = A(0);
  for (long long i = tid; i < nvec; i += stride) {
    const uint4 w = __ldcs(x4 + i);
    acc = word_sum(acc, w.x, T());
    acc = word_sum(acc, w.y, T());
    acc = word_sum(acc, w.z, T());
    acc = word_sum(acc, w.w, T());
  }
  for (long long i = nvec * V + tid; i < n; i += stride) acc += to_acc(x[i]);
  const A s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

template <typename A>
__global__ void __launch_bounds__(kThreads)
final_sum(const A* __restrict__ partials, int n, A* __restrict__ out) {
  A acc = A(0);
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  const A s = block_sum(acc);
  if (threadIdx.x == 0) *out = s;
}

template <typename T, typename A = typename Acc<T>::type>
int launch(const void* x, long long n, void* partials, void* out, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vectorized = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long work = vectorized ? (n + V - 1) / V : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks : want));
  A* p = static_cast<A*>(partials);
  partial_sums<T><<<blocks, kThreads, 0, st>>>(static_cast<const T*>(x), n,
                                              vectorized ? 1 : 0, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  final_sum<A><<<1, kThreads, 0, st>>>(p, blocks, static_cast<A*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int reduction_max_blocks() { return kMaxBlocks; }

// x: contiguous (n,); dtype: 0 int32, 1 f32, 2 bf16. acc: 0 the f32 route
// (partials and out f32), 1 the int32 route (dtype int32 only; partials and
// out int32, wrapping). partials: 4-byte scratch of reduction_max_blocks()
// values; out: one value on the device.
extern "C" int reduction(const void* x, long long n, int dtype, int acc, void* partials,
                         void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (acc == 1)
    return dtype == 0 ? launch<unsigned>(x, n, partials, out, st)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (acc != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch<int>(x, n, partials, out, st);
    case 1: return launch<float>(x, n, partials, out, st);
    case 2: return launch<__nv_bfloat16>(x, n, partials, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
