// Matrix-vector product y = A x, A (M, K) row-major, x (K,), accumulated in
// f32, y in A's type (PrIM GEMV; one bank's shard of a decode GEMV).
//
// Replaces: src/repro/kernels/gemv.py, gemv_tiled (body _gemv_kernel), and
// the wrapper's padding to (256, 512) tiles and its cast of the f32 result
// to A's type (src/repro/kernels/ops.py, gemv). The TPU kernel keeps a
// (256, 1) f32 output block resident across the K grid axis, which runs in
// order; here one warp owns whole rows, so no sum crosses blocks.
//
// Bound on the H100: bytes. 2 flops per element of A against 4 or 2 bytes
// of A read once: far below the ridge, so the kernel can only be as fast as
// streaming A from HBM.
//
// Two routes, chosen by the launcher (kernels/gemv.py, `plan`):
// - ring (A 16-byte aligned, K * size % 16 == 0, x fits in shared memory as
//   f32): a persistent grid, one block per SM, owns a contiguous range of
//   rows and streams it through a 4-stage ring of bulk copies
//   (bulk_ring.cuh). A stage is 4 rows by kc columns, at most 16 KB (the
//   launcher's STAGE_CAP): rows of up to 4 KB are contiguous in A and a
//   stage of them arrives by one bulk copy; longer rows are cut into
//   kc-column chunks, one copy per row (at the path's shapes, 8 KB rows in
//   two chunks). x is converted to f32 into shared memory once per block by
//   the 4 consumer warps while the producer's first copies are in flight
//   (no barrier in front of them). Warp w takes row w of each stage: 16-byte
//   ld.shared of A and of x, lanes on consecutive addresses, an f32 sum per
//   lane carried over the row's chunks.
// - rows (the first kernel, kept for the other A): a block of 8 warps owns 32
//   rows, 4 per warp. x is staged in shared memory as f32, in chunks of up
//   to 8192 values. Each lane reads its rows with 16-byte loads (4 f32 or 8
//   bf16 per load, the 4 rows' loads interleaved so 64 bytes are in flight
//   per lane), neighbouring lanes on neighbouring addresses; A whose rows are
//   not all 16-byte aligned takes the same loop with one element per lane
//   and step.
// Either way each row ends in a fixed-order warp shuffle tree and lane 0
// writes it: every launch gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

// ring route (kernels/gemv.py mirrors these)
constexpr int kRingStages = 4;
constexpr int kRingWarps = 4;   // consumer warps; a stage holds a row for each
constexpr int kRingThreads = (kRingWarps + 1) * 32;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kChunk = 8192;   // x values staged at once (32 KB of f32)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// dot of one 16-byte vector of A with the matching x values in shared memory
__device__ __forceinline__ float dot16(float acc, const uint4& a, const float* xs, float) {
  const float4 x = *reinterpret_cast<const float4*>(xs);
  acc = fmaf(__uint_as_float(a.x), x.x, acc);
  acc = fmaf(__uint_as_float(a.y), x.y, acc);
  acc = fmaf(__uint_as_float(a.z), x.z, acc);
  return fmaf(__uint_as_float(a.w), x.w, acc);
}
__device__ __forceinline__ float dot16(float acc, const uint4& a, const float* xs, __nv_bfloat16) {
  const float4 x0 = *reinterpret_cast<const float4*>(xs);
  const float4 x1 = *reinterpret_cast<const float4*>(xs + 4);
  acc = fmaf(__uint_as_float(a.x << 16), x0.x, acc);
  acc = fmaf(__uint_as_float(a.x & 0xffff0000u), x0.y, acc);
  acc = fmaf(__uint_as_float(a.y << 16), x0.z, acc);
  acc = fmaf(__uint_as_float(a.y & 0xffff0000u), x0.w, acc);
  acc = fmaf(__uint_as_float(a.z << 16), x1.x, acc);
  acc = fmaf(__uint_as_float(a.z & 0xffff0000u), x1.y, acc);
  acc = fmaf(__uint_as_float(a.w << 16), x1.z, acc);
  return fmaf(__uint_as_float(a.w & 0xffff0000u), x1.w, acc);
}

template <typename T, typename X, bool VEC>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const T* __restrict__ A, const X* __restrict__ x, T* __restrict__ y,
            int M, int K) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float xs[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  float acc[kRowsPerWarp];
  const T* rows[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    acc[r] = 0.f;
    // rows past M read row M - 1 (a valid address) and are never written
    rows[r] = A + (size_t)min(row0 + r, M - 1) * K;
  }

  for (int c0 = 0; c0 < K; c0 += kChunk) {
    const int kc = min(kChunk, K - c0);
    __syncthreads();   // the previous chunk is consumed
    for (int i = threadIdx.x; i < kc; i += kThreads) xs[i] = to_f32(x[c0 + i]);
    __syncthreads();
    if (VEC) {
      for (int k = lane * V; k < kc; k += 32 * V) {
        uint4 a[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          a[r] = __ldcs(reinterpret_cast<const uint4*>(rows[r] + c0 + k));
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = dot16(acc[r], a[r], xs + k, T());
      }
    } else {
      for (int k = lane; k < kc; k += 32) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r] = fmaf(to_f32(rows[r][c0 + k]), xs[k], acc[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float v = acc[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0 && row0 + r < M) y[row0 + r] = from_f32<T>(v);
  }
}

// 16 bytes of x (4 f32 or 8 bf16) as f32 into shared memory
__device__ __forceinline__ void put_f32(float* xs, const uint4& v, float) {
  *reinterpret_cast<uint4*>(xs) = v;
}
__device__ __forceinline__ void put_f32(float* xs, const uint4& v, __nv_bfloat16) {
  *reinterpret_cast<float4*>(xs) =
      make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                  __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  *reinterpret_cast<float4*>(xs + 4) =
      make_float4(__uint_as_float(v.z << 16), __uint_as_float(v.z & 0xffff0000u),
                  __uint_as_float(v.w << 16), __uint_as_float(v.w & 0xffff0000u));
}

// x (K,) as f32 into xs by `threads` threads, thread `t`. Where x is 16-byte
// aligned and whole vectors, each thread keeps 8 16-byte loads in flight,
// so that one round trip to memory stages x at the shapes of the path.
template <typename X>
__device__ __forceinline__ void stage_x(const X* __restrict__ x, float* xs, int K, int t,
                                        int threads) {
  constexpr int XV = 16 / sizeof(X), B = 8;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0 && K % XV == 0) {
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    const int nv = K / XV;
    for (int v0 = t; v0 < nv; v0 += B * threads) {
      uint4 r[B];
#pragma unroll
      for (int j = 0; j < B; ++j)
        if (v0 + j * threads < nv) r[j] = __ldg(x4 + v0 + j * threads);
#pragma unroll
      for (int j = 0; j < B; ++j)
        if (v0 + j * threads < nv) put_f32(xs + (v0 + j * threads) * XV, r[j], X());
    }
  } else {
#pragma unroll 8
    for (int k = t; k < K; k += threads) xs[k] = to_f32(x[k]);
  }
}

// Block b owns rows [first, first + count) (bulk_ring::block_range of
// per_block, extra), taken kRingWarps rows and kc columns a stage.
template <typename T, typename X>
__global__ void __launch_bounds__(kRingThreads, 1)
gemv_ring_kernel(const T* __restrict__ A, const X* __restrict__ x, T* __restrict__ y, int K,
                 int kc, long long per_block, long long extra) {
  constexpr int V = 16 / sizeof(T);
  constexpr int R = kRingWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  bulk_ring::Ring<kRingStages> ring(smem);
  const int stage_bytes = R * kc * static_cast<int>(sizeof(T));
  unsigned char* stages = smem + bulk_ring::kBarrierBytes;
  float* xs = reinterpret_cast<float*>(stages + kRingStages * stage_bytes);
  const int chunks = (K + kc - 1) / kc;
  long long first, count;
  bulk_ring::block_range(blockIdx.x, per_block, extra, &first, &count);
  const long long iters = (count + R - 1) / R * chunks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == kRingWarps) {   // the producer warp
    if (lane == 0) ring.init_barriers(kRingWarps);
    __syncwarp();
    bulk_ring::named_arrive(1, kRingThreads);
    if (lane == 0) {
      for (long long i = 0; i < iters; ++i) {
        const long long g = i / chunks;
        const int k0 = static_cast<int>(i % chunks) * kc;
        const long long row = first + g * R;
        const int rows = static_cast<int>(min(static_cast<long long>(R), count - g * R));
        const uint32_t row_bytes = static_cast<uint32_t>(min(kc, K - k0) * sizeof(T));
        uint64_t* full = ring.acquire(i, rows * row_bytes);
        unsigned char* st = stages + (i % kRingStages) * stage_bytes;
        if (chunks == 1) {
          bulk_ring::load(st, A + row * K, rows * row_bytes, full);
        } else {
          for (int r = 0; r < rows; ++r)
            bulk_ring::load(st + r * row_bytes, A + (row + r) * K + k0, row_bytes, full);
        }
      }
    }
    return;
  }

  // x as f32, once per block, while the first stages are in flight
  stage_x(x, xs, K, threadIdx.x, kRingWarps * 32);
  bulk_ring::named_sync(1, kRingThreads);   // x staged, barriers initialised
  float acc = 0.f;
  for (long long i = 0; i < iters; ++i) {
    const long long g = i / chunks;
    const int c = static_cast<int>(i % chunks);
    const int k0 = c * kc, kk = min(kc, K - k0);
    const bool mine = warp < count - g * R;   // the stage holds my row
    if (c == 0) acc = 0.f;
    ring.wait_full(i);
    if (mine) {
      const T* a = reinterpret_cast<const T*>(stages + (i % kRingStages) * stage_bytes) + warp * kk;
#pragma unroll 4
      for (int k = lane * V; k < kk; k += 32 * V)
        acc = dot16(acc, *reinterpret_cast<const uint4*>(a + k), xs + k0 + k, T());
    }
    ring.release(i);
    if (mine && c == chunks - 1) {
      float v = acc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) y[first + g * R + warp] = from_f32<T>(v);
    }
  }
}

template <typename T, typename X>
int launch_rows(const void* A, const void* x, void* y, int M, int K, int blocks,
                cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = K % V == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const size_t smem = sizeof(float) * (size_t)(K < kChunk ? (K < 1 ? 1 : K) : kChunk);
  const T* a = static_cast<const T*>(A);
  const X* xx = static_cast<const X*>(x);
  T* yy = static_cast<T*>(y);
  if (blocks != (M + kRowsPerBlock - 1) / kRowsPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec)
    gemv_kernel<T, X, true><<<blocks, kThreads, smem, st>>>(a, xx, yy, M, K);
  else
    gemv_kernel<T, X, false><<<blocks, kThreads, smem, st>>>(a, xx, yy, M, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename X>
int launch_ring(const void* A, const void* x, void* y, int M, int K, int blocks,
                long long per_block, long long extra, int kc, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  static bool opted_in = false;   // once, so that no launch under capture sets it
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(gemv_ring_kernel<T, X>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               bulk_ring::kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const long long smem = bulk_ring::kBarrierBytes +
                         (long long)kRingStages * kRingWarps * kc * sizeof(T) + 4LL * K;
  if ((reinterpret_cast<uintptr_t>(A) & 15) != 0 || K < 1 || K % V != 0 || kc < V ||
      kc % V != 0 || kc > K || smem > bulk_ring::kMaxSmem ||
      (long long)blocks * per_block + extra != M || (extra > 0 && extra >= blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  gemv_ring_kernel<T, X><<<blocks, kRingThreads, static_cast<size_t>(smem), st>>>(
      static_cast<const T*>(A), static_cast<const X*>(x), static_cast<T*>(y), K, kc, per_block,
      extra);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename X>
int launch(const void* A, const void* x, void* y, int M, int K, int route, int blocks,
           long long per_block, long long extra, int kc, cudaStream_t st) {
  switch (route) {
    case 0: return launch_rows<T, X>(A, x, y, M, K, blocks, st);
    case 1: return launch_ring<T, X>(A, x, y, M, K, blocks, per_block, extra, kc, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A: contiguous (M, K); x: contiguous (K,); y: (M,) in A's type.
// a_dtype, x_dtype: 1 f32, 2 bf16. route: 0 rows, 1 ring; blocks: the grid;
// per_block, extra: the ring's cut of the M rows over the blocks; kc: the
// ring's columns a stage (K, or a chunk of it).
extern "C" int gemv(const void* A, const void* x, void* y, int M, int K, int a_dtype,
                    int x_dtype, int route, int blocks, long long per_block, long long extra,
                    int kc, void* stream) {
  if (M < 1 || K < 0 || M > 2147483647 - 2 * kRowsPerBlock || blocks < 1 || per_block < 0 ||
      extra < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_dtype == 1 && x_dtype == 1)
    return launch<float, float>(A, x, y, M, K, route, blocks, per_block, extra, kc, st);
  if (a_dtype == 1 && x_dtype == 2)
    return launch<float, __nv_bfloat16>(A, x, y, M, K, route, blocks, per_block, extra, kc, st);
  if (a_dtype == 2 && x_dtype == 1)
    return launch<__nv_bfloat16, float>(A, x, y, M, K, route, blocks, per_block, extra, kc, st);
  if (a_dtype == 2 && x_dtype == 2)
    return launch<__nv_bfloat16, __nv_bfloat16>(A, x, y, M, K, route, blocks, per_block, extra,
                                                kc, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
