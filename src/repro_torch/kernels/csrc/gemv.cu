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
// Design: a block of 8 warps owns 32 rows, 4 per warp. x is staged in
// shared memory as f32, in chunks of up to 8192 values, once per block. Each
// lane reads its rows with 16-byte loads (4 f32 or 8 bf16 per load, the
// 4 rows' loads interleaved so 64 bytes are in flight per lane), neighbouring
// lanes on neighbouring addresses, and sums in f32; each row ends in a
// fixed-order warp shuffle tree, and lane 0 writes it. A whose rows are not
// all 16-byte aligned (K * size % 16 != 0 or an unaligned base) takes the
// same loop with one element per lane and step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, typename X>
int launch(const void* A, const void* x, void* y, int M, int K, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = K % V == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem = sizeof(float) * (size_t)(K < kChunk ? (K < 1 ? 1 : K) : kChunk);
  const T* a = static_cast<const T*>(A);
  const X* xx = static_cast<const X*>(x);
  T* yy = static_cast<T*>(y);
  if (vec)
    gemv_kernel<T, X, true><<<grid, kThreads, smem, st>>>(a, xx, yy, M, K);
  else
    gemv_kernel<T, X, false><<<grid, kThreads, smem, st>>>(a, xx, yy, M, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A: contiguous (M, K); x: contiguous (K,); y: (M,) in A's type.
// a_dtype, x_dtype: 1 f32, 2 bf16.
extern "C" int gemv(const void* A, const void* x, void* y, int M, int K,
                    int a_dtype, int x_dtype, void* stream) {
  if (M < 1 || K < 0 || M > 2147483647 - 2 * kRowsPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_dtype == 1 && x_dtype == 1) return launch<float, float>(A, x, y, M, K, st);
  if (a_dtype == 1 && x_dtype == 2) return launch<float, __nv_bfloat16>(A, x, y, M, K, st);
  if (a_dtype == 2 && x_dtype == 1) return launch<__nv_bfloat16, float>(A, x, y, M, K, st);
  if (a_dtype == 2 && x_dtype == 2) return launch<__nv_bfloat16, __nv_bfloat16>(A, x, y, M, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
