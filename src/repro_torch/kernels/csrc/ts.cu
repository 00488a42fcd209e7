// Sliding-window distance (PrIM TS, the bank-local phase): the f32
// squared euclidean distance of a query (m,) to each of the n - m + 1
// windows of a series (n,), out[i] = sum over j = 0 .. m-1, in that order,
// of (f32(series[i + j]) - f32(query[j]))^2.
//
// Replaces: src/repro/kernels/ts.py, ts_dists_tiled (body _ts_kernel), and
// the wrapper's padding of the series to whole 512-element blocks
// (src/repro/kernels/ops.py, ts_min). The TPU kernel reads the next block
// a second time, through a clamped second BlockSpec, as the halo of the
// windows that run past its own block; here each block stages its tile and
// the m - 1 elements after it in shared memory, masking the end of the
// series itself. It writes only the n - m + 1 windows that exist, so no
// entry is left for the caller to mask.
//
// Bound on the H100: bytes at PrIM's m = 8 (4 bytes read and 4 written per
// window, 3m f32 operations per window); operations only for m in the
// hundreds.
//
// Design: a block of 256 threads owns 1024 consecutive windows, 4 a
// thread (threads side by side on neighbouring windows, so the shared
// reads of a warp are conflict-free and the query value a broadcast). The
// series is cast to f32 as it is staged, the query likewise. Each window
// keeps its own sum, over j in order, with __fsub_rn, __fmul_rn and
// __fadd_rn: nvcc would otherwise contract d * d + acc into one FFMA,
// which rounds once where the plain version (kernels/ref.py, ts_dists)
// rounds twice. So the distances equal the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kWin = kThreads * kPerThread;   // windows per block
constexpr int kMaxM = 512;                    // kernels/ts.py MAX_M

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }

template <typename S, typename Q>
__global__ void __launch_bounds__(kThreads)
ts_kernel(const S* __restrict__ series, long long n, const Q* __restrict__ query, int m,
          float* __restrict__ out) {
  __shared__ float seg[kWin + kMaxM - 1];
  __shared__ float q[kMaxM];
  const long long base = (long long)blockIdx.x * kWin;
  const long long nwin = n - m + 1;
  const int len = kWin + m - 1;
  for (int j = threadIdx.x; j < len; j += kThreads) {
    const long long p = base + j;
    seg[j] = p < n ? to_f32(series[p]) : 0.f;
  }
  for (int j = threadIdx.x; j < m; j += kThreads) q[j] = to_f32(query[j]);
  __syncthreads();
  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.f;
  for (int j = 0; j < m; ++j) {
    const float qj = q[j];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const float d = __fsub_rn(seg[threadIdx.x + k * kThreads + j], qj);
      acc[k] = __fadd_rn(acc[k], __fmul_rn(d, d));
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long w = base + threadIdx.x + k * kThreads;
    if (w < nwin) out[w] = acc[k];
  }
}

template <typename S, typename Q>
int launch(const void* series, long long n, const void* query, int m, float* out,
           cudaStream_t st) {
  const long long nwin = n - m + 1;
  const long long blocks = (nwin + kWin - 1) / kWin;
  ts_kernel<S, Q><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const S*>(series), n, static_cast<const Q*>(query), m, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// series: contiguous (n,); query: contiguous (m,), 1 <= m <= min(n, kMaxM);
// s_dtype, q_dtype: 0 int32, 1 f32. out: f32 (n - m + 1,).
extern "C" int ts_dists(const void* series, long long n, int s_dtype, const void* query, int m,
                        int q_dtype, void* out, void* stream) {
  if (m < 1 || m > kMaxM || m > n || s_dtype < 0 || s_dtype > 1 || q_dtype < 0 || q_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (2 * s_dtype + q_dtype) {
    case 0: return launch<int, int>(series, n, query, m, o, st);
    case 1: return launch<int, float>(series, n, query, m, o, st);
    case 2: return launch<float, int>(series, n, query, m, o, st);
    default: return launch<float, float>(series, n, query, m, o, st);
  }
}
