// Histogram of an (n,) array of uint32 values (PrIM HST-S / HST-L, the
// bank-local phase): int32 counts over `bins` buckets, the bucket of x
// being (x * bins) >> 12 in uint32 arithmetic (the product wraps, as the
// reference's does). A bucket >= bins counts nowhere: the reference's
// one-hot compare and its scatter both drop it.
//
// Replaces: src/repro/kernels/histogram.py, histogram_2d (body _hst_kernel),
// and the wrapper's padding with zeros that it then takes out of bin 0
// (src/repro/kernels/ops.py, histogram): the kernel masks its own tail.
// The TPU kernel keeps the counts in one VMEM block across an in-order
// grid and bins by a one-hot compare, since its vector unit cannot scatter;
// on the H100 blocks run in parallel and shared memory takes atomics.
//
// Bound on the H100: bytes (4 an element read once; the counts are tiny).
//
// Design: each block keeps a private histogram of all `bins` counters in
// shared memory (bins x 4 bytes, at most 32 KB), walks its grid-stride
// share of the input in 16-byte vectors (a scalar loop for the tail and
// unaligned arrays) counting with shared-memory atomics, then adds each
// non-zero counter to the output with one global atomicAdd. The counts are
// integers, so the order of the atomics cannot change the result: every
// launch gives the same counts. The output is zeroed on the stream first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocks = 132 * 4;
constexpr int kShift = 12;
constexpr int kMaxBins = 8192;   // kernels/histogram.py MAX_BINS

__device__ __forceinline__ void count(unsigned x, unsigned bins, int* local) {
  const unsigned idx = (x * bins) >> kShift;
  if (idx < bins) atomicAdd(local + idx, 1);
}

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const unsigned* __restrict__ x, long long n, int vectorized, unsigned bins,
                 int* __restrict__ counts) {
  extern __shared__ int local[];
  for (unsigned b = threadIdx.x; b < bins; b += kThreads) local[b] = 0;
  __syncthreads();
  const long long nvec = vectorized ? n / 4 : 0;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  for (long long i = tid; i < nvec; i += stride) {
    const uint4 w = __ldcs(x4 + i);
    count(w.x, bins, local);
    count(w.y, bins, local);
    count(w.z, bins, local);
    count(w.w, bins, local);
  }
  for (long long i = nvec * 4 + tid; i < n; i += stride) count(x[i], bins, local);
  __syncthreads();
  for (unsigned b = threadIdx.x; b < bins; b += kThreads) {
    const int c = local[b];
    if (c) atomicAdd(counts + b, c);
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: contiguous (n,) of 32-bit values (uint32, or int32 read as the same
// bits), 1 <= n < 2^31; counts: int32 (bins,), 1 <= bins <= kMaxBins.
extern "C" int histogram(const void* x, long long n, int bins, void* counts, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || bins < 1 || bins > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * bins, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vectorized = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long work = vectorized ? (n + 3) / 4 : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want > kMaxBlocks ? kMaxBlocks : want);
  histogram_kernel<<<blocks, kThreads, sizeof(int) * bins, st>>>(
      static_cast<const unsigned*>(x), n, vectorized ? 1 : 0, static_cast<unsigned>(bins),
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
