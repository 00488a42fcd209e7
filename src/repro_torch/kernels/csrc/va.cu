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
// Design: a grid-stride loop over 16-byte vectors (4 int32/f32 or 8 bf16 a
// load), so each thread keeps two 16-byte loads in flight per step; the
// n % (16 / sizeof(T)) tail, and whole arrays whose pointers are not 16-byte
// aligned, take a scalar loop. int32 adds are done unsigned (two's-complement
// wrap, as XLA's int32 add; signed overflow is undefined in C++). bf16 adds
// in f32 and rounds once to nearest even, which is what the plain version
// (and XLA) computes, bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

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
int launch(const void* a, const void* b, void* o, long long n, cudaStream_t st) {
  using T = typename Op::T;
  constexpr int V = 16 / sizeof(T);
  const bool vectorized = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                            reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  const long long work = vectorized ? (n + V - 1) / V : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks : want));
  va_kernel<Op><<<blocks, kThreads, 0, st>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                            static_cast<T*>(o), n, vectorized ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a, b, o: contiguous (n,) arrays of one type. dtype: 0 int32, 1 f32, 2 bf16.
extern "C" int va(const void* a, const void* b, void* o, long long n, int dtype,
                  void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<I32>(a, b, o, n, st);
    case 1: return launch<F32>(a, b, o, n, st);
    case 2: return launch<BF16>(a, b, o, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
