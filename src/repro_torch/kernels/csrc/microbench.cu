// The Fig. 2 microbenchmark: `k` dependent adds of i + 1 (i = 0 .. k-1) on
// each element of an (n,) int32 or f32 array, read once and written once.
// Sweeping k sweeps the operational intensity (k adds per 8 bytes moved).
//
// Replaces: src/repro/kernels/microbench.py, stream_ops (body
// _stream_kernel), and the wrapper's padding to whole (256, 128) tiles
// (src/repro/kernels/ops.py, stream_ops): the kernel masks its own tail.
//
// Bound on the H100: bytes at small k, operations at large k. The two
// bounds cross where k adds per element take as long as moving 8 bytes per
// element: k = 8 * (add rate) / (HBM bandwidth). With the adds on two
// pipes (below) the rate is the SM's issue limit, 128 lanes a clock, and
// the bounds cross at k = 80; the measured knee lies between k = 64 and
// 128 (PERF.md; chip_smoke.py computes both bounds for every k it runs).
//
// Design: a grid-stride loop over 16-byte vectors, 4 elements per thread
// and step, whose 4 chains are interleaved so each thread has 4 independent
// adds in flight; the n % 4 tail (or a whole unaligned array) takes a
// scalar loop. The hard part is to make the card do the work at all. The
// chain y + 1 + 2 + ... + k is one add of a constant to a compiler, and
// both nvcc and ptxas fold or fuse it: with the adds written as PTX
// immediates ptxas folded the whole chain, and with addends it cannot see
// (kernel parameters) it fused each two dependent adds into one 3-input
// IADD3. So for int32 and the k of the sweep (1, 2, 4, ..., 256) each
// step is written in PTX as an add predicated on one of two flags,
// alternating between them. The host always sets both flags, so every add
// executes, but no compiler can prove two neighbouring adds unconditional,
// and so none can fold or fuse them: the SASS holds k predicated adds per
// element (chip_smoke.py phase 2 counts them). ptxas issues them as IADD3
// and VIADD about half and half, so the adds run on two pipes. The adds
// are unsigned, so int32 wraps as XLA's does (signed overflow is undefined
// in C++). f32 adds round after every step (__fadd_rn, no fast-math flag),
// which no compiler may reassociate. Other k take a plain runtime loop
// (right, not tuned).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// One step of the int32 chain on the 4 elements %0..%3, predicated on P.
#define I4(P, c)                                  \
  "@" #P " add.u32 %0, %0, " #c ";\n\t"           \
  "@" #P " add.u32 %1, %1, " #c ";\n\t"           \
  "@" #P " add.u32 %2, %2, " #c ";\n\t"           \
  "@" #P " add.u32 %3, %3, " #c ";\n\t"
#define S2(a, b) I4(p, a) I4(q, b)
#define C1 I4(p, 1)
#define C2 C1 I4(q, 2)
#define C4 C2 S2(3, 4)
#define C8 C4 S2(5, 6) S2(7, 8)
#define C16 C8 S2(9, 10) S2(11, 12) S2(13, 14) S2(15, 16)
#define C32 C16 S2(17, 18) S2(19, 20) S2(21, 22) S2(23, 24) S2(25, 26) \
    S2(27, 28) S2(29, 30) S2(31, 32)
#define C64 C32 S2(33, 34) S2(35, 36) S2(37, 38) S2(39, 40) S2(41, 42) \
    S2(43, 44) S2(45, 46) S2(47, 48) S2(49, 50) S2(51, 52) S2(53, 54)   \
    S2(55, 56) S2(57, 58) S2(59, 60) S2(61, 62) S2(63, 64)
#define C128 C64 S2(65, 66) S2(67, 68) S2(69, 70) S2(71, 72) S2(73, 74) \
    S2(75, 76) S2(77, 78) S2(79, 80) S2(81, 82) S2(83, 84) S2(85, 86)    \
    S2(87, 88) S2(89, 90) S2(91, 92) S2(93, 94) S2(95, 96) S2(97, 98)    \
    S2(99, 100) S2(101, 102) S2(103, 104) S2(105, 106) S2(107, 108)      \
    S2(109, 110) S2(111, 112) S2(113, 114) S2(115, 116) S2(117, 118)     \
    S2(119, 120) S2(121, 122) S2(123, 124) S2(125, 126) S2(127, 128)
#define C256 C128 S2(129, 130) S2(131, 132) S2(133, 134) S2(135, 136)        \
    S2(137, 138) S2(139, 140) S2(141, 142) S2(143, 144) S2(145, 146)         \
    S2(147, 148) S2(149, 150) S2(151, 152) S2(153, 154) S2(155, 156)         \
    S2(157, 158) S2(159, 160) S2(161, 162) S2(163, 164) S2(165, 166)         \
    S2(167, 168) S2(169, 170) S2(171, 172) S2(173, 174) S2(175, 176)         \
    S2(177, 178) S2(179, 180) S2(181, 182) S2(183, 184) S2(185, 186)         \
    S2(187, 188) S2(189, 190) S2(191, 192) S2(193, 194) S2(195, 196)         \
    S2(197, 198) S2(199, 200) S2(201, 202) S2(203, 204) S2(205, 206)         \
    S2(207, 208) S2(209, 210) S2(211, 212) S2(213, 214) S2(215, 216)         \
    S2(217, 218) S2(219, 220) S2(221, 222) S2(223, 224) S2(225, 226)         \
    S2(227, 228) S2(229, 230) S2(231, 232) S2(233, 234) S2(235, 236)         \
    S2(237, 238) S2(239, 240) S2(241, 242) S2(243, 244) S2(245, 246)         \
    S2(247, 248) S2(249, 250) S2(251, 252) S2(253, 254) S2(255, 256)

#define INT_CHAIN(BODY)                                                   \
  asm volatile("{\n\t.reg .pred p, q;\n\t"                                \
               "setp.ne.u32 p, %4, 0;\n\tsetp.ne.u32 q, %5, 0;\n\t" BODY  \
               "}"                                                        \
               : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)               \
               : "r"(fp), "r"(fq))

template <int K> __device__ __forceinline__ void int_chain(uint4& v, unsigned fp, unsigned fq);
template <> __device__ __forceinline__ void int_chain<0>(uint4&, unsigned, unsigned) {}
template <> __device__ __forceinline__ void int_chain<1>(uint4& v, unsigned fp, unsigned fq) { INT_CHAIN(C1); }
template <> __device__ __forceinline__ void int_chain<2>(uint4& v, unsigned fp, unsigned fq) { INT_CHAIN(C2); }
template <> __device__ __forceinline__ void int_chain<4>(uint4& v, unsigned fp, unsigned fq) { INT_CHAIN(C4); }
template <> __device__ __forceinline__ void int_chain<8>(uint4& v, unsigned fp, unsigned fq) { INT_CHAIN(C8); }
template <> __device__ __forceinline__ void int_chain<16>(uint4& v, unsigned fp, unsigned fq) { INT_CHAIN(C16); }
template <> __device__ __forceinline__ void int_chain<32>(uint4& v, unsigned fp, unsigned fq) { INT_CHAIN(C32); }
template <> __device__ __forceinline__ void int_chain<64>(uint4& v, unsigned fp, unsigned fq) { INT_CHAIN(C64); }
template <> __device__ __forceinline__ void int_chain<128>(uint4& v, unsigned fp, unsigned fq) { INT_CHAIN(C128); }
template <> __device__ __forceinline__ void int_chain<256>(uint4& v, unsigned fp, unsigned fq) { INT_CHAIN(C256); }

template <int K>
__device__ __forceinline__ void f32_chain(float4& v) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float c = static_cast<float>(j + 1);
    v.x = __fadd_rn(v.x, c);
    v.y = __fadd_rn(v.y, c);
    v.z = __fadd_rn(v.z, c);
    v.w = __fadd_rn(v.w, c);
  }
}

// the scalar tail (a few elements, so the compiler may fold it) and the
// runtime-k kernel; kept rolled so the k = 128 instance's SASS holds the
// chain's adds alone
template <typename T>
__device__ __forceinline__ T scalar_chain(T y, int k) {
#pragma unroll 1
  for (int j = 0; j < k; ++j) y = y + static_cast<T>(j + 1);
  return y;
}
__device__ __forceinline__ float scalar_chain(float y, int k) {
#pragma unroll 1
  for (int j = 0; j < k; ++j) y = __fadd_rn(y, static_cast<float>(j + 1));
  return y;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
stream_i32(const unsigned* __restrict__ x, unsigned* __restrict__ y, long long n,
           int vectorized, unsigned fp, unsigned fq) {
  const long long nvec = vectorized ? n / 4 : 0;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* y4 = reinterpret_cast<uint4*>(y);
  for (long long i = tid; i < nvec; i += stride) {
    uint4 v = __ldcs(x4 + i);
    int_chain<K>(v, fp, fq);
    __stcs(y4 + i, v);
  }
  for (long long i = nvec * 4 + tid; i < n; i += stride) y[i] = scalar_chain(x[i], K);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
stream_f32(const float* __restrict__ x, float* __restrict__ y, long long n, int vectorized) {
  const long long nvec = vectorized ? n / 4 : 0;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (long long i = tid; i < nvec; i += stride) {
    float4 v = __ldcs(x4 + i);
    f32_chain<K>(v);
    __stcs(y4 + i, v);
  }
  for (long long i = nvec * 4 + tid; i < n; i += stride) y[i] = scalar_chain(x[i], K);
}

// any other k: a runtime loop of adds of a loop counter
template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_any(const T* __restrict__ x, T* __restrict__ y, long long n, int k) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    y[i] = scalar_chain(x[i], k);
}

int grid_for(long long work) {
  const long long want = (work + kThreads - 1) / kThreads;
  return static_cast<int>(want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks : want));
}

template <int K>
void launch_k(const void* x, void* y, long long n, int is_f32, bool vec, cudaStream_t st) {
  const int grid = grid_for(vec ? (n + 3) / 4 : n);
  if (is_f32)
    stream_f32<K><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), static_cast<float*>(y), n, vec);
  else  // both flags 1: every predicated add executes
    stream_i32<K><<<grid, kThreads, 0, st>>>(static_cast<const unsigned*>(x), static_cast<unsigned*>(y), n, vec, 1u, 1u);
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: contiguous (n,) of one type; dtype: 0 int32, 1 f32; ops_per_elem >= 0.
extern "C" int stream_ops(const void* x, void* y, long long n, int ops_per_elem,
                          int dtype, void* stream) {
  if (n < 0 || ops_per_elem < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  switch (ops_per_elem) {
    case 0: launch_k<0>(x, y, n, dtype, vec, st); break;
    case 1: launch_k<1>(x, y, n, dtype, vec, st); break;
    case 2: launch_k<2>(x, y, n, dtype, vec, st); break;
    case 4: launch_k<4>(x, y, n, dtype, vec, st); break;
    case 8: launch_k<8>(x, y, n, dtype, vec, st); break;
    case 16: launch_k<16>(x, y, n, dtype, vec, st); break;
    case 32: launch_k<32>(x, y, n, dtype, vec, st); break;
    case 64: launch_k<64>(x, y, n, dtype, vec, st); break;
    case 128: launch_k<128>(x, y, n, dtype, vec, st); break;
    case 256: launch_k<256>(x, y, n, dtype, vec, st); break;
    default:
      if (dtype == 1)
        stream_any<float><<<grid_for(n), kThreads, 0, st>>>(
            static_cast<const float*>(x), static_cast<float*>(y), n, ops_per_elem);
      else
        stream_any<unsigned><<<grid_for(n), kThreads, 0, st>>>(
            static_cast<const unsigned*>(x), static_cast<unsigned*>(y), n, ops_per_elem);
  }
  return static_cast<int>(cudaGetLastError());
}
