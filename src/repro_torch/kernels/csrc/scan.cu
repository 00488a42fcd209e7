// The two bank-local phases of PrIM SCAN-SSA over a flat (n,) array, in
// 64 x 128 = 8192-element tiles, f32 inside:
//   scan_blocks: the row-major inclusive scan of each tile and its total;
//   add_offsets: each tile's exclusive offset added back, cast to the
//                output type (f32, or int32 by truncation, as XLA's
//                convert). Between the two, the tile totals are scanned
//                on the card in a fixed order (kernels/ref.py,
//                tile_offsets).
//
// Replaces: src/repro/kernels/scan_block.py, scan_blocks (body
// _scan_kernel) and add_offsets (body _add_kernel), with the wrapper's
// padding to whole tiles and its final astype (src/repro/kernels/ops.py,
// scan): the kernels mask the ragged last tile (its missing elements count
// as zeros, as the reference's padding) and add_offsets writes x's type.
//
// Bound on the H100: bytes. scan_blocks reads x once and writes the f32
// scans (8 bytes an element for int32/f32 input); add_offsets reads the
// scans and writes the result (8 bytes). A handful of adds per element is
// far below the card's ridge.
//
// Design: one block of 8 warps per tile; each warp holds 8 of its rows in
// registers, 4 consecutive elements a lane (one 16-byte load per row and
// lane, coalesced). The arithmetic is the plain version's step by step
// (kernels/ref.py, scan_blocks): each row is scanned by doubling (steps
// s = 1, 2, 4, ..., 64: every element from s on adds the one s before
// it), the 64 row totals likewise by warp 0, the row offsets are that scan
// minus the row totals, and every element adds its row's offset. Steps
// s = 1 and 2 mix a lane's own 4 values with its left neighbour's; from
// s = 4 on a step is one shuffle of each value from d = s / 4 lanes left.
// Every add is __fadd_rn / __fsub_rn: no contraction and no reordering, so
// the result equals the plain version bit for bit, on any data.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 64;
constexpr long long kTile = kLanes * kRows;   // 8192
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAddThreads = 256;
constexpr int kMaxAddBlocks = 132 * 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }
// one element of type T from its 32 bits, as f32
__device__ __forceinline__ float word_f32(unsigned w, float) { return __uint_as_float(w); }
__device__ __forceinline__ float word_f32(unsigned w, int) {
  return __int2float_rn(static_cast<int>(w));
}

// 4 elements from p on (p % 4 == 0), as f32; past n they are 0.
template <typename T>
__device__ __forceinline__ float4 load4(const T* __restrict__ x, long long p, long long n,
                                        bool whole) {
  if (whole) {
    const uint4 w = __ldcs(reinterpret_cast<const uint4*>(x + p));
    return make_float4(word_f32(w.x, T()), word_f32(w.y, T()), word_f32(w.z, T()),
                       word_f32(w.w, T()));
  }
  return make_float4(p < n ? to_f32(x[p]) : 0.f, p + 1 < n ? to_f32(x[p + 1]) : 0.f,
                     p + 2 < n ? to_f32(x[p + 2]) : 0.f, p + 3 < n ? to_f32(x[p + 3]) : 0.f);
}

__device__ __forceinline__ void store4(float* __restrict__ o, long long p, long long n,
                                       bool whole, float4 v) {
  if (whole) {
    __stcs(reinterpret_cast<float4*>(o + p), v);
    return;
  }
  if (p < n) o[p] = v.x;
  if (p + 1 < n) o[p + 1] = v.y;
  if (p + 2 < n) o[p + 2] = v.z;
  if (p + 3 < n) o[p + 3] = v.w;
}

// Inclusive scan by doubling of the 128 values of one row, lane l holding
// positions 4l .. 4l+3 in a.x .. a.w. At step s, position p >= s adds
// position p - s (both before the step).
__device__ __forceinline__ float4 row_scan(float4 a, int lane) {
  // s = 1: p - 1 is the lane's previous value, or the left lane's a.w
  float u = __shfl_up_sync(kFull, a.w, 1);
  a = make_float4(lane >= 1 ? __fadd_rn(a.x, u) : a.x, __fadd_rn(a.y, a.x),
                  __fadd_rn(a.z, a.y), __fadd_rn(a.w, a.z));
  // s = 2: p - 2 is two values back in the lane, or the left lane's a.z, a.w
  const float uz = __shfl_up_sync(kFull, a.z, 1);
  const float uw = __shfl_up_sync(kFull, a.w, 1);
  a = make_float4(lane >= 1 ? __fadd_rn(a.x, uz) : a.x, lane >= 1 ? __fadd_rn(a.y, uw) : a.y,
                  __fadd_rn(a.z, a.x), __fadd_rn(a.w, a.y));
  // s = 4d: the same value of lane l - d
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float ux = __shfl_up_sync(kFull, a.x, d);
    const float uy = __shfl_up_sync(kFull, a.y, d);
    const float u2 = __shfl_up_sync(kFull, a.z, d);
    const float u3 = __shfl_up_sync(kFull, a.w, d);
    if (lane >= d) {
      a.x = __fadd_rn(a.x, ux);
      a.y = __fadd_rn(a.y, uy);
      a.z = __fadd_rn(a.z, u2);
      a.w = __fadd_rn(a.w, u3);
    }
  }
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_blocks_kernel(const T* __restrict__ x, long long n, int vectorized,
                   float* __restrict__ scans, float* __restrict__ totals) {
  __shared__ float row_tot[kRows];
  __shared__ float row_off[kRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * kTile;
  const bool whole = vectorized && base + kTile <= n;
  float4 v[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    v[i] = load4(x, base + (warp + i * kWarps) * kLanes + 4 * lane, n, whole);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    v[i] = row_scan(v[i], lane);
    if (lane == 31) row_tot[warp + i * kWarps] = v[i].w;
  }
  __syncthreads();
  if (warp == 0) {
    // the 64 row totals, 2 a lane (positions 2l, 2l+1), scanned by doubling
    const float t0 = row_tot[2 * lane], t1 = row_tot[2 * lane + 1];
    const float u = __shfl_up_sync(kFull, t1, 1);
    float b0 = lane >= 1 ? __fadd_rn(t0, u) : t0;
    float b1 = __fadd_rn(t1, t0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {   // s = 2d
      const float u0 = __shfl_up_sync(kFull, b0, d);
      const float u1 = __shfl_up_sync(kFull, b1, d);
      if (lane >= d) {
        b0 = __fadd_rn(b0, u0);
        b1 = __fadd_rn(b1, u1);
      }
    }
    row_off[2 * lane] = __fsub_rn(b0, t0);
    row_off[2 * lane + 1] = __fsub_rn(b1, t1);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    const float off = row_off[r];
    v[i] = make_float4(__fadd_rn(v[i].x, off), __fadd_rn(v[i].y, off),
                       __fadd_rn(v[i].z, off), __fadd_rn(v[i].w, off));
    store4(scans, base + r * kLanes + 4 * lane, n, whole, v[i]);
  }
  // the tile's total is its last element, row 63 = warp 7's last row
  if (warp == kWarps - 1 && lane == 31) totals[blockIdx.x] = v[kRowsPerWarp - 1].w;
}

// f32 -> the output type, as 32 bits: f32 as is, int32 truncated
__device__ __forceinline__ unsigned cvt(float v, float) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned cvt(float v, int) {
  return static_cast<unsigned>(__float2int_rz(v));
}

template <typename O>
__global__ void __launch_bounds__(kAddThreads)
add_offsets_kernel(const float* __restrict__ scans, const float* __restrict__ offsets,
                   long long n, int vectorized, O* __restrict__ out) {
  const long long nvec = vectorized ? n / 4 : 0;
  const long long stride = (long long)gridDim.x * kAddThreads;
  const long long tid = (long long)blockIdx.x * kAddThreads + threadIdx.x;
  for (long long i = tid; i < nvec; i += stride) {
    // 4 | 8192: a vector never straddles two tiles
    const float off = __ldg(offsets + (4 * i) / kTile);
    const float4 s = __ldcs(reinterpret_cast<const float4*>(scans) + i);
    __stcs(reinterpret_cast<uint4*>(out) + i,
           make_uint4(cvt(__fadd_rn(s.x, off), O()), cvt(__fadd_rn(s.y, off), O()),
                      cvt(__fadd_rn(s.z, off), O()), cvt(__fadd_rn(s.w, off), O())));
  }
  unsigned* o = reinterpret_cast<unsigned*>(out);
  for (long long i = nvec * 4 + tid; i < n; i += stride)
    o[i] = cvt(__fadd_rn(scans[i], offsets[i / kTile]), O());
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

template <typename T>
int launch_scan(const void* x, long long n, float* scans, float* totals, cudaStream_t st) {
  const long long tiles = (n + kTile - 1) / kTile;
  scan_blocks_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const T*>(x), n, aligned16(x, scans) ? 1 : 0, scans, totals);
  return static_cast<int>(cudaGetLastError());
}

template <typename O>
int launch_add(const float* scans, const float* offsets, long long n, void* out,
               cudaStream_t st) {
  const bool vectorized = aligned16(scans, out);
  const long long work = vectorized ? (n + 3) / 4 : n;
  const long long want = (work + kAddThreads - 1) / kAddThreads;
  const int blocks = static_cast<int>(want > kMaxAddBlocks ? kMaxAddBlocks : want);
  add_offsets_kernel<O><<<blocks, kAddThreads, 0, st>>>(scans, offsets, n, vectorized ? 1 : 0,
                                                       static_cast<O*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: contiguous (n,), n >= 1; dtype: 0 int32, 1 f32. scans: f32 (n,);
// totals: f32 (ceil(n / 8192),).
extern "C" int scan_blocks(const void* x, long long n, int dtype, void* scans, void* totals,
                           void* stream) {
  if (n < 1 || (n + kTile - 1) / kTile > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(scans);
  float* t = static_cast<float*>(totals);
  switch (dtype) {
    case 0: return launch_scan<int>(x, n, s, t, st);
    case 1: return launch_scan<float>(x, n, s, t, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// scans: f32 (n,), n >= 1; offsets: f32 (ceil(n / 8192),); out: (n,) of
// out_dtype, 0 int32 (truncated), 1 f32.
extern "C" int add_offsets(const void* scans, const void* offsets, long long n, int out_dtype,
                           void* out, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scans);
  const float* o = static_cast<const float*>(offsets);
  switch (out_dtype) {
    case 0: return launch_add<int>(s, o, n, out, st);
    case 1: return launch_add<float>(s, o, n, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
