// The bank-local phases of PrIM SCAN over a flat (n,) array, in
// 64 x 128 = 8192-element tiles. Three entry points:
//   scan_blocks: the row-major inclusive scan of each tile and its total;
//   add_offsets: each tile's exclusive offset added back, written in the
//                output type (f32 route: f32, or int32 by truncation, as
//                XLA's convert; int32 route: int32). Between the two, the
//                tile totals are scanned on the card in a fixed order
//                (kernels/ref.py, tile_offsets);
//   scan_lookback: the whole int32 scan, plus an optional carry, in one
//                pass: each tile finds the sum of all tiles before it by
//                decoupled look-back.
// The pair runs on one of two routes:
//   f32:   f32 inside (the Pallas kernels' contract);
//   int32: int32 data, int32 scans, totals and offsets, every add wrapping
//          at 2^32, which is what the reference's PrIM SCAN computes with
//          x64 off (src/repro/prim/scan_ssa.py, scan_rss.py: jnp.cumsum of
//          int32); f32 is exact only below 2^24.
// scan_lookback is int32 only.
//
// Replaces: src/repro/kernels/scan_block.py:33 scan_blocks (body
// _scan_kernel) and :56 add_offsets (body _add_kernel), with the wrapper's
// padding to whole tiles and its final astype (src/repro/kernels/ops.py,
// scan): the kernels mask the ragged last tile (its missing elements count
// as zeros, as the reference's padding) and add_offsets writes x's type.
// scan_lookback replaces the two composed as repro.kernels.ops.scan, on the
// int32 route, and the reference's SCAN-RSS phase 3, jnp.cumsum(xb) + ob[0].
//
// Bound on the H100: bytes. scan_blocks reads x once and writes the 4-byte
// scans (8 bytes an element for int32/f32 input); add_offsets reads the
// scans and writes the result (8 bytes). A handful of adds per element is
// far below the card's ridge. The whole scan as the pair moves 16 bytes an
// element where the function needs 8: at 2^27 its bound is 8 * 2^27 bytes
// / 3.35 TB/s = 0.3205 ms. scan_lookback moves those 8 bytes and no more:
// x is read once and the result written once, and what passes between
// the tiles is one 64-bit status word a tile.
//
// Design of the pair: one block of 8 warps per tile; each warp holds 8 of
// its rows in registers, 4 consecutive elements a lane (one 16-byte load
// per row and lane, coalesced). The arithmetic is the plain version's step
// by step (kernels/ref.py, scan_blocks): each row is scanned by doubling
// (steps s = 1, 2, 4, ..., 64: every element from s on adds the one s
// before it), the 64 row totals likewise by warp 0, the row offsets are
// that scan minus the row totals, and every element adds its row's offset.
// Steps s = 1 and 2 mix a lane's own 4 values with its left neighbour's;
// from s = 4 on a step is one shuffle of each value from d = s / 4 lanes
// left. On the f32 route every add is __fadd_rn / __fsub_rn: no
// contraction and no reordering, so the result equals the plain version
// bit for bit, on any data. On the int32 route the adds are unsigned
// 32-bit: addition mod 2^32 is associative, so any order gives the plain
// version's bits.
//
// Design of scan_lookback (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA 2016): the same tile and in-tile
// scan, one block a tile, but a block takes its tile by ticket (an
// atomicAdd on a counter in scratch), not by blockIdx, so every tile
// before its own belongs to a block that is resident or done, and the
// look-back cannot wait on a block that was never scheduled. Its loads are
// in flight before it looks back. Each tile has one 64-bit status word:
// the 32-bit value above a 2-bit flag (invalid, aggregate, inclusive
// prefix), stored and loaded whole with relaxed device-scope atomics
// (st/ld.relaxed.gpu, which L1 never serves stale), so value and flag
// travel together and no fence is needed. Warp 0 publishes the tile's
// aggregate, then reads the 32 status words before the tile, one a lane;
// once none is invalid, a ballot finds the nearest inclusive prefix and a
// warp sum adds it and the aggregates after it; with no prefix among them
// it adds all 32 and moves 32 tiles further back. Tile 0 publishes carry +
// its aggregate as its prefix at once. The tile's exclusive prefix is
// added into the row offsets, so each element still takes one add. A
// spin of more than kMaxPolls polls traps: a fault of the protocol shows
// as a launch failure at the next synchronize, not as a hang. The scratch
// (the counter, then one word a tile) is the wrapper's and is zeroed here
// on the launch stream, so a captured CUDA graph replays the reset and no
// state outlives a call.

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

// The accumulator A of each route: float (f32) or unsigned (int32, whose
// adds wrap). add/sub: the route's rounding-exact add and subtract.
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ unsigned add(unsigned a, unsigned b) { return a + b; }
__device__ __forceinline__ unsigned sub(unsigned a, unsigned b) { return a - b; }

// four values of the accumulator type (float4 or uint4, 16 bytes)
template <typename A> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static __device__ __forceinline__ float4 make(float a, float b, float c, float d) {
    return make_float4(a, b, c, d);
  }
};
template <> struct Vec<unsigned> {
  using type = uint4;
  static __device__ __forceinline__ uint4 make(unsigned a, unsigned b, unsigned c,
                                               unsigned d) {
    return make_uint4(a, b, c, d);
  }
};

__device__ __forceinline__ float to_acc(float v, float) { return v; }
__device__ __forceinline__ float to_acc(int v, float) { return __int2float_rn(v); }
__device__ __forceinline__ unsigned to_acc(int v, unsigned) { return static_cast<unsigned>(v); }
// one element of type T from its 32 bits, in the accumulator type
__device__ __forceinline__ float word_acc(unsigned w, float, float) { return __uint_as_float(w); }
__device__ __forceinline__ float word_acc(unsigned w, int, float) {
  return __int2float_rn(static_cast<int>(w));
}
__device__ __forceinline__ unsigned word_acc(unsigned w, int, unsigned) { return w; }

// 4 elements from p on (p % 4 == 0), in A; past n they are 0.
template <typename T, typename A, typename V = typename Vec<A>::type>
__device__ __forceinline__ V load4(const T* __restrict__ x, long long p, long long n,
                                   bool whole) {
  if (whole) {
    const uint4 w = __ldcs(reinterpret_cast<const uint4*>(x + p));
    return Vec<A>::make(word_acc(w.x, T(), A()), word_acc(w.y, T(), A()),
                        word_acc(w.z, T(), A()), word_acc(w.w, T(), A()));
  }
  return Vec<A>::make(p < n ? to_acc(x[p], A()) : A(0), p + 1 < n ? to_acc(x[p + 1], A()) : A(0),
                      p + 2 < n ? to_acc(x[p + 2], A()) : A(0),
                      p + 3 < n ? to_acc(x[p + 3], A()) : A(0));
}

template <typename A, typename V>
__device__ __forceinline__ void store4(A* __restrict__ o, long long p, long long n,
                                       bool whole, V v) {
  if (whole) {
    __stcs(reinterpret_cast<V*>(o + p), v);
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
template <typename A, typename V = typename Vec<A>::type>
__device__ __forceinline__ V row_scan(V a, int lane) {
  // s = 1: p - 1 is the lane's previous value, or the left lane's a.w
  A u = __shfl_up_sync(kFull, a.w, 1);
  a = Vec<A>::make(lane >= 1 ? add(a.x, u) : a.x, add(a.y, a.x), add(a.z, a.y), add(a.w, a.z));
  // s = 2: p - 2 is two values back in the lane, or the left lane's a.z, a.w
  const A uz = __shfl_up_sync(kFull, a.z, 1);
  const A uw = __shfl_up_sync(kFull, a.w, 1);
  a = Vec<A>::make(lane >= 1 ? add(a.x, uz) : a.x, lane >= 1 ? add(a.y, uw) : a.y,
                   add(a.z, a.x), add(a.w, a.y));
  // s = 4d: the same value of lane l - d
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const A ux = __shfl_up_sync(kFull, a.x, d);
    const A uy = __shfl_up_sync(kFull, a.y, d);
    const A u2 = __shfl_up_sync(kFull, a.z, d);
    const A u3 = __shfl_up_sync(kFull, a.w, d);
    if (lane >= d) {
      a.x = add(a.x, ux);
      a.y = add(a.y, uy);
      a.z = add(a.z, u2);
      a.w = add(a.w, u3);
    }
  }
  return a;
}

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
scan_blocks_kernel(const T* __restrict__ x, long long n, int vectorized,
                   A* __restrict__ scans, A* __restrict__ totals) {
  using V = typename Vec<A>::type;
  __shared__ A row_tot[kRows];
  __shared__ A row_off[kRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * kTile;
  const bool whole = vectorized && base + kTile <= n;
  V v[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    v[i] = load4<T, A>(x, base + (warp + i * kWarps) * kLanes + 4 * lane, n, whole);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    v[i] = row_scan<A>(v[i], lane);
    if (lane == 31) row_tot[warp + i * kWarps] = v[i].w;
  }
  __syncthreads();
  if (warp == 0) {
    // the 64 row totals, 2 a lane (positions 2l, 2l+1), scanned by doubling
    const A t0 = row_tot[2 * lane], t1 = row_tot[2 * lane + 1];
    const A u = __shfl_up_sync(kFull, t1, 1);
    A b0 = lane >= 1 ? add(t0, u) : t0;
    A b1 = add(t1, t0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {   // s = 2d
      const A u0 = __shfl_up_sync(kFull, b0, d);
      const A u1 = __shfl_up_sync(kFull, b1, d);
      if (lane >= d) {
        b0 = add(b0, u0);
        b1 = add(b1, u1);
      }
    }
    row_off[2 * lane] = sub(b0, t0);
    row_off[2 * lane + 1] = sub(b1, t1);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    const A off = row_off[r];
    v[i] = Vec<A>::make(add(v[i].x, off), add(v[i].y, off), add(v[i].z, off), add(v[i].w, off));
    store4(scans, base + r * kLanes + 4 * lane, n, whole, v[i]);
  }
  // the tile's total is its last element, row 63 = warp 7's last row
  if (warp == kWarps - 1 && lane == 31) totals[blockIdx.x] = v[kRowsPerWarp - 1].w;
}

// the accumulator -> the output type, as 32 bits: f32 as is, f32 -> int32
// truncated, the int32 route's sum as is
__device__ __forceinline__ unsigned cvt(float v, float) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned cvt(float v, int) {
  return static_cast<unsigned>(__float2int_rz(v));
}
__device__ __forceinline__ unsigned cvt(unsigned v, int) { return v; }

template <typename A, typename O>
__global__ void __launch_bounds__(kAddThreads)
add_offsets_kernel(const A* __restrict__ scans, const A* __restrict__ offsets,
                   long long n, int vectorized, O* __restrict__ out) {
  using V = typename Vec<A>::type;
  const long long nvec = vectorized ? n / 4 : 0;
  const long long stride = (long long)gridDim.x * kAddThreads;
  const long long tid = (long long)blockIdx.x * kAddThreads + threadIdx.x;
  for (long long i = tid; i < nvec; i += stride) {
    // 4 | 8192: a vector never straddles two tiles
    const A off = __ldg(offsets + (4 * i) / kTile);
    const V s = __ldcs(reinterpret_cast<const V*>(scans) + i);
    __stcs(reinterpret_cast<uint4*>(out) + i,
           make_uint4(cvt(add(s.x, off), O()), cvt(add(s.y, off), O()),
                      cvt(add(s.z, off), O()), cvt(add(s.w, off), O())));
  }
  unsigned* o = reinterpret_cast<unsigned*>(out);
  for (long long i = nvec * 4 + tid; i < n; i += stride)
    o[i] = cvt(add(scans[i], offsets[i / kTile]), O());
}

// scan_lookback's status words: the value in the high 32 bits, the flag in
// the low 2; a zeroed word is invalid.
constexpr unsigned kInvalid = 0, kAggregate = 1, kPrefix = 2;
constexpr long long kMaxPolls = 1LL << 24;

__device__ __forceinline__ unsigned long long status_word(unsigned value, unsigned flag) {
  return (static_cast<unsigned long long>(value) << 32) | flag;
}
__device__ __forceinline__ unsigned status_flag(unsigned long long w) {
  return static_cast<unsigned>(w) & 3u;
}
__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}
__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

// Warp 0 of tile `tile` > 0: the wrapping sum of every tile before it, from
// the status words. Lane l reads the word of tile end - 1 - l; a word
// before tile 0 reads as a prefix of 0 (tile 0's own is always a prefix, so
// it is never passed). Every lane returns the sum.
__device__ __forceinline__ unsigned look_back(const unsigned long long* status, int tile,
                                              int lane) {
  unsigned sum = 0;
  long long polls = 0;
  for (int end = tile;; end -= 32) {
    const int idx = end - 1 - lane;
    unsigned long long w;
    while (true) {
      w = idx >= 0 ? load_status(status + idx) : status_word(0, kPrefix);
      if (__all_sync(kFull, status_flag(w) != kInvalid)) break;
      if (++polls > kMaxPolls) __trap();
      __nanosleep(32);
    }
    const unsigned prefixes = __ballot_sync(kFull, status_flag(w) == kPrefix);
    const int nearest = prefixes ? __ffs(static_cast<int>(prefixes)) - 1 : 31;
    unsigned v = lane <= nearest ? static_cast<unsigned>(w >> 32) : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    sum += v;
    if (prefixes) return sum;
  }
}

// One tile of scan_lookback: kLookbackRows rows of 128, each warp holding
// kLookbackRows / 8 of them.
constexpr int kLookbackRows = 64;
constexpr long long kLookbackTile = kLookbackRows * kLanes;

__global__ void __launch_bounds__(kThreads)
scan_lookback_kernel(const int* __restrict__ x, long long n, int vectorized,
                     const int* __restrict__ carry, int* __restrict__ out,
                     unsigned long long* __restrict__ scratch) {
  constexpr int kPerWarp = kLookbackRows / kWarps;   // rows a warp holds
  constexpr int kPerLane = kLookbackRows / 32;       // row totals a lane of warp 0 scans
  __shared__ unsigned row_sum[kLookbackRows];        // row totals, then row offsets
  __shared__ int ticket;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0)
    ticket = static_cast<int>(atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u));
  __syncthreads();
  const int tile = ticket;
  unsigned long long* status = scratch + 1;
  const long long base = (long long)tile * kLookbackTile;
  const bool whole = vectorized && base + kLookbackTile <= n;
  uint4 v[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i)
    v[i] = load4<int, unsigned>(x, base + (warp + i * kWarps) * kLanes + 4 * lane, n, whole);
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    v[i] = row_scan<unsigned>(v[i], lane);
    if (lane == 31) row_sum[warp + i * kWarps] = v[i].w;
  }
  __syncthreads();
  if (warp == 0) {
    // the row totals, kPerLane consecutive ones a lane: scanned in the
    // lane, then the lanes' sums across the warp
    unsigned t[kPerLane], c[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      t[j] = row_sum[lane * kPerLane + j];
      c[j] = j ? c[j - 1] + t[j] : t[j];
    }
    unsigned incl = c[kPerLane - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    const unsigned total = __shfl_sync(kFull, incl, 31);
    unsigned before;
    if (tile == 0) {
      before = carry ? static_cast<unsigned>(*carry) : 0u;
      if (lane == 0) store_status(status, status_word(before + total, kPrefix));
    } else {
      if (lane == 0) store_status(status + tile, status_word(total, kAggregate));
      before = look_back(status, tile, lane);
      if (lane == 0) store_status(status + tile, status_word(before + total, kPrefix));
    }
    const unsigned lane_off = before + incl - c[kPerLane - 1];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) row_sum[lane * kPerLane + j] = lane_off + c[j] - t[j];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int r = warp + i * kWarps;
    const unsigned off = row_sum[r];
    v[i] = make_uint4(v[i].x + off, v[i].y + off, v[i].z + off, v[i].w + off);
    store4(reinterpret_cast<unsigned*>(out), base + r * kLanes + 4 * lane, n, whole, v[i]);
  }
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

template <typename T, typename A>
int launch_scan(const void* x, long long n, void* scans, void* totals, cudaStream_t st) {
  const long long tiles = (n + kTile - 1) / kTile;
  scan_blocks_kernel<T, A><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const T*>(x), n, aligned16(x, scans) ? 1 : 0, static_cast<A*>(scans),
      static_cast<A*>(totals));
  return static_cast<int>(cudaGetLastError());
}

template <typename A, typename O>
int launch_add(const void* scans_, const void* offsets_, long long n, void* out,
               cudaStream_t st) {
  const A* scans = static_cast<const A*>(scans_);
  const A* offsets = static_cast<const A*>(offsets_);
  const bool vectorized = aligned16(scans, out);
  const long long work = vectorized ? (n + 3) / 4 : n;
  const long long want = (work + kAddThreads - 1) / kAddThreads;
  const int blocks = static_cast<int>(want > kMaxAddBlocks ? kMaxAddBlocks : want);
  add_offsets_kernel<A, O><<<blocks, kAddThreads, 0, st>>>(scans, offsets, n,
                                                          vectorized ? 1 : 0,
                                                          static_cast<O*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: contiguous (n,), n >= 1; dtype: 0 int32, 1 f32; acc: 0 the f32 route
// (scans, totals f32), 1 the int32 route (dtype int32; scans, totals int32).
// scans: (n,); totals: (ceil(n / 8192),).
extern "C" int scan_blocks(const void* x, long long n, int dtype, int acc, void* scans,
                           void* totals, void* stream) {
  if (n < 1 || (n + kTile - 1) / kTile > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (acc == 1)
    return dtype == 0 ? launch_scan<int, unsigned>(x, n, scans, totals, st)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (acc != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch_scan<int, float>(x, n, scans, totals, st);
    case 1: return launch_scan<float, float>(x, n, scans, totals, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// scans: (n,), n >= 1; offsets: (ceil(n / 8192),); acc: 0 the f32 route
// (scans, offsets f32; out_dtype 0 int32, truncated, or 1 f32), 1 the int32
// route (scans, offsets int32; out_dtype 0 int32). out: (n,) of out_dtype.
extern "C" int add_offsets(const void* scans, const void* offsets, long long n, int acc,
                           int out_dtype, void* out, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (acc == 1)
    return out_dtype == 0 ? launch_add<unsigned, int>(scans, offsets, n, out, st)
                          : static_cast<int>(cudaErrorInvalidValue);
  if (acc != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (out_dtype) {
    case 0: return launch_add<float, int>(scans, offsets, n, out, st);
    case 1: return launch_add<float, float>(scans, offsets, n, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: contiguous int32 (n,), n >= 1; carry: one int32 on the device, or null
// for 0; out: int32 (n,), out[i] = carry + x[0] + ... + x[i], wrapping at
// 2^32; scratch: ceil(n / kLookbackTile) + 1 64-bit words (the ticket
// counter, then one status word a tile), zeroed here on the stream before
// the launch.
extern "C" int scan_lookback(const void* x, long long n, const void* carry, void* out,
                             void* scratch, void* stream) {
  const long long tiles = (n + kLookbackTile - 1) / kLookbackTile;
  if (n < 1 || tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      cudaMemsetAsync(scratch, 0, static_cast<size_t>(tiles + 1) * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_lookback_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const int*>(x), n, aligned16(x, out) ? 1 : 0, static_cast<const int*>(carry),
      static_cast<int*>(out), static_cast<unsigned long long*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
