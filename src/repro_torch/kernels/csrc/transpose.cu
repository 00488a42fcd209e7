// Matrix transpose (PrIM TRNS, the bank-local step): (M, N) -> (N, M) for
// 32-bit elements (f32, int32: the kernel moves bits), of one matrix or of
// a batch of them stored one after another, (B, M, N) -> (B, N, M): PrIM
// TRNS on B banks transposes every bank's column tile in one launch.
//
// Replaces: src/repro/kernels/trns.py, transpose_tiled (body _trns_kernel),
// and the wrapper's padding of M and N to multiples of 128
// (src/repro/kernels/ops.py, transpose). The TPU kernel moves 128 x 128
// tiles and swaps the grid indices in its out BlockSpec; here a block
// moves one 32 x 32 tile and masks the ragged edges itself.
//
// Bound on the H100: bytes (each element read once and written once).
//
// Design: the classic shared-memory tile transpose. A block of 32 x 8
// threads reads its tile row by row (each warp one 128-byte row segment,
// coalesced), and writes the transposed tile row by row likewise; the
// tile's rows are padded to 33 words, so the column reads of the second
// half hit 32 different banks. Tiles are numbered in one grid dimension,
// so M and N are limited only by the tile count (< 2^31). A batch runs the
// kBatched instance, whose grid's second dimension (< 65536) is the matrix;
// one matrix runs the instance without the offset.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;

template <bool kBatched>
__global__ void __launch_bounds__(kTile * kRowsPerPass)
transpose_kernel(const unsigned* __restrict__ a, unsigned* __restrict__ o, long long m,
                 long long n, long long tiles_n) {
  __shared__ unsigned tile[kTile][kTile + 1];
  if (kBatched) {   // blockIdx.y is the matrix
    a += blockIdx.y * m * n;
    o += blockIdx.y * m * n;
  }
  const long long ti = blockIdx.x / tiles_n, tj = blockIdx.x % tiles_n;
  const long long r0 = ti * kTile, c0 = tj * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = ty; i < kTile; i += kRowsPerPass) {
    const long long r = r0 + i, c = c0 + tx;
    if (r < m && c < n) tile[i][tx] = __ldcs(a + r * n + c);
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < kTile; i += kRowsPerPass) {
    const long long r = c0 + i, c = r0 + tx;   // row of the output: a column of a
    if (r < n && c < m) __stcs(o + r * m + c, tile[tx][i]);
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a: contiguous (batch, m, n) of 32-bit elements, 1 <= batch < 65536,
// m, n >= 1, with fewer than 2^31 32 x 32 tiles a matrix; o: contiguous
// (batch, n, m).
extern "C" int transpose(const void* a, long long batch, long long m, long long n, void* o,
                         void* stream) {
  if (m < 1 || n < 1 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_m = (m + kTile - 1) / kTile, tiles_n = (n + kTile - 1) / kTile;
  if (tiles_m * tiles_n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles_m * tiles_n), static_cast<unsigned>(batch));
  const dim3 block(kTile, kRowsPerPass);
  auto* src = static_cast<const unsigned*>(a);
  auto* dst = static_cast<unsigned*>(o);
  if (batch > 1)
    transpose_kernel<true><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        src, dst, m, n, tiles_n);
  else
    transpose_kernel<false><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        src, dst, m, n, tiles_n);
  return static_cast<int>(cudaGetLastError());
}
