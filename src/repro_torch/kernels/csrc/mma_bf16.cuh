// The bf16 tensor-core building blocks that flash_attention.cu (forward) and
// flash_attention_bwd.cu (backward) share: asynchronous 16-byte copies into
// shared memory (cp.async), fragment loads (ldmatrix, plain and transposed),
// the m16n8k16 product with bf16 operands and f32 accumulators (mma.sync),
// the hi + lo split of two floats into bf16 pairs, and the loader of a
// 64-row tile of one head into shared memory.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4): the
// accumulator's c0, c1 are row g, columns 2t and 2t + 1, c2, c3 row g + 8;
// the A operand's a0 is row g, k 2t and 2t + 1, a1 row g + 8, a2 and a3 the
// same rows at k + 8; so two adjacent 8-column accumulator tiles, rounded
// to bf16 pairs, are the A operand of a product whose depth is their 16
// columns. The B operand's b0 holds k 2t and 2t + 1 of column g, b1 the same
// at k + 8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMmaThreads = 128;   // 4 warps x 16 rows
constexpr int kTileRows = 64;      // rows of a tile that load_rows fills

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(src_bytes) : "memory");
}
// one 4-byte word; src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
// d += a (16x16, row major) * b (16x8, column major); bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats x0, x1 (x0 in the low half, the lower column index) as
// bf16x2, `hi`, and the bf16x2 of what that rounding left, `lo`: hi + lo
// holds each to about 16 significant bits, where hi alone holds 8
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// Rows [row0, row0 + 64) of one head of a position-strided bf16 array
// into a 64 x (HD + 8) shared tile; rows at or past n are zero. vec:
// 16-byte cp.async (every address 16-byte aligned); else 2-byte loads,
// stored 16 bytes at a time. Above hd 128 the loop stays rolled, so that
// the compiler keeps no per-piece addresses live across the key loop.
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int row0, int n,
                                          bool vec) {
  constexpr int kPieces = HD / 8;            // 16-byte pieces a row
  constexpr int kLd = HD + 8;
  constexpr int kUnroll = HD > 128 ? 1 : kTileRows * kPieces / kMmaThreads;
#pragma unroll kUnroll
  for (int u = 0; u < kTileRows * kPieces / kMmaThreads; ++u) {
    const int i = threadIdx.x + u * kMmaThreads;
    const int r = i / kPieces, c = i % kPieces;
    const int pos = row0 + r;
    const bool ok = pos < n;
    __nv_bfloat16* d = dst + r * kLd + c * 8;
    const __nv_bfloat16* s = src + (long long)(ok ? pos : 0) * ss + c * 8;
    if (vec) {
      cp_async16(d, s, ok ? 16 : 0);
    } else {
      union {
        uint4 u;
        __nv_bfloat16 h[8];
      } piece;
      piece.u = make_uint4(0u, 0u, 0u, 0u);
      if (ok)
#pragma unroll
        for (int e = 0; e < 8; ++e) piece.h[e] = s[e];
      *reinterpret_cast<uint4*>(d) = piece.u;
    }
  }
}

}  // namespace
