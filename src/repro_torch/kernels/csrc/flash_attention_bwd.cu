// Flash-attention backward: the gradients dQ, dK, dV of softmax attention
// (causal, sliding-window or unmasked) from q, k, v, the forward's output O,
// its per-row log-sum-exp and dO, never holding the (Sq, Skv) matrices.
//
// Replaces: no pallas_call. The reference trains through pure-JAX attention
// (src/repro/models/transformer.py, _plain_attention, and the chunked
// src/repro/models/layers.py, flash_attention) and lets JAX differentiate
// it; the port runs its attention on the forward kernel
// (flash_attention.cu), whose output carries no gradient, so this kernel is
// that gradient. It is FlashAttention-2's backward: P is recomputed from q,
// k and the forward's log-sum-exp L (natural log, f32, (B, H, Sq)) as
// P = exp(q.k / sqrt(hd) - L), then
//   D  = rowsum(dO o O)                   (bwd_dot_kernel)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),  dK = dS^T Q / sqrt(hd)
//                                          (the dK/dV kernel)
//   dQ = dS K / sqrt(hd)                  (the dQ kernel)
// Layouts are the forward's: q (B, Sq, H, hd), k/v (B, Skv, KVH, hd), read
// through their (batch, position, head) strides with unit stride on hd;
// O and dO contiguous (B, Sq, H, hd). dQ is written contiguous (B, Sq, H,
// hd), dK and dV contiguous (B, Skv, KVH, hd), in the inputs' dtype.
//
// Scope: what training reaches. Query positions start at 0 (no q_offset);
// causal with or without a window, or unmasked; every query row has at least
// one unmasked key (the wrapper refuses rows without one); hd <= 256.
//
// Bound on the H100: operations. The least work is 10 * hd flops per
// unmasked (query, key) pair and head (S, dP, dV, dK, dQ, 2 * hd each),
// against some 10 * S * hd bytes per head. This design does 14: the dQ
// kernel computes S and dP a second time. Its alternative, dQ summed into
// device memory by atomics from the dK/dV kernel, saves 4 * hd flops a pair
// but adds in an order that changes from launch to launch, and a training
// run that crashes and resumes must end bit-equal to one that did not.
//
// Two routes, chosen by the caller (kernels/flash_attention_bwd.py, route())
// from the dtype and head_dim alone; neither is ever taken because the other
// failed. Both keep the split into a dK/dV kernel and a dQ kernel: one dK/dV
// block per (key tile, KV head, batch) loops over the H / KVH query heads of
// its KV head and, for each, over the query tiles that see a key of its
// tile, so GQA's sum over the group happens in the block's registers; one dQ
// block per (query tile, head, batch) loops over the key tiles its rows
// see. Key tile 0 and the latest query tile (the longest causal loops) start
// first. No atomics anywhere and every sum in a fixed order: two launches on
// the same inputs give the same bits.
//
// Tensor cores (route 1: bf16, hd a multiple of 16 up to 128; every
// architecture of configs/: hd 128, whisper's 64), bwd_dkdv_mma_kernel and
// bwd_dq_mma_kernel: FlashAttention-2's backward on mma.sync.m16n8k16, bf16
// operands and f32 accumulators, each warp owning 16 rows of its block
// (keys in dK/dV, queries in dQ): kDkdvWarps = 4 (64 keys a block) and
// kDqWarps = 8 (128 queries). The other side streams in tiles of 64 rows.
// Tiles sit in shared memory as bf16, rows padded by 16 bytes so that
// ldmatrix reads have no bank conflicts; the streamed tiles (Q, dO with
// their rows' L and D in dK/dV; K, V in dQ) arrive double-buffered through
// cp.async, tile j + 1 loading while tile j computes, or, where a base
// pointer or stride is not 16-byte aligned, through 2-byte loads
// (mma_bf16.cuh's load_rows).
//   dK/dV: K and V stay resident. Per 16 queries of a streamed tile a warp
//   computes S^T = K.Q^T and dP^T = V.dO^T (K, V as A operands, Q and dO as
//   ldmatrix B operands), forms P^T = exp2(S^T scale log2 e - L log2 e) and
//   dS^T = P^T o (dP^T - D) in f32 registers, rounds both accumulators
//   straight into bf16 A fragments (no P or dS tile goes through shared
//   memory), and adds dV += P^T.dO and dK += dS^T.Q with ldmatrix.trans B
//   operands. dK is scaled by 1 / sqrt(hd) once, at the end.
//   dQ: Q, dO and the rows' L and D stay resident, Q's and dO's fragments in
//   registers. Per 16 keys of a streamed tile: S = Q.K^T, dP = dO.V^T, dS in
//   registers as A fragments, dQ += dS.K with ldmatrix.trans of K.
// Causal, window and key < Skv masks (and query < Sq) are applied on the
// accumulator fragments, only where a warp's 16 x 16 piece crosses one;
// pieces wholly masked are skipped, and tiles wholly masked never loaded.
// The tiling trades registers for shared-memory traffic: a dK/dV thread
// holds 16 rows x hd columns of dK and of dV (128 f32 registers at hd 128,
// 246 in all) and a dQ thread those of dQ with Q's and dO's fragments (239),
// each only a 16 x 16 piece of S and dP (8 each), so K and V (dK/dV) are
// re-read from shared memory for every 16 queries. At hd 128 a dK/dV block
// takes 105 KB of shared memory (two blocks an SM), a dQ block 140 KB (one).
// The warps a block were chosen by measurement (flash_bwd_sweep.py: 4 or 8
// for each kernel, granite-3-8b's training call and whisper-tiny's
// encoder): they move either kernel by 1-6%, and each warp's sums run in
// the same order whatever the block's size, so every choice gives the same
// bits. P and dS enter the products as plain bf16 (8 significant bits):
// their rounding, 2^-9 relative, averages out in the sums, below the
// gradients' own bf16 rounding and O's (chip_smoke.py phase 17 (a) holds
// each case to BWD_BAND of f64; no case needed the hi + lo split).
//
// CUDA cores (route 0: f32, and bf16 with other head dims), bwd_dkdv_kernel
// and bwd_dq_kernel: f32 arithmetic on CUDA cores (bf16 widened as it is
// loaded into shared memory), as the forward's CUDA-core route is: TF32
// tensor cores could not hold f32 gradients to an f64 run at 1e-4
// (phase 17 (b)). Tiles of 64 queries and 64 keys (32 of each above hd 128,
// to stay in shared memory), 256 threads as 16 x 16, each thread holding a
// 4 x 4 (2 x 2) block of scores and R rows x hd / 16 columns of its f32
// accumulators in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16: ty picks rows, tx picks columns
constexpr int kMaxHd = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, s, h;   // elements between batches, positions, heads
};

struct Shape {
  int Sq, Skv, H, KVH, hd;
  int causal, window;
  float scale;         // 1 / sqrt(hd)
};

__device__ __forceinline__ bool unmasked(const Shape& sh, int qpos, int key) {
  return qpos < sh.Sq && key < sh.Skv && (!sh.causal || qpos >= key) &&
         (sh.window <= 0 || qpos - key < sh.window);
}

// Four BM x (hd + 1) f32 tiles, two BM x (BM + 1) f32 score tiles, and the
// query tile's L and D.
size_t smem_bytes(int bm, int hd) {
  return sizeof(float) *
         (size_t)(4 * bm * (hd + 1) + 2 * bm * (bm + 1) + 2 * bm);
}

// D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], f32: one warp a row, the
// lanes' partial sums folded in a fixed butterfly order.
template <typename T>
__global__ void bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                               float* __restrict__ D, int B, int Sq, int H, int hd) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * Sq * H) return;
  const T* orow = o + row * hd;
  const T* drow = dout + row * hd;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s += to_f32(orow[d]) * to_f32(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long long bi = row / H;
    const int i = static_cast<int>(bi % Sq);
    const int b = static_cast<int>(bi / Sq);
    D[((size_t)b * H + h) * Sq + i] = s;
  }
}

// rows [row0, row0 + BM) of one head of a position-strided array, widened to
// f32, into a BM x ld shared tile; rows at or past n are zero
template <typename T, int BM>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss,
                                          int row0, int n, int hd, int ld) {
  for (int i = threadIdx.x; i < BM * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int pos = row0 + r;
    dst[r * ld + d] = pos < n ? to_f32(src[pos * ss + d]) : 0.f;
  }
}

// BM: rows of a query and of a key tile; HDM: the most hd this
// instantiation holds (a multiple of 16).
template <typename T, int BM, int HDM>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ D,
                T* __restrict__ dk, T* __restrict__ dv, Shape sh, Strides qs,
                Strides ks, Strides vs) {
  constexpr int R = BM / 16;      // key rows (and query columns) a thread
  constexpr int CD = HDM / 16;    // hd columns a thread
  constexpr int ldp = BM + 1;
  extern __shared__ float smem[];
  const int hd = sh.hd, ld = hd + 1;
  float* sK = smem;               // BM x ld
  float* sV = sK + BM * ld;       // BM x ld
  float* sQ = sV + BM * ld;       // BM x ld
  float* sG = sQ + BM * ld;       // dO tile, BM x ld
  float* sP = sG + BM * ld;       // P^T, [key][query], BM x ldp
  float* sS = sP + BM * ldp;      // dS^T, [key][query], BM x ldp
  float* sL = sS + BM * ldp;      // L of the query tile
  float* sD = sL + BM;            // D of the query tile

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int group = sh.H / sh.KVH;
  const int k_lo = kt * BM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, BM>(sK, k + b * ks.b + kh * ks.h, ks.s, k_lo, sh.Skv, hd, ld);
  load_tile<T, BM>(sV, v + b * vs.b + kh * vs.h, vs.s, k_lo, sh.Skv, hd, ld);

  // the query tiles that see a key of this tile (query positions from 0)
  int qt_begin = 0, qt_end = (sh.Sq + BM - 1) / BM;
  if (sh.causal) qt_begin = k_lo / BM;
  if (sh.window > 0) qt_end = min(qt_end, (k_lo + BM - 1 + sh.window - 1) / BM + 1);

  float adk[R][CD], adv[R][CD];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) adk[a][c] = adv[a][c] = 0.f;

  for (int hq = 0; hq < group; ++hq) {
    const int h = kh * group + hq;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* gb = dout + ((size_t)b * sh.Sq * sh.H + h) * hd;
    const float* lb = lse + ((size_t)b * sh.H + h) * sh.Sq;
    const float* db = D + ((size_t)b * sh.H + h) * sh.Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q_lo = qt * BM;
      __syncthreads();   // the previous tile's sQ, sG, sP, sS are consumed
      load_tile<T, BM>(sQ, qb, qs.s, q_lo, sh.Sq, hd, ld);
      load_tile<T, BM>(sG, gb, (long long)sh.H * hd, q_lo, sh.Sq, hd, ld);
      for (int r = threadIdx.x; r < BM; r += kThreads) {
        const bool ok = q_lo + r < sh.Sq;
        sL[r] = ok ? lb[q_lo + r] : 0.f;
        sD[r] = ok ? db[q_lo + r] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for keys ty + 16a, queries tx + 16c
      float s[R][R], dp[R][R];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.f;
      for (int d = 0; d < hd; ++d) {
        float kk[R], vv[R], qq[R], gg[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          kk[a] = sK[(ty + 16 * a) * ld + d];
          vv[a] = sV[(ty + 16 * a) * ld + d];
          qq[a] = sQ[(tx + 16 * a) * ld + d];
          gg[a] = sG[(tx + 16 * a) * ld + d];
        }
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int c = 0; c < R; ++c) {
            s[a][c] += kk[a] * qq[c];
            dp[a][c] += vv[a] * gg[c];
          }
      }
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int key = k_lo + ty + 16 * a, qr = tx + 16 * c;
          const float p = unmasked(sh, q_lo + qr, key)
                              ? expf(s[a][c] * sh.scale - sL[qr]) : 0.f;
          sP[(ty + 16 * a) * ldp + qr] = p;
          sS[(ty + 16 * a) * ldp + qr] = p * (dp[a][c] - sD[qr]);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: key rows ty + 16a, columns tx + 16c
      for (int j = 0; j < BM; ++j) {
        float pj[R], sj[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          pj[a] = sP[(ty + 16 * a) * ldp + j];
          sj[a] = sS[(ty + 16 * a) * ldp + j];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          const int d = tx + 16 * c;
          const float g = d < hd ? sG[j * ld + d] : 0.f;
          const float qv = d < hd ? sQ[j * ld + d] : 0.f;
#pragma unroll
          for (int a = 0; a < R; ++a) {
            adv[a][c] += pj[a] * g;
            adk[a][c] += sj[a] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int key = k_lo + ty + 16 * a;
    if (key >= sh.Skv) continue;
    const size_t off = (((size_t)b * sh.Skv + key) * sh.KVH + kh) * hd;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) {
        dk[off + d] = from_f32<T>(adk[a][c] * sh.scale);
        dv[off + d] = from_f32<T>(adv[a][c]);
      }
    }
  }
}

template <typename T, int BM, int HDM>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ D,
              T* __restrict__ dq, Shape sh, Strides qs, Strides ks, Strides vs) {
  constexpr int R = BM / 16;
  constexpr int CD = HDM / 16;
  constexpr int ldp = BM + 1;
  extern __shared__ float smem[];
  const int hd = sh.hd, ld = hd + 1;
  float* sQ = smem;               // BM x ld
  float* sG = sQ + BM * ld;       // dO tile
  float* sK = sG + BM * ld;
  float* sV = sK + BM * ld;
  float* sS = sV + BM * ld;       // dS, [query][key], BM x ldp
  float* sL = sS + BM * ldp;
  float* sD = sL + BM;

  const int qt = gridDim.x - 1 - blockIdx.x;   // latest (longest) rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (sh.H / sh.KVH);
  const int q_lo = qt * BM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  load_tile<T, BM>(sQ, q + b * qs.b + h * qs.h, qs.s, q_lo, sh.Sq, hd, ld);
  load_tile<T, BM>(sG, dout + ((size_t)b * sh.Sq * sh.H + h) * hd,
                   (long long)sh.H * hd, q_lo, sh.Sq, hd, ld);
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const bool ok = q_lo + r < sh.Sq;
    sL[r] = ok ? lse[((size_t)b * sh.H + h) * sh.Sq + q_lo + r] : 0.f;
    sD[r] = ok ? D[((size_t)b * sh.H + h) * sh.Sq + q_lo + r] : 0.f;
  }

  int kt_end = (sh.Skv + BM - 1) / BM;
  if (sh.causal) kt_end = min(kt_end, (q_lo + BM - 1) / BM + 1);
  int kt_begin = 0;
  if (sh.window > 0 && q_lo - sh.window + 1 > 0) kt_begin = (q_lo - sh.window + 1) / BM;

  float adq[R][CD];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) adq[a][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * BM;
    __syncthreads();   // the previous tile's sK, sV, sS are consumed
    load_tile<T, BM>(sK, kb, ks.s, k_lo, sh.Skv, hd, ld);
    load_tile<T, BM>(sV, vb, vs.s, k_lo, sh.Skv, hd, ld);
    __syncthreads();

    // S and dP for queries ty + 16a, keys tx + 16c
    float s[R][R], dp[R][R];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qq[R], gg[R], kk[R], vv[R];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        qq[a] = sQ[(ty + 16 * a) * ld + d];
        gg[a] = sG[(ty + 16 * a) * ld + d];
        kk[a] = sK[(tx + 16 * a) * ld + d];
        vv[a] = sV[(tx + 16 * a) * ld + d];
      }
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < R; ++c) {
          s[a][c] += qq[a] * kk[c];
          dp[a][c] += gg[a] * vv[c];
        }
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int qr = ty + 16 * a, key = k_lo + tx + 16 * c;
        const float p = unmasked(sh, q_lo + qr, key)
                            ? expf(s[a][c] * sh.scale - sL[qr]) : 0.f;
        sS[qr * ldp + tx + 16 * c] = p * (dp[a][c] - sD[qr]);
      }
    __syncthreads();

    // dQ += dS K: query rows ty + 16a, columns tx + 16c
    for (int j = 0; j < BM; ++j) {
      float sj[R];
#pragma unroll
      for (int a = 0; a < R; ++a) sj[a] = sS[(ty + 16 * a) * ldp + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const int d = tx + 16 * c;
        const float kv = d < hd ? sK[j * ld + d] : 0.f;
#pragma unroll
        for (int a = 0; a < R; ++a) adq[a][c] += sj[a] * kv;
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int qpos = q_lo + ty + 16 * a;
    if (qpos >= sh.Sq) continue;
    T* row = dq + (((size_t)b * sh.Sq + qpos) * sh.H + h) * hd;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) row[d] = from_f32<T>(adq[a][c] * sh.scale);
    }
  }
}

template <typename T, int BM, int HDM>
int launch(cudaStream_t st, int B, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* D, void* dq,
           void* dk, void* dv, Shape sh, Strides qs, Strides ks, Strides vs) {
  const size_t smem = smem_bytes(BM, sh.hd);
  cudaError_t e = cudaFuncSetAttribute(bwd_dkdv_kernel<T, BM, HDM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bwd_dq_kernel<T, BM, HDM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_kv((sh.Skv + BM - 1) / BM, sh.KVH, B);
  bwd_dkdv_kernel<T, BM, HDM><<<grid_kv, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, D, static_cast<T*>(dk), static_cast<T*>(dv),
      sh, qs, ks, vs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_q((sh.Sq + BM - 1) / BM, sh.H, B);
  bwd_dq_kernel<T, BM, HDM><<<grid_q, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, D, static_cast<T*>(dq), sh, qs, ks, vs);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------------
// Tensor-core route (bf16, hd a multiple of 16 up to 128)
// ------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcMaxHd = 128;
constexpr float kLog2e = 1.4426950408889634f;
// warps a block, each owning 16 of the block's rows (keys in dK/dV, queries
// in dQ); the streamed tiles have kTileRows rows whatever the block owns
constexpr int kDkdvWarps = 4;
constexpr int kDqWarps = 8;

// the block's own rows (16 a warp) of two bf16 arrays (dK/dV: K and V; dQ:
// Q and dO) and two stages of two streamed 64-row tiles (Q and dO; K and
// V), rows of hd + 8; then dK/dV's two stages of the query tile's L and D
constexpr size_t mma_smem_bytes(int hd, int warps) {
  return sizeof(bf16) * (size_t)(2 * 16 * warps + 4 * kTileRows) * (hd + 8) +
         sizeof(float) * 4 * kTileRows;
}

__device__ __forceinline__ unsigned pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Per-lane ldmatrix offsets (elements) into a tile of rows of kLd: the A
// operand of a warp's 16 rows from `row0` (matrices: rows 0-7 and 8-15 at
// columns 0-7, then at 8-15); the B operand from 16 rows taken as columns
// (rows 0-7 at k 0-7 and 8-15, then rows 8-15); the B operand of 16 rows
// taken as depth, transposed (rows 0-7 and 8-15 at columns 0-7, then 8-15).
template <int kLd> __device__ __forceinline__ int a_offset(int row0, int lane) {
  return (row0 + (lane & 15)) * kLd + (lane >> 4) * 8;
}
template <int kLd> __device__ __forceinline__ int b_offset(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8;
}
template <int kLd> __device__ __forceinline__ int bt_offset(int lane) {
  return (lane & 15) * kLd + (lane >> 4) * 8;
}

// P and dS of one 16 x 16 piece of scores, in place: s holds S (two 8-wide
// tiles) and becomes P, dp holds dP and becomes dS. Its rows are this lane's
// two fragment rows, its columns its four, keys along the rows (dK/dV) or
// along the columns (dQ). l and d: L * log2(e) and D of this lane's queries
// (four columns, or two rows). q0, k0: the positions of the piece's first
// query and key; mask: the piece crosses a mask.
template <bool kKeysAreRows>
__device__ __forceinline__ void p_and_ds(float (&s)[2][4], float (&dp)[2][4],
                                         const float (&l)[4], const float (&d)[4],
                                         int q0, int k0, const Shape& sh,
                                         float scale_log2, bool mask, int gq, int tq) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = gq + (e >> 1) * 8, col = t * 8 + 2 * tq + (e & 1);
      const int qi = kKeysAreRows ? 2 * t + (e & 1) : e >> 1;   // into l, d
      const int qpos = q0 + (kKeysAreRows ? col : row);
      const int key = k0 + (kKeysAreRows ? row : col);
      const bool ok = !mask || unmasked(sh, qpos, key);
      const float p = ok ? exp2f(fmaf(s[t][e], scale_log2, -l[qi])) : 0.f;
      s[t][e] = p;
      dp[t][e] = p * (dp[t][e] - d[qi]);
    }
}

// One block per (16 * WARPS-key tile, KV head, batch), WARPS warps x 16
// keys.
template <int HD, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ D,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, Shape sh,
                    Strides qs, Strides ks, Strides vs, int vec) {
  constexpr int R = kTileRows;    // rows of a streamed query tile
  constexpr int RK = 16 * WARPS;  // the block's keys
  static_assert(RK % R == 0, "the block's keys fill whole 64-row tiles");
  constexpr int KS = HD / 16;   // 16-wide steps over hd
  constexpr int DN = HD / 8;    // 8-wide column tiles of dK and dV
  constexpr int kLd = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + RK * kLd;
  bf16* sQ = sV + RK * kLd;          // 2 stages
  bf16* sG = sQ + 2 * R * kLd;       // dO, 2 stages
  float* sL = reinterpret_cast<float*>(sG + 2 * R * kLd);   // 2 stages
  float* sD = sL + 2 * R;                                    // 2 stages

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int group = sh.H / sh.KVH;
  const int k_lo = kt * RK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wk_lo = k_lo + warp * 16, wk_hi = wk_lo + 15;
  // the first kMmaThreads threads start the copies
  const bool loader = threadIdx.x < kMmaThreads;
  const float scale_log2 = sh.scale * kLog2e;

  // the query tiles that see a key of this tile (query positions from 0)
  int qt_begin = 0, qt_end = (sh.Sq + R - 1) / R;
  if (sh.causal) qt_begin = k_lo / R;
  if (sh.window > 0) qt_end = min(qt_end, (k_lo + RK - 1 + sh.window - 1) / R + 1);
  const int n_qt = max(qt_end - qt_begin, 0);
  const int n_iter = group * n_qt;   // (query head, query tile) in that order

  // tile `it`'s Q, dO, L and D into stage `stage`: L and D one word a
  // thread (threads 0-63 L, 64-127 D)
  auto load_q = [&](int it, int stage) {
    if (!loader) return;
    const int h = kh * group + it / n_qt;
    const int q_lo = (qt_begin + it % n_qt) * R;
    load_rows<HD>(sQ + stage * R * kLd, q + b * qs.b + h * qs.h, qs.s, q_lo, sh.Sq, vec);
    load_rows<HD>(sG + stage * R * kLd, dout + ((size_t)b * sh.Sq * sh.H + h) * HD,
                  (long long)sh.H * HD, q_lo, sh.Sq, vec);
    const int r = threadIdx.x & (R - 1);
    const bool ok = q_lo + r < sh.Sq;
    const float* src = (threadIdx.x < R ? lse : D) + ((size_t)b * sh.H + h) * sh.Sq;
    cp_async4((threadIdx.x < R ? sL : sD) + stage * R + r, src + (ok ? q_lo + r : 0),
              ok ? 4 : 0);
  };

  if (loader)
#pragma unroll
    for (int part = 0; part < RK / R; ++part) {
      load_rows<HD>(sK + part * R * kLd, k + b * ks.b + kh * ks.h, ks.s, k_lo + part * R,
                    sh.Skv, vec);
      load_rows<HD>(sV + part * R * kLd, v + b * vs.b + kh * vs.h, vs.s, k_lo + part * R,
                    sh.Skv, vec);
    }
  if (n_iter > 0) load_q(0, 0);
  cp_async_commit();

  const int a_off = a_offset<kLd>(warp * 16, lane);
  const int b_off = b_offset<kLd>(lane), t_off = bt_offset<kLd>(lane);
  float adk[DN][4], adv[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[dn][e] = adv[dn][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();
    // tile it is in shared memory for every thread, and every warp is done
    // with tile it - 1, whose stage the next loads refill
    __syncthreads();
    if (it + 1 < n_iter) {
      load_q(it + 1, buf ^ 1);
      cp_async_commit();
    }
    const int q_lo = (qt_begin + it % n_qt) * R;
    const bf16* sQt = sQ + buf * R * kLd;
    const bf16* sGt = sG + buf * R * kLd;
    const float* sLt = sL + buf * R;
    const float* sDt = sD + buf * R;

#pragma unroll 1
    for (int c = 0; c < R / 16; ++c) {   // 16 queries at a time
      const int cq_lo = q_lo + c * 16, cq_hi = cq_lo + 15;
      if (cq_lo >= sh.Sq) break;
      // a piece wholly masked for this warp's keys is skipped
      if (sh.causal && cq_hi < wk_lo) continue;
      if (sh.window > 0 && cq_lo - wk_hi >= sh.window) continue;

      // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x 16 queries, two 8-wide tiles
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        unsigned a[4], bb[4];
        ldmatrix_x4(a, sK + a_off + s * 16);
        ldmatrix_x4(bb, sQt + b_off + c * 16 * kLd + s * 16);
        mma_bf16(st[0], a, bb[0], bb[1]);
        mma_bf16(st[1], a, bb[2], bb[3]);
        ldmatrix_x4(a, sV + a_off + s * 16);
        ldmatrix_x4(bb, sGt + b_off + c * 16 * kLd + s * 16);
        mma_bf16(dpt[0], a, bb[0], bb[1]);
        mma_bf16(dpt[1], a, bb[2], bb[3]);
      }

      // this lane's four query columns: L * log2(e) and D
      float lq[4], dq4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c * 16 + (i >> 1) * 8 + 2 * tq + (i & 1);
        lq[i] = sLt[col] * kLog2e;
        dq4[i] = sDt[col];
      }
      const bool mask = cq_hi >= sh.Sq || wk_hi >= sh.Skv ||
                        (sh.causal && cq_lo < wk_hi) ||
                        (sh.window > 0 && cq_hi - wk_lo >= sh.window);
      p_and_ds<true>(st, dpt, lq, dq4, cq_lo, wk_lo, sh, scale_log2, mask, gq, tq);

      // P^T and dS^T as bf16 A fragments (16 keys x 16 queries)
      const unsigned ap[4] = {pack_bf16(st[0][0], st[0][1]), pack_bf16(st[0][2], st[0][3]),
                              pack_bf16(st[1][0], st[1][1]), pack_bf16(st[1][2], st[1][3])};
      const unsigned as[4] = {pack_bf16(dpt[0][0], dpt[0][1]), pack_bf16(dpt[0][2], dpt[0][3]),
                              pack_bf16(dpt[1][0], dpt[1][1]), pack_bf16(dpt[1][2], dpt[1][3])};
      // dV += P^T.dO, dK += dS^T.Q: B operands from ldmatrix.trans of the
      // 16 query rows
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {   // columns 16j .. 16j + 15
        unsigned bb[4];
        ldmatrix_x4_trans(bb, sGt + t_off + c * 16 * kLd + j * 16);
        mma_bf16(adv[2 * j], ap, bb[0], bb[1]);
        mma_bf16(adv[2 * j + 1], ap, bb[2], bb[3]);
        ldmatrix_x4_trans(bb, sQt + t_off + c * 16 * kLd + j * 16);
        mma_bf16(adk[2 * j], as, bb[0], bb[1]);
        mma_bf16(adk[2 * j + 1], as, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();   // with no query tile, K and V's copies are still open

  const int keys[2] = {wk_lo + gq, wk_lo + gq + 8};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= sh.Skv) continue;
    const size_t off = (((size_t)b * sh.Skv + keys[i]) * sh.KVH + kh) * HD;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int col = dn * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + col) = __floats2bfloat162_rn(
          adk[dn][2 * i] * sh.scale, adk[dn][2 * i + 1] * sh.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
          __floats2bfloat162_rn(adv[dn][2 * i], adv[dn][2 * i + 1]);
    }
  }
}

// One block per (16 * WARPS-query tile, head, batch), WARPS warps x 16
// queries.
template <int HD, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ D,
                  bf16* __restrict__ dq, Shape sh, Strides qs, Strides ks,
                  Strides vs, int vec) {
  constexpr int R = kTileRows;    // rows of a streamed key tile
  constexpr int RQ = 16 * WARPS;  // the block's queries
  static_assert(RQ % R == 0, "the block's queries fill whole 64-row tiles");
  constexpr int KS = HD / 16;
  constexpr int DN = HD / 8;
  constexpr int kLd = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + RQ * kLd;          // dO
  bf16* sK = sG + RQ * kLd;          // 2 stages
  bf16* sV = sK + 2 * R * kLd;       // 2 stages

  const int qt = gridDim.x - 1 - blockIdx.x;   // latest (longest) rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (sh.H / sh.KVH);
  const int q_lo = qt * RQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wq_lo = q_lo + warp * 16, wq_hi = wq_lo + 15;
  // the first kMmaThreads threads start the copies
  const bool loader = threadIdx.x < kMmaThreads;
  const float scale_log2 = sh.scale * kLog2e;
  const bf16* kb = k + b * ks.b + kh * ks.h;
  const bf16* vb = v + b * vs.b + kh * vs.h;

  int kt_end = (sh.Skv + R - 1) / R;
  if (sh.causal) kt_end = min(kt_end, (q_lo + RQ - 1) / R + 1);
  int kt_begin = 0;
  if (sh.window > 0 && q_lo - sh.window + 1 > 0) kt_begin = (q_lo - sh.window + 1) / R;

  if (loader)
#pragma unroll
    for (int part = 0; part < RQ / R; ++part) {
      load_rows<HD>(sQ + part * R * kLd, q + b * qs.b + h * qs.h, qs.s, q_lo + part * R,
                    sh.Sq, vec);
      load_rows<HD>(sG + part * R * kLd, dout + ((size_t)b * sh.Sq * sh.H + h) * HD,
                    (long long)sh.H * HD, q_lo + part * R, sh.Sq, vec);
    }
  if (loader && kt_begin < kt_end) {
    load_rows<HD>(sK, kb, ks.s, kt_begin * R, sh.Skv, vec);
    load_rows<HD>(sV, vb, vs.s, kt_begin * R, sh.Skv, vec);
  }
  cp_async_commit();

  // this lane's two rows: L * log2(e) and D
  const int rows[2] = {wq_lo + gq, wq_lo + gq + 8};
  float lr[4] = {0.f, 0.f, 0.f, 0.f}, dr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= sh.Sq) continue;
    const size_t at = ((size_t)b * sh.H + h) * sh.Sq + rows[i];
    lr[i] = lse[at] * kLog2e;
    dr[i] = D[at];
  }

  const int a_off = a_offset<kLd>(warp * 16, lane);
  const int b_off = b_offset<kLd>(lane), t_off = bt_offset<kLd>(lane);
  unsigned qf[KS][4], gf[KS][4];   // Q's and dO's A fragments
  float adq[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[dn][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    cp_async_wait<0>();
    // tile kt is in shared memory for every thread, and every warp is done
    // with tile kt - 1, whose stage the next loads refill
    __syncthreads();
    if (kt + 1 < kt_end) {
      if (loader) {
        load_rows<HD>(sK + (buf ^ 1) * R * kLd, kb, ks.s, (kt + 1) * R, sh.Skv, vec);
        load_rows<HD>(sV + (buf ^ 1) * R * kLd, vb, vs.s, (kt + 1) * R, sh.Skv, vec);
      }
      cp_async_commit();
    }
    if (kt == kt_begin) {
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        ldmatrix_x4(qf[s], sQ + a_off + s * 16);
        ldmatrix_x4(gf[s], sG + a_off + s * 16);
      }
    }
    const int k_lo = kt * R;
    const bf16* sKt = sK + buf * R * kLd;
    const bf16* sVt = sV + buf * R * kLd;

#pragma unroll 1
    for (int c = 0; c < R / 16; ++c) {   // 16 keys at a time
      const int ck_lo = k_lo + c * 16, ck_hi = ck_lo + 15;
      if (wq_lo >= sh.Sq || ck_lo >= sh.Skv) break;
      if (sh.causal && ck_lo > wq_hi) break;
      if (sh.window > 0 && wq_lo - ck_hi >= sh.window) continue;

      // S = Q.K^T and dP = dO.V^T: 16 queries x 16 keys
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[t][e] = dp[t][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        unsigned bb[4];
        ldmatrix_x4(bb, sKt + b_off + c * 16 * kLd + s * 16);
        mma_bf16(sc[0], qf[s], bb[0], bb[1]);
        mma_bf16(sc[1], qf[s], bb[2], bb[3]);
        ldmatrix_x4(bb, sVt + b_off + c * 16 * kLd + s * 16);
        mma_bf16(dp[0], gf[s], bb[0], bb[1]);
        mma_bf16(dp[1], gf[s], bb[2], bb[3]);
      }
      const bool mask = ck_hi >= sh.Skv || wq_hi >= sh.Sq ||
                        (sh.causal && ck_hi > wq_lo) ||
                        (sh.window > 0 && wq_hi - ck_lo >= sh.window);
      p_and_ds<false>(sc, dp, lr, dr, wq_lo, ck_lo, sh, scale_log2, mask, gq, tq);

      // dS as a bf16 A fragment (16 queries x 16 keys); dQ += dS.K with
      // B operands from ldmatrix.trans of the 16 key rows
      const unsigned as[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                              pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        unsigned bb[4];
        ldmatrix_x4_trans(bb, sKt + t_off + c * 16 * kLd + j * 16);
        mma_bf16(adq[2 * j], as, bb[0], bb[1]);
        mma_bf16(adq[2 * j + 1], as, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= sh.Sq) continue;
    bf16* row = dq + (((size_t)b * sh.Sq + rows[i]) * sh.H + h) * HD;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(row + dn * 8 + 2 * tq) = __floats2bfloat162_rn(
          adq[dn][2 * i] * sh.scale, adq[dn][2 * i + 1] * sh.scale);
  }
}

template <int HD>
int launch_mma(cudaStream_t st, int B, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* D, void* dq, void* dk,
               void* dv, Shape sh, Strides qs, Strides ks, Strides vs, int vec) {
  constexpr size_t smem_kv = mma_smem_bytes(HD, kDkdvWarps);
  constexpr size_t smem_q = mma_smem_bytes(HD, kDqWarps);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaSuccess;
    const void* fns[2] = {reinterpret_cast<const void*>(bwd_dkdv_mma_kernel<HD, kDkdvWarps>),
                          reinterpret_cast<const void*>(bwd_dq_mma_kernel<HD, kDqWarps>)};
    const size_t smem[2] = {smem_kv, smem_q};
    for (int i = 0; i < 2; ++i) {
      const void* fn = fns[i];
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem[i]));
      if (e == cudaSuccess)   // as much shared memory as L1 allows: more blocks
        e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid_kv((sh.Skv + 16 * kDkdvWarps - 1) / (16 * kDkdvWarps), sh.KVH, B);
  bwd_dkdv_mma_kernel<HD, kDkdvWarps><<<grid_kv, 32 * kDkdvWarps, smem_kv, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, D, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      sh, qs, ks, vs, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_q((sh.Sq + 16 * kDqWarps - 1) / (16 * kDqWarps), sh.H, B);
  bwd_dq_mma_kernel<HD, kDqWarps><<<grid_q, 32 * kDqWarps, smem_q, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, D, static_cast<bf16*>(dq), sh, qs, ks, vs, vec);
  return static_cast<int>(cudaGetLastError());
}

// one instantiation per head dim: every offset is a constant
template <int HD>
int launch_mma_hd(cudaStream_t st, int B, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* D, void* dq, void* dk,
                  void* dv, Shape sh, Strides qs, Strides ks, Strides vs, int vec) {
  if (sh.hd == HD)
    return launch_mma<HD>(st, B, q, k, v, dout, lse, D, dq, dk, dv, sh, qs, ks, vs, vec);
  if constexpr (HD > 16)
    return launch_mma_hd<HD - 16>(st, B, q, k, v, dout, lse, D, dq, dk, dv, sh, qs, ks, vs, vec);
  return static_cast<int>(cudaErrorInvalidValue);
}

// D = rowsum(dO o O), then the route's dK/dV and dQ kernels
template <typename T>
int launch_all(cudaStream_t st, int B, const void* q, const void* k,
               const void* v, const void* o, const void* dout, const float* lse,
               float* D, void* dq, void* dk, void* dv, Shape sh, Strides qs,
               Strides ks, Strides vs, int route, int vec) {
  const long long rows = (long long)B * sh.Sq * sh.H;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  bwd_dot_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), D, B, sh.Sq, sh.H, sh.hd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (route == 1)
    return launch_mma_hd<kTcMaxHd>(st, B, q, k, v, dout, lse, D, dq, dk, dv, sh, qs, ks, vs, vec);
  if (sh.hd <= 64)
    return launch<T, 64, 64>(st, B, q, k, v, dout, lse, D, dq, dk, dv, sh, qs, ks, vs);
  if (sh.hd <= 128)
    return launch<T, 64, 128>(st, B, q, k, v, dout, lse, D, dq, dk, dv, sh, qs, ks, vs);
  return launch<T, 32, 256>(st, B, q, k, v, dout, lse, D, dq, dk, dv, sh, qs, ks, vs);
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (B, Sq, H, hd), k/v: (B, Skv, KVH, hd), each with unit stride on hd and
// the given (batch, position, head) strides in elements; o, dout: contiguous
// (B, Sq, H, hd); lse: contiguous f32 (B, H, Sq), the forward's; D: f32
// scratch of B * H * Sq; dq: contiguous (B, Sq, H, hd), dk/dv: contiguous
// (B, Skv, KVH, hd). Query positions start at 0. window 0 = no window.
// is_bf16: 1 for bf16, 0 for f32. route: 1 = tensor cores (bf16, hd % 16 ==
// 0, hd <= 128), 0 = CUDA cores; a route the inputs do not fit is refused,
// never replaced by the other.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const void* lse, void* D, void* dq, void* dk,
                                   void* dv, int B, int Sq, int Skv, int H,
                                   int KVH, int hd, long long q_sb,
                                   long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb,
                                   long long v_ss, long long v_sh, int causal,
                                   int window, int is_bf16, int route,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH != 0 || hd < 1 ||
      hd > kMaxHd || window < 0 || H > 65535 || B > 65535 || route < 0 ||
      route > 1 || (route == 1 && (!is_bf16 || hd % 16 != 0 || hd > kTcMaxHd)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{Sq, Skv, H, KVH, hd, causal, window,
                 1.0f / sqrtf(static_cast<float>(hd))};
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  // 16-byte copies need every base pointer and stride 16-byte aligned (dO's
  // row stride is H * hd, a multiple of 8 on the tensor-core route)
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  int vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
             reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
  for (long long s : strides) vec = vec && s % 8 == 0;
  return is_bf16
      ? launch_all<__nv_bfloat16>(st, B, q, k, v, o, dout, l, d, dq, dk, dv, sh, qs, ks, vs, route, vec)
      : launch_all<float>(st, B, q, k, v, o, dout, l, d, dq, dk, dv, sh, qs, ks, vs, route, vec);
}
