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
//                                          (bwd_dkdv_kernel)
//   dQ = dS K / sqrt(hd)                  (bwd_dq_kernel)
// Layouts are the forward's: q (B, Sq, H, hd), k/v (B, Skv, KVH, hd), read
// through their (batch, position, head) strides with unit stride on hd;
// O and dO contiguous (B, Sq, H, hd). dQ is written contiguous (B, Sq, H,
// hd), dK and dV contiguous (B, Skv, KVH, hd), in the inputs' dtype.
//
// Scope: what training reaches. Query positions start at 0 (no q_offset);
// causal with or without a window, or unmasked; every query row has at least
// one unmasked key (the wrapper refuses rows without one); hd <= 256.
//
// Bound on the H100: operations. Per unmasked (query, key) pair and head the
// two kernels do 14 * hd flops (S and dP twice, dV, dK, dQ), about 3.5 times
// the forward's 4 * hd, against some 10 * S * hd bytes per head.
//
// Design: a first, simple kernel, on CUDA cores in f32 for f32 and bf16
// inputs alike (bf16 is widened as it is loaded into shared memory), as the
// forward's CUDA-core route is. Tiles of BM = 64 queries and 64 keys (32 of
// each above hd 128, to stay in shared memory), 256 threads as 16 x 16, each
// thread holding a 4 x 4 (2 x 2) block of scores and R rows x hd / 16
// columns of its f32 accumulators in registers.
//   bwd_dkdv_kernel: one block per (key tile, KV head, batch). It loops over
//   the H / KVH query heads of its KV head and, for each, over the query
//   tiles that see a key of its tile, so GQA's sum over the group happens in
//   the block's registers: no atomics. Key tile 0 (the longest causal loop)
//   starts first.
//   bwd_dq_kernel: one block per (query tile, head, batch), looping over the
//   key tiles its rows see, latest query tile first.
// No atomics anywhere and every sum in a fixed order: two launches on the
// same inputs give the same bits (a crash-and-resume training run depends on
// it). Tensor cores (wgmma with TMA) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
int launch_all(cudaStream_t st, int B, const void* q, const void* k,
               const void* v, const void* o, const void* dout, const float* lse,
               float* D, void* dq, void* dk, void* dv, Shape sh, Strides qs,
               Strides ks, Strides vs) {
  const long long rows = (long long)B * sh.Sq * sh.H;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  bwd_dot_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), D, B, sh.Sq, sh.H, sh.hd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
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
// is_bf16: 1 for bf16, 0 for f32.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const void* lse, void* D, void* dq, void* dk,
                                   void* dv, int B, int Sq, int Skv, int H,
                                   int KVH, int hd, long long q_sb,
                                   long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb,
                                   long long v_ss, long long v_sh, int causal,
                                   int window, int is_bf16, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH != 0 || hd < 1 ||
      hd > kMaxHd || window < 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{Sq, Skv, H, KVH, hd, causal, window,
                 1.0f / sqrtf(static_cast<float>(hd))};
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  return is_bf16
      ? launch_all<__nv_bfloat16>(st, B, q, k, v, o, dout, l, d, dq, dk, dv, sh, qs, ks, vs)
      : launch_all<float>(st, B, q, k, v, o, dout, l, d, dq, dk, dv, sh, qs, ks, vs);
}
