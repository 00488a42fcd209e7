// Prefill flash attention: causal / sliding-window softmax attention over a
// whole prompt, never holding the (Sq, Skv) score matrix.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_fwd (body
// _flash_kernel), and with it the wrapper's KV repeat, fold and padding
// (src/repro/kernels/ops.py, flash_attention). It reads the public layout
// q (B, Sq, H, hd), k/v (B, Skv, KVH, hd) directly through strides; a query
// head h reads KV head h / (H / KVH), so nothing is repeated or copied. The
// masks are those of _flash_kernel: causal, window, and keys past Skv (the
// kernel masks its own ragged edges). Key positions start at 0; query row r
// sits at position q_off + r (q_off >= 0): 0 for a prefill into a fresh
// cache, the chunk's distance from its first key for a later chunk of a
// chunked prefill (serve/dispatch_engine.py), whose keys are the prompt's
// rows up to the chunk's end.
//
// Bound on the H100: operations. A causal prefill of S tokens does about
// 2 * S^2 * hd flops per head against 4 * S * hd bytes of q/k/v/out, far
// above the ~295 flops/byte ridge, so the limit is arithmetic.
//
// Two routes, chosen by the caller (kernels/flash_attention.py, route())
// from the dtype and head_dim alone; neither is ever taken because the
// other failed.
//
// Tensor cores (route 1: bf16, hd a multiple of 16 up to 256),
// flash_mma_kernel: FlashAttention-2 on mma.sync.m16n8k16 (bf16 in, f32
// accumulators). One block of 4 warps per (64-query tile, head, batch),
// each warp owning 16 query rows. The query tile and 64-key K/V tiles sit
// in shared memory as bf16, rows padded by 16 bytes so that ldmatrix reads
// are free of bank conflicts; K/V tiles arrive through 16-byte cp.async
// copies, double-buffered (tile j + 1 loads while tile j computes), or,
// where a base pointer or stride is not 16-byte aligned, through 2-byte
// loads. For hd <= 128 the warp's Q fragments stay in registers for the
// whole block (above hd 128 they are re-read from shared memory, leaving
// registers for the up to 128 f32 output accumulators a thread holds). Per key
// tile: S = Q.K^T on the tensor cores; S * log2(e) / sqrt(hd) in f32 (the
// scale never touches the bf16 inputs); causal, window and key < Skv masks
// on the accumulator fragment (tiles wholly inside the masks skip them);
// online softmax (m, l) in f32, base 2, row max over the 4 lanes of a quad;
// P split in registers into bf16(P) and bf16(P - bf16(P)), both fed
// straight back as A operands of O += P.V, whose B operand comes from
// ldmatrix.trans of the V tile. P in bf16 alone (8 significant bits) would
// move outputs by up to 2^-9 of max |V| where V rows of opposite sign
// cancel, which on granite-3-8b's own activations (scores in the hundreds,
// |V| in the tens) leaves chip_smoke.py's bf16 band of 1e-2 (1 + |out|);
// the second product keeps P to about 16 bits. The f32 output is
// normalised by 1 / l and stored as bf16. The copies, fragment loads,
// product and split, and the tile loader are mma_bf16.cuh's, which the
// backward (flash_attention_bwd.cu) shares.
//
// CUDA cores (route 0: f32, and bf16 with other head dims), flash_kernel:
// one block of 256 threads per (64-query tile, head, batch). The query tile
// and each 64-key K/V tile are staged in shared memory as f32 (rows padded
// by one word against bank conflicts); each thread computes a 4x4 block of
// scores and holds 4 output rows x hd/16 columns in registers, with the
// online softmax (m, l) in f32 per row, all in f32 on CUDA cores: phase 4
// of chip_smoke.py holds every f32 call within 1e-4 of an f64 run, which
// TF32 tensor cores cannot.
//
// Log-sum-exp (both routes): given a non-null `lse`, the kernels also
// write each row's f32 log-sum-exp of its scaled scores, natural log,
// shaped (B, H, Sq), which the backward (flash_attention_bwd.cu) reads to
// recompute P. CUDA cores keep m and l of the scaled scores: lse = m +
// log(l). The tensor cores keep m of the raw scores and l of base-2
// exponents: lse = (m * scale_log2 + log2(l)) * ln 2. Rows with no
// unmasked key get -1e30, the plain version's logsumexp of scores that
// are all -1e30 (f32 and f64 alike). With `lse` null nothing else changes:
// the output bits are those of the kernels without it.
//
// Both: key tiles that are wholly causally dead or outside the window are
// never loaded, and query tiles run latest first, so the longest causal
// rows start first. A query row with no unmasked key (window > 0 and
// q_off + r >= Skv + window - 1, causal or not) gets what the plain version
// gives it: every score is -1e30, the softmax is uniform, so the row is the
// f32 mean of V over keys [0, Skv), cast to q's type. The main kernels skip
// those rows (and whole query tiles of them), and a second small kernel,
// launched only when such rows exist, writes them. Rows are indices from 0,
// positions (masks, tile ranges) are q_off + row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int kThreads = 256; // 16 x 16: ty picks rows, tx picks keys/columns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reductions over the 16 lanes that share a ty (one half-warp)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {
  long long b, s, h;   // elements between batches, positions, heads
};

size_t smem_bytes(int hd) {
  const int ld = hd + 1;
  return sizeof(float) * (size_t)(BQ * ld + BK * ld + BK * hd + BQ * (BK + 1));
}

// HDM: most head dim this instantiation holds (hd <= HDM, HDM % 16 == 0).
template <typename T, int HDM>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int Sq, int Skv,
             int H, int KVH, int hd, Strides qs, Strides ks, Strides vs,
             int causal, int window, int q_off, float scale) {
  constexpr int CD = HDM / 16;   // output columns per thread
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* sQ = smem;              // BQ x ld
  float* sK = sQ + BQ * ld;      // BK x ld
  float* sV = sK + BK * ld;      // BK x hd
  float* sP = sV + BK * hd;      // BQ x (BK + 1)

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int q_lo = qt * BQ;
  const int p_lo = q_off + q_lo;   // position of the tile's first row
  // rows from q_empty on have no unmasked key: empty_rows_kernel writes them
  const long long q_empty = window > 0 ? (long long)Skv + window - 1 - q_off : Sq;
  if (q_lo >= q_empty) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int i = tid; i < BQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int pos = q_lo + r;
    sQ[r * ld + d] = pos < Sq ? to_f32(qb[pos * qs.s + d]) * scale : 0.f;
  }

  int kt_end = (Skv + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (p_lo + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && p_lo - window + 1 > 0) kt_begin = (p_lo - window + 1) / BK;

  float m_i[4], l_i[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -1e30f;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();   // the previous tile's sK/sV/sP are consumed
    for (int i = tid; i < BK * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const int pos = k_lo + r;
      const bool ok = pos < Skv;
      sK[r * ld + d] = ok ? to_f32(kb[pos * ks.s + d]) : 0.f;
      sV[r * hd + d] = ok ? to_f32(vb[pos * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = sK[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * kk[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = p_lo + ty + 16 * i;
      bool ok[4];
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_lo + tx + 16 * j;
        ok[j] = kpos < Skv && (!causal || qpos >= kpos) &&
                (window <= 0 || qpos - kpos < window);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], half_max(mx));
      const float alpha = expf(m_i[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        psum += p;
      }
      l_i[i] = l_i[i] * alpha + half_sum(psum);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int c0 = 0; c0 < BK; ++c0) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * (BK + 1) + c0];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < hd ? sV[c0 * hd + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_lo + ty + 16 * i;
    if (qpos >= Sq || qpos >= q_empty) continue;
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * Sq + qpos] = m_i[i] + logf(l_i[i]);
    T* orow = o + (((size_t)b * Sq + qpos) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) orow[d] = from_f32<T>(acc[i][c] * inv);
    }
  }
}

// Rows [q_empty, Sq) of head h, batch b: the f32 mean of V over keys
// [0, Skv), one thread per column, summed in key order; their lse -1e30.
template <typename T>
__global__ void empty_rows_kernel(const T* __restrict__ v, T* __restrict__ o,
                                  float* __restrict__ lse, int Sq, int Skv,
                                  int H, int KVH, int hd, Strides vs,
                                  int q_empty) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (H / KVH);
  if (lse != nullptr)
    for (int qpos = q_empty + threadIdx.x; qpos < Sq; qpos += blockDim.x)
      lse[((size_t)b * H + h) * Sq + qpos] = -1e30f;
  const T* vb = v + b * vs.b + kh * vs.h;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float sum = 0.f;
    for (int pos = 0; pos < Skv; ++pos) sum += to_f32(vb[pos * vs.s + d]);
    const T mean = from_f32<T>(sum / static_cast<float>(Skv));
    for (int qpos = q_empty; qpos < Sq; ++qpos)
      o[(((size_t)b * Sq + qpos) * H + h) * hd + d] = mean;
  }
}

// ------------------------------------------------------------------------
// Tensor-core route (bf16)
// ------------------------------------------------------------------------

constexpr size_t mma_smem_bytes(int hd) {
  // Q tile, then two stages of K and of V, rows of hd + 8 bf16
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BK) * (hd + 8);
}

// HD: the head dim, a multiple of 16. scale_log2 = log2(e) / sqrt(HD).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int H,
                 int KVH, Strides qs, Strides ks, Strides vs, int causal,
                 int window, int q_off, float scale_log2, int vec) {
  constexpr int KS = HD / 16;             // 16-wide steps over hd
  constexpr int DN = HD / 8;              // 8-wide output column tiles
  constexpr int kLd = HD + 8;             // 16 bytes of padding a row
  constexpr bool kQInRegs = HD <= 128;
  constexpr int kSUnroll = kQInRegs ? KS : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * kLd;      // 2 stages x BK x kLd
  __nv_bfloat16* sV = sK + 2 * BK * kLd;  // 2 stages x BK x kLd

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int q_lo = qt * BQ;
  const int p_lo = q_off + q_lo;   // position of the tile's first row
  // rows from q_empty on have no unmasked key: empty_rows_kernel writes them
  const long long q_empty = window > 0 ? (long long)Skv + window - 1 - q_off : Sq;
  if (q_lo >= q_empty) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;   // fragment row group, lane in quad

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kh * vs.h;

  int kt_end = (Skv + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (p_lo + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && p_lo - window + 1 > 0) kt_begin = (p_lo - window + 1) / BK;

  load_rows<HD>(sQ, qb, qs.s, q_lo, Sq, vec);
  load_rows<HD>(sK, kb, ks.s, kt_begin * BK, Skv, vec);
  load_rows<HD>(sV, vb, vs.s, kt_begin * BK, Skv, vec);
  cp_async_commit();

  // this warp's 16 query rows: row0 holds fragment rows 0-7, row1 8-15;
  // wp_lo/wp_hi and pos0/pos1 are their positions
  const int wq_lo = q_lo + warp * 16;
  const int wp_lo = q_off + wq_lo, wp_hi = wp_lo + 15;
  const int row0 = wq_lo + gq, row1 = row0 + 8;
  const int pos0 = q_off + row0, pos1 = pos0 + 8;
  // per-lane ldmatrix offsets (elements) into Q, K and V tiles
  const int qf_off = (warp * 16 + (lane & 15)) * kLd + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * kLd + (lane >> 4) * 8;
  unsigned qf[kQInRegs ? KS : 1][4];
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  // running max of the raw scores, and the running sum, per fragment row
  float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    cp_async_wait<0>();
    // tile kt is in shared memory for every thread, and every warp is done
    // with tile kt - 1, whose stage the next loads refill
    __syncthreads();
    if (kt + 1 < kt_end) {
      load_rows<HD>(sK + (buf ^ 1) * BK * kLd, kb, ks.s, (kt + 1) * BK, Skv, vec);
      load_rows<HD>(sV + (buf ^ 1) * BK * kLd, vb, vs.s, (kt + 1) * BK, Skv, vec);
      cp_async_commit();
    }
    if (kQInRegs && kt == kt_begin) {
#pragma unroll
      for (int s = 0; s < KS; ++s) ldmatrix_x4(qf[kQInRegs ? s : 0], sQ + qf_off + s * 16);
    }
    const int k_lo = kt * BK;
    // a warp whose 16 rows see no key of this tile skips it
    const bool live = !(causal && wp_hi < k_lo) &&
                      !(window > 0 && wp_lo - (k_lo + BK - 1) >= window);
    if (!live) continue;
    const __nv_bfloat16* sKt = sK + buf * BK * kLd;
    const __nv_bfloat16* sVt = sV + buf * BK * kLd;

    // S = Q.K^T: 8 tiles of 16 rows x 8 keys
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    // above hd 128 Q comes from shared memory and the step loop stays
    // rolled in pairs, which keeps the registers for the 128 f32 output
    // accumulators a thread holds at hd 256
#pragma unroll kSUnroll
    for (int s = 0; s < KS; ++s) {
      unsigned a[4];
      if (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kQInRegs ? s : 0][e];
      } else {
        ldmatrix_x4(a, sQ + qf_off + s * 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // keys 16j .. 16j + 15
        unsigned kf[4];
        ldmatrix_x4(kf, sKt + k_off + j * 16 * kLd + s * 16);
        mma_bf16(sc[2 * j], a, kf[0], kf[1]);
        mma_bf16(sc[2 * j + 1], a, kf[2], kf[3]);
      }
    }

    // mask on the fragment where the tile crosses an edge: masked raw
    // scores are -inf; m starts at -1e30, so exp2 gives them 0
    const bool edge = k_lo + BK > Skv || (causal && k_lo + BK - 1 > wp_lo) ||
                      (window > 0 && wp_hi - k_lo >= window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int pos = e < 2 ? pos0 : pos1;
          const int key = k_lo + nt * 8 + 2 * tq + (e & 1);
          const bool ok = key < Skv && (!causal || pos >= key) &&
                          (window <= 0 || pos - key < window);
          if (!ok) sc[nt][e] = __int_as_float(0xff800000);   // -inf
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    }
    // softmax in base 2: p = exp2(s * scale_log2 - m * scale_log2), the
    // scale applied in f32 inside one FFMA
    float alpha[2], m_scaled[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f((m_r[i] - mx[i]) * scale_log2);
      m_r[i] = mx[i];
      m_scaled[i] = mx[i] * scale_log2;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // O += P.V, 16 keys at a time: P's fragments, split into a bf16 part
    // and the bf16 of its rounding error, are the A operands of two MMAs
    // into the same accumulators; V's come from ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      float p[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[t][e] = exp2f(fmaf(sc[2 * kc + t][e], scale_log2, -m_scaled[e >> 1]));
          l_r[e >> 1] += p[t][e];
        }
      unsigned a[4], r[4];
      split_bf16(p[0][0], p[0][1], a[0], r[0]);
      split_bf16(p[0][2], p[0][3], a[1], r[1]);
      split_bf16(p[1][0], p[1][1], a[2], r[2]);
      split_bf16(p[1][2], p[1][3], a[3], r[3]);
#pragma unroll
      for (int j = 0; j < DN / 2; ++j) {   // columns 16j .. 16j + 15
        unsigned vf[4];
        ldmatrix_x4_trans(vf, sVt + v_off + kc * 16 * kLd + j * 16);
        mma_bf16(acc[2 * j], a, vf[0], vf[1]);
        mma_bf16(acc[2 * j], r, vf[0], vf[1]);
        mma_bf16(acc[2 * j + 1], a, vf[2], vf[3]);
        mma_bf16(acc[2 * j + 1], r, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  const float inv[2] = {1.f / fmaxf(l_r[0], 1e-30f), 1.f / fmaxf(l_r[1], 1e-30f)};
  const int rows[2] = {row0, row1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Sq || rows[i] >= q_empty) continue;
    if (lse != nullptr && tq == 0)
      lse[((size_t)b * H + h) * Sq + rows[i]] =
          (m_r[i] * scale_log2 + log2f(l_r[i])) * 0.69314718055994531f;
    __nv_bfloat16* orow = o + (((size_t)b * Sq + rows[i]) * H + h) * HD;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[dn][2 * i] * inv[i], acc[dn][2 * i + 1] * inv[i]);
  }
}

template <int HD>
int launch_mma(dim3 grid, cudaStream_t st, const void* q, const void* k,
               const void* v, void* o, float* lse, int Sq, int Skv, int H, int KVH,
               Strides qs, Strides ks, Strides vs, int causal, int window,
               int q_off, int vec) {
  constexpr size_t smem = mma_smem_bytes(HD);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess)   // as much shared memory as L1 allows: more blocks
      e = cudaFuncSetAttribute(flash_mma_kernel<HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  flash_mma_kernel<HD><<<grid, kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      Sq, Skv, H, KVH, qs, ks, vs, causal, window, q_off, scale_log2, vec);
  return 0;
}

// one instantiation per head dim: every offset is a constant
template <int HD>
int launch_mma_hd(int hd, dim3 grid, cudaStream_t st, const void* q,
                  const void* k, const void* v, void* o, float* lse, int Sq,
                  int Skv, int H, int KVH, Strides qs, Strides ks, Strides vs,
                  int causal, int window, int q_off, int vec) {
  if (hd == HD)
    return launch_mma<HD>(grid, st, q, k, v, o, lse, Sq, Skv, H, KVH, qs, ks, vs, causal, window, q_off, vec);
  if constexpr (HD > 16)
    return launch_mma_hd<HD - 16>(hd, grid, st, q, k, v, o, lse, Sq, Skv, H, KVH, qs, ks, vs, causal, window, q_off, vec);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------------------
// CUDA-core route
// ------------------------------------------------------------------------

template <typename T, int HDM>
int launch(dim3 grid, size_t smem, cudaStream_t st, const void* q,
           const void* k, const void* v, void* o, float* lse, int Sq, int Skv, int H,
           int KVH, int hd, Strides qs, Strides ks, Strides vs, int causal,
           int window, int q_off, float scale) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, HDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_kernel<T, HDM><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Skv, H, KVH, hd,
      qs, ks, vs, causal, window, q_off, scale);
  return 0;
}

template <typename T>
int launch_hd(dim3 grid, size_t smem, cudaStream_t st, const void* q,
              const void* k, const void* v, void* o, float* lse, int Sq, int Skv, int H,
              int KVH, int hd, Strides qs, Strides ks, Strides vs, int causal,
              int window, int q_off, float scale) {
  if (hd <= 64)
    return launch<T, 64>(grid, smem, st, q, k, v, o, lse, Sq, Skv, H, KVH, hd, qs, ks, vs, causal, window, q_off, scale);
  if (hd <= 128)
    return launch<T, 128>(grid, smem, st, q, k, v, o, lse, Sq, Skv, H, KVH, hd, qs, ks, vs, causal, window, q_off, scale);
  return launch<T, 256>(grid, smem, st, q, k, v, o, lse, Sq, Skv, H, KVH, hd, qs, ks, vs, causal, window, q_off, scale);
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (B, Sq, H, hd), k/v: (B, Skv, KVH, hd), each with unit stride on hd and
// the given (batch, position, head) strides in elements; o: contiguous
// (B, Sq, H, hd); lse: null, or a contiguous f32 (B, H, Sq) that receives
// each row's log-sum-exp. window 0 = no window. q_off >= 0: the position
// of query row 0 counted from key 0. is_bf16: 1 for bf16, 0 for f32.
// route: 1 = tensor cores (bf16, hd % 16 == 0), 0 = CUDA cores; a route the
// inputs do not fit is refused, never replaced by the other.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* lse_ptr, int B, int Sq, int Skv, int H, int KVH,
                               int hd, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, int causal, int window,
                               int q_off, int is_bf16, int route,
                               void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH != 0 || hd < 1 ||
      q_off < 0 || window < 0 ||
      hd > 256 || H > 65535 || B > 65535 || route < 0 || route > 1 ||
      (route == 1 && (!is_bf16 || hd % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_ptr);
  int rc;
  if (route == 1) {
    // 16-byte copies need every base pointer and stride 16-byte aligned
    const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    int vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
               reinterpret_cast<uintptr_t>(v)) % 16 == 0;
    for (long long s : strides) vec = vec && s % 8 == 0;
    rc = launch_mma_hd<256>(hd, grid, st, q, k, v, o, lse, Sq, Skv, H, KVH, qs, ks, vs, causal, window, q_off, vec);
  } else {
    const size_t smem = smem_bytes(hd);
    const float scale = 1.0f / sqrtf(static_cast<float>(hd));
    rc = is_bf16
        ? launch_hd<__nv_bfloat16>(grid, smem, st, q, k, v, o, lse, Sq, Skv, H, KVH, hd, qs, ks, vs, causal, window, q_off, scale)
        : launch_hd<float>(grid, smem, st, q, k, v, o, lse, Sq, Skv, H, KVH, hd, qs, ks, vs, causal, window, q_off, scale);
  }
  if (rc != 0) return rc;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // rows from q_empty on have no unmasked key (all of them if it is <= 0)
  const long long q_empty_ll = (long long)Skv + window - 1 - q_off;
  if (window > 0 && (long long)Sq > q_empty_ll) {
    const int q_empty = q_empty_ll > 0 ? static_cast<int>(q_empty_ll) : 0;
    const dim3 rows_grid(H, B);
    const int threads = ((hd + 31) / 32) * 32;
    if (is_bf16)
      empty_rows_kernel<__nv_bfloat16><<<rows_grid, threads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, H, KVH, hd, vs, q_empty);
    else
      empty_rows_kernel<float><<<rows_grid, threads, 0, st>>>(
          static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Skv, H, KVH, hd, vs, q_empty);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}
