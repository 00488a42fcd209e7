// Prefill flash attention: causal / sliding-window softmax attention over a
// whole prompt, never holding the (Sq, Skv) score matrix.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_fwd (body
// _flash_kernel), and with it the wrapper's KV repeat, fold and padding
// (src/repro/kernels/ops.py, flash_attention). It reads the public layout
// q (B, Sq, H, hd), k/v (B, Skv, KVH, hd) directly through strides; a query
// head h reads KV head h / (H / KVH), so nothing is repeated or copied. The
// masks are those of _flash_kernel: causal, window, and keys past Skv (the
// kernel masks its own ragged edges); query and key positions both start
// at 0, as a prefill into a fresh cache has them.
//
// Bound on the H100: operations. A causal prefill of S tokens does about
// 2 * S^2 * hd flops per head against 4 * S * hd bytes of q/k/v/out, far
// above the ~295 flops/byte ridge, so the limit is arithmetic.
//
// Design: one block of 256 threads per (64-query tile, head, batch). The
// query tile and each 64-key K/V tile are staged in shared memory as f32
// (rows padded by one word against bank conflicts); each thread computes a
// 4x4 block of scores and holds 4 output rows x hd/16 columns in registers,
// with the online softmax (m, l) in f32 per row. Key tiles that are wholly
// causally dead or outside the window are never loaded. Query tiles run
// latest first, so the longest causal rows start first. The arithmetic runs
// on CUDA cores in f32; mma.sync/wgmma tensor-core tiles are later work.
// A query row with no unmasked key (window > 0 and q_pos >= Skv + window - 1,
// causal or not) gets what the plain version gives it: every score is
// -1e30, the softmax is uniform, so the row is the f32 mean of V over keys
// [0, Skv), cast to q's type. The main kernel skips those rows (and whole
// query tiles of them), and a second small kernel, launched only when such
// rows exist, writes them; the normal path is unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
             int H, int KVH, int hd, Strides qs, Strides ks, Strides vs,
             int causal, int window, float scale) {
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
  // rows from q_empty on have no unmasked key: empty_rows_kernel writes them
  const long long q_empty = window > 0 ? (long long)Skv + window - 1 : Sq;
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
  if (causal) kt_end = min(kt_end, (q_lo + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / BK;

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
      const int qpos = q_lo + ty + 16 * i;
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
    T* orow = o + (((size_t)b * Sq + qpos) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) orow[d] = from_f32<T>(acc[i][c] * inv);
    }
  }
}

// Rows q_pos in [q_empty, Sq) of head h, batch b: the f32 mean of V over
// keys [0, Skv), one thread per column, summed in key order.
template <typename T>
__global__ void empty_rows_kernel(const T* __restrict__ v, T* __restrict__ o,
                                  int Sq, int Skv, int H, int KVH, int hd,
                                  Strides vs, int q_empty) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (H / KVH);
  const T* vb = v + b * vs.b + kh * vs.h;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float sum = 0.f;
    for (int pos = 0; pos < Skv; ++pos) sum += to_f32(vb[pos * vs.s + d]);
    const T mean = from_f32<T>(sum / static_cast<float>(Skv));
    for (int qpos = q_empty; qpos < Sq; ++qpos)
      o[(((size_t)b * Sq + qpos) * H + h) * hd + d] = mean;
  }
}

template <typename T, int HDM>
int launch(dim3 grid, size_t smem, cudaStream_t st, const void* q,
           const void* k, const void* v, void* o, int Sq, int Skv, int H,
           int KVH, int hd, Strides qs, Strides ks, Strides vs, int causal,
           int window, float scale) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, HDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_kernel<T, HDM><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KVH, hd, qs,
      ks, vs, causal, window, scale);
  return 0;
}

template <typename T>
int launch_hd(dim3 grid, size_t smem, cudaStream_t st, const void* q,
              const void* k, const void* v, void* o, int Sq, int Skv, int H,
              int KVH, int hd, Strides qs, Strides ks, Strides vs, int causal,
              int window, float scale) {
  if (hd <= 64)
    return launch<T, 64>(grid, smem, st, q, k, v, o, Sq, Skv, H, KVH, hd, qs, ks, vs, causal, window, scale);
  if (hd <= 128)
    return launch<T, 128>(grid, smem, st, q, k, v, o, Sq, Skv, H, KVH, hd, qs, ks, vs, causal, window, scale);
  return launch<T, 256>(grid, smem, st, q, k, v, o, Sq, Skv, H, KVH, hd, qs, ks, vs, causal, window, scale);
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (B, Sq, H, hd), k/v: (B, Skv, KVH, hd), each with unit stride on hd and
// the given (batch, position, head) strides in elements; o: contiguous
// (B, Sq, H, hd). window 0 = no window. is_bf16: 1 for bf16, 0 for f32.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Skv, int H, int KVH,
                               int hd, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, int causal, int window,
                               int is_bf16, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH != 0 || hd < 1 ||
      hd > 256 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const size_t smem = smem_bytes(hd);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = is_bf16
      ? launch_hd<__nv_bfloat16>(grid, smem, st, q, k, v, o, Sq, Skv, H, KVH, hd, qs, ks, vs, causal, window, scale)
      : launch_hd<float>(grid, smem, st, q, k, v, o, Sq, Skv, H, KVH, hd, qs, ks, vs, causal, window, scale);
  if (rc != 0) return rc;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (window > 0 && (long long)Sq > (long long)Skv + window - 1) {
    const int q_empty = Skv + window - 1;
    const dim3 rows_grid(H, B);
    const int threads = ((hd + 31) / 32) * 32;
    if (is_bf16)
      empty_rows_kernel<__nv_bfloat16><<<rows_grid, threads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, H, KVH, hd, vs, q_empty);
    else
      empty_rows_kernel<float><<<rows_grid, threads, 0, st>>>(
          static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, KVH, hd, vs, q_empty);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}
