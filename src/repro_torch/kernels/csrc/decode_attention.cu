// Decode attention: one step of grouped-query attention over a KV cache.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_grouped
// (body _decode_kernel). Same function, widened in one way: the number of
// valid cache slots is per row (lengths[b]); the Pallas contract's scalar
// length is the broadcast case.
//
// Bound on the H100: bytes. Each (b, kv head) reads lengths[b] rows of K and
// V once and does 4 * G * hd flops per row, about G flops per byte in bf16,
// far below the ~295 flops/byte where the tensor cores would bound it. So
// the design is about bytes in flight on every SM.
//
// Design (flash-decoding): the W cache slots split into S equal chunks and
// the grid is (B, KVH, S), so that B * KVH * S blocks fill the card; the
// host picks S from B, KVH and W alone (never from lengths, which live on
// the card). A block reads its chunk's rows below lengths[b] once, for all
// G query heads of its group, whose rows sit in shared memory in f32,
// pre-scaled by log2(e) / sqrt(hd). The rows arrive in 32-row tiles
// through 16-byte cp.async copies, double-buffered, so one tile loads while
// the block works on the one before; rows at or past lengths[b] are
// zero-filled, never read. In a tile each warp takes 8 rows: the four lanes
// of a quad split a row's 16-byte pieces, sum their partial dot products
// with two shuffles, and the warp's online softmax (m, l, acc in f32, base
// 2) takes the tile's 8 rows with one 3-step max; for P.V each lane owns
// hd / 32 output columns and reads each V row once. The warps merge in
// warp order, and the block writes its partial state (m, l, acc[hd]) per
// query head to a workspace the wrapper allocates. A block whose chunk
// starts at or past lengths[b] writes the empty state (m = -1e30, l = 0,
// acc = 0). A second small kernel merges the S partial states of each
// (b, head) in split order, weighting by exp2(m_s - max m) * l_s, so an
// empty state adds nothing and the result has the same bits on every
// launch. Output is in q's dtype; on request the merge also writes each
// row's f32 log-sum-exp, which a caller merging several such calls (a
// cache sharded along its sequence) weighs their outputs by.
// Precondition: 1 <= lengths[b] <= W (clamped to [0, W]; 0 gives zeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                       // warps per block
constexpr int kRowsPerWarp = 8;                 // cache rows a warp takes per tile
constexpr int kTile = kWarps * kRowsPerWarp;    // rows per staged tile
constexpr int kStages = 2;                      // tiles in flight
constexpr float kEmptyM = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the 16-byte piece at p as floats
__device__ __forceinline__ void unpack(const unsigned char* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}
__device__ __forceinline__ void unpack(const unsigned char* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// E contiguous elements of a row, loaded as one vector
template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T v[E];
};

// Bytes between staged rows: a multiple of 32 (the widest V vector), and
// 64 mod 128, so the two rows that a quarter-warp's 16-byte reads touch in
// the scoring phase fall in opposite halves of the 32 banks.
__host__ __device__ constexpr int row_bytes(int hd, int isz) {
  return (hd * isz + 127) / 128 * 128 + 64;
}

// Shared memory: the staged tiles, reused by the warps' merge at the end,
// then the group's query rows in f32.
__host__ __device__ size_t stage_area(int hd, int isz, int G) {
  const size_t stages = (size_t)kStages * kTile * 2 * row_bytes(hd, isz);
  const size_t merge = (size_t)kWarps * G * (hd + 2) * sizeof(float);
  return stages > merge ? stages : merge;
}
size_t smem_bytes(int hd, int isz, int G) {
  return stage_area(hd, isz, G) + (size_t)G * hd * sizeof(float);
}

// E: output columns per lane (hd <= 32 * E). GM: most query heads per KV
// head (G <= GM). ws_ml: (B, H, S, 2) of (m, l); ws_acc: (B, H, S, hd).
template <typename T, int E, int GM>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ ws_ml, float* __restrict__ ws_acc,
                    int W, int KVH, int G, int hd, int S, int chunk,
                    float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kh = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = KVH * G;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > W ? W : len);
  const int lo = sp * chunk;
  const int hi = min(lo + chunk, len);
  // workspace slot of query head kh * G + g, this split
  const size_t slot0 = ((size_t)b * H + (size_t)kh * G) * S + sp;

  if (lo >= hi) {   // nothing of this chunk is valid: the empty state
    for (int i = tid; i < G * hd; i += blockDim.x) {
      const int g = i / hd, d = i - g * hd;
      ws_acc[(slot0 + (size_t)g * S) * hd + d] = 0.f;
    }
    for (int g = tid; g < G; g += blockDim.x) {
      ws_ml[2 * (slot0 + (size_t)g * S)] = kEmptyM;
      ws_ml[2 * (slot0 + (size_t)g * S) + 1] = 0.f;
    }
    return;
  }

  constexpr int kPiece = 16 / sizeof(T);         // elements per 16 bytes
  const int rb = row_bytes(hd, sizeof(T));
  const int stage_bytes = kTile * 2 * rb;         // K rows, then V rows
  float* sq = reinterpret_cast<float*>(smem + stage_area(hd, sizeof(T), G));

  const size_t row = (size_t)KVH * hd;            // elements between cache rows
  const T* kb = k + (size_t)b * W * row + (size_t)kh * hd;
  const T* vb = v + (size_t)b * W * row + (size_t)kh * hd;
  const int pieces = hd / kPiece;
  const int n_tiles = (hi - lo + kTile - 1) / kTile;

  auto stage = [&](int t) {
    unsigned char* sk = smem + (t % kStages) * stage_bytes;
    unsigned char* sv = sk + kTile * rb;
    const int r0 = lo + t * kTile;
    for (int i = tid; i < kTile * pieces; i += blockDim.x) {
      const int r = i / pieces, c = i - r * pieces;
      const int j = r0 + r;
      const bool ok = j < hi;
      const size_t off = (size_t)(ok ? j : lo) * row + (size_t)c * kPiece;
      cp_async16(sk + r * rb + c * 16, kb + off, ok ? 16 : 0);
      cp_async16(sv + r * rb + c * 16, vb + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  stage(0);

  for (int i = tid; i < G * hd; i += blockDim.x)
    sq[i] = to_f32(q[((size_t)b * H + (size_t)kh * G) * hd + i]) * scale_log2;

  const int quad = lane >> 2, part = lane & 3;    // row of the warp's 8, piece lane
  const bool lane_on = lane * E < hd;             // lane owns output columns
  const int d0 = lane_on ? lane * E : 0;

  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kEmptyM;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile t (and, on the first pass, sq) is in shared memory
    const unsigned char* sk = smem + (t % kStages) * stage_bytes;
    const unsigned char* sv = sk + kTile * rb;
    const int tr = warp * kRowsPerWarp + quad;    // this quad's row of the tile
    const bool valid = lo + t * kTile + tr < hi;

    // scores: the quad's lanes take pieces part, part + 4, ... of the row
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    for (int c = part; c < pieces; c += 4) {
      float kx[kPiece];
      unpack(sk + tr * rb + c * 16, kx);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float4* qg = reinterpret_cast<const float4*>(sq + g * hd + c * kPiece);
#pragma unroll
          for (int e = 0; e < kPiece / 4; ++e) {
            const float4 qv = qg[e];
            s[g] += qv.x * kx[4 * e] + qv.y * kx[4 * e + 1] +
                    qv.z * kx[4 * e + 2] + qv.w * kx[4 * e + 3];
          }
        }
      }
    }

    // online softmax over the warp's 8 rows of the tile (base 2)
    float p[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], 2);
        float mx = valid ? s[g] : kEmptyM;
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = exp2f(m[g] - m_new);
        p[g] = valid ? exp2f(s[g] - m_new) : 0.f;
        l[g] = l[g] * alpha + (part == 0 ? p[g] : 0.f);   // one lane a row
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
      }
    }

    // P.V: lane owns columns [d0, d0 + E); row u's p sits in lanes 4u..4u+3
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const Vec<T, E> vr = *reinterpret_cast<const Vec<T, E>*>(
          sv + (warp * kRowsPerWarp + u) * rb + d0 * sizeof(T));
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float pu = __shfl_sync(0xffffffffu, p[g], 4 * u);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += pu * to_f32(vr.v[e]);
        }
      }
    }
    __syncthreads();   // tile t is consumed before its stage is refilled
  }

  // merge the warps in warp order (the stage area is free now)
  float* red_ml = reinterpret_cast<float*>(smem);           // kWarps x G x 2
  float* red_acc = red_ml + kWarps * G * 2;                  // kWarps x G x hd
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      float lw = l[g];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) lw += __shfl_xor_sync(0xffffffffu, lw, o);
      if (lane == 0) {
        red_ml[(warp * G + g) * 2] = m[g];
        red_ml[(warp * G + g) * 2 + 1] = lw;
      }
      if (lane_on)
#pragma unroll
        for (int e = 0; e < E; ++e) red_acc[(warp * G + g) * hd + d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    float mx = kEmptyM;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_ml[(w * G + g) * 2]);
    float a = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(red_ml[(w * G + g) * 2] - mx);
      a += red_acc[(w * G + g) * hd + d] * f;
      den += red_ml[(w * G + g) * 2 + 1] * f;
    }
    const size_t sl = slot0 + (size_t)g * S;
    ws_acc[sl * hd + d] = a;
    if (d == 0) {
      ws_ml[2 * sl] = mx;
      ws_ml[2 * sl + 1] = den;
    }
  }
}

// out[b, h] from the S partial states of (b, h), in split order; where lse
// is given, also the row's natural log-sum-exp of its scaled scores,
// (mx + log2(den)) * ln 2 in the base-2 units the split kernel keeps, or
// kEmptyM for a row with no valid slot.
template <typename T>
__global__ void merge_kernel(const float* __restrict__ ws_ml,
                             const float* __restrict__ ws_acc,
                             T* __restrict__ out, float* __restrict__ lse,
                             int H, int S, int hd) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t base = ((size_t)b * H + h) * S;
  float mx = kEmptyM;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, ws_ml[2 * (base + s)]);
  float den = 0.f;
  for (int s = 0; s < S; ++s)
    den += ws_ml[2 * (base + s) + 1] * exp2f(ws_ml[2 * (base + s)] - mx);
  const float inv = 1.f / fmaxf(den, 1e-30f);
  if (lse != nullptr && threadIdx.x == 0)
    lse[(size_t)b * H + h] =
        den > 0.f ? (mx + log2f(den)) * 0.6931471805599453f : kEmptyM;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < S; ++s)
      a += ws_acc[(base + s) * hd + d] * exp2f(ws_ml[2 * (base + s)] - mx);
    out[((size_t)b * H + h) * hd + d] = from_f32<T>(a * inv);
  }
}

template <typename T, int E, int GM>
int launch_split(dim3 grid, size_t smem, cudaStream_t st, const void* q,
                 const void* k, const void* v, const int* len, float* ws_ml,
                 float* ws_acc, int W, int KVH, int G, int hd, int S,
                 int chunk, float scale_log2) {
  static size_t smem_set = 0;   // the most dynamic shared memory allowed so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, E, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e == cudaSuccess)   // as much shared memory as L1 allows: more blocks
      e = cudaFuncSetAttribute(decode_split_kernel<T, E, GM>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  decode_split_kernel<T, E, GM><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len, ws_ml, ws_acc, W, KVH, G, hd, S, chunk,
      scale_log2);
  return 0;
}

template <typename T, int E>
int launch_g(int GM, dim3 grid, size_t smem, cudaStream_t st, const void* q,
             const void* k, const void* v, const int* len, float* ws_ml,
             float* ws_acc, int W, int KVH, int G, int hd, int S, int chunk,
             float sc) {
  switch (GM) {
    case 1: return launch_split<T, E, 1>(grid, smem, st, q, k, v, len, ws_ml, ws_acc, W, KVH, G, hd, S, chunk, sc);
    case 2: return launch_split<T, E, 2>(grid, smem, st, q, k, v, len, ws_ml, ws_acc, W, KVH, G, hd, S, chunk, sc);
    case 4: return launch_split<T, E, 4>(grid, smem, st, q, k, v, len, ws_ml, ws_acc, W, KVH, G, hd, S, chunk, sc);
    case 8: return launch_split<T, E, 8>(grid, smem, st, q, k, v, len, ws_ml, ws_acc, W, KVH, G, hd, S, chunk, sc);
    default: return launch_split<T, E, 16>(grid, smem, st, q, k, v, len, ws_ml, ws_acc, W, KVH, G, hd, S, chunk, sc);
  }
}

template <typename T>
int launch_e(int E, int GM, dim3 grid, size_t smem, cudaStream_t st,
             const void* q, const void* k, const void* v, const int* len,
             float* ws_ml, float* ws_acc, int W, int KVH, int G, int hd,
             int S, int chunk, float sc) {
  switch (E) {
    case 1: return launch_g<T, 1>(GM, grid, smem, st, q, k, v, len, ws_ml, ws_acc, W, KVH, G, hd, S, chunk, sc);
    case 2: return launch_g<T, 2>(GM, grid, smem, st, q, k, v, len, ws_ml, ws_acc, W, KVH, G, hd, S, chunk, sc);
    case 4: return launch_g<T, 4>(GM, grid, smem, st, q, k, v, len, ws_ml, ws_acc, W, KVH, G, hd, S, chunk, sc);
    default: return launch_g<T, 8>(GM, grid, smem, st, q, k, v, len, ws_ml, ws_acc, W, KVH, G, hd, S, chunk, sc);
  }
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (B, KVH*G, hd); k, v: (B, W, KVH, hd), 16-byte aligned; lengths: int32
// (B,); out like q; lse: f32 (B, KVH*G), or null for none.
// workspace: B * KVH * G * splits * (hd + 2) floats.
// hd a multiple of 8, at most 256; G at most 16; 1 <= splits <= W.
// All contiguous, on the device. is_bf16: 1 for bf16, 0 for f32.
// Two launches on the stream: the split kernel, then the merge.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, void* lse,
                                void* workspace, int B, int KVH, int G, int W,
                                int hd, int splits, int is_bf16,
                                void* stream) {
  if (B < 1 || B > 65535 || KVH < 1 || KVH > 65535 || G < 1 || G > 16 ||
      W < 1 || hd < 8 || hd > 256 || hd % 8 != 0 || splits < 1 ||
      splits > W || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int E = pow2_at_least((hd + 31) / 32);
  const int GM = pow2_at_least(G);
  const int chunk = (W + splits - 1) / splits;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(hd));
  const dim3 grid(B, KVH, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int H = KVH * G;
  float* ws_ml = static_cast<float*>(workspace);
  float* ws_acc = ws_ml + (size_t)B * H * splits * 2;
  const size_t smem = smem_bytes(hd, is_bf16 ? 2 : 4, G);
  const int rc = is_bf16
      ? launch_e<__nv_bfloat16>(E, GM, grid, smem, st, q, k, v, len, ws_ml, ws_acc, W, KVH, G, hd, splits, chunk, scale_log2)
      : launch_e<float>(E, GM, grid, smem, st, q, k, v, len, ws_ml, ws_acc, W, KVH, G, hd, splits, chunk, scale_log2);
  if (rc != 0) return rc;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 merge_grid(H, B);
  const int threads = ((hd + 31) / 32) * 32;
  float* lse_f = static_cast<float*>(lse);
  if (is_bf16)
    merge_kernel<__nv_bfloat16><<<merge_grid, threads, 0, st>>>(
        ws_ml, ws_acc, static_cast<__nv_bfloat16*>(out), lse_f, H, splits, hd);
  else
    merge_kernel<float><<<merge_grid, threads, 0, st>>>(
        ws_ml, ws_acc, static_cast<float*>(out), lse_f, H, splits, hd);
  return static_cast<int>(cudaGetLastError());
}
