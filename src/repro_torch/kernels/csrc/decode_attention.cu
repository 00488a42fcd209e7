// Decode attention: one step of grouped-query attention over a KV cache.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_grouped
// (body _decode_kernel). Same function, widened in one way: the number of
// valid cache slots is per row (lengths[b]); the Pallas contract's scalar
// length is the broadcast case.
//
// Bound on the H100: bytes. Each (b, kv head) reads lengths[b] rows of K and
// V once and does 4 * G * hd flops per row, about G flops per byte in bf16,
// far below the ~295 flops/byte where the tensor cores would bound it.
//
// Design: one block per (b, kv head), eight warps walking the valid rows in
// turn, eight rows in flight per warp. A K/V row is loaded once, as one
// vector of hd/32 contiguous elements per lane (a warp reads the row's
// bytes contiguously), and used by all G query heads of the group, whose
// rows sit in registers; nothing is repeated to full heads. Rows at or past
// lengths[b] are never read: the loads of a warp's last, partial group of
// rows re-read row lengths[b] - 1 and mask it. Each warp keeps an
// online softmax (m, l, acc) in f32; the warps merge through shared memory
// at the end. Output is in q's dtype.
// Precondition: 1 <= lengths[b] <= W (clamped to [0, W]; 0 gives zeros).
// Not yet done: splitting W over several blocks (only B * KVH blocks run),
// cp.async/TMA staging and tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;    // warps per block
constexpr int kRows = 8;     // cache rows in flight per warp

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// E contiguous elements of a head row, loaded as one vector
template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T v[E];
};

// E: elements of a head row per lane (hd <= 32 * E, hd % E == 0).
// GM: most query heads per KV head (G <= GM).
template <typename T, int E, int GM>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ out, int W, int KVH, int G, int hd, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = KVH * G;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > W ? W : len);
  // lane holds elements [d0, d0 + E); lanes past hd repeat the last chunk
  // with a zero query, so they add nothing
  const bool lane_on = lane * E < hd;
  const int d0 = lane_on ? lane * E : hd - E;

  // the group's query rows, pre-scaled by 1/sqrt(hd)
  float qr[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[g][e] = (g < G && lane_on)
          ? to_f32(q[((size_t)b * H + (size_t)kh * G + g) * hd + d0 + e]) * scale
          : 0.f;

  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -1e30f;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const size_t row = (size_t)KVH * hd;   // elements between cache rows
  const T* kb = k + (size_t)b * W * row + (size_t)kh * hd + d0;
  const T* vb = v + (size_t)b * W * row + (size_t)kh * hd + d0;

  for (int j0 = warp * kRows; j0 < len; j0 += kWarps * kRows) {
    // all loads first, unconditionally (a row past len re-reads row
    // len - 1, which is masked below): kRows rows in flight per warp
    Vec<T, E> kraw[kRows], vraw[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const size_t j = (size_t)min(j0 + u, len - 1);
      kraw[u] = *reinterpret_cast<const Vec<T, E>*>(kb + j * row);
      vraw[u] = *reinterpret_cast<const Vec<T, E>*>(vb + j * row);
    }
    float kr[kRows][E], vr[kRows][E];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[u][e] = to_f32(kraw[u].v[e]);
        vr[u][e] = to_f32(vraw[u].v[e]);
      }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        float s[kRows];
        float m_new = m[g];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) part += qr[g][e] * kr[u][e];
          s[u] = warp_sum(part);
          if (j0 + u < len) m_new = fmaxf(m_new, s[u]);
        }
        const float alpha = expf(m[g] - m_new);
        float p[kRows], psum = 0.f;
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          p[u] = j0 + u < len ? expf(s[u] - m_new) : 0.f;
          psum += p[u];
        }
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float a = acc[g][e] * alpha;
#pragma unroll
          for (int u = 0; u < kRows; ++u) a += p[u] * vr[u][e];
          acc[g][e] = a;
        }
      }
    }
  }

  // merge the warps' softmax states
  __shared__ float sm_m[kWarps][GM], sm_l[kWarps][GM];
  __shared__ float sm_acc[GM][32 * E];
  for (int i = threadIdx.x; i < GM * 32 * E; i += blockDim.x) (&sm_acc[0][0])[i] = 0.f;
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      float mx = -1e30f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
      const float f = expf(m[g] - mx);
      if (lane_on)
#pragma unroll
        for (int e = 0; e < E; ++e) atomicAdd(&sm_acc[g][d0 + e], acc[g][e] * f);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    float mx = -1e30f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float denom = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) denom += sm_l[w][g] * expf(sm_m[w][g] - mx);
    out[((size_t)b * H + (size_t)kh * G + g) * hd + d] =
        from_f32<T>(sm_acc[g][d] / fmaxf(denom, 1e-30f));
  }
}

template <typename T, int E>
void launch_g(int GM, dim3 grid, cudaStream_t st, const void* q, const void* k,
              const void* v, const int* len, void* out, int W, int KVH, int G,
              int hd, float scale) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (GM) {
    case 1: decode_kernel<T, E, 1><<<grid, kWarps * 32, 0, st>>>(qt, kt, vt, len, ot, W, KVH, G, hd, scale); break;
    case 2: decode_kernel<T, E, 2><<<grid, kWarps * 32, 0, st>>>(qt, kt, vt, len, ot, W, KVH, G, hd, scale); break;
    case 4: decode_kernel<T, E, 4><<<grid, kWarps * 32, 0, st>>>(qt, kt, vt, len, ot, W, KVH, G, hd, scale); break;
    case 8: decode_kernel<T, E, 8><<<grid, kWarps * 32, 0, st>>>(qt, kt, vt, len, ot, W, KVH, G, hd, scale); break;
    default: decode_kernel<T, E, 16><<<grid, kWarps * 32, 0, st>>>(qt, kt, vt, len, ot, W, KVH, G, hd, scale); break;
  }
}

template <typename T>
void launch_e(int E, int GM, dim3 grid, cudaStream_t st, const void* q,
              const void* k, const void* v, const int* len, void* out, int W,
              int KVH, int G, int hd, float scale) {
  switch (E) {
    case 1: launch_g<T, 1>(GM, grid, st, q, k, v, len, out, W, KVH, G, hd, scale); break;
    case 2: launch_g<T, 2>(GM, grid, st, q, k, v, len, out, W, KVH, G, hd, scale); break;
    case 4: launch_g<T, 4>(GM, grid, st, q, k, v, len, out, W, KVH, G, hd, scale); break;
    default: launch_g<T, 8>(GM, grid, st, q, k, v, len, out, W, KVH, G, hd, scale); break;
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

// q: (B, KVH*G, hd); k, v: (B, W, KVH, hd); lengths: int32 (B,); out like q.
// hd a multiple of 8, at most 256; G at most 16.
// All contiguous, on the device. is_bf16: 1 for bf16, 0 for f32.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int B, int KVH,
                                int G, int W, int hd, int is_bf16,
                                void* stream) {
  if (B < 1 || KVH < 1 || G < 1 || G > 16 || W < 1 || hd < 8 || hd > 256 ||
      hd % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int E = pow2_at_least((hd + 31) / 32);
  const int GM = pow2_at_least(G);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const dim3 grid(B, KVH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (is_bf16)
    launch_e<__nv_bfloat16>(E, GM, grid, st, q, k, v, len, out, W, KVH, G, hd, scale);
  else
    launch_e<float>(E, GM, grid, st, q, k, v, len, out, W, KVH, G, hd, scale);
  return static_cast<int>(cudaGetLastError());
}
