// Decode attention forward for Hopper (sm_90a): one new query token per
// sequence against a padded KV cache.
//
// Replaces: repro/kernels/decode_attention/kernel.py::decode_attention_pallas
// (body _decode_kernel). For each (b, q head h):
//     out = softmax(q . K^T * scale, masked) . V
// over cache positions k with k < length[b] (a length above S counts as
// S) and, when window > 0, k >= length[b] - window. Online softmax in
// f32; a row with no valid key gives 0. q head h reads kv head h / group.
//
// Bound on the H100: bytes. Each cache row (D values of K and of V) is
// used for `group` dot products per head group, a few operations per
// byte, so streaming the cache from device memory is the limit.
//
// Design: one block of 256 threads per (kv head, b). The block takes all
// `group` q heads of its kv head, so each K/V row is read from device
// memory once for the whole group (8 heads on one cache for gemma's
// MQA). It walks the valid range of the cache in tiles of 32 rows: all
// threads stage the K and V tile in shared memory with 16-byte loads
// (rows outside the valid range are zero-filled, so the tail of a cache
// whose length is not a multiple of the tile is masked here and no
// S % tile assert is needed); each warp then scores whole rows, one lane
// per 16-byte chunk of the head dimension, against all heads held in
// registers; one warp per head updates that head's running max and sum
// over the tile's 32 scores; and each thread folds the tile's
// probabilities into its share of the (group x D) f32 output held in
// registers. With 4 sequences and 1 kv head this launches only 4 blocks;
// splitting the cache length over more blocks is left to a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // cache rows per tile (= lanes of a warp)
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int G>
__host__ __device__ constexpr size_t smem_bytes(int d, int elem) {
  return (size_t)2 * kTile * d * elem + (size_t)G * kTile * 4 + (size_t)3 * G * 4;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, T* __restrict__ o,
              int h, int kvh, int s, int d, float scale, int window) {
  constexpr int VEC = 16 / sizeof(T);             // elements per 16-byte chunk
  constexpr int MAXR = kMaxD / (VEC * 32);        // chunks per lane
  constexpr int MAXO = (G * kMaxD + kThreads - 1) / kThreads;   // outputs per thread

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kTile * d;
  float* ps = reinterpret_cast<float*>(vs + kTile * d);   // (G, kTile) scores -> probs
  float* alpha_s = ps + G * kTile;
  float* m_s = alpha_s + G;
  float* l_s = m_s + G;

  const int kv = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = d / VEC;
  const size_t cache_off = ((size_t)b * kvh + kv) * s * d;
  const T* kb = k + cache_off;
  const T* vb = v + cache_off;
  const int head0 = b * h + kv * G;

  const int len = lengths[b];
  const int hi = min(len, s);
  const int lo = window > 0 ? max(0, len - window) : 0;

  // this lane's chunks of every head's query, in f32
  float qr[G][MAXR][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int c = lane + 32 * r;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[g][r][e] = c < chunks ? to_f32(q[(size_t)(head0 + g) * d + c * VEC + e]) : 0.f;
    }

  float acc[MAXO];
#pragma unroll
  for (int i = 0; i < MAXO; ++i) acc[i] = 0.f;
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }

  for (int t0 = (lo / kTile) * kTile; t0 < hi; t0 += kTile) {
    __syncthreads();   // previous tile fully consumed
    // stage K and V rows [t0, t0 + kTile); rows outside [lo, hi) become 0
    for (int idx = threadIdx.x; idx < kTile * chunks; idx += kThreads) {
      const int row = idx / chunks, c = idx - row * chunks;
      const int pos = t0 + row;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (pos >= lo && pos < hi) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)pos * d + c * VEC);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)pos * d + c * VEC);
      }
      *reinterpret_cast<uint4*>(ks + row * d + c * VEC) = kv4;
      *reinterpret_cast<uint4*>(vs + row * d + c * VEC) = vv4;
    }
    __syncthreads();

    // scores: warp per row, lane per chunk, all G heads at once
    for (int row = warp; row < kTile; row += kWarps) {
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        const int c = lane + 32 * r;
        if (c < chunks) {
          uint4 raw = *reinterpret_cast<const uint4*>(ks + row * d + c * VEC);
          const T* kv8 = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float kf = to_f32(kv8[e]);
#pragma unroll
            for (int g = 0; g < G; ++g) part[g] += qr[g][r][e] * kf;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (lane == 0) {
        const int pos = t0 + row;
        const bool valid = pos >= lo && pos < hi;
#pragma unroll
        for (int g = 0; g < G; ++g) ps[g * kTile + row] = valid ? part[g] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp per head, lane per row of the tile
    for (int g = warp; g < G; g += kWarps) {
      const int pos = t0 + lane;
      const bool valid = pos >= lo && pos < hi;
      const float sc = ps[g * kTile + lane];
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_cur = fmaxf(m_prev, mx);
      const float p = valid ? expf(sc - m_cur) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[g * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        alpha_s[g] = alpha;
        m_s[g] = m_cur;
        l_s[g] = l_s[g] * alpha + sum;
      }
    }
    __syncthreads();

    // acc(g, :) = acc(g, :) * alpha(g) + p(g, :) . V_tile
#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx < G * d) {
        const int g = idx / d, col = idx - g * d;
        const float* pg = ps + g * kTile;
        float a = acc[i] * alpha_s[g];
#pragma unroll 8
        for (int j = 0; j < kTile; ++j) a += pg[j] * to_f32(vs[j * d + col]);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < MAXO; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < G * d) {
      const int g = idx / d, col = idx - g * d;
      const float l = hi > lo ? l_s[g] : 0.f;
      o[(size_t)(head0 + g) * d + col] = from_f32<T>(acc[i] / fmaxf(l, 1e-30f));
    }
  }
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* o,
                   int b, int h, int kvh, int s, int d, float scale, int window,
                   cudaStream_t stream) {
  static bool configured = false;
  const size_t max_bytes = smem_bytes<G>(kMaxD, sizeof(T));
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<T, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)max_bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(kvh, b);
  decode_kernel<T, G><<<grid, kThreads, smem_bytes<G>(d, sizeof(T)), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(o), h, kvh, s, d, scale, window);
  return cudaGetLastError();
}

// Groups (q heads per kv head) built: those of the configs, e.g. 8 for
// gemma-2b and 10 for recurrentgemma-2b. At G = 16 and D = 256 a thread
// holds 128 f32 query values and 16 outputs in registers, and a block
// uses 68 KB of shared memory in f32: every smaller group fits as well.
template <typename T>
cudaError_t dispatch(int group, const void* q, const void* k, const void* v, const int* lengths,
                     void* o, int b, int h, int kvh, int s, int d, float scale, int window,
                     cudaStream_t stream) {
#define DECODE_CASE(G) \
  case G: return launch<T, G>(q, k, v, lengths, o, b, h, kvh, s, d, scale, window, stream);
  switch (group) {
    DECODE_CASE(1)
    DECODE_CASE(2)
    DECODE_CASE(3)
    DECODE_CASE(4)
    DECODE_CASE(8)
    DECODE_CASE(10)
    DECODE_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_CASE
}

}  // namespace

extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* lengths, void* o, int b, int h, int kvh,
                                    int s, int d, float scale, int window, int is_bf16,
                                    void* stream) {
  if (b <= 0 || kvh <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > kMaxD || d % 8 != 0 || h % kvh != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  cudaError_t e = is_bf16
      ? dispatch<__nv_bfloat16>(h / kvh, q, k, v, len, o, b, h, kvh, s, d, scale, window, st)
      : dispatch<float>(h / kvh, q, k, v, len, o, b, h, kvh, s, d, scale, window, st);
  return (int)e;
}
