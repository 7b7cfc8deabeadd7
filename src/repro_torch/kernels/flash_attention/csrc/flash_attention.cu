// Flash attention forward for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _flash_kernel). For q (B, H, Sq, D) and k, v (B, KVH, Skv, D):
//     out = softmax(q . k^T * sm_scale, masked) . v
// with q row i at absolute position i + q_offset, key j kept when
// j < Skv, (causal) j <= i + q_offset and (window > 0)
// j > i + q_offset - window. q head h reads kv head h / (H / KVH).
// Online softmax with f32 accumulation; the sum is divided by
// max(l, 1e-30), so a row with no valid key gives 0 and not NaN.
//
// Bound on the H100: operations at the lengths of a forward pass (a
// causal 1024-token gemma layer does ~4.3 GFLOP on ~9 MB), bytes at
// short ones. This first version does the products with f32 FMAs on the
// CUDA cores, not the tensor cores, so it runs far from the bf16 bound;
// mma/wgmma tiles and TMA loads are the work of a later change.
//
// Design: one block of 256 threads per (q tile of 64 rows, q head, b),
// looping over kv tiles of 32 rows. The tiles live in shared memory as
// f32 (q 64xD, k and v 32xD: about 140 KB at D=256, taken as dynamic
// shared memory above the 48 KB default), converted from bf16 at load;
// rows past Sq or Skv are zero-filled there, so odd lengths need no
// padding on the host. Tiles wholly outside the causal range or the
// window are never visited. S = q k^T: each thread owns 2x4 scores
// (k rows padded by 4 floats so the 16-byte reads of one quarter-warp hit
// distinct banks), the running max and sum of its rows are reduced over
// the 8 lanes that share a row with shuffles, and the probabilities go
// through shared memory to the P.V product, where each warp owns 8 rows
// of the f32 output accumulator in registers (8 x ceil(D/32) per thread;
// at D=16 half the lanes sit out that product). The head dims built are
// those of the configs: 16 (the reduced test configs), 64, 128 and 256.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;           // q rows per block
constexpr int kBK = 32;           // kv rows per tile
constexpr int kPad = 4;           // floats of padding per q/k row in shared memory
constexpr int kPLd = kBK + 8;     // row stride of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ constexpr size_t smem_floats(int d) {
  return (size_t)kBQ * (d + kPad) + (size_t)kBK * (d + kPad) + (size_t)kBK * d +
         (size_t)kBQ * kPLd + 2 * kBQ;
}

// rows [row0, row0 + nrows) of a (rows, d) matrix into shared memory as
// f32 with row stride ld; rows at or past `limit` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int row0,
                                          int nrows, int limit, int d) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = d / VEC;
  for (int idx = threadIdx.x; idx < nrows * chunks; idx += kThreads) {
    const int r = idx / chunks, c = idx - r * chunks;
    float* out = dst + r * ld + c * VEC;
    if (row0 + r < limit) {
      uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + c * VEC);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(out + j) =
            make_float4(to_f32(e[j]), to_f32(e[j + 1]), to_f32(e[j + 2]), to_f32(e[j + 3]));
    } else {
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(out + j) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int h, int kvh, int sq, int skv, float scale,
             int causal, int window, int q_offset) {
  constexpr int DC = (D + 31) / 32;   // output columns per lane
  constexpr int QLD = D + kPad;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // (kBQ, QLD)
  float* ks = qs + kBQ * QLD;            // (kBK, QLD)
  float* vs = ks + kBK * QLD;            // (kBK, D)
  float* ps = vs + kBK * D;              // (kBQ, kPLd)
  float* alpha_s = ps + kBQ * kPLd;      // (kBQ,)
  float* l_s = alpha_s + kBQ;            // (kBQ,)

  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int kv = head / (h / kvh);
  const int q0 = qt * kBQ;
  const T* qb = q + ((size_t)b * h + head) * sq * D;
  const T* kb = k + ((size_t)b * kvh + kv) * skv * D;
  const T* vb = v + ((size_t)b * kvh + kv) * skv * D;
  T* ob = o + ((size_t)b * h + head) * sq * D;

  // kv range any row of this q tile can see
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + kBQ, sq) - 1 + q_offset;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const int kv_begin = window > 0 ? max(0, q_first - window + 1) : 0;

  // S-step layout: thread owns rows {ty, ty + 32} x cols {tx + 8m}
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  // PV-step layout: warp owns rows 8w..8w+7, lane owns cols lane + 32i
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.f, 0.f};
  float acc[8][DC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < DC; ++i) acc[r][i] = 0.f;

  load_tile<T>(qs, QLD, qb, q0, kBQ, sq, D);

  for (int k0 = (kv_begin / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // previous tile fully consumed (and q staged)
    load_tile<T>(ks, QLD, kb, k0, kBK, skv, D);
    load_tile<T>(vs, D, vb, k0, kBK, skv, D);
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 qa[2], kc[4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        qa[a] = *reinterpret_cast<const float4*>(qs + (ty + 32 * a) * QLD + dd);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kc[c] = *reinterpret_cast<const float4*>(ks + (tx + 8 * c) * QLD + dd);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[a][c] += qa[a].x * kc[c].x + qa[a].y * kc[c].y + qa[a].z * kc[c].z +
                     qa[a].w * kc[c].w;
    }

#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int row = ty + 32 * a;
      const int qp = q0 + row + q_offset;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 8 * c;
        valid[c] = kp < skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        s[a][c] = valid[c] ? s[a][c] * scale : kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m_row[a], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = valid[c] ? expf(s[a][c] - m_cur) : 0.f;
        ps[row * kPLd + tx + 8 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_row[a] - m_cur);
      l_row[a] = l_row[a] * alpha + sum;
      m_row[a] = m_cur;
      if (tx == 0) alpha_s[row] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float al = alpha_s[warp * 8 + r];
#pragma unroll
      for (int i = 0; i < DC; ++i) acc[r][i] *= al;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[DC];
#pragma unroll
      for (int i = 0; i < DC; ++i)
        vv[i] = (D % 32 == 0 || lane + 32 * i < D) ? vs[j * D + lane + 32 * i] : 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float p = ps[(warp * 8 + r) * kPLd + j];
#pragma unroll
        for (int i = 0; i < DC; ++i) acc[r][i] += p * vv[i];
      }
    }
  }

  if (tx == 0) {
    l_s[ty] = l_row[0];
    l_s[ty + 32] = l_row[1];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = warp * 8 + r;
    if (q0 + row < sq) {
      const float inv = 1.f / fmaxf(l_s[row], 1e-30f);
#pragma unroll
      for (int i = 0; i < DC; ++i)
        if (D % 32 == 0 || lane + 32 * i < D)
          ob[(size_t)(q0 + row) * D + lane + 32 * i] = from_f32<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int h,
                   int kvh, int sq, int skv, float scale, int causal, int window,
                   int q_offset, cudaStream_t stream) {
  const size_t bytes = smem_floats(D) * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), h, kvh, sq, skv, scale, causal, window, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, void* o, int b,
                     int h, int kvh, int sq, int skv, float scale, int causal, int window,
                     int q_offset, cudaStream_t stream) {
#define FLASH_CASE(D)                                                                 \
  case D: return launch<T, D>(q, k, v, o, b, h, kvh, sq, skv, scale, causal, window, \
                              q_offset, stream);
  switch (d) {
    FLASH_CASE(16)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int b, int h, int kvh, int sq, int skv, int d, float scale,
                                   int causal, int window, int q_offset, int is_bf16,
                                   void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return (int)cudaSuccess;
  if (kvh <= 0 || h % kvh != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16
      ? dispatch<__nv_bfloat16>(d, q, k, v, o, b, h, kvh, sq, skv, scale, causal, window,
                                q_offset, st)
      : dispatch<float>(d, q, k, v, o, b, h, kvh, sq, skv, scale, causal, window, q_offset,
                        st);
  return (int)e;
}
