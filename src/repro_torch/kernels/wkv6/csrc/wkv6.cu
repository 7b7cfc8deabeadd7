// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces: repro/kernels/wkv6/kernel.py::wkv6_pallas (body _wkv6_kernel).
// For each (b, h), with a K x V f32 state S loaded from state0[b, h]:
//     out_t = r_t @ (S_{t-1} + (u * k_t)^T v_t)
//     S_t   = diag(exp(lw_t)) S_{t-1} + k_t^T v_t,        t = 0 .. S-1
// r, k, v and out are f32 or bf16 (one type); lw, u, state0 and the final
// state are f32; all arithmetic is f32. S = 1 is RWKV-6's decode step.
//
// Bound on the H100: bytes. r, k, v and lw are read once and out written
// once; the 2 multiply-adds per state element and step are far below the
// operations per byte where arithmetic would be the limit.
//
// Design: the per-step form of repro/kernels/wkv6/ref.py, not the TPU
// kernel's chunked one. Every decay factor is exp(lw_t) <= 1, so nothing
// overflows at any lw (lw = -50 included) and no chunk tail needs masking.
// Column v of S and of out uses column v of v only, so one thread owns one
// column: its K state values live in registers (K padded to KP, a
// template parameter; rows k >= K stay 0). A block of 32 threads is one
// warp of 32 neighbouring columns of one (b, h); the grid is
// (ceil(V / 32), H, B), 64 blocks for B = 1 and rwkv6-1.6b's H = 32,
// V = 64. The TPU kernel's sequential chunk axis, which carried S in VMEM
// scratch, becomes a loop over all of S inside the block. The block stages
// kTile steps of r, k and exp(lw) (shared by all its columns; exp is taken
// once per element, not once per column) and of its own v columns in
// shared memory, then each thread walks the tile in order; the sum over k
// is split over 4 partial sums so that the multiply-adds do not wait on
// one another. Any S >= 0, any V and any K <= 64 are taken. With one warp
// per (b, h, 32 columns) and 2048 dependent steps at prefill the card is
// mostly idle; a chunked tensor-core form is left to a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // threads per block = state columns per block
constexpr int kTile = 32;   // steps staged in shared memory at a time
constexpr int kMaxK = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int KP>
__global__ void __launch_bounds__(kCols)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ lw, const float* __restrict__ u,
            const float* __restrict__ state0, T* __restrict__ out,
            float* __restrict__ state, int h_count, int s, int kd, int vd) {
  __shared__ __align__(16) float sr[kTile][KP];
  __shared__ __align__(16) float sk[kTile][KP];
  __shared__ __align__(16) float sw[kTile][KP];   // exp(lw)
  __shared__ __align__(16) float su[KP];
  __shared__ float sv[kTile][kCols];

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * h_count + h;
  const int col = blockIdx.x * kCols + tid;
  const bool live = col < vd;

  for (int i = tid; i < KP; i += kCols) su[i] = i < kd ? u[(size_t)h * kd + i] : 0.f;
  float st[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i)
    st[i] = live && i < kd ? state0[(bh * kd + i) * vd + col] : 0.f;

  for (int t0 = 0; t0 < s; t0 += kTile) {
    const int n = min(kTile, s - t0);
    __syncthreads();                      // the previous tile is consumed
    for (int i = tid; i < kTile * KP; i += kCols) {
      const int j = i / KP, c = i % KP;
      const bool in = j < n && c < kd;
      const size_t g = (bh * s + t0 + j) * kd + c;
      sr[j][c] = in ? to_f32(r[g]) : 0.f;
      sk[j][c] = in ? to_f32(k[g]) : 0.f;
      sw[j][c] = in ? expf(lw[g]) : 0.f;
    }
    for (int j = 0; j < n; ++j)
      sv[j][tid] = live ? to_f32(v[(bh * s + t0 + j) * vd + col]) : 0.f;
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float vv = sv[j][tid];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        const float kv = sk[j][i] * vv;
        acc[i & 3] = fmaf(sr[j][i], st[i] + su[i] * kv, acc[i & 3]);
        st[i] = fmaf(sw[j][i], st[i], kv);
      }
      if (live)
        out[(bh * s + t0 + j) * vd + col] = from_f32<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < KP; ++i)
      if (i < kd) state[(bh * kd + i) * vd + col] = st[i];
  }
}

template <typename T, int KP>
cudaError_t launch_kp(const void* r, const void* k, const void* v, const void* lw, const void* u,
                      const void* state0, void* out, void* state, int b, int h, int s, int kd,
                      int vd, cudaStream_t stream) {
  dim3 grid((vd + kCols - 1) / kCols, h, b);
  wkv6_kernel<T, KP><<<grid, kCols, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lw), static_cast<const float*>(u),
      static_cast<const float*>(state0), static_cast<T*>(out), static_cast<float*>(state),
      h, s, kd, vd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
                   const void* state0, void* out, void* state, int b, int h, int s, int kd,
                   int vd, cudaStream_t stream) {
  if (kd <= 8) return launch_kp<T, 8>(r, k, v, lw, u, state0, out, state, b, h, s, kd, vd, stream);
  if (kd <= 16) return launch_kp<T, 16>(r, k, v, lw, u, state0, out, state, b, h, s, kd, vd, stream);
  if (kd <= 32) return launch_kp<T, 32>(r, k, v, lw, u, state0, out, state, b, h, s, kd, vd, stream);
  return launch_kp<T, 64>(r, k, v, lw, u, state0, out, state, b, h, s, kd, vd, stream);
}

}  // namespace

extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* lw,
                        const void* u, const void* state0, void* out, void* state, int b, int h,
                        int s, int kd, int vd, int is_bf16, void* stream) {
  if (b <= 0 || h <= 0 || vd <= 0) return (int)cudaSuccess;
  if (s < 0 || kd <= 0 || kd > kMaxK || b > 65535 || h > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16
      ? launch<__nv_bfloat16>(r, k, v, lw, u, state0, out, state, b, h, s, kd, vd, st)
      : launch<float>(r, k, v, lw, u, state0, out, state, b, h, s, kd, vd, st);
  return (int)e;
}
