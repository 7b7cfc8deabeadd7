// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces: repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas (body
// _rmsnorm_kernel). Computes, per row of x (rows, D):
//     y = x * rsqrt(mean(x^2) + eps) * (scale_offset + w)
// in f32, cast back to x's type (f32 or bf16). scale_offset = 1.0 is the
// Gemma convention (weight stored as a delta around 1).
//
// Bound on the H100: bytes. Each row is read and written once and the
// arithmetic is a few operations per element, far below the ~295
// operations per byte where the tensor cores would become the limit.
//
// Design: one block of 256 threads per row. Threads walk the row in
// 16-byte vectors (8 bf16 or 4 f32 per load, neighbouring threads on
// neighbouring addresses), so any D is covered by a loop; a scalar path
// takes rows whose width is not a multiple of the vector. The sum of
// squares is taken in f32: per thread, then across the warp with
// shuffles, then across the 8 warps through shared memory. The second
// pass over the row re-reads x, which a row of at most tens of KB keeps
// in L1/L2, so device memory sees each byte once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               int d, float eps, float offset) {
  constexpr int VEC = 16 / sizeof(T);
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;
  const bool vec_ok = (d % VEC) == 0 &&
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % 16) == 0;

  float ss = 0.f;
  if (vec_ok) {
    for (int i = threadIdx.x * VEC; i < d; i += kThreads * VEC) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float f = to_f32(v[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      float f = to_f32(xr[i]);
      ss += f * f;
    }
  }

  __shared__ float partial[kThreads / 32];
  __shared__ float inv_rms;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) tot += partial[i];
    inv_rms = rsqrtf(tot / (float)d + eps);
  }
  __syncthreads();
  const float r = inv_rms;

  if (vec_ok) {
    for (int i = threadIdx.x * VEC; i < d; i += kThreads * VEC) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      uint4 wraw = *reinterpret_cast<const uint4*>(w + i);
      const T* v = reinterpret_cast<const T*>(&raw);
      const T* wv = reinterpret_cast<const T*>(&wraw);
      uint4 outraw;
      T* o = reinterpret_cast<T*>(&outraw);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o[j] = from_f32<T>(to_f32(v[j]) * r * (offset + to_f32(wv[j])));
      *reinterpret_cast<uint4*>(yr + i) = outraw;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      yr[i] = from_f32<T>(to_f32(xr[i]) * r * (offset + to_f32(w[i])));
  }
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int rows, int d,
                           float eps, float offset, int is_bf16, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), d, eps, offset);
  } else {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), d, eps, offset);
  }
  return (int)cudaGetLastError();
}
