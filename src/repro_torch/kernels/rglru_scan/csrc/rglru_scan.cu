// RG-LRU gated linear recurrence for Hopper (sm_90a).
//
// Replaces: repro/kernels/rglru_scan/kernel.py::rglru_scan_pallas (body
// _rglru_kernel). For each (b, d) channel, from h0[b, d]:
//     h_t = exp(log_a[b, t, d]) * h_{t-1} + x[b, t, d],   t = 0 .. S-1
// in f32; every h_t is stored in the input type (f32 or bf16) and the
// last one is written to hlast[b, d]. S = 1 is Griffin's decode step.
//
// Bound on the H100: bytes. Each element of log_a and x is read once and
// each h_t written once, for 3 operations (exp, multiply, add): far below
// the operations per byte where arithmetic would be the limit.
//
// Design: one thread per (b, d) channel, blocks of 128 channels along D
// and one grid row per batch entry, so a warp's loads and stores at step
// t fall on 32 neighbouring addresses. Each thread carries h in an f32
// register across the whole sequence: the recurrence is sequential in t,
// and the TPU kernel's VMEM scratch that carried h across time blocks
// becomes this loop. The loop loads kUnroll steps of log_a and x into
// registers before it uses them, so that many loads are in flight per
// thread instead of one. Channels d >= D are masked, and a sequence tail
// shorter than kUnroll is masked in the loop, so any S >= 0 and any D are
// taken (no S % block_s or D % block_d assert). At prefill with small
// B * D the grid has few blocks (20 for B = 1, D = 2560) and each thread
// walks all of S; a chunked two-pass scan over S for more parallelism is
// left to a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ log_a, const T* __restrict__ x,
                  const T* __restrict__ h0, T* __restrict__ hs, T* __restrict__ hlast,
                  int s, int d) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= d) return;
  const int b = blockIdx.y;
  const size_t base = (size_t)b * s * d + ch;
  float h = to_f32(h0[(size_t)b * d + ch]);
  for (int t0 = 0; t0 < s; t0 += kUnroll) {
    float la[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + (size_t)(t0 + u) * d;
      la[u] = t0 + u < s ? to_f32(log_a[i]) : 0.f;
      xv[u] = t0 + u < s ? to_f32(x[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < s) {
        h = expf(la[u]) * h + xv[u];
        hs[base + (size_t)(t0 + u) * d] = from_f32<T>(h);
      }
    }
  }
  hlast[(size_t)b * d + ch] = from_f32<T>(h);
}

template <typename T>
cudaError_t launch(const void* log_a, const void* x, const void* h0, void* hs, void* hlast,
                   int b, int s, int d, cudaStream_t stream) {
  dim3 grid((d + kThreads - 1) / kThreads, b);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(log_a), static_cast<const T*>(x), static_cast<const T*>(h0),
      static_cast<T*>(hs), static_cast<T*>(hlast), s, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rglru_scan_fwd(const void* log_a, const void* x, const void* h0, void* hs,
                              void* hlast, int b, int s, int d, int is_bf16, void* stream) {
  if (b <= 0 || d <= 0) return (int)cudaSuccess;
  if (s < 0 || b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16
      ? launch<__nv_bfloat16>(log_a, x, h0, hs, hlast, b, s, d, st)
      : launch<float>(log_a, x, h0, hs, hlast, b, s, d, st);
  return (int)e;
}
