// Fused LayerNorm forward for Hopper (sm_90a), float32 and bfloat16.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_kernels.py
// (_ln_fwd_kernel, launched by _fused_layer_norm_2d): LayerNorm over the
// last axis of x [rows, D] with affine weight and bias [D]; mean and
// variance in f32, the output stored in x's dtype.
//
// Design: one CTA per row. The row is loaded once into registers (at
// most kMaxPerThread elements per thread, neighbouring threads on
// neighbouring addresses), then two block reductions over the held
// values give the mean and the variance of the centred row, and the
// affine pass writes (x - mean) * rstd * w + b. Any row count is taken:
// the TPU kernel's row-block divisibility came from VMEM tiling.
//
// Bound: memory. The kernel must read x and w, b once and write y once,
// 2 * rows * D + 2 * D elements, against ~8 flops per element. Each x
// element is read from device memory exactly once (the row stays in
// registers between the passes); w and b are re-read per row but stay
// in L1/L2 across the CTAs of a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPerThread = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum over the CTA; every thread gets the total. `red` holds 33 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

template <typename T>
__global__ void ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                              const T* __restrict__ b, T* __restrict__ y, int D,
                              float eps) {
  __shared__ float red[33];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  float v[kMaxPerThread];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    v[k] = i < D ? to_f32(xr[i]) : 0.f;
    s += v[k];
  }
  const float mean = block_sum(s, red) / D;
  float s2 = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < D) {
      v[k] -= mean;
      s2 += v[k] * v[k];
    }
  }
  const float rstd = 1.f / sqrtf(block_sum(s2, red) / D + eps);
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < D) yr[i] = from_f32<T>(v[k] * rstd * to_f32(w[i]) + to_f32(b[i]));
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int rows, int D,
           float eps, cudaStream_t stream) {
  int threads = 128;
  while (threads * kMaxPerThread < D && threads < 1024) threads *= 2;
  if (threads * kMaxPerThread < D) return (int)cudaErrorInvalidValue;
  ln_fwd_kernel<T><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, b and y share it). D <= 16384.
// Returns cudaGetLastError() after the asynchronous launch on `stream`.
extern "C" int ln_fwd_launch(int dtype, const void* x, const void* w,
                             const void* b, void* y, int rows, int D, float eps,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, b, y, rows, D, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, b, y, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
