// Fused LayerNorm forward and backward for Hopper (sm_90a), float32 and
// bfloat16.
//
// Forward replaces the Pallas TPU kernel paddle_tpu/ops/pallas_kernels.py
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
//
// Backward replaces _ln_bwd_kernel (launched by _ln_bwd_rule): from x, w
// and the output gradient g it recomputes mean and rstd and writes
//   dx = (g*w - mean(g*w) - xhat * mean(g*w*xhat)) * rstd
// in x's dtype, and dw = sum_rows g*xhat, db = sum_rows g in w's dtype.
// One CTA owns a fixed run of rows, holds each row in registers, and
// keeps per-column partial sums of g*xhat and g; it writes them to a
// [n_cta, D] f32 workspace (the TPU kernel's per-row-block partials,
// without its 8-sublane spread, a tiling artefact), and a second kernel
// sums the partials in a fixed order. No atomics: dw/db are the same bits
// on every run. Bound: memory, 3 * rows * D elements read or written
// (x, g, dx) plus 2 * D * (n_cta + 1) of partials.

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

// rows [r0, r0 + rows_per_cta) of x/g; partial dw/db of this CTA to
// dw_part/db_part [gridDim.x, D]
template <typename T>
__global__ void ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                              const T* __restrict__ g, T* __restrict__ dx,
                              float* __restrict__ dw_part,
                              float* __restrict__ db_part, int rows, int D,
                              int rows_per_cta, float eps) {
  __shared__ float red[33];
  float wv[kMaxPerThread], pw[kMaxPerThread], pb[kMaxPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    wv[k] = i < D ? to_f32(w[i]) : 0.f;
    pw[k] = pb[k] = 0.f;
  }
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_cta;
  const int64_t r1 =
      r0 + rows_per_cta < (int64_t)rows ? r0 + rows_per_cta : (int64_t)rows;
  for (int64_t row = r0; row < r1; ++row) {
    const T* xr = x + row * D;
    const T* gr = g + row * D;
    float xv[kMaxPerThread], gv[kMaxPerThread];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      xv[k] = i < D ? to_f32(xr[i]) : 0.f;
      gv[k] = i < D ? to_f32(gr[i]) : 0.f;
      s += xv[k];
    }
    const float mean = block_sum(s, red) / D;
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < D) {
        xv[k] -= mean;
        s2 += xv[k] * xv[k];
      }
    }
    const float rstd = 1.f / sqrtf(block_sum(s2, red) / D + eps);
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      xv[k] *= rstd;                      // xhat (0 past D)
      const float gw = gv[k] * wv[k];
      sa += gw;
      sb += gw * xv[k];
    }
    const float m1 = block_sum(sa, red) / D;
    const float m2 = block_sum(sb, red) / D;
    T* dxr = dx + row * D;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < D) {
        dxr[i] = from_f32<T>((gv[k] * wv[k] - m1 - xv[k] * m2) * rstd);
        pw[k] += gv[k] * xv[k];
        pb[k] += gv[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < D) {
      dw_part[(int64_t)blockIdx.x * D + i] = pw[k];
      db_part[(int64_t)blockIdx.x * D + i] = pb[k];
    }
  }
}

// dw/db [D] = sums of the [n_part, D] partials. A CTA owns 32 columns;
// its 8 thread rows stride the partials and meet in shared memory, in an
// order fixed by the shapes alone.
template <typename T>
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ dw_part,
                                     const float* __restrict__ db_part,
                                     T* __restrict__ dw, T* __restrict__ db,
                                     int n_part, int D) {
  __shared__ float sw[8][33], sb[8][33];
  const int cx = threadIdx.x & 31, cy = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + cx;
  float a = 0.f, b = 0.f;
  if (i < D) {
    for (int p = cy; p < n_part; p += 8) {
      a += dw_part[(int64_t)p * D + i];
      b += db_part[(int64_t)p * D + i];
    }
  }
  sw[cy][cx] = a;
  sb[cy][cx] = b;
  __syncthreads();
  if (cy == 0 && i < D) {
#pragma unroll
    for (int r = 1; r < 8; ++r) {
      a += sw[r][cx];
      b += sb[r][cx];
    }
    dw[i] = from_f32<T>(a);
    db[i] = from_f32<T>(b);
  }
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* g, void* dx,
               void* dw, void* db, float* part, int rows, int D,
               int n_part, float eps, cudaStream_t stream) {
  int threads = 128;
  while (threads * kMaxPerThread < D && threads < 1024) threads *= 2;
  if (threads * kMaxPerThread < D || n_part < 1) return (int)cudaErrorInvalidValue;
  const int per = (rows + n_part - 1) / n_part;
  float* dw_part = part;
  float* db_part = part + (size_t)n_part * D;
  ln_bwd_kernel<T><<<n_part, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), dw_part, db_part, rows, D,
      per, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ln_bwd_reduce_kernel<T><<<(D + 31) / 32, 256, 0, stream>>>(
      dw_part, db_part, static_cast<T*>(dw), static_cast<T*>(db), n_part, D);
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

// LayerNorm backward: x, w, g, dx, dw, db share `dtype` (0 = float32,
// 1 = bfloat16); `part` is an f32 workspace of 2 * n_part * D floats; the
// rows split into n_part runs of ceil(rows / n_part). D <= 16384.
extern "C" int ln_bwd_launch(int dtype, const void* x, const void* w,
                             const void* g, void* dx, void* dw, void* db,
                             float* part, int rows, int D, int n_part,
                             float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, w, g, dx, dw, db, part, rows, D, n_part, eps, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, w, g, dx, dw, db, part, rows, D,
                                     n_part, eps, s);
  return (int)cudaErrorInvalidValue;
}
