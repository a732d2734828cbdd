// Fused LayerNorm forward and backward for Hopper (sm_90a), float32,
// bfloat16 and float16, on two routes that the wrapper (ops/layer_norm.py, ln_route)
// chooses before the launch.
//
// Forward replaces the Pallas TPU kernel paddle_tpu/ops/pallas_kernels.py
// _ln_fwd_kernel (launched by _fused_layer_norm_2d): LayerNorm over the
// last axis of x [rows, D] with affine weight and bias [D]; mean and
// variance of the centred row in f32, the output stored in x's dtype.
// Backward replaces _ln_bwd_kernel (launched by _ln_bwd_rule): from x, w
// and the output gradient g it recomputes mean and rstd and writes
//   dx = (g*w - mean(g*w) - xhat * mean(g*w*xhat)) * rstd
// in x's dtype, and dw = sum_rows g*xhat, db = sum_rows g in w's dtype.
// No atomics on values: dw/db are the same bits on every run.
//
// Bound: memory on both. The forward must read x once and write y once
// (2 * rows * D elements, plus w and b), against ~8 flops an element; the
// backward must read x and g and write dx (3 * rows * D elements, plus w,
// dw, db). At f32 [8192, 768] that is 0.0150 ms and 0.0225 ms at 3.35 TB/s.
//
// Warp-row route (ln_fwd_warp_kernel, ln_bwd_warp_kernel): D <= 2048 that
// fills whole 16-byte vectors, 16-byte-aligned bases. One warp owns a row;
// lane l holds the row's 16-byte vectors l, l + 32, ... (neighbouring lanes
// on neighbouring addresses), V of them, templated on V. Reductions are
// warp shuffles: no __syncthreads between a row's load and its store.
// - Forward: one row per warp, every load of the row started before the
//   first reduction, the row kept in registers through both reductions,
//   16-byte stores. Warps per CTA follow the row count (rows / 128, 1 to
//   8), so ~512 engine rows still spread over ~128 CTAs.
// - Backward: a CTA of W warps (16 at D = 768) owns a fixed run of rows;
//   each warp walks its rows with a two-stage cp.async ring in shared
//   memory, so the next row's x and g are in flight while the current row
//   is reduced (four warp sums) and stored. Little's law: 3.35 TB/s over
//   132 SMs at ~1 us of loaded latency wants ~25 KB in flight an SM; at
//   D = 768 a warp keeps one row pair, 6 KB (f32) or 3 KB (bf16), in
//   flight, and an SM holds one 16-warp CTA: ~96 KB (f32) and ~48 KB
//   (bf16) an SM. (Deeper rings, 3 and 4 stages in bf16, measured slower
//   on the card.) w sits in shared memory as f32. Each lane keeps its
//   columns' dw/db partials in registers over its rows; the CTA's warps
//   meet once in shared memory in warp order, and the CTA writes one
//   partial. The CTA count is a function of the row count alone, capped
//   at 128 (never the SM count), and W of D and the dtype alone, so the
//   order of every sum is fixed by the shapes.
//   The partials are summed by a second launch, ln_bwd_reduce_kernel (the
//   row route's, in CTA order). A same-launch sum, where the last CTA to
//   finish a group of 16 (by a ticket counter after __threadfence) sums
//   the group and the last group sums the groups, measured slower on the
//   card: its chain of fences, tickets and L2 round trips sits after the
//   slowest CTA, where the second launch spreads the sum over 24 CTAs.
//   Registers (nvcc -Xptxas -v, sm_90a), no variant spilling: forward
//   24-95 by width, 70 at f32 D = 768 and 47 at bf16; backward 64-189,
//   96 at f32 D = 768 and 113 at bf16 (16-warp CTAs up to 24 values a
//   lane, launch bound 512; 8 warps above).
//
// Row route (ln_fwd_kernel, ln_bwd_kernel + ln_bwd_reduce_kernel): every
// other case up to D = 16384 (odd widths, widths that do not fill 16-byte
// vectors, unaligned bases, D > 2048). One CTA per row in the forward; in
// the backward one CTA per run of rows with per-CTA partials to a
// workspace and a second, fixed-order reduction kernel. Scalar loads,
// block reductions through shared memory. D > 4096 takes 512 or 1024
// threads a CTA, in a backward kernel bounded to fit them (it spills).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kMaxPerThread = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
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
__device__ __forceinline__ void ln_bwd_rows(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ dw_part,
    float* __restrict__ db_part, int rows, int D, int rows_per_cta,
    float eps) {
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

template <typename T>
__global__ void ln_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ dw_part,
    float* __restrict__ db_part, int rows, int D, int rows_per_cta,
    float eps) {
  ln_bwd_rows<T>(x, w, g, dx, dw_part, db_part, rows, D, rows_per_cta, eps);
}

// the same for 512 or 1024 threads (D > 4096), bounded so that the block
// fits the SM's registers
template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads) ln_bwd_wide_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ dw_part,
    float* __restrict__ db_part, int rows, int D, int rows_per_cta,
    float eps) {
  ln_bwd_rows<T>(x, w, g, dx, dw_part, db_part, rows, D, rows_per_cta, eps);
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
  auto kernel = threads <= 256   ? ln_bwd_kernel<T>
                : threads == 512 ? ln_bwd_wide_kernel<T, 512>
                                 : ln_bwd_wide_kernel<T, 1024>;
  kernel<<<n_part, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), dw_part, db_part, rows, D,
      per, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ln_bwd_reduce_kernel<T><<<(D + 31) / 32, 256, 0, stream>>>(
      dw_part, db_part, static_cast<T*>(dw), static_cast<T*>(db), n_part, D);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- warp-row route

constexpr int kWarpMaxD = 2048;      // widest row a warp holds
constexpr int kSmemMax = 232448 - 1024;  // a CTA's shared memory, less room
                                         // for its static part

// a 16-byte vector of T, unpacked to and packed from f32
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static __forceinline__ float2 unpair(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
  __device__ static __forceinline__ uint32_t pair(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    float2 t;
    t = unpair(u.x); f[0] = t.x; f[1] = t.y;
    t = unpair(u.y); f[2] = t.x; f[3] = t.y;
    t = unpair(u.z); f[4] = t.x; f[5] = t.y;
    t = unpair(u.w); f[6] = t.x; f[7] = t.y;
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                      pair(f[6], f[7]));
  }
};
template <>
struct Vec<__half> {
  static constexpr int N = 8;
  __device__ static __forceinline__ float2 unpair(uint32_t u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
  __device__ static __forceinline__ uint32_t pair(float a, float b) {
    __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    float2 t;
    t = unpair(u.x); f[0] = t.x; f[1] = t.y;
    t = unpair(u.y); f[2] = t.x; f[3] = t.y;
    t = unpair(u.z); f[4] = t.x; f[5] = t.y;
    t = unpair(u.w); f[6] = t.x; f[7] = t.y;
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                      pair(f[6], f[7]));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V 16-byte vectors a lane covers D <= kWarpMaxD: rounded up to one of
// 1, 2, 3, 4, 6, 8, 12, 16, the widths instantiated
inline int v_bucket(int nvec) {
  const int v = (nvec + 31) / 32;
  for (int b : {1, 2, 3, 4, 6, 8, 12, 16})
    if (v <= b) return b;
  return 0;
}

template <typename T, int V>
__global__ void __launch_bounds__(256, 1)
    ln_fwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ b, T* __restrict__ y, int rows,
                       int D, float eps) {
  using P = Vec<T>;
  constexpr int N = P::N;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;                 // the whole warp leaves together
  const int nvec = D / N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
  uint4 raw[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {            // every load in flight at once
    const int j = lane + 32 * k;
    raw[k] = j < nvec ? __ldg(xr + j) : make_uint4(0u, 0u, 0u, 0u);
  }
  float v[V][N];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    P::unpack(raw[k], v[k]);
#pragma unroll
    for (int i = 0; i < N; ++i) s += v[k][i];
  }
  const float mean = warp_sum(s) / D;
  float s2 = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (lane + 32 * k < nvec) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[k][i] -= mean;
        s2 += v[k][i] * v[k][i];
      }
    }
  }
  const float rstd = 1.f / sqrtf(warp_sum(s2) / D + eps);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  uint4* yr = reinterpret_cast<uint4*>(y + row * D);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = lane + 32 * k;
    if (j < nvec) {
      float wf[N], bf[N], o[N];
      P::unpack(__ldg(wv + j), wf);
      P::unpack(__ldg(bv + j), bf);
#pragma unroll
      for (int i = 0; i < N; ++i) o[i] = v[k][i] * rstd * wf[i] + bf[i];
      yr[j] = P::pack(o);
    }
  }
}

// the most warps a backward CTA of this width may have: 16 while a lane's
// dw/db partials are at most 2 x 24 floats (<= 128 registers a thread),
// else 8 (<= 255)
template <typename T, int V>
constexpr int bwd_max_warps() {
  return V * Vec<T>::N <= 24 ? 16 : 8;
}

// rows [blockIdx.x * rows_per_cta, +rows_per_cta) of x/g. Dynamic shared
// memory: w as f32 [D], then per warp a two-stage ring of (x row, g row),
// reused at the end for the warps' dw/db partials [W][2][D]. The CTA's
// dw/db partials go to part [2, gridDim.x, D], which ln_bwd_reduce_kernel
// sums.
template <typename T, int V>
__global__ void __launch_bounds__(32 * bwd_max_warps<T, V>(), 1)
    ln_bwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ g, T* __restrict__ dx,
                       float* __restrict__ part, int rows, int D,
                       int rows_per_cta, float eps) {
  using P = Vec<T>;
  constexpr int N = P::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = D / N;
  float* ws = reinterpret_cast<float*>(smem);
  uint4* ring = reinterpret_cast<uint4*>(smem + (size_t)D * sizeof(float)) +
                (size_t)warp * 4 * nvec;
  for (int i = threadIdx.x; i < D; i += blockDim.x) ws[i] = to_f32(w[i]);

  const int64_t r0 = (int64_t)blockIdx.x * rows_per_cta;
  const int64_t r1 =
      r0 + rows_per_cta < (int64_t)rows ? r0 + rows_per_cta : (int64_t)rows;
  // x and g of row r into ring stage `stage`; each lane copies the vectors
  // it will read itself, so the ring needs no barrier beyond wait_group
  auto fetch = [&](int64_t r, int stage) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + r * D);
    const uint4* gr = reinterpret_cast<const uint4*>(g + r * D);
    uint4* sx = ring + 2 * stage * nvec;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = lane + 32 * k;
      if (j < nvec) {
        cp_async16(sx + j, xr + j);
        cp_async16(sx + nvec + j, gr + j);
      }
    }
  };
  float pw[V][N], pb[V][N];
#pragma unroll
  for (int k = 0; k < V; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) pw[k][i] = pb[k][i] = 0.f;

  // the warp's rows are r0 + warp + i * W; row i + 1 is in flight while
  // row i is reduced and stored (one commit group a row, empty past the
  // end, so one group is pending at each wait)
  int64_t r = r0 + warp;
  if (r < r1) fetch(r, 0);
  cp_async_commit();
  __syncthreads();                         // ws is written
  for (int st = 0; r < r1; r += W, st ^= 1) {
    if (r + W < r1) fetch(r + W, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                    // row r has landed
    const uint4* sx = ring + 2 * st * nvec;
    const uint4* sg = sx + nvec;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = lane + 32 * k;
      if (j < nvec) {
        float f[N];
        P::unpack(sx[j], f);
#pragma unroll
        for (int i = 0; i < N; ++i) s += f[i];
      }
    }
    const float mean = warp_sum(s) / D;
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = lane + 32 * k;
      if (j < nvec) {
        float f[N];
        P::unpack(sx[j], f);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float c = f[i] - mean;
          s2 += c * c;
        }
      }
    }
    const float rstd = 1.f / sqrtf(warp_sum(s2) / D + eps);
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = lane + 32 * k;
      if (j < nvec) {
        float f[N], gf[N];
        P::unpack(sx[j], f);
        P::unpack(sg[j], gf);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float gw = gf[i] * ws[j * N + i];
          sa += gw;
          sb += gw * ((f[i] - mean) * rstd);
        }
      }
    }
    const float m1 = warp_sum(sa) / D;
    const float m2 = warp_sum(sb) / D;
    uint4* dxr = reinterpret_cast<uint4*>(dx + r * D);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = lane + 32 * k;
      if (j < nvec) {
        float f[N], gf[N], o[N];
        P::unpack(sx[j], f);
        P::unpack(sg[j], gf);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xh = (f[i] - mean) * rstd;
          o[i] = (gf[i] * ws[j * N + i] - m1 - xh * m2) * rstd;
          pw[k][i] += gf[i] * xh;
          pb[k][i] += gf[i];
        }
        dxr[j] = P::pack(o);
      }
    }
  }
  cp_async_wait<0>();

  // the CTA's warps meet in shared memory, in warp order
  __syncthreads();                         // every ring is drained
  float* comb = reinterpret_cast<float*>(smem + (size_t)D * sizeof(float));
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = lane + 32 * k;
    if (j < nvec) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        comb[(size_t)(2 * warp) * D + j * N + i] = pw[k][i];
        comb[(size_t)(2 * warp + 1) * D + j * N + i] = pb[k][i];
      }
    }
  }
  __syncthreads();
  // the CTA's partial, in the row route's layout: dw_part [gridDim.x, D]
  // then db_part [gridDim.x, D]
  const int n4 = D / 4;                    // float4s in a row of D
  const float4* comb4 = reinterpret_cast<const float4*>(comb);
  float4* dw4 = reinterpret_cast<float4*>(part) + (size_t)blockIdx.x * n4;
  float4* db4 = dw4 + (size_t)gridDim.x * n4;
  for (int c = threadIdx.x; c < 2 * n4; c += blockDim.x) {
    float4 a = comb4[c];
    for (int wp = 1; wp < W; ++wp) {
      const float4 t = comb4[(size_t)wp * 2 * n4 + c];
      a.x += t.x; a.y += t.y; a.z += t.z; a.w += t.w;
    }
    if (c < n4) dw4[c] = a;
    else db4[c - n4] = a;
  }
}

template <typename T, int V>
int launch_fwd_warp(const void* x, const void* w, const void* b, void* y,
                    int rows, int D, float eps, cudaStream_t stream) {
  int warps = rows / 128;                  // ~128 CTAs from ~256 rows up
  warps = warps >= 8 ? 8 : warps >= 4 ? 4 : warps >= 2 ? 2 : 1;
  const int ctas = (rows + warps - 1) / warps;
  ln_fwd_warp_kernel<T, V><<<ctas, 32 * warps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), rows, D, eps);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd_warp(const void* x, const void* w, const void* g, void* dx,
                    void* dw, void* db, float* part, int rows, int D,
                    int n_cta, int rows_per_cta, float eps,
                    cudaStream_t stream) {
  // as many warps as fit, up to bwd_max_warps, with two (x, g) row pairs
  // a warp
  const size_t ring = 4 * (size_t)D * sizeof(T);
  int warps = (int)((kSmemMax - (size_t)D * sizeof(float)) / ring);
  if (warps > bwd_max_warps<T, V>()) warps = bwd_max_warps<T, V>();
  const size_t smem = (size_t)D * sizeof(float) + (size_t)warps * ring;
  cudaError_t e = cudaFuncSetAttribute(
      ln_bwd_warp_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ln_bwd_warp_kernel<T, V><<<n_cta, 32 * warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), part, rows, D,
      rows_per_cta, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ln_bwd_reduce_kernel<T><<<(D + 31) / 32, 256, 0, stream>>>(
      part, part + (size_t)n_cta * D, static_cast<T*>(dw),
      static_cast<T*>(db), n_cta, D);
  return (int)cudaGetLastError();
}

// the warp-route launch of T for V = v_bucket(D / N); the bucket list is
// the switch's case list
template <typename T, template <typename, int> class L, typename... A>
int by_width(int D, A... args) {
  constexpr int N = Vec<T>::N;
  constexpr int kMaxV = kWarpMaxD / (32 * N);
  switch (v_bucket(D / N)) {
    case 1: return L<T, 1>::run(args...);
    case 2: return L<T, 2>::run(args...);
    case 3: return L<T, 3>::run(args...);
    case 4: return L<T, 4>::run(args...);
    case 6: if constexpr (kMaxV >= 6) return L<T, 6>::run(args...); break;
    case 8: if constexpr (kMaxV >= 8) return L<T, 8>::run(args...); break;
    case 12: if constexpr (kMaxV >= 12) return L<T, 12>::run(args...); break;
    case 16: if constexpr (kMaxV >= 16) return L<T, 16>::run(args...); break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int V>
struct FwdWarp {
  template <typename... A>
  static int run(A... a) { return launch_fwd_warp<T, V>(a...); }
};
template <typename T, int V>
struct BwdWarp {
  template <typename... A>
  static int run(A... a) { return launch_bwd_warp<T, V>(a...); }
};

// what the warp-row route takes: D fills whole 16-byte vectors, D <=
// kWarpMaxD, every base 16-byte aligned
inline bool warp_ok(int D, size_t elem,
                    std::initializer_list<const void*> ptrs) {
  if (D < 1 || D > kWarpMaxD || (D * elem) % 16 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, w, b and y share it).
// D <= 16384.
// Returns cudaGetLastError() after the asynchronous launch on `stream`.
// The row route.
extern "C" int ln_fwd_launch(int dtype, const void* x, const void* w,
                             const void* b, void* y, int rows, int D, float eps,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, b, y, rows, D, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, b, y, rows, D, eps, s);
  if (dtype == 2) return launch<__half>(x, w, b, y, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

// LayerNorm backward, the row route: x, w, g, dx, dw, db share `dtype` (0 =
// float32, 1 = bfloat16, 2 = float16); `part` is an f32 workspace of 2 * n_part * D
// floats; the rows split into n_part runs of ceil(rows / n_part). D <= 16384.
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
  if (dtype == 2)
    return launch_bwd<__half>(x, w, g, dx, dw, db, part, rows, D, n_part, eps,
                              s);
  return (int)cudaErrorInvalidValue;
}

// The forward on the warp-row route: as ln_fwd_launch, for D <= 2048 that
// fills whole 16-byte vectors and 16-byte-aligned x, w, b, y; anything
// else returns cudaErrorInvalidValue without a launch.
extern "C" int ln_fwd_warp_launch(int dtype, const void* x, const void* w,
                                  const void* b, void* y, int rows, int D,
                                  float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t elem = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || rows < 1 || !warp_ok(D, elem, {x, w, b, y}))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return by_width<float, FwdWarp>(D, x, w, b, y, rows, D, eps, s);
  if (dtype == 2)
    return by_width<__half, FwdWarp>(D, x, w, b, y, rows, D, eps, s);
  return by_width<__nv_bfloat16, FwdWarp>(D, x, w, b, y, rows, D, eps, s);
}

// The backward on the warp-row route, for what ln_fwd_warp_launch takes
// (x, w, g, dx aligned). The rows split into n_cta runs of rows_per_cta;
// `part` is an f32 workspace of 2 * n_cta * D floats. Two kernels: the
// warp-row kernel writes each CTA's dw/db partial there, and
// ln_bwd_reduce_kernel sums them in CTA order.
extern "C" int ln_bwd_warp_launch(int dtype, const void* x, const void* w,
                                  const void* g, void* dx, void* dw, void* db,
                                  float* part, int rows, int D, int n_cta,
                                  int rows_per_cta, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t elem = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || rows < 1 || n_cta < 1 ||
      rows_per_cta < 1 || (int64_t)n_cta * rows_per_cta < rows ||
      (int64_t)(n_cta - 1) * rows_per_cta >= rows ||
      !warp_ok(D, elem, {x, w, g, dx}))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return by_width<float, BwdWarp>(D, x, w, g, dx, dw, db, part, rows, D,
                                    n_cta, rows_per_cta, eps, s);
  if (dtype == 2)
    return by_width<__half, BwdWarp>(D, x, w, g, dx, dw, db, part, rows, D,
                                     n_cta, rows_per_cta, eps, s);
  return by_width<__nv_bfloat16, BwdWarp>(D, x, w, g, dx, dw, db, part, rows,
                                          D, n_cta, rows_per_cta, eps, s);
}
