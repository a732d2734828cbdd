// Fused AdamW update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_kernels.py
// (_adamw_kernel, launched by _fused_adamw_callable.run): one parameter's
// update in one pass,
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g
//   p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)
// with g widened to f32 and m, v f32. bc1 = 1 - b1^t and bc2 = 1 - b2^t
// come from the host. p, m and v are updated IN PLACE (the TPU kernel
// returned new arrays); p is f32 (a master copy or an f32 parameter),
// bf16 or f16, and `low`, when given beside an f32 p, receives p rounded
// to bf16 or f16 in the same pass: the O2 parameter written from its f32
// master. The TPU's padding of the flat parameter to 128 lanes is gone: a
// grid-stride loop takes any element count.
//
// Bound: memory. Per element the update reads p, g, m, v and writes p,
// m, v (and low): 28 bytes for an f32 master with a 16-bit gradient and
// copy, against ~15 flops. Neighbouring threads touch neighbouring
// elements, so every access is coalesced.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

template <typename P, typename G, typename L>
__global__ void adamw_kernel(P* __restrict__ p, const G* __restrict__ g,
                             float* __restrict__ m, float* __restrict__ v,
                             L* __restrict__ low, int64_t n, float lr,
                             float b1, float b2, float eps, float wd,
                             float bc1, float bc2) {
  const float c1 = 1.f - b1, c2 = 1.f - b2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gf = to_f32(g[i]);
    const float mi = b1 * m[i] + c1 * gf;
    const float vi = b2 * v[i] + c2 * gf * gf;
    const float pf = to_f32(p[i]);
    const float mhat = mi / bc1;
    const float vhat = vi / bc2;
    const float np = pf - lr * (mhat / (sqrtf(vhat) + eps) + wd * pf);
    store(p + i, np);
    m[i] = mi;
    v[i] = vi;
    if (low != nullptr) store(low + i, np);
  }
}

template <typename P, typename G, typename L>
int launch(void* p, const void* g, float* m, float* v, void* low, int64_t n,
           float lr, float b1, float b2, float eps, float wd, float bc1,
           float bc2, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond one wave
  adamw_kernel<P, G, L><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), m, v, static_cast<L*>(low),
      n, lr, b1, b2, eps, wd, bc1, bc2);
  return (int)cudaGetLastError();
}

// an f32 p takes a g of any dtype and a copy of either 16-bit dtype
template <typename G>
int launch_f32(int low_dtype, void* p, const void* g, float* m, float* v,
               void* low, int64_t n, float lr, float b1, float b2, float eps,
               float wd, float bc1, float bc2, cudaStream_t s) {
  if (low_dtype == 2)
    return launch<float, G, __half>(p, g, m, v, low, n, lr, b1, b2, eps, wd,
                                    bc1, bc2, s);
  if (low_dtype == 1 || low == nullptr)
    return launch<float, G, __nv_bfloat16>(p, g, m, v, low, n, lr, b1, b2, eps,
                                           wd, bc1, bc2, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// p_dtype / g_dtype / low_dtype: 0 = float32, 1 = bfloat16, 2 = float16.
// An f32 p takes any g; a bf16 or f16 p a g of its own dtype. m, v f32.
// `low` is a buffer of n elements of low_dtype (bf16 or f16) or NULL (only
// with an f32 p). All updates in place on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int adamw_launch(int p_dtype, int g_dtype, int low_dtype, void* p,
                            const void* g, float* m, float* v, void* low,
                            int64_t n, float lr, float b1, float b2, float eps,
                            float wd, float bc1, float bc2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0 && g_dtype == 0)
    return launch_f32<float>(low_dtype, p, g, m, v, low, n, lr, b1, b2, eps,
                             wd, bc1, bc2, s);
  if (p_dtype == 0 && g_dtype == 1)
    return launch_f32<__nv_bfloat16>(low_dtype, p, g, m, v, low, n, lr, b1, b2,
                                     eps, wd, bc1, bc2, s);
  if (p_dtype == 0 && g_dtype == 2)
    return launch_f32<__half>(low_dtype, p, g, m, v, low, n, lr, b1, b2, eps,
                              wd, bc1, bc2, s);
  if (low != nullptr) return (int)cudaErrorInvalidValue;
  if (p_dtype == 1 && g_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        p, g, m, v, low, n, lr, b1, b2, eps, wd, bc1, bc2, s);
  if (p_dtype == 2 && g_dtype == 2)
    return launch<__half, __half, __half>(p, g, m, v, low, n, lr, b1, b2, eps,
                                          wd, bc1, bc2, s);
  return (int)cudaErrorInvalidValue;
}
