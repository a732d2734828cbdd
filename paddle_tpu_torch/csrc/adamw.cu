// Fused AdamW update for Hopper (sm_90a), many tensors a launch.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_kernels.py
// (_adamw_kernel, launched by _fused_adamw_callable.run), which the JAX
// package's eager step launches once per parameter. Here one launch
// updates up to kMaxTensors tensors of one dtype combination, each
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g
//   p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)
// with g widened to f32 and m, v f32; lr, wd, bc1 = 1 - b1^t and
// bc2 = 1 - b2^t are the tensor's own (its learning-rate multiplier, its
// decay decision and its own step), from the host. p, m and v are
// updated IN PLACE (the TPU kernel returned new arrays); p is f32 (a
// master copy or an f32 parameter), bf16 or f16, and `low`, when given
// beside an f32 p, receives p rounded to bf16 or f16 in the same pass:
// the O2 parameter written from its f32 master. The reference updates a
// list of parameters in one op the same way (merged_adam).
//
// Bound: memory. Per element the update reads p, g, m, v and writes p,
// m, v (and low): 28 bytes for an f32 p and g, or for an f32 master with
// a 16-bit gradient and copy, against ~15 flops. So the design keeps
// bytes in flight and launches few:
//  - the host cuts every tensor into chunks of kChunk elements and packs
//    up to kMaxTensors descriptors and kMaxChunks chunk entries into one
//    by-value parameter struct (no table is copied to the card, so
//    nothing on the host must outlive the launch and a step never
//    synchronises);
//  - each chunk is kSplit units of kUnit elements, and the grid is as
//    many CTAs as the card holds at once (at most one a unit), each
//    striding over the units: a launch of a few hundred chunks still
//    fills every SM, and no SM waits on a last wave of whole chunks;
//  - each thread moves 4 consecutive elements a vector, 16-byte loads
//    and stores of f32 p, m and v and 8-byte ones of 16-bit g, p and
//    low, kUnroll vectors in flight before any store;
//  - a tensor whose pointers are not all aligned to their vector's width
//    (a view at an odd offset), and the n % 4 tail, take the scalar loop
//    of the same kernel.
// The arithmetic is the single-tensor kernel's, expression for
// expression: divisions (no reciprocal), IEEE sqrtf, no fast-math.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// kChunk is ADAMW_CHUNK, kMaxTensors ADAMW_MAX_TENSORS and kMaxChunks
// ADAMW_MAX_CHUNKS of ops/fused_adamw.py, whose plan these limits bound.
constexpr int64_t kChunk = 65536;
constexpr int64_t kUnit = 2048;
constexpr int kSplit = kChunk / kUnit;
constexpr int kMaxTensors = 36;
constexpr int kMaxChunks = 440;
constexpr int kThreads = 256;
constexpr int kUnroll = 2;
// a chunk entry: the tensor's slot in the launch above kSlotShift, the
// chunk's index within the tensor below it
constexpr int kSlotShift = 24;

struct Tensor {            // 64 bytes
  void* p;
  const void* g;
  float* m;
  float* v;
  void* low;
  int64_t n;
  float lr, wd, bc1, bc2;
};

struct Args {
  Tensor t[kMaxTensors];
  uint32_t chunk[kMaxChunks];
  int n_chunks;
  float b1, b2, eps;
};
// the kernel parameter space a launch may use (4 KB)
static_assert(sizeof(Args) <= 4096, "AdamW launch struct over 4 KB");
static_assert(kChunk % kUnit == 0 && kUnit % (4 * kThreads * kUnroll) == 0,
              "a chunk of whole units, a unit of whole rounds");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void from_f32(__half* p, float x) {
  *p = __float2half_rn(x);
}

// four consecutive elements, one 16-byte (f32) or 8-byte (16-bit) access
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T x[4];
};

template <typename T>
__device__ __forceinline__ bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % sizeof(Vec4<T>) == 0;
}

__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v,
                                      const Tensor& t, float b1, float b2,
                                      float c1, float c2, float eps) {
  const float mi = b1 * m + c1 * g;
  const float vi = b2 * v + c2 * g * g;
  const float mhat = mi / t.bc1;
  const float vhat = vi / t.bc2;
  p = p - t.lr * (mhat / (sqrtf(vhat) + eps) + t.wd * p);
  m = mi;
  v = vi;
}

// elements [start, start + len) of tensor t
template <typename P, typename G, typename L>
__device__ __forceinline__ void update(const Tensor& t, int64_t start,
                                       int64_t len, float b1, float b2,
                                       float eps) {
  P* __restrict__ p = static_cast<P*>(t.p) + start;
  const G* __restrict__ g = static_cast<const G*>(t.g) + start;
  float* __restrict__ m = t.m + start;
  float* __restrict__ v = t.v + start;
  L* __restrict__ low = t.low ? static_cast<L*>(t.low) + start : nullptr;
  const float c1 = 1.f - b1, c2 = 1.f - b2;
  // units start at multiples of kUnit elements, so a tensor whose base
  // is aligned has every unit aligned
  const bool vec = aligned<P>(p) && aligned<G>(g) && aligned<float>(m) &&
                   aligned<float>(v) && (low == nullptr || aligned<L>(low));
  int64_t done = 0;
  if (vec) {
    const int64_t nvec = len / 4;
    const Vec4<P>* pv = reinterpret_cast<const Vec4<P>*>(p);
    const Vec4<G>* gv = reinterpret_cast<const Vec4<G>*>(g);
    const Vec4<float>* mv = reinterpret_cast<const Vec4<float>*>(m);
    const Vec4<float>* vv = reinterpret_cast<const Vec4<float>*>(v);
    for (int64_t base = threadIdx.x; base < nvec;
         base += kThreads * kUnroll) {
      Vec4<P> pr[kUnroll];
      Vec4<G> gr[kUnroll];
      Vec4<float> mr[kUnroll], vr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * kThreads;
        if (i < nvec) {
          pr[u] = pv[i];
          gr[u] = gv[i];
          mr[u] = mv[i];
          vr[u] = vv[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * kThreads;
        if (i < nvec) {
          Vec4<P> po;
          Vec4<L> lo;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float pf = to_f32(pr[u].x[k]);
            adamw(pf, to_f32(gr[u].x[k]), mr[u].x[k], vr[u].x[k], t, b1, b2,
                  c1, c2, eps);
            from_f32(&po.x[k], pf);
            from_f32(&lo.x[k], pf);
          }
          reinterpret_cast<Vec4<P>*>(p)[i] = po;
          reinterpret_cast<Vec4<float>*>(m)[i] = mr[u];
          reinterpret_cast<Vec4<float>*>(v)[i] = vr[u];
          if (low != nullptr) reinterpret_cast<Vec4<L>*>(low)[i] = lo;
        }
      }
    }
    done = nvec * 4;
  }
  for (int64_t i = done + threadIdx.x; i < len; i += kThreads) {
    float pf = to_f32(p[i]);
    float mi = m[i], vi = v[i];
    adamw(pf, to_f32(g[i]), mi, vi, t, b1, b2, c1, c2, eps);
    from_f32(p + i, pf);
    m[i] = mi;
    v[i] = vi;
    if (low != nullptr) from_f32(low + i, pf);
  }
}

template <typename P, typename G, typename L>
__global__ void __launch_bounds__(kThreads, 4)
    adamw_kernel(const __grid_constant__ Args a) {
  const int units = a.n_chunks * kSplit;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const uint32_t entry = a.chunk[u / kSplit];
    const Tensor& t = a.t[entry >> kSlotShift];
    const int64_t start =
        (int64_t)(entry & ((1u << kSlotShift) - 1)) * kChunk +
        (int64_t)(u % kSplit) * kUnit;
    if (start < t.n)
      update<P, G, L>(t, start, t.n - start < kUnit ? t.n - start : kUnit,
                      a.b1, a.b2, a.eps);
  }
}

// the CTAs of this instantiation the current device holds at once
template <typename P, typename G, typename L>
int resident_ctas() {
  static int ctas = 0;     // one card model a process
  if (ctas == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adamw_kernel<P, G, L>, kThreads, 0);
    ctas = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return ctas;
}

template <typename P, typename G, typename L>
int launch(const Args& a, cudaStream_t s) {
  const int units = a.n_chunks * kSplit;
  const int cap = resident_ctas<P, G, L>();
  adamw_kernel<P, G, L><<<units < cap ? units : cap, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// an f32 p takes a g of any dtype and a copy of either 16-bit dtype or
// none (then L is only a placeholder: low is NULL)
template <typename G>
int launch_f32(int low_dtype, const Args& a, cudaStream_t s) {
  if (low_dtype == 2) return launch<float, G, __half>(a, s);
  if (low_dtype == 1 || low_dtype < 0)
    return launch<float, G, __nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

int dispatch(int p_dtype, int g_dtype, int low_dtype, const Args& a,
             cudaStream_t s) {
  if (p_dtype == 0 && g_dtype == 0)
    return launch_f32<float>(low_dtype, a, s);
  if (p_dtype == 0 && g_dtype == 1)
    return launch_f32<__nv_bfloat16>(low_dtype, a, s);
  if (p_dtype == 0 && g_dtype == 2)
    return launch_f32<__half>(low_dtype, a, s);
  if (low_dtype >= 0) return (int)cudaErrorInvalidValue;
  if (p_dtype == 1 && g_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(a, s);
  if (p_dtype == 2 && g_dtype == 2)
    return launch<__half, __half, __half>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The launches of one plan (ops/fused_adamw.py adamw_plan) on `stream`.
// Tensor i's operands are ptrs[5i .. 5i+4] = p, g, m, v, low (low NULL
// for none), its element count numel[i], its scalars scalars[4i .. 4i+3]
// = lr, wd, bc1, bc2. Launch l updates the tensors
// tensors[tensor_off[l] .. tensor_off[l+1]) (slot j = the j-th of them)
// over the chunk entries chunks[chunk_off[l] .. chunk_off[l+1]), each
// slot << 24 | chunk index, kSplit units an entry; kinds[3l .. 3l+2] are its
// p, g and low dtypes (0 = float32, 1 = bfloat16, 2 = float16, low -1
// for none). An f32 p takes any g; a bf16 or f16 p a g of its own dtype
// and no low. m, v f32. Returns the first nonzero cudaGetLastError()
// after a launch, or cudaErrorInvalidValue for a launch over the limits
// or of a dtype combination the kernel does not take.
extern "C" int adamw_group_launch(int n_launches, const int32_t* kinds,
                                  const int32_t* tensor_off,
                                  const int32_t* tensors,
                                  const int32_t* chunk_off,
                                  const uint32_t* chunks, void* const* ptrs,
                                  const int64_t* numel, const float* scalars,
                                  float b1, float b2, float eps,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  memset(&a, 0, sizeof(a));
  a.b1 = b1;
  a.b2 = b2;
  a.eps = eps;
  for (int l = 0; l < n_launches; ++l) {
    const int nt = tensor_off[l + 1] - tensor_off[l];
    const int nc = chunk_off[l + 1] - chunk_off[l];
    if (nt <= 0 || nt > kMaxTensors || nc <= 0 || nc > kMaxChunks)
      return (int)cudaErrorInvalidValue;
    for (int j = 0; j < nt; ++j) {
      const int i = tensors[tensor_off[l] + j];
      Tensor& t = a.t[j];
      t.p = ptrs[5 * i];
      t.g = ptrs[5 * i + 1];
      t.m = static_cast<float*>(ptrs[5 * i + 2]);
      t.v = static_cast<float*>(ptrs[5 * i + 3]);
      t.low = ptrs[5 * i + 4];
      t.n = numel[i];
      t.lr = scalars[4 * i];
      t.wd = scalars[4 * i + 1];
      t.bc1 = scalars[4 * i + 2];
      t.bc2 = scalars[4 * i + 3];
    }
    memcpy(a.chunk, chunks + chunk_off[l], sizeof(uint32_t) * nc);
    a.n_chunks = nc;
    const int rc = dispatch(kinds[3 * l], kinds[3 * l + 1], kinds[3 * l + 2],
                            a, s);
    if (rc != 0) return rc;
  }
  return 0;
}
