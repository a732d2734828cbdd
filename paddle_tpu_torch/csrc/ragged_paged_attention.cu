// Ragged paged attention for Hopper (sm_90a): K1 over float pools
// (float32, bfloat16, float16) and K1q over quantized pools (int8,
// float8_e4m3fn).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/ragged_paged_attention.py
// (_rpa_kernel, launched by ragged_paged_attention, with its quantized
// branch for int8/fp8 pools). Same contract:
//   q      [H, Qp, Dh]                 flattened padded query rows,
//                                      f32/bf16/f16
//   pool   [L, 2, NB+1, H, bs, Dh]     the whole KV block pool; `layer`
//                                      selects a plane by pointer offset,
//                                      no per-layer slice is made
//   scales [L, 2, NB+1, H] f32         K1q only: per-(block, head) max-abs
//                                      scale of the codes, read whole too
//   blk_seq [Qp/8], seq_qstart/seq_pos0/lo/kv_len [S], tables [S, T]  int32
//   out    [H, Qp, Dh]                 in q's dtype
// A row at virtual position p attends to cache columns [lo, p] of its
// sequence, read through the sequence's page table.
//
// Design (simple first): one CTA per (q block of 8 rows, head). The CTA
// reads its own metadata from global memory (the TPU's scalar prefetch),
// then loops over the sequence's ceil(kv_len / bs) blocks (the TPU's
// sequential grid and its scratch carry): each [bs, Dh] K and V tile is
// copied into shared memory with 16-byte loads and widened to f32, the
// 8 x bs scores are masked to [lo, qpos] with a -1e30 fill, and an
// online softmax keeps m, l and an f32 accumulator [8, Dh] in shared
// memory. P is rounded to V's dtype before the PV product, as the TPU
// kernel's dot takes it; the output is acc / max(l, 1e-30).
//
// One loop serves both kernels, templated on the storage type S and the
// compute type C (q's dtype). K1 has S == C. K1q reads 16 one-byte codes
// per 16-byte load, multiplies each by its block's scale in f32 and
// rounds the product to C: the in-register dequant of the TPU kernel.
// V's dtype, to which P is rounded, is C in both.
//
// Bound: memory. Per launch the kernel must read every KV block the
// batch owns once per head (sum over sequences of ceil(kv_len/bs) * bs *
// H * Dh * 2 elements of S, plus one scale per block, head and K/V for
// K1q) plus q, and write o; the arithmetic is ~4 flops per KV element
// per q row, far below the card's ~295 flop/byte ridge. What the design
// does about it: only the blocks a sequence owns are read (nothing is
// gathered or padded to the table bucket), tiles are read with coalesced
// 16-byte loads, and the pool is never copied or dequantized into a
// float copy. A decode row still costs a whole 8-row q block, and each
// of the 8 rows re-reads the tile from shared memory, not from device
// memory.
//
// Pool offsets are 64-bit: L * 2 * (NB+1) * H * bs * Dh passes 2^31
// elements for large pools. Pad rows inside a real q block compute
// finite masked values nobody reads; pad blocks (blk_seq < 0) write 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 8;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return (float)x; }

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

// x rounded to C and widened back: the value a C operand holds
template <typename C>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<C>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy a contiguous [rows, dh] tile of S from device memory into f32
// shared memory with row stride ld, one 16-byte vector per thread per
// step (dh is a multiple of the vector width and the tile base is
// 16-byte aligned). Quantized storage (1-byte S) is dequantized on the
// way: code * scale in f32, rounded to C.
template <typename S, typename C>
__device__ __forceinline__ void load_tile(const S* __restrict__ src, float* dst,
                                          int rows, int dh, int ld,
                                          float qscale) {
  constexpr int kVec = 16 / sizeof(S);
  constexpr bool kQuant = sizeof(S) == 1;
  const int vec_per_row = dh / kVec;
  const int total = rows * vec_per_row;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / vec_per_row;
    const int c = (i - r * vec_per_row) * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (int64_t)r * dh + c);
    const S* v = reinterpret_cast<const S*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if constexpr (kQuant)
        dst[r * ld + c + e] = round_to<C>(to_f32(v[e]) * qscale);
      else
        dst[r * ld + c + e] = to_f32(v[e]);
    }
  }
}

// S: pool storage type; C: q's, o's and V's compute type. scales is
// null for float pools (S == C).
template <typename S, typename C>
__global__ void __launch_bounds__(kThreads)
rpa_kernel(const C* __restrict__ q, const S* __restrict__ pool,
           const float* __restrict__ scales, C* __restrict__ out,
           const int* __restrict__ blk_seq, const int* __restrict__ seq_qstart,
           const int* __restrict__ seq_pos0, const int* __restrict__ tables,
           const int* __restrict__ lo_arr, const int* __restrict__ kv_len_arr,
           int H, int Qp, int Dh, int NB1, int bs, int T_len, int layer,
           float scale) {
  const int b = blockIdx.x;   // q block
  const int h = blockIdx.y;   // head
  const int tid = threadIdx.x;
  const int64_t q_off = ((int64_t)h * Qp + (int64_t)b * kBlockQ) * Dh;
  C* o = out + q_off;
  const int seq = blk_seq[b];
  if (seq < 0) {
    for (int i = tid; i < kBlockQ * Dh; i += blockDim.x) o[i] = from_f32<C>(0.f);
    return;
  }

  extern __shared__ float smem[];
  const int ldk = Dh + 1;                 // padded: score reads hit distinct banks
  float* q_s = smem;                      // [8][Dh]
  float* k_s = q_s + kBlockQ * Dh;        // [bs][Dh + 1]
  float* v_s = k_s + bs * ldk;            // [bs][Dh]
  float* p_s = v_s + bs * Dh;             // [8][bs] scores, then probabilities
  float* acc_s = p_s + kBlockQ * bs;      // [8][Dh]
  float* m_s = acc_s + kBlockQ * Dh;      // [8] running max
  float* l_s = m_s + kBlockQ;             // [8] running sum
  float* a_s = l_s + kBlockQ;             // [8] rescale of this step

  // virtual cache position of row 0 of this block: the rows of a
  // sequence are consecutive tokens starting at seq_pos0
  const int qpos0 = seq_pos0[seq] + b * kBlockQ - seq_qstart[seq];
  const int lo = lo_arr[seq];
  const int n_kv = (kv_len_arr[seq] + bs - 1) / bs;
  const int* table = tables + (int64_t)seq * T_len;

  load_tile<C, C>(q + q_off, q_s, kBlockQ, Dh, Dh, 1.f);
  for (int i = tid; i < kBlockQ * Dh; i += blockDim.x) acc_s[i] = 0.f;
  if (tid < kBlockQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int64_t tile = (int64_t)bs * Dh;
  const int64_t block_stride = (int64_t)H * tile;
  const int64_t kv_stride = (int64_t)NB1 * block_stride;
  const S* k_base = pool + (int64_t)layer * 2 * kv_stride + (int64_t)h * tile;
  const S* v_base = k_base + kv_stride;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_warps = blockDim.x >> 5;

  for (int j = 0; j < n_kv; ++j) {
    const int64_t pid = table[j];
    float k_scale = 1.f, v_scale = 1.f;
    if constexpr (sizeof(S) == 1) {   // scales[layer, kv, pid, h]
      const int64_t k_at = (((int64_t)layer * 2) * NB1 + pid) * H + h;
      k_scale = scales[k_at];
      v_scale = scales[k_at + (int64_t)NB1 * H];
    }
    __syncthreads();   // the previous step's readers of k_s / v_s / p_s are done
    load_tile<S, C>(k_base + pid * block_stride, k_s, bs, Dh, ldk, k_scale);
    load_tile<S, C>(v_base + pid * block_stride, v_s, bs, Dh, Dh, v_scale);
    __syncthreads();
    for (int i = tid; i < kBlockQ * bs; i += blockDim.x) {
      const int r = i / bs;
      const int c = i - r * bs;
      const float* qr = q_s + r * Dh;
      const float* kc = k_s + c * ldk;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], kc[d], s);
      s *= scale;
      const int col = j * bs + c;
      if (col < lo || col > qpos0 + r) s = kNegInf;
      p_s[i] = s;
    }
    __syncthreads();
    for (int r = warp; r < kBlockQ; r += n_warps) {
      float* pr = p_s + r * bs;
      float mx = kNegInf;
      for (int c = lane; c < bs; c += 32) mx = fmaxf(mx, pr[c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < bs; c += 32) {
        const float p = expf(pr[c] - m_new);
        pr[c] = round_to<C>(p);   // PV takes P in V's dtype; l sums it unrounded
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // each thread owns the same accumulator entries on every step
    for (int i = tid; i < kBlockQ * Dh; i += blockDim.x) {
      const int r = i / Dh;
      const int d = i - r * Dh;
      const float* pr = p_s + r * bs;
      float a = acc_s[i] * a_s[r];
      for (int c = 0; c < bs; ++c) a = fmaf(pr[c], v_s[c * Dh + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < kBlockQ * Dh; i += blockDim.x) {
    o[i] = from_f32<C>(acc_s[i] / fmaxf(l_s[i / Dh], 1e-30f));
  }
}

template <typename S, typename C>
int launch(const void* q, const void* pool, const float* scales, void* out,
           const int* blk_seq, const int* seq_qstart, const int* seq_pos0,
           const int* tables, const int* lo, const int* kv_len, int H, int Qp,
           int Dh, int NB1, int bs, int T_len, int layer, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBlockQ * Dh + (size_t)bs * (Dh + 1) + (size_t)bs * Dh +
       (size_t)kBlockQ * bs + (size_t)kBlockQ * Dh + 3 * kBlockQ);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rpa_kernel<S, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(Qp / kBlockQ, H);
  rpa_kernel<S, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const C*>(q), static_cast<const S*>(pool), scales,
      static_cast<C*>(out), blk_seq, seq_qstart, seq_pos0, tables, lo, kv_len,
      H, Qp, Dh, NB1, bs, T_len, layer, scale);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_quant(int dtype, const void* q, const void* pool, const float* scales,
                 void* out, const int* blk_seq, const int* seq_qstart,
                 const int* seq_pos0, const int* tables, const int* lo,
                 const int* kv_len, int H, int Qp, int Dh, int NB1, int bs,
                 int T_len, int layer, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch<S, float>(q, pool, scales, out, blk_seq, seq_qstart, seq_pos0,
                            tables, lo, kv_len, H, Qp, Dh, NB1, bs, T_len, layer,
                            scale, s);
  if (dtype == 1)
    return launch<S, __nv_bfloat16>(q, pool, scales, out, blk_seq, seq_qstart,
                                    seq_pos0, tables, lo, kv_len, H, Qp, Dh, NB1,
                                    bs, T_len, layer, scale, s);
  if (dtype == 2)
    return launch<S, __half>(q, pool, scales, out, blk_seq, seq_qstart,
                             seq_pos0, tables, lo, kv_len, H, Qp, Dh, NB1, bs,
                             T_len, layer, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K1, float pools. dtype: 0 = float32, 1 = bfloat16, 2 = float16, for q,
// pool and out.
// Returns cudaGetLastError() after the launch (0 = success); the launch
// is asynchronous on `stream`.
extern "C" int rpa_launch(int dtype, const void* q, const void* pool, void* out,
                          const int* blk_seq, const int* seq_qstart,
                          const int* seq_pos0, const int* tables, const int* lo,
                          const int* kv_len, int H, int Qp, int Dh, int NB1,
                          int bs, int T_len, int layer, float scale,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q, pool, nullptr, out, blk_seq, seq_qstart,
                                seq_pos0, tables, lo, kv_len, H, Qp, Dh, NB1, bs,
                                T_len, layer, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, pool, nullptr, out, blk_seq, seq_qstart, seq_pos0, tables, lo, kv_len,
        H, Qp, Dh, NB1, bs, T_len, layer, scale, s);
  if (dtype == 2)
    return launch<__half, __half>(q, pool, nullptr, out, blk_seq, seq_qstart,
                                  seq_pos0, tables, lo, kv_len, H, Qp, Dh,
                                  NB1, bs, T_len, layer, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K1q, quantized pools. storage: 0 = int8, 1 = float8_e4m3fn codes in the
// pool; dtype: 0 = float32, 1 = bfloat16, 2 = float16 for q and out.
// scales is the float32 [L, 2, NB+1, H] array. Returns cudaGetLastError() after the
// launch; asynchronous on `stream`.
extern "C" int rpa_quant_launch(int storage, int dtype, const void* q,
                                const void* pool, const float* scales, void* out,
                                const int* blk_seq, const int* seq_qstart,
                                const int* seq_pos0, const int* tables,
                                const int* lo, const int* kv_len, int H, int Qp,
                                int Dh, int NB1, int bs, int T_len, int layer,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == 0)
    return launch_quant<int8_t>(dtype, q, pool, scales, out, blk_seq, seq_qstart,
                                seq_pos0, tables, lo, kv_len, H, Qp, Dh, NB1, bs,
                                T_len, layer, scale, s);
  if (storage == 1)
    return launch_quant<__nv_fp8_e4m3>(dtype, q, pool, scales, out, blk_seq,
                                       seq_qstart, seq_pos0, tables, lo, kv_len,
                                       H, Qp, Dh, NB1, bs, T_len, layer, scale,
                                       s);
  return (int)cudaErrorInvalidValue;
}
