// Flash attention, forward and backward, for Hopper (sm_90a), float32,
// bfloat16 and float16.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_kernels.py:
//   forward   _fa_fwd_kernel (_fa_call_fwd) and its VMEM-resident twin
//             _fa_fwd_kernel_resident (_fa_call_fwd_resident);
//   backward  _fa_dq_kernel + _fa_dkv_kernel (_fa_call_bwd) and the
//             resident pair (_fa_call_bwd_resident).
// The TPU chose between streaming and resident variants by a VMEM budget;
// here one kernel of each kind streams K/V (or Q/dO) tiles through shared
// memory for every length.
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, H, D], contiguous, read in place (no
// transpose to [B*H, S, D]); o like q; lse [B, H, Sq] f32 (the TPU's
// 8-lane replication of the LSE was a Mosaic tiling artefact). Any Sq, Sk:
// tails are masked instead of demanding S % block == 0. D <= 256, padded
// with zeros to the kernel's tile width KD (32, 64, 128 or 256).
//
// Numerics follow the TPU kernels: scores s = (q . k) * scale in f32, the
// masked score is -1e30 (causal: row >= col, top-left aligned), the
// online softmax keeps m, l and an f32 accumulator, P is rounded to V's
// dtype before the PV product, the normaliser is max(l, 1e-30), and
// lse = m + log(l_safe). Backward recomputes P = exp(s - lse), takes
// delta = rowsum(dO * O) (computed by the caller), and rounds dS to K's
// dtype for dQ, P to dO's dtype for dV and dS to Q's dtype for dK.
//
// Design (simple first): 256 threads per CTA, BT x BT tiles (BT = 64, or
// 32 at KD = 256 to fit shared memory), operands widened to f32 in shared
// memory, products on CUDA cores with f32 accumulation; each thread owns
// a (BT/16) x (BT/16) patch of a score tile and a (BT/16) x (KD/16) patch
// of an output tile, columns strided by 16 so that shared-memory reads
// are conflict-free. The forward and dQ kernels run one CTA per (q tile,
// batch*head) and loop over K/V tiles; the dK/dV kernel runs one CTA per
// (k tile, batch*head) and loops over Q/dO tiles, so no output is shared
// between CTAs and nothing needs atomics. Causal CTAs skip tiles wholly
// above the diagonal, and the longest q tiles are scheduled first.
//
// Bound: at the GPT-2 training shape ([8, 1024, 12, 64], causal) the
// forward moves ~50 MB and does ~13 GFLOP. This kernel runs its products
// on CUDA cores (67 TFLOP/s f32 peak), so it is compute-bound by design.
// bfloat16 at head widths 64 and 128 with 16-byte-aligned bases runs
// flash_attention_sm90.cu's tensor-core kernels instead
// (ops/flash_attention.py chooses); these take float32, where the f32
// products keep the float32 step within 1e-3 of the CPU, float16 (the
// tensor-core kernels are bfloat16-only) and the rest. A float16 operand
// is widened with __half2float and its P, dS rounded with
// __float2half_rn, as the TPU kernel's `.astype(float16)` would.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

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

// x rounded to T's precision and widened back (the TPU's `.astype(T)`
// ahead of a product with f32 accumulation)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <int BT, int KD>
struct Geo {
  static constexpr int RT = BT / 16;            // tile rows per thread
  static constexpr int CT = BT / 16;            // score cols per thread
  static constexpr int DT = KD / 16;            // head-dim cols per thread
  static constexpr int LD = KD + 1;             // row stride, [BT, KD] tile
  static constexpr int LS = BT + 1;             // row stride, [BT, BT] tile
  static constexpr int TPR = kThreads / BT;     // threads per row (stats)
  static_assert(KD % 16 == 0 && BT % 16 == 0, "tile widths");
  static_assert(TPR <= 32 && 32 % TPR == 0, "a row's threads share a warp");
};

// rows [row0, row0 + BT) of one (batch, head) plane into dst [BT][KD + 1]
// as f32; rows >= nrows and columns >= D are zero
template <typename T, int BT, int KD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int nrows, int64_t rs,
                                          int D) {
  for (int i = threadIdx.x; i < BT * KD; i += kThreads) {
    const int r = i / KD, d = i % KD;
    const int s = row0 + r;
    float val = 0.f;
    if (s < nrows && d < D) val = to_f32(src[(int64_t)s * rs + d]);
    dst[r * (KD + 1) + d] = val;
  }
}

// per-row f32 values [BT] (lse or delta of one (batch, head) row range)
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int nrows, int bt) {
  for (int r = threadIdx.x; r < bt; r += kThreads)
    dst[r] = row0 + r < nrows ? src[row0 + r] : 0.f;
}

// ------------------------------------------------------------ forward
template <typename T, int BT, int KD>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int H, int Sq, int Sk, int D,
              float scale, int causal) {
  using G = Geo<BT, KD>;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [BT][LD]
  float* k_s = q_s + BT * G::LD;          // [BT][LD]
  float* v_s = k_s + BT * G::LD;          // [BT][LD]
  float* p_s = v_s + BT * G::LD;          // [BT][LS] scores, then P
  float* m_s = p_s + BT * G::LS;          // [BT]
  float* l_s = m_s + BT;                  // [BT]
  float* a_s = l_s + BT;                  // [BT] rescale factor alpha

  const int nq = (Sq + BT - 1) / BT;
  const int qi = nq - 1 - (int)blockIdx.x;      // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int64_t rs = (int64_t)H * D;            // row stride of [B, S, H, D]
  const int64_t qoff = ((int64_t)b * Sq * H + h) * D;
  const int64_t koff = ((int64_t)b * Sk * H + h) * D;
  const int q0 = qi * BT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, BT, KD>(q_s, q + qoff, q0, Sq, rs, D);
  for (int r = tid; r < BT; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[G::RT][G::DT];
#pragma unroll
  for (int i = 0; i < G::RT; ++i)
#pragma unroll
    for (int c = 0; c < G::DT; ++c) acc[i][c] = 0.f;

  int nk = (Sk + BT - 1) / BT;
  if (causal) nk = min(nk, qi + 1);       // tiles with k0 <= the last row
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BT;
    __syncthreads();                      // k_s, v_s, p_s free again
    load_tile<T, BT, KD>(k_s, k + koff, k0, Sk, rs, D);
    load_tile<T, BT, KD>(v_s, v + koff, k0, Sk, rs, D);
    __syncthreads();
    float s[G::RT][G::CT];
#pragma unroll
    for (int i = 0; i < G::RT; ++i)
#pragma unroll
      for (int c = 0; c < G::CT; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < KD; ++d) {
      float a[G::RT], bb[G::CT];
#pragma unroll
      for (int i = 0; i < G::RT; ++i) a[i] = q_s[(ty * G::RT + i) * G::LD + d];
#pragma unroll
      for (int c = 0; c < G::CT; ++c) bb[c] = k_s[(tx + 16 * c) * G::LD + d];
#pragma unroll
      for (int i = 0; i < G::RT; ++i)
#pragma unroll
        for (int c = 0; c < G::CT; ++c) s[i][c] = fmaf(a[i], bb[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < G::RT; ++i) {
      const int r = ty * G::RT + i;
#pragma unroll
      for (int c = 0; c < G::CT; ++c) {
        const int col = k0 + tx + 16 * c;
        float val = s[i][c] * scale;
        if (col >= Sk || (causal && col > q0 + r)) val = kNegInf;
        p_s[r * G::LS + tx + 16 * c] = val;
      }
    }
    __syncthreads();
    {  // online softmax statistics, TPR threads per row
      const int r = tid / G::TPR, part = tid % G::TPR;
      float* pr = p_s + r * G::LS;
      float mx = kNegInf;
      for (int c = part; c < BT; c += G::TPR) mx = fmaxf(mx, pr[c]);
#pragma unroll
      for (int off = G::TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < BT; c += G::TPR) {
        const float p = expf(pr[c] - m_new);
        sum += p;
        pr[c] = round_to<T>(p);
      }
#pragma unroll
      for (int off = G::TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < G::RT; ++i) {
      const float al = a_s[ty * G::RT + i];
#pragma unroll
      for (int c = 0; c < G::DT; ++c) acc[i][c] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float pv[G::RT], vv[G::DT];
#pragma unroll
      for (int i = 0; i < G::RT; ++i) pv[i] = p_s[(ty * G::RT + i) * G::LS + kk];
#pragma unroll
      for (int c = 0; c < G::DT; ++c) vv[c] = v_s[kk * G::LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < G::RT; ++i)
#pragma unroll
        for (int c = 0; c < G::DT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < G::RT; ++i) {
    const int r = ty * G::RT + i;
    const int row = q0 + r;
    if (row >= Sq) continue;
    const float l_safe = fmaxf(l_s[r], 1e-30f);
    T* orow = o + qoff + (int64_t)row * rs;
#pragma unroll
    for (int c = 0; c < G::DT; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = from_f32<T>(acc[i][c] / l_safe);
    }
    if (tx == 0) lse[(int64_t)bh * Sq + row] = m_s[r] + logf(l_safe);
  }
}

// ------------------------------------------------------------ backward: dQ
template <typename T, int BT, int KD>
__global__ void __launch_bounds__(kThreads)
fa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int H, int Sq, int Sk, int D, float scale,
             int causal) {
  using G = Geo<BT, KD>;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [BT][LD]
  float* do_s = q_s + BT * G::LD;         // [BT][LD]
  float* k_s = do_s + BT * G::LD;         // [BT][LD]
  float* v_s = k_s + BT * G::LD;          // [BT][LD]
  float* ds_s = v_s + BT * G::LD;         // [BT][LS] dS rounded to K's dtype
  float* lse_s = ds_s + BT * G::LS;       // [BT]
  float* dl_s = lse_s + BT;               // [BT]

  const int nq = (Sq + BT - 1) / BT;
  const int qi = nq - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int64_t rs = (int64_t)H * D;
  const int64_t qoff = ((int64_t)b * Sq * H + h) * D;
  const int64_t koff = ((int64_t)b * Sk * H + h) * D;
  const int q0 = qi * BT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, BT, KD>(q_s, q + qoff, q0, Sq, rs, D);
  load_tile<T, BT, KD>(do_s, dout + qoff, q0, Sq, rs, D);
  load_rows(lse_s, lse + (int64_t)bh * Sq, q0, Sq, BT);
  load_rows(dl_s, delta + (int64_t)bh * Sq, q0, Sq, BT);
  float acc[G::RT][G::DT];
#pragma unroll
  for (int i = 0; i < G::RT; ++i)
#pragma unroll
    for (int c = 0; c < G::DT; ++c) acc[i][c] = 0.f;

  int nk = (Sk + BT - 1) / BT;
  if (causal) nk = min(nk, qi + 1);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BT;
    __syncthreads();
    load_tile<T, BT, KD>(k_s, k + koff, k0, Sk, rs, D);
    load_tile<T, BT, KD>(v_s, v + koff, k0, Sk, rs, D);
    __syncthreads();
    float s[G::RT][G::CT], dp[G::RT][G::CT];
#pragma unroll
    for (int i = 0; i < G::RT; ++i)
#pragma unroll
      for (int c = 0; c < G::CT; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < KD; ++d) {
      float a[G::RT], ad[G::RT], bk[G::CT], bv[G::CT];
#pragma unroll
      for (int i = 0; i < G::RT; ++i) {
        a[i] = q_s[(ty * G::RT + i) * G::LD + d];
        ad[i] = do_s[(ty * G::RT + i) * G::LD + d];
      }
#pragma unroll
      for (int c = 0; c < G::CT; ++c) {
        bk[c] = k_s[(tx + 16 * c) * G::LD + d];
        bv[c] = v_s[(tx + 16 * c) * G::LD + d];
      }
#pragma unroll
      for (int i = 0; i < G::RT; ++i)
#pragma unroll
        for (int c = 0; c < G::CT; ++c) {
          s[i][c] = fmaf(a[i], bk[c], s[i][c]);
          dp[i][c] = fmaf(ad[i], bv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < G::RT; ++i) {
      const int r = ty * G::RT + i;
#pragma unroll
      for (int c = 0; c < G::CT; ++c) {
        const int col = k0 + tx + 16 * c;
        float sv = s[i][c] * scale;
        if (col >= Sk || (causal && col > q0 + r)) sv = kNegInf;
        const float p = expf(sv - lse_s[r]);
        ds_s[r * G::LS + tx + 16 * c] =
            round_to<T>(p * (dp[i][c] - dl_s[r]) * scale);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float dsv[G::RT], kv[G::DT];
#pragma unroll
      for (int i = 0; i < G::RT; ++i) dsv[i] = ds_s[(ty * G::RT + i) * G::LS + kk];
#pragma unroll
      for (int c = 0; c < G::DT; ++c) kv[c] = k_s[kk * G::LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < G::RT; ++i)
#pragma unroll
        for (int c = 0; c < G::DT; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < G::RT; ++i) {
    const int row = q0 + ty * G::RT + i;
    if (row >= Sq) continue;
    T* out = dq + qoff + (int64_t)row * rs;
#pragma unroll
    for (int c = 0; c < G::DT; ++c) {
      const int d = tx + 16 * c;
      if (d < D) out[d] = from_f32<T>(acc[i][c]);
    }
  }
}

// ------------------------------------------------------------ backward: dK, dV
template <typename T, int BT, int KD>
__global__ void __launch_bounds__(kThreads)
fa_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk,
              int D, float scale, int causal) {
  using G = Geo<BT, KD>;
  extern __shared__ float smem[];
  float* k_s = smem;                      // [BT][LD]
  float* v_s = k_s + BT * G::LD;          // [BT][LD]
  float* q_s = v_s + BT * G::LD;          // [BT][LD]
  float* do_s = q_s + BT * G::LD;         // [BT][LD]
  float* p_s = do_s + BT * G::LD;         // [BT q][LS] P rounded to dO's dtype
  float* ds_s = p_s + BT * G::LS;         // [BT q][LS] dS rounded to Q's dtype
  float* lse_s = ds_s + BT * G::LS;       // [BT]
  float* dl_s = lse_s + BT;               // [BT]

  const int ki = blockIdx.x;              // most causal q tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int64_t rs = (int64_t)H * D;
  const int64_t qoff = ((int64_t)b * Sq * H + h) * D;
  const int64_t koff = ((int64_t)b * Sk * H + h) * D;
  const int k0 = ki * BT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, BT, KD>(k_s, k + koff, k0, Sk, rs, D);
  load_tile<T, BT, KD>(v_s, v + koff, k0, Sk, rs, D);
  float gk[G::RT][G::DT], gv[G::RT][G::DT];
#pragma unroll
  for (int i = 0; i < G::RT; ++i)
#pragma unroll
    for (int c = 0; c < G::DT; ++c) gk[i][c] = gv[i][c] = 0.f;

  const int nq = (Sq + BT - 1) / BT;
  // causal: q tile j reaches this k tile once its last row >= k0
  const int j0 = causal ? ki : 0;
  for (int j = j0; j < nq; ++j) {
    const int q0 = j * BT;
    __syncthreads();
    load_tile<T, BT, KD>(q_s, q + qoff, q0, Sq, rs, D);
    load_tile<T, BT, KD>(do_s, dout + qoff, q0, Sq, rs, D);
    load_rows(lse_s, lse + (int64_t)bh * Sq, q0, Sq, BT);
    load_rows(dl_s, delta + (int64_t)bh * Sq, q0, Sq, BT);
    __syncthreads();
    // scores for q rows ty*RT+i and k cols tx+16c
    float s[G::RT][G::CT], dp[G::RT][G::CT];
#pragma unroll
    for (int i = 0; i < G::RT; ++i)
#pragma unroll
      for (int c = 0; c < G::CT; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < KD; ++d) {
      float a[G::RT], ad[G::RT], bk[G::CT], bv[G::CT];
#pragma unroll
      for (int i = 0; i < G::RT; ++i) {
        a[i] = q_s[(ty * G::RT + i) * G::LD + d];
        ad[i] = do_s[(ty * G::RT + i) * G::LD + d];
      }
#pragma unroll
      for (int c = 0; c < G::CT; ++c) {
        bk[c] = k_s[(tx + 16 * c) * G::LD + d];
        bv[c] = v_s[(tx + 16 * c) * G::LD + d];
      }
#pragma unroll
      for (int i = 0; i < G::RT; ++i)
#pragma unroll
        for (int c = 0; c < G::CT; ++c) {
          s[i][c] = fmaf(a[i], bk[c], s[i][c]);
          dp[i][c] = fmaf(ad[i], bv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < G::RT; ++i) {
      const int r = ty * G::RT + i;
#pragma unroll
      for (int c = 0; c < G::CT; ++c) {
        const int col = k0 + tx + 16 * c;
        float sv = s[i][c] * scale;
        if (col >= Sk || (causal && col > q0 + r)) sv = kNegInf;
        const float p = expf(sv - lse_s[r]);
        p_s[r * G::LS + tx + 16 * c] = round_to<T>(p);
        ds_s[r * G::LS + tx + 16 * c] =
            round_to<T>(p * (dp[i][c] - dl_s[r]) * scale);
      }
    }
    __syncthreads();
    // dV[kc] += sum_r P[r][kc] dO[r];  dK[kc] += sum_r dS[r][kc] Q[r]
#pragma unroll 4
    for (int r = 0; r < BT; ++r) {
      float pv[G::RT], dsv[G::RT], dov[G::DT], qv[G::DT];
#pragma unroll
      for (int i = 0; i < G::RT; ++i) {
        pv[i] = p_s[r * G::LS + ty * G::RT + i];
        dsv[i] = ds_s[r * G::LS + ty * G::RT + i];
      }
#pragma unroll
      for (int c = 0; c < G::DT; ++c) {
        dov[c] = do_s[r * G::LD + tx + 16 * c];
        qv[c] = q_s[r * G::LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < G::RT; ++i)
#pragma unroll
        for (int c = 0; c < G::DT; ++c) {
          gv[i][c] = fmaf(pv[i], dov[c], gv[i][c]);
          gk[i][c] = fmaf(dsv[i], qv[c], gk[i][c]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < G::RT; ++i) {
    const int row = k0 + ty * G::RT + i;
    if (row >= Sk) continue;
    T* ok = dk + koff + (int64_t)row * rs;
    T* ov = dv + koff + (int64_t)row * rs;
#pragma unroll
    for (int c = 0; c < G::DT; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        ok[d] = from_f32<T>(gk[i][c]);
        ov[d] = from_f32<T>(gv[i][c]);
      }
    }
  }
}

// ------------------------------------------------------------ launchers
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int BT, int KD>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int H, int Sq, int Sk, int D, float scale, int causal,
        cudaStream_t stream) {
  using G = Geo<BT, KD>;
  const size_t smem =
      sizeof(float) * (3 * BT * G::LD + BT * G::LS + 3 * BT);
  cudaError_t e = set_smem(fa_fwd_kernel<T, BT, KD>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BT - 1) / BT, B * H);
  fa_fwd_kernel<T, BT, KD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Sq, Sk, D, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T, int BT, int KD>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq, void* dk, void* dv,
        int B, int H, int Sq, int Sk, int D, float scale, int causal,
        cudaStream_t stream) {
  using G = Geo<BT, KD>;
  const size_t smem_dq = sizeof(float) * (4 * BT * G::LD + BT * G::LS + 2 * BT);
  const size_t smem_dkv =
      sizeof(float) * (4 * BT * G::LD + 2 * BT * G::LS + 2 * BT);
  cudaError_t e = set_smem(fa_dq_kernel<T, BT, KD>, smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = set_smem(fa_dkv_kernel<T, BT, KD>, smem_dkv);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_q((Sq + BT - 1) / BT, B * H);
  fa_dq_kernel<T, BT, KD><<<grid_q, kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, Sq, Sk, D, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_k((Sk + BT - 1) / BT, B * H);
  fa_dkv_kernel<T, BT, KD><<<grid_k, kThreads, smem_dkv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, D, scale, causal);
  return (int)cudaGetLastError();
}

// the tile width KD is the smallest of 32, 64, 128, 256 that holds D
template <typename T>
int fwd_d(const void* q, const void* k, const void* v, void* o, float* lse,
          int B, int H, int Sq, int Sk, int D, float scale, int causal,
          cudaStream_t s) {
  if (D <= 32) return fwd<T, 64, 32>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal, s);
  if (D <= 64) return fwd<T, 64, 64>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal, s);
  if (D <= 128) return fwd<T, 64, 128>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal, s);
  if (D <= 256) return fwd<T, 32, 256>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_d(const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* delta, void* dq, void* dk, void* dv,
          int B, int H, int Sq, int Sk, int D, float scale, int causal,
          cudaStream_t s) {
  if (D <= 32)
    return bwd<T, 64, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D, scale, causal, s);
  if (D <= 64)
    return bwd<T, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D, scale, causal, s);
  if (D <= 128)
    return bwd<T, 64, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D, scale, causal, s);
  if (D <= 256)
    return bwd<T, 32, 256>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, o share it). q/o [B, Sq, H, D],
// k/v [B, Sk, H, D] contiguous; lse [B, H, Sq] f32. 1 <= D <= 256.
// Returns cudaGetLastError() after the asynchronous launch on `stream`.
extern "C" int fa_fwd_launch(int dtype, const void* q, const void* k,
                             const void* v, void* o, float* lse, int B, int H,
                             int Sq, int Sk, int D, float scale, int causal,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_d<float>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal, s);
  if (dtype == 1)
    return fwd_d<__nv_bfloat16>(q, k, v, o, lse, B, H, Sq, Sk, D, scale,
                                causal, s);
  if (dtype == 2)
    return fwd_d<__half>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The backward pair: dQ (one CTA per q tile) then dK/dV (one CTA per k
// tile), both on `stream`. dout like q; delta [B, H, Sq] f32 =
// rowsum(dout * o); dq like q, dk/dv like k.
extern "C" int fa_bwd_launch(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const float* lse,
                             const float* delta, void* dq, void* dk, void* dv,
                             int B, int H, int Sq, int Sk, int D, float scale,
                             int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_d<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk,
                        D, scale, causal, s);
  if (dtype == 1)
    return bwd_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                                Sq, Sk, D, scale, causal, s);
  if (dtype == 2)
    return bwd_d<__half>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk,
                         D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
