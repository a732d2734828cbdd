// Flash attention on Hopper's tensor cores (sm_90a), bfloat16 or float16,
// head widths 64 and 128: the forward and the backward pair, with every product a
// wgmma and every tile loaded by TMA.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_kernels.py:
//   forward   _fa_fwd_kernel (_fa_call_fwd) and its VMEM-resident twin
//             _fa_fwd_kernel_resident (_fa_call_fwd_resident);
//   backward  _fa_dq_kernel + _fa_dkv_kernel (_fa_call_bwd) and the
//             resident pair (_fa_call_bwd_resident),
// for the operands the tensor cores take. Everything else (float32, other
// head widths, unaligned bases) runs csrc/flash_attention.cu's CUDA-core
// kernels; ops/flash_attention.py picks the route before the launch.
//
// Layout and numerics are flash_attention.cu's: q/o [B, Sq, H, D], k/v
// [B, Sk, H, D] read in place, lse [B, H, Sq] f32; scores (q . k) * scale
// in f32, masked to -1e30 (causal: row >= col, top-left aligned); online
// softmax with f32 m, l and accumulator; P rounded to the operand type T
// (bf16 or f16) before PV; max(l, 1e-30); lse = m + log(l_safe). The
// backward recomputes P from lse, takes delta = rowsum(dO * O) from the
// caller, and rounds dS (for dQ and dK) and P (for dV) to T, as the Pallas
// kernels round them (pallas_kernels.py :153, :205, :253, :260). On wgmma
// those roundings are where the operands enter the second product: P and
// dS are T A fragments packed from the first product's f32 accumulator,
// in registers. Every kernel is one template over T: the two types differ
// only in the wgmma instruction's operand type, the packing of pairs and
// the tensor maps' data type (sm90.cuh). In float16 a dS scaled by a large
// loss scale may round to inf; that is the reference's rounding too, and
// the loss scaler then skips the step.
//
// Design: one warpgroup (128 threads) per CTA and 64-row tiles. The
// forward and dQ kernels run one CTA per (q tile, batch*head), longest
// causal rows first, and loop over K/V tiles; the dK/dV kernel runs one
// CTA per (k tile, batch*head) and loops over Q/dO tiles, so no output is
// shared between CTAs: no atomics, the same bits on every run. Each
// operand is a 4-D tensor map (D, H, S, B) with boxes of 64 rows x 64
// columns and 128-byte swizzle (sm90.cuh); rows past S arrive as zeros
// and their scores are masked, so any length works. The CTA's own tile
// (Q, or Q and dO, or K and V) is loaded once; the streamed tiles go
// through a ring of two stages on mbarriers: thread 0 refills a stage as
// soon as the warpgroup has finished with it, so tile j + 1's load runs
// under tile j's products. S = Q K^T (and dP = dO V^T, S^T = K Q^T,
// dP^T = V dO^T) are wgmma with both operands K-major in shared memory;
// O += P V, dQ += dS K, dV += P^T dO and dK += dS^T Q take A from
// registers and B MN-major from shared memory (the transpose 16-bit types
// allow). Row statistics are reduced by shuffles among the four threads
// that share an accumulator row.
//
// Bound: at the GPT-2 training shape ([8, 1024, 12, 64] bf16, causal) the
// forward moves ~51 MB and does ~13 GFLOP (0.0151 ms of bytes, 0.0130 ms
// of products at 989 TFLOP/s), the backward ~32 GFLOP (0.0326 ms of
// products). Within a CTA the softmax and the products take turns (each
// product is waited for before the next step), so what hides one CTA's
// softmax and exponentials is the other CTAs on the SM (three to five fit,
// by registers and shared memory). Left for later: a producer warp with
// warp specialisation, two consumer warpgroups ping-ponging softmax
// against products, persistent CTAs, 2-CTA clusters sharing K/V, fp8.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                 // rows of every tile
constexpr int kStages = 2;                // depth of the streamed tiles' ring
constexpr int kThreads = 128;             // one warpgroup
constexpr int kBlockBytes = kRows * 128;  // one 64-column block of a tile
constexpr float kNegInf = -1e30f;

template <int D>
struct Tile {
  static_assert(D == 64 || D == 128, "the tensor-core route takes D 64, 128");
  static constexpr int kBytes = (D / 64) * kBlockBytes;   // one [64, D] tile
};

// the dynamic shared-memory buffer rounded up to 1024 bytes (the swizzle
// atom), which the launch's byte count allows for
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (sm90::smem_u32(raw) & 1023)) & 1023);
}

// rows [row0, row0 + 64) of head h of batch b into `dst`, completing on bar
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int b, int h,
                                          int row0) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    sm90::tma_load_4d(dst + c * kBlockBytes, map, bar, c * 64, h, row0, b);
}

// k-step kk (columns 16kk .. 16kk + 15) of a [64, D] tile, K-major
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int kk) {
  return sm90::desc_sw128(tile + (kk / 4) * kBlockBytes + (kk % 4) * 32, 16);
}

// k-step kk (rows 16kk .. 16kk + 15) of a [64, D] tile, MN-major
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk) {
  return sm90::desc_sw128(tile + kk * 16 * 128, kBlockBytes);
}

// s = a . b^T over D, a and b [64, D] tiles of T in shared memory
template <typename T, int D>
__device__ __forceinline__ void product_abt(float (&s)[32], const uint8_t* a,
                                            const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss_n64<T>(s, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// acc += p . tile, p a 64 x 64 T operand in registers (four k-steps of
// A fragments), tile [64, D] in shared memory
template <typename T, int D>
__device__ __forceinline__ void product_pt(float (&acc)[D / 2],
                                           const uint32_t (&p)[4][4],
                                           const uint8_t* tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 64)
      sm90::wgmma_rs_n64<T>(acc, p[kk], desc_mn(tile, kk));
    else
      sm90::wgmma_rs_n128<T>(acc, p[kk], desc_mn(tile, kk));
  }
}

// A 64 x 64 accumulator as T A fragments (each value rounded to T once):
// element 4j + 2h + c holds row 16 warp + lane / 4 + 8h, column 8j + 2
// (lane % 4) + c, which is the A layout of k-step j / 2, register
// 2 (j % 2) + h
template <typename T>
__device__ __forceinline__ void to_frags(uint32_t (&p)[4][4],
                                         const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = sm90::pack2<T>(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// this thread's half `hh` of a [64, D] accumulator (its row `row`), over
// `div`, into row `row` of head h, batch b of a [B, S, H, D] output; rows
// >= S are not written
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 2],
                                           int hh, int row, int S, int H,
                                           int b, int h, float div) {
  if (row >= S) return;
  const int t = threadIdx.x % 4;
  T* dst = out + (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t) = sm90::pack2<T>(
        acc[4 * j + 2 * hh] / div, acc[4 * j + 2 * hh + 1] / div);
}

__device__ __forceinline__ void init_barriers(uint64_t* bar) {
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
}

// ------------------------------------------------------------ forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Sq,
                 int Sk, float scale, int causal) {
  constexpr int kTile = Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = aligned_smem(smem_raw);
  uint8_t* k_s = q_s + kTile;                     // [kStages] tiles
  uint8_t* v_s = k_s + kStages * kTile;           // [kStages] tiles
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_s + kStages * kTile);

  const int nq = (Sq + kRows - 1) / kRows;
  const int qi = nq - 1 - (int)blockIdx.x;        // longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qi * kRows;
  int nk = (Sk + kRows - 1) / kRows;
  if (causal) nk = min(nk, qi + 1);               // tiles with k0 <= the last row
  const int tid = threadIdx.x, lane = tid % 32, t = lane % 4;
  const int r_lo = q0 + 16 * (tid / 32) + lane / 4;   // rows r_lo, r_lo + 8

  init_barriers(bar);
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar[0], kTile);
    load_tile<D>(q_s, &tm_q, &bar[0], b, h, q0);
    for (int j = 0; j < kStages && j < nk; ++j) {
      sm90::mbar_expect_tx(&bar[1 + j], 2 * kTile);
      load_tile<D>(k_s + j * kTile, &tm_k, &bar[1 + j], b, h, j * kRows);
      load_tile<D>(v_s + j * kTile, &tm_v, &bar[1 + j], b, h, j * kRows);
    }
  }
  float acc[D / 2];
  zero(acc);
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  sm90::mbar_wait(&bar[0], 0);

  for (int j = 0; j < nk; ++j) {
    const int st = j % kStages;
    const uint8_t* k_t = k_s + st * kTile;
    const uint8_t* v_t = v_s + st * kTile;
    sm90::mbar_wait(&bar[1 + st], (j / kStages) & 1);
    float s[32];
    zero(s);
    sm90::wgmma_fence();
    product_abt<T, D>(s, q_s, k_t);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);

    const int k0 = j * kRows;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r_lo + 8 * hh;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = k0 + 8 * jj + 2 * t + c;
          float v = s[4 * jj + 2 * hh + c] * scale;
          if (col >= Sk || (causal && col > row)) v = kNegInf;
          s[4 * jj + 2 * hh + c] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hh], mx);
      const float alpha = expf(m_run[hh] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = expf(s[4 * jj + 2 * hh + c] - m_new);
          s[4 * jj + 2 * hh + c] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[hh] = l_run[hh] * alpha + sum;
      m_run[hh] = m_new;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        acc[4 * jj + 2 * hh] *= alpha;
        acc[4 * jj + 2 * hh + 1] *= alpha;
      }
    }
    uint32_t p[4][4];
    to_frags<T>(p, s);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    product_pt<T, D>(acc, p, v_t);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);

    __syncthreads();                      // the warpgroup is done with stage st
    if (tid == 0 && j + kStages < nk) {
      const int k1 = (j + kStages) * kRows;
      sm90::mbar_expect_tx(&bar[1 + st], 2 * kTile);
      load_tile<D>(k_s + st * kTile, &tm_k, &bar[1 + st], b, h, k1);
      load_tile<D>(v_s + st * kTile, &tm_v, &bar[1 + st], b, h, k1);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r_lo + 8 * hh;
    const float l_safe = fmaxf(l_run[hh], 1e-30f);
    store_rows<T, D>(o, acc, hh, row, Sq, H, b, h, l_safe);
    if (t == 0 && row < Sq)
      lse[(int64_t)bh * Sq + row] = m_run[hh] + logf(l_safe);
  }
}

// ------------------------------------------------------------ backward: dQ
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int H, int Sq, int Sk, float scale,
                int causal) {
  constexpr int kTile = Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = aligned_smem(smem_raw);
  uint8_t* do_s = q_s + kTile;
  uint8_t* k_s = do_s + kTile;                    // [kStages] tiles
  uint8_t* v_s = k_s + kStages * kTile;           // [kStages] tiles
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_s + kStages * kTile);

  const int nq = (Sq + kRows - 1) / kRows;
  const int qi = nq - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qi * kRows;
  int nk = (Sk + kRows - 1) / kRows;
  if (causal) nk = min(nk, qi + 1);
  const int tid = threadIdx.x, lane = tid % 32, t = lane % 4;
  const int r_lo = q0 + 16 * (tid / 32) + lane / 4;

  init_barriers(bar);
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar[0], 2 * kTile);
    load_tile<D>(q_s, &tm_q, &bar[0], b, h, q0);
    load_tile<D>(do_s, &tm_do, &bar[0], b, h, q0);
    for (int j = 0; j < kStages && j < nk; ++j) {
      sm90::mbar_expect_tx(&bar[1 + j], 2 * kTile);
      load_tile<D>(k_s + j * kTile, &tm_k, &bar[1 + j], b, h, j * kRows);
      load_tile<D>(v_s + j * kTile, &tm_v, &bar[1 + j], b, h, j * kRows);
    }
  }
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r_lo + 8 * hh;
    lse_r[hh] = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
    dl_r[hh] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
  }
  float acc[D / 2];
  zero(acc);
  sm90::mbar_wait(&bar[0], 0);

  for (int j = 0; j < nk; ++j) {
    const int st = j % kStages;
    const uint8_t* k_t = k_s + st * kTile;
    const uint8_t* v_t = v_s + st * kTile;
    sm90::mbar_wait(&bar[1 + st], (j / kStages) & 1);
    float s[32], dp[32];
    zero(s);
    zero(dp);
    sm90::wgmma_fence();
    product_abt<T, D>(s, q_s, k_t);
    product_abt<T, D>(dp, do_s, v_t);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    const int k0 = j * kRows;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r_lo + 8 * hh;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * jj + 2 * hh + c;
          const int col = k0 + 8 * jj + 2 * t + c;
          float sv = s[i] * scale;
          if (col >= Sk || (causal && col > row)) sv = kNegInf;
          const float p = expf(sv - lse_r[hh]);
          s[i] = p * (dp[i] - dl_r[hh]) * scale;      // dS
        }
    }
    uint32_t ds[4][4];
    to_frags<T>(ds, s);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    product_pt<T, D>(acc, ds, k_t);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);

    __syncthreads();
    if (tid == 0 && j + kStages < nk) {
      const int k1 = (j + kStages) * kRows;
      sm90::mbar_expect_tx(&bar[1 + st], 2 * kTile);
      load_tile<D>(k_s + st * kTile, &tm_k, &bar[1 + st], b, h, k1);
      load_tile<D>(v_s + st * kTile, &tm_v, &bar[1 + st], b, h, k1);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    store_rows<T, D>(dq, acc, hh, r_lo + 8 * hh, Sq, H, b, h, 1.f);
}

// ------------------------------------------------------------ backward: dK, dV
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int Sq, int Sk, float scale,
                 int causal) {
  constexpr int kTile = Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = aligned_smem(smem_raw);
  uint8_t* v_s = k_s + kTile;
  uint8_t* q_s = v_s + kTile;                     // [kStages] tiles
  uint8_t* do_s = q_s + kStages * kTile;          // [kStages] tiles
  float* stat = reinterpret_cast<float*>(do_s + kStages * kTile);  // lse, delta
  uint64_t* bar = reinterpret_cast<uint64_t*>(stat + 2 * kRows);

  const int ki = blockIdx.x;                      // most causal q tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = ki * kRows;
  const int nqt = (Sq + kRows - 1) / kRows;
  // causal: q tile i reaches this k tile once its last row >= k0
  const int i0 = causal ? ki : 0;
  const int cnt = max(0, nqt - i0);
  const int tid = threadIdx.x, lane = tid % 32, t = lane % 4;
  const int r_lo = k0 + 16 * (tid / 32) + lane / 4;   // key rows r_lo, r_lo + 8

  init_barriers(bar);
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar[0], 2 * kTile);
    load_tile<D>(k_s, &tm_k, &bar[0], b, h, k0);
    load_tile<D>(v_s, &tm_v, &bar[0], b, h, k0);
    for (int n = 0; n < kStages && n < cnt; ++n) {
      const int qr = (i0 + n) * kRows;
      sm90::mbar_expect_tx(&bar[1 + n], 2 * kTile);
      load_tile<D>(q_s + n * kTile, &tm_q, &bar[1 + n], b, h, qr);
      load_tile<D>(do_s + n * kTile, &tm_do, &bar[1 + n], b, h, qr);
    }
  }
  float gk[D / 2], gv[D / 2];
  zero(gk);
  zero(gv);
  sm90::mbar_wait(&bar[0], 0);

  for (int n = 0; n < cnt; ++n) {
    const int st = n % kStages;
    const int q0 = (i0 + n) * kRows;
    const uint8_t* q_t = q_s + st * kTile;
    const uint8_t* do_t = do_s + st * kTile;
    {  // this q tile's lse (stat[0, 64)) and delta (stat[64, 128))
      const int c = tid % kRows;
      const float* src = tid < kRows ? lse : delta;
      stat[tid] = q0 + c < Sq ? src[(int64_t)bh * Sq + q0 + c] : 0.f;
    }
    __syncthreads();
    sm90::mbar_wait(&bar[1 + st], (n / kStages) & 1);
    float s[32], dp[32];                  // S^T and dP^T: key rows, q columns
    zero(s);
    zero(dp);
    sm90::wgmma_fence();
    product_abt<T, D>(s, k_s, q_t);
    product_abt<T, D>(dp, v_s, do_t);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = r_lo + 8 * hh;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * jj + 2 * hh + c;
          const int qc = 8 * jj + 2 * t + c;
          const int col = q0 + qc;
          float sv = s[i] * scale;
          if (col >= Sq || key >= Sk || (causal && key > col)) sv = kNegInf;
          const float p = expf(sv - stat[qc]);
          s[i] = p;
          dp[i] = p * (dp[i] - stat[kRows + qc]) * scale;    // dS^T
        }
    }
    uint32_t pf[4][4], dsf[4][4];
    to_frags<T>(pf, s);
    to_frags<T>(dsf, dp);
    sm90::fence_regs(gv);
    sm90::fence_regs(gk);
    sm90::wgmma_fence();
    product_pt<T, D>(gv, pf, do_t);
    product_pt<T, D>(gk, dsf, q_t);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(gv);
    sm90::fence_regs(gk);

    __syncthreads();                      // stage st and stat are free again
    if (tid == 0 && n + kStages < cnt) {
      const int qr = (i0 + n + kStages) * kRows;
      sm90::mbar_expect_tx(&bar[1 + st], 2 * kTile);
      load_tile<D>(q_s + st * kTile, &tm_q, &bar[1 + st], b, h, qr);
      load_tile<D>(do_s + st * kTile, &tm_do, &bar[1 + st], b, h, qr);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    store_rows<T, D>(dk, gk, hh, r_lo + 8 * hh, Sk, H, b, h, 1.f);
    store_rows<T, D>(dv, gv, hh, r_lo + 8 * hh, Sk, H, b, h, 1.f);
  }
}

// ------------------------------------------------------------ launchers
// shared memory of a kernel holding `tiles` [64, D] tiles and `extra`
// bytes, with room to align the buffer and for the kStages + 1 barriers
template <int D>
constexpr size_t smem_bytes(int tiles, size_t extra = 0) {
  return 1024 + (size_t)tiles * Tile<D>::kBytes + extra +
         (kStages + 1) * sizeof(uint64_t);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// an operand could not be described to TMA (no tensor-map encoder)
constexpr int kEncodeFailed = (int)cudaErrorNotSupported;

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int H, int Sq, int Sk, float scale, int causal,
        cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!sm90::encode_bshd<T>(&mq, q, B, Sq, H, D, kRows) ||
      !sm90::encode_bshd<T>(&mk, k, B, Sk, H, D, kRows) ||
      !sm90::encode_bshd<T>(&mv, v, B, Sk, H, D, kRows))
    return kEncodeFailed;
  const size_t smem = smem_bytes<D>(1 + 2 * kStages);
  cudaError_t e = allow_smem(fa_fwd_tc_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  fa_fwd_tc_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<T*>(o), lse, H, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq, void* dk, void* dv,
        int B, int H, int Sq, int Sk, float scale, int causal,
        cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!sm90::encode_bshd<T>(&mq, q, B, Sq, H, D, kRows) ||
      !sm90::encode_bshd<T>(&mk, k, B, Sk, H, D, kRows) ||
      !sm90::encode_bshd<T>(&mv, v, B, Sk, H, D, kRows) ||
      !sm90::encode_bshd<T>(&mdo, dout, B, Sq, H, D, kRows))
    return kEncodeFailed;
  const size_t smem_dq = smem_bytes<D>(2 + 2 * kStages);
  const size_t smem_dkv = smem_bytes<D>(2 + 2 * kStages, 2 * kRows * sizeof(float));
  cudaError_t e = allow_smem(fa_dq_tc_kernel<T, D>, smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(fa_dkv_tc_kernel<T, D>, smem_dkv);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_q((Sq + kRows - 1) / kRows, B * H);
  fa_dq_tc_kernel<T, D><<<grid_q, kThreads, smem_dq, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dq), H, Sq, Sk, scale,
      causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_k((Sk + kRows - 1) / kRows, B * H);
  fa_dkv_tc_kernel<T, D><<<grid_k, kThreads, smem_dkv, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

// the launcher F<T, D>::run for q's dtype (1 = bfloat16, 2 = float16,
// as _build.DTYPE_CODE numbers them) and head width D
template <template <typename, int> class F, typename... A>
int dispatch(int dtype, int D, A... args) {
  if (dtype == 1 && D == 64) return F<bf16, 64>::run(args...);
  if (dtype == 1 && D == 128) return F<bf16, 128>::run(args...);
  if (dtype == 2 && D == 64) return F<__half, 64>::run(args...);
  if (dtype == 2 && D == 128) return F<__half, 128>::run(args...);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
struct Fwd {
  template <typename... A>
  static int run(A... args) { return fwd<T, D>(args...); }
};
template <typename T, int D>
struct Bwd {
  template <typename... A>
  static int run(A... args) { return bwd<T, D>(args...); }
};

}  // namespace

// q/o [B, Sq, H, D], k/v [B, Sk, H, D] of dtype 1 = bfloat16 or 2 =
// float16, contiguous, base pointers 16-byte aligned; D is 64 or 128; lse
// [B, H, Sq] f32. Returns cudaGetLastError() after the asynchronous launch
// on `stream`, or cudaErrorNotSupported when the tensor maps cannot be
// encoded.
extern "C" int fa_tc_fwd_launch(int dtype, const void* q, const void* k,
                                const void* v, void* o, float* lse, int B,
                                int H, int Sq, int Sk, int D, float scale,
                                int causal, void* stream) {
  return dispatch<Fwd>(dtype, D, q, k, v, o, lse, B, H, Sq, Sk, scale, causal,
                       static_cast<cudaStream_t>(stream));
}

// The backward pair: dQ (one CTA per q tile) then dK/dV (one CTA per k
// tile), both on `stream`. dout like q; delta [B, H, Sq] f32 =
// rowsum(dout * o); dq like q, dk/dv like k; dtype as for the forward.
extern "C" int fa_tc_bwd_launch(int dtype, const void* q, const void* k,
                                const void* v, const void* dout,
                                const float* lse, const float* delta,
                                void* dq, void* dk, void* dv, int B, int H,
                                int Sq, int Sk, int D, float scale,
                                int causal, void* stream) {
  return dispatch<Bwd>(dtype, D, q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                       Sq, Sk, scale, causal,
                       static_cast<cudaStream_t>(stream));
}
