// Ragged paged attention on Hopper's tensor cores (sm_90a), bfloat16 or
// float16 q: K1 over pools of q's dtype and K1q over int8 / float8_e4m3fn
// pools, at head widths 64 and 128 and KV blocks of 16, 32 or 64 rows.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/ragged_paged_attention.py
// (_rpa_kernel, launched by ragged_paged_attention, with its quantized
// branch) for the operands the tensor cores take. Everything else (float32
// q, other head widths or block sizes) runs csrc/ragged_paged_attention.cu's
// CUDA-core kernel; ops/ragged_paged_attention.py picks the route before
// the launch. The layout contract is that kernel's:
//   q      [H, Qp, Dh] bf16 or f16     flattened padded query rows
//   pool   [L, 2, NB+1, H, bs, Dh]     q's dtype, int8 or fp8 codes, read
//                                      whole
//   scales [L, 2, NB+1, H] f32         K1q only: per-(block, head) scale
//   blk_seq [Qp/8], seq_qstart/seq_pos0/lo/kv_len [S], tables [S, T] int32
//   out    [H, Qp, Dh] in q's dtype
// A row at virtual position p attends to cache columns [lo, p].
//
// Numerics are those of the JAX kernel and the CUDA-core kernel: scores
// (q . k) accumulated in f32, times scale, masked to [lo, qpos] with a
// -1e30 fill; an online softmax in f32; P rounded to q's dtype T (V's)
// before the PV product while l sums the unrounded P; out = acc / max(l,
// 1e-30), rounded once. A quantized code enters a product as
// round_to_T(code * scale), computed in f32 (_rpa_kernel's dequantization,
// :162-165); the products stay T x T. Only P, the dequantized codes and
// the output are rounded to T: the scores, the softmax and the
// accumulators stay f32, which is what float16's narrow range needs (an
// fp8 code times its scale is bounded by the float16 values it was
// quantized from). bf16 and f16 differ only in the instruction's operand
// type and the packing of pairs: one kernel template serves both.
//
// Design, and why:
// - Tiles of up to 64 rows (8 layout blocks) of ONE sequence, 4 warps of
//   16 rows. A block is a tile's leader when (b - seq_qstart[seq] / 8) % 8
//   == 0 and its tile takes up to 8 consecutive blocks of its sequence.
//   A 256-row chunk reads each KV page 4 times per head instead of 32. The
//   tiles of a sequence follow from its own blocks alone: no host plan, no
//   sync, and a request's tiles do not depend on its batch-mates. The
//   grid runs over tile slots, ceil(Qp / 64) + S of them (a bound on the
//   tile count known on the host): each CTA finds the slot-th leader by a
//   ballot over blk_seq, so a step padded to a wide q bucket launches ~8x
//   fewer CTAs than one per block, most of which would exit at once.
// - Products on tensor cores with mma.sync.m16n8k16 (bf16 x bf16 or
//   f16 x f16 into f32), FlashAttention-2 style: Q fragments stay in
//   registers for the whole walk, K and V fragments come from shared
//   memory through ldmatrix (.trans for V; 16-bit lanes either way), S
//   and P never touch shared memory. A decode row is one 8-row block
//   inside an m16 tile, which wgmma's 64-row tiles would waste; the
//   kernel is bound by bytes and latency, not by tensor-core rate.
//   A tile of at most 16 rows (decode rows, short chunks) would leave 3
//   warps idle, so there every warp takes all its rows and a quarter of
//   each step's columns (a tile of at most 32 rows: two groups of two
//   halves), and the warps' (acc, m, l) of a row are summed through
//   shared memory at the end, in warp order.
// - Pages in flight: a (page, head) tile is one contiguous bs * Dh run;
//   16-byte cp.async copies land it in a ring of stages of 64 KV columns
//   (4 pages of 16, 2 of 32, 1 of 64), XOR-swizzled by row so that
//   ldmatrix reads are free of bank conflicts; the ring has a stage more
//   than a split has steps, so every page of a split is in flight from the
//   start and the next step's pages land while the current ones are
//   multiplied. One __syncthreads a step. The split's page-table slice
//   (and K1q's scales, by 4-byte cp.async with the first stage) is read
//   into shared memory once.
// - Few dependent round trips before the first page lands: blk_seq and
//   the sequences' first rows (to find the tile); then the tile's
//   metadata, the next 7 blocks' sequences and split z's page ids (from
//   its first column, which is right unless lo starts the walk inside the
//   split), with Q's fragments; then the pages.
// - The walk stops at the diagonal: a tile walks its pages from the one
//   holding lo to min(ceil(kv_len / bs), page of its last row's qpos + 1),
//   pad rows of real blocks included. Pages wholly right of every row's
//   position contribute exactly 0. A tile with a row below lo (wholly
//   masked) walks all ceil(kv_len / bs) pages, as the plain version's mean
//   over them asks.
// - Long walks split across CTAs (flash-decoding): grid.z runs over splits
//   at fixed multiples of kSplitCols = 128 KV columns, set from the
//   sequence's own positions, never from the SM count or the batch. A tile
//   whose walk lies in one split writes its output directly. Otherwise each
//   split writes f32 partials (acc, m, l) to scratch from the wrapper,
//   its leader records the tile's split range for each of its blocks, and
//   rpa_tc_combine_kernel, launched as a programmatic dependent so that its
//   launch overlaps this kernel's tail, sums them in split order (no
//   atomics): a split in
//   which every column of a row was masked has m = -1e30 and is weighted
//   by exactly 0, unless every split of the row is, which gives the plain
//   version's mean.
// - K1q dequantizes in registers: pages land in shared memory as 1-byte
//   codes (device-memory bytes stay at storage width). ldmatrix's 16-bit
//   lanes carry pairs of codes, so K's head-dim order inside each 16-wide
//   slice is permuted (codes 4a..4a+3 of a row feed k-slots 2a, 2a+1,
//   2a+8, 2a+9, and Q is loaded in the same order; a dot product does not
//   care), and V's transposed ldmatrix gives each lane two head-dim columns
//   of two key rows, so the output's n8 tiles interleave even and odd
//   columns. The epilogue maps both back. An int8 code becomes an f32 by
//   its bits (2^23 + code + 128, less the offset: exact, at full rate where
//   I2F runs at 1/8), an fp8 pair by one e4m3x2 -> f16x2 conversion; both
//   then times the scale in f32 and rounded once to T.
//
// Bound: bytes. Each (page, head) tile a tile walks is read once per q
// tile; the engine's widest step moves ~4 MB at ~54 operations a byte,
// below the ~295 of the ridge. What holds a launch above its bound is
// latency: the round trips above, a walk of at most 2 steps a CTA, and
// the combine (PERF.md has the measured phases).
//
// Pool offsets are 64-bit. Pad blocks (blk_seq < 0) write zeros.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 8;        // rows of a layout block
constexpr int kTileBlocks = 8;    // layout blocks a tile takes at most
constexpr int kWarps = 4;         // 16 tile rows each
constexpr int kThreads = kWarps * 32;
constexpr int kStepCols = 64;     // KV columns a pipeline step
constexpr int kSplitCols = 128;   // KV columns a split (a multiple of a step)
constexpr float kNegInf = -1e30f;

// a compile-time int as a value (the warp layout of a tile's walk)
template <int N>
struct Int {
  static constexpr int value = N;
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <typename T>
constexpr bool kHalf = std::is_same<T, __half>::value;

// d (+)= A[16 x 16] . B[16 x 8], T operands (bf16 or f16), f32 accumulator
#define RPA_MMA(TY)                                                  \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY   \
               ".f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, " \
               "{%0, %1, %2, %3};\n"                                 \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), \
                 "r"(b1))
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (kHalf<T>)
    RPA_MMA("f16");
  else
    RPA_MMA("bf16");
}
#undef RPA_MMA

// two floats rounded to T in one register, `lo` in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// ------------------------------------------------------------ codes
// T pair (round(code_i * s), round(code_j * s)) of bytes i and j of w,
// code_i in the low half; each code * s is computed in f32 and rounded
// once to T
template <typename S, typename T>
__device__ __forceinline__ uint32_t deq2(uint32_t w, int i, int j, float s) {
  if constexpr (std::is_same<S, int8_t>::value) {
    // 2^23 + (code + 128) as an f32 built from its bits, less 2^23 + 128:
    // exact, one byte permute and one add a code (I2F runs at 1/8 the rate)
    const uint32_t u = w ^ 0x80808080u;
    const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | i));
    const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | j));
    return pack2<T>((lo - 8388736.f) * s, (hi - 8388736.f) * s);
  } else {
    // both codes in one e4m3x2 -> f16x2 conversion (exact), then f32
    const __half2 h2 = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)__byte_perm(w, 0, 0x4400 | j << 4 | i),
        __NV_E4M3);
    const float2 f = __half22float2(h2);
    return pack2<T>(f.x * s, f.y * s);
  }
}

// ------------------------------------------------------------ the tile plan
// The tile led by layout block b of sequence seq (tc_plan in
// ops/ragged_paged_attention.py computes the same on the host).
struct Plan {
  int n_rows;               // rows of the tile (8 per block)
  int qpos0;                // virtual position of the tile's row 0
  int lo;
  int p_begin, p_end;       // pages walked, [p_begin, p_end)
  int z_first, z_last;      // splits holding them
};

template <int BS>
__device__ __forceinline__ Plan plan_tile(int n_blocks, int qpos0, int lo,
                                          int kv_len) {
  Plan p;
  p.n_rows = n_blocks * kBlockQ;
  p.qpos0 = qpos0;
  p.lo = lo;
  const int n_kv = (kv_len + BS - 1) / BS;
  if (qpos0 < lo) {              // a wholly masked row: the plain version's
    p.p_begin = 0;               // mean over every page
    p.p_end = n_kv;
  } else {
    p.p_begin = lo / BS;
    p.p_end = min(n_kv, (qpos0 + p.n_rows - 1) / BS + 1);
  }
  if (p.p_end <= p.p_begin) {    // nothing to walk: one split writes zeros
    p.p_begin = p.p_end = 0;
    p.z_first = p.z_last = 0;
  } else {
    p.z_first = p.p_begin * BS / kSplitCols;
    p.z_last = (p.p_end * BS - 1) / kSplitCols;
  }
  return p;
}

// Byte offset of 16-byte chunk c of row r in a staged tile of ROWB-byte
// rows: the chunk index XOR a function of the row, so the 8 rows an
// ldmatrix phase reads hit 8 distinct 16-byte bank groups.
template <int ROWB>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (ROWB >= 128)
    return r * ROWB + ((c ^ (r & 7)) << 4);
  else   // 64-byte rows (1-byte codes, Dh 64): two rows per 128 bytes
    return r * ROWB + ((c ^ ((r >> 1) & 3)) << 4);
}

// Head-dim column of accumulator entry o[j][e]: the natural n8 layout
// for 16-bit V, even/odd columns interleaved for 1-byte V.
template <bool kQuant>
__device__ __forceinline__ int dh_col(int j, int e, int a) {
  if constexpr (kQuant)
    return 16 * (j >> 1) + 4 * a + 2 * (e & 1) + (j & 1);
  else
    return 8 * j + 2 * a + (e & 1);
}

// ring stages: a split's steps and one more, so all of a split's pages
// are in flight from the start
constexpr int kStages = kSplitCols / kStepCols + 1;

// Row (m, l) and 4 accumulator columns from d of C warps' copies of one
// row, at warp slots slot0, slot0 + 16, ...: summed in warp order with
// weights exp(m_w - max m).
template <int C, int DH>
__device__ __forceinline__ void merge_warps(const float* acc_s,
                                            const float* ml_s, int slot0,
                                            int d, float& m, float& l,
                                            float4& acc) {
  if constexpr (C == 1) {
    m = ml_s[2 * slot0];
    l = ml_s[2 * slot0 + 1];
    acc = *reinterpret_cast<const float4*>(acc_s + slot0 * DH + d);
    return;
  }
  m = kNegInf;
#pragma unroll
  for (int w = 0; w < C; ++w) m = fmaxf(m, ml_s[2 * (slot0 + 16 * w)]);
  l = 0.f;
  acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int w = 0; w < C; ++w) {
    const int at = slot0 + 16 * w;
    const float wt = __expf(ml_s[2 * at] - m);
    const float4 v = *reinterpret_cast<const float4*>(acc_s + at * DH + d);
    l += wt * ml_s[2 * at + 1];
    acc.x += wt * v.x;
    acc.y += wt * v.y;
    acc.z += wt * v.z;
    acc.w += wt * v.w;
  }
}

template <typename T, typename S, int DH, int BS>
__global__ void __launch_bounds__(kThreads)
rpa_tc_kernel(const T* __restrict__ q, const S* __restrict__ pool,
              const float* __restrict__ scales, T* __restrict__ out,
              float* __restrict__ part_acc, float* __restrict__ part_ml,
              int* __restrict__ part_z, const int* __restrict__ blk_seq,
              const int* __restrict__ seq_qstart,
              const int* __restrict__ seq_pos0,
              const int* __restrict__ tables, const int* __restrict__ lo_arr,
              const int* __restrict__ kv_len_arr, int H, int Qp, int NB1,
              int T_len, int layer, float scale, int n_splits) {
  constexpr bool kQuant = sizeof(S) == 1;
  constexpr int ROWB = DH * (int)sizeof(S);   // bytes of a K/V row
  constexpr int CPR = ROWB / 16;              // 16-byte chunks a row
  constexpr int PPS = kStepCols / BS;         // pages a step
  constexpr int PPSPLIT = kSplitCols / BS;    // pages a split
  constexpr int STAGE = kStepCols * ROWB;     // bytes of K (or V) a stage
  constexpr int NST = kStages;
  constexpr int KT = DH / 16;                 // k16 slices of the head dim
  constexpr int NO = DH / 8;                  // n8 tiles of the output

  const int slot = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, a = lane & 3;
  const int n_blocks = Qp / kBlockQ;

  // Find this CTA's tile: the slot-th leader block in layout order. The
  // 128 threads look at 128 blocks at a time; a pad block they pass is
  // written with zeros by the CTA whose slot it falls to.
  __shared__ int warp_leads[kWarps], found;
  if (tid == 0) found = -1;
  for (int base = 0, seen = 0; base < n_blocks && (seen <= slot || z == 0);
       base += kThreads) {   // split 0's CTAs scan on for pad blocks
    const int i = base + tid;
    const int sq = i < n_blocks ? blk_seq[i] : -1;
    const bool lead =
        sq >= 0 && (i - seq_qstart[sq] / kBlockQ) % kTileBlocks == 0;
    if (sq < 0 && i < n_blocks && z == 0 && i % gridDim.x == slot) {
      uint4* o = reinterpret_cast<uint4*>(
          out + ((int64_t)h * Qp + i * kBlockQ) * DH);
      for (int k = 0; k < kBlockQ * DH / 8; ++k) o[k] = make_uint4(0, 0, 0, 0);
      if (h == 0 && n_splits > 1) part_z[i] = -1;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, lead);
    if (lane == 0) warp_leads[warp] = __popc(ball);
    __syncthreads();
    int rank = seen + __popc(ball & ((1u << lane) - 1));
    for (int w = 0; w < kWarps; ++w) {
      rank += w < warp ? warp_leads[w] : 0;
      seen += warp_leads[w];
    }
    if (lead && rank == slot) found = i;
    __syncthreads();   // warp_leads is rewritten, found is read
  }
  // the combine launch may begin once every CTA has passed here or exited
  // (it waits for this grid's end before it reads)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = found;
  if (b < 0) return;   // a spare slot: more slots than tiles

  // One round trip for the rest: the sequence's metadata, the next 7
  // layout blocks (how long is the tile?), and the page ids of split z
  // from its first column (right unless lo starts the walk inside it).
  const int seq = blk_seq[b];
  const int qstart = seq_qstart[seq], pos0 = seq_pos0[seq];
  const int lo = lo_arr[seq], kv_len = kv_len_arr[seq];
  int next[kTileBlocks - 1];
#pragma unroll
  for (int i = 1; i < kTileBlocks; ++i)
    next[i - 1] = b + i < n_blocks ? blk_seq[b + i] : -1;
  const int* table = tables + (int64_t)seq * T_len;
  const int spec_page = z * PPSPLIT + tid;
  const int spec_pid =
      tid < PPSPLIT && spec_page < T_len ? table[spec_page] : 0;
  int nb = 1;
#pragma unroll
  for (int i = 1; i < kTileBlocks; ++i)
    if (nb == i && next[i - 1] == seq) nb = i + 1;
  const Plan P = plan_tile<BS>(nb, pos0 + b * kBlockQ - qstart, lo, kv_len);
  if (z == P.z_first && h == 0 && n_splits > 1 && tid < nb)
    part_z[b + tid] = P.z_last > P.z_first ? P.z_first | P.z_last << 16 : -1;
  if (z < P.z_first || z > P.z_last) return;
  const int pg0 = max(P.p_begin, z * PPSPLIT);
  const int pg1 = min(P.p_end, (z + 1) * PPSPLIT);
  const int n_pages = max(pg1 - pg0, 0);
  const int n_steps = (n_pages + PPS - 1) / PPS;

  // Rows and key columns of this warp: the 4 warps are n_rg groups of 16
  // rows times 4 / n_rg slices of each step's columns. A tile of up to 16
  // rows (decode rows, short chunks) gives every warp its rows and a
  // quarter of the columns, one of up to 32 rows two groups of two
  // halves, a taller one each warp 16 rows and every column. Warps past
  // the tile's rows sit out the products.
  const int n_rg = P.n_rows <= 16 ? 1 : P.n_rows <= 32 ? 2 : kWarps;
  const int n_cg = kWarps / n_rg;
  const int row0 = warp / n_cg * 16;
  const bool active = row0 < P.n_rows;
  const int r_lo = row0 + g, r_hi = r_lo + 8;

  // Q fragments for the whole walk (zero past the tile, whose rows belong
  // to other blocks and are never written); issued before the page ids
  // are needed, so their loads overlap
  uint32_t qf[KT][4];
  {
    const T* qh = q + ((int64_t)h * Qp + (int64_t)b * kBlockQ) * DH;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r_hi : r_lo;
        uint32_t x = 0, y = 0;
        if (r < P.n_rows) {
          const T* row = qh + (int64_t)r * DH + 16 * kt;
          if constexpr (kQuant) {   // columns 4a..4a+3: k-slots 2a.., 2a+8..
            const uint2 v = *reinterpret_cast<const uint2*>(row + 4 * a);
            x = v.x;
            y = v.y;
          } else {
            x = *reinterpret_cast<const uint32_t*>(row + 2 * a);
            y = *reinterpret_cast<const uint32_t*>(row + 2 * a + 8);
          }
        }
        qf[kt][half] = x;        // a0 / a1: rows g / g + 8, low k-slots
        qf[kt][2 + half] = y;    // a2 / a3: high k-slots
      }
    }
  }

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* k_s = smem;                          // [NST][64 rows][ROWB]
  uint8_t* v_s = k_s + NST * STAGE;
  int* pid_s = reinterpret_cast<int*>(v_s + NST * STAGE);
  float* ksc_s = reinterpret_cast<float*>(pid_s + PPSPLIT);
  float* vsc_s = ksc_s + PPSPLIT;

  const int64_t tile = (int64_t)BS * DH;
  const int64_t block_stride = (int64_t)H * tile;
  const int64_t kv_stride = (int64_t)NB1 * block_stride;
  const S* k_base = pool + (int64_t)layer * 2 * kv_stride + (int64_t)h * tile;
  const S* v_base = k_base + kv_stride;
  if constexpr (kQuant) {   // the scales of pages past the walk read 0
    if (tid >= n_pages && tid < PPSPLIT) ksc_s[tid] = vsc_s[tid] = 0.f;
  }
  if (tid < n_pages) {
    const int pid = pg0 == z * PPSPLIT ? spec_pid : table[pg0 + tid];
    pid_s[tid] = pid;
    if constexpr (kQuant) {   // scales[layer, kv, pid, h], with stage 0
      const float* at = scales + ((int64_t)layer * 2 * NB1 + pid) * H + h;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_u32(ksc_s + tid)), "l"(at) : "memory");
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_u32(vsc_s + tid)), "l"(at + (int64_t)NB1 * H)
                   : "memory");
    }
  }
  __syncthreads();

  // one step's pages of K and V into stage `step % NST`; V's rows past a
  // short last step's pages are zeroed (their P is 0, and 0 * garbage
  // could be NaN)
  auto issue = [&](int step) {
    const int st = step % NST;
    const int np = min(PPS, n_pages - step * PPS);
    const uint32_t kd = smem_u32(k_s + st * STAGE);
    const uint32_t vd = smem_u32(v_s + st * STAGE);
    for (int i = tid; i < np * BS * CPR; i += kThreads) {
      const int r = i / CPR, c = i - r * CPR;
      const int64_t src = (int64_t)pid_s[step * PPS + r / BS] * block_stride +
                          (int64_t)(r % BS) * DH + c * (16 / (int)sizeof(S));
      const int dst = swz<ROWB>(r, c);
      cp_async16(kd + dst, k_base + src);
      cp_async16(vd + dst, v_base + src);
    }
    uint4* vz = reinterpret_cast<uint4*>(v_s + st * STAGE + np * BS * ROWB);
    for (int i = tid; i < (PPS - np) * BS * CPR; i += kThreads)
      vz[i] = make_uint4(0, 0, 0, 0);
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_steps) issue(s);
    cp_async_commit();
  }

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const int qpos_lo = P.qpos0 + r_lo, qpos_hi = P.qpos0 + r_hi;

  // The walk for this tile's warp layout: each warp takes a window of
  // 64 / C columns (NT n8 tiles) of every step. The bounds are compile-
  // time, so a step's products issue back to back with no branch between
  // them; columns past the step's pages score -inf (P = 0, as if never
  // walked), masked ones -1e30.
  auto walk = [&](auto layout) {
    constexpr int C = decltype(layout)::value;
    constexpr int NT = 8 / C;
    const int win0 = warp % C * (kStepCols / C);
    for (int step = 0; step < n_steps; ++step) {
      cp_async_wait<NST - 2>();
      __syncthreads();   // this step's stage landed; the previous one is free
      if (step + NST - 1 < n_steps) issue(step + NST - 1);
      cp_async_commit();
      if (!active) continue;

      const int st = step % NST;
      const uint32_t kb = smem_u32(k_s + st * STAGE);
      const uint32_t vb = smem_u32(v_s + st * STAGE);
      const int step_col = (pg0 + step * PPS) * BS;   // the step's first key
      const int col_end = step_col + min(PPS, n_pages - step * PPS) * BS;

      // S = Q K^T over the window
      float s[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      if constexpr (kQuant) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int key = win0 + 8 * t;
          const float ks = ksc_s[step * PPS + key / BS];
          const int row = key + (lane & 7);
#pragma unroll
          for (int c4 = 0; c4 < KT; c4 += 4) {
            uint32_t w[4];   // codes of 8 keys x 4 chunks (k slices c4..c4+3)
            ldsm_x4(kb + swz<ROWB>(row, c4 + (lane >> 3)), w);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              mma16816<T>(s[t], qf[c4 + i], deq2<S, T>(w[i], 0, 1, ks),
                          deq2<S, T>(w[i], 2, 3, ks));
          }
        }
      } else {
#pragma unroll
        for (int t2 = 0; t2 < NT / 2; ++t2) {   // n8 tiles 2 t2, 2 t2 + 1
          const int row = win0 + 16 * t2 + ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
          for (int kt = 0; kt < KT; ++kt) {
            uint32_t w[4];
            ldsm_x4(kb + swz<ROWB>(row, 2 * kt + ((lane >> 3) & 1)), w);
            mma16816<T>(s[2 * t2], qf[kt], w[0], w[1]);
            mma16816<T>(s[2 * t2 + 1], qf[kt], w[2], w[3]);
          }
        }
      }

      // scale, mask, online softmax; rows r_lo (entries 0, 1), r_hi (2, 3)
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = step_col + win0 + 8 * t + 2 * a + (e & 1);
          const int qpos = e < 2 ? qpos_lo : qpos_hi;
          float v = s[t][e] * scale;
          if (col < P.lo || col > qpos) v = kNegInf;
          if (col >= col_end) v = -INFINITY;
          s[t][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = __expf(m_run[i] - mx[i]);
        m_run[i] = mx[i];
        l_run[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[t][e] - m_run[e >> 1]);
          l_run[e >> 1] += p;   // l sums P unrounded
          s[t][e] = p;
        }
      }

      // O += P V, 16 keys a slice; P rounded to T as it is packed
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const uint32_t pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                                pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                                pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const int key = win0 + 16 * kk;
        const int row = key + (((lane >> 3) & 1) << 3) + (lane & 7);
        if constexpr (kQuant) {
          const float vs = vsc_s[step * PPS + key / BS];
#pragma unroll
          for (int cx = 0; cx < KT; cx += 2) {   // 16-column chunks cx, cx + 1
            uint32_t w[4];   // keys 0-7 / 8-15 of the slice x chunks cx, cx+1
            ldsm_x4_t(vb + swz<ROWB>(row, cx + (lane >> 4)), w);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const uint32_t lo8 = w[2 * i], hi8 = w[2 * i + 1];
              // bytes: (key 2a, col 2g), (2a, 2g+1), (2a+1, 2g), (2a+1, 2g+1)
              mma16816<T>(o[2 * (cx + i)], pa, deq2<S, T>(lo8, 0, 2, vs),
                          deq2<S, T>(hi8, 0, 2, vs));
              mma16816<T>(o[2 * (cx + i) + 1], pa,
                          deq2<S, T>(lo8, 1, 3, vs),
                          deq2<S, T>(hi8, 1, 3, vs));
            }
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < NO / 2; ++jj) {   // n8 tiles 2 jj, 2 jj + 1
            uint32_t w[4];
            ldsm_x4_t(vb + swz<ROWB>(row, 2 * jj + (lane >> 4)), w);
            mma16816<T>(o[2 * jj], pa, w[0], w[1]);
            mma16816<T>(o[2 * jj + 1], pa, w[2], w[3]);
          }
        }
      }
    }
  };
  if (n_cg == 1)
    walk(Int<1>{});
  else if (n_cg == 2)
    walk(Int<2>{});
  else
    walk(Int<kWarps>{});
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the stages: reuse them

  // Each warp's unnormalised rows (acc, m, l) into shared memory in head-
  // dim order, then the tile's rows in natural order: row r is the sum of
  // row r % 16 of its group's n_cg warps, in warp order, with weights
  // exp(m_w - max m) (a warp that saw only masked columns weighs 0).
  static_assert(kWarps * 16 * (DH + 2) * 4 <= 2 * NST * STAGE,
                "the rows fit in the stages");
  float* acc_s = reinterpret_cast<float*>(smem);   // [4 warps][16][DH]
  float* ml_s = acc_s + kWarps * 16 * DH;          // [4 warps][16][2]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  if (active) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half;
      float* arow = acc_s + (warp * 16 + r) * DH;
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          arow[dh_col<kQuant>(j, e, a)] = o[j][2 * half + e];
      if (a == 0) {
        ml_s[2 * (warp * 16 + r)] = m_run[half];
        ml_s[2 * (warp * 16 + r) + 1] = l_run[half];
      }
    }
  }
  __syncthreads();
  const bool single = P.z_first == P.z_last;
  for (int i = tid; i < P.n_rows * DH / 4; i += kThreads) {   // 4 columns
    const int r = i / (DH / 4), d = (i - r * (DH / 4)) * 4;
    const int slot0 = r / 16 * n_cg * 16 + r % 16;   // the group's first warp
    float m, l;
    float4 acc;
    if (n_cg == 1)
      merge_warps<1, DH>(acc_s, ml_s, slot0, d, m, l, acc);
    else if (n_cg == 2)
      merge_warps<2, DH>(acc_s, ml_s, slot0, d, m, l, acc);
    else
      merge_warps<kWarps, DH>(acc_s, ml_s, slot0, d, m, l, acc);
    const int64_t row = (int64_t)h * Qp + b * kBlockQ + r;
    if (single) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      *reinterpret_cast<uint2*>(out + row * DH + d) =
          make_uint2(pack2<T>(acc.x * inv, acc.y * inv),
                     pack2<T>(acc.z * inv, acc.w * inv));
    } else {   // a split's partials: unnormalised acc, m and l of each row
      const int64_t at = row * n_splits + z;
      *reinterpret_cast<float4*>(part_acc + at * DH + d) = acc;
      if (d == 0)
        *reinterpret_cast<float2*>(part_ml + 2 * at) = make_float2(m, l);
    }
  }
}

// Sum of a multi-split tile's partials, in split order, for the 8 rows of
// layout block b (one CTA per block and head). part_z[b], written by the
// attention kernel, holds the tile's split range, or -1 for a block the
// attention kernel finished (one split, or a pad block). Launched as a
// programmatic dependent of the attention kernel: its launch overlaps
// that kernel's run, and griddepcontrol.wait holds it until the attention
// kernel has finished and its writes are visible. The partials are f32;
// only the final write is rounded to T.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
rpa_tc_combine_kernel(T* __restrict__ out,
                      const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ part_z, int Qp, int n_splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int b = blockIdx.x, h = blockIdx.y;
  const int zz = part_z[b];
  if (zz < 0) return;
  const int z_first = zz & 0xffff, z_last = zz >> 16;
  constexpr int kQuads = DH / 4;   // 4 columns a thread
  for (int i = threadIdx.x; i < kBlockQ * kQuads; i += kThreads) {
    const int r = i / kQuads, c = (i - r * kQuads) * 4;
    const int64_t row = (int64_t)h * Qp + b * kBlockQ + r;
    const int64_t at = row * n_splits;
    float m = kNegInf;
#pragma unroll 4
    for (int z = z_first; z <= z_last; ++z) m = fmaxf(m, part_ml[2 * (at + z)]);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int z = z_first; z <= z_last; ++z) {
      const float2 ml =
          *reinterpret_cast<const float2*>(part_ml + 2 * (at + z));
      const float4 v =
          *reinterpret_cast<const float4*>(part_acc + (at + z) * DH + c);
      const float w = __expf(ml.x - m);
      l += w * ml.y;
      acc.x += w * v.x;
      acc.y += w * v.y;
      acc.z += w * v.z;
      acc.w += w * v.w;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    *reinterpret_cast<uint2*>(out + row * DH + c) =
        make_uint2(pack2<T>(acc.x * inv, acc.y * inv),
                   pack2<T>(acc.z * inv, acc.w * inv));
  }
}

// the C entry's arguments, passed down the dispatch
struct Args {
  const void* q;
  const void* pool;
  const float* scales;
  void* out;
  float* part_acc;
  float* part_ml;
  int* part_z;
  const int *blk_seq, *seq_qstart, *seq_pos0, *tables, *lo, *kv_len;
  int H, Qp, NB1, T_len, layer;
  float scale;
  int n_slots, n_splits;
  cudaStream_t stream;
};

template <typename T, typename S, int DH, int BS>
int launch(const Args& x) {
  constexpr int kRowBytes = DH * (int)sizeof(S);
  const size_t smem = 2 * (size_t)kStages * kStepCols * kRowBytes +
                      kSplitCols / BS * (sizeof(int) + 2 * sizeof(float));
  static bool sized = false;   // the attribute outlives the launch
  cudaError_t e;
  if (!sized) {
    e = cudaFuncSetAttribute(rpa_tc_kernel<T, S, DH, BS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid(x.n_slots, x.H, x.n_splits);
  rpa_tc_kernel<T, S, DH, BS><<<grid, kThreads, smem, x.stream>>>(
      static_cast<const T*>(x.q), static_cast<const S*>(x.pool), x.scales,
      static_cast<T*>(x.out), x.part_acc, x.part_ml, x.part_z, x.blk_seq,
      x.seq_qstart, x.seq_pos0, x.tables, x.lo, x.kv_len, x.H, x.Qp, x.NB1,
      x.T_len, x.layer, x.scale, x.n_splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || x.n_splits == 1) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(x.Qp / kBlockQ, x.H);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = x.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, rpa_tc_combine_kernel<T, DH>,
                                 static_cast<T*>(x.out),
                                 (const float*)x.part_acc,
                                 (const float*)x.part_ml,
                                 (const int*)x.part_z, x.Qp, x.n_splits);
}

template <typename T, typename S, int DH>
int launch_bs(int bs, const Args& x) {
  if constexpr (sizeof(S) == 2) {   // 1-byte pools take blocks of >= 32
    if (bs == 16) return launch<T, S, DH, 16>(x);
  }
  if (bs == 32) return launch<T, S, DH, 32>(x);
  if (bs == 64) return launch<T, S, DH, 64>(x);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename S>
int launch_dh(int dh, int bs, const Args& x) {
  if (dh == 64) return launch_bs<T, S, 64>(bs, x);
  if (dh == 128) return launch_bs<T, S, 128>(bs, x);
  return (int)cudaErrorInvalidValue;
}

// the pool's storage: 0 = q's dtype T, 1 = int8, 2 = float8_e4m3fn codes
template <typename T>
int launch_storage(int storage, int dh, int bs, const Args& x) {
  if (storage == 0) return launch_dh<T, T>(dh, bs, x);
  if (storage == 1) return launch_dh<T, int8_t>(dh, bs, x);
  if (storage == 2) return launch_dh<T, __nv_fp8_e4m3>(dh, bs, x);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K1 (storage 0: a pool of q's dtype) and K1q (1: int8, 2: float8_e4m3fn
// codes with the float32 scales [L, 2, NB+1, H]) on the tensor cores; q and
// out of dtype 1 = bfloat16 or 2 = float16 (_build.DTYPE_CODE), Dh 64 or
// 128, bs 16 (16-bit pools), 32 or 64; S sequences.
// n_slots = ceil(Qp / 64) + S bounds the tile count (a sequence of k
// blocks makes at most k / 8 + 1 tiles); n_splits = ceil(T * bs / 128).
// Above one split, the float32 scratch part_acc [H, Qp, n_splits, Dh] and
// part_ml [H, Qp, n_splits, 2] takes the splits' partials, the int32
// part_z [Qp / 8] each block's split range, and a second launch combines
// them. Returns cudaGetLastError() after the launches (0 = success);
// asynchronous on `stream`.
extern "C" int rpa_tc_launch(int storage, int dtype, const void* q,
                             const void* pool, const float* scales, void* out,
                             float* part_acc, float* part_ml, int* part_z,
                             const int* blk_seq,
                             const int* seq_qstart, const int* seq_pos0,
                             const int* tables, const int* lo,
                             const int* kv_len, int H, int Qp, int S,
                             int Dh, int NB1, int bs, int T_len, int layer,
                             float scale, int n_slots, int n_splits,
                             void* stream) {
  if (n_splits < 1 ||
      (long long)n_splits * kSplitCols < (long long)T_len * bs ||
      n_slots < (Qp / kBlockQ + kTileBlocks - 1) / kTileBlocks + S)
    return (int)cudaErrorInvalidValue;
  const Args x{q, pool, scales, out, part_acc, part_ml, part_z, blk_seq,
               seq_qstart, seq_pos0, tables, lo, kv_len, H, Qp, NB1, T_len,
               layer, scale, n_slots, n_splits,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return launch_storage<bf16>(storage, Dh, bs, x);
  if (dtype == 2) return launch_storage<__half>(storage, Dh, bs, x);
  return (int)cudaErrorInvalidValue;
}
