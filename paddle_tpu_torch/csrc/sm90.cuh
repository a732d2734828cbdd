// Hopper (sm_90a) building blocks of the tensor-core kernels: TMA tile
// loads that complete on mbarriers, wgmma shared-memory descriptors for
// 16-bit (bf16 or f16) tiles written by TMA with 128-byte swizzle, the
// wgmma products the kernels use, each for either operand type T, and the
// host-side encoding of a [B, S, H, D] tensor map.
//
// Tile layout in shared memory (what TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B from a box of 64 16-bit columns): rows of 128
// bytes, 8-row atoms of 1024 bytes, swizzled within the atom; a tile
// wider than 64 columns is several such column blocks one after another.
// Every tile starts on a 1024-byte boundary, so descriptors carry a base
// offset of 0.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// until the barrier's phase of parity `parity` has completed. A wait that
// outlasts ~2^32 clock cycles (seconds; a tile arrives in microseconds)
// traps, so a lost arrival fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

// ------------------------------------------------------------ TMA
// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------------------ wgmma
// Descriptor of a 128-byte-swizzled 16-bit operand at `p`: SBO = 1024 bytes
// (the next 8-row atom). K-major operands (the reduction runs along the
// 64-element rows) ignore LBO; MN-major ones (the reduction runs down the
// rows) take the byte stride between 64-column blocks as LBO.
__device__ __forceinline__ uint64_t desc_sw128(const void* p,
                                               uint32_t lbo_bytes) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;                       // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <typename T>
constexpr bool kHalf = std::is_same<T, __half>::value;

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

// The products below exist for T = bf16 and T = f16 (__half): one asm
// body each, its operand type spliced into the instruction (TY).

// d[32] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory;
// accumulate = 0 overwrites d
#define SM90_WGMMA_SS_N64(TY)                                                          \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                     \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                       \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                                      \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])                                                       \
      : "l"(da), "l"(db), "r"(accumulate))
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  if constexpr (kHalf<T>)
    SM90_WGMMA_SS_N64("f16");
  else
    SM90_WGMMA_SS_N64("bf16");
}
#undef SM90_WGMMA_SS_N64

// d[32] += A[64 x 16] . B[16 x 64], A from registers (four T pairs of the
// accumulator's fragment layout), B MN-major in shared memory
#define SM90_WGMMA_RS_N64(TY)                                                          \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                     \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                       \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                                      \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])                                                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (kHalf<T>)
    SM90_WGMMA_RS_N64("f16");
  else
    SM90_WGMMA_RS_N64("bf16");
}
#undef SM90_WGMMA_RS_N64

// d[64] += A[64 x 16] . B[16 x 128], A from registers (four T pairs of
// the accumulator's fragment layout), B MN-major in shared memory
#define SM90_WGMMA_RS_N128(TY)                                                         \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                     \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                    \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                       \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                       \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                       \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                                       \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                                       \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                                      \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),  \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (kHalf<T>)
    SM90_WGMMA_RS_N128("f16");
  else
    SM90_WGMMA_RS_N128("bf16");
}
#undef SM90_WGMMA_RS_N128

// ------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query so that the library needs no -lcuda; null where it is missing
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A contiguous [B, S, H, D] tensor of T (bf16 or f16) as a 4-D map (D, H,
// S, B) with boxes of `rows` x 64 columns of one (b, h): a tile of one head
// is read in place, and rows past S arrive as zeros. The swizzle and the
// box are the same for any 2-byte type; only the map's data type differs.
template <typename T>
inline bool encode_bshd(CUtensorMap* map, const void* base, int B, int S,
                        int H, int D, int rows) {
  static_assert(sizeof(T) == 2, "the tiles are of 16-bit elements");
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {e * D, e * D * H, e * D * H * S};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = kHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
