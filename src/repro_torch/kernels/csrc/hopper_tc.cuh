// Hopper (sm_90a) pieces shared by the tensor-core kernels
// (flash_attention_tc.cu, the forward; flash_attention_bwd_tc.cu, the
// backward; ssm_scan_bwd_tc.cu, the chunked ssm_scan backward, which takes
// the wgmma pieces and the swizzled layout): mbarriers, TMA tile loads,
// wgmma issue / commit / wait, the
// 128-byte-swizzle shared-memory descriptor, the bf16 wgmma shapes both
// use, the kv-tile rules of a block of query rows, and the host-side
// tensor-map encoding.
//
// Layout every user keeps: a tile of rows of bf16 is stored in 64-column
// blocks; each block holds the tile's rows of 128 bytes one after another,
// 128-byte swizzled (the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B
// and wgmma reads through sw128_desc).  A K-major operand (the reduction
// runs along a row) steps 32 bytes per 16-column slice inside a block; an
// MN-major one (the reduction runs down the rows) steps 16 rows (2 KB) per
// slice, with the leading offset the distance between its 64-column blocks.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace hopper {

constexpr int kAtom = 64;       // bf16 columns of one swizzled 128-byte row
constexpr int kRowBytes = 128;
constexpr int kMmaRows = 64;    // rows of one wgmma (a warpgroup's rows)

// ------------------------------------------------------------ PTX wrappers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the wgmma issue and wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for register A operands (K slices of 16 columns, 4 words each):
// they stay live until the wgmma that reads them is waited for.
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[kk][r])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An fp32 accumulator (64 x 16K, s[4n + 2i + j] is row r0 + 8i, column 8n +
// c0 + j) in bf16: its layout of columns 16kk .. 16kk+15 is the register A
// layout of the kk-th k16 slice of the next product.
template <int K>
__device__ __forceinline__ void pack_frags(const float (&s)[8 * K], uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands step
// 1 KB per 8 rows (SBO); the leading offset is unused.  MN-major operands
// step 1 KB per 8 rows of the reduction (SBO) and `lbo` bytes per 64
// columns.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define FA_F8(d, i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x 128, fp32) = A (64 x 16) B (128 x 16)^T (+ S when scale_d), both
// bf16 from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : FA_F8(d, 0), FA_F8(d, 8), FA_F8(d, 16), FA_F8(d, 24), FA_F8(d, 32), FA_F8(d, 40),
        FA_F8(d, 48), FA_F8(d, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (64 x 64, fp32) = A (64 x 16) B (64 x 16)^T (+ S when scale_d), both
// bf16 from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FA_F8(d, 0), FA_F8(d, 8), FA_F8(d, 16), FA_F8(d, 24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, fp32) += A (64 x 16, bf16 in registers) B (16 x N, bf16 in
// shared memory, MN-major: the transpose flag).  The forward's O += P V;
// the backward's dV += P^T dO, dK += dS^T Q and dQ += dS K.
template <int N>
struct RsMma;

template <>
struct RsMma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : FA_F8(d, 0), FA_F8(d, 8), FA_F8(d, 16), FA_F8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct RsMma<80> {
  static __device__ __forceinline__ void mma(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
        "}\n"
        : FA_F8(d, 0), FA_F8(d, 8), FA_F8(d, 16), FA_F8(d, 24), FA_F8(d, 32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct RsMma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : FA_F8(d, 0), FA_F8(d, 8), FA_F8(d, 16), FA_F8(d, 24), FA_F8(d, 32), FA_F8(d, 40),
          FA_F8(d, 48), FA_F8(d, 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

#undef FA_F8

// ------------------------------------------------------------ tile rules
struct KvTiles {
  int lo, hi;  // kv tiles lo .. hi-1 hold every pair the block keeps
};

// The kv tiles of BK keys a block of query rows q0 .. q0+rows-1 must visit:
// with causal, none past the one holding key q0+rows-1; with a window, none
// before the one holding key q0-window+1 (the first any row keeps).
template <int BK>
__device__ __forceinline__ KvTiles kv_tiles(int q0, int rows, int Sk, int causal, int window) {
  int hi = (Sk + BK - 1) / BK;
  if (causal) hi = min(hi, (q0 + rows - 1) / BK + 1);
  int lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / BK;
  return {lo, max(lo, hi)};
}

// Whether the tile of keys k0 .. k0+BK-1 holds a pair of the 64 query rows
// q_lo .. q_lo+63 that the mask drops, or keys past Sk.
template <int BK>
__device__ __forceinline__ bool tile_masked(int q_lo, int k0, int Sk, int causal, int window) {
  return k0 + BK > Sk || (causal && k0 + BK - 1 > q_lo) ||
         (window > 0 && q_lo + kMmaRows - 1 - k0 >= window);
}

// ------------------------------------------------------------ host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime's
// entry-point query (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A (planes, rows, dh) bf16 tensor read in boxes of (1, box_rows, 64)
// columns, 128-byte swizzled; reads past a row's dh or past `rows` fill
// zeros.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int dh, int rows, int planes,
                            int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(dh) * 2 * rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kAtom), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
