// Flash attention on Hopper's tensor cores (bf16, GQA, causal / full,
// optional sliding window), written for sm_90a.
//
// Replaces, for bf16 inputs at head dims 64, 80 and 128, the Pallas TPU
// kernel src/repro/kernels/flash_attention.py: _flash_kernel (launched by
// flash_attention), the TPU-tiled form of the model's blocked_attend
// (redesigned for the tensor cores from the SIMT flash_attention.cu).  It
// computes what the SIMT kernel (flash_attention.cu) computes: q and o
// (B, H, Sq, dh), k and v (B, Hkv, Sk, dh); query head h reads kv head
// h / (H / Hkv); causal keeps q >= k, window > 0 keeps q - k < window; the
// softmax runs online over kv tiles with (m, l, acc) in fp32; p is rounded
// to bf16 before the PV product while l sums the unrounded p; the output is
// acc / max(l, 1e-30) in bf16.  Only the order of the sums inside QK^T and
// PV differs from the plain version (kernels/flash_attention.py).  Masked
// pairs get p = 0 (a score of -inf; the plain form's -1e30 gives the same
// output for every row that keeps a key, and every row of the model's
// self-attention keeps its own).
//
// Bound on this card: operations.  At llama3-8b's prefill shape (B=1,
// H=32, Hkv=8, S=4096, dh=128, causal) the work is 4 * H * dh * S(S+1)/2 =
// 137.5 GFLOP, 0.139 ms at the 989 TFLOP/s of the bf16 tensor cores,
// against 84 MB of q, k, v and o (0.025 ms at 3.35 TB/s).
//
// Design (FA3's shape):
//  * One block of 384 threads per (128-row query tile, head, batch): a
//    producer warpgroup and two consumer warpgroups of 64 query rows each.
//    blockIdx.x walks the heads (a kv group's heads are neighbours, so its
//    K/V tiles hit in L2) and blockIdx.y the query tiles from the last one
//    down (the longest causal rows start first, shortening the tail).
//  * The producer drops to 24 registers (setmaxnreg) and one of its threads
//    keeps K and V tiles of 128 keys in flight into a ring of two stages
//    with TMA (cp.async.bulk.tensor, tensor maps built on the host and
//    passed as __grid_constant__), completing on mbarriers; the consumers
//    free a stage's K and its V through their own "empty" mbarriers, so the
//    next K loads while this tile's P V still runs.  Rows are stored in
//    64-column blocks of 128 bytes with the 128-byte swizzle, the layout
//    wgmma reads.
//  * The consumers rise to 240 registers.  S = Q K^T is wgmma m64n128k16
//    (Q and K from shared memory, both K-major), fp32 accumulators; the
//    online softmax stays in registers (a row's 32 values a thread, its
//    max across the 4 threads that share it by shuffles; l is summed per
//    thread and across the 4 only at the end); p converts to bf16 in
//    registers, in the accumulator layout, which is the A-operand layout
//    of O += P V: wgmma m64n{dh}k16 with A from registers and V from
//    shared memory MN-major (the transpose flag).  Each step issues S of
//    tile j and then P V of tile j-1, and runs tile j's softmax while that
//    P V is on the tensor cores.
//  * Masks only where they bite: the kv tiles the causal mask or the
//    window masks for every row of the block are never loaded, and the
//    elementwise mask runs only on a tile that the diagonal, the window's
//    edge or the end of the keys (a half-full last tile, zero-filled by
//    TMA) crosses for the warpgroup's rows.  kernels/flash_attention.py:
//    tc_kv_tiles and tc_tile_masked mirror these rules for the CPU tests.
//  * dh = 80: the tensor maps carry the true row of 80, and the second
//    64-column block of each row is loaded as a full box whose columns
//    80-127 TMA fills with zeros.  QK^T reads depth 80 (5 slices of 16)
//    and PV writes N = 80, so no product touches the zeros; they cost
//    shared memory (the dh = 128 footprint, 160 KB) and TMA writes.
//  * A 64-row last query tile (Sq = 64 mod 128) runs one consumer: the
//    other loads nothing, computes nothing and stores nothing.
// Tried on the H100 and left out, as none was faster at the llama shape:
// FA3's ping-pong of the two consumers' issues on named barriers, one
// persistent block per SM walking the tiles in a fixed order (slower: the
// hardware's block scheduler balances the causal tiles better), kv tiles
// of 64 or of 176 keys, and the plain loop's expf softmax instead of ex2
// with the scale folded in (slower, and no closer at the model level).
//
// kernels/flash_attention.py routes bf16 at dh 64 and 128 here; bf16 at
// dh 80 (zamba2) stays on the SIMT kernel, bit-equal to the plain loop:
// any flash that is not (this one, the plain loop itself at another kv
// tile) moves zamba2's full-width logits ~3.3% normwise from the plain
// path's (flash_probe.py), above the bound its check keeps.  fp32 stays
// on the SIMT kernel too: the tensor cores would run it in TF32.  No model
// of the repo uses bf16 at dh 16, 32 or 256.

#include <math.h>

#include "hopper_tc.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;        // query rows of a block
constexpr int kWgRows = 64;     // query rows of a consumer warpgroup
constexpr int kBK = 128;        // keys of a kv tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kThreads = 384;   // producer + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Smem {
  static constexpr int kBlocks = (DH + kAtom - 1) / kAtom;  // 64-column blocks
  static constexpr int kQBlock = kWgRows * kRowBytes;        // 8 KB
  static constexpr int kKvBlock = kBK * kRowBytes;           // 16 KB
  static constexpr int kQ = 0;                               // [warpgroup][block]
  static constexpr int kK = kQ + 2 * kBlocks * kQBlock;      // [stage][block]
  static constexpr int kV = kK + kStages * kBlocks * kKvBlock;
  static constexpr int kBar = kV + kStages * kBlocks * kKvBlock;
  // mbarriers: q_full[2], then k_full, v_full, k_empty, v_empty [kStages]
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base to 1 KB
};

struct Bars {
  uint32_t base;
  __device__ uint32_t q_full(int w) const { return base + 8 * w; }
  __device__ uint32_t k_full(int s) const { return base + 8 * (2 + s); }
  __device__ uint32_t v_full(int s) const { return base + 8 * (2 + kStages + s); }
  __device__ uint32_t k_empty(int s) const { return base + 8 * (2 + 2 * kStages + s); }
  __device__ uint32_t v_empty(int s) const { return base + 8 * (2 + 3 * kStages + s); }
};

// ------------------------------------------------------------ the kernel
template <int DH>
__device__ __forceinline__ void produce(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, uint32_t base, Bars bars,
                                        int n_wg, int q0, int qplane, int kvplane,
                                        KvTiles tiles) {
  using L = Smem<DH>;
  for (int w = 0; w < n_wg; ++w) {
    mbar_expect_tx(bars.q_full(w), L::kBlocks * L::kQBlock);
    for (int blk = 0; blk < L::kBlocks; ++blk)
      tma_load_3d(base + L::kQ + (w * L::kBlocks + blk) * L::kQBlock, tm_q, bars.q_full(w),
                  blk * kAtom, q0 + w * kWgRows, qplane);
  }
  const int n_tiles = tiles.hi - tiles.lo;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int use = it / kStages;
    const int k0 = (tiles.lo + it) * kBK;
    if (use > 0) mbar_wait(bars.k_empty(s), (use - 1) & 1);  // the stage's K readers are done
    mbar_expect_tx(bars.k_full(s), L::kBlocks * L::kKvBlock);
    for (int blk = 0; blk < L::kBlocks; ++blk)
      tma_load_3d(base + L::kK + (s * L::kBlocks + blk) * L::kKvBlock, tm_k, bars.k_full(s),
                  blk * kAtom, k0, kvplane);
    if (use > 0) mbar_wait(bars.v_empty(s), (use - 1) & 1);
    mbar_expect_tx(bars.v_full(s), L::kBlocks * L::kKvBlock);
    for (int blk = 0; blk < L::kBlocks; ++blk)
      tma_load_3d(base + L::kV + (s * L::kBlocks + blk) * L::kKvBlock, tm_v, bars.v_full(s),
                  blk * kAtom, k0, kvplane);
  }
}

// S = Q K^T for one kv tile: DH / 16 slices of 16 columns, 4 to a swizzled
// 64-column block (issued, not waited for).
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], uint32_t sq, uint32_t sk) {
  using L = Smem<DH>;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;
    wgmma_ss_n128(s, sw128_desc(sq + (ks / 4) * L::kQBlock + col, 16),
                  sw128_desc(sk + (ks / 4) * L::kKvBlock + col, 16), ks > 0);
  }
}

// O += P V for one kv tile: kBK / 16 slices of 16 keys, 1 KB per 8 keys of a
// 64-column block (issued, not waited for).
template <int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[DH / 2], const uint32_t (&pa)[kBK / 16][4],
                                         uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    RsMma<DH>::mma(acc, pa[kk], sw128_desc(sv + kk * 16 * kRowBytes, Smem<DH>::kKvBlock));
}

// One tile's online softmax on the scores s (s[4n + 2i + j] is row r0 + 8i
// of the warpgroup, key k0 + 8n + c0 + j), in the log2 domain with the
// scale folded in: masks where the tile needs it, updates m and l, leaves p
// (fp32, unrounded) in s and returns the rows' rescale factors in corr.
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int q_lo, int r0, int k0, int c0,
                                             int Sk, float scale_log2, int causal, int window) {
  if (tile_masked<kBK>(q_lo, k0, Sk, causal, window)) {
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int q = q_lo + r0 + 8 * i;
          const int k = k0 + 8 * n + c0 + j;
          const bool keep = k < Sk && (!causal || q >= k) && (window <= 0 || q - k < window);
          if (!keep) s[4 * n + 2 * i + j] = -INFINITY;
        }
  }
  float ms[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    ms[i] = mx == -INFINITY ? 0.0f : mx * scale_log2;
    corr[i] = ex2(__fmaf_rn(m[i], scale_log2, -ms[i]));  // 0 while m was -inf
    m[i] = mx;
  }
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ex2(__fmaf_rn(s[4 * n + 2 * i + j], scale_log2, -ms[i]));
        s[4 * n + 2 * i + j] = p;
        rsum[i] += p;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rsum[i];
}

// A consumer warpgroup's 64 query rows.  Tile `it` runs its softmax while the
// tensor cores run tile it-1's P V: each step issues S_it = Q K_it^T and then
// O += P_{it-1} V_{it-1}, waits for S_it alone, and rescales O once P V is
// done.
template <int DH>
__device__ __forceinline__ void consume(__nv_bfloat16* __restrict__ out, uint32_t base, Bars bars,
                                        int wg, int q_lo, int Sk, float scale_log2, int causal,
                                        int window, KvTiles tiles) {
  using L = Smem<DH>;
  constexpr int kAcc = DH / 2;  // fp32 accumulators a thread holds of 64 x DH
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int r0 = warp * 16 + lane / 4;  // rows r0 and r0 + 8 of the warpgroup's 64
  const int c0 = 2 * (lane % 4);        // columns c0, c0 + 1 of each group of 8
  const uint32_t sq = base + L::kQ + wg * L::kBlocks * L::kQBlock;
  auto k_smem = [&](int st) { return base + L::kK + st * L::kBlocks * L::kKvBlock; };
  auto v_smem = [&](int st) { return base + L::kV + st * L::kBlocks * L::kKvBlock; };

  float acc[kAcc];
  float s[kBK / 2];
  uint32_t pa[kBK / 16][4];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  float corr[2];

  mbar_wait(bars.q_full(wg), 0);
  const int n_tiles = tiles.hi - tiles.lo;
  if (n_tiles > 0) {
    mbar_wait(bars.k_full(0), 0);
    fence_regs(s);
    wgmma_fence();
    issue_qk<DH>(s, sq, k_smem(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (t == 0) mbar_arrive(bars.k_empty(0));
    softmax_tile(s, m, l, corr, q_lo, r0, tiles.lo * kBK, c0, Sk, scale_log2, causal, window);
    pack_frags(s, pa);  // p in bf16, the A layout of P V
  }
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int prev = (it - 1) % kStages;
    mbar_wait(bars.k_full(st), (it / kStages) & 1);
    mbar_wait(bars.v_full(prev), ((it - 1) / kStages) & 1);
    fence_regs(s);
    fence_regs(acc);
    fence_frags(pa);
    wgmma_fence();
    issue_qk<DH>(s, sq, k_smem(st));
    wgmma_commit();
    issue_pv<DH>(acc, pa, v_smem(prev));
    wgmma_commit();
    wgmma_wait<1>();  // S_it is done; P_{it-1} V_{it-1} may still run
    fence_regs(s);
    if (t == 0) mbar_arrive(bars.k_empty(st));
    softmax_tile(s, m, l, corr, q_lo, r0, (tiles.lo + it) * kBK, c0, Sk, scale_log2, causal,
                 window);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(pa);
    if (t == 0) mbar_arrive(bars.v_empty(prev));
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * n + 2 * i] *= corr[i];
        acc[4 * n + 2 * i + 1] *= corr[i];
      }
    pack_frags(s, pa);  // p in bf16, the A layout of P V
  }
  if (n_tiles > 0) {
    const int last = (n_tiles - 1) % kStages;
    mbar_wait(bars.v_full(last), ((n_tiles - 1) / kStages) & 1);
    fence_regs(acc);
    fence_frags(pa);
    wgmma_fence();
    issue_pv<DH>(acc, pa, v_smem(last));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (t == 0) mbar_arrive(bars.v_empty(last));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* row = out + static_cast<long long>(q_lo + r0 + 8 * i) * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + c0) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] / denom, acc[4 * n + 2 * i + 1] / denom);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int H,
                    int group, int Sq, int Sk, float scale_log2, int causal, int window) {
  using L = Smem<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Bars bars{base + L::kBar};

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // the last query tiles first
  const int b = blockIdx.z;
  const int n_wg = min(kBQ, Sq - q0) / kWgRows;  // 1 on a 64-row last tile
  const KvTiles tiles = kv_tiles<kBK>(q0, n_wg * kWgRows, Sk, causal, window);

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) mbar_init(bars.q_full(w), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.k_full(s), 1);
      mbar_init(bars.v_full(s), 1);
      mbar_init(bars.k_empty(s), n_wg);
      mbar_init(bars.v_empty(s), n_wg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0)
      produce<DH>(&tm_q, &tm_k, &tm_v, base, bars, n_wg, q0, b * H + h,
                  b * (H / group) + h / group, tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    if (wg - 1 < n_wg) {
      const int q_lo = q0 + (wg - 1) * kWgRows;
      consume<DH>(o + (static_cast<long long>(b) * H + h) * Sq * DH, base, bars, wg - 1, q_lo, Sk,
                  scale_log2, causal, window, tiles);
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                   int Sq, int Sk, float scale, int causal, int window, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_map(&tm_q, q, DH, Sq, B * H, kWgRows);
  if (err == cudaSuccess) err = make_map(&tm_k, k, DH, Sk, B * Hkv, kBK);
  if (err == cudaSuccess) err = make_map(&tm_v, v, DH, Sk, B * Hkv, kBK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<DH>::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (Sq + kBQ - 1) / kBQ, B);
  flash_tc_kernel<DH><<<grid, kThreads, Smem<DH>::kAlloc, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), H, H / Hkv, Sq, Sk, scale * kLog2e,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, H, Sq, dh); k, v: (B, Hkv, Sk, dh); contiguous bf16 device
// tensors, 16-byte aligned.  Sq and Sk multiples of 64, H a multiple of Hkv,
// dh one of 64, 80, 128; window 0 means none.  Launches on `stream`; returns
// the CUDA error code of the launch (0 on success).
extern "C" int repro_flash_attention_tc(const void* q, const void* k, const void* v, void* o,
                                        int B, int H, int Hkv, int Sq, int Sk, int dh, float scale,
                                        int causal, int window, void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
                        15) == 0;
  if (!aligned || B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < kWgRows || Sq % kWgRows ||
      Sk < kWgRows || Sk % kWgRows || B > 65535 || (Sq + kBQ - 1) / kBQ > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, window, s));
    case 80:
      return static_cast<int>(launch<80>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, window, s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, window, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
