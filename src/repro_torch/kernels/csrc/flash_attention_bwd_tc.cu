// Flash attention backward on Hopper's tensor cores (bf16, GQA, causal /
// full, optional sliding window), written for sm_90a.
//
// Replaces no TPU kernel.  The reference trains through plain jnp: the
// gradient of its attention is XLA's autodiff of models/attention.py
// (blocked_attend), and src/repro/ has no custom_vjp.  The port's forward is
// a hand-written kernel called through ctypes, which autograd cannot see
// through; this kernel is the backward of that forward for bf16 at head dims
// 64, 80 and 128, redesigned for the tensor cores from the SIMT
// flash_attention_bwd.cu (which keeps fp32 and the other head dims).
//
// Layout as the forward's: q, o, do, dq (B, H, Sq, dh); k, v, dk, dv
// (B, Hkv, Sk, dh); query head h reads kv head h / (H / Hkv); causal keeps
// q >= k, window > 0 keeps q - k < window.  With s = scale * q.k, the row's
// max m and sum l of exp(s - m), and the saved output o:
//   p  = exp(s - m) / max(l, 1e-30)        (masked pairs give exactly 0)
//   D  = rowsum(do * o)
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - D) * scale
//   dk = ds^T q,  dq = ds k
// S = q k^T and dP = do v^T take bf16 operands and sum in fp32; p is rounded
// to bf16 before dv's product and ds before dk's and dq's (the tensor cores
// take bf16 operands; ds is formed from the unrounded p), each sum in fp32,
// each result rounded once to bf16.  kernels/flash_attention.py:
// flash_attention_bwd_plain(..., operands="bf16") spells this rounding.
//
// Three kernels, FA2's split, none with atomics, so the result is the same
// from run to run.  Each is a block of 384 threads: a producer warpgroup
// (24 registers; one thread keeps TMA loads in flight into shared memory,
// completing on mbarriers) and two consumer warpgroups (240 registers) of 64
// rows each.  Tiles are stored as hopper_tc.cuh describes.
//   1. bwd_tc_stats, a block per (128 query rows, head, batch): S = Q K^T
//      over the kv tiles of 128 keys the forward visits (wgmma m64n128k16,
//      both operands in shared memory), m and l online in fp32 in the log2
//      domain as the forward keeps them, and D from o and do; writes the
//      fp32 scratch (m * scale * log2(e), 1 / max(l, 1e-30), D), three
//      (B, H, Sq) planes.
//   2. bwd_tc_dkdv, a block per (128 keys, kv head, batch), each consumer
//      owning 64 keys whose K and V it keeps in shared memory; the producer
//      streams a ring of (Q, dO, the rows' m, 1/l, D) for every query head of
//      the kv group and every 64-row query tile the mask lets see the block.
//      Per tile: S^T = K Q^T and dP^T = V dO^T (m64n64k16, shared memory);
//      P^T and dS^T in registers; dV += P^T dO and dK += dS^T Q (A from
//      registers: the accumulator layout is the A layout; B MN-major).
//      dK and dV stay in fp32 registers across the group's heads and are
//      stored once.  dV's product runs while dS^T is formed.
//   3. bwd_tc_dq, a block per (128 query rows, head, batch): a ring of K and
//      V tiles of 64 keys; per tile S = Q K^T, dP = dO V^T, dS in
//      registers, dQ += dS K (K MN-major).  dQ's product of tile j runs
//      while tile j+1's S and dP are issued.
// Blocks run the longest first: dk/dv's from the first keys (causal rows
// see them most), the others from the last query rows.  Tiles that the
// causal mask or the window drop whole are never loaded; the elementwise
// mask runs only where the diagonal or the window's edge crosses a tile.
// kernels/flash_attention.py: tc_bwd_q_tiles and tc_kv_tiles mirror the
// tile rules for the CPU tests.
//
// dh = 80 (zamba2's shared attention block, hubert's encoder) is built as
// the forward builds it: a row takes two 64-column swizzled blocks (the dh
// 128 footprint in shared memory), the tensor maps carry the true row of
// 80 (160 bytes) and TMA fills columns 80-127 of the second block with
// zeros.  No product reads them: S = Q K^T and dP = dO V^T run depth 80 as
// 5 k16 slices, and dV, dK and dQ write N = 80 (wgmma m64n80k16), their
// MN-major B operands (dO, Q, K) spanning the two blocks as the forward's
// V does.  D and the stores take a row's 80 columns as 5 16-byte loads a
// half row and 10 groups of 8.
//
// Bound on this card: operations.  At llama3-8b's training shape (B=1,
// H=32, Hkv=8, S=4096, dh=128, causal) the three kernels do 16 * dh FLOP a
// kept query/key pair (s three times, dp twice, dv, dk, dq), 0.55 TFLOP,
// 0.556 ms at the 989 TFLOP/s of the bf16 tensor cores; FA2's 10 * dh
// would be 0.3475 ms.  q, k, v, o, do and the gradients are 84 MB (0.025
// ms).  At zamba2-2.7b's (B=1, H=Hkv=32, S=4096, dh=80, causal) FA2's
// count is 0.215 TFLOP, 0.217 ms (16 * dh: 0.3475 ms), against 168 MB
// (0.050 ms).

#include <math.h>

#include "hopper_tc.cuh"

namespace {

using namespace hopper;

constexpr int kRows = kMmaRows;  // rows of a tile: a warpgroup's queries or keys
constexpr int kBlockRows = 128;  // rows of a block: two consumer warpgroups
constexpr int kThreads = 384;    // producer + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStatsBK = 128;    // keys of the stats pass's kv tile
constexpr int kStatsStages = 2;  // its K ring
constexpr int kStages = 3;       // dk/dv's Q/dO ring, dq's K/V ring
constexpr int kTileBlock = kRows * kRowBytes;  // one 64-column block of a 64-row tile: 8 KB
constexpr int kStatBytes = 3 * kRows * 4;      // m, 1/l, D of 64 rows in fp32
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

template <int DH>
struct Tile {
  static_assert(DH % 16 == 0 && DH <= 2 * kAtom, "dh 64, 80 or 128");
  static constexpr int kBlocks = (DH + kAtom - 1) / kAtom;  // 64-column blocks
  static constexpr int kBytes = kBlocks * kTileBlock;       // a 64-row tile
  static constexpr int kSlices = DH / 16;                   // k16 slices of a row
};

template <int DH>
struct StatsSmem {
  static constexpr int kKBlock = kStatsBK * kRowBytes;      // 16 KB
  static constexpr int kQ = 0;                              // [warpgroup] 64-row tiles
  static constexpr int kK = kQ + 2 * Tile<DH>::kBytes;      // [stage][block]
  static constexpr int kBar = kK + kStatsStages * Tile<DH>::kBlocks * kKBlock;
  // mbarriers: q_full[2], k_full[kStatsStages], k_empty[kStatsStages]
  static constexpr int kAlloc = kBar + 8 * (2 + 2 * kStatsStages) + 1024;
};

template <int DH>
struct DkdvSmem {
  static constexpr int kT = Tile<DH>::kBytes;
  static constexpr int kK = 0;                    // [warpgroup] 64-key tiles
  static constexpr int kV = kK + 2 * kT;
  static constexpr int kQ = kV + 2 * kT;          // [stage]
  static constexpr int kDO = kQ + kStages * kT;   // [stage]
  static constexpr int kStat = kDO + kStages * kT;  // [stage] m, 1/l, D
  static constexpr int kBar = kStat + kStages * kStatBytes;
  // mbarriers: kv_full, q_full[kStages], q_empty[kStages]
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int DH>
struct DqSmem {
  static constexpr int kT = Tile<DH>::kBytes;
  static constexpr int kQ = 0;                    // [warpgroup]
  static constexpr int kDO = kQ + 2 * kT;         // [warpgroup]
  static constexpr int kK = kDO + 2 * kT;         // [stage] 64-key tiles
  static constexpr int kV = kK + kStages * kT;    // [stage]
  static constexpr int kBar = kV + kStages * kT;
  // mbarriers: q_full[2], kv_full[kStages], kv_empty[kStages]
  static constexpr int kAlloc = kBar + 8 * (2 + 2 * kStages) + 1024;
};

// A 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Descriptors of the k16 slice `ks` of a K-major tile whose 64-column blocks
// lie `block` bytes apart, and of the k16 slice `kk` (16 rows) of an
// MN-major 64-row tile.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks, int block) {
  return sw128_desc(tile + (ks / 4) * block + (ks % 4) * 32, 16);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * kRowBytes, kTileBlock);
}

// The 64-row query tiles a block of keys k0 .. k0+keys-1 must visit: with
// causal, none before the one holding query k0 (earlier rows keep none of
// its keys); with a window, none past the one holding query
// k0+keys-1+window-1 (the last row any of its keys is kept by).
__device__ __forceinline__ KvTiles q_tiles(int k0, int keys, int Sq, int causal, int window) {
  const int lo = causal ? k0 / kRows : 0;
  int hi = Sq / kRows;
  if (window > 0) hi = min(hi, (k0 + keys - 1 + window - 1) / kRows + 1);
  return {lo, max(lo, hi)};
}

// Whether the 64 x 64 tile of query rows q0 .. and keys kw0 .. holds a pair
// the mask drops (no tile runs past Sq or Sk: both are multiples of 64).
__device__ __forceinline__ bool pair_tile_masked(int q0, int kw0, int causal, int window) {
  return (causal && q0 < kw0 + kRows - 1) || (window > 0 && q0 + kRows - 1 - kw0 >= window);
}

// A fresh accumulator for a product whose first slice overwrites it: zeros
// (fenced), so that its last tile's values are dead once read and need no
// registers while the other products run.
template <int N>
__device__ __forceinline__ void fresh(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
  fence_regs(r);
}

__device__ __forceinline__ bool keep(int q, int k, int causal, int window) {
  return (!causal || q >= k) && (window <= 0 || q - k < window);
}

// ------------------------------------------------------------ 1. stats
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_tc_stats(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k128, const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout, float* __restrict__ ws, int H, int group,
                 int Sq, int Sk, float scale_log2, int causal, int window, long long plane) {
  using L = StatsSmem<DH>;
  using T = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBar;
  auto q_full = [&](int w) { return bars + 8 * w; };
  auto k_full = [&](int s) { return bars + 8 * (2 + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 + kStatsStages + s); };

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // the last query rows first
  const int b = blockIdx.z;
  const int n_wg = min(kBlockRows, Sq - q0) / kRows;  // 1 on a 64-row last tile
  const KvTiles tiles = kv_tiles<kStatsBK>(q0, n_wg * kRows, Sk, causal, window);
  const int n_tiles = tiles.hi - tiles.lo;
  const int qplane = b * H + h;

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) mbar_init(q_full(w), 1);
    for (int s = 0; s < kStatsStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), n_wg);
    }
    init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int kvplane = b * (H / group) + h / group;
      for (int w = 0; w < n_wg; ++w) {
        mbar_expect_tx(q_full(w), T::kBytes);
        for (int blk = 0; blk < T::kBlocks; ++blk)
          tma_load_3d(base + L::kQ + w * T::kBytes + blk * kTileBlock, &tm_q, q_full(w),
                      blk * kAtom, q0 + w * kRows, qplane);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStatsStages;
        const int use = it / kStatsStages;
        if (use > 0) mbar_wait(k_empty(s), (use - 1) & 1);
        mbar_expect_tx(k_full(s), T::kBlocks * L::kKBlock);
        for (int blk = 0; blk < T::kBlocks; ++blk)
          tma_load_3d(base + L::kK + (s * T::kBlocks + blk) * L::kKBlock, &tm_k128, k_full(s),
                      blk * kAtom, (tiles.lo + it) * kStatsBK, kvplane);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int w = wg - 1;
  if (w >= n_wg) return;
  const int q_lo = q0 + w * kRows;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // rows r0 and r0 + 8 of the warpgroup's 64
  const int c0 = 2 * (lane % 4);            // columns c0, c0 + 1 of each group of 8
  const long long row0 = static_cast<long long>(qplane) * Sq + q_lo;

  {  // D = rowsum(do * o): two threads a row, half of it each, 8 values a load
    const int r = t / 2;
    const long long at = (row0 + r) * DH + (t % 2) * (DH / 2);
    const uint4* po = reinterpret_cast<const uint4*>(o + at);
    const uint4* pd = reinterpret_cast<const uint4*>(dout + at);
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      const uint4 a = po[c];
      const uint4 d = pd[c];
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 af = __bfloat1622float2(a2[e]);
        const float2 df = __bfloat1622float2(d2[e]);
        acc = fmaf(af.x, df.x, acc);
        acc = fmaf(af.y, df.y, acc);
      }
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    if (t % 2 == 0) ws[2 * plane + row0 + r] = acc;
  }

  const uint32_t sq = base + L::kQ + w * T::kBytes;
  float s[kStatsBK / 2];
#pragma unroll
  for (int i = 0; i < kStatsBK / 2; ++i) s[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // raw q.k maxima of rows r0, r0 + 8
  float l[2] = {0.0f, 0.0f};
  mbar_wait(q_full(w), 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStatsStages;
    const uint32_t sk = base + L::kK + st * T::kBlocks * L::kKBlock;
    mbar_wait(k_full(st), (it / kStatsStages) & 1);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < T::kSlices; ++ks)
      wgmma_ss_n128(s, kmajor(sq, ks, kTileBlock), kmajor(sk, ks, L::kKBlock), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (t == 0) mbar_arrive(k_empty(st));
    const int k0 = (tiles.lo + it) * kStatsBK;
    if (tile_masked<kStatsBK>(q_lo, k0, Sk, causal, window)) {
#pragma unroll
      for (int n = 0; n < kStatsBK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = k0 + 8 * n + c0 + j;
            if (k >= Sk || !keep(q_lo + r0 + 8 * i, k, causal, window))
              s[4 * n + 2 * i + j] = -INFINITY;
          }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < kStatsBK / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float ms = mx == -INFINITY ? 0.0f : mx * scale_log2;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < kStatsBK / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) sum += ex2(__fmaf_rn(s[4 * n + 2 * i + j], scale_log2, -ms));
      l[i] = l[i] * ex2(__fmaf_rn(m[i], scale_log2, -ms)) + sum;  // ex2(-inf) = 0 at first
      m[i] = mx;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    if (lane % 4 == 0) {
      const long long row = row0 + r0 + 8 * i;
      ws[row] = m[i] == -INFINITY ? 0.0f : m[i] * scale_log2;
      ws[plane + row] = 1.0f / fmaxf(l[i], 1e-30f);
    }
  }
}

// ------------------------------------------------------------ 2. dk, dv
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_tc_dkdv(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ ws, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int H, int group, int Sq, int Sk, float scale,
                float scale_log2, int causal, int window, long long plane) {
  using L = DkdvSmem<DH>;
  using T = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + L::kBar;
  const uint32_t kv_full = bars;
  auto q_full = [&](int s) { return bars + 8 * (1 + s); };
  auto q_empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int hk = blockIdx.x;
  const int k0 = blockIdx.y * kBlockRows;  // the first keys first
  const int b = blockIdx.z;
  const int n_wg = min(kBlockRows, Sk - k0) / kRows;  // 1 on a 64-key last tile
  const KvTiles qt = q_tiles(k0, n_wg * kRows, Sq, causal, window);
  const int n_q = qt.hi - qt.lo;
  const int n_it = group * n_q;  // the group's heads, each over its query tiles
  const int kvplane = b * (H / group) + hk;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(q_empty(s), n_wg);
    }
    init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * n_wg * T::kBytes);
      for (int w = 0; w < n_wg; ++w)
        for (int blk = 0; blk < T::kBlocks; ++blk) {
          const uint32_t off = w * T::kBytes + blk * kTileBlock;
          tma_load_3d(base + L::kK + off, &tm_k, kv_full, blk * kAtom, k0 + w * kRows, kvplane);
          tma_load_3d(base + L::kV + off, &tm_v, kv_full, blk * kAtom, k0 + w * kRows, kvplane);
        }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int use = it / kStages;
        const int q0 = (qt.lo + it % n_q) * kRows;
        const int qplane = b * H + hk * group + it / n_q;
        if (use > 0) mbar_wait(q_empty(s), (use - 1) & 1);
        mbar_expect_tx(q_full(s), 2 * T::kBytes + kStatBytes);
        for (int blk = 0; blk < T::kBlocks; ++blk) {
          const uint32_t off = s * T::kBytes + blk * kTileBlock;
          tma_load_3d(base + L::kQ + off, &tm_q, q_full(s), blk * kAtom, q0, qplane);
          tma_load_3d(base + L::kDO + off, &tm_do, q_full(s), blk * kAtom, q0, qplane);
        }
        const float* rows = ws + static_cast<long long>(qplane) * Sq + q0;
        const uint32_t stat = base + L::kStat + s * kStatBytes;
        for (int p = 0; p < 3; ++p)
          bulk_load(stat + p * kRows * 4, rows + p * plane, kRows * 4, q_full(s));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int w = wg - 1;
  if (w >= n_wg) return;
  const int kw0 = k0 + w * kRows;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // keys kw0 + r0 and kw0 + r0 + 8
  const int c0 = 2 * (lane % 4);            // queries c0, c0 + 1 of each group of 8
  const uint32_t sk = base + L::kK + w * T::kBytes;
  const uint32_t sv = base + L::kV + w * T::kBytes;

  float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  float s[kRows / 2], dp[kRows / 2];
  uint32_t pa[kRows / 16][4], da[kRows / 16][4];

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int q0 = (qt.lo + it % n_q) * kRows;
    const uint32_t sq = base + L::kQ + st * T::kBytes;
    const uint32_t sdo = base + L::kDO + st * T::kBytes;
    const float* stat = reinterpret_cast<const float*>(sbase + L::kStat + st * kStatBytes);
    mbar_wait(q_full(st), (it / kStages) & 1);

    // S^T = K Q^T, dP^T = V dO^T
    fresh(s);
    fresh(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < T::kSlices; ++ks)
      wgmma_ss_n64(s, kmajor(sk, ks, kTileBlock), kmajor(sq, ks, kTileBlock), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < T::kSlices; ++ks)
      wgmma_ss_n64(dp, kmajor(sv, ks, kTileBlock), kmajor(sdo, ks, kTileBlock), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P^T (s[4n + 2i + j]: key r0 + 8i, query 8n + c0 + j), then dV += P^T dO
    const bool masked = pair_tile_masked(q0, kw0, causal, window);
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n) {
      const float2 mq = *reinterpret_cast<const float2*>(stat + 8 * n + c0);
      const float2 lq = *reinterpret_cast<const float2*>(stat + kRows + 8 * n + c0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float p0 = ex2(__fmaf_rn(s[4 * n + 2 * i], scale_log2, -mq.x)) * lq.x;
        float p1 = ex2(__fmaf_rn(s[4 * n + 2 * i + 1], scale_log2, -mq.y)) * lq.y;
        if (masked) {
          const int k = kw0 + r0 + 8 * i;
          if (!keep(q0 + 8 * n + c0, k, causal, window)) p0 = 0.0f;
          if (!keep(q0 + 8 * n + c0 + 1, k, causal, window)) p1 = 0.0f;
        }
        s[4 * n + 2 * i] = p0;
        s[4 * n + 2 * i + 1] = p1;
      }
    }
    pack_frags(s, pa);
    fence_frags(pa);
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) RsMma<DH>::mma(dv_acc, pa[kk], mnmajor(sdo, kk));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is done; dV's product may still run
    fence_regs(dp);

    // dS^T = P^T (dP^T - D) scale, then dK += dS^T Q
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n) {
      const float2 dd = *reinterpret_cast<const float2*>(stat + 2 * kRows + 8 * n + c0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dp[4 * n + 2 * i] = s[4 * n + 2 * i] * (dp[4 * n + 2 * i] - dd.x) * scale;
        dp[4 * n + 2 * i + 1] = s[4 * n + 2 * i + 1] * (dp[4 * n + 2 * i + 1] - dd.y) * scale;
      }
    }
    pack_frags(dp, da);
    fence_frags(da);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) RsMma<DH>::mma(dk_acc, da[kk], mnmajor(sq, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_frags(pa);
    fence_frags(da);
    if (t == 0) mbar_arrive(q_empty(st));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = static_cast<long long>(kvplane) * Sk + kw0 + r0 + 8 * i;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + row * DH + 8 * n + c0) =
          __floats2bfloat162_rn(dk_acc[4 * n + 2 * i], dk_acc[4 * n + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + row * DH + 8 * n + c0) =
          __floats2bfloat162_rn(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------ 3. dq
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_tc_dq(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
              const float* __restrict__ ws, __nv_bfloat16* __restrict__ dq, int H, int group,
              int Sq, int Sk, float scale, float scale_log2, int causal, int window,
              long long plane) {
  using L = DqSmem<DH>;
  using T = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBar;
  auto q_full = [&](int w) { return bars + 8 * w; };
  auto kv_full = [&](int s) { return bars + 8 * (2 + s); };
  auto kv_empty = [&](int s) { return bars + 8 * (2 + kStages + s); };

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // the last query rows first
  const int b = blockIdx.z;
  const int n_wg = min(kBlockRows, Sq - q0) / kRows;
  const KvTiles tiles = kv_tiles<kRows>(q0, n_wg * kRows, Sk, causal, window);
  const int n_tiles = tiles.hi - tiles.lo;
  const int qplane = b * H + h;

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) mbar_init(q_full(w), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), n_wg);
    }
    init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int kvplane = b * (H / group) + h / group;
      for (int w = 0; w < n_wg; ++w) {
        mbar_expect_tx(q_full(w), 2 * T::kBytes);
        for (int blk = 0; blk < T::kBlocks; ++blk) {
          const uint32_t off = w * T::kBytes + blk * kTileBlock;
          tma_load_3d(base + L::kQ + off, &tm_q, q_full(w), blk * kAtom, q0 + w * kRows, qplane);
          tma_load_3d(base + L::kDO + off, &tm_do, q_full(w), blk * kAtom, q0 + w * kRows,
                      qplane);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int use = it / kStages;
        const int kt0 = (tiles.lo + it) * kRows;
        if (use > 0) mbar_wait(kv_empty(s), (use - 1) & 1);
        mbar_expect_tx(kv_full(s), 2 * T::kBytes);
        for (int blk = 0; blk < T::kBlocks; ++blk) {
          const uint32_t off = s * T::kBytes + blk * kTileBlock;
          tma_load_3d(base + L::kK + off, &tm_k, kv_full(s), blk * kAtom, kt0, kvplane);
          tma_load_3d(base + L::kV + off, &tm_v, kv_full(s), blk * kAtom, kt0, kvplane);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int w = wg - 1;
  if (w >= n_wg) return;
  const int q_lo = q0 + w * kRows;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // rows q_lo + r0 and q_lo + r0 + 8
  const int c0 = 2 * (lane % 4);            // keys c0, c0 + 1 of each group of 8
  const long long row0 = static_cast<long long>(qplane) * Sq + q_lo;
  float m2[2], linv[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = row0 + r0 + 8 * i;
    m2[i] = ws[row];
    linv[i] = ws[plane + row];
    dd[i] = ws[2 * plane + row];
  }
  const uint32_t sq = base + L::kQ + w * T::kBytes;
  const uint32_t sdo = base + L::kDO + w * T::kBytes;

  float dq_acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq_acc[i] = 0.0f;
  float s[kRows / 2], dp[kRows / 2];
  uint32_t da[kRows / 16][4];
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) da[kk][r] = 0u;

  mbar_wait(q_full(w), 0);
  int prev = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int kt0 = (tiles.lo + it) * kRows;
    const uint32_t sk = base + L::kK + st * T::kBytes;
    const uint32_t sv = base + L::kV + st * T::kBytes;
    mbar_wait(kv_full(st), (it / kStages) & 1);

    // S = Q K^T, dP = dO V^T, issued while the previous tile's dQ runs
    fresh(s);
    fresh(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < T::kSlices; ++ks)
      wgmma_ss_n64(s, kmajor(sq, ks, kTileBlock), kmajor(sk, ks, kTileBlock), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < T::kSlices; ++ks)
      wgmma_ss_n64(dp, kmajor(sdo, ks, kTileBlock), kmajor(sv, ks, kTileBlock), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous dQ and this S are done
    fence_regs(s);
    fence_regs(dq_acc);
    fence_frags(da);
    if (it > 0 && t == 0) mbar_arrive(kv_empty(prev));

    // P (s[4n + 2i + j]: row r0 + 8i, key 8n + c0 + j)
    const bool masked = tile_masked<kRows>(q_lo, kt0, Sk, causal, window);
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float p = ex2(__fmaf_rn(s[4 * n + 2 * i + j], scale_log2, -m2[i])) * linv[i];
          if (masked && !keep(q_lo + r0 + 8 * i, kt0 + 8 * n + c0 + j, causal, window)) p = 0.0f;
          s[4 * n + 2 * i + j] = p;
        }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS = P (dP - D) scale, then dQ += dS K
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          dp[4 * n + 2 * i + j] = s[4 * n + 2 * i + j] * (dp[4 * n + 2 * i + j] - dd[i]) * scale;
    pack_frags(dp, da);
    fence_frags(da);
    fence_regs(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) RsMma<DH>::mma(dq_acc, da[kk], mnmajor(sk, kk));
    wgmma_commit();
    prev = st;
  }
  wgmma_wait<0>();
  fence_regs(dq_acc);
  fence_frags(da);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat16* row = dq + (row0 + r0 + 8 * i) * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + c0) =
          __floats2bfloat162_rn(dq_acc[4 * n + 2 * i], dq_acc[4 * n + 2 * i + 1]);
  }
}

// ------------------------------------------------------------ host side
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   void* dq, void* dk, void* dv, float* ws, int B, int H, int Hkv, int Sq, int Sk,
                   float scale, int causal, int window, cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_k128;
  cudaError_t err = make_map(&tm_q, q, DH, Sq, B * H, kRows);
  if (err == cudaSuccess) err = make_map(&tm_do, dout, DH, Sq, B * H, kRows);
  if (err == cudaSuccess) err = make_map(&tm_k, k, DH, Sk, B * Hkv, kRows);
  if (err == cudaSuccess) err = make_map(&tm_v, v, DH, Sk, B * Hkv, kRows);
  if (err == cudaSuccess) err = make_map(&tm_k128, k, DH, Sk, B * Hkv, kStatsBK);
  if (err == cudaSuccess) err = allow_smem(bwd_tc_stats<DH>, StatsSmem<DH>::kAlloc);
  if (err == cudaSuccess) err = allow_smem(bwd_tc_dkdv<DH>, DkdvSmem<DH>::kAlloc);
  if (err == cudaSuccess) err = allow_smem(bwd_tc_dq<DH>, DqSmem<DH>::kAlloc);
  if (err != cudaSuccess) return err;
  const int group = H / Hkv;
  const float scale_log2 = scale * kLog2e;
  const long long plane = static_cast<long long>(B) * H * Sq;
  const auto* o16 = static_cast<const __nv_bfloat16*>(o);
  const auto* do16 = static_cast<const __nv_bfloat16*>(dout);
  const dim3 q_grid(H, (Sq + kBlockRows - 1) / kBlockRows, B);
  bwd_tc_stats<DH><<<q_grid, kThreads, StatsSmem<DH>::kAlloc, stream>>>(
      tm_q, tm_k128, o16, do16, ws, H, group, Sq, Sk, scale_log2, causal, window, plane);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_tc_dkdv<DH><<<dim3(Hkv, (Sk + kBlockRows - 1) / kBlockRows, B), kThreads,
                    DkdvSmem<DH>::kAlloc, stream>>>(
      tm_q, tm_k, tm_v, tm_do, ws, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, group, Sq, Sk, scale, scale_log2, causal, window, plane);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_tc_dq<DH><<<q_grid, kThreads, DqSmem<DH>::kAlloc, stream>>>(
      tm_q, tm_k, tm_v, tm_do, ws, static_cast<__nv_bfloat16*>(dq), H, group, Sq, Sk, scale,
      scale_log2, causal, window, plane);
  return cudaGetLastError();
}

}  // namespace

// q, o, do, dq: (B, H, Sq, dh); k, v, dk, dv: (B, Hkv, Sk, dh); contiguous
// bf16 device tensors, 16-byte aligned; ws: fp32 scratch of 3 * B * H * Sq,
// 16-byte aligned.  Sq and Sk multiples of 64, H a multiple of Hkv, dh 64,
// 80 or 128; window 0 means none.  Launches three kernels on `stream`;
// returns the CUDA error code of the launches (0 on success).
extern "C" int repro_flash_attention_bwd_tc(const void* q, const void* k, const void* v,
                                            const void* o, const void* dout, void* dq, void* dk,
                                            void* dv, void* ws, int B, int H, int Hkv, int Sq,
                                            int Sk, int dh, float scale, int causal, int window,
                                            void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                         reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
                         reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
                         reinterpret_cast<uintptr_t>(ws);
  if ((addr & 15) || B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < kRows || Sq % kRows ||
      Sk < kRows || Sk % kRows || B > 65535 || (Sq + kBlockRows - 1) / kBlockRows > 65535 ||
      (Sk + kBlockRows - 1) / kBlockRows > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  switch (dh) {
    case 64:
      return static_cast<int>(
          launch<64>(q, k, v, o, dout, dq, dk, dv, w, B, H, Hkv, Sq, Sk, scale, causal, window, s));
    case 80:
      return static_cast<int>(
          launch<80>(q, k, v, o, dout, dq, dk, dv, w, B, H, Hkv, Sq, Sk, scale, causal, window, s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, o, dout, dq, dk, dv, w, B, H, Hkv, Sq, Sk,
                                          scale, causal, window, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
