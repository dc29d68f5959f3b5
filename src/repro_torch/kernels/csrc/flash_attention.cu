// Flash attention (GQA, causal / full, optional sliding window) on the fp32
// pipes, written for Hopper (sm_90a): the "simt" variant of
// kernels/flash_attention.py, bit for bit equal to its plain loop.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// _flash_kernel (launched by flash_attention), the TPU-tiled form of the
// model's blocked_attend (src/repro/models/attention.py).  Layout as the
// Pallas kernel's: q and o (B, H, Sq, dh), k and v (B, Hkv, Sk, dh); query
// head h reads kv head h / (H / Hkv).  Scores are scaled by `scale`
// (1/sqrt(dh)), masked scores are -1e30, and the softmax runs online over kv
// tiles with (m, l, acc) in fp32; the output is acc / max(l, 1e-30), written
// once in the input type.
//
// Rounding follows blocked_attend, the form the model runs: q, k and v stay
// in their type (bf16 products are exact in fp32), p is rounded to v's type
// before the PV product, and l sums the unrounded p.  For fp32 inputs that is
// the Pallas body's arithmetic too.
//
// The arithmetic contract: every output element goes through the rounded
// operations of flash_attention_plain on the card, in its order, so the two
// agree bit for bit (built with --fmad=false, IEEE division, expf):
//   * s[i][j] is one fmaf chain over d = 0 .. dh-1 from 0.0f, then times
//     scale, then -1e30 where masked; a chain is never split for ILP;
//   * kv tiles are exactly 64 keys (BLOCK_KV); per tile m_new = max(m, row
//     max), p = expf(s - m_new), corr = expf(m - m_new);
//   * the row sum of p is a fixed tree: keys (j, j+32) for j < 32, then the
//     pairs 16 apart, 8, 4, 2, 1 (the xor butterfly of one warp holding two
//     keys a lane); l = l * corr + sum;
//   * pv is a fresh fmaf chain over the tile's 64 keys in ascending order,
//     of p rounded to v's type; acc = acc * corr + pv;
//   * out = acc / max(l, 1e-30).
// fp32 inputs run the same chains (there fmaf and a multiply-add differ, so
// the explicit fmaf stays).  Kv tiles that the mask drops for every row of a
// query tile are skipped: with a real score seen they change nothing, and
// before one they leave (m, l, acc) where the first kept tile's corr = 0
// wipes them; every row sees its own key.
//
// Design: one block per (query tile, head, batch) of 16 row groups by L key
// lanes; a thread holds TM query rows by TN keys of each kv tile, TM = TN =
// 8 up to dh 80 (L = 8: 128 threads, 128-row query tiles), 4 above (L = 16:
// 256 threads, 64 rows).  Key lane j holds keys j, j+L, ..., j+L(TN-1), so
// the pairs (j, j+32) and the levels of the row-sum tree down to L lanes
// apart are its own adds, and the lanes of a row group add the rest with
// __shfl_xor_sync: the softmax stays in registers, with no shared-memory
// round trip, and (m, l) of row i live in the key lanes j with j % TM = i.
// Q and K are staged d-major (transposed) in shared memory as fp32, K with
// each lane's keys in 16-byte words that a quarter warp reads side by side:
// at each d a thread reads (TM + TN) / 4 16-byte words for TM TN fmaf (8 x
// 8: 4 per 64, where a 4 x 4 tile of scalar loads reads 8 words per 16).  p goes to shared
// memory key-major (rows padded by 4 words, so a quarter warp's stores hit
// 32 distinct banks) in the K tile's place; V stays row-major, and each lane
// owns dh/L output columns (groups of four adjacent columns 4L apart, then
// dh % 4L / L columns), so the PV loop reads TM/4 + dh/4L (+1) words per TM
// dh/L fmaf.  acc, pv and the scores live in registers (233 at bf16 dh 80, no
// spill); two blocks share an SM up to dh 128 (95 KB of shared memory at
// dh 80), so one block's staging and barriers overlap the other's products.
// Blocks run the heaviest query tiles first: block i takes tile
// n_q - 1 - i / (H B) of head-batch i % (H B) (simt_block_tile in
// flash_attention.py mirrors it), so causal's long tiles do not form the
// tail.
//
// Bound on this card: operations.  The tensor-core bound at zamba2's shape
// (B=1, H=Hkv=32, S=4096, dh=80, causal) is 4 H dh S(S+1)/2 = 86 GFLOP at
// 989 TFLOP/s, 0.0869 ms.  Bit-equality with the plain loop keeps this kernel
// off the tensor cores (their sums run in another order), so its floor is the
// fp32 pipes': 2 dh fmaf for each (query, key) pair of the tiles it computes,
// 4.4e10 at that shape, 1.3-1.5 ms at 132 SMs x 128 lanes x 1.76-1.98 GHz
// (chip_smoke.py prints it as ffma_floor_ms).  The score and PV loops are
// ~90% fmaf in SASS; with expf, masks, shuffles and staging a tile runs
// ~1.3 instructions a fmaf, and by a count of quarter-warp accesses the
// loops' 16-byte loads keep the SM's shared-memory port about as busy as
// its fp32 pipes: the kernel runs at ~1.7x the floor (flash_simt_probe.py;
// PERF.md).  Head dims 16, 32, 64, 80, 128 and 256 are built; dh 256 runs
// one block an SM (192 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;  // keys a kv tile (BLOCK_KV)
constexpr int kGroups = 16;  // row groups a block
constexpr float kMasked = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// The block's shape at head dim DH.  A thread holds TM query rows by TN keys
// of each kv tile; key lane j (of L = 64 / TN) holds keys j, j + L, ...,
// j + L (TN - 1), so TN / 2 = 32 / L and keys j + L a and j + L a + 32 are
// the thread's own.
template <int DH>
struct Tile {
  static constexpr int kTM = DH <= 80 ? 8 : 4;         // rows a thread
  static constexpr int kTN = kTM;                      // keys a thread
  static constexpr int kLanes = kBK / kTN;             // key lanes of a row group
  static constexpr int kThreads = kGroups * kLanes;    // 128 or 256
  static constexpr int kBQ = kGroups * kTM;            // query rows a block: 128 or 64
  static constexpr int kCols = DH / kLanes;            // output columns a thread
  static_assert(DH % (4 * kLanes) == 0 || DH % (4 * kLanes) == kLanes ||
                    DH % (4 * kLanes) == 2 * kLanes,
                "dh 16, 32, 64, 80, 128 or 256");
  static constexpr int kPStride = kBQ + 4;             // P[key][row]
  static constexpr int kMinBlocks = DH <= 128 ? 2 : 1;
  static constexpr int kQ = 0;                         // Q[d][row], DH x kBQ
  static constexpr int kK = kQ + DH * kBQ;             // K[d][slot], DH x 64; then P
  static constexpr int kKFloats = DH * kBK > kBK * kPStride ? DH * kBK : kBK * kPStride;
  static constexpr int kV = kK + kKFloats;             // V[key][d], 64 x DH
  static constexpr int kFloats = kV + kBK * DH;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One 16-byte chunk of a row (8 bf16 or 4 fp32 elements) as fp32: a vector
// load where the tensors are 16-byte aligned, else element by element.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src, bool vec,
                                           float (&out)[16 / sizeof(T)]) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // bf16 -> fp32 is exact: the high half
        out[2 * e] = __uint_as_float(w[e] << 16);
        out[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = __uint_as_float(w[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = to_float(src[e]);
  }
}

// Stage 4 G rows (DH wide) of `src` transposed: dst[d * 4G + s] is slot s's
// element d.  Q (KEYS false): slot s is row s.  K (KEYS true, G = 16): lane
// j's key j + L (4 h + e) sits in slot 4 L h + 4 j + e, so a lane reads its
// keys as TN / 4 16-byte words and a quarter warp's words are adjacent.
// Rows >= valid read zero.
template <typename T, int DH, int G, bool KEYS>
__device__ __forceinline__ void stage_t(const T* __restrict__ src, float* dst, int valid,
                                        bool vec) {
  using L = Tile<DH>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DH / kVec;
  for (int u = threadIdx.x; u < G * kChunks; u += L::kThreads) {
    const int g = u % G;
    const int c = u / G;
    float val[4][kVec];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int slot = 4 * g + e;
      const int h = slot / (4 * L::kLanes);
      const int j = (slot % (4 * L::kLanes)) / 4;
      const int r = KEYS ? j + L::kLanes * (4 * h + e) : slot;
      if (r < valid) {
        load_chunk<T>(src + static_cast<long long>(r) * DH + c * kVec, vec, val[e]);
      } else {
#pragma unroll
        for (int x = 0; x < kVec; ++x) val[e][x] = 0.0f;
      }
    }
#pragma unroll
    for (int x = 0; x < kVec; ++x)
      *reinterpret_cast<float4*>(dst + (c * kVec + x) * (4 * G) + 4 * g) =
          make_float4(val[0][x], val[1][x], val[2][x], val[3][x]);
  }
}

// Stage 64 rows (DH wide) of `src` as fp32 rows of DH words.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, float* dst, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DH / kVec;
  for (int u = threadIdx.x; u < kBK * kChunks; u += Tile<DH>::kThreads) {
    float val[kVec];
    load_chunk<T>(src + u * kVec, vec, val);
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(dst + u * kVec + e) =
          make_float4(val[e], val[e + 1], val[e + 2], val[e + 3]);
  }
}

// Output column c (0 .. DH/L - 1) of key lane j: groups of four adjacent
// columns 4L apart, then the DH % 4L remainder (two or one columns a lane).
template <int DH>
__device__ __forceinline__ int out_col(int c, int j) {
  constexpr int kL = Tile<DH>::kLanes;
  constexpr int n4 = DH / (4 * kL);
  if (c < 4 * n4) return 4 * kL * (c / 4) + 4 * j + c % 4;
  if constexpr (DH % (4 * kL) == 2 * kL) return 4 * kL * n4 + 2 * j + (c - 4 * n4);
  return 4 * kL * n4 + j;
}

// Key lane j's columns of the V row `row`, in out_col's order.
template <int DH>
__device__ __forceinline__ void load_v(const float* row, int j,
                                       float (&vv)[Tile<DH>::kCols]) {
  constexpr int kL = Tile<DH>::kLanes;
  constexpr int n4 = DH / (4 * kL);
#pragma unroll
  for (int g = 0; g < n4; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(row + 4 * kL * g + 4 * j);
    vv[4 * g] = x.x;
    vv[4 * g + 1] = x.y;
    vv[4 * g + 2] = x.z;
    vv[4 * g + 3] = x.w;
  }
  if constexpr (DH % (4 * kL) == 2 * kL) {
    const float2 x = *reinterpret_cast<const float2*>(row + 4 * kL * n4 + 2 * j);
    vv[4 * n4] = x.x;
    vv[4 * n4 + 1] = x.y;
  } else if constexpr (DH % (4 * kL) == kL) {
    vv[4 * n4] = row[4 * kL * n4 + j];
  }
}

// Max and sum over the key lanes of a row group (xor L/2, ..., 1): every
// lane ends with the same value, each stage adding two values commutatively.
template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v = v + __shfl_xor_sync(kFullMask, v, off);
  return v;
}

template <typename T, int DH>
__global__ void __launch_bounds__(Tile<DH>::kThreads, Tile<DH>::kMinBlocks)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int B, int H, int group, int Sq, int Sk, float scale,
                 int causal, int window, int vec) {
  using L = Tile<DH>;
  constexpr int TM = L::kTM;
  constexpr int TN = L::kTN;
  constexpr int NL = L::kLanes;
  constexpr int BQ = L::kBQ;
  constexpr int NC = L::kCols;
  constexpr int PS = L::kPStride;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem + L::kQ;
  float* sK = smem + L::kK;
  float* sP = smem + L::kK;  // after the score loop
  float* sV = smem + L::kV;

  const int tid = threadIdx.x;
  const int j = tid % NL;   // key lane: keys j + NL a, output columns out_col(c, j)
  const int rg = tid / NL;  // row group: rows rg * TM .. rg * TM + TM - 1
  // (m, l) of row rg * TM + j % TM live in key lane j; lane row_lane + i of
  // the warp holds row i's
  const int row_lane = (tid & 31) & ~(NL - 1);
  // heaviest query tiles first (simt_block_tile in flash_attention.py)
  const int n_q = (Sq + BQ - 1) / BQ;
  const int hb_n = H * B;
  const int tile = n_q - 1 - static_cast<int>(blockIdx.x) / hb_n;
  const int hb = static_cast<int>(blockIdx.x) % hb_n;
  const int h = hb % H;
  const int b = hb / H;
  const int q0 = tile * BQ;
  const int rows = min(BQ, Sq - q0);
  const int hk = h / group;
  const int Hkv = H / group;

  const T* qt = q + ((static_cast<long long>(b) * H + h) * Sq + q0) * DH;
  const T* kh = k + (static_cast<long long>(b) * Hkv + hk) * Sk * DH;
  const T* vh = v + (static_cast<long long>(b) * Hkv + hk) * Sk * DH;
  T* ot = o + ((static_cast<long long>(b) * H + h) * Sq + q0) * DH;

  stage_t<T, DH, BQ / 4, false>(qt, sQ, rows, vec);

  float acc[TM][NC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  float m_own = -INFINITY, l_own = 0.0f;

  const int q_last = q0 + rows - 1;
  const int n_kv = Sk / kBK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    if (causal && k0 > q_last) break;                           // this and later tiles: all k > q
    if (window > 0 && q0 - (k0 + kBK - 1) >= window) continue;  // all q - k >= window
    __syncthreads();  // the previous tile's P and V readers are done
    stage_t<T, DH, kBK / 4, true>(kh + static_cast<long long>(k0) * DH, sK, kBK, vec);
    stage_rows<T, DH>(vh + static_cast<long long>(k0) * DH, sV, vec);
    __syncthreads();

    // scores: rows rg * TM + i, keys j + NL a; one chain over d each
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int a = 0; a < TN; ++a) s[i][a] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float x[TM], y[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 w = *reinterpret_cast<const float4*>(sQ + d * BQ + rg * TM + i);
        x[i] = w.x;
        x[i + 1] = w.y;
        x[i + 2] = w.z;
        x[i + 3] = w.w;
      }
#pragma unroll
      for (int a = 0; a < TN; a += 4) {
        const float4 w = *reinterpret_cast<const float4*>(sK + d * kBK + NL * a + 4 * j);
        y[a] = w.x;
        y[a + 1] = w.y;
        y[a + 2] = w.z;
        y[a + 3] = w.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int a = 0; a < TN; ++a) s[i][a] = fmaf(x[i], y[a], s[i][a]);
    }

    // online softmax in registers; s becomes p rounded to v's type
    const int rel0 = (q0 + rg * TM) - (k0 + j);  // row i, key a: rel0 + i - NL a
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = kMasked;
#pragma unroll
      for (int a = 0; a < TN; ++a) {
        const int rel = rel0 + i - NL * a;
        const bool keep = (!causal || rel >= 0) && (window <= 0 || rel < window);
        s[i][a] = keep ? s[i][a] * scale : kMasked;
        mx = fmaxf(mx, s[i][a]);
      }
      const float m_old = __shfl_sync(kFullMask, m_own, row_lane + i);
      const float l_old = __shfl_sync(kFullMask, l_own, row_lane + i);
      const float m_new = fmaxf(m_old, group_max<NL>(mx));
      float p[TN];
#pragma unroll
      for (int a = 0; a < TN; ++a) p[a] = expf(s[i][a] - m_new);
      // the row-sum tree: keys (j + NL a, j + NL a + 32), then the thread's
      // pairs 16, ..., NL lanes apart, then the lanes
      float t[TN / 2];
#pragma unroll
      for (int a = 0; a < TN / 2; ++a) t[a] = p[a] + p[a + TN / 2];
#pragma unroll
      for (int w = TN / 4; w >= 1; w /= 2)
#pragma unroll
        for (int a = 0; a < w; ++a) t[a] = t[a] + t[a + w];
      const float row_sum = group_sum<NL>(t[0]);
      const float corr = expf(m_old - m_new);
      const float l_new = l_old * corr + row_sum;
      if (j % TM == i) {
        m_own = m_new;
        l_own = l_new;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = acc[i][c] * corr;
#pragma unroll
      for (int a = 0; a < TN; ++a) s[i][a] = to_float(from_float<T>(p[a]));
    }
    __syncthreads();  // every thread is done reading K: P takes its place
#pragma unroll
    for (int a = 0; a < TN; ++a)
#pragma unroll
      for (int i = 0; i < TM; i += 4)
        *reinterpret_cast<float4*>(sP + (j + NL * a) * PS + rg * TM + i) =
            make_float4(s[i][a], s[i + 1][a], s[i + 2][a], s[i + 3][a]);
    __syncthreads();

    // pv: one chain over the tile's keys each; acc (already times corr) += pv
    float pv[TM][NC];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) pv[i][c] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float x[TM], vv[NC];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 w = *reinterpret_cast<const float4*>(sP + kk * PS + rg * TM + i);
        x[i] = w.x;
        x[i + 1] = w.y;
        x[i + 2] = w.z;
        x[i + 3] = w.w;
      }
      load_v<DH>(sV + kk * DH, j, vv);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) pv[i][c] = fmaf(x[i], vv[c], pv[i][c]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = acc[i][c] + pv[i][c];
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = rg * TM + i;
    const float denom = fmaxf(__shfl_sync(kFullMask, l_own, row_lane + i), 1e-30f);
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        ot[static_cast<long long>(r) * DH + out_col<DH>(c, j)] = from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int group,
                   int Sq, int Sk, float scale, int causal, int window, int vec,
                   cudaStream_t stream) {
  using L = Tile<DH>;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((Sq + L::kBQ - 1) / L::kBQ) * H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_kernel<T, DH><<<static_cast<unsigned>(blocks), L::kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), B, H, group, Sq, Sk, scale, causal, window, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o, int B, int H,
                      int group, int Sq, int Sk, int dh, float scale, int causal, int window,
                      int vec, cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, group, Sq, Sk, scale, causal, window, vec, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, group, Sq, Sk, scale, causal, window, vec, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, group, Sq, Sk, scale, causal, window, vec, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, B, H, group, Sq, Sk, scale, causal, window, vec, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, group, Sq, Sk, scale, causal, window, vec, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, group, Sq, Sk, scale, causal, window, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, H, Sq, dh); k, v: (B, Hkv, Sk, dh); contiguous device tensors of
// one type (dtype 0 = float32, 1 = bfloat16).  Sq and Sk multiples of 64, H a
// multiple of Hkv, dh one of 16, 32, 64, 80, 128, 256; window 0 means none.
// Launches on `stream`; returns the CUDA error code of the launch (0 on
// success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                     int H, int Hkv, int Sq, int Sk, int dh, float scale,
                                     int causal, int window, int dtype, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < kBK || Sq % kBK || Sk < kBK || Sk % kBK ||
      B > 65535 || H > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = H / Hkv;
  // 16-byte loads where q, k and v allow them (rows are 32 or 64 bytes wide)
  const int vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dh<float>(q, k, v, o, B, H, group, Sq, Sk, dh, scale, causal, window, vec, s);
  } else if (dtype == 1) {
    err = launch_dh<__nv_bfloat16>(q, k, v, o, B, H, group, Sq, Sk, dh, scale, causal, window,
                                   vec, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
