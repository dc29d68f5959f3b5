// Flash attention backward (GQA, causal / full, optional sliding window),
// written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference trains through plain jnp: the
// gradient of its attention is XLA's autodiff of models/attention.py
// (blocked_attend), and src/repro/ has no custom_vjp.  The port's forward is
// a hand-written kernel (flash_attention.cu, flash_attention_tc.cu) called
// through ctypes, which autograd cannot see through; this kernel is the
// backward of that forward, so that training on the card runs no plain
// version.
//
// Layout as the forward's: q, o, do, dq (B, H, Sq, dh); k, v, dk, dv
// (B, Hkv, Sk, dh); query head h reads kv head h / (H / Hkv).  With s =
// scale * q.k (masked to -1e30), the forward's row max m and sum l, and the
// saved output o:
//   p  = exp(s - m) / max(l, 1e-30)        (masked pairs give exactly 0)
//   D  = rowsum(do * o)
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - D) * scale
//   dk = ds^T q,  dq = ds k
// all in fp32 from the inputs' values (bf16 products are exact in fp32), the
// results rounded once to the inputs' type.  The forward rounds p to v's type
// before the PV product; the backward takes that rounding as the identity,
// as autodiff of the reference does.
//
// Three kernels, FA2's split, none with atomics, so the result is the same
// from run to run:
//   1. bwd_stats, a block per (query tile, head, batch): m and l again from q
//      and k, online over the kv tiles the forward visits, and D; written to
//      an fp32 scratch (m, 1 / max(l, 1e-30), D), three (B, H, Sq) planes;
//   2. bwd_dkdv, a block per (kv tile, kv head, batch): loops over the
//      group's query heads and their query tiles that see the kv tile, and
//      accumulates dk and dv in registers (the group's heads summed inside
//      the block);
//   3. bwd_dq, a block per (query tile, head, batch): loops over the kv
//      tiles and accumulates dq.
// Tiles that the causal mask or the window drop for every pair are skipped,
// as the forward skips them.
//
// Design: 256 threads a block; tiles of kT = 64 rows (32 at dh = 256, where
// four 64-row fp32 tiles would not fit in shared memory).  The block stages
// its tiles of q, do, k and v in shared memory as fp32 (rows padded by one
// word); thread (ty, tx) owns kT/16 x kT/16 entries of the score tile (rows
// kR*ty + i, columns tx + 16 j) and kT/16 rows x dh/16 columns of each
// accumulator, and runs its products as explicit fmaf.  p and ds go through
// shared memory between the score products and the accumulating ones.
//
// Bound on this card: operations.  At the training shape (B=1, H=32,
// Hkv=8, S=4096, dh=128, causal) the backward needs the score products
// twice (dk/dv and dq passes) besides the stats pass: 2 * dh FLOP a kept
// query/key pair for each of s (3 times), dp (twice), dv, dk and dq, 16 * dh
// in all, 0.55 TFLOP, 0.56 ms at the 989 TFLOP/s of the bf16 tensor cores;
// FA2's own 10 * dh (s and dp once each) would be 0.34 ms.  This first
// kernel runs on the fp32 pipes with no tensor cores and one block an SM at
// dh = 128; a wgmma/TMA redesign is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(kFullMask, v, off);
  return v;
}

template <int DH>
struct Tile {
  static constexpr int kT = DH > 128 ? 32 : 64;  // rows of a q or kv tile
  static constexpr int kR = kT / 16;              // score rows (and columns) a thread owns
  static constexpr int kCols = DH / 16;           // accumulator columns a thread owns
  static constexpr int kLS = DH + 1;              // stride of a staged q/do/k/v row
  static constexpr int kPS = kT + 1;              // stride of a p/ds row
  static constexpr int kTile = kT * kLS;
  static constexpr int kScores = kT * kPS;
};

// Stage a (rows x DH) tile of `src` (row-major, DH wide) as fp32 rows of
// `stride` words.
template <typename T, int DH>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst, int rows, int stride) {
  for (int idx = threadIdx.x; idx < rows * DH; idx += kThreads) {
    const int r = idx / DH;
    const int c = idx - r * DH;
    dst[r * stride + c] = to_float(src[idx]);
  }
}

__device__ __forceinline__ bool kept(int rel, int causal, int window) {
  return (!causal || rel >= 0) && (window <= 0 || rel < window);
}

// Dot products of the thread's kR x kR entries: a's rows kR*ty+i against b's
// rows tx+16j, over DH.
template <int DH>
__device__ __forceinline__ void tile_dots(const float* a, const float* b, float (&out)[Tile<DH>::kR][Tile<DH>::kR],
                                          int ty, int tx) {
  using L = Tile<DH>;
#pragma unroll
  for (int i = 0; i < L::kR; ++i)
#pragma unroll
    for (int j = 0; j < L::kR; ++j) out[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float av[L::kR], bv[L::kR];
#pragma unroll
    for (int i = 0; i < L::kR; ++i) av[i] = a[(L::kR * ty + i) * L::kLS + d];
#pragma unroll
    for (int j = 0; j < L::kR; ++j) bv[j] = b[(tx + 16 * j) * L::kLS + d];
#pragma unroll
    for (int i = 0; i < L::kR; ++i)
#pragma unroll
      for (int j = 0; j < L::kR; ++j) out[i][j] = fmaf(av[i], bv[j], out[i][j]);
  }
}

// p and ds of the thread's entries (query rows kR*ty+i of the tile at q0,
// keys tx+16j of the tile at k0) into sP (if given) and sDS.
template <int DH>
__device__ __forceinline__ void probs(const float (&s)[Tile<DH>::kR][Tile<DH>::kR],
                                      const float (&dp)[Tile<DH>::kR][Tile<DH>::kR],
                                      const float* sM, const float* sLinv, const float* sD,
                                      float* sP, float* sDS, int q0, int k0, float scale,
                                      int causal, int window, int ty, int tx) {
  using L = Tile<DH>;
#pragma unroll
  for (int i = 0; i < L::kR; ++i) {
    const int r = L::kR * ty + i;
#pragma unroll
    for (int j = 0; j < L::kR; ++j) {
      const int c = tx + 16 * j;
      const float sc = kept((q0 + r) - (k0 + c), causal, window) ? s[i][j] * scale : kMasked;
      const float p = expf(sc - sM[r]) * sLinv[r];
      if (sP != nullptr) sP[r * L::kPS + c] = p;
      sDS[r * L::kPS + c] = p * (dp[i][j] - sD[r]) * scale;
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    bwd_stats(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
              const T* __restrict__ dout, float* __restrict__ ws, int B, int H, int group, int Sq,
              int Sk, float scale, int causal, int window) {
  using L = Tile<DH>;
  constexpr int kT = L::kT;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + L::kTile;
  float* sS = sK + L::kTile;
  float* sM = sS + L::kScores;
  float* sL = sM + kT;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Hkv = H / group;
  const long long row0 = (static_cast<long long>(b) * H + h) * Sq + q0;
  const T* kh = k + (static_cast<long long>(b) * Hkv + h / group) * Sk * DH;

  stage<T, DH>(q + row0 * DH, sQ, kT, L::kLS);
  if (tid < kT) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.0f;
  }
  for (int kt = 0; kt < Sk / kT; ++kt) {
    const int k0 = kt * kT;
    if (causal && k0 > q0 + kT - 1) break;
    if (window > 0 && q0 - (k0 + kT - 1) >= window) continue;
    __syncthreads();
    stage<T, DH>(kh + static_cast<long long>(k0) * DH, sK, kT, L::kLS);
    __syncthreads();
    float s[L::kR][L::kR];
    tile_dots<DH>(sQ, sK, s, ty, tx);
#pragma unroll
    for (int i = 0; i < L::kR; ++i) {
      const int r = L::kR * ty + i;
#pragma unroll
      for (int j = 0; j < L::kR; ++j) {
        const int c = tx + 16 * j;
        sS[r * L::kPS + c] = kept((q0 + r) - (k0 + c), causal, window) ? s[i][j] * scale : kMasked;
      }
    }
    __syncthreads();
    // online (m, l): warp w takes rows w * kT/8 .., kT/32 keys a lane
    for (int rr = 0; rr < kT / kWarps; ++rr) {
      const int r = warp * (kT / kWarps) + rr;
      const float* srow = sS + r * L::kPS;
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kT / 32; ++u) mx = fmaxf(mx, srow[lane + 32 * u]);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float part = 0.0f;
#pragma unroll
      for (int u = 0; u < kT / 32; ++u) part = part + expf(srow[lane + 32 * u] - m_new);
      const float row_sum = warp_sum(part);
      if (lane == 0) {
        sL[r] = sL[r] * expf(m_old - m_new) + row_sum;
        sM[r] = m_new;
      }
    }
  }
  __syncthreads();
  const long long plane = static_cast<long long>(B) * H * Sq;
  if (tid < kT) {
    ws[row0 + tid] = sM[tid];
    ws[plane + row0 + tid] = 1.0f / fmaxf(sL[tid], 1e-30f);
  }
  // D = rowsum(do * o): warp w takes rows w * kT/8 ..
  for (int rr = 0; rr < kT / kWarps; ++rr) {
    const long long row = row0 + warp * (kT / kWarps) + rr;
    float acc = 0.0f;
    for (int c = lane; c < DH; c += 32) acc = fmaf(to_float(dout[row * DH + c]), to_float(o[row * DH + c]), acc);
    acc = warp_sum(acc);
    if (lane == 0) ws[2 * plane + row] = acc;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ ws, T* __restrict__ dk,
             T* __restrict__ dv, int B, int H, int group, int Sq, int Sk, float scale, int causal,
             int window) {
  using L = Tile<DH>;
  constexpr int kT = L::kT;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + L::kTile;
  float* sQ = sV + L::kTile;
  float* sDO = sQ + L::kTile;
  float* sP = sDO + L::kTile;
  float* sDS = sP + L::kScores;
  float* sM = sDS + L::kScores;
  float* sLinv = sM + kT;
  float* sD = sLinv + kT;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int k0 = blockIdx.x * kT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int Hkv = H / group;
  const long long kv0 = (static_cast<long long>(b) * Hkv + hk) * Sk + k0;
  const long long plane = static_cast<long long>(B) * H * Sq;

  stage<T, DH>(k + kv0 * DH, sK, kT, L::kLS);
  stage<T, DH>(v + kv0 * DH, sV, kT, L::kLS);

  float acc_dk[L::kR][L::kCols], acc_dv[L::kR][L::kCols];
#pragma unroll
  for (int i = 0; i < L::kR; ++i)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.0f;

  const int first = causal ? k0 / kT : 0;  // earlier query tiles: every q < k
  for (int j = 0; j < group; ++j) {
    const int h = hk * group + j;
    for (int qt = first; qt < Sq / kT; ++qt) {
      const int q0 = qt * kT;
      if (window > 0 && q0 - (k0 + kT - 1) >= window) break;  // this and later: q - k >= window
      const long long row0 = (static_cast<long long>(b) * H + h) * Sq + q0;
      __syncthreads();  // the previous tile's readers are done
      stage<T, DH>(q + row0 * DH, sQ, kT, L::kLS);
      stage<T, DH>(dout + row0 * DH, sDO, kT, L::kLS);
      if (tid < kT) {
        sM[tid] = ws[row0 + tid];
        sLinv[tid] = ws[plane + row0 + tid];
        sD[tid] = ws[2 * plane + row0 + tid];
      }
      __syncthreads();
      float s[L::kR][L::kR], dp[L::kR][L::kR];
      tile_dots<DH>(sQ, sK, s, ty, tx);
      tile_dots<DH>(sDO, sV, dp, ty, tx);
      probs<DH>(s, dp, sM, sLinv, sD, sP, sDS, q0, k0, scale, causal, window, ty, tx);
      __syncthreads();
      // dv[key] += p[q][key] do[q]; dk[key] += ds[q][key] q[q]: keys kR*ty+i
#pragma unroll 2
      for (int qq = 0; qq < kT; ++qq) {
        float pk[L::kR], dsk[L::kR], dov[L::kCols], qv[L::kCols];
#pragma unroll
        for (int i = 0; i < L::kR; ++i) {
          pk[i] = sP[qq * L::kPS + L::kR * ty + i];
          dsk[i] = sDS[qq * L::kPS + L::kR * ty + i];
        }
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) {
          dov[c] = sDO[qq * L::kLS + tx + 16 * c];
          qv[c] = sQ[qq * L::kLS + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < L::kR; ++i)
#pragma unroll
          for (int c = 0; c < L::kCols; ++c) {
            acc_dv[i][c] = fmaf(pk[i], dov[c], acc_dv[i][c]);
            acc_dk[i][c] = fmaf(dsk[i], qv[c], acc_dk[i][c]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < L::kR; ++i) {
    const long long row = kv0 + L::kR * ty + i;
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) {
      dk[row * DH + tx + 16 * c] = from_float<T>(acc_dk[i][c]);
      dv[row * DH + tx + 16 * c] = from_float<T>(acc_dv[i][c]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ ws, T* __restrict__ dq, int B,
           int H, int group, int Sq, int Sk, float scale, int causal, int window) {
  using L = Tile<DH>;
  constexpr int kT = L::kT;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + L::kTile;
  float* sK = sDO + L::kTile;
  float* sV = sK + L::kTile;
  float* sDS = sV + L::kTile;
  float* sM = sDS + L::kScores;
  float* sLinv = sM + kT;
  float* sD = sLinv + kT;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Hkv = H / group;
  const long long row0 = (static_cast<long long>(b) * H + h) * Sq + q0;
  const long long plane = static_cast<long long>(B) * H * Sq;
  const long long kvh = (static_cast<long long>(b) * Hkv + h / group) * Sk;

  stage<T, DH>(q + row0 * DH, sQ, kT, L::kLS);
  stage<T, DH>(dout + row0 * DH, sDO, kT, L::kLS);
  if (tid < kT) {
    sM[tid] = ws[row0 + tid];
    sLinv[tid] = ws[plane + row0 + tid];
    sD[tid] = ws[2 * plane + row0 + tid];
  }
  float acc[L::kR][L::kCols];
#pragma unroll
  for (int i = 0; i < L::kR; ++i)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[i][c] = 0.0f;

  for (int kt = 0; kt < Sk / kT; ++kt) {
    const int k0 = kt * kT;
    if (causal && k0 > q0 + kT - 1) break;
    if (window > 0 && q0 - (k0 + kT - 1) >= window) continue;
    __syncthreads();
    stage<T, DH>(k + (kvh + k0) * DH, sK, kT, L::kLS);
    stage<T, DH>(v + (kvh + k0) * DH, sV, kT, L::kLS);
    __syncthreads();
    float s[L::kR][L::kR], dp[L::kR][L::kR];
    tile_dots<DH>(sQ, sK, s, ty, tx);
    tile_dots<DH>(sDO, sV, dp, ty, tx);
    probs<DH>(s, dp, sM, sLinv, sD, nullptr, sDS, q0, k0, scale, causal, window, ty, tx);
    __syncthreads();
    // dq[q] += ds[q][key] k[key]: query rows kR*ty+i
#pragma unroll 2
    for (int kk = 0; kk < kT; ++kk) {
      float dsq[L::kR], kv[L::kCols];
#pragma unroll
      for (int i = 0; i < L::kR; ++i) dsq[i] = sDS[(L::kR * ty + i) * L::kPS + kk];
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) kv[c] = sK[kk * L::kLS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < L::kR; ++i)
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) acc[i][c] = fmaf(dsq[i], kv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < L::kR; ++i) {
    const long long row = row0 + L::kR * ty + i;
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) dq[row * DH + tx + 16 * c] = from_float<T>(acc[i][c]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   void* dq, void* dk, void* dv, float* ws, int B, int H, int group, int Sq,
                   int Sk, float scale, int causal, int window, cudaStream_t stream) {
  using L = Tile<DH>;
  constexpr int kT = L::kT;
  const int Hkv = H / group;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  constexpr size_t stats_bytes = sizeof(float) * (2 * L::kTile + L::kScores + 2 * kT);
  constexpr size_t dkdv_bytes = sizeof(float) * (4 * L::kTile + 2 * L::kScores + 3 * kT);
  constexpr size_t dq_bytes = sizeof(float) * (4 * L::kTile + L::kScores + 3 * kT);
  cudaError_t err = allow_smem(bwd_stats<T, DH>, stats_bytes);
  if (err == cudaSuccess) err = allow_smem(bwd_dkdv<T, DH>, dkdv_bytes);
  if (err == cudaSuccess) err = allow_smem(bwd_dq<T, DH>, dq_bytes);
  if (err != cudaSuccess) return err;
  bwd_stats<T, DH><<<dim3(Sq / kT, H, B), kThreads, stats_bytes, stream>>>(
      qt, kt, static_cast<const T*>(o), dot, ws, B, H, group, Sq, Sk, scale, causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dkdv<T, DH><<<dim3(Sk / kT, Hkv, B), kThreads, dkdv_bytes, stream>>>(
      qt, kt, vt, dot, ws, static_cast<T*>(dk), static_cast<T*>(dv), B, H, group, Sq, Sk, scale,
      causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dq<T, DH><<<dim3(Sq / kT, H, B), kThreads, dq_bytes, stream>>>(
      qt, kt, vt, dot, ws, static_cast<T*>(dq), B, H, group, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, void* dq, void* dk, void* dv, float* ws, int B, int H,
                      int group, int Sq, int Sk, int dh, float scale, int causal, int window,
                      cudaStream_t s) {
#define REPRO_BWD_CASE(D)                                                                     \
  case D:                                                                                     \
    return launch<T, D>(q, k, v, o, dout, dq, dk, dv, ws, B, H, group, Sq, Sk, scale, causal, \
                        window, s);
  switch (dh) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(80)
    REPRO_BWD_CASE(128)
    REPRO_BWD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_CASE
}

}  // namespace

// q, o, do, dq: (B, H, Sq, dh); k, v, dk, dv: (B, Hkv, Sk, dh); contiguous
// device tensors of one type (dtype 0 = float32, 1 = bfloat16); ws: fp32
// scratch of 3 * B * H * Sq.  Sq and Sk multiples of 64, H a multiple of
// Hkv, dh one of 16, 32, 64, 80, 128, 256; window 0 means none.  Launches
// three kernels on `stream`; returns the CUDA error code of the launches (0
// on success).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, void* dq, void* dk,
                                         void* dv, void* ws, int B, int H, int Hkv, int Sq,
                                         int Sk, int dh, float scale, int causal, int window,
                                         int dtype, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 64 || Sq % 64 || Sk < 64 || Sk % 64 ||
      B > 65535 || H > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = H / Hkv;
  float* w = static_cast<float*>(ws);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dh<float>(q, k, v, o, dout, dq, dk, dv, w, B, H, group, Sq, Sk, dh, scale,
                           causal, window, s);
  } else if (dtype == 1) {
    err = launch_dh<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, w, B, H, group, Sq, Sk, dh,
                                   scale, causal, window, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
