// Flash attention (GQA, causal / full, optional sliding window), written for
// Hopper (sm_90a).
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
// Design: one block of 256 threads per (query tile of 64 rows, head, batch).
// The block stages its Q tile and, for each kv tile of 64 keys, the K and V
// tiles in shared memory as fp32 (rows of Q and K padded by one word, so the
// column walks hit 32 distinct banks).  A thread owns a 4 x 4 block of the
// 64 x 64 score tile and a 4 x dh/16 block of the accumulator, both in
// registers, and runs its products as explicit fmaf; each warp then takes 8
// score rows for the row max, exp and sum (shuffles), writes p back to shared
// memory and one correction factor a row.  Kv tiles that the causal mask or
// the window masks for every row of the query tile are skipped: with a real
// score seen they change nothing, and every row sees its own key.
//
// Bound on this card: operations.  At the prefill shape (B=1, H=32, Hkv=8,
// S=4096, dh=128, causal) the work is 4 * H * dh * S(S+1)/2 = 137.5 GFLOP,
// 0.139 ms at the 989 TFLOP/s of the bf16 tensor cores, against 84 MB of
// q, k, v and o (0.025 ms at 3.35 TB/s).  This first kernel runs its
// products on the fp32 pipes (no wgmma, no TMA), with one block an SM for
// dh = 128, so it is far from that bound; a tensor-core redesign is later
// work.  Head dims 16, 32, 64, 80, 128 and 256 are built: dh = 80 is
// zamba2's (2560 / 32 heads), with 5 accumulator columns a thread and 79 KB
// of shared memory, less than dh = 128 takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
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
struct Layout {
  static constexpr int kQStride = DH + 1;
  static constexpr int kKStride = DH + 1;
  static constexpr int kVStride = DH;
  static constexpr int kPStride = kBK + 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kQStride;
  static constexpr int kV = kK + kBK * kKStride;
  static constexpr int kP = kV + kBK * kVStride;
  static constexpr int kM = kP + kBQ * kPStride;
  static constexpr int kL = kM + kBQ;
  static constexpr int kCorr = kL + kBQ;
  static constexpr int kFloats = kCorr + kBQ;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int group, int Sq, int Sk, float scale, int causal,
                 int window) {
  using L = Layout<DH>;
  constexpr int kCols = DH / 16;  // accumulator columns a thread owns
  extern __shared__ float smem[];
  float* sQ = smem + L::kQ;
  float* sK = smem + L::kK;
  float* sV = smem + L::kV;
  float* sP = smem + L::kP;
  float* sM = smem + L::kM;
  float* sL = smem + L::kL;
  float* sCorr = smem + L::kCorr;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows 4*ty .. 4*ty+3
  const int tx = tid & 15;  // columns tx, tx+16, ...
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int Hkv = H / group;

  const T* qt = q + ((static_cast<long long>(b) * H + h) * Sq + q0) * DH;
  const T* kh = k + (static_cast<long long>(b) * Hkv + hk) * Sk * DH;
  const T* vh = v + (static_cast<long long>(b) * Hkv + hk) * Sk * DH;
  T* ot = o + ((static_cast<long long>(b) * H + h) * Sq + q0) * DH;

  stage<T, DH>(qt, sQ, kBQ, L::kQStride);
  if (tid < kBQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.0f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  const int n_kv = Sk / kBK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    if (causal && k0 > q0 + kBQ - 1) break;                // this and later tiles: all k > q
    if (window > 0 && q0 - (k0 + kBK - 1) >= window) continue;  // all q - k >= window
    __syncthreads();  // the previous tile's readers are done
    stage<T, DH>(kh + static_cast<long long>(k0) * DH, sK, kBK, L::kKStride);
    stage<T, DH>(vh + static_cast<long long>(k0) * DH, sV, kBK, L::kVStride);
    __syncthreads();

    // scores: rows 4*ty+i, keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(4 * ty + i) * L::kQStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * L::kKStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int rel = (q0 + r) - (k0 + c);
        const bool keep = (!causal || rel >= 0) && (window <= 0 || rel < window);
        sP[r * L::kPStride + c] = keep ? s[i][j] * scale : kMasked;
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows 8w .. 8w+7, two keys a lane
#pragma unroll
    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      float* prow = sP + r * L::kPStride;
      const float s0 = prow[lane];
      const float s1 = prow[lane + 32];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float row_sum = warp_sum(p0 + p1);
      prow[lane] = to_float(from_float<T>(p0));
      prow[lane + 32] = to_float(from_float<T>(p1));
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sL[r] = sL[r] * corr + row_sum;
        sM[r] = m_new;
        sCorr[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v
    float pv[4][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) pv[i][j] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(4 * ty + i) * L::kPStride + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = sV[kk * L::kVStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) pv[i][j] = fmaf(p[i], vv[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sCorr[4 * ty + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = acc[i][j] * corr + pv[i][j];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const float denom = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) ot[r * DH + tx + 16 * j] = from_float<T>(acc[i][j] / denom);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int group,
                   int Sq, int Sk, float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = Layout<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(Sq / kBQ, H, B);
  flash_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, group, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o, int B, int H,
                      int group, int Sq, int Sk, int dh, float scale, int causal, int window,
                      cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, group, Sq, Sk, scale, causal, window, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, group, Sq, Sk, scale, causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, group, Sq, Sk, scale, causal, window, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, B, H, group, Sq, Sk, scale, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, group, Sq, Sk, scale, causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, group, Sq, Sk, scale, causal, window, stream);
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
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < kBQ || Sq % kBQ || Sk < kBK || Sk % kBK ||
      B > 65535 || H > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = H / Hkv;
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dh<float>(q, k, v, o, B, H, group, Sq, Sk, dh, scale, causal, window, s);
  } else if (dtype == 1) {
    err = launch_dh<__nv_bfloat16>(q, k, v, o, B, H, group, Sq, Sk, dh, scale, causal, window, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
