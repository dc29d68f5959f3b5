// Selective scan (Mamba2 recurrence), written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py:_ssm_kernel
// (launched by ssm_scan):
//
//   h_t = exp(a_t) * h_{t-1} + dt_t * (x_t outer B_t),   y_t = h_t . C_t
//
// with x and y (B, H, S, P), a and dt (B, H, S), B and C (B, S, N) shared by
// every head; the state (P, N) of each (batch, head) is fp32 from zero and y
// is fp32.  x, B and C are fp32 or bf16 (read as fp32, which is exact); a and
// dt are fp32.  Each step rounds as the Pallas body does in fp32: exp(a) * h
// and dt * (x * B) each rounded, then their sum (built with --fmad=false, so
// no multiply-add is contracted).
//
// Design.  The Pallas grid is one program per (batch, head) with a (P, N)
// state in VMEM: 80 programs at the zamba2 prefill shape, far too few for 132
// SMs.  But row h[p, :] of the state depends on x[p] alone, so the rows are
// independent recurrences: here one warp owns one row, and lane l keeps the
// state entries n = l, l + 32, ... (N / 32 of them, at most 8) in registers;
// lanes past N hold zeros.  A block of kWarps warps takes kWarps consecutive
// rows of one (batch, head): grid (ceil(P / kWarps), H, B), 5,120 warps at
// (1, 80, 4096, 64).  The block walks the sequence in tiles of kSteps steps;
// for each tile its threads stage exp(a), dt, the B and C rows (zero-padded
// to 32 * K entries) and the x values of its rows in shared memory, every
// warp runs the tile's steps from there, and the tile's y values go back
// through shared memory so that each step's rows are written side by side.
// The dot h . C is summed by each lane over its entries in order and then
// over the lanes with an xor butterfly of __shfl_xor_sync; the plain PyTorch
// version (ssm_scan_plain in ssm_scan.py) sums in that order.
//
// Bound on this card: operations.  A step costs 6 fp32 operations per state
// entry (two products and a sum for the update, one more product, the dot's
// product and sum), 6 * B * H * S * P * N = 8.05 GFLOP at (1, 80, 4096, 64)
// with N = 64: 0.12 ms at the 67 TFLOP/s of the fp32 pipes, against ~130 MB
// of bf16 x, fp32 a, dt and y, and bf16 B and C (0.04 ms at 3.35 TB/s).  This
// first kernel spends a 5-shuffle butterfly per row and step on two entries a
// lane, so it is far from that bound; packing several rows into a warp is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWarps = 8;  // rows of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 32;  // steps of a staged tile
constexpr int kMaxK = 8;    // N <= 32 * kMaxK
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float butterfly_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Shared memory of a block, in floats: exp(a) and dt of the tile's steps,
// its B and C rows (32 * K wide), and its rows' x and y values.
template <int K>
struct Layout {
  static constexpr int kN = 32 * K;
  static constexpr int kE = 0;
  static constexpr int kD = kE + kSteps;
  static constexpr int kB = kD + kSteps;
  static constexpr int kC = kB + kSteps * kN;
  static constexpr int kX = kC + kSteps * kN;
  static constexpr int kY = kX + kSteps * kWarps;
  static constexpr int kFloats = kY + kSteps * kWarps;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ dt, const T* __restrict__ bm,
                    const T* __restrict__ cm, float* __restrict__ y, int H, int S, int P,
                    int N) {
  using L = Layout<K>;
  extern __shared__ float smem[];
  float* sE = smem + L::kE;
  float* sD = smem + L::kD;
  float* sB = smem + L::kB;
  float* sC = smem + L::kC;
  float* sX = smem + L::kX;
  float* sY = smem + L::kY;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * kWarps;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool active = p0 + warp < P;
  const int rows = min(kWarps, P - p0);

  const long long bh = static_cast<long long>(b) * H + h;
  const T* xh = x + bh * S * P;
  const float* ah = a + bh * S;
  const float* dth = dt + bh * S;
  const T* bb = bm + static_cast<long long>(b) * S * N;
  const T* cb = cm + static_cast<long long>(b) * S * N;
  float* yh = y + bh * S * P;

  float st[K];
#pragma unroll
  for (int j = 0; j < K; ++j) st[j] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int steps = min(kSteps, S - t0);
    __syncthreads();  // the previous tile's readers and y writers are done
    for (int i = tid; i < steps; i += kThreads) {
      sE[i] = expf(ah[t0 + i]);
      sD[i] = dth[t0 + i];
    }
    for (int idx = tid; idx < steps * L::kN; idx += kThreads) {
      const int i = idx / L::kN;
      const int n = idx - i * L::kN;
      const long long src = static_cast<long long>(t0 + i) * N + n;
      sB[idx] = n < N ? to_float(bb[src]) : 0.0f;
      sC[idx] = n < N ? to_float(cb[src]) : 0.0f;
    }
    for (int idx = tid; idx < steps * kWarps; idx += kThreads) {
      const int i = idx / kWarps;
      const int w = idx - i * kWarps;
      sX[idx] = w < rows ? to_float(xh[static_cast<long long>(t0 + i) * P + p0 + w]) : 0.0f;
    }
    __syncthreads();

    if (active) {
      for (int i = 0; i < steps; ++i) {
        const float e = sE[i];
        const float d = sD[i];
        const float xv = sX[i * kWarps + warp];
        const float* brow = sB + i * L::kN;
        const float* crow = sC + i * L::kN;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int n = lane + 32 * j;
          st[j] = e * st[j] + d * (xv * brow[n]);
          const float prod = st[j] * crow[n];
          acc = j == 0 ? prod : acc + prod;
        }
        acc = butterfly_sum(acc);
        if (lane == 0) sY[i * kWarps + warp] = acc;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < steps * kWarps; idx += kThreads) {
      const int i = idx / kWarps;
      const int w = idx - i * kWarps;
      if (w < rows) yh[static_cast<long long>(t0 + i) * P + p0 + w] = sY[idx];
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* a, const void* dt, const void* bm, const void* cm,
                   void* y, int B, int H, int S, int P, int N, cudaStream_t stream) {
  constexpr size_t bytes = Layout<K>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kWarps - 1) / kWarps, H, B);
  ssm_scan_kernel<T, K><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<float*>(y), H, S, P, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* x, const void* a, const void* dt, const void* bm, const void* cm,
                     void* y, int B, int H, int S, int P, int N, cudaStream_t stream) {
  switch ((N + 31) / 32) {
    case 1:
      return launch<T, 1>(x, a, dt, bm, cm, y, B, H, S, P, N, stream);
    case 2:
      return launch<T, 2>(x, a, dt, bm, cm, y, B, H, S, P, N, stream);
    case 3:
      return launch<T, 3>(x, a, dt, bm, cm, y, B, H, S, P, N, stream);
    case 4:
      return launch<T, 4>(x, a, dt, bm, cm, y, B, H, S, P, N, stream);
    case 5:
      return launch<T, 5>(x, a, dt, bm, cm, y, B, H, S, P, N, stream);
    case 6:
      return launch<T, 6>(x, a, dt, bm, cm, y, B, H, S, P, N, stream);
    case 7:
      return launch<T, 7>(x, a, dt, bm, cm, y, B, H, S, P, N, stream);
    case kMaxK:
      return launch<T, kMaxK>(x, a, dt, bm, cm, y, B, H, S, P, N, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (B, H, S, P) and bm, cm: (B, S, N), contiguous, of one type (dtype 0 =
// float32, 1 = bfloat16); a, dt: (B, H, S) contiguous float32; y: (B, H, S,
// P) float32.  1 <= N <= 256, 1 <= B, H <= 65535, S, P >= 1.  Launches on
// `stream`; returns the CUDA error code of the launch (0 on success).
extern "C" int repro_ssm_scan(const void* x, const void* a, const void* dt, const void* bm,
                              const void* cm, void* y, int B, int H, int S, int P, int N,
                              int dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1 || P < 1 || N < 1 || N > 32 * kMaxK || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_k<float>(x, a, dt, bm, cm, y, B, H, S, P, N, s);
  } else if (dtype == 1) {
    err = launch_k<__nv_bfloat16>(x, a, dt, bm, cm, y, B, H, S, P, N, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
