// RMSNorm backward, written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference trains through plain jnp: the
// gradient of its layer norm is XLA's autodiff of models/layers.py:38
// (rmsnorm), and src/repro/ has no custom_vjp.  The port's forward is the
// hand-written kernel of rmsnorm.cu, called through ctypes, which autograd
// cannot see through; this kernel is the backward of that forward, so that
// training on the card runs no plain version.
//
// With r = 1 / sqrt(mean(x^2) + eps) recomputed from x in the forward
// kernel's sum-of-squares order, xh = x * r and g = dy * gamma (fp32):
//   dx     = r * (g - xh * mean(g * xh))          in x's type;
//   dgamma = sum over rows of dy * y0             in fp32, then gamma's type,
// where y0 is the forward's x * r rounded to x's type in the model layer's
// form (LAYER, y = round(x * r) * gamma) and unrounded in the Pallas form.
// The rounding of the forward's output counts as the identity, as autodiff
// of the reference takes it.
//
// Bound on this card: bytes.  x and dy are read and dx written once (6 bytes
// a bf16 element), against ~12 fp32 operations an element: at the training
// shape (4096 rows of 4096, bf16) 100.7 MB, 30 us at 3.35 TB/s.
//
// Design: a block of kThreads threads walks kRows rows (rmsnorm.py:BWD_ROWS),
// one after another.  A row is cut into chunks of 16 bytes as in the forward
// kernel, thread t holding chunks t, t + kThreads, ...; each row sum (the
// squares, then g * xh) runs in the forward's fixed order: the thread's
// elements chunk by chunk, a warp butterfly, the warps' partials through one
// more (rmsnorm.py:_row_sum spells it).  Every column belongs to the same
// thread in every row, so the thread adds its columns' dy * y0 into the
// block's row of the fp32 scratch `part` (rows / kRows, d) with plain loads
// and stores: no atomics, and the sum over the block's rows runs in row
// order.  A second kernel sums the blocks' rows in block order, one thread a
// column.  Both sums run in a fixed order, so the result is the same from
// run to run, and the plain version (rmsnorm_bwd_plain) follows it.  The
// row is read from memory three times (squares, dot, output); the second
// and third reads hit the caches.  Holding the row in registers, as the
// forward's vector path does, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // rows a block walks: rmsnorm.py:BWD_ROWS
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

__device__ __forceinline__ float butterfly_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// The block's sum of each thread's partial, in the forward's order; every
// thread gets it.  `partial` must not be written again before every thread
// has returned from this call.
__device__ __forceinline__ float block_sum(float acc, float* partial) {
  const int lane = threadIdx.x & 31;
  acc = butterfly_sum(acc);
  if (lane == 0) partial[threadIdx.x >> 5] = acc;
  __syncthreads();
  return butterfly_sum(lane < kWarps ? partial[lane] : 0.0f);
}

template <typename T, bool LAYER>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ gamma,
                     const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                     long long rows, int d, float inv_d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  // two buffers: the dot's partials are written while a slow warp may still
  // read the squares'; a row's squares are written only after the previous
  // row's dot barrier, which every thread passes after reading them
  __shared__ float partial[2][kWarps];
  const int t = threadIdx.x;
  float* prow = part + static_cast<long long>(blockIdx.x) * d;
  for (int rr = 0; rr < kRows; ++rr) {
    const long long row = static_cast<long long>(blockIdx.x) * kRows + rr;
    if (row >= rows) break;  // the same for every thread of the block
    const T* xr = x + row * d;
    const T* dyr = dy + row * d;
    T* dxr = dx + row * d;

    float ss = 0.0f;
    for (int c = t * kVec; c < d; c += kThreads * kVec) {
      const int end = c + kVec < d ? c + kVec : d;
      for (int i = c; i < end; ++i) {
        const float v = to_float(xr[i]);
        ss = ss + v * v;
      }
    }
    const float r = 1.0f / sqrtf(block_sum(ss, partial[0]) * inv_d + eps);

    float dot = 0.0f;
    for (int c = t * kVec; c < d; c += kThreads * kVec) {
      const int end = c + kVec < d ? c + kVec : d;
      for (int i = c; i < end; ++i) {
        const float xh = to_float(xr[i]) * r;
        const float g = to_float(dyr[i]) * to_float(gamma[i]);
        dot = dot + g * xh;
      }
    }
    const float mean = block_sum(dot, partial[1]) * inv_d;

    for (int c = t * kVec; c < d; c += kThreads * kVec) {
      const int end = c + kVec < d ? c + kVec : d;
      for (int i = c; i < end; ++i) {
        const float xh = to_float(xr[i]) * r;
        const float dyv = to_float(dyr[i]);
        const float g = dyv * to_float(gamma[i]);
        dxr[i] = from_float<T>(r * (g - xh * mean));
        const float y0 = LAYER ? to_float(from_float<T>(xh)) : xh;
        const float contrib = dyv * y0;
        prow[i] = rr == 0 ? contrib : prow[i] + contrib;
      }
    }
  }
}

// dgamma[c] = part[0][c] + part[1][c] + ... in block order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_dgamma(const float* __restrict__ part, T* __restrict__ dgamma, int blocks,
                       int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float acc = part[c];
  for (int b = 1; b < blocks; ++b) acc = acc + part[static_cast<long long>(b) * d + c];
  dgamma[c] = from_float<T>(acc);
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* dy, void* dx, void* dgamma,
                   float* part, long long rows, int d, float inv_d, float eps, int layer,
                   cudaStream_t stream) {
  const long long blocks = (rows + kRows - 1) / kRows;
  if (layer) {
    rmsnorm_bwd_rows<T, true><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(dy),
        static_cast<T*>(dx), part, rows, d, inv_d, eps);
  } else {
    rmsnorm_bwd_rows<T, false><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(dy),
        static_cast<T*>(dx), part, rows, d, inv_d, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dgamma<T><<<(d + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, static_cast<T*>(dgamma), static_cast<int>(blocks), d);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: (rows, d); gamma, dgamma: (d,); contiguous device tensors of one
// type (dtype 0 = float32, 1 = bfloat16).  part: fp32 scratch of
// ceil(rows / 16) x d.  layer != 0: the model layer's rounding form.
// Launches two kernels on `stream`; returns the CUDA error code of the
// launches (0 on success).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                                 void* dgamma, void* part, long long rows, int d, float inv_d,
                                 float eps, int dtype, int layer, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, gamma, dy, dx, dgamma, p, rows, d, inv_d, eps, layer, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, gamma, dy, dx, dgamma, p, rows, d, inv_d, eps, layer, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
