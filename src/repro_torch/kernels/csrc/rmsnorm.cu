// Fused RMSNorm, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py:_rmsnorm_kernel
// (launched by rmsnorm): y = x * rsqrt(mean(x^2) + eps) * gamma over the last
// axis, with the mean square accumulated in fp32 whatever the input type.
//
// Two rounding forms, chosen by a template flag:
//   LAYER = false  the Pallas kernel's: x * r * gamma in fp32, rounded once;
//   LAYER = true   the model layer's (models/layers.py:rmsnorm): x * r rounded
//                  to the input type, then multiplied by gamma in that type.
// The two agree in fp32 and differ by one rounding in bf16.
//
// Design: one block of kThreads threads per row, so any row count works (the
// Pallas kernel's 1-row fallback for ragged row counts has no counterpart).
// Thread t sums the squares of x[t], x[t + kThreads], ... in order; each warp
// then adds its lanes with an xor butterfly of __shfl_xor_sync, and warp 0
// adds the warps' partials the same way.  That fixed order is the one the
// plain PyTorch version (_sum_squares in rmsnorm.py) spells out.  The mean is
// the sum times inv_d, the fp32 reciprocal of d that the wrapper passes (how
// PyTorch's own CUDA division by a scalar computes it), and r = 1 / sqrtf(ms +
// eps) with IEEE sqrt and division; built with --fmad=false, the kernel and
// its plain version then agree bit for bit.  A second pass over the row
// (from L1/L2: a 4096-wide bf16 row is 8 KB) writes the output.
//
// Bound on this card: bytes.  Each element is read once and written once
// (4 bytes a bf16 element, 8 an fp32 one) plus gamma, against ~4 fp32
// operations an element.  At the decode shape (8 rows of 4096, bf16) that is
// 139,264 bytes, 0.04 us at 3.35 TB/s, so a launch is bound by launch
// latency; at 4096 rows of 4096 (67 MB) the bound is ~20 us and 4096 blocks
// fill the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

template <typename T, bool LAYER>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ out, int d,
                   float inv_d, float eps) {
  __shared__ float partial[32];
  __shared__ float row_r;
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  float acc = 0.0f;
  for (int i = t; i < d; i += kThreads) {
    const float v = to_float(xr[i]);
    acc = acc + v * v;
  }
  acc = butterfly_sum(acc);
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kWarps ? partial[lane] : 0.0f;
    s = butterfly_sum(s);
    if (lane == 0) row_r = 1.0f / sqrtf(s * inv_d + eps);
  }
  __syncthreads();
  const float r = row_r;

  for (int i = t; i < d; i += kThreads) {
    const float y = to_float(xr[i]) * r;
    if constexpr (LAYER) {
      orow[i] = from_float<T>(to_float(from_float<T>(y)) * to_float(gamma[i]));
    } else {
      orow[i] = from_float<T>(y * to_float(gamma[i]));
    }
  }
}

template <typename T, bool LAYER>
cudaError_t launch(const void* x, const void* gamma, void* out, long long rows, int d,
                   float inv_d, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, LAYER><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<T*>(out), d, inv_d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, gamma, out: device pointers; x and out (rows, d) contiguous, gamma (d,),
// all of one type: dtype 0 = float32, 1 = bfloat16.  inv_d is the fp32
// reciprocal of d; layer != 0 picks the model layer's rounding form.
// Launches on `stream`; returns the CUDA error code of the launch (0 on
// success).
extern "C" int repro_rmsnorm(const void* x, const void* gamma, void* out, long long rows, int d,
                             float inv_d, float eps, int dtype, int layer, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = layer ? launch<float, true>(x, gamma, out, rows, d, inv_d, eps, s)
                : launch<float, false>(x, gamma, out, rows, d, inv_d, eps, s);
  } else if (dtype == 1) {
    err = layer ? launch<__nv_bfloat16, true>(x, gamma, out, rows, d, inv_d, eps, s)
                : launch<__nv_bfloat16, false>(x, gamma, out, rows, d, inv_d, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
