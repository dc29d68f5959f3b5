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
// Bound on this card: bytes.  Each element is read once and written once
// (4 bytes a bf16 element, 8 an fp32 one) plus gamma, against ~4 fp32
// operations an element.  At the decode shape (8 rows of 4096, bf16) that is
// 139,264 bytes, 0.04 us at 3.35 TB/s, so a launch is bound by its latency:
// the launch and one round trip to memory are the least it can take.  At
// 4096 rows of 4096 (67 MB) the bound is ~20 us and 4096 blocks fill the card.
//
// Design: one block of kThreads threads per row (any row count works; the
// Pallas kernel's 1-row fallback for ragged row counts has no counterpart).
// The row is cut into chunks of 16 bytes (kVec = 8 bf16 or 4 fp32 elements);
// thread t holds chunks t, t + kThreads, ... .  On the vector path each
// thread issues all of its 16-byte loads of gamma and of x through the
// read-only path before any arithmetic, so a row costs one memory round trip;
// it sums the squares from those registers, and writes the output from the
// same registers with 16-byte stores: x is read once.  The vector path takes
// rows whose width is a multiple of kVec, at most kMaxSlots chunks a thread,
// with 16-byte aligned pointers; any other row runs the strided kernel, which
// sums in the same order with scalar loads and reads x again to write.
//
// The sum's fixed order, the one the plain PyTorch version (_sum_squares in
// rmsnorm.py) spells out: thread t adds the squares of its chunks' elements
// chunk by chunk, in element order (elements past d add nothing); each warp
// adds its lanes with an xor butterfly of __shfl_xor_sync; the warps' partials
// meet in shared memory, and every warp adds them with the same butterfly, so
// one barrier serves and every lane holds the same sum (each stage adds two
// values commutatively).  The mean is the sum times inv_d, the fp32 reciprocal
// of d that the wrapper passes (how PyTorch's own CUDA division by a scalar
// computes it), and r = 1 / sqrtf(ms + eps) with IEEE sqrt and division; built
// with --fmad=false, the kernel and its plain version agree bit for bit.
//
// Measured on an H100 80GB HBM3 at 700 W (rmsnorm_probe.py, chip_smoke.py):
// 1.63 us at 8 x 4096 bf16 (a one-element torch op takes 1.15 us), 24.4 us
// at 4096 x 4096 (82% of the bytes bound).  Blocks of 128 threads took
// 0.18 us more at the decode shape and 512 threads 0.01-0.06 us more;
// programmatic dependent launch (griddepcontrol.wait between gamma's loads
// and x's) took 0.17 us more a launch in eager back-to-back launches and
// 0.1-0.27 us less in a captured chain of dependent norms.  The decode
// path launches eagerly, so it is not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// The launch arguments, packed by the wrapper into one buffer (the Python
// struct format "@PPPqiffii", rmsnorm.py:_ARGS): one pointer crosses ctypes
// in place of nine values.
struct ReproRmsnormArgs {
  const void* x;      // (rows, d), contiguous
  const void* gamma;  // (d,)
  void* out;          // (rows, d), contiguous
  long long rows;
  int d;
  float inv_d;        // fp32 reciprocal of d
  float eps;
  int dtype;          // 0 = float32, 1 = bfloat16
  int layer;          // != 0: the model layer's rounding form
};
static_assert(offsetof(ReproRmsnormArgs, rows) == 24 && offsetof(ReproRmsnormArgs, layer) == 48,
              "ReproRmsnormArgs must match rmsnorm.py:_ARGS");

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 8;  // 16-byte chunks a thread holds on the vector path
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

// One output element from x's value, the row's 1/rms and gamma.
template <typename T, bool LAYER>
__device__ __forceinline__ T scale(float v, float r, T g) {
  const float y = v * r;
  if constexpr (LAYER) {
    return from_float<T>(to_float(from_float<T>(y)) * to_float(g));
  } else {
    return from_float<T>(y * to_float(g));
  }
}

__device__ __forceinline__ float butterfly_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// The row's 1 / rms from each thread's partial sum of squares.
__device__ __forceinline__ float row_rrms(float acc, float* partial, float inv_d, float eps) {
  const int lane = threadIdx.x & 31;
  acc = butterfly_sum(acc);
  if (lane == 0) partial[threadIdx.x >> 5] = acc;
  __syncthreads();
  const float s = butterfly_sum(lane < kWarps ? partial[lane] : 0.0f);
  return 1.0f / sqrtf(s * inv_d + eps);
}

template <typename T, bool LAYER, int SLOTS>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_vec_kernel(const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ out,
                       int d, float inv_d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float partial[kWarps];
  const int chunks = d / kVec;
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  const uint4* gr = reinterpret_cast<const uint4*>(gamma);
  uint4* orow = reinterpret_cast<uint4*>(out + base);

  alignas(16) T gv[SLOTS][kVec];
  alignas(16) T xv[SLOTS][kVec];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int c = j * kThreads + t;
    if (c < chunks) *reinterpret_cast<uint4*>(gv[j]) = __ldg(gr + c);
  }
  // x after gamma: nothing above reads what an earlier kernel may write
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int c = j * kThreads + t;
    if (c < chunks) *reinterpret_cast<uint4*>(xv[j]) = __ldg(xr + c);
  }

  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    if (j * kThreads + t < chunks) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float v = to_float(xv[j][e]);
        acc = acc + v * v;
      }
    }
  }
  const float r = row_rrms(acc, partial, inv_d, eps);

#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int c = j * kThreads + t;
    if (c < chunks) {
      alignas(16) T ov[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) ov[e] = scale<T, LAYER>(to_float(xv[j][e]), r, gv[j][e]);
      orow[c] = *reinterpret_cast<const uint4*>(ov);
    }
  }
}

// Rows the vector path does not take: the same chunks and order with scalar
// loads, then a second, element-strided pass over x to write.
template <typename T, bool LAYER>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_strided_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                           T* __restrict__ out, int d, float inv_d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float partial[kWarps];
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const T* xr = x + base;
  T* orow = out + base;

  float acc = 0.0f;
  for (long long c = static_cast<long long>(t) * kVec; c < d; c += kThreads * kVec) {
    const int end = c + kVec < d ? static_cast<int>(c) + kVec : d;
    for (int i = static_cast<int>(c); i < end; ++i) {
      const float v = to_float(xr[i]);
      acc = acc + v * v;
    }
  }
  const float r = row_rrms(acc, partial, inv_d, eps);

  for (int i = t; i < d; i += kThreads) orow[i] = scale<T, LAYER>(to_float(xr[i]), r, gamma[i]);
}

template <typename T>
cudaError_t start(void (*kernel)(const T*, const T*, T*, int, float, float),
                  const ReproRmsnormArgs& a, cudaStream_t stream) {
  kernel<<<static_cast<unsigned>(a.rows), kThreads, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.gamma), static_cast<T*>(a.out), a.d,
      a.inv_d, a.eps);
  return cudaGetLastError();
}

// The vector kernel with SLOTS = slots, for slots in [S, kMaxSlots].
template <typename T, bool LAYER, int S>
cudaError_t start_vec(int slots, const ReproRmsnormArgs& a, cudaStream_t stream) {
  if constexpr (S < kMaxSlots) {
    if (slots > S) return start_vec<T, LAYER, S + 1>(slots, a, stream);
  }
  return start<T>(rmsnorm_vec_kernel<T, LAYER, S>, a, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0; }

template <typename T, bool LAYER>
cudaError_t launch(const ReproRmsnormArgs& a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int slots = (a.d / kVec + kThreads - 1) / kThreads;
  if (a.d % kVec == 0 && slots <= kMaxSlots && aligned16(a.x) && aligned16(a.gamma) &&
      aligned16(a.out)) {
    return start_vec<T, LAYER, 1>(slots, a, stream);
  }
  return start<T>(rmsnorm_strided_kernel<T, LAYER>, a, stream);
}

}  // namespace

// args: see ReproRmsnormArgs (device pointers; x, gamma and out of one type).
// Launches on `stream`; returns the CUDA error code of the launch (0 on
// success).
extern "C" int repro_rmsnorm(const ReproRmsnormArgs* args, void* stream) {
  const ReproRmsnormArgs& a = *args;
  if (a.rows < 1 || a.rows > 0x7fffffffLL || a.d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.dtype == 0) {
    err = a.layer ? launch<float, true>(a, s) : launch<float, false>(a, s);
  } else if (a.dtype == 1) {
    err = a.layer ? launch<__nv_bfloat16, true>(a, s) : launch<__nv_bfloat16, false>(a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
