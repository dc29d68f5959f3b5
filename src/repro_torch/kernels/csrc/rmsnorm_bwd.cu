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
// of the reference takes it.  mean(g * xh) is taken as r * sum(g * x) * (1/d),
// so that both row sums come from x and dy as loaded.
//
// Bound on this card: bytes.  x and dy are read and dx written once (6 bytes
// a bf16 element), against ~12 fp32 operations an element: at the training
// shape (4096 rows of 4096, bf16) 100.7 MB, 30 us at 3.35 TB/s.
//
// Design.  A block of kThreads threads walks kRows rows (rmsnorm.py:BWD_ROWS)
// one after another.  A row is cut into chunks of 16 bytes as in the forward
// kernel, thread t holding chunks t, t + kThreads, ... .  On the vector path
// (d a multiple of the chunk, at most kMaxSlots chunks a thread, 16-byte
// aligned pointers) the thread loads gamma's chunks once, and each row's x
// and dy chunks with 16-byte loads into registers, all issued before any
// arithmetic; the next row's loads are issued before the current row is
// reduced, into a second register set, so a row's memory round trip
// overlaps the row before.  x and dy are read from memory once, and dx is
// written with 16-byte stores from the same registers.  The two row sums,
// sum(x^2) and sum(g * x), go through the forward's fixed order as a pair:
// the thread's elements chunk by chunk, a warp butterfly of
// __shfl_xor_sync, the warps' partials through one shared-memory exchange
// (double-buffered, so one barrier a row serves) and one more butterfly
// (rmsnorm.py:_row_sum spells it).  Every column belongs to the same thread
// in every row, so the thread adds its columns' dy * y0 over the block's
// rows in registers, in row order, and stores the block's fp32 row of the
// scratch `part` (rows / kRows, d) once.  A second kernel sums the blocks'
// rows in a fixed tree over kGroups groups: group k holds blocks k,
// k + kGroups, ..., added in order by one thread a column; the groups'
// sums are then added in group order through shared memory.  Its blocks
// take kCols2 columns each, so d = 4096 spreads over 256 blocks.  No
// atomics: the result is the same from run to run, and the plain version
// (rmsnorm_bwd_plain) follows both orders bit for bit.  Rows the vector path
// does not take run the strided kernel, which sums in the same order with
// scalar loads, reads x and dy a second time to write, and keeps its
// partial of dgamma in its block's row of `part` (each thread reading back
// only what it wrote).
//
// Measured on an H100 80GB HBM3 at 700 W (rmsnorm_probe.py --bwd, device
// time by torch.profiler in a fresh process), at 4096 x 4096 bf16: the rows
// pass 37.0-37.7 us and the second pass 2.5 us, 75% of the bytes bound
// (the design before this one: 291-300 us and 7.8 us).  Blocks of 8 rows
// took 48.8 us (the second pass 5.7 of it), of 32 rows 45.7 us (128 blocks
// on 132 SMs), and loading the next row after the current one's writes in
// place of before its reduction 45.6 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// The launch arguments, packed by the wrapper into one buffer (the Python
// struct format "@PPPPPPqiffii", rmsnorm.py:_BWD_ARGS): one pointer crosses
// ctypes in place of twelve values.
struct ReproRmsnormBwdArgs {
  const void* x;      // (rows, d), contiguous
  const void* gamma;  // (d,)
  const void* dy;     // (rows, d), contiguous
  void* dx;           // (rows, d), contiguous
  void* dgamma;       // (d,)
  void* part;         // fp32 scratch, ceil(rows / kRows) x d
  long long rows;
  int d;
  float inv_d;        // fp32 reciprocal of d
  float eps;
  int dtype;          // 0 = float32, 1 = bfloat16
  int layer;          // != 0: the model layer's rounding form
};
static_assert(offsetof(ReproRmsnormBwdArgs, rows) == 48 &&
                  offsetof(ReproRmsnormBwdArgs, layer) == 72,
              "ReproRmsnormBwdArgs must match rmsnorm.py:_BWD_ARGS");

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;      // rows a block walks: rmsnorm.py:BWD_ROWS
constexpr int kMaxSlots = 4;   // 16-byte chunks a thread holds: rmsnorm.py:BWD_MAX_SLOTS
constexpr int kGroups = 16;    // groups of the second pass: rmsnorm.py:BWD_GROUPS
constexpr int kCols2 = kThreads / kGroups;  // columns a block of the second pass
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

// The block's sums of each thread's pair of partials (sum(x^2), sum(g * x))
// in the forward's order; every thread gets both.  `partial` must not be
// written again before every thread has returned from this call: the
// callers alternate two buffers a row, and the next row's barrier fences
// the one after.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* partial) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = a + __shfl_xor_sync(kFullMask, a, off);
    b = b + __shfl_xor_sync(kFullMask, b, off);
  }
  if (lane == 0) partial[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  const float2 p = lane < kWarps ? partial[lane] : make_float2(0.0f, 0.0f);
  a = p.x;
  b = p.y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = a + __shfl_xor_sync(kFullMask, a, off);
    b = b + __shfl_xor_sync(kFullMask, b, off);
  }
  return make_float2(a, b);
}

// One element's dx and its dgamma term dy * y0.
template <typename T, bool LAYER>
__device__ __forceinline__ T element(float xv, float dyv, float gv, float r, float mean,
                                     float& acc) {
  const float g = dyv * gv;
  const float xh = xv * r;
  const float y0 = LAYER ? to_float(from_float<T>(xh)) : xh;
  acc = acc + dyv * y0;
  return from_float<T>(r * (g - xh * mean));
}

template <typename T, bool LAYER, int SLOTS>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_vec(const T* __restrict__ x, const T* __restrict__ gamma,
                    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                    int rows, int d, float inv_d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float2 partial[2][kWarps];
  const int chunks = d / kVec;
  const int t = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long r1 = r0 + kRows < rows ? r0 + kRows : rows;

  alignas(16) T gv[SLOTS][kVec];
  alignas(16) T xv[SLOTS][kVec];
  alignas(16) T dv[SLOTS][kVec];
  float acc[SLOTS][kVec];
  const uint4* gr = reinterpret_cast<const uint4*>(gamma);
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int c = j * kThreads + t;
    if (c < chunks) *reinterpret_cast<uint4*>(gv[j]) = __ldg(gr + c);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[j][e] = 0.0f;
  }
  {
    const uint4* xr = reinterpret_cast<const uint4*>(x + r0 * d);
    const uint4* dr = reinterpret_cast<const uint4*>(dy + r0 * d);
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int c = j * kThreads + t;
      if (c < chunks) {
        *reinterpret_cast<uint4*>(xv[j]) = __ldg(xr + c);
        *reinterpret_cast<uint4*>(dv[j]) = __ldg(dr + c);
      }
    }
  }

  for (long long row = r0; row < r1; ++row) {  // the same bounds for every thread
    // the next row's chunks, in flight while this row reduces
    alignas(16) T xn[SLOTS][kVec];
    alignas(16) T dn[SLOTS][kVec];
    if (row + 1 < r1) {
      const uint4* xr = reinterpret_cast<const uint4*>(x + (row + 1) * d);
      const uint4* dr = reinterpret_cast<const uint4*>(dy + (row + 1) * d);
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int c = j * kThreads + t;
        if (c < chunks) {
          *reinterpret_cast<uint4*>(xn[j]) = __ldg(xr + c);
          *reinterpret_cast<uint4*>(dn[j]) = __ldg(dr + c);
        }
      }
    }

    float ss = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if (j * kThreads + t < chunks) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float v = to_float(xv[j][e]);
          const float g = to_float(dv[j][e]) * to_float(gv[j][e]);
          ss = ss + v * v;
          sgx = sgx + g * v;
        }
      }
    }
    const float2 s = block_sum2(ss, sgx, partial[(row - r0) & 1]);
    const float r = 1.0f / sqrtf(s.x * inv_d + eps);
    const float mean = r * s.y * inv_d;

    uint4* orow = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int c = j * kThreads + t;
      if (c < chunks) {
        alignas(16) T ov[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          ov[e] = element<T, LAYER>(to_float(xv[j][e]), to_float(dv[j][e]),
                                    to_float(gv[j][e]), r, mean, acc[j][e]);
        }
        orow[c] = *reinterpret_cast<const uint4*>(ov);
      }
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      *reinterpret_cast<uint4*>(xv[j]) = *reinterpret_cast<const uint4*>(xn[j]);
      *reinterpret_cast<uint4*>(dv[j]) = *reinterpret_cast<const uint4*>(dn[j]);
    }
  }

  float4* prow = reinterpret_cast<float4*>(part + static_cast<long long>(blockIdx.x) * d);
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int c = j * kThreads + t;
    if (c < chunks) {
#pragma unroll
      for (int q = 0; q < kVec / 4; ++q) {
        prow[c * (kVec / 4) + q] =
            make_float4(acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2], acc[j][4 * q + 3]);
      }
    }
  }
}

// Rows the vector path does not take: the same chunks and order with scalar
// loads; x and dy are read again to write, and dgamma's partial goes through
// the block's row of `part`, each element written and read back by the one
// thread that owns its column.
template <typename T, bool LAYER>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_strided(const T* __restrict__ x, const T* __restrict__ gamma,
                        const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                        int rows, int d, float inv_d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float2 partial[2][kWarps];
  const int t = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long r1 = r0 + kRows < rows ? r0 + kRows : rows;
  float* prow = part + static_cast<long long>(blockIdx.x) * d;
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * d;
    const T* dyr = dy + row * d;
    T* dxr = dx + row * d;

    float ss = 0.0f, sgx = 0.0f;
    for (long long c = static_cast<long long>(t) * kVec; c < d; c += kThreads * kVec) {
      const int end = c + kVec < d ? static_cast<int>(c) + kVec : d;
      for (int i = static_cast<int>(c); i < end; ++i) {
        const float v = to_float(xr[i]);
        const float g = to_float(dyr[i]) * to_float(gamma[i]);
        ss = ss + v * v;
        sgx = sgx + g * v;
      }
    }
    const float2 s = block_sum2(ss, sgx, partial[(row - r0) & 1]);
    const float r = 1.0f / sqrtf(s.x * inv_d + eps);
    const float mean = r * s.y * inv_d;

    for (long long c = static_cast<long long>(t) * kVec; c < d; c += kThreads * kVec) {
      const int end = c + kVec < d ? static_cast<int>(c) + kVec : d;
      for (int i = static_cast<int>(c); i < end; ++i) {
        float acc = row == r0 ? 0.0f : prow[i];
        dxr[i] = element<T, LAYER>(to_float(xr[i]), to_float(dyr[i]), to_float(gamma[i]), r,
                                   mean, acc);
        prow[i] = acc;
      }
    }
  }
}

// dgamma[c] from the blocks' rows of `part`: group k (k < kGroups) adds
// rows k, k + kGroups, ... in order, from zero; the groups' sums are added
// in group order, from zero.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_dgamma(const float* __restrict__ part, T* __restrict__ dgamma, int blocks,
                       int d) {
  __shared__ float sums[kGroups][kCols2];
  const int col = threadIdx.x % kCols2;
  const int grp = threadIdx.x / kCols2;
  const int c = blockIdx.x * kCols2 + col;
  float acc = 0.0f;
  if (c < d) {
#pragma unroll 4
    for (int b = grp; b < blocks; b += kGroups) {
      acc = acc + part[static_cast<long long>(b) * d + c];
    }
  }
  sums[grp][col] = acc;
  __syncthreads();
  if (grp == 0 && c < d) {
    float total = 0.0f;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) total = total + sums[k][col];
    dgamma[c] = from_float<T>(total);
  }
}

template <typename T>
cudaError_t start_rows(void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, float,
                                      float),
                       unsigned blocks, const void* x, const void* gamma, const void* dy,
                       void* dx, float* part, int rows, int d, float inv_d, float eps,
                       cudaStream_t stream) {
  kernel<<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(gamma),
                                          static_cast<const T*>(dy), static_cast<T*>(dx), part,
                                          rows, d, inv_d, eps);
  return cudaGetLastError();
}

// The vector kernel with SLOTS = slots, for slots in [S, kMaxSlots].
template <typename T, bool LAYER, int S>
cudaError_t start_vec(int slots, unsigned blocks, const void* x, const void* gamma,
                      const void* dy, void* dx, float* part, int rows, int d, float inv_d,
                      float eps, cudaStream_t stream) {
  if constexpr (S < kMaxSlots) {
    if (slots > S) {
      return start_vec<T, LAYER, S + 1>(slots, blocks, x, gamma, dy, dx, part, rows, d, inv_d,
                                        eps, stream);
    }
  }
  return start_rows<T>(rmsnorm_bwd_vec<T, LAYER, S>, blocks, x, gamma, dy, dx, part, rows, d,
                       inv_d, eps, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0; }

template <typename T, bool LAYER>
cudaError_t launch_rows(unsigned blocks, const void* x, const void* gamma, const void* dy,
                        void* dx, float* part, int rows, int d, float inv_d, float eps,
                        cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int slots = (d / kVec + kThreads - 1) / kThreads;
  if (d % kVec == 0 && slots <= kMaxSlots && aligned16(x) && aligned16(gamma) &&
      aligned16(dy) && aligned16(dx) && aligned16(part)) {
    return start_vec<T, LAYER, 1>(slots, blocks, x, gamma, dy, dx, part, rows, d, inv_d, eps,
                                  stream);
  }
  return start_rows<T>(rmsnorm_bwd_strided<T, LAYER>, blocks, x, gamma, dy, dx, part, rows, d,
                       inv_d, eps, stream);
}

template <typename T>
cudaError_t launch(const ReproRmsnormBwdArgs& a, cudaStream_t stream) {
  const int rows = static_cast<int>(a.rows);
  const unsigned blocks = static_cast<unsigned>((a.rows + kRows - 1) / kRows);
  float* part = static_cast<float*>(a.part);
  cudaError_t err = a.layer ? launch_rows<T, true>(blocks, a.x, a.gamma, a.dy, a.dx, part, rows,
                                                   a.d, a.inv_d, a.eps, stream)
                            : launch_rows<T, false>(blocks, a.x, a.gamma, a.dy, a.dx, part,
                                                    rows, a.d, a.inv_d, a.eps, stream);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dgamma<T><<<(a.d + kCols2 - 1) / kCols2, kThreads, 0, stream>>>(
      part, static_cast<T*>(a.dgamma), static_cast<int>(blocks), a.d);
  return cudaGetLastError();
}

}  // namespace

// args: see ReproRmsnormBwdArgs (device pointers; x, gamma, dy, dx and
// dgamma of one type).  Launches two kernels on `stream`; returns the CUDA
// error code of the launches (0 on success).
extern "C" int repro_rmsnorm_bwd(const ReproRmsnormBwdArgs* args, void* stream) {
  const ReproRmsnormBwdArgs& a = *args;
  if (a.rows < 1 || a.rows > 0x7fffffffLL || a.d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.dtype == 0) {
    err = launch<float>(a, s);
  } else if (a.dtype == 1) {
    err = launch<__nv_bfloat16>(a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
