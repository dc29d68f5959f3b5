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
// Bound on this card: operations.  A step costs 6 fp32 operations per state
// entry (the update's two products and sum, the outer product, the dot's
// product and sum): 6 * B * H * S * P * N = 8.05 G at (1, 80, 4096, 64) with
// N = 64, 0.120 ms at the 67 TFLOP/s of the fp32 pipes (which count a fused
// multiply-add as two), against ~130 MB of bf16 x, fp32 a, dt and y, and
// bf16 B and C (0.04 ms at 3.35 TB/s).  Without contraction each of the 6 is
// one lane instruction, so the issue floor is 8.05 G over 132 SMs x 128 lanes
// x 1.98 GHz = 33.45 T lane-ops/s: 0.241 ms.
//
// Design.  Row h[p, :] of a state depends on x[p] alone, so the B * H * P
// rows are independent recurrences.  The dot h . C is summed in a fixed
// order that the plain version (ssm_scan_plain in ssm_scan.py) repeats: 32
// "virtual lanes", lane v adding the products of entries v, v + 32, ... in
// order, then a pairwise tree over the lanes, adjacent ones first (v with
// v ^ 1, then v ^ 2, 4, 8, 16).  8 threads serve a row: thread l (0..7)
// holds the virtual lanes 4l .. 4l + 3, that is 4 * K state entries in
// registers (K = ceil(N / 32), N <= 256), four side by side for each j.
// The tree's first two stages are adds in registers; only the last three
// cross threads, and they run once per four steps as a reduce-scatter: at
// l ^ 1 a thread sends two of its four steps' partial sums and keeps the
// other two, at l ^ 2 one, at l ^ 4 it ends with the whole sum of one step.
// So a row spends 4 shuffles on 4 steps (a butterfly a step: 12), and 4
// threads of a row each store one y, straight to global memory (the 4 rows
// of a warp side by side).
//
// A warp serves 4 rows.  A block has 4 computing warps (16 consecutive rows
// of one (batch, head)) and 2 loading warps: grid (ceil(P / 16), H, B), 320
// blocks of 192 threads at (1, 80, 4096, 64).  The sequence runs in tiles
// of 32 steps through a ring of 3 slots of shared memory: the loading warps
// fill slot t % 3 with tile t (B and C rows by cp.async, in the input type,
// each padded with zeros to 32 * K entries; x of the block's rows, exp(a)
// and dt as fp32) once the computing warps are done with tile t - 3 there,
// and the two sides meet at named barriers (full / empty, one a slot).  The
// computing threads read four entries of B or C as one 8-byte (bf16) or
// 16-byte (fp32) load and widen bf16 in registers (exact), and e, dt and x
// four steps a 16-byte load.  Every computing thread runs every step, so
// the full-mask shuffles are convergent.
//
// Levers, on an H100 80GB HBM3 at 700 W (ssm_probe.py, bf16 at (1, 80,
// 4096, 64); the kernel before this design, one warp a row with a
// 5-shuffle butterfly a step: 1.46 ms):
// - 4 virtual lanes a thread, the tree's first stages in registers: taken.
//   The tree's last stages once a step instead of the reduce-scatter:
//   0.669 ms against 0.615.
// - 2 rows a thread (B and C widened once for two rows): not taken.  It
//   halves the warps to 640, and the busiest of the 528 schedulers would
//   carry 2 warps of ~520 instructions per 4 steps instead of 3 of 310.
// - Vector loads from shared memory: taken.  Summing adjacent virtual
//   lanes first (not v with v + 16, the first draft's order) puts a
//   thread's entries of a j side by side in B's and C's rows, so they are
//   staged as they lie in global memory and read 4 at a time.  Staging a
//   thread's entries of every j side by side (one 16-byte load for both
//   at N = 64, 8-byte copies to place them) was slower in a draft.
// - Staging off the computing warps' path: taken.  A first draft staged by
//   all warps between two block barriers a tile (cp.async of raw bytes,
//   unpacked to fp32), with staging and unpacking on every warp's path,
//   and was slower.  Loading warps: 1 a block 0.642 ms, 2 0.615, 4 0.692;
//   2 slots 0.619.  B and C staged as fp32 (widened by the loading warps;
//   a draft) double the shared-memory reads and were slower.
// - Tiles of 16 or 64 steps: 0.880 and 0.693 ms (32 taken).
// - Several heads a block (B and C staged once for all): not taken.  B and
//   C come from L2 (1 MB at zamba2's prefill), and 32-row blocks put 4
//   warps on the schedulers of 28 SMs (32 rows of one head: 1.275 ms;
//   8-row blocks, each with its own loading warps: 0.81-0.83).
// - y side by side: the 4 rows of a warp write 16 adjacent bytes a store;
//   the first draft passed y through shared memory instead.
// What holds it now: the loop is 310 instructions per 4 steps (192 fp32,
// 64 to widen bf16, 19 shared loads, 4 shuffles and 6 selects, 25 of
// address, loop and store), and the busiest schedulers run 3 computing
// warps: 3 x 310 x 1024 / 1.98 GHz = 0.48 ms of issue (the SM clock
// holds 1980 MHz under this load).  With the loading warps' filling taken
// out the kernel runs 0.571 ms; filling adds ~0.04.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;                      // threads of a row
constexpr int kRowsPerWarp = 32 / kGroup;      // 4
constexpr int kWarps = 4;                      // computing warps of a block
constexpr int kRows = kWarps * kRowsPerWarp;   // rows of a block
constexpr int kLoadWarps = 2;                  // loading warps of a block
constexpr int kLoaders = 32 * kLoadWarps;
constexpr int kThreads = 32 * kWarps + kLoaders;
constexpr int kSteps = 32;                     // steps of a tile
constexpr int kSlots = 3;                      // tiles staged at once
constexpr int kXStride = kSteps + 4;           // floats of a row's x in a slot
constexpr int kMaxK = 8;                       // N <= 32 * kMaxK
constexpr unsigned kFullMask = 0xffffffffu;
// Named barriers (0 is __syncthreads): slot s full, slot s empty.
constexpr int kFull = 1;
constexpr int kEmpty = kFull + kSlots;
constexpr int kXPer = kSteps * kRows / kLoaders;  // x values a loading thread stages

static_assert(kSteps % 4 == 0, "tiles run in groups of four steps");
static_assert(kXPer * kLoaders == kSteps * kRows, "x splits evenly over the loaders");
static_assert(kEmpty + kSlots <= 16, "named barriers");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void set_zero(float& v) { v = 0.0f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& v) { v = __float2bfloat16(0.0f); }

// Four consecutive entries of a staged row of B or C, as fp32 (bf16 widens
// exactly: its bits are the float's upper half).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// ---------------------------------------------------------------- cp.async
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Named barriers over the whole block: the loading and the computing warps
// meet at them, one side arriving, the other waiting.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(kThreads) : "memory");
}

// A slot of shared memory, in bytes: a tile's rows of B and C in the input
// type, each padded to 32 * K entries (zeros past N); x of the block's rows
// (fp32, a row's steps side by side); exp(a) and dt of each step.
template <typename T, int K>
struct Layout {
  static constexpr int kN = 32 * K;
  static constexpr int kBC = kSteps * kN * static_cast<int>(sizeof(T));
  static constexpr int kB = 0;
  static constexpr int kC = kB + kBC;
  static constexpr int kX = kC + kBC;
  static constexpr int kE = kX + 4 * kRows * kXStride;
  static constexpr int kD = kE + 4 * kSteps;
  static constexpr int kSlot = kD + 4 * kSteps;
  static constexpr int kBytes = kSlots * kSlot;
  static_assert(kBC % 16 == 0 && kSlot % 16 == 0, "16-byte rows and slots");
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// The global memory one block reads and writes.
template <typename T>
struct Rows {
  const T* x;  // x[b, h, 0, 0]
  const float* a;
  const float* dt;
  const T* b;  // B[b, 0, 0]
  const T* c;
  float* y;
  int S, P, N, p0, rows;
};

// Fill a slot with tile t0 (`steps` steps; loading thread li of kLoaders).
// B and C rows go by cp.async when every row starts on 16 bytes (`fast`),
// else one entry at a time; x, exp(a) and dt by plain loads, all issued
// before any is stored.  Steps past
// `steps` (the last tile's) get exp(a) = 1, dt = 0 and x = 0: they leave
// the state as it is (whatever B and C hold there), and their y is never
// written.
template <typename T, int K>
__device__ __forceinline__ void fill_slot(char* slot, const Rows<T>& g, int t0, int steps,
                                          bool fast, int li) {
  using L = Layout<T, K>;
  T* sB = reinterpret_cast<T*>(slot + L::kB);
  T* sC = reinterpret_cast<T*>(slot + L::kC);
  const T* b0 = g.b + static_cast<long long>(t0) * g.N;
  const T* c0 = g.c + static_cast<long long>(t0) * g.N;
  if (fast) {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    const int chunks = g.N / kVec;
    for (int idx = li; idx < steps * chunks; idx += kLoaders) {
      const int i = idx / chunks;
      const int n = (idx - i * chunks) * kVec;
      cp_async16(sB + i * L::kN + n, b0 + i * g.N + n);
      cp_async16(sC + i * L::kN + n, c0 + i * g.N + n);
    }
    cp_async_commit();
  } else {
    for (int idx = li; idx < steps * g.N; idx += kLoaders) {
      const int i = idx / g.N;
      const int n = idx - i * g.N;
      sB[i * L::kN + n] = b0[idx];
      sC[i * L::kN + n] = c0[idx];
    }
  }
  float xv[kXPer];
#pragma unroll
  for (int k = 0; k < kXPer; ++k) {
    const int i = (li + k * kLoaders) / kRows;
    const int r = (li + k * kLoaders) % kRows;
    xv[k] = i < steps && r < g.rows
                ? to_float(g.x[static_cast<long long>(t0 + i) * g.P + g.p0 + r])
                : 0.0f;
  }
  float* sE = reinterpret_cast<float*>(slot + L::kE);
  float* sD = reinterpret_cast<float*>(slot + L::kD);
  for (int i = li; i < kSteps; i += kLoaders) {
    sE[i] = i < steps ? expf(g.a[t0 + i]) : 1.0f;
    sD[i] = i < steps ? g.dt[t0 + i] : 0.0f;
  }
  float* sX = reinterpret_cast<float*>(slot + L::kX);
#pragma unroll
  for (int k = 0; k < kXPer; ++k) {
    const int i = (li + k * kLoaders) / kRows;
    const int r = (li + k * kLoaders) % kRows;
    sX[r * kXStride + i] = xv[k];
  }
  if (fast) cp_async_wait_all();
}

// The loading warps: fill slot t % kSlots with tile t once the computing
// warps are done with tile t - kSlots there, then mark it full.
template <typename T, int K>
__device__ __forceinline__ void load_tiles(char* smem, const Rows<T>& g, int li) {
  using L = Layout<T, K>;
  const bool fast = ((reinterpret_cast<uintptr_t>(g.b) | reinterpret_cast<uintptr_t>(g.c)) & 15) == 0 &&
                    g.N * static_cast<int>(sizeof(T)) % 16 == 0;
  // B's and C's entries past N are never written: zero them once
  for (int idx = li; idx < kSteps * L::kN; idx += kLoaders) {
    if (idx % L::kN >= g.N) {
      for (int s = 0; s < kSlots; ++s) {
        set_zero(reinterpret_cast<T*>(smem + s * L::kSlot + L::kB)[idx]);
        set_zero(reinterpret_cast<T*>(smem + s * L::kSlot + L::kC)[idx]);
      }
    }
  }
  const int tiles = (g.S + kSteps - 1) / kSteps;
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kSlots;
    if (t >= kSlots) bar_sync(kEmpty + s);
    fill_slot<T, K>(smem + s * L::kSlot, g, t * kSteps, min(kSteps, g.S - t * kSteps), fast, li);
    bar_arrive(kFull + s);
  }
}

__device__ __forceinline__ float part_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// One step of one j for a thread's four virtual lanes: the state update and
// the lanes' running dot products (the first j starts them).
__device__ __forceinline__ void step_quad(float (&st)[4], float (&acc)[4], bool first, float e,
                                          float d, float xv, const float4& bv, const float4& cv) {
  const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
  const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    st[m] = e * st[m] + d * (xv * bs[m]);
    const float prod = st[m] * cs[m];
    acc[m] = first ? prod : acc[m] + prod;
  }
}

// The tree's last three stages, across the row's threads (l with l ^ 1,
// then l ^ 2, then l ^ 4), over four steps' partial sums (part[u] is this
// thread's four-lane sum of step u): the sum of step 2 * (l & 1) + (l & 2 ?
// 1 : 0), the same in threads l and l ^ 4.
__device__ __forceinline__ float row_sum4(const float (&part)[4], bool odd, bool hi2) {
  const float r0 = (odd ? part[2] : part[0]) +
                   __shfl_xor_sync(kFullMask, odd ? part[0] : part[2], 1);
  const float r1 = (odd ? part[3] : part[1]) +
                   __shfl_xor_sync(kFullMask, odd ? part[1] : part[3], 1);
  const float q = (hi2 ? r1 : r0) + __shfl_xor_sync(kFullMask, hi2 ? r0 : r1, 2);
  return q + __shfl_xor_sync(kFullMask, q, 4);
}

// A computing thread's steps of a tile, from a full slot (the last tile's
// rounded up to a multiple of four); y of its row from step t0, if live.
template <typename T, int K>
__device__ __forceinline__ void scan_tile(const char* slot, float (&st)[K][4], int row, int l,
                                          int steps, float* y, int P, bool live) {
  using L = Layout<T, K>;
  const T* sB = reinterpret_cast<const T*>(slot + L::kB) + 4 * l;
  const T* sC = reinterpret_cast<const T*>(slot + L::kC) + 4 * l;
  const float4* sE = reinterpret_cast<const float4*>(slot + L::kE);
  const float4* sD = reinterpret_cast<const float4*>(slot + L::kD);
  const float4* sX = reinterpret_cast<const float4*>(slot + L::kX) + row * (kXStride / 4);
  const bool odd = (l & 1) != 0;
  const bool hi2 = (l & 2) != 0;
  const int mine = (odd ? 2 : 0) + (hi2 ? 1 : 0);
  const bool writer = live && !(l & 4);
#pragma unroll 1
  for (int i0 = 0; i0 < steps; i0 += 4) {
    const float4 e4 = sE[i0 / 4];
    const float4 d4 = sD[i0 / 4];
    const float4 x4 = sX[i0 / 4];
    float part[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float e = part_of(e4, u);
      const float d = part_of(d4, u);
      const float xv = part_of(x4, u);
      float acc[4];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int at = (i0 + u) * L::kN + 32 * j;
        step_quad(st[j], acc, j == 0, e, d, xv, load4(sB + at), load4(sC + at));
      }
      // the tree's first two stages: adjacent virtual lanes, then pairs
      part[u] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    const float sum = row_sum4(part, odd, hi2);
    if (writer && i0 + mine < steps) y[static_cast<long long>(i0 + mine) * P] = sum;
  }
}

// The computing warps: each of their threads holds 4 * K state entries of
// one row and runs every step of every tile, slot by slot; four threads of
// a row write its y straight to global memory.
template <typename T, int K>
__device__ __forceinline__ void scan_tiles(const char* smem, const Rows<T>& g, int tid) {
  using L = Layout<T, K>;
  const int lane = tid & 31;
  const int l = lane % kGroup;
  const int row = (tid / 32) * kRowsPerWarp + lane / kGroup;
  const bool live = row < g.rows;
  float* yrow = g.y + g.p0 + row;
  float st[K][4];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int m = 0; m < 4; ++m) st[j][m] = 0.0f;
  const int tiles = (g.S + kSteps - 1) / kSteps;
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kSlots;
    const int t0 = t * kSteps;
    bar_sync(kFull + s);
    scan_tile<T, K>(smem + s * L::kSlot, st, row, l, min(kSteps, g.S - t0),
                    yrow + static_cast<long long>(t0) * g.P, g.P, live);
    if (t + kSlots < tiles) bar_arrive(kEmpty + s);  // no one waits for the last ones
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ dt, const T* __restrict__ bm,
                    const T* __restrict__ cm, float* __restrict__ y, int H, int S, int P,
                    int N) {
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const long long bh = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  Rows<T> g;
  g.x = x + bh * S * P;
  g.a = a + bh * S;
  g.dt = dt + bh * S;
  g.b = bm + static_cast<long long>(blockIdx.z) * S * N;
  g.c = cm + static_cast<long long>(blockIdx.z) * S * N;
  g.y = y + bh * S * P;
  g.S = S;
  g.P = P;
  g.N = N;
  g.p0 = blockIdx.x * kRows;
  g.rows = min(kRows, P - g.p0);
  if (tid < 32 * kWarps)
    scan_tiles<T, K>(smem, g, tid);
  else
    load_tiles<T, K>(smem, g, tid - 32 * kWarps);
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* a, const void* dt, const void* bm, const void* cm,
                   void* y, int B, int H, int S, int P, int N, cudaStream_t stream) {
  constexpr int bytes = Layout<T, K>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssm_scan_kernel<T, K>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kRows - 1) / kRows, H, B);
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
