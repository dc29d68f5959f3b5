// Selective scan backward (Mamba2 recurrence), written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains through the chunked SSD form
// (src/repro/models/ssm.py:69) and XLA's autodiff, while the port's forward
// is the ctypes kernel csrc/ssm_scan.cu, which autograd cannot see through.
// The forward, per (batch, head) and state row p:
//
//   h_t = exp(a_t) * h_{t-1} + dt_t * (x_t[p] * B_t),   y_t[p] = h_t . C_t
//
// and, with g_t = dL/dh_t walked in reverse from g_S = 0 and dy of y's type
// (fp32):
//
//   g_t     = exp(a_{t+1}) * g_{t+1} + dy_t[p] * C_t
//   dx_t[p] = dt_t * gB_t[p],            gB_t[p] = sum_n g_t[p, n] B_t[n]
//   ddt_t   = sum_p x_t[p] * gB_t[p]
//   da_t    = exp(a_t) * sum_p sum_n g_t[p, n] h_{t-1}[p, n]
//   dB_t[n] = sum_h sum_p (dt_t * x_t[p]) * g_t[p, n]
//   dC_t[n] = sum_h sum_p dy_t[p] * h_t[p, n]
//
// x, B, C and dx, dB, dC are fp32 or bf16 (read as fp32, exact; written
// rounded once); a, dt, dy, da and ddt are fp32.  Built with --fmad=false:
// every product and sum rounds on its own, as the plain twin
// (ssm_scan_bwd_plain in ssm_scan.py) rounds.
//
// Order of the sums (the twin repeats it, so the two agree bit for bit where
// exp does).  Over n: the forward's 32 virtual lanes (lane v adds entries
// v, v + 32, ... in order), then the pairwise tree over the lanes, adjacent
// first.  Over p: the rows in blocks of 16, a pairwise tree over a block's
// rows (adjacent first), then the blocks one after another from the first;
// for dB and dC the heads too, head after head, each head's blocks in
// order.  No atomics: the same result from run to run.
//
// Design.  Two kernels.  ssm_bwd_rows: grid (ceil(P / 16), H, B), a block of
// 4 warps serves 16 rows of one (batch, head), 8 threads a row, thread l
// holding the virtual lanes 4l .. 4l + 3 (4 * K entries, K = ceil(N / 32)),
// as the forward.  It walks the sequence in segments of kSeg steps (8 for
// N <= 64, else 4).  Phase 1 walks forward and saves the state entering
// each segment to the workspace (global memory, each thread its own float4s).
// Phase 2 walks the segments in reverse: each thread reloads its saved
// state, recomputes the segment's states into its own slots of shared
// memory (rounded as the forward rounds them: never h_t / exp(a)), then
// walks the segment back, carrying g in registers.  A step: the g update,
// the row sums gB and gh (a butterfly over the row's 8 threads), dx written;
// the rows' ddt and da terms summed over the warp's 4 rows by shuffles, the
// dB and dC terms by a reduce-scatter over the warp's rows (each thread ends
// with a quarter of them), into shared memory; after the segment the block
// adds its 4 warps and writes its partials (the block's dB, dC, ddt, da of
// each step) to the workspace.  Inputs are staged a segment at a time by
// all threads between block barriers (B and C widened to fp32, zero past N;
// x and dy zero past P; exp(a) of each step and the next).  ssm_bwd_sum: one
// thread an output adds the blocks' partials in order (over heads and
// blocks for dB and dC) and rounds to the output type.
//
// Bound on this card: operations.  About 15 fp32 operations per state entry
// and step (recompute 4, the g update 3, gB 2, gh 2, the dB and dC terms 2
// each): 15 * B * H * S * P * N = 20.1 G at (1, 80, 4096, 64) with N = 64,
// 0.30 ms at 67 TFLOP/s, against ~170 MB of inputs and outputs (0.05 ms at
// 3.35 TB/s).  This design adds a second forward walk (phase 1) and moves
// its workspace through memory: the saved states (4 bytes per entry every
// kSeg steps, 0.67 GB there) and the blocks' partials (2 N floats per block
// and step, 0.67 GB), each written once and read once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;                      // threads of a row
constexpr int kRowsPerWarp = 32 / kGroup;      // 4
constexpr int kWarps = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // rows of a block (16)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxK = 8;                       // N <= 32 * kMaxK
constexpr int kSumThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Steps of a segment: the recomputed states of a segment live in shared
// memory, (kSeg + 1) * 4 * K floats a thread.
__host__ __device__ constexpr int seg_steps(int k) { return k <= 2 ? 8 : 4; }

// Shared memory of ssm_bwd_rows, in floats (every region starts on 16 bytes).
template <int K>
struct Smem {
  static constexpr int kN = 32 * K;                  // a staged row of B or C
  static constexpr int kT = seg_steps(K);
  static constexpr int kB = 0;                       // [kT][kN]
  static constexpr int kC = kB + kT * kN;            // [kT][kN]
  static constexpr int kX = kC + kT * kN;            // [kT][kRows]
  static constexpr int kDy = kX + kT * kRows;        // [kT][kRows]
  static constexpr int kE = kDy + kT * kRows;        // [kT + 1]: exp(a)
  static constexpr int kD = kE + (kT + 4) / 4 * 4;   // [kT]: dt
  static constexpr int kRed = kD + (kT + 3) / 4 * 4;  // [kT][kWarps][2][kN]
  static constexpr int kRedS = kRed + kT * kWarps * 2 * kN;  // [kT][kWarps][2]
  static constexpr int kHist = kRedS + kT * kWarps * 2;      // [kT + 1][K][kThreads] float4
  static constexpr int kFloats = kHist + (kT + 1) * K * kThreads * 4;
  static constexpr int kBytes = 4 * kFloats;
  static_assert(kD % 4 == 0 && kRed % 4 == 0 && kHist % 4 == 0, "16-byte regions");
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// The workspace, in floats: the state entering each segment of each block
// (a float4 per thread and j), then the blocks' partial dB and dC of each
// step ([b][h][block][t][2 N]), then their partial ddt and da ([b][h][block]
// [t][2]).
struct Work {
  long long states, bc, s, total;
};

__host__ __device__ inline Work work_layout(int B, int H, int S, int P, int N) {
  const long long blocks = static_cast<long long>(B) * H * ((P + kRows - 1) / kRows);
  const int k = (N + 31) / 32;
  const long long segs = (S + seg_steps(k) - 1) / seg_steps(k);
  Work w;
  w.states = 0;
  w.bc = blocks * segs * k * kThreads * 4;
  w.s = w.bc + blocks * S * 2 * static_cast<long long>(N);
  w.total = w.s + blocks * S * 2;
  return w;
}

// What one block reads and writes.
template <typename T>
struct Rows {
  const T* x;   // x[b, h, 0, 0]
  const float* a;
  const float* dt;
  const T* b;   // B[b, 0, 0]
  const T* c;
  const float* dy;
  T* dx;
  float4* states;  // this block's saved states
  float* bc;       // this block's partial dB, dC
  float* s;        // this block's partial ddt, da
  int S, P, N, p0, rows;
};

// Stage steps t0 .. t0 + steps - 1 (all threads, between barriers): B (and
// with `back`, C) widened to fp32 and zero past N; x (and dy) of the
// block's rows, zero past P and past the segment; exp(a) of each step and of
// the one after the segment (1 past the sequence: g_S = 0 there); dt.
template <typename T, int K>
__device__ __forceinline__ void stage(float* smem, const Rows<T>& g, int t0, int steps, bool back,
                                      int tid) {
  using L = Smem<K>;
  for (int idx = tid; idx < L::kT * L::kN; idx += kThreads) {
    const int i = idx / L::kN;
    const int n = idx - i * L::kN;
    const bool in = i < steps && n < g.N;
    const long long at = static_cast<long long>(t0 + i) * g.N + n;
    smem[L::kB + idx] = in ? to_float(g.b[at]) : 0.0f;
    if (back) smem[L::kC + idx] = in ? to_float(g.c[at]) : 0.0f;
  }
  for (int idx = tid; idx < L::kT * kRows; idx += kThreads) {
    const int i = idx / kRows;
    const int r = idx - i * kRows;
    const bool in = i < steps && r < g.rows;
    const long long at = static_cast<long long>(t0 + i) * g.P + g.p0 + r;
    smem[L::kX + idx] = in ? to_float(g.x[at]) : 0.0f;
    if (back) smem[L::kDy + idx] = in ? g.dy[at] : 0.0f;
  }
  for (int i = tid; i <= L::kT; i += kThreads) {
    smem[L::kE + i] = t0 + i < g.S ? expf(g.a[t0 + i]) : 1.0f;
    if (i < L::kT) smem[L::kD + i] = i < steps ? g.dt[t0 + i] : 0.0f;
  }
}

__device__ __forceinline__ float part(const float4& v, int m) {
  return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
}

// One forward step of a thread's 4 * K entries, rounded as the forward
// kernel rounds it: exp(a) * h and dt * (x * B) each, then their sum.
template <int K>
__device__ __forceinline__ void step_state(float (&st)[K][4], const float* sB, float e, float d,
                                           float xv, int l) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float4 b4 = reinterpret_cast<const float4*>(sB)[8 * j + l];
#pragma unroll
    for (int m = 0; m < 4; ++m) st[j][m] = e * st[j][m] + d * (xv * part(b4, m));
  }
}

// The sum over a row's 8 threads (the lanes' tree's last three stages;
// a butterfly, so every thread of the row ends with the sum).
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  v += __shfl_xor_sync(kFullMask, v, 2);
  return v + __shfl_xor_sync(kFullMask, v, 4);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    ssm_bwd_rows(const T* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ dt, const T* __restrict__ bm,
                 const T* __restrict__ cm, const float* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ work, int H, int S, int P, int N) {
  using L = Smem<K>;
  constexpr int kT = L::kT;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int l = lane % kGroup;
  const int rw = lane / kGroup;              // row within the warp
  const int row = warp * kRowsPerWarp + rw;  // row within the block
  const long long bh = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  const long long blk = bh * gridDim.x + blockIdx.x;
  const int segs = (S + kT - 1) / kT;
  const Work w = work_layout(gridDim.z, H, S, P, N);
  Rows<T> g;
  g.x = x + bh * S * P;
  g.a = a + bh * S;
  g.dt = dt + bh * S;
  g.b = bm + static_cast<long long>(blockIdx.z) * S * N;
  g.c = cm + static_cast<long long>(blockIdx.z) * S * N;
  g.dy = dy + bh * S * P;
  g.dx = dx + bh * S * P;
  g.states = reinterpret_cast<float4*>(work + w.states) + blk * segs * K * kThreads;
  g.bc = work + w.bc + blk * S * 2 * static_cast<long long>(N);
  g.s = work + w.s + blk * S * 2;
  g.S = S;
  g.P = P;
  g.N = N;
  g.p0 = blockIdx.x * kRows;
  g.rows = min(kRows, P - g.p0);
  const bool live = row < g.rows;
  const float* sB = smem + L::kB;
  const float* sC = smem + L::kC;
  const float* sX = smem + L::kX;
  const float* sDy = smem + L::kDy;
  const float* sE = smem + L::kE;
  const float* sD = smem + L::kD;
  float* red = smem + L::kRed;
  float* redS = smem + L::kRedS;
  float4* hist = reinterpret_cast<float4*>(smem + L::kHist) + tid;

  // Phase 1: the forward walk; the state entering each segment saved.
  float st[K][4];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int m = 0; m < 4; ++m) st[j][m] = 0.0f;
  for (int sg = 0; sg < segs; ++sg) {
    const int t0 = sg * kT;
    const int steps = min(kT, S - t0);
#pragma unroll
    for (int j = 0; j < K; ++j)
      g.states[(static_cast<long long>(sg) * K + j) * kThreads + tid] =
          make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
    stage<T, K>(smem, g, t0, steps, false, tid);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kT; ++i)
      if (i < steps) step_state<K>(st, sB + i * L::kN, sE[i], sD[i], sX[i * kRows + row], l);
    __syncthreads();
  }

  // Phase 2: the segments in reverse.
  float gr[K][4];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int m = 0; m < 4; ++m) gr[j][m] = 0.0f;
  const bool hi0 = (rw & 1) != 0;
  const bool hi1 = (rw & 2) != 0;
  for (int sg = segs - 1; sg >= 0; --sg) {
    const int t0 = sg * kT;
    const int steps = min(kT, S - t0);
    stage<T, K>(smem, g, t0, steps, true, tid);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float4 v = g.states[(static_cast<long long>(sg) * K + j) * kThreads + tid];
      st[j][0] = v.x;
      st[j][1] = v.y;
      st[j][2] = v.z;
      st[j][3] = v.w;
      hist[j * kThreads] = v;
    }
    __syncthreads();
    // the segment's states: slot i + 1 holds the state after step t0 + i
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      if (i < steps) {
        step_state<K>(st, sB + i * L::kN, sE[i], sD[i], sX[i * kRows + row], l);
#pragma unroll
        for (int j = 0; j < K; ++j)
          hist[((i + 1) * K + j) * kThreads] = make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
      }
    }
    // back through the segment; hc is h_t (the state after step t)
    float hc[K][4];
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int m = 0; m < 4; ++m) hc[j][m] = st[j][m];
#pragma unroll
    for (int i = kT - 1; i >= 0; --i) {
      if (i >= steps) continue;
      const float en = sE[i + 1];
      const float d = sD[i];
      const float xv = sX[i * kRows + row];
      const float dyv = sDy[i * kRows + row];
      float hp[K][4];  // h_{t-1}
      float accB[4], accH[4];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float4 p4 = hist[(i * K + j) * kThreads];
        const float4 b4 = reinterpret_cast<const float4*>(sB + i * L::kN)[8 * j + l];
        const float4 c4 = reinterpret_cast<const float4*>(sC + i * L::kN)[8 * j + l];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          hp[j][m] = part(p4, m);
          gr[j][m] = en * gr[j][m] + dyv * part(c4, m);
          const float pb = gr[j][m] * part(b4, m);
          const float ph = gr[j][m] * hp[j][m];
          accB[m] = j == 0 ? pb : accB[m] + pb;
          accH[m] = j == 0 ? ph : accH[m] + ph;
        }
      }
      const float gB = row_sum((accB[0] + accB[1]) + (accB[2] + accB[3]));
      const float gh = row_sum((accH[0] + accH[1]) + (accH[2] + accH[3]));
      if (live && l == 0)
        g.dx[static_cast<long long>(t0 + i) * P + g.p0 + row] = from_float<T>(d * gB);
      // ddt and da terms over the warp's 4 rows: rows r ^ 1, then r ^ 2
      float sd = xv * gB;
      float sa = gh;
      sd += __shfl_xor_sync(kFullMask, sd, 8);
      sa += __shfl_xor_sync(kFullMask, sa, 8);
      sd += __shfl_xor_sync(kFullMask, sd, 16);
      sa += __shfl_xor_sync(kFullMask, sa, 16);
      if (lane == 0) {
        redS[(i * kWarps + warp) * 2] = sd;
        redS[(i * kWarps + warp) * 2 + 1] = sa;
      }
      // dB terms (w * g, entry c = 4 j + m) and dC terms (dy * h_t): a
      // reduce-scatter over the warp's rows.  At lane ^ 8 (row r ^ 1) a
      // thread keeps one quantity (dB if bit 0 of its row is clear) and
      // sends the other; at lane ^ 16 (row r ^ 2) it keeps half of its
      // entries.  Each thread ends with 2 K entries of one quantity, summed
      // over the warp's rows as ((r0 + r1) + (r2 + r3)).
      const float wv = d * xv;
      float r1[4 * K];
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float vb = wv * gr[j][m];
          const float vc = dyv * hc[j][m];
          r1[4 * j + m] = (hi0 ? vc : vb) + __shfl_xor_sync(kFullMask, hi0 ? vb : vc, 8);
        }
      float* dst = red + ((i * kWarps + warp) * 2 + (hi0 ? 1 : 0)) * L::kN + 4 * l;
#pragma unroll
      for (int e = 0; e < 2 * K; ++e) {
        const float keep = hi1 ? r1[2 * K + e] : r1[e];
        const float send = hi1 ? r1[e] : r1[2 * K + e];
        const float v = keep + __shfl_xor_sync(kFullMask, send, 16);
        const int c = (hi1 ? 2 * K : 0) + e;  // entry 32 (c / 4) + 4 l + c % 4
        dst[32 * (c / 4) + c % 4] = v;
      }
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int m = 0; m < 4; ++m) hc[j][m] = hp[j][m];
    }
    __syncthreads();
    // the block's partials of the segment: its 4 warps as (w0 + w1) + (w2 + w3)
    const int twoN = 2 * N;
    for (int idx = tid; idx < steps * twoN; idx += kThreads) {
      const int i = idx / twoN;
      const int qn = idx - i * twoN;
      const int q = qn >= N ? 1 : 0;
      const float* r = red + (i * kWarps * 2 + q) * L::kN + (qn - q * N);
      g.bc[static_cast<long long>(t0 + i) * twoN + qn] =
          (r[0] + r[2 * L::kN]) + (r[4 * L::kN] + r[6 * L::kN]);
    }
    for (int idx = tid; idx < steps * 2; idx += kThreads) {
      const int i = idx / 2;
      const int q = idx - 2 * i;
      const float* r = redS + i * kWarps * 2 + q;
      g.s[static_cast<long long>(t0 + i) * 2 + q] = (r[0] + r[2]) + (r[4] + r[6]);
    }
  }
}

// The blocks' partials to the outputs, one thread an output: dB and dC over
// heads and blocks (head after head, each head's blocks in order), ddt and
// da over a head's blocks, each added from the first; da times exp(a).
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    ssm_bwd_sum(const float* __restrict__ work, const float* __restrict__ a, T* __restrict__ db,
                T* __restrict__ dc, float* __restrict__ ddt, float* __restrict__ da, int B, int H,
                int S, int P, int N) {
  const Work w = work_layout(B, H, S, P, N);
  const int blocks = (P + kRows - 1) / kRows;
  const long long idx = static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  const long long row = static_cast<long long>(S) * 2 * N;   // one block's dB, dC
  const long long nbc = static_cast<long long>(B) * row;
  if (idx < nbc) {
    const long long b = idx / row;
    const long long rem = idx - b * row;                       // t * 2 N + q N + n
    const int hb = H * blocks;
    const float* p = work + w.bc + b * hb * row + rem;
    float acc = p[0];
    for (int k = 1; k < hb; ++k) acc += p[k * row];
    const long long t = rem / (2 * N);
    const int qn = static_cast<int>(rem - t * 2 * N);
    if (qn < N)
      db[(b * S + t) * N + qn] = from_float<T>(acc);
    else
      dc[(b * S + t) * N + qn - N] = from_float<T>(acc);
  } else if (idx < nbc + static_cast<long long>(B) * H * S) {
    const long long k2 = idx - nbc;           // (b * H + h) * S + t
    const long long bh = k2 / S;
    const long long t = k2 - bh * S;
    const float* p = work + w.s + (bh * blocks * S + t) * 2;
    float sd = p[0];
    float sa = p[1];
    for (int k = 1; k < blocks; ++k) {
      sd += p[static_cast<long long>(k) * S * 2];
      sa += p[static_cast<long long>(k) * S * 2 + 1];
    }
    ddt[k2] = sd;
    da[k2] = expf(a[k2]) * sa;
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* a, const void* dt, const void* bm, const void* cm,
                   const void* dy, void* dx, void* da, void* ddt, void* db, void* dc, void* work,
                   int B, int H, int S, int P, int N, cudaStream_t stream) {
  constexpr int bytes = Smem<K>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(ssm_bwd_rows<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kRows - 1) / kRows, H, B);
  ssm_bwd_rows<T, K><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<const float*>(dy),
      static_cast<T*>(dx), static_cast<float*>(work), H, S, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long outs = static_cast<long long>(B) * S * 2 * N + static_cast<long long>(B) * H * S;
  const long long sum_blocks = (outs + kSumThreads - 1) / kSumThreads;
  if (sum_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssm_bwd_sum<T><<<static_cast<unsigned>(sum_blocks), kSumThreads, 0, stream>>>(
      static_cast<const float*>(work), static_cast<const float*>(a), static_cast<T*>(db),
      static_cast<T*>(dc), static_cast<float*>(ddt), static_cast<float*>(da), B, H, S, P, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* x, const void* a, const void* dt, const void* bm, const void* cm,
                     const void* dy, void* dx, void* da, void* ddt, void* db, void* dc, void* work,
                     int B, int H, int S, int P, int N, cudaStream_t s) {
  switch ((N + 31) / 32) {
    case 1:
      return launch<T, 1>(x, a, dt, bm, cm, dy, dx, da, ddt, db, dc, work, B, H, S, P, N, s);
    case 2:
      return launch<T, 2>(x, a, dt, bm, cm, dy, dx, da, ddt, db, dc, work, B, H, S, P, N, s);
    case 3:
      return launch<T, 3>(x, a, dt, bm, cm, dy, dx, da, ddt, db, dc, work, B, H, S, P, N, s);
    case 4:
      return launch<T, 4>(x, a, dt, bm, cm, dy, dx, da, ddt, db, dc, work, B, H, S, P, N, s);
    case 5:
      return launch<T, 5>(x, a, dt, bm, cm, dy, dx, da, ddt, db, dc, work, B, H, S, P, N, s);
    case 6:
      return launch<T, 6>(x, a, dt, bm, cm, dy, dx, da, ddt, db, dc, work, B, H, S, P, N, s);
    case 7:
      return launch<T, 7>(x, a, dt, bm, cm, dy, dx, da, ddt, db, dc, work, B, H, S, P, N, s);
    case kMaxK:
      return launch<T, kMaxK>(x, a, dt, bm, cm, dy, dx, da, ddt, db, dc, work, B, H, S, P, N, s);
    default:
      return cudaErrorInvalidValue;
  }
}

bool valid(int B, int H, int S, int P, int N) {
  return B >= 1 && H >= 1 && S >= 1 && P >= 1 && N >= 1 && N <= 32 * kMaxK && B <= 65535 &&
         H <= 65535;
}

}  // namespace

// Floats of the workspace repro_ssm_scan_bwd needs for these sizes (-1 when
// the kernel does not take them).
extern "C" long long repro_ssm_scan_bwd_workspace(int B, int H, int S, int P, int N) {
  if (!valid(B, H, S, P, N)) return -1;
  return work_layout(B, H, S, P, N).total;
}

// x: (B, H, S, P) and bm, cm: (B, S, N), contiguous, of one type (dtype 0 =
// float32, 1 = bfloat16); a, dt: (B, H, S) and dy: (B, H, S, P) contiguous
// float32.  Writes dx (x's shape and type), da and ddt ((B, H, S) float32),
// db and dc (bm's shape and type); `work` holds
// repro_ssm_scan_bwd_workspace(...) floats.  Launches two kernels on
// `stream`; returns the CUDA error code of the launches (0 on success).
extern "C" int repro_ssm_scan_bwd(const void* x, const void* a, const void* dt, const void* bm,
                                  const void* cm, const void* dy, void* dx, void* da, void* ddt,
                                  void* db, void* dc, void* work, int B, int H, int S, int P,
                                  int N, int dtype, void* stream) {
  if (!valid(B, H, S, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_k<float>(x, a, dt, bm, cm, dy, dx, da, ddt, db, dc, work, B, H, S, P, N, s);
  } else if (dtype == 1) {
    err = launch_k<__nv_bfloat16>(x, a, dt, bm, cm, dy, dx, da, ddt, db, dc, work, B, H, S, P,
                                  N, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
