// Selective scan backward (Mamba2 recurrence) as the chunked SSD backward on
// Hopper's tensor cores (bf16 x, B and C; sm_90a).
//
// Replaces no TPU kernel: the reference trains through the chunked SSD form
// (src/repro/models/ssm.py:93-152) and XLA's autodiff; the port's forward is
// the ctypes kernel csrc/ssm_scan.cu, which autograd cannot see through.
// This is a redesign of csrc/ssm_scan_bwd.cu (which keeps fp32 and the other
// shapes) for bf16 at P, N <= 64: the same function, (dx, da, ddt, dB, dC)
// from x, a, dt, B, C and dy, computed in chunks of Q = 64 steps, where
// nearly all the work is 64 x 64 x 64 matrix products (wgmma).
//
// Per (batch, head) and chunk, with cs the inclusive cumulative sum of a
// inside the chunk, cs_e its last entry, L_ij = exp(cs_i - cs_j) for i >= j
// (0 above the diagonal), we_j = exp(cs_e - cs_j) and ec_i = exp(cs_i):
//
//   h_in(0) = 0,      h_in(k + 1) = exp(cs_e) h_in(k) + x^T diag(dt we) B
//   G_out(K - 1) = 0, G_out(k - 1) = exp(cs_e) G_out(k) + dy^T diag(ec) C
//   M1 = (C B^T) o L,  M2 = (dy x^T) o L                      (Q x Q)
//   gB  = M1^T dy + diag(we) B G_out^T,   dx = dt o gB,   ddt_j = x_j . gB_j
//   dB  = sum_h diag(dt) [M2^T C + diag(we) x G_out]
//   dC  = sum_h [(M2 diag(dt)) B + diag(ec) dy h_in]
//   da_t = sum over the pairs j < t <= i of exp(cs_i - cs_j) (C_i.B_j)
//          (dy_i.x_j) dt_j (global indices), which is exp(a_t) g_t . h_{t-1}:
//        = D_t + sum_{i >= t} u_i + sum_{j < t} v_j + exp(cs_e) <G_out, h_in>
//   with W_ij = (C_i.B_j)(dy_i.x_j) L_ij dt_j, c_j = sum_{i > j} W_ij,
//   r_i = sum_{j < i} W_ij, D_t = sum_{j < t} (c_j - r_j) (the pairs inside
//   the chunk), u_i = C_i . (ec_i h_in^T dy_i) (j in an earlier chunk),
//   v_j = x_j . (dt_j we_j G_out B_j) (i in a later chunk).
//
// Roundings.  x, B and C are bf16 and enter every product as they are.
// Every other operand of a product is fp32 and enters as a pair of bf16
// values, hi = bf16(v) and lo = bf16(v - hi); a product of such an operand
// with a bf16 one is hi.B + lo.B, of two such operands hi.hi + hi.lo +
// lo.hi (lo.lo dropped): about 16 bits of each operand, every sum in fp32.
// Those operands are dy (fp32; bf16-exact on the model's path, where y only
// reaches the loss through y.to(bf16), so there lo = 0), the weighted B
// and C of the chunk states (B dt we, C ec), M1, M2 and M2 diag(dt), and the
// states h_in and G_out.  One bf16 rounding of each instead puts 1-6% of the
// entries outside SSM_TOL of the fp32 scan (bf16 states alone 0.04-0.6%),
// which no bf16 output rounding excuses.  W, c, r, u, v, ddt, da and the
// state recurrences are fp32; exp is expf, but L's entries are exp2 of
// differences of cs log2(e) (ex2.approx, ~2 ulp).  dx, dB and dC are
// rounded once to bf16.  kernels/ssm_scan.py: ssm_scan_bwd_chunked_plain(...,
// operands="bf16") spells these roundings.
//
// Three kernels, no atomics: the result is the same from run to run.
//   1. ssm_tc_states, a block (one warpgroup) per (head, batch, direction),
//      walks the chunks in order (h_in) or in reverse (G_out): the chunk's
//      x (or dy as hi / lo) and weighted B (or C) staged as they lie, rows
//      of steps (the MN-major operands of x^T B), the product accumulated
//      onto exp(cs_e) times the state in registers, the state entering each
//      chunk stored to the workspace (fp32, 16 KB a chunk).  The next
//      chunk is staged into a second buffer while this chunk's product
//      runs; its loads were issued two chunks ahead.
//   2. ssm_tc_chunk, a block (one warpgroup) per (chunk, group of heads,
//      batch; one wave of two blocks a SM): B and C staged once; per head
//      of the group, in order, x, dy, h_in and G_out staged (the fp32 ones
//      as hi / lo tiles; all of a head's loads issued before any store), then
//      ten products of 64 x 64 x 64 (two to four wgmmas each): B C^T and
//      x dy^T in (j, i), whose masked and scaled forms are the register A
//      operands of gB and of dB; C B^T and dy x^T in (i, j), for dC; B
//      G_out^T, x G_out and dy h_in.  dx, ddt and da are written per head;
//      dB and dC are summed over the group's heads in registers, in order,
//      and written as the group's fp32 partials.
//   3. ssm_tc_sum adds the groups' partials in order and rounds dB, dC.
//
// Bound on this card.  Bytes: x, dy, dx (bf16, fp32, bf16: 8 bytes an entry
// of x) and a, dt, da, ddt, B, C, dB, dC: 175.1 MB at zamba2's training
// shape (B=1, H=80, S=4096, P=N=64), 0.052 ms at 3.35 TB/s.  Tensor-core
// work the function needs, in bf16 passes of 64 x 64 x 64 (an fp32
// operand as hi / lo takes two, two such operands three): a (head, chunk)
// h_in 2, G_out 3, x dy^T 2, M1^T dy 3, B G_out^T 2, M2^T C 2, x G_out 2,
// (M2 dt) B 2, dy h_in 3, that is 21, or 17 where dy is bf16-exact (no lo
// part); and one B C^T a (batch, chunk).  At that shape 56.4 GFLOP, 0.057
// ms at 989 TFLOP/s, with fp32 dy; 45.7 GFLOP, 0.046 ms, on the model's
// path, where the bytes bound binds.  The code does 25 a (head, chunk): it
// forms B C^T per head, C B^T and dy x^T as products rather than reading
// the (j, i) ones back transposed, and dy's lo products where they are
// zero; forming B C^T once, transposing through shared memory and
// skipping the zero products each measured slower on the card, not
// faster (most of the time is not in wgmma).  The workspace (the states,
// 168 MB, written once and read once; the groups' partials) adds 0.1 ms
// of traffic to the bytes bound's 0.05.

#include <math.h>

#include "hopper_tc.cuh"

namespace {

using namespace hopper;

constexpr int kQ = 64;                   // steps of a chunk
constexpr int kW = 64;                   // rows and columns of every tile
constexpr int kThreads = 128;            // one warpgroup
constexpr int kTile = kW * kRowBytes;    // a 64 x 64 bf16 tile: 8 KB
constexpr int kState = kW * kW;          // floats of a state in the workspace
constexpr int kSumThreads = 256;
constexpr int kTargetBlocks = 2 * 132;   // ssm_tc_chunk's grid: one wave, two a SM
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of ssm_tc_chunk: nine tiles, then per-step arrays.
struct ChunkSmem {
  static constexpr int kB = 0, kC = 1, kX = 2, kDyH = 3, kDyL = 4, kHH = 5, kHL = 6, kGH = 7,
                       kGL = 8, kTiles = 9;
  static constexpr int kArr = kTiles * kTile;  // float arrays of 64
  enum { kA, kDt, kCs, kCs2, kEc, kWe, kCp, kRp, kU, kV, kDdt, kArrays };
  static constexpr int kRed = kArr + kArrays * kQ * 4;  // 4 warps' partial sums
  static constexpr int kAlloc = kRed + 16 + 1024;
};

// Shared memory of ssm_tc_states: two buffers of four tiles (A hi, A lo, B
// hi, B lo).
constexpr int kStatesAlloc = 8 * kTile + 1024;

// Byte offset of element (r, c) of a 128-byte-swizzled 64 x 64 bf16 tile:
// 16-byte unit c / 8 of row r at unit (c / 8) ^ (r % 8), as TMA writes it.
__device__ __forceinline__ int sw(int r, int c) {
  return r * kRowBytes + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

// Generic-proxy writes of shared memory made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t kmaj(uint32_t tile, int ks) {
  return sw128_desc(tile + ks * 32, 16);
}
__device__ __forceinline__ uint64_t mnmaj(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * kRowBytes, kTile);
}

// D (64 x 64, fp32) += A (64 x 16) B (16 x 64), both bf16 in shared memory:
// A K-major (TA = 0: rows M, columns K) or MN-major (TA = 1: rows K), B
// K-major (TB = 0: rows N, columns K) or MN-major (TB = 1: rows K).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d = 0, then d += A B^T over the 4 k16 slices of each (A, B) pair given
// (K-major tiles, or MN-major B with TB = 1): one commit group, waited for.
template <int TB>
__device__ __forceinline__ void product(float (&d)[32], const uint32_t* a, const uint32_t* b,
                                        int pairs) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  fence_regs(d);
  wgmma_fence();
  for (int q = 0; q < pairs; ++q)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<0, TB>(d, kmaj(a[q], ks), TB ? mnmaj(b[q], ks) : kmaj(b[q], ks));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
}

// A register operand (64 x 64 in the accumulator layout) as bf16 hi / lo
// fragments: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split_frags(const float (&s)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v0 = s[8 * kk + 2 * r], v1 = s[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      const float2 hf = __bfloat1622float2(h);
      const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = *reinterpret_cast<const uint32_t*>(&l);
    }
}

// d = (hi + lo) B with B MN-major in shared memory; with two B tiles (bh,
// bl: hi and lo of an fp32 operand) also + hi bl.
__device__ __forceinline__ void product_rs(float (&d)[32], uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4], uint32_t bh, uint32_t bl,
                                           bool split_b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  fence_regs(d);
  fence_frags(hi);
  fence_frags(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) RsMma<64>::mma(d, hi[kk], mnmaj(bh, kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) RsMma<64>::mma(d, lo[kk], mnmaj(bh, kk));
  if (split_b)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) RsMma<64>::mma(d, hi[kk], mnmaj(bl, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  fence_frags(hi);
  fence_frags(lo);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  __nv_bfloat162 v;
  v.x = a;
  v.y = b;
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void split8(const float (&v)[8], uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat16 h0 = __float2bfloat16(v[2 * e]);
    const __nv_bfloat16 h1 = __float2bfloat16(v[2 * e + 1]);
    h[e] = pack2(h0, h1);
    l[e] = pack2(__float2bfloat16(v[2 * e] - __bfloat162float(h0)),
                 __float2bfloat16(v[2 * e + 1] - __bfloat162float(h1)));
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// Rows 0 .. rows-1, columns 0 .. cols-1 (a multiple of 8) of a bf16 matrix
// with row stride ld into a 64 x 64 tile, zeros elsewhere.  Thread tid
// takes 16-byte unit tid % 8 of rows tid / 8 + 16 m.
__device__ __forceinline__ void tile_bf16(uint8_t* tile, const __nv_bfloat16* src, int rows,
                                          int cols, long long ld, int tid) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = tid / 8 + 16 * m, u = tid % 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && u * 8 < cols) v = __ldg(reinterpret_cast<const uint4*>(src + r * ld + u * 8));
    *reinterpret_cast<uint4*>(tile + r * kRowBytes + ((u ^ (r & 7)) << 4)) = v;
  }
}

// Scans over a warp holding 64 steps, two a lane (steps 2 lane, 2 lane +
// 1).  The sum of the lanes before this one of each lane's `pair`.
__device__ __forceinline__ float lanes_before(float pair, int lane) {
  float incl = pair;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = v + incl;
  }
  const float excl = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? 0.0f : excl;
}

// The inclusive cumulative sums cs0, cs1 of this lane's steps (a0, a1 its
// terms).
__device__ __forceinline__ void cumsum2(float a0, float a1, int lane, float& cs0, float& cs1) {
  const float pair = a0 + a1;
  const float excl = lanes_before(pair, lane);
  cs0 = excl + a0;
  cs1 = excl + pair;
}

// The exclusive prefix sums of v[0 .. 63] at this lane's steps.
__device__ __forceinline__ void warp_prefix(const float* v, int lane, float& p0, float& p1) {
  const float e0 = v[2 * lane];
  p0 = lanes_before(e0 + v[2 * lane + 1], lane);
  p1 = p0 + e0;
}

// The inclusive suffix sums of v[0 .. 63] at this lane's steps.
__device__ __forceinline__ void warp_suffix(const float* v, int lane, float& s0, float& s1) {
  const float e0 = v[2 * lane], e1 = v[2 * lane + 1];
  float incl = e0 + e1;  // sum over lanes >= lane
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float w = __shfl_down_sync(kFull, incl, o);
    if (lane + o < 32) incl = incl + w;
  }
  float after = __shfl_down_sync(kFull, incl, 1);
  if (lane == 31) after = 0.0f;
  s1 = e1 + after;
  s0 = e0 + s1;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// ------------------------------------------------------------ 1. states
// Chunk k's raw inputs, loaded into registers an iteration ahead of their
// use: 16-byte units (row t = tid / 8 + 16 m, unit tid % 8) of x (DIR 0)
// or dy (DIR 1; fp32, two float4) and of B or C; a and dt of steps 2 lane
// and 2 lane + 1 (each warp loads all 64).
struct Raw {
  uint4 xb[4];
  float4 yf[8];
  uint4 m[4];
  float a[2], dt[2];
};

template <int DIR>
__device__ __forceinline__ void load_raw(Raw& raw, const __nv_bfloat16* x, const float* dy,
                                         const __nv_bfloat16* bc, const float* a, const float* dt,
                                         int t0, int S, int P, int N, int tid) {
  const int steps = min(kQ, S - t0);
  const int lane = tid % 32;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = tid / 8 + 16 * m, u = tid % 8;
    const bool in_p = r < steps && u * 8 < P;
    if (DIR == 0) {
      raw.xb[m] = in_p ? __ldg(reinterpret_cast<const uint4*>(x + (t0 + r) * (long long)P + u * 8))
                       : make_uint4(0u, 0u, 0u, 0u);
    } else {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* p = dy + (t0 + r) * (long long)P + u * 8;
      raw.yf[2 * m] = in_p ? __ldg(reinterpret_cast<const float4*>(p)) : z;
      raw.yf[2 * m + 1] = in_p ? __ldg(reinterpret_cast<const float4*>(p + 4)) : z;
    }
    raw.m[m] = r < steps && u * 8 < N
                   ? __ldg(reinterpret_cast<const uint4*>(bc + (t0 + r) * (long long)N + u * 8))
                   : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    raw.a[e] = t < steps ? __ldg(a + t0 + t) : 0.0f;
    raw.dt[e] = t < steps ? __ldg(dt + t0 + t) : 0.0f;
  }
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 p = __bfloat1622float2(h[e]);
    f[2 * e] = p.x;
    f[2 * e + 1] = p.y;
  }
}

// Stage a chunk from `raw` into the tiles ah, al (A: x, or dy as hi / lo;
// rows t, columns p: the MN-major form of x^T, dy^T) and bh, bl (B dt we or
// C ec as hi / lo; rows t, columns n: MN-major).  Each warp takes the
// cumulative sum of a itself (two steps a lane, then a shuffle scan).
// Returns exp(cs_e).
template <int DIR>
__device__ __forceinline__ float stage(const Raw& raw, uint8_t* ah, uint8_t* al, uint8_t* bh,
                                       uint8_t* bl, int tid) {
  const int lane = tid % 32;
  float cs0, cs1;
  cumsum2(raw.a[0], raw.a[1], lane, cs0, cs1);
  const float cse = __shfl_sync(kFull, cs1, 31);
  const float wt0 = DIR == 0 ? raw.dt[0] * expf(cse - cs0) : expf(cs0);
  const float wt1 = DIR == 0 ? raw.dt[1] * expf(cse - cs1) : expf(cs1);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int t = tid / 8 + 16 * m, u = tid % 8;
    const float w0 = __shfl_sync(kFull, wt0, t / 2), w1 = __shfl_sync(kFull, wt1, t / 2);
    const float w = (t & 1) ? w1 : w0;
    const int at = t * kRowBytes + ((u ^ (t & 7)) << 4);
    uint4 h, l;
    if (DIR == 0) {
      *reinterpret_cast<uint4*>(ah + at) = raw.xb[m];
    } else {
      const float4 y0 = raw.yf[2 * m], y1 = raw.yf[2 * m + 1];
      const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
      split8(yv, h, l);
      *reinterpret_cast<uint4*>(ah + at) = h;
      *reinterpret_cast<uint4*>(al + at) = l;
    }
    float f[8];
    unpack8(raw.m[m], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = f[e] * w;
    split8(f, h, l);
    *reinterpret_cast<uint4*>(bh + at) = h;
    *reinterpret_cast<uint4*>(bl + at) = l;
  }
  return expf(cse);
}

// One (batch, head)'s walk: DIR 0 the chunks in order, storing h_in of
// each; DIR 1 in reverse, storing G_out.  Two buffers of four tiles: the
// next chunk is staged while this chunk's product runs.  Two register
// sets of raw inputs: a chunk's loads are issued two iterations before it
// is staged.
template <int DIR>
__device__ __forceinline__ void walk(const __nv_bfloat16* xp, const float* dyp,
                                     const __nv_bfloat16* mp, const float* ap, const float* dtp,
                                     float* out, int S, int P, int N, uint8_t* sm, uint32_t base) {
  const int tid = threadIdx.x, lane = tid % 32;
  const int K = (S + kQ - 1) / kQ;
  const int r0 = (tid / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  auto chunk = [&](int it) { return DIR == 0 ? it : K - 1 - it; };
  auto load = [&](Raw& raw, int it) {
    load_raw<DIR>(raw, xp, dyp, mp, ap, dtp, chunk(it) * kQ, S, P, N, tid);
  };
  auto put = [&](const Raw& raw, int buf) {
    uint8_t* t = sm + buf * 4 * kTile;
    return stage<DIR>(raw, t, t + kTile, t + 2 * kTile, t + 3 * kTile, tid);
  };
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  Raw ra, rb;  // chunks of even and odd iterations
  load(ra, 0);
  if (K > 1) load(rb, 1);
  float ee = put(ra, 0);
  if (K > 2) load(ra, 2);
  fence_async_smem();
  __syncthreads();
  // iteration it: store the state entering chunk(it), issue its product,
  // stage chunk(it + 1) from `next`, load chunk(it + 3) into it
  auto step = [&](int it, Raw& next) {
    const int k = chunk(it);
    float* st = out + static_cast<long long>(k) * kState;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(st + (r0 + 8 * i) * kW + 8 * nb + c0) =
            make_float2(acc[4 * nb + 2 * i], acc[4 * nb + 2 * i + 1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = ee * acc[i];
    fence_regs(acc);
    wgmma_fence();
    const uint32_t tb = base + (it & 1) * 4 * kTile;  // A hi, A lo, B hi, B lo
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_ss<1, 1>(acc, mnmaj(tb, ks), mnmaj(tb + 2 * kTile, ks));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_ss<1, 1>(acc, mnmaj(tb, ks), mnmaj(tb + 3 * kTile, ks));
    if (DIR == 1)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss<1, 1>(acc, mnmaj(tb + kTile, ks), mnmaj(tb + 2 * kTile, ks));
    wgmma_commit();
    if (it + 1 < K) {
      ee = put(next, (it + 1) & 1);
      if (it + 3 < K) load(next, it + 3);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_async_smem();
    __syncthreads();
  };
  for (int it = 0; it < K; it += 2) {
    step(it, rb);
    if (it + 1 < K) step(it + 1, ra);
  }
}

// h_in of every chunk (the grid's z = 0) or G_out (z = 1) of one (batch,
// head), each stored to its workspace plane before the chunk adds to it.
__global__ void __launch_bounds__(kThreads)
    ssm_tc_states(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ dt, const __nv_bfloat16* __restrict__ bm,
                  const __nv_bfloat16* __restrict__ cm, const float* __restrict__ dy,
                  float* __restrict__ hin, float* __restrict__ gout, int H, int S, int P, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(sm);
  const int h = blockIdx.x, b = blockIdx.y;
  const long long bh = static_cast<long long>(b) * H + h;
  const int K = (S + kQ - 1) / kQ;
  const long long seq = static_cast<long long>(b) * S * N;
  if (blockIdx.z == 0)
    walk<0>(x + bh * S * P, dy + bh * S * P, bm + seq, a + bh * S, dt + bh * S,
            hin + bh * K * kState, S, P, N, sm, base);
  else
    walk<1>(x + bh * S * P, dy + bh * S * P, cm + seq, a + bh * S, dt + bh * S,
            gout + bh * K * kState, S, P, N, sm, base);
}

// ------------------------------------------------------------ 2. chunks
// One head's raw inputs for a chunk, in registers: 16-byte units (row
// tid / 8 + 16 m, unit tid % 8) of x, dy, h_in and G_out; a and dt of step
// tid (tid < steps).
struct HeadRaw {
  uint4 x[4];
  float4 dy[8], hs[8], gs[8];
  float a, dt;
};

__device__ __forceinline__ void load_head(HeadRaw& r, const __nv_bfloat16* x, const float* dy,
                                          const float* a, const float* dt, const float* hin,
                                          const float* gout, long long row0, long long st,
                                          int steps, int P, int tid) {
  r.a = tid < steps ? __ldg(a + row0 + tid) : 0.0f;  // steps <= kQ
  r.dt = tid < steps ? __ldg(dt + row0 + tid) : 0.0f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = tid / 8 + 16 * m, u = tid % 8;
    const bool in = row < steps && u * 8 < P;
    const long long at = (row0 + row) * P + u * 8;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    r.x[m] = in ? __ldg(reinterpret_cast<const uint4*>(x + at)) : make_uint4(0u, 0u, 0u, 0u);
    r.dy[2 * m] = in ? __ldg(reinterpret_cast<const float4*>(dy + at)) : z;
    r.dy[2 * m + 1] = in ? __ldg(reinterpret_cast<const float4*>(dy + at + 4)) : z;
    const long long sat = st + row * kW + u * 8;
    r.hs[2 * m] = __ldg(reinterpret_cast<const float4*>(hin + sat));
    r.hs[2 * m + 1] = __ldg(reinterpret_cast<const float4*>(hin + sat + 4));
    r.gs[2 * m] = __ldg(reinterpret_cast<const float4*>(gout + sat));
    r.gs[2 * m + 1] = __ldg(reinterpret_cast<const float4*>(gout + sat + 4));
  }
}

__device__ __forceinline__ void unpack(const float4& lo4, const float4& hi4, float (&v)[8]) {
  v[0] = lo4.x, v[1] = lo4.y, v[2] = lo4.z, v[3] = lo4.w;
  v[4] = hi4.x, v[5] = hi4.y, v[6] = hi4.z, v[7] = hi4.w;
}

__global__ void __launch_bounds__(kThreads)
    ssm_tc_chunk(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ dt, const __nv_bfloat16* __restrict__ bm,
                 const __nv_bfloat16* __restrict__ cm, const float* __restrict__ dy,
                 const float* __restrict__ hin, const float* __restrict__ gout,
                 __nv_bfloat16* __restrict__ dx, float* __restrict__ da, float* __restrict__ ddt,
                 float* __restrict__ part, int H, int S, int P, int N, int HG) {
  using L = ChunkSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(sm);
  auto tile = [&](int i) { return sm + i * kTile; };
  auto tadr = [&](int i) { return base + i * kTile; };
  float* arr = reinterpret_cast<float*>(sm + L::kArr);
  float* sa = arr + L::kA * kQ;
  float* sdt = arr + L::kDt * kQ;
  float* scs = arr + L::kCs * kQ;
  float* scs2 = arr + L::kCs2 * kQ;  // cs log2(e): L = exp2(cs2_i - cs2_j)
  float* sec = arr + L::kEc * kQ;
  float* swe = arr + L::kWe * kQ;
  float* scp = arr + L::kCp * kQ;
  float* srp = arr + L::kRp * kQ;
  float* su = arr + L::kU * kQ;
  float* sv = arr + L::kV * kQ;
  float* sddt = arr + L::kDdt * kQ;
  float* red = reinterpret_cast<float*>(sm + L::kRed);

  const int k = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int K = (S + kQ - 1) / kQ;
  const int t0 = k * kQ, steps = min(kQ, S - t0);
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int h_lo = g * HG, h_hi = min(H, h_lo + HG);

  tile_bf16(tile(L::kB), bm + (static_cast<long long>(b) * S + t0) * N, steps, N, N, tid);
  tile_bf16(tile(L::kC), cm + (static_cast<long long>(b) * S + t0) * N, steps, N, N, tid);

  float dbs[32], dcs[32];  // dB, dC summed over the group's heads
#pragma unroll
  for (int i = 0; i < 32; ++i) dbs[i] = dcs[i] = 0.0f;
  float acc_a[32], acc_b[32];
  uint32_t fh[4][4], fl[4][4], gh2[4][4], gl2[4][4];

  for (int h = h_lo; h < h_hi; ++h) {
    const long long bh = static_cast<long long>(b) * H + h;
    const long long row0 = bh * S + t0;  // (b, h, t0) in x, dy, dx, a, dt
    // the head's loads, all issued before any is stored
    HeadRaw raw;
    load_head(raw, x, dy, a, dt, hin, gout, row0, (bh * K + k) * kState, steps, P, tid);
    if (tid < kQ) {
      sa[tid] = raw.a;
      sdt[tid] = raw.dt;
    }
    float gh = 0.0f;  // this thread's share of <G_out, h_in>
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = tid / 8 + 16 * m, u = tid % 8;
      const int at = r * kRowBytes + ((u ^ (r & 7)) << 4);
      *reinterpret_cast<uint4*>(tile(L::kX) + at) = raw.x[m];
      uint4 hv, lv;
      float yv[8], hs[8], gs[8];
      unpack(raw.dy[2 * m], raw.dy[2 * m + 1], yv);
      split8(yv, hv, lv);
      *reinterpret_cast<uint4*>(tile(L::kDyH) + at) = hv;
      *reinterpret_cast<uint4*>(tile(L::kDyL) + at) = lv;
      unpack(raw.hs[2 * m], raw.hs[2 * m + 1], hs);
      split8(hs, hv, lv);
      *reinterpret_cast<uint4*>(tile(L::kHH) + at) = hv;
      *reinterpret_cast<uint4*>(tile(L::kHL) + at) = lv;
      unpack(raw.gs[2 * m], raw.gs[2 * m + 1], gs);
      split8(gs, hv, lv);
      *reinterpret_cast<uint4*>(tile(L::kGH) + at) = hv;
      *reinterpret_cast<uint4*>(tile(L::kGL) + at) = lv;
#pragma unroll
      for (int e = 0; e < 8; ++e) gh = gh + gs[e] * hs[e];
    }
    gh += __shfl_xor_sync(kFull, gh, 16);
    gh += __shfl_xor_sync(kFull, gh, 8);
    gh += __shfl_xor_sync(kFull, gh, 4);
    gh += __shfl_xor_sync(kFull, gh, 2);
    gh += __shfl_xor_sync(kFull, gh, 1);
    if (lane == 0) red[warp] = gh;
    fence_async_smem();
    __syncthreads();
    if (warp == 0) {
      cumsum2(sa[2 * lane], sa[2 * lane + 1], lane, scs[2 * lane], scs[2 * lane + 1]);
      __syncwarp();
      const float cse = scs[kQ - 1];
      for (int t = lane; t < kQ; t += 32) {
        sec[t] = expf(scs[t]);
        swe[t] = expf(cse - scs[t]);
        scs2[t] = scs[t] * kLog2e;
      }
    }
    __syncthreads();
    const float cse = scs[kQ - 1];
    float csr[2], dtr[2], wer[2];  // of this thread's rows r0, r0 + 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      csr[i] = scs2[r0 + 8 * i];
      dtr[i] = sdt[r0 + 8 * i];
      wer[i] = swe[r0 + 8 * i];
    }

    // A. (j, i): acc_b = B C^T, acc_a = x dy^T.  c_j, and the register
    // operands M1^T = acc_b o L^T (fh, fl) and M2^T = acc_a o L^T (gh2, gl2).
    {
      const uint32_t ta[1] = {tadr(L::kB)}, tb[1] = {tadr(L::kC)};
      product<0>(acc_b, ta, tb, 1);
      const uint32_t xa[2] = {tadr(L::kX), tadr(L::kX)}, ya[2] = {tadr(L::kDyH), tadr(L::kDyL)};
      product<0>(acc_a, xa, ya, 2);
      float cpart[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int e = 4 * nb + 2 * i + jj;
            const int j = r0 + 8 * i, col = 8 * nb + c0 + jj;  // (j, i = col)
            const float l = col >= j ? ex2(scs2[col] - csr[i]) : 0.0f;
            const float w = acc_b[e] * acc_a[e] * l * dtr[i];
            if (col > j) cpart[i] = cpart[i] + w;
            acc_b[e] = acc_b[e] * l;
            acc_a[e] = acc_a[e] * l;
          }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float c = quad_sum(cpart[i]);
        if (lane % 4 == 0) scp[r0 + 8 * i] = c;
      }
      split_frags(acc_b, fh, fl);
      split_frags(acc_a, gh2, gl2);
    }
    // B. (j, p): acc_a = M1^T dy, acc_b = B G_out^T.  dx, ddt, v.
    {
      product_rs(acc_a, fh, fl, tadr(L::kDyH), tadr(L::kDyL), true);
      const uint32_t ta[2] = {tadr(L::kB), tadr(L::kB)}, tb[2] = {tadr(L::kGH), tadr(L::kGL)};
      product<0>(acc_b, ta, tb, 2);
      float sd[2] = {0.0f, 0.0f}, sv2[2] = {0.0f, 0.0f};
      const uint8_t* tx = tile(L::kX);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int j = r0 + 8 * i, p = 8 * nb + c0;
          const float2 xv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tx + sw(j, p)));
          const float gb0 = acc_a[4 * nb + 2 * i] + wer[i] * acc_b[4 * nb + 2 * i];
          const float gb1 = acc_a[4 * nb + 2 * i + 1] + wer[i] * acc_b[4 * nb + 2 * i + 1];
          sd[i] = sd[i] + xv.x * gb0 + xv.y * gb1;
          const float dw = dtr[i] * wer[i];
          sv2[i] = sv2[i] + xv.x * (dw * acc_b[4 * nb + 2 * i]) +
                   xv.y * (dw * acc_b[4 * nb + 2 * i + 1]);
          if (j < steps && p < P)
            *reinterpret_cast<__nv_bfloat162*>(dx + (row0 + j) * P + p) =
                __floats2bfloat162_rn(dtr[i] * gb0, dtr[i] * gb1);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float d = quad_sum(sd[i]), v = quad_sum(sv2[i]);
        if (lane % 4 == 0) {
          sddt[r0 + 8 * i] = d;
          sv[r0 + 8 * i] = v;
        }
      }
    }
    // C. (j, n): acc_a = M2^T C, acc_b = x G_out.  dB += dt (acc_a + we acc_b).
    {
      product_rs(acc_a, gh2, gl2, tadr(L::kC), 0, false);
      const uint32_t ta[2] = {tadr(L::kX), tadr(L::kX)}, tb[2] = {tadr(L::kGH), tadr(L::kGL)};
      product<1>(acc_b, ta, tb, 2);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        dbs[e] = dbs[e] + dtr[i] * (acc_a[e] + wer[i] * acc_b[e]);
      }
    }
    // D. (i, j): acc_a = dy x^T, acc_b = C B^T.  r_i, and the register
    // operand (acc_a o L) diag(dt) (fh, fl).
    {
      const uint32_t ya[2] = {tadr(L::kDyH), tadr(L::kDyL)}, xa[2] = {tadr(L::kX), tadr(L::kX)};
      product<0>(acc_a, ya, xa, 2);
      const uint32_t ta[1] = {tadr(L::kC)}, tb[1] = {tadr(L::kB)};
      product<0>(acc_b, ta, tb, 1);
      float rpart[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int e = 4 * nb + 2 * i + jj;
            const int row = r0 + 8 * i, j = 8 * nb + c0 + jj;  // (i = row, j)
            const float l = j <= row ? ex2(csr[i] - scs2[j]) : 0.0f;
            const float d = sdt[j];
            const float w = acc_b[e] * acc_a[e] * l * d;
            if (j < row) rpart[i] = rpart[i] + w;
            acc_a[e] = acc_a[e] * l * d;
          }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float r = quad_sum(rpart[i]);
        if (lane % 4 == 0) srp[r0 + 8 * i] = r;
      }
      split_frags(acc_a, fh, fl);
    }
    // E. (i, n): acc_a = (M2 diag(dt)) B, acc_b = dy h_in.  dC += acc_a +
    // ec acc_b; u.
    {
      product_rs(acc_a, fh, fl, tadr(L::kB), 0, false);
      const uint32_t ya[3] = {tadr(L::kDyH), tadr(L::kDyH), tadr(L::kDyL)};
      const uint32_t hb[3] = {tadr(L::kHH), tadr(L::kHL), tadr(L::kHH)};
      product<1>(acc_b, ya, hb, 3);
      float up[2] = {0.0f, 0.0f};
      const uint8_t* tc = tile(L::kC);
      float ecr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) ecr[i] = sec[r0 + 8 * i];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + 8 * i, n = 8 * nb + c0;
          const float2 cv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tc + sw(row, n)));
          const int e = 4 * nb + 2 * i;
          const float o0 = ecr[i] * acc_b[e], o1 = ecr[i] * acc_b[e + 1];
          dcs[e] = dcs[e] + (acc_a[e] + o0);
          dcs[e + 1] = dcs[e + 1] + (acc_a[e + 1] + o1);
          up[i] = up[i] + cv.x * o0 + cv.y * o1;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float u = quad_sum(up[i]);
        if (lane % 4 == 0) su[r0 + 8 * i] = u;
      }
    }
    __syncthreads();
    // da and ddt of the chunk's steps (warp 0, two steps a lane).
    if (warp == 0) {
      const float t4 = expf(cse) * (((red[0] + red[1]) + red[2]) + red[3]);
      float q[2];
      for (int e = 0; e < 2; ++e) q[e] = scp[2 * lane + e] - srp[2 * lane + e];
      __syncwarp();
      for (int e = 0; e < 2; ++e) sa[2 * lane + e] = q[e];  // a is spent
      __syncwarp();
      float d0, d1, v0, v1, u0, u1;
      warp_prefix(sa, lane, d0, d1);
      warp_prefix(sv, lane, v0, v1);
      warp_suffix(su, lane, u0, u1);
      const float dav[2] = {((d0 + u0) + v0) + t4, ((d1 + u1) + v1) + t4};
      for (int e = 0; e < 2; ++e) {
        const int t = 2 * lane + e;
        if (t < steps) {
          da[row0 + t] = dav[e];
          ddt[row0 + t] = sddt[t];
        }
      }
    }
    __syncthreads();
  }
  // the group's dB and dC partials: part[b][g][t][2 N]
  float* pp = part + ((static_cast<long long>(b) * gridDim.y + g) * S + t0) * 2 * N;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i, n = 8 * nb + c0;
      if (row < steps && n < N) {
        const int e = 4 * nb + 2 * i;
        *reinterpret_cast<float2*>(pp + row * 2 * N + n) = make_float2(dbs[e], dbs[e + 1]);
        *reinterpret_cast<float2*>(pp + row * 2 * N + N + n) = make_float2(dcs[e], dcs[e + 1]);
      }
    }
}

// ------------------------------------------------------------ 3. sum
__global__ void __launch_bounds__(kSumThreads)
    ssm_tc_sum(const float* __restrict__ part, __nv_bfloat16* __restrict__ db,
               __nv_bfloat16* __restrict__ dc, int B, int S, int N, int G) {
  const long long idx = static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  const long long per_b = static_cast<long long>(S) * 2 * N;
  if (idx >= B * per_b) return;
  const long long b = idx / per_b;
  const long long rem = idx - b * per_b;  // t * 2 N + q N + n
  const float* p = part + b * G * per_b + rem;
  float acc = p[0];
  for (int g = 1; g < G; ++g) acc = acc + p[g * per_b];
  const long long t = rem / (2 * N);
  const int qn = static_cast<int>(rem - t * 2 * N);
  if (qn < N)
    db[(b * S + t) * N + qn] = __float2bfloat16(acc);
  else
    dc[(b * S + t) * N + qn - N] = __float2bfloat16(acc);
}

struct Plan {
  int K, HG, G;
  long long states, part, total;  // floats: offsets and size of the workspace
};

Plan plan(int B, int H, int S, int N) {
  Plan p;
  p.K = (S + kQ - 1) / kQ;
  const long long chunks = static_cast<long long>(p.K) * B;
  long long g = kTargetBlocks / chunks;  // groups of heads: at most one wave
  if (g < 1) g = 1;
  if (g > H) g = H;
  p.HG = (H + g - 1) / g;
  p.G = (H + p.HG - 1) / p.HG;
  p.states = static_cast<long long>(B) * H * p.K * kState;
  p.part = 2 * p.states;
  p.total = p.part + static_cast<long long>(B) * p.G * S * 2 * N;
  return p;
}

bool valid(int B, int H, int S, int P, int N) {
  return B >= 1 && H >= 1 && S >= 1 && B <= 65535 && H <= 65535 && P >= 8 && P <= kW &&
         P % 8 == 0 && N >= 8 && N <= kW && N % 8 == 0;
}

}  // namespace

// Floats of the workspace repro_ssm_scan_bwd_tc needs for these sizes (-1
// when the kernel does not take them).
extern "C" long long repro_ssm_scan_bwd_tc_workspace(int B, int H, int S, int P, int N) {
  if (!valid(B, H, S, P, N)) return -1;
  return plan(B, H, S, N).total;
}

// x: (B, H, S, P) bf16; a, dt: (B, H, S) fp32; bm, cm: (B, S, N) bf16; dy:
// (B, H, S, P) fp32; all contiguous, P and N multiples of 8 up to 64.
// Writes dx (x's shape, bf16), da and ddt ((B, H, S) fp32), db and dc (bm's
// shape, bf16); `work` holds repro_ssm_scan_bwd_tc_workspace(...) floats.
// Launches three kernels on `stream`; returns the CUDA error code of the
// launches (0 on success).
extern "C" int repro_ssm_scan_bwd_tc(const void* x, const void* a, const void* dt, const void* bm,
                                     const void* cm, const void* dy, void* dx, void* da,
                                     void* ddt, void* db, void* dc, void* work, int B, int H,
                                     int S, int P, int N, void* stream) {
  if (!valid(B, H, S, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan pl = plan(B, H, S, N);
  float* ws = static_cast<float*>(work);
  cudaError_t err = cudaFuncSetAttribute(ssm_tc_states,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kStatesAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssm_tc_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ChunkSmem::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* af = static_cast<const float*>(a);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* bb = static_cast<const __nv_bfloat16*>(bm);
  const auto* cb = static_cast<const __nv_bfloat16*>(cm);
  const auto* dyf = static_cast<const float*>(dy);
  ssm_tc_states<<<dim3(H, B, 2), kThreads, kStatesAlloc, s>>>(
      xb, af, dtf, bb, cb, dyf, ws, ws + pl.states, H, S, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_tc_chunk<<<dim3(pl.K, pl.G, B), kThreads, ChunkSmem::kAlloc, s>>>(
      xb, af, dtf, bb, cb, dyf, ws, ws + pl.states, static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(da), static_cast<float*>(ddt), ws + pl.part, H, S, P, N, pl.HG);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long outs = static_cast<long long>(B) * S * 2 * N;
  const long long blocks = (outs + kSumThreads - 1) / kSumThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssm_tc_sum<<<static_cast<unsigned>(blocks), kSumThreads, 0, s>>>(
      ws + pl.part, static_cast<__nv_bfloat16*>(db), static_cast<__nv_bfloat16*>(dc), B, S, N,
      pl.G);
  return static_cast<int>(cudaGetLastError());
}
