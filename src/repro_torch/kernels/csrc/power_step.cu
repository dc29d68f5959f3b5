// Fused power-redistribution wave step, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/power_step.py:_power_step_kernel (launched by
// power_step_pallas) and, as a second entry point, its water-fill stage
// (waterfill_caps), which the heuristic policy's tick calls alone.
//
// One wave per scenario row: under REDIST, reclaim the idle draw of the
// non-running lanes and water-fill the rest of the bound over the running
// lanes; translate caps to (freq, duty, power) through the LUT states;
// compute per-lane rates and completion times; reduce the row to its
// cluster power (sum) and earliest completion (min).
//
// Design: one warp per row, each thread holding L = ceil(N/32) lanes in
// registers (lane i lives in thread i % 32, slot i / 32), so N <= 256.
// Every row reduction is a thread-local sum over its slots followed by an
// xor butterfly of __shfl_xor_sync; that fixed order is the one the plain
// PyTorch version (_row_sum in power_step.py) spells out, so the two agree
// bit for bit.  Water-fill open counts are __ballot_sync popcounts, and a
// water-fill pass that has no open lane left ends the loop for the warp.
// Tables carry a per-row stride: 0 for one cluster shared by every row,
// S*N (state tables) and N (lane tables) for per-row stacked clusters.
//
// Numerics: built with --fmad=false and without --use_fast_math, so each
// multiply and add rounds on its own and every division is IEEE, as in the
// plain version.
//
// Bound on this card: the kernel moves about 2 MB per launch at B=1024,
// N=64 (four f32 lane inputs, four lane outputs, L2-resident tables), well
// under a microsecond at 3.35 TB/s, so one launch is bound by launch
// latency, not bandwidth.  The engine launches it once per wave; fusing
// more of the wave into it is later work.

#include <cuda_runtime.h>

namespace {

constexpr float kFitAtol = 1e-6f;   // FIT_ATOL
constexpr float kDutyFloor = 0.02f;  // DUTY_FLOOR
constexpr float kBigTime = 1e30f;    // BIG_TIME
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

struct Tables {
  const float* state_p;    // (S, N) shared or (B, S, N) stacked
  const float* state_f;
  const float* idle_w;     // (N,) shared or (B, N) stacked
  const float* f_min;
  const float* f_nom;
  const float* span;
  const float* speed;
  const float* cap_floor;
  const float* p_max;
  long long stride_s;      // row stride of state_p / state_f (0 = shared)
  long long stride_l;      // row stride of the lane tables (0 = shared)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// Water-fill `budget` over the running lanes: equal shares, lanes whose
// p_max fits the share saturate at p_max and the surplus re-spreads; the
// pass with no saturated lane settles every open lane at
// clip(share, cap_floor, p_max).  Non-running lanes keep the cap floor.
template <int L>
__device__ __forceinline__ void waterfill_lanes(const bool (&run)[L], const float (&floor_w)[L],
                                                const float (&pmax)[L], float budget, int n,
                                                float (&caps)[L]) {
  bool open[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    caps[l] = floor_w[l];
    open[l] = run[l];
  }
  float rem = budget;
  for (int it = 0; it < n; ++it) {
    int n_open = 0;
#pragma unroll
    for (int l = 0; l < L; ++l) n_open += __popc(__ballot_sync(kFullMask, open[l]));
    if (n_open == 0) break;  // every later pass is a no-op
    const float share = rem / static_cast<float>(n_open);
    bool sat[L];
    bool any_sat = false;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      sat[l] = open[l] && (pmax[l] <= share + kFitAtol);
      any_sat = any_sat || sat[l];
    }
    const bool finished = !__any_sync(kFullMask, any_sat);
    float sat_w = 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (open[l] && finished) caps[l] = fminf(fmaxf(share, floor_w[l]), pmax[l]);
      if (sat[l]) caps[l] = pmax[l];
      sat_w = sat_w + (sat[l] ? pmax[l] : 0.0f);
      open[l] = open[l] && !sat[l] && !finished;
    }
    rem = rem - warp_sum(sat_w);
  }
}

template <int L, bool REDIST>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
power_step_kernel(const float* __restrict__ caps, const float* __restrict__ running,
                  const float* __restrict__ remaining, const float* __restrict__ rho,
                  const float* __restrict__ bound, Tables tab, int B, int N, int S,
                  float* __restrict__ rate_out, float* __restrict__ p_node_out,
                  float* __restrict__ t_fin_out, float* __restrict__ eff_caps_out,
                  float* __restrict__ p_cluster_out, float* __restrict__ t_comp_out) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warps only: B rows map to whole warps
  const long long lo = row * N;
  const long long tl = row * tab.stride_l;
  const float* sp = tab.state_p + row * tab.stride_s;
  const float* sf = tab.state_f + row * tab.stride_s;

  bool valid[L], run[L];
  float cap[L], rem[L], rh[L], idle[L], fmin_w[L], fnom[L], span[L], spd[L], floor_w[L], pmax[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = lane + 32 * l;
    valid[l] = i < N;
    if (valid[l]) {
      cap[l] = caps[lo + i];
      run[l] = running[lo + i] > 0.5f;
      rem[l] = remaining[lo + i];
      rh[l] = rho[lo + i];
      idle[l] = tab.idle_w[tl + i];
      fmin_w[l] = tab.f_min[tl + i];
      fnom[l] = tab.f_nom[tl + i];
      span[l] = tab.span[tl + i];
      spd[l] = tab.speed[tl + i];
      floor_w[l] = tab.cap_floor[tl + i];
      pmax[l] = tab.p_max[tl + i];
    } else {
      cap[l] = rem[l] = rh[l] = idle[l] = fmin_w[l] = fnom[l] = span[l] = spd[l] = 0.0f;
      floor_w[l] = pmax[l] = 0.0f;
      run[l] = false;
    }
  }

  float eff[L];
  if (REDIST) {
    float idle_w = 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l) idle_w = idle_w + (run[l] ? 0.0f : idle[l]);
    const float budget = bound[row] - warp_sum(idle_w);
    waterfill_lanes<L>(run, floor_w, pmax, budget, N, eff);
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) eff[l] = cap[l];
  }

  float p_sum = 0.0f;
  float t_min = kBigTime;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (!valid[l]) continue;
    const int i = lane + 32 * l;
    const float c = eff[l];
    // LUT translation: ascending scan, the last (highest) fitting state wins;
    // +inf padded states never fit.
    float freq = fmin_w[l];
    float pfit = sp[i];
    bool has = false;
    for (int s = 0; s < S; ++s) {
      const float p = sp[static_cast<long long>(s) * N + i];
      if (p <= c + kFitAtol) {
        freq = sf[static_cast<long long>(s) * N + i];
        pfit = p;
        has = true;
      }
    }
    const float q = fminf(fmaxf((c - idle[l]) / span[l], kDutyFloor), 1.0f);
    const float f = has ? freq : fmin_w[l];
    const float duty = has ? 1.0f : q;
    const float power = has ? pfit : idle[l] + q * span[l];
    const float slowdown = rh[l] * (fnom[l] / f) + (1.0f - rh[l]);
    const float r = run[l] ? spd[l] * duty / slowdown : 0.0f;
    const float pn = run[l] ? power : idle[l];
    const float tf = r > 0.0f ? rem[l] / r : kBigTime;
    rate_out[lo + i] = r;
    p_node_out[lo + i] = pn;
    t_fin_out[lo + i] = tf;
    eff_caps_out[lo + i] = c;
    p_sum = p_sum + pn;
    t_min = fminf(t_min, tf);
  }
  p_sum = warp_sum(p_sum);
  t_min = warp_min(t_min);
  if (lane == 0) {
    p_cluster_out[row] = p_sum;
    t_comp_out[row] = t_min;
  }
}

template <int L>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
waterfill_kernel(const float* __restrict__ running, const float* __restrict__ budget,
                 const float* __restrict__ cap_floor, const float* __restrict__ p_max,
                 long long stride_l, int B, int N, float* __restrict__ caps_out) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;
  const long long lo = row * N;
  const long long tl = row * stride_l;
  bool run[L];
  float floor_w[L], pmax[L], caps[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = lane + 32 * l;
    const bool valid = i < N;
    run[l] = valid && running[lo + i] > 0.5f;
    floor_w[l] = valid ? cap_floor[tl + i] : 0.0f;
    pmax[l] = valid ? p_max[tl + i] : 0.0f;
  }
  waterfill_lanes<L>(run, floor_w, pmax, budget[row], N, caps);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = lane + 32 * l;
    if (i < N) caps_out[lo + i] = caps[l];
  }
}

inline dim3 grid_for(int B) { return dim3((B + kWarpsPerBlock - 1) / kWarpsPerBlock); }

template <bool REDIST>
void launch_power_step(int slots, cudaStream_t stream, const float* caps, const float* running,
                       const float* remaining, const float* rho, const float* bound,
                       const Tables& tab, int B, int N, int S, float* rate, float* p_node,
                       float* t_fin, float* eff_caps, float* p_cluster, float* t_comp) {
  const dim3 block(kWarpsPerBlock * 32);
#define REPRO_LAUNCH(LL)                                                                   \
  power_step_kernel<LL, REDIST><<<grid_for(B), block, 0, stream>>>(                        \
      caps, running, remaining, rho, bound, tab, B, N, S, rate, p_node, t_fin, eff_caps, \
      p_cluster, t_comp)
  if (slots <= 1) REPRO_LAUNCH(1);
  else if (slots <= 2) REPRO_LAUNCH(2);
  else if (slots <= 4) REPRO_LAUNCH(4);
  else REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
}

}  // namespace

extern "C" {

// One fused wave for B rows of N lanes.  Lane tensors are (B, N) f32
// row-major, bound/p_cluster/t_comp are (B,), tables as in `Tables`.
// Returns cudaGetLastError() after the launch (0 on success).
int repro_power_step(const float* caps, const float* running, const float* remaining,
                     const float* rho, const float* bound, const float* state_p,
                     const float* state_f, const float* idle_w, const float* f_min,
                     const float* f_nom, const float* span, const float* speed,
                     const float* cap_floor, const float* p_max, float* rate, float* p_node,
                     float* t_fin, float* eff_caps, float* p_cluster, float* t_comp, int B,
                     int N, int S, long long stride_s, long long stride_l, int redistribute,
                     void* stream) {
  if (B < 1 || N < 1 || N > 256 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Tables tab{state_p, state_f, idle_w, f_min, f_nom, span, speed, cap_floor, p_max,
                   stride_s, stride_l};
  const int slots = (N + 31) / 32;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (redistribute)
    launch_power_step<true>(slots, st, caps, running, remaining, rho, bound, tab, B, N, S,
                            rate, p_node, t_fin, eff_caps, p_cluster, t_comp);
  else
    launch_power_step<false>(slots, st, caps, running, remaining, rho, bound, tab, B, N, S,
                             rate, p_node, t_fin, eff_caps, p_cluster, t_comp);
  return static_cast<int>(cudaGetLastError());
}

// The water-fill stage alone: running (B, N), budget (B,) -> caps (B, N).
int repro_waterfill(const float* running, const float* budget, const float* cap_floor,
                    const float* p_max, float* caps, int B, int N, long long stride_l,
                    void* stream) {
  if (B < 1 || N < 1 || N > 256) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarpsPerBlock * 32);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slots = (N + 31) / 32;
#define REPRO_LAUNCH(LL)                                                                      \
  waterfill_kernel<LL><<<grid_for(B), block, 0, st>>>(running, budget, cap_floor, p_max, \
                                                      stride_l, B, N, caps)
  if (slots <= 1) REPRO_LAUNCH(1);
  else if (slots <= 2) REPRO_LAUNCH(2);
  else if (slots <= 4) REPRO_LAUNCH(4);
  else REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
