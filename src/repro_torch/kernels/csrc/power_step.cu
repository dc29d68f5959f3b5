// Power-redistribution wave step and whole-row wave loop, written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/power_step.py:_power_step_kernel (launched by
// power_step_pallas) together with the loop that drives it,
// src/repro/backends/jax/engine.py:_row_loop (one lax.while_loop per row,
// vmapped over the rows).  Three entry points share one step body:
//
// * repro_wave_run: the whole sweep in one launch.  Each row runs its own
//   wave loop to its end (done, stalled or out of max_steps): a settle
//   step (start the ready jobs, complete the zero-work ones), and on a
//   settled row one wave: the policy's caps, the step below, the earliest
//   of completion / policy tick / scheduled bound change, clock, energy,
//   peak and over-budget accounting, completions and the policy tick.  It
//   follows TorchBatchSimulator._settle_step and _wave
//   (backends/engine.py) line for line, on the engine's state tensors in
//   place.
// * repro_power_step: one wave's step for every row, the port of the TPU
//   kernel itself (the engine's "step" path launches it once per wave).
// * repro_waterfill: the step's water-fill stage alone (the heuristic
//   policy's tick on the "step" path).
//
// The step, per row: under REDIST, reclaim the idle draw of the
// non-running lanes and water-fill the rest of the bound over the running
// lanes; translate caps to (freq, duty, power) through the LUT states;
// compute per-lane rates and completion times; reduce the row to its
// cluster power (sum) and earliest completion (min).
//
// Design: one warp per row, each thread holding L = ceil(N/32) lanes in
// registers (lane i lives in thread i % 32, slot i / 32), so N <= 256.
// Every row reduction is a thread-local sum over its slots followed by an
// xor butterfly of __shfl_xor_sync; that fixed order is the one the plain
// PyTorch version (row_sum in power_step.py) spells out, so the two agree
// bit for bit.  Water-fill open counts are __ballot_sync popcounts, and a
// water-fill pass that has no open lane left ends the loop for the warp.
// Tables carry a per-row stride: 0 for one cluster shared by every row,
// S*N (state tables) and N (lane tables) for per-row stacked clusters; the
// loop's geometry (job sequences, dependencies, work) likewise.
//
// The whole-row loop keeps a row's lane state (job pointer, running flag,
// remaining work, heuristic cap) and its scalars (clock, bound, energy,
// ...) in registers for the whole run and writes them back once.  Job
// state lives in global memory: the completed bitmap (one byte a job,
// read by the dependency test of every waiting lane), the start/end
// stamps, and the heuristic's (delay + 1, N) ring of targets, so any J
// and any delay fit.  A lane's completion is seen by the other lanes of
// its warp after __syncwarp(), which orders the warp's memory accesses.
//
// Numerics: built with --fmad=false and without --use_fast_math, so each
// multiply and add rounds on its own and every division is IEEE, as in the
// plain version.  The constants of the wave are the float32 values that
// PyTorch applies for the engine's Python-float scalars, and the tick
// offset (k+1)*dt - t is computed in double and rounded once, as the
// engine does.
//
// Bound on this card: one wave step moves about 2 MB at B=1024, N=64, so
// a launch of repro_power_step is bound by launch latency, not bandwidth.
// The whole-row loop reads and writes a few MB once (the state and the
// stamps), a few microseconds at 3.35 TB/s; what bounds it is the serial
// chain of waves of the slowest row times the latency of one wave's
// dependent loads and warp reductions.  Its design answers that: no host
// in the loop, and every row in flight at once (one warp each).

#include <cuda_runtime.h>

namespace {

constexpr float kFitAtol = 1e-6f;   // FIT_ATOL
constexpr float kDutyFloor = 0.02f;  // DUTY_FLOOR
constexpr float kBigTime = 1e30f;    // BIG_TIME
constexpr float kBigCut = 5e29f;     // BIG_TIME * 0.5: "no event"
// The engine's wave constants, as PyTorch applies them to float32 tensors.
constexpr float kOverRtol = static_cast<float>(1.0 + 1e-5);  // 1 + OVER_BUDGET_RTOL
constexpr float kFinishRtol = static_cast<float>(1.0 + 1e-6);
constexpr float kEventAtol = 1e-9f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

// Cap rule of the whole-row loop (the policy's kernel_mode).
enum Mode { kNominal = 0, kJobCaps = 1, kRedistribute = 2, kHeuristic = 3, kLearned = 4 };

// The learned policy's MLP (8 features -> 16 -> 16 -> 1), packed as
// MLP_LAYOUT in power_step.py: W1 (8, 16), b1, W2 (16, 16), b2, w3, b3.
constexpr int kMlpIn = 8;
constexpr int kMlpHidden = 16;
constexpr int kMlpW1 = 0;
constexpr int kMlpB1 = kMlpW1 + kMlpIn * kMlpHidden;
constexpr int kMlpW2 = kMlpB1 + kMlpHidden;
constexpr int kMlpB2 = kMlpW2 + kMlpHidden * kMlpHidden;
constexpr int kMlpW3 = kMlpB2 + kMlpHidden;
constexpr int kMlpB3 = kMlpW3 + kMlpHidden;
constexpr int kMlpSize = kMlpB3 + 1;  // 433 floats
constexpr float kNegBig = -1e30f;     // the masked logit (_NEG_BIG)

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

// One row's lane tables, in registers; lanes past N are zero and invalid.
template <int L>
struct Lanes {
  bool valid[L];
  float idle[L], fmin[L], fnom[L], span[L], spd[L], floor_w[L], pmax[L];
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

template <int L>
__device__ __forceinline__ void load_lanes(const Tables& tab, long long row, int n, int lane,
                                           Lanes<L>& t) {
  const long long tl = row * tab.stride_l;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = lane + 32 * l;
    t.valid[l] = i < n;
    if (t.valid[l]) {
      t.idle[l] = tab.idle_w[tl + i];
      t.fmin[l] = tab.f_min[tl + i];
      t.fnom[l] = tab.f_nom[tl + i];
      t.span[l] = tab.span[tl + i];
      t.spd[l] = tab.speed[tl + i];
      t.floor_w[l] = tab.cap_floor[tl + i];
      t.pmax[l] = tab.p_max[tl + i];
    } else {
      t.idle[l] = t.fmin[l] = t.fnom[l] = t.span[l] = t.spd[l] = 0.0f;
      t.floor_w[l] = t.pmax[l] = 0.0f;
    }
  }
}

// The row's idle draw reclaimed from its non-running lanes.
template <int L>
__device__ __forceinline__ float idle_draw(const Lanes<L>& t, const bool (&run)[L]) {
  float w = 0.0f;
#pragma unroll
  for (int l = 0; l < L; ++l) w = w + (run[l] ? 0.0f : t.idle[l]);
  return warp_sum(w);
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

// The step after the caps are set: LUT translation, rates, completion
// times and the row's cluster power and earliest completion.  `sp`/`sf`
// point at the row's (S, N) state tables.
template <int L>
__device__ __forceinline__ void step_lanes(const Lanes<L>& t, const float* sp, const float* sf,
                                           int n, int n_states, int lane, const float (&eff)[L],
                                           const bool (&run)[L], const float (&rem)[L],
                                           const float (&rh)[L], float (&rate)[L],
                                           float (&p_node)[L], float (&t_fin)[L],
                                           float& p_cluster, float& t_comp) {
  float p_sum = 0.0f;
  float t_min = kBigTime;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    rate[l] = 0.0f;
    p_node[l] = 0.0f;
    t_fin[l] = kBigTime;
    if (!t.valid[l]) continue;
    const int i = lane + 32 * l;
    const float c = eff[l];
    // LUT translation: ascending scan, the last (highest) fitting state wins;
    // +inf padded states never fit.
    float freq = t.fmin[l];
    float pfit = sp[i];
    bool has = false;
    for (int s = 0; s < n_states; ++s) {
      const float p = sp[static_cast<long long>(s) * n + i];
      if (p <= c + kFitAtol) {
        freq = sf[static_cast<long long>(s) * n + i];
        pfit = p;
        has = true;
      }
    }
    const float q = fminf(fmaxf((c - t.idle[l]) / t.span[l], kDutyFloor), 1.0f);
    const float f = has ? freq : t.fmin[l];
    const float duty = has ? 1.0f : q;
    const float power = has ? pfit : t.idle[l] + q * t.span[l];
    const float slowdown = rh[l] * (t.fnom[l] / f) + (1.0f - rh[l]);
    rate[l] = run[l] ? t.spd[l] * duty / slowdown : 0.0f;
    p_node[l] = run[l] ? power : t.idle[l];
    t_fin[l] = rate[l] > 0.0f ? rem[l] / rate[l] : kBigTime;
    p_sum = p_sum + p_node[l];
    t_min = fminf(t_min, t_fin[l]);
  }
  p_cluster = warp_sum(p_sum);
  t_comp = warp_min(t_min);
}

// The learned policy's caps (compute_caps in policies/learned.py, in the
// order the engine's torch namespace spells it, so the plain path agrees
// bit for bit): three row sums (running lanes, p_max, the idle draw of the
// lanes not running) and the running lanes' cap floors, each a warp_sum in
// row_sum's order; each running lane's 8 features, two tanh layers of 16
// and the output dot in registers, every sum over inputs in ascending
// order; then the masked softmax split of the free budget over the running
// lanes on top of their floors (a warp max, expf, a row_sum-ordered
// denominator).  Lanes not running park at their floor; a row with no
// running lane takes the nominal share.  `w` is the packed MLP (kMlp*).
template <int L>
__device__ __forceinline__ void learned_caps(const Lanes<L>& t, const float* w,
                                             const bool (&run)[L], const float (&rh)[L],
                                             float bound, float n_act, float (&caps)[L]) {
  float r[L];
  float n_run = 0.0f, p_sum = 0.0f, idle = 0.0f, floor_sum = 0.0f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    r[l] = run[l] ? 1.0f : 0.0f;
    n_run = n_run + r[l];
    p_sum = p_sum + t.pmax[l];
    idle = idle + (1.0f - r[l]) * t.idle[l];
    floor_sum = floor_sum + r[l] * t.floor_w[l];
  }
  n_run = warp_sum(n_run);
  p_sum = warp_sum(p_sum);
  idle = warp_sum(idle);
  floor_sum = warp_sum(floor_sum);
  const float inv_bound = 1.0f / fmaxf(bound, 1e-12f);
  const float frac_running = n_run / n_act;
  const float tightness = bound / fmaxf(p_sum, 1e-12f);
  const float per_bound = n_act * inv_bound;
  const float idle_frac = idle * inv_bound;

  float masked[L];
  float m = kNegBig;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    masked[l] = kNegBig;  // a lane not running: its logit is masked
    if (run[l]) {
      const float f[kMlpIn] = {r[l],         frac_running,  tightness,
                               t.pmax[l] * per_bound,       idle_frac,
                               rh[l] * r[l], t.floor_w[l] * per_bound, 1.0f};
      float h1[kMlpHidden];
#pragma unroll
      for (int j = 0; j < kMlpHidden; ++j) {
        float acc = f[0] * w[kMlpW1 + j];
#pragma unroll
        for (int k = 1; k < kMlpIn; ++k) acc = acc + f[k] * w[kMlpW1 + k * kMlpHidden + j];
        h1[j] = tanhf(acc + w[kMlpB1 + j]);
      }
      float out = 0.0f;
#pragma unroll
      for (int j = 0; j < kMlpHidden; ++j) {
        float acc = h1[0] * w[kMlpW2 + j];
#pragma unroll
        for (int k = 1; k < kMlpHidden; ++k) acc = acc + h1[k] * w[kMlpW2 + k * kMlpHidden + j];
        const float term = tanhf(acc + w[kMlpB2 + j]) * w[kMlpW3 + j];
        out = j == 0 ? term : out + term;
      }
      masked[l] = out + w[kMlpB3];
    }
    m = fmaxf(m, masked[l]);
  }
  m = warp_max(m);
  float e[L];
  float e_sum = 0.0f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    e[l] = expf(masked[l] - m) * r[l];
    e_sum = e_sum + e[l];
  }
  const float denom = fmaxf(warp_sum(e_sum), 1e-30f);
  const float free_w = fmaxf(bound - idle - floor_sum, 0.0f);
  const float nominal = bound / n_act;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float c = run[l] ? t.floor_w[l] + (e[l] / denom) * free_w : t.floor_w[l];
    caps[l] = n_run > 0.0f ? c : nominal;
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
  Lanes<L> t;
  load_lanes<L>(tab, row, N, lane, t);

  bool run[L];
  float cap[L], rem[L], rh[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = lane + 32 * l;
    run[l] = t.valid[l] && running[lo + i] > 0.5f;
    cap[l] = t.valid[l] ? caps[lo + i] : 0.0f;
    rem[l] = t.valid[l] ? remaining[lo + i] : 0.0f;
    rh[l] = t.valid[l] ? rho[lo + i] : 0.0f;
  }

  float eff[L];
  if (REDIST) {
    waterfill_lanes<L>(run, t.floor_w, t.pmax, bound[row] - idle_draw<L>(t, run), N, eff);
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) eff[l] = cap[l];
  }

  float rate[L], p_node[L], t_fin[L], p_cluster, t_comp;
  step_lanes<L>(t, tab.state_p + row * tab.stride_s, tab.state_f + row * tab.stride_s, N, S,
                lane, eff, run, rem, rh, rate, p_node, t_fin, p_cluster, t_comp);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (!t.valid[l]) continue;
    const int i = lane + 32 * l;
    rate_out[lo + i] = rate[l];
    p_node_out[lo + i] = p_node[l];
    t_fin_out[lo + i] = t_fin[l];
    eff_caps_out[lo + i] = eff[l];
  }
  if (lane == 0) {
    p_cluster_out[row] = p_cluster;
    t_comp_out[row] = t_comp;
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

}  // namespace

extern "C" {

// Everything repro_wave_run reads and updates.  Geometry is int32 with a
// per-row stride (0 = one graph shared by every row); the state is the
// engine's, updated in place (bool tensors as bytes).  Mirrored field for
// field by _WaveArgs in power_step.py.
struct ReproWaveArgs {
  const float* state_p;      // tables, as Tables
  const float* state_f;
  const float* idle_w;
  const float* f_min;
  const float* f_nom;
  const float* span;
  const float* speed;
  const float* cap_floor;
  const float* p_max;
  long long stride_s;
  long long stride_l;
  const int* node_seq;       // (N, K) per row: each lane's job slots, J padded
  long long stride_seq;
  const int* deps;           // (J+1, D) per row: dependency slots, J padded
  long long stride_deps;
  const float* work;         // (J+1,) per row
  const float* rho;          // (J+1,) per row
  long long stride_job;
  const int* n_active;       // (B,) real node count
  const float* sched_t;      // (B, T) bound-change times, BIG_TIME padded
  const float* sched_w;      // (B, T) bounds taking effect then
  const float* caps_job;     // (B, J+1) per-job caps (kJobCaps)
  float* cap;                // (B, N) applied caps (kHeuristic), in place
  float* ring;               // (B, depth, N) tick targets (kHeuristic), in place
  const float* mlp;          // (433,) the packed MLP weights (kLearned)
  long long* ptr;            // (B, N) lane state
  unsigned char* running;
  float* remaining;
  unsigned char* completed;  // (B, J+1) job state
  float* start_t;
  float* end_t;
  float* row_t;              // (B,) row state
  float* bound;
  long long* sched_idx;
  unsigned char* done;
  unsigned char* stalled;
  unsigned char* settled;
  float* energy;
  float* peak;
  float* over_t;
  float* makespan;
  long long* tick_count;
  long long* steps;
  long long* iters;          // (B,) out: loop iterations the row ran
  long long max_steps;
  float dt;
  int B, N, S, K, J, D, T, depth, mode;
};

}  // extern "C"

namespace {

template <int L>
__device__ __forceinline__ void current_jobs(const int* seq, int k, int j, int lane,
                                             const int (&ptr)[L], const bool (&valid)[L],
                                             int (&cur)[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l)
    cur[l] = valid[l] ? seq[static_cast<long long>(lane + 32 * l) * k + ptr[l]] : j;
}

// Complete the masked lanes' current jobs at time `t`: the engine's
// _complete.  `n_done` counts the row's completed job slots, so the row
// is done when it reaches J (== completed[:J].all()).
template <int L>
__device__ __forceinline__ void complete_lanes(const bool (&mask)[L], const int (&cur)[L],
                                               float t, unsigned char* completed, float* end_t,
                                               int j, int (&ptr)[L], bool (&run)[L],
                                               int& n_done, bool& done, float& makespan) {
  int count = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (!mask[l]) continue;
    completed[cur[l]] = 1;
    end_t[cur[l]] = t;
    ++ptr[l];
    run[l] = false;
    ++count;
  }
  n_done += __reduce_add_sync(kFullMask, count);
  const bool all_done = n_done >= j;
  if (all_done && !done) makespan = t;
  done = done || all_done;
  __syncwarp();  // the completions are visible to every lane's next read
}

// LEARNED: the kLearned cap rule, an instantiation of its own, so the
// other modes' code (and registers) stay as they were.
template <int L, bool LEARNED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) wave_run_kernel(ReproWaveArgs a) {
  // the learned MLP's weights, loaded once a block (every row shares them)
  __shared__ float mlp[LEARNED ? kMlpSize : 1];
  if (LEARNED) {
    for (int i = threadIdx.x; i < kMlpSize; i += blockDim.x) mlp[i] = a.mlp[i];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= a.B) return;
  const int n = a.N, j = a.J, d_max = a.D;
  const Tables tab{a.state_p, a.state_f, a.idle_w, a.f_min, a.f_nom, a.span, a.speed,
                   a.cap_floor, a.p_max, a.stride_s, a.stride_l};
  Lanes<L> t;
  load_lanes<L>(tab, row, n, lane, t);
  const float* sp = a.state_p + row * a.stride_s;
  const float* sf = a.state_f + row * a.stride_s;
  const int* seq = a.node_seq + row * a.stride_seq;
  const int* deps = a.deps + row * a.stride_deps;
  const float* work = a.work + row * a.stride_job;
  const float* rho = a.rho + row * a.stride_job;
  const long long jo = row * (j + 1);
  unsigned char* completed = a.completed + jo;
  float* start_t = a.start_t + jo;
  float* end_t = a.end_t + jo;
  const long long lo = row * n;
  const bool ticks_on = a.mode == kHeuristic;

  int ptr[L];
  bool run[L];
  float rem[L], cap[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = lane + 32 * l;
    ptr[l] = t.valid[l] ? static_cast<int>(a.ptr[lo + i]) : 0;
    run[l] = t.valid[l] && a.running[lo + i] != 0;
    rem[l] = t.valid[l] ? a.remaining[lo + i] : 0.0f;
    cap[l] = t.valid[l] && ticks_on ? a.cap[lo + i] : 0.0f;
  }
  float row_t = a.row_t[row], bound = a.bound[row], energy = a.energy[row];
  float peak = a.peak[row], over_t = a.over_t[row], makespan = a.makespan[row];
  long long sched_idx = a.sched_idx[row], tick_count = a.tick_count[row];
  long long steps = a.steps[row], iters = 0;
  bool done = a.done[row] != 0, stalled = a.stalled[row] != 0;
  const float n_act = static_cast<float>(a.n_active[row]);
  const float* sched_t = a.sched_t + row * a.T;
  const float* sched_w = a.sched_w + row * a.T;
  int n_done = 0;  // phantom job slots are born complete
  for (int k = lane; k < j; k += 32) n_done += completed[k] != 0;
  n_done = __reduce_add_sync(kFullMask, n_done);

  int cur[L];
  for (;;) {
    // ---- one settle step: start the ready jobs, complete the zero-work ones
    current_jobs<L>(seq, a.K, j, lane, ptr, t.valid, cur);
    bool ready[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      ready[l] = t.valid[l] && !run[l] && cur[l] < j;
      if (!ready[l]) continue;
      const int* dep = deps + static_cast<long long>(cur[l]) * d_max;
      for (int dd = 0; dd < d_max; ++dd) {
        if (!completed[dep[dd]]) {
          ready[l] = false;
          break;
        }
      }
    }
    bool instant[L];
    bool any_instant = false;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (ready[l]) {
        run[l] = true;
        rem[l] = work[cur[l]];
        start_t[cur[l]] = row_t;
      }
      instant[l] = run[l] && rem[l] <= 0.0f;
      any_instant = any_instant || instant[l];
    }
    const bool settled = !__any_sync(kFullMask, any_instant);
    complete_lanes<L>(instant, cur, row_t, completed, end_t, j, ptr, run, n_done, done,
                      makespan);
    ++iters;
    if (!settled) continue;
    if (done || stalled || steps >= a.max_steps) break;

    // ---- one wave
    current_jobs<L>(seq, a.K, j, lane, ptr, t.valid, cur);
    float caps[L], rh[L];
    const float share = bound / n_act;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      rh[l] = t.valid[l] ? rho[cur[l]] : 0.0f;
      if (a.mode == kJobCaps)
        caps[l] = t.valid[l] ? a.caps_job[jo + cur[l]] : 0.0f;
      else if (a.mode == kHeuristic)
        caps[l] = cap[l];
      else
        caps[l] = share;
    }
    if (LEARNED) learned_caps<L>(t, mlp, run, rh, bound, n_act, caps);
    if (a.mode == kRedistribute) {
      float eff[L];
      waterfill_lanes<L>(run, t.floor_w, t.pmax, bound - idle_draw<L>(t, run), n, eff);
#pragma unroll
      for (int l = 0; l < L; ++l) caps[l] = eff[l];
    }
    float rate[L], p_node[L], t_fin[L], p_cluster, t_comp;
    step_lanes<L>(t, sp, sf, n, a.S, lane, caps, run, rem, rh, rate, p_node, t_fin, p_cluster,
                  t_comp);

    float next_tick = kBigTime, t_tick = kBigTime;
    if (ticks_on) {
      const float ticks = static_cast<float>(tick_count + 1);
      next_tick = ticks * a.dt;
      // (k+1)*dt - t rounded once, as the engine computes it
      t_tick = static_cast<float>(static_cast<double>(ticks) * static_cast<double>(a.dt) -
                                  static_cast<double>(row_t));
    }
    const long long idx_c = sched_idx < a.T - 1 ? sched_idx : a.T - 1;
    const bool sched_live = sched_idx < a.T;
    const float next_bound_t = sched_t[idx_c];
    const float t_bound = sched_live ? next_bound_t - row_t : kBigTime;
    float delta = fminf(fminf(t_comp, t_tick), t_bound);
    // deadlock is judged on t_comp: a row with no running lane never recovers
    const bool stalled_now = t_comp >= kBigCut;
    if (stalled_now) delta = 0.0f;
    const bool over = p_cluster > bound * kOverRtol + kEventAtol;
    const float finish_by = delta * kFinishRtol + kEventAtol;
    bool finishing[L];
#pragma unroll
    for (int l = 0; l < L; ++l) finishing[l] = run[l] && t_fin[l] <= finish_by;
    float new_t = row_t + delta;
    const bool due = ticks_on && t_tick <= t_comp && t_tick <= t_bound && !stalled_now;
    if (due) new_t = next_tick;  // kill float residue
    const bool bound_due = sched_live && t_bound <= t_comp && t_bound <= t_tick && !stalled_now;
    if (bound_due) new_t = next_bound_t;
#pragma unroll
    for (int l = 0; l < L; ++l) rem[l] = finishing[l] ? 0.0f : rem[l] - rate[l] * delta;
    row_t = new_t;
    if (bound_due) {
      bound = sched_w[idx_c];
      ++sched_idx;
    }
    energy = energy + p_cluster * delta;
    peak = fmaxf(peak, p_cluster);
    over_t = over_t + (over ? delta : 0.0f);
    stalled = stalled || stalled_now;
    ++steps;
    complete_lanes<L>(finishing, cur, row_t, completed, end_t, j, ptr, run, n_done, done,
                      makespan);
    if (due) {
      // the heuristic's tick: water-fill the bound over the running lanes
      // into the ring; apply the target pushed `depth - 1` ticks ago
      float target[L];
      waterfill_lanes<L>(run, t.floor_w, t.pmax, bound - idle_draw<L>(t, run), n, target);
      float* ring = a.ring + row * a.depth * n;
      const long long slot = tick_count % a.depth;
      const long long ticks = tick_count + 1;
      const long long delay = a.depth - 1;
      const long long slot_old = (ticks - 1 - delay) % a.depth;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (!t.valid[l]) continue;
        const int i = lane + 32 * l;
        ring[slot * n + i] = target[l];
        if (ticks > delay) cap[l] = ring[slot_old * n + i];
      }
      ++tick_count;
    }
    if (done || stalled || steps >= a.max_steps) break;
  }

#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (!t.valid[l]) continue;
    const int i = lane + 32 * l;
    a.ptr[lo + i] = ptr[l];
    a.running[lo + i] = run[l] ? 1 : 0;
    a.remaining[lo + i] = rem[l];
    if (ticks_on) a.cap[lo + i] = cap[l];
  }
  if (lane == 0) {
    a.row_t[row] = row_t;
    a.bound[row] = bound;
    a.sched_idx[row] = sched_idx;
    a.done[row] = done ? 1 : 0;
    a.stalled[row] = stalled ? 1 : 0;
    a.settled[row] = 1;
    a.energy[row] = energy;
    a.peak[row] = peak;
    a.over_t[row] = over_t;
    a.makespan[row] = makespan;
    a.tick_count[row] = tick_count;
    a.steps[row] = steps;
    a.iters[row] = iters;
  }
}

inline dim3 grid_for(int B) { return dim3((B + kWarpsPerBlock - 1) / kWarpsPerBlock); }

template <int L>
void launch_wave_run(const ReproWaveArgs& a, dim3 block, cudaStream_t stream) {
  if (a.mode == kLearned)
    wave_run_kernel<L, true><<<grid_for(a.B), block, 0, stream>>>(a);
  else
    wave_run_kernel<L, false><<<grid_for(a.B), block, 0, stream>>>(a);
}

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

// Every row of the batch through its whole wave loop, in one launch (see
// ReproWaveArgs).  Returns cudaGetLastError() after the launch.
int repro_wave_run(const ReproWaveArgs* args, void* stream) {
  const ReproWaveArgs& a = *args;
  const bool shapes_ok = a.B >= 1 && a.N >= 1 && a.N <= 256 && a.S >= 1 && a.K >= 1 &&
                         a.J >= 0 && a.D >= 1 && a.T >= 1;
  const bool mode_ok = (a.mode == kNominal || a.mode == kRedistribute) ||
                       (a.mode == kJobCaps && a.caps_job != nullptr) ||
                       (a.mode == kHeuristic && a.cap != nullptr && a.ring != nullptr &&
                        a.depth >= 1) ||
                       (a.mode == kLearned && a.mlp != nullptr);
  if (!shapes_ok || !mode_ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarpsPerBlock * 32);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slots = (a.N + 31) / 32;
#define REPRO_LAUNCH(LL) launch_wave_run<LL>(a, block, st)
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
