#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (one process per source, in parallel) and holds each entry
point against its plain PyTorch version on the card.  Then it drives the
port's two paths:

* the batched wave engine, ``TorchBatchSimulator``, at full width (the
  NPB IS class-C analogue on 64 heterogeneous nodes, 1024 cluster
  bounds, three policies), a padded mixed-shape batch and the ILP
  policies, each run in one launch of the whole-row kernel
  (``wave_run``), checked against the plain version and the event
  simulator's golden makespans; then the per-wave "step" path
  (``power_step`` and ``waterfill`` once a wave) on the same rows as the
  yardstick;
* the sweep front end on those rows and on the mixed family
  (``SweepEngine(executor="torch")``), and the streaming service
  (``SweepService(executor="torch")``: a burst of the full-width rows in
  full 256-row buckets, the same cells again from its result cache, a
  Poisson stream whose deadline flushes pad buckets with phantom rows,
  and the mixed family), each record held against the engine's;
* recorded MPI traces (``repro_torch.traces``): four 64-rank recordings
  written as JSONL, loaded, replay-validated and held against the
  recorded graphs, then their 384-cell ``ScenarioFamily.from_corpus``
  family through the sweep, the service and the serve CLI's
  ``--trace-corpus`` mode (once with ``REPRO_TRACE`` set), 12 cells
  against ``impl="plain"`` and the event simulator;
* the cluster scheduler (``repro_torch.cluster``): the bundled 1,000-job
  arrival stream on 12 nodes and a 128-job stream over those four
  recordings on 256 nodes, each calibrated, scheduled under the four
  outer policies and replayed (every job's realized power schedule as
  its bound schedule) on the card, held against ``impl="plain"`` and
  the vector executor, and the ``python -m repro_torch.cluster`` CLI
  (once with ``REPRO_TRACE`` set);
* the differentiable layer (``repro_torch.diff``): the soft makespan and
  its gradient on the card against the CPU and central differences, and
  its anneal to the exact smooth-LUT makespan (float64), on the four
  graphs of the gradient tests; gradient-descended caps on Listing 2 at
  7, 9 and 12 W against the ILP (300 steps, float32); the policy
  trainer on its 20 scenarios for 3 steps (the bundled checkpoint took
  150), held against the CPU; the trainer's CLI in its own process, and
  ``"learned"`` with the checkpoint it wrote through the sweep on the
  per-wave ``power_step`` path, against ``impl="plain"``;
* the dense LM serving path at full width, llama3-8b with random bf16
  weights from a seed: ``ServeEngine.generate`` on 8 requests (prompt
  512, 64 new tokens) and ``make_prefill_step`` at S=4096, each held
  against the same entry point at ``impl="plain"`` on the card
  (``rmsnorm``, and ``flash_attention`` on its tensor-core kernel);
* the hybrid LM serving path at full width, zamba2-2.7b (54 Mamba2
  layers, the shared attention block after every 6th), random bf16
  weights from a seed, through the same two entry points after
  llama3-8b's weights are freed (``rmsnorm``, ``ssm_scan`` on the SSD
  core of every Mamba2 layer's prefill, ``flash_attention`` at dh=80 on
  its SIMT kernel, which keeps the prefill bit-equal to the plain path);
* the other four model families at full width, each after the last
  one's weights are freed, through the same two entry points (8
  requests of 128 prompt and 32 new tokens; prefill at S=4096):
  moonshot-v1-16b-a3b (MoE, 64 experts top-6, full depth, 56 GB),
  arctic-480b (128 experts top-2 and the dense residual FFN, depth cut
  to 1 layer), xlstm-350m (mLSTM and sLSTM, full depth),
  chameleon-34b (VLM, depth cut to 8 layers) and hubert-xlarge
  (encoder: prefill on frames, non-causal ``flash_attention`` at dh=80;
  no decode), with the MoE's dropped share and its routing agreement
  between the kernel and the plain path;
* the training path at full width, llama3-8b with its depth cut to 2 of
  32 layers (S=4096, batch 1, fp32 AdamW state, remat): the backward
  kernels (``rmsnorm_bwd``; ``flash_attention_bwd``'s tensor-core kernel,
  on the trainer's path, and its SIMT kernel; ``ssm_scan_bwd``'s
  tensor-core kernel, the chunked SSD backward, and its scan kernel)
  against their plain twins, step 0's loss and gradients against
  ``impl="plain"``, 4 steps of ``PowerAwareTrainer``
  (``build_trainer(..., device="cuda")``) with exact launch counts, a
  checkpoint restored bit for bit by a fresh trainer, the train CLI's
  failure recovery in its own process (S=64) and 2 CLI steps at S=2048
  in another (the fp32 smoke config: the SIMT backward's path, its
  launch counts printed by the CLI) and 2 CLI steps of zamba2's fp32
  smoke config in a third (the scan backward's path); then the hybrid
  family the same way, zamba2-2.7b with its depth cut to 12 of 54 layers
  (3 steps; ``ssm_scan`` and its tensor-core backward kernel, the SIMT
  flash forward and the tensor-core flash backward at dh 80).

Every path runs with the launch counts set to 0 just before it and read
just after.  One JSON line per phase, with the ``seconds`` since its
phase began (a phase of several lines gives its total on the last);
then a ``kernels`` line, the
card's name and power limit as ``nvidia-smi`` reports them, and last
``{"ok": true, "device": {...}}``.

Any failed check exits nonzero before that last line, and so does a
machine without CUDA: nothing here falls back to the CPU or to the plain
version.  Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: Kernel-vs-plain tolerance on the card (rtol and atol): the two share
#: every rounding, so a mismatch is a fault, not float noise.
TOL = 1e-5
#: H100 SXM data-sheet peaks used for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: fp32 lane instructions a second (132 SMs x 128 lanes x 1.98 GHz): the
#: issue rate when each multiply and add is its own instruction, as the
#: kernels are built (--fmad=false).
FP32_LANE_OPS_PER_S = 132 * 128 * 1.98e9
BF16_TENSOR_OPS_PER_S = 989e12
#: LM kernels vs their plain versions (rtol and atol): the rmsnorm
#: kernel sums in the plain version's order; flash attention's products
#: run in another order than cuBLAS's, so fp32 agrees to rounding and
#: bf16 to a flipped rounding of p or of the output.
LM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: Whole-model logits, kernel path vs plain path (bf16): normwise
#: relative error.  Every op but the kernels is the same on both paths.  A
#: flash that is not bit-equal to the plain loop (the tensor-core kernel,
#: or the plain loop itself at another kv tile) moves the full-width
#: prefill logits by the model's bf16 rounding floor: 1.8% for llama3-8b,
#: 3.3% for zamba2-2.7b (``flash_probe.py`` on an H100), so zamba2's
#: prefill keeps the bit-equal SIMT flash kernel.  A MoE prefill with
#: random weights routes near-ties everywhere: a flash rounding flips an
#: expert choice, and with capacity drops the flip moves later tokens'
#: slots, so its logits are held at this bar with the plain path handed
#: the kernel path's routing (:func:`phase_prefill_full_width`).
MODEL_REL_TOL = 2e-2
#: ssm_scan kernel vs plain (rtol and atol): the same fp32 arithmetic in
#: the same order, bf16 inputs read as fp32 exactly; only exp may differ
#: by an ulp.
SSM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


class SmokeFailure(RuntimeError):
    pass


#: Start times of the phases running in this process, innermost last
#: (:func:`_timed`), and the time of the last line printed.
_PHASE_STARTS: list = []
_LAST_EMIT = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    """Print one phase line; its ``seconds`` are the wall since its phase
    began (since the line before, outside a ``phase_*`` function), unless
    the line gives its own."""
    now = time.perf_counter()
    fields.setdefault("seconds", now - (_PHASE_STARTS[-1] if _PHASE_STARTS
                                        else _LAST_EMIT[0]))
    _LAST_EMIT[0] = now
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _timed(fn):
    """``fn`` with its start time on :data:`_PHASE_STARTS` while it
    runs."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        _PHASE_STARTS.append(time.perf_counter())
        try:
            return fn(*args, **kwargs)
        finally:
            _PHASE_STARTS.pop()
    return run


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- inputs
def random_rows(torch, b, n, stacked, gen, device):
    """Random wave inputs for ``b`` rows of ``n`` lanes on ``device``.

    Tables are built from the port's two LUT presets (8 and 10 states,
    so S is ragged and +inf padded).  Shared: one heterogeneous cluster
    for every row.  Stacked: each row draws its lanes' presets and
    speeds and a real node count, and the lanes past it are phantom
    (the padding of ``stack_lut_tables``), never running."""
    from repro_torch.core.power import (_PHANTOM, NodeSpec,
                                        arndale_like_lut,
                                        heterogeneous_cluster, lut_table,
                                        odroid_like_lut)
    from repro_torch.kernels.power_step import StepTables, step_tables

    f32 = dict(dtype=torch.float32, device=device)
    if stacked:
        base = lut_table([NodeSpec(arndale_like_lut()),
                          NodeSpec(odroid_like_lut())])
        kind = torch.randint(0, 2, (b, n), generator=gen, device=device)
        n_act = torch.randint(1, n + 1, (b, 1), generator=gen,
                              device=device)
        real = torch.arange(n, device=device)[None, :] < n_act

        def lanes(name, scale=None):
            t = torch.as_tensor(getattr(base, name), **f32)[kind]
            if scale is not None:
                t = t * scale
            return torch.where(real, t, float(_PHANTOM[name])).contiguous()

        def states(name):
            t = torch.as_tensor(getattr(base, name), **f32)[kind]
            t = torch.where(real[..., None], t, float(_PHANTOM[name]))
            return t.transpose(1, 2).contiguous()          # (B, S, N)

        speed = 1.0 + 0.25 * kind.float() + 0.05 * (
            2 * torch.rand((b, n), generator=gen, **f32) - 1)
        tab = StepTables(
            state_p=states("state_p"), state_f=states("state_f"),
            idle_w=lanes("idle_w"), f_min=lanes("f_min"),
            f_nom=lanes("f_nom"), span=lanes("span"),
            speed=lanes("speed", speed), cap_floor=lanes("cap_floor"),
            p_max=lanes("p_max"))
    else:
        tab = step_tables(lut_table(heterogeneous_cluster(n, seed=n)),
                          device)
        real = torch.ones((b, n), dtype=torch.bool, device=device)

    def uni(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    p_hi = float(tab.p_max.max())
    caps = uni(0.2, 1.2 * p_hi, (b, n))
    running = ((torch.rand((b, n), generator=gen, **f32) < 0.7)
               & real).float()
    remaining = uni(0.0, 50.0, (b, n))
    rho = uni(0.1, 1.0, (b, n))
    idle_sum = tab.idle_w.expand(b, n).sum(-1, keepdim=True)
    pmax_sum = tab.p_max.expand(b, n).sum(-1, keepdim=True)
    bound = idle_sum + (pmax_sum - idle_sum) * torch.rand(
        (b, 1), generator=gen, **f32)
    return tab, (caps, running, remaining, rho, bound)


def compare(torch, got, want):
    """(max abs err, max rel err, all within TOL) over matching tensors."""
    abs_err = rel_err = 0.0
    ok = True
    for g, w in zip(got, want):
        d = (g - w).abs()
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err, float((d / w.abs().clamp(min=1e-30)).max()))
        ok = ok and bool((d <= TOL + TOL * w.abs()).all())
    return abs_err, rel_err, ok


def call_ms(torch, fn, reps):
    """Milliseconds per call of ``fn``, host included (CUDA events over
    ``reps`` back-to-back calls after a warm-up)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: Device kernels one launch of each wrapper runs (its ``LAUNCHES`` key):
#: what a profiler session must hold at least, besides the other calls'.
#: ``flash_attention_tc`` and ``flash_attention_bwd_tc`` are counted
#: under ``flash_attention`` and ``flash_attention_bwd`` too, so not here;
#: ``ssm_scan_bwd_tc`` is counted under ``ssm_scan_bwd`` too (whose two
#: kernels the scan variant runs), and runs one kernel more (three).
KERNELS_PER_LAUNCH = {"wave_run": 1, "power_step": 1, "waterfill": 1,
                      "rmsnorm": 1, "rmsnorm_bwd": 2, "flash_attention": 1,
                      "flash_attention_bwd": 3, "ssm_scan": 1,
                      "ssm_scan_bwd": 2, "ssm_scan_bwd_tc": 1}
#: Every ``device_ms`` session of this process: reps, the kernel records
#: it kept, the fewest it must hold, whether it fell short, its device ms
#: a call and where its records lay (``_record_span``).
PROFILER_SESSIONS: list = []


def _kernels_launched() -> int:
    """Device kernels the port's wrappers have launched in this process."""
    return sum(n * c.get(key, 0) for c in _counters()
               for key, n in KERNELS_PER_LAUNCH.items())


#: Host idle seconds at each end of a profiler session.  The profiler
#: keeps only the device records whose time stamps, carried to the host's
#: clock, fall inside its session, and that carriage is off by
#: milliseconds in some sessions, either way: a session whose calls began
#: at once (the first launch ~1.2 ms after the start) or ended just before
#: its stop lost the kernels that fell outside, every kernel of a short
#: session.  ``profiler_probe.py`` (an H100): 43 of 5,824 such sessions
#: under-recorded (22 recorded nothing), with CUPTI kept between sessions
#: or not; 0 of 3,720 with the calls begun 20 ms after the start; offsets
#: of up to 15.7 ms seen, so the hold is 250 ms.  (A second loss, records
#: missing inside late sessions of a process with millions of launches
#: behind it, no hold prevents: ``device_ms`` reports it.)
PROFILE_HOLD_S = 0.25


@contextlib.contextmanager
def profiler_session(torch):
    """A ``torch.profiler`` session of the device's activity, the host
    idle for :data:`PROFILE_HOLD_S` after it starts and, once the device
    has finished the body's work, before it stops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_HOLD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_HOLD_S)


def _record_span(torch, prof, t_first, t_sync) -> dict:
    """Where a session's device records lie on the host's clock: the
    first one's start after the first call was made (``lead_ms``) and the
    last one's end before the device was seen done (``tail_ms``).  Either
    negative, or far above a launch's latency, is the carriage's offset."""
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    if not events:
        return {"lead_ms": None, "tail_ms": None}
    return {"lead_ms": (min(e.start_ns() for e in events) - t_first) / 1e6,
            "tail_ms": (t_sync - max(e.end_ns() for e in events)) / 1e6}


def device_ms(torch, fn, reps):
    """Device milliseconds per call of ``fn``: the summed time of the
    GPU kernels and copies it ran, from a :func:`profiler_session`.

    The session's device records are counted against what ran: at least
    the kernels the port's wrappers launched in it (their ``LAUNCHES``
    deltas, :data:`KERNELS_PER_LAUNCH` a launch), and a whole number of
    records a call (every call runs the same kernels).  A session that
    records no device time raises.  One that records fewer is a reading:
    its counts, :func:`_record_span` and its records by kernel go to
    :data:`PROFILER_SESSIONS` marked ``short``, and
    :func:`profiler_summary` lists it (its sum is low)."""
    fn()
    torch.cuda.synchronize()
    before = _kernels_launched()
    with profiler_session(torch) as prof:
        t_first = time.time_ns()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        t_sync = time.time_ns()
    launched = _kernels_launched() - before
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(_self_device_us(e) for e in rows)
    records = sum(e.count for e in rows)
    want = max(launched, reps)
    session = {"reps": reps, "records": records, "at_least": want,
               "short": records < want or records % reps != 0,
               "ms": total_us / 1e3 / reps,
               **_record_span(torch, prof, t_first, t_sync)}
    if session["short"]:
        session["by_kernel"] = {e.key[:60]: e.count for e in rows}
    PROFILER_SESSIONS.append(session)
    if total_us <= 0:
        raise SmokeFailure(f"the profiler saw no device time: {session}, "
                           f"{launched} of the port's kernels launched")
    return total_us / 1e3 / reps


def profiler_summary() -> dict:
    """What this process's :func:`device_ms` sessions recorded, and the
    extremes of where their records lay (:func:`_record_span`)."""
    spans = [r for r in PROFILER_SESSIONS if r["lead_ms"] is not None]
    return {"sessions": len(PROFILER_SESSIONS),
            "records": sum(r["records"] for r in PROFILER_SESSIONS),
            "at_least": sum(r["at_least"] for r in PROFILER_SESSIONS),
            "short": [r for r in PROFILER_SESSIONS if r["short"]],
            "hold_s": PROFILE_HOLD_S,
            "lead_ms_min": min((r["lead_ms"] for r in spans), default=None),
            "lead_ms_max": max((r["lead_ms"] for r in spans), default=None),
            "tail_ms_min": min((r["tail_ms"] for r in spans), default=None),
            "tail_ms_max": max((r["tail_ms"] for r in spans), default=None)}


def bound(nbytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / ops_per_s
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def _self_device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    raise SmokeFailure("profiler event without a device time")


# ----------------------------------------------------------------- phases
def phase_kernel(torch, device):
    """Every entry point vs its plain version on random rows."""
    from repro_torch.kernels import power_step as ps

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    worst = {"power_step": [0.0, 0.0], "waterfill": [0.0, 0.0]}
    cases = 0
    for n in (3, 8, 33, 64, 200):
        for stacked in (False, True):
            tab, args = random_rows(torch, 65536, n, stacked, gen, device)
            for red in (False, True):
                got = ps.power_step(tab, *args, redistribute=red)
                want = ps.power_step(tab, *args, redistribute=red,
                                     impl="plain")
                a, r, ok = compare(torch, got, want)
                require(ok, f"power_step N={n} stacked={stacked} "
                            f"redistribute={red}: kernel vs plain abs "
                            f"{a:.3g} rel {r:.3g}")
                worst["power_step"] = [max(worst["power_step"][0], a),
                                       max(worst["power_step"][1], r)]
                cases += 1
            running, budget = args[1], args[4]
            got = ps.waterfill(tab, running, budget)
            want = ps.waterfill(tab, running, budget, impl="plain")
            a, r, ok = compare(torch, (got,), (want,))
            require(ok, f"waterfill N={n} stacked={stacked}: kernel vs "
                        f"plain abs {a:.3g} rel {r:.3g}")
            worst["waterfill"] = [max(worst["waterfill"][0], a),
                                  max(worst["waterfill"][1], r)]
            cases += 1
            del tab, args
    torch.cuda.synchronize()

    # Times at the main path's shape: B=1024 rows of N=64, shared tables.
    b, n = 1024, 64
    tab, args = random_rows(torch, b, n, False, gen, device)
    s = tab.state_p.shape[0]
    running, budget = args[1], args[4]
    calls = {
        "power_step": lambda: ps.power_step(tab, *args),
        "power_step_plain": lambda: ps.power_step(tab, *args,
                                                  impl="plain"),
        "power_step_redistribute": lambda: ps.power_step(
            tab, *args, redistribute=True),
        "power_step_redistribute_plain": lambda: ps.power_step(
            tab, *args, redistribute=True, impl="plain"),
        "waterfill": lambda: ps.waterfill(tab, running, budget),
        "waterfill_plain": lambda: ps.waterfill(tab, running, budget,
                                                impl="plain"),
    }
    # device time is what the card spends; call time adds the host's
    # dispatch, which bounds a lone launch of a kernel this small
    times = {}
    for name, fn in calls.items():
        reps = 20 if name.endswith("plain") else 200
        times[f"{name}_ms"] = device_ms(torch, fn, reps)
        times[f"{name}_call_ms"] = call_ms(torch, fn, reps)
    # Bounds: each input read once, each output written once; operations
    # per lane of the translation (a compare and a select per state) and
    # the rest of the wave (~15), plus ~8 per lane per water-fill pass.
    table_bytes = 4 * (2 * s * n + 7 * n)
    step_bytes = 4 * (4 * b * n + b) + table_bytes + 4 * (4 * b * n + 2 * b)
    step_ops = b * n * (2 * s + 15)
    fill_bytes = 4 * (b * n + b + 2 * n) + 4 * b * n
    fill_ops = b * n * 8 * 2
    bounds = {}
    for name, nbytes, ops in (("power_step", step_bytes, step_ops),
                              ("waterfill", fill_bytes, fill_ops)):
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * ops / FP32_OPS_PER_S
        bounds[name] = {"bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations", "bytes": nbytes}
    emit("kernel", cases=cases, rows=65536, tol=TOL,
         max_abs_err={k: v[0] for k, v in worst.items()},
         max_rel_err={k: v[1] for k, v in worst.items()},
         timing_shape=[b, n], **times, bounds=bounds)
    return worst, times, bounds


def _summary(r):
    """What the comparisons read of a result (picklable)."""
    return (r.makespan, r.energy_j, r.peak_power_w, r.over_budget_time,
            frozenset(r.job_ends))


def _compare_results(rs_a, rs_b, what):
    """Per-row makespan / energy / peak / over-budget time within TOL and
    the same completed jobs; takes results or their summaries.  Returns
    (worst relative error, max abs diff over those four and, where both
    sides are results, every job's start and end stamps)."""
    import math

    worst = abs_diff = 0.0
    for ra, rb in zip(rs_a, rs_b):
        sa = ra if isinstance(ra, tuple) else _summary(ra)
        sb = rb if isinstance(rb, tuple) else _summary(rb)
        for f, a, b in zip(("makespan", "energy_j", "peak_power_w",
                            "over_budget_time"), sa, sb):
            require(math.isfinite(a) and math.isfinite(b),
                    f"{what}: non-finite {f}")
            require(abs(a - b) <= TOL * abs(b) + 1e-9,
                    f"{what}: {f} {a!r} vs {b!r}")
            worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
            abs_diff = max(abs_diff, abs(a - b))
        require(sa[4] == sb[4], f"{what}: completed job sets differ")
        if not (isinstance(ra, tuple) or isinstance(rb, tuple)):
            for stamps_a, stamps_b in ((ra.job_starts, rb.job_starts),
                                       (ra.job_ends, rb.job_ends)):
                require(stamps_a.keys() == stamps_b.keys(),
                        f"{what}: started job sets differ")
                for k, v in stamps_b.items():
                    abs_diff = max(abs_diff, abs(stamps_a[k] - v))
    return worst, abs_diff


FULL_WIDTH_POLICIES = ("equal-share", "oracle", "heuristic")
#: The policies whose full-width rows are held against the plain version.
#: Not the heuristic: the plain path issues each of its ~26k-31k tick
#: waves a row from the host (87-152 s for 32 rows, on a critical path
#: of the script's time limit); its kernel rows are held against plain in
#: ``padded``, ``step_path`` and ``trace_corpus``.
FULL_WIDTH_PLAIN = ("equal-share", "oracle")


def _full_width_case():
    """IS class-C analogue on 64 mixed nodes and its 1024 bounds, and
    the 32 rows of each policy of :data:`FULL_WIDTH_PLAIN` held against
    the plain version, spread over every bound."""
    import numpy as np

    from repro_torch.core.power import (heterogeneous_cluster,
                                        max_useful_cluster_bound,
                                        min_feasible_cluster_bound)
    from repro_torch.core.workloads import is_like

    graph = is_like(64, "C")
    specs = heterogeneous_cluster(64, seed=0)
    rows = 1024
    bounds = np.linspace(1.05 * min_feasible_cluster_bound(specs),
                         max_useful_cluster_bound(specs), rows)
    picks = {p: np.linspace(16, rows - 1, 32).astype(int)
             for p in FULL_WIDTH_PLAIN}
    return graph, specs, bounds, picks


def _plain_full_width(queue) -> None:
    """Worker process: the full-width picks under the plain version.  It
    runs beside the kernel runs (the card mostly idle) and sends back
    summaries, or the traceback of its failure."""
    import traceback

    try:
        sys.path.insert(0, str(SRC))
        from repro_torch import TorchBatchSimulator

        graph, specs, bounds, picks = _full_width_case()
        out = {}
        for policy in FULL_WIDTH_PLAIN:
            t0 = time.perf_counter()
            res = TorchBatchSimulator(graph, specs, bounds[picks[policy]],
                                      policy, dt=0.05, latency_s=0.05,
                                      impl="plain").run()
            out[policy] = (time.perf_counter() - t0,
                           [_summary(r) for r in res])
        queue.put(("ok", out))
    except Exception:     # reported to the parent, which fails the run
        queue.put(("error", traceback.format_exc()))


def _delta(launches, before):
    return {k: launches[k] - before[k] for k in launches}


def _wave_run_bound(sim, stats) -> dict:
    """The least time the card could take for one whole-row run: each
    input read once and each output written once (geometry and tables
    once, shared or not; the state and the policy's tensors in and out),
    and the operations this run's waves need: per lane a wave, a compare
    and a select per LUT state and ~15 more, plus ~8 per water-fill pass
    (two passes) where the policy water-fills."""
    import numpy as np

    from repro_torch.backends.policies import kernel_mode

    a = sim.arrays
    b, n, j1 = sim.n_rows, a.n_nodes, a.n_jobs + 1
    s = a.table.state_p.shape[-1]
    copies = b if sim.stacked else 1          # of work, rho and the tables
    geometry = 4 * (a.node_seq.size + a.deps_pad.size
                    + copies * (2 * j1 + (2 * s + 7) * n))
    t_cols = 1 if sim._sched is None else sim._sched[0].shape[1]
    inputs = geometry + 4 * b + 8 * b * t_cols  # n_active, schedules
    state = (b * n * (8 + 1 + 4) + b * j1 * (1 + 4 + 4)
             + b * (4 * 6 + 8 * 3 + 3)
             + 4 * sum(np.asarray(v).size
                       for v in sim.policy.init_state(sim).values()))
    nbytes = inputs + 2 * state + 8 * b       # + the loop counts out
    fills = kernel_mode(sim.policy) in ("redistribute", "heuristic")
    per_lane = 2 * s + 15 + (16 if fills else 0)
    return bound(nbytes, stats.row_waves * n * per_lane, FP32_OPS_PER_S)


def phase_full_width(torch, launches):
    """The main path at full width: 1024 bounds x IS class C, N=64, each
    policy in one launch of the whole-row kernel; then the plain path on
    equal-share's 1024 rows as the yardstick.  Returns the main path's
    launch counts, the kernel's numbers and equal-share's run."""
    import multiprocessing as mp

    from repro_torch import TorchBatchSimulator
    from repro_torch.core.arrays import build_graph_arrays

    graph, specs, bounds, picks = _full_width_case()
    ga = build_graph_arrays(graph, specs)
    dims = [ga.n_nodes, ga.n_jobs, ga.node_seq.shape[1],
            ga.deps_pad.shape[1], ga.table.state_p.shape[1]]
    require(dims == [64, 1088, 18, 64, 10], f"IS class-C dims {dims}")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    worker = ctx.Process(target=_plain_full_width, args=(queue,))
    worker.start()
    try:
        for key in launches:
            launches[key] = 0
        runs = {}
        for policy in FULL_WIDTH_POLICIES:
            before = dict(launches)
            t0 = time.perf_counter()
            sim = TorchBatchSimulator(graph, specs, bounds, policy,
                                      dt=0.05, latency_s=0.05)
            res = sim.run()
            runs[policy] = (time.perf_counter() - t0, sim, res)
            got = _delta(launches, before)
            require(sim.stats.path == "cuda"
                    and got == {"power_step": 0, "waterfill": 0,
                                "wave_run": 1},
                    f"{policy}: launches {got} on path {sim.stats.path}; "
                    f"one wave_run launch and no per-wave launch expected")
            require(all(len(r.job_ends) == ga.n_jobs for r in res),
                    f"{policy}: a row did not complete every job")
            if policy == "equal-share":
                require(all(r.peak_power_w <= b * (1 + 1e-5)
                            for r, b in zip(res, bounds)),
                        "equal-share peak above its bound")
        main_launches = dict(launches)
        # the latency of one wave: the heuristic's lowest bound (its
        # longest row) alone on the card, no other warp beside it
        one = TorchBatchSimulator(graph, specs, bounds[:1], "heuristic",
                                  dt=0.05, latency_s=0.05)
        one.run()
        # the plain version on the same inputs: all 1024 rows of
        # equal-share on this card
        t0 = time.perf_counter()
        eq_plain = TorchBatchSimulator(graph, specs, bounds, "equal-share",
                                       dt=0.05, latency_s=0.05,
                                       impl="plain").run()
        eq_plain_wall = time.perf_counter() - t0
        status, plain = queue.get(timeout=1800)
        worker.join(timeout=60)
    finally:
        if worker.is_alive():
            worker.terminate()
            worker.join()
    require(status == "ok", f"plain full-width worker failed:\n{plain}")
    out = {"abs_diff": 0.0}
    for policy in FULL_WIDTH_POLICIES:
        wall, sim, res = runs[policy]
        st = sim.stats
        plain_wall, plain_rows = plain.get(policy, (None, []))
        rel = abs_diff = None
        if policy in FULL_WIDTH_PLAIN:
            rel, abs_diff = _compare_results(
                [res[i] for i in picks[policy]], plain_rows,
                f"full-width {policy} kernel vs plain")
            out["abs_diff"] = max(out["abs_diff"], abs_diff)
        mk = [r.makespan for r in res]
        fields = {}
        if policy == "equal-share":
            rel_p, abs_p = _compare_results(res, eq_plain,
                                            "full-width equal-share "
                                            "kernel vs plain (all rows)")
            out["abs_diff"] = max(out["abs_diff"], abs_p)
            out.update(bound=_wave_run_bound(sim, st), ms=st.kernel_ms,
                       plain_ms=1e3 * eq_plain_wall, equal_share=(wall, res,
                                                                 st))
            fields = dict(plain_all_rows_wall_s=eq_plain_wall,
                          max_rel_vs_plain_all_rows=rel_p,
                          max_abs_diff_vs_plain_all_rows=abs_p)
        if policy == "heuristic":
            one_us = 1e3 * one.stats.kernel_ms / one.stats.waves
            fields = dict(one_row_kernel_ms=one.stats.kernel_ms,
                          one_row_waves=one.stats.waves,
                          one_row_us_per_wave=one_us,
                          latency_floor_ms=st.waves * one_us / 1e3)
            out["latency_floor_ms_heuristic"] = fields["latency_floor_ms"]
        out[f"ms_{policy}"] = st.kernel_ms
        out.setdefault("results", {})[policy] = res
        emit("full_width", policy=policy, path=st.path, rows=len(res),
             dims=dims, bound_w=[float(bounds[0]), float(bounds[-1])],
             wall_s=wall, kernel_ms=st.kernel_ms, waves=st.waves,
             row_waves=st.row_waves,
             us_per_wave=1e3 * st.kernel_ms / st.waves,
             host_share_of_wall=1 - st.kernel_ms / (1e3 * wall),
             host_syncs=st.host_syncs, rows_per_s=len(res) / wall,
             makespan_s=[min(mk), max(mk)], max_rel_vs_plain=rel,
             max_abs_diff_vs_plain=abs_diff, plain_rows=len(plain_rows),
             plain_wall_s=plain_wall, **fields)
    return main_launches, out


def phase_profile(torch):
    """Where a full-width run's time goes on the default path: each
    policy's run under ``torch.profiler`` (device time of the wave_run
    kernel and of everything else) and the host's parts of the wall:
    building the simulator, the run, and turning the fetched arrays into
    results."""
    from repro_torch import TorchBatchSimulator

    graph, specs, bounds, _ = _full_width_case()
    results_s = []
    make_results = TorchBatchSimulator._results

    def timed_results(self, out, rows):
        t0 = time.perf_counter()
        res = make_results(self, out, rows)
        results_s.append(time.perf_counter() - t0)
        return res

    TorchBatchSimulator._results = timed_results
    try:
        for policy in ("equal-share", "heuristic"):
            with profiler_session(torch) as prof:
                t0 = time.perf_counter()
                sim = TorchBatchSimulator(graph, specs, bounds, policy)
                t1 = time.perf_counter()
                sim.run()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            device_s = sum(_self_device_us(e) for e in rows) / 1e6
            kernel_s = sum(_self_device_us(e) for e in rows
                           if "wave_run" in e.key) / 1e6
            require(kernel_s > 0, f"profile {policy}: no wave_run kernel")
            wall = t2 - t0
            top = sorted(rows, key=_self_device_us, reverse=True)[:5]
            emit("profile", policy=policy, rows=len(bounds),
                 waves=sim.stats.waves, wall_s=wall, build_s=t1 - t0,
                 run_s=t2 - t1, results_s=results_s[-1],
                 device_s=device_s, wave_run_device_s=kernel_s,
                 device_busy_share=device_s / wall,
                 host_share=1 - device_s / wall,
                 device_launches=sum(e.count for e in rows),
                 top_device_ms={e.key[:60]: _self_device_us(e) / 1e3
                                for e in top})
    finally:
        TorchBatchSimulator._results = make_results


@functools.lru_cache(maxsize=1)
def _padded_case():
    """The six mixed-family members x bound fractions (0.15, 0.4, 0.8),
    their relative bound steps, and paper-ILP assignments (solved once,
    in threads: the MILP solver releases the interpreter lock;
    ``phase_step_path`` and ``phase_padded`` share them)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.ilp import solve_paper_ilp
    from repro_torch.core.power import (max_useful_cluster_bound,
                                        min_feasible_cluster_bound)
    from repro_torch.core.workloads import mixed_members

    items, bounds, scheds = [], [], []
    for _name, graph, specs, steps in mixed_members(seed=0):
        lo = min_feasible_cluster_bound(specs)
        hi = max_useful_cluster_bound(specs)
        for frac in (0.15, 0.4, 0.8):
            bound_w = lo + frac * (hi - lo)
            items.append((graph, specs))
            bounds.append(bound_w)
            scheds.append(tuple((t, f * bound_w) for t, f in steps))
    # a 5 s cap per solve keeps the slowest members' MILPs short: the
    # kernel and plain runs then share whatever assignment it returns
    with ThreadPoolExecutor(len(os.sched_getaffinity(0))) as pool:
        assignments = list(pool.map(
            lambda item, b: solve_paper_ilp(*item, b, time_limit=5.0),
            items, bounds))
    return items, bounds, scheds, assignments


def phase_padded(torch, launches):
    """One stacked batch per policy with bound steps, on the default path
    (one wave_run launch) against the plain path; returns the max abs
    diff."""
    from repro_torch import TorchBatchSimulator

    items, bounds, scheds, assignments = _padded_case()
    worst = 0.0
    for policy in ("equal-share", "oracle", "heuristic", "ilp"):
        kw = {"assignments": assignments} if policy == "ilp" else {}
        before = dict(launches)
        t0 = time.perf_counter()
        sim = TorchBatchSimulator.padded(items, bounds, policy,
                                         bound_schedules=scheds, **kw)
        res = sim.run()
        wall = time.perf_counter() - t0
        got = _delta(launches, before)
        require(got == {"power_step": 0, "waterfill": 0, "wave_run": 1},
                f"padded {policy}: launches {got}; one wave_run expected")
        plain = TorchBatchSimulator.padded(items, bounds, policy,
                                           bound_schedules=scheds,
                                           impl="plain", **kw).run()
        rel, abs_diff = _compare_results(res, plain,
                                         f"padded {policy} kernel vs plain")
        worst = max(worst, abs_diff)
        require(all(len(r.job_ends) == len(g.jobs)
                    for r, (g, _) in zip(res, items)),
                f"padded {policy}: a row did not complete")
        emit("padded", policy=policy, path=sim.stats.path, rows=len(res),
             wall_s=wall, kernel_ms=sim.stats.kernel_ms,
             waves=sim.stats.waves, row_waves=sim.stats.row_waves,
             host_syncs=sim.stats.host_syncs, max_rel_vs_plain=rel,
             max_abs_diff_vs_plain=abs_diff)
    return worst


def phase_step_path(torch, launches, equal_share):
    """The per-wave "step" path (one power_step launch a wave, and one
    waterfill launch a heuristic wave), the yardstick on the same card:
    equal-share at full width, all 1024 rows, against the whole-row
    kernel's run of ``phase_full_width``; and the padded heuristic
    against the default path.  Both run with the counts set to 0 before
    and read after (the default-path comparison run is not counted).
    Returns those counts and the full-width step wall in ms."""
    from repro_torch import TorchBatchSimulator

    graph, specs, bounds, _ = _full_width_case()
    kernel_wall, kernel_res, kernel_stats = equal_share
    items, p_bounds, scheds, _ = _padded_case()
    for key in launches:
        launches[key] = 0
    t0 = time.perf_counter()
    sim = TorchBatchSimulator(graph, specs, bounds, "equal-share",
                              dt=0.05, latency_s=0.05, impl="step")
    res = sim.run()
    wall = time.perf_counter() - t0
    got = dict(launches)
    require(sim.stats.path == "step" and got["wave_run"] == 0
            and got["power_step"] == sim.stats.waves,
            f"step path: launches {got}, {sim.stats.waves} waves")
    # the lockstep loop tests liveness every 64 iterations
    require(sim.stats.waves == -(-kernel_stats.waves // 64) * 64,
            f"step path ran {sim.stats.waves} iterations, the kernel's "
            f"longest row {kernel_stats.waves}")
    rel, abs_diff = _compare_results(res, kernel_res, "full-width "
                                     "equal-share step vs wave_run")
    emit("step_path", run="full_width equal-share", rows=len(res),
         wall_s=wall, rows_per_s=len(res) / wall, waves=sim.stats.waves,
         launches=got, max_rel_vs_wave_run=rel,
         max_abs_diff_vs_wave_run=abs_diff, wave_run_wall_s=kernel_wall,
         wave_run_waves=kernel_stats.waves,
         wall_ratio_step_over_wave_run=wall / kernel_wall)

    before = dict(launches)
    sim = TorchBatchSimulator.padded(items, p_bounds, "heuristic",
                                     bound_schedules=scheds, impl="step")
    res = sim.run()
    got = _delta(launches, before)
    require(got["power_step"] == sim.stats.waves == got["waterfill"]
            and got["wave_run"] == 0,
            f"step path padded heuristic: launches {got}, "
            f"{sim.stats.waves} waves")
    step_launches = dict(launches)
    kernel_res = TorchBatchSimulator.padded(
        items, p_bounds, "heuristic", bound_schedules=scheds).run()
    rel_h, abs_h = _compare_results(res, kernel_res, "padded heuristic "
                                    "step vs wave_run")
    emit("step_path", run="padded heuristic", rows=len(res),
         waves=sim.stats.waves, launches=got, max_rel_vs_wave_run=rel_h,
         max_abs_diff_vs_wave_run=abs_h)
    return step_launches, 1e3 * wall


def phase_ilp(torch, launches):
    """Listing 2 on three nodes: ILP policies over 16 bounds on the
    default path (one wave_run launch) vs plain, and equal-share / oracle
    vs the event simulator's golden makespans.  Returns the max abs diff
    vs plain."""
    import numpy as np

    from repro_torch import TorchBatchSimulator
    from repro_torch.core.ilp import build_makespan_milp, solve_paper_ilp
    from repro_torch.core.power import (homogeneous_cluster,
                                        max_useful_cluster_bound,
                                        min_feasible_cluster_bound)
    from repro_torch.core.workloads import listing2_graph

    graph, specs = listing2_graph(), homogeneous_cluster(3)
    lo = min_feasible_cluster_bound(specs)
    hi = max_useful_cluster_bound(specs)
    bounds = np.linspace(1.05 * lo, hi, 16)
    worst = 0.0
    for policy, solver in (("ilp", solve_paper_ilp),
                           ("ilp-makespan", build_makespan_milp)):
        assignments = [solver(graph, specs, b) for b in bounds]
        before = dict(launches)
        res = TorchBatchSimulator(graph, specs, bounds, policy,
                                  assignments=assignments).run()
        got = _delta(launches, before)
        require(got == {"power_step": 0, "waterfill": 0, "wave_run": 1},
                f"listing2 {policy}: launches {got}; one wave_run expected")
        plain = TorchBatchSimulator(graph, specs, bounds, policy,
                                    assignments=assignments,
                                    impl="plain").run()
        rel, abs_diff = _compare_results(res, plain, f"listing2 {policy}")
        worst = max(worst, abs_diff)
        emit("ilp", policy=policy, rows=len(res), max_rel_vs_plain=rel,
             max_abs_diff_vs_plain=abs_diff,
             makespan_s=[r.makespan for r in res])
    # The solver-free exact policies against the event simulator's
    # golden makespans; the ILP's golden depends on the HiGHS build that
    # solved it (another scipy picks another optimal assignment).
    golden = json.loads((ROOT / "tests" / "golden" / "listing2.json")
                        .read_text())["makespans"]
    golden_worst = 0.0
    for policy in ("equal-share", "oracle"):
        gb = sorted(golden, key=float)
        res = TorchBatchSimulator(graph, specs, [float(b) for b in gb],
                                  policy).run()
        for r, b in zip(res, gb):
            want = golden[b][policy]
            err = abs(r.makespan - want) / want
            require(err <= TOL, f"listing2 {policy} at {b} W: makespan "
                                f"{r.makespan} vs golden {want}")
            golden_worst = max(golden_worst, err)
    emit("golden", workload="listing2 on homogeneous_cluster(3)",
         policies=["equal-share", "oracle"],
         max_rel_vs_event_simulator=golden_worst)
    return worst


# -------------------------------------------------------- sweep phases
def _bucket_profiles(sweep):
    return [b.to_dict() for b in sweep.profile.buckets]


def phase_sweep_full_width(torch, launches, fw, smi):
    """The sweep front end at the main path's full width: the rows of
    ``full_width`` (1024 bounds x equal-share / oracle / heuristic on IS
    class C, N=64) as 3,072 scenarios through ``SweepEngine(executor=
    "torch")``, with the pipeline on and off, each run with the counts
    set to 0 just before it.  Three shared buckets, one wave_run launch
    each, and every record equal to the ``full_width`` run of its row
    (max abs diff 0.0).  Returns the pipelined run's launch counts."""
    from repro_torch.core.sweep import Scenario, SweepEngine

    graph, specs, bounds, _ = _full_width_case()
    specs = tuple(specs)
    cells = [Scenario(name="is-C-64", graph=graph, specs=specs,
                      bound_w=float(b), policy=p, latency_s=0.05)
             for p in FULL_WIDTH_POLICIES for b in bounds]
    first = None
    for pipeline in (True, False):
        engine = SweepEngine(executor="torch", vector_dt=0.05,
                             pipeline=pipeline)
        for key in launches:
            launches[key] = 0
        t0 = time.perf_counter()
        sweep = engine.run(cells)
        wall = time.perf_counter() - t0
        got = dict(launches)
        require(not sweep.failures,
                f"sweep_full_width: {len(sweep.failures)} failed records, "
                f"first: {sweep.failures[:1] and sweep.failures[0].error}")
        require(all(r.backend == "torch" for r in sweep.records),
                "sweep_full_width: a record left the torch backend")
        labels = sorted({r.bucket for r in sweep.records})
        require(len(labels) == 3 and all(b.endswith(":shared")
                                         for b in labels),
                f"sweep_full_width: buckets {labels}")
        require(got == {"power_step": 0, "waterfill": 0, "wave_run": 3},
                f"sweep_full_width: launches {got}; 3 wave_run expected")
        abs_diff = 0.0
        for k, policy in enumerate(FULL_WIDTH_POLICIES):
            recs = sweep.records[k * len(bounds):(k + 1) * len(bounds)]
            _, d = _compare_results([r.result for r in recs],
                                    fw["results"][policy],
                                    f"sweep_full_width {policy} vs "
                                    f"full_width")
            abs_diff = max(abs_diff, d)
        require(abs_diff == 0.0, f"sweep_full_width: max abs diff "
                                 f"{abs_diff} vs full_width")
        prof = sweep.profile
        emit("sweep_full_width", pipeline=pipeline, nvidia_smi=smi,
             scenarios=len(cells), buckets=labels, wall_s=wall,
             rows_per_s=len(cells) / wall, launches=got,
             max_abs_diff_vs_full_width=abs_diff,
             **{f"{ph}_s": prof.total(ph) for ph in
                ("pack", "dispatch", "run", "transfer", "results")},
             profile=_bucket_profiles(sweep))
        if first is None:
            first = got
    return first


MIXED_POLICIES = ("equal-share", "oracle", "heuristic", "ilp",
                  "ilp-makespan", "learned", "countdown")
#: policies whose batched answers match the event simulator's envelope
EXACT_POLICIES = ("equal-share", "oracle", "ilp", "ilp-makespan")


def _mixed_cells():
    """The mixed family x the seven policies (bound steps on), with a
    2 s cap a solve on the ILP cells; plus a traced cell, a cell with
    policy kwargs and a 300-node cell."""
    import dataclasses

    from repro_torch.core import (Scenario, ep_like, homogeneous_cluster,
                                  listing2_graph, mixed_family)

    cells = [dataclasses.replace(s, ilp_time_limit=2.0)
             if s.policy.startswith("ilp") else s
             for s in mixed_family(seed=0,
                                   policies=MIXED_POLICIES).scenarios()]
    l2, l2_specs = listing2_graph(), tuple(homogeneous_cluster(3))
    cells += [
        Scenario("traced", l2, l2_specs, 6.0, "equal-share",
                 trace_every=0.0),
        Scenario("kwargs", l2, l2_specs, 6.0, "heuristic",
                 policy_kwargs={"clamp_to_lut": False}),
        Scenario("ep300", ep_like(300, "A", seed=1),
                 tuple(homogeneous_cluster(300)), 1200.0, "equal-share"),
    ]
    return cells


def _planned(s):
    """(backend, fallback reason, engine path) the plan should give."""
    if s.name == "traced":
        return "vector", "trace-retention", None
    if s.name == "kwargs":
        return "event", "policy-kwargs", None
    if s.name == "ep300":
        return "vector", "lanes(300>256)", None
    if s.policy == "countdown":
        return "event", "no-vector-policy(countdown)", None
    return "torch", None, "step" if s.policy == "learned" else "cuda"


def phase_sweep_mixed(torch, launches):
    """The padded path and the fallback chain: the mixed family with the
    seven policies and the three odd cells through ``SweepEngine(
    executor="torch")`` (counts set to 0 just before it), every record
    on its planned backend, every torch record equal to the same sweep
    at ``impl="plain"`` on the card (0.0), and every exact-policy record
    inside the event simulator's envelope.  Returns the launch counts,
    the cells, the sweep and its ILP solves."""
    from repro_torch.core import SweepEngine, simulate

    cells = _mixed_cells()
    engine = SweepEngine(executor="torch")
    for key in launches:
        launches[key] = 0
    t0 = time.perf_counter()
    sweep = engine.run(cells)
    wall = time.perf_counter() - t0
    got = dict(launches)
    plain_engine = SweepEngine(executor="torch", impl="plain")
    plain_engine._assignments = engine._assignments   # the same ILP caps
    t1 = time.perf_counter()
    plain = plain_engine.run(cells)
    plain_wall = time.perf_counter() - t1
    for name, sw in (("kernel", sweep), ("plain", plain)):
        require(not sw.failures,
                f"sweep_mixed {name}: {len(sw.failures)} failed records, "
                f"first: {sw.failures[:1] and sw.failures[0].error}")
    paths = {b.bucket: b.path for b in sweep.profile.buckets}
    for rec in sweep.records:
        backend, reason, path = _planned(rec.scenario)
        require((rec.backend, rec.fallback_reason) == (backend, reason),
                f"sweep_mixed {rec.scenario.name}/{rec.scenario.policy_key}"
                f": {rec.backend}/{rec.fallback_reason}, planned "
                f"{backend}/{reason}")
        if path is not None:
            require(paths[rec.bucket] == path,
                    f"sweep_mixed {rec.bucket}: path {paths[rec.bucket]}, "
                    f"expected {path}")
    n_cuda = sum(p == "cuda" for p in paths.values())
    require(got["wave_run"] == n_cuda and got["power_step"] > 0
            and got["waterfill"] == 0,
            f"sweep_mixed: launches {got}, {n_cuda} wave_run buckets")
    torch_recs = [(a, b) for a, b in zip(sweep.records, plain.records)
                  if a.backend == "torch"]
    _, abs_diff = _compare_results([a.result for a, _ in torch_recs],
                                   [b.result for _, b in torch_recs],
                                   "sweep_mixed kernel vs plain")
    require(abs_diff == 0.0, f"sweep_mixed: max abs diff {abs_diff} vs "
                             f"impl='plain'")
    worst_ms = worst_e = 0.0
    for rec in sweep.records:
        s = rec.scenario
        if s.policy_key not in EXACT_POLICIES or s.policy_kwargs:
            continue
        ev = simulate(s.graph, list(s.specs), s.bound_w, s.policy,
                      assignment=engine._assignments.assignment_for(s),
                      latency_s=s.latency_s,
                      bound_schedule=s.bound_schedule)
        d_ms = abs(rec.result.makespan - ev.makespan)
        d_e = abs(rec.result.energy_j - ev.energy_j) / ev.energy_j
        require(d_ms <= 2 * 0.05 and d_e <= 0.01,
                f"sweep_mixed {s.name}/{s.policy_key}@{s.bound_w}: "
                f"makespan {rec.result.makespan} vs event {ev.makespan}, "
                f"energy {rec.result.energy_j} vs {ev.energy_j}")
        worst_ms, worst_e = max(worst_ms, d_ms), max(worst_e, d_e)
    emit("sweep_mixed", scenarios=len(cells), wall_s=wall,
         plain_wall_s=plain_wall, launches=got,
         summary=sweep.backend_summary(),
         max_abs_diff_vs_plain=abs_diff, torch_records=len(torch_recs),
         max_makespan_diff_vs_event_s=worst_ms,
         max_energy_rel_vs_event=worst_e,
         profile=_bucket_profiles(sweep))
    return got, cells, sweep, engine._assignments


# ------------------------------------------------------ service phases
#: Rows of a ``service_full_width`` bucket (its 3,072 cells fill 12),
#: and the Poisson round's offered rate: a bucket takes ~0.13 s of
#: arrivals to fill, longer than the 0.05 s deadline, so it flushes
#: part-full with phantom rows.
SERVICE_BUCKET_ROWS = 256
SERVICE_RATE_HZ = 2000.0


def _service_line(service, records, wall, n0, got, offered_hz):
    """What every service round prints: rates, latency percentiles,
    flushes, launches and the profile's totals over the round's own
    buckets (those past the first ``n0``)."""
    from repro_torch.serving import percentile

    st = service.stats()
    bks = service.profile.buckets[n0:]
    lat = [r.latency_s for r in records]
    rows = sum(b.rows for b in bks)
    kernel_ms = sum(b.kernel_ms or 0.0 for b in bks)
    return dict(
        requests=len(records), wall_s=wall, offered_rate_hz=offered_hz,
        achieved_rate_hz=len(records) / wall,
        launched_rows=rows, rows_per_s=rows / wall,
        latency_p50_s=percentile(lat, 50), latency_p99_s=percentile(lat, 99),
        latency_max_s=max(lat), buckets=len(bks),
        flushed_full=st.flushed_full, flushed_deadline=st.flushed_deadline,
        phantom_rows=st.phantom_rows, cache_hits=st.cache_hits,
        launches=got, compiles=service.profile.compiles,
        kernel_ms=kernel_ms, device_busy_share=kernel_ms / (1e3 * wall),
        **{f"{ph}_s": sum(getattr(b, f"{ph}_s") for b in bks)
           for ph in ("pack", "dispatch", "run", "transfer", "results")})


class _Arrivals:
    """A service seen through its ``submit``, stamping every arrival
    (``poisson_replay`` calls nothing else): the rate the stream really
    offered, beside the rate it was asked to offer."""

    def __init__(self, service):
        self.service, self.times = service, []

    def submit(self, scenario):
        self.times.append(time.perf_counter())
        return self.service.submit(scenario)

    def rate_hz(self) -> float:
        return (len(self.times) - 1) / (self.times[-1] - self.times[0])


def phase_service_full_width(torch, launches, fw, smi):
    """The streaming service at the main path's full width:
    ``sweep_full_width``'s 3,072 scenarios through ``SweepService(
    executor="torch", bucket_rows=256)``, each round with the counts set
    to 0 just before it.  (a) a burst under a 5 s deadline: 12 buckets,
    all flushed full, 12 wave_run launches, no phantom row; (b) the same
    cells again: every record from the result cache, no launch; (c) a
    fresh service under a 0.05 s deadline fed by ``poisson_replay`` at
    2,000 requests/s: deadline flushes padded with phantom rows, one
    wave_run launch a bucket.  Every record equals the ``full_width`` run
    of its row (max abs diff 0.0), and no round builds the kernels.
    Returns the launch counts of (a) and (c)."""
    from repro_torch.core.sweep import Scenario
    from repro_torch.serving import SweepService, poisson_replay

    graph, specs, bounds, _ = _full_width_case()
    specs = tuple(specs)
    cells = [Scenario(name="is-C-64", graph=graph, specs=specs,
                      bound_w=float(b), policy=p, latency_s=0.05)
             for p in FULL_WIDTH_POLICIES for b in bounds]
    want = [r for p in FULL_WIDTH_POLICIES for r in fw["results"][p]]
    none = {"power_step": 0, "waterfill": 0, "wave_run": 0}

    def held(records, what):
        require(all(r.ok for r in records),
                f"{what}: a request failed: "
                f"{next((r.error for r in records if not r.ok), None)}")
        _, d = _compare_results([r.result for r in records], want, what)
        require(d == 0.0, f"{what}: max abs diff {d} vs full_width")
        return d

    def zero():
        for key in launches:
            launches[key] = 0

    rows = SERVICE_BUCKET_ROWS
    full = len(cells) // rows
    require(len(cells) % rows == 0, "service burst: cells fill no buckets")
    out = {}
    with SweepService(executor="torch", bucket_rows=rows,
                      flush_deadline_s=5.0) as service:
        zero()
        t0 = time.perf_counter()
        tickets = service.submit_many(cells)
        submit_s = time.perf_counter() - t0
        records = [t.result(timeout=600) for t in tickets]
        wall = time.perf_counter() - t0
        got = dict(launches)
        st = service.stats()
        require(st.buckets == full and st.flushed_full == full
                and st.flushed_deadline == 0 and st.phantom_rows == 0,
                f"service burst: {st}; {full} full buckets expected")
        require(got == dict(none, wave_run=full),
                f"service burst: launches {got}; {full} wave_run "
                f"expected")
        require(all(r.backend == "torch" for r in records)
                and all(b.path == "cuda" and b.rows == rows
                        for b in service.profile.buckets),
                "service burst: a record or bucket left the wave_run path")
        require(service.profile.compiles == 0,
                "service burst: a dispatch built the kernels")
        d = held(records, "service burst")
        out["burst"] = got
        emit("service_full_width", round="burst", nvidia_smi=smi,
             max_abs_diff_vs_full_width=d, submit_s=submit_s,
             **_service_line(service, records, wall, 0, got,
                             len(cells) / submit_s))

        n0 = len(service.profile.buckets)
        zero()
        t0 = time.perf_counter()
        tickets = service.submit_many(cells)
        submit_s = time.perf_counter() - t0
        again = [t.result(timeout=60) for t in tickets]
        wall = time.perf_counter() - t0
        got = dict(launches)
        require(all(r.backend == "cache" and r.cached for r in again),
                "service resubmit: a record missed the result cache")
        require(got == none and len(service.profile.buckets) == n0,
                f"service resubmit: launches {got}; none expected")
        d = held(again, "service resubmit")
        emit("service_full_width", round="resubmit", nvidia_smi=smi,
             max_abs_diff_vs_full_width=d, submit_s=submit_s,
             **_service_line(service, again, wall, n0, got,
                             len(cells) / submit_s))

    with SweepService(executor="torch", bucket_rows=rows,
                      flush_deadline_s=0.05) as service:
        zero()
        arrivals = _Arrivals(service)
        report = poisson_replay(arrivals, cells, rate_hz=SERVICE_RATE_HZ,
                                seed=0, timeout_s=600)
        got = dict(launches)
        prof = service.profile
        st = service.stats()
        require(got == dict(none, wave_run=len(prof.buckets))
                and all(b.path == "cuda" for b in prof.buckets),
                f"service poisson: launches {got} for "
                f"{len(prof.buckets)} torch buckets")
        require(st.phantom_rows > 0 and st.flushed_deadline > 0,
                f"service poisson: {st}; deadline flushes with phantom "
                f"rows expected")
        require(prof.compiles == 0 and prof.recompiles == 0,
                "service poisson: a dispatch built the kernels")
        d = held(report.records, "service poisson")
        out["poisson"] = got
        emit("service_full_width", round="poisson", nvidia_smi=smi,
             max_abs_diff_vs_full_width=d,
             phantom_share=st.phantom_rows / (st.phantom_rows + len(cells)),
             arrival_rate_hz=arrivals.rate_hz(),
             arrival_s=arrivals.times[-1] - arrivals.times[0],
             **_service_line(service, report.records, report.wall_s, 0,
                             got, report.offered_rate_hz))
    return out


def phase_service_mixed(torch, launches, cells, sweep, assignments):
    """``sweep_mixed``'s 129 cells through ``SweepService(executor=
    "torch")`` (counts set to 0 just before it, the sweep's ILP solves
    shared): every record on the backend, with the fallback reason, of
    ``SweepEngine(executor="torch")``'s record of the same cell; torch
    records equal to it (0.0; ``learned``'s within TOL, its lane sums
    rounding with the lane padding), vector and event records inside the event
    simulator's envelope of it (2 dt, 1% energy); one wave_run launch a
    ``"cuda"`` bucket, ``learned`` on the ``"step"`` path.  Returns the
    launch counts."""
    from repro_torch.serving import SweepService

    for key in launches:
        launches[key] = 0
    with SweepService(executor="torch", flush_deadline_s=0.05) as service:
        service._assignments = assignments      # the same ILP caps
        t0 = time.perf_counter()
        records = [t.result(timeout=600)
                   for t in service.submit_many(cells)]
        wall = time.perf_counter() - t0
    got = dict(launches)
    prof = service.profile
    require(all(r.ok for r in records),
            f"service_mixed: a request failed: "
            f"{next((r.error for r in records if not r.ok), None)}")
    torch_pairs, learned = [], []
    worst_ms = worst_e = 0.0
    for rec, off in zip(records, sweep.records):
        s = rec.scenario
        require((rec.backend, rec.fallback_reason)
                == (off.backend, off.fallback_reason),
                f"service_mixed {s.name}/{s.policy_key}: "
                f"{rec.backend}/{rec.fallback_reason}, the sweep's "
                f"{off.backend}/{off.fallback_reason}")
        if rec.backend == "torch":
            (learned if s.policy == "learned" else torch_pairs).append(
                (rec.result, off.result))
            continue
        d_ms = abs(rec.result.makespan - off.result.makespan)
        d_e = abs(rec.result.energy_j - off.result.energy_j) \
            / off.result.energy_j
        require(d_ms <= 2 * 0.05 and d_e <= 0.01,
                f"service_mixed {s.name}/{s.policy_key}: makespan "
                f"{rec.result.makespan} vs {off.result.makespan}, energy "
                f"{rec.result.energy_j} vs {off.result.energy_j}")
        worst_ms, worst_e = max(worst_ms, d_ms), max(worst_e, d_e)
    _, abs_diff = _compare_results([a for a, _ in torch_pairs],
                                   [b for _, b in torch_pairs],
                                   "service_mixed vs sweep_mixed")
    require(abs_diff == 0.0, f"service_mixed: max abs diff {abs_diff} vs "
                             f"the sweep's records")
    # learned's MLP sums its lanes in torch's own order, which depends on
    # the lane count: a bucket the sweep ran in the shared layout (exact
    # N) and the service padded (pow2 N) round apart, within TOL
    learned_rel, learned_abs = _compare_results(
        [a for a, _ in learned], [b for _, b in learned],
        "service_mixed learned vs sweep_mixed")
    n_cuda = sum(b.path == "cuda" for b in prof.buckets)
    require(got["wave_run"] == n_cuda and got["power_step"] > 0
            and got["waterfill"] == 0 and prof.compiles == 0,
            f"service_mixed: launches {got}, {n_cuda} wave_run buckets, "
            f"{prof.compiles} builds")
    st = service.stats()
    emit("service_mixed", scenarios=len(cells), wall_s=wall, launches=got,
         backends={b: sum(r.backend == b for r in records)
                   for b in ("torch", "vector", "event")},
         buckets=st.buckets, step_buckets=sum(b.path == "step"
                                              for b in prof.buckets),
         phantom_rows=st.phantom_rows, fallbacks=st.fallbacks,
         latency_p50_s=st.latency_p50_s, latency_p99_s=st.latency_p99_s,
         max_abs_diff_vs_sweep=abs_diff, torch_records=len(torch_pairs),
         learned_records=len(learned),
         learned_max_rel_vs_sweep=learned_rel,
         learned_max_abs_diff_vs_sweep=learned_abs,
         max_makespan_diff_vs_sweep_s=worst_ms,
         max_energy_rel_vs_sweep=worst_e)
    return got


# ------------------------------------------------------ trace corpus
#: The ``trace_corpus`` phase's recordings: (workload, class) on 64
#: heterogeneous ranks from seed 0 — the NPB IS / CG / EP class-C
#: analogues and one MoE step, written as JSONL and read back.
TRACE_MEMBERS = (("npb-is", "C"), ("npb-cg", "C"), ("npb-ep", "C"),
                 ("moe", "A"))
TRACE_RANKS = 64
TRACE_FRACS = 32
TRACE_BUCKET_ROWS = 64
#: Reconstructed vs recorded work (``graphs_match``'s rtol, absolute
#: below 1 unit): the file round trip rounds each stamp to 1 ns.
TRACE_WORK_RTOL = 1e-8


#: The picked cells held against the plain path, split over its workers
#: (processes on the card, run side by side), as (member, policy).  The
#: plain path issues each wave's ops from the host, 3.4-5.4 ms a
#: heuristic tick wave, so the heuristic's IS-C and EP-C cells (85-153 s
#: each, alone in a worker) set the phase's wall; they are not held, to
#: keep the script inside its time limit.  The heuristic stays held on
#: npb-cg-C (47-77 s) and moe-A.  The rest took under 62 s (one worker,
#: H100 80GB HBM3).
TRACE_PLAIN_GROUPS = (
    (("npb-cg-C", "heuristic"),),
    (("npb-cg-C", "oracle"),),
    (("npb-cg-C", "equal-share"), ("moe-A", "equal-share"),
     ("moe-A", "oracle"), ("moe-A", "heuristic")),
    (("npb-is-C", "equal-share"), ("npb-is-C", "oracle"),
     ("npb-ep-C", "equal-share"), ("npb-ep-C", "oracle")),
)


def _trace_family(corpus_dir):
    """The recorded corpus as a family: 32 bound fractions evenly in
    [0.05, 0.95] x equal-share / oracle / heuristic (384 cells)."""
    import numpy as np

    from repro_torch.core import ScenarioFamily

    fracs = tuple(float(f) for f in np.linspace(0.05, 0.95, TRACE_FRACS))
    return ScenarioFamily.from_corpus(corpus_dir, bound_fracs=fracs,
                                      policies=FULL_WIDTH_POLICIES)


def _trace_picks(n_members):
    """Indices into the family's cells of the 12 picked: one bound
    fraction a member and policy — equal-share and oracle spread over the
    range, the heuristic at 0.95 (its fewest tick waves: the plain path
    runs a wave's ops from the host).  :data:`TRACE_PLAIN_GROUPS` says
    which are held against the plain path."""
    picks, top = [], TRACE_FRACS - 1
    for m in range(n_members):
        spread = m * top // max(1, n_members - 1)
        for p, policy in enumerate(FULL_WIDTH_POLICIES):
            f = {"equal-share": spread, "oracle": top - spread,
                 "heuristic": top}[policy]
            picks.append((m * TRACE_FRACS + f) * len(FULL_WIDTH_POLICIES)
                         + p)
    return picks


def _trace_worker(queue, what, corpus_dir, group) -> None:
    """Worker process of ``trace_corpus``: the picked cells of
    ``group`` (``(member, policy)`` pairs) through the sweep at
    ``impl="plain"`` on the card (``what="plain"``), or the event
    simulator on the host (``what="event"``).  Sends back ``{pick
    position: (seconds, ...)}``, or the traceback of a failure."""
    import traceback

    try:
        sys.path.insert(0, str(SRC))
        from repro_torch.core import SweepEngine, simulate

        cells = _trace_family(corpus_dir).scenarios()
        picked = [(k, cells[i]) for k, i in
                  enumerate(_trace_picks(len(TRACE_MEMBERS)))
                  if (cells[i].tags["member"], cells[i].policy) in group]
        out = {}
        if what == "plain":
            engine = SweepEngine(executor="torch", impl="plain")
            for k, s in picked:
                t0 = time.perf_counter()
                rec = engine.run([s]).records[0]
                out[k] = (time.perf_counter() - t0, rec.backend,
                          rec.error, rec.result)
        else:
            for k, s in picked:
                t0 = time.perf_counter()
                ev = simulate(s.graph, list(s.specs), s.bound_w, s.policy,
                              latency_s=s.latency_s,
                              bound_schedule=s.bound_schedule)
                out[k] = (time.perf_counter() - t0, ev.makespan,
                          ev.energy_j)
        queue.put(("ok", out))
    except Exception:     # reported to the parent, which fails the run
        queue.put(("error", traceback.format_exc()))


def _collect(proc, queue, what, timeout=900.0):
    """A worker's ``("ok", out)``: fails at once if the worker died
    without sending, or reported an error, or ran past ``timeout``."""
    import queue as _queue

    deadline = time.perf_counter() + timeout
    while True:
        try:
            status, out = queue.get(timeout=5.0)
            break
        except _queue.Empty:
            require(proc.is_alive(), f"{what} worker exited "
                                     f"({proc.exitcode}) without a result")
            require(time.perf_counter() < deadline,
                    f"{what} worker ran past {timeout} s")
    proc.join(timeout=60)
    require(status == "ok", f"{what} worker failed:\n{out}")
    return out


def phase_trace_corpus(torch, launches, smi):
    """Recorded MPI traces through the port's traces package onto the
    card: four 64-rank heterogeneous recordings (``record_workload``,
    seed 0) written as JSONL, loaded strictly (``TraceCorpus.from_dir``),
    replay-validated and held against the recorded graphs; their family
    (``ScenarioFamily.from_corpus``, 32 bound fractions x three policies,
    384 cells) through ``SweepEngine(executor="torch")`` with the counts
    set to 0 just before it: no failure, no event fallback, every record
    on ``"torch"``, every bucket one wave_run launch, no kernel build.
    10 of 12 picked cells equal ``impl="plain"`` on the card (0.0; four
    spawned workers, ``TRACE_PLAIN_GROUPS``, beside the rest) and, for
    the exact policies, lie inside the event simulator's envelope (2 dt,
    1% energy; one more worker, on the host).  The
    same 384 cells through ``SweepService(executor="torch",
    bucket_rows=64)`` as a burst: every record 0.0 against the sweep's.
    Then the serve CLI's sweep mode in process on the recorded corpus
    (``--expect-clean``), and in a subprocess on ``examples/traces`` with
    ``REPRO_TRACE`` set: both return 0, and the trace file holds the
    ``service`` and ``power:*`` tracks.  Returns the launch counts."""
    import multiprocessing as mp
    import os
    import tempfile

    from repro_torch.core import SweepEngine, workloads
    from repro_torch.launch import serve
    from repro_torch.serving import SweepService, percentile
    from repro_torch.traces import (TraceCorpus, dump_trace, graphs_match,
                                    load_trace, reconstruct,
                                    record_workload)

    def zero():
        for key in launches:
            launches[key] = 0

    builders = {"npb-is": workloads.is_builder,
                "npb-cg": workloads.cg_builder,
                "npb-ep": workloads.ep_builder}
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="trace_corpus_")
    corpus_dir = Path(tmp.name) / "corpus"
    corpus_dir.mkdir()
    workers = []
    traced = None
    ctx = mp.get_context("spawn")
    try:
        # 1. record
        truth, members = {}, []
        for workload, klass in TRACE_MEMBERS:
            name = f"{workload}-{klass}"
            t0 = time.perf_counter()
            trace = record_workload(workload, n_nodes=TRACE_RANKS,
                                    klass=klass, seed=0, hetero=True)
            record_s = time.perf_counter() - t0
            path = corpus_dir / f"{name}.jsonl"
            dump_trace(trace, path)
            truth[name] = (workloads.moe_step_builder(TRACE_RANKS, seed=0)
                           if workload == "moe" else
                           builders[workload](TRACE_RANKS, klass,
                                              seed=0)).build()
            members.append(dict(name=name, ranks=trace.ranks,
                                records=len(trace.events),
                                bytes=path.stat().st_size,
                                record_s=record_s))
        members.sort(key=lambda m: m["name"])    # the corpus's order
        # the plain path (on the card) and the event simulator (on the
        # host) on the picked cells, beside the rest of the phase
        exact = tuple((m["name"], p) for m in members
                      for p in FULL_WIDTH_POLICIES if p in EXACT_POLICIES)
        for what, group in ([("plain", g) for g in TRACE_PLAIN_GROUPS]
                            + [("event", exact)]):
            queue = ctx.Queue()
            proc = ctx.Process(target=_trace_worker,
                               args=(queue, what, str(corpus_dir), group))
            proc.start()
            workers.append((what, proc, queue))

        # 2. load strictly, replay-validate, hold against the recordings
        for m in members:
            t0 = time.perf_counter()
            trace = load_trace(corpus_dir / f"{m['name']}.jsonl")
            t1 = time.perf_counter()
            recon = reconstruct(trace, validate=False)
            m.update(load_s=t1 - t0, reconstruct_s=time.perf_counter() - t1,
                     jobs=len(recon.graph))
        t0 = time.perf_counter()
        corpus = TraceCorpus.from_dir(corpus_dir)
        corpus_load_s = time.perf_counter() - t0
        require(corpus.names == [m["name"] for m in members],
                f"trace_corpus: corpus {corpus.names}")
        t0 = time.perf_counter()
        reports = corpus.validate()
        validate_s = time.perf_counter() - t0
        for m, entry, rep in zip(members, corpus, reports):
            require(rep.ok, f"trace_corpus: replay of {m['name']}: {rep}")
            require(entry.recon.report.clean,
                    f"trace_corpus: {m['name']} reconstruction not clean")
            # JSONL stamps are written to 1 ns: a recovered work is the
            # recorded one within ~1e-9 x the rank's speed (<= 1.32)
            require(graphs_match(entry.recon.graph, truth[m["name"]],
                                 work_rtol=TRACE_WORK_RTOL),
                    f"trace_corpus: {m['name']} reconstruction differs "
                    f"from the recorded graph")
            m.update(replay_rel_err=rep.rel_err,
                     sim_makespan_s=rep.sim_makespan_s)

        # 3. the family; 4. the sweep
        t0 = time.perf_counter()
        family = _trace_family(corpus_dir)
        cells = family.scenarios()
        family_s = time.perf_counter() - t0
        require(len(cells) == len(TRACE_MEMBERS) * TRACE_FRACS
                * len(FULL_WIDTH_POLICIES),
                f"trace_corpus: {len(cells)} cells")
        engine = SweepEngine(executor="torch")
        zero()
        t0 = time.perf_counter()
        sweep = engine.run(cells)
        sweep_wall = time.perf_counter() - t0
        sweep_launches = dict(launches)
        prof = sweep.profile
        require(not sweep.failures,
                f"trace_corpus sweep: {len(sweep.failures)} failed records, "
                f"first: {sweep.failures[:1] and sweep.failures[0].error}")
        require(sweep.event_fallbacks() == [],
                f"trace_corpus sweep: {len(sweep.event_fallbacks())} event "
                f"fallbacks")
        require(all(r.backend == "torch" for r in sweep.records),
                "trace_corpus sweep: a record left the torch backend")
        require(all(b.path == "cuda" for b in prof.buckets)
                and sweep_launches == {"power_step": 0, "waterfill": 0,
                                       "wave_run": len(prof.buckets)},
                f"trace_corpus sweep: launches {sweep_launches} for "
                f"{len(prof.buckets)} buckets")
        require(prof.compiles == 0, "trace_corpus sweep: a kernel build")
        for rec in sweep.records:
            require(len(rec.result.job_ends) == len(rec.scenario.graph),
                    f"trace_corpus sweep: {rec.scenario.name} did not "
                    f"complete every job")

        # 6. the service, as a burst
        zero()
        with SweepService(executor="torch",
                          bucket_rows=TRACE_BUCKET_ROWS) as service:
            t0 = time.perf_counter()
            served = [t.result(timeout=600)
                      for t in service.submit_many(cells)]
            service_wall = time.perf_counter() - t0
        service_launches = dict(launches)
        sprof = service.profile
        require(all(r.ok and r.backend == "torch" for r in served),
                "trace_corpus service: a request failed or left torch")
        require(sprof.compiles == 0 and all(b.path == "cuda"
                                            for b in sprof.buckets)
                and service_launches["wave_run"] == len(sprof.buckets),
                f"trace_corpus service: launches {service_launches} for "
                f"{len(sprof.buckets)} buckets, {sprof.compiles} builds")
        _, service_diff = _compare_results(
            [r.result for r in served], [r.result for r in sweep.records],
            "trace_corpus service vs sweep")
        require(service_diff == 0.0, f"trace_corpus service: max abs diff "
                                     f"{service_diff} vs the sweep")

        # 7. the serve CLI in process, on the recorded corpus
        zero()
        summary_path = Path(tmp.name) / "serve.json"
        t0 = time.perf_counter()
        rc = serve.main(["--trace-corpus", str(corpus_dir), "--executor",
                         "torch", "--expect-clean", "--rate-hz", "200",
                         "--repeat", "2", "--bucket-rows",
                         str(TRACE_BUCKET_ROWS), "--json",
                         str(summary_path)])
        cli_wall = time.perf_counter() - t0
        cli_launches = dict(launches)
        require(rc == 0, f"trace_corpus serve CLI: exit {rc}")
        cli = json.loads(summary_path.read_text())

        # 8. the serve CLI with REPRO_TRACE, in a process of its own
        trace_json = Path(tmp.name) / "serve_trace.json"
        env = dict(os.environ, REPRO_TRACE=str(trace_json),
                   PYTHONPATH=str(SRC))
        t0 = time.perf_counter()
        traced = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve",
             "--trace-corpus", str(ROOT / "examples" / "traces"),
             "--executor", "torch", "--expect-clean", "--rate-hz", "200",
             "--repeat", "2", "--bucket-rows", str(TRACE_BUCKET_ROWS)],
            cwd=tmp.name, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        traced_out, _ = traced.communicate(timeout=600)
        traced_wall = time.perf_counter() - t0
        require(traced.returncode == 0,
                f"trace_corpus traced serve CLI: exit {traced.returncode}"
                f"\n{traced_out}")
        events = json.loads(trace_json.read_text())
        tracks = sorted({e["args"]["name"] for e in events
                         if e["ph"] == "M" and e["name"] == "process_name"})
        require("service" in tracks
                and any(t.startswith("power:") for t in tracks),
                f"trace_corpus traced serve CLI: tracks {tracks}")

        # 5. the picked cells against the plain path and the event
        # simulator: the workers' results
        plain, event = {}, {}
        for what, proc, queue in workers:
            (plain if what == "plain" else event).update(
                _collect(proc, queue, f"trace_corpus {what}"))
        picks = _trace_picks(len(TRACE_MEMBERS))
        pairs = {pair for group in TRACE_PLAIN_GROUPS for pair in group}
        held = [k for k, i in enumerate(picks)
                if (sweep.records[i].scenario.tags["member"],
                    sweep.records[i].scenario.policy) in pairs]
        require(sorted(plain) == held and len(held) == len(pairs),
                f"trace_corpus plain: cells {sorted(plain)}, {held} held")
        require(all(b == "torch" and e is None
                    for _, b, e, _ in plain.values()),
                "trace_corpus plain: a picked cell failed or left torch")
        plain_rel, plain_diff = _compare_results(
            [sweep.records[picks[k]].result for k in held],
            [plain[k][3] for k in held],
            "trace_corpus sweep vs plain")
        require(plain_diff == 0.0, f"trace_corpus: max abs diff "
                                   f"{plain_diff} vs impl='plain'")
        require(len(event) == len(exact),
                f"trace_corpus event: {len(event)} cells")
        worst_ms = worst_e = 0.0
        for k, ev in event.items():
            rec = sweep.records[picks[k]]
            d_ms = abs(rec.result.makespan - ev[1])
            d_e = abs(rec.result.energy_j - ev[2]) / ev[2]
            require(d_ms <= 2 * 0.05 and d_e <= 0.01,
                    f"trace_corpus {rec.scenario.name}/"
                    f"{rec.scenario.policy}@{rec.scenario.bound_w}: "
                    f"makespan {rec.result.makespan} vs event {ev[1]}, "
                    f"energy {rec.result.energy_j} vs {ev[2]}")
            worst_ms, worst_e = max(worst_ms, d_ms), max(worst_e, d_e)
    finally:
        for _, proc, _ in workers:
            if proc.is_alive():
                proc.terminate()
                proc.join()
        if traced is not None and traced.poll() is None:
            traced.kill()
            traced.wait()
        tmp.cleanup()
    lat = [r.latency_s for r in served]
    results_s = [b.results_s for b in prof.buckets]
    emit("trace_corpus", nvidia_smi=smi, members=members,
         corpus_load_s=corpus_load_s, validate_s=validate_s,
         family_s=family_s, cells=len(cells), sweep_wall_s=sweep_wall,
         rows_per_s=len(cells) / sweep_wall, summary=sweep.backend_summary(),
         buckets=[b.bucket for b in prof.buckets],
         bucket_rows=[b.rows for b in prof.buckets],
         results_s=results_s, results_share=sum(results_s) / sweep_wall,
         kernel_ms=[b.kernel_ms for b in prof.buckets],
         **{f"{ph}_s": prof.total(ph) for ph in
            ("pack", "dispatch", "run", "transfer")},
         launches=sweep_launches, plain_cells=len(held),
         plain_cell_s=[plain[k][0] for k in held],
         max_abs_diff_vs_plain=plain_diff, max_rel_vs_plain=plain_rel,
         event_cell_s={k: v[0] for k, v in sorted(event.items())},
         max_makespan_diff_vs_event_s=worst_ms,
         max_energy_rel_vs_event=worst_e,
         service=dict(wall_s=service_wall,
                      rows_per_s=len(served) / service_wall,
                      latency_p50_s=percentile(lat, 50),
                      latency_p99_s=percentile(lat, 99),
                      buckets=len(sprof.buckets),
                      phantom_rows=service.stats().phantom_rows,
                      launches=service_launches,
                      results_s=sprof.total("results"),
                      max_abs_diff_vs_sweep=service_diff),
         cli={k: cli[k] for k in ("requests", "wall_s", "throughput_rps",
                                  "latency_p50_s", "latency_p99_s",
                                  "fallbacks", "cache_hits", "compiles",
                                  "recompiles", "compiles_after_warmup")}
         | dict(rc=rc, wall_s_in_process=cli_wall, launches=cli_launches),
         cli_traced=dict(rc=traced.returncode, wall_s=traced_wall,
                         events=len(events), tracks=tracks),
         phase_wall_s=time.perf_counter() - t_phase)
    return sweep_launches


# ------------------------------------------------------------- cluster
#: Phase ``cluster``: the outer policies, run once per stream and policy.
CLUSTER_POLICY_NAMES = ("fifo-equal-split", "backfill", "power-aware",
                        "fair-share")
#: Stream A: the bundled 1,000-job stream over the ``mixed`` pool.
CLUSTER_1K = ROOT / "examples" / "cluster" / "arrivals_1k.jsonl"
CLUSTER_1K_NODES = 12
CLUSTER_BOUND_FRAC = 0.5
CLUSTER_LEVELS = 6
#: Stream B: a Poisson stream over the four 64-rank recordings of
#: ``trace_corpus`` (``TRACE_MEMBERS``) on a 256-node pool, offered
#: ``CLUSTER_RATE_FACTOR`` x what four jobs at full power finish.
CLUSTER_CORPUS_JOBS = 128
CLUSTER_CORPUS_NODES = 256
CLUSTER_RATE_FACTOR = 1.5
#: The event simulator's envelope (and the vector backend's control
#: tick): 2 dt on makespan, 1% on energy.
ENVELOPE_DT = 0.05


def _cluster_worker(queue, what, payload) -> None:
    """Worker process of phase ``cluster``.  ``what="plain"``: the
    pickled replay cells through the sweep at ``impl="plain"`` on the
    card, one at a time, sending back ``[(seconds, backend, error,
    result)]``.  ``what="vector"``: a pickled ``{policy: cells}`` through
    ``SweepEngine(executor="vector")`` on the host, sending back
    ``{policy: (seconds, [(backend, error, makespan, energy)])}``.  A
    failure sends its traceback."""
    import pickle
    import traceback

    try:
        sys.path.insert(0, str(SRC))
        from repro_torch.core import SweepEngine

        cells = pickle.loads(payload)
        if what == "plain":
            engine = SweepEngine(executor="torch", impl="plain")
            out = []
            for s in cells:
                t0 = time.perf_counter()
                rec = engine.run([s]).records[0]
                out.append((time.perf_counter() - t0, rec.backend,
                            rec.error, rec.result))
        else:
            out = {}
            for policy, group in cells.items():
                t0 = time.perf_counter()
                sweep = SweepEngine(executor="vector").run(group)
                out[policy] = (time.perf_counter() - t0,
                               _cluster_vector_rows(sweep))
        queue.put(("ok", out))
    except Exception:     # reported to the parent, which fails the run
        queue.put(("error", traceback.format_exc()))


def _cluster_vector_rows(sweep):
    """What the envelope check reads of a vector sweep (picklable)."""
    return [(r.backend, r.error, r.result.makespan if r.ok else None,
             r.result.energy_j if r.ok else None) for r in sweep.records]


def _cluster_record_corpus(corpus_dir):
    """``trace_corpus``'s four 64-rank recordings (seed 0), written as
    JSONL into ``corpus_dir``."""
    from repro_torch.traces import dump_trace, record_workload

    for workload, klass in TRACE_MEMBERS:
        trace = record_workload(workload, n_nodes=TRACE_RANKS, klass=klass,
                                seed=0, hetero=True)
        dump_trace(trace, corpus_dir / f"{workload}-{klass}.jsonl")


def _cluster_envelope(records, vector, what):
    """Each torch record inside the event envelope of its vector twin
    (``(backend, error, makespan, energy)``): returns the largest
    relative makespan and energy differences."""
    worst_ms = worst_e = 0.0
    for rec, (backend, err, ms, energy) in zip(records, vector):
        require(backend == "vector" and err is None,
                f"{what}: vector row {rec.scenario.name} on {backend} "
                f"({err})")
        got = rec.result
        require(abs(got.makespan - ms) <= 2 * ENVELOPE_DT
                and abs(got.energy_j - energy) <= 0.01 * energy,
                f"{what}: {rec.scenario.name} makespan {got.makespan} vs "
                f"vector {ms}, energy {got.energy_j} vs {energy}")
        worst_ms = max(worst_ms, abs(got.makespan - ms) / ms)
        worst_e = max(worst_e, abs(got.energy_j - energy) / energy)
    return worst_ms, worst_e


class _ClusterStream:
    """One stream's run through the port's cluster entry points on the
    card: the calibration, then per policy the outer loop and the
    replay, each sweep with the launch counts set to 0 just before it
    and read just after.  Every torch sweep's bucket profiles are kept
    in order (``profiles``) for the phase's no-late-build check."""

    def __init__(self, name, launches, profiles):
        self.name = name
        self.launches = launches
        self.profiles = profiles
        self.line = {"stream": name}
        self.results, self.checks = {}, {}
        self.wave_run = 0

    def _counted(self, fn):
        """``fn()``, its wall and the launches it made."""
        for key in self.launches:
            self.launches[key] = 0
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, dict(self.launches)

    def _sweep_checks(self, sweep, launches, what):
        prof = sweep.profile
        require(not sweep.failures, f"{what}: {len(sweep.failures)} failed "
                                    f"records")
        require(sweep.event_fallbacks() == [],
                f"{what}: {len(sweep.event_fallbacks())} event fallbacks")
        require(all(r.backend == "torch" for r in sweep.records),
                f"{what}: a record left the torch backend")
        require(all(b.path == "cuda" for b in prof.buckets)
                and launches == {"power_step": 0, "waterfill": 0,
                                 "wave_run": len(prof.buckets)},
                f"{what}: launches {launches} for {len(prof.buckets)} "
                f"buckets")
        self.profiles.append(prof)
        self.wave_run += launches["wave_run"]

    def calibrate(self, model):
        sweep, wall, launches = self._counted(model.calibrate)
        what = f"cluster {self.name} calibration"
        self._sweep_checks(sweep, launches, what)
        self.line["calibration"] = dict(
            wall_s=wall, cells=len(sweep), buckets=len(sweep.profile.buckets),
            launches=launches["wave_run"],
            kernel_ms=[b.kernel_ms for b in sweep.profile.buckets],
            summary=sweep.backend_summary())

    def outer_loops(self, trace, bound, nodes, model):
        from repro_torch.cluster import ClusterScheduler, report

        self.line["policies"] = {}
        for policy in CLUSTER_POLICY_NAMES:
            t0 = time.perf_counter()
            result = ClusterScheduler(trace, bound_w=bound, total_nodes=nodes,
                                      policy=policy, model=model).run()
            wall = time.perf_counter() - t0
            require(len(result.runs) == len(trace.jobs)
                    and all(r.end_t is not None for r in result.runs),
                    f"cluster {self.name} {policy}: the stream did not drain")
            self.results[policy] = result
            sched = [len(c.bound_schedule) for c in result.scenarios()]
            self.line["policies"][policy] = dict(
                outer_loop_s=wall,
                report={k: v for k, v in report(result).as_dict().items()
                        if k not in ("policy", "bound_w", "total_nodes")},
                schedule_cols_max=max(sched),
                schedule_cols_mean=sum(sched) / len(sched))

    def replays(self):
        from repro_torch.cluster import replay

        for policy, result in self.results.items():
            what = f"cluster {self.name} {policy} replay"
            check, wall, launches = self._counted(lambda: replay(result))
            require(check.event_fallbacks == 0 and check.recompiles == 0,
                    f"{what}: {check.event_fallbacks} event fallbacks, "
                    f"{check.recompiles} recompiles")
            self._sweep_checks(check.sweep, launches, what)
            for rec in check.sweep.records:
                require(len(rec.result.job_ends) == len(rec.scenario.graph)
                        and math.isfinite(rec.result.makespan)
                        and rec.result.makespan > 0,
                        f"{what}: {rec.scenario.name} did not complete")
            self.checks[policy] = check
            prof = check.sweep.profile
            results_s = prof.total("results")
            self.line["policies"][policy].update(
                replay_wall_s=wall, rows=len(check.sweep),
                rows_per_s=len(check.sweep) / wall, results_s=results_s,
                results_share=results_s / wall,
                launches=launches["wave_run"],
                buckets=[b.bucket for b in prof.buckets],
                kernel_ms=[b.kernel_ms for b in prof.buckets],
                max_rel_err=check.max_rel_err,
                mean_rel_err=check.mean_rel_err,
                event_fallbacks=check.event_fallbacks,
                recompiles=check.recompiles)

    def vector(self, policy, seconds, rows):
        """Hold ``policy``'s replay against its vector twin's ``rows``."""
        ms, energy = _cluster_envelope(self.checks[policy].sweep.records,
                                       rows, f"cluster {self.name} {policy} "
                                             f"vs vector")
        self.line["policies"][policy].update(
            vector_s=seconds, max_makespan_rel_vs_vector=ms,
            max_energy_rel_vs_vector=energy)


def phase_cluster(torch, launches, smi):
    """The cluster scheduler (``repro_torch.cluster``) on the card, two
    streams through the port's entry points with ``device=None``: the
    rate model's calibration sweep, the outer discrete-event loop of each
    of the four outer policies once, and the replay of that one
    ``ClusterResult`` (every job's realized watt history as its bound
    schedule) through ``replay``, each sweep with the launch counts set
    to 0 just before it: no failure, no event fallback, every record on
    ``"torch"``, every bucket one ``wave_run`` launch, no kernel build
    after the phase's first dispatch.  Every replay row lies inside the
    event envelope (2 dt, 1% energy) of the same cells on
    ``executor="vector"`` on the host.

    Stream A is the bundled 1,000-job stream on 12 nodes at
    ``suggest_bound(frac=0.5)``: every replay record equals the same
    cells on ``impl="plain"`` on the card (at ``TOL``), power-aware's
    stream makespan is below fifo-equal-split's, and ``python -m
    repro_torch.cluster run ... --expect-clean`` exits 0 in a process of
    its own, once plain and once with ``REPRO_TRACE`` (whose file holds
    the ``cluster`` track).  Stream B is ``CLUSTER_CORPUS_JOBS`` Poisson
    arrivals (seed 0) over ``trace_corpus``'s four 64-rank recordings on
    256 nodes, at ``CLUSTER_RATE_FACTOR`` x 4 / the members' mean
    calibrated makespan at their top level: one replay row a member
    (each from another policy) equals ``impl="plain"`` in spawned card
    workers.  Prints one line a stream; returns the launch counts."""
    import multiprocessing as mp
    import os
    import pickle
    import tempfile

    from repro_torch.cluster import (ArrivalJob, ArrivalTrace, RateModel,
                                     load_arrivals, member_pool,
                                     poisson_arrivals, replay,
                                     suggest_bound)
    from repro_torch.core import SweepEngine

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="cluster_")
    ctx = mp.get_context("spawn")
    workers, clis, profiles = [], [], []
    try:
        # the CLI, twice in processes of its own, beside the rest
        env = dict(os.environ, PYTHONPATH=str(SRC))
        env.pop("REPRO_TRACE", None)
        trace_json = Path(tmp.name) / "cluster_trace.json"
        for traced in (False, True):
            argv = [sys.executable, "-m", "repro_torch.cluster", "run",
                    str(CLUSTER_1K), "--nodes", str(CLUSTER_1K_NODES),
                    "--bound-frac", str(CLUSTER_BOUND_FRAC),
                    "--levels", str(CLUSTER_LEVELS), "--expect-clean",
                    "--json", str(Path(tmp.name) / f"cli_{traced}.json")]
            clis.append((traced, time.perf_counter(), subprocess.Popen(
                argv, cwd=tmp.name, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
                env=dict(env, REPRO_TRACE=str(trace_json)) if traced
                else env)))

        # ---- stream B: the corpus stream at real size
        b = _ClusterStream("cluster_corpus", launches, profiles)
        corpus_dir = Path(tmp.name) / "corpus"
        corpus_dir.mkdir()
        t0 = time.perf_counter()
        _cluster_record_corpus(corpus_dir)
        b.line["record_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pool = member_pool(str(corpus_dir))
        b.line["pool_s"] = time.perf_counter() - t0
        b.line["members"] = {m.name: dict(zip(("nodes", "jobs"), m.shape))
                             for m in pool}
        # calibrate on the pool (one arrival a member), then generate
        # the stream at the rate the curves give
        model = RateModel(ArrivalTrace(
            pool, [ArrivalJob(name=m.name, t=0.0, member=m.name)
                   for m in pool]), levels=CLUSTER_LEVELS)
        b.calibrate(model)
        best = [model.best_makespan(m.name) for m in pool]
        rate_hz = CLUSTER_RATE_FACTOR * 4 / (sum(best) / len(best))
        print(f"cluster_corpus: rate_hz {rate_hz!r} (best makespans "
              f"{best})", flush=True)
        trace = poisson_arrivals(pool, n_jobs=CLUSTER_CORPUS_JOBS,
                                 rate_hz=rate_hz, seed=0)
        model.trace = trace
        bound = suggest_bound(trace, CLUSTER_CORPUS_NODES,
                              frac=CLUSTER_BOUND_FRAC)
        b.line.update(rate_hz=rate_hz, best_makespan_s=best, bound_w=bound,
                      nodes=CLUSTER_CORPUS_NODES, jobs=len(trace))
        b.outer_loops(trace, bound, CLUSTER_CORPUS_NODES, model)
        # one replay row a member (the job with the longest schedule,
        # each member from another policy) on the plain path in card
        # workers, and every row on the vector executor in host workers
        # (one a policy: an npb-cg row is ~12k waves on the host too)
        b_cells = {p: r.scenarios() for p, r in b.results.items()}
        picks = []
        for i, m in enumerate(pool):
            policy = CLUSTER_POLICY_NAMES[i % len(CLUSTER_POLICY_NAMES)]
            rows = [k for k, c in enumerate(b_cells[policy])
                    if c.tags["member"] == m.name]
            require(rows, f"cluster_corpus: no {m.name} job in {policy}")
            picks.append((policy, max(rows, key=lambda k: (
                len(b_cells[policy][k].bound_schedule), -k))))
        for what, payload in (
                [("plain", pickle.dumps([b_cells[p][k]]))
                 for p, k in picks]
                + [("vector", pickle.dumps({p: cells}))
                   for p, cells in b_cells.items()]):
            queue = ctx.Queue()
            proc = ctx.Process(target=_cluster_worker,
                               args=(queue, what, payload))
            proc.start()
            workers.append((what, proc, queue))
        b.replays()

        # ---- stream A: the bundled 1k stream
        a = _ClusterStream("cluster_1k", launches, profiles)
        t0 = time.perf_counter()
        trace_a = load_arrivals(CLUSTER_1K)
        a.line["load_s"] = time.perf_counter() - t0
        bound_a = suggest_bound(trace_a, CLUSTER_1K_NODES,
                                frac=CLUSTER_BOUND_FRAC)
        a.line.update(bound_w=bound_a, nodes=CLUSTER_1K_NODES,
                      jobs=len(trace_a))
        model_a = RateModel(trace_a, levels=CLUSTER_LEVELS)
        a.calibrate(model_a)
        a.outer_loops(trace_a, bound_a, CLUSTER_1K_NODES, model_a)
        aware = a.results["power-aware"].makespan
        fifo = a.results["fifo-equal-split"].makespan
        require(aware < fifo, f"cluster_1k: power-aware makespan {aware} "
                              f"not below fifo-equal-split's {fifo}")
        a.replays()
        plain_engine = SweepEngine(executor="torch", impl="plain")
        for policy, result in a.results.items():
            t0 = time.perf_counter()
            plain = replay(result, engine=plain_engine)
            plain_s = time.perf_counter() - t0
            rel, diff = _compare_results(
                [r.result for r in a.checks[policy].sweep.records],
                [r.result for r in plain.sweep.records],
                f"cluster_1k {policy} vs plain")
            t0 = time.perf_counter()
            vec = replay(result, executor="vector")
            vector_s = time.perf_counter() - t0
            require(vec.event_fallbacks == 0,
                    f"cluster_1k {policy}: vector event fallbacks")
            a.vector(policy, vector_s, _cluster_vector_rows(vec.sweep))
            a.line["policies"][policy].update(
                plain_s=plain_s, max_abs_diff_vs_plain=diff,
                max_rel_vs_plain=rel)

        # ---- stream B's workers
        plain_b = []
        for what, proc, queue in workers:
            out = _collect(proc, queue, f"cluster_corpus {what}")
            if what == "plain":
                plain_b += out
            else:
                for policy, (seconds, rows) in out.items():
                    b.vector(policy, seconds, rows)
        require(len(plain_b) == len(picks)
                and all(bk == "torch" and e is None
                        for _, bk, e, _ in plain_b),
                "cluster_corpus plain: a picked row failed or left torch")
        rel, diff = _compare_results(
            [b.checks[p].sweep.records[k].result for p, k in picks],
            [r for _, _, _, r in plain_b], "cluster_corpus vs plain")
        b.line["plain"] = dict(
            rows=[f"{p}/{b_cells[p][k].tags['job']}"
                  f"/{b_cells[p][k].tags['member']}" for p, k in picks],
            schedule_cols=[len(b_cells[p][k].bound_schedule)
                           for p, k in picks],
            row_s=[s for s, _, _, _ in plain_b],
            max_abs_diff_vs_plain=diff, max_rel_vs_plain=rel)

        # ---- the CLI runs
        for traced, t0, proc in clis:
            out, _ = proc.communicate(timeout=900)
            wall = time.perf_counter() - t0
            require(proc.returncode == 0,
                    f"cluster CLI{' (traced)' if traced else ''}: exit "
                    f"{proc.returncode}\n{out}")
            summary = json.loads(
                (Path(tmp.name) / f"cli_{traced}.json").read_text())
            entry = dict(rc=proc.returncode, wall_s=wall, makespans={
                p["policy"]: p["makespan"] for p in summary["policies"]})
            if traced:
                events = json.loads(trace_json.read_text())
                tracks = sorted({e["args"]["name"] for e in events
                                 if e["ph"] == "M"
                                 and e["name"] == "process_name"})
                admits = sum(e["name"] == "admit" and e["cat"] == "cluster"
                             for e in events)
                require("cluster" in tracks and admits == len(trace_a)
                        * len(CLUSTER_POLICY_NAMES),
                        f"cluster traced CLI: tracks {tracks}, {admits} "
                        f"admits")
                entry.update(events=len(events), tracks=tracks)
            a.line["cli_traced" if traced else "cli"] = entry
    finally:
        for _, proc, _ in workers:
            if proc.is_alive():
                proc.terminate()
                proc.join()
        for _, _, proc in clis:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.cleanup()

    # no kernel build after the phase's first dispatch
    built = [b.compiled for prof in profiles for b in prof.buckets]
    require(not any(built[1:]), f"cluster: {sum(built[1:])} kernel builds "
                                f"after the first dispatch")
    wall = time.perf_counter() - t_phase
    for stream in (a, b):
        emit("cluster", nvidia_smi=smi, **stream.line,
             wave_run_launches=stream.wave_run, kernel_builds=sum(built),
             phase_wall_s=wall)
    return {"wave_run": a.wave_run + b.wave_run,
            "cluster_1k": a.wave_run, "cluster_corpus": b.wave_run}


# ---------------------------------------------------- differentiable layer
#: Phase ``diff``: the temperature of the gradient checks, the central
#: difference step and the bars (float64, the reference's x64 bars).
DIFF_T = 0.1
DIFF_FD_H = 1e-5
DIFF_VALUE_RTOL = 1e-9
DIFF_GRAD_RTOL = 1e-7
DIFF_FD_RTOL = 1e-3
DIFF_LADDER = (0.5, 0.2, 0.1, 0.05, 0.02)
#: ``benchmarks/diff_opt.py`` without ``--quick``: Listing 2 at three
#: bounds, 300 Adam steps, a gap to the ILP of at most +2%.
DIFF_BOUNDS = (7.0, 9.0, 12.0)
#: Adam steps of each gradient-descended bound (300 until PR 30, cut to
#: 150 for the card script's wall: at 150 the gaps to the ILP are -4.8%,
#: -0.4% and -0.02% on the CPU at float32, under the +2% bar)
DIFF_OPT_STEPS = 150
DIFF_OPT_STEPS_FULL = 300
DIFF_ILP_GAP_MAX = 0.02
#: The trainer on all 20 scenarios of ``training_scenarios(0)``, cut in
#: depth to 3 steps, one a rung of its temperature ladder (the bundled
#: checkpoint took 150; at 15 steps, 2.75 s each on an H100, the phase
#: took 144 s), every loss against the same run on the CPU at rtol 1e-4.
DIFF_TRAIN_STEPS = 3
DIFF_TRAIN_RTOL = 1e-4


def _diff_zoo():
    """``tests/test_diff_grad.py``'s graph zoo, built by the port."""
    from repro_torch import traces
    from repro_torch.core import (fork_join_graph, heterogeneous_cluster,
                                  homogeneous_cluster, layered_dag,
                                  listing2_graph)

    l2, l2_specs = listing2_graph(), homogeneous_cluster(3)
    recon = traces.reconstruct(traces.loads_trace(traces.dumps_trace(
        traces.record_graph(l2, l2_specs))))
    return [("listing2", l2, l2_specs),
            ("layered", layered_dag(4, layers=3, seed=11),
             homogeneous_cluster(4)),
            ("forkjoin", fork_join_graph(4, stages=2, seed=12),
             heterogeneous_cluster(4)),
            ("trace-recon", recon.graph, list(recon.specs))]


def _diff_caps(specs, frac=0.55, seed=5):
    """A cap point away from LUT state powers and symmetry ties (the
    tests' ``generic_caps``)."""
    import numpy as np

    from repro_torch.core.power import lut_table

    rng = np.random.default_rng(seed)
    tab = lut_table(specs)
    lo, hi = np.asarray(tab.cap_floor), np.asarray(tab.p_max)
    u = rng.uniform(0.35, 0.8, len(specs))
    return lo + (frac * u / u.mean()).clip(0.05, 0.95) * (hi - lo)


def _diff_value_grad(torch, soft, caps, knots=None):
    from repro_torch.diff.softsim import soft_makespan

    x = torch.tensor(caps, dtype=torch.float64, device=soft.device,
                     requires_grad=True)
    val = soft_makespan(x, soft, DIFF_T, knot_times=knots)
    (g,) = torch.autograd.grad(val, x)
    return float(val.detach()), g.cpu().numpy()


def _diff_checks(torch, device, name, graph, specs, knots=None):
    """One zoo case on the card against the CPU (value and gradient),
    the card's gradient against central differences on the card, and the
    card's anneal down the ladder against the exact smooth-LUT makespan
    (static caps, or a two-row schedule switching at ``knots``)."""
    import numpy as np

    from repro_torch.core.batchsim import simulate_batch
    from repro_torch.diff.softsim import build_soft_arrays, soft_makespan
    from repro_torch.policies import VectorStaticCaps

    base = _diff_caps(specs)
    caps = base if knots is None else np.stack([base, base[::-1].copy()])
    cpu = build_soft_arrays(graph, specs, device="cpu")
    card = build_soft_arrays(graph, specs, device=device)
    v_cpu, g_cpu = _diff_value_grad(torch, cpu, caps, knots)
    v_card, g_card = _diff_value_grad(torch, card, caps, knots)

    def f(c, t=DIFF_T):
        with torch.no_grad():
            return float(soft_makespan(
                torch.tensor(c, dtype=torch.float64, device=device), card,
                t, knot_times=knots))

    fd = np.zeros(caps.size)
    for i in range(caps.size):
        e = np.zeros(caps.size)
        e[i] = DIFF_FD_H
        fd[i] = (f(caps + e.reshape(caps.shape))
                 - f(caps - e.reshape(caps.shape))) / (2 * DIFF_FD_H)
    fd = fd.reshape(caps.shape)
    bound = float(base.sum())
    if knots is None:
        policy, sched = VectorStaticCaps(caps=caps), None
    else:
        policy = VectorStaticCaps(caps_schedule=caps)
        sched = [[(float(k), bound) for k in knots]]
    exact = simulate_batch(graph, specs, [bound], policy=policy,
                           bound_schedules=sched,
                           smooth_lut=True)[0].makespan
    errs = [abs(f(caps, t) - exact) for t in DIFF_LADDER]
    out = dict(
        case=name + ("" if knots is None else "-schedule"),
        value_rel_vs_cpu=abs(v_card - v_cpu) / abs(v_cpu),
        grad_rel_vs_cpu=float(np.linalg.norm(g_card - g_cpu)
                              / np.linalg.norm(g_cpu)),
        grad_rel_vs_fd=float(np.linalg.norm(g_card - fd)
                             / max(np.linalg.norm(fd), 1e-9)),
        exact=exact, anneal_abs_err=errs)
    require(out["value_rel_vs_cpu"] <= DIFF_VALUE_RTOL
            and out["grad_rel_vs_cpu"] <= DIFF_GRAD_RTOL,
            f"diff {out['case']}: card vs CPU {out}")
    require(out["grad_rel_vs_fd"] <= DIFF_FD_RTOL,
            f"diff {out['case']}: gradient vs central differences {out}")
    require(all(cold <= hot + 1e-9 for hot, cold in zip(errs, errs[1:]))
            and errs[-1] <= 1e-3 * exact,
            f"diff {out['case']}: anneal not monotone to 1e-3: {out}")
    return out


def _diff_optimize(torch, device, bound):
    """Listing 2 at ``bound``: the ILP's smooth-LUT makespan,
    :data:`DIFF_OPT_STEPS` Adam steps on the card at float32, the
    result's exact and stepped makespans, and the device launches of one
    forward+backward."""
    import numpy as np

    from repro_torch.core import homogeneous_cluster, listing2_graph
    from repro_torch.core.batchsim import simulate_batch
    from repro_torch.diff.optimize import (caps_from_theta,
                                           evaluate_static_caps,
                                           optimize_static_caps)
    from repro_torch.diff.softsim import build_soft_arrays, soft_makespan

    g, specs = listing2_graph(), homogeneous_cluster(3)
    ilp = simulate_batch(g, specs, [bound], "ilp",
                         smooth_lut=True)[0].makespan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt = optimize_static_caps(g, specs, bound, steps=DIFF_OPT_STEPS,
                               device=device)
    wall = time.perf_counter() - t0
    stepped = evaluate_static_caps(opt.caps, g, specs, bound,
                                   smooth_lut=False)
    gap = (opt.exact_makespan - ilp) / ilp
    soft = build_soft_arrays(g, specs, device=device)
    floor = soft.table.cap_floor.to(torch.float32)
    require(opt.caps.dtype == np.float32
            and abs(float(opt.caps.sum()) - bound) <= 1e-6 * bound
            and bool((opt.caps >= floor.cpu().numpy()).all()),
            f"diff optimize {bound} W: caps {opt.caps.tolist()} off the "
            f"simplex")
    require(gap <= DIFF_ILP_GAP_MAX,
            f"diff optimize {bound} W: {gap:+.2%} worse than the ILP "
            f"({opt.exact_makespan} vs {ilp})")

    def step():
        theta = torch.zeros(3, device=device, requires_grad=True)
        val = soft_makespan(caps_from_theta(theta, floor, bound), soft,
                            DIFF_LADDER[-1])
        torch.autograd.grad(val, theta)

    step()
    prof = _profile(torch, step)
    return dict(bound_w=bound, ilp_makespan=ilp,
                grad_makespan=opt.exact_makespan,
                grad_makespan_stepped=stepped, gap=gap,
                soft_makespan=opt.soft_makespan, caps=opt.caps.tolist(),
                steps=DIFF_OPT_STEPS,
                reduced={"steps": [DIFF_OPT_STEPS_FULL, DIFF_OPT_STEPS]},
                wall_s=wall,
                ms_per_step=1e3 * wall / DIFF_OPT_STEPS,
                launches_per_step=prof["device_launches"],
                step_wall_ms=1e3 * prof["wall_s"],
                step_device_ms=1e3 * prof["device_s"],
                step_device_busy_share=prof["device_busy_share"])


def _diff_train(torch, device):
    """``train_policy`` on the card at float32 over the full scenario set,
    cut to ``DIFF_TRAIN_STEPS`` steps (one a temperature, so ``meta``
    keeps every step's loss), against the same run on the CPU."""
    from repro_torch.diff.train import train_policy, training_scenarios

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, meta = train_policy(seed=0, steps=DIFF_TRAIN_STEPS, verbose=False,
                           device=device)
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    _, cpu_meta = train_policy(seed=0, steps=DIFF_TRAIN_STEPS,
                               verbose=False, device="cpu")
    cpu_wall = time.perf_counter() - t1
    card, cpu = meta["loss_history"], cpu_meta["loss_history"]
    rel = [abs(a[2] - b[2]) / abs(b[2]) for a, b in zip(card, cpu)]
    require(len(card) == len(cpu) == DIFF_TRAIN_STEPS
            and max(rel) <= DIFF_TRAIN_RTOL
            and [a[:2] for a in card] == [b[:2] for b in cpu],
            f"diff train: card losses {card} vs CPU {cpu}")
    return dict(scenarios=len(training_scenarios(0)),
                steps=DIFF_TRAIN_STEPS,
                reduced=f"20 scenarios x {DIFF_TRAIN_STEPS} steps, one a "
                        f"temperature (the bundled checkpoint took 150)",
                temperatures=[a[1] for a in card],
                losses=[a[2] for a in card], wall_s=wall,
                ms_per_step=1e3 * wall / DIFF_TRAIN_STEPS,
                cpu_losses=[b[2] for b in cpu], loss_rel_vs_cpu=rel,
                cpu_wall_s=cpu_wall)


def _diff_learned_sweep(torch, launches, ckpt):
    """``"learned"`` with the CLI's checkpoint through
    ``SweepEngine(executor="torch")`` on Listing 2 and the held-out
    layered family at three bounds each, against ``impl="plain"``."""
    import os

    import numpy as np

    from repro_torch.backends.policies import TorchLearned
    from repro_torch.core import (Scenario, SweepEngine,
                                  homogeneous_cluster, listing2_graph)
    from repro_torch.core.scenarios import random_layered_family
    from repro_torch.policies.learned import CHECKPOINT_ENV, load_checkpoint

    l2, l2_specs = listing2_graph(), tuple(homogeneous_cluster(3))
    cells = [Scenario(f"listing2-{b}", l2, l2_specs, b, "learned")
             for b in DIFF_BOUNDS]
    cells += random_layered_family(seed=77, n_members=4,
                                   policies=("learned",),
                                   bound_fracs=(0.3, 0.45, 0.6)).scenarios()
    before = os.environ.get(CHECKPOINT_ENV)
    os.environ[CHECKPOINT_ENV] = ckpt
    try:
        want = load_checkpoint(ckpt)
        got = TorchLearned().params
        require(all(np.array_equal(got[k], want[k]) for k in want),
                "diff: the learned policy did not load the CLI's checkpoint")
        for key in launches:
            launches[key] = 0
        t0 = time.perf_counter()
        sweep = SweepEngine(executor="torch").run(cells)
        wall = time.perf_counter() - t0
        counts = dict(launches)
        plain = SweepEngine(executor="torch", impl="plain").run(cells)
    finally:
        if before is None:
            os.environ.pop(CHECKPOINT_ENV, None)
        else:
            os.environ[CHECKPOINT_ENV] = before
    for name, sw in (("kernel", sweep), ("plain", plain)):
        require(not sw.failures and all(r.backend == "torch"
                                        for r in sw.records),
                f"diff sweep {name}: {sw.backend_summary()}")
    require(counts["power_step"] > 0 and counts["wave_run"] == 0,
            f"diff sweep: launches {counts}")
    rel, diff = _compare_results([r.result for r in sweep.records],
                                 [r.result for r in plain.records],
                                 "diff learned sweep vs plain")
    require(diff == 0.0, f"diff sweep: max abs diff {diff} vs impl='plain'")
    return dict(cells=len(cells), launches=counts, wall_s=wall,
                max_abs_diff_vs_plain=diff,
                paths=sorted({b.path for b in sweep.profile.buckets}),
                makespans=[r.result.makespan for r in sweep.records])


def phase_diff(torch, device, launches, smi):
    """The differentiable layer (``repro_torch.diff``) on the card: the
    zoo against the CPU, central differences and the anneal (float64);
    gradient-descended caps against the ILP at full width and the
    trainer on the full scenario set (float32); then the trainer's CLI
    in its own process and its checkpoint's ``"learned"`` sweep, with
    the power_step launch counts set to 0 just before it."""
    import os
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="diff_")
    ckpt = str(Path(tmp.name) / "ckpt.json")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t_cli = time.perf_counter()
    # no --device on the card: the CLI's default is the card
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.diff.train", "--quick",
         "--steps", "4", "--out", ckpt]
        + ([] if device.type == "cuda" else ["--device", str(device)]),
        cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        zoo = _diff_zoo()
        checks = [_diff_checks(torch, device, *case) for case in zoo]
        checks.append(_diff_checks(torch, device, *zoo[0], knots=[9.7]))
        out, _ = cli.communicate(timeout=600)
        cli_wall = time.perf_counter() - t_cli
        require(cli.returncode == 0 and Path(ckpt).exists(),
                f"diff CLI: exit {cli.returncode}\n{out}")
        optimized = [_diff_optimize(torch, device, b) for b in DIFF_BOUNDS]
        trained = _diff_train(torch, device)
        learned = _diff_learned_sweep(torch, launches, ckpt)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
        tmp.cleanup()
    wall = time.perf_counter() - t_phase
    emit("diff", nvidia_smi=smi, checks=checks)
    for entry in optimized:
        emit("diff_optimize", nvidia_smi=smi, **entry)
    emit("diff_train", nvidia_smi=smi, **trained)
    emit("diff_learned", nvidia_smi=smi, cli_wall_s=cli_wall,
         cli_last_line=out.strip().splitlines()[-1], **learned,
         phase_wall_s=wall)
    return learned["launches"]


# ------------------------------------------------------------ LM phases
LLAMA = "llama3-8b"
ZAMBA = "zamba2-2.7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 512, 64
PREFILL_SEQ = 4096
FLASH_MAIN = (1, 32, 8, PREFILL_SEQ, 128)
#: zamba2's shared attention at the prefill: 32 heads of 80, MHA
FLASH_ZAMBA = (1, 32, 32, PREFILL_SEQ, 80)
#: zamba2's SSD core at the prefill: (B, H, S, P, N) and the SSD chunk
SSM_MAIN = (1, 80, PREFILL_SEQ, 64, 64)
SSM_CHUNK = 128
#: The other families' full-width paths: (arch, phase tag, depth kept or
#: None for full depth, serve-phase name, prefill-phase name).  arctic
#: at 35 layers is 478.6 B parameters and chameleon at 48 68.6 GB, so
#: each keeps the depth that fits the card beside the plain check.
MOONSHOT, ARCTIC = "moonshot-v1-16b-a3b", "arctic-480b"
XLSTM, CHAMELEON, HUBERT = "xlstm-350m", "chameleon-34b", "hubert-xlarge"
FAMILY_RUNS = (
    (MOONSHOT, "moe", None, "serve_full_width_moe", "prefill_full_width_moe"),
    (ARCTIC, "arctic", 1, "serve_arctic", "prefill_arctic"),
    (XLSTM, "xlstm", None, "serve_full_width_xlstm",
     "prefill_full_width_xlstm"),
    (CHAMELEON, "chameleon", 8, "serve_chameleon", "prefill_chameleon"),
    (HUBERT, "encoder", None, None, "prefill_full_width_encoder"))
#: Their serve phases' prompt and new tokens (llama and zamba2 keep
#: 512 and 64).
FAMILY_PROMPT, FAMILY_NEW = 128, 32
#: Their prefills' attention, (B, H, Hkv, S, dh): GQA groups 1, 7 and 8
#: on the tensor-core kernel, causal; hubert's dh 80 on the SIMT kernel,
#: non-causal.
FLASH_FAMILIES = {"moe": ((1, 16, 16, PREFILL_SEQ, 128), True),
                  "arctic": ((1, 56, 8, PREFILL_SEQ, 128), True),
                  "chameleon": ((1, 64, 8, PREFILL_SEQ, 128), True),
                  "encoder": ((1, 16, 16, PREFILL_SEQ, 80), False)}
#: Widths of their norms: d_model of each, the mLSTM cell's d_in.
RMSNORM_FAMILY_WIDTHS = (1024, 1280, 2048, 7168, 8192)


def _max_abs(torch, got, want) -> float:
    """Largest elementwise distance, over blocks of rows."""
    g = got.reshape(-1, got.shape[-1])
    w = want.reshape(-1, want.shape[-1])
    return max(float((g[i:i + 512].float() - w[i:i + 512].float())
                     .abs().max()) for i in range(0, g.shape[0], 512))


def _within(torch, got, want, dtype) -> bool:
    tol = LM_TOL[dtype]
    return bool(((got.float() - want.float()).abs()
                 <= tol + tol * want.float().abs()).all())


def _rel_err(torch, got, want) -> float:
    """Normwise relative error of ``got`` against ``want``, the squares
    summed in float64 over blocks of rows (a 4096 x 163,840 logits
    tensor needs no float64 copy of the whole)."""
    g = got.reshape(-1, got.shape[-1])
    w = want.reshape(-1, want.shape[-1])
    num = den = 0.0
    for i in range(0, g.shape[0], 512):
        gi, wi = g[i:i + 512].double(), w[i:i + 512].double()
        num += float(((gi - wi) ** 2).sum())
        den += float((wi ** 2).sum())
    return math.sqrt(num / den)


def phase_rmsnorm_kernel(torch, device):
    """rmsnorm kernel vs plain at llama3-8b's shapes (decode 8 x 4096 and
    prefill 4096 x 4096 rows) and a ragged row count, bf16 and fp32,
    both rounding forms, and at zamba2-2.7b's (8 and 4096 rows of 2560,
    and of 5120 for the gated norm; bf16, the layer's form) and the other
    families' widths (:data:`RMSNORM_FAMILY_WIDTHS`); then the
    rows the vector path does not take (d = 1001, an x one element off
    its 16-byte alignment, a row of 20,000).  Every case must equal the
    plain version bit for bit.  Times (device, host-included call, and
    ``F.rms_norm``'s) at the decode shapes of both models and llama's
    prefill shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    worst, bitwise, cases = 0.0, True, 0
    shapes = [(rows, 4096, dtype, (True, False)) for rows in (8, 4096, 1001)
              for dtype in ("bfloat16", "float32")]
    shapes += [(rows, d, "bfloat16", (True,))
               for rows in (SERVE_BATCH, PREFILL_SEQ)
               for d in (2560, 5120) + RMSNORM_FAMILY_WIDTHS]
    # the strided kernel: a width that is no multiple of 16 bytes, an x
    # off its alignment (offset 1), more chunks a thread than registers hold
    shapes += [(SERVE_BATCH, d, dtype, (True, False), offset)
               for d, offset in ((1001, 0), (4096, 1)) for dtype in
               ("bfloat16", "float32")]
    shapes += [(SERVE_BATCH, 20000, "bfloat16", (True,), 0)]
    for rows, d, dtype, forms, *offset in shapes:
        td = getattr(torch, dtype)
        skip = offset[0] if offset else 0
        x = (3 * torch.randn(rows * d + skip, generator=gen,
                             device=device)).to(td)[skip:].view(rows, d)
        g = (1 + torch.randn(d, generator=gen, device=device)).to(td)
        for layer in forms:
            got = rn.rmsnorm(x, g, layer_form=layer)
            want = rn.rmsnorm(x, g, layer_form=layer, impl="plain")
            err = _max_abs(torch, got, want)
            require(_within(torch, got, want, dtype),
                    f"rmsnorm {rows}x{d} {dtype} layer_form={layer}: "
                    f"kernel vs plain max abs err {err:.3g}")
            worst = max(worst, err)
            bitwise = bitwise and bool(torch.equal(got, want))
            cases += 1
    torch.cuda.synchronize()
    require(bitwise, "rmsnorm: kernel not bit-equal to plain "
                     f"(max abs err {worst:.3g})")
    times = {}
    for tag, rows, d in (("decode", SERVE_BATCH, 4096),
                         ("decode_2560", SERVE_BATCH, 2560),
                         ("decode_5120", SERVE_BATCH, 5120),
                         ("prefill", PREFILL_SEQ, 4096)):
        x = torch.randn((rows, d), generator=gen,
                        device=device).to(torch.bfloat16)
        g = torch.ones(d, dtype=torch.bfloat16, device=device)
        calls = {"ms": lambda: rn.rmsnorm(x, g, layer_form=True),
                 "plain_ms": lambda: rn.rmsnorm(x, g, layer_form=True,
                                                impl="plain"),
                 "library_ms": lambda: F.rms_norm(x, (d,), g, 1e-5)}
        t = {k: device_ms(torch, fn, 50) for k, fn in calls.items()}
        t["call_ms"] = call_ms(torch, calls["ms"], 200)
        t["library_call_ms"] = call_ms(torch, calls["library_ms"], 200)
        t.update(bound(2 * (2 * rows * d + d), 4 * rows * d,
                       FP32_OPS_PER_S))
        t["bound_share"] = t["bound_ms"] / t["ms"]
        times[tag] = t
    # the per-launch floors: the device time and the host-included call
    # time of a one-element torch op, taken beside the decode-shape times
    tiny = torch.zeros(8, device=device)
    floor = device_ms(torch, lambda: tiny.add_(1), 50)
    floor_call = call_ms(torch, lambda: tiny.add_(1), 200)
    variant = {"threads": rn.THREADS, "chunk_bytes": 16,
               "paths": ["vector (x held in registers)", "strided"],
               "pdl": False, "cluster": False}
    emit("rmsnorm_kernel", cases=cases, tol=LM_TOL, max_abs_err=worst,
         bitwise_equal=bitwise, variant=variant, times=times, floor_ms=floor,
         floor_call_ms=floor_call)
    return worst, times, floor


def _causal_pairs(s: int, causal: bool, window: int) -> int:
    """Query/key pairs the mask keeps (positions 0..s-1 on both)."""
    import numpy as np

    rel = np.arange(s)[:, None] - np.arange(s)[None, :]
    keep = np.ones_like(rel, dtype=bool)
    if causal:
        keep &= rel >= 0
    if window:
        keep &= rel < window
    return int(keep.sum())


def phase_flash_kernel(torch, device):
    """flash_attention kernels vs plain at llama3-8b's prefill shape (B=1,
    H=32, Hkv=8, S=4096, dh=128, bf16, causal), zamba2-2.7b's (H=Hkv=32,
    dh=80) and small ones (MHA, fp32, full, window), and the tensor-core
    kernel's edges (a half-empty last query tile, a half-full last kv
    tile, dh=80 full and windowed, dh=64), and the other families'
    prefill shapes (:data:`FLASH_FAMILIES`: GQA groups 7 and 8, and
    hubert's non-causal dh=80).  Each case runs the variant
    ``kernel_variant`` names (the table's, or the one a case forces: the
    tensor-core kernel at dh=80, which zamba2's path does not take), read
    back from the launch counters.  Times at both prefill shapes for both
    kernels, with SDPA as the library yardstick (timed here only)."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    cases = [(FLASH_MAIN, "bfloat16", True, 0, None),
             (FLASH_ZAMBA, "bfloat16", True, 0, None),
             ((1, 4, 4, 256, 64), "float32", False, 0, None),
             ((2, 8, 2, 512, 64), "bfloat16", True, 0, None),
             ((1, 4, 2, 1024, 128), "bfloat16", True, 256, None),
             ((1, 2, 2, 256, 32), "float32", True, 0, None),
             ((1, 2, 1, 192, 256), "bfloat16", False, 100, None),
             ((2, 8, 2, 192, 128), "bfloat16", True, 0, None),
             ((1, 4, 4, 256, 64), "bfloat16", True, 0, None),
             (FLASH_ZAMBA, "bfloat16", True, 0, "tc"),
             ((1, 4, 1, 320, 80), "bfloat16", False, 0, "tc"),
             ((1, 4, 2, 1024, 80), "bfloat16", True, 200, "tc")]
    cases += [(shape, "bfloat16", causal, 0, None)
              for shape, causal in FLASH_FAMILIES.values()]
    worst, variants = {}, {}
    inputs = {}
    for (b, h, hkv, s, dh), dtype, causal, window, force in cases:
        td = getattr(torch, dtype)
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(td)
                   for shape in ((b, h, s, dh), (b, hkv, s, dh),
                                 (b, hkv, s, dh)))
        before = dict(fa.LAUNCHES)
        got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      variant=force)
        ran = {key: fa.LAUNCHES[key] - before[key] for key in before}
        want = fa.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="plain")
        err = _max_abs(torch, got, want)
        name = (f"{b}x{h}/{hkv}x{s}x{dh} {dtype} causal={causal} "
                f"w={window}" + (f" {force}" if force else ""))
        variant = "tc" if ran["flash_attention_tc"] else "simt"
        expect = fa.kernel_variant(td, dh, force)
        require(ran["flash_attention"] == 1 and variant == expect,
                f"flash {name}: launches {ran}, expected one {expect} "
                f"launch")
        require(_within(torch, got, want, dtype),
                f"flash {name}: kernel vs plain max abs err {err:.3g}")
        worst[name] = err
        variants[name] = variant
        if (b, h, hkv, s, dh) in (FLASH_MAIN, FLASH_ZAMBA) or \
                ((b, h, hkv, s, dh), causal) in FLASH_FAMILIES.values():
            inputs[(b, h, hkv, s, dh)] = (q, k, v)
    torch.cuda.synchronize()
    times = _flash_times(torch, FLASH_MAIN, *inputs.pop(FLASH_MAIN))
    zamba = _flash_times(torch, FLASH_ZAMBA, *inputs.pop(FLASH_ZAMBA))
    families = {tag: _flash_routed_times(torch, shape, causal,
                                         *inputs.pop(shape))
                for tag, (shape, causal) in FLASH_FAMILIES.items()}
    emit("flash_kernel", tol=LM_TOL, max_abs_err=worst, variants=variants,
         shape=FLASH_MAIN, **times, shape_zamba2=FLASH_ZAMBA, zamba2=zamba,
         families=families)
    return max(worst.values()), times, zamba, families


def _flash_times(torch, shape, q, k, v):
    """Device ms at one causal bf16 shape of both kernels (``ms`` is the
    one the table routes the shape to, ``variant``), the plain version
    and SDPA; the routed kernel's call ms; and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b, h, hkv, s, dh = shape
    calls = {"tc_ms": lambda: fa.flash_attention_cuda(q, k, v, variant="tc"),
             "simt_ms": lambda: fa.flash_attention_cuda(q, k, v,
                                                        variant="simt"),
             "plain_ms": lambda: fa.flash_attention(q, k, v, impl="plain"),
             "library_ms": lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True, enable_gqa=True)}
    times = {key: device_ms(torch, fn, 10 if key in ("tc_ms", "library_ms")
                            else 3)
             for key, fn in calls.items()}
    times["variant"] = fa.kernel_variant(q.dtype, dh)
    times["ms"] = times[f"{times['variant']}_ms"]
    times["call_ms"] = call_ms(torch, lambda: fa.flash_attention(q, k, v), 10)
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         enable_gqa=True)
    times["library_max_abs_diff"] = _max_abs(torch, fa.flash_attention(
        q, k, v), lib)
    flops = 4 * b * h * dh * _causal_pairs(s, True, 0)
    nbytes = 2 * (2 * b * h * s * dh + 2 * b * hkv * s * dh)
    times.update(bound(nbytes, flops, BF16_TENSOR_OPS_PER_S))
    times["tflops"] = flops / (times["ms"] * 1e9)
    times["tc_tflops"] = flops / (times["tc_ms"] * 1e9)
    return times


def _flash_routed_times(torch, shape, causal, q, k, v):
    """Device ms at one shape of the kernel the table routes it to, the
    plain version and SDPA, and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b, h, hkv, s, dh = shape
    calls = {"ms": lambda: fa.flash_attention(q, k, v, causal=causal),
             "plain_ms": lambda: fa.flash_attention(q, k, v, causal=causal,
                                                    impl="plain"),
             "library_ms": lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=causal, enable_gqa=True)}
    times = {key: device_ms(torch, fn, 3 if key == "plain_ms" else 10)
             for key, fn in calls.items()}
    times["variant"] = fa.kernel_variant(q.dtype, dh)
    times["causal"] = causal
    flops = 4 * b * h * dh * _causal_pairs(s, causal, 0)
    nbytes = 2 * (2 * b * h * s * dh + 2 * b * hkv * s * dh)
    times.update(bound(nbytes, flops, BF16_TENSOR_OPS_PER_S))
    times["tflops"] = flops / (times["ms"] * 1e9)
    return times


def phase_ssm_scan_kernel(torch, device):
    """ssm_scan kernel vs plain at zamba2's prefill shape (1, 80, 4096,
    64), N=64, in bf16 (the path's type) and fp32, and at two small ones
    (N=8 below a warp, N=256 the widest state); with a = 0 (exp(a) = 1
    exactly on both sides) at the prefill shape and a ragged one, held
    bit for bit; times at the prefill shape in bf16.  No single PyTorch
    call computes a selective scan, so there is no library time."""
    from repro_torch.kernels import ssm_scan as ss

    gen = torch.Generator(device=device)
    gen.manual_seed(3)

    def inputs(b, h, s, p, n, dtype):
        rnd = lambda *shape: torch.randn(  # noqa: E731
            shape, generator=gen, device=device)
        return (rnd(b, h, s, p).to(dtype), -rnd(b, h, s).abs() * 0.2,
                rnd(b, h, s).abs(), rnd(b, s, n).to(dtype),
                rnd(b, s, n).to(dtype))

    cases = [(SSM_MAIN, SSM_CHUNK, "bfloat16"),
             (SSM_MAIN, SSM_CHUNK, "float32"),
             ((2, 3, 128, 16, 8), 64, "float32"),
             ((1, 2, 192, 32, 256), 64, "bfloat16")]
    worst, main = {}, None
    for shape, chunk, dtype in cases:
        args = inputs(*shape, getattr(torch, dtype))
        got = ss.ssm_scan(*args, chunk=chunk)
        want = ss.ssm_scan(*args, chunk=chunk, impl="plain")
        tol = SSM_TOL[dtype]
        err = _max_abs(torch, got, want)
        name = "x".join(map(str, shape)) + f" chunk={chunk} {dtype}"
        require(bool(torch.isfinite(got).all())
                and bool(((got - want).abs() <= tol + tol * want.abs())
                         .all()),
                f"ssm_scan {name}: kernel vs plain max abs err {err:.3g}")
        worst[name] = err
        if main is None:
            main = args
        del got, want
    # a = 0: any change of summation order or index is a nonzero error
    for shape, chunk, dtype in ((SSM_MAIN, SSM_CHUNK, "bfloat16"),
                                ((1, 3, 100, 5, 40), 100, "float32")):
        x, a, dt, bm, cm = inputs(*shape, getattr(torch, dtype))
        a = torch.zeros_like(a)
        got = ss.ssm_scan(x, a, dt, bm, cm, chunk=chunk)
        want = ss.ssm_scan(x, a, dt, bm, cm, chunk=chunk, impl="plain")
        name = "x".join(map(str, shape)) + f" chunk={chunk} {dtype} a=0"
        err = _max_abs(torch, got, want)
        require(bool(torch.equal(got, want)),
                f"ssm_scan {name}: kernel vs plain not bitwise equal, max "
                f"abs err {err:.3g}")
        worst[name] = err
        del got, want
    torch.cuda.synchronize()
    calls = {"ms": lambda: ss.ssm_scan(*main, chunk=SSM_CHUNK),
             "plain_ms": lambda: ss.ssm_scan(*main, chunk=SSM_CHUNK,
                                             impl="plain")}
    times = {k: device_ms(torch, fn, 3 if k == "plain_ms" else 10)
             for k, fn in calls.items()}
    times["call_ms"] = call_ms(torch, calls["ms"], 10)
    times["library_ms"] = None
    b, h, s, p, n = SSM_MAIN
    x, a, dt, bm, cm = main
    # each input read once, y (fp32) written once; 6 fp32 operations per
    # state entry and step (the update's 2 products and sum, the outer
    # product, the dot's product and sum)
    nbytes = sum(t.numel() * t.element_size() for t in main) + 4 * x.numel()
    times.update(bound(nbytes, 6 * b * h * s * p * n, FP32_OPS_PER_S))
    times["issue_floor_ms"] = 1e3 * 6 * b * h * s * p * n / FP32_LANE_OPS_PER_S
    emit("ssm_scan_kernel", tol=SSM_TOL, max_abs_err=worst, shape=SSM_MAIN,
         chunk=SSM_CHUNK, dtype="bfloat16", **times)
    return max(worst.values()), times


def _llama_config():
    """llama3-8b's shipped config, checked at full width (with remat, as
    the trainer runs it; the training phase cuts its depth)."""
    from repro_torch.configs import get_config

    cfg = get_config(LLAMA)
    require(cfg.n_layers == 32 and cfg.d_model == 4096 and cfg.n_heads == 32
            and cfg.n_kv_heads == 8 and cfg.dh == 128 and cfg.d_ff == 14336
            and cfg.vocab == 128256 and cfg.dtype == "bfloat16"
            and cfg.remat, f"{LLAMA} is not at full width with remat")
    return cfg


def _llama_params(torch, device):
    return _random_params(torch, device, _llama_config())


def _zamba2_config():
    """zamba2-2.7b's shipped config, checked at full width."""
    from repro_torch.configs import get_config

    cfg = get_config(ZAMBA)
    ssm = cfg.ssm
    require(cfg.family == "hybrid" and cfg.n_layers == 54
            and cfg.attn_every == 6 and cfg.d_model == 2560
            and cfg.n_heads == 32 and cfg.n_kv_heads == 32 and cfg.dh == 80
            and cfg.d_ff == 10240 and cfg.vocab == 32000
            and (ssm.state_dim, ssm.head_dim, ssm.expand, ssm.conv_width,
                 ssm.chunk) == (64, 64, 2, 4, SSM_CHUNK)
            and cfg.dtype == cfg.param_dtype == "bfloat16" and cfg.remat,
            f"{ZAMBA} is not at full width with remat")
    return cfg


def _zamba2_params(torch, device):
    return _random_params(torch, device, _zamba2_config())


def _random_params(torch, device, cfg):
    """The model's random weights on the card from generator seed 0."""
    from repro_torch.models import init_params

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    return cfg, params, n, time.perf_counter() - t0


#: Each family's full-width config as the repo ships it (the fields the
#: phases check before they cut depth).
FAMILY_WIDTHS = {
    MOONSHOT: {"family": "moe", "n_layers": 48, "d_model": 2048,
               "n_heads": 16, "n_kv_heads": 16, "d_ff": 1408,
               "vocab": 163840,
               "moe": {"n_experts": 64, "top_k": 6, "capacity_factor": 1.25,
                       "dense_residual_ff": 0}},
    ARCTIC: {"family": "moe", "n_layers": 35, "d_model": 7168,
             "n_heads": 56, "n_kv_heads": 8, "d_ff": 4864, "vocab": 32000,
             "moe": {"n_experts": 128, "top_k": 2, "capacity_factor": 1.25,
                     "dense_residual_ff": 4864}},
    XLSTM: {"family": "ssm", "n_layers": 24, "d_model": 1024, "n_heads": 4,
            "n_kv_heads": 4, "d_ff": 0, "vocab": 50304,
            "xlstm": {"slstm_every": 8, "mlstm_proj_factor": 2.0,
                      "slstm_proj_factor": 4.0 / 3.0, "conv_width": 4}},
    CHAMELEON: {"family": "vlm", "n_layers": 48, "d_model": 8192,
                "n_heads": 64, "n_kv_heads": 8, "d_ff": 22016,
                "vocab": 65536},
    HUBERT: {"family": "encoder", "n_layers": 48, "d_model": 1280,
             "n_heads": 16, "n_kv_heads": 16, "d_ff": 5120, "vocab": 504,
             "causal": False, "mlp": "gelu"},
}


def _family_params(torch, device, arch, layers):
    """``arch``'s shipped config, checked at full width, its depth cut to
    ``layers`` where given; random weights on the card.  Returns (cfg,
    params, parameter count, init s, the cut as ``{"n_layers": [full,
    kept]}`` or {})."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    fields = dataclasses.asdict(cfg)
    want = FAMILY_WIDTHS[arch]
    require({k: fields[k] for k in want} == want
            and cfg.dtype == cfg.param_dtype == "bfloat16",
            f"{arch} is not at full width")
    reduced = {}
    if layers is not None:
        reduced = {"n_layers": [cfg.n_layers, layers]}
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return (*_random_params(torch, device, cfg), reduced)


def expected_launches(cfg) -> dict:
    """Kernel launches of one decode step (rmsnorm) and one prefill at
    S >= 2048 (all three) of ``cfg``'s model: 2 L + 1 rmsnorm and L flash
    for the dense, vlm, moe and encoder families; for the hybrid family
    2 L + 2 n_super + 1 rmsnorm (every Mamba2 layer's ln and gated norm,
    the shared block's two norms per application, the final norm), L
    ssm_scan and n_super flash; for the ssm family (xLSTM) 2 L + 1
    rmsnorm (each block's ln and its cell's output norm, the final norm)
    and no flash.  Every flash launch runs the kernel ``kernel_variant``
    routes the model's (dtype, dh) to: all of them on the tensor-core
    kernel (``flash_attention_tc``) at bf16 dh 128 (llama3-8b,
    moonshot, arctic, chameleon), none at bf16 dh 80 (zamba2-2.7b,
    hubert-xlarge)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel_variant

    if cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.attn_every
        want = {"rmsnorm": 2 * cfg.n_layers + 2 * n_super + 1,
                "ssm_scan": cfg.n_layers, "flash_attention": n_super}
    else:
        want = {"rmsnorm": 2 * cfg.n_layers + 1, "ssm_scan": 0,
                "flash_attention": 0 if cfg.family == "ssm"
                else cfg.n_layers}
    tc = kernel_variant(getattr(torch, cfg.dtype), cfg.dh) == "tc"
    want["flash_attention_tc"] = want["flash_attention"] if tc else 0
    want["rmsnorm_bwd"] = want["flash_attention_bwd"] = 0
    want["flash_attention_bwd_tc"] = want["ssm_scan_bwd"] = 0
    want["ssm_scan_bwd_tc"] = 0
    return want


def expected_train_launches(cfg) -> dict:
    """Kernel launches of one training step (loss and backward, one
    microbatch) of ``cfg``'s model at S >= 2048 with ``cfg.remat``.

    Dense, vlm, moe and encoder (each block under ``torch.utils.checkpoint``):
    the forward's ``2 L + 1`` rmsnorm and ``L`` flash, the recompute of
    every block in the backward (``2 L`` rmsnorm and ``L`` flash: each
    block's norms and attention lie before its last saved activation, so
    the recompute runs through them), and the backward kernels, one per
    forward call: ``2 L + 1`` rmsnorm_bwd and ``L`` flash_attention_bwd.
    In all ``4 L + 1``, ``2 L``, ``2 L + 1`` and ``L``.

    Hybrid (``L`` Mamba2 layers in ``n = L / attn_every`` super-blocks,
    each super-block under checkpoint and each Mamba2 layer under its own
    inside it; the shared attention block once a super-block): a Mamba2
    layer runs three times (the forward, the super-block's recompute, its
    own recompute inside that one's backward), the attention block twice.
    So ``3 L`` ssm_scan, ``6 L + 4 n + 1`` rmsnorm (a layer's ln and gated
    norm, the block's two norms, the final norm once), ``2 n`` flash;
    backward kernels one per forward call: ``L`` ssm_scan_bwd, ``2 L +
    2 n + 1`` rmsnorm_bwd, ``n`` flash_attention_bwd.

    ssm (xLSTM; ``L_s = n`` sLSTM layers closing the super-blocks, ``L_m =
    L - n`` mLSTM layers each under its own checkpoint inside them): an
    mLSTM layer runs three times, an sLSTM layer twice, two norms each:
    ``6 L_m + 4 L_s + 1`` rmsnorm and ``2 L + 1`` rmsnorm_bwd; no flash.

    Every flash launch (and every flash backward) is on the tensor-core
    kernel where ``kernel_variant`` (``bwd_kernel_variant``) routes the
    model's (dtype, dh) there: the forward at bf16 dh 64 and 128 (not
    zamba2's dh 80), the backward at bf16 dh 64, 80 and 128.  Every
    ssm_scan backward is on the tensor-core kernel where
    ``ssm_scan.bwd_kernel_variant`` routes the model's (dtype, P, N):
    zamba2's bf16 (64, 64)."""
    import torch

    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels.flash_attention import (bwd_kernel_variant,
                                                     kernel_variant)
    from repro_torch.models.model import superblock_shape

    require(cfg.remat, f"{cfg.arch_id}: the training formula is remat's")
    n_layers = cfg.n_layers
    if cfg.family in ("dense", "vlm", "moe", "encoder"):
        want = {"rmsnorm": 4 * n_layers + 1, "ssm_scan": 0,
                "flash_attention": 2 * n_layers, "ssm_scan_bwd": 0,
                "rmsnorm_bwd": 2 * n_layers + 1,
                "flash_attention_bwd": n_layers}
    elif cfg.family == "hybrid":
        n = superblock_shape(cfg)[0]
        want = {"rmsnorm": 6 * n_layers + 4 * n + 1,
                "ssm_scan": 3 * n_layers, "flash_attention": 2 * n,
                "ssm_scan_bwd": n_layers,
                "rmsnorm_bwd": 2 * n_layers + 2 * n + 1,
                "flash_attention_bwd": n}
    else:
        n = superblock_shape(cfg)[0]
        want = {"rmsnorm": 6 * (n_layers - n) + 4 * n + 1, "ssm_scan": 0,
                "flash_attention": 0, "ssm_scan_bwd": 0,
                "rmsnorm_bwd": 2 * n_layers + 1, "flash_attention_bwd": 0}
    dtype = getattr(torch, cfg.dtype)
    tc = kernel_variant(dtype, cfg.dh) == "tc"
    tc_bwd = bwd_kernel_variant(dtype, cfg.dh) == "tc"
    want["flash_attention_tc"] = want["flash_attention"] if tc else 0
    want["flash_attention_bwd_tc"] = \
        want["flash_attention_bwd"] if tc_bwd else 0
    want["ssm_scan_bwd_tc"] = want["ssm_scan_bwd"] if (
        cfg.family == "hybrid" and ss.bwd_kernel_variant(
            dtype, cfg.ssm.head_dim, cfg.ssm.state_dim) == "tc") else 0
    return want


def _launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss

    return {"rmsnorm": rn.LAUNCHES["rmsnorm"],
            "ssm_scan": ss.LAUNCHES["ssm_scan"],
            "ssm_scan_bwd": ss.LAUNCHES["ssm_scan_bwd"],
            "ssm_scan_bwd_tc": ss.LAUNCHES["ssm_scan_bwd_tc"],
            "flash_attention": fa.LAUNCHES["flash_attention"],
            "flash_attention_tc": fa.LAUNCHES["flash_attention_tc"],
            "rmsnorm_bwd": rn.LAUNCHES["rmsnorm_bwd"],
            "flash_attention_bwd": fa.LAUNCHES["flash_attention_bwd"],
            "flash_attention_bwd_tc": fa.LAUNCHES["flash_attention_bwd_tc"]}


#: Device-time groups of a training step's kernels, by name fragment
#: (first match wins; the rest is "other").
TRAIN_GROUPS = (("flash_attention_bwd_tc", ("bwd_tc_stats", "bwd_tc_dkdv",
                                            "bwd_tc_dq")),
                ("flash_attention_bwd", ("bwd_dkdv", "bwd_dq", "bwd_stats")),
                ("flash_attention", ("flash_tc_kernel", "flash_kernel")),
                ("ssm_scan_bwd_tc", ("ssm_tc_states", "ssm_tc_chunk",
                                     "ssm_tc_sum")),
                ("ssm_scan_bwd", ("ssm_bwd_rows", "ssm_bwd_sum")),
                ("ssm_scan", ("ssm_scan_kernel",)),
                ("rmsnorm_bwd", ("rmsnorm_bwd",)),
                ("rmsnorm", ("rmsnorm_",)),
                ("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
                ("elementwise", ("elementwise",)),
                ("reduce", ("reduce",)),
                ("copy", ("copy", "memcpy", "memset")))


def _profile(torch, fn, top=6, groups=None):
    """Run ``fn`` once in a :func:`profiler_session`: wall s, device s
    and the ``top`` kernels with the most device time (ms; names cut to 70
    characters, the kernels a cut name covers summed); with ``groups``
    ((name, fragments) pairs), the device ms of each group too."""
    with profiler_session(torch) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(_self_device_us(e) for e in rows) / 1e6
    by_name = {}
    for e in rows:
        by_name[e.key[:70]] = by_name.get(e.key[:70], 0.0) + \
            _self_device_us(e) / 1e3
    first = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
    out = {"wall_s": wall, "device_s": device_s,
           "device_busy_share": device_s / wall,
           "device_launches": sum(e.count for e in rows),
           "top_device_ms": dict(first[:top])}
    if groups is not None:
        ms = {name: 0.0 for name, _ in groups}
        ms["other"] = 0.0
        for e in rows:
            name = next((n for n, frags in groups
                         if any(f in e.key for f in frags)), "other")
            ms[name] += _self_device_us(e) / 1e3
        out["group_device_ms"] = ms
    return out


def _zero(counters):
    for c in counters:
        for key in c:
            c[key] = 0


class _RouteLog:
    """While entered, keeps every MoE layer's ``Routing`` in call order
    (``repro_torch.models.moe.route`` wrapped, the model's arithmetic
    untouched).  With ``replay`` (another log's routings), each layer is
    handed the replayed routing in place of its own: the experts, slots,
    keep flags and gate weights of that run."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        from repro_torch.models import moe

        self.module, self.real, self.layers = moe, moe.route, []

        def logged(*args, **kw):
            r = (self.real(*args, **kw) if self.replay is None
                 else self.replay[len(self.layers)])
            self.layers.append(r)
            return r

        moe.route = logged
        return self

    def __exit__(self, *exc):
        self.module.route = self.real
        return False


def _routing_stats(torch, got: list, want: list) -> dict:
    """Dropped share of (token, choice) pairs on the kernel path, the
    share whose expert differs between the kernel and the plain path
    (``got`` and ``want``: the two paths' :class:`_RouteLog` layers), and
    the share of tokens with a choice whose expert or keep flag differs
    in some layer (a flip moves the capacity ranks of the expert's later
    tokens)."""
    require(len(got) == len(want) > 0,
            "MoE routing not logged on both paths")
    pairs = dropped = differs = 0
    flipped = None
    for r, w in zip(got, want):
        pairs += r.keep.numel()
        dropped += int((~r.keep).sum())
        diff = r.gate_idx != w.gate_idx
        differs += int(diff.sum())
        tok = (diff | (r.keep != w.keep)).any(-1)
        flipped = tok if flipped is None else flipped | tok
    return {"pairs": pairs, "dropped_share": dropped / pairs,
            "expert_differs_share": differs / pairs,
            "tokens_flipped_share": float(flipped.float().mean())}


def _moe_block_checks(torch, cfg, params, tokens, device):
    """Each block of a MoE model at the prefill, the kernel path against
    the plain block fed the same input (the kernel path's output of the
    block before): the normwise error of the block's output with each
    path routing for itself (``block_rel_err``) and with the plain block
    handed the kernel block's routing (``block_rel_err_pinned``), and the
    share of (token, choice) pairs whose expert differs."""
    from repro_torch.models import model as lm

    free, pinned, flips = [], [], []
    with torch.inference_mode():
        x = lm.embed_inputs(cfg, params, {"tokens": torch.as_tensor(
            tokens, dtype=torch.int64, device=device)})
        b, s = x.shape[:2]
        pos = torch.arange(s, device=device).expand(b, s)
        for blk in params.blocks:
            with _RouteLog() as got_log:
                got, _ = lm.attn_block(cfg, blk, x, pos, cfg.causal, None)
            with _RouteLog() as want_log:
                want, _ = lm.attn_block(cfg, blk, x, pos, cfg.causal,
                                        "plain")
            free.append(_rel_err(torch, got, want))
            flips.append(_routing_stats(torch, got_log.layers,
                                        want_log.layers)
                         ["expert_differs_share"])
            with _RouteLog(replay=got_log.layers):
                want, _ = lm.attn_block(cfg, blk, x, pos, cfg.causal,
                                        "plain")
            pinned.append(_rel_err(torch, got, want))
            x = got
    return {"block_rel_err_max": max(free),
            "block_rel_err_pinned_max": max(pinned),
            "block_rel_err": free, "block_rel_err_pinned": pinned,
            "block_expert_differs_share": flips}


def phase_serve_full_width(torch, device, counters, model,
                           phase="serve_full_width", prompt=SERVE_PROMPT,
                           new=SERVE_NEW, reduced=None):
    """ServeEngine.generate on 8 requests (``prompt`` tokens, ``new``
    new ones, greedy) with the model at full width (``reduced`` lists a
    depth cut); the first decode steps' logits against the same engine at
    impl="plain" (for the MoE, with the routing of both)."""
    import numpy as np

    from repro_torch.models import init_cache
    from repro_torch.serving.engine import ServeEngine

    t_phase = time.perf_counter()
    cfg, params = model
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab, (SERVE_BATCH, prompt),
                           dtype=np.int32)
    max_seq = prompt + new
    engine = ServeEngine(cfg, params, max_seq=max_seq, max_batch=SERVE_BATCH)
    engine.generate(prompts[:, :4], 2)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    res = engine.generate(prompts, new)
    wall = time.perf_counter() - t0
    launches = _launches()
    steps = prompt + new - 1
    want = expected_launches(cfg)["rmsnorm"] * steps
    require(launches["rmsnorm"] == want,
            f"{phase}: rmsnorm launches {launches['rmsnorm']} != {want}")
    require(launches["flash_attention"] == launches["flash_attention_tc"]
            == launches["ssm_scan"] == 0,
            f"{phase}: decode runs no flash attention and no ssm_scan")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(res.new_tokens.shape == (SERVE_BATCH, new)
            and bool(((res.new_tokens >= 0)
                      & (res.new_tokens < cfg.vocab)).all()),
            f"{phase}: tokens out of range")
    moe = cfg.family == "moe"
    with torch.inference_mode():
        # 8 decode steps at the end of the prompt, under the profiler (the
        # attention reads the whole cache whatever it holds)
        cache = init_cache(cfg, SERVE_BATCH, max_seq, device)
        tok = torch.as_tensor(res.new_tokens[:, :1], device=device,
                              dtype=torch.int64)
        prof = _profile(torch, lambda: [engine.decode(
            cache, tok, prompt + i) for i in range(8)])
        prof["device_launches_per_step"] = prof["device_launches"] / 8
        del cache
        # kernel vs plain: the first 8 decode steps from an empty cache
        plain = ServeEngine(cfg, params, max_seq=max_seq,
                            max_batch=SERVE_BATCH, impl="plain")
        caches = [init_cache(cfg, SERVE_BATCH, max_seq, device)
                  for _ in range(2)]
        toks = torch.as_tensor(prompts, device=device, dtype=torch.int64)
        rel = abs_err = 0.0
        agree, got_layers, want_layers = [], [], []
        for i in range(8):
            with _RouteLog() as log:
                got = engine.decode(caches[0], toks[:, i:i + 1], i)
            got_layers += log.layers
            with _RouteLog() as log:
                ref = plain.decode(caches[1], toks[:, i:i + 1], i)
            want_layers += log.layers
            require(bool(torch.isfinite(got).all()),
                    f"{phase}: non-finite logits")
            rel = max(rel, _rel_err(torch, got, ref))
            abs_err = max(abs_err, _max_abs(torch, got, ref))
            agree.append(float((got.argmax(-1) == ref.argmax(-1))
                               .float().mean()))
        del caches
        routing = {}
        if moe:
            routing = _routing_stats(torch, got_layers, want_layers)
    require(rel <= MODEL_REL_TOL,
            f"{phase}: logits kernel vs plain normwise rel err {rel:.3g}")
    emit(phase, arch=cfg.arch_id, reduced=reduced or {}, batch=SERVE_BATCH,
         prompt=prompt, new=new, wall_s=wall,
         prefill_s=res.prefill_s, prefill_tokens_per_s=SERVE_BATCH
         * prompt / res.prefill_s,
         prefill_ms_per_step=1e3 * res.prefill_s / prompt,
         decode_s=res.decode_s,
         decode_tokens_per_s=SERVE_BATCH * (new - 1) / res.decode_s,
         decode_ms_per_step=1e3 * res.decode_s / (new - 1),
         peak_memory_gb=peak_gb, launches=launches, expected_rmsnorm=want,
         logits_rel_err_vs_plain=rel, logits_max_abs_err_vs_plain=abs_err,
         argmax_agreement_vs_plain=min(agree), rel_tol=MODEL_REL_TOL,
         **({"routing_8_steps": routing} if moe else {}),
         first_tokens=res.new_tokens[0, :8].tolist(),
         decode_profile_8_steps=prof,
         phase_wall_s=time.perf_counter() - t_phase)
    return launches


def phase_prefill_full_width(torch, device, counters, model,
                             phase="prefill_full_width", warm=2048,
                             profile=True, reduced=None):
    """make_prefill_step at B=1, S=4096 (tokens; frames ``(1, S, d)`` for
    the encoder) after a warm-up at ``warm``: the launches of
    :func:`expected_launches`; logits against impl="plain".  For the MoE,
    the dropped share and the routing of both paths, and the logits
    against the plain path handed the kernel path's routing (every
    layer's experts, slots, keep flags and weights).  Where the routing
    flips take the free logits past :data:`MODEL_REL_TOL`, those pinned
    logits are held at that bar, and so is every block against the plain
    block fed the same input and the same routing
    (:func:`_moe_block_checks`).  ``profile=False`` leaves
    out the profiled run (xLSTM's prefill is ~10^5 launches)."""
    import numpy as np

    from repro_torch.launch.steps import make_prefill_step

    t_phase = time.perf_counter()
    cfg, params = model
    rng = np.random.default_rng(1)
    if cfg.family == "encoder":
        inputs = {"frames": rng.standard_normal(
            (1, PREFILL_SEQ, cfg.d_model), dtype=np.float32)}
        warm_inputs = {"frames": inputs["frames"][:, :warm]}
    else:
        inputs = {"tokens": rng.integers(2, cfg.vocab, (1, PREFILL_SEQ))}
        warm_inputs = {"tokens": inputs["tokens"][:, :warm]}
    step = make_prefill_step(cfg)
    step(params, warm_inputs)                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    moe = cfg.family == "moe"
    with _RouteLog() as got_log:
        t0 = time.perf_counter()
        logits = step(params, inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _launches()
    want = expected_launches(cfg)
    require(launches == want, f"{phase}: launches {launches} != {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(tuple(logits.shape) == (1, PREFILL_SEQ, cfg.vocab)
            and bool(torch.isfinite(logits).all()),
            f"{phase}: logits {tuple(logits.shape)} not finite or "
            f"misshaped")
    with _RouteLog() as want_log:
        t0 = time.perf_counter()
        ref = make_prefill_step(cfg, impl="plain")(params, inputs)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    rel = _rel_err(torch, logits, ref)
    abs_err = _max_abs(torch, logits, ref)
    argmax_agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    extra = {}
    if moe:
        extra["routing"] = _routing_stats(torch, got_log.layers,
                                          want_log.layers)
        del ref
        with _RouteLog(replay=got_log.layers):
            ref = make_prefill_step(cfg, impl="plain")(params, inputs)
        extra["logits_rel_err_vs_plain_pinned"] = _rel_err(torch, logits,
                                                           ref)
    del logits, ref, got_log, want_log
    if moe:
        extra.update(_moe_block_checks(torch, cfg, params, inputs["tokens"],
                                       device))
    if rel > MODEL_REL_TOL and moe:
        extra["check"] = "routing_pinned"
        pinned = extra["logits_rel_err_vs_plain_pinned"]
        block = extra["block_rel_err_pinned_max"]
        require(pinned <= MODEL_REL_TOL and block <= MODEL_REL_TOL,
                f"{phase}: logits rel err {rel:.3g} over {MODEL_REL_TOL}; "
                f"with the kernel path's routing {pinned:.3g}, its worst "
                f"block {block:.3g}")
    else:
        require(rel <= MODEL_REL_TOL,
                f"{phase}: logits kernel vs plain normwise rel err "
                f"{rel:.3g}")
    prof = (_profile(torch, lambda: step(params, inputs)) if profile
            else "not measured: one launch a step of every sLSTM "
                 "recurrence")
    emit(phase, arch=cfg.arch_id, reduced=reduced or {}, batch=1,
         seq=PREFILL_SEQ, wall_s=wall, tokens_per_s=PREFILL_SEQ / wall,
         plain_wall_s=plain_wall, peak_memory_gb=peak_gb, launches=launches,
         logits_rel_err_vs_plain=rel, logits_max_abs_err_vs_plain=abs_err,
         argmax_agreement_vs_plain=argmax_agree, rel_tol=MODEL_REL_TOL,
         **extra, profile=prof, phase_wall_s=time.perf_counter() - t_phase)
    return launches


def family_phases(torch, device, counters) -> dict:
    """The other families' full-width serve and prefill phases
    (:data:`FAMILY_RUNS`), one model on the card at a time: each tag's
    (serve launches or None, prefill launches)."""
    import gc

    runs = {}
    for arch, tag, layers, serve_phase, prefill_phase in FAMILY_RUNS:
        cfg, params, n_params, init_s, reduced = _family_params(
            torch, device, arch, layers)
        emit(f"{tag}_params", arch=arch, params=n_params, init_s=init_s,
             gb=2 * n_params / 1e9, reduced=reduced)
        serve = None
        if serve_phase is not None:
            serve = phase_serve_full_width(
                torch, device, counters, (cfg, params), serve_phase,
                FAMILY_PROMPT, FAMILY_NEW, reduced)
        prefill = phase_prefill_full_width(
            torch, device, counters, (cfg, params), prefill_phase,
            warm=512 if cfg.family == "ssm" else 2048,
            profile=cfg.family != "ssm", reduced=reduced)
        runs[tag] = (serve, prefill)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return runs


# ------------------------------------------------------------ training
#: The training path's configuration: llama3-8b at full width, depth cut
#: to TRAIN_LAYERS of 32, S=4096, global batch 1, fp32 AdamW state.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 2, 4096, 1, 4
#: Virtual hosts of the trainer's cluster model (the reference CLI's
#: default).
TRAIN_HOSTS = 8
#: The second train CLI run's sequence (its smoke config, fp32 at dh 16):
#: long enough that attention takes the flash kernels, so that run's
#: training is the SIMT backward's path.  The recovery run keeps S=64,
#: the dense attention under autograd.
TRAIN_CLI_SEQ = 2048
#: The third train CLI run's sequence: zamba2's smoke config in fp32
#: (P = N = 16), the scan backward kernel's path since the bf16 one runs
#: on the tensor cores.
TRAIN_CLI_HYBRID_SEQ = 256
#: zamba2-2.7b's training phase: FULL widths, depth cut to ZAMBA_TRAIN_LAYERS
#: of 54 (two super-blocks: the shared attention block's gradient sums two
#: uses), S=4096, batch 1, fp32 AdamW state, ZAMBA_TRAIN_STEPS trainer steps.
ZAMBA_TRAIN_LAYERS, ZAMBA_TRAIN_STEPS = 12, 3
#: The scan backward kernel's cases (``variant="scan"``, forced where the
#: table routes bf16 to the tensor cores): (shape (B, H, S, P, N), dtype,
#: a = 0).  bf16 and fp32 at the training shape; N off the 32 lanes (16,
#: 40) and the widest (256); P off the 16-row blocks; B 2; S of one segment
#: and of one step; a = 0 (held bit for bit) at the training shape and a
#: ragged one.
SSM_BWD_CASES = ((SSM_MAIN, "bfloat16", False),
                 (SSM_MAIN, "float32", False),
                 ((1, 4, 256, 64, 16), "bfloat16", False),
                 ((1, 4, 200, 32, 40), "float32", False),
                 ((1, 2, 64, 24, 256), "bfloat16", False),
                 ((1, 3, 200, 20, 64), "float32", False),
                 ((2, 4, 300, 32, 64), "bfloat16", False),
                 ((1, 4, 8, 64, 64), "bfloat16", False),
                 ((1, 3, 1, 17, 64), "float32", False),
                 (SSM_MAIN, "bfloat16", True),
                 ((1, 3, 100, 5, 40), "float32", True))
#: The tensor-core backward's cases (the table's route, bf16): zamba2's
#: training shape, a ragged last chunk, B 2 (ragged), the smoke config's
#: (P, N) = (16, 16), P and N between, one step.
SSM_BWD_TC_CASES = (SSM_MAIN, (1, 8, 1000, 64, 64), (2, 4, 300, 32, 64),
                    (1, 8, 256, 16, 16), (1, 3, 200, 24, 40),
                    (2, 3, 1, 16, 64))
#: The tensor-core ssm_scan backward against its bf16-operand twin,
#: besides SSM_TOL against the scan's twin: the largest 64-step tile's
#: ||kernel - twin|| / ||twin|| (each head's dx, da and ddt; each batch's
#: dB and dC).  Set from the sound runs' largest reading (dx at the
#: training shape, where a tile's bf16 outputs round the other way in a
#: few entries) and that of a planted fault (one chunk of one head without
#: its lo products) (PERF.md).
SSM_TC_TILE_NORMWISE = 1.5e-3
#: Step axis of each gradient: dx, da, ddt (B, H, S, ...); dB, dC (B, S, N).
SSM_STEP_AXES = (2, 2, 2, 1, 1)
SSM_GRADS = ("dx", "da", "ddt", "dB", "dC")
#: rmsnorm_bwd at the training shape: the norms' rows (B * S) of d_model.
RMSNORM_BWD_MAIN = (TRAIN_BATCH * TRAIN_SEQ, 4096)
#: rmsnorm_bwd's other cases: (rows, d, dtype, layer_form, x offset).
RMSNORM_BWD_CASES = ((RMSNORM_BWD_MAIN[0], 4096, "float32", True, 0),
                     (RMSNORM_BWD_MAIN[0], 4096, "bfloat16", False, 0),
                     (SERVE_BATCH, 4096, "bfloat16", True, 0),
                     (1001, 4096, "float32", False, 0),
                     (37, 1001, "bfloat16", True, 0),
                     (37, 4096, "bfloat16", True, 1),
                     (16, 20000, "float32", True, 0))
#: flash_attention_bwd's cases besides the training shape (FLASH_MAIN,
#: bf16, causal): (shape, dtype, causal, window, variant).  The SIMT
#: kernel's (forced where the table routes the pair to the tensor cores):
#: every head dim of HEAD_DIMS, fp32, windowed and non-causal.
FLASH_BWD_CASES = (((1, 4, 4, 256, 64), "float32", False, 0, "simt"),
                   ((2, 8, 2, 512, 64), "bfloat16", True, 0, "simt"),
                   ((1, 4, 2, 1024, 128), "bfloat16", True, 256, "simt"),
                   ((1, 4, 1, 512, 128), "bfloat16", False, 0, "simt"),
                   ((1, 2, 1, 256, 16), "bfloat16", True, 0, "simt"),
                   ((1, 2, 1, 256, 32), "float32", True, 100, "simt"),
                   ((1, 2, 2, 256, 80), "bfloat16", False, 0, "simt"),
                   ((1, 2, 1, 192, 256), "bfloat16", True, 0, "simt"),
                   ((1, 2, 1, 192, 256), "float32", False, 70, "simt"),
                   (FLASH_MAIN, "bfloat16", True, 0, "simt"))
#: The tensor-core kernel's (the table's route): dh 64, 80 and 128;
#: causal, full and windowed; GQA groups 1, 4 and 8; 64-row last tiles (S
#: = 64 mod 128).  At dh 80: zamba2's training shape (H = Hkv, causal),
#: hubert's layout (H = Hkv = 16, non-causal), a window, a GQA group of 4
#: and 64-row last tiles.
FLASH_BWD_TC_CASES = (((1, 8, 8, 1024, 64), "bfloat16", True, 0, None),
                      ((1, 16, 4, 1024, 128), "bfloat16", False, 0, None),
                      ((1, 16, 2, 2048, 128), "bfloat16", True, 512, None),
                      ((2, 8, 1, 320, 64), "bfloat16", True, 96, None),
                      ((1, 4, 1, 448, 128), "bfloat16", False, 130, None),
                      ((1, 32, 8, 2048, 64), "bfloat16", True, 0, None),
                      ((1, 4, 4, 192, 128), "bfloat16", True, 0, None),
                      (FLASH_ZAMBA, "bfloat16", True, 0, None),
                      ((1, 16, 16, 2048, 80), "bfloat16", False, 0, None),
                      ((1, 4, 2, 1024, 80), "bfloat16", True, 200, None),
                      ((1, 16, 4, 1024, 80), "bfloat16", True, 0, None),
                      ((2, 4, 1, 320, 80), "bfloat16", True, 96, None),
                      ((1, 4, 2, 448, 80), "bfloat16", False, 130, None))
#: The tensor-core backward against its bf16-operand twin, besides
#: LM_TOL's elementwise bar: normwise over each 64-row tile of each head
#: (dq: 64 query rows; dk, dv: 64 keys), the largest tile's
#: ||kernel - twin|| / ||twin||.  A tile's norm and not the tensor's, so
#: that a fault confined to one tile of late rows shows (under a causal
#: mask their gradients are the smallest).  Set from the sound runs'
#: largest reading and that of a planted fault (PERF.md).
TC_BWD_TILE_NORMWISE = 2e-3


#: How the backward kernels' phases time: CUDA events around back-to-back
#: calls, what a training step pays; ``device_ms`` is the profiler's
#: device sum, for comparison (its sessions dropped kernels before
#: :data:`PROFILE_HOLD_S`: run AO read F.rms_norm's forward below its
#: bytes bound).
EVENT_TIMING = ("ms, plain_ms, library_ms, library_bwd_ms: CUDA events "
                "over back-to-back calls after a warm-up (host included "
                "where the host is slower than the card); device_ms: the "
                "profiler's device sum of the kernel")


def _event_times(torch, calls: dict, reps: int = 20) -> dict:
    """:func:`call_ms` of each call, in turns (each call, then each again
    in reverse order), the two readings averaged."""
    first = {k: call_ms(torch, fn, reps) for k, fn in calls.items()}
    second = {k: call_ms(torch, calls[k], reps) for k in reversed(calls)}
    return {k: (first[k] + second[k]) / 2 for k in calls}


def _rmsnorm_bwd_bytes_ops(rows: int, d: int, size: int):
    """Bytes (x and dy read, dx written, gamma read, dgamma written) and
    fp32 operations (~12 an element) of one backward."""
    return 3 * rows * d * size + 2 * d * size, 12 * rows * d


def phase_rmsnorm_bwd_kernel(torch, device):
    """rmsnorm_bwd kernel vs its plain twin at the training shape (4096
    rows of 4096, bf16, the layer's form) and at fp32, the other form, the
    decode batch, ragged rows, a width that is no multiple of 16 bytes, an
    x off its alignment and a row of 20,000, under :data:`LM_TOL`, and bit
    for bit where the kernel's vector path runs them; dx and dgamma the
    same from run to run.  Times at the training shape: the kernel, the
    plain twin, and ``F.rms_norm`` forward + backward through autograd
    (the library's yardstick: the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    worst, cases = 0.0, 0
    bitwise = {"vector": True, "strided": True}
    inputs = None
    for rows, d, dtype, layer, skip in \
            ((*RMSNORM_BWD_MAIN, "bfloat16", True, 0),) + RMSNORM_BWD_CASES:
        td = getattr(torch, dtype)
        x = (3 * torch.randn(rows * d + skip, generator=gen,
                             device=device)).to(td)[skip:].view(rows, d)
        g = (1 + torch.randn(d, generator=gen, device=device)).to(td)
        dy = torch.randn((rows, d), generator=gen, device=device).to(td)
        got = rn.rmsnorm_bwd(x.contiguous(), g, dy, layer_form=layer)
        again = rn.rmsnorm_bwd(x.contiguous(), g, dy, layer_form=layer)
        want = rn.rmsnorm_bwd(x, g, dy, layer_form=layer, impl="plain")
        path = "vector" if rn.bwd_vector_path(x, g, dy) else "strided"
        for a, b, c in zip(got, want, again):
            err = _max_abs(torch, a.view(-1, a.shape[-1]),
                           b.view(-1, b.shape[-1]))
            same = bool(torch.equal(a, b))
            require(_within(torch, a, b, dtype) and bool(torch.equal(a, c))
                    and (same or path == "strided"),
                    f"rmsnorm_bwd {rows}x{d} {dtype} layer={layer} "
                    f"({path}): kernel vs plain max abs err {err:.3g}, not "
                    f"bit-equal on the vector path, or not the same from "
                    f"run to run")
            worst = max(worst, err)
            bitwise[path] = bitwise[path] and same
        cases += 1
        if inputs is None:
            inputs = (x, g, dy)
    torch.cuda.synchronize()
    x, g, dy = inputs
    rows, d = RMSNORM_BWD_MAIN
    xr = x.detach().clone().requires_grad_(True)
    gr = g.detach().clone().requires_grad_(True)
    y = F.rms_norm(xr, (d,), gr, 1e-5)
    calls = {"ms": lambda: rn.rmsnorm_bwd(x, g, dy),
             "plain_ms": lambda: rn.rmsnorm_bwd(x, g, dy, impl="plain"),
             "library_ms": lambda: F.rms_norm(xr, (d,), gr,
                                              1e-5).backward(dy),
             "library_bwd_ms": lambda: torch.autograd.grad(
                 y, (xr, gr), dy, retain_graph=True)}
    times = _event_times(torch, calls)
    times["device_ms"] = device_ms(torch, calls["ms"], 20)
    times["device_ms_records"] = {k: PROFILER_SESSIONS[-1][k]
                                  for k in ("records", "at_least", "short")}
    times.update(bound(*_rmsnorm_bwd_bytes_ops(rows, d, 2), FP32_OPS_PER_S))
    times["bound_share"] = times["bound_ms"] / times["ms"]
    emit("rmsnorm_bwd_kernel", cases=cases, tol=LM_TOL, max_abs_err=worst,
         bitwise_equal=bitwise["vector"] and bitwise["strided"],
         bitwise_equal_by_path=bitwise, shape=list(RMSNORM_BWD_MAIN),
         timing=EVENT_TIMING, library_note="library_ms is F.rms_norm "
         "forward + backward through autograd, library_bwd_ms its backward "
         "alone (a retained graph)", times=times)
    return worst, times


def _step_tiles(torch, got, want, axis: int, steps: int = 64) -> float:
    """Largest ||got - want|| / ||want|| over the tiles of ``steps`` steps
    (along ``axis``; the last tile ragged) of each leading index, in
    float64."""
    lead = math.prod(want.shape[:axis])
    s = want.shape[axis]
    pad = -s % steps
    tiles = []
    for t in (got, want):
        t = torch.nn.functional.pad(t.double().reshape(lead, s, -1),
                                    (0, 0, 0, pad))
        tiles.append(t.reshape(lead, (s + pad) // steps, -1))
    g, w = tiles
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp_min(1e-300)).max())


def _planted_tile_fault(torch, fa, q, k, v, o, do, dq, dk):
    """dq and dk as a kernel that skipped one tile pair would leave them:
    the share of head 0's last 64 query rows against keys S/2 .. S/2+63
    (causal, no window; inside the mask) taken out of ``dq`` and ``dk``,
    in fp32 from the inputs and rounded back to their type."""
    s, dh = q.shape[2], q.shape[3]
    i0, j0 = s - 64, s // 2
    scale = fa.softmax_scale(dh)
    qi, doi = q[0, 0, i0:].float(), do[0, 0, i0:].float()
    kj, vj = k[0, 0, j0:j0 + 64].float(), v[0, 0, j0:j0 + 64].float()
    logits = scale * qi @ k[0, 0].float().T
    logits.masked_fill_(torch.arange(s, device=q.device)[None, :]
                        > torch.arange(i0, s, device=q.device)[:, None],
                        float("-inf"))
    p = torch.exp(scale * qi @ kj.T
                  - torch.logsumexp(logits, dim=-1)[:, None])
    d_row = (doi * o[0, 0, i0:].float()).sum(-1)
    ds = p * (doi @ vj.T - d_row[:, None]) * scale
    dq2, dk2 = dq.clone(), dk.clone()
    dq2[0, 0, i0:] = (dq[0, 0, i0:].float() - ds @ kj).to(dq.dtype)
    dk2[0, 0, j0:j0 + 64] = (dk[0, 0, j0:j0 + 64].float()
                             - ds.T @ qi).to(dk.dtype)
    return dq2, dk2


def _flash_bwd_bytes_ops(shape, causal: bool, window: int, size: int):
    """Bytes (q, k, v, o, do read; dq, dk, dv written) and the fewest
    operations of the gradient: 10 * dh a kept query/key pair (s again,
    dp, dv, dk, dq; FA2's count)."""
    b, h, hkv, s, dh = shape
    nbytes = size * (5 * b * h * s * dh + 4 * b * hkv * s * dh)
    return nbytes, 10 * b * h * dh * _causal_pairs(s, causal, window)


def _flash_bwd_times(torch, shape, inputs, reps):
    """Times of the flash backward at one causal bf16 shape, by CUDA
    events (:func:`_event_times`): the kernel the table routes the shape
    to (``ms``), the SIMT kernel forced, both twins, and SDPA forward +
    backward through autograd and backward alone (the library's
    yardstick: the port never calls it); the bound (FA2's 10 dh a kept
    pair) and the shares."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    q, k, v, o, do = inputs
    qr, kr, vr = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def sdpa(*qkv):
        return F.scaled_dot_product_attention(*qkv, is_causal=True,
                                              enable_gqa=True)

    y = sdpa(qr, kr, vr)
    calls = {"ms": lambda: fa.flash_attention_bwd(q, k, v, o, do),
             "simt_ms": lambda: fa.flash_attention_bwd_cuda(
                 q, k, v, o, do, variant="simt"),
             "plain_ms": lambda: fa.flash_attention_bwd(q, k, v, o, do,
                                                        impl="plain"),
             "plain_bf16_ms": lambda: fa.flash_attention_bwd_plain(
                 q, k, v, o, do, operands="bf16"),
             "library_ms": lambda: sdpa(qr, kr, vr).backward(do),
             "library_bwd_ms": lambda: torch.autograd.grad(
                 y, (qr, kr, vr), do, retain_graph=True)}
    times = _event_times(torch, calls, reps=reps)
    times["variant"] = fa.bwd_kernel_variant(q.dtype, q.shape[-1])
    times.update(bound(*_flash_bwd_bytes_ops(shape, True, 0, 2),
                       BF16_TENSOR_OPS_PER_S))
    times["tflops"] = times["ops"] / (times["ms"] * 1e9)
    times["simt_tflops"] = times["ops"] / (times["simt_ms"] * 1e9)
    times["bound_share"] = times["bound_ms"] / times["ms"]
    times["simt_bound_share"] = times["bound_ms"] / times["simt_ms"]
    times["ops_done"] = 16 * times["ops"] / 10   # 16 dh a kept pair
    times["speedup_vs_simt"] = times["simt_ms"] / times["ms"]
    times["vs_library_bwd"] = times["ms"] / times["library_bwd_ms"]
    return times


def phase_flash_bwd_kernel(torch, device):
    """flash_attention_bwd kernels vs their plain twins (on the forward
    kernel's output) at the training shape (B=1, H=32, Hkv=8, S=4096,
    dh=128, bf16, causal: the tensor-core kernel, and the SIMT one
    forced), :data:`FLASH_BWD_TC_CASES` (zamba2's training shape, dh 80,
    among them) and :data:`FLASH_BWD_CASES`, under :data:`LM_TOL`, the
    same from run to run, each launch counted on the variant
    ``bwd_kernel_variant`` names.  The tensor-core kernel is held against
    the bf16-operand twin (its rounding) and the fp32 twin, and to
    :data:`TC_BWD_TILE_NORMWISE` against the bf16-operand twin; a planted
    fault (one tile pair's share taken out of the kernel's dq and dk at
    llama's and at zamba2's training shapes) must read above that bar.
    The SIMT kernel is held against the fp32 twin.  Times at both
    training shapes (:func:`_flash_bwd_times`), by CUDA events."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    worst, worst_fp32, variants = {}, {}, {}
    tile16, tile32 = {}, {}
    kept = {}   # shape -> (inputs, twins, kernel's dq, dk, dv)
    for shape, dtype, causal, window, force in \
            ((FLASH_MAIN, "bfloat16", True, 0, None),) + FLASH_BWD_TC_CASES \
            + FLASH_BWD_CASES:
        b, h, hkv, s, dh = shape
        td = getattr(torch, dtype)
        if shape in kept and dtype == "bfloat16" and causal and not window:
            (q, k, v, o, do), twins, _ = kept[shape]
        else:
            q, k, v, do = (torch.randn(sh, generator=gen,
                                       device=device).to(td)
                           for sh in ((b, h, s, dh), (b, hkv, s, dh),
                                      (b, hkv, s, dh), (b, h, s, dh)))
            o = fa.flash_attention(q, k, v, causal=causal, window=window)
            twins = {}
        variant = fa.bwd_kernel_variant(td, dh, force)
        before = dict(fa.LAUNCHES)
        got = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window,
                                          force)
        again = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window,
                                            force)
        ran = {key: fa.LAUNCHES[key] - before[key]
               for key in ("flash_attention_bwd", "flash_attention_bwd_tc")}
        name = (f"{b}x{h}/{hkv}x{s}x{dh} {dtype} causal={causal} "
                f"w={window} {variant}")
        require(ran == {"flash_attention_bwd": 2, "flash_attention_bwd_tc":
                        2 if variant == "tc" else 0},
                f"flash_bwd {name}: launches {ran}")
        for operands in ("bf16", "fp32") if variant == "tc" else ("fp32",):
            if operands not in twins:
                twins[operands] = fa.flash_attention_bwd_plain(
                    q, k, v, o, do, causal, window, operands=operands)
        errs, errs32 = [], []
        for i, (grad, a, r) in enumerate(zip("qkv", got, again)):
            want = twins["bf16" if variant == "tc" else "fp32"][i]
            errs.append(_max_abs(torch, a, want))
            errs32.append(_max_abs(torch, a, twins["fp32"][i]))
            require(_within(torch, a, want, dtype)
                    and _within(torch, a, twins["fp32"][i], dtype)
                    and bool(torch.equal(a, r)),
                    f"flash_bwd {name} d{grad}: kernel vs its twin max abs "
                    f"err {errs[-1]:.3g}, vs the fp32 twin {errs32[-1]:.3g}, "
                    f"or not the same from run to run")
            if variant == "tc":
                tile16.setdefault(name, {})[grad] = _step_tiles(
                    torch, a, want, 2)
                tile32.setdefault(name, {})[grad] = _step_tiles(
                    torch, twins["fp32"][i], want, 2)
                require(tile16[name][grad] <= TC_BWD_TILE_NORMWISE,
                        f"flash_bwd {name} d{grad}: a 64-row tile "
                        f"{tile16[name][grad]:.3g} normwise from the "
                        f"bf16-operand twin (bar {TC_BWD_TILE_NORMWISE})")
        worst[name], worst_fp32[name] = max(errs), max(errs32)
        variants[name] = variant
        if shape in (FLASH_MAIN, FLASH_ZAMBA) and shape not in kept:
            kept[shape] = ((q, k, v, o, do), twins, got)
    planted = {}
    for tag, shape in (("", FLASH_MAIN), ("_zamba2", FLASH_ZAMBA)):
        inputs, twins, got = kept[shape]
        faulty = _planted_tile_fault(torch, fa, *inputs, *got[:2])
        planted[f"planted_fault{tag}"] = {
            g: {"tile": _step_tiles(torch, a, twins["bf16"][i], 2),
                "tensor": _rel_err(torch, a, twins["bf16"][i])}
            for i, (g, a) in enumerate(zip("qk", faulty))}
    inputs = {shape: kept[shape][0] for shape in kept}
    del kept, twins, got
    torch.cuda.synchronize()
    times = _flash_bwd_times(torch, FLASH_MAIN, inputs[FLASH_MAIN], 10)
    zamba = _flash_bwd_times(torch, FLASH_ZAMBA, inputs[FLASH_ZAMBA], 5)
    emit("flash_bwd_kernel", tol=LM_TOL, max_abs_err=worst,
         max_abs_err_vs_fp32_twin=worst_fp32, variants=variants,
         tile_normwise_bar=TC_BWD_TILE_NORMWISE, tile_normwise=tile16,
         tile_normwise_fp32_twin=tile32, **planted,
         shape=list(FLASH_MAIN), timing="CUDA events over back-to-back "
         "calls after a warm-up, in turns (each call, then each again in "
         "reverse order)",
         twins="the tensor-core kernel is held against "
               "flash_attention_bwd_plain(operands='bf16') (max_abs_err, "
               "tile_normwise) and the fp32 twin "
               "(max_abs_err_vs_fp32_twin); tile_normwise_fp32_twin is the "
               "fp32 twin's reading against the bf16-operand one, "
               "planted_fault that of the kernel's dq and dk with one tile "
               "pair's share taken out (tile: the largest 64-row tile; "
               "tensor: the whole tensor); the SIMT kernel against the "
               "fp32 twin",
         library_note="library_ms is SDPA forward + backward through "
                      "autograd, library_bwd_ms its backward alone (a "
                      "retained graph); ops is FA2's 10 dh a kept pair, "
                      "ops_done the 16 dh the three passes run; "
                      "vs_library_bwd the kernel's ms over SDPA's "
                      "backward alone",
         times=times, shape_zamba2=list(FLASH_ZAMBA), times_zamba2=zamba)
    for key, faults in planted.items():
        require(min(r["tile"] for r in faults.values())
                > TC_BWD_TILE_NORMWISE,
                f"flash_bwd: the {key} reads {faults}, within the tile bar "
                f"{TC_BWD_TILE_NORMWISE}")
    tc = {n: e for n, e in worst.items() if variants[n] == "tc"}
    simt = {n: e for n, e in worst.items() if variants[n] == "simt"}
    return max(tc.values()), max(simt.values()), times, zamba


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _train_step0(torch, counters, tr, device, what):
    """Step 0 from the trainer's weights and first batch: one loss and
    backward at impl=None and one at impl="plain".  The kernel path's
    launches are held against :func:`expected_train_launches`, the plain
    path's at none, the loss and every parameter's gradient normwise
    within :data:`MODEL_REL_TOL`.  Returns (the launches a step, the
    line's fields: the losses, the distances, each run's peak memory)."""
    import gc

    import numpy as np

    from repro_torch.data.pipeline import global_batch
    from repro_torch.launch.steps import train_batch
    from repro_torch.models import loss_fn

    model, tcfg = tr.model, tr.mcfg
    batch = train_batch(global_batch(tr.dcfg, 0), device)
    runs = {}
    for impl in (None, "plain"):
        _zero(counters)
        torch.cuda.reset_peak_memory_stats()
        loss, _ = loss_fn(tcfg, model, batch, impl=impl)
        loss.backward()
        torch.cuda.synchronize()
        runs[impl] = (float(loss.detach()), _grads(model), _launches(),
                      torch.cuda.max_memory_allocated() / 1e9)
        model.zero_grad(set_to_none=True)
    want_step = expected_train_launches(tcfg)
    require(runs[None][2] == want_step,
            f"{what} step 0: launches {runs[None][2]} != {want_step}")
    require(not any(runs["plain"][2].values()),
            f"{what} step 0 at impl=plain launched {runs['plain'][2]}")
    losses = {"kernels": runs[None][0], "plain": runs["plain"][0]}
    loss_rel = abs(losses["kernels"] - losses["plain"]) / \
        abs(losses["plain"])
    grad_rel = {}
    for name, g in runs[None][1].items():
        w = runs["plain"][1][name]
        grad_rel[name] = _rel_err(torch, g.reshape(-1, g.shape[-1]),
                                  w.reshape(-1, w.shape[-1]))
    worst = max(grad_rel, key=grad_rel.get)
    require(np.isfinite(losses["kernels"]) and loss_rel <= MODEL_REL_TOL
            and grad_rel[worst] <= MODEL_REL_TOL,
            f"{what} step 0: loss rel err {loss_rel:.3g}, worst gradient "
            f"{worst} {grad_rel[worst]:.3g} (bar {MODEL_REL_TOL})")
    peaks = {"kernels": runs[None][3], "plain": runs["plain"][3]}
    del runs, batch
    gc.collect()
    torch.cuda.empty_cache()
    return want_step, {
        "step0_loss": losses, "loss_rel_err_vs_plain": loss_rel,
        "grad_rel_err_vs_plain_max": grad_rel[worst],
        "grad_rel_err_vs_plain": {k: grad_rel[k] for k in sorted(grad_rel)},
        "rel_tol": MODEL_REL_TOL, "step0_peak_memory_gb": peaks}


def _train_steps(torch, counters, tr, want_step, n_steps, n_params, what):
    """The main path: the trainer's ``n_steps`` steps, the launch counts
    set to 0 just before and each step's read around the trainer's own
    step function, held exactly against ``want_step``.  Returns (the
    launches, the line's fields: each step's ms, tokens/s and
    model-FLOPs share, the launches, the peak memory).  A step's
    ``host_ms`` is the host's time to issue it (until the step function
    returns, before the loss is read back): near ``ms`` when the host sets
    the step's pace, below it when the card does; ``device_span_ms`` the
    card's time from the step's first launch to its last kernel's end
    (CUDA events)."""
    import numpy as np

    per_step, host_ms, spans, step_fn = [], [], [], tr.train_step

    def counted(*args):
        before = _launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = step_fn(*args)
        end.record()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        spans.append((start, end))
        per_step.append({k: v - before[k] for k, v in _launches().items()})
        return out

    tr.train_step = counted
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    try:
        history = tr.run()
        torch.cuda.synchronize()
    finally:
        tr.train_step = step_fn
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: v * n_steps for k, v in want_step.items()}
    require(launches == want and per_step == [want_step] * n_steps,
            f"{what}: launches {launches} != {want}, or per step "
            f"{per_step} != {want_step}")
    require([r.step for r in history] == list(range(n_steps))
            and all(np.isfinite(r.loss) for r in history),
            f"{what}: steps {[r.step for r in history]}, losses "
            f"{[r.loss for r in history]}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steps = [{"step": r.step, "loss": r.loss, "ms": 1e3 * r.wall_s,
              "host_ms": host, "device_span_ms": a.elapsed_time(b),
              "tokens_per_s": tokens / r.wall_s,
              "model_flops_share": 6 * n_params * tokens
              / (r.wall_s * BF16_TENSOR_OPS_PER_S),
              "straggler": r.straggler, "max_cap_w": max(r.caps_w)}
             for r, host, (a, b) in zip(history, host_ms, spans)]
    return launches, {"steps": steps, "launches": launches,
                      "launches_per_step": want_step,
                      "peak_memory_gb": peak_gb}


def _train_restore(torch, tr, trainer, n_steps, what):
    """The checkpoint the last step saved, restored by a fresh trainer
    (``trainer()``): it resumes at step ``n_steps`` with parameters and
    moments bit-equal.  Returns the line's fields (checkpoint GB, restore
    s)."""
    import gc

    from repro_torch.checkpoint.manager import flatten_tree

    saved = tr.ckpt.latest_step()
    t0 = time.perf_counter()
    fresh = trainer()
    restore_s = time.perf_counter() - t0
    require(saved == n_steps - 1 and fresh.start_step == n_steps,
            f"{what} checkpoint: saved step {saved}, fresh trainer starts "
            f"at {fresh.start_step}")
    pairs = list(zip(flatten_tree(tr.state()), flatten_tree(fresh.state())))
    require(all(pa == pb and a.dtype == b.dtype and torch.equal(a, b)
                for (pa, a), (pb, b) in pairs),
            f"{what} checkpoint: the restored state is not bit-equal")
    ckpt_gb = sum(f.stat().st_size for f in Path(
        tr.ckpt.dir).rglob("*.npy")) / 1e9
    del fresh, pairs
    gc.collect()
    torch.cuda.empty_cache()
    return {"checkpoint_gb": ckpt_gb, "restore_s": restore_s}


def _train_profile(torch, tr, n_steps):
    """One more trainer step under the profiler: device busy share, top
    kernels, device ms by :data:`TRAIN_GROUPS`."""
    from repro_torch.data.pipeline import global_batch

    batch = global_batch(tr.dcfg, n_steps)
    return _profile(torch, lambda: tr.train_step(
        tr.model, tr.opt_state, batch, n_steps), top=16,
        groups=TRAIN_GROUPS)


def phase_train_full_width(torch, device, counters, smi):
    """The training path at full width: llama3-8b (d 4096, 32 heads, GQA
    8, d_ff 14336, vocab 128256, bf16, remat), depth cut to
    :data:`TRAIN_LAYERS`, S=4096, batch 1, fp32 AdamW state, through
    ``build_trainer(..., device="cuda")`` and ``PowerAwareTrainer``.

    Step 0's loss and every parameter's gradient at impl=None against
    impl="plain" from the same weights and batch (:func:`_train_step0`);
    then :data:`TRAIN_STEPS` trainer steps with exact launch counts
    (:func:`_train_steps`); the checkpoint the last step saved restored
    by a fresh trainer (resumes at step 4, parameters and moments
    bit-equal); one more step under the profiler.  The train CLI runs
    twice in processes of its own on the card meanwhile: a failure
    injected at step 6 of 10 on 4 hosts of the smoke config at S=64 (it
    must recover on 3 hosts and reach step 9), and 2 steps at
    :data:`TRAIN_CLI_SEQ`, whose flash backward must run the SIMT kernel;
    a third process trains zamba2's smoke config (fp32) 2 steps at
    :data:`TRAIN_CLI_HYBRID_SEQ`, whose ssm_scan backward must run the
    scan kernel.  Returns the trainer's launch counts, the second CLI
    run's and the third's."""
    import gc
    import os
    import tempfile

    from repro_torch.launch.train import build_trainer

    t_phase = time.perf_counter()
    _llama_config()
    tmp = tempfile.TemporaryDirectory(prefix="train_", dir=ROOT / "build")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli_cmd = [sys.executable, "-m", "repro_torch.launch.train", "--steps",
               "10", "--hosts", "4", "--batch", "4", "--seq", "64",
               "--fail-at", "6", "--ckpt-dir", str(Path(tmp.name) / "cli"),
               "--device", str(device)]
    simt_cmd = [sys.executable, "-m", "repro_torch.launch.train",
                "--steps", "2", "--hosts", "2", "--batch", "2", "--seq",
                str(TRAIN_CLI_SEQ), "--ckpt-dir",
                str(Path(tmp.name) / "cli_simt"), "--device", str(device)]
    hybrid_cmd = [sys.executable, "-m", "repro_torch.launch.train",
                  "--arch", ZAMBA, "--steps", "2", "--hosts", "2", "--batch",
                  "2", "--seq", str(TRAIN_CLI_HYBRID_SEQ), "--ckpt-dir",
                  str(Path(tmp.name) / "cli_hybrid"), "--device",
                  str(device)]
    t_cli = time.perf_counter()
    cli, cli_simt, cli_hybrid = (
        subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for cmd in (cli_cmd, simt_cmd, hybrid_cmd))
    try:
        def trainer():
            return build_trainer(
                LLAMA, smoke=False, steps=TRAIN_STEPS, hosts=TRAIN_HOSTS,
                batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                ckpt_dir=str(Path(tmp.name) / "ckpt"),
                n_layers=TRAIN_LAYERS, device=device)

        t0 = time.perf_counter()
        tr = trainer()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in tr.model.parameters())
        want_step, step0 = _train_step0(torch, counters, tr, device,
                                        "train")
        out, _ = cli.communicate(timeout=600)
        cli_wall = time.perf_counter() - t_cli
        require(cli.returncode == 0
                and "hosts left 3; last step 9" in out,
                f"train CLI: exit {cli.returncode}, no recovery line\n{out}")
        simt_out, _ = cli_simt.communicate(timeout=600)
        tag = "[train] kernel launches "
        cli_launches = json.loads(next(
            (ln for ln in simt_out.splitlines() if ln.startswith(tag)),
            tag + "{}")[len(tag):])
        hybrid_out, _ = cli_hybrid.communicate(timeout=600)
        hybrid_launches = json.loads(next(
            (ln for ln in hybrid_out.splitlines() if ln.startswith(tag)),
            tag + "{}")[len(tag):])
        require(cli_hybrid.returncode == 0
                and hybrid_launches.get("ssm_scan_bwd", 0) > 0
                and hybrid_launches["ssm_scan_bwd_tc"] == 0,
                f"train CLI, {ZAMBA} smoke config (fp32) at "
                f"S={TRAIN_CLI_HYBRID_SEQ}: exit {cli_hybrid.returncode}, "
                f"its ssm_scan backward must run the scan kernel\n"
                f"{hybrid_out}")
        require(cli_simt.returncode == 0
                and cli_launches.get("flash_attention_bwd", 0) > 0
                and cli_launches["flash_attention_bwd_tc"] == 0,
                f"train CLI at S={TRAIN_CLI_SEQ} (fp32 smoke config, dh "
                f"16): exit {cli_simt.returncode}, its flash backward must "
                f"run the SIMT kernel\n{simt_out}")
        launches, run = _train_steps(torch, counters, tr, want_step,
                                     TRAIN_STEPS, n_params,
                                     "train_full_width")
        restored = _train_restore(torch, tr, trainer, TRAIN_STEPS, "train")
        prof = _train_profile(torch, tr, TRAIN_STEPS)
    finally:
        for proc in (cli, cli_simt, cli_hybrid):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.cleanup()
    emit("train_full_width", nvidia_smi=smi, arch=LLAMA,
         reduced={"n_layers": [32, TRAIN_LAYERS]}, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, params=n_params, state_dtype=tr.ocfg.state_dtype,
         init_s=init_s, **step0,
         grad_note="embed's gradient is F.embedding's backward on both "
                   "paths: each row's terms summed in fp32, rounded once",
         **run, hosts=TRAIN_HOSTS,
         power_aware_speedup=tr.speedup_summary()["speedup"], **restored,
         cli_wall_s=cli_wall, cli_simt_seq=TRAIN_CLI_SEQ,
         cli_simt_launches=cli_launches,
         cli_hybrid_seq=TRAIN_CLI_HYBRID_SEQ,
         cli_hybrid_launches=hybrid_launches,
         cli_recovery_line=next(ln for ln in out.splitlines()
                                if "hosts left" in ln),
         profile_step=prof, phase_wall_s=time.perf_counter() - t_phase)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return launches, cli_launches, hybrid_launches


def _ssm_bwd_bytes_ops(shape, size: int):
    """Bytes (x, a, dt, B, C, dy read; dx, da, ddt, dB, dC written) and
    ~15 fp32 operations per state entry and step (the recompute 4, the g
    update 3, the row sums gB and gh 2 each, the dB and dC terms 2 each)
    of one backward."""
    b, h, s, p, n = shape
    nbytes = 2 * size * b * h * s * p + 4 * b * h * s * p \
        + 4 * 4 * b * h * s + 4 * size * b * s * n
    return nbytes, 15 * b * h * s * p * n


def _ssm_tc_bwd_bytes_ops(torch, shape, size: int, dy):
    """Bytes (as :func:`_ssm_bwd_bytes_ops`) and the tensor-core
    operations the chunked backward needs on this ``dy`` (the products
    ``csrc/ssm_scan_bwd_tc.cu``'s header counts, 2 operations a
    multiply-add; the kernel does more): 17 products of 64 x 64 x 64 a
    (batch, head, chunk of 64 steps), 4 more where that chunk of ``dy`` is
    not bf16-exact (its lo parts: the fp32 operand as two bf16 passes,
    what one tf32 pass costs at half the bf16 rate), and one B C^T a
    (batch, chunk)."""
    b, h, s, p, n = shape
    nbytes, _ = _ssm_bwd_bytes_ops(shape, size)
    k = -(-s // 64)
    lo = (dy != dy.to(torch.bfloat16).float()).any(-1).float()
    lo = torch.nn.functional.pad(lo.reshape(b * h, s), (0, k * 64 - s))
    lo_chunks = int(lo.reshape(b * h, k, 64).amax(-1).sum())
    products = 17 * b * h * k + 4 * lo_chunks + b * k
    return nbytes, products * 2 * 64 ** 3


def _ssm_planted_fault(torch, ss, args, got):
    """dx and dB as a kernel that skipped the lo products of one chunk of
    one head would leave them: head 0's steps 320 .. 383 of dx, and the
    same steps of dB, from the single-rounding twin (``operands=
    "bf16_hi"``)."""
    hi = ss.ssm_scan_bwd_chunked_plain(*args, operands="bf16_hi")
    dx, db = got[0].clone(), got[3].clone()
    dx[0, 0, 320:384] = hi[0][0, 0, 320:384]
    db[0, 320:384] = hi[3][0, 320:384]
    return dx, db


def phase_ssm_scan_bwd_kernel(torch, device):
    """ssm_scan_bwd kernels vs their plain twins.  The tensor-core kernel
    (the table's route for bf16 at zamba2's (P, N)) at
    :data:`SSM_BWD_TC_CASES` (zamba2's training shape SSM_MAIN: (1, 80,
    4096, 64), N=64, bf16, among them): against its bf16-operand twin
    (``ssm_scan_bwd_chunked_plain``), every 64-step tile within
    :data:`SSM_TC_TILE_NORMWISE`, and against the scan's twin
    (``ssm_scan_bwd_plain``) under :data:`SSM_TOL`, and so at the
    training shape with dy rounded to bf16 (as the model's path gives it);
    a planted fault (one chunk's lo products skipped) must read above the
    tile bar.  The scan kernel (forced) at :data:`SSM_BWD_CASES` under
    :data:`SSM_TOL`, bit for bit at a = 0 (exp(0) = 1 on both sides, so
    any change of order shows).  Every case the same from run to run,
    each launch counted on the variant it ran.  Times at the training
    shape by CUDA events: both kernels (the scan one forced at bf16; the
    tensor-core one also with dy rounded to bf16), the twins (the scan's
    a host loop).  No single PyTorch call computes this backward, so
    there is no library time."""
    from repro_torch.kernels import ssm_scan as ss

    gen = torch.Generator(device=device)
    gen.manual_seed(13)

    def inputs(b, h, s, p, n, dtype, zero_a):
        rnd = lambda *shape: torch.randn(  # noqa: E731
            shape, generator=gen, device=device)
        a = -rnd(b, h, s).abs() * 0.2
        return (rnd(b, h, s, p).to(dtype),
                torch.zeros_like(a) if zero_a else a, rnd(b, h, s).abs(),
                rnd(b, s, n).to(dtype), rnd(b, s, n).to(dtype),
                rnd(b, h, s, p))

    worst, bitwise, tiles, variants, main = {}, {}, {}, {}, None
    cases = [(shape, "bfloat16", False, None, False)
             for shape in SSM_BWD_TC_CASES]
    # dy rounded to bf16, as the model's path gives it (y reaches the
    # loss through y.to(bf16)): no lo part
    cases.append((SSM_MAIN, "bfloat16", False, None, True))
    cases += [(shape, dtype, zero_a, "scan", False)
              for shape, dtype, zero_a in SSM_BWD_CASES]
    planted = None
    for shape, dtype, zero_a, force, dy_bf16 in cases:
        td = getattr(torch, dtype)
        args = inputs(*shape, td, zero_a)
        if dy_bf16:
            args = args[:5] + (args[5].to(torch.bfloat16).float(),)
        chunk = SSM_CHUNK if shape[2] % SSM_CHUNK == 0 else shape[2]
        variant = ss.bwd_kernel_variant(td, shape[3], shape[4], force)
        before = (ss.LAUNCHES["ssm_scan_bwd"], ss.LAUNCHES["ssm_scan_bwd_tc"])
        got = ss.ssm_scan_bwd(*args, chunk=chunk, variant=force)
        again = ss.ssm_scan_bwd(*args, chunk=chunk, variant=force)
        torch.cuda.synchronize()
        ran = (ss.LAUNCHES["ssm_scan_bwd"] - before[0],
               ss.LAUNCHES["ssm_scan_bwd_tc"] - before[1])
        want = ss.ssm_scan_bwd(*args, chunk=chunk, impl="plain")
        twin = (ss.ssm_scan_bwd_chunked_plain(*args, operands="bf16")
                if variant == "tc" else None)
        name = "x".join(map(str, shape)) + f" {dtype} {variant}" + \
            (" a=0" if zero_a else "") + (" dy=bf16" if dy_bf16 else "")
        tol = SSM_TOL[dtype]
        errs, same = [], []
        for i, (grad, g, w, r) in enumerate(zip(SSM_GRADS, got, want,
                                                again)):
            err = _max_abs(torch, g.view(-1, g.shape[-1]),
                           w.view(-1, w.shape[-1]))
            errs.append(err)
            same.append(bool(torch.equal(g, w)))
            require(g.dtype == w.dtype and g.shape == w.shape
                    and bool(torch.isfinite(g).all())
                    and bool(((g.float() - w.float()).abs()
                              <= tol + tol * w.float().abs()).all())
                    and bool(torch.equal(g, r)) and (same[-1] or not zero_a),
                    f"ssm_scan_bwd {name} {grad}: kernel vs the scan's twin "
                    f"max abs err {err:.3g} (tol {tol}), not bit-equal at "
                    f"a = 0, or not the same from run to run")
            if twin is not None:
                tile = _step_tiles(torch, g, twin[i], SSM_STEP_AXES[i])
                tiles.setdefault(name, {})[grad] = tile
                require(tile <= SSM_TC_TILE_NORMWISE,
                        f"ssm_scan_bwd {name} {grad}: a 64-step tile "
                        f"{tile:.3g} normwise from the bf16-operand twin "
                        f"(bar {SSM_TC_TILE_NORMWISE})")
        require(ran == (2, 2 if variant == "tc" else 0),
                f"ssm_scan_bwd {name}: launches {ran} for 2 calls")
        worst[name], bitwise[name] = max(errs), all(same)
        variants[name] = variant
        if shape == SSM_MAIN and variant == "tc" and main is None:
            main = args
            faulty = _ssm_planted_fault(torch, ss, args, got)
            planted = {g: _step_tiles(torch, f, twin[i], SSM_STEP_AXES[i])
                       for g, f, i in zip(("dx", "dB"), faulty, (0, 3))}
            del faulty
        del got, again, want, twin
    require(min(planted.values()) > SSM_TC_TILE_NORMWISE,
            f"ssm_scan_bwd: the planted fault reads {planted}, within the "
            f"tile bar {SSM_TC_TILE_NORMWISE}")
    torch.cuda.synchronize()
    model = main[:5] + (main[5].to(torch.bfloat16).float(),)
    calls = {"tc_ms": lambda: ss.ssm_scan_bwd(*main, chunk=SSM_CHUNK),
             "tc_bf16_dy_ms": lambda: ss.ssm_scan_bwd(*model,
                                                      chunk=SSM_CHUNK),
             "scan_ms": lambda: ss.ssm_scan_bwd(*main, chunk=SSM_CHUNK,
                                                variant="scan"),
             "chunked_plain_ms": lambda: ss.ssm_scan_bwd_chunked_plain(
                 *main, operands="bf16")}
    times = _event_times(torch, calls, reps=10)
    times["plain_ms"] = call_ms(torch, lambda: ss.ssm_scan_bwd(
        *main, chunk=SSM_CHUNK, impl="plain"), 2)
    times["ms"] = times["tc_ms"]
    times["library_ms"] = None
    times.update(bound(*_ssm_tc_bwd_bytes_ops(torch, SSM_MAIN, 2, main[5]),
                       BF16_TENSOR_OPS_PER_S))
    times["bound_share"] = times["bound_ms"] / times["tc_ms"]
    on_model = bound(*_ssm_tc_bwd_bytes_ops(torch, SSM_MAIN, 2, model[5]),
                     BF16_TENSOR_OPS_PER_S)
    times.update({f"bf16_dy_{k}": v for k, v in on_model.items()})
    times["bf16_dy_bound_share"] = on_model["bound_ms"] / \
        times["tc_bf16_dy_ms"]
    del model
    scan = bound(*_ssm_bwd_bytes_ops(SSM_MAIN, 2), FP32_OPS_PER_S)
    times.update({f"scan_{k}": v for k, v in scan.items()})
    times["scan_bound_share"] = scan["bound_ms"] / times["scan_ms"]
    times["forward_ms"] = call_ms(torch, lambda: ss.ssm_scan(
        *main[:5], chunk=SSM_CHUNK), 10)
    prof = _profile(torch, lambda: ss.ssm_scan_bwd(*main, chunk=SSM_CHUNK),
                    top=4)
    emit("ssm_scan_bwd_kernel", tol=SSM_TOL, max_abs_err=worst,
         bitwise_equal=bitwise, variants=variants,
         tile_normwise_bar=SSM_TC_TILE_NORMWISE, tile_normwise=tiles,
         planted_fault=planted, shape=list(SSM_MAIN), chunk=SSM_CHUNK,
         dtype="bfloat16", timing="CUDA events over back-to-back calls "
         "after a warm-up, in turns (each call, then each again in reverse "
         "order); plain_ms: 2 calls of the scan's twin's host loop; "
         "forward_ms: the forward kernel on the same inputs",
         twins="the tensor-core kernel against ssm_scan_bwd_chunked_plain("
               "operands='bf16') (tile_normwise) and ssm_scan_bwd_plain "
               "(max_abs_err, SSM_TOL); the scan kernel against "
               "ssm_scan_bwd_plain; planted_fault: the tensor-core kernel's "
               "dx and dB with one chunk of head 0 from the single-rounding "
               "twin (operands='bf16_hi')",
         bound_note="bound_ms: the chunked form's need on these inputs "
                    "(bytes, or the products of 64^3 it needs at 989 "
                    "TFLOP/s: 21 a head and chunk with fp32 dy, 17 with "
                    "bf16-exact dy, one B C^T a chunk); bf16_dy_*: the "
                    "same inputs with dy rounded to bf16, as on the "
                    "model's path (tc_bf16_dy_ms); scan_bound_ms: the scan "
                    "form's ~15 fp32 operations an entry and step at 67 "
                    "TFLOP/s",
         times=times, device_kernels_ms=prof["top_device_ms"])
    return max(worst[n] for n in worst if variants[n] == "tc"), \
        max(worst[n] for n in worst if variants[n] == "scan"), times


def phase_train_full_width_zamba2(torch, device, counters, smi):
    """The hybrid family's training at full width: zamba2-2.7b (d 2560, 32
    heads at dh 80, d_ff 10240, vocab 32000, Mamba2 N 64, head dim 64, 80
    heads, chunk 128, bf16, remat), depth cut to
    :data:`ZAMBA_TRAIN_LAYERS` of 54 (two super-blocks, so the shared
    attention block's gradient sums two uses), S=4096, batch 1, fp32
    AdamW state, through ``build_trainer(..., device="cuda")``.

    Step 0's loss and every parameter's gradient (A_log, dt_bias, D, the
    conv and the shared block's weights among them) at impl=None against
    impl="plain" (:func:`_train_step0`; each run's peak memory printed:
    the plain path's backward twin walks the 4096-step scan in host loops
    under the Function, with no autograd graph of it); then
    :data:`ZAMBA_TRAIN_STEPS` trainer steps with exact launch counts a
    step (every ``ssm_scan_bwd`` on the tensor-core kernel; at dh 80 every
    flash forward on the SIMT kernel and every flash backward on the
    tensor-core one); the
    checkpoint the last step saved restored bit-equal by a fresh trainer;
    one more step under the profiler.
    Returns the trainer's launch counts."""
    import gc
    import tempfile

    from repro_torch.launch.train import build_trainer

    t_phase = time.perf_counter()
    _zamba2_config()
    tmp = tempfile.TemporaryDirectory(prefix="train_zamba2_",
                                      dir=ROOT / "build")
    try:
        def trainer():
            return build_trainer(
                ZAMBA, smoke=False, steps=ZAMBA_TRAIN_STEPS,
                hosts=TRAIN_HOSTS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                ckpt_dir=str(Path(tmp.name) / "ckpt"),
                n_layers=ZAMBA_TRAIN_LAYERS, device=device)

        t0 = time.perf_counter()
        tr = trainer()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tcfg = tr.mcfg
        require(tcfg.n_layers == ZAMBA_TRAIN_LAYERS and tcfg.remat
                and tcfg.family == "hybrid", f"zamba2 trainer: {tcfg}")
        n_params = sum(p.numel() for p in tr.model.parameters())
        want_step, step0 = _train_step0(torch, counters, tr, device,
                                        "zamba2 train")
        launches, run = _train_steps(torch, counters, tr, want_step,
                                     ZAMBA_TRAIN_STEPS, n_params,
                                     "train_full_width_zamba2")
        restored = _train_restore(torch, tr, trainer, ZAMBA_TRAIN_STEPS,
                                  "zamba2")
        prof = _train_profile(torch, tr, ZAMBA_TRAIN_STEPS)
    finally:
        tmp.cleanup()
    emit("train_full_width_zamba2", nvidia_smi=smi, arch=ZAMBA,
         reduced={"n_layers": [54, ZAMBA_TRAIN_LAYERS]}, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, params=n_params, state_dtype=tr.ocfg.state_dtype,
         init_s=init_s, **step0, **run,
         static_memory_gb=(2 + 2 + 8) * n_params / 1e9,
         memory_note="static_memory_gb: bf16 parameters and gradients and "
                     "fp32 AdamW moments (12 bytes a parameter); the peaks "
                     "add activations, the remat recompute and the "
                     "backward kernels' workspaces (the plain step 0: the "
                     "twins' host loops, no autograd graph of the scan)",
         hosts=TRAIN_HOSTS,
         power_aware_speedup=tr.speedup_summary()["speedup"], **restored,
         profile_step=prof, phase_wall_s=time.perf_counter() - t_phase)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_phases(torch, device, counters, smi):
    """The training slice: the backward kernels against their plain
    twins, the full-width training paths of llama3-8b and zamba2-2.7b."""
    rn_err, rn_times = phase_rmsnorm_bwd_kernel(torch, device)
    tc_err, simt_err, fa_times, fa_zamba = phase_flash_bwd_kernel(torch,
                                                                  device)
    ss_tc_err, ss_err, ss_times = phase_ssm_scan_bwd_kernel(torch, device)
    launches, cli, cli_hybrid = phase_train_full_width(torch, device,
                                                       counters, smi)
    zamba2 = phase_train_full_width_zamba2(torch, device, counters, smi)
    why = ("the reference trains through plain jnp and XLA's autodiff "
           "(no custom_vjp); the port's forward is a ctypes kernel autograd "
           "cannot see through, so its backward is a kernel too")
    return launches, zamba2, [
        {"name": "rmsnorm_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
         "replaces": None, "why": why,
         "backward_of": "src/repro/models/layers.py:38",
         "launches": launches["rmsnorm_bwd"],
         "launches_train": launches["rmsnorm_bwd"],
         "launches_train_zamba2": zamba2["rmsnorm_bwd"],
         "max_abs_err": rn_err, "shape": list(RMSNORM_BWD_MAIN),
         **{k: rn_times[k] for k in ("ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "bound_share",
                                     "library_ms", "library_bwd_ms")}},
        {"name": "flash_attention_bwd_tc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
         "replaces": None, "why": why,
         "backward_of": "src/repro/models/attention.py:96",
         "launches": launches["flash_attention_bwd_tc"],
         "launches_train": launches["flash_attention_bwd_tc"],
         "launches_train_zamba2": zamba2["flash_attention_bwd_tc"],
         "max_abs_err": tc_err, "shape": list(FLASH_MAIN),
         **{k: fa_times[k] for k in ("ms", "plain_bf16_ms", "bound_ms",
                                     "bound_by", "bound_share", "library_ms",
                                     "library_bwd_ms", "tflops")},
         "plain_ms": fa_times["plain_bf16_ms"],
         "shape_zamba2": list(FLASH_ZAMBA),
         **{f"{k}_zamba2": fa_zamba[k] for k in (
             "ms", "bound_ms", "bound_by", "bound_share", "library_ms",
             "library_bwd_ms", "tflops", "vs_library_bwd")},
         "plain_ms_zamba2": fa_zamba["plain_bf16_ms"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": None, "why": why,
         "backward_of": "src/repro/models/attention.py:96",
         "launches": cli["flash_attention_bwd"] - cli[
             "flash_attention_bwd_tc"],
         "launches_note": "launches are the second train CLI run's (its "
                          "own process: the fp32 smoke config at dh 16, "
                          f"S {TRAIN_CLI_SEQ}, 2 steps); launches_train "
                          "the llama3-8b trainer's and "
                          "launches_train_zamba2 the zamba2-2.7b "
                          "trainer's (bf16 at dh 128 and 80: all on the "
                          "tensor-core kernel)",
         "launches_train": launches["flash_attention_bwd"] - launches[
             "flash_attention_bwd_tc"],
         "launches_train_zamba2": zamba2["flash_attention_bwd"] - zamba2[
             "flash_attention_bwd_tc"],
         "max_abs_err": simt_err, "shape": list(FLASH_MAIN),
         "ms": fa_times["simt_ms"], "tflops": fa_times["simt_tflops"],
         "bound_share": fa_times["simt_bound_share"],
         **{k: fa_times[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "library_bwd_ms")},
         "shape_zamba2": list(FLASH_ZAMBA), "ms_zamba2": fa_zamba["simt_ms"],
         "bound_share_zamba2": fa_zamba["simt_bound_share"],
         **{f"{k}_zamba2": fa_zamba[k] for k in (
             "plain_ms", "bound_ms", "library_ms", "library_bwd_ms")}},
        {"name": "ssm_scan_bwd_tc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd_tc.cu",
         "replaces": None, "why": why,
         "backward_of": "src/repro/models/ssm.py:69",
         "launches": zamba2["ssm_scan_bwd_tc"],
         "launches_note": "launches are the zamba2-2.7b trainer's "
                          f"({ZAMBA_TRAIN_STEPS} steps at "
                          f"{ZAMBA_TRAIN_LAYERS} layers): every ssm_scan "
                          "backward of its bf16 path",
         "max_abs_err": ss_tc_err, "shape": list(SSM_MAIN),
         **{k: ss_times[k] for k in ("ms", "bound_ms", "bound_by",
                                     "bound_share", "library_ms",
                                     "forward_ms")},
         "ms_bf16_dy": ss_times["tc_bf16_dy_ms"],
         **{f"{k}_bf16_dy": ss_times[f"bf16_dy_{k}"] for k in (
             "bound_ms", "bound_by", "bound_share")},
         "bf16_dy_note": "*_bf16_dy: the same inputs with dy rounded to "
                         "bf16, as the model's path gives it",
         "plain_ms": ss_times["chunked_plain_ms"],
         "plain_note": "plain_ms: ssm_scan_bwd_chunked_plain("
                       "operands='bf16') on the card; scan_plain_ms the "
                       "scan's twin's host loop"},
        {"name": "ssm_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
         "replaces": None, "why": why,
         "backward_of": "src/repro/models/ssm.py:69",
         "launches": cli_hybrid["ssm_scan_bwd"]
         - cli_hybrid["ssm_scan_bwd_tc"],
         "launches_note": "launches are the third train CLI run's (its "
                          f"own process: {ZAMBA}'s smoke config in fp32, "
                          f"S {TRAIN_CLI_HYBRID_SEQ}, 2 steps); "
                          "launches_train_zamba2 the zamba2-2.7b "
                          "trainer's (bf16 at (64, 64): all on the "
                          "tensor-core kernel since PR 30)",
         "launches_train_zamba2": zamba2["ssm_scan_bwd"]
         - zamba2["ssm_scan_bwd_tc"],
         "max_abs_err": ss_err, "shape": list(SSM_MAIN),
         "ms": ss_times["scan_ms"], "plain_ms": ss_times["plain_ms"],
         "bound_ms": ss_times["scan_bound_ms"],
         "bound_by": ss_times["scan_bound_by"],
         "bound_share": ss_times["scan_bound_share"], "library_ms": None},
    ]


def _lm_worker(queue, smi) -> None:
    """Worker process: the LM phases on the card, in a CUDA context of
    their own (the LM weights never share the card with the wave
    engine's state).  Sends back the LM kernels' entries, or the
    traceback of a failure."""
    import traceback

    try:
        import torch

        sys.path.insert(0, str(SRC))
        queue.put(("ok", lm_phases(torch, torch.device("cuda"),
                                   _counters(), smi)))
    except Exception:     # reported to the parent, which fails the run
        queue.put(("error", traceback.format_exc()))


def run_lm_phases(smi) -> list:
    """The LM phases in a spawned process; their kernels' entries."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    worker = ctx.Process(target=_lm_worker, args=(queue, smi))
    worker.start()
    try:
        status, out = queue.get(timeout=900)
        worker.join(timeout=120)
    finally:
        if worker.is_alive():
            worker.terminate()
            worker.join()
    require(status == "ok", f"LM phases failed:\n{out}")
    return out


def lm_phases(torch, device, counters, smi):
    """The LM kernel phases, then the full-width serving paths of
    llama3-8b and of zamba2-2.7b (llama's weights freed first), then the
    other families' (:func:`family_phases`), then the training path
    (:func:`train_phases`)."""
    import gc

    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    rms_err, rms_times, rms_floor = phase_rmsnorm_kernel(torch, device)
    fa_err, fa_times, fa_zamba, fa_families = phase_flash_kernel(torch,
                                                                 device)
    ss_err, ss_times = phase_ssm_scan_kernel(torch, device)
    runs = {}
    for arch, make, tag in ((LLAMA, _llama_params, ""),
                            (ZAMBA, _zamba2_params, "_zamba2")):
        cfg, params, n_params, init_s = make(torch, device)
        emit("llama_params" if arch == LLAMA else "zamba2_params",
             arch=arch, params=n_params, init_s=init_s, gb=2 * n_params / 1e9)
        runs[arch] = (
            phase_serve_full_width(torch, device, counters, (cfg, params),
                                   f"serve_full_width{tag}"),
            phase_prefill_full_width(torch, device, counters, (cfg, params),
                                     f"prefill_full_width{tag}"))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    families = family_phases(torch, device, counters)
    train, ztrain, train_entries = train_phases(torch, device, counters,
                                                smi)
    emit("profiler_sessions", process="lm_worker", **profiler_summary())
    serve, prefill = runs[LLAMA]
    zserve, zprefill = runs[ZAMBA]
    dec, pre = rms_times["decode"], rms_times["prefill"]
    rms_families, fa_launches = {}, {}
    for tag, (fserve, fprefill) in families.items():
        if fserve is not None:
            rms_families[f"launches_{tag}"] = fserve["rmsnorm"]
        rms_families[f"launches_prefill_{tag}"] = fprefill["rmsnorm"]
        fa_launches[f"launches_{tag}"] = fprefill["flash_attention"]
        fa_launches[f"launches_tc_{tag}"] = fprefill["flash_attention_tc"]
    return [
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:20",
         "launches": serve["rmsnorm"], "launches_prefill": prefill["rmsnorm"],
         "launches_zamba2": zserve["rmsnorm"],
         "launches_prefill_zamba2": zprefill["rmsnorm"], **rms_families,
         "launches_train": train["rmsnorm"],
         "launches_train_zamba2": ztrain["rmsnorm"],
         "max_abs_err": rms_err, "shape": [SERVE_BATCH, 4096],
         **{k: dec[k] for k in ("ms", "plain_ms", "call_ms", "bound_ms",
                                "bound_by", "library_ms", "library_call_ms")},
         **{f"{k}_prefill": pre[k] for k in ("ms", "plain_ms", "call_ms",
                                             "bound_ms", "library_ms")},
         "floor_ms": rms_floor},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
         "source_simt": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:33",
         "launches": prefill["flash_attention"],
         "launches_tc": prefill["flash_attention_tc"],
         "launches_zamba2": zprefill["flash_attention"],
         "launches_tc_zamba2": zprefill["flash_attention_tc"], **fa_launches,
         "launches_train": train["flash_attention"],
         "launches_tc_train": train["flash_attention_tc"],
         "launches_train_zamba2": ztrain["flash_attention"],
         "launches_tc_train_zamba2": ztrain["flash_attention_tc"],
         "max_abs_err": fa_err, "shape": list(FLASH_MAIN),
         **{k: fa_times[k] for k in FLASH_KEYS},
         "shape_zamba2": list(FLASH_ZAMBA),
         **{f"{k}_zamba2": fa_zamba[k] for k in FLASH_KEYS},
         "families": {tag: {"shape": list(FLASH_FAMILIES[tag][0]), **{
             k: t[k] for k in ("variant", "causal", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms",
                               "tflops")}}
                      for tag, t in fa_families.items()}},
        {"name": "ssm_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan.py:29",
         "launches": zprefill["ssm_scan"],
         "launches_train_zamba2": ztrain["ssm_scan"], "max_abs_err": ss_err,
         "shape": list(SSM_MAIN),
         **{k: ss_times[k] for k in ("ms", "plain_ms", "call_ms", "bound_ms",
                                     "bound_by", "library_ms")}},
    ] + train_entries


#: What the kernels line keeps of each flash timing.
FLASH_KEYS = ("variant", "ms", "tc_ms", "simt_ms", "plain_ms", "call_ms",
              "bound_ms", "bound_by", "library_ms", "tflops", "tc_tflops")


def _counters():
    """Every kernel's launch counter."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import power_step as ps
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss

    return (ps.LAUNCHES, rn.LAUNCHES, fa.LAUNCHES, ss.LAUNCHES)


def sim_phases(torch, device, counters, smi):
    """The wave engine's and the sweep front end's phases; returns their
    kernels' entries."""
    from repro_torch.kernels import power_step as ps

    worst, times, bounds = phase_kernel(torch, device)
    _zero(counters)
    main_launches, fw = phase_full_width(torch, ps.LAUNCHES)
    step_launches, step_ms = phase_step_path(torch, ps.LAUNCHES,
                                             fw["equal_share"])
    phase_profile(torch)
    padded_diff = phase_padded(torch, ps.LAUNCHES)
    ilp_diff = phase_ilp(torch, ps.LAUNCHES)
    sweep_fw = phase_sweep_full_width(torch, ps.LAUNCHES, fw, smi)
    service_fw = phase_service_full_width(torch, ps.LAUNCHES, fw, smi)
    del fw["results"]
    sweep_mixed, cells, sweep, solved = phase_sweep_mixed(torch,
                                                          ps.LAUNCHES)
    service_mixed = phase_service_mixed(torch, ps.LAUNCHES, cells, sweep,
                                        solved)
    trace_corpus = phase_trace_corpus(torch, ps.LAUNCHES, smi)
    cluster = phase_cluster(torch, ps.LAUNCHES, smi)
    diff = phase_diff(torch, device, ps.LAUNCHES, smi)

    src = "src/repro_torch/kernels/csrc/power_step.cu"
    per_wave = ("the per-wave entry points run on the engine's \"step\" "
                "path; launches are its counts (phase step_path), "
                "launches_main the default path's")
    return [
        {"name": "wave_run", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/power_step.py:195",
         "replaces_loop": "src/repro/backends/jax/engine.py:211",
         "launches": main_launches["wave_run"],
         "launches_sweep_full_width": sweep_fw["wave_run"],
         "launches_sweep_mixed": sweep_mixed["wave_run"],
         "launches_service_full_width": service_fw["burst"]["wave_run"],
         "launches_service_poisson": service_fw["poisson"]["wave_run"],
         "launches_service_mixed": service_mixed["wave_run"],
         "launches_trace_corpus": trace_corpus["wave_run"],
         "launches_cluster": cluster["wave_run"],
         "max_abs_err": max(fw["abs_diff"], padded_diff, ilp_diff),
         "ms": fw["ms"], "ms_oracle": fw["ms_oracle"],
         "ms_heuristic": fw["ms_heuristic"],
         "latency_floor_ms_heuristic": fw["latency_floor_ms_heuristic"],
         "plain_ms": fw["plain_ms"], "step_ms": step_ms,
         "timing": "equal-share at full width: ms is the kernel (CUDA "
                   "events), plain_ms and step_ms the wall of the plain "
                   "and per-wave paths on the same rows; the latency "
                   "floor is the longest row's waves x one wave's time "
                   "with that row alone on the card",
         **{k: fw["bound"][k] for k in ("bound_ms", "bound_by")},
         "library_ms": None},
        {"name": "power_step", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/power_step.py:195",
         "launches": step_launches["power_step"],
         "launches_main": main_launches["power_step"],
         "launches_sweep_mixed": sweep_mixed["power_step"],
         "launches_service_mixed": service_mixed["power_step"],
         "launches_diff": diff["power_step"],
         "note": per_wave + "; launches_sweep_mixed, "
                            "launches_service_mixed and launches_diff "
                            "the learned policy's, in phases sweep_mixed, "
                            "service_mixed and diff (a checkpoint the "
                            "trainer's CLI wrote on the card)",
         "max_abs_err": worst["power_step"][0],
         "ms": times["power_step_ms"],
         "plain_ms": times["power_step_plain_ms"],
         "call_ms": times["power_step_call_ms"],
         "ms_redistribute": times["power_step_redistribute_ms"],
         "plain_ms_redistribute": times["power_step_redistribute_plain_ms"],
         **{k: bounds["power_step"][k] for k in ("bound_ms", "bound_by")},
         "library_ms": None},
        {"name": "waterfill", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/power_step.py:134",
         "launches": step_launches["waterfill"],
         "launches_main": main_launches["waterfill"], "note": per_wave,
         "max_abs_err": worst["waterfill"][0],
         "ms": times["waterfill_ms"], "plain_ms": times["waterfill_plain_ms"],
         "call_ms": times["waterfill_call_ms"],
         **{k: bounds["waterfill"][k] for k in ("bound_ms", "bound_by")},
         "library_ms": None},
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels._build import load_library

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    kl = load_library()
    emit("build", seconds=time.perf_counter() - t0, nvcc_s=kl.build_s,
         source_s=kl.source_s, library=str(kl.path.relative_to(ROOT)),
         ptxas=[ln.strip() for ln in kl.log.splitlines()
                if "registers" in ln or "spill" in ln
                or ln.startswith("[")])

    kernels = sim_phases(torch, device, _counters(), smi)
    emit("profiler_sessions", process="main", **profiler_summary())
    kernels += run_lm_phases(smi)
    for entry in kernels:    # each source's nvcc seconds in this run
        entry["build_s"] = kl.source_s.get(Path(entry["source"]).name)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# every phase_* function times its own lines (emit's ``seconds``)
for _name in [n for n in globals() if n.startswith("phase_")]:
    globals()[_name] = _timed(globals()[_name])


if __name__ == "__main__":
    sys.exit(main())
