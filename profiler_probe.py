#!/usr/bin/env python3
"""What ``torch.profiler`` records of the port's kernels, on one GPU.

``chip_smoke.py`` sums device time from ``torch.profiler`` sessions
(``device_ms``).  In its LM worker process some sessions recorded no
kernel at all, and others too few.  This probe reproduces the worker's
sessions and reads, for every session, what the profiler kept against
what ran:

* the kernel records the session holds against the launches the
  wrappers counted over the same calls (``LAUNCHES`` deltas times the
  kernels a launch runs), as the profiler's raw events and as
  ``key_averages()`` counts them (``chip_smoke.device_ms``'s count), and
  the same calls' CUDA-event time;
* where the kept records lie on the host's clock: the first record's
  start after the session began (``lead_us``) and the last record's end
  before ``torch.cuda.synchronize()`` returned inside it (``tail_us``).
  A negative ``tail_us`` is a device time stamp later than a host clock
  reading taken after the kernel had finished: the two clocks disagree,
  and the profiler drops a record whose end falls after its session's
  stop.

Each case runs in the session forms ``--forms`` names: ``plain``, as
``device_ms`` ran them before (the calls, a synchronize, the session's
stop), ``hold_stop``, the host idle for ``--hold-ms`` before the
session's stop, ``hold_start``, the calls begun ``--hold-ms`` after its
start, and ``held``, both (as ``chip_smoke.profiler_session`` holds
them).  Sessions repeat for ``--minutes`` in one spawned process, as
the LM worker's do, with the environment ``--env`` sets (the profiler's
own switches, such as ``TEARDOWN_CUPTI``) and ``--load-s`` seconds of
bf16 products between rounds; ``--launches`` calls of the first case,
unprofiled, between a first round (round -1) and the others give the
process a launch history like the LM worker's, whose late sessions
lost records with neither end of the session near them; ``--cases``
picks the cases.  The shared libraries of the installed torch are
searched for the profiler's own strings that bear on this (the window
check, CUPTI's teardown).

Prints one JSON line a round (each session's records, as raw events and
as ``key_averages()`` counts them, the records its calls ran and
``tail_us``) and a summary, and writes every session to ``--out``
(JSONL).  Exits nonzero on a machine without CUDA.  Run from
the repository root:

    python3 profiler_probe.py [--out build/profiler_probe.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: Strings of the profiler's C++ side that name what it drops or tears
#: down (searched in torch's shared libraries).
PROFILER_STRINGS = (b"outside of profiling window", b"TEARDOWN_CUPTI",
                    b"DISABLE_CUPTI_LAZY_REINIT",
                    b"cuptiActivityRegisterTimestampCallback",
                    b"cuptiActivityFlushAll", b"CUPTI_ACTIVITY_FLUSH_PERIOD")


def library_strings() -> dict:
    """Which of :data:`PROFILER_STRINGS` each of torch's libraries holds."""
    import torch

    found = {}
    for lib in sorted((Path(torch.__file__).parent / "lib").glob("*.so*")):
        data = lib.read_bytes()
        hits = [s.decode() for s in PROFILER_STRINGS if s in data]
        if hits:
            found[lib.name] = hits
    return found


def _cases(torch, device):
    """(name, call, kernels a wrapper launch runs, wrapper counter, reps):
    the shapes ``chip_smoke.py``'s LM worker profiles."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((8, 4096), generator=gen, device=device).bfloat16()
    g = torch.randn(4096, generator=gen, device=device).bfloat16()
    q, k, v, do = (torch.randn(s, generator=gen, device=device).bfloat16()
                   for s in ((1, 16, 4096, 128), (1, 16, 4096, 128),
                             (1, 16, 4096, 128), (1, 16, 4096, 128)))
    o = fa.flash_attention_cuda(q, k, v)
    xb, dyb = (torch.randn((4096, 4096), generator=gen,
                           device=device).bfloat16() for _ in range(2))
    return (
        ("rmsnorm_decode", lambda: rn.rmsnorm_cuda(x, g), 1,
         (rn.LAUNCHES, "rmsnorm"), 20),
        ("rmsnorm_bwd", lambda: rn.rmsnorm_bwd(xb, g, dyb), 2,
         (rn.LAUNCHES, "rmsnorm_bwd"), 20),
        ("flash_tc_moe", lambda: fa.flash_attention_cuda(q, k, v), 1,
         (fa.LAUNCHES, "flash_attention_tc"), 10),
        ("sdpa_moe", lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), None, None, 10),
        ("flash_bwd_tc_moe", lambda: fa.flash_attention_bwd_cuda(
            q, k, v, o, do), 3, (fa.LAUNCHES, "flash_attention_bwd_tc"), 5),
    )


def session(torch, fn, reps, form, hold_s):
    """One profiler session of ``reps`` calls of ``fn`` in ``form``
    ("plain", "hold_stop", "hold_start", or "held": both); the kernel
    records it kept, their device us and where they lie on the host's
    clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_start = time.time_ns()
        if form in ("hold_start", "held"):
            time.sleep(hold_s)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        t_sync = time.time_ns()
        if form in ("hold_stop", "held"):
            time.sleep(hold_s)
    results = prof.profiler.kineto_results
    kernels = [e for e in results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and e.end_ns() > e.start_ns()]
    out = {"records": len(kernels),
           "averaged_records": sum(
               e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA),
           "device_us": sum(e.end_ns() - e.start_ns() for e in kernels) / 1e3,
           "trace_start_us": (results.trace_start_ns() - t_start) / 1e3}
    if kernels:
        out["lead_us"] = (min(e.start_ns() for e in kernels) - t_start) / 1e3
        out["tail_us"] = (t_sync - max(e.end_ns() for e in kernels)) / 1e3
    return out


def events_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _load(torch, device, seconds):
    """Keep the card busy with bf16 products for ``seconds`` (the LM
    phases' heavy work between their timed sessions)."""
    a = torch.randn((8192, 8192), device=device).bfloat16()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(8):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()


def _worker(queue, minutes, hold_ms, forms, env, load_s, launches,
            names) -> None:
    """Spawned process: rounds of every case in every form, with ``env``
    set before torch is imported."""
    import os
    import traceback

    os.environ.update(env)
    try:
        import torch

        sys.path.insert(0, str(SRC))
        from repro_torch.kernels._build import load_library

        load_library()
        device = torch.device("cuda")
        cases = [c for c in _cases(torch, device)
                 if not names or c[0] in names]
        for _, fn, *_ in cases:
            fn()
        first = cases[0][1]
        t0 = time.perf_counter()
        rnd = -1 if launches else 0     # round -1: before the history
        while rnd < 0 or time.perf_counter() - t0 < 60 * minutes:
            if rnd == 0 and launches:
                for _ in range(launches):
                    first()
                torch.cuda.synchronize()
            for name, fn, per_launch, counter, reps in cases:
                for form in forms:
                    before = counter[0][counter[1]] if counter else 0
                    rec = session(torch, fn, reps, form, hold_ms / 1e3)
                    if counter:
                        rec["expected"] = per_launch * (
                            counter[0][counter[1]] - before)
                    rec.update(round=rnd, case=name, form=form, reps=reps,
                               s=time.perf_counter() - t0,
                               events_ms=events_ms(torch, fn, reps))
                    queue.put(("session", rec))
            if load_s:
                _load(torch, device, load_s)
            rnd += 1
        queue.put(("done", rnd))
    except Exception:     # reported to the parent, which fails the run
        queue.put(("error", traceback.format_exc()))


def main() -> int:
    import multiprocessing as mp

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "profiler_probe.jsonl")
    ap.add_argument("--minutes", type=float, default=2.0)
    ap.add_argument("--hold-ms", type=float, default=20.0)
    ap.add_argument("--forms", default="plain,hold_stop,hold_start",
                    help="session forms, comma-separated")
    ap.add_argument("--env", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="set in the worker before torch is imported "
                         "(e.g. TEARDOWN_CUPTI=0: keep CUPTI between "
                         "sessions)")
    ap.add_argument("--load-s", type=float, default=0.0,
                    help="seconds of bf16 products between rounds")
    ap.add_argument("--launches", type=int, default=0,
                    help="calls of the first case before the rounds, "
                         "unprofiled (the LM worker's launch history)")
    ap.add_argument("--cases", default="",
                    help="case names, comma-separated (default: all)")
    args = ap.parse_args()
    forms = tuple(args.forms.split(","))
    names = tuple(n for n in args.cases.split(",") if n)
    env = dict(kv.split("=", 1) for kv in args.env)
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"probe": "torch", "torch": torch.__version__,
                      "env": env, "forms": forms,
                      "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "library_strings": library_strings()}), flush=True)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    worker = ctx.Process(target=_worker, args=(
        queue, args.minutes, args.hold_ms, forms, env, args.load_s,
        args.launches, names))
    worker.start()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    summary, rounds = {}, {}
    status = "error"
    with args.out.open("w") as fh:
        while True:
            kind, rec = queue.get(timeout=120 + 90 * args.minutes)
            if kind != "session":
                status = kind
                break
            fh.write(json.dumps(rec) + "\n")
            line = rounds.setdefault(rec["round"], {"probe": "round",
                                                    "round": rec["round"]})
            line["s"] = rec["s"]
            line[f"{rec['case']}/{rec['form']}"] = [
                rec["records"], rec["averaged_records"], rec.get("expected"),
                rec.get("tail_us")]
            if len(line) == 3 + len(forms) * (len(names) or 5):
                print(json.dumps(line), flush=True)
            s = summary.setdefault(f"{rec['case']}/{rec['form']}", {
                "sessions": 0, "short": 0, "empty": 0, "min_tail_us": None,
                "max_tail_us": None})
            s["sessions"] += 1
            want = rec.get("expected")
            s["short"] += int(want is not None and rec["records"] < want)
            s["empty"] += int(rec["records"] == 0)
            if "tail_us" in rec:
                for key, pick in (("min_tail_us", min), ("max_tail_us", max)):
                    s[key] = rec["tail_us"] if s[key] is None else \
                        pick(s[key], rec["tail_us"])
    worker.join(timeout=60)
    if worker.is_alive():
        worker.terminate()
        worker.join()
    print(json.dumps({"probe": "summary", "status": status,
                      "rounds": rec if status == "done" else None,
                      "by_case_and_form": summary}), flush=True)
    if status != "done":
        print(rec, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
