"""Serving CLI of the port: two front ends behind one entry point.

**Sweep-service mode** (``--trace-corpus``) replays a directory of
recorded MPI traces into the streaming sweep service
(:class:`repro_torch.serving.SweepService`) as a Poisson arrival stream
and reports throughput, latency percentiles and the kernel-build
profile::

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --trace-corpus examples/traces --rate-hz 50 --expect-clean

``--executor torch`` (the default) runs the wave engine on the card and
fails without one; ``--device cpu`` runs its plain path on the CPU, and
``--executor vector`` the numpy batch backend.  ``--expect-clean`` turns
the steady-state contract into an exit code: nonzero when any request
fell back off the batched backend, or any dispatch built the kernel
library again for a key it had dispatched (a recompile) or after the
warm-up pass.

**LLM mode** (default, no ``--trace-corpus``): batched prefill + decode
of any decoder config (dense, vlm, moe, hybrid, ssm; the encoder has no
decode step) with random weights from a seed, through
:class:`ServeEngine`::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --full
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch moonshot-v1-16b-a3b --full

It runs on the card by default and fails without one; ``--device cpu``
runs it on the CPU (``--smoke``, the default, is the reduced config).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _emit_power_timelines(family) -> int:
    """Render one exemplar per corpus member as per-node power tracks.

    The streaming replay runs on the batched backends, which keep no
    per-node power traces — so the power-timeline view of a traced
    replay comes from re-running one scenario per distinct graph
    through the event simulator with ``node_trace=True``.  Only called
    when tracing is enabled; returns the number of events emitted.
    """
    from repro_torch.core.simulator import simulate
    from repro_torch.obs import timeline

    seen = set()
    n = 0
    for s in family.scenarios():
        if id(s.graph) in seen:
            continue
        seen.add(id(s.graph))
        result = simulate(s.graph, s.specs, s.bound_w, policy=s.policy,
                          latency_s=s.latency_s, trace_every=0.0,
                          bound_schedule=s.bound_schedule,
                          node_trace=True)
        bound = ([(0.0, s.bound_w)] + list(s.bound_schedule)
                 if s.bound_schedule else s.bound_w)
        n += timeline.sim_tracks(result, bound, label=s.name,
                                 specs=s.specs)
    return n


def _serve_sweep(args: argparse.Namespace) -> int:
    from repro_torch.core.scenarios import ScenarioFamily
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving import SweepService, poisson_replay

    family = ScenarioFamily.from_corpus(
        args.trace_corpus,
        bound_fracs=tuple(args.bound_fracs),
        policies=tuple(args.policies),
        strict=not args.no_strict)
    scenarios = family.scenarios() * args.repeat
    print(f"[serve] corpus {args.trace_corpus}: "
          f"{len(family.members)} traces -> {len(scenarios)} requests "
          f"({args.repeat}x family), offered rate {args.rate_hz}/s")

    with SweepService(executor=args.executor,
                      flush_deadline_s=args.flush_deadline,
                      bucket_rows=args.bucket_rows,
                      shard_devices=args.shard_devices,
                      result_cache=not args.no_result_cache,
                      device=args.device) as svc:
        if args.warmup:
            # Warm pass: one submission of every envelope, drained, so
            # the replay below measures steady state.
            t0 = time.perf_counter()
            for t in svc.submit_many(family.scenarios()):
                t.result(timeout=args.timeout)
            svc.drain(timeout=args.timeout)
            print(f"[serve] warm-up: {len(svc.profile.buckets)} buckets,"
                  f" {svc.profile.compiles} kernel builds,"
                  f" {time.perf_counter() - t0:.2f}s")
        warm_buckets = len(svc.profile.buckets)
        report = poisson_replay(svc, scenarios, rate_hz=args.rate_hz,
                                seed=args.seed, timeout_s=args.timeout)
        stats = svc.stats()
        profile = svc.profile

    summary = report.to_dict()
    summary["stats"] = stats.to_dict()
    summary["executor"] = args.executor
    summary["device"] = None if svc.device is None else str(svc.device)
    summary["compiles"] = profile.compiles
    summary["recompiles"] = profile.recompiles
    summary["compiles_after_warmup"] = profile.compiles_after(
        warm_buckets)
    print(f"[serve] {summary['requests']} requests in "
          f"{summary['wall_s']:.2f}s -> "
          f"{summary['throughput_rps']:.1f} req/s | latency "
          f"p50={summary['latency_p50_s'] * 1e3:.1f}ms "
          f"p99={summary['latency_p99_s'] * 1e3:.1f}ms | "
          f"{summary['fallbacks']} fallbacks, "
          f"{summary['cache_hits']} cache hits | kernels: "
          f"{summary['compiles']} builds, "
          f"{summary['compiles_after_warmup']} after warm-up")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(summary, fh, indent=2)
        print(f"[serve] wrote {args.json}")

    if obs_trace.enabled():
        n_ev = _emit_power_timelines(family)
        path = obs_trace.flush_env_trace()
        print(f"[serve] trace: {n_ev} power-timeline events"
              + (f", wrote {path}" if path else ""))

    if summary["failures"]:
        for rec in report.failures[:5]:
            print(f"[serve] FAILED {rec.scenario.name}: {rec.error}")
        return 1
    if args.expect_clean:
        problems = []
        if summary["fallbacks"]:
            problems.append(f"{summary['fallbacks']} fallbacks")
        if summary["recompiles"]:
            problems.append(f"{summary['recompiles']} recompiles")
        if args.warmup and summary["compiles_after_warmup"]:
            problems.append(f"{summary['compiles_after_warmup']} "
                            "kernel builds after warm-up")
        if problems:
            print(f"[serve] NOT CLEAN: {', '.join(problems)}")
            return 1
        print("[serve] clean: no fallbacks, no steady-state kernel "
              "builds")
    return 0


def _serve_llm(args: argparse.Namespace) -> int:
    import numpy as np
    import torch

    from repro_torch.backends.engine import resolve_device
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import init_params
    from repro_torch.serving.engine import ServeEngine

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    engine = ServeEngine(cfg, params,
                         max_seq=args.prompt_len + args.max_new,
                         max_batch=args.batch, device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    t0 = time.perf_counter()
    result = engine.generate(prompts, args.max_new,
                             temperature=args.temperature)
    dt = time.perf_counter() - t0
    tps = args.batch * args.max_new / dt
    print(f"[serve] {args.arch} on {device}: batch={args.batch} "
          f"prompt={args.prompt_len} new={args.max_new} "
          f"-> {dt:.2f}s ({tps:.1f} tok/s incl. prefill)")
    for b in range(min(args.batch, 2)):
        print(f"  lane {b}: ...{result.tokens[b, -8:].tolist()}")
    return 0


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS, ENCODER_ARCHS

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises "
                         "without CUDA)")
    sweep = ap.add_argument_group("sweep-service mode")
    sweep.add_argument("--trace-corpus", default=None, metavar="DIR",
                       help="directory of *.jsonl traces; presence "
                            "selects sweep-service mode")
    sweep.add_argument("--executor", choices=("torch", "vector"),
                       default="torch")
    sweep.add_argument("--rate-hz", type=float, default=50.0,
                       help="Poisson arrival rate (requests/s)")
    sweep.add_argument("--repeat", type=int, default=3,
                       help="replay the corpus family this many times")
    sweep.add_argument("--flush-deadline", type=float, default=0.05,
                       help="max seconds a request waits in an open "
                            "bucket (latency SLO knob)")
    sweep.add_argument("--bucket-rows", type=int, default=8)
    sweep.add_argument("--bound-fracs", type=float, nargs="+",
                       default=(0.15, 0.4, 0.8))
    sweep.add_argument("--policies", nargs="+",
                       default=("equal-share", "oracle"))
    sweep.add_argument("--shard-devices", type=int, default=None,
                       help="devices each bucket's rows split over "
                            "(default: every visible one)")
    sweep.add_argument("--seed", type=int, default=0)
    sweep.add_argument("--timeout", type=float, default=300.0)
    sweep.add_argument("--no-warmup", dest="warmup",
                       action="store_false", default=True)
    sweep.add_argument("--no-result-cache", action="store_true")
    sweep.add_argument("--no-strict", action="store_true",
                       help="load the corpus leniently (noisy traces)")
    sweep.add_argument("--json", default=None, metavar="PATH",
                       help="write the replay summary as JSON")
    sweep.add_argument("--expect-clean", action="store_true",
                       help="exit nonzero on fallbacks or steady-state "
                            "kernel builds (CI gate)")

    llm = ap.add_argument_group("LLM mode (default)")
    llm.add_argument("--arch", choices=[a for a in ARCH_IDS
                                        if a not in ENCODER_ARCHS],
                     default="qwen1.5-4b")
    llm.add_argument("--smoke", action="store_true", default=True)
    llm.add_argument("--full", dest="smoke", action="store_false")
    llm.add_argument("--batch", type=int, default=4)
    llm.add_argument("--prompt-len", type=int, default=16)
    llm.add_argument("--max-new", type=int, default=24)
    llm.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    if args.trace_corpus is not None:
        return _serve_sweep(args)
    return _serve_llm(args)

if __name__ == "__main__":
    sys.exit(main())
