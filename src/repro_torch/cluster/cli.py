"""``python -m repro_torch.cluster`` — generate and run arrival streams.

Two subcommands:

``generate``
    Emit a seeded Poisson arrival trace (versioned JSONL) over a
    member-pool prefab or trace corpus::

        python -m repro_torch.cluster generate --pool mixed --jobs 1000 \\
            --rate-hz 2.0 --seed 0 --out arrivals_1k.jsonl

``run``
    Calibrate, schedule, and score one or more outer policies on a
    trace, with the batched replay cross-check and the CI gate::

        python -m repro_torch.cluster run arrivals_1k.jsonl --nodes 12 \\
            --bound-frac 0.5 --policies fifo-equal-split,backfill \\
            --expect-clean --json out.json

    The sweeps run on the torch engine on the card by default and fail
    without one; ``--device cpu`` runs the engine's plain path on the
    CPU, and ``--executor vector`` the numpy batch backend.
    ``--expect-clean`` exits nonzero unless the calibration and replay
    sweeps ran with zero event fallbacks and (on torch) no kernel build
    after the first dispatch and no steady-state recompile.

The reference's CLI (``python -m repro.cluster``) takes the same
arguments, with ``--executor jax|vector`` and no ``--device``; its
``--expect-clean`` reads XLA recompiles where this one reads kernel
builds.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .arrivals import (DEFAULT_SLO_STRETCH, POOL_PREFABS, dump_arrivals,
                       load_arrivals, member_pool, poisson_arrivals)
from .metrics import policy_grid, suggest_bound
from .policies import CLUSTER_POLICIES
from .scheduler import DEFAULT_INNER_POLICY, RateModel


def build_parser() -> argparse.ArgumentParser:
    """The CLI parser (exposed for docs and tests)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cluster",
        description="cluster-level job-arrival scheduling under a "
                    "shared power bound")
    sub = ap.add_subparsers(dest="cmd", required=True)

    gen = sub.add_parser("generate",
                         help="emit a seeded Poisson arrival trace")
    gen.add_argument("--pool", default="mixed",
                     help=f"member pool: one of {POOL_PREFABS} or a "
                          f"trace-corpus directory")
    gen.add_argument("--jobs", type=int, default=100,
                     help="number of arrivals")
    gen.add_argument("--rate-hz", type=float, default=1.0,
                     help="mean arrival rate (jobs per second)")
    gen.add_argument("--seed", type=int, default=0)
    gen.add_argument("--users", type=int, default=3,
                     help="number of submitting users")
    gen.add_argument("--slo", type=float, default=DEFAULT_SLO_STRETCH,
                     help="SLO stretch factor over best-case solo "
                          "makespan")
    gen.add_argument("--out", required=True, help="output JSONL path")
    gen.set_defaults(fn=cmd_generate)

    run = sub.add_parser("run",
                         help="schedule a trace under outer policies")
    run.add_argument("trace", help="arrival-trace JSONL path")
    run.add_argument("--nodes", type=int, required=True,
                     help="node-pool size")
    bound = run.add_mutually_exclusive_group()
    bound.add_argument("--bound-w", type=float,
                       help="absolute cluster bound (watts)")
    bound.add_argument("--bound-frac", type=float, default=0.6,
                       help="bound as a fraction of the pool's "
                            "flat-out capacity (default 0.6)")
    run.add_argument("--policies",
                     default="fifo-equal-split,backfill,power-aware,"
                             "fair-share",
                     help="comma-separated outer policies "
                          f"(available: {sorted(CLUSTER_POLICIES.names())})")
    run.add_argument("--inner-policy", default=DEFAULT_INNER_POLICY,
                     help="per-job power policy for calibration and "
                          "replay")
    run.add_argument("--executor", default="torch",
                     choices=("torch", "vector"),
                     help="batched backend for the padded sweeps "
                          "(torch: the wave engine)")
    run.add_argument("--device", default=None,
                     help="torch device of --executor torch (default: "
                          "the card; raises without CUDA)")
    run.add_argument("--levels", type=int, default=6,
                     help="rate-model bound levels per member")
    run.add_argument("--no-replay", action="store_true",
                     help="skip the batched ground-truth replay")
    run.add_argument("--expect-clean", action="store_true",
                     help="exit nonzero on any event fallback, or "
                          "(torch) any kernel build after the first "
                          "dispatch")
    run.add_argument("--json", help="write the reports to this path")
    run.set_defaults(fn=cmd_run)
    return ap


def cmd_generate(args: argparse.Namespace) -> int:
    """The ``generate`` subcommand."""
    pool = member_pool(args.pool, seed=args.seed)
    users = tuple(f"u{k}" for k in range(args.users))
    trace = poisson_arrivals(pool, n_jobs=args.jobs,
                             rate_hz=args.rate_hz, seed=args.seed,
                             users=users, slo=args.slo,
                             meta={"pool": args.pool})
    dump_arrivals(trace, args.out)
    print(f"wrote {len(trace)} arrivals over {len(trace.members)} "
          f"members ({len(users)} users, {trace.duration:.1f}s span) "
          f"-> {args.out}")
    return 0


def cmd_run(args: argparse.Namespace) -> int:
    """The ``run`` subcommand."""
    trace = load_arrivals(args.trace)
    policies = [p.strip() for p in args.policies.split(",") if p.strip()]
    bound = args.bound_w if args.bound_w is not None else \
        suggest_bound(trace, total_nodes=args.nodes,
                      frac=args.bound_frac)
    print(f"{len(trace)} jobs, {len(trace.members)} members, "
          f"{args.nodes} nodes, bound {bound:.1f} W, "
          f"executor {args.executor}")
    model = RateModel(trace, inner_policy=args.inner_policy,
                      levels=args.levels, executor=args.executor,
                      device=args.device)
    cal = model.calibrate()
    cal_fallbacks = len(cal.event_fallbacks())
    print(f"calibrated {len(trace.members)} members x {args.levels} "
          f"levels: {cal.backend_summary()}")
    cells = policy_grid(trace, bound_w=bound, total_nodes=args.nodes,
                        policies=policies, model=model,
                        replay=not args.no_replay,
                        replay_executor=args.executor,
                        device=args.device)
    hdr = (f"{'policy':>18} {'makespan':>10} {'jobs/s':>8} "
           f"{'wait.mean':>10} {'wait.p99':>10} {'slo':>6} "
           f"{'util':>6} {'relerr':>8}")
    print(hdr)
    problems: List[str] = []
    if cal_fallbacks:
        problems.append(f"{cal_fallbacks} calibration event fallbacks")
    payload = {"trace": args.trace, "bound_w": bound,
               "nodes": args.nodes, "executor": args.executor,
               "policies": []}
    for cell in cells:
        rep = cell.report
        err = f"{cell.check.max_rel_err:8.1%}" if cell.check else \
            f"{'-':>8}"
        print(f"{rep.policy:>18} {rep.makespan:>9.1f}s "
              f"{rep.throughput:>8.3f} {rep.wait_mean:>9.1f}s "
              f"{rep.wait_p99:>9.1f}s {rep.slo_attainment:>6.0%} "
              f"{rep.util_mean:>6.0%} {err}")
        entry = rep.as_dict()
        if cell.check:
            entry["replay"] = {
                "event_fallbacks": cell.check.event_fallbacks,
                "recompiles": cell.check.recompiles,
                "max_rel_err": cell.check.max_rel_err,
                "mean_rel_err": cell.check.mean_rel_err}
            if cell.check.event_fallbacks:
                problems.append(f"{rep.policy}: "
                                f"{cell.check.event_fallbacks} replay "
                                f"event fallbacks")
            if args.executor == "torch" and cell.check.recompiles:
                problems.append(f"{rep.policy}: "
                                f"{cell.check.recompiles} replay "
                                f"recompiles")
        payload["policies"].append(entry)
    if args.executor == "torch":
        late = _builds_after_first(
            [cal] + [c.check.sweep for c in cells if c.check])
        if late:
            problems.append(f"{late} kernel builds after the first "
                            f"dispatch")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    if args.expect_clean:
        if problems:
            print("NOT CLEAN: " + "; ".join(problems))
            return 1
        print("clean: zero event fallbacks"
              + (", no kernel build after the first dispatch"
                 if args.executor == "torch" else ""))
    return 0


def _builds_after_first(sweeps) -> int:
    """Dispatches, past the first of all of ``sweeps`` in order, that
    built the kernel library (it is built once a process, on first
    use)."""
    buckets = [b for sweep in sweeps if sweep.profile is not None
               for b in sweep.profile.buckets]
    return sum(1 for b in buckets[1:] if b.compiled)


def main(argv: Optional[List[str]] = None) -> int:
    """Entry point for ``python -m repro_torch.cluster``."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
