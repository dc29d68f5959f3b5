"""``python -m repro_torch.traces`` — the trace subsystem's command line.

Subcommands::

    record    synthesise a ground-truth workload recording
    validate  schema-check + replay-validate trace files
    convert   trace -> dependency-graph text (graph.from_text format)
    sweep     run a corpus directory through the batched sweep engine

Examples (``docs/traces.md`` tours the reference's CLI; this one takes
its arguments, with ``--backend torch`` in place of ``jax``, and a
``--device``)::

    python -m repro_torch.traces record --workload npb-is --nodes 4 \\
        --out traces/is_a4.jsonl
    python -m repro_torch.traces validate traces/*.jsonl
    python -m repro_torch.traces convert traces/is_a4.jsonl
    python -m repro_torch.traces sweep traces/
    python -m repro_torch.traces sweep traces/ --device cpu

``sweep`` runs the torch engine on the card by default and fails
without one; ``--device cpu`` runs its plain path on the CPU, and
``--backend vector|thread|event`` the numpy backends.  ``record``,
``validate`` and ``convert`` run on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _cmd_record(args) -> int:
    from .record import record_workload, with_noise
    from .schema import dump_trace, dumps_trace

    trace = record_workload(args.workload, n_nodes=args.nodes,
                            klass=args.klass, seed=args.seed,
                            hetero=args.hetero, freqs=args.freqs)
    if args.jitter or args.skew or args.drop:
        trace = with_noise(trace, jitter_s=args.jitter,
                           skew_s=args.skew, drop=args.drop,
                           seed=args.seed)
    if args.out:
        dump_trace(trace, args.out)
        print(f"wrote {args.out}: {len(trace.events)} records, "
              f"{trace.ranks} ranks, wall clock "
              f"{trace.wall_clock:.3f}s")
    else:
        sys.stdout.write(dumps_trace(trace))
    return 0


def _cmd_validate(args) -> int:
    from .reconstruct import reconstruct
    from .replay import replay_report
    from .schema import TraceError, load_trace

    failures = 0
    for path in args.paths:
        try:
            trace = load_trace(path, strict=not args.lenient)
            recon = reconstruct(trace, strict=not args.lenient,
                                validate=False)
            report = replay_report(recon, tol=args.tol)
        except TraceError as e:
            print(f"{path}: INVALID — {e}")
            failures += 1
            continue
        print(f"{path}: {report}")
        if not recon.report.clean:
            print(f"  reconstruction drops: {recon.report}")
        if not report.ok:
            failures += 1
    return 1 if failures else 0


def _cmd_convert(args) -> int:
    from .reconstruct import reconstruct
    from .schema import TraceError, load_trace

    try:
        recon = reconstruct(load_trace(args.path,
                                       strict=not args.lenient),
                            strict=not args.lenient, validate=False)
    except TraceError as e:
        print(f"{args.path}: INVALID — {e}")
        return 1
    text = recon.graph.to_text()
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
        print(f"wrote {args.out}: {len(recon.graph)} jobs")
    else:
        sys.stdout.write(text)
    return 0


def _cmd_sweep(args) -> int:
    from repro_torch.core import SweepEngine

    from .corpus import TraceCorpus
    from .schema import TraceError

    try:
        corpus = TraceCorpus.from_dir(args.corpus,
                                      strict=not args.lenient)
    except TraceError as e:
        print(f"{args.corpus}: INVALID — {e}")
        return 1
    family = corpus.family(bound_fracs=tuple(args.bound_fracs),
                           policies=tuple(args.policies.split(",")))
    scenarios = family.scenarios()
    print(f"corpus {args.corpus}: {len(corpus)} traces "
          f"({', '.join(corpus.names)}), {len(scenarios)} cells")
    executor = "serial" if args.backend == "event" else args.backend
    sweep = SweepEngine(executor=executor, device=args.device).run(
        scenarios)
    if sweep.failures:
        for r in sweep.failures:
            print(f"FAIL {r.scenario.name}: {r.error}")
        return 1
    print(sweep.backend_summary())
    fallbacks = sweep.event_fallbacks()
    if fallbacks:
        print(f"warning: {len(fallbacks)} cells fell back to the event "
              f"simulator")
    for m in family.members:
        name = f"{family.name}/{m.name}"
        for bound in family.member_bounds(m):
            parts = [f"{name:<24s} P={bound:8.2f}W"]
            for policy in family.policies:
                r = sweep.result(name, policy, bound)
                parts.append(f"{policy}={r.makespan:.2f}s")
            print("  ".join(parts))
    if args.bench_json:
        rows = sweep.rows()
        with open(args.bench_json, "w") as fh:
            json.dump({"corpus": args.corpus, "cells": len(rows),
                       "rows": rows}, fh, indent=2, sort_keys=True)
        print(f"wrote {args.bench_json}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The CLI parser (exposed for the docs and tests)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.traces",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("record", help="synthesise a workload recording")
    rec.add_argument("--workload", required=True,
                     help="listing2 | npb-is | npb-ep | npb-cg | moe | "
                          "layered | forkjoin | pipeline")
    rec.add_argument("--nodes", type=int, default=4)
    rec.add_argument("--klass", default="A", choices=("A", "B", "C"))
    rec.add_argument("--seed", type=int, default=0)
    rec.add_argument("--hetero", action="store_true",
                     help="mixed Arndale/ODROID-style cluster")
    rec.add_argument("--freqs", default="nominal",
                     choices=("nominal", "random"),
                     help="DVFS states the synthetic run used")
    rec.add_argument("--jitter", type=float, default=0.0,
                     help="timestamp jitter stddev (s)")
    rec.add_argument("--skew", type=float, default=0.0,
                     help="per-rank clock skew bound (s)")
    rec.add_argument("--drop", type=float, default=0.0,
                     help="record drop probability")
    rec.add_argument("--out", "-o", default=None)
    rec.set_defaults(fn=_cmd_record)

    val = sub.add_parser("validate",
                         help="schema + replay validation of traces")
    val.add_argument("paths", nargs="+")
    val.add_argument("--tol", type=float, default=0.05,
                     help="replay tolerance (relative)")
    val.add_argument("--lenient", action="store_true",
                     help="accept noisy traces (jitter/drops)")
    val.set_defaults(fn=_cmd_validate)

    conv = sub.add_parser("convert",
                          help="trace -> dependency graph text")
    conv.add_argument("path")
    conv.add_argument("--lenient", action="store_true")
    conv.add_argument("--out", "-o", default=None)
    conv.set_defaults(fn=_cmd_convert)

    sw = sub.add_parser("sweep",
                        help="sweep a corpus directory, batched")
    sw.add_argument("corpus")
    sw.add_argument("--backend", default="torch",
                    choices=("event", "thread", "vector", "torch"),
                    help="torch (default): the wave engine; event: "
                         "one event simulation a cell, in process")
    sw.add_argument("--device", default=None,
                    help="torch device of --backend torch (default: "
                         "the card; raises without CUDA)")
    sw.add_argument("--policies", default="equal-share,oracle")
    sw.add_argument("--bound-fracs", type=float, nargs="+",
                    default=[0.15, 0.4, 0.8])
    sw.add_argument("--lenient", action="store_true")
    sw.add_argument("--bench-json", default=None)
    sw.set_defaults(fn=_cmd_sweep)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
