"""Job-graph extraction from one LM step's collective schedule (§VII-A1
analogue).

The paper's MPI wrapper intercepts communication calls to build the
dependency graph online, *without modifying the program*.  The
reference reads the schedule from compiled (post-SPMD) HLO text; the
port runs eagerly, so its dry run (:mod:`repro_torch.launch.dryrun`)
logs every collective its step issues, in order, as ``(kind, bytes)``
pairs.  :func:`step_job_graph` takes either: HLO text (parsed by
:func:`repro_torch.core.hlo.collective_schedule`, as the reference
does) or such a schedule.  Given the same schedule, both give the same
graph.

``step_job_graph`` turns that schedule into the paper's abstraction: per
worker, compute segments (jobs) separated by collectives (barriers).
Compute work per segment is apportioned from the step's analytic FLOPs;
per-worker skew models the straggler sources (data skew, hot experts,
heterogeneous pods).  The resulting JobDependencyGraph plugs directly
into the ILP (§IV) and the online heuristic (§V) — scheduling *real*
workload structure.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple, Union

from .graph import JobDependencyGraph
from .hlo import collective_schedule
from .workloads import TraceBuilder

#: collectives treated as memory/comm-bound segments (cpu_frac low)
_COMM_CPU_FRAC = 0.3
_COMPUTE_CPU_FRAC = 0.85

#: HLO text, or an ordered ``(kind, bytes)`` collective schedule
Schedule = Union[str, Sequence[Tuple[str, int]]]


def as_schedule(source: Schedule) -> List[Tuple[str, int]]:
    """The ``(kind, bytes)`` list of ``source``: parsed from HLO text, or
    a schedule's pairs as they are."""
    if isinstance(source, str):
        return collective_schedule(source)
    return [(str(kind), int(nbytes)) for kind, nbytes in source]


def step_job_graph(source: Schedule, n_nodes: int, total_work: float = 100.0,
                   skew: float = 0.15, min_segments: int = 1,
                   max_segments: int = 64, seed: int = 0
                   ) -> JobDependencyGraph:
    """Build the per-step job dependency graph from compiled HLO text or
    from a ``(kind, bytes)`` collective schedule.

    ``n_nodes`` is the worker granularity the controller manages (hosts /
    pods, not chips).  ``total_work`` is the step's compute time at
    nominal power, split across segments proportional to position;
    ``skew`` adds per-node multiplicative noise (the blackout source).
    """
    sched = as_schedule(source)
    if len(sched) > max_segments:
        # keep the largest collectives, merge the rest into segments
        keep = sorted(range(len(sched)),
                      key=lambda i: -sched[i][1])[:max_segments]
        sched = [sched[i] for i in sorted(keep)]
    n_seg = max(len(sched), min_segments)
    per_seg = total_work / n_seg

    rng = random.Random(seed)
    tb = TraceBuilder(n_nodes)
    group = list(range(n_nodes))
    for si in range(n_seg):
        kind = sched[si][0] if si < len(sched) else "barrier"
        for node in range(n_nodes):
            w = per_seg * (1.0 + rng.uniform(-skew, skew))
            tb.compute(node, w, cpu_frac=_COMPUTE_CPU_FRAC)
        tb.collective(kind if si < len(sched) else "barrier", group)
    for node in range(n_nodes):
        tb.compute(node, per_seg * 0.1, cpu_frac=_COMM_CPU_FRAC)
    return tb.build()


def describe_schedule(source: Schedule) -> List[Tuple[str, int]]:
    """Human-readable collective schedule (kind, bytes per device)."""
    return as_schedule(source)
