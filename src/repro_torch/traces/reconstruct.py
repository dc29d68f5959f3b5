"""Trace → :class:`JobDependencyGraph` reconstruction (paper §IV, §VII-A1).

The inverse of the recording side: each rank's compute spans become that
node's job sequence (work calibrated through the power LUT, see
:mod:`repro_torch.traces.calibrate`), and the communication ops between spans
become cross-node dependency edges through the **same matching engine**
:class:`~repro_torch.core.workloads.TraceBuilder` compiles with
(:func:`~repro_torch.core.workloads.match_comm_ops`): collectives match by
occurrence order within ``(name, group)``, sends/recvs pair FIFO per
``(src, dst, tag)`` channel, and every receiving op makes the job
*after* it depend on the matched producing jobs.

Program (``seq``) order is authoritative; timestamps are only used for

* duration calibration (work units),
* the per-job frequency map handed to the replay validator, and
* the **causality filter** in lenient mode: when matching had to drop
  records, a matched edge whose producer *ends* after its child
  *starts* (beyond ``causal_slack_s``) cannot be a real dependency — it
  is a mis-match induced by the loss and is discarded (counted in the
  report) rather than risking a dependency cycle.  On cleanly-matched
  traces the filter never fires, so pure jitter/skew cannot delete
  edges.

Nonblocking ops: a ``send``/``recv`` carrying ``req`` claims its FIFO
matching slot at the *post* (MPI's non-overtaking order — an isend
posted before a blocking send to the same peer matches first), with the
isend's *producer* being the job preceding the post (the data existed
then) and an irecv's *child* the job following the matching ``wait``
(the data is only guaranteed then).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.graph import GraphError, JobDependencyGraph, JobId
from repro_torch.core.power import NodeSpec
from repro_torch.core.workloads import (MatchReport, OpSite,
                                        match_comm_ops)

from .calibrate import span_work, specs_for, state_freq
from .schema import SpanRecord, Trace, TraceError

#: Lenient-mode causality slack (seconds): a matched dependency edge is
#: kept only if the producer ends no later than this after the child
#: starts — generous against jitter, tight against the iterations-apart
#: mis-matches dropped collective records cause.
CAUSAL_SLACK_S = 0.5


@dataclass
class ReconstructionReport:
    """What lenient reconstruction had to paper over (all-zero = exact)."""

    match: MatchReport = field(default_factory=MatchReport)
    dropped_acausal: int = 0

    @property
    def clean(self) -> bool:
        """True when nothing was dropped anywhere in the pipeline."""
        return self.match.clean and self.dropped_acausal == 0


@dataclass
class ReconstructedGraph:
    """A trace turned back into a simulator-ready workload.

    ``graph`` uses ranks as node ids and 0-based per-rank job indices.
    ``freqs`` maps each job to the DVFS state its span was logged at
    (replay uses it); ``specs`` is the calibration cluster.
    """

    graph: JobDependencyGraph
    specs: List[NodeSpec]
    freqs: Dict[JobId, float]
    trace: Trace
    report: ReconstructionReport

    @property
    def name(self) -> str:
        """A human label: the recorded workload name when present."""
        return str(self.trace.meta.get("workload", "trace"))


def reconstruct(trace: Trace,
                specs: Optional[Sequence[NodeSpec]] = None,
                strict: bool = True,
                causal_slack_s: float = CAUSAL_SLACK_S,
                validate: bool = True) -> ReconstructedGraph:
    """Reconstruct the dependency graph a trace records (see module doc).

    ``strict=True`` (clean recordings) raises on anything unmatched;
    ``strict=False`` (noisy logs) drops unmatched ops and acausal edges
    and accounts for them in ``result.report``.  ``validate=False``
    skips re-validating a trace a loader already validated (the corpus
    ingest path).
    """
    if validate:
        trace.validate(strict=strict)
    resolved = specs_for(trace, specs)

    spans: Dict[int, List[SpanRecord]] = {}
    sites: Dict[int, List[OpSite]] = {}
    by_rank = trace.events_by_rank()

    for rank in range(trace.ranks):
        spans[rank] = []
        # mutable [site_op, producer, child] triples: a nonblocking op
        # claims its FIFO slot at *post* time (MPI's non-overtaking
        # order), but an irecv's child is only known at the wait
        rank_sites: List[list] = []
        pending: Dict[str, list] = {}
        n_seen = 0
        for e in by_rank.get(rank, ()):
            if isinstance(e, SpanRecord):
                spans[rank].append(e)
                n_seen += 1
                continue
            if e.kind == "wait":
                # complete the posted op: an isend's producer was fixed
                # at the post; an irecv's dependency lands here.  A wait
                # whose post was dropped (lenient) matches nothing.
                posted = pending.pop(e.req, None)
                if posted is not None and posted[0][0] != "send":
                    posted[2] = (rank, n_seen)   # irecv / nonblocking coll
                continue
            producer = (rank, n_seen - 1) if n_seen > 0 else None
            child = (rank, n_seen)
            if e.is_collective:
                key = (e.kind, e.tag) if e.tag else e.kind
                site = [("coll", key, tuple(e.group)), producer, child]
            elif e.kind == "send":
                site = [("send", e.peer, e.tag), producer, child]
            else:
                site = [("recv", e.peer, e.tag), producer, child]
            rank_sites.append(site)
            if e.req is not None:
                pending[e.req] = site
        sites[rank] = [tuple(s) for s in rank_sites]

    try:
        deps, match_report = match_comm_ops(sites, strict=strict)
    except TraceError:
        raise
    except ValueError as e:
        # strict matching failures are trace inconsistencies — surface
        # them under the schema's error type so every consumer (CLI,
        # corpus loaders) handles one exception family
        raise TraceError(str(e)) from e
    report = ReconstructionReport(match=match_report)

    # span wall-clock windows, for the causality filter
    window: Dict[JobId, Tuple[float, float]] = {}
    for rank, rank_spans in spans.items():
        for k, s in enumerate(rank_spans):
            window[(rank, k)] = (s.t0, s.t1)

    # The causality filter guards against the mis-matches that *dropped
    # records* cause (shifted FIFO/occurrence alignment can pair jobs
    # iterations apart and even manufacture cycles).  It fires only when
    # matching actually dropped something: on a cleanly-matched trace the
    # order-based matching is structurally sound no matter how noisy the
    # timestamps are, and filtering there would delete real edges whose
    # endpoints merely jittered past each other.
    if not strict and not match_report.clean:
        for child, producers in list(deps.items()):
            kept = []
            for p in producers:
                p_end = window.get(p, (0.0, 0.0))[1]
                c_start = window.get(child, (float("inf"),) * 2)[0]
                if p_end <= c_start + causal_slack_s:
                    kept.append(p)
                else:
                    report.dropped_acausal += 1
            deps[child] = kept

    g = JobDependencyGraph()
    freqs: Dict[JobId, float] = {}
    for rank in range(trace.ranks):
        n_jobs = len(spans[rank])
        # a *receiving* op past the last span needs a terminal job to
        # carry its dependency (a trailing send's child is never used)
        if any(op[0] != "send" and child[1] >= n_jobs
               for op, _producer, child in sites[rank]):
            n_jobs += 1
        # a rank that logged nothing still exists: without a node the
        # graph's node list shifts and every positional specs lookup
        # (replay, corpus, simulators) pairs later ranks with the wrong
        # cluster entry
        n_jobs = max(n_jobs, 1)
        for k in range(n_jobs):
            serial = [(rank, k - 1)] if k > 0 else []
            if k < len(spans[rank]):
                s = spans[rank][k]
                work = span_work(s, resolved[rank], strict=strict)
                cpu_frac, tag = s.cpu_frac, s.tag
                freqs[(rank, k)] = state_freq(resolved[rank].lut,
                                              s.freq_mhz, strict=strict)
            else:
                work, cpu_frac, tag = 0.0, 1.0, ""
                freqs[(rank, k)] = resolved[rank].lut.f_max
            extra = [d for d in deps.get((rank, k), ())
                     if d not in serial]
            # drop edges whose producer job does not exist (lenient)
            extra = [d for d in dict.fromkeys(extra)
                     if d[1] < len(spans[d[0]])]
            g.add(rank, k, work, deps=serial + extra,
                  cpu_frac=cpu_frac, tag=tag)
    try:
        g.topological_order()
    except GraphError as e:
        raise TraceError(
            f"reconstructed graph is cyclic ({e}); the trace is "
            f"inconsistent (heavy record loss?)") from e
    return ReconstructedGraph(graph=g, specs=resolved, freqs=freqs,
                              trace=trace, report=report)


# --------------------------------------------------------- round-trip oracle
def canonical_form(graph: JobDependencyGraph):
    """A graph as position-canonical tuples, for isomorphism checks.

    Node ids are replaced by their rank in sorted order and job indices
    by their per-node position (a reconstructed graph is always 0-based
    while e.g. ``listing2_graph`` is 1-based — the structure, not the
    labels, is the contract).  Returns ``[(rank, pos, work, cpu_frac,
    sorted deps), ...]`` sorted by ``(rank, pos)``.
    """
    rank_of = {nid: r for r, nid in enumerate(graph.nodes)}
    pos_of: Dict[JobId, Tuple[int, int]] = {}
    for nid in graph.nodes:
        for p, job in enumerate(graph.node_jobs(nid)):
            pos_of[job.job_id] = (rank_of[nid], p)
    out = []
    for jid in sorted(pos_of, key=lambda j: pos_of[j]):
        job = graph[jid]
        rank, pos = pos_of[jid]
        out.append((rank, pos, job.work, job.cpu_frac,
                    tuple(sorted(pos_of[d] for d in job.deps))))
    return out


def graphs_match(a: JobDependencyGraph, b: JobDependencyGraph,
                 work_rtol: float = 1e-9) -> bool:
    """True when two graphs are isomorphic under the canonical relabeling
    — same shape, same edges, per-job ``work`` and ``cpu_frac`` within
    ``work_rtol`` — the noise-free round-trip acceptance check."""
    ca, cb = canonical_form(a), canonical_form(b)
    if len(ca) != len(cb):
        return False

    def close(x: float, y: float) -> bool:
        return abs(x - y) <= work_rtol * max(1.0, abs(x), abs(y))

    for (ra, pa, wa, fa, da), (rb, pb, wb, fb, db) in zip(ca, cb):
        if (ra, pa, da) != (rb, pb, db):
            return False
        if not (close(wa, wb) and close(fa, fb)):
            return False
    return True
