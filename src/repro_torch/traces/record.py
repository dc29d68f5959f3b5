"""Synthetic trace recorders: ground-truth traces from the workload zoo.

The paper records real MPI executions through a wrapper library; this
module is that wrapper's synthetic twin.  It replays a workload graph at
chosen DVFS states (nominal by default, per-span random states to
exercise calibration), stamps every compute span and communication op
with wall-clock timestamps, and emits a schema-v1
:class:`~repro_torch.traces.schema.Trace`.  Because the workload is known, the
emitted trace has a ground-truth graph — the ingest↔reconstruct
round-trip oracle the tests and benchmarks rely on.

Two recorders cover the whole zoo:

* :func:`record_builder` wraps an (unbuilt) :class:`TraceBuilder` script
  — the NPB analogues and MoE steps — and records the *actual* ops,
  collectives included.
* :func:`record_graph` records any :class:`JobDependencyGraph` (the
  hand-coded Listing-2 example, random layered DAGs, fork/join,
  pipelines) by synthesising a pairwise ``send``/``recv`` for every
  cross-node edge — dependency-equivalent to whatever op produced the
  edge.  Redundant same-node edges (already implied by each node's
  serial order) have no trace representation and are skipped.

:func:`with_noise` degrades a clean recording the way real logs degrade:
per-timestamp jitter, per-rank clock skew, and dropped records.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.graph import JobDependencyGraph, JobId
from repro_torch.core.power import NodeSpec, job_time
from repro_torch.core.workloads import TraceBuilder

from .calibrate import rank_info
from .schema import (COLLECTIVE_KINDS, OpRecord, SpanRecord, Trace,
                     TraceRecord)

#: Schema kind used for collectives whose name is not a schema kind
#: (e.g. HLO-derived custom collectives); the original name rides in the
#: op's ``tag`` so occurrence matching still keys on it.
_COLL_FALLBACK = "barrier"

#: Frequency plans: how the synthetic cluster "ran" the workload.
#: ``nominal`` = every span at f_nom (wall clock == nominal makespan);
#: ``random`` = every span at a random real LUT state (exercises the
#: duration→work calibration path end-to-end).
FREQ_PLANS = ("nominal", "random")


def _freq_plan(freqs: str, specs: Sequence[NodeSpec],
               rng: random.Random) -> Callable[[int], float]:
    """rank -> a frequency for the next span on that rank."""
    if freqs == "nominal":
        return lambda rank: specs[rank].lut.f_max
    if freqs == "random":
        return lambda rank: rng.choice(
            [s.freq_mhz for s in specs[rank].lut.states])
    raise ValueError(f"unknown freq plan {freqs!r} (known: {FREQ_PLANS})")


def _timed_replay(graph: JobDependencyGraph, specs: Sequence[NodeSpec],
                  freqs: str, rng: random.Random):
    """Assign a frequency per job and replay the graph at it.

    Returns ``(freq, start, comp)`` keyed by job id — the wall-clock
    schedule the recorded timestamps are read off.
    """
    nodes = graph.nodes
    rank_of = {nid: r for r, nid in enumerate(nodes)}
    plan = _freq_plan(freqs, specs, rng)
    freq: Dict[JobId, float] = {}
    for nid in nodes:
        for job in graph.node_jobs(nid):
            freq[job.job_id] = plan(rank_of[nid])
    dur = {jid: job_time(graph[jid], freq[jid],
                         specs[rank_of[jid[0]]].lut.f_max,
                         specs[rank_of[jid[0]]].speed)
           for jid in freq}
    start, comp = graph.completion_times(lambda j: dur[j.job_id])
    return freq, start, comp


def _base_meta(freqs: str, seed: int, recorder: str,
               meta: Optional[Mapping]) -> Dict[str, object]:
    out = {"recorder": recorder, "freqs": freqs, "seed": seed}
    if meta:
        out.update(meta)
    return out


def record_builder(tb: TraceBuilder, specs: Sequence[NodeSpec],
                   freqs: str = "nominal", seed: int = 0,
                   meta: Optional[Mapping] = None) -> Trace:
    """Record a :class:`TraceBuilder` op script (see module docstring).

    The builder is compiled (``tb.build()``) to obtain the ground-truth
    schedule; its script — including the epsilon segments the build pass
    adds — is then serialised one span per segment with each segment's
    op attached at the time it happened.
    """
    graph = tb.build()
    script = tb.script()
    if len(specs) != len(script):
        raise ValueError(f"{len(specs)} NodeSpecs for a "
                         f"{len(script)}-node builder")
    rng = random.Random(seed)
    freq, start, comp = _timed_replay(graph, specs, freqs, rng)

    events: List[TraceRecord] = []
    for node, segments in enumerate(script):
        seq = 0
        for k, seg in enumerate(segments):
            jid = (node, k)
            events.append(SpanRecord(
                rank=node, seq=seq, t0=start[jid], t1=comp[jid],
                freq_mhz=freq[jid], cpu_frac=seg.cpu_frac,
                tag=graph[jid].tag))
            seq += 1
            if seg.op is None:
                continue
            kind = seg.op[0]
            if kind == "coll":
                _, name, group = seg.op
                op_kind, tag = ((name, "") if name in COLLECTIVE_KINDS
                                else (_COLL_FALLBACK, name))
                events.append(OpRecord(rank=node, seq=seq, t=comp[jid],
                                       kind=op_kind, group=tuple(group),
                                       tag=tag))
            elif kind == "send":
                events.append(OpRecord(rank=node, seq=seq, t=comp[jid],
                                       kind="send", peer=seg.op[1]))
            else:  # recv completes when the dependent job may start
                events.append(OpRecord(rank=node, seq=seq,
                                       t=start[(node, k + 1)],
                                       kind="recv", peer=seg.op[1]))
            seq += 1
    trace = Trace(ranks=len(script), cluster=tuple(rank_info(specs)),
                  events=events,
                  meta=_base_meta(freqs, seed, "builder", meta))
    return trace.validate()


def record_graph(graph: JobDependencyGraph, specs: Sequence[NodeSpec],
                 freqs: str = "nominal", seed: int = 0,
                 meta: Optional[Mapping] = None) -> Trace:
    """Record any dependency graph as a pairwise send/recv trace.

    Every cross-node edge ``(j, m) -> (i, k)`` becomes a ``send`` on
    rank(j) at ``(j, m)``'s completion and a ``recv`` on rank(i) just
    before ``(i, k)`` starts — the trace a pointwise-messaging program
    with the same dependency structure would have produced.  Channels
    whose FIFO order would pair edges differently from the original
    graph get per-edge message tags (MPI tags exist for a reason).
    """
    nodes = graph.nodes
    if len(specs) != len(nodes):
        raise ValueError(f"{len(specs)} NodeSpecs for a "
                         f"{len(nodes)}-node graph")
    rank_of = {nid: r for r, nid in enumerate(nodes)}
    pos_of: Dict[JobId, int] = {}
    for nid in nodes:
        for p, job in enumerate(graph.node_jobs(nid)):
            pos_of[job.job_id] = p
    rng = random.Random(seed)
    freq, start, comp = _timed_replay(graph, specs, freqs, rng)

    # Cross-node edges per channel, as (producer, child) job-id pairs.
    channels: Dict[Tuple[int, int], List[Tuple[JobId, JobId]]] = {}
    for jid in graph.topological_order():
        for dep in graph[jid].deps:
            if dep[0] == jid[0]:
                continue  # serial-implied; not representable in a trace
            channels.setdefault((rank_of[dep[0]], rank_of[jid[0]]),
                                []).append((dep, jid))

    # A channel is FIFO-consistent when pairing sends in producer order
    # with recvs in child order reproduces the original edges; otherwise
    # give every edge on the channel its own message tag.
    tagged: Dict[Tuple[int, int], bool] = {}
    for chan, edges in channels.items():
        by_send = sorted(edges, key=lambda e: (pos_of[e[0]], pos_of[e[1]]))
        by_recv = sorted(edges, key=lambda e: (pos_of[e[1]], pos_of[e[0]]))
        tagged[chan] = by_send != by_recv

    def edge_tag(src_rank: int, dst_rank: int, producer: JobId,
                 child: JobId) -> str:
        if not tagged.get((src_rank, dst_rank)):
            return ""
        return f"m{pos_of[producer]}k{pos_of[child]}"

    # producer job -> its outgoing (child, dst rank) sends
    sends_of: Dict[JobId, List[Tuple[JobId, int]]] = {}
    for (_srank, drank), edges in channels.items():
        for producer, child in edges:
            sends_of.setdefault(producer, []).append((child, drank))

    events: List[TraceRecord] = []
    for nid in nodes:
        rank = rank_of[nid]
        seq = 0
        for job in graph.node_jobs(nid):
            jid = job.job_id
            # recvs completing just before this job starts
            for dep in sorted(job.deps,
                              key=lambda d: (rank_of[d[0]], pos_of[d])):
                if dep[0] == nid:
                    continue
                src = rank_of[dep[0]]
                events.append(OpRecord(
                    rank=rank, seq=seq, t=start[jid], kind="recv",
                    peer=src, tag=edge_tag(src, rank, dep, jid)))
                seq += 1
            events.append(SpanRecord(
                rank=rank, seq=seq, t0=start[jid], t1=comp[jid],
                freq_mhz=freq[jid], cpu_frac=job.cpu_frac, tag=job.tag))
            seq += 1
            # sends leaving this job's completion
            for child, dst in sorted(
                    sends_of.get(jid, ()),
                    key=lambda e: (e[1], pos_of[e[0]])):
                events.append(OpRecord(
                    rank=rank, seq=seq, t=comp[jid], kind="send",
                    peer=dst, tag=edge_tag(rank, dst, jid, child)))
                seq += 1
    trace = Trace(ranks=len(nodes), cluster=tuple(rank_info(specs)),
                  events=events,
                  meta=_base_meta(freqs, seed, "graph", meta))
    return trace.validate()


def with_noise(trace: Trace, jitter_s: float = 0.005,
               skew_s: float = 0.02, drop: float = 0.0,
               seed: int = 0) -> Trace:
    """A degraded copy of a recording, the way real logs degrade.

    ``jitter_s`` — gaussian noise (stddev, seconds) added to every
    timestamp independently; ``skew_s`` — a per-rank clock offset drawn
    uniformly from ``[-skew_s, +skew_s]``; ``drop`` — probability that
    any non-header record is simply missing from the log.  ``seq``
    numbers are preserved (a wrapper's per-rank log order survives even
    when its clock does not), which is what keeps reconstruction
    structurally exact under pure jitter/skew — only *calibration* and
    the wall clock degrade.  Dropped records do change the reconstructed
    graph; load the result with ``strict=False`` and reconstruct in
    lenient mode.
    """
    rng = random.Random(seed)
    skew = {r: rng.uniform(-skew_s, skew_s) for r in range(trace.ranks)}
    dropped = 0
    events: List[TraceRecord] = []
    for e in sorted(trace.events, key=lambda e: (e.rank, e.seq)):
        if drop > 0.0 and rng.random() < drop:
            dropped += 1
            continue
        off = skew[e.rank]
        if isinstance(e, SpanRecord):
            t0 = max(0.0, e.t0 + off + rng.gauss(0.0, jitter_s))
            t1 = e.t1 + off + rng.gauss(0.0, jitter_s)
            events.append(SpanRecord(rank=e.rank, seq=e.seq, t0=t0,
                                     t1=max(t0, t1), freq_mhz=e.freq_mhz,
                                     cpu_frac=e.cpu_frac, tag=e.tag))
        else:
            t = max(0.0, e.t + off + rng.gauss(0.0, jitter_s))
            events.append(OpRecord(rank=e.rank, seq=e.seq, t=t,
                                   kind=e.kind, peer=e.peer,
                                   group=e.group, tag=e.tag, req=e.req))
    meta = dict(trace.meta)
    meta["noise"] = {"jitter_s": jitter_s, "skew_s": skew_s,
                     "drop": drop, "seed": seed, "dropped": dropped}
    noisy = Trace(ranks=trace.ranks, cluster=trace.cluster,
                  events=events, meta=meta, version=trace.version)
    return noisy.validate(strict=False)


# ------------------------------------------------------------- workload zoo
def record_workload(workload: str, n_nodes: int = 4, klass: str = "A",
                    seed: int = 0, hetero: bool = False,
                    freqs: str = "nominal") -> Trace:
    """One-call recording of a named workload (the CLI/bench entry).

    ``workload`` is one of ``listing2``, ``npb-is``, ``npb-ep``,
    ``npb-cg``, ``moe``, ``layered``, ``forkjoin``, ``pipeline``.
    """
    from repro_torch.core.power import (heterogeneous_cluster,
                                        homogeneous_cluster)
    from repro_torch.core.workloads import (cg_builder, ep_builder,
                                            fork_join_graph, is_builder,
                                            layered_dag, listing2_graph,
                                            moe_step_builder,
                                            pipeline_graph)

    def cluster(n: int) -> List[NodeSpec]:
        return (heterogeneous_cluster(n, seed=seed) if hetero
                else homogeneous_cluster(n))

    meta = {"workload": workload}
    if workload.startswith("npb-"):
        meta["klass"] = klass
    builders = {
        "npb-is": lambda: is_builder(n_nodes, klass, seed=seed),
        "npb-ep": lambda: ep_builder(n_nodes, klass, seed=seed),
        "npb-cg": lambda: cg_builder(n_nodes, klass, seed=seed),
        "moe": lambda: moe_step_builder(n_nodes, seed=seed),
    }
    graphs = {
        "listing2": lambda: listing2_graph(),
        "layered": lambda: layered_dag(n_nodes, seed=seed),
        "forkjoin": lambda: fork_join_graph(n_nodes, seed=seed),
        "pipeline": lambda: pipeline_graph(n_nodes, 4, seed=seed),
    }
    if workload in builders:
        tb = builders[workload]()
        return record_builder(tb, cluster(tb.n), freqs=freqs, seed=seed,
                              meta=meta)
    if workload in graphs:
        g = graphs[workload]()
        return record_graph(g, cluster(len(g.nodes)), freqs=freqs,
                            seed=seed, meta=meta)
    raise ValueError(f"unknown workload {workload!r} (known: "
                     f"{sorted(builders) + sorted(graphs)})")
