"""Workload graphs: the paper's running example, an MPI-trace builder, and
NPB-analogue generators (paper §II, §III-C, §VI, §VII-B).

``listing2_graph`` reproduces the paper's 15-job example (Listing 2 /
Fig. 4) with hand-coded edges that match Tables I and II exactly.  The
paper's figure gives only some execution times in prose ("the execution
time of jobs J_,1 ... are 2, 3, and 1", "all J_,2 start after 3 time
units", "total execution time is 19", "the longest execution path starts
with J_{2,1}", "the last jobs to complete are J_{2,5} and J_{3,5}"); the
default times below are reconstructed to satisfy *every* stated fact.

``TraceBuilder`` is the graph-construction analogue of the paper's MPI
wrapper (§VII-A1): callers describe each node's execution as compute
segments ending in communication ops, and the builder derives the
dependency edges — no knowledge of the "program" beyond its comm calls.

Dependency-attachment convention: a receiving op (recv or any collective)
ending segment k of node i makes job (i, k+1) depend on the producing jobs.
The paper draws node 1's lone-recv job (J_{1,3}) with the dependency on the
recv job itself because that job *is* the recv; the hand-coded
``listing2_graph`` keeps the paper's exact edges, while builder-generated
graphs use the uniform next-job convention.

The convention's matching engine — collectives by occurrence order per
(name, group), sends/recvs FIFO per (src, dst, tag) — is factored out as
:func:`match_comm_ops`; the ``*_builder`` variants of the NPB/MoE
generators expose their op scripts unbuilt.

This is the port's own copy of the reference's ``repro.core.workloads``:
every generator gives the same graph for the same seed.
:func:`mixed_members` rebuilds the reference's ``mixed_family`` members.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .graph import Job, JobDependencyGraph, JobId

# ----------------------------------------------------------------- Listing 2
#: Reconstructed nominal execution times for Fig. 4 (see module docstring).
LISTING2_TIMES: Dict[JobId, float] = {
    # J_{node, job}: nodes 1..3 (paper table numbering), jobs 1..5
    (1, 1): 2.0, (2, 1): 3.0, (3, 1): 1.0,   # stated in §IV-B
    (1, 2): 2.0, (2, 2): 2.0, (3, 2): 4.0,
    (1, 3): 1.0, (2, 3): 1.0, (3, 3): 1.0,
    (1, 4): 3.0, (2, 4): 4.0, (3, 4): 2.0,
    (1, 5): 5.0, (2, 5): 7.0, (3, 5): 7.0,
}


def listing2_graph(times: Optional[Mapping[JobId, float]] = None,
                   cpu_frac: float = 1.0) -> JobDependencyGraph:
    """The paper's running example: bcast, ring send/recv, reduce, finalize.

    15 jobs on 3 nodes.  Edges are exactly those of Fig. 4:
      * bcast barrier: every J_{*,2} depends on every J_{*,1};
      * ring: J_{2,3} <- J_{1,2};  J_{3,3} <- J_{2,3};  J_{1,3} <- J_{3,3};
      * reduce barrier: every J_{*,5} depends on every J_{*,4};
      * serial order within each node.
    """
    t = dict(LISTING2_TIMES)
    if times:
        t.update(times)
    g = JobDependencyGraph()
    nodes = (1, 2, 3)
    for i in nodes:
        g.add(i, 1, t[(i, 1)], deps=(), cpu_frac=cpu_frac, tag="bcast")
    for i in nodes:
        deps = [(k, 1) for k in nodes if k != i] + [(i, 1)]
        tag = "send" if i == 1 else "recv"
        g.add(i, 2, t[(i, 2)], deps=deps, cpu_frac=cpu_frac, tag=tag)
    # ring: node1 sends to node2, node2 to node3, node3 to node1
    g.add(2, 3, t[(2, 3)], deps=[(2, 2), (1, 2)], cpu_frac=cpu_frac, tag="send")
    g.add(3, 3, t[(3, 3)], deps=[(3, 2), (2, 3)], cpu_frac=cpu_frac, tag="send")
    g.add(1, 3, t[(1, 3)], deps=[(1, 2), (3, 3)], cpu_frac=cpu_frac, tag="recv")
    for i in nodes:
        g.add(i, 4, t[(i, 4)], deps=[(i, 3)], cpu_frac=cpu_frac, tag="reduce")
    for i in nodes:
        deps = [(k, 4) for k in nodes if k != i] + [(i, 4)]
        g.add(i, 5, t[(i, 5)], deps=deps, cpu_frac=cpu_frac, tag="finalize")
    g.validate()
    return g


def listing2_uniform(work: float = 10.0) -> JobDependencyGraph:
    """§VI homogeneous variant: same graph, every job the same size."""
    return listing2_graph({jid: work for jid in LISTING2_TIMES})


def listing2_random(stddev: float, mean: float = 10.0,
                    seed: int = 0) -> JobDependencyGraph:
    """Fig. 9 variant: same structure, times ~ N(mean, stddev), floored."""
    rng = random.Random(seed)
    times = {jid: max(0.5, rng.gauss(mean, stddev))
             for jid in LISTING2_TIMES}
    return listing2_graph(times)


# ------------------------------------------------------------- TraceBuilder
@dataclass
class Segment:
    """One compute block of a per-node trace script, optionally ended by a
    communication op: ``("coll", name, group)`` | ``("send", dst[, tag])``
    | ``("recv", src[, tag])``."""

    work: float
    cpu_frac: float
    op: Optional[Tuple] = None


@dataclass
class MatchReport:
    """Outcome of :func:`match_comm_ops` — all zeros on a clean match.

    In lenient mode (``strict=False``, the trace-ingestion path) unmatched
    sends/recvs and collective occurrences with missing members are
    *dropped* (their dependency edges are simply not emitted) and counted
    here instead of raising.
    """

    dropped_sends: int = 0
    dropped_recvs: int = 0
    dropped_members: int = 0

    @property
    def clean(self) -> bool:
        """True when every op found its match."""
        return not (self.dropped_sends or self.dropped_recvs
                    or self.dropped_members)


#: One op occurrence for :func:`match_comm_ops`: ``(op, producer, child)``
#: where ``producer`` is the job that completed immediately before the op
#: on that node (``None`` if the op precedes every job) and ``child`` the
#: job started immediately after it (``None`` past the last job).
OpSite = Tuple[Tuple, Optional[JobId], Optional[JobId]]


def match_comm_ops(sites: Mapping[int, Sequence[OpSite]],
                   strict: bool = True
                   ) -> Tuple[Dict[JobId, List[JobId]], MatchReport]:
    """THE dependency-attachment convention, as a reusable matching engine.

    ``sites`` maps each node to its ordered communication-op occurrences.
    Collectives match by occurrence order within the same ``(name,
    group)``; sends/recvs pair FIFO per ``(src, dst, tag)`` channel (ops
    without an explicit tag use ``""``).  Every receiving op (recv or
    collective) makes its *child* job depend on the matched *producer*
    jobs — the convention :class:`TraceBuilder` has always compiled and
    the trace-ingestion pass shares.

    Returns ``(deps, report)``: extra cross-node dependency edges keyed by
    child job, plus the :class:`MatchReport`.  ``strict=True`` raises
    ``ValueError`` on mismatched collectives or unmatched sends/recvs;
    ``strict=False`` drops them (noisy-trace ingestion).
    """
    # member: (node, producer, child) per collective occurrence
    coll_seen: Dict[Tuple, List[List[Tuple]]] = {}
    sends: Dict[Tuple[int, int, str], List[Optional[JobId]]] = {}
    recvs: Dict[Tuple[int, int, str], List[Optional[JobId]]] = {}
    for node in sorted(sites):
        coll_count: Dict[Tuple, int] = {}
        for op, producer, child in sites[node]:
            kind = op[0]
            if kind == "coll":
                _, name, group = op
                key = (name, tuple(sorted(group)))
                idx = coll_count.get(key, 0)
                coll_count[key] = idx + 1
                coll_seen.setdefault(key, [])
                while len(coll_seen[key]) <= idx:
                    coll_seen[key].append([])
                coll_seen[key][idx].append((node, producer, child))
            elif kind == "send":
                tag = op[2] if len(op) > 2 else ""
                sends.setdefault((node, op[1], tag), []).append(producer)
            elif kind == "recv":
                tag = op[2] if len(op) > 2 else ""
                recvs.setdefault((op[1], node, tag), []).append(child)
            else:
                raise ValueError(f"unknown comm op kind {kind!r}")

    deps: Dict[JobId, List[JobId]] = {}
    report = MatchReport()

    def add_dep(child: Optional[JobId], dep: Optional[JobId]) -> None:
        if child is not None and dep is not None:
            deps.setdefault(child, []).append(dep)

    for key, occurrences in coll_seen.items():
        _, group = key
        for members in occurrences:
            nodes = {node for node, _, _ in members}
            if nodes != set(group):
                if strict:
                    raise ValueError(
                        f"collective {key} mismatched across nodes: "
                        f"{sorted(nodes)}")
                report.dropped_members += len(set(group) - nodes)
            for node, _, child in members:
                for other, producer, _ in members:
                    if other != node:
                        add_dep(child, producer)

    for channel in sorted(set(sends) | set(recvs)):
        src, dst, _tag = channel
        producers = sends.get(channel, [])
        children = recvs.get(channel, [])
        if len(producers) != len(children) and strict:
            raise ValueError(
                f"unmatched send/recv {src}->{dst}: "
                f"{len(producers)} sends, {len(children)} recvs")
        n = min(len(producers), len(children))
        report.dropped_sends += len(producers) - n
        report.dropped_recvs += len(children) - n
        for producer, child in zip(producers, children):
            add_dep(child, producer)
    return deps, report


class TraceBuilder:
    """Builds a job dependency graph from per-node comm traces (§VII-A1).

    Usage::

        tb = TraceBuilder()
        tb.compute(node, work).allreduce(group)   # via per-node handles
    """

    def __init__(self, n_nodes: int):
        self.n = n_nodes
        self._traces: List[List[Segment]] = [[] for _ in range(n_nodes)]

    # trace-recording API ---------------------------------------------------
    def compute(self, node: int, work: float, cpu_frac: float = 1.0) -> None:
        """Append a compute segment (a future job) to a node's trace."""
        self._traces[node].append(Segment(work, cpu_frac))

    def _end_with(self, node: int, op: Tuple) -> None:
        if not self._traces[node] or self._traces[node][-1].op is not None:
            # an op with no preceding compute gets an epsilon job (e.g. a
            # bare recv like the paper's J_{1,3})
            self._traces[node].append(Segment(0.0, 1.0))
        self._traces[node][-1].op = op

    def collective(self, name: str, group: Sequence[int]) -> None:
        """All nodes in ``group`` hit collective ``name`` (in trace order)."""
        for node in group:
            self.join_collective(node, name, group)

    def join_collective(self, node: int, name: str,
                        group: Sequence[int]) -> None:
        """One node's participation in a collective — the per-rank form a
        recorded trace arrives in (ranks log their own enter events)."""
        self._end_with(node, ("coll", name, tuple(sorted(group))))

    def send(self, src: int, dst: int) -> None:
        self._end_with(src, ("send", dst))

    def recv(self, dst: int, src: int) -> None:
        self._end_with(dst, ("recv", src))

    def script(self) -> List[List[Segment]]:
        """The per-node segment script recorded so far (the live lists —
        callers must treat them as read-only).  This is what the synthetic
        trace recorder serialises."""
        return self._traces

    # compilation -----------------------------------------------------------
    def build(self) -> JobDependencyGraph:
        g = JobDependencyGraph()
        # Give every trace a terminal segment so trailing ops have a
        # successor job to carry their dependency.
        for node, trace in enumerate(self._traces):
            if trace and trace[-1].op is not None:
                trace.append(Segment(0.0, 1.0))

        # Pass 1: create jobs with serial deps.
        for node, trace in enumerate(self._traces):
            for k, seg in enumerate(trace):
                deps = [(node, k - 1)] if k > 0 else []
                tag = seg.op[0] if seg.op else ""
                if seg.op and seg.op[0] == "coll":
                    tag = seg.op[1]
                g.add(node, k, seg.work, deps=deps, cpu_frac=seg.cpu_frac,
                      tag=tag)

        # Pass 2: cross-node deps through the shared matching engine — an
        # op ending segment k produces from (node, k) and attaches the
        # dependency to (node, k + 1).
        sites: Dict[int, List[OpSite]] = {
            node: [(seg.op, (node, k), (node, k + 1))
                   for k, seg in enumerate(trace) if seg.op is not None]
            for node, trace in enumerate(self._traces)}
        extra, _report = match_comm_ops(sites, strict=True)

        # Rebuild with merged deps (jobs are frozen dataclasses).
        g2 = JobDependencyGraph()
        for jid, job in g.jobs.items():
            deps = list(job.deps) + [d for d in extra.get(jid, [])
                                     if d not in job.deps]
            g2.add(job.node, job.index, job.work, deps=deps,
                   cpu_frac=job.cpu_frac, tag=job.tag)
        g2.topological_order()
        return g2


# ------------------------------------------------------------ NPB analogues
#: NPB-style problem classes: work multiplier per class.
NPB_CLASSES = {"A": 1.0, "B": 4.0, "C": 16.0}


def _skew(rng: random.Random, spread: float) -> float:
    return rng.uniform(1.0 - spread, 1.0 + spread)


def is_builder(n_nodes: int, klass: str = "A", iterations: int = 4,
               seed: int = 1) -> TraceBuilder:
    """The :func:`is_like` op script as an unbuilt :class:`TraceBuilder`
    (the form the synthetic trace recorder wraps)."""
    scale = NPB_CLASSES[klass]
    rng = random.Random(seed)
    tb = TraceBuilder(n_nodes)
    group = list(range(n_nodes))
    for _ in range(iterations):
        for node in range(n_nodes):
            tb.compute(node, 6.0 * scale * _skew(rng, 0.35), cpu_frac=0.45)
        tb.collective("allreduce", group)
        for node in range(n_nodes):
            tb.compute(node, 3.0 * scale * _skew(rng, 0.35), cpu_frac=0.40)
        tb.collective("alltoall", group)
        for node in range(n_nodes):
            tb.compute(node, 2.0 * scale * _skew(rng, 0.50), cpu_frac=0.40)
        tb.collective("alltoallv", group)
        for node in range(n_nodes):
            tb.compute(node, 4.0 * scale * _skew(rng, 0.35), cpu_frac=0.50)
    tb.collective("barrier", group)
    return tb


def is_like(n_nodes: int, klass: str = "A", iterations: int = 4,
            seed: int = 1) -> JobDependencyGraph:
    """Integer-Sort analogue (§VII-B): memory-intensive, alltoall-heavy.

    Each iteration mirrors NPB IS ``rank()`` (paper Listing 1): bucket
    count (compute) -> Allreduce -> key redistribution (compute) ->
    Alltoall -> Alltoallv -> local ranking (compute).  cpu_frac is low
    (memory-bound), so frequency boosts help moderately — the paper sees
    modest IS speedups that improve with class size.
    """
    return is_builder(n_nodes, klass, iterations, seed).build()


def ep_builder(n_nodes: int, klass: str = "A",
               seed: int = 2) -> TraceBuilder:
    """The :func:`ep_like` op script as an unbuilt :class:`TraceBuilder`."""
    scale = NPB_CLASSES[klass]
    rng = random.Random(seed)
    tb = TraceBuilder(n_nodes)
    group = list(range(n_nodes))
    for node in range(n_nodes):
        tb.compute(node, 60.0 * scale * _skew(rng, 0.45), cpu_frac=0.95)
    tb.collective("allreduce", group)
    for _ in range(3):
        for node in range(n_nodes):
            tb.compute(node, 1.0 * scale * _skew(rng, 0.20), cpu_frac=0.90)
        tb.collective("allreduce", group)
    return tb


def ep_like(n_nodes: int, klass: str = "A", seed: int = 2) -> JobDependencyGraph:
    """Embarrassingly-Parallel analogue: one huge CPU-bound block + reduces.

    The paper's best case (heuristic 2.25x, ILP 2.78x at class C): long
    independent compute with large cross-node skew means early finishers
    idle for a long time unless their power moves to the stragglers.
    """
    return ep_builder(n_nodes, klass, seed).build()


def cg_builder(n_nodes: int, klass: str = "A", iterations: int = 15,
               seed: int = 3) -> TraceBuilder:
    """The :func:`cg_like` op script as an unbuilt :class:`TraceBuilder`."""
    scale = NPB_CLASSES[klass]
    rng = random.Random(seed)
    tb = TraceBuilder(n_nodes)
    group = list(range(n_nodes))
    iters = int(iterations * math.sqrt(scale))
    for _ in range(iters):
        for node in range(n_nodes):
            tb.compute(node, 0.8 * _skew(rng, 0.30), cpu_frac=0.65)
        # ring halo exchange
        for node in range(n_nodes):
            tb.send(node, (node + 1) % n_nodes)
        for node in range(n_nodes):
            tb.recv(node, (node - 1) % n_nodes)
        for node in range(n_nodes):
            tb.compute(node, 0.5 * _skew(rng, 0.30), cpu_frac=0.65)
        tb.collective("allreduce", group)
    return tb


def cg_like(n_nodes: int, klass: str = "A", iterations: int = 15,
            seed: int = 3) -> JobDependencyGraph:
    """Conjugate-Gradient analogue: communication-intensive halo exchanges.

    Many short compute blocks separated by neighbour send/recv and a
    reduction per iteration.  Jobs are small relative to controller RTT, so
    the debounced heuristic barely acts (paper Fig. 13: speedup ~= 1.0,
    worst observed 0.98).
    """
    return cg_builder(n_nodes, klass, iterations, seed).build()


def pipeline_graph(stages: int, microbatches: int, fwd_work: float = 4.0,
                   bwd_work: float = 8.0, skew: float = 0.0,
                   seed: int = 4) -> JobDependencyGraph:
    """GPipe-style pipeline schedule as a dependency graph.

    Node = pipeline stage.  Forward microbatch m at stage s depends on
    (s-1, m) fwd and the stage's previous job; backward reversed.  The
    warm-up/drain bubbles are exactly the paper's "blackouts": with no
    power redistribution the bubble stages idle at p_o while the busy
    stages are capped — redistribution shortens the critical path.
    """
    rng = random.Random(seed)
    g = JobDependencyGraph()
    idx = [0] * stages
    fwd_id: Dict[Tuple[int, int], JobId] = {}
    bwd_id: Dict[Tuple[int, int], JobId] = {}

    def push(stage: int, work: float, deps: List[JobId], tag: str) -> JobId:
        k = idx[stage]
        idx[stage] += 1
        if k > 0:
            deps = deps + [(stage, k - 1)]
        g.add(stage, k, work, deps=deps, cpu_frac=0.9, tag=tag)
        return (stage, k)

    for m in range(microbatches):
        for s in range(stages):
            deps = [fwd_id[(s - 1, m)]] if s > 0 else []
            w = fwd_work * (1.0 + rng.uniform(-skew, skew))
            fwd_id[(s, m)] = push(s, w, deps, f"fwd{m}")
    for m in range(microbatches):
        for s in reversed(range(stages)):
            deps = [bwd_id[(s + 1, m)]] if s < stages - 1 else \
                [fwd_id[(stages - 1, m)]]
            w = bwd_work * (1.0 + rng.uniform(-skew, skew))
            bwd_id[(s, m)] = push(s, w, deps, f"bwd{m}")
    # gradient all-reduce: every stage's final job joins a barrier
    final = [(s, idx[s] - 1) for s in range(stages)]
    for s in range(stages):
        deps = [f for f in final if f[0] != s] + [(s, idx[s] - 1)]
        g.add(s, idx[s], fwd_work * 0.25, deps=deps, cpu_frac=0.3,
              tag="allreduce")
        idx[s] += 1
    g.topological_order()
    return g


def layered_dag(n_nodes: int, layers: int = 4, fan: int = 2,
                work: float = 6.0, skew: float = 0.4,
                seed: int = 6) -> JobDependencyGraph:
    """Random layered DAG: ``layers`` jobs per node, each depending on
    its predecessor plus up to ``fan`` random previous-layer jobs on
    *other* nodes.

    This is the shape family the scenario generators use to fill the
    space between the hand-built workloads: cross-node skew (``skew``,
    uniform around ``work``) plus random cross-layer edges gives the
    blocked-node patterns power redistribution exploits, at arbitrary
    (N, J) sizes.
    """
    rng = random.Random(seed)
    g = JobDependencyGraph()
    for k in range(layers):
        for i in range(n_nodes):
            deps: List[JobId] = [(i, k - 1)] if k > 0 else []
            if k > 0:
                others = [j for j in range(n_nodes) if j != i]
                rng.shuffle(others)
                deps += [(j, k - 1) for j in others[:rng.randint(0, fan)]]
            w = work * (1.0 + rng.uniform(-skew, skew))
            g.add(i, k, w, deps=deps,
                  cpu_frac=rng.uniform(0.5, 0.95), tag=f"layer{k}")
    g.topological_order()
    return g


def fork_join_graph(n_nodes: int, stages: int = 3, work: float = 8.0,
                    skew: float = 0.5, seed: int = 7) -> JobDependencyGraph:
    """Fork-join stages: node 0 forks, every node computes a skewed
    block, node 0 joins — the classic master/worker shape whose join
    barriers idle the fast workers (prime redistribution territory).
    """
    rng = random.Random(seed)
    g = JobDependencyGraph()
    idx = [0] * n_nodes

    def push(node: int, w: float, deps: List[JobId], tag: str) -> JobId:
        k = idx[node]
        idx[node] += 1
        if k > 0:   # serial order, deduped (the fork IS node 0's prior job)
            deps = list(dict.fromkeys(deps + [(node, k - 1)]))
        g.add(node, k, w, deps=deps, cpu_frac=0.85, tag=tag)
        return (node, k)

    join: Optional[JobId] = None
    for s in range(stages):
        fork = push(0, 0.5, [join] if join else [], f"fork{s}")
        blocks = [push(i, work * (1.0 + rng.uniform(-skew, skew)),
                       [fork], f"work{s}") for i in range(n_nodes)]
        join = push(0, 0.5, blocks, f"join{s}")
    g.topological_order()
    return g


def moe_step_builder(n_nodes: int, layers: int = 4,
                     hot_factor: float = 2.5,
                     seed: int = 5) -> TraceBuilder:
    """The :func:`moe_step_graph` op script as an unbuilt
    :class:`TraceBuilder`."""
    rng = random.Random(seed)
    tb = TraceBuilder(n_nodes)
    group = list(range(n_nodes))
    for layer in range(layers):
        hot = rng.randrange(n_nodes)
        for node in range(n_nodes):
            tb.compute(node, 3.0 * _skew(rng, 0.05), cpu_frac=0.85)
        tb.collective("alltoall", group)
        for node in range(n_nodes):
            w = 4.0 * (hot_factor if node == hot else 1.0) * _skew(rng, 0.10)
            tb.compute(node, w, cpu_frac=0.9)
        tb.collective("alltoall", group)
    for node in range(n_nodes):
        tb.compute(node, 2.0, cpu_frac=0.5)
    tb.collective("allreduce", group)
    return tb


def moe_step_graph(n_nodes: int, layers: int = 4, hot_factor: float = 2.5,
                   seed: int = 5) -> JobDependencyGraph:
    """An MoE training step: per-layer alltoall with hot-expert imbalance.

    Node = expert-parallel rank.  Each layer: attention compute (balanced)
    -> dispatch alltoall -> expert FFN compute (imbalanced: the rank
    holding the hot expert gets ``hot_factor`` more work) -> combine
    alltoall.  Final DP gradient allreduce.  This is the LM-workload face
    of the paper's technique (see DESIGN.md §4).
    """
    return moe_step_builder(n_nodes, layers, hot_factor, seed).build()


# ----------------------------------------------------------- mixed family
def mixed_members(seed: int = 0, with_bound_steps: bool = True
                  ) -> List[Tuple[str, JobDependencyGraph, tuple,
                                  Tuple[Tuple[float, float], ...]]]:
    """The six members of the reference's ``mixed_family(seed)`` as
    ``(name, graph, specs, bound_steps)``: Listing-2, a random Listing-2,
    an NPB-IS analogue on a mixed cluster, a layered DAG, a fork-join
    and an MoE step.  ``bound_steps`` holds ``(time_s, fraction)`` pairs
    relative to each scenario's own bound (the cap drops to 60% at 8 s
    and recovers at 20 s on two members).  Same seed, same graphs."""
    from .power import heterogeneous_cluster, homogeneous_cluster

    rng = random.Random(seed)
    steps = ((8.0, 0.6), (20.0, 1.0)) if with_bound_steps else ()
    return [
        ("l2", listing2_graph(), tuple(homogeneous_cluster(3)), ()),
        ("l2r", listing2_random(3.0, seed=rng.randrange(1 << 16)),
         tuple(homogeneous_cluster(3)), steps),
        ("is4", is_like(4, "A", seed=rng.randrange(1 << 16)),
         tuple(heterogeneous_cluster(4, seed=seed)), ()),
        ("layered5", layered_dag(5, layers=4, seed=rng.randrange(1 << 16)),
         tuple(homogeneous_cluster(5)), steps),
        ("forkjoin4", fork_join_graph(4, stages=3,
                                      seed=rng.randrange(1 << 16)),
         tuple(homogeneous_cluster(4)), ()),
        ("moe6", moe_step_graph(6, layers=3, seed=rng.randrange(1 << 16)),
         tuple(homogeneous_cluster(6)), ()),
    ]
