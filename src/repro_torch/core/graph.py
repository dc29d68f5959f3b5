"""Job dependency graph (paper §III, §IV-A).

A parallel program is modelled as one sequence of *jobs* per node.  A job is
a block of execution that, once started, completes without communication.
Dependencies (the paper's ``theta``) encode both serial order within a node
and cross-node synchronisation (collectives, send/recv pairs).

This module implements:
  * :class:`Job` / :class:`JobDependencyGraph` — the DAG itself,
  * max-depth ``delta`` (Definition 4) and depth ranges ``Delta``
    (Definition 5) used by the Job Concurrency Optimization algorithm,
  * completion-time propagation and the critical path, whose length is the
    total execution time ``E_D`` (Definition 3),
  * text (de)serialisation — the paper's simulator is "initialized with a
    text file detailing the job dependency graph".

The implementation is pure Python (no networkx): graphs here are small
(10^2..10^5 jobs) and the traversals are the O(E) ones the paper describes.
"""

from __future__ import annotations

import io
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, List, Mapping, Sequence, Tuple

JobId = Tuple[int, int]  # (node index i, job index j) — the paper's J_{i,j}


@dataclass(frozen=True)
class Job:
    """One block of uninterrupted execution on one node (paper §III).

    ``work`` is the job's size in *work units*: execution time at the node's
    nominal frequency.  ``cpu_frac`` is the fraction of that time that scales
    with CPU frequency (EP-like jobs ~1.0, memory-bound IS-like jobs lower);
    the remainder is frequency-invariant (memory/IO), matching the paper's
    observation that CPU-bound programs benefit most (§VII-C).
    """

    node: int
    index: int
    work: float
    cpu_frac: float = 1.0
    deps: Tuple[JobId, ...] = ()
    tag: str = ""  # e.g. the collective that *ends* this job ("allreduce")

    @property
    def job_id(self) -> JobId:
        return (self.node, self.index)


class GraphError(ValueError):
    pass


class JobDependencyGraph:
    """Directed acyclic graph over jobs (Definition 1)."""

    def __init__(self, jobs: Iterable[Job] = ()):
        self._jobs: Dict[JobId, Job] = {}
        for job in jobs:
            self.add_job(job)
        self._topo_cache: List[JobId] | None = None

    # ------------------------------------------------------------------ build
    def add_job(self, job: Job) -> None:
        if job.job_id in self._jobs:
            raise GraphError(f"duplicate job {job.job_id}")
        if job.work < 0:
            raise GraphError(f"negative work for {job.job_id}")
        if not (0.0 <= job.cpu_frac <= 1.0):
            raise GraphError(f"cpu_frac out of [0,1] for {job.job_id}")
        self._jobs[job.job_id] = job
        self._topo_cache = None

    def add(self, node: int, index: int, work: float, deps=(), cpu_frac=1.0,
            tag: str = "") -> Job:
        job = Job(node=node, index=index, work=float(work),
                  cpu_frac=float(cpu_frac),
                  deps=tuple(tuple(d) for d in deps), tag=tag)
        self.add_job(job)
        return job

    # ------------------------------------------------------------ accessors
    def __len__(self) -> int:
        return len(self._jobs)

    def __contains__(self, jid: JobId) -> bool:
        return tuple(jid) in self._jobs

    def __getitem__(self, jid: JobId) -> Job:
        return self._jobs[tuple(jid)]

    @property
    def jobs(self) -> Mapping[JobId, Job]:
        return self._jobs

    @property
    def nodes(self) -> List[int]:
        return sorted({j.node for j in self._jobs.values()})

    def node_jobs(self, node: int) -> List[Job]:
        """The sequence ``J_i`` of jobs on one node, in index order."""
        return sorted((j for j in self._jobs.values() if j.node == node),
                      key=lambda j: j.index)

    def children(self) -> Dict[JobId, List[JobId]]:
        out: Dict[JobId, List[JobId]] = {jid: [] for jid in self._jobs}
        for job in self._jobs.values():
            for dep in job.deps:
                if dep not in self._jobs:
                    raise GraphError(f"{job.job_id} depends on missing {dep}")
                out[dep].append(job.job_id)
        return out

    def initial_jobs(self) -> List[JobId]:
        """Jobs with theta(J) = {} — no incoming edges."""
        return [jid for jid, j in self._jobs.items() if not j.deps]

    def final_jobs(self) -> List[JobId]:
        """Jobs no other job depends on — no outgoing edges."""
        ch = self.children()
        return [jid for jid, kids in ch.items() if not kids]

    # ------------------------------------------------------------- topology
    def topological_order(self) -> List[JobId]:
        if self._topo_cache is not None:
            return self._topo_cache
        indeg = {jid: len(j.deps) for jid, j in self._jobs.items()}
        for job in self._jobs.values():
            for dep in job.deps:
                if dep not in self._jobs:
                    raise GraphError(f"{job.job_id} depends on missing {dep}")
        ready = deque(sorted(jid for jid, d in indeg.items() if d == 0))
        ch = self.children()
        order: List[JobId] = []
        while ready:
            jid = ready.popleft()
            order.append(jid)
            for kid in ch[jid]:
                indeg[kid] -= 1
                if indeg[kid] == 0:
                    ready.append(kid)
        if len(order) != len(self._jobs):
            cyc = [jid for jid, d in indeg.items() if d > 0]
            raise GraphError(f"dependency cycle among {cyc[:8]}...")
        self._topo_cache = order
        return order

    def validate(self) -> None:
        """Checks the structural invariants of §III.

        * acyclic (Definition 1),
        * serial order: job j>0 depends (directly) on its predecessor j-1,
        * at most one *direct* dependency into any other single node
          (the paper: "does not depend on multiple jobs in any other node";
          deeper fan-in is expressed by chaining).
        """
        self.topological_order()
        for job in self._jobs.values():
            if job.index > 0:
                pred = (job.node, job.index - 1)
                if pred in self._jobs and pred not in job.deps:
                    raise GraphError(
                        f"{job.job_id} missing serial dep on {pred}")
            per_node: Dict[int, int] = {}
            for (n, _k) in job.deps:
                if n != job.node:
                    per_node[n] = per_node.get(n, 0) + 1
            bad = {n: c for n, c in per_node.items() if c > 1}
            if bad:
                raise GraphError(
                    f"{job.job_id} depends on multiple jobs in nodes {bad}")

    # ----------------------------------------------- depths (Defs. 4 and 5)
    def max_depths(self) -> Dict[JobId, int]:
        """delta(J): length of the longest path from any initial job to J.

        Initial jobs have depth 0 (paper Table I).  O(E) DAG traversal.
        """
        depth: Dict[JobId, int] = {}
        for jid in self.topological_order():
            job = self._jobs[jid]
            depth[jid] = (max((depth[d] for d in job.deps), default=-1) + 1)
        return depth

    def depth_ranges(self) -> Dict[JobId, Tuple[int, int]]:
        """Delta(J) = [delta(J), beta(J) - 1] (Definition 5).

        beta(J) is the minimum max-depth over J's children.  Final jobs have
        no children; the paper's Table II assigns them the degenerate range
        [delta, delta], i.e. beta = delta + 1 by convention.
        """
        depth = self.max_depths()
        ch = self.children()
        out: Dict[JobId, Tuple[int, int]] = {}
        for jid in self._jobs:
            kids = ch[jid]
            if kids:
                beta = min(depth[k] for k in kids)
            else:
                beta = depth[jid] + 1
            out[jid] = (depth[jid], beta - 1)
        return out

    def depth_level_sets(self) -> Dict[int, List[JobId]]:
        """delta -> jobs whose depth range contains delta (ILP constraint sets).

        The paper's per-depth-level cluster-power constraints sum over
        ``delta_j = {J | delta in Delta(J)}``.
        """
        ranges = self.depth_ranges()
        levels: Dict[int, List[JobId]] = {}
        for jid, (lo, hi) in ranges.items():
            for d in range(lo, hi + 1):
                levels.setdefault(d, []).append(jid)
        return {d: sorted(js) for d, js in sorted(levels.items())}

    # -------------------------------------------------- times and schedules
    def completion_times(
        self, time_fn: Callable[[Job], float]
    ) -> Tuple[Dict[JobId, float], Dict[JobId, float]]:
        """Earliest (start, completion) per job given per-job durations.

        start(J) = max over deps' completion (0 for initial jobs);
        completion(J) = start(J) + time_fn(J).  This is the semantics of the
        paper's Fig. 4 walk-through (superscripts = starts, subscripts =
        completions).
        """
        start: Dict[JobId, float] = {}
        comp: Dict[JobId, float] = {}
        for jid in self.topological_order():
            job = self._jobs[jid]
            s = max((comp[d] for d in job.deps), default=0.0)
            start[jid] = s
            comp[jid] = s + float(time_fn(job))
        return start, comp

    def makespan(self, time_fn: Callable[[Job], float]) -> float:
        """Total execution time E_D (Definition 3) = longest-path length."""
        _, comp = self.completion_times(time_fn)
        return max(comp.values(), default=0.0)

    def critical_path(self, time_fn: Callable[[Job], float]) -> List[JobId]:
        """One longest execution path (initial -> final), by back-tracing."""
        start, comp = self.completion_times(time_fn)
        if not comp:
            return []
        cur = max(comp, key=lambda j: comp[j])
        path = [cur]
        while self._jobs[cur].deps:
            deps = self._jobs[cur].deps
            # the dep whose completion equals our start is on the path
            cur = max(deps, key=lambda d: comp[d])
            path.append(cur)
        return list(reversed(path))

    def execution_paths(self, limit: int = 100000) -> List[List[JobId]]:
        """Enumerate all execution paths (Definition 2). Small graphs only."""
        ch = self.children()
        paths: List[List[JobId]] = []

        def walk(jid: JobId, acc: List[JobId]) -> None:
            if len(paths) >= limit:
                raise GraphError("path enumeration limit exceeded")
            acc = acc + [jid]
            kids = ch[jid]
            if not kids:
                paths.append(acc)
                return
            for k in kids:
                walk(k, acc)

        for jid in self.initial_jobs():
            walk(jid, [])
        return paths

    # -------------------------------------------------------- serialisation
    def to_text(self) -> str:
        """Text format (one job per line):

        ``node index work cpu_frac tag dep_node:dep_index,...``
        """
        buf = io.StringIO()
        buf.write("# repro job dependency graph v1\n")
        for jid in sorted(self._jobs):
            j = self._jobs[jid]
            deps = ",".join(f"{n}:{k}" for n, k in j.deps) or "-"
            tag = j.tag or "-"
            buf.write(f"{j.node} {j.index} {j.work:.9g} {j.cpu_frac:.9g} "
                      f"{tag} {deps}\n")
        return buf.getvalue()

    @classmethod
    def from_text(cls, text: str) -> "JobDependencyGraph":
        g = cls()
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            node_s, idx_s, work_s, cf_s, tag, deps_s = line.split()
            deps: List[JobId] = []
            if deps_s != "-":
                for part in deps_s.split(","):
                    a, b = part.split(":")
                    deps.append((int(a), int(b)))
            g.add(int(node_s), int(idx_s), float(work_s), deps=deps,
                  cpu_frac=float(cf_s), tag="" if tag == "-" else tag)
        return g

    # ------------------------------------------------------------- utilities
    def scaled(self, factor: float) -> "JobDependencyGraph":
        """A copy with all work values scaled (problem classes A/B/C)."""
        return JobDependencyGraph(
            replace(j, work=j.work * factor) for j in self._jobs.values())

    def stats(self) -> Dict[str, float]:
        import statistics

        works = [j.work for j in self._jobs.values()]
        return {
            "jobs": len(works),
            "nodes": len(self.nodes),
            "edges": sum(len(j.deps) for j in self._jobs.values()),
            "depth_levels": max(self.max_depths().values(), default=0) + 1,
            "work_mean": statistics.fmean(works) if works else 0.0,
            "work_stdev": statistics.pstdev(works) if len(works) > 1 else 0.0,
        }
