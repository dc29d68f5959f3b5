"""Job-arrival traces: a queue of applications for the cluster layer.

A copy of the reference's ``repro.cluster.arrivals`` on the port's core:
the same pool and seed write the same JSONL bytes, and a file either
package writes, the other loads.

The paper optimizes power *within* one MPI application; a power-capped
center runs a **stream** of them.  An :class:`ArrivalTrace` is that
stream as data: a pool of workload *members* (each a
:class:`~repro_torch.core.scenarios.FamilyMember` — dependency graph + its
own cluster slice) and a time-ordered list of :class:`ArrivalJob`\\ s,
each naming the member it instantiates, the user who submitted it, and
its SLO stretch factor.

The on-disk format is versioned JSON Lines, mirroring the MPI trace
schema of :mod:`repro_torch.traces.schema`:

* line 1 is the **header**::

      {"record": "header", "version": 1, "kind": "cluster-arrivals",
       "meta": {...}}

* **member records** define the workload pool once (graph text in the
  :meth:`~repro_torch.core.graph.JobDependencyGraph.to_text` format, cluster
  as LUT-name + speed pairs resolved through
  :data:`repro_torch.traces.calibrate.LUT_REGISTRY`)::

      {"record": "member", "name": "is4", "graph": "# repro job...",
       "cluster": [{"lut": "arndale-5410", "speed": 1.0}, ...],
       "tags": {"kind": "is"}}

* **job records** are then one short line per arrival::

      {"record": "job", "name": "j0007", "t": 3.81, "member": "is4",
       "user": "u1", "slo": 8.0}

  ``t`` is the arrival time in seconds (non-decreasing in strict
  mode), ``slo`` the job's turnaround stretch limit (see
  :mod:`repro_torch.cluster.metrics`).

:func:`poisson_arrivals` is the seeded generator: exponential
inter-arrival gaps at ``rate_hz``, per-user member mixes (every user
gets its own seeded preference weighting over the pool), members drawn
from any :class:`~repro_torch.core.scenarios.ScenarioFamily` prefab or a
:class:`~repro_torch.traces.TraceCorpus` via :func:`member_pool`.

Example::

    >>> from repro_torch.cluster.arrivals import (loads_arrivals, member_pool,
    ...                                           dumps_arrivals,
    ...                                           poisson_arrivals)
    >>> pool = member_pool("mixed", seed=3)
    >>> trace = poisson_arrivals(pool, n_jobs=8, rate_hz=0.5, seed=7,
    ...                          users=("ana", "ben"))
    >>> [len(trace.jobs), len(trace.members)]
    [8, 6]
    >>> trace.jobs[0].t
    0.0
    >>> loads_arrivals(dumps_arrivals(trace)).jobs == trace.jobs
    True

The reference's ``docs/cluster.md`` walks through the same format.
"""

from __future__ import annotations

import io
import json
import pathlib
import random
from dataclasses import dataclass, field
from typing import (Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

from repro_torch.core.graph import JobDependencyGraph
from repro_torch.core.power import NodeSpec
from repro_torch.core.scenarios import FamilyMember

#: Current arrival-trace schema version; loaders reject anything else.
ARRIVALS_VERSION = 1

#: Header ``kind`` discriminator (an arrival trace is not an MPI trace,
#: even though both are JSONL — the loader refuses the wrong family).
ARRIVALS_KIND = "cluster-arrivals"

#: Default SLO stretch: a job meets its SLO when its turnaround
#: (arrival -> completion) is at most this many times its best-case
#: solo makespan at full power.
DEFAULT_SLO_STRETCH = 8.0


class ArrivalError(ValueError):
    """An arrival trace violates the schema (bad record, member
    reference, time order, or header)."""


@dataclass(frozen=True)
class ArrivalJob:
    """One job arrival: instantiate ``member`` at time ``t``.

    ``slo`` is the job's turnaround stretch limit (multiples of the
    member's best-case solo makespan); ``user`` feeds the fair-share
    outer policy and the per-user metrics.
    """

    name: str
    t: float
    member: str
    user: str = ""
    slo: float = DEFAULT_SLO_STRETCH
    tags: Mapping[str, object] = field(default_factory=dict)

    def __post_init__(self):
        if self.t < 0:
            raise ArrivalError(f"job {self.name!r}: negative arrival "
                               f"time {self.t}")
        if self.slo <= 0:
            raise ArrivalError(f"job {self.name!r}: non-positive slo "
                               f"{self.slo}")


class ArrivalTrace:
    """A member pool plus a time-ordered job stream.

    ``members`` may be any sequence of
    :class:`~repro_torch.core.scenarios.FamilyMember`\\ s with distinct
    names; ``jobs`` must reference them by name and arrive in
    non-decreasing time order with unique job names.
    """

    def __init__(self, members: Sequence[FamilyMember],
                 jobs: Sequence[ArrivalJob],
                 meta: Optional[Mapping[str, object]] = None):
        self.members: Dict[str, FamilyMember] = {}
        for m in members:
            if m.name in self.members:
                raise ArrivalError(f"duplicate member {m.name!r}")
            self.members[m.name] = m
        self.jobs = list(jobs)
        self.meta = dict(meta or {})
        if not self.members:
            raise ArrivalError("an arrival trace needs at least one "
                               "member")
        if not self.jobs:
            raise ArrivalError("an arrival trace needs at least one job")
        seen: set = set()
        last_t = 0.0
        for job in self.jobs:
            if job.member not in self.members:
                raise ArrivalError(
                    f"job {job.name!r} references unknown member "
                    f"{job.member!r} (pool: {sorted(self.members)})")
            if job.name in seen:
                raise ArrivalError(f"duplicate job name {job.name!r}")
            seen.add(job.name)
            if job.t < last_t:
                raise ArrivalError(
                    f"job {job.name!r} arrives at {job.t} before the "
                    f"previous arrival at {last_t}")
            last_t = job.t

    def __len__(self) -> int:
        return len(self.jobs)

    @property
    def users(self) -> List[str]:
        """Sorted distinct submitting users."""
        return sorted({j.user for j in self.jobs})

    @property
    def duration(self) -> float:
        """Time of the last arrival (the offered-load horizon)."""
        return self.jobs[-1].t if self.jobs else 0.0

    def member_for(self, job: ArrivalJob) -> FamilyMember:
        """The pool member a job instantiates."""
        return self.members[job.member]


# ------------------------------------------------------------- writer

def _member_record(m: FamilyMember) -> dict:
    from repro_torch.traces.calibrate import rank_info

    return {"record": "member", "name": m.name,
            "graph": m.graph.to_text(),
            "cluster": [{"lut": r.lut, "speed": r.speed}
                        for r in rank_info(m.specs)],
            "tags": dict(m.tags)}


def dumps_arrivals(trace: ArrivalTrace) -> str:
    """The trace as canonical JSONL text (byte-stable under reload)."""
    buf = io.StringIO()
    header = {"record": "header", "version": ARRIVALS_VERSION,
              "kind": ARRIVALS_KIND, "meta": trace.meta}
    buf.write(json.dumps(header, sort_keys=True) + "\n")
    for m in trace.members.values():
        buf.write(json.dumps(_member_record(m), sort_keys=True) + "\n")
    for j in trace.jobs:
        rec = {"record": "job", "name": j.name, "t": j.t,
               "member": j.member, "user": j.user, "slo": j.slo}
        if j.tags:
            rec["tags"] = dict(j.tags)
        buf.write(json.dumps(rec, sort_keys=True) + "\n")
    return buf.getvalue()


def dump_arrivals(trace: ArrivalTrace,
                  path: Union[str, pathlib.Path]) -> None:
    """Write the trace to ``path`` as JSONL."""
    pathlib.Path(path).write_text(dumps_arrivals(trace))


# ------------------------------------------------------------- loader

def _parse_member(rec: dict, lineno: int) -> FamilyMember:
    from repro_torch.traces.calibrate import LUT_REGISTRY

    try:
        graph = JobDependencyGraph.from_text(rec["graph"])
    except Exception as e:  # noqa: BLE001 — rewrapped with context
        raise ArrivalError(f"line {lineno}: unparseable member graph: "
                           f"{e}") from None
    specs: List[NodeSpec] = []
    for entry in rec.get("cluster", ()):
        builder = LUT_REGISTRY.get(entry.get("lut"))
        if builder is None:
            raise ArrivalError(
                f"line {lineno}: unknown LUT {entry.get('lut')!r} "
                f"(known: {sorted(LUT_REGISTRY)})")
        specs.append(NodeSpec(builder(),
                              speed=float(entry.get("speed", 1.0))))
    if len(specs) != len(graph.nodes):
        raise ArrivalError(
            f"line {lineno}: member {rec.get('name')!r} has "
            f"{len(specs)} cluster entries for {len(graph.nodes)} "
            f"graph nodes")
    return FamilyMember(name=str(rec["name"]), graph=graph,
                        specs=tuple(specs),
                        tags=dict(rec.get("tags", {})))


def loads_arrivals(text: str, strict: bool = True) -> ArrivalTrace:
    """Parse JSONL text into an :class:`ArrivalTrace`.

    Strict mode additionally requires non-decreasing job times (the
    generator always writes them sorted); lenient mode sorts arrivals
    by time instead.
    """
    members: List[FamilyMember] = []
    jobs: List[ArrivalJob] = []
    meta: dict = {}
    saw_header = False
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise ArrivalError(f"line {lineno}: not JSON: {e}") from None
        kind = rec.get("record")
        if lineno == 1 or not saw_header:
            if kind != "header":
                raise ArrivalError(f"line {lineno}: first record must "
                                   f"be the header, got {kind!r}")
            if rec.get("version") != ARRIVALS_VERSION:
                raise ArrivalError(
                    f"unsupported arrival-trace version "
                    f"{rec.get('version')!r} (want {ARRIVALS_VERSION})")
            if rec.get("kind") != ARRIVALS_KIND:
                raise ArrivalError(
                    f"not an arrival trace: header kind is "
                    f"{rec.get('kind')!r} (want {ARRIVALS_KIND!r})")
            meta = dict(rec.get("meta", {}))
            saw_header = True
            continue
        if kind == "member":
            members.append(_parse_member(rec, lineno))
        elif kind == "job":
            try:
                jobs.append(ArrivalJob(
                    name=str(rec["name"]), t=float(rec["t"]),
                    member=str(rec["member"]),
                    user=str(rec.get("user", "")),
                    slo=float(rec.get("slo", DEFAULT_SLO_STRETCH)),
                    tags=dict(rec.get("tags", {}))))
            except KeyError as e:
                raise ArrivalError(f"line {lineno}: job record missing "
                                   f"{e}") from None
        else:
            raise ArrivalError(f"line {lineno}: unknown record kind "
                               f"{kind!r}")
    if not saw_header:
        raise ArrivalError("empty arrival trace (no header)")
    if not strict:
        jobs.sort(key=lambda j: j.t)
    return ArrivalTrace(members, jobs, meta=meta)


def load_arrivals(path: Union[str, pathlib.Path],
                  strict: bool = True) -> ArrivalTrace:
    """Load an arrival trace from a JSONL file."""
    return loads_arrivals(pathlib.Path(path).read_text(), strict=strict)


# ---------------------------------------------------------- generators

#: Named member-pool prefabs ``member_pool`` resolves (plus
#: ``corpus:<dir>`` for trace corpora).
POOL_PREFABS = ("mixed", "layered", "npb", "lm")


def member_pool(spec: str, seed: int = 0) -> List[FamilyMember]:
    """A workload pool from a family prefab name or a trace corpus.

    ``spec`` is one of :data:`POOL_PREFABS` (the seeded
    :mod:`repro_torch.core.scenarios` generators) or ``"corpus:<dir>"`` /
    a directory path, in which case every recorded MPI trace under it
    becomes one member (the :mod:`repro_torch.traces` frontend).
    """
    from repro_torch.core.scenarios import (lm_family, mixed_family,
                                            npb_family,
                                            random_layered_family)

    prefabs = {"mixed": mixed_family, "layered": random_layered_family,
               "npb": npb_family, "lm": lm_family}
    if spec in prefabs:
        return list(prefabs[spec](seed=seed).members)
    path = spec[len("corpus:"):] if spec.startswith("corpus:") else spec
    if pathlib.Path(path).is_dir():
        from repro_torch.traces import TraceCorpus

        return TraceCorpus.from_dir(path).members()
    raise ArrivalError(f"unknown member pool {spec!r} "
                       f"(prefabs: {POOL_PREFABS}, or a corpus dir)")


def user_mixes(members: Sequence[FamilyMember], users: Sequence[str],
               rng: random.Random) -> Dict[str, List[float]]:
    """Seeded per-user preference weights over the member pool.

    Every user gets an independent draw (squared uniforms, normalized)
    so user mixes are visibly skewed rather than uniform — some users
    submit mostly MoE steps, others mostly NPB analogues.
    """
    mixes: Dict[str, List[float]] = {}
    for user in users:
        raw = [rng.random() ** 2 + 1e-3 for _ in members]
        total = sum(raw)
        mixes[user] = [w / total for w in raw]
    return mixes


def poisson_arrivals(members: Sequence[FamilyMember], n_jobs: int,
                     rate_hz: float, seed: int = 0,
                     users: Sequence[str] = ("u0", "u1", "u2"),
                     slo: float = DEFAULT_SLO_STRETCH,
                     meta: Optional[Mapping[str, object]] = None
                     ) -> ArrivalTrace:
    """A seeded Poisson job stream over a member pool.

    Inter-arrival gaps are exponential with mean ``1 / rate_hz`` (the
    first job arrives at t=0); each arrival picks a submitting user
    uniformly and then a member from that *user's* seeded preference
    mix (:func:`user_mixes`).  Deterministic under ``seed``.
    """
    if n_jobs < 1:
        raise ArrivalError("n_jobs must be >= 1")
    if rate_hz <= 0:
        raise ArrivalError("rate_hz must be positive")
    if not users:
        raise ArrivalError("at least one user required")
    members = list(members)
    rng = random.Random(seed)
    mixes = user_mixes(members, users, rng)
    width = max(4, len(str(n_jobs - 1)))
    jobs: List[ArrivalJob] = []
    t = 0.0
    for k in range(n_jobs):
        if k:
            t += rng.expovariate(rate_hz)
        user = users[rng.randrange(len(users))]
        member = rng.choices(members, weights=mixes[user])[0]
        jobs.append(ArrivalJob(name=f"j{k:0{width}d}", t=t,
                               member=member.name, user=user, slo=slo))
    info = {"generator": "poisson", "rate_hz": rate_hz, "seed": seed,
            "users": list(users)}
    info.update(dict(meta or {}))
    return ArrivalTrace(members, jobs, meta=info)
