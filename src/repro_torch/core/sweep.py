"""Batched scenario sweeps over (graph, bound, policy) grids (§VI-§VII).

The port's own sweep executor, written from the reference's
``repro.core.sweep`` (not a subclass of it): the same planning
vocabulary, bucket labels and fallback reasons, with the torch engine
(:class:`~repro_torch.backends.engine.TorchBatchSimulator`) in place of
the jax one.  The paper's evaluation is a sweep: run many scenarios
through the simulator and tabulate speedups.  :class:`SweepEngine` runs
one with

  * shared setup: ILP assignments are solved once per unique
    (graph, specs, bound, solver) and reused across scenarios,
  * parallel execution via ``concurrent.futures`` (thread, process, or
    serial executors; the simulator is pure Python, so processes give
    real speedup on big batches while threads keep zero pickling cost),
  * batched execution (``executor="vector"`` / ``"torch"``): eligible
    scenarios are grouped into **padded shape buckets** — same policy
    and latency, shape dimensions rounded up to powers of two — and
    each bucket runs as ONE vector/torch batch, so a heterogeneous
    scenario family (mixed graph sizes, mixed clusters, per-row bound
    schedules) stays off the slow per-scenario event path,
  * structured results: a :class:`SweepResult` table with per-scenario
    :class:`SimResult` rows, failure capture, speedup lookups, and
    per-scenario backend/bucket accounting
    (:meth:`SweepResult.backend_summary`),
  * bounded memory: scenarios default to ``trace_every=None`` so power
    traces are not retained across thousands of runs.

``SweepEngine.map`` is the same machinery for arbitrary batch work.

Example — a two-graph grid batched onto the vector backend::

    >>> from repro_torch.core import (SweepEngine, scenario_grid,
    ...                               listing2_graph, listing2_uniform,
    ...                               homogeneous_cluster)
    >>> grid = scenario_grid(
    ...     {"a": listing2_graph(), "b": listing2_uniform(10.0)},
    ...     homogeneous_cluster(3), [6.0, 9.0], ["equal-share"])
    >>> sweep = SweepEngine(executor="vector").run(grid)
    >>> len(sweep), sweep.failures
    (4, [])
    >>> round(sweep.result("a", "equal-share", 6.0).makespan, 1)
    38.0
"""

from __future__ import annotations

import concurrent.futures as _futures
import multiprocessing
import os
import threading
import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, Union)

from repro_torch.obs import trace as obs_trace

from .batchsim import BatchSimulator, estimate_row_bytes
from .graph import JobDependencyGraph
from .ilp import PowerAssignment
from .power import NodeSpec
from .results import SimResult
from .simulator import Simulator

#: Default device-memory budget for one dispatched bucket, in MiB
#: (override per engine with ``memory_budget_mb`` or the
#: ``REPRO_DEVICE_BUDGET_MB`` environment variable).  A bucket whose
#: padded rows exceed it is split into sub-buckets instead of growing
#: without bound.
DEFAULT_MEMORY_BUDGET_MB = 1024.0


def _process_pool(max_workers: Optional[int]
                  ) -> _futures.ProcessPoolExecutor:
    """A process pool that is safe to start after torch has initialized.

    The Linux default start method is ``fork``, and a forked child of a
    process that has initialized CUDA cannot use it, nor safely inherit
    torch's thread pools.  Every process executor in this module
    therefore uses the ``spawn`` start method: workers are fresh
    interpreters that import :mod:`repro_torch` cleanly, at the cost of a
    slightly slower pool start.
    """
    return _futures.ProcessPoolExecutor(
        max_workers=max_workers,
        mp_context=multiprocessing.get_context("spawn"))


def device_budget_mb(memory_budget_mb: Optional[float] = None) -> float:
    """The per-dispatch device-memory budget in MiB: ``memory_budget_mb``
    when given, else ``REPRO_DEVICE_BUDGET_MB``, else
    :data:`DEFAULT_MEMORY_BUDGET_MB`."""
    if memory_budget_mb is None:
        memory_budget_mb = os.environ.get("REPRO_DEVICE_BUDGET_MB",
                                          DEFAULT_MEMORY_BUDGET_MB)
    return float(memory_budget_mb)


def plan_chunk_rows(row_bytes: int, budget_bytes: int,
                    align: int = 1) -> int:
    """Rows one dispatch may carry under a device-memory budget.

    ``row_bytes`` is the per-row footprint of the bucket's padding
    envelope (:func:`repro_torch.core.batchsim.estimate_row_bytes`);
    ``align`` is the shard width (the devices a batch's rows split
    over) — the cap is rounded *down* to a multiple of it, so chunks
    split without phantom rows, but never below one full shard width (a
    bucket must be dispatchable even when one row's state already
    exceeds the budget).
    """
    align = max(1, int(align))
    cap = int(budget_bytes) // max(1, int(row_bytes))
    return max(align, (cap // align) * align)


@dataclass(frozen=True)
class Scenario:
    """One (graph, bound, policy) cell of a sweep."""

    name: str
    graph: JobDependencyGraph
    specs: Tuple[NodeSpec, ...]
    bound_w: float
    policy: Union[str, object]            # registry key or PowerPolicy
    latency_s: float = 0.05
    policy_kwargs: Mapping[str, object] = field(default_factory=dict)
    use_makespan_milp: bool = False
    ilp_time_limit: float = 60.0
    trace_every: Optional[float] = None   # no trace retention by default
    bound_schedule: Tuple[Tuple[float, float], ...] = ()
    tags: Mapping[str, object] = field(default_factory=dict)

    @property
    def policy_key(self) -> str:
        """The registry key (or the instance's ``name``) for tabulation."""
        return self.policy if isinstance(self.policy, str) \
            else getattr(self.policy, "name", str(self.policy))


@dataclass
class SweepRecord:
    scenario: Scenario
    result: Optional[SimResult]
    error: Optional[str] = None
    elapsed_s: float = 0.0
    #: Which simulator actually ran this cell: "event", "vector", "torch".
    backend: str = "event"
    #: Why the cell did not run on the requested batched backend (None
    #: when it did) — batched executors fall back silently otherwise.
    fallback_reason: Optional[str] = None
    #: Label of the batch the cell ran in (``None`` for per-scenario
    #: event runs): ``"vector#0:shared"`` for a same-shape batch,
    #: ``"torch#1:padded(N8,J64)"`` for a padded mixed-shape bucket.
    bucket: Optional[str] = None

    @property
    def ok(self) -> bool:
        """True when the scenario produced a result (no captured error)."""
        return self.error is None


@dataclass
class MapRecord:
    """One item's outcome from :meth:`SweepEngine.map`."""

    label: str
    value: object = None
    error: Optional[str] = None
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        """True when the item produced a value (no captured error)."""
        return self.error is None


class SweepResult:
    """Structured table over the finished sweep.

    ``profile`` is the torch backend's
    :class:`~repro_torch.backends.profile.SweepProfile` (per-bucket
    pack / dispatch / run / transfer / results timings) when the sweep
    dispatched torch buckets, else ``None``.
    """

    def __init__(self, records: List[SweepRecord], profile=None):
        self.records = records
        self.profile = profile

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    @property
    def failures(self) -> List[SweepRecord]:
        """Records whose scenarios errored (empty on a clean sweep)."""
        return [r for r in self.records if not r.ok]

    def backend_summary(self) -> str:
        """One line of truthful accounting: **per-scenario** cells per
        backend (a padded bucket of 30 scenarios counts as 30, never as
        one record), the number of distinct batches each batched backend
        actually launched, and why any cell fell back off the requested
        batched backend.

        >>> from repro_torch.core import (SweepEngine, scenario_grid,
        ...                               listing2_graph,
        ...                               homogeneous_cluster)
        >>> grid = scenario_grid({"l2": listing2_graph()},
        ...                      homogeneous_cluster(3), [6.0, 9.0],
        ...                      ["equal-share"])
        >>> SweepEngine(executor="vector").run(grid).backend_summary()
        'backends: vector=2 | batches: vector=1'
        """
        from collections import Counter

        counts = Counter(r.backend for r in self.records)
        parts = " ".join(f"{b}={counts[b]}" for b in sorted(counts))
        batches = {b: len({r.bucket for r in self.records
                           if r.backend == b and r.bucket})
                   for b in sorted(counts)}
        if any(batches.values()):
            detail = ", ".join(f"{b}={n}" for b, n in batches.items()
                               if n)
            parts += f" | batches: {detail}"
        reasons = Counter(r.fallback_reason for r in self.records
                          if r.fallback_reason)
        if reasons:
            detail = ", ".join(f"{k} x{n}"
                               for k, n in sorted(reasons.items()))
            parts += f" | fallbacks: {detail}"
        if self.profile is not None and self.profile.buckets:
            parts += f" | {self.profile.summary()}"
        return f"backends: {parts}"

    def event_fallbacks(self) -> List[SweepRecord]:
        """Records that landed on the per-scenario event simulator.

        On the thread/process/serial executors every record is an event
        record and that is not a fallback; under a batched executor a
        non-empty result means part of the sweep silently lost its
        batching — the trace-corpus sweep and the serve CLI's
        ``--expect-clean`` gate assert on this.
        """
        return [r for r in self.records if r.backend == "event"]

    def result(self, name: str, policy: str,
               bound_w: Optional[float] = None) -> SimResult:
        """Exact lookup of one scenario's SimResult (raises if absent)."""
        for r in self.records:
            s = r.scenario
            if s.name == name and s.policy_key == policy and \
                    (bound_w is None or abs(s.bound_w - bound_w) < 1e-9):
                if r.error is not None:
                    raise RuntimeError(
                        f"scenario {name}/{policy}/{bound_w}: {r.error}")
                return r.result
        raise KeyError(f"no scenario {name}/{policy}/{bound_w}")

    def speedup(self, name: str, policy: str, bound_w: float,
                baseline: str = "equal-share") -> float:
        """``policy``'s makespan speedup over ``baseline`` on one cell."""
        base = self.result(name, baseline, bound_w)
        return self.result(name, policy, bound_w).speedup_vs(base)

    def rows(self) -> List[Dict[str, object]]:
        """One flat dict per record: scenario identity + tags, backend /
        bucket / fallback accounting, and the headline result metrics
        (or the error string)."""
        out = []
        for r in self.records:
            s = r.scenario
            row: Dict[str, object] = {
                "name": s.name, "policy": s.policy_key,
                "bound_w": s.bound_w, "latency_s": s.latency_s,
                "ok": r.ok, "elapsed_s": r.elapsed_s,
                "backend": r.backend, **dict(s.tags),
            }
            if r.fallback_reason is not None:
                row["fallback_reason"] = r.fallback_reason
            if r.bucket is not None:
                row["bucket"] = r.bucket
            if r.ok:
                row.update(makespan=r.result.makespan,
                           energy_j=r.result.energy_j,
                           avg_power_w=r.result.avg_power_w,
                           peak_power_w=r.result.peak_power_w,
                           over_budget_time=r.result.over_budget_time)
            else:
                row["error"] = r.error
            out.append(row)
        return out

    def to_csv(self) -> str:
        """:meth:`rows` as CSV text (union of all row columns)."""
        rows = self.rows()
        cols: List[str] = []
        for row in rows:
            for k in row:
                if k not in cols:
                    cols.append(k)
        lines = [",".join(cols)]
        for row in rows:
            lines.append(",".join(str(row.get(c, "")) for c in cols))
        return "\n".join(lines) + "\n"


def _run_scenario(scenario: Scenario,
                  assignment: Optional[PowerAssignment]) -> SimResult:
    from repro_torch.policies import get_policy

    policy = scenario.policy
    if isinstance(policy, str):
        kwargs = dict(scenario.policy_kwargs)
        if assignment is not None and "assignment" not in kwargs:
            kwargs["assignment"] = assignment
        policy = get_policy(policy, **kwargs)
    else:
        # A PowerPolicy instance may appear in several scenarios (e.g. via
        # scenario_grid); policies are stateful, so each run gets its own
        # copy — both for thread safety and to avoid state leaking from
        # one scenario into the next.
        import copy

        policy = copy.deepcopy(policy)
    return Simulator(scenario.graph, list(scenario.specs), scenario.bound_w,
                     policy=policy, latency_s=scenario.latency_s,
                     trace_every=scenario.trace_every,
                     bound_schedule=scenario.bound_schedule).run()


# --------------------------------------------------------- bucket planning
# The planning vocabulary below is module-level on purpose: the offline
# SweepEngine and a streaming frontend share one definition of "which
# scenarios batch together", "what envelope they pad to" and "how a
# batch simulator is built".

#: Policies whose shared setup is an ILP solve (cached per unique
#: (graph, cluster, bound, solver) by :class:`AssignmentCache`).
ILP_POLICIES = ("ilp", "ilp-makespan")


def specs_signature(specs: Sequence[NodeSpec]) -> tuple:
    """Content signature of a cluster: LUT names can collide across
    differently parameterized builders (e.g. ``tpu_v5e_lut(4)`` vs
    ``tpu_v5e_lut(8)``), so hash the actual states too."""
    return tuple(
        (sp.lut.name, sp.speed, sp.lut.idle_w,
         tuple((st.freq_mhz, st.power_w) for st in sp.lut.states))
        for sp in specs)


def next_pow2(x: int) -> int:
    """The power-of-two padding target for one shape dimension."""
    return 1 << (max(1, int(x)) - 1).bit_length()


def scenario_dims(s: Scenario,
                  cache: Optional[Dict[tuple, tuple]] = None
                  ) -> Tuple[int, int, int, int, int]:
    """A scenario's batching shape ``(N, J, K, D, S)``: nodes, jobs,
    per-lane sequence length (jobs-per-node max + 1), dependency
    fan-in, LUT states.  ``cache`` (keyed on the graph/specs
    identities) skips the O(J + N) graph walk for the many scenarios
    of a sweep that share one graph."""
    key = (id(s.graph), id(s.specs))
    if cache is not None and key in cache:
        return cache[key]
    g = s.graph
    n = len(g.nodes)
    j = len(g.jobs)
    k = max(len(g.node_jobs(nid)) for nid in g.nodes) + 1
    d = max((len(job.deps) for job in g.jobs.values()), default=0) or 1
    lut_states = max(len(sp.lut.states) for sp in s.specs)
    dims = (n, j, k, d, lut_states)
    if cache is not None:
        cache[key] = dims
    return dims


def bucket_key(backend: str, s: Scenario,
               dims_cache: Optional[Dict[tuple, tuple]] = None) -> tuple:
    """Scenarios sharing a key run as ONE batch: same backend, policy,
    latency and trace config, and the same power-of-two (N, J) padding
    envelope.  Rounding nodes/jobs up to powers of two keeps the bucket
    count logarithmic in shape diversity; the minor dimensions
    (per-lane sequence, dependency fan-in, LUT states) are padded to
    the bucket's own power-of-two maxima at build time, so they never
    split buckets."""
    n, j = scenario_dims(s, dims_cache)[:2]
    return (backend, s.policy, round(s.latency_s, 12), s.trace_every,
            (next_pow2(n), next_pow2(j)))


def _graph_text(g: JobDependencyGraph,
                texts: Optional[Dict[int, tuple]]) -> str:
    """``g.to_text()``, memoized in ``texts`` per graph object and job
    count: jobs are frozen and a graph only grows, so a graph that was
    added to since is read again.  The entry pins the graph, so a
    recycled ``id`` cannot alias another graph."""
    if texts is None:
        return g.to_text()
    hit = texts.get(id(g))
    if hit is not None and hit[0] is g and hit[1] == len(g):
        return hit[2]
    text = g.to_text()
    texts[id(g)] = (g, len(g), text)
    return text


def scenario_cache_key(s: Scenario,
                       texts: Optional[Dict[int, tuple]] = None
                       ) -> Optional[tuple]:
    """Content-based identity of one scenario's *result*, or ``None``
    when the scenario is uncacheable (stateful policy instances).

    Unlike :func:`bucket_key` — which answers "what compiles together"
    and deliberately ignores graph content — this key answers "is this
    the same simulation": the canonical graph text, the cluster
    content signature, the exact bound/schedule, and the full policy
    configuration (what a result cache is keyed on).  ``texts`` memoizes
    the graph text across calls (a long-lived service's many scenarios
    share a few graphs, and a 64-node all-to-all graph's text takes
    milliseconds to write).
    """
    if not isinstance(s.policy, str):
        return None
    return ("scenario", _graph_text(s.graph, texts),
            specs_signature(s.specs),
            round(s.bound_w, 12), s.policy,
            tuple(sorted((k, repr(v))
                         for k, v in s.policy_kwargs.items())),
            round(s.latency_s, 12), s.trace_every,
            tuple((round(float(t), 12), round(float(w), 12))
                  for t, w in s.bound_schedule),
            s.use_makespan_milp, s.ilp_time_limit)


def vector_ineligibility(s: Scenario) -> Optional[str]:
    """Why a scenario cannot run on the numpy batch backend (None when
    it can).  Bound schedules are *not* a fallback class: both batched
    backends resolve scheduled cluster-bound arrivals at exact event
    times."""
    from repro_torch.policies.vector import has_vector_policy

    if not isinstance(s.policy, str):
        return "policy-instance"
    if not has_vector_policy(s.policy):
        return f"no-vector-policy({s.policy})"
    if s.policy_kwargs:
        return "policy-kwargs"
    return None


def torch_ineligibility(s: Scenario,
                        max_lanes: Optional[int] = None) -> Optional[str]:
    """Why a scenario cannot run on the torch engine (None when it can).

    ``max_lanes`` is the widest row the engine's device takes: the
    kernels run one warp a row, at most
    :data:`~repro_torch.kernels.power_step.MAX_LANES` lanes, so a wider
    scenario planned onto the card falls back to the vector backend
    with its own reason instead of failing inside its bucket.  ``None``
    (the CPU's plain path) has no limit."""
    reason = vector_ineligibility(s)
    if reason is not None:
        return reason
    from repro_torch.backends.policies import torch_policies

    if s.policy not in torch_policies():
        return f"no-torch-policy({s.policy})"
    if s.trace_every is not None:
        return "trace-retention"
    n = len(s.graph.nodes)
    if max_lanes is not None and n > max_lanes:
        return f"lanes({n}>{max_lanes})"
    return None


def plan_backend(s: Scenario, requested: str,
                 max_lanes: Optional[int] = None
                 ) -> Tuple[str, Optional[str]]:
    """(actual backend, fallback reason) for one scenario under the
    requested batched executor.  ``"torch"`` falls back through the
    vector backend before landing on the event simulator; ``max_lanes``
    is :func:`torch_ineligibility`'s."""
    if requested == "torch":
        reason = torch_ineligibility(s, max_lanes)
        if reason is None:
            return "torch", None
        if vector_ineligibility(s) is None:
            return "vector", reason
        return "event", reason
    reason = vector_ineligibility(s)
    return ("vector", None) if reason is None else ("event", reason)


class AssignmentCache:
    """Thread-safe ILP shared setup: assignments are solved once per
    unique (graph, cluster, bound, solver) and reused by every
    scenario — and every frontend — that asks for them."""

    def __init__(self):
        # key -> (graph, assignment); the entry pins the graph: the key
        # contains id(graph), so the graph must stay alive for as long
        # as the entry does or a recycled id could alias a different
        # workload.
        self._cache: Dict[
            tuple, Tuple[JobDependencyGraph, PowerAssignment]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def key(s: Scenario) -> tuple:
        """The solve identity: graph, cluster content, bound, solver."""
        return (id(s.graph), specs_signature(s.specs),
                round(s.bound_w, 9), s.use_makespan_milp,
                s.ilp_time_limit)

    def assignment_for(self, s: Scenario) -> Optional[PowerAssignment]:
        """The scenario's pre-solved assignment (``None`` when the
        policy does not take one).  Raises on an infeasible solve —
        callers record that as a per-scenario failure."""
        if not (isinstance(s.policy, str)
                and s.policy in ILP_POLICIES
                and "assignment" not in s.policy_kwargs):
            return None
        key = self.key(s)
        with self._lock:
            cached = self._cache.get(key)
        if cached is not None:
            return cached[1]
        from .ilp import build_makespan_milp, solve_paper_ilp

        solver = (build_makespan_milp
                  if (s.use_makespan_milp or s.policy == "ilp-makespan")
                  else solve_paper_ilp)
        assignment = solver(s.graph, list(s.specs), s.bound_w,
                            time_limit=s.ilp_time_limit)
        self.put(s, assignment)
        return assignment

    def put(self, s: Scenario, assignment: PowerAssignment) -> None:
        """Keep ``assignment`` as the scenario's solve (one solved
        elsewhere, e.g. in a process pool)."""
        with self._lock:
            self._cache[self.key(s)] = (s.graph, assignment)


def build_batch_sim(backend: str, scens: List[Scenario],
                    assignments: List[Optional[PowerAssignment]],
                    shared: bool, pad_dims: tuple, *,
                    vector_dt: float = 0.05, device=None,
                    impl: Optional[str] = None,
                    shard_devices: Optional[int] = None):
    """Construct the batch simulator for one planned bucket.

    ``scens`` must share a :func:`bucket_key`; ``shared`` selects the
    zero-padding single-graph layout, otherwise the scenarios stack
    into the ``pad_dims`` envelope.  ``backend`` is ``"vector"`` or
    ``"torch"`` — the returned simulator is a
    :class:`~repro_torch.core.batchsim.BatchSimulator` or a
    :class:`~repro_torch.backends.engine.TorchBatchSimulator` on
    ``device`` with engine path ``impl``, its rows split over
    ``shard_devices`` devices (only the latter has the dispatch/fetch
    split).
    """
    first = scens[0]
    kwargs = {}
    if first.policy in ILP_POLICIES:
        kwargs["assignments"] = assignments
    schedules = [s.bound_schedule for s in scens]
    if not any(schedules):
        schedules = None
    common = dict(dt=vector_dt, latency_s=first.latency_s,
                  bound_schedules=schedules)
    if backend == "torch":
        from repro_torch.backends.engine import TorchBatchSimulator
        from repro_torch.backends.policies import get_torch_policy

        cls = TorchBatchSimulator
        policy = get_torch_policy(first.policy, **kwargs)
        common.update(device=device, impl=impl,
                      shard_devices=shard_devices)
    else:
        from repro_torch.policies.vector import get_vector_policy

        cls = BatchSimulator
        policy = get_vector_policy(first.policy, **kwargs)
        common["trace_every"] = first.trace_every
    common["policy"] = policy
    bounds = [s.bound_w for s in scens]
    if shared:
        # single-graph batch: exact shapes, zero padding overhead
        return cls(first.graph, list(first.specs), bounds, **common)
    return cls.padded([(s.graph, list(s.specs)) for s in scens],
                      bounds, pad_dims=pad_dims, **common)


class SweepEngine:
    """Runs a batch of scenarios with shared setup and a worker pool.

    ``executor`` is ``"thread"`` (default), ``"process"``, ``"serial"``,
    ``"vector"``, or ``"torch"``.  Process pools require picklable
    graphs/specs (true for everything in
    :mod:`repro_torch.core.workloads`) and string policy keys.

    The batched executors plan eligible scenarios into **buckets**
    (:func:`bucket_key`): scenarios sharing a policy key, latency, trace
    config, and power-of-two shape envelope run as one batch-simulator
    call — :class:`~repro_torch.core.batchsim.BatchSimulator` for
    ``"vector"``, the torch engine
    (:class:`~repro_torch.backends.engine.TorchBatchSimulator`) for
    ``"torch"``.  A bucket whose scenarios all share one graph and
    cluster uses the zero-padding shared layout; mixed-shape buckets use
    the padded layout (phantom jobs/lanes masked out of the physics).
    Per-row ``bound_schedule``\\ s ride along in either layout.
    Ineligible scenarios (unregistered policies, policy instances,
    policy kwargs, trace retention on torch, rows wider than the card's
    kernels take) fall back down the chain (torch -> vector -> event)
    with the reason recorded on :attr:`SweepRecord.fallback_reason` and
    the batch they ran in on :attr:`SweepRecord.bucket`; ``vector_dt``
    is the batch backends' control tick.

    The ``"torch"`` executor runs on ``device`` (``None``: the card, and
    it raises without one; ``"cpu"`` runs the engine's plain path) with
    engine path ``impl`` (``None`` picks by policy and device, see
    :func:`~repro_torch.backends.engine.resolve_impl`).  Buckets whose
    padded footprint exceeds ``memory_budget_mb`` are split into
    sub-buckets (:func:`plan_chunk_rows` over
    :func:`~repro_torch.core.batchsim.estimate_row_bytes`, aligned to
    the shard width; ``None`` reads ``REPRO_DEVICE_BUDGET_MB``, else
    :data:`DEFAULT_MEMORY_BUDGET_MB`).  With
    ``pipeline=True`` (default) every torch chunk is dispatched before
    the first is fetched, so the card runs later chunks while the host
    builds earlier chunks' results; ``pipeline=False`` fetches each
    chunk before packing the next.  ``shard_devices`` splits each torch
    chunk's rows over that many of the visible devices (``None``: all of
    them; :func:`~repro_torch.backends.engine.shard_count`), with results
    equal to one device's bit for bit.
    """

    _ILP_POLICIES = ILP_POLICIES
    #: Executors that group same-shape scenarios into batch-simulator runs
    #: (public: callers test membership to decide whether a backend
    #: summary/fallback accounting applies).
    BATCHED_EXECUTORS = ("vector", "torch")

    def __init__(self, max_workers: Optional[int] = None,
                 executor: str = "thread", vector_dt: float = 0.05,
                 shard_devices: Optional[int] = None,
                 memory_budget_mb: Optional[float] = None,
                 pipeline: bool = True, device=None,
                 impl: Optional[str] = None):
        if executor not in ("thread", "process", "serial", "vector",
                            "torch"):
            raise ValueError(f"unknown executor {executor!r}")
        self.max_workers = max_workers
        self.executor = executor
        self.vector_dt = vector_dt
        self.shard_devices = shard_devices
        self.memory_budget_mb = device_budget_mb(memory_budget_mb)
        self.pipeline = pipeline
        self.impl = impl
        self.device = None
        self.max_lanes: Optional[int] = None
        if executor == "torch":
            from repro_torch.backends.engine import resolve_device
            from repro_torch.kernels.power_step import MAX_LANES

            self.device = resolve_device(device)
            if self.device.type == "cuda":
                self.max_lanes = MAX_LANES
        self._assignments = AssignmentCache()

    # ------------------------------------------------------- shared setup
    def _assignment_for(self, s: Scenario) -> Optional[PowerAssignment]:
        return self._assignments.assignment_for(s)

    # --------------------------------------------------------------- run
    def _run_one(self, s: Scenario) -> SweepRecord:
        t0 = time.perf_counter()
        try:
            assignment = self._assignment_for(s)
            result = _run_scenario(s, assignment)
            return SweepRecord(s, result,
                               elapsed_s=time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — captured per scenario
            return SweepRecord(s, None, error=f"{type(e).__name__}: {e}",
                               elapsed_s=time.perf_counter() - t0)

    def run(self, scenarios: Sequence[Scenario]) -> SweepResult:
        """Run every scenario on the configured executor; failures are
        captured per record, never raised (check ``result.failures``)."""
        scenarios = list(scenarios)
        one = self._run_one

        if self.executor in self.BATCHED_EXECUTORS:
            return self._run_batched(scenarios, self.executor)
        if self.executor == "serial" or len(scenarios) <= 1:
            return SweepResult([one(s) for s in scenarios])
        if self.executor == "process":
            # Solve ILP assignments up front in-process (shared setup),
            # then ship (scenario, assignment) pairs to the pool.  A
            # failed solve is a per-scenario failure, same as in the
            # serial/thread paths, not a sweep abort.
            records: List[SweepRecord] = [None] * len(scenarios)
            pre: List[Tuple[int, Scenario, Optional[PowerAssignment]]] = []
            for k, s in enumerate(scenarios):
                try:
                    pre.append((k, s, self._assignment_for(s)))
                except Exception as e:  # noqa: BLE001
                    records[k] = SweepRecord(
                        s, None, error=f"{type(e).__name__}: {e}")
            with _process_pool(self.max_workers) as pool:
                futs = {pool.submit(_run_scenario, s, a): k
                        for k, s, a in pre}
                for fut in _futures.as_completed(futs):
                    k = futs[fut]
                    try:
                        records[k] = SweepRecord(scenarios[k], fut.result())
                    except Exception as e:  # noqa: BLE001
                        records[k] = SweepRecord(
                            scenarios[k], None,
                            error=f"{type(e).__name__}: {e}")
            return SweepResult(records)
        with _futures.ThreadPoolExecutor(max_workers=self.max_workers) \
                as pool:
            return SweepResult(list(pool.map(one, scenarios)))

    # ----------------------------------------------------- batched backends
    def _run_batched(self, scenarios: Sequence[Scenario],
                     requested: str) -> SweepResult:
        records: List[Optional[SweepRecord]] = [None] * len(scenarios)
        plan_t0 = time.perf_counter()
        plans = [plan_backend(s, requested, self.max_lanes)
                 for s in scenarios]
        groups: Dict[tuple, List[int]] = {}
        leftovers: List[int] = []
        dims_cache: Dict[tuple, tuple] = {}
        for k, s in enumerate(scenarios):
            backend, _ = plans[k]
            if backend in self.BATCHED_EXECUTORS:
                groups.setdefault(bucket_key(backend, s, dims_cache),
                                  []).append(k)
            else:
                leftovers.append(k)
        if obs_trace.enabled():
            obs_trace.complete("plan", plan_t0,
                               time.perf_counter() - plan_t0, cat="sweep",
                               track="engine",
                               args={"scenarios": len(scenarios),
                                     "buckets": len(groups),
                                     "leftovers": len(leftovers)})

        profile = None
        torch_align = 1
        if any(key[0] == "torch" for key in groups):
            from repro_torch.backends.engine import shard_count
            from repro_torch.backends.profile import SweepProfile

            profile = SweepProfile()
            # The shard width every torch chunk should be a multiple of:
            # the device count the engine would pick for an unbounded
            # batch (per chunk it still clamps to the chunk's rows).
            torch_align = shard_count(self.shard_devices, 1 << 30,
                                      self.device)
        budget_bytes = int(self.memory_budget_mb * 2 ** 20)

        def solve(k: int):
            try:
                return k, self._assignment_for(scenarios[k]), None
            except Exception as e:  # noqa: BLE001
                return k, None, f"{type(e).__name__}: {e}"

        def finish(batch_idx, results, t0, backend, bucket):
            per_cell = (time.perf_counter() - t0) / len(batch_idx)
            for k, result in zip(batch_idx, results):
                records[k] = SweepRecord(scenarios[k], result,
                                         elapsed_s=per_cell,
                                         backend=backend,
                                         fallback_reason=plans[k][1],
                                         bucket=bucket)

        def fail(batch_idx, err, t0, backend, bucket):
            per_cell = (time.perf_counter() - t0) / len(batch_idx)
            for k in batch_idx:
                records[k] = SweepRecord(scenarios[k], None, error=err,
                                         elapsed_s=per_cell,
                                         backend=backend,
                                         fallback_reason=plans[k][1],
                                         bucket=bucket)
            obs_trace.instant("bucket-failed", cat="sweep", track="engine",
                              args={"bucket": bucket})

        # Phase A — plan, pack and *dispatch*.  torch chunks are launched
        # and parked on ``in_flight``; while chunk k computes, the loop is
        # already packing chunk k+1.  ``pipeline=False`` fetches each
        # chunk before packing the next; vector chunks always run
        # synchronously.  A chunk that fails to build or launch fails its
        # records: nothing is re-planned onto another backend.
        in_flight: List[tuple] = []
        for bnum, (key, idxs) in enumerate(groups.items()):
            backend, (n_pad, j_pad) = key[0], key[-1]
            # minor dims: power-of-two of the bucket's own maxima
            minor = [scenario_dims(scenarios[k], dims_cache)[2:]
                     for k in idxs]
            pad_dims = (n_pad, j_pad) + tuple(
                next_pow2(max(col)) for col in zip(*minor))
            first = scenarios[idxs[0]]
            # Shared setup first: a failing ILP solve is a per-scenario
            # failure, not a batch abort.  Solves run on a thread pool —
            # the solver releases the GIL, so threads give real
            # concurrency.
            if first.policy in self._ILP_POLICIES and len(idxs) > 1:
                with _futures.ThreadPoolExecutor(
                        max_workers=self.max_workers) as pool:
                    solved = list(pool.map(solve, idxs))
            else:
                solved = [solve(k) for k in idxs]
            live: List[int] = []
            assign_by_k: Dict[int, Optional[PowerAssignment]] = {}
            for k, assignment, err in solved:
                if err is not None:
                    records[k] = SweepRecord(scenarios[k], None, error=err,
                                             backend=backend,
                                             fallback_reason=plans[k][1])
                else:
                    assign_by_k[k] = assignment
                    live.append(k)
            if not live:
                continue
            # Memory-aware envelope: rows per dispatch capped by the
            # device budget, aligned to the shard width; an oversized
            # bucket becomes several device-aligned chunks.
            itemsize = 4 if backend == "torch" else 8
            cap = plan_chunk_rows(
                estimate_row_bytes(pad_dims, itemsize), budget_bytes,
                torch_align if backend == "torch" else 1)
            chunks = [live[i:i + cap] for i in range(0, len(live), cap)]
            for ci, batch_idx in enumerate(chunks):
                t0 = time.perf_counter()
                scens = [scenarios[k] for k in batch_idx]
                assignments = [assign_by_k[k] for k in batch_idx]
                shared = (len({id(s.graph) for s in scens}) == 1
                          and len({specs_signature(s.specs)
                                   for s in scens}) == 1)
                tag = f"{backend}#{bnum}" + \
                    (f".{ci}" if len(chunks) > 1 else "")
                bucket = (f"{tag}:shared" if shared else
                          f"{tag}:padded(N{pad_dims[0]},"
                          f"J{pad_dims[1]})")
                try:
                    sim = build_batch_sim(backend, scens, assignments,
                                          shared, pad_dims,
                                          vector_dt=self.vector_dt,
                                          device=self.device,
                                          impl=self.impl,
                                          shard_devices=self.shard_devices)
                    if backend == "torch":
                        pending = sim.dispatch()
                        pending.profile.bucket = bucket
                        # Recorded from the moment the chunk dispatches:
                        # a failed fetch still shows the chunk in the
                        # sweep's profile (the fetch fills it in place).
                        profile.add(pending.profile)
                        if self.pipeline:
                            in_flight.append(
                                (sim, pending, batch_idx, bucket, t0))
                            if obs_trace.enabled():
                                obs_trace.complete(
                                    "bucket:dispatch", t0,
                                    time.perf_counter() - t0, cat="sweep",
                                    track="engine",
                                    args={"bucket": bucket,
                                          "rows": len(batch_idx)})
                            continue
                        results = sim.fetch(pending)
                    else:
                        results = sim.run()
                    finish(batch_idx, results, t0, backend, bucket)
                    if obs_trace.enabled():
                        obs_trace.complete(
                            "bucket", t0, time.perf_counter() - t0,
                            cat="sweep", track="engine",
                            args={"bucket": bucket,
                                  "rows": len(batch_idx)})
                except Exception as e:  # noqa: BLE001
                    fail(batch_idx, f"{type(e).__name__}: {e}", t0,
                         backend, bucket)

        # Phase B — fetch in dispatch order: wait for each chunk, bring
        # its state back in one transfer and build its results.
        for sim, pending, batch_idx, bucket, t0 in in_flight:
            fetch_t0 = time.perf_counter()
            try:
                results = sim.fetch(pending)
                finish(batch_idx, results, t0, "torch", bucket)
                if obs_trace.enabled():
                    obs_trace.complete(
                        "bucket:fetch", fetch_t0,
                        time.perf_counter() - fetch_t0, cat="sweep",
                        track="engine",
                        args={"bucket": bucket, "rows": len(batch_idx)})
            except Exception as e:  # noqa: BLE001
                fail(batch_idx, f"{type(e).__name__}: {e}", t0, "torch",
                     bucket)

        if leftovers:
            left = [scenarios[k] for k in leftovers]
            if len(left) == 1:
                done = [self._run_one(left[0])]
            else:
                with _futures.ThreadPoolExecutor(
                        max_workers=self.max_workers) as pool:
                    done = list(pool.map(self._run_one, left))
            for k, rec in zip(leftovers, done):
                rec.fallback_reason = plans[k][1]
                records[k] = rec
        return SweepResult(records, profile=profile)

    # --------------------------------------------------------------- map
    def map(self, fn: Callable[[object], object], items: Iterable[object],
            label: Callable[[object], str] = str) -> List[MapRecord]:
        """Generic batched execution with per-item failure capture."""
        items = list(items)

        def one(item) -> MapRecord:
            t0 = time.perf_counter()
            try:
                return MapRecord(label(item), value=fn(item),
                                 elapsed_s=time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — captured per item
                return MapRecord(label(item),
                                 error=f"{type(e).__name__}: {e}",
                                 elapsed_s=time.perf_counter() - t0)

        if self.executor == "serial" or len(items) <= 1 \
                or self.max_workers == 1:
            return [one(i) for i in items]
        if self.executor == "process":
            # fn must be picklable; submit everything first, then collect
            # in submission order so the pool actually runs concurrently.
            t0 = time.perf_counter()
            recs = []
            with _process_pool(self.max_workers) as pool:
                futs = [(item, pool.submit(fn, item)) for item in items]
                for item, fut in futs:
                    try:
                        recs.append(MapRecord(
                            label(item), value=fut.result(),
                            elapsed_s=time.perf_counter() - t0))
                    except Exception as e:  # noqa: BLE001
                        recs.append(MapRecord(
                            label(item), error=f"{type(e).__name__}: {e}",
                            elapsed_s=time.perf_counter() - t0))
            return recs
        with _futures.ThreadPoolExecutor(max_workers=self.max_workers) \
                as pool:
            return list(pool.map(one, items))


def scenario_grid(graphs: Mapping[str, JobDependencyGraph],
                  specs: Sequence[NodeSpec],
                  bounds: Iterable[float],
                  policies: Iterable[Union[str, object]],
                  latency_s: float = 0.05,
                  **kwargs) -> List[Scenario]:
    """Cross product of graphs x bounds x policies as a scenario list."""
    specs_t = tuple(specs)
    return [Scenario(name=name, graph=g, specs=specs_t, bound_w=float(P),
                     policy=p, latency_s=latency_s, **kwargs)
            for name, g in graphs.items()
            for P in bounds
            for p in policies]


def compare_policies(graph: JobDependencyGraph, specs: Sequence[NodeSpec],
                     cluster_bound_w: float, latency_s: float = 0.05,
                     ilp_time_limit: float = 60.0,
                     use_makespan_milp: bool = False,
                     policies: Sequence[str] = ("equal-share", "ilp",
                                                "heuristic"),
                     ) -> Dict[str, SimResult]:
    """Run a set of registry policies on the same workload (§VI)."""
    engine = SweepEngine(executor="serial")
    scenarios = scenario_grid({"compare": graph}, specs, [cluster_bound_w],
                              policies, latency_s=latency_s,
                              use_makespan_milp=use_makespan_milp,
                              ilp_time_limit=ilp_time_limit,
                              trace_every=0.0)
    sweep = engine.run(scenarios)
    out: Dict[str, SimResult] = {}
    for record in sweep:
        if record.error is not None:
            raise RuntimeError(f"policy {record.scenario.policy_key!r} "
                               f"failed: {record.error}")
        out[record.scenario.policy_key] = record.result
    return out
