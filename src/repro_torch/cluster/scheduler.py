"""The outer discrete-event scheduler and its calibrated rate model.

A copy of the reference's ``repro.cluster.scheduler``: the outer loop is
the same Python float arithmetic in the same order, so the same curves
give the same admissions, splits and times.  Its sweeps run on the
port's ``SweepEngine``, by default ``executor="torch"`` on the card
(``device="cpu"`` runs the engine's plain path on the CPU).

Two-level simulation has a circularity problem: a job's completion
time depends on its watt allocation over time, which depends on other
jobs' completions.  We break it the way the serving layer breaks
per-request latency estimation — with a **calibrated model**:

* :class:`RateModel` runs ONE batched :class:`~repro_torch.core.sweep.
  SweepEngine` sweep (members x quantized bound levels, padded
  buckets, zero event fallbacks) and tabulates each member's
  *progress rate* ``rate(W) = 1 / inner_makespan(W)``.  Between grid
  levels the rate interpolates linearly.
* :class:`ClusterScheduler` then runs the outer discrete-event loop:
  jobs arrive (:mod:`repro_torch.cluster.arrivals`), a
  :class:`~repro_torch.cluster.policies.ClusterPolicy` admits them onto the
  node pool and splits the facility bound, and each running job's
  progress advances at its calibrated rate for its current watts.
  Since splits only change at events, predicted completions are exact
  under the model.
* Every admitted job's realized watt history is emitted as a per-job
  ``bound_schedule`` (:meth:`ClusterResult.scenarios`), so the
  *existing* inner policies and batched torch/vector backends replay the
  whole stream unchanged — :func:`repro_torch.cluster.metrics.replay` uses
  exactly that as the ground-truth cross-check.

Example (vector backend, so it runs anywhere)::

    >>> from repro_torch.cluster.arrivals import member_pool, poisson_arrivals
    >>> from repro_torch.cluster.scheduler import ClusterScheduler, RateModel
    >>> pool = member_pool("mixed", seed=3)
    >>> trace = poisson_arrivals(pool, n_jobs=12, rate_hz=0.2, seed=7)
    >>> model = RateModel(trace, executor="vector", levels=4)
    >>> model.calibrate().event_fallbacks()
    []
    >>> sched = ClusterScheduler(trace, bound_w=60.0, total_nodes=10,
    ...                          policy="fifo-equal-split", model=model)
    >>> result = sched.run()
    >>> len(result.outcomes) == len(trace.jobs)
    True
    >>> result.makespan > 0
    True

The reference's ``docs/cluster.md`` tours the same API.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.power import (max_useful_cluster_bound,
                                    min_feasible_cluster_bound)
from repro_torch.core.scenarios import FamilyMember
from repro_torch.core.sweep import Scenario, SweepEngine, SweepResult
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import default_registry

from .arrivals import ArrivalJob, ArrivalTrace
from .policies import (EPS_W, ClusterPolicy, ClusterState, JobView,
                       get_cluster_policy)

#: Progress slack treated as "done" (absorbs float drift across many
#: piecewise-constant segments).
EPS_PROGRESS = 1e-9

#: Default inner (per-job) power policy for calibration and replay:
#: solver-free and implemented on every backend.
DEFAULT_INNER_POLICY = "equal-share"


class SchedulerError(RuntimeError):
    """The outer loop cannot make progress (a job that never fits, a
    policy that admits nothing admissible, or an invalid split)."""


class RateModel:
    """Per-member progress-rate curves, calibrated by one padded sweep.

    For every member of ``trace`` the model simulates the member solo
    at ``levels`` bound levels spanning its own feasible watt range
    (``min_feasible_cluster_bound`` .. ``max_useful_cluster_bound``)
    under ``inner_policy``, all levels of all members batched through
    a single ``SweepEngine`` run.  :meth:`rate` then interpolates
    ``1 / makespan`` piecewise-linearly — exact at grid levels,
    reported-not-hidden in between (see
    :func:`repro_torch.cluster.metrics.replay`).

    The sweep runs on ``engine`` when one is given, else on a
    ``SweepEngine(executor=executor, device=device)``: the torch
    executor (the default) on ``device``, where ``None`` is the card
    and raises without one, and ``"cpu"`` the engine's plain path.  A
    failed bucket fails the calibration; nothing is retried on another
    executor.
    """

    def __init__(self, trace: ArrivalTrace,
                 inner_policy: str = DEFAULT_INNER_POLICY,
                 levels: int = 6, executor: str = "torch",
                 latency_s: float = 0.05,
                 engine: Optional[SweepEngine] = None, device=None):
        if levels < 2:
            raise ValueError("levels must be >= 2")
        self.trace = trace
        self.inner_policy = inner_policy
        self.levels = levels
        self.latency_s = latency_s
        self.engine = engine or SweepEngine(executor=executor,
                                            device=device)
        #: member name -> sorted [(bound_w, rate)] grid; filled by
        #: :meth:`calibrate`.
        self.curves: Dict[str, List[Tuple[float, float]]] = {}
        self.sweep_result: Optional[SweepResult] = None

    def member_levels(self, member: FamilyMember) -> List[float]:
        """The quantized bound grid (watts) for one member."""
        lo = min_feasible_cluster_bound(member.specs)
        hi = max_useful_cluster_bound(member.specs)
        n = self.levels
        return [lo + (hi - lo) * k / (n - 1) for k in range(n)]

    def calibration_scenarios(self) -> List[Scenario]:
        """The members-x-levels grid as plain sweep cells."""
        cells = []
        for m in self.trace.members.values():
            for k, bound in enumerate(self.member_levels(m)):
                cells.append(Scenario(
                    name=f"cal/{m.name}/{k}", graph=m.graph,
                    specs=m.specs, bound_w=bound,
                    policy=self.inner_policy,
                    latency_s=self.latency_s,
                    tags={"member": m.name, "level": k}))
        return cells

    def calibrate(self) -> SweepResult:
        """Run the calibration sweep and tabulate the rate curves."""
        result = self.engine.run(self.calibration_scenarios())
        for rec in result:
            if not rec.ok:
                raise SchedulerError(
                    f"calibration failed for {rec.scenario.name}: "
                    f"{rec.error}")
            member = rec.scenario.tags["member"]
            pair = (rec.scenario.bound_w, 1.0 / rec.result.makespan)
            self.curves.setdefault(member, []).append(pair)
        for curve in self.curves.values():
            curve.sort()
        self.sweep_result = result
        return result

    def _curve(self, member: str) -> List[Tuple[float, float]]:
        if not self.curves:
            self.calibrate()
        try:
            return self.curves[member]
        except KeyError:
            raise SchedulerError(f"no rate curve for member "
                                 f"{member!r}; not in the trace pool?"
                                 ) from None

    def rate(self, member: str, bound_w: float) -> float:
        """Calibrated progress rate (1/s) at ``bound_w`` watts."""
        curve = self._curve(member)
        if bound_w <= curve[0][0]:
            return curve[0][1]
        if bound_w >= curve[-1][0]:
            return curve[-1][1]
        for (w0, r0), (w1, r1) in zip(curve, curve[1:]):
            if w0 <= bound_w <= w1:
                f = (bound_w - w0) / (w1 - w0) if w1 > w0 else 0.0
                return r0 + f * (r1 - r0)
        raise AssertionError("unreachable: sorted curve scan")

    def solo_makespan(self, member: str, bound_w: float) -> float:
        """Model-predicted solo makespan at ``bound_w`` watts."""
        return 1.0 / self.rate(member, bound_w)

    def best_makespan(self, member: str) -> float:
        """Solo makespan at the member's max-useful bound (the SLO
        reference duration)."""
        return 1.0 / self._curve(member)[-1][1]


@dataclass
class JobRun:
    """One job's life through the outer loop (scheduler-internal, but
    exposed on :class:`ClusterResult` for metrics/replay)."""

    job: ArrivalJob
    member: FamilyMember
    min_w: float
    max_w: float
    admit_t: Optional[float] = None
    end_t: Optional[float] = None
    progress: float = 0.0
    #: Realized allocation steps: absolute ``(time, watts)``, one entry
    #: per split change while running.  Becomes the job's
    #: ``bound_schedule`` on replay.
    history: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def watts(self) -> float:
        """Current allocation (0 when not running)."""
        return self.history[-1][1] if self.history else 0.0

    def bound_schedule(self) -> Tuple[Tuple[float, float], ...]:
        """The job-relative schedule after the initial bound (the
        ``Scenario.bound_schedule`` contract: times from sim start)."""
        if len(self.history) < 2:
            return ()
        t0 = self.history[0][0]
        return tuple((t - t0, w) for t, w in self.history[1:])


class ClusterScheduler:
    """Discrete-event loop: arrivals in, per-job bound schedules out.

    Events are job arrivals and (model-predicted) completions; at each
    event the policy may admit queued jobs and the bound is re-split
    across the running set.  The scheduler owns the invariants — a
    split must cover exactly the running jobs, stay inside each job's
    ``[min_w, max_w]`` box, and sum to at most ``bound_w``; a policy
    that stalls the queue (nothing running, nothing admissible ever)
    raises :class:`SchedulerError` instead of spinning.

    Without a ``model`` it builds ``RateModel(trace, executor=executor,
    device=device)``: the torch executor on the card by default.
    """

    def __init__(self, trace: ArrivalTrace, bound_w: float,
                 total_nodes: int,
                 policy: Union[str, ClusterPolicy] = "fifo-equal-split",
                 model: Optional[RateModel] = None,
                 executor: str = "torch", device=None):
        self.trace = trace
        self.bound_w = float(bound_w)
        self.total_nodes = int(total_nodes)
        self.policy = get_cluster_policy(policy)
        self.model = model or RateModel(trace, executor=executor,
                                        device=device)
        for m in trace.members.values():
            n = len(m.graph.nodes)
            if n > self.total_nodes:
                raise SchedulerError(
                    f"member {m.name!r} needs {n} nodes but the pool "
                    f"has {self.total_nodes}")
            if min_feasible_cluster_bound(m.specs) > self.bound_w + EPS_W:
                raise SchedulerError(
                    f"member {m.name!r} needs "
                    f"{min_feasible_cluster_bound(m.specs):.1f} W solo "
                    f"but the cluster bound is {self.bound_w:.1f} W")

    # ---------------------------------------------------------- views

    def _view(self, run: JobRun) -> JobView:
        member = run.member.name
        return JobView(
            name=run.job.name, user=run.job.user, member=member,
            nodes=len(run.member.graph.nodes), min_w=run.min_w,
            max_w=run.max_w, arrival_t=run.job.t,
            progress=run.progress,
            rate_fn=lambda w, _m=member: self.model.rate(_m, w),
            weight=self.model.best_makespan(member),
            tags=dict(run.job.tags))

    def _validated_split(self, split: Dict[str, float],
                         running: Dict[str, JobRun]) -> Dict[str, float]:
        if set(split) != set(running):
            raise SchedulerError(
                f"policy {self.policy.name!r} split keys "
                f"{sorted(split)} != running {sorted(running)}")
        total = 0.0
        out = {}
        for name, w in split.items():
            run = running[name]
            if w < run.min_w - 1e-6 or w > run.max_w + 1e-6:
                raise SchedulerError(
                    f"policy {self.policy.name!r} gave {name} "
                    f"{w:.2f} W outside [{run.min_w:.2f}, "
                    f"{run.max_w:.2f}]")
            w = min(max(w, run.min_w), run.max_w)
            out[name] = w
            total += w
        if total > self.bound_w + 1e-6:
            raise SchedulerError(
                f"policy {self.policy.name!r} split sums to "
                f"{total:.2f} W > bound {self.bound_w:.2f} W")
        return out

    # ----------------------------------------------------------- loop

    def run(self) -> "ClusterResult":
        """Simulate the whole stream; returns every job completed."""
        runs = {}
        for job in self.trace.jobs:
            m = self.trace.member_for(job)
            runs[job.name] = JobRun(
                job=job, member=m,
                min_w=min_feasible_cluster_bound(m.specs),
                max_w=max_useful_cluster_bound(m.specs))
        pending = list(self.trace.jobs)   # arrival order
        queue: List[str] = []             # arrived, not admitted
        running: Dict[str, JobRun] = {}
        util: List[Tuple[float, float]] = []
        now = 0.0
        max_events = 20 * len(pending) + 100
        # DES observability: sim-time events on the "cluster" track,
        # wait/queue metrics in the process-default registry.
        metrics = default_registry()
        wait_h = metrics.histogram("cluster_wait_s")
        wait_g = metrics.gauge("cluster_job_wait_s")
        queue_g = metrics.gauge("cluster_queue_depth")
        admitted_c = metrics.counter("cluster_admitted")
        completed_c = metrics.counter("cluster_completed")
        stalls_c = metrics.counter("cluster_stalls")
        tracing = obs_trace.enabled()
        for _ in range(max_events):
            # 1. next event time: first arrival or earliest predicted
            #    completion (rates are constant until then, so the
            #    prediction is exact under the model).
            t_arr = pending[0].t if pending else math.inf
            t_done = math.inf
            for run in running.values():
                rate = self.model.rate(run.member.name, run.watts)
                t_done = min(t_done,
                             now + (1.0 - run.progress) / rate)
            t_next = min(t_arr, t_done)
            if math.isinf(t_next):
                break
            # 2. advance running progress to the event time.
            dt = t_next - now
            for run in running.values():
                run.progress += dt * self.model.rate(run.member.name,
                                                     run.watts)
            now = t_next
            # 3. completions.
            for name in [n for n, r in running.items()
                         if r.progress >= 1.0 - EPS_PROGRESS]:
                run = running.pop(name)
                run.progress = 1.0
                run.end_t = now
                completed_c.inc()
                if tracing:
                    obs_trace.complete(
                        "job", 0.0, now - run.admit_t, cat="cluster",
                        track="cluster", lane=f"user:{run.job.user}",
                        ts=run.admit_t,
                        args={"job": name, "member": run.member.name})
                    obs_trace.instant("complete", cat="cluster",
                                      track="cluster", ts=now,
                                      args={"job": name})
            # 4. arrivals.
            while pending and pending[0].t <= now + EPS_PROGRESS:
                job = pending.pop(0)
                queue.append(job.name)
                if tracing:
                    obs_trace.instant("arrive", cat="cluster",
                                      track="cluster", ts=now,
                                      args={"job": job.name})
            # 5. admission.
            free = self.total_nodes \
                - sum(len(r.member.graph.nodes)
                      for r in running.values())
            state = ClusterState(
                now=now, bound_w=self.bound_w,
                total_nodes=self.total_nodes, free_nodes=free,
                running=[self._view(r) for r in running.values()],
                queue=[self._view(runs[n]) for n in queue])
            admitted = self.policy.admit(state)
            for view in admitted:
                if view.name not in queue:
                    raise SchedulerError(
                        f"policy {self.policy.name!r} admitted "
                        f"{view.name!r} which is not queued")
                queue.remove(view.name)
                run = runs[view.name]
                run.admit_t = now
                running[view.name] = run
                wait = now - run.job.t
                admitted_c.inc()
                wait_h.observe(wait)
                wait_g.set(wait, job=view.name)
                if tracing:
                    obs_trace.instant("admit", cat="cluster",
                                      track="cluster", ts=now,
                                      args={"job": view.name,
                                            "wait_s": wait})
            if running and sum(len(r.member.graph.nodes)
                               for r in running.values()) \
                    > self.total_nodes:
                raise SchedulerError(
                    f"policy {self.policy.name!r} over-admitted: "
                    f"node demand exceeds the pool")
            # 6. re-split on any membership change.
            if admitted or t_done <= t_arr:
                split = self._validated_split(
                    self.policy.split(
                        [self._view(r) for r in running.values()],
                        self.bound_w),
                    running) if running else {}
                for name, w in split.items():
                    run = running[name]
                    if not run.history \
                            or abs(run.watts - w) > EPS_W:
                        run.history.append((now, w))
                util.append((now, sum(split.values())))
            queue_g.set(len(queue))
            if tracing:
                obs_trace.counter("jobs",
                                  {"queued": len(queue),
                                   "running": len(running)},
                                  cat="cluster", track="cluster", ts=now)
            # 7. stall detection: jobs are waiting, nothing is
            #    running, and no future arrival can change the state.
            if queue and not running and not pending:
                stalls_c.inc()
                if tracing:
                    obs_trace.instant("stall", cat="cluster",
                                      track="cluster", ts=now,
                                      args={"queued": len(queue)})
                raise SchedulerError(
                    f"policy {self.policy.name!r} stalled: "
                    f"{len(queue)} jobs queued, none admissible")
        else:
            raise SchedulerError("event budget exhausted (scheduler "
                                 "livelock?)")
        if pending or queue or running:
            raise SchedulerError("stream did not drain: "
                                 f"{len(pending)} pending, "
                                 f"{len(queue)} queued, "
                                 f"{len(running)} running")
        return ClusterResult(self, [runs[j.name]
                                    for j in self.trace.jobs], util)


class ClusterResult:
    """A finished outer simulation: per-job runs + the utilization
    trace, with the realized splits exported as replayable scenarios.
    """

    def __init__(self, scheduler: ClusterScheduler,
                 runs: Sequence[JobRun],
                 util: Sequence[Tuple[float, float]]):
        self.scheduler = scheduler
        self.policy_name = scheduler.policy.name
        self.bound_w = scheduler.bound_w
        self.total_nodes = scheduler.total_nodes
        self.model = scheduler.model
        self.runs = list(runs)
        self.util = list(util)

    @property
    def outcomes(self) -> List[JobRun]:
        """Alias kept for symmetry with the metrics layer."""
        return self.runs

    @property
    def makespan(self) -> float:
        """Completion time of the last job (stream makespan)."""
        return max(r.end_t for r in self.runs)

    def scenarios(self, inner_policy: Optional[str] = None,
                  latency_s: Optional[float] = None) -> List[Scenario]:
        """Every job's realized split as an inner-level scenario.

        The first allocation becomes ``Scenario.bound_w`` and the
        remaining history the job-relative ``bound_schedule`` — ready
        for any ``SweepEngine`` executor (the replay cross-check).
        """
        cells = []
        for run in self.runs:
            cells.append(Scenario(
                name=f"replay/{self.policy_name}/{run.job.name}",
                graph=run.member.graph, specs=run.member.specs,
                bound_w=run.history[0][1],
                policy=inner_policy or self.model.inner_policy,
                latency_s=(self.model.latency_s if latency_s is None
                           else latency_s),
                bound_schedule=run.bound_schedule(),
                tags={"job": run.job.name, "user": run.job.user,
                      "member": run.member.name}))
        return cells
