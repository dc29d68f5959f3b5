"""Cluster-level metrics and the batched ground-truth replay check.

A copy of the reference's ``repro.cluster.metrics``; :func:`replay` and
:func:`policy_grid` run their sweeps on the port's ``SweepEngine``, by
default ``executor="torch"`` on the card (``device="cpu"``: the
engine's plain path on the CPU).

Three jobs:

* :func:`report` folds a finished :class:`~repro_torch.cluster.scheduler.
  ClusterResult` into a :class:`ClusterReport` — stream makespan,
  throughput, mean/p99 queue wait, SLO attainment, and the
  time-weighted bound-utilization of the facility.
* :func:`replay` is the honesty check on the rate model: every job's
  *realized* watt history is replayed through the real inner
  simulator as one padded :class:`~repro_torch.core.sweep.SweepEngine`
  sweep (``bound_schedule`` per job, zero event fallbacks on the
  batched backends) and the model-predicted durations are compared
  against the replayed makespans.
* :func:`policy_grid` sweeps several outer policies over the same
  trace/bound/pool, sharing one calibrated
  :class:`~repro_torch.cluster.scheduler.RateModel` — the cluster-level
  analogue of a ``ScenarioFamily`` sweep.

Example::

    >>> from repro_torch.cluster.arrivals import member_pool, poisson_arrivals
    >>> from repro_torch.cluster.metrics import policy_grid, suggest_bound
    >>> pool = member_pool("mixed", seed=3)
    >>> trace = poisson_arrivals(pool, n_jobs=10, rate_hz=0.25, seed=5)
    >>> bound = suggest_bound(trace, total_nodes=10, frac=0.6)
    >>> cells = policy_grid(trace, bound_w=bound, total_nodes=10,
    ...                     policies=("fifo-equal-split", "backfill"),
    ...                     executor="vector", levels=4, replay=False)
    >>> [c.report.policy for c in cells]
    ['fifo-equal-split', 'backfill']
    >>> all(c.report.throughput > 0 for c in cells)
    True
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.sweep import SweepEngine, SweepResult
from repro_torch.serving import percentile

from .arrivals import ArrivalTrace
from .policies import ClusterPolicy
from .scheduler import ClusterResult, ClusterScheduler, RateModel


@dataclass
class ClusterReport:
    """Headline metrics for one (trace, policy, bound) cluster run."""

    policy: str
    bound_w: float
    total_nodes: int
    n_jobs: int
    #: Completion time of the last job in the stream (seconds).
    makespan: float
    #: Completed jobs per second of stream makespan.
    throughput: float
    wait_mean: float
    wait_p99: float
    turnaround_mean: float
    #: Fraction of jobs whose turnaround stayed within ``slo`` times
    #: their best-case solo duration.
    slo_attainment: float
    #: Time-weighted mean of (allocated watts / cluster bound).
    util_mean: float

    def as_dict(self) -> Dict[str, object]:
        """The report as a flat JSON-ready mapping."""
        return dict(self.__dict__)


def report(result: ClusterResult) -> ClusterReport:
    """Fold a finished outer simulation into its metric summary."""
    waits = [r.admit_t - r.job.t for r in result.runs]
    turnarounds = [r.end_t - r.job.t for r in result.runs]
    slo_met = 0
    for r in result.runs:
        best = result.model.best_makespan(r.member.name)
        if r.end_t - r.job.t <= r.job.slo * best:
            slo_met += 1
    makespan = result.makespan
    used_dt = 0.0
    for (t0, w), (t1, _) in zip(result.util, result.util[1:]):
        used_dt += w * (t1 - t0)
    if result.util:
        t_last, w_last = result.util[-1]
        used_dt += w_last * max(0.0, makespan - t_last)
    n = len(result.runs)
    return ClusterReport(
        policy=result.policy_name, bound_w=result.bound_w,
        total_nodes=result.total_nodes, n_jobs=n,
        makespan=makespan, throughput=n / makespan,
        wait_mean=sum(waits) / n,
        wait_p99=percentile(waits, 99.0),
        turnaround_mean=sum(turnarounds) / n,
        slo_attainment=slo_met / n,
        util_mean=used_dt / (makespan * result.bound_w))


@dataclass
class ReplayCheck:
    """Model-vs-simulator comparison over one outer run's jobs."""

    #: Per-scenario cells that fell off the batched backend (must be
    #: empty for the ``--expect-clean`` gate).
    event_fallbacks: int
    #: Kernel builds in steady state (torch executor: the sweep
    #: profile's :attr:`~repro_torch.backends.profile.SweepProfile.
    #: recompiles`; 0 on the host executors).
    recompiles: int
    #: Relative error of the model-predicted per-job duration vs the
    #: replayed inner makespan, per job.
    rel_errs: List[float] = field(default_factory=list)
    sweep: Optional[SweepResult] = None

    @property
    def max_rel_err(self) -> float:
        """Worst per-job model error (0 for an empty stream)."""
        return max(self.rel_errs) if self.rel_errs else 0.0

    @property
    def mean_rel_err(self) -> float:
        """Mean per-job model error."""
        return (sum(self.rel_errs) / len(self.rel_errs)
                if self.rel_errs else 0.0)


def replay(result: ClusterResult, executor: str = "torch",
           engine: Optional[SweepEngine] = None,
           device=None) -> ReplayCheck:
    """Replay every job's realized ``bound_schedule`` through the real
    inner simulator and compare against the model's predictions.

    All jobs run as ONE padded sweep on the requested backend; the
    returned check carries the fallback/recompile accounting the CI
    gate asserts on and the per-job relative errors.  Without an
    ``engine`` the sweep runs on ``SweepEngine(executor=executor,
    device=device)`` (torch: ``None`` is the card and raises without
    one).  A failed bucket raises; nothing is retried on another
    executor.
    """
    engine = engine or SweepEngine(executor=executor, device=device)
    cells = result.scenarios()
    sweep = engine.run(cells)
    by_name = {rec.scenario.tags["job"]: rec for rec in sweep}
    errs = []
    for run in result.runs:
        rec = by_name[run.job.name]
        if not rec.ok:
            raise RuntimeError(f"replay failed for {run.job.name}: "
                               f"{rec.error}")
        predicted = run.end_t - run.admit_t
        actual = rec.result.makespan
        errs.append(abs(predicted - actual) / actual)
    profile = sweep.profile
    return ReplayCheck(
        event_fallbacks=len(sweep.event_fallbacks()),
        recompiles=profile.recompiles if profile is not None else 0,
        rel_errs=errs, sweep=sweep)


# ``policy_grid`` takes a ``replay=`` flag that shadows the function.
_replay = replay


@dataclass
class GridCell:
    """One outer policy's evaluation on a shared trace and bound."""

    result: ClusterResult
    report: ClusterReport
    check: Optional[ReplayCheck] = None


def suggest_bound(trace: ArrivalTrace, total_nodes: int,
                  frac: float = 0.6) -> float:
    """A facility bound scaled to the pool: ``frac`` times the node
    pool's capacity at the members' mean per-node max-useful power.

    ``frac=1.0`` roughly lets ``total_nodes`` worth of jobs run
    flat-out simultaneously; the interesting contention regime for the
    outer policies is below that.
    """
    from repro_torch.core.power import max_useful_cluster_bound

    density = [max_useful_cluster_bound(m.specs)
               / len(m.graph.nodes)
               for m in trace.members.values()]
    return frac * total_nodes * (sum(density) / len(density))


def policy_grid(trace: ArrivalTrace, bound_w: float, total_nodes: int,
                policies: Sequence[Union[str, ClusterPolicy]],
                executor: str = "torch", levels: int = 6,
                inner_policy: Optional[str] = None,
                model: Optional[RateModel] = None,
                replay: bool = True,
                replay_executor: Optional[str] = None,
                device=None) -> List[GridCell]:
    """Evaluate several outer policies on one trace under one bound.

    Calibration happens once (the shared :class:`RateModel`, one
    padded sweep) and each policy's realized schedules are then
    replayed (another padded sweep per policy) unless ``replay`` is
    off.  Cells come back in ``policies`` order.  ``device`` goes to
    every engine built here (the torch executor's card by default).
    """
    if model is None:
        kwargs = {} if inner_policy is None else \
            {"inner_policy": inner_policy}
        model = RateModel(trace, executor=executor, levels=levels,
                          device=device, **kwargs)
    if not model.curves:
        model.calibrate()
    cells = []
    for policy in policies:
        sched = ClusterScheduler(trace, bound_w=bound_w,
                                 total_nodes=total_nodes,
                                 policy=policy, model=model)
        result = sched.run()
        check = None
        if replay:
            check = _replay(result,
                            executor=replay_executor or executor,
                            device=device)
        cells.append(GridCell(result=result, report=report(result),
                              check=check))
    return cells
