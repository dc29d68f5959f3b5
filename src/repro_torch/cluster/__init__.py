"""Cluster-level job-arrival scheduling under a shared power bound.

The port's own copy of the reference's ``repro.cluster``: the same
arrival JSONL (the same pool and seed give the same bytes), the same
outer policies and the same discrete-event loop in the same float
order, with both batched sweeps (rate-model calibration and the replay
of every job's realized bound schedule) on the torch engine: each
bucket is one ``wave_run`` launch on the card.

The paper's simulator optimizes power *within* one MPI application;
this package adds the level above: a power-capped facility running a
**queue** of such applications.  Seeded arrival streams
(:mod:`~repro_torch.cluster.arrivals`) feed a discrete-event outer scheduler
(:mod:`~repro_torch.cluster.scheduler`) whose string-registered policies
(:mod:`~repro_torch.cluster.policies`) admit jobs onto a node pool and split
the facility bound among them; every decision lands as a per-job
``bound_schedule`` so the existing batched backends replay and verify
the whole stream (:mod:`~repro_torch.cluster.metrics`).

CLI: ``python -m repro_torch.cluster`` (see :mod:`repro_torch.cluster.cli`;
it runs on the card by default, ``--device cpu`` on the CPU).  The
reference's guide, ``docs/cluster.md``, tours the same API.
"""

from .arrivals import (ArrivalError, ArrivalJob, ArrivalTrace,
                       dump_arrivals, dumps_arrivals, load_arrivals,
                       loads_arrivals, member_pool, poisson_arrivals)
from .metrics import (ClusterReport, GridCell, ReplayCheck, policy_grid,
                      replay, report, suggest_bound)
from .policies import (CLUSTER_POLICIES, ClusterPolicy, ClusterState,
                       JobView, get_cluster_policy, marginal_fill,
                       water_fill)
from .scheduler import (ClusterResult, ClusterScheduler, JobRun,
                        RateModel, SchedulerError)

__all__ = [
    "ArrivalError", "ArrivalJob", "ArrivalTrace", "dump_arrivals",
    "dumps_arrivals", "load_arrivals", "loads_arrivals", "member_pool",
    "poisson_arrivals",
    "CLUSTER_POLICIES", "ClusterPolicy", "ClusterState", "JobView",
    "get_cluster_policy", "marginal_fill", "water_fill",
    "ClusterResult", "ClusterScheduler", "JobRun", "RateModel",
    "SchedulerError",
    "ClusterReport", "GridCell", "ReplayCheck", "policy_grid",
    "replay", "report", "suggest_bound",
]
