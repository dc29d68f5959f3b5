"""Outer cluster policies: who runs, and at what share of the bound.

A copy of the reference's ``repro.cluster.policies``: the same
admission rules and the same watt splits, in the same float order.

The inner level (everything under :mod:`repro_torch.core` and the batched
backends) answers "given *this job* a bound of W watts, how should its
nodes share it?".  A :class:`ClusterPolicy` answers the level above:
given a facility bound, a node pool, a queue of arrivals and the jobs
already running, **which** queued jobs to admit and **how many watts**
each running job gets.  The scheduler re-invokes the policy at every
discrete event (arrival / completion), so a job's watt allocation over
time becomes exactly a per-job ``bound_schedule`` — the seam the
existing per-job policies and batched backends consume unchanged.

Policies are string-registered through the same
:class:`~repro_torch.policies.registry.PolicyRegistry` machinery as the inner
power policies::

    >>> from repro_torch.cluster.policies import CLUSTER_POLICIES
    >>> sorted(CLUSTER_POLICIES.names())[:2]
    ['backfill', 'fair-share']
    >>> CLUSTER_POLICIES.get("fifo-equal-split").name
    'fifo-equal-split'

Four policies ship:

``fifo-equal-split``
    Strict FIFO admission (the head blocks the queue until it fits);
    the bound is split by equal water-fill over running jobs.
``backfill``
    FIFO head first, then any queued job that fits the leftover nodes
    and watts (EASY-style backfilling without reservations); equal
    water-fill split.
``power-aware``
    Bin-packing admission by smallest power footprint, and a
    marginal-rate split: spare watts go, one quantum at a time, to the
    running job whose calibrated rate curve gains the most per watt —
    the outer-level analogue of the paper's redistribution rule.
``fair-share``
    Round-robin admission across users and an equal per-user watt
    budget, water-filled inside each user; watts a capped user cannot
    absorb are reclaimed and redistributed to the others (COUNTDOWN
    Slack's reclamation idea at cluster scope).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.policies.registry import PolicyRegistry

#: Watt tolerance for split bookkeeping (water-fill convergence, bound
#: conservation checks).
EPS_W = 1e-9


@dataclass
class JobView:
    """What a cluster policy may see of one job.

    ``min_w`` / ``max_w`` bracket the job's useful bound range (its
    cluster's ``min_feasible`` / ``max_useful`` watts); ``rate_fn``
    maps a bound to the job's calibrated progress rate (1 / predicted
    solo makespan at that bound) — the power-aware split differentiates
    it numerically.  ``progress`` is the fraction of the job already
    done (0 for queued jobs).
    """

    name: str
    user: str
    member: str
    nodes: int
    min_w: float
    max_w: float
    arrival_t: float
    progress: float = 0.0
    rate_fn: Optional[Callable[[float], float]] = None
    #: Job size in seconds of best-case solo work.  Marginal fills
    #: weight rate gains by it, so a watt goes where it buys the most
    #: *work* per second, not where it buys the largest fraction of a
    #: (possibly tiny) job.
    weight: float = 1.0
    tags: Dict[str, object] = field(default_factory=dict)


@dataclass
class ClusterState:
    """The decision context handed to a policy at each event."""

    now: float
    bound_w: float
    total_nodes: int
    free_nodes: int
    running: List[JobView]
    queue: List[JobView]

    def fits(self, job: JobView, admitted: Sequence[JobView] = ()
             ) -> bool:
        """Whether ``job`` fits the free nodes and min-watt headroom
        left after also admitting ``admitted``."""
        nodes = self.free_nodes - sum(j.nodes for j in admitted)
        floor = sum(j.min_w for j in self.running) \
            + sum(j.min_w for j in admitted)
        return job.nodes <= nodes \
            and floor + job.min_w <= self.bound_w + EPS_W


class ClusterPolicy:
    """Admission + watt-split strategy for the outer scheduler.

    Subclasses implement :meth:`admit` (which queued jobs start now)
    and :meth:`split` (watts per running job).  The scheduler enforces
    the invariants — splits within ``[min_w, max_w]`` summing to at
    most the bound, admissions that fit — so a policy bug fails loudly
    instead of running an infeasible simulation.
    """

    #: Registry key; set by the ``@CLUSTER_POLICIES.register`` decorator.
    name = "?"

    def admit(self, state: ClusterState) -> List[JobView]:
        """Queued jobs to admit at this event, in admission order."""
        raise NotImplementedError

    def split(self, running: Sequence[JobView], bound_w: float
              ) -> Dict[str, float]:
        """Watts for every running job (keyed by job name)."""
        raise NotImplementedError


#: The cluster-policy registry (string keys -> policy classes), the
#: outer-level mirror of the event policies' registry
#: (:mod:`repro_torch.policies.registry`).
CLUSTER_POLICIES = PolicyRegistry(ClusterPolicy, kind="cluster")


def get_cluster_policy(name, **kwargs) -> ClusterPolicy:
    """Resolve a policy name (or pass an instance through)."""
    if isinstance(name, ClusterPolicy):
        return name
    return CLUSTER_POLICIES.get(name, **kwargs)


# ------------------------------------------------------------ helpers

def water_fill(jobs: Sequence[JobView], budget_w: float
               ) -> Dict[str, float]:
    """Equal water-fill: floor everyone at ``min_w``, then raise all
    allocations together until the budget is spent or every job caps
    out at its ``max_w``.

    The discrete analogue of pouring the spare watts evenly; jobs that
    hit their cap drop out and the rest keep filling (so the split is
    max-min fair over ``[min_w, max_w]`` boxes).
    """
    if not jobs:
        return {}
    alloc = {j.name: j.min_w for j in jobs}
    spare = budget_w - sum(alloc.values())
    if spare < -EPS_W:
        raise ValueError(f"budget {budget_w} below the running floor "
                         f"{sum(alloc.values())}")
    open_jobs = [j for j in jobs if j.max_w > j.min_w + EPS_W]
    while spare > EPS_W and open_jobs:
        share = spare / len(open_jobs)
        still_open = []
        for j in open_jobs:
            give = min(j.max_w - alloc[j.name], share)
            alloc[j.name] += give
            spare -= give
            if alloc[j.name] < j.max_w - EPS_W:
                still_open.append(j)
        if len(still_open) == len(open_jobs):
            break  # nobody capped: the equal shares landed exactly
        open_jobs = still_open
    return alloc


def marginal_fill(jobs: Sequence[JobView], budget_w: float,
                  quantum_w: float = 0.0) -> Dict[str, float]:
    """Greedy marginal-rate fill: after flooring at ``min_w``, spend
    the spare budget one quantum at a time on the job whose calibrated
    ``rate_fn`` improves most per watt at its current allocation.

    Jobs without a rate curve are treated as flat (they only ever get
    their floor from this rule); ties and exhausted curves fall back
    to water-fill behaviour via a tiny uniform bonus so the spare is
    always spent.
    """
    if not jobs:
        return {}
    alloc = {j.name: j.min_w for j in jobs}
    spare = budget_w - sum(alloc.values())
    if spare < -EPS_W:
        raise ValueError(f"budget {budget_w} below the running floor "
                         f"{sum(alloc.values())}")
    if quantum_w <= 0:
        span = max(j.max_w - j.min_w for j in jobs)
        quantum_w = max(span / 64.0, 1e-3)
    jobs_by_name = {j.name: j for j in jobs}
    while spare > EPS_W:
        best_name, best_gain = None, -1.0
        for name, w in alloc.items():
            j = jobs_by_name[name]
            room = j.max_w - w
            if room <= EPS_W:
                continue
            step = min(quantum_w, room, spare)
            if j.rate_fn is None:
                gain = 0.0
            else:
                gain = j.weight \
                    * (j.rate_fn(w + step) - j.rate_fn(w)) / step
            # Tiny uniform bonus: flat curves still absorb the spare
            # (least-filled first), so the bound is never left unspent.
            gain += 1e-12 * (j.max_w - w)
            if gain > best_gain:
                best_name, best_gain = name, gain
        if best_name is None:
            break  # everyone capped
        j = jobs_by_name[best_name]
        step = min(quantum_w, j.max_w - alloc[best_name], spare)
        alloc[best_name] += step
        spare -= step
    return alloc


# ------------------------------------------------------------ policies

@CLUSTER_POLICIES.register("fifo-equal-split", "fifo")
class FifoEqualSplit(ClusterPolicy):
    """Strict FIFO admission; equal water-fill split.

    The queue head blocks everything behind it until it fits — the
    honest baseline every batch scheduler is measured against.
    """

    name = "fifo-equal-split"

    def admit(self, state: ClusterState) -> List[JobView]:
        admitted: List[JobView] = []
        for job in state.queue:
            if not state.fits(job, admitted):
                break
            admitted.append(job)
        return admitted

    def split(self, running, bound_w):
        return water_fill(running, bound_w)


@CLUSTER_POLICIES.register("backfill")
class Backfill(ClusterPolicy):
    """FIFO head first, then anything that fits (EASY-style backfill
    without reservations); equal water-fill split."""

    name = "backfill"

    def admit(self, state: ClusterState) -> List[JobView]:
        admitted: List[JobView] = []
        for job in state.queue:
            if state.fits(job, admitted):
                admitted.append(job)
        return admitted

    def split(self, running, bound_w):
        return water_fill(running, bound_w)


@CLUSTER_POLICIES.register("power-aware", "power-aware-packing")
class PowerAware(ClusterPolicy):
    """Bin-packing admission by power footprint + marginal-rate split.

    Admission scans the queue smallest ``min_w`` first (a first-fit
    decreasing bin-pack on the watt floor), so more jobs run
    concurrently under the same bound; the split then pushes each
    spare watt to whichever running job's calibrated rate curve bends
    up fastest — the cluster-level version of the paper's
    "redistribute power to the ranks on the critical path".
    """

    name = "power-aware"

    def __init__(self, quantum_w: float = 0.0):
        self.quantum_w = quantum_w

    def admit(self, state: ClusterState) -> List[JobView]:
        admitted: List[JobView] = []
        order = sorted(state.queue,
                       key=lambda j: (j.min_w * j.nodes, j.arrival_t))
        for job in order:
            if state.fits(job, admitted):
                admitted.append(job)
        return admitted

    def split(self, running, bound_w):
        return marginal_fill(running, bound_w, quantum_w=self.quantum_w)


@CLUSTER_POLICIES.register("fair-share")
class FairShare(ClusterPolicy):
    """Round-robin admission across users; equal per-user watt budgets
    with reclamation.

    The bound is divided evenly among users with running jobs and
    water-filled inside each user's jobs; watts a user cannot absorb
    (all jobs capped) are reclaimed and re-filled across the other
    users' jobs, so a user finishing early returns its share instantly.
    """

    name = "fair-share"

    def admit(self, state: ClusterState) -> List[JobView]:
        by_user: Dict[str, List[JobView]] = {}
        for job in state.queue:
            by_user.setdefault(job.user, []).append(job)
        admitted: List[JobView] = []
        users = sorted(by_user)
        progressed = True
        while progressed:
            progressed = False
            for user in users:
                while by_user[user]:
                    job = by_user[user][0]
                    if state.fits(job, admitted):
                        admitted.append(by_user[user].pop(0))
                        progressed = True
                        break  # one admission per user per round
                    break
        return admitted

    def split(self, running, bound_w):
        if not running:
            return {}
        by_user: Dict[str, List[JobView]] = {}
        for job in running:
            by_user.setdefault(job.user, []).append(job)
        floor = sum(j.min_w for j in running)
        spare = bound_w - floor
        if spare < -EPS_W:
            raise ValueError(f"budget {bound_w} below the running "
                             f"floor {floor}")
        alloc = {j.name: j.min_w for j in running}
        open_users = {u: [j for j in jobs
                          if j.max_w > j.min_w + EPS_W]
                      for u, jobs in by_user.items()}
        open_users = {u: jobs for u, jobs in open_users.items() if jobs}
        while spare > EPS_W and open_users:
            share = spare / len(open_users)
            next_round: Dict[str, List[JobView]] = {}
            for user, jobs in sorted(open_users.items()):
                budget = share + sum(alloc[j.name] for j in jobs)
                filled = water_fill(jobs, budget)
                used = sum(filled.values()) \
                    - sum(alloc[j.name] for j in jobs)
                for name, w in filled.items():
                    alloc[name] = w
                spare -= used
                still = [j for j in jobs
                         if alloc[j.name] < j.max_w - EPS_W]
                if still:
                    next_round[user] = still
            if len(next_round) == len(open_users):
                break  # no user capped out: shares landed exactly
            open_users = next_round
        return alloc
