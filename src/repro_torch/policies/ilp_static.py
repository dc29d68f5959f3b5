"""Static per-job caps from the paper's ILP (§IV) — or the beyond-paper
exact-makespan MILP — as a policy.

The assignment may be passed in pre-solved (what ``simulate(...,
assignment=...)`` has always done) or left ``None``, in which case the
policy solves it itself at ``on_start`` from the cluster view.  Either
way the runtime behaviour is the same: each job start re-caps its node to
the assignment's per-job bound, applied synchronously (the assignment is
installed on the node before execution, no message latency)."""

from __future__ import annotations

from typing import List, Optional

from repro_torch.core.graph import Job
from repro_torch.core.ilp import PowerAssignment

from .base import Action, ClusterView, PowerPolicy, SetCap
from .registry import register_policy


@register_policy("ilp")
class IlpStaticPolicy(PowerPolicy):
    name = "ilp"

    def __init__(self, assignment: Optional[PowerAssignment] = None,
                 use_makespan_milp: bool = False, time_limit: float = 60.0):
        self.assignment = assignment
        self.use_makespan_milp = use_makespan_milp
        self.time_limit = time_limit

    def on_start(self, view: ClusterView) -> List[Action]:
        if self.assignment is None:
            from repro_torch.core.ilp import build_makespan_milp, solve_paper_ilp

            solver = (build_makespan_milp if self.use_makespan_milp
                      else solve_paper_ilp)
            specs = [view.specs[n] for n in view.node_ids]
            self.assignment = solver(view.graph, specs, view.bound_w,
                                     time_limit=self.time_limit)
        return []

    def on_job_start(self, job: Job, now: float) -> List[Action]:
        return [SetCap(job.node, self.assignment.bounds_w[job.job_id])]


@register_policy("ilp-makespan")
class IlpMakespanPolicy(IlpStaticPolicy):
    """Convenience key for the exact-makespan MILP variant."""

    name = "ilp-makespan"

    def __init__(self, assignment: Optional[PowerAssignment] = None,
                 time_limit: float = 120.0):
        super().__init__(assignment=assignment, use_makespan_milp=True,
                         time_limit=time_limit)
