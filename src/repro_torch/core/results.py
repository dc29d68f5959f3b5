"""The simulator's result record and the over-budget classifier's slack."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .graph import JobId

#: Relative slack for the over-budget classifier: time counts as "above
#: the cluster bound" only when the draw exceeds
#: ``bound * (1 + OVER_BUDGET_RTOL) + 1e-9``.  ILP caps carry solver
#: tolerance (~1e-7 W above the bound) and float32 carries rounding of
#: the same order; neither is a power-bound violation.  Real transient
#: surges (the paper's §VII heuristic overshoots) exceed bounds by watts.
OVER_BUDGET_RTOL = 1e-5


@dataclass
class SimResult:
    policy: str
    makespan: float
    energy_j: float
    avg_power_w: float
    peak_power_w: float
    over_budget_time: float       # time spent above the cluster bound
    messages: int                 # reports that reached the controller
    distributes: int
    suppressed_reports: int       # debounce savings
    power_trace: List[Tuple[float, float]] = field(repr=False,
                                                   default_factory=list)
    job_starts: Dict[JobId, float] = field(repr=False, default_factory=dict)
    job_ends: Dict[JobId, float] = field(repr=False, default_factory=dict)
    #: Per-node power samples ``(t, (p_node0, p_node1, ...))`` in
    #: ``graph.nodes`` order, recorded by the event simulator only under
    #: ``node_trace=True``, at the cadence of :attr:`power_trace`.
    node_power_trace: List[Tuple[float, Tuple[float, ...]]] = field(
        repr=False, default_factory=list)

    def speedup_vs(self, baseline: "SimResult") -> float:
        """``baseline.makespan / self.makespan``; a zero-makespan result
        (empty/zero-work workload) is infinitely fast, not a crash."""
        if self.makespan == 0:
            return 1.0 if baseline.makespan == 0 else float("inf")
        return baseline.makespan / self.makespan
