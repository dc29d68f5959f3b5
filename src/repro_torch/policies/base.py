"""The pluggable power-policy protocol (refactor of the simulator's
former hard-wired ``equal-share`` / ``ilp`` / ``heuristic`` branches).

A :class:`PowerPolicy` is a pure decision-maker: the simulator feeds it
events (report messages on node state transitions, job starts/completions,
cluster-bound changes, timer wake-ups) and the policy answers with a list
of :data:`Action` values — cap changes (optionally delayed, to model
controller message latency) and timer requests.  The simulator owns all
physics (progress integration, energy accounting, the event heap); a
policy owns only its control logic, so a new power-distribution scheme is
a single file that registers itself under a string key.

Hook contract (all hooks return a list of actions; the base class
implements every hook as a no-op so policies override only what they use):

``on_start(view)``
    Called once at t = 0 with the :class:`ClusterView` before any job
    starts.  Stash the view; emit initial cap assignments if the policy's
    steady state differs from the nominal equal share the simulator
    pre-applies.
``on_report(report, now)``
    A node changed state.  ``report`` is the paper's alpha message
    (§V-A): Blocked with a blocker set and power gain, or Running.
``on_job_start(job, now)`` / ``on_job_complete(job, now)``
    Per-job edges — what a static per-job assignment (the ILP) or a
    clairvoyant policy needs.
``on_bound_change(bound_w, now)``
    The cluster power bound itself moved (a power-bound arrival event).
``on_wake(token, now)``
    A timer the policy previously requested via :class:`Wake` fired.

Zero-delay ``SetCap`` actions are applied synchronously at the current
simulation time; a positive ``delay_s`` models the controller->node
message latency of the paper's UDP distribute path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Mapping, Tuple, Union

from repro_torch.core.block_detector import ReportMessage
from repro_torch.core.graph import Job, JobDependencyGraph
from repro_torch.core.power import NodeSpec, cap_floor_w


@dataclass(frozen=True)
class SetCap:
    """Grant ``node`` a power bound of ``cap_w`` after ``delay_s``."""

    node: int
    cap_w: float
    delay_s: float = 0.0


@dataclass(frozen=True)
class Wake:
    """Ask the simulator to call ``on_wake(token, at)`` at time ``at``."""

    at: float
    token: Hashable = None


Action = Union[SetCap, Wake]


@dataclass(frozen=True)
class ClusterView:
    """Read-only cluster description handed to a policy at ``on_start``.

    ``graph`` is included so clairvoyant / solver-backed policies can see
    the whole workload; online policies should restrict themselves to the
    report stream (that is the point of the paper's §V controller).
    """

    graph: JobDependencyGraph
    node_ids: Tuple[int, ...]
    specs: Mapping[int, NodeSpec]
    bound_w: float
    latency_s: float

    @property
    def p_o(self) -> float:
        """The nominal equal share P/n (Algorithm 1 line 3)."""
        return self.bound_w / len(self.node_ids)

    def equal_share(self, bound_w: float) -> float:
        return bound_w / len(self.node_ids)

    def clamp(self, node: int, p_w: float) -> float:
        """Clamp a grant to the node's physical envelope [duty floor, p_max].

        Granting more than p_max merely strands budget; granting less than
        the duty floor would halt the node (the translator clamps anyway).
        """
        lut = self.specs[node].lut
        return min(max(p_w, cap_floor_w(lut)), lut.p_max)


class PowerPolicy:
    """Base class / protocol for power-distribution policies.

    Subclasses must be constructible from keyword arguments only (that is
    what the registry and the sweep engine rely on) and must set ``name``.
    """

    name: str = "?"

    def on_start(self, view: ClusterView) -> List[Action]:
        return []

    def on_report(self, report: ReportMessage, now: float) -> List[Action]:
        return []

    def on_job_start(self, job: Job, now: float) -> List[Action]:
        return []

    def on_job_complete(self, job: Job, now: float) -> List[Action]:
        return []

    def on_bound_change(self, bound_w: float, now: float) -> List[Action]:
        return []

    def on_wake(self, token: Hashable, now: float) -> List[Action]:
        return []

    def stats(self) -> Dict[str, int]:
        """Controller-plane counters surfaced into ``SimResult``."""
        return {"messages": 0, "distributes": 0, "suppressed": 0}
