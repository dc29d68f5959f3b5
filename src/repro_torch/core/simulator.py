"""Discrete-event cluster simulator (paper §VI).

The port's copy of the reference's ``repro.core.simulator``; its policies
are the port's own (:mod:`repro_torch.policies`, imported where they are
used, as in the reference).  Executes a job dependency graph on a
modelled cluster under a pluggable
:class:`~repro_torch.policies.base.PowerPolicy` resolved from the
string-keyed registry (``equal-share``, ``ilp``, ``heuristic``,
``countdown``, ``oracle``, ...).  The simulator owns the
physics — progress integration at the rate implied by each node's
current operating point, energy accounting, the event heap — and feeds
the policy events (state-transition reports, job starts/completions,
cluster-bound arrivals, timers); the policy answers with cap-change and
timer actions.  Mid-job cap changes take effect immediately (that is the
whole point of power redistribution).

Event kinds: job completions (``finish``), delayed cap grants (``cap``),
policy timers (``wake``), and cluster power-bound arrivals (``bound``).
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import (Dict, Iterable, List, Optional, Sequence, Set, Tuple,
                    Union)

from .block_detector import blocked_report, running_report
from .graph import Job, JobDependencyGraph, JobId
from .ilp import PowerAssignment
from .power import NodeSpec, OperatingPoint, op_rate, operating_point
from .results import OVER_BUDGET_RTOL, SimResult

class _NState:
    RUNNING, BLOCKED, DONE = "running", "blocked", "done"


@dataclass
class _NodeRT:
    nid: int
    spec: NodeSpec
    jobs: List[Job]
    ptr: int = 0
    state: str = _NState.BLOCKED
    cap_w: float = 0.0
    op: Optional[OperatingPoint] = None
    remaining: float = 0.0
    last_update: float = 0.0
    version: int = 0

    @property
    def current(self) -> Optional[Job]:
        return self.jobs[self.ptr] if self.ptr < len(self.jobs) else None


class Simulator:
    """Policy-agnostic discrete-event simulator.

    ``policy`` is a registry key or a pre-built ``PowerPolicy`` instance.
    ``assignment`` is forwarded to the ``ilp`` policies for backwards
    compatibility with the pre-refactor call signature.

    ``trace_every`` bounds :attr:`SimResult.power_trace` growth during
    long sweeps: ``0.0`` (default) records every accounting point as
    before, a positive value records at most one sample per that many
    simulated seconds, and ``None`` disables the trace entirely.

    ``bound_schedule`` is an iterable of ``(time, new_bound_w)`` power
    bound arrivals; each triggers the policy's ``on_bound_change`` hook.

    ``node_trace=True`` additionally records per-node power samples
    into :attr:`SimResult.node_power_trace` at the :attr:`power_trace`
    cadence (so it is likewise disabled by ``trace_every=None``); off
    by default because sweeps only need the cluster total.
    """

    def __init__(self, graph: JobDependencyGraph, specs: Sequence[NodeSpec],
                 cluster_bound_w: float,
                 policy: Union[str, "PowerPolicy"] = "equal-share",
                 assignment: Optional[PowerAssignment] = None,
                 latency_s: float = 0.05, max_events: int = 5_000_000,
                 trace_every: Optional[float] = 0.0,
                 bound_schedule: Iterable[Tuple[float, float]] = (),
                 node_trace: bool = False):
        graph.topological_order()
        self.graph = graph
        self.node_ids = graph.nodes
        if len(specs) != len(self.node_ids):
            raise ValueError("one NodeSpec per graph node required")
        self.specs = {nid: specs[k] for k, nid in enumerate(self.node_ids)}
        self.bound = cluster_bound_w
        self.latency = latency_s
        self.max_events = max_events
        self.policy = self._resolve_policy(policy, assignment)
        self.policy_name = getattr(self.policy, "name", None) or str(policy)

        self.p_o = cluster_bound_w / len(self.node_ids)
        self.completed: Set[JobId] = set()
        self.children = graph.children()
        self.waiters: Dict[JobId, List[int]] = {}

        self.nodes: Dict[int, _NodeRT] = {}
        for nid in self.node_ids:
            rt = _NodeRT(nid=nid, spec=self.specs[nid],
                         jobs=graph.node_jobs(nid))
            rt.cap_w = self.p_o
            rt.op = operating_point(rt.spec.lut, rt.cap_w)
            self.nodes[nid] = rt

        self._heap: List[Tuple[float, int, Tuple]] = []
        self._seq = itertools.count()
        self._now = 0.0
        self._trace_every = trace_every
        self._node_trace = node_trace
        self._power_trace: List[Tuple[float, float]] = []
        self._node_power_trace: List[Tuple[float, Tuple[float, ...]]] = []
        self._energy = 0.0
        self._peak = 0.0
        self._over_budget_time = 0.0
        self._last_power_t = 0.0
        self._last_power = 0.0
        self.job_starts: Dict[JobId, float] = {}
        self.job_ends: Dict[JobId, float] = {}
        for t_b, new_bound in bound_schedule:
            self._push(float(t_b), ("bound", float(new_bound)))

    @staticmethod
    def _resolve_policy(policy, assignment):
        from repro_torch.policies import PowerPolicy, get_policy

        if isinstance(policy, PowerPolicy):
            return policy
        kwargs = {}
        if assignment is not None:
            kwargs["assignment"] = assignment
        return get_policy(policy, **kwargs)

    # ------------------------------------------------------------- plumbing
    def _push(self, t: float, ev: Tuple) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), ev))

    def _node_power(self, rt: _NodeRT) -> float:
        if rt.state == _NState.RUNNING:
            return rt.op.power_w
        return rt.spec.lut.idle_w

    def _account_power(self, t: float) -> None:
        """Integrate energy up to t, then snapshot instantaneous power."""
        dt = t - self._last_power_t
        if dt > 0:
            self._energy += self._last_power * dt
            if self._last_power > self.bound * (1 + OVER_BUDGET_RTOL) \
                    + 1e-9:
                self._over_budget_time += dt
        p_nodes: Optional[Tuple[float, ...]] = None
        if self._node_trace:
            p_nodes = tuple(self._node_power(self.nodes[nid])
                            for nid in self.node_ids)
            p = sum(p_nodes)
        else:
            p = sum(self._node_power(rt) for rt in self.nodes.values())
        self._last_power_t = t
        self._last_power = p
        self._peak = max(self._peak, p)
        if self._trace_every is None:
            return
        if self._power_trace and self._power_trace[-1][0] == t:
            self._power_trace[-1] = (t, p)
            if p_nodes is not None:
                self._node_power_trace[-1] = (t, p_nodes)
        elif (self._trace_every == 0.0 or not self._power_trace
              or t - self._power_trace[-1][0] >= self._trace_every):
            self._power_trace.append((t, p))
            if p_nodes is not None:
                self._node_power_trace.append((t, p_nodes))

    # -------------------------------------------------------- policy actions
    def _apply_actions(self, actions, t: float) -> None:
        from repro_torch.policies import SetCap, Wake

        for act in actions:
            if isinstance(act, SetCap):
                if act.delay_s > 0:
                    self._push(t + act.delay_s,
                               ("cap", act.node, act.cap_w))
                else:
                    self._apply_cap(self.nodes[act.node], act.cap_w, t)
            elif isinstance(act, Wake):
                self._push(act.at, ("wake", act.token))
            else:
                raise TypeError(f"unknown policy action {act!r}")

    def _apply_cap(self, rt: _NodeRT, cap: float, t: float) -> None:
        self._update_progress(rt, t)
        rt.cap_w = cap
        new_op = operating_point(rt.spec.lut, cap)
        if new_op != rt.op:
            rt.op = new_op
            self._reschedule(rt, t)
        self._account_power(t)

    # ---------------------------------------------------------- job control
    def _rate(self, rt: _NodeRT, job: Job) -> float:
        return op_rate(job, rt.op, rt.spec.lut.f_max, rt.spec.speed)

    def _deps_ready(self, job: Job) -> bool:
        return all(d in self.completed for d in job.deps)

    def _start_job(self, rt: _NodeRT, t: float) -> None:
        job = rt.current
        assert job is not None
        rt.state = _NState.RUNNING
        rt.remaining = job.work
        rt.last_update = t
        self.job_starts[job.job_id] = t
        # The policy may re-cap the node for this specific job (e.g. the
        # static ILP assignment); zero-delay caps land before scheduling.
        self._apply_actions(self.policy.on_job_start(job, t), t)
        self._reschedule(rt, t)

    def _update_progress(self, rt: _NodeRT, t: float) -> None:
        job = rt.current
        if rt.state != _NState.RUNNING or job is None or job.work <= 0:
            rt.last_update = t
            return
        rate = self._rate(rt, job)
        rt.remaining = max(0.0, rt.remaining - rate * (t - rt.last_update))
        rt.last_update = t

    def _reschedule(self, rt: _NodeRT, t: float) -> None:
        job = rt.current
        if rt.state != _NState.RUNNING or job is None:
            return
        rt.version += 1
        rate = self._rate(rt, job)
        dur = rt.remaining / rate if rate > 0 else 0.0
        self._push(t + dur, ("finish", rt.nid, rt.version))

    def _block_node(self, rt: _NodeRT, t: float, blockers: Set[int],
                    done: bool = False) -> None:
        p_g = rt.op.power_w - rt.spec.lut.idle_w  # §V-A power gain
        rt.state = _NState.DONE if done else _NState.BLOCKED
        self._apply_actions(
            self.policy.on_report(blocked_report(rt.nid, blockers, p_g, t),
                                  t), t)

    def _try_advance(self, rt: _NodeRT, t: float) -> None:
        """Start the node's next job, or block/finish."""
        job = rt.current
        if job is None:
            if rt.state != _NState.DONE:
                self._block_node(rt, t, set(), done=True)
            return
        if self._deps_ready(job):
            was_blocked = rt.state == _NState.BLOCKED
            self._start_job(rt, t)
            if was_blocked:
                self._apply_actions(
                    self.policy.on_report(running_report(rt.nid, t), t), t)
        else:
            pending = [d for d in job.deps if d not in self.completed]
            for d in pending:
                self.waiters.setdefault(d, []).append(rt.nid)
            blockers = {d[0] for d in pending if d[0] != rt.nid}
            self._block_node(rt, t, blockers)

    # -------------------------------------------------------------- run loop
    def run(self) -> SimResult:
        t = 0.0
        from repro_torch.policies import ClusterView

        view = ClusterView(graph=self.graph, node_ids=tuple(self.node_ids),
                           specs=dict(self.specs), bound_w=self.bound,
                           latency_s=self.latency)
        self._account_power(t)
        self._apply_actions(self.policy.on_start(view), t)
        for rt in self.nodes.values():
            self._try_advance(rt, t)
        self._account_power(t)

        events = 0
        while self._heap:
            events += 1
            if events > self.max_events:
                raise RuntimeError("simulator exceeded max events "
                                   f"({self.max_events}); livelock?")
            t, _seq, ev = heapq.heappop(self._heap)
            self._now = t
            kind = ev[0]
            if kind == "finish":
                _, nid, version = ev
                rt = self.nodes[nid]
                if version != rt.version or rt.state != _NState.RUNNING:
                    continue  # stale (rescheduled) event
                job = rt.current
                self._update_progress(rt, t)
                if rt.remaining > 1e-9:   # rate changed since scheduling
                    self._reschedule(rt, t)
                    continue
                self.completed.add(job.job_id)
                self.job_ends[job.job_id] = t
                rt.ptr += 1
                self._apply_actions(self.policy.on_job_complete(job, t), t)
                self._try_advance(rt, t)
                # wake waiters of this job
                for wnid in self.waiters.pop(job.job_id, []):
                    wrt = self.nodes[wnid]
                    if wrt.state == _NState.BLOCKED and wrt.current is not None \
                            and self._deps_ready(wrt.current):
                        self._try_advance(wrt, t)
                self._account_power(t)
                if len(self.completed) == len(self.graph):
                    break  # drain: only in-flight messages remain
            elif kind == "wake":
                _, token = ev
                self._apply_actions(self.policy.on_wake(token, t), t)
            elif kind == "cap":
                _, nid, cap = ev
                self._apply_cap(self.nodes[nid], cap, t)
            elif kind == "bound":
                _, new_bound = ev
                self._account_power(t)
                self.bound = new_bound
                self.p_o = new_bound / len(self.node_ids)
                self._apply_actions(
                    self.policy.on_bound_change(new_bound, t), t)
            else:  # pragma: no cover
                raise AssertionError(f"unknown event {kind}")

        if len(self.completed) != len(self.graph):
            missing = set(self.graph.jobs) - self.completed
            raise RuntimeError(f"deadlock: jobs never ran: "
                               f"{sorted(missing)[:8]}")
        makespan = max(self.job_ends.values(), default=0.0)
        # close the energy integral at makespan
        self._account_power(makespan)
        stats = self.policy.stats()
        return SimResult(
            policy=self.policy_name,
            makespan=makespan,
            energy_j=self._energy,
            avg_power_w=self._energy / makespan if makespan > 0 else 0.0,
            peak_power_w=self._peak,
            over_budget_time=self._over_budget_time,
            messages=int(stats.get("messages", 0)),
            distributes=int(stats.get("distributes", 0)),
            suppressed_reports=int(stats.get("suppressed", 0)),
            power_trace=self._power_trace,
            job_starts=self.job_starts,
            job_ends=self.job_ends,
            node_power_trace=self._node_power_trace,
        )


def simulate(graph: JobDependencyGraph, specs: Sequence[NodeSpec],
             cluster_bound_w: float,
             policy: Union[str, "PowerPolicy"] = "equal-share",
             assignment: Optional[PowerAssignment] = None,
             latency_s: float = 0.05,
             trace_every: Optional[float] = 0.0,
             bound_schedule: Iterable[Tuple[float, float]] = (),
             node_trace: bool = False) -> SimResult:
    """One-call façade used by benchmarks and tests."""
    return Simulator(graph, specs, cluster_bound_w, policy=policy,
                     assignment=assignment, latency_s=latency_s,
                     trace_every=trace_every,
                     bound_schedule=bound_schedule,
                     node_trace=node_trace).run()
