"""Vectorized policy adapters for the batch simulator.

The port's copy of the reference's ``repro.policies.vector``.  The
event-driven :class:`~repro_torch.policies.base.PowerPolicy` protocol
trades messages one node at a time; the float64 batch backend
(:mod:`repro_torch.core.batchsim`) instead advances *B* scenarios x *N*
nodes as arrays and asks a :class:`VectorPolicy` for whole cap
*matrices*.  A vector policy is registered in its own string-keyed table
(mirroring the event registry) so
:class:`~repro_torch.core.sweep.SweepEngine` can route a
scenario to the vector backend exactly when its policy key has a vector
implementation; everything else falls back to the event simulator.

``exact`` declares the contract with the differential test suite:

* ``exact=True`` — the vector semantics reproduce the event simulator's
  answers to floating-point/timestep tolerance (``equal-share``, ``ilp``,
  ``ilp-makespan``, ``oracle``: their cap decisions depend only on state
  transitions, which the batch backend resolves at exact event times).
* ``exact=False`` — a native vectorization whose control plane is
  quantized to the timestep (``heuristic``: report/distribute latency is
  rounded to whole ticks and the ski-rental debounce is dropped), so it
  tracks the event policy's behaviour but not its exact makespans.

Hooks receive the live :class:`~repro_torch.core.batchsim.BatchSimulator` and
mutate ``sim.cap`` (a ``(B, N)`` watt matrix) in place; the simulator
re-derives operating points from ``sim.cap`` every segment.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.power import LUTTable

from .assign import resolve_assignments
from .registry import PolicyRegistry


class VectorPolicy:
    """Base class for batched policies (see module docstring).

    Subclasses must be constructible from keyword arguments only and set
    ``name``.  ``wants_ticks=True`` asks the simulator for an ``on_tick``
    call every ``dt`` of simulated time (the only quantized hook — the
    others fire at exact event times).
    """

    name: str = "?"
    exact: bool = True
    wants_ticks: bool = False

    def setup(self, sim) -> np.ndarray:
        """Initial ``(B, N)`` caps; default is the nominal share P/n —
        per-row ``n`` being the row's *real* node count ``sim.n_active``
        (phantom padding lanes never run, so their cap is inert)."""
        nominal = sim.bounds / sim.n_active
        return np.repeat(nominal[:, None], sim.n_nodes, axis=1)

    def on_job_start(self, sim, rows: np.ndarray, lanes: np.ndarray,
                     jobs: np.ndarray) -> None:
        """Jobs ``jobs[i]`` started on ``(rows[i], lanes[i])`` at the rows'
        current times.  May write ``sim.cap[rows, lanes]``."""

    def on_transition(self, sim, rows: np.ndarray) -> None:
        """Some node in each of ``rows`` changed state (start / block /
        complete) at the rows' current times."""

    def on_tick(self, sim, rows: np.ndarray) -> None:
        """A ``dt`` boundary passed for boolean row mask ``rows``."""

    def on_bound_change(self, sim, rows: np.ndarray) -> None:
        """A scheduled cluster-bound arrival fired for boolean row mask
        ``rows``; ``sim.bounds`` already holds the new values.  Default
        is a no-op — matching the event protocol, where only policies
        that opt in react to ``on_bound_change`` (the static ILP caps,
        for instance, deliberately stay put)."""


_REGISTRY = PolicyRegistry(VectorPolicy, "vector")


def register_vector_policy(name: str, *aliases: str):
    """Class decorator: register a vector-policy factory under ``name``."""
    return _REGISTRY.register(name, *aliases)


def get_vector_policy(name: str, **kwargs) -> "VectorPolicy":
    return _REGISTRY.get(name, **kwargs)


def has_vector_policy(name: str) -> bool:
    return name in _REGISTRY


def vector_policies() -> List[str]:
    return _REGISTRY.names()


@register_vector_policy("equal-share", "equal_share")
class VectorEqualShare(VectorPolicy):
    """Static P/n caps — the base-class setup is almost the whole
    policy; its only dynamic behaviour is re-splitting a changed
    cluster bound evenly (mirroring the event policy)."""

    name = "equal-share"

    def on_bound_change(self, sim, rows) -> None:
        sim.cap[rows] = (sim.bounds[rows] / sim.n_active[rows])[:, None]


@register_vector_policy("ilp")
class VectorIlpStatic(VectorPolicy):
    """Static per-job caps from the paper ILP, applied at job start.

    ``assignments`` is one pre-solved
    :class:`~repro_torch.core.ilp.PowerAssignment` per batch row (what the
    sweep engine's shared-setup cache provides); ``None`` entries (or no
    list at all) are solved at ``setup`` time, once per unique bound.
    """

    name = "ilp"
    use_makespan_milp = False

    def __init__(self, assignments: Optional[Sequence] = None,
                 time_limit: float = 60.0):
        self.assignments = assignments
        self.time_limit = time_limit
        self._caps_job: Optional[np.ndarray] = None   # (B, J)

    def _solve(self, sim, row: int, bound_w: float):
        from repro_torch.core.ilp import build_makespan_milp, solve_paper_ilp

        solver = (build_makespan_milp if self.use_makespan_milp
                  else solve_paper_ilp)
        return solver(sim.row_graphs[row], sim.row_specs[row], bound_w,
                      time_limit=self.time_limit)

    def setup(self, sim) -> np.ndarray:
        resolved = resolve_assignments(
            sim.bounds, self.assignments,
            lambda row, bound: self._solve(sim, row, bound),
            graphs=sim.row_graphs)
        caps_job = np.zeros((sim.n_rows, sim.n_jobs_total))
        for b, assignment in enumerate(resolved):
            for k, jid in enumerate(sim.row_job_ids[b]):
                caps_job[b, k] = assignment.bounds_w[jid]
        self._caps_job = caps_job
        return super().setup(sim)

    def on_job_start(self, sim, rows, lanes, jobs) -> None:
        sim.cap[rows, lanes] = self._caps_job[rows, jobs]


@register_vector_policy("ilp-makespan")
class VectorIlpMakespan(VectorIlpStatic):
    name = "ilp-makespan"
    use_makespan_milp = True

    def __init__(self, assignments: Optional[Sequence] = None,
                 time_limit: float = 120.0):
        super().__init__(assignments=assignments, time_limit=time_limit)


def batched_waterfill(running: np.ndarray, budget: np.ndarray,
                      table: LUTTable) -> np.ndarray:
    """Vectorized oracle water-fill: split ``budget[b]`` equally over each
    row's running nodes, clamp saturated nodes at their ``p_max``,
    re-spread the surplus until absorbed.  Non-running nodes get the
    cap floor (they draw idle power regardless).  Row-for-row identical
    to ``OraclePolicy._waterfill`` + ``ClusterView.clamp``.  ``table``
    leaves may be shared ``(N,)`` or per-row ``(B, N)`` (a padded
    mixed-shape batch; phantom lanes carry ``p_max = cap_floor = 0`` and
    are never running, so they neither attract nor strand budget)."""
    n_rows, n_nodes = running.shape
    floor = np.broadcast_to(table.cap_floor, running.shape)
    p_max = np.broadcast_to(table.p_max, running.shape)
    caps = floor.copy()
    open_ = running.copy()
    rem = budget.astype(float).copy()
    for _ in range(n_nodes):
        n_open = open_.sum(axis=1)
        live = n_open > 0
        if not live.any():
            break
        share = np.where(live, rem / np.maximum(n_open, 1), 0.0)
        sat = open_ & (p_max <= share[:, None] + 1e-12)
        finished = live & ~sat.any(axis=1)
        if finished.any():
            m = open_ & finished[:, None]
            share_b = np.broadcast_to(share[:, None], (n_rows, n_nodes))
            caps = np.where(m, np.clip(share_b, floor, p_max), caps)
            open_ &= ~finished[:, None]
        if sat.any():
            caps = np.where(sat, p_max, caps)
            rem = rem - (sat * p_max).sum(axis=1)
            open_ &= ~sat
    return caps


class VectorStaticCaps(VectorPolicy):
    """Externally supplied caps, held fixed: the *exact* evaluation seam
    for :mod:`repro_torch.diff.optimize`.  Gradient-descend a cap vector
    through the soft simulator, then measure its true makespan here.

    Deliberately *not* in the registry: it is unconstructible without a
    cap vector (the registry contract is kwargless construction).  Pass
    an instance straight to ``simulate_batch(policy=...)``.

    ``caps`` is ``(N,)`` (shared by every row) or ``(B, N)``.  A
    piecewise-constant cap *schedule* is evaluated by pairing this policy
    with a constant-bound ``bound_schedules`` entry per knot and swapping
    ``caps_schedule[k]`` in at the k-th arrival (``on_bound_change``),
    which forces a wave boundary at each knot time.
    """

    name = "static-caps"

    def __init__(self, caps=None, caps_schedule=None):
        if caps is None and caps_schedule is None:
            raise ValueError("static-caps needs caps= or caps_schedule=")
        self.caps = None if caps is None else np.asarray(caps, dtype=float)
        self.caps_schedule = (None if caps_schedule is None else
                              np.asarray(caps_schedule, dtype=float))
        self._knot: Optional[np.ndarray] = None    # (B,) next schedule row

    def setup(self, sim) -> np.ndarray:
        first = self.caps if self.caps is not None else self.caps_schedule[0]
        self._knot = np.zeros(sim.n_rows, dtype=np.int64)
        return np.broadcast_to(first, (sim.n_rows, sim.n_nodes)).copy()

    def on_bound_change(self, sim, rows) -> None:
        if self.caps_schedule is None:
            return                      # truly static: ignore bound moves
        self._knot[rows] = np.minimum(self._knot[rows] + 1,
                                      len(self.caps_schedule) - 1)
        sim.cap[rows] = self.caps_schedule[self._knot[rows]]


@register_vector_policy("oracle")
class VectorOracle(VectorPolicy):
    """Zero-latency clairvoyant water-filling, batched.

    State transitions in the batch backend happen at exact event times,
    so re-solving on ``on_transition`` reproduces the event oracle's cap
    trajectory exactly — this policy is ``exact`` despite being fully
    dynamic.
    """

    name = "oracle"

    def _refill(self, sim, rows) -> None:
        running = sim.running[rows]
        idle_draw = ((~running) * sim.idle_w[rows]).sum(axis=1)
        budget = sim.bounds[rows] - idle_draw
        table = sim.table
        if table.state_p.ndim == 3:        # per-row tables: slice the rows
            table = LUTTable(**{k: getattr(table, k)[rows]
                                for k in LUTTable.__dataclass_fields__})
        sim.cap[rows] = batched_waterfill(running, budget, table)

    def on_transition(self, sim, rows) -> None:
        self._refill(sim, rows)

    def on_bound_change(self, sim, rows) -> None:
        # the event oracle re-resolves on bound arrivals (force=True)
        self._refill(sim, rows)


@register_vector_policy("heuristic")
class VectorOnlineHeuristic(VectorPolicy):
    """Native vectorization of the online redistribution controller.

    Each tick the controller observes the blocked/running masks and
    water-fills the cluster bound (minus blocked nodes' idle draw) over
    the running nodes — the steady state Algorithm 1 converges to — and
    the resulting cap matrix is *applied* ``2 * latency_s`` later
    (report + distribute one-way latencies), rounded to whole ticks.
    A node that unblocks inside that window keeps its boosted cap until
    the controller catches up, reproducing the paper's documented
    transient surges above the bound.  The ski-rental debounce is not
    modelled, so this is ``exact=False``: it tracks the event heuristic's
    behaviour and speedups, not its exact makespans.
    """

    name = "heuristic"
    exact = False
    wants_ticks = True

    def __init__(self):
        self._delay_ticks = 1
        self._buf: Optional[np.ndarray] = None   # (delay+1, B, N) ring
        self._ticks: Optional[np.ndarray] = None  # (B,) per-row tick count

    def setup(self, sim) -> np.ndarray:
        self._delay_ticks = max(1, int(round(2.0 * sim.latency_s / sim.dt)))
        self._buf = np.zeros((self._delay_ticks + 1, sim.n_rows,
                              sim.n_nodes))
        self._ticks = np.zeros(sim.n_rows, dtype=np.int64)
        return super().setup(sim)

    def on_tick(self, sim, rows) -> None:
        # The delay is counted in each row's OWN ticks (rows tick at the
        # same absolute times but stop when done), so a scenario's answer
        # does not depend on which other bounds share its batch.
        # sim.bounds is the rows' *current* bound, so a scheduled bound
        # change propagates to the caps with the usual ring-buffer delay
        # (the controller reacts one report round-trip later).
        running = sim.running
        idle_draw = ((~running) * sim.idle_w).sum(axis=1)
        target = batched_waterfill(running, sim.bounds - idle_draw,
                                   sim.table)
        idx = np.nonzero(rows)[0]
        depth = self._delay_ticks + 1
        self._buf[self._ticks[idx] % depth, idx] = target[idx]
        self._ticks[idx] += 1
        ripe = idx[self._ticks[idx] > self._delay_ticks]
        if ripe.size:
            slot = (self._ticks[ripe] - 1 - self._delay_ticks) % depth
            sim.cap[ripe] = self._buf[slot, ripe]
