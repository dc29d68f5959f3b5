"""Vectorized batch simulator: B scenarios x N nodes as one float64
numpy program.

The port's copy of the reference's ``repro.core.batchsim`` (the sweep's
``executor="vector"`` backend and the torch executor's fallback).  The
geometry builders it shares with the torch engine live in
:mod:`repro_torch.core.arrays`; the reference's piecewise-linear LUT
option belongs to its differentiable layer and is not copied.

The discrete-event :class:`~repro_torch.core.simulator.Simulator` walks
one scenario's event heap in pure Python; this backend advances a whole
*batch* of scenarios together: per-node state lives in ``(B, N)`` arrays
(current-job pointer, remaining work, running mask, cap), job
bookkeeping in ``(B, J)`` arrays, and the power-to-frequency translation
is one batched LUT gather
(:func:`repro_torch.core.power.batched_operating_point`).

Two batch layouts share the same wave loop:

* **shared** (:class:`BatchSimulator` constructor) — one graph, one
  cluster, B cluster bounds, the geometry broadcast over the rows;
* **padded** (:meth:`BatchSimulator.padded`) — B *different* (graph,
  cluster) rows stacked into one envelope; phantom job slots carry zero
  work and are born completed, phantom node lanes draw zero idle power,
  so a padded row's physics is the same as running it unpadded.

Time advances in *waves*: each iteration every active row jumps to its
own earliest next event — the minimum over its lanes' job-completion
times, the next policy tick boundary (multiples of ``dt``, only for
policies with ``wants_ticks``), and the row's next scheduled
cluster-bound change (``bound_schedules``).  For policies whose cap
decisions depend only on state transitions (equal-share, ilp, oracle)
the backend reproduces the event simulator up to float accumulation
order; ``dt`` matters only for tick-quantized control planes.
"""

from __future__ import annotations

import math
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.obs import trace as obs_trace

from .arrays import (build_graph_arrays, pad_bound_schedules,
                     stack_graph_arrays, validate_padded_items)
from .graph import JobDependencyGraph
from .power import (LUTTable, NodeSpec, batched_operating_point,
                    batched_rates)
from .results import OVER_BUDGET_RTOL, SimResult

#: Remaining-work threshold below which a job counts as complete.  Wave
#: advancement subtracts exactly ``rate * (remaining / rate)`` for the
#: earliest lane, so residues are pure float noise (~1e-13 at class-C
#: work scales), far under this.
_DONE_EPS = 1e-9


class WaveCandidates(NamedTuple):
    """One wave's candidate next-event times, measured from the rows'
    current instants (:meth:`BatchSimulator.wave_candidates`).

    This is THE event-selection seam of the wave loop: the advance is
    ``min(t_comp, t_tick, t_bound)`` per row, a hard minimum whose
    winner reorders discontinuously under cap perturbations.
    """

    t_fin: np.ndarray         # (B, N) per-lane completion times (inf idle)
    t_comp: np.ndarray        # (B,) earliest completion per row
    t_tick: np.ndarray        # (B,) time to the next policy tick (inf)
    next_tick: np.ndarray     # (B,) absolute next tick boundary
    t_bound: np.ndarray       # (B,) time to the next bound arrival (inf)
    next_bound_t: np.ndarray  # (B,) absolute next arrival time
    sched_live: np.ndarray    # (B,) row still has scheduled arrivals


#: Loop-state multiplier for :func:`estimate_row_bytes`: the loop's
#: state, its outputs and the transfer buffer live alongside the inputs,
#: so the live working set is a small multiple of one row's state
#: footprint (the reference's factor, kept so both plan alike).
_STATE_FACTOR = 3.0


def estimate_row_bytes(pad_dims: Tuple[int, int, int, int, int],
                       itemsize: int = 4) -> int:
    """Bytes one batch row occupies on device under a padding envelope.

    ``pad_dims`` is the bucket envelope ``(N, J, K, D, S)`` (see
    :func:`~repro_torch.core.arrays.stack_graph_arrays`); ``itemsize``
    is the element width the backend runs at (4 for the torch engine's
    float32/int32, 8 for the numpy backend's float64).  The model sums
    the per-row geometry (``BatchArrays`` leaves plus the ``(S, N)`` /
    ``(1, N)`` LUT step tables) and the wave-loop carry (lane state, job
    bookkeeping, start/end stamps) scaled by a double-buffering factor.  It is intentionally a slight
    over-estimate: the sweep engine's memory-aware planner uses it to
    split oversized buckets *before* dispatch, where guessing low means
    an allocator failure mid-sweep and guessing high merely costs an
    extra (pipelined) bucket.
    """
    n, j, k, d, s = (int(x) for x in pad_dims)
    jp = j + 1
    geometry = (
        2 * jp            # work_pad, rho_pad
        + n * k           # node_seq
        + jp * d          # deps_pad
        + jp              # completed0
        + 2 * s * n       # state_p / state_f step tables
        + 7 * n           # lane vectors (idle/f_min/f_nom/span/...)
        + 4               # bounds + padded schedule entries (amortized)
    )
    carry = (
        4 * n             # ptr / running / remaining / caps
        + 3 * jp          # completed / start_t / end_t
        + 16              # row scalars (t, bound, energy, peak, ...)
    )
    return int(itemsize * (geometry + _STATE_FACTOR * carry))


class BatchSimulator:
    """One batch: B scenario rows advanced in lock-step waves.

    The plain constructor is the *shared* layout — one graph, one
    cluster, one policy, B cluster bounds; :meth:`padded` is the
    *mixed-shape* layout — B (graph, cluster) rows padded to a common
    envelope (see the module docstring for the masking semantics).

    ``policy`` is a vector-registry key or a pre-built
    :class:`~repro_torch.policies.vector.VectorPolicy`.  ``dt`` is the control
    tick for ``wants_ticks`` policies (pure event-driven policies ignore
    it).  ``bound_schedules`` is one iterable of ``(time_s, bound_w)``
    arrivals per row (or ``None``): each arrival replaces the row's
    cluster bound at exactly that simulated time and fires the policy's
    ``on_bound_change`` hook — the batched form of the event simulator's
    ``bound_schedule``.  ``trace_every`` has the event simulator's
    semantics — ``None`` retains no per-row power trace, ``0.0`` records
    every segment, a positive value records at most one sample per that
    many simulated seconds — but the *default* is ``None``, not the
    event simulator's ``0.0``: this backend exists for big sweeps, where
    retained traces are the memory hazard ``trace_every`` was invented
    to cap.

    Public attributes a :class:`~repro_torch.policies.vector.VectorPolicy`
    may rely on: ``bounds`` (the rows' *current* cluster bounds —
    mutated by bound-schedule arrivals), ``cap`` (the live ``(B, N)``
    cap matrix), ``running``/``completed``/``row_t`` state arrays,
    ``idle_w`` (``(B, N)`` idle draw, zero on phantom lanes),
    ``n_active`` (``(B,)`` real node counts), ``row_graphs`` /
    ``row_specs`` / ``row_job_ids`` (per-row workload descriptions), and
    ``table`` / ``dt`` / ``latency_s``.
    """

    def __init__(self, graph: JobDependencyGraph, specs: Sequence[NodeSpec],
                 bounds: Sequence[float],
                 policy: Union[str, "VectorPolicy"] = "equal-share",
                 dt: float = 0.05, latency_s: float = 0.05,
                 trace_every: Optional[float] = None,
                 max_steps: int = 1_000_000,
                 bound_schedules: Optional[Sequence] = None,
                 smooth_lut: bool = False,
                 **policy_kwargs):
        graph.topological_order()          # validates the DAG
        self.graph = graph
        self.node_ids = graph.nodes
        if len(specs) != len(self.node_ids):
            raise ValueError("one NodeSpec per graph node required")
        self.specs = list(specs)
        b = self._setup_run_params(bounds, policy, dt, latency_s,
                                   trace_every, max_steps, policy_kwargs,
                                   bound_schedules, smooth_lut)

        # ---- static graph arrays, broadcast (zero-copy) over the rows
        arrays = build_graph_arrays(graph, self.specs)
        self.arrays = arrays
        self.job_ids = list(arrays.job_ids)
        j1, (n, k) = len(arrays.work_pad), arrays.node_seq.shape
        self._init_geometry(
            work_pad=np.broadcast_to(arrays.work_pad, (b, j1)),
            rho_pad=np.broadcast_to(arrays.rho_pad, (b, j1)),
            node_seq=np.broadcast_to(arrays.node_seq, (b, n, k)),
            deps_pad=np.broadcast_to(arrays.deps_pad,
                                     (b,) + arrays.deps_pad.shape),
            table=arrays.table,
            row_job_ids=(tuple(arrays.job_ids),) * b,
            n_jobs_row=np.full(b, arrays.n_jobs),
            n_active=np.full(b, n),
            row_graphs=[graph] * b,
            row_specs=[self.specs] * b)

    @classmethod
    def padded(cls, items: Sequence[Tuple[JobDependencyGraph,
                                          Sequence[NodeSpec]]],
               bounds: Sequence[float],
               policy: Union[str, "VectorPolicy"] = "equal-share",
               dt: float = 0.05, latency_s: float = 0.05,
               trace_every: Optional[float] = None,
               max_steps: int = 1_000_000,
               bound_schedules: Optional[Sequence] = None,
               pad_dims: Optional[Tuple[int, int, int, int, int]] = None,
               smooth_lut: bool = False,
               **policy_kwargs) -> "BatchSimulator":
        """Build a mixed-shape batch: row ``b`` runs ``items[b]`` under
        ``bounds[b]`` (one (graph, specs) pair and one bound per row).

        ``pad_dims`` optionally fixes the ``(N, J, K, D, S)`` padding
        envelope (e.g. the sweep engine's power-of-two buckets); by
        default the rows' tight maxima are used.
        """
        self = cls.__new__(cls)
        items, bounds = validate_padded_items(items, bounds)
        self.graph = None                  # no single shared graph
        self.node_ids = None
        self.specs = None
        self.job_ids = None
        self._setup_run_params(bounds, policy, dt, latency_s, trace_every,
                               max_steps, policy_kwargs, bound_schedules,
                               smooth_lut)
        arrays = stack_graph_arrays(items, pad_dims)
        self.arrays = arrays
        self._init_geometry(
            work_pad=arrays.work_pad, rho_pad=arrays.rho_pad,
            node_seq=arrays.node_seq, deps_pad=arrays.deps_pad,
            table=arrays.table, row_job_ids=arrays.row_job_ids,
            n_jobs_row=arrays.n_jobs_row, n_active=arrays.n_active,
            row_graphs=[g for g, _ in items],
            row_specs=[list(sp) for _, sp in items])
        return self

    # ------------------------------------------------------- construction
    def _setup_run_params(self, bounds, policy, dt, latency_s, trace_every,
                          max_steps, policy_kwargs, bound_schedules,
                          smooth_lut: bool = False) -> int:
        if dt <= 0:
            raise ValueError("dt must be positive")
        #: ``True`` translates caps through the piecewise-linear LUT
        #: (``smooth=True`` of
        #: :func:`~repro_torch.core.power.batched_operating_point`): the
        #: exact trajectory that :mod:`repro_torch.diff`'s
        #: ``soft_makespan`` converges to as the temperature goes to 0.
        self.smooth_lut = bool(smooth_lut)
        self._bounds0 = np.asarray(list(bounds), dtype=float)
        if self._bounds0.ndim != 1 or len(self._bounds0) == 0:
            raise ValueError("bounds must be a non-empty 1-D sequence")
        #: The rows' *current* cluster bounds; reset from the initial
        #: bounds at the top of :meth:`run` and mutated by
        #: bound-schedule arrivals.
        self.bounds = self._bounds0.copy()
        self.dt = float(dt)
        self.latency_s = float(latency_s)
        self.max_steps = max_steps
        self._trace_every = trace_every
        self._sched = pad_bound_schedules(bound_schedules,
                                          len(self._bounds0))
        self.policy = self._resolve_policy(policy, policy_kwargs)
        return len(self._bounds0)

    def _init_geometry(self, *, work_pad, rho_pad, node_seq, deps_pad,
                       table, row_job_ids, n_jobs_row, n_active,
                       row_graphs, row_specs) -> None:
        b, n = node_seq.shape[:2]
        self.work_pad = work_pad          # (B, J+1)
        self.rho_pad = rho_pad            # (B, J+1)
        self.node_seq = node_seq          # (B, N, K)
        self.deps_pad = deps_pad          # (B, J+1, D)
        self.table: LUTTable = table
        self.row_job_ids = row_job_ids
        self.n_jobs_row = n_jobs_row
        self.n_active = n_active
        self.row_graphs = row_graphs
        self.row_specs = row_specs
        self.n_jobs_total = work_pad.shape[1] - 1
        self._n = n
        self._nidx = np.arange(n)
        self._bidx = np.arange(b)
        #: (B, N) idle draw per lane (zero on phantom lanes) — the form
        #: policies should use for reclamation sums.
        self.idle_w = np.broadcast_to(self.table.idle_w, (b, n))

    @staticmethod
    def _resolve_policy(policy, kwargs):
        from repro_torch.policies.vector import VectorPolicy, get_vector_policy

        if isinstance(policy, VectorPolicy):
            if kwargs:
                raise ValueError("policy_kwargs only apply to registry keys")
            return policy
        return get_vector_policy(policy, **kwargs)

    # ------------------------------------------------------------ geometry
    @property
    def n_rows(self) -> int:
        """Batch size B (scenario rows)."""
        return len(self._bounds0)

    @property
    def n_nodes(self) -> int:
        """Node lanes per row (the padded envelope ``N``; per-row real
        node counts are :attr:`n_active`)."""
        return self._n

    # ------------------------------------------------------------ stepping
    def _cur(self) -> np.ndarray:
        """(B, N) flat index of each lane's current job (sentinel J if
        exhausted — phantom lanes sit there from the first wave)."""
        return self.node_seq[self._bidx[:, None], self._nidx[None, :],
                             self.ptr]

    def _settle(self, before: Optional[np.ndarray] = None) -> None:
        """Resolve everything that happens at the rows' current instants:
        start ready jobs, complete zero-work jobs, repeat until stable.
        Then report every row whose running mask changed — relative to
        ``before`` (a snapshot predating the caller's own completions)
        when given — to the policy, mirroring the event simulator's
        report semantics: a node finishing one job and immediately
        starting the next emits no report."""
        b_rows = self._bidx
        if before is None:
            before = self.running.copy()
        while True:
            cur = self._cur()
            deps = self.deps_pad[b_rows[:, None], cur]      # (B, N, D)
            deps_ok = self.completed[b_rows[:, None, None],
                                     deps].all(axis=-1)
            ready = (~self.running) & (cur < self.n_jobs_total) & deps_ok \
                & ~self.row_done[:, None]
            changed = False
            if ready.any():
                rows, lanes = np.nonzero(ready)
                jobs = cur[ready]
                self.running[ready] = True
                self.remaining[ready] = self.work_pad[rows, jobs]
                self.start_t[rows, jobs] = self.row_t[rows]
                self.policy.on_job_start(self, rows, lanes, jobs)
                changed = True
            instant = self.running & (self.remaining <= _DONE_EPS)
            if instant.any():
                self._complete(instant)
                changed = True
            if not changed:
                break
        touched = (self.running != before).any(axis=1)
        if touched.any():
            self.policy.on_transition(self, touched)

    def _complete(self, mask: np.ndarray) -> None:
        """Finish the current jobs of every ``(row, lane)`` in ``mask``."""
        rows, lanes = np.nonzero(mask)
        jobs = self._cur()[mask]
        self.completed[rows, jobs] = True
        self.end_t[rows, jobs] = self.row_t[rows]
        self.ptr[mask] += 1
        self.running[mask] = False
        newly_done = ~self.row_done & self.completed[:, :-1].all(axis=1)
        if newly_done.any():
            self.row_done |= newly_done
            self.makespan[newly_done] = self.row_t[newly_done]

    def wave_candidates(self, rate: np.ndarray,
                        tick_count: Optional[np.ndarray] = None,
                        sched_idx: Optional[np.ndarray] = None
                        ) -> WaveCandidates:
        """The wave loop's candidate next-event times as data.

        ``rate`` is the ``(B, N)`` per-lane progress rate of the current
        segment; ``tick_count`` the per-row tick counters (``None`` for
        policies without ticks); ``sched_idx`` the per-row next
        bound-schedule cursor (``None`` without schedules).  Returns the
        :class:`WaveCandidates` the advance minimizes over.
        """
        b = self.n_rows
        with np.errstate(divide="ignore", invalid="ignore"):
            t_fin = np.where(rate > 0, self.remaining / rate, np.inf)
        t_comp = t_fin.min(axis=1)
        if tick_count is not None:
            next_tick = (tick_count + 1) * self.dt
            t_tick = next_tick - self.row_t
        else:
            next_tick = np.full(b, np.inf)
            t_tick = np.full(b, np.inf)
        if sched_idx is not None and self._sched is not None:
            sched_t, _ = self._sched
            t_cols = sched_t.shape[1]
            idx_c = np.minimum(sched_idx, t_cols - 1)
            next_bound_t = sched_t[self._bidx, idx_c]
            sched_live = sched_idx < t_cols
            t_bound = np.where(sched_live, next_bound_t - self.row_t,
                               np.inf)
        else:
            next_bound_t = np.full(b, np.inf)
            sched_live = np.zeros(b, dtype=bool)
            t_bound = np.full(b, np.inf)
        return WaveCandidates(t_fin=t_fin, t_comp=t_comp, t_tick=t_tick,
                              next_tick=next_tick, t_bound=t_bound,
                              next_bound_t=next_bound_t,
                              sched_live=sched_live)

    def _record_trace(self, p_cluster: np.ndarray) -> None:
        every = self._trace_every
        for b in range(self.n_rows):
            if self.row_done[b]:
                continue
            tr = self._traces[b]
            t, p = float(self.row_t[b]), float(p_cluster[b])
            if tr and tr[-1][0] == t:
                tr[-1] = (t, p)
            elif every == 0.0 or not tr or t - tr[-1][0] >= every:
                tr.append((t, p))

    def run(self) -> List[SimResult]:
        """Advance every row to completion; one :class:`SimResult` per
        row, in row order."""
        run_t0 = time.perf_counter()
        b, n, j = self.n_rows, self.n_nodes, self.n_jobs_total
        self.bounds = self._bounds0.copy()
        self.completed = np.zeros((b, j + 1), dtype=bool)
        self.completed[:, j] = True
        # phantom job slots of short rows are born completed
        self.completed[:, :j] |= \
            np.arange(j)[None, :] >= self.n_jobs_row[:, None]
        self.ptr = np.zeros((b, n), dtype=np.int64)
        self.running = np.zeros((b, n), dtype=bool)
        self.remaining = np.zeros((b, n))
        self.row_t = np.zeros(b)
        self.row_done = np.zeros(b, dtype=bool)
        self.energy = np.zeros(b)
        self.peak = np.zeros(b)
        self.over_t = np.zeros(b)
        self.makespan = np.zeros(b)
        self.start_t = np.full((b, j), np.nan)
        self.end_t = np.full((b, j), np.nan)
        self._traces: List[List[Tuple[float, float]]] = [[] for _ in range(b)]
        self.cap = np.array(self.policy.setup(self), dtype=float)
        if self.cap.shape != (b, n):
            raise ValueError(f"policy setup returned {self.cap.shape}, "
                             f"want {(b, n)}")
        ticks = self.policy.wants_ticks
        # Integer tick counts, not accumulated floats: next_tick is always
        # exactly (count + 1) * dt and row_t snaps onto it when a tick
        # wins the wave, so no epsilon comparison can strand a row.
        tick_count = np.zeros(b, dtype=np.int64)
        if self._sched is not None:
            sched_t, sched_w = self._sched
            t_cols = sched_t.shape[1]
            sched_idx = np.zeros(b, dtype=np.int64)

        self._settle()
        steps = 0
        while not self.row_done.all():
            steps += 1
            if steps > self.max_steps:
                raise RuntimeError(f"batch simulator exceeded max steps "
                                   f"({self.max_steps}); livelock?")
            freq, duty, op_power = batched_operating_point(
                self.table, self.cap, smooth=self.smooth_lut)
            rho = self.rho_pad[self._bidx[:, None], self._cur()]
            rate = np.where(self.running,
                            batched_rates(self.table, freq, duty, rho), 0.0)
            p_node = np.where(self.running, op_power, self.idle_w)
            p_cluster = p_node.sum(axis=1)
            active = ~self.row_done
            if self._trace_every is not None:
                self._record_trace(p_cluster)

            cand = self.wave_candidates(
                rate,
                tick_count=tick_count if ticks else None,
                sched_idx=sched_idx if self._sched is not None else None)
            t_comp, t_tick, t_bound = cand.t_comp, cand.t_tick, cand.t_bound
            next_tick, next_bound_t = cand.next_tick, cand.next_bound_t
            sched_live = cand.sched_live
            if self._sched is not None:
                idx_c = np.minimum(sched_idx, t_cols - 1)
            step = np.minimum(np.minimum(t_comp, t_tick), t_bound)
            # Deadlock is judged on t_comp, not step: starts depend only
            # on dependency completions, so a row with no running lane
            # can never recover — even under a tick policy whose t_tick
            # stays finite forever (which would otherwise spin here for
            # max_steps waves).  Bound arrivals cannot start jobs either.
            if np.any(active & ~np.isfinite(t_comp)):
                bad = int(np.nonzero(active & ~np.isfinite(t_comp))[0][0])
                jids = self.row_job_ids[bad]
                missing = [jids[k] for k in range(int(self.n_jobs_row[bad]))
                           if not self.completed[bad, k]]
                raise RuntimeError(f"deadlock in batch row {bad}: jobs "
                                   f"never ran: {sorted(missing)[:8]}")
            delta = np.where(active, step, 0.0)
            # Over-budget time is classified against the bound in effect
            # *during* the wave (a scheduled change applies from its
            # arrival instant onwards, exactly like the event heap).
            self.energy += p_cluster * delta
            self.peak = np.where(active, np.maximum(self.peak, p_cluster),
                                 self.peak)
            self.over_t += delta * (
                active & (p_cluster
                          > self.bounds * (1 + OVER_BUDGET_RTOL) + 1e-9))
            self.remaining -= rate * delta[:, None]
            self.row_t += delta

            if ticks:
                due = active & (t_tick <= t_comp) & (t_tick <= t_bound)
                self.row_t[due] = next_tick[due]   # kill the float residue
            before = self.running.copy()
            finished = self.running & (self.remaining <= _DONE_EPS) \
                & active[:, None]
            if finished.any():
                self._complete(finished)
            if self._sched is not None:
                b_due = active & sched_live & (t_bound <= t_comp) \
                    & (t_bound <= t_tick)
                if b_due.any():
                    self.row_t[b_due] = next_bound_t[b_due]
                    self.bounds[b_due] = sched_w[self._bidx, idx_c][b_due]
                    sched_idx[b_due] += 1
                    self.policy.on_bound_change(self, b_due)
            if ticks and due.any():
                self.policy.on_tick(self, due)
                tick_count[due] += 1
            self._settle(before)
        if self._trace_every is not None:
            idle_total = self.idle_w.sum(axis=1)
            for b_row, (tr, m) in enumerate(zip(self._traces,
                                                self.makespan)):
                if not tr or tr[-1][0] < float(m):
                    tr.append((float(m), float(idle_total[b_row])))
        # One span for the whole wave loop (never per-wave: the loop is
        # the vector backend's hot path and waves number in the
        # thousands; the disabled path must stay O(1) per run).
        if obs_trace.enabled():
            obs_trace.complete("wave-loop", run_t0,
                               time.perf_counter() - run_t0, cat="vector",
                               track="engine",
                               args={"rows": b, "waves": steps})
        return self._results()

    # -------------------------------------------------------------- output
    def _results(self) -> List[SimResult]:
        name = self.policy.name
        out: List[SimResult] = []
        for row in range(self.n_rows):
            makespan = float(self.makespan[row])
            jids = self.row_job_ids[row]
            starts = {jid: float(self.start_t[row, k])
                      for k, jid in enumerate(jids)
                      if not math.isnan(self.start_t[row, k])}
            ends = {jid: float(self.end_t[row, k])
                    for k, jid in enumerate(jids)
                    if not math.isnan(self.end_t[row, k])}
            energy = float(self.energy[row])
            out.append(SimResult(
                policy=name, makespan=makespan, energy_j=energy,
                avg_power_w=energy / makespan if makespan > 0 else 0.0,
                peak_power_w=float(self.peak[row]),
                over_budget_time=float(self.over_t[row]),
                messages=0, distributes=0, suppressed_reports=0,
                power_trace=self._traces[row],
                job_starts=starts, job_ends=ends))
        return out


def simulate_batch(graph: JobDependencyGraph, specs: Sequence[NodeSpec],
                   bounds: Sequence[float],
                   policy: Union[str, "VectorPolicy"] = "equal-share",
                   dt: float = 0.05, latency_s: float = 0.05,
                   trace_every: Optional[float] = None,
                   bound_schedules: Optional[Sequence] = None,
                   smooth_lut: bool = False,
                   **policy_kwargs) -> List[SimResult]:
    """One-call facade: one :class:`SimResult` per entry of ``bounds``."""
    return BatchSimulator(graph, specs, bounds, policy=policy, dt=dt,
                          latency_s=latency_s, trace_every=trace_every,
                          bound_schedules=bound_schedules,
                          smooth_lut=smooth_lut,
                          **policy_kwargs).run()
