"""Wave-advancement engine: every scenario row of a batch in lockstep.

The reference engine (``repro.backends.jax.engine``) writes the wave
loop for one row and ``vmap``s a data-dependent ``while_loop`` over the
rows.  PyTorch cannot map such a loop, so this engine steps all B rows
together as ``(B, N)`` lane tensors and ``(B, J+1)`` job tensors, the
layout of the reference's numpy batch simulator.  Each row keeps its own
clock and advances by its own ``delta``; a row that is done, stalled or
out of steps is frozen by a mask and changes nothing.

Two batch layouts share the loop:

* **shared** (the constructor): one graph and cluster, B bounds — the
  geometry is expanded over the rows without copying;
* **stacked** (:meth:`TorchBatchSimulator.padded`): B different (graph,
  cluster) rows padded to one envelope (phantom job slots born complete,
  phantom lanes with zero idle draw; see :mod:`repro_torch.core.arrays`).

Three paths run the same loop (``impl``):

* ``"cuda"`` — one launch of the hand-written ``wave_run`` kernel runs
  every row through the whole loop below on the device, one warp a row,
  with the policy's cap rule inside (its ``kernel_mode``); no host in
  the loop;
* ``"step"`` — the lockstep loop below on the host, one launch of the
  ``power_step`` kernel (and of ``waterfill`` for the heuristic) a wave;
* ``"plain"`` — the same lockstep loop with the plain PyTorch versions:
  the plain version beside the kernels, and the CPU path.

One loop iteration does, for every row, one step of the settle fixed
point (start ready jobs, then complete zero-work ones) and then, on the
rows that are settled, one wave: policy caps, the fused
:func:`~repro_torch.kernels.power_step.power_step` (one kernel launch for
the whole batch), the earliest of completion / policy tick / bound
arrival, energy / peak / over-budget accounting, completions and the
policy tick.  A row is settled when its step completed no zero-work job:
starting jobs cannot make another lane ready, and the step's completion
pass leaves no running lane without work, so a step that completed
nothing reached the fixed point.  A row that completed something takes
another step in the next iteration before it waves, exactly as the
reference's settle loop runs its body again; each row therefore walks
the reference's sequence of waves, and the settle loop needs no host
sync.  The host syncs only to test whether any row is still live, every
``check_every`` iterations; later iterations on finished rows change
nothing, so the results do not depend on ``check_every``.

A run splits in two, as the reference's does:
:meth:`~TorchBatchSimulator.dispatch` packs the batch, uploads it from
pinned host memory (so the copy does not wait for a kernel still running
on the stream) and launches it; :meth:`~TorchBatchSimulator.fetch`
waits, brings the state back in one device-to-host copy and builds the
results.  The sweep executor
(:mod:`repro_torch.core.sweep`) dispatches every bucket before it
fetches the first, so the card runs later buckets while the host builds
earlier buckets' results.

Numerics: float32 throughout, like the reference.  Job completion is
decided by time (``t_fin <= delta``), never by a residual-work epsilon.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.arrays import (build_graph_arrays,
                                     pad_bound_schedules,
                                     stack_graph_arrays,
                                     validate_padded_items)
from repro_torch.core.graph import JobDependencyGraph
from repro_torch.core.power import NodeSpec
from repro_torch.core.results import OVER_BUDGET_RTOL, SimResult
from repro_torch.kernels.power_step import (BIG_TIME, StepTables,
                                            power_step, step_tables,
                                            wave_run_cuda)
from repro_torch.obs import trace as obs_trace

from .policies import (TorchPolicy, current_jobs, get_torch_policy,
                       kernel_mode)
from .profile import BucketProfile

#: Anything above this is "no event" (see power_step's BIG_TIME).
_BIG_CUT = BIG_TIME * 0.5

FLOAT = torch.float32

#: The engine's paths (see the module docstring).
ENGINE_IMPLS = ("plain", "step", "cuda")


class Ctx(NamedTuple):
    """The batch's geometry on the device, every leaf with a leading row
    axis B (expanded without copying in the shared layout)."""

    tab: StepTables
    node_seq: torch.Tensor    # (B, N, K) int64 (int32 for "cuda")
    deps_pad: torch.Tensor    # (B, J+1, D) int64 (int32 for "cuda")
    work_pad: torch.Tensor    # (B, J+1)
    rho_pad: torch.Tensor     # (B, J+1)
    n_active: torch.Tensor    # (B,) int64 (int32 for "cuda") real nodes
    dt: torch.Tensor          # () policy tick
    impl: str                 # per-wave kernels' impl ("plain"/"cuda")


@dataclass
class State:
    """The batch's loop state, updated in place."""

    ptr: torch.Tensor         # (B, N) int64 current-job pointer
    running: torch.Tensor     # (B, N) bool
    remaining: torch.Tensor   # (B, N)
    completed: torch.Tensor   # (B, J+1) bool, sentinel slot always True
    row_t: torch.Tensor       # (B,)
    bound: torch.Tensor       # (B,) current bound (schedules update it)
    sched_idx: torch.Tensor   # (B,) int64 next bound-schedule entry
    done: torch.Tensor        # (B,) bool
    stalled: torch.Tensor     # (B,) bool (deadlock flag)
    settled: torch.Tensor     # (B,) bool: at the settle fixed point
    energy: torch.Tensor      # (B,)
    peak: torch.Tensor        # (B,)
    over_t: torch.Tensor      # (B,)
    makespan: torch.Tensor    # (B,)
    start_t: torch.Tensor     # (B, J+1) NaN until started, slot J junk
    end_t: torch.Tensor       # (B, J+1) NaN until completed, slot J junk
    tick_count: torch.Tensor  # (B,) int64
    steps: torch.Tensor       # (B,) int64 waves taken


#: The state fields :meth:`TorchBatchSimulator.fetch` brings back, in
#: the order they are packed (8-byte, 4-byte, then 1-byte items, so every
#: field of the packed buffer is aligned for its type).
_FETCHED = ("steps", "makespan", "energy", "peak", "over_t", "start_t",
            "end_t", "completed", "done", "stalled")


@dataclass
class ShardRun:
    """One shard of a dispatched batch: its rows' state on its device,
    what its launch returns, and the stream it ran on."""

    device: torch.device
    st: State
    stream: Optional[torch.cuda.Stream] = None
    iters: Optional[torch.Tensor] = None   # wave_run's per-row counts
    events: Optional[Tuple] = None         # (start, end) CUDA events
    waves: int = 0                         # lockstep iterations
    syncs: int = 0                         # lockstep liveness checks


@dataclass
class PendingBatch:
    """A dispatched batch: its shards (one unless the rows were split
    over several devices) and its profile (:meth:`TorchBatchSimulator.
    fetch` fills in the fields after the dispatch)."""

    profile: BucketProfile
    shards: List[ShardRun] = field(default_factory=list)
    #: the pinned host buffers the uploads were copied from, kept alive
    #: until :meth:`TorchBatchSimulator.fetch` returns
    staged: Tuple[torch.Tensor, ...] = ()


class RunStats(NamedTuple):
    """What the last :meth:`TorchBatchSimulator.run` cost."""

    path: str           # the engine path that ran (ENGINE_IMPLS)
    waves: int          # loop iterations: of the lockstep loop (a
    #                     multiple of check_every), or the most any row
    #                     ran in the kernel ("cuda")
    row_waves: int      # waves summed over the rows
    host_syncs: int     # liveness checks + the final fetch
    kernel_ms: Optional[float]  # device time of the wave_run launch
    #                             (CUDA events; "cuda" only)


def resolve_impl(impl: Optional[str], device: torch.device,
                 policy: TorchPolicy) -> str:
    """The engine path for ``impl`` (see the module docstring).

    ``None`` chooses by capability: on the CPU the plain path; on the
    card ``"cuda"`` when the policy declares a ``kernel_mode`` (every
    registry policy does) and ``"step"`` when it does not (a custom
    :class:`TorchPolicy`).  Nothing falls back: ``"step"``/``"cuda"``
    without a CUDA device, and ``"cuda"`` for a policy without a mode,
    raise.
    """
    mode = kernel_mode(policy)
    if impl is None:
        if device.type != "cuda":
            return "plain"
        return "cuda" if mode is not None else "step"
    if impl not in ENGINE_IMPLS:
        raise ValueError(f"unknown engine impl {impl!r}; expected None or "
                         f"one of {ENGINE_IMPLS}")
    if impl != "plain" and device.type != "cuda":
        raise ValueError(f"impl={impl!r} launches the CUDA kernels: it "
                         f"needs a CUDA device, got {device}")
    if impl == "cuda" and mode is None:
        raise ValueError(f"impl='cuda' runs the policy's cap rule in the "
                         f"kernel, and policy {policy.name!r} declares no "
                         f"kernel_mode; use impl='step'")
    return impl


def visible_devices(device=None) -> List[torch.device]:
    """The devices a batch's rows may be split over, the counterpart of
    the reference's ``jax.devices()``: every card
    (``torch.cuda.device_count()``) for a CUDA engine (``None`` is the
    card), the engine's one device otherwise."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def shard_count(requested: Optional[int], n_rows: int, device=None) -> int:
    """Resolve a shard-device request against the visible devices
    (:func:`visible_devices` of ``device``) and the batch size: ``None``
    means every visible device, and a batch never shards wider than its
    row count (a 3-row batch on 8 devices runs 3-wide)."""
    avail = len(visible_devices(device))
    n = avail if requested is None else min(int(requested), avail)
    return max(1, min(n, n_rows))


def resolve_device(device) -> torch.device:
    """``None`` means the card: it raises when CUDA is missing rather
    than running on the CPU.  Pass ``device="cpu"`` for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the engine on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _on(stream):
    """Make ``stream`` current for its device (no-op for ``None``)."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


# ------------------------------------------------------------ state ops
# ``cur`` is each lane's current job slot (current_jobs), computed once
# per settle step and once per wave: starting jobs does not move it.
def _ready_mask(ctx: Ctx, st: State, cur: torch.Tensor) -> torch.Tensor:
    """Lanes whose current job can start: not running, a real job, every
    dependency complete.  A done row's lanes all sit on the sentinel, and
    a stalled row has nothing ready, so neither starts anything."""
    b, n = cur.shape
    j = ctx.work_pad.shape[1] - 1
    d = ctx.deps_pad.shape[2]
    deps = ctx.deps_pad.gather(1, cur.unsqueeze(-1).expand(b, n, d))
    deps_ok = st.completed.gather(1, deps.reshape(b, n * d)) \
        .view(b, n, d).all(dim=-1)
    return ~st.running & (cur < j) & deps_ok


def _start(ctx: Ctx, st: State, mask: torch.Tensor, cur: torch.Tensor):
    j = ctx.work_pad.shape[1] - 1
    tgt = torch.where(mask, cur, j)      # masked-off lanes hit the junk slot
    st.running |= mask
    st.remaining = torch.where(mask, ctx.work_pad.gather(1, cur),
                               st.remaining)
    st.start_t.scatter_(1, tgt, st.row_t.unsqueeze(-1).expand_as(tgt))


def _complete(ctx: Ctx, st: State, mask: torch.Tensor, cur: torch.Tensor):
    j = ctx.work_pad.shape[1] - 1
    tgt = torch.where(mask, cur, j)
    st.completed.scatter_(1, tgt, True)
    all_done = st.completed[:, :j].all(dim=-1)
    st.end_t.scatter_(1, tgt, st.row_t.unsqueeze(-1).expand_as(tgt))
    st.ptr += mask
    st.running &= ~mask
    st.makespan = torch.where(all_done & ~st.done, st.row_t, st.makespan)
    st.done |= all_done


def _settle_step(ctx: Ctx, st: State) -> None:
    """One pass of the settle fixed point on every row: start the ready
    jobs, then complete the running jobs with no work left."""
    cur = current_jobs(ctx, st)
    _start(ctx, st, _ready_mask(ctx, st, cur), cur)
    instant = st.running & (st.remaining <= 0.0)
    _complete(ctx, st, instant, cur)
    st.settled = ~instant.any(dim=-1)


class TorchBatchSimulator:
    """Batched wave simulator, B scenario rows at once (on one device, or
    split over several: ``shard_devices``).

    The constructor's fixed-structure batch (one graph, one cluster, B
    bounds, one policy) and :meth:`padded`'s mixed-shape stacked batch,
    with ``policy`` a key of the torch-policy registry
    (:mod:`repro_torch.backends.policies`) or an instance.
    ``bound_schedules`` (one ``(time_s, bound_w)`` iterable per row)
    makes the rows' bounds time-varying, resolved at exact arrival
    times.  ``device=None`` runs on the card and raises without one;
    ``impl`` picks the engine path, ``None``/``"plain"``/``"step"``/
    ``"cuda"`` (:func:`resolve_impl`; :attr:`stats` names the one that
    ran).  ``check_every`` is the number of lockstep iterations between
    the host's checks for live rows.  ``shard_devices`` splits the rows
    over that many of the visible devices (:func:`visible_devices`;
    ``None`` = all of them, clamped to the row count): on one device the
    batch runs unsplit.
    """

    def __init__(self, graph: JobDependencyGraph, specs: Sequence[NodeSpec],
                 bounds: Sequence[float],
                 policy: Union[str, TorchPolicy] = "equal-share",
                 dt: float = 0.05, latency_s: float = 0.05,
                 max_steps: int = 1_000_000,
                 bound_schedules: Optional[Sequence] = None,
                 device=None, impl: Optional[str] = None,
                 check_every: int = 64,
                 shard_devices: Optional[int] = None, **policy_kwargs):
        graph.topological_order()          # validates the DAG
        if len(specs) != len(graph.nodes):
            raise ValueError("one NodeSpec per graph node required")
        self.graph = graph
        self.specs = list(specs)
        self._setup_run_params(bounds, policy, dt, latency_s, max_steps,
                               bound_schedules, device, impl, check_every,
                               shard_devices, policy_kwargs)
        b = self.n_rows
        arrays = build_graph_arrays(graph, self.specs)
        self._init_rows(
            arrays, stacked=False,
            row_graphs=[graph] * b, row_specs=[self.specs] * b,
            row_job_ids=(tuple(arrays.job_ids),) * b,
            n_jobs_row=np.full(b, arrays.n_jobs),
            n_active=np.full(b, arrays.n_nodes))

    @classmethod
    def padded(cls, items: Sequence[Tuple[JobDependencyGraph,
                                          Sequence[NodeSpec]]],
               bounds: Sequence[float],
               policy: Union[str, TorchPolicy] = "equal-share",
               dt: float = 0.05, latency_s: float = 0.05,
               max_steps: int = 1_000_000,
               bound_schedules: Optional[Sequence] = None,
               pad_dims: Optional[Tuple[int, int, int, int, int]] = None,
               device=None, impl: Optional[str] = None,
               check_every: int = 64,
               shard_devices: Optional[int] = None,
               **policy_kwargs) -> "TorchBatchSimulator":
        """A mixed-shape batch: row ``b`` runs ``items[b]`` under
        ``bounds[b]``; ``pad_dims`` is the ``(N, J, K, D, S)`` envelope
        (tight maxima when omitted)."""
        self = cls.__new__(cls)
        items, bounds = validate_padded_items(items, bounds)
        self.graph = None
        self.specs = None
        self._setup_run_params(bounds, policy, dt, latency_s, max_steps,
                               bound_schedules, device, impl, check_every,
                               shard_devices, policy_kwargs)
        arrays = stack_graph_arrays(items, pad_dims)
        self._init_rows(
            arrays, stacked=True,
            row_graphs=[g for g, _ in items],
            row_specs=[list(sp) for _, sp in items],
            row_job_ids=arrays.row_job_ids,
            n_jobs_row=arrays.n_jobs_row, n_active=arrays.n_active)
        return self

    # ------------------------------------------------------- construction
    def _init_rows(self, arrays, *, stacked, row_graphs, row_specs,
                   row_job_ids, n_jobs_row, n_active) -> None:
        self.arrays = arrays
        self.stacked = stacked
        self.row_graphs = row_graphs
        self.row_specs = row_specs
        self.row_job_ids = row_job_ids
        self.n_jobs_row = np.asarray(n_jobs_row)
        self.n_active = np.asarray(n_active)
        self.n_jobs_total = arrays.n_jobs

    def _setup_run_params(self, bounds, policy, dt, latency_s, max_steps,
                          bound_schedules, device, impl, check_every,
                          shard_devices, policy_kwargs) -> None:
        if dt <= 0:
            raise ValueError("dt must be positive")
        if check_every < 1:
            raise ValueError("check_every must be >= 1")
        self.bounds = np.asarray(list(bounds), dtype=float)
        if self.bounds.ndim != 1 or len(self.bounds) == 0:
            raise ValueError("bounds must be a non-empty 1-D sequence")
        self.dt = float(dt)
        self.latency_s = float(latency_s)
        self.max_steps = int(max_steps)
        self.device = resolve_device(device)
        self.n_shards = shard_count(shard_devices, len(self.bounds),
                                    self.device)
        #: the device of each shard, in row order
        self.devices = ([self.device] if self.n_shards == 1 else
                        visible_devices(self.device)[:self.n_shards])
        self.check_every = int(check_every)
        self._sched = pad_bound_schedules(bound_schedules, len(self.bounds))
        if isinstance(policy, TorchPolicy):
            if policy_kwargs:
                raise ValueError("policy_kwargs only apply to registry "
                                 "keys")
            self.policy = policy
        else:
            self.policy = get_torch_policy(policy, **policy_kwargs)
        self.impl = resolve_impl(impl, self.device, self.policy)
        self.stats: Optional[RunStats] = None
        self._staged: List[torch.Tensor] = []

    @property
    def n_rows(self) -> int:
        return len(self.bounds)

    @property
    def n_nodes(self) -> int:
        return self.arrays.n_nodes

    def _tensor(self, a, dtype, device=None) -> torch.Tensor:
        return self._upload(torch.as_tensor(np.asarray(a)).to(dtype), device)

    def _upload(self, t: torch.Tensor, device=None) -> torch.Tensor:
        """A host tensor on ``device`` (the engine's by default).  To the
        card it goes from pinned memory without blocking, on the current
        stream: a copy from pageable memory would wait for every kernel
        queued on the stream, so a batch dispatched behind another would
        wait for that one's run."""
        device = self.device if device is None else device
        t = t.contiguous()
        if device.type != "cuda":
            return t
        pinned = t.pin_memory()
        self._staged.append(pinned)
        return pinned.to(device, non_blocking=True)

    def _ctx(self, rows: Optional[np.ndarray] = None, device=None,
             tab: Optional[StepTables] = None) -> Ctx:
        """The geometry of the batch rows ``rows`` (all by default) on
        ``device``: the stacked layout takes those rows of every leaf,
        the shared layout expands its one graph and cluster over them.
        ``tab`` is the host's :class:`StepTables`, built once a dispatch
        when given."""
        a = self.arrays
        rows = np.arange(self.n_rows) if rows is None else rows
        b = len(rows)
        # the kernel loop indexes with int32; torch's gathers take int64
        index = torch.int32 if self.impl == "cuda" else torch.int64

        def put(x, dtype):
            if self.stacked:
                return self._tensor(np.asarray(x)[rows], dtype, device)
            t = self._tensor(x, dtype, device)
            return t.unsqueeze(0).expand(b, *t.shape)

        if tab is None:
            tab = step_tables(a.table, "cpu", FLOAT)
        if self.stacked:
            take = torch.from_numpy(np.asarray(rows, np.int64))
            tab = StepTables(*(t.index_select(0, take) for t in tab))
        tab = StepTables(*(self._upload(t, device) for t in tab))
        return Ctx(tab=tab,
                   node_seq=put(a.node_seq, index),
                   deps_pad=put(a.deps_pad, index),
                   work_pad=put(a.work_pad, FLOAT),
                   rho_pad=put(a.rho_pad, FLOAT),
                   n_active=self._tensor(self.n_active[rows], index, device),
                   dt=self._tensor(self.dt, FLOAT, device),
                   impl="plain" if self.impl == "plain" else "cuda")

    def _state0(self, rows: Optional[np.ndarray] = None,
                device=None) -> State:
        """The loop's initial state for the batch rows ``rows`` (all by
        default) on ``device``."""
        rows = np.arange(self.n_rows) if rows is None else rows
        dev = self.device if device is None else device
        b, n, j = len(rows), self.n_nodes, self.n_jobs_total
        completed = np.zeros((b, j + 1), dtype=bool)
        completed[:, j] = True
        # phantom job slots of a padded row are born completed
        completed[:, :j] |= \
            np.arange(j)[None, :] >= self.n_jobs_row[rows][:, None]

        def zeros(dtype=FLOAT):
            return torch.zeros(b, dtype=dtype, device=dev)

        return State(
            ptr=torch.zeros(b, n, dtype=torch.int64, device=dev),
            running=torch.zeros(b, n, dtype=torch.bool, device=dev),
            remaining=torch.zeros(b, n, dtype=FLOAT, device=dev),
            completed=self._tensor(completed, torch.bool, dev),
            row_t=zeros(), bound=self._tensor(self.bounds[rows], FLOAT, dev),
            sched_idx=zeros(torch.int64), done=zeros(torch.bool),
            stalled=zeros(torch.bool), settled=zeros(torch.bool),
            energy=zeros(), peak=zeros(), over_t=zeros(),
            makespan=zeros(),
            start_t=torch.full((b, j + 1), math.nan, dtype=FLOAT,
                               device=dev),
            end_t=torch.full((b, j + 1), math.nan, dtype=FLOAT, device=dev),
            tick_count=zeros(torch.int64), steps=zeros(torch.int64))

    def _shard_rows(self) -> List[np.ndarray]:
        """Each shard's batch rows: the row axis padded to a multiple of
        the shard count with replicas of the last row (the reference's
        ``_pad_rows``), cut into contiguous blocks."""
        b = self.n_rows
        pad = (-b) % self.n_shards
        index = np.concatenate([np.arange(b), np.full(pad, b - 1)])
        return np.split(index, self.n_shards)

    # ------------------------------------------------------------- the loop
    def _wave(self, ctx: Ctx, st: State, pol, sched_t, sched_w):
        """One wave on the rows that are live and settled."""
        cls = self.policy
        act = ~(st.done | st.stalled) & (st.steps < self.max_steps) \
            & st.settled
        caps = cls.caps_fn(ctx, st, pol).contiguous()
        cur = current_jobs(ctx, st)
        rho = ctx.rho_pad.gather(1, cur)
        rate, _, t_fin, _, p_cl, t_cm = power_step(
            ctx.tab, caps, st.running.to(FLOAT), st.remaining, rho,
            st.bound.unsqueeze(-1), redistribute=cls.redistribute,
            impl=ctx.impl)
        p_cluster, t_comp = p_cl.squeeze(-1), t_cm.squeeze(-1)
        big = torch.full_like(t_comp, BIG_TIME)

        if cls.wants_ticks:
            ticks = (st.tick_count + 1).to(FLOAT)
            next_tick = ticks * ctx.dt
            # One rounding for (k+1)*dt - row_t, a fused multiply-add, as
            # the reference's compiled loop evaluates it (exact in float64,
            # then rounded): rounding the product first drifts energy
            # past 1e-5 of the reference over thousands of tick waves.
            t_tick = (ticks.double() * ctx.dt.double()
                      - st.row_t.double()).to(FLOAT)
        else:
            next_tick = t_tick = big
        # next scheduled bound arrival (padded with BIG_TIME; sched_live
        # guards re-reading a consumed final entry)
        t_cols = sched_t.shape[1]
        idx_c = st.sched_idx.clamp(max=t_cols - 1).unsqueeze(-1)
        sched_live = st.sched_idx < t_cols
        next_bound_t = sched_t.gather(1, idx_c).squeeze(-1)
        t_bound = torch.where(sched_live, next_bound_t - st.row_t, big)
        delta = torch.minimum(torch.minimum(t_comp, t_tick), t_bound)
        # Deadlock is judged on t_comp, not delta: a row with no running
        # lane can never recover (ticks and bound arrivals start nothing).
        stalled_now = (t_comp >= _BIG_CUT) & act
        # A frozen row (and a stalling one) advances by exactly 0: adding
        # 0 leaves its clock, remaining work and energy as they were.
        delta = torch.where(act & ~stalled_now, delta, 0.0)
        # over-budget uses the bound in effect *during* the wave
        over = p_cluster > st.bound * (1 + OVER_BUDGET_RTOL) + 1e-9
        finishing = st.running & act.unsqueeze(-1) & \
            (t_fin <= delta.unsqueeze(-1) * (1 + 1e-6) + 1e-9)
        row_t = st.row_t + delta
        if cls.wants_ticks:
            due = (t_tick <= t_comp) & (t_tick <= t_bound) & ~stalled_now \
                & act
            row_t = torch.where(due, next_tick, row_t)   # kill float residue
        bound_due = sched_live & (t_bound <= t_comp) & (t_bound <= t_tick) \
            & ~stalled_now & act
        row_t = torch.where(bound_due, next_bound_t, row_t)

        st.remaining = torch.where(finishing, 0.0,
                                   st.remaining - rate * delta.unsqueeze(-1))
        st.row_t = row_t
        st.bound = torch.where(bound_due,
                               sched_w.gather(1, idx_c).squeeze(-1),
                               st.bound)
        st.sched_idx += bound_due
        st.energy = st.energy + p_cluster * delta
        st.peak = torch.where(act, torch.maximum(st.peak, p_cluster),
                              st.peak)
        st.over_t = st.over_t + torch.where(over, delta, 0.0)
        st.stalled |= stalled_now
        st.steps += act
        _complete(ctx, st, finishing, cur)
        if cls.wants_ticks:
            pol = cls.tick_fn(ctx, st, pol, due)
            st.tick_count += due
        return pol

    def _live(self, st: State) -> torch.Tensor:
        return ((~st.done & ~st.stalled & (st.steps < self.max_steps))
                | ~st.settled).any()

    def _lockstep(self, ctx: Ctx, st: State, pol, sched_t, sched_w
                  ) -> Tuple[int, int]:
        """Every row in lockstep until none is live: (iterations, host
        syncs)."""
        waves = syncs = 0
        while True:
            _settle_step(ctx, st)
            pol = self._wave(ctx, st, pol, sched_t, sched_w)
            waves += 1
            if waves % self.check_every == 0:
                syncs += 1
                if not bool(self._live(st)):
                    return waves, syncs

    def dispatch(self) -> PendingBatch:
        """Pack, upload and launch the batch; returns its handle for
        :meth:`fetch`.

        On the ``"cuda"`` path this is one asynchronous ``wave_run``
        launch a shard between two CUDA events, and it returns without
        waiting for the card.  The ``"step"`` and ``"plain"`` paths run
        their lockstep loop here, shard after shard, which syncs with the
        host every ``check_every`` iterations, so their dispatch runs
        (nearly) to completion.  ``profile.compiled`` is true when this
        dispatch built the kernel library (the per-wave paths build it at
        their first launch).

        Everything here works from the shards' own devices: the
        launches, the events and the streams they are recorded on, never
        the calling thread's current device, so a dispatcher thread and
        a collector thread may each take one side of a batch.  One shard
        runs on its device's current stream; split rows run each on a
        stream of its own, so the shards overlap even on one card."""
        from repro_torch.kernels._build import claim_build, library_loaded

        prof = BucketProfile(rows=self.n_rows, devices=self.n_shards,
                             path=self.impl)
        t0 = time.perf_counter()
        self._staged = []
        pol_host = self.policy.init_state(self)
        tab_host = step_tables(self.arrays.table, "cpu", FLOAT)
        shards = []
        for rows, dev in zip(self._shard_rows(), self.devices):
            stream = None
            if dev.type == "cuda":
                stream = (torch.cuda.current_stream(dev)
                          if self.n_shards == 1 else torch.cuda.Stream(dev))
            with _on(stream):
                shards.append(self._pack(rows, dev, stream, pol_host,
                                         tab_host))
        prof.cache_key = (tuple(shards[0][1].work_pad.shape),
                          tuple(shards[0][1].node_seq.shape), self.impl,
                          self.n_shards, self.policy.name)
        t1 = time.perf_counter()
        prof.pack_s = t1 - t0
        unbuilt = self.impl != "plain" and not library_loaded()
        pending = PendingBatch(profile=prof)
        for shard, ctx, pol, sched_t, sched_w in shards:
            with _on(shard.stream):
                self._launch(shard, ctx, pol, sched_t, sched_w)
            pending.shards.append(shard)
        pending.staged, self._staged = tuple(self._staged), []
        prof.dispatch_s = time.perf_counter() - t1
        # the one dispatch that claims the build reports it, even when
        # several threads were waiting on it
        prof.compile_s = claim_build() if unbuilt else 0.0
        prof.compiled = prof.compile_s > 0
        if obs_trace.enabled():
            args = {"rows": self.n_rows, "devices": self.n_shards,
                    "path": self.impl}
            obs_trace.complete("pack", t0, prof.pack_s, cat="engine",
                               track="engine", args=args)
            obs_trace.complete("compile" if prof.compiled else "dispatch",
                               t1, prof.dispatch_s, cat="engine",
                               track="engine",
                               args=dict(args, compiled=prof.compiled))
        return pending

    def _pack(self, rows: np.ndarray, device: torch.device, stream,
              pol_host: Dict[str, np.ndarray], tab_host: StepTables):
        """One shard's geometry, state, policy tensors and bound
        schedules on its device (uploaded on the current stream)."""
        pol = {k: self._tensor(v, torch.bool if np.asarray(v).dtype == bool
                               else FLOAT, device)
               for k, v in self.policy.take_state_rows(pol_host,
                                                       rows).items()}
        ctx = self._ctx(rows, device, tab_host)
        st = self._state0(rows, device)
        if self._sched is not None:
            sched_t, sched_w = (self._tensor(x[rows], FLOAT, device)
                                for x in self._sched)
        else:
            sched_t = torch.full((len(rows), 1), BIG_TIME, dtype=FLOAT,
                                 device=device)
            sched_w = torch.zeros_like(sched_t)
        return (ShardRun(device=device, st=st, stream=stream), ctx, pol,
                sched_t, sched_w)

    def _launch(self, shard: ShardRun, ctx: Ctx, pol, sched_t,
                sched_w) -> None:
        """Run one shard: its ``wave_run`` launch, or its lockstep loop,
        between two CUDA events on its stream (on the card)."""
        if shard.stream is not None:
            shard.events = tuple(torch.cuda.Event(enable_timing=True)
                                 for _ in range(2))
            shard.events[0].record(shard.stream)
        if self.impl == "cuda":
            shard.iters = wave_run_cuda(
                ctx, shard.st, pol, sched_t, sched_w,
                mode=kernel_mode(self.policy), dt=self.dt,
                max_steps=self.max_steps)
        else:
            shard.waves, shard.syncs = self._lockstep(ctx, shard.st, pol,
                                                      sched_t, sched_w)
        if shard.events is not None:
            shard.events[1].record(shard.stream)

    def fetch(self, pending: PendingBatch,
              rows: Optional[int] = None) -> List[SimResult]:
        """Wait for a dispatched batch and build its results.

        ``run_s`` is the wait left at fetch time (for every shard); then
        one device-to-host copy a shard brings back every state field
        (``transfer_s``), the shards' rows are gathered in order and the
        phantom rows of the split trimmed, and the results are built on
        the host (``results_s``) for the first ``rows`` rows (all when
        ``None``: the streaming service's phantom rows past its requests
        are checked, not built).  On the card each copy runs on a stream
        of its own that waits for its shard's end event only: on the
        launch stream it would also wait for every batch dispatched after
        this one."""
        prof = pending.profile
        t0 = time.perf_counter()
        for shard in pending.shards:
            if shard.events is not None:
                shard.events[1].synchronize()
        t1 = time.perf_counter()
        prof.run_s = t1 - t0
        parts = []
        for shard in pending.shards:
            if shard.events is not None:
                copier = torch.cuda.Stream(shard.device)
                copier.wait_event(shard.events[1])
                with torch.cuda.stream(copier):
                    parts.append(self._transfer(shard))
            else:
                parts.append(self._transfer(shard))
        out = {k: np.concatenate([p[k] for p in parts])[:self.n_rows]
               for k in parts[0]}
        t2 = time.perf_counter()
        prof.transfer_s = t2 - t1
        syncs = sum(shard.syncs for shard in pending.shards)
        if self.impl == "cuda":
            waves = int(out["iters"].max())
            prof.kernel_ms = max(shard.events[0].elapsed_time(
                shard.events[1]) for shard in pending.shards)
        else:
            waves = max(shard.waves for shard in pending.shards)
        self.stats = RunStats(path=self.impl, waves=waves,
                              row_waves=int(out["steps"].sum()),
                              host_syncs=syncs + len(pending.shards),
                              kernel_ms=prof.kernel_ms)
        pending.staged = ()
        self._check_failures(out)
        results = self._results(out, self.n_rows if rows is None else rows)
        prof.results_s = time.perf_counter() - t2
        if obs_trace.enabled():
            args = {"rows": self.n_rows, "devices": self.n_shards,
                    "path": self.impl}
            for name, start, dur in (("run", t0, prof.run_s),
                                     ("transfer", t1, prof.transfer_s),
                                     ("results", t2, prof.results_s)):
                obs_trace.complete(name, start, dur, cat="engine",
                                   track="engine", args=args)
        return results

    def run(self) -> List[SimResult]:
        """Run the batch to the end of every row; one result per row
        (dispatch, then fetch)."""
        return self.fetch(self.dispatch())

    @staticmethod
    def _transfer(shard: ShardRun) -> Dict[str, np.ndarray]:
        """Every fetched state field of a shard (and wave_run's loop
        counts) in one device-to-host copy: the fields' bytes packed into
        one buffer on the device, then split on the host."""
        fields = [(name, getattr(shard.st, name)) for name in _FETCHED]
        if shard.iters is not None:
            fields.insert(0, ("iters", shard.iters))
        buf = torch.cat([t.reshape(-1).view(torch.uint8)
                         for _, t in fields]).cpu().numpy()
        out, at = {}, 0
        for name, t in fields:
            dtype = np.dtype(str(t.dtype).replace("torch.", ""))
            size = t.numel() * dtype.itemsize
            out[name] = buf[at:at + size].view(dtype).reshape(t.shape)
            at += size
        return out

    def _check_failures(self, out: Dict[str, np.ndarray]) -> None:
        if out["stalled"].any():
            bad = int(np.nonzero(out["stalled"])[0][0])
            jids = self.row_job_ids[bad]
            missing = [jids[k] for k in range(int(self.n_jobs_row[bad]))
                       if not out["completed"][bad, k]]
            raise RuntimeError(f"deadlock in batch row {bad}: jobs "
                               f"never ran: {sorted(missing)[:8]}")
        hung = ~out["done"] & (out["steps"] >= self.max_steps)
        if hung.any():
            raise RuntimeError(f"torch batch simulator exceeded max steps "
                               f"({self.max_steps}); livelock?")

    def _results(self, out: Dict[str, np.ndarray],
                 rows: int) -> List[SimResult]:
        name = self.policy.name
        results: List[SimResult] = []
        for row in range(rows):
            job_ids = self.row_job_ids[row]
            makespan = float(out["makespan"][row])
            starts = {jid: float(out["start_t"][row, k])
                      for k, jid in enumerate(job_ids)
                      if not math.isnan(out["start_t"][row, k])}
            ends = {jid: float(out["end_t"][row, k])
                    for k, jid in enumerate(job_ids)
                    if not math.isnan(out["end_t"][row, k])}
            energy = float(out["energy"][row])
            results.append(SimResult(
                policy=name, makespan=makespan, energy_j=energy,
                avg_power_w=energy / makespan if makespan > 0 else 0.0,
                peak_power_w=float(out["peak"][row]),
                over_budget_time=float(out["over_t"][row]),
                messages=0, distributes=0, suppressed_reports=0,
                power_trace=[], job_starts=starts, job_ends=ends))
        return results


def simulate_batch_torch(graph: JobDependencyGraph,
                         specs: Sequence[NodeSpec],
                         bounds: Sequence[float],
                         policy: Union[str, TorchPolicy] = "equal-share",
                         dt: float = 0.05, latency_s: float = 0.05,
                         **kwargs) -> List[SimResult]:
    """One-call facade: one :class:`SimResult` per entry of ``bounds``."""
    return TorchBatchSimulator(graph, specs, bounds, policy=policy, dt=dt,
                               latency_s=latency_s, **kwargs).run()
