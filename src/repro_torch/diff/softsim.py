"""The soft wave loop: ``soft_makespan`` and its policy-driven variant.

The port of the reference's ``repro.diff.softsim``.  The structure
mirrors :meth:`repro_torch.core.batchsim.BatchSimulator.run` wave for
wave, with the two relaxations of :mod:`repro_torch.diff.relax` swapped
in and the dynamic ``while`` replaced by a fixed number of waves, a
Python loop on torch autograd (the reference's ``lax.scan``).  The
discrete state machine (which lane finishes, which job starts) is still
driven by *hard* comparisons, but on smoothly computed times, so
gradients flow through the event *times* while the event *ordering*
stays combinatorial:

* the Boltzmann advance is >= the earliest candidate, so every wave
  still consumes at least one event and ``max_waves = J + knots +
  slack`` bounds the loop;
* at an exact event *tie* the ordering is non-differentiable in the
  underlying problem; the relaxation averages over the tie instead of
  picking a side, which is where its gradients stop being trustworthy.

Every write into a state vector is out of place (``index_put`` without
``accumulate``), so autograd sees each wave's state.  Lanes with nothing
to write aim at the sentinel job slot ``J``; duplicate targets only ever
hit it, and the makespan drops it (``end_t[:J]``).  Nothing in the loop
reads a tensor back to the host, so ``torch.func.vmap`` maps it over a
batch of caps and a card runs it without a sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.arrays import build_graph_arrays
from repro_torch.core.graph import JobDependencyGraph
from repro_torch.core.power import LUTTable, NodeSpec

from .relax import smooth_operating_point, soft_max_time, soft_min_time

BIG_TIME = 1e30

_TABLE_FIELDS = ("state_p", "state_f", "idle_w", "p_min", "p_max", "f_min",
                 "f_nom", "span", "speed", "cap_floor")


class SoftArrays(NamedTuple):
    """Static geometry for the soft loop (tensors on one device, float64
    and int64) and its loop bounds.

    Built once per (graph, cluster) by :func:`build_soft_arrays`;
    ``max_waves``/``settle_iters`` size the unrolled control structure.
    """

    work_pad: torch.Tensor    # (J+1,) work units, sentinel 0
    rho_pad: torch.Tensor     # (J+1,) cpu_frac, sentinel 1
    node_seq: torch.Tensor    # (N, K) per-lane job slots, J padded
    deps_pad: torch.Tensor    # (J+1, D) dependency slots, J padded
    table: LUTTable           # (N, S)/(N,) cluster tables, as tensors
    n_jobs: int               # J
    n_nodes: int              # N
    max_waves: int            # loop length (before schedule knots)
    settle_iters: int         # unrolled start/instant-complete passes

    @property
    def device(self) -> torch.device:
        return self.work_pad.device


def soft_arrays_from_numpy(work_pad, rho_pad, node_seq, deps_pad, table,
                           n_jobs: int, n_nodes: int, max_waves: int,
                           settle_iters: int, device) -> SoftArrays:
    """:class:`SoftArrays` from numpy leaves and a numpy ``LUTTable``."""
    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    def i64(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    return SoftArrays(
        work_pad=f64(work_pad), rho_pad=f64(rho_pad),
        node_seq=i64(node_seq), deps_pad=i64(deps_pad),
        table=LUTTable(**{k: f64(getattr(table, k))
                          for k in _TABLE_FIELDS}),
        n_jobs=int(n_jobs), n_nodes=int(n_nodes),
        max_waves=int(max_waves), settle_iters=int(settle_iters))


def build_soft_arrays(graph: JobDependencyGraph,
                      specs: Sequence[NodeSpec], extra_waves: int = 4,
                      device=None) -> SoftArrays:
    """Flatten (graph, cluster) for the soft loop, on ``device`` (``None``
    is the card: it raises without one; ``"cpu"`` for the CPU).

    Every wave consumes at least one completion (the Boltzmann advance
    is >= the earliest candidate), so ``J + extra_waves`` waves always
    suffice; each settle pass needs one extra iteration per link of a
    zero-work dependency chain, bounded above by the zero-work job
    count.
    """
    from repro_torch.backends.engine import resolve_device

    dev = resolve_device(device)
    ga = build_graph_arrays(graph, specs)
    j = ga.n_jobs
    zero_work = int((ga.work_pad[:j] <= 0.0).sum())
    return soft_arrays_from_numpy(
        ga.work_pad, ga.rho_pad, ga.node_seq, ga.deps_pad, ga.table,
        n_jobs=j, n_nodes=ga.n_nodes, max_waves=j + extra_waves,
        settle_iters=2 + zero_work, device=dev)


class _Geometry(NamedTuple):
    """One run's view of :class:`SoftArrays`: float leaves in the run's
    type."""

    work_pad: torch.Tensor
    rho_pad: torch.Tensor
    node_seq: torch.Tensor
    deps_pad: torch.Tensor
    table: LUTTable
    n_jobs: int
    settle_iters: int
    true: torch.Tensor       # 0-d True, the value ``_mark`` writes


def _geometry(soft: SoftArrays, dtype) -> _Geometry:
    table = LUTTable(**{k: getattr(soft.table, k).to(dtype)
                        for k in _TABLE_FIELDS})
    return _Geometry(soft.work_pad.to(dtype), soft.rho_pad.to(dtype),
                     soft.node_seq, soft.deps_pad, table, soft.n_jobs,
                     soft.settle_iters,
                     torch.ones((), dtype=torch.bool, device=soft.device))


class _SoftState(NamedTuple):
    ptr: torch.Tensor        # (N,) i64 position in each lane's sequence
    running: torch.Tensor    # (N,) bool
    remaining: torch.Tensor  # (N,) work units left on the current job
    completed: torch.Tensor  # (J+1,) bool, sentinel born True
    t: torch.Tensor          # scalar row time
    end_t: torch.Tensor      # (J+1,) completion times (0 until completed)


def _cur(geo: _Geometry, ptr: torch.Tensor) -> torch.Tensor:
    return geo.node_seq.gather(1, ptr[:, None])[:, 0]


def _mark(geo: _Geometry, st: _SoftState, tgt: torch.Tensor,
          t_now: torch.Tensor):
    """``completed[tgt] = True`` and ``end_t[tgt] = t_now``, out of place
    (the sentinel slot collects every lane with nothing to write)."""
    completed = st.completed.index_put((tgt,), geo.true)
    end_t = st.end_t.index_put((tgt,), t_now.expand(tgt.shape))
    return completed, end_t


def _settle(geo: _Geometry, st: _SoftState) -> _SoftState:
    """Start every ready job, complete zero-work jobs instantly; one
    unrolled pass per possible cascade link."""
    j = geo.n_jobs
    for _ in range(geo.settle_iters):
        cur = _cur(geo, st.ptr)
        deps_ok = st.completed[geo.deps_pad[cur]].all(dim=-1)
        ready = (~st.running) & (cur < j) & deps_ok
        running = st.running | ready
        remaining = torch.where(ready, geo.work_pad[cur], st.remaining)
        instant = running & (remaining <= 0.0)
        tgt = torch.where(instant, cur, j)
        # the sentinel slot is junk
        completed, end_t = _mark(geo, st, tgt, st.t)
        st = _SoftState(
            ptr=st.ptr + instant, running=running & ~instant,
            remaining=remaining, completed=completed, t=st.t, end_t=end_t)
    return st


def _init_state(geo: _Geometry, n: int, dtype, device) -> _SoftState:
    j = geo.n_jobs
    completed = torch.zeros(j + 1, dtype=torch.bool, device=device)
    completed[j] = True
    return _SoftState(
        ptr=torch.zeros(n, dtype=torch.int64, device=device),
        running=torch.zeros(n, dtype=torch.bool, device=device),
        remaining=torch.zeros(n, dtype=dtype, device=device),
        completed=completed,
        t=torch.zeros((), dtype=dtype, device=device),
        end_t=torch.zeros(j + 1, dtype=dtype, device=device))


def _pick(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``x[k]`` for a 0-d index tensor, without reading it on the host."""
    return torch.index_select(x, 0, k.reshape(1))[0]


def _soft_run(caps_of, soft: SoftArrays, temperature, n_extra_events: int,
              knot_times: Optional[torch.Tensor], dtype):
    """The shared loop: ``caps_of(t, st, geo) -> (N,)`` supplies the
    wave's caps."""
    geo = _geometry(soft, dtype)
    j = geo.n_jobs
    table = geo.table
    device = soft.device
    nk = 0 if knot_times is None else knot_times.shape[0]
    if nk:
        knots_pad = torch.cat(
            [knot_times.to(dtype),
             torch.full((1,), BIG_TIME, dtype=dtype, device=device)])
    zero = torch.zeros((), dtype=dtype, device=device)
    st = _settle(geo, _init_state(geo, soft.n_nodes, dtype, device))

    for _ in range(soft.max_waves + n_extra_events):
        done = st.completed[:j].all()
        caps = caps_of(st.t, st, geo)
        freq, duty, power = smooth_operating_point(table, caps)
        cur = _cur(geo, st.ptr)
        rho = geo.rho_pad[cur]
        slowdown = rho * (table.f_nom / freq) + (1.0 - rho)
        rate = torch.where(st.running, table.speed * duty / slowdown, 0.0)
        live = st.running & (rate > 0) & ~done
        rate_safe = torch.where(live, rate, 1.0)
        t_fin = torch.where(live, torch.maximum(st.remaining, zero)
                            / rate_safe, BIG_TIME)
        times, valid = t_fin, live
        if nk:
            knot = (st.t >= knots_pad[:nk]).sum()
            t_knot = _pick(knots_pad, knot) - st.t
            times = torch.cat([times, t_knot[None]])
            valid = torch.cat([valid, ((knot < nk) & ~done)[None]])
        delta = soft_min_time(times, valid, temperature)
        finishing = st.running & (t_fin <= delta * (1 + 1e-6) + 1e-9)
        t_new = st.t + delta
        tgt = torch.where(finishing, cur, j)
        completed, end_t = _mark(geo, st, tgt, t_new)
        st = _SoftState(
            ptr=st.ptr + finishing, running=st.running & ~finishing,
            remaining=torch.where(finishing, 0.0,
                                  st.remaining - rate * delta),
            completed=completed, t=t_new, end_t=end_t)
        st = _settle(geo, st)

    makespan = soft_max_time(st.end_t[:j], temperature)
    return makespan, st


def _aux(soft: SoftArrays, st: _SoftState) -> dict:
    return {"done": st.completed[:soft.n_jobs].all(),
            "end_t": st.end_t[:soft.n_jobs]}


def _as_float(x, device) -> torch.Tensor:
    """``x`` as a tensor on ``device``: a float tensor or numpy array keeps
    its type (as ``jnp.result_type(x, 0.1)`` does), anything else takes
    the default type."""
    t = torch.as_tensor(x, device=device)
    return t if t.is_floating_point() else t.to(torch.get_default_dtype())


def soft_makespan(caps, soft: SoftArrays, temperature, knot_times=None,
                  return_aux: bool = False):
    """Differentiable makespan of per-node cap assignment ``caps``.

    ``caps`` is ``(N,)`` static watts, or ``(K, N)`` piecewise-constant
    with ``knot_times`` the ``(K-1,)`` absolute switch times (caps row
    ``k`` applies from ``knot_times[k-1]``; knot crossings are wave
    boundaries, like scheduled bound arrivals in the exact backends).
    The run's type is that of ``caps`` (a float tensor or numpy array;
    anything else takes the default type).  ``temperature`` controls both
    relaxations; as it goes to 0 the result converges to the
    ``BatchSimulator(smooth_lut=True)`` makespan under the same caps.
    Gradients flow to ``caps`` and not to ``knot_times``: knot *timing*
    is a hard branch by design.

    With ``return_aux`` also returns ``{"done": all-jobs-completed,
    "end_t": per-job soft completion times}`` for diagnostics.
    """
    caps = _as_float(caps, soft.device)
    dtype = caps.dtype
    if caps.dim() == 2:
        if knot_times is None:
            raise ValueError("(K, N) caps need knot_times")
        knot_times = torch.as_tensor(knot_times, device=soft.device)
        knot_times = knot_times.detach().to(dtype)
        nk = knot_times.shape[0]
        if caps.shape[0] != nk + 1:
            raise ValueError(f"caps rows {caps.shape[0]} != "
                             f"len(knot_times) + 1 = {nk + 1}")

        def caps_of(t, st, geo):
            return _pick(caps, (t >= knot_times).sum())
    else:
        knot_times = None
        nk = 0

        def caps_of(t, st, geo):
            return caps

    temp = torch.as_tensor(temperature, dtype=dtype, device=soft.device)
    ms, st = _soft_run(caps_of, soft, temp, nk, knot_times, dtype)
    return (ms, _aux(soft, st)) if return_aux else ms


def soft_makespan_policy(params, soft: SoftArrays, bound, temperature,
                         return_aux: bool = False):
    """Differentiable makespan under the ``"learned"`` MLP policy.

    Each wave recomputes ``caps = f(state)`` from the same xp-generic
    core the event, vector and torch adapters run
    (:func:`repro_torch.policies.learned.compute_caps`, through the torch
    engine's array namespace), so parameters trained through this
    function mean the same policy everywhere.  ``params`` maps the MLP's
    leaf names to tensors (or arrays); the run's type is that of
    ``bound`` when it is a float tensor, else that of ``params["W1"]``
    when that is one, else the default type.  Gradients flow to the
    ``params`` leaves and to ``bound``.
    """
    from repro_torch.backends.policies import _TorchXP
    from repro_torch.policies.learned import compute_caps

    device = soft.device
    w1 = params["W1"]
    dtype = (bound.dtype if torch.is_tensor(bound)
             and bound.is_floating_point() else
             w1.dtype if torch.is_tensor(w1) else torch.get_default_dtype())
    bound = torch.as_tensor(bound, dtype=dtype, device=device)
    params = {k: v if torch.is_tensor(v)
              else torch.as_tensor(v, dtype=dtype, device=device)
              for k, v in params.items()}
    n_active = torch.tensor(float(soft.n_nodes), dtype=dtype, device=device)

    def caps_of(t, st, geo):
        rho = geo.rho_pad[_cur(geo, st.ptr)]
        tab = geo.table
        return compute_caps(
            _TorchXP, params, running=st.running,
            rho=torch.where(st.running, rho, 0.0), bound=bound * 1.0,
            n_active=n_active, p_max=tab.p_max, cap_floor=tab.cap_floor,
            idle_w=tab.idle_w)

    temp = torch.as_tensor(temperature, dtype=dtype, device=device)
    ms, st = _soft_run(caps_of, soft, temp, 0, None, dtype)
    return (ms, _aux(soft, st)) if return_aux else ms
