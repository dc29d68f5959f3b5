"""Static batch geometry: a (graph, cluster) flattened into arrays.

The port's copy of the reference's numpy geometry builders
(``repro.core.batchsim``): :class:`GraphArrays` for one graph on one
cluster (the shared layout), :class:`BatchArrays` for B different
(graph, cluster) rows padded to one envelope (the stacked layout), and
the padded bound-schedule arrays.  Everything here is numpy; the engine
(:mod:`repro_torch.backends.engine`) moves it to the device once.

Job slot ``J`` (= ``n_jobs``) is the "no job" sentinel: zero work,
always complete.  In a padded batch, job slots past a row's real job
count are *phantom* (zero work, born completed) and node lanes past its
real node count are *phantom* (their whole ``node_seq`` row is the
sentinel and their table columns hold the zero-power phantom values of
:func:`repro_torch.core.power.stack_lut_tables`), so a padded row's
physics is the same as running it unpadded.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .graph import JobDependencyGraph, JobId
from .power import LUTTable, NodeSpec, lut_table, stack_lut_tables

#: Finite stand-in for "no further scheduled event" used to pad
#: ``bound_schedules`` rows (the kernel's BIG_TIME; finite so the padded
#: arrays survive float32 min-reductions).
BIG_EVENT_TIME = 1e30


class GraphArrays(NamedTuple):
    """Static (graph, cluster) geometry of the shared layout."""

    job_ids: Tuple[JobId, ...]   # sorted job ids; slot k <-> job_ids[k]
    work_pad: np.ndarray         # (J+1,) work units, sentinel 0
    rho_pad: np.ndarray          # (J+1,) cpu_frac, sentinel 1
    node_seq: np.ndarray         # (N, K+1) per-lane job slots, J padded
    deps_pad: np.ndarray         # (J+1, D) dependency slots, J padded
    table: LUTTable              # stacked cluster LUTs

    @property
    def n_jobs(self) -> int:
        """Real job count J (the sentinel slot is not counted)."""
        return len(self.job_ids)

    @property
    def n_nodes(self) -> int:
        """Node count N (= lane count; no padding in this layout)."""
        return self.node_seq.shape[0]


def build_graph_arrays(graph: JobDependencyGraph,
                       specs: Sequence[NodeSpec]) -> GraphArrays:
    """Flatten a validated graph + cluster into :class:`GraphArrays`."""
    node_ids = graph.nodes
    n = len(node_ids)
    job_ids: List[JobId] = sorted(graph.jobs)
    j = len(job_ids)
    k_of = {jid: k for k, jid in enumerate(job_ids)}
    work_pad = np.zeros(j + 1)
    rho_pad = np.ones(j + 1)
    for k, jid in enumerate(job_ids):
        work_pad[k] = graph.jobs[jid].work
        rho_pad[k] = graph.jobs[jid].cpu_frac
    seqs = [[k_of[job.job_id] for job in graph.node_jobs(nid)]
            for nid in node_ids]
    k_max = max(len(s) for s in seqs)
    node_seq = np.full((n, k_max + 1), j, dtype=np.int64)
    for i, s in enumerate(seqs):
        node_seq[i, :len(s)] = s
    d_max = max((len(graph.jobs[jid].deps) for jid in job_ids),
                default=0) or 1
    deps_pad = np.full((j + 1, d_max), j, dtype=np.int64)
    for k, jid in enumerate(job_ids):
        deps = [k_of[d] for d in graph.jobs[jid].deps]
        deps_pad[k, :len(deps)] = deps
    return GraphArrays(job_ids=tuple(job_ids), work_pad=work_pad,
                       rho_pad=rho_pad, node_seq=node_seq,
                       deps_pad=deps_pad, table=lut_table(specs))


class BatchArrays(NamedTuple):
    """Per-row stacked geometry for a mixed-shape (padded) batch.

    Shapes: ``B`` rows, each padded to ``N`` node lanes, ``J`` job slots
    (plus the per-row sentinel slot ``J``), ``K`` per-lane sequence
    length, ``D`` dependency fan-in, ``S`` LUT states.
    """

    row_job_ids: Tuple[Tuple[JobId, ...], ...]  # per-row sorted job ids
    n_jobs_row: np.ndarray       # (B,) real job count per row
    n_active: np.ndarray         # (B,) real node count per row
    work_pad: np.ndarray         # (B, J+1)
    rho_pad: np.ndarray          # (B, J+1)
    node_seq: np.ndarray         # (B, N, K)
    deps_pad: np.ndarray         # (B, J+1, D)
    table: LUTTable              # (B, N, S)/(B, N) leaves

    @property
    def n_jobs(self) -> int:
        """Padded job-slot count J (>= every row's real job count)."""
        return self.work_pad.shape[1] - 1

    @property
    def n_nodes(self) -> int:
        """Padded lane count N (>= every row's real node count)."""
        return self.node_seq.shape[1]


def stack_graph_arrays(items: Sequence[Tuple[JobDependencyGraph,
                                             Sequence[NodeSpec]]],
                       pad_dims: Optional[Tuple[int, int, int, int, int]]
                       = None) -> BatchArrays:
    """Stack per-row (graph, specs) pairs into one :class:`BatchArrays`.

    ``pad_dims`` is the ``(N, J, K, D, S)`` padding envelope (``K``
    counts the full ``node_seq`` second axis, i.e. max jobs per lane
    + 1); when omitted, the tight maxima over the rows are used.
    """
    if not items:
        raise ValueError("padded batch needs at least one (graph, specs)")
    cache: dict = {}
    gas: List[GraphArrays] = []
    for graph, specs in items:
        key = (id(graph), tuple(id(sp) for sp in specs))
        ga = cache.get(key)
        if ga is None:
            ga = cache[key] = build_graph_arrays(graph, specs)
        gas.append(ga)
    need = (max(ga.n_nodes for ga in gas),
            max(ga.n_jobs for ga in gas),
            max(ga.node_seq.shape[1] for ga in gas),
            max(ga.deps_pad.shape[1] for ga in gas),
            max(ga.table.state_p.shape[1] for ga in gas))
    if pad_dims is None:
        pad_dims = need
    if any(p < m for p, m in zip(pad_dims, need)):
        raise ValueError(f"pad_dims {pad_dims} smaller than row "
                         f"maxima {need}")
    n, j, k, d, s = pad_dims
    b = len(gas)
    work = np.zeros((b, j + 1))
    rho = np.ones((b, j + 1))
    node_seq = np.full((b, n, k), j, dtype=np.int64)
    deps = np.full((b, j + 1, d), j, dtype=np.int64)
    for r, ga in enumerate(gas):
        jb = ga.n_jobs
        work[r, :jb] = ga.work_pad[:jb]
        rho[r, :jb] = ga.rho_pad[:jb]
        # remap the row's own sentinel (jb) to the padded sentinel (j)
        ns = np.where(ga.node_seq == jb, j, ga.node_seq)
        node_seq[r, :ga.n_nodes, :ns.shape[1]] = ns
        dp = np.where(ga.deps_pad == jb, j, ga.deps_pad)
        deps[r, :jb, :dp.shape[1]] = dp[:jb]
    table = stack_lut_tables([ga.table for ga in gas], n, s)
    return BatchArrays(
        row_job_ids=tuple(ga.job_ids for ga in gas),
        n_jobs_row=np.array([ga.n_jobs for ga in gas]),
        n_active=np.array([ga.n_nodes for ga in gas]),
        work_pad=work, rho_pad=rho, node_seq=node_seq, deps_pad=deps,
        table=table)


def validate_padded_items(items, bounds) -> Tuple[list, list]:
    """Validate a padded batch's per-row inputs: every graph is a valid
    DAG with one NodeSpec per node, and there is exactly one bound per
    row.  Returns ``(items, bounds)`` as lists."""
    items = list(items)
    bounds = list(bounds)
    for graph, specs in items:
        graph.topological_order()          # validates each DAG
        if len(specs) != len(graph.nodes):
            raise ValueError("one NodeSpec per graph node required")
    if len(bounds) != len(items):
        raise ValueError(f"padded batch needs one bound per row: got "
                         f"{len(bounds)} bounds for {len(items)} rows")
    return items, bounds


def pad_bound_schedules(
        schedules: Optional[Sequence[Sequence[Tuple[float, float]]]],
        n_rows: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Normalize per-row bound schedules into padded ``(B, T)`` arrays.

    Returns ``(sched_t, sched_w)`` — per-row change times (sorted,
    padded with :data:`BIG_EVENT_TIME`) and the bound in watts that
    takes effect at each — or ``None`` when every row's schedule is
    empty.  Times must be non-negative (a past arrival would run a wave
    backwards); the sort is *stable*, so same-time arrivals apply in
    their given order.
    """
    if schedules is None:
        return None
    if len(schedules) != n_rows:
        raise ValueError(f"got {len(schedules)} bound schedules for "
                         f"{n_rows} batch rows")
    if all(not s for s in schedules):
        return None
    t_max = max(len(s) for s in schedules)
    sched_t = np.full((n_rows, t_max), BIG_EVENT_TIME)
    sched_w = np.zeros((n_rows, t_max))
    for r, entries in enumerate(schedules):
        entries = [(float(t), float(w)) for t, w in entries]
        if any(t < 0 for t, _ in entries):
            raise ValueError(f"bound-schedule times must be >= 0 "
                             f"(row {r}: {entries})")
        entries.sort(key=lambda e: e[0])
        for i, (t, w) in enumerate(entries):
            sched_t[r, i] = t
            sched_w[r, i] = w
    return sched_t, sched_w
