"""Optimal power-bound assignment via (M)ILP (paper §IV).

Faithful reproduction of the paper's ILP instance (§IV-B):

  * binary x_{j,b}: job j runs under power bound b, where b ranges over the
    finite DVFS-derived power set of j's node;
  * unique assignment: sum_b x_{j,b} = 1 for every job;
  * cluster power: for every depth level d, the jobs whose depth range
    contains d (the Job Concurrency Optimization output, §IV-A) may run
    concurrently, so   sum_{j in delta_d} sum_b p_b * x_{j,b}  <=  P;
  * node makespan:  sum_{j in J_i} sum_b tau(j,b) * x_{j,b}  <=  t;
  * objective min t.

The node-makespan constraint is the paper's deliberate abstraction — it
ignores cross-node waiting, which is why the paper calls the result
"optimal (or nearly optimal due [to] abstractions)".  We additionally ship
:func:`build_makespan_milp` (beyond-paper): continuous start-time variables
s_j with edge precedence constraints make t the *true* DAG makespan for the
chosen assignment, at the cost of a bigger MILP.  Both are solved with
scipy's HiGHS backend (``scipy.optimize.milp``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import Bounds, LinearConstraint, milp
from scipy.sparse import csr_matrix

from .graph import Job, JobDependencyGraph, JobId
from .power import NodeSpec, duty_states, job_time, op_time


@dataclass(frozen=True)
class PowerAssignment:
    """pi: job -> (power bound watts, frequency MHz, execution time)."""

    bounds_w: Dict[JobId, float]
    freqs_mhz: Dict[JobId, float]
    times: Dict[JobId, float]
    objective_t: float
    status: str

    def time_fn(self):
        return lambda job: self.times[job.job_id]


def _duty_grid(lut, p_equal_w: float) -> List[float]:
    """Duty fractions exposed to the ILP: a geometric ladder plus the exact
    equal-share point, so the equal-share assignment is always feasible
    (guaranteeing ILP <= equal-share in the model)."""
    from .power import DUTY_FLOOR

    qs = {DUTY_FLOOR}
    q = 0.03
    while q < 0.95:
        qs.add(round(q, 4))
        q *= 1.45
    span = lut.p_min - lut.idle_w
    q_eq = (p_equal_w - lut.idle_w) / span
    if DUTY_FLOOR <= q_eq < 1.0:
        qs.add(round(q_eq, 6))
    return sorted(qs)


def _job_options(graph: JobDependencyGraph, specs: Sequence[NodeSpec],
                 node_ids: Sequence[int],
                 cluster_bound_w: Optional[float] = None,
                 include_duty: bool = True
                 ) -> Dict[JobId, List[Tuple[float, float, float]]]:
    """Per job: list of (power_w, freq_mhz, tau) options from its node LUT.

    Options = the LUT's real DVFS states plus (``include_duty``) sub-p_min
    duty states, which are what makes "stretching" a job nearly free in
    power — the stretched job idles most of each period.
    """
    node_to_spec = {nid: specs[k] for k, nid in enumerate(node_ids)}
    p_equal = (cluster_bound_w / len(node_ids)) if cluster_bound_w else 0.0
    options: Dict[JobId, List[Tuple[float, float, float]]] = {}
    grids = {}
    for jid, job in graph.jobs.items():
        spec = node_to_spec[job.node]
        opts = []
        if include_duty:
            if id(spec.lut) not in grids:
                grids[id(spec.lut)] = _duty_grid(spec.lut, p_equal)
            for op in duty_states(spec.lut, grids[id(spec.lut)]):
                tau = op_time(job, op, spec.lut.f_max, spec.speed)
                opts.append((op.power_w, op.freq_mhz, tau))
        for st in spec.lut.states:
            tau = job_time(job, st.freq_mhz, spec.lut.f_max, spec.speed)
            opts.append((st.power_w, st.freq_mhz, tau))
        options[jid] = opts
    return options


def _solve(c, A_rows, lbs, ubs, integrality, var_bounds, n_vars,
           time_limit: float):
    A = csr_matrix((len(A_rows), n_vars)) if not A_rows else None
    rows, cols, vals = [], [], []
    for r, row in enumerate(A_rows):
        for col, v in row.items():
            rows.append(r)
            cols.append(col)
            vals.append(v)
    A = csr_matrix((vals, (rows, cols)), shape=(len(A_rows), n_vars))
    cons = LinearConstraint(A, np.asarray(lbs), np.asarray(ubs))
    # mip_rel_gap must beat the epsilon tie-break term (<= 1e-3) or HiGHS
    # may return any assignment within its default 1e-4 relative gap,
    # silently dropping the prefer-fast secondary objective.
    res = milp(c=c, constraints=cons, integrality=integrality,
               bounds=var_bounds,
               options={"time_limit": time_limit, "presolve": True,
                        "mip_rel_gap": 1e-9})
    return res


def solve_paper_ilp(graph: JobDependencyGraph, specs: Sequence[NodeSpec],
                    cluster_bound_w: float,
                    time_limit: float = 60.0) -> PowerAssignment:
    """The paper's ILP instance (§IV-B), solved to optimality via HiGHS."""
    node_ids = graph.nodes
    if len(specs) != len(node_ids):
        raise ValueError(f"{len(specs)} specs for {len(node_ids)} nodes")
    options = _job_options(graph, specs, node_ids, cluster_bound_w)

    jids = sorted(graph.jobs)
    var_index: Dict[Tuple[JobId, int], int] = {}
    for jid in jids:
        for b in range(len(options[jid])):
            var_index[(jid, b)] = len(var_index)
    t_index = len(var_index)
    n_vars = t_index + 1

    c = np.zeros(n_vars)
    c[t_index] = 1.0  # min t

    A_rows: List[Dict[int, float]] = []
    lbs: List[float] = []
    ubs: List[float] = []

    # unique assignment, one per job
    for jid in jids:
        row = {var_index[(jid, b)]: 1.0 for b in range(len(options[jid]))}
        A_rows.append(row)
        lbs.append(1.0)
        ubs.append(1.0)

    # cluster power bound, one per depth level
    for level, members in graph.depth_level_sets().items():
        row: Dict[int, float] = {}
        for jid in members:
            for b, (p_w, _f, _tau) in enumerate(options[jid]):
                row[var_index[(jid, b)]] = p_w
        A_rows.append(row)
        lbs.append(-np.inf)
        ubs.append(cluster_bound_w)

    # node makespan:  sum tau * x - t <= 0, one per node
    for nid in node_ids:
        row = {t_index: -1.0}
        for job in graph.node_jobs(nid):
            for b, (_p, _f, tau) in enumerate(options[job.job_id]):
                row[var_index[(job.job_id, b)]] = tau
        A_rows.append(row)
        lbs.append(-np.inf)
        ubs.append(0.0)

    integrality = np.ones(n_vars)
    integrality[t_index] = 0
    var_bounds = Bounds(np.zeros(n_vars),
                        np.concatenate([np.ones(t_index), [np.inf]]))

    res = _solve(c, A_rows, lbs, ubs, integrality, var_bounds, n_vars,
                 time_limit)
    if res.x is None:
        raise RuntimeError(f"paper ILP infeasible or failed: {res.message}")

    # Lexicographic tie-break: among assignments achieving the optimal t,
    # minimise the total job time.  Without this the paper's objective is
    # degenerate — jobs on non-binding nodes could be assigned arbitrarily
    # slow bounds, wrecking the *simulated* makespan while leaving the ILP
    # objective untouched.
    res, t_star = _tiebreak(res, c, A_rows, lbs, ubs, integrality,
                            var_bounds, n_vars, options, var_index, jids,
                            t_index, time_limit)
    return _extract(res, graph, options, var_index, t_index,
                    objective_t=t_star)


def _tiebreak(res, c, A_rows, lbs, ubs, integrality, var_bounds, n_vars,
              options, var_index, jids, t_index, time_limit):
    t_star = float(res.x[t_index])
    c2 = np.zeros(n_vars)
    for jid in jids:
        for b, (_p, _f, tau) in enumerate(options[jid]):
            c2[var_index[(jid, b)]] = tau
    rows2 = A_rows + [{t_index: 1.0}]
    lbs2 = list(lbs) + [-np.inf]
    ubs2 = list(ubs) + [t_star * (1 + 1e-6) + 1e-9]
    res2 = _solve(c2, rows2, lbs2, ubs2, integrality, var_bounds, n_vars,
                  time_limit)
    return (res2 if res2.x is not None else res), t_star


def build_makespan_milp(graph: JobDependencyGraph, specs: Sequence[NodeSpec],
                        cluster_bound_w: float,
                        time_limit: float = 120.0) -> PowerAssignment:
    """Beyond-paper tighter MILP: exact DAG makespan via start variables.

    Adds continuous s_j >= 0 with, for every edge (d -> j):
        s_j - s_d - sum_b tau(d,b) x_{d,b} >= 0
    and t >= s_j + sum_b tau(j,b) x_{j,b} for all j.  The cluster power
    constraint keeps the paper's depth-level abstraction (true
    time-windowed power coupling would need indicator variables).
    """
    node_ids = graph.nodes
    options = _job_options(graph, specs, node_ids, cluster_bound_w)
    jids = sorted(graph.jobs)
    var_index: Dict[Tuple[JobId, int], int] = {}
    for jid in jids:
        for b in range(len(options[jid])):
            var_index[(jid, b)] = len(var_index)
    s_index = {jid: len(var_index) + k for k, jid in enumerate(jids)}
    t_index = len(var_index) + len(jids)
    n_vars = t_index + 1

    c = np.zeros(n_vars)
    c[t_index] = 1.0

    A_rows: List[Dict[int, float]] = []
    lbs: List[float] = []
    ubs: List[float] = []

    for jid in jids:
        row = {var_index[(jid, b)]: 1.0 for b in range(len(options[jid]))}
        A_rows.append(row)
        lbs.append(1.0)
        ubs.append(1.0)

    for level, members in graph.depth_level_sets().items():
        row = {}
        for jid in members:
            for b, (p_w, _f, _tau) in enumerate(options[jid]):
                row[var_index[(jid, b)]] = p_w
        A_rows.append(row)
        lbs.append(-np.inf)
        ubs.append(cluster_bound_w)

    # precedence: s_j - s_d - sum_b tau(d,b) x_{d,b} >= 0
    for jid in jids:
        for dep in graph[jid].deps:
            row = {s_index[jid]: 1.0, s_index[dep]: -1.0}
            for b, (_p, _f, tau) in enumerate(options[dep]):
                row[var_index[(dep, b)]] = -tau
            A_rows.append(row)
            lbs.append(0.0)
            ubs.append(np.inf)

    # t >= s_j + tau_j
    for jid in jids:
        row = {t_index: 1.0, s_index[jid]: -1.0}
        for b, (_p, _f, tau) in enumerate(options[jid]):
            row[var_index[(jid, b)]] = -tau
        A_rows.append(row)
        lbs.append(0.0)
        ubs.append(np.inf)

    integrality = np.zeros(n_vars)
    for v in var_index.values():
        integrality[v] = 1
    ub = np.full(n_vars, np.inf)
    ub[: len(var_index)] = 1.0
    var_bounds = Bounds(np.zeros(n_vars), ub)

    res = _solve(c, A_rows, lbs, ubs, integrality, var_bounds, n_vars,
                 time_limit)
    if res.x is None:
        raise RuntimeError(f"makespan MILP failed: {res.message}")
    res, t_star = _tiebreak(res, c, A_rows, lbs, ubs, integrality,
                            var_bounds, n_vars, options, var_index, jids,
                            t_index, time_limit)
    return _extract(res, graph, options, var_index, t_index,
                    objective_t=t_star)


def _extract(res, graph, options, var_index, t_index,
             objective_t: Optional[float] = None) -> PowerAssignment:
    x = res.x
    bounds_w: Dict[JobId, float] = {}
    freqs: Dict[JobId, float] = {}
    times: Dict[JobId, float] = {}
    for jid in graph.jobs:
        chosen = None
        for b, (p_w, f, tau) in enumerate(options[jid]):
            if x[var_index[(jid, b)]] > 0.5:
                chosen = (p_w, f, tau)
                break
        if chosen is None:  # numerically fuzzy relaxation — take argmax
            b = int(np.argmax([x[var_index[(jid, bb)]]
                               for bb in range(len(options[jid]))]))
            chosen = options[jid][b]
        bounds_w[jid], freqs[jid], times[jid] = chosen
    return PowerAssignment(bounds_w=bounds_w, freqs_mhz=freqs, times=times,
                           objective_t=(float(x[t_index])
                                        if objective_t is None
                                        else objective_t),
                           status=str(res.message))


def equal_share_assignment(graph: JobDependencyGraph,
                           specs: Sequence[NodeSpec],
                           cluster_bound_w: float) -> PowerAssignment:
    """Baseline: every node capped at P/n forever (paper's Equal-share)."""
    from .power import operating_point

    node_ids = graph.nodes
    p_o = cluster_bound_w / len(node_ids)
    node_to_spec = {nid: specs[k] for k, nid in enumerate(node_ids)}
    bounds_w, freqs, times = {}, {}, {}
    for jid, job in graph.jobs.items():
        spec = node_to_spec[job.node]
        op = operating_point(spec.lut, p_o)
        bounds_w[jid] = p_o
        freqs[jid] = op.freq_mhz
        times[jid] = op_time(job, op, spec.lut.f_max, spec.speed)
    mk = graph.makespan(lambda j: times[j.job_id])
    return PowerAssignment(bounds_w=bounds_w, freqs_mhz=freqs, times=times,
                           objective_t=mk, status="equal-share")


def assignment_peak_power(graph: JobDependencyGraph,
                          assignment: PowerAssignment,
                          specs: Sequence[NodeSpec]) -> float:
    """True peak instantaneous power of an assignment under earliest-start
    scheduling — audits the paper's depth-level abstraction."""
    node_ids = graph.nodes
    node_to_spec = {nid: specs[k] for k, nid in enumerate(node_ids)}
    start, comp = graph.completion_times(assignment.time_fn())
    events = sorted({*start.values(), *comp.values()})
    peak = 0.0
    for tpt in events:
        p = 0.0
        for nid in node_ids:
            running = [j for j in graph.node_jobs(nid)
                       if start[j.job_id] <= tpt < comp[j.job_id]]
            if running:
                p += assignment.bounds_w[running[0].job_id]
            else:
                p += node_to_spec[nid].lut.idle_w
        peak = max(peak, p)
    return peak
