"""Power / frequency models (paper §V-A, Eq. 3; §IV-B power-bound sets).

The port's own numpy copy of the reference's ``repro.core.power``: the
LUTs, the cluster presets, the stacked :class:`LUTTable` and its phantom
padding convention, and the scalar and batched numpy translators the
port's event and vector simulators run (the torch engine translates caps
inside :mod:`repro_torch.kernels.power_step`).

The paper abstracts DVFS into a finite lookup table measured per node:
CPU frequency -> full-load power, plus idle power, and — for multicore
nodes — power at every (active cores, frequency) pair (Eq. 3).  The ILP
operates on the induced finite set of per-job power bounds; the online
heuristic's power-to-frequency *translator* picks the highest frequency
whose power fits the granted bound.

Two LUT families ship with the framework:

* :func:`arndale_like_lut` / :func:`odroid_like_lut` — synthetic tables in
  the style of the paper's ARM boards (Arndale Exynos 5410 dual-A15,
  ODROID XU-2 quad-A15).  Shapes follow public A15 DVFS characteristics:
  power grows ~ f^3 at the high end (P = P_static + c·f·V(f)^2, V rising
  with f).  Used by the reproduction benchmarks.
* :func:`tpu_v5e_lut` — an analytical per-chip table for the TPU target:
  a chip at power cap p delivers throughput ~ (p/p_tdp)^(1/alpha) of peak.
  Used when scheduling the LM workloads' extracted HLO graphs.

Execution-time model (tau of §III): a job with ``work`` units and
``cpu_frac`` rho running at frequency f takes

    tau = work * (rho * f_nom / f + (1 - rho))

i.e. the CPU-bound fraction scales inversely with frequency and the
memory/IO fraction does not — consistent with the paper's finding that
CPU-bound benchmarks (EP) gain most and memory-bound ones (IS) less.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .graph import Job


@dataclass(frozen=True)
class PowerState:
    """One row of the LUT: running flat-out at ``freq_mhz`` draws ``power_w``."""

    freq_mhz: float
    power_w: float


@dataclass(frozen=True)
class PowerLUT:
    """Per-node frequency<->power table (paper §V-A).

    ``states`` must be sorted by frequency.  ``idle_w`` is p_s.  The
    multicore extension stores power per (active cores, frequency) in
    ``multicore``, keyed by core count, enabling Eq. (3):

        p_g = p_(m_c - 1, f_c) - p_s   (one job per core, one job blocks)
    """

    name: str
    states: Tuple[PowerState, ...]
    idle_w: float
    cores: int = 1
    multicore: Dict[int, Tuple[PowerState, ...]] = field(default_factory=dict)

    def __post_init__(self):
        freqs = [s.freq_mhz for s in self.states]
        if freqs != sorted(freqs):
            raise ValueError("LUT states must be sorted by frequency")
        if not self.states:
            raise ValueError("empty LUT")
        powers = [s.power_w for s in self.states]
        if powers != sorted(powers):
            raise ValueError("power must be monotone in frequency")
        if self.idle_w >= self.states[0].power_w:
            raise ValueError("idle power must sit below the lowest state")

    # -------------------------------------------------------------- queries
    @property
    def f_max(self) -> float:
        return self.states[-1].freq_mhz

    @property
    def p_max(self) -> float:
        return self.states[-1].power_w

    @property
    def p_min(self) -> float:
        return self.states[0].power_w

    def power_at(self, freq_mhz: float) -> float:
        for s in self.states:
            if abs(s.freq_mhz - freq_mhz) < 1e-9:
                return s.power_w
        raise KeyError(f"{self.name}: no LUT state at {freq_mhz} MHz")

    def freq_for_power(self, bound_w: float) -> float | None:
        """Power-to-frequency translator (§V): max frequency fitting bound.

        Returns None if even the lowest state exceeds the bound (the node
        must then run at the lowest state regardless — a power bound below
        p_min is infeasible for a *running* node; callers clamp).
        """
        best = None
        for s in self.states:
            if s.power_w <= bound_w + 1e-12:
                best = s.freq_mhz
        return best

    def freq_for_power_clamped(self, bound_w: float) -> float:
        f = self.freq_for_power(bound_w)
        return self.states[0].freq_mhz if f is None else f


@dataclass(frozen=True)
class NodeSpec:
    """A cluster node: its LUT and its relative nominal speed.

    ``speed`` rescales work: a job of w units takes w/speed at f_nom on this
    node — how we model heterogeneous clusters (Arndale vs ODROID, or TPU
    v5e vs a throttled/older pod).
    """

    lut: PowerLUT
    speed: float = 1.0


def job_time(job: Job, freq_mhz: float, f_nom_mhz: float,
             speed: float = 1.0) -> float:
    """tau(J, P->f): execution time of a job at a frequency (see module doc)."""
    if freq_mhz <= 0:
        raise ValueError("frequency must be positive")
    rho = job.cpu_frac
    slowdown = rho * (f_nom_mhz / freq_mhz) + (1.0 - rho)
    return (job.work / speed) * slowdown


def progress_rate(job: Job, freq_mhz: float, f_nom_mhz: float,
                  speed: float = 1.0) -> float:
    """Work-units per second while running at ``freq_mhz`` (simulator use)."""
    return job.work / job_time(job, freq_mhz, f_nom_mhz, speed) \
        if job.work > 0 else float("inf")


# ----------------------------------------------------- sub-p_min duty states
#: Progress floor for caps at/below idle power — a granted bound can never
#: fully halt a node (it would deadlock the program); physical power capping
#: (forced-idle injection) has the same floor.
DUTY_FLOOR = 0.02


@dataclass(frozen=True)
class OperatingPoint:
    """How a node actually runs under a granted power bound.

    ``duty`` = 1.0 means a pure DVFS state at ``freq_mhz``.  ``duty`` < 1.0
    models RAPL-style forced-idle capping *below* the lowest DVFS state:
    the node runs at f_min for a ``duty`` fraction of wall-clock and is
    clock-gated (idle power) for the rest, so active power is
    ``idle + duty * (p_min - idle)`` and throughput is ``duty * rate(f_min)``.

    The paper's ILP abstracts power bounds "into a finite set ... that map
    to operating frequencies"; its tightest simulated cluster bounds sit
    below n * p(f_min), which is only meaningful with such sub-minimum
    states — see DESIGN.md §5.
    """

    freq_mhz: float
    duty: float
    power_w: float


def operating_point(lut: PowerLUT, cap_w: float) -> OperatingPoint:
    """Power-to-frequency translator (§V) extended with duty states."""
    f = lut.freq_for_power(cap_w)
    if f is not None:
        return OperatingPoint(freq_mhz=f, duty=1.0, power_w=lut.power_at(f))
    span = lut.p_min - lut.idle_w
    q = (cap_w - lut.idle_w) / span
    q = min(1.0, max(DUTY_FLOOR, q))
    f0 = lut.states[0].freq_mhz
    return OperatingPoint(freq_mhz=f0, duty=q,
                          power_w=lut.idle_w + q * span)


def op_time(job: Job, op: OperatingPoint, f_nom_mhz: float,
            speed: float = 1.0) -> float:
    """tau(J, operating point): duty cycling stretches time by 1/duty."""
    return job_time(job, op.freq_mhz, f_nom_mhz, speed) / op.duty


def op_rate(job: Job, op: OperatingPoint, f_nom_mhz: float,
            speed: float = 1.0) -> float:
    return op.duty * progress_rate(job, op.freq_mhz, f_nom_mhz, speed)


def cap_floor_w(lut: PowerLUT) -> float:
    """Lowest meaningful power grant for a node: the duty-floor operating
    point's draw.  THE definition — ``ClusterView.clamp`` and the batch
    backend's :attr:`LUTTable.cap_floor` must agree or the vector
    waterfill stops mirroring the event oracle."""
    return lut.idle_w + DUTY_FLOOR * (lut.p_min - lut.idle_w)


def duty_states(lut: PowerLUT,
                qs: Sequence[float] = (DUTY_FLOOR, 0.0625, 0.125, 0.25,
                                       0.5, 0.75)
                ) -> List[OperatingPoint]:
    """Virtual sub-p_min states exposed to the ILP alongside real states."""
    span = lut.p_min - lut.idle_w
    f0 = lut.states[0].freq_mhz
    return [OperatingPoint(freq_mhz=f0, duty=q,
                           power_w=lut.idle_w + q * span)
            for q in qs]


# ------------------------------------------------------- vectorized tables
@dataclass(frozen=True)
class LUTTable:
    """A cluster's LUTs stacked into arrays for batched translation.

    ``state_p``/``state_f`` are ``(n_nodes, max_states)`` with short LUTs
    padded by ``+inf`` power rows (a pad never fits any cap, so the fitting
    states of each node are exactly its real prefix).  Everything here is
    plain gather/compare/where arithmetic, so the same lookup is
    a plain tensor program (see :mod:`repro_torch.kernels.power_step`).
    """

    state_p: np.ndarray   # (N, S) full-load power per state, +inf padded
    state_f: np.ndarray   # (N, S) frequency per state
    idle_w: np.ndarray    # (N,)
    p_min: np.ndarray     # (N,) lowest real state's power
    p_max: np.ndarray     # (N,) highest real state's power
    f_min: np.ndarray     # (N,)
    f_nom: np.ndarray     # (N,) nominal (= max) frequency
    span: np.ndarray      # (N,) p_min - idle_w (duty-state range)
    speed: np.ndarray     # (N,) NodeSpec.speed

    cap_floor: np.ndarray = None  # (N,) per-node cap_floor_w

    @property
    def n_nodes(self) -> int:
        return self.state_p.shape[0]


def lut_table(specs: Sequence[NodeSpec]) -> LUTTable:
    """Stack a cluster's (possibly heterogeneous) LUTs into a LUTTable."""
    n_states = max(len(s.lut.states) for s in specs)
    state_p = np.full((len(specs), n_states), np.inf)
    state_f = np.zeros((len(specs), n_states))
    for i, spec in enumerate(specs):
        k = len(spec.lut.states)
        state_p[i, :k] = [st.power_w for st in spec.lut.states]
        state_f[i, :k] = [st.freq_mhz for st in spec.lut.states]
        state_f[i, k:] = spec.lut.states[-1].freq_mhz
    idle = np.array([s.lut.idle_w for s in specs])
    p_min = np.array([s.lut.p_min for s in specs])
    return LUTTable(
        state_p=state_p, state_f=state_f, idle_w=idle, p_min=p_min,
        p_max=np.array([s.lut.p_max for s in specs]),
        f_min=np.array([s.lut.states[0].freq_mhz for s in specs]),
        f_nom=np.array([s.lut.f_max for s in specs]),
        span=p_min - idle,
        speed=np.array([s.speed for s in specs]),
        cap_floor=np.array([cap_floor_w(s.lut) for s in specs]))



def batched_operating_point(table: LUTTable, caps_w: np.ndarray,
                            smooth: bool = False
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized :func:`operating_point`: caps ``(B, N)`` -> (freq, duty,
    power), each ``(B, N)``.  Elementwise-identical to the scalar
    translator, including the sub-``p_min`` duty states.  ``table`` holds
    one cluster shared by every row (``(N, S)`` state tables) or one per
    row (``(B, N, S)`` from :func:`stack_lut_tables`).

    ``smooth=True`` selects the piecewise-linear relaxation the
    differentiable layer (:mod:`repro_torch.diff`) optimizes: frequency
    interpolates linearly between adjacent LUT states and the draw is
    ``clip(cap, duty-floor draw, p_max)``.  It agrees with the stepped
    translator exactly at the state powers and in the duty region, and
    clamps to the top state above ``p_max``.  The default ``smooth=False``
    path is the stepped translator.
    """
    if smooth:
        return _smooth_operating_point(table, caps_w)
    fits = table.state_p <= caps_w[..., None] + 1e-12
    idx = fits.sum(axis=-1) - 1            # highest fitting state, -1 if none
    has_state = idx >= 0
    idx_c = np.maximum(idx, 0)[..., None]
    shape = caps_w.shape + (table.state_p.shape[-1],)
    freq_fit = np.take_along_axis(
        np.broadcast_to(table.state_f, shape), idx_c, -1)[..., 0]
    power_fit = np.take_along_axis(
        np.broadcast_to(table.state_p, shape), idx_c, -1)[..., 0]
    q = (caps_w - table.idle_w) / table.span
    q = np.clip(q, DUTY_FLOOR, 1.0)
    freq = np.where(has_state, freq_fit, np.broadcast_to(table.f_min,
                                                         caps_w.shape))
    duty = np.where(has_state, 1.0, q)
    power = np.where(has_state, power_fit, table.idle_w + q * table.span)
    return freq, duty, power


def _smooth_operating_point(table: LUTTable, caps_w: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The ``smooth=True`` branch of :func:`batched_operating_point`.

    The segment index comes from the stepped path's hard gather; the
    gradient of :func:`repro_torch.diff.relax.smooth_operating_point`, its
    torch mirror, flows through the interpolated values only.
    """
    fits = table.state_p <= caps_w[..., None] + 1e-12
    idx = fits.sum(axis=-1) - 1            # segment lower knot, -1 if none
    has_state = idx >= 0
    idx_c = np.maximum(idx, 0)[..., None]
    shape = caps_w.shape + (table.state_p.shape[-1],)
    sp = np.broadcast_to(table.state_p, shape)
    sf = np.broadcast_to(table.state_f, shape)
    p_lo = np.take_along_axis(sp, idx_c, -1)[..., 0]
    f_lo = np.take_along_axis(sf, idx_c, -1)[..., 0]
    idx_n = np.minimum(idx_c + 1, shape[-1] - 1)
    p_hi = np.take_along_axis(sp, idx_n, -1)[..., 0]
    f_hi = np.take_along_axis(sf, idx_n, -1)[..., 0]
    # Segment fraction: +inf-padded upper knots (and the top state, whose
    # "next" slot is itself) give t = 0, i.e. a flat clamp at the edge.
    denom = p_hi - p_lo
    with np.errstate(invalid="ignore", divide="ignore"):
        t = np.where(denom > 0, (caps_w - p_lo) / denom, 0.0)
    t = np.clip(np.where(np.isfinite(t), t, 0.0), 0.0, 1.0)
    freq_fit = f_lo + t * (f_hi - f_lo)
    q = (caps_w - table.idle_w) / table.span
    q = np.clip(q, DUTY_FLOOR, 1.0)
    freq = np.where(has_state, freq_fit, np.broadcast_to(table.f_min,
                                                         caps_w.shape))
    duty = np.where(has_state, 1.0, q)
    floor_draw = table.idle_w + q * table.span
    power = np.where(has_state,
                     np.minimum(caps_w, np.broadcast_to(table.p_max,
                                                        caps_w.shape)),
                     floor_draw)
    return freq, duty, power


def batched_rates(table: LUTTable, freq: np.ndarray, duty: np.ndarray,
                  cpu_frac: np.ndarray) -> np.ndarray:
    """Vectorized :func:`op_rate` per unit of work: work-units per second
    for a job with ``cpu_frac`` at (freq, duty).  Accepts shared ``(N,)``
    or per-row ``(B, N)`` table leaves."""
    slowdown = cpu_frac * (table.f_nom / freq) + (1.0 - cpu_frac)
    return table.speed * duty / slowdown


#: Phantom-lane table values used to pad heterogeneous buckets: a phantom
#: node draws zero power idle (``idle_w=0``), can never run (its
#: ``state_p`` rows are +inf so no cap fits, and ``speed=0`` zeroes its
#: rate), and is numerically inert (``span=1``, ``f_min=f_nom=1`` keep
#: every division finite).  ``p_max=0`` keeps water-fills from ever
#: granting it budget; ``cap_floor=0`` keeps it out of floor sums.
_PHANTOM = dict(state_p=np.inf, state_f=1.0, idle_w=0.0, p_min=1.0,
                p_max=0.0, f_min=1.0, f_nom=1.0, span=1.0, speed=0.0,
                cap_floor=0.0)


def stack_lut_tables(tables: Sequence[LUTTable], n_pad: int,
                     s_pad: int) -> LUTTable:
    """Stack per-row cluster tables into one per-row-batched LUTTable.

    Each input table covers one scenario row's cluster (``N_b`` nodes,
    ``S_b`` states); the result holds ``(B, n_pad, s_pad)`` state tables
    and ``(B, n_pad)`` lane vectors, padded with the :data:`_PHANTOM`
    values so phantom lanes and phantom states are inert: +inf state
    power never fits a cap, zero idle draw never reaches the energy
    integral, zero ``p_max`` never attracts water-filled budget.
    Output of this stacking is what :func:`batched_operating_point` and
    the batch simulators consume for mixed-shape (padded bucket) runs.
    """
    b = len(tables)
    state_p = np.full((b, n_pad, s_pad), _PHANTOM["state_p"])
    state_f = np.full((b, n_pad, s_pad), _PHANTOM["state_f"])
    lanes = {k: np.full((b, n_pad), _PHANTOM[k])
             for k in ("idle_w", "p_min", "p_max", "f_min", "f_nom",
                       "span", "speed", "cap_floor")}
    for r, t in enumerate(tables):
        n, s = t.state_p.shape
        if n > n_pad or s > s_pad:
            raise ValueError(f"row {r} shape ({n}, {s}) exceeds pad "
                             f"({n_pad}, {s_pad})")
        state_p[r, :n, :s] = t.state_p
        state_f[r, :n, :s] = t.state_f
        # real nodes' trailing state slots keep the lut_table convention:
        # +inf power (never fits), last real frequency
        state_f[r, :n, s:] = t.state_f[:, -1:]
        for k, arr in lanes.items():
            arr[r, :n] = getattr(t, k)
    return LUTTable(state_p=state_p, state_f=state_f, **lanes)


# --------------------------------------------------------------------- LUTs
def _vf_power(freq_mhz: float, f_max: float, p_max: float, p_static: float,
              alpha: float = 2.4) -> float:
    """P(f) = P_static + (P_max - P_static) * (f/f_max)^alpha."""
    return p_static + (p_max - p_static) * (freq_mhz / f_max) ** alpha


def arndale_like_lut() -> PowerLUT:
    """Synthetic dual-A15 table in the style of the paper's Arndale board."""
    freqs = [250, 400, 600, 800, 1000, 1200, 1400, 1600]
    f_max, p_max, p_static = 1600.0, 6.2, 0.9
    states = tuple(PowerState(f, round(_vf_power(f, f_max, p_max, p_static), 3))
                   for f in freqs)
    multicore = {
        1: tuple(PowerState(f, round(0.62 * s.power_w + 0.25, 3))
                 for f, s in zip(freqs, states)),
        2: states,
    }
    return PowerLUT(name="arndale-5410", states=states, idle_w=0.45,
                    cores=2, multicore=multicore)


def odroid_like_lut() -> PowerLUT:
    """Synthetic quad-A15 table in the style of the ODROID XU-2."""
    freqs = [250, 400, 600, 800, 1000, 1200, 1400, 1600, 1800, 2000]
    f_max, p_max, p_static = 2000.0, 8.4, 1.1
    states = tuple(PowerState(f, round(_vf_power(f, f_max, p_max, p_static), 3))
                   for f in freqs)
    multicore = {}
    for m in range(1, 5):
        frac = 0.30 + 0.70 * (m / 4.0)
        multicore[m] = tuple(
            PowerState(f, round(p_static * 0.5 + frac * (s.power_w - p_static * 0.5), 3))
            for f, s in zip(freqs, states))
    return PowerLUT(name="odroid-xu2", states=states, idle_w=0.60,
                    cores=4, multicore=multicore)


def tpu_v5e_lut(n_steps: int = 8) -> PowerLUT:
    """Analytical per-chip power-cap table for TPU v5e (the target).

    A v5e chip has ~200 W board TDP; capping to power p yields clock
    throughput ~ (p/p_tdp)^(1/2.2) of peak (cubic-ish V-f scaling inverted).
    We expose ``n_steps`` evenly spaced "frequency" states mirroring the
    DVFS-table interface the paper measures on its ARM boards.
    """
    f_max, p_tdp, p_static = 940.0, 200.0, 60.0  # MHz-like clock scale
    freqs = [f_max * (i + 1) / n_steps for i in range(n_steps)]
    states = tuple(PowerState(round(f, 1),
                              round(_vf_power(f, f_max, p_tdp, p_static, 2.2), 2))
                   for f in freqs)
    return PowerLUT(name="tpu-v5e", states=states, idle_w=35.0, cores=1)


def heterogeneous_cluster(n_nodes: int, seed: int = 0) -> List[NodeSpec]:
    """A mixed Arndale/ODROID-style cluster (paper §VII-B at larger scale)."""
    import random

    rng = random.Random(seed)
    specs: List[NodeSpec] = []
    for i in range(n_nodes):
        if i % 2 == 0:
            specs.append(NodeSpec(arndale_like_lut(),
                                  speed=1.0 * rng.uniform(0.95, 1.05)))
        else:
            specs.append(NodeSpec(odroid_like_lut(),
                                  speed=1.25 * rng.uniform(0.95, 1.05)))
    return specs


def homogeneous_cluster(n_nodes: int) -> List[NodeSpec]:
    return [NodeSpec(arndale_like_lut(), speed=1.0) for _ in range(n_nodes)]


def min_feasible_cluster_bound(specs: Sequence[NodeSpec]) -> float:
    """Lowest cluster bound at which every node can run its slowest state."""
    return sum(s.lut.p_min for s in specs)


def max_useful_cluster_bound(specs: Sequence[NodeSpec]) -> float:
    """Bound above which equal-share already runs every node flat-out."""
    return max(s.lut.p_max for s in specs) * len(specs)
