"""Replay validation: does the reconstructed graph explain the trace?

A reconstructed workload is only trustworthy if *re-executing* it
reproduces the recording.  The validator replays the graph with every
job pinned to the DVFS state its span was logged at (the model of §III:
``tau = (work / speed) * (rho * f_nom / f + 1 - rho)``) and compares the
replayed makespan against the trace's observed wall clock.

* On a noise-free synthetic recording the two agree to float precision
  — the acceptance bar is 1% (:data:`REPLAY_RTOL`).
* With timestamp jitter/skew the calibrated works absorb the duration
  noise, so the replayed makespan drifts from the recorded wall clock
  by roughly the accumulated jitter along the critical path; the
  documented tolerance for the default noise model is 10%
  (:data:`NOISY_REPLAY_RTOL`).
* Dropped records lose work or edges; the validator is exactly the tool
  that quantifies how much.

For traces recorded at nominal frequency the validator additionally
cross-checks the *event simulator*: under the nominal (uncapped) cluster
bound with the equal-share policy every node runs flat out, so the
simulated makespan must also land on the wall clock — this closes the
loop through the same simulator stack the corpus sweeps use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.power import job_time, max_useful_cluster_bound

from .reconstruct import ReconstructedGraph

#: Acceptance tolerance for noise-free recordings (relative).
REPLAY_RTOL = 0.01

#: Documented tolerance for recordings degraded with the default
#: :func:`repro_torch.traces.record.with_noise` model.
NOISY_REPLAY_RTOL = 0.10


@dataclass
class ReplayReport:
    """Outcome of replaying one reconstructed trace."""

    name: str
    wall_clock_s: float
    replay_makespan_s: float
    rel_err: float
    tol: float
    ok: bool
    #: Event-simulator makespan under the nominal bound (only for
    #: nominal-frequency recordings; None otherwise).
    sim_makespan_s: Optional[float] = None

    def __str__(self) -> str:
        sim = ("" if self.sim_makespan_s is None
               else f"  sim@nominal {self.sim_makespan_s:.3f}s")
        status = "ok" if self.ok else "FAIL"
        return (f"{self.name}: wall {self.wall_clock_s:.3f}s  replay "
                f"{self.replay_makespan_s:.3f}s  err "
                f"{self.rel_err * 100:.2f}% (tol {self.tol * 100:.0f}%)"
                f"{sim}  [{status}]")


def replay_makespan(recon: ReconstructedGraph) -> float:
    """Makespan of the reconstructed graph at its logged DVFS states."""
    rank_of = {nid: r for r, nid in enumerate(recon.graph.nodes)}

    def time_fn(job) -> float:
        spec = recon.specs[rank_of[job.node]]
        return job_time(job, recon.freqs[job.job_id], spec.lut.f_max,
                        spec.speed)

    return recon.graph.makespan(time_fn)


def replay_report(recon: ReconstructedGraph, tol: float = REPLAY_RTOL,
                  simulate_nominal: Optional[bool] = None) -> ReplayReport:
    """Validate one reconstruction (see module docstring).

    ``simulate_nominal`` forces the event-simulator cross-check on or
    off; by default it runs exactly when the trace says it was recorded
    at nominal frequency.
    """
    wall = recon.trace.wall_clock
    predicted = replay_makespan(recon)
    denom = max(wall, 1e-12)
    rel_err = abs(predicted - wall) / denom
    ok = rel_err <= tol

    if simulate_nominal is None:
        simulate_nominal = recon.trace.meta.get("freqs") == "nominal"
    sim_makespan = None
    if simulate_nominal:
        from repro_torch.core.simulator import simulate

        bound = max_useful_cluster_bound(recon.specs)
        sim_makespan = simulate(recon.graph, recon.specs, bound,
                                "equal-share", latency_s=0.0).makespan
        ok = ok and abs(sim_makespan - wall) / denom <= tol
    return ReplayReport(name=recon.name, wall_clock_s=wall,
                        replay_makespan_s=predicted, rel_err=rel_err,
                        tol=tol, ok=ok, sim_makespan_s=sim_makespan)
