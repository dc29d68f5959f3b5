"""Power/frequency/job timelines as Chrome counter tracks (the port's copy
of the reference's ``repro.obs.timeline``).

The paper's result — idle nodes donating watts so lagging nodes can
run hotter, with the cluster total pinned at the bound — is invisible
in a scalar like makespan.  This module renders it: a
:class:`~repro_torch.core.results.SimResult` recorded with
``node_trace=True`` becomes stacked per-node power counters, a bound
line, per-node job Gantt spans, and (given the node specs) frequency
tracks, all in one Perfetto view.  Donations show up literally: one
node's area shrinks as another's grows while the stack stays under the
bound line.

    >>> from repro_torch.core.results import SimResult
    >>> from repro_torch.obs import trace
    >>> from repro_torch.obs.timeline import sim_tracks
    >>> r = SimResult(policy="equal-share", makespan=2.0, energy_j=0.0,
    ...               avg_power_w=0.0, peak_power_w=0.0,
    ...               over_budget_time=0.0, messages=0, distributes=0,
    ...               suppressed_reports=0,
    ...               node_power_trace=[(0.0, (40.0, 60.0)),
    ...                                 (1.0, (55.0, 45.0))],
    ...               job_starts={(0, 0): 0.0}, job_ends={(0, 0): 2.0})
    >>> t = trace.Tracer()
    >>> sim_tracks(r, bound=110.0, tracer=t, label="demo") >= 5
    True
    >>> counters = [e for e in t.events() if e["ph"] == "C"]
    >>> sum(counters[0]["args"].values()) <= 110.0
    True
"""

from __future__ import annotations

from typing import (TYPE_CHECKING, Dict, Iterable, Mapping, Optional,
                    Sequence, Tuple, Union)

from . import trace as _trace

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids core import
    from repro_torch.core.power import NodeSpec
    from repro_torch.core.results import SimResult

#: One sample: ``(t_seconds, watts)`` where watts is a per-series
#: mapping or a per-node sequence.
Sample = Tuple[float, Union[Mapping[str, float], Sequence[float]]]

#: A bound is a constant or a ``(t, watts)`` step schedule.
Bound = Union[float, Sequence[Tuple[float, float]]]


def _series(watts) -> Dict[str, float]:
    """Normalize one sample's payload to a ``{series: value}`` dict."""
    if isinstance(watts, Mapping):
        return {str(k): float(v) for k, v in watts.items()}
    return {f"node{i}": float(v) for i, v in enumerate(watts)}


def _bound_steps(bound: Bound, t_end: float) -> Sequence[Tuple[float, float]]:
    """A bound as step samples covering ``[0, t_end]``."""
    if isinstance(bound, (int, float)):
        return [(0.0, float(bound)), (t_end, float(bound))]
    steps = [(float(t), float(w)) for t, w in bound]
    if steps and steps[-1][0] < t_end:
        steps.append((t_end, steps[-1][1]))
    return steps


def power_tracks(samples: Iterable[Sample], bound: Bound,
                 tracer: Optional[_trace.Tracer] = None,
                 label: str = "sim") -> int:
    """Emit a power counter track (plus the bound line) from samples.

    ``samples`` is any ``(t, watts)`` sequence — a
    ``SimResult.node_power_trace`` (per-node tuple), a batch
    simulator's ``power_trace`` wrapped as single-series samples, or a
    hand-built mapping.  Events land on simulated-time track
    ``power:<label>``; returns the number emitted (0 when tracing is
    disabled and no tracer is given).
    """
    if tracer is None:
        tracer = _trace.get()
    if tracer is None:
        return 0
    track = f"power:{label}"
    n = 0
    t_end = 0.0
    for t, watts in samples:
        tracer.counter("power_w", _series(watts), cat="power",
                       track=track, ts=t)
        t_end = max(t_end, t)
        n += 1
    for t, w in _bound_steps(bound, t_end):
        tracer.counter("bound_w", {"bound": w}, cat="power",
                       track=track, ts=t)
        n += 1
    return n


def _freq_samples(result: "SimResult",
                  specs: Sequence["NodeSpec"]) -> Iterable[Sample]:
    """Per-node frequency estimated from each power sample via the
    LUT's power→frequency translator (idle draw maps to 0 MHz)."""
    for t, watts in result.node_power_trace:
        freqs = {}
        for i, p in enumerate(watts):
            lut = specs[i].lut
            if p <= lut.idle_w + 1e-12:
                freqs[f"node{i}"] = 0.0
            else:
                freqs[f"node{i}"] = lut.freq_for_power_clamped(p)
        yield t, freqs


def sim_tracks(result: "SimResult", bound: Bound,
               tracer: Optional[_trace.Tracer] = None,
               label: Optional[str] = None,
               specs: Optional[Sequence["NodeSpec"]] = None) -> int:
    """Emit one simulation's full timeline: per-node power counters
    with the bound line, per-node job Gantt spans, and (when ``specs``
    is given) per-node frequency counters.

    Per-node power requires the simulation to have run with
    ``node_trace=True``; without it this falls back to the cluster
    total ``power_trace``.  Returns the number of events emitted.
    """
    if tracer is None:
        tracer = _trace.get()
    if tracer is None:
        return 0
    label = label or result.policy
    track = f"power:{label}"
    samples: Iterable[Sample] = result.node_power_trace \
        or [(t, {"cluster": p}) for t, p in result.power_trace]
    n = power_tracks(samples, bound, tracer=tracer, label=label)
    if specs is not None and result.node_power_trace:
        for t, freqs in _freq_samples(result, specs):
            tracer.counter("freq_mhz", freqs, cat="power", track=track,
                           ts=t)
            n += 1
    for job_id, t0 in sorted(result.job_starts.items()):
        t1 = result.job_ends.get(job_id, result.makespan)
        nid, idx = job_id if isinstance(job_id, tuple) else (job_id, 0)
        tracer.complete(f"job{idx}", 0.0, max(0.0, t1 - t0), cat="job",
                        track=track, lane=f"node{nid}", ts=t0,
                        args={"job": list(job_id)
                              if isinstance(job_id, tuple) else job_id})
        n += 1
    return n


def write_sim_trace(result: "SimResult", bound: Bound, path: str,
                    label: Optional[str] = None,
                    specs: Optional[Sequence["NodeSpec"]] = None) -> str:
    """One-call export: render ``result`` into a fresh tracer and
    write the Chrome JSON to ``path`` (returned)."""
    tracer = _trace.Tracer(path=path)
    sim_tracks(result, bound, tracer=tracer, label=label, specs=specs)
    return tracer.write()
