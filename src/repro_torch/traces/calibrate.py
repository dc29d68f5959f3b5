"""Duration → work calibration through the power model (§III / §V-A).

A trace records *seconds*; the dependency graph wants *work units*
(execution time at nominal frequency on a unit-speed node).  Guermouche
et al. make the case that observed durations must be normalised against
the frequency they ran at before any power decision reuses them — a span
that took 4 s at 800 MHz is **not** a 4-unit job on a 1600 MHz-nominal
node.  Inverting the execution-time model of :mod:`repro_torch.core.power`::

    tau = (work / speed) * (rho * f_nom / f + (1 - rho))
    work = tau * speed / (rho * f_nom / f + (1 - rho))

where ``rho`` is the span's CPU-bound fraction and ``f`` the logged
DVFS state.  The logged frequency must be a real state of the rank's
LUT (strict mode raises :class:`~repro_torch.traces.schema.TraceError`
otherwise; lenient mode snaps to the nearest state — real governors
occasionally report transition frequencies).

LUT identity travels in the trace header by *name*, resolved through
:data:`LUT_REGISTRY`; pass explicit specs to the reconstruction entry
points for clusters the registry does not know.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.power import (NodeSpec, PowerLUT, arndale_like_lut,
                                    odroid_like_lut, tpu_v5e_lut)

from .schema import RankInfo, SpanRecord, Trace, TraceError

#: Known LUT builders, keyed by ``PowerLUT.name`` — how a trace header's
#: ``cluster`` entries become :class:`NodeSpec`\ s again.
LUT_REGISTRY: Dict[str, Callable[[], PowerLUT]] = {
    "arndale-5410": arndale_like_lut,
    "odroid-xu2": odroid_like_lut,
    "tpu-v5e": tpu_v5e_lut,
}

#: Relative tolerance for matching a logged frequency to a LUT state.
FREQ_RTOL = 1e-6


def rank_info(specs: Sequence[NodeSpec]) -> List[RankInfo]:
    """Header ``cluster`` entries for a cluster (the recording side)."""
    return [RankInfo(lut=s.lut.name, speed=s.speed) for s in specs]


def specs_for(trace: Trace,
              specs: Optional[Sequence[NodeSpec]] = None) -> List[NodeSpec]:
    """Resolve a trace's cluster into :class:`NodeSpec`\\ s.

    Explicit ``specs`` override the header (count-checked); otherwise
    every header LUT name must be in :data:`LUT_REGISTRY`.
    """
    if specs is not None:
        if len(specs) != trace.ranks:
            raise TraceError(f"{len(specs)} NodeSpecs for a "
                             f"{trace.ranks}-rank trace")
        return list(specs)
    out: List[NodeSpec] = []
    for info in trace.cluster:
        builder = LUT_REGISTRY.get(info.lut)
        if builder is None:
            raise TraceError(
                f"unknown LUT {info.lut!r} in trace header (known: "
                f"{sorted(LUT_REGISTRY)}); pass explicit specs")
        out.append(NodeSpec(builder(), speed=info.speed))
    return out


def state_freq(lut: PowerLUT, freq_mhz: float,
               strict: bool = True) -> float:
    """The LUT state frequency a logged frequency corresponds to.

    Strict mode requires an exact state (within :data:`FREQ_RTOL`);
    lenient mode snaps to the nearest one.
    """
    best, best_err = None, float("inf")
    for s in lut.states:
        err = abs(s.freq_mhz - freq_mhz)
        if err < best_err:
            best, best_err = s.freq_mhz, err
    if strict and best_err > FREQ_RTOL * max(1.0, abs(freq_mhz)):
        raise TraceError(
            f"logged frequency {freq_mhz} MHz is not a state of LUT "
            f"{lut.name!r} (states: "
            f"{[s.freq_mhz for s in lut.states]})")
    return best


def span_work(span: SpanRecord, spec: NodeSpec,
              strict: bool = True) -> float:
    """Calibrated work units for one compute span (see module doc)."""
    dur = span.duration
    if dur < 0:
        raise TraceError(f"rank {span.rank} seq {span.seq}: negative "
                         f"duration")
    if dur == 0.0:
        return 0.0
    f = state_freq(spec.lut, span.freq_mhz, strict=strict)
    slowdown = span.cpu_frac * (spec.lut.f_max / f) + (1.0 - span.cpu_frac)
    return dur * spec.speed / slowdown
