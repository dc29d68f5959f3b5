"""Arrival-stream replay against a :class:`~repro_torch.serving.SweepService`.

The port's copy of the reference's ``repro.serving.stream``.

An offline sweep hands the engine its whole scenario list at once; a
*stream* feeds scenarios to the service one at a time with gaps between
arrivals, which is what exercises the continuous-batching path: open
buckets fill across requests, deadlines flush partial buckets, and the
fixed bucket shapes (no kernel build after warm-up) have to hold across
the whole stream rather than within one planned batch.

:func:`poisson_replay` is the canonical load generator — a scenario family
replayed as a Poisson process (exponential inter-arrival gaps at
``rate_hz``), the standard open-loop load model for serving benchmarks.
It is deterministic under a seed (its own ``random.Random``), so a gate
can be set on its output.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.core.sweep import Scenario

from .service import ServeRecord, SweepService


def percentile(values: Sequence[float], pct: float) -> float:
    """Nearest-rank percentile (``pct`` in [0, 100]) of ``values``.

    Nearest-rank rather than interpolation: latency SLOs quote an
    observation that actually happened, and the tiny sample sizes of
    smoke runs make interpolated tails misleading.
    """
    if not values:
        raise ValueError("percentile of empty sequence")
    if not 0 <= pct <= 100:
        raise ValueError(f"pct must be in [0, 100], got {pct}")
    ordered = sorted(values)
    rank = max(1, math.ceil(pct / 100 * len(ordered)))
    return ordered[rank - 1]


@dataclass
class ReplayReport:
    """One replay's outcome: every resolved record plus the headline
    stream metrics (wall-clock is submit-of-first to resolve-of-last)."""

    records: List[ServeRecord] = field(default_factory=list)
    wall_s: float = 0.0
    offered_rate_hz: float = 0.0

    @property
    def throughput(self) -> float:
        """Completed requests per second of replay wall-clock."""
        return len(self.records) / self.wall_s if self.wall_s else 0.0

    def latencies(self) -> List[float]:
        """Per-request submit→result latencies, in seconds."""
        return [r.latency_s for r in self.records]

    def latency_pct(self, pct: float) -> float:
        """Latency percentile over every resolved request."""
        return percentile(self.latencies(), pct)

    @property
    def failures(self) -> List[ServeRecord]:
        return [r for r in self.records if not r.ok]

    @property
    def fallbacks(self) -> List[ServeRecord]:
        """Requests the batched backends could not serve."""
        return [r for r in self.records if r.fallback_reason is not None]

    def to_dict(self) -> dict:
        """JSON-ready summary for BENCH records / CI gates."""
        lat = self.latencies()
        return {
            "requests": len(self.records),
            "failures": len(self.failures),
            "fallbacks": len(self.fallbacks),
            "cache_hits": sum(1 for r in self.records if r.cached),
            "offered_rate_hz": self.offered_rate_hz,
            "wall_s": self.wall_s,
            "throughput_rps": self.throughput,
            "latency_p50_s": percentile(lat, 50) if lat else None,
            "latency_p99_s": percentile(lat, 99) if lat else None,
            "latency_max_s": max(lat) if lat else None,
        }


def poisson_replay(service: SweepService,
                   scenarios: Sequence[Scenario],
                   rate_hz: float,
                   seed: int = 0,
                   timeout_s: Optional[float] = 120.0) -> ReplayReport:
    """Replay ``scenarios`` into ``service`` as a Poisson arrival
    stream and block for every result.

    Arrivals are open-loop: inter-arrival gaps are exponential with
    mean ``1 / rate_hz`` regardless of how fast the service answers,
    so a service slower than the offered rate shows up as growing
    latency rather than a throttled stream.  The report preserves
    submission order (``records[i]`` answers ``scenarios[i]``).
    """
    if rate_hz <= 0:
        raise ValueError("rate_hz must be positive")
    rng = random.Random(seed)
    t0 = time.perf_counter()
    tickets = []
    for i, scenario in enumerate(scenarios):
        if i:
            time.sleep(rng.expovariate(rate_hz))
        tickets.append(service.submit(scenario))
    records = [t.result(timeout=timeout_s) for t in tickets]
    return ReplayReport(records=records,
                        wall_s=time.perf_counter() - t0,
                        offered_rate_hz=rate_hz)
