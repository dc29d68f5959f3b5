"""Labeled counter/gauge/histogram registry with streaming percentiles.

The port's copy of the reference's ``repro.obs.metrics``.  The tracer
(:mod:`repro_torch.obs.trace`) answers *when* — this module
answers *how many* and *how long*.  Layers register named metrics once
and update them from any thread; :meth:`MetricsRegistry.snapshot`
renders the whole registry to one stable, JSON-ready schema that
``ServiceStats`` reads, so percentiles are computed in exactly one place
(:func:`repro_torch.serving.stream.percentile`, nearest-rank) instead of
being re-derived by hand per consumer.

    >>> from repro_torch.obs.metrics import MetricsRegistry
    >>> reg = MetricsRegistry()
    >>> flushes = reg.counter("flushes")
    >>> flushes.inc(cause="full"); flushes.inc(cause="full")
    >>> flushes.inc(cause="deadline")
    >>> lat = reg.histogram("latency_s")
    >>> for v in [0.01, 0.02, 0.03, 0.04]:
    ...     lat.observe(v)
    >>> snap = reg.snapshot()
    >>> snap["counters"]["flushes"] == {"cause=full": 2.0,
    ...                                 "cause=deadline": 1.0}
    True
    >>> snap["histograms"]["latency_s"][""]["count"]
    4
    >>> snap["histograms"]["latency_s"][""]["p50"]
    0.02
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Tuple

#: Histograms keep at most this many samples per label set; beyond it
#: they switch to seeded reservoir sampling so long streams keep a
#: uniform (and run-to-run deterministic) sample with bounded memory.
DEFAULT_RESERVOIR = 4096

#: The percentiles every histogram snapshot reports.
SNAPSHOT_PCTS = (50, 90, 99)


def _label_key(labels: Dict[str, object]) -> str:
    """One label set as a stable string key (sorted ``k=v`` pairs;
    ``""`` for the unlabeled series)."""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


class Counter:
    """A monotonically increasing count, split by labels.

    ``inc(cause="full")`` and ``inc(cause="deadline")`` accumulate
    independent series under one metric name.
    """

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._values: Dict[str, float] = {}

    def inc(self, amount: float = 1, **labels) -> None:
        """Add ``amount`` (default 1) to the series named by ``labels``."""
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        """Current value of one series (0 if never incremented)."""
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        """Sum across every label series."""
        with self._lock:
            return sum(self._values.values())

    def _snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._values)


class Gauge:
    """A point-in-time value (queue depth, open buckets), split by
    labels; :meth:`set` overwrites, :meth:`add` adjusts."""

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._values: Dict[str, float] = {}

    def set(self, value: float, **labels) -> None:
        """Overwrite the series named by ``labels``."""
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def add(self, delta: float, **labels) -> None:
        """Adjust the series by ``delta`` (may be negative)."""
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta

    def value(self, **labels) -> float:
        """Current value of one series (0 if never set)."""
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def _snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._values)


class _Series:
    """One histogram label-series: exact count/sum/min/max plus a
    bounded sample for percentiles."""

    __slots__ = ("count", "total", "lo", "hi", "samples", "_rng")

    def __init__(self, seed: int):
        self.count = 0
        self.total = 0.0
        self.lo: Optional[float] = None
        self.hi: Optional[float] = None
        self.samples: List[float] = []
        self._rng = random.Random(seed)

    def observe(self, value: float, capacity: int) -> None:
        self.count += 1
        self.total += value
        self.lo = value if self.lo is None else min(self.lo, value)
        self.hi = value if self.hi is None else max(self.hi, value)
        if len(self.samples) < capacity:
            self.samples.append(value)
        else:
            # Algorithm R: keep each of the n observations with
            # probability capacity/n; seeded, so runs are reproducible.
            j = self._rng.randrange(self.count)
            if j < capacity:
                self.samples[j] = value


class Histogram:
    """A distribution of observations with streaming percentiles.

    Count, sum, min and max are exact; percentiles come from a
    bounded seeded reservoir (`Vitter's algorithm R`) so unbounded
    streams — a million-request replay — cost O(reservoir) memory.
    Percentile math delegates to :func:`repro_torch.serving.stream.
    percentile` (nearest-rank), the same function the serving reports
    use, so every layer quotes identical tails.
    """

    def __init__(self, name: str, lock: threading.Lock,
                 reservoir: int = DEFAULT_RESERVOIR):
        self.name = name
        self._lock = lock
        self._reservoir = reservoir
        self._series: Dict[str, _Series] = {}

    def observe(self, value: float, **labels) -> None:
        """Record one observation into the series named by ``labels``."""
        key = _label_key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _Series(len(self._series))
            series.observe(float(value), self._reservoir)

    def count(self, **labels) -> int:
        """Observations recorded into one series."""
        with self._lock:
            series = self._series.get(_label_key(labels))
            return series.count if series else 0

    def pct(self, pct: float, **labels) -> Optional[float]:
        """Nearest-rank percentile of one series (None when empty)."""
        from repro_torch.serving.stream import percentile
        with self._lock:
            series = self._series.get(_label_key(labels))
            samples = list(series.samples) if series else []
        return percentile(samples, pct) if samples else None

    def _snapshot(self) -> Dict[str, dict]:
        from repro_torch.serving.stream import percentile
        with self._lock:
            copies = {key: (s.count, s.total, s.lo, s.hi,
                            list(s.samples))
                      for key, s in self._series.items()}
        out = {}
        for key, (count, total, lo, hi, samples) in copies.items():
            entry = {"count": count, "sum": total, "min": lo, "max": hi}
            for p in SNAPSHOT_PCTS:
                entry[f"p{p}"] = (percentile(samples, p)
                                  if samples else None)
            out[key] = entry
        return out


class MetricsRegistry:
    """A named collection of metrics with one stable snapshot schema.

    Accessors are get-or-create and idempotent — every call site can
    say ``registry.counter("flushes")`` without coordinating which one
    registers first — but a name can hold only one metric kind
    (re-registering ``"flushes"`` as a gauge raises).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(
                    name, threading.Lock(), *args)
            elif not isinstance(metric, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(metric).__name__}, not {cls.__name__}")
        return metric

    def counter(self, name: str) -> Counter:
        """Get or create the counter called ``name``."""
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        """Get or create the gauge called ``name``."""
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  reservoir: int = DEFAULT_RESERVOIR) -> Histogram:
        """Get or create the histogram called ``name``."""
        return self._get(name, Histogram, reservoir)

    def snapshot(self) -> dict:
        """The whole registry as one JSON-ready dict.

        Schema (stable — ``ServiceStats`` parses it)::

            {"counters":   {name: {label_key: value}},
             "gauges":     {name: {label_key: value}},
             "histograms": {name: {label_key:
                 {count, sum, min, max, p50, p90, p99}}}}

        where ``label_key`` is the sorted ``k=v`` join (``""`` for
        unlabeled series).
        """
        with self._lock:
            metrics = dict(self._metrics)
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, metric in sorted(metrics.items()):
            if isinstance(metric, Counter):
                out["counters"][name] = metric._snapshot()
            elif isinstance(metric, Gauge):
                out["gauges"][name] = metric._snapshot()
            else:
                out["histograms"][name] = metric._snapshot()
        return out


#: The process-default registry — layers without an injected registry
#: (ad-hoc scripts) report here.
DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-default :class:`MetricsRegistry`."""
    return DEFAULT
