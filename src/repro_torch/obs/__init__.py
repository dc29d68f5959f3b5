"""Observability of the port: span tracing (:mod:`repro_torch.obs.trace`,
enabled by injection or ``REPRO_TRACE=<path>``), the labeled metrics
registry (:mod:`repro_torch.obs.metrics`) and per-node power / frequency
/ job timelines from simulation results (:mod:`repro_torch.obs.timeline`,
imported by its consumers: it imports ``repro_torch.core``) and the
``python -m repro_torch.obs regress`` BENCH artifact differ
(:mod:`repro_torch.obs.regress`, imported by its consumers as the
reference's is)."""

from . import trace
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .trace import TRACE_ENV, Tracer

# A bare `REPRO_TRACE=out.json python -m ...` run needs no code changes:
# importing any instrumented layer activates the file-backed tracer.
trace.configure_from_env()

__all__ = ["trace", "Tracer", "TRACE_ENV", "Counter", "Gauge",
           "Histogram", "MetricsRegistry", "default_registry"]
