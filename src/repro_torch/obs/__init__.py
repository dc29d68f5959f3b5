"""Observability of the port: span tracing (:mod:`repro_torch.obs.trace`)
and the labeled metrics registry (:mod:`repro_torch.obs.metrics`)."""

from . import trace
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .trace import Tracer

__all__ = ["trace", "Tracer", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "default_registry"]
