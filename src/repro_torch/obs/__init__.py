"""Observability of the port: span tracing (:mod:`repro_torch.obs.trace`)."""

from . import trace
from .trace import Tracer

__all__ = ["trace", "Tracer"]
