"""Serving of the port.

Two residents share this package:

* :class:`SweepService` (``service.py``) — the streaming scenario-sweep
  server with continuous bucket batching onto the torch engine, plus its
  arrival-stream replay in ``stream.py``;
* :class:`ServeEngine` (``engine.py``) — the batched LM engine.
"""

from repro_torch.serving.engine import GenerationResult, ServeEngine

from .service import (DEFAULT_BUCKET_ROWS, ServeRecord, ServeTicket,
                      ServiceStats, SweepService)
from .stream import ReplayReport, percentile, poisson_replay

__all__ = [
    "DEFAULT_BUCKET_ROWS",
    "GenerationResult",
    "ReplayReport",
    "ServeEngine",
    "ServeRecord",
    "ServeTicket",
    "ServiceStats",
    "SweepService",
    "percentile",
    "poisson_replay",
]
