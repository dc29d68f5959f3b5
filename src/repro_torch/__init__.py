"""PyTorch/CUDA port of the power-redistribution simulator.

A second package beside the JAX reference (``repro``), which it never
imports: the numpy geometry, LUT and ILP modules it needs are its own
copies (``repro_torch.core``, ``repro_torch.policies``).  The main path
is a sweep (:class:`~repro_torch.core.sweep.SweepEngine` with
``executor="torch"``) that buckets scenarios onto the batched wave
engine (:class:`~repro_torch.backends.engine.TorchBatchSimulator`),
which runs each bucket in one launch of the ``wave_run`` kernel
(``kernels/csrc/power_step.cu``, built with ``nvcc`` on first use).
The same buckets are served as an open
stream by :class:`~repro_torch.serving.service.SweepService` (continuous
batching with flush deadlines, a result cache and the same fallbacks),
driven by :func:`~repro_torch.serving.stream.poisson_replay`.  Recorded
MPI traces enter through :mod:`repro_torch.traces` (a directory of them
is a :meth:`~repro_torch.core.scenarios.ScenarioFamily.from_corpus`
family).  Entry points run on the card unless the caller passes
``device="cpu"``.

    from repro_torch import simulate_batch_torch, TorchBatchSimulator
    from repro_torch.core import SweepEngine, mixed_family
    from repro_torch import SweepService, poisson_replay
"""

from repro_torch.backends.engine import (TorchBatchSimulator,
                                         simulate_batch_torch)
from repro_torch.serving.service import SweepService
from repro_torch.serving.stream import poisson_replay

__all__ = ["SweepService", "TorchBatchSimulator", "poisson_replay",
           "simulate_batch_torch"]
