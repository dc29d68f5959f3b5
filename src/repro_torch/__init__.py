"""PyTorch/CUDA port of the power-redistribution simulator.

A second package beside the JAX reference (``repro``), which it never
imports: the numpy geometry, LUT and ILP modules it needs are its own
copies (``repro_torch.core``).  The main path is the batched wave engine
(:class:`~repro_torch.backends.engine.TorchBatchSimulator`), whose hot
step is one call per wave into the fused ``power_step`` kernel
(``kernels/csrc/power_step.cu``, built with ``nvcc`` on first use).
Entry points run on the card unless the caller passes ``device="cpu"``.

    from repro_torch import simulate_batch_torch, TorchBatchSimulator
"""

from repro_torch.backends.engine import (TorchBatchSimulator,
                                         simulate_batch_torch)

__all__ = ["TorchBatchSimulator", "simulate_batch_torch"]
