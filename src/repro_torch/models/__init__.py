"""The LM models of the port (dense and hybrid families):
``init_params``, ``forward``, ``init_cache``, ``decode_step``."""

from repro_torch.models.model import (DenseLM, HybridLM, decode_step,
                                      forward, init_cache, init_params)

__all__ = ["DenseLM", "HybridLM", "decode_step", "forward", "init_cache",
           "init_params"]
