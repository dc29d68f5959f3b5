"""The LM models of the port (dense family): ``init_params``, ``forward``,
``init_cache``, ``decode_step``."""

from repro_torch.models.model import (DenseLM, decode_step, forward,
                                      init_cache, init_params)

__all__ = ["DenseLM", "decode_step", "forward", "init_cache", "init_params"]
