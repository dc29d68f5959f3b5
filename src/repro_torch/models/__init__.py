"""The LM models of the port (dense, vlm, moe, encoder, hybrid and ssm
families): ``init_params``, ``forward``, ``loss_fn``, ``init_cache``,
``decode_step``."""

from repro_torch.models.model import (DenseLM, EncoderLM, HybridLM, XLSTMLM,
                                      decode_step, forward, init_cache,
                                      init_params, loss_fn)

__all__ = ["DenseLM", "EncoderLM", "HybridLM", "XLSTMLM", "decode_step",
           "forward", "init_cache", "init_params", "loss_fn"]
