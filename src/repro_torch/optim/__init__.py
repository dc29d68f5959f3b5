"""AdamW (fp32 / bf16 / int8 state) and gradient compression."""

from repro_torch.optim.adamw import (AdamWConfig, QTensor, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     init_opt_state, lr_schedule)
from repro_torch.optim import compression

__all__ = ["AdamWConfig", "QTensor", "adamw_update", "clip_by_global_norm",
           "global_norm", "init_opt_state", "lr_schedule", "compression"]
