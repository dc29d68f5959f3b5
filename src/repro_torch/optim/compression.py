"""Gradient compression for the data-parallel all-reduce, the port of the
reference's ``optim/compression.py``.

int8 uniform quantisation with **error feedback**: the quantisation
residual is carried to the next step, so the compressed SGD/Adam path
converges to the same fixed points (Karimireddy et al., 2019).  Gradients
and error state are dictionaries keyed by parameter name.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


def init_error_feedback(params: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """fp32 zeros of each parameter's shape, on its device."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in dict(params).items()}


def compress_decompress(g: torch.Tensor, err: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantise (g + err) to int8 per-tensor scale; return (ĝ, new_err)."""
    target = g.float() + err
    scale = torch.clamp(target.abs().max(), min=1e-12) / 127.0
    codes = torch.round(target / scale).clamp(-127, 127)
    ghat = codes * scale
    return ghat.to(g.dtype), target - ghat


def apply(grads: Mapping[str, torch.Tensor],
          err_state: Mapping[str, torch.Tensor]
          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    outs = {k: compress_decompress(g, err_state[k]) for k, g in grads.items()}
    return ({k: o[0] for k, o in outs.items()},
            {k: o[1] for k, o in outs.items()})
