"""Step functions of the LM serving path, as the reference's
``launch/steps.py``: prefill (full-sequence forward) and one serve step.
The train step comes with the training path.

Each step runs on the card unless ``device="cpu"`` is passed (``None``
raises without CUDA); the parameters must live on that device, and the
inputs (tokens, or the encoder's frames) are moved there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.backends.engine import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import decode_step, forward


def _tokens(tokens, device) -> torch.Tensor:
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                           device=device)


def _frames(frames, device) -> torch.Tensor:
    if isinstance(frames, torch.Tensor):
        return frames.to(device=device)
    return torch.as_tensor(np.asarray(frames), device=device)


def make_prefill_step(cfg: ModelConfig, device=None,
                      impl: Optional[str] = None):
    """(params, batch) -> logits ``(B, S, V)``; the batch is ``{"tokens":
    (B, S)}``, or ``{"frames": (B, S, d_model)}`` for the encoder family
    (as the reference's ``input_specs``)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def prefill_step(params, batch):
        if cfg.family == "encoder":
            inputs = {"frames": _frames(batch["frames"], dev)}
        else:
            inputs = {"tokens": _tokens(batch["tokens"], dev)}
        logits, _aux = forward(cfg, params, inputs, impl=impl)
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig, device=None,
                    impl: Optional[str] = None):
    """(params, cache, tokens ``(B, 1)``, pos) -> (next tokens ``(B,)``,
    logits ``(B, 1, V)``, cache); greedy, the cache written in place."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def serve_step(params, cache, tokens, pos: int):
        logits, cache = decode_step(cfg, params, cache, _tokens(tokens, dev),
                                    pos, impl=impl)
        return logits[:, -1].argmax(dim=-1), logits, cache

    return serve_step
