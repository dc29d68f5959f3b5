"""Step functions of the LM paths, as the reference's ``launch/steps.py``:
prefill (full-sequence forward), one serve step and one train step.

The prefill and serve steps run on the card unless ``device="cpu"`` is
passed (``None`` raises without CUDA); the parameters must live on that
device, and the inputs (tokens, or the encoder's frames) are moved there.
The train step runs where the model's parameters live and moves the
batch there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.backends.engine import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import decode_step, forward, loss_fn
from repro_torch.optim import AdamWConfig, adamw_update


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


def train_batch(batch, device) -> dict:
    """The batch's arrays as tensors on ``device``: token ids and labels
    as int64, frames as they are (the forward casts them)."""
    out = {}
    for key, val in batch.items():
        if key == "frames":
            out[key] = _frames(val, device)
        else:
            out[key] = _tokens(val, device)
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    n_microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32,
                    impl: Optional[str] = None):
    """(model, opt_state, batch, step) -> (opt_state, metrics): one AdamW
    step on :func:`~repro_torch.models.model.loss_fn`, the model's
    parameters and the state updated in place.  Metrics (0-dim tensors,
    nothing read back to the host): ``loss``, ``xent``, ``moe_aux``,
    ``grad_norm`` and ``lr``.  The model's parameters must require
    gradients (``model.requires_grad_(True)``).

    ``n_microbatches > 1`` splits the batch along dim 0 into that many
    microbatches (rows ``i * B/M ..``, as the reference's reshape) and
    adds each one's gradients into buffers of ``accum_dtype`` (fp32), then
    clears ``.grad``: a bf16 ``.grad`` would accumulate in bf16, which
    the reference does not.  The raw sum goes to ``adamw_update`` with
    ``grad_scale = 1/M``, as the reference passes it."""

    def grads_of(model, params, batch):
        for p in params.values():
            p.grad = None
        total, parts = loss_fn(cfg, model, batch, impl=impl)
        total.backward()
        return total.detach(), {k: v.detach() for k, v in parts.items()}

    def train_step(model, opt_state, batch, step):
        params = dict(model.named_parameters())
        frozen = [k for k, p in params.items() if not p.requires_grad]
        if frozen:
            raise ValueError(f"parameters without gradients: {frozen[:3]} "
                             f"(call model.requires_grad_(True))")
        dev = next(iter(params.values())).device
        batch = train_batch(batch, dev)
        grad_scale = 1.0
        if n_microbatches == 1:
            loss, parts = grads_of(model, params, batch)
            grads = {k: p.grad for k, p in params.items()}
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % n_microbatches:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{n_microbatches} microbatches")
            micro = {k: v.reshape((n_microbatches, rows // n_microbatches)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=accum_dtype, device=dev)
                     for k, p in params.items()}
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            aux_sum = torch.zeros_like(loss_sum)
            for i in range(n_microbatches):
                loss, parts = grads_of(model, params,
                                       {k: v[i] for k, v in micro.items()})
                for k, p in params.items():
                    grads[k] += p.grad.to(accum_dtype)
                    p.grad = None
                loss_sum = loss_sum + loss
                aux_sum = aux_sum + parts["moe_aux"]
            grad_scale = 1.0 / n_microbatches
            loss = loss_sum / n_microbatches
            parts = {"xent": loss, "moe_aux": aux_sum / n_microbatches}
        _, opt_state, metrics = adamw_update(params, grads, opt_state, step,
                                             opt_cfg, grad_scale=grad_scale)
        for p in params.values():
            p.grad = None
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics.update(parts)
        return opt_state, metrics

    return train_step
