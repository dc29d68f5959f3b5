"""Step functions of the LM paths, as the reference's ``launch/steps.py``:
prefill (full-sequence forward), one serve step and one train step.

The prefill and serve steps run on the card unless ``device="cpu"`` is
passed (``None`` raises without CUDA); the parameters must live on that
device, and the inputs (tokens, or the encoder's frames) are moved there.
The train step runs where the model's parameters live and moves the
batch there.

:func:`abstract_params`, :func:`input_specs` and :func:`abstract_cache`
give a cell's parameters, inputs and decode cache as tensors on the
``meta`` device (shapes and types, no storage), as the reference's
``ShapeDtypeStruct`` stand-ins: the dry run
(:mod:`repro_torch.launch.dryrun`) shards them on its mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.backends.engine import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.ops import is_dtensor
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      init_params, loss_fn)
from repro_torch.optim import AdamWConfig, adamw_update


# ------------------------------------------------------------ input specs
class _OnMeta(TorchFunctionMode):
    """Every tensor a call creates lies on ``meta``: a ``device`` argument
    is replaced, a draw is an ``empty`` of its shape and a write into a
    slice is skipped (nothing is drawn or stored)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__setitem__:
            return None
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        if func is torch.randn:
            kwargs.pop("generator", None)
            func = torch.empty
        return func(*args, **kwargs)


def abstract_params(cfg: ModelConfig):
    """The model of ``cfg`` with every parameter on ``meta``: the shapes,
    types and names ``init_params`` gives, in a few milliseconds."""
    with torch.device("meta"), _OnMeta():
        return init_params(cfg, torch.Generator())


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract model inputs of one (arch x shape) cell, on ``meta``, in
    the reference's types:

    train   : {tokens|frames, labels}
    prefill : {tokens|frames}
    decode  : {tokens (B, 1)} (the position is an int; the cache comes
              from :func:`abstract_cache`)
    """
    b, s = shape.global_batch, shape.seq_len

    def meta(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.family == "encoder":
            out = {"frames": meta((b, s, cfg.d_model), dtype_of(cfg.dtype))}
        else:
            out = {"tokens": meta((b, s), torch.int32)}
        if shape.kind == "train":
            out["labels"] = meta((b, s), torch.int32)
        return out
    if shape.kind == "decode":
        return {"tokens": meta((b, 1), torch.int32)}
    raise ValueError(shape.kind)


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The decode cache of a cell (batch ``global_batch``, ``seq_len``
    slots) on ``meta``."""
    return init_cache(cfg, shape.global_batch, shape.seq_len, "meta")


def _tokens(tokens, device) -> torch.Tensor:
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                           device=device)


def _frames(frames, device) -> torch.Tensor:
    if isinstance(frames, torch.Tensor):
        return frames.to(device=device)
    return torch.as_tensor(np.asarray(frames), device=device)


def _serving(model):
    """Inference mode, or ``no_grad`` for a model of DTensors (the dry
    run's), whose redistributions cannot run on inference tensors."""
    first = next(model.parameters())
    return torch.no_grad() if is_dtensor(first) else torch.inference_mode()


def _greedy(last: torch.Tensor) -> torch.Tensor:
    """Each row's argmax over the vocab.  A DTensor row (the dry run's)
    first gathers its vocab shards (one row of logits a lane): DTensor's
    own argmax over a sharded dim gathers through a path the fake process
    group does not shape right when the batch is not split."""
    if is_dtensor(last):
        from torch.distributed.tensor import Replicate, Shard

        vocab = Shard(last.ndim - 1)
        last = last.redistribute(last.device_mesh, [
            Replicate() if pl == vocab else pl for pl in last.placements])
    return last.argmax(dim=-1)


def make_prefill_step(cfg: ModelConfig, device=None,
                      impl: Optional[str] = None):
    """(params, batch) -> logits ``(B, S, V)``; the batch is ``{"tokens":
    (B, S)}``, or ``{"frames": (B, S, d_model)}`` for the encoder family
    (as the reference's ``input_specs``)."""
    dev = resolve_device(device)

    def prefill_step(params, batch):
        with _serving(params):
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

    def serve_step(params, cache, tokens, pos: int):
        with _serving(params):
            logits, cache = decode_step(cfg, params, cache,
                                        _tokens(tokens, dev), pos, impl=impl)
            return _greedy(logits[:, -1]), logits, cache

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


def _microbatches(v: torch.Tensor, m: int):
    """``v`` split along dim 0 into ``m`` microbatches: rows ``i * B/m ..``
    of the batch, as the reference's reshape.  A DTensor batch (the dry
    run's) splits each rank's own rows the same way, so its rows stay
    where they are, as data-parallel microbatching keeps them."""
    if not is_dtensor(v):
        return v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
    from torch.distributed.tensor import DTensor

    local = v.to_local()
    parts = local.reshape((m, local.shape[0] // m) + tuple(local.shape[1:]))
    shape = (v.shape[0] // m,) + tuple(v.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return [DTensor.from_local(parts[i], v.device_mesh, v.placements,
                               run_check=False, shape=shape, stride=stride)
            for i in range(m)]


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
            micro = {k: _microbatches(v, n_microbatches)
                     for k, v in batch.items()}
            grads = {k: torch.zeros_like(p, dtype=accum_dtype)
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
