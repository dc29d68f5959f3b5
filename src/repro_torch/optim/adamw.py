"""AdamW with configurable state precision (fp32 / bf16 / int8), the port
of the reference's ``optim/adamw.py``.

The parameters, gradients and state are dictionaries keyed by parameter
name (``dict(model.named_parameters())``); the state holds ``{"m", "v"}``
per name.  The int8 state keeps each moment as int8 codes in the
parameter's shape and one fp32 scale per row (``shape[:-1]``), as the
reference's ``_quantize_blockwise`` does, and re-quantises after each
moment update.

Deliberate difference: the reference returns new arrays (and its
trainer donates the old ones); :func:`adamw_update` writes the
parameters and the state in place and returns the same objects.  The
update runs as plain PyTorch ops, as the reference's runs outside any
Pallas kernel; its scalars (the clip factor, the learning rate, the bias
corrections) stay 0-dim fp32 tensors on the parameters' device, so a
step reads nothing back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch

#: leaves with ndim >= 3, more than one slice along dim 0 and at least
#: this many elements are updated one slice at a time (the reference's
#: ``CHUNK_ELEMS``: arctic's stacked experts)
CHUNK_ELEMS = 256 * 1024 * 1024


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # float32 | bfloat16 | int8
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class QTensor(NamedTuple):
    """An int8 moment: ``codes`` in the parameter's shape, fp32 ``scale``
    of ``shape[:-1]`` (``(1,)`` for a 0-dim parameter)."""

    codes: torch.Tensor
    scale: torch.Tensor


Moment = Union[torch.Tensor, QTensor]


# ------------------------------------------------------- int8 quantisation
def _quantize_blockwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (fp32, any shape) -> (int8 codes of x.shape, per-row fp32 scales
    of x.shape[:-1])."""
    xs = x if x.dim() else x.reshape(1)
    scale = xs.abs().amax(dim=-1).clamp(min=1e-12) / 127.0
    codes = torch.round(xs / scale[..., None]).clamp(-127, 127)
    return codes.to(torch.int8).reshape(x.shape), scale


def _dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor,
                          shape) -> torch.Tensor:
    cs = codes if codes.dim() else codes.reshape(1)
    return (cs.float() * scale[..., None]).reshape(shape)


def _encode(x: torch.Tensor, dtype: str) -> Moment:
    if dtype == "int8":
        return QTensor(*_quantize_blockwise(x))
    return x.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _decode(x: Moment, shape) -> torch.Tensor:
    if isinstance(x, QTensor):
        return _dequantize_blockwise(x.codes, x.scale, shape)
    return x.float()


def _store(dst: Moment, x: torch.Tensor) -> None:
    """Write the fp32 moment ``x`` into ``dst`` in place, encoded in
    ``dst``'s form (an fp32 moment ``x`` already is ``dst``)."""
    if isinstance(dst, QTensor):
        codes, scale = _quantize_blockwise(x)
        dst.codes.copy_(codes)
        dst.scale.copy_(scale)
    elif dst is not x:
        dst.copy_(x)


# ---------------------------------------------------------------- optimizer
def init_opt_state(params: Mapping[str, torch.Tensor], cfg: AdamWConfig
                   ) -> Dict[str, Dict[str, Moment]]:
    """Zero moments ``{name: {"m", "v"}}`` for a name -> parameter
    mapping (``dict(model.named_parameters())``), on each parameter's
    device."""
    def zeros(p):
        return _encode(torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device), cfg.state_dtype)

    return {name: {"m": zeros(p), "v": zeros(p)}
            for name, p in params.items()}


def lr_schedule(cfg: AdamWConfig, step, device=None) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac`` (fp32)."""
    step = torch.as_tensor(step, device=device).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, leaf by leaf
    in the mapping's order."""
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * factor).to(g.dtype)
            for k, g in grads.items()}, norm


def _leaf_update(p: torch.Tensor, g: torch.Tensor, s_m: Moment,
                 s_v: Moment, cfg: AdamWConfig, factor, lr, bc1,
                 bc2) -> None:
    """One leaf (or one slice of one), in place.  An fp32 moment is
    updated where it lies (``float()`` returns the tensor itself); a bf16
    or int8 one is decoded to a fresh fp32 tensor and stored back."""
    gf = g.float() * factor
    m = _decode(s_m, p.shape).mul_(cfg.b1).add_((1 - cfg.b1) * gf)
    v = _decode(s_v, p.shape).mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
    update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    pf = p.float()
    pf = pf - lr * (update + cfg.weight_decay * pf)
    p.copy_(pf)
    _store(s_m, m)
    _store(s_v, v)


def _slice(s: Moment, i: int) -> Moment:
    return QTensor(s.codes[i], s.scale[i]) if isinstance(s, QTensor) \
        else s[i]


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor],
                 opt_state: Dict[str, Dict[str, Moment]], step,
                 cfg: AdamWConfig, grad_scale: float = 1.0):
    """One AdamW step, in place; returns ``(params, opt_state, metrics)``
    (the same parameter and state objects) with metrics ``grad_norm`` and
    ``lr``.

    ``grad_scale`` rescales the gradients inside the per-leaf fp32 math:
    pass the raw microbatch sum and ``1/M``, and scaling and clipping fold
    into one factor (no scaled copy of the whole gradient set).  Leaves
    of ndim >= 3 with at least :data:`CHUNK_ELEMS` elements are updated
    one slice along dim 0 at a time, so their fp32 temporaries are one
    slice's."""
    if set(grads) != set(params) or set(opt_state) != set(params):
        raise ValueError("params, grads and opt_state must hold the same "
                         "names")
    device = next(iter(params.values())).device
    gnorm = global_norm({k: grads[k] for k in params}) * grad_scale
    factor = grad_scale * torch.clamp(
        cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(cfg, step, device)
    t = torch.as_tensor(step, device=device).to(torch.float32) + 1.0
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=device), t)
    for name, p in params.items():
        g, s = grads[name], opt_state[name]
        if p.dim() >= 3 and p.shape[0] > 1 and p.numel() >= CHUNK_ELEMS:
            for i in range(p.shape[0]):
                _leaf_update(p[i], g[i], _slice(s["m"], i),
                             _slice(s["v"], i), cfg, factor, lr, bc1, bc2)
        else:
            _leaf_update(p, g, s["m"], s["v"], cfg, factor, lr, bc1, bc2)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
