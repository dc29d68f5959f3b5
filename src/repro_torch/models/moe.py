"""Mixture-of-Experts FFN with capacity-based token dispatch, transcribed
from the reference's ``models/moe.py`` (GShard/Switch style):

  1. router: logits ``(B, S, E)`` in fp32 -> softmax -> top-k experts per
     token, the k weights renormalised to sum to 1;
  2. position of each (token, choice) in its expert, ranked
     **choice-major** (every token's first choice, then every second
     choice, ...) within each batch row (the dispatch group); a choice
     ranked at or past the capacity ``C`` is dropped (the residual
     passes through at the block level);
  3. dispatch: tokens into an ``(E, C, d)`` buffer per row;
  4. expert SwiGLU: batched products over the expert axis (every
     expert's weights are read, as in the reference's einsums);
  5. combine: each choice's expert output gathered back, weighted by its
     router probability, added in choice order ``j = 0 .. k-1`` in the
     model's type; Arctic's dense residual SwiGLU added last.

The expert products are plain matrix products that the reference leaves
to XLA outside any Pallas kernel; the port leaves them to ``torch.einsum``.

Exactness of the dispatch: a dropped choice is sent to slot ``C - 1``
with its contribution multiplied by 0, so every slot sums one real token
plus exact zeros, and ``index_add_`` rebuilds the reference's scatter-add
value for value.  The ranks are one cumulative sum, along the
choice-major sequence, of each expert's indicator row (the sequence is
the innermost axis, so the scan runs along rows): the reference's
per-choice cumsum plus its running ``base`` count, the same integers, so
the same tokens drop.

Under a sharding policy, on a DTensor batch (the dry run), the FFN runs
as :func:`_moe_ffn_sharded`, with the reference's ``constrain`` sites.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models.layers import MLP, dense_init, frozen, mlp_init
from repro_torch.models.sharding import constrain, get_policy, is_dtensor


class MoE(nn.Module):
    """One MoE FFN: fp32 ``router (d, E)``, expert stacks ``wi``/``wg (E,
    d, ff)`` and ``wo (E, ff, d)``, and Arctic's ``dense`` SwiGLU (or
    None)."""

    def __init__(self, router, wi, wg, wo, dense: Optional[MLP] = None):
        super().__init__()
        self.router = frozen(router)
        self.wi, self.wg, self.wo = frozen(wi), frozen(wg), frozen(wo)
        self.dense = dense


def _expert_stack(gen: torch.Generator, n_experts: int, d_in: int,
                  d_out: int, dtype) -> torch.Tensor:
    """``(E, d_in, d_out)`` drawn one expert at a time (each through an
    fp32 temporary of one expert's size), scale ``1/sqrt(d_in)``."""
    out = torch.empty((n_experts, d_in, d_out), dtype=dtype,
                      device=gen.device)
    for e in range(n_experts):
        out[e] = dense_init(gen, d_in, d_out, dtype)
    return out


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype, dense_residual_ff: int = 0) -> MoE:
    """The reference's leaves in its draw order: router, wi, wg, wo, then
    the dense SwiGLU's wi, wg, wo."""
    router = dense_init(gen, d_model, n_experts, torch.float32)
    wi = _expert_stack(gen, n_experts, d_model, d_ff, dtype)
    wg = _expert_stack(gen, n_experts, d_model, d_ff, dtype)
    wo = _expert_stack(gen, n_experts, d_ff, d_model, dtype)
    dense = None
    if dense_residual_ff:
        dense = mlp_init("swiglu", gen, d_model, dense_residual_ff, dtype)
    return MoE(router, wi, wg, wo, dense)


def capacity(tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert and dispatch group: ``ceil(top_k * tokens / E *
    capacity_factor)`` rounded up to a multiple of 8, at least 8."""
    c = math.ceil(top_k * tokens / n_experts * capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


class Routing(NamedTuple):
    """The router's decisions for ``x (B, S, d)``."""

    gate_w: torch.Tensor     # (B, S, k) fp32, each token's weights sum to 1
    gate_idx: torch.Tensor   # (B, S, k) int64, experts by falling weight
    pos: torch.Tensor        # (B, S, k) slot in the expert (C - 1 if dropped)
    keep: torch.Tensor       # (B, S, k) bool, False where dropped
    aux: torch.Tensor        # () fp32, Switch load-balance loss
    capacity: int            # C, slots per expert and batch row


def _route(router: torch.Tensor, x: torch.Tensor, *, n_experts: int,
           top_k: int, capacity_factor: float):
    """:func:`route`'s ``Routing``, and the auxiliary loss's two factors:
    each expert's mean probability and mean share of choices (E,)."""
    b, s, _ = x.shape
    e, k = n_experts, top_k
    cap = capacity(s, e, k, capacity_factor)
    probs = torch.softmax(x.float() @ router, dim=-1)             # (B,S,E)
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9)

    me = probs.mean(dim=(0, 1))                                   # (E,)
    ce = F.one_hot(gate_idx, e).float().mean(dim=(0, 1)).sum(0)   # (E,)
    aux = e * (me * (ce / k)).sum()

    flat = gate_idx.transpose(1, 2).reshape(b, 1, k * s)   # choice-major
    experts = torch.arange(e, device=x.device)[None, :, None]
    ranks = (flat == experts).cumsum(dim=-1) - 1                  # (B,E,kS)
    pos = ranks.gather(1, flat).view(b, k, s).transpose(1, 2)     # (B,S,k)
    keep = pos < cap
    return Routing(gate_w, gate_idx, torch.where(keep, pos, cap - 1), keep,
                   aux, cap), me, ce


def route(router: torch.Tensor, x: torch.Tensor, *, n_experts: int,
          top_k: int, capacity_factor: float) -> Routing:
    """Router probabilities, top-k choices, the auxiliary loss and each
    choice's slot, ranked choice-major per batch row (see the module
    doc)."""
    return _route(router, x, n_experts=n_experts, top_k=top_k,
                  capacity_factor=capacity_factor)[0]


def _dispatch(r: Routing, x: torch.Tensor, n_experts: int):
    """(each choice's row of the flat ``(B*E*C, d)`` buffer ``(B, S, k)``,
    the buffer ``(B, E, C, d)`` with every kept token added into its
    slot)."""
    b, s, d = x.shape
    e, cap = n_experts, r.capacity
    rows = torch.arange(b, device=x.device)[:, None, None] * (e * cap)
    slot = rows + r.gate_idx * cap + r.pos                        # (B,S,k)

    contrib = x[:, :, None, :] * r.keep[..., None].to(x.dtype)    # (B,S,k,d)
    buf = torch.zeros((b * e * cap, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot.reshape(-1), contrib.reshape(-1, d))
    return slot, buf.view(b, e, cap, d)


def _combine(out_buf: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Each choice's expert output (rows ``slot`` of ``out_buf`` as ``(B*E*C,
    d)``) times its weight ``w (B, S, k)``, added in choice order."""
    picked = out_buf.reshape(-1, x.shape[-1])[slot]               # (B,S,k,d)
    out = torch.zeros_like(x)
    for j in range(slot.shape[-1]):
        out = out + picked[:, :, j] * w[..., j, None]
    return out


def _experts(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """The expert SwiGLU over the dispatch buffer ``(B, E, C, d)``."""
    h = F.silu(torch.einsum("becd,edf->becf", buf, p.wg)) * \
        torch.einsum("becd,edf->becf", buf, p.wi)
    return torch.einsum("becf,efd->becd", h, p.wo)


def moe_ffn(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(B, S, d)`` -> (out ``(B, S, d)`` in x's type, the auxiliary
    load-balancing loss, an fp32 scalar).  Each batch row is a dispatch
    group with its own capacity, as in the reference."""
    if get_policy() is not None and is_dtensor(x):
        return _moe_ffn_sharded(p, x, n_experts=n_experts, top_k=top_k,
                                capacity_factor=capacity_factor)
    e, k = n_experts, top_k
    r = route(p.router, x, n_experts=e, top_k=k,
              capacity_factor=capacity_factor)
    slot, buf = _dispatch(r, x, e)
    out = _combine(_experts(p, buf), slot,
                   (r.gate_w * r.keep).to(x.dtype), x)
    if p.dense is not None:          # Arctic-style dense residual branch
        out = out + p.dense(x)
    return out, r.aux


def _moe_ffn_sharded(p: MoE, x: torch.Tensor, *, n_experts: int,
                     top_k: int, capacity_factor: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_ffn` on a DTensor batch under a sharding policy, with the
    reference's constraints: routing and dispatch run on each data shard's
    own rows (``local_map``: a row is its own dispatch group, so this is
    the same arithmetic), the ``(B, E, C, d)`` buffer is redistributed to
    experts over the model axis for the expert products and back to the
    batch split for the local combine.  The slots a shard's routing gives
    count its own rows from 0; only its own combine reads them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    e, k = n_experts, top_k
    x = constrain(x, "dp", None, None)
    mesh = x.device_mesh
    bp = tuple(pl if pl == Shard(0) else Replicate() for pl in x.placements)
    avg = tuple(Partial("avg") if pl == Shard(0) else Replicate()
                for pl in bp)
    rep = (Replicate(),) * mesh.ndim

    def local_dispatch(router, xl):
        r, me, ce = _route(router, xl, n_experts=e, top_k=k,
                           capacity_factor=capacity_factor)
        slot, buf = _dispatch(r, xl, e)
        return buf, slot, (r.gate_w * r.keep).to(xl.dtype), me, ce

    buf, slot, w, me, ce = local_map(
        local_dispatch, out_placements=(bp, bp, bp, avg, avg),
        in_placements=(rep, bp), device_mesh=mesh,
        redistribute_inputs=True)(p.router, x)
    aux = e * (me * (ce / k)).sum()
    # batch-sharded -> expert-sharded boundary, and back for the combine
    buf = constrain(buf, None, "mdl", None, None)
    out_buf = constrain(_experts(p, buf), "dp", None, None, None)
    out = local_map(_combine, out_placements=list(bp),
                    in_placements=(bp, bp, bp, bp), device_mesh=mesh,
                    redistribute_inputs=True)(out_buf, slot, w, x)
    if p.dense is not None:
        out = out + p.dense(x)
    return out, aux
