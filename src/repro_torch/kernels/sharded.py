"""The LM kernels as custom operators that DTensor shards by rule.

:mod:`repro_torch.kernels.ops` hands a DTensor input to these operators
(``torch.ops.repro_torch.*``); plain tensors never reach them, so the
paths on the card and on the CPU are the ones they were.  Each operator
has:

* a real implementation, run on each rank's local shards: the port's
  dispatch (the kernel on CUDA shards, the plain version on CPU ones);
* a shape-only fake implementation (``register_fake``), which is all the
  dry run (:mod:`repro_torch.launch.dryrun`) runs: its shards are fake
  tensors, so no kernel launches and no plain loop steps (the scan's
  plain version walks every step of the sequence);
* a sharding rule (``register_sharding``), one list of acceptable
  placements a mesh dim, following the reference's constraints:

  - ``rmsnorm`` over any row dim (``gamma`` replicated); its backward's
    ``dgamma`` is a partial sum;
  - ``flash_attention`` over the batch, over the heads where both the
    query and the kv heads divide, or over the query sequence with K/V
    whole (the reference's layout: K/V gathered once a layer, queries
    sequence-sharded);
  - ``ssm_scan`` over the batch or the heads (``Bm``/``Cm`` replicated);
    its backward's ``dBm``/``dCm`` are partial sums over the heads.

  Every op also accepts all-replicated inputs; DTensor picks the
  acceptable layout that costs the least redistribution.

The sequence-sharded attention layout is for the dry run's shapes only:
the kernels take no query offset, so the real implementation raises for
queries shorter than the keys.

Each forward is differentiable (``register_autograd``) through its
backward operator, which has the same three parts.  FLOP formulas are
registered for the dry run's counter (``torch.utils.flop_counter``):
attention as ``4 B H Sq Sk dh`` forward and ``8 B H Sq Sk dh`` backward
(the products, as the library's SDPA formulas count them), the scan as
``6 B H S P N`` forward and ``12 B H S P N`` backward; the norm is
elementwise and, as every elementwise op, not counted.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import Tensor
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssm_scan as _ss


def _heads(t: Tensor) -> Tensor:
    """Model layout ``(B, S, H, dh)`` <-> the kernel's ``(B, H, S, dh)``."""
    return t.transpose(1, 2).contiguous()


# ---------------------------------------------------------------- rmsnorm
@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def rmsnorm(x: Tensor, gamma: Tensor, eps: float, layer_form: bool,
            impl: Optional[str]) -> Tensor:
    return _rn.rmsnorm(x.contiguous(), gamma.contiguous(), eps, layer_form,
                       impl)


@rmsnorm.register_fake
def _(x, gamma, eps, layer_form, impl):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::rmsnorm_bwd", mutates_args=())
def rmsnorm_bwd(x: Tensor, gamma: Tensor, dy: Tensor, eps: float,
                layer_form: bool, impl: Optional[str]
                ) -> Tuple[Tensor, Tensor]:
    dx, dgamma = _rn.rmsnorm_bwd(x.contiguous(), gamma.contiguous(),
                                 dy.contiguous(), eps, layer_form, impl)
    return dx, dgamma


@rmsnorm_bwd.register_fake
def _(x, gamma, dy, eps, layer_form, impl):
    return torch.empty_like(x), torch.empty_like(gamma)


def _rmsnorm_setup(ctx, inputs, output):
    x, gamma, eps, layer_form, impl = inputs
    ctx.save_for_backward(x, gamma)
    ctx.args = (eps, layer_form, impl)


def _rmsnorm_backward(ctx, dy):
    x, gamma = ctx.saved_tensors
    dx, dgamma = rmsnorm_bwd(x, gamma, dy, *ctx.args)
    return dx, dgamma, None, None, None


rmsnorm.register_autograd(_rmsnorm_backward, setup_context=_rmsnorm_setup)


@register_sharding(torch.ops.repro_torch.rmsnorm.default)
def _rmsnorm_sharding(x, gamma, eps, layer_form, impl):
    out: List = [([Replicate()], [Replicate(), Replicate(), None, None,
                                  None])]
    for dim in range(len(x.shape) - 1):
        out.append(([Shard(dim)], [Shard(dim), Replicate(), None, None,
                                   None]))
    return out


@register_sharding(torch.ops.repro_torch.rmsnorm_bwd.default)
def _rmsnorm_bwd_sharding(x, gamma, dy, eps, layer_form, impl):
    out: List = [([Replicate(), Replicate()],
                  [Replicate(), Replicate(), Replicate(), None, None, None])]
    for dim in range(len(x.shape) - 1):
        out.append(([Shard(dim), Partial()],
                    [Shard(dim), Replicate(), Shard(dim), None, None, None]))
    return out


# -------------------------------------------------------- flash attention
def _check_aligned(q: Tensor, k: Tensor) -> None:
    if q.shape[1] != k.shape[1]:
        raise NotImplementedError(
            f"sequence-sharded queries ({q.shape[1]} of {k.shape[1]} "
            f"positions): the kernels take no query offset")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                    window: int, impl: Optional[str]) -> Tensor:
    """Model layout: q ``(B, S, H, dh)``, k/v ``(B, S, Hkv, dh)``."""
    _check_aligned(q, k)
    out = _fa.flash_attention(_heads(q), _heads(k), _heads(v), causal=causal,
                              window=window, impl=impl)
    return _heads(out)


@flash_attention.register_fake
def _(q, k, v, causal, window, impl):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                        do: Tensor, causal: bool, window: int,
                        impl: Optional[str]
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    _check_aligned(q, k)
    grads = _fa.flash_attention_bwd(_heads(q), _heads(k), _heads(v),
                                    _heads(o), _heads(do), causal, window,
                                    impl)
    return tuple(_heads(g) for g in grads)


@flash_attention_bwd.register_fake
def _(q, k, v, o, do, causal, window, impl):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, window, impl = inputs
    ctx.save_for_backward(q, k, v, output)
    ctx.args = (causal, window, impl)


def _flash_backward(ctx, do):
    q, k, v, o = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, do, *ctx.args)
    return dq, dk, dv, None, None, None


flash_attention.register_autograd(_flash_backward, setup_context=_flash_setup)


def _flash_layouts(q, k, n_tensors: int, n_outputs: int) -> List:
    """Acceptable layouts of a mesh dim: replicated, batch, heads (when the
    query and kv heads both divide on every mesh dim) and the query
    sequence with K/V whole (forward only)."""
    tail = [None, None, None]
    out: List = [([Replicate()] * n_outputs, [Replicate()] * n_tensors + tail),
                 ([Shard(0)] * n_outputs, [Shard(0)] * n_tensors + tail)]
    sizes = q.mesh.shape
    if all(q.shape[2] % n == 0 and k.shape[2] % n == 0 for n in sizes):
        out.append(([Shard(2)] * n_outputs, [Shard(2)] * n_tensors + tail))
    if n_outputs == 1:
        out.append(([Shard(1)], [Shard(1), Replicate(), Replicate()] + tail))
    return out


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _flash_sharding(q, k, v, causal, window, impl):
    return _flash_layouts(q, k, 3, 1)


@register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
def _flash_bwd_sharding(q, k, v, o, do, causal, window, impl):
    return _flash_layouts(q, k, 5, 3)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                 **kwargs) -> int:
    b, sq, h, dh = q_shape
    return 4 * b * h * sq * k_shape[1] * dh


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_bwd_flops(q_shape, k_shape, *args, out_shape=None,
                     **kwargs) -> int:
    b, sq, h, dh = q_shape
    return 8 * b * h * sq * k_shape[1] * dh


# --------------------------------------------------------------- ssm_scan
@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=())
def ssm_scan(x: Tensor, a: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor,
             chunk: int, impl: Optional[str]) -> Tensor:
    """x ``(B, H, S, P)``; a/dt ``(B, H, S)``; Bm/Cm ``(B, S, N)`` -> y
    ``(B, H, S, P)`` fp32."""
    return _ss.ssm_scan(x.contiguous(), a.contiguous(), dt.contiguous(),
                        Bm.contiguous(), Cm.contiguous(), chunk=chunk,
                        impl=impl)


@ssm_scan.register_fake
def _(x, a, dt, Bm, Cm, chunk, impl):
    return torch.empty(x.shape, dtype=torch.float32, device=x.device)


@torch.library.custom_op("repro_torch::ssm_scan_bwd", mutates_args=())
def ssm_scan_bwd(x: Tensor, a: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor,
                 dy: Tensor, chunk: int, impl: Optional[str]
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    grads = _ss.ssm_scan_bwd(x.contiguous(), a.contiguous(), dt.contiguous(),
                             Bm.contiguous(), Cm.contiguous(),
                             dy.contiguous(), chunk=chunk, impl=impl)
    return tuple(grads)


@ssm_scan_bwd.register_fake
def _(x, a, dt, Bm, Cm, dy, chunk, impl):
    return tuple(torch.empty_like(t) for t in (x, a, dt, Bm, Cm))


def _ssm_setup(ctx, inputs, output):
    x, a, dt, Bm, Cm, chunk, impl = inputs
    ctx.save_for_backward(x, a, dt, Bm, Cm)
    ctx.args = (chunk, impl)


def _ssm_backward(ctx, dy):
    grads = ssm_scan_bwd(*ctx.saved_tensors, dy, *ctx.args)
    return (*grads, None, None)


ssm_scan.register_autograd(_ssm_backward, setup_context=_ssm_setup)


@register_sharding(torch.ops.repro_torch.ssm_scan.default)
def _ssm_sharding(x, a, dt, Bm, Cm, chunk, impl):
    rep, tail = Replicate(), [None, None]
    return [([rep], [rep] * 5 + tail),
            ([Shard(0)], [Shard(0)] * 5 + tail),
            ([Shard(1)], [Shard(1)] * 3 + [rep, rep] + tail)]


@register_sharding(torch.ops.repro_torch.ssm_scan_bwd.default)
def _ssm_bwd_sharding(x, a, dt, Bm, Cm, dy, chunk, impl):
    rep, tail = Replicate(), [None, None]
    heads = [Shard(1)] * 3
    return [([rep] * 5, [rep] * 6 + tail),
            ([Shard(0)] * 5, [Shard(0)] * 6 + tail),
            (heads + [Partial(), Partial()],
             heads + [rep, rep, Shard(1)] + tail)]


@register_flop_formula(torch.ops.repro_torch.ssm_scan)
def _ssm_flops(x_shape, a_shape, dt_shape, bm_shape, *args, out_shape=None,
               **kwargs) -> int:
    b, h, s, p = x_shape
    return 6 * b * h * s * p * bm_shape[-1]


@register_flop_formula(torch.ops.repro_torch.ssm_scan_bwd)
def _ssm_bwd_flops(x_shape, a_shape, dt_shape, bm_shape, *args,
                   out_shape=None, **kwargs) -> int:
    b, h, s, p = x_shape
    return 12 * b * h * s * p * bm_shape[-1]
