"""Sharding rules: parameter, optimizer-state, batch and cache placements
on the production meshes, the reference's ``launch/sharding.py`` written
as DTensor placements.

Strategy (the reference's baseline):
  * activations: batch over the data(+pod) axes;
  * TP: attention heads / FFN hidden / experts over ``model``;
  * FSDP (ZeRO-3): the *other* big weight dim over ``data``(+``pod``) —
    weights and optimizer state are fully sharded across all ranks;
  * KV caches: batch over data, sequence over ``model`` (flash-decoding
    style split-S; the softmax reductions become small collectives);
  * anything indivisible falls back to replication (never fails).

A rule gives a spec first: one entry a tensor dim, ``None`` or the mesh
axes that split it (``"model"``, or ``("pod", "data")`` split pod-major),
as the reference's ``PartitionSpec``.  :func:`placements` turns a spec
into DTensor placements: ``Shard(d)`` on each mesh dim that an entry on
tensor dim ``d`` names, ``Replicate()`` on every other.

The rules are path-based.  The reference stacks each layer family into
one leaf; the port keeps a tensor a layer, so each rule reads a tensor's
trailing dims, and a port parameter takes the rule of the reference path
:func:`~repro_torch.convert.reference_path` maps its name to.  Every
spec passes a divisibility check against the mesh, so e.g. hubert's
504-way vocab is replicated instead of split unevenly.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes, dp_axes

#: one spec entry: replicated, one mesh axis, or axes split major-first
Axes = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[Axes, ...]


def P(*entries: Axes) -> Spec:
    """A spec, as the reference's ``PartitionSpec(*entries)``."""
    return tuple(entries)


def _axis_size(mesh, axes: Axes) -> int:
    if axes is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _maybe(mesh, axes: Axes, dim: int) -> Axes:
    """Use `axes` for a dim only when it divides evenly."""
    return axes if dim % _axis_size(mesh, axes) == 0 else None


def _pad(spec_tail: Sequence[Axes], rank: int) -> Spec:
    """Left-pad a trailing-dims spec with None for leading dims."""
    pad = rank - len(spec_tail)
    return P(*([None] * pad + list(spec_tail)))


def param_spec(cfg: ModelConfig, mesh, path: str,
               shape: Sequence[int]) -> Spec:
    """Spec of one parameter of ``shape`` at the reference's ``path``
    (``/``-joined keys)."""
    dp = dp_axes(mesh)
    rank = len(shape)
    last = shape[-1] if rank else 1
    second = shape[-2] if rank >= 2 else 1

    def tail2(a, b):
        return _pad((_maybe(mesh, a, second), _maybe(mesh, b, last)), rank)

    if rank == 0:
        return P()
    if "embed" in path:
        return P(_maybe(mesh, "model", shape[0]), _maybe(mesh, dp, shape[1]))
    if "lm_head" in path or "frame_proj" in path:
        return tail2(dp, "model")
    if re.search(r"attn/w[qkv]$", path):
        return tail2(dp, "model")
    if re.search(r"attn/wo$", path):
        return tail2("model", dp)
    if re.search(r"attn/b[qkv]$", path):
        return _pad((_maybe(mesh, "model", last),), rank)
    if "moe/router" in path:
        return tail2(dp, None)
    if re.search(r"moe/w[ig]$", path):  # (E, d, ff): EP x TP(ff over dp)
        return _pad((_maybe(mesh, "model", shape[-3]), None,
                     _maybe(mesh, dp, last)), rank)
    if re.search(r"moe/wo$", path):     # (E, ff, d): contract ff (aligned)
        return _pad((_maybe(mesh, "model", shape[-3]),
                     _maybe(mesh, dp, second), None), rank)
    if re.search(r"(ffn|dense)/(wi|wg)$", path):
        return tail2(dp, "model")
    if re.search(r"(ffn|dense)/wo$", path):
        return tail2("model", dp)
    if re.search(r"ssm/in_proj$", path):
        return tail2(dp, "model")
    if re.search(r"ssm/out_proj$", path):
        return tail2("model", dp)
    if re.search(r"ssm/conv$", path):
        return _pad((None, _maybe(mesh, "model", last)), rank)
    if re.search(r"cell/(up_x|up_z|wq|wk|wv)$", path):
        return tail2(dp, "model")
    if re.search(r"cell/down$", path):
        return tail2("model", dp)
    if re.search(r"cell/w_in$", path):
        return tail2(dp, "model")
    if re.search(r"cell/w_if$", path):
        return tail2(dp, None)
    # norms, biases, scalars, conv kernels, recurrent mats: replicate
    return P(*([None] * rank))


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim an entry on tensor dim ``d`` names (several in the entry's
    order, major first), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


def param_specs(cfg: ModelConfig, mesh, model) -> Dict[str, Spec]:
    """``{parameter name: spec}`` of a model of the port."""
    from repro_torch.convert import reference_path

    return {name: param_spec(cfg, mesh, reference_path(name), p.shape)
            for name, p in model.named_parameters()}


def _moment_specs(cfg, mesh, path: str, moment) -> Dict[str, Spec]:
    """Specs of one moment: a tensor shaped like its parameter takes the
    parameter's spec; an int8 moment's codes too, and its per-row scales
    the spec of a parameter of shape ``scale.shape + (1,)`` cut by one
    dim (the reference's rule)."""
    codes = getattr(moment, "codes", None)
    if codes is None:
        return {"": param_spec(cfg, mesh, path, moment.shape)}
    scale_shape = tuple(moment.scale.shape)
    return {"codes": param_spec(cfg, mesh, path, codes.shape),
            "scale": param_spec(cfg, mesh, path,
                                scale_shape + (1,))[:len(scale_shape)]}


def opt_state_specs(cfg: ModelConfig, mesh, opt_state
                    ) -> Dict[str, Dict[str, Dict[str, Spec]]]:
    """``{name: {"m" | "v": {field: spec}}}`` of an optimizer state
    ``{name: {"m", "v"}}``: the field is ``""`` for a plain moment, and
    ``"codes"`` / ``"scale"`` for an int8 one."""
    from repro_torch.convert import reference_path

    return {name: {key: _moment_specs(cfg, mesh, reference_path(name), mom)
                   for key, mom in moments.items()}
            for name, moments in opt_state.items()}


def batch_specs(cfg: ModelConfig, mesh, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, Spec]:
    """Batch inputs: dim 0 over the data axes where it divides."""
    dp = dp_axes(mesh)
    out = {}
    for k, v in batch.items():
        spec = [None] * len(v.shape)
        if len(v.shape) >= 1:
            spec[0] = _maybe(mesh, dp, v.shape[0])
        out[k] = P(*spec)
    return out


def cache_specs(cfg: ModelConfig, mesh, cache: Dict[str, torch.Tensor]
                ) -> Dict[str, Spec]:
    """KV caches: (stack.., B, S, Hkv, dh) -> batch over dp, seq over
    model.  Recurrent states: batch over dp, biggest inner dim over
    model.  The keys are the reference's."""
    dp = dp_axes(mesh)
    out = {}
    for key, leaf in cache.items():
        shape = leaf.shape
        if key in ("k", "v"):
            # (..., B, S, Hkv, dh): batch over dp, sequence over model;
            # the decode path writes and reads it through the
            # flash-decoding ``decode_attend_seqsharded``
            stack = len(shape) - 4
            spec = [None] * stack + [
                _maybe(mesh, dp, shape[stack]),
                _maybe(mesh, "model", shape[stack + 1]), None, None]
        elif key == "conv":      # (ns, ps, B, W-1, Dc)
            spec = [None, None, _maybe(mesh, dp, shape[2]), None,
                    _maybe(mesh, "model", shape[4])]
        elif key == "ssm":       # (ns, ps, B, H, P, N)
            spec = [None, None, _maybe(mesh, dp, shape[2]),
                    _maybe(mesh, "model", shape[3]), None, None]
        elif key == "mC":        # (ns, ps, B, H, dk, dv)
            spec = [None, None, _maybe(mesh, dp, shape[2]), None,
                    _maybe(mesh, "model", shape[4]), None]
        elif key in ("mn",):     # (ns, ps, B, H, dk)
            spec = [None, None, _maybe(mesh, dp, shape[2]), None,
                    _maybe(mesh, "model", shape[4])]
        elif key == "mconv":     # (ns, ps, B, W-1, d_in)
            spec = [None, None, _maybe(mesh, dp, shape[2]), None,
                    _maybe(mesh, "model", shape[4])]
        elif key in ("sc", "sn", "sh"):  # (ns, B, H, dh)
            spec = [None, _maybe(mesh, dp, shape[1]), None,
                    _maybe(mesh, "model", shape[3])]
        else:                    # mm, sm, small scalars
            spec = [None] * len(shape)
            if len(shape) >= 2:
                spec[1] = _maybe(mesh, dp, shape[1]) \
                    if len(shape) > 2 else spec[1]
        out[key] = P(*spec)
    return out


def replicated(mesh) -> tuple:
    """Placements of a replicated tensor."""
    return placements(mesh, P())


def param_shardings(cfg: ModelConfig, mesh, model) -> Dict[str, tuple]:
    """``{parameter name: placements}``."""
    return {k: placements(mesh, s)
            for k, s in param_specs(cfg, mesh, model).items()}


def opt_state_shardings(cfg: ModelConfig, mesh, opt_state) -> Dict:
    """``{name: {"m" | "v": {field: placements}}}`` (see
    :func:`opt_state_specs`)."""
    return {name: {key: {f: placements(mesh, s) for f, s in fields.items()}
                   for key, fields in moments.items()}
            for name, moments in opt_state_specs(cfg, mesh,
                                                 opt_state).items()}


def batch_shardings(cfg: ModelConfig, mesh, batch) -> Dict[str, tuple]:
    return {k: placements(mesh, s)
            for k, s in batch_specs(cfg, mesh, batch).items()}


def cache_shardings(cfg: ModelConfig, mesh, cache) -> Dict[str, tuple]:
    return {k: placements(mesh, s)
            for k, s in cache_specs(cfg, mesh, cache).items()}
