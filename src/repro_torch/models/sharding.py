"""Activation-sharding policy hook, as the reference's ``models/sharding.py``.

Model code is mesh-agnostic; a launcher (the dry run) installs a policy
mapping the logical axes ("dp" = batch/fsdp axes, "mdl" = tensor axis)
to the axes of a DeviceMesh, and :func:`constrain` redistributes key
activations of DTensor type to it (embedding output, per-layer residual
stream, logits, MoE dispatch buffers, attention and scan operands).
Without a policy, or on a plain tensor, it returns ``x`` itself: the
paths on the card and on the CPU do not change.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ops import is_dtensor

_LOCAL = threading.local()


def set_policy(mesh, dp, mdl: str = "model") -> None:
    _LOCAL.policy = (mesh, dp, mdl)


def clear_policy() -> None:
    _LOCAL.policy = None


def get_policy() -> Optional[Tuple]:
    """``(mesh, dp axes, model axis)`` of the installed policy, or None."""
    return getattr(_LOCAL, "policy", None)


def logical_spec(mesh, shape, logical) -> tuple:
    """The spec of ``logical`` (``'dp'``, ``'mdl'`` or None a dim) on
    ``mesh``: an axis that does not divide its dim is dropped
    (replicated) rather than erroring."""
    from repro_torch.launch.sharding import _axis_size

    _, dp, mdl = get_policy()
    spec = []
    for dim, name in zip(shape, logical):
        axes = {"dp": dp, "mdl": mdl, None: None}[name]
        if axes is not None and dim % _axis_size(mesh, axes) == 0:
            spec.append(axes)
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """constrain(x, 'dp', None, 'mdl') -> x redistributed to that layout.

    Logical entries: 'dp', 'mdl', or None.  The identity without a policy
    or when ``x`` is not a DTensor."""
    policy = get_policy()
    if policy is None or not is_dtensor(x):
        return x
    from repro_torch.launch.sharding import placements

    mesh = policy[0]
    return x.redistribute(mesh, placements(
        mesh, logical_spec(mesh, x.shape, logical)))


def along_sequence(fn, seq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``fn(seq, w)`` for a causal conv over ``seq (B, S, C)`` with taps
    ``w (W, C)``.  Under a policy, a DTensor ``seq`` is laid out with the
    sequence whole on every rank (``("dp", None, "mdl")``) and ``fn`` runs
    on each rank's shard (``local_map``; ``w`` split as the channels
    are): the conv is then local, and no DTensor rule for a pad or a
    shifted slice of the sequence is needed (some releases have none
    that runs)."""
    policy = get_policy()
    if policy is None or not is_dtensor(seq):
        return fn(seq, w)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    seq = constrain(seq, "dp", None, "mdl")
    chan = Shard(seq.ndim - 1)
    w_pl = tuple(Shard(w.ndim - 1) if pl == chan else Replicate()
                 for pl in seq.placements)
    return local_map(fn, out_placements=list(seq.placements),
                     in_placements=(seq.placements, w_pl),
                     device_mesh=seq.device_mesh,
                     redistribute_inputs=True)(seq, w)
