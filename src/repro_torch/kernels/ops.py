"""Model-layout wrappers around the LM kernels, as the reference's
``kernels/ops.py``: q ``(B, S, H, dh)`` and k/v ``(B, S, Hkv, dh)`` are
swapped to the kernel's ``(B, H, S, dh)`` and back; ``ssm_scan`` takes
the kernel's own layout, as the reference's wrapper does.  ``impl``
picks the implementation as every dispatch of the port does (``None``:
the kernel for CUDA tensors, the plain version for CPU ones).

A DTensor input (the dry run's, on a sharding policy's mesh) goes to the
operator of the same name in :mod:`repro_torch.kernels.sharded`, which
DTensor shards by rule and whose fake form is shape-only; a plain tensor
never does.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssm_scan as _ss


def is_dtensor(x) -> bool:
    """``x`` is a DTensor (checked without importing DTensor for a plain
    tensor)."""
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _sharded():
    from repro_torch.kernels import sharded

    return sharded


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """q ``(B, S, H, dh)``; k/v ``(B, S, Hkv, dh)`` -> ``(B, S, H, dh)``."""
    if is_dtensor(q):
        return _sharded().flash_attention(q, k, v, causal, window, impl)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = _fa.flash_attention(qt, kt, vt, causal=causal, window=window,
                              impl=impl)
    return out.transpose(1, 2)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-5,
            layer_form: bool = False,
            impl: Optional[str] = None) -> torch.Tensor:
    """x ``(..., d)``, gamma ``(d,)`` -> x's shape and type."""
    if is_dtensor(x):
        return _sharded().rmsnorm(x, gamma, eps, layer_form, impl)
    return _rn.rmsnorm(x.contiguous(), gamma.contiguous(), eps, layer_form,
                       impl)


def ssm_scan(x: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = _ss.DEFAULT_CHUNK,
             impl: Optional[str] = None) -> torch.Tensor:
    """x ``(B, H, S, P)``; a/dt ``(B, H, S)``; Bm/Cm ``(B, S, N)`` -> y
    ``(B, H, S, P)`` fp32."""
    if is_dtensor(x):
        return _sharded().ssm_scan(x, a, dt, Bm, Cm, chunk, impl)
    return _ss.ssm_scan(x.contiguous(), a.contiguous(), dt.contiguous(),
                        Bm.contiguous(), Cm.contiguous(), chunk=chunk,
                        impl=impl)
