"""Fused RMSNorm: plain PyTorch version + CUDA kernel.

``y = x * rsqrt(mean(x^2) + eps) * gamma`` over the last axis of ``x``
``(..., d)`` with ``gamma (d,)``, the mean square accumulated in fp32
whatever the input type, the result in ``x``'s type.  Two rounding forms:

* the Pallas kernel's (``src/repro/kernels/rmsnorm.py``, default):
  ``x * r * gamma`` in fp32, rounded once;
* the model layer's (``layer_form=True``, what ``models/layers.rmsnorm``
  runs): ``x * r`` rounded to ``x``'s type, then multiplied by ``gamma``
  in that type.

The two agree in fp32 and differ by one rounding in bf16.

:func:`rmsnorm_plain` sums the squares in the order of the CUDA kernel's
block reduction (:func:`_sum_squares`), so the kernel and its plain
version agree bit for bit on the card.  :func:`rmsnorm` dispatches on the
tensor's device as :func:`repro_torch.kernels.power_step.resolve_impl`
does: the plain version for CPU tensors, the hand-written kernel
(``csrc/rmsnorm.cu``) for CUDA tensors, which it launches or raises.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.power_step import resolve_impl

#: Threads of the kernel's block; thread ``t`` sums elements ``t``,
#: ``t + THREADS``, ... of its row.
THREADS = 256

#: Types the kernel takes (codes passed to the C entry point).
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches, counted where each launch happens.
LAUNCHES: Counter = Counter(rmsnorm=0)


def _inv(d: int) -> float:
    """The fp32 reciprocal of ``d``, as a Python float (exact in fp32):
    the kernel and the plain version both take the mean as sum * this."""
    return float(np.float32(1.0) / np.float32(d))


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """``(R, 32) -> (R, 1)``: a warp's xor butterfly, in lane 0's order."""
    for off in (16, 8, 4, 2, 1):
        v = v[:, :off] + v[:, off:2 * off]
    return v


def _sum_squares(xf: torch.Tensor) -> torch.Tensor:
    """``(R, d)`` fp32 -> ``(R, 1)`` sum of squares in the kernel's order:
    thread ``t`` adds the squares of its elements in order (zero padding
    adds nothing), each warp of 32 threads adds its lanes with a
    butterfly, and the 8 warps' partials go through one more."""
    r, d = xf.shape
    per = -(-d // THREADS)
    sq = F.pad(xf * xf, (0, per * THREADS - d)).view(r, per, THREADS)
    acc = sq[:, 0]
    for i in range(1, per):
        acc = acc + sq[:, i]
    warps = THREADS // 32
    partial = _butterfly(acc.reshape(r * warps, 32)).view(r, warps)
    return _butterfly(F.pad(partial, (0, 32 - warps)))


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5,
                  layer_form: bool = False) -> torch.Tensor:
    """Plain PyTorch RMSNorm (see the module doc for the two forms)."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    ms = _sum_squares(xf) * _inv(d)
    y = xf * torch.sqrt(ms + eps).reciprocal()
    if layer_form:
        out = y.to(x.dtype) * gamma.to(x.dtype)
    else:
        out = (y * gamma.float()).to(x.dtype)
    return out.view(x.shape)


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5,
                 layer_form: bool = False) -> torch.Tensor:
    """Launch the hand-written kernel: ``x`` contiguous on a CUDA device,
    ``gamma (d,)`` of the same type and device, fp32 or bf16."""
    from repro_torch.kernels._build import check, load_library

    if x.device.type != "cuda" or gamma.device != x.device:
        raise ValueError(f"the CUDA kernel needs x and gamma on one CUDA "
                         f"device, got {x.device} and {gamma.device}")
    if x.dtype not in _DTYPES or gamma.dtype != x.dtype:
        raise ValueError(f"the rmsnorm kernel takes float32 or bfloat16 x "
                         f"and gamma of x's type, got {x.dtype} and "
                         f"{gamma.dtype}")
    d = x.shape[-1]
    if x.dim() < 1 or d < 1 or tuple(gamma.shape) != (d,):
        raise ValueError(f"x (..., d) and gamma (d,), got {tuple(x.shape)} "
                         f"and {tuple(gamma.shape)}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("the rmsnorm kernel takes contiguous tensors")
    rows = x.numel() // d
    if rows < 1:
        raise ValueError("the rmsnorm kernel needs at least one row")
    lib = load_library().lib
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.repro_rmsnorm(x.data_ptr(), gamma.data_ptr(),
                                 out.data_ptr(), rows, d, _inv(d), eps,
                                 _DTYPES[x.dtype], int(bool(layer_form)),
                                 stream)
    check(code, "rmsnorm")
    LAUNCHES["rmsnorm"] += 1
    return out


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5,
            layer_form: bool = False,
            impl: Optional[str] = None) -> torch.Tensor:
    """Dispatch (see :func:`~repro_torch.kernels.power_step.resolve_impl`):
    the kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_impl(impl, x) == "plain":
        return rmsnorm_plain(x, gamma, eps, layer_form)
    return rmsnorm_cuda(x, gamma, eps, layer_form)
