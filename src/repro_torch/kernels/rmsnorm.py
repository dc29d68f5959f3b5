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

The launch path is the decode step's: a norm there is a few microseconds
of device time, so :func:`rmsnorm_cuda` keeps its host work small.  It
resolves the library's entry point once, caches the reciprocal of ``d``,
reads the current stream as a raw handle, enters a device guard only
when ``x`` is not on the current device, and packs the arguments into
one buffer that crosses ``ctypes`` as a pointer (:data:`_ARGS`).  It
launches on PyTorch's current stream, allocates nothing but its output
and never synchronises, so a CUDA graph can capture it.
"""

from __future__ import annotations

import functools
import struct
from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.power_step import resolve_impl

#: Threads of the kernel's block.  The row is cut into chunks of 16 bytes
#: (8 bf16 or 4 fp32 elements); thread ``t`` holds chunks ``t``,
#: ``t + THREADS``, ... .
THREADS = 256

#: Types the kernel takes (codes passed to the C entry point).
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The C entry point's argument block, ``ReproRmsnormArgs`` in
#: ``csrc/rmsnorm.cu``: x, gamma, out, rows, d, 1/d, eps, dtype code,
#: layer form (native alignment, as the C struct lays it out).
_ARGS = struct.Struct("@PPPqiffii")

#: Kernel launches, counted where each launch happens.
LAUNCHES: Counter = Counter(rmsnorm=0)


@functools.lru_cache(maxsize=None)
def _inv(d: int) -> float:
    """The fp32 reciprocal of ``d``, as a Python float (exact in fp32):
    the kernel and the plain version both take the mean as sum * this."""
    return float(np.float32(1.0) / np.float32(d))


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """``(R, 32) -> (R, 1)``: a warp's xor butterfly, in lane 0's order."""
    for off in (16, 8, 4, 2, 1):
        v = v[:, :off] + v[:, off:2 * off]
    return v


def _sum_squares(xf: torch.Tensor, vec: int,
                 threads: int = THREADS) -> torch.Tensor:
    """``(R, d)`` fp32 -> ``(R, 1)`` sum of squares in the kernel's order,
    with chunks of ``vec`` elements: thread ``t`` adds the squares of the
    elements of its chunks ``t``, ``t + threads``, ... chunk by chunk, in
    element order (zero padding past ``d`` adds nothing); each warp of 32
    threads adds its lanes with a butterfly, and the warps' partials go
    through one more.  The squares are laid out as (R, chunk slot,
    element, thread), so each add takes one contiguous (R, threads)
    slice."""
    r, d = xf.shape
    slots = -(-d // (vec * threads))
    xp = F.pad(xf, (0, slots * threads * vec - d))
    xt = xp.view(r, slots, threads, vec).transpose(2, 3)
    sq = torch.mul(xt, xt, out=xf.new_empty(r, slots, vec, threads))
    sq = sq.view(r, slots * vec, threads)
    acc = sq[:, 0]
    for k in range(1, slots * vec):
        acc = acc + sq[:, k]
    warps = threads // 32
    partial = _butterfly(acc.reshape(r * warps, 32)).view(r, warps)
    return _butterfly(F.pad(partial, (0, 32 - warps)))


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5,
                  layer_form: bool = False) -> torch.Tensor:
    """Plain PyTorch RMSNorm (see the module doc for the two forms)."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    ms = _sum_squares(xf, 16 // x.element_size()) * _inv(d)
    y = xf * torch.sqrt(ms + eps).reciprocal()
    if layer_form:
        out = y.to(x.dtype) * gamma.to(x.dtype)
    else:
        out = (y * gamma.float()).to(x.dtype)
    return out.view(x.shape)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, a reader of the current stream's raw handle and
    of the current device's index, resolved once per process (the library
    is built on first use)."""
    return (_build.load_library().lib.repro_rmsnorm,
            torch._C._cuda_getCurrentRawStream, torch._C._cuda_getDevice)


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5,
                 layer_form: bool = False) -> torch.Tensor:
    """Launch the hand-written kernel: ``x`` contiguous on a CUDA device,
    ``gamma (d,)`` of the same type and device, fp32 or bf16."""
    index = x.get_device()
    if not x.is_cuda or gamma.get_device() != index:
        raise ValueError(f"the CUDA kernel needs x and gamma on one CUDA "
                         f"device, got {x.device} and {gamma.device}")
    code = _DTYPES.get(x.dtype)
    if code is None or gamma.dtype != x.dtype:
        raise ValueError(f"the rmsnorm kernel takes float32 or bfloat16 x "
                         f"and gamma of x's type, got {x.dtype} and "
                         f"{gamma.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if d < 1 or gamma.shape != (d,):
        raise ValueError(f"x (..., d) and gamma (d,), got {tuple(x.shape)} "
                         f"and {tuple(gamma.shape)}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("the rmsnorm kernel takes contiguous tensors")
    rows = x.numel() // d
    if rows < 1:
        raise ValueError("the rmsnorm kernel needs at least one row")
    launch, raw_stream, current_device = _entry()
    out = torch.empty_like(x)
    args = _ARGS.pack(x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows,
                      d, _inv(d), eps, code, 1 if layer_form else 0)
    if index == current_device():
        err = launch(args, raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = launch(args, raw_stream(index))
    if err:
        _build.check(err, "rmsnorm")
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
