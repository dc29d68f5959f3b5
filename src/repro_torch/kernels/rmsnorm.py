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

Training: under grad mode, with ``x`` or ``gamma`` requiring a gradient,
:func:`rmsnorm` runs through :class:`RmsnormFunction`, whose backward is
:func:`rmsnorm_bwd`: the hand-written kernel ``csrc/rmsnorm_bwd.cu`` for
CUDA tensors (its own ``LAUNCHES["rmsnorm_bwd"]``), the plain
:func:`rmsnorm_bwd_plain` for CPU ones.  Autograd cannot see through a
``ctypes`` launch, so without it the kernel's output would be a
constant.  :func:`rmsnorm_bwd_cuda` launches as the forward does (packed
arguments, :data:`_BWD_ARGS`; the raw current stream; a device guard
only when needed): at the training shape the kernel takes ~40 µs of
device time, and a slower host would set the time of back-to-back calls.
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

#: The backward's C argument block, ``ReproRmsnormBwdArgs`` in
#: ``csrc/rmsnorm_bwd.cu``: x, gamma, dy, dx, dgamma, the fp32 scratch,
#: rows, d, 1/d, eps, dtype code, layer form.
_BWD_ARGS = struct.Struct("@PPPPPPqiffii")

#: Rows a block of the backward kernel walks (its share of dgamma is
#: summed over them in row order, in registers on the vector path).
BWD_ROWS = 16

#: Chunks of 16 bytes a thread of the backward kernel holds on its vector
#: path (x, dy, the next row's x and dy, gamma and dgamma's partial in
#: registers): bf16 rows up to 8192 wide, fp32 up to 4096.  Wider rows run
#: the strided kernel, in the same order.
BWD_MAX_SLOTS = 4

#: Groups of the backward's second pass: group ``k`` adds the blocks'
#: partial rows ``k``, ``k + BWD_GROUPS``, ... in order, then the groups'
#: sums are added in group order.
BWD_GROUPS = 16

#: Kernel launches, counted where each launch happens.
LAUNCHES: Counter = Counter(rmsnorm=0, rmsnorm_bwd=0)


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


def _row_sum(v: torch.Tensor, vec: int,
             threads: int = THREADS) -> torch.Tensor:
    """``(R, d)`` fp32 -> ``(R, 1)`` sum of each row in the kernel's
    order, with chunks of ``vec`` elements: thread ``t`` adds the elements
    of its chunks ``t``, ``t + threads``, ... chunk by chunk, in element
    order (zero padding past ``d`` adds nothing); each warp of 32 threads
    adds its lanes with a butterfly, and the warps' partials go through
    one more.  The values are laid out as (R, chunk slot, element,
    thread), so each add takes one contiguous (R, threads) slice."""
    r, d = v.shape
    slots = -(-d // (vec * threads))
    vp = F.pad(v, (0, slots * threads * vec - d))
    vt = vp.view(r, slots, threads, vec).transpose(2, 3)
    vt = vt.reshape(r, slots * vec, threads)
    acc = vt[:, 0]
    for k in range(1, slots * vec):
        acc = acc + vt[:, k]
    warps = threads // 32
    partial = _butterfly(acc.reshape(r * warps, 32)).view(r, warps)
    return _butterfly(F.pad(partial, (0, 32 - warps)))


def _sum_squares(xf: torch.Tensor, vec: int,
                 threads: int = THREADS) -> torch.Tensor:
    """``(R, d)`` fp32 -> ``(R, 1)`` sum of squares in the kernel's order
    (:func:`_row_sum` of the squares)."""
    return _row_sum(xf * xf, vec, threads)


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


def bwd_vector_path(x: torch.Tensor, gamma: torch.Tensor,
                    dy: torch.Tensor) -> bool:
    """Whether the backward kernel takes these tensors on its vector path
    (the C launcher's test: d a multiple of the 16-byte chunk, at most
    :data:`BWD_MAX_SLOTS` chunks a thread, 16-byte aligned pointers; the
    outputs and scratch the wrapper allocates are aligned); else the
    strided kernel runs them, in the same order."""
    vec = 16 // x.element_size()
    d = x.shape[-1]
    return (d % vec == 0 and -(-d // vec // THREADS) <= BWD_MAX_SLOTS
            and all(t.data_ptr() % 16 == 0 for t in (x, gamma, dy)))


def _dgamma_sum(part: torch.Tensor) -> torch.Tensor:
    """``(rows, d)`` fp32 terms ``dy * y0`` -> ``(d,)`` in the backward
    kernel's order: each block of :data:`BWD_ROWS` rows adds its rows in
    order from zero; group ``k`` of :data:`BWD_GROUPS` adds the blocks'
    sums ``k``, ``k + BWD_GROUPS``, ... in order from zero; the groups'
    sums are added in group order from zero.  Zero padding adds nothing
    (a sum started from +0 is never -0)."""
    rows, d = part.shape
    blocks = -(-rows // BWD_ROWS)
    p = F.pad(part, (0, 0, 0, blocks * BWD_ROWS - rows))
    p = p.view(blocks, BWD_ROWS, d)
    acc = torch.zeros((blocks, d), dtype=part.dtype, device=part.device)
    for i in range(BWD_ROWS):
        acc = acc + p[:, i]
    q = -(-blocks // BWD_GROUPS)
    acc = F.pad(acc, (0, 0, 0, q * BWD_GROUPS - blocks))
    acc = acc.view(q, BWD_GROUPS, d)
    groups = torch.zeros((BWD_GROUPS, d), dtype=part.dtype,
                         device=part.device)
    for i in range(q):
        groups = groups + acc[i]
    total = torch.zeros(d, dtype=part.dtype, device=part.device)
    for k in range(BWD_GROUPS):
        total = total + groups[k]
    return total


def rmsnorm_bwd_plain(x: torch.Tensor, gamma: torch.Tensor,
                      dy: torch.Tensor, eps: float = 1e-5,
                      layer_form: bool = True):
    """The backward of :func:`rmsnorm_plain` in the backward kernel's
    order: ``(dx, dgamma)``.

    With ``r`` recomputed from ``x`` as the forward does, ``xh = x * r``
    and ``g = dy * gamma`` (fp32), ``dx = r * (g - xh * mean(g * xh))``
    (the rounding of the forward's output taken as the identity, as
    autodiff of the reference does), in ``x``'s type, with ``mean(g *
    xh)`` taken as ``r * sum(g * x) * (1/d)``; ``dgamma`` sums ``dy * y0``
    over the rows in fp32, ``y0`` the forward's ``x * r`` rounded to
    ``x``'s type in the layer's form (unrounded in the other), in
    ``gamma``'s type.  Both row sums run in the kernel's order
    (:func:`_row_sum`: one reduction of the pair in the kernel), dgamma's
    in :func:`_dgamma_sum`'s."""
    d = x.shape[-1]
    vec = 16 // x.element_size()
    xf = x.reshape(-1, d).float()
    dyf = dy.reshape(-1, d).float()
    g = dyf * gamma.float()
    r = torch.sqrt(_row_sum(xf * xf, vec) * _inv(d) + eps).reciprocal()
    mean = r * _row_sum(g * xf, vec) * _inv(d)
    xh = xf * r
    dx = (r * (g - xh * mean)).to(x.dtype).view(x.shape)
    part = dyf * (xh.to(x.dtype).float() if layer_form else xh)
    return dx, _dgamma_sum(part).to(gamma.dtype)


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    """The backward's C entry point, resolved once per process."""
    return _build.load_library().lib.repro_rmsnorm_bwd


def rmsnorm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5, layer_form: bool = True):
    """Launch the backward kernel (``csrc/rmsnorm_bwd.cu``): ``x`` and
    ``dy`` contiguous of one shape, ``gamma (d,)``, one type (fp32 or
    bf16) on one CUDA device.  Returns ``(dx, dgamma)``.  The launch path
    is the forward's: packed arguments, the raw current stream, a device
    guard only when ``x`` is not on the current device."""
    index = x.get_device()
    if not (x.is_cuda and gamma.get_device() == index
            and dy.get_device() == index):
        raise ValueError(f"the CUDA kernel needs x, gamma and dy on one CUDA "
                         f"device, got {x.device}, {gamma.device} and "
                         f"{dy.device}")
    code = _DTYPES.get(x.dtype)
    if code is None or gamma.dtype != x.dtype or dy.dtype != x.dtype:
        raise ValueError(f"the rmsnorm backward kernel takes float32 or "
                         f"bfloat16 x, gamma and dy of one type, got "
                         f"{x.dtype}, {gamma.dtype} and {dy.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if d < 1 or gamma.shape != (d,) or dy.shape != x.shape:
        raise ValueError(f"x (..., d), gamma (d,) and dy of x's shape, got "
                         f"{tuple(x.shape)}, {tuple(gamma.shape)} and "
                         f"{tuple(dy.shape)}")
    if not (x.is_contiguous() and gamma.is_contiguous()
            and dy.is_contiguous()):
        raise ValueError("the rmsnorm backward kernel takes contiguous "
                         "tensors")
    rows = x.numel() // d
    if not 1 <= rows < 2 ** 31:
        raise ValueError(f"the rmsnorm backward kernel takes 1 to 2^31 - 1 "
                         f"rows, got {rows}")
    launch = _bwd_entry()
    _, raw_stream, current_device = _entry()
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    part = torch.empty((-(-rows // BWD_ROWS), d), dtype=torch.float32,
                       device=x.device)
    args = _BWD_ARGS.pack(x.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
                          dx.data_ptr(), dgamma.data_ptr(), part.data_ptr(),
                          rows, d, _inv(d), eps, code,
                          1 if layer_form else 0)
    if index == current_device():
        err = launch(args, raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = launch(args, raw_stream(index))
    if err:
        _build.check(err, "rmsnorm_bwd")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dgamma


def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5, layer_form: bool = True,
                impl: Optional[str] = None):
    """Dispatch the backward: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    if resolve_impl(impl, x) == "plain":
        return rmsnorm_bwd_plain(x, gamma, dy, eps, layer_form)
    return rmsnorm_bwd_cuda(x, gamma, dy.contiguous(), eps, layer_form)


class RmsnormFunction(torch.autograd.Function):
    """:func:`rmsnorm` with its backward (:func:`rmsnorm_bwd`); ``impl``
    is resolved once and serves both directions."""

    @staticmethod
    def forward(ctx, x, gamma, eps: float, layer_form: bool, impl: str):
        ctx.save_for_backward(x, gamma)
        ctx.eps, ctx.layer_form, ctx.impl = eps, layer_form, impl
        if impl == "plain":
            return rmsnorm_plain(x, gamma, eps, layer_form)
        return rmsnorm_cuda(x, gamma, eps, layer_form)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma = rmsnorm_bwd(x, gamma, dy, ctx.eps, ctx.layer_form,
                                 ctx.impl)
        return dx, dgamma, None, None, None


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5,
            layer_form: bool = False,
            impl: Optional[str] = None) -> torch.Tensor:
    """Dispatch (see :func:`~repro_torch.kernels.power_step.resolve_impl`):
    the kernel for CUDA tensors, the plain version for CPU ones; under
    grad mode, with an input that requires a gradient, through
    :class:`RmsnormFunction`."""
    which = resolve_impl(impl, x)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad):
        return RmsnormFunction.apply(x, gamma, eps, layer_form, which)
    if which == "plain":
        return rmsnorm_plain(x, gamma, eps, layer_form)
    return rmsnorm_cuda(x, gamma, eps, layer_form)
