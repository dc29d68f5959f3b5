"""Selective scan (Mamba2 recurrence): plain PyTorch version + CUDA kernel.

    h_t = exp(a_t) * h_{t-1} + dt_t * (x_t outer B_t);   y_t = h_t . C_t

Layout as the Pallas kernel's (``src/repro/kernels/ssm_scan.py``): x
``(B, H, S, P)``, a/dt ``(B, H, S)``, Bm/Cm ``(B, S, N)`` (one group, shared
by every head); y ``(B, H, S, P)`` in fp32 whatever the input type, the
state ``(P, N)`` of each (batch, head) in fp32 from zero.

Both versions round as the Pallas body does in fp32: ``exp(a) * h`` and
``dt * (x * B)`` each rounded, then their sum.  The dot ``h . C`` is
summed in one fixed order: 32 "virtual lanes", lane ``v`` adding the
products of entries ``v, v + 32, ...`` in order, then a pairwise tree over
the lanes, adjacent ones first (``v`` with ``v ^ 1``, then ``v ^ 2``, 4,
8, 16).  The row ``h[p, :]`` of the state depends on ``x[p]`` alone; the
kernel gives each row 8 threads, thread ``l`` holding the virtual lanes
``4 l .. 4 l + 3``, so the tree's first two stages are adds in its
registers and the last three cross threads.  :func:`ssm_scan_plain` sums
in that order too (:func:`_lane_sum`), so kernel and plain agree bit for
bit where their ``exp`` does.

``chunk`` is the reference's sequence tile: ``S`` must be a multiple of
``min(chunk, S)``, as there, and the result does not depend on it.  The
plain version walks the sequence in tiles of that many steps (the state
carried across tiles, as the Pallas grid carries it in VMEM); the kernel
walks it all in one block loop.

:func:`ssm_scan` dispatches on the tensor's device as
:func:`repro_torch.kernels.power_step.resolve_impl` does: the plain
version for CPU tensors, the hand-written kernel (``csrc/ssm_scan.cu``)
for CUDA tensors, which it launches or raises.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.power_step import resolve_impl

DEFAULT_CHUNK = 256
#: Virtual lanes of the dot product: lane ``v`` sums entries ``n = v + 32 j``.
LANES = 32
#: Largest state width the kernel takes (8 entries a virtual lane).
MAX_STATE = 8 * LANES

#: Types the kernel takes for x, Bm and Cm (codes passed to the C entry
#: point); a and dt are fp32.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches, counted where each launch happens.
LAUNCHES: Counter = Counter(ssm_scan=0)


def _check(x, a, dt, Bm, Cm, chunk: int):
    """(B, H, S, P, N) of valid inputs; the reference's chunk check."""
    if x.dim() != 4 or a.dim() != 3 or Bm.dim() != 3:
        raise ValueError(f"x (B, H, S, P), a/dt (B, H, S), Bm/Cm (B, S, N); "
                         f"got {tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(Bm.shape)}")
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    if (tuple(a.shape) != (b, h, s) or tuple(dt.shape) != (b, h, s)
            or tuple(Bm.shape) != (b, s, n) or tuple(Cm.shape) != (b, s, n)):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, dt {tuple(dt.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    ch = min(chunk, s)
    if ch < 1 or s % ch:
        raise ValueError(f"S={s} must divide chunk={ch}")
    return b, h, s, p, n


def _tree(v: torch.Tensor) -> torch.Tensor:
    """``(..., 32) -> (...)``: the pairwise tree over the virtual lanes,
    adjacent lanes first (``v`` with ``v ^ 1``, then pairs, ...)."""
    for _ in range(5):
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def _lane_sum(prod: torch.Tensor) -> torch.Tensor:
    """``(..., N) -> (...)``: the kernel's sum over the state axis.  Virtual
    lane ``v`` adds entries ``v, v + 32, ...`` in order (zeros past N add
    nothing), then the tree adds the lanes."""
    n = prod.shape[-1]
    k = -(-n // LANES)
    v = F.pad(prod, (0, k * LANES - n)).unflatten(-1, (k, LANES))
    acc = v[..., 0, :]
    for j in range(1, k):
        acc = acc + v[..., j, :]
    return _tree(acc)


def ssm_scan_plain(x, a, dt, Bm, Cm,
                   chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """The recurrence step by step, in tiles of ``min(chunk, S)`` steps:
    each tile forms ``dt * (x * B)`` for all its steps at once, runs the
    two state ops a step, and sums ``h . C`` for all its steps."""
    b, h, s, p, n = _check(x, a, dt, Bm, Cm, chunk)
    ch = min(chunk, s)
    # step-major layouts: index t of the tile is a contiguous (B, H, P, N)
    xf = x.float().permute(2, 0, 1, 3)[..., None]        # (S, B, H, P, 1)
    ea = torch.exp(a.float()).permute(2, 0, 1)[..., None, None]
    dtf = dt.float().permute(2, 0, 1)[..., None, None]   # (S, B, H, 1, 1)
    bf = Bm.float().transpose(0, 1)[:, :, None, None, :]  # (S, B, 1, 1, N)
    cf = Cm.float().transpose(0, 1)[:, :, None, None, :]
    y = torch.empty((s, b, h, p), dtype=torch.float32, device=x.device)
    hs = torch.empty((ch, b, h, p, n), dtype=torch.float32, device=x.device)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    for t0 in range(0, s, ch):
        tile = slice(t0, t0 + ch)
        u = dtf[tile] * (xf[tile] * bf[tile])             # (T, B, H, P, N)
        e = ea[tile]
        for i in range(ch):
            torch.mul(e[i], hs[i - 1] if i else state, out=hs[i])
            hs[i] += u[i]
        state = hs[ch - 1].clone()
        y[tile] = _lane_sum(hs * cf[tile])
    return y.permute(1, 2, 0, 3).contiguous()


def ssm_scan_cuda(x, a, dt, Bm, Cm,
                  chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Launch the hand-written kernel: contiguous tensors on one CUDA
    device, x/Bm/Cm of one type (fp32 or bf16), a/dt fp32, N <= 256."""
    from repro_torch.kernels._build import check, load_library

    b, h, s, p, n = _check(x, a, dt, Bm, Cm, chunk)
    for t in (x, a, dt, Bm, Cm):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"the CUDA kernel needs every input on one "
                             f"CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("the ssm_scan kernel takes contiguous tensors")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"the ssm_scan kernel takes float32 or bfloat16 x, "
                         f"Bm, Cm of one type, got {x.dtype}, {Bm.dtype}, "
                         f"{Cm.dtype}")
    if a.dtype != torch.float32 or dt.dtype != torch.float32:
        raise ValueError(f"the ssm_scan kernel takes float32 a and dt, got "
                         f"{a.dtype} and {dt.dtype}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the ssm_scan kernel takes a state of 1 to "
                         f"{MAX_STATE} entries, got N={n}")
    if b > 65535 or h > 65535 or min(b, h, s, p) < 1:
        raise ValueError(f"the ssm_scan kernel takes 1 <= B, H <= 65535 "
                         f"and S, P >= 1, got {tuple(x.shape)}")
    lib = load_library().lib
    y = torch.empty((b, h, s, p), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.repro_ssm_scan(x.data_ptr(), a.data_ptr(), dt.data_ptr(),
                                  Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                                  b, h, s, p, n, _DTYPES[x.dtype], stream)
    check(code, "ssm_scan")
    LAUNCHES["ssm_scan"] += 1
    return y


def ssm_scan(x, a, dt, Bm, Cm, *, chunk: int = DEFAULT_CHUNK,
             impl: Optional[str] = None) -> torch.Tensor:
    """x ``(B, H, S, P)``; a/dt ``(B, H, S)``; Bm/Cm ``(B, S, N)`` -> y
    ``(B, H, S, P)`` fp32.  Dispatch (see
    :func:`~repro_torch.kernels.power_step.resolve_impl`): the kernel for
    CUDA tensors, the plain version for CPU ones."""
    if resolve_impl(impl, x) == "plain":
        return ssm_scan_plain(x, a, dt, Bm, Cm, chunk)
    return ssm_scan_cuda(x, a, dt, Bm, Cm, chunk)
