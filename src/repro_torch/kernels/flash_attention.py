"""Flash attention (GQA, causal / full, sliding window): plain PyTorch
version + CUDA kernel.

Layout as the Pallas kernel's (``src/repro/kernels/flash_attention.py``):
q ``(B, H, Sq, dh)``, k/v ``(B, Hkv, Sk, dh)``, query head ``h`` reads kv
head ``h // (H // Hkv)``; out ``(B, H, Sq, dh)`` in q's type.  Positions
are the indices ``0..S-1`` of both sequences; ``causal`` keeps ``q >= k``
and ``window > 0`` keeps ``q - k < window``, as ``blocked_attend`` does.

The softmax runs online over kv tiles of :data:`BLOCK_KV` keys with
(m, l, acc) in fp32, masked scores ``-1e30`` and the output
``acc / max(l, 1e-30)``.  Rounding follows the model's ``blocked_attend``
(the function the kernel replaces on the model path): q, k and v stay in
their type, p is rounded to v's type before the PV product, l sums the
unrounded p.  For fp32 inputs this is also the Pallas body's arithmetic.

:func:`flash_attention` dispatches on the tensors' device as
:func:`repro_torch.kernels.power_step.resolve_impl` does: the plain loop
for CPU tensors, the hand-written kernel (``csrc/flash_attention.cu``)
for CUDA tensors, which it launches or raises.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.power_step import resolve_impl

#: The kernel's query and kv tile sizes; sequence lengths must be
#: multiples of them (the kernel does not pad, nor does the reference).
BLOCK_Q = 64
BLOCK_KV = 64
#: Head dims the kernel is built for.
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: Score of a masked query/key pair (both JAX forms use it).
MASKED = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches, counted where each launch happens.
LAUNCHES: Counter = Counter(flash_attention=0)


def softmax_scale(dh: int) -> float:
    """``1 / sqrt(dh)`` rounded in fp32, as ``blocked_attend`` computes
    it; exact as a Python float."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _check_shapes(q, k, v):
    """(B, H, Hkv, Sq, Sk, dh) of valid Pallas-layout inputs."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, H, Sq, dh) and k/v (B, Hkv, Sk, dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (batch, dh, H a multiple of Hkv)")
    return b, h, hkv, sq, sk, dh


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0,
                          block_kv: int = BLOCK_KV) -> torch.Tensor:
    """The kernel's online softmax as a torch loop over kv tiles of
    ``min(block_kv, Sk)`` keys (all query rows at once)."""
    b, h, hkv, sq, sk, dh = _check_shapes(q, k, v)
    bk = min(block_kv, sk)
    if sk % bk:
        raise ValueError(f"Sk={sk} must be a multiple of the kv block {bk}")
    g = h // hkv
    scale = softmax_scale(dh)
    qf = q.reshape(b, hkv, g * sq, dh).float()
    q_pos = torch.arange(sq, device=q.device).repeat(g)
    m = torch.full((b, hkv, g * sq, 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g * sq, dh), device=q.device)
    for k0 in range(0, sk, bk):
        kb = k[:, :, k0:k0 + bk].float()
        vb = v[:, :, k0:k0 + bk]
        s = (qf @ kb.transpose(-1, -2)) * scale
        rel = q_pos[:, None] - torch.arange(k0, k0 + bk, device=q.device)
        keep = torch.ones_like(rel, dtype=torch.bool)
        if causal:
            keep &= rel >= 0
        if window > 0:
            keep &= rel < window
        s = torch.where(keep, s, MASKED)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ vb.float()
        m = m_new
    out = acc / l.clamp(min=1e-30)
    return out.view(b, h, sq, dh).to(q.dtype)


def flash_attention_cuda(q, k, v, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Launch the hand-written kernel: contiguous q/k/v of one type (fp32
    or bf16) on one CUDA device, Sq and Sk multiples of 64, dh in
    :data:`HEAD_DIMS`."""
    from repro_torch.kernels._build import check, load_library

    b, h, hkv, sq, sk, dh = _check_shapes(q, k, v)
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"the CUDA kernel needs q, k, v on one CUDA "
                             f"device, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"the flash kernel takes float32 or bfloat16 "
                             f"q, k, v of one type, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the flash kernel takes contiguous tensors")
    if sq % BLOCK_Q or sk % BLOCK_KV or sq == 0 or sk == 0:
        raise ValueError(f"Sq={sq} and Sk={sk} must be positive multiples "
                         f"of the kernel's tiles ({BLOCK_Q}, {BLOCK_KV})")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes dh in {HEAD_DIMS}, "
                         f"got {dh}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    lib = load_library().lib
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, hkv, sq, sk, dh, softmax_scale(dh), int(bool(causal)),
            int(window), _DTYPES[q.dtype], stream)
    check(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Dispatch (see :func:`~repro_torch.kernels.power_step.resolve_impl`):
    the kernel for CUDA tensors, the plain loop for CPU ones."""
    if resolve_impl(impl, q) == "plain":
        return flash_attention_plain(q, k, v, causal, window)
    return flash_attention_cuda(q, k, v, causal, window)
