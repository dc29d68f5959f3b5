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
for CPU tensors, a hand-written kernel for CUDA tensors, which it
launches or raises.  Two kernels compute the function:

* ``"tc"`` (``csrc/flash_attention_tc.cu``) takes bf16 at dh 64, 80 and
  128 (:data:`TC_HEAD_DIMS`): wgmma on the tensor cores, TMA,
  warp-specialised; query tiles of :data:`TC_BLOCK_Q` rows and kv tiles
  of :data:`TC_BLOCK_KV` keys.  :func:`tc_kv_tiles` and
  :func:`tc_tile_masked` mirror its tile-skip and mask rules.  Its sums
  run in another order than the plain loop's, so its output differs from
  it by a flipped bf16 rounding here and there.
* ``"simt"`` (``csrc/flash_attention.cu``) takes fp32 and bf16 at every
  head dim of :data:`HEAD_DIMS`, and matches the plain loop bit for bit.

The table :data:`KERNEL_VARIANTS` picks one by ``(dtype, dh)``: the
tensor-core kernel for bf16 at dh 64 and 128 (llama3-8b and the other
dense configs), the SIMT kernel for fp32 (the tensor cores would round
it to TF32), for bf16 at dh 16, 32 and 256, and for bf16 at dh 80.  The
last keeps zamba2-2.7b's prefill bit-equal to its plain path: any flash
that is not bit-equal to the plain loop (the tensor-core kernel, SDPA,
the plain loop itself at another kv tile) puts that model's bf16 logits
~3.2-3.3% normwise from the plain path's, above the 2e-2 its full-width
check holds them to (``PERF.md``, PR 14).  ``variant="tc"`` runs the
tensor-core kernel at dh 80 all the same.

Any other pair raises.  Every launch counts under
``LAUNCHES["flash_attention"]``; the tensor-core kernel's also under
``LAUNCHES["flash_attention_tc"]``.  A failed build or launch raises: no
variant falls back to another.
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
#: Head dims the kernels are built for.
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: The tensor-core kernel's head dims (bf16 only), query and kv tiles (a
#: 64-row last query tile and a 64-key last kv tile are allowed).
TC_HEAD_DIMS = (64, 80, 128)
TC_BLOCK_Q = 128
TC_BLOCK_KV = 128
#: The kernel each (dtype, dh) launches by default: "tc" (tensor cores) or
#: "simt" (see the module doc for bf16 at dh 80).
KERNEL_VARIANTS = {
    **{(torch.float32, dh): "simt" for dh in HEAD_DIMS},
    **{(torch.bfloat16, dh): "tc" if dh in (64, 128) else "simt"
       for dh in HEAD_DIMS},
}
#: Score of a masked query/key pair (both JAX forms use it).
MASKED = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches, counted where each launch happens: every launch under
#: ``flash_attention``, the tensor-core kernel's also under
#: ``flash_attention_tc``.
LAUNCHES: Counter = Counter(flash_attention=0, flash_attention_tc=0)


def kernel_variant(dtype: torch.dtype, dh: int,
                   variant: Optional[str] = None) -> str:
    """The kernel that runs ``(dtype, dh)`` on the card: the table's
    (:data:`KERNEL_VARIANTS`) for ``variant=None``, else ``variant``
    itself if that kernel takes the pair.  Raises for a pair the kernel
    does not take."""
    if (dtype, dh) not in KERNEL_VARIANTS:
        raise ValueError(f"the flash kernels take float32 or bfloat16 with "
                         f"dh in {HEAD_DIMS}, got {dtype} dh={dh}")
    if variant is None:
        return KERNEL_VARIANTS[(dtype, dh)]
    if variant not in ("tc", "simt"):
        raise ValueError(f"unknown flash kernel variant {variant!r}")
    if variant == "tc" and (dtype != torch.bfloat16
                            or dh not in TC_HEAD_DIMS):
        raise ValueError(f"the tensor-core flash kernel takes bfloat16 with "
                         f"dh in {TC_HEAD_DIMS}, got {dtype} dh={dh}")
    return variant


def tc_kv_tiles(q0: int, rows: int, sk: int, causal: bool,
                window: int) -> range:
    """The kv tiles (of :data:`TC_BLOCK_KV` keys) the tensor-core kernel
    loads for query rows ``q0 .. q0+rows-1``: with ``causal`` none past
    the one holding key ``q0+rows-1``, with a window none before the one
    holding key ``q0-window+1``.  Mirrors ``kv_tiles`` in
    ``csrc/flash_attention_tc.cu``."""
    hi = -(-sk // TC_BLOCK_KV)
    if causal:
        hi = min(hi, (q0 + rows - 1) // TC_BLOCK_KV + 1)
    lo = 0
    if window > 0 and q0 - window + 1 > 0:
        lo = (q0 - window + 1) // TC_BLOCK_KV
    return range(lo, max(lo, hi))


def tc_tile_masked(q_lo: int, k0: int, sk: int, causal: bool,
                   window: int) -> bool:
    """Whether the kernel masks the tile of keys ``k0 ..
    k0+TC_BLOCK_KV-1`` for a warpgroup's 64 rows ``q_lo ..``: it holds a
    pair the mask drops or keys past ``sk``.  Mirrors ``tile_masked`` in
    ``csrc/flash_attention_tc.cu``; an unmasked tile is taken whole."""
    return (k0 + TC_BLOCK_KV > sk or (causal and k0 + TC_BLOCK_KV - 1 > q_lo)
            or (window > 0 and q_lo + 63 - k0 >= window))


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


def flash_attention_cuda(q, k, v, causal: bool = True, window: int = 0,
                         variant: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel :func:`kernel_variant` picks (``variant`` forces
    one): contiguous q/k/v of one type (fp32 or bf16) on one CUDA device,
    Sq and Sk multiples of 64, dh in :data:`HEAD_DIMS`."""
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
    variant = kernel_variant(q.dtype, dh, variant)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if variant == "tc" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core flash kernel reads q, k, v "
                         "through TMA: 16-byte aligned storage")
    lib = load_library().lib
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, h, hkv, sq, sk, dh, softmax_scale(dh), int(bool(causal)),
                int(window))
        if variant == "tc":
            code = lib.repro_flash_attention_tc(*args, stream)
        else:
            code = lib.repro_flash_attention(*args, _DTYPES[q.dtype], stream)
    check(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    if variant == "tc":
        LAUNCHES["flash_attention_tc"] += 1
    return out


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Dispatch (see :func:`~repro_torch.kernels.power_step.resolve_impl`):
    the kernel for CUDA tensors, the plain loop for CPU ones."""
    if resolve_impl(impl, q) == "plain":
        return flash_attention_plain(q, k, v, causal, window)
    return flash_attention_cuda(q, k, v, causal, window)
