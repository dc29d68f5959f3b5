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
  head dim of :data:`HEAD_DIMS`, and matches the plain loop bit for bit
  on the card.  Its contract is the plain loop's order: each score one
  fmaf chain over ``d = 0 .. dh-1`` from 0, then times the scale, then
  masked; kv tiles of exactly :data:`BLOCK_KV` keys; ``p = exp(s -
  m_new)``, ``corr = exp(m - m_new)``; the row sum of p as a fixed tree
  (keys ``(j, j+32)``, then pairs 16, 8, 4, 2, 1 apart); ``l = l * corr
  + sum``; p rounded to v's type; pv one fmaf chain over the tile's keys
  in order; ``acc = acc * corr + pv``.  A block takes
  :func:`simt_block_q` query rows: up to dh 80, 128 threads of 8 rows by
  8 keys (lane ``j`` of 8 holds keys ``j, j+8, ..., j+56``); above, 256
  threads of 4 rows by 4 keys (16 lanes).  So the pairs ``(j, j+32)``
  and the next levels of the row-sum tree are a thread's own adds, the
  rest shuffles among a row's lanes, and the softmax stays in registers.
  Q and K sit d-major in shared memory, so up to dh 80 each d costs a
  thread four 16-byte loads for 64 fmaf.  Blocks run the heaviest query tiles first
  (:func:`simt_block_tile`), and skip the kv tiles
  :func:`simt_kv_tiles` leaves out.  Bit-equality keeps it off
  the tensor cores, so its floor is the fp32 pipes': ``2 dh`` fmaf for
  each (query, key) pair of the tiles it computes
  (:func:`simt_tile_pairs`), ~1.3-1.5 ms at zamba2-2.7b's prefill shape
  against the tensor cores' 0.087 ms.

The table :data:`KERNEL_VARIANTS` picks one by ``(dtype, dh)``: the
tensor-core kernel for bf16 at dh 64 and 128 (llama3-8b and the other
dense configs), the SIMT kernel for fp32 (the tensor cores would round
it to TF32), for bf16 at dh 16, 32 and 256, and for bf16 at dh 80.  The
last keeps zamba2-2.7b's prefill bit-equal to its plain path: any flash
that is not bit-equal to the plain loop (the tensor-core kernel, SDPA,
the plain loop itself at another kv tile) puts that model's bf16 logits
~3.2-3.3% normwise from the plain path's, above the 2e-2 its full-width
check holds them to (``PERF.md``, PR 14).  ``variant="tc"`` runs the
tensor-core kernel at dh 80 all the same.  That bar is the forward's
logits': the backward at dh 80 runs on the tensor cores (below).

Any other pair raises.  Every launch counts under
``LAUNCHES["flash_attention"]``; the tensor-core kernel's also under
``LAUNCHES["flash_attention_tc"]``.  A failed build or launch raises: no
variant falls back to another.

Training: under grad mode, with q, k or v requiring a gradient,
:func:`flash_attention` runs through :class:`FlashAttentionFunction`,
which saves q, k, v and the output and whose backward is
:func:`flash_attention_bwd`: a hand-written kernel for CUDA tensors,
:func:`flash_attention_bwd_plain` for CPU ones.  Two kernels compute the
backward, picked by :data:`BWD_KERNEL_VARIANTS`:

* ``"tc"`` (``csrc/flash_attention_bwd_tc.cu``) for bf16 at dh 64, 80
  and 128 (:data:`TC_BWD_HEAD_DIMS`): wgmma and TMA, three passes.  It
  rounds p and ds to bf16 before the products that take them
  (``flash_attention_bwd_plain(..., operands="bf16")`` spells this);
  :func:`tc_bwd_q_tiles`, :func:`tc_bwd_tile_masked` and
  :func:`tc_kv_tiles` mirror its tile rules.  So zamba2-2.7b's and
  hubert's attention (bf16, dh 80) train through it while their forward
  stays on the SIMT kernel: their gradients are held to 2e-2 of the
  plain path's, a bar the bf16 operands keep.
* ``"simt"`` (``csrc/flash_attention_bwd.cu``) for fp32 and bf16 at dh
  16, 32 and 256, in fp32 throughout (``operands="fp32"``, the default);
  ``variant="simt"`` forces it at the other head dims.

Every backward launch counts under ``LAUNCHES["flash_attention_bwd"]``,
the tensor-core one's also under ``LAUNCHES["flash_attention_bwd_tc"]``.
The forward kernels are unchanged: the backward recomputes the softmax
statistics from q and k.
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
#: The tensor-core backward's head dims (bf16 only).
TC_BWD_HEAD_DIMS = (64, 80, 128)
#: The backward kernel each (dtype, dh) launches by default: the
#: tensor-core kernel for bf16 at its head dims, the SIMT kernel for the
#: rest (fp32 stays in fp32).
BWD_KERNEL_VARIANTS = {
    **{(torch.float32, dh): "simt" for dh in HEAD_DIMS},
    **{(torch.bfloat16, dh): "tc" if dh in TC_BWD_HEAD_DIMS else "simt"
       for dh in HEAD_DIMS},
}
#: Score of a masked query/key pair (both JAX forms use it).
MASKED = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches, counted where each launch happens: every forward
#: launch under ``flash_attention``, the tensor-core kernel's also under
#: ``flash_attention_tc``; every backward under ``flash_attention_bwd``,
#: the tensor-core one's also under ``flash_attention_bwd_tc``.
LAUNCHES: Counter = Counter(flash_attention=0, flash_attention_tc=0,
                            flash_attention_bwd=0, flash_attention_bwd_tc=0)


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


def tc_kv_tiles(q0: int, rows: int, sk: int, causal: bool, window: int,
                block: int = TC_BLOCK_KV) -> range:
    """The kv tiles (of ``block`` keys) a tensor-core kernel loads for
    query rows ``q0 .. q0+rows-1``: with ``causal`` none past the one
    holding key ``q0+rows-1``, with a window none before the one holding
    key ``q0-window+1``.  Mirrors ``kv_tiles`` in ``csrc/hopper_tc.cuh``:
    the forward's tiles of :data:`TC_BLOCK_KV` keys, the backward's dq
    pass's of 64."""
    hi = -(-sk // block)
    if causal:
        hi = min(hi, (q0 + rows - 1) // block + 1)
    lo = 0
    if window > 0 and q0 - window + 1 > 0:
        lo = (q0 - window + 1) // block
    return range(lo, max(lo, hi))


def simt_block_q(dh: int) -> int:
    """Query rows a block of the SIMT kernel takes at head dim ``dh``:
    128 up to dh 80 (8 rows a thread), 64 above (4 a thread).  Mirrors
    ``Tile<DH>::kBQ`` in ``csrc/flash_attention.cu``."""
    return 128 if dh <= 80 else 64


def simt_block_tile(block: int, sq: int, dh: int, heads: int,
                    batch: int) -> tuple:
    """``(q0, rows, head, batch index)`` of the SIMT kernel's block
    ``block`` (its 1-D grid has ``ceil(sq / simt_block_q(dh)) * heads *
    batch`` blocks): the heaviest query tiles first, every head and batch
    of one tile before the next lighter tile.  ``rows`` is below the
    block's size only in a half-empty last tile.  Mirrors the block
    decode of ``flash_kernel`` in ``csrc/flash_attention.cu``."""
    bq = simt_block_q(dh)
    hb = heads * batch
    tile = -(-sq // bq) - 1 - block // hb
    q0 = tile * bq
    return q0, min(bq, sq - q0), (block % hb) % heads, (block % hb) // heads


def simt_kv_tiles(q0: int, rows: int, sk: int, causal: bool,
                  window: int) -> list:
    """First keys of the :data:`BLOCK_KV`-key tiles the SIMT kernel runs
    for query rows ``q0 .. q0+rows-1``: it stops at the first tile past
    the last row under ``causal`` and skips tiles the window drops for
    every row.  Mirrors the kv loop of ``flash_kernel``."""
    kept = []
    for k0 in range(0, sk, BLOCK_KV):
        if causal and k0 > q0 + rows - 1:
            break
        if window > 0 and q0 - (k0 + BLOCK_KV - 1) >= window:
            continue
        kept.append(k0)
    return kept


def simt_tile_pairs(sq: int, sk: int, dh: int, heads: int, batch: int,
                    causal: bool, window: int) -> int:
    """(query row, key) pairs whose scores the SIMT kernel computes:
    ``simt_block_q(dh)`` rows (a half-empty tile's zero rows too) by
    :data:`BLOCK_KV` keys for each kv tile each block runs.  Each pair
    takes ``2 dh`` fmaf (``dh`` for its score, ``dh`` for its share of
    pv), the kernel's floor on the fp32 pipes."""
    bq = simt_block_q(dh)
    tiles = sum(len(simt_kv_tiles(q0, min(bq, sq - q0), sk, causal, window))
                for q0 in range(0, sq, bq))
    return tiles * bq * BLOCK_KV * heads * batch


def tc_bwd_q_tiles(k0: int, keys: int, sq: int, causal: bool,
                   window: int) -> range:
    """The 64-row query tiles the tensor-core backward's dk/dv pass
    loads for keys ``k0 .. k0+keys-1``: with ``causal`` none before the
    one holding query ``k0`` (earlier rows keep none of the keys), with a
    window none past the one holding query ``k0+keys-1+window-1`` (the
    last row any of the keys is kept by).  Mirrors ``q_tiles`` in
    ``csrc/flash_attention_bwd_tc.cu``."""
    lo = k0 // BLOCK_Q if causal else 0
    hi = sq // BLOCK_Q
    if window > 0:
        hi = min(hi, (k0 + keys - 1 + window - 1) // BLOCK_Q + 1)
    return range(lo, max(lo, hi))


def tc_bwd_tile_masked(q0: int, k0: int, causal: bool, window: int) -> bool:
    """Whether the backward masks the 64 x 64 tile of query rows ``q0 ..``
    and keys ``k0 ..`` elementwise: it holds a pair the mask drops.
    Mirrors ``pair_tile_masked`` in ``csrc/flash_attention_bwd_tc.cu``; an
    unmasked tile is taken whole."""
    return ((causal and q0 < k0 + 63)
            or (window > 0 and q0 + 63 - k0 >= window))


def bwd_kernel_variant(dtype: torch.dtype, dh: int,
                       variant: Optional[str] = None) -> str:
    """The backward kernel that runs ``(dtype, dh)`` on the card: the
    table's (:data:`BWD_KERNEL_VARIANTS`) for ``variant=None``, else
    ``variant`` itself if that kernel takes the pair.  Raises for a pair
    the kernel does not take."""
    if (dtype, dh) not in BWD_KERNEL_VARIANTS:
        raise ValueError(f"the flash backward kernels take float32 or "
                         f"bfloat16 with dh in {HEAD_DIMS}, got {dtype} "
                         f"dh={dh}")
    if variant is None:
        return BWD_KERNEL_VARIANTS[(dtype, dh)]
    if variant not in ("tc", "simt"):
        raise ValueError(f"unknown flash backward kernel variant "
                         f"{variant!r}")
    if variant == "tc" and (dtype != torch.bfloat16
                            or dh not in TC_BWD_HEAD_DIMS):
        raise ValueError(f"the tensor-core flash backward kernel takes "
                         f"bfloat16 with dh in {TC_BWD_HEAD_DIMS}, got "
                         f"{dtype} dh={dh}")
    return variant


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


def _tile_keep(q_pos: torch.Tensor, k0: int, bk: int, causal: bool,
               window: int) -> torch.Tensor:
    """``(rows, bk)`` keep-mask of the query positions against keys
    ``k0 .. k0+bk-1``."""
    rel = q_pos[:, None] - torch.arange(k0, k0 + bk, device=q_pos.device)
    keep = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        keep &= rel >= 0
    if window > 0:
        keep &= rel < window
    return keep


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
        s = torch.where(_tile_keep(q_pos, k0, bk, causal, window), s, MASKED)
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


def flash_attention_bwd_plain(q, k, v, o, do, causal: bool = True,
                              window: int = 0, block_kv: int = BLOCK_KV,
                              operands: str = "fp32"):
    """The backward kernels' algorithm as a torch loop over kv tiles of
    ``min(block_kv, Sk)`` keys (all query rows at once): ``(dq, dk, dv)``
    in the inputs' types.

    First the statistics: the row max ``m`` and sum ``l`` of the
    forward's online softmax, again from q and k, and ``D = rowsum(do *
    o)`` from the saved output; then for each kv tile ``p = exp(s - m) /
    max(l, 1e-30)``, ``dv = p^T do``, ``dp = do v^T``, ``ds = p * (dp -
    D) * scale``, ``dk = ds^T q`` and ``dq += ds k``, in fp32.  The
    forward's rounding of p to v's type counts as the identity (as
    autodiff of the reference takes it).

    ``operands="fp32"`` (the SIMT kernel's arithmetic) keeps p and ds in
    fp32; ``"bf16"`` (the tensor-core kernel's) rounds p to bf16 before
    ``dv``'s product and ds (formed from the unrounded p) before ``dk``'s
    and ``dq``'s, the sums still in fp32."""
    if operands not in ("fp32", "bf16"):
        raise ValueError(f"operands must be 'fp32' or 'bf16', got "
                         f"{operands!r}")
    bf16 = operands == "bf16"
    b, h, hkv, sq, sk, dh = _check_shapes(q, k, v)
    bk = min(block_kv, sk)
    if sk % bk:
        raise ValueError(f"Sk={sk} must be a multiple of the kv block {bk}")
    g = h // hkv
    scale = softmax_scale(dh)
    qf = q.reshape(b, hkv, g * sq, dh).float()
    dof = do.reshape(b, hkv, g * sq, dh).float()
    dd = (dof * o.reshape(b, hkv, g * sq, dh).float()).sum(-1, keepdim=True)
    q_pos = torch.arange(sq, device=q.device).repeat(g)
    m = torch.full((b, hkv, g * sq, 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    tiles = []
    for k0 in range(0, sk, bk):
        kb = k[:, :, k0:k0 + bk].float()
        keep = _tile_keep(q_pos, k0, bk, causal, window)
        s = torch.where(keep, (qf @ kb.transpose(-1, -2)) * scale, MASKED)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1,
                                                               keepdim=True)
        m = m_new
        tiles.append((k0, kb, keep))
    linv = 1.0 / l.clamp(min=1e-30)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, hkv, sk, dh), device=q.device)
    dv = torch.zeros_like(dk)
    for k0, kb, keep in tiles:
        vb = v[:, :, k0:k0 + bk].float()
        s = torch.where(keep, (qf @ kb.transpose(-1, -2)) * scale, MASKED)
        p = torch.exp(s - m) * linv
        dp = dof @ vb.transpose(-1, -2)
        ds = p * (dp - dd) * scale
        if bf16:
            p, ds = p.bfloat16().float(), ds.bfloat16().float()
        dv[:, :, k0:k0 + bk] = p.transpose(-1, -2) @ dof
        dk[:, :, k0:k0 + bk] = ds.transpose(-1, -2) @ qf
        dq += ds @ kb
    return (dq.view(b, h, sq, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_cuda(q, k, v, o, do, causal: bool = True,
                             window: int = 0,
                             variant: Optional[str] = None):
    """Launch the backward kernel :func:`bwd_kernel_variant` picks
    (``variant`` forces one): contiguous q, k, v, the forward's output o
    and its gradient do, of one type (fp32 or bf16) on one CUDA device,
    Sq and Sk multiples of 64, dh in :data:`HEAD_DIMS`.  Returns ``(dq,
    dk, dv)``."""
    from repro_torch.kernels._build import check, load_library

    b, h, hkv, sq, sk, dh = _check_shapes(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must have q's shape {tuple(q.shape)}, "
                         f"got {tuple(o.shape)} and {tuple(do.shape)}")
    for t in (q, k, v, o, do):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"the CUDA kernel needs q, k, v, o, do on one "
                             f"CUDA device, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"the flash backward kernel takes float32 or "
                             f"bfloat16 tensors of one type, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the flash backward kernel takes contiguous "
                             "tensors")
    if sq % BLOCK_Q or sk % BLOCK_KV or sq == 0 or sk == 0:
        raise ValueError(f"Sq={sq} and Sk={sk} must be positive multiples "
                         f"of the kernel's tiles ({BLOCK_Q}, {BLOCK_KV})")
    variant = bwd_kernel_variant(q.dtype, dh, variant)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if variant == "tc" and any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("the tensor-core flash backward reads q, k, v, o "
                         "and do through TMA and 16-byte loads: 16-byte "
                         "aligned storage")
    lib = load_library().lib
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws = torch.empty((3, b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                ws.data_ptr(), b, h, hkv, sq, sk, dh, softmax_scale(dh),
                int(bool(causal)), int(window))
        if variant == "tc":
            code = lib.repro_flash_attention_bwd_tc(*args, stream)
        else:
            code = lib.repro_flash_attention_bwd(*args, _DTYPES[q.dtype],
                                                 stream)
    check(code, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    if variant == "tc":
        LAUNCHES["flash_attention_bwd_tc"] += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, do, causal: bool = True, window: int = 0,
                        impl: Optional[str] = None):
    """Dispatch the backward: the kernel :data:`BWD_KERNEL_VARIANTS`
    routes to for CUDA tensors, the plain loop for CPU ones."""
    if resolve_impl(impl, q) == "plain":
        return flash_attention_bwd_plain(q, k, v, o, do, causal, window)
    return flash_attention_bwd_cuda(q, k, v, o, do.contiguous(), causal,
                                    window)


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention` with its backward
    (:func:`flash_attention_bwd`); ``impl`` is resolved once and serves
    both directions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, impl: str):
        if impl == "plain":
            out = flash_attention_plain(q, k, v, causal, window)
        else:
            out = flash_attention_cuda(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window, ctx.impl = causal, window, impl
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, ctx.causal,
                                         ctx.window, ctx.impl)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Dispatch (see :func:`~repro_torch.kernels.power_step.resolve_impl`):
    the kernel for CUDA tensors, the plain loop for CPU ones; under grad
    mode, with an input that requires a gradient, through
    :class:`FlashAttentionFunction`."""
    which = resolve_impl(impl, q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, window, which)
    if which == "plain":
        return flash_attention_plain(q, k, v, causal, window)
    return flash_attention_cuda(q, k, v, causal, window)
