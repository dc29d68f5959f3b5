"""Grouped-query attention: full-sequence (prefill) and cached-decode paths,
transcribed from the reference's ``models/attention.py``.

Below :data:`BLOCKED_ATTN_THRESHOLD` and for decode against the cache
the reference computes attention as plain einsums; so does the port.  At
and above it the reference runs ``blocked_attend``, whose TPU-tiled form
is the Pallas flash kernel; the port's :func:`blocked_attend` is one
launch of the hand-written ``flash_attention`` kernel on the card (its
plain loop on the CPU).

Under a sharding policy with a DTensor KV cache sharded on S over the
model axis (the dry run), decode runs :func:`decode_attend_seqsharded`,
the reference's flash-decoding ``shard_map`` written with DTensor's
``local_map``; the ``constrain`` hints stand where the reference's do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, frozen
from repro_torch.models.sharding import constrain, get_policy

#: sequences at or above this length use the blocked (flash) path
BLOCKED_ATTN_THRESHOLD = 2048
#: ``blocked_attend``'s query and kv block: a longer sequence must be a
#: multiple of it, as the reference asserts
BLOCKED_ATTN_BLOCK = 1024
#: masked score (``-1e30``, as both reference forms)
MASKED = -1e30


class Attention(nn.Module):
    """Projection weights ``wq (d, H*dh)``, ``wk``/``wv (d, Hkv*dh)``,
    ``wo (H*dh, d)`` and, with QKV bias, ``bq``/``bk``/``bv``."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(frozen, (wq, wk, wv, wo))
        biased = bq is not None
        self.bq = frozen(bq) if biased else None
        self.bk = frozen(bk) if biased else None
        self.bv = frozen(bv) if biased else None


def attn_init(gen: torch.Generator, d_model: int, n_heads: int,
              n_kv_heads: int, head_dim: int, dtype,
              qkv_bias: bool = False) -> Attention:
    wq = dense_init(gen, d_model, n_heads * head_dim, dtype)
    wk = dense_init(gen, d_model, n_kv_heads * head_dim, dtype)
    wv = dense_init(gen, d_model, n_kv_heads * head_dim, dtype)
    wo = dense_init(gen, n_heads * head_dim, d_model, dtype)
    if not qkv_bias:
        return Attention(wq, wk, wv, wo)
    zeros = lambda n: torch.zeros((n,), dtype=dtype,  # noqa: E731
                                  device=gen.device)
    return Attention(wq, wk, wv, wo, zeros(n_heads * head_dim),
                     zeros(n_kv_heads * head_dim), zeros(n_kv_heads * head_dim))


def _project_qkv(p: Attention, x: torch.Tensor, n_heads: int,
                 n_kv_heads: int, head_dim: int):
    b, s, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.view(b, s, n_heads, head_dim),
            k.view(b, s, n_kv_heads, head_dim),
            v.view(b, s, n_kv_heads, head_dim))


def gqa_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                    window: int = 0) -> torch.Tensor:
    """``(..., Sq, Sk)`` boolean keep-mask from positions."""
    rel = q_pos[..., :, None] - k_pos[..., None, :]
    keep = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        keep &= rel >= 0
    if window > 0:
        keep &= rel < window
    return keep


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               keep: Optional[torch.Tensor],
               decode_layout: bool = False) -> torch.Tensor:
    """q ``(B, Sq, H, dh)``; k/v ``(B, Sk, Hkv, dh)``; keep ``(B, Sq, Sk)``.

    Scores and softmax in fp32 (the reference's fp32-accumulated einsum
    of the model-type inputs), weights rounded to v's type for the PV
    product; returns ``(B, Sq, H, dh)``.  Materialises the scores: for
    decode and short sequences only.  ``decode_layout`` pins the scores
    and the output to batch-only sharding, as the reference's does."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if decode_layout:
        scores = constrain(scores, "dp", None, None, None, None)
    scores = scores / float(np.sqrt(np.float32(dh)))
    if keep is not None:
        scores = torch.where(keep[:, None, None], scores, MASKED)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    if decode_layout:
        out = constrain(out, "dp", None, None, None, None)
    return out.reshape(b, sq, h, dh)


def blocked_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, window: int = 0,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Flash attention over the sequence: q ``(B, S, H, dh)``, k/v
    ``(B, S, Hkv, dh)``, positions ``0..S-1`` (those ``forward`` gives).
    The reference asserts ``S`` divides its 1024 blocks; the port raises
    ``ValueError`` on the same inputs and does not pad."""
    s = q.shape[1]
    block = min(BLOCKED_ATTN_BLOCK, s)
    if s % block or k.shape[1] != s:
        raise ValueError(f"blocked attention needs S a multiple of "
                         f"{block} and as many keys as queries, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               impl=impl)


def attention(p: Attention, x: torch.Tensor, positions: torch.Tensor, *,
              n_heads: int, n_kv_heads: int, head_dim: int,
              causal: bool = True, window: int = 0,
              rope_theta: float = 500000.0, use_rope: bool = True,
              impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence attention (prefill); positions ``(B, S)``."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if s >= BLOCKED_ATTN_THRESHOLD:
        # the reference gathers K/V's sequence once a layer and keeps the
        # queries sequence-sharded
        k = constrain(k, "dp", None, None, None)
        v = constrain(v, "dp", None, None, None)
        q = constrain(q, "dp", "mdl", None, None)
        out = blocked_attend(q, k, v, causal, window, impl=impl)
    else:
        keep = None
        if causal or window:
            keep = gqa_scores_mask(positions, positions, causal, window)
        out = gqa_attend(q, k, v, keep)
    return out.reshape(b, s, n_heads * head_dim) @ p.wo


def attention_decode(p: Attention, x: torch.Tensor, pos: int,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     window: int = 0, rope_theta: float = 500000.0,
                     use_rope: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache (aligned batch): x ``(B, 1,
    d)``, ``pos`` the step's position, caches ``(B, S_max, Hkv, dh)``.

    The reference returns an updated copy of the (donated) cache; the
    port writes the new key and value into slot ``pos`` of the caches in
    place (slice assignment) and returns them."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if use_rope:
        posv = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
        q = apply_rope(q, posv, rope_theta)
        k = apply_rope(k, posv, rope_theta)
    if _seqsharded_available(k_cache):
        out = decode_attend_seqsharded(q, k_cache, v_cache, k, v, pos,
                                       window=window)
        return out.reshape(b, 1, n_heads * head_dim) @ p.wo, k_cache, v_cache
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    kpos = torch.arange(k_cache.shape[1], device=x.device)
    keep = kpos <= pos
    if window > 0:
        keep &= kpos > pos - window
    keep = keep[None, None, :].expand(b, 1, k_cache.shape[1])
    out = gqa_attend(q, k_cache, v_cache, keep, decode_layout=True)
    return out.reshape(b, 1, n_heads * head_dim) @ p.wo, k_cache, v_cache


def _seqsharded_available(k_cache: torch.Tensor) -> bool:
    """A policy is set, and the cache is a DTensor whose sequence the
    model axis splits (the cache rule splits it only where it divides)."""
    policy = get_policy()
    if policy is None:
        return False
    from torch.distributed.tensor import DTensor

    from torch.distributed.tensor import Shard

    mesh, _dp, mdl = policy
    if not (isinstance(k_cache, DTensor) and mdl in mesh.mesh_dim_names):
        return False
    return k_cache.placements[mesh.mesh_dim_names.index(mdl)] == Shard(1)


def decode_attend_seqsharded(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, new_k: torch.Tensor,
                             new_v: torch.Tensor, pos: int,
                             window: int = 0) -> torch.Tensor:
    """Flash-decoding with the KV cache sharded along S over the model
    axis (the reference's ``shard_map`` form, with ``local_map``): the
    cache write lands on the owning shard only, in place, and the softmax
    combines each shard's partials with functional all-reduces over the
    model axis (max, then sum), as the reference's ``pmax`` / ``psum``.

    q ``(B, 1, H, dh)``; caches ``(B, S, Hkv, dh)`` DTensors; new_k /
    new_v ``(B, 1, Hkv, dh)``; ``pos`` the step's position.  Needs a
    policy (:func:`~repro_torch.models.sharding.set_policy`); returns out
    ``(B, 1, H, dh)`` in q's type, batch-sharded as the cache is."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, dp, mdl = get_policy()
    names = mesh.mesh_dim_names
    b, s, hkv, dh = k_cache.shape
    h = q.shape[2]
    g = h // hkv
    mdl_dim = names.index(mdl)
    n_seq = mesh.size(mdl_dim)
    s_loc = s // n_seq
    scale = float(1.0 / np.sqrt(np.float32(dh)))
    # the batch keeps the cache's own split: its placements on every
    # mesh dim but the model axis
    batch_pl = tuple(Replicate() if i == mdl_dim else pl
                     for i, pl in enumerate(k_cache.placements))
    seq_pl = tuple(Shard(1) if i == mdl_dim else pl
                   for i, pl in enumerate(batch_pl))
    group = (mesh, mdl_dim)

    def local_fn(q_l, kc, vc, nk, nv):
        start = mesh.get_local_rank(mdl_dim) * s_loc
        off = pos - start
        if 0 <= off < s_loc:
            kc[:, off] = nk[:, 0].to(kc.dtype)
            vc[:, off] = nv[:, 0].to(vc.dtype)
        bl = kc.shape[0]
        qf = q_l.reshape(bl, 1, hkv, g, dh).float()
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc.float()) * scale
        kpos = start + torch.arange(s_loc, device=kc.device)
        keep = kpos <= pos
        if window > 0:
            keep &= kpos > pos - window
        sc = torch.where(keep, sc, MASKED)
        m = funcol.all_reduce(sc.amax(dim=-1), "max", group)
        p = torch.exp(sc - m[..., None])
        l_sum = funcol.all_reduce(p.sum(dim=-1), "sum", group)
        acc = funcol.all_reduce(torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vc.dtype).float(), vc.float()),
            "sum", group)
        out = acc / torch.clamp(l_sum, min=1e-30)[..., None]
        out = out.permute(0, 3, 1, 2, 4).reshape(bl, 1, h, dh)
        return out.to(q_l.dtype)

    fn = local_map(local_fn, out_placements=list(batch_pl),
                   in_placements=(batch_pl, seq_pl, seq_pl, batch_pl,
                                  batch_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k_cache, v_cache, new_k, new_v)
