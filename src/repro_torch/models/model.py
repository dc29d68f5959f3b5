"""The dense decoder LM of the port (llama3-8b, qwen1.5-4b, ...),
transcribed from the reference's ``models/model.py``.

The reference scans one stacked block over the layers; the port keeps the
blocks as an ``nn.ModuleList`` (the converter unstacks the reference's
``(L, ...)`` leaves) and loops over it.  Its ``constrain`` sharding hints
are no-ops on one device and are dropped.  Every RMSNorm is one launch of
the ``rmsnorm`` kernel on the card (``2 L + 1`` per ``forward`` and per
``decode_step``); ``forward`` at ``S >= 2048`` adds one ``flash_attention``
launch per layer.  ``impl`` (``None`` | ``"plain"`` | ``"cuda"``) is
handed to both kernels' dispatch.

Only the dense family is ported.  The others (moe, vlm, hybrid, ssm,
encoder) raise ``NotImplementedError``: they wait in ROADMAP.md's queue
of modules to port (the hybrid family next, with the ``ssm_scan`` kernel).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (Attention, attention,
                                          attention_decode, attn_init)
from repro_torch.models.layers import (MLP, dense_init, dtype_of,
                                       embed_init, frozen, mlp_init, rmsnorm,
                                       rmsnorm_init)


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP.md, modules to port); the port runs the dense family")


class Block(nn.Module):
    """Pre-norm transformer block: ``ln1``, ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, ln1: torch.Tensor, ln2: torch.Tensor,
                 attn: Attention, ffn: MLP):
        super().__init__()
        self.ln1, self.ln2 = frozen(ln1), frozen(ln2)
        self.attn, self.ffn = attn, ffn


class DenseLM(nn.Module):
    """Embedding, ``blocks``, final norm and (untied) LM head."""

    def __init__(self, embed: torch.Tensor, blocks, final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = frozen(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = frozen(final_norm)
        self.lm_head = None if lm_head is None else frozen(lm_head)


# ------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, gen: torch.Generator) -> DenseLM:
    """Random weights on ``gen.device`` from ``gen``, in the reference's
    draw order (embedding, each layer's attention and MLP, head)."""
    require_dense(cfg)
    dt = dtype_of(cfg.param_dtype)
    dev = gen.device
    embed = embed_init(gen, cfg.vocab, cfg.d_model, dt)
    blocks = [Block(rmsnorm_init(cfg.d_model, dt, dev),
                    rmsnorm_init(cfg.d_model, dt, dev),
                    attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.dh, dt, cfg.qkv_bias),
                    mlp_init(cfg.mlp, gen, cfg.d_model, cfg.d_ff, dt))
              for _ in range(cfg.n_layers)]
    head = None
    if not cfg.tie_embeddings:
        head = dense_init(gen, cfg.d_model, cfg.vocab, dt)
    return DenseLM(embed, blocks, rmsnorm_init(cfg.d_model, dt, dev), head)


# ---------------------------------------------------------------- forward
def _attn_kwargs(cfg: ModelConfig) -> Dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.dh, rope_theta=cfg.rope_theta, use_rope=True)


def _logits(cfg: ModelConfig, model: DenseLM, x: torch.Tensor,
            impl: Optional[str]) -> torch.Tensor:
    x = rmsnorm(x, model.final_norm, cfg.norm_eps, impl)
    head = model.embed.T if model.lm_head is None else model.lm_head
    return x @ head.to(x.dtype)


def forward(cfg: ModelConfig, model: DenseLM,
            batch: Dict[str, torch.Tensor], impl: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: tokens ``(B, S)`` -> (logits ``(B, S, V)``,
    the MoE auxiliary loss, 0 for the dense family)."""
    require_dense(cfg)
    cdt = dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = model.embed.to(cdt)[tokens]
    positions = torch.arange(s, device=x.device).expand(b, s)
    for blk in model.blocks:
        x = x + attention(blk.attn, rmsnorm(x, blk.ln1, cfg.norm_eps, impl),
                          positions, causal=cfg.causal,
                          window=cfg.attn_window, impl=impl,
                          **_attn_kwargs(cfg))
        x = x + blk.ffn(rmsnorm(x, blk.ln2, cfg.norm_eps, impl))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(cfg, model, x, impl), aux


# ------------------------------------------------------------------ decode
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device) -> Dict[str, torch.Tensor]:
    """Zero KV cache ``{"k", "v"}``, each ``(L, B, max_seq, Hkv, dh)``."""
    require_dense(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.dh)
    cdt = dtype_of(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def decode_step(cfg: ModelConfig, model: DenseLM,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: int, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: tokens ``(B, 1)`` at position ``pos`` -> (logits
    ``(B, 1, V)``, the cache).  The cache is updated in place."""
    require_dense(cfg)
    x = model.embed.to(dtype_of(cfg.dtype))[tokens]
    for i, blk in enumerate(model.blocks):
        a, _, _ = attention_decode(
            blk.attn, rmsnorm(x, blk.ln1, cfg.norm_eps, impl), pos,
            cache["k"][i], cache["v"][i], window=cfg.attn_window,
            **_attn_kwargs(cfg))
        x = x + a
        x = x + blk.ffn(rmsnorm(x, blk.ln2, cfg.norm_eps, impl))
    return _logits(cfg, model, x, impl), cache
