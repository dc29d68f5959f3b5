"""The decoder LMs of the port, transcribed from the reference's
``models/model.py``: the dense family (llama3-8b, qwen1.5-4b, ...) and
the hybrid family (zamba2-2.7b).

The reference scans stacked blocks over the layers; the port keeps them
as ``nn.ModuleList``s (the converter unstacks the reference's ``(L, ...)``
and ``(n_super, per_super, ...)`` leaves) and loops over them.  Its
``constrain`` sharding hints are no-ops on one device and are dropped.

* dense: ``L`` pre-norm transformer blocks.  Every RMSNorm is one launch
  of the ``rmsnorm`` kernel on the card (``2 L + 1`` per ``forward`` and
  per ``decode_step``); ``forward`` at ``S >= 2048`` adds one
  ``flash_attention`` launch per layer.
* hybrid: ``n_super`` super-blocks of ``attn_every`` Mamba2 layers
  (``ln`` + the SSM mixer), each followed by the one *shared* attention
  + SwiGLU block (Zamba2's design: one set of weights, applied
  ``n_super`` times, each application with its own KV cache slot).
  ``2 L + 2 n_super + 1`` rmsnorm launches per ``forward`` and per
  ``decode_step`` (the mixer's gated norm is one of each layer's two);
  ``forward`` adds one ``ssm_scan`` launch per Mamba2 layer and, at
  ``S >= 2048``, one ``flash_attention`` launch per super-block.

``impl`` (``None`` | ``"plain"`` | ``"cuda"``) is handed to every
kernel's dispatch.  The other families (moe, vlm, ssm, encoder) raise
``NotImplementedError``: they wait in ROADMAP.md's queue of modules to
port.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (Attention, attention,
                                          attention_decode, attn_init)
from repro_torch.models.layers import (MLP, dense_init, dtype_of,
                                       embed_init, frozen, mlp_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.ssm import SSM, ssm_decode, ssm_forward, ssm_init

#: families the port runs
PORTED_FAMILIES = ("dense", "hybrid")


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP.md, modules to port); the port runs the "
            f"{' and '.join(PORTED_FAMILIES)} families")


def superblock_shape(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_super, layers_per_super) of the hybrid stack; (L, 1) otherwise."""
    if cfg.family == "hybrid":
        k = cfg.attn_every or cfg.n_layers
        if cfg.n_layers % k:
            raise ValueError(f"n_layers={cfg.n_layers} must divide by "
                             f"attn_every={k}")
        return cfg.n_layers // k, k
    return cfg.n_layers, 1


class Block(nn.Module):
    """Pre-norm transformer block: ``ln1``, ``attn``, ``ln2``, ``ffn`` (also
    the hybrid family's shared attention + SwiGLU block)."""

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


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 layer: ``ln`` and the ``ssm`` mixer."""

    def __init__(self, ln: torch.Tensor, ssm: SSM):
        super().__init__()
        self.ln, self.ssm = frozen(ln), ssm


class HybridLM(nn.Module):
    """Embedding, ``mamba`` (``n_super`` lists of ``attn_every``
    :class:`MambaBlock`), the one ``shared`` :class:`Block`, final norm
    and (untied) LM head."""

    def __init__(self, embed: torch.Tensor, mamba, shared: Block,
                 final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = frozen(embed)
        self.mamba = nn.ModuleList(nn.ModuleList(sup) for sup in mamba)
        self.shared = shared
        self.final_norm = frozen(final_norm)
        self.lm_head = None if lm_head is None else frozen(lm_head)


LM = Union[DenseLM, HybridLM]


# ------------------------------------------------------------------- init
def _attn_block_init(cfg: ModelConfig, gen: torch.Generator, mlp: str,
                     qkv_bias: bool) -> Block:
    dt = dtype_of(cfg.param_dtype)
    return Block(rmsnorm_init(cfg.d_model, dt, gen.device),
                 rmsnorm_init(cfg.d_model, dt, gen.device),
                 attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.dh, dt, qkv_bias),
                 mlp_init(mlp, gen, cfg.d_model, cfg.d_ff, dt))


def _mamba_block_init(cfg: ModelConfig, gen: torch.Generator) -> MambaBlock:
    dt = dtype_of(cfg.param_dtype)
    return MambaBlock(rmsnorm_init(cfg.d_model, dt, gen.device),
                      ssm_init(gen, cfg.d_model, expand=cfg.ssm.expand,
                               state_dim=cfg.ssm.state_dim,
                               head_dim=cfg.ssm.head_dim,
                               conv_width=cfg.ssm.conv_width, dtype=dt))


def init_params(cfg: ModelConfig, gen: torch.Generator) -> LM:
    """Random weights on ``gen.device`` from ``gen``, in the reference's
    draw order (embedding; each layer, or each Mamba2 layer and then the
    shared block; head)."""
    require_ported(cfg)
    dt = dtype_of(cfg.param_dtype)
    embed = embed_init(gen, cfg.vocab, cfg.d_model, dt)
    if cfg.family == "hybrid":
        n_super, per_super = superblock_shape(cfg)
        body = ([[_mamba_block_init(cfg, gen) for _ in range(per_super)]
                 for _ in range(n_super)],
                _attn_block_init(cfg, gen, "swiglu", False))
    else:
        body = ([_attn_block_init(cfg, gen, cfg.mlp, cfg.qkv_bias)
                 for _ in range(cfg.n_layers)],)
    head = None
    if not cfg.tie_embeddings:
        head = dense_init(gen, cfg.d_model, cfg.vocab, dt)
    lm = HybridLM if cfg.family == "hybrid" else DenseLM
    return lm(embed, *body, rmsnorm_init(cfg.d_model, dt, gen.device), head)


# ---------------------------------------------------------------- forward
def _attn_kwargs(cfg: ModelConfig) -> Dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.dh, rope_theta=cfg.rope_theta, use_rope=True)


def _ssm_kwargs(cfg: ModelConfig) -> Dict:
    return dict(expand=cfg.ssm.expand, state_dim=cfg.ssm.state_dim,
                head_dim=cfg.ssm.head_dim)


def _logits(cfg: ModelConfig, model: LM, x: torch.Tensor,
            impl: Optional[str]) -> torch.Tensor:
    x = rmsnorm(x, model.final_norm, cfg.norm_eps, impl)
    head = model.embed.T if model.lm_head is None else model.lm_head
    return x @ head.to(x.dtype)


def _attn_block(cfg: ModelConfig, blk: Block, x: torch.Tensor,
                positions: torch.Tensor, causal: bool,
                impl: Optional[str]) -> torch.Tensor:
    x = x + attention(blk.attn, rmsnorm(x, blk.ln1, cfg.norm_eps, impl),
                      positions, causal=causal, window=cfg.attn_window,
                      impl=impl, **_attn_kwargs(cfg))
    return x + blk.ffn(rmsnorm(x, blk.ln2, cfg.norm_eps, impl))


def forward(cfg: ModelConfig, model: LM,
            batch: Dict[str, torch.Tensor], impl: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: tokens ``(B, S)`` -> (logits ``(B, S, V)``,
    the MoE auxiliary loss, 0 for these families)."""
    require_ported(cfg)
    cdt = dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = model.embed.to(cdt)[tokens]
    positions = torch.arange(s, device=x.device).expand(b, s)
    if cfg.family == "hybrid":
        for sup in model.mamba:
            for blk in sup:
                x = x + ssm_forward(blk.ssm,
                                    rmsnorm(x, blk.ln, cfg.norm_eps, impl),
                                    chunk=cfg.ssm.chunk, impl=impl,
                                    **_ssm_kwargs(cfg))
            x = _attn_block(cfg, model.shared, x, positions, True, impl)
    else:
        for blk in model.blocks:
            x = _attn_block(cfg, blk, x, positions, cfg.causal, impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(cfg, model, x, impl), aux


# ------------------------------------------------------------------ decode
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device) -> Dict[str, torch.Tensor]:
    """Zero decode cache in the reference's layout.  Dense: ``{"k", "v"}``,
    each ``(L, B, max_seq, Hkv, dh)``.  Hybrid: ``conv (n_super,
    per_super, B, W-1, Dc)`` in the compute type, ``ssm (n_super,
    per_super, B, H, P, N)`` in fp32, and ``k``/``v (n_super, B, max_seq,
    Hkv, dh)``, one slot per application of the shared block."""
    require_ported(cfg)
    cdt = dtype_of(cfg.dtype)
    zeros = lambda shape, dt=cdt: torch.zeros(  # noqa: E731
        shape, dtype=dt, device=device)
    n_super, per_super = superblock_shape(cfg)
    kv = (n_super, batch, max_seq, cfg.n_kv_heads, cfg.dh)
    if cfg.family != "hybrid":
        return {"k": zeros(kv), "v": zeros(kv)}
    d_inner = cfg.ssm.expand * cfg.d_model
    dc = d_inner + 2 * cfg.ssm.state_dim
    h = d_inner // cfg.ssm.head_dim
    return {"conv": zeros((n_super, per_super, batch,
                           cfg.ssm.conv_width - 1, dc)),
            "ssm": zeros((n_super, per_super, batch, h, cfg.ssm.head_dim,
                          cfg.ssm.state_dim), torch.float32),
            "k": zeros(kv), "v": zeros(kv)}


def _attn_decode_block(cfg: ModelConfig, blk: Block, x: torch.Tensor,
                       pos: int, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       impl: Optional[str]) -> torch.Tensor:
    a, _, _ = attention_decode(
        blk.attn, rmsnorm(x, blk.ln1, cfg.norm_eps, impl), pos, k_cache,
        v_cache, window=cfg.attn_window, **_attn_kwargs(cfg))
    x = x + a
    return x + blk.ffn(rmsnorm(x, blk.ln2, cfg.norm_eps, impl))


def decode_step(cfg: ModelConfig, model: LM,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: int, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: tokens ``(B, 1)`` at position ``pos`` -> (logits
    ``(B, 1, V)``, the cache).  The cache is updated in place."""
    require_ported(cfg)
    x = model.embed.to(dtype_of(cfg.dtype))[tokens]
    if cfg.family == "hybrid":
        for i, sup in enumerate(model.mamba):
            for j, blk in enumerate(sup):
                out, conv, state = ssm_decode(
                    blk.ssm, rmsnorm(x, blk.ln, cfg.norm_eps, impl),
                    cache["conv"][i, j], cache["ssm"][i, j], impl=impl,
                    **_ssm_kwargs(cfg))
                cache["conv"][i, j] = conv
                cache["ssm"][i, j] = state
                x = x + out
            x = _attn_decode_block(cfg, model.shared, x, pos, cache["k"][i],
                                   cache["v"][i], impl)
    else:
        for i, blk in enumerate(model.blocks):
            x = _attn_decode_block(cfg, blk, x, pos, cache["k"][i],
                                   cache["v"][i], impl)
    return _logits(cfg, model, x, impl), cache
