"""The LMs of the port, transcribed from the reference's
``models/model.py``: all six families of the repo's configs.

The reference scans stacked blocks over the layers; the port keeps them
as ``nn.ModuleList``s (the converter unstacks the reference's ``(L, ...)``
and ``(n_super, per_super, ...)`` leaves) and loops over them.  Its
``constrain`` sharding hints stand where the reference's do
(:mod:`repro_torch.models.sharding`): the identity unless a policy is set
and the activation is a DTensor (the dry run).

* dense, vlm (chameleon-34b: early fusion, image tokens in the text
  vocabulary, so the dense code unchanged), moe, encoder: ``L`` pre-norm
  transformer blocks.  The moe family's blocks run the routed
  :func:`~repro_torch.models.moe.moe_ffn` in place of the MLP, and
  ``forward`` returns the sum of their auxiliary losses.  The encoder
  (hubert-xlarge) projects precomputed frames ``(B, S, d)`` with
  ``frame_proj`` in place of the embedding, attends bidirectionally
  without RoPE, and has no decode step.  Every RMSNorm is one launch of
  the ``rmsnorm`` kernel on the card (``2 L + 1`` per ``forward`` and per
  ``decode_step``); ``forward`` at ``S >= 2048`` adds one
  ``flash_attention`` launch per layer.
* hybrid (zamba2-2.7b): ``n_super`` super-blocks of ``attn_every`` Mamba2
  layers (``ln`` + the SSM mixer), each followed by the one *shared*
  attention + SwiGLU block (one set of weights, applied ``n_super``
  times, each application with its own KV cache slot).  ``2 L + 2 n_super
  + 1`` rmsnorm launches per ``forward`` and per ``decode_step`` (the
  mixer's gated norm is one of each layer's two); ``forward`` adds one
  ``ssm_scan`` launch per Mamba2 layer and, at ``S >= 2048``, one
  ``flash_attention`` launch per super-block.
* ssm (xlstm-350m): ``n_super`` super-blocks of ``slstm_every - 1`` mLSTM
  layers and one sLSTM layer, each pre-norm (``ln``) with a residual.
  ``2 L + 1`` rmsnorm launches per ``forward`` and per ``decode_step``
  (each block's ``ln`` and its cell's output norm, and the final norm);
  no flash attention.

``impl`` (``None`` | ``"plain"`` | ``"cuda"``) is handed to every
kernel's dispatch.  ``decode_step`` writes the cache in place.

Training: :func:`loss_fn` is ``forward`` plus the fp32 cross-entropy (and
the MoE auxiliary loss).  The weights are created without gradients (for
serving); the trainer turns them on with ``model.requires_grad_(True)``.
Under grad mode the norms, flash attention and the selective scan run
through their ``autograd.Function``s, whose backwards are kernels too.  With
``cfg.remat`` each block (dense, vlm, moe, encoder), each Mamba2 layer and
each super-block (hybrid), each mLSTM layer and each super-block (ssm) is
recomputed in the backward (``torch.utils.checkpoint``, non-reentrant), as
the reference's ``jax.checkpoint`` bodies are.  One training step of a
dense model at ``S >= 2048`` with ``remat`` launches ``2 L + 1`` rmsnorm
and ``L`` flash_attention in the forward, ``2 L`` rmsnorm and ``L``
flash_attention again in the recompute (every block's norms and attention
lie before its last saved activation), and ``2 L + 1`` rmsnorm_bwd and
``L`` flash_attention_bwd: ``4 L + 1``, ``2 L``, ``2 L + 1`` and ``L`` in
all.  The hybrid family (``L`` Mamba2 layers in ``n = L / attn_every``
super-blocks) nests its checkpoints: a Mamba2 layer runs three times (the
forward, its super-block's recompute, and its own recompute inside that
one's backward), the shared attention block twice.  One step launches
``3 L`` ssm_scan, ``6 L + 4 n + 1`` rmsnorm and ``2 n`` flash_attention,
and one backward kernel a forward call: ``L`` ssm_scan_bwd, ``2 L + 2 n +
1`` rmsnorm_bwd and ``n`` flash_attention_bwd.  The ssm family (``n``
sLSTM layers closing the super-blocks, ``L - n`` mLSTM layers under their
own checkpoints inside) launches ``6 (L - n) + 4 n + 1`` rmsnorm and ``2 L
+ 1`` rmsnorm_bwd.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (Attention, attention,
                                          attention_decode, attn_init)
from repro_torch.models.layers import (MLP, dense_init, dtype_of,
                                       embed_init, frozen, mlp_init, rmsnorm,
                                       rmsnorm_init, softmax_xent)
from repro_torch.models.moe import MoE, moe_ffn, moe_init
from repro_torch.models.sharding import constrain
from repro_torch.models.ssm import SSM, ssm_decode, ssm_forward, ssm_init
from repro_torch.models.xlstm import (MLSTM, SLSTM, mlstm_decode,
                                      mlstm_forward, mlstm_init,
                                      slstm_decode, slstm_forward,
                                      slstm_init)

#: the model families, as the reference's ``init_params`` knows them
FAMILIES = ("dense", "moe", "encoder", "vlm", "hybrid", "ssm")


def require_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family the reference does not know."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.arch_id}: unknown family {cfg.family!r} "
                         f"(known: {', '.join(FAMILIES)})")


def superblock_shape(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_super, layers_per_super): hybrid ``attn_every`` Mamba2 layers; ssm
    ``slstm_every - 1`` mLSTM layers (and one sLSTM); (L, 1) otherwise."""
    if cfg.family not in ("hybrid", "ssm"):
        return cfg.n_layers, 1
    k = (cfg.attn_every or cfg.n_layers) if cfg.family == "hybrid" \
        else cfg.xlstm.slstm_every
    name = "attn_every" if cfg.family == "hybrid" else "slstm_every"
    if cfg.n_layers % k:
        raise ValueError(f"n_layers={cfg.n_layers} must divide by "
                         f"{name}={k}")
    return cfg.n_layers // k, k if cfg.family == "hybrid" else k - 1


class Block(nn.Module):
    """Pre-norm transformer block: ``ln1``, ``attn``, ``ln2`` and either the
    ``ffn`` MLP or the routed ``moe`` FFN (also the hybrid family's shared
    attention + SwiGLU block)."""

    def __init__(self, ln1: torch.Tensor, ln2: torch.Tensor,
                 attn: Attention, ffn: Optional[MLP] = None,
                 moe: Optional[MoE] = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("a block has an ffn or a moe, not both")
        self.ln1, self.ln2 = frozen(ln1), frozen(ln2)
        self.attn, self.ffn, self.moe = attn, ffn, moe


class DenseLM(nn.Module):
    """Embedding, ``blocks``, final norm and (untied) LM head: the dense,
    vlm and moe families."""

    def __init__(self, embed: torch.Tensor, blocks, final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = frozen(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = frozen(final_norm)
        self.lm_head = None if lm_head is None else frozen(lm_head)


class EncoderLM(nn.Module):
    """The encoder family: ``frame_proj (d, d)`` over precomputed frames in
    place of the embedding, ``blocks``, final norm and head."""

    def __init__(self, frame_proj: torch.Tensor, blocks,
                 final_norm: torch.Tensor, lm_head: torch.Tensor):
        super().__init__()
        self.frame_proj = frozen(frame_proj)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = frozen(final_norm)
        self.lm_head = frozen(lm_head)


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


class CellBlock(nn.Module):
    """Pre-norm xLSTM layer: ``ln`` and the mLSTM or sLSTM ``cell``."""

    def __init__(self, ln: torch.Tensor, cell: Union[MLSTM, SLSTM]):
        super().__init__()
        self.ln, self.cell = frozen(ln), cell


class XLSTMLM(nn.Module):
    """Embedding, ``mlstm`` (``n_super`` lists of ``slstm_every - 1``
    mLSTM :class:`CellBlock`), ``slstm`` (one sLSTM :class:`CellBlock` a
    super-block), final norm and (untied) LM head."""

    def __init__(self, embed: torch.Tensor, mlstm, slstm,
                 final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = frozen(embed)
        self.mlstm = nn.ModuleList(nn.ModuleList(sup) for sup in mlstm)
        self.slstm = nn.ModuleList(slstm)
        self.final_norm = frozen(final_norm)
        self.lm_head = None if lm_head is None else frozen(lm_head)


LM = Union[DenseLM, EncoderLM, HybridLM, XLSTMLM]


# ------------------------------------------------------------------- init
def _attn_block_init(cfg: ModelConfig, gen: torch.Generator, mlp: str,
                     qkv_bias: bool, moe: bool = False) -> Block:
    dt = dtype_of(cfg.param_dtype)
    ln1 = rmsnorm_init(cfg.d_model, dt, gen.device)
    ln2 = rmsnorm_init(cfg.d_model, dt, gen.device)
    attn = attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
                     dt, qkv_bias)
    if moe:
        return Block(ln1, ln2, attn, moe=moe_init(
            gen, cfg.d_model, cfg.d_ff, cfg.moe.n_experts, dt,
            cfg.moe.dense_residual_ff))
    return Block(ln1, ln2, attn, mlp_init(mlp, gen, cfg.d_model, cfg.d_ff,
                                          dt))


def _mamba_block_init(cfg: ModelConfig, gen: torch.Generator) -> MambaBlock:
    dt = dtype_of(cfg.param_dtype)
    return MambaBlock(rmsnorm_init(cfg.d_model, dt, gen.device),
                      ssm_init(gen, cfg.d_model, expand=cfg.ssm.expand,
                               state_dim=cfg.ssm.state_dim,
                               head_dim=cfg.ssm.head_dim,
                               conv_width=cfg.ssm.conv_width, dtype=dt))


def _cell_block_init(cfg: ModelConfig, gen: torch.Generator,
                     slstm: bool) -> CellBlock:
    dt = dtype_of(cfg.param_dtype)
    x = cfg.xlstm
    cell = (slstm_init(gen, cfg.d_model, cfg.n_heads, x.slstm_proj_factor, dt)
            if slstm else
            mlstm_init(gen, cfg.d_model, cfg.n_heads, x.mlstm_proj_factor,
                       x.conv_width, dt))
    return CellBlock(rmsnorm_init(cfg.d_model, dt, gen.device), cell)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> LM:
    """Random weights on ``gen.device`` from ``gen``, in the reference's
    draw order (embedding or frame projection; each layer, or each Mamba2
    layer and then the shared block, or each mLSTM layer and then each
    sLSTM layer; head)."""
    require_ported(cfg)
    dt = dtype_of(cfg.param_dtype)
    if cfg.family == "encoder":
        first = dense_init(gen, cfg.d_model, cfg.d_model, dt)
    else:
        first = embed_init(gen, cfg.vocab, cfg.d_model, dt)
    n_super, per_super = superblock_shape(cfg)
    if cfg.family == "hybrid":
        body = ([[_mamba_block_init(cfg, gen) for _ in range(per_super)]
                 for _ in range(n_super)],
                _attn_block_init(cfg, gen, "swiglu", False))
    elif cfg.family == "ssm":
        body = ([[_cell_block_init(cfg, gen, False) for _ in range(per_super)]
                 for _ in range(n_super)],
                [_cell_block_init(cfg, gen, True) for _ in range(n_super)])
    else:
        body = ([_attn_block_init(cfg, gen, cfg.mlp, cfg.qkv_bias,
                                  cfg.family == "moe")
                 for _ in range(cfg.n_layers)],)
    head = None
    if not cfg.tie_embeddings:
        head = dense_init(gen, cfg.d_model, cfg.vocab, dt)
    lm = {"hybrid": HybridLM, "ssm": XLSTMLM,
          "encoder": EncoderLM}.get(cfg.family, DenseLM)
    return lm(first, *body, rmsnorm_init(cfg.d_model, dt, gen.device), head)


# ---------------------------------------------------------------- forward
def _attn_kwargs(cfg: ModelConfig) -> Dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.dh, rope_theta=cfg.rope_theta,
                use_rope=cfg.family != "encoder")


def _ssm_kwargs(cfg: ModelConfig) -> Dict:
    return dict(expand=cfg.ssm.expand, state_dim=cfg.ssm.state_dim,
                head_dim=cfg.ssm.head_dim)


def _logits(cfg: ModelConfig, model: LM, x: torch.Tensor,
            impl: Optional[str]) -> torch.Tensor:
    x = rmsnorm(x, model.final_norm, cfg.norm_eps, impl)
    head = model.embed.T if model.lm_head is None else model.lm_head
    return constrain(x @ head.to(x.dtype), "dp", None, "mdl")


def _ffn(cfg: ModelConfig, blk: Block, xn: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on the normed input: (out, the MoE's auxiliary loss
    or None)."""
    if blk.moe is None:
        return blk.ffn(xn), None
    return moe_ffn(blk.moe, xn, n_experts=cfg.moe.n_experts,
                   top_k=cfg.moe.top_k,
                   capacity_factor=cfg.moe.capacity_factor)


def attn_block(cfg: ModelConfig, blk: Block, x: torch.Tensor,
               positions: torch.Tensor, causal: bool, impl: Optional[str]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One transformer block over the whole sequence: (x out, the MoE's
    auxiliary loss or None)."""
    x = x + attention(blk.attn, rmsnorm(x, blk.ln1, cfg.norm_eps, impl),
                      positions, causal=causal, window=cfg.attn_window,
                      impl=impl, **_attn_kwargs(cfg))
    out, aux = _ffn(cfg, blk, rmsnorm(x, blk.ln2, cfg.norm_eps, impl))
    return x + out, aux


def _dense_layer(cfg: ModelConfig, blk: Block, x: torch.Tensor,
                 positions: torch.Tensor, causal: bool, impl: Optional[str]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block of the dense, moe, vlm and encoder stacks, its output
    constrained as the reference's scan body constrains it."""
    x, aux = attn_block(cfg, blk, x, positions, causal, impl)
    return constrain(x, "dp", "mdl", None), aux


def _cell_forward(cfg: ModelConfig, blk: CellBlock, x: torch.Tensor,
                  impl: Optional[str]) -> torch.Tensor:
    fwd = slstm_forward if isinstance(blk.cell, SLSTM) else mlstm_forward
    return x + fwd(blk.cell, rmsnorm(x, blk.ln, cfg.norm_eps, impl),
                   cfg.n_heads, impl=impl)


def embed_inputs(cfg: ModelConfig, model: LM,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The first hidden state ``(B, S, d)``: the frames' projection
    (encoder, ``batch["frames"] (B, S, d)``) or the tokens' embedding
    (``batch["tokens"] (B, S)``), in the compute type.  The gather is
    ``F.embedding``'s: its backward adds each row's terms in fp32 and
    rounds once, where an indexing gather's adds them into the bf16
    gradient one at a time (a token that fills a quarter of a batch
    then sums 1,000 terms at 8 bits)."""
    cdt = dtype_of(cfg.dtype)
    if cfg.family == "encoder":
        return batch["frames"].to(cdt) @ model.frame_proj
    return F.embedding(batch["tokens"], model.embed.to(cdt))


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``; with ``cfg.remat`` under grad mode, recomputed in the
    backward instead of keeping its activations."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _mamba_layer(cfg: ModelConfig, blk: MambaBlock, x: torch.Tensor,
                 impl: Optional[str]) -> torch.Tensor:
    return x + ssm_forward(blk.ssm, rmsnorm(x, blk.ln, cfg.norm_eps, impl),
                           chunk=cfg.ssm.chunk, impl=impl, **_ssm_kwargs(cfg))


def _hybrid_super(cfg: ModelConfig, shared: Block, sup, x: torch.Tensor,
                  positions: torch.Tensor,
                  impl: Optional[str]) -> torch.Tensor:
    for blk in sup:
        x = _remat(cfg, _mamba_layer, cfg, blk, x, impl)
    x, _ = attn_block(cfg, shared, x, positions, True, impl)
    return constrain(x, "dp", "mdl", None)


def _xlstm_super(cfg: ModelConfig, sup, sblk: CellBlock, x: torch.Tensor,
                 impl: Optional[str]) -> torch.Tensor:
    for blk in sup:
        x = _remat(cfg, _cell_forward, cfg, blk, x, impl)
    return constrain(_cell_forward(cfg, sblk, x, impl), "dp", "mdl", None)


def forward(cfg: ModelConfig, model: LM,
            batch: Dict[str, torch.Tensor], impl: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: tokens ``(B, S)`` (frames ``(B, S, d)`` for
    the encoder) -> (logits ``(B, S, V)``, the MoE auxiliary loss: the sum
    over layers, 0 for the other families)."""
    require_ported(cfg)
    x = constrain(embed_inputs(cfg, model, batch), "dp", "mdl", None)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        for sup in model.mamba:
            x = _remat(cfg, _hybrid_super, cfg, model.shared, sup, x,
                       positions, impl)
    elif cfg.family == "ssm":
        for sup, sblk in zip(model.mlstm, model.slstm):
            x = _remat(cfg, _xlstm_super, cfg, sup, sblk, x, impl)
    else:
        for blk in model.blocks:
            x, aux_l = _remat(cfg, _dense_layer, cfg, blk, x, positions,
                              cfg.causal, impl)
            if aux_l is not None:
                aux = aux + aux_l
    return _logits(cfg, model, x, impl), aux


def loss_fn(cfg: ModelConfig, model: LM, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01, impl: Optional[str] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(``xent + aux_weight * moe_aux``, ``{"xent", "moe_aux"}``):
    :func:`forward` and :func:`~repro_torch.models.layers.softmax_xent`
    against ``batch["labels"] (B, S)`` (``-1`` masked)."""
    logits, aux = forward(cfg, model, batch, impl)
    loss = softmax_xent(logits, batch["labels"])
    return loss + aux_weight * aux, {"xent": loss, "moe_aux": aux}


# ------------------------------------------------------------------ decode
#: the ssm family's cache leaves: the mLSTM states, then the sLSTM states
XLSTM_CACHE = ("mC", "mn", "mm", "mconv", "sc", "sn", "sh", "sm")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device) -> Dict[str, torch.Tensor]:
    """Zero decode cache in the reference's layout.

    * dense, vlm, moe: ``{"k", "v"}``, each ``(L, B, max_seq, Hkv, dh)``
      in the compute type.
    * hybrid: ``conv (n_super, per_super, B, W-1, Dc)`` in the compute
      type, ``ssm (n_super, per_super, B, H, P, N)`` in fp32, and
      ``k``/``v (n_super, B, max_seq, Hkv, dh)``, one slot per application
      of the shared block.
    * ssm: the mLSTM states ``mC (n_super, per_super, B, H, dh_in,
      dh_in)``, ``mn (.., B, H, dh_in)``, ``mm (.., B, H)`` (fp32) and
      ``mconv (.., B, W-1, d_in)`` (compute type); the sLSTM states
      ``sc``/``sn``/``sh (n_super, B, H, dh)`` and ``sm (n_super, B, H)``
      (fp32).  The stabilisers ``mm`` and ``sm`` start at -1e30.
    * encoder: raises ``ValueError`` (no decode step).
    """
    require_ported(cfg)
    cdt = dtype_of(cfg.dtype)
    zeros = lambda shape, dt=cdt: torch.zeros(  # noqa: E731
        shape, dtype=dt, device=device)
    f32 = torch.float32
    n_super, per_super = superblock_shape(cfg)
    kv = (n_super, batch, max_seq, cfg.n_kv_heads, cfg.dh)
    if cfg.family in ("dense", "moe", "vlm"):
        return {"k": zeros(kv), "v": zeros(kv)}
    if cfg.family == "hybrid":
        d_inner = cfg.ssm.expand * cfg.d_model
        dc = d_inner + 2 * cfg.ssm.state_dim
        h = d_inner // cfg.ssm.head_dim
        return {"conv": zeros((n_super, per_super, batch,
                               cfg.ssm.conv_width - 1, dc)),
                "ssm": zeros((n_super, per_super, batch, h,
                              cfg.ssm.head_dim, cfg.ssm.state_dim), f32),
                "k": zeros(kv), "v": zeros(kv)}
    if cfg.family == "ssm":
        d_in = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
        h = cfg.n_heads
        dh_in, dh = d_in // h, cfg.d_model // h
        m = (n_super, per_super, batch, h)
        s = (n_super, batch, h)
        return {"mC": zeros(m + (dh_in, dh_in), f32),
                "mn": zeros(m + (dh_in,), f32),
                "mm": torch.full(m, -1e30, dtype=f32, device=device),
                "mconv": zeros((n_super, per_super, batch,
                                cfg.xlstm.conv_width - 1, d_in)),
                "sc": zeros(s + (dh,), f32), "sn": zeros(s + (dh,), f32),
                "sh": zeros(s + (dh,), f32),
                "sm": torch.full(s, -1e30, dtype=f32, device=device)}
    raise ValueError(f"no decode cache for family {cfg.family}")


def _attn_decode_block(cfg: ModelConfig, blk: Block, x: torch.Tensor,
                       pos: int, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       impl: Optional[str]) -> torch.Tensor:
    a, _, _ = attention_decode(
        blk.attn, rmsnorm(x, blk.ln1, cfg.norm_eps, impl), pos, k_cache,
        v_cache, window=cfg.attn_window, **_attn_kwargs(cfg))
    x = x + a
    out, _ = _ffn(cfg, blk, rmsnorm(x, blk.ln2, cfg.norm_eps, impl))
    return x + out


def _xlstm_decode(cfg: ModelConfig, model: XLSTMLM,
                  cache: Dict[str, torch.Tensor], x: torch.Tensor,
                  impl: Optional[str]) -> torch.Tensor:
    """Every xLSTM layer for one token, each cell's new state written into
    its cache slot."""
    for i, (sup, sblk) in enumerate(zip(model.mlstm, model.slstm)):
        for j, blk in enumerate(sup):
            slots = [cache[name][i, j] for name in XLSTM_CACHE[:4]]
            out, st = mlstm_decode(
                blk.cell, rmsnorm(x, blk.ln, cfg.norm_eps, impl),
                dict(zip(("C", "n", "m", "conv"), slots)), cfg.n_heads,
                impl=impl)
            for slot, key in zip(slots, ("C", "n", "m", "conv")):
                slot.copy_(st[key])
            x = x + out
        slots = [cache[name][i] for name in XLSTM_CACHE[4:]]
        out, st = slstm_decode(
            sblk.cell, rmsnorm(x, sblk.ln, cfg.norm_eps, impl),
            dict(zip(("c", "n", "h", "m"), slots)), cfg.n_heads, impl=impl)
        for slot, key in zip(slots, ("c", "n", "h", "m")):
            slot.copy_(st[key])
        x = x + out
    return x


def decode_step(cfg: ModelConfig, model: LM,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: int, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: tokens ``(B, 1)`` at position ``pos`` -> (logits
    ``(B, 1, V)``, the cache).  The cache is updated in place.  The
    encoder raises ``ValueError``."""
    require_ported(cfg)
    if cfg.family == "encoder":
        raise ValueError(f"family {cfg.family} has no decode step")
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
    elif cfg.family == "ssm":
        x = _xlstm_decode(cfg, model, cache, x, impl)
    else:
        for i, blk in enumerate(model.blocks):
            x = _attn_decode_block(cfg, blk, x, pos, cache["k"][i],
                                   cache["v"][i], impl)
    return _logits(cfg, model, x, impl), cache
