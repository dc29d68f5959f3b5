"""Model / run configuration dataclasses.

One :class:`ModelConfig` per assigned architecture lives in
``repro_torch.configs.<arch>``; each also exposes a ``smoke()`` reduction
of the same family for CPU tests.  Input shapes are global
(pre-sharding).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # Snowflake Arctic style: a small dense FFN runs in parallel with the
    # routed experts and is added residually.
    dense_residual_ff: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style selective state space block."""

    state_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128  # SSD chunk length


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack: mLSTM with periodic sLSTM (arXiv:2405.04517)."""

    slstm_every: int = 8       # every k-th block is sLSTM, rest mLSTM
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | hybrid | ssm | xlstm | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    causal: bool = True
    mlp: str = "swiglu"  # "swiglu" (3-proj) or "gelu" (2-proj)
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (zamba2): a single *shared* attention block applied every
    # ``attn_every`` layers (weights reused across applications)
    attn_every: int = 0
    # sliding window for long-context attention (0 = full)
    attn_window: int = 0
    # numerics
    param_dtype: str = "float32"
    dtype: str = "float32"
    remat: bool = False
    # layer-stack scan (small HLO, required for the 480B dry-runs)
    scan_layers: bool = True

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        dh = self.dh
        attn = d * dh * self.n_heads + 2 * d * dh * self.n_kv_heads \
            + self.n_heads * dh * d
        per_layer = 0
        if self.family in ("dense", "moe", "encoder", "vlm"):
            per_layer += attn + 2 * d  # attn + norms
            ffn_mats = 3 if self.mlp == "swiglu" else 2
            if self.family == "moe":
                per_layer += self.moe.n_experts * 3 * d * ff \
                    + d * self.moe.n_experts
                per_layer += 3 * d * self.moe.dense_residual_ff
            elif ff > 0:
                per_layer += ffn_mats * d * ff
        elif self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            per_layer += d * (2 * d_in) + d_in * d + 2 * d  # in/out proj
            per_layer += d_in * (2 * s.state_dim) + 2 * (d_in // s.head_dim)
        elif self.family == "ssm":  # xlstm
            x = self.xlstm
            d_in = int(x.mlstm_proj_factor * d)
            per_layer += 2 * (d * 2 * d_in + d_in * d)
        total = self.n_layers * per_layer + V * d
        if not self.tie_embeddings:
            total += V * d
        if self.family == "hybrid" and self.attn_every:
            total += attn + 3 * d * (4 * d)  # one shared attn+mlp block
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k of the experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        expert_params = self.moe.n_experts * 3 * d * ff
        active_experts = self.moe.top_k * 3 * d * ff
        return self.param_count() - self.n_layers * (expert_params -
                                                     active_experts)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
