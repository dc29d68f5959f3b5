"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention (arXiv:2411.15242).

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
The single attention(+MLP) block's weights are *shared* across its
applications (every 6th layer) — Zamba2's signature design.  ``long_500k``
runs with a 4096-token sliding window on the shared attention so the KV
footprint stays bounded; the Mamba2 state is O(1) in sequence length.
"""

from dataclasses import replace

from .base import ModelConfig, SSMConfig

FULL = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, head_dim=64,
                  chunk=128),
    attn_every=6,
    param_dtype="bfloat16",
    dtype="bfloat16",
    remat=True,
)

# long-context variant: windowed shared attention
FULL_LONGCTX = replace(FULL, attn_window=4096)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-2.7b-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, head_dim=16,
                      chunk=32),
        attn_every=2,
    )
