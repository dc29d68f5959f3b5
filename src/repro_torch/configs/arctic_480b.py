"""arctic-480b [moe] — Snowflake Arctic base (hf:Snowflake/snowflake-arctic-base).

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts
top-2 **plus a dense residual FFN** (Arctic's dense-MoE hybrid design).
"""

from .base import ModelConfig, MoEConfig

FULL = ModelConfig(
    arch_id="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    moe=MoEConfig(n_experts=128, top_k=2, capacity_factor=1.25,
                  dense_residual_ff=4864),
    param_dtype="bfloat16",
    dtype="bfloat16",
    remat=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="arctic-480b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=96,
        vocab=256,
        moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.25,
                      dense_residual_ff=96),
    )
