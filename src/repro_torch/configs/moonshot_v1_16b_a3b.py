"""moonshot-v1-16b-a3b [moe] — Moonlight-16B-A3B (hf:moonshotai/Moonlight-16B-A3B).

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
"""

from .base import ModelConfig, MoEConfig

FULL = ModelConfig(
    arch_id="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    moe=MoEConfig(n_experts=64, top_k=6, capacity_factor=1.25),
    param_dtype="bfloat16",
    dtype="bfloat16",
    remat=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="moonshot-v1-16b-a3b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=48,
        vocab=512,
        moe=MoEConfig(n_experts=8, top_k=3, capacity_factor=1.25),
    )
