"""llama3-8b [dense] — Llama 3 8B (arXiv:2407.21783).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""

from .base import ModelConfig

FULL = ModelConfig(
    arch_id="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
    param_dtype="bfloat16",
    dtype="bfloat16",
    remat=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="llama3-8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=224,
        vocab=512,
    )
