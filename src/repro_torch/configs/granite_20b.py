"""granite-20b [dense] — IBM Granite 20B code (arXiv:2405.04324).

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
"""

from .base import ModelConfig

FULL = ModelConfig(
    arch_id="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    mlp="gelu",
    param_dtype="bfloat16",
    dtype="bfloat16",
    remat=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-20b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=256,
        vocab=256,
        mlp="gelu",
    )
