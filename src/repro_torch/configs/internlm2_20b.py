"""internlm2-20b [dense] — InternLM2 (arXiv:2403.17297).

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""

from .base import ModelConfig

FULL = ModelConfig(
    arch_id="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    param_dtype="bfloat16",
    dtype="bfloat16",
    remat=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="internlm2-20b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=192,
        vocab=384,
    )
