"""qwen1.5-4b [dense] — Qwen1.5 family (hf:Qwen/Qwen1.5-0.5B scaled config).

40L d_model=2560 20H (kv=20, MHA) d_ff=6912 vocab=151936, QKV bias.
"""

from .base import ModelConfig

FULL = ModelConfig(
    arch_id="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    param_dtype="bfloat16",
    dtype="bfloat16",
    remat=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen1.5-4b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=108,
        vocab=512,
        qkv_bias=True,
    )
