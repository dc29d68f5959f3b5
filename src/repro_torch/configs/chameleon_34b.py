"""chameleon-34b [vlm] — early-fusion token-based VLM (arXiv:2405.09818).

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early fusion means images are VQ-tokenised into the same 65536-entry
vocabulary as text; the VQ-VAE image tokenizer is the STUB modality
frontend — ``input_specs()`` supplies precomputed token ids (text + image
tokens interleaved), so the backbone is a standard decoder.
"""

from .base import ModelConfig

FULL = ModelConfig(
    arch_id="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    param_dtype="bfloat16",
    dtype="bfloat16",
    remat=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="chameleon-34b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=1,
        d_ff=172,
        vocab=256,
    )
