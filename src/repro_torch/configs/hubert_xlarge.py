"""hubert-xlarge [audio] — HuBERT X-Large encoder (arXiv:2106.07447).

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (cluster targets).
Encoder-only: bidirectional attention, no decode step (``decode_32k`` and
``long_500k`` are documented skips).  The convolutional waveform frontend
is a STUB — ``input_specs()`` supplies precomputed frame embeddings
(B, T, d_model), which the model consumes via a linear frame projection.
"""

from .base import ModelConfig

FULL = ModelConfig(
    arch_id="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    mlp="gelu",
    param_dtype="bfloat16",
    dtype="bfloat16",
    remat=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="hubert-xlarge-smoke",
        family="encoder",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=72,
        causal=False,
        mlp="gelu",
    )
