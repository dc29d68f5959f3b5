"""xlstm-350m [ssm] — xLSTM (arXiv:2405.04517).

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304 — sLSTM + mLSTM blocks.
``d_ff=0``: no separate FFN; projection factors live inside the blocks
(mLSTM 2.0, sLSTM 4/3).  Every 8th block is sLSTM (7:1 ratio).
Recurrent state is O(1) in sequence length -> runs ``long_500k``.
"""

from .base import ModelConfig, XLSTMConfig

FULL = ModelConfig(
    arch_id="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    xlstm=XLSTMConfig(slstm_every=8, mlstm_proj_factor=2.0,
                      slstm_proj_factor=4.0 / 3.0, conv_width=4),
    param_dtype="bfloat16",
    dtype="bfloat16",
    remat=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="xlstm-350m-smoke",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab=256,
        xlstm=XLSTMConfig(slstm_every=2, mlstm_proj_factor=2.0,
                          slstm_proj_factor=4.0 / 3.0, conv_width=4),
    )
