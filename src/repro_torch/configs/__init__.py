"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``.

10 assigned architectures; each module exposes ``FULL`` (the exact
published config) and ``smoke()`` (a reduced same-family config for CPU
tests).  ``CELLS`` enumerates the (arch x shape) dry-run matrix including
the documented skips (see DESIGN.md §4).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import (arctic_480b, chameleon_34b, granite_20b, hubert_xlarge,
               internlm2_20b, llama3_8b, moonshot_v1_16b_a3b, qwen1p5_4b,
               xlstm_350m, zamba2_2p7b)
from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                   ModelConfig, MoEConfig, ShapeConfig, SSMConfig,
                   XLSTMConfig, shape_by_name)

_MODULES = {
    "arctic-480b": arctic_480b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "zamba2-2.7b": zamba2_2p7b,
    "granite-20b": granite_20b,
    "internlm2-20b": internlm2_20b,
    "llama3-8b": llama3_8b,
    "qwen1.5-4b": qwen1p5_4b,
    "hubert-xlarge": hubert_xlarge,
    "xlstm-350m": xlstm_350m,
    "chameleon-34b": chameleon_34b,
}

ARCH_IDS = tuple(_MODULES)

#: archs with O(1)-state sequence mixing -> run long_500k
LONG_CONTEXT_ARCHS = ("zamba2-2.7b", "xlstm-350m")
#: encoder-only archs -> no decode step
ENCODER_ARCHS = ("hubert-xlarge",)


def get_config(arch_id: str, shape: Optional[str] = None) -> ModelConfig:
    cfg = _MODULES[arch_id].FULL
    if (shape == "long_500k" and arch_id == "zamba2-2.7b"):
        cfg = zamba2_2p7b.FULL_LONGCTX
    return cfg


def get_smoke(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].smoke()


def cell_status(arch_id: str, shape_name: str) -> str:
    """'run' or the documented skip reason for an (arch x shape) cell."""
    if shape_name in ("decode_32k", "long_500k") and arch_id in ENCODER_ARCHS:
        return "skip: encoder-only, no decode step"
    if shape_name == "long_500k" and arch_id not in LONG_CONTEXT_ARCHS:
        return "skip: pure full-attention arch, 500k needs sub-quadratic"
    return "run"


def cells() -> List[Tuple[str, str, str]]:
    """All 40 (arch, shape, status) cells."""
    out = []
    for arch in ARCH_IDS:
        for sh in ALL_SHAPES:
            out.append((arch, sh.name, cell_status(arch, sh.name)))
    return out


def runnable_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a, s, st in cells() if st == "run"]
