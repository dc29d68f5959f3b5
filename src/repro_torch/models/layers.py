"""Shared building blocks of the LM port: types, inits, RMSNorm, RoPE and
the MLPs, transcribed from the reference's ``models/layers.py``.

Weights keep the reference's layout: a dense layer is ``x @ W`` with
``W (d_in, d_out)``, so the converter copies the JAX leaves as they are.
Inits draw from an explicit :class:`torch.Generator` on the device the
weights live on: the same seed gives the same model, but not the JAX
package's numbers (the tests carry those across with
``repro_torch.convert.params_from_reference``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as _rmsnorm


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A weight, created as a parameter that takes no gradient: serving
    needs none.  The trainer turns gradients on for the whole model with
    ``model.requires_grad_(True)``."""
    return nn.Parameter(t, requires_grad=False)


# ------------------------------------------------------------------- init
def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    return (scale * torch.randn(shape, generator=gen, device=gen.device,
                                dtype=torch.float32)).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _normal(gen, (d_in, d_out), scale, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    return _normal(gen, (vocab, d), 0.02, dtype)


def rmsnorm_init(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------- rmsnorm
def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5,
            impl: Optional[str] = None) -> torch.Tensor:
    """The layer's RMSNorm: fp32 accumulation, ``x * rms`` rounded to
    ``x``'s type, times ``gamma`` in that type.  One launch of the
    ``rmsnorm`` kernel on the card (its ``layer_form``)."""
    if gamma.dtype != x.dtype:
        gamma = gamma.to(x.dtype)
    return _rmsnorm.rmsnorm(x.contiguous(), gamma.contiguous(), eps,
                            layer_form=True, impl=impl)


# ------------------------------------------------------------------- loss
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_id: int = -1) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32 over the positions whose label
    is not ``ignore_id`` (0 when there is none).  The reference extracts
    the gold logit with a one-hot contraction (for vocab-sharded logits);
    on one device a gather takes the same value."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


# ------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x ``(..., seq, heads, head_dim)``; positions ``(..., seq)``."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------------- mlp
class MLP(nn.Module):
    """SwiGLU (``wi``, ``wg``, ``wo``) or the 2-projection GELU MLP
    (``wi``, ``wo``; ``wg`` is None)."""

    def __init__(self, wi: torch.Tensor, wo: torch.Tensor,
                 wg: Optional[torch.Tensor] = None):
        super().__init__()
        self.wi = frozen(wi)
        self.wo = frozen(wo)
        self.wg = None if wg is None else frozen(wg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.wg is not None:
            return (F.silu(x @ self.wg) * (x @ self.wi)) @ self.wo
        return F.gelu(x @ self.wi, approximate="tanh") @ self.wo


def mlp_init(kind: str, gen: torch.Generator, d: int, ff: int, dtype) -> MLP:
    """The reference's draw order: swiglu ``wi, wg, wo``; gelu ``wi, wo``."""
    if kind == "swiglu":
        wi, wg = dense_init(gen, d, ff, dtype), dense_init(gen, d, ff, dtype)
        return MLP(wi, dense_init(gen, ff, d, dtype), wg)
    return MLP(dense_init(gen, d, ff, dtype), dense_init(gen, ff, d, dtype))
