"""Torch oracles of the LM kernels, transcribing the reference's
``kernels/ref.py``: whole-sequence softmax and RMSNorm in fp32, no
tiling.  The tests hold the plain versions and the kernels against them.
"""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q ``(B, Sq, H, dh)``; k/v ``(B, Sk, Hkv, dh)``; GQA; fp32 softmax."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, sq, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(dh)
    if causal:
        sk = k.shape[1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, h, dh).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms * gamma.float()).to(x.dtype)
