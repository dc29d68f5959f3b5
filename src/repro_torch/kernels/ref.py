"""Torch oracles of the LM kernels, transcribing the reference's
``kernels/ref.py``: whole-sequence softmax and RMSNorm in fp32, no
tiling, and the selective scan as a plain loop over the sequence.  The
tests hold the plain versions and the kernels against them.
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


def ssm_scan_ref(x: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """Selective-scan oracle: h_t = e^{a_t} h_{t-1} + dt_t B_t (x) x_t;
    y_t = C_t . h_t.

    x ``(B, S, H, P)``; a/dt ``(B, S, H)``; Bm/Cm ``(B, S, N)`` -> y
    ``(B, S, H, P)``, fp32.
    """
    bsz, s, h, p = x.shape
    xf, af, dtf, bf, cf = (t.float() for t in (x, a, dt, Bm, Cm))
    state = torch.zeros((bsz, h, p, Bm.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        state = torch.exp(af[:, t])[..., None, None] * state + torch.einsum(
            "bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], bf[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", cf[:, t], state))
    return torch.stack(ys, dim=1)
