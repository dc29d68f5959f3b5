"""Mamba2-style selective state-space block, transcribed from the
reference's ``models/ssm.py``.

Per-head scalar-decay linear recurrence

    h_t = exp(a_t) * h_{t-1} + dt_t * (B_t outer x_t)
    y_t = C_t . h_t + D * x_t

The reference's prefill computes the recurrence with the chunked SSD
scheme (``y_intra + y_inter``: quadratic math inside chunks, a scan over
chunk states); that sum is exactly the ``ssm_scan`` kernel's recurrence on
the same inputs (``a = dt * A``, ``dt = softplus(dt + dt_bias)``, x, B and
C after the causal conv), so the port's :func:`ssm_forward` runs it as one
launch of the hand-written ``ssm_scan`` kernel on the card (its plain
version on the CPU), then adds ``D * x``; under grad mode its backward
is the hand-written ``ssm_scan_bwd`` kernel (the plain twin on the CPU).  :func:`ssm_decode` is the
one-step recurrence in plain torch, as in the reference.  The gated
output norm is the layer RMSNorm at ``eps = 1e-5`` (not the model's
``norm_eps``, as in the reference): one launch of the ``rmsnorm`` kernel.

Layout: x ``(B, S, H, P)`` with H ssm heads of dim P; state
``(B, H, P, N)`` in fp32; B/C projections shared across heads (one
group), ``(B, S, N)``.  ``A_log``, ``D`` and ``dt_bias`` are fp32 whatever
the model's type, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, frozen, rmsnorm


class SSM(nn.Module):
    """Weights of one Mamba2 mixer: fused ``in_proj (d, 2 d_inner + 2 N +
    H)`` (x, z, B, C, dt), depthwise ``conv (W, d_inner + 2 N)``, fp32
    ``A_log``/``D``/``dt_bias (H,)``, ``out_proj (d_inner, d)`` and the
    gated norm's ``norm_z (d_inner,)``."""

    def __init__(self, in_proj, conv, A_log, D, dt_bias, out_proj, norm_z):
        super().__init__()
        self.in_proj, self.conv = frozen(in_proj), frozen(conv)
        self.A_log, self.D, self.dt_bias = map(frozen, (A_log, D, dt_bias))
        self.out_proj, self.norm_z = frozen(out_proj), frozen(norm_z)


def ssm_init(gen: torch.Generator, d_model: int, *, expand: int,
             state_dim: int, head_dim: int, conv_width: int,
             dtype) -> SSM:
    """The reference's shapes, types and values of the constant leaves;
    random leaves drawn from ``gen`` (in_proj, conv, out_proj)."""
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    dev = gen.device
    in_proj = dense_init(gen, d_model, 2 * d_inner + 2 * state_dim + n_heads,
                         dtype)
    conv = (0.1 * torch.randn((conv_width, d_inner + 2 * state_dim),
                              generator=gen, device=dev)).to(dtype)
    out_proj = dense_init(gen, d_inner, d_model, dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    return SSM(in_proj, conv, torch.zeros((n_heads,), **f32),
               torch.ones((n_heads,), **f32), torch.zeros((n_heads,), **f32),
               out_proj, torch.ones((d_inner,), dtype=dtype, device=dev))


def _split_proj(cfg_dims, proj: torch.Tensor):
    """The fused projection's parts: x, z ``(.., d_inner)``, B, C ``(..,
    N)``, dt ``(.., H)``."""
    d_inner, n, _h = cfg_dims
    x, z = proj[..., :d_inner], proj[..., d_inner:2 * d_inner]
    rest = proj[..., 2 * d_inner:]
    return x, z, rest[..., :n], rest[..., n:2 * n], rest[..., 2 * n:]


def _causal_conv(seq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along axis 1, then SiLU; seq ``(B, S, D)``, w
    ``(W, D)``."""
    width = w.shape[0]
    pad = F.pad(seq, (0, 0, width - 1, 0))
    out = torch.zeros_like(seq)
    for i in range(width):
        out = out + pad[:, i:i + seq.shape[1], :] * w[i]
    return F.silu(out)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gated_out(p: SSM, y: torch.Tensor, z: torch.Tensor, dtype,
               impl: Optional[str]) -> torch.Tensor:
    """``RMSNorm(y * silu(z)) @ out_proj`` (eps 1e-5, as the reference)."""
    return rmsnorm(y.to(dtype) * F.silu(z), p.norm_z, impl=impl) @ p.out_proj


def ssm_forward(p: SSM, x_in: torch.Tensor, *, expand: int, state_dim: int,
                head_dim: int, chunk: int,
                impl: Optional[str] = None) -> torch.Tensor:
    """Prefill pass, x_in ``(B, S, d_model)`` -> ``(B, S, d_model)``: one
    ``ssm_scan`` launch on the SSD core, the sequence padded at its end to
    a multiple of ``chunk`` as the reference pads it (the padded steps come
    after every real one, so they change no output)."""
    b, s, d_model = x_in.shape
    d_inner = expand * d_model
    n, hd = state_dim, head_dim
    h = d_inner // hd

    proj = x_in @ p.in_proj
    x, z, bm, cm, dt = _split_proj((d_inner, n, h), proj)
    xbc = _causal_conv(torch.cat([x, bm, cm], dim=-1), p.conv)
    x, bm, cm = (xbc[..., :d_inner], xbc[..., d_inner:d_inner + n],
                 xbc[..., d_inner + n:])

    dt = _softplus(dt.float() + p.dt_bias)                    # (B, S, H)
    a = dt * -torch.exp(p.A_log)                              # (B, S, H)
    xh = x.reshape(b, s, h, hd)
    pad = -s % chunk
    xs, a_s, dt_s = xh.transpose(1, 2), a.transpose(1, 2), dt.transpose(1, 2)
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        a_s, dt_s = F.pad(a_s, (0, pad)), F.pad(dt_s, (0, pad))
        bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    y = ops.ssm_scan(xs, a_s, dt_s, bm, cm, chunk=chunk, impl=impl)
    y = y[:, :, :s].transpose(1, 2) + p.D[:, None] * xh.float()
    return _gated_out(p, y.reshape(b, s, d_inner), z, x_in.dtype, impl)


def ssm_decode(p: SSM, x_in: torch.Tensor, conv_state: torch.Tensor,
               ssm_state: torch.Tensor, *, expand: int, state_dim: int,
               head_dim: int, impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token step: x_in ``(B, 1, d)``; conv_state ``(B, W-1, Dc)``;
    ssm_state ``(B, H, P, N)`` -> (out ``(B, 1, d)``, the new conv state,
    the new ssm state); new tensors, the inputs are not written."""
    b, _one, d_model = x_in.shape
    d_inner = expand * d_model
    n, hd = state_dim, head_dim
    h = d_inner // hd

    proj = x_in @ p.in_proj
    x, z, bm, cm, dt = _split_proj((d_inner, n, h), proj)
    window = torch.cat([conv_state, torch.cat([x, bm, cm], dim=-1)], dim=1)
    conv_out = F.silu(torch.einsum("bwd,wd->bd", window, p.conv))
    x = conv_out[:, :d_inner]
    bf = conv_out[:, d_inner:d_inner + n].float()            # (B, N)
    cf = conv_out[:, d_inner + n:].float()

    dtf = _softplus(dt[:, 0].float() + p.dt_bias)             # (B, H)
    decay = torch.exp(dtf * -torch.exp(p.A_log))              # (B, H)
    xh = x.reshape(b, h, hd).float()
    new_state = ssm_state * decay[..., None, None] + \
        (dtf[..., None] * xh)[..., None] * bf[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", cf, new_state) + p.D[:, None] * xh
    out = _gated_out(p, y.reshape(b, 1, d_inner), z, x_in.dtype, impl)
    return out, window[:, 1:], new_state
