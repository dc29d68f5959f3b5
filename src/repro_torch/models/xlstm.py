"""xLSTM blocks (arXiv:2405.04517), transcribed from the reference's
``models/xlstm.py``: mLSTM (matrix memory) and sLSTM (scalar memory),
both with exponential gating.

* mLSTM prefill: the stabilised parallel (quadratic) form, or, at ``S >=
  2 chunk`` with ``S`` a multiple of ``chunk`` (256, as the reference),
  the chunked form: the parallel form inside each chunk and the ``(C, n,
  m)`` state carried across chunks by a Python loop (the reference's
  ``lax.scan``).  Decode is the O(1) recurrence over the matrix memory
  ``C (B, H, dk, dv)``, normaliser ``n (B, H, dk)`` and stabiliser ``m
  (B, H)``, with the causal conv's last ``W - 1`` inputs as state.
* sLSTM: block-diagonal (per-head) recurrent weights, fp32 state, a
  Python loop over time (the reference's ``lax.scan``); its prefill is
  one step per token and layer.

The reference computes both cells in plain jnp, outside any Pallas
kernel, and so does the port.  Each cell's output norm is the layer
RMSNorm at eps 1e-5: one launch of the ``rmsnorm`` kernel on the card.
``w_if``, ``b_if`` (mLSTM gates) and ``r``, ``b`` (sLSTM recurrence) are
fp32 whatever the model's type, as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, frozen, rmsnorm
from repro_torch.models.sharding import along_sequence, constrain

#: chunk length of the chunked mLSTM prefill
MLSTM_CHUNK = 256


# ------------------------------------------------------------------ mLSTM
class MLSTM(nn.Module):
    """One mLSTM cell: ``up_x``/``up_z (d, d_in)``, depthwise ``conv (W,
    d_in)``, ``wq``/``wk``/``wv (d_in, d_in)``, fp32 ``w_if (d_in, 2H)``
    and ``b_if (2H,)``, the output norm ``norm (d_in,)`` and ``down
    (d_in, d)``."""

    def __init__(self, up_x, up_z, conv, wq, wk, wv, w_if, b_if, norm,
                 down):
        super().__init__()
        self.up_x, self.up_z, self.conv = map(frozen, (up_x, up_z, conv))
        self.wq, self.wk, self.wv = map(frozen, (wq, wk, wv))
        self.w_if, self.b_if = frozen(w_if), frozen(b_if)
        self.norm, self.down = frozen(norm), frozen(down)


def mlstm_init(gen: torch.Generator, d_model: int, n_heads: int,
               proj_factor: float, conv_width: int, dtype) -> MLSTM:
    """The reference's leaves in its draw order (up_x, up_z, conv, wq, wk,
    wv, w_if, down); ``b_if`` is 0 for the input gates and 3 for the
    forget gates, ``norm`` ones."""
    d_in = int(proj_factor * d_model)
    dev = gen.device
    up_x = dense_init(gen, d_model, d_in, dtype)
    up_z = dense_init(gen, d_model, d_in, dtype)
    conv = (0.1 * torch.randn((conv_width, d_in), generator=gen,
                              device=dev)).to(dtype)
    wq, wk, wv = (dense_init(gen, d_in, d_in, dtype) for _ in range(3))
    w_if = dense_init(gen, d_in, 2 * n_heads, torch.float32)
    b_if = torch.cat([torch.zeros(n_heads, device=dev),
                      torch.full((n_heads,), 3.0, device=dev)])
    down = dense_init(gen, d_in, d_model, dtype)
    return MLSTM(up_x, up_z, conv, wq, wk, wv, w_if, b_if,
                 torch.ones((d_in,), dtype=dtype, device=dev), down)


def _mlstm_cell_parallel(q, k, v, log_i, log_f) -> torch.Tensor:
    """Stabilised parallel mLSTM: q/k/v ``(B, S, H, dh)``, gates ``(B, S,
    H)`` fp32 -> ``(B, S, H, dh)`` in q's type.  O(S^2) memory."""
    _, s, _, dh = q.shape
    qf = q.float() / math.sqrt(dh)
    kf, vf = k.float(), v.float()
    cum_f = torch.cumsum(log_f, dim=1)                          # (B,S,H)
    # logD[i, j] = cum_f[i] - cum_f[j] + log_i[j]  (j <= i)
    log_d = (cum_f[:, :, None, :] - cum_f[:, None, :, :]
             + log_i[:, None, :, :])                            # (B,Sq,Sk,H)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    log_d = torch.where(mask[None, :, :, None], log_d, -math.inf)
    m = log_d.amax(dim=2, keepdim=True)                         # (B,Sq,1,H)
    scores = torch.einsum("bihd,bjhd->bijh", qf, kf) * torch.exp(log_d - m)
    norm = torch.maximum(scores.sum(dim=2).abs(), torch.exp(-m[:, :, 0, :]))
    out = torch.einsum("bijh,bjhd->bihd", scores, vf) / norm[..., None]
    return out.to(q.dtype)


def _mlstm_cell_chunked(q, k, v, log_i, log_f,
                        chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """Chunkwise stabilised mLSTM: the parallel form inside chunks of
    ``chunk`` steps, the ``(C, n, m)`` state carried from chunk to chunk;
    O(S chunk) memory.  ``S`` not a multiple of the chunk falls back to
    the parallel form, as in the reference."""
    b, s, h, dh = q.shape
    qn = min(chunk, s)
    if s % qn:
        return _mlstm_cell_parallel(q, k, v, log_i, log_f)
    kn = s // qn
    scale = 1.0 / math.sqrt(dh)

    qf = (q.float() * scale).reshape(b, kn, qn, h, dh)
    kf = k.float().reshape(b, kn, qn, h, dh)
    vf = v.float().reshape(b, kn, qn, h, dh)
    li = log_i.float().reshape(b, kn, qn, h)
    bc = torch.cumsum(log_f.float().reshape(b, kn, qn, h), dim=2)

    # intra-chunk decay logD[i, j] = b_i - b_j + i_j  (j <= i)
    log_d = (bc[:, :, :, None, :] - bc[:, :, None, :, :]
             + li[:, :, None, :, :])                            # (B,K,Qi,Qj,H)
    mask = torch.ones((qn, qn), dtype=torch.bool, device=q.device).tril()
    log_d = torch.where(mask[None, None, :, :, None], log_d, -math.inf)
    m_intra = log_d.amax(dim=3)                                 # (B,K,Qi,H)
    qk = torch.einsum("bkihd,bkjhd->bkijh", qf, kf)             # (B,K,Qi,Qj,H)
    # chunk-end summaries: s_j = b_Q - b_j + i_j (decay from j to the end)
    s_end = bc[:, :, -1:, :] - bc + li                          # (B,K,Q,H)
    m_end_local = s_end.amax(dim=2)                             # (B,K,H)
    b_end = bc[:, :, -1, :]                                     # (B,K,H)

    c_state = torch.zeros((b, h, dh, dh), device=q.device)
    n_state = torch.zeros((b, h, dh), device=q.device)
    m_state = torch.full((b, h), -1e30, device=q.device)
    outs = []
    for c in range(kn):
        qc, kc, vc = qf[:, c], kf[:, c], vf[:, c]
        # combined stabiliser per query position
        m_inter = bc[:, c] + m_state[:, None, :]                # (B,Q,H)
        m_comb = torch.maximum(m_inter, m_intra[:, c])
        inter_w = torch.exp(m_inter - m_comb)
        scores = qk[:, c] * torch.exp(log_d[:, c] - m_comb[:, :, None, :])
        h_intra = torch.einsum("bijh,bjhd->bihd", scores, vc)
        # inter: numerator q.C, normaliser q.n (decayed, stabilised)
        h_inter = torch.einsum("bihd,bhdv->bihv", qc, c_state) * \
            inter_w[..., None]
        qn_inter = torch.einsum("bihd,bhd->bih", qc, n_state) * inter_w
        denom = torch.maximum((qn_inter + scores.sum(dim=2)).abs(),
                              torch.exp(-m_comb))
        outs.append((h_inter + h_intra) / denom[..., None])
        # state update to the chunk's end
        m_new = torch.maximum(b_end[:, c] + m_state, m_end_local[:, c])
        carry_w = torch.exp(b_end[:, c] + m_state - m_new)      # (B,H)
        tok_w = torch.exp(s_end[:, c] - m_new[:, None, :])      # (B,Q,H)
        c_state = c_state * carry_w[..., None, None] + torch.einsum(
            "bjhd,bjhv->bhdv", tok_w[..., None] * kc, vc)
        n_state = n_state * carry_w[..., None] + torch.einsum(
            "bjh,bjhd->bhd", tok_w, kc)
        m_state = m_new
    return torch.stack(outs, dim=1).reshape(b, s, h, dh).to(q.dtype)


def _conv_silu(xb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv along the sequence, then SiLU: the taps added
    in order in x's type, as the reference's ``sum(...)`` (on a DTensor,
    each rank's shard with the sequence whole:
    :func:`~repro_torch.models.sharding.along_sequence`)."""
    return along_sequence(_conv_silu_local, xb, w)


def _conv_silu_local(xb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    width, s = w.shape[0], xb.shape[1]
    pad = F.pad(xb, (0, 0, width - 1, 0))
    return F.silu(sum(pad[:, i:i + s, :] * w[i] for i in range(width)))


def _mlstm_qkv_gates(p: MLSTM, conv: torch.Tensor, xb: torch.Tensor,
                     n_heads: int):
    """q, k (from the conv path), v (from ``xb``), each ``(B, S, H, dh)``,
    and the fp32 gates ``log_i``, ``log_f (B, S, H)``."""
    b, s, d_in = xb.shape
    dh = d_in // n_heads
    q = (conv @ p.wq).reshape(b, s, n_heads, dh)
    k = (conv @ p.wk).reshape(b, s, n_heads, dh)
    v = (xb @ p.wv).reshape(b, s, n_heads, dh)
    gates = conv.float() @ p.w_if + p.b_if
    return q, k, v, gates[..., :n_heads], F.logsigmoid(gates[..., n_heads:])


def _mlstm_out(p: MLSTM, h: torch.Tensor, zb: torch.Tensor,
               impl: Optional[str]) -> torch.Tensor:
    return (rmsnorm(h, p.norm, impl=impl) * F.silu(zb)) @ p.down


def mlstm_forward(p: MLSTM, x: torch.Tensor, n_heads: int,
                  impl: Optional[str] = None,
                  chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """Prefill, x ``(B, S, d)`` -> ``(B, S, d)``: the chunked form at ``S
    >= 2 chunk`` with ``S`` a multiple of ``chunk``, else the parallel
    form."""
    b, s, _ = x.shape
    xb, zb = x @ p.up_x, x @ p.up_z
    conv = _conv_silu(xb, p.conv)
    q, k, v, log_i, log_f = _mlstm_qkv_gates(p, conv, xb, n_heads)
    if s >= 2 * chunk and s % chunk == 0:
        h = _mlstm_cell_chunked(q, k, v, log_i, log_f, chunk)
    else:
        h = _mlstm_cell_parallel(q, k, v, log_i, log_f)
    return _mlstm_out(p, h.reshape(b, s, -1), zb, impl)


def mlstm_decode(p: MLSTM, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 n_heads: int, impl: Optional[str] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token, x ``(B, 1, d)``; state ``{C (B, H, dk, dv), n (B, H, dk),
    m (B, H), conv (B, W-1, d_in)}`` -> (out ``(B, 1, d)``, the new state:
    new tensors, the inputs are not written)."""
    b = x.shape[0]
    xb, zb = x @ p.up_x, x @ p.up_z
    window = torch.cat([state["conv"], xb], dim=1)              # (B,W,d_in)
    conv = F.silu(torch.einsum("bwd,wd->bd", window, p.conv))[:, None]
    d_in = xb.shape[-1]
    dh = d_in // n_heads
    q, k, v, log_i, log_f = (
        t[:, 0] for t in _mlstm_qkv_gates(p, conv, xb, n_heads))
    q, k, v = q.float(), k.float(), v.float()                   # (B,H,dh)

    m_new = torch.maximum(log_f + state["m"], log_i)            # (B,H)
    i_g = torch.exp(log_i - m_new)
    f_g = torch.exp(log_f + state["m"] - m_new)
    c_new = state["C"] * f_g[..., None, None] + \
        i_g[..., None, None] * torch.einsum("bhk,bhv->bhkv", k, v)
    n_new = state["n"] * f_g[..., None] + i_g[..., None] * k
    qs = q / math.sqrt(dh)
    num = torch.einsum("bhk,bhkv->bhv", qs, c_new)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qs, n_new).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, 1, d_in).to(x.dtype)
    return _mlstm_out(p, h, zb, impl), {"C": c_new, "n": n_new, "m": m_new,
                                        "conv": window[:, 1:]}


# ------------------------------------------------------------------ sLSTM
class SLSTM(nn.Module):
    """One sLSTM cell: ``w_in (d, 4d)`` (gates i, f, z, o), fp32 ``r (4,
    H, dh, dh)`` (block-diagonal recurrence) and ``b (4d,)``, the output
    norm ``norm (d,)`` and the GeGLU projection ``up1``/``up2 (d, d_up)``,
    ``down (d_up, d)``."""

    def __init__(self, w_in, r, b, norm, up1, up2, down):
        super().__init__()
        self.w_in, self.r, self.b = frozen(w_in), frozen(r), frozen(b)
        self.norm = frozen(norm)
        self.up1, self.up2, self.down = map(frozen, (up1, up2, down))


def slstm_init(gen: torch.Generator, d_model: int, n_heads: int,
               proj_factor: float, dtype) -> SLSTM:
    """The reference's leaves in its draw order (w_in, r, up1, up2, down);
    ``b`` is 3 for the forget gates and 0 elsewhere, ``norm`` ones."""
    dh = d_model // n_heads
    d_up = int(proj_factor * d_model)
    dev = gen.device
    w_in = dense_init(gen, d_model, 4 * d_model, dtype)
    r = torch.randn((4, n_heads, dh, dh), generator=gen,
                    device=dev) / math.sqrt(dh)
    b = torch.cat([torch.zeros(d_model, device=dev),
                   torch.full((d_model,), 3.0, device=dev),
                   torch.zeros(2 * d_model, device=dev)])
    up1 = dense_init(gen, d_model, d_up, dtype)
    up2 = dense_init(gen, d_model, d_up, dtype)
    down = dense_init(gen, d_up, d_model, dtype)
    return SLSTM(w_in, r, b, torch.ones((d_model,), dtype=dtype, device=dev),
                 up1, up2, down)


SState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _slstm_step(p: SLSTM, n_heads: int, carry: SState,
                u_t: torch.Tensor) -> SState:
    """One time step: ``u_t (B, 4d)`` the input's gate contributions;
    carry ``(c, n, h (B, H, dh), m (B, H))`` in fp32 -> the new carry
    (its ``h`` is the step's output)."""
    c, n, h, m = carry
    b, dh = u_t.shape[0], c.shape[-1]
    rec = torch.einsum("ghkd,bhk->bghd", p.r.float(), h)        # (B,4,H,dh)
    gates = u_t.reshape(b, 4, n_heads, dh).float() + rec + \
        p.b.reshape(4, n_heads, dh)
    it, ft, zt, ot = gates.unbind(1)
    # per-head scalar stabiliser: the max over the head dim
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m[..., None], it).amax(dim=-1)  # (B,H)
    # on a DTensor, the max reduced across ranks here (a partial max
    # cannot meet the gates' partial sums in some DTensor releases)
    m_new = constrain(m_new, "dp", None)
    i_g = torch.exp(it - m_new[..., None])
    f_g = torch.exp(log_f + m[..., None] - m_new[..., None])
    c_new = f_g * c + i_g * torch.tanh(zt)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(ot) * c_new / n_new.clamp(min=1e-6)
    return c_new, n_new, h_new, m_new


def _slstm_out(p: SLSTM, h: torch.Tensor,
               impl: Optional[str]) -> torch.Tensor:
    """Output norm and the GeGLU projection (jax's default tanh GELU)."""
    h = rmsnorm(h, p.norm, impl=impl)
    return (F.gelu(h @ p.up1, approximate="tanh") * (h @ p.up2)) @ p.down


def slstm_forward(p: SLSTM, x: torch.Tensor, n_heads: int,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Prefill, x ``(B, S, d)`` -> ``(B, S, d)``: one recurrence step per
    token, in order."""
    b, s, d = x.shape
    u = (x @ p.w_in).float()             # (B,S,4d); the step's cast, hoisted
    zeros = lambda: torch.zeros((b, n_heads, d // n_heads),  # noqa: E731
                                device=x.device)
    carry = (zeros(), zeros(), zeros(),
             torch.full((b, n_heads), -1e30, device=x.device))
    hs = []
    for t in range(s):
        carry = _slstm_step(p, n_heads, carry, u[:, t])
        hs.append(carry[2])
    h = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return _slstm_out(p, h, impl)


def slstm_decode(p: SLSTM, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 n_heads: int, impl: Optional[str] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token, x ``(B, 1, d)``; state ``{c, n, h (B, H, dh), m (B,
    H)}`` -> (out ``(B, 1, d)``, the new state)."""
    b, _, d = x.shape
    u = (x @ p.w_in)[:, 0]
    c, n, h, m = _slstm_step(p, n_heads, (state["c"], state["n"],
                                          state["h"], state["m"]), u)
    out = _slstm_out(p, h.reshape(b, 1, d).to(x.dtype), impl)
    return out, {"c": c, "n": n, "h": h, "m": m}
