"""Smooth building blocks: soft event selection and a differentiable LUT.

The port of the reference's ``repro.diff.relax``.  Three pure functions,
each the relaxation of one hard operation in the wave loop:

* :func:`soft_min_time`: the Boltzmann (softmax) weighted mean replaces
  the hard ``min`` over a wave's candidate event times.  The mean lies
  in ``[min, max]`` of the valid candidates, so a wave always advances
  at least to the earliest event (progress is preserved and a fixed
  wave budget suffices).
* :func:`soft_max_time`: ``T * logsumexp(t / T)``, the matching upper
  relaxation of ``max`` for the final makespan reduction.
* :func:`smooth_operating_point`: the torch mirror of the ``smooth=True``
  path of :func:`repro_torch.core.power.batched_operating_point`
  (piecewise-linear frequency between adjacent LUT states; the duty
  region is already continuous).

``clip`` and ``maximum`` are spelled as ``torch.maximum`` and
``torch.minimum``, whose gradient splits a tie in half, as the
reference's does.
"""

from __future__ import annotations

import torch

from repro_torch.core.power import DUTY_FLOOR

#: Stand-in for +inf in state tables: finite so that masked and padded
#: branches stay NaN-free under reverse-mode autograd (an ``inf - inf`` in
#: an unselected ``torch.where`` branch still puts a NaN in the gradient).
BIG_POWER = 1e30

#: Logit floor for invalid candidates in the soft minimum.
NEG_BIG = -1e30


def _full(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``minimum(maximum(x, lo), hi)``: the reference's clip, including
    its gradient at a bound."""
    return torch.minimum(torch.maximum(x, _full(x, lo)), _full(x, hi))


def soft_min_time(times: torch.Tensor, valid: torch.Tensor,
                  temperature) -> torch.Tensor:
    """Boltzmann-weighted mean of the ``valid`` entries of ``times``.

    ``times``/``valid`` are ``(..., C)`` candidate tensors; returns
    ``(...,)``.  With every candidate invalid the result is 0 (the
    frozen-row convention of the soft wave loop).  As ``temperature``
    goes to 0 this converges to the hard ``min`` over valid candidates.
    """
    logits = torch.where(valid, -times / temperature, NEG_BIG)
    w = torch.softmax(logits, dim=-1)
    return (w * torch.where(valid, times, 0.0)).sum(dim=-1)


def soft_max_time(times: torch.Tensor, temperature) -> torch.Tensor:
    """Smooth maximum ``T * logsumexp(t / T)`` (>= max, -> max as T->0)."""
    return temperature * torch.logsumexp(times / temperature, dim=-1)


def _take(table_rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(broadcast_to(rows, idx.shape[:-1] + (S,)), idx,
    -1)[..., 0]``."""
    rows = table_rows.expand(idx.shape[:-1] + table_rows.shape[-1:])
    return rows.gather(-1, idx)[..., 0]


def smooth_operating_point(table, caps: torch.Tensor):
    """Differentiable cap -> (freq, duty, power) translation.

    ``table`` has the :class:`repro_torch.core.power.LUTTable` field names
    with ``(N, S)`` state tables and ``(N,)`` lane vectors as tensors in
    the type and on the device of ``caps``, which is ``(..., N)``.
    Mirrors ``batched_operating_point(table, caps, smooth=True)`` with the
    +inf state-table pads replaced by :data:`BIG_POWER`, so every branch
    is finite.
    """
    state_p = table.state_p
    sp = torch.where(torch.isfinite(state_p), state_p, BIG_POWER)
    sf = table.state_f
    fits = sp <= caps[..., None] + 1e-12
    idx = fits.sum(dim=-1) - 1             # highest fitting state, -1 if none
    has_state = idx >= 0
    idx_c = idx.clamp(min=0)[..., None]
    p_lo = _take(sp, idx_c)
    f_lo = _take(sf, idx_c)
    idx_n = (idx_c + 1).clamp(max=sp.shape[-1] - 1)
    p_hi = _take(sp, idx_n)
    f_hi = _take(sf, idx_n)
    denom = p_hi - p_lo
    ok = denom > 0
    t = torch.where(ok, (caps - p_lo) / torch.where(ok, denom, 1.0), 0.0)
    t = _clip(t, 0.0, 1.0)
    freq_fit = f_lo + t * (f_hi - f_lo)
    q = _clip((caps - table.idle_w) / table.span, DUTY_FLOOR, 1.0)
    freq = torch.where(has_state, freq_fit, table.f_min.expand(caps.shape))
    duty = torch.where(has_state, 1.0, q)
    floor_draw = table.idle_w + q * table.span
    power = torch.where(has_state,
                        torch.minimum(caps, table.p_max.expand(caps.shape)),
                        floor_draw)
    return freq, duty, power
