"""Selective scan (Mamba2 recurrence): plain PyTorch version + CUDA kernel.

    h_t = exp(a_t) * h_{t-1} + dt_t * (x_t outer B_t);   y_t = h_t . C_t

Layout as the Pallas kernel's (``src/repro/kernels/ssm_scan.py``): x
``(B, H, S, P)``, a/dt ``(B, H, S)``, Bm/Cm ``(B, S, N)`` (one group, shared
by every head); y ``(B, H, S, P)`` in fp32 whatever the input type, the
state ``(P, N)`` of each (batch, head) in fp32 from zero.

Both versions round as the Pallas body does in fp32: ``exp(a) * h`` and
``dt * (x * B)`` each rounded, then their sum.  The dot ``h . C`` is
summed in one fixed order: 32 "virtual lanes", lane ``v`` adding the
products of entries ``v, v + 32, ...`` in order, then a pairwise tree over
the lanes, adjacent ones first (``v`` with ``v ^ 1``, then ``v ^ 2``, 4,
8, 16).  The row ``h[p, :]`` of the state depends on ``x[p]`` alone; the
kernel gives each row 8 threads, thread ``l`` holding the virtual lanes
``4 l .. 4 l + 3``, so the tree's first two stages are adds in its
registers and the last three cross threads.  :func:`ssm_scan_plain` sums
in that order too (:func:`_lane_sum`), so kernel and plain agree bit for
bit where their ``exp`` does.

``chunk`` is the reference's sequence tile: ``S`` must be a multiple of
``min(chunk, S)``, as there, and the result does not depend on it.  The
plain version walks the sequence in tiles of that many steps (the state
carried across tiles, as the Pallas grid carries it in VMEM); the kernel
walks it all in one block loop.

:func:`ssm_scan` dispatches on the tensor's device as
:func:`repro_torch.kernels.power_step.resolve_impl` does: the plain
version for CPU tensors, the hand-written kernel (``csrc/ssm_scan.cu``)
for CUDA tensors, which it launches or raises.  Under grad mode, with an
input that requires a gradient, it goes through :class:`SsmScanFunction`,
whose backward is :func:`ssm_scan_bwd`: the kernel
``csrc/ssm_scan_bwd.cu`` on CUDA tensors, its plain twin
:func:`ssm_scan_bwd_plain` on CPU ones.

The backward, with ``g_t = dL/dh_t`` walked in reverse from ``g_S = 0``:

    g_t = exp(a_{t+1}) g_{t+1} + dy_t outer C_t
    dx_t[p] = dt_t gB_t[p],   gB_t[p] = sum_n g_t[p, n] B_t[n]
    ddt_t = sum_p x_t[p] gB_t[p]
    da_t = exp(a_t) sum_p sum_n g_t[p, n] h_{t-1}[p, n]
    dB_t[n] = sum_h sum_p (dt_t x_t[p]) g_t[p, n]
    dC_t[n] = sum_h sum_p dy_t[p] h_t[p, n]

``h_{t-1}`` is recomputed forward from saved states, never divided out
of ``h_t``.  The sums over ``n`` are :func:`_lane_sum`'s; those over
``p`` take the rows in blocks of :data:`BWD_ROWS`, a pairwise tree over a
block's rows (adjacent first), then the blocks (and for dB and dC the
heads, head by head, each head's blocks in order) added one after
another from the first.  No atomics: the result is the same from run to
run, and the twin equals the kernel bit for bit where ``exp`` agrees.

Two kernels compute the backward on the card, picked by
:data:`BWD_KERNEL_VARIANTS` (``variant=`` forces one):

* ``"tc"`` (``csrc/ssm_scan_bwd_tc.cu``) for bf16 x, Bm and Cm at the
  ``(P, N)`` the table lists (multiples of 8 up to 64: zamba2-2.7b's
  (64, 64), the smoke config's (16, 16)): the chunked SSD backward in
  chunks of :data:`TC_CHUNK` steps, its work 64 x 64 x 64 products on the
  tensor cores.  Each fp32 operand of a product enters as a pair of bf16
  values (hi and lo), so its twin is :func:`ssm_scan_bwd_chunked_plain` with
  ``operands="bf16"``; it is held to ``ssm_scan_bwd_plain`` by tolerance,
  not bit for bit.
* ``"scan"`` (``csrc/ssm_scan_bwd.cu``) for fp32 and every other shape:
  the walk above, bit-equal to :func:`ssm_scan_bwd_plain`.

Every backward launch counts under ``LAUNCHES["ssm_scan_bwd"]``, the
tensor-core one's also under ``LAUNCHES["ssm_scan_bwd_tc"]``.  A failed
build or launch raises: no variant falls back to another.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.power_step import resolve_impl

DEFAULT_CHUNK = 256
#: Virtual lanes of the dot product: lane ``v`` sums entries ``n = v + 32 j``.
LANES = 32
#: Largest state width the kernel takes (8 entries a virtual lane).
MAX_STATE = 8 * LANES

#: Types the kernel takes for x, Bm and Cm (codes passed to the C entry
#: point); a and dt are fp32.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Rows of a backward block: the kernel's partial sums over ``p`` are
#: pairwise trees over these rows (adjacent first), the blocks added in
#: order after.
BWD_ROWS = 16

#: Steps of a chunk of the tensor-core backward (every product 64 x 64 x
#: 64 at P = N = 64).
TC_CHUNK = 64
#: The backward kernel each ``(dtype, P, N)`` launches by default: the
#: tensor-core kernel for bf16 at P and N multiples of 8 up to 64 (the
#: (P, N) it takes: its tiles are 64 x 64, zero past P and N); every other
#: key (fp32, other shapes) the scan kernel (:func:`bwd_kernel_variant`).
BWD_KERNEL_VARIANTS = {(torch.bfloat16, p, n): "tc" for p in range(8, 65, 8)
                       for n in range(8, 65, 8)}

#: Kernel launches, counted where each launch happens (the backward once
#: a call, whatever its internal launches): every backward under
#: ``ssm_scan_bwd``, the tensor-core one's also under ``ssm_scan_bwd_tc``.
LAUNCHES: Counter = Counter(ssm_scan=0, ssm_scan_bwd=0, ssm_scan_bwd_tc=0)


def bwd_kernel_variant(dtype: torch.dtype, p: int, n: int,
                       variant: Optional[str] = None) -> str:
    """The backward kernel that runs ``(dtype, P, N)`` on the card: the
    table's (:data:`BWD_KERNEL_VARIANTS`, ``"scan"`` for a key it lacks)
    for ``variant=None``, else ``variant`` itself if that kernel takes
    the key.  Raises for a key the kernel does not take."""
    if variant is None:
        return BWD_KERNEL_VARIANTS.get((dtype, p, n), "scan")
    if variant not in ("tc", "scan"):
        raise ValueError(f"unknown ssm_scan backward kernel variant "
                         f"{variant!r}")
    if variant == "tc" and (dtype, p, n) not in BWD_KERNEL_VARIANTS:
        raise ValueError(f"the tensor-core ssm_scan backward takes bfloat16 "
                         f"with P and N multiples of 8 up to 64, got {dtype} "
                         f"P={p} N={n}")
    return variant


def _check(x, a, dt, Bm, Cm, chunk: int):
    """(B, H, S, P, N) of valid inputs; the reference's chunk check."""
    if x.dim() != 4 or a.dim() != 3 or Bm.dim() != 3:
        raise ValueError(f"x (B, H, S, P), a/dt (B, H, S), Bm/Cm (B, S, N); "
                         f"got {tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(Bm.shape)}")
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    if (tuple(a.shape) != (b, h, s) or tuple(dt.shape) != (b, h, s)
            or tuple(Bm.shape) != (b, s, n) or tuple(Cm.shape) != (b, s, n)):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, dt {tuple(dt.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    ch = min(chunk, s)
    if ch < 1 or s % ch:
        raise ValueError(f"S={s} must divide chunk={ch}")
    return b, h, s, p, n


def _tree(v: torch.Tensor) -> torch.Tensor:
    """``(..., 32) -> (...)``: the pairwise tree over the virtual lanes,
    adjacent lanes first (``v`` with ``v ^ 1``, then pairs, ...)."""
    for _ in range(5):
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def _lane_sum(prod: torch.Tensor) -> torch.Tensor:
    """``(..., N) -> (...)``: the kernel's sum over the state axis.  Virtual
    lane ``v`` adds entries ``v, v + 32, ...`` in order (zeros past N add
    nothing), then the tree adds the lanes."""
    n = prod.shape[-1]
    k = -(-n // LANES)
    v = F.pad(prod, (0, k * LANES - n)).unflatten(-1, (k, LANES))
    acc = v[..., 0, :]
    for j in range(1, k):
        acc = acc + v[..., j, :]
    return _tree(acc)


def ssm_scan_plain(x, a, dt, Bm, Cm,
                   chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """The recurrence step by step, in tiles of ``min(chunk, S)`` steps:
    each tile forms ``dt * (x * B)`` for all its steps at once, runs the
    two state ops a step, and sums ``h . C`` for all its steps."""
    b, h, s, p, n = _check(x, a, dt, Bm, Cm, chunk)
    ch = min(chunk, s)
    # step-major layouts: index t of the tile is a contiguous (B, H, P, N)
    xf = x.float().permute(2, 0, 1, 3)[..., None]        # (S, B, H, P, 1)
    ea = torch.exp(a.float()).permute(2, 0, 1)[..., None, None]
    dtf = dt.float().permute(2, 0, 1)[..., None, None]   # (S, B, H, 1, 1)
    bf = Bm.float().transpose(0, 1)[:, :, None, None, :]  # (S, B, 1, 1, N)
    cf = Cm.float().transpose(0, 1)[:, :, None, None, :]
    y = torch.empty((s, b, h, p), dtype=torch.float32, device=x.device)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    for t0 in range(0, s, ch):
        tile = slice(t0, t0 + ch)
        u = dtf[tile] * (xf[tile] * bf[tile])             # (T, B, H, P, N)
        e = ea[tile]
        steps = []
        for i in range(ch):       # out of place: autograd can follow it
            state = e[i] * state + u[i]
            steps.append(state)
        y[tile] = _lane_sum(torch.stack(steps) * cf[tile])
    return y.permute(1, 2, 0, 3).contiguous()


def _check_cuda(x, a, dt, Bm, Cm, what: str = "ssm_scan") -> None:
    """Raise unless the kernels take these inputs: contiguous tensors on
    one CUDA device, x/Bm/Cm of one type (fp32 or bf16), a/dt fp32,
    ``N <= 256``."""
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    for t in (x, a, dt, Bm, Cm):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"the CUDA kernel needs every input on one "
                             f"CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"the {what} kernel takes contiguous tensors")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"the {what} kernel takes float32 or bfloat16 x, "
                         f"Bm, Cm of one type, got {x.dtype}, {Bm.dtype}, "
                         f"{Cm.dtype}")
    if a.dtype != torch.float32 or dt.dtype != torch.float32:
        raise ValueError(f"the {what} kernel takes float32 a and dt, got "
                         f"{a.dtype} and {dt.dtype}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the {what} kernel takes a state of 1 to "
                         f"{MAX_STATE} entries, got N={n}")
    if b > 65535 or h > 65535 or min(b, h, s, p) < 1:
        raise ValueError(f"the {what} kernel takes 1 <= B, H <= 65535 "
                         f"and S, P >= 1, got {tuple(x.shape)}")


def ssm_scan_cuda(x, a, dt, Bm, Cm,
                  chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Launch the hand-written kernel: contiguous tensors on one CUDA
    device, x/Bm/Cm of one type (fp32 or bf16), a/dt fp32, N <= 256."""
    from repro_torch.kernels._build import check, load_library

    b, h, s, p, n = _check(x, a, dt, Bm, Cm, chunk)
    _check_cuda(x, a, dt, Bm, Cm)
    lib = load_library().lib
    y = torch.empty((b, h, s, p), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.repro_ssm_scan(x.data_ptr(), a.data_ptr(), dt.data_ptr(),
                                  Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                                  b, h, s, p, n, _DTYPES[x.dtype], stream)
    check(code, "ssm_scan")
    LAUNCHES["ssm_scan"] += 1
    return y


# ---------------------------------------------------------------- backward
def _row_tree(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum axis ``dim`` (a multiple of :data:`BWD_ROWS` long) in blocks of
    :data:`BWD_ROWS`: a pairwise tree over each block, adjacent rows
    first; the axis becomes the blocks'."""
    dim = dim % v.dim()
    v = v.unflatten(dim, (-1, BWD_ROWS))
    while v.shape[dim + 1] > 1:
        v = v.unflatten(dim + 1, (-1, 2))
        v = v.select(dim + 2, 0) + v.select(dim + 2, 1)
    return v.squeeze(dim + 1)


def _in_order(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum axis ``dim`` one term after another, from the first."""
    acc = v.select(dim, 0)
    for k in range(1, v.shape[dim]):
        acc = acc + v.select(dim, k)
    return acc


def ssm_scan_bwd_plain(x, a, dt, Bm, Cm, dy, chunk: int = DEFAULT_CHUNK):
    """The backward in the kernel's order: ``(dx, da, ddt, dB, dC)``, dx,
    dB and dC in the input's type, da and ddt fp32.

    In tiles of ``min(chunk, S)`` steps (the result does not depend on
    it): the state entering each tile from a forward walk as
    :func:`ssm_scan_plain` rounds it; then, tile by tile in reverse, the
    tile's states recomputed from the saved one, ``g`` walked back
    through the tile, and every sum of the tile's steps at once.  The
    rows are padded with zeros to whole blocks of :data:`BWD_ROWS`;
    each block's partial sums are pairwise trees over its rows
    (:func:`_row_tree`), added block after block (:func:`_in_order`),
    for dB and dC head after head; da is ``exp(a)`` times its sum."""
    b, h, s, p, n = _check(x, a, dt, Bm, Cm, chunk)
    if tuple(dy.shape) != (b, h, s, p):
        raise ValueError(f"dy must be y's shape {(b, h, s, p)}, got "
                         f"{tuple(dy.shape)}")
    ch = min(chunk, s)
    blocks = -(-p // BWD_ROWS)
    pad = blocks * BWD_ROWS - p
    dev = x.device
    # step-major layouts, rows padded with zeros: (S, B, H, PP, 1) etc.
    xf = F.pad(x.float(), (0, pad)).permute(2, 0, 1, 3)[..., None]
    dyf = F.pad(dy.float(), (0, pad)).permute(2, 0, 1, 3)[..., None]
    ea = torch.exp(a.float()).permute(2, 0, 1)[..., None, None]
    dtf = dt.float().permute(2, 0, 1)[..., None, None]
    bf = Bm.float().transpose(0, 1)[:, :, None, None, :]
    cf = Cm.float().transpose(0, 1)[:, :, None, None, :]
    tiles = list(range(0, s, ch))
    starts, state = [], torch.zeros((b, h, blocks * BWD_ROWS, n),
                                    dtype=torch.float32, device=dev)
    for t0 in tiles:
        starts.append(state)
        u = dtf[t0:t0 + ch] * (xf[t0:t0 + ch] * bf[t0:t0 + ch])
        for i in range(ch):
            state = ea[t0 + i] * state + u[i]
    dx = torch.empty((s, b, h, blocks * BWD_ROWS), dtype=torch.float32,
                     device=dev)
    part_dt = torch.empty((s, b, h, blocks), dtype=torch.float32,
                          device=dev)
    part_da = torch.empty_like(part_dt)
    part_b = torch.empty((s, b, h, blocks, n), dtype=torch.float32,
                         device=dev)
    part_c = torch.empty_like(part_b)
    g = torch.zeros_like(state)
    e_next = torch.ones_like(ea[0])          # past the end: g_S = 0
    for k in reversed(range(len(tiles))):
        tile = slice(tiles[k], tiles[k] + ch)
        u = dtf[tile] * (xf[tile] * bf[tile])
        hs = [starts[k]]
        for i in range(ch):
            hs.append(ea[tiles[k] + i] * hs[-1] + u[i])
        hs = torch.stack(hs)                      # (T + 1, B, H, PP, N)
        dyc = dyf[tile] * cf[tile]
        gs = [None] * ch
        for i in reversed(range(ch)):
            g = e_next * g + dyc[i]
            gs[i] = g
            e_next = ea[tiles[k] + i]
        gs = torch.stack(gs)                      # (T, B, H, PP, N)
        gb = _lane_sum(gs * bf[tile])             # (T, B, H, PP)
        gh = _lane_sum(gs * hs[:-1])
        dx[tile] = dtf[tile][..., 0] * gb
        part_dt[tile] = _row_tree(xf[tile][..., 0] * gb, -1)
        part_da[tile] = _row_tree(gh, -1)
        part_b[tile] = _row_tree((dtf[tile] * xf[tile]) * gs, -2)
        part_c[tile] = _row_tree(dyf[tile] * hs[1:], -2)
    ddt = _in_order(part_dt, -1)
    da = ea[..., 0, 0] * _in_order(part_da, -1)
    db = _in_order(part_b.flatten(2, 3), 2)
    dc = _in_order(part_c.flatten(2, 3), 2)
    return (dx[..., :p].permute(1, 2, 0, 3).to(x.dtype).contiguous(),
            da.permute(1, 2, 0).contiguous(),
            ddt.permute(1, 2, 0).contiguous(),
            db.transpose(0, 1).to(Bm.dtype).contiguous(),
            dc.transpose(0, 1).to(Cm.dtype).contiguous())


def _split(v: torch.Tensor):
    """An fp32 operand as the tensor-core kernel feeds it: ``hi =
    bf16(v)`` and ``lo = bf16(v - hi)``, both as fp32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _mm(a, b, split_a: bool, split_b: bool, operands: str) -> torch.Tensor:
    """``a @ b`` as the kernel forms it.  ``"bf16"``: an operand marked
    split (fp32) enters as its hi and lo parts, the product ``hi.hi +
    lo.hi + hi.lo`` (lo.lo dropped), the other operand as it is (bf16
    values); ``"bf16_hi"``: as its hi part alone; ``"fp32"``: ``a @ b``."""
    if operands == "fp32":
        return a @ b
    ah, al = _split(a) if split_a else (a, None)
    bh, bl = _split(b) if split_b else (b, None)
    out = ah @ bh
    if operands == "bf16_hi":
        return out
    if al is not None:
        out = out + al @ bh
    if bl is not None:
        out = out + ah @ bl
    return out


def ssm_scan_bwd_chunked_plain(x, a, dt, Bm, Cm, dy, *,
                               operands: str = "fp32"):
    """The backward as the chunked SSD form computes it, in plain tensor
    ops: ``(dx, da, ddt, dB, dC)`` as :func:`ssm_scan_bwd_plain` gives
    them, in chunks of :data:`TC_CHUNK` steps (a ragged last chunk padded
    with zero steps, which add nothing).  ``csrc/ssm_scan_bwd_tc.cu``'s
    header derives each term.  ``operands="bf16"`` makes every rounding
    the tensor-core kernel makes: dy, the weighted B and C of the chunk
    states, the masked Q x Q matrices and the states h_in and G_out enter
    their products as bf16 hi and lo parts (:func:`_mm`); ``"fp32"``
    computes in fp32 throughout; ``"bf16_hi"`` rounds each of those
    operands once to bf16 (the kernel without its lo products: too coarse
    for ``SSM_TOL``, the fault the card's tile bar must see)."""
    if operands not in ("fp32", "bf16", "bf16_hi"):
        raise ValueError(f"operands must be 'fp32', 'bf16' or 'bf16_hi', "
                         f"got {operands!r}")
    b, h, s, p, n = _check(x, a, dt, Bm, Cm, 1)    # any chunk: none used
    if tuple(dy.shape) != (b, h, s, p):
        raise ValueError(f"dy must be y's shape {(b, h, s, p)}, got "
                         f"{tuple(dy.shape)}")
    q = TC_CHUNK
    k = -(-s // q)
    pad = k * q - s
    xs = F.pad(x.float(), (0, 0, 0, pad)).view(b, h, k, q, p)
    dys = F.pad(dy.float(), (0, 0, 0, pad)).view(b, h, k, q, p)
    cs = torch.cumsum(F.pad(a.float(), (0, pad)).view(b, h, k, q), -1)
    dts = F.pad(dt.float(), (0, pad)).view(b, h, k, q)
    bs = F.pad(Bm.float(), (0, 0, 0, pad)).view(b, 1, k, q, n)
    cc = F.pad(Cm.float(), (0, 0, 0, pad)).view(b, 1, k, q, n)
    cse = cs[..., -1:]
    we = torch.exp(cse - cs)                        # exp(cs_e - cs_j)
    ec = torch.exp(cs)                              # exp(cs_i)
    ee = torch.exp(cse[..., 0])                     # exp(cs_e)
    # the chunk states: h_in entering each chunk, G_out leaving it
    s_k = _mm(xs.transpose(-1, -2), bs * (dts * we)[..., None], False,
              True, operands)
    t_k = _mm(dys.transpose(-1, -2), cc * ec[..., None], True, True, operands)
    hin, gout = torch.empty_like(s_k), torch.empty_like(t_k)
    state = torch.zeros_like(s_k[:, :, 0])
    for i in range(k):
        hin[:, :, i] = state
        state = ee[:, :, i, None, None] * state + s_k[:, :, i]
    state = torch.zeros_like(state)
    for i in reversed(range(k)):
        gout[:, :, i] = state
        state = ee[:, :, i, None, None] * state + t_k[:, :, i]
    idx = torch.arange(q, device=x.device)
    lower = idx[:, None] >= idx[None, :]            # [i, j]: j <= i
    lmat = torch.where(lower, torch.exp(cs[..., :, None] - cs[..., None, :]),
                       torch.zeros((), device=x.device))
    cb = cc @ bs.transpose(-1, -2)                  # (i, j): C_i . B_j
    dxm = _mm(dys, xs.transpose(-1, -2), True, False, operands)  # dy_i . x_j
    m1, m2 = cb * lmat, dxm * lmat
    g_in = _mm(m1.transpose(-1, -2), dys, True, True, operands)
    g_out = _mm(bs, gout.transpose(-1, -2), False, True, operands)
    gb = g_in + we[..., None] * g_out
    dx = dts[..., None] * gb
    ddt = (xs * gb).sum(-1)
    v = (xs * ((dts * we)[..., None] * g_out)).sum(-1)
    db = dts[..., None] * (_mm(m2.transpose(-1, -2), cc, True, False, operands)
                           + we[..., None] * _mm(xs, gout, False, True,
                                                 operands))
    c_out = ec[..., None] * _mm(dys, hin, True, True, operands)
    dc = _mm(m2 * dts[..., None, :], bs, True, False, operands) + c_out
    u = (cc * c_out).sum(-1)
    # da: the pairs j < t <= i inside the chunk (D), with i in it and j
    # earlier (the suffix of u), with j in it and i later (the prefix of
    # v), with both outside (exp(cs_e) <G_out, h_in>)
    strict = idx[:, None] > idx[None, :]            # [i, j]: j < i
    w = cb * dxm * lmat * dts[..., None, :] * strict
    dq = w.sum(-2) - w.sum(-1)   # sum_{i > j} W_ij less sum_{k < j} W_jk
    d_t = torch.cumsum(dq, -1) - dq
    v_t = torch.cumsum(v, -1) - v
    u_t = u.flip(-1).cumsum(-1).flip(-1)
    da = ((d_t + u_t) + v_t) + (ee * (gout * hin).sum((-1, -2)))[..., None]

    def seq(t):      # (b, h, k, q, ...) -> (b, h, s, ...)
        return t.reshape(b, h, k * q, *t.shape[4:])[:, :, :s]

    return (seq(dx).to(x.dtype).contiguous(), seq(da).contiguous(),
            seq(ddt).contiguous(),
            seq(db).sum(1).to(Bm.dtype).contiguous(),
            seq(dc).sum(1).to(Cm.dtype).contiguous())


def _check_bwd_cuda(x, a, dt, Bm, Cm, dy, chunk: int):
    """Raise unless the backward kernels take these inputs (dy float32 of
    y's shape, contiguous, on x's device); their (B, H, S, P, N)."""
    b, h, s, p, n = _check(x, a, dt, Bm, Cm, chunk)
    _check_cuda(x, a, dt, Bm, Cm, "ssm_scan_bwd")
    if (tuple(dy.shape) != (b, h, s, p) or dy.dtype != torch.float32
            or dy.device != x.device or not dy.is_contiguous()):
        raise ValueError(f"the ssm_scan_bwd kernel takes dy float32 of "
                         f"y's shape {(b, h, s, p)}, contiguous on "
                         f"{x.device}, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    return b, h, s, p, n


def ssm_scan_bwd_tc_cuda(x, a, dt, Bm, Cm, dy, chunk: int = DEFAULT_CHUNK):
    """Launch the tensor-core backward (``csrc/ssm_scan_bwd_tc.cu``):
    bf16 x, Bm and Cm at a ``(P, N)`` :data:`BWD_KERNEL_VARIANTS` routes
    to it, the rest as :func:`ssm_scan_bwd_cuda` takes it; ``(dx, da, ddt,
    dB, dC)`` as :func:`ssm_scan_bwd_chunked_plain` gives them (``chunk``
    is only the reference's tile check).  Its scratch (the chunk states,
    the head groups' dB and dC partials) is one fp32 tensor of the size
    the library asks for."""
    from repro_torch.kernels._build import check, load_library

    b, h, s, p, n = _check_bwd_cuda(x, a, dt, Bm, Cm, dy, chunk)
    bwd_kernel_variant(x.dtype, p, n, "tc")
    lib = load_library().lib
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    da = torch.empty((b, h, s), **f32)
    ddt = torch.empty((b, h, s), **f32)
    db, dc = torch.empty_like(Bm), torch.empty_like(Cm)
    work = torch.empty((lib.repro_ssm_scan_bwd_tc_workspace(b, h, s, p, n),),
                       **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.repro_ssm_scan_bwd_tc(
            *(t.data_ptr() for t in (x, a, dt, Bm, Cm, dy, dx, da, ddt, db,
                                     dc, work)),
            b, h, s, p, n, stream)
    check(code, "ssm_scan_bwd_tc")
    LAUNCHES["ssm_scan_bwd"] += 1
    LAUNCHES["ssm_scan_bwd_tc"] += 1
    return dx, da, ddt, db, dc


def ssm_scan_bwd_cuda(x, a, dt, Bm, Cm, dy, chunk: int = DEFAULT_CHUNK):
    """Launch the backward kernel (``csrc/ssm_scan_bwd.cu``): the
    forward's inputs as :func:`ssm_scan_cuda` takes them and dy fp32 of
    y's shape, contiguous, on their device; ``(dx, da, ddt, dB, dC)`` as
    :func:`ssm_scan_bwd_plain` gives them.  Its scratch (the states
    entering each segment, the blocks' partial sums) is one fp32 tensor
    of the size the library asks for."""
    from repro_torch.kernels._build import check, load_library

    b, h, s, p, n = _check_bwd_cuda(x, a, dt, Bm, Cm, dy, chunk)
    lib = load_library().lib
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    da = torch.empty((b, h, s), **f32)
    ddt = torch.empty((b, h, s), **f32)
    db, dc = torch.empty_like(Bm), torch.empty_like(Cm)
    work = torch.empty((lib.repro_ssm_scan_bwd_workspace(b, h, s, p, n),),
                       **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.repro_ssm_scan_bwd(
            *(t.data_ptr() for t in (x, a, dt, Bm, Cm, dy, dx, da, ddt, db,
                                     dc, work)),
            b, h, s, p, n, _DTYPES[x.dtype], stream)
    check(code, "ssm_scan_bwd")
    LAUNCHES["ssm_scan_bwd"] += 1
    return dx, da, ddt, db, dc


def ssm_scan_bwd(x, a, dt, Bm, Cm, dy, *, chunk: int = DEFAULT_CHUNK,
                 impl: Optional[str] = None, variant: Optional[str] = None):
    """Dispatch the backward: for CUDA tensors the kernel
    :func:`bwd_kernel_variant` names (it launches or raises), for CPU ones
    the plain twin :func:`ssm_scan_bwd_plain`."""
    if resolve_impl(impl, x) == "plain":
        return ssm_scan_bwd_plain(x, a, dt, Bm, Cm, dy, chunk)
    if bwd_kernel_variant(x.dtype, x.shape[-1], Bm.shape[-1],
                          variant) == "tc":
        return ssm_scan_bwd_tc_cuda(x, a, dt, Bm, Cm, dy.contiguous(), chunk)
    return ssm_scan_bwd_cuda(x, a, dt, Bm, Cm, dy.contiguous(), chunk)


class SsmScanFunction(torch.autograd.Function):
    """:func:`ssm_scan` with its backward (:func:`ssm_scan_bwd`); ``impl``
    is resolved once and serves both directions."""

    @staticmethod
    def forward(ctx, x, a, dt, Bm, Cm, chunk: int, impl: str):
        ctx.save_for_backward(x, a, dt, Bm, Cm)
        ctx.chunk, ctx.impl = chunk, impl
        if impl == "plain":
            return ssm_scan_plain(x, a, dt, Bm, Cm, chunk)
        return ssm_scan_cuda(x, a, dt, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, dy):
        x, a, dt, Bm, Cm = ctx.saved_tensors
        grads = ssm_scan_bwd(x, a, dt, Bm, Cm, dy, chunk=ctx.chunk,
                             impl=ctx.impl)
        return (*grads, None, None)


def ssm_scan(x, a, dt, Bm, Cm, *, chunk: int = DEFAULT_CHUNK,
             impl: Optional[str] = None) -> torch.Tensor:
    """x ``(B, H, S, P)``; a/dt ``(B, H, S)``; Bm/Cm ``(B, S, N)`` -> y
    ``(B, H, S, P)`` fp32.  Dispatch (see
    :func:`~repro_torch.kernels.power_step.resolve_impl`): the kernel for
    CUDA tensors, the plain version for CPU ones; under grad mode, with
    an input that requires a gradient, through :class:`SsmScanFunction`
    (the backward kernel on CUDA tensors, the plain twin on CPU ones)."""
    which = resolve_impl(impl, x)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, a, dt, Bm, Cm)):
        return SsmScanFunction.apply(x, a, dt, Bm, Cm, chunk, which)
    if which == "plain":
        return ssm_scan_plain(x, a, dt, Bm, Cm, chunk)
    return ssm_scan_cuda(x, a, dt, Bm, Cm, chunk)
