"""The selective scan's backward on the CPU: the plain twin
``ssm_scan_bwd_plain`` (the order of the backward kernel
``csrc/ssm_scan_bwd.cu``) against torch autograd of ``ssm_scan_plain``,
against ``jax.vjp`` of the reference's oracle ``kernels.ref.ssm_scan_ref``
(layout ``(B, S, H, P)``, transposed), and against the kernel's order
spelled out in numpy loops bit for bit; the Mamba2 block's gradients
through ``SsmScanFunction`` against ``jax.vjp`` of the reference's
``models.ssm.ssm_forward`` (the chunked SSD form).

Tolerances: fp32 at rtol = atol = 1e-5 for the scan (both sides sum the
same fp32 products in other orders), 1e-4 for the block (the reference
differentiates the chunked SSD algorithm, the port the recurrence: the
forward tests hold the two at 1e-4 too); with bf16 inputs the scan's dx,
dB and dC come back in bf16 on both sides, held at 2e-2 (``SSM_TOL``'s
bf16 bar; one bf16 rounding of fp32 sums that differ in their last
bits).  Inputs are made with numpy from a seed, scaled so that the
gradients are of order one.  The kernel itself is held against the twin
on the card (``tests/test_torch_kernel_cuda.py``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as ref_ref  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402

from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

from test_torch_ssm import block  # noqa: E402

F32 = 1e-5
BLOCK = 1e-4
SSM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: (B, H, S, P, N, chunk): P and N on and off the kernel's multiples (16
#: rows a block, 32 virtual lanes), one step, several tiles
SHAPES = [(1, 2, 24, 16, 32, 8), (2, 3, 21, 5, 7, 7), (1, 2, 40, 20, 40, 8),
          (1, 1, 17, 33, 64, 17), (1, 1, 1, 3, 65, 1)]


def _np32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, dtype=np.float32)


def scan_inputs(b, h, s, p, n, seed, zero_a=False):
    """x, a, dt, Bm, Cm, dy as numpy fp32: a <= 0 (a decay), dt >= 0."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape,  # noqa: E731
                                           dtype=np.float32)
    x = 0.5 * f(b, h, s, p)
    a = np.zeros((b, h, s), np.float32) if zero_a else \
        -0.3 * np.abs(f(b, h, s))
    dt = 0.5 * np.abs(f(b, h, s))
    bm, cm, dy = 0.5 * f(b, s, n), 0.5 * f(b, s, n), f(b, h, s, p)
    return x, a, dt, bm, cm, dy


def torch_inputs(arrays, dtype="float32"):
    """x, Bm and Cm in ``dtype``; a, dt and dy fp32."""
    x, a, dt, bm, cm, dy = (torch.from_numpy(v) for v in arrays)
    td = DT[dtype][0]
    return x.to(td), a, dt, bm.to(td), cm.to(td), dy


@pytest.mark.parametrize("b,h,s,p,n,chunk", SHAPES)
def test_bwd_plain_matches_autograd(b, h, s, p, n, chunk):
    """The twin against torch autograd of the plain forward, fp32."""
    x, a, dt, bm, cm, dy = torch_inputs(scan_inputs(b, h, s, p, n, s + n))
    leaves = [t.clone().requires_grad_() for t in (x, a, dt, bm, cm)]
    ss.ssm_scan_plain(*leaves, chunk).backward(dy)
    got = ss.ssm_scan_bwd_plain(x, a, dt, bm, cm, dy, chunk)
    for g, leaf in zip(got, leaves):
        assert g.dtype == torch.float32 and g.shape == leaf.shape
        np.testing.assert_allclose(_np32(g), _np32(leaf.grad), rtol=F32,
                                   atol=F32)


def _ref_vjp(arrays, dtype):
    """``jax.vjp`` of ``ssm_scan_ref`` at the port's layout: x and dy
    ``(B, H, S, P)`` and a/dt ``(B, H, S)`` transposed to the oracle's
    ``(B, S, H, ...)`` and the gradients back."""
    x, a, dt, bm, cm, dy = arrays
    jd = DT[dtype][1]
    args = (jnp.asarray(x.transpose(0, 2, 1, 3), jd),
            jnp.asarray(a.transpose(0, 2, 1)), jnp.asarray(dt.transpose(0, 2, 1)),
            jnp.asarray(bm, jd), jnp.asarray(cm, jd))
    _, vjp = jax.vjp(ref_ref.ssm_scan_ref, *args)
    gx, ga, gdt, gb, gc = vjp(jnp.asarray(dy.transpose(0, 2, 1, 3)))
    return (np.asarray(gx, np.float32).transpose(0, 2, 1, 3),
            np.asarray(ga).transpose(0, 2, 1),
            np.asarray(gdt).transpose(0, 2, 1),
            np.asarray(gb, np.float32), np.asarray(gc, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,p,n,chunk", SHAPES)
def test_bwd_plain_matches_jax_vjp(b, h, s, p, n, chunk, dtype):
    """The twin against ``jax.vjp`` of the reference's oracle: fp32 at
    1e-5; with bf16 x, Bm and Cm (their gradients in bf16 on both sides)
    at ``SSM_TOL``'s bf16 bar."""
    arrays = scan_inputs(b, h, s, p, n, 7 * s + n)
    tx = torch_inputs(arrays, dtype)
    rounded = [_np32(t) for t in tx]        # the bf16 values both sides see
    want = _ref_vjp(rounded, dtype)
    got = ss.ssm_scan_bwd_plain(*tx, chunk)
    for g, w, like in zip(got, want, tx):
        assert g.dtype == like.dtype and g.shape == like.shape
        np.testing.assert_allclose(_np32(g), w, rtol=SSM_TOL[dtype],
                                   atol=SSM_TOL[dtype])


@pytest.mark.parametrize("chunks", [(24, 8, 4, 3, 1), (60, 20, 12, 6)])
def test_bwd_plain_chunk_invariance(chunks):
    """The tiles are how the twin walks, not what it computes: every chunk
    gives the same gradients bit for bit."""
    s = chunks[0]
    tx = torch_inputs(scan_inputs(1, 2, s, 18, 40, s), "bfloat16")
    first = ss.ssm_scan_bwd_plain(*tx, chunks[0])
    for chunk in chunks[1:]:
        for a, b in zip(first, ss.ssm_scan_bwd_plain(*tx, chunk)):
            assert torch.equal(a, b)


# ---------------------------------------------- the kernel's order in loops
def _np_bf16(v):
    """float32 -> the nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _np_lane_sum(prod):
    """``(..., N)`` -> ``(...)`` as the kernel sums a row: virtual lane
    ``v`` adds entries ``v, v + 32, ...`` in order from the first (zeros
    past N), then the lanes pair up, adjacent first."""
    n = prod.shape[-1]
    k = -(-n // 32)
    pad = np.zeros(prod.shape[:-1] + (32 * k,), np.float32)
    pad[..., :n] = prod
    lanes = [pad[..., v] for v in range(32)]
    for v in range(32):
        for j in range(1, k):
            lanes[v] = lanes[v] + pad[..., v + 32 * j]
    while len(lanes) > 1:
        lanes = [lanes[i] + lanes[i + 1] for i in range(0, len(lanes), 2)]
    return lanes[0]


def _np_rows(v):
    """``(PP, ...)`` -> ``(blocks, ...)``: each block of 16 rows as a
    pairwise tree, adjacent rows first."""
    out = []
    for b0 in range(0, v.shape[0], ss.BWD_ROWS):
        level = [v[r] for r in range(b0, b0 + ss.BWD_ROWS)]
        while len(level) > 1:
            level = [level[i] + level[i + 1] for i in range(0, len(level), 2)]
        out.append(level[0])
    return np.stack(out)


def _np_ssm_bwd(x, e, dt, bm, cm, dy, bf16):
    """The backward kernel spelled in numpy: per (batch, head), the rows
    padded to blocks of 16 and the states walked forward, then step by
    step in reverse the g update, the row sums (``_np_lane_sum``), dx, and
    each block's partials (``_np_rows``); the blocks added in order, for
    dB and dC head after head.  ``e`` is exp(a) as the twin takes it (the
    CPU torch's exp): the order of the sums is what is held here."""
    b, h, s, p = x.shape
    n = bm.shape[-1]
    pp = -(-p // ss.BWD_ROWS) * ss.BWD_ROWS
    blocks = pp // ss.BWD_ROWS
    rnd = _np_bf16 if bf16 else (lambda v: v)
    dx = np.zeros((b, h, s, p), np.float32)
    pdt = np.zeros((b, h, blocks, s), np.float32)
    pda = np.zeros_like(pdt)
    pdb = np.zeros((b, h, blocks, s, n), np.float32)
    pdc = np.zeros_like(pdb)
    for bi in range(b):
        for hi in range(h):
            xr = np.zeros((s, pp), np.float32)
            xr[:, :p] = x[bi, hi]
            dyr = np.zeros((s, pp), np.float32)
            dyr[:, :p] = dy[bi, hi]
            hs = [np.zeros((pp, n), np.float32)]
            for t in range(s):
                hs.append(e[bi, hi, t] * hs[-1] + dt[bi, hi, t]
                          * (xr[t][:, None] * bm[bi, t][None, :]))
            g = np.zeros((pp, n), np.float32)
            for t in reversed(range(s)):
                en = e[bi, hi, t + 1] if t + 1 < s else np.float32(1)
                g = en * g + dyr[t][:, None] * cm[bi, t][None, :]
                gb = _np_lane_sum(g * bm[bi, t][None, :])
                gh = _np_lane_sum(g * hs[t])
                dx[bi, hi, t] = (dt[bi, hi, t] * gb)[:p]
                pdt[bi, hi, :, t] = _np_rows(xr[t] * gb)
                pda[bi, hi, :, t] = _np_rows(gh)
                w = dt[bi, hi, t] * xr[t]
                pdb[bi, hi, :, t] = _np_rows(w[:, None] * g)
                pdc[bi, hi, :, t] = _np_rows(dyr[t][:, None] * hs[t + 1])
    ddt, da = pdt[:, :, 0], pda[:, :, 0]
    for k in range(1, blocks):
        ddt, da = ddt + pdt[:, :, k], da + pda[:, :, k]
    flat_b = pdb.reshape(b, h * blocks, s, n)
    flat_c = pdc.reshape(b, h * blocks, s, n)
    db, dc = flat_b[:, 0], flat_c[:, 0]
    for k in range(1, h * blocks):
        db, dc = db + flat_b[:, k], dc + flat_c[:, k]
    return rnd(dx), e * da, ddt, rnd(db), rnd(dc)


@pytest.mark.parametrize("dtype,shape,zero_a", [
    ("float32", (1, 2, 6, 18, 40), False),   # two blocks, ragged rows, K = 2
    ("bfloat16", (2, 2, 5, 5, 7), False),    # one ragged block, N < 32
    ("bfloat16", (1, 3, 4, 33, 70), True),   # three blocks, K = 3, a = 0
])
def test_bwd_order_in_numpy_loops(dtype, shape, zero_a):
    """The twin against the kernel's order spelled in numpy, bit for bit:
    ragged row blocks, state widths under, at and past 32 lanes, heads
    and batches added in order."""
    tx = torch_inputs(scan_inputs(*shape, sum(shape), zero_a), dtype)
    x, a, dt, bm, cm, dy = tx
    got = ss.ssm_scan_bwd_plain(*tx, shape[2])
    want = _np_ssm_bwd(_np32(x), torch.exp(a).numpy(), dt.numpy(),
                       _np32(bm), _np32(cm), dy.numpy(),
                       dtype == "bfloat16")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np32(g), w)


# ------------------------------------------------- the autograd Function
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_runs_plain_backward_on_cpu(dtype):
    """Under grad, CPU tensors take ``SsmScanFunction``: its forward is
    ``ssm_scan_plain``'s bit for bit, its gradients the twin's, no kernel
    launch is counted, and inputs that need no gradient get none."""
    tx = torch_inputs(scan_inputs(1, 2, 20, 10, 24, 3), dtype)
    x, a, dt, bm, cm, dy = tx
    leaves = [t.clone().requires_grad_(i != 2)
              for i, t in enumerate((x, a, dt, bm, cm))]
    before = dict(ss.LAUNCHES)
    y = ss.ssm_scan(*leaves, chunk=10)
    assert torch.equal(y.detach(), ss.ssm_scan_plain(x, a, dt, bm, cm, 10))
    y.backward(dy)
    assert dict(ss.LAUNCHES) == before
    want = ss.ssm_scan_bwd_plain(x, a, dt, bm, cm, dy, 10)
    for i, (w, leaf) in enumerate(zip(want, leaves)):
        if i == 2:
            assert leaf.grad is None
        else:
            assert leaf.grad.dtype == leaf.dtype
            assert torch.equal(w, leaf.grad)


def test_bwd_dispatch_and_shape_checks():
    """``ssm_scan_bwd`` runs the twin for CPU tensors and the kernel's
    checks (which refuse CPU tensors) when routed to the kernel; a dy of
    the wrong shape is refused."""
    tx = torch_inputs(scan_inputs(1, 1, 8, 4, 8, 0))
    for a, b in zip(ss.ssm_scan_bwd(*tx, chunk=8),
                    ss.ssm_scan_bwd_plain(*tx, 8)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA device"):
        ss.ssm_scan_bwd(*tx, chunk=8, impl="cuda")
    with pytest.raises(ValueError, match="dy must be"):
        ss.ssm_scan_bwd_plain(*tx[:5], tx[5][..., :2], 8)


# ---------------------------------------------------------- the Mamba2 block
@pytest.mark.parametrize("s,chunk", [(32, 8), (50, 16), (16, 32)])
def test_ssm_forward_grads_match_jax_vjp(s, chunk, monkeypatch):
    """Every gradient of the Mamba2 block (x_in, in_proj, conv, A_log, D,
    dt_bias, out_proj, norm_z) through ``SsmScanFunction`` (its backward
    called once) against ``jax.vjp`` of the reference's chunked SSD
    ``ssm_forward``, fp32 at 1e-4; a ragged S is padded to the chunk on
    both sides."""
    calls = []
    real = ss.ssm_scan_bwd
    monkeypatch.setattr(ss, "ssm_scan_bwd", lambda *a, **k: (
        calls.append(k["impl"]), real(*a, **k))[1])
    p, tp, kw = block(s)
    tp.requires_grad_(True)
    rng = np.random.default_rng(s + chunk)
    x = rng.standard_normal((2, s, 32), dtype=np.float32)
    ct = rng.standard_normal((2, s, 32), dtype=np.float32)
    out, vjp = jax.vjp(lambda pp, xx: ref_ssm.ssm_forward(
        pp, xx, chunk=chunk, **kw), p, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    got = ssm.ssm_forward(tp, xt, chunk=chunk, **kw)
    np.testing.assert_allclose(_np32(got), np.asarray(out), rtol=BLOCK,
                               atol=BLOCK)
    got.backward(torch.from_numpy(ct))
    assert calls == ["plain"]
    np.testing.assert_allclose(_np32(xt.grad), np.asarray(gx), rtol=BLOCK,
                               atol=BLOCK)
    names = dict(tp.named_parameters())
    assert set(names) == set(gp)
    for name, leaf in names.items():
        np.testing.assert_allclose(_np32(leaf.grad), np.asarray(gp[name]),
                                   rtol=BLOCK, atol=BLOCK, err_msg=name)
