"""The selective scan's chunked backward on the CPU: the plain twin of the
tensor-core kernel (``csrc/ssm_scan_bwd_tc.cu``),
``ssm_scan_bwd_chunked_plain``, against ``jax.vjp`` of the reference's
oracle ``kernels.ref.ssm_scan_ref`` and, through the Mamba2 block, of the
reference's chunked ``models.ssm.ssm_forward``; its bf16 operands (each
fp32 operand of a product as a bf16 hi and lo pair) against fp32; and the
table that routes the backward to the tensor-core or the scan kernel.

Tolerances: the fp32 twin at rtol = atol = 1e-5 against the oracle, as
the scan's twin is held (``test_torch_ssm_bwd.py``): both sum the same
fp32 products in other orders; the block at 1e-4, as there.  The bf16
operands within :data:`BF16_NORMWISE` of the fp32 twin, normwise per
gradient: a hi and lo pair keeps ~16 bits of an operand (2^-17 relative),
and the bf16 outputs' last rounding flips a few entries by one ulp
(2^-8 relative).  The kernel itself is held against this twin on the
card (``tests/test_torch_kernel_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as ref_ssm  # noqa: E402

from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

from test_torch_ssm import block  # noqa: E402
from test_torch_ssm_bwd import (F32, SSM_TOL, _np32, _ref_vjp,  # noqa: E402
                                scan_inputs, torch_inputs)

BLOCK = 1e-4
#: ``operands="bf16"`` against ``"fp32"``, ||bf16 - fp32|| / ||fp32|| per
#: gradient, by the inputs' type: fp32 outputs carry only the hi / lo
#: pairs' 2^-17 (ddt, a row sum that cancels, reads ~2.4e-5 at SHAPES);
#: bf16 dx, dB and dC add a flipped last rounding in a few entries (~3.5e-4
#: at SHAPES).  Each bar is ~4-6 times the largest reading.
BF16_NORMWISE = {"float32": 1e-4, "bfloat16": 2e-3}
NAMES = ("dx", "da", "ddt", "dB", "dC")
#: (B, H, S, P, N): a ragged last chunk (S = 130, 100), whole chunks, one
#: step, B = 2, P and N of 16 and 64 and between.
SHAPES = [(1, 2, 130, 16, 16), (2, 3, 128, 64, 64), (1, 2, 100, 64, 16),
          (2, 1, 1, 16, 64), (1, 3, 70, 24, 40)]


def unit_inputs(b, h, s, p, n, seed):
    """``scan_inputs`` with x scaled by 4 / sqrt(P) and Bm, Cm by 4 /
    sqrt(N) (1 at 16, where ``scan_inputs`` already gives gradients of
    order one): at P = N = 64 and ``scan_inputs``'s own scale the
    gradients reach tens, where fp32's rounding in any order of the sums
    (``jax.vjp``'s among them) passes an absolute 1e-5."""
    x, a, dt, bm, cm, dy = scan_inputs(b, h, s, p, n, seed)
    return (x * np.float32(4 / np.sqrt(p)), a, dt,
            bm * np.float32(4 / np.sqrt(n)), cm * np.float32(4 / np.sqrt(n)),
            dy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,p,n", SHAPES)
def test_chunked_twin_matches_jax_vjp(b, h, s, p, n, dtype):
    """The chunked twin in fp32 against ``jax.vjp`` of the reference's
    oracle: 1e-5 with fp32 inputs; with bf16 x, Bm and Cm (their
    gradients in bf16 on both sides) at ``SSM_TOL``'s bf16 bar."""
    arrays = unit_inputs(b, h, s, p, n, 11 * s + n + p)
    tx = torch_inputs(arrays, dtype)
    want = _ref_vjp([_np32(t) for t in tx], dtype)
    got = ss.ssm_scan_bwd_chunked_plain(*tx, operands="fp32")
    tol = F32 if dtype == "float32" else SSM_TOL[dtype]
    for name, g, w, like in zip(NAMES, got, want, tx):
        assert g.dtype == like.dtype and g.shape == like.shape, name
        np.testing.assert_allclose(_np32(g), w, rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,p,n", SHAPES)
def test_bf16_operands_within_normwise_bound(b, h, s, p, n, dtype):
    """The kernel's roundings (``operands="bf16"``) against fp32: within
    :data:`BF16_NORMWISE` for every gradient; with bf16 inputs (the
    kernel's route) also within ``SSM_TOL`` of the scan's twin
    elementwise."""
    tx = torch_inputs(scan_inputs(b, h, s, p, n, 5 * s + n), dtype)
    fp32 = ss.ssm_scan_bwd_chunked_plain(*tx, operands="fp32")
    bf16 = ss.ssm_scan_bwd_chunked_plain(*tx, operands="bf16")
    scan = ss.ssm_scan_bwd_plain(*tx, s)
    tol = SSM_TOL[dtype]
    for name, g, w, q in zip(NAMES, bf16, fp32, scan):
        g, w = g.double(), w.double()
        assert float((g - w).norm()) <= \
            BF16_NORMWISE[dtype] * float(w.norm()), name
        if dtype == "bfloat16":
            torch.testing.assert_close(g, q.double(), rtol=tol, atol=tol,
                                       msg=name)


def test_single_bf16_rounding_misses_ssm_tol():
    """Why each fp32 operand enters as a hi and lo pair: rounded once to
    bf16 (``operands="bf16_hi"``), the products put entries of every
    gradient outside ``SSM_TOL`` of the scan's twin on inputs of the
    card's scale (randn x, B, C, dy; a = -0.2 |randn|, dt = |randn|),
    while the pairs keep every entry inside."""
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *sh: torch.randn(sh, generator=gen)  # noqa: E731
    b, h, s, p, n = 1, 4, 256, 64, 64
    a = -0.2 * rnd(b, h, s).abs()
    args = (rnd(b, h, s, p).bfloat16(), a, rnd(b, h, s).abs(),
            rnd(b, s, n).bfloat16(), rnd(b, s, n).bfloat16(),
            rnd(b, h, s, p))
    scan = ss.ssm_scan_bwd_plain(*args, s)
    tol = SSM_TOL["bfloat16"]

    def outside(got):
        return [float(((g.float() - w.float()).abs()
                       > tol + tol * w.float().abs()).float().mean())
                for g, w in zip(got, scan)]

    assert min(outside(ss.ssm_scan_bwd_chunked_plain(
        *args, operands="bf16_hi"))) > 1e-3
    assert max(outside(ss.ssm_scan_bwd_chunked_plain(
        *args, operands="bf16"))) == 0.0


def test_chunked_twin_checks_its_arguments():
    tx = torch_inputs(scan_inputs(1, 1, 8, 8, 8, 0))
    with pytest.raises(ValueError, match="operands"):
        ss.ssm_scan_bwd_chunked_plain(*tx, operands="tf32")
    with pytest.raises(ValueError, match="dy must be"):
        ss.ssm_scan_bwd_chunked_plain(*tx[:5], tx[5][..., :2])


# ---------------------------------------------------------- the Mamba2 block
@pytest.mark.parametrize("operands", ["fp32", "bf16"])
@pytest.mark.parametrize("s,chunk,state_dim,head_dim", [
    (96, 32, 16, 16), (50, 16, 64, 16), (70, 64, 16, 64)])
def test_ssm_forward_grads_through_chunked_twin_match_jax_vjp(
        s, chunk, state_dim, head_dim, operands, monkeypatch):
    """Every gradient of the Mamba2 block with the scan's backward taken by
    the chunked twin (the tensor-core kernel's route on the card) against
    ``jax.vjp`` of the reference's chunked SSD ``ssm_forward``, fp32 at
    1e-4; ragged S padded to the chunk on both sides."""
    calls = []

    def chunked(x, a, dt, bm, cm, dy, **kw):
        calls.append(kw["impl"])
        return ss.ssm_scan_bwd_chunked_plain(x, a, dt, bm, cm, dy,
                                             operands=operands)

    monkeypatch.setattr(ss, "ssm_scan_bwd", chunked)
    p, tp, kw = block(s + state_dim, state_dim=state_dim, head_dim=head_dim)
    tp.requires_grad_(True)
    rng = np.random.default_rng(s + chunk)
    x = rng.standard_normal((2, s, 32), dtype=np.float32)
    ct = rng.standard_normal((2, s, 32), dtype=np.float32)
    out, vjp = jax.vjp(lambda pp, xx: ref_ssm.ssm_forward(
        pp, xx, chunk=chunk, **kw), p, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    got = ssm.ssm_forward(tp, xt, chunk=chunk, **kw)
    got.backward(torch.from_numpy(ct))
    assert calls == ["plain"]
    np.testing.assert_allclose(_np32(xt.grad), np.asarray(gx), rtol=BLOCK,
                               atol=BLOCK)
    names = dict(tp.named_parameters())
    assert set(names) == set(gp)
    for name, leaf in names.items():
        np.testing.assert_allclose(_np32(leaf.grad), np.asarray(gp[name]),
                                   rtol=BLOCK, atol=BLOCK, err_msg=name)


# ---------------------------------------------------------------- the route
@pytest.mark.parametrize("dtype,p,n,want", [
    (torch.bfloat16, 64, 64, "tc"),      # zamba2-2.7b
    (torch.bfloat16, 16, 16, "tc"),      # the smoke config
    (torch.bfloat16, 24, 40, "tc"),
    (torch.bfloat16, 8, 64, "tc"),
    (torch.float32, 64, 64, "scan"),     # fp32 stays on the scan kernel
    (torch.float32, 16, 16, "scan"),
    (torch.bfloat16, 20, 64, "scan"),    # P not a multiple of 8
    (torch.bfloat16, 64, 72, "scan"),    # N past 64
    (torch.bfloat16, 64, 256, "scan"),
    (torch.bfloat16, 5, 40, "scan"),
])
def test_bwd_route_table(dtype, p, n, want):
    """Which ``(dtype, P, N)`` goes where; ``variant=`` forces the scan
    kernel anywhere and the tensor-core one only where it takes the key."""
    assert ss.bwd_kernel_variant(dtype, p, n) == want
    assert ss.BWD_KERNEL_VARIANTS.get((dtype, p, n), "scan") == want
    assert ss.bwd_kernel_variant(dtype, p, n, "scan") == "scan"
    if want == "tc":
        assert ss.bwd_kernel_variant(dtype, p, n, "tc") == "tc"
    else:
        with pytest.raises(ValueError, match="tensor-core"):
            ss.bwd_kernel_variant(dtype, p, n, "tc")
    with pytest.raises(ValueError, match="unknown"):
        ss.bwd_kernel_variant(dtype, p, n, "simt")


@pytest.mark.parametrize("dtype,variant,want", [
    ("bfloat16", None, "tc"), ("bfloat16", "tc", "tc"),
    ("bfloat16", "scan", "scan"), ("float32", None, "scan"),
    ("float32", "scan", "scan")])
def test_bwd_dispatch_follows_the_route(dtype, variant, want, monkeypatch):
    """``ssm_scan_bwd`` on the kernel route calls the wrapper the table
    (or ``variant=``) names; the plain route takes the scan's twin
    whatever the variant; the wrappers refuse CPU tensors."""
    tx = torch_inputs(scan_inputs(1, 2, 16, 16, 16, 1), dtype)
    called = []
    for name in ("ssm_scan_bwd_tc_cuda", "ssm_scan_bwd_cuda"):
        monkeypatch.setattr(ss, name, lambda *a, _n=name: called.append(_n))
    ss.ssm_scan_bwd(*tx, chunk=16, impl="cuda", variant=variant)
    assert called == [{"tc": "ssm_scan_bwd_tc_cuda",
                       "scan": "ssm_scan_bwd_cuda"}[want]]
    monkeypatch.undo()
    for g, w in zip(ss.ssm_scan_bwd(*tx, chunk=16, variant=variant),
                    ss.ssm_scan_bwd_plain(*tx, 16)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA device"):
        ss.ssm_scan_bwd(*tx, chunk=16, impl="cuda", variant=variant)
