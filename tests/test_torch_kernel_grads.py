"""The backward kernels' plain twins against the JAX reference's gradients,
on the CPU.

* ``rmsnorm_bwd_plain`` (the backward kernel's order) against ``jax.vjp``
  of ``repro.models.layers.rmsnorm`` (the model layer's rounding form) and
  against torch autograd of ``rmsnorm_plain``.  fp32 at rtol = atol =
  1e-5 (both sides compute ``x * r`` and the row sums in fp32, in other
  orders); bf16 inputs and cotangents with dx and dgamma rounded to bf16,
  held normwise at 2e-2: the reference differentiates through its bf16
  rounding of ``x * r`` and of the product with gamma, and its dx sums
  bf16-rounded terms, where the port sums in fp32.
* ``flash_attention_bwd_plain`` against ``jax.vjp`` of
  ``repro.models.attention.blocked_attend`` (causal, full and windowed;
  GQA groups 1 and 4; fp32 and bf16; dh 16, 64, 80 and 128 at S=128) and
  against torch autograd of ``flash_attention_plain``.  fp32 at rtol =
  atol = 1e-5; bf16 normwise at 2e-2: the reference rounds p to bf16
  before the PV product and its cotangents to bf16 at each cast, the
  backward keeps p in fp32 (see the kernel's note).
* The autograd dispatch: under grad, ``rmsnorm`` and ``flash_attention``
  on CPU tensors run their ``autograd.Function`` with the plain backward
  (no kernel launch counted), and so does ``ssm_scan`` (its backward
  twin ``ssm_scan_bwd_plain``; routed to the kernel with CPU tensors it
  raises the kernel's own ``ValueError``).  ``ssm_scan_bwd_plain`` itself
  is held against the reference in ``test_torch_ssm_bwd.py``.
"""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ref_attention  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402

F32 = 1e-5
BF16_NORMWISE = 2e-2
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np32(t):
    return np.asarray(t, dtype=np.float32) if not isinstance(
        t, torch.Tensor) else t.detach().float().numpy()


def _close(got, want, dtype):
    g, w = _np32(got), _np32(want)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=F32, atol=F32)
    else:
        assert np.linalg.norm(g - w) <= BF16_NORMWISE * np.linalg.norm(w)


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 7, 64), (33, 300), (16, 4096)])
def test_rmsnorm_bwd_matches_jax(shape, dtype):
    td, jd = DT[dtype]
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    g = (1 + rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    xt, gt, dyt = (torch.as_tensor(a).to(td) for a in (x, g, dy))
    dx, dg = rn.rmsnorm_bwd_plain(xt, gt, dyt, 1e-5, layer_form=True)
    assert dx.dtype == td and dg.dtype == td and dx.shape == shape
    _, vjp = jax.vjp(lambda a, b: ref_layers.rmsnorm(a, b, 1e-5),
                     jnp.asarray(x).astype(jd), jnp.asarray(g).astype(jd))
    rdx, rdg = vjp(jnp.asarray(dy).astype(jd))
    _close(dx, rdx, dtype)
    _close(dg, rdg, dtype)
    # torch autograd of the plain forward (the same rounding form)
    xa, ga = xt.clone().requires_grad_(), gt.clone().requires_grad_()
    rn.rmsnorm_plain(xa, ga, 1e-5, layer_form=True).backward(dyt)
    _close(dx, xa.grad, dtype)
    _close(dg, ga.grad, dtype)


def _np_bf16(a):
    """float32 -> the nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _np_row_sum(v, vec, threads=rn.THREADS):
    """``(R, d)`` float32 -> ``(R,)`` in the backward kernel's order:
    thread ``t`` adds, from zero, the elements of its 16-byte chunks ``t``,
    ``t + threads``, ... in element order (a short last chunk on the
    strided kernel); each warp's xor butterfly; the warps' partials (the
    lanes past them zero) through one more; lane 0's sum."""
    rows, d = v.shape
    acc = np.zeros((rows, threads), np.float32)
    for t in range(threads):
        for c in range(t * vec, d, threads * vec):
            for i in range(c, min(c + vec, d)):
                acc[:, t] = acc[:, t] + v[:, i]
    lanes = np.arange(32)
    warps = acc.reshape(rows, threads // 32, 32)
    for off in (16, 8, 4, 2, 1):
        warps = warps + warps[:, :, lanes ^ off]
    part = np.zeros((rows, 32), np.float32)
    part[:, :threads // 32] = warps[:, :, 0]
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, lanes ^ off]
    return part[:, 0]


def _np_rmsnorm_bwd(x, g, dy, layer_form, bf16, eps=1e-5):
    """The backward kernel spelled in numpy loops: ``(dx, dgamma)`` as
    float32 values of the working type.  The paired row sums
    (:func:`_np_row_sum`), ``mean = r * sum(g * x) * (1/d)``; dgamma's
    terms added from zero over each block of ``BWD_ROWS`` rows in order,
    the blocks' sums into ``BWD_GROUPS`` groups (group ``k`` takes blocks
    ``k``, ``k + BWD_GROUPS``, ... in order), the groups in order.  r takes
    the plain version's own sqrt: the CPU torch's is not correctly rounded
    (the card's is), and the order of the sums is what is held here."""
    rows, d = x.shape
    vec = 8 if bf16 else 4
    rnd = _np_bf16 if bf16 else (lambda a: a)
    inv = np.float32(rn._inv(d))
    gx = dy * g
    ss = _np_row_sum(x * x, vec)
    sgx = _np_row_sum(gx * x, vec)
    r = torch.sqrt(torch.as_tensor(ss * inv + np.float32(eps)))
    r = r.reciprocal().numpy()
    mean = r * sgx * inv
    xh = x * r[:, None]
    dx = rnd(r[:, None] * (gx - xh * mean[:, None]))
    terms = dy * (rnd(xh) if layer_form else xh)
    blocks = []
    for b0 in range(0, rows, rn.BWD_ROWS):
        acc = np.zeros(d, np.float32)
        for i in range(b0, min(b0 + rn.BWD_ROWS, rows)):
            acc = acc + terms[i]
        blocks.append(acc)
    groups = [np.zeros(d, np.float32) for _ in range(rn.BWD_GROUPS)]
    for b, acc in enumerate(blocks):
        groups[b % rn.BWD_GROUPS] = groups[b % rn.BWD_GROUPS] + acc
    total = np.zeros(d, np.float32)
    for acc in groups:
        total = total + acc
    return dx, rnd(total)


def _bwd_order_case(dtype, rows, d, layer_form, seed):
    td = DT[dtype][0]
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(3 * rng.standard_normal((rows, d)),
                        dtype=torch.float32).to(td)
    g = torch.as_tensor(1 + rng.standard_normal(d),
                        dtype=torch.float32).to(td)
    dy = torch.as_tensor(rng.standard_normal((rows, d)),
                         dtype=torch.float32).to(td)
    got = rn.rmsnorm_bwd_plain(x, g, dy, layer_form=layer_form)
    want = _np_rmsnorm_bwd(*(t.float().numpy() for t in (x, g, dy)),
                           layer_form, dtype == "bfloat16")
    for a, b in zip(got, want):
        assert a.dtype == td
        np.testing.assert_array_equal(a.float().numpy(), b)
    return x, g, dy, got


def test_rmsnorm_bwd_both_forms_and_order():
    """The Pallas form differs from the layer's only in dgamma's rounding
    of ``x * r``; in fp32 the two are one.  The plain version equals the
    backward kernel's order spelled in numpy loops bit for bit
    (:func:`_np_rmsnorm_bwd`): a width on the vector path (514 chunks of
    16 bytes: three a thread for two threads, two for the rest) at a
    ragged row count whose 35 blocks fill the second pass's groups
    unevenly."""
    x, g, dy, a = _bwd_order_case("float32", 549, 2056, True, 1)
    b = rn.rmsnorm_bwd_plain(x, g, dy, layer_form=False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype,rows,d,layer_form", [
    ("bfloat16", 37, 1001, True),     # strided: d no multiple of 8
    ("float32", 300, 1030, False),    # strided: d no multiple of 4
    ("bfloat16", 300, 4104, True),    # vector path, three chunks a thread
    ("bfloat16", 17, 2048, False),    # vector path, the Pallas form
])
def test_rmsnorm_bwd_order_in_numpy_loops(dtype, rows, d, layer_form):
    """The plain version against the kernel's order in numpy loops, bit
    for bit, on the strided kernel's widths (a short last chunk) and on
    the vector path in bf16, both forms."""
    _bwd_order_case(dtype, rows, d, layer_form, rows + d)


def test_rmsnorm_function_runs_plain_backward_on_cpu():
    """Under grad, CPU tensors take the Function with the plain backward:
    the gradients equal ``rmsnorm_bwd_plain``'s bit for bit, and no kernel
    launch is counted."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((5, 64)),
                        dtype=torch.float32).requires_grad_()
    g = torch.ones(64, requires_grad=True)
    dy = torch.as_tensor(rng.standard_normal((5, 64)), dtype=torch.float32)
    before = dict(rn.LAUNCHES)
    y = rn.rmsnorm(x, g, layer_form=True)
    assert y.grad_fn is not None and "Rmsnorm" in type(y.grad_fn).__name__
    y.backward(dy)
    dx, dg = rn.rmsnorm_bwd_plain(x.detach(), g.detach(), dy)
    assert torch.equal(x.grad, dx) and torch.equal(g.grad, dg)
    assert dict(rn.LAUNCHES) == before
    with torch.no_grad():       # no grad: the forward's own path
        assert rn.rmsnorm(x, g, layer_form=True).grad_fn is None


# ---------------------------------------------------------------- flash
FLASH_CASES = [(dh, group, dtype, mask)
               for dh, group, dtype, mask in itertools.product(
                   (16, 64, 80, 128), (1, 4), ("float32", "bfloat16"),
                   ("causal", "full", "window"))]


def _mask(mask):
    return {"causal": (True, 0), "full": (False, 0),
            "window": (True, 48)}[mask]


@pytest.mark.parametrize("dh,group,dtype,mask", FLASH_CASES,
                         ids=[f"dh{d}-g{g}-{t}-{m}"
                              for d, g, t, m in FLASH_CASES])
def test_flash_bwd_matches_jax(dh, group, dtype, mask):
    td, jd = DT[dtype]
    causal, window = _mask(mask)
    b, hkv, s = 1, 2, 128
    h = hkv * group
    rng = np.random.default_rng(dh + group)
    q = rng.standard_normal((b, h, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    do = rng.standard_normal((b, h, s, dh)).astype(np.float32)
    qt, kt, vt, dot = (torch.as_tensor(a).to(td) for a in (q, k, v, do))
    o = fa.flash_attention_plain(qt, kt, vt, causal, window)
    dq, dk, dv = fa.flash_attention_bwd_plain(qt, kt, vt, o, dot, causal,
                                              window)
    assert (dq.dtype, dk.dtype, dv.dtype) == (td, td, td)
    # the reference's layout: (B, S, H, dh), positions 0..S-1
    sw = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3)).astype(jd)  # noqa
    pos = jnp.arange(s)
    _, vjp = jax.vjp(lambda a, c, e: ref_attention.blocked_attend(
        a, c, e, pos, pos, causal, window), sw(q), sw(k), sw(v))
    for got, want in zip((dq, dk, dv), vjp(sw(do))):
        _close(got, np.asarray(want.astype(jnp.float32)).transpose(
            0, 2, 1, 3), dtype)
    # torch autograd of the plain forward loop
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    fa.flash_attention_plain(*leaves, causal, window).backward(dot)
    for got, leaf in zip((dq, dk, dv), leaves):
        _close(got, leaf.grad, dtype)


def test_flash_function_runs_plain_backward_on_cpu():
    """Under grad, CPU tensors take the Function: the forward saves its
    output and the backward equals ``flash_attention_bwd_plain``'s bit for
    bit; no kernel launch is counted; a kv tile other than the kernel's
    64 keys gives the same gradients to fp32 rounding."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).requires_grad_()
               for shape in ((1, 4, 192, 32), (1, 2, 192, 32),
                             (1, 2, 192, 32)))
    do = torch.as_tensor(rng.standard_normal((1, 4, 192, 32)),
                         dtype=torch.float32)
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(q, k, v, causal=True, window=100)
    out.backward(do)
    assert dict(fa.LAUNCHES) == before
    want = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                        out.detach(), do, True, 100)
    for got, leaf in zip(want, (q, k, v)):
        assert torch.equal(got, leaf.grad)
    other = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                         out.detach(), do, True, 100,
                                         block_kv=192)
    for a, b in zip(want, other):
        torch.testing.assert_close(a, b, rtol=F32, atol=F32)


def test_ssm_scan_kernel_route_raises_under_grad():
    """Under grad, ``ssm_scan`` goes through ``SsmScanFunction`` on either
    route: routed to the kernel with CPU tensors it reaches the kernel's
    own checks and raises their ``ValueError`` (no launch counted, no
    fallback to the plain version), with or without grad mode; on the
    plain route the Function's gradients are ``ssm_scan_bwd_plain``'s bit
    for bit."""
    rng = np.random.default_rng(4)
    f = lambda *shape: torch.as_tensor(  # noqa: E731
        rng.standard_normal(shape), dtype=torch.float32)
    x, a, dt = f(1, 2, 8, 4).requires_grad_(), -f(1, 2, 8).abs(), f(1, 2, 8)
    bm, cm = f(1, 8, 4), f(1, 8, 4)
    before = dict(ss.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssm_scan(x, a, dt, bm, cm, chunk=8, impl="cuda")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ss.ssm_scan(x, a, dt, bm, cm, chunk=8, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssm_scan_bwd(x.detach(), a, dt, bm, cm, f(1, 2, 8, 4), chunk=8,
                        impl="cuda")
    assert dict(ss.LAUNCHES) == before
    a, dt, bm, cm = (t.requires_grad_() for t in (a, dt, bm, cm))
    dy = f(1, 2, 8, 4)
    y = ss.ssm_scan(x, a, dt, bm, cm, chunk=4)
    assert y.grad_fn is not None and "SsmScanFunction" in type(
        y.grad_fn).__name__
    y.backward(dy)
    want = ss.ssm_scan_bwd_plain(*(t.detach() for t in (x, a, dt, bm, cm)),
                                 dy, chunk=4)
    for got, leaf in zip(want, (x, a, dt, bm, cm)):
        assert torch.equal(got, leaf.grad)
    assert dict(ss.LAUNCHES) == before
