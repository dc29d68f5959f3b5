"""The port's selective scan and Mamba2 block against the JAX reference.

The same numpy inputs (from a seed) go through the reference's
``kernels.ops.ssm_scan`` (Pallas in interpret mode, as
``tests/test_kernels.py`` runs it on the CPU) and ``kernels.ref
.ssm_scan_ref``, and through the port's ``kernels.ops.ssm_scan`` on the
CPU, which dispatches to the plain version.  Tolerances are
``tests/test_kernels.py``'s: 1e-4 fp32, 5e-2 bf16.  The Mamba2 block's
prefill (the port: one scan; the reference: the chunked SSD algorithm)
and its one-step decode are held against the reference's ``ssm_forward``
and ``ssm_decode`` in fp32 at 1e-4 and 1e-5.  The CUDA kernel itself is
held against the plain version on the card
(``tests/test_torch_kernel_cuda.py``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402

from repro_torch.convert import ssm_from_reference  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: the three shapes of tests/test_kernels.py: (B, H, S, P, N, chunk)
SHAPES = [(1, 2, 64, 8, 16, 16), (2, 3, 128, 16, 8, 64),
          (1, 1, 256, 32, 32, 256)]


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def scan_inputs(b, h, s, p, n, seed):
    """x, a, dt, Bm, Cm as numpy fp32, distributed as the reference's
    kernel tests draw them (a <= 0, dt >= 0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, s, p), dtype=np.float32)
    a = -np.abs(rng.standard_normal((b, h, s), dtype=np.float32)) * 0.2
    dt = np.abs(rng.standard_normal((b, h, s), dtype=np.float32))
    bm = rng.standard_normal((b, s, n), dtype=np.float32)
    cm = rng.standard_normal((b, s, n), dtype=np.float32)
    return x, a, dt, bm, cm


def both(arrays, dtype):
    """x, Bm and Cm in ``dtype`` (the same round-to-nearest-even cast on
    both sides), a and dt in fp32, as JAX and torch arrays."""
    jd, td = DTYPES[dtype]
    x, a, dt, bm, cm = arrays
    jx = [jnp.asarray(x).astype(jd), jnp.asarray(a), jnp.asarray(dt),
          jnp.asarray(bm).astype(jd), jnp.asarray(cm).astype(jd)]
    tx = [torch.from_numpy(x).to(td), torch.from_numpy(a),
          torch.from_numpy(dt), torch.from_numpy(bm).to(td),
          torch.from_numpy(cm).to(td)]
    return jx, tx


# ------------------------------------------------------------------ scan
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,p,n,chunk", SHAPES)
def test_ssm_scan_matches_pallas_and_ref(b, h, s, p, n, chunk, dtype):
    jx, tx = both(scan_inputs(b, h, s, p, n, s + n), dtype)
    got = ops.ssm_scan(*tx, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (b, h, s, p)
    pallas = ref_ops.ssm_scan(*jx, chunk=chunk, interpret=True)
    close(got, pallas, TOL[dtype])
    want = ref_ref.ssm_scan_ref(
        jnp.moveaxis(jx[0], 1, 2).astype(jnp.float32),
        jnp.moveaxis(jx[1], 1, 2), jnp.moveaxis(jx[2], 1, 2), jx[3], jx[4])
    close(got, jnp.moveaxis(want, 1, 2), TOL[dtype])
    # the port's own oracle, in the reference's (B, S, H, P) layout
    mine = ref.ssm_scan_ref(tx[0].transpose(1, 2), tx[1].transpose(1, 2),
                            tx[2].transpose(1, 2), tx[3], tx[4])
    close(got, mine.transpose(1, 2), TOL[dtype])


@pytest.mark.parametrize("chunks", [(32, 128), (1, 64), (16, 48)])
def test_ssm_scan_chunk_invariance(chunks):
    """The result does not depend on the tile of steps: the plain version
    carries the state across tiles exactly."""
    _, tx = both(scan_inputs(1, 2, 192 if 48 in chunks else 128, 8, 8, 5),
                 "float32")
    y1, y2 = (ss.ssm_scan(*tx, chunk=c) for c in chunks)
    assert torch.equal(y1, y2)


def test_ssm_scan_rejects_ragged_chunk():
    _, tx = both(scan_inputs(1, 1, 96, 4, 8, 0), "float32")
    with pytest.raises(ValueError, match="must divide"):
        ss.ssm_scan(*tx, chunk=64)
    with pytest.raises(ValueError, match="must divide"):
        ref_ops.ssm_scan(*(jnp.asarray(t.numpy()) for t in tx), chunk=64,
                         interpret=True)
    with pytest.raises(ValueError, match="do not match"):
        ss.ssm_scan(tx[0], tx[1][:, :, :64], tx[2], tx[3], tx[4])


@pytest.mark.parametrize("n", [8, 40, 64])
def test_lane_sum_is_a_sum(n):
    """The kernel-order reduction over N (lanes past N hold zeros) is the
    sum, to fp32 rounding; over exact values it is exact."""
    rng = np.random.default_rng(n)
    v = torch.from_numpy(rng.standard_normal((3, 5, n), dtype=np.float32))
    close(ss._lane_sum(v), v.double().sum(-1), 1e-5)
    ints = torch.from_numpy(rng.integers(-50, 50, (4, n)).astype(np.float32))
    assert torch.equal(ss._lane_sum(ints), ints.sum(-1))


def _tree_sum(row: np.ndarray) -> np.float32:
    """One row in the kernel's order, written out in fp32 scalars: virtual
    lane ``v`` adds entries ``v, v + 32, ...`` left to right (zeros past
    N), then the lanes pair up adjacent ones first (``v`` with ``v + 1``,
    then pairs of pairs, ...)."""
    k = -(-len(row) // 32)
    padded = np.zeros(32 * k, np.float32)
    padded[:len(row)] = row
    lanes = []
    for v in range(32):
        acc = padded[v]
        for j in range(1, k):
            acc = np.float32(acc + padded[v + 32 * j])
        lanes.append(acc)
    while len(lanes) > 1:
        lanes = [np.float32(lanes[i] + lanes[i + 1])
                 for i in range(0, len(lanes), 2)]
    return lanes[0]


@pytest.mark.parametrize("n", [1, 33, 64, 255, 256])
def test_lane_sum_sums_in_the_kernels_tree(n):
    """The plain version's reduction over N is the kernel's: bit for bit
    the written-out tree, and a sum to fp32 rounding."""
    rng = np.random.default_rng(100 + n)
    v = rng.standard_normal((4, n), dtype=np.float32)
    got = ss._lane_sum(torch.from_numpy(v)).numpy()
    assert np.array_equal(got, [_tree_sum(row) for row in v])
    close(got, v.astype(np.float64).sum(-1), 1e-5)


def test_dispatch_cpu_runs_plain_and_cuda_raises():
    _, tx = both(scan_inputs(1, 2, 32, 4, 8, 1), "float32")
    before = ss.LAUNCHES["ssm_scan"]
    assert torch.equal(ss.ssm_scan(*tx), ss.ssm_scan_plain(*tx))
    assert torch.equal(ss.ssm_scan(*tx, impl="plain"),
                       ss.ssm_scan_plain(*tx))
    assert ss.LAUNCHES["ssm_scan"] == before
    with pytest.raises(ValueError, match="CUDA device"):
        ss.ssm_scan(*tx, impl="cuda")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ss.ssm_scan(*tx, impl="triton")


# ---------------------------------------------------------------- block
def block(seed, d_model=32, expand=2, state_dim=16, head_dim=8,
          conv_width=4):
    """The reference's ssm_init weights (fp32) with non-trivial A_log, D
    and dt_bias, and the port's SSM carrying the same arrays."""
    p = ref_ssm.ssm_init(jax.random.PRNGKey(seed), d_model, expand=expand,
                         state_dim=state_dim, head_dim=head_dim,
                         conv_width=conv_width, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    h = expand * d_model // head_dim
    p = dict(p, A_log=jnp.asarray(rng.uniform(-1, 1, h), jnp.float32),
             D=jnp.asarray(rng.uniform(0.5, 1.5, h), jnp.float32),
             dt_bias=jnp.asarray(rng.uniform(-1, 1, h), jnp.float32))
    kw = dict(expand=expand, state_dim=state_dim, head_dim=head_dim)
    return p, ssm_from_reference(p, torch.float32), kw


@pytest.mark.parametrize("s,chunk", [(64, 16), (50, 16), (96, 32),
                                     (8, 32)])
def test_ssm_forward_matches(s, chunk):
    """Chunked SSD (reference) vs one scan (port), ragged S padded."""
    p, tp, kw = block(s)
    x = np.random.default_rng(s).standard_normal((2, s, 32),
                                                 dtype=np.float32)
    want = ref_ssm.ssm_forward(p, jnp.asarray(x), chunk=chunk, **kw)
    got = ssm.ssm_forward(tp, torch.from_numpy(x), chunk=chunk, **kw)
    close(got, want, 1e-4)


def test_ssm_decode_matches():
    """Eight one-token steps from a zero state: output, conv state and
    ssm state at every step."""
    p, tp, kw = block(3)
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((8, 2, 1, 32), dtype=np.float32)
    h = 2 * 32 // 8
    conv = np.zeros((2, 3, 64 + 32), np.float32)
    state = np.zeros((2, h, 8, 16), np.float32)
    jc, js = jnp.asarray(conv), jnp.asarray(state)
    tc, ts = torch.from_numpy(conv), torch.from_numpy(state)
    for x in xs:
        want, jc, js = ref_ssm.ssm_decode(p, jnp.asarray(x), jc, js, **kw)
        got, tc, ts = ssm.ssm_decode(tp, torch.from_numpy(x), tc, ts, **kw)
        close(got, want, 1e-5)
        close(tc, jc, 1e-5)
        close(ts, js, 1e-5)


def test_decode_steps_follow_forward():
    """The port's own prefill (one scan) and its step-by-step decode give
    the same outputs: the two forms of one recurrence."""
    _p, tp, kw = block(4)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 24, 32), dtype=np.float32))
    full = ssm.ssm_forward(tp, x, chunk=8, **kw)
    conv = torch.zeros((1, 3, 96))
    state = torch.zeros((1, 8, 8, 16))
    for t in range(24):
        out, conv, state = ssm.ssm_decode(tp, x[:, t:t + 1], conv, state,
                                          **kw)
        close(out, full[:, t:t + 1], 1e-5)
