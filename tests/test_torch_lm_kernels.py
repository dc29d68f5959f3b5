"""The port's LM kernels (plain versions) against the JAX reference.

The same numpy inputs (from a seed) go through the reference's
``kernels.ops`` wrappers (Pallas in interpret mode, as
``tests/test_kernels.py`` runs them on the CPU) and oracles
(``kernels.ref``), and through the port's ``kernels.ops`` on the CPU,
which dispatch to the plain versions.  Tolerances are
``tests/test_kernels.py``'s: rmsnorm 1e-5 fp32 / 2e-2 bf16, flash
attention 2e-5 fp32 / 2e-2 bf16.  The model layer's RMSNorm form is held
against ``models.layers.rmsnorm`` at 1e-6 fp32 and 1e-2 bf16 (the two
sum in different orders, so a bf16 result may differ by one ulp), and
the flash loop against ``models.attention.blocked_attend``.  The CUDA
kernels themselves are held against the plain versions on the card
(``tests/test_torch_kernel_cuda.py``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models import layers  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(a, dtype):
    """One numpy array as a JAX and a torch array of ``dtype`` (the same
    round-to-nearest-even cast on both sides)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("shape", [(8, 128), (2, 16, 256), (1, 512),
                                   (3, 5, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas_and_ref(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    jx, tx = both(rng.standard_normal(shape, dtype=np.float32), dtype)
    jg, tg = both(rng.standard_normal(shape[-1], dtype=np.float32) + 1.0,
                  dtype)
    got = ops.rmsnorm(tx, tg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    close(got, ref_ops.rmsnorm(jx, jg, interpret=True), tol)
    close(got, ref_ref.rmsnorm_ref(jx, jg), tol)
    close(ref.rmsnorm_ref(tx, tg), ref_ref.rmsnorm_ref(jx, jg), tol)


@pytest.mark.parametrize("shape", [(4, 96), (2, 3, 64), (5, 4096)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_layer_form_matches_model_layer(shape, dtype):
    rng = np.random.default_rng(7 + shape[-1])
    jx, tx = both(3 * rng.standard_normal(shape, dtype=np.float32), dtype)
    jg, tg = both(rng.standard_normal(shape[-1], dtype=np.float32), dtype)
    got = layers.rmsnorm(tx, tg)
    tol = 1e-2 if dtype == "bfloat16" else 1e-6
    close(got, ref_layers.rmsnorm(jx, jg), tol)
    # the two forms agree in fp32 and differ by one rounding in bf16
    pallas_form = rn.rmsnorm(tx, tg)
    if dtype == "float32":
        assert torch.equal(got, pallas_form)
    else:
        close(got, pallas_form, 1e-2)


def _lane0_butterfly(v):
    """A warp's xor butterfly (``v + shfl_xor(v, off)`` for off = 16 ... 1)
    over 32 float32 lanes, written lane by lane; lane 0's value."""
    v = list(v)
    for off in (16, 8, 4, 2, 1):
        v = [np.float32(v[i] + v[i ^ off]) for i in range(32)]
    return v[0]


def _kernel_sum_order(x, vec, threads=rn.THREADS):
    """``(R, d)`` float32 -> ``(R, 1)``: the kernel's sum of squares as
    explicit loops in float32.  Thread ``t`` walks its slots ``j`` (chunk
    ``j * threads + t`` of ``vec`` elements) and each chunk's elements in
    order, skipping those past ``d``; then each warp's butterfly, and one
    more over the warps' partials (zeros past the last warp)."""
    rows, d = x.shape
    slots = -(-d // (vec * threads))
    out = np.empty((rows, 1), np.float32)
    for r in range(rows):
        lanes = []
        for t in range(threads):
            acc = np.float32(0.0)
            for j in range(slots):
                for e in range(vec):
                    i = (j * threads + t) * vec + e
                    if i < d:
                        acc = np.float32(acc + x[r, i] * x[r, i])
            lanes.append(acc)
        warps = [_lane0_butterfly(lanes[w:w + 32])
                 for w in range(0, threads, 32)]
        out[r, 0] = _lane0_butterfly(warps + [np.float32(0.0)]
                                     * (32 - len(warps)))
    return out


def test_rmsnorm_sum_order_is_the_kernels():
    """The plain sum of squares walks the kernel's order (16-byte chunks of
    4 fp32 or 8 bf16 elements, thread-strided slots, then two
    butterflies): it equals the order written out as loops bit for bit,
    and it is a sum of the same terms."""
    rng = np.random.default_rng(3)
    for vec in (4, 8):
        for d in (1, 8, 64, 255, 256, 300, 1001, 2560, 4096, 5000, 5120):
            a = (rng.standard_normal((2, d))
                 * rng.uniform(0.1, 10.0, (2, 1))).astype(np.float32)
            x = torch.from_numpy(a)
            got = rn._sum_squares(x, vec)
            np.testing.assert_array_equal(got.numpy(),
                                          _kernel_sum_order(a, vec))
            want = (x.double() ** 2).sum(-1, keepdim=True)
            torch.testing.assert_close(got.double(), want, rtol=1e-5,
                                       atol=0)


# ---------------------------------------------------------------- flash
FLASH_SHAPES = [(1, 4, 4, 128, 64),     # MHA
                (2, 8, 2, 256, 64),     # GQA 4:1
                (1, 4, 1, 128, 128),    # MQA
                (1, 2, 2, 512, 32)]     # long-ish seq


def _qkv(b, h, hkv, s, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [both(rng.standard_normal(shape, dtype=np.float32), dtype)
            for shape in ((b, s, h, dh), (b, s, hkv, dh), (b, s, hkv, dh))]


@pytest.mark.parametrize("b,h,hkv,s,dh", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_and_ref(b, h, hkv, s, dh, dtype, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(b, h, hkv, s, dh, dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    close(got, ref_ops.flash_attention(jq, jk, jv, causal=causal,
                                       block_q=64, block_kv=64,
                                       interpret=True), tol)
    close(got, ref_ref.flash_attention_ref(jq, jk, jv, causal=causal), tol)
    close(ref.flash_attention_ref(tq, tk, tv, causal=causal),
          ref_ref.flash_attention_ref(jq, jk, jv, causal=causal), tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 96), (False, 80)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_blocked_attend(causal, window, dtype):
    """The model's blocked_attend (same kv tile of 64 keys), causal and
    full, with and without a sliding window."""
    b, h, hkv, s, dh = 2, 4, 2, 256, 32
    (jq, tq), (jk, tk), (jv, tv) = _qkv(b, h, hkv, s, dh, dtype, seed=5)
    pos = jnp.arange(s)
    want = ref_attention.blocked_attend(jq, jk, jv, pos, pos, causal,
                                        window, block_q=64, block_kv=64)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    close(got, want, 2e-2 if dtype == "bfloat16" else 2e-5)


def test_flash_block_size_invariance():
    (_, tq), (_, tk), (_, tv) = _qkv(1, 4, 4, 256, 64, "float32", seed=2)
    args = [t.transpose(1, 2).contiguous() for t in (tq, tk, tv)]
    torch.testing.assert_close(fa.flash_attention_plain(*args, block_kv=64),
                               fa.flash_attention_plain(*args, block_kv=32),
                               rtol=1e-5, atol=1e-5)


def test_flash_rejects_ragged():
    q = torch.zeros((1, 100, 4, 64))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, q, q)


# --------------------------------------------------------------- dispatch
def test_cpu_tensors_take_the_plain_version_and_never_launch():
    x = torch.randn(4, 64)
    g = torch.ones(64)
    q = torch.randn(1, 2, 64, 16)
    before = (rn.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"])
    torch.testing.assert_close(rn.rmsnorm(x, g), rn.rmsnorm_plain(x, g))
    torch.testing.assert_close(fa.flash_attention(q, q, q),
                               fa.flash_attention_plain(q, q, q))
    assert (rn.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"]) == before
    # asking for the kernel on CPU tensors raises; it never falls back
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm(x, g, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        rn.rmsnorm(x, g, impl="triton")


# ------------------------------------------------- the tensor-core kernel
@pytest.mark.parametrize("dtype,dh,variant", [
    *[(torch.float32, dh, "simt") for dh in (16, 32, 64, 80, 128, 256)],
    *[(torch.bfloat16, dh, "tc") for dh in (64, 128)],
    *[(torch.bfloat16, dh, "simt") for dh in (16, 32, 80, 256)],
    (torch.bfloat16, 48, None), (torch.float32, 96, None),
    (torch.bfloat16, 512, None), (torch.float16, 128, None),
])
def test_flash_kernel_variant_routing(dtype, dh, variant):
    """bf16 at dh 64 and 128 (the dense models' path) goes to the
    tensor-core kernel; fp32 (TF32 on the tensor cores would break its
    tolerance), bf16 at dh 16/32/256, and bf16 at dh 80 (zamba2's path,
    kept bit-equal to its plain path) to the SIMT kernel; any other pair
    raises."""
    if variant is None:
        with pytest.raises(ValueError, match="dh"):
            fa.kernel_variant(dtype, dh)
    else:
        assert fa.kernel_variant(dtype, dh) == variant


@pytest.mark.parametrize("dtype,dh,force,ok", [
    (torch.bfloat16, 80, "tc", True), (torch.bfloat16, 64, "tc", True),
    (torch.bfloat16, 128, "simt", True), (torch.float32, 128, "simt", True),
    (torch.float32, 80, "tc", False), (torch.bfloat16, 256, "tc", False),
    (torch.bfloat16, 32, "tc", False), (torch.bfloat16, 128, "mma", False),
])
def test_flash_kernel_variant_forced(dtype, dh, force, ok):
    """A forced variant runs if that kernel takes the pair, else raises:
    the tensor-core kernel takes bf16 at dh 64, 80 and 128 only."""
    if ok:
        assert fa.kernel_variant(dtype, dh, force) == force
    else:
        with pytest.raises(ValueError, match="flash kernel"):
            fa.kernel_variant(dtype, dh, force)


TC_WINDOWS = (0, 1, 2, 63, 64, 65, 100, 127, 128, 129, 200, 300)


@pytest.mark.parametrize("sq,sk", [(64, 64), (128, 128), (192, 192),
                                   (320, 320), (512, 512), (128, 384)])
@pytest.mark.parametrize("causal", [True, False])
def test_tc_tile_rules_keep_every_kept_pair(sq, sk, causal):
    """The tensor-core kernel's kv-tile skip rule (``tc_kv_tiles``, per
    128-row query tile) never skips a tile that holds a pair the mask
    keeps, and its mask rule (``tc_tile_masked``, per 64-row warpgroup)
    leaves unmasked only tiles whose every pair is kept and real; with
    Sq == Sk the first and last tiles loaded each hold a kept pair."""
    bq, bk = fa.TC_BLOCK_Q, fa.TC_BLOCK_KV
    rel = np.arange(sq)[:, None] - np.arange(sk)[None, :]
    key_tile = np.arange(sk) // bk
    for window in TC_WINDOWS:
        keep = np.ones((sq, sk), bool)
        if causal:
            keep &= rel >= 0
        if window:
            keep &= rel < window
        for q0 in range(0, sq, bq):
            rows = min(bq, sq - q0)
            tiles = fa.tc_kv_tiles(q0, rows, sk, causal, window)
            needed = set(key_tile[keep[q0:q0 + rows].any(0)].tolist())
            assert needed <= set(tiles), (q0, window, needed, tiles)
            for q_lo in range(q0, q0 + rows, 64):
                for t in tiles:
                    k0 = t * bk
                    if not fa.tc_tile_masked(q_lo, k0, sk, causal, window):
                        assert k0 + bk <= sk
                        assert keep[q_lo:q_lo + 64, k0:k0 + bk].all()
            if sq == sk and len(tiles):
                for t in (tiles[0], tiles[-1]):
                    assert keep[q0:q0 + rows, t * bk:(t + 1) * bk].any()
