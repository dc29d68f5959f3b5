"""The SIMT flash kernel's arithmetic contract, on the CPU.

``csrc/flash_attention.cu`` (the ``"simt"`` variant) equals
``flash_attention_plain`` on the card bit for bit: each score is one fmaf
chain over d, kv tiles are 64 keys, the row sum of p is a fixed tree (keys
``(j, j+32)``, then pairs 16, 8, 4, 2, 1 apart) and pv one fmaf chain over
the tile's keys.  Here numpy spells that order out on bf16 inputs, whose
products are exact in fp32, so a chain step is a multiply and one rounded
add:

* :func:`plain_order` runs every kv tile for all rows at once, with the
  tree of one warp holding two keys a lane (the plain loop's order);
* :func:`kernel_order` runs the kernel's blocks (``simt_block_tile``),
  their kv tiles (``simt_kv_tiles``, skipped tiles and all) and its
  per-lane tree (8 keys a lane up to dh 80, 4 above), zero rows of a
  half-empty query tile included.

The two agree bit for bit.  Both are held against the plain loop on the
CPU and against the JAX reference (the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it; with a window, the model's
``blocked_attend``, which the Pallas kernel lacks) at 2e-2, the bf16
tolerance of ``tests/test_kernels.py``: the CPU's matrix products sum in
another order, and the Pallas kernel keeps p in fp32.  The schedule's
mirrors cover every query tile once, heaviest first, and skip only tiles
the mask drops whole.  ``flash_simt_probe.py`` (the card's side by side
timings) imports no JAX and its design variants edit the kernel's text.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: emulation and kernel vs the plain loop and the reference (bf16 outputs)
TOL = 2e-2


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 (nearest even), as fp32."""
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float() \
        .numpy()


def _chain(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a @ b^T`` over the last axis as one chain per element, in order
    from 0: ``a`` (..., R, D), ``b`` (..., C, D) with fp32-exact
    products."""
    s = np.zeros(a.shape[:-1] + (b.shape[-2],), np.float32)
    for d in range(a.shape[-1]):
        s = s + a[..., :, d, None] * b[..., None, :, d]
    return s


def _warp_tree(p: np.ndarray) -> np.ndarray:
    """The plain loop's row sum over 64 keys: lane l adds keys (l, l+32),
    then the xor butterfly 16, 8, 4, 2, 1."""
    t = p[..., :32] + p[..., 32:]
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        t = t + t[..., lanes ^ off]
    return t[..., 0]


def _lane_tree(p: np.ndarray, tn: int) -> np.ndarray:
    """The kernel's row sum: lane j of 64 / tn holds keys j + L a; it adds
    (a, a + tn/2), then its own pairs tn/4, ..., 1 entries apart, then the
    lanes xor L/2, ..., 1."""
    n_lanes = 64 // tn
    x = p.reshape(p.shape[:-1] + (tn, n_lanes))     # [..., a, j]
    t = x[..., :tn // 2, :] + x[..., tn // 2:, :]
    w = tn // 4
    while w >= 1:
        t = t[..., :w, :] + t[..., w:2 * w, :]
        w //= 2
    t = t[..., 0, :]
    lanes = np.arange(n_lanes)
    off = n_lanes // 2
    while off >= 1:
        t = t + t[..., lanes ^ off]
        off //= 2
    return t[..., 0]


def _online(q, k, v, rows, k_tiles, causal, window, tree):
    """The online softmax of query rows at positions ``rows`` (q (..., R,
    dh)) over the kv tiles starting at ``k_tiles`` (k, v (..., Sk, dh)),
    in the contract's order; the output in fp32."""
    scale = np.float32(fa.softmax_scale(q.shape[-1]))
    m = np.full(q.shape[:-1], -np.inf, np.float32)
    l = np.zeros_like(m)
    acc = np.zeros(q.shape, np.float32)
    for k0 in k_tiles:
        rel = rows[:, None] - np.arange(k0, k0 + fa.BLOCK_KV)[None, :]
        keep = np.ones(rel.shape, bool)
        if causal:
            keep &= rel >= 0
        if window > 0:
            keep &= rel < window
        s = _chain(q, k[..., k0:k0 + fa.BLOCK_KV, :]) * scale
        s = np.where(keep, s, np.float32(fa.MASKED))
        m_new = np.maximum(m, s.max(-1))
        p = np.exp(s - m_new[..., None])
        corr = np.exp(m - m_new)
        l = l * corr + tree(p)
        pv = _chain(_bf16(p), np.swapaxes(v[..., k0:k0 + fa.BLOCK_KV, :],
                                          -1, -2))
        acc = acc * corr[..., None] + pv
        m = m_new
    return acc / np.maximum(l, np.float32(1e-30))[..., None]


def plain_order(q, k, v, causal, window):
    """The contract as the plain loop runs it: (B, H, S, dh) fp32 arrays
    of bf16 values, k and v (B, Hkv, Sk, dh)."""
    g = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    sk = k.shape[2]
    return _online(q, k, v, np.arange(q.shape[2]),
                   range(0, sk, fa.BLOCK_KV), causal, window, _warp_tree)


def kernel_order(q, k, v, causal, window):
    """The contract as the kernel's blocks run it."""
    b_n, h_n, sq, dh = q.shape
    g = h_n // k.shape[1]
    bq = fa.simt_block_q(dh)
    tn = bq // 16
    out = np.full(q.shape, np.nan, np.float32)
    n_blocks = -(-sq // bq) * h_n * b_n
    for block in range(n_blocks):
        q0, rows, h, b = fa.simt_block_tile(block, sq, dh, h_n, b_n)
        qt = np.zeros((bq, dh), np.float32)
        qt[:rows] = q[b, h, q0:q0 + rows]
        tiles = fa.simt_kv_tiles(q0, rows, k.shape[2], causal, window)
        o = _online(qt, k[b, h // g], v[b, h // g], q0 + np.arange(bq),
                    tiles, causal, window, lambda p: _lane_tree(p, tn))
        out[b, h, q0:q0 + rows] = o[:rows]
    return out


def _inputs(b, h, hkv, s, dh, seed):
    rng = np.random.default_rng(seed)
    return [_bf16(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((b, h, s, dh), (b, hkv, s, dh), (b, hkv, s, dh))]


MASKS = [(True, 0), (False, 0), (True, 100), (False, 70)]


@pytest.mark.parametrize("dh", [80, 32, 128])
@pytest.mark.parametrize("causal,window", MASKS[:3])
def test_kernel_order_is_the_plain_order(dh, causal, window):
    """The kernel's tiling (128- or 64-row query tiles, a half-empty last
    one, skipped kv tiles) and its lane-local row-sum tree keep the plain
    loop's order: bit for bit, GQA group 4."""
    q, k, v = _inputs(1, 8, 2, 192, dh, seed=dh)
    got = kernel_order(q, k, v, causal, window)
    want = plain_order(q, k, v, causal, window)
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got, want)


def test_lane_tree_is_the_warp_tree():
    """The per-lane row sum (8 or 4 keys a lane) is the warp's tree bit for
    bit, and a tree in another order is not."""
    rng = np.random.default_rng(7)
    p = np.exp(rng.standard_normal((4096, 64)).astype(np.float32) * 4)
    want = _warp_tree(p)
    for tn in (8, 4):
        np.testing.assert_array_equal(_lane_tree(p, tn), want)
    assert not np.array_equal(p.sum(-1, dtype=np.float32), want)


@pytest.mark.parametrize("dh", [80, 32])
@pytest.mark.parametrize("causal,window", MASKS)
def test_order_matches_plain_loop_and_reference(dh, causal, window):
    """The emulated order against the plain loop (CPU) and the JAX
    reference, GQA group 4, a 128-row query tile half empty."""
    b, h, hkv, s = 1, 8, 2, 192
    q, k, v = _inputs(b, h, hkv, s, dh, seed=10 + dh)
    got = torch.from_numpy(plain_order(q, k, v, causal, window)).bfloat16()
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    plain = fa.flash_attention_plain(tq, tk, tv, causal, window)
    torch.testing.assert_close(got, plain, rtol=TOL, atol=TOL)
    jq, jk, jv = (jnp.asarray(a.transpose(0, 2, 1, 3)).astype(jnp.bfloat16)
                  for a in (q, k, v))
    if window:
        pos = jnp.arange(s)
        ref = ref_attention.blocked_attend(jq, jk, jv, pos, pos, causal,
                                           window, block_q=64, block_kv=64)
    else:
        ref = ref_ops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                      block_kv=64, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sq", [64, 192, 4096])
@pytest.mark.parametrize("dh", [80, 128])
def test_simt_schedule_covers_each_tile_once(sq, dh):
    """The blocks' query tiles cover every (row, head, batch) exactly once,
    and the causal work of a block never grows along the launch order."""
    heads, batch = 3, 2
    bq = fa.simt_block_q(dh)
    n_blocks = -(-sq // bq) * heads * batch
    seen = np.zeros((batch, heads, sq), int)
    work = []
    for block in range(n_blocks):
        q0, rows, h, b = fa.simt_block_tile(block, sq, dh, heads, batch)
        assert q0 % bq == 0 and 0 < rows <= bq and q0 + rows <= sq
        assert rows == bq or q0 + rows == sq
        seen[b, h, q0:q0 + rows] += 1
        work.append(len(fa.simt_kv_tiles(q0, rows, sq, True, 0)))
    assert (seen == 1).all()
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("causal,window", MASKS + [(True, 1), (False, 700)])
def test_simt_kv_tiles_skip_only_dropped_tiles(causal, window):
    """A kv tile is run iff the mask keeps one of its pairs for a row of
    the query tile."""
    sk = 1024
    for q0, rows in ((0, 128), (128, 64), (448, 128), (960, 64), (896, 128)):
        run = set(fa.simt_kv_tiles(q0, rows, sk, causal, window))
        rel = (np.arange(q0, q0 + rows)[:, None]
               - np.arange(sk)[None, :])
        keep = np.ones(rel.shape, bool)
        if causal:
            keep &= rel >= 0
        if window > 0:
            keep &= rel < window
        kept = {k0 for k0 in range(0, sk, fa.BLOCK_KV)
                if keep[:, k0:k0 + fa.BLOCK_KV].any()}
        assert run == kept


def test_simt_tile_pairs_counts_the_blocks():
    """The pairs the kernel computes are its blocks' rows by their kv
    tiles' keys; at zamba2-2.7b's prefill shape, 2.77e8 (2 dh fmaf each)."""
    for sq, dh, causal, window in ((192, 80, True, 0), (320, 128, False, 100),
                                   (4096, 80, True, 0)):
        bq = fa.simt_block_q(dh)
        want = sum(bq * fa.BLOCK_KV * len(fa.simt_kv_tiles(
            q0, min(bq, sq - q0), sq, causal, window))
            for q0 in range(0, sq, bq)) * 6
        assert fa.simt_tile_pairs(sq, sq, dh, 3, 2, causal, window) == want
    assert fa.simt_tile_pairs(4096, 4096, 80, 32, 1, True, 0) == 276_824_064


def test_probe_imports_neither_jax_nor_reference_and_needs_a_gpu():
    """``flash_simt_probe.py`` loads no ``jax`` and no ``repro``, and with
    no CUDA device exits nonzero with no measurement line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    check = ("import sys; sys.path.insert(0, 'src'); import flash_simt_probe;"
             " bad = [k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", check], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = subprocess.run([sys.executable, str(ROOT / "flash_simt_probe.py")],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=120)
    assert proc.returncode != 0
    assert '"probe"' not in proc.stdout


_PROBE_VARIANTS = ("tn4", "tm4", "unroll4", "unroll16", "pv_unroll8",
                   "one_block", "no_exp", "no_scores", "no_pv", "no_stage")


@pytest.mark.parametrize("variant", _PROBE_VARIANTS)
def test_probe_variant_edits_match_the_kernel(monkeypatch, variant):
    """Each of ``flash_simt_probe.py``'s variants and ablations edits
    ``csrc/flash_attention.cu``'s text: every edit matches the source
    exactly once and changes it, so an edit of the kernel that breaks a
    variant fails here, not on the card."""
    monkeypatch.syspath_prepend(str(ROOT))
    import flash_simt_probe

    edits = {**flash_simt_probe.VARIANTS, **flash_simt_probe.ABLATIONS}
    assert sorted(edits) == sorted(["shipped", *_PROBE_VARIANTS])
    text = flash_simt_probe.SOURCE.read_text()
    assert flash_simt_probe.variant_source(text, edits["shipped"]) == text
    assert flash_simt_probe.variant_source(text, edits[variant]) != text
