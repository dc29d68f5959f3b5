"""The tensor-core flash backward's plain twin, tile rules and routing, on
the CPU (the kernel itself runs only on the card:
``tests/test_torch_kernel_cuda.py``).

* ``flash_attention_bwd_plain(..., operands="bf16")`` (p rounded to bf16
  before dv's product, ds before dk's and dq's: the kernel's rounding)
  against ``jax.vjp`` of ``repro.models.attention.blocked_attend``: bf16
  at dh 64, 80 and 128 (the kernel's head dims; 80 is the hybrid and
  encoder families'), GQA groups 1 and 4,
  causal, full and windowed, S=192 (a 64-row last tile of the kernel's
  128-row blocks).  Normwise 2e-2, as the fp32-operand twin is held in
  ``tests/test_torch_kernel_grads.py``:
  the reference rounds p to bf16 before its PV product and its cotangents
  to bf16 at each cast.
* That twin against the fp32-operand twin (the SIMT kernel's arithmetic)
  on the same bf16 inputs: normwise 1e-2, elementwise within ``LM_TOL``'s
  bf16 bar (2e-2 absolute plus 2e-2 relative): the two differ only by the
  bf16 rounding of p and ds (2^-9 relative a term) before sums in fp32.
* The dk/dv pass's query-tile rule (``tc_bwd_q_tiles``) and its mask rule
  (``tc_bwd_tile_masked``), and the dq pass's 64-key tiles
  (``tc_kv_tiles(..., block=64)``), against a brute-force mask: each visits
  exactly the tiles holding a kept pair, and leaves unmasked exactly the
  tiles whose every pair is kept.
* ``BWD_KERNEL_VARIANTS`` and the errors of ``variant=``.
* The card's gradient bar forecast: a small hybrid model whose shared
  attention block runs at dh 80 (zamba2's head dim) gives step-0
  gradients with the bf16-operand twin (the tensor-core kernel's
  arithmetic) within 2e-2 normwise of those with the fp32 twin.
"""

import dataclasses

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ref_attention  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402

BF16_NORMWISE = 2e-2
TWIN_NORMWISE = 1e-2
LM_TOL_BF16 = 2e-2
MASKS = {"causal": (True, 0), "full": (False, 0), "window": (True, 48)}


def _inputs(b, h, hkv, s, dh, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, dh), (b, hkv, s, dh), (b, hkv, s, dh),
                          (b, h, s, dh))]
    return arrs, [torch.as_tensor(a).to(torch.bfloat16) for a in arrs]


def _normwise(got, want):
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm())


TC_CASES = list(itertools.product((64, 80, 128), (1, 4), tuple(MASKS)))


@pytest.mark.parametrize("dh,group,mask", TC_CASES,
                         ids=[f"dh{d}-g{g}-{m}" for d, g, m in TC_CASES])
def test_bf16_twin_matches_jax(dh, group, mask):
    causal, window = MASKS[mask]
    b, hkv, s = 1, 2 if group == 1 else 1, 192
    h = hkv * group
    (q, k, v, do), (qt, kt, vt, dot) = _inputs(b, h, hkv, s, dh, dh + group)
    o = fa.flash_attention_plain(qt, kt, vt, causal, window)
    got = fa.flash_attention_bwd_plain(qt, kt, vt, o, dot, causal, window,
                                       operands="bf16")
    assert all(g.dtype == torch.bfloat16 for g in got)
    sw = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3)).astype(  # noqa
        jnp.bfloat16)
    pos = jnp.arange(s)
    _, vjp = jax.vjp(lambda a, c, e: ref_attention.blocked_attend(
        a, c, e, pos, pos, causal, window), sw(q), sw(k), sw(v))
    for g, want in zip(got, vjp(sw(do))):
        w = np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3)
        assert np.linalg.norm(g.float().numpy() - w) <= \
            BF16_NORMWISE * np.linalg.norm(w)


TWIN_CASES = [((1, 2, 2, 128, 64), "full"), ((1, 4, 1, 192, 64), "causal"),
              ((1, 8, 2, 256, 128), "causal"), ((1, 2, 1, 320, 128), "window"),
              ((2, 4, 2, 192, 128), "full"), ((1, 4, 1, 256, 64), "window")]


@pytest.mark.parametrize("shape,mask", TWIN_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{m}"
                              for s, m in TWIN_CASES])
def test_bf16_twin_against_fp32_twin(shape, mask):
    causal, window = MASKS[mask]
    _, (q, k, v, do) = _inputs(*shape, seed=sum(shape))
    o = fa.flash_attention_plain(q, k, v, causal, window)
    bf = fa.flash_attention_bwd_plain(q, k, v, o, do, causal, window,
                                      operands="bf16")
    f32 = fa.flash_attention_bwd_plain(q, k, v, o, do, causal, window)
    assert torch.equal(f32[0], fa.flash_attention_bwd_plain(
        q, k, v, o, do, causal, window, operands="fp32")[0])
    for a, w in zip(bf, f32):
        assert _normwise(a, w) <= TWIN_NORMWISE
        af, wf = a.float(), w.float()
        assert bool(((af - wf).abs()
                     <= LM_TOL_BF16 + LM_TOL_BF16 * wf.abs()).all())
    # the switch rounds: p and ds in bf16 move the results
    assert any(not torch.equal(a, w) for a, w in zip(bf, f32))


def test_bf16_twin_on_fp32_inputs_rounds_only_p_and_ds():
    """On fp32 inputs the bf16 switch still rounds p and ds alone: with p
    and ds already bf16 values the two twins agree to fp32 rounding."""
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.as_tensor(rng.standard_normal(shape),
                                   dtype=torch.float32)
                   for shape in ((1, 2, 64, 16), (1, 1, 64, 16),
                                 (1, 1, 64, 16), (1, 2, 64, 16)))
    o = fa.flash_attention_plain(q, k, v, True, 0)
    a = fa.flash_attention_bwd_plain(q, k, v, o, do, True, 0,
                                     operands="bf16")
    b = fa.flash_attention_bwd_plain(q, k, v, o, do, True, 0)
    for x, y in zip(a, b):
        assert x.dtype == torch.float32
        assert _normwise(x, y) <= TWIN_NORMWISE
    with pytest.raises(ValueError, match="operands"):
        fa.flash_attention_bwd_plain(q, k, v, o, do, operands="tf32")


def _keep(sq, sk, causal, window):
    rel = np.arange(sq)[:, None] - np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= rel >= 0
    if window:
        keep &= rel < window
    return keep


WINDOWS = (0, 1, 2, 63, 64, 65, 100, 127, 128, 129, 200, 300)


@pytest.mark.parametrize("sq,sk", [(64, 64), (192, 192), (320, 320),
                                   (512, 512), (128, 384), (384, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_dkdv_query_tiles_and_masks_match_brute_force(sq, sk, causal):
    """For each block of 128 keys (64 on a half-full last one), the query
    tiles ``tc_bwd_q_tiles`` names are exactly the 64-row tiles holding a
    pair the mask keeps; per 64-key warpgroup, ``tc_bwd_tile_masked`` is
    False exactly where every pair of the 64 x 64 tile is kept."""
    for window in WINDOWS:
        keep = _keep(sq, sk, causal, window)
        for k0 in range(0, sk, 128):
            keys = min(128, sk - k0)
            tiles = fa.tc_bwd_q_tiles(k0, keys, sq, causal, window)
            needed = [t for t in range(sq // 64)
                      if keep[t * 64:(t + 1) * 64, k0:k0 + keys].any()]
            assert list(tiles) == needed, (k0, window, tiles, needed)
            for kw0 in range(k0, k0 + keys, 64):
                for q0 in range(0, sq, 64):
                    whole = keep[q0:q0 + 64, kw0:kw0 + 64].all()
                    assert fa.tc_bwd_tile_masked(q0, kw0, causal,
                                                 window) == (not whole)


@pytest.mark.parametrize("sq,sk", [(64, 64), (192, 192), (320, 320),
                                   (128, 384)])
@pytest.mark.parametrize("causal", [True, False])
def test_dq_kv_tiles_match_brute_force(sq, sk, causal):
    """The dq pass walks kv tiles of 64 keys for each block of 128 query
    rows (64 on a half-full last one): ``tc_kv_tiles(..., block=64)``
    names exactly the tiles holding a kept pair when Sq == Sk, and never
    skips one otherwise."""
    for window in WINDOWS:
        keep = _keep(sq, sk, causal, window)
        for q0 in range(0, sq, 128):
            rows = min(128, sq - q0)
            tiles = fa.tc_kv_tiles(q0, rows, sk, causal, window, block=64)
            needed = [t for t in range(sk // 64)
                      if keep[q0:q0 + rows, t * 64:(t + 1) * 64].any()]
            assert set(needed) <= set(tiles)
            if sq == sk:
                assert list(tiles) == needed, (q0, window, tiles, needed)


def test_bwd_kernel_variants_table():
    """bf16 at dh 64, 80 and 128 goes to the tensor-core backward; fp32
    and every other head dim to the SIMT one.  The forward keeps bf16 at
    dh 80 on the SIMT kernel (zamba2's logits stay bit-equal to plain)."""
    assert fa.TC_BWD_HEAD_DIMS == (64, 80, 128)
    assert set(fa.BWD_KERNEL_VARIANTS) == {
        (dt, dh) for dt in (torch.float32, torch.bfloat16)
        for dh in fa.HEAD_DIMS}
    for (dtype, dh), variant in fa.BWD_KERNEL_VARIANTS.items():
        want = ("tc" if dtype == torch.bfloat16 and dh in (64, 80, 128)
                else "simt")
        assert variant == want, (dtype, dh)
        assert fa.bwd_kernel_variant(dtype, dh) == want
        assert fa.bwd_kernel_variant(dtype, dh, "simt") == "simt"
    assert fa.BWD_KERNEL_VARIANTS[(torch.bfloat16, 80)] == "tc"
    assert fa.KERNEL_VARIANTS[(torch.bfloat16, 80)] == "simt"
    assert fa.bwd_kernel_variant(torch.bfloat16, 80, "tc") == "tc"
    assert "flash_attention_bwd_tc" in fa.LAUNCHES


@pytest.mark.parametrize("dtype,dh,variant,match", [
    (torch.float32, 128, "tc", "tensor-core"),
    (torch.bfloat16, 256, "tc", "tensor-core"),
    (torch.bfloat16, 32, "tc", "tensor-core"),
    (torch.float32, 80, "tc", "tensor-core"),
    (torch.bfloat16, 128, "wgmma", "unknown"),
    (torch.bfloat16, 48, None, "dh in"),
    (torch.float16, 64, None, "float32 or"),
])
def test_bwd_kernel_variant_errors(dtype, dh, variant, match):
    with pytest.raises(ValueError, match=match):
        fa.bwd_kernel_variant(dtype, dh, variant)


def test_bwd_cuda_wrapper_rejects_cpu_tensors_and_bad_variants():
    """The wrapper checks before it builds anything: CPU tensors and a
    variant the pair cannot take raise, and no launch is counted."""
    _, (q, k, v, do) = _inputs(1, 2, 1, 64, 64, 3)
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, k, v, q, do, variant="tc")
    assert dict(fa.LAUNCHES) == before


def test_hybrid_dh80_grads_with_bf16_twin_within_the_card_bar():
    """The hybrid smoke model (4 Mamba2 layers, the shared attention block
    twice) with its attention at dh 80, bf16, S=2048 (the flash path),
    remat on: one loss and backward with the backward's plain twin at
    ``operands="bf16"`` (what the tensor-core kernel computes) and one at
    ``"fp32"`` (the SIMT kernel's).  The forward is the same, so the
    losses are equal; every gradient stays within the card's 2e-2
    normwise bar (``chip_smoke.py``'s step 0 of zamba2, MODEL_REL_TOL)."""
    cfg = dataclasses.replace(get_smoke("zamba2-2.7b"), head_dim=80,
                              dtype="bfloat16", param_dtype="bfloat16",
                              remat=True)
    model = init_params(cfg, torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    gen = torch.Generator().manual_seed(1)
    batch = {key: torch.randint(0, cfg.vocab, (1, 2048), generator=gen)
             for key in ("tokens", "labels")}
    plain, runs, seen = fa.flash_attention_bwd_plain, {}, []
    for operands in ("fp32", "bf16"):
        def twin(*args, operands=operands, **kwargs):
            seen.append(operands)
            return plain(*args, **kwargs, operands=operands)

        fa.flash_attention_bwd_plain = twin
        try:
            loss, _ = loss_fn(cfg, model, batch)
            loss.backward()
        finally:
            fa.flash_attention_bwd_plain = plain
        runs[operands] = (float(loss.detach()),
                          {n: p.grad.clone()
                           for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
    assert seen == ["fp32"] * 2 + ["bf16"] * 2     # the block's two uses
    assert runs["bf16"][0] == runs["fp32"][0]
    for name, g in runs["bf16"][1].items():
        w = runs["fp32"][1][name].double()
        assert float((g.double() - w).norm()) <= 2e-2 * float(w.norm()), \
            name
