"""The port's xLSTM cells and the xLSTM LM (xlstm-350m) against the JAX
reference.

Cells, from numpy inputs: the mLSTM's parallel and chunked forms (the
chunk a parameter, so small ``S`` reaches the chunked loop), its block
``forward`` on both paths and its O(1) ``decode`` over several steps,
the sLSTM's ``forward`` and ``decode``, each against ``repro.models.
xlstm`` at rtol = atol = 1e-4 in fp32; the counterparts of
``tests/test_ssm_xlstm.py::TestMLSTM`` / ``TestMLSTMChunked`` on the
port (parallel vs the naive stabilised recurrence, forward vs decode,
chunked vs parallel, chunk-size invariance).  The model (smoke config:
2 super-blocks of one mLSTM and one sLSTM layer, the JAX parameters
carried across by ``convert.params_from_reference``): ``forward`` logits
at S=16 (parallel mLSTM) and S=512 (chunked, the reference's path
choice) in fp32; the cache layout and types (``mm``/``sm`` at -1e30);
``decode_step`` logits and all eight cache leaves over six steps in
fp32; decode against ``forward``; greedy tokens of ``ServeEngine`` equal
to the JAX ``ServeEngine``'s, the engine's prefill writing the cache
leaves in place; ``2 L + 1`` RMSNorm launch sites and no flash attention.

bf16 is held cell by cell (each cell's forward at the normwise 2e-2 of
``tests/test_torch_model.py``: 0.3-0.9% from the reference), not for the
whole model: on this config the reference's own bf16 logits sit 3.0-3.6%
normwise from its fp32 logits on the same weights (the port's 2.4-3.0%),
and its jitted and eager bf16 forwards 1.4% from each other, so the
model's bf16 rounding alone exceeds a 2e-2 bar between the two packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro.models import xlstm as ref_xlstm  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import (cache_from_reference,  # noqa: E402
                                 mlstm_from_reference, params_from_reference,
                                 slstm_from_reference)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models import XLSTMLM, model, xlstm  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

ARCH = "xlstm-350m"
F32 = 1e-4
BF16 = 2e-2


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def close(got, want, tol=F32):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def normwise(got, want, tol=BF16):
    g, w = f32(got), f32(want)
    assert np.linalg.norm(g - w) <= tol * np.linalg.norm(w)


def smoke(dtype="float32"):
    cfg, port = ref_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    if dtype != "float32":
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
        port = dataclasses.replace(port, dtype=dtype, param_dtype=dtype)
    return cfg, port


def cell_inputs(s, b=2, h=3, dh=8, seed=7):
    """q, k, v ``(B, S, H, dh)`` and gates ``(B, S, H)`` as the reference
    tests draw them (forget gates mostly open)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    log_i = rng.normal(size=(b, s, h)).astype(np.float32)
    log_f = np.log(1 / (1 + np.exp(
        -rng.normal(size=(b, s, h)).astype(np.float32) - 2)))
    return q, k, v, log_i, log_f.astype(np.float32)


def naive_mlstm(q, k, v, log_i, log_f):
    """Oracle stabilised recurrence (xLSTM paper eqs. 19-27), float64."""
    b, s, h, dh = q.shape
    c = np.zeros((b, h, dh, dh))
    n = np.zeros((b, h, dh))
    m = np.full((b, h), -np.inf)
    outs = []
    qs = np.asarray(q, np.float64) / np.sqrt(dh)
    for t in range(s):
        m_new = np.maximum(log_f[:, t] + m, log_i[:, t])
        i_g = np.exp(log_i[:, t] - m_new)
        f_g = np.exp(log_f[:, t] + m - m_new)
        c = f_g[..., None, None] * c + i_g[..., None, None] * \
            np.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        n = f_g[..., None] * n + i_g[..., None] * k[:, t]
        m = m_new
        num = np.einsum("bhk,bhkv->bhv", qs[:, t], c)
        den = np.maximum(np.abs(np.einsum("bhk,bhk->bh", qs[:, t], n)),
                         np.exp(-m))
        outs.append(num / den[..., None])
    return np.stack(outs, axis=1)


def t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture
def counts(monkeypatch):
    """Calls of each LM kernel's dispatch (the launch sites on the card)."""
    seen = {"rmsnorm": 0, "flash_attention": 0}
    for mod, name in ((rn, "rmsnorm"), (fa, "flash_attention")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            seen[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return seen


# ------------------------------------------------------------ mLSTM cells
@pytest.mark.parametrize("s", [1, 16, 48])
def test_mlstm_parallel_matches_reference(s):
    args = cell_inputs(s)
    close(xlstm._mlstm_cell_parallel(*t(*args)),
          ref_xlstm._mlstm_cell_parallel(*j(*args)))


@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (48, 16), (40, 16),
                                     (512, 256)])
def test_mlstm_chunked_matches_reference(s, chunk):
    """The chunked loop (``S`` not a multiple of the chunk: the parallel
    fallback, as in the reference)."""
    args = cell_inputs(s)
    close(xlstm._mlstm_cell_chunked(*t(*args), chunk=chunk),
          ref_xlstm._mlstm_cell_chunked(*j(*args), chunk=chunk))


def test_parallel_matches_recurrence():
    """TestMLSTM's oracle check, on the port."""
    b, s, h, dh = 2, 16, 2, 8
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    log_i = rng.normal(size=(b, s, h)).astype(np.float32)
    log_f = np.log(1 / (1 + np.exp(-rng.normal(
        size=(b, s, h)).astype(np.float32) - 2))).astype(np.float32)
    got = xlstm._mlstm_cell_parallel(*t(q, k, v, log_i, log_f))
    np.testing.assert_allclose(f32(got), naive_mlstm(q, k, v, log_i, log_f),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (48, 16)])
def test_chunked_matches_parallel(s, chunk):
    """TestMLSTMChunked's check, on the port."""
    args = t(*cell_inputs(s))
    close(xlstm._mlstm_cell_chunked(*args, chunk=chunk),
          xlstm._mlstm_cell_parallel(*args), 2e-3)


def test_chunk_size_invariance():
    args = t(*cell_inputs(64))
    close(xlstm._mlstm_cell_chunked(*args, chunk=8),
          xlstm._mlstm_cell_chunked(*args, chunk=32))


def _ref_mlstm(seed=0, d=32, h=2):
    return ref_xlstm.mlstm_init(jax.random.PRNGKey(seed), d, h, 2.0, 4,
                                jnp.float32)


@pytest.mark.parametrize("s", [10, 512])
def test_mlstm_forward_matches_reference(s):
    """S=10: the parallel form; S=512: the chunked form (both packages
    choose it at S >= 512, S a multiple of 256)."""
    p = _ref_mlstm()
    x = np.random.default_rng(s).standard_normal((2, s, 32), np.float32)
    close(xlstm.mlstm_forward(mlstm_from_reference(p, torch.float32),
                              torch.from_numpy(x), 2),
          ref_xlstm.mlstm_forward(p, jnp.asarray(x), 2))


def test_mlstm_decode_matches_reference():
    """Six steps from the zero state: outputs and every state leaf."""
    p = _ref_mlstm(1)
    tp = mlstm_from_reference(p, torch.float32)
    x = np.random.default_rng(2).standard_normal((2, 6, 32), np.float32)
    state = {"C": jnp.zeros((2, 2, 32, 32)), "n": jnp.zeros((2, 2, 32)),
             "m": jnp.full((2, 2), -1e30), "conv": jnp.zeros((2, 3, 64))}
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    for i in range(6):
        want, state = ref_xlstm.mlstm_decode(p, jnp.asarray(x[:, i:i + 1]),
                                             state, 2)
        got, tstate = xlstm.mlstm_decode(tp, torch.from_numpy(
            x[:, i:i + 1].copy()), tstate, 2)
        close(got, want)
        for k in state:
            close(tstate[k], state[k])


def test_block_forward_decode_consistency():
    """TestMLSTM's forward-vs-decode check, on the port."""
    d, s, b, h = 32, 10, 2, 2
    p = xlstm.mlstm_init(torch.Generator().manual_seed(0), d, h, 2.0, 4,
                         torch.float32)
    x = torch.randn((b, s, d), generator=torch.Generator().manual_seed(2))
    full = xlstm.mlstm_forward(p, x, h)
    state = {"C": torch.zeros((b, h, 32, 32)), "n": torch.zeros((b, h, 32)),
             "m": torch.full((b, h), -1e30), "conv": torch.zeros((b, 3, 64))}
    outs = []
    for i in range(s):
        o, state = xlstm.mlstm_decode(p, x[:, i:i + 1], state, h)
        outs.append(o)
    close(torch.cat(outs, dim=1), full, 2e-3)


# ------------------------------------------------------------ sLSTM cells
def _ref_slstm(seed=0, d=32, h=4):
    return ref_xlstm.slstm_init(jax.random.PRNGKey(seed), d, h, 4.0 / 3.0,
                                jnp.float32)


def test_slstm_forward_matches_reference():
    p = _ref_slstm()
    x = np.random.default_rng(3).standard_normal((2, 24, 32), np.float32)
    close(xlstm.slstm_forward(slstm_from_reference(p, torch.float32),
                              torch.from_numpy(x), 4),
          ref_xlstm.slstm_forward(p, jnp.asarray(x), 4))


def test_slstm_decode_matches_reference_and_forward():
    """Six steps from the zero state against the reference's decode (out
    and state) and the port's own forward."""
    p = _ref_slstm(1)
    tp = slstm_from_reference(p, torch.float32)
    x = np.random.default_rng(4).standard_normal((2, 6, 32), np.float32)
    state = {"c": jnp.zeros((2, 4, 8)), "n": jnp.zeros((2, 4, 8)),
             "h": jnp.zeros((2, 4, 8)), "m": jnp.full((2, 4), -1e30)}
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    outs = []
    for i in range(6):
        want, state = ref_xlstm.slstm_decode(p, jnp.asarray(x[:, i:i + 1]),
                                             state, 4)
        got, tstate = xlstm.slstm_decode(tp, torch.from_numpy(
            x[:, i:i + 1].copy()), tstate, 4)
        close(got, want)
        for k in state:
            close(tstate[k], state[k])
        outs.append(got)
    close(torch.cat(outs, 1), xlstm.slstm_forward(tp, torch.from_numpy(x), 4),
          1e-5)


def test_cells_keep_fp32_leaves():
    """w_if, b_if, r and b stay fp32 in a bf16 model, as the reference
    keeps them; the port's init has the carried cells' names, shapes and
    types."""
    for make, ref, conv, fp32 in (
            (lambda g: xlstm.mlstm_init(g, 32, 2, 2.0, 4, torch.bfloat16),
             ref_xlstm.mlstm_init(jax.random.PRNGKey(0), 32, 2, 2.0, 4,
                                  jnp.bfloat16),
             mlstm_from_reference, {"w_if", "b_if"}),
            (lambda g: xlstm.slstm_init(g, 32, 4, 4.0 / 3.0, torch.bfloat16),
             ref_xlstm.slstm_init(jax.random.PRNGKey(0), 32, 4, 4.0 / 3.0,
                                  jnp.bfloat16),
             slstm_from_reference, {"r", "b"})):
        got = conv(ref, torch.bfloat16)
        for name, leaf in got.named_parameters():
            assert leaf.dtype == (torch.float32 if name in fp32
                                  else torch.bfloat16), name
            np.testing.assert_array_equal(f32(leaf), f32(ref[name]))
        mine = make(torch.Generator().manual_seed(0))
        assert [(n, p.shape, p.dtype) for n, p in mine.named_parameters()] \
            == [(n, p.shape, p.dtype) for n, p in got.named_parameters()]


# ------------------------------------------------------------------ model
def test_superblocks():
    _, port = smoke()
    assert model.superblock_shape(port) == (2, 1)
    assert model.superblock_shape(configs.get_config(ARCH)) == (3, 7)
    with pytest.raises(ValueError, match="must divide by slstm_every"):
        model.superblock_shape(dataclasses.replace(port, n_layers=5))


@pytest.mark.parametrize("s", [16, 512])
def test_forward_matches(s, counts):
    """S=16: the mLSTM's parallel form; S=512: its chunked form."""
    cfg, port = smoke()
    params = ref_models.init_params(cfg, jax.random.PRNGKey(s))
    tokens = np.random.default_rng(s).integers(0, cfg.vocab, (2, s))
    want, _ = ref_models.forward(cfg, params, {"tokens": jnp.asarray(tokens)})
    tparams = params_from_reference(port, params)
    assert isinstance(tparams, XLSTMLM)
    got, aux = model.forward(port, tparams,
                             {"tokens": torch.from_numpy(tokens)})
    assert float(aux) == 0.0 and got.shape == (2, s, cfg.vocab)
    close(got, want)
    assert counts == {"rmsnorm": 2 * cfg.n_layers + 1, "flash_attention": 0}


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cells_bf16_match_reference(cell):
    """bf16 cells against the reference's jitted bf16 cells, normwise at
    2e-2 (see the module doc for the whole model in bf16)."""
    x = np.random.default_rng(0).standard_normal((2, 24, 64), np.float32)
    if cell == "mlstm":
        p = ref_xlstm.mlstm_init(jax.random.PRNGKey(0), 64, 2, 2.0, 4,
                                 jnp.bfloat16)
        tp = mlstm_from_reference(p, torch.bfloat16)
        ref_fwd, fwd = ref_xlstm.mlstm_forward, xlstm.mlstm_forward
    else:
        p = ref_xlstm.slstm_init(jax.random.PRNGKey(0), 64, 2, 4.0 / 3.0,
                                 jnp.bfloat16)
        tp = slstm_from_reference(p, torch.bfloat16)
        ref_fwd, fwd = ref_xlstm.slstm_forward, xlstm.slstm_forward
    want = jax.jit(lambda p, x: ref_fwd(p, x, 2))(
        p, jnp.asarray(x, jnp.bfloat16))
    got = fwd(tp, torch.from_numpy(x).to(torch.bfloat16), 2)
    assert got.dtype == torch.bfloat16
    normwise(got, want)


def test_cache_layout_matches_reference():
    for dtype in ("float32", "bfloat16"):
        cfg, port = smoke(dtype)
        want = ref_models.init_cache(cfg, 3, 16)
        got = model.init_cache(port, 3, 16, "cpu")
        assert tuple(got) == model.XLSTM_CACHE == tuple(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name, k
            np.testing.assert_array_equal(f32(got[k]), f32(want[k]))
        assert float(got["mm"].max()) == float(got["sm"].min()) == \
            float(np.float32(-1e30))


def test_decode_step_matches(counts):
    """Six decode steps from the initial cache: logits and all eight cache
    leaves after each (fp32)."""
    cfg, port = smoke()
    params = ref_models.init_params(cfg, jax.random.PRNGKey(3))
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 6))
    cache = ref_models.init_cache(cfg, 2, 8)
    tcache = cache_from_reference(cache)
    tparams = params_from_reference(port, params)
    step = jax.jit(lambda p, c, t, i: ref_models.decode_step(cfg, p, c, t, i))
    for i in range(tokens.shape[1]):
        want, cache = step(params, cache, jnp.asarray(tokens[:, i:i + 1]),
                           jnp.int32(i))
        got, tcache = model.decode_step(
            port, tparams, tcache, torch.from_numpy(tokens[:, i:i + 1]), i)
        close(got, want)
        for name in model.XLSTM_CACHE:
            close(tcache[name], cache[name])
    assert counts == {"rmsnorm": 6 * (2 * cfg.n_layers + 1),
                      "flash_attention": 0}


def test_decode_consistent_with_forward():
    _, port = smoke()
    params = model.init_params(port, torch.Generator().manual_seed(4))
    tokens = torch.from_numpy(
        np.random.default_rng(8).integers(0, port.vocab, (2, 8)))
    full, _ = model.forward(port, params, {"tokens": tokens})
    cache = model.init_cache(port, 2, 8, "cpu")
    for i in range(8):
        got, cache = model.decode_step(port, params, cache,
                                       tokens[:, i:i + 1], i)
        close(got[:, 0], full[:, i], 2e-3)


def test_greedy_tokens_equal_reference():
    cfg, port = smoke()
    params = ref_models.init_params(cfg, jax.random.PRNGKey(0))
    prompts = np.array([[5, 6, 7, 8, 9], [9, 10, 11, 12, 13]], np.int32)
    want = RefEngine(cfg, params, max_seq=32, max_batch=2).generate(
        prompts, max_new=8)
    engine = ServeEngine(port, params_from_reference(port, params),
                         max_seq=32, max_batch=2, device="cpu")
    got = engine.generate(prompts, max_new=8)
    np.testing.assert_array_equal(got.new_tokens, want.new_tokens)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_engine_prefill_writes_the_cache_in_place():
    """The engine's prefill (decode steps over the prompt) leaves every
    xLSTM cache leaf in the tensor it allocated, filled: the same storage
    as a fresh cache's layout, with the states the steps wrote."""
    _, port = smoke()
    params = model.init_params(port, torch.Generator().manual_seed(5))
    engine = ServeEngine(port, params, max_seq=16, max_batch=2,
                         device="cpu")
    allocated = []
    real = model.init_cache

    def spy(*a, **k):
        allocated.append(real(*a, **k))
        return allocated[-1]

    import repro_torch.serving.engine as eng
    eng_init, eng.init_cache = eng.init_cache, spy
    try:
        cache, _ = engine.prefill(np.array([[3, 4, 5, 6]], np.int32))
    finally:
        eng.init_cache = eng_init
    assert cache is allocated[0]
    fresh = model.init_cache(port, 1, 16, "cpu")
    for name in model.XLSTM_CACHE:
        assert not torch.equal(cache[name], fresh[name]), name
    ref = model.init_cache(port, 1, 16, "cpu")
    with torch.inference_mode():
        for i, tok in enumerate((3, 4, 5, 6)):
            model.decode_step(port, params, ref, torch.tensor([[tok]]), i)
    for name in model.XLSTM_CACHE:
        assert torch.equal(cache[name], ref[name]), name
