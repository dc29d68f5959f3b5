"""The port's MoE FFN and MoE LMs (moonshot-v1-16b-a3b, arctic-480b)
against the JAX reference.

``moe_ffn`` (output and auxiliary loss) against ``repro.models.moe`` at
rtol = atol = 1e-4 in fp32 and the normwise 2e-2 of
``tests/test_torch_model.py`` in bf16, with and without capacity drops
and with Arctic's dense branch.  The routing is held exactly: the experts
against the reference's ``jax.lax.top_k``, each choice's slot and keep
flag against a numpy transcription of the reference's per-choice loop
(ranks within each choice plus the running ``base`` count); the drop
cases assert that some choices are dropped.  The counterparts of
``tests/test_attention_moe.py::TestMoE`` run on the port.  Whole models
(smoke configs, the JAX parameters carried across by
``convert.params_from_reference``): ``forward`` logits and the summed
auxiliary loss, ``decode_step`` logits and the KV cache, decode against
``forward`` at capacity factor 8 (no drops, as
``tests/test_models_smoke.py`` does), greedy tokens of ``ServeEngine``
equal to the JAX ``ServeEngine``'s, and the kernels' launch sites (``2 L
+ 1`` RMSNorms, ``L`` flash launches at S >= 2048).

Whole MoE models are held in fp32 only.  In bf16 a token's top-k
choices flip wherever a bf16 rounding of the residual stream moves a
router logit across a near-tie, and then that token's output changes
by a whole expert's share: the reference's own jitted and eager bf16
``forward`` of the moonshot smoke model (``PRNGKey(0)``) differ by 7.2%
normwise, over the 2e-2 bar, so a bf16 whole-model bound would measure
XLA's fusion choices rather than the port.  ``moe_ffn`` itself is held
in bf16 (one layer, no flip at that size).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import (cache_from_reference,  # noqa: E402
                                 moe_from_reference, params_from_reference)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models import DenseLM, model, moe  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

F32 = 1e-4
BF16 = 2e-2
MOE = ["moonshot-v1-16b-a3b", "arctic-480b"]
KEY = jax.random.PRNGKey(0)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def close(got, want, tol=F32):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def normwise(got, want, tol=BF16):
    g, w = f32(got), f32(want)
    assert np.linalg.norm(g - w) <= tol * np.linalg.norm(w)


def smoke(arch, dtype="float32", **moe_kw):
    cfg, port = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    out = []
    for c in (cfg, port):
        if dtype != "float32":
            c = dataclasses.replace(c, dtype=dtype, param_dtype=dtype)
        if moe_kw:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe,
                                                               **moe_kw))
        out.append(c)
    return tuple(out)


def ref_routing(router, x, e, k, cf):
    """The reference's routing, its per-choice loop in numpy: (gate_idx,
    pos, keep), each (B, S, k)."""
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                                      router), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    idx = np.asarray(idx)
    b, s, _ = idx.shape
    cap = ref_moe.capacity(s, e, k, cf)
    base = np.zeros((b, e), np.int64)
    pos, keep = [], []
    for j in range(k):
        onehot = np.eye(e, dtype=np.int64)[idx[..., j]]        # (B,S,E)
        ranks = np.cumsum(onehot, axis=1) - 1 + base[:, None, :]
        pos_j = np.sum(ranks * onehot, axis=2)
        keep.append(pos_j < cap)
        pos.append(np.where(pos_j < cap, pos_j, cap - 1))
        base = base + onehot.sum(axis=1)
    return idx, np.stack(pos, -1), np.stack(keep, -1)


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


# -------------------------------------------------------------- moe_ffn
@pytest.mark.parametrize("tokens,e,k,cf,want", [
    (4096, 128, 2, 1.25, 80), (8, 64, 2, 1.0, 8), (4096, 64, 6, 1.25, 480),
    (1, 64, 6, 1.25, 8), (16, 8, 3, 1.25, 8), (64, 2, 1, 0.25, 8),
    (100, 3, 2, 1.3, 88)])
def test_capacity_matches_reference(tokens, e, k, cf, want):
    assert moe.capacity(tokens, e, k, cf) == \
        ref_moe.capacity(tokens, e, k, cf) == want


@pytest.mark.parametrize("case", ["no_drops", "drops", "heavy_drops",
                                  "dense_branch"])
def test_moe_ffn_matches_reference(case):
    """Output and aux at 1e-4 (fp32); routing exactly: experts, slots,
    keep flags (some false in the drop cases)."""
    d, ff, e, k, cf, dense = {"no_drops": (16, 24, 4, 2, 8.0, 0),
                              "drops": (16, 24, 8, 3, 1.0, 0),
                              "heavy_drops": (12, 20, 4, 2, 0.25, 0),
                              "dense_branch": (16, 24, 4, 2, 1.25, 20)}[case]
    params = ref_moe.moe_init(jax.random.PRNGKey(3), d, ff, e, jnp.float32,
                              dense)
    x = np.random.default_rng(4).standard_normal((2, 40, d), np.float32)
    want, want_aux = ref_moe.moe_ffn(params, jnp.asarray(x), n_experts=e,
                                     top_k=k, capacity_factor=cf)
    port = moe_from_reference(params, torch.float32)
    assert (port.dense is None) == (dense == 0)
    got, aux = moe.moe_ffn(port, torch.from_numpy(x), n_experts=e, top_k=k,
                           capacity_factor=cf)
    close(got, want)
    close(aux, want_aux, 1e-5)
    r = moe.route(port.router, torch.from_numpy(x), n_experts=e, top_k=k,
                  capacity_factor=cf)
    idx, pos, keep = ref_routing(params["router"], jnp.asarray(x), e, k, cf)
    np.testing.assert_array_equal(r.gate_idx.numpy(), idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert r.capacity == ref_moe.capacity(40, e, k, cf)
    if case == "no_drops":
        assert keep.all()
    if case in ("drops", "heavy_drops"):
        assert (~keep).sum() >= 4


def test_moe_ffn_bf16_matches_reference():
    d, ff, e, k = 32, 48, 8, 3
    params = ref_moe.moe_init(jax.random.PRNGKey(5), d, ff, e, jnp.bfloat16,
                              24)
    x = np.random.default_rng(6).standard_normal((2, 24, d), np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, want_aux = ref_moe.moe_ffn(params, xb, n_experts=e, top_k=k,
                                     capacity_factor=1.25)
    port = moe_from_reference(params, torch.bfloat16)
    assert port.router.dtype == torch.float32
    assert port.wi.dtype == port.dense.wi.dtype == torch.bfloat16
    got, aux = moe.moe_ffn(port, torch.from_numpy(x).to(torch.bfloat16),
                           n_experts=e, top_k=k, capacity_factor=1.25)
    assert got.dtype == torch.bfloat16
    normwise(got, want)
    close(aux, want_aux, 1e-4)


# --------------------------------------- counterparts of TestMoE (port)
def _port_moe(seed, d, ff, e):
    return moe.moe_init(torch.Generator().manual_seed(seed), d, ff, e,
                        torch.float32)


def test_capacity_formula():
    assert moe.capacity(tokens=4096, n_experts=128, top_k=2,
                        capacity_factor=1.25) == 80
    assert moe.capacity(8, 64, 2, 1.0) == 8  # floor + x8 rounding


def test_all_tokens_routed_with_big_capacity():
    """Generous capacity drops nothing: every token's output is a
    non-zero mix of expert outputs, and aux >= 1 (1 when balanced)."""
    d, ff, e, k = 16, 32, 4, 2
    p = _port_moe(0, d, ff, e)
    x = torch.randn((2, 16, d), generator=torch.Generator().manual_seed(1))
    out, aux = moe.moe_ffn(p, x, n_experts=e, top_k=k, capacity_factor=8.0)
    assert out.shape == x.shape
    assert float(out.abs().sum(-1).min()) > 0
    assert float(aux) >= 1.0 - 1e-5
    assert bool(moe.route(p.router, x, n_experts=e, top_k=k,
                          capacity_factor=8.0).keep.all())


def test_capacity_drops_reduce_output():
    """Tiny capacity drops tokens: a dropped token's output row is zero
    (the residual passes through at the block level)."""
    d, ff, e, k = 8, 16, 2, 1
    p = _port_moe(0, d, ff, e)
    x = torch.randn((1, 64, d), generator=torch.Generator().manual_seed(2))
    full, _ = moe.moe_ffn(p, x, n_experts=e, top_k=k, capacity_factor=8.0)
    tight, _ = moe.moe_ffn(p, x, n_experts=e, top_k=k, capacity_factor=0.25)
    zero = tight.abs().sum(-1) < 1e-9
    assert int(zero.sum()) > 0
    assert float(full.abs().max()) > 0
    keep = moe.route(p.router, x, n_experts=e, top_k=k,
                     capacity_factor=0.25).keep[..., 0]
    assert torch.equal(zero, ~keep)


def test_moe_init_draws_one_expert_at_a_time():
    """Same seed, same weights; shapes and types of the reference's
    leaves; each expert's own draw (no two experts equal)."""
    a = moe.moe_init(torch.Generator().manual_seed(0), 8, 12, 4,
                     torch.bfloat16, 6)
    b = moe.moe_init(torch.Generator().manual_seed(0), 8, 12, 4,
                     torch.bfloat16, 6)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    ref = moe_from_reference(ref_moe.moe_init(KEY, 8, 12, 4, jnp.bfloat16, 6),
                             torch.bfloat16)
    assert [(n, p.shape, p.dtype) for n, p in a.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in ref.named_parameters()]
    assert not torch.equal(a.wi[0], a.wi[1])


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("arch", MOE)
def test_forward_matches(arch, counts):
    """Logits and the summed auxiliary loss (capacity drops included:
    the smoke configs' 16-token groups drop choices), in fp32 (see the
    module doc for bf16)."""
    cfg, port = smoke(arch)
    params = ref_models.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    want, want_aux = ref_models.forward(cfg, params,
                                        {"tokens": jnp.asarray(tokens)})
    tparams = params_from_reference(port, params)
    assert isinstance(tparams, DenseLM)
    got, aux = model.forward(port, tparams,
                             {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and float(aux) > 0
    close(got, want)
    close(aux, want_aux, 1e-5)
    assert counts == {"rmsnorm": 2 * cfg.n_layers + 1, "flash_attention": 0}


def test_forward_blocked_path_matches(counts):
    """S=2048: every layer's attention on the blocked (flash) path at a
    GQA group of 4 (arctic's smoke config), against the eager reference."""
    cfg, port = smoke("arctic-480b")
    params = ref_models.init_params(cfg, jax.random.PRNGKey(1))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (1, 2048))
    with jax.disable_jit():
        want, want_aux = ref_models.forward(cfg, params,
                                            {"tokens": jnp.asarray(tokens)})
    got, aux = model.forward(port, params_from_reference(port, params),
                             {"tokens": torch.from_numpy(tokens)})
    close(got, want)
    close(aux, want_aux, 1e-5)
    assert counts == {"rmsnorm": 2 * cfg.n_layers + 1,
                      "flash_attention": cfg.n_layers}


@pytest.mark.parametrize("arch", MOE)
def test_decode_step_matches(arch, counts):
    """Six decode steps from an empty cache: logits at every step and the
    KV cache after each (fp32)."""
    cfg, port = smoke(arch)
    params = ref_models.init_params(cfg, jax.random.PRNGKey(2))
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
        for name in ("k", "v"):
            close(tcache[name], cache[name])
    assert counts == {"rmsnorm": 6 * (2 * cfg.n_layers + 1),
                      "flash_attention": 0}


@pytest.mark.parametrize("arch", MOE)
def test_decode_consistent_with_forward(arch):
    """At capacity factor 8 nothing drops, so decode reproduces forward
    position by position (the reference's check; drops differ between
    the 16-token and the 1-token groups otherwise)."""
    _, port = smoke(arch, capacity_factor=8.0)
    params = model.init_params(port, torch.Generator().manual_seed(3))
    tokens = torch.from_numpy(
        np.random.default_rng(7).integers(0, port.vocab, (2, 8)))
    full, _ = model.forward(port, params, {"tokens": tokens})
    cache = model.init_cache(port, 2, 8, "cpu")
    for i in range(8):
        got, cache = model.decode_step(port, params, cache,
                                       tokens[:, i:i + 1], i)
        close(got[:, 0], full[:, i], 1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_greedy_tokens_equal_reference(arch):
    cfg, port = smoke(arch)
    params = ref_models.init_params(cfg, KEY)
    prompts = np.array([[5, 6, 7, 8, 9], [9, 10, 11, 12, 13]], np.int32)
    want = RefEngine(cfg, params, max_seq=32, max_batch=2).generate(
        prompts, max_new=8)
    engine = ServeEngine(port, params_from_reference(port, params),
                         max_seq=32, max_batch=2, device="cpu")
    got = engine.generate(prompts, max_new=8)
    np.testing.assert_array_equal(got.new_tokens, want.new_tokens)
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("arch", MOE)
def test_params_carry_every_leaf(arch):
    """Every leaf exactly, the router fp32 in a bf16 model; the port's
    init gives the carried model's names, shapes and types."""
    cfg, port = smoke(arch, "bfloat16")
    params = ref_models.init_params(cfg, KEY)
    got = params_from_reference(port, params)
    n = 0
    for name, t in got.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            leaf = params["blocks"]
            for key in parts[2:]:
                leaf = leaf[key]
            leaf = np.asarray(leaf)[int(parts[1])]
        else:
            leaf = params[parts[0]]
        want = torch.float32 if parts[-1] == "router" else torch.bfloat16
        assert t.dtype == want, name
        np.testing.assert_array_equal(f32(t), f32(leaf), err_msg=name)
        n += 1
    per_layer = len(jax.tree_util.tree_leaves(params["blocks"]))
    assert n == cfg.n_layers * per_layer + 3
    mine = model.init_params(port, torch.Generator().manual_seed(0))
    assert [(k, p.shape, p.dtype) for k, p in mine.named_parameters()] == \
        [(k, p.shape, p.dtype) for k, p in got.named_parameters()]
