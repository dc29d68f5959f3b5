"""The port's hybrid LM (zamba2) against the JAX reference model.

On the zamba2-2.7b smoke config (4 Mamba2 layers in 2 super-blocks, each
followed by the shared attention block), with the JAX parameters carried
across by ``convert.params_from_reference``: every leaf exactly (and the
SSM's fp32 leaves fp32 in a bf16 model); ``forward`` logits at rtol =
atol = 1e-4 in fp32 at S=64 (the attention's einsum path) and S=2048 (the
blocked path, held against the reference run eagerly, as
``tests/test_torch_model.py`` explains), and at a normwise relative
error of 2e-2 in bf16; ``decode_step`` logits and every cache leaf over
several positions at 1e-4 in fp32; greedy tokens of ``ServeEngine``
equal to the JAX ``ServeEngine``'s.  Decode is not compared in bf16:
there the reference's jitted and eager decode steps differ from each
other by up to 1.7e-2 normwise over six steps of this config (the
in_proj output alone by 0.8e-2), which leaves no room under a 2e-2
bound for the port's own roundings.  The kernels' launch sites are
counted on the CPU: one ``ssm_scan`` per Mamba2 layer, one flash
attention per super-block at S >= 2048, ``2 L + 2 n_super + 1``
RMSNorms.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import (cache_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import HybridLM, layers, model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

ARCH = "zamba2-2.7b"
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


def ref_params(cfg, seed):
    """The reference's init with non-trivial A_log, D and dt_bias (its
    init makes them 0, 1, 0), so the tests see every term."""
    params = ref_models.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    ssm = dict(params["mamba"]["ssm"])
    for name, lo, hi in (("A_log", -1, 1), ("D", 0.5, 1.5),
                         ("dt_bias", -1, 1)):
        ssm[name] = jnp.asarray(rng.uniform(lo, hi, ssm[name].shape),
                                jnp.float32)
    params["mamba"] = dict(params["mamba"], ssm=ssm)
    return params


@pytest.fixture
def counts(monkeypatch):
    """Calls of each kernel's dispatch (the launch sites on the card)."""
    seen = {"rmsnorm": 0, "ssm_scan": 0, "flash_attention": 0}
    for mod, name in ((rn, "rmsnorm"), (ss, "ssm_scan"),
                      (fa, "flash_attention")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            seen[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return seen


# ------------------------------------------------------------ parameters
def test_params_from_reference_carries_every_leaf():
    cfg, port = smoke("bfloat16")
    params = ref_params(cfg, 0)
    got = params_from_reference(port, params)
    assert isinstance(got, HybridLM)
    assert not any(p.requires_grad for p in got.parameters())
    n_super, per_super = model.superblock_shape(port)
    assert (n_super, per_super) == (2, 2)
    assert [len(sup) for sup in got.mamba] == [per_super] * n_super
    fp32 = {"A_log", "D", "dt_bias"}
    for name, t in got.named_parameters():
        parts = name.split(".")
        if parts[0] == "mamba":
            i, j = int(parts[1]), int(parts[2])
            leaf = params["mamba"]
            for key in parts[3:]:
                leaf = leaf[key]
            leaf = np.asarray(leaf)[i, j]
        elif parts[0] == "shared":
            leaf = params["shared_attn"]
            for key in parts[1:]:
                leaf = leaf[key]
        else:
            leaf = params[parts[0]]
        want = torch.float32 if parts[-1] in fp32 else torch.bfloat16
        assert t.dtype == want, name
        np.testing.assert_array_equal(f32(t), f32(leaf), err_msg=name)
    # 8 stacked leaves a Mamba2 layer (ln + 7 of the mixer), 9 of the
    # shared block, embed / final norm / head: every one carried
    assert len(jax.tree_util.tree_leaves(params)) == 8 + 9 + 3
    assert len(list(got.parameters())) == n_super * per_super * 8 + 9 + 3


def test_init_params_shapes_and_seed():
    """Same generator seed, same weights; names, shapes and types those
    of the reference's pytree carried across."""
    cfg, port = smoke("bfloat16")
    a = model.init_params(port, torch.Generator().manual_seed(0))
    b = model.init_params(port, torch.Generator().manual_seed(0))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    ref = params_from_reference(port, ref_models.init_params(
        cfg, jax.random.PRNGKey(0)))
    assert [(n, p.shape, p.dtype) for n, p in a.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in ref.named_parameters()]


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("s", [64, 2048])
def test_forward_matches(s, counts):
    """S=64: the shared attention's einsum path; S=2048: its blocked
    (flash) path, against the eager reference."""
    cfg, port = smoke()
    params = ref_params(cfg, 1)
    tokens = np.random.default_rng(s).integers(0, cfg.vocab, (1, s))
    if s >= 2048:
        with jax.disable_jit():
            want, _ = ref_models.forward(cfg, params,
                                         {"tokens": jnp.asarray(tokens)})
    else:
        want, _ = ref_models.forward(cfg, params,
                                     {"tokens": jnp.asarray(tokens)})
    got, aux = model.forward(port, params_from_reference(port, params),
                             {"tokens": torch.from_numpy(tokens)})
    assert float(aux) == 0.0 and got.shape == (1, s, cfg.vocab)
    close(got, want)
    n_super, _ = model.superblock_shape(port)
    assert counts == {"rmsnorm": 2 * cfg.n_layers + 2 * n_super + 1,
                      "ssm_scan": cfg.n_layers,
                      "flash_attention": n_super if s >= 2048 else 0}


def test_forward_bf16_matches():
    cfg, port = smoke("bfloat16")
    params = ref_params(cfg, 2)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 40))
    want, _ = ref_models.forward(cfg, params, {"tokens": jnp.asarray(tokens)})
    got, _ = model.forward(port, params_from_reference(port, params),
                           {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.bfloat16
    normwise(got, want)


# ----------------------------------------------------------------- decode
def test_cache_layout_matches_reference():
    for dtype in ("float32", "bfloat16"):
        cfg, port = smoke(dtype)
        want = ref_models.init_cache(cfg, 3, 16)
        got = model.init_cache(port, 3, 16, "cpu")
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name, k
            assert not got[k].any()
        carried = cache_from_reference(want)
        assert {k: (v.shape, v.dtype) for k, v in carried.items()} == \
            {k: (v.shape, v.dtype) for k, v in got.items()}


@pytest.mark.parametrize("batch", [1, 2])
def test_decode_step_matches(batch, counts):
    """Six decode steps from an empty cache: logits at every step, and
    every cache leaf (conv and ssm states, the shared block's KV slots)
    after each, in fp32 (see the module doc for bf16)."""
    cfg, port = smoke()
    params = ref_params(cfg, 3)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (batch, 6))
    cache = ref_models.init_cache(cfg, batch, 8)
    tcache = cache_from_reference(cache)
    tparams = params_from_reference(port, params)
    step = jax.jit(lambda p, c, t, i: ref_models.decode_step(cfg, p, c, t, i))
    for i in range(tokens.shape[1]):
        want, cache = step(params, cache, jnp.asarray(tokens[:, i:i + 1]),
                           jnp.int32(i))
        got, tcache = model.decode_step(
            port, tparams, tcache, torch.from_numpy(tokens[:, i:i + 1]), i)
        close(got, want)
        for name in ("conv", "ssm", "k", "v"):
            close(tcache[name], cache[name])
    n_super, _ = model.superblock_shape(port)
    assert counts == {"rmsnorm": 6 * (2 * cfg.n_layers + 2 * n_super + 1),
                      "ssm_scan": 0, "flash_attention": 0}


# ---------------------------------------------------------------- serving
PROMPTS = np.array([[5, 6, 7, 8, 9], [9, 10, 11, 12, 13]], np.int32)


def test_greedy_tokens_equal_reference():
    cfg, port = smoke()
    params = ref_params(cfg, 0)
    want = RefEngine(cfg, params, max_seq=32, max_batch=2).generate(
        PROMPTS, max_new=8)
    engine = ServeEngine(port, params_from_reference(port, params),
                         max_seq=32, max_batch=2, device="cpu")
    got = engine.generate(PROMPTS, max_new=8)
    np.testing.assert_array_equal(got.new_tokens, want.new_tokens)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.steps == want.steps == 8


def test_serve_follows_prefill():
    """The engine's first token (the decode step over the prompt) is the
    argmax of the prefill step's last logits (one scan per layer), and a
    serve step continues from the engine's cache."""
    _, port = smoke()
    params = model.init_params(port, torch.Generator().manual_seed(5))
    logits = make_prefill_step(port, device="cpu")(params,
                                                   {"tokens": PROMPTS})
    engine = ServeEngine(port, params, max_seq=16, max_batch=2,
                         device="cpu")
    res = engine.generate(PROMPTS, max_new=2)
    np.testing.assert_array_equal(res.new_tokens[:, 0],
                                  logits[:, -1].argmax(-1).numpy())
    cache, last = engine.prefill(PROMPTS)
    close(last[:, -1], logits[:, -1], 1e-5)
    nxt, _, _ = make_serve_step(port, device="cpu")(
        params, cache, res.new_tokens[:, :1], PROMPTS.shape[1])
    np.testing.assert_array_equal(nxt.numpy(), res.new_tokens[:, 1])


def test_cli_runs_zamba2_on_the_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert f"{ARCH} on cpu: batch=2 prompt=4 new=3" in out


def test_hybrid_layers_must_divide():
    _, port = smoke()
    with pytest.raises(ValueError, match="must divide"):
        model.superblock_shape(dataclasses.replace(port, n_layers=5))
    assert model.superblock_shape(configs.get_config(ARCH)) == (9, 6)
    assert layers.dtype_of(configs.get_config(ARCH).dtype) == torch.bfloat16
