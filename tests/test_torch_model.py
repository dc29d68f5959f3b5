"""The port's dense, VLM and encoder LMs against the JAX reference model.

Configs: every arch's ``FULL`` and ``smoke()`` equal field for field.
Layers and attention: RoPE, ``gqa_attend`` and ``attention`` at S=64 (the
einsum path) and S=2048 (the blocked path, the flash kernel's plain loop
here).  Model: ``forward`` logits and ``decode_step`` logits plus the KV
cache on the llama3-8b, qwen1.5-4b and chameleon-34b (vlm: the dense
code unchanged) smoke configs, with the JAX
parameters carried across by ``convert.params_from_reference``, at rtol =
atol = 1e-4 in fp32, and for a bf16 variant of each config at a normwise
relative error of 2e-2: elementwise, the reference's own jitted and
eager evaluations of one bf16 forward differ by up to 4.1e-2 on these
configs (XLA keeps fused intermediates in fp32), so an elementwise bf16
bound would measure XLA's fusion choices rather than the port.  At
S=2048 the fp32 reference runs eagerly (``jax.disable_jit``): its jitted
form differs from itself eager by up to 1.1e-4 there, the port from the
eager form by under 1e-5.  The encoder (hubert-xlarge smoke): frames
through ``frame_proj``, bidirectional attention without RoPE, the GELU
MLP, at S=64 (einsum path) and S=2048 (the non-causal blocked path), and
``make_prefill_step`` on frames; it has no cache and no decode step.
Every family's ``init_params`` gives the names, shapes and types of the
reference's pytree carried across; an unknown family raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import (attention_from_reference,  # noqa: E402
                                 cache_from_reference, from_reference,
                                 params_from_reference)
from repro_torch.models import attention, layers, model  # noqa: E402

F32 = 1e-4
BF16 = 2e-2
DENSE = ["llama3-8b", "qwen1.5-4b"]
DECODERS = DENSE + ["chameleon-34b"]
ENCODER = "hubert-xlarge"


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def close_model(got, want, dtype):
    """Whole-model outputs: elementwise at 1e-4 in fp32, normwise
    relative error at 2e-2 in bf16 (see the module doc)."""
    if dtype == "float32":
        close(got, want, F32)
        return
    g, w = f32(got), f32(want)
    assert np.linalg.norm(g - w) <= BF16 * np.linalg.norm(w)


def smoke(arch, dtype="float32"):
    cfg = ref_configs.get_smoke(arch)
    if dtype != "float32":
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    port = configs.get_smoke(arch)
    if dtype != "float32":
        port = dataclasses.replace(port, dtype=dtype, param_dtype=dtype)
    return cfg, port


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_match_field_for_field(arch):
    for shape in (None, "long_500k"):
        assert dataclasses.asdict(configs.get_config(arch, shape)) == \
            dataclasses.asdict(ref_configs.get_config(arch, shape))
    assert dataclasses.asdict(configs.get_smoke(arch)) == \
        dataclasses.asdict(ref_configs.get_smoke(arch))
    assert configs.get_config(arch).param_count() == \
        ref_configs.get_config(arch).param_count()
    assert configs.cells() == ref_configs.cells()
    assert [dataclasses.asdict(s) for s in configs.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in ref_configs.ALL_SHAPES]


# ----------------------------------------------------- layers / attention
def test_rope_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 16), dtype=np.float32)
    pos = rng.integers(0, 4096, (2, 9))
    for theta in (500000.0, 1e6):
        close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta),
              ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
              1e-5)


@pytest.mark.parametrize("window", [0, 5])
def test_gqa_attend_matches(window):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((2, 7, 4, 16), (2, 7, 2, 16), (2, 7, 2, 16)))
    pos = np.broadcast_to(np.arange(7), (2, 7))
    keep = ref_attention.gqa_scores_mask(jnp.asarray(pos), jnp.asarray(pos),
                                         True, window)
    tkeep = attention.gqa_scores_mask(torch.from_numpy(pos.copy()),
                                      torch.from_numpy(pos.copy()), True,
                                      window)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    close(attention.gqa_attend(*map(torch.from_numpy, (q, k, v)), tkeep),
          ref_attention.gqa_attend(*map(jnp.asarray, (q, k, v)), keep), 1e-5)


@pytest.mark.parametrize("s", [64, 2048])
@pytest.mark.parametrize("arch", DENSE)
def test_attention_matches(arch, s):
    """S=64 takes the einsum path, S=2048 the blocked (flash) path."""
    cfg, _ = smoke(arch)
    p = ref_attention.attn_init(jax.random.PRNGKey(3), cfg.d_model,
                                cfg.n_heads, cfg.n_kv_heads, cfg.dh,
                                jnp.float32, cfg.qkv_bias)
    if cfg.qkv_bias:     # non-zero biases, so the bias path is exercised
        p = {k: (v + 0.1 if k.startswith("b") else v) for k, v in p.items()}
    x = np.random.default_rng(s).standard_normal((1, s, cfg.d_model),
                                                 dtype=np.float32)
    pos = np.arange(s)[None]
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.dh, rope_theta=cfg.rope_theta)
    want = ref_attention.attention(p, jnp.asarray(x), jnp.asarray(pos), **kw)
    got = attention.attention(attention_from_reference(p, torch.float32),
                              torch.from_numpy(x), torch.from_numpy(pos),
                              **kw)
    close(got, want, F32)


def test_attention_rejects_what_blocked_attend_asserts():
    q = torch.zeros((1, 3072 - 64, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        attention.blocked_attend(q, q, q, True)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODERS)
def test_forward_matches(arch, dtype):
    cfg, port = smoke(arch, dtype)
    params = ref_models.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    want, _ = ref_models.forward(cfg, params, {"tokens": jnp.asarray(tokens)})
    got, aux = model.forward(port, params_from_reference(port, params),
                             {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == layers.dtype_of(dtype) and float(aux) == 0.0
    close_model(got, want, dtype)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_blocked_path_matches(arch):
    """S=2048: every layer's attention runs the blocked (flash) path."""
    cfg, port = smoke(arch)
    params = ref_models.init_params(cfg, jax.random.PRNGKey(1))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (1, 2048))
    with jax.disable_jit():
        want, _ = ref_models.forward(cfg, params,
                                     {"tokens": jnp.asarray(tokens)})
    got, _ = model.forward(port, params_from_reference(port, params),
                           {"tokens": torch.from_numpy(tokens)})
    close(got, want, F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step_matches(arch, dtype):
    """Six decode steps from an empty cache: logits at every step and
    the KV cache after the last."""
    cfg, port = smoke(arch, dtype)
    params = ref_models.init_params(cfg, jax.random.PRNGKey(2))
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 6))
    cache = ref_models.init_cache(cfg, 2, 8)
    tcache = cache_from_reference(cache)
    assert tcache["k"].dtype == layers.dtype_of(dtype)
    tparams = params_from_reference(port, params)
    step = jax.jit(lambda p, c, t, i: ref_models.decode_step(cfg, p, c, t, i))
    for i in range(tokens.shape[1]):
        want, cache = step(params, cache, jnp.asarray(tokens[:, i:i + 1]),
                           jnp.int32(i))
        got, tcache = model.decode_step(
            port, tparams, tcache, torch.from_numpy(tokens[:, i:i + 1]), i)
        close_model(got, want, dtype)
    for name in ("k", "v"):
        close_model(tcache[name], cache[name], dtype)


def test_params_from_reference_keeps_bf16():
    """bf16 leaves (ml_dtypes arrays) cross through float32 to
    torch.bfloat16, value for value."""
    cfg, port = smoke("qwen1.5-4b", "bfloat16")
    params = ref_models.init_params(cfg, jax.random.PRNGKey(7))
    got = params_from_reference(port, params)
    assert {p.dtype for p in got.parameters()} == {torch.bfloat16}
    assert not any(p.requires_grad for p in got.parameters())
    blk = got.blocks[1]
    np.testing.assert_array_equal(
        f32(blk.attn.wq), f32(params["blocks"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(
        f32(blk.attn.bk), f32(params["blocks"]["attn"]["bk"][1]))
    np.testing.assert_array_equal(f32(got.embed), f32(params["embed"]))
    np.testing.assert_array_equal(f32(got.lm_head), f32(params["lm_head"]))
    assert len(got.blocks) == cfg.n_layers
    # the generic converter takes bf16 leaves too (as float32)
    state = from_reference({"embed": params["embed"]})
    assert state["embed"].dtype == torch.float32
    np.testing.assert_array_equal(state["embed"].numpy(),
                                  f32(params["embed"]))


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_init_params_shapes_and_seed(arch):
    """Same generator seed, same weights; shapes and types those of the
    reference's pytree."""
    cfg, port = smoke(arch, "bfloat16")
    a = model.init_params(port, torch.Generator().manual_seed(0))
    b = model.init_params(port, torch.Generator().manual_seed(0))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    ref = params_from_reference(
        port, ref_models.init_params(cfg, jax.random.PRNGKey(0)))
    assert [(n, p.shape, p.dtype) for n, p in a.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in ref.named_parameters()]


# ---------------------------------------------------------------- encoder
def _frames(cfg, s, seed):
    return np.random.default_rng(seed).standard_normal((1, s, cfg.d_model),
                                                       dtype=np.float32)


@pytest.mark.parametrize("s", [64, 2048])
def test_encoder_forward_matches(s):
    """S=64: the einsum path; S=2048: the non-causal blocked (flash)
    path, against the eager reference."""
    cfg, port = smoke(ENCODER)
    assert not port.causal and port.mlp == "gelu"
    params = ref_models.init_params(cfg, jax.random.PRNGKey(s))
    frames = _frames(cfg, s, s)
    if s >= 2048:
        with jax.disable_jit():
            want, _ = ref_models.forward(cfg, params,
                                         {"frames": jnp.asarray(frames)})
    else:
        want, _ = ref_models.forward(cfg, params,
                                     {"frames": jnp.asarray(frames)})
    tparams = params_from_reference(port, params)
    assert isinstance(tparams, model.EncoderLM)
    got, aux = model.forward(port, tparams,
                             {"frames": torch.from_numpy(frames)})
    assert float(aux) == 0.0 and got.shape == (1, s, cfg.vocab)
    close(got, want, F32)


def test_encoder_bf16_prefill_step_matches():
    """make_prefill_step on frames, as the reference's prefill step."""
    from repro.launch.steps import make_prefill_step as ref_prefill

    from repro_torch.launch.steps import make_prefill_step

    cfg, port = smoke(ENCODER, "bfloat16")
    params = ref_models.init_params(cfg, jax.random.PRNGKey(9))
    frames = _frames(cfg, 48, 9)
    want = ref_prefill(cfg)(params, {"frames": jnp.asarray(frames)})
    got = make_prefill_step(port, device="cpu")(
        params_from_reference(port, params), {"frames": frames})
    assert got.dtype == torch.bfloat16
    close_model(got, want, "bfloat16")


def test_encoder_has_no_decode_step():
    _, port = smoke(ENCODER)
    params = model.init_params(port, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no decode cache"):
        model.init_cache(port, 1, 8, "cpu")
    with pytest.raises(ValueError, match="no decode step"):
        model.decode_step(port, params, {}, torch.zeros((1, 1), dtype=int), 0)


def test_unknown_family_raises():
    """Every family of the repo's configs is ported; a family the
    reference does not know raises at every entry point."""
    from repro_torch.serving.engine import ServeEngine

    assert set(model.FAMILIES) == {configs.get_smoke(a).family
                                   for a in ref_configs.ARCH_IDS}
    cfg = dataclasses.replace(configs.get_smoke("llama3-8b"),
                              family="rnn")
    for call in (lambda: model.init_params(cfg, torch.Generator()),
                 lambda: model.init_cache(cfg, 1, 8, "cpu"),
                 lambda: model.forward(cfg, None, {}),
                 lambda: model.decode_step(cfg, None, {}, None, 0),
                 lambda: params_from_reference(cfg, {}),
                 lambda: ServeEngine(cfg, None, 8, 1, device="cpu")):
        with pytest.raises(ValueError, match="unknown family 'rnn'"):
            call()
