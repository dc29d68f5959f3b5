"""The port's serving path against the JAX reference's ``ServeEngine``.

Greedy generation from the same weights (carried across by
``convert.params_from_reference``) gives the reference's tokens exactly
on the llama3-8b, qwen1.5-4b and chameleon-34b smoke configs (fp32; the
moe and ssm families' cases are in ``tests/test_torch_moe.py`` and
``tests/test_torch_xlstm.py``).  The port's own
checks mirror ``tests/test_runtime_serving.py``: prefill + decode equals
the teacher-forced ``forward``'s argmax, generation is deterministic,
encoder-only archs are rejected; besides, sampling at ``temperature > 0`` is
reproducible from its seed (shapes only against the reference: its
``jax.random`` bits cannot be matched), the step functions and the CLI
run on the CPU when asked, and default to the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import forward, init_cache, init_params  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

PROMPTS = np.array([[5, 6, 7, 8, 9], [9, 10, 11, 12, 13]], np.int32)


def _port(arch, seed):
    cfg = get_smoke(arch)
    return cfg, init_params(cfg, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-4b",
                                  "chameleon-34b"])
def test_greedy_tokens_equal_reference(arch):
    cfg = ref_smoke(arch)
    params = ref_init(cfg, jax.random.PRNGKey(0))
    want = RefEngine(cfg, params, max_seq=32, max_batch=2).generate(
        PROMPTS, max_new=8)
    port_cfg = get_smoke(arch)
    engine = ServeEngine(port_cfg, params_from_reference(port_cfg, params),
                         max_seq=32, max_batch=2, device="cpu")
    got = engine.generate(PROMPTS, max_new=8)
    np.testing.assert_array_equal(got.new_tokens, want.new_tokens)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.steps == want.steps == 8


def test_greedy_deterministic():
    cfg, params = _port("llama3-8b", 0)
    engine = ServeEngine(cfg, params, max_seq=32, max_batch=2, device="cpu")
    a = engine.generate(PROMPTS[:, :4], max_new=6)
    b = engine.generate(PROMPTS[:, :4], max_new=6)
    np.testing.assert_array_equal(a.new_tokens, b.new_tokens)
    assert a.new_tokens.shape == (2, 6) and a.new_tokens.dtype == np.int32
    assert (a.new_tokens >= 0).all() and (a.new_tokens < cfg.vocab).all()


def test_prefill_matches_stepwise_forward():
    """Engine prefill + decode equals the teacher-forced forward argmax,
    and the prefill step's logits are the forward's."""
    cfg, params = _port("llama3-8b", 1)
    engine = ServeEngine(cfg, params, max_seq=16, max_batch=1, device="cpu")
    prompts = np.array([[3, 4, 5, 6, 7, 8]], np.int32)
    res = engine.generate(prompts, max_new=1)
    with torch.inference_mode():
        logits, _ = forward(cfg, params, {"tokens": torch.tensor(prompts)})
    assert int(res.new_tokens[0, 0]) == int(logits[0, -1].argmax())
    prefill = make_prefill_step(cfg, device="cpu")
    torch.testing.assert_close(prefill(params, {"tokens": prompts}), logits)


def test_serve_step_matches_engine():
    """make_serve_step's greedy tokens follow the engine's, and each step
    counts 2 L + 1 RMSNorm calls (plain on the CPU: no launches)."""
    cfg, params = _port("qwen1.5-4b", 2)
    engine = ServeEngine(cfg, params, max_seq=16, max_batch=2, device="cpu")
    want = engine.generate(PROMPTS[:, :3], max_new=4)
    step = make_serve_step(cfg, device="cpu")
    cache = init_cache(cfg, 2, 16, "cpu")
    launches = rn.LAUNCHES["rmsnorm"]
    for i in range(3):
        nxt, logits, cache = step(params, cache, PROMPTS[:, i:i + 1], i)
    got = [nxt]
    for i in range(3, 6):
        nxt, logits, cache = step(params, cache, nxt[:, None], i)
        got.append(nxt)
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(),
                                  want.new_tokens)
    assert logits.shape == (2, 1, cfg.vocab)
    assert rn.LAUNCHES["rmsnorm"] == launches


def test_temperature_sampling_reproducible():
    cfg, params = _port("llama3-8b", 3)
    engine = ServeEngine(cfg, params, max_seq=32, max_batch=2, device="cpu")
    a = engine.generate(PROMPTS, max_new=6, temperature=1.0, seed=7)
    b = engine.generate(PROMPTS, max_new=6, temperature=1.0, seed=7)
    c = engine.generate(PROMPTS, max_new=6, temperature=1.0, seed=8)
    np.testing.assert_array_equal(a.new_tokens, b.new_tokens)
    assert not np.array_equal(a.new_tokens, c.new_tokens)
    ref = RefEngine(ref_smoke("llama3-8b"),
                    ref_init(ref_smoke("llama3-8b"), jax.random.PRNGKey(3)),
                    max_seq=32, max_batch=2)
    want = ref.generate(PROMPTS, max_new=6, temperature=1.0, seed=7)
    assert a.new_tokens.shape == want.new_tokens.shape
    assert a.tokens.shape == want.tokens.shape


def test_encoder_rejected():
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(get_smoke("hubert-xlarge"), None, max_seq=8, max_batch=1,
                    device="cpu")


def test_entry_points_default_to_the_card():
    """device=None means the card: without CUDA every entry point raises
    rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    cfg, params = _port("llama3-8b", 0)
    for make in (lambda: ServeEngine(cfg, params, 8, 1),
                 lambda: make_prefill_step(cfg),
                 lambda: make_serve_step(cfg),
                 lambda: serve.main(["--arch", "llama3-8b"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("arch", ["llama3-8b", "moonshot-v1-16b-a3b",
                                  "arctic-480b", "chameleon-34b",
                                  "xlstm-350m"])
def test_cli_runs_on_the_cpu(capsys, arch):
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch",
                       "2", "--prompt-len", "4", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert f"{arch} on cpu: batch=2 prompt=4 new=3" in out
    assert out.count("lane ") == 2


def test_cli_rejects_the_encoder():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_reference_tokens_follow_forward():
    """The reference engine's first token is the reference forward's
    argmax, so the port's exact token match above covers prefill."""
    from repro.models import forward as ref_forward

    cfg = ref_smoke("qwen1.5-4b")
    params = ref_init(cfg, jax.random.PRNGKey(4))
    res = RefEngine(cfg, params, max_seq=16, max_batch=2).generate(
        PROMPTS, max_new=1)
    logits, _ = ref_forward(cfg, params, {"tokens": jnp.asarray(PROMPTS)})
    np.testing.assert_array_equal(res.new_tokens[:, 0],
                                  np.asarray(jnp.argmax(logits[:, -1], -1)))
