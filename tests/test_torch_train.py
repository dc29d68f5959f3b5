"""The port's training path against the JAX reference's, on the CPU:

* ``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
  reference's ``loss_fn``, for every arch's smoke config in fp32 with
  ``remat`` on (the reference's ``jax.checkpoint`` bodies, the port's
  ``torch.utils.checkpoint``), the parameters carried across by
  ``convert.params_from_reference`` and the gradients mapped back the
  same way (the hybrid family through the plain ``ssm_scan``, which
  autograd follows), at S=32 (the reference jitted), and llama3-8b at
  S=2048, where attention takes the flash path (its
  ``autograd.Function`` with the plain backward here; the reference
  eager, as ``test_torch_model.py`` holds the blocked path).  Loss at rtol 1e-4; each gradient leaf elementwise at
  rtol 1e-4 with an atol of 1e-4 of the leaf's largest entry (gradients
  cancel to near zero in places, where fp32 summation order dominates);
* a step of ``make_train_step`` with 1 and 2 microbatches against the
  reference's (same weights, zero state, one batch of the reference's
  data pipeline): loss, grad norm and lr at rtol 1e-4, the parameters
  after the step at rtol 1e-4 with an atol of 1e-4 of one lr step (the
  first AdamW step moves a parameter by ``lr * g / (|g| + eps)``, whose
  sign flips for gradients within rounding of zero);
* the port's versions of the four ``TestPowerAwareTrainer`` cases
  (``tests/test_runtime_serving.py``), on the CPU;
* the trainer started from the reference trainer's initial weights, in
  fp32 and in bf16: equal caps and straggler sequences (they depend on
  the host-time model only through each host's ratio to the others, not
  on the step's wall time) and losses at rtol 1e-3 over six steps in fp32
  (AdamW's sign-like first steps amplify fp32 rounding of near-zero
  gradients a little), 1e-2 in bf16;
* the train CLI on the CPU, with an injected failure.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro.data.pipeline import DataConfig as RefDataConfig  # noqa: E402
from repro.data.pipeline import global_batch as ref_global_batch  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch.train import build_trainer as ref_build_trainer  # noqa
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import init_opt_state as ref_init_opt_state  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.train import build_trainer  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402

TOL = 1e-4


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.family == "encoder":
        batch = {"frames": rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(
            np.int32)}
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -1                      # masked positions
    batch["labels"] = labels
    return batch


def _torch_batch(batch):
    return {k: torch.as_tensor(v) if k == "frames"
            else torch.as_tensor(v).long() for k, v in batch.items()}


def _close_leaf(got, want, name, tol=TOL):
    w = want.detach().numpy()
    np.testing.assert_allclose(got.detach().numpy(), w, rtol=tol,
                               atol=tol * float(np.abs(w).max()),
                               err_msg=name)


CASES = [(arch, 32) for arch in ref_configs.ARCH_IDS] + [("llama3-8b", 2048)]


@pytest.mark.parametrize("arch,seq", CASES,
                         ids=[f"{a}-S{s}" for a, s in CASES])
def test_loss_and_grads_match_reference(arch, seq):
    rcfg = dataclasses.replace(ref_configs.get_smoke(arch), remat=True)
    pcfg = dataclasses.replace(configs.get_smoke(arch), remat=True)
    batch = _batch(rcfg, 1 if seq > 64 else 2, seq)
    params = ref_models.init_params(rcfg, jax.random.PRNGKey(0))
    grad_fn = jax.value_and_grad(
        lambda p: ref_models.loss_fn(
            rcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)
    if seq <= 64:           # jitted: one compile in place of many
        grad_fn = jax.jit(grad_fn)
    (loss, parts), grads = grad_fn(params)
    model = params_from_reference(pcfg, params).requires_grad_(True)
    total, pparts = loss_fn(pcfg, model, _torch_batch(batch))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(loss), rtol=TOL)
    np.testing.assert_allclose(float(pparts["xent"].detach()),
                               float(parts["xent"]), rtol=TOL)
    np.testing.assert_allclose(float(pparts["moe_aux"].detach()),
                               float(parts["moe_aux"]), rtol=TOL, atol=1e-6)
    want = dict(params_from_reference(pcfg, grads).named_parameters())
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        _close_leaf(p.grad, want[name], name)


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(micro):
    rcfg = ref_configs.get_smoke("llama3-8b")
    pcfg = configs.get_smoke("llama3-8b")
    kw = dict(lr=1e-3, warmup_steps=5, total_steps=20)
    ropt, popt = RefAdamWConfig(**kw), AdamWConfig(**kw)
    data = RefDataConfig(vocab=rcfg.vocab, seq_len=32, global_batch=4,
                         seed=0)
    batch = ref_global_batch(data, 3)
    params = ref_models.init_params(rcfg, jax.random.PRNGKey(0))
    model = params_from_reference(pcfg, params).requires_grad_(True)
    state = ref_init_opt_state(params, ropt)
    pstate = opt_state_from_reference(pcfg, state)
    new_params, new_state, ref_m = jax.jit(ref_steps.make_train_step(
        rcfg, ropt, n_microbatches=micro))(
        params, state, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.int32(3))
    pstate, metrics = steps.make_train_step(pcfg, popt,
                                            n_microbatches=micro)(
        model, pstate, batch, 3)
    assert sorted(metrics) == sorted(ref_m)
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(ref_m[key]),
                                   rtol=TOL, atol=1e-7, err_msg=key)
    want = dict(params_from_reference(pcfg, new_params).named_parameters())
    lr_step = float(ref_m["lr"])
    for name, p in model.named_parameters():
        assert p.grad is None, name
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), rtol=TOL,
                                   atol=TOL * lr_step, err_msg=name)


def test_train_step_needs_gradients_on():
    cfg = configs.get_smoke("llama3-8b")
    params = ref_models.init_params(ref_configs.get_smoke("llama3-8b"),
                                    jax.random.PRNGKey(0))
    model = params_from_reference(cfg, params)      # frozen, as for serving
    step = steps.make_train_step(cfg, AdamWConfig())
    with pytest.raises(ValueError, match="requires_grad_"):
        step(model, {}, _batch(cfg, 2, 16), 0)


# -------------------------------------------------------------- trainer
@pytest.fixture()
def ckpt_dir(tmp_path):
    return str(tmp_path / "ckpt")


class TestPowerAwareTrainer:
    def test_loss_decreases_and_controller_acts(self, ckpt_dir):
        trainer = build_trainer("llama3-8b", smoke=True, steps=12,
                                hosts=4, batch=4, seq=64,
                                ckpt_dir=ckpt_dir, device="cpu")
        history = trainer.run()
        assert len(history) == 12
        first = np.mean([r.loss for r in history[:3]])
        last = np.mean([r.loss for r in history[-3:]])
        assert last < first, f"loss did not decrease: {first} -> {last}"
        assert any(max(r.caps_w) > trainer.p_o * 1.01 for r in history)
        assert trainer.speedup_summary()["speedup"] > 1.0

    def test_power_aware_off_keeps_equal_caps(self, ckpt_dir):
        trainer = build_trainer("qwen1.5-4b", smoke=True, steps=4,
                                hosts=4, batch=4, seq=32,
                                ckpt_dir=ckpt_dir, power_aware=False,
                                device="cpu")
        for r in trainer.run():
            assert all(abs(c - trainer.p_o) < 1e-9 for c in r.caps_w)

    def test_failure_recovery_resumes_from_checkpoint(self, ckpt_dir):
        trainer = build_trainer("llama3-8b", smoke=True, steps=10,
                                hosts=4, batch=4, seq=64,
                                ckpt_dir=ckpt_dir, fail_at=(6,),
                                device="cpu")
        history = trainer.run()
        assert history[-1].step == 9
        assert trainer.n_hosts == 3
        steps_seen = [r.step for r in history]
        assert steps_seen.count(6) >= 1
        # resumed after the step-4 checkpoint: step 5 ran twice
        assert steps_seen.count(5) == 2

    def test_restart_resumes_step(self, ckpt_dir):
        t1 = build_trainer("qwen1.5-4b", smoke=True, steps=6, hosts=3,
                           batch=4, seq=32, ckpt_dir=ckpt_dir, device="cpu")
        t1.run()
        t2 = build_trainer("qwen1.5-4b", smoke=True, steps=6, hosts=3,
                           batch=4, seq=32, ckpt_dir=ckpt_dir, device="cpu")
        assert t2.start_step == 6  # nothing left to do
        assert t2.run() == []
        for (name, a), b in zip(t1.model.state_dict().items(),
                                t2.model.state_dict().values()):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-3),
                                        ("bfloat16", 1e-2)])
def test_trainer_from_reference_weights(tmp_path, monkeypatch, dtype, rtol):
    """Both trainers from the reference trainer's initial weights, in fp32
    and in bf16 (the model's type: parameters, activations and the
    AdamW update's rounding back to bf16); bf16 losses at rtol 1e-2, as
    XLA's fusions round bf16 activations at other places than the
    port's eager ops (test_torch_model.py's doc)."""
    import repro.launch.train as ref_train_mod

    def smoke(get):
        return lambda arch: dataclasses.replace(
            get(arch), dtype=dtype, param_dtype=dtype)

    monkeypatch.setattr(ref_train_mod, "get_smoke",
                        smoke(ref_configs.get_smoke))
    monkeypatch.setattr(train_cli, "get_smoke", smoke(configs.get_smoke))
    kw = dict(smoke=True, steps=6, hosts=4, batch=4, seq=32)
    ref = ref_build_trainer("llama3-8b", ckpt_dir=str(tmp_path / "r"), **kw)
    start = params_from_reference(train_cli.get_smoke("llama3-8b"),
                                  ref.params)
    port = build_trainer("llama3-8b", ckpt_dir=str(tmp_path / "p"),
                         device="cpu", model=start, **kw)
    want, got = ref.run(), port.run()
    assert [r.step for r in got] == [r.step for r in want]
    assert [r.straggler for r in got] == [r.straggler for r in want]
    np.testing.assert_allclose([r.caps_w for r in got],
                               [r.caps_w for r in want], rtol=1e-12)
    np.testing.assert_allclose([r.loss for r in got],
                               [r.loss for r in want], rtol=rtol)
    assert not any(p.requires_grad for p in start.parameters())
    assert all(p.dtype == getattr(torch, dtype)
               for p in port.model.parameters())


def test_train_cli_on_cpu(tmp_path, capsys):
    rc = train_cli.main(["--device", "cpu", "--steps", "10", "--hosts", "4",
                         "--batch", "4", "--seq", "32", "--fail-at", "6",
                         "--ckpt-dir", str(tmp_path / "c")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "device=cpu" in out
    assert "hosts left 3; last step 9" in out
    assert "power-aware speedup over equal-share" in out
    assert '[train] kernel launches {"flash_attention": 0' in out


def test_training_modules_import_neither_jax_nor_reference():
    """The training path's modules, imported in a fresh interpreter, load
    no ``jax`` and no ``repro`` (the port keeps its own copies)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "import repro_torch.data.pipeline, repro_torch.optim.adamw\n"
            "import repro_torch.optim.compression\n"
            "import repro_torch.checkpoint.manager\n"
            "import repro_torch.runtime.trainer, repro_torch.launch.train\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=root, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
