"""The ``learned`` policy in the port against the reference's.

The port keeps its own copy of ``policies/learned.py`` and its bundled
checkpoint; the torch engine's ``TorchLearned`` calls the copy's
xp-generic ``compute_caps`` through a small torch namespace.  Held here:

* the copy's checkpoint and math equal the reference's (numpy, rel
  1e-12), and the torch namespace gives numpy's caps on float64 tensors;
* the event and vector adapters equal the reference's on the mixed
  family (rel 1e-12);
* the torch engine's plain path equals the reference's ``JaxLearned``
  (both float32) on the mixed family at rtol 1e-5, job stamps at atol
  1e-4;
* ``TorchLearned`` declares no kernel mode, so on the card it runs on
  the per-wave ``"step"`` path.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import batchsim as ref_bs
from repro.core import scenarios as ref_sc
from repro.core import simulate as ref_simulate
from repro.policies import learned as ref_learned

from repro_torch.backends.engine import TorchBatchSimulator, resolve_impl
from repro_torch.backends.policies import (TorchLearned, _TorchXP,
                                           get_torch_policy, kernel_mode)
from repro_torch.convert import from_reference
from repro_torch.core import batchsim as port_bs
from repro_torch.core.simulator import simulate
from repro_torch.policies import learned as port_learned

jax = pytest.importorskip("jax")
from repro.backends.jax.engine import JaxBatchSimulator  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RTOL, STAMP_ATOL = 1e-5, 1e-4


def _rows():
    """The mixed family's 18 (graph, cluster, bound, bound steps) rows."""
    fam = ref_sc.mixed_family(seed=0)
    return [(m.graph, list(m.specs), b,
             tuple((t, f * b) for t, f in m.bound_steps))
            for m in fam.members for b in fam.member_bounds(m)]


def _close(got, want, rtol, stamp_atol):
    for a, b in zip(got, want):
        for f in ("makespan", "energy_j", "peak_power_w",
                  "over_budget_time"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=rtol,
                                                  abs=1e-9), f
        for stamps in ("job_starts", "job_ends"):
            sa, sb = getattr(a, stamps), getattr(b, stamps)
            assert sa.keys() == sb.keys()
            np.testing.assert_allclose([sa[k] for k in sb], list(sb.values()),
                                       rtol=0, atol=stamp_atol)


def test_bundled_checkpoint_is_the_references():
    a = json.loads(port_learned.DEFAULT_CHECKPOINT.read_text())
    b = json.loads(ref_learned.DEFAULT_CHECKPOINT.read_text())
    assert a == b
    p, q = port_learned.load_checkpoint(), ref_learned.load_checkpoint()
    assert p.keys() == q.keys()
    for k in p:
        np.testing.assert_array_equal(p[k], q[k])
    assert port_learned.FEATURE_DIM == ref_learned.FEATURE_DIM
    assert port_learned.HIDDEN == ref_learned.HIDDEN


def _lane_inputs(seed, b=16, n=7):
    rng = np.random.default_rng(seed)
    running = rng.random((b, n)) < 0.6
    running[0] = False                     # a row with no running lane
    p_max = rng.uniform(4.0, 8.0, (b, n))
    return dict(running=running, rho=rng.uniform(0.0, 1.0, (b, n)),
                bound=rng.uniform(5.0, 40.0, b),
                n_active=np.full(b, float(n)), p_max=p_max,
                cap_floor=rng.uniform(0.3, 0.6, (b, n)),
                idle_w=rng.uniform(0.2, 0.5, (b, n)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_caps_numpy_and_torch_match_reference(seed):
    """The copy's numpy math equals the reference's, and the torch
    namespace on float64 tensors gives the same caps."""
    kw = _lane_inputs(seed)
    params = ref_learned.load_checkpoint()
    want = ref_learned.compute_caps(np, params, **kw)
    np.testing.assert_allclose(
        port_learned.compute_caps(np, params, **kw), want, rtol=1e-12)
    t = {k: torch.as_tensor(v) for k, v in kw.items()}
    got = port_learned.compute_caps(
        _TorchXP, {k: torch.as_tensor(v) for k, v in params.items()}, **t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # bound-compliant by construction on rows with a running lane
    live = kw["running"].any(-1)
    spent = np.where(kw["running"], got.numpy(), kw["idle_w"]).sum(-1)
    np.testing.assert_allclose(spent[live], kw["bound"][live], rtol=1e-12)


def test_event_adapter_matches_reference_on_mixed_family():
    for g, specs, bound, steps in _rows():
        want = ref_simulate(g, specs, bound, "learned", bound_schedule=steps)
        got = simulate(from_reference(g), from_reference(specs), bound,
                       "learned", bound_schedule=steps)
        _close([got], [want], 1e-12, 1e-9)
        assert (got.messages, got.distributes) == \
            (want.messages, want.distributes)


def test_vector_adapter_matches_reference_on_mixed_family():
    rows = _rows()
    want = ref_bs.BatchSimulator.padded(
        [(g, sp) for g, sp, _, _ in rows], [b for *_, b, _ in rows],
        "learned", bound_schedules=[s for *_, s in rows]).run()
    got = port_bs.BatchSimulator.padded(
        [(from_reference(g), from_reference(sp)) for g, sp, _, _ in rows],
        [b for *_, b, _ in rows], "learned",
        bound_schedules=[s for *_, s in rows]).run()
    _close(got, want, 1e-12, 1e-9)


def test_torch_engine_matches_jax_learned_on_mixed_family():
    """The torch plain path against the reference's compiled
    ``JaxLearned`` (both float32), padded with bound steps."""
    rows = _rows()
    want = JaxBatchSimulator.padded(
        [(g, sp) for g, sp, _, _ in rows], [b for *_, b, _ in rows],
        "learned", bound_schedules=[s for *_, s in rows]).run()
    sim = TorchBatchSimulator.padded(
        [(from_reference(g), from_reference(sp)) for g, sp, _, _ in rows],
        [b for *_, b, _ in rows], "learned",
        bound_schedules=[s for *_, s in rows], device="cpu")
    got = sim.run()
    assert sim.stats.path == "plain"
    _close(got, want, RTOL, STAMP_ATOL)
    assert all(r.policy == "learned" for r in got)


def test_learned_runs_on_the_step_path_on_the_card():
    """No kernel mode: ``None`` resolves to ``"step"`` on a CUDA device
    and ``impl="cuda"`` is refused (no device is touched here)."""
    pol = get_torch_policy("learned")
    assert isinstance(pol, TorchLearned) and kernel_mode(pol) is None
    assert not pol.wants_ticks and not pol.redistribute
    cuda = torch.device("cuda")
    assert resolve_impl(None, cuda, pol) == "step"
    assert resolve_impl(None, torch.device("cpu"), pol) == "plain"
    with pytest.raises(ValueError, match="kernel_mode"):
        resolve_impl("cuda", cuda, pol)


def test_checkpoint_path_and_env_override(tmp_path, monkeypatch):
    """An explicit checkpoint and ``REPRO_LEARNED_CHECKPOINT`` both load:
    a zero output layer makes every running lane's share equal."""
    params = port_learned.init_params(seed=0)
    path = tmp_path / "flat.json"
    port_learned.save_checkpoint(params, path)
    flat = TorchLearned(checkpoint=str(path))
    np.testing.assert_array_equal(flat.params["w3"], np.zeros(16))
    monkeypatch.setenv(port_learned.CHECKPOINT_ENV, str(path))
    assert np.all(TorchLearned().params["w3"] == 0)
    g, specs, bound, _ = _rows()[0]
    r = TorchBatchSimulator(from_reference(g), from_reference(specs),
                            [bound], "learned", device="cpu").run()[0]
    assert r.makespan > 0 and len(r.job_ends) == len(g.jobs)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"arch": {"features": 3, "hidden": [4]},
                               "params": {}}))
    with pytest.raises(ValueError, match="architecture"):
        port_learned.load_checkpoint(bad)
