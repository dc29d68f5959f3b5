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
* the torch namespace's lane sums and weight products take the order
  of the card kernel's ``learned`` mode (``row_sum``; products summed in
  ascending input order), bit for bit against numpy loops, and the
  reordered plain path stays within rtol 1e-5 of ``JaxLearned`` on
  Listing 2 and on a padded bucket of mixed node counts;
* ``TorchLearned`` declares the kernel mode ``"learned"``, so on the
  card it runs in the whole-row kernel; the per-wave ``"step"`` path
  runs it when asked.
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
    """The per-wave ``"step"`` path still runs ``learned`` on a CUDA
    device when asked (the yardstick); the CPU takes the plain path (no
    device is touched here)."""
    pol = get_torch_policy("learned")
    assert isinstance(pol, TorchLearned)
    assert not pol.wants_ticks and not pol.redistribute
    cuda = torch.device("cuda")
    assert resolve_impl("step", cuda, pol) == "step"
    assert resolve_impl(None, torch.device("cpu"), pol) == "plain"
    with pytest.raises(ValueError, match="CUDA device"):
        resolve_impl("step", torch.device("cpu"), pol)


def test_learned_declares_the_learned_kernel_mode():
    from repro_torch.kernels.power_step import WAVE_MODES

    assert kernel_mode(TorchLearned()) == "learned"
    assert WAVE_MODES["learned"] == 4

    class Tweaked(TorchLearned):
        """A subclass does not inherit the mode."""

    assert kernel_mode(Tweaked()) is None


def test_learned_resolves_to_the_kernel_on_the_card(monkeypatch):
    """``impl=None`` on a (monkeypatched) CUDA device picks the
    whole-row kernel, as it does for every registry policy."""
    from repro_torch.backends import engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = engine.resolve_device(None)
    assert cuda.type == "cuda"
    assert resolve_impl(None, cuda, get_torch_policy("learned")) == "cuda"
    assert resolve_impl("cuda", cuda, TorchLearned()) == "cuda"


def _ascending_dot(a, w):
    """numpy float32 loops: each output's products in ascending input
    order, every product and sum rounded."""
    a, w = np.asarray(a, np.float32), np.asarray(w, np.float32)
    wm = w if w.ndim == 2 else w[:, None]
    out = np.empty(a.shape[:-1] + wm.shape[1:], np.float32)
    for idx in np.ndindex(*a.shape[:-1]):
        for j in range(wm.shape[1]):
            acc = np.float32(a[idx][0] * wm[0, j])
            for k in range(1, a.shape[-1]):
                acc = np.float32(acc + np.float32(a[idx][k] * wm[k, j]))
            out[idx + (j,)] = acc
    return out if w.ndim == 2 else out[..., 0]


def _warp_sum(x):
    """numpy float32 loops of the warp's order: lane i in slot i // 32
    of thread i % 32, each thread's slots summed in order, then the xor
    butterfly 16, 8, 4, 2, 1 (thread t adds t + off)."""
    x = np.asarray(x, np.float32)
    out = np.empty(x.shape[:-1], np.float32)
    for idx in np.ndindex(*x.shape[:-1]):
        row = x[idx]
        acc = [np.float32(0.0)] * 32
        for i, v in enumerate(row):
            acc[i % 32] = np.float32(v) if i < 32 else \
                np.float32(acc[i % 32] + v)
        for off in (16, 8, 4, 2, 1):
            acc = [np.float32(acc[t] + acc[t + off]) for t in range(off)]
        out[idx] = acc[0]
    return out


@pytest.mark.parametrize("n", [3, 33, 70])
def test_torch_namespace_sums_in_the_kernel_order(n):
    """``lane_sum`` and ``matmul`` equal the kernel's order spelled in
    numpy loops bit for bit; zero lanes added to a row change nothing;
    under numpy the hooks are ``.sum(-1)`` and ``@``."""
    rng = np.random.default_rng(n)
    x = rng.uniform(0.0, 9.0, (4, n)).astype(np.float32)
    got = _TorchXP.lane_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _warp_sum(x))
    padded = np.concatenate([x, np.zeros((4, 5), np.float32)], axis=-1)
    np.testing.assert_array_equal(
        _TorchXP.lane_sum(torch.from_numpy(padded)).numpy(), got)
    feats = rng.normal(size=(2, n, 8)).astype(np.float32)
    w1 = rng.normal(size=(8, 16)).astype(np.float32)
    w3 = rng.normal(size=16).astype(np.float32)
    h = _TorchXP.matmul(torch.from_numpy(feats), torch.from_numpy(w1))
    np.testing.assert_array_equal(h.numpy(), _ascending_dot(feats, w1))
    o = _TorchXP.matmul(h, torch.from_numpy(w3))
    np.testing.assert_array_equal(o.numpy(), _ascending_dot(h.numpy(), w3))
    np.testing.assert_allclose(h.numpy(), feats @ w1, rtol=1e-5, atol=1e-5)
    assert port_learned.lane_sum(np, x).tolist() == x.sum(-1).tolist()


def test_torch_engine_matches_jax_learned_on_listing2():
    """The reordered plain path against ``JaxLearned`` in the shared
    layout (one graph, exact lane count)."""
    from repro.core import homogeneous_cluster, listing2_graph

    g, specs = listing2_graph(), homogeneous_cluster(3)
    bounds = [2.5, 4.0, 6.0, 7.5, 9.0, 12.0, 20.0]
    want = JaxBatchSimulator(g, specs, bounds, "learned").run()
    sim = TorchBatchSimulator(from_reference(g), from_reference(specs),
                              bounds, "learned", device="cpu")
    got = sim.run()
    assert sim.stats.path == "plain"
    _close(got, want, RTOL, STAMP_ATOL)


def test_torch_engine_matches_jax_learned_on_padded_mixed_n_bucket():
    """A padded bucket of mixed node counts (3 to 9 real lanes in a
    16-lane envelope): the phantom lanes add nothing to the kernel-order
    lane sums, and the rows stay within rtol 1e-5 of ``JaxLearned`` on
    the same envelope."""
    from repro.core import heterogeneous_cluster, is_like, listing2_graph
    from repro.core import homogeneous_cluster

    items = [(listing2_graph(), homogeneous_cluster(3)),
             (is_like(5, "A"), heterogeneous_cluster(5, seed=1)),
             (is_like(9, "A"), heterogeneous_cluster(9, seed=2)),
             (is_like(7, "A"), heterogeneous_cluster(7, seed=3))]
    bounds = [6.0, 0.6 * sum(s.lut.p_max for s in items[1][1]),
              0.4 * sum(s.lut.p_max for s in items[2][1]),
              0.8 * sum(s.lut.p_max for s in items[3][1])]
    pad = (16, 256, 32, 16, 16)
    want = JaxBatchSimulator.padded(items, bounds, "learned",
                                    pad_dims=pad).run()
    sim = TorchBatchSimulator.padded(
        [(from_reference(g), from_reference(sp)) for g, sp in items],
        bounds, "learned", pad_dims=pad, device="cpu")
    got = sim.run()
    assert sim.arrays.n_nodes == 16
    _close(got, want, RTOL, STAMP_ATOL)
    # each row alone in the shared layout (its exact lane count) gives
    # the padded row's result bit for bit
    for (g, sp), b, row in zip(items, bounds, got):
        alone = TorchBatchSimulator(from_reference(g), from_reference(sp),
                                    [b], "learned", device="cpu").run()[0]
        assert (alone.makespan, alone.energy_j, alone.job_ends) == \
            (row.makespan, row.energy_j, row.job_ends)


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
