"""The port's differentiable simulator, ``repro_torch.diff``, and the two
pieces of the exact numpy simulator it is held against (the smooth LUT
translator with ``simulate_batch(smooth_lut=True)``, and
``VectorStaticCaps``), against the reference's ``repro.diff`` and
``repro.core`` on the same inputs.

The reference runs in float64 inside ``jax.enable_x64(True)`` (and in its
default float32 for one value check); the port runs on the CPU.

* the smooth translator and the smooth-LUT batch simulator under
  ``VectorStaticCaps`` (static caps and a knot schedule, shared and
  padded layouts) are bit-equal to the reference's;
* ``smooth_operating_point`` agrees at 1e-12, ``soft_makespan`` on the
  zoo (static and ``(K, N)`` caps) at rtol 1e-9 with ``torch.autograd``
  gradients at normwise 1e-7 against ``jax.grad`` (rtol 1e-4 in
  float32), and ``soft_makespan_policy`` with its ``w3`` and ``bound``
  gradients likewise;
* ``optimize_static_caps`` and ``train_policy`` follow the reference's
  trajectories (caps and params at rtol 1e-7, losses at rtol 1e-9);
* the port's counterpart of each case of ``tests/test_diff_grad.py``:
  central finite differences on the zoo, schedules and the policy
  parameters, the fuzzed directional check, monotone annealing to the
  exact smooth-LUT makespan, ``torch.func.vmap`` against a loop, and the
  simplex map;
* the trainer's CLI writes a checkpoint the port's loader reads, and the
  entry points' default device is the card.
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import power as ref_power  # noqa: E402
from repro.core.batchsim import BatchSimulator as RefBatchSimulator  # noqa: E402,E501
from repro.core.workloads import (fork_join_graph as ref_fork_join,  # noqa: E402,E501
                                  layered_dag as ref_layered,
                                  listing2_graph as ref_listing2)
from repro.diff import optimize as ref_opt  # noqa: E402
from repro.diff import relax as ref_relax  # noqa: E402
from repro.diff import softsim as ref_soft  # noqa: E402
from repro.diff import train as ref_train  # noqa: E402
from repro.policies import VectorStaticCaps as RefStaticCaps  # noqa: E402
from repro.policies.learned import init_params  # noqa: E402

from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import power  # noqa: E402
from repro_torch.core.batchsim import BatchSimulator, simulate_batch  # noqa: E402,E501
from repro_torch.core.power import (heterogeneous_cluster,  # noqa: E402
                                    homogeneous_cluster, lut_table,
                                    max_useful_cluster_bound)
from repro_torch.core.workloads import (fork_join_graph,  # noqa: E402
                                        layered_dag, listing2_graph)
from repro_torch.diff import optimize, relax, softsim, train  # noqa: E402
from repro_torch.diff.optimize import caps_from_theta  # noqa: E402
from repro_torch.diff.softsim import (build_soft_arrays,  # noqa: E402
                                      soft_makespan, soft_makespan_policy)
from repro_torch.policies import VectorStaticCaps  # noqa: E402
from repro_torch.policies.learned import load_checkpoint  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # tier-1 runs without the dev extra
    from _hyp_stub import given, settings, st

ROOT = pathlib.Path(__file__).resolve().parents[1]
T_CHECK = 0.1
FD_H = 1e-5
GRAD_RTOL = 1e-3
LADDER = (0.5, 0.2, 0.1, 0.05, 0.02)
F64 = torch.float64


def _trace_graphs():
    """Listing 2 recorded and reconstructed, by each package's traces."""
    from repro import traces as rt
    from repro_torch import traces as pt

    ref = rt.reconstruct(rt.loads_trace(rt.dumps_trace(rt.record_graph(
        ref_listing2(), ref_power.homogeneous_cluster(3)))))
    port = pt.reconstruct(pt.loads_trace(pt.dumps_trace(pt.record_graph(
        listing2_graph(), homogeneous_cluster(3)))))
    return (ref.graph, ref.specs), (port.graph, port.specs)


_REF_TRACE, _PORT_TRACE = _trace_graphs()

#: (name, reference (graph, specs), port (graph, specs)): the reference's
#: graph zoo, each side built by its own package.
ZOO = [
    ("listing2", (ref_listing2(), ref_power.homogeneous_cluster(3)),
     (listing2_graph(), homogeneous_cluster(3))),
    ("layered", (ref_layered(4, layers=3, seed=11),
                 ref_power.homogeneous_cluster(4)),
     (layered_dag(4, layers=3, seed=11), homogeneous_cluster(4))),
    ("forkjoin", (ref_fork_join(4, stages=2, seed=12),
                  ref_power.heterogeneous_cluster(4)),
     (fork_join_graph(4, stages=2, seed=12), heterogeneous_cluster(4))),
    ("trace-recon", _REF_TRACE, _PORT_TRACE),
]
_ids = [z[0] for z in ZOO]


def generic_caps(specs, frac=0.55, seed=5):
    """A cap point away from LUT state powers and symmetry ties."""
    rng = np.random.default_rng(seed)
    tab = lut_table(specs)
    lo, hi = np.asarray(tab.cap_floor), np.asarray(tab.p_max)
    u = rng.uniform(0.35, 0.8, len(specs))
    return lo + (frac * u / u.mean()).clip(0.05, 0.95) * (hi - lo)


def central_fd(f, x, h=FD_H):
    x = np.asarray(x, dtype=float)
    out = np.zeros_like(x)
    for i in range(x.size):
        e = np.zeros_like(x)
        e.flat[i] = h
        out.flat[i] = (float(f(x + e)) - float(f(x - e))) / (2 * h)
    return out


def _normwise(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def _soft(specs_graph):
    graph, specs = specs_graph
    return build_soft_arrays(graph, specs, device="cpu")


def _value_grad(fn, x):
    x = torch.tensor(np.asarray(x, dtype=float), dtype=F64,
                     requires_grad=True)
    val = fn(x)
    (g,) = torch.autograd.grad(val, x)
    return float(val.detach()), g.numpy()


@pytest.fixture(scope="module")
def ref_softs():
    with jax.enable_x64(True):
        return {name: ref_soft.build_soft_arrays(*ref)
                for name, ref, _ in ZOO}


# ------------------------------------------- the exact simulator's pieces
def test_smooth_translator_is_bit_equal_to_the_reference():
    """At random caps and exactly at the state powers, both branches."""
    ref_specs = ref_power.heterogeneous_cluster(4)
    ref_tab = ref_power.lut_table(ref_specs)
    tab = lut_table(heterogeneous_cluster(4))
    rng = np.random.default_rng(0)
    state_caps = np.where(np.isfinite(tab.state_p), tab.state_p,
                          tab.p_max[:, None])
    caps = np.concatenate(
        [rng.uniform(0.1, 1.2 * float(np.max(tab.p_max)), (16, 4)),
         state_caps.T[:, :4].copy()])
    for smooth in (True, False):
        got = power.batched_operating_point(tab, caps, smooth=smooth)
        want = ref_power.batched_operating_point(ref_tab, caps,
                                                 smooth=smooth)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), smooth
    assert all(np.array_equal(a, b) for a, b in zip(
        power.batched_operating_point(tab, caps),
        ref_power.batched_operating_point(ref_tab, caps)))


@pytest.mark.parametrize("layout", ["shared", "padded"])
@pytest.mark.parametrize("scheduled", [False, True], ids=["static",
                                                          "schedule"])
def test_smooth_lut_simulate_batch_is_bit_equal(layout, scheduled):
    """``smooth_lut=True`` under ``VectorStaticCaps``: makespan and energy
    bit-equal to the reference's, for static caps and a knot schedule
    (one constant-bound ``bound_schedules`` arrival per knot)."""
    (rg, rs), (pg, ps_) = ZOO[2][1], ZOO[2][2]
    base = generic_caps(ps_)
    bound = float(base.sum())
    if scheduled:
        caps = dict(caps_schedule=np.stack([base, base[::-1].copy(),
                                            0.9 * base]))
        sched = [[(6.1, bound), (13.7, bound)]]
    else:
        caps, sched = dict(caps=base), None
    kw = dict(bound_schedules=sched, smooth_lut=True)
    if layout == "shared":
        want = RefBatchSimulator(rg, rs, [bound], policy=RefStaticCaps(
            **caps), **kw).run()
        got = BatchSimulator(pg, ps_, [bound],
                             policy=VectorStaticCaps(**caps), **kw).run()
    else:
        want = RefBatchSimulator.padded([(rg, rs)], [bound],
                                        policy=RefStaticCaps(**caps),
                                        **kw).run()
        got = BatchSimulator.padded([(pg, ps_)], [bound],
                                    policy=VectorStaticCaps(**caps),
                                    **kw).run()
    stepped = simulate_batch(pg, ps_, [bound],
                             policy=VectorStaticCaps(**caps),
                             bound_schedules=sched)[0]
    for g, w in zip(got, want):
        assert g.makespan == w.makespan and g.energy_j == w.energy_j
    assert stepped.makespan != got[0].makespan   # the flag does something


# ------------------------------------------------- against the reference
def test_smooth_operating_point_matches_the_reference():
    specs = heterogeneous_cluster(4)
    tab = lut_table(specs)
    rng = np.random.default_rng(0)
    state_caps = np.where(np.isfinite(tab.state_p), tab.state_p,
                          tab.p_max[:, None])
    caps = np.concatenate([rng.uniform(0.1, 1.2 * float(np.max(tab.p_max)),
                                       (16, 4)), state_caps.T[:, :4]])
    ttab = power.LUTTable(**{
        k: torch.tensor(np.asarray(getattr(tab, k)), dtype=F64)
        for k in softsim._TABLE_FIELDS})
    got = relax.smooth_operating_point(ttab, torch.tensor(caps, dtype=F64))
    with jax.enable_x64(True):
        want = ref_relax.smooth_operating_point(
            ref_power.lut_table(ref_power.heterogeneous_cluster(4)),
            jnp.asarray(caps))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)
    np_ref = power.batched_operating_point(tab, caps, smooth=True)
    for g, w in zip(got, np_ref):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,ref,port", ZOO, ids=_ids)
def test_soft_arrays_match_the_reference(name, ref, port, ref_softs):
    got, want = _soft(port), from_reference(ref_softs[name])
    for k in ("work_pad", "rho_pad", "node_seq", "deps_pad"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for k in softsim._TABLE_FIELDS:
        assert torch.equal(getattr(got.table, k), getattr(want.table, k))
    assert got[5:] == want[5:]


@pytest.mark.parametrize("scheduled", [False, True], ids=["static",
                                                          "schedule"])
@pytest.mark.parametrize("name,ref,port", ZOO, ids=_ids)
def test_soft_makespan_matches_jax_grad(name, ref, port, scheduled,
                                        ref_softs):
    """float64: values at rtol 1e-9, gradients at normwise 1e-7."""
    base = generic_caps(port[1])
    caps = np.stack([base, base[::-1].copy()]) if scheduled else base
    knots = np.array([7.3]) if scheduled else None
    soft = _soft(port)
    val, grad = _value_grad(
        lambda c: soft_makespan(c, soft, T_CHECK, knot_times=knots), caps)
    rs = ref_softs[name]
    with jax.enable_x64(True):
        rval, rgrad = jax.value_and_grad(
            lambda c: ref_soft.soft_makespan(c, rs, T_CHECK,
                                             knot_times=knots))(
            jnp.asarray(caps))
    assert val == pytest.approx(float(rval), rel=1e-9)
    assert _normwise(grad, rgrad) <= 1e-7


def test_soft_makespan_float32_matches_the_reference_default(ref_softs):
    """float32 caps run in float32, like the reference without x64 (on a
    homogeneous and a heterogeneous cluster)."""
    for name, _, port in (ZOO[0], ZOO[2]):
        caps = generic_caps(port[1]).astype(np.float32)
        got = soft_makespan(torch.tensor(caps), _soft(port), T_CHECK)
        with jax.enable_x64(False):
            want = ref_soft.soft_makespan(jnp.asarray(caps),
                                          ref_softs[name], T_CHECK)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        assert float(got) == pytest.approx(float(want), rel=1e-4), name


def _policy_case():
    params = init_params(seed=3)
    params["w3"] = np.random.default_rng(7).normal(0.0, 0.2,
                                                   params["w3"].shape)
    return params, 0.5 * max_useful_cluster_bound(homogeneous_cluster(4))


def test_soft_makespan_policy_matches_jax_grad(ref_softs):
    """Value, and the ``w3`` and ``bound`` gradients, in float64."""
    params, bound = _policy_case()
    soft = _soft(ZOO[1][2])
    leaves = {k: torch.tensor(v, dtype=F64, requires_grad=k == "w3")
              for k, v in params.items()}
    b = torch.tensor(bound, dtype=F64, requires_grad=True)
    val = soft_makespan_policy(leaves, soft, b, T_CHECK)
    g_w3, g_b = torch.autograd.grad(val, [leaves["w3"], b])
    rs = ref_softs["layered"]
    with jax.enable_x64(True):
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        rval, (rw3, rb) = jax.value_and_grad(
            lambda w3, b_: ref_soft.soft_makespan_policy(
                {**jp, "w3": w3}, rs, b_, T_CHECK), argnums=(0, 1))(
            jp["w3"], jnp.asarray(bound))
    assert float(val.detach()) == pytest.approx(float(rval), rel=1e-9)
    assert _normwise(g_w3.numpy(), rw3) <= 1e-7
    assert float(g_b) == pytest.approx(float(rb), rel=1e-7)
    assert np.linalg.norm(np.asarray(rw3)) > 0


def test_optimize_static_caps_follows_the_reference():
    (rg, rs), (pg, ps_) = ZOO[0][1], ZOO[0][2]
    got = optimize.optimize_static_caps(pg, ps_, 9.0, steps=10,
                                        device="cpu", dtype=F64)
    with jax.enable_x64(True):
        want = from_reference(ref_opt.optimize_static_caps(rg, rs, 9.0,
                                                           steps=10))
    np.testing.assert_allclose(got.caps, want.caps, rtol=1e-7)
    assert [h[:2] for h in got.history] == [h[:2] for h in want.history]
    np.testing.assert_allclose([h[2] for h in got.history],
                               [h[2] for h in want.history], rtol=1e-9)
    assert got.soft_makespan == pytest.approx(want.soft_makespan, rel=1e-9)
    assert got.exact_makespan == pytest.approx(want.exact_makespan,
                                               rel=1e-9)
    assert got.caps.sum() == pytest.approx(9.0, rel=1e-12)


def test_train_policy_follows_the_reference():
    got, meta = train.train_policy(quick=True, steps=3, verbose=False,
                                   device="cpu", dtype=F64)
    with jax.enable_x64(True):
        want, ref_meta = ref_train.train_policy(quick=True, steps=3,
                                                verbose=False)
    # b3 shifts every logit alike, and the softmax split is blind to a
    # shift: its gradient is rounding noise, which Adam's eps turns into
    # moves of ~1e-11 (lr x noise / eps) on either side.
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=1e-10,
                                   err_msg=k)
    assert meta.keys() == ref_meta.keys()
    assert meta["scenarios"] == ref_meta["scenarios"]
    hist, ref_hist = meta["loss_history"], ref_meta["loss_history"]
    assert [h[:2] for h in hist] == [h[:2] for h in ref_hist]
    np.testing.assert_allclose([h[2] for h in hist],
                               [h[2] for h in ref_hist], rtol=1e-9)


# ----------------------------------- counterparts of test_diff_grad.py
class TestGradMatchesFD:
    @pytest.mark.parametrize("name,ref,port", ZOO, ids=_ids)
    def test_static_caps_grad(self, name, ref, port):
        soft = _soft(port)
        caps = generic_caps(port[1])

        def f(c):
            return soft_makespan(torch.as_tensor(c, dtype=F64), soft,
                                 T_CHECK)

        _, grad = _value_grad(f, caps)
        fd = central_fd(f, caps)
        assert np.linalg.norm(grad - fd) <= \
            GRAD_RTOL * max(np.linalg.norm(fd), 1e-9), \
            f"{name}: grad {grad} vs FD {fd}"

    @pytest.mark.parametrize("name,ref,port", ZOO[:2], ids=_ids[:2])
    def test_schedule_grad(self, name, ref, port):
        """(K, N) piecewise-constant schedules differentiate too."""
        soft = _soft(port)
        base = generic_caps(port[1])
        sched = np.stack([base, base[::-1].copy()])
        knots = np.array([7.3])

        def f(c):
            return soft_makespan(torch.as_tensor(c, dtype=F64), soft,
                                 T_CHECK, knot_times=knots)

        _, grad = _value_grad(f, sched)
        fd = central_fd(lambda c: f(np.reshape(c, sched.shape)),
                        sched.ravel()).reshape(sched.shape)
        assert np.linalg.norm(grad - fd) <= \
            GRAD_RTOL * max(np.linalg.norm(fd), 1e-9)

    def test_knot_times_get_no_gradient(self):
        soft = _soft(ZOO[0][2])
        base = generic_caps(ZOO[0][2][1])
        knots = torch.tensor([7.3], dtype=F64, requires_grad=True)
        caps = torch.tensor(np.stack([base, base[::-1].copy()]), dtype=F64,
                            requires_grad=True)
        val = soft_makespan(caps, soft, T_CHECK, knot_times=knots)
        g_caps, g_knots = torch.autograd.grad(val, [caps, knots],
                                              allow_unused=True)
        assert g_knots is None and torch.isfinite(g_caps).all()

    def test_policy_params_grad(self):
        """Gradients w.r.t. the learned-policy MLP parameters, on a
        rho-diverse graph."""
        params, bound = _policy_case()
        soft = _soft(ZOO[1][2])

        def f(w3):
            leaves = {k: torch.tensor(v, dtype=F64)
                      for k, v in params.items()}
            leaves["w3"] = torch.as_tensor(w3, dtype=F64)
            return soft_makespan_policy(leaves, soft, bound, T_CHECK)

        _, grad = _value_grad(f, params["w3"])
        fd = central_fd(f, params["w3"])
        assert np.linalg.norm(fd) > 0          # the signal exists
        assert np.linalg.norm(grad - fd) <= \
            GRAD_RTOL * max(np.linalg.norm(fd), 1e-9)

    @staticmethod
    def _directional(seed):
        """Directional derivative along a random direction at a random
        cap point of the layered graph, against central differences."""
        port = ZOO[1][2]
        soft = _soft(port)
        rng = np.random.default_rng(seed)
        caps = generic_caps(port[1], frac=float(rng.uniform(0.4, 0.7)),
                            seed=seed)
        d = rng.normal(size=caps.shape)
        d /= np.linalg.norm(d)

        def f(c):
            return soft_makespan(torch.as_tensor(c, dtype=F64), soft,
                                 T_CHECK)

        _, grad = _value_grad(f, caps)
        h = FD_H * 10
        fd_dir = (float(f(caps + h * d)) - float(f(caps - h * d))) / (2 * h)
        assert float(grad @ d) == pytest.approx(
            fd_dir, rel=GRAD_RTOL * 10, abs=GRAD_RTOL)

    @settings(max_examples=5, deadline=None)
    @given(st.integers(min_value=0, max_value=10_000))
    def test_fuzzed_cap_perturbations(self, seed):
        self._directional(seed)

    @pytest.mark.parametrize("seed", [0, 1234, 9999])
    def test_cap_perturbations_at_fixed_seeds(self, seed):
        self._directional(seed)


class TestAnnealingConvergence:
    @pytest.mark.parametrize("name,ref,port", ZOO, ids=_ids)
    def test_soft_converges_to_exact(self, name, ref, port):
        """|soft - exact| -> 0 monotonically down the ladder, "exact"
        being the port's numpy simulator under the same smooth LUT and
        the same static caps."""
        graph, specs = port
        soft = _soft(port)
        caps = generic_caps(specs)
        bound = float(caps.sum())
        exact = simulate_batch(graph, specs, [bound],
                               policy=VectorStaticCaps(caps=caps),
                               smooth_lut=True)[0].makespan
        errs = [abs(float(soft_makespan(caps, soft, t)) - exact)
                for t in LADDER]
        for hot, cold in zip(errs, errs[1:]):
            assert cold <= hot + 1e-9, f"{name}: not monotone: {errs}"
        assert errs[-1] <= 1e-3 * exact, f"{name}: {errs} vs {exact}"

    def test_scheduled_caps_converge(self):
        graph, specs = ZOO[0][2]
        soft = _soft(ZOO[0][2])
        base = generic_caps(specs)
        sched = np.stack([base, base[::-1].copy()])
        knots = [9.7]
        bound = float(base.sum())
        exact = simulate_batch(
            graph, specs, [bound],
            policy=VectorStaticCaps(caps_schedule=sched),
            bound_schedules=[[(knots[0], bound)]],
            smooth_lut=True)[0].makespan
        errs = [abs(float(soft_makespan(sched, soft, t,
                                        knot_times=np.asarray(knots)))
                    - exact) for t in LADDER]
        for hot, cold in zip(errs, errs[1:]):
            assert cold <= hot + 1e-9, f"not monotone: {errs}"
        assert errs[-1] <= 1e-3 * exact
        assert optimize.evaluate_static_caps(sched, graph, specs, bound,
                                             knot_times=knots) == exact


class TestSmoothLut:
    def test_agrees_with_hard_translator_at_states(self):
        tab = lut_table(homogeneous_cluster(2))
        caps = np.asarray(tab.state_p)[0][None, :].repeat(2, 0).T
        hard = power.batched_operating_point(tab, caps)
        smooth = power.batched_operating_point(tab, caps, smooth=True)
        for h, s in zip(hard, smooth):
            np.testing.assert_allclose(s, h, rtol=1e-12)


class TestTransformCompat:
    def test_vmap_matches_loop(self):
        port = ZOO[0][2]
        soft = _soft(port)
        caps_b = torch.tensor(np.stack([generic_caps(port[1], seed=s)
                                        for s in range(4)]), dtype=F64)

        def f(c):
            return soft_makespan(c, soft, T_CHECK)

        batched = torch.func.vmap(f)(caps_b)
        single = torch.stack([f(c) for c in caps_b])
        torch.testing.assert_close(batched, single, rtol=1e-6, atol=0)
        g_batched = torch.func.vmap(torch.func.grad(f))(caps_b)
        g_single = torch.stack([torch.func.grad(f)(c) for c in caps_b])
        torch.testing.assert_close(g_batched, g_single, rtol=1e-6,
                                   atol=1e-12)

    def test_simplex_parameterization_respects_bound(self):
        """caps_from_theta outputs sum to the bound and sit at or above
        the duty floor for any theta."""
        tab = lut_table(heterogeneous_cluster(3))
        floor = torch.tensor(tab.cap_floor, dtype=F64)
        bound = 11.0
        rng = np.random.default_rng(3)
        for _ in range(5):
            theta = torch.tensor(rng.normal(0, 3, 3), dtype=F64)
            caps = caps_from_theta(theta, floor, bound)
            assert float(caps.sum()) == pytest.approx(bound, rel=1e-6)
            assert bool((caps >= floor - 1e-9).all())


# ------------------------------------------------------ CLI and devices
def test_train_cli_writes_a_checkpoint_the_port_reads(tmp_path, capsys):
    out = tmp_path / "ckpt.json"
    assert train.main(["--device", "cpu", "--quick", "--steps", "2",
                       "--out", str(out)]) == 0
    assert f"wrote {out}" in capsys.readouterr().out
    params = load_checkpoint(out)
    assert set(params) == {"W1", "b1", "W2", "b2", "w3", "b3"}
    meta = json.loads(out.read_text())["meta"]
    ref_meta = json.loads((ROOT / "src/repro/policies/"
                           "learned_default.json").read_text())["meta"]
    # at least one step a temperature: 2 steps on a 3-rung ladder run 3
    assert meta.keys() == ref_meta.keys() and meta["steps"] == 3
    for rel in ("src/repro/policies/learned_default.json",
                "src/repro_torch/policies/learned_default.json"):
        digest = hashlib.sha256((ROOT / rel).read_bytes()).hexdigest()
        assert digest == ("817e26a6ec0857ea167922ccfb61300d"
                          "cd9d6a5fa317da3240219b560f4d888c"), rel


def test_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` is the card: without CUDA each entry point raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph, specs = ZOO[0][2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_soft_arrays(graph, specs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize.optimize_static_caps(graph, specs, 9.0, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train_policy(steps=1, quick=True, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--quick", "--steps", "1"])


def test_lazy_exports_match_the_reference():
    import repro.diff as ref_diff
    import repro_torch.diff as diff

    assert set(diff.__all__) == set(ref_diff.__all__) - {"HAS_JAX"}
    for name in diff.__all__:
        assert callable(getattr(diff, name)) or name == "SoftArrays"
    with pytest.raises(AttributeError):
        diff.missing_name
