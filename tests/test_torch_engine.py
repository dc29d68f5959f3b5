"""The port's wave engine against the JAX reference engine (shared layout).

The reference's graph and cluster are carried across with
``repro_torch.convert.from_reference``; both engines then build the same
geometry and policy state (checked array for array) and run the same
bounds.  Per row: makespan, energy, peak power and over-budget time
within ``rtol=1e-5``, job start/end stamps within ``atol=1e-4``, the
same set of completed jobs.  The reference engine runs float32; under
``jax_enable_x64`` it would run float64, so the comparison is skipped.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.backends.jax import JaxBatchSimulator  # noqa: E402
from repro.core import ilp as ref_ilp  # noqa: E402
from repro.core.power import (heterogeneous_cluster,  # noqa: E402
                              homogeneous_cluster,
                              max_useful_cluster_bound,
                              min_feasible_cluster_bound)
from repro.core.workloads import is_like, listing2_graph  # noqa: E402

from repro_torch.backends import engine as port_engine  # noqa: E402
from repro_torch.backends.engine import (TorchBatchSimulator,  # noqa: E402
                                         simulate_batch_torch)
from repro_torch.backends.policies import (get_torch_policy,  # noqa: E402
                                           torch_policies)
from repro_torch.convert import from_reference  # noqa: E402

POLICIES = ("equal-share", "ilp", "ilp-makespan", "oracle", "heuristic")


@pytest.fixture(autouse=True)
def _float32_reference():
    if jax.config.jax_enable_x64:
        pytest.skip("jax_enable_x64 is on: the reference engine would run "
                    "float64, the port runs float32")


def assert_same_results(ref, port):
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        for f in ("makespan", "energy_j", "peak_power_w",
                  "over_budget_time"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=1e-5, atol=1e-9, err_msg=f)
        assert a.job_ends.keys() == b.job_ends.keys()
        assert a.job_starts.keys() == b.job_starts.keys()
        for k in a.job_ends:
            assert abs(a.job_ends[k] - b.job_ends[k]) <= 1e-4, k
            assert abs(a.job_starts[k] - b.job_starts[k]) <= 1e-4, k


def assert_same_inputs(jsim, tsim):
    """Both engines built the same geometry and policy state."""
    ref = from_reference(jsim.arrays)
    for name in ("work_pad", "rho_pad", "node_seq", "deps_pad"):
        np.testing.assert_array_equal(getattr(tsim.arrays, name),
                                      getattr(ref, name))
    for name in ("state_p", "state_f", "idle_w", "p_max", "cap_floor",
                 "speed"):
        np.testing.assert_array_equal(getattr(tsim.arrays.table, name),
                                      getattr(ref.table, name))
    jstate = from_reference(jsim.policy.init_state(jsim))
    tstate = from_reference(tsim.policy.init_state(tsim))
    assert jstate.keys() == tstate.keys()
    for k in jstate:
        assert torch.equal(jstate[k], tstate[k]), k


def run_both(graph, specs, bounds, policy, **kw):
    jsim = JaxBatchSimulator(graph, specs, bounds, policy, **kw)
    tsim = TorchBatchSimulator(from_reference(graph), from_reference(specs),
                               bounds, policy, device="cpu",
                               **{k: from_reference(v) if k == "assignments"
                                  else v for k, v in kw.items()})
    assert_same_inputs(jsim, tsim)
    assert_same_results(jsim.run(), tsim.run())
    return tsim


def solved(policy, graph, specs, bounds):
    """ILP assignments solved once by the reference (time-limited) and
    given to both engines; other policies take no arguments."""
    if not policy.startswith("ilp"):
        return {}
    solver = (ref_ilp.build_makespan_milp if policy == "ilp-makespan"
              else ref_ilp.solve_paper_ilp)
    return {"assignments": [solver(graph, specs, b, time_limit=5.0)
                            for b in bounds]}


@pytest.mark.parametrize("policy", POLICIES)
def test_listing2_matches_reference(policy):
    """Listing 2 on three nodes."""
    graph, specs = listing2_graph(), homogeneous_cluster(3)
    bounds = [2.5, 6.0, 12.0]
    run_both(graph, specs, bounds, policy,
             **solved(policy, graph, specs, bounds))


def test_listing2_ilp_solved_inside_each_engine():
    """With no assignments given, each engine solves the paper ILP with
    its own copy of the solver, once per bound."""
    run_both(listing2_graph(), homogeneous_cluster(3), [2.5, 12.0], "ilp")


@pytest.mark.parametrize("policy", POLICIES)
def test_is_analogue_matches_reference(policy):
    """The NPB-IS analogue on a 4-node mixed cluster (ragged LUTs)."""
    graph = is_like(4, "A")
    specs = heterogeneous_cluster(4)
    lo = min_feasible_cluster_bound(specs)
    hi = max_useful_cluster_bound(specs)
    bounds = [lo + f * (hi - lo) for f in (0.6, 0.9)]
    run_both(graph, specs, bounds, policy,
             **solved(policy, graph, specs, bounds))


def test_deadlock_raises_like_reference():
    """Each lane's first job waits on the other lane's second job: both
    engines raise the same deadlock error, tick policy included."""
    from repro.core import JobDependencyGraph

    g = JobDependencyGraph()
    g.add(0, 1, 5.0, deps=[(1, 2)])
    g.add(0, 2, 5.0)
    g.add(1, 1, 5.0, deps=[(0, 2)])
    g.add(1, 2, 5.0)
    for policy in ("equal-share", "heuristic"):
        with pytest.raises(RuntimeError, match="deadlock") as ref:
            JaxBatchSimulator(g, homogeneous_cluster(2), [6.0], policy).run()
        with pytest.raises(RuntimeError, match="deadlock") as port:
            simulate_batch_torch(from_reference(g),
                                 from_reference(homogeneous_cluster(2)),
                                 [6.0], policy, device="cpu")
        assert str(port.value) == str(ref.value)


def test_default_device_needs_cuda(monkeypatch):
    """``device=None`` means the card: without CUDA it raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph = from_reference(listing2_graph())
    specs = from_reference(homogeneous_cluster(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBatchSimulator(graph, specs, [6.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_engine.resolve_device(None)
    assert port_engine.resolve_device("cpu") == torch.device("cpu")


def test_validation_and_registry():
    graph = from_reference(listing2_graph())
    specs = from_reference(homogeneous_cluster(3))
    with pytest.raises(ValueError, match="dt"):
        TorchBatchSimulator(graph, specs, [6.0], dt=0.0, device="cpu")
    with pytest.raises(ValueError, match="bounds"):
        TorchBatchSimulator(graph, specs, [], device="cpu")
    with pytest.raises(ValueError, match="NodeSpec"):
        TorchBatchSimulator(graph, specs[:2], [6.0], device="cpu")
    with pytest.raises(ValueError, match="policy_kwargs"):
        TorchBatchSimulator(graph, specs, [6.0],
                            policy=get_torch_policy("equal-share"),
                            device="cpu", time_limit=5.0)
    with pytest.raises(KeyError, match="no torch policy"):
        get_torch_policy("countdown")
    assert set(POLICIES) <= set(torch_policies())
    for name in ("equal-share", "ilp", "ilp-makespan", "oracle"):
        assert get_torch_policy(name).exact
    heur = get_torch_policy("heuristic")
    assert not heur.exact and heur.wants_ticks
    assert get_torch_policy("oracle").redistribute
