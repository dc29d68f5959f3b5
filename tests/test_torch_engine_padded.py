"""The port's wave engine against the JAX reference engine (padded layout).

A stacked batch of the reference's ``mixed_family`` members (six graph
shapes, phantom lanes and job slots, bound schedules that drop and
recover mid-run) runs through ``JaxBatchSimulator.padded`` and
``TorchBatchSimulator.padded`` on the same arrays, at the tolerances of
``test_torch_engine.py``.
"""

import pytest

jax = pytest.importorskip("jax")

from repro.backends.jax import JaxBatchSimulator  # noqa: E402
from repro.core import ilp as ref_ilp  # noqa: E402
from repro.core.power import homogeneous_cluster  # noqa: E402
from repro.core.scenarios import mixed_family  # noqa: E402
from repro.core.workloads import listing2_graph  # noqa: E402

from repro_torch.backends.engine import TorchBatchSimulator  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402

from test_torch_engine import (assert_same_inputs,  # noqa: E402
                               assert_same_results)


@pytest.fixture(autouse=True)
def _float32_reference():
    if jax.config.jax_enable_x64:
        pytest.skip("jax_enable_x64 is on: the reference engine would run "
                    "float64, the port runs float32")


def _bucket(members, fracs):
    """(items, bounds, schedules) of the members x bound fractions."""
    items, bounds, scheds = [], [], []
    for m in mixed_family(seed=0).members:
        if m.name not in members:
            continue
        for f in fracs:
            bound = _bound(m, f)
            items.append((m.graph, m.specs))
            bounds.append(bound)
            scheds.append(tuple((t, s * bound) for t, s in m.bound_steps))
    return items, bounds, scheds


def _bound(member, frac):
    from repro.core.power import (max_useful_cluster_bound,
                                  min_feasible_cluster_bound)

    lo = min_feasible_cluster_bound(member.specs)
    hi = max_useful_cluster_bound(member.specs)
    return lo + frac * (hi - lo)


def run_padded(items, bounds, scheds, policy, **kw):
    jsim = JaxBatchSimulator.padded(items, bounds, policy,
                                    bound_schedules=scheds, **kw)
    port_items = [(from_reference(g), from_reference(list(sp)))
                  for g, sp in items]
    tsim = TorchBatchSimulator.padded(
        port_items, bounds, policy, bound_schedules=scheds, device="cpu",
        **{k: from_reference(v) for k, v in kw.items()})
    assert_same_inputs(jsim, tsim)
    for name in ("n_jobs_row", "n_active"):
        assert list(getattr(tsim.arrays, name)) == \
            list(getattr(jsim.arrays, name))
    assert_same_results(jsim.run(), tsim.run())


ALL = ("l2", "l2r", "is4", "layered5", "forkjoin4", "moe6")


@pytest.mark.parametrize("policy", ["equal-share", "oracle", "heuristic"])
def test_mixed_bucket_matches_reference(policy):
    """All six members x three bound fractions in one stacked batch."""
    run_padded(*_bucket(ALL, (0.15, 0.4, 0.8)), policy)


@pytest.mark.parametrize("policy", ["ilp", "ilp-makespan"])
def test_mixed_bucket_ilp_matches_reference(policy):
    """The ILP policies on the members whose MILPs solve in well under a
    second, with schedules; assignments solved once and shared."""
    items, bounds, scheds = _bucket(("l2", "l2r", "layered5", "forkjoin4"),
                                    (0.15, 0.8))
    solver = (ref_ilp.build_makespan_milp if policy == "ilp-makespan"
              else ref_ilp.solve_paper_ilp)
    assignments = [solver(g, sp, b, time_limit=5.0)
                   for (g, sp), b in zip(items, bounds)]
    run_padded(items, bounds, scheds, policy, assignments=assignments)


def test_results_do_not_depend_on_check_period():
    """Liveness is tested every k loop iterations; the iterations after
    every row finished change nothing."""
    graph = from_reference(listing2_graph())
    specs = from_reference(homogeneous_cluster(3))
    for policy in ("oracle", "heuristic"):
        outs = []
        for k in (1, 64):
            sim = TorchBatchSimulator(graph, specs, [6.0, 12.0], policy,
                                      device="cpu", check_every=k)
            outs.append(sim.run())
        assert sim.stats.waves % 64 == 0
        for a, b in zip(*outs):
            assert (a.makespan, a.energy_j, a.peak_power_w,
                    a.over_budget_time) == (b.makespan, b.energy_j,
                                            b.peak_power_w,
                                            b.over_budget_time)
            assert a.job_ends == b.job_ends and a.job_starts == b.job_starts
