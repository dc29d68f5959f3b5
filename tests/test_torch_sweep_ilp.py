"""``SweepEngine(executor="torch", device="cpu")`` against the
reference's ``SweepEngine(executor="jax")`` on ``mixed_family(seed=0)``:
the ILP policies (the reference's solves handed to the port, see
``_torch_sweep_parity.py``) and ``learned``; record for record as in
``test_torch_sweep.py``.  Also: an infeasible ILP is one failed record
on every executor, never a raised sweep, and ILP solves are shared per
(graph, cluster, bound, solver).
"""

import pytest

pytest.importorskip("jax")

from repro_torch.core import (Scenario, SweepEngine, homogeneous_cluster,
                              listing2_graph)

from _torch_sweep_parity import assert_record_for_record, run_both

POLICIES = ("ilp", "ilp-makespan", "learned")


@pytest.fixture(scope="module")
def sweeps():
    return run_both(POLICIES)


def test_record_for_record_against_jax(sweeps):
    ref, port = sweeps
    assert_record_for_record(port, ref)
    assert all(r.backend == "torch" for r in port.records)
    assert {r.scenario.policy for r in port.records} == set(POLICIES)


def test_ilp_failure_is_per_scenario():
    """An infeasible bound fails its own cell on the torch executor (the
    batch runs the rest), and on the process executor (spawned workers)."""
    g = listing2_graph()
    specs = tuple(homogeneous_cluster(3))
    cells = [Scenario(name="ok", graph=g, specs=specs, bound_w=6.0,
                      policy="ilp"),
             Scenario(name="bad", graph=g, specs=specs, bound_w=0.1,
                      policy="ilp")]
    for engine in (SweepEngine(executor="torch", device="cpu"),
                   SweepEngine(executor="process", max_workers=2)):
        sweep = engine.run(cells)
        assert [r.scenario.name for r in sweep.failures] == ["bad"]
        assert sweep.result("ok", "ilp", 6.0).makespan > 0
        if engine.executor == "torch":
            assert sweep.failures[0].backend == "torch"
            assert sweep.failures[0].bucket is None


def test_shared_ilp_setup_solves_once(monkeypatch):
    """Two ilp cells on the same (graph, cluster, bound) solve once."""
    import repro_torch.core.ilp as ilp_mod

    calls = []
    real = ilp_mod.solve_paper_ilp
    monkeypatch.setattr(ilp_mod, "solve_paper_ilp",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    g = listing2_graph()
    specs = tuple(homogeneous_cluster(3))
    cells = [Scenario(name="a", graph=g, specs=specs, bound_w=6.0,
                      policy="ilp", latency_s=lat) for lat in (0.05, 0.5)]
    sweep = SweepEngine(executor="torch", device="cpu").run(cells)
    assert not sweep.failures and len(calls) == 1
