"""Tie-breaking in the port's simulators: the counterpart of
``tests/test_sim_invariants.py::TestTieBreakingDeterminism``.

Two jobs completing at the *same instant* must resolve identically
everywhere: the port's event simulator pops the tied completions one by
one, its vector backend collapses them into a single wave, and the torch
engine (on the CPU, its plain path) completes them in one lockstep
iteration — yet the downstream start times, makespan and energy have to
agree, with the reference's event simulator too, and repeating a run
must be bit-stable (no dict-ordering or accumulation nondeterminism).
"""

import pytest

from repro.core import JobDependencyGraph as RefGraph
from repro.core import homogeneous_cluster as ref_cluster
from repro.core import simulate as ref_simulate

from repro_torch import simulate_batch_torch
from repro_torch.core import (JobDependencyGraph, homogeneous_cluster,
                              simulate, simulate_batch)

DT = 0.05


def tied_graph(cls):
    g = cls()
    g.add(0, 0, 6.0)
    g.add(1, 0, 6.0)          # exact tie with (0, 0) under equal caps
    g.add(2, 0, 6.0)          # triple tie
    g.add(0, 1, 3.0, deps=[(0, 0), (1, 0), (2, 0)])
    g.validate()
    return g


@pytest.mark.parametrize("policy", ["equal-share", "oracle", "learned"])
def test_simultaneous_completions_agree_across_backends(policy):
    g = tied_graph(JobDependencyGraph)
    specs = homogeneous_cluster(3)
    for bound in (4.5, 9.0):
        ev = simulate(g, specs, bound, policy)
        ref = ref_simulate(tied_graph(RefGraph), ref_cluster(3), bound,
                           policy)
        assert ev.makespan == pytest.approx(ref.makespan, rel=1e-12)
        assert ev.energy_j == pytest.approx(ref.energy_j, rel=1e-12)
        assert ev.job_starts == pytest.approx(ref.job_starts, rel=1e-12)
        vec = simulate_batch(g, specs, [bound], policy, dt=DT)[0]
        assert vec.makespan == pytest.approx(ev.makespan, rel=1e-9)
        assert vec.energy_j == pytest.approx(ev.energy_j, rel=1e-6)
        assert vec.job_ends.keys() == ev.job_ends.keys()
        tb = simulate_batch_torch(g, specs, [bound], policy, dt=DT,
                                  device="cpu")[0]
        assert tb.makespan == pytest.approx(ev.makespan, rel=1e-4)
        assert tb.energy_j == pytest.approx(ev.energy_j, rel=1e-4)
        assert tb.job_ends.keys() == ev.job_ends.keys()
        # the three tied jobs end together, and the dependent starts then
        ends = [tb.job_ends[(n, 0)] for n in range(3)]
        assert len(set(ends)) == 1
        assert tb.job_starts[(0, 1)] == ends[0]


def test_tie_resolution_is_bit_deterministic_across_repeats():
    g = tied_graph(JobDependencyGraph)
    specs = homogeneous_cluster(3)
    runs_ev = [simulate(g, specs, 6.0, "learned").makespan
               for _ in range(3)]
    runs_vec = [simulate_batch(g, specs, [6.0], "learned")[0].makespan
                for _ in range(3)]
    runs_torch = [simulate_batch_torch(g, specs, [6.0, 6.0], "learned",
                                       device="cpu")
                  for _ in range(3)]
    assert len(set(runs_ev)) == 1
    assert len(set(runs_vec)) == 1
    assert runs_vec[0] == pytest.approx(runs_ev[0], rel=1e-12)
    first = runs_torch[0][0]
    for rows in runs_torch:
        for r in rows:           # every repeat and every row: bit-equal
            assert (r.makespan, r.energy_j, r.job_starts, r.job_ends) == \
                (first.makespan, first.energy_j, first.job_starts,
                 first.job_ends)
    assert first.makespan == pytest.approx(runs_ev[0], rel=1e-4)
