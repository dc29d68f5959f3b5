"""``SweepEngine(executor="torch", device="cpu")`` against the
reference's ``SweepEngine(executor="jax")`` on ``mixed_family(seed=0)``.

This file holds the solver-free policies (equal-share, oracle, the
tick-quantized heuristic, and countdown, which has no batched
implementation and lands on the event simulator in both);
``test_torch_sweep_ilp.py`` holds ilp, ilp-makespan and learned.  Record
for record: the same backend (torch where the reference says jax), the
same fallback reason, the same bucket label after its backend prefix,
results at rtol 1e-5 and job stamps at atol 1e-4 (event records at rel
1e-12), and the same CSV columns.  Also the profile the torch sweep
returns, and its acceptance against the event simulator (the
reference's ``tests/test_scenarios.py`` mixed-family check).
"""

import pytest

pytest.importorskip("jax")

from repro_torch.core import SweepEngine, mixed_family, simulate

from _torch_sweep_parity import assert_record_for_record, run_both

POLICIES = ("equal-share", "oracle", "heuristic", "countdown")
DT = 0.05
MAKESPAN_ATOL, ENERGY_RTOL = 2 * DT, 0.01


@pytest.fixture(scope="module")
def sweeps():
    return run_both(POLICIES)


def test_record_for_record_against_jax(sweeps):
    ref, port = sweeps
    assert_record_for_record(port, ref)


def test_backend_accounting(sweeps):
    ref, port = sweeps
    counts = {b: sum(r.backend == b for r in port.records)
              for b in ("torch", "event")}
    assert counts == {"torch": 54, "event": 18}
    assert {r.fallback_reason for r in port.records
            if r.backend == "event"} == {"no-vector-policy(countdown)"}
    want = ref.backend_summary().split(" | jit")[0].replace("jax", "torch")
    assert port.backend_summary().startswith(want)


def test_profile_has_one_entry_per_torch_bucket(sweeps):
    _, port = sweeps
    buckets = {r.bucket for r in port.records if r.backend == "torch"}
    prof = port.profile
    assert {b.bucket for b in prof.buckets} == buckets
    assert sum(b.rows for b in prof.buckets) == 54
    for b in prof.buckets:
        assert b.path == "plain" and b.kernel_ms is None
        assert not b.compiled and b.compile_s == 0.0
        assert min(b.pack_s, b.dispatch_s, b.transfer_s, b.results_s) >= 0
    d = prof.to_dict()
    assert {"compiles", "cache_hits", "pack_s", "compile_s", "run_s",
            "transfer_s", "buckets"} <= set(d)
    assert {"bucket", "rows", "devices", "compiled", "cache_key", "pack_s",
            "dispatch_s", "compile_s", "run_s", "transfer_s"} <= \
        set(d["buckets"][0])


def test_mixed_family_acceptance_against_event_simulator():
    """The reference's mixed-family acceptance on the torch executor:
    >= 3 shapes, dynamic-bound cells, no failures, no event fallback,
    and every record inside the event simulator's envelope."""
    fam = mixed_family(seed=11)
    cells = fam.scenarios()
    assert len(fam.shapes()) >= 3 and any(s.bound_schedule for s in cells)
    sweep = SweepEngine(executor="torch", device="cpu").run(cells)
    assert not sweep.failures
    assert all(r.backend == "torch" for r in sweep.records)
    for rec in sweep.records:
        s = rec.scenario
        ev = simulate(s.graph, s.specs, s.bound_w, s.policy,
                      bound_schedule=s.bound_schedule)
        assert rec.result.makespan == pytest.approx(ev.makespan,
                                                    abs=MAKESPAN_ATOL)
        assert rec.result.energy_j == pytest.approx(ev.energy_j,
                                                    rel=ENERGY_RTOL)
