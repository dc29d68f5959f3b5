"""Shared setup of the torch-vs-jax sweep parity tests
(``test_torch_sweep.py``, ``test_torch_sweep_ilp.py``).

The same mixed-family cells run through the reference's
``SweepEngine(executor="jax")`` and the port's
``SweepEngine(executor="torch", device="cpu")``.  ILP cells carry a short
solver time limit, and the port's engine is handed the reference's
solved assignments (carried across with ``convert.from_reference``), so
both sweeps run the same caps: a time-capped MILP may stop at another
incumbent on another run.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import SweepEngine as RefSweepEngine
from repro.core import scenarios as ref_sc
from repro.core.sweep import AssignmentCache as RefAssignmentCache

from repro_torch.convert import from_reference
from repro_torch.core import scenarios as port_sc
from repro_torch.core.sweep import AssignmentCache, SweepEngine

#: Torch engine vs the reference's jax engine (both float32).  Job
#: stamps are held at atol 1e-4 plus one float32 ulp of their value: past
#: 1024 s one ulp is 1.22e-4, and the two engines' stamps there can
#: differ by one rounding (measured: 11 stamps of one ILP row between
#: 1340 and 3530 s, the largest 1.22e-4 apart).
RTOL, STAMP_ATOL = 1e-5, 1e-4
STAMP_RTOL = float(np.finfo(np.float32).eps)
ILP_TIME_LIMIT = 0.25


def family_cells(module, policies, **kw):
    cells = module.mixed_family(seed=0, policies=policies, **kw).scenarios()
    return [dataclasses.replace(s, ilp_time_limit=ILP_TIME_LIMIT)
            if s.policy in ("ilp", "ilp-makespan") else s for s in cells]


def share_assignments(ref_engine, ref_cells, engine, cells) -> None:
    """Seed ``engine``'s ILP cache with the reference engine's solves."""
    for a, b in zip(ref_cells, cells):
        hit = ref_engine._assignments._cache.get(RefAssignmentCache.key(a))
        if hit is not None:
            engine._assignments._cache[AssignmentCache.key(b)] = (
                b.graph, from_reference(hit[1]))


def run_both(policies, **engine_kw):
    """(reference sweep, port sweep) over the mixed family's cells."""
    ref_cells = family_cells(ref_sc, policies)
    cells = family_cells(port_sc, policies)
    ref_engine = RefSweepEngine(executor="jax")
    ref = ref_engine.run(ref_cells)
    engine = SweepEngine(executor="torch", device="cpu", **engine_kw)
    share_assignments(ref_engine, ref_cells, engine, cells)
    return ref, engine.run(cells)


def assert_results_close(got, want, rtol=RTOL, stamp_atol=STAMP_ATOL,
                         stamp_rtol=STAMP_RTOL):
    for f in ("makespan", "energy_j", "peak_power_w", "over_budget_time"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=rtol,
                                                abs=1e-9), f
    for stamps in ("job_starts", "job_ends"):
        a, b = getattr(got, stamps), getattr(want, stamps)
        assert a.keys() == b.keys()
        np.testing.assert_allclose([a[k] for k in b], list(b.values()),
                                   rtol=stamp_rtol, atol=stamp_atol)


def assert_record_for_record(port, ref):
    """Same backend (torch for jax), fallback reason, bucket label after
    its backend prefix, and results; the same CSV columns."""
    assert len(port) == len(ref)
    assert not ref.failures and not port.failures
    for p, r in zip(port.records, ref.records):
        assert p.scenario.name == r.scenario.name
        assert p.scenario.policy == r.scenario.policy
        assert p.backend == {"jax": "torch"}.get(r.backend, r.backend)
        assert p.fallback_reason == r.fallback_reason
        if r.bucket is None:
            assert p.bucket is None
        else:
            assert p.bucket.split("#", 1)[1] == r.bucket.split("#", 1)[1]
        exact = p.backend == "event"
        assert_results_close(p.result, r.result,
                             rtol=1e-12 if exact else RTOL,
                             stamp_atol=1e-9 if exact else STAMP_ATOL,
                             stamp_rtol=1e-12 if exact else STAMP_RTOL)
    assert port.to_csv().splitlines()[0] == ref.to_csv().splitlines()[0]
