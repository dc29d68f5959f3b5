"""Rows split over several devices (``shard_devices``) in the torch
engine, on the CPU: the cases of ``tests/test_sharded.py`` on the port.

The reference gets its four devices from ``XLA_FLAGS`` before jax
starts, so its multi-device cases skip inside the full suite.  The port
reads the visible devices through one function,
:func:`repro_torch.backends.engine.visible_devices`, which the
``four_devices`` fixture monkeypatches to four CPU devices: these cases
run in the full suite too.

Correctness bar: the split is **bit-identical** to one device (each
shard runs the same per-row loop on its own block of rows; nothing of a
row crosses a shard), both sit inside the differential suite's
envelopes against the event simulator (``2*dt`` makespan, 1% energy for
exact policies), and each split run stays within rtol 1e-5 of the JAX
reference's single-device run (both float32).
"""

import random

import numpy as np
import pytest
import torch

from repro.core import SweepEngine as RefSweepEngine
from repro.core import homogeneous_cluster as ref_cluster
from repro.core import listing2_graph as ref_listing2
from repro.core import listing2_uniform as ref_uniform
from repro.core import scenario_grid as ref_grid
from repro.core.sweep import plan_chunk_rows as ref_plan_chunk_rows

from _torch_sweep_parity import assert_results_close, share_assignments
from repro_torch.backends import engine as torch_engine
from repro_torch.backends.engine import TorchBatchSimulator, shard_count
from repro_torch.core import (SweepEngine, homogeneous_cluster,
                              listing2_graph, listing2_uniform,
                              scenario_grid, simulate)
from repro_torch.core.batchsim import estimate_row_bytes
from repro_torch.core.sweep import device_budget_mb, plan_chunk_rows

DT = 0.05
MAKESPAN_ATOL = 2 * DT
ENERGY_RTOL = 0.01
FIELDS = ("makespan", "energy_j", "avg_power_w", "peak_power_w",
          "over_budget_time", "job_starts", "job_ends")


@pytest.fixture
def four_devices(monkeypatch):
    """Four visible (CPU) devices for the engine."""
    monkeypatch.setattr(torch_engine, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * 4)


def family_grid(policies=("equal-share", "oracle"), ref=False):
    """A mixed-shape family: shared and padded buckets, plus a
    bound-schedule row, sized so 4 devices see uneven shards (on the
    reference's types with ``ref``)."""
    if ref:
        grid, l2, uni, cluster = ref_grid, ref_listing2, ref_uniform, \
            ref_cluster
    else:
        grid, l2, uni, cluster = scenario_grid, listing2_graph, \
            listing2_uniform, homogeneous_cluster
    cells = grid({"l2": l2(), "u10": uni(10.0), "u7": uni(7.0)},
                 cluster(3), [2.5, 6.0, 9.0], policies)
    sched = grid({"l2s": l2()}, cluster(3), [9.0], policies,
                 bound_schedule=((15.0, 4.0),))
    return cells + sched


def _same(a, b) -> bool:
    return all(getattr(a, f) == getattr(b, f) for f in FIELDS)


def _reference(policies):
    """The JAX reference's single-device sweep of the family, the
    engine that ran it (for its ILP solves) and its cells."""
    cells = family_grid(policies, ref=True)
    engine = RefSweepEngine(executor="jax", shard_devices=1)
    return engine.run(cells), engine, cells


def _held_to_reference(sweep, ref) -> None:
    assert len(sweep.records) == len(ref.records)
    for p, r in zip(sweep.records, ref.records):
        assert (p.scenario.name, p.scenario.policy, p.scenario.bound_w) \
            == (r.scenario.name, r.scenario.policy, r.scenario.bound_w)
        assert_results_close(p.result, r.result)


def _port_sweep(policies, ref_engine=None, ref_cells=None, **kw):
    cells = family_grid(policies)
    engine = SweepEngine(executor="torch", device="cpu", **kw)
    if ref_engine is not None:
        share_assignments(ref_engine, ref_cells, engine, cells)
    return engine.run(cells)


class TestPlanner:
    """Device-independent memory planning (no devices needed)."""

    def test_row_bytes_scales_with_envelope(self):
        small = estimate_row_bytes((4, 16, 4, 2, 4))
        big = estimate_row_bytes((8, 64, 8, 2, 4))
        assert 0 < small < big
        assert estimate_row_bytes((4, 16, 4, 2, 4), itemsize=8) \
            == 2 * small

    def test_chunk_rows_aligned_and_floored(self):
        # budget of 10 rows, 4-way alignment -> 8 rows per chunk
        assert plan_chunk_rows(100, 1000, align=4) == 8
        assert plan_chunk_rows(100, 1000, align=1) == 10
        # a single shard-row over budget still dispatches one shard
        assert plan_chunk_rows(10_000, 1000, align=4) == 4
        assert plan_chunk_rows(10_000, 1000) == 1

    def test_zero_row_bytes_is_budget_bound(self):
        assert plan_chunk_rows(0, 1000, align=1) == 1000
        assert plan_chunk_rows(0, 1000, align=4) == 1000
        assert plan_chunk_rows(0, 1000, align=3) == 999

    def test_zero_budget_still_dispatches_one_shard(self):
        assert plan_chunk_rows(100, 0) == 1
        assert plan_chunk_rows(100, 0, align=4) == 4

    def test_align_wider_than_budget_wins(self):
        assert plan_chunk_rows(100, 500, align=8) == 8

    def test_non_pow2_align(self):
        assert plan_chunk_rows(100, 1000, align=3) == 9
        assert plan_chunk_rows(100, 1000, align=7) == 7
        assert plan_chunk_rows(100, 70, align=1) == 1

    def test_cap_never_exceeds_budget_except_one_shard_minimum(self):
        """The cap is always a positive multiple of the shard width, only
        exceeds the byte budget for the one-shard minimum, and equals
        the reference planner's."""
        rng = random.Random(7)
        for _ in range(500):
            row_bytes = rng.choice([0, 1, 7, 64, 1000, 10 ** 6])
            budget = rng.choice([0, 1, 999, 2 ** 10, 2 ** 20])
            align = rng.choice([1, 2, 3, 4, 7, 8, 16])
            cap = plan_chunk_rows(row_bytes, budget, align)
            assert cap == ref_plan_chunk_rows(row_bytes, budget, align)
            assert cap >= align >= 1
            assert cap % align == 0
            if cap > align:
                assert cap * row_bytes <= budget

    def test_budget_splits_buckets_without_changing_results(
            self, monkeypatch):
        grid = family_grid()
        base = SweepEngine(executor="torch", device="cpu").run(grid)
        tiny = SweepEngine(executor="torch", device="cpu",
                           memory_budget_mb=0.001).run(grid)
        # the budget variable, read when memory_budget_mb is None
        monkeypatch.setenv("REPRO_DEVICE_BUDGET_MB", "0.001")
        assert device_budget_mb() == 0.001
        env = SweepEngine(executor="torch", device="cpu").run(grid)
        assert not base.failures and not tiny.failures
        assert len({r.bucket for r in tiny.records}) \
            > len({r.bucket for r in base.records})
        assert any(".1:" in (r.bucket or "") for r in tiny.records)
        assert [r.bucket for r in env.records] == \
            [r.bucket for r in tiny.records]
        for a, b in zip(tiny.records, base.records):
            assert _same(a.result, b.result)

    def test_pipeline_toggle_is_result_invariant(self):
        grid = family_grid()
        on = SweepEngine(executor="torch", device="cpu",
                         pipeline=True).run(grid)
        off = SweepEngine(executor="torch", device="cpu",
                          pipeline=False).run(grid)
        assert not on.failures and not off.failures
        for a, b in zip(on.records, off.records):
            assert _same(a.result, b.result)


@pytest.mark.usefixtures("four_devices")
class TestShardedParity:
    def test_mesh_really_has_four_devices(self):
        assert len(torch_engine.visible_devices("cpu")) == 4
        assert shard_count(None, 100) == 4
        assert shard_count(None, 3) == 3      # clamped to rows
        assert shard_count(2, 100) == 2       # clamped to request
        assert shard_count(64, 100) == 4
        sim = TorchBatchSimulator(listing2_graph(), homogeneous_cluster(3),
                                  [6.0, 9.0], device="cpu")
        assert sim.n_shards == 2 and len(sim.devices) == 2
        from repro.backends.jax import JaxBatchSimulator

        want = JaxBatchSimulator(ref_listing2(), ref_cluster(3), [6.0, 9.0],
                                 shard_devices=1).run()
        for a, b in zip(sim.run(), want):
            assert_results_close(a, b)

    def test_sharded_matches_single_device_bitwise(self):
        """The same per-row loop, rows partitioned: bit-identical to one
        device, and within rtol 1e-5 of the reference's one device."""
        policies = ("equal-share", "oracle", "heuristic", "ilp", "learned")
        ref, ref_engine, ref_cells = _reference(policies)
        s4 = _port_sweep(policies, ref_engine, ref_cells)
        s1 = _port_sweep(policies, ref_engine, ref_cells, shard_devices=1)
        assert not s4.failures and not s1.failures
        assert {b.devices for b in s4.profile.buckets} >= {4}
        assert {b.devices for b in s1.profile.buckets} == {1}
        assert {r.backend for r in s4.records} == {"torch"}
        for a, b in zip(s4.records, s1.records):
            assert _same(a.result, b.result), (a.scenario.name,
                                               a.scenario.policy)
        _held_to_reference(s4, ref)

    def test_sharded_within_event_envelopes(self):
        """The differential contract holds through the split."""
        policies = ("equal-share", "oracle", "ilp")
        ref, ref_engine, ref_cells = _reference(policies)
        sw = _port_sweep(policies, ref_engine, ref_cells)
        assert not sw.failures
        assert not sw.event_fallbacks()
        assert {b.devices for b in sw.profile.buckets} >= {4}
        for r in sw.records:
            s = r.scenario
            ev = simulate(s.graph, list(s.specs), s.bound_w, s.policy,
                          latency_s=s.latency_s,
                          bound_schedule=s.bound_schedule)
            assert r.result.makespan == pytest.approx(
                ev.makespan, abs=MAKESPAN_ATOL), (s.name, s.policy)
            assert r.result.energy_j == pytest.approx(
                ev.energy_j, rel=ENERGY_RTOL), (s.name, s.policy)
        _held_to_reference(sw, ref)

    @pytest.mark.parametrize("stacked", [False, True])
    def test_row_padding_to_shard_multiple(self, stacked):
        """Row counts not divisible by the device count are padded with
        replicas of the last row and trimmed on fetch; in the stacked
        layout every row-carrying leaf is padded."""
        from repro.backends.jax import JaxBatchSimulator

        bounds = [2.5, 6.0, 7.5, 9.0, 12.0]       # 5 rows on 4 devices
        if stacked:
            graphs = [listing2_graph(), listing2_uniform(10.0),
                      listing2_graph(), listing2_uniform(7.0),
                      listing2_uniform(10.0)]
            specs = homogeneous_cluster(3)
            items = [(g, specs) for g in graphs]

            def make(**kw):
                return TorchBatchSimulator.padded(items, bounds, "heuristic",
                                                  device="cpu", **kw)
            ref_graphs = [ref_listing2(), ref_uniform(10.0), ref_listing2(),
                          ref_uniform(7.0), ref_uniform(10.0)]
            want = JaxBatchSimulator.padded(
                [(g, ref_cluster(3)) for g in ref_graphs], bounds,
                "heuristic", shard_devices=1).run()
        else:
            def make(**kw):
                return TorchBatchSimulator(listing2_graph(),
                                           homogeneous_cluster(3), bounds,
                                           "heuristic", device="cpu", **kw)
            want = JaxBatchSimulator(ref_listing2(), ref_cluster(3), bounds,
                                     "heuristic", shard_devices=1).run()
        sim = make()
        assert sim.n_shards == 4
        assert [len(r) for r in sim._shard_rows()] == [2, 2, 2, 2]
        sharded = sim.run()
        single = make(shard_devices=1).run()
        assert len(sharded) == len(bounds)
        assert sim.stats.host_syncs >= 4
        for a, b in zip(sharded, single):
            assert _same(a, b)
        for a, b in zip(sharded, want):
            assert_results_close(a, b)

    def test_profile_reports_shard_and_phase_split(self):
        policies = ("equal-share", "oracle")
        ref, _, _ = _reference(policies)
        sw = _port_sweep(policies)
        prof = sw.profile
        assert prof is not None and prof.buckets
        for b in prof.buckets:
            assert b.devices == min(4, b.rows) and b.rows >= 1
            assert b.cache_key is not None and b.cache_key[3] == b.devices
            assert b.run_s >= 0 and b.transfer_s >= 0
        assert {b.devices for b in prof.buckets} == {4}
        d = prof.to_dict()
        assert set(d) >= {"compiles", "cache_hits", "compile_s",
                          "run_s", "transfer_s", "buckets"}
        assert {b["devices"] for b in d["buckets"]} == {4}
        assert "build:" in sw.backend_summary()
        _held_to_reference(sw, ref)
