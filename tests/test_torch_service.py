"""The port's streaming sweep service, ``repro_torch.serving.SweepService``,
on the CPU (``device="cpu"``: the torch engine's plain path).

One class per class of ``tests/test_serving.py``, with the torch
executor where the reference's tests use the vector one:
continuous bucket packing, full-vs-deadline flushes, per-request
latency, the content-based result cache, the event fallback leg (and
the vector leg, with its reason), per-request failure isolation, the
lifecycle, the Poisson replay, schedule padding and, in place of
the reference's jit-cache class, the fixed bucket shapes of the torch
engine.  ``TestParityWithReference`` holds the service record for record
against the reference's ``SweepService(executor="jax")`` on the same
cells.  Every service is closed by a ``with`` block, so no thread
outlives its test.
"""

import doctest
import threading
import time

import pytest

from repro_torch.core import (Scenario, SweepEngine, homogeneous_cluster,
                              layered_dag, listing2_graph, listing2_uniform,
                              scenario_grid, simulate)
from repro_torch.core.sweep import scenario_cache_key
from repro_torch.obs import MetricsRegistry, trace
from repro_torch.serving import (ReplayReport, ServeRecord, SweepService,
                                 percentile, poisson_replay)
from repro_torch.serving import service as service_mod

from _torch_sweep_parity import (ILP_TIME_LIMIT, RTOL, STAMP_ATOL,
                                 STAMP_RTOL, assert_results_close,
                                 share_assignments)

FIELDS = ("makespan", "energy_j", "peak_power_w", "over_budget_time",
          "job_starts", "job_ends")


def grid(bounds=(6.0, 9.0), policies=("equal-share",), **kwargs):
    return scenario_grid({"l2": listing2_graph()},
                         homogeneous_cluster(3), list(bounds),
                         list(policies), **kwargs)


def svc(**kwargs):
    kwargs.setdefault("executor", "torch")
    kwargs.setdefault("device", "cpu")
    kwargs.setdefault("flush_deadline_s", 0.02)
    return SweepService(**kwargs)


def same(a, b):
    return all(getattr(a, f) == getattr(b, f) for f in FIELDS)


def test_doc_example_runs():
    """The module docstring's example (``test_docs.py`` collects only
    the reference's modules)."""
    result = doctest.testmod(service_mod, optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0


class TestSubmitResolve:
    def test_matches_event_simulator(self):
        cells = grid(bounds=(2.5, 6.0, 12.0))
        with svc() as service:
            records = [t.result(timeout=60)
                       for t in service.submit_many(cells)]
        for s, rec in zip(cells, records):
            assert rec.ok and rec.backend == "torch"
            ref = simulate(s.graph, list(s.specs), s.bound_w, s.policy)
            assert rec.result.makespan == pytest.approx(ref.makespan,
                                                        rel=0.02)
            assert rec.latency_s > 0
            assert rec.bucket is not None
            assert rec.fallback_reason is None

    def test_full_flush_before_deadline(self):
        # capacity 2 -> the second submit flushes the bucket "full",
        # long before the (deliberately huge) deadline
        with svc(bucket_rows=2, flush_deadline_s=30.0) as service:
            t0 = time.perf_counter()
            records = [t.result(timeout=60)
                       for t in service.submit_many(grid())]
            elapsed = time.perf_counter() - t0
        assert elapsed < 5.0
        assert all(r.flush_cause == "full" for r in records)
        assert service.stats().flushed_full == 1

    def test_deadline_flush_of_partial_bucket(self):
        with svc(bucket_rows=64, flush_deadline_s=0.02) as service:
            rec = service.submit(grid(bounds=(6.0,))[0]).result(
                timeout=60)
        assert rec.ok and rec.flush_cause == "deadline"
        assert rec.latency_s >= 0.02
        assert service.stats().flushed_deadline == 1

    def test_mixed_shapes_open_separate_buckets(self):
        big = layered_dag(n_nodes=5, seed=3)
        cells = grid(bounds=(6.0,)) + scenario_grid(
            {"big": big}, homogeneous_cluster(5), [6.0],
            ["equal-share"])
        with svc() as service:
            records = [t.result(timeout=60)
                       for t in service.submit_many(cells)]
        assert all(r.ok for r in records)
        # 3-node listing2 and the 5-node layered DAG pad to different
        # (N, J) envelopes, so they cannot share an open bucket
        assert len({r.bucket for r in records}) == 2

    def test_bound_schedule_rows(self):
        cells = grid(bounds=(9.0,),
                     bound_schedule=((15.0, 4.0), (30.0, 9.0)))
        with svc() as service:
            rec = service.submit(cells[0]).result(timeout=60)
        ref = simulate(cells[0].graph, list(cells[0].specs), 9.0,
                       "equal-share",
                       bound_schedule=((15.0, 4.0), (30.0, 9.0)))
        assert rec.ok and rec.backend == "torch"
        assert rec.result.makespan == pytest.approx(ref.makespan,
                                                    rel=0.02)

    def test_ticket_timeout_raises(self):
        with svc(flush_deadline_s=5.0, bucket_rows=64) as service:
            ticket = service.submit(grid(bounds=(6.0,))[0])
            with pytest.raises(TimeoutError, match="not resolved"):
                ticket.result(timeout=0.01)
            service.drain(timeout=60)       # flush without the 5 s wait
            assert ticket.result(timeout=60).ok


class TestResultCache:
    def test_repeat_submission_hits_cache(self):
        cells = grid()
        with svc() as service:
            first = [t.result(60) for t in service.submit_many(cells)]
            again = [t.result(60) for t in service.submit_many(cells)]
        assert not any(r.cached for r in first)
        assert all(r.cached and r.backend == "cache" for r in again)
        assert service.stats().cache_hits == len(cells)
        assert len(service.profile.buckets) == 1    # no launch for hits
        for a, b in zip(first, again):
            assert b.result.makespan == a.result.makespan

    def test_cache_key_memo_follows_a_growing_graph(self):
        """The service memoizes each graph's text for its cache keys: the
        key equals the unmemoized one, also after the graph grew."""
        from repro_torch.core import JobDependencyGraph

        g = JobDependencyGraph()
        g.add(0, 0, 4.0)
        g.add(1, 0, 2.0)
        cell = Scenario("g", g, tuple(homogeneous_cluster(2)), 6.0,
                        "equal-share")
        texts = {}
        before = scenario_cache_key(cell, texts)
        assert before == scenario_cache_key(cell)
        assert texts[id(g)][0] is g
        g.add(0, 1, 3.0, deps=[(0, 0), (1, 0)])
        after = scenario_cache_key(cell, texts)
        assert after == scenario_cache_key(cell) != before

    def test_cache_can_be_disabled(self):
        cells = grid()
        with svc(result_cache=False) as service:
            _ = [t.result(60) for t in service.submit_many(cells)]
            again = [t.result(60) for t in service.submit_many(cells)]
        assert not any(r.cached for r in again)
        assert service.stats().cache_hits == 0

    def test_policy_instances_are_uncacheable(self):
        from repro_torch.policies import get_policy

        cell = grid(policies=[get_policy("equal-share")])[0]
        assert scenario_cache_key(cell) is None
        with svc() as service:
            first = service.submit(cell).result(60)
            again = service.submit(cell).result(60)
        assert first.ok and again.ok and not again.cached


class TestFallbackAndFailure:
    def test_policy_instance_falls_back_to_event(self):
        from repro_torch.policies import get_policy

        cell = grid(policies=[get_policy("equal-share")])[0]
        with svc() as service:
            rec = service.submit(cell).result(timeout=60)
        assert rec.ok and rec.backend == "event"
        assert rec.fallback_reason == "policy-instance"
        assert service.stats().fallbacks == 1
        ref = simulate(cell.graph, list(cell.specs), cell.bound_w,
                       "equal-share")
        assert rec.result.makespan == pytest.approx(ref.makespan)

    def test_fallback_chain_records_its_reasons(self):
        """torch -> vector -> event with the plan's reason on every
        record, the card's lane limit among them (set low here: on the
        CPU the plain path has no limit)."""
        l2, specs = listing2_graph(), tuple(homogeneous_cluster(3))
        big = layered_dag(n_nodes=5, seed=3)
        cells = [
            Scenario("traced", l2, specs, 6.0, "equal-share",
                     trace_every=0.0),
            Scenario("kwargs", l2, specs, 6.0, "heuristic",
                     policy_kwargs={"clamp_to_lut": False}),
            Scenario("countdown", l2, specs, 6.0, "countdown"),
            Scenario("wide", big, tuple(homogeneous_cluster(5)), 9.0,
                     "equal-share"),
            Scenario("torch", l2, specs, 6.0, "oracle"),
        ]
        with svc() as service:
            service.max_lanes = 4
            records = [t.result(60) for t in service.submit_many(cells)]
        got = [(r.backend, r.fallback_reason) for r in records]
        assert got == [("vector", "trace-retention"),
                       ("event", "policy-kwargs"),
                       ("event", "no-vector-policy(countdown)"),
                       ("vector", "lanes(5>4)"), ("torch", None)]
        assert all(r.ok for r in records)
        assert service.stats().fallbacks == 2       # the event leg only

    def test_batch_failure_is_isolated_per_request(self, monkeypatch):
        # a bucket whose build explodes fails its own requests with the
        # error captured on the record — later traffic is unaffected
        real = service_mod.build_batch_sim

        def exploding(*args, **kwargs):
            raise RuntimeError("device on fire")

        monkeypatch.setattr(service_mod, "build_batch_sim", exploding)
        with svc() as service:
            bad = [t.result(60) for t in service.submit_many(grid())]
            monkeypatch.setattr(service_mod, "build_batch_sim", real)
            good = service.submit(grid(bounds=(2.5,))[0]).result(60)
        assert all(not r.ok for r in bad)
        assert all("device on fire" in r.error for r in bad)
        assert good.ok
        assert service.stats().failed == 2

    @pytest.mark.parametrize("stage", ["dispatch", "fetch"])
    def test_failed_launch_resolves_with_the_error(self, monkeypatch,
                                                   stage):
        """A torch bucket whose launch (dispatcher) or fetch (collector)
        raises resolves its requests with the error, as the bucket's
        torch records: nothing is re-run on another path or backend."""
        from repro_torch.backends.engine import TorchBatchSimulator

        calls = []

        def failing(self, *args):
            calls.append(self.impl)
            raise RuntimeError(f"{stage} failed on the card")

        monkeypatch.setattr(TorchBatchSimulator, stage, failing)
        with svc() as service:
            records = [t.result(60) for t in service.submit_many(grid())]
        assert all(not r.ok and r.backend == "torch" for r in records)
        assert all(f"{stage} failed" in r.error for r in records)
        assert calls == ["plain"]                   # one bucket, once
        assert service.stats().failed == len(records)
        assert service.stats().fallbacks == 0

    def test_assignment_failure_fails_only_its_request(self):
        class Exploding:
            def assignment_for(self, s):
                if s.bound_w < 7.0:
                    raise RuntimeError("infeasible")
                return None

        with svc() as service:
            service._assignments = Exploding()
            records = [t.result(60)
                       for t in service.submit_many(grid())]
        bad, good = records
        assert not bad.ok and "infeasible" in bad.error
        assert good.ok

    def test_validation(self):
        with pytest.raises(ValueError, match="executor"):
            SweepService(executor="jax")
        with pytest.raises(ValueError, match="flush_deadline_s"):
            SweepService(flush_deadline_s=0.0)
        with pytest.raises(ValueError, match="bucket_rows"):
            SweepService(executor="vector", bucket_rows=0)
        assert SweepService(device="cpu",
                            shard_devices=2).shard_devices == 2

    def test_vector_executor_needs_no_card(self, monkeypatch):
        """``executor="vector"`` is the numpy backend: no device, no
        phantom rows (numpy has no fixed batch shape to keep)."""
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with SweepService(executor="vector", flush_deadline_s=0.02) as \
                service:
            records = [t.result(60) for t in service.submit_many(grid())]
        assert service.device is None
        assert all(r.ok and r.backend == "vector" and
                   r.fallback_reason is None for r in records)
        assert service.stats().phantom_rows == 0
        assert records[0].result.makespan == pytest.approx(38.0, abs=0.05)

    def test_default_device_is_the_card(self, monkeypatch):
        """``device=None`` means the card: without one the constructor
        raises instead of running on the CPU."""
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SweepService(executor="torch")
        with SweepService(executor="torch", device="cpu") as service:
            assert service.device == torch.device("cpu")


class TestLifecycle:
    def test_drain_barrier(self):
        with svc(bucket_rows=64, flush_deadline_s=10.0) as service:
            tickets = service.submit_many(grid())
            # open bucket holds both requests; drain must flush it
            service.drain(timeout=60)
            assert all(t.done() for t in tickets)

    def test_drain_timeout(self):
        with svc() as service:
            with pytest.raises(TimeoutError, match="in flight"):
                service._outstanding += 1  # simulate a stuck request
                try:
                    service.drain(timeout=0.05)
                finally:
                    service._outstanding -= 1

    def test_close_is_idempotent_and_final(self):
        service = svc()
        ticket = service.submit(grid(bounds=(6.0,))[0])
        service.close()
        service.close()
        assert ticket.result(timeout=60).ok  # drained on close
        assert not any(t.is_alive() for t in service._threads)
        with pytest.raises(RuntimeError, match="closed"):
            service.submit(grid(bounds=(6.0,))[0])

    def test_concurrent_submitters(self):
        cells = grid(bounds=(2.5, 6.0, 9.0, 12.0),
                     policies=("equal-share", "oracle"))
        results = {}

        def feed(i, s, service):
            results[i] = service.submit(s).result(timeout=60)

        with svc() as service:
            threads = [threading.Thread(target=feed,
                                        args=(i, s, service))
                       for i, s in enumerate(cells)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == len(cells)
        assert all(r.ok for r in results.values())
        stats = service.stats()
        assert stats.completed == stats.submitted == len(cells)

    def test_metrics_and_trace(self):
        """The serve_* counters land in an injected registry, and with a
        tracer installed every request is one async span (begun on the
        submitting thread, ended on the one that resolved it) beside the
        flush instants and the dispatch and fetch spans."""
        registry = MetricsRegistry()
        tracer = trace.install(trace.Tracer())
        try:
            with svc(metrics=registry) as service:
                records = [t.result(60)
                           for t in service.submit_many(grid())]
                service.set_phase("steady")
                again = service.submit(grid()[0]).result(60)
        finally:
            assert trace.uninstall() is tracer
        assert all(r.ok for r in records) and again.cached
        snap = registry.snapshot()
        assert snap["counters"]["serve_submitted"] == {"": 3.0}
        assert snap["counters"]["serve_flushes"] == {"cause=deadline": 1.0}
        assert snap["histograms"]["serve_latency_s"]["phase=steady"][
            "count"] == 1
        assert service.latency_pct(50, phase="steady") == again.latency_s
        evs = tracer.events()
        begins = {e["id"] for e in evs if e["ph"] == "b"}
        ends = {e["id"] for e in evs if e["ph"] == "e"}
        assert begins == ends and len(begins) == 2
        names = {e["name"] for e in evs}
        assert {"request", "flush", "bucket-open", "serve:dispatch",
                "serve:fetch", "cache-hit", "pack", "dispatch"} <= names
        assert set(tracer.track_ids()) >= {"service", "engine"}


class TestStream:
    def test_percentile_nearest_rank(self):
        vals = [0.4, 0.1, 0.3, 0.2]
        assert percentile(vals, 50) == 0.2
        assert percentile(vals, 99) == 0.4
        assert percentile(vals, 0) == 0.1
        assert percentile([7.0], 50) == 7.0
        with pytest.raises(ValueError, match="empty"):
            percentile([], 50)
        with pytest.raises(ValueError, match="pct"):
            percentile(vals, 101)

    def test_poisson_replay_preserves_order(self):
        cells = grid(bounds=(2.5, 6.0, 9.0))
        with svc() as service:
            report = poisson_replay(service, cells, rate_hz=500.0,
                                    seed=3, timeout_s=60)
        assert [r.scenario for r in report.records] == cells
        assert report.throughput > 0
        summary = report.to_dict()
        assert summary["requests"] == 3 and summary["failures"] == 0
        assert summary["latency_p50_s"] <= summary["latency_p99_s"]

    def test_replay_gaps_are_the_references(self, monkeypatch):
        """The same seed gives the reference's inter-arrival gaps (both
        draw from their own ``random.Random(seed)``)."""
        from repro.serving import stream as ref_stream

        from repro_torch.serving import stream

        class Recorder:
            def __init__(self):
                self.gaps = []

            def sleep(self, s):
                self.gaps.append(s)

        class Instant:
            def __init__(self, s):
                self.scenario = s

            def result(self, timeout=None):
                return ServeRecord(scenario=self.scenario, result=None)

        class Service:
            def submit(self, s):
                return Instant(s)

        gaps = []
        for mod in (stream, ref_stream):
            rec = Recorder()
            monkeypatch.setattr(mod.time, "sleep", rec.sleep)
            mod.poisson_replay(Service(), list(range(6)), rate_hz=300.0,
                               seed=11)
            monkeypatch.undo()
            gaps.append(rec.gaps)
        assert len(gaps[0]) == 5 and gaps[0] == gaps[1]

    def test_replay_rejects_bad_rate(self):
        with svc() as service:
            with pytest.raises(ValueError, match="rate_hz"):
                poisson_replay(service, grid(), rate_hz=0.0)

    def test_report_partitions(self):
        ok = ServeRecord(scenario=None, result=None, latency_s=0.1)
        bad = ServeRecord(scenario=None, result=None, error="x",
                          latency_s=0.2)
        fb = ServeRecord(scenario=None, result=None,
                         fallback_reason="policy-instance",
                         latency_s=0.3)
        rep = ReplayReport(records=[ok, bad, fb], wall_s=1.0)
        assert rep.failures == [bad]
        assert rep.fallbacks == [fb]
        assert rep.throughput == 3.0
        assert rep.latency_pct(50) == 0.2


class TestTorchService:
    """The counterpart of the reference's jit-cache class: every
    dispatch of one envelope has one shape, nothing is built after
    warm-up, phantom rows are trimmed, and the answers are the offline
    engine's."""

    def test_fixed_shapes_and_no_build_after_warm_up(self):
        with svc(bucket_rows=4) as service:
            wave1 = [t.result(60) for t in
                     service.submit_many(grid(bounds=(6.0, 9.0)))]
            service.drain(timeout=60)
            warm = len(service.profile.buckets)
            wave2 = [t.result(60) for t in
                     service.submit_many(grid(bounds=(5.0, 8.0, 11.0)))]
            profile = service.profile
        assert all(r.ok and r.backend == "torch" for r in wave1 + wave2)
        assert profile.recompiles == 0
        assert profile.compiles_after(warm) == 0
        assert len(profile.buckets) > warm  # wave2 really dispatched
        assert len({b.cache_key for b in profile.buckets}) == 1
        assert {b.rows for b in profile.buckets} == {4}

    def test_phantom_rows_trimmed(self):
        cells = grid(bounds=(2.5, 6.0, 12.0))
        with svc(bucket_rows=8) as service:
            records = [t.result(60)
                       for t in service.submit_many(cells)]
            assert service.stats().phantom_rows >= 5
        assert len(records) == len(cells)
        for s, rec in zip(cells, records):
            ref = simulate(s.graph, list(s.specs), s.bound_w, s.policy)
            assert rec.result.makespan == pytest.approx(ref.makespan,
                                                        rel=1e-5)

    def test_fetch_builds_only_the_rows_asked_for(self):
        """The collector builds results for a bucket's requests only: its
        phantom rows are run and checked, not turned into results."""
        from repro_torch.backends.engine import TorchBatchSimulator

        sim = TorchBatchSimulator(listing2_graph(), homogeneous_cluster(3),
                                  [6.0, 9.0, 9.0, 9.0], device="cpu")
        want = sim.run()
        got = sim.fetch(sim.dispatch(), 2)
        assert len(got) == 2 and all(map(same, got, want[:2]))

    def test_matches_offline_sweep_engine(self):
        cells = scenario_grid(
            {"l2": listing2_graph(), "u10": listing2_uniform(10.0)},
            homogeneous_cluster(3), [2.5, 6.0, 9.0],
            ["equal-share", "oracle"])
        offline = SweepEngine(executor="torch", device="cpu").run(cells)
        assert not offline.failures
        with svc() as service:
            records = [t.result(60)
                       for t in service.submit_many(cells)]
        for off, rec in zip(offline.records, records):
            assert rec.ok and rec.backend == off.backend == "torch"
            assert same(rec.result, off.result)


# ----------------------------------------------- schedule padding (S2)
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # tier-1 runs without the dev extra
    from _hyp_stub import given, settings, st


class TestSchedulePadding:
    """The service pads ``bound_schedule`` columns up to a power of two
    (``_service_key``) with inert events, and rows up to the bucket's
    capacity; results must be identical to the offline engine running
    the exact, unpadded schedule — for length 1, pow2 lengths, and
    pow2±1 lengths."""

    def cell(self, schedule):
        return Scenario(name=f"sched{len(schedule)}",
                        graph=listing2_graph(),
                        specs=tuple(homogeneous_cluster(3)),
                        bound_w=9.0, policy="equal-share",
                        bound_schedule=tuple(schedule))

    def check_identical(self, schedule):
        s = self.cell(schedule)
        offline = SweepEngine(executor="torch",
                              device="cpu").run([s]).records[0]
        assert offline.ok and offline.backend == "torch"
        with svc() as service:
            served = service.submit(s).result(timeout=60)
        assert served.ok and served.backend == "torch"
        assert served.result.makespan == offline.result.makespan
        assert served.result.energy_j == offline.result.energy_j
        return offline.result

    @pytest.mark.parametrize("length", [1, 2, 3, 4, 5, 7, 8, 9])
    def test_non_pow2_lengths_result_identical(self, length):
        # events inside the run (the listing-2 makespan at 9 W is tens
        # of seconds) and beyond it, watts bouncing across the range
        schedule = [(1.0 + 4.0 * k, 4.0 + 5.0 * (k % 3))
                    for k in range(length)]
        result = self.check_identical(schedule)
        assert result.makespan > 0

    def test_padded_lengths_change_nothing_vs_each_other(self):
        # same effective schedule, one padded to 2 cols, one to 4:
        # trailing far-future events are inert by construction
        base = [(2.0, 4.0)]
        far = [(1e8, 4.0), (2e8, 4.0)]
        a = self.check_identical(base)
        b = self.check_identical(base + far)
        assert a.makespan == b.makespan

    @settings(max_examples=15, deadline=None)
    @given(st.lists(st.floats(min_value=3.5, max_value=12.0),
                    min_size=1, max_size=9))
    def test_fuzzed_schedules_result_identical(self, watts):
        schedule = [(1.0 + 3.0 * k, w) for k, w in enumerate(watts)]
        self.check_identical(schedule)


# ------------------------------------------- parity with the reference
class TestParityWithReference:
    """The same cells through the reference's ``SweepService(executor=
    "jax")`` and the port's service on the CPU: the same backend (torch
    where the reference says jax), fallback reason, bucket envelope and
    row capacity, and results at the sweep parity tolerances (event
    records at rel 1e-12).  The ILP cells carry a short solver cap, and
    the port is handed the reference's solves."""

    POLICIES = ("equal-share", "ilp", "countdown")

    @staticmethod
    def cells(core):
        import dataclasses

        g = {"l2": core.listing2_graph(),
             "u10": core.listing2_uniform(10.0)}
        big = {"big": core.layered_dag(n_nodes=5, seed=3)}
        out = core.scenario_grid(g, core.homogeneous_cluster(3),
                                 [4.0, 9.0], TestParityWithReference.POLICIES)
        out += core.scenario_grid(big, core.homogeneous_cluster(5),
                                  [8.0, 14.0], ("equal-share",))
        return [dataclasses.replace(s, ilp_time_limit=ILP_TIME_LIMIT)
                if s.policy == "ilp" else s for s in out]

    def test_record_for_record_against_jax_service(self):
        pytest.importorskip("jax")
        import repro.core as ref_core
        from repro.serving import SweepService as RefSweepService

        import repro_torch.core as core

        ref_cells, cells = self.cells(ref_core), self.cells(core)
        # a long deadline and a drain: full buckets flush at once, the
        # rest at the drain, so both services cut the same buckets
        with RefSweepService(executor="jax", flush_deadline_s=30.0,
                             bucket_rows=4) as ref_svc:
            tickets = ref_svc.submit_many(ref_cells)
            ref_svc.drain(timeout=300)
            want = [t.result(60) for t in tickets]
        with svc(flush_deadline_s=30.0, bucket_rows=4) as service:
            share_assignments(ref_svc, ref_cells, service, cells)
            tickets = service.submit_many(cells)
            service.drain(timeout=300)
            got = [t.result(60) for t in tickets]
        assert len(got) == len(want) == len(cells)
        for p, r in zip(got, want):
            assert p.ok and r.ok, (p.error, r.error)
            assert p.scenario.name == r.scenario.name
            assert p.scenario.policy == r.scenario.policy
            assert p.backend == {"jax": "torch"}.get(r.backend, r.backend)
            assert p.fallback_reason == r.fallback_reason
            assert p.flush_cause == r.flush_cause
            if r.bucket is None:
                assert p.bucket is None
            else:       # the envelope after "serve:<backend>#<seq>"
                assert p.bucket.split(":", 2)[2] == r.bucket.split(":", 2)[2]
            exact = p.backend == "event"
            assert_results_close(p.result, r.result,
                                 rtol=1e-12 if exact else RTOL,
                                 stamp_atol=1e-9 if exact else STAMP_ATOL,
                                 stamp_rtol=1e-12 if exact else STAMP_RTOL)
        assert {p.backend for p in got} == {"torch", "event"}
        stats, ref_stats = service.stats(), ref_svc.stats()
        for f in ("buckets", "flushed_full", "flushed_deadline",
                  "phantom_rows", "fallbacks"):
            assert getattr(stats, f) == getattr(ref_stats, f), f
        assert sorted(b.rows for b in service.profile.buckets) == \
            sorted(b.rows for b in ref_svc.profile.buckets)
