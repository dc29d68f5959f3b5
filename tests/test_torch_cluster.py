"""The port's cluster scheduler, ``repro_torch.cluster``, against the
reference's ``repro.cluster`` on the same inputs.

One counterpart of each of ``tests/test_cluster.py``'s cluster tests (its
two benchmark-registry tests belong to ``benchmarks/``, which the port
does not have), run on the port: the replays on the port's main
executor, ``SweepEngine(executor="torch", device="cpu")``.  Then the
port held against the reference with the reference's fixtures (the
``mixed`` pool at seed 3, 40 jobs at 0.4 Hz from seed 7, ``levels=4``):

* the arrival JSONL of every pool prefab and of a corpus is byte-equal,
  the bundled 1k stream round-trips byte for byte, and both loaders
  reject the same texts with the same message;
* ``water_fill`` / ``marginal_fill`` / the fair-share split are ``==``
  on seeded random boxes;
* on ``executor="vector"`` in both packages the calibration curves,
  every ``JobRun``'s admit and end times and watt history, the
  ``ClusterReport`` and the ``ReplayCheck`` of every outer policy are
  bit-equal;
* the torch executor on the CPU is within rtol 1e-5 of the reference's
  jax executor on the calibration makespans and on a replay of the same
  outer run (both schedulers fed the same curves, so their discrete
  decisions cannot part);
* the CLI's ``generate`` writes the reference's bytes, ``run
  --expect-clean --device cpu`` passes, a kernel build after the first
  dispatch fails it, and the ``cluster`` track's events equal the
  reference's by name, category and simulated time (the ``REPRO_TRACE``
  case in an interpreter of its own: both packages' ``obs`` install a
  file tracer on import).

One reference jax engine is shared by the module, so each bucket shape
is compiled once.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro import cluster as ref_cl
from repro.cluster.cli import main as ref_cli_main
from repro.core import SweepEngine as RefSweepEngine
from repro.obs import trace as ref_trace

from repro_torch.cluster import (CLUSTER_POLICIES, ArrivalError, ArrivalJob,
                                 ArrivalTrace, ClusterScheduler, JobView,
                                 RateModel, SchedulerError, dumps_arrivals,
                                 load_arrivals, loads_arrivals,
                                 marginal_fill, member_pool,
                                 poisson_arrivals, policy_grid, replay,
                                 report, suggest_bound, water_fill)
from repro_torch.cluster import cli as port_cli
from repro_torch.cluster.cli import main as cli_main
from repro_torch.core import SweepEngine
from repro_torch.core.power import (max_useful_cluster_bound,
                                    min_feasible_cluster_bound)
from repro_torch.core.scenarios import ScenarioFamily
from repro_torch.obs import trace

from _torch_sweep_parity import assert_results_close

ROOT = pathlib.Path(__file__).resolve().parent.parent
SAMPLE_CORPUS = ROOT / "examples" / "traces"
BUNDLED = ROOT / "examples" / "cluster" / "arrivals_1k.jsonl"

ALL_POLICIES = ("fifo-equal-split", "backfill", "power-aware",
                "fair-share")

#: Torch engine on the CPU vs the reference's jax engine (both float32).
RTOL = 1e-5


@pytest.fixture(scope="module")
def pool():
    return member_pool("mixed", seed=3)


@pytest.fixture(scope="module")
def trace_(pool):
    return poisson_arrivals(pool, n_jobs=40, rate_hz=0.4, seed=7)


@pytest.fixture(scope="module")
def model(trace_):
    m = RateModel(trace_, executor="vector", levels=4)
    sweep = m.calibrate()
    assert not sweep.event_fallbacks()
    return m


@pytest.fixture(scope="module")
def ref_trace_():
    return ref_cl.poisson_arrivals(ref_cl.member_pool("mixed", seed=3),
                                   n_jobs=40, rate_hz=0.4, seed=7)


@pytest.fixture(scope="module")
def ref_model(ref_trace_):
    m = ref_cl.RateModel(ref_trace_, executor="vector", levels=4)
    assert not m.calibrate().event_fallbacks()
    return m


@pytest.fixture(scope="module")
def ref_jax():
    """The module's one reference jax engine."""
    return RefSweepEngine(executor="jax")


def run_policy(trace_, model, policy, nodes=12, frac=0.5):
    bound = suggest_bound(trace_, total_nodes=nodes, frac=frac)
    return ClusterScheduler(trace_, bound_w=bound, total_nodes=nodes,
                            policy=policy, model=model).run()


def ref_run_policy(ref_trace_, ref_model, policy, nodes=12, frac=0.5):
    bound = ref_cl.suggest_bound(ref_trace_, total_nodes=nodes, frac=frac)
    return ref_cl.ClusterScheduler(ref_trace_, bound_w=bound,
                                   total_nodes=nodes, policy=policy,
                                   model=ref_model).run()


def torch_cpu():
    return SweepEngine(executor="torch", device="cpu")


# ------------------------------------------------------------ arrivals
class TestArrivals:
    def test_roundtrip_identity(self, trace_):
        text = dumps_arrivals(trace_)
        back = loads_arrivals(text)
        assert back.jobs == trace_.jobs
        assert set(back.members) == set(trace_.members)
        assert back.meta == trace_.meta
        assert dumps_arrivals(back) == text

    def test_seed_determinism(self, pool):
        a = poisson_arrivals(pool, n_jobs=30, rate_hz=1.0, seed=5)
        b = poisson_arrivals(pool, n_jobs=30, rate_hz=1.0, seed=5)
        c = poisson_arrivals(pool, n_jobs=30, rate_hz=1.0, seed=6)
        assert a.jobs == b.jobs
        assert a.jobs != c.jobs

    def test_arrivals_sorted_and_distributed(self, trace_):
        times = [j.t for j in trace_.jobs]
        assert times == sorted(times)
        assert times[0] == 0.0
        assert len(trace_.users) == 3
        by_user = {u: {j.member for j in trace_.jobs if j.user == u}
                   for u in trace_.users}
        assert all(len(ms) >= 2 for ms in by_user.values())

    def test_generator_validation(self, pool):
        with pytest.raises(ArrivalError):
            poisson_arrivals(pool, n_jobs=0, rate_hz=1.0)
        with pytest.raises(ArrivalError):
            poisson_arrivals(pool, n_jobs=5, rate_hz=0.0)
        with pytest.raises(ArrivalError):
            poisson_arrivals(pool, n_jobs=5, rate_hz=1.0, users=())

    def test_bundled_trace_loads(self):
        trace_ = load_arrivals(BUNDLED)
        assert len(trace_) == 1000
        assert len(trace_.members) == 6
        assert trace_.meta["generator"] == "poisson"

    def test_member_pool_prefabs_and_corpus(self):
        assert len(member_pool("mixed", seed=1)) == 6
        corpus_members = member_pool(str(SAMPLE_CORPUS))
        assert {m.name for m in corpus_members} == \
            {"listing2", "npb_is_a4"}
        assert [m.name for m in member_pool(f"corpus:{SAMPLE_CORPUS}")] \
            == [m.name for m in corpus_members]
        with pytest.raises(ArrivalError):
            member_pool("not-a-pool")

    def test_loader_rejects_bad_traces(self, trace_):
        text = dumps_arrivals(trace_)
        lines = text.splitlines()
        with pytest.raises(ArrivalError):
            loads_arrivals("\n".join(lines[1:]))
        hdr = json.loads(lines[0])
        for patch in ({"version": 99}, {"kind": "mpi-trace"}):
            bad = dict(hdr, **patch)
            with pytest.raises(ArrivalError):
                loads_arrivals("\n".join([json.dumps(bad)] + lines[1:]))
        ghost = json.dumps({"record": "job", "name": "zz", "t": 999.0,
                            "member": "ghost"})
        with pytest.raises(ArrivalError, match="unknown member"):
            loads_arrivals(text + ghost + "\n")
        dup = json.dumps(dict(record="job", name=trace_.jobs[0].name,
                              t=999.0, member=trace_.jobs[0].member))
        with pytest.raises(ArrivalError, match="duplicate job"):
            loads_arrivals(text + dup + "\n")
        early = json.dumps({"record": "job", "name": "early", "t": 0.0,
                            "member": trace_.jobs[0].member})
        with pytest.raises(ArrivalError, match="before"):
            loads_arrivals(text + early + "\n")
        lax = loads_arrivals(text + early + "\n", strict=False)
        assert [j.t for j in lax.jobs] == sorted(j.t for j in lax.jobs)
        with pytest.raises(ArrivalError, match="unknown record"):
            loads_arrivals(lines[0] + "\n"
                           + json.dumps({"record": "frob"}) + "\n")
        member = json.loads(lines[1])
        member["cluster"][0]["lut"] = "krypton-9"
        with pytest.raises(ArrivalError, match="unknown LUT"):
            loads_arrivals("\n".join([lines[0], json.dumps(member)]))

    def test_trace_invariants(self, pool):
        with pytest.raises(ArrivalError, match="at least one job"):
            ArrivalTrace(pool, [])
        with pytest.raises(ArrivalError, match="negative"):
            ArrivalJob(name="j", t=-1.0, member=pool[0].name)
        with pytest.raises(ArrivalError, match="slo"):
            ArrivalJob(name="j", t=0.0, member=pool[0].name, slo=0.0)


# ------------------------------------------------------------ policies
def views(*boxes, module=None):
    cls = JobView if module is None else module.JobView
    return [cls(name=f"v{i}", user=u, member=f"m{i}", nodes=2,
                min_w=lo, max_w=hi, arrival_t=0.0)
            for i, (lo, hi, u) in enumerate(boxes)]


class TestPolicies:
    def test_registry(self):
        for name in ALL_POLICIES:
            assert name in CLUSTER_POLICIES
            assert CLUSTER_POLICIES.get(name).name == name
        with pytest.raises(KeyError, match="no cluster policy"):
            CLUSTER_POLICIES.get("round-robin-lottery")
        assert CLUSTER_POLICIES.names() == ref_cl.CLUSTER_POLICIES.names()

    def test_water_fill_floors_caps_and_conserves(self):
        jobs = views((2.0, 4.0, "a"), (3.0, 20.0, "a"), (1.0, 2.0, "b"))
        alloc = water_fill(jobs, 12.0)
        assert sum(alloc.values()) == pytest.approx(12.0)
        for j in jobs:
            assert alloc[j.name] >= j.min_w - 1e-9
            assert alloc[j.name] <= j.max_w + 1e-9
        assert alloc["v0"] == pytest.approx(4.0)
        assert alloc["v2"] == pytest.approx(2.0)
        assert alloc["v1"] == pytest.approx(6.0)

    def test_water_fill_equal_when_uncapped(self):
        jobs = views((1.0, 100.0, "a"), (1.0, 100.0, "a"))
        alloc = water_fill(jobs, 10.0)
        assert alloc["v0"] == pytest.approx(alloc["v1"])

    def test_water_fill_infeasible_budget(self):
        with pytest.raises(ValueError, match="below the running floor"):
            water_fill(views((5.0, 9.0, "a")), 2.0)

    def test_marginal_fill_follows_weighted_slope(self):
        jobs = views((1.0, 10.0, "a"), (1.0, 10.0, "a"))
        jobs[0].rate_fn = lambda w: 0.10 * w
        jobs[1].rate_fn = lambda w: 0.01 * w
        alloc = marginal_fill(jobs, 12.0)
        assert sum(alloc.values()) == pytest.approx(12.0)
        assert alloc["v0"] == pytest.approx(10.0)
        assert alloc["v1"] == pytest.approx(2.0)
        jobs[1].weight = 100.0
        alloc = marginal_fill(jobs, 12.0)
        assert alloc["v1"] == pytest.approx(10.0)

    def test_fair_share_reclaims_capped_user_surplus(self):
        policy = CLUSTER_POLICIES.get("fair-share")
        jobs = views((1.0, 2.0, "a"), (1.0, 50.0, "b"), (1.0, 50.0, "b"))
        alloc = policy.split(jobs, 20.0)
        assert sum(alloc.values()) == pytest.approx(20.0)
        assert alloc["v0"] == pytest.approx(2.0)
        assert alloc["v1"] + alloc["v2"] == pytest.approx(18.0)
        assert alloc["v1"] == pytest.approx(alloc["v2"])


# ----------------------------------------------------------- scheduler
class TestScheduler:
    def test_stream_drains_with_sane_times(self, trace_, model):
        result = run_policy(trace_, model, "fifo-equal-split")
        assert len(result.runs) == len(trace_.jobs)
        for run in result.runs:
            assert run.admit_t >= run.job.t - 1e-9
            assert run.end_t > run.admit_t
            assert run.progress == pytest.approx(1.0)
            assert run.history[0][0] == run.admit_t
        assert result.makespan >= trace_.duration

    def test_fifo_admits_in_arrival_order(self, trace_, model):
        result = run_policy(trace_, model, "fifo-equal-split")
        admits = [r.admit_t for r in result.runs]
        assert admits == sorted(admits)

    @pytest.mark.parametrize("policy", ALL_POLICIES)
    def test_capacity_and_bound_conserved(self, trace_, model, policy):
        nodes = 12
        result = run_policy(trace_, model, policy, nodes=nodes)
        bound = result.bound_w
        for t, used in result.util:
            assert used <= bound + 1e-6
        events = sorted({t for r in result.runs for t, _ in r.history})
        for t in events:
            live = [r for r in result.runs
                    if r.admit_t <= t < r.end_t - 1e-12]
            assert sum(len(r.member.graph.nodes) for r in live) <= nodes
            total = 0.0
            for r in live:
                w = [hw for ht, hw in r.history if ht <= t][-1]
                assert r.min_w - 1e-6 <= w <= r.max_w + 1e-6
                total += w
            assert total <= bound + 1e-6

    def test_power_aware_beats_fifo_on_makespan(self, trace_, model):
        fifo = report(run_policy(trace_, model, "fifo-equal-split"))
        aware = report(run_policy(trace_, model, "power-aware"))
        assert aware.makespan < fifo.makespan

    def test_rejects_impossible_streams(self, trace_, model):
        with pytest.raises(SchedulerError, match="nodes"):
            ClusterScheduler(trace_, bound_w=100.0, total_nodes=2,
                             policy="fifo-equal-split", model=model)
        with pytest.raises(SchedulerError, match="bound"):
            ClusterScheduler(trace_, bound_w=1.0, total_nodes=12,
                             policy="fifo-equal-split", model=model)

    def test_rate_model_interpolates_monotonically(self, trace_, model):
        for m in trace_.members.values():
            lo = min_feasible_cluster_bound(m.specs)
            hi = max_useful_cluster_bound(m.specs)
            rates = [model.rate(m.name, lo + f * (hi - lo))
                     for f in (0.0, 0.25, 0.5, 0.75, 1.0)]
            assert all(r > 0 for r in rates)
            assert rates == sorted(rates)
            assert model.best_makespan(m.name) == \
                pytest.approx(1.0 / rates[-1])


# -------------------------------------------------- replay cross-check
class TestReplay:
    def test_replay_clean_and_model_close(self, trace_, model):
        """On the port's torch executor (plain path on the CPU): one
        bucket launch a shape, no event fallback."""
        result = run_policy(trace_, model, "power-aware")
        check = replay(result, engine=torch_cpu())
        assert check.event_fallbacks == 0 and check.recompiles == 0
        assert all(r.backend == "torch" for r in check.sweep.records)
        assert check.max_rel_err < 0.25
        assert check.mean_rel_err < 0.10

    def test_scenarios_carry_job_relative_schedules(self, trace_, model):
        result = run_policy(trace_, model, "fair-share")
        cells = result.scenarios()
        assert len(cells) == len(trace_.jobs)
        for cell, run in zip(cells, result.runs):
            assert cell.bound_w == run.history[0][1]
            if cell.bound_schedule:
                times = [t for t, _ in cell.bound_schedule]
                assert times[0] > 0
                assert times == sorted(times)

    def test_report_metrics_consistent(self, trace_, model):
        rep = report(run_policy(trace_, model, "backfill"))
        assert rep.throughput == pytest.approx(rep.n_jobs / rep.makespan)
        assert 0.0 <= rep.slo_attainment <= 1.0
        assert 0.0 < rep.util_mean <= 1.0 + 1e-9
        assert rep.wait_p99 >= rep.wait_mean >= 0.0

    def test_policy_grid_shares_model(self, trace_, model):
        cells = policy_grid(trace_, bound_w=suggest_bound(trace_, 12),
                            total_nodes=12,
                            policies=("fifo-equal-split", "backfill"),
                            model=model, replay=False)
        assert [c.report.policy for c in cells] == \
            ["fifo-equal-split", "backfill"]
        assert all(c.check is None for c in cells)


# --------------------------------------- corpus offset invariance
class TestCorpusOffsetInvariance:
    def test_member_makespans_invariant_to_arrival_offset(self):
        members = ScenarioFamily.from_corpus(SAMPLE_CORPUS).members
        baseline = {}
        model = None
        for offset in (0.0, 2.5, 40.0):
            jobs = [ArrivalJob(name=f"{m.name}-j", t=offset,
                               member=m.name) for m in members]
            jobs.sort(key=lambda j: j.t)
            trace_ = ArrivalTrace(members, jobs)
            if model is None:
                model = RateModel(trace_, executor="torch", device="cpu",
                                  levels=3)
                assert not model.calibrate().event_fallbacks()
            else:
                model.trace = trace_
            nodes = sum(len(m.graph.nodes) for m in members)
            bound = sum(max_useful_cluster_bound(m.specs) for m in members)
            result = ClusterScheduler(
                trace_, bound_w=bound, total_nodes=nodes,
                policy="backfill", model=model).run()
            check = replay(result, engine=torch_cpu())
            assert check.event_fallbacks == 0
            for run, rec in zip(result.runs, check.sweep):
                assert run.admit_t == pytest.approx(offset)
                name = run.member.name
                if name in baseline:
                    assert rec.result.makespan == baseline[name], \
                        f"{name} makespan changed at offset {offset}"
                else:
                    baseline[name] = rec.result.makespan
        assert set(baseline) == {m.name for m in members}


# ------------------------------------------------------------------ CLI
class TestCli:
    def test_generate_then_run_clean(self, tmp_path, capsys):
        out = tmp_path / "arrivals.jsonl"
        rc = cli_main(["generate", "--pool", "mixed", "--jobs", "12",
                       "--rate-hz", "0.3", "--seed", "7", "--users", "2",
                       "--out", str(out)])
        assert rc == 0 and out.exists()
        payload = tmp_path / "report.json"
        rc = cli_main(["run", str(out), "--nodes", "10", "--bound-frac",
                       "0.6", "--device", "cpu", "--levels", "3",
                       "--policies",
                       "fifo-equal-split,backfill,power-aware",
                       "--expect-clean", "--json", str(payload)])
        captured = capsys.readouterr().out
        assert rc == 0, captured
        assert "clean: zero event fallbacks, no kernel build after the " \
               "first dispatch" in captured
        data = json.loads(payload.read_text())
        assert data["executor"] == "torch"
        assert len(data["policies"]) == 3
        for entry in data["policies"]:
            assert entry["makespan"] > 0
            assert entry["throughput"] > 0
            assert entry["wait_p99"] >= 0
            assert entry["replay"]["event_fallbacks"] == 0
            assert entry["replay"]["recompiles"] == 0

    def test_run_rejects_unknown_policy(self, tmp_path):
        out = tmp_path / "arrivals.jsonl"
        cli_main(["generate", "--pool", "mixed", "--jobs", "3",
                  "--rate-hz", "1.0", "--out", str(out)])
        with pytest.raises(KeyError, match="no cluster policy"):
            cli_main(["run", str(out), "--nodes", "10", "--levels", "2",
                      "--device", "cpu", "--policies", "slurm"])


# ------------------------------------------------ against the reference
def _bad_texts(text):
    """(label, text, strict) cases both loaders must treat alike."""
    lines = text.splitlines()
    hdr = json.loads(lines[0])
    member = json.loads(lines[1])
    job = json.loads(lines[-1])
    lut = dict(member, cluster=[dict(member["cluster"][0],
                                     lut="krypton-9")]
               + member["cluster"][1:])
    short = dict(member, cluster=member["cluster"][:-1])
    graph = dict(member, graph="not a graph")
    early = {"record": "job", "name": "early", "t": 0.0,
             "member": job["member"]}
    nokey = {"record": "job", "name": "nokey", "t": 999.0}
    return [
        ("empty", "", True),
        ("blank", "\n\n", True),
        ("no-header", "\n".join(lines[1:]), True),
        ("version", "\n".join([json.dumps(dict(hdr, version=99))]
                              + lines[1:]), True),
        ("kind", "\n".join([json.dumps(dict(hdr, kind="mpi-trace"))]
                           + lines[1:]), True),
        ("not-json", lines[0] + "\n{not json\n", True),
        ("ghost", text + json.dumps({"record": "job", "name": "zz",
                                     "t": 999.0, "member": "ghost"}),
         True),
        ("dup", text + json.dumps(dict(job, t=999.0)), True),
        ("early-strict", text + json.dumps(early), True),
        ("early-lenient", text + json.dumps(early), False),
        ("record", lines[0] + "\n" + json.dumps({"record": "frob"}), True),
        ("lut", "\n".join([lines[0], json.dumps(lut)]), True),
        ("ranks", "\n".join([lines[0], json.dumps(short)]), True),
        ("graph", "\n".join([lines[0], json.dumps(graph)]), True),
        ("job-key", text + json.dumps(nokey), True),
        ("no-jobs", "\n".join(lines[:2]), True),
        ("negative", text + json.dumps(dict(job, name="neg", t=-1.0)),
         False),
        ("slo", text + json.dumps(dict(job, name="slo", t=999.0, slo=0)),
         True),
    ]


def _load(module, text, strict):
    try:
        return module.dumps_arrivals(module.loads_arrivals(text,
                                                           strict=strict))
    except module.ArrivalError as e:
        return ("ArrivalError", str(e))


class TestParityWithReference:
    @pytest.mark.parametrize("spec,seed", [
        ("mixed", 3), ("layered", 1), ("npb", 0), ("lm", 2),
        (str(SAMPLE_CORPUS), 0)])
    def test_arrival_jsonl_is_byte_equal(self, spec, seed):
        kw = dict(n_jobs=40, rate_hz=0.4, seed=7)
        got = dumps_arrivals(poisson_arrivals(member_pool(spec, seed=seed),
                                              **kw))
        want = ref_cl.dumps_arrivals(ref_cl.poisson_arrivals(
            ref_cl.member_pool(spec, seed=seed), **kw))
        assert got == want

    def test_bundled_trace_round_trips_byte_for_byte(self, tmp_path):
        text = BUNDLED.read_text()
        trace_ = load_arrivals(BUNDLED)
        assert dumps_arrivals(trace_) == text
        out = tmp_path / "again.jsonl"
        from repro_torch.cluster import dump_arrivals
        dump_arrivals(trace_, out)
        assert out.read_bytes() == BUNDLED.read_bytes()
        ref = ref_cl.load_arrivals(out)
        assert ref_cl.dumps_arrivals(ref) == text

    def test_loaders_reject_alike(self, trace_):
        text = dumps_arrivals(trace_)
        cases = _bad_texts(text)
        for label, bad, strict in cases:
            got = _load(sys.modules["repro_torch.cluster.arrivals"], bad,
                        strict)
            want = _load(ref_cl.arrivals, bad, strict)
            assert got == want, label
        rejected = [label for label, bad, strict in cases
                    if isinstance(_load(ref_cl.arrivals, bad, strict),
                                  tuple)]
        assert rejected == [label for label, _, _ in cases
                            if label != "early-lenient"]
        for module in (sys.modules["repro_torch.cluster.arrivals"],
                       ref_cl.arrivals):
            with pytest.raises(module.ArrivalError) as e:
                module.ArrivalTrace([], [])
            assert str(e.value) == "an arrival trace needs at least one " \
                                   "member"

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_fills_are_exactly_equal(self, seed):
        rng = np.random.default_rng(seed)
        fair = CLUSTER_POLICIES.get("fair-share")
        ref_fair = ref_cl.CLUSTER_POLICIES.get("fair-share")
        for _ in range(20):
            n = int(rng.integers(1, 7))
            lo = rng.uniform(1.0, 10.0, n)
            hi = lo + rng.uniform(0.0, 30.0, n) * (rng.random(n) > 0.1)
            users = [f"u{k}" for k in rng.integers(0, 3, n)]
            boxes = list(zip(lo.tolist(), hi.tolist(), users))
            budget = float(lo.sum() + rng.uniform(0.0, 1.2)
                           * (hi - lo).sum())
            slopes = rng.uniform(0.01, 1.0, n).tolist()
            weights = rng.uniform(0.5, 50.0, n).tolist()
            both = []
            for module in (None, ref_cl):
                jobs = views(*boxes, module=module)
                for j, k, w in zip(jobs, slopes, weights):
                    j.rate_fn = (lambda x, _k=k: _k * np.log1p(x))
                    j.weight = w
                both.append(jobs)
            port_jobs, ref_jobs = both
            assert water_fill(port_jobs, budget) == \
                ref_cl.water_fill(ref_jobs, budget)
            assert marginal_fill(port_jobs, budget) == \
                ref_cl.marginal_fill(ref_jobs, budget)
            assert marginal_fill(port_jobs, budget, quantum_w=0.37) == \
                ref_cl.marginal_fill(ref_jobs, budget, quantum_w=0.37)
            assert fair.split(port_jobs, budget) == \
                ref_fair.split(ref_jobs, budget)

    def test_vector_calibration_curves_are_bit_equal(self, model,
                                                     ref_model):
        assert model.curves == ref_model.curves
        assert [(r.scenario.name, r.scenario.bound_w, r.backend, r.bucket)
                for r in model.sweep_result] == \
            [(r.scenario.name, r.scenario.bound_w, r.backend, r.bucket)
             for r in ref_model.sweep_result]

    @pytest.mark.parametrize("policy", ALL_POLICIES)
    def test_vector_runs_reports_and_replays_are_bit_equal(
            self, trace_, model, ref_trace_, ref_model, policy):
        got = run_policy(trace_, model, policy)
        want = ref_run_policy(ref_trace_, ref_model, policy)
        assert [(r.job.name, r.admit_t, r.end_t, r.progress, r.history)
                for r in got.runs] == \
            [(r.job.name, r.admit_t, r.end_t, r.progress, r.history)
             for r in want.runs]
        assert got.util == want.util
        assert report(got).as_dict() == ref_cl.report(want).as_dict()
        check = replay(got, executor="vector")
        ref_check = ref_cl.replay(want, executor="vector")
        assert (check.event_fallbacks, check.recompiles, check.rel_errs) \
            == (ref_check.event_fallbacks, ref_check.recompiles,
                ref_check.rel_errs)
        assert check.event_fallbacks == 0

    def test_torch_calibration_matches_jax(self, trace_, ref_trace_,
                                           ref_jax):
        port = RateModel(trace_, levels=4, device="cpu")
        assert port.engine.executor == "torch"
        sweep = port.calibrate()
        ref = ref_cl.RateModel(ref_trace_, levels=4, engine=ref_jax)
        ref_sweep = ref.calibrate()
        assert not sweep.event_fallbacks() and not ref_sweep.event_fallbacks()
        assert all(r.backend == "torch" for r in sweep.records)
        assert len(sweep.profile.buckets) == len(ref_sweep.profile.buckets)
        for p, r in zip(sweep.records, ref_sweep.records):
            assert p.scenario.name == r.scenario.name
            assert p.result.makespan == pytest.approx(r.result.makespan,
                                                      rel=RTOL)
        assert port.curves.keys() == ref.curves.keys()
        for name, curve in ref.curves.items():
            np.testing.assert_allclose(port.curves[name], curve, rtol=RTOL)

    def test_torch_replay_matches_jax(self, trace_, model, ref_trace_,
                                      ref_model, ref_jax):
        """The same outer run (both schedulers on the same curves) replayed
        on the torch executor on the CPU and on the reference's jax one."""
        got = run_policy(trace_, model, "fair-share")
        want = ref_run_policy(ref_trace_, ref_model, "fair-share")
        assert [r.history for r in got.runs] == \
            [r.history for r in want.runs]
        assert max(len(c.bound_schedule) for c in got.scenarios()) >= 2
        check = replay(got, device="cpu")
        ref_check = ref_cl.replay(want, engine=ref_jax)
        assert check.sweep.records[0].backend == "torch"
        assert (check.event_fallbacks, check.recompiles) == (0, 0)
        assert ref_check.event_fallbacks == 0
        for p, r in zip(check.sweep.records, ref_check.sweep.records):
            assert p.scenario.name == r.scenario.name
            assert p.scenario.bound_schedule == r.scenario.bound_schedule
            assert_results_close(p.result, r.result)
        np.testing.assert_allclose(check.rel_errs, ref_check.rel_errs,
                                   rtol=1e-4, atol=1e-6)

    def test_cli_generate_is_byte_equal(self, tmp_path, capsys):
        argv = ["generate", "--pool", "mixed", "--jobs", "25",
                "--rate-hz", "0.7", "--seed", "4", "--users", "4",
                "--slo", "6.5", "--out"]
        assert cli_main(argv + [str(tmp_path / "port.jsonl")]) == 0
        port_out = capsys.readouterr().out
        assert ref_cli_main(argv + [str(tmp_path / "ref.jsonl")]) == 0
        ref_out = capsys.readouterr().out
        assert (tmp_path / "port.jsonl").read_bytes() == \
            (tmp_path / "ref.jsonl").read_bytes()
        assert port_out.replace("port.jsonl", "x") == \
            ref_out.replace("ref.jsonl", "x")

    def test_expect_clean_fails_on_a_late_kernel_build(self, tmp_path,
                                                       monkeypatch,
                                                       capsys):
        """A bucket past the first dispatch that built the kernels (as
        its profile records it) fails ``--expect-clean``."""
        out = tmp_path / "arrivals.jsonl"
        cli_main(["generate", "--jobs", "6", "--rate-hz", "0.5", "--out",
                  str(out)])
        run = SweepEngine.run

        def late_build(self, scenarios):
            sweep = run(self, scenarios)
            if sweep.records[0].scenario.name.startswith("replay/"):
                sweep.profile.buckets[-1].compiled = True
            return sweep

        monkeypatch.setattr(SweepEngine, "run", late_build)
        argv = ["run", str(out), "--nodes", "10", "--levels", "2",
                "--device", "cpu", "--policies", "backfill",
                "--expect-clean"]
        assert cli_main(argv) == 1
        text = capsys.readouterr().out
        assert "NOT CLEAN: 1 kernel builds after the first dispatch" in text
        assert port_cli._builds_after_first([]) == 0

    def test_cluster_track_events_match_reference(self, trace_, model,
                                                  ref_trace_, ref_model):
        got_tracer, want_tracer = trace.Tracer(), ref_trace.Tracer()
        trace.install(got_tracer)
        ref_trace.install(want_tracer)
        try:
            run_policy(trace_, model, "power-aware")
            ref_run_policy(ref_trace_, ref_model, "power-aware")
        finally:
            trace.uninstall()
            ref_trace.uninstall()

        def cluster_events(tracer):
            events = tracer.events()
            names = {(e["pid"], e["tid"]): e["args"]["name"]
                     for e in events
                     if e["ph"] == "M" and e["name"] == "thread_name"}
            tracks = {e["pid"]: e["args"]["name"] for e in events
                      if e["ph"] == "M" and e["name"] == "process_name"}
            return [(tracks[e["pid"]], names[(e["pid"], e["tid"])],
                     e["ph"], e["name"], e["cat"], e["ts"], e.get("dur"),
                     e["args"]) for e in events if e["ph"] != "M"]

        got = cluster_events(got_tracer)
        assert got == cluster_events(want_tracer)
        assert {ev[0] for ev in got} == {"cluster"}
        assert {ev[3] for ev in got} == {"arrive", "admit", "complete",
                                         "job", "jobs"}
        assert sum(ev[3] == "job" for ev in got) == len(trace_.jobs)

    def test_repro_trace_cli_writes_cluster_track(self, tmp_path):
        """``REPRO_TRACE`` in an interpreter of its own: the file holds
        the ``cluster`` track and the sweeps' ``engine`` track."""
        arrivals = tmp_path / "arrivals.jsonl"
        cli_main(["generate", "--jobs", "8", "--rate-hz", "0.5", "--out",
                  str(arrivals)])
        path = tmp_path / "trace.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   REPRO_TRACE=str(path))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.cluster", "run",
             str(arrivals), "--nodes", "10", "--levels", "2", "--device",
             "cpu", "--policies", "fifo-equal-split", "--expect-clean"],
            capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=240)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        events = json.loads(path.read_text())
        tracks = {e["args"]["name"] for e in events
                  if e["ph"] == "M" and e["name"] == "process_name"}
        assert {"cluster", "engine"} <= tracks
        assert sum(e["name"] == "admit" and e["cat"] == "cluster"
                   for e in events) == 8

    def test_defaults_to_the_card(self, trace_, model, monkeypatch,
                                  tmp_path, capsys):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        result = run_policy(trace_, model, "backfill")
        for build in (lambda: RateModel(trace_),
                      lambda: ClusterScheduler(trace_, bound_w=60.0,
                                               total_nodes=12),
                      lambda: replay(result),
                      lambda: policy_grid(trace_, 60.0, 12,
                                          ("backfill",))):
            with pytest.raises(RuntimeError):
                build()
        out = tmp_path / "arrivals.jsonl"
        cli_main(["generate", "--jobs", "3", "--out", str(out)])
        with pytest.raises(RuntimeError):
            cli_main(["run", str(out), "--nodes", "10"])
        capsys.readouterr()
