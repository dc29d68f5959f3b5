"""The torch sweep executor's machinery, on the CPU: the dispatch/fetch
split, the pipeline, memory-budget chunking, the process executor, the
fallback chain (the card's lane limit included), tracing, and a run of
the whole front end in a fresh interpreter that cannot import ``jax``
or ``repro``.  Nothing here needs the reference."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.backends.engine import TorchBatchSimulator
from repro_torch.core import (Scenario, SweepEngine, compare_policies,
                              ep_like, homogeneous_cluster, listing2_graph,
                              listing2_random, mixed_family, scenario_grid,
                              simulate)
from repro_torch.core.sweep import (DEFAULT_MEMORY_BUDGET_MB, _process_pool,
                                    plan_backend, plan_chunk_rows)
from repro_torch.obs import trace

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("makespan", "energy_j", "peak_power_w", "over_budget_time",
          "job_starts", "job_ends")


def _same(a, b):
    return all(getattr(a, f) == getattr(b, f) for f in FIELDS)


def _cells():
    """36 mixed cells: three policies on the six members at two bounds
    (every bucket holds at least two rows)."""
    return mixed_family(seed=0, bound_fracs=(0.4, 0.8),
                        policies=("equal-share", "oracle",
                                  "learned")).scenarios()


# ----------------------------------------------------- dispatch / fetch
def test_fetch_of_dispatch_equals_run_in_any_order():
    g, specs = listing2_graph(), homogeneous_cluster(3)
    a = TorchBatchSimulator(g, specs, [4.0, 9.0], "heuristic",
                            device="cpu")
    b = TorchBatchSimulator(listing2_random(3.0, seed=7), specs, [5.0],
                            "oracle", device="cpu")
    want_a, want_b = a.run(), b.run()
    pa, pb = a.dispatch(), b.dispatch()
    got_b, got_a = b.fetch(pb), a.fetch(pa)
    assert all(map(_same, got_a, want_a)) and all(map(_same, got_b, want_b))
    prof = pa.profile
    assert prof.path == "plain" and prof.rows == 2 and prof.kernel_ms is None
    assert a.stats.path == "plain" and a.stats.row_waves > 0


# ------------------------------------------------ pipeline and chunking
def test_pipeline_off_and_forced_chunks_give_the_same_records():
    cells = _cells()
    base = SweepEngine(executor="torch", device="cpu").run(cells)
    flat = SweepEngine(executor="torch", device="cpu",
                       pipeline=False).run(cells)
    # a budget of a few rows' bytes: every bucket splits into chunks
    tiny = SweepEngine(executor="torch", device="cpu",
                       memory_budget_mb=0.0001).run(cells)
    assert not base.failures and not flat.failures and not tiny.failures
    for a, b, c in zip(base.records, flat.records, tiny.records):
        assert _same(a.result, b.result) and _same(a.result, c.result)
        assert a.bucket == b.bucket and a.backend == c.backend == "torch"
    assert len(flat.profile.buckets) == len(base.profile.buckets)
    chunked = {r.bucket for r in tiny.records}
    assert len(tiny.profile.buckets) == len(chunked) > \
        len(base.profile.buckets)
    assert all("." in b.split(":")[0] for b in chunked)
    assert all(b.rows == 1 for b in tiny.profile.buckets)


def test_plan_chunk_rows():
    assert plan_chunk_rows(644_352, int(DEFAULT_MEMORY_BUDGET_MB * 2 ** 20)) \
        == 1666
    assert plan_chunk_rows(10, 5) == 1
    assert plan_chunk_rows(10, 100, align=4) == 8


# ---------------------------------------------------------- executors
def test_process_executor_equals_serial_and_uses_spawn():
    cells = scenario_grid({"l2": listing2_graph()}, homogeneous_cluster(3),
                          [4.0, 9.0], ("equal-share", "heuristic",
                                       "countdown", "learned"))
    serial = SweepEngine(executor="serial").run(cells)
    proc = SweepEngine(executor="process", max_workers=2).run(cells)
    assert not serial.failures and not proc.failures
    assert all(_same(a.result, b.result)
               for a, b in zip(serial.records, proc.records))
    with _process_pool(1) as pool:
        assert pool._mp_context.get_start_method() == "spawn"


def test_fallback_chain_and_reasons():
    g = listing2_graph()
    specs = tuple(homogeneous_cluster(3))
    from repro_torch.policies import get_policy

    cells = [
        Scenario("plain", g, specs, 6.0, "equal-share"),
        Scenario("traced", g, specs, 6.0, "equal-share", trace_every=0.0),
        Scenario("kw", g, specs, 6.0, "heuristic",
                 policy_kwargs={"clamp_to_lut": False}),
        Scenario("inst", g, specs, 6.0, get_policy("oracle")),
        Scenario("cd", g, specs, 6.0, "countdown"),
    ]
    sweep = SweepEngine(executor="torch", device="cpu").run(cells)
    assert not sweep.failures
    got = {r.scenario.name: (r.backend, r.fallback_reason)
           for r in sweep.records}
    assert got == {"plain": ("torch", None),
                   "traced": ("vector", "trace-retention"),
                   "kw": ("event", "policy-kwargs"),
                   "inst": ("event", "policy-instance"),
                   "cd": ("event", "no-vector-policy(countdown)")}
    traced = sweep.records[1].result
    assert traced.power_trace
    assert sweep.records[0].result.makespan == \
        pytest.approx(simulate(g, specs, 6.0).makespan, rel=1e-6)


def test_vector_only_policy_falls_back_with_its_reason(monkeypatch):
    from repro_torch.policies import vector

    monkeypatch.setitem(vector._REGISTRY._table, "vec-only",
                        vector.VectorEqualShare)
    s = Scenario("v", listing2_graph(), tuple(homogeneous_cluster(3)), 6.0,
                 "vec-only")
    assert plan_backend(s, "torch") == ("vector",
                                        "no-torch-policy(vec-only)")


def test_wide_rows_plan_to_vector_on_the_card_only():
    """The kernels take at most 256 lanes: on the card a wider scenario
    plans to the vector backend with its own reason (never failing in a
    bucket); the CPU's plain path has no limit."""
    wide = Scenario("ep300", ep_like(300, "A", seed=1),
                    tuple(homogeneous_cluster(300)), 300 * 4.0,
                    "equal-share")
    narrow = dataclasses.replace(wide, name="ep4", graph=ep_like(4, "A"),
                                 specs=tuple(homogeneous_cluster(4)),
                                 bound_w=16.0)
    assert plan_backend(wide, "torch", 256) == ("vector", "lanes(300>256)")
    assert plan_backend(narrow, "torch", 256) == ("torch", None)
    assert plan_backend(wide, "torch", None) == ("torch", None)
    engine = SweepEngine(executor="torch", device="cpu")
    assert engine.max_lanes is None
    engine.max_lanes = 256       # plan as on the card, run here
    sweep = engine.run([wide, narrow])
    assert not sweep.failures
    assert [(r.backend, r.fallback_reason) for r in sweep.records] == \
        [("vector", "lanes(300>256)"), ("torch", None)]
    ev = simulate(wide.graph, wide.specs, wide.bound_w)
    assert sweep.records[0].result.makespan == \
        pytest.approx(ev.makespan, rel=1e-9)


def test_engine_arguments():
    with pytest.raises(ValueError, match="unknown executor"):
        SweepEngine(executor="jax")
    assert SweepEngine(executor="torch", device="cpu",
                       shard_devices=2).shard_devices == 2
    assert SweepEngine(executor="torch", device="cpu",
                       shard_devices=1).device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SweepEngine(executor="torch")
    assert SweepEngine(executor="vector").device is None


def test_map_and_compare_policies():
    recs = SweepEngine().map(lambda x: 1 / x, [2, 0, 4], label=str)
    assert [r.ok for r in recs] == [True, False, True]
    assert "ZeroDivision" in recs[1].error
    out = compare_policies(listing2_graph(), homogeneous_cluster(3), 6.0,
                           policies=("equal-share", "oracle"))
    assert out["equal-share"].makespan == 38.0
    assert out["oracle"].makespan < 38.0


def test_sweep_and_engine_spans():
    tracer = trace.install(trace.Tracer())
    try:
        SweepEngine(executor="torch", device="cpu").run(_cells()[:6])
    finally:
        assert trace.uninstall() is tracer
    names = {e["name"] for e in tracer.events() if e["ph"] == "X"}
    assert {"plan", "pack", "dispatch", "run", "transfer", "results",
            "bucket:dispatch", "bucket:fetch"} <= names


# ------------------------------------------- no jax, no reference: run it
_BLOCKED_RUN = r"""
import dataclasses, importlib.abc, sys

class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocked())
from repro_torch.obs import trace
tracer = trace.install(trace.Tracer())
from repro_torch.core import (SweepEngine, homogeneous_cluster,
                              listing2_graph, mixed_family, simulate,
                              simulate_batch)
from repro_torch.core.sweep import AssignmentCache
from repro_torch.policies import available_policies

g, specs = listing2_graph(), homogeneous_cluster(3)
for p in available_policies():
    assert simulate(g, specs, 6.0, p).makespan > 0, p
for p in ("equal-share", "ilp", "heuristic", "oracle", "learned"):
    assert len(simulate_batch(g, specs, [6.0, 9.0], p)) == 2, p
seven = ("equal-share", "oracle", "heuristic", "ilp", "ilp-makespan",
         "learned", "countdown")
cells = [dataclasses.replace(s, ilp_time_limit=0.25)
         for s in mixed_family(seed=0, policies=seven,
                               bound_fracs=(0.8,)).scenarios()]
solved = AssignmentCache()
backends = {}
for ex in ("serial", "vector", "torch"):
    engine = SweepEngine(executor=ex, device="cpu")
    engine._assignments = solved
    sweep = engine.run(cells)
    assert not sweep.failures, sweep.failures[0].error
    backends[ex] = sorted({r.backend for r in sweep.records})
names = {e["name"] for e in tracer.events()}
assert {"plan", "pack", "dispatch", "bucket:fetch", "wave-loop"} <= names
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(backends)
"""


def test_front_end_runs_with_jax_and_reference_blocked():
    """A fresh interpreter whose imports of ``jax`` and ``repro`` raise
    runs every event policy, the vector backend and the serial, vector
    and torch executors over the mixed family with all seven policies
    and tracing on: a lazy import of the reference left in a copy
    fails here."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == str(
        {"serial": ["event"], "vector": ["event", "vector"],
         "torch": ["event", "torch"]})


# ---------------------------------------------------------- doctests
@pytest.mark.parametrize("name", ["repro_torch.core.sweep",
                                  "repro_torch.core.scenarios",
                                  "repro_torch.policies.learned",
                                  "repro_torch.obs.trace"])
def test_module_doctests(name):
    """The examples in the copies' docstrings run."""
    import doctest
    import importlib

    mod = importlib.import_module(name)
    result = doctest.testmod(mod, optionflags=doctest.ELLIPSIS
                             | doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0
