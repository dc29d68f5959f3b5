"""The port's event simulator, event policies and float64 vector backend
against the reference's.

Same inputs (the reference's graphs and clusters carried across with
``convert.from_reference``) go through ``repro.core.simulate`` /
``repro.core.batchsim`` and their copies in ``repro_torch.core``; every
result field agrees at rel 1e-12, and the golden Listing-2 makespans
(``tests/test_policies.py::GOLDEN``, ``tests/golden/listing2.json``) hold
for the copies as they hold for the originals.  Also: the registries,
the scenario families, and the phantom-padding properties of the
vector backend (the reference's ``tests/test_scenarios.py`` checks).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from repro.core import batchsim as ref_bs
from repro.core import scenarios as ref_sc
from repro.core import simulate as ref_simulate
from repro.core import workloads as ref_wl
from repro.core.ilp import build_makespan_milp as ref_milp
from repro.core.ilp import solve_paper_ilp as ref_solve
from repro.core.power import heterogeneous_cluster, homogeneous_cluster
from repro.policies import available_policies as ref_available
from repro.policies.vector import vector_policies as ref_vector_policies

from repro_torch.convert import from_reference
from repro_torch.core import batchsim as port_bs
from repro_torch.core import scenarios as port_sc
from repro_torch.core.ilp import solve_paper_ilp
from repro_torch.core.simulator import simulate
from repro_torch.policies import (available_policies, get_policy,
                                  get_vector_policy, vector_policies)

from test_policies import GOLDEN

GOLDEN_PATH = Path(__file__).parent / "golden" / "listing2.json"
SAMPLE_CORPUS = Path(__file__).resolve().parents[1] / "examples" / "traces"
REL = 1e-12
EVENT_POLICIES = ("equal-share", "ilp", "ilp-makespan", "heuristic",
                  "countdown", "oracle", "learned")
VECTOR_POLICIES = ("equal-share", "ilp", "ilp-makespan", "heuristic",
                   "oracle", "learned")
DT = 0.05


def _port(*objs):
    return [from_reference(o) for o in objs]


def assert_same_result(got, want, rel=REL, fields=("makespan", "energy_j",
                                                   "avg_power_w",
                                                   "peak_power_w",
                                                   "over_budget_time")):
    for f in fields:
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=rel,
                                                abs=1e-12), f
    for name in ("messages", "distributes", "suppressed_reports",
                 "policy"):
        assert getattr(got, name) == getattr(want, name), name
    for stamps in ("job_starts", "job_ends"):
        a, b = getattr(got, stamps), getattr(want, stamps)
        assert a.keys() == b.keys()
        np.testing.assert_allclose([a[k] for k in b], list(b.values()),
                                   rtol=rel, atol=1e-12)
    assert len(got.power_trace) == len(want.power_trace)
    np.testing.assert_allclose(np.asarray(got.power_trace, float).ravel(),
                               np.asarray(want.power_trace, float).ravel(),
                               rtol=rel, atol=1e-12)


# -------------------------------------------------------------- registries
def test_registries_match_the_reference():
    assert available_policies() == ref_available()
    assert vector_policies() == [p for p in ref_vector_policies()
                                 if p != "static-caps"]
    with pytest.raises(KeyError, match="unknown policy"):
        get_policy("nope")
    with pytest.raises(KeyError, match="no vector policy"):
        get_vector_policy("countdown")
    assert {p: get_vector_policy(p).exact for p in vector_policies()} == {
        "equal-share": True, "equal_share": True, "ilp": True,
        "ilp-makespan": True, "oracle": True, "heuristic": False,
        "learned": False}


# ------------------------------------------------------------------ golden
@pytest.mark.parametrize("bound", sorted(GOLDEN))
def test_golden_makespans(bound):
    """``tests/test_policies.py::GOLDEN`` on the port's event simulator."""
    g, specs = _port(ref_wl.listing2_graph(), homogeneous_cluster(3))
    gold = GOLDEN[bound]
    assert simulate(g, specs, bound, "equal-share").makespan == \
        pytest.approx(gold["equal-share"], rel=REL)
    a = solve_paper_ilp(g, specs, bound)
    assert simulate(g, specs, bound, "ilp", assignment=a).makespan == \
        pytest.approx(gold["ilp"], rel=REL)
    assert simulate(g, specs, bound, "ilp").makespan == \
        pytest.approx(gold["ilp"], rel=REL)
    assert simulate(g, specs, bound, "heuristic").makespan == \
        pytest.approx(gold["heuristic"], rel=REL)


def test_golden_fixture_on_event_and_vector_copies():
    """``tests/golden/listing2.json`` on the port's event simulator, and
    on its vector backend for the exact policies."""
    data = json.loads(GOLDEN_PATH.read_text())
    g, specs = _port(ref_wl.listing2_graph(), homogeneous_cluster(3))
    for bound, row in data["makespans"].items():
        for policy, want in row.items():
            assert simulate(g, specs, float(bound), policy).makespan == \
                pytest.approx(want, rel=1e-9), (policy, bound)
            if policy in vector_policies() and \
                    get_vector_policy(policy).exact:
                got = port_bs.simulate_batch(g, specs, [float(bound)],
                                             policy)[0]
                assert got.makespan == pytest.approx(want, rel=1e-9)


# ------------------------------------------------------ event simulator
def _event_cases():
    steps = ((8.0, 0.6), (20.0, 1.0))
    return {
        "listing2": (ref_wl.listing2_graph(), homogeneous_cluster(3), 6.0,
                     ()),
        "random-l2-steps": (ref_wl.listing2_random(3.0, seed=7),
                            homogeneous_cluster(3), 5.0, steps),
        "layered-mixed": (ref_wl.layered_dag(5, layers=3, fan=2, seed=21),
                          heterogeneous_cluster(5, seed=2), 14.0, steps),
        "forkjoin": (ref_wl.fork_join_graph(4, stages=3, seed=13),
                     homogeneous_cluster(4), 9.0, ()),
    }


@pytest.mark.parametrize("case", sorted(_event_cases()))
@pytest.mark.parametrize("policy", EVENT_POLICIES)
def test_event_simulator_matches_reference(policy, case):
    """Every field of every event policy's result, traces and the
    controller's message counts included, at rel 1e-12."""
    g, specs, bound, steps = _event_cases()[case]
    kw = dict(bound_schedule=steps, trace_every=0.0, node_trace=True)
    if policy.startswith("ilp"):
        solver = ref_solve if policy == "ilp" else ref_milp
        kw["assignment"] = solver(g, specs, bound, time_limit=5.0)
    want = ref_simulate(g, specs, bound, policy, **kw)
    if kw.get("assignment") is not None:
        kw["assignment"] = from_reference(kw["assignment"])
    pg, pspecs = _port(g, specs)
    got = simulate(pg, pspecs, bound, policy, **kw)
    assert_same_result(got, want)
    assert len(got.node_power_trace) == len(want.node_power_trace)
    for (ta, pa), (tb, pb) in zip(got.node_power_trace,
                                  want.node_power_trace):
        assert ta == pytest.approx(tb, rel=REL)
        np.testing.assert_allclose(pa, pb, rtol=REL)


def test_policy_instance_and_custom_policy_drop_in():
    """A policy instance runs as given; a subclass of the port's
    ``PowerPolicy`` works without registration."""
    from repro_torch.policies import PowerPolicy, SetCap

    class HalfCaps(PowerPolicy):
        name = "half"

        def on_start(self, view):
            return [SetCap(n, view.p_o / 2) for n in view.node_ids]

    g, specs = _port(ref_wl.listing2_graph(), homogeneous_cluster(3))
    slow = simulate(g, specs, 12.0, HalfCaps())
    assert slow.policy == "half"
    assert slow.makespan > simulate(g, specs, 12.0, "equal-share").makespan
    inst = simulate(g, specs, 6.0, get_policy("oracle"))
    assert inst.makespan == simulate(g, specs, 6.0, "oracle").makespan


# -------------------------------------------------------- vector backend
def _vector_rows():
    """Padded rows from the mixed family (bound steps on two members)."""
    rows = []
    fam = ref_sc.mixed_family(seed=0, bound_fracs=(0.15, 0.8))
    for m in fam.members:
        for bound in fam.member_bounds(m):
            rows.append((m.graph, m.specs, bound,
                         tuple((t, f * bound) for t, f in m.bound_steps)))
    return rows


@pytest.mark.parametrize("policy", VECTOR_POLICIES)
def test_vector_backend_matches_reference(policy):
    """The padded batch of mixed members, bound steps and traces on, and
    one shared Listing-2 batch: every row at rel 1e-12."""
    rows = _vector_rows()
    kw = dict(dt=DT, trace_every=0.0)
    assigns = None
    if policy.startswith("ilp"):
        # one (time-capped) solve per row, shared by both backends
        solver = ref_solve if policy == "ilp" else ref_milp
        assigns = [solver(g, list(sp), b, time_limit=0.3)
                   for g, sp, b, _ in rows]
    ref_kw = dict(kw, assignments=assigns) if assigns else kw
    want = ref_bs.BatchSimulator.padded(
        [(g, list(sp)) for g, sp, _, _ in rows], [b for *_, b, _ in rows],
        policy, bound_schedules=[s for *_, s in rows], **ref_kw).run()
    port_kw = dict(kw, assignments=[from_reference(a) for a in assigns]) \
        if assigns else kw
    got = port_bs.BatchSimulator.padded(
        [tuple(_port(g, list(sp))) for g, sp, _, _ in rows],
        [b for *_, b, _ in rows], policy,
        bound_schedules=[s for *_, s in rows], **port_kw).run()
    for a, b in zip(got, want):
        assert_same_result(a, b)
    g, specs = _port(ref_wl.listing2_graph(), homogeneous_cluster(3))
    want = ref_bs.simulate_batch(ref_wl.listing2_graph(),
                                 homogeneous_cluster(3), [4.0, 6.0, 12.0],
                                 policy, dt=DT)
    got = port_bs.simulate_batch(g, specs, [4.0, 6.0, 12.0], policy, dt=DT)
    for a, b in zip(got, want):
        assert_same_result(a, b)


def test_estimate_row_bytes_matches_reference():
    for dims in ((64, 2048, 32, 64, 16), (4, 16, 8, 4, 16), (1, 1, 2, 1, 1)):
        for itemsize in (4, 8):
            assert port_bs.estimate_row_bytes(dims, itemsize) == \
                ref_bs.estimate_row_bytes(dims, itemsize)
    assert port_bs.estimate_row_bytes((64, 2048, 32, 64, 16), 4) == 644_352


# --------------------------------------------- phantom padding (vector)
def _padding_rows():
    return [
        (ref_wl.listing2_graph(), homogeneous_cluster(3), 6.0),
        (ref_wl.layered_dag(5, layers=3, seed=4), homogeneous_cluster(5),
         14.0),
        (ref_wl.fork_join_graph(4, stages=2, seed=5),
         heterogeneous_cluster(4), 11.0),
    ]


@pytest.mark.parametrize("policy", ["equal-share", "oracle"])
def test_padded_rows_match_unpadded_exactly(policy):
    """Each padded row equals its own unpadded run to float noise: a
    phantom draw would show in the energy integral."""
    rows = [(*_port(g, sp), b) for g, sp, b in _padding_rows()]
    padded = port_bs.BatchSimulator.padded(
        [(g, sp) for g, sp, _ in rows], [b for *_, b in rows],
        policy=policy, dt=DT).run()
    for (g, sp, bound), got in zip(rows, padded):
        solo = port_bs.simulate_batch(g, sp, [bound], policy, dt=DT)[0]
        assert got.makespan == pytest.approx(solo.makespan, rel=REL)
        assert got.energy_j == pytest.approx(solo.energy_j, rel=REL)
        assert got.peak_power_w == pytest.approx(solo.peak_power_w,
                                                 rel=REL)


def test_forced_wide_padding_is_inert():
    g, specs = _port(ref_wl.listing2_graph(), homogeneous_cluster(3))
    tight = port_bs.BatchSimulator.padded([(g, specs)], [6.0]).run()[0]
    wide = port_bs.BatchSimulator.padded(
        [(g, specs)], [6.0], pad_dims=(16, 64, 16, 8, 16)).run()[0]
    assert wide.makespan == tight.makespan
    assert wide.energy_j == pytest.approx(tight.energy_j, rel=REL)
    assert wide.peak_power_w == pytest.approx(tight.peak_power_w, rel=REL)


def test_phantom_lane_caps_attract_no_budget():
    g, specs = _port(ref_wl.listing2_graph(), homogeneous_cluster(3))
    sim = port_bs.BatchSimulator.padded([(g, specs)], [6.0],
                                        policy="oracle",
                                        pad_dims=(8, 16, 8, 4, 8))
    sim.run()
    assert np.all(sim.cap[:, 3:] == 0.0)


def test_traced_padded_power_matches_event_trace():
    g, specs = _port(ref_wl.listing2_graph(), homogeneous_cluster(3))
    trace = port_bs.BatchSimulator.padded(
        [(g, specs)], [6.0], policy="equal-share", trace_every=0.0,
        pad_dims=(8, 16, 8, 4, 8)).run()[0].power_trace
    ev = simulate(g, specs, 6.0, "equal-share", trace_every=0.0)
    assert dict(trace) == pytest.approx(dict(ev.power_trace))


# ------------------------------------------------------ scenario families
FAMILIES = {
    "mixed": lambda m: m.mixed_family(seed=0),
    "mixed-s11-flat": lambda m: m.mixed_family(seed=11,
                                               with_bound_steps=False),
    "layered": lambda m: m.random_layered_family(seed=3),
    "npb": lambda m: m.npb_family(seed=1),
    "lm": lambda m: m.lm_family(seed=2),
    "traces": lambda m: m.ScenarioFamily.from_corpus(SAMPLE_CORPUS),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_scenario_families_match_reference(name):
    """Same seed (or the same recorded corpus, ``traces``), same
    members, bounds and cells (names, tags, bounds, schedules and
    graphs)."""
    ref = FAMILIES[name](ref_sc).scenarios()
    got = FAMILIES[name](port_sc).scenarios()
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert (a.name, a.policy, a.latency_s, dict(a.tags)) == \
            (b.name, b.policy, b.latency_s, dict(b.tags))
        assert a.bound_w == b.bound_w
        assert a.bound_schedule == b.bound_schedule
        assert a.graph.to_text() == b.graph.to_text()
        assert [s.speed for s in a.specs] == [s.speed for s in b.specs]
        assert [s.lut.name for s in a.specs] == [s.lut.name for s in b.specs]


