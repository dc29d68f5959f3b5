"""The port's traces package, ``repro_torch.traces``, against the
reference's ``repro.traces`` on the same inputs.

One counterpart for each case of ``tests/test_traces.py``, each held
against the reference: the canonical JSONL text of a recording is
byte-equal between the packages (with and without ``with_noise`` at the
same seed), the strict and lenient loaders raise the same
``TraceError`` on the same inputs and accept the same ones, ``span_work``
is ``==`` at every DVFS state of every bundled LUT, reconstructed graphs
have equal ``to_text()`` and the reconstruction reports are equal, and
replay makespans are ``==``.  The bundled corpus (``examples/traces``)
as ``ScenarioFamily.from_corpus`` sweeps on ``SweepEngine(executor=
"torch", device="cpu")`` record for record against the reference's
``executor="jax"`` (``tests/_torch_sweep_parity.py``: rtol 1e-5, stamps
atol 1e-4) and on the vector executor against the reference's vector
at 1e-12, both with zero event fallbacks.  Also the ``python -m
repro_torch.traces`` CLI, ``PowerLUT.freq_for_power_clamped``, the
power timelines of ``repro_torch.obs.timeline`` (the counterparts of
``tests/test_obs.py::TestPowerTimeline``) and the serve CLI's sweep
mode, whose ``REPRO_TRACE`` case runs in an interpreter of its own.
"""

import dataclasses
import doctest
import json
import os
import pathlib
import subprocess
import sys

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # property-based tests skip without hypothesis
    from _hyp_stub import given, settings, st

from repro import traces as ref_tr
from repro.core import ScenarioFamily as RefScenarioFamily
from repro.core import SweepEngine as RefSweepEngine
from repro.core import graph as ref_graph
from repro.core import power as ref_power
from repro.core import simulate as ref_simulate
from repro.core import workloads as ref_wl
from repro.obs import timeline as ref_timeline
from repro.obs import trace as ref_trace
from repro.traces.cli import main as ref_cli_main

from repro_torch import traces as tr
from repro_torch.core import ScenarioFamily, SweepEngine
from repro_torch.core import graph as port_graph
from repro_torch.core import power as port_power
from repro_torch.core import workloads as port_wl
from repro_torch.core.simulator import simulate
from repro_torch.launch import serve
from repro_torch.obs import timeline, trace
from repro_torch.obs.trace import Tracer
from repro_torch.traces.cli import main as cli_main

from _torch_sweep_parity import assert_record_for_record

ROOT = pathlib.Path(__file__).resolve().parents[1]
SAMPLE_CORPUS = ROOT / "examples" / "traces"
GOLDEN_TEXT = pathlib.Path(__file__).parent / "golden" / \
    "trace_listing2.txt"
LUTS = ("arndale_like_lut", "odroid_like_lut", "tpu_v5e_lut")


def minimal_trace_text(**header_over):
    header = {"record": "header", "version": 1, "ranks": 2,
              "cluster": [{"lut": "arndale-5410", "speed": 1.0}] * 2}
    header.update(header_over)
    lines = [json.dumps(header)]
    for rank in range(2):
        lines.append(json.dumps(
            {"record": "span", "rank": rank, "seq": 0, "t0": 0.0,
             "t1": 1.0, "f": 1600.0, "rho": 1.0}))
    return "\n".join(lines) + "\n"


def jsonl(records):
    return "\n".join(json.dumps(r) for r in records)


def load_both(text, strict=True):
    """(port trace, reference trace), or the two errors' messages."""
    out = []
    for mod in (tr, ref_tr):
        try:
            out.append(mod.loads_trace(text, strict=strict))
        except mod.TraceError as e:
            out.append(("TraceError", str(e)))
    return out


def assert_same_load(text, strict=True):
    got, want = load_both(text, strict=strict)
    if isinstance(want, tuple):
        assert got == want
        return None
    assert tr.dumps_trace(got) == ref_tr.dumps_trace(want)
    return got


def assert_same_recon(got, want):
    """Reconstructions equal: graph text, logged frequencies, specs and
    report."""
    assert got.graph.to_text() == want.graph.to_text()
    assert got.freqs == want.freqs
    assert [(s.lut.name, s.speed) for s in got.specs] == \
        [(s.lut.name, s.speed) for s in want.specs]
    assert dataclasses.asdict(got.report) == dataclasses.asdict(want.report)
    assert got.report.clean == want.report.clean


def recon_both(text, strict=True, **kw):
    got = tr.reconstruct(tr.loads_trace(text, strict=strict),
                         strict=strict, **kw)
    want = ref_tr.reconstruct(ref_tr.loads_trace(text, strict=strict),
                              strict=strict, **kw)
    assert_same_recon(got, want)
    return got, want


def assert_same_replay(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert str(got) == str(want)


# ------------------------------------------------------------------ schema
class TestSchema:
    def test_minimal_trace_loads(self):
        trace_ = assert_same_load(minimal_trace_text())
        assert trace_.ranks == 2
        assert len(trace_.spans()) == 2
        assert trace_.wall_clock == 1.0

    @pytest.mark.parametrize("text", [
        "",
        '{"record": "span", "rank": 0, "seq": 0, "t0": 0, "t1": 1, '
        '"f": 1600}',
        "not json\n",
        "[1, 2]\n",
        minimal_trace_text() + minimal_trace_text(),
        minimal_trace_text(version=99),
        minimal_trace_text(cluster=[{"lut": "arndale-5410"}]),
        minimal_trace_text(ranks=0, cluster=[]),
        minimal_trace_text(cluster=[{"lut": "arndale-5410",
                                     "speed": 0.0}] * 2),
    ], ids=["empty", "no-header", "bad-json", "not-object",
            "duplicate-header", "version", "cluster-size", "no-ranks",
            "zero-speed"])
    def test_bad_headers_rejected_alike(self, text):
        got, want = load_both(text)
        assert isinstance(want, tuple)
        assert got == want

    def test_rank_out_of_range_rejected(self):
        bad = minimal_trace_text() + json.dumps(
            {"record": "span", "rank": 7, "seq": 1, "t0": 1, "t1": 2,
             "f": 1600})
        got, want = load_both(bad)
        assert got == want and "out of range" in want[1]

    @pytest.mark.parametrize("op", [
        {"kind": "frobnicate"},
        {"kind": "send", "peer": 9},
        {"kind": "send", "peer": 0},
        {"kind": "allreduce"},
        {"kind": "allreduce", "group": [0, 9]},
        {"kind": "allreduce", "group": [1]},
        {"kind": "wait"},
        {"kind": "send"},
        {"kind": "send", "peer": 1, "t": -1.0},
    ], ids=["kind", "peer", "self", "no-group", "group-range",
            "own-group", "wait", "no-peer", "negative-t"])
    def test_malformed_ops_rejected(self, op):
        bad = minimal_trace_text() + json.dumps(
            {"record": "op", "rank": 0, "seq": 1, "t": 1.0, **op})
        for strict in (True, False):
            got, want = load_both(bad, strict=strict)
            assert isinstance(want, tuple)
            assert got == want

    @pytest.mark.parametrize("span", [
        {"t0": 2.0, "t1": 1.0},
        {"t0": -1.0, "t1": 1.0},
        {"f": 0.0},
        {"rho": 1.5},
        {"f": "fast"},
        {"t1": None},
    ], ids=["reversed", "negative", "zero-f", "rho", "f-type", "t1-none"])
    def test_malformed_spans_rejected(self, span):
        rec = {"record": "span", "rank": 0, "seq": 1, "t0": 1.0,
               "t1": 2.0, "f": 1600.0, **span}
        got, want = load_both(minimal_trace_text() + json.dumps(rec))
        assert isinstance(want, tuple)
        assert got == want

    def test_duplicate_seq_rejected(self):
        bad = minimal_trace_text() + json.dumps(
            {"record": "span", "rank": 0, "seq": 0, "t0": 1, "t1": 2,
             "f": 1600})
        got, want = load_both(bad)
        assert got == want and "duplicate seq" in want[1]

    def test_backwards_time_strict_vs_lenient(self):
        bad = minimal_trace_text() + json.dumps(
            {"record": "span", "rank": 0, "seq": 1, "t0": 0.2,
             "t1": 0.5, "f": 1600})
        got, want = load_both(bad)
        assert got == want and "backwards" in want[1]
        assert assert_same_load(bad, strict=False).ranks == 2

    def test_unwaited_nonblocking_rejected(self):
        bad = minimal_trace_text() + json.dumps(
            {"record": "op", "rank": 0, "seq": 1, "t": 1.0,
             "kind": "send", "peer": 1, "req": "r1"})
        got, want = load_both(bad)
        assert got == want and "never waited" in want[1]

    def test_serialisation_is_canonical(self):
        text = tr.dumps_trace(tr.record_workload("listing2"))
        assert text == ref_tr.dumps_trace(ref_tr.record_workload(
            "listing2"))
        assert tr.dumps_trace(tr.loads_trace(text)) == text
        assert ref_tr.dumps_trace(ref_tr.loads_trace(text)) == text

    @pytest.mark.parametrize("header", [
        {"ranks": "three"},
        {"cluster": [3, 3]},
        {"cluster": [{"lut": "arndale-5410", "speed": "fast"}] * 2},
        {"version": "one"},
    ])
    def test_malformed_header_fields_raise_trace_error(self, header):
        got, want = load_both(minimal_trace_text(**header))
        assert isinstance(want, tuple)
        assert got == want

    def test_idle_rank_still_gets_a_node(self):
        header = {"record": "header", "version": 1, "ranks": 3,
                  "cluster": [{"lut": "arndale-5410"},
                              {"lut": "odroid-xu2"},
                              {"lut": "arndale-5410", "speed": 2.0}]}
        recs = [header,
                {"record": "span", "rank": 0, "seq": 0, "t0": 0.0,
                 "t1": 2.0, "f": 1600.0},
                {"record": "span", "rank": 2, "seq": 0, "t0": 0.0,
                 "t1": 2.0, "f": 1600.0}]
        got, want = recon_both(jsonl(recs))
        assert got.graph.nodes == [0, 1, 2]
        assert got.graph[(1, 0)].work == 0.0
        report = tr.replay_report(got, simulate_nominal=False)
        assert_same_replay(report, ref_tr.replay_report(
            want, simulate_nominal=False))
        assert report.ok and report.rel_err < 1e-9, str(report)


# -------------------------------------------------------------- calibration
class TestCalibration:
    @pytest.mark.parametrize("lut", LUTS)
    def test_span_work_equal_at_every_state(self, lut):
        """work -> duration -> work at every state of every bundled LUT,
        any cpu_frac: the port's span_work == the reference's, and
        inverts the port's job_time."""
        from repro.core.graph import Job as RefJob
        from repro_torch.core.graph import Job

        spec = port_power.NodeSpec(getattr(port_power, lut)(), speed=1.3)
        ref_spec = ref_power.NodeSpec(getattr(ref_power, lut)(), speed=1.3)
        for freq in [s.freq_mhz for s in spec.lut.states]:
            for rho in (0.0, 0.4, 1.0):
                dur = port_power.job_time(
                    Job(node=0, index=0, work=7.5, cpu_frac=rho), freq,
                    spec.lut.f_max, spec.speed)
                assert dur == ref_power.job_time(
                    RefJob(node=0, index=0, work=7.5, cpu_frac=rho), freq,
                    ref_spec.lut.f_max, ref_spec.speed)
                span = tr.SpanRecord(rank=0, seq=0, t0=1.0, t1=1.0 + dur,
                                     freq_mhz=freq, cpu_frac=rho)
                ref_span = ref_tr.SpanRecord(rank=0, seq=0, t0=1.0,
                                             t1=1.0 + dur, freq_mhz=freq,
                                             cpu_frac=rho)
                work = tr.span_work(span, spec)
                assert work == ref_tr.span_work(ref_span, ref_spec)
                assert work == pytest.approx(7.5, rel=1e-12)
                assert tr.state_freq(spec.lut, freq) == \
                    ref_tr.state_freq(ref_spec.lut, freq)

    def test_unknown_frequency_strict_raises_lenient_snaps(self):
        spec = port_power.NodeSpec(port_power.arndale_like_lut())
        ref_spec = ref_power.NodeSpec(ref_power.arndale_like_lut())
        kw = dict(rank=0, seq=0, t0=0.0, t1=2.0, freq_mhz=1234.5,
                  cpu_frac=1.0)
        with pytest.raises(tr.TraceError, match="not a state") as got:
            tr.span_work(tr.SpanRecord(**kw), spec)
        with pytest.raises(ref_tr.TraceError) as want:
            ref_tr.span_work(ref_tr.SpanRecord(**kw), ref_spec)
        assert str(got.value) == str(want.value)
        snapped = tr.span_work(tr.SpanRecord(**kw), spec, strict=False)
        assert snapped == ref_tr.span_work(ref_tr.SpanRecord(**kw),
                                           ref_spec, strict=False)
        assert snapped == pytest.approx(2.0 * 1200.0 / 1600.0)

    def test_unknown_lut_name_needs_explicit_specs(self):
        text = minimal_trace_text(cluster=[{"lut": "mystery"}] * 2)
        with pytest.raises(tr.TraceError, match="unknown LUT") as got:
            tr.reconstruct(tr.loads_trace(text))
        with pytest.raises(ref_tr.TraceError) as want:
            ref_tr.reconstruct(ref_tr.loads_trace(text))
        assert str(got.value) == str(want.value)
        recon = tr.reconstruct(
            tr.loads_trace(text),
            specs=[port_power.NodeSpec(port_power.arndale_like_lut())] * 2)
        ref_recon = ref_tr.reconstruct(
            ref_tr.loads_trace(text),
            specs=[ref_power.NodeSpec(ref_power.arndale_like_lut())] * 2)
        assert_same_recon(recon, ref_recon)
        assert len(recon.graph) == 2

    def test_registry_names_the_same_luts(self):
        assert sorted(tr.LUT_REGISTRY) == sorted(ref_tr.LUT_REGISTRY)
        for name, build in tr.LUT_REGISTRY.items():
            lut, ref_lut = build(), ref_tr.LUT_REGISTRY[name]()
            assert lut.name == ref_lut.name == name
            assert [(s.freq_mhz, s.power_w) for s in lut.states] == \
                [(s.freq_mhz, s.power_w) for s in ref_lut.states]

    @pytest.mark.parametrize("lut", LUTS)
    def test_freq_for_power_clamped_matches_reference(self, lut):
        """At, between, below and above the LUT's states."""
        port_lut = getattr(port_power, lut)()
        ref_lut = getattr(ref_power, lut)()
        powers = [s.power_w for s in port_lut.states]
        probes = list(powers)
        probes += [(a + b) / 2 for a, b in zip(powers, powers[1:])]
        probes += [0.0, powers[0] - 1e-3, port_lut.idle_w,
                   powers[-1] + 1e-3, 10 * powers[-1]]
        for p in probes:
            got = port_lut.freq_for_power_clamped(p)
            assert got == ref_lut.freq_for_power_clamped(p), p
            assert got in [s.freq_mhz for s in port_lut.states]


# ------------------------------------------------------- round-trip oracle
def zoo_cases(mod, wl, pw):
    """(id, ground-truth graph, specs, recorder) of one package, across
    both recorders, clusters and frequency plans."""
    het4 = pw.heterogeneous_cluster(4, seed=0)
    return [
        ("listing2", wl.listing2_graph(), pw.homogeneous_cluster(3),
         lambda g, s: mod.record_graph(g, s)),
        ("npb-is-random-f", wl.is_builder(4, "A", seed=1).build(), het4,
         lambda g, s: mod.record_builder(wl.is_builder(4, "A", seed=1), s,
                                         freqs="random", seed=9)),
        ("npb-ep", wl.ep_builder(4, "A", seed=2).build(),
         pw.homogeneous_cluster(4),
         lambda g, s: mod.record_builder(wl.ep_builder(4, "A", seed=2),
                                         s)),
        ("moe", wl.moe_step_builder(4, seed=5).build(),
         pw.homogeneous_cluster(4),
         lambda g, s: mod.record_builder(wl.moe_step_builder(4, seed=5),
                                         s)),
        ("forkjoin", wl.fork_join_graph(4, stages=3, seed=7),
         pw.homogeneous_cluster(4),
         lambda g, s: mod.record_graph(g, s, freqs="random", seed=3)),
        ("layered", wl.layered_dag(5, layers=4, seed=6),
         pw.homogeneous_cluster(5), lambda g, s: mod.record_graph(g, s)),
        ("pipeline", wl.pipeline_graph(3, 4, seed=4),
         pw.homogeneous_cluster(3), lambda g, s: mod.record_graph(g, s)),
    ]


ZOO_IDS = [c[0] for c in zoo_cases(tr, port_wl, port_power)]


def zoo_pair(k):
    """The k-th zoo case in both packages: (port case, reference case)."""
    return (zoo_cases(tr, port_wl, port_power)[k],
            zoo_cases(ref_tr, ref_wl, ref_power)[k])


def strip_redundant_deps(graph):
    """Drop same-node deps other than the serial predecessor (no trace
    representation; only the pipeline generator emits them)."""
    g = port_graph.JobDependencyGraph()
    for jid in sorted(graph.jobs):
        job = graph[jid]
        deps = [d for d in job.deps
                if d[0] != job.node or d == (job.node, job.index - 1)]
        g.add(job.node, job.index, job.work, deps=deps,
              cpu_frac=job.cpu_frac, tag=job.tag)
    return g


@pytest.mark.parametrize("workload, kw", [
    ("listing2", {}),
    ("npb-is", {"n_nodes": 4, "hetero": True}),
    ("npb-ep", {"n_nodes": 5, "klass": "B", "seed": 3}),
    ("npb-cg", {"n_nodes": 3, "seed": 2, "freqs": "random"}),
    ("moe", {"n_nodes": 4, "hetero": True, "freqs": "random", "seed": 1}),
    ("layered", {"n_nodes": 5, "seed": 6}),
    ("forkjoin", {"n_nodes": 4, "seed": 7, "freqs": "random"}),
    ("pipeline", {"n_nodes": 3, "seed": 4}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_record_workload_text_is_byte_equal(workload, kw):
    """The same recording gives the same bytes in both packages, and
    so does ``with_noise`` at the same seed (jitter, skew and drops)."""
    got = tr.record_workload(workload, **kw)
    want = ref_tr.record_workload(workload, **kw)
    assert tr.dumps_trace(got) == ref_tr.dumps_trace(want)
    for noise in ({}, {"jitter_s": 0.02, "skew_s": 0.1, "seed": 5},
                  {"drop": 0.1, "seed": 4}):
        assert tr.dumps_trace(tr.with_noise(got, **noise)) == \
            ref_tr.dumps_trace(ref_tr.with_noise(want, **noise))


class TestRoundTripOracle:
    @pytest.mark.parametrize("k", range(len(ZOO_IDS)), ids=ZOO_IDS)
    def test_noise_free_reconstruction_is_isomorphic(self, k):
        (name, graph, specs, recorder), (_, rgraph, rspecs, rrecorder) = \
            zoo_pair(k)
        text = tr.dumps_trace(recorder(graph, specs))
        assert text == ref_tr.dumps_trace(rrecorder(rgraph, rspecs))
        recon, want = recon_both(text)
        assert recon.report.clean
        assert tr.graphs_match(strip_redundant_deps(graph), recon.graph,
                               work_rtol=1e-9)
        if name != "pipeline":
            assert tr.graphs_match(graph, recon.graph, work_rtol=1e-9)
        assert tr.canonical_form(recon.graph) == \
            ref_tr.canonical_form(want.graph)

    @pytest.mark.parametrize("k", range(4), ids=ZOO_IDS[:4])
    def test_replay_matches_wall_clock_within_1pct(self, k):
        (_, graph, specs, recorder), (_, rgraph, rspecs, rrecorder) = \
            zoo_pair(k)
        report = tr.replay_report(tr.reconstruct(recorder(graph, specs)),
                                  tol=tr.REPLAY_RTOL)
        want = ref_tr.replay_report(
            ref_tr.reconstruct(rrecorder(rgraph, rspecs)),
            tol=ref_tr.REPLAY_RTOL)
        assert_same_replay(report, want)
        assert report.ok, str(report)
        assert report.rel_err < 1e-9

    def test_nominal_recording_wall_clock_is_nominal_makespan(self):
        g = port_wl.listing2_graph()
        trace_ = tr.record_graph(g, port_power.homogeneous_cluster(3))
        assert trace_.wall_clock == ref_tr.record_graph(
            ref_wl.listing2_graph(),
            ref_power.homogeneous_cluster(3)).wall_clock
        assert trace_.wall_clock == pytest.approx(
            g.makespan(lambda j: j.work), rel=1e-12)

    def test_nominal_replay_cross_checks_event_simulator(self):
        report = tr.replay_report(tr.reconstruct(tr.record_graph(
            port_wl.listing2_graph(), port_power.homogeneous_cluster(3))))
        want = ref_tr.replay_report(ref_tr.reconstruct(ref_tr.record_graph(
            ref_wl.listing2_graph(), ref_power.homogeneous_cluster(3))))
        assert_same_replay(report, want)
        assert report.sim_makespan_s == pytest.approx(19.0, rel=1e-9)
        assert tr.replay_makespan(tr.reconstruct(tr.record_graph(
            port_wl.listing2_graph(),
            port_power.homogeneous_cluster(3)))) == want.replay_makespan_s

    def test_random_freq_recording_stretches_wall_clock(self):
        g = port_wl.listing2_graph()
        trace_ = tr.record_graph(g, port_power.homogeneous_cluster(3),
                                 freqs="random", seed=11)
        assert trace_.wall_clock > g.makespan(lambda j: j.work)
        recon, want = recon_both(tr.dumps_trace(trace_))
        assert tr.graphs_match(g, recon.graph)
        report = tr.replay_report(recon)
        assert_same_replay(report, ref_tr.replay_report(want))
        assert report.ok


class TestNoiseResilience:
    def _noisy(self, builder_kw, noise, hetero=True):
        cluster = (lambda pw: pw.heterogeneous_cluster(4, seed=0)) \
            if hetero else (lambda pw: pw.homogeneous_cluster(4))
        got = tr.with_noise(tr.record_builder(
            port_wl.is_builder(4, "A", seed=1), cluster(port_power)),
            **noise)
        want = ref_tr.with_noise(ref_tr.record_builder(
            ref_wl.is_builder(4, "A", seed=1), cluster(ref_power)),
            **noise)
        text = tr.dumps_trace(got)
        assert text == ref_tr.dumps_trace(want)
        return got, text

    def test_jitter_and_skew_keep_structure(self):
        g = port_wl.is_builder(4, "A", seed=1).build()
        _, text = self._noisy({}, {"jitter_s": 0.02, "skew_s": 0.1,
                                   "seed": 5})
        recon, _ = recon_both(text, strict=False)
        shape = [(r, p, f, d) for r, p, _w, f, d in tr.canonical_form(g)]
        got = [(r, p, f, d) for r, p, _w, f, d
               in tr.canonical_form(recon.graph)]
        assert got == shape

    def test_default_noise_replay_within_documented_tolerance(self):
        for seed in range(3):
            _, text = self._noisy({}, {"seed": seed})
            recon, want = recon_both(text, strict=False)
            report = tr.replay_report(recon, tol=tr.NOISY_REPLAY_RTOL)
            assert_same_replay(report, ref_tr.replay_report(
                want, tol=ref_tr.NOISY_REPLAY_RTOL))
            assert report.ok, f"seed {seed}: {report}"

    def test_dropped_records_reconstruct_leniently(self):
        noisy, text = self._noisy({}, {"drop": 0.05, "seed": 4},
                                  hetero=False)
        assert noisy.meta["noise"]["dropped"] > 0
        with pytest.raises((tr.TraceError, ValueError)):
            tr.reconstruct(tr.loads_trace(text))
        with pytest.raises((ref_tr.TraceError, ValueError)):
            ref_tr.reconstruct(ref_tr.loads_trace(text))
        recon, _ = recon_both(text, strict=False)
        assert len(recon.graph) > 0
        assert not recon.report.clean or \
            len(recon.graph) < len(noisy.spans())

    def test_noisy_trace_strict_load_rejected(self):
        noisy = tr.with_noise(tr.record_workload("listing2"),
                              jitter_s=0.5, seed=1)
        got, want = load_both(tr.dumps_trace(noisy))
        assert got == want and "backwards" in want[1]

    def test_heavy_jitter_never_deletes_edges(self):
        g = port_wl.listing2_graph()
        noisy = tr.with_noise(tr.record_graph(
            g, port_power.homogeneous_cluster(3)), jitter_s=0.2,
            skew_s=0.3, seed=8)
        recon, _ = recon_both(tr.dumps_trace(noisy), strict=False)
        assert recon.report.dropped_acausal == 0
        shape = [(r, p, d) for r, p, _w, _f, d in tr.canonical_form(g)]
        got = [(r, p, d) for r, p, _w, _f, d
               in tr.canonical_form(recon.graph)]
        assert got == shape

    def test_causal_slack_drops_alike(self):
        """Heavy drops with a zero slack: the causality filter fires,
        and drops the same edges in both packages."""
        noisy = tr.with_noise(tr.record_workload("npb-cg", n_nodes=4,
                                                 seed=2),
                              jitter_s=0.05, drop=0.15, seed=3)
        recon, _ = recon_both(tr.dumps_trace(noisy), strict=False,
                              causal_slack_s=0.0)
        assert not recon.report.match.clean


class TestNonblockingOps:
    HEADER = {"record": "header", "version": 1, "ranks": 2,
              "cluster": [{"lut": "arndale-5410"}] * 2}

    def test_isend_irecv_wait_attachment(self):
        recs = [self.HEADER,
                {"record": "span", "rank": 0, "seq": 0, "t0": 0.0,
                 "t1": 2.0, "f": 1600.0},
                {"record": "op", "rank": 0, "seq": 1, "t": 2.0,
                 "kind": "send", "peer": 1, "req": "s1"},
                {"record": "span", "rank": 0, "seq": 2, "t0": 2.0,
                 "t1": 5.0, "f": 1600.0},
                {"record": "op", "rank": 0, "seq": 3, "t": 5.0,
                 "kind": "wait", "req": "s1"},
                {"record": "span", "rank": 0, "seq": 4, "t0": 5.0,
                 "t1": 6.0, "f": 1600.0},
                {"record": "op", "rank": 1, "seq": 0, "t": 0.0,
                 "kind": "recv", "peer": 0, "req": "r1"},
                {"record": "span", "rank": 1, "seq": 1, "t0": 0.0,
                 "t1": 1.0, "f": 1600.0},
                {"record": "op", "rank": 1, "seq": 2, "t": 2.0,
                 "kind": "wait", "req": "r1"},
                {"record": "span", "rank": 1, "seq": 3, "t0": 2.0,
                 "t1": 4.0, "f": 1600.0}]
        recon, _ = recon_both(jsonl(recs))
        assert (0, 0) in recon.graph[(1, 1)].deps
        assert recon.report.clean

    def test_isend_keeps_non_overtaking_order(self):
        recs = [self.HEADER,
                {"record": "span", "rank": 0, "seq": 0, "t0": 0.0,
                 "t1": 1.0, "f": 1600.0},
                {"record": "op", "rank": 0, "seq": 1, "t": 1.0,
                 "kind": "send", "peer": 1, "req": "s1"},
                {"record": "span", "rank": 0, "seq": 2, "t0": 1.0,
                 "t1": 2.0, "f": 1600.0},
                {"record": "op", "rank": 0, "seq": 3, "t": 2.0,
                 "kind": "send", "peer": 1},
                {"record": "span", "rank": 0, "seq": 4, "t0": 2.0,
                 "t1": 3.0, "f": 1600.0},
                {"record": "op", "rank": 0, "seq": 5, "t": 3.0,
                 "kind": "wait", "req": "s1"},
                {"record": "span", "rank": 0, "seq": 6, "t0": 3.0,
                 "t1": 4.0, "f": 1600.0},
                {"record": "op", "rank": 1, "seq": 0, "t": 1.0,
                 "kind": "recv", "peer": 0},
                {"record": "span", "rank": 1, "seq": 1, "t0": 1.0,
                 "t1": 2.5, "f": 1600.0},
                {"record": "op", "rank": 1, "seq": 2, "t": 2.5,
                 "kind": "recv", "peer": 0},
                {"record": "span", "rank": 1, "seq": 3, "t0": 2.5,
                 "t1": 3.5, "f": 1600.0}]
        recon, _ = recon_both(jsonl(recs))
        assert (0, 0) in recon.graph[(1, 0)].deps
        assert (0, 1) in recon.graph[(1, 1)].deps
        assert recon.report.clean

    def test_duplicate_pending_req_rejected_strict(self):
        bad = minimal_trace_text() + jsonl([
            {"record": "op", "rank": 0, "seq": 1, "t": 1.0,
             "kind": "recv", "peer": 1, "req": "r"},
            {"record": "op", "rank": 0, "seq": 2, "t": 1.0,
             "kind": "recv", "peer": 1, "req": "r"},
            {"record": "op", "rank": 0, "seq": 3, "t": 1.0,
             "kind": "wait", "req": "r"}])
        got, want = load_both(bad)
        assert got == want and "still pending" in want[1]

    def test_dropped_wait_tolerated_leniently(self):
        unwaited = minimal_trace_text() + json.dumps(
            {"record": "op", "rank": 0, "seq": 1, "t": 1.0,
             "kind": "recv", "peer": 1, "req": "r1"})
        orphan_wait = minimal_trace_text() + json.dumps(
            {"record": "op", "rank": 0, "seq": 1, "t": 1.0,
             "kind": "wait", "req": "ghost"})
        for text in (unwaited, orphan_wait):
            got, want = load_both(text)
            assert isinstance(want, tuple) and got == want
            recon, _ = recon_both(text, strict=False)
            assert len(recon.graph) >= 2

    def test_unmatched_send_strict_error_alike(self):
        bad = minimal_trace_text() + json.dumps(
            {"record": "op", "rank": 0, "seq": 1, "t": 1.0,
             "kind": "send", "peer": 1})
        with pytest.raises(tr.TraceError) as got:
            tr.reconstruct(tr.loads_trace(bad))
        with pytest.raises(ref_tr.TraceError) as want:
            ref_tr.reconstruct(ref_tr.loads_trace(bad))
        assert str(got.value) == str(want.value)


# ---------------------------------------------------- corpus + sweep (accept)
@pytest.fixture(scope="module")
def corpus_cells():
    """The bundled corpus as a family in both packages (equal-share and
    oracle at the three default bound fractions: 12 cells)."""
    return (ScenarioFamily.from_corpus(SAMPLE_CORPUS).scenarios(),
            RefScenarioFamily.from_corpus(SAMPLE_CORPUS).scenarios())


class TestSampleCorpus:
    def test_bundled_corpus_loads_and_validates(self):
        corpus = tr.TraceCorpus.from_dir(SAMPLE_CORPUS)
        ref = ref_tr.TraceCorpus.from_dir(SAMPLE_CORPUS)
        assert corpus.names == ref.names == ["listing2", "npb_is_a4"]
        for a, b in zip(corpus, ref):
            assert_same_recon(a.recon, b.recon)
        for report, want in zip(corpus.validate(), ref.validate()):
            assert_same_replay(report, want)
            assert report.ok and report.rel_err < 1e-9, str(report)
            assert report.sim_makespan_s is not None

    def test_bundled_listing2_is_the_paper_graph(self):
        corpus = tr.TraceCorpus.from_dir(SAMPLE_CORPUS)
        entry = {e.name: e for e in corpus}["listing2"]
        assert tr.graphs_match(port_wl.listing2_graph(), entry.recon.graph)
        assert entry.trace is entry.recon.trace

    def test_members_carry_provenance(self):
        corpus = tr.TraceCorpus.from_dir(SAMPLE_CORPUS)
        ref = ref_tr.TraceCorpus.from_dir(SAMPLE_CORPUS)
        for m, r in zip(corpus.members(), ref.members()):
            assert (m.name, m.tags, m.shape) == (r.name, r.tags, r.shape)

    def test_corpus_sweep_torch_matches_jax(self, corpus_cells):
        """Acceptance: the torch executor on the CPU, record for record
        against the reference's jax executor, zero event fallbacks."""
        cells, ref_cells = corpus_cells
        sweep = SweepEngine(executor="torch", device="cpu").run(cells)
        ref = RefSweepEngine(executor="jax").run(ref_cells)
        assert_record_for_record(sweep, ref)
        assert not sweep.event_fallbacks() and not ref.event_fallbacks()
        assert all(r.backend == "torch" for r in sweep.records)

    def test_corpus_sweep_vector_matches_reference(self, corpus_cells):
        cells, ref_cells = corpus_cells
        sweep = SweepEngine(executor="vector").run(cells)
        ref = RefSweepEngine(executor="vector").run(ref_cells)
        assert_record_for_record(sweep, ref)
        for a, b in zip(sweep.records, ref.records):
            for f in ("makespan", "energy_j", "peak_power_w",
                      "over_budget_time"):
                assert getattr(a.result, f) == pytest.approx(
                    getattr(b.result, f), rel=1e-12, abs=1e-12)
        assert not sweep.event_fallbacks() and not ref.event_fallbacks()
        assert all(r.backend == "vector" for r in sweep.records)
        for rec in sweep.records:
            s = rec.scenario
            ev = simulate(s.graph, s.specs, s.bound_w, s.policy)
            assert rec.result.makespan == pytest.approx(ev.makespan,
                                                        abs=0.1)

    def test_event_fallbacks_lists_event_records(self, corpus_cells):
        cells, _ = corpus_cells
        serial = SweepEngine(executor="serial").run(cells[:2])
        assert serial.event_fallbacks() == serial.records
        cd = [dataclasses.replace(cells[0], policy="countdown")]
        mixed = SweepEngine(executor="vector").run(cd + cells[:1])
        assert mixed.event_fallbacks() == mixed.records[:1]

    def test_in_memory_corpus(self):
        traces_ = [tr.record_workload("listing2"),
                   tr.record_workload("npb-cg", n_nodes=3, seed=2)]
        fam = tr.TraceCorpus.from_traces(traces_).family()
        ref = ref_tr.TraceCorpus.from_traces(
            [ref_tr.record_workload("listing2"),
             ref_tr.record_workload("npb-cg", n_nodes=3, seed=2)]).family()
        assert len(fam.scenarios()) == 12
        assert [(s.name, s.bound_w, s.policy) for s in fam.scenarios()] \
            == [(s.name, s.bound_w, s.policy) for s in ref.scenarios()]

    def test_in_memory_corpus_dedupes_repeated_workloads(self):
        corpus = tr.TraceCorpus.from_traces(
            [tr.record_workload("npb-cg", n_nodes=3, seed=2),
             tr.record_workload("npb-cg", n_nodes=4, seed=3),
             tr.record_workload("listing2")])
        assert corpus.names == ["npb-cg", "npb-cg-2", "listing2"]

    def test_empty_dir_rejected(self, tmp_path):
        with pytest.raises(tr.TraceError, match="no .*traces") as got:
            tr.TraceCorpus.from_dir(tmp_path)
        with pytest.raises(ref_tr.TraceError) as want:
            ref_tr.TraceCorpus.from_dir(tmp_path)
        assert str(got.value) == str(want.value)
        with pytest.raises(tr.TraceError, match="does not exist"):
            tr.TraceCorpus.from_dir(tmp_path / "missing")
        with pytest.raises(tr.TraceError, match="empty trace corpus"):
            tr.TraceCorpus([])

    def test_file_written_by_either_package_loads_in_the_other(
            self, tmp_path):
        tr.dump_trace(tr.record_workload("moe", n_nodes=3, seed=4),
                      tmp_path / "port.jsonl")
        ref_tr.dump_trace(ref_tr.record_workload("moe", n_nodes=3, seed=4),
                          tmp_path / "ref.jsonl")
        assert (tmp_path / "port.jsonl").read_bytes() == \
            (tmp_path / "ref.jsonl").read_bytes()
        a = tr.load_trace(tmp_path / "ref.jsonl")
        b = ref_tr.load_trace(tmp_path / "port.jsonl")
        assert tr.dumps_trace(a) == ref_tr.dumps_trace(b)


# ------------------------------------------------------------ golden fixture
class TestGoldenTraceGraph:
    def test_reconstructed_listing2_matches_golden_text(self):
        recon = tr.reconstruct(tr.load_trace(SAMPLE_CORPUS /
                                             "listing2.jsonl"))
        assert recon.graph.to_text() == GOLDEN_TEXT.read_text()

    def test_golden_text_parses_back_to_the_same_graph(self):
        g = port_graph.JobDependencyGraph.from_text(GOLDEN_TEXT.read_text())
        assert tr.graphs_match(g, port_wl.listing2_graph())


# ------------------------------------------------- graph text round-trips
class TestGraphTextRoundTrip:
    @pytest.mark.parametrize("k", range(len(ZOO_IDS)), ids=ZOO_IDS)
    def test_zoo_graphs_round_trip(self, k):
        (_, graph, _, _), (_, rgraph, _, _) = zoo_pair(k)
        assert graph.to_text() == rgraph.to_text()
        g2 = port_graph.JobDependencyGraph.from_text(graph.to_text())
        assert tr.graphs_match(graph, g2, work_rtol=1e-8)
        assert {j: graph[j].tag for j in graph.jobs} == \
            {j: g2[j].tag for j in g2.jobs}
        assert g2.to_text() == port_graph.JobDependencyGraph.from_text(
            g2.to_text()).to_text()

    @given(st.lists(st.floats(min_value=0.0, max_value=1e6,
                              allow_nan=False), min_size=5, max_size=5),
           st.integers(min_value=0, max_value=10 ** 6))
    @settings(max_examples=20, deadline=None)
    def test_roundtrip_property(self, works, seed):
        """to_text/from_text preserves structure exactly and work to
        %.9g precision, and the port's text is the reference's."""
        import random as _random

        graphs = []
        for gmod in (port_graph, ref_graph):
            rng = _random.Random(seed)
            g = gmod.JobDependencyGraph()
            for k, w in enumerate(works):
                deps = [(0, k - 1)] if k > 0 else []
                g.add(0, k, w, deps=deps, cpu_frac=rng.uniform(0.0, 1.0),
                      tag=rng.choice(["", "send", "allreduce"]))
            graphs.append(g)
        assert graphs[0].to_text() == graphs[1].to_text()
        g2 = port_graph.JobDependencyGraph.from_text(graphs[0].to_text())
        assert tr.graphs_match(graphs[0], g2, work_rtol=1e-8)


# ---------------------------------------------------------------------- CLI
class TestCLI:
    def test_record_validate_convert_sweep(self, tmp_path, capsys):
        out = tmp_path / "t.jsonl"
        ref_out = tmp_path / "ref" / "t.jsonl"
        ref_out.parent.mkdir()
        args = ["record", "--workload", "npb-cg", "--nodes", "3",
                "--seed", "2"]
        assert cli_main(args + ["-o", str(out)]) == 0
        assert ref_cli_main(args + ["-o", str(ref_out)]) == 0
        assert out.read_bytes() == ref_out.read_bytes()
        assert cli_main(["validate", str(out)]) == 0
        assert cli_main(["convert", str(out), "-o",
                         str(tmp_path / "g.txt")]) == 0
        assert ref_cli_main(["convert", str(out), "-o",
                             str(tmp_path / "ref" / "g.txt")]) == 0
        text = (tmp_path / "g.txt").read_text()
        assert text == (tmp_path / "ref" / "g.txt").read_text()
        assert len(port_graph.JobDependencyGraph.from_text(text).nodes) == 3
        capsys.readouterr()
        bench = tmp_path / "bench.json"
        assert cli_main(["sweep", str(tmp_path), "--backend", "torch",
                         "--device", "cpu", "--bench-json",
                         str(bench)]) == 0
        assert "backends: torch=6" in capsys.readouterr().out
        payload = json.loads(bench.read_text())
        assert payload["cells"] == len(payload["rows"]) == 6
        assert {r["backend"] for r in payload["rows"]} == {"torch"}

    @pytest.mark.parametrize("backend", ["vector", "event"])
    def test_sweep_host_backends(self, backend, capsys):
        assert cli_main(["sweep", str(SAMPLE_CORPUS), "--backend",
                         backend, "--bound-fracs", "0.4"]) == 0
        out = capsys.readouterr().out
        want = {"vector": "vector=4", "event": "event=4"}[backend]
        assert f"backends: {want}" in out
        assert ("fell back" in out) == (backend == "event")

    def test_sweep_defaults_to_the_card(self, monkeypatch, capsys):
        """Without CUDA the default ``sweep`` raises: nothing falls back
        to the CPU."""
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            cli_main(["sweep", str(SAMPLE_CORPUS)])
        capsys.readouterr()

    def test_noisy_record_and_lenient_validate(self, tmp_path, capsys):
        out = tmp_path / "n.jsonl"
        ref_out = tmp_path / "ref.jsonl"
        args = ["record", "--workload", "npb-is", "--nodes", "4",
                "--hetero", "--freqs", "random", "--jitter", "0.01",
                "--skew", "0.02", "--seed", "3"]
        assert cli_main(args + ["-o", str(out)]) == 0
        assert ref_cli_main(args + ["-o", str(ref_out)]) == 0
        assert out.read_bytes() == ref_out.read_bytes()
        assert cli_main(["validate", "--lenient", "--tol", "0.1",
                         str(out)]) == 0
        capsys.readouterr()

    def test_validate_fails_on_garbage(self, tmp_path, capsys):
        bad = tmp_path / "bad.jsonl"
        bad.write_text("not json\n")
        assert cli_main(["validate", str(bad)]) == 1
        assert "INVALID" in capsys.readouterr().out
        assert cli_main(["sweep", str(tmp_path), "--backend",
                         "vector"]) == 1
        capsys.readouterr()

    def test_validate_reports_unmatched_comm_as_invalid(self, tmp_path,
                                                        capsys):
        bad = tmp_path / "unmatched.jsonl"
        bad.write_text(minimal_trace_text() + json.dumps(
            {"record": "op", "rank": 0, "seq": 1, "t": 1.0,
             "kind": "send", "peer": 1}) + "\n")
        assert cli_main(["validate", str(bad)]) == 1
        assert "INVALID" in capsys.readouterr().out
        assert cli_main(["convert", str(bad)]) == 1
        capsys.readouterr()

    def test_record_to_stdout(self, capsys):
        assert cli_main(["record", "--workload", "listing2"]) == 0
        text = capsys.readouterr().out
        assert ref_cli_main(["record", "--workload", "listing2"]) == 0
        assert capsys.readouterr().out == text
        assert tr.loads_trace(text).ranks == 3


# ------------------------------------------------------ power timelines
@pytest.fixture
def tracer():
    """A fresh installed tracer, uninstalled afterwards."""
    t = trace.install(Tracer())
    yield t
    trace.uninstall()


def both_results(bound=9.0, **kw):
    """The same Listing-2 simulation in both packages."""
    return (simulate(port_wl.listing2_graph(),
                     port_power.homogeneous_cluster(3), bound, **kw),
            ref_simulate(ref_wl.listing2_graph(),
                         ref_power.homogeneous_cluster(3), bound, **kw))


def ref_events(result, bound, **kw):
    t = ref_trace.Tracer()
    n = ref_timeline.sim_tracks(result, bound, tracer=t, **kw)
    return n, t.events()


class TestPowerTimeline:
    def test_doc_example_runs(self):
        got = doctest.testmod(timeline, optionflags=doctest.ELLIPSIS)
        assert got.attempted > 0 and got.failed == 0

    def test_counter_sums_stay_under_bound(self, tracer):
        bound = 9.0
        r, ref = both_results(bound, node_trace=True)
        assert r.node_power_trace, "node_trace=True must record nodes"
        n = timeline.sim_tracks(r, bound, label="l2")
        assert (n, tracer.events()) == ref_events(ref, bound, label="l2")
        assert n >= len(r.node_power_trace)
        power = [e for e in tracer.events()
                 if e["ph"] == "C" and e["name"] == "power_w"]
        assert power
        for ev in power:
            assert sum(ev["args"].values()) <= bound + 1e-6
        bound_line = [e for e in tracer.events()
                      if e["ph"] == "C" and e["name"] == "bound_w"]
        assert all(e["args"]["bound"] == bound for e in bound_line)

    def test_job_spans_cover_every_start(self, tracer):
        r, ref = both_results(node_trace=True)
        timeline.sim_tracks(r, 9.0, label="l2")
        assert tracer.events() == ref_events(ref, 9.0, label="l2")[1]
        jobs = [e for e in tracer.events()
                if e["ph"] == "X" and e["cat"] == "job"]
        assert len(jobs) == len(r.job_starts)

    def test_freq_track_with_specs(self, tracer):
        specs = port_power.homogeneous_cluster(3)
        r, ref = both_results(node_trace=True)
        timeline.sim_tracks(r, 9.0, label="l2", specs=specs)
        assert tracer.events() == ref_events(
            ref, 9.0, label="l2",
            specs=ref_power.homogeneous_cluster(3))[1]
        freq = [e for e in tracer.events()
                if e["ph"] == "C" and e["name"] == "freq_mhz"]
        assert len(freq) == len(r.node_power_trace)
        f_max = specs[0].lut.f_max
        for ev in freq:
            assert all(0.0 <= v <= f_max for v in ev["args"].values())

    def test_fallback_to_cluster_total(self, tracer):
        r, ref = both_results()
        assert not r.node_power_trace
        timeline.sim_tracks(r, 9.0, label="l2")
        assert tracer.events() == ref_events(ref, 9.0, label="l2")[1]
        power = [e for e in tracer.events() if e["name"] == "power_w"]
        assert power and all(set(e["args"]) == {"cluster"}
                             for e in power)

    def test_explicit_tracer_beats_installed(self):
        mine = Tracer()
        n = timeline.power_tracks([(0.0, {"a": 1.0})], 2.0, tracer=mine)
        assert n == 3 and len(mine) > 0        # samples + bound steps

    def test_disabled_returns_zero(self):
        assert not trace.enabled()
        assert timeline.power_tracks([(0.0, {"a": 1.0})], 2.0) == 0
        assert timeline.sim_tracks(both_results()[0], 9.0) == 0

    def test_bound_schedule_and_file_export(self, tmp_path):
        r, ref = both_results(node_trace=True, trace_every=0.0)
        sched = [(0.0, 9.0), (5.0, 7.0)]
        path = timeline.write_sim_trace(r, sched, str(tmp_path / "p.json"),
                                        label="l2")
        ref_path = ref_timeline.write_sim_trace(
            ref, sched, str(tmp_path / "r.json"), label="l2")
        got = json.loads(pathlib.Path(path).read_text())
        want = json.loads(pathlib.Path(ref_path).read_text())
        assert got == want
        bounds = [e["args"]["bound"] for e in got
                  if e.get("name") == "bound_w"]
        assert bounds == [9.0, 7.0, 7.0]


# ------------------------------------------------ serve CLI, sweep mode
class TestServeSweepMode:
    def test_expect_clean_on_the_bundled_corpus(self, tmp_path, capsys):
        out = tmp_path / "summary.json"
        assert serve.main(["--trace-corpus", str(SAMPLE_CORPUS),
                           "--device", "cpu", "--expect-clean",
                           "--rate-hz", "400", "--repeat", "2",
                           "--json", str(out)]) == 0
        text = capsys.readouterr().out
        assert "[serve] clean" in text
        summary = json.loads(out.read_text())
        assert summary["requests"] == 24 and summary["failures"] == 0
        assert summary["fallbacks"] == 0
        assert summary["compiles_after_warmup"] == 0
        assert (summary["executor"], summary["device"]) == ("torch", "cpu")

    def test_vector_executor_and_no_warmup(self, capsys):
        assert serve.main(["--trace-corpus", str(SAMPLE_CORPUS),
                           "--executor", "vector", "--no-warmup",
                           "--no-result-cache", "--expect-clean",
                           "--rate-hz", "400", "--repeat", "1",
                           "--policies", "equal-share", "countdown"]) == 1
        assert "NOT CLEAN: 6 fallbacks" in capsys.readouterr().out

    def test_shard_devices_two_serves_the_records_of_one(self, monkeypatch,
                                                         capsys):
        """``--shard-devices 2`` on four (monkeypatched) CPU devices:
        every bucket's rows split over two devices, and the replay's
        records equal those of ``--shard-devices 1`` bit for bit."""
        import torch

        from repro_torch import serving
        from repro_torch.backends import engine

        monkeypatch.setattr(engine, "visible_devices",
                            lambda device=None: [torch.device("cpu")] * 4)
        replay, runs = serving.poisson_replay, {}

        def keep(svc, scenarios, **kw):
            report = replay(svc, scenarios, **kw)
            runs[svc.shard_devices] = (report, svc.profile)
            return report

        monkeypatch.setattr(serving, "poisson_replay", keep)
        for k in ("1", "2"):
            assert serve.main(["--trace-corpus", str(SAMPLE_CORPUS),
                               "--device", "cpu", "--expect-clean",
                               "--rate-hz", "400", "--repeat", "1",
                               "--no-result-cache",
                               "--shard-devices", k]) == 0
            assert "[serve] clean" in capsys.readouterr().out
        (one, prof1), (two, prof2) = runs[1], runs[2]
        assert {b.devices for b in prof1.buckets} == {1}
        assert {b.devices for b in prof2.buckets} == {2}

        def by_name(report):
            return sorted(((r.scenario.name, r.scenario.policy,
                            r.scenario.bound_w), r.result)
                          for r in report.records)

        assert len(two.records) == len(one.records) == 12
        assert by_name(two) == by_name(one)

    def test_defaults_to_the_card(self, monkeypatch, capsys):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            serve.main(["--trace-corpus", str(SAMPLE_CORPUS)])
        capsys.readouterr()

    def test_repro_trace_writes_service_and_power_tracks(self, tmp_path):
        """``REPRO_TRACE`` in an interpreter of its own: the port's
        tracer is installed on import and the file holds the service's
        and the power timelines' tracks."""
        path = tmp_path / "trace.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   REPRO_TRACE=str(path))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve",
             "--trace-corpus", str(SAMPLE_CORPUS), "--device", "cpu",
             "--expect-clean", "--rate-hz", "400", "--repeat", "1"],
            capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=240)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert f"wrote {path}" in proc.stdout
        events = json.loads(path.read_text())
        tracks = {e["args"]["name"] for e in events
                  if e["ph"] == "M" and e["name"] == "process_name"}
        assert "service" in tracks
        assert {"power:traces/listing2", "power:traces/npb_is_a4"} <= tracks
        assert any(e["ph"] == "C" and e["name"] == "power_w"
                   for e in events)

    def test_no_tracer_without_the_variable(self):
        """Importing the port installs no tracer unless the variable is
        set, and ``flush_env_trace`` is then a no-op."""
        assert os.environ.get(trace.TRACE_ENV) is None
        assert trace.configure_from_env() is None
        assert trace.flush_env_trace() is None
        assert not trace.enabled()
