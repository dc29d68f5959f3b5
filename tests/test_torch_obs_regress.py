"""The port's BENCH regression gate: classifier, differ, CLI exits, each
case a counterpart of `tests/test_obs_regress.py`, plus the reference's
verdicts on the same payloads.

The acceptance contract, tested in both directions: ``python -m
repro_torch.obs regress`` exits 0 on identical artifacts and nonzero when a
makespan (quality) or throughput (higher-is-better) metric is pushed
past its hard threshold; metadata skew refuses (exit 2) instead of
producing an apples-to-oranges diff.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.obs.regress import (RefusalError, classify,
                                     compare_payloads, main,
                                     markdown_report, split_payload)


def payload(benches, meta=None):
    return {"meta": meta if meta is not None
            else {"schema_version": 1, "backend": "cpu",
                  "device_kind": "cpu"},
            "benches": benches}


BASE = {"fig8": {"makespan": 10.0, "wall_s": 1.0,
                 "throughput_rps": 100.0, "recompiles": 0,
                 "cells": 500}}


def write_dir(tmp_path, name, benches, meta=None,
              fname="BENCH_sweep.json"):
    d = tmp_path / name
    d.mkdir(exist_ok=True)
    (d / fname).write_text(json.dumps(payload(benches, meta)))
    return str(d)


# ---------------------------------------------------------- classifier
class TestClassify:
    @pytest.mark.parametrize("metric,klass", [
        ("a.fallbacks", "structural"),
        ("serve.recompiles", "structural"),
        ("x.failures", "structural"),
        ("fig8.makespan", "quality"),
        ("fig8.max_makespan_diff_vs_offline", "quality"),
        ("x.rel_err", "quality"),
        ("serve.throughput_rps", "higher"),
        ("sharded.speedup", "higher"),
        ("fig8.wall_s", "lower"),
        ("fig8.us_per_cell", "lower"),
        ("serve.latency_p99_s", "lower"),
        ("grid.cells", None),
    ])
    def test_by_name(self, metric, klass):
        assert classify(metric) == klass

    def test_last_component_wins(self):
        # the bench name must not leak into classification
        assert classify("serve_stream.grid.cells") is None


# -------------------------------------------------------------- differ
class TestComparePayloads:
    def test_identical_is_clean(self):
        findings = compare_payloads(payload(BASE), payload(BASE))
        assert all(f.status in ("ok", "info") for f in findings)

    def test_quality_hard_regression(self):
        cur = {"fig8": dict(BASE["fig8"], makespan=11.0)}
        findings = compare_payloads(payload(BASE), payload(cur))
        bad = [f for f in findings if f.metric == "fig8.makespan"]
        assert bad[0].status == "hard"
        assert bad[0].delta_pct == pytest.approx(10.0)

    def test_quality_soft_band(self):
        cur = {"fig8": dict(BASE["fig8"], makespan=10.3)}
        findings = compare_payloads(payload(BASE), payload(cur))
        assert [f for f in findings
                if f.metric == "fig8.makespan"][0].status == "soft"

    def test_quality_improvement_is_ok(self):
        cur = {"fig8": dict(BASE["fig8"], makespan=9.0)}
        findings = compare_payloads(payload(BASE), payload(cur))
        assert [f for f in findings
                if f.metric == "fig8.makespan"][0].status == "ok"

    def test_throughput_drop_is_hard(self):
        cur = {"fig8": dict(BASE["fig8"], throughput_rps=40.0)}
        findings = compare_payloads(payload(BASE), payload(cur))
        f = [x for x in findings
             if x.metric == "fig8.throughput_rps"][0]
        assert f.status == "hard"

    def test_throughput_gain_is_ok(self):
        cur = {"fig8": dict(BASE["fig8"], throughput_rps=300.0)}
        findings = compare_payloads(payload(BASE), payload(cur))
        assert [x for x in findings
                if x.metric == "fig8.throughput_rps"][0].status == "ok"

    def test_structural_any_increase_is_hard(self):
        cur = {"fig8": dict(BASE["fig8"], recompiles=1)}
        findings = compare_payloads(payload(BASE), payload(cur))
        assert [f for f in findings
                if f.metric == "fig8.recompiles"][0].status == "hard"

    def test_timing_soft_downgrades_only_timing(self):
        cur = {"fig8": dict(BASE["fig8"], wall_s=3.0, makespan=11.0)}
        findings = compare_payloads(payload(BASE), payload(cur),
                                    timing_soft=True)
        by = {f.metric: f.status for f in findings}
        assert by["fig8.wall_s"] == "soft"       # downgraded
        assert by["fig8.makespan"] == "hard"     # quality still gates

    def test_missing_and_new_metrics(self):
        cur = {"fig8": {"makespan": 10.0, "extra": 1.0}}
        statuses = {f.metric: f.status for f in compare_payloads(
            payload(BASE), payload(cur))}
        assert statuses["fig8.wall_s"] == "missing"
        assert statuses["fig8.extra"] == "new"

    def test_schema_mismatch_refuses(self):
        with pytest.raises(RefusalError):
            compare_payloads(payload(BASE),
                             payload(BASE, {"schema_version": 2}))

    def test_backend_mismatch_refuses(self):
        with pytest.raises(RefusalError):
            compare_payloads(
                payload(BASE, {"backend": "cpu"}),
                payload(BASE, {"backend": "gpu"}))

    def test_legacy_unwrapped_payload(self):
        meta, benches = split_payload(BASE)
        assert meta == {} and benches is BASE
        findings = compare_payloads(BASE, payload(BASE))
        assert all(f.status in ("ok", "info") for f in findings)


# -------------------------------------------------------------- report
class TestReport:
    def test_markdown_contains_verdicts(self):
        cur = {"fig8": dict(BASE["fig8"], makespan=11.0)}
        findings = compare_payloads(payload(BASE), payload(cur))
        report = markdown_report(findings, ["note-1"])
        assert "**1 hard**" in report
        assert "`fig8.makespan`" in report
        assert "| hard" in report
        assert "note-1" in report


# ----------------------------------------------------------------- CLI
class TestCli:
    def test_identical_dirs_exit_zero(self, tmp_path, capsys):
        base = write_dir(tmp_path, "base", BASE)
        cur = write_dir(tmp_path, "cur", BASE)
        assert main(["regress", "--baseline", base,
                     "--current", cur]) == 0
        assert "0 hard" in capsys.readouterr().out

    def test_injected_makespan_regression_exits_nonzero(
            self, tmp_path, capsys):
        base = write_dir(tmp_path, "base", BASE)
        cur = write_dir(tmp_path, "cur",
                        {"fig8": dict(BASE["fig8"], makespan=11.0)})
        assert main(["regress", "--baseline", base,
                     "--current", cur]) == 1
        assert "fig8.makespan" in capsys.readouterr().out

    def test_injected_throughput_regression_exits_nonzero(
            self, tmp_path):
        base = write_dir(tmp_path, "base", BASE)
        cur = write_dir(
            tmp_path, "cur",
            {"fig8": dict(BASE["fig8"], throughput_rps=40.0)})
        assert main(["regress", "--baseline", base,
                     "--current", cur]) == 1

    def test_meta_mismatch_exits_two(self, tmp_path, capsys):
        base = write_dir(tmp_path, "base", BASE)
        cur = write_dir(tmp_path, "cur", BASE,
                        meta={"schema_version": 2})
        assert main(["regress", "--baseline", base,
                     "--current", cur]) == 2
        assert "REFUSED" in capsys.readouterr().out

    def test_missing_artifact_is_hard(self, tmp_path):
        base = write_dir(tmp_path, "base", BASE)
        cur = tmp_path / "cur"
        cur.mkdir()
        assert main(["regress", "--baseline", base,
                     "--current", str(cur)]) == 1

    def test_no_baselines_refuses(self, tmp_path):
        base = tmp_path / "base"
        base.mkdir()
        cur = write_dir(tmp_path, "cur", BASE)
        assert main(["regress", "--baseline", str(base),
                     "--current", cur]) == 2

    def test_report_file_written(self, tmp_path):
        base = write_dir(tmp_path, "base", BASE)
        cur = write_dir(tmp_path, "cur", BASE)
        report = tmp_path / "report.md"
        assert main(["regress", "--baseline", base, "--current", cur,
                     "--report", str(report)]) == 0
        assert "Bench regression report" in report.read_text()

    def test_new_artifact_is_note_not_failure(self, tmp_path, capsys):
        base = write_dir(tmp_path, "base", BASE)
        cur = write_dir(tmp_path, "cur", BASE)
        write_dir(tmp_path, "cur", BASE, fname="BENCH_serve.json")
        assert main(["regress", "--baseline", base,
                     "--current", cur]) == 0
        assert "no baseline yet" in capsys.readouterr().out

    def test_committed_baselines_self_compare(self, capsys):
        # the artifacts seeded for CI must pass their own gate
        baselines = str(pathlib.Path(__file__).resolve().parents[1]
                        / "benchmarks" / "baselines")
        assert main(["regress", "--baseline", baselines,
                     "--current", baselines]) == 0


# ------------------------------------------------- against the reference
_VARIANTS = [
    {"fig8": dict(BASE["fig8"], makespan=11.0, wall_s=3.0)},
    {"fig8": dict(BASE["fig8"], makespan=10.3, throughput_rps=40.0,
                  recompiles=1)},
    {"fig8": dict(BASE["fig8"], makespan=9.0, throughput_rps=300.0,
                  wall_s=1.6)},
    {"fig8": {"makespan": 10.0, "extra": 1.0},
     "serve": {"latency_p99_s": 0.2, "grid": {"cells": 4}}},
]


@pytest.mark.parametrize("timing_soft", [False, True])
def test_findings_and_verdicts_match_reference(timing_soft):
    """On the same payloads the copy gives the reference's findings, field
    for field, and the same markdown report."""
    from repro.obs import regress as ref

    for cur in _VARIANTS:
        ours = compare_payloads(payload(BASE), payload(cur),
                                timing_soft=timing_soft)
        theirs = ref.compare_payloads(payload(BASE), payload(cur),
                                      timing_soft=timing_soft)
        assert [dataclasses.astuple(f) for f in ours] == \
            [dataclasses.astuple(f) for f in theirs]
        assert markdown_report(ours, ["n"]) == \
            ref.markdown_report(theirs, ["n"])
    with pytest.raises(ref.RefusalError):
        ref.compare_payloads(payload(BASE),
                             payload(BASE, {"schema_version": 2}))


def test_module_cli_exits_as_reference(tmp_path):
    """``python -m repro_torch.obs regress`` and ``python -m repro.obs
    regress`` give the same exit code and report on the same dirs."""
    root = pathlib.Path(__file__).resolve().parents[1]
    base = write_dir(tmp_path, "base", BASE)
    cur = write_dir(tmp_path, "cur",
                    {"fig8": dict(BASE["fig8"], makespan=11.0)})
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    runs = [subprocess.run([sys.executable, "-m", pkg, "regress",
                            "--baseline", base, "--current", cur],
                           capture_output=True, text=True, env=env,
                           timeout=120)
            for pkg in ("repro_torch.obs", "repro.obs")]
    assert [r.returncode for r in runs] == [1, 1], runs[0].stderr
    assert runs[0].stdout == runs[1].stdout


def test_module_doctest_runs():
    """The copy's docstring example runs, as the reference's does in
    ``tests/test_docs.py``."""
    import doctest

    from repro_torch.obs import regress

    result = doctest.testmod(regress, verbose=False,
                             optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0


def test_public_api_has_docstrings():
    import inspect

    from repro_torch.obs import regress

    missing = [name for name, obj in vars(regress).items()
               if not name.startswith("_")
               and (inspect.isfunction(obj) or inspect.isclass(obj))
               and getattr(obj, "__module__", "") == regress.__name__
               and not inspect.getdoc(obj)]
    assert not missing, missing
