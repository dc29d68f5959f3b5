"""BENCH artifact regression differ (the ``python -m repro_torch.obs`` gate).

A copy of the reference's differ (standard library only): a directory
of committed baseline ``BENCH_*.json`` artifacts and a directory of
fresh ones are diffed with per-metric-class thresholds; ``regress``
emits a markdown report and exits nonzero on a hard regression, so a CI
job fails.

Metrics are classified by name (dotted path, substring match):

* **structural** (``fallbacks``, ``recompiles``, ``failures``, ...) —
  correctness contracts; *any* increase is a hard failure.
* **quality** (``makespan``, ``maxdiff``, ``rel_err``, ...) —
  deterministic outputs; tight thresholds (soft 1%, hard 5%).
* **timing, lower is better** (``wall_s``, ``us_per_call``,
  ``latency``...) — noisy; soft at +25%, hard at +100%.
* **timing, higher is better** (``throughput``, ``speedup``...) —
  soft at −20%, hard at −50%.

Timing classes can be downgraded to warn-only with ``--timing-soft``
(CI compares across host generations; deterministic classes still
gate hard there).  Exit codes: 0 clean/soft-only, 1 hard regression,
2 refusal (schema or backend mismatch — apples to oranges).

    >>> from repro_torch.obs.regress import compare_payloads
    >>> base = {"meta": {"schema_version": 1},
    ...         "benches": {"fig8": {"makespan": 10.0, "wall_s": 1.0}}}
    >>> cur = {"meta": {"schema_version": 1},
    ...        "benches": {"fig8": {"makespan": 11.0, "wall_s": 1.1}}}
    >>> findings = compare_payloads(base, cur)
    >>> [(f.metric, f.status) for f in findings]
    [('fig8.makespan', 'hard'), ('fig8.wall_s', 'ok')]
"""

from __future__ import annotations

import argparse
import io
import json
import pathlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: Bumped when the BENCH payload layout changes incompatibly; regress
#: refuses to compare across versions.
SCHEMA_VERSION = 1

#: Metric-name substrings → class.  First match wins; order matters
#: (``fallbacks`` before the generic ``_s`` timing suffix).
STRUCTURAL = ("fallbacks", "recompiles", "failures", "errors",
              "phantom_guard")
QUALITY = ("makespan", "maxdiff", "max_diff", "rel_err", "relerr",
           "energy_j", "over_budget")
HIGHER_BETTER = ("throughput", "rps", "speedup", "scaling", "rate_hz")
LOWER_BETTER = ("wall_s", "us_per", "latency", "_s", "seconds",
                "compile", "elapsed")

#: ``(soft, hard)`` relative thresholds per class.
THRESHOLDS = {"quality": (0.01, 0.05),
              "lower": (0.25, 1.00),
              "higher": (0.20, 0.50)}


def classify(metric: str) -> Optional[str]:
    """The metric's class, or ``None`` for informational values."""
    name = metric.rsplit(".", 1)[-1]
    for needle in STRUCTURAL:
        if needle in name:
            return "structural"
    for needle in QUALITY:
        if needle in name:
            return "quality"
    for needle in HIGHER_BETTER:
        if needle in name:
            return "higher"
    for needle in LOWER_BETTER:
        if needle in name:
            return "lower"
    return None


@dataclass(frozen=True)
class Finding:
    """One compared metric: its class, both values, and the verdict
    (``ok`` / ``soft`` / ``hard`` / ``info`` / ``new`` / ``missing``)."""

    metric: str
    klass: Optional[str]
    baseline: Optional[float]
    current: Optional[float]
    status: str
    note: str = ""

    @property
    def delta_pct(self) -> Optional[float]:
        """Relative change in percent (None when undefined)."""
        if self.baseline in (None, 0) or self.current is None:
            return None
        return 100.0 * (self.current - self.baseline) / abs(self.baseline)


def _flatten(record: dict, prefix: str = "") -> Dict[str, float]:
    """Numeric leaves of a (possibly nested) bench record, dotted."""
    out: Dict[str, float] = {}
    for key, value in record.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(_flatten(value, path))
        elif isinstance(value, bool):
            continue
        elif isinstance(value, (int, float)):
            out[path] = float(value)
    return out


def split_payload(payload: dict) -> Tuple[dict, dict]:
    """``(meta, benches)`` of one BENCH file; legacy files (written
    before the schema satellite) have no ``meta`` wrapper."""
    if "benches" in payload and "meta" in payload:
        return payload["meta"], payload["benches"]
    return {}, payload


class RefusalError(ValueError):
    """Baseline and current are not comparable (schema/backend skew)."""


def check_comparable(base_meta: dict, cur_meta: dict) -> None:
    """Refuse apples-to-oranges: schema version and backend/device
    class must match when both sides declare them (legacy metadata-free
    files compare permissively)."""
    for key in ("schema_version", "backend", "device_kind"):
        b, c = base_meta.get(key), cur_meta.get(key)
        if b is not None and c is not None and b != c:
            raise RefusalError(
                f"refusing to compare: {key} differs "
                f"(baseline={b!r}, current={c!r})")


def _judge(metric: str, base: float, cur: float,
           timing_soft: bool) -> Finding:
    klass = classify(metric)
    if klass is None:
        return Finding(metric, None, base, cur, "info")
    if klass == "structural":
        status = "hard" if cur > base else "ok"
        return Finding(metric, klass, base, cur, status,
                       "structural count increased" if status != "ok"
                       else "")
    soft, hard = THRESHOLDS[klass]
    if base == 0:
        return Finding(metric, klass, base, cur,
                       "ok" if cur == 0 else "info",
                       "zero baseline" if cur != 0 else "")
    rel = (cur - base) / abs(base)
    if klass == "higher":
        rel = -rel   # a drop in throughput is the regression
    if rel > hard:
        status, note = "hard", f"beyond hard threshold {hard:+.0%}"
        if timing_soft and klass in ("lower", "higher"):
            status, note = "soft", note + " (downgraded: --timing-soft)"
    elif rel > soft:
        status, note = "soft", f"beyond soft threshold {soft:+.0%}"
    else:
        status, note = "ok", ""
    return Finding(metric, klass, base, cur, status, note)


def compare_payloads(baseline: dict, current: dict,
                     timing_soft: bool = False,
                     prefix: str = "") -> List[Finding]:
    """Diff two BENCH payloads (raises :class:`RefusalError` on
    incomparable metadata); findings are sorted by metric path."""
    base_meta, base_benches = split_payload(baseline)
    cur_meta, cur_benches = split_payload(current)
    check_comparable(base_meta, cur_meta)
    base_flat = _flatten(base_benches, prefix)
    cur_flat = _flatten(cur_benches, prefix)
    findings = []
    for metric in sorted(set(base_flat) | set(cur_flat)):
        if metric not in cur_flat:
            findings.append(Finding(metric, classify(metric),
                                    base_flat[metric], None, "missing",
                                    "metric disappeared"))
        elif metric not in base_flat:
            findings.append(Finding(metric, classify(metric), None,
                                    cur_flat[metric], "new"))
        else:
            findings.append(_judge(metric, base_flat[metric],
                                   cur_flat[metric], timing_soft))
    return findings


def compare_dirs(baseline_dir: str, current_dir: str,
                 timing_soft: bool = False,
                 pattern: str = "BENCH_*.json"
                 ) -> Tuple[List[Finding], List[str]]:
    """Diff every baseline artifact against its counterpart.

    Returns ``(findings, notes)`` where notes record artifacts present
    on only one side (fresh artifacts missing in CI is itself a hard
    finding — a silently-skipped bench must not pass the gate).
    """
    base_dir = pathlib.Path(baseline_dir)
    cur_dir = pathlib.Path(current_dir)
    base_files = {p.name: p for p in sorted(base_dir.glob(pattern))}
    cur_files = {p.name: p for p in sorted(cur_dir.glob(pattern))}
    if not base_files:
        raise RefusalError(f"no {pattern} baselines under {base_dir}")
    findings: List[Finding] = []
    notes: List[str] = []
    for name, base_path in base_files.items():
        stem = name[:-len(".json")]
        if name not in cur_files:
            findings.append(Finding(stem, "structural", None, None,
                                    "hard", "artifact missing from "
                                    "current run"))
            continue
        baseline = json.loads(base_path.read_text())
        current = json.loads(cur_files[name].read_text())
        findings.extend(compare_payloads(baseline, current,
                                         timing_soft=timing_soft,
                                         prefix=stem))
    for name in sorted(set(cur_files) - set(base_files)):
        notes.append(f"new artifact (no baseline yet): {name}")
    return findings, notes


def _fmt(value: Optional[float]) -> str:
    if value is None:
        return "—"
    return f"{value:.6g}"


def markdown_report(findings: Sequence[Finding],
                    notes: Sequence[str] = ()) -> str:
    """The findings as a markdown report (what CI prints/uploads)."""
    out = io.StringIO()
    hard = [f for f in findings if f.status == "hard"]
    soft = [f for f in findings if f.status == "soft"]
    out.write("# Bench regression report\n\n")
    out.write(f"{len(findings)} metrics compared — "
              f"**{len(hard)} hard**, {len(soft)} soft.\n\n")
    out.write("| metric | class | baseline | current | Δ% | status |\n")
    out.write("|---|---|---:|---:|---:|---|\n")
    order = {"hard": 0, "soft": 1, "missing": 2, "new": 3, "info": 4,
             "ok": 5}
    for f in sorted(findings, key=lambda f: (order[f.status], f.metric)):
        delta = f.delta_pct
        out.write(f"| `{f.metric}` | {f.klass or '—'} "
                  f"| {_fmt(f.baseline)} | {_fmt(f.current)} "
                  f"| {'—' if delta is None else format(delta, '+.1f')} "
                  f"| {f.status}{' — ' + f.note if f.note else ''} |\n")
    for note in notes:
        out.write(f"\n> {note}\n")
    return out.getvalue()


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry point (``python -m repro_torch.obs regress ...``)."""
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Observability utilities for the repro stack.")
    sub = parser.add_subparsers(dest="cmd", required=True)
    reg = sub.add_parser(
        "regress", help="diff fresh BENCH_*.json against baselines")
    reg.add_argument("--baseline", required=True,
                     help="directory of committed baseline artifacts")
    reg.add_argument("--current", required=True,
                     help="directory holding the fresh artifacts")
    reg.add_argument("--report", default=None,
                     help="write the markdown report here (default: "
                          "stdout only)")
    reg.add_argument("--timing-soft", action="store_true",
                     help="downgrade timing-class hard failures to "
                          "warnings (cross-machine CI compares)")
    args = parser.parse_args(argv)

    try:
        findings, notes = compare_dirs(args.baseline, args.current,
                                       timing_soft=args.timing_soft)
    except RefusalError as exc:
        print(f"REFUSED: {exc}")
        return 2
    report = markdown_report(findings, notes)
    print(report)
    if args.report:
        with open(args.report, "w") as fh:
            fh.write(report)
    hard = sum(1 for f in findings if f.status == "hard")
    return 1 if hard else 0
