"""Post-SPMD HLO text parsing: collective schedule with while-loop trip
counts.

XLA's ``cost_analysis``/text both describe loop *bodies once* — a
scan-over-layers hides (n_layers - 1)/n_layers of the collective
traffic.  This parser attributes each collective to its enclosing
computation, recovers while-loop trip counts from the loop condition's
compare-against-constant, and multiplies bytes through the (possibly
nested) loop structure — giving faithful per-step collective volume.

A copy of the reference's parser, kept for parity: the port runs
eagerly and produces no XLA text, so its collective schedules come from
the dry run's collective log (:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3": 1,
                "f8e5m2": 1, "s64": 8, "u64": 8, "s32": 4, "u32": 4,
                "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1}

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# header: "%name (params...) -> type {" — params may nest parens (tuples)
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*->.*\{\s*$")
_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")
_BODY_RE = re.compile(r"body=%?([\w.\-]+)")
_COND_RE = re.compile(r"condition=%?([\w.\-]+)")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALL_RE = re.compile(r"calls=%?([\w.\-]+)")
_CONST_CMP_RE = re.compile(r"constant\((\d+)\)")


@dataclass
class CollectiveOp:
    kind: str
    bytes: int
    comp: str
    multiplier: int = 1


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_computations(hlo: str) -> Dict[str, List[str]]:
    """computation name -> its instruction lines."""
    comps: Dict[str, List[str]] = {}
    cur: Optional[str] = None
    for line in hlo.splitlines():
        stripped = line.strip()
        m = _COMP_RE.match(stripped)
        if m and stripped.endswith("{"):
            cur = m.group(1)
            comps[cur] = []
            continue
        if stripped.startswith("}"):
            cur = None
            continue
        if cur is not None and stripped:
            comps[cur].append(stripped)
    return comps


def _entry_name(hlo: str) -> Optional[str]:
    for line in hlo.splitlines():
        s = line.strip()
        if s.startswith("ENTRY"):
            m = re.match(r"ENTRY\s+%?([\w.\-]+)", s)
            if m:
                return m.group(1)
    return None


def _trip_count(cond_lines: List[str]) -> int:
    """Best-effort: the largest compare constant in the condition body."""
    best = 1
    for line in cond_lines:
        if "compare" in line or "constant" in line:
            for m in _CONST_CMP_RE.finditer(line):
                best = max(best, int(m.group(1)))
    return best


def collect_collectives(hlo: str) -> Tuple[List[CollectiveOp], Dict[str, int]]:
    """All collectives with loop-corrected multipliers.

    Returns (ops, per-kind loop-corrected byte totals).
    """
    comps = parse_computations(hlo)
    entry = _entry_name(hlo)

    # computation -> [(kind, bytes)] and -> [(child_comp, trip)]
    own: Dict[str, List[Tuple[str, int]]] = {c: [] for c in comps}
    children: Dict[str, List[Tuple[str, int]]] = {c: [] for c in comps}
    for cname, lines in comps.items():
        for line in lines:
            head = line.split("//")[0]
            matched_coll = False
            for kind in COLLECTIVE_KINDS:
                if re.search(rf"\b{kind}(?:-start)?\(", head):
                    lhs = head.split("=", 1)[0] + "=" + \
                        head.split("=", 1)[1].split(kind)[0]
                    own[cname].append((kind, _shape_bytes(lhs)))
                    matched_coll = True
                    break
            if matched_coll:
                continue
            if " while(" in head:
                bm = _BODY_RE.search(line)
                if bm:
                    tm = _TRIP_RE.search(line)
                    if tm:
                        trip = int(tm.group(1))
                    else:
                        cm = _COND_RE.search(line)
                        trip = _trip_count(
                            comps.get(cm.group(1), [])) if cm else 1
                    children[cname].append((bm.group(1), trip))
                continue
            for m in _CALL_RE.finditer(head):
                children[cname].append((m.group(1), 1))

    memo: Dict[str, Dict[str, int]] = {}

    def total(comp: str, depth=0) -> Dict[str, int]:
        if comp in memo:
            return memo[comp]
        if depth > 50 or comp not in comps:
            return {}
        out: Dict[str, int] = {}
        for kind, b in own.get(comp, []):
            out[kind] = out.get(kind, 0) + b
        for child, trip in children.get(comp, []):
            sub = total(child, depth + 1)
            for kind, b in sub.items():
                out[kind] = out.get(kind, 0) + trip * b
        memo[comp] = out
        return out

    totals = total(entry) if entry else {}
    flat_ops = [CollectiveOp(kind=k, bytes=b, comp=c)
                for c, lst in own.items() for k, b in lst]
    return flat_ops, totals


def collective_schedule(hlo: str) -> List[Tuple[str, int]]:
    """(kind, bytes) in program order of the entry computation, loops
    unrolled once — the input for hlo_extract's job graphs."""
    comps = parse_computations(hlo)
    entry = _entry_name(hlo)
    sched: List[Tuple[str, int]] = []

    def walk(comp: str, depth=0):
        if depth > 50 or comp not in comps:
            return
        for line in comps[comp]:
            head = line.split("//")[0]
            matched = False
            for kind in COLLECTIVE_KINDS:
                if re.search(rf"\b{kind}(?:-start)?\(", head):
                    parts = head.split("=", 1)
                    lhs = parts[0] + "=" + parts[1].split(kind)[0] \
                        if len(parts) == 2 else head
                    sched.append((kind, _shape_bytes(lhs)))
                    matched = True
                    break
            if matched:
                continue
            if " while(" in head:
                m = _BODY_RE.search(line)
                if m:
                    walk(m.group(1), depth + 1)
                continue
            for m in _CALL_RE.finditer(head):
                walk(m.group(1), depth + 1)

    if entry:
        walk(entry)
    return sched
