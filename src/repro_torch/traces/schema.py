"""Versioned JSONL trace schema (paper §VII-A1).

A *trace* is what the paper's MPI wrapper library records: one stream of
timestamped records per rank — compute spans (with the DVFS state they
ran at) and communication ops.  The on-disk format is JSON Lines:

* line 1 is the **header**::

      {"record": "header", "version": 1, "ranks": 3,
       "cluster": [{"lut": "arndale-5410", "speed": 1.0}, ...],
       "meta": {...}}

  ``cluster`` names each rank's power LUT (resolved through the registry
  in :mod:`repro_torch.traces.calibrate`) and its relative nominal speed —
  everything calibration needs to turn observed seconds back into work
  units.

* **compute spans**::

      {"record": "span", "rank": 0, "seq": 4, "t0": 3.0, "t1": 5.0,
       "f": 1600.0, "rho": 0.8, "tag": "ffn"}

  ``[t0, t1]`` is wall-clock, ``f`` the CPU frequency (MHz) the span ran
  at, ``rho`` the CPU-bound fraction (the calibrator's ``cpu_frac``).

* **communication ops**::

      {"record": "op", "rank": 0, "seq": 5, "t": 5.0, "kind": "send",
       "peer": 1, "tag": ""}
      {"record": "op", "rank": 0, "seq": 9, "t": 8.0,
       "kind": "allreduce", "group": [0, 1, 2]}

  Point-to-point kinds (``send``/``recv``) carry ``peer`` and an
  optional ``tag``; collective kinds (``barrier``/``allreduce``/
  ``alltoall``/``alltoallv``/``bcast``/``reduce``) carry ``group``.
  Nonblocking ops add ``"req": "<id>"`` and are completed by a later
  ``{"kind": "wait", "req": "<id>"}`` on the same rank.

``seq`` is the per-rank program order and is **authoritative** for
reconstruction; timestamps only calibrate durations and the wall clock.
That split is what makes graph reconstruction robust to clock skew and
timestamp jitter — see ``docs/traces.md``.

The loader is strict by default (:class:`TraceError` on any malformed,
out-of-range, or non-monotone record); ``strict=False`` accepts the
timestamp disorder that noisy recordings carry while still enforcing the
structural schema.
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

#: Current schema version.  Loaders reject anything else — the schema is
#: the contract between recorders (real wrappers or the synthetic ones
#: in :mod:`repro_torch.traces.record`) and the reconstruction pass.
TRACE_VERSION = 1

#: Collective op kinds.  All reconstruct identically (occurrence-order
#: matching over ``group``); the distinction is kept for workload
#: statistics and tags.
COLLECTIVE_KINDS = ("barrier", "allreduce", "alltoall", "alltoallv",
                    "bcast", "reduce")

#: Point-to-point op kinds.
P2P_KINDS = ("send", "recv")

OP_KINDS = P2P_KINDS + COLLECTIVE_KINDS + ("wait",)


class TraceError(ValueError):
    """A trace violates the schema (bad record, rank, order, or header)."""


@dataclass(frozen=True)
class RankInfo:
    """One rank's calibration identity: LUT name + relative speed."""

    lut: str
    speed: float = 1.0


@dataclass(frozen=True)
class SpanRecord:
    """A compute span: rank ``rank`` ran flat-out at ``freq_mhz`` over
    wall-clock ``[t0, t1]`` with CPU-bound fraction ``cpu_frac``."""

    rank: int
    seq: int
    t0: float
    t1: float
    freq_mhz: float
    cpu_frac: float = 1.0
    tag: str = ""

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


@dataclass(frozen=True)
class OpRecord:
    """A communication op at wall-clock ``t`` (see module docstring)."""

    rank: int
    seq: int
    t: float
    kind: str
    peer: Optional[int] = None
    group: Optional[Tuple[int, ...]] = None
    tag: str = ""
    req: Optional[str] = None

    @property
    def is_collective(self) -> bool:
        return self.kind in COLLECTIVE_KINDS


TraceRecord = Union[SpanRecord, OpRecord]


@dataclass
class Trace:
    """A loaded trace: header + per-rank record streams.

    ``events`` holds every record; :meth:`rank_events` returns one rank's
    records in ``seq`` (program) order, which is the order every consumer
    walks them in.
    """

    ranks: int
    cluster: Tuple[RankInfo, ...]
    events: List[TraceRecord] = field(default_factory=list)
    meta: Dict[str, object] = field(default_factory=dict)
    version: int = TRACE_VERSION

    def rank_events(self, rank: int) -> List[TraceRecord]:
        """One rank's records in program (``seq``) order."""
        return sorted((e for e in self.events if e.rank == rank),
                      key=lambda e: e.seq)

    def events_by_rank(self) -> Dict[int, List[TraceRecord]]:
        """All ranks' records in ``seq`` order, bucketed in ONE pass —
        what validation and reconstruction iterate (``rank_events`` per
        rank would rescan the whole event list ``ranks`` times)."""
        out: Dict[int, List[TraceRecord]] = {}
        for e in self.events:
            out.setdefault(e.rank, []).append(e)
        for events in out.values():
            events.sort(key=lambda e: e.seq)
        return out

    def spans(self, rank: Optional[int] = None) -> List[SpanRecord]:
        """Compute spans (of one rank, or all), in ``seq`` order."""
        out = [e for e in self.events if isinstance(e, SpanRecord)
               and (rank is None or e.rank == rank)]
        return sorted(out, key=lambda e: (e.rank, e.seq))

    def ops(self, rank: Optional[int] = None) -> List[OpRecord]:
        """Communication ops (of one rank, or all), in ``seq`` order."""
        out = [e for e in self.events if isinstance(e, OpRecord)
               and (rank is None or e.rank == rank)]
        return sorted(out, key=lambda e: (e.rank, e.seq))

    @property
    def wall_clock(self) -> float:
        """The trace's observed total execution time: the latest
        timestamp in the recording (t=0 is the program start)."""
        latest = 0.0
        for e in self.events:
            latest = max(latest, e.t1 if isinstance(e, SpanRecord) else e.t)
        return latest

    # ------------------------------------------------------------ validate
    def validate(self, strict: bool = True) -> "Trace":
        """Schema validation; returns ``self`` for chaining.

        Structural rules always apply (ranks/peers/groups in range,
        known op kinds, sane spans, unique per-rank ``seq``); ``strict``
        additionally requires per-rank timestamps to be non-decreasing
        in program order — exactly the property jittered/skewed
        recordings lose — and exact ``req``/``wait`` pairing (no
        duplicate, unknown, or never-waited requests), which dropped
        records legitimately break.
        """
        if self.version != TRACE_VERSION:
            raise TraceError(f"unsupported trace version {self.version} "
                             f"(supported: {TRACE_VERSION})")
        if self.ranks < 1:
            raise TraceError("a trace needs at least one rank")
        if len(self.cluster) != self.ranks:
            raise TraceError(f"header cluster has {len(self.cluster)} "
                             f"entries for {self.ranks} ranks")
        for info in self.cluster:
            if info.speed <= 0:
                raise TraceError(f"non-positive speed for LUT {info.lut!r}")
        for e in self.events:
            if not 0 <= e.rank < self.ranks:
                raise TraceError(f"seq {e.seq}: rank {e.rank} out of "
                                 f"range for {self.ranks}-rank trace")
        by_rank = self.events_by_rank()
        for rank in range(self.ranks):
            self._validate_rank(rank, by_rank.get(rank, []), strict)
        return self

    def _validate_rank(self, rank: int, events: List[TraceRecord],
                       strict: bool) -> None:
        seqs = [e.seq for e in events]
        if len(set(seqs)) != len(seqs):
            raise TraceError(f"rank {rank}: duplicate seq numbers")
        pending: Dict[str, OpRecord] = {}
        last_t = 0.0
        for e in events:
            if isinstance(e, SpanRecord):
                if e.t1 < e.t0:
                    raise TraceError(f"rank {rank} seq {e.seq}: span ends "
                                     f"before it starts")
                if e.t0 < 0:
                    raise TraceError(f"rank {rank} seq {e.seq}: negative "
                                     f"timestamp")
                if e.freq_mhz <= 0:
                    raise TraceError(f"rank {rank} seq {e.seq}: "
                                     f"non-positive frequency")
                if not 0.0 <= e.cpu_frac <= 1.0:
                    raise TraceError(f"rank {rank} seq {e.seq}: cpu_frac "
                                     f"outside [0, 1]")
                t0, t1 = e.t0, e.t1
            else:
                self._validate_op(e)
                if e.req is not None and e.kind != "wait":
                    if e.req in pending and strict:
                        raise TraceError(
                            f"rank {rank} seq {e.seq}: request "
                            f"{e.req!r} posted while still pending")
                    pending[e.req] = e
                elif e.kind == "wait":
                    if e.req not in pending and strict:
                        raise TraceError(
                            f"rank {rank} seq {e.seq}: wait for unknown "
                            f"request {e.req!r}")
                    pending.pop(e.req, None)
                t0 = t1 = e.t
            if strict and t0 < last_t - 1e-9:
                raise TraceError(
                    f"rank {rank} seq {e.seq}: timestamp goes backwards "
                    f"({t0} after {last_t}); load with strict=False for "
                    f"jittered recordings")
            last_t = max(last_t, t1)
        if pending and strict:
            # lenient mode tolerates dropped wait records — the
            # reconstruction completes such posts at their post site
            raise TraceError(f"rank {rank}: nonblocking ops never waited "
                             f"on: {sorted(pending)}")

    def _validate_op(self, op: OpRecord) -> None:
        where = f"rank {op.rank} seq {op.seq}"
        if op.kind not in OP_KINDS:
            raise TraceError(f"{where}: unknown op kind {op.kind!r}")
        if op.t < 0:
            raise TraceError(f"{where}: negative timestamp")
        if op.kind in P2P_KINDS:
            if op.peer is None or not 0 <= op.peer < self.ranks:
                raise TraceError(f"{where}: {op.kind} peer out of range")
            if op.peer == op.rank:
                raise TraceError(f"{where}: {op.kind} to self")
        elif op.kind in COLLECTIVE_KINDS:
            if not op.group:
                raise TraceError(f"{where}: collective without a group")
            if not set(op.group) <= set(range(self.ranks)):
                raise TraceError(f"{where}: group members out of range")
            if op.rank not in op.group:
                raise TraceError(f"{where}: rank outside its own "
                                 f"collective group")
        elif op.kind == "wait":
            if op.req is None:
                raise TraceError(f"{where}: wait without a request id")


# --------------------------------------------------------------- (de)serde
def _record_to_json(e: TraceRecord) -> dict:
    if isinstance(e, SpanRecord):
        out = {"record": "span", "rank": e.rank, "seq": e.seq,
               "t0": round(float(e.t0), 9), "t1": round(float(e.t1), 9),
               "f": float(e.freq_mhz), "rho": float(e.cpu_frac)}
        if e.tag:
            out["tag"] = e.tag
        return out
    out = {"record": "op", "rank": e.rank, "seq": e.seq,
           "t": round(float(e.t), 9), "kind": e.kind}
    if e.peer is not None:
        out["peer"] = e.peer
    if e.group is not None:
        out["group"] = list(e.group)
    if e.tag:
        out["tag"] = e.tag
    if e.req is not None:
        out["req"] = e.req
    return out


def _require(obj: Mapping, key: str, lineno: int):
    if key not in obj:
        raise TraceError(f"line {lineno}: missing field {key!r}")
    return obj[key]


def _record_from_json(obj: Mapping, lineno: int) -> TraceRecord:
    kind = _require(obj, "record", lineno)
    try:
        if kind == "span":
            return SpanRecord(
                rank=int(_require(obj, "rank", lineno)),
                seq=int(_require(obj, "seq", lineno)),
                t0=float(_require(obj, "t0", lineno)),
                t1=float(_require(obj, "t1", lineno)),
                freq_mhz=float(_require(obj, "f", lineno)),
                cpu_frac=float(obj.get("rho", 1.0)),
                tag=str(obj.get("tag", "")))
        if kind == "op":
            group = obj.get("group")
            return OpRecord(
                rank=int(_require(obj, "rank", lineno)),
                seq=int(_require(obj, "seq", lineno)),
                t=float(_require(obj, "t", lineno)),
                kind=str(_require(obj, "kind", lineno)),
                peer=None if obj.get("peer") is None else int(obj["peer"]),
                group=None if group is None else tuple(int(g)
                                                       for g in group),
                tag=str(obj.get("tag", "")),
                req=None if obj.get("req") is None else str(obj["req"]))
    except (TypeError, ValueError) as e:
        raise TraceError(f"line {lineno}: {e}") from e
    raise TraceError(f"line {lineno}: unknown record type {kind!r}")


def dumps_trace(trace: Trace) -> str:
    """Serialise a trace to JSONL text (header first, then events in
    ``(rank, seq)`` order — a canonical layout, so identical traces
    serialise byte-identically)."""
    buf = io.StringIO()
    header = {"record": "header", "version": trace.version,
              "ranks": trace.ranks,
              "cluster": [{"lut": c.lut, "speed": c.speed}
                          for c in trace.cluster]}
    if trace.meta:
        header["meta"] = trace.meta
    buf.write(json.dumps(header, sort_keys=True) + "\n")
    for e in sorted(trace.events, key=lambda e: (e.rank, e.seq)):
        buf.write(json.dumps(_record_to_json(e), sort_keys=True) + "\n")
    return buf.getvalue()


def loads_trace(text: str, strict: bool = True) -> Trace:
    """Parse and validate JSONL trace text (see :meth:`Trace.validate`
    for what ``strict`` gates)."""
    header = None
    events: List[TraceRecord] = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise TraceError(f"line {lineno}: invalid JSON: {e}") from e
        if not isinstance(obj, dict):
            raise TraceError(f"line {lineno}: expected an object")
        if obj.get("record") == "header":
            if header is not None:
                raise TraceError(f"line {lineno}: duplicate header")
            if events:
                raise TraceError(f"line {lineno}: header must be the "
                                 f"first record")
            header = obj
            continue
        if header is None:
            raise TraceError(f"line {lineno}: records before the header")
        events.append(_record_from_json(obj, lineno))
    if header is None:
        raise TraceError("empty trace: no header record")
    try:
        cluster = tuple(RankInfo(lut=str(_require(c, "lut", 1)),
                                 speed=float(c.get("speed", 1.0)))
                        for c in _require(header, "cluster", 1))
        trace = Trace(ranks=int(_require(header, "ranks", 1)),
                      cluster=cluster, events=events,
                      meta=dict(header.get("meta", {})),
                      version=int(header.get("version", -1)))
    except TraceError:
        raise
    except (TypeError, ValueError, AttributeError) as e:
        raise TraceError(f"malformed header: {e}") from e
    return trace.validate(strict=strict)


def dump_trace(trace: Trace, path) -> None:
    """Write a trace to ``path`` as JSONL."""
    with open(path, "w") as fh:
        fh.write(dumps_trace(trace))


def load_trace(path, strict: bool = True) -> Trace:
    """Read and validate a JSONL trace file."""
    with open(path) as fh:
        return loads_trace(fh.read(), strict=strict)
