"""Span tracing in Chrome ``trace_event`` format.

The port's copy of the reference's ``repro.obs.trace``.  Spans,
instants, counters, async spans (one service request's submit→resolve
life, begun and ended on different threads) and already-measured
complete events are collected into one JSON array that Chrome's
``about:tracing`` and Perfetto open directly.

* **Near-zero cost when disabled.**  Instrumentation sites call the
  module-level helpers (:func:`span`, :func:`instant`, :func:`counter`,
  :func:`complete`, :func:`async_begin`, :func:`async_end`); each starts with a single ``if _TRACER is None`` check and returns a
  shared singleton — no allocation, no string formatting, no lock.
* **Thread-safe when enabled.**  The tracer appends under one lock.
* **Tracks.**  String ``track``/``lane`` names map to stable integer
  process/thread ids with their metadata events.

Enabling: inject a :class:`Tracer` with :func:`install` and write it
out with :meth:`Tracer.write`, or set ``REPRO_TRACE=<path>`` in the
environment before the process starts — the tracer is installed when
:mod:`repro_torch.obs` is first imported and the file written at exit
(see :func:`configure_from_env`).  A process that imports both this
package and the reference's gets two tracers on the one path, each
writing its own file at exit: run a traced command of the port in an
interpreter of its own.

Example::

    >>> from repro_torch.obs import trace
    >>> t = trace.install(trace.Tracer())
    >>> with trace.span("plan", cat="sweep", track="engine"):
    ...     trace.instant("bucket-open", track="engine")
    >>> trace.uninstall() is t
    True
    >>> [e["ph"] for e in t.events() if e["ph"] != "M"]
    ['i', 'X']
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

#: Environment variable naming the trace output path.  Set it and every
#: instrumented layer of one process run lands in a single Chrome
#: trace, written at interpreter exit (and on :func:`flush_env_trace`).
TRACE_ENV = "REPRO_TRACE"

#: The process-wide tracer, or ``None`` when tracing is disabled.  The
#: module-level emit helpers read it once per call — the whole cost of
#: disabled instrumentation is that read plus a ``None`` check.
_TRACER: Optional["Tracer"] = None


class _NoopSpan:
    """The shared do-nothing context manager the disabled path returns
    (one singleton for the whole process: disabled spans allocate
    nothing per call)."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    """An open span: records its start at ``__enter__`` and emits ONE
    complete (``ph: X``) event at ``__exit__`` — half the events of a
    B/E pair and trivially well-nested."""

    __slots__ = ("_tracer", "_name", "_cat", "_track", "_lane", "_args",
                 "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 track: Optional[str], lane: Optional[str],
                 args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._lane = lane
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer.complete(self._name, self._t0,
                              time.perf_counter() - self._t0,
                              cat=self._cat, track=self._track,
                              lane=self._lane, args=self._args)
        return False


class Tracer:
    """Thread-safe in-memory collector of Chrome ``trace_event`` dicts.

    **Tracks.**  Chrome traces group events by integer ``pid``
    (rendered as a process group) and ``tid`` (a lane inside it).  The
    tracer maps string names to stable small integers — ``track`` is
    the process-level group (``"service"``, ``"engine"``,
    ``"cluster"``, ``"power:<scenario>"``...), ``lane`` the row within
    it (a node, a bucket, a worker thread; defaults to the calling
    thread's name) — and emits the ``process_name`` /
    ``thread_name`` metadata events viewers use for labels.  Distinct
    names never share an id, so merged multi-layer traces cannot
    collide.

    **Clocks.**  Wall-clock events are stamped relative to the
    tracer's creation from ``time.perf_counter()``; simulated-time
    emitters pass ``ts=<seconds>`` explicitly.  Both are exported in
    the format's microseconds.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._epoch = time.perf_counter()
        self._pids: Dict[str, int] = {}
        self._tids: Dict[Tuple[int, str], int] = {}

    # ------------------------------------------------------------ tracks
    def _pid(self, track: Optional[str]) -> int:
        """The stable integer id of one process-level track (allocates
        and emits the ``process_name`` metadata on first use).  Callers
        hold the lock."""
        name = track or "main"
        pid = self._pids.get(name)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[name] = pid
            self._events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": name}})
        return pid

    def _tid(self, pid: int, lane: Optional[str]) -> int:
        """The stable integer id of one lane within a track (callers
        hold the lock)."""
        name = lane if lane is not None \
            else threading.current_thread().name
        tid = self._tids.get((pid, name))
        if tid is None:
            tid = sum(1 for p, _ in self._tids if p == pid) + 1
            self._tids[(pid, name)] = tid
            self._events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": name}})
        return tid

    def track_ids(self) -> Dict[str, int]:
        """Snapshot of the ``track name -> pid`` map (tests assert the
        merged layers stay on disjoint ids)."""
        with self._lock:
            return dict(self._pids)

    # ------------------------------------------------------------- emit
    def _emit(self, ph: str, name: str, ts_us: float, cat: str,
              track: Optional[str], lane: Optional[str],
              args: Optional[dict], **extra) -> None:
        ev = {"ph": ph, "name": name, "cat": cat or "repro",
              "ts": ts_us, "args": args or {}}
        ev.update(extra)
        with self._lock:
            pid = self._pid(track)
            ev["pid"] = pid
            ev["tid"] = self._tid(pid, lane)
            self._events.append(ev)

    def _ts_us(self, ts: Optional[float], t0: Optional[float]) -> float:
        """Resolve a timestamp to trace microseconds: explicit ``ts``
        is simulated seconds; ``t0`` is a ``perf_counter`` reading;
        neither means "now"."""
        if ts is not None:
            return float(ts) * 1e6
        if t0 is None:
            t0 = time.perf_counter()
        return (t0 - self._epoch) * 1e6

    # ------------------------------------------------------------ events
    def span(self, name: str, cat: str = "", track: Optional[str] = None,
             lane: Optional[str] = None,
             args: Optional[dict] = None) -> _Span:
        """A context manager emitting one wall-clock complete event."""
        return _Span(self, name, cat, track, lane, args)

    def complete(self, name: str, t0: float, dur_s: float,
                 cat: str = "", track: Optional[str] = None,
                 lane: Optional[str] = None, ts: Optional[float] = None,
                 args: Optional[dict] = None) -> None:
        """One already-measured span as a complete (``X``) event.

        ``t0`` is the span's start as a ``perf_counter`` reading and
        ``dur_s`` its measured duration — exactly the numbers the
        profiling layer (:class:`repro_torch.backends.profile.
        BucketProfile`) already collects, so instrumentation reuses one
        measurement instead of timing twice.  Simulated-time callers
        pass ``ts=<start seconds>`` instead of ``t0``.
        """
        self._emit("X", name, self._ts_us(ts, t0), cat, track, lane,
                   args, dur=max(0.0, dur_s) * 1e6)

    def instant(self, name: str, cat: str = "",
                track: Optional[str] = None, lane: Optional[str] = None,
                ts: Optional[float] = None,
                args: Optional[dict] = None) -> None:
        """A zero-duration marker (``i``), thread-scoped."""
        self._emit("i", name, self._ts_us(ts, None), cat, track, lane,
                   args, s="t")

    def counter(self, name: str, values: Dict[str, float],
                cat: str = "", track: Optional[str] = None,
                ts: Optional[float] = None) -> None:
        """One sample of a counter track (``C``): ``values`` maps
        series name to value; viewers render multiple series of one
        counter as a stacked area (the power-timeline view)."""
        self._emit("C", name, self._ts_us(ts, None), cat, track, "",
                   {k: float(v) for k, v in values.items()})

    def async_begin(self, name: str, aid: str, cat: str = "",
                    track: Optional[str] = None,
                    ts: Optional[float] = None,
                    args: Optional[dict] = None) -> None:
        """Open an async span (``b``) — spans that start and end on
        different threads, e.g. one service request's submit→resolve
        life.  ``aid`` correlates the matching :meth:`async_end`."""
        self._emit("b", name, self._ts_us(ts, None), cat, track, "",
                   args, id=str(aid))

    def async_end(self, name: str, aid: str, cat: str = "",
                  track: Optional[str] = None, ts: Optional[float] = None,
                  args: Optional[dict] = None) -> None:
        """Close the async span opened under ``aid``."""
        self._emit("e", name, self._ts_us(ts, None), cat, track, "",
                   args, id=str(aid))

    # ------------------------------------------------------------ export
    def events(self) -> List[dict]:
        """A snapshot copy of the collected events."""
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def __bool__(self) -> bool:
        """An installed tracer is truthy even before its first event
        (``__len__`` would otherwise make an empty tracer falsy)."""
        return True

    def to_json(self) -> str:
        """The Chrome JSON array format (one line per event)."""
        evs = self.events()
        lines = ",\n".join(json.dumps(e, sort_keys=True) for e in evs)
        return "[\n" + lines + "\n]\n" if evs else "[]\n"

    def write(self, path: Optional[str] = None) -> str:
        """Serialize to ``path`` (default: the constructor's path)."""
        path = path or self.path
        if not path:
            raise ValueError("no trace output path configured")
        with open(path, "w") as fh:
            fh.write(self.to_json())
        return path


# ---------------------------------------------------------- module API
def get() -> Optional[Tracer]:
    """The installed tracer, or ``None`` when tracing is disabled.
    Hot loops hoist this once instead of paying a check per event."""
    return _TRACER


def enabled() -> bool:
    """True when a tracer is installed."""
    return _TRACER is not None


def install(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-wide sink for every instrumented
    layer; returns it for chaining."""
    global _TRACER
    _TRACER = tracer
    return tracer


def uninstall() -> Optional[Tracer]:
    """Disable tracing; returns the tracer that was installed."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def span(name: str, cat: str = "", track: Optional[str] = None,
         lane: Optional[str] = None, args: Optional[dict] = None):
    """Module-level span: a real span when tracing is enabled, the
    shared no-op singleton otherwise (the disabled path allocates
    nothing — it returns the same object every call)."""
    t = _TRACER
    if t is None:
        return _NOOP_SPAN
    return t.span(name, cat=cat, track=track, lane=lane, args=args)


def complete(name: str, t0: float, dur_s: float, cat: str = "",
             track: Optional[str] = None, lane: Optional[str] = None,
             ts: Optional[float] = None,
             args: Optional[dict] = None) -> None:
    """Module-level :meth:`Tracer.complete`; no-op when disabled."""
    t = _TRACER
    if t is not None:
        t.complete(name, t0, dur_s, cat=cat, track=track, lane=lane,
                   ts=ts, args=args)


def instant(name: str, cat: str = "", track: Optional[str] = None,
            lane: Optional[str] = None, ts: Optional[float] = None,
            args: Optional[dict] = None) -> None:
    """Module-level :meth:`Tracer.instant`; no-op when disabled."""
    t = _TRACER
    if t is not None:
        t.instant(name, cat=cat, track=track, lane=lane, ts=ts,
                  args=args)


def counter(name: str, values: Dict[str, float], cat: str = "",
            track: Optional[str] = None,
            ts: Optional[float] = None) -> None:
    """Module-level :meth:`Tracer.counter`; no-op when disabled."""
    t = _TRACER
    if t is not None:
        t.counter(name, values, cat=cat, track=track, ts=ts)


def async_begin(name: str, aid: str, cat: str = "",
                track: Optional[str] = None, ts: Optional[float] = None,
                args: Optional[dict] = None) -> None:
    """Module-level :meth:`Tracer.async_begin`; no-op when disabled."""
    t = _TRACER
    if t is not None:
        t.async_begin(name, aid, cat=cat, track=track, ts=ts, args=args)


def async_end(name: str, aid: str, cat: str = "",
              track: Optional[str] = None, ts: Optional[float] = None,
              args: Optional[dict] = None) -> None:
    """Module-level :meth:`Tracer.async_end`; no-op when disabled."""
    t = _TRACER
    if t is not None:
        t.async_end(name, aid, cat=cat, track=track, ts=ts, args=args)


# ------------------------------------------------------ env activation
_env_tracer: Optional[Tracer] = None


def configure_from_env() -> Optional[Tracer]:
    """Install a file-backed tracer when ``REPRO_TRACE=<path>`` is set.

    Idempotent: the first call (run automatically on package import)
    installs the tracer and registers an exit hook that writes the
    file; later calls return the same tracer.  Without the variable it
    does nothing and returns ``None``.
    """
    global _env_tracer
    path = os.environ.get(TRACE_ENV)
    if not path:
        return None
    if _env_tracer is None:
        _env_tracer = Tracer(path=path)
        atexit.register(flush_env_trace)
    return install(_env_tracer)


def flush_env_trace() -> Optional[str]:
    """Write the env-configured tracer's file now (also runs at
    interpreter exit); returns the path or ``None`` when inactive."""
    if _env_tracer is None or not _env_tracer.path:
        return None
    return _env_tracer.write()
