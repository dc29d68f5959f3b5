"""Streaming sweep service: continuous bucket batching over an open
scenario stream.

The port's copy of the reference's ``repro.serving.service``, on the
torch engine.  The offline :class:`~repro_torch.core.sweep.SweepEngine`
takes a closed scenario list, buckets it, runs, returns.  Production
traffic is an open stream: scenarios arrive one at a time, each wants an
answer quickly, and the service never exits.  :class:`SweepService` is
the long-lived frontend for that mode, built from the same planning
vocabulary the engine exposes (:func:`~repro_torch.core.sweep.bucket_key`,
:func:`~repro_torch.core.sweep.build_batch_sim`,
:func:`~repro_torch.core.sweep.plan_chunk_rows`) so a scenario lands in
the same bucket shape whichever frontend dispatched it.

The decomposition is the classic feeder / scheduler / worker split of
LLM-serving simulators (Helix's ``ClusterSimulator``), one thread per
stage:

* **feeder** — callers (or :func:`repro_torch.serving.stream.
  poisson_replay`) call :meth:`SweepService.submit`; each scenario
  becomes a request with a :class:`ServeTicket` the caller blocks on.  A
  result-cache hit (content-based
  :func:`~repro_torch.core.sweep.scenario_cache_key`) resolves the
  ticket immediately, without touching the pipeline.
* **scheduler** — the single owner of the *open buckets*: requests
  pack continuously into the bucket for their envelope key, and a
  bucket flushes when it is **full** (its fixed row capacity, sized by
  the device-memory planner) or when its **deadline** expires
  (``flush_deadline_s`` after the bucket opened — dispatch a
  partially-filled bucket rather than blow the latency SLO).
* **dispatcher** — builds the batch simulator for each flushed bucket
  and launches it: torch buckets dispatch asynchronously (one
  ``wave_run`` launch on the card) and are handed to the collector,
  vector buckets run synchronously in place.  It is the only thread
  that launches on the card.
* **collector** — waits on in-flight torch batches in dispatch order,
  trims the phantom rows, and resolves every request with its result
  and measured submit→result latency.

**Fixed bucket shapes.**  Every dispatched torch bucket has a shape
fully determined by its service bucket key: the stacked power-of-two
envelope (major *and* minor dims), a *fixed* row capacity (partial
flushes are padded with phantom replicas of the last request, trimmed
on fetch), and a fixed bound-schedule column count — the reference's
compile-once layout.  The card has no jit cache: the kernel library is
built once a process, and the profile
(:class:`~repro_torch.backends.profile.SweepProfile`) shows it with
``compiles_after(warm-up) == 0``.  Each phantom row is a real row of the
launch, and its results are built and dropped.

Example (synchronous caller, the torch engine on the CPU)::

    >>> from repro_torch.core import (listing2_graph, homogeneous_cluster,
    ...                               scenario_grid)
    >>> from repro_torch.serving import SweepService
    >>> cells = scenario_grid({"l2": listing2_graph()},
    ...                       homogeneous_cluster(3), [6.0, 9.0],
    ...                       ["equal-share"])
    >>> with SweepService(executor="torch", device="cpu",
    ...                   flush_deadline_s=0.01) as svc:
    ...     tickets = [svc.submit(s) for s in cells]
    ...     records = [t.result(timeout=60) for t in tickets]
    >>> [r.ok for r in records], [r.backend for r in records]
    ([True, True], ['torch', 'torch'])
    >>> round(records[0].result.makespan, 1)
    38.0
"""

from __future__ import annotations

import concurrent.futures as _futures
import dataclasses
import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.arrays import BIG_EVENT_TIME
from repro_torch.core.batchsim import estimate_row_bytes
from repro_torch.core.results import SimResult
from repro_torch.core.sweep import (AssignmentCache, Scenario,
                                    _run_scenario, build_batch_sim,
                                    bucket_key, device_budget_mb,
                                    next_pow2, plan_backend,
                                    plan_chunk_rows, scenario_cache_key,
                                    scenario_dims)
from repro_torch.obs import MetricsRegistry
from repro_torch.obs import trace as obs_trace

#: Default rows one service bucket holds before it force-flushes.  Kept
#: deliberately small: the service optimizes latency under a deadline,
#: not offline throughput, and a full bucket should fill well inside
#: one ``flush_deadline_s`` at moderate arrival rates.
DEFAULT_BUCKET_ROWS = 8


@dataclass
class ServeRecord:
    """One resolved request: the offline ``SweepRecord`` fields plus
    the streaming-side accounting (latency, cache, flush cause)."""

    scenario: Scenario
    result: Optional[SimResult]
    error: Optional[str] = None
    #: Which simulator answered: "torch", "vector", "event", or "cache".
    backend: str = "event"
    #: Why the request left the requested batched backend (None when it
    #: ran there; mirrors ``SweepRecord.fallback_reason``).
    fallback_reason: Optional[str] = None
    #: Label of the dispatched bucket (None for cache hits/fallbacks).
    bucket: Optional[str] = None
    #: submit() -> resolved wall-clock, the service's headline metric.
    latency_s: float = 0.0
    #: True when the result came straight from the content cache.
    cached: bool = False
    #: "full" or "deadline" — what flushed the request's bucket.
    flush_cause: Optional[str] = None

    @property
    def ok(self) -> bool:
        """True when the request produced a result (no error)."""
        return self.error is None


class ServeTicket:
    """Caller-side handle for one submitted scenario."""

    def __init__(self, scenario: Scenario):
        self.scenario = scenario
        self._event = threading.Event()
        self._record: Optional[ServeRecord] = None

    def done(self) -> bool:
        """True once the request has resolved (result or error)."""
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeRecord:
        """Block until resolved; raises :class:`TimeoutError` on
        expiry.  The record is returned even when the request failed —
        check :attr:`ServeRecord.ok` / ``error``."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.scenario.name!r} not resolved within "
                f"{timeout}s")
        return self._record

    def _resolve(self, record: ServeRecord) -> None:
        self._record = record
        self._event.set()


@dataclass
class ServiceStats:
    """A consistent snapshot of the service counters.

    Counts and latency percentiles are read out of the service's
    :class:`~repro_torch.obs.metrics.MetricsRegistry` (one source of
    truth), so the percentiles are the registry histogram's nearest-rank
    values over every resolved request, cache hits included.
    """

    submitted: int = 0
    completed: int = 0
    failed: int = 0
    cache_hits: int = 0
    fallbacks: int = 0
    buckets: int = 0
    flushed_full: int = 0
    flushed_deadline: int = 0
    phantom_rows: int = 0
    #: Nearest-rank submit→result latency percentiles over every
    #: resolved request (None before the first resolution).
    latency_p50_s: Optional[float] = None
    latency_p99_s: Optional[float] = None

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclass
class _Request:
    scenario: Scenario
    ticket: ServeTicket
    submit_t: float
    cache_key: Optional[tuple]
    #: Async-span correlation id when tracing is enabled (None when
    #: disabled — no per-request id allocation on the fast path).
    aid: Optional[str] = None
    #: Why the plan sent the request off the requested executor.
    reason: Optional[str] = None


@dataclass
class _OpenBucket:
    key: tuple
    backend: str
    pad_dims: Tuple[int, int, int, int, int]
    sched_cols: int
    cap: int
    deadline: float
    requests: List[_Request] = field(default_factory=list)


@dataclass
class _Flush:
    bucket: _OpenBucket
    cause: str                      # "full" | "deadline"
    label: str


class _Close:
    """Queue sentinel: shut the stage down after draining."""


class _FlushAll:
    """Inbox sentinel: flush every open bucket now (drain barrier)."""


class SweepService:
    """A long-lived scenario-sweep server with continuous batching.

    ``executor`` is ``"torch"`` (the torch engine, async dispatch
    pipeline) or ``"vector"`` (the numpy batch backend).  Requests whose
    policy cannot run batched fall down the same
    torch → vector → event chain as the offline engine, with the event
    leg served by a small thread pool (numpy only: no fallback thread
    touches the card).

    The ``"torch"`` executor runs on ``device`` (``None``: the card, and
    it raises without one; ``"cpu"`` runs the engine's plain path) with
    engine path ``impl``, as :class:`~repro_torch.core.sweep.SweepEngine`
    does, each bucket's rows split over ``shard_devices`` devices
    (``None``: every visible one) with capacities aligned to that width.

    ``flush_deadline_s`` is the batching SLO knob: the longest a
    request may wait in an open bucket for co-batchable traffic before
    the bucket dispatches partially filled.  ``bucket_rows`` caps the
    bucket capacity; the effective capacity is the smaller of it and
    the device-memory planner's row budget (``memory_budget_mb`` /
    ``REPRO_DEVICE_BUDGET_MB``, exactly like the offline engine).

    The service is a context manager; on exit it drains in-flight work
    and joins its threads.  All public methods are thread-safe.
    """

    def __init__(self, executor: str = "torch",
                 flush_deadline_s: float = 0.05,
                 bucket_rows: int = DEFAULT_BUCKET_ROWS,
                 vector_dt: float = 0.05,
                 shard_devices: Optional[int] = None,
                 memory_budget_mb: Optional[float] = None,
                 result_cache: bool = True,
                 fallback_workers: int = 2,
                 metrics: Optional[MetricsRegistry] = None,
                 device=None, impl: Optional[str] = None):
        if executor not in ("torch", "vector"):
            raise ValueError(f"unknown service executor {executor!r} "
                             "(use 'torch' or 'vector')")
        if flush_deadline_s <= 0:
            raise ValueError("flush_deadline_s must be positive")
        if bucket_rows < 1:
            raise ValueError("bucket_rows must be >= 1")
        self.executor = executor
        self.flush_deadline_s = float(flush_deadline_s)
        self.bucket_rows = int(bucket_rows)
        self.vector_dt = float(vector_dt)
        self.shard_devices = shard_devices
        self.memory_budget_mb = device_budget_mb(memory_budget_mb)
        self.result_cache = bool(result_cache)
        self.impl = impl
        self.device = None
        self.max_lanes: Optional[int] = None
        if executor == "torch":
            from repro_torch.backends.engine import resolve_device
            from repro_torch.kernels.power_step import MAX_LANES

            self.device = resolve_device(device)
            if self.device.type == "cuda":
                self.max_lanes = MAX_LANES

        from repro_torch.backends.profile import SweepProfile

        #: Per-bucket pack/dispatch/run/transfer/results profiles; the
        #: smoke run asserts ``profile.compiles == 0`` once the kernels
        #: are built.  Recorded at dispatch time, unconditionally.
        self.profile = SweepProfile()

        self._assignments = AssignmentCache()
        self._cache: Dict[tuple, SimResult] = {}
        self._lock = threading.Lock()          # cache + outstanding
        #: All service counters/latencies live in one metrics registry
        #: (injectable, else private) — :meth:`stats` reads it.
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry()
        self._c_submitted = self.metrics.counter("serve_submitted")
        self._c_completed = self.metrics.counter("serve_completed")
        self._c_failed = self.metrics.counter("serve_failed")
        self._c_cache_hits = self.metrics.counter("serve_cache_hits")
        self._c_fallbacks = self.metrics.counter("serve_fallbacks")
        self._c_buckets = self.metrics.counter("serve_buckets")
        self._c_flushes = self.metrics.counter("serve_flushes")
        self._c_phantom = self.metrics.counter("serve_phantom_rows")
        self._h_latency = self.metrics.histogram("serve_latency_s")
        self._phase: Optional[str] = None
        self._outstanding = 0
        self._idle = threading.Condition(self._lock)
        self._torch_align: Optional[int] = None
        self._dims_cache: Dict[tuple, tuple] = {}
        self._texts: Dict[int, tuple] = {}     # graph texts of cache keys
        self._bucket_seq = itertools.count()
        self._req_seq = itertools.count()

        self._inbox: "queue.Queue" = queue.Queue()
        self._dispatch_q: "queue.Queue" = queue.Queue()
        self._fetch_q: "queue.Queue" = queue.Queue()
        self._fallback_pool = _futures.ThreadPoolExecutor(
            max_workers=fallback_workers,
            thread_name_prefix="serve-fallback")
        self._closed = False
        self._threads = [
            threading.Thread(target=self._scheduler_loop,
                             name="serve-scheduler", daemon=True),
            threading.Thread(target=self._dispatch_loop,
                             name="serve-dispatcher", daemon=True),
            threading.Thread(target=self._collect_loop,
                             name="serve-collector", daemon=True),
        ]
        for t in self._threads:
            t.start()

    # ---------------------------------------------------------- lifecycle
    def __enter__(self) -> "SweepService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop accepting requests, drain everything in flight, join
        the worker threads.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._inbox.put(_Close)
        for t in self._threads:
            t.join()
        self._fallback_pool.shutdown(wait=True)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Flush every open bucket and block until all submitted
        requests have resolved (the warm-up barrier)."""
        self._inbox.put(_FlushAll)
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._idle:
            while self._outstanding > 0:
                left = None if deadline is None \
                    else deadline - time.perf_counter()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"{self._outstanding} requests still in flight "
                        f"after {timeout}s")
                self._idle.wait(timeout=left)

    def set_phase(self, phase: Optional[str]) -> None:
        """Tag subsequent latency observations with ``phase=<name>``.

        Latencies are always recorded in the unlabeled series (which
        :meth:`stats` reads); when a phase is set they are *also*
        recorded under a ``phase`` label so callers can quote
        steady-state percentiles that exclude warm-up::

            svc.set_phase("steady")
            ...
            p50 = svc.latency_pct(50, phase="steady")
        """
        self._phase = phase

    def latency_pct(self, pct: float, **labels) -> Optional[float]:
        """Latency percentile from the registry histogram (seconds)."""
        return self._h_latency.pct(pct, **labels)

    def _observe_latency(self, latency_s: float) -> None:
        self._h_latency.observe(latency_s)
        if self._phase is not None:
            self._h_latency.observe(latency_s, phase=self._phase)

    def stats(self) -> ServiceStats:
        """A point-in-time snapshot of the service counters, read from
        the metrics registry."""
        return ServiceStats(
            submitted=int(self._c_submitted.total()),
            completed=int(self._c_completed.total()),
            failed=int(self._c_failed.total()),
            cache_hits=int(self._c_cache_hits.total()),
            fallbacks=int(self._c_fallbacks.total()),
            buckets=int(self._c_buckets.total()),
            flushed_full=int(self._c_flushes.value(cause="full")),
            flushed_deadline=int(
                self._c_flushes.value(cause="deadline")),
            phantom_rows=int(self._c_phantom.total()),
            latency_p50_s=self._h_latency.pct(50),
            latency_p99_s=self._h_latency.pct(99))

    # ------------------------------------------------------------- feeder
    def submit(self, scenario: Scenario) -> ServeTicket:
        """Enqueue one scenario; returns immediately with a ticket.

        A content-identical scenario answered before (and cacheable:
        registry policy, no instances) resolves on the spot from the
        result cache with ``backend="cache"``.
        """
        if self._closed:
            raise RuntimeError("service is closed")
        ticket = ServeTicket(scenario)
        t0 = time.perf_counter()
        key = scenario_cache_key(scenario, self._texts) \
            if self.result_cache else None
        if key is not None:
            with self._lock:
                hit = self._cache.get(key)
            if hit is not None:
                self._c_submitted.inc()
                self._c_completed.inc()
                self._c_cache_hits.inc()
                latency = time.perf_counter() - t0
                self._observe_latency(latency)
                if obs_trace.enabled():
                    obs_trace.instant("cache-hit", cat="serve",
                                      track="service",
                                      args={"scenario": scenario.name})
                ticket._resolve(ServeRecord(
                    scenario=scenario, result=hit, backend="cache",
                    cached=True, latency_s=latency))
                return ticket
        self._c_submitted.inc()
        with self._lock:
            self._outstanding += 1
        aid = None
        if obs_trace.enabled():
            aid = f"req{next(self._req_seq)}"
            obs_trace.async_begin("request", aid, cat="serve",
                                  track="service",
                                  args={"scenario": scenario.name})
        self._inbox.put(_Request(scenario=scenario, ticket=ticket,
                                 submit_t=t0, cache_key=key, aid=aid))
        return ticket

    def submit_many(self, scenarios: Sequence[Scenario]
                    ) -> List[ServeTicket]:
        """Submit a batch of scenarios back to back."""
        return [self.submit(s) for s in scenarios]

    # ---------------------------------------------------------- scheduler
    def _service_key(self, backend: str, s: Scenario) -> tuple:
        """The open-bucket identity: the engine's :func:`bucket_key`
        extended with the power-of-two *minor* dims and the schedule
        column count, so the dispatched shapes are a pure function of
        the key."""
        base = bucket_key(backend, s, self._dims_cache)
        minor = tuple(next_pow2(d)
                      for d in scenario_dims(s, self._dims_cache)[2:])
        sched = next_pow2(len(s.bound_schedule)) \
            if s.bound_schedule else 0
        return base + (minor, sched)

    def _align(self, backend: str) -> int:
        if backend != "torch":
            return 1
        if self._torch_align is None:
            from repro_torch.backends.engine import shard_count

            self._torch_align = shard_count(self.shard_devices, 1 << 30,
                                            self.device)
        return self._torch_align

    def _capacity(self, backend: str, pad_dims: tuple) -> int:
        # the torch engine runs float32, the vector backend float64
        itemsize = 4 if backend == "torch" else 8
        planned = plan_chunk_rows(
            estimate_row_bytes(pad_dims, itemsize),
            int(self.memory_budget_mb * 2 ** 20), self._align(backend))
        return max(1, min(self.bucket_rows, planned))

    def _open_bucket(self, key: tuple, backend: str,
                     s: Scenario, now: float) -> _OpenBucket:
        (n, j), minor, sched_cols = key[-3], key[-2], key[-1]
        pad_dims = (n, j) + minor
        return _OpenBucket(key=key, backend=backend, pad_dims=pad_dims,
                           sched_cols=sched_cols,
                           cap=self._capacity(backend, pad_dims),
                           deadline=now + self.flush_deadline_s)

    def _scheduler_loop(self) -> None:
        buckets: Dict[tuple, _OpenBucket] = {}

        def flush(bucket: _OpenBucket, cause: str) -> None:
            del buckets[bucket.key]
            n, j = bucket.pad_dims[:2]
            label = (f"serve:{bucket.backend}#{next(self._bucket_seq)}"
                     f":padded(N{n},J{j})")
            self._c_buckets.inc()
            self._c_flushes.inc(cause=cause)
            if obs_trace.enabled():
                obs_trace.instant("flush", cat="serve", track="service",
                                  args={"cause": cause, "label": label,
                                        "rows": len(bucket.requests)})
            self._dispatch_q.put(_Flush(bucket=bucket, cause=cause,
                                        label=label))

        def flush_all() -> None:
            for b in list(buckets.values()):
                flush(b, "deadline")

        def admit(req: _Request) -> None:
            backend, req.reason = plan_backend(
                req.scenario, self.executor, self.max_lanes)
            if backend not in ("torch", "vector"):
                self._spawn_fallback(req, req.reason)
                return
            key = self._service_key(backend, req.scenario)
            bucket = buckets.get(key)
            if bucket is None:
                bucket = self._open_bucket(key, backend, req.scenario,
                                           time.perf_counter())
                buckets[key] = bucket
                if obs_trace.enabled():
                    obs_trace.instant(
                        "bucket-open", cat="serve", track="service",
                        args={"backend": backend, "cap": bucket.cap})
            bucket.requests.append(req)
            if len(bucket.requests) >= bucket.cap:
                flush(bucket, "full")

        while True:
            timeout = None
            if buckets:
                now = time.perf_counter()
                timeout = max(0.0, min(b.deadline
                                       for b in buckets.values()) - now)
            try:
                item = self._inbox.get(timeout=timeout)
            except queue.Empty:
                item = None
            if item is _Close:
                # a submit() racing close() may have enqueued behind
                # the sentinel — drain so no ticket is orphaned
                while True:
                    try:
                        late = self._inbox.get_nowait()
                    except queue.Empty:
                        break
                    if isinstance(late, _Request):
                        admit(late)
                flush_all()
                self._dispatch_q.put(_Close)
                return
            if item is _FlushAll:
                flush_all()
                continue
            if item is not None:
                admit(item)
            # deadline sweep (runs on every wake-up, item or timeout)
            now = time.perf_counter()
            for b in [b for b in buckets.values() if b.deadline <= now]:
                flush(b, "deadline")

    # --------------------------------------------------------- dispatcher
    def _padded_requests(self, flush: _Flush
                         ) -> Tuple[List[Scenario], int]:
        """The flush's scenarios grown to the bucket's fixed capacity:
        phantom replicas of the last request keep the torch batch shape
        a pure function of the bucket key (results are trimmed before
        resolution), and the last row's bound schedule is padded with
        inert ``BIG_EVENT_TIME`` entries so the schedule column count
        is fixed too.  Vector buckets skip row padding."""
        bucket = flush.bucket
        scens = [r.scenario for r in bucket.requests]
        pad = 0
        if bucket.backend == "torch":
            pad = bucket.cap - len(scens)
            scens = scens + [scens[-1]] * pad
        if bucket.sched_cols:
            last = scens[-1]
            sched = list(last.bound_schedule)
            sched += [(BIG_EVENT_TIME, sched[-1][1])] \
                * (bucket.sched_cols - len(sched))
            scens[-1] = dataclasses.replace(
                last, bound_schedule=tuple(sched))
        return scens, pad

    def _dispatch_loop(self) -> None:
        while True:
            item = self._dispatch_q.get()
            if item is _Close:
                self._fetch_q.put(_Close)
                return
            flush: _Flush = item
            bucket = flush.bucket
            live: List[_Request] = []
            assignments: List = []
            for req in bucket.requests:
                try:
                    assignments.append(
                        self._assignments.assignment_for(req.scenario))
                    live.append(req)
                except Exception as e:  # noqa: BLE001 — per request
                    self._resolve(req, None,
                                  error=f"{type(e).__name__}: {e}",
                                  backend=bucket.backend,
                                  bucket=flush.label,
                                  flush_cause=flush.cause)
            if not live:
                continue
            bucket.requests = live
            dispatch_t0 = time.perf_counter()
            try:
                scens, pad = self._padded_requests(flush)
                assignments = assignments + [assignments[-1]] * pad
                sim = build_batch_sim(
                    bucket.backend, scens, assignments, False,
                    bucket.pad_dims, vector_dt=self.vector_dt,
                    device=self.device, impl=self.impl,
                    shard_devices=self.shard_devices)
                self._c_phantom.inc(pad)
                if bucket.backend == "torch":
                    pending = sim.dispatch()
                    pending.profile.bucket = flush.label
                    # recorded at dispatch, unconditionally: a failed
                    # fetch must still show up in the profile
                    self.profile.add(pending.profile)
                    if obs_trace.enabled():
                        obs_trace.complete(
                            "serve:dispatch", dispatch_t0,
                            time.perf_counter() - dispatch_t0,
                            cat="serve", track="service",
                            args={"label": flush.label,
                                  "rows": len(live), "phantom": pad})
                    self._fetch_q.put((flush, sim, pending))
                else:
                    results = sim.run()
                    if obs_trace.enabled():
                        obs_trace.complete(
                            "serve:run", dispatch_t0,
                            time.perf_counter() - dispatch_t0,
                            cat="serve", track="service",
                            args={"label": flush.label,
                                  "rows": len(live)})
                    self._resolve_flush(flush, results)
            except Exception as e:  # noqa: BLE001 — captured per bucket
                self._fail_flush(flush, f"{type(e).__name__}: {e}")

    # ---------------------------------------------------------- collector
    def _collect_loop(self) -> None:
        while True:
            item = self._fetch_q.get()
            if item is _Close:
                return
            flush, sim, pending = item
            fetch_t0 = time.perf_counter()
            try:
                # phantom rows are checked with the bucket, not built
                results = sim.fetch(pending, len(flush.bucket.requests))
                if obs_trace.enabled():
                    obs_trace.complete(
                        "serve:fetch", fetch_t0,
                        time.perf_counter() - fetch_t0, cat="serve",
                        track="service", args={"label": flush.label})
                self._resolve_flush(flush, results)
            except Exception as e:  # noqa: BLE001 — captured per bucket
                self._fail_flush(flush, f"{type(e).__name__}: {e}")

    # ---------------------------------------------------------- resolution
    def _resolve(self, req: _Request, result: Optional[SimResult], *,
                 error: Optional[str] = None, backend: str = "event",
                 bucket: Optional[str] = None,
                 fallback_reason: Optional[str] = None,
                 flush_cause: Optional[str] = None) -> None:
        record = ServeRecord(
            scenario=req.scenario, result=result, error=error,
            backend=backend, bucket=bucket,
            fallback_reason=fallback_reason, flush_cause=flush_cause,
            latency_s=time.perf_counter() - req.submit_t)
        self._c_completed.inc()
        if error is not None:
            self._c_failed.inc()
        self._observe_latency(record.latency_s)
        if req.aid is not None:
            obs_trace.async_end("request", req.aid, cat="serve",
                                track="service",
                                args={"backend": backend,
                                      "cause": flush_cause,
                                      "ok": error is None})
        with self._idle:
            if error is None and req.cache_key is not None:
                self._cache[req.cache_key] = result
            self._outstanding -= 1
            if self._outstanding == 0:
                self._idle.notify_all()
        req.ticket._resolve(record)

    def _resolve_flush(self, flush: _Flush,
                       results: List[SimResult]) -> None:
        # a vector row of a torch service carries why it left the torch
        # engine, as the offline engine's record does
        for req, result in zip(flush.bucket.requests, results):
            self._resolve(req, result, backend=flush.bucket.backend,
                          bucket=flush.label, flush_cause=flush.cause,
                          fallback_reason=req.reason)

    def _fail_flush(self, flush: _Flush, err: str) -> None:
        for req in flush.bucket.requests:
            self._resolve(req, None, error=err,
                          backend=flush.bucket.backend,
                          bucket=flush.label, flush_cause=flush.cause,
                          fallback_reason=req.reason)

    # ----------------------------------------------------------- fallback
    def _spawn_fallback(self, req: _Request,
                        reason: Optional[str]) -> None:
        self._c_fallbacks.inc()
        if obs_trace.enabled():
            obs_trace.instant("fallback", cat="serve", track="service",
                              args={"scenario": req.scenario.name,
                                    "reason": reason})

        def run() -> None:
            try:
                assignment = self._assignments.assignment_for(
                    req.scenario)
                result = _run_scenario(req.scenario, assignment)
                self._resolve(req, result, backend="event",
                              fallback_reason=reason)
            except Exception as e:  # noqa: BLE001 — captured per request
                self._resolve(req, None,
                              error=f"{type(e).__name__}: {e}",
                              backend="event", fallback_reason=reason)

        self._fallback_pool.submit(run)
