"""The port's metrics registry and tracer against the reference's
``repro.obs``: the same sequence of calls gives the same snapshot, and
the same events (timestamps aside)."""

import doctest
import json
import threading

import pytest

from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace

from repro_torch.obs import metrics, trace


def _drive(mod, reservoir):
    """One fixed sequence of counter, gauge and histogram calls."""
    reg = mod.MetricsRegistry()
    flushes = reg.counter("flushes")
    flushes.inc(cause="full")
    flushes.inc(2.5, cause="deadline")
    flushes.inc()
    assert reg.counter("flushes") is flushes       # get-or-create
    depth = reg.gauge("queue_depth")
    depth.set(4, stage="dispatch")
    depth.add(-1.5, stage="dispatch")
    depth.add(3)
    lat = reg.histogram("latency_s", reservoir=reservoir)
    # past the reservoir: the seeded sampling decides which stay
    for k in range(5 * reservoir + 3):
        lat.observe(((k * 37) % 101) / 100.0)
        lat.observe(k / 7.0, phase="steady", rows=k % 3)
    lat.observe(0.5, phase="warm")
    reg.histogram("empty")
    return reg, flushes, depth, lat


@pytest.mark.parametrize("reservoir", [4, 64, metrics.DEFAULT_RESERVOIR])
def test_snapshot_equals_the_references(reservoir):
    got, c, g, h = _drive(metrics, reservoir)
    want, rc, rg, rh = _drive(ref_metrics, reservoir)
    assert json.dumps(got.snapshot(), sort_keys=True) == \
        json.dumps(want.snapshot(), sort_keys=True)
    assert c.value(cause="full") == rc.value(cause="full") == 1.0
    assert c.total() == rc.total() == 4.5
    assert g.value(stage="dispatch") == rg.value(stage="dispatch") == 2.5
    for labels in ({}, {"phase": "steady", "rows": 1}, {"phase": "warm"},
                   {"phase": "none"}):
        assert h.count(**labels) == rh.count(**labels)
        for p in (0, 50, 99, 100):
            assert h.pct(p, **labels) == rh.pct(p, **labels)


def test_one_name_one_kind():
    reg = metrics.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError, match="already registered as Counter"):
        reg.gauge("x")
    assert metrics.default_registry() is metrics.default_registry()
    assert metrics.default_registry() is not ref_metrics.default_registry()


def test_counter_is_thread_safe():
    """Eight threads of 2,000 increments each lose no update."""
    import sys

    reg = metrics.MetricsRegistry()
    c = reg.counter("hits")
    h = reg.histogram("lat", reservoir=16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                c.inc(phase="a")
                h.observe(1.0)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert c.value(phase="a") == 16000 and h.count() == 16000


def _calls(mod):
    """The tracer calls the service makes, plus the span kinds."""
    t = mod.Tracer()
    assert bool(t) and len(t) == 0            # truthy while empty
    t.counter("power", {"n0": 3, "n1": 4.5}, cat="power", track="power:l2")
    t.counter("power", {"n0": 2}, track="power:l2", ts=1.25)
    t.async_begin("request", "req0", cat="serve", track="service",
                  args={"scenario": "l2"})
    t.instant("flush", cat="serve", track="service", lane="sched",
              args={"cause": "full"})
    t.async_end("request", "req0", cat="serve", track="service",
                args={"backend": "torch", "ok": True})
    t.complete("serve:dispatch", 0.0, 0.25, cat="serve", track="service",
               lane="dispatch", args={"rows": 8})
    with t.span("plan", cat="sweep", track="engine", lane="main"):
        pass
    return t


def _without_time(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def test_tracer_events_equal_the_references():
    got, want = _calls(trace), _calls(ref_trace)
    assert _without_time(got.events()) == _without_time(want.events())
    assert got.track_ids() == want.track_ids() == {
        "power:l2": 1, "service": 2, "engine": 3}
    assert len(got) == len(want) == len(got.events())
    # explicit simulated-time stamps are the same microseconds
    assert [e["ts"] for e in got.events() if e["ph"] == "C"][1] == 1.25e6
    # Chrome JSON for the same calls, timestamps aside
    strip = lambda tr: _without_time(json.loads(tr.to_json()))  # noqa: E731
    assert strip(got) == strip(want)


def test_module_level_helpers_and_disabled_path():
    assert trace.get() is None
    # disabled: every helper is a no-op
    trace.counter("c", {"a": 1})
    trace.async_begin("r", "1")
    trace.async_end("r", "1")
    t = trace.install(trace.Tracer())
    try:
        trace.counter("c", {"a": 1}, track="x")
        trace.async_begin("r", "1", track="x")
        trace.async_end("r", "1", track="x")
    finally:
        assert trace.uninstall() is t
    assert [e["ph"] for e in t.events() if e["ph"] != "M"] == \
        ["C", "b", "e"]
    assert [e["id"] for e in t.events() if e["ph"] in "be"] == ["1", "1"]


def test_metrics_doctest():
    """The module docstring's example runs (the tracer's runs in
    ``test_torch_sweep_exec.py``)."""
    result = doctest.testmod(metrics, optionflags=doctest.ELLIPSIS
                             | doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0
