"""The kernel library is built once a process, whichever threads ask
first, and exactly one caller is told it paid for the build.  Runs on the
CPU: the nvcc lookup, each source's compile, the link and the load are
replaced by fakes that record how often they ran."""

import sys
import threading

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def fake_toolchain(monkeypatch, tmp_path):
    calls = {"compile": 0, "link": 0, "open": 0}
    lock = threading.Lock()
    gate = threading.Event()

    def compile_(nvcc, name, obj):
        gate.wait(timeout=30)            # hold every building thread inside
        with lock:
            calls["compile"] += 1
        obj.write_bytes(b"obj")
        return f"{name}: ok\n", 0, 0.01

    def link(nvcc, objs, out):
        with lock:
            calls["link"] += 1
        out.write_bytes(b"lib")
        return "", 0

    def open_(path):
        with lock:
            calls["open"] += 1
        return object()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build, "_link", link)
    monkeypatch.setattr(_build, "_open", open_)
    monkeypatch.setattr(_build, "_LIBRARY", None)
    monkeypatch.setattr(_build, "_CLAIMED", False)
    return calls, gate


def test_concurrent_first_calls_build_once(fake_toolchain):
    calls, gate = fake_toolchain
    n = 8
    start = threading.Barrier(n)
    got, claims = [None] * n, [None] * n

    def first_call(i):
        start.wait(timeout=30)
        unbuilt = not _build.library_loaded()
        got[i] = _build.load_library()
        claims[i] = _build.claim_build() if unbuilt else 0.0

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_call, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"compile": len(_build._SOURCES), "link": 1, "open": 1}
    assert all(lib is got[0] for lib in got)
    assert got[0].build_s > 0 and got[0].source_s
    assert sum(c > 0 for c in claims) == 1        # one caller paid
    assert _build.claim_build() == 0.0             # and only once
    assert _build.load_library() is got[0]         # no second build
    assert calls["compile"] == len(_build._SOURCES)


def test_a_built_library_is_loaded_not_claimed(fake_toolchain):
    """A library found on disk is opened without nvcc, and no dispatch
    is told it built the kernels."""
    calls, gate = fake_toolchain
    gate.set()
    path = _build.BUILD_DIR / f"libreprotorch-{_build._digest()}.so"
    path.write_bytes(b"lib")
    lib = _build.load_library()
    assert lib.build_s == 0.0 and lib.path == path
    assert calls == {"compile": 0, "link": 0, "open": 1}
    assert _build.claim_build() == 0.0


def test_failed_compile_raises_and_leaves_nothing_loaded(fake_toolchain,
                                                         monkeypatch):
    _, gate = fake_toolchain
    gate.set()
    monkeypatch.setattr(_build, "_compile",
                        lambda nvcc, name, obj: ("error: x", 1, 0.01))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load_library()
    assert not _build.library_loaded()
