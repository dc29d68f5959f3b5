"""Pack/dispatch/run/transfer profiling for the torch sweep executor.

The port's copy of the reference's ``repro.backends.jax.profile``, with
the same field names so that :meth:`BucketProfile.to_dict` payloads read
the same.  Every bucket a torch sweep dispatches gets one
:class:`BucketProfile` with the phases of its life separated out:

* **pack** — host-side packing: ``stack_graph_arrays`` / LUT stacking /
  bound-schedule padding, the policy's state and the upload of it all
  (from pinned host memory, so it does not wait for the kernel of the
  bucket before it);
* **compile** — on this backend, the one-time ``nvcc`` build of the
  kernel library (:func:`repro_torch.kernels._build.load_library`):
  ``compiled`` is true only for the dispatch that triggered the build,
  and ``compile_s`` is that build's wall time;
* **dispatch** — the launch itself: one ``wave_run`` launch on the
  ``"cuda"`` path, returning at once; the whole lockstep loop on the
  ``"step"`` and ``"plain"`` paths, which sync with the host as they go;
* **run** — time spent blocking until the device results are ready
  (under the pipeline, the device time not hidden behind host work);
* **transfer** — the one device-to-host copy of the state fields;
* **results** — building the ``SimResult`` rows from the fetched
  arrays (host only).

``kernel_ms`` is the ``wave_run`` launch's device time from CUDA events
(``"cuda"`` path only) and ``path`` the engine path the bucket ran on.
:class:`SweepProfile` aggregates the buckets of one sweep and renders
the one-line summary that ``SweepResult.backend_summary()`` appends.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class BucketProfile:
    """One dispatched bucket's accounting (times in seconds)."""

    bucket: str = "?"                #: sweep bucket label
    rows: int = 0                    #: batch rows
    devices: int = 1                 #: cards the batch ran on
    #: dispatch identity: (padded envelope dims, engine path, policy).
    cache_key: Optional[Tuple] = None
    compiled: bool = False           #: did this dispatch build the kernels?
    pack_s: float = 0.0
    dispatch_s: float = 0.0
    compile_s: float = 0.0
    run_s: float = 0.0
    transfer_s: float = 0.0
    results_s: float = 0.0
    kernel_ms: Optional[float] = None
    path: str = "?"                  #: engine path ("cuda"/"step"/"plain")

    def to_dict(self) -> Dict[str, object]:
        """Flat JSON-ready payload."""
        return {
            "bucket": self.bucket, "rows": self.rows,
            "devices": self.devices, "compiled": self.compiled,
            "cache_key": (None if self.cache_key is None
                          else [str(k) for k in self.cache_key]),
            "pack_s": self.pack_s, "dispatch_s": self.dispatch_s,
            "compile_s": self.compile_s, "run_s": self.run_s,
            "transfer_s": self.transfer_s, "results_s": self.results_s,
            "kernel_ms": self.kernel_ms, "path": self.path,
        }


@dataclass
class SweepProfile:
    """All bucket profiles of one batched sweep."""

    buckets: List[BucketProfile] = field(default_factory=list)

    def add(self, bucket: BucketProfile) -> None:
        """Append one bucket's profile."""
        self.buckets.append(bucket)

    @property
    def compiles(self) -> int:
        """Dispatches that built the kernel library."""
        return sum(1 for b in self.buckets if b.compiled)

    @property
    def cache_hits(self) -> int:
        """Dispatches that found the library built."""
        return sum(1 for b in self.buckets if not b.compiled)

    @property
    def recompiles(self) -> int:
        """Builds in steady state: dispatches that built the kernels for
        a cache key this profile had *already* dispatched earlier.  The
        library is built at most once a process, so a long-lived
        service's smoke run asserts this is zero."""
        seen: set = set()
        n = 0
        for b in self.buckets:
            if b.compiled and b.cache_key in seen:
                n += 1
            seen.add(b.cache_key)
        return n

    def compiles_after(self, warmup_buckets: int) -> int:
        """Dispatches beyond the first ``warmup_buckets`` that still
        built the kernels — the service's "no kernel build after
        warm-up" acceptance gate."""
        return sum(1 for b in self.buckets[warmup_buckets:]
                   if b.compiled)

    def total(self, phase: str) -> float:
        """Sum one phase (``pack``/``dispatch``/``compile``/``run``/
        ``transfer``/``results``) over every bucket, in seconds."""
        return sum(getattr(b, f"{phase}_s") for b in self.buckets)

    def summary(self) -> str:
        """The ``backend_summary()`` suffix: kernel builds plus the
        wall-clock split."""
        return (f"build: {self.compiles} built, {self.cache_hits} cached"
                f" | t: pack={self.total('pack'):.3f}s"
                f" compile={self.total('compile'):.3f}s"
                f" run={self.total('run'):.3f}s"
                f" transfer={self.total('transfer'):.3f}s"
                f" results={self.total('results'):.3f}s")

    def to_dict(self) -> Dict[str, object]:
        """JSON-ready payload."""
        return {
            "compiles": self.compiles, "cache_hits": self.cache_hits,
            "pack_s": self.total("pack"),
            "compile_s": self.total("compile"),
            "run_s": self.total("run"),
            "transfer_s": self.total("transfer"),
            "results_s": self.total("results"),
            "buckets": [b.to_dict() for b in self.buckets],
        }
