"""Trace corpora: a directory of recordings as a sweepable workload set.

A :class:`TraceCorpus` loads every ``*.jsonl`` trace under a directory,
reconstructs each into a simulator-ready workload, and exposes the set
as :class:`~repro_torch.core.scenarios.FamilyMember`\\ s /
a :class:`~repro_torch.core.scenarios.ScenarioFamily` — from there the whole
batched stack applies unchanged: the sweep engine buckets the mixed
shapes into padded vector/torch batches exactly as it does for
synthetic families.  The ``sweep`` subcommand of ``python -m
repro_torch.traces`` and the serve CLI's ``--trace-corpus`` mode are thin
wrappers over this class.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

from repro_torch.core.power import NodeSpec
from repro_torch.core.scenarios import (DEFAULT_POLICIES, FamilyMember,
                                        ScenarioFamily)

from .reconstruct import ReconstructedGraph, reconstruct
from .replay import REPLAY_RTOL, ReplayReport, replay_report
from .schema import Trace, TraceError, load_trace

#: File patterns a corpus directory is scanned for.
TRACE_GLOB = "*.jsonl"


@dataclass
class CorpusEntry:
    """One trace of a corpus: its file, recording, and reconstruction."""

    name: str
    path: Optional[pathlib.Path]
    recon: ReconstructedGraph

    @property
    def trace(self) -> Trace:
        return self.recon.trace


class TraceCorpus:
    """A set of reconstructed traces, ready for family sweeps."""

    def __init__(self, entries: Sequence[CorpusEntry]):
        if not entries:
            raise TraceError("empty trace corpus")
        self.entries = list(entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)

    @property
    def names(self) -> List[str]:
        return [e.name for e in self.entries]

    @classmethod
    def from_dir(cls, path: Union[str, pathlib.Path],
                 strict: bool = True,
                 specs: Optional[Sequence[NodeSpec]] = None
                 ) -> "TraceCorpus":
        """Load every ``*.jsonl`` trace under ``path`` (sorted by name).

        ``strict`` gates both schema validation and reconstruction
        matching (see :func:`repro_torch.traces.reconstruct.reconstruct`);
        ``specs`` overrides the header cluster of *every* trace (only
        sensible for single-cluster corpora).
        """
        root = pathlib.Path(path)
        if not root.is_dir():
            raise TraceError(f"corpus directory {root} does not exist")
        files = sorted(root.glob(TRACE_GLOB))
        if not files:
            raise TraceError(f"no {TRACE_GLOB} traces under {root}")
        entries = []
        for f in files:
            trace = load_trace(f, strict=strict)
            recon = reconstruct(trace, specs=specs, strict=strict,
                                validate=False)   # load_trace validated
            entries.append(CorpusEntry(name=f.stem, path=f, recon=recon))
        return cls(entries)

    @classmethod
    def from_traces(cls, traces: Sequence[Trace], strict: bool = True
                    ) -> "TraceCorpus":
        """An in-memory corpus (benchmarks record straight into one).

        Entries are named after their recorded workload; repeats get a
        positional suffix so member names — and therefore
        ``SweepResult`` lookups — stay unambiguous.
        """
        seen: dict = {}
        entries = []
        for i, t in enumerate(traces):
            base = str(t.meta.get("workload", f"t{i}"))
            seen[base] = seen.get(base, 0) + 1
            name = base if seen[base] == 1 else f"{base}-{seen[base]}"
            entries.append(CorpusEntry(name=name, path=None,
                                       recon=reconstruct(t,
                                                         strict=strict)))
        return cls(entries)

    # ------------------------------------------------------------- sweeps
    def members(self) -> List[FamilyMember]:
        """One :class:`FamilyMember` per trace, tagged with provenance."""
        return [FamilyMember(
            name=e.name, graph=e.recon.graph,
            specs=tuple(e.recon.specs),
            tags={"kind": "trace", "trace": e.name,
                  "ranks": e.trace.ranks}) for e in self.entries]

    def family(self, name: str = "traces",
               bound_fracs: Sequence[float] = (0.15, 0.4, 0.8),
               policies: Sequence = DEFAULT_POLICIES,
               latency_s: float = 0.05) -> ScenarioFamily:
        """The corpus as a :class:`ScenarioFamily` — feed it to any
        ``SweepEngine`` executor; the batched ones bucket the mixed
        trace shapes like any other family."""
        return ScenarioFamily(name, self.members(),
                              bound_fracs=bound_fracs,
                              policies=policies, latency_s=latency_s)

    # ---------------------------------------------------------- validation
    def validate(self, tol: float = REPLAY_RTOL) -> List[ReplayReport]:
        """Replay-validate every entry (see
        :mod:`repro_torch.traces.replay`)."""
        return [replay_report(e.recon, tol=tol) for e in self.entries]
