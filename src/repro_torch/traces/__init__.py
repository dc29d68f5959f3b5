"""MPI trace ingestion, calibration, and replay (paper §VII-A1).

The port's own copy of the reference's ``repro.traces``: the same JSONL
format (a file either package writes, the other loads), the same
recorders (the same seed gives the same bytes), and the same
reconstruction, on the port's numpy core.

The paper's pipeline starts from *recorded* executions: a wrapper
library logs timestamped compute segments and communication ops per
rank, and the dependency graph of §IV is reconstructed from those logs.
This package is that frontend:

  schema       versioned JSONL trace format + strict loader/validator
  calibrate    observed duration at a logged DVFS state -> work units
               (through the power LUTs of repro_torch.core.power)
  record       synthetic recorders over the workload zoo + noise models
               (the ground-truth side of the round-trip oracle)
  reconstruct  sends↔recvs / collective matching -> JobDependencyGraph
               (shares TraceBuilder's dependency-attachment convention)
  replay       re-execute a reconstruction and check it against the
               trace's wall clock
  corpus       a directory of traces as a ScenarioFamily for the
               batched sweep engine
  cli          ``python -m repro_torch.traces`` (record/validate/convert/sweep;
               ``sweep`` runs on the card by default)

See ``docs/traces.md`` for the schema reference and guarantees.
"""

from .calibrate import LUT_REGISTRY, span_work, specs_for, state_freq
from .corpus import CorpusEntry, TraceCorpus
from .record import (FREQ_PLANS, record_builder, record_graph,
                     record_workload, with_noise)
from .reconstruct import (CAUSAL_SLACK_S, ReconstructedGraph,
                          ReconstructionReport, canonical_form,
                          graphs_match, reconstruct)
from .replay import (NOISY_REPLAY_RTOL, REPLAY_RTOL, ReplayReport,
                     replay_makespan, replay_report)
from .schema import (COLLECTIVE_KINDS, OP_KINDS, P2P_KINDS, TRACE_VERSION,
                     OpRecord, RankInfo, SpanRecord, Trace, TraceError,
                     dump_trace, dumps_trace, load_trace, loads_trace)

__all__ = [k for k in dir() if not k.startswith("_")]
