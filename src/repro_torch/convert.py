"""Carry the reference package's objects across to the port.

This system has no model weights: its "parameters" are the scenario
geometry and the policy state.  :func:`from_reference` takes the JAX
package's numpy-side objects — recognised by their field names, never
imported — and returns the port's counterpart:

* a job graph or a cluster (``NodeSpec`` list) -> the port's graph and
  specs, job for job and LUT state for LUT state;
* a ``LUTTable``, ``GraphArrays`` or ``BatchArrays`` -> the port's numpy
  record of the same arrays;
* a ``PowerAssignment`` -> the port's assignment;
* ``step_tables(...)`` output -> :class:`StepTables` tensors on
  ``device`` (the reference's stacked ``(B, 1, N)`` lane leaves become
  the port's ``(B, N)``);
* a policy ``init_state(...)`` dict -> tensors on ``device`` (floats as
  float32, the engine's type).

The tests use it so that both engines run literally the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.arrays import BatchArrays, GraphArrays
from repro_torch.core.graph import Job, JobDependencyGraph
from repro_torch.core.ilp import PowerAssignment
from repro_torch.core.power import LUTTable, NodeSpec, PowerLUT, PowerState
from repro_torch.kernels.power_step import StepTables

_LUT_FIELDS = ("state_p", "state_f", "idle_w", "p_min", "p_max", "f_min",
               "f_nom", "span", "speed", "cap_floor")


def _has(obj, *names) -> bool:
    return all(hasattr(obj, n) for n in names)


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    t = torch.as_tensor(arr, device=device)
    if arr.dtype.kind == "f":
        t = t.to(torch.float32)
    elif arr.dtype.kind in "iu":
        t = t.to(torch.int64)
    return t.contiguous()


def _states(states):
    return tuple(PowerState(float(s.freq_mhz), float(s.power_w))
                 for s in states)


def from_reference(obj, device="cpu"):
    """The port's counterpart of one reference object (see module doc)."""
    if isinstance(obj, dict):
        return {k: _tensor(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(from_reference(o, device) for o in obj)
    if _has(obj, "jobs", "node_jobs"):
        return JobDependencyGraph(
            Job(node=j.node, index=j.index, work=j.work,
                cpu_frac=j.cpu_frac, deps=tuple(tuple(d) for d in j.deps),
                tag=j.tag)
            for j in obj.jobs.values())
    if _has(obj, "lut", "speed"):
        lut = obj.lut
        return NodeSpec(PowerLUT(
            name=lut.name, states=_states(lut.states),
            idle_w=float(lut.idle_w), cores=int(lut.cores),
            multicore={int(m): _states(s)
                       for m, s in lut.multicore.items()}),
            speed=float(obj.speed))
    if _has(obj, "bounds_w", "objective_t"):
        return PowerAssignment(
            bounds_w=dict(obj.bounds_w), freqs_mhz=dict(obj.freqs_mhz),
            times=dict(obj.times), objective_t=float(obj.objective_t),
            status=str(obj.status))
    if _has(obj, "row_job_ids", "node_seq"):
        return BatchArrays(
            row_job_ids=tuple(tuple(r) for r in obj.row_job_ids),
            n_jobs_row=np.array(obj.n_jobs_row),
            n_active=np.array(obj.n_active),
            work_pad=np.array(obj.work_pad), rho_pad=np.array(obj.rho_pad),
            node_seq=np.array(obj.node_seq), deps_pad=np.array(obj.deps_pad),
            table=from_reference(obj.table))
    if _has(obj, "job_ids", "node_seq"):
        return GraphArrays(
            job_ids=tuple(obj.job_ids), work_pad=np.array(obj.work_pad),
            rho_pad=np.array(obj.rho_pad), node_seq=np.array(obj.node_seq),
            deps_pad=np.array(obj.deps_pad),
            table=from_reference(obj.table))
    if _has(obj, *_LUT_FIELDS):
        return LUTTable(**{k: np.array(getattr(obj, k))
                           for k in _LUT_FIELDS})
    if _has(obj, "state_p", "state_f", "cap_floor"):
        leaves = [_tensor(getattr(obj, f), device)
                  for f in StepTables._fields]
        state_p, state_f, *lanes = leaves
        if state_p.dim() == 3:               # stacked: (B, 1, N) -> (B, N)
            lanes = [t.reshape(t.shape[0], -1) for t in lanes]
        return StepTables(state_p, state_f, *lanes)
    raise TypeError(f"no port counterpart for {type(obj).__name__}")
