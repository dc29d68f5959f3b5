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

For the LM path, :func:`params_from_reference` takes a dense model's
parameter pytree (``init_params``: stacked ``blocks`` leaves ``(L, ...)``)
and returns the port's :class:`~repro_torch.models.model.DenseLM`, one
block per layer, in ``cfg.param_dtype``; :func:`cache_from_reference`
takes a decode cache.  A bf16 leaf (an ``ml_dtypes`` array that
``torch.as_tensor`` rejects) goes through float32, which is lossless.

The tests use it so that both packages run literally the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.arrays import BatchArrays, GraphArrays
from repro_torch.core.graph import Job, JobDependencyGraph
from repro_torch.core.ilp import PowerAssignment
from repro_torch.core.power import LUTTable, NodeSpec, PowerLUT, PowerState
from repro_torch.kernels.power_step import StepTables
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, dtype_of
from repro_torch.models.model import Block, DenseLM, require_dense

_LUT_FIELDS = ("state_p", "state_f", "idle_w", "p_min", "p_max", "f_min",
               "f_nom", "span", "speed", "cap_floor")


def _has(obj, *names) -> bool:
    return all(hasattr(obj, n) for n in names)


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
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


# ------------------------------------------------------------------- LM
def _leaf(a, dtype: torch.dtype, device) -> torch.Tensor:
    """One float array in ``dtype`` on ``device``, through a float32 copy
    (lossless for the bf16 and fp32 leaves of the reference)."""
    arr = np.array(a, dtype=np.float32)
    return torch.as_tensor(arr, device=device).to(dtype).contiguous()


def attention_from_reference(p, dtype, device="cpu") -> Attention:
    """One attention layer's ``attn_init`` dict -> :class:`Attention`."""
    t = {k: _leaf(v, dtype, device) for k, v in p.items()}
    return Attention(t["wq"], t["wk"], t["wv"], t["wo"], t.get("bq"),
                     t.get("bk"), t.get("bv"))


def mlp_from_reference(p, dtype, device="cpu") -> MLP:
    t = {k: _leaf(v, dtype, device) for k, v in p.items()}
    return MLP(t["wi"], t["wo"], t.get("wg"))


def params_from_reference(cfg, params, device="cpu") -> DenseLM:
    """A dense model's JAX parameter pytree -> :class:`DenseLM` in
    ``cfg.param_dtype`` on ``device``, the stacked layers unstacked."""
    require_dense(cfg)
    dt = dtype_of(cfg.param_dtype)
    stacked = params["blocks"]

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else np.asarray(v)[i]
                for k, v in tree.items()}

    blocks = []
    for i in range(cfg.n_layers):
        p = layer(stacked, i)
        blocks.append(Block(_leaf(p["ln1"], dt, device),
                            _leaf(p["ln2"], dt, device),
                            attention_from_reference(p["attn"], dt, device),
                            mlp_from_reference(p["ffn"], dt, device)))
    head = params.get("lm_head")
    return DenseLM(_leaf(params["embed"], dt, device), blocks,
                   _leaf(params["final_norm"], dt, device),
                   None if head is None else _leaf(head, dt, device))


def cache_from_reference(cache, device="cpu"):
    """A decode cache pytree -> dict of tensors, each leaf in its own
    type (a bf16 leaf stays bf16)."""
    return {k: _leaf(v, getattr(torch, np.asarray(v).dtype.name), device)
            for k, v in cache.items()}
