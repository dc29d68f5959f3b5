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
* a differentiable layer's ``SoftArrays`` (numpy leaves and a
  ``LUTTable``) -> the port's :class:`~repro_torch.diff.softsim.SoftArrays`
  on ``device`` (float64 and int64 tensors), and an ``OptResult`` -> the
  port's :class:`~repro_torch.diff.optimize.OptResult`;
* ``step_tables(...)`` output -> :class:`StepTables` tensors on
  ``device`` (the reference's stacked ``(B, 1, N)`` lane leaves become
  the port's ``(B, N)``);
* a policy ``init_state(...)`` dict -> tensors on ``device`` (floats as
  float32, the engine's type).

For the LM path, :func:`params_from_reference` takes a model's parameter
pytree (``init_params``) of any family and returns the port's module in
``cfg.param_dtype``, the stacked leaves unstacked: the ``blocks`` leaves
``(L, ...)`` become a :class:`~repro_torch.models.model.DenseLM` (dense,
vlm, moe: each block's ``moe`` dict a
:class:`~repro_torch.models.moe.MoE`) or an
:class:`~repro_torch.models.model.EncoderLM` (``frame_proj`` in place of
the embedding); the hybrid family's ``mamba`` leaves ``(n_super,
per_super, ...)`` and its one ``shared_attn`` block a
:class:`~repro_torch.models.model.HybridLM`; the ssm family's ``mlstm``
``(n_super, per_super, ...)`` and ``slstm`` ``(n_super, ...)`` leaves an
:class:`~repro_torch.models.model.XLSTMLM`.  Leaves the reference keeps
in fp32 whatever the model's type stay fp32: the SSM's ``A_log``, ``D``
and ``dt_bias``, the router, the mLSTM's ``w_if`` and ``b_if``, the
sLSTM's ``r`` and ``b``.  :func:`cache_from_reference` takes a decode
cache of any family.  :func:`opt_state_from_reference` takes an
``init_opt_state`` tree of a model's parameters (fp32, bf16 or int8
``_QTensor`` moments) and returns the port's optimizer state under the
names ``params_from_reference`` gives the parameters.  A bf16 leaf (an
``ml_dtypes`` array that ``torch.as_tensor`` rejects) goes through
float32, which is lossless.

The tests use it so that both packages run literally the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.arrays import BatchArrays, GraphArrays
from repro_torch.core.graph import Job, JobDependencyGraph
from repro_torch.core.ilp import PowerAssignment
from repro_torch.core.power import LUTTable, NodeSpec, PowerLUT, PowerState
from repro_torch.diff.optimize import OptResult
from repro_torch.diff.softsim import soft_arrays_from_numpy
from repro_torch.kernels.power_step import StepTables
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, dtype_of
from repro_torch.models.model import (Block, CellBlock, DenseLM, EncoderLM,
                                      HybridLM, MambaBlock, XLSTMLM,
                                      require_ported, superblock_shape)
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import SSM
from repro_torch.models.xlstm import MLSTM, SLSTM
from repro_torch.optim import QTensor

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
    if _has(obj, "settle_iters", "max_waves", "node_seq"):
        return soft_arrays_from_numpy(
            obj.work_pad, obj.rho_pad, obj.node_seq, obj.deps_pad,
            obj.table, n_jobs=obj.n_jobs, n_nodes=obj.n_nodes,
            max_waves=obj.max_waves, settle_iters=obj.settle_iters,
            device=device)
    if _has(obj, "exact_makespan", "soft_makespan", "history"):
        return OptResult(
            caps=np.array(obj.caps), soft_makespan=float(obj.soft_makespan),
            exact_makespan=float(obj.exact_makespan),
            history=[(int(s), float(t), float(v))
                     for s, t, v in obj.history])
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


def _index(tree, *idx):
    """One layer of a stacked parameter tree (numpy leaves)."""
    return {k: _index(v, *idx) if isinstance(v, dict) else np.asarray(v)[idx]
            for k, v in tree.items()}


def _block(p, dt, device) -> Block:
    ln1, ln2 = _leaf(p["ln1"], dt, device), _leaf(p["ln2"], dt, device)
    attn = attention_from_reference(p["attn"], dt, device)
    if "moe" in p:
        return Block(ln1, ln2, attn, moe=moe_from_reference(p["moe"], dt,
                                                             device))
    return Block(ln1, ln2, attn, mlp_from_reference(p["ffn"], dt, device))


def _leaves(p, dtype, device, fp32=()):
    """Every array leaf of one layer's dict in ``dtype``, those named in
    ``fp32`` in fp32."""
    return {k: _leaf(v, torch.float32 if k in fp32 else dtype, device)
            for k, v in p.items() if not isinstance(v, dict)}


def moe_from_reference(p, dtype, device="cpu") -> MoE:
    """One ``moe_init`` dict -> :class:`~repro_torch.models.moe.MoE` (the
    router in fp32)."""
    t = _leaves(p, dtype, device, ("router",))
    dense = p.get("dense")
    return MoE(t["router"], t["wi"], t["wg"], t["wo"],
               None if dense is None else mlp_from_reference(dense, dtype,
                                                             device))


#: SSM leaves the reference keeps in fp32 whatever the model's type
_SSM_FP32 = ("A_log", "D", "dt_bias")


def ssm_from_reference(p, dtype, device="cpu") -> SSM:
    """One ``ssm_init`` dict -> :class:`~repro_torch.models.ssm.SSM`."""
    t = _leaves(p, dtype, device, _SSM_FP32)
    return SSM(t["in_proj"], t["conv"], t["A_log"], t["D"], t["dt_bias"],
               t["out_proj"], t["norm_z"])


def mlstm_from_reference(p, dtype, device="cpu") -> MLSTM:
    """One ``mlstm_init`` dict -> :class:`~repro_torch.models.xlstm.MLSTM`
    (``w_if``, ``b_if`` in fp32)."""
    t = _leaves(p, dtype, device, ("w_if", "b_if"))
    return MLSTM(*(t[k] for k in ("up_x", "up_z", "conv", "wq", "wk", "wv",
                                  "w_if", "b_if", "norm", "down")))


def slstm_from_reference(p, dtype, device="cpu") -> SLSTM:
    """One ``slstm_init`` dict -> :class:`~repro_torch.models.xlstm.SLSTM`
    (``r``, ``b`` in fp32)."""
    t = _leaves(p, dtype, device, ("r", "b"))
    return SLSTM(*(t[k] for k in ("w_in", "r", "b", "norm", "up1", "up2",
                                  "down")))


def params_from_reference(cfg, params, device="cpu"):
    """A model's JAX parameter pytree -> the port's module of its family
    (see the module doc) in ``cfg.param_dtype`` on ``device``, the stacked
    layers unstacked."""
    require_ported(cfg)
    dt = dtype_of(cfg.param_dtype)
    head = params.get("lm_head")
    head = None if head is None else _leaf(head, dt, device)
    final = _leaf(params["final_norm"], dt, device)
    n_super, per_super = superblock_shape(cfg)
    if cfg.family == "encoder":
        blocks = [_block(_index(params["blocks"], i), dt, device)
                  for i in range(cfg.n_layers)]
        return EncoderLM(_leaf(params["frame_proj"], dt, device), blocks,
                         final, head)
    embed = _leaf(params["embed"], dt, device)
    if cfg.family == "hybrid":
        def mamba_block(i, j):
            p = _index(params["mamba"], i, j)
            return MambaBlock(_leaf(p["ln"], dt, device),
                              ssm_from_reference(p["ssm"], dt, device))

        mamba = [[mamba_block(i, j) for j in range(per_super)]
                 for i in range(n_super)]
        return HybridLM(embed, mamba,
                        _block(params["shared_attn"], dt, device), final,
                        head)
    if cfg.family == "ssm":
        def cell_block(p, convert):
            return CellBlock(_leaf(p["ln"], dt, device),
                             convert(p["cell"], dt, device))

        mlstm = [[cell_block(_index(params["mlstm"], i, j),
                             mlstm_from_reference)
                  for j in range(per_super)] for i in range(n_super)]
        slstm = [cell_block(_index(params["slstm"], i), slstm_from_reference)
                 for i in range(n_super)]
        return XLSTMLM(embed, mlstm, slstm, final, head)
    blocks = [_block(_index(params["blocks"], i), dt, device)
              for i in range(cfg.n_layers)]
    return DenseLM(embed, blocks, final, head)


def cache_from_reference(cache, device="cpu"):
    """A decode cache pytree -> dict of tensors, each leaf in its own
    type (a bf16 leaf stays bf16)."""
    return {k: _leaf(v, getattr(torch, np.asarray(v).dtype.name), device)
            for k, v in cache.items()}


def _moment(tree, key: str, field=None):
    """The parameter-shaped tree of one moment (``key`` "m" or "v"), or of
    one field of an int8 moment, from an ``init_opt_state`` tree."""
    if set(tree) == {"m", "v"} and not isinstance(tree["m"], dict):
        leaf = tree[key]
        return np.asarray(leaf if field is None else getattr(leaf, field))
    return {k: _moment(v, key, field) for k, v in tree.items()}


def opt_state_from_reference(cfg, state, device="cpu"):
    """A reference ``init_opt_state`` tree of a model's parameters -> the
    port's optimizer state ``{name: {"m", "v"}}``, the names those
    :func:`params_from_reference` gives the parameters: fp32 and bf16
    moments in their type, int8 ones as
    :class:`~repro_torch.optim.QTensor` (int8 codes, fp32 scales)."""
    as_f32 = dataclasses.replace(cfg, param_dtype="float32")

    def named(tree, dtype):
        module = params_from_reference(as_f32, tree, device)
        return {k: p.detach().to(dtype) for k, p in module.named_parameters()}

    first = state
    while isinstance(first, dict):
        first = next(iter(first.values()))    # a leaf's {"m", "v"}: its m
    out = {}
    for key in ("m", "v"):
        if hasattr(first, "codes"):           # int8: (codes, scale)
            codes = named(_moment(state, key, "codes"), torch.int8)
            scale = named(_moment(state, key, "scale"), torch.float32)
            moments = {k: QTensor(codes[k], scale[k]) for k in codes}
        else:
            moments = named(_moment(state, key),
                            getattr(torch, np.asarray(first).dtype.name))
        for name, t in moments.items():
            out.setdefault(name, {})[key] = t
    return out


def reference_path(name: str) -> str:
    """The reference's ``/``-joined parameter path of a port parameter
    name, as :func:`params_from_reference` maps one to the other: the
    layer indices dropped (the reference stacks the layers), the hybrid
    family's ``shared`` block named ``shared_attn``
    (``blocks.3.attn.wq`` -> ``blocks/attn/wq``, ``mamba.1.0.ssm.conv``
    -> ``mamba/ssm/conv``, ``shared.ffn.wi`` -> ``shared_attn/ffn/wi``)."""
    parts = [p for p in name.split(".") if not p.isdigit()]
    if parts[0] == "shared":
        parts[0] = "shared_attn"
    return "/".join(parts)
