"""Multi-pod dry run of the port on a fake 256/512-rank mesh.

For every runnable (architecture x input shape) cell this runs the port's
real step function once — ``make_train_step``, ``make_prefill_step`` or
``make_serve_step`` — on rank 0 of the production mesh (16x16
single-pod or 2x16x16 multi-pod, :mod:`repro_torch.launch.mesh`), with
the parameters, optimizer state, batch and cache sharded by the rules of
:mod:`repro_torch.launch.sharding` as DTensors whose local shards are
fake tensors (``FakeTensorMode``: shapes and types, no storage, no
arithmetic).  The activations follow the reference's ``constrain``
sites (:mod:`repro_torch.models.sharding`), and the LM kernels run as
their shape-only operators (:mod:`repro_torch.kernels.sharded`), so no
kernel launches and no plain loop runs.  Nothing touches a card.

It records, per cell, under the reference's keys:

  * ``peak_bytes_per_device``: the most bytes of rank 0's shards alive at
    once (the parameters, state, batch and cache, then every tensor the
    step creates until it is freed), counted by :class:`StepCost`, a
    dispatch mode over the local shards that sees each storage created
    and freed;
  * ``cost.flops``: rank 0's FLOPs, by ``torch.utils.flop_counter``'s
    formulas applied to the local shards' operators;
  * the collectives rank 0 issues, in order, from the same dispatch mode:
    ``collectives_per_device`` (count and bytes by kind) and
    ``schedule``, the ordered ``(kind, bytes)`` list that
    :func:`repro_torch.core.hlo_extract.step_job_graph` reads.  Bytes are
    each collective's result on the rank, as the reference's are those
    of the HLO result shape.  The step runs eagerly, each loop unrolled,
    so the per-step totals are already what the reference's
    loop-corrected HLO parse recovers:
    ``collectives_per_device_loop_corrected`` records them.

written to ``<out>/<arch>__<shape>__<mesh>.json`` (the roofline report,
:mod:`repro_torch.core.roofline`, reads these artifacts).

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \\
        --mesh single --out results/dryrun_torch

The fake process group is process-global: a run of both meshes (or of
several cells) destroys it after each cell and creates it anew for the
next (:func:`repro_torch.launch.mesh.production_mesh`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import weakref
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (cell_status, get_config, runnable_cells,
                                 shape_by_name)
from repro_torch.launch.mesh import (alltoall_redistribution, dp_axes,
                                     mesh_name, production_mesh)
from repro_torch.launch.sharding import (batch_shardings, cache_shardings,
                                         opt_state_shardings,
                                         param_shardings)
from repro_torch.launch.steps import (abstract_cache, abstract_params,
                                      input_specs, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models.sharding import clear_policy, set_policy
from repro_torch.optim import AdamWConfig, QTensor, init_opt_state

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

#: functional collectives (and DTensor's all-to-all) -> the reference's
#: collective kinds
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def opt_config_for(arch: str) -> AdamWConfig:
    # arctic-480b needs int8 moments to fit one pod; everything else
    # keeps fp32 state (the reference's choice)
    if arch == "arctic-480b":
        return AdamWConfig(state_dtype="int8")
    return AdamWConfig(state_dtype="float32")


def micro_for(arch: str, shape_name: str) -> int:
    """Gradient-accumulation microbatches per (arch, shape) — the memory
    lever for the densest training cells (activation working set ~ 1/M)."""
    if shape_name != "train_4k":
        return 1
    return {
        "arctic-480b": 16,
        "chameleon-34b": 4,
        "granite-20b": 2,
        "internlm2-20b": 2,
        "moonshot-v1-16b-a3b": 2,
        "llama3-8b": 2,
    }.get(arch, 1)


def _outputs(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _outputs(o)]
    return []


class StepCost(TorchDispatchMode):
    """Rank 0's collectives, FLOPs and live bytes, read off the local
    shards' operators.

    A DTensor operator is handed back to DTensor (``NotImplemented``):
    DTensor then runs its redistributions and the operator on the local
    shards, and this mode sees those.  Only tensors of ``fake_mode`` (the
    shards') count; DTensor's own shape inference runs on other fake
    tensors and is skipped.  Each new storage adds its bytes to the live
    total until it is freed (a weak reference's callback).

    A DTensor view that DTensor cannot shard (a sharded dim split into
    dims whose first does not divide by its mesh dim, e.g. a
    ``(B, S, Hkv*dh) -> (B, S, Hkv, dh)`` split of 8 kv heads with the
    last dim over 16 ranks; or, in releases without strided shards, a
    flatten of two sharded dims) is retried after its input's last
    sharded mesh dim is gathered, until it runs.  Each such gather is a
    collective the step issues (counted) and is listed in ``regathers``
    (the operator, global shape and placements before it): a compiler
    could shard an inner dim of the split instead, which DTensor's view
    rule does not do."""

    VIEWS = ("aten::view", "aten::_unsafe_view", "aten::reshape")

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.regathers: List[Tuple[str, Tuple[int, ...], str]] = []
        self.schedule: List[Tuple[str, int]] = []
        self.flops = 0
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, weakref.ref] = {}

    def _local(self, t) -> bool:
        return getattr(t, "fake_mode", None) is self.fake_mode

    def _free(self, key: int, nbytes: int) -> None:
        self._seen.pop(key, None)
        self.live -= nbytes

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live (once), until it is freed."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen and self._seen[key]() is st:
            return
        nbytes = st.nbytes()
        self._seen[key] = weakref.ref(
            st, lambda _r, k=key, n=nbytes: self._free(k, n))
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if func.name() in self.VIEWS:
                return self._view(func, args, kwargs)
            return NotImplemented
        out = func(*args, **kwargs)
        outs = [t for t in _outputs(out) if self._local(t)]
        if not outs:
            return out
        name = func.name()
        space, _, op = name.partition("::")
        if space in _COLLECTIVE_NAMESPACES and op in COLLECTIVE_KINDS:
            self.schedule.append(
                (COLLECTIVE_KINDS[op],
                 sum(t.numel() * t.element_size() for t in outs)))
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        for t in outs:
            self.track(t)
        return out

    def _view(self, func, args, kwargs):
        from torch.distributed.tensor import Replicate, Shard

        x, rest = args[0], args[1:]
        while True:
            try:
                return func(x, *rest, **kwargs)
            except RuntimeError:
                # DTensor refuses the view (which error depends on the
                # release: an uneven split, or a flatten of sharded dims)
                dims = [i for i, pl in enumerate(x.placements)
                        if isinstance(pl, Shard)]
                if not dims:
                    raise
            self.regathers.append((func.name(), tuple(x.shape),
                                   str(tuple(x.placements))))
            pls = list(x.placements)
            pls[dims[-1]] = Replicate()
            with self:
                x = x.redistribute(x.device_mesh, pls)

    def collectives(self) -> Dict[str, Dict[str, int]]:
        by: Dict[str, Dict[str, int]] = {}
        for kind, nbytes in self.schedule:
            rec = by.setdefault(kind, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += nbytes
        return by


# ------------------------------------------------------------ sharded state
def _shard(t: torch.Tensor, mesh, placements, fake_mode):
    """A DTensor of ``t``'s global shape and type, its local shard a fake
    tensor of the placements' shape on rank 0."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    local_shape, _ = compute_local_shape_and_global_offset(
        tuple(t.shape), mesh, placements)
    with fake_mode:
        local = torch.empty(local_shape, dtype=t.dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape,
                              stride=torch.empty(t.shape,
                                                 device="meta").stride())


def shard_model(model: nn.Module, mesh, shardings, fake_mode) -> nn.Module:
    """Replace each (meta) parameter by a DTensor parameter placed by
    ``shardings`` (``{name: placements}``), in place."""
    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, attr, nn.Parameter(
            _shard(p, mesh, shardings[name], fake_mode),
            requires_grad=p.requires_grad))
    return model


def shard_opt_state(state, mesh, shardings, fake_mode):
    """The (meta) optimizer state as DTensors placed by ``shardings``
    (:func:`~repro_torch.launch.sharding.opt_state_shardings`)."""
    out = {}
    for name, moments in state.items():
        out[name] = {}
        for key, mom in moments.items():
            pl = shardings[name][key]
            if isinstance(mom, QTensor):
                out[name][key] = QTensor(
                    _shard(mom.codes, mesh, pl["codes"], fake_mode),
                    _shard(mom.scale, mesh, pl["scale"], fake_mode))
            else:
                out[name][key] = _shard(mom, mesh, pl[""], fake_mode)
    return out


def _local_tensors(tree):
    """Every DTensor's local shard in a tree of dicts / tuples / modules."""
    if isinstance(tree, nn.Module):
        return [p.to_local() for p in tree.parameters()]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _local_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _local_tensors(v)]
    if isinstance(tree, torch.Tensor):
        return [tree.to_local()]
    return []


# ------------------------------------------------------------------ cells
def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path = RESULTS, verbose: bool = True,
             n_layers: Optional[int] = None) -> dict:
    """Dry-run one cell and write its artifact; returns the record.
    ``n_layers`` cuts the model's depth (the widths stay the config's);
    the artifact then records it under ``reduced``."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    mesh_id = mesh_name(multi_pod)
    t0 = time.time()
    cfg = get_config(arch, shape_name)
    full_layers = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = shape_by_name(shape_name)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with production_mesh(multi_pod=multi_pod) as mesh:
        set_policy(mesh, dp_axes(mesh))
        try:
            model = abstract_params(cfg)
            meta_params = dict(model.named_parameters())
            shard_model(model, mesh, param_shardings(cfg, mesh, model), fake)
            specs = input_specs(cfg, shape)
            batch = {k: _shard(v, mesh, pl, fake) for (k, v), pl in zip(
                specs.items(), batch_shardings(cfg, mesh, specs).values())}
            n_micro = micro_for(arch, shape_name) \
                if shape.kind == "train" else 1
            if shape.kind == "train":
                opt_cfg = opt_config_for(arch)
                meta_state = init_opt_state(meta_params, opt_cfg)
                state = shard_opt_state(
                    meta_state, mesh,
                    opt_state_shardings(cfg, mesh, meta_state), fake)
                model.requires_grad_(True)
                accum = torch.bfloat16 if arch == "arctic-480b" \
                    else torch.float32
                step = make_train_step(cfg, opt_cfg, n_microbatches=n_micro,
                                       accum_dtype=accum)
                args, held = (model, state, batch, 0), (model, state, batch)
            elif shape.kind == "prefill":
                step = make_prefill_step(cfg, device="cpu")
                args, held = (model, batch), (model, batch)
            else:
                meta_cache = abstract_cache(cfg, shape)
                cache = {k: _shard(v, mesh, pl, fake) for (k, v), pl in zip(
                    meta_cache.items(),
                    cache_shardings(cfg, mesh, meta_cache).values())}
                step = make_serve_step(cfg, device="cpu")
                args = (model, cache, batch["tokens"], shape.seq_len - 1)
                held = (model, cache, batch)
            cost = StepCost(fake)
            for t in _local_tensors(held):
                cost.track(t)
            argument_bytes = cost.live
            with cost, implicit_replication(), alltoall_redistribution():
                step(*args)
        finally:
            clear_policy()
        n_dev = mesh.size()
    colls = cost.collectives()
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_id,
        "n_devices": int(n_dev),
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "n_layers": cfg.n_layers,
        "reduced": (f"n_layers {cfg.n_layers} of {full_layers}"
                    if cfg.n_layers != full_layers else None),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "memory": {"argument_bytes": argument_bytes,
                   "temp_bytes": cost.peak - argument_bytes,
                   "peak_source": "StepCost: live storages of rank 0's "
                                  "shards"},
        "peak_bytes_per_device": int(cost.peak),
        "cost": {"flops": float(cost.flops)},
        "collectives_per_device": colls,
        "collectives_per_device_loop_corrected": {
            k: v["bytes"] for k, v in colls.items()},
        "schedule": [[k, b] for k, b in cost.schedule],
        "reshape_regathers": [list(r) for r in cost.regathers],
        "n_microbatches": n_micro,
        "torch": torch.__version__,
        "compile_seconds": round(time.time() - t0, 1),
    }
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_id}.json"
    out_path.write_text(json.dumps(record, indent=2))
    if verbose:
        gib = record["peak_bytes_per_device"] / 2**30
        coll_mb = sum(v["bytes"] for v in colls.values()) / 2**20
        print(f"[dryrun] {arch:22s} {shape_name:12s} {mesh_id:11s} "
              f"peak/dev={gib:6.2f}GiB  "
              f"flops={record['cost']['flops']:.3e}  "
              f"coll/dev={coll_mb:9.1f}MiB  "
              f"n_coll={len(cost.schedule)}  "
              f"wall={record['compile_seconds']:6.1f}s", flush=True)
    return record


def _label(cell) -> str:
    return f"{cell[0]}__{cell[1]}__{'multi' if cell[2] else 'single'}"


def _run_child(cell, out_dir: Path, n_layers: Optional[int],
               timeout: float) -> str:
    """One cell in a child process (``python -m repro_torch.launch.dryrun``)
    under ``timeout`` seconds; raises with its output's end when it
    fails."""
    import os
    import subprocess

    arch, shape_name, multi_pod = cell
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape_name, "--mesh",
           "multi" if multi_pod else "single", "--out", str(out_dir)]
    if n_layers is not None:
        cmd += ["--layers", str(n_layers)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parents[2])]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"no artifact in {timeout:.0f} s") from None
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout.strip().splitlines()[-1]
                           if proc.stdout.strip() else proc.stderr[-300:])
    return proc.stdout


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true",
                    help="run every runnable cell")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each model to this many layers (widths "
                         "unchanged; recorded under 'reduced')")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --cell-timeout: cells run at once, each in "
                         "its own process")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="run each cell in its own process and fail it "
                         "after this many seconds")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    if args.all:
        todo = runnable_cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        status = cell_status(args.arch, args.shape)
        if status != "run":
            print(f"[dryrun] {args.arch} x {args.shape}: {status}")
            return 0
        todo = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    # cells run one after another through the sweep engine's map, which
    # captures each failure with its timing (the fake group is
    # process-global, so cells cannot overlap)
    from repro_torch.core import SweepEngine

    cells = [(arch, shape_name, mp)
             for arch, shape_name in todo for mp in meshes]
    if args.cell_timeout is None:
        records = SweepEngine(executor="serial").map(
            lambda c: run_cell(c[0], c[1], c[2], out_dir,
                               n_layers=args.layers),
            cells, label=_label)
    else:
        # one process a cell (each its own fake group), ``--jobs`` at once
        records = SweepEngine(executor="thread", max_workers=args.jobs).map(
            lambda c: _run_child(c, out_dir, args.layers, args.cell_timeout),
            cells, label=_label)
        for rec in records:
            if rec.ok:
                print(rec.value.strip().splitlines()[0], flush=True)
    failures = [r for r in records if not r.ok]
    for rec in failures:
        print(f"[dryrun] FAIL {rec.label}: {rec.error}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for rec in failures:
            print(f"   {rec.label}: {rec.error[:300]}")
        return 1
    print("\nall dry-run cells ran OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
