"""Fault-tolerant checkpoints of the training state, the port of the
reference's ``checkpoint/manager.py``.

Layout per step::

    <dir>/step_000000123.tmp-<nonce>/   (written first)
        manifest.json                   (paths, shapes, dtypes, step, extra)
        leaf_00000.npy ...
    <dir>/step_000000123/               (atomic rename when complete)

Guarantees:
  * atomicity — a crash mid-write leaves only a .tmp dir, which is
    ignored and garbage-collected on the next save;
  * restore-anywhere — leaves are saved device-agnostic (host numpy);
    ``restore`` puts them on the device the caller names (the counterpart
    of the reference's ``shardings``), so a job can restart on another
    device;
  * retention — keep_last N complete checkpoints.

A tree is a nested dict (or named tuple) of tensors: the trainer saves
``{"params": model.state_dict(), "opt": opt_state}``, so each leaf is
keyed by its ``state_dict`` name or its optimizer-state name (``opt/<param
name>/m``, and ``/codes`` and ``/scale`` under an int8 moment).  numpy has
no bfloat16, so a bf16 leaf is stored as its raw 16-bit patterns
(``int16``) with ``bfloat16`` in the manifest, and restored bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_tree(tree: Tree, prefix: str = ""
                 ) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in the tree's order: dict keys in insertion
    order, a named tuple's fields in order; the path joins the keys with
    ``/``."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    else:
        raise TypeError(f"checkpoint trees hold dicts, named tuples and "
                        f"tensors, got {type(tree).__name__} at {prefix!r}")
    out = []
    for key, sub in items:
        out.extend(flatten_tree(sub, f"{prefix}/{key}" if prefix
                                else str(key)))
    return out


def _unflatten(template: Tree, leaves) -> Tree:
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` in order."""
    if isinstance(template, torch.Tensor):
        return next(leaves)
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves) for k, v in template.items()}
    return type(template)(*(_unflatten(v, leaves) for v in template))


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """Host copy of ``t`` and its type's name (bf16 as its bit pattern)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Tree,
             extra: Optional[Dict[str, Any]] = None) -> Path:
        flat = flatten_tree(tree)
        tmp = self.dir / f"step_{step:09d}.tmp-{uuid.uuid4().hex[:8]}"
        tmp.mkdir(parents=True)
        try:
            dtypes, shapes = [], []
            for i, (_, leaf) in enumerate(flat):
                arr, dtype = _to_numpy(leaf)
                np.save(tmp / f"leaf_{i:05d}.npy", arr)
                dtypes.append(dtype)
                shapes.append(list(leaf.shape))
            manifest = {"step": step, "paths": [p for p, _ in flat],
                        "dtypes": dtypes, "shapes": shapes,
                        "extra": extra or {}}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step:09d}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self) -> None:
        # drop stale tmp dirs and old complete checkpoints
        for p in self.dir.glob("step_*.tmp-*"):
            shutil.rmtree(p, ignore_errors=True)
        steps = self.completed_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def completed_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.name.count(".tmp-") or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.completed_steps()
        return steps[-1] if steps else None

    def restore(self, template: Tree, step: Optional[int] = None,
                device=None) -> Tuple[Tree, int, Dict[str, Any]]:
        """Restore into the structure of ``template``: each leaf on
        ``device``, or on the device of the template's leaf when ``device``
        is None.  Raises ``ValueError`` when the paths differ."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = flatten_tree(template)
        want_paths = [p for p, _ in flat]
        if want_paths != manifest["paths"]:
            raise ValueError("checkpoint tree structure mismatch: "
                             f"{len(want_paths)} vs {len(manifest['paths'])}"
                             " leaves / differing paths")
        loaded = (_from_numpy(np.load(d / f"leaf_{i:05d}.npy"),
                              manifest["dtypes"][i],
                              leaf.device if device is None else device)
                  for i, (_, leaf) in enumerate(flat))
        return _unflatten(template, loaded), step, manifest["extra"]
