"""Trainer for the ``"learned"`` cap policy (gradient through the soft
simulator).

The port of the reference's ``repro.diff.train``.  Loss: mean over a
rho-diverse scenario set of ``soft makespan / equal-share exact
makespan``; the normalization puts every scenario on the same scale (1.0
= "no better than the paper's baseline") so no single large graph
dominates the gradient.  The parameters are the MLP of
:mod:`repro_torch.policies.learned`; gradients flow through
:func:`repro_torch.diff.softsim.soft_makespan_policy`, which calls the
same ``compute_caps`` the event, vector and torch adapters run, so the
result IS the deployed policy.

With the zero output layer the initial policy is already equal-split
reclamation; what training adds is lane *discrimination*: features only
distinguish lanes by ``running`` and the current job's ``cpu_frac``, so
rho-diverse workloads (``layered_dag``) carry the signal and
rho-homogeneous ones (``listing2``) anchor the symmetric baseline.

Run as a script to train a checkpoint on the card (``--device cpu`` for
the CPU); ``--out`` writes the format ``TorchLearned(checkpoint=...)``
reads::

    PYTHONPATH=src python -m repro_torch.diff.train --steps 150 \\
        --out /path/to/learned.json
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.power import (NodeSpec, homogeneous_cluster,
                                    max_useful_cluster_bound,
                                    min_feasible_cluster_bound)
from repro_torch.core.workloads import (fork_join_graph, layered_dag,
                                        listing2_graph)
from repro_torch.policies.learned import init_params, save_checkpoint

from .softsim import build_soft_arrays, soft_makespan_policy


def training_scenarios(seed: int = 0, quick: bool = False
                       ) -> List[Tuple[str, object, Sequence[NodeSpec],
                                       float]]:
    """(name, graph, specs, bound) tuples: layered DAGs across seeds and
    bound tightnesses (the rho-diverse signal), fork-join barriers, and
    listing2 (the symmetric anchor)."""
    out = []
    fracs = (0.35, 0.55) if quick else (0.3, 0.45, 0.6)
    seeds = (seed + 1, seed + 2) if quick else (seed + 1, seed + 2,
                                                seed + 3)
    for s in seeds:
        for n in (4,) if quick else (4, 6):
            g = layered_dag(n, layers=3, fan=2, seed=s)
            specs = homogeneous_cluster(n)
            lo = min_feasible_cluster_bound(specs)
            hi = max_useful_cluster_bound(specs)
            for f in fracs:
                out.append((f"layered-n{n}-s{s}-f{f}", g, specs,
                            lo + f * (hi - lo)))
    g = fork_join_graph(4, stages=2, seed=seed + 9)
    specs = homogeneous_cluster(4)
    lo, hi = (min_feasible_cluster_bound(specs),
              max_useful_cluster_bound(specs))
    out.append(("forkjoin-4", g, specs, lo + 0.4 * (hi - lo)))
    g = listing2_graph()
    specs = homogeneous_cluster(3)
    out.append(("listing2", g, specs, 9.0))
    return out


def train_policy(seed: int = 0, steps: int = 150, lr: float = 0.02,
                 temperatures: Sequence[float] = (0.3, 0.1, 0.05),
                 quick: bool = False, verbose: bool = True, device=None,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[Dict[str, np.ndarray], dict]:
    """Adam over the scenario-mean normalized soft makespan, on
    ``device`` (``None`` is the card and raises without one) in
    ``dtype``.

    Returns ``(params, meta)``; ``meta`` records the scenario list and
    the per-phase loss trajectory (1.0 = equal-share parity).
    """
    from repro_torch.core.batchsim import simulate_batch

    scenarios = training_scenarios(seed, quick=quick)
    objectives = []
    for name, g, specs, bound in scenarios:
        soft = build_soft_arrays(g, specs, device=device)
        base = simulate_batch(g, specs, [bound],
                              policy="equal-share")[0].makespan
        objectives.append((name, soft, bound, base))
    dev = objectives[0][1].device
    params = {k: torch.as_tensor(v, dtype=dtype, device=dev)
              for k, v in init_params(seed).items()}

    def val_grad(params, temp, soft, bound, base):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        val = soft_makespan_policy(leaves, soft, bound, temp) / base
        grads = torch.autograd.grad(val, list(leaves.values()))
        return val.detach(), dict(zip(leaves, grads))

    b1, b2, eps = 0.9, 0.999, 1e-8
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    history: List[Tuple[int, float, float]] = []
    per_temp = max(1, steps // len(temperatures))
    step = 0
    for temp in temperatures:
        for _ in range(per_temp):
            step += 1
            total = 0.0
            gsum = {k: torch.zeros_like(p) for k, p in params.items()}
            for _, soft, bound, base in objectives:
                val, g = val_grad(params, temp, soft, bound, base)
                total += float(val)
                gsum = {k: gsum[k] + g[k] for k in gsum}
            k_ = len(objectives)
            gmean = {k: x / k_ for k, x in gsum.items()}
            m = {k: b1 * m[k] + (1 - b1) * gmean[k] for k in m}
            v = {k: b2 * v[k] + (1 - b2) * gmean[k] * gmean[k] for k in v}
            t_ = step
            params = {k: p - lr * (m[k] / (1 - b1 ** t_))
                      / (torch.sqrt(v[k] / (1 - b2 ** t_)) + eps)
                      for k, p in params.items()}
        history.append((step, float(temp), total / k_))
        if verbose:
            print(f"step {step:4d}  T={temp:<5}  "
                  f"loss={total / k_:.5f} (1.0 = equal-share)")

    params_np = {k: p.cpu().numpy().astype(float)
                 for k, p in params.items()}
    meta = {
        "seed": seed, "steps": step, "lr": lr,
        "temperatures": list(map(float, temperatures)),
        "scenarios": [name for name, *_ in scenarios],
        "loss_history": [[s, t, l] for s, t, l in history],
    }
    return params_np, meta


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--quick", action="store_true",
                    help="smaller scenario set (CI smoke)")
    ap.add_argument("--out", default=None,
                    help="checkpoint path (default: print only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the "
                         "CPU)")
    args = ap.parse_args(argv)
    params, meta = train_policy(seed=args.seed, steps=args.steps,
                                lr=args.lr, quick=args.quick,
                                device=args.device)
    if args.out:
        save_checkpoint(params, args.out, meta=meta)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
