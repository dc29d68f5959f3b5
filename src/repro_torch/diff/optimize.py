"""Gradient descent on static per-node caps (and cap schedules) under the
bound.

The port of the reference's ``repro.diff.optimize``.  The decision
variable is an unconstrained ``theta`` mapped onto the budget simplex::

    caps = cap_floor + softmax(theta) * (bound - sum(cap_floor))

so every iterate satisfies ``sum(caps) == bound`` (the paper's
total-bound constraint) and no cap falls below the duty floor, without a
projection.  A ``(K, N)`` theta optimizes a piecewise-constant cap
*schedule* over fixed knot times, each interval on its own simplex.

Optimization runs on :func:`repro_torch.diff.softsim.soft_makespan` down
a temperature ladder (coarse smoothing finds the basin, cold
temperatures sharpen onto the exact objective).
:func:`evaluate_static_caps` then scores the result in the *exact* numpy
simulator through :class:`~repro_torch.policies.vector.VectorStaticCaps`,
with ``smooth_lut=True`` by default: the continuous-DVFS model the
relaxation optimizes.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import JobDependencyGraph
from repro_torch.core.power import NodeSpec

from .softsim import SoftArrays, build_soft_arrays, soft_makespan


class OptResult(NamedTuple):
    caps: np.ndarray            # (N,) or (K, N) optimized watts
    soft_makespan: float        # final soft objective (coldest temp)
    exact_makespan: float       # exact smooth-LUT makespan of ``caps``
    history: List[Tuple[int, float, float]]  # (step, temperature, soft)


def caps_from_theta(theta: torch.Tensor, cap_floor: torch.Tensor,
                    bound) -> torch.Tensor:
    """Simplex map (see module docstring); works for (N,) and (K, N)."""
    free = bound - cap_floor.sum()
    return cap_floor + torch.softmax(theta, dim=-1) * free


def evaluate_static_caps(caps, graph: JobDependencyGraph,
                         specs: Sequence[NodeSpec], bound: float,
                         knot_times: Optional[Sequence[float]] = None,
                         smooth_lut: bool = True) -> float:
    """Exact makespan of ``caps`` in the numpy batch simulator.

    A ``(K, N)`` schedule is evaluated by pairing
    :class:`~repro_torch.policies.vector.VectorStaticCaps` with one
    constant-bound ``bound_schedules`` arrival per knot: each arrival
    forces a wave boundary at the knot time and the policy swaps the next
    cap row in, so the schedule lands at exact times.
    """
    from repro_torch.core.batchsim import simulate_batch
    from repro_torch.policies import VectorStaticCaps

    if torch.is_tensor(caps):
        caps = caps.detach().cpu().numpy()
    caps = np.asarray(caps, dtype=float)
    if caps.ndim == 2:
        policy = VectorStaticCaps(caps_schedule=caps)
        schedules = [[(float(t), float(bound)) for t in knot_times]]
    else:
        policy = VectorStaticCaps(caps=caps)
        schedules = None
    return simulate_batch(graph, specs, [bound], policy=policy,
                          bound_schedules=schedules,
                          smooth_lut=smooth_lut)[0].makespan


def optimize_static_caps(graph: JobDependencyGraph,
                         specs: Sequence[NodeSpec], bound: float,
                         knot_times: Optional[Sequence[float]] = None,
                         steps: int = 300, lr: float = 0.2,
                         temperatures: Sequence[float] = (
                             0.5, 0.2, 0.1, 0.05, 0.02),
                         soft: Optional[SoftArrays] = None, device=None,
                         dtype: torch.dtype = torch.float32) -> OptResult:
    """Adam on the simplex-parameterized (scheduled) caps.

    ``knot_times`` switches to a ``(len(knot_times)+1, N)`` schedule.
    ``steps`` are split evenly across the ``temperatures`` ladder.  The
    loop runs on ``device`` (``None`` is the card and raises without one;
    a given ``soft`` brings its own) in ``dtype``.
    """
    if soft is None:
        soft = build_soft_arrays(graph, specs, device=device)
    dev = soft.device
    cap_floor = soft.table.cap_floor.to(dtype)
    n = soft.n_nodes
    kt = None if knot_times is None else torch.as_tensor(
        np.asarray(knot_times, dtype=float), dtype=dtype, device=dev)
    shape = (n,) if kt is None else (kt.shape[0] + 1, n)
    theta = torch.zeros(shape, dtype=dtype, device=dev)

    def val_grad(theta, temperature):
        theta = theta.detach().requires_grad_(True)
        caps = caps_from_theta(theta, cap_floor, bound)
        val = soft_makespan(caps, soft, temperature, knot_times=kt)
        (g,) = torch.autograd.grad(val, theta)
        return val.detach(), g

    # Hand-rolled Adam, in the reference's order of operations.
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    history: List[Tuple[int, float, float]] = []
    per_temp = max(1, steps // len(temperatures))
    step = 0
    for temp in temperatures:
        for _ in range(per_temp):
            step += 1
            val, g = val_grad(theta, temp)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / (1 - b1 ** step)
            vhat = v / (1 - b2 ** step)
            theta = theta - lr * mhat / (torch.sqrt(vhat) + eps)
        history.append((step, float(temp), float(val)))

    with torch.no_grad():
        caps_t = caps_from_theta(theta, cap_floor, bound)
        soft_ms = float(soft_makespan(caps_t, soft, temperatures[-1],
                                      knot_times=kt))
    caps = caps_t.cpu().numpy()
    exact_ms = evaluate_static_caps(
        caps, graph, specs, bound,
        knot_times=None if knot_times is None else list(knot_times))
    return OptResult(caps=caps, soft_makespan=soft_ms,
                     exact_makespan=exact_ms, history=history)
