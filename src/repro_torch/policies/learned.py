"""Gradient-trained cap policy ("learned"): caps = MLP(observable state).

A tiny permutation-equivariant MLP scores every lane from features any of
the three backends can observe *online* (no remaining-work, no lookahead
— the same information budget as the paper's §V controller), and the
scores are turned into caps by a masked softmax over the running lanes::

    caps = cap_floor + softmax(logits | running) * free_budget
    free_budget = bound - idle_draw(non-running) - sum(cap_floor | running)

which is bound-compliant *by construction*: running caps plus non-running
idle draw always totals exactly the cluster bound (never above it — the
learned policy cannot borrow the transient surplus the paper's heuristic
surges with).  With the final layer at zero the logits are uniform and
the policy degrades to equal-split reclamation of blocked nodes' power —
a strictly-better-than-``equal-share`` starting point that training
(the reference's differentiable layer) then improves by learning *which*
running lane deserves the marginal watt (high ``cpu_frac`` lanes first,
saturated lanes last).

The port's copy of the reference's ``repro.policies.learned`` and its
bundled checkpoint.  Everything numeric lives in module-level pure
functions taking an ``xp`` array namespace (``numpy`` here; the torch
engine's :class:`~repro_torch.backends.policies.TorchLearned` calls the
same functions through a small torch namespace), so the three backends
cannot drift.  Every sum over lanes goes through :func:`lane_sum` and
every product with a weight matrix through ``xp.matmul``: under numpy
those are ``.sum(-1)`` and ``@``; the torch namespace spells the order
of the card's kernel (``repro_wave_run``'s ``learned`` mode) in both, so
the engine's plain path and the kernel agree bit for bit.  This module
imports only numpy.

>>> import numpy as np
>>> p = init_params(seed=0)
>>> feats = lane_features(
...     np, running=np.array([1.0, 1.0, 0.0]),
...     rho=np.array([1.0, 0.4, 0.0]), bound=np.asarray(9.0),
...     n_active=np.asarray(3.0), p_max=np.full(3, 6.2),
...     cap_floor=np.full(3, 0.5), idle_w=np.full(3, 0.45))
>>> feats.shape                       # (lanes, FEATURE_DIM)
(3, 8)
>>> caps = caps_from_logits(
...     np, policy_logits(np, p, feats), running=np.array([1., 1., 0.]),
...     bound=np.asarray(9.0), n_active=np.asarray(3.0),
...     p_max=np.full(3, 6.2), cap_floor=np.full(3, 0.5),
...     idle_w=np.full(3, 0.45))
>>> bool(np.isclose(caps[0] + caps[1] + 0.45, 9.0))   # exactly the bound
True
>>> bool(caps[2] == 0.5)              # non-running lane parked at floor
True
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .base import Action, ClusterView, PowerPolicy, SetCap
from .registry import register_policy
from .vector import VectorPolicy, register_vector_policy

#: Per-lane feature vector (all observable online in every backend):
#: [running, frac_running, tightness, headroom, idle_frac, rho*running,
#:  floor_frac, 1].  Anything proportional to remaining work is
#: deliberately absent — the event backend could not see it.
FEATURE_DIM = 8
HIDDEN = (16, 16)

#: Environment variable overriding the bundled default checkpoint.
CHECKPOINT_ENV = "REPRO_LEARNED_CHECKPOINT"

#: The seeded checkpoint shipped with the package (a copy of the
#: reference's — ``tests/test_torch_learned.py`` pins the two
#: copies identical).
DEFAULT_CHECKPOINT = Path(__file__).with_name("learned_default.json")

_PARAM_KEYS = ("W1", "b1", "W2", "b2", "w3", "b3")
_NEG_BIG = -1e30


# ------------------------------------------------------------------ params
def init_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Fresh MLP parameters.  Hidden layers get small random weights; the
    output layer is *zero* so the initial policy is exactly equal-split
    reclamation (uniform logits) — training starts from a sane baseline
    instead of a random cap assignment."""
    rng = np.random.default_rng(seed)
    h1, h2 = HIDDEN
    return {
        "W1": rng.normal(0.0, 0.3, (FEATURE_DIM, h1)),
        "b1": np.zeros(h1),
        "W2": rng.normal(0.0, 0.3, (h1, h2)),
        "b2": np.zeros(h2),
        "w3": np.zeros(h2),
        "b3": np.zeros(()),
    }


def save_checkpoint(params: Dict[str, np.ndarray], path,
                    meta: Optional[dict] = None) -> None:
    """Write a JSON checkpoint (nested lists — no pickle, diffable)."""
    doc = {
        "arch": {"features": FEATURE_DIM, "hidden": list(HIDDEN)},
        "params": {k: np.asarray(params[k]).tolist() for k in _PARAM_KEYS},
        "meta": meta or {},
    }
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


def load_checkpoint(path=None) -> Dict[str, np.ndarray]:
    """Load MLP parameters: explicit ``path``, else the
    ``REPRO_LEARNED_CHECKPOINT`` env var, else the bundled default."""
    if path is None:
        path = os.environ.get(CHECKPOINT_ENV) or DEFAULT_CHECKPOINT
    doc = json.loads(Path(path).read_text())
    arch = doc.get("arch", {})
    if (arch.get("features") != FEATURE_DIM
            or tuple(arch.get("hidden", ())) != HIDDEN):
        raise ValueError(f"checkpoint {path} architecture {arch} does not "
                         f"match features={FEATURE_DIM} hidden={HIDDEN}")
    return {k: np.asarray(doc["params"][k], dtype=float)
            for k in _PARAM_KEYS}


# ------------------------------------------------- xp-generic policy math
def lane_sum(xp, x):
    """Sum over the lane axis (the last): ``xp.lane_sum`` where the
    namespace gives one (the torch engine's, in the kernel's order),
    else ``x.sum(axis=-1)``."""
    hook = getattr(xp, "lane_sum", None)
    return x.sum(axis=-1) if hook is None else hook(x)


def lane_features(xp, running, rho, bound, n_active, p_max, cap_floor,
                  idle_w):
    """Stack the ``(..., N, FEATURE_DIM)`` feature tensor.

    ``running``/``rho``/``p_max``/``cap_floor``/``idle_w`` are ``(..., N)``
    lane arrays; ``bound``/``n_active`` are ``(...,)`` row scalars.  Works
    for a single ``(N,)`` row (event backend, jax per-row trace) and a
    ``(B, N)`` batch alike.  Phantom padding lanes (``p_max = cap_floor =
    idle_w = 0``, never running) contribute nothing to the row sums and
    produce inert features.
    """
    r = running * 1.0
    bound = bound * 1.0
    inv_bound = 1.0 / xp.maximum(bound, 1e-12)
    n_running = lane_sum(xp, r)
    frac_running = (n_running / n_active)[..., None]
    tightness = (bound / xp.maximum(lane_sum(xp, p_max), 1e-12))[..., None]
    headroom = p_max * (n_active * inv_bound)[..., None]
    idle_frac = (lane_sum(xp, (1.0 - r) * idle_w) * inv_bound)[..., None]
    floor_frac = cap_floor * (n_active * inv_bound)[..., None]
    ones = xp.ones_like(r)
    return xp.stack(
        [r, frac_running * ones, tightness * ones, headroom,
         idle_frac * ones, rho * r, floor_frac, ones], axis=-1)


def policy_logits(xp, params, feats):
    """MLP forward pass: ``(..., N, F)`` features -> ``(..., N)`` logits."""
    h = xp.tanh(xp.matmul(feats, params["W1"]) + params["b1"])
    h = xp.tanh(xp.matmul(h, params["W2"]) + params["b2"])
    return xp.matmul(h, params["w3"]) + params["b3"]


def caps_from_logits(xp, logits, running, bound, n_active, p_max,
                     cap_floor, idle_w):
    """Masked-softmax cap assignment (see module docstring).

    Running lanes split ``free_budget`` by softmax weight on top of their
    cap floors; non-running lanes are parked at their floors (they draw
    idle power regardless of cap); rows with *no* running lane fall back
    to the nominal share P/n, matching ``VectorPolicy.setup``.
    """
    r = running * 1.0
    idle_draw = lane_sum(xp, (1.0 - r) * idle_w)
    free = xp.maximum(bound - idle_draw - lane_sum(xp, r * cap_floor), 0.0)
    masked = xp.where(running, logits, _NEG_BIG)
    z = masked - xp.max(masked, axis=-1, keepdims=True)
    e = xp.exp(z) * r
    denom = xp.maximum(lane_sum(xp, e)[..., None], 1e-30)
    share = e / denom
    caps_run = cap_floor + share * free[..., None]
    caps = xp.where(running, caps_run, cap_floor)
    any_running = (lane_sum(xp, r) > 0)[..., None]
    nominal = (bound / n_active)[..., None] * xp.ones_like(r)
    return xp.where(any_running, caps, nominal)


def compute_caps(xp, params, running, rho, bound, n_active, p_max,
                 cap_floor, idle_w):
    """features -> logits -> caps in one call (the whole policy)."""
    feats = lane_features(xp, running, rho, bound, n_active, p_max,
                          cap_floor, idle_w)
    logits = policy_logits(xp, params, feats)
    return caps_from_logits(xp, logits, running, bound, n_active, p_max,
                            cap_floor, idle_w)


# ------------------------------------------------------------ event policy
@register_policy("learned")
class LearnedPolicy(PowerPolicy):
    """Event-driven adapter: recompute the cap split on every observable
    edge (report, job start/complete, bound change), zero latency like
    the oracle adapter — latency modelling is the heuristic's concern,
    the learned policy's contract is the *split*."""

    name = "learned"

    def __init__(self, checkpoint: Optional[str] = None):
        self.params = load_checkpoint(checkpoint)
        self._view: Optional[ClusterView] = None
        self._running: Dict[int, bool] = {}
        self._rho: Dict[int, float] = {}
        self._bound = 0.0
        self._last_sent: Dict[int, float] = {}
        self._messages = 0
        self._distributes = 0

    def on_start(self, view: ClusterView) -> List[Action]:
        self._view = view
        self._bound = view.bound_w
        # ``running`` means "a job is executing right now" — the exact
        # quantity the batch backends read off their lane state.  Jobs
        # starting at t=0 flip it via on_job_start before time advances.
        self._running = {n: False for n in view.node_ids}
        self._rho = {n: 0.0 for n in view.node_ids}
        return []

    def on_report(self, report, now: float) -> List[Action]:
        # Job start/complete hooks fire at exact event times, so the
        # (latency-delayed) block reports carry no extra information for
        # this policy; counting them keeps the stats() contract.
        self._messages += 1
        return []

    def on_job_start(self, job, now: float) -> List[Action]:
        self._rho[job.node] = job.cpu_frac
        self._running[job.node] = True
        return self._resolve()

    def on_job_complete(self, job, now: float) -> List[Action]:
        self._rho[job.node] = 0.0
        self._running[job.node] = False
        return self._resolve()

    def on_bound_change(self, bound_w: float, now: float) -> List[Action]:
        self._bound = bound_w
        return self._resolve(force=True)

    def _resolve(self, force: bool = False) -> List[Action]:
        view = self._view
        nodes = view.node_ids
        luts = [view.specs[n].lut for n in nodes]
        from repro_torch.core.power import cap_floor_w

        caps = compute_caps(
            np, self.params,
            running=np.array([self._running[n] for n in nodes]),
            rho=np.array([self._rho[n] for n in nodes]),
            bound=np.asarray(self._bound),
            n_active=np.asarray(float(len(nodes))),
            p_max=np.array([lut.p_max for lut in luts]),
            cap_floor=np.array([cap_floor_w(lut) for lut in luts]),
            idle_w=np.array([lut.idle_w for lut in luts]))
        actions: List[Action] = []
        for i, n in enumerate(nodes):
            cap = float(caps[i])
            if force or abs(self._last_sent.get(n, -1.0) - cap) > 1e-9:
                self._last_sent[n] = cap
                self._distributes += 1
                actions.append(SetCap(n, cap))
        return actions

    def stats(self) -> Dict[str, int]:
        return {"messages": self._messages,
                "distributes": self._distributes, "suppressed": 0}


# ----------------------------------------------------------- vector policy
@register_vector_policy("learned")
class VectorLearned(VectorPolicy):
    """Batched adapter: same :func:`compute_caps` on ``(B, N)`` state at
    every exact-time transition.  ``exact=False`` — the jax backend runs
    the identical math in float32, and near an LUT state-power threshold
    that rounding difference can flip the selected operating point, so
    the cross-backend makespans track but are not bitwise-pinned."""

    name = "learned"
    exact = False

    def __init__(self, checkpoint: Optional[str] = None):
        self.params = load_checkpoint(checkpoint)

    def _refill(self, sim, rows) -> None:
        from repro_torch.core.power import LUTTable

        table = sim.table
        if table.state_p.ndim == 3:        # per-row tables: slice the rows
            table = LUTTable(**{k: getattr(table, k)[rows]
                                for k in LUTTable.__dataclass_fields__})
        running = sim.running[rows]
        rho = sim.rho_pad[sim._bidx[:, None], sim._cur()][rows]
        sim.cap[rows] = compute_caps(
            np, self.params, running=running,
            rho=np.where(running, rho, 0.0),
            bound=sim.bounds[rows], n_active=sim.n_active[rows] * 1.0,
            p_max=np.broadcast_to(table.p_max, running.shape),
            cap_floor=np.broadcast_to(table.cap_floor, running.shape),
            idle_w=sim.idle_w[rows])

    def on_job_start(self, sim, rows, lanes, jobs) -> None:
        # ``on_transition`` only fires when the running *mask* changes,
        # but a lane chaining straight into its next job can change that
        # lane's cpu_frac — the event and jax backends both recompute
        # there, so the rho-sensitive policy must refill on job starts.
        self._refill(sim, np.unique(rows))

    def on_transition(self, sim, rows) -> None:
        self._refill(sim, rows)

    def on_bound_change(self, sim, rows) -> None:
        self._refill(sim, rows)
