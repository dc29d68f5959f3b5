"""Policy functions for the torch wave engine.

Each policy is a pair of functions of the batch's lockstep state:

* ``caps_fn(ctx, st, pol) -> (B, N) watts`` — evaluated at the top of
  every wave from the settled state.  Waves land exactly on state
  transitions, so recomputing event-driven caps every wave is the same
  physics as the event hooks for the exact policies (equal-share, ilp,
  ilp-makespan, oracle).
* ``tick_fn(ctx, st, pol, due) -> pol`` — the only quantized hook; runs
  every wave and takes effect on the rows whose ``dt`` boundary won the
  wave (``due``; ``wants_ticks`` policies only).

Host-side work (ILP solves) happens once in ``init_state``, which returns
the per-row policy state (numpy, leading row axis B); the engine moves it
to the device.  ``redistribute=True`` hands cap setting to the fused
power step's reclamation / water-fill stage (the oracle rule).

``kernel_mode`` names the cap rule the whole-row CUDA loop
(``wave_run`` in :mod:`repro_torch.kernels.power_step`) runs in place of
``caps_fn``/``tick_fn``: a key of ``WAVE_MODES``.  It is read from the
policy's own class only (:func:`kernel_mode`), so a subclass that
changes the two functions does not inherit a rule that no longer
describes it; a policy without a mode runs on the engine's per-wave
paths.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.power_step import row_sum, waterfill
from repro_torch.policies.assign import resolve_assignments
from repro_torch.policies.registry import PolicyRegistry


def current_jobs(ctx, st) -> torch.Tensor:
    """Each lane's current job slot ``(B, N)`` (sentinel ``J`` when its
    sequence is exhausted)."""
    return ctx.node_seq.gather(2, st.ptr.unsqueeze(-1)).squeeze(-1)


def _nominal(ctx, st) -> torch.Tensor:
    """The paper's P/n share per row, as ``(B, N)`` lanes.  ``n`` is the
    row's real node count (phantom lanes never run, so their cap is
    inert); ``st.bound`` is the row's current bound, so a scheduled
    bound change re-splits at once."""
    share = st.bound / ctx.n_active
    return share.unsqueeze(-1).expand(-1, ctx.node_seq.shape[1])


class TorchPolicy:
    """Base class: static nominal caps, no state, no ticks."""

    name: str = "?"
    exact: bool = True
    wants_ticks: bool = False
    redistribute: bool = False
    kernel_mode: Optional[str] = None

    def init_state(self, sim) -> Dict[str, np.ndarray]:
        """Per-row policy state, every leaf with the row axis first."""
        return {}

    def take_state_rows(self, state: Dict[str, np.ndarray],
                        rows: np.ndarray) -> Dict[str, np.ndarray]:
        """The state of the batch rows ``rows`` (one shard of a batch
        split over devices; an index repeated for the split's phantom
        rows).  Every leaf carries the row axis here; a policy whose
        state has leaves without it overrides this."""
        return {k: np.asarray(v)[rows] for k, v in state.items()}

    @staticmethod
    def caps_fn(ctx, st, pol) -> torch.Tensor:
        return _nominal(ctx, st)

    @staticmethod
    def tick_fn(ctx, st, pol, due):
        return pol


def kernel_mode(policy: TorchPolicy) -> Optional[str]:
    """The cap rule ``policy``'s own class declares for the whole-row
    kernel, or ``None`` (inherited declarations do not count)."""
    return vars(type(policy)).get("kernel_mode")


_TORCH_REGISTRY = PolicyRegistry(TorchPolicy, "torch")


def register_torch_policy(name: str, *aliases: str):
    """Class decorator: register a torch-policy factory under ``name``."""
    return _TORCH_REGISTRY.register(name, *aliases)


def get_torch_policy(name: str, **kwargs) -> TorchPolicy:
    return _TORCH_REGISTRY.get(name, **kwargs)


def torch_policies() -> List[str]:
    return _TORCH_REGISTRY.names()


@register_torch_policy("equal-share", "equal_share")
class TorchEqualShare(TorchPolicy):
    """Static P/n caps — the base class is the whole policy."""

    name = "equal-share"
    kernel_mode = "nominal"


@register_torch_policy("ilp")
class TorchIlpStatic(TorchPolicy):
    """Static per-job ILP caps, gathered at each lane's current job.

    Gathering ``caps_job[cur]`` every wave gives the event backends'
    physics (non-running lanes draw idle power whatever their cap).
    ``assignments`` is one pre-solved
    :class:`~repro_torch.core.ilp.PowerAssignment` per row (any object
    with a ``bounds_w`` mapping); missing entries are solved in
    ``init_state``, once per unique (graph, bound).
    """

    name = "ilp"
    kernel_mode = "job_caps"
    use_makespan_milp = False

    def __init__(self, assignments: Optional[Sequence] = None,
                 time_limit: float = 60.0):
        self.assignments = assignments
        self.time_limit = time_limit

    def _solve(self, sim, row: int, bound_w: float):
        from repro_torch.core.ilp import build_makespan_milp, solve_paper_ilp

        solver = (build_makespan_milp if self.use_makespan_milp
                  else solve_paper_ilp)
        return solver(sim.row_graphs[row], sim.row_specs[row], bound_w,
                      time_limit=self.time_limit)

    def init_state(self, sim) -> Dict[str, np.ndarray]:
        j = sim.n_jobs_total
        resolved = resolve_assignments(
            sim.bounds, self.assignments,
            lambda row, bound: self._solve(sim, row, bound),
            graphs=sim.row_graphs)
        caps_job = np.zeros((sim.n_rows, j + 1))
        for b, assignment in enumerate(resolved):
            for k, jid in enumerate(sim.row_job_ids[b]):
                caps_job[b, k] = assignment.bounds_w[jid]
            # sentinel slot: exhausted lanes gather the nominal share
            caps_job[b, j] = sim.bounds[b] / sim.n_active[b]
        return {"caps_job": caps_job}

    @staticmethod
    def caps_fn(ctx, st, pol) -> torch.Tensor:
        return pol["caps_job"].gather(1, current_jobs(ctx, st))


@register_torch_policy("ilp-makespan")
class TorchIlpMakespan(TorchIlpStatic):
    name = "ilp-makespan"
    kernel_mode = "job_caps"
    use_makespan_milp = True

    def __init__(self, assignments: Optional[Sequence] = None,
                 time_limit: float = 120.0):
        super().__init__(assignments=assignments, time_limit=time_limit)


@register_torch_policy("oracle")
class TorchOracle(TorchPolicy):
    """Zero-latency clairvoyant water-filling: the fused power step
    reclaims non-running lanes' idle draw and water-fills the rest every
    wave, so ``caps_fn`` is never consulted for physics."""

    name = "oracle"
    redistribute = True
    kernel_mode = "redistribute"


@register_torch_policy("heuristic")
class TorchOnlineHeuristic(TorchPolicy):
    """Tick-quantized online redistribution.

    Each due tick water-fills the row's bound (minus the idle draw of
    lanes not running) over the running lanes and pushes the target into
    a per-row ring buffer ``(B, delay + 1, N)``; the caps applied are the
    target from ``delay`` ticks ago (report + distribute latency rounded
    to whole ticks), which reproduces the paper's transient surges above
    the bound.  ``exact=False``: the control plane is quantized to ``dt``.
    """

    name = "heuristic"
    exact = False
    wants_ticks = True
    kernel_mode = "heuristic"

    def init_state(self, sim) -> Dict[str, np.ndarray]:
        delay = max(1, int(round(2.0 * sim.latency_s / sim.dt)))
        b, n = sim.n_rows, sim.arrays.n_nodes
        nominal = np.asarray(sim.bounds)[:, None] / \
            np.asarray(sim.n_active)[:, None]
        return {
            "buf": np.zeros((b, delay + 1, n)),
            "cap": np.repeat(nominal, n, axis=1),
        }

    @staticmethod
    def caps_fn(ctx, st, pol) -> torch.Tensor:
        return pol["cap"]

    @staticmethod
    def tick_fn(ctx, st, pol, due):
        # The ring depth is delay + 1.  The row's tick index is
        # st.tick_count, which the engine increments after this call
        # (pre-increment slot, post-increment ripe check).
        buf = pol["buf"]
        b, depth, n = buf.shape
        delay = depth - 1
        # summed in the kernel's warp order, so every engine path agrees
        idle_draw = row_sum(torch.where(st.running, 0.0, ctx.tab.idle_w))
        budget = st.bound.unsqueeze(-1) - idle_draw
        target = waterfill(ctx.tab, st.running.to(budget.dtype), budget,
                           impl=ctx.impl)
        slot = st.tick_count % depth
        slots = torch.arange(depth, device=buf.device)
        hit = (slots.unsqueeze(0) == slot.unsqueeze(-1)) & due.unsqueeze(-1)
        buf = torch.where(hit.unsqueeze(-1), target.unsqueeze(1), buf)
        ticks = st.tick_count + 1
        ripe = due & (ticks > delay)
        slot2 = (ticks - 1 - delay) % depth
        old = buf.gather(1, slot2.view(b, 1, 1).expand(b, 1, n)).squeeze(1)
        cap = torch.where(ripe.unsqueeze(-1), old, pol["cap"])
        return {"buf": buf, "cap": cap}


class _TorchXP:
    """The array namespace the learned policy's xp-generic math
    (:mod:`repro_torch.policies.learned`) calls, on torch tensors: the
    names where torch's spelling or argument types differ from numpy's
    (``maximum`` with a float, ``max`` with ``axis``/``keepdims``,
    ``stack`` with ``axis``), and the two sums in the order of the
    kernel's ``learned`` mode (``csrc/power_step.cu``): ``lane_sum`` is
    :func:`~repro_torch.kernels.power_step.row_sum` over the last axis
    (the warp's order, in which zero padding lanes add nothing) and
    ``matmul`` sums each output's products in ascending input order,
    rounding every product and every sum, where ``@`` would take BLAS's
    order."""

    exp = staticmethod(torch.exp)
    tanh = staticmethod(torch.tanh)
    where = staticmethod(torch.where)
    ones_like = staticmethod(torch.ones_like)

    @staticmethod
    def maximum(a: torch.Tensor, b) -> torch.Tensor:
        return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype,
                                                device=a.device))

    @staticmethod
    def max(a: torch.Tensor, axis: int, keepdims: bool = False):
        return torch.amax(a, dim=axis, keepdim=keepdims)

    @staticmethod
    def stack(tensors, axis: int = 0) -> torch.Tensor:
        return torch.stack(list(tensors), dim=axis)

    @staticmethod
    def lane_sum(x: torch.Tensor) -> torch.Tensor:
        return row_sum(x.reshape(-1, x.shape[-1])).reshape(x.shape[:-1])

    @staticmethod
    def matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``a @ w`` for ``w`` ``(F, H)`` or ``(F,)``: the products of
        each output summed in ascending ``F``, each rounded on its own."""
        def term(k):
            return a[..., k:k + 1] * w[k] if w.dim() == 2 else \
                a[..., k] * w[k]

        out = term(0)
        for k in range(1, a.shape[-1]):
            out = out + term(k)
        return out


@register_torch_policy("learned")
class TorchLearned(TorchPolicy):
    """Gradient-trained MLP cap split, recomputed every wave.

    The math is the shared xp-generic core of
    :mod:`repro_torch.policies.learned` called with torch (float32, the
    engine's type), so the trained parameters mean the same thing as in
    the event and vector adapters.  Waves land exactly on state
    transitions, so recomputing the split at the top of each wave is the
    event adapter's recompute-on-every-edge.  The weights are shared by
    every row, so its state leaves carry no row axis.  Its kernel mode,
    ``"learned"``, runs the same MLP and masked softmax inside the
    whole-row kernel, in the order the torch namespace spells.
    ``exact=False``: float32 rounding can flip an LUT state against the
    float64 event adapter.
    """

    name = "learned"
    exact = False
    kernel_mode = "learned"

    def __init__(self, checkpoint: Optional[str] = None):
        from repro_torch.policies.learned import load_checkpoint

        self.params = load_checkpoint(checkpoint)

    def init_state(self, sim) -> Dict[str, np.ndarray]:
        return {f"mlp_{k}": np.asarray(v) for k, v in self.params.items()}

    def take_state_rows(self, state: Dict[str, np.ndarray],
                        rows: np.ndarray) -> Dict[str, np.ndarray]:
        """The weights go whole to every shard."""
        return state

    @staticmethod
    def caps_fn(ctx, st, pol) -> torch.Tensor:
        from repro_torch.policies.learned import compute_caps

        params = {k[4:]: v for k, v in pol.items() if k.startswith("mlp_")}
        rho = ctx.rho_pad.gather(1, current_jobs(ctx, st))
        lanes = rho.shape
        return compute_caps(
            _TorchXP, params, running=st.running,
            rho=torch.where(st.running, rho, 0.0), bound=st.bound,
            n_active=ctx.n_active.to(rho.dtype),
            p_max=ctx.tab.p_max.expand(lanes),
            cap_floor=ctx.tab.cap_floor.expand(lanes),
            idle_w=ctx.tab.idle_w.expand(lanes))
