"""COUNTDOWN-style timeout/slack policy (arXiv 1806.07258, 1909.12684).

COUNTDOWN reduces a core's frequency during MPI phases, but only after a
timeout filters out phases too short to be worth the DVFS transition —
the same rent-vs-buy logic as the paper's §VII-A2 debounce, applied on
the node itself instead of at the report manager.  Translated to this
simulator's cluster-bound setting:

  * every node nominally holds its equal share p_o;
  * when a node reports Blocked, a per-node countdown of ``timeout_s``
    starts; if the node is still blocked when it expires, the node's
    share is *reclaimed*: its cap drops to the duty floor and the freed
    watts are split equally among the currently running nodes (clamped
    to their LUT envelopes);
  * when a reclaimed node reports Running again, its share is restored
    and the boosts are withdrawn.

Unlike Algorithm 1 there is no online dependency graph and no blocker
ranking — reclamation is purely local and timeout-driven, which is
exactly the kind of policy the pre-refactor simulator could not express
without growing new event branches.  Distribute messages still pay the
controller->node latency of the cluster view.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional

from repro_torch.core.block_detector import NodeState, ReportMessage

from .base import Action, ClusterView, PowerPolicy, SetCap, Wake
from .registry import register_policy


@register_policy("countdown")
class CountdownPolicy(PowerPolicy):
    name = "countdown"

    def __init__(self, timeout_s: Optional[float] = None):
        #: None -> default to the report/distribute round-trip time, the
        #: same break-even the paper's debounce uses.
        self.timeout_s = timeout_s
        self._view: ClusterView | None = None
        self._running: Dict[int, bool] = {}
        self._reclaimed: set[int] = set()
        self._timer_ver: Dict[int, int] = {}
        self._last_sent: Dict[int, float] = {}
        self._messages = 0
        self._distributes = 0

    def on_start(self, view: ClusterView) -> List[Action]:
        self._view = view
        if self.timeout_s is None:
            self.timeout_s = 2.0 * view.latency_s
        self._running = {n: True for n in view.node_ids}
        self._timer_ver = {n: 0 for n in view.node_ids}
        return []

    # ------------------------------------------------------------- events
    def on_report(self, report: ReportMessage, now: float) -> List[Action]:
        self._messages += 1
        node = report.node
        self._timer_ver[node] += 1
        if report.state == NodeState.BLOCKED:
            self._running[node] = False
            return [Wake(now + self.timeout_s,
                         ("timeout", node, self._timer_ver[node]))]
        self._running[node] = True
        restored = node in self._reclaimed
        self._reclaimed.discard(node)
        # A resumed node always needs its share back; reclaimed or not,
        # the boost split over running nodes changed, so rebalance.
        return self._rebalance() if (restored or self._reclaimed) \
            else self._set(node, self._view.p_o)

    def on_wake(self, token: Hashable, now: float) -> List[Action]:
        _kind, node, ver = token
        if ver != self._timer_ver[node] or self._running[node]:
            return []  # unblocked (or re-blocked) before the countdown hit
        self._reclaimed.add(node)
        return self._rebalance()

    def on_bound_change(self, bound_w: float, now: float) -> List[Action]:
        # ClusterView is frozen; rebuild it around the new bound.
        from dataclasses import replace

        self._view = replace(self._view, bound_w=bound_w)
        return self._rebalance(force=True)

    # ---------------------------------------------------------- internals
    def _floor(self, node: int) -> float:
        return self._view.clamp(node, 0.0)

    def _rebalance(self, force: bool = False) -> List[Action]:
        view = self._view
        p_o = view.p_o
        running = [n for n, r in self._running.items() if r]
        freed = sum(p_o - self._floor(n) for n in self._reclaimed)
        boost = freed / len(running) if running else 0.0
        actions: List[Action] = []
        for n in view.node_ids:
            if n in self._reclaimed:
                cap = self._floor(n)
            elif self._running[n]:
                cap = view.clamp(n, p_o + boost)
            else:
                cap = p_o  # blocked but countdown still pending
            actions.extend(self._set(n, cap, force=force))
        return actions

    def _set(self, node: int, cap_w: float,
             force: bool = False) -> List[Action]:
        if not force and abs(self._last_sent.get(node, -1.0) - cap_w) < 1e-9:
            return []  # Algorithm-1-line-42-style "only if changed" guard
        self._last_sent[node] = cap_w
        self._distributes += 1
        return [SetCap(node, cap_w, delay_s=self._view.latency_s)]

    def stats(self) -> Dict[str, int]:
        return {"messages": self._messages,
                "distributes": self._distributes, "suppressed": 0}
