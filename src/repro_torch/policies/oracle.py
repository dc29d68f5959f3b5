"""Clairvoyant oracle: the upper bound every online policy chases.

On *every* state transition the oracle instantly re-solves the power
split: the full cluster bound, minus the idle draw of non-running nodes,
is water-filled equally across the running nodes (equal split, clamp at
each LUT's p_max, re-spread the clamped surplus until it is absorbed).
No report latency, no debounce, no distribute latency — caps change at
the same simulation instant the state changes.

This is not achievable by a real controller (the paper's controller pays
a UDP round trip and must debounce); it exists to quantify how much of
the available headroom the online heuristic actually captures.  Within
the simulator's power model (blocked nodes draw idle power) it is the
best *bound-respecting* redistribution of a fixed cluster bound short of
solving the full scheduling problem per event.  Note one consequence:
the oracle never draws a joule above the bound, whereas the paper's
heuristic transiently surges past it when a boosted node unblocks before
the controller reclaims (§VII) — at very tight bounds that borrowed
power can let the heuristic finish *ahead* of the oracle.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.core.block_detector import NodeState, ReportMessage

from .base import Action, ClusterView, PowerPolicy, SetCap
from .registry import register_policy


@register_policy("oracle")
class OraclePolicy(PowerPolicy):
    name = "oracle"

    def __init__(self):
        self._view: ClusterView | None = None
        self._running: Dict[int, bool] = {}
        self._last_sent: Dict[int, float] = {}
        self._messages = 0
        self._distributes = 0

    def on_start(self, view: ClusterView) -> List[Action]:
        self._view = view
        self._running = {n: True for n in view.node_ids}
        return []

    def on_report(self, report: ReportMessage, now: float) -> List[Action]:
        self._messages += 1
        self._running[report.node] = report.state == NodeState.RUNNING
        return self._resolve()

    def on_bound_change(self, bound_w: float, now: float) -> List[Action]:
        from dataclasses import replace

        self._view = replace(self._view, bound_w=bound_w)
        return self._resolve(force=True)

    # ---------------------------------------------------------- internals
    def _resolve(self, force: bool = False) -> List[Action]:
        view = self._view
        running = [n for n, r in self._running.items() if r]
        idle_draw = sum(view.specs[n].lut.idle_w
                        for n in view.node_ids if n not in running)
        budget = view.bound_w - idle_draw
        caps = self._waterfill(running, budget)
        actions: List[Action] = []
        for n in view.node_ids:
            cap = caps.get(n, view.clamp(n, 0.0))
            if force or abs(self._last_sent.get(n, -1.0) - cap) > 1e-9:
                self._last_sent[n] = cap
                self._distributes += 1
                actions.append(SetCap(n, cap))  # zero latency: clairvoyant
        return actions

    def _waterfill(self, running: List[int], budget: float
                   ) -> Dict[int, float]:
        """Equal split over running nodes, clamped at p_max, surplus
        re-spread over the still-unclamped nodes until absorbed."""
        view = self._view
        caps: Dict[int, float] = {}
        open_set = list(running)
        remaining = budget
        while open_set:
            share = remaining / len(open_set)
            saturated = [n for n in open_set
                         if view.specs[n].lut.p_max <= share + 1e-12]
            if not saturated:
                for n in open_set:
                    caps[n] = view.clamp(n, share)
                break
            for n in saturated:
                caps[n] = view.specs[n].lut.p_max
                remaining -= caps[n]
                open_set.remove(n)
        return caps

    def stats(self) -> Dict[str, int]:
        return {"messages": self._messages,
                "distributes": self._distributes, "suppressed": 0}
