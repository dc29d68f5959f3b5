"""The paper's online controller (Algorithm 1, §V) as a policy.

This is a faithful re-packaging of what ``Simulator`` used to hard-wire:
per-node :class:`ReportManager` debouncing (§VII-A2 ski-rental), one-way
report latency to the central :class:`PowerDistributionController`, and
one-way distribute latency back to the nodes.  Timer tokens:

  ``("ctrl", msg)``   — a report message arriving at the controller;
  ``("rm_poll", n)``  — node n's report-manager break-even deadline.

The event timing is the reference's (``tests/test_torch_event_sim.py``
holds the copy to the reference's golden makespans)."""

from __future__ import annotations

from typing import Dict, Hashable, List

from repro_torch.core.block_detector import ReportManager, ReportMessage
from repro_torch.core.heuristic import PowerDistributionController

from .base import Action, ClusterView, PowerPolicy, SetCap, Wake
from .registry import register_policy


@register_policy("heuristic")
class OnlineHeuristicPolicy(PowerPolicy):
    name = "heuristic"

    def __init__(self, clamp_to_lut: bool = True):
        self.clamp_to_lut = clamp_to_lut
        self.controller: PowerDistributionController | None = None
        self.rms: Dict[int, ReportManager] = {}
        self.latency = 0.0

    def on_start(self, view: ClusterView) -> List[Action]:
        self.latency = view.latency_s
        rtt = 2.0 * view.latency_s
        specs = [view.specs[n] for n in view.node_ids]
        self.controller = PowerDistributionController(
            view.bound_w, len(view.node_ids), specs=specs,
            node_ids=view.node_ids, clamp_to_lut=self.clamp_to_lut)
        self.rms = {n: ReportManager(node=n, breakeven_s=rtt)
                    for n in view.node_ids}
        return []

    # ------------------------------------------------------- report plane
    def on_report(self, report: ReportMessage, now: float) -> List[Action]:
        rm = self.rms[report.node]
        actions: List[Action] = [Wake(now + self.latency, ("ctrl", m))
                                 for m in rm.offer(report, now)]
        deadline = rm.next_deadline()
        if deadline is not None:
            actions.append(Wake(deadline, ("rm_poll", report.node)))
        return actions

    def on_wake(self, token: Hashable, now: float) -> List[Action]:
        kind = token[0]
        if kind == "ctrl":
            return [SetCap(g.node, g.power_bound_w, delay_s=self.latency)
                    for g in self.controller.process_message(token[1])]
        # rm_poll: flush a debounced report whose break-even window passed
        rm = self.rms[token[1]]
        actions: List[Action] = [Wake(now + self.latency, ("ctrl", m))
                                 for m in rm.poll(now)]
        deadline = rm.next_deadline()
        if deadline is not None and deadline > now:
            actions.append(Wake(deadline, ("rm_poll", token[1])))
        return actions

    def on_bound_change(self, bound_w: float, now: float) -> List[Action]:
        return [SetCap(g.node, g.power_bound_w, delay_s=self.latency)
                for g in self.controller.rebalance(bound_w)]

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, int]:
        return {
            "messages": self.controller.messages_processed,
            "distributes": self.controller.distributes_sent,
            "suppressed": sum(rm.suppressed for rm in self.rms.values()),
        }
