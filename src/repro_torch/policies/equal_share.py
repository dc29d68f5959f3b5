"""Equal-share baseline (paper's "Equal-share"): every node permanently
capped at P/n.  Purely static — its only dynamic behaviour is tracking
cluster-bound changes, where it re-splits the new bound evenly."""

from __future__ import annotations

from typing import List

from .base import Action, ClusterView, PowerPolicy, SetCap
from .registry import register_policy


@register_policy("equal-share", "equal_share")
class EqualSharePolicy(PowerPolicy):
    name = "equal-share"

    def __init__(self):
        self._view: ClusterView | None = None

    def on_start(self, view: ClusterView) -> List[Action]:
        self._view = view
        # The simulator pre-applies the nominal equal share; restating it
        # here keeps the policy correct even if that default ever changes.
        return [SetCap(n, view.p_o) for n in view.node_ids]

    def on_bound_change(self, bound_w: float, now: float) -> List[Action]:
        share = self._view.equal_share(bound_w)
        return [SetCap(n, share) for n in self._view.node_ids]
