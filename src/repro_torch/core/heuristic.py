"""Online power-redistribution heuristic — the paper's Algorithm 1 (§V-B).

The controller keeps an *online dependency graph* G = (V, E) over nodes
(not jobs): an edge (v, u) means "v is blocked by u".  On every report
message it

  1. updates the sender's vertex (state, p_g) and its outgoing edges,
  2. sums the power gain of all blocked vertices into the budget epsilon,
  3. ranks running vertices by how many nodes they block (in-degree),
  4. redistributes: a running node of rank r gets  p_o + epsilon * r / t
     where t is the sum of ranks — double the blockers, double the boost,
  5. emits SendPowerBound messages only for nodes whose bound changed
     (Algorithm 1 line 42 guard).

Faithful deviations, documented:
  * when blocked nodes exist but no running node blocks anyone (t = 0 —
    Algorithm 1 would divide by zero), we split epsilon equally among
    running nodes so the budget is not wasted;
  * bounds are clamped to each node's LUT envelope [p_min, p_max] before
    sending — granting more power than a node can draw merely strands
    budget (the physical translator would clamp anyway).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .block_detector import (DistributeMessage, NodeState, ReportMessage)
from .power import NodeSpec


@dataclass
class _Vertex:
    node: int
    state: NodeState = NodeState.RUNNING
    power_gain_w: float = 0.0
    bound_w: Optional[float] = None  # last bound sent (None = p_o default)
    rank: int = 0
    blocked_by: Set[int] = field(default_factory=set)  # outgoing edges


class PowerDistributionController:
    """Central controller (Fig. 1) executing Algorithm 1."""

    def __init__(self, cluster_bound_w: float, n_nodes: int,
                 specs: Optional[Sequence[NodeSpec]] = None,
                 node_ids: Optional[Sequence[int]] = None,
                 clamp_to_lut: bool = True):
        self.cluster_bound_w = cluster_bound_w
        self.n = n_nodes
        self.p_o = cluster_bound_w / n_nodes  # Algorithm 1 line 3
        self._v: Dict[int, _Vertex] = {}
        self._specs: Dict[int, NodeSpec] = {}
        if specs is not None:
            ids = list(node_ids) if node_ids is not None else list(range(n_nodes))
            self._specs = {nid: specs[k] for k, nid in enumerate(ids)}
        self.clamp_to_lut = clamp_to_lut and bool(self._specs)
        self.messages_processed = 0
        self.distributes_sent = 0

    # ------------------------------------------------------------ Algorithm 1
    def process_message(self, alpha: ReportMessage) -> List[DistributeMessage]:
        """PROCESSMESSAGE (lines 4-21)."""
        self.messages_processed += 1
        v = self._v.get(alpha.node)
        if v is None:  # lines 5-7: AddVertex
            v = _Vertex(node=alpha.node)
            self._v[alpha.node] = v
        v.state = alpha.state                    # line 10
        v.power_gain_w = alpha.power_gain_w      # line 11
        self._update_edges(v, alpha.blockers)    # line 12 / lines 22-27

        epsilon = sum(u.power_gain_w for u in self._v.values()
                      if u.state == NodeState.BLOCKED)  # lines 13-18
        t = self._rank_graph()                   # line 19 / lines 28-37
        return self._distribute_power(epsilon, t)  # line 20 / lines 38-49

    def _update_edges(self, v: _Vertex, blockers) -> None:
        """UPDATEEDGES: clear v's outgoing edges, re-add from B."""
        v.blocked_by = set(blockers)

    def _rank_graph(self) -> int:
        """RANKGRAPH: rank of a running node = # nodes it is blocking."""
        incoming: Dict[int, int] = {n: 0 for n in self._v}
        for u in list(self._v.values()):
            if u.state == NodeState.BLOCKED:
                for b in u.blocked_by:
                    if b in incoming:
                        incoming[b] += 1
                    else:
                        incoming[b] = 1
                        # blocker we have never heard from: materialise it
                        self._v[b] = _Vertex(node=b)
        t = 0
        for u in self._v.values():
            if u.state == NodeState.RUNNING:
                u.rank = incoming.get(u.node, 0)
                t += u.rank
            else:
                u.rank = 0
        return t

    def _distribute_power(self, epsilon: float, t: int
                          ) -> List[DistributeMessage]:
        """DISTRIBUTEPOWER with the t=0 equal-split extension."""
        out: List[DistributeMessage] = []
        running = [u for u in self._v.values() if u.state == NodeState.RUNNING]
        for u in self._v.values():
            if u.state != NodeState.RUNNING:
                continue
            if t > 0:
                p_new = self.p_o + epsilon * u.rank / t   # line 41
            elif running:
                p_new = self.p_o + epsilon / len(running)
            else:
                p_new = self.p_o
            p_new = self._clamp(u.node, p_new)
            if u.bound_w is None or abs(u.bound_w - p_new) > 1e-9:  # line 42
                u.bound_w = p_new
                out.append(DistributeMessage(node=u.node,
                                             power_bound_w=p_new))
                self.distributes_sent += 1
        return out

    def _clamp(self, node: int, p: float) -> float:
        if not self.clamp_to_lut or node not in self._specs:
            return p
        from .power import cap_floor_w

        lut = self._specs[node].lut
        return min(max(p, cap_floor_w(lut)), lut.p_max)

    def rebalance(self, cluster_bound_w: Optional[float] = None
                  ) -> List[DistributeMessage]:
        """Re-run DISTRIBUTEPOWER from the current online graph, optionally
        under a new cluster bound (a power-bound arrival, §VI)."""
        if cluster_bound_w is not None:
            self.cluster_bound_w = cluster_bound_w
            self.p_o = cluster_bound_w / self.n
        epsilon = sum(u.power_gain_w for u in self._v.values()
                      if u.state == NodeState.BLOCKED)
        t = self._rank_graph()
        return self._distribute_power(epsilon, t)

    # ------------------------------------------------------------- inspection
    def budget_in_use(self) -> float:
        """Sum of bounds currently granted to running nodes + idle draw of
        blocked ones — audit that the controller respects the bound."""
        total = 0.0
        for u in self._v.values():
            if u.state == NodeState.RUNNING:
                total += u.bound_w if u.bound_w is not None else self.p_o
            else:
                spec = self._specs.get(u.node)
                total += spec.lut.idle_w if spec else 0.0
        return total

    def snapshot(self) -> Dict[int, Tuple[str, float, int]]:
        return {n: (v.state.value,
                    v.bound_w if v.bound_w is not None else self.p_o,
                    v.rank)
                for n, v in self._v.items()}
