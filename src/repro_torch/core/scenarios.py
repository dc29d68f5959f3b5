"""Scenario families: reproducible parameterized sets of mixed scenarios.

The port's copy of the reference's ``repro.core.scenarios``: the same
seed gives the same members, bounds and cells.

The paper's evaluation sweeps many scenario *shapes* — NPB classes, skew
levels, cluster sizes, power bounds (Figs. 8-9) — and the related
systems it is compared against (COUNTDOWN's timeout reclamation,
EcoShift-style cap shifting) evaluate across heterogeneous job mixes and
time-varying power caps.  A :class:`ScenarioFamily` packages that kind
of evaluation as data: a seeded generator emits a list of
:class:`FamilyMember` workloads (graph + cluster + optional bound-step
schedule), and :meth:`ScenarioFamily.scenarios` crosses them with
per-member bound fractions and policies into plain
:class:`~repro_torch.core.sweep.Scenario` cells that any ``SweepEngine``
executor can run — the batched ones bucket the mixed shapes into padded
batches instead of degrading to per-scenario runs.

Bounds are specified as *fractions* of each member's useful range
(``min_feasible_cluster_bound`` .. ``max_useful_cluster_bound``), so one
family mixes 3-node Listing-2 graphs with 6-node MoE steps and every
cell still lands in its own cluster's interesting regime.  Bound-step
schedules are likewise relative: a member's ``bound_steps`` holds
``(time_s, fraction)`` pairs, scaled by each scenario's own bound at
build time (the paper's "power cap drops mid-run" case).

Example::

    >>> from repro_torch.core.scenarios import mixed_family
    >>> fam = mixed_family(seed=1)
    >>> len(fam.shapes()) >= 3          # >= 3 distinct (N, J) shapes
    True
    >>> cells = fam.scenarios()
    >>> len(cells) == len(fam.members) * len(fam.bound_fracs) \
            * len(fam.policies)
    True
    >>> any(s.bound_schedule for s in cells)    # dynamic-bound cells
    True
    >>> mixed_family(seed=1).scenarios()[0].bound_w == cells[0].bound_w
    True
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Iterable, List, Mapping, Sequence, Tuple, Union

from .graph import JobDependencyGraph
from .power import (NodeSpec, heterogeneous_cluster, homogeneous_cluster,
                    max_useful_cluster_bound, min_feasible_cluster_bound)
from .sweep import Scenario
from .workloads import (cg_like, ep_like, fork_join_graph, is_like,
                        layered_dag, mixed_members, moe_step_graph,
                        pipeline_graph)

#: Default policies for generated families: solver-free and implemented
#: on every backend, so a family sweeps compiled end-to-end by default.
DEFAULT_POLICIES = ("equal-share", "oracle")


@dataclass(frozen=True)
class FamilyMember:
    """One workload of a family: a graph on its own cluster.

    ``bound_steps`` is a tuple of ``(time_s, fraction)`` pairs: at
    ``time_s`` the scenario's cluster bound becomes ``fraction`` times
    its *initial* bound (so the same member describes "the cap drops to
    60% at t=20s" at every sweep bound).
    """

    name: str
    graph: JobDependencyGraph
    specs: Tuple[NodeSpec, ...]
    bound_steps: Tuple[Tuple[float, float], ...] = ()
    tags: Mapping[str, object] = field(default_factory=dict)

    @property
    def shape(self) -> Tuple[int, int]:
        """(nodes, jobs) — the member's batching shape class."""
        return (len(self.graph.nodes), len(self.graph.jobs))


class ScenarioFamily:
    """A named set of members crossed with bounds and policies.

    ``bound_fracs`` positions each member's sweep bounds inside its own
    cluster's ``[min_feasible, max_useful]`` watt range (0 = barely
    feasible, 1 = equal-share already runs flat-out); ``policies`` is
    any mix of registry keys.  :meth:`scenarios` emits the cross
    product as :class:`~repro_torch.core.sweep.Scenario` cells tagged with
    ``family`` / ``member`` / ``shape`` for later grouping.
    """

    def __init__(self, name: str, members: Sequence[FamilyMember],
                 bound_fracs: Sequence[float] = (0.15, 0.4, 0.8),
                 policies: Sequence[Union[str, object]] = DEFAULT_POLICIES,
                 latency_s: float = 0.05):
        if not members:
            raise ValueError("a scenario family needs at least one member")
        self.name = name
        self.members = list(members)
        self.bound_fracs = tuple(float(f) for f in bound_fracs)
        self.policies = tuple(policies)
        self.latency_s = float(latency_s)

    def __len__(self) -> int:
        return len(self.members) * len(self.bound_fracs) \
            * len(self.policies)

    @classmethod
    def from_corpus(cls, path, name: str = "traces",
                    bound_fracs: Sequence[float] = (0.15, 0.4, 0.8),
                    policies: Sequence[Union[str, object]] =
                    DEFAULT_POLICIES,
                    latency_s: float = 0.05,
                    strict: bool = True) -> "ScenarioFamily":
        """A family whose members are reconstructed from a directory of
        recorded MPI traces (the :mod:`repro_torch.traces` frontend) —
        each trace's graph on its own header-declared cluster, swept
        like any synthetic member.  See ``docs/traces.md``."""
        from repro_torch.traces import TraceCorpus

        corpus = TraceCorpus.from_dir(path, strict=strict)
        return corpus.family(name=name, bound_fracs=bound_fracs,
                             policies=policies, latency_s=latency_s)

    def shapes(self) -> List[Tuple[int, int]]:
        """Sorted distinct (nodes, jobs) shape classes in the family."""
        return sorted({m.shape for m in self.members})

    def member_bounds(self, member: FamilyMember) -> List[float]:
        """Absolute sweep bounds (watts) for one member's cluster."""
        lo = min_feasible_cluster_bound(member.specs)
        hi = max_useful_cluster_bound(member.specs)
        return [lo + f * (hi - lo) for f in self.bound_fracs]

    def scenarios(self) -> List[Scenario]:
        """The family as a flat scenario list (the SweepEngine input)."""
        out: List[Scenario] = []
        for m in self.members:
            for bound in self.member_bounds(m):
                schedule = tuple((t, frac * bound)
                                 for t, frac in m.bound_steps)
                for policy in self.policies:
                    out.append(Scenario(
                        name=f"{self.name}/{m.name}", graph=m.graph,
                        specs=m.specs, bound_w=bound, policy=policy,
                        latency_s=self.latency_s,
                        bound_schedule=schedule,
                        tags={"family": self.name, "member": m.name,
                              "shape": f"{m.shape[0]}x{m.shape[1]}",
                              **dict(m.tags)}))
        return out


def _cluster(rng: random.Random, n: int) -> Tuple[NodeSpec, ...]:
    """Coin-flip a homogeneous or mixed cluster of ``n`` nodes."""
    if rng.random() < 0.5:
        return tuple(homogeneous_cluster(n))
    return tuple(heterogeneous_cluster(n, seed=rng.randrange(1 << 16)))


def random_layered_family(seed: int = 0, n_members: int = 6,
                          policies: Sequence = DEFAULT_POLICIES,
                          bound_fracs: Sequence[float] = (0.15, 0.4, 0.8),
                          ) -> ScenarioFamily:
    """Random layered / fork-join DAGs at rng-chosen (N, layers) sizes."""
    rng = random.Random(seed)
    members = []
    for k in range(n_members):
        n = rng.randint(3, 6)
        if k % 2 == 0:
            g = layered_dag(n, layers=rng.randint(3, 6),
                            fan=rng.randint(1, 3),
                            skew=rng.uniform(0.2, 0.6),
                            seed=rng.randrange(1 << 16))
            kind = "layered"
        else:
            g = fork_join_graph(n, stages=rng.randint(2, 4),
                                skew=rng.uniform(0.3, 0.7),
                                seed=rng.randrange(1 << 16))
            kind = "forkjoin"
        members.append(FamilyMember(name=f"{kind}{k}-n{n}", graph=g,
                                    specs=_cluster(rng, n),
                                    tags={"kind": kind}))
    return ScenarioFamily(f"layered-s{seed}", members, policies=policies,
                          bound_fracs=bound_fracs)


def npb_family(seed: int = 0, klass: str = "A",
               nodes: Iterable[int] = (3, 4, 5),
               policies: Sequence = DEFAULT_POLICIES,
               bound_fracs: Sequence[float] = (0.15, 0.4, 0.8),
               ) -> ScenarioFamily:
    """Skewed NPB-analogue variants (IS/EP/CG) across cluster sizes."""
    rng = random.Random(seed)
    members = []
    for n in nodes:
        for kind, gen in (("is", is_like), ("ep", ep_like),
                          ("cg", cg_like)):
            g = gen(n, klass, seed=rng.randrange(1 << 16))
            members.append(FamilyMember(
                name=f"{kind}{klass}-n{n}", graph=g,
                specs=_cluster(rng, n), tags={"kind": kind,
                                              "class": klass}))
    return ScenarioFamily(f"npb{klass}-s{seed}", members,
                          policies=policies, bound_fracs=bound_fracs)


def lm_family(seed: int = 0, policies: Sequence = DEFAULT_POLICIES,
              bound_fracs: Sequence[float] = (0.15, 0.4, 0.8),
              ) -> ScenarioFamily:
    """Pipeline-parallel and MoE training-step graphs at several sizes."""
    rng = random.Random(seed)
    members = []
    for stages, micro in ((3, 4), (4, 6)):
        g = pipeline_graph(stages, micro, skew=rng.uniform(0.1, 0.3),
                           seed=rng.randrange(1 << 16))
        members.append(FamilyMember(
            name=f"pipe-s{stages}m{micro}", graph=g,
            specs=tuple(homogeneous_cluster(stages)),
            tags={"kind": "pipeline"}))
    for n, layers in ((4, 3), (6, 4)):
        g = moe_step_graph(n, layers=layers,
                           hot_factor=rng.uniform(2.0, 3.0),
                           seed=rng.randrange(1 << 16))
        members.append(FamilyMember(
            name=f"moe-n{n}l{layers}", graph=g,
            specs=tuple(homogeneous_cluster(n)), tags={"kind": "moe"}))
    return ScenarioFamily(f"lm-s{seed}", members, policies=policies,
                          bound_fracs=bound_fracs)


def mixed_family(seed: int = 0, policies: Sequence = DEFAULT_POLICIES,
                 bound_fracs: Sequence[float] = (0.15, 0.4, 0.8),
                 with_bound_steps: bool = True) -> ScenarioFamily:
    """The kitchen-sink family the benchmarks and acceptance tests use.

    Guarantees >= 3 distinct (N, J) shapes — Listing-2, an NPB-IS
    analogue, a random layered DAG, a fork-join, and an MoE step — and
    (by default) members whose cluster bound *drops and recovers*
    mid-run via relative ``bound_steps``, exercising the dynamic-bound
    path of every backend.
    """
    members = [FamilyMember(name, graph, specs, bound_steps=steps)
               for name, graph, specs, steps
               in mixed_members(seed, with_bound_steps)]
    return ScenarioFamily(f"mixed-s{seed}", members, policies=policies,
                          bound_fracs=bound_fracs)
