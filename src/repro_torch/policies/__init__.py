"""Pluggable power-distribution policies: the port's copies of the
reference's event policies, their vector adapters, the learned policy,
the policy registries and ILP assignment resolution.

Registered event keys:

  ``equal-share``  — static P/n caps (paper baseline)
  ``ilp``          — static per-job caps from the §IV ILP (self-solving
                     when no pre-solved assignment is supplied)
  ``ilp-makespan`` — same, from the exact-makespan MILP
  ``heuristic``    — Algorithm 1 online controller + §VII-A2 debounce
  ``countdown``    — COUNTDOWN-style per-node timeout slack reclamation
  ``oracle``       — zero-latency clairvoyant water-filling upper bound
  ``learned``      — gradient-trained MLP cap split

The torch engine's policies live in :mod:`repro_torch.backends.policies`.
"""

from .base import (Action, ClusterView, PowerPolicy,  # noqa: F401
                   SetCap, Wake)
from .registry import (available_policies, get_policy,  # noqa: F401
                       register_policy)

# Importing the implementation modules populates the registries.
from .countdown import CountdownPolicy  # noqa: F401,E402
from .equal_share import EqualSharePolicy  # noqa: F401,E402
from .ilp_static import IlpMakespanPolicy, IlpStaticPolicy  # noqa: F401,E402
from .learned import LearnedPolicy, VectorLearned  # noqa: F401,E402
from .online_heuristic import OnlineHeuristicPolicy  # noqa: F401,E402
from .oracle import OraclePolicy  # noqa: F401,E402
from .vector import (VectorEqualShare, VectorIlpStatic,  # noqa: F401,E402
                     VectorOnlineHeuristic, VectorOracle, VectorPolicy,
                     VectorStaticCaps, get_vector_policy, has_vector_policy,
                     register_vector_policy, vector_policies)

__all__ = [
    "Action", "ClusterView", "PowerPolicy", "SetCap", "Wake",
    "available_policies", "get_policy", "register_policy",
    "CountdownPolicy", "EqualSharePolicy", "IlpMakespanPolicy",
    "IlpStaticPolicy", "LearnedPolicy", "OnlineHeuristicPolicy",
    "OraclePolicy", "VectorEqualShare", "VectorIlpStatic",
    "VectorLearned", "VectorOnlineHeuristic", "VectorOracle",
    "VectorPolicy", "VectorStaticCaps", "get_vector_policy", "has_vector_policy",
    "register_vector_policy", "vector_policies",
]
