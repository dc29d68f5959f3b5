"""Per-row ILP assignment resolution shared by the ILP policies."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence


def resolve_assignments(bounds: Sequence[float],
                        assignments: Optional[Sequence],
                        solve: Callable[[int, float], object],
                        graphs: Optional[Sequence] = None) -> List[object]:
    """One :class:`~repro_torch.core.ilp.PowerAssignment` per batch row:
    the pre-solved entry when given, else ``solve(row, bound)`` once per
    unique (graph, bound) pair — the 9-dp-rounded bound alone when
    ``graphs`` is omitted (a shared single-graph batch), else keyed by
    the row graph's identity too (a padded mixed-shape batch)."""
    cache: Dict[tuple, object] = {}
    out: List[object] = []
    for b, bound in enumerate(bounds):
        assignment = assignments[b] if assignments is not None else None
        if assignment is None:
            key = (id(graphs[b]) if graphs is not None else None,
                   round(float(bound), 9))
            if key not in cache:
                cache[key] = solve(b, float(bound))
            assignment = cache[key]
        out.append(assignment)
    return out
