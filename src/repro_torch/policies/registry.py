"""String-keyed policy registry.

``register("name")`` decorates a policy class (or any keyword-arg
factory); ``get("name", **kwargs)`` builds a fresh instance.  The torch
engine's policies (:mod:`repro_torch.backends.policies`) keep their
table in one :class:`PolicyRegistry`.
"""

from __future__ import annotations

from typing import Callable, Dict, List


class PolicyRegistry:
    """One string-keyed factory table with registration + lookup.

    ``kind`` labels the table in error messages (``"torch"`` -> "no
    torch policy ...").  ``base_cls`` is what every factory must produce.
    """

    def __init__(self, base_cls: type, kind: str = ""):
        self.base_cls = base_cls
        self.kind = kind
        self._table: Dict[str, Callable] = {}

    def register(self, name: str, *aliases: str):
        """Class decorator: register a factory under ``name`` (+aliases)."""
        label = f"{self.kind} policy" if self.kind else "policy"

        def deco(factory: Callable):
            for key in (name, *aliases):
                if key in self._table:
                    raise ValueError(f"{label} {key!r} already registered")
                self._table[key] = factory
            return factory

        return deco

    def get(self, name: str, **kwargs):
        """Instantiate a registered policy by key."""
        try:
            factory = self._table[name]
        except KeyError:
            missing = (f"no {self.kind} policy" if self.kind
                       else "unknown policy")
            raise KeyError(f"{missing} {name!r}; "
                           f"available: {self.names()}") from None
        policy = factory(**kwargs)
        if not isinstance(policy, self.base_cls):
            raise TypeError(f"factory for {name!r} returned "
                            f"{type(policy)!r}, not a "
                            f"{self.base_cls.__name__}")
        return policy

    def __contains__(self, name: str) -> bool:
        return name in self._table

    def __getitem__(self, name: str) -> Callable:
        return self._table[name]

    def names(self) -> List[str]:
        return sorted(self._table)
