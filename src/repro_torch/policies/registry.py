"""String-keyed policy registries.

``register_policy("name")`` decorates a
:class:`~repro_torch.policies.base.PowerPolicy` subclass (or any
keyword-arg factory); ``get_policy("name", **kwargs)`` builds a fresh
instance.  The event simulator and the sweep engine resolve event
policies through this table.  The vector policies
(:mod:`repro_torch.policies.vector`) and the torch engine's policies
(:mod:`repro_torch.backends.policies`) each keep a table of the same
shape: :class:`PolicyRegistry` is the one implementation behind all
three.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from .base import PowerPolicy


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


_EVENT = PolicyRegistry(PowerPolicy)


def register_policy(name: str, *aliases: str):
    """Class decorator: register a policy factory under ``name`` (+aliases)."""
    return _EVENT.register(name, *aliases)


def get_policy(name: str, **kwargs) -> PowerPolicy:
    """Instantiate a registered event policy by key."""
    return _EVENT.get(name, **kwargs)


def available_policies() -> List[str]:
    return _EVENT.names()
