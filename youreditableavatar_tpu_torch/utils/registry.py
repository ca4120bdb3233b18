"""String → class registry decoupling config names from implementations.

Counterpart of `youreditableavatar_tpu/utils/registry.py`: components
register under a stable string name and are looked up when a config names
them, with collision checking.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Type

_REGISTRY: Dict[str, Type[Any]] = {}


def register(name: str) -> Callable[[Type[Any]], Type[Any]]:
    """Class decorator: ``@register("tetgs-init-trainer")``."""

    def decorator(cls: Type[Any]) -> Type[Any]:
        existing = _REGISTRY.get(name)
        if existing is not None and existing is not cls:
            raise ValueError(
                f"registry name {name!r} already bound to {existing.__qualname__}"
            )
        _REGISTRY[name] = cls
        cls.registry_name = name
        return cls

    return decorator


def find(name: str) -> Type[Any]:
    """Look up a registered class by name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY)) or "<empty>"
        raise KeyError(f"unknown component {name!r}; registered: {known}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)
