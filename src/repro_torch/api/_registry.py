"""Shared string-registry mechanics for the api protocols.

One contract, four registries (controller, network model, energy model,
environment): case-insensitive names, an ``overwrite`` flag guarding
accidental re-registration with a ``ValueError``, and a ``KeyError`` that
lists the known names on a miss.  Keeping the mechanics here means a
contract change (say, name validation) lands in every registry at once.
"""
from __future__ import annotations

from typing import Callable


def register_in(registry: dict, kind: str, name: str, factory: Callable,
                overwrite: bool) -> None:
    key = name.lower()
    if key in registry and not overwrite:
        raise ValueError(f"{kind} {name!r} already registered")
    registry[key] = factory


def make_from(registry: dict, kind: str, list_fn: Callable, name: str,
              kwargs: dict):
    try:
        factory = registry[name.lower()]
    except KeyError:
        raise KeyError(f"unknown {kind} {name!r}; "
                       f"known: {list_fn()}") from None
    return factory(**kwargs)
