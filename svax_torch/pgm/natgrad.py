"""CVI natural-gradient update for conjugate globals (``svax/pgm/natgrad.py``)."""

from __future__ import annotations

from typing import Any


def _map(fn, *trees):
    """Leaf-wise map over matching NamedTuple trees of tensors."""
    head = trees[0]
    if isinstance(head, tuple):
        return type(head)(*(_map(fn, *parts) for parts in zip(*trees)))
    return fn(*trees)


def cvi_update(nat: Any, prior: Any, increment: Any, rho) -> Any:
    """η ← (1−ρ)η + ρ(η₀ + Δ), applied leaf-wise over matching trees.

    The increment must already be scaled by N/M (Khan & Lin 2017: with
    such increments this is the natural gradient of the ELBO in η)."""
    return _map(
        lambda e, e0, d: (1.0 - rho) * e + rho * (e0 + d), nat, prior, increment
    )
