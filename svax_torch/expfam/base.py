"""The exponential-family module protocol (``svax/expfam/base.py``).

Every family module in ``svax_torch.expfam`` (``beta``, ``dirichlet``,
``mvn``, ``niw``) exposes the same functional surface over its own
parameter containers. Modules are modules, not classes: the protocol is
duck-typed over module attributes and checked by ``implements()``.

| Function | Contract |
|---|---|
| ``standard_to_natural`` / ``natural_to_standard`` | mutually inverse bijection |
| ``log_partition`` (+ ``log_partition_nat``) | cumulant A; ∇_η A = E[T] |
| ``kl`` | Bregman form ⟨λ_q−λ_p, E_q[T]⟩ − A_q + A_p |
"""

from __future__ import annotations

from types import ModuleType

_REQUIRED = ("standard_to_natural", "natural_to_standard", "log_partition", "kl")


def implements(module: ModuleType) -> bool:
    """True if ``module`` exposes the exponential-family surface."""
    return all(hasattr(module, name) for name in _REQUIRED)
