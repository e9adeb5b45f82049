"""Dirichlet exponential family over mixture weights π (``svax/expfam/dirichlet.py``).

Natural parameter ``η = α − 1``; sufficient statistic ``log π``;
``A(α) = Σ lgamma(α_k) − lgamma(Σ α_k)``, whose gradient is ``E[log π]``.
"""

from __future__ import annotations

import torch


def natural_to_standard(nat: torch.Tensor) -> torch.Tensor:
    """η (…, K) → α = η + 1."""
    return nat + 1.0


def expected_log_pi(alpha: torch.Tensor) -> torch.Tensor:
    """E[log π_k] = ψ(α_k) − ψ(Σ_j α_j); alpha (…, K)."""
    return torch.special.digamma(alpha) - torch.special.digamma(
        alpha.sum(dim=-1, keepdim=True)
    )


def log_partition(alpha: torch.Tensor) -> torch.Tensor:
    """A(α) = Σ_k lgamma(α_k) − lgamma(Σ_k α_k); reduces the trailing axis."""
    return torch.lgamma(alpha).sum(dim=-1) - torch.lgamma(alpha.sum(dim=-1))


def kl(alpha_q: torch.Tensor, alpha_p: torch.Tensor) -> torch.Tensor:
    """KL(Dir(α_q) ‖ Dir(α_p)) in Bregman form:
    ⟨α_q − α_p, E_q[log π]⟩ − A(α_q) + A(α_p)."""
    elogpi = expected_log_pi(alpha_q)
    return (
        ((alpha_q - alpha_p) * elogpi).sum(dim=-1)
        - log_partition(alpha_q)
        + log_partition(alpha_p)
    )
