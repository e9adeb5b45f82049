"""Beta exponential family over Bernoulli success probabilities θ
(``svax/expfam/beta.py``), the conjugate pair of the Bernoulli-mixture
baseline.

The (a, b) pair is stacked on the trailing axis, as the Dirichlet's α is.
Natural parameter ``η = (a − 1, b − 1)``; a Bernoulli observation x adds
``(x, 1 − x)``. ``A(a, b) = lgamma(a) + lgamma(b) − lgamma(a + b)``, whose
natural-parameter gradient is ``(E[log θ], E[log(1 − θ)])``.
"""

from __future__ import annotations

import torch


def standard_to_natural(ab: torch.Tensor) -> torch.Tensor:
    """(…, 2) stacked (a, b) → η = (a − 1, b − 1)."""
    return ab - 1.0


def natural_to_standard(nat: torch.Tensor) -> torch.Tensor:
    """η (…, 2) → (a, b) = η + 1."""
    return nat + 1.0


def expected_log_theta(ab: torch.Tensor) -> torch.Tensor:
    """(E[log θ], E[log(1 − θ)]) = (ψ(a) − ψ(a+b), ψ(b) − ψ(a+b)), stacked
    on the trailing axis."""
    return torch.special.digamma(ab) - torch.special.digamma(ab.sum(dim=-1, keepdim=True))


def mean(ab: torch.Tensor) -> torch.Tensor:
    """Posterior-predictive success probability E[θ] = a / (a + b)."""
    return ab[..., 0] / ab.sum(dim=-1)


def log_partition(ab: torch.Tensor) -> torch.Tensor:
    """A(a, b) = lgamma(a) + lgamma(b) − lgamma(a + b); reduces the pair axis."""
    return torch.lgamma(ab).sum(dim=-1) - torch.lgamma(ab.sum(dim=-1))


def log_partition_nat(nat: torch.Tensor) -> torch.Tensor:
    """A(η); ∇_η A = (E[log θ], E[log(1 − θ)])."""
    return log_partition(natural_to_standard(nat))


def kl(ab_q: torch.Tensor, ab_p: torch.Tensor) -> torch.Tensor:
    """KL(Beta(a_q, b_q) ‖ Beta(a_p, b_p)) in Bregman form."""
    return (((ab_q - ab_p) * expected_log_theta(ab_q)).sum(dim=-1)
            - log_partition(ab_q) + log_partition(ab_p))


def log_prob(ab: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """log Beta(θ | a, b) for θ ∈ (0, 1)."""
    a, b = ab[..., 0], ab[..., 1]
    return (a - 1.0) * torch.log(theta) + (b - 1.0) * torch.log1p(-theta) - log_partition(ab)
