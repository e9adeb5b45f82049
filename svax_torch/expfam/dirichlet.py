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


def sample_gamma(generator: torch.Generator, conc: torch.Tensor) -> torch.Tensor:
    """Gamma(conc, 1) draws, elementwise, from ``generator`` (on conc's
    device): Marsaglia–Tsang's squeeze on conc + 1 where conc < 1, boosted
    by U^(1/conc). Each round draws a normal and a uniform for every
    element and keeps the first accepted value, so the draws depend on the
    generator alone."""
    boost = conc < 1.0
    a = torch.where(boost, conc + 1.0, conc)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(conc)
    todo = torch.ones_like(conc, dtype=torch.bool)
    kw = dict(generator=generator, device=conc.device, dtype=conc.dtype)
    while bool(todo.any()):
        x = torch.randn(conc.shape, **kw)
        v = (1.0 + c * x) ** 3
        u = torch.rand(conc.shape, **kw)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(torch.finfo(conc.dtype).tiny)))
        out = torch.where(todo & ok, d * v, out)
        todo = todo & ~ok
    u = torch.rand(conc.shape, **kw)
    return torch.where(boost, out * u ** (1.0 / conc), out)


def sample(generator: torch.Generator, alpha: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """Draw π ~ Dir(α) as normalised Gamma(α_k) draws; returns shape + alpha.shape."""
    g = sample_gamma(generator, alpha.expand(tuple(shape) + tuple(alpha.shape)))
    return g / g.sum(dim=-1, keepdim=True)
