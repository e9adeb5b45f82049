"""Full-covariance multivariate Gaussian exponential family
(``svax/expfam/mvn.py``), in information form.

A Gaussian potential is a pair ``(h, J)`` with precision ``J = Σ⁻¹`` and
linear term ``h = Σ⁻¹ μ``, so ``log N(z) = hᵀz − ½ zᵀJz − A(h, J)`` with

    A(h, J) = ½ hᵀ J⁻¹ h − ½ log|J| + (d/2) log 2π .

Every solve goes through ``ops.batched_linalg``, as the reference's does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from svax_torch.ops import batched_linalg as bl

_LOG_2PI = math.log(2.0 * math.pi)


class GaussianNat(NamedTuple):
    """Natural/information parameters of a Gaussian: h = Σ⁻¹μ, prec = Σ⁻¹."""

    h: torch.Tensor  # (..., d)
    prec: torch.Tensor  # (..., d, d)


def standard_to_natural(mean: torch.Tensor, cov: torch.Tensor) -> GaussianNat:
    """(μ, Σ) → (h, J) by a Cholesky solve, no explicit inverse."""
    chol = bl.cholesky(cov)
    return GaussianNat(h=bl.cho_solve_vec(chol, mean), prec=bl.inv_psd(chol))


def natural_to_standard(nat: GaussianNat) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, J) → (μ, Σ)."""
    chol = bl.cholesky(nat.prec)
    return bl.cho_solve_vec(chol, nat.h), bl.inv_psd(chol)


def log_partition(nat: GaussianNat) -> torch.Tensor:
    """A(h, J) = ½ hᵀJ⁻¹h − ½ log|J| + (d/2) log 2π, batched over leading axes."""
    d = nat.h.shape[-1]
    chol = bl.cholesky(nat.prec)
    half_quad = 0.5 * (nat.h * bl.cho_solve_vec(chol, nat.h)).sum(dim=-1)
    return half_quad - 0.5 * bl.logdet_from_chol(chol) + 0.5 * d * _LOG_2PI


def log_prob(nat: GaussianNat, x: torch.Tensor) -> torch.Tensor:
    """log N(x | μ(h, J), Σ(h, J)) for x of shape (..., d)."""
    quad = torch.einsum("...i,...ij,...j->...", x, nat.prec, x)
    return (nat.h * x).sum(dim=-1) - 0.5 * quad - log_partition(nat)


def sample_from_precision(generator: torch.Generator, mean: torch.Tensor,
                          prec_chol: torch.Tensor, shape_prefix: tuple = (),
                          eps: torch.Tensor | None = None) -> torch.Tensor:
    """Reparameterised draw z = μ + L⁻ᵀε given L = chol(J) (Σ = L⁻ᵀL⁻¹).

    ``shape_prefix`` prepends sample axes; ε is ``eps`` when given (of
    shape ``shape_prefix + mean.shape``), else drawn from ``generator`` on
    mean's device. Gradients flow through μ and L."""
    shape = tuple(shape_prefix) + tuple(mean.shape)
    if eps is None:
        eps = torch.randn(shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return mean + bl.solve_triu_vec(prec_chol.expand(tuple(shape_prefix)
                                                     + tuple(prec_chol.shape)), eps)


def expected_stats(mean: torch.Tensor, cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """E[z] = μ and E[zzᵀ] = Σ + μμᵀ."""
    return mean, cov + mean[..., :, None] * mean[..., None, :]


def kl(q: GaussianNat, p: GaussianNat) -> torch.Tensor:
    """KL(q ‖ p) between Gaussians in information form (Bregman form):
    ⟨h_q − h_p, μ_q⟩ − ½⟨J_q − J_p, Σ_q + μ_qμ_qᵀ⟩ − A(q) + A(p)."""
    mean_q, cov_q = natural_to_standard(q)
    ezz = cov_q + mean_q[..., :, None] * mean_q[..., None, :]
    inner = ((q.h - p.h) * mean_q).sum(dim=-1) - 0.5 * ((q.prec - p.prec) * ezz).sum(
        dim=(-2, -1))
    return inner - log_partition(q) + log_partition(p)
