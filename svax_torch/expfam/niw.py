"""Normal-inverse-Wishart exponential family over (μ, Λ) (``svax/expfam/niw.py``).

Standard parameters per component ``(m, κ, Φ, ν)``: Σ ~ IW(Φ, ν),
μ|Σ ~ N(m, Σ/κ). Natural parameters (SURVEY.md §9.2):

    η₁ = κ m,  η₂ = κ,  η₃ = Φ + κ m mᵀ,  η₄ = ν + d + 2

so the conjugate update of Gaussian statistics (s₁, N, S₂) is additive,
Δη = (s₁, N, S₂, N). ∇_η A = (E[Λμ], −½E[μᵀΛμ], −½E[Λ], ½E[log|Λ|]).

The per-component Cholesky of Φ here is a batched ``torch.linalg`` call
(a few kernels for all K), not the entry-unrolled recurrence of
``ops.batched_linalg`` that the per-(n, k) combine uses: at d = 8 the
unrolled form is ~900 single-element kernels per expected-parameter map,
which bounded the per-step SVAE engine by its launches. Gradients reach η₃
symmetrised (torch.linalg's convention), where the unrolled form reads Φ's
lower triangle; the two agree on every symmetric perturbation.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_LOG_2 = math.log(2.0)
_LOG_2PI = math.log(2.0 * math.pi)


class NiwStandard(NamedTuple):
    """Standard NIW parameters, batched over leading axes (components)."""

    m: torch.Tensor  # (..., d)
    kappa: torch.Tensor  # (...,)
    phi: torch.Tensor  # (..., d, d)
    nu: torch.Tensor  # (...,)


class NiwNat(NamedTuple):
    """Natural NIW parameters (η₁..η₄)."""

    eta1: torch.Tensor  # (..., d) = κ m
    eta2: torch.Tensor  # (...,)   = κ
    eta3: torch.Tensor  # (..., d, d) = Φ + κ m mᵀ
    eta4: torch.Tensor  # (...,)   = ν + d + 2


class NiwExpectedStats(NamedTuple):
    """Expected sufficient statistics of q(μ, Λ)."""

    prec: torch.Tensor  # (..., d, d)  E[Λ]
    prec_mean: torch.Tensor  # (..., d) E[Λμ]
    quad: torch.Tensor  # (...,)       E[μᵀΛμ]
    logdet: torch.Tensor  # (...,)     E[log|Λ|]


def standard_to_natural(std: NiwStandard) -> NiwNat:
    mm = std.m[..., :, None] * std.m[..., None, :]
    d = std.m.shape[-1]
    return NiwNat(
        eta1=std.kappa[..., None] * std.m,
        eta2=std.kappa,
        eta3=std.phi + std.kappa[..., None, None] * mm,
        eta4=std.nu + d + 2.0,
    )


def natural_to_standard(nat: NiwNat) -> NiwStandard:
    d = nat.eta1.shape[-1]
    kappa = nat.eta2
    m = nat.eta1 / kappa[..., None]
    mm = m[..., :, None] * m[..., None, :]
    phi = nat.eta3 - kappa[..., None, None] * mm
    nu = nat.eta4 - d - 2.0
    return NiwStandard(m=m, kappa=kappa, phi=phi, nu=nu)


def _mv_digamma_sum(nu: torch.Tensor, d: int) -> torch.Tensor:
    """Σ_{i=1..d} ψ((ν + 1 − i)/2)."""
    total = torch.special.digamma(nu / 2.0)
    for i in range(2, d + 1):
        total = total + torch.special.digamma((nu + 1.0 - i) / 2.0)
    return total


def _chol_logdet(phi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, log|Φ|) for Φ = LLᵀ; a non-PSD Φ gives NaN, as the unrolled
    recurrence does, and no host sync (``cholesky_ex`` skips the check)."""
    chol, _ = torch.linalg.cholesky_ex(phi)
    return chol, 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(dim=-1)


def expected_stats(std: NiwStandard) -> NiwExpectedStats:
    """Expected sufficient statistics, one Cholesky of Φ per component."""
    d = std.m.shape[-1]
    chol, logdet_phi = _chol_logdet(std.phi)
    eye = torch.eye(d, dtype=chol.dtype, device=chol.device).expand_as(chol)
    chol_inv = torch.linalg.solve_triangular(chol, eye, upper=False)  # L⁻¹
    phi_inv = chol_inv.mT @ chol_inv
    phi_inv_m = (phi_inv @ std.m[..., None])[..., 0]
    nu = std.nu
    prec = nu[..., None, None] * phi_inv
    prec_mean = nu[..., None] * phi_inv_m
    quad = d / std.kappa + nu * (std.m * phi_inv_m).sum(dim=-1)
    logdet = _mv_digamma_sum(nu, d) + d * _LOG_2 - logdet_phi
    return NiwExpectedStats(prec=prec, prec_mean=prec_mean, quad=quad, logdet=logdet)


def expected_stats_nat(nat: NiwNat) -> NiwExpectedStats:
    return expected_stats(natural_to_standard(nat))


def log_partition(std: NiwStandard) -> torch.Tensor:
    """A(m, κ, Φ, ν), batched over leading component axes."""
    d = std.m.shape[-1]
    logdet_phi = _chol_logdet(std.phi)[1]
    return (
        torch.special.multigammaln(std.nu / 2.0, d)
        + 0.5 * std.nu * d * _LOG_2
        - 0.5 * std.nu * logdet_phi
        - 0.5 * d * torch.log(std.kappa)
        + 0.5 * d * _LOG_2PI
    )


def log_partition_nat(nat: NiwNat) -> torch.Tensor:
    """A(η); ∇_η A = (E[Λμ], −½E[μᵀΛμ], −½E[Λ], ½E[log|Λ|])."""
    return log_partition(natural_to_standard(nat))


def kl(q: NiwStandard, p: NiwStandard) -> torch.Tensor:
    """KL(q ‖ p) between NIW distributions, exp-family Bregman form.

    KL = ⟨λ_q − λ_p, E_q[T]⟩ − A_q + A_p with true naturals
    λ = (−½(Φ+κmmᵀ), κm, −½κ, (ν−d)/2) against T = (Λ, Λμ, μᵀΛμ, log|Λ|).
    """
    stats = expected_stats(q)

    def true_naturals(s: NiwStandard):
        d = s.m.shape[-1]
        mm = s.m[..., :, None] * s.m[..., None, :]
        lam_prec = -0.5 * (s.phi + s.kappa[..., None, None] * mm)
        lam_h = s.kappa[..., None] * s.m
        lam_quad = -0.5 * s.kappa
        lam_ld = 0.5 * (s.nu - d)
        return lam_prec, lam_h, lam_quad, lam_ld

    qp, qh, qq, ql = true_naturals(q)
    pp, ph, pq, pl = true_naturals(p)
    inner = (
        ((qp - pp) * stats.prec).sum(dim=(-2, -1))
        + ((qh - ph) * stats.prec_mean).sum(dim=-1)
        + (qq - pq) * stats.quad
        + (ql - pl) * stats.logdet
    )
    return inner - log_partition(q) + log_partition(p)


def kl_nat(q: NiwNat, p: NiwNat) -> torch.Tensor:
    return kl(natural_to_standard(q), natural_to_standard(p))


def sample(generator: torch.Generator, std: NiwStandard) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw (μ, Λ) ~ NIW(m, κ, Φ, ν) via the Bartlett decomposition, from
    ``generator`` (on the parameters' device).

    Λ = L A Aᵀ Lᵀ with L = chol(Φ⁻¹), A lower-triangular with A_ii =
    sqrt(χ²_{ν−i+1}) and N(0, 1) entries below the diagonal; then μ | Λ ~
    N(m, (κΛ)⁻¹). Batched over leading component axes. For generation and
    posterior-predictive checks, not the training path."""
    from svax_torch.expfam.dirichlet import sample_gamma
    from svax_torch.ops import batched_linalg as bl

    d = std.m.shape[-1]
    batch = tuple(std.m.shape[:-1])
    kw = dict(device=std.m.device, dtype=std.m.dtype)
    chol_v = bl.cholesky(bl.inv_psd(bl.cholesky(std.phi)))  # L Lᵀ = Φ⁻¹
    dfs = std.nu[..., None] - torch.arange(d, **kw)  # (..., d)
    diag = torch.sqrt(2.0 * sample_gamma(generator, dfs / 2.0))
    normals = torch.randn(batch + (d, d), generator=generator, **kw)
    a = torch.tril(normals, diagonal=-1) + torch.diag_embed(diag)
    la = chol_v @ a
    lam = la @ la.mT
    chol_kl = bl.cholesky(std.kappa[..., None, None] * lam)
    eps = torch.randn(tuple(std.m.shape), generator=generator, **kw)
    return std.m + bl.solve_triu_vec(chol_kl, eps), lam
