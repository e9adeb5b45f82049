"""Student-t mixture model (SMM) via Gamma scale augmentation (``svax/pgm/smm.py``).

Per component k: x | k, u ~ N(μ_k, (u Λ_k)⁻¹), u ~ Gamma(a₀, b₀) with
a₀ = b₀ = ν_dof/2, so integrating u out gives a Student-t with ν_dof
degrees of freedom. q(u | n, k) = Gamma(a, b_nk) with a = a₀ + d/2 and
b_nk = b₀ + ½E[(x−μ_k)ᵀΛ_k(x−μ_k)]; the responsibilities collapse the
u-subproblem's free energy:

    log r̃_nk ∝ E[logπ_k] + ½E[log|Λ_k|] − (d/2)log 2π
               + a₀ log b₀ + lnΓ(a) − lnΓ(a₀) − a log b_nk.

The NIW increments carry E[u]-weighted moments with the *count*
degrees-of-freedom increment: Δη = (Σ r E[u] x, Σ r E[u], Σ r E[u] xxᵀ, Σ r),
so Δη₂ ≠ Δη₄. As a₀ = b₀ → ∞, E[u] → 1 and everything reduces to the GMM.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from svax_torch.expfam.niw import NiwNat
from svax_torch.pgm import gmm
from svax_torch.pgm.gmm import GmmExpected, GmmNat

_LOG_2PI = math.log(2.0 * math.pi)


class SmmSuffStats(NamedTuple):
    """u-weighted sufficient statistics."""

    counts: torch.Tensor  # (K,)      Σ r            (→ Δη₄, Dirichlet)
    u_counts: torch.Tensor  # (K,)    Σ r E[u]       (→ Δη₂)
    mean_stat: torch.Tensor  # (K, d) Σ r E[u] x     (→ Δη₁)
    scatter_stat: torch.Tensor  # (K, d, d) Σ r E[u] xxᵀ (→ Δη₃)


def log_rho_constant(dof: float, d: int) -> float:
    """a₀ log b₀ + lnΓ(a) − lnΓ(a₀) with a₀ = b₀ = dof/2, a = a₀ + d/2,
    in double on the host."""
    a0 = 0.5 * dof
    a = a0 + 0.5 * d
    return a0 * math.log(a0) + math.lgamma(a) - math.lgamma(a0)


def _quad_form(x: torch.Tensor, exp: GmmExpected) -> torch.Tensor:
    """E[(x−μ_k)ᵀΛ_k(x−μ_k)] per (n, k)."""
    quad_x = torch.einsum("ni,kij,nj->nk", x, exp.prec, x)
    cross = x @ exp.prec_mean.T
    return quad_x - 2.0 * cross + exp.quad


def e_step_obs(x: torch.Tensor, exp: GmmExpected, dof: float = 4.0):
    """Responsibilities r (N, K), E[u] (N, K) and per-point evidence (N,)."""
    d = x.shape[-1]
    a0 = 0.5 * dof
    a = a0 + 0.5 * d
    b = a0 + 0.5 * _quad_form(x, exp)
    log_rho = (exp.log_pi + 0.5 * exp.logdet - 0.5 * d * _LOG_2PI
               + log_rho_constant(dof, d) - a * torch.log(b))
    evidence = torch.logsumexp(log_rho, dim=-1)
    resp = torch.exp(log_rho - evidence[:, None])
    return resp, a / b, evidence


def suff_stats_obs(x: torch.Tensor, resp: torch.Tensor, e_u: torch.Tensor,
                   scale: float = 1.0) -> SmmSuffStats:
    ru = resp * e_u
    return SmmSuffStats(
        counts=scale * resp.sum(dim=0),
        u_counts=scale * ru.sum(dim=0),
        mean_stat=scale * (ru.T @ x),
        scatter_stat=scale * torch.einsum("nk,ni,nj->kij", ru, x, x),
    )


def stats_to_nat(stats: SmmSuffStats) -> GmmNat:
    """Map SMM stats onto Dirichlet/NIW natural increments."""
    return GmmNat(
        dir_nat=stats.counts,
        niw_nat=NiwNat(eta1=stats.mean_stat, eta2=stats.u_counts,
                       eta3=stats.scatter_stat, eta4=stats.counts),
    )


def elbo_obs(x: torch.Tensor, nat: GmmNat, prior: GmmNat, dof: float = 4.0,
             scale: float = 1.0) -> tuple[torch.Tensor, dict]:
    """SMM evidence lower bound: scale · Σ_n lse_k log ρ̃_nk − KL_global."""
    _, _, evidence = e_step_obs(x, gmm.expected_params(nat), dof)
    local = scale * evidence.sum()
    klg = gmm.kl_global(nat, prior)
    return local - klg, {"local": local, "kl_global": klg}
