"""Gaussian-mixture PGM: expected parameters, the observed-data E-step and
sufficient statistics (``svax/pgm/gmm.py``, the subset the SVAE and the
pure-mixture training paths use, with its component-parallel forms).

A Dirichlet(α) prior over mixing weights and one NIW prior per component,
batched over K along the leading axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from svax_torch.expfam import dirichlet, niw
from svax_torch.expfam.niw import NiwNat, NiwStandard
from svax_torch.parallel import mesh

_LOG_2PI = math.log(2.0 * math.pi)


class GmmNat(NamedTuple):
    """Global PGM natural parameters: q(π) Dirichlet and q(μ_k, Λ_k) NIW."""

    dir_nat: torch.Tensor  # (K,) Dirichlet natural α − 1
    niw_nat: NiwNat  # component-batched NIW naturals, leading axis K


class GmmExpected(NamedTuple):
    """Expected natural parameters — the VMP messages."""

    log_pi: torch.Tensor  # (K,)      E[log π]
    prec: torch.Tensor  # (K, d, d)   E[Λ]
    prec_mean: torch.Tensor  # (K, d) E[Λμ]
    quad: torch.Tensor  # (K,)        E[μᵀΛμ]
    logdet: torch.Tensor  # (K,)      E[log|Λ|]


class GmmSuffStats(NamedTuple):
    """Weighted sufficient statistics (SURVEY.md §9.5)."""

    counts: torch.Tensor  # (K,)      N_k = Σ_n r_nk
    mean_stat: torch.Tensor  # (K, d) s₁ = Σ_n r_nk E[z_n]
    scatter_stat: torch.Tensor  # (K, d, d) S₂ = Σ_n r_nk E[z_n z_nᵀ]


def expected_params(nat: GmmNat, group=None) -> GmmExpected:
    """Expected-parameter messages from the global naturals.

    With ``group`` (component parallelism), ``nat`` is this rank's K-shard:
    the NIW expectations are per component, and only the Dirichlet's ψ(Σα)
    needs the sum of α across the group (one SUM all-reduce)."""
    alpha = dirichlet.natural_to_standard(nat.dir_nat)
    stats = niw.expected_stats_nat(nat.niw_nat)
    if group is None:
        log_pi = dirichlet.expected_log_pi(alpha)
    else:
        total = mesh.psum(alpha.sum(dim=-1, keepdim=True), group)
        log_pi = torch.special.digamma(alpha) - torch.special.digamma(total)
    return GmmExpected(
        log_pi=log_pi,
        prec=stats.prec,
        prec_mean=stats.prec_mean,
        quad=stats.quad,
        logdet=stats.logdet,
    )


def lse_over_components(log_rho: torch.Tensor, group=None) -> torch.Tensor:
    """Row-wise logsumexp over the component axis, (N, K_local) → (N,),
    across ``group``'s K-shards when given: a MAX all-reduce of the
    detached row maxima (a constant shift: the value and the softmax
    gradient do not depend on it), then a SUM all-reduce of the shifted
    exp-sums, differentiable."""
    m = mesh.pmax_const(log_rho.max(dim=-1).values, group)
    se = mesh.psum(torch.exp(log_rho - m[:, None]).sum(dim=-1), group)
    return m + torch.log(se)


def make_prior(
    num_components: int,
    latent_dim: int,
    alpha: float = 1.0,
    mean: float = 0.0,
    kappa: float = 0.05,
    psi_scale: float = 1.0,
    nu: float | None = None,
    *,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> GmmNat:
    """Conjugate prior naturals (paper-typical defaults, SURVEY.md §4.5)."""
    k, d = num_components, latent_dim
    if nu is None:
        nu = d + 1.0
    kw = dict(device=device, dtype=dtype)
    std = NiwStandard(
        m=torch.full((k, d), mean, **kw),
        kappa=torch.full((k,), kappa, **kw),
        phi=(psi_scale * torch.eye(d, **kw)).expand(k, d, d).clone(),
        nu=torch.full((k,), nu, **kw),
    )
    return GmmNat(
        dir_nat=torch.full((k,), alpha - 1.0, **kw),
        niw_nat=niw.standard_to_natural(std),
    )


def init_variational(
    generator: torch.Generator,
    prior: GmmNat,
    data: torch.Tensor | None = None,
    mean_scale: float = 1.0,
    pseudo_counts: float = 1.0,
) -> GmmNat:
    """q's naturals as the prior plus ``pseudo_counts`` pseudo-observations
    per component, at a random data point (if ``data`` is given, drawn
    without replacement) or at N(0, mean_scale²). The increment is a valid
    sufficient-statistic bundle, so the result is a valid NIW natural.

    ``generator`` must live on the prior's device."""
    k = prior.dir_nat.shape[0]
    d = prior.niw_nat.eta1.shape[-1]
    ref = prior.niw_nat.eta1
    if data is None:
        locs = mean_scale * torch.randn(
            (k, d), generator=generator, device=ref.device, dtype=ref.dtype
        )
    else:
        idx = torch.randperm(
            data.shape[0], generator=generator, device=ref.device
        )[:k]
        locs = data[idx].to(ref.dtype)
    c = pseudo_counts
    outer = locs[:, :, None] * locs[:, None, :]
    eye = torch.eye(d, dtype=ref.dtype, device=ref.device)
    inc = NiwNat(
        eta1=c * locs,
        eta2=torch.full((k,), c, dtype=ref.dtype, device=ref.device),
        eta3=c * (outer + eye),
        eta4=torch.full((k,), c, dtype=ref.dtype, device=ref.device),
    )
    return GmmNat(
        dir_nat=prior.dir_nat + c,
        niw_nat=NiwNat(*(a + b for a, b in zip(prior.niw_nat, inc))),
    )


def log_responsibilities_obs(x: torch.Tensor, exp: GmmExpected) -> torch.Tensor:
    """Unnormalised log responsibilities for observed data, x (N, d) → (N, K):

    log ρ_nk = E[logπ_k] + ½E[log|Λ_k|] − ½(xᵀE[Λ]x − 2xᵀE[Λμ] + E[μᵀΛμ])
               − (d/2) log 2π.
    """
    d = x.shape[-1]
    quad_x = torch.einsum("ni,kij,nj->nk", x, exp.prec, x)
    cross = x @ exp.prec_mean.T
    return (exp.log_pi + 0.5 * exp.logdet
            - 0.5 * (quad_x - 2.0 * cross + exp.quad) - 0.5 * d * _LOG_2PI)


def e_step_obs(x: torch.Tensor, exp: GmmExpected) -> tuple[torch.Tensor, torch.Tensor]:
    """Responsibilities r (N, K) and per-point evidence lse_k log ρ (N,)."""
    log_rho = log_responsibilities_obs(x, exp)
    evidence = torch.logsumexp(log_rho, dim=-1)
    return torch.exp(log_rho - evidence[:, None]), evidence


def suff_stats_obs(x: torch.Tensor, resp: torch.Tensor, scale: float = 1.0) -> GmmSuffStats:
    """Weighted stats (N_k, Σ r x, Σ r xxᵀ) for observed data, × N/M scale."""
    return GmmSuffStats(
        counts=scale * resp.sum(dim=0),
        mean_stat=scale * (resp.T @ x),
        scatter_stat=scale * torch.einsum("nk,ni,nj->kij", resp, x, x),
    )


def suff_stats_from_moments(
    resp: torch.Tensor,
    ez: torch.Tensor,
    ezz: torch.Tensor,
    scale: float = 1.0,
) -> GmmSuffStats:
    """Weighted stats from per-(n,k) posterior moments (SVAE path, §9.5).

    resp (N, K); ez (N, K, d) = μ̃; ezz (N, K, d, d) = Σ̃ + μ̃μ̃ᵀ.
    """
    counts = resp.sum(dim=0)
    mean_stat = torch.einsum("nk,nki->ki", resp, ez)
    scatter_stat = torch.einsum("nk,nkij->kij", resp, ezz)
    return GmmSuffStats(
        counts=scale * counts,
        mean_stat=scale * mean_stat,
        scatter_stat=scale * scatter_stat,
    )


def stats_to_nat(stats: GmmSuffStats) -> GmmNat:
    """Map sufficient statistics onto natural-parameter increments (§9.5)."""
    return GmmNat(
        dir_nat=stats.counts,
        niw_nat=NiwNat(
            eta1=stats.mean_stat,
            eta2=stats.counts,
            eta3=stats.scatter_stat,
            eta4=stats.counts,
        ),
    )


def sample_generative(generator: torch.Generator, nat: GmmNat, num_samples: int,
                      sample_params: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Ancestral draws from the (posterior) mixture: returns (x, labels).

    With ``sample_params`` the mixture parameters are drawn from q(θ)
    (π ~ Dir, (μ_k, Λ_k) ~ NIW via Bartlett); otherwise the expected
    parameters E[π], m_k, E[Σ_k] are used (the plug-in). Every draw comes
    from ``generator`` (on the naturals' device)."""
    from svax_torch.ops import batched_linalg as bl

    alpha = dirichlet.natural_to_standard(nat.dir_nat)
    std = niw.natural_to_standard(nat.niw_nat)
    d = std.m.shape[-1]
    if sample_params:
        pi = dirichlet.sample(generator, alpha)
        mu, lam = niw.sample(generator, std)
        chol_lam = bl.cholesky(lam)
    else:
        pi = alpha / alpha.sum()
        mu = std.m
        cov = std.phi / torch.clamp_min(std.nu - d - 1.0, 0.5)[..., None, None]
        chol_lam = bl.cholesky(bl.inv_psd(bl.cholesky(cov)))
    labels = torch.multinomial(pi, num_samples, replacement=True, generator=generator)
    eps = torch.randn((num_samples, d), generator=generator, device=mu.device,
                      dtype=mu.dtype)
    return mu[labels] + bl.solve_triu_vec(chol_lam[labels], eps), labels


def kl_global(nat: GmmNat, prior: GmmNat, group=None) -> torch.Tensor:
    """KL(q(π)‖p(π)) + Σ_k KL(q(μ_k,Λ_k)‖p(μ_k,Λ_k)) (§9.6 global term).

    With ``group``, ``nat`` and ``prior`` are this rank's K-shards: the
    Dirichlet KL couples the shards through Σα only, the NIW KLs sum over
    them; two SUM all-reduces give the whole mixture's KL on every rank."""
    alpha_q = dirichlet.natural_to_standard(nat.dir_nat)
    alpha_p = dirichlet.natural_to_standard(prior.dir_nat)
    if group is None:
        kl_dir = dirichlet.kl(alpha_q, alpha_p)
        kl_niw = niw.kl_nat(nat.niw_nat, prior.niw_nat).sum()
        return kl_dir + kl_niw
    sum_q, sum_p = mesh.psum(torch.stack([alpha_q.sum(-1), alpha_p.sum(-1)]), group).unbind()
    elogpi = torch.special.digamma(alpha_q) - torch.special.digamma(sum_q)
    per_k = (alpha_q - alpha_p) * elogpi - torch.lgamma(alpha_q) + torch.lgamma(alpha_p)
    dir_sum, kl_niw = mesh.psum(torch.stack(
        [per_k.sum(-1), niw.kl_nat(nat.niw_nat, prior.niw_nat).sum()]), group).unbind()
    return dir_sum + torch.lgamma(sum_q) - torch.lgamma(sum_p) + kl_niw


def elbo_obs(x: torch.Tensor, nat: GmmNat, prior: GmmNat,
             scale: float = 1.0) -> tuple[torch.Tensor, dict]:
    """VB-GMM evidence lower bound on observed data (Bishop §10.2):
    ELBO = scale · Σ_n lse_k log ρ_nk − KL_global."""
    _, evidence = e_step_obs(x, expected_params(nat))
    local = scale * evidence.sum()
    klg = kl_global(nat, prior)
    return local - klg, {"local": local, "kl_global": klg}
