"""SVAE with a Student-t mixture (SMM) latent prior — the robust SVAE
(``svax/models/svae_smm.py``, the diagonal-head subset).

The scale augmentation of ``pgm.smm`` lifted to the latent space:

    z | k, u, θ ~ N(μ_k, (u Λ_k)⁻¹),   u ~ Gamma(a₀, b₀),  a₀ = b₀ = dof/2.

Mean-field structured posterior q(z, u, k | x) = r̃_nk q(z|n,k) q(u|n,k):

* q(z|n,k) = N(μ̃, J̃⁻¹) with J̃ = diag(Pₙ) + ū·E[Λ_k],
  μ̃ = J̃⁻¹(hₙ + ū·E[Λμ]_k)                 (the SIN combine, ū = E_q[u]);
* q(u|n,k) = Gamma(a, b) with a = a₀ + d/2, b = b₀ + ½·Q_nk,
  Q = E[(z−μ_k)ᵀΛ_k(z−μ_k)] under q(z)q(θ);
* log r̃ is the ū-scaled product-of-Gaussians log-normalizer plus E[log π_k]
  and the u-subproblem free energy; the per-point local term is the
  explicit Σ_k r̃ (A_nk − log r̃_nk), A_nk the per-component free energy —
  a valid bound for any r̃.

``config.smm_iters`` coordinate rounds (ū = 1 → z-update → u-update,
repeated) and a final z-update resolve the u–z coupling. The CVI payload
is the u-weighted latent moments (Σ r̃ū μ̃, Σ r̃ū, Σ r̃ū E[zzᵀ], Σ r̃) in
``pgm.smm.SmmSuffStats``, mapped by ``pgm.smm.stats_to_nat`` (re-exported
here for ``svae_step.make_train_step``, which picks this module when
``config.dof`` > 0). As dof → ∞ every
formula reduces to the GMM-prior SVAE.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from svax_torch.models import svae as svae_mod
from svax_torch.models.svae import SvaeConfig, SvaeOutputs, init_params  # noqa: F401
from svax_torch.nets import mlp as nets
from svax_torch.ops import batched_linalg as bl
from svax_torch.parallel import mesh
from svax_torch.pgm import gmm
from svax_torch.pgm.gmm import GmmExpected, GmmNat
from svax_torch.pgm.smm import SmmSuffStats, stats_to_nat  # noqa: F401  (re-export)

_LOG_2PI = math.log(2.0 * math.pi)


class SmmPosterior(NamedTuple):
    """Per-(n,k) structured posterior q(z|x,k) q(u|x,k) and weights."""

    mean: torch.Tensor  # (N, K, d) μ̃
    prec_chol: torch.Tensor  # (N, K, d, d) chol(J̃)
    cov: torch.Tensor  # (N, K, d, d) Σ̃
    log_resp: torch.Tensor  # (N, K)
    logdet_prec: torch.Tensor  # (N, K) log|J̃|
    e_u: torch.Tensor  # (N, K) E[u]
    e_log_u: torch.Tensor  # (N, K) E[log u]
    gamma_b: torch.Tensor  # (N, K) rate of q(u)


def gamma_constants(dof: float, d: int) -> tuple[float, float, float, float]:
    """(a₀, a, lnΓ-free constant of E[log p(u)], ψ(a)) in double on the host:
    a₀ = b₀ = dof/2, a = a₀ + d/2, the constant a₀ log b₀ − lnΓ(a₀)."""
    a0 = 0.5 * dof
    a = a0 + 0.5 * d
    psi_a = float(torch.special.digamma(torch.tensor(a, dtype=torch.float64)))
    return a0, a, a0 * math.log(a0) - math.lgamma(a0), psi_a


def _z_update(pot_h: torch.Tensor, pot_p: torch.Tensor, exp: GmmExpected,
              e_u: torch.Tensor):
    """q(z|n,k) given E[u]: the ū-scaled SIN combine on the diagonal
    encoder precision ``pot_p`` (N, d)."""
    d = pot_h.shape[-1]
    eye = torch.eye(d, dtype=pot_h.dtype, device=pot_h.device)
    prec = (pot_p[:, :, None] * eye)[:, None] + e_u[:, :, None, None] * exp.prec[None]
    h = pot_h[:, None, :] + e_u[:, :, None] * exp.prec_mean[None]
    chol = bl.cholesky(prec)
    mean = bl.cho_solve_vec(chol, h)
    return mean, chol, bl.inv_psd(chol), bl.logdet_from_chol(chol), h


def _quad_latent(mean: torch.Tensor, cov: torch.Tensor, exp: GmmExpected) -> torch.Tensor:
    """Q_nk = E[(z−μ_k)ᵀΛ_k(z−μ_k)] = tr(JΣ̃) + μ̃ᵀJμ̃ − 2μ̃ᵀh̄ + E[μᵀΛμ]."""
    tr = torch.einsum("kij,nkij->nk", exp.prec, cov)
    quad_mu = torch.einsum("nki,kij,nkj->nk", mean, exp.prec, mean)
    cross = torch.einsum("ki,nki->nk", exp.prec_mean, mean)
    return tr + quad_mu - 2.0 * cross + exp.quad[None, :]


def smm_combine(pot_h: torch.Tensor, pot_p: torch.Tensor, exp: GmmExpected,
                dof: float, num_iters: int = 2, envelope_grads: bool = False,
                comp_group=None) -> tuple[SmmPosterior, torch.Tensor]:
    """Coordinate-ascent u–z combine → (posterior, free_energy A (N, K)).

    ``num_iters`` u-updates (at least one), each after a z-update, ū
    starting at 1 (the GMM combine); then a final z-update so q(z) is
    optimal for the final q(u). ``envelope_grads`` detaches q(u) — ``b``
    and ū = a/b — so the backward skips the rounds (q(u) is at its
    coordinate optimum given q(z), where ∂bound/∂q(u) = 0); the final
    z-update and its Q_nk stay differentiated.

    ``log r̃`` is the SIN convention: the log-normalizer of the encoder
    Gaussian times the ū-scaled expected component message, plus E[log π_k]
    and −KL(q(u)‖p(u)); ``free_energy`` is A_nk = E[log p̄(z,u|k)π_k] +
    H[q(z|k)] + H[q(u|k)]. With ``comp_group``, ``exp`` is this rank's
    K-shard: the u–z rounds are per component, and the softmax normalises
    across the group (``gmm.lse_over_components``)."""
    d = pot_h.shape[-1]
    a0, a, log_pu_const, psi_a = gamma_constants(dof, d)
    b0 = a0
    e_u = torch.ones(pot_h.shape[:1] + exp.log_pi.shape, dtype=pot_h.dtype,
                     device=pot_h.device)
    for _ in range(max(num_iters, 1)):
        mean, _, cov, _, _ = _z_update(pot_h, pot_p, exp, e_u)
        gamma_b = b0 + 0.5 * _quad_latent(mean, cov, exp)
        e_u = a / gamma_b
    if envelope_grads:
        gamma_b = gamma_b.detach()
        e_u = a / gamma_b
    mean, chol, cov, logdet, h = _z_update(pot_h, pot_p, exp, e_u)
    quad = _quad_latent(mean, cov, exp)
    log_gb = torch.log(gamma_b)
    e_log_u = psi_a - log_gb

    # −KL(q(u)‖p(u)) = E[log p(u)] + H[q(u)], shared by both quantities.
    e_log_pu = log_pu_const + (a0 - 1.0) * e_log_u - b0 * e_u
    h_u = a - log_gb + math.lgamma(a) + (1.0 - a) * psi_a
    u_free = e_log_pu + h_u

    msg_const = (0.5 * d * e_log_u - 0.5 * d * _LOG_2PI + 0.5 * exp.logdet[None, :]
                 - 0.5 * e_u * exp.quad[None, :])
    log_rho = (exp.log_pi[None, :] + msg_const + 0.5 * (mean * h).sum(dim=-1)
               - 0.5 * logdet + u_free)
    if comp_group is None:
        log_resp = torch.log_softmax(log_rho, dim=-1)
    else:
        log_resp = log_rho - gmm.lse_over_components(log_rho, comp_group)[:, None]

    e_log_pz = (0.5 * d * e_log_u - 0.5 * d * _LOG_2PI + 0.5 * exp.logdet[None, :]
                - 0.5 * e_u * quad)
    h_z = 0.5 * d * (1.0 + _LOG_2PI) - 0.5 * logdet
    free_energy = exp.log_pi[None, :] + e_log_pz + h_z + u_free
    post = SmmPosterior(mean=mean, prec_chol=chol, cov=cov, log_resp=log_resp,
                        logdet_prec=logdet, e_u=e_u, e_log_u=e_log_u, gamma_b=gamma_b)
    return post, free_energy


def suff_stats_latent(post: SmmPosterior, scale: float) -> SmmSuffStats:
    """u-weighted latent moments → the SMM CVI payload."""
    resp = torch.exp(post.log_resp)
    ru = resp * post.e_u
    ezz = post.cov + post.mean[..., :, None] * post.mean[..., None, :]
    return SmmSuffStats(
        counts=scale * resp.sum(dim=0),
        u_counts=scale * ru.sum(dim=0),
        mean_stat=scale * torch.einsum("nk,nki->ki", ru, post.mean),
        scatter_stat=scale * torch.einsum("nk,nkij->kij", ru, ezz),
    )


def forward(nn_params: dict, pgm_nat: GmmNat, prior_nat: GmmNat, x: torch.Tensor,
            config: SvaeConfig, eps: torch.Tensor | None = None,
            generator: torch.Generator | None = None, *, seed: int | None = None,
            step: int = 0, comp_group=None) -> SvaeOutputs:
    """Full SMM-prior SVAE forward → structured ELBO + CVI payload.

    ``config.dof`` (> 0) is the Student-t degrees of freedom,
    ``config.smm_iters`` the u–z rounds. The signature is
    ``svae.forward``'s; ``eps`` (S, N, K, d) injects the noise, else it is
    drawn from ``generator``. As in the reference, the combine, sampling and
    decoder are the plain ones whatever ``fused_combine``, ``kernel_rng``
    and ``fused_mlp_decoder`` say (``seed`` and ``step`` are unused): a
    Bernoulli head runs ``bernoulli_loglik_decomposed`` in the config's
    compute dtype. ``comp_group``: component parallelism, as in
    ``svae.forward`` (the u–z rounds are K-local; the softmax normaliser,
    recon, the local term and the global KL are reduced over the group)."""
    if config.dof <= 0.0:
        raise ValueError("svae_smm.forward needs config.dof > 0 (the Student-t prior)")
    svae_mod.check_recon_mode(config, comp_group)
    n = x.shape[0]
    scale = config.num_total / n
    exp = gmm.expected_params(pgm_nat, comp_group)
    pot_h, pot_p = nets.encoder_apply(nn_params["encoder"], x)
    post, free_energy = smm_combine(pot_h, pot_p, exp, config.dof, config.smm_iters,
                                    envelope_grads=config.smm_envelope_grads,
                                    comp_group=comp_group)
    resp = torch.exp(post.log_resp)

    z = svae_mod.sample_posterior(post, config.num_samples, eps=eps, generator=generator)
    if config.likelihood == "bernoulli":
        loglik = nets.bernoulli_loglik_decomposed(
            nn_params["decoder"], z, x, compute_dtype=config.decoder_compute_dtype)
    else:
        mean, var = nets.decoder_apply(nn_params["decoder"], z)
        loglik = nets.gaussian_loglik(x[None, :, None, :], mean, var)
    recon = scale * (resp * loglik.mean(dim=0)).sum()

    # Σ_n Σ_k r̃ (A_nk − log r̃_nk): r̃ follows the SIN convention, so the
    # explicit sum (not a logsumexp collapse) is the bound.
    local = -scale * (resp * (free_energy - post.log_resp)).sum()
    if comp_group is not None:
        recon, local = mesh.psum(torch.stack([recon, local]), comp_group).unbind()
    global_kl = gmm.kl_global(pgm_nat, prior_nat, comp_group)
    return SvaeOutputs(
        elbo=recon - local - global_kl,
        recon=recon,
        local_kl=local,
        global_kl=global_kl,
        suff_stats=suff_stats_latent(post, scale),
        posterior=post,
    )
