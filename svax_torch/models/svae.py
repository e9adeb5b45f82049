"""Structured VAE: SIN combine, mixture reparam sampling, structured ELBO
(``svax/models/svae.py``, the weighted-recon Gaussian subset).

One forward pass computes, in closed form except the reconstruction Monte
Carlo: encoder potentials (h, P); the SIN combine with the expected GMM
naturals, J̃_nk = diag(Pₙ) + E[Λ_k], μ̃_nk = J̃⁻¹(hₙ + E[Λμ]_k); the
mixture responsibilities r̃; S reparameterised samples per (n, k) through
the decoder, weighted by r̃; the local KL; the global KL; and the CVI
sufficient statistics.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from svax_torch.nets import mlp as nets
from svax_torch.ops import batched_linalg as bl
from svax_torch.pgm import gmm
from svax_torch.pgm.gmm import GmmExpected, GmmNat, GmmSuffStats

_LOG_2PI = math.log(2.0 * math.pi)


class SvaeConfig(NamedTuple):
    """The SVAE configuration fields the pinwheel and auto training paths read.

    The port implements the Gaussian likelihood, the diagonal recognition
    head, weighted reconstruction and zero jitter; the reference's other
    switches are not ported yet (ROADMAP.md)."""

    latent_dim: int
    num_components: int
    num_samples: int = 1
    num_total: int = 1  # dataset size N for minibatch scaling


class SinPosterior(NamedTuple):
    """Per-(n,k) structured posterior q(z|x,k) and mixture weights."""

    mean: torch.Tensor  # (N, K, d) μ̃
    prec_chol: torch.Tensor  # (N, K, d, d) chol(J̃)
    cov: torch.Tensor  # (N, K, d, d) Σ̃ = J̃⁻¹
    log_resp: torch.Tensor  # (N, K) normalized log r̃
    logdet_prec: torch.Tensor  # (N, K) log|J̃|


class SvaeOutputs(NamedTuple):
    elbo: torch.Tensor
    recon: torch.Tensor
    local_kl: torch.Tensor
    global_kl: torch.Tensor
    suff_stats: GmmSuffStats
    posterior: SinPosterior


def sin_combine(
    pot_h: torch.Tensor, pot_p: torch.Tensor, exp: GmmExpected
) -> SinPosterior:
    """Conjugate combine of the diagonal encoder potential (N, d) with the
    expected GMM naturals (§9.4). The responsibility formula drops per-n
    constants, which cancel in the softmax over k."""
    d = pot_h.shape[-1]
    eye = torch.eye(d, dtype=pot_h.dtype, device=pot_h.device)
    prec = (pot_p[:, :, None] * eye)[:, None] + exp.prec[None]  # (N, K, d, d)
    h = pot_h[:, None, :] + exp.prec_mean[None]  # (N, K, d)
    chol = bl.cholesky(prec)
    mean = bl.cho_solve_vec(chol, h)
    logdet_prec = bl.logdet_from_chol(chol)
    cov = bl.inv_psd(chol)
    log_rho = (
        exp.log_pi[None, :]
        + 0.5 * exp.logdet[None, :]
        - 0.5 * exp.quad[None, :]
        + 0.5 * (mean * h).sum(dim=-1)
        - 0.5 * logdet_prec
    )
    log_resp = torch.log_softmax(log_rho, dim=-1)
    return SinPosterior(
        mean=mean, prec_chol=chol, cov=cov, log_resp=log_resp,
        logdet_prec=logdet_prec,
    )


def sample_posterior(
    post: SinPosterior,
    num_samples: int,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """S reparameterised draws z = μ̃ + L̃⁻ᵀε per (n, k): (S, N, K, d).

    ``eps`` (S, N, K, d) overrides the draw from ``generator``."""
    shape = (num_samples,) + tuple(post.mean.shape)
    if eps is None:
        eps = torch.randn(
            shape, generator=generator, device=post.mean.device,
            dtype=post.mean.dtype,
        )
    else:
        eps = eps.to(post.mean.dtype)
    chol = post.prec_chol.expand((num_samples,) + tuple(post.prec_chol.shape))
    return post.mean[None] + bl.solve_triu_vec(chol, eps)


def _weighted_loglik(dec_params: list, z: torch.Tensor, x: torch.Tensor):
    """Gaussian decoder log-likelihood batched over (S, N, K)."""
    mean, var = nets.decoder_apply(dec_params, z)
    return nets.gaussian_loglik(x[None, :, None, :], mean, var)


def local_kl_term(post: SinPosterior, exp: GmmExpected) -> torch.Tensor:
    """KL(q(z,k|x) ‖ p̄(z,k)) per datapoint, closed form (§9.6): (N,).

    With ḡ_k = ½E[log|Λ|] − (d/2)log2π − ½E[μᵀΛμ]:
      E_q[log p̄(z,k)] = E[logπ_k] + ḡ_k + h̄_kᵀμ̃ − ½(tr(J̄Σ̃) + μ̃ᵀJ̄μ̃)
      E_q[log q(z|n,k)] = −(d/2)(1+log2π) + ½log|J̃|
    """
    d = post.mean.shape[-1]
    resp = torch.exp(post.log_resp)
    g_k = 0.5 * exp.logdet - 0.5 * d * _LOG_2PI - 0.5 * exp.quad
    cross = torch.einsum("ki,nki->nk", exp.prec_mean, post.mean)
    tr_term = torch.einsum("kij,nkij->nk", exp.prec, post.cov)
    quad_mu = torch.einsum("nki,kij,nkj->nk", post.mean, exp.prec, post.mean)
    e_log_pbar = exp.log_pi[None, :] + g_k[None, :] + cross - 0.5 * (tr_term + quad_mu)
    e_log_q = post.log_resp - 0.5 * d * (1.0 + _LOG_2PI) + 0.5 * post.logdet_prec
    return -(resp * (e_log_pbar - e_log_q)).sum(dim=-1)


def forward(
    nn_params: dict,
    pgm_nat: GmmNat,
    prior_nat: GmmNat,
    x: torch.Tensor,
    config: SvaeConfig,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> SvaeOutputs:
    """Full SVAE forward pass → structured ELBO + CVI payload.

    ``eps`` (S, N, K, d) injects the reparameterisation noise; otherwise
    it is drawn from ``generator``."""
    n = x.shape[0]
    scale = config.num_total / n
    exp = gmm.expected_params(pgm_nat)
    pot_h, pot_p = nets.encoder_apply(nn_params["encoder"], x)
    post = sin_combine(pot_h, pot_p, exp)
    resp = torch.exp(post.log_resp)

    z = sample_posterior(post, config.num_samples, eps=eps, generator=generator)
    loglik = _weighted_loglik(nn_params["decoder"], z, x)  # (S, N, K)
    recon = scale * (resp * loglik.mean(dim=0)).sum()
    local = scale * local_kl_term(post, exp).sum()
    global_kl = gmm.kl_global(pgm_nat, prior_nat)

    ezz = post.cov + post.mean[..., :, None] * post.mean[..., None, :]
    stats = gmm.suff_stats_from_moments(resp, post.mean, ezz, scale=scale)
    return SvaeOutputs(
        elbo=recon - local - global_kl,
        recon=recon,
        local_kl=local,
        global_kl=global_kl,
        suff_stats=stats,
        posterior=post,
    )


def init_params(
    generator: torch.Generator,
    input_dim: int,
    config: SvaeConfig,
    encoder_hidden=(50, 50),
    decoder_hidden=(50, 50),
    *,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Encoder (input → 2d) and Gaussian decoder (d → 2·input) MLPs."""
    kw = dict(device=device, dtype=dtype)
    d = config.latent_dim
    return {
        "encoder": nets.mlp_init(
            generator, [input_dim, *encoder_hidden, 2 * d], **kw
        ),
        "decoder": nets.mlp_init(
            generator, [d, *decoder_hidden, 2 * input_dim], **kw
        ),
    }
