"""Held-out evaluation (``svax/models/evaluation.py``: ``cluster_purity``,
``gmm_predictive_log_prob``, ``svae_iw_loglik``, ``svae_smm_iw_loglik``
and ``vae_iw_loglik``; the SVAE bounds take the recognition head, the
combine's jitter and the nets' activation).

``gmm_predictive_log_prob`` is the exact VB posterior predictive of the
conjugate GMM (a mixture of Student-t, Bishop PRML eq. 10.81): the
exact-GMM bar the SVAE is judged against. ``svae_iw_loglik`` is the
SVAE's importance-weighted bound (Burda et al.): proposal the structured
mixture posterior q(z|x), target the expected-parameter GMM prior p̄(z)
times the decoder (Gaussian or Bernoulli, in f32 as the reference
evaluates it). ``svae_smm_iw_loglik`` is the same bound for the
Student-t-prior SVAE: proposal the u–z posterior of ``svae_smm``, target
the expected-parameter Student-t mixture (u integrated out in closed form).
``vae_iw_loglik`` is the plain VAE's bound: proposal q(z|x), target
N(0, I) times the decoder.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from svax_torch.expfam import dirichlet, niw
from svax_torch.models import svae as svae_mod
from svax_torch.models import svae_smm
from svax_torch.nets import mlp as nets
from svax_torch.ops import batched_linalg as bl
from svax_torch.pgm import gmm
from svax_torch.pgm.gmm import GmmNat

_LOG_PI = math.log(math.pi)
_LOG_2PI = math.log(2.0 * math.pi)
# Samples scored at once by svae_iw_loglik: at bigk-dp's K = 100, d = 10
# and 1000 test points one sample's (N, K, d) block is 4 MB, and the
# unrolled triangular solve makes a dozen such temporaries.
_IW_CHUNK = 10


def cluster_purity(resp, labels) -> float:
    """Hard-assignment cluster purity against ground-truth labels:
    (1/N) Σ_clusters max_class |cluster ∩ class| ∈ (0, 1]."""
    if isinstance(resp, torch.Tensor):
        resp = resp.detach().cpu().numpy()
    hard = np.asarray(resp).argmax(-1)
    labels = np.asarray(labels)
    total = 0
    for c in np.unique(hard):
        members = labels[hard == c]
        if len(members):
            total += np.bincount(members).max()
    return float(total) / float(len(labels))


def gmm_predictive_log_prob(nat: GmmNat, x: torch.Tensor) -> torch.Tensor:
    """Exact VB posterior predictive (Bishop 10.81), per point (N,):

    p(x*) = Σ_k (α_k/Σα) · St(x*; m_k, L_k, ν_k + 1 − d) with scale
    L_k = ((κ_k + 1) Φ_k) / (κ_k (ν_k + 1 − d)).
    """
    alpha = dirichlet.natural_to_standard(nat.dir_nat)
    std = niw.natural_to_standard(nat.niw_nat)
    d = x.shape[-1]
    dof = std.nu + 1.0 - d  # (K,)
    scale = ((std.kappa + 1.0) / (std.kappa * dof))[:, None, None] * std.phi
    chol = bl.cholesky(scale)  # (K, d, d)
    diff = x[:, None, :] - std.m[None]  # (N, K, d)
    sol = bl.solve_tril_vec(chol.expand(diff.shape[:2] + chol.shape[-2:]), diff)
    maha = (sol ** 2).sum(dim=-1)  # (N, K)
    log_st = (
        torch.lgamma(0.5 * (dof + d))
        - torch.lgamma(0.5 * dof)
        - 0.5 * d * (torch.log(dof) + _LOG_PI)
        - 0.5 * bl.logdet_from_chol(chol)
        - 0.5 * (dof + d) * torch.log1p(maha / dof)
    )
    log_mix = torch.log(alpha) - torch.log(alpha.sum())
    return torch.logsumexp(log_mix + log_st, dim=-1)


def _mixture_log_q(z: torch.Tensor, post: svae_mod.SinPosterior) -> torch.Tensor:
    """log q(z|x) = lse_k [log r̃_k + log N(z; μ̃_k, Σ̃_k)]; z: (S, N, d)."""
    d = z.shape[-1]
    diff = z[:, :, None, :] - post.mean[None]  # (S, N, K, d)
    # Mahalanobis via the precision Cholesky: ‖L̃ᵀ diff‖² with J̃ = L̃L̃ᵀ.
    lt_diff = torch.einsum("nkji,snkj->snki", post.prec_chol, diff)
    log_n = (-0.5 * (lt_diff ** 2).sum(-1) + 0.5 * post.logdet_prec[None]
             - 0.5 * d * _LOG_2PI)
    return torch.logsumexp(post.log_resp[None] + log_n, dim=-1)  # (S, N)


def _expected_gmm_log_prob(z: torch.Tensor, exp: gmm.GmmExpected) -> torch.Tensor:
    """log p̄(z) under the expected-natural-parameter GMM; z: (..., d)."""
    d = z.shape[-1]
    quad = torch.einsum("...i,kij,...j->...k", z, exp.prec, z)
    cross = torch.einsum("...i,ki->...k", z, exp.prec_mean)
    logp_k = (exp.log_pi + 0.5 * exp.logdet - 0.5 * (quad - 2.0 * cross + exp.quad)
              - 0.5 * d * _LOG_2PI)
    return torch.logsumexp(logp_k, dim=-1)


def _expected_smm_log_prob(z: torch.Tensor, exp: gmm.GmmExpected,
                           dof: float) -> torch.Tensor:
    """log p̄(z) under the expected-parameter Student-t mixture; z (..., d).

    u ~ Gamma(a₀, b₀) integrated out of exp(E[log p(z|u,θ,k)]):
    p̄(z|k) = (2π)^{−d/2} e^{½E[log|Λ|]} b₀^{a₀} Γ(a₀+d/2)/Γ(a₀)
             · (b₀ + Q(z)/2)^{−(a₀+d/2)},
    Q(z) = zᵀE[Λ]z − 2zᵀE[Λμ] + E[μᵀΛμ]."""
    d = z.shape[-1]
    a0 = b0 = 0.5 * dof
    a = a0 + 0.5 * d
    quad = torch.einsum("...i,kij,...j->...k", z, exp.prec, z)
    cross = torch.einsum("...i,ki->...k", z, exp.prec_mean)
    q_z = quad - 2.0 * cross + exp.quad
    logp_k = (exp.log_pi + 0.5 * exp.logdet - 0.5 * d * _LOG_2PI + a0 * math.log(b0)
              + math.lgamma(a) - math.lgamma(a0) - a * torch.log(b0 + 0.5 * q_z))
    return torch.logsumexp(logp_k, dim=-1)


def _iw_draws(post, num_samples: int, x: torch.Tensor, generator, gumbel, eps):
    """The Gumbel and ε draws of an IW bound (injected, or from
    ``generator``, the Gumbel first) and the Gumbel-max choice (S, N)."""
    shape = (num_samples,) + tuple(post.log_resp.shape)
    if gumbel is None:
        gumbel = svae_mod.gumbel_draws(shape, generator, device=x.device, dtype=x.dtype)
    if eps is None:  # as sample_posterior draws it
        eps = torch.randn(shape + (post.mean.shape[-1],), generator=generator,
                          device=x.device, dtype=post.mean.dtype)
    return torch.argmax(post.log_resp[None] + gumbel.to(x.dtype), dim=-1), eps


def _iw_bound(nn_params, post, x, choice, eps, log_prior, likelihood,
              activation: str = "tanh") -> torch.Tensor:
    """lse_s[log p(x|z) + log_prior(z) − log q(z|x)] − log S over the chosen
    components' draws, scored _IW_CHUNK samples at a time."""
    num_samples = choice.shape[0]
    log_w = []
    for lo in range(0, num_samples, _IW_CHUNK):
        hi = min(lo + _IW_CHUNK, num_samples)
        z_all = svae_mod.sample_posterior(post, hi - lo, eps=eps[lo:hi])
        idx = choice[lo:hi, :, None, None].expand(-1, -1, 1, z_all.shape[-1])
        z = torch.gather(z_all, 2, idx)[:, :, 0, :]  # (chunk, N, d)
        loglik = nets.log_likelihood(nn_params["decoder"], z, x[None], likelihood,
                                     activation)
        log_w.append(loglik + log_prior(z) - _mixture_log_q(z, post))
    return torch.logsumexp(torch.cat(log_w), dim=0) - math.log(float(num_samples))


@torch.no_grad()
def svae_iw_loglik(nn_params: dict, pgm_nat: GmmNat, x: torch.Tensor,
                   num_samples: int = 100, *, generator: torch.Generator | None = None,
                   gumbel: torch.Tensor | None = None,
                   eps: torch.Tensor | None = None,
                   likelihood: str = "gaussian", encoder_head: str = "diag",
                   jitter: float = 0.0, activation: str = "tanh") -> torch.Tensor:
    """Per-point IW bound: lse_s[log p(x|z)p̄(z)/q(z|x)] − log S; (N,).

    Per (s, n) a component is drawn by Gumbel-max on log r̃ and z from its
    Gaussian, z = μ̃ + L̃⁻ᵀε. ``gumbel`` (S, N, K) and ``eps`` (S, N, K, d)
    inject the draws; otherwise they come from ``generator``, all of them
    first. The samples are then scored _IW_CHUNK at a time, which leaves
    every value as it is. The decoder runs in the parameters' dtype with
    the ``likelihood`` head; the nets at ``activation`` and f32 products, the
    encoder with ``encoder_head``, the combine with ``jitter``, as the
    reference's (svax/models/evaluation.py:72-90)."""
    exp = gmm.expected_params(pgm_nat)
    pot_h, pot_p = nets.encoder_apply(nn_params["encoder"], x, activation,
                                      head=encoder_head)
    post = svae_mod.sin_combine(pot_h, pot_p, exp, jitter=jitter)
    choice, eps = _iw_draws(post, num_samples, x, generator, gumbel, eps)
    return _iw_bound(nn_params, post, x, choice, eps,
                     lambda z: _expected_gmm_log_prob(z, exp), likelihood, activation)


@torch.no_grad()
def svae_smm_iw_loglik(nn_params: dict, pgm_nat: GmmNat, x: torch.Tensor,
                       num_samples: int = 100, *, dof: float, smm_iters: int = 2,
                       generator: torch.Generator | None = None,
                       gumbel: torch.Tensor | None = None,
                       eps: torch.Tensor | None = None,
                       likelihood: str = "gaussian", encoder_head: str = "diag",
                       jitter: float = 0.0, activation: str = "tanh") -> torch.Tensor:
    """Per-point IW bound of the SMM-prior SVAE; (N,). Proposal: the
    structured mixture posterior of ``svae_smm.smm_combine`` (``smm_iters``
    rounds); target: the expected-parameter Student-t mixture times the
    decoder. Draws, their injection and chunking, the head, jitter and
    activation as ``svae_iw_loglik``."""
    if dof <= 0.0:
        raise ValueError("svae_smm_iw_loglik needs dof > 0")
    exp = gmm.expected_params(pgm_nat)
    pot_h, pot_p = nets.encoder_apply(nn_params["encoder"], x, activation,
                                      head=encoder_head)
    post, _ = svae_smm.smm_combine(pot_h, pot_p, exp, dof, smm_iters, jitter=jitter)
    choice, eps = _iw_draws(post, num_samples, x, generator, gumbel, eps)
    return _iw_bound(nn_params, post, x, choice, eps,
                     lambda z: _expected_smm_log_prob(z, exp, dof), likelihood, activation)


@torch.no_grad()
def vae_iw_loglik(params: dict, x: torch.Tensor, config, num_samples: int = 100, *,
                  generator: torch.Generator | None = None,
                  eps: torch.Tensor | None = None) -> torch.Tensor:
    """IWAE bound of the plain VAE (``models.vae``), per point (N,):
    lse_s[log p(x|z) + log N(z; 0, I) − log q(z|x)] − log S. ε (S, N, d) is
    ``eps`` when given, else drawn from ``generator``; the samples are then
    scored _IW_CHUNK at a time, which leaves every value as it is."""
    from svax_torch.models import vae

    mean, var = vae.posterior(params, x, config)
    if eps is None:
        eps = torch.randn((num_samples,) + tuple(mean.shape), generator=generator,
                          device=mean.device, dtype=mean.dtype)
    log_w = []
    for lo in range(0, num_samples, _IW_CHUNK):
        e = eps[lo:lo + _IW_CHUNK]
        z = mean[None] + torch.sqrt(var)[None] * e
        log_q = (-0.5 * e**2 - 0.5 * torch.log(var)[None] - 0.5 * _LOG_2PI).sum(dim=-1)
        log_prior = (-0.5 * z**2 - 0.5 * _LOG_2PI).sum(dim=-1)
        loglik = nets.log_likelihood(params["decoder"], z, x[None], config.likelihood,
                                     config.activation)
        log_w.append(loglik + log_prior - log_q)
    return torch.logsumexp(torch.cat(log_w), dim=0) - math.log(float(num_samples))
