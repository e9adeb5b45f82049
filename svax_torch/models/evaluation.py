"""Held-out evaluation (``svax/models/evaluation.py``, the
``cluster_purity``, ``gmm_predictive_log_prob`` and ``svae_iw_loglik``
subset).

``gmm_predictive_log_prob`` is the exact VB posterior predictive of the
conjugate GMM (a mixture of Student-t, Bishop PRML eq. 10.81): the
exact-GMM bar the SVAE is judged against. ``svae_iw_loglik`` is the
SVAE's importance-weighted bound (Burda et al.): proposal the structured
mixture posterior q(z|x), target the expected-parameter GMM prior p̄(z)
times the Gaussian decoder.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from svax_torch.expfam import dirichlet, niw
from svax_torch.models import svae as svae_mod
from svax_torch.nets import mlp as nets
from svax_torch.ops import batched_linalg as bl
from svax_torch.pgm import gmm
from svax_torch.pgm.gmm import GmmNat

_LOG_PI = math.log(math.pi)
_LOG_2PI = math.log(2.0 * math.pi)


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


@torch.no_grad()
def svae_iw_loglik(nn_params: dict, pgm_nat: GmmNat, x: torch.Tensor,
                   num_samples: int = 100, *, generator: torch.Generator | None = None,
                   gumbel: torch.Tensor | None = None,
                   eps: torch.Tensor | None = None) -> torch.Tensor:
    """Per-point IW bound: lse_s[log p(x|z)p̄(z)/q(z|x)] − log S; (N,).

    Per (s, n) a component is drawn by Gumbel-max on log r̃ and z from its
    Gaussian, z = μ̃ + L̃⁻ᵀε. ``gumbel`` (S, N, K) and ``eps`` (S, N, K, d)
    inject the draws; otherwise they come from ``generator``."""
    exp = gmm.expected_params(pgm_nat)
    pot_h, pot_p = nets.encoder_apply(nn_params["encoder"], x)
    post = svae_mod.sin_combine(pot_h, pot_p, exp)
    shape = (num_samples,) + tuple(post.log_resp.shape)
    if gumbel is None:
        u = torch.rand(shape, generator=generator, device=x.device, dtype=x.dtype)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(x.dtype).tiny)))
    choice = torch.argmax(post.log_resp[None] + gumbel.to(x.dtype), dim=-1)  # (S, N)
    z_all = svae_mod.sample_posterior(post, num_samples, eps=eps, generator=generator)
    idx = choice[..., None, None].expand(-1, -1, 1, z_all.shape[-1])
    z = torch.gather(z_all, 2, idx)[:, :, 0, :]  # (S, N, d)
    log_q = _mixture_log_q(z, post)
    log_prior = _expected_gmm_log_prob(z, exp)
    mean, var = nets.decoder_apply(nn_params["decoder"], z)
    loglik = nets.gaussian_loglik(x[None], mean, var)  # (S, N)
    log_w = loglik + log_prior - log_q
    return torch.logsumexp(log_w, dim=0) - math.log(float(num_samples))
