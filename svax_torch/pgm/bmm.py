"""Bernoulli-mixture inference engine, Beta–Bernoulli conjugate CVI
(``svax/pgm/bmm.py``): the third model of the comparison's mnist row.

A mixture of product-Bernoulli components with a Dirichlet prior over the
weights and a Beta prior per component and pixel, trained by the same
natural-gradient update as the GMM (``pgm.natgrad.cvi_update`` applies
leaf-wise, unchanged). It mirrors ``pgm.gmm``:

* ``BmmNat(dir_nat, beta_nat)``: Dirichlet η (K,), Beta η (K, D, 2);
* E-step: log r_nk = E[log π_k] + Σ_j x_j E[log θ_kj] + (1 − x_j)
  E[log(1 − θ_kj)], a softmax over k;
* statistics N_k = Σ_n r_nk and s_kj = Σ_n r_nk x_nj, scaled N/M; the
  Beta increment is (s_kj, N_k − s_kj), the all-reduce point under data
  parallelism;
* the exact posterior predictive p(x*) = Σ_k E[π_k] Π_j BetaBern(x*_j),
  with E[π] = α/α₀ and E[θ] = a/(a + b).

``x`` may be soft in [0, 1] in training (the E-step and the statistics are
linear in x); the predictive is a log-mass only for binary x. The two
(N, D) × (D, K) products are ``torch.matmul``, as the reference computes
them outside any kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svax_torch.expfam import beta, dirichlet


class BmmNat(NamedTuple):
    dir_nat: torch.Tensor  # (K,)      Dirichlet natural α − 1
    beta_nat: torch.Tensor  # (K, D, 2) Beta naturals (a − 1, b − 1)


class BmmExpected(NamedTuple):
    elog_pi: torch.Tensor  # (K,)
    elog_theta: torch.Tensor  # (K, D) E[log θ]
    elog_1m_theta: torch.Tensor  # (K, D) E[log(1 − θ)]


class BmmSuffStats(NamedTuple):
    counts: torch.Tensor  # (K,)   Σ r
    s1: torch.Tensor  # (K, D) Σ r·x


def make_prior(num_components: int, data_dim: int, alpha: float = 1.0,
               beta_a: float = 1.0, beta_b: float = 1.0, *,
               device: torch.device | str = "cpu",
               dtype: torch.dtype = torch.float32) -> BmmNat:
    """Conjugate prior naturals: Dir(α) weights, Beta(a, b) per (k, j)."""
    k, d = num_components, data_dim
    ab = torch.tensor([beta_a, beta_b], device=device, dtype=dtype).expand(k, d, 2)
    return BmmNat(dir_nat=torch.full((k,), alpha - 1.0, device=device, dtype=dtype),
                  beta_nat=beta.standard_to_natural(ab))


def init_variational(generator: torch.Generator | None, prior: BmmNat,
                     data: torch.Tensor | None = None, pseudo_counts: float = 2.0,
                     blur: float = 0.25, rows: torch.Tensor | None = None) -> BmmNat:
    """q's naturals: the prior plus ``pseudo_counts`` pseudo-observations per
    component at a random data row blurred toward 0.5 (blur·0.5 + (1 −
    blur)·x), so no Beta starts at a corner; with no data, at uniform draws.

    The K rows are drawn from ``generator`` (on the prior's device) without
    replacement, or given as ``rows`` (K indices into ``data``)."""
    k, d = prior.beta_nat.shape[0], prior.beta_nat.shape[1]
    ref = prior.beta_nat
    if data is None:
        locs = torch.rand((k, d), generator=generator, device=ref.device, dtype=ref.dtype)
    else:
        if rows is None:
            rows = torch.randperm(data.shape[0], generator=generator, device=ref.device)[:k]
        locs = data[rows.to(data.device)].to(device=ref.device, dtype=ref.dtype)
    locs = blur * 0.5 + (1.0 - blur) * locs
    c = pseudo_counts
    inc = c * torch.stack([locs, 1.0 - locs], dim=-1)
    return BmmNat(dir_nat=prior.dir_nat + c, beta_nat=prior.beta_nat + inc)


def expected_params(nat: BmmNat) -> BmmExpected:
    elog = beta.expected_log_theta(beta.natural_to_standard(nat.beta_nat))
    return BmmExpected(
        elog_pi=dirichlet.expected_log_pi(dirichlet.natural_to_standard(nat.dir_nat)),
        elog_theta=elog[..., 0],
        elog_1m_theta=elog[..., 1],
    )


def log_responsibilities(x: torch.Tensor, exp: BmmExpected) -> torch.Tensor:
    """Unnormalised log r (N, K): E[log π_k] + Σ_j ⟨T(x_j), E[log θ·]⟩, as two
    (N, D) × (D, K) products."""
    return exp.elog_pi[None, :] + x @ exp.elog_theta.T + (1.0 - x) @ exp.elog_1m_theta.T


def e_step(x: torch.Tensor, exp: BmmExpected) -> tuple[torch.Tensor, torch.Tensor]:
    """Responsibilities (N, K) and per-point local evidence (N,)."""
    log_rho = log_responsibilities(x, exp)
    evidence = torch.logsumexp(log_rho, dim=-1)
    return torch.exp(log_rho - evidence[:, None]), evidence


def suff_stats(x: torch.Tensor, resp: torch.Tensor, scale=1.0) -> BmmSuffStats:
    """Weighted sufficient statistics, scaled by N/M."""
    return BmmSuffStats(counts=scale * resp.sum(dim=0), s1=scale * (resp.T @ x))


def stats_to_nat(stats: BmmSuffStats) -> BmmNat:
    """(N_k, s_kj) → natural increments: Δη_k = N_k for the Dirichlet,
    Δη = (s_kj, N_k − s_kj) for each Beta."""
    fail = stats.counts[:, None] - stats.s1
    return BmmNat(dir_nat=stats.counts, beta_nat=torch.stack([stats.s1, fail], dim=-1))


def kl_global(nat: BmmNat, prior: BmmNat) -> torch.Tensor:
    """KL(q(π) ‖ p) + Σ_{k,j} KL(q(θ_kj) ‖ p), the global ELBO term."""
    kl_dir = dirichlet.kl(dirichlet.natural_to_standard(nat.dir_nat),
                          dirichlet.natural_to_standard(prior.dir_nat))
    kl_beta = beta.kl(beta.natural_to_standard(nat.beta_nat),
                      beta.natural_to_standard(prior.beta_nat))
    return kl_dir + kl_beta.sum()


def predictive_log_prob(nat: BmmNat, x: torch.Tensor) -> torch.Tensor:
    """The exact posterior-predictive log-mass per point (N,) under q:
    p(x*) = Σ_k (α_k/α₀) Π_j θ̂_kj^{x_j} (1 − θ̂_kj)^{1 − x_j}, θ̂ = a/(a + b)
    (one Bernoulli trial's Beta predictive is its mean)."""
    alpha = dirichlet.natural_to_standard(nat.dir_nat)
    log_w = torch.log(alpha) - torch.log(alpha.sum())
    theta = beta.mean(beta.natural_to_standard(nat.beta_nat))  # (K, D)
    comp = x @ torch.log(theta).T + (1.0 - x) @ torch.log1p(-theta).T  # (N, K)
    return torch.logsumexp(comp + log_w[None, :], dim=-1)
