"""Held-out evaluation of the pure mixtures (``svax/models/evaluation.py``,
the ``cluster_purity`` and ``gmm_predictive_log_prob`` subset).

``gmm_predictive_log_prob`` is the exact VB posterior predictive of the
conjugate GMM (a mixture of Student-t, Bishop PRML eq. 10.81): the
exact-GMM bar the SVAE is judged against.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from svax_torch.expfam import dirichlet, niw
from svax_torch.ops import batched_linalg as bl
from svax_torch.pgm.gmm import GmmNat

_LOG_PI = math.log(math.pi)


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
