"""VAE-style warmup + k-means++ reseed for the high-d SVAE configs
(``svax/train/warmup.py``).

When the latent dimension differs from the data dimension the components
cannot be seeded from data, a fresh encoder maps every input near the
origin, and CVI collapses the mixture to one component (the reference
measured purity 0.117 with 1/10 components on the MNIST surrogate). The
remedy is two phases:

1. **Warmup**: ``steps`` ordinary train steps at ρ = 0, so the naturals
   stay frozen and the nets train as a VAE against the fixed mixture; on
   the same per-step path as the joint phase (``loop.make_step_runner``),
   the combine kernel included.
2. **Reseed**: encode the training set, run k-means++ on the latent means
   (``pgm.init``, numpy on the host — a one-off, as in the reference), and
   rebuild q's naturals as prior + pseudo-observations at the seeds with a
   covariance matched to the measured within-cluster spread.
"""

from __future__ import annotations

import numpy as np
import torch

from svax_torch.nets import mlp as nets
from svax_torch.pgm import init as pgm_init
from svax_torch.pgm.gmm import GmmNat
from svax_torch.train import loop

# The warmup draws its batches and noise from a stream of its own: the
# runner keys its generator seed + step, and the joint phase restarts at
# step 0 after the reseed.
WARMUP_STREAM = 1 << 32


@torch.no_grad()
def encoded_latent_means(nn_params: dict, x: torch.Tensor, head: str = "diag",
                         activation: str = "tanh") -> torch.Tensor:
    """Latent means of the encoder's potentials, (N, d): h / P for the
    diagonal head, P⁻¹h for the full one."""
    pot_h, pot_p = nets.encoder_apply(nn_params["encoder"], x, activation, head=head)
    if head == "diag":
        return pot_h / pot_p
    return torch.linalg.solve(pot_p, pot_h[..., None])[..., 0]


def reseed_from_encoder(state, x: torch.Tensor, prior: GmmNat, *, seed: int = 0,
                        pseudo_counts: float = 5.0, cov_scale: float = 0.0,
                        max_points: int = 20000, reset_step: bool = True,
                        head: str = "diag", activation: str = "tanh"):
    """Replace q's naturals with k-means++ seeds in the current latent space.

    ``cov_scale=0`` (auto) uses the within-cluster per-dimension variance of
    the k-means++ assignment, floored at 1e-3. ``reset_step`` zeroes the
    step counter so a decaying ρ restarts from ρ₀ (Adam's count is left
    alone). ``head`` and ``activation`` are the encoder's. Returns ``(state,
    info)``."""
    k = prior.dir_nat.shape[0]
    lat = encoded_latent_means(state.nn_params, x[:max_points], head,
                               activation).cpu().double().numpy()
    centers = pgm_init.kmeanspp_centers(lat, k, seed=seed)
    d2 = ((lat[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    assign = np.argmin(d2, axis=-1)
    within = float(np.mean((lat - centers[assign]) ** 2))
    scale = cov_scale if cov_scale > 0.0 else max(within, 1e-3)
    pgm_nat = pgm_init.init_variational_kmeanspp(
        prior, lat, seed=seed, pseudo_counts=pseudo_counts, cov_scale=scale)
    new_state = state._replace(pgm_nat=pgm_nat)
    if reset_step:
        new_state = new_state._replace(step=0)
    info = {"within_cluster_var": within, "cov_scale": scale,
            "seed_occupancy": int(np.unique(assign).size)}
    return new_state, info


def vae_warmup_reseed(state, x: torch.Tensor, config, prior: GmmNat, *, lr: float,
                      steps: int = 1000, batch_size: int = 0, scan_chunk: int = 100,
                      seed: int = 0, engine: str = "kernel", pseudo_counts: float = 5.0,
                      cov_scale: float = 0.0, graph: bool | None = None):
    """Phase-1 warmup (ρ = 0) then the k-means++ reseed; returns (state, info).

    ``batch_size=0`` trains full-batch; ``engine`` is the per-step runner's
    (``loop.make_step_runner``), which trains the SMM prior when
    ``config.dof`` > 0. The reseed's k-means++ is seeded ``seed``;
    ``pseudo_counts`` and ``cov_scale`` are ``reseed_from_encoder``'s;
    ``graph`` is the runner's (a CUDA graph on the card by default)."""
    if steps > 0:
        runner = loop.make_step_runner(config, prior, lr=lr, rho=0.0,
                                       batch_size=batch_size, engine=engine, graph=graph)
        done = 0
        while done < steps:
            todo = min(scan_chunk, steps - done)
            state, _ = runner(state, x, todo, seed=seed + WARMUP_STREAM)
            done += todo
    return reseed_from_encoder(state, x, prior, seed=seed, pseudo_counts=pseudo_counts,
                               cov_scale=cov_scale, head=config.encoder_head,
                               activation=config.activation)
