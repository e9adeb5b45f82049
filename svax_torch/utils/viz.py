"""Cluster and latent-space figures (``svax/utils/viz.py``).

Matplotlib renderings of the classic SVAE figures: data coloured by the
argmax responsibility, each component's covariance ellipse from the
expected NIW parameters, and training curves from the JSONL rows that
``train.metrics.JsonlLogger`` writes. Matplotlib is imported inside the
functions, with the Agg backend, so that training never pays for it; where
it is not installed, a plot raises an ImportError that names it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend; raises ImportError naming
    matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as err:
        raise ImportError("plotting needs matplotlib, which is not installed here "
                          "(train without --plot)") from err
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def check_available(path) -> None:
    """Raise the ImportError of ``pyplot`` when ``path`` asks for a figure
    and matplotlib is missing: the entries call it before any work."""
    if path:
        pyplot()


def _np(a) -> np.ndarray:
    """A tensor or an array as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _ellipse_points(mean: np.ndarray, cov: np.ndarray, n_std: float = 2.0, n: int = 64):
    theta = np.linspace(0, 2 * np.pi, n)
    circle = np.stack([np.cos(theta), np.sin(theta)], axis=0)
    vals, vecs = np.linalg.eigh(cov)
    radii = n_std * np.sqrt(np.maximum(vals, 0.0))
    return (vecs @ (radii[:, None] * circle)).T + mean


def plot_gmm_clusters(x, resp, nat, path: str | Path | None, title: str = "",
                      min_weight: float = 0.01, ax=None) -> None:
    """Scatter of 2-D data coloured by argmax responsibility, with each
    component's ellipse (two standard deviations) and centre.

    ``nat`` is the port's ``GmmNat``; the ellipses use E[μ] = m and the
    expected covariance E[Σ] = Φ/(ν − d − 1) of the NIW posterior
    (``expfam.niw.natural_to_standard``). For d > 2 the data and the
    components are projected onto the first two axes; a component whose
    share of the responsibility is below ``min_weight`` is not drawn. With
    ``ax`` given, draws into that axes (the caller owns the figure; ``path``
    is ignored), else writes the figure to ``path``. ``x`` and ``resp`` are
    tensors or arrays."""
    plt = pyplot()
    from svax_torch.expfam import niw as niw_mod

    std = niw_mod.natural_to_standard(nat.niw_nat)
    m, phi, nu = _np(std.m), _np(std.phi), _np(std.nu)
    x, resp = _np(x), _np(resp)
    d = m.shape[-1]
    if d > 2:
        # The first two latent axes (marginal covariances).
        x = x[:, :2]
        m = m[:, :2]
        phi = phi[:, :2, :2]
    weights = resp.sum(0)
    weights = weights / weights.sum()

    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(6, 6))
    hard = resp.argmax(-1)
    cmap = plt.get_cmap("tab10")
    ax.scatter(x[:, 0], x[:, 1], c=[cmap(h % 10) for h in hard], s=8, alpha=0.6)
    for j in range(m.shape[0]):
        if weights[j] < min_weight:
            continue
        denom = max(nu[j] - d - 1.0, 0.1)
        pts = _ellipse_points(m[j], phi[j] / denom)
        ax.plot(pts[:, 0], pts[:, 1], color=cmap(j % 10), lw=1.5)
        ax.scatter(*m[j], marker="x", color=cmap(j % 10), s=60)
    ax.set_title(title or "GMM clusters")
    ax.set_aspect("equal")
    if own_fig:
        fig.tight_layout()
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, dpi=120)
        plt.close(fig)


def plot_latent_space(z_mean, resp, nat, path: str | Path | None, title: str = "",
                      ax=None) -> None:
    """Latent scatter (responsibility-weighted posterior means) with the
    components' ellipses."""
    plot_gmm_clusters(z_mean, resp, nat, path, title=title or "latent space", ax=ax)


def plot_training_curves(jsonl_path: str | Path, path: str | Path, keys=("elbo",)) -> None:
    """One line per key of the JSONL rows against their step."""
    plt = pyplot()
    from svax_torch.train.metrics import read_jsonl

    rows = read_jsonl(jsonl_path)
    fig, ax = plt.subplots(figsize=(7, 4))
    for k in keys:
        xs = [r["step"] for r in rows if k in r]
        ys = [r[k] for r in rows if k in r]
        if xs:
            ax.plot(xs, ys, label=k)
    ax.set_xlabel("step")
    ax.legend()
    fig.tight_layout()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def svae_latent(state, config, prior, x, generator=None) -> tuple[np.ndarray, np.ndarray]:
    """(z̄, resp) of the SVAE's forward pass on ``x`` with one sample
    (``svae.forward``, or ``svae_smm.forward`` for dof > 0) on the plain
    combine and decoder, as the entries plot it: resp = exp(log r̃) and
    z̄ = Σₖ resp·μ̃ₖ."""
    import torch

    from svax_torch.train.svae_step import model_for

    cfg = config._replace(num_samples=1, fused_combine=False, kernel_rng=False,
                          fused_mlp_decoder=False, fused_decoder=False)
    with torch.no_grad():
        post = model_for(cfg).forward(state.nn_params, state.pgm_nat, prior, x, cfg,
                                      generator=generator).posterior
    resp = np.exp(_np(post.log_resp))
    return np.einsum("nk,nkd->nd", resp, _np(post.mean)), resp
