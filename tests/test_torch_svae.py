"""Port SVAE forward pieces against svax.models.svae at injected ε (float64).

Same JAX-built parameters and naturals in (carried across with
svax_torch.convert), same numpy noise, rtol 1e-9: sin_combine,
sample_posterior, local_kl_term, the GMM expected parameters, global KL
and the full forward (ELBO terms and CVI statistics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.data import make_pinwheel_data
from svax.models import svae as jsvae
from svax.models.svae import SvaeConfig as JConfig
from svax.nets import mlp as jnets
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax_torch import convert
from svax_torch.models import svae
from svax_torch.models.svae import SvaeConfig
from svax_torch.nets import mlp as nets
from svax_torch.pgm import gmm

torch.set_num_threads(1)
RTOL = 1e-9


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _setup(n=60, k=4, s=3, hidden=(12, 12), seed=0):
    x = jnp.asarray(make_pinwheel_data(num_classes=3, num_per_class=n // 3,
                                       seed=seed)[:n])
    jconfig = JConfig(latent_dim=2, num_components=k, num_samples=s,
                      num_total=n, nn_precision=jax.lax.Precision.HIGHEST)
    jprior = jgmm.make_prior(k, 2, kappa=0.05, dtype=jnp.float64)
    jstate = jstep.init_state(jax.random.PRNGKey(seed), 2, jconfig, jprior,
                              optax.adam(1e-3), hidden, hidden, data=x,
                              dtype=jnp.float64)
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate))
    prior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior))
    eps = np.random.default_rng(seed + 1).standard_normal((s, n, k, 2))
    config = SvaeConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n)
    return dict(x=x, jconfig=jconfig, jprior=jprior, jstate=jstate, state=state,
                prior=prior, eps=eps, config=config,
                xt=torch.tensor(np.asarray(x)))


def test_expected_params_and_global_kl_match_jax():
    c = _setup()
    for got, want in zip(gmm.expected_params(c["state"].pgm_nat),
                         jgmm.expected_params(c["jstate"].pgm_nat)):
        _close(got, want)
    _close(gmm.kl_global(c["state"].pgm_nat, c["prior"]),
           jgmm.kl_global(c["jstate"].pgm_nat, c["jprior"]))
    prior = gmm.make_prior(4, 2, kappa=0.05, dtype=torch.float64)
    _close(prior.dir_nat, c["jprior"].dir_nat)
    for got, want in zip(prior.niw_nat, c["jprior"].niw_nat):
        _close(got, want)


def test_encoder_and_combine_match_jax():
    c = _setup()
    h, p = nets.encoder_apply(c["state"].nn_params["encoder"], c["xt"])
    jh, jp = jnets.encoder_apply(c["jstate"].nn_params["encoder"], c["x"])
    _close(h, jh)
    _close(p, jp)
    post = svae.sin_combine(h, p, gmm.expected_params(c["state"].pgm_nat))
    jpost = jsvae.sin_combine(jh, jp, jgmm.expected_params(c["jstate"].pgm_nat))
    for got, want in zip(post, jpost):
        _close(got, want, atol=1e-12)
    z = svae.sample_posterior(post, 3, eps=torch.tensor(c["eps"]))
    jz = jsvae.sample_posterior(None, jpost, 3, eps=jnp.asarray(c["eps"]))
    _close(z, jz)
    _close(svae.local_kl_term(post, gmm.expected_params(c["state"].pgm_nat)),
           jsvae.local_kl_term(jpost, jgmm.expected_params(c["jstate"].pgm_nat)))


@pytest.mark.parametrize("seed", [0, 2])
def test_forward_matches_jax(seed):
    c = _setup(seed=seed)
    out = svae.forward(c["state"].nn_params, c["state"].pgm_nat, c["prior"],
                       c["xt"], c["config"], eps=torch.tensor(c["eps"]))
    jout = jsvae.forward(c["jstate"].nn_params, c["jstate"].pgm_nat, c["jprior"],
                         c["x"], jax.random.PRNGKey(0), c["jconfig"],
                         eps=jnp.asarray(c["eps"]))
    for name in ("elbo", "recon", "local_kl", "global_kl"):
        _close(getattr(out, name), getattr(jout, name))
    for got, want in zip(out.suff_stats, jout.suff_stats):
        _close(got, want)


def test_forward_minibatch_scaling_matches_jax():
    """num_total > N scales recon, local KL and statistics by N/M."""
    c = _setup()
    cfg = c["config"]._replace(num_total=240)
    out = svae.forward(c["state"].nn_params, c["state"].pgm_nat, c["prior"],
                       c["xt"], cfg, eps=torch.tensor(c["eps"]))
    jout = jsvae.forward(c["jstate"].nn_params, c["jstate"].pgm_nat, c["jprior"],
                         c["x"], jax.random.PRNGKey(0),
                         c["jconfig"]._replace(num_total=240),
                         eps=jnp.asarray(c["eps"]))
    _close(out.elbo, jout.elbo)
    _close(out.suff_stats.counts, jout.suff_stats.counts)


def test_init_params_layout_matches_jax():
    """Same shapes as svax's init (weights (in, out), zero biases), so
    converted state lines up one to one."""
    c = _setup()
    mine = svae.init_params(torch.Generator().manual_seed(0), 2, c["config"],
                            (12, 12), (12, 12), dtype=torch.float64)
    for side in ("encoder", "decoder"):
        for ly, jly in zip(mine[side], c["jstate"].nn_params[side]):
            assert ly["w"].shape == jly["w"].shape
            assert ly["b"].shape == jly["b"].shape
            assert not ly["b"].any()
