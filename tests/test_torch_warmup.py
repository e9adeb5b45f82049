"""The port's warmup and k-means++ reseed against ``svax.train.warmup``.

* ``encoded_latent_means`` and ``reseed_from_encoder`` on a converted state
  equal the reference's at 1e-6: both run the same numpy k-means++ on the
  same latent means (float64 and float32 states);
* the ρ = 0 warmup leaves the naturals unchanged before the reseed, moves
  the nets, and ``vae_warmup_reseed`` is that warmup followed by the reseed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.models.svae import SvaeConfig as JConfig
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax.train import warmup as jwarmup
from svax_torch import convert
from svax_torch.models.svae import SvaeConfig
from svax_torch.train import loop, warmup

torch.set_num_threads(1)


def _setup(dtype, *, n=80, d_in=20, d=3, k=4, hidden=(16, 16), seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, d_in)) < 0.3).astype(np.float64)
    jconfig = JConfig(latent_dim=d, num_components=k, num_samples=1,
                      likelihood="bernoulli", num_total=n)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    cast = lambda t: jax.tree.map(  # noqa: E731
        lambda a: a.astype(jdt) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
    jprior = cast(jgmm.make_prior(k, d, kappa=0.05))
    jstate = cast(jstep.init_state(jax.random.PRNGKey(seed), d_in, jconfig, jprior,
                                   optax.adam(1e-3), hidden, hidden))
    jstate = jstate._replace(step=jnp.asarray(37, jstate.step.dtype))
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate), dtype=dtype)
    prior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior), dtype=dtype)
    return x.astype(np.float32 if dtype == torch.float32 else np.float64), jprior, \
        jstate, prior, state


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_latent_means_and_reseed_match_jax(dtype):
    x, jprior, jstate, prior, state = _setup(dtype)
    xt = torch.tensor(x)
    lat = warmup.encoded_latent_means(state.nn_params, xt)
    jlat = jwarmup.encoded_latent_means(jstate.nn_params, jnp.asarray(x))
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), rtol=1e-6, atol=1e-6)

    new, info = warmup.reseed_from_encoder(state, xt, prior, seed=3)
    jnew, jinfo = jwarmup.reseed_from_encoder(jstate, jnp.asarray(x), jprior, seed=3)
    assert info["seed_occupancy"] == jinfo["seed_occupancy"]
    np.testing.assert_allclose(info["within_cluster_var"], jinfo["within_cluster_var"],
                               rtol=1e-6)
    np.testing.assert_allclose(info["cov_scale"], jinfo["cov_scale"], rtol=1e-6)
    got = convert.gmm_nat_to_numpy(new.pgm_nat)
    np.testing.assert_allclose(got["dir_nat"], np.asarray(jnew.pgm_nat.dir_nat), rtol=1e-6)
    for f in ("eta1", "eta2", "eta3", "eta4"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jnew.pgm_nat.niw_nat, f)),
                                   rtol=1e-6, atol=1e-6)
    assert new.step == int(jnew.step) == 0
    assert new.opt_state.count == state.opt_state.count  # Adam's count is kept
    kept, _ = warmup.reseed_from_encoder(state, xt, prior, seed=3, reset_step=False)
    assert kept.step == 37
    # A given cov_scale replaces the measured spread.
    _, fixed = warmup.reseed_from_encoder(state, xt, prior, seed=3, cov_scale=0.5)
    assert fixed["cov_scale"] == 0.5


@pytest.mark.parametrize("engine", ["kernel", "plain"])
def test_rho_zero_warmup_keeps_the_naturals_then_reseeds(engine):
    x, _, _, prior, state = _setup(torch.float32, seed=1)
    xt = torch.tensor(x)
    config = SvaeConfig(latent_dim=3, num_components=4, num_samples=1, num_total=80,
                        likelihood="bernoulli", fused_combine=True, kernel_rng=True)
    runner = loop.make_step_runner(config, prior, lr=1e-3, rho=0.0, batch_size=16,
                                   engine=engine)
    seed = 5 + warmup.WARMUP_STREAM
    warm, mets = runner(state, xt, 3, seed=seed)
    warm, _ = runner(warm, xt, 2, seed=seed)
    for a, b in zip([state.pgm_nat.dir_nat, *state.pgm_nat.niw_nat],
                    [warm.pgm_nat.dir_nat, *warm.pgm_nat.niw_nat]):
        assert torch.equal(a, b)
    assert not torch.equal(warm.nn_params["decoder"][0]["w"], state.nn_params["decoder"][0]["w"])
    assert warm.step == 37 + 5 and float(mets["rho"].abs().max()) == 0.0
    want, want_info = warmup.reseed_from_encoder(warm, xt, prior, seed=5)
    got, info = warmup.vae_warmup_reseed(state, xt, config, prior, lr=1e-3, steps=5,
                                         batch_size=16, scan_chunk=3, seed=5, engine=engine)
    assert info == want_info and got.step == 0
    for a, b in zip([want.pgm_nat.dir_nat, *want.pgm_nat.niw_nat],
                    [got.pgm_nat.dir_nat, *got.pgm_nat.niw_nat]):
        assert torch.equal(a, b)
    assert torch.equal(got.nn_params["encoder"][0]["w"], want.nn_params["encoder"][0]["w"])
    # steps = 0 is the reseed alone.
    only, _ = warmup.vae_warmup_reseed(state, xt, config, prior, lr=1e-3, steps=0, seed=5)
    assert torch.equal(only.nn_params["encoder"][0]["w"], state.nn_params["encoder"][0]["w"])
