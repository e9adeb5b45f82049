"""svax_torch.convert: JAX training state → port → back is bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.data import make_pinwheel_data
from svax.expfam.niw import NiwNat as JNiwNat
from svax.models.svae import SvaeConfig as JConfig
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax_torch import convert

torch.set_num_threads(1)


def _jax_state(dtype):
    """A JAX SvaeTrainState two steps in, so Adam's count and moments are
    non-trivial."""
    x = jnp.asarray(make_pinwheel_data(num_classes=3, num_per_class=20, seed=0),
                    dtype)
    config = JConfig(latent_dim=2, num_components=4, num_samples=2, num_total=60)
    cast = lambda t: jax.tree.map(  # noqa: E731
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
    prior = cast(jgmm.make_prior(4, 2, kappa=0.05))
    opt = optax.adam(1e-3)
    state = cast(jstep.init_state(jax.random.PRNGKey(0), 2, config, prior, opt,
                                  (8, 8), (8, 8), data=x))
    step = jax.jit(jstep.make_train_step(config, prior, opt, 0.1))
    for i in range(2):
        state, _ = step(state, x, jax.random.PRNGKey(i))
    return state, prior


def _to_jax(d, template):
    """Inverse of convert.state_to_numpy, onto the JAX package's types."""
    adam = template.opt_state[0]._replace(
        count=jnp.asarray(d["adam"]["count"]),
        mu=jax.tree.map(jnp.asarray, d["adam"]["mu"]),
        nu=jax.tree.map(jnp.asarray, d["adam"]["nu"]),
    )
    nat = d["pgm_nat"]
    return jstep.SvaeTrainState(
        nn_params=jax.tree.map(jnp.asarray, d["nn_params"]),
        opt_state=(adam,) + tuple(template.opt_state[1:]),
        pgm_nat=jgmm.GmmNat(
            dir_nat=jnp.asarray(nat["dir_nat"]),
            niw_nat=JNiwNat(*(jnp.asarray(nat[f]) for f in ("eta1", "eta2", "eta3", "eta4"))),
        ),
        step=jnp.asarray(d["step"]),
    )


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_state_round_trip_is_bit_exact(dtype):
    jstate, _ = _jax_state(dtype)
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate))
    assert state.step == 2 and state.opt_state.count == 2
    assert state.nn_params["encoder"][0]["w"].dtype == (
        torch.float32 if dtype == jnp.float32 else torch.float64)
    back = _to_jax(convert.state_to_numpy(state), jstate)
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_prior_round_trip_and_dtype_cast():
    _, jprior = _jax_state(jnp.float64)
    prior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior))
    back = convert.gmm_nat_to_numpy(prior)
    np.testing.assert_array_equal(back["dir_nat"], np.asarray(jprior.dir_nat))
    for f in ("eta1", "eta2", "eta3", "eta4"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jprior.niw_nat, f)))
    f32 = convert.gmm_nat_from_numpy(jprior, dtype=torch.float32)
    assert f32.niw_nat.eta3.dtype == torch.float32
    assert f32.niw_nat.eta3.shape == (4, 2, 2)


def test_converted_tensors_do_not_alias_the_source():
    jstate, _ = _jax_state(jnp.float32)
    src = jax.tree.map(np.array, jstate)
    state = convert.state_from_numpy(src)
    state.nn_params["decoder"][0]["w"].add_(1.0)
    np.testing.assert_array_equal(src.nn_params["decoder"][0]["w"],
                                  np.asarray(jstate.nn_params["decoder"][0]["w"]))
