"""The port's Bernoulli decoder head against the JAX reference.

* ``bernoulli_loglik_decomposed`` (the x-free form ll = ⟨x, o⟩ + Σ_D logσ(−o))
  and the broadcast ``bernoulli_loglik``/``log_likelihood`` against
  ``svax.nets.mlp`` in float32 at rtol 1e-5, values and parameter
  gradients;
* the same under ``compute_dtype=bfloat16`` at rtol 2e-3 of |ll|: bf16 keeps
  8 significant bits, so each rounded activation and logit is off by up to
  2⁻⁹ relative, and XLA and PyTorch round at different places (XLA fuses
  the bias add and tanh before rounding); summed in f32 over 784 pixels the
  two packages differ by ~4e-4 of |ll| at the mnist width (measured), and
  each differs from the f32 result by as much;
* the Bernoulli decoder's parameters (a D-wide last layer) through
  ``convert``, bit-exact both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.models.svae import SvaeConfig as JConfig
from svax.nets import mlp as jnets
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax_torch import convert
from svax_torch.models import svae
from svax_torch.models.svae import SvaeConfig
from svax_torch.nets import mlp as nets

torch.set_num_threads(1)
HIGHEST = jax.lax.Precision.HIGHEST
BF16_RTOL = 2e-3


def _params(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _torch_params(params, requires_grad=False):
    return [{k: torch.tensor(v, requires_grad=requires_grad) for k, v in ly.items()}
            for ly in params]


def _data(s, n, k, d, d_out, seed=1):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((s, n, k, d)).astype(np.float32)
    x = (rng.random((n, d_out)) < 0.3).astype(np.float32)
    return z, x


@pytest.mark.parametrize("s,n,k,d,hidden,d_out", [(2, 12, 5, 3, (16, 16), 20),
                                                  (1, 16, 10, 8, (200, 200), 784)])
def test_decomposed_matches_jax_in_float32(s, n, k, d, hidden, d_out):
    params = _params([d, *hidden, d_out])
    z, x = _data(s, n, k, d, d_out)
    jp = jax.tree.map(jnp.asarray, params)
    jfun = lambda p: jnets.bernoulli_loglik_decomposed(p, z, x, precision=HIGHEST)  # noqa: E731
    want = np.asarray(jfun(jp))
    tp = _torch_params(params, requires_grad=True)
    got = nets.bernoulli_loglik_decomposed(tp, torch.tensor(z), torch.tensor(x))
    assert got.shape == (s, n, k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    jg = jax.grad(lambda p: jnp.sum(jfun(p)))(jp)
    g = torch.autograd.grad(got.sum(), [t for ly in tp for t in ly.values()])
    for gi, wi in zip(g, [jg[i][name] for i in range(len(params)) for name in ("w", "b")]):
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(wi).max()))


@pytest.mark.parametrize("s,n,k,d,hidden,d_out", [(2, 12, 5, 3, (16, 16), 20),
                                                  (1, 16, 10, 8, (200, 200), 784)])
def test_decomposed_matches_jax_in_bfloat16(s, n, k, d, hidden, d_out):
    params = _params([d, *hidden, d_out], seed=2)
    z, x = _data(s, n, k, d, d_out, seed=3)
    want = np.asarray(jnets.bernoulli_loglik_decomposed(
        jax.tree.map(jnp.asarray, params), z, x, compute_dtype=jnp.bfloat16))
    got = nets.bernoulli_loglik_decomposed(_torch_params(params), torch.tensor(z),
                                           torch.tensor(x), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_RTOL)
    f32 = nets.bernoulli_loglik_decomposed(_torch_params(params), torch.tensor(z),
                                           torch.tensor(x))
    assert not torch.equal(got, f32)  # the body really ran in bf16


def test_broadcast_form_matches_jax_and_the_decomposition():
    s, n, k, d, d_out = 2, 10, 4, 3, 30
    params = _params([d, 12, 12, d_out], seed=4)
    z, x = _data(s, n, k, d, d_out, seed=5)
    jp = jax.tree.map(jnp.asarray, params)
    logits = jnets.decoder_apply(jp, z, "bernoulli", precision=HIGHEST)
    want = np.asarray(jnets.bernoulli_loglik(x[None, :, None, :], logits))
    tp = _torch_params(params)
    got_logits = nets.decoder_apply(tp, torch.tensor(z), "bernoulli")
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), rtol=1e-5, atol=1e-6)
    got = nets.bernoulli_loglik(torch.tensor(x)[None, :, None, :], got_logits)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    ll = nets.log_likelihood(tp, torch.tensor(z), torch.tensor(x)[None, :, None, :],
                             "bernoulli")
    assert torch.equal(ll, got)
    # The decomposition is an identity: float64, the same parameters.
    tp64 = [{k_: v.double() for k_, v in ly.items()} for ly in tp]
    z64, x64 = torch.tensor(z, dtype=torch.float64), torch.tensor(x, dtype=torch.float64)
    np.testing.assert_allclose(
        nets.bernoulli_loglik_decomposed(tp64, z64, x64).numpy(),
        nets.log_likelihood(tp64, z64, x64[None, :, None, :], "bernoulli").numpy(),
        rtol=1e-12)


def test_bernoulli_decoder_convert_round_trip():
    """The mnist-svae state (784 → 200-200 → 16, 8 → 200-200 → 784) from
    the JAX package converts to the port and back bit-exactly; the port's
    own init builds the same shapes."""
    key = jax.random.PRNGKey(0)
    jconfig = JConfig(latent_dim=8, num_components=10, num_samples=1,
                      likelihood="bernoulli", num_total=6000)
    jstate = jstep.init_state(key, 784, jconfig, jgmm.make_prior(10, 8), optax.adam(1e-3),
                              (200, 200), (200, 200))
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate))
    assert state.nn_params["decoder"][2]["w"].shape == (200, 784)
    assert state.nn_params["decoder"][2]["b"].shape == (784,)
    assert state.nn_params["encoder"][2]["w"].shape == (200, 16)
    back = convert.state_to_numpy(state)
    for side in ("encoder", "decoder"):
        for gl, wl in zip(back["nn_params"][side], jstate.nn_params[side]):
            for name in ("w", "b"):
                np.testing.assert_array_equal(gl[name], np.asarray(wl[name]))
    mine = svae.init_params(torch.Generator().manual_seed(0), 784,
                            SvaeConfig(latent_dim=8, num_components=10,
                                       likelihood="bernoulli"), (200, 200), (200, 200))
    for side in ("encoder", "decoder"):
        assert [tuple(ly["w"].shape) for ly in mine[side]] == \
            [tuple(ly["w"].shape) for ly in state.nn_params[side]]
