"""The port's ``expfam.mvn`` and ``expfam.base`` against the JAX reference
(float64): every ``mvn`` function at rtol 1e-10 (the reparameterised draw
with the reference's ε injected), and ``base.implements`` on the port's
four families."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.expfam import base as jbase
from svax.expfam import mvn as jmvn
from svax_torch.expfam import base, beta, dirichlet, mvn, niw

torch.set_num_threads(1)


def _close(got, want, rtol=1e-10, what=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=1e-12,
                               err_msg=what)


def _spd(rng, batch, d):
    a = rng.standard_normal(batch + (d, d))
    return a @ np.swapaxes(a, -1, -2) + d * np.eye(d)


@pytest.mark.parametrize("d", [1, 3, 5])
def test_mvn_matches_jax(d):
    rng = np.random.default_rng(d)
    mean = rng.standard_normal((4, d))
    cov = _spd(rng, (4,), d)
    x = rng.standard_normal((4, d))
    nat = mvn.standard_to_natural(torch.tensor(mean), torch.tensor(cov))
    jnat = jmvn.standard_to_natural(jnp.asarray(mean), jnp.asarray(cov))
    _close(nat.h, jnat.h, what="h")
    _close(nat.prec, jnat.prec, what="prec")
    m, c = mvn.natural_to_standard(nat)
    jm, jc = jmvn.natural_to_standard(jnat)
    _close(m, jm)
    _close(c, jc)
    _close(m, mean, 1e-9, "round trip mean")
    _close(c, cov, 1e-9, "round trip cov")
    _close(mvn.log_partition(nat), jmvn.log_partition(jnat))
    _close(mvn.log_prob(nat, torch.tensor(x)), jmvn.log_prob(jnat, jnp.asarray(x)))
    e1, e2 = mvn.expected_stats(torch.tensor(mean), torch.tensor(cov))
    j1, j2 = jmvn.expected_stats(jnp.asarray(mean), jnp.asarray(cov))
    _close(e1, j1)
    _close(e2, j2)
    q2 = mvn.standard_to_natural(torch.tensor(mean[::-1].copy()),
                                 torch.tensor(cov[::-1].copy()))
    jq2 = jmvn.standard_to_natural(jnp.asarray(mean[::-1]), jnp.asarray(cov[::-1]))
    _close(mvn.kl(nat, q2), jmvn.kl(jnat, jq2))
    _close(mvn.kl(nat, nat), np.zeros(4), what="KL(q||q)")


def test_sample_from_precision_with_injected_eps():
    rng = np.random.default_rng(9)
    d = 3
    mean = rng.standard_normal((5, d))
    chol = np.linalg.cholesky(_spd(rng, (5,), d))
    key = jax.random.PRNGKey(4)
    want = jmvn.sample_from_precision(key, jnp.asarray(mean), jnp.asarray(chol), (2,))
    eps = np.asarray(jax.random.normal(key, (2, 5, d), dtype=jnp.float64))
    got = mvn.sample_from_precision(None, torch.tensor(mean), torch.tensor(chol), (2,),
                                    eps=torch.tensor(eps))
    _close(got, want)
    drawn = mvn.sample_from_precision(torch.Generator().manual_seed(0), torch.tensor(mean),
                                      torch.tensor(chol), (7,))
    assert drawn.shape == (7, 5, d) and bool(torch.isfinite(drawn).all())


def test_base_implements_on_the_port_families():
    for module in (beta, dirichlet, mvn, niw):
        assert base.implements(module), module.__name__
        assert jbase.implements(module)  # the reference's protocol agrees
    assert base._REQUIRED == jbase._REQUIRED
    assert not base.implements(torch)
