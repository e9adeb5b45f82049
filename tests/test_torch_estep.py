"""The port's fused E-step against the JAX reference.

* the plain version (``e_step_stats_reference``, which
  ``e_step_stats_fused`` runs on CPU tensors) against the JAX twin
  ``estep_pallas.e_step_stats_reference`` in float64 at rtol 1e-9, d = 2
  and d = 3; its packing helpers to the last bits;
* against the TPU kernel's own body, ``e_step_stats_fused(interpret=True)``,
  in float32 at a non-aligned N, at benchmarks/bench_estep.py's bars
  (statistics: max error over max |reference| < 5e-5; evidence: max
  absolute error < 1e-3);
* the wrapper's routing, launch counter and rejections. The CUDA kernel
  itself is held to the plain version on the card by
  tests/test_torch_cuda_mixture.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.data import make_pinwheel_data
from svax.ops import estep_pallas
from svax.pgm import gmm as jgmm
from svax_torch import convert
from svax_torch.ops import estep
from svax_torch.pgm import gmm

torch.set_num_threads(1)


def _setup(n, k, d, seed=0, dtype=jnp.float64):
    if d == 2:
        x = make_pinwheel_data(num_classes=5, num_per_class=-(-n // 5), seed=seed)[:n]
    else:
        x = np.random.default_rng(seed).standard_normal((n, d))
    x = np.asarray(x, np.float64 if dtype == jnp.float64 else np.float32)
    jprior = jgmm.make_prior(k, d, dtype=dtype)
    jnat = jgmm.init_variational(jax.random.PRNGKey(seed), jprior, jnp.asarray(x))
    nat = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jnat))
    return x, jgmm.expected_params(jnat), gmm.expected_params(nat)


@pytest.mark.parametrize("d", [2, 3])
def test_plain_matches_jax_twin_float64(d):
    x, jexp, exp = _setup(100, 7, d, seed=d)
    before = estep.launches
    stats, ev = estep.e_step_stats_fused(torch.tensor(x), exp, scale=3.0)
    assert estep.launches == before  # CPU tensors take the plain version
    jstats, jev = estep_pallas.e_step_stats_reference(jnp.asarray(x), jexp, scale=3.0)
    np.testing.assert_allclose(ev.numpy(), np.asarray(jev), rtol=1e-9)
    for got, want in zip(stats, jstats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)
    # ... and the einsum path of pgm.gmm, which the GMM step uses unfused
    resp, ev2 = gmm.e_step_obs(torch.tensor(x), exp)
    np.testing.assert_allclose(ev.numpy(), ev2.numpy(), rtol=1e-12)
    for got, want in zip(stats, gmm.suff_stats_obs(torch.tensor(x), resp, scale=3.0)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-12)


def test_packing_helpers_match_jax():
    x, jexp, exp = _setup(20, 4, 3, seed=1)
    # the expected params differ from the JAX ones in the last bits only
    np.testing.assert_allclose(estep.pack_coeffs(exp).numpy(),
                               np.asarray(estep_pallas.pack_coeffs(jexp, jnp.float64)),
                               rtol=1e-12)
    np.testing.assert_array_equal(estep._features(torch.tensor(x)).numpy(),
                                  np.asarray(estep_pallas._features(jnp.asarray(x))))
    raw = np.random.default_rng(0).standard_normal((13, 4))
    for got, want in zip(estep.unpack_stats(torch.tensor(raw), 3),
                         estep_pallas.unpack_stats(jnp.asarray(raw), 3)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)


@pytest.mark.parametrize("n,k,d", [(300, 10, 2), (700, 6, 3)])
def test_plain_matches_pallas_interpret_float32(n, k, d):
    """N = 300 and 700 are not multiples of the 128-point tile."""
    x, jexp, exp = _setup(n, k, d, seed=4, dtype=jnp.float32)
    stats, ev = estep.e_step_stats_fused(torch.tensor(x), exp, scale=2.0)
    jstats, jev = estep_pallas.e_step_stats_fused(jnp.asarray(x), jexp, scale=2.0,
                                                  tile_n=128, interpret=True)
    for got, want, name in zip(stats, jstats, jstats._fields):
        want = np.asarray(want, np.float64)
        err = np.abs(got.double().numpy() - want).max() / (np.abs(want).max() + 1e-30)
        assert err < 5e-5, (name, err)
    assert np.abs(ev.double().numpy() - np.asarray(jev, np.float64)).max() < 1e-3


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, _, exp = _setup(30, 4, 2)
    x32 = torch.zeros((30, 2))
    assert estep.unsupported_reason(x32, exp) is None
    assert "float32" in estep.unsupported_reason(x32.double(), exp)
    assert "contiguous" in estep.unsupported_reason(torch.zeros((2, 30)).T, exp)
    _, _, wide = _setup(30, 4, estep.MAX_DIM + 1)
    assert "d = 11" in estep.unsupported_reason(torch.zeros((30, 11)), wide)
    _, _, many = _setup(200, estep.MAX_COMPONENTS + 1, 2)
    assert "K = 129" in estep.unsupported_reason(x32, many)
    assert "expected params" in estep.unsupported_reason(torch.zeros((30, 3)), exp)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        estep.e_step_stats_fused(torch.zeros((30, 2), device="meta"), exp)
