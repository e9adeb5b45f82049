"""The port's plain flexstep chunk against the TPU kernel's own body, run
by the Pallas interpreter (svax/ops/flexstep_pallas.py, interpret=True), at
tests/test_flexstep_kernel.py's tolerances: the auto shape class scaled
down (d_in=8, d=4, K=5, S=2, 16-16, ρ decay 1e-3), two steps. In a file
of its own so that pytest-xdist's ``--dist loadfile`` gives the
interpreter a worker to itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from svax.models.svae import SvaeConfig as JConfig
from svax.ops import flexstep_pallas as fsp
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax_torch import convert
from svax_torch.ops import flexstep

torch.set_num_threads(1)


def test_plain_chunk_matches_pallas_interpret():
    n, m, d_in, d, k, s, t = 80, 32, 8, 4, 5, 2, 2
    kx, kinit = jax.random.split(jax.random.PRNGKey(3))
    x = jax.random.normal(kx, (n, d_in), jnp.float32)
    config = JConfig(latent_dim=d, num_components=k, num_samples=s, num_total=n)
    prior = jax.tree.map(lambda a: a.astype(jnp.float32), jgmm.make_prior(k, d, kappa=0.05))
    state = jstep.init_state(kinit, d_in, config, prior, optax.adam(3e-3),
                             encoder_hidden=(16, 16), decoder_hidden=(16, 16), data=x)
    state = jax.tree.map(lambda a: a.astype(jnp.float32)
                         if jnp.issubdtype(a.dtype, jnp.floating) else a, state)
    rng = np.random.default_rng(4)
    batches = x[jnp.asarray(rng.integers(0, n, size=(t, m)))]
    eps = rng.standard_normal((t, s, m, k, d)).astype(np.float32)
    kw = dict(lr=3e-3, rho=0.2, rho_decay=1e-3, num_total=n)
    jst, jm = fsp.train_chunk(state, prior, batches, eps=jnp.asarray(eps), interpret=True,
                              **kw)
    st, mets = flexstep.train_chunk_plain(
        convert.state_from_numpy(jax.tree.map(np.asarray, state), dtype=torch.float32),
        convert.gmm_nat_from_numpy(prior), torch.tensor(np.asarray(batches)),
        eps=torch.tensor(eps), **kw)
    got = convert.state_to_numpy(st)
    want = jax.tree.map(np.asarray, jst)
    for name, g, w, rtol, atol in (
            ("params", got["nn_params"], want.nn_params, 5e-4, 5e-5),
            ("mu", got["adam"]["mu"], want.opt_state[0].mu, 5e-4, 1e-5)):
        for side in ("encoder", "decoder"):
            for gl, wl in zip(g[side], w[side]):
                for key in ("w", "b"):
                    np.testing.assert_allclose(gl[key], wl[key], rtol=rtol, atol=atol,
                                               err_msg=f"{name} {side} {key}")
    for f in ("eta1", "eta2", "eta3", "eta4"):
        np.testing.assert_allclose(got["pgm_nat"][f], getattr(want.pgm_nat.niw_nat, f),
                                   rtol=5e-4, atol=5e-4, err_msg=f)
    np.testing.assert_allclose(got["pgm_nat"]["dir_nat"], want.pgm_nat.dir_nat,
                               rtol=5e-4, atol=5e-4)
    assert got["step"] == int(want.step) == t
    for key, tol in (("recon", 2e-3), ("local_kl", 2e-3), ("neg_loss", 1e-4),
                     ("rho", 1e-6)):
        np.testing.assert_allclose(mets[key].numpy(), np.asarray(jm[key]), rtol=tol,
                                   atol=tol, err_msg=key)
