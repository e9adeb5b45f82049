"""``svax_torch.redraw_probe``'s helpers against the JAX package.

* at the encoder's own potentials, ``local_elbo_from_potentials`` summed
  over the points is ``svax.models.svae.forward``'s recon − local KL at
  the same (converted) state and injected ε, float64 at rtol 1e-9;
* ``iw_from_potentials`` at the encoder's potentials is
  ``evaluation.svae_iw_loglik`` at the same draws, bit for bit;
* the free parameters reproduce the encoder's potentials (both families),
  and a few local-optimisation steps raise the objective;
* the entry runs on the CPU and writes the reference's schema.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.data import make_pinwheel_data
from svax.models import svae as jsvae
from svax.models.svae import SvaeConfig as JConfig
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax_torch import convert, redraw_probe, seed_sweep
from svax_torch.data.pinwheel import load_pinwheel
from svax_torch.models import evaluation
from svax_torch.nets import mlp as nets
from svax_torch.pgm import gmm

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _setup(n=60, k=4, s=3, hidden=(12, 12), seed=0):
    x = jnp.asarray(make_pinwheel_data(num_classes=3, num_per_class=n // 3, seed=seed)[:n])
    jconfig = JConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n,
                      nn_precision=jax.lax.Precision.HIGHEST)
    jprior = jgmm.make_prior(k, 2, kappa=0.05, dtype=jnp.float64)
    jstate = jstep.init_state(jax.random.PRNGKey(seed), 2, jconfig, jprior, optax.adam(1e-3),
                              hidden, hidden, data=x, dtype=jnp.float64)
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate))
    eps = np.random.default_rng(seed + 1).standard_normal((s, n, k, 2))
    return x, jconfig, jprior, jstate, state, eps


@pytest.mark.parametrize("seed", [0, 2])
def test_local_elbo_at_the_encoder_potentials_is_the_forward(seed):
    x, jconfig, jprior, jstate, state, eps = _setup(seed=seed)
    out = jsvae.forward(jstate.nn_params, jstate.pgm_nat, jprior, x, jax.random.PRNGKey(0),
                        jconfig, eps=jnp.asarray(eps))
    xt = torch.tensor(np.asarray(x))
    exp = gmm.expected_params(state.pgm_nat)
    h, p = nets.encoder_apply(state.nn_params["encoder"], xt)
    got = redraw_probe.local_elbo_from_potentials(h, p, state.nn_params["decoder"], exp, xt,
                                                  num_samples=3, eps=torch.tensor(eps))
    assert got.shape == (60,)
    np.testing.assert_allclose(float(got.sum()), float(out.recon - out.local_kl), rtol=1e-9)


def test_iw_from_potentials_is_the_iw_bound():
    x, _, _, _, state, _ = _setup()
    xt = torch.tensor(np.asarray(x))
    rng = np.random.default_rng(5)
    gumbel = torch.tensor(rng.gumbel(size=(8, 60, 4)))
    eps = torch.tensor(rng.standard_normal((8, 60, 4, 2)))
    want = evaluation.svae_iw_loglik(state.nn_params, state.pgm_nat, xt, 8, gumbel=gumbel,
                                     eps=eps)
    exp = gmm.expected_params(state.pgm_nat)
    h, p = nets.encoder_apply(state.nn_params["encoder"], xt)
    got = redraw_probe.iw_from_potentials(h, p, state.nn_params["decoder"], exp, xt, 8,
                                          gumbel=gumbel, eps=eps)
    assert torch.equal(got, want)


@pytest.mark.parametrize("potential", ["diag", "full"])
def test_free_potentials_start_at_the_encoder_and_the_local_fit_climbs(potential):
    train, test = load_pinwheel(seed=0)
    x = torch.tensor(train, dtype=torch.float32)
    xt = torch.tensor(test, dtype=torch.float32)
    config = seed_sweep.make_config(400)
    prior = gmm.make_prior(10, 2, kappa=0.05)
    spec = seed_sweep.parse_variant("steps40", steps=40, chunk=20, engine="plain")
    runner = seed_sweep.make_variant_runner(config, prior, spec, engine="plain", rho=0.05)
    _, state, _ = seed_sweep.train_restarts(x, train, config, prior, runner, spec, seed=1)
    h, p = nets.encoder_apply(state.nn_params["encoder"], xt)
    h0, p0 = redraw_probe.potentials_from(redraw_probe.init_potential_params(h, p, potential))
    if potential == "diag":
        np.testing.assert_allclose(p0.detach().numpy(), p.numpy(), rtol=1e-4)
        np.testing.assert_allclose(h0.detach().numpy(), h.numpy(), rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(torch.diagonal(p0, dim1=-2, dim2=-1).detach().numpy(),
                                   p.numpy(), rtol=1e-4)
        assert float(p0[:, 0, 1].abs().max()) == 0.0
    score, traj = redraw_probe.local_opt_bound(state, xt, seed=1, opt_steps=60,
                                               potential=potential, iw_samples=50)
    assert np.isfinite(score)
    assert traj["opt_obj_last"] > traj["opt_obj_first"], traj


def test_probe_entry_writes_the_reference_schema(tmp_path):
    out = tmp_path / "probe_torch.json"
    res = redraw_probe.main(["--device", "cpu", "--seeds", "3", "--data-seed", "0",
                             "--steps", "20", "--chunk", "10", "--restarts", "2",
                             "--iw-samples", "20", "--opt-steps", "30", "--engine", "kernel",
                             "--json", str(out)])
    got = json.loads(out.read_text())
    ref = json.loads((ROOT / "runs" / "canonical_probe.json").read_text())
    assert set(got) == set(ref) and set(got["rows"][0]) == set(ref["rows"][0])
    assert got["rows"][0]["gmm_bar"] == pytest.approx(-5.409, abs=2e-3)
    assert got["protocol"].startswith("canonical-table (draw fixed at seed 0) recipe "
                                      "(aug0.6+rs2+steps20)")
    assert res["localopt_crossing"] == "0/1"
