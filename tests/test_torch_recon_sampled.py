"""The sampled-component reconstruction estimator (``SvaeConfig.recon_mode
= "sampled"``, ``models.svae._recon_sampled``) against the JAX package.

At one JAX key the test reproduces the reference's draws —
``jax.random.split(key)`` → ``gumbel(k_cat, (S, N, K))`` and
``normal(k_norm, (S, N, d))`` — and injects them into the port
(``forward(sampled_draws=)``): the ELBO terms and every encoder and decoder
gradient (the REINFORCE term's included) match at rtol 1e-8 in float64,
for S = 1 (the leave-one-out batch baseline) and S = 4 (the leave-one-out
sample baseline), Gaussian and Bernoulli heads. Then the estimator is
unbiased against the weighted one (Monte Carlo, 4 standard errors), the
refusals (component sharding, injected ε, the SMM prior), the entry at a
small size, and resume bit for bit.
"""

import json

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
from svax_torch import convert, train_svae
from svax_torch.models import svae, svae_smm
from svax_torch.models.svae import SvaeConfig
from svax_torch.pgm import gmm
from svax_torch.train import loop, svae_step
from svax_torch.train.checkpoint import Checkpointer

torch.set_num_threads(1)
HI = jax.lax.Precision.HIGHEST


def _setup(s, likelihood="gaussian", n=36, k=4, d=2, seed=0, head="diag"):
    if likelihood == "gaussian":
        x = make_pinwheel_data(num_classes=3, num_per_class=n // 3, seed=seed)[:n]
    else:
        x = (np.random.default_rng(seed).random((n, 10)) < 0.4).astype(np.float64)
    x = jnp.asarray(x, jnp.float64)
    jconfig = JConfig(latent_dim=d, num_components=k, num_samples=s, num_total=3 * n,
                      likelihood=likelihood, nn_precision=HI, recon_mode="sampled",
                      encoder_head=head)
    jprior = jgmm.make_prior(k, d, kappa=0.05, dtype=jnp.float64)
    jstate = jstep.init_state(jax.random.PRNGKey(seed), x.shape[1], jconfig, jprior,
                              optax.adam(1e-3), (16, 16), (16, 16), dtype=jnp.float64)
    config = SvaeConfig(latent_dim=d, num_components=k, num_samples=s, num_total=3 * n,
                        likelihood=likelihood, nn_precision="highest", recon_mode="sampled",
                        encoder_head=head)
    return dict(x=x, xt=torch.tensor(np.asarray(x)), jconfig=jconfig, jprior=jprior,
                jstate=jstate, config=config,
                state=convert.state_from_numpy(jax.tree.map(np.asarray, jstate)),
                prior=convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior)))


def _reference_draws(key, s, n, k, d):
    """The reference's _recon_sampled draws from ``key`` (svax/models/svae.py:303-317)."""
    k_cat, k_norm = jax.random.split(key)
    return (np.asarray(jax.random.gumbel(k_cat, (s, n, k), dtype=jnp.float64)),
            np.asarray(jax.random.normal(k_norm, (s, n, d), dtype=jnp.float64)))


def _loss_grads_jax(c, key):
    n = c["x"].shape[0]

    def loss(nn):
        out = jsvae.forward(nn, c["jstate"].pgm_nat, c["jprior"], c["x"], key, c["jconfig"])
        return -(out.recon - out.local_kl) / n, out

    (_, out), g = jax.value_and_grad(loss, has_aux=True)(c["jstate"].nn_params)
    return out, [np.asarray(ly[name]) for side in ("encoder", "decoder") for ly in g[side]
                 for name in ("w", "b")]


def _loss_grads_port(c, draws):
    params = svae_step.map_params(lambda t: t.clone().requires_grad_(True),
                                  c["state"].nn_params)
    out = svae.forward(params, c["state"].pgm_nat, c["prior"], c["xt"], c["config"],
                       sampled_draws=tuple(torch.tensor(a) for a in draws))
    leaves = [t for side in params.values() for ly in side for t in ly.values()]
    return out, torch.autograd.grad(-(out.recon - out.local_kl) / c["xt"].shape[0], leaves)


@pytest.mark.parametrize("s,likelihood,head", [(1, "gaussian", "diag"), (4, "gaussian", "diag"),
                                               (4, "bernoulli", "diag"), (1, "gaussian", "full")])
def test_sampled_forward_and_grads_match_jax_at_one_key(s, likelihood, head):
    c = _setup(s, likelihood, head=head)
    key = jax.random.PRNGKey(11)
    jout, jg = _loss_grads_jax(c, key)
    n, k = c["x"].shape[0], 4
    out, g = _loss_grads_port(c, _reference_draws(key, s, n, k, 2))
    for name in ("elbo", "recon", "local_kl", "global_kl"):
        got = float(getattr(out, name).detach())
        np.testing.assert_allclose(got, float(getattr(jout, name)), rtol=1e-8, err_msg=name)
    assert len(g) == len(jg)
    for got, want in zip(g, jg):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=1e-11)


def test_reinforce_term_reaches_the_encoder():
    """Without the REINFORCE term the encoder's gradient differs: the
    surrogate adds E[ll·∇log r̃], which sampling k̂ would drop."""
    c = _setup(4)
    draws = _reference_draws(jax.random.PRNGKey(2), 4, 36, 4, 2)
    _, g = _loss_grads_port(c, draws)
    orig = svae._recon_sampled

    def without(*a, **kw):
        # The same estimator with the log r̃ gradient path cut.
        post = a[1]._replace(log_resp=a[1].log_resp.detach())
        return orig(a[0], post, *a[2:], **kw)

    svae._recon_sampled = without
    try:
        _, g0 = _loss_grads_port(c, draws)
    finally:
        svae._recon_sampled = orig
    assert not torch.allclose(g[0], g0[0])  # encoder W1
    torch.testing.assert_close(g[-1], g0[-1], rtol=0.0, atol=0.0)  # decoder b3


def test_sampled_is_unbiased_for_the_weighted_recon():
    """The mean of the sampled recon over 400 seeded draws equals the
    weighted recon's mean over 400 draws within 4 combined standard errors
    (both estimate Σ_k r̃ E_q[log p(x|z)]; float64, N = 12, K = 3, S = 1)."""
    c = _setup(1, n=12, k=3)
    state, prior, x = c["state"], c["prior"], c["xt"]
    gen = torch.Generator().manual_seed(0)
    vals = {"sampled": [], "weighted": []}
    with torch.no_grad():
        for mode in vals:
            cfg = c["config"]._replace(recon_mode=mode)
            for _ in range(400):
                vals[mode].append(float(svae.forward(state.nn_params, state.pgm_nat, prior, x,
                                                     cfg, generator=gen).recon))
    a, b = np.array(vals["sampled"]), np.array(vals["weighted"])
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) < 4.0 * se, (a.mean(), b.mean(), se)


def test_sampled_refusals():
    c = _setup(2)
    args = (c["state"].nn_params, c["state"].pgm_nat, c["prior"], c["xt"], c["config"])
    with pytest.raises(ValueError, match="sampled_draws"):
        svae.forward(*args, eps=torch.zeros(2, 36, 4, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="component parallelism"):
        svae.forward(*args, comp_group=object())
    with pytest.raises(ValueError, match="component parallelism"):
        loop.make_step_runner(c["config"], c["prior"], lr=1e-3, rho=0.1, comp_group=object())
    with pytest.raises(ValueError, match="weighted recon estimator only"):
        svae_smm.forward(*args[:4], c["config"]._replace(dof=4.0))
    with pytest.raises(ValueError, match="unknown recon_mode"):
        svae.check_recon_mode(c["config"]._replace(recon_mode="stratified"))
    assert loop.choose_kernel(c["config"], batch_full=True, encoder_hidden=(16, 16),
                              decoder_hidden=(16, 16), rho=0.1, engine="auto") == loop.PER_STEP


def test_train_svae_sampled_runs(capsys):
    out = train_svae.main(["--config", "pinwheel-svae", "--device", "cpu", "--steps", "6",
                           "--recon-mode", "sampled", "--nn-precision", "highest",
                           "--iw-samples", "3"])
    first = json.loads(capsys.readouterr().out.splitlines()[0])
    assert first["recon_mode"] == "sampled" and first["nn_precision"] == "highest"
    assert out["kernel"] == loop.PER_STEP and "recon_mode='weighted'" in out["why"]
    assert np.isfinite(out["rows"][-1]["elbo"])


def test_train_svae_refuses_sampled_with_the_smm_prior(capsys):
    with pytest.raises(SystemExit):
        train_svae.main(["--config", "pinwheel-svae", "--device", "cpu", "--steps", "1",
                         "--recon-mode", "sampled", "--smm-dof", "4"])
    assert "weighted estimator only" in capsys.readouterr().err


def test_exact_resume_with_sampled_recon(tmp_path):
    """The per-step engine's generator (keyed seed + step) draws the sampled
    estimator's noise: two chunks equal chunk → save → restore → chunk."""
    x = torch.tensor(make_pinwheel_data(num_classes=3, num_per_class=12, seed=0))
    config = SvaeConfig(latent_dim=2, num_components=3, num_samples=2, num_total=36,
                        recon_mode="sampled")
    prior = gmm.make_prior(3, 2, kappa=0.05, dtype=torch.float64)
    state0 = svae_step.init_state(torch.Generator().manual_seed(0), 2, config, prior,
                                  (8,), (8,), data=x)
    fresh = svae_step.init_state(torch.Generator().manual_seed(5), 2, config, prior,
                                 (8,), (8,), data=x)
    runner = loop.make_step_runner(config, prior, lr=1e-3, rho=0.2, batch_size=24)
    ref, _ = runner(state0, x, 3, seed=2)
    ref, _ = runner(ref, x, 3, seed=2)
    half, _ = runner(state0, x, 3, seed=2)
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(3, half)
    restored, _, _ = ckpt.restore_or(fresh)
    resumed, _ = runner(restored, x, 3, seed=2)
    for side in ("encoder", "decoder"):
        for a, b in zip(ref.nn_params[side], resumed.nn_params[side]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    assert torch.equal(ref.pgm_nat.niw_nat.eta3, resumed.pgm_nat.niw_nat.eta3)
    other, _ = runner(restored, x, 3, seed=3)
    assert not torch.equal(other.nn_params["decoder"][0]["w"],
                           resumed.nn_params["decoder"][0]["w"])
