"""The port's mnist-svae path around the combine kernel, against the JAX
reference.

* two mnist-path train steps at full width (784 → 200-200 → 16, 8 → 200-200
  → 784 Bernoulli, K = 10, S = 1, M = 256, ρ₀ = 0.1 with decay 1e-3) on a
  converted state with injected numpy ε, the fused combine's plain version
  and the f32 decoder, against the reference's ``make_train_step`` (its
  sin_combine path, the same function): parameters, Adam moments,
  naturals and the metrics in float64 at rtol 1e-8;
* the same step with the bf16 decoder body against the reference's bf16
  step: the ELBO terms at 2e-3 (tests/test_torch_bernoulli.py's bf16 bar);
* the engine gate, the per-step runner and ``train_svae --config
  mnist-svae`` on the CPU;
* a port of tests/test_mnist_quality_pin.py (slow, as the original).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.data import load_mnist as jload_mnist
from svax.models import svae as jsvae
from svax.models.svae import SvaeConfig as JConfig
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax_torch import convert, train_svae
from svax_torch.data import load_mnist
from svax_torch.models import evaluation, svae
from svax_torch.models.svae import SvaeConfig
from svax_torch.nets import mlp as nets
from svax_torch.ops import combine
from svax_torch.pgm import gmm
from svax_torch.train import loop, svae_step, warmup

torch.set_num_threads(1)


class _InjectedEps:
    """svax.models.svae as make_train_step's ``model``, with the batch
    carrying (x, ε) so the reference step runs at injected noise."""

    @staticmethod
    def forward(nn, nat, prior, batch, key, config, axis_comp=None):
        x, eps = batch
        return jsvae.forward(nn, nat, prior, x, key, config, eps=eps, axis_comp=axis_comp)


def _mnist_setup(dtype, compute="float32", m=256):
    x, _, _ = jload_mnist(seed=0, max_train=1000)
    n = x.shape[0]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jconfig = JConfig(latent_dim=8, num_components=10, num_samples=1,
                      likelihood="bernoulli", num_total=n,
                      nn_precision=jax.lax.Precision.HIGHEST, nn_compute_dtype=compute)
    cast = lambda t: jax.tree.map(  # noqa: E731
        lambda a: a.astype(jdt) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
    jprior = cast(jgmm.make_prior(10, 8, alpha=1.0, kappa=0.05))
    jstate = cast(jstep.init_state(jax.random.PRNGKey(0), 784, jconfig, jprior,
                                   optax.adam(1e-3), (200, 200), (200, 200)))
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate), dtype=dtype)
    prior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior), dtype=dtype)
    config = SvaeConfig(latent_dim=8, num_components=10, num_samples=1, num_total=n,
                        likelihood="bernoulli", nn_compute_dtype=compute,
                        fused_combine=True, kernel_rng=True)
    rng = np.random.default_rng(7)
    idx = rng.integers(0, n, size=(2, m))
    eps = rng.standard_normal((2, 1, m, 10, 8))
    return x.astype(np.float64 if dtype == torch.float64 else np.float32), jconfig, \
        jprior, jstate, config, prior, state, idx, eps


def test_two_mnist_steps_match_jax_in_float64():
    x, jconfig, jprior, jstate, config, prior, state, idx, eps = _mnist_setup(torch.float64)
    rho = lambda t: 0.1 / (1.0 + 0.001 * t)  # noqa: E731
    jrun = jax.jit(jstep.make_train_step(jconfig, jprior, optax.adam(1e-3), rho=rho,
                                         model=_InjectedEps))
    step = svae_step.make_train_step(config, prior, 1e-3, svae_step.rho_schedule(0.1, 1e-3))
    xt = torch.tensor(x)
    for t in range(2):
        jstate, jm = jrun(jstate, (jnp.asarray(x[idx[t]]), jnp.asarray(eps[t])),
                          jax.random.PRNGKey(0))
        state, mets = step(state, xt[torch.tensor(idx[t])], eps=torch.tensor(eps[t]))
        for name in ("elbo", "recon", "local_kl", "global_kl", "rho"):
            np.testing.assert_allclose(float(mets[name]), float(jm[name]), rtol=1e-8,
                                       err_msg=name)
    got = convert.state_to_numpy(state)
    want = jax.tree.map(np.asarray, jstate)
    adam = want.opt_state[0]
    for side in ("encoder", "decoder"):
        for i, wl in enumerate(want.nn_params[side]):
            for name in ("w", "b"):
                for g, w, what in ((got["nn_params"], wl, "params"),
                                   (got["adam"]["mu"], adam.mu[side][i], "adam m"),
                                   (got["adam"]["nu"], adam.nu[side][i], "adam v")):
                    np.testing.assert_allclose(g[side][i][name], w[name], rtol=1e-8,
                                               atol=1e-12, err_msg=f"{what} {side}{i}.{name}")
    np.testing.assert_allclose(got["pgm_nat"]["dir_nat"], want.pgm_nat.dir_nat, rtol=1e-8)
    for f in ("eta1", "eta2", "eta3", "eta4"):
        np.testing.assert_allclose(got["pgm_nat"][f], getattr(want.pgm_nat.niw_nat, f),
                                   rtol=1e-8, atol=1e-10, err_msg=f)
    assert got["step"] == 2 and got["adam"]["count"] == 2


def test_mnist_forward_with_the_bf16_decoder_matches_jax():
    x, jconfig, jprior, jstate, config, prior, state, idx, eps = _mnist_setup(
        torch.float32, compute="bfloat16", m=64)
    jout = jsvae.forward(jstate.nn_params, jstate.pgm_nat, jprior, jnp.asarray(x[idx[0]]),
                         jax.random.PRNGKey(0), jconfig, eps=jnp.asarray(eps[0], jnp.float32))
    out = svae.forward(state.nn_params, state.pgm_nat, prior,
                       torch.tensor(x[idx[0]]), config, eps=torch.tensor(eps[0]).float())
    for name in ("elbo", "recon"):
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(jout, name)), rtol=2e-3, err_msg=name)
    np.testing.assert_allclose(float(out.local_kl.detach()), float(jout.local_kl), rtol=2e-4)


def test_gate_sends_mnist_to_the_per_step_engine():
    config = SvaeConfig(latent_dim=8, num_components=10, num_samples=1, num_total=6000,
                        likelihood="bernoulli", fused_combine=True, kernel_rng=True)
    gate = dict(batch_full=False, encoder_hidden=(200, 200), decoder_hidden=(200, 200),
                rho=0.1, rho_decay=1e-3, likelihood="bernoulli", input_dim=784)
    assert loop.choose_kernel(config, engine="auto", **gate) == loop.PER_STEP
    with pytest.raises(ValueError, match="fits neither kernel"):
        loop.choose_kernel(config, **gate)
    reason = loop.kernel_unsupported_reason(config, **gate)
    assert "latent d = 2 (got 8)" in reason and "latent d <= 6 (got 8)" in reason
    auto_cfg = SvaeConfig(latent_dim=4, num_components=10, num_samples=4, num_total=352)
    assert loop.choose_kernel(auto_cfg, engine="auto", batch_full=False,
                              encoder_hidden=(100, 100), decoder_hidden=(100, 100),
                              rho=0.2, rho_decay=1e-3, input_dim=8) == "flexstep"
    with pytest.raises(ValueError, match="unknown engine"):
        loop.choose_kernel(config, engine="xla", **gate)


def test_step_runner_draws_with_replacement_and_seeds_the_combine(monkeypatch):
    n, d_in = 50, 12
    gen = torch.Generator().manual_seed(0)
    x = (torch.rand(n, d_in, generator=gen) < 0.3).float()
    config = SvaeConfig(latent_dim=3, num_components=4, num_samples=1, num_total=n,
                        likelihood="bernoulli", fused_combine=True, kernel_rng=True)
    prior = gmm.make_prior(4, 3)
    state = svae_step.init_state(gen, d_in, config, prior, (8,), (8,))
    seen = []
    real = combine.combine_fused

    def spy(*args, **kw):
        seen.append((args[0].shape[0], args[3], kw["seed"], kw["step"]))
        return real(*args, **kw)

    monkeypatch.setattr(combine, "combine_fused", spy)
    runner = loop.make_step_runner(config, prior, lr=1e-3, rho=0.1, rho_decay=0.01,
                                   batch_size=16)
    st, mets = runner(state, x, 3, seed=9)
    g = torch.Generator().manual_seed(9)
    torch.randint(0, n, (3, 16), generator=g)
    chunk_seed = int(torch.randint(0, 2**62, (1,), generator=g))
    assert [(m_, e, s_, t_) for m_, e, s_, t_ in seen] == [(16, None, chunk_seed, t)
                                                          for t in range(3)]
    assert st.step == 3 and set(mets) == {"elbo", "recon", "local_kl", "global_kl",
                                          "neg_loss", "rho"}
    assert mets["elbo"].shape == (3,)
    np.testing.assert_allclose(mets["rho"].numpy(), [0.1 / (1 + 0.01 * t) for t in range(3)],
                               rtol=1e-6)
    again, _ = runner(state, x, 3, seed=9)
    assert torch.equal(again.pgm_nat.niw_nat.eta3, st.pgm_nat.niw_nat.eta3)
    seen.clear()
    plain = loop.make_step_runner(config, prior, lr=1e-3, rho=0.1, batch_size=16,
                                  engine="plain")
    plain(state, x, 2, seed=9)
    assert seen == []  # the plain engine runs sin_combine
    eps = torch.tensor(np.random.default_rng(0).standard_normal((2, 1, 16, 4, 3)),
                       dtype=torch.float32)
    runner(state, x, 2, seed=9, eps=eps)
    assert [e is not None and s_ is None for _, e, s_, _ in seen] == [True, True]


def test_train_svae_mnist_cpu_runs(capsys):
    out = train_svae.main(["--config", "mnist-svae", "--device", "cpu", "--steps", "20",
                           "--warmup-steps", "20", "--iw-samples", "2"])
    first = capsys.readouterr().out.splitlines()[0]
    assert '"kernel": "per-step"' in first and '"synthetic": true' in first
    assert '"fused_combine": true' in first
    assert out["kernel"] == loop.PER_STEP and "fits neither kernel" in out["why"]
    assert out["state"].step == 20 and out["warmup"]["seed_occupancy"] >= 1
    assert out["state"].opt_state.count == 40  # the warmup's steps count for Adam
    assert len(out["rows"]) == 1
    assert all(np.isfinite(v) for r in out["rows"] for v in r.values())
    assert np.isfinite(out["init_test_elbo_per_point"])
    assert np.isfinite(out["final_test_iw_loglik_per_point"])


def test_train_svae_mnist_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_svae.main(["--config", "mnist-svae", "--device", "cuda", "--steps", "1"])


@pytest.mark.slow
def test_bernoulli_path_quality_pin():
    """tests/test_mnist_quality_pin.py on the port (float32, the fused
    combine's plain version): the warmup + reseed recipe, then joint
    training; purity, components in use and the held-out ELBO floors."""
    x_train, x_test, meta, _, y_test = load_mnist(seed=0, max_train=600, return_labels=True)
    assert meta["synthetic"] is True
    x = torch.tensor(x_train, dtype=torch.float32)
    xt = torch.tensor(x_test[:400], dtype=torch.float32)
    yt = np.asarray(y_test[:400])
    n = x.shape[0]
    config = SvaeConfig(latent_dim=8, num_components=10, num_samples=1, num_total=n,
                        likelihood="bernoulli", fused_combine=True)
    prior = gmm.make_prior(10, 8, alpha=1.0, kappa=0.05)
    state = svae_step.init_state(torch.Generator().manual_seed(0), 784, config, prior,
                                 (64, 64), (64, 64))
    evaluate = svae_step.make_eval_fn(config, prior)
    ev0 = float(evaluate(state, xt, generator=torch.Generator().manual_seed(99))
                ["elbo_per_point"])
    state, winfo = warmup.vae_warmup_reseed(state, x, config, prior, lr=1e-3, steps=800,
                                            batch_size=128, scan_chunk=100, seed=0)
    assert winfo["seed_occupancy"] >= 8, winfo
    runner = loop.make_step_runner(config, prior, lr=1e-3, rho=0.1, rho_decay=1e-3,
                                   batch_size=128)
    for _ in range(8):
        state, _ = runner(state, x, 100, seed=0)
    test_elbo = float(evaluate(state, xt, generator=torch.Generator().manual_seed(99))
                      ["elbo_per_point"])
    assert test_elbo > ev0 + 100.0, (ev0, test_elbo)
    assert test_elbo > -280.0, test_elbo
    exp = gmm.expected_params(state.pgm_nat)
    pot_h, pot_p = nets.encoder_apply(state.nn_params["encoder"], xt)
    post = svae.sin_combine(pot_h, pot_p, exp)
    purity = evaluation.cluster_purity(torch.exp(post.log_resp), yt)
    ncomp = int(torch.unique(post.log_resp.argmax(-1)).numel())
    assert ncomp >= 6, f"mixture collapse: only {ncomp}/10 components used"
    assert purity > 0.7, f"cluster purity regression: {purity}"
