"""The port's Student-t-prior (SMM) SVAE against svax.models.svae_smm.

Same JAX-built parameters and naturals in (carried across with
svax_torch.convert), same numpy noise: ``smm_combine``, ``forward`` (ELBO
terms, CVI statistics and the gradient of −(recon − local)/N in both
gradient modes) at float64 rtol 1e-9 and float32 at tests/test_svae_smm.py's
1e-4 ELBO bar; the dof → ∞ reduction to the port's GMM-prior SVAE and the
u fixed point at 40 rounds (tests/test_svae_smm.py's bars); the SMM IW
bound and its prior density; one SMM ``make_train_step`` step
against the reference's updated state; the entry's routing and lines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.data import make_pinwheel_data
from svax.models import evaluation as jeval
from svax.models import svae_smm as jsmm
from svax.models.svae import SvaeConfig as JConfig
from svax.nets import mlp as jnets
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax_torch import convert, train_svae
from svax_torch.models import evaluation, svae, svae_smm
from svax_torch.models.svae import SvaeConfig
from svax_torch.nets import mlp as nets
from svax_torch.pgm import gmm, smm
from svax_torch.train import loop, svae_step

torch.set_num_threads(1)
RTOL = 1e-9


def _close(got, want, rtol=RTOL, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol, atol=atol,
                               err_msg=what)


def _setup(dof=4.0, smm_iters=2, env=False, likelihood="gaussian", n=48, k=4, s=2,
           hidden=(12, 12), seed=0, dtype=jnp.float64):
    if likelihood == "gaussian":
        x = make_pinwheel_data(num_classes=3, num_per_class=n // 3, seed=seed)[:n]
    else:
        x = (np.random.default_rng(seed).random((n, 6)) < 0.4).astype(np.float64)
    x = jnp.asarray(x, dtype)
    d_in = x.shape[1]
    jconfig = JConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n,
                      likelihood=likelihood, nn_precision=jax.lax.Precision.HIGHEST,
                      dof=dof, smm_iters=smm_iters, smm_envelope_grads=env)
    jprior = jgmm.make_prior(k, 2, kappa=0.05, dtype=dtype)
    jstate = jstep.init_state(jax.random.PRNGKey(seed), d_in, jconfig, jprior,
                              optax.adam(1e-3), hidden, hidden,
                              data=x if d_in == 2 else None, dtype=dtype)
    tdtype = torch.float64 if dtype == jnp.float64 else torch.float32
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate), dtype=tdtype)
    prior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior), dtype=tdtype)
    eps = np.random.default_rng(seed + 1).standard_normal((s, n, k, 2))
    config = SvaeConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n,
                        likelihood=likelihood, dof=dof, smm_iters=smm_iters,
                        smm_envelope_grads=env)
    return dict(x=x, jconfig=jconfig, jprior=jprior, jstate=jstate, state=state,
                prior=prior, eps=eps.astype(np.float64 if dtype == jnp.float64
                                            else np.float32),
                config=config, xt=torch.tensor(np.asarray(x)))


def _jax_forward_and_grads(c):
    def loss(nn):
        out = jsmm.forward(nn, c["jstate"].pgm_nat, c["jprior"], c["x"],
                           jax.random.PRNGKey(0), c["jconfig"], eps=jnp.asarray(c["eps"]))
        return -(out.recon - out.local_kl) / c["x"].shape[0], out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(c["jstate"].nn_params)
    return out, grads


def _port_forward_and_grads(c):
    params = svae_step.map_params(lambda p: p.clone().requires_grad_(True),
                                  c["state"].nn_params)
    out = svae_smm.forward(params, c["state"].pgm_nat, c["prior"], c["xt"], c["config"],
                           eps=torch.tensor(c["eps"]))
    leaves = [t for side in params.values() for ly in side for t in ly.values()]
    grads = torch.autograd.grad(-(out.recon - out.local_kl) / c["xt"].shape[0], leaves)
    return out, grads


def _grad_leaves(jgrads):
    return [np.asarray(ly[name]) for side in ("encoder", "decoder")
            for ly in jgrads[side] for name in ("w", "b")]


@pytest.mark.parametrize("likelihood", ["gaussian", "bernoulli"])
@pytest.mark.parametrize("env", [False, True])
@pytest.mark.parametrize("smm_iters", [1, 2, 6])
@pytest.mark.parametrize("dof", [2.5, 4.0])
def test_forward_and_grads_match_jax_float64(dof, smm_iters, env, likelihood):
    c = _setup(dof, smm_iters, env, likelihood)
    jout, jgrads = _jax_forward_and_grads(c)
    out, grads = _port_forward_and_grads(c)
    for name in ("elbo", "recon", "local_kl", "global_kl"):
        _close(getattr(out, name), getattr(jout, name), what=name)
    for f in smm.SmmSuffStats._fields:
        _close(getattr(out.suff_stats, f), getattr(jout.suff_stats, f), atol=1e-12, what=f)
    for f in svae_smm.SmmPosterior._fields:
        _close(getattr(out.posterior, f), getattr(jout.posterior, f), atol=1e-12, what=f)
    for g, w in zip(grads, _grad_leaves(jgrads)):
        _close(g, w, atol=1e-13, what="grad")


@pytest.mark.parametrize("dof,smm_iters", [(4.0, 2), (2.5, 6)])
def test_forward_matches_jax_float32(dof, smm_iters):
    """float32 on both sides: the ELBO within tests/test_svae_smm.py's
    f32 bar (1e-4 relative), the gradients to 1e-3 of their largest entry."""
    c = _setup(dof, smm_iters, dtype=jnp.float32)
    jout, jgrads = _jax_forward_and_grads(c)
    out, grads = _port_forward_and_grads(c)
    rel = abs(float(out.elbo.detach()) - float(jout.elbo)) / abs(float(jout.elbo))
    assert rel < 1e-4, rel
    _close(out.posterior.log_resp, jout.posterior.log_resp, rtol=0.0, atol=1e-5)
    for g, w in zip(grads, _grad_leaves(jgrads)):
        _close(g, w, rtol=0.0, atol=1e-3 * float(np.abs(w).max()), what="grad")


@pytest.mark.parametrize("env", [False, True])
def test_smm_combine_matches_jax(env):
    c = _setup(4.0, 3, env)
    h, p = nets.encoder_apply(c["state"].nn_params["encoder"], c["xt"])
    jh, jp = jnets.encoder_apply(c["jstate"].nn_params["encoder"], c["x"])
    post, fe = svae_smm.smm_combine(h, p, gmm.expected_params(c["state"].pgm_nat), 4.0,
                                    3, envelope_grads=env)
    jpost, jfe = jsmm.smm_combine(jh, jp, jgmm.expected_params(c["jstate"].pgm_nat), 4.0,
                                  3, envelope_grads=env)
    _close(fe, jfe)
    for got, want, name in zip(post, jpost, svae_smm.SmmPosterior._fields):
        _close(got, want, atol=1e-12, what=name)


def test_dof_infinity_reduces_to_the_gmm_svae():
    """tests/test_svae_smm.py:43's reduction and setup (its parameters and
    naturals carried across), on the port's two models."""
    from svax.models import svae as jsvae

    n, k, s = 80, 5, 2
    x = jnp.asarray(make_pinwheel_data(num_classes=4, num_per_class=n // 4, seed=3))[:n]
    key = jax.random.PRNGKey(7)
    jconfig = JConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n)
    nn = jsvae.init_params(key, 2, jconfig, (16,), (16,), dtype=jnp.float64)
    nat = jgmm.init_variational(key, jgmm.make_prior(k, 2, dtype=jnp.float64), x)
    params = convert.state_from_numpy(jax.tree.map(np.asarray, jstep.SvaeTrainState(
        nn_params=nn, opt_state=optax.adam(1e-3).init(nn), pgm_nat=nat,
        step=0))).nn_params
    nat = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, nat))
    prior = gmm.make_prior(k, 2, dtype=torch.float64)
    eps = torch.tensor(np.random.default_rng(0).standard_normal((s, n, k, 2)))
    config = SvaeConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n,
                        dof=1e9)
    xt = torch.tensor(np.asarray(x))
    out_smm = svae_smm.forward(params, nat, prior, xt, config, eps=eps)
    out_gmm = svae.forward(params, nat, prior, xt, config._replace(dof=0.0), eps=eps)
    _close(out_smm.posterior.log_resp, out_gmm.posterior.log_resp, rtol=0.0, atol=1e-5)
    _close(out_smm.posterior.mean, out_gmm.posterior.mean, rtol=1e-6, atol=1e-8)
    rel = abs(float(out_smm.elbo - out_gmm.elbo)) / abs(float(out_gmm.elbo))
    assert rel < 1e-5, rel
    st = out_smm.suff_stats
    _close(st.u_counts, st.counts, rtol=1e-6)
    _close(st.mean_stat, out_gmm.suff_stats.mean_stat, rtol=1e-5, atol=1e-8)
    _close(st.scatter_stat, out_gmm.suff_stats.scatter_stat, rtol=1e-5, atol=1e-8)


def test_u_coordinate_fixed_point():
    """After 40 rounds one more u-update is a no-op (rtol 1e-8)."""
    c = _setup(dof=4.0)
    exp = gmm.expected_params(c["state"].pgm_nat)
    h, p = nets.encoder_apply(c["state"].nn_params["encoder"], c["xt"])
    post, _ = svae_smm.smm_combine(h, p, exp, 4.0, num_iters=40)
    a = 0.5 * 4.0 + 0.5 * 2
    e_u_next = a / (0.5 * 4.0 + 0.5 * svae_smm._quad_latent(post.mean, post.cov, exp))
    _close(e_u_next, post.e_u, rtol=1e-8)


@pytest.mark.parametrize("likelihood", ["gaussian", "bernoulli"])
def test_smm_iw_loglik_matches_jax(likelihood):
    """The bound at injected Gumbel and ε draws: the reference's draws,
    recovered from its key as it makes them."""
    c = _setup(dof=2.5, smm_iters=2, likelihood=likelihood)
    key, samples = jax.random.PRNGKey(5), 7
    want = jeval.svae_smm_iw_loglik(c["jstate"].nn_params, c["jstate"].pgm_nat, c["x"],
                                    key, c["jconfig"], samples)
    k_cat, k_norm = jax.random.split(key)
    n, k = c["x"].shape[0], 4
    gumbel = np.asarray(jax.random.gumbel(k_cat, (samples, n, k), dtype=c["x"].dtype))
    eps = np.asarray(jax.random.normal(k_norm, (samples, n, k, 2), dtype=c["x"].dtype))
    got = evaluation.svae_smm_iw_loglik(
        c["state"].nn_params, c["state"].pgm_nat, c["xt"], samples, dof=2.5, smm_iters=2,
        gumbel=torch.tensor(gumbel), eps=torch.tensor(eps), likelihood=likelihood)
    _close(got, want)


def test_expected_smm_log_prob_matches_jax():
    c = _setup(dof=4.0)
    z = np.random.default_rng(3).standard_normal((5, 7, 2))
    want = jeval._expected_smm_log_prob(jnp.asarray(z),
                                        jgmm.expected_params(c["jstate"].pgm_nat), 4.0)
    got = evaluation._expected_smm_log_prob(torch.tensor(z),
                                            gmm.expected_params(c["state"].pgm_nat), 4.0)
    _close(got, want)


class _InjectedEps:
    """svax.models.svae_smm as make_train_step's ``model``, with the batch
    carrying (x, ε) so the reference step runs at injected noise."""

    stats_to_nat = staticmethod(jsmm.stats_to_nat)

    @staticmethod
    def forward(nn, nat, prior, batch, key, config, axis_comp=None):
        x, eps = batch
        return jsmm.forward(nn, nat, prior, x, key, config, eps=eps)


@pytest.mark.parametrize("env", [False, True])
def test_train_step_matches_jax(env):
    """One make_train_step step at dof > 0 (svae_smm): every leaf of the updated
    state at float64 rtol 1e-9 (atol 1e-15 for Adam's ν)."""
    c = _setup(dof=4.0, smm_iters=2, env=env)
    jstep_fn = jstep.make_train_step(c["jconfig"], c["jprior"], optax.adam(3e-3), 0.2,
                                     model=_InjectedEps)
    jst, jm = jstep_fn(c["jstate"], (c["x"], jnp.asarray(c["eps"])), jax.random.PRNGKey(0))
    step = svae_step.make_train_step(c["config"], c["prior"], 3e-3, 0.2)
    st, m = step(c["state"], c["xt"], eps=torch.tensor(c["eps"]))
    got, want = convert.state_to_numpy(st), jax.tree.map(np.asarray, jst)
    for side in ("encoder", "decoder"):
        for gl, wl, gm, wm, gv, wv in zip(got["nn_params"][side], want.nn_params[side],
                                          got["adam"]["mu"][side], want.opt_state[0].mu[side],
                                          got["adam"]["nu"][side], want.opt_state[0].nu[side]):
            for key in ("w", "b"):
                _close(gl[key], wl[key], what=f"params {side}")
                _close(gm[key], wm[key], atol=1e-15, what=f"mu {side}")
                _close(gv[key], wv[key], atol=1e-15, what=f"nu {side}")
    _close(got["pgm_nat"]["dir_nat"], want.pgm_nat.dir_nat)
    for f in ("eta1", "eta2", "eta3", "eta4"):
        _close(got["pgm_nat"][f], getattr(want.pgm_nat.niw_nat, f), what=f)
    # Σ r̃ū ≠ Σ r̃: the u-weighted η₂ increment differs from the counts'.
    assert not np.allclose(got["pgm_nat"]["eta2"] - c["prior"].niw_nat.eta2.numpy(),
                           got["pgm_nat"]["eta4"] - c["prior"].niw_nat.eta4.numpy())
    _close(m["elbo"], jm["elbo"])


def test_converted_jax_state_gives_the_same_elbo():
    """A JAX SMM-SVAE state, trained three steps by the reference and carried
    across by convert (the parameter layout is the GMM-prior SVAE's),
    evaluates to the reference's ELBO terms."""
    c = _setup(dof=4.0)
    jstep_fn = jax.jit(jstep.make_train_step(c["jconfig"], c["jprior"], optax.adam(3e-3),
                                             0.2, model=_InjectedEps))
    jst = c["jstate"]
    for t in range(3):
        jst, _ = jstep_fn(jst, (c["x"], jnp.asarray(c["eps"]) * (t + 1) / 3),
                          jax.random.PRNGKey(0))
    n = c["x"].shape[0]
    want = jsmm.forward(jst.nn_params, jst.pgm_nat, c["jprior"], c["x"],
                        jax.random.PRNGKey(0), c["jconfig"], eps=jnp.asarray(c["eps"]))
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jst))
    got = svae_step.make_eval_fn(c["config"], c["prior"])(
        state, c["xt"], eps=torch.tensor(c["eps"]))
    _close(got["elbo_per_point"], want.elbo / n)
    _close(got["recon_per_point"], want.recon / n)
    _close(got["local_kl_per_point"], want.local_kl / n)
    _close(got["global_kl"], want.global_kl)
    fresh = svae_smm.init_params(torch.Generator().manual_seed(0), 2, c["config"],
                                 (12, 12), (12, 12), dtype=torch.float64)
    for side in ("encoder", "decoder"):
        assert [ly["w"].shape for ly in fresh[side]] == [
            ly["w"].shape for ly in state.nn_params[side]]


def test_forward_refuses_dof_zero():
    c = _setup(dof=4.0)
    with pytest.raises(ValueError, match="dof > 0"):
        svae_smm.forward(c["state"].nn_params, c["state"].pgm_nat, c["prior"], c["xt"],
                         c["config"]._replace(dof=0.0))


def test_model_for_and_runner_gates():
    cfg = SvaeConfig(latent_dim=4, num_components=10, num_samples=4, num_total=352)
    assert svae_step.model_for(cfg) is svae
    assert svae_step.model_for(cfg._replace(dof=4.0)) is svae_smm
    gate = dict(batch_full=False, encoder_hidden=(100, 100), decoder_hidden=(100, 100),
                rho=0.2, rho_decay=1e-3, input_dim=8)
    assert loop.choose_kernel(cfg, engine="auto", **gate) == "flexstep"
    smm_cfg = cfg._replace(dof=4.0)
    assert loop.choose_kernel(smm_cfg, engine="auto", **gate) == loop.PER_STEP
    assert "GMM prior only" in loop.kernel_unsupported_reason(smm_cfg, **gate)
    with pytest.raises(ValueError, match="GMM prior only"):
        loop.make_runner(smm_cfg, None, lr=1e-3, rho=0.2, kernel="flexstep")
    pin = cfg._replace(latent_dim=2, dof=4.0)
    assert loop.choose_kernel(pin, batch_full=True, encoder_hidden=(50, 50),
                              decoder_hidden=(50, 50), rho=0.05) == "tinystep"


def test_step_runner_trains_the_smm_model():
    """The per-step runner builds its step on svae_smm from dof."""
    c = _setup(dof=4.0, dtype=jnp.float32)
    runner = loop.make_step_runner(c["config"], c["prior"], lr=3e-3, rho=0.2,
                                   batch_size=16, engine="plain")
    st, mets = runner(c["state"], c["xt"], 3, seed=1)
    assert st.step == 3 and torch.isfinite(mets["elbo"]).all()
    step = svae_step.make_train_step(c["config"], c["prior"], 3e-3,
                                     svae_step.rho_schedule(0.2))
    gen = torch.Generator().manual_seed(1)
    idx = loop.minibatch_indices(gen, 48, 16, 3)
    ref = c["state"]
    for t in range(3):
        ref, _ = step(ref, c["xt"][idx[t]], generator=gen)
    assert torch.equal(ref.pgm_nat.niw_nat.eta2, st.pgm_nat.niw_nat.eta2)


def test_train_svae_routes_smm_on_the_cpu(capsys):
    """pinwheel-svae with --smm-dof runs tinystep's plain path; auto-svae
    with --smm-dof runs the per-step engine with flexstep's reason; the
    first line reports the prior and the last the SMM IW bound."""
    out = train_svae.main(["--config", "pinwheel-svae", "--smm-dof", "4", "--device",
                           "cpu", "--steps", "50", "--iw-samples", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    import json

    first, last = json.loads(lines[0]), json.loads(lines[-1])
    assert out["kernel"] == "tinystep" and out["state"].step == 50
    assert first["prior"] == "smm" and first["dof"] == 4.0 and first["smm_iters"] == 2
    assert first["fused_combine"] is False and first["fused_mlp_decoder"] is False
    assert set(last) == {"final_test_iw_loglik_per_point", "iw_samples"}
    assert np.isfinite(last["final_test_iw_loglik_per_point"])
    gen = torch.Generator().manual_seed(2)
    model_cfg = SvaeConfig(latent_dim=2, num_components=10, num_samples=4, num_total=400,
                           dof=4.0)
    want = evaluation.svae_smm_iw_loglik(out["state"].nn_params, out["state"].pgm_nat,
                                         out["x_test"], 3, dof=model_cfg.dof,
                                         smm_iters=model_cfg.smm_iters, generator=gen)
    assert last["final_test_iw_loglik_per_point"] == float(want.mean())

    auto = train_svae.main(["--config", "auto-svae", "--smm-dof", "4", "--device", "cpu",
                            "--steps", "3", "--iw-samples", "0"])
    first = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert auto["kernel"] == loop.PER_STEP and "GMM prior only" in auto["why"]
    assert first["prior"] == "smm" and first["kernel"] == loop.PER_STEP
    assert np.isfinite(auto["rows"][-1]["test_elbo_per_point"])


def test_train_svae_smm_flags_and_mnist_warmup(capsys):
    """--smm-envelope-grads and --smm-iters reach the model; mnist-svae
    with --smm-dof runs its warmup and reseed on the per-step engine with
    the fused kernels reported off."""
    import json

    out = train_svae.main(["--config", "mnist-svae", "--smm-dof", "4", "--smm-iters", "1",
                           "--smm-envelope-grads", "--device", "cpu", "--steps", "2",
                           "--warmup-steps", "2", "--iw-samples", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    first = json.loads(lines[0])
    assert first["prior"] == "smm" and first["smm_iters"] == 1
    assert first["smm_envelope_grads"] is True
    assert first["fused_combine"] is False and first["fused_mlp_decoder"] is False
    assert out["kernel"] == loop.PER_STEP and out["warmup"]["seed_occupancy"] >= 1
    assert np.isfinite(out["final_test_iw_loglik_per_point"])
    train_svae.main(["--device", "cpu", "--steps", "1", "--iw-samples", "0"])
    first = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert first["prior"] == "gmm" and first["dof"] == 0.0


def test_train_svae_bigk_smm_at_a_small_width(capsys, monkeypatch):
    """bigk-dp with --smm-dof, its config cut to a small width: warmup,
    reseed and the data-parallel rows on the per-step engine, every step
    through svae_smm.forward, neither fused kernel's wrapper called, and
    the first line saying so."""
    import json

    from svax_torch import configs
    from svax_torch.ops import combine, decoder_mlp

    small = dict(configs.CONFIGS["bigk-dp"], num_components=6, latent_dim=10,
                 encoder_hidden=[16, 16], decoder_hidden=[16, 16], batch_size=64)
    monkeypatch.setitem(configs.CONFIGS, "bigk-dp", small)
    calls = []
    fwd = svae_smm.forward
    monkeypatch.setattr(svae_smm, "forward",
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))

    def refuse(*a, **k):
        raise AssertionError("a fused kernel's wrapper ran under --smm-dof")

    monkeypatch.setattr(combine, "combine_fused", refuse)
    monkeypatch.setattr(decoder_mlp, "bernoulli_mlp_loglik_fused", refuse)
    out = train_svae.main(["--config", "bigk-dp", "--smm-dof", "4", "--device", "cpu",
                           "--steps", "5", "--warmup-steps", "2", "--eval-every", "2",
                           "--iw-samples", "2"])
    first = json.loads(capsys.readouterr().out.splitlines()[0])
    assert first["prior"] == "smm" and first["kernel"] == loop.PER_STEP
    assert first["fused_combine"] is False and first["fused_mlp_decoder"] is False
    assert [r["step"] for r in out["rows"]] == [1, 2, 4, 5]
    assert out["state"].step == 5 and out["state"].opt_state.count == 7
    # 2 warmup + 5 joint steps, and the initial and 4 row evaluations.
    assert len(calls) == 2 + 5 + 1 + 4
    assert all(np.isfinite(v) for r in out["rows"] for v in r.values())
    assert np.isfinite(out["final_test_iw_loglik_per_point"])
