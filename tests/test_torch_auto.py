"""The port's auto-svae path around the kernel, against the JAX reference.

* ``svax_torch.data.auto.load_auto`` bit-equal to ``svax.data.auto.load_auto``
  on the surrogate and on a UCI-format file; ``load_dataset``'s routing;
* ``make_train_step`` with the Trainer's ρ₀/(1 + decay·t) schedule against
  the JAX step at injected noise (state and the ``rho`` metric, float64);
* the IW bound against the JAX one at its own draws;
* ``convert`` at the auto shape (d = 4, 100-100);
* the kernel gate, the minibatch runner and the ``train_svae`` entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.data import auto as jauto
from svax.data import load_dataset as jload_dataset
from svax.models import evaluation as jevaluation
from svax.models import svae as jsvae
from svax.models.svae import SvaeConfig as JConfig
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax_torch import convert, train_svae
from svax_torch.data import auto, load_dataset
from svax_torch.models import evaluation
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import flexstep
from svax_torch.pgm import gmm
from svax_torch.train import loop, svae_step

torch.set_num_threads(1)


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("seed", [0, 3])
def test_surrogate_is_bit_equal(seed, monkeypatch, tmp_path):
    monkeypatch.setenv("SVAX_DATA_DIR", str(tmp_path))  # an empty directory
    train, test, meta = auto.load_auto(seed=seed)
    jtrain, jtest, jmeta = jauto.load_auto(seed=seed)
    assert meta == jmeta and meta["synthetic"] is True
    np.testing.assert_array_equal(train, jtrain)
    np.testing.assert_array_equal(test, jtest)
    assert train.shape == (352, 8) and test.shape == (39, 8)


def test_uci_file_is_bit_equal(monkeypatch, tmp_path):
    rng = np.random.default_rng(5)
    lines = []
    for i in range(30):
        vals = rng.uniform(1.0, 400.0, size=8)
        fields = [f"{v:.1f}" for v in vals]
        if i == 7:
            fields[3] = "?"  # missing horsepower: the row is dropped
        lines.append("   ".join(fields) + f'\t"car {i}"')
    (tmp_path / "auto-mpg.data").write_text("\n".join(lines) + "\n\n")
    monkeypatch.setenv("SVAX_DATA_DIR", str(tmp_path))
    train, test, meta = auto.load_auto(seed=1)
    jtrain, jtest, jmeta = jauto.load_auto(seed=1)
    assert meta == jmeta and meta["synthetic"] is False
    assert train.shape[0] + test.shape[0] == 29
    np.testing.assert_array_equal(train, jtrain)
    np.testing.assert_array_equal(test, jtest)


def test_load_dataset_routes(monkeypatch, tmp_path):
    monkeypatch.setenv("SVAX_DATA_DIR", str(tmp_path))
    for name in ("pinwheel", "auto"):
        train, test, meta = load_dataset(name, seed=2)
        jtrain, jtest, jmeta = jload_dataset(name, seed=2)
        np.testing.assert_array_equal(train, jtrain)
        np.testing.assert_array_equal(test, jtest)
        assert meta == jmeta
    with pytest.raises(NotImplementedError, match="not ported"):
        load_dataset("mnist")
    with pytest.raises(ValueError, match="unknown dataset"):
        load_dataset("cifar")


# ------------------------------------------------- the ρ schedule and step


class _InjectedEps:
    """svax.models.svae as make_train_step's ``model``, with the batch
    carrying (x, ε) so the reference step runs at injected noise."""

    @staticmethod
    def forward(nn, nat, prior, batch, key, config, axis_comp=None):
        x, eps = batch
        return jsvae.forward(nn, nat, prior, x, key, config, eps=eps, axis_comp=axis_comp)


def _jax_setup(*, n=48, d_in=8, d=4, k=5, s=2, hidden=(16, 16), seed=0,
               dtype=jnp.float64):
    kx, kinit = jax.random.split(jax.random.PRNGKey(seed))
    x = jax.random.normal(kx, (n, d_in), dtype)
    jconfig = JConfig(latent_dim=d, num_components=k, num_samples=s, num_total=n,
                      nn_precision=jax.lax.Precision.HIGHEST)
    cast = lambda t: jax.tree.map(  # noqa: E731
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
    jprior = cast(jgmm.make_prior(k, d, kappa=0.05))
    jstate = cast(jstep.init_state(kinit, d_in, jconfig, jprior, optax.adam(1e-3),
                                   hidden, hidden, data=x))
    return x, jconfig, jprior, jstate


def _port(jtree, dtype):
    return convert.state_from_numpy(jax.tree.map(np.asarray, jtree), dtype=dtype)


def test_rho_schedule_step_matches_jax():
    """Three minibatch steps at d = 4 with ρ_t = 0.2/(1 + 0.3·t) from step 5:
    the schedule is read at the pre-update step and reported as ``rho``."""
    x, jconfig, jprior, jstate = _jax_setup()
    jstate = jstate._replace(step=jnp.asarray(5, jstate.step.dtype))
    m, lr = 16, 3e-3
    rng = np.random.default_rng(3)
    idx = rng.integers(0, x.shape[0], size=(3, m))
    eps = rng.standard_normal((3, 2, m, 5, 4))
    rho = lambda t: 0.2 / (1.0 + 0.3 * t)  # noqa: E731
    jrun = jax.jit(jstep.make_train_step(jconfig, jprior, optax.adam(lr), rho=rho,
                                         model=_InjectedEps))
    state = _port(jstate, torch.float64)
    prior = convert.gmm_nat_from_numpy(jprior, dtype=torch.float64)
    config = SvaeConfig(latent_dim=4, num_components=5, num_samples=2, num_total=48)
    step = svae_step.make_train_step(config, prior, lr, svae_step.rho_schedule(0.2, 0.3))
    xt = torch.tensor(np.asarray(x))
    for t in range(3):
        jstate, jm = jrun(jstate, (x[idx[t]], jnp.asarray(eps[t])), jax.random.PRNGKey(0))
        state, m_ = step(state, xt[torch.tensor(idx[t])], eps=torch.tensor(eps[t]))
        np.testing.assert_allclose(float(m_["rho"]), float(jm["rho"]), rtol=1e-7)
        np.testing.assert_allclose(float(m_["rho"]), 0.2 / (1.0 + 0.3 * (5 + t)), rtol=1e-12)
        np.testing.assert_allclose(float(m_["recon"]), float(jm["recon"]), rtol=1e-8)
    got = convert.state_to_numpy(state)
    want = jax.tree.map(np.asarray, jstate)
    for side in ("encoder", "decoder"):
        for gl, wl in zip(got["nn_params"][side], want.nn_params[side]):
            np.testing.assert_allclose(gl["w"], wl["w"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got["pgm_nat"]["eta3"], want.pgm_nat.niw_nat.eta3, rtol=1e-8)
    np.testing.assert_allclose(got["pgm_nat"]["dir_nat"], want.pgm_nat.dir_nat, rtol=1e-8)
    assert got["step"] == int(want.step) == 8
    assert got["adam"]["count"] == int(want.opt_state[0].count) == 3
    assert svae_step.rho_schedule(0.2, 0.0) == 0.2


# --------------------------------------------------------------- IW bound


@pytest.mark.parametrize("d_in,d", [(8, 4), (2, 2)])
def test_iw_bound_matches_jax(d_in, d):
    x, jconfig, jprior, jstate = _jax_setup(n=24, d_in=d_in, d=d, k=3, hidden=(12, 10),
                                           seed=4)
    key, s = jax.random.PRNGKey(11), 7
    want = jevaluation.svae_iw_loglik(jstate.nn_params, jstate.pgm_nat, x, key, jconfig, s)
    k_cat, k_norm = jax.random.split(key)  # evaluation.py:77-84's draws
    gumbel = jax.random.gumbel(k_cat, (s, 24, 3), dtype=x.dtype)
    eps = jax.random.normal(k_norm, (s, 24, 3, d), dtype=x.dtype)
    state = _port(jstate, torch.float64)
    got = evaluation.svae_iw_loglik(
        state.nn_params, state.pgm_nat, torch.tensor(np.asarray(x)), s,
        gumbel=torch.tensor(np.asarray(gumbel)), eps=torch.tensor(np.asarray(eps)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    drawn = evaluation.svae_iw_loglik(state.nn_params, state.pgm_nat,
                                      torch.tensor(np.asarray(x)), s,
                                      generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (24,) and bool(torch.isfinite(drawn).all())


# ---------------------------------------------------------------- convert


def test_convert_round_trip_at_auto_shape():
    """The SVAE state at d = 4, 100-100, with Adam's count and the step
    that flexstep reads (ρ at step, bias correction at count + 1)."""
    _, _, _, jstate = _jax_setup(n=40, d=4, k=10, hidden=(100, 100), dtype=jnp.float32)
    adam = jstate.opt_state[0]
    jstate = jstate._replace(
        step=jnp.asarray(123, jstate.step.dtype),
        opt_state=(adam._replace(count=jnp.asarray(117, adam.count.dtype)),)
        + tuple(jstate.opt_state[1:]))
    state = _port(jstate, None)
    assert state.step == 123 and state.opt_state.count == 117
    assert state.nn_params["encoder"][1]["w"].shape == (100, 100)
    assert state.nn_params["decoder"][2]["w"].shape == (100, 16)
    back = convert.state_to_numpy(state)
    want = jax.tree.map(np.asarray, jstate)
    for side in ("encoder", "decoder"):
        for gl, wl in zip(back["nn_params"][side], want.nn_params[side]):
            for name in ("w", "b"):
                np.testing.assert_array_equal(gl[name], wl[name])
                assert gl[name].dtype == np.float32
    np.testing.assert_array_equal(back["pgm_nat"]["eta3"], want.pgm_nat.niw_nat.eta3)
    assert int(back["step"]) == 123 and int(back["adam"]["count"]) == 117


# ------------------------------------------------- gate, runner and entry


def test_gate_sends_pinwheel_to_tinystep_and_auto_to_flexstep():
    pin = SvaeConfig(latent_dim=2, num_components=10, num_samples=4, num_total=400)
    assert loop.choose_kernel(pin, batch_full=True, encoder_hidden=(50, 50),
                              decoder_hidden=(50, 50), rho=0.05, input_dim=2) == "tinystep"
    auto_cfg = SvaeConfig(latent_dim=4, num_components=10, num_samples=4, num_total=352)
    ok = dict(batch_full=False, encoder_hidden=(100, 100), decoder_hidden=(100, 100),
              rho=0.2, rho_decay=1e-3, input_dim=8)
    assert loop.choose_kernel(auto_cfg, **ok) == "flexstep"
    assert loop.kernel_unsupported_reason(auto_cfg, **ok) is None
    # pinwheel with a decaying ρ is flexstep's, full batch
    assert loop.choose_kernel(pin, batch_full=True, encoder_hidden=(50, 50),
                              decoder_hidden=(50, 50), rho=0.05, rho_decay=1e-3,
                              input_dim=2) == "flexstep"
    bad = {
        "latent d <= 6": (auto_cfg._replace(latent_dim=7), ok),
        "d_in <= 8": (auto_cfg, {**ok, "input_dim": 9}),
        "two hidden layers": (auto_cfg, {**ok, "encoder_hidden": (100,)}),
        "hidden widths 1..128": (auto_cfg, {**ok, "decoder_hidden": (100, 200)}),
        "Gaussian": (auto_cfg, {**ok, "likelihood": "bernoulli"}),
    }
    for what, (cfg, kw) in bad.items():
        reason = loop.kernel_unsupported_reason(cfg, **kw)
        assert reason is not None and what in reason, (what, reason)
        with pytest.raises(ValueError, match="fits neither kernel"):
            loop.choose_kernel(cfg, **kw)


def _auto_state(n=40, d_in=5, d=3, k=4, hidden=(12, 12), seed=0):
    gen = torch.Generator().manual_seed(seed)
    config = SvaeConfig(latent_dim=d, num_components=k, num_samples=2, num_total=n)
    prior = gmm.make_prior(k, d, kappa=0.05)
    state = svae_step.init_state(gen, d_in, config, prior, hidden, hidden)
    x = torch.randn(n, d_in, generator=gen)
    return config, prior, state, x


def test_minibatch_runner_draws_with_replacement_and_is_seeded(monkeypatch):
    config, prior, state, x = _auto_state()
    seen = []
    real = flexstep.train_chunk

    def spy(state, prior, batches, **kw):
        seen.append((batches.clone(), kw))
        return real(state, prior, batches, **kw)

    monkeypatch.setattr(flexstep, "train_chunk", spy)
    runner = loop.make_runner(config, prior, lr=3e-3, rho=0.2, rho_decay=0.01,
                              batch_size=16, kernel="flexstep")
    st, mets = runner(state, x, 3, seed=7)
    batches, kw = seen[-1]
    gen = torch.Generator().manual_seed(7 + state.step)
    idx = torch.randint(0, 40, (3, 16), generator=gen)
    assert torch.equal(batches, x[idx])
    assert kw["num_total"] == 40 and kw["rho_decay"] == 0.01
    assert st.step == 3 and st.opt_state.count == 3
    assert set(mets) == {"recon", "local_kl", "global_kl", "elbo", "rho"}
    np.testing.assert_allclose(mets["rho"].numpy(),
                               [0.2 / (1.0 + 0.01 * t) for t in range(3)], rtol=1e-6)
    gkl = gmm.kl_global(st.pgm_nat, prior)  # at the post-chunk naturals
    np.testing.assert_allclose(float(mets["global_kl"][0]), float(gkl), rtol=1e-6)
    np.testing.assert_allclose(float(mets["elbo"][-1]),
                               float(mets["recon"][-1] - mets["local_kl"][-1] - gkl),
                               rtol=1e-6)
    st2, _ = runner(state, x, 3, seed=7)
    assert torch.equal(st.pgm_nat.niw_nat.eta3, st2.pgm_nat.niw_nat.eta3)
    st3, _ = runner(st, x, 2, seed=7)  # the next chunk draws fresh indices
    assert st3.step == 5 and not torch.equal(seen[-1][0][0], batches[0])
    plain = loop.make_runner(config, prior, lr=3e-3, rho=0.2, rho_decay=0.01,
                             batch_size=16, kernel="flexstep", engine="plain")
    st4, _ = plain(state, x, 3, seed=7)
    assert torch.equal(st4.pgm_nat.dir_nat, st.pgm_nat.dir_nat)  # CPU: the same path


def test_full_batch_flexstep_runner_uses_every_row():
    config, prior, state, x = _auto_state(n=24)
    runner = loop.make_runner(config, prior, lr=3e-3, rho=0.3, kernel="flexstep")
    eps = torch.tensor(np.random.default_rng(1).standard_normal((2, 2, 24, 4, 3)),
                       dtype=torch.float32)
    st, _ = runner(state, x, 2, eps=eps)
    ref, _ = flexstep.train_chunk_plain(state, prior, x.expand(2, 24, 5), lr=3e-3, rho=0.3,
                                        num_total=24, eps=eps)
    assert torch.equal(st.pgm_nat.dir_nat, ref.pgm_nat.dir_nat)
    with pytest.raises(ValueError, match="aug_eps"):
        runner(state, x, 2, aug_eps=torch.zeros(2, 24, 5))


def test_train_svae_auto_cpu_runs(capsys):
    out = train_svae.main(["--config", "auto-svae", "--device", "cpu", "--steps", "10",
                           "--iw-samples", "8"])
    assert out["kernel"] == "flexstep" and out["state"].step == 10
    assert out["meta"]["synthetic"] is True
    assert len(out["rows"]) == 1
    assert all(np.isfinite(v) for r in out["rows"] for v in r.values())
    assert np.isfinite(out["init_test_elbo_per_point"])
    assert np.isfinite(out["final_test_iw_loglik_per_point"])
    assert '"final_test_iw_loglik_per_point"' in capsys.readouterr().out


def test_train_svae_refuses_unported_configs(capsys):
    for name in ("mnist-svae", "bigk-dp"):
        with pytest.raises(SystemExit):
            train_svae.main(["--config", name, "--device", "cpu"])
        assert "ROADMAP.md" in capsys.readouterr().err


def test_train_svae_auto_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_svae.main(["--config", "auto-svae", "--device", "cuda", "--steps", "1"])
