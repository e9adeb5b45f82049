"""The port's pure-mixture path against the JAX reference (float64).

* ``pgm.gmm``'s observed-data pieces and ``pgm.smm`` at rtol 1e-10;
* the ``gmm_baseline`` (plain and fused E-step) and ``smm_baseline``
  steps over 5 steps at rtol 1e-9, from converted naturals;
* ``evaluate``, ``gmm_predictive_log_prob`` and ``cluster_purity`` at
  rtol 1e-9;
* the numpy copies (``kmeanspp_centers``, ``make_pinwheel_with_outliers``)
  bit-equal, and the k-means++ naturals equal;
* the whole slice: ``svax_torch.train_gmm`` at ``--config pinwheel-gmm
  --init kmeanspp`` against 300 steps of the JAX step from the same
  naturals (float64, rtol 1e-8; both engines), and its float32 predictive
  figure against the JAX entry's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.data import load_pinwheel, make_pinwheel_data
from svax.data import pinwheel as jpinwheel
from svax.models import evaluation as jevaluation
from svax.models import gmm_baseline as jgmm_baseline
from svax.models import smm_baseline as jsmm_baseline
from svax.pgm import gmm as jgmm
from svax.pgm import init as jinit
from svax.pgm import smm as jsmm
from svax_torch import convert, train_gmm
from svax_torch.data import pinwheel
from svax_torch.models import evaluation, gmm_baseline, smm_baseline
from svax_torch.models.smm_baseline import SmmTrainState
from svax_torch.pgm import gmm, init, smm

torch.set_num_threads(1)

# experiments/train_gmm.py --config pinwheel-gmm --platform cpu --init
# kmeanspp (float32, seed 0) prints this test predictive log-likelihood.
JAX_ENTRY_PREDICTIVE = -5.64118


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _setup(n=72, k=5, d=2, seed=0):
    """numpy data, the JAX prior and naturals (float64) and their ports."""
    if d == 2:
        x = make_pinwheel_data(num_classes=3, num_per_class=n // 3, seed=seed)[:n]
    else:
        x = np.random.default_rng(seed).standard_normal((n, d))
    jprior = jgmm.make_prior(k, d, kappa=0.05, dtype=jnp.float64)
    jnat = jgmm.init_variational(jax.random.PRNGKey(seed), jprior, jnp.asarray(x),
                                 pseudo_counts=2.0)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    prior = convert.gmm_nat_from_numpy(to_np(jprior))
    nat = convert.gmm_nat_from_numpy(to_np(jnat))
    return x, jprior, jnat, prior, nat


def _assert_nat_close(nat, jnat, rtol, atol=0.0):
    got = convert.gmm_nat_to_numpy(nat)
    _close(got["dir_nat"], jnat.dir_nat, rtol, atol, "dir_nat")
    for f in ("eta1", "eta2", "eta3", "eta4"):
        _close(got[f], getattr(jnat.niw_nat, f), rtol, atol, f)


@pytest.mark.parametrize("d", [2, 3])
def test_gmm_observed_pieces_match_jax(d):
    x, jprior, jnat, prior, nat = _setup(d=d, k=4)
    jexp, exp = jgmm.expected_params(jnat), gmm.expected_params(nat)
    xt, xj = torch.tensor(x), jnp.asarray(x)
    _close(gmm.log_responsibilities_obs(xt, exp),
           jgmm.log_responsibilities_obs(xj, jexp), 1e-10)
    resp, ev = gmm.e_step_obs(xt, exp)
    jresp, jev = jgmm.e_step_obs(xj, jexp)
    _close(resp, jresp, 1e-10, 1e-300)
    _close(ev, jev, 1e-10)
    for got, want in zip(gmm.suff_stats_obs(xt, resp, scale=3.0),
                         jgmm.suff_stats_obs(xj, jresp, scale=3.0)):
        _close(got, want, 1e-10, 1e-12)
    elbo, parts = gmm.elbo_obs(xt, nat, prior, scale=2.0)
    jelbo, jparts = jgmm.elbo_obs(xj, jnat, jprior, scale=2.0)
    _close(float(elbo), float(jelbo), 1e-10)
    for key in ("local", "kl_global"):
        _close(float(parts[key]), float(jparts[key]), 1e-10)


@pytest.mark.parametrize("dof", [4.0, 30.0])
def test_smm_pieces_match_jax(dof):
    x, jprior, jnat, prior, nat = _setup(k=4, seed=1)
    jexp, exp = jgmm.expected_params(jnat), gmm.expected_params(nat)
    xt, xj = torch.tensor(x), jnp.asarray(x)
    _close(smm._quad_form(xt, exp), jsmm._quad_form(xj, jexp), 1e-10)
    resp, e_u, ev = smm.e_step_obs(xt, exp, dof)
    jresp, je_u, jev = jsmm.e_step_obs(xj, jexp, dof)
    _close(resp, jresp, 1e-10, 1e-300)
    _close(e_u, je_u, 1e-10)
    _close(ev, jev, 1e-10)
    stats = smm.suff_stats_obs(xt, resp, e_u, scale=1.5)
    jstats = jsmm.suff_stats_obs(xj, jresp, je_u, scale=1.5)
    assert stats._fields == jstats._fields
    for got, want in zip(stats, jstats):
        _close(got, want, 1e-10, 1e-12)
    inc, jinc = smm.stats_to_nat(stats), jsmm.stats_to_nat(jstats)
    _assert_nat_close(inc, jinc, 1e-10, 1e-12)
    assert not torch.allclose(inc.niw_nat.eta2, inc.niw_nat.eta4)  # Δη₂ ≠ Δη₄
    elbo, parts = smm.elbo_obs(xt, nat, prior, dof=dof, scale=2.0)
    jelbo, jparts = jsmm.elbo_obs(xj, jnat, jprior, dof=dof, scale=2.0)
    _close(float(elbo), float(jelbo), 1e-10)
    _close(float(parts["local"]), float(jparts["local"]), 1e-10)


def _run_steps(step, jstep, state, jstate, x, t_steps):
    for _ in range(t_steps):
        state, mets = step(state, torch.tensor(x))
        jstate, jmets = jstep(jstate, jnp.asarray(x))
        for key in ("local_evidence", "elbo", "rho"):
            _close(float(mets[key]), float(jmets[key]), 1e-9, 0.0, key)
    return state, jstate


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("rho,num_total", [(0.3, 72), (1.0, 144)])
def test_gmm_baseline_steps_match_jax(fused, rho, num_total):
    x, jprior, jnat, prior, nat = _setup()
    step = gmm_baseline.make_train_step(prior, rho, num_total, fused=fused)
    jstep = jax.jit(jgmm_baseline.make_train_step(jprior, rho, num_total))
    state, jstate = _run_steps(
        step, jstep, gmm_baseline.GmmTrainState(nat=nat, step=0),
        jgmm_baseline.GmmTrainState(nat=jnat, step=jnp.zeros((), jnp.int32)), x, 5)
    _assert_nat_close(state.nat, jstate.nat, 1e-9)
    assert state.step == int(jstate.step) == 5


def test_smm_baseline_steps_match_jax():
    x, jprior, jnat, prior, nat = _setup(seed=2)
    step = smm_baseline.make_train_step(prior, 0.3, 72, dof=4.0)
    jstep = jax.jit(jsmm_baseline.make_train_step(jprior, 0.3, 72, dof=4.0))
    state, jstate = _run_steps(
        step, jstep, SmmTrainState(nat=nat, step=0),
        jsmm_baseline.SmmTrainState(nat=jnat, step=jnp.zeros((), jnp.int32)), x, 5)
    _assert_nat_close(state.nat, jstate.nat, 1e-9)


def test_init_state_uses_two_pseudo_counts():
    _, _, _, prior, _ = _setup()
    for module in (gmm_baseline, smm_baseline):
        state = module.init_state(torch.Generator().manual_seed(0), prior,
                                  torch.randn(20, 2, dtype=torch.float64))
        assert state.step == 0
        _close(state.nat.dir_nat - prior.dir_nat, np.full(5, 2.0), 0.0)


def test_evaluation_matches_jax():
    train, test, train_labels, _ = load_pinwheel(return_labels=True)
    _, jprior, jnat, prior, nat = _setup(k=10, seed=3)
    jstep = jax.jit(jgmm_baseline.make_train_step(jprior, 1.0, 400))
    jstate = jgmm_baseline.GmmTrainState(nat=jnat, step=jnp.zeros((), jnp.int32))
    for _ in range(5):  # a fitted state, not the prior-dominated start
        jstate, _ = jstep(jstate, jnp.asarray(train))
    jnat = jstate.nat
    nat = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jnat))
    got = gmm_baseline.evaluate(nat, prior, torch.tensor(test), num_total=400)
    want = jgmm_baseline.evaluate(jnat, jprior, jnp.asarray(test), num_total=400)
    for key in ("evidence_per_point", "elbo", "local", "kl_global"):
        _close(float(got[key]), float(want[key]), 1e-9, 0.0, key)
    _close(evaluation.gmm_predictive_log_prob(nat, torch.tensor(test)),
           jevaluation.gmm_predictive_log_prob(jnat, jnp.asarray(test)), 1e-9)
    resp, _ = gmm.e_step_obs(torch.tensor(train), gmm.expected_params(nat))
    jresp, _ = jgmm.e_step_obs(jnp.asarray(train), jgmm.expected_params(jnat))
    purity = evaluation.cluster_purity(resp, train_labels)
    _close(purity, jevaluation.cluster_purity(jresp, train_labels), 1e-9)
    assert 0.0 < purity <= 1.0


@pytest.mark.parametrize("seed", [0, 5])
def test_kmeanspp_bit_equal(seed):
    x = make_pinwheel_data(seed=seed)
    np.testing.assert_array_equal(init.kmeanspp_centers(x, 10, seed=seed),
                                  jinit.kmeanspp_centers(x, 10, seed=seed))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        nat = init.init_variational_kmeanspp(gmm.make_prior(10, 2, dtype=dt), x, seed=seed)
        jnat = jinit.init_variational_kmeanspp(jgmm.make_prior(10, 2, dtype=jdt), x,
                                               seed=seed)
        _assert_nat_close(nat, jnat, 0.0)


@pytest.mark.parametrize("seed", [0, 2])
def test_pinwheel_with_outliers_bit_equal(seed):
    for got, want in zip(pinwheel.make_pinwheel_with_outliers(seed=seed),
                         jpinwheel.make_pinwheel_with_outliers(seed=seed)):
        np.testing.assert_array_equal(got, want)
    got = pinwheel.make_pinwheel_with_outliers(0.2, 5.0, num_classes=3,
                                               num_per_class=10, seed=seed)
    want = jpinwheel.make_pinwheel_with_outliers(0.2, 5.0, num_classes=3,
                                                 num_per_class=10, seed=seed)
    np.testing.assert_array_equal(got[0], want[0])


def test_mixture_state_convert_round_trip():
    _, _, jnat, _, _ = _setup()
    jstate = jgmm_baseline.GmmTrainState(nat=jnat, step=jnp.asarray(7, jnp.int32))
    state = convert.mixture_state_from_numpy(jax.tree.map(np.asarray, jstate))
    assert isinstance(state, gmm_baseline.GmmTrainState) and state.step == 7
    back = convert.mixture_state_to_numpy(state)
    assert back["step"] == 7
    _assert_nat_close(state.nat, jnat, 0.0)
    np.testing.assert_array_equal(back["nat"]["eta3"], np.asarray(jnat.niw_nat.eta3))
    smm_state = convert.mixture_state_from_numpy(jstate, cls=SmmTrainState)
    assert isinstance(smm_state, SmmTrainState)


def _jax_pinwheel_gmm(dtype, steps=300):
    """300 steps of the JAX GMM step from the k-means++ naturals at
    pinwheel-gmm's settings (N=400, K=10, ρ=1, α=1, κ=0.05, seed 0)."""
    train, test = load_pinwheel(seed=0)
    jprior = jgmm.make_prior(10, 2, alpha=1.0, kappa=0.05, dtype=dtype)
    jstate = jgmm_baseline.GmmTrainState(
        nat=jinit.init_variational_kmeanspp(jprior, train, seed=0),
        step=jnp.zeros((), jnp.int32))
    step = jax.jit(jgmm_baseline.make_train_step(jprior, 1.0, num_total=400))
    x = jnp.asarray(train, dtype=dtype)
    for _ in range(steps):
        jstate, _ = step(jstate, x)
    return jstate, jnp.asarray(test, dtype=dtype)


@pytest.fixture
def float64_default():
    """The entries make their tensors in torch's default dtype."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


@pytest.mark.parametrize("engine", [["--engine", "kernel"],
                                    ["--engine", "plain", "--fused-kernel"]])
def test_train_gmm_whole_slice_float64(engine, capsys, float64_default):
    out = train_gmm.main(["--config", "pinwheel-gmm", "--device", "cpu",
                          "--init", "kmeanspp", *engine])
    assert out["state"].nat.dir_nat.dtype == torch.float64
    jstate, _ = _jax_pinwheel_gmm(jnp.float64)
    assert out["state"].step == 300
    _assert_nat_close(out["state"].nat, jstate.nat, 1e-8)
    assert "test_predictive_loglik_per_point" in capsys.readouterr().out


def test_train_gmm_whole_slice_float32_predictive():
    out = train_gmm.main(["--config", "pinwheel-gmm", "--device", "cpu",
                          "--init", "kmeanspp", "--eval-every", "100"])
    jstate, x_test = _jax_pinwheel_gmm(jnp.float32)
    jpred = float(jevaluation.gmm_predictive_log_prob(jstate.nat, x_test).mean())
    got = out["test_predictive_loglik_per_point"]
    assert abs(got - JAX_ENTRY_PREDICTIVE) < 1e-3, got
    assert abs(got - jpred) < 1e-3, (got, jpred)
    assert out["train_cluster_purity"] == pytest.approx(0.98)
    assert [r["step"] for r in out["rows"]] == [100, 200, 300]
    assert all(np.isfinite(list(r.values())).all() for r in out["rows"])
