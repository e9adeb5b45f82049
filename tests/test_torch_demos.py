"""The port's demos (``svax_torch.anomaly_demo``, ``robustness_demo``,
``latent_contamination_demo``, ``impute_demo``) against the JAX package's
(``experiments/*_demo.py``), on the CPU at small sizes.

JAX draws with threefry and the port with Philox, so the parity tests hold
the deterministic pieces, in float64 from one seeded state:

* ``_auc`` equals the reference's on seeded scores, with and without ties;
* one step of each online rule (``gmm_online``, ``smm_online``) from a
  converted JAX state equals the reference's math (``sin_combine``,
  ``smm_combine`` / ``suff_stats_latent``, ``cvi_update``) to 1e-5
  relative; ``make_streams`` equals the reference's recipe bit for bit;
* the per-point E[u] of ``robustness_demo.point_e_u`` equals
  ``svae_smm.forward``'s to 1e-5;
* the VAE fixed-point fill (both likelihoods) and the hidden-coordinate
  NLL (SVAE and VAE) equal the reference's loops to 1e-5; the live and
  the exported SVAE fills agree;
* each demo's ``main`` at a tiny size prints the reference's keys (the
  committed ``runs/latent_contamination_tanh.json`` and
  ``runs/impute_quality.json`` key for key) and trains on the engine
  ``choose_kernel`` picks; no default output is a reference artifact.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.data.pinwheel import make_pinwheel_data as jmake_pinwheel
from svax.data.pinwheel import make_pinwheel_with_outliers as jmake_outliers
from svax.models import svae as jsvae
from svax.models import svae_smm as jsvae_smm
from svax.models import vae as jvae
from svax.models.svae import SvaeConfig as JConfig
from svax.nets import mlp as jnets
from svax.pgm import gmm as jgmm
from svax.pgm import natgrad as jnatgrad
from svax.pgm import smm as jsmm
from svax.train import svae_step as jstep
from svax_torch import (anomaly_demo, convert, impute_demo, latent_contamination_demo,
                        robustness_demo, serve)
from svax_torch.models.svae import SvaeConfig
from svax_torch.pgm import gmm

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
F64 = torch.float64
HIGHEST = jax.lax.Precision.HIGHEST


def _reference(name: str):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}",
                                                  ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f64(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float64)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _jax_state(hidden=(16, 16), k=6, seed=0, n=200):
    """A float64 JAX SVAE state at random weights, naturals seeded on data
    rows, and its conversion."""
    x = jnp.asarray(jmake_pinwheel(num_per_class=n // 5, seed=seed), jnp.float64)
    config = JConfig(latent_dim=2, num_components=k, num_samples=1, num_total=n)
    prior = _f64(jgmm.make_prior(k, 2, kappa=0.05))
    state = _f64(jstep.init_state(jax.random.PRNGKey(seed), 2, config, prior,
                                  optax.adam(1e-3), hidden, hidden, data=x))
    port = convert.state_from_numpy(jax.tree.map(np.asarray, state), dtype=F64)
    pprior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, prior), dtype=F64)
    return state, prior, port, pprior, x


def _nat_close(got, want):
    leaves = [got.dir_nat, *got.niw_nat]
    refs = [want.dir_nat, *want.niw_nat]
    for a, b in zip(leaves, refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("ties", [False, True])
def test_auc_matches_the_reference(ties):
    rng = np.random.default_rng(3)
    pos, neg = rng.standard_normal(90), rng.standard_normal(40) - 1.0
    if ties:
        pos, neg = np.round(pos, 1), np.round(neg, 1)
        neg[:10] = pos[:10]
        assert len(np.unique(np.concatenate([pos, neg]))) < 130
    want = _reference("anomaly_demo")._auc(pos, neg)
    assert anomaly_demo._auc(pos, neg) == want
    assert 0.5 < want < 1.0


@pytest.mark.parametrize("rule", ["gmm", "smm"])
def test_online_rule_step_matches_the_reference(rule):
    state, prior, port, pprior, _ = _jax_state()
    xb_np = np.asarray(jmake_pinwheel(num_per_class=8, seed=5), np.float64)
    xb_np[-6:] = np.random.default_rng(2).uniform(-30, 30, (6, 2))  # far outliers
    xb = jnp.asarray(xb_np)
    rho, scale, dof, iters = 0.05, 400.0 / 40, 4.0, 2
    pot_h, pot_p = jnets.encoder_apply(state.nn_params["encoder"], xb, jnp.tanh, HIGHEST)
    exp = jgmm.expected_params(state.pgm_nat)
    cfg = SvaeConfig(latent_dim=2, num_components=6, num_samples=4, num_total=400)
    common = dict(nn=port.nn_params, prior=pprior, config=cfg, rho=rho, scale=scale)
    if rule == "gmm":
        post = jsvae.sin_combine(pot_h, pot_p, exp, jitter=0.0)
        resp = jnp.exp(post.log_resp)
        ezz = post.cov + post.mean[..., :, None] * post.mean[..., None, :]
        stats = jgmm.suff_stats_from_moments(resp, post.mean, ezz, scale)
        want = jnatgrad.cvi_update(state.pgm_nat, prior, jgmm.stats_to_nat(stats), rho)
        got, aux = latent_contamination_demo.gmm_online(port.pgm_nat, torch.tensor(xb_np),
                                                        **common)
        assert float(aux) == 1.0
    else:
        post, _ = jsvae_smm.smm_combine(pot_h, pot_p, exp, dof, iters, 0.0)
        stats = jsvae_smm.suff_stats_latent(post, scale)
        want = jnatgrad.cvi_update(state.pgm_nat, prior, jsmm.stats_to_nat(stats), rho)
        got, aux = latent_contamination_demo.smm_online(port.pgm_nat, torch.tensor(xb_np),
                                                        **common, dof=dof, smm_iters=iters)
        want_eu = np.asarray(jnp.sum(jnp.exp(post.log_resp) * post.e_u, axis=-1))
        np.testing.assert_allclose(aux.numpy(), want_eu, **TOL)
    _nat_close(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_streams_equal_the_reference_recipe(seed):
    """latent_contamination_demo.py:126-146 with the reference's pinwheel."""
    t_steps, batch, frac, box = 6, 40, 0.25, 30.0
    rng = np.random.default_rng(seed + 1)
    n_out = int(round(frac * batch))
    n_clean = batch - n_out

    def fresh_clean(count):
        per = count // 5 + 1
        d_ = jmake_pinwheel(num_per_class=per, seed=int(rng.integers(1 << 31)))
        idx = rng.permutation(d_.shape[0])[:count]
        return d_[idx]

    clean = np.stack([fresh_clean(batch) for _ in range(t_steps)]).astype(np.float32)
    contam = clean.copy()
    contam[:, n_clean:, :] = rng.uniform(-box, box, size=(t_steps, n_out, 2)).astype(
        np.float32)
    got = latent_contamination_demo.make_streams(seed, t_steps, batch, frac, box)
    np.testing.assert_array_equal(got[0], clean)
    np.testing.assert_array_equal(got[1], contam)
    assert got[2].tolist() == [0.0] * n_clean + [1.0] * n_out


def test_point_e_u_matches_the_reference():
    state, prior, port, pprior, _ = _jax_state(k=5, seed=1)
    x_np, labels = jmake_outliers(outlier_fraction=0.15, num_per_class=12, seed=1)
    x = jnp.asarray(x_np, jnp.float64)
    jcfg = JConfig(latent_dim=2, num_components=5, num_samples=1, num_total=len(x_np),
                   dof=4.0)
    out = jax.jit(lambda nn, nat, xx: jsvae_smm.forward(nn, nat, prior, xx,
                                                        jax.random.PRNGKey(0), jcfg))(
        state.nn_params, state.pgm_nat, x)
    want = np.asarray(jnp.sum(jnp.exp(out.posterior.log_resp) * out.posterior.e_u, axis=-1))
    cfg = SvaeConfig(latent_dim=2, num_components=5, num_samples=2, num_total=len(x_np),
                     dof=4.0)
    eps = torch.tensor(np.random.default_rng(0).standard_normal((1, len(x_np), 5, 2)))
    got = robustness_demo.point_e_u(port, pprior, torch.tensor(x_np), cfg, eps=eps)
    np.testing.assert_allclose(got, want, **TOL)
    assert got.shape == (len(x_np),) and np.isfinite(got).all()


def _reference_vae_fill(params, x_true, mask, iters, likelihood):
    """impute_demo.py:211-229."""
    def vae_recon(xc):
        pot_h, pot_p = jnets.encoder_apply(params["encoder"], xc, jnp.tanh)
        out = jnets.decoder_apply(params["decoder"], pot_h / pot_p, likelihood, jnp.tanh)
        return out[0] if likelihood == "gaussian" else jax.nn.sigmoid(out)

    hidden = mask == 0.0
    xv = jnp.asarray(np.where(hidden, 0.0, x_true))
    mj = jnp.asarray(mask)
    cur = xv
    for _ in range(iters):
        cur = mj * xv + (1.0 - mj) * vae_recon(cur)
    return np.asarray(cur)


@pytest.mark.parametrize("likelihood", ["gaussian", "bernoulli"])
def test_vae_fill_matches_the_reference(likelihood):
    d_in = 2 if likelihood == "gaussian" else 12
    rng = np.random.default_rng(4)
    if likelihood == "gaussian":
        xt = np.asarray(jmake_pinwheel(num_per_class=10, seed=2))
        x_true, mask = impute_demo.masks("pinwheel", xt)
    else:
        x_true = (rng.uniform(size=(30, d_in)) > 0.6).astype(np.float64)
        _, mask = impute_demo.masks("mnist", x_true)
    jst = _f64(jvae.init_state(jax.random.PRNGKey(1), d_in,
                               jvae.VaeConfig(latent_dim=3, likelihood=likelihood),
                               optax.adam(1e-3), (16, 16), (16, 16)))
    params = convert.vae_state_from_numpy(jax.tree.map(np.asarray, jst), dtype=F64).params
    want = _reference_vae_fill(jst.params, x_true, mask, 4, likelihood)
    got = impute_demo.vae_fill(params, x_true, mask, 4, likelihood)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[mask == 1.0], x_true[mask == 1.0])


def test_masks_equal_the_reference_recipe():
    xt = np.asarray(jmake_pinwheel(num_per_class=4, seed=0))
    x_true, mask = impute_demo.masks("pinwheel", xt)
    assert x_true.shape == (40, 2) and mask[:20, 0].sum() == 0 and mask[20:, 1].sum() == 0
    img = np.zeros((7, 9), np.float32)
    want = (np.random.default_rng(0).uniform(size=img.shape) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(impute_demo.masks("mnist", img)[1], want)


@pytest.mark.parametrize("model", ["svae", "vae"])
def test_hidden_coord_nll_matches_the_reference(model):
    """impute_demo.py:251-267."""
    state, prior, port, pprior, _ = _jax_state(k=5, seed=2)
    if model == "vae":
        jst = _f64(jvae.init_state(jax.random.PRNGKey(3), 2, jvae.VaeConfig(latent_dim=2),
                                   optax.adam(1e-3), (16, 16), (16, 16)))
        jparams, nat, jnat = jst.params, None, None
        params = convert.vae_state_from_numpy(jax.tree.map(np.asarray, jst), dtype=F64).params
    else:
        jparams, params, jnat, nat = state.nn_params, port.nn_params, state.pgm_nat, \
            port.pgm_nat
    xt = np.asarray(jmake_pinwheel(num_per_class=6, seed=3))
    x_true, mask = impute_demo.masks("pinwheel", xt)
    hidden = mask == 0.0
    fill = np.where(hidden, np.random.default_rng(5).standard_normal(x_true.shape) * 8, x_true)
    pot_h, pot_p = jnets.encoder_apply(jparams["encoder"], jnp.asarray(fill), jnp.tanh)
    if jnat is not None:
        post = jsvae.sin_combine(pot_h, pot_p, jgmm.expected_params(jnat))
        z = jnp.einsum("nk,nkd->nd", jnp.exp(post.log_resp), post.mean)
    else:
        z = pot_h / pot_p
    mean, var = jnets.decoder_apply(jparams["decoder"], z, "gaussian", jnp.tanh)
    nll = 0.5 * ((jnp.asarray(x_true) - mean) ** 2 / var + jnp.log(var)
                 + jnp.log(2 * jnp.pi))
    want = float(jnp.mean(nll[jnp.asarray(hidden)]))
    got = impute_demo.hidden_coord_nll(fill, params, "tanh", x_true, hidden, nat)
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("ds", ["pinwheel", "mnist"])
def test_live_and_exported_fills_agree(ds, tmp_path):
    d_in = 2 if ds == "pinwheel" else 20
    cfg = SvaeConfig(latent_dim=3, num_components=4, num_total=50,
                     likelihood="gaussian" if ds == "pinwheel" else "bernoulli")
    from svax_torch.train import svae_step

    prior = gmm.make_prior(4, 3)
    st = svae_step.init_state(torch.Generator().manual_seed(0), d_in, cfg, prior, (16,), (16,))
    spec = serve.ModelSpec(input_dim=d_in, latent_dim=3, num_components=4,
                           likelihood=cfg.likelihood, encoder_hidden=(16,),
                           decoder_hidden=(16,), num_total=50)
    server = serve.SvaeServer(st.nn_params, st.pgm_nat, spec, buckets=(32,))
    rng = np.random.default_rng(6)
    x_true = (rng.standard_normal((20, d_in)) if ds == "pinwheel"
              else (rng.uniform(size=(20, d_in)) > 0.5).astype(np.float32))
    x_true, mask = impute_demo.masks(ds, x_true)
    x_masked = np.where(mask == 0.0, np.nan, x_true).astype(np.float32)
    for mode in ("mean", "map"):
        live = server.impute(x_masked, mask, num_iters=3, mode=mode)
        out = tmp_path / mode
        manifest = serve.export_serving(server, out, impute_iters=3, impute_mode=mode,
                                        endpoints=("impute",))
        assert list(manifest["artifacts"]) == ["impute"]
        exported = serve.load_exported(out).impute(x_masked, mask)
        np.testing.assert_allclose(exported, live, rtol=1e-6, atol=1e-6)
        assert np.isfinite(live).all()
    with pytest.raises(ValueError, match="endpoints"):
        serve.export_serving(server, tmp_path / "bad", endpoints=("generate",))


def _keys(tree):
    """The nested key structure of a JSON object."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_anomaly_and_robustness_mains_print_the_reference_keys(capsys):
    out = anomaly_demo.main(["--device", "cpu", "--steps", "20", "--scan-chunk", "10",
                             "--iw-samples", "10", "--outlier-scale", "30"])
    printed = json.loads(capsys.readouterr().out)
    _, labels = jmake_outliers(outlier_fraction=0.15, num_per_class=60, outlier_scale=30.0,
                               seed=13)
    assert printed["n_test"] == len(labels) and printed["n_outliers"] == int((labels < 0).sum())
    score_keys = {"roc_auc": None, "mean_score_clean": None, "mean_score_outlier": None}
    assert _keys(printed) == {"outlier_fraction": None, "outlier_scale": None, "n_test": None,
                              "n_outliers": None, "gmm": score_keys, "smm": score_keys}
    assert out["kernels"] == {"gmm": "tinystep", "smm": "tinystep"}
    assert 0.0 <= printed["gmm"]["roc_auc"] <= 1.0

    out = robustness_demo.main(["--device", "cpu", "--steps", "20", "--scan-chunk", "10"])
    printed = json.loads(capsys.readouterr().out)
    base = {"clean_test_elbo_per_point": None, "contaminated_train_elbo_per_point": None,
            "final_train_elbo": None}
    assert _keys(printed) == {"gmm": base, "smm": {**base, "mean_Eu_outliers": None,
                                                   "mean_Eu_clean": None},
                              "dof": None, "outlier_fraction": None, "activation": None}
    assert out["kernels"] == {"gmm": "tinystep", "smm": "tinystep"}
    out = robustness_demo.main(["--device", "cpu", "--steps", "3", "--scan-chunk", "3",
                                "--activation", "relu"])
    assert out["kernels"] == {"gmm": "per-step", "smm": "per-step"}
    assert all(np.isfinite(v) for v in out["smm"].values())


def test_latent_contamination_main_writes_the_reference_keys(tmp_path):
    ref = json.loads((ROOT / "runs" / "latent_contamination_tanh.json").read_text())
    path = tmp_path / "lc_torch.json"
    out = latent_contamination_demo.main(
        ["--device", "cpu", "--pretrain-steps", "20", "--scan-chunk", "10",
         "--online-steps", "6", "--batch", "40", "--iw-samples", "10", "--json", str(path)])
    written = json.loads(path.read_text())
    want = _keys(ref)
    want["config"] = {("device" if k == "platform" else k): None for k in ref["config"]}
    assert _keys(written) == want
    assert out["kernel"] == "tinystep"
    assert all(np.isfinite(v) for v in written["clean_test_iw_per_point"].values())
    default = latent_contamination_demo.parse_args([]).json
    assert "torch" in Path(default).name and default != ref["config"]["json"]
    with pytest.raises(ValueError, match="reference"):
        latent_contamination_demo.main(["--device", "cpu", "--json",
                                        "runs/latent_contamination.json"])


def test_impute_main_writes_the_reference_keys(tmp_path, monkeypatch):
    ref = json.loads((ROOT / "runs" / "impute_quality.json").read_text())
    monkeypatch.setattr(impute_demo, "SPECS", {
        ds: dict(sp, steps=4, warmup=min(sp["warmup"], 2))
        for ds, sp in impute_demo.SPECS.items()})
    path = tmp_path / "iq_torch.json"
    out = impute_demo.main(["--device", "cpu", "--impute-iters", "2", "--json", str(path)])
    written = json.loads(path.read_text())
    assert _keys(written) == _keys(ref)
    assert out["kernels"] == {"pinwheel": "tinystep", "mnist": "per-step"}
    for ds in ("pinwheel", "mnist"):
        assert written[ds]["aot_max_abs_diff"] <= 1e-5
        assert written[ds]["n_problems"] == ref[ds]["n_problems"]
    # The baselines do not depend on training: the reference's own numbers.
    assert written["pinwheel"]["rmse"]["mean_fill"] == ref["pinwheel"]["rmse"]["mean_fill"]
    assert written["mnist"]["masked_pixel_nll"]["mean_fill"] == \
        ref["mnist"]["masked_pixel_nll"]["mean_fill"]
    assert impute_demo.DEFAULT_JSON == "runs/impute_quality_torch.json"
    with pytest.raises(ValueError, match="reference"):
        impute_demo.main(["--device", "cpu", "--json", "runs/impute_quality.json"])
