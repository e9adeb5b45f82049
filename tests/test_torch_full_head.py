"""The full-covariance recognition head, jitter, remat_combine and the
non-tanh activations (``SvaeConfig`` slice J) against the JAX package.

Same JAX-built parameters and naturals (``svax_torch.convert``), same
numpy noise, float64 unless stated, at small sizes (d = 2–4, K = 3–4,
16-16 nets, N = 32–48):

* ``encoder_apply(head="full")`` and its widths; zero off-diagonal outputs
  give the diagonal head's potential (to the f32 rounding of 1/√v squared);
* ``sin_combine`` with full potentials and jitter; ``forward`` with the full
  head (value and gradients); ``remat_combine`` equal to the run without it;
* ReLU and softplus nets; ``svae_iw_loglik`` with the full head; the SMM
  prior with the full head and jitter; the warmup's latent means;
* a bundle written by ``svax/serve.py`` with a full head and ReLU nets,
  served by the port on the CPU, equal to the JAX server's encode;
* the entry: ``--encoder-head full`` trains on the per-step engine,
  ``--engine megakernel`` refuses it with both kernels' reasons, the
  kernel runner refuses it, and resume stays bit-exact.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax import serve as jserve
from svax.data import make_pinwheel_data
from svax.models import evaluation as jevaluation
from svax.models import svae as jsvae
from svax.models import svae_smm as jsmm
from svax.models.svae import SvaeConfig as JConfig
from svax.nets import mlp as jnets
from svax.ops import batched_linalg as jbl
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax.train import warmup as jwarmup
from svax_torch import convert, serve, train_svae
from svax_torch.models import evaluation, svae, svae_smm
from svax_torch.models.svae import SvaeConfig
from svax_torch.nets import mlp as nets
from svax_torch.ops import batched_linalg as bl
from svax_torch.pgm import gmm
from svax_torch.train import loop, svae_step, warmup
from svax_torch.train.checkpoint import Checkpointer

torch.set_num_threads(1)
RTOL = 1e-9
HI = jax.lax.Precision.HIGHEST
JACTS = {"tanh": jnp.tanh, "relu": jax.nn.relu, "softplus": jax.nn.softplus}


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), rtol=rtol, atol=atol)


def _params(rng, sizes, scale=0.4):
    return [{"w": scale * rng.standard_normal((i, o)), "b": 0.1 * rng.standard_normal(o)}
            for i, o in zip(sizes[:-1], sizes[1:])]


def _both(params):
    return (jax.tree.map(jnp.asarray, params),
            [{k: torch.tensor(v) for k, v in ly.items()} for ly in params])


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_encoder_widths_match_jax(d):
    for head in ("diag", "full"):
        w = nets.encoder_out_dim(d, head)
        assert w == jnets.encoder_out_dim(d, head)
        assert nets._latent_dim_from_width(w, head) == jnets._latent_dim_from_width(w, head)
    with pytest.raises(ValueError, match="not a 'full'-head width"):
        nets._latent_dim_from_width(nets.encoder_out_dim(d, "full") + 1, "full")


@pytest.mark.parametrize("d,act", [(2, "tanh"), (3, "relu"), (4, "softplus")])
def test_full_head_encoder_matches_jax(d, act):
    rng = np.random.default_rng(d)
    jp, tp = _both(_params(rng, [5, 16, 16, nets.encoder_out_dim(d, "full")]))
    x = rng.standard_normal((32, 5))
    h, p = nets.encoder_apply(tp, torch.tensor(x), act, head="full")
    jh, jpp = jnets.encoder_apply(jp, jnp.asarray(x), JACTS[act], HI, head="full")
    assert p.shape == (32, d, d)
    _close(h, jh)
    _close(p, jpp)
    torch.testing.assert_close(p, p.mT, rtol=0.0, atol=0.0)


def test_zero_off_diagonals_give_the_diagonal_head():
    """With the last d(d−1)/2 outputs zero, the full head's P is diagonal
    with the diagonal head's precisions, 1/√v squared against 1/v: within
    4e-7 relative in float32 (two roundings); h likewise."""
    rng = np.random.default_rng(7)
    d = 3
    params = _params(rng, [4, 16, nets.encoder_out_dim(d, "full")])
    params[-1]["w"][:, 2 * d:] = 0.0
    params[-1]["b"][2 * d:] = 0.0
    t32 = [{k: torch.tensor(v, dtype=torch.float32) for k, v in ly.items()} for ly in params]
    diag = [dict(ly) for ly in t32]
    diag[-1] = {"w": t32[-1]["w"][:, :2 * d], "b": t32[-1]["b"][:2 * d]}
    x = torch.tensor(rng.standard_normal((40, 4)), dtype=torch.float32)
    hf, pf = nets.encoder_apply(t32, x, head="full")
    hd, pd = nets.encoder_apply(diag, x)
    off = pf - torch.diag_embed(torch.diagonal(pf, dim1=-2, dim2=-1))
    assert torch.count_nonzero(off) == 0
    torch.testing.assert_close(torch.diagonal(pf, dim1=-2, dim2=-1), pd, rtol=4e-7, atol=0.0)
    torch.testing.assert_close(hf, hd, rtol=4e-7, atol=1e-30)


def _setup(head="full", k=4, d=2, s=3, n=48, seed=0, activation="tanh", jitter=0.0, dof=0.0):
    x = jnp.asarray(make_pinwheel_data(num_classes=3, num_per_class=n // 3, seed=seed)[:n])
    jconfig = JConfig(latent_dim=d, num_components=k, num_samples=s, num_total=n,
                      nn_precision=HI, encoder_head=head, jitter=jitter,
                      activation=JACTS[activation], dof=dof)
    jprior = jgmm.make_prior(k, d, kappa=0.05, dtype=jnp.float64)
    jstate = jstep.init_state(jax.random.PRNGKey(seed), 2, jconfig, jprior, optax.adam(1e-3),
                              (16, 16), (16, 16), dtype=jnp.float64)
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate))
    prior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior))
    eps = np.random.default_rng(seed + 1).standard_normal((s, n, k, d))
    config = SvaeConfig(latent_dim=d, num_components=k, num_samples=s, num_total=n,
                        nn_precision="highest", encoder_head=head, jitter=jitter,
                        activation=activation, dof=dof)
    return dict(x=x, xt=torch.tensor(np.asarray(x)), jconfig=jconfig, jprior=jprior,
                jstate=jstate, state=state, prior=prior, eps=eps, config=config)


def test_init_params_shapes_follow_the_head():
    c = _setup()
    enc = c["state"].nn_params["encoder"]
    assert enc[-1]["w"].shape == (16, nets.encoder_out_dim(2, "full"))
    config = SvaeConfig(latent_dim=3, num_components=2, encoder_head="full")
    p = svae.init_params(torch.Generator().manual_seed(0), 5, config, (8,), (8,))
    assert p["encoder"][-1]["w"].shape == (8, 9)


def test_add_jitter_matches_jax():
    a = np.random.default_rng(0).standard_normal((5, 3, 4, 4))
    _close(bl.add_jitter(torch.tensor(a), 1e-3), jbl.add_jitter(jnp.asarray(a), 1e-3))
    _close(bl.add_jitter(torch.tensor(a)), jbl.add_jitter(jnp.asarray(a)))


@pytest.mark.parametrize("jitter", [0.0, 1e-2])
def test_sin_combine_full_potential_and_jitter_match_jax(jitter):
    c = _setup(d=3, k=3)
    h, p = nets.encoder_apply(c["state"].nn_params["encoder"], c["xt"], head="full")
    jh, jp = jnets.encoder_apply(c["jstate"].nn_params["encoder"], c["x"], head="full")
    post = svae.sin_combine(h, p, gmm.expected_params(c["state"].pgm_nat), jitter=jitter)
    jpost = jsvae.sin_combine(jh, jp, jgmm.expected_params(c["jstate"].pgm_nat),
                              jitter=jitter)
    for got, want in zip(post, jpost):
        _close(got, want, atol=1e-12)


def _grads(forward, params, *args, **kw):
    params = svae_step.map_params(lambda t: t.clone().requires_grad_(True), params)
    out = forward(params, *args, **kw)
    leaves = [t for side in params.values() for ly in side for t in ly.values()]
    return out, torch.autograd.grad(-(out.recon - out.local_kl) / args[-2].shape[0], leaves)


def _jax_grads(forward, nn, *args, **kw):
    n = args[2].shape[0]

    def loss(nn):
        out = forward(nn, *args, **kw)
        return -(out.recon - out.local_kl) / n, out

    (_, out), g = jax.value_and_grad(loss, has_aux=True)(nn)
    return out, [np.asarray(ly[name]) for side in ("encoder", "decoder")
                 for ly in g[side] for name in ("w", "b")]


def _assert_forward_matches(c, port_forward, jax_forward, port_config=None, **kw):
    jout, jg = _jax_grads(jax_forward, c["jstate"].nn_params, c["jstate"].pgm_nat,
                          c["jprior"], c["x"], jax.random.PRNGKey(0), c["jconfig"],
                          eps=jnp.asarray(c["eps"]))
    out, g = _grads(port_forward, c["state"].nn_params, c["state"].pgm_nat, c["prior"],
                    c["xt"], port_config or c["config"], eps=torch.tensor(c["eps"]), **kw)
    for name in ("elbo", "recon", "local_kl", "global_kl"):
        _close(getattr(out, name), getattr(jout, name), rtol=1e-8)
    for got, want in zip(g, jg):
        _close(got, want, rtol=1e-7, atol=1e-11)
    return out, g


@pytest.mark.parametrize("jitter", [0.0, 1e-3])
def test_forward_full_head_value_and_grads_match_jax(jitter):
    c = _setup(jitter=jitter)
    _assert_forward_matches(c, svae.forward, jsvae.forward)


def test_remat_combine_keeps_value_and_grads():
    """``remat_combine`` recomputes the combine in the backward: the value
    and every gradient equal the run without it, bit for bit, and the
    reference's remat run at rtol 1e-8."""
    c = _setup()
    out, g = _grads(svae.forward, c["state"].nn_params, c["state"].pgm_nat, c["prior"],
                    c["xt"], c["config"], eps=torch.tensor(c["eps"]))
    c["jconfig"] = c["jconfig"]._replace(remat_combine=True)
    out_r, g_r = _assert_forward_matches(c, svae.forward, jsvae.forward,
                                         c["config"]._replace(remat_combine=True))
    assert out_r.elbo.item() == out.elbo.item()
    for a, b in zip(g_r, g):
        assert torch.equal(a, b)


@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_activation_nets_forward_matches_jax(act):
    c = _setup(head="diag", activation=act)
    _assert_forward_matches(c, svae.forward, jsvae.forward)
    rng = np.random.default_rng(3)
    jp, tp = _both(_params(rng, [2, 16, 16, 6]))
    z = rng.standard_normal((5, 2))
    x = rng.standard_normal((5, 3))
    _close(nets.log_likelihood(tp, torch.tensor(z), torch.tensor(x), "gaussian", act),
           jnets.log_likelihood(jp, jnp.asarray(z), jnp.asarray(x), "gaussian", JACTS[act]))


def test_iw_loglik_full_head_matches_jax():
    """The IW bound with the full head at one JAX key: its Gumbel and ε
    draws reproduced from the key and injected into the port."""
    c = _setup(jitter=1e-3, activation="relu")
    key, s = jax.random.PRNGKey(5), 7
    want = jevaluation.svae_iw_loglik(c["jstate"].nn_params, c["jstate"].pgm_nat, c["x"], key,
                                      c["jconfig"], num_samples=s)
    k_cat, k_norm = jax.random.split(key)
    n, k, d = c["x"].shape[0], 4, 2
    gumbel = np.asarray(jax.random.gumbel(k_cat, (s, n, k), dtype=c["x"].dtype))
    eps = np.asarray(jax.random.normal(k_norm, (s, n, k, d), dtype=c["x"].dtype))
    got = evaluation.svae_iw_loglik(c["state"].nn_params, c["state"].pgm_nat, c["xt"], s,
                                    gumbel=torch.tensor(gumbel), eps=torch.tensor(eps),
                                    encoder_head="full", jitter=1e-3, activation="relu")
    _close(got, want, rtol=1e-8)


def test_smm_full_head_and_jitter_match_jax():
    c = _setup(jitter=1e-3, dof=4.0)
    _assert_forward_matches(c, svae_smm.forward, jsmm.forward)
    h, p = nets.encoder_apply(c["state"].nn_params["encoder"], c["xt"], head="full")
    post, _ = svae_smm.smm_combine(h, p, gmm.expected_params(c["state"].pgm_nat), 4.0, 2,
                                   jitter=1e-3)
    jh, jp = jnets.encoder_apply(c["jstate"].nn_params["encoder"], c["x"], head="full")
    jpost, _ = jsmm.smm_combine(jh, jp, jgmm.expected_params(c["jstate"].pgm_nat), 4.0, 2,
                                1e-3)
    for got, want in zip(post, jpost):
        _close(got, want, atol=1e-12)


def test_warmup_latent_means_full_head_match_jax():
    c = _setup(d=3, k=3)
    got = warmup.encoded_latent_means(c["state"].nn_params, c["xt"], head="full")
    want = jwarmup.encoded_latent_means(c["jstate"].nn_params, c["x"], head="full")
    _close(got, want, rtol=1e-8)


def test_reference_bundle_full_head_relu_serves_equal(tmp_path):
    """A bundle written by ``svax/serve.py`` (full head, ReLU nets), its
    state converted (``convert.bundle_from_numpy``), served by the port on
    the CPU: encode, reconstruct and the score's draws-free parts equal the
    JAX server's at rtol/atol 1e-5, the components equal."""
    jspec = jserve.ModelSpec(input_dim=2, latent_dim=2, num_components=4, encoder_hidden=(16,),
                             decoder_hidden=(16,), num_samples=2, num_total=60,
                             activation="relu", encoder_head="full")
    x = jnp.asarray(make_pinwheel_data(num_per_class=20, seed=0), jnp.float32)
    config = jspec.to_config()._replace(num_total=x.shape[0])
    prior = jspec.make_prior()
    opt = optax.adam(1e-3)
    key = jax.random.PRNGKey(0)
    jstate = jstep.init_state(key, 2, config, prior, opt, (16,), (16,), data=x)
    step = jax.jit(jstep.make_train_step(config, prior, opt, rho=0.1))
    for i in range(20):
        jstate, _ = step(jstate, x, jax.random.fold_in(key, i))
    jserve.save_bundle(tmp_path / "jax", jstate, jspec)
    spec = json.loads((tmp_path / "jax" / "spec.json").read_text())
    assert spec["encoder_head"] == "full" and spec["activation"] == "relu"
    convert.bundle_from_numpy(tmp_path / "port", jax.tree.map(np.asarray, jstate), spec)
    srv = serve.load_bundle(tmp_path / "port", buckets=(8, 32), device="cpu")
    jsrv = jserve.SvaeServer(jstate.nn_params, jstate.pgm_nat, jspec, buckets=(8, 32))
    q = make_pinwheel_data(num_per_class=8, seed=3).astype(np.float32)
    got, want = srv.encode(q), jsrv.encode(q)
    for name in ("z_mean", "responsibilities"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["component"], want["component"])
    np.testing.assert_allclose(srv.reconstruct(q), jsrv.reconstruct(q), rtol=1e-5, atol=1e-5)
    assert dataclasses.asdict(srv.spec)["encoder_head"] == "full"
    assert np.isfinite(srv.score(q, num_samples=10)).all()


def test_full_head_bundle_exports_equal_to_live(tmp_path):
    """The port's own full-head ReLU bundle: its exported tier equals the
    live server (encode within 1e-6, score bit for bit for one seed)."""
    spec = serve.ModelSpec(input_dim=2, latent_dim=3, num_components=3, encoder_hidden=(8,),
                           decoder_hidden=(8,), activation="relu", encoder_head="full")
    config = spec.to_config()
    state = svae_step.init_state(torch.Generator().manual_seed(0), 2, config,
                                 spec.make_prior(), (8,), (8,))
    serve.save_bundle(tmp_path / "b", state, spec)
    live = serve.load_bundle(tmp_path / "b", buckets=(16,), device="cpu")
    serve.export_serving(live, tmp_path / "e", score_samples=5)
    aot = serve.load_exported(tmp_path / "e")
    q = make_pinwheel_data(num_per_class=4, seed=1).astype(np.float32)
    np.testing.assert_allclose(aot.encode(q)["z_mean"], live.encode(q)["z_mean"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(aot.score(q, seed=3), live.score(q, seed=3, num_samples=5))


# ---------------------------------------------------------------- the entry


def test_train_svae_full_head_runs_on_the_per_step_engine(capsys):
    out = train_svae.main(["--config", "pinwheel-svae", "--device", "cpu", "--steps", "6",
                           "--encoder-head", "full", "--remat", "--iw-samples", "3"])
    first = json.loads(capsys.readouterr().out.splitlines()[0])
    assert out["kernel"] == loop.PER_STEP and "encoder_head='diag'" in out["why"]
    assert first["encoder_head"] == "full" and first["remat_combine"] is True
    assert first["nn_precision"] == "default"  # the config's
    assert out["state"].nn_params["encoder"][-1]["w"].shape[1] == 5
    assert np.isfinite(out["final_test_iw_loglik_per_point"])


def test_engine_megakernel_refuses_the_full_head(capsys):
    with pytest.raises(SystemExit):
        train_svae.main(["--config", "pinwheel-svae", "--device", "cpu", "--steps", "1",
                         "--engine", "megakernel", "--encoder-head", "full"])
    err = capsys.readouterr().err
    assert "tinystep kernel needs encoder_head='diag'" in err
    assert "flexstep kernel needs encoder_head='diag'" in err


def test_kernel_runner_refuses_the_full_head():
    config = SvaeConfig(latent_dim=2, num_components=3, encoder_head="full")
    with pytest.raises(ValueError, match="diagonal recognition head"):
        loop.make_runner(config, gmm.make_prior(3, 2), lr=1e-3, rho=0.1, kernel="tinystep")


def test_exact_resume_with_the_full_head(tmp_path):
    """The per-step engine with the full head: two chunks equal a chunk, a
    save, a restore into a fresh template and a chunk, bit for bit."""
    x = torch.tensor(make_pinwheel_data(num_classes=3, num_per_class=12, seed=0))
    config = SvaeConfig(latent_dim=2, num_components=3, num_samples=2, num_total=36,
                        encoder_head="full", jitter=1e-4, nn_precision="default")
    prior = gmm.make_prior(3, 2, kappa=0.05, dtype=torch.float64)
    state0 = svae_step.init_state(torch.Generator().manual_seed(0), 2, config, prior,
                                  (8,), (8,), data=x)
    fresh = svae_step.init_state(torch.Generator().manual_seed(9), 2, config, prior,
                                 (8,), (8,), data=x)
    runner = loop.make_step_runner(config, prior, lr=1e-3, rho=0.2, aug_noise=0.1)
    ref, _ = runner(state0, x, 3, seed=4)
    ref, _ = runner(ref, x, 3, seed=4)
    half, _ = runner(state0, x, 3, seed=4)
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(3, half)
    restored, _, start = ckpt.restore_or(fresh)
    resumed, _ = runner(restored, x, 3, seed=4)
    assert start == 3
    for a, b in zip(svae_step.map_params(lambda t: t, ref.nn_params)["encoder"],
                    resumed.nn_params["encoder"]):
        assert all(torch.equal(a[n], b[n]) for n in ("w", "b"))
    assert torch.equal(ref.pgm_nat.dir_nat, resumed.pgm_nat.dir_nat)
    assert ref.step == resumed.step == 6
