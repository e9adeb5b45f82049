"""The port's serving layer (``svax_torch.serve``) against the JAX package's
(``svax/serve.py``), on the same weights: a JAX-trained state converted
into a port bundle (``convert.bundle_from_numpy``).

* the live server equals the JAX live server on ``encode``,
  ``reconstruct`` and ``impute`` (mean and map) to rtol 1e-5, with
  ``component`` equal; ``score`` equals the IW bound on the same draws;
  generate's plug-in moments match the reference's plug-in parameters;
* the SMM server, padding invisibility, the missing-state error, the
  refused bundles (an unknown head or activation), ``spec.json`` equal to
  the reference's;
* the exported tier equal to the live one (score bit for bit for one
  seed), its bucket contract, and its self-containment in a child process
  whose import of the model modules raises.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax import serve as jserve
from svax.data import make_pinwheel_data
from svax.models import evaluation as jevaluation
from svax.train import svae_step as jstep
from svax_torch import convert, serve
from svax_torch.models import evaluation

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)


def _trained(jspec, steps=30, seed=0):
    """A JAX state trained ``steps`` steps (tests/test_serve.py's recipe)."""
    key = jax.random.PRNGKey(seed)
    x = jnp.asarray(make_pinwheel_data(num_per_class=20, seed=seed), jnp.float32)
    config = jspec.to_config()._replace(num_total=x.shape[0])
    prior = jspec.make_prior()
    opt = optax.adam(1e-3)
    state = jstep.init_state(key, jspec.input_dim, config, prior, opt,
                             jspec.encoder_hidden, jspec.decoder_hidden, data=x)
    kwargs = {}
    if jspec.dof > 0.0:
        from svax.models import svae_smm

        kwargs["model"] = svae_smm
    step = jax.jit(jstep.make_train_step(config, prior, opt, rho=0.1, **kwargs))
    for i in range(steps):
        state, _ = step(state, x, jax.random.fold_in(key, i))
    return state


def _pair(tmp_path_factory, jspec, steps=30, seed=0, buckets=(8, 32)):
    """(JAX server, port server) on the same weights."""
    jstate = _trained(jspec, steps, seed)
    path = tmp_path_factory.mktemp("bundle")
    convert.bundle_from_numpy(path, jax.tree.map(np.asarray, jstate),
                              dataclasses.asdict(jspec))
    jsrv = jserve.SvaeServer(jstate.nn_params, jstate.pgm_nat, jspec, buckets=buckets)
    return jsrv, serve.load_bundle(path, buckets=buckets, device="cpu"), jstate


@pytest.fixture(scope="module")
def jspec():
    return jserve.ModelSpec(input_dim=2, latent_dim=2, num_components=4,
                            likelihood="gaussian", encoder_hidden=(16,),
                            decoder_hidden=(16,), num_samples=2, num_total=100)


@pytest.fixture(scope="module")
def servers(jspec, tmp_path_factory):
    return _pair(tmp_path_factory, jspec)


@pytest.fixture(scope="module")
def exported(servers, tmp_path_factory):
    path = tmp_path_factory.mktemp("exports")
    manifest = serve.export_serving(servers[1], path, score_samples=20)
    assert set(manifest["artifacts"]) == {"encode", "reconstruct", "score", "impute"}
    ref_keys = {"input_dim", "buckets", "score_samples", "impute_iters", "impute_mode",
                "platforms", "artifacts"}
    assert ref_keys <= set(manifest) and manifest["platforms"] == ["cpu", "cuda"]
    return serve.load_exported(path), path


def _x(num_per_class, seed):
    return make_pinwheel_data(num_per_class=num_per_class, seed=seed).astype(np.float32)


# ------------------------------------------------------------ live server


def test_bundle_roundtrip_no_flags(servers, jspec):
    _, srv, _ = servers
    assert dataclasses.asdict(srv.spec) == dataclasses.asdict(jspec)
    out = srv.encode(_x(5, 1))
    assert out["z_mean"].shape == (25, 2) and out["responsibilities"].shape == (25, 4)
    assert out["component"].dtype == np.int64
    np.testing.assert_allclose(out["responsibilities"].sum(-1), 1.0, rtol=1e-5)


def test_live_server_matches_jax_server(servers):
    jsrv, srv, _ = servers
    x = _x(8, 6)  # 40 rows: one padded bucket of 32 and one of 8
    got, want = srv.encode(x), jsrv.encode(x)
    np.testing.assert_allclose(got["z_mean"], want["z_mean"], **TOL)
    np.testing.assert_allclose(got["responsibilities"], want["responsibilities"], **TOL)
    np.testing.assert_array_equal(got["component"], want["component"])
    np.testing.assert_allclose(srv.reconstruct(x), jsrv.reconstruct(x), **TOL)
    mask = np.ones_like(x)
    mask[::2, 0] = 0.0
    mask[1::3, 1] = 0.0
    x_nan = np.where(mask > 0, x, np.nan).astype(np.float32)
    for mode in ("mean", "map"):
        got = srv.impute(x_nan, mask, num_iters=8, mode=mode)
        np.testing.assert_allclose(got, jsrv.impute(x_nan, mask, num_iters=8, mode=mode),
                                   **TOL)
        # Observed coordinates pass through bit for bit; the fill is finite.
        np.testing.assert_array_equal(got[mask > 0], x[mask > 0])
        assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(srv.impute(x, np.ones_like(x)), x)
    np.testing.assert_array_equal(srv.impute(x, np.full_like(x, 0.5)), x)
    with pytest.raises(ValueError, match="mode"):
        srv.impute(x, mask, mode="argmax")
    np.testing.assert_array_equal(srv.cluster(x), jsrv.cluster(x))


def test_score_matches_iw_bound_on_the_same_draws(servers, jspec):
    _, srv, jstate = servers
    x = _x(8, 3)[:32]  # one full bucket: the draws' shape is the request's
    s, key = 20, jax.random.PRNGKey(7)
    iw = jax.jit(jevaluation.svae_iw_loglik, static_argnums=(4, 5))
    want = iw(jstate.nn_params, jstate.pgm_nat, jnp.asarray(x), key, jspec.to_config(), s)
    k_cat, k_norm = jax.random.split(key)  # svax/models/evaluation.py:77-84's draws
    gumbel = jax.random.gumbel(k_cat, (s, 32, 4), dtype=jnp.float32)
    eps = jax.random.normal(k_norm, (s, 32, 4, 2), dtype=jnp.float32)
    with torch.inference_mode():
        got = srv._fns["score"](torch.tensor(x), torch.tensor(np.asarray(gumbel)),
                                torch.tensor(np.asarray(eps)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # The endpoint draws from torch.Generator(device).manual_seed(seed), in
    # svae_iw_loglik's order.
    port = evaluation.svae_iw_loglik(srv._nn, srv._nat, torch.tensor(x), s,
                                     generator=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(srv.score(x, seed=5, num_samples=s), port.numpy(), rtol=1e-5)
    assert not np.array_equal(srv.score(x, seed=6, num_samples=s), srv.score(x, seed=5,
                                                                              num_samples=s))


def test_generate_plugin_moments(servers):
    """With sample_params=False the mixture is the reference's plug-in
    (E[π], m_k, Φ_k / max(ν_k − d − 1, ½)): the draws' mean and covariance
    match its moments within Monte-Carlo error."""
    from svax.expfam import dirichlet as jdir
    from svax.expfam import niw as jniw

    _, srv, jstate = servers
    alpha = np.asarray(jdir.natural_to_standard(jstate.pgm_nat.dir_nat), np.float64)
    std = jax.tree.map(lambda a: np.asarray(a, np.float64),
                       jniw.natural_to_standard(jstate.pgm_nat.niw_nat))
    pi = alpha / alpha.sum()
    cov = std.phi / np.maximum(std.nu - 2 - 1.0, 0.5)[:, None, None]
    mean = pi @ std.m
    second = np.einsum("k,kij->ij", pi, cov + std.m[:, :, None] * std.m[:, None, :])
    want_cov = second - np.outer(mean, mean)
    n = 40000
    x, z, labels = srv.generate(n, seed=4)
    assert x.shape == (n, 2) and z.shape == (n, 2) and labels.shape == (n,)
    assert labels.min() >= 0 and labels.max() < 4
    se = np.sqrt(np.diag(want_cov) / n)
    np.testing.assert_allclose(z.mean(0), mean, atol=5 * se.max())
    np.testing.assert_allclose(np.cov(z.T), want_cov, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(np.bincount(labels, minlength=4) / n, pi, atol=0.01)
    # x is the decoder's mean at z.
    dec = srv._nn["decoder"]
    from svax_torch.nets import mlp

    np.testing.assert_allclose(x[:50], mlp.decoder_apply(dec, torch.tensor(z[:50]))[0].numpy(),
                               rtol=1e-6)
    xs, zs, ls = srv.generate(12, seed=4, sample_params=True)
    assert np.all(np.isfinite(xs)) and np.all(np.isfinite(zs)) and ls.shape == (12,)


def test_padding_is_invisible(servers):
    _, srv, _ = servers
    x = _x(8, 2)  # 40 rows > the top bucket of 32
    full = srv.encode(x)
    for part in (x[:5], torch.tensor(x[:5]), x[33:38]):
        small = srv.encode(part)
        lo = 33 if part is not None and np.array_equal(np.asarray(part), x[33:38]) else 0
        np.testing.assert_allclose(small["z_mean"], full["z_mean"][lo:lo + 5], rtol=1e-5)
        np.testing.assert_array_equal(small["component"], full["component"][lo:lo + 5])
    one = srv.encode(x[3])  # a 1-D request is one row
    np.testing.assert_allclose(one["z_mean"], full["z_mean"][3:4], rtol=1e-5)


def test_smm_server(tmp_path_factory):
    jspec = jserve.ModelSpec(input_dim=2, latent_dim=2, num_components=3,
                             likelihood="gaussian", encoder_hidden=(8,), decoder_hidden=(8,),
                             dof=4.0, num_total=100)
    # The initial weights: both servers see the same ones, and the JAX SMM
    # step's compile would dominate the test.
    jsrv, srv, _ = _pair(tmp_path_factory, jspec, steps=0, seed=1, buckets=(16,))
    x = _x(4, 1)[:6]
    got, want = srv.encode(x), jsrv.encode(x)
    np.testing.assert_allclose(got["z_mean"], want["z_mean"], **TOL)
    np.testing.assert_array_equal(got["component"], want["component"])
    assert np.all(np.isfinite(srv.score(x, num_samples=10)))
    path = tmp_path_factory.mktemp("smm_exp")
    serve.export_serving(srv, path, score_samples=10, impute_iters=1)
    aot = serve.load_exported(path)
    np.testing.assert_array_equal(aot.encode(x)["z_mean"], got["z_mean"])
    np.testing.assert_array_equal(aot.score(x, seed=2), srv.score(x, seed=2, num_samples=10))


def test_missing_state_raises(tmp_path, jspec):
    path = tmp_path / "empty"
    path.mkdir()
    (path / "spec.json").write_text(json.dumps(serve.spec_payload(serve.ModelSpec(
        **dataclasses.asdict(jspec)))))
    with pytest.raises(FileNotFoundError):
        serve.load_bundle(path, device="cpu")


@pytest.mark.parametrize("field,value", [("encoder_head", "block"), ("activation", "gelu")])
def test_unsupported_bundle_is_refused(tmp_path, servers, field, value):
    """A head or an activation the nets do not know (the full head, relu
    and softplus serve: tests/test_torch_full_head.py)."""
    _, srv, jstate = servers
    spec = dataclasses.replace(srv.spec, **{field: value})
    path = tmp_path / "b"
    serve.save_bundle(path, convert.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                                     dtype=torch.float32), srv.spec)
    (path / "spec.json").write_text(json.dumps(serve.spec_payload(spec)))
    with pytest.raises(ValueError, match="one of"):
        serve.load_bundle(path, device="cpu")


def test_cuda_request_without_a_card_raises(tmp_path, servers, exported):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.load_bundle(tmp_path, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.load_exported(exported[1], device="cuda")


def test_spec_json_matches_reference(tmp_path, servers, jspec):
    _, srv, jstate = servers
    jserve.save_bundle(tmp_path / "j", jstate, jspec)
    serve.save_bundle(tmp_path / "p", convert.state_from_numpy(
        jax.tree.map(np.asarray, jstate), dtype=torch.float32), srv.spec)
    want = json.loads((tmp_path / "j" / "spec.json").read_text())
    got = json.loads((tmp_path / "p" / "spec.json").read_text())
    assert got == want and list(got) == list(want)


# ----------------------------------------------------------- exported tier


def test_exported_matches_live_server(servers, exported):
    _, srv, _ = servers
    aot, _ = exported
    x = _x(8, 6)
    live = srv.encode(x)
    got = aot.encode(x)
    np.testing.assert_array_equal(got["z_mean"], live["z_mean"])
    np.testing.assert_array_equal(got["responsibilities"], live["responsibilities"])
    np.testing.assert_array_equal(got["component"], live["component"])
    np.testing.assert_array_equal(aot.reconstruct(x), srv.reconstruct(x))
    # score: one seed, the same draws, the same bits.
    np.testing.assert_array_equal(aot.score(x, seed=7), srv.score(x, seed=7, num_samples=20))
    mask = np.ones_like(x)
    mask[::2, 0] = 0.0
    np.testing.assert_array_equal(aot.impute(x, mask),
                                  srv.impute(x, mask, num_iters=aot.impute_iters))


def test_exported_impute_map_mode(servers, tmp_path):
    _, srv, _ = servers
    serve.export_serving(srv, tmp_path / "map", buckets=(8,), score_samples=5,
                         impute_iters=6, impute_mode="map")
    aot = serve.load_exported(tmp_path / "map")
    assert aot.impute_mode == "map" and aot.impute_iters == 6
    x = _x(5, 4)
    mask = np.ones_like(x)
    mask[:, 0] = 0.0
    np.testing.assert_array_equal(aot.impute(x, mask),
                                  srv.impute(x, mask, num_iters=6, mode="map"))
    with pytest.raises(ValueError, match="impute_mode"):
        serve.export_serving(srv, tmp_path / "bad", impute_mode="argmax")


def test_exported_bucket_contract(exported):
    aot, _ = exported
    x = _x(8, 8)  # 40 rows > the top bucket of 32
    full = aot.encode(x)
    small = aot.encode(x[:5])
    np.testing.assert_allclose(small["z_mean"], full["z_mean"][:5], rtol=1e-5, atol=1e-6)
    assert aot.cluster(x).shape == (40,)
    assert aot.score(x[:3], seed=1).shape == (3,)


_CHILD = """
import importlib.abc, sys

BLOCKED = ("svax_torch.models", "svax_torch.nets", "svax_torch.pgm", "svax_torch.train",
           "svax_torch.ops", "svax_torch.expfam", "jax")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "svax" or name.startswith("svax.") or name.startswith(BLOCKED):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Block())
import numpy as np
from svax_torch import serve

srv = serve.load_exported(sys.argv[1])
x = np.load(sys.argv[2])
np.save(sys.argv[3], srv.encode(x)["z_mean"])
np.save(sys.argv[4], srv.score(x, seed=1))
try:
    import svax_torch.models
except ImportError:
    print("MODELS BLOCKED")
print(sorted(m for m in sys.modules if m.startswith("svax")))
"""


def test_exported_is_self_contained(servers, exported, tmp_path):
    """The artifact directory alone serves, in a process whose import of
    the model modules raises."""
    _, srv, _ = servers
    path = exported[1]
    names = sorted(os.listdir(path))
    assert "exports.json" in names and len(names) == 9
    assert all(n.endswith(".pt2") or n == "exports.json" for n in names)
    x = _x(2, 9)
    np.save(tmp_path / "x.npy", x)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", _CHILD, str(path), str(tmp_path / "x.npy"),
                          str(tmp_path / "z.npy"), str(tmp_path / "s.npy")],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "MODELS BLOCKED" in out.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "z.npy"), srv.encode(x)["z_mean"])
    np.testing.assert_array_equal(np.load(tmp_path / "s.npy"),
                                  srv.score(x, seed=1, num_samples=20))
