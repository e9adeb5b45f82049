"""The training harness and the serving layer on the card: resume bit for
bit through each kernel engine at its config's width, the ``cuda`` server
against the ``cpu`` server on one bundle, and a ``cuda`` export against
the live server (and moved to the CPU at load).

Every test needs a CUDA device and skips without one; ``load_bundle`` and
``load_exported`` raising without one is held by tests/test_torch_serve.py
on the CPU. The file imports no JAX:

    python -m pytest tests/test_torch_cuda_harness.py -m requires_cuda --noconftest
"""

import numpy as np
import pytest
import torch

from svax_torch import serve
from svax_torch.data import load_dataset
from svax_torch.data.pinwheel import load_pinwheel
from svax_torch.models.gmm_baseline import GmmTrainState
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import combine, decoder_mlp, flexstep, mixstep, tinystep
from svax_torch.pgm import gmm
from svax_torch.pgm.init import init_variational_kmeanspp
from svax_torch.train.trainer import GmmTrainer, SvaeTrainer, TrainerConfig
from svax_torch.utils.tree import flatten

pytestmark = pytest.mark.requires_cuda
TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_serve.py's


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _f32(*arrays):
    """The loaders' float64 arrays as float32: the kernels take float32 only
    (the trainer keeps the data's dtype)."""
    return [a.astype(np.float32) for a in arrays]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for (_, x), (_, y) in zip(flatten(a), flatten(b)))


def _resumes(make, tmp_path, steps: int, cut: int, fit_kw=None):
    """make(steps, checkpoint_dir) → trainer: the whole fit against a fit
    cut at ``cut`` and resumed by a fresh trainer; returns the trainers."""
    fit_kw = fit_kw or {}
    whole = make(steps, str(tmp_path / "whole"))
    s_whole = whole.fit(**fit_kw)
    make(cut, str(tmp_path / "cut")).fit(**fit_kw)
    resumed = make(steps, str(tmp_path / "cut"))
    s_res = resumed.fit(**fit_kw)
    assert s_res.step == steps and _equal(s_whole, s_res)
    return whole, resumed


def test_resume_through_tinystep(dev, tmp_path):
    train, test = _f32(*load_pinwheel(seed=0))
    mc = SvaeConfig(latent_dim=2, num_components=10, num_samples=4, num_total=len(train))

    def make(steps, ck):
        return SvaeTrainer(mc, TrainerConfig(steps=steps, eval_every=100, engine="kernel",
                                             checkpoint_dir=ck), input_dim=2)

    before = tinystep.launches
    whole, _ = _resumes(make, tmp_path, 200, 100, dict(x_train=train, x_test=test))
    assert whole.kernel == "tinystep" and tinystep.launches - before == 4


def test_resume_through_flexstep(dev, tmp_path):
    train, test = _f32(*load_dataset("auto", seed=0)[:2])
    mc = SvaeConfig(latent_dim=4, num_components=10, num_samples=4, num_total=len(train))

    def make(steps, ck):
        tc = TrainerConfig(steps=steps, batch_size=64, rho=0.2, rho_decay=0.001,
                           eval_every=100, encoder_hidden=(100, 100),
                           decoder_hidden=(100, 100), engine="kernel", checkpoint_dir=ck)
        return SvaeTrainer(mc, tc, input_dim=train.shape[1])

    before = flexstep.launches
    whole, _ = _resumes(make, tmp_path, 200, 100, dict(x_train=train, x_test=test))
    assert whole.kernel == "flexstep" and flexstep.launches - before == 4


def test_resume_through_mixstep(dev, tmp_path):
    train, test = _f32(*load_pinwheel(seed=0))
    prior = gmm.make_prior(10, 2, kappa=0.05, device=dev)
    start = GmmTrainState(nat=init_variational_kmeanspp(prior, train, seed=0), step=0)

    def make(steps, ck):
        return GmmTrainer(TrainerConfig(steps=steps, eval_every=50, rho=1.0,
                                        engine="kernel", checkpoint_dir=ck), 10, 2,
                          prior=prior)

    before = mixstep.launches
    whole, _ = _resumes(make, tmp_path, 150, 100,
                        dict(x_train=train, x_test=test, state=start))
    assert whole.engine == "kernel" and mixstep.launches - before == 6


def _mnist_config(n: int) -> SvaeConfig:
    return SvaeConfig(latent_dim=8, num_components=10, num_samples=1, num_total=n,
                      likelihood="bernoulli", nn_compute_dtype="bfloat16",
                      fused_combine=True, kernel_rng=True, fused_mlp_decoder=True)


def _mnist_trainer(steps, ck, n, warmup=20):
    tc = TrainerConfig(steps=steps, batch_size=256, rho=0.1, rho_decay=0.001,
                       eval_every=20, encoder_hidden=(200, 200), decoder_hidden=(200, 200),
                       warmup_steps=warmup, checkpoint_dir=ck)
    return SvaeTrainer(_mnist_config(n), tc, input_dim=784)


def test_resume_through_the_step_engines_kernels(dev, tmp_path):
    """mnist-svae's width on the per-step engine: the combine and MLP-decoder
    kernels in every step; the resumed fit skips the warmup."""
    train, test = _f32(*load_dataset("mnist", seed=0)[:2])
    before = (combine.launches, decoder_mlp.launches)
    whole, resumed = _resumes(lambda s, ck: _mnist_trainer(s, ck, len(train)), tmp_path,
                              40, 20, dict(x_train=train, x_test=test))
    assert combine.launches > before[0] and decoder_mlp.launches > before[1]
    assert whole.warmup_info is not None and resumed.warmup_info is None


@pytest.fixture
def bundle(dev, tmp_path):
    train, test = _f32(*load_dataset("mnist", seed=0)[:2])
    trainer = _mnist_trainer(40, "", len(train))
    state = trainer.fit(train, test)
    spec = serve.ModelSpec(input_dim=784, latent_dim=8, num_components=10,
                           likelihood="bernoulli", encoder_hidden=(200, 200),
                           decoder_hidden=(200, 200), num_total=len(train))
    serve.save_bundle(tmp_path / "bundle", state, spec)
    return tmp_path / "bundle", test


def test_cuda_server_matches_cpu_server(bundle):
    path, x = bundle
    on_card = serve.load_bundle(path, device="cuda")
    on_host = serve.load_bundle(path, device="cpu")
    assert on_card.device.type == "cuda" and on_host.device.type == "cpu"
    got, want = on_card.encode(x), on_host.encode(x)
    np.testing.assert_allclose(got["z_mean"], want["z_mean"], **TOL)
    np.testing.assert_allclose(got["responsibilities"], want["responsibilities"], **TOL)
    top = -np.sort(-want["responsibilities"], axis=-1)
    tie = (top[:, 0] - top[:, 1]) < 2 * (TOL["rtol"] + TOL["atol"])
    assert not np.any((got["component"] != want["component"]) & ~tie)
    np.testing.assert_allclose(on_card.reconstruct(x), on_host.reconstruct(x), **TOL)
    mask = np.ones_like(x)
    mask[:, ::2] = 0.0
    filled = on_card.impute(x, mask, num_iters=3)
    np.testing.assert_array_equal(filled[:, 1::2], x[:, 1::2])
    assert np.all(np.isfinite(on_card.score(x[:100], num_samples=10)))


def test_cuda_export_matches_live_server(bundle, tmp_path):
    path, x = bundle
    live = serve.load_bundle(path, buckets=(32, 128), device="cuda")
    manifest = serve.export_serving(live, tmp_path / "exp", score_samples=10, impute_iters=3)
    assert manifest["device"].startswith("cuda")
    aot = serve.load_exported(tmp_path / "exp")
    assert aot.device.type == "cuda"
    q = x[:100]
    mask = np.ones_like(q)
    mask[:, 392:] = 0.0
    np.testing.assert_array_equal(aot.score(q, seed=4), live.score(q, seed=4, num_samples=10))
    np.testing.assert_allclose(aot.encode(q)["z_mean"], live.encode(q)["z_mean"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(aot.reconstruct(q), live.reconstruct(q), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aot.impute(q, mask), live.impute(q, mask, num_iters=3),
                               rtol=1e-6, atol=1e-6)
    # Moved to the CPU at load, on request: it agrees with the CPU server.
    on_host = serve.load_exported(tmp_path / "exp", device="cpu")
    host = serve.load_bundle(path, buckets=(32, 128), device="cpu")
    assert on_host.device.type == "cpu"
    np.testing.assert_allclose(on_host.encode(q)["z_mean"], host.encode(q)["z_mean"], **TOL)
