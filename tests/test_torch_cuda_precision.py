"""Slice J on the card: tinystep's and flexstep's bf16-product mode against
their plain versions at every shipped width, the row sum's mode as
``SvaeConfig.nn_precision`` selects it, and the full-head and sampled
per-step engine on ``cuda``.

The bars are chip_smoke.py phase M's (``BF16_TINY_TOL``, ``BF16_FLEX_TOL``,
stated there beside the f32 mode's). Every test needs a CUDA device and
skips without one. The file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_cuda_precision.py -m requires_cuda --noconftest
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svax_torch.data.pinwheel import make_pinwheel_data
from svax_torch.models import svae
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import decoder, flexstep, tinystep
from svax_torch.pgm import gmm
from svax_torch.train import loop, svae_step

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import BF16_FLEX_TOL, BF16_TINY_TOL  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flat(tree):
    return [t for side in tree.values() for ly in side for t in ly.values()]


def _close(got, want, tol, what):
    rtol, atol = tol
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=rtol, atol=atol,
                                   err_msg=what)


def _nat(nat):
    return [nat.dir_nat, *nat.niw_nat]


@pytest.mark.parametrize("hidden,smm", [((16, 16), {}), ((50, 50), {}),
                                        ((50, 50), dict(dof=4.0, smm_iters=2)),
                                        ((16, 16), dict(dof=2.5, smm_iters=1,
                                                        smm_envelope_grads=True))])
def test_tinystep_bf16_matches_plain(dev, hidden, smm):
    n, k, s, t = 120, 6, 2, 3
    x = torch.tensor(make_pinwheel_data(num_classes=3, num_per_class=n // 3, seed=0),
                     dtype=torch.float32)
    config = SvaeConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n)
    prior = gmm.make_prior(k, 2, kappa=0.05)
    state = svae_step.init_state(torch.Generator().manual_seed(0), 2, config, prior,
                                 hidden, hidden)
    state, prior, x = svae_step.state_to(state, dev), svae_step.nat_to(prior, dev), x.to(dev)
    rng = np.random.default_rng(1)
    eps = torch.tensor(rng.standard_normal((t, s, n, k, 2)), dtype=torch.float32, device=dev)
    aug = torch.tensor(rng.standard_normal((t, n, 2)), dtype=torch.float32, device=dev)
    kw = dict(lr=1e-3, rho=0.05, t_steps=t, aug_noise=0.4, eps=eps, aug_eps=aug,
              nn_precision="default", **smm)
    before = tinystep.launches_bf16
    a, ma = tinystep.train_chunk(state, prior, x, **kw)
    b, _ = tinystep.train_chunk(state, prior, x, **kw)
    assert tinystep.launches_bf16 == before + 2
    assert all(torch.equal(p, q) for p, q in zip(_flat(a.nn_params), _flat(b.nn_params)))
    p, mp = tinystep.train_chunk_plain(state, prior, x, **kw)
    _close(_flat(a.nn_params), _flat(p.nn_params), BF16_TINY_TOL["params"], "params")
    _close(_flat(a.opt_state.mu), _flat(p.opt_state.mu), BF16_TINY_TOL["adam m"], "adam m")
    _close(_flat(a.opt_state.nu), _flat(p.opt_state.nu), BF16_TINY_TOL["adam v"], "adam v")
    _close(_nat(a.pgm_nat), _nat(p.pgm_nat), BF16_TINY_TOL["naturals"], "naturals")
    for key in ("recon", "local_kl"):
        _close([ma[key]], [mp[key]], BF16_TINY_TOL[key], key)
    f32, _ = tinystep.train_chunk(state, prior, x, **{**kw, "nn_precision": "highest"})
    assert not torch.equal(f32.nn_params["decoder"][1]["w"], a.nn_params["decoder"][1]["w"])
    with pytest.raises(ValueError, match="cluster 16 only"):
        tinystep.train_chunk(state, prior, x, cluster=8, **kw)


@pytest.mark.parametrize("d,d_in,k,hidden", [(2, 2, 1, (16, 16)), (3, 5, 7, (24, 40)),
                                             (4, 8, 10, (100, 100)), (6, 8, 3, (16, 16))])
def test_flexstep_bf16_matches_plain(dev, d, d_in, k, hidden):
    n, m, s, t = 120, 32, 2, 3
    gen = torch.Generator().manual_seed(0)
    config = SvaeConfig(latent_dim=d, num_components=k, num_samples=s, num_total=n)
    prior = gmm.make_prior(k, d, kappa=0.05)
    state = svae_step.init_state(gen, d_in, config, prior, hidden, hidden)
    x = torch.randn(n, d_in, generator=gen)
    rng = np.random.default_rng(2)
    batches = x[torch.tensor(rng.integers(0, n, (t, m)))].contiguous().to(dev)
    eps = torch.tensor(rng.standard_normal((t, s, m, k, d)), dtype=torch.float32, device=dev)
    state, prior = svae_step.state_to(state, dev), svae_step.nat_to(prior, dev)
    kw = dict(lr=1e-3, rho=0.2, rho_decay=1e-3, num_total=n, eps=eps, nn_precision="default")
    before = flexstep.launches_bf16
    a, ma = flexstep.train_chunk(state, prior, batches, **kw)
    b, _ = flexstep.train_chunk(state, prior, batches, **kw)
    assert flexstep.launches_bf16 == before + 2
    assert all(torch.equal(p, q) for p, q in zip(_flat(a.nn_params), _flat(b.nn_params)))
    p, mp = flexstep.train_chunk_plain(state, prior, batches, **kw)
    _close(_flat(a.nn_params), _flat(p.nn_params), BF16_FLEX_TOL["params"], "params")
    _close(_flat(a.opt_state.mu), _flat(p.opt_state.mu), BF16_FLEX_TOL["adam m"], "adam m")
    _close(_nat(a.pgm_nat), _nat(p.pgm_nat), BF16_FLEX_TOL["naturals"], "naturals")
    for key in ("recon", "local_kl", "neg_loss", "rho"):
        _close([ma[key]], [mp[key]], BF16_FLEX_TOL[key], key)


@pytest.mark.parametrize("precision,bf16", [("highest", False), ("high", True),
                                            ("default", True)])
def test_row_sum_mode_follows_nn_precision(dev, precision, bf16):
    """``SvaeConfig(fused_decoder=True, nn_precision=...)`` launches the row
    sum in the mode ``_kernel_precision`` maps it to."""
    config = SvaeConfig(latent_dim=3, num_components=4, num_samples=1, num_total=64,
                        likelihood="bernoulli", fused_decoder=True, nn_precision=precision)
    prior = gmm.make_prior(4, 3, kappa=0.05, device=dev)
    state = svae_step.init_state(torch.Generator(device=dev).manual_seed(0), 20, config,
                                 prior, (32, 32), (32, 32))
    x = (torch.rand(64, 20, generator=torch.Generator().manual_seed(1)) < 0.4).float().to(dev)
    eps = torch.randn(1, 64, 4, 3, generator=torch.Generator().manual_seed(2)).to(dev)
    before = (decoder.launches, decoder.bf16_launches)
    out = svae.forward(state.nn_params, state.pgm_nat, prior, x, config, eps=eps)
    assert decoder.launches == before[0] + 1
    assert decoder.bf16_launches == before[1] + int(bf16)
    assert bool(torch.isfinite(out.elbo))


@pytest.mark.parametrize("switches", [dict(encoder_head="full"), dict(recon_mode="sampled"),
                                      dict(encoder_head="full", recon_mode="sampled",
                                           remat_combine=True, activation="relu")])
def test_per_step_engine_runs_the_switches_on_cuda(dev, switches):
    n = 96
    x = torch.tensor(make_pinwheel_data(num_classes=3, num_per_class=n // 3, seed=0),
                     dtype=torch.float32, device=dev)
    config = SvaeConfig(latent_dim=2, num_components=5, num_samples=2, num_total=n,
                        nn_precision="default", **switches)
    prior = gmm.make_prior(5, 2, kappa=0.05, device=dev)
    state = svae_step.init_state(torch.Generator(device=dev).manual_seed(0), 2, config,
                                 prior, (16, 16), (16, 16), data=x)
    gate = dict(batch_full=True, encoder_hidden=(16, 16), decoder_hidden=(16, 16), rho=0.1)
    assert loop.choose_kernel(config, engine="auto", **gate) == loop.PER_STEP
    runner = loop.make_step_runner(config, prior, lr=1e-3, rho=0.1, aug_noise=0.1)
    a, ma = runner(state, x, 5, seed=3)
    b, _ = runner(state, x, 5, seed=3)
    assert bool(torch.isfinite(ma["elbo"]).all())
    assert all(torch.equal(p, q) for p, q in zip(_flat(a.nn_params), _flat(b.nn_params)))
