"""The flexstep CUDA kernel on the card: against its plain version at
d ∈ {2, 3, 4, 6} and several hidden widths, bit-equal reruns with
in-kernel noise, and the wrapper raising (not falling back) outside its
shape class.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_flexstep.py -m requires_cuda --noconftest
"""

import numpy as np
import pytest
import torch

from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import flexstep
from svax_torch.pgm import gmm
from svax_torch.train import svae_step

torch.set_num_threads(1)
pytestmark = pytest.mark.requires_cuda

# tests/test_flexstep_kernel.py's float32 bars: (rtol, atol).
TOL = {"params": (5e-4, 5e-5), "mu": (5e-4, 1e-5), "nat": (5e-4, 5e-4)}
MET_TOL = {"recon": 2e-3, "local_kl": 2e-3, "neg_loss": 1e-4, "rho": 1e-6}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(dev, *, n=120, m=32, d_in=8, d=4, k=5, s=2, hidden=(16, 16), t=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    config = SvaeConfig(latent_dim=d, num_components=k, num_samples=s, num_total=n)
    prior = gmm.make_prior(k, d, kappa=0.05)
    state = svae_step.init_state(gen, d_in, config, prior, hidden, hidden)
    x = torch.randn(n, d_in, generator=gen)
    rng = np.random.default_rng(seed + 1)
    batches = x[torch.tensor(rng.integers(0, n, (t, m)))].contiguous()
    eps = torch.tensor(rng.standard_normal((t, s, m, k, d)), dtype=torch.float32)
    return (svae_step.state_to(state, dev), svae_step.nat_to(prior, dev),
            batches.to(dev), eps.to(dev), n)


def _flat(tree):
    return [t for side in tree.values() for ly in side for t in ly.values()]


def _close(got, want, rtol, atol, what):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=rtol, atol=atol,
                                   err_msg=what)


@pytest.mark.parametrize("d,d_in,k,hidden", [
    (2, 2, 1, (16, 16)), (3, 5, 7, (24, 40)), (4, 8, 10, (100, 100)),
    (4, 8, 10, (128, 128)), (6, 8, 3, (16, 16)),
])
def test_kernel_matches_plain(dev, d, d_in, k, hidden):
    state, prior, batches, eps, n = _setup(dev, d=d, d_in=d_in, k=k, hidden=hidden)
    # The auto config's learning rate: Adam moves a parameter whose gradient
    # is ~0 by up to ~lr per step whatever the gradient's rounding, so
    # summation order shows in the parameters at the scale of lr.
    kw = dict(lr=1e-3, rho=0.2, rho_decay=1e-3, num_total=n, eps=eps)
    before = flexstep.launches
    st_k, m_k = flexstep.train_chunk(state, prior, batches, **kw)
    torch.cuda.synchronize()
    assert flexstep.launches == before + 1
    st_p, m_p = flexstep.train_chunk_plain(state, prior, batches, **kw)
    _close(_flat(st_k.nn_params), _flat(st_p.nn_params), *TOL["params"], "params")
    _close(_flat(st_k.opt_state.mu), _flat(st_p.opt_state.mu), *TOL["mu"], "adam m")
    _close([st_k.pgm_nat.dir_nat, *st_k.pgm_nat.niw_nat],
           [st_p.pgm_nat.dir_nat, *st_p.pgm_nat.niw_nat], *TOL["nat"], "naturals")
    for key, tol in MET_TOL.items():
        _close([m_k[key]], [m_p[key]], tol, tol, key)
    assert st_k.step == st_p.step == 3 and st_k.opt_state.count == 3


def test_in_kernel_noise_is_seeded_and_reruns_are_bit_equal(dev):
    state, prior, batches, _, n = _setup(dev, hidden=(100, 100), k=10, s=4, m=64)
    kw = dict(lr=1e-3, rho=0.2, rho_decay=1e-3, num_total=n, num_samples=4)
    a, ma = flexstep.train_chunk(state, prior, batches, seed=3, **kw)
    b, mb = flexstep.train_chunk(state, prior, batches, seed=3, **kw)
    c, _ = flexstep.train_chunk(state, prior, batches, seed=4, **kw)
    assert all(torch.equal(p, q) for p, q in zip(_flat(a.nn_params), _flat(b.nn_params)))
    assert torch.equal(ma["recon"], mb["recon"])
    assert not torch.equal(a.pgm_nat.dir_nat, c.pgm_nat.dir_nat)
    assert all(bool(torch.isfinite(t).all()) for t in _flat(a.nn_params))
    # The state's step is folded into the seed: the next chunk draws fresh noise.
    d, _ = flexstep.train_chunk(a, prior, batches, seed=3, **kw)
    e, _ = flexstep.train_chunk(a._replace(step=0), prior, batches, seed=3, **kw)
    assert not torch.equal(d.pgm_nat.dir_nat, e.pgm_nat.dir_nat)


def test_wrapper_raises_outside_the_shape_class(dev):
    state, prior, batches, _, n = _setup(dev)
    kw = dict(lr=1e-3, rho=0.1, num_total=n)
    before = flexstep.launches
    with pytest.raises(ValueError, match="float32"):
        flexstep.train_chunk(state, prior, batches.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        flexstep.train_chunk(state, prior, batches.transpose(0, 1), **kw)
    s7, p7, b7, _, _ = _setup(dev, d=7)
    with pytest.raises(ValueError, match="latent d = 7"):
        flexstep.train_chunk(s7, p7, b7, **kw)
    wide, pw, bw, _, _ = _setup(dev, hidden=(200, 200))
    with pytest.raises(ValueError, match="hidden widths"):
        flexstep.train_chunk(wide, pw, bw, **kw)
    assert flexstep.launches == before
