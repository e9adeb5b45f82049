"""The tinystep CUDA kernel on the card: against its plain version (GMM
prior, and the SMM prior in both gradient modes) at each cluster size,
including ragged and empty parts of the cluster, seeded in-kernel noise,
bit-equal reruns, the Philox normals and the wrapper's checks.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m requires_cuda --noconftest
"""

import ctypes

import numpy as np
import pytest
import torch

from svax_torch.data.pinwheel import make_pinwheel_data
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import tinystep
from svax_torch.pgm import gmm
from svax_torch.train import svae_step

torch.set_num_threads(1)
pytestmark = pytest.mark.requires_cuda

# tests/test_tinystep_kernel.py's float32 bars: (rtol, atol).
TOL = {"params": (5e-4, 5e-5), "mu": (5e-4, 5e-6), "nu": (5e-4, 1e-8),
       "nat": (2e-5, 2e-5)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(dev, n=72, k=4, hidden=(16, 16), seed=0):
    x = make_pinwheel_data(num_classes=3, num_per_class=-(-n // 3), seed=seed)[:n]
    config = SvaeConfig(latent_dim=2, num_components=k, num_samples=2, num_total=n)
    prior = gmm.make_prior(k, 2, kappa=0.05)
    state = svae_step.init_state(torch.Generator().manual_seed(seed), 2, config,
                                 prior, hidden, hidden)
    return (svae_step.state_to(state, dev), svae_step.nat_to(prior, dev),
            torch.tensor(x, dtype=torch.float32, device=dev))


def _flat(tree):
    return [t for side in tree.values() for ly in side for t in ly.values()]


def _close(got, want, rtol, atol, what):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=rtol,
                                   atol=atol, err_msg=what)


@pytest.mark.parametrize("t_steps", [1, 3])
def test_kernel_matches_plain(dev, t_steps):
    state, prior, x = _setup(dev)
    rng = np.random.default_rng(100)
    kw = dict(lr=3e-3, rho=0.2, t_steps=t_steps, aug_noise=0.4,
              eps=torch.tensor(rng.standard_normal((t_steps, 2, 72, 4, 2)),
                               dtype=torch.float32, device=dev),
              aug_eps=torch.tensor(rng.standard_normal((t_steps, 72, 2)),
                                   dtype=torch.float32, device=dev))
    before = tinystep.launches
    st_k, m_k = tinystep.train_chunk(state, prior, x, **kw)
    assert tinystep.launches == before + 1
    st_p, m_p = tinystep.train_chunk_plain(state, prior, x, **kw)
    _close(_flat(st_k.nn_params), _flat(st_p.nn_params), *TOL["params"], "params")
    _close(_flat(st_k.opt_state.mu), _flat(st_p.opt_state.mu), *TOL["mu"], "adam m")
    _close(_flat(st_k.opt_state.nu), _flat(st_p.opt_state.nu), *TOL["nu"], "adam v")
    _close([st_k.pgm_nat.dir_nat, *st_k.pgm_nat.niw_nat],
           [st_p.pgm_nat.dir_nat, *st_p.pgm_nat.niw_nat], *TOL["nat"], "naturals")
    _close([m_k["recon"]], [m_p["recon"]], 2e-4, 0.0, "recon")
    _close([m_k["local_kl"]], [m_p["local_kl"]], 2e-4, 2e-4, "local_kl")
    assert st_k.step == st_p.step == t_steps
    assert st_k.opt_state.count == t_steps


@pytest.mark.parametrize("smm", [
    dict(dof=4.0, smm_iters=2, smm_envelope_grads=False),
    dict(dof=4.0, smm_iters=2, smm_envelope_grads=True),
    dict(dof=2.5, smm_iters=1, smm_envelope_grads=False),
    dict(dof=4.0, smm_iters=6, smm_envelope_grads=False),
], ids=["full_chain", "envelope", "dof2.5_one_round", "six_rounds"])
@pytest.mark.parametrize("t_steps", [1, 3])
def test_smm_kernel_matches_plain(dev, t_steps, smm):
    """The SMM branch (u–z rounds, Student-t local term, ū-weighted
    statistics, the hand-derived backward) against train_chunk_plain."""
    state, prior, x = _setup(dev)
    rng = np.random.default_rng(101)
    kw = dict(lr=3e-3, rho=0.2, t_steps=t_steps, aug_noise=0.4,
              eps=torch.tensor(rng.standard_normal((t_steps, 2, 72, 4, 2)),
                               dtype=torch.float32, device=dev),
              aug_eps=torch.tensor(rng.standard_normal((t_steps, 72, 2)),
                                   dtype=torch.float32, device=dev), **smm)
    before = tinystep.launches
    st_k, m_k = tinystep.train_chunk(state, prior, x, **kw)
    assert tinystep.launches == before + 1
    st_p, m_p = tinystep.train_chunk_plain(state, prior, x, **kw)
    _close(_flat(st_k.nn_params), _flat(st_p.nn_params), *TOL["params"], "params")
    _close(_flat(st_k.opt_state.mu), _flat(st_p.opt_state.mu), *TOL["mu"], "adam m")
    _close(_flat(st_k.opt_state.nu), _flat(st_p.opt_state.nu), *TOL["nu"], "adam v")
    _close([st_k.pgm_nat.dir_nat, *st_k.pgm_nat.niw_nat],
           [st_p.pgm_nat.dir_nat, *st_p.pgm_nat.niw_nat], *TOL["nat"], "naturals")
    _close([m_k["recon"]], [m_p["recon"]], 2e-4, 0.0, "recon")
    _close([m_k["local_kl"]], [m_p["local_kl"]], 2e-4, 2e-4, "local_kl")


def test_smm_kernel_reruns_bit_equal_and_differ_from_gmm(dev):
    state, prior, x = _setup(dev)
    kw = dict(lr=3e-3, rho=0.2, t_steps=3, aug_noise=0.4, seed=5)
    a, ma = tinystep.train_chunk(state, prior, x, dof=4.0, **kw)
    b, mb = tinystep.train_chunk(state, prior, x, dof=4.0, **kw)
    g, mg = tinystep.train_chunk(state, prior, x, **kw)
    assert all(torch.equal(p, q) for p, q in zip(_flat(a.nn_params), _flat(b.nn_params)))
    assert torch.equal(a.pgm_nat.niw_nat.eta2, b.pgm_nat.niw_nat.eta2)
    assert torch.equal(ma["local_kl"], mb["local_kl"])
    assert not torch.equal(a.pgm_nat.niw_nat.eta2, g.pgm_nat.niw_nat.eta2)


def test_in_kernel_noise_is_seeded(dev):
    state, prior, x = _setup(dev)
    kw = dict(lr=3e-3, rho=0.2, t_steps=2, aug_noise=0.4)
    a, _ = tinystep.train_chunk(state, prior, x, seed=3, **kw)
    b, _ = tinystep.train_chunk(state, prior, x, seed=3, **kw)
    c, _ = tinystep.train_chunk(state, prior, x, seed=4, **kw)
    assert all(torch.equal(p, q) for p, q in zip(_flat(a.nn_params), _flat(b.nn_params)))
    assert not torch.equal(a.pgm_nat.dir_nat, c.pgm_nat.dir_nat)
    # The state's step is folded into the seed: the next chunk from a
    # draws fresh noise, not a replay of the first chunk's.
    d, _ = tinystep.train_chunk(a, prior, x, seed=3, **kw)
    e, _ = tinystep.train_chunk(a._replace(step=0), prior, x, seed=3, **kw)
    assert not torch.equal(d.pgm_nat.dir_nat, e.pgm_nat.dir_nat)


def test_philox_normals(dev):
    from svax_torch.ops import _build

    lib = _build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def draws(seed, base):
        out = torch.empty(1 << 20, device=dev)
        _build.check(lib, lib.philox_normals(seed, base, ctypes.c_void_p(out.data_ptr()),
                                             out.numel(), stream), "philox_normals")
        torch.cuda.synchronize()
        return out.double()

    a = draws(7, 0)
    assert abs(float(a.mean())) < 0.005 and abs(float(a.var()) - 1.0) < 0.01
    assert float(a.abs().max()) < 7.0  # u1 strictly inside (0, 1)
    assert torch.equal(a, draws(7, 0))
    assert not torch.equal(a, draws(8, 0))
    assert not torch.equal(a, draws(7, 1))


def _noise(dev, t, s, n, k, seed):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal((t, s, n, k, 2)), dtype=torch.float32, device=dev),
            torch.tensor(rng.standard_normal((t, n, 2)), dtype=torch.float32, device=dev))


def _assert_matches_plain(st_k, m_k, st_p, m_p):
    _close(_flat(st_k.nn_params), _flat(st_p.nn_params), *TOL["params"], "params")
    _close(_flat(st_k.opt_state.mu), _flat(st_p.opt_state.mu), *TOL["mu"], "adam m")
    _close(_flat(st_k.opt_state.nu), _flat(st_p.opt_state.nu), *TOL["nu"], "adam v")
    _close([st_k.pgm_nat.dir_nat, *st_k.pgm_nat.niw_nat],
           [st_p.pgm_nat.dir_nat, *st_p.pgm_nat.niw_nat], *TOL["nat"], "naturals")
    _close([m_k["recon"]], [m_p["recon"]], 2e-4, 0.0, "recon")
    _close([m_k["local_kl"]], [m_p["local_kl"]], 2e-4, 2e-4, "local_kl")


@pytest.mark.parametrize("case", [
    dict(n=37, k=4, t=3), dict(n=5, k=3, t=3), dict(n=72, k=1, t=3), dict(n=37, k=4, t=1),
    dict(n=37, k=4, t=3, smm=dict(dof=4.0, smm_iters=2)),
    dict(n=5, k=3, t=2, smm=dict(dof=4.0, smm_iters=2, smm_envelope_grads=True)),
    dict(n=40, k=3, t=2, hidden=(50, 50)),
], ids=["ragged_n37", "n5_empty_ctas", "k1", "t1", "smm_n37", "smm_envelope_n5", "50-50"])
@pytest.mark.parametrize("cluster", tinystep.CLUSTER_SIZES)
def test_cluster_kernel_matches_plain(dev, cluster, case):
    """Each cluster size against the plain version where N does not divide
    by C, where some CTAs own no point (N < C), at K = 1 and T = 1."""
    n, k, t = case["n"], case["k"], case["t"]
    state, prior, x = _setup(dev, n=n, k=k, hidden=case.get("hidden", (16, 16)))
    eps, aug_eps = _noise(dev, t, 2, n, k, 102)
    kw = dict(lr=3e-3, rho=0.2, t_steps=t, aug_noise=0.4, eps=eps, aug_eps=aug_eps,
              **case.get("smm", {}))
    st_k, m_k = tinystep.train_chunk(state, prior, x, cluster=cluster, **kw)
    torch.cuda.synchronize()
    st_p, m_p = tinystep.train_chunk_plain(state, prior, x, **kw)
    _assert_matches_plain(st_k, m_k, st_p, m_p)


@pytest.mark.parametrize("dof", [0.0, 4.0])
@pytest.mark.parametrize("cluster", tinystep.CLUSTER_SIZES)
def test_cluster_reruns_are_bit_equal(dev, cluster, dof):
    state, prior, x = _setup(dev, n=37)
    kw = dict(lr=3e-3, rho=0.2, t_steps=3, aug_noise=0.4, seed=9, dof=dof, cluster=cluster)
    a, ma = tinystep.train_chunk(state, prior, x, **kw)
    b, mb = tinystep.train_chunk(state, prior, x, **kw)
    assert all(torch.equal(p, q) for p, q in zip(_flat(a.nn_params), _flat(b.nn_params)))
    assert all(torch.equal(p, q) for p, q in zip(_flat(a.opt_state.nu), _flat(b.opt_state.nu)))
    assert torch.equal(a.pgm_nat.niw_nat.eta3, b.pgm_nat.niw_nat.eta3)
    assert torch.equal(ma["neg_loss"], mb["neg_loss"])


def test_cluster_sizes_agree(dev):
    """C = 8 and C = 16 add the same terms in other groupings: within the
    kernel-vs-plain bars of each other."""
    state, prior, x = _setup(dev, n=72, k=4)
    eps, aug_eps = _noise(dev, 3, 2, 72, 4, 103)
    kw = dict(lr=3e-3, rho=0.2, t_steps=3, aug_noise=0.4, eps=eps, aug_eps=aug_eps)
    a, ma = tinystep.train_chunk(state, prior, x, cluster=8, **kw)
    b, mb = tinystep.train_chunk(state, prior, x, cluster=16, **kw)
    _assert_matches_plain(a, ma, b, mb)


@pytest.mark.parametrize("hidden", tinystep.SUPPORTED_HIDDEN)
@pytest.mark.parametrize("cluster", tinystep.CLUSTER_SIZES)
def test_smem_bytes_match_the_c_entry(dev, cluster, hidden):
    from svax_torch.ops import _build

    lib = _build.load()
    for k in (1, 10, tinystep.MAX_COMPONENTS):
        assert lib.tinystep_smem_bytes(*hidden, k, cluster, 0) == tinystep.smem_bytes(
            *hidden, k, cluster)
        assert lib.tinystep_smem_bytes(*hidden, k, cluster, 1) == tinystep.smem_bytes(
            *hidden, k, cluster, bf16=True)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    state, prior, x = _setup(dev)
    kw = dict(lr=1e-3, rho=0.1, t_steps=1)
    with pytest.raises(ValueError, match="float32"):
        tinystep.train_chunk(state, prior, x.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tinystep.train_chunk(state, prior, torch.cat([x, x], 1)[:, ::2], **kw)
    odd, _, _ = _setup(dev, hidden=(20, 12))
    with pytest.raises(ValueError, match="hidden widths"):
        tinystep.train_chunk(odd, prior, x, **kw)
    with pytest.raises(ValueError, match="cluster 4"):
        tinystep.train_chunk(state, prior, x, cluster=4, **kw)
