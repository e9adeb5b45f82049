"""The mixstep and estep CUDA kernels on the card: against their plain
versions, at a ragged N, the gates, the launch counters and bit-equal
reruns.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_mixture.py -m requires_cuda --noconftest
"""

import numpy as np
import pytest
import torch

from svax_torch.data.pinwheel import make_pinwheel_data
from svax_torch.models.gmm_baseline import GmmTrainState
from svax_torch.models.smm_baseline import SmmTrainState
from svax_torch.ops import estep, mixstep
from svax_torch.pgm import gmm
from svax_torch.pgm.init import init_variational_kmeanspp

torch.set_num_threads(1)
pytestmark = pytest.mark.requires_cuda

# tests/test_mixstep_kernel.py's float32 bars.
NAT_TOL = dict(rtol=3e-4, atol=3e-4)
EVID_TOL = dict(rtol=2e-4, atol=2e-3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(dev, n=130, k=10, seed=0, cls=GmmTrainState):
    x = make_pinwheel_data(num_classes=5, num_per_class=-(-n // 5), seed=seed)[:n]
    prior = gmm.make_prior(k, 2, kappa=0.05)
    nat = init_variational_kmeanspp(prior, x, seed=seed)
    to = lambda t: t.to(dev)  # noqa: E731
    nat = gmm.GmmNat(to(nat.dir_nat), type(nat.niw_nat)(*map(to, nat.niw_nat)))
    prior = gmm.GmmNat(to(prior.dir_nat), type(prior.niw_nat)(*map(to, prior.niw_nat)))
    return cls(nat=nat, step=0), prior, torch.tensor(x, dtype=torch.float32, device=dev)


def _leaves(nat):
    return [nat.dir_nat, *nat.niw_nat]


@pytest.mark.parametrize("dof,n,num_total", [(0.0, 130, None), (4.0, 130, None),
                                             (0.0, 400, 800), (4.0, 37, None)])
def test_mixstep_matches_plain(dev, dof, n, num_total):
    cls = SmmTrainState if dof else GmmTrainState
    state, prior, x = _setup(dev, n=n, cls=cls)
    kw = dict(rho=0.3, t_steps=6, dof=dof, num_total=num_total)
    before = mixstep.launches
    st_k, m_k = mixstep.train_chunk(state, prior, x, **kw)
    assert mixstep.launches == before + 1
    st_p, m_p = mixstep.train_chunk_plain(state, prior, x, **kw)
    for a, b in zip(_leaves(st_k.nat), _leaves(st_p.nat)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **NAT_TOL)
    np.testing.assert_allclose(m_k["local_evidence"].cpu().numpy(),
                               m_p["local_evidence"].cpu().numpy(), **EVID_TOL)
    assert st_k.step == 6 and type(st_k) is cls


@pytest.mark.parametrize("dof", [0.0, 4.0])
def test_mixstep_reruns_chunk_splits_and_unrolls(dev, dof):
    state, prior, x = _setup(dev, n=400)
    kw = dict(rho=0.3, dof=dof)
    a, ma = mixstep.train_chunk(state, prior, x, t_steps=8, **kw)
    b, mb = mixstep.train_chunk(state, prior, x, t_steps=8, **kw)
    h, m1 = mixstep.train_chunk(state, prior, x, t_steps=4, **kw)
    h, m2 = mixstep.train_chunk(h, prior, x, t_steps=4, **kw)
    for p, q, r in zip(_leaves(a.nat), _leaves(b.nat), _leaves(h.nat)):
        assert torch.equal(p, q) and torch.equal(p, r)
    assert torch.equal(ma["local_evidence"], mb["local_evidence"])
    assert torch.equal(ma["local_evidence"], torch.cat([m1["local_evidence"],
                                                        m2["local_evidence"]]))
    for unroll in (2, 4, 8):
        u, mu = mixstep.train_chunk(state, prior, x, t_steps=8, unroll=unroll, **kw)
        for p, q in zip(_leaves(a.nat), _leaves(u.nat)):
            np.testing.assert_allclose(p.cpu().numpy(), q.cpu().numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_mixstep_rejections(dev):
    state, prior, x = _setup(dev)
    kw = dict(rho=0.3, t_steps=4)
    with pytest.raises(ValueError, match="float32"):
        mixstep.train_chunk(state, prior, x.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        mixstep.train_chunk(state, prior, torch.cat([x, x], 1)[:, ::2], **kw)
    with pytest.raises(ValueError, match="2-D data"):
        mixstep.train_chunk(state, prior, torch.cat([x, x], 1), **kw)
    with pytest.raises(ValueError, match="does not divide"):
        mixstep.train_chunk(state, prior, x, unroll=8, **kw)
    big = torch.zeros((mixstep.MAX_POINTS + 1, 2), device=dev)
    with pytest.raises(ValueError, match="outside the kernel"):
        mixstep.train_chunk(state, prior, big, **kw)


def _estep_inputs(dev, n, k, d, seed=0):
    """Seeded numpy data and a prior-plus-pseudo-points q, as
    benchmarks/bench_estep.py makes them."""
    x = np.random.default_rng(seed).standard_normal((n, d))
    xt = torch.tensor(x, dtype=torch.float32, device=dev)
    prior = gmm.make_prior(k, d, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return xt, gmm.expected_params(gmm.init_variational(gen, prior, xt))


@pytest.mark.parametrize("n,k,d", [(400, 10, 2), (1000, 7, 3), (4097, 128, 10)])
def test_estep_matches_plain(dev, n, k, d):
    x, exp = _estep_inputs(dev, n, k, d)
    before = estep.launches
    stats, ev = estep.e_step_stats_fused(x, exp, scale=2.0)
    assert estep.launches == before + 1
    ref, ref_ev = estep.e_step_stats_reference(x, exp, scale=2.0)
    for got, want in zip(stats, ref):
        err = float((got - want).abs().max() / (want.abs().max() + 1e-30))
        assert err < 5e-5, err
    assert float((ev - ref_ev).abs().max()) < 1e-3
    again, ev2 = estep.e_step_stats_fused(x, exp, scale=2.0)
    assert all(torch.equal(p, q) for p, q in zip(stats, again))
    assert torch.equal(ev, ev2)


def test_estep_rejections(dev):
    x, exp = _estep_inputs(dev, 64, 4, 2)
    with pytest.raises(ValueError, match="float32"):
        estep.e_step_stats_fused(x.double(), exp)
    wide_x, wide = _estep_inputs(dev, 64, 4, estep.MAX_DIM + 1)
    with pytest.raises(ValueError, match="d = 11"):
        estep.e_step_stats_fused(wide_x, wide)
    _, many = _estep_inputs(dev, 200, estep.MAX_COMPONENTS + 1, 2)
    with pytest.raises(ValueError, match="K = 129"):
        estep.e_step_stats_fused(x, many)
