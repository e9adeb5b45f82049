"""The mixstep and estep CUDA kernels on the card: against their plain
versions, at a ragged N, mixstep at every unroll and both priors and at the
edges of its shape class, the gates, the launch counters and bit-equal
reruns.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_mixture.py -m requires_cuda --noconftest
"""

import json
import os
import subprocess
import sys
from pathlib import Path

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


@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
@pytest.mark.parametrize("dof", [0.0, 4.0])
def test_mixstep_every_unroll_matches_plain(dev, dof, unroll):
    """Each of U = 1, 2, 4, 8 for both priors at the pinwheel-gmm shape
    (N = 400, K = 10) against the plain version, reruns bit-equal."""
    cls = SmmTrainState if dof else GmmTrainState
    state, prior, x = _setup(dev, n=400, cls=cls)
    kw = dict(rho=0.3, t_steps=8, dof=dof, unroll=unroll)
    st_k, m_k = mixstep.train_chunk(state, prior, x, **kw)
    st_p, m_p = mixstep.train_chunk_plain(state, prior, x, **kw)
    for a, b in zip(_leaves(st_k.nat), _leaves(st_p.nat)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **NAT_TOL)
    np.testing.assert_allclose(m_k["local_evidence"].cpu().numpy(),
                               m_p["local_evidence"].cpu().numpy(), **EVID_TOL)
    again, m_again = mixstep.train_chunk(state, prior, x, **kw)
    assert all(torch.equal(p, q) for p, q in zip(_leaves(st_k.nat), _leaves(again.nat)))
    assert torch.equal(m_k["local_evidence"], m_again["local_evidence"])


@pytest.mark.parametrize("dof", [0.0, 4.0])
@pytest.mark.parametrize("n,k", [(1, 1), (31, 10), (513, 64), (16384, 10), (2000, 64)])
def test_mixstep_shape_class_edges_match_plain(dev, n, k, dof):
    """The shape class's edges (N = 1 … 16,384, K = 1 … 64: one or 32 point
    batches a thread, 1 to 16 groups of statistics) against the plain
    version."""
    cls = SmmTrainState if dof else GmmTrainState
    state, prior, x = _setup(dev, n=n, k=k, cls=cls)
    kw = dict(rho=0.3, t_steps=4, dof=dof)
    st_k, m_k = mixstep.train_chunk(state, prior, x, **kw)
    st_p, m_p = mixstep.train_chunk_plain(state, prior, x, **kw)
    for a, b in zip(_leaves(st_k.nat), _leaves(st_p.nat)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **NAT_TOL)
    np.testing.assert_allclose(m_k["local_evidence"].cpu().numpy(),
                               m_p["local_evidence"].cpu().numpy(), **EVID_TOL)


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
    benchmarks/bench_estep.py makes them (q from max(N, K) points, the
    first N of them the data)."""
    x = np.random.default_rng(seed).standard_normal((max(n, k), d))
    xt = torch.tensor(x, dtype=torch.float32, device=dev)
    prior = gmm.make_prior(k, d, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return xt[:n].contiguous(), gmm.expected_params(gmm.init_variational(gen, prior, xt))


# tests/test_torch_estep.py's shapes (each N, K and d at least once, every
# kernel instantiation), the pinwheel shape and the design shape.
ESTEP_SHAPES = [(1, 1, 1), (63, 10, 2), (65, 128, 3), (400, 10, 2), (4097, 128, 10),
                (400, 1, 10), (63, 128, 10), (4097, 10, 1), (130, 20, 5), (300, 40, 7),
                (200, 70, 9), (1000, 7, 3), (65536, 128, 10)]


@pytest.mark.parametrize("n,k,d", ESTEP_SHAPES)
def test_estep_matches_plain(dev, n, k, d):
    x, exp = _estep_inputs(dev, n, k, d)
    before = estep.launches
    stats, ev = estep.e_step_stats_fused(x, exp, scale=2.5)
    assert estep.launches == before + 1
    ref, ref_ev = estep.e_step_stats_reference(x, exp, scale=2.5)
    for got, want in zip(stats, ref):
        err = float((got - want).abs().max() / (want.abs().max() + 1e-30))
        assert err < 5e-5, err
    assert float((ev - ref_ev).abs().max()) < 1e-3
    assert torch.equal(stats.scatter_stat, stats.scatter_stat.mT)
    again, ev2 = estep.e_step_stats_fused(x, exp, scale=2.5)
    assert all(torch.equal(p, q) for p, q in zip(stats, again))
    assert torch.equal(ev, ev2)


def profiled_estep_kernels(n: int, k: int, d: int) -> dict:
    """One call of the kernel under torch.profiler on cuda:0 (after one
    unprofiled call): the device kernels it ran and the plan's count."""
    dev = torch.device("cuda", 0)
    x, exp = _estep_inputs(dev, n, k, d)
    estep.e_step_stats_fused(x, exp)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        estep.e_step_stats_fused(x, exp)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    cap = estep.card_capacity(x.device.index, d, k)
    return {"kernels": kernels, "want": estep.launches_per_call(n, d, k, cap)}


@pytest.mark.parametrize("n,k,d", [(400, 10, 2), (65536, 128, 10)])
def test_estep_launches_per_call(dev, n, k, d):
    """One kernel a call at the pinwheel shape (the ticket's last block adds
    the partials), as the plan says; at the design shape the plan's count.
    The profile is taken in a fresh child process (as chip_smoke's
    ``timed_fresh``): late in a long process torch.profiler has read no
    device events at all."""
    code = ("import importlib.util, json, sys\n"
            "spec = importlib.util.spec_from_file_location('cuda_mixture', sys.argv[1])\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "got = mod.profiled_estep_kernels(*map(int, sys.argv[2:]))\n"
            "print('RESULT ' + json.dumps(got))\n")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), *filter(None, [os.environ.get("PYTHONPATH")])]))
    out = subprocess.run([sys.executable, "-c", code, __file__, str(n), str(k), str(d)],
                         cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads([ln for ln in out.stdout.splitlines()
                      if ln.startswith("RESULT ")][-1][len("RESULT "):])
    kernels, want = got["kernels"], got["want"]
    assert len(kernels) == want and all("estep" in name for name in kernels), kernels
    if n == 400:
        assert want == 1


def test_estep_capacity_is_sms_times_blocks_an_sm(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for d, k in ((2, 10), (10, 128), (1, 1), (7, 40)):
        cap = estep.card_capacity(torch.cuda.current_device(), d, k)
        assert cap >= sms and cap % sms == 0, (d, k, cap)


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
