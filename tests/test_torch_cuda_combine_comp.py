"""The component-parallel CUDA kernels on the card: the ρ-kernel
(``log_rho_fused``, forward and backward) and the combine's log_norm mode
(forward and backward, with the normaliser's cotangent) against their plain
versions at the bigk (N = 1024, K = 100 in shards of 50, d = 10, S = 1) and
pinwheel (N = 400, K = 10 in shards of 5, d = 2, S = 4) shard shapes,
bit-equal reruns, and the wrappers raising outside their shape class.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_combine_comp.py -m requires_cuda --noconftest
"""

import numpy as np
import pytest
import torch

from svax_torch.ops import combine
from svax_torch.pgm import gmm

torch.set_num_threads(1)
pytestmark = pytest.mark.requires_cuda

# tests/test_combine_kernel.py's bars: z, log r̃, μ̃ and log ρ at 2e-5, the
# local row and the statistics at 2e-4; gradients at 5e-4 of each tensor's
# largest entry (dw sums N·K terms in float32).
VALUE_TOL = {"z": 2e-5, "log_resp": 2e-5, "mean": 2e-5, "local": 2e-4, "stats": 2e-4}
GRAD_TOL = 5e-4
SHAPES = {"bigk": (1024, 100, 10, 1), "pinwheel": (400, 10, 2, 4)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n, k, d, s, seed=0):
    rng = np.random.default_rng(seed)
    pot_h = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    pot_p = torch.tensor(0.3 + rng.random((n, d)), dtype=torch.float32)
    prior = gmm.make_prior(k, d)
    nat = gmm.init_variational(torch.Generator().manual_seed(seed), prior)
    exp = gmm.GmmExpected(*(t.to(dev) for t in gmm.expected_params(nat)))
    eps = torch.tensor(rng.standard_normal((s, n, k, d)), dtype=torch.float32)
    return pot_h.to(dev), pot_p.to(dev), exp, eps.to(dev), rng


def _shard(exp, i, count=2):
    k = exp.log_pi.shape[0] // count
    return gmm.GmmExpected(*(t[i * k:(i + 1) * k] for t in exp))


def _outputs(out):
    z, lr, mean, local, st = out
    return {"z": z, "log_resp": lr, "mean": mean, "local": local,
            "stats": torch.cat([st.counts[:, None], st.mean_stat,
                                st.scatter_stat.flatten(1)], dim=1)}


def _grads(fn, tensors, loss_of):
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    return torch.autograd.grad(loss_of(fn(*leaves)), leaves, allow_unused=True)


def _held(got, want, what):
    for g, w in zip(got, want):
        if w is None:
            assert g is None or float(g.abs().max()) == 0.0, what
            continue
        bar = GRAD_TOL * max(float(w.abs().max()), 1e-30)
        np.testing.assert_allclose(g.cpu().double().numpy(), w.cpu().double().numpy(),
                                   rtol=GRAD_TOL, atol=bar, err_msg=what)


@pytest.mark.parametrize("label", list(SHAPES))
def test_log_rho_kernels_match_plain(dev, label):
    n, k, d, s = SHAPES[label]
    pot_h, pot_p, exp, _, rng = _inputs(dev, n, k, d, s)
    for e in (exp, _shard(exp, 0), _shard(exp, 1)):
        before = combine.rho_launches
        got = combine.log_rho_fused(pot_h, pot_p, e)
        torch.cuda.synchronize()
        assert combine.rho_launches == before + 1
        want = combine.log_rho_plain(pot_h, pot_p, e)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-5, atol=2e-5)
        assert torch.equal(got, combine.log_rho_fused(pot_h, pot_p, e))
        drho = torch.tensor(rng.standard_normal(got.shape), dtype=torch.float32, device=dev)
        loss = lambda out: (out * drho).sum()  # noqa: E731
        kern = lambda a, b, *f: combine.log_rho_fused(a, b, gmm.GmmExpected(*f))  # noqa: E731
        plain = lambda a, b, *f: combine.log_rho_plain(a, b, gmm.GmmExpected(*f))  # noqa: E731
        gk = _grads(kern, (pot_h, pot_p, *e), loss)
        _held(gk, _grads(plain, (pot_h, pot_p, *e), loss), f"{label} log rho backward")
        assert all(torch.equal(a, b) for a, b in zip(gk, _grads(kern, (pot_h, pot_p, *e), loss)))


@pytest.mark.parametrize("label", list(SHAPES))
def test_log_norm_combine_kernels_match_plain(dev, label):
    """One shard's combine against the cross-shard normaliser: values, each
    cotangent path alone and all together (dn among the gradients), reruns."""
    n, k, d, s = SHAPES[label]
    pot_h, pot_p, exp, eps, rng = _inputs(dev, n, k, d, s, seed=1)
    lse = torch.logsumexp(torch.cat([combine.log_rho_fused(pot_h, pot_p, _shard(exp, i))
                                     for i in range(2)], dim=1), dim=-1)
    e0, eps0 = _shard(exp, 0), eps[:, :, :k // 2].contiguous()
    kern = lambda a, b, *f: combine.combine_fused(  # noqa: E731
        a, b, gmm.GmmExpected(*f[:-1]), eps0, s, log_norm=f[-1])
    plain = lambda a, b, *f: combine.combine_fused_plain(  # noqa: E731
        a, b, gmm.GmmExpected(*f[:-1]), eps0, s, log_norm=f[-1])
    before = (combine.norm_launches, combine.launches)
    got = _outputs(kern(pot_h, pot_p, *e0, lse))
    torch.cuda.synchronize()
    assert (combine.norm_launches, combine.launches) == (before[0] + 1, before[1])
    want = _outputs(plain(pot_h, pot_p, *e0, lse))
    for name, tol in VALUE_TOL.items():
        np.testing.assert_allclose(got[name].cpu().numpy(), want[name].cpu().numpy(),
                                   rtol=tol, atol=tol, err_msg=f"{label} {name}")
    again = _outputs(kern(pot_h, pot_p, *e0, lse))
    assert all(torch.equal(got[m], again[m]) for m in got)
    cts = {m: torch.tensor(rng.standard_normal(t.shape), dtype=torch.float32, device=dev)
           for m, t in want.items()}
    for paths in [list(cts)] + [[m] for m in cts]:
        loss = lambda out, paths=paths: sum(  # noqa: E731
            (_outputs(out)[m] * cts[m]).sum() for m in paths)
        gk = _grads(kern, (pot_h, pot_p, *e0, lse), loss)
        _held(gk, _grads(plain, (pot_h, pot_p, *e0, lse), loss), f"{label} via {paths}")
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in
                   zip(gk, _grads(kern, (pot_h, pot_p, *e0, lse), loss)))


@pytest.mark.parametrize("label", list(SHAPES))
def test_two_shards_equal_the_unsharded_combine(dev, label):
    """Each shard's ρ-kernel, the lse across both, each shard's log_norm
    combine, put together: the unsharded softmax combine's values and
    gradients."""
    n, k, d, s = SHAPES[label]
    pot_h, pot_p, exp, eps, _ = _inputs(dev, n, k, d, s, seed=2)

    def sharded(a, b, *f):
        es = [_shard(gmm.GmmExpected(*f), i) for i in range(2)]
        nrm = torch.logsumexp(torch.cat([combine.log_rho_fused(a, b, e) for e in es], dim=1),
                              dim=-1)
        outs = [combine.combine_fused(a, b, e, eps[:, :, i * (k // 2):(i + 1) * (k // 2)]
                                      .contiguous(), s, log_norm=nrm)
                for i, e in enumerate(es)]
        return (torch.cat([o[0] for o in outs], dim=2), torch.cat([o[1] for o in outs], 1),
                torch.cat([o[2] for o in outs], 1), outs[0][3] + outs[1][3],
                gmm.GmmSuffStats(*(torch.cat(t) for t in zip(*(o[4] for o in outs)))))

    def whole(a, b, *f):
        return combine.combine_fused(a, b, gmm.GmmExpected(*f), eps, s)

    got, want = _outputs(sharded(pot_h, pot_p, *exp)), _outputs(whole(pot_h, pot_p, *exp))
    for name, tol in VALUE_TOL.items():
        np.testing.assert_allclose(got[name].cpu().numpy(), want[name].cpu().numpy(),
                                   rtol=tol, atol=tol, err_msg=f"{label} {name}")

    def scalar(out):
        z, lr, mean, local, st = out
        return ((torch.exp(lr) * torch.tanh(z).sum(dim=(0, -1))).sum() - local.sum()
                + 0.01 * st.scatter_stat.sum() + 0.1 * mean.sum())

    _held(_grads(sharded, (pot_h, pot_p, *exp), scalar),
          _grads(whole, (pot_h, pot_p, *exp), scalar), f"{label} sharded gradients")


def test_wrappers_raise_outside_the_shape_class(dev):
    pot_h, pot_p, exp, eps, _ = _inputs(dev, 16, 4, 5, 1)
    with pytest.raises(ValueError, match="latent d = 5"):
        combine.log_rho_fused(pot_h, pot_p, exp)
    pot_h, pot_p, exp, eps, _ = _inputs(dev, 16, 4, 2, 1)
    with pytest.raises(ValueError, match="float32"):
        combine.log_rho_fused(pot_h.double(), pot_p, exp)
    with pytest.raises(ValueError, match="log_norm shape"):
        combine.combine_fused(pot_h, pot_p, exp, eps, 1, log_norm=torch.zeros(15, device=dev))
