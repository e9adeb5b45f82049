"""The combine CUDA kernels on the card: forward and backward against their
plain version at d ∈ {2, 3, 4, 6, 8, 10} (the mnist and bigk shapes among
them), the train step's backward (combine_bwd_lean: the cotangents of z,
log r̃ and the local row only, no dw) at every d at the mnist, bigk and a
ragged shape, which calls take which backward, the grid against the
Python mirror of the block plan, bit-equal reruns, the in-kernel ε, and
the wrapper raising (not falling back) outside its shape class.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_combine.py -m requires_cuda --noconftest
"""

import numpy as np
import pytest
import torch

from svax_torch.models import svae
from svax_torch.ops import _build, combine
from svax_torch.pgm import gmm

torch.set_num_threads(1)
pytestmark = pytest.mark.requires_cuda

# tests/test_combine_kernel.py's bars: z, log r̃ and μ̃ at 2e-5, the local row
# and the statistics at 2e-4 (rtol and atol). Gradients: its 5e-4 relative
# to each tensor's largest entry, since dw sums N·K terms in float32.
VALUE_TOL = {"z": 2e-5, "log_resp": 2e-5, "mean": 2e-5, "local": 2e-4, "stats": 2e-4}
GRAD_TOL = 5e-4
SHAPES = [(40, 5, 2, 2), (130, 10, 3, 1), (64, 7, 4, 3), (33, 12, 6, 2),
          (256, 10, 8, 1), (1024, 100, 10, 1), (48, 5, 10, 2)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n, k, d, s, seed=0):
    """tests/test_combine_kernel.py:_inputs, made with numpy and torch."""
    rng = np.random.default_rng(seed)
    pot_h = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    pot_p = torch.tensor(0.3 + rng.random((n, d)), dtype=torch.float32)
    prior = gmm.make_prior(k, d)
    nat = gmm.init_variational(torch.Generator().manual_seed(seed), prior)
    exp = gmm.GmmExpected(*(t.to(dev) for t in gmm.expected_params(nat)))
    eps = torch.tensor(rng.standard_normal((s, n, k, d)), dtype=torch.float32)
    return pot_h.to(dev), pot_p.to(dev), exp, eps.to(dev)


def _outputs(out):
    z, lr, mean, local, st = out
    return {"z": z, "log_resp": lr, "mean": mean, "local": local,
            "stats": torch.cat([st.counts[:, None], st.mean_stat,
                                st.scatter_stat.flatten(1)], dim=1)}


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got.detach().cpu().double().numpy(),
                               want.detach().cpu().double().numpy(),
                               rtol=rtol, atol=atol, err_msg=what)


def _grads(fn, pot_h, pot_p, exp, cts):
    """Gradients of Σ_i ⟨output_i, ct_i⟩ w.r.t. pot_h, pot_p and exp's fields."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (pot_h, pot_p, *exp)]
    outs = _outputs(fn(leaves[0], leaves[1], gmm.GmmExpected(*leaves[2:])))
    loss = sum((outs[name] * ct).sum() for name, ct in cts.items())
    return torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("n,k,d,s", SHAPES)
def test_kernel_matches_plain(dev, n, k, d, s):
    pot_h, pot_p, exp, eps = _inputs(dev, n, k, d, s)
    before = (combine.launches, combine.backward_launches)
    got = _outputs(combine.combine_fused(pot_h, pot_p, exp, eps, s, scale=2.5))
    torch.cuda.synchronize()
    assert combine.launches == before[0] + 1
    want = _outputs(combine.combine_fused_plain(pot_h, pot_p, exp, eps, s, scale=2.5))
    for name, tol in VALUE_TOL.items():
        _close(got[name], want[name], tol, tol, name)

    rng = np.random.default_rng(1)
    cts = {name: torch.tensor(rng.standard_normal(t.shape), dtype=torch.float32,
                              device=dev) for name, t in want.items()}
    kern = lambda a, b, e: combine.combine_fused(a, b, e, eps, s)  # noqa: E731
    plain = lambda a, b, e: combine.combine_fused_plain(a, b, e, eps, s)  # noqa: E731
    # All five cotangent paths together, then each alone.
    for paths in [list(cts)] + [[name] for name in cts]:
        sub = {name: cts[name] for name in paths}
        for g, w, what in zip(_grads(kern, pot_h, pot_p, exp, sub),
                              _grads(plain, pot_h, pot_p, exp, sub),
                              ["pot_h", "pot_p", *gmm.GmmExpected._fields]):
            if w is None:
                assert g is None or float(g.abs().max()) == 0.0, what
                continue
            scale = float(w.abs().max())
            _close(g, w, GRAD_TOL, GRAD_TOL * scale, f"{what} through {paths}")
    torch.cuda.synchronize()
    assert combine.backward_launches > before[1]


def _pot_grads(fn, pot_h, pot_p, exp, cts):
    """Gradients of Σ_i ⟨output_i, ct_i⟩ w.r.t. pot_h and pot_p only (the
    expected parameters constant, as in the train step)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (pot_h, pot_p)]
    outs = _outputs(fn(leaves[0], leaves[1], exp))
    loss = sum((outs[name] * ct).sum() for name, ct in cts.items())
    return torch.autograd.grad(loss, leaves)


MAIN_PATH = ("z", "log_resp", "local")  # the outputs the train step differentiates


@pytest.mark.parametrize("d", combine.LATENT_DIMS)
@pytest.mark.parametrize("n,k", [(256, 10), (1024, 100), (77, 13)], ids=["mnist", "bigk", "ragged"])
def test_main_path_backward_matches_plain(dev, n, k, d):
    """The train step's call (cotangents of z, log r̃ and the local row; no
    dw) runs combine_bwd_lean and matches the plain version, with injected
    and with in-kernel ε; reruns are bit-equal."""
    s = 1
    pot_h, pot_p, exp, eps = _inputs(dev, n, k, d, s, seed=d)
    rng = np.random.default_rng(d)
    shapes = {"z": (s, n, k, d), "log_resp": (n, k), "local": (n,)}
    cts = {name: torch.tensor(rng.standard_normal(sh), dtype=torch.float32, device=dev)
           for name, sh in shapes.items()}
    before = (combine.lean_backward_launches, combine.backward_launches)
    got = _pot_grads(lambda a, b, e: combine.combine_fused(a, b, e, eps, s),
                     pot_h, pot_p, exp, cts)
    torch.cuda.synchronize()
    assert (combine.lean_backward_launches, combine.backward_launches) == (
        before[0] + 1, before[1] + 1)
    want = _pot_grads(lambda a, b, e: combine.combine_fused_plain(a, b, e, eps, s),
                      pot_h, pot_p, exp, cts)
    for g, w, what in zip(got, want, ("pot_h", "pot_p")):
        _close(g, w, GRAD_TOL, GRAD_TOL * float(w.abs().max()), what)
    seeded = [_pot_grads(lambda a, b, e: combine.combine_fused(a, b, e, None, s, seed=5, step=2),
                         pot_h, pot_p, exp, cts) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*seeded))
    z = combine.combine_fused(pot_h, pot_p, exp, None, s, seed=5, step=2)[0]
    post = svae.sin_combine(pot_h.double(), pot_p.double(),
                            gmm.GmmExpected(*(t.double() for t in exp)))
    rec = (post.prec_chol.mT @ (z[0].double() - post.mean)[..., None])[..., 0]
    recovered = _pot_grads(lambda a, b, e: combine.combine_fused(a, b, e, rec[None].float(), s),
                           pot_h, pot_p, exp, cts)
    for g, w, what in zip(seeded[0], recovered, ("pot_h", "pot_p")):
        _close(g, w, GRAD_TOL, GRAD_TOL * float(w.abs().max()), f"seeded {what}")


def test_calls_with_dstats_or_dw_take_the_full_backward(dev):
    n, k, d, s = 64, 7, 4, 1
    pot_h, pot_p, exp, eps = _inputs(dev, n, k, d, s)
    rng = np.random.default_rng(0)
    want = _outputs(combine.combine_fused_plain(pot_h, pot_p, exp, eps, s))
    cts = {name: torch.tensor(rng.standard_normal(t.shape), dtype=torch.float32, device=dev)
           for name, t in want.items()}
    kern = lambda a, b, e: combine.combine_fused(a, b, e, eps, s)  # noqa: E731
    main = {name: cts[name] for name in MAIN_PATH}
    for grads, sub, variant in ((_pot_grads, main, "lean"),
                                (_pot_grads, {**main, "mean": cts["mean"]}, "lean"),
                                (_pot_grads, {**main, "stats": cts["stats"]}, "full"),
                                (_grads, main, "full"), (_grads, cts, "full")):
        before = (combine.lean_backward_launches, combine.backward_launches)
        grads(kern, pot_h, pot_p, exp, sub)
        torch.cuda.synchronize()
        assert combine.backward_launches == before[1] + 1
        assert combine.lean_backward_launches == before[0] + (variant == "lean"), (sub, variant)
        assert combine.backward_variant("stats" in sub, grads is _grads) == variant


@pytest.mark.parametrize("d", [2, 8, 10])
def test_grid_is_the_plans(dev, d):
    """combine_grid's partial counts follow the Python plan: the row groups
    of R = rows_per_block(N, K, threads, SMs) rows, or fewer where the card
    cannot hold them all at once — then a whole number of blocks an SM."""
    lib = _build.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind in range(4):
        threads = combine.BLOCK_THREADS if kind < 2 else combine.FULL_THREADS
        for k in (1, 5, 10, 13, 50, 100, 128):
            for n in (1, 7, 77, 256, 512, 1024, 5000, 1 << 20):
                blocks = lib.combine_grid(n, k, d, kind)
                groups = combine.row_groups(n, k, threads, sms)
                assert 1 <= blocks <= groups, (kind, k, n, blocks, groups)
                assert blocks == groups or blocks % sms == 0, (kind, k, n, blocks, sms)
            assert lib.combine_grid(1 << 20, k, d, kind) < combine.row_groups(1 << 20, k,
                                                                              threads, sms)


def test_reruns_are_bit_equal(dev):
    pot_h, pot_p, exp, eps = _inputs(dev, 1024, 100, 10, 1, seed=2)
    leaves = [t.clone().requires_grad_(True) for t in (pot_h, pot_p, *exp)]

    def run():
        out = combine.combine_fused(leaves[0], leaves[1], gmm.GmmExpected(*leaves[2:]),
                                    None, 1, seed=7, step=3)
        loss = sum(o.sum() for o in _outputs(out).values())
        return [*_outputs(out).values(), *torch.autograd.grad(loss, leaves)]

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


def test_in_kernel_eps_is_normal_seeded_and_gives_the_injected_gradients(dev):
    n, k, d, s = 1024, 100, 10, 1
    pot_h, pot_p, exp, _ = _inputs(dev, n, k, d, s, seed=4)
    z, _, mean, _, _ = combine.combine_fused(pot_h, pot_p, exp, None, s, seed=11, step=5)
    post = svae.sin_combine(pot_h.double(), pot_p.double(),
                            gmm.GmmExpected(*(t.double() for t in exp)))
    eps = (post.prec_chol.mT @ (z[0].double() - post.mean)[..., None])[..., 0]
    assert abs(float(eps.mean())) < 0.005 and abs(float(eps.var()) - 1.0) < 0.01
    again = combine.combine_fused(pot_h, pot_p, exp, None, s, seed=11, step=5)[0]
    assert torch.equal(again, z)
    assert not torch.equal(combine.combine_fused(pot_h, pot_p, exp, None, s, seed=11,
                                                 step=6)[0], z)
    assert not torch.equal(combine.combine_fused(pot_h, pot_p, exp, None, s, seed=12,
                                                 step=5)[0], z)
    rng = np.random.default_rng(3)
    cts = {"z": torch.tensor(rng.standard_normal((s, n, k, d)), dtype=torch.float32,
                             device=dev),
           "log_resp": torch.tensor(rng.standard_normal((n, k)), dtype=torch.float32,
                                    device=dev)}
    seeded = _grads(lambda a, b, e: combine.combine_fused(a, b, e, None, s, seed=11, step=5),
                    pot_h, pot_p, exp, cts)
    injected = _grads(lambda a, b, e: combine.combine_fused(a, b, e, eps[None].float(), s),
                      pot_h, pot_p, exp, cts)
    for g, w in zip(seeded, injected):
        _close(g, w, GRAD_TOL, GRAD_TOL * float(w.abs().max()), "seeded vs recovered eps")


def test_wrapper_raises_outside_the_shape_class(dev):
    before = (combine.launches, combine.backward_launches)
    pot_h, pot_p, exp, eps = _inputs(dev, 16, 3, 5, 1)
    with pytest.raises(ValueError, match="latent d = 5"):
        combine.combine_fused(pot_h, pot_p, exp, eps, 1)
    pot_h, pot_p, exp, eps = _inputs(dev, 4, 129, 2, 1)
    with pytest.raises(ValueError, match="K <= 128"):
        combine.combine_fused(pot_h, pot_p, exp, eps, 1)
    pot_h, pot_p, exp, eps = _inputs(dev, 16, 3, 4, 1)
    with pytest.raises(ValueError, match="float32"):
        combine.combine_fused(pot_h.double(), pot_p, exp, eps, 1)
    with pytest.raises(ValueError, match="requires a seed"):
        combine.combine_fused(pot_h, pot_p, exp, None, 1)
    assert (combine.launches, combine.backward_launches) == before
