"""The port's x-free Bernoulli row sum (``svax_torch/ops/decoder.py``)
against the reference's Pallas kernel (``svax/ops/decoder_pallas.py``) run
in interpret mode, as tests/test_kernel_interpret.py:75-140 runs it.

The same numpy inputs go to both; the port runs its plain version (CPU
tensors). Bars: the reference kernel test's, the row sum and the fused
log-likelihood at rtol = atol = 2e-5 and the gradients (H̄, W̄, b̄) at
5e-5. The cotangent is a fixed non-uniform one, sin(1 + i) over the
outputs; the reference test's ``sum(sin(out))`` makes it cos(out), which at
D = 784 (|ll| ~ 600, an f32 ulp ~6e-5) turns each side's rounding of ll
into a 1e-4 change of the cotangent, a property of the loss and not of
either backward.

The bf16 mode ("default", and "high" mapped to it) rounds H and W to bf16
before the products and sums in f32: against the reference at HIGHEST on
operands rounded to bf16 in numpy, the products are exact in f32 on both
sides and only the order of summation differs, so the row sum keeps the
2e-5 bar and b̄ (a sum of the f32 do) 5e-5. The port's backward also rounds
do = −σ(o)·s̄ before its products, as the reference kernel's DEFAULT dots
do on the TPU and its f32 dots on the CPU cannot: H̄ and W̄ are held within
1e-2 of their largest entry (do's rounding is up to 2⁻⁹ of it; measured
3.3e-3 at most).
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.nets import mlp as jnets
from svax.ops import decoder_pallas
from svax_torch.nets import mlp as nets
from svax_torch.ops import decoder

torch.set_num_threads(1)
HIGHEST = jax.lax.Precision.HIGHEST


def _setup(seed, n, r, dh, d):
    """tests/test_kernel_interpret.py's inputs, as numpy float32."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, r, dh)).astype(np.float32)
    w = (0.3 * rng.standard_normal((dh, d))).astype(np.float32)
    b = (0.1 * rng.standard_normal((d,))).astype(np.float32)
    x = rng.integers(0, 2, size=(n, d)).astype(np.float32)
    return h, w, b, x


def _bf16(a):
    """a rounded to bf16 (round to nearest even), as float32."""
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def _leaves(*arrays):
    return [torch.tensor(a).requires_grad_(True) for a in arrays]


def _cotangent(shape):
    """A fixed non-uniform cotangent: sin(1 + i) over the outputs, float32."""
    return np.sin(1.0 + np.arange(int(np.prod(shape)))).reshape(shape).astype(np.float32)


def _vjp(fn, cot, *arrays):
    """The reference's VJP of fn at the arrays, with cotangent ``cot``."""
    _, pull = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return pull(jnp.asarray(cot))


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("n,r,dh,d,tile_m", [(5, 3, 20, 33, 8), (4, 4, 16, 784, 16)])
def test_forward_matches_the_interpreted_kernel(n, r, dh, d, tile_m):
    h, w, b, x = _setup(0, n, r, dh, d)
    j = [jnp.asarray(a) for a in (h, w, b, x)]
    want_ll = decoder_pallas.fused_bernoulli_loglik(*j, tile_m=tile_m, interpret=True)
    want_s = decoder_pallas.rowsum_logsig_neg(*j[:3], tile_m=tile_m, interpret=True)
    got_ll = decoder.fused_bernoulli_loglik(*(torch.tensor(a) for a in (h, w, b, x)))
    got_s = decoder.rowsum_logsig_neg(*(torch.tensor(a) for a in (h, w, b)))
    _close(got_ll, want_ll, 2e-5, 2e-5, "ll")
    _close(got_s, want_s, 2e-5, 2e-5, "s")
    _close(decoder.bernoulli_loglik_reference(*(torch.tensor(a) for a in (h, w, b, x))),
           decoder_pallas.bernoulli_loglik_reference(*j), 2e-5, 2e-5, "twin")


@pytest.mark.parametrize("n,r,dh,d,tile_m", [(5, 3, 20, 33, 8), (4, 4, 16, 784, 16)])
def test_gradients_match_the_interpreted_kernel(n, r, dh, d, tile_m):
    """The custom VJP (multi-tile W̄/b̄ accumulation in the reference)."""
    h, w, b, x = _setup(1, n, r, dh, d)
    cot = _cotangent((n, r))
    want = _vjp(lambda h, w, b: decoder_pallas.fused_bernoulli_loglik(
        h, w, b, jnp.asarray(x), tile_m=tile_m, interpret=True), cot, h, w, b)
    leaves = _leaves(h, w, b)
    out = decoder.fused_bernoulli_loglik(*leaves, torch.tensor(x))
    got = torch.autograd.grad(out, leaves, torch.tensor(cot))
    for g, t, name in zip(got, want, ("hbar", "wbar", "bbar")):
        _close(g, t, 5e-5, 5e-5, name)


def test_leading_axes_and_row_sum_gradients():
    """(S, N, K, Dh) rows flatten (tests/test_kernel_interpret.py:109-117);
    the row sum's own gradients."""
    rng = np.random.default_rng(5)
    s_, n, k, dh, d = 2, 3, 4, 12, 17
    h = rng.standard_normal((s_, n, k, dh)).astype(np.float32)
    w = (0.3 * rng.standard_normal((dh, d))).astype(np.float32)
    b = (0.1 * rng.standard_normal((d,))).astype(np.float32)
    cot = _cotangent((s_, n, k))
    want_s = decoder_pallas.rowsum_logsig_neg(*(jnp.asarray(a) for a in (h, w, b)),
                                              tile_m=8, interpret=True)
    want = _vjp(lambda h, w, b: decoder_pallas.rowsum_logsig_neg(h, w, b, tile_m=8,
                                                                 interpret=True), cot, h, w, b)
    leaves = _leaves(h, w, b)
    got_s = decoder.rowsum_logsig_neg(*leaves)
    assert got_s.shape == (s_, n, k)
    _close(got_s, want_s, 2e-5, 2e-5, "s")
    got = torch.autograd.grad(got_s, leaves, torch.tensor(cot))
    for g, t, name in zip(got, want, ("hbar", "wbar", "bbar")):
        _close(g, t, 5e-5, 5e-5, name)


@pytest.mark.parametrize("n,r,dh,d,tile_m", [(5, 3, 20, 33, 8), (4, 4, 16, 784, 16)])
def test_bf16_mode_against_the_reference_on_rounded_operands(n, r, dh, d, tile_m):
    h, w, b, _ = _setup(2, n, r, dh, d)
    hr, wr = _bf16(h), _bf16(w)
    assert not np.array_equal(hr, h)  # the rounding is real at these inputs
    cot = _cotangent((n, r))

    def ref(h, w, b):
        return decoder_pallas.rowsum_logsig_neg(h, w, b, tile_m=tile_m, interpret=True,
                                                precision=HIGHEST)

    want_s = ref(*(jnp.asarray(a) for a in (hr, wr, b)))
    want = _vjp(ref, cot, hr, wr, b)
    leaves = _leaves(h, w, b)
    got_s = decoder.rowsum_logsig_neg(*leaves, precision="default")
    _close(got_s, want_s, 2e-5, 2e-5, "s")
    got = torch.autograd.grad(got_s, leaves, torch.tensor(cot))
    _close(got[2], want[2], 5e-5, 5e-5, "bbar")
    for g, t, name in zip(got[:2], want[:2], ("hbar", "wbar")):
        t = np.asarray(t)
        _close(g, t, 0.0, 1e-2 * float(np.abs(t).max()), name)
    # "high" maps to "default" (the reference's _kernel_precision), and the
    # f32 mode on the rounded operands is another function.
    high = decoder.rowsum_logsig_neg(*(torch.tensor(a) for a in (h, w, b)), precision="high")
    assert torch.equal(high, got_s.detach())
    f32 = decoder.rowsum_logsig_neg(*(torch.tensor(a) for a in (h, w, b)))
    assert not torch.equal(f32, got_s.detach())


def test_bf16_mode_rounds_the_cotangent_before_its_products():
    """The plain version's backward in the bf16 mode equals the product of the
    bf16-rounded do with the bf16-rounded operands (float64 check)."""
    h, w, b, _ = _setup(3, 4, 5, 12, 40)
    h2 = h.reshape(-1, 12)
    sbar = np.sin(np.arange(h2.shape[0], dtype=np.float32))
    leaves = _leaves(h2, w, b)
    s = decoder.rowsum_logsig_neg_plain(*leaves, "default")
    hbar, wbar, bbar = torch.autograd.grad((s * torch.tensor(sbar)).sum(), leaves)
    hr, wr = torch.tensor(_bf16(h2)), torch.tensor(_bf16(w))
    do = -torch.sigmoid(hr @ wr + torch.tensor(b)) * torch.tensor(sbar)[:, None]
    dr = do.to(torch.bfloat16).double()
    _close(hbar, (dr @ wr.double().T).numpy(), 1e-6, 1e-7, "hbar")
    _close(wbar, (hr.double().T @ dr).numpy(), 1e-6, 1e-7, "wbar")
    _close(bbar, do.double().sum(0).numpy(), 1e-6, 1e-7, "bbar")


def test_decomposed_fused_route_matches_the_reference():
    """``nets.bernoulli_loglik_decomposed(fused=True)`` against the
    reference's fused branch with its backend gate patched and the kernel
    interpreted (tests/test_kernel_interpret.py:128-136), at 2e-4; the
    port's branch runs its row sum in ``ops.decoder``."""
    rng = np.random.default_rng(5)
    s_, n, k, dh, d = 2, 3, 4, 12, 17
    params = [{"w": (0.3 * rng.standard_normal((5, dh))).astype(np.float32),
               "b": np.zeros((dh,), np.float32)},
              {"w": (0.3 * rng.standard_normal((dh, d))).astype(np.float32),
               "b": (0.1 * rng.standard_normal((d,))).astype(np.float32)}]
    z = rng.standard_normal((s_, n, k, 5)).astype(np.float32)
    x = rng.integers(0, 2, (n, d)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    orig_fwd = decoder_pallas._rowsum_fwd_call
    with mock.patch("jax.default_backend", return_value="tpu"), mock.patch(
        "svax.ops.decoder_pallas._rowsum_fwd_call",
        lambda *a, **kw: orig_fwd(*a, **{**kw, "interpret": True}),
    ):
        want = jnets.bernoulli_loglik_decomposed(jparams, jnp.asarray(z), jnp.asarray(x),
                                                 fused=True)
    tparams = [{key: torch.tensor(v) for key, v in ly.items()} for ly in params]
    calls = []
    real = decoder.rowsum_logsig_neg_plain
    with mock.patch.object(decoder, "rowsum_logsig_neg_plain",
                           lambda *a: calls.append(a[-1]) or real(*a)):
        got = nets.bernoulli_loglik_decomposed(tparams, torch.tensor(z), torch.tensor(x),
                                               fused=True)
        got_bf16 = nets.bernoulli_loglik_decomposed(tparams, torch.tensor(z),
                                                    torch.tensor(x), fused=True,
                                                    precision="default")
    assert calls == ["highest", "default"]
    _close(got, want, 2e-4, 2e-4, "ll")
    _close(got, nets.bernoulli_loglik_decomposed(tparams, torch.tensor(z), torch.tensor(x)),
           2e-5, 2e-5, "fused vs unfused")
    assert not torch.equal(got_bf16, got)


def test_fused_has_no_effect_under_bf16_compute():
    """As in the reference (svax/nets/mlp.py:268): the row-sum route is f32
    only; under bf16 compute ``fused=True`` is the unfused bf16 path."""
    rng = np.random.default_rng(6)
    params = [{"w": torch.tensor(0.3 * rng.standard_normal((4, 10)), dtype=torch.float32),
               "b": torch.zeros(10)},
              {"w": torch.tensor(0.3 * rng.standard_normal((10, 20)), dtype=torch.float32),
               "b": torch.tensor(0.1 * rng.standard_normal(20), dtype=torch.float32)}]
    z = torch.tensor(rng.standard_normal((1, 6, 3, 4)), dtype=torch.float32)
    x = torch.tensor(rng.integers(0, 2, (6, 20)), dtype=torch.float32)
    with mock.patch.object(decoder, "rowsum_logsig_neg",
                           side_effect=AssertionError("row sum reached under bf16")):
        fused = nets.bernoulli_loglik_decomposed(params, z, x, torch.bfloat16, fused=True)
    assert torch.equal(fused, nets.bernoulli_loglik_decomposed(params, z, x, torch.bfloat16))


def test_wrapper_rejects_unknown_precision_and_devices():
    h, w, b, _ = _setup(4, 2, 3, 8, 9)
    args = [torch.tensor(a) for a in (h, w, b)]
    with pytest.raises(ValueError, match="precision"):
        decoder.rowsum_logsig_neg(*args, precision="bf16")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        decoder.rowsum_logsig_neg(*(t.to("meta") for t in args))
