"""The port's fused MLP decoder (plain version, on the CPU) against the JAX
reference kernel in interpret mode.

* values and every gradient — z, W1..3, b1..3, with the x-term through y
  and c — against ``bernoulli_mlp_loglik_fused(..., tile=128,
  interpret=True)`` at the reference's own shapes
  (tests/test_decoder_mlp_kernel.py:40-47: n = 40, and n = 300 for several
  n-tiles) and one d = 10, K = 12 case, at that file's bars:
  - values at rtol = atol = 1e-5: both sides round the same operands to
    bf16 and sum in f32, in other orders; but torch's and XLA's f32 tanh
    differ in the last bit on most inputs (63% of 10⁶ normals, measured),
    and an activation that lands on a bf16 rounding tie then rounds the
    other way and moves its row's ll by up to ~1e-3 of it (2 of 3000
    values, by 3.3e-4, at the multi-tile shape): so under 0.5% of the
    values may miss 1e-5, and none 1e-3;
  - dz at a worst case of 5e-3 with under 0.5% of entries beyond 1e-5:
    dz is rounded to bf16, and a sum that lands near a rounding tie in one
    order rounds the other way in another, one bf16 ulp (:107-114);
  - dW and db within 2e-2 of max(1, max|ref|): the reference rounds each
    tile's dW to bf16 before adding the tiles, the port rounds the sum
    once; the difference grows like sqrt(rows)·2⁻⁹ (:115-120);
* against the reference's XLA bf16 path, ``bernoulli_loglik_decomposed(...,
  compute_dtype=bfloat16)``, at its < 0.1 (:56-59): the XLA path rounds the
  activations to bf16 as well;
* where the reference rounds in its backward: rounding the f32 cotangent
  to bf16 before each transposed product (the other reading of a bf16 dot's
  VJP) misses the reference's dz by far (the port does not: it rounds each
  product's result only, as plain autograd does);
* ``unsupported_reason`` and the launch counters on CPU tensors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.nets import mlp as jnets
from svax.ops import decoder_mlp_pallas as jdmp
from svax_torch.ops import decoder_mlp

torch.set_num_threads(1)

VALUE_TOL, VALUE_SHARE, VALUE_FLIP = 1e-5, 5e-3, 1e-3
DZ_MAX, DZ_SHARE = 5e-3, 5e-3
GRAD_TOL = 2e-2
# (S, N, K, d, hidden, D, seed): the reference's default and multi-tile
# shapes, and a bigk-like latent (d = 10, K = 12).
SHAPES = {"small": (2, 40, 5, 3, 16, 24, 0), "multitile": (2, 300, 5, 3, 16, 24, 7),
          "d10k12": (1, 24, 12, 10, 16, 24, 3)}
NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def _inputs(s, n, k, d, dh, dd, seed):
    rng = np.random.default_rng(seed)
    params = [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32),
               "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
              for a, b in ((d, dh), (dh, dh), (dh, dd))]
    z = rng.standard_normal((s, n, k, d)).astype(np.float32)
    x = (rng.random((n, dd)) > 0.5).astype(np.float32)
    w = np.cos(np.arange(s * n * k, dtype=np.float32)).reshape(s, n, k)
    return params, z, x, w


@functools.lru_cache(maxsize=None)
def _jax(case):
    """The reference kernel (interpret mode): ll and the gradients of ⟨w, ll⟩."""
    params, z, x, w = _inputs(*SHAPES[case])
    jp = jax.tree.map(jnp.asarray, params)

    def loss(p, zz):
        return jnp.sum(w * jdmp.bernoulli_mlp_loglik_fused(p, zz, x, tile=128, interpret=True))

    ll = jdmp.bernoulli_mlp_loglik_fused(jp, jnp.asarray(z), x, tile=128, interpret=True)
    gp, gz = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(z))
    grads = {f"{name}{i + 1}": np.asarray(gp[i][name]) for i in range(3) for name in ("w", "b")}
    return np.asarray(ll), np.asarray(gz), grads


def _torch(case):
    params, z, x, w = _inputs(*SHAPES[case])
    tp = [{k_: torch.tensor(v, requires_grad=True) for k_, v in ly.items()} for ly in params]
    tz = torch.tensor(z, requires_grad=True)
    ll = decoder_mlp.bernoulli_mlp_loglik_fused(tp, tz, torch.tensor(x))
    g = torch.autograd.grad((torch.tensor(w) * ll).sum(), [tz] + [t for ly in tp for t in ly.values()])
    grads = {f"{name}{i + 1}": g[1 + 2 * i + j].numpy()
             for i in range(3) for j, name in enumerate(("w", "b"))}
    return ll.detach().numpy(), g[0].numpy(), grads


@pytest.mark.parametrize("case", list(SHAPES))
def test_values_match_the_reference_kernel(case):
    want, _, _ = _jax(case)
    got, _, _ = _torch(case)
    assert got.shape == want.shape == SHAPES[case][:3]
    miss = np.abs(got - want) > VALUE_TOL * (1.0 + np.abs(want))
    assert miss.mean() < VALUE_SHARE, miss.mean()
    np.testing.assert_allclose(got, want, rtol=VALUE_FLIP, atol=VALUE_FLIP)


@pytest.mark.parametrize("case", list(SHAPES))
def test_gradients_match_the_reference_kernel(case):
    _, want_z, want = _jax(case)
    _, got_z, got = _torch(case)
    err = np.abs(got_z - want_z)
    assert err.max() < DZ_MAX and (err > 1e-5).mean() < DZ_SHARE, (err.max(), (err > 1e-5).mean())
    for name in NAMES:
        scale = max(1.0, float(np.abs(want[name]).max()))
        assert np.abs(got[name] - want[name]).max() / scale < GRAD_TOL, name


class _RoundCotangent(torch.autograd.Function):
    """The identity, whose backward rounds the cotangent to bf16."""

    @staticmethod
    def forward(ctx, a):
        return a

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def test_the_reference_rounds_products_not_cotangents(monkeypatch):
    """JAX's transposed bf16 dot (preferred_element_type f32) takes the f32
    cotangent as it is and rounds only the product at the operand's cast —
    what autograd does over ``a.to(bf16).float() @ w.to(bf16).float()``.
    Rounding the cotangent first, the other reading, moves most dz entries."""
    _, want_z, _ = _jax("small")
    real = decoder_mlp._bf16_mm
    monkeypatch.setattr(decoder_mlp, "_bf16_mm",
                        lambda a, w: _RoundCotangent.apply(real(a, w)))
    _, got_z, _ = _torch("small")
    assert (np.abs(got_z - want_z) > 1e-5).mean() > 0.3  # 60% measured


def test_close_to_the_reference_xla_bf16_path():
    params, z, x, _ = _inputs(*SHAPES["small"])
    want = np.asarray(jnets.bernoulli_loglik_decomposed(
        jax.tree.map(jnp.asarray, params), z, x, compute_dtype=jnp.bfloat16))
    got = decoder_mlp.bernoulli_mlp_loglik_plain(
        [{k_: torch.tensor(v) for k_, v in ly.items()} for ly in params], torch.tensor(z),
        torch.tensor(x))
    assert float(np.abs(got.numpy() - want).max()) < 0.1


def test_unsupported_reason_gives_the_kernels_shape_class():
    def params(*sizes):
        return [{"w": torch.zeros(a, b), "b": torch.zeros(b)} for a, b in zip(sizes[:-1], sizes[1:])]

    assert decoder_mlp.unsupported_reason(params(10, 200, 200, 784), 10) is None
    assert decoder_mlp.unsupported_reason(params(16, 256, 1, 3), 16) is None
    assert "2 hidden layers" in decoder_mlp.unsupported_reason(params(10, 200, 784), 10)
    assert "2 hidden layers" in decoder_mlp.unsupported_reason(params(4, 8, 8, 8, 8), 4)
    assert "latent d = 17" in decoder_mlp.unsupported_reason(params(17, 8, 8, 8), 17)
    assert "hidden widths" in decoder_mlp.unsupported_reason(params(4, 257, 8, 8), 4)
    assert "tanh" in decoder_mlp.unsupported_reason(params(4, 8, 8, 8), 4, activation="relu")


def test_cpu_tensors_take_the_plain_version_and_never_launch():
    params, z, x, w = _inputs(*SHAPES["small"])
    tp = [{k_: torch.tensor(v, requires_grad=True) for k_, v in ly.items()} for ly in params]
    before = (decoder_mlp.launches, decoder_mlp.backward_launches)
    ll = decoder_mlp.bernoulli_mlp_loglik_fused(tp, torch.tensor(z), torch.tensor(x))
    (torch.tensor(w) * ll).sum().backward()
    assert (decoder_mlp.launches, decoder_mlp.backward_launches) == before
    assert torch.equal(ll, decoder_mlp.bernoulli_mlp_loglik_plain(tp, torch.tensor(z),
                                                                  torch.tensor(x)))
    with pytest.raises(ValueError, match="no kernel for device"):
        decoder_mlp.core_fused(*([torch.zeros(1, 2, 3, 4)] + [torch.zeros(1)] * 8))
