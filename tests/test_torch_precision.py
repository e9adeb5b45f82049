"""The port's nn precision (``nets.mlp``'s table) and the kernel gates.

JAX on the CPU computes ``Precision.DEFAULT`` dots in f32 (its DEFAULT and
HIGHEST agree there), so the port's "default" — single-pass bf16 products,
as the reference's DEFAULT on a TPU — is held twice:

* exactly, against an emulation: every product's operands rounded to bf16
  by ``ml_dtypes`` (round to nearest even) in numpy, then the same f32
  product; the backward's transposed products take the rounded cotangent
  (and the emulation shows that autograd through casts would not);
* within a bf16-level bound (stated per test) of the JAX package at
  HIGHEST, and visibly apart from the port's own f32 ("highest").

Then the mapping into the kernels: the row sum under ``fused_decoder``
("high" and "default" → its bf16-operand mode, "highest" → f32, as
``decoder_pallas._kernel_precision``), tinystep's and flexstep's product
mode ("default" → bf16 products, else f32) through ``loop.make_runner``;
and ``choose_kernel`` against ``tinystep_pallas.supported`` and
``flexstep_pallas.supported`` over a grid of configs — with one recorded
exception: the reference's tinystep gate omits the activation, which its
tanh-only ``_mlp3`` needs (ROADMAP.md queue 3).
"""

import itertools
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from svax.models import svae as jsvae
from svax.models.svae import SvaeConfig as JConfig
from svax.nets import mlp as jnets
from svax.ops import flexstep_pallas as fsp
from svax.ops import tinystep_pallas as tsp
from svax.pgm import gmm as jgmm
from svax_torch.models import svae
from svax_torch.models.svae import SvaeConfig
from svax_torch.nets import mlp as nets
from svax_torch.ops import decoder, flexstep, tinystep
from svax_torch.pgm import gmm
from svax_torch.train import loop, svae_step

torch.set_num_threads(1)
HI = jax.lax.Precision.HIGHEST


def _bf16(a: np.ndarray) -> np.ndarray:
    """numpy's emulation of the rounding: ml_dtypes' bfloat16 (RNE)."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _mlp_params(rng, sizes, scale=0.5):
    return [{"w": (scale * rng.standard_normal((i, o))).astype(np.float32),
             "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])]


def _torch(params, grad=False):
    return [{k: torch.tensor(v, requires_grad=grad) for k, v in ly.items()} for ly in params]


def test_bf16_round_is_ml_dtypes_rounding():
    """Every float32 class — ties at both parities, subnormals, ±0, ±inf,
    large and tiny — rounds as ml_dtypes' RNE cast: bit for bit."""
    rng = np.random.default_rng(0)
    ties = (np.arange(1, 200, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    scaled = (rng.standard_normal(4000) * 10.0 ** rng.integers(-40, 38, 4000)).astype(np.float32)
    x = np.concatenate([scaled, ties, -ties,
                        np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, 3.4e38], np.float32)])
    got = nets.bf16_round(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _bf16(x).view(np.uint32))


@pytest.mark.parametrize("shape_a,shape_b", [((7, 13), (13, 5)), ((2, 3, 6, 9), (9, 4)),
                                             ((5, 3, 8), (5, 8, 1)), ((11,), (11, 3))])
def test_default_product_forward_and_backward_are_the_emulation(shape_a, shape_b):
    """``dot(a, b, "default")`` is the f32 product of the ml_dtypes-rounded
    operands, and its backward is ā = round(ȳ)·round(b)ᵀ, b̄ = round(a)ᵀ·round(ȳ)
    summed over broadcast axes: exactly (the same f32 products)."""
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal(s).astype(np.float32) for s in (shape_a, shape_b))
    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    y = nets.dot(ta, tb, "default")
    assert torch.equal(y, torch.tensor(_bf16(a)) @ torch.tensor(_bf16(b)))
    ybar = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    abar, bbar = torch.autograd.grad(y, (ta, tb), torch.tensor(ybar))
    yr, ar, br = (torch.tensor(_bf16(v)) for v in (ybar, a, b))
    if a.ndim == 1:
        want_a = (yr[None] @ br.mT)[0]
        want_b = ar[:, None] @ yr[None]
    else:
        want_a = (yr @ br.mT).sum_to_size(a.shape)
        want_b = (ar.reshape(-1, a.shape[-1]).mT @ yr.reshape(-1, yr.shape[-1])
                  if b.ndim == 2 else (ar.mT @ yr).sum_to_size(b.shape))
    assert torch.equal(abar, want_a) and torch.equal(bbar, want_b)
    # Autograd through the casts would round the products' results instead.
    ta2, tb2 = (torch.tensor(v, requires_grad=True) for v in (a, b))
    cast = nets.bf16_round(ta2) @ nets.bf16_round(tb2)
    abar_cast, _ = torch.autograd.grad(cast, (ta2, tb2), torch.tensor(ybar))
    assert not torch.equal(abar_cast, abar)


def test_highest_and_high_are_f32_products():
    rng = np.random.default_rng(2)
    a, b = torch.tensor(rng.standard_normal((6, 7))), torch.tensor(rng.standard_normal((7, 3)))
    for p in ("highest", "high"):
        assert torch.equal(nets.dot(a, b, p), a @ b)
    with pytest.raises(ValueError, match="precision"):
        nets.dot(a, b, "bf16")


def _emulated_mlp(params, x):
    """The tanh MLP at DEFAULT: each layer's operands rounded in numpy, then
    the f32 product (torch's, to share the summation order)."""
    h = x
    for i, ly in enumerate(params):
        h = (torch.tensor(_bf16(h)) @ torch.tensor(_bf16(ly["w"]))).numpy() + ly["b"]
        if i < len(params) - 1:
            h = torch.tanh(torch.tensor(h)).numpy()
    return h


def test_default_mlp_forward_is_the_emulation_and_near_jax_highest():
    """The encoder at "default": the emulation bit for bit; JAX at HIGHEST
    within 2e-2 of the largest output (two 16-wide layers of bf16 operands:
    each rounding is within 2⁻⁹ relative), and the port's "highest" output
    differs from it by more than 1e-5."""
    rng = np.random.default_rng(3)
    params = _mlp_params(rng, [5, 16, 16, 8])
    x = rng.standard_normal((40, 5)).astype(np.float32)
    got = nets.mlp_apply(_torch(params), torch.tensor(x), "tanh", "default").numpy()
    np.testing.assert_array_equal(got, _emulated_mlp(params, x))
    want = np.asarray(jnets.mlp_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                      precision=HI))
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    f32 = nets.mlp_apply(_torch(params), torch.tensor(x), "tanh", "highest").numpy()
    np.testing.assert_allclose(f32, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got - f32).max() > 1e-5


def test_default_mlp_gradients_take_rounded_cotangents():
    """The weight gradients of a 2-layer MLP at "default" against the
    operand-rounding emulation of its backward, bit for bit."""
    rng = np.random.default_rng(4)
    params = _mlp_params(rng, [4, 12, 3])
    x = rng.standard_normal((30, 4)).astype(np.float32)
    gout = rng.standard_normal((30, 3)).astype(np.float32)
    tp = _torch(params, grad=True)
    out = nets.mlp_apply(tp, torch.tensor(x), "tanh", "default")
    g = torch.autograd.grad(out, [tp[0]["w"], tp[1]["w"], tp[0]["b"]], torch.tensor(gout))
    w1 = torch.tensor(params[1]["w"])
    a1 = torch.tanh(torch.tensor(_bf16(x)) @ torch.tensor(_bf16(params[0]["w"]))
                    + torch.tensor(params[0]["b"]))
    gr = torch.tensor(_bf16(gout))
    want_w1 = torch.tensor(_bf16(a1.numpy())).T @ gr
    ga1 = gr @ torch.tensor(_bf16(w1.numpy())).T
    g1 = ga1 * (1.0 - a1 * a1)  # the tanh backward is elementwise, in f32
    want_w0 = torch.tensor(_bf16(x)).T @ torch.tensor(_bf16(g1.numpy()))
    assert torch.equal(g[1], want_w1) and torch.equal(g[0], want_w0)
    # A bias's gradient is the f32 cotangent's sum (autograd sums in its own
    # order): 1e-6 relative.
    torch.testing.assert_close(g[2], g1.sum(0), rtol=1e-6, atol=1e-6)


def test_forward_at_default_is_near_jax_highest():
    """A pinwheel-size SVAE forward (d = 2, K = 4, S = 2, 16-16) at
    nn_precision "default" against JAX at HIGHEST: the ELBO within 1e-2
    relative, and apart from the port's "high" (f32) forward, which equals
    JAX within 1e-5."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((48, 2)).astype(np.float32)
    k, s = 4, 2
    jconfig = JConfig(latent_dim=2, num_components=k, num_samples=s, num_total=48,
                      nn_precision=HI)
    from svax.train import svae_step as jstep
    import optax

    jprior = jgmm.make_prior(k, 2, kappa=0.05)
    jstate = jstep.init_state(jax.random.PRNGKey(0), 2, jconfig, jprior, optax.adam(1e-3),
                              (16, 16), (16, 16), data=jnp.asarray(x))
    from svax_torch import convert

    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate), dtype=torch.float32)
    prior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior), dtype=torch.float32)
    eps = rng.standard_normal((s, 48, k, 2)).astype(np.float32)
    want = float(jsvae.forward(jstate.nn_params, jstate.pgm_nat, jprior, jnp.asarray(x),
                               jax.random.PRNGKey(0), jconfig, eps=jnp.asarray(eps)).elbo)
    outs = {}
    for p in ("default", "high"):
        config = SvaeConfig(latent_dim=2, num_components=k, num_samples=s, num_total=48,
                            nn_precision=p)
        outs[p] = float(svae.forward(state.nn_params, state.pgm_nat, prior, torch.tensor(x),
                                     config, eps=torch.tensor(eps)).elbo)
    assert abs(outs["high"] - want) <= 1e-5 * abs(want)
    assert abs(outs["default"] - want) <= 1e-2 * abs(want)
    assert outs["default"] != outs["high"]


@pytest.mark.parametrize("precision,mode", [("highest", "highest"), ("high", "default"),
                                            ("default", "default")])
def test_fused_decoder_row_sum_mode_follows_kernel_precision(precision, mode):
    """``SvaeConfig.nn_precision`` through ``fused_decoder`` reaches the row
    sum in the mode ``_kernel_precision`` maps it to: its output equals the
    row sum called at that mode, bit for bit."""
    rng = np.random.default_rng(6)
    config = SvaeConfig(latent_dim=3, num_components=3, num_samples=1, num_total=16,
                        likelihood="bernoulli", fused_decoder=True, nn_precision=precision)
    prior = gmm.make_prior(3, 3, kappa=0.05)
    state = svae_step.init_state(torch.Generator().manual_seed(0), 12, config, prior,
                                 (8, 8), (8, 8))
    x = torch.tensor((rng.random((16, 12)) < 0.4).astype(np.float32))
    eps = torch.tensor(rng.standard_normal((1, 16, 3, 3)).astype(np.float32))
    seen = []
    real = decoder.rowsum_logsig_neg_plain
    with mock.patch.object(decoder, "rowsum_logsig_neg_plain",
                           lambda *a: seen.append(decoder._bf16_mode(a[-1])) or real(*a)):
        out = svae.forward(state.nn_params, state.pgm_nat, prior, x, config, eps=eps)
    assert seen == [mode != "highest"] and torch.isfinite(out.elbo)


@pytest.mark.parametrize("nn_precision,bf16", [("highest", False), ("high", False),
                                               ("default", True)])
def test_whole_step_kernels_take_the_mapped_precision(nn_precision, bf16):
    """``loop.make_runner`` hands tinystep and flexstep the config's
    nn_precision; "default" is their bf16-product mode, anything else f32
    (the reference's map where Mosaic has no HIGH)."""
    assert tinystep.bf16_mode(nn_precision) == bf16
    seen = {}
    config = SvaeConfig(latent_dim=2, num_components=3, num_samples=1, num_total=24,
                        nn_precision=nn_precision)
    prior = gmm.make_prior(3, 2, kappa=0.05)
    state = svae_step.init_state(torch.Generator().manual_seed(0), 2, config, prior,
                                 (16, 16), (16, 16))
    x = torch.randn(24, 2, generator=torch.Generator().manual_seed(1))
    for name, mod in (("tinystep", tinystep), ("flexstep", flexstep)):
        real = mod.train_chunk_plain
        with mock.patch.object(mod, "train_chunk_plain",
                               lambda *a, _n=name, _r=real, **kw: seen.__setitem__(
                                   _n, kw["nn_precision"]) or _r(*a, **kw)):
            runner = loop.make_runner(config, prior, lr=1e-3, rho=0.1, kernel=name,
                                      batch_size=8)
            runner(state, x, 1, seed=0)
    assert seen == {"tinystep": nn_precision, "flexstep": nn_precision}


def test_plain_step_chunks_differ_by_mode():
    """tinystep's and flexstep's plain versions run the step at their
    ``nn_precision``: "default" moves the parameters otherwise than f32."""
    config = SvaeConfig(latent_dim=2, num_components=3, num_samples=2, num_total=30)
    prior = gmm.make_prior(3, 2, kappa=0.05)
    state = svae_step.init_state(torch.Generator().manual_seed(0), 2, config, prior,
                                 (16, 16), (16, 16))
    x = torch.randn(30, 2, generator=torch.Generator().manual_seed(2))
    kw = dict(lr=1e-3, rho=0.1, t_steps=2, num_samples=2, seed=3)
    a, _ = tinystep.train_chunk_plain(state, prior, x, nn_precision="default", **kw)
    b, _ = tinystep.train_chunk_plain(state, prior, x, nn_precision="high", **kw)
    c, _ = tinystep.train_chunk_plain(state, prior, x, nn_precision="highest", **kw)
    w = lambda s: s.nn_params["decoder"][1]["w"]  # noqa: E731
    assert torch.equal(w(b), w(c)) and not torch.equal(w(a), w(c))
    with pytest.raises(ValueError, match="nn_precision"):
        tinystep.train_chunk_plain(state, prior, x, nn_precision="bf16", **kw)


# ------------------------------------------------------------ the kernel gates

_ACTS = {"tanh": jnp.tanh, "relu": jax.nn.relu}


def _gate_grid():
    return itertools.product(("weighted", "sampled"), ("diag", "full"), (0.0, 1e-3),
                             ("tanh", "relu"), (2, 4), ((16, 16), (50, 50)), (True, False),
                             (0.0, 1e-3))


def test_choose_kernel_agrees_with_the_reference_gates():
    """Over recon mode × head × jitter × activation × latent d × widths ×
    full batch × ρ decay (shapes inside the port's classes): the port picks
    tinystep exactly where ``tinystep_pallas.supported`` does and the
    activation is tanh (the reference's gate omits it: a recorded fault),
    else flexstep exactly where ``flexstep_pallas.supported`` does, else the
    per-step engine; ``--engine megakernel`` raises where neither fits."""
    for recon, head, jitter, act, d, hidden, batch_full, decay in _gate_grid():
        jconfig = JConfig(latent_dim=d, num_components=10, recon_mode=recon,
                          encoder_head=head, jitter=jitter, activation=_ACTS[act])
        config = SvaeConfig(latent_dim=d, num_components=10, recon_mode=recon,
                            encoder_head=head, jitter=jitter, activation=act)
        tiny = decay == 0.0 and act == "tanh" and tsp.supported(
            jconfig, batch_full=batch_full, encoder_hidden=hidden, decoder_hidden=hidden,
            rho=0.1)
        flex = fsp.supported(jconfig, d_in=2, encoder_hidden=hidden, decoder_hidden=hidden)
        want = "tinystep" if tiny else ("flexstep" if flex else loop.PER_STEP)
        gate = dict(batch_full=batch_full, encoder_hidden=hidden, decoder_hidden=hidden,
                    rho=0.1, rho_decay=decay, input_dim=2)
        assert loop.choose_kernel(config, engine="auto", **gate) == want, (
            recon, head, jitter, act, d, hidden, batch_full, decay)
        if want == loop.PER_STEP:
            with pytest.raises(ValueError, match="fits neither kernel"):
                loop.choose_kernel(config, engine="megakernel", **gate)


def test_reference_tinystep_gate_omits_the_activation():
    """The recorded reference fault: ``tinystep_pallas.supported`` accepts a
    ReLU config that its tanh-only ``_mlp3`` would train with tanh; the
    port's gate refuses it."""
    gate = dict(batch_full=True, encoder_hidden=(50, 50), decoder_hidden=(50, 50), rho=0.1)
    assert tsp.supported(JConfig(latent_dim=2, num_components=10, activation=jax.nn.relu),
                         **gate)
    reason = loop.tinystep_unsupported_reason(
        SvaeConfig(latent_dim=2, num_components=10, activation="relu"), **gate)
    assert reason is not None and "tanh" in reason


def test_bf16_mode_smem_budgets_fit_at_the_default_cluster():
    """The bf16-product mode keeps its slice's f32 master beside the Adam
    moments: one more slice a CTA, within the 227 KB for every shape either
    kernel accepts at the cluster size it runs at."""
    c16 = tinystep.DEFAULT_CLUSTER
    for (h1, h2), k in itertools.product(tinystep.SUPPORTED_HIDDEN,
                                         range(1, tinystep.MAX_COMPONENTS + 1)):
        bf16 = tinystep.smem_bytes(h1, h2, k, c16, bf16=True)
        assert bf16 <= tinystep.SMEM_LIMIT
        p = 2 * (3 * h1 + h1 * h2 + h2 + 4 * h2 + 4)
        assert bf16 - tinystep.smem_bytes(h1, h2, k, c16) == 4 * (-(-(-(-p // c16)) // 4) * 4)
    top = flexstep.smem_bytes(8, 6, 64, 128, 128, 128, 128, c16, bf16=True)
    assert top <= flexstep.SMEM_LIMIT
    assert flexstep.smem_bytes(8, 6, 64, 128, 128, 128, 128, 8, bf16=True) > flexstep.SMEM_LIMIT
