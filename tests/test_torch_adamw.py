"""The port's AdamW (``svae_step.make_train_step(weight_decay=...)``) against
the JAX step with ``optax.adamw``.

* the update alone, five AdamW updates on the same float32 gradients:
  params and both moments at rtol 1e-6 / atol 1e-7;
* five whole train steps from one converted state, with the reference's ε
  injected into both: NN params, Adam moments and the PGM naturals at
  rtol 1e-10 in float64, and in float32 at tests/test_torch_tinystep.py's
  f32 bars (the two packages' f32 gradients differ in summation order by
  ~1e-5 relative, which the second moments carry);
* the decay never touches the naturals: step 1's naturals with weight
  decay equal those without, bit for bit;
* ``weight_decay=0`` is the plain Adam step as it was, bit for bit (the
  update written out as the port computed it before AdamW);
* the per-step runner takes the decay, and neither whole-step kernel does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.data import make_pinwheel_data
from svax.models import svae as jsvae
from svax.models.svae import SvaeConfig as JConfig
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax_torch import convert
from svax_torch.models.svae import SvaeConfig
from svax_torch.train import loop, svae_step

torch.set_num_threads(1)
N, K, S, HIDDEN, LR, RHO, WD = 60, 4, 2, (12, 12), 1e-3, 0.1, 1e-3


class _InjectedEps:
    """svax.models.svae as make_train_step's ``model``, the batch carrying
    (x, ε)."""

    @staticmethod
    def forward(nn, nat, prior, batch, key, config, axis_comp=None):
        x, eps = batch
        return jsvae.forward(nn, nat, prior, x, key, config, eps=eps, axis_comp=axis_comp)


def _setup(dtype):
    x = jnp.asarray(make_pinwheel_data(num_classes=3, num_per_class=N // 3, seed=0)[:N],
                    dtype)
    jconfig = JConfig(latent_dim=2, num_components=K, num_samples=S, num_total=N,
                      nn_precision=jax.lax.Precision.HIGHEST)
    cast = lambda t: jax.tree.map(  # noqa: E731
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
    jprior = cast(jgmm.make_prior(K, 2, kappa=0.05))
    opt = optax.adamw(LR, weight_decay=WD)
    jstate = cast(jstep.init_state(jax.random.PRNGKey(0), 2, jconfig, jprior, opt, HIDDEN,
                                   HIDDEN, data=x))
    tdtype = torch.float64 if dtype == jnp.float64 else torch.float32
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate), dtype=tdtype)
    prior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior), dtype=tdtype)
    config = SvaeConfig(latent_dim=2, num_components=K, num_samples=S, num_total=N,
                        nn_precision="highest")
    np_dtype = np.float64 if dtype == jnp.float64 else np.float32
    eps = np.random.default_rng(7).standard_normal((5, S, N, K, 2)).astype(np_dtype)
    return dict(x=x, jconfig=jconfig, jprior=jprior, jstate=jstate, opt=opt, state=state,
                prior=prior, config=config, eps=eps, xt=torch.tensor(np.asarray(x)))


def _leaves(tree):
    return [t for side in tree.values() for ly in side for t in ly.values()]


# tests/test_torch_tinystep.py's float32 bars: (rtol, atol) per group.
F32_TOL = {"params": (5e-4, 5e-5), "mu": (5e-4, 5e-6), "nu": (5e-4, 1e-8),
           "nat": (2e-5, 2e-5)}
F64_TOL = {g: (1e-10, 1e-12) for g in F32_TOL}


def test_adamw_update_matches_optax_on_the_same_gradients():
    rng = np.random.default_rng(11)
    shapes = {"encoder": [(2, 12), (12,), (12, 4), (4,)], "decoder": [(2, 12), (12,)]}
    tree = lambda: {side: [{"w": rng.standard_normal(s[0]).astype(np.float32),  # noqa: E731
                            "b": rng.standard_normal(s[1]).astype(np.float32)}
                           for s in zip(sh[::2], sh[1::2])]
                    for side, sh in shapes.items()}
    params = tree()
    grads = [tree() for _ in range(5)]
    opt = optax.adamw(LR, weight_decay=WD)
    jp = jax.tree.map(jnp.asarray, params)
    jo = opt.init(jp)
    tp = svae_step.map_params(torch.tensor, params)
    to = svae_step.adam_init(tp)
    for g in grads:
        upd, jo = opt.update(jax.tree.map(jnp.asarray, g), jo, jp)
        jp = optax.apply_updates(jp, upd)
        tp, to = svae_step.adam_update(svae_step.map_params(torch.tensor, g), to, tp, LR, WD)
    for got, want in ((tp, jp), (to.mu, jo[0].mu), (to.nu, jo[0].nu)):
        for side in got:
            for gl, wl in zip(got[side], want[side]):
                for key in ("w", "b"):
                    np.testing.assert_allclose(gl[key].numpy(), np.asarray(wl[key]),
                                               rtol=1e-6, atol=1e-7)
    assert to.count == int(jo[0].count) == 5


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32_TOL), (jnp.float64, F64_TOL)])
def test_adamw_matches_optax_adamw(dtype, tol):
    c = _setup(dtype)
    jstep_fn = jax.jit(jstep.make_train_step(c["jconfig"], c["jprior"], c["opt"], RHO,
                                             model=_InjectedEps))
    step = svae_step.make_train_step(c["config"], c["prior"], LR, RHO, weight_decay=WD)
    jst, st = c["jstate"], c["state"]
    for t in range(5):
        jst, _ = jstep_fn(jst, (c["x"], jnp.asarray(c["eps"][t])), jax.random.PRNGKey(0))
        st, _ = step(st, c["xt"], eps=torch.tensor(c["eps"][t]))
    got, want = convert.state_to_numpy(st), jax.tree.map(np.asarray, jst)
    adam = want.opt_state[0]
    for name, g, w in (("params", got["nn_params"], want.nn_params),
                       ("mu", got["adam"]["mu"], adam.mu), ("nu", got["adam"]["nu"], adam.nu)):
        rtol, atol = tol[name]
        for side in ("encoder", "decoder"):
            for gl, wl in zip(g[side], w[side]):
                for key in ("w", "b"):
                    np.testing.assert_allclose(gl[key], wl[key], rtol=rtol, atol=atol,
                                               err_msg=f"{name} {side} {key}")
    rtol, atol = tol["nat"]
    np.testing.assert_allclose(got["pgm_nat"]["dir_nat"], want.pgm_nat.dir_nat, rtol=rtol,
                               atol=atol)
    for f in ("eta1", "eta2", "eta3", "eta4"):
        np.testing.assert_allclose(got["pgm_nat"][f], getattr(want.pgm_nat.niw_nat, f),
                                   rtol=rtol, atol=atol, err_msg=f)
    assert got["adam"]["count"] == int(adam.count) == 5
    # The decay acted: plain Adam from the same state lands elsewhere.
    plain = svae_step.make_train_step(c["config"], c["prior"], LR, RHO)
    st0 = c["state"]
    for t in range(5):
        st0, _ = plain(st0, c["xt"], eps=torch.tensor(c["eps"][t]))
    assert not torch.equal(st0.nn_params["decoder"][0]["w"], st.nn_params["decoder"][0]["w"])


def test_weight_decay_leaves_the_naturals_alone():
    c = _setup(jnp.float32)
    eps = torch.tensor(c["eps"][0])
    decayed, _ = svae_step.make_train_step(c["config"], c["prior"], LR, RHO,
                                           weight_decay=0.5)(c["state"], c["xt"], eps=eps)
    plain, _ = svae_step.make_train_step(c["config"], c["prior"], LR, RHO)(
        c["state"], c["xt"], eps=eps)
    for a, b in zip([decayed.pgm_nat.dir_nat, *decayed.pgm_nat.niw_nat],
                    [plain.pgm_nat.dir_nat, *plain.pgm_nat.niw_nat]):
        assert torch.equal(a, b)
    assert not torch.equal(decayed.nn_params["encoder"][0]["w"],
                           plain.nn_params["encoder"][0]["w"])
    # The moments see the gradient only.
    for a, b in zip(_leaves(decayed.opt_state.mu), _leaves(plain.opt_state.mu)):
        assert torch.equal(a, b)


def _adam_as_before(grads, opt, params, lr):
    """The port's Adam update before AdamW, operation for operation."""
    count = opt.count + 1
    flat = lambda tree: [t for side in tree.values() for ly in side for t in ly.values()]  # noqa: E731
    g, m, v, p = flat(grads), flat(opt.mu), flat(opt.nu), flat(params)
    mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - svae_step.B1),
                            torch._foreach_mul(m, svae_step.B1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, 1.0 - svae_step.B2), g),
                            torch._foreach_mul(v, svae_step.B2))
    step = torch._foreach_div(mu, 1.0 - svae_step.B1**count)
    denom = torch._foreach_add(torch._foreach_sqrt(
        torch._foreach_div(nu, 1.0 - svae_step.B2**count)), svae_step.ADAM_EPS)
    step = torch._foreach_mul(torch._foreach_div(step, denom), lr)
    return torch._foreach_sub(p, step), mu, nu


def test_zero_weight_decay_is_the_adam_step_bit_for_bit():
    c = _setup(jnp.float32)
    params, opt = c["state"].nn_params, c["state"].opt_state
    gen = torch.Generator().manual_seed(3)
    grads = svae_step.map_params(lambda t: torch.randn(t.shape, generator=gen), params)
    for _ in range(3):
        want_p, want_m, want_v = _adam_as_before(grads, opt, params, LR)
        params, opt = svae_step.adam_update(grads, opt, params, LR, 0.0)
        for got, want in ((_leaves(params), want_p), (_leaves(opt.mu), want_m),
                          (_leaves(opt.nu), want_v)):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    # And through the train step: weight_decay=0 is the default.
    eps = torch.tensor(c["eps"][0])
    a, _ = svae_step.make_train_step(c["config"], c["prior"], LR, RHO, weight_decay=0.0)(
        c["state"], c["xt"], eps=eps)
    b, _ = svae_step.make_train_step(c["config"], c["prior"], LR, RHO)(
        c["state"], c["xt"], eps=eps)
    assert all(torch.equal(p, q) for p, q in zip(_leaves(a.nn_params), _leaves(b.nn_params)))


def test_step_runner_trains_adamw_and_the_kernels_refuse_it():
    c = _setup(jnp.float32)
    runner = loop.make_step_runner(c["config"], c["prior"], lr=LR, rho=RHO,
                                   weight_decay=WD)
    eps = torch.tensor(c["eps"][:2])
    got, _ = runner(c["state"], c["xt"], 2, eps=eps)
    step = svae_step.make_train_step(c["config"], c["prior"], LR, RHO, weight_decay=WD)
    want = c["state"]
    for t in range(2):
        want, _ = step(want, c["xt"], eps=eps[t])
    assert all(torch.equal(p, q) for p, q in zip(_leaves(got.nn_params),
                                                 _leaves(want.nn_params)))
    gate = dict(batch_full=True, encoder_hidden=(50, 50), decoder_hidden=(50, 50), rho=RHO,
                input_dim=2, weight_decay=WD)
    assert loop.choose_kernel(c["config"], engine="auto", **gate) == loop.PER_STEP
    assert loop.kernel_unsupported_reason(c["config"], **gate) == loop.PLAIN_ADAM
    assert loop.choose_kernel(c["config"], engine="auto",
                              **dict(gate, weight_decay=0.0)) == "tinystep"
