"""The port's flexstep module against the JAX reference.

* ``flexstep.train_chunk`` on CPU tensors (its plain version) against T
  explicit XLA steps of the reference at injected ε and a fixed batch stack
  (the ``_oracle_steps`` mirror of tests/test_flexstep_kernel.py), float32,
  at that file's tolerances: the auto shape class scaled down, a d = 3 case
  and a full-batch case;
* ``step_grads_manual`` (the backward the CUDA kernel transcribes) against
  autograd of the plain forward, float64, rtol 1e-9, d ∈ {2, 3, 4, 6};
* ``expected_slots`` (the kernel's expected-parameter map) against
  ``gmm.expected_params``;
* the wrapper's routing and its shape gate. The CUDA kernel itself is
  tested on the card by tests/test_torch_cuda_flexstep.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.models import svae as jsvae
from svax.models.svae import SvaeConfig as JConfig
from svax.pgm import gmm as jgmm
from svax.pgm import natgrad as jnatgrad
from svax.train import svae_step as jstep
from svax_torch import convert
from svax_torch.models import svae
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import flexstep
from svax_torch.pgm import gmm
from svax_torch.train import svae_step

torch.set_num_threads(1)

# tests/test_flexstep_kernel.py's float32 bars: (rtol, atol).
TOL = {"params": (5e-4, 5e-5), "mu": (5e-4, 1e-5), "nat": (5e-4, 5e-4)}
MET_TOL = {"recon": 2e-3, "local_kl": 2e-3, "neg_loss": 1e-4, "rho": 1e-6}


def _setup(n=96, m=24, d_in=5, d_lat=3, k=4, s=2, hidden=(16, 16), lr=3e-3, seed=0,
           dtype=jnp.float32):
    kx, kinit = jax.random.split(jax.random.PRNGKey(seed))
    x = jax.random.normal(kx, (n, d_in), dtype)
    config = JConfig(latent_dim=d_lat, num_components=k, num_samples=s, num_total=n,
                     nn_precision=jax.lax.Precision.HIGHEST)
    cast = lambda t: jax.tree.map(  # noqa: E731
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
    prior = cast(jgmm.make_prior(k, d_lat, kappa=0.05))
    opt = optax.adam(lr)
    state = cast(jstep.init_state(kinit, d_in, config, prior, opt,
                                  encoder_hidden=hidden, decoder_hidden=hidden, data=x))
    return x, config, prior, opt, state, m


def _oracle_steps(state, prior, batches, eps_all, config, opt, rho0, rho_decay):
    """T explicit XLA steps at the injected eps (mirrors make_train_step)."""

    def loss_fn(nn_params, pgm_nat, xb, eps):
        out = jsvae.forward(nn_params, pgm_nat, prior, xb, jax.random.PRNGKey(0), config,
                            eps=eps)
        return -(out.recon - out.local_kl) / config.num_total, out

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    metrics = {"recon": [], "local_kl": [], "neg_loss": [], "rho": []}
    for t in range(eps_all.shape[0]):
        (loss, out), grads = grad_fn(state.nn_params, state.pgm_nat, batches[t], eps_all[t])
        updates, opt_state = opt.update(grads, state.opt_state, state.nn_params)
        nn_params = optax.apply_updates(state.nn_params, updates)
        inc = jgmm.stats_to_nat(out.suff_stats)
        rho_t = rho0 / (1.0 + rho_decay * float(state.step))
        pgm_nat = jnatgrad.cvi_update(state.pgm_nat, prior, inc, rho_t)
        state = jstep.SvaeTrainState(nn_params=nn_params, opt_state=opt_state,
                                     pgm_nat=pgm_nat, step=state.step + 1)
        metrics["recon"].append(float(out.recon))
        metrics["local_kl"].append(float(out.local_kl))
        metrics["neg_loss"].append(float(loss))
        metrics["rho"].append(rho_t)
    return state, metrics


def _port(jtree, dtype=torch.float32):
    return convert.state_from_numpy(jax.tree.map(np.asarray, jtree), dtype=dtype)


def _assert_state_close(state, jstate):
    got = convert.state_to_numpy(state)
    want = jax.tree.map(np.asarray, jstate)
    adam = want.opt_state[0]
    for name, g, w in (("params", got["nn_params"], want.nn_params),
                       ("mu", got["adam"]["mu"], adam.mu)):
        rtol, atol = TOL[name]
        for side in ("encoder", "decoder"):
            for gl, wl in zip(g[side], w[side]):
                for key in ("w", "b"):
                    np.testing.assert_allclose(gl[key], wl[key], rtol=rtol, atol=atol,
                                               err_msg=f"{name} {side} {key}")
    rtol, atol = TOL["nat"]
    np.testing.assert_allclose(got["pgm_nat"]["dir_nat"], want.pgm_nat.dir_nat,
                               rtol=rtol, atol=atol)
    for f in ("eta1", "eta2", "eta3", "eta4"):
        np.testing.assert_allclose(got["pgm_nat"][f], getattr(want.pgm_nat.niw_nat, f),
                                   rtol=rtol, atol=atol, err_msg=f)
    assert got["adam"]["count"] == int(adam.count)
    assert got["step"] == int(want.step)


CASES = {
    # The BASELINE config-#3 shape class scaled down: d_in=8, d=4, ρ decay,
    # K not a multiple of 8 (test_flexstep_kernel.test_auto_shape_class).
    "auto": dict(t_steps=3, rho0=0.2, rho_decay=1e-3, seed=3,
                 shape=dict(n=80, m=32, d_in=8, d_lat=4, k=5, s=2)),
    "d3": dict(t_steps=3, rho0=0.2, rho_decay=0.0, seed=0, shape=dict()),
    "full_batch": dict(t_steps=2, rho0=0.3, rho_decay=0.0, seed=5,
                       shape=dict(n=64, m=64), full=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_chunk_matches_xla_steps(case):
    c = CASES[case]
    x, config, prior, opt, state, m = _setup(seed=c["seed"], **c["shape"])
    n = x.shape[0]
    t = c["t_steps"]
    rng = np.random.default_rng(c["seed"] + 1)
    if c.get("full"):
        batches = jnp.broadcast_to(x, (t,) + x.shape)
    else:
        batches = x[jnp.asarray(rng.integers(0, n, size=(t, m)))]
    eps = rng.standard_normal((t, config.num_samples, m, config.num_components,
                               config.latent_dim)).astype(np.float32)
    before = flexstep.launches
    st, mets = flexstep.train_chunk(
        _port(state), convert.gmm_nat_from_numpy(prior), torch.tensor(np.asarray(batches)),
        lr=3e-3, rho=c["rho0"], rho_decay=c["rho_decay"], num_total=n,
        eps=torch.tensor(eps))
    assert flexstep.launches == before  # CPU tensors take the plain version
    jst, jmets = _oracle_steps(state, prior, batches, jnp.asarray(eps), config, opt,
                               c["rho0"], c["rho_decay"])
    _assert_state_close(st, jst)
    for key, tol in MET_TOL.items():
        np.testing.assert_allclose(mets[key].numpy(), np.asarray(jmets[key]), rtol=tol,
                                   atol=tol, err_msg=key)


@pytest.mark.parametrize("d,k", [(2, 1), (3, 5), (4, 10), (6, 3)])
def test_step_grads_manual_matches_autograd(d, k):
    d_in, m, s, n = 8 if d >= 4 else d + 2, 11, 3, 40
    gen = torch.Generator().manual_seed(d)
    config = SvaeConfig(latent_dim=d, num_components=k, num_samples=s, num_total=n)
    prior = gmm.make_prior(k, d, kappa=0.05, dtype=torch.float64)
    state = svae_step.init_state(gen, d_in, config, prior, (12, 9), (10, 7))
    x = torch.randn(m, d_in, generator=gen, dtype=torch.float64)
    eps = torch.randn(s, m, k, d, generator=gen, dtype=torch.float64)
    grads, aux = flexstep.step_grads_manual(state.nn_params, state.pgm_nat, x, eps,
                                            num_total=n)

    params = svae_step.map_params(lambda p: p.clone().requires_grad_(True), state.nn_params)
    out = svae.forward(params, state.pgm_nat, prior, x, config, eps=eps)
    neg_loss = -(out.recon - out.local_kl) / n
    leaves = [t for side in params.values() for ly in side for t in ly.values()]
    want = torch.autograd.grad(neg_loss, leaves)
    got = [t for side in grads.values() for ly in side for t in ly.values()]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(float(aux["recon"]), float(out.recon.detach()), rtol=1e-9)
    np.testing.assert_allclose(float(aux["local_kl"]), float(out.local_kl.detach()),
                               rtol=1e-9)
    np.testing.assert_allclose(float(aux["neg_loss"]), float(neg_loss.detach()), rtol=1e-9)
    stats = gmm.GmmSuffStats(*(t.detach() for t in out.suff_stats))
    np.testing.assert_allclose(aux["counts"].numpy(), stats.counts.numpy(), rtol=1e-9)
    np.testing.assert_allclose(aux["s1"].numpy(), stats.mean_stat.numpy(), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(aux["s2"].numpy(), stats.scatter_stat.numpy(), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("d", [2, 4, 6])
def test_expected_slots_match_gmm(d):
    """The kernel's expected-parameter map, ψ by its recurrence, agrees
    with gmm.expected_params (torch.special.digamma)."""
    gen = torch.Generator().manual_seed(d)
    prior = gmm.make_prior(7, d, kappa=0.05, dtype=torch.float64)
    nat = gmm.init_variational(gen, prior, pseudo_counts=3.0)
    e, ref = flexstep.expected_slots(nat), gmm.expected_params(nat)
    tol = dict(rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(e[:, 0].numpy(), ref.log_pi.numpy(), **tol)
    np.testing.assert_allclose(e[:, 1].numpy(), ref.logdet.numpy(), **tol)
    np.testing.assert_allclose(e[:, 2].numpy(), ref.quad.numpy(), **tol)
    np.testing.assert_allclose(e[:, 3:3 + d].numpy(), ref.prec_mean.numpy(), **tol)
    np.testing.assert_allclose(e[:, 3 + d:].reshape(7, d, d).numpy(), ref.prec.numpy(),
                               **tol)
    back = flexstep.unpack_nat(flexstep.pack_nat(nat), d)
    for a, b in zip([back.dir_nat, *back.niw_nat], [nat.dir_nat, *nat.niw_nat]):
        assert torch.equal(a, b)


def _torch_state(d=4, d_in=8, k=10, hidden=((100, 100), (100, 100)), layers=2):
    gen = torch.Generator().manual_seed(0)
    config = SvaeConfig(latent_dim=d, num_components=k, num_samples=4, num_total=100)
    prior = gmm.make_prior(k, d)
    state = svae_step.init_state(gen, d_in, config, prior, hidden[0][:layers],
                                 hidden[1][:layers])
    return state, prior


def test_unsupported_reason():
    state, prior = _torch_state()
    assert flexstep.unsupported_reason(state.nn_params, prior, (3, 64, 8), 4) is None
    assert "d_in" in flexstep.unsupported_reason(state.nn_params, prior, (3, 64, 9), 4)
    s7, p7 = _torch_state(d=7)
    assert "latent d = 7" in flexstep.unsupported_reason(s7.nn_params, p7, (3, 64, 8), 4)
    s1, p1 = _torch_state(layers=1)
    assert "two-hidden-layer" in flexstep.unsupported_reason(s1.nn_params, p1, (3, 64, 8), 4)
    wide, pw = _torch_state(hidden=((100, 200), (100, 100)))
    assert "hidden widths" in flexstep.unsupported_reason(wide.nn_params, pw, (3, 64, 8), 4)
    big, pb = _torch_state(k=65)
    assert "K = 65" in flexstep.unsupported_reason(big.nn_params, pb, (3, 64, 8), 4)


def test_train_chunk_routes_by_device():
    state, prior = _torch_state(d=3, d_in=5, k=4, hidden=((16, 16), (16, 16)))
    meta = torch.zeros((2, 8, 5), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flexstep.train_chunk(state, prior, meta, lr=1e-3, rho=0.1, num_total=8)
    xb = torch.randn(2, 8, 5, generator=torch.Generator().manual_seed(1))
    before = flexstep.launches
    a, ma = flexstep.train_chunk(state, prior, xb, lr=1e-3, rho=0.1, rho_decay=0.5,
                                 num_total=8, seed=3)
    b, _ = flexstep.train_chunk_plain(state, prior, xb, lr=1e-3, rho=0.1, rho_decay=0.5,
                                      num_total=8, seed=3)
    assert flexstep.launches == before
    assert torch.equal(a.pgm_nat.niw_nat.eta3, b.pgm_nat.niw_nat.eta3)  # seeded
    np.testing.assert_allclose(ma["rho"].numpy(), [0.1, 0.1 / 1.5], rtol=1e-6)
    assert a.step == 2 and a.opt_state.count == 2
