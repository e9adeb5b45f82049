"""The port's tinystep path with the Student-t mixture prior (dof > 0).

* ``tinystep.train_chunk_plain(dof=...)`` against the TPU kernel's own body
  run by the Pallas interpreter (``tinystep_pallas.train_chunk(...,
  interpret=True)``), augmentation on, at tests/test_tinystep_kernel.py's
  float32 bars — its SMM cases: full chain, envelope, and odd shapes with
  dof 2.5 and one round;
* the plain chunk against T steps of svax's ``make_train_step(model=
  svae_smm)`` at matched ε and ξ in float64 (rtol 1e-8);
* ``step_grads_manual(dof=...)`` (the backward the CUDA kernel
  transcribes) against autograd of the plain SMM forward, float64, rtol
  1e-9, in both gradient modes and at 1, 2 and 6 rounds;
* the wrapper's and the runner's routing on CPU tensors. The CUDA kernel
  itself is tested on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.data import load_pinwheel, make_pinwheel_data
from svax.models import svae_smm as jsmm
from svax.models.svae import SvaeConfig as JConfig
from svax.ops import tinystep_pallas as tsp
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax_torch import convert
from svax_torch.models import svae_smm
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import tinystep
from svax_torch.pgm import smm
from svax_torch.train import loop, svae_step

torch.set_num_threads(1)

# tests/test_tinystep_kernel.py's float32 bars: (rtol, atol) per group.
F32_TOL = {"params": (5e-4, 5e-5), "mu": (5e-4, 5e-6), "nu": (5e-4, 1e-8),
           "nat": (2e-5, 2e-5)}
F64_TOL = {g: (1e-8, 0.0) for g in F32_TOL}


class _InjectedEps:
    """svax.models.svae_smm as make_train_step's ``model``, with the batch
    carrying (x, ε) so the reference step runs at injected noise."""

    stats_to_nat = staticmethod(jsmm.stats_to_nat)

    @staticmethod
    def forward(nn, nat, prior, batch, key, config, axis_comp=None):
        x, eps = batch
        return jsmm.forward(nn, nat, prior, x, key, config, eps=eps)


def _setup(n=72, k=4, s=2, hidden=(16, 16), seed=0, dtype=jnp.float64, full=False,
           dof=4.0, smm_iters=2, env=False):
    if full:
        x = jnp.asarray(load_pinwheel(seed=seed)[0])
    else:
        x = jnp.asarray(make_pinwheel_data(num_classes=3, num_per_class=n // 3,
                                           seed=seed)[:n])
    n = x.shape[0]
    x = x.astype(dtype)
    jconfig = JConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n,
                      nn_precision=jax.lax.Precision.HIGHEST, dof=dof,
                      smm_iters=smm_iters, smm_envelope_grads=env)
    cast = lambda t: jax.tree.map(  # noqa: E731
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
    jprior = cast(jgmm.make_prior(k, 2, kappa=0.05))
    jstate = cast(jstep.init_state(jax.random.PRNGKey(seed), 2, jconfig, jprior,
                                   optax.adam(1e-3), hidden, hidden, data=x))
    return x, jconfig, jprior, jstate


def _noise(t, s, n, k, seed, np_dtype):
    rng = np.random.default_rng(seed + 100)
    return (rng.standard_normal((t, s, n, k, 2)).astype(np_dtype),
            rng.standard_normal((t, n, 2)).astype(np_dtype))


def _port(jtree, dtype):
    return convert.state_from_numpy(jax.tree.map(np.asarray, jtree), dtype=dtype)


def _assert_state_close(state, jstate, tol):
    got = convert.state_to_numpy(state)
    want = jax.tree.map(np.asarray, jstate)
    adam = want.opt_state[0]
    groups = [("params", got["nn_params"], want.nn_params),
              ("mu", got["adam"]["mu"], adam.mu), ("nu", got["adam"]["nu"], adam.nu)]
    for name, g, w in groups:
        rtol, atol = tol[name]
        for side in ("encoder", "decoder"):
            for gl, wl in zip(g[side], w[side]):
                for key in ("w", "b"):
                    np.testing.assert_allclose(gl[key], wl[key], rtol=rtol,
                                               atol=atol, err_msg=f"{name} {side} {key}")
    rtol, atol = tol["nat"]
    np.testing.assert_allclose(got["pgm_nat"]["dir_nat"], want.pgm_nat.dir_nat,
                               rtol=rtol, atol=atol)
    for f in ("eta1", "eta2", "eta3", "eta4"):
        np.testing.assert_allclose(got["pgm_nat"][f], getattr(want.pgm_nat.niw_nat, f),
                                   rtol=rtol, atol=atol, err_msg=f)
    assert got["adam"]["count"] == int(adam.count)
    assert got["step"] == int(want.step)


@pytest.mark.parametrize("case", [
    # tests/test_tinystep_kernel.py: test_smm_prior_matches_oracle,
    # test_smm_envelope_grads_matches_oracle, test_smm_odd_shapes.
    dict(dof=4.0, smm_iters=2, env=False),
    dict(dof=4.0, smm_iters=2, env=True),
    dict(dof=2.5, smm_iters=1, env=False, n=150, k=5, s=1, hidden=(20, 12), rho=0.5,
         seed=3),
], ids=["full_chain", "envelope", "odd_shapes"])
def test_plain_chunk_matches_pallas_interpret(case):
    """Against the TPU kernel's SMM branch run by the Pallas interpreter,
    with σ = 0.4 augmentation, T = 2."""
    c = {**dict(n=72, k=4, s=2, hidden=(16, 16), rho=0.2, seed=0), **case}
    rho, env = c.pop("rho"), c["env"]
    x, _, jprior, jstate = _setup(dtype=jnp.float32, **c)
    eps, aug_eps = _noise(2, c["s"], x.shape[0], c["k"], c["seed"], np.float32)
    kw = dict(lr=3e-3, rho=rho, t_steps=2, aug_noise=0.4, dof=c["dof"],
              smm_iters=c["smm_iters"], smm_envelope_grads=env)
    jst, jm = tsp.train_chunk(jstate, jprior, x, eps=jnp.asarray(eps), interpret=True,
                              aug_eps=jnp.asarray(aug_eps), **kw)
    st, m = tinystep.train_chunk_plain(
        _port(jstate, torch.float32), convert.gmm_nat_from_numpy(jprior),
        torch.tensor(np.asarray(x)), eps=torch.tensor(eps),
        aug_eps=torch.tensor(aug_eps), **kw)
    _assert_state_close(st, jst, F32_TOL)
    np.testing.assert_allclose(m["recon"].numpy(), np.asarray(jm["recon"]), rtol=2e-4)
    np.testing.assert_allclose(m["local_kl"].numpy(), np.asarray(jm["local_kl"]),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("env", [False, True])
def test_plain_chunk_matches_jax_float64(env):
    """T = 3 steps against svax's make_train_step(model=svae_smm) at matched
    ε and ξ (x + σξ), rtol 1e-8."""
    x, jconfig, jprior, jstate = _setup(env=env)
    n, lr, rho, aug = x.shape[0], 3e-3, 0.2, 0.4
    eps, aug_eps = _noise(3, 2, n, 4, 0, np.float64)
    step = jax.jit(jstep.make_train_step(jconfig, jprior, optax.adam(lr), rho,
                                         model=_InjectedEps))
    jst, jrecon = jstate, []
    for t in range(3):
        jst, jm = step(jst, (x + aug * aug_eps[t], jnp.asarray(eps[t])),
                       jax.random.PRNGKey(0))
        jrecon.append(float(jm["recon"]))
    before = tinystep.launches
    st, m = tinystep.train_chunk(
        _port(jstate, torch.float64), convert.gmm_nat_from_numpy(jprior),
        torch.tensor(np.asarray(x)), lr=lr, rho=rho, t_steps=3, aug_noise=aug,
        eps=torch.tensor(eps), aug_eps=torch.tensor(aug_eps), dof=4.0, smm_iters=2,
        smm_envelope_grads=env)
    assert tinystep.launches == before  # CPU tensors take the plain version
    _assert_state_close(st, jst, F64_TOL)
    np.testing.assert_allclose(m["recon"].numpy(), jrecon, rtol=1e-8)


@pytest.mark.parametrize("env", [False, True])
@pytest.mark.parametrize("smm_iters,dof", [(1, 2.5), (2, 4.0), (6, 4.0)])
def test_step_grads_manual_matches_autograd(smm_iters, dof, env):
    x, _, jprior, jstate = _setup(dof=dof, smm_iters=smm_iters, env=env)
    _check_manual_grads(x, jprior, jstate, 2, dof, smm_iters, env)


@pytest.mark.parametrize("env", [False, True])
def test_step_grads_manual_matches_autograd_full_width(env):
    """N=400, K=10, S=4, 50-50, dof 4, two rounds."""
    x, _, jprior, jstate = _setup(full=True, k=10, s=4, hidden=(50, 50), env=env)
    _check_manual_grads(x, jprior, jstate, 4, 4.0, 2, env)


def _check_manual_grads(x, jprior, jstate, s, dof, smm_iters, env):
    state = _port(jstate, torch.float64)
    x = torch.tensor(np.asarray(x))
    n, k = x.shape[0], state.pgm_nat.dir_nat.shape[0]
    eps = torch.tensor(np.random.default_rng(7).standard_normal((s, n, k, 2)))
    grads, aux = tinystep.step_grads_manual(state.nn_params, state.pgm_nat, x, eps,
                                            dof=dof, smm_iters=smm_iters,
                                            smm_envelope_grads=env)
    params = svae_step.map_params(lambda p: p.clone().requires_grad_(True),
                                  state.nn_params)
    config = SvaeConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n,
                        dof=dof, smm_iters=smm_iters, smm_envelope_grads=env)
    prior = convert.gmm_nat_from_numpy(jprior, dtype=torch.float64)
    out = svae_smm.forward(params, state.pgm_nat, prior, x, config, eps=eps)
    neg_loss = -(out.recon - out.local_kl) / n
    leaves = [t for side in params.values() for ly in side for t in ly.values()]
    want = torch.autograd.grad(neg_loss, leaves)
    got = [t for side in grads.values() for ly in side for t in ly.values()]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(float(aux["recon"]), float(out.recon.detach()), rtol=1e-9)
    np.testing.assert_allclose(float(aux["local_kl"]), float(out.local_kl.detach()),
                               rtol=1e-9)
    stats = smm.SmmSuffStats(*(t.detach() for t in out.suff_stats))
    np.testing.assert_allclose(aux["counts"].numpy(), stats.counts.numpy(), rtol=1e-9)
    np.testing.assert_allclose(aux["u_counts"].numpy(), stats.u_counts.numpy(), rtol=1e-9)
    np.testing.assert_allclose(aux["s1_2"].numpy(), stats.mean_stat[:, 1].numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(aux["s2_12"].numpy(), stats.scatter_stat[:, 0, 1].numpy(),
                               rtol=1e-9)


def test_envelope_and_full_chain_gradients_differ():
    """The two modes share the forward and differ in the encoder's gradient
    only (the decoder's sees the same z and r̃)."""
    x, _, _, jstate = _setup()
    state = _port(jstate, torch.float64)
    x = torch.tensor(np.asarray(x))
    eps = torch.tensor(np.random.default_rng(7).standard_normal((2, 72, 4, 2)))
    full, aux_f = tinystep.step_grads_manual(state.nn_params, state.pgm_nat, x, eps, dof=4.0)
    env, aux_e = tinystep.step_grads_manual(state.nn_params, state.pgm_nat, x, eps, dof=4.0,
                                            smm_envelope_grads=True)
    assert float(aux_f["neg_loss"]) == float(aux_e["neg_loss"])
    for a, b in zip(full["decoder"], env["decoder"]):
        np.testing.assert_allclose(a["w"].numpy(), b["w"].numpy(), rtol=1e-12)
    assert not torch.allclose(full["encoder"][0]["w"], env["encoder"][0]["w"], rtol=1e-3)


def test_runner_passes_the_smm_switches_to_tinystep():
    """make_runner's tinystep chunk on CPU tensors equals train_chunk_plain
    with the config's dof, smm_iters and smm_envelope_grads."""
    x, _, jprior, jstate = _setup(dtype=jnp.float32)
    state, prior = _port(jstate, torch.float32), convert.gmm_nat_from_numpy(jprior)
    xt = torch.tensor(np.asarray(x))
    eps, aug_eps = _noise(2, 2, 72, 4, 0, np.float32)
    config = SvaeConfig(latent_dim=2, num_components=4, num_samples=2, num_total=72,
                        dof=2.5, smm_iters=3, smm_envelope_grads=True)
    runner = loop.make_runner(config, prior, lr=3e-3, rho=0.2, aug_noise=0.4)
    st, mets = runner(state, xt, 2, eps=torch.tensor(eps), aug_eps=torch.tensor(aug_eps))
    want, wm = tinystep.train_chunk_plain(
        state, prior, xt, lr=3e-3, rho=0.2, t_steps=2, aug_noise=0.4,
        eps=torch.tensor(eps), aug_eps=torch.tensor(aug_eps), dof=2.5, smm_iters=3,
        smm_envelope_grads=True)
    assert torch.equal(st.pgm_nat.niw_nat.eta2, want.pgm_nat.niw_nat.eta2)
    assert torch.equal(mets["local_kl"], wm["local_kl"])
    gmm_st, _ = loop.make_runner(config._replace(dof=0.0), prior, lr=3e-3, rho=0.2,
                                 aug_noise=0.4)(state, xt, 2, eps=torch.tensor(eps),
                                                aug_eps=torch.tensor(aug_eps))
    assert not torch.equal(gmm_st.pgm_nat.niw_nat.eta2, st.pgm_nat.niw_nat.eta2)
