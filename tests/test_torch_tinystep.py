"""The port's tinystep path against the JAX reference.

* ``tinystep.train_chunk`` on CPU tensors (its plain version) against T
  steps of svax's ``make_train_step`` at matched ε and augmentation noise ξ
  (the batch is x + σξ — ``augment_step``'s semantics): float64 at rtol
  1e-8 (only summation order differs), float32 at
  tests/test_tinystep_kernel.py's tolerances; one full-width step
  (N=400, K=10, S=4, 50-50, σ=0.4) in float64;
* ``step_grads_manual`` (the backward the CUDA kernel transcribes)
  against autograd of the plain forward, float64, rtol 1e-9;
* the plain chunk against the Pallas kernel itself in interpret mode;
* the wrapper's routing, launch counter and rejections, the runner and
  the entry point on the CPU. The CUDA kernel itself is tested on the
  card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.data import load_pinwheel, make_pinwheel_data
from svax.models import svae as jsvae
from svax.models.svae import SvaeConfig as JConfig
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax_torch import convert, train_svae
from svax_torch.models import svae
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import tinystep
from svax_torch.pgm import gmm
from svax_torch.train import loop, svae_step

torch.set_num_threads(1)

# tests/test_tinystep_kernel.py's float32 bars: (rtol, atol) per group.
F32_TOL = {"params": (5e-4, 5e-5), "mu": (5e-4, 5e-6), "nu": (5e-4, 1e-8),
           "nat": (2e-5, 2e-5)}
F64_TOL = {g: (1e-8, 0.0) for g in F32_TOL}


class _InjectedEps:
    """svax.models.svae as make_train_step's ``model``, with the batch
    carrying (x, ε) so the reference step runs at injected noise."""

    @staticmethod
    def forward(nn, nat, prior, batch, key, config, axis_comp=None):
        x, eps = batch
        return jsvae.forward(nn, nat, prior, x, key, config, eps=eps,
                             axis_comp=axis_comp)


def _setup(n=72, k=4, s=2, hidden=(16, 16), seed=0, dtype=jnp.float64,
           full=False):
    if full:
        x = jnp.asarray(load_pinwheel(seed=seed)[0])
    else:
        x = jnp.asarray(make_pinwheel_data(num_classes=3, num_per_class=n // 3,
                                           seed=seed)[:n])
    n = x.shape[0]
    x = x.astype(dtype)
    jconfig = JConfig(latent_dim=2, num_components=k, num_samples=s,
                      num_total=n, nn_precision=jax.lax.Precision.HIGHEST)
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


def _jax_steps(jstate, jprior, x, jconfig, eps, aug_eps, *, lr, rho, aug):
    step = jax.jit(jstep.make_train_step(jconfig, jprior, optax.adam(lr), rho,
                                         model=_InjectedEps))
    mets = {"recon": [], "local_kl": []}
    for t in range(eps.shape[0]):
        jstate, m = step(jstate, (x + aug * aug_eps[t], eps[t]),
                         jax.random.PRNGKey(0))
        for name in mets:
            mets[name].append(float(m[name]))
    return jstate, mets


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


def _compare(t_steps, *, dtype, tol, full=False, aug=0.4, lr=3e-3, rho=0.2,
             k=4, s=2, hidden=(16, 16)):
    x, jconfig, jprior, jstate = _setup(k=k, s=s, hidden=hidden, dtype=dtype,
                                        full=full)
    n = x.shape[0]
    np_dtype = np.float64 if dtype == jnp.float64 else np.float32
    eps, aug_eps = _noise(t_steps, s, n, k, 0, np_dtype)
    tdtype = torch.float64 if dtype == jnp.float64 else torch.float32
    before = tinystep.launches
    st, mets = tinystep.train_chunk(
        _port(jstate, tdtype), convert.gmm_nat_from_numpy(jprior, dtype=tdtype),
        torch.tensor(np.asarray(x)), lr=lr, rho=rho, t_steps=t_steps,
        aug_noise=aug, eps=torch.tensor(eps), aug_eps=torch.tensor(aug_eps))
    assert tinystep.launches == before  # CPU tensors take the plain version
    jst, jmets = _jax_steps(jstate, jprior, x, jconfig, jnp.asarray(eps),
                            jnp.asarray(aug_eps), lr=lr, rho=rho, aug=aug)
    _assert_state_close(st, jst, tol)
    rtol = 1e-8 if dtype == jnp.float64 else 2e-4
    np.testing.assert_allclose(mets["recon"].numpy(), jmets["recon"], rtol=rtol)
    np.testing.assert_allclose(mets["local_kl"].numpy(), jmets["local_kl"],
                               rtol=rtol, atol=0.0 if dtype == jnp.float64 else 2e-4)


@pytest.mark.parametrize("t_steps", [1, 3])
def test_plain_chunk_matches_jax_float64(t_steps):
    _compare(t_steps, dtype=jnp.float64, tol=F64_TOL)


@pytest.mark.parametrize("t_steps", [1, 3])
def test_plain_chunk_matches_jax_float32(t_steps):
    _compare(t_steps, dtype=jnp.float32, tol=F32_TOL)


def test_plain_chunk_without_augmentation_matches_jax():
    _compare(2, dtype=jnp.float64, tol=F64_TOL, aug=0.0)


def test_full_width_step_matches_jax():
    """N=400, K=10, S=4, 50-50 tanh MLPs, σ=0.4, lr 1e-3, ρ 0.05."""
    _compare(1, dtype=jnp.float64, tol=F64_TOL, full=True, k=10, s=4,
             hidden=(50, 50), lr=1e-3, rho=0.05)


@pytest.mark.parametrize("full", [False, True])
def test_step_grads_manual_matches_autograd(full):
    x, _, jprior, jstate = _setup(full=full, k=10 if full else 4,
                                  s=4 if full else 2,
                                  hidden=(50, 50) if full else (16, 16))
    state = _port(jstate, torch.float64)
    x = torch.tensor(np.asarray(x))
    n = x.shape[0]
    k, s = state.pgm_nat.dir_nat.shape[0], 4 if full else 2
    eps = torch.tensor(np.random.default_rng(7).standard_normal((s, n, k, 2)))
    grads, aux = tinystep.step_grads_manual(state.nn_params, state.pgm_nat, x, eps)

    params = svae_step.map_params(lambda p: p.clone().requires_grad_(True),
                                  state.nn_params)
    config = SvaeConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n)
    prior = convert.gmm_nat_from_numpy(jprior, dtype=torch.float64)
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
    stats = gmm.GmmSuffStats(*(t.detach() for t in out.suff_stats))
    np.testing.assert_allclose(aux["counts"].numpy(), stats.counts.numpy(), rtol=1e-9)
    np.testing.assert_allclose(aux["s1_2"].numpy(), stats.mean_stat[:, 1].numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(aux["s2_12"].numpy(), stats.scatter_stat[:, 0, 1].numpy(),
                               rtol=1e-9)


def test_expected_cols_digamma_recurrence_matches_gmm():
    """The kernel's closed-form d=2 expected parameters with the
    recurrence ψ agree with gmm.expected_params (torch.special.digamma)."""
    _, _, _, jstate = _setup()
    nat = _port(jstate, torch.float64).pgm_nat
    e, ref = tinystep.expected_cols(nat), gmm.expected_params(nat)
    tol = dict(rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(e["log_pi"].numpy(), ref.log_pi.numpy(), **tol)
    np.testing.assert_allclose(e["logdet"].numpy(), ref.logdet.numpy(), **tol)
    np.testing.assert_allclose(e["quad"].numpy(), ref.quad.numpy(), **tol)
    np.testing.assert_allclose(e["prec12"].numpy(), ref.prec[:, 0, 1].numpy(), **tol)
    np.testing.assert_allclose(e["pm2"].numpy(), ref.prec_mean[:, 1].numpy(), **tol)


def test_plain_chunk_matches_pallas_interpret():
    """Against the TPU kernel's own body run by the Pallas interpreter."""
    from svax.ops import tinystep_pallas as tsp

    x, _, jprior, jstate = _setup(dtype=jnp.float32)
    eps, aug_eps = _noise(2, 2, x.shape[0], 4, 0, np.float32)
    jst, jm = tsp.train_chunk(jstate, jprior, x, lr=3e-3, rho=0.2, t_steps=2,
                              eps=jnp.asarray(eps), interpret=True,
                              aug_noise=0.4, aug_eps=jnp.asarray(aug_eps))
    st, m = tinystep.train_chunk_plain(
        _port(jstate, torch.float32), convert.gmm_nat_from_numpy(jprior),
        torch.tensor(np.asarray(x)), lr=3e-3, rho=0.2, t_steps=2,
        aug_noise=0.4, eps=torch.tensor(eps), aug_eps=torch.tensor(aug_eps))
    _assert_state_close(st, jst, F32_TOL)
    np.testing.assert_allclose(m["recon"].numpy(), np.asarray(jm["recon"]), rtol=2e-4)


def test_train_chunk_rejects_what_the_kernel_does_not_take():
    x, _, jprior, jstate = _setup(hidden=(20, 12))
    state = _port(jstate, torch.float32)
    prior = convert.gmm_nat_from_numpy(jprior, dtype=torch.float32)
    reason = tinystep.shape_class_reason(state, prior, torch.zeros(72, 2), 2)
    assert reason is not None and "hidden widths" in reason
    meta = torch.zeros((72, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tinystep.train_chunk(state, prior, meta, lr=1e-3, rho=0.1, t_steps=1)
    _, _, _, ok_state = _setup()
    assert tinystep.shape_class_reason(_port(ok_state, torch.float32), prior,
                                       torch.zeros(72, 2), 2) is None


def test_kernel_unsupported_reason():
    cfg = SvaeConfig(latent_dim=2, num_components=10, num_samples=4, num_total=400)
    ok = dict(batch_full=True, encoder_hidden=(50, 50), decoder_hidden=(50, 50),
              rho=0.05)
    assert loop.kernel_unsupported_reason(cfg, **ok) is None
    assert "latent d = 2" in loop.kernel_unsupported_reason(
        cfg._replace(latent_dim=4), **ok)
    assert "full batch" in loop.kernel_unsupported_reason(
        cfg, **{**ok, "batch_full": False})
    assert "constant rho" in loop.kernel_unsupported_reason(cfg, **ok, rho_decay=1e-3)
    assert "Gaussian" in loop.kernel_unsupported_reason(cfg, **ok, likelihood="bernoulli")
    assert "hidden widths" in loop.kernel_unsupported_reason(
        cfg, **{**ok, "encoder_hidden": (100, 100), "decoder_hidden": (100, 100)})


def test_augment_step_perturbs_the_batch():
    seen = []

    def step(state, xb, eps=None, generator=None):
        seen.append(xb)
        return state, {}

    xb = torch.ones(5, 2)
    xi = torch.full((5, 2), 2.0)
    loop.augment_step(step, 0.5)(None, xb, aug_eps=xi)
    assert torch.equal(seen[-1], xb + 0.5 * xi)
    assert loop.augment_step(step, 0.0) is step


def test_runner_elbo_is_exact_on_the_last_row():
    x, _, jprior, jstate = _setup(dtype=jnp.float32)
    state = _port(jstate, torch.float32)
    prior = convert.gmm_nat_from_numpy(jprior)
    config = SvaeConfig(latent_dim=2, num_components=4, num_samples=2, num_total=72)
    runner = loop.make_runner(config, prior, lr=3e-3, rho=0.2, aug_noise=0.4)
    st, mets = runner(state, torch.tensor(np.asarray(x)), 3, seed=1)
    assert st.step == 3 and st.opt_state.count == 3
    gkl = gmm.kl_global(st.pgm_nat, prior)
    np.testing.assert_allclose(float(mets["elbo"][-1]),
                               float(mets["recon"][-1] - mets["local_kl"][-1] - gkl),
                               rtol=1e-6)
    assert set(mets) == {"recon", "local_kl", "global_kl", "elbo", "rho"}
    st2, _ = runner(state, torch.tensor(np.asarray(x)), 3, seed=1)
    assert torch.equal(st.pgm_nat.dir_nat, st2.pgm_nat.dir_nat)  # seeded


def test_train_svae_cpu_runs_and_refuses_other_configs(capsys):
    out = train_svae.main(["--device", "cpu", "--steps", "4"])
    assert out["state"].step == 4
    assert np.isfinite(list(out["rows"][-1].values())).all()
    with pytest.raises(SystemExit):
        train_svae.main(["--config", "mnist-svae", "--device", "cpu"])
    assert "ROADMAP.md" in capsys.readouterr().err


def test_train_svae_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_svae.main(["--device", "cuda", "--steps", "1"])
