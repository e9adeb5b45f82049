"""The port's ``SvaeConfig.fused_decoder`` path (the Bernoulli decoder's
x-free row sum in ``ops.decoder``) against the JAX reference.

The reference's ``fused_decoder`` takes its row-sum kernel on a TPU only;
on the CPU its gate sends it through the XLA formula (svax/nets/mlp.py:268),
the same function, whose kernel body tests/test_torch_decoder_rowsum.py
holds the port to in interpret mode. Here the port's switch must reach its
row sum (its plain version on CPU tensors) and give the reference's numbers:

* a converted mnist-svae state (784 → 200-200 → 16, 8 → 200-200 → 784)
  through both packages' ``forward`` with ``fused_decoder`` in float32: the
  ELBO terms at rtol 2e-5 (f32 sums over 784 pixels in other orders; the
  reference kernel's own bar is 2e-5 per row);
* two ``make_train_step`` steps with injected ε at small widths, and the
  SMM prior's forward and gradients (``svae_smm``, dof > 0), in float64 at
  rtol 1e-8 (parameters, Adam moments, naturals, metrics; the gradients at
  atol 1e-12), where both sides compute the same function exactly;
* ``remat_decoder`` (``torch.utils.checkpoint``) leaving the gradients as
  they are (1e-6) and matching the reference's ``remat_decoder`` (1e-8,
  float64);
* the runners and the entry: the plain engine turns the switch off, the
  kernel engine keeps it, ``choose_kernel`` sends it to the per-step
  engine, and ``train_svae --fused-decoder`` runs without JAX loaded or
  refuses where it cannot act.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.data import load_mnist as jload_mnist
from svax.models import svae as jsvae
from svax.models import svae_smm as jsmm
from svax.models.svae import SvaeConfig as JConfig
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax_torch import convert, train_svae
from svax_torch.models import svae, svae_smm
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import decoder
from svax_torch.train import loop, svae_step

torch.set_num_threads(1)
HIGHEST = jax.lax.Precision.HIGHEST
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TOTAL, M, D_IN, K, D, S, H = 60, 24, 20, 5, 3, 2, (16, 16)


class _InjectedEps:
    """svax.models.svae as make_train_step's ``model``, with the batch
    carrying (x, ε) so the reference step runs at injected noise."""

    @staticmethod
    def forward(nn, nat, prior, batch, key, config, axis_comp=None):
        x, eps = batch
        return jsvae.forward(nn, nat, prior, x, key, config, eps=eps, axis_comp=axis_comp)


@pytest.fixture
def rowsum_calls(monkeypatch):
    """The precisions the port's plain row sum was called with."""
    calls = []
    real = decoder.rowsum_logsig_neg_plain
    monkeypatch.setattr(decoder, "rowsum_logsig_neg_plain",
                        lambda *a: calls.append(a[-1]) or real(*a))
    return calls


def _cast(tree, dtype):
    return jax.tree.map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


@functools.lru_cache(maxsize=None)
def _small(dof=0.0, remat=False):
    """A small Bernoulli SVAE (d_in 20, K = 5, d = 3, S = 2, 16-16) in float64
    on both sides, fused_decoder on, from one JAX-built state; two batches
    of M indices and their ε."""
    rng = np.random.default_rng(3)
    x = (rng.random((N_TOTAL, D_IN)) < 0.35).astype(np.float64)
    jconfig = JConfig(latent_dim=D, num_components=K, num_samples=S, likelihood="bernoulli",
                      num_total=N_TOTAL, nn_precision=HIGHEST, fused_decoder=True,
                      remat_decoder=remat, dof=dof)
    jprior = _cast(jgmm.make_prior(K, D, alpha=1.0, kappa=0.05), jnp.float64)
    jstate = _cast(jstep.init_state(jax.random.PRNGKey(1), D_IN, jconfig, jprior,
                                    optax.adam(1e-3), H, H), jnp.float64)
    idx = np.stack([rng.permutation(N_TOTAL)[:M] for _ in range(2)])
    eps = rng.standard_normal((2, S, M, K, D))
    config = SvaeConfig(latent_dim=D, num_components=K, num_samples=S, num_total=N_TOTAL,
                        likelihood="bernoulli", fused_decoder=True, remat_decoder=remat,
                        dof=dof, nn_precision="highest")
    return x, jconfig, jprior, jstate, idx, eps, config


def _port_state(jstate, jprior, dtype=torch.float64):
    return (convert.state_from_numpy(jax.tree.map(np.asarray, jstate), dtype=dtype),
            convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior), dtype=dtype))


def test_mnist_state_forward_matches_jax(rowsum_calls):
    """A converted mnist-svae state through both packages' fused_decoder
    forward, float32."""
    x, _, _ = jload_mnist(seed=0, max_train=200)
    x = x[:64].astype(np.float32)
    jconfig = JConfig(latent_dim=8, num_components=10, num_samples=1, likelihood="bernoulli",
                      num_total=6000, nn_precision=HIGHEST, fused_decoder=True)
    jprior = _cast(jgmm.make_prior(10, 8, alpha=1.0, kappa=0.05), jnp.float32)
    jstate = _cast(jstep.init_state(jax.random.PRNGKey(0), 784, jconfig, jprior,
                                    optax.adam(1e-3), (200, 200), (200, 200)), jnp.float32)
    eps = np.random.default_rng(8).standard_normal((1, 64, 10, 8)).astype(np.float32)
    jout = jsvae.forward(jstate.nn_params, jstate.pgm_nat, jprior, jnp.asarray(x),
                         jax.random.PRNGKey(0), jconfig, eps=jnp.asarray(eps))
    state, prior = _port_state(jstate, jprior, torch.float32)
    config = SvaeConfig(latent_dim=8, num_components=10, num_samples=1, num_total=6000,
                        likelihood="bernoulli", fused_decoder=True, nn_precision="highest")
    out = svae.forward(state.nn_params, state.pgm_nat, prior, torch.tensor(x), config,
                       eps=torch.tensor(eps))
    assert rowsum_calls == ["highest"]
    for name in ("elbo", "recon", "local_kl", "global_kl"):
        np.testing.assert_allclose(float(getattr(out, name)), float(getattr(jout, name)),
                                   rtol=2e-5, err_msg=name)


def test_two_steps_match_jax_in_float64(rowsum_calls):
    x, jconfig, jprior, jstate, idx, eps, config = _small()
    rho = lambda t: 0.1 / (1.0 + 0.001 * t)  # noqa: E731
    jrun = jax.jit(jstep.make_train_step(jconfig, jprior, optax.adam(1e-3), rho=rho,
                                         model=_InjectedEps))
    state, prior = _port_state(jstate, jprior)
    step = svae_step.make_train_step(config, prior, 1e-3, svae_step.rho_schedule(0.1, 1e-3))
    xt = torch.tensor(x)
    for t in range(2):
        jstate, jm = jrun(jstate, (jnp.asarray(x[idx[t]]), jnp.asarray(eps[t])),
                          jax.random.PRNGKey(0))
        state, mets = step(state, xt[torch.tensor(idx[t])], eps=torch.tensor(eps[t]))
        for name in ("elbo", "recon", "local_kl", "global_kl", "rho"):
            np.testing.assert_allclose(float(mets[name]), float(jm[name]), rtol=1e-8,
                                       err_msg=f"step {t} {name}")
    assert rowsum_calls == ["highest", "highest"]
    got, want = convert.state_to_numpy(state), jax.tree.map(np.asarray, jstate)
    adam = want.opt_state[0]
    for side in ("encoder", "decoder"):
        for i, wl in enumerate(want.nn_params[side]):
            for name in ("w", "b"):
                for g, w, what in ((got["nn_params"], wl, "params"),
                                   (got["adam"]["mu"], adam.mu[side][i], "adam m"),
                                   (got["adam"]["nu"], adam.nu[side][i], "adam v")):
                    np.testing.assert_allclose(g[side][i][name], w[name], rtol=1e-8,
                                               atol=1e-12, err_msg=f"{what} {side}{i}.{name}")
    np.testing.assert_allclose(got["pgm_nat"]["dir_nat"], want.pgm_nat.dir_nat, rtol=1e-8)
    for f in ("eta1", "eta2", "eta3", "eta4"):
        np.testing.assert_allclose(got["pgm_nat"][f], getattr(want.pgm_nat.niw_nat, f),
                                   rtol=1e-8, atol=1e-10, err_msg=f)
    assert got["step"] == 2 and got["adam"]["count"] == 2


def _grads(forward, params, *args, **kw):
    """The gradients of −(recon − local)/M through ``forward`` w.r.t. params."""
    params = svae_step.map_params(lambda p: p.clone().requires_grad_(True), params)
    out = forward(params, *args, **kw)
    leaves = [t for side in params.values() for ly in side for t in ly.values()]
    return out, torch.autograd.grad(-(out.recon - out.local_kl) / M, leaves)


def _jax_grads(forward, nn, *args, **kw):
    def loss(nn):
        out = forward(nn, *args, **kw)
        return -(out.recon - out.local_kl) / M, out

    (_, out), g = jax.value_and_grad(loss, has_aux=True)(nn)
    return out, [np.asarray(ly[name]) for side in ("encoder", "decoder")
                 for ly in g[side] for name in ("w", "b")]


@pytest.mark.parametrize("dof", [2.5, 4.0])
def test_smm_forward_and_grads_match_jax_in_float64(rowsum_calls, dof):
    x, jconfig, jprior, jstate, idx, eps, config = _small(dof=dof)
    xb = x[idx[0]]
    jout, jg = _jax_grads(jsmm.forward, jstate.nn_params, jstate.pgm_nat, jprior,
                          jnp.asarray(xb), jax.random.PRNGKey(0), jconfig,
                          eps=jnp.asarray(eps[0]))
    state, prior = _port_state(jstate, jprior)
    out, g = _grads(svae_smm.forward, state.nn_params, state.pgm_nat, prior,
                    torch.tensor(xb), config, eps=torch.tensor(eps[0]))
    assert rowsum_calls == ["highest"]
    for name in ("elbo", "recon", "local_kl", "global_kl"):
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(jout, name)), rtol=1e-8, err_msg=name)
    for got, want in zip(g, jg):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12)


def test_remat_decoder_keeps_the_gradients_and_matches_jax(rowsum_calls):
    x, jconfig, jprior, jstate, idx, eps, config = _small(remat=True)
    xb = x[idx[1]]
    state, prior = _port_state(jstate, jprior)
    args = (state.pgm_nat, prior, torch.tensor(xb))
    out_r, g_r = _grads(svae.forward, state.nn_params, *args, config, eps=torch.tensor(eps[1]))
    # The checkpoint recomputes the decoder in the backward pass: two row sums.
    assert rowsum_calls == ["highest", "highest"]
    out, g = _grads(svae.forward, state.nn_params, *args,
                    config._replace(remat_decoder=False), eps=torch.tensor(eps[1]))
    assert out_r.elbo.item() == out.elbo.item()
    for a, b in zip(g_r, g):
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-6)
    jout, jg = _jax_grads(jsvae.forward, jstate.nn_params, jstate.pgm_nat, jprior,
                          jnp.asarray(xb), jax.random.PRNGKey(0), jconfig,
                          eps=jnp.asarray(eps[1]))
    np.testing.assert_allclose(out_r.elbo.item(), float(jout.elbo), rtol=1e-8)
    for got, want in zip(g_r, jg):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12)


def test_runners_carry_the_switches(rowsum_calls):
    """The kernel engine keeps fused_decoder and remat_decoder (one row sum a
    step, two under remat); the plain engine turns fused_decoder off."""
    x, _, jprior, jstate, _, _, config = _small()
    state, prior = _port_state(jstate, jprior, torch.float32)
    xt = torch.tensor(x, dtype=torch.float32)
    for engine, cfg, calls in (("kernel", config, 3), ("plain", config, 0),
                               ("kernel", config._replace(remat_decoder=True), 6)):
        rowsum_calls.clear()
        runner = loop.make_step_runner(cfg, prior, lr=1e-3, rho=0.1, batch_size=M,
                                       engine=engine)
        _, mets = runner(state, xt, 3, seed=1)
        assert len(rowsum_calls) == calls, (engine, cfg.remat_decoder, rowsum_calls)
        assert bool(torch.isfinite(mets["elbo"]).all())
    rowsum_calls.clear()
    svae_step.make_eval_fn(config, prior)(state, xt, generator=torch.Generator().manual_seed(0))
    assert rowsum_calls == ["highest"]
    gate = dict(batch_full=False, encoder_hidden=H, decoder_hidden=H, rho=0.1,
                likelihood="bernoulli", input_dim=D_IN)
    assert loop.choose_kernel(config, engine="auto", **gate) == loop.PER_STEP


_ENTRY = """
import sys
from svax_torch.ops import decoder
from svax_torch import train_svae
calls = []
real = decoder.rowsum_logsig_neg_plain
decoder.rowsum_logsig_neg_plain = lambda *a: calls.append(a[-1]) or real(*a)
out = train_svae.main(sys.argv[1:])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "svax", "configs"))
print("ROWSUM", len(calls), "LOADED", loaded, "STEP", out["state"].step)
"""


def test_train_svae_fused_decoder_runs_without_jax():
    """The entry with --fused-decoder on the CPU, in a process with neither
    JAX nor the JAX package loaded (the warmup and the IW bound cut to keep
    it fast)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _ENTRY, "--device", "cpu", "--config", "mnist-svae",
         "--nn-compute-dtype", "float32", "--fused-decoder", "--steps", "2",
         "--warmup-steps", "1", "--iw-samples", "2"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    first = res.stdout.splitlines()[0]
    assert '"fused_decoder": true' in first and '"nn_compute_dtype": "float32"' in first
    assert '"fused_mlp_decoder": false' in first and '"kernel": "per-step"' in first
    last = res.stdout.splitlines()[-1]
    # Warmup 1 step + 2 steps (forward and backward), and 4 evaluations
    # (the initial test ELBO, the warmup reseed runs none, rows at 1 and 2:
    # mnist-svae emits per chunk, so the row after step 2) run the row sum.
    assert last.startswith("ROWSUM ") and "LOADED [] STEP 2" in last, last
    assert int(last.split()[1]) >= 3


@pytest.mark.parametrize("argv,message", [
    (["--config", "mnist-svae"], "computes it in bfloat16"),
    (["--config", "pinwheel-svae"], "gaussian likelihood"),
    (["--config", "bigk-dp", "--nn-compute-dtype", "float32"], "--no-fused-mlp-decoder"),
])
def test_train_svae_refuses_fused_decoder_where_it_cannot_act(capsys, argv, message):
    with pytest.raises(SystemExit):
        train_svae.main([*argv, "--device", "cpu", "--steps", "1", "--fused-decoder"])
    assert message in capsys.readouterr().err
