"""The port's bigk-dp path on one device, against the JAX reference.

* ``svae.forward`` with the fused combine (injected ε) and the fused MLP
  decoder — their plain versions on the CPU — against the reference's
  ``svae.forward`` with both kernels in interpret mode
  (``svae._COMBINE_INTERPRET``, as tests/test_decoder_mlp_kernel.py:127
  sets it), at a small bigk-like shape (K = 12, d = 10, S = 1, hidden
  16-16, D = 24), and then two ``make_train_step`` steps on both sides
  from one converted state;
* the data-parallel loop's draw without replacement;
* ``train_svae --config bigk-dp`` on the CPU (at full width in the slow
  tier), its refusals, and its data-parallel run on two ranks under
  ``torch.distributed.run`` (gloo).

Tolerances, float32 on both sides: the ELBO terms at rtol 2e-5 (the
decoder's f32 sums over D of bf16 products, in other orders, and torch's
and XLA's tanh differing in the last bit; the reference's own kernel bar is
1e-5 per row). After two steps: the encoder's parameters at atol 2e-6 and
Adam moments at 1e-3 of each leaf's largest entry (measured: 1.6e-6,
1.7e-4); the decoder's moments at 2e-2 (measured 8.1e-3: its weight
gradients come back rounded to bf16, per tile in the reference and once
over the batch in the port, ~3e-3 apart) and its parameters at 5e-5, 5% of a step (1.7e-5 measured),
where the first moment is at least 5% of its leaf's largest. Adam moves every
entry by about lr = 1e-3 a step whatever its gradient's size, so an entry
whose gradient is near 0 turns that rounding into a different step of up
to lr (1.0e-3 measured at the last layer), and is left out. The naturals
at rtol = atol = 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.models import svae as jsvae
from svax.models.svae import SvaeConfig as JConfig
from svax.pgm import gmm as jgmm
from svax.train import svae_step as jstep
from svax_torch import convert, train_svae
from svax_torch.models import svae
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import combine, decoder_mlp
from svax_torch.train import loop, svae_step

torch.set_num_threads(1)

N_TOTAL, M, D_IN, K, D, H = 96, 32, 24, 12, 10, 16
LR = 1e-3


class _InjectedEps:
    """svax.models.svae as make_train_step's ``model``, with the batch
    carrying (x, ε) so the reference step runs at injected noise."""

    @staticmethod
    def forward(nn, nat, prior, batch, key, config, axis_comp=None):
        x, eps = batch
        return jsvae.forward(nn, nat, prior, x, key, config, eps=eps, axis_comp=axis_comp)


def _cast32(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


@functools.lru_cache(maxsize=None)
def _setup():
    rng = np.random.default_rng(11)
    x = (rng.random((N_TOTAL, D_IN)) < 0.3).astype(np.float32)
    jconfig = JConfig(latent_dim=D, num_components=K, num_samples=1, likelihood="bernoulli",
                      num_total=N_TOTAL, nn_precision=jax.lax.Precision.HIGHEST,
                      nn_compute_dtype="bfloat16", fused_combine=True,
                      fused_mlp_decoder=True, kernel_rng=True)
    jprior = _cast32(jgmm.make_prior(K, D, alpha=0.5, kappa=0.05))
    jstate = _cast32(jstep.init_state(jax.random.PRNGKey(3), D_IN, jconfig, jprior,
                                      optax.adam(LR), (H, H), (H, H)))
    idx = np.stack([rng.permutation(N_TOTAL)[:M] for _ in range(2)])
    eps = rng.standard_normal((2, 1, M, K, D)).astype(np.float32)
    return x, jconfig, jprior, jstate, idx, eps


def _port():
    x, jconfig, jprior, jstate, idx, eps = _setup()
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate), dtype=torch.float32)
    prior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior), dtype=torch.float32)
    config = SvaeConfig(latent_dim=D, num_components=K, num_samples=1, num_total=N_TOTAL,
                        likelihood="bernoulli", nn_compute_dtype="bfloat16",
                        fused_combine=True, kernel_rng=True, fused_mlp_decoder=True)
    return config, prior, state


def test_bigk_forward_matches_jax_with_both_kernels(monkeypatch):
    monkeypatch.setattr(jsvae, "_COMBINE_INTERPRET", True)
    x, jconfig, jprior, jstate, idx, eps = _setup()
    config, prior, state = _port()
    xb = x[idx[0]]
    jout = jsvae.forward(jstate.nn_params, jstate.pgm_nat, jprior, jnp.asarray(xb),
                         jax.random.PRNGKey(0), jconfig, eps=jnp.asarray(eps[0]))
    before = (decoder_mlp.launches, combine.launches)
    calls = []
    real = decoder_mlp.bernoulli_mlp_loglik_plain
    monkeypatch.setattr(decoder_mlp, "bernoulli_mlp_loglik_plain",
                        lambda *a: calls.append(1) or real(*a))
    out = svae.forward(state.nn_params, state.pgm_nat, prior, torch.tensor(xb), config,
                       eps=torch.tensor(eps[0]))
    assert calls == [1]  # the fused decoder's plain version ran
    assert (decoder_mlp.launches, combine.launches) == before
    for name in ("elbo", "recon", "local_kl", "global_kl"):
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(jout, name)), rtol=2e-5, err_msg=name)
    # Off, the same config takes the decomposed bf16 decoder: another number.
    off = svae.forward(state.nn_params, state.pgm_nat, prior, torch.tensor(xb),
                       config._replace(fused_mlp_decoder=False), eps=torch.tensor(eps[0]))
    assert float(off.recon) != float(out.recon)


def test_two_bigk_steps_match_jax(monkeypatch):
    monkeypatch.setattr(jsvae, "_COMBINE_INTERPRET", True)
    x, jconfig, jprior, jstate, idx, eps = _setup()
    config, prior, state = _port()
    rho = lambda t: 0.1 / (1.0 + 0.001 * t)  # noqa: E731
    jrun = jax.jit(jstep.make_train_step(jconfig, jprior, optax.adam(LR), rho=rho,
                                         model=_InjectedEps))
    step = svae_step.make_train_step(config, prior, LR, svae_step.rho_schedule(0.1, 1e-3))
    xt = torch.tensor(x)
    for t in range(2):
        jstate, jm = jrun(jstate, (jnp.asarray(x[idx[t]]), jnp.asarray(eps[t])),
                          jax.random.PRNGKey(0))
        state, mets = step(state, xt[torch.tensor(idx[t])], eps=torch.tensor(eps[t]))
        for name in ("elbo", "recon", "local_kl", "global_kl", "rho"):
            np.testing.assert_allclose(float(mets[name]), float(jm[name]), rtol=2e-5,
                                       err_msg=f"step {t} {name}")
    got = convert.state_to_numpy(state)
    want = jax.tree.map(np.asarray, jstate)
    adam = want.opt_state[0]
    for side in ("encoder", "decoder"):
        for i, wl in enumerate(want.nn_params[side]):
            for name in ("w", "b"):
                what = f"{side}{i}.{name}"
                m_ref = adam.mu[side][i][name]
                for g, w, moment in ((got["adam"]["mu"], m_ref, "m"),
                                     (got["adam"]["nu"], adam.nu[side][i][name], "v")):
                    tol = (1e-3 if side == "encoder" else 2e-2) * float(np.abs(w).max())
                    np.testing.assert_allclose(g[side][i][name], w, rtol=0, atol=tol,
                                               err_msg=f"adam {moment} {what}")
                diff = np.abs(got["nn_params"][side][i][name] - wl[name])
                if side == "encoder":
                    assert diff.max() < 2e-6, (what, diff.max())
                else:
                    moved = np.abs(m_ref) >= 0.05 * np.abs(m_ref).max()
                    assert moved.any() and diff[moved].max() < 5e-5, (what, diff[moved].max())
    np.testing.assert_allclose(got["pgm_nat"]["dir_nat"], want.pgm_nat.dir_nat, rtol=1e-4)
    for f in ("eta1", "eta2", "eta3", "eta4"):
        np.testing.assert_allclose(got["pgm_nat"][f], getattr(want.pgm_nat.niw_nat, f),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    assert got["step"] == 2 and got["adam"]["count"] == 2


def test_step_runner_draws_without_replacement(monkeypatch):
    n, m, t_steps = 50, 16, 4
    gen = torch.Generator().manual_seed(0)
    idx = loop.minibatch_indices(gen, n, m, t_steps, replace=False)
    assert idx.shape == (t_steps, m)
    assert all(len(set(row.tolist())) == m for row in idx)
    assert int(idx.min()) >= 0 and int(idx.max()) < n
    again = loop.minibatch_indices(torch.Generator().manual_seed(0), n, m, t_steps, replace=False)
    assert torch.equal(idx, again)
    full = loop.minibatch_indices(torch.Generator().manual_seed(0), n, n, 1, replace=False)
    assert sorted(full[0].tolist()) == list(range(n))
    # The runner: every step's batch has M distinct rows of x.
    x = torch.eye(n)[:, :n]  # row i is the i-th unit vector: its index
    config = SvaeConfig(latent_dim=3, num_components=4, num_samples=1, num_total=n,
                        likelihood="bernoulli", fused_combine=True, kernel_rng=True,
                        fused_mlp_decoder=True)
    prior = svae_step.gmm.make_prior(4, 3)
    state = svae_step.init_state(torch.Generator().manual_seed(1), n, config, prior, (8,), (8,))
    seen = []
    real = svae.forward

    def spy(nn, nat, pr, xb, cfg, **kw):
        seen.append(xb.argmax(dim=1))
        return real(nn, nat, pr, xb, cfg, **kw)

    monkeypatch.setattr(svae, "forward", spy)
    runner = loop.make_step_runner(config, prior, lr=LR, rho=0.1, batch_size=m, replace=False)
    runner(state, x, 3, seed=5)
    assert len(seen) == 3 and all(len(set(b.tolist())) == m for b in seen)
    g = torch.Generator().manual_seed(5)
    assert torch.equal(torch.stack(seen), loop.minibatch_indices(g, n, m, 3, replace=False))


def test_train_svae_bigk_loop_at_a_small_width(capsys, monkeypatch):
    """The entry's bigk-dp path with the config cut to a small width (the
    full width takes minutes on the CPU: the slow test below)."""
    from svax_torch import configs

    small = dict(configs.CONFIGS["bigk-dp"], num_components=6, latent_dim=10,
                 encoder_hidden=[16, 16], decoder_hidden=[16, 16], batch_size=64)
    monkeypatch.setitem(configs.CONFIGS, "bigk-dp", small)
    out = train_svae.main(["--config", "bigk-dp", "--device", "cpu", "--steps", "5",
                           "--warmup-steps", "2", "--eval-every", "2", "--iw-samples", "2"])
    first = capsys.readouterr().out.splitlines()[0]
    assert '"world_size": 1' in first and '"fused_mlp_decoder": true' in first
    assert '"kernel": "per-step"' in first and '"batch": 64' in first
    assert [r["step"] for r in out["rows"]] == [1, 2, 4, 5]
    assert out["state"].step == 5 and out["state"].opt_state.count == 7
    assert all(np.isfinite(v) for r in out["rows"] for v in r.values())
    assert np.isfinite(out["final_test_iw_loglik_per_point"])
    plain = train_svae.main(["--config", "bigk-dp", "--device", "cpu", "--steps", "1",
                             "--warmup-steps", "0", "--engine", "plain", "--iw-samples", "0"])
    assert plain["rows"][0]["step"] == 1


@pytest.mark.slow
def test_train_svae_bigk_cpu_runs(capsys):
    """bigk-dp at full width on the CPU (K = 100, 1024-point minibatches,
    200-200): ~4 minutes on one core, so in the slow tier."""
    out = train_svae.main(["--config", "bigk-dp", "--device", "cpu", "--steps", "3",
                           "--warmup-steps", "1", "--eval-every", "2", "--iw-samples", "2"])
    first = capsys.readouterr().out.splitlines()[0]
    assert '"world_size": 1' in first and '"fused_mlp_decoder": true' in first
    assert '"kernel": "per-step"' in first and '"batch": 1024' in first
    assert [r["step"] for r in out["rows"]] == [1, 2, 3]
    assert out["state"].step == 3 and out["state"].opt_state.count == 4
    assert all(np.isfinite(v) for r in out["rows"] for v in r.values())
    assert np.isfinite(out["final_test_iw_loglik_per_point"])
    assert out["state"].pgm_nat.dir_nat.shape == (100,)


def test_train_svae_refusals(monkeypatch):
    with pytest.raises(SystemExit):
        train_svae.main(["--config", "pinwheel-svae", "--device", "cpu", "--steps", "1",
                         "--fused-mlp-decoder"])
    # Several processes train only data-parallel (--dp, or bigk-dp's config).
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit):
        train_svae.main(["--config", "pinwheel-svae", "--device", "cpu", "--steps", "1"])


_DP_WRAPPER = """
import os, sys
import torch
from svax_torch import configs, train_svae
configs.CONFIGS["bigk-dp"] = dict(configs.CONFIGS["bigk-dp"], num_components=6, latent_dim=10,
                                  encoder_hidden=[16, 16], decoder_hidden=[16, 16],
                                  batch_size=64)
out = train_svae.main(sys.argv[1:])
st = out["state"]
leaves = [t for side in st.nn_params.values() for ly in side for t in ly.values()]
leaves += [t for side in st.opt_state.mu.values() for ly in side for t in ly.values()]
leaves += [st.pgm_nat.dir_nat, *st.pgm_nat.niw_nat]
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "svax", "configs"))
torch.save({"leaves": leaves, "loaded": loaded, "rows": out["rows"]},
           os.path.join(os.path.dirname(__file__), f"rank{os.environ['RANK']}.pt"))
"""


def test_train_svae_dp_on_two_ranks(tmp_path):
    """bigk-dp cut to a small width (as the fast test above) on two ranks
    over gloo: each rank trains on its half of every minibatch, rank 0
    alone prints, and the replicated state is equal on both ranks."""
    import os
    import subprocess
    import sys

    wrapper = tmp_path / "dp_wrapper.py"
    wrapper.write_text(_DP_WRAPPER)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         str(wrapper), "--config", "bigk-dp", "--device", "cpu", "--steps", "2",
         "--warmup-steps", "0", "--eval-every", "1", "--iw-samples", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    first = [ln for ln in lines if ln.startswith('{"config"')]
    assert len(first) == 1 and '"world_size": 2, "data": 2, "comp": 1' in first[0], lines
    assert '"batch": 64' in first[0] and '"kernel": "per-step"' in first[0]
    assert [ln.count('"step": ') for ln in lines if ln.startswith('{"step"')] == [1, 1]
    assert sum(ln.startswith('{"final_test_iw_loglik_per_point"') for ln in lines) == 1
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in (0, 1)]
    assert [r["loaded"] for r in ranks] == [[], []]
    assert [row["step"] for row in ranks[0]["rows"]] == [1, 2] and ranks[1]["rows"] == []
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["leaves"], ranks[1]["leaves"]))
    assert all(bool(torch.isfinite(t).all()) for t in ranks[0]["leaves"])
