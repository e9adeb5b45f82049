"""The port's plain VAE (``models.vae``, ``models.evaluation.vae_iw_loglik``,
``train.trainer.VaeTrainer``, ``svax_torch.train_vae``) against the JAX
reference:

* ``elbo`` (Gaussian and Bernoulli) with the reference's ε injected, at
  rtol 1e-9 (float64), and its gradients against ``jax.grad`` at 1e-8;
* 5 train steps (Adam) against ``make_train_step`` with optax at 1e-8;
* ``vae_iw_loglik`` with injected ε at 1e-9;
* ``VaeTrainer`` as the reference's ``test_vae_trainer_through_engine`` and
  ``_data_parallel`` (two gloo ranks), its engine gates, and a resume
  bit-equal to an uninterrupted fit at a chunk boundary;
* ``train_vae`` on the CPU, in a process where JAX is never loaded.

JAX is imported inside the tests: the spawned ranks import this module to
find their function and stay free of it.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svax_torch import convert
from svax_torch.data.pinwheel import make_pinwheel_data
from svax_torch.models import evaluation, vae
from svax_torch.train.metrics import read_jsonl
from svax_torch.train.trainer import TrainerConfig, VaeTrainer
from svax_torch.utils.tree import flatten

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _close(got, want, rtol, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=1e-13,
                               err_msg=what)


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _data(likelihood: str, n=48, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if likelihood == "gaussian":
        return make_pinwheel_data(num_classes=3, num_per_class=n // 3, seed=seed)[:n]
    return (rng.uniform(size=(n, 10)) < rng.uniform(0.2, 0.8, size=10)).astype(np.float64)


def _setup(likelihood: str, s=2, seed=0):
    """f64 data, the JAX config, state and optimizer, and their ports."""
    import jax
    import jax.numpy as jnp
    import optax

    from svax.models import vae as jvae

    x = _data(likelihood, seed=seed)
    jconfig = jvae.VaeConfig(latent_dim=3, num_samples=s, likelihood=likelihood)
    config = vae.VaeConfig(latent_dim=3, num_samples=s, likelihood=likelihood)
    opt = optax.adam(3e-3)
    jstate = jvae.init_state(jax.random.PRNGKey(seed), x.shape[1], jconfig, opt, (12, 9),
                             (11, 8), dtype=jnp.float64)
    return x, jconfig, config, opt, jstate, convert.vae_state_from_numpy(_np(jstate))


def _eps(key, s, n, d=3):
    import jax
    import jax.numpy as jnp

    return np.asarray(jax.random.normal(key, (s, n, d), dtype=jnp.float64))


@pytest.mark.parametrize("likelihood", ["gaussian", "bernoulli"])
def test_elbo_and_gradients_match_jax(likelihood):
    import jax
    import jax.numpy as jnp

    from svax.models import vae as jvae

    x, jconfig, config, _, jstate, state = _setup(likelihood)
    key = jax.random.PRNGKey(11)
    (jval, jparts), jgrads = jax.value_and_grad(
        lambda p: jvae.elbo(p, jnp.asarray(x), key, jconfig), has_aux=True)(jstate.params)
    params = {side: [{k: t.clone().requires_grad_(True) for k, t in ly.items()}
                     for ly in layers] for side, layers in state.params.items()}
    val, parts = vae.elbo(params, torch.tensor(x), None, config,
                          eps=torch.tensor(_eps(key, 2, x.shape[0])))
    _close(val, jval, 1e-9, "elbo")
    for name in ("recon", "kl"):
        _close(parts[name], jparts[name], 1e-9, name)
    leaves = [t for _, t in flatten(params)]
    grads = torch.autograd.grad(val, leaves)
    jleaves = [jgrads[side][i][k] for side in ("encoder", "decoder")
               for i in range(len(jgrads[side])) for k in ("w", "b")]
    assert len(jleaves) == len(grads)
    for got, want in zip(grads, jleaves):
        _close(got, want, 1e-8, "gradient")


@pytest.mark.parametrize("likelihood", ["gaussian", "bernoulli"])
def test_five_adam_steps_match_optax(likelihood):
    import jax
    import jax.numpy as jnp

    from svax.models import vae as jvae

    x, jconfig, config, opt, jstate, state = _setup(likelihood, seed=1)
    jstep = jax.jit(jvae.make_train_step(jconfig, opt))
    step = vae.make_train_step(config, 3e-3)
    key = jax.random.PRNGKey(5)
    for t in range(5):
        key, k = jax.random.split(key)
        xb = x[t * 8:(t + 1) * 8 + 16]
        jstate, jm = jstep(jstate, jnp.asarray(xb), k)
        state, m = step(state, torch.tensor(xb), eps=torch.tensor(_eps(k, 2, len(xb))))
        for name in ("elbo_per_point", "recon", "kl"):
            _close(m[name], jm[name], 1e-8, name)
    back = convert.vae_state_to_numpy(state)
    assert state.step == int(jstate.step) == 5
    assert int(back["adam"]["count"]) == int(jstate.opt_state[0].count)
    jnp_tree = _np(jstate)
    for side in ("encoder", "decoder"):
        for i, ly in enumerate(jnp_tree.params[side]):
            for k in ("w", "b"):
                _close(back["params"][side][i][k], ly[k], 1e-8, f"{side}.{i}.{k}")
                _close(back["adam"]["mu"][side][i][k], jnp_tree.opt_state[0].mu[side][i][k],
                       1e-8, "adam m")
                _close(back["adam"]["nu"][side][i][k], jnp_tree.opt_state[0].nu[side][i][k],
                       1e-8, "adam v")


@pytest.mark.parametrize("likelihood", ["gaussian", "bernoulli"])
def test_iw_loglik_matches_jax(likelihood):
    import jax
    import jax.numpy as jnp

    from svax.models import evaluation as jevaluation

    x, jconfig, config, _, jstate, state = _setup(likelihood, s=1, seed=2)
    key = jax.random.PRNGKey(3)
    want = jevaluation.vae_iw_loglik(jstate.params, jnp.asarray(x), key, jconfig, 23)
    got = evaluation.vae_iw_loglik(state.params, torch.tensor(x), config, 23,
                                   eps=torch.tensor(_eps(key, 23, x.shape[0])))
    _close(got, want, 1e-9)
    drawn = evaluation.vae_iw_loglik(state.params, torch.tensor(x), config, 64,
                                     generator=torch.Generator().manual_seed(0))
    elbo, _ = vae.elbo(state.params, torch.tensor(x), torch.Generator().manual_seed(1),
                       config)
    assert float(drawn.mean()) >= float(elbo) - 0.05  # the IWAE bound is tighter


# ------------------------------------------------------------ VaeTrainer


def _pin(dtype=np.float32):
    x = make_pinwheel_data(num_classes=3, num_per_class=30, seed=0).astype(dtype)
    return x[:72], x[72:]


def _tc(**kw) -> TrainerConfig:
    base = dict(device="cpu", lr=3e-3, encoder_hidden=(16,), decoder_hidden=(16,))
    base.update(kw)
    return TrainerConfig(**base)


def _tensors(state) -> list:
    return [t.numpy() for _, t in flatten(state) if isinstance(t, torch.Tensor)]


def test_vae_trainer_through_engine(tmp_path):
    x_train, x_test = _pin()
    mc = vae.VaeConfig(latent_dim=2, num_samples=1)
    tr = VaeTrainer(mc, _tc(steps=40, eval_every=20, logfile=str(tmp_path / "v.jsonl")), 2)
    state = tr.fit(x_train, x_test)
    assert state.step == 40 and tr.engine == "step"
    rows = read_jsonl(tmp_path / "v.jsonl")
    assert [r["step"] for r in rows] == [20, 40]
    assert rows[-1]["elbo_per_point"] > rows[0]["elbo_per_point"]
    assert np.isfinite(rows[-1]["test_elbo_per_point"])
    assert tr.best["metric"] == "test_elbo_per_point" and tr.best["steps_run"] == 40


def test_vae_trainer_engines():
    """"kernel" is refused with the reference's reason; "auto" runs the
    per-step engine; a minibatch fit takes its own index stacks."""
    x_train, _ = _pin()
    mc = vae.VaeConfig(latent_dim=2)
    with pytest.raises(ValueError, match="VaeTrainer has no whole-step kernel engine"):
        VaeTrainer(mc, _tc(steps=2, engine="kernel"), 2).fit(x_train)
    auto = VaeTrainer(mc, _tc(steps=4, eval_every=2, engine="auto"), 2)
    a = auto.fit(x_train)
    assert auto.engine == "step" and a.step == 4
    b = VaeTrainer(mc, _tc(steps=4, eval_every=2), 2).fit(x_train)
    assert all(np.array_equal(p, q) for p, q in zip(_tensors(a), _tensors(b)))
    mb = VaeTrainer(mc, _tc(steps=4, eval_every=2, batch_size=16), 2).fit(x_train)
    assert mb.step == 4 and not np.array_equal(_tensors(mb)[0], _tensors(b)[0])


def test_vae_trainer_resume_is_bitexact(tmp_path):
    """A fit stopped at step 20 and resumed to 40 equals one run to 40, at
    the chunk boundary, with minibatches (state and logged rows)."""
    x_train, x_test = _pin()
    mc = vae.VaeConfig(latent_dim=2, num_samples=2)
    kw = dict(eval_every=10, batch_size=24)
    full = VaeTrainer(mc, _tc(steps=40, **kw), 2).fit(x_train, x_test)
    ck = str(tmp_path / "ck")
    VaeTrainer(mc, _tc(steps=20, checkpoint_dir=ck, **kw), 2).fit(x_train, x_test)
    resumed = VaeTrainer(mc, _tc(steps=40, checkpoint_dir=ck,
                                 logfile=str(tmp_path / "r.jsonl"), **kw), 2)
    got = resumed.fit(x_train, x_test)
    assert got.step == 40 and got.opt_state.count == 40
    for p, q in zip(_tensors(got), _tensors(full)):
        np.testing.assert_array_equal(p, q)
    assert [r["step"] for r in read_jsonl(tmp_path / "r.jsonl")] == [30, 40]


def _dp_rank(rank: int, world: int, dev, x_train) -> dict:
    mc = vae.VaeConfig(latent_dim=2, num_samples=1)
    tr = VaeTrainer(mc, _tc(steps=10, eval_every=5, encoder_hidden=(8,),
                            decoder_hidden=(8,), data_parallel=True), 2)
    state = tr.fit(x_train)
    return {"state": _tensors(state), "step": state.step, "data": tr.mesh.data}


def test_vae_trainer_data_parallel():
    """Two gloo ranks: every rank ends with the same finite state."""
    from svax_torch.parallel import mesh

    x_train, _ = _pin()
    out = mesh.spawn(_dp_rank, 2, "cpu", "gloo", args=(x_train,), timeout=120.0)
    assert out[0]["step"] == 10 and out[0]["data"] == 2
    for a, b in zip(out[0]["state"], out[1]["state"]):
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(a).all() for a in out[0]["state"])


def test_data_parallel_step_averages_over_ranks():
    """The step's gradient average over a data group equals the full
    batch's when each rank sees half the batch with its half of ε."""
    from svax_torch.parallel import mesh

    x = torch.tensor(_data("gaussian", n=18, seed=4))
    config = vae.VaeConfig(latent_dim=3, num_samples=2)
    state = vae.init_state(torch.Generator().manual_seed(0), 2, config, (6,), (5,),
                           dtype=torch.float64)
    eps = torch.randn((2, 18, 3), generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)
    ref, ref_m = vae.make_train_step(config, 1e-2)(state, x, eps=eps)
    out = mesh.spawn(_dp_step_rank, 2, "cpu", "gloo", args=(x, config, state, eps),
                     timeout=120.0)
    for o in out:
        for got, want in zip(o["params"], _tensors(ref.params)):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
        _close(o["elbo"], float(ref_m["elbo_per_point"]), 1e-12)


def _dp_step_rank(rank: int, world: int, dev, x, config, state, eps) -> dict:
    from svax_torch.parallel import mesh

    group = mesh.make_data_mesh().data_group
    half = x.shape[0] // world
    mine = slice(rank * half, (rank + 1) * half)
    new, m = vae.make_train_step(config, 1e-2, data_group=group)(state, x[mine],
                                                                  eps=eps[:, mine])
    return {"params": _tensors(new.params), "elbo": float(m["elbo_per_point"])}


# ------------------------------------------------------------ train_vae


def test_train_vae_entry_without_jax(tmp_path):
    """``python -m svax_torch.train_vae`` on the CPU: the first line, JSON
    rows after step 1 and every --eval-every, steps/sec; the test ELBO
    improves, rows reach --logfile, and JAX is never imported."""
    log = tmp_path / "vae.jsonl"
    code = ("import sys; from svax_torch import train_vae; "
            "out = train_vae.main(sys.argv[1:]); "
            "assert 'jax' not in sys.modules and 'svax' not in sys.modules")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--device", "cpu", "--steps", "300",
         "--eval-every", "100", "--logfile", str(log), "--batch-size", "128",
         "--encoder-hidden", "20", "20", "--decoder-hidden", "20", "20"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("device=cpu dataset=pinwheel n=400 D=2")
    assert lines[-1].startswith("steps/sec:")
    rows = read_jsonl(log)
    assert [r["step"] for r in rows] == [1, 100, 200, 300]
    assert rows[-1]["test_elbo_per_point"] > rows[0]["test_elbo_per_point"] + 1.0
    if not torch.cuda.is_available():
        from svax_torch import train_vae

        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_vae.main(["--steps", "1"])
