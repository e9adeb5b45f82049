"""The port's checkpoint/resume (``svax_torch.train.checkpoint``), following
tests/test_checkpoint.py:

* an exact-resume round trip for the per-step engine and for the plain
  versions of the three whole-step kernels (tinystep, flexstep, mixstep):
  two chunks uninterrupted equal a chunk, a save, a restore into a fresh
  template and a chunk, bit for bit — NN params, Adam moments and count,
  the naturals, the step — with the "a different seed changes the result"
  guard, and mixstep's one launch equal to two;
* the trainer's generator state round trip;
* pass-through on an empty directory, refusal of a mismatched template
  (a missing or extra leaf, a shape, a dtype), ``max_to_keep`` and the
  atomic write.

The reference side is the JAX package's own state at the same layout:
a JAX SvaeTrainState converted into the port saves and restores equal.
"""

import numpy as np
import pytest
import torch

from svax_torch.data.pinwheel import make_pinwheel_data
from svax_torch.models import gmm_baseline
from svax_torch.models.svae import SvaeConfig
from svax_torch.pgm import gmm
from svax_torch.train import loop, svae_step
from svax_torch.train.checkpoint import Checkpointer
from svax_torch.utils.tree import flatten

torch.set_num_threads(1)


def _leaves(tree) -> list:
    return flatten(tree)


def _assert_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert type(x) is type(y) and x == y, path


def _differs(a, b) -> bool:
    return any(isinstance(x, torch.Tensor) and not torch.equal(x, y)
               for (_, x), (_, y) in zip(_leaves(a), _leaves(b)))


def _setup(seed=0, k=3, n=48, s=2, latent=2, hidden=(8, 8), dtype=torch.float32):
    x = torch.tensor(make_pinwheel_data(num_classes=3, num_per_class=n // 3, seed=0)[:n],
                     dtype=dtype)
    config = SvaeConfig(latent_dim=latent, num_components=k, num_samples=s, num_total=n)
    prior = gmm.make_prior(k, latent, kappa=0.05, dtype=dtype)
    state = svae_step.init_state(torch.Generator().manual_seed(seed), 2, config, prior,
                                 hidden, hidden, data=x)
    return x, config, prior, state


def _resume_roundtrip(tmp_path, runner, state0, fresh, x, **kw):
    """Uninterrupted (two chunks) vs chunk → save → restore → chunk."""
    ref, _ = runner(state0, x, 4, **kw)
    ref, _ = runner(ref, x, 4, **kw)
    half, _ = runner(state0, x, 4, **kw)
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(4, half)
    restored, _, start = ckpt.restore_or(fresh)
    assert start == 4
    _assert_equal(restored, half)
    resumed, _ = runner(restored, x, 4, **kw)
    _assert_equal(ref, resumed)
    return restored, resumed


def test_exact_resume_per_step_engine(tmp_path):
    """The per-step engine (make_step_runner, float64): its noise is keyed
    seed + state.step, so the restored state replays the same draws."""
    x, config, prior, state0 = _setup(dtype=torch.float64, hidden=(8,))
    runner = loop.make_step_runner(config, prior, lr=1e-3, rho=0.2, engine="plain")
    _, _, _, fresh = _setup(seed=9, dtype=torch.float64, hidden=(8,))
    restored, resumed = _resume_roundtrip(tmp_path, runner, state0, fresh, x, seed=3)
    assert resumed.step == 8 and resumed.opt_state.count == 8
    assert isinstance(restored.step, int) and isinstance(restored.opt_state.count, int)
    alt, _ = runner(restored, x, 4, seed=4)
    assert _differs(alt, resumed)


def test_exact_resume_tinystep_plain(tmp_path):
    x, config, prior, state0 = _setup()
    runner = loop.make_runner(config, prior, lr=3e-3, rho=0.2, kernel="tinystep")
    _, _, _, fresh = _setup(seed=7)
    restored, resumed = _resume_roundtrip(tmp_path, runner, state0, fresh, x, seed=5)
    assert resumed.step == 8
    # The seed reaches the noise: another seed on the resumed chunk differs.
    alt, _ = runner(restored, x, 4, seed=6)
    assert _differs(alt.nn_params, resumed.nn_params)


def test_exact_resume_flexstep_plain(tmp_path):
    """Minibatches and ρ decay: the batch stack's draw keys on the step too."""
    x, config, prior, state0 = _setup(latent=3)
    runner = loop.make_runner(config, prior, lr=3e-3, rho=0.2, rho_decay=0.01,
                              batch_size=16, kernel="flexstep")
    _, _, _, fresh = _setup(seed=7, latent=3)
    restored, resumed = _resume_roundtrip(tmp_path, runner, state0, fresh, x, seed=3)
    assert resumed.step == 8
    alt, _ = runner(restored, x, 4, seed=4)
    assert _differs(alt.nn_params, resumed.nn_params)


@pytest.mark.parametrize("dof", [0.0, 4.0])
def test_exact_resume_mixstep_plain(tmp_path, dof):
    """The mixture step is deterministic: resume parity AND one 8-step
    chunk equal to two 4-step chunks."""
    x = torch.tensor(make_pinwheel_data(num_classes=3, num_per_class=16, seed=0),
                     dtype=torch.float32)
    prior = gmm.make_prior(4, 2, kappa=0.05)
    state0 = gmm_baseline.init_state(torch.Generator().manual_seed(0), prior, x)
    fresh = gmm_baseline.init_state(torch.Generator().manual_seed(7), prior, x)
    runner = loop.make_mixture_runner(prior, rho=0.2, dof=dof)
    _, resumed = _resume_roundtrip(tmp_path, runner, state0, fresh, x)
    assert resumed.step == 8
    one_shot, _ = runner(state0, x, 8)
    _assert_equal(one_shot, resumed)


def test_generator_state_round_trip(tmp_path):
    """The trainer's generator: its state is saved, set on the template
    generator at restore, and that generator then draws what the saved one
    would have drawn."""
    x, config, prior, state = _setup()
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(3, state, gen)
    want = torch.rand(7, generator=gen)
    other = torch.Generator().manual_seed(0)
    _, got_gen, start = ckpt.restore_or(state, other)
    assert start == 3 and got_gen is other
    assert torch.equal(torch.rand(7, generator=other), want)
    # A state tensor in place of a generator comes back as the saved tensor.
    _, saved, _ = ckpt.restore_or(state, torch.Generator().get_state())
    assert isinstance(saved, torch.Tensor) and saved.dtype == torch.uint8


def test_restore_or_passthrough_on_empty(tmp_path):
    _, _, _, state = _setup()
    gen = torch.Generator().manual_seed(1)
    ckpt = Checkpointer(tmp_path / "empty")
    same, same_gen, start = ckpt.restore_or(state, gen)
    assert start == 0 and same is state and same_gen is gen
    assert ckpt.latest_step() is None


@pytest.mark.parametrize("change", ["hidden", "structure", "dtype", "int_leaf"])
def test_mismatched_template_raises(tmp_path, change):
    """A template whose leaves, shapes or dtypes differ raises; nothing is
    loaded in part."""
    x, config, prior, state = _setup()
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(2, state)
    if change == "hidden":
        template = _setup(hidden=(8, 9))[3]
        match = "nn_params"
    elif change == "structure":
        template = _setup(hidden=(8,))[3]
        match = "leaves differ"
    elif change == "dtype":
        template = _setup(dtype=torch.float64)[3]
        match = "float64"
    else:
        template = state._replace(step=torch.zeros(3))
        match = "step"
    with pytest.raises(ValueError, match=match):
        ckpt.restore_or(template)


def test_max_to_keep_and_atomic_write(tmp_path):
    _, _, _, state = _setup()
    ckpt = Checkpointer(tmp_path / "ck", max_to_keep=2)
    for step in range(1, 6):
        ckpt.save(step, state._replace(step=step))
    assert ckpt.all_steps() == [4, 5]
    names = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert names == ["step_4.pt", "step_5.pt"]  # no temporary left behind
    restored, _, start = ckpt.restore_or(state)
    assert start == 5 and restored.step == 5
    # Saving a step again replaces it in place.
    ckpt.save(5, state._replace(step=50))
    assert ckpt.restore_or(state)[0].step == 50


def test_jax_state_saves_and_restores_equal(tmp_path):
    """A JAX SvaeTrainState converted into the port goes through a
    checkpoint unchanged and converts back to the same numpy arrays."""
    import jax
    import jax.numpy as jnp
    import optax

    from svax.models.svae import SvaeConfig as JConfig
    from svax.pgm import gmm as jgmm
    from svax.train import svae_step as jstep
    from svax_torch import convert

    jconfig = JConfig(latent_dim=2, num_components=3, num_samples=1, num_total=48)
    jprior = jgmm.make_prior(3, 2, dtype=jnp.float32)
    jstate = jstep.init_state(jax.random.PRNGKey(0), 2, jconfig, jprior, optax.adam(1e-3),
                              (8,), (8,))
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate))
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(0, state)
    template = _setup(k=3, hidden=(8,))[3]
    restored, _, _ = ckpt.restore_or(template)
    back = convert.state_to_numpy(restored)
    want = jax.tree.map(np.asarray, jstate)
    np.testing.assert_array_equal(back["pgm_nat"]["eta3"], want.pgm_nat.niw_nat.eta3)
    for side in ("encoder", "decoder"):
        for got, ref in zip(back["nn_params"][side], want.nn_params[side]):
            np.testing.assert_array_equal(got["w"], ref["w"])
            np.testing.assert_array_equal(got["b"], ref["b"])
