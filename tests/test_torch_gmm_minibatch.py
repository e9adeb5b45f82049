"""``svax_torch.train_gmm``'s minibatch mode (``--batch-size``,
``--rho-decay``) against the reference's ``gmm_baseline`` step (float64):

* ``train_gmm.minibatch_step`` over an injected (T, M) index stack with
  ρ_t = ρ/(1 + decay·t) equals the JAX step over the same rows, rtol 1e-9;
* the entry's run equals the JAX step over the rows its generator draws;
* ``--engine kernel`` with a minibatch or a decaying ρ is refused with
  mixstep's gate reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.data import load_pinwheel
from svax.models import gmm_baseline as jgmm_baseline
from svax.pgm import gmm as jgmm
from svax_torch import convert, train_gmm
from svax_torch.models import gmm_baseline
from svax_torch.pgm.gmm import GmmNat
from svax_torch.train.loop import minibatch_indices

torch.set_num_threads(1)


def _jax_run(jprior, nat: GmmNat, x: np.ndarray, stack, rho, decay, n):
    """The reference's step over x[stack[t]], from the port's naturals."""
    nat_np = convert.gmm_nat_to_numpy(nat)
    jnat = jgmm.GmmNat(jnp.asarray(nat_np["dir_nat"]), jgmm.NiwNat(
        *(jnp.asarray(nat_np[f]) for f in ("eta1", "eta2", "eta3", "eta4"))))
    sched = lambda t: rho / (1.0 + decay * t)  # noqa: E731
    jstep = jax.jit(jgmm_baseline.make_train_step(jprior, sched, num_total=n))
    jstate = jgmm_baseline.GmmTrainState(nat=jnat, step=jnp.zeros((), jnp.int32))
    elbos = []
    for idx in stack:
        jstate, m = jstep(jstate, jnp.asarray(x[np.asarray(idx)]))
        elbos.append(float(m["elbo"]))
    return jstate, elbos


def _assert_nat(nat: GmmNat, jnat, rtol=1e-9):
    got = convert.gmm_nat_to_numpy(nat)
    for name, want in zip(("dir_nat", "eta1", "eta2", "eta3", "eta4"),
                          (jnat.dir_nat, *jnat.niw_nat)):
        np.testing.assert_allclose(got[name], np.asarray(want), rtol=rtol, err_msg=name)


def test_minibatch_step_over_injected_stack():
    train, _ = load_pinwheel(seed=0)
    n = train.shape[0]
    rng = np.random.default_rng(0)
    stack = np.stack([rng.choice(n, 48, replace=False) for _ in range(5)])
    jprior = jgmm.make_prior(6, 2, kappa=0.05, dtype=jnp.float64)
    prior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior))
    x = torch.tensor(train)
    nat = gmm_baseline.init_state(torch.Generator().manual_seed(1), prior, x).nat
    step = gmm_baseline.make_train_step(prior, lambda t: 0.7 / (1.0 + 0.05 * t), num_total=n)
    fn = train_gmm.minibatch_step(step, x, 48, indices=torch.tensor(stack))
    state = gmm_baseline.GmmTrainState(nat=nat, step=0)
    elbos, rhos = [], []
    for _ in range(5):
        state, m = fn(state, None)
        elbos.append(float(m["elbo"]))
        rhos.append(float(m["rho"]))
    jstate, jelbos = _jax_run(jprior, nat, train, stack, 0.7, 0.05, n)
    _assert_nat(state.nat, jstate.nat)
    np.testing.assert_allclose(elbos, jelbos, rtol=1e-9)
    np.testing.assert_allclose(rhos, [0.7 / (1 + 0.05 * t) for t in range(5)], rtol=1e-12)


def test_entry_minibatch_run_matches_jax(float64_default):
    """``train_gmm --batch-size 64 --rho-decay 0.02 --engine plain``: the final
    naturals equal the reference step's over the rows the entry's
    generator (seeded --seed + 1) draws."""
    steps, seed = 7, 3
    out = train_gmm.main(["--config", "pinwheel-gmm", "--device", "cpu", "--engine", "plain",
                          "--batch-size", "64", "--rho", "0.8", "--rho-decay", "0.02",
                          "--steps", str(steps), "--eval-every", "3", "--seed", str(seed)])
    assert [r["step"] for r in out["rows"]] == [1, 3, 6]
    train, _ = load_pinwheel(seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    stack = [minibatch_indices(gen, train.shape[0], 64, 1, replace=False)[0].numpy()
             for _ in range(steps)]
    assert all(len(set(s.tolist())) == 64 for s in stack)
    prior = jgmm.make_prior(10, 2, alpha=1.0, kappa=0.05, dtype=jnp.float64)
    init = gmm_baseline.init_state(
        torch.Generator().manual_seed(seed),
        convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, prior)),
        torch.tensor(train)).nat
    jstate, _ = _jax_run(prior, init, train, stack, 0.8, 0.02, train.shape[0])
    _assert_nat(out["state"].nat, jstate.nat)


@pytest.mark.parametrize("flag, reason", [
    (["--batch-size", "64"], "the mixstep kernel trains on the full batch only"),
    (["--rho-decay", "0.1"], "the mixstep kernel needs a constant rho"),
])
def test_kernel_engine_refuses_minibatch_and_decay(flag, reason):
    with pytest.raises(ValueError, match=f"--engine kernel: {reason}"):
        train_gmm.main(["--config", "pinwheel-gmm", "--device", "cpu", "--steps", "4",
                        *flag])


@pytest.fixture
def float64_default():
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)
