"""The port's Bernoulli mixture against the JAX reference (float64).

* ``expfam.beta`` at rtol 1e-10 (every function, the log-partition's
  gradient identity by autograd);
* ``pgm.bmm``'s pieces at rtol 1e-10, the predictive against brute-force
  enumeration over D = 3 (and total mass 1), ``init_variational`` with the
  reference's rows injected;
* 5 ``bmm_baseline`` steps from converted naturals at rtol 1e-9, constant
  and decaying ρ; ``evaluate``;
* two gloo ranks' step equal to the full batch's (tests/test_bmm.py:192).

JAX is imported inside the tests: the spawned ranks import this module to
find their function and stay free of it.
"""

import itertools

import numpy as np
import pytest
import torch

from svax_torch import convert
from svax_torch.expfam import beta
from svax_torch.models import bmm_baseline
from svax_torch.pgm import bmm

torch.set_num_threads(1)


def _close(got, want, rtol, atol=0.0, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _setup(n=40, d=12, k=4, seed=0):
    """Binary data, the JAX prior and initial naturals (float64), and their
    ports."""
    import jax
    import jax.numpy as jnp

    from svax.pgm import bmm as jbmm

    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=(n, d)) < rng.uniform(0.2, 0.8, size=d)).astype(np.float64)
    jprior = jbmm.make_prior(k, d, alpha=1.3, beta_a=0.9, beta_b=1.4, dtype=jnp.float64)
    jnat = jbmm.init_variational(jax.random.PRNGKey(seed), jprior, jnp.asarray(x))
    prior = convert.bmm_nat_from_numpy(_np(jprior))
    nat = convert.bmm_nat_from_numpy(_np(jnat))
    return x, jprior, jnat, prior, nat


# ------------------------------------------------------------ expfam.beta


def test_beta_matches_jax():
    import jax.numpy as jnp

    from svax.expfam import beta as jbeta

    rng = np.random.default_rng(1)
    ab = rng.uniform(0.3, 5.0, (7, 2))
    ab_p = rng.uniform(0.3, 5.0, (7, 2))
    theta = rng.uniform(0.05, 0.95, 7)
    t, tp, tt = (torch.tensor(a) for a in (ab, ab_p, theta))
    ja, jp, jt = (jnp.asarray(a) for a in (ab, ab_p, theta))
    pairs = [
        (beta.standard_to_natural(t), jbeta.standard_to_natural(ja)),
        (beta.natural_to_standard(t), jbeta.natural_to_standard(ja)),
        (beta.expected_log_theta(t), jbeta.expected_log_theta(ja)),
        (beta.mean(t), jbeta.mean(ja)),
        (beta.log_partition(t), jbeta.log_partition(ja)),
        (beta.log_partition_nat(t), jbeta.log_partition_nat(ja)),
        (beta.kl(t, tp), jbeta.kl(ja, jp)),
        (beta.log_prob(t, tt), jbeta.log_prob(ja, jt)),
    ]
    for i, (got, want) in enumerate(pairs):
        _close(got, want, 1e-10, what=f"beta function {i}")
    # ∇_η A(η) = (E[log θ], E[log(1 − θ)]).
    nat = beta.standard_to_natural(t).requires_grad_(True)
    (g,) = torch.autograd.grad(beta.log_partition_nat(nat).sum(), nat)
    _close(g, beta.expected_log_theta(t).detach(), 1e-10)


# ------------------------------------------------------------ pgm.bmm


def test_bmm_pieces_match_jax():
    import jax.numpy as jnp

    from svax.pgm import bmm as jbmm

    x, jprior, jnat, prior, nat = _setup()
    _close(bmm.make_prior(4, 12, alpha=1.3, beta_a=0.9, beta_b=1.4,
                          dtype=torch.float64).beta_nat, jprior.beta_nat, 1e-12)
    exp, jexp = bmm.expected_params(nat), jbmm.expected_params(jnat)
    for f in bmm.BmmExpected._fields:
        _close(getattr(exp, f), getattr(jexp, f), 1e-10, what=f)
    xt, jx = torch.tensor(x), jnp.asarray(x)
    _close(bmm.log_responsibilities(xt, exp), jbmm.log_responsibilities(jx, jexp), 1e-10)
    resp, ev = bmm.e_step(xt, exp)
    jresp, jev = jbmm.e_step(jx, jexp)
    _close(resp, jresp, 1e-10)
    _close(ev, jev, 1e-10)
    stats = bmm.suff_stats(xt, resp, scale=2.5)
    jstats = jbmm.suff_stats(jx, jresp, scale=2.5)
    for f in bmm.BmmSuffStats._fields:
        _close(getattr(stats, f), getattr(jstats, f), 1e-10, what=f)
    inc, jinc = bmm.stats_to_nat(stats), jbmm.stats_to_nat(jstats)
    _close(inc.dir_nat, jinc.dir_nat, 1e-10)
    _close(inc.beta_nat, jinc.beta_nat, 1e-10)
    _close(bmm.kl_global(nat, prior), jbmm.kl_global(jnat, jprior), 1e-10)
    _close(bmm.predictive_log_prob(nat, xt), jbmm.predictive_log_prob(jnat, jx), 1e-10)


def test_predictive_against_enumeration():
    """D = 3: the exact predictive equals E_q[p(x*|π, θ)] by the factorised
    means, point by point, and sums to 1 over all 2³ binary vectors."""
    rng = np.random.default_rng(2)
    k, d = 3, 3
    alpha = rng.uniform(0.5, 4.0, k)
    ab = rng.uniform(0.5, 4.0, (k, d, 2))
    nat = bmm.BmmNat(torch.tensor(alpha - 1.0), torch.tensor(ab - 1.0))
    grid = np.array(list(itertools.product([0.0, 1.0], repeat=d)))
    got = bmm.predictive_log_prob(nat, torch.tensor(grid)).numpy()
    w = alpha / alpha.sum()
    theta = ab[..., 0] / ab.sum(-1)
    want = [np.log(np.sum(w * np.prod(theta**xi * (1 - theta) ** (1 - xi), axis=-1)))
            for xi in grid]
    _close(got, want, 1e-10)
    _close(np.exp(got).sum(), 1.0, 1e-10)


def test_init_variational_with_injected_rows():
    import jax
    import jax.numpy as jnp

    from svax.pgm import bmm as jbmm

    x, jprior, _, prior, _ = _setup(seed=3)
    key = jax.random.PRNGKey(7)
    jnat = jbmm.init_variational(key, jprior, jnp.asarray(x), pseudo_counts=3.0, blur=0.1)
    rows = np.asarray(jax.random.choice(key, x.shape[0], (4,), replace=False))
    nat = bmm.init_variational(None, prior, torch.tensor(x), pseudo_counts=3.0, blur=0.1,
                               rows=torch.tensor(rows))
    _close(nat.dir_nat, jnat.dir_nat, 1e-12)
    _close(nat.beta_nat, jnat.beta_nat, 1e-12)
    # Drawn from a generator: K distinct rows of the data, blurred.
    drawn = bmm.init_variational(torch.Generator().manual_seed(0), prior, torch.tensor(x))
    locs = (drawn.beta_nat[..., 0] - prior.beta_nat[..., 0]) / 2.0
    raw = (locs - 0.125) / 0.75
    hits = [int(np.flatnonzero((np.abs(x - r.numpy()) < 1e-12).all(-1))[0]) for r in raw]
    assert len(set(hits)) == 4
    state = bmm_baseline.init_state(None, prior, torch.tensor(x), rows=torch.tensor(rows))
    assert state.step == 0
    _close(state.nat.beta_nat, jbmm.init_variational(key, jprior, jnp.asarray(x)).beta_nat,
           1e-12)


# ------------------------------------------------------------ bmm_baseline


@pytest.mark.parametrize("decay", [0.0, 0.3])
def test_baseline_steps_match_jax(decay):
    """5 steps at num_total = 3N (the minibatch scaling) from converted
    naturals: naturals and metrics at rtol 1e-9."""
    import jax
    import jax.numpy as jnp

    from svax.models import bmm_baseline as jbase

    x, jprior, jnat, prior, nat = _setup(seed=4)
    rho = 0.6 if decay == 0.0 else (lambda t: 0.6 / (1.0 + decay * t))
    jstep = jax.jit(jbase.make_train_step(jprior, rho, 3 * x.shape[0]))
    step = bmm_baseline.make_train_step(prior, rho, 3 * x.shape[0])
    jstate = jbase.BmmTrainState(nat=jnat, step=jnp.zeros((), jnp.int32))
    state = convert.bmm_state_from_numpy(_np(jstate))
    xt, jx = torch.tensor(x), jnp.asarray(x)
    for _ in range(5):
        jstate, jm = jstep(jstate, jx)
        state, m = step(state, xt)
        for name in ("local_evidence", "elbo", "rho"):
            _close(m[name], jm[name], 1e-9, what=name)
    assert state.step == int(jstate.step) == 5
    back = convert.bmm_state_to_numpy(state)
    _close(back["nat"]["dir_nat"], jstate.nat.dir_nat, 1e-9)
    _close(back["nat"]["beta_nat"], jstate.nat.beta_nat, 1e-9)


def test_evaluate_matches_jax():
    import jax.numpy as jnp

    from svax.models import bmm_baseline as jbase

    x, jprior, jnat, prior, nat = _setup(seed=5)
    got = bmm_baseline.evaluate(nat, prior, torch.tensor(x[:15]), num_total=x.shape[0])
    want = jbase.evaluate(jnat, jprior, jnp.asarray(x[:15]), num_total=x.shape[0])
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], 1e-10, what=name)


def _dp_rank(rank: int, world: int, dev, x, prior, nat) -> dict:
    """One rank's step on its contiguous half of the batch."""
    from svax_torch.parallel import mesh

    dmesh = mesh.make_data_mesh()
    step = bmm_baseline.make_train_step(prior, 0.3, x.shape[0], data_group=dmesh.data_group)
    half = x.shape[0] // world
    state, m = step(bmm_baseline.BmmTrainState(nat, 0), x[rank * half:(rank + 1) * half])
    return {"dir": state.nat.dir_nat, "beta": state.nat.beta_nat, "elbo": m["elbo"]}


def test_two_ranks_equal_full_batch():
    """Two gloo ranks' statistics summed over the group equal the full
    batch's step (float64, rtol 1e-12)."""
    from svax_torch.parallel import mesh

    rng = np.random.default_rng(3)
    x = torch.tensor((rng.uniform(size=(64, 6)) < 0.5).astype(np.float64))
    prior = bmm.make_prior(4, 6, dtype=torch.float64)
    nat = bmm.init_variational(torch.Generator().manual_seed(0), prior, x)
    ref, ref_m = bmm_baseline.make_train_step(prior, 0.3, 64)(
        bmm_baseline.BmmTrainState(nat, 0), x)
    out = mesh.spawn(_dp_rank, 2, "cpu", "gloo", args=(x, prior, nat), timeout=120.0)
    for o in out:
        _close(o["dir"], ref.nat.dir_nat.numpy(), 1e-12)
        _close(o["beta"], ref.nat.beta_nat.numpy(), 1e-12)
        _close(o["elbo"], float(ref_m["elbo"]), 1e-12)
