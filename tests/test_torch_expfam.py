"""Port expfam + batched_linalg against the JAX reference (float64).

Dirichlet and NIW maps, expectations, log-partitions and KLs agree with
svax.expfam at rtol 1e-10 (only summation order and special-function
implementations differ); ∇A(η) = E[T] holds under torch.autograd; the
unrolled small-d linear algebra agrees with torch.linalg and with
svax.ops.batched_linalg at 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.expfam import dirichlet as jdir
from svax.expfam import niw as jniw
from svax.ops import batched_linalg as jbl
from svax_torch.expfam import dirichlet, niw
from svax_torch.ops import batched_linalg as bl

torch.set_num_threads(1)
RTOL = 1e-10


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _niw_std(rng, k=5, d=2):
    a = rng.standard_normal((k, d, d))
    return (rng.standard_normal((k, d)), rng.uniform(0.1, 3.0, k),
            a @ np.swapaxes(a, -1, -2) + d * np.eye(d),
            rng.uniform(d + 0.5, d + 6.0, k))


# ------------------------------------------------------------- Dirichlet


def test_dirichlet_matches_jax():
    rng = np.random.default_rng(0)
    aq, ap = rng.uniform(0.3, 5.0, (3, 7)), rng.uniform(0.3, 5.0, (3, 7))
    _close(dirichlet.natural_to_standard(_t(aq - 1.0)), aq)
    _close(dirichlet.expected_log_pi(_t(aq)), jdir.expected_log_pi(jnp.asarray(aq)))
    _close(dirichlet.log_partition(_t(aq)), jdir.log_partition(jnp.asarray(aq)))
    _close(dirichlet.kl(_t(aq), _t(ap)), jdir.kl(jnp.asarray(aq), jnp.asarray(ap)))
    assert (dirichlet.kl(_t(aq), _t(ap)) > 0).all()
    assert torch.allclose(dirichlet.kl(_t(aq), _t(aq)), torch.zeros(3, dtype=torch.float64),
                          atol=1e-12)


def test_dirichlet_grad_log_partition_is_expected_stat():
    eta = _t(np.random.default_rng(1).uniform(-0.5, 4.0, 6)).requires_grad_(True)
    a = dirichlet.log_partition(dirichlet.natural_to_standard(eta))
    (grad,) = torch.autograd.grad(a, eta)
    _close(grad, dirichlet.expected_log_pi(eta.detach() + 1.0).numpy())


# ------------------------------------------------------------------- NIW


@pytest.mark.parametrize("d", [2, 3])
def test_niw_maps_and_expectations_match_jax(d):
    m, kappa, phi, nu = _niw_std(np.random.default_rng(d), d=d)
    std = niw.NiwStandard(_t(m), _t(kappa), _t(phi), _t(nu))
    jstd = jniw.NiwStandard(*(jnp.asarray(a) for a in (m, kappa, phi, nu)))
    nat, jnat = niw.standard_to_natural(std), jniw.standard_to_natural(jstd)
    for got, want in zip(nat, jnat):
        _close(got, want)
    for got, want in zip(niw.natural_to_standard(nat), jniw.natural_to_standard(jnat)):
        _close(got, want, atol=1e-12)
    for got, want in zip(niw.expected_stats_nat(nat), jniw.expected_stats_nat(jnat)):
        _close(got, want)
    _close(niw.log_partition_nat(nat), jniw.log_partition_nat(jnat))


@pytest.mark.parametrize("d", [2, 3])
def test_niw_kl_matches_jax(d):
    rng = np.random.default_rng(10 + d)
    q, p = _niw_std(rng, d=d), _niw_std(rng, d=d)
    got = niw.kl(niw.NiwStandard(*map(_t, q)), niw.NiwStandard(*map(_t, p)))
    want = jniw.kl(jniw.NiwStandard(*map(jnp.asarray, q)),
                   jniw.NiwStandard(*map(jnp.asarray, p)))
    _close(got, want)
    assert (got > 0).all()
    qn = niw.standard_to_natural(niw.NiwStandard(*map(_t, q)))
    _close(niw.kl_nat(qn, qn), np.zeros(len(q[1])), atol=1e-9)


def test_niw_grad_log_partition_is_expected_stats():
    """∇_η A = (E[Λμ], −½E[μᵀΛμ], −½E[Λ], ½E[log|Λ|]) (SURVEY.md §9.2)."""
    m, kappa, phi, nu = _niw_std(np.random.default_rng(5), d=2)
    nat = niw.standard_to_natural(niw.NiwStandard(_t(m), _t(kappa), _t(phi), _t(nu)))
    leaves = [t.clone().requires_grad_(True) for t in nat]
    a = niw.log_partition_nat(niw.NiwNat(*leaves)).sum()
    g1, g2, g3, g4 = torch.autograd.grad(a, leaves)
    ex = niw.expected_stats_nat(nat)
    _close(g1, ex.prec_mean.numpy(), rtol=1e-9)
    _close(g2, (-0.5 * ex.quad).numpy(), rtol=1e-9)
    # η₃ enters A through Φ's lower triangle (the Cholesky reads it), so
    # compare the symmetrised gradient.
    _close(0.5 * (g3 + g3.mT), (-0.5 * ex.prec).numpy(), rtol=1e-9)
    _close(g4, (0.5 * ex.logdet).numpy(), rtol=1e-9)


# --------------------------------------------------------- batched linalg


@pytest.mark.parametrize("d", [1, 2, 3, 5, 20])
def test_batched_linalg_matches_torch_linalg_and_jax(d):
    """d = 20 > UNROLL_MAX exercises the torch.linalg route."""
    rng = np.random.default_rng(d)
    m = rng.standard_normal((4, 3, d, d))
    a = m @ np.swapaxes(m, -1, -2) + d * np.eye(d)
    b = rng.standard_normal((4, 3, d))
    ta, tb = _t(a), _t(b)
    chol = bl.cholesky(ta)
    tol = dict(rtol=1e-9, atol=1e-9)
    _close(chol, torch.linalg.cholesky(ta).numpy(), **tol)
    _close(chol, jbl.cholesky(jnp.asarray(a)), **tol)
    jchol = jbl.cholesky(jnp.asarray(a))
    _close(bl.solve_tril_vec(chol, tb), jbl.solve_tril_vec(jchol, jnp.asarray(b)), **tol)
    _close(bl.solve_triu_vec(chol, tb), jbl.solve_triu_vec(jchol, jnp.asarray(b)), **tol)
    _close(bl.cho_solve_vec(chol, tb),
           torch.linalg.solve(ta, tb.unsqueeze(-1)).squeeze(-1).numpy(), **tol)
    _close(bl.inv_psd(chol), torch.linalg.inv(ta).numpy(), **tol)
    _close(bl.inv_psd(chol), jbl.inv_psd(jchol), **tol)
    _close(bl.logdet_from_chol(chol), torch.linalg.slogdet(ta)[1].numpy(), **tol)
    _close(bl.logdet_from_chol(chol), jbl.logdet_from_chol(jchol), **tol)


def test_batched_linalg_autograd_matches_jax_vjp():
    """Plain autograd through the unrolled recurrences equals the
    reference's analytic custom VJPs."""
    import jax

    rng = np.random.default_rng(3)
    m = rng.standard_normal((6, 3, 3))
    a = m @ np.swapaxes(m, -1, -2) + 3 * np.eye(3)
    b = rng.standard_normal((6, 3))
    w = rng.standard_normal((6, 3))

    def jfun(a_, b_):
        c = jbl.cholesky(a_)
        return jnp.sum(jbl.cho_solve_vec(c, b_) * w) + jnp.sum(jbl.logdet_from_chol(c))

    ja, jb = jax.grad(jfun, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    c = bl.cholesky(ta)
    out = (bl.cho_solve_vec(c, tb) * _t(w)).sum() + bl.logdet_from_chol(c).sum()
    ga, gb = torch.autograd.grad(out, (ta, tb))
    # Both read A's lower triangle only.
    _close(torch.tril(ga), np.tril(np.asarray(ja)), rtol=1e-9, atol=1e-12)
    _close(gb, jb, rtol=1e-9)
