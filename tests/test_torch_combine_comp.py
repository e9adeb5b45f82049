"""The port's ρ-kernel and the combine's log_norm mode (their plain versions,
on the CPU) against the JAX reference, and their hand-written backwards
against autograd.

* ``log_rho_plain`` (what ``log_rho_fused`` runs on CPU tensors) against
  ``combine_pallas.log_rho_fused`` run by the Pallas interpreter;
* ``combine_fused(log_norm=)`` against the reference's
  ``combine_fused(..., interpret=True, log_norm=)`` on each K-shard of a
  mixture, with the logsumexp taken across the shards: values at 2e-5,
  and gradients through the ρ → lse → combine chain at 5e-4 (the bars of
  tests/test_combine_kernel.py:223-262), and the one-shard identity with
  the softmax mode;
* ``combine_grads_manual(log_norm=)``, including the normaliser's
  cotangent dn, and ``log_rho_grads_manual`` (the formulas the CUDA
  kernels transcribe) against autograd in float64 at 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.ops import combine_pallas as cp
from svax.pgm import gmm as jgmm
from svax_torch.ops import combine
from svax_torch.pgm import gmm

torch.set_num_threads(1)

VALUE_TOL = 2e-5
GRAD_TOL = 5e-4
CASES = [(40, 5, 2, 2), (130, 10, 3, 1), (32, 6, 10, 1)]


def _inputs(n, k, d, s, seed=0):
    """tests/test_combine_kernel.py:_inputs: numpy data, the JAX naturals."""
    rng = np.random.default_rng(seed)
    pot_h = rng.standard_normal((n, d)).astype(np.float32)
    pot_p = (0.3 + rng.random((n, d))).astype(np.float32)
    prior = jgmm.make_prior(k, d)
    nat = jax.tree.map(lambda a: a.astype(jnp.float32),
                       jgmm.init_variational(jax.random.PRNGKey(seed), prior))
    jexp = jgmm.expected_params(nat)
    eps = rng.standard_normal((s, n, k, d)).astype(np.float32)
    exp = gmm.GmmExpected(**{f: torch.tensor(np.asarray(getattr(jexp, f)))
                             for f in gmm.GmmExpected._fields})
    return pot_h, pot_p, jexp, exp, eps


def _shard(exp, i, count):
    """Shard i of ``count`` along K of either package's GmmExpected."""
    k = exp.log_pi.shape[0] // count
    return type(exp)(*(t[i * k:(i + 1) * k] for t in exp))


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("n,k,d,s", CASES)
def test_log_rho_plain_matches_the_interpreted_kernel(n, k, d, s):
    pot_h, pot_p, jexp, exp, _ = _inputs(n, k, d, s)
    got = combine.log_rho_fused(torch.tensor(pot_h), torch.tensor(pot_p), exp)
    assert combine.rho_launches == 0  # CPU tensors: the plain version
    want = cp.log_rho_fused(pot_h, pot_p, jexp, interpret=True)
    _close(got, want, VALUE_TOL, "log rho")


@pytest.mark.parametrize("n,k,d,s", CASES)
def test_sharded_log_norm_combine_matches_the_interpreted_kernel(n, k, d, s):
    """Two K-shards, each with its own log ρ, the logsumexp across them,
    then each shard's log_norm combine: the port's plain version against
    the reference's interpreted kernel, every output."""
    pot_h, pot_p, jexp, exp, eps = _inputs(n, k * 2, d, s, seed=1)
    ph, pp = torch.tensor(pot_h), torch.tensor(pot_p)
    rho = [combine.log_rho_fused(ph, pp, _shard(exp, i, 2)) for i in range(2)]
    lse = torch.logsumexp(torch.cat(rho, dim=1), dim=-1)
    jrho = [cp.log_rho_fused(pot_h, pot_p, _shard(jexp, i, 2), interpret=True)
            for i in range(2)]
    jlse = jax.nn.logsumexp(jnp.concatenate(jrho, axis=1), axis=-1)
    _close(lse, jlse, VALUE_TOL, "cross-shard lse")
    for i in range(2):
        e = eps[:, :, i * k:(i + 1) * k]
        got = combine.combine_fused(ph, pp, _shard(exp, i, 2), torch.tensor(e), s,
                                    scale=2.5, log_norm=lse)
        want = cp.combine_fused(pot_h, pot_p, _shard(jexp, i, 2), e, s, scale=2.5,
                                interpret=True, log_norm=jlse)
        for name, g, w in zip(("z", "log_resp", "mean", "local"), got[:4], want[:4]):
            _close(g, w, VALUE_TOL, f"shard {i} {name}")
        for f in ("counts", "mean_stat", "scatter_stat"):
            _close(getattr(got[4], f), getattr(want[4], f), VALUE_TOL, f"shard {i} {f}")
    assert combine.norm_launches == 0


def _chain_scalar(out):
    """tests/test_combine_kernel.py:251-256's functional, either package."""
    z, lr, _, local, st = out
    if isinstance(z, torch.Tensor):
        return ((torch.exp(lr) * torch.tanh(z).sum(dim=(0, -1))).sum() - local.sum()
                + 0.01 * st.scatter_stat.sum())
    return (jnp.sum(jnp.exp(lr) * jnp.sum(jnp.tanh(z), axis=(0, -1))) - jnp.sum(local)
            + 0.01 * jnp.sum(st.scatter_stat))


def test_chain_gradients_match_jax():
    """Gradients w.r.t. the potentials and every expected-parameter field
    through ρ-kernel → logsumexp → log_norm combine, one shard of two
    differentiated (the other's log ρ held in the lse), against the
    reference's interpreted kernels."""
    n, k, d, s = 40, 4, 3, 2
    pot_h, pot_p, jexp, exp, eps = _inputs(n, 2 * k, d, s, seed=5)
    e0 = eps[:, :, :k]
    jother = cp.log_rho_fused(pot_h, pot_p, _shard(jexp, 1, 2), interpret=True)

    def jfun(a, b, e):
        lr = cp.log_rho_fused(a, b, e, interpret=True)
        nrm = jax.nn.logsumexp(jnp.concatenate([lr, jother], axis=1), axis=-1)
        return _chain_scalar(cp.combine_fused(a, b, e, e0, s, interpret=True, log_norm=nrm))

    jg_h, jg_p, jg_e = jax.grad(jfun, argnums=(0, 1, 2))(pot_h, pot_p, _shard(jexp, 0, 2))
    other = combine.log_rho_fused(torch.tensor(pot_h), torch.tensor(pot_p), _shard(exp, 1, 2))
    leaves = [torch.tensor(pot_h, requires_grad=True), torch.tensor(pot_p, requires_grad=True),
              *(t.clone().requires_grad_(True) for t in _shard(exp, 0, 2))]
    e = gmm.GmmExpected(*leaves[2:])
    lr = combine.log_rho_fused(leaves[0], leaves[1], e)
    nrm = torch.logsumexp(torch.cat([lr, other], dim=1), dim=-1)
    loss = _chain_scalar(combine.combine_fused(leaves[0], leaves[1], e, torch.tensor(e0), s,
                                               log_norm=nrm))
    grads = torch.autograd.grad(loss, leaves)
    _close(grads[0], jg_h, GRAD_TOL, "pot_h")
    _close(grads[1], jg_p, GRAD_TOL, "pot_p")
    for f, g in zip(gmm.GmmExpected._fields, grads[2:]):
        _close(g, getattr(jg_e, f), GRAD_TOL, f)


def test_one_shard_log_norm_is_the_softmax():
    """log_norm = lse(log ρ) over the whole K reproduces the softmax mode:
    values and gradients (tests/test_combine_kernel.py:223-262 on the
    port's side)."""
    pot_h, pot_p, _, exp, eps = _inputs(40, 5, 3, 2, seed=5)
    ph, pp, ep = torch.tensor(pot_h), torch.tensor(pot_p), torch.tensor(eps)
    lse = torch.logsumexp(combine.log_rho_fused(ph, pp, exp), dim=-1)
    for a, b in zip(combine.combine_fused(ph, pp, exp, ep, 2)[:4],
                    combine.combine_fused(ph, pp, exp, ep, 2, log_norm=lse)[:4]):
        _close(a, b.numpy(), VALUE_TOL, "value")

    def grads(use_norm):
        leaves = [t.clone().requires_grad_(True) for t in (ph, pp, *exp)]
        e = gmm.GmmExpected(*leaves[2:])
        nrm = (torch.logsumexp(combine.log_rho_fused(leaves[0], leaves[1], e), dim=-1)
               if use_norm else None)
        out = combine.combine_fused(leaves[0], leaves[1], e, ep, 2, log_norm=nrm)
        return torch.autograd.grad(_chain_scalar(out), leaves)

    for a, b in zip(grads(True), grads(False)):
        _close(a, b.numpy(), GRAD_TOL, "gradient")


def _f64_inputs(n, k, d, s, seed):
    rng = np.random.default_rng(seed)
    f64 = torch.float64
    pot_h = torch.tensor(rng.standard_normal((n, d)), dtype=f64)
    pot_p = torch.tensor(0.3 + rng.random((n, d)), dtype=f64)
    prior = gmm.make_prior(k, d, dtype=f64)
    nat = gmm.init_variational(torch.Generator().manual_seed(seed), prior)
    w = combine.pack_expected(gmm.expected_params(nat))
    eps = torch.tensor(rng.standard_normal((s, n, k, d)), dtype=f64)
    return rng, pot_h, pot_p, w, eps


def _assert_grads(got, want, names, what):
    for g, ref, name in zip(got, want, names):
        np.testing.assert_allclose(g.numpy(), ref.detach().numpy(), rtol=1e-10,
                                   atol=1e-10 * float(ref.abs().max()),
                                   err_msg=f"{name} {what}")


@pytest.mark.parametrize("n,k,d,s", [(7, 3, 2, 2), (5, 4, 3, 1), (3, 4, 10, 2)])
def test_manual_log_norm_backward_matches_autograd(n, k, d, s):
    """combine_grads_manual(log_norm=) against autograd of
    combine_raw_plain(log_norm=) in float64, for the five cotangent paths
    alone and together: the cotangents of pot_h, pot_p, w and dn."""
    rng, pot_h, pot_p, w, eps = _f64_inputs(n, k, d, s, d)
    # A normaliser from a wider mixture: this shard's lse plus others'.
    log_norm = (torch.logsumexp(combine.log_rho_plain(pot_h, pot_p,
                                                      combine.unpack_expected(w, d)), -1)
                + torch.tensor(rng.random(n)))
    shapes = [(s, n, k, d), (n, k), (n, k, d), (n,), (k, combine.stats_width(d))]
    cts = [torch.tensor(rng.standard_normal(sh), dtype=torch.float64) for sh in shapes]
    for paths in [range(5)] + [[j] for j in range(5)]:
        c = [cts[j] if j in paths else None for j in range(5)]
        leaves = [t.clone().requires_grad_(True) for t in (pot_h, pot_p, w, log_norm)]
        outs = combine.combine_raw_plain(*leaves[:3], eps, log_norm=leaves[3])
        loss = sum((o * ct).sum() for o, ct in zip(outs, c) if ct is not None)
        want = [torch.zeros_like(t) if g is None else g
                for g, t in zip(torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
        got = combine.combine_grads_manual(pot_h, pot_p, w, eps, *c, log_norm=log_norm)
        _assert_grads(got, want, ("pot_h", "pot_p", "w", "dn"),
                      f"through paths {list(paths)}")


@pytest.mark.parametrize("n,k,d", [(7, 3, 2), (5, 4, 3), (3, 4, 10)])
def test_manual_log_rho_backward_matches_autograd(n, k, d):
    rng, pot_h, pot_p, w, _ = _f64_inputs(n, k, d, 1, d + 1)
    drho = torch.tensor(rng.standard_normal((n, k)))
    leaves = [t.clone().requires_grad_(True) for t in (pot_h, pot_p, w)]
    lr = combine.log_rho_plain(leaves[0], leaves[1], combine.unpack_expected(leaves[2], d))
    want = torch.autograd.grad((lr * drho).sum(), leaves)
    got = combine.log_rho_grads_manual(pot_h, pot_p, w, drho)
    _assert_grads(got, want, ("pot_h", "pot_p", "w"), "of log rho")


def test_log_norm_shape_is_checked_before_a_launch():
    """A CUDA-less host still reaches the wrapper's argument checks for a
    non-CPU device: anything but a CUDA tensor raises rather than falling
    back."""
    pot_h, pot_p, _, exp, eps = _inputs(8, 3, 2, 1)
    meta = torch.device("meta")
    ph = torch.empty((8, 2), device=meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        combine.log_rho_fused(ph, ph, gmm.GmmExpected(*(t.to(meta) for t in exp)))
    with pytest.raises(ValueError, match="no kernel for device"):
        combine.combine_fused(ph, ph, gmm.GmmExpected(*(t.to(meta) for t in exp)),
                              torch.empty((1, 8, 3, 2), device=meta), 1,
                              log_norm=torch.empty((8,), device=meta))
