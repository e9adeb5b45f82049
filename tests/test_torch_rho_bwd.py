"""The redesigned ρ-kernel backward (csrc/combine.cu: log_rho_bwd) on the
CPU: its formulas and its block plan.

* ``combine.log_rho_grads_lean`` — the train step's call (no dw) as the
  kernel forms it: h̃̄ = ρ̄μ̃ and diag G = −½ρ̄(diag Σ̃ + μ̃²) with diag Σ̃ the
  column sums of squares of L̃⁻¹, summed over k in order — against
  autograd of ``log_rho_plain`` in float64 at 1e-10 and against the
  reference's ``_rho_bwd_call`` (the vjp of ``combine_pallas.log_rho_fused``
  run by the Pallas interpreter) in float32 at 5e-4 of each gradient's
  largest entry (tests/test_combine_kernel.py's bar), d = 2 and 10, ragged
  N;
* the backward with dw as the kernel sums it: the per-(n, k) planes
  [ρ̄, ρ̄μ̃, G's lower triangle] added in the plan's order (each block's
  rows in order, the blocks in reduce_planes' two levels) and expanded by
  the reduce's layout equal ``log_rho_grads_manual``'s dw in float64;
* the plan at the shape class's edges (N = 1, 31, 400, 16,384; K = 1, 10,
  64, 128; d = 10; with and without dw): every row owned by one block, the
  grid within ``rho_blocks``' bound, the partial within the scratch the
  wrapper sizes from it, shared memory within the card's 232,448 bytes.

The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_cuda_combine_comp.py.
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

GRAD_TOL = 5e-4


def _f64_inputs(n, k, d, seed):
    rng = np.random.default_rng(seed)
    f64 = torch.float64
    pot_h = torch.tensor(rng.standard_normal((n, d)), dtype=f64)
    pot_p = torch.tensor(0.3 + rng.random((n, d)), dtype=f64)
    nat = gmm.init_variational(torch.Generator().manual_seed(seed), gmm.make_prior(k, d, dtype=f64))
    w = combine.pack_expected(gmm.expected_params(nat))
    drho = torch.tensor(rng.standard_normal((n, k)), dtype=f64)
    return pot_h, pot_p, w, drho


@pytest.mark.parametrize("n,k,d", [(7, 3, 2), (37, 5, 2), (13, 4, 10), (41, 7, 10)])
def test_lean_mirror_matches_autograd(n, k, d):
    pot_h, pot_p, w, drho = _f64_inputs(n, k, d, n + d)
    leaves = [t.clone().requires_grad_(True) for t in (pot_h, pot_p)]
    lr = combine.log_rho_plain(leaves[0], leaves[1], combine.unpack_expected(w, d))
    want = torch.autograd.grad(lr, leaves, grad_outputs=drho)
    got = combine.log_rho_grads_lean(pot_h, pot_p, w, drho)
    for g, ref, name in zip(got, want, ("pot_h", "pot_p")):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(ref.abs().max()), err_msg=name)


@pytest.mark.parametrize("n,k,d", [(37, 5, 2), (130, 10, 2), (41, 7, 10), (9, 12, 10)])
def test_lean_mirror_matches_the_interpreted_kernel(n, k, d):
    rng = np.random.default_rng(n * d)
    pot_h = rng.standard_normal((n, d)).astype(np.float32)
    pot_p = (0.3 + rng.random((n, d))).astype(np.float32)
    prior = jgmm.make_prior(k, d)
    nat = jax.tree.map(lambda a: a.astype(jnp.float32),
                       jgmm.init_variational(jax.random.PRNGKey(n), prior))
    jexp = jgmm.expected_params(nat)
    drho = rng.standard_normal((n, k)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: cp.log_rho_fused(a, b, jexp, interpret=True), pot_h, pot_p)
    want = vjp(jnp.asarray(drho))
    exp = gmm.GmmExpected(**{f: torch.tensor(np.asarray(getattr(jexp, f)))
                             for f in gmm.GmmExpected._fields})
    got = combine.log_rho_grads_lean(torch.tensor(pot_h), torch.tensor(pot_p),
                                     combine.pack_expected(exp), torch.tensor(drho))
    for g, ref, name in zip(got, want, ("pot_h", "pot_p")):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * float(np.abs(ref).max()), err_msg=name)


@pytest.mark.parametrize("sms,per_sm", [(132, 2), (3, 1), (1, 1)])
@pytest.mark.parametrize("n,k,d", [(9, 5, 2), (130, 10, 4), (77, 13, 10), (33, 100, 10)])
def test_dw_in_the_plans_order_equals_the_manual_backward(n, k, d, sms, per_sm):
    pot_h, pot_p, w, drho = _f64_inputs(n, k, d, k + d)
    threads = combine.BLOCK_THREADS
    blocks = combine.grid_blocks(n, k, threads, sms, sms * per_sm)
    planes = combine.log_rho_dw_planes(pot_h, pot_p, w, drho)
    assert planes.shape == (n, k, combine.partial_planes(d))
    summed = combine.plan_sum(planes, k, threads, sms, blocks)
    dw = combine.rho_dw_from_planes(summed, d)
    want = combine.log_rho_grads_manual(pot_h, pot_p, w, drho)[2]
    np.testing.assert_allclose(dw.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-10 * float(want.abs().max()))


def _rho_bwd_bytes(k: int, nt: int, d: int, dw: bool) -> int:
    """csrc/combine.cu: rho_bwd_bytes — w's rows, [h̃̄, diag G] at an odd
    plane stride and, with dw, each thread's planes."""
    return 4 * (combine.slot_width(d) * k + (nt | 1) * 2 * d
                + nt * (combine.partial_planes(d) if dw else 0))


@pytest.mark.parametrize("dw", [False, True])
@pytest.mark.parametrize("k", [1, 10, 64, 128])
@pytest.mark.parametrize("n", [1, 31, 400, 16384])
def test_plan_at_the_shape_class_edges(n, k, dw):
    d, sms, threads = 10, 132, combine.BLOCK_THREADS
    rows = combine.rows_per_block(n, k, threads, sms)
    bound = combine.row_groups(n, k, threads, sms)  # rho_blocks(n, k)
    assert rows * k <= threads
    for per_sm in (1, 2, 4):
        blocks = combine.grid_blocks(n, k, threads, sms, sms * per_sm)
        assert 1 <= blocks <= bound
        owned = [row for b in range(blocks)
                 for rs in combine.block_rows(b, n, k, threads, sms, blocks) for row in rs]
        assert sorted(owned) == list(range(n))
        assert blocks * k * combine.partial_planes(d) <= bound * k * combine.slot_width(d)
    assert _rho_bwd_bytes(k, rows * k, d, dw) <= 232448
