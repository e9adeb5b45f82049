"""The redesigned ρ-kernel forward (csrc/combine.cu: log_rho_fwd) on the CPU:
its arithmetic and its block plan.

* the kernel's per-(n, k) arithmetic — ``recompute<D, kDivide = true,
  kRaw = true>`` on w's rows as they lie: the Cholesky of diag(p) + E[Λ]
  from E[Λ]'s lower triangle, both solves dividing by L̃_ii, log|J̃| and
  log ρ — transcribed here in PyTorch, against autograd's function,
  ``log_rho_plain``, in float64 at 1e-10, and against the reference's
  ``combine_pallas.log_rho_fused`` run by the Pallas interpreter in float32
  at 2e-5 (tests/test_combine_kernel.py's bar), d = 2 and 10, ragged N;
* the plan at the shape class's edges (N = 1, 31, 400, 16,384; K = 1, 10,
  64, 128; d = 10; one to four blocks an SM): every row owned by one block,
  the grid within ``rho_blocks``, shared memory within the card's 232,448
  bytes;
* the copy of w: the TMA bulk copy a multiple of 16 bytes from w's
  (16-byte aligned) start, with the tail the threads copy it covers w's
  K·(3 + d + d²) floats once, and nothing past its end is read; the
  mbarrier after w's rows 16-byte aligned.

The CUDA kernel itself is held to the plain version, and to the combine's
log_norm mode bit for bit, on the card by tests/test_torch_cuda_combine_comp.py.
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

SMEM_LIMIT = 232448  # shared memory a block may opt in to on the H100


def kernel_order_log_rho(pot_h: torch.Tensor, pot_p: torch.Tensor, w: torch.Tensor
                         ) -> torch.Tensor:
    """log ρ (N, K) in recompute<D, true, true>'s order, vectorised over (n, k)."""
    d = pot_h.shape[1]
    row = lambda c: w[:, c][None, :]  # noqa: E731 — entry c of every component's row
    ht = [row(3 + i) + pot_h[:, i:i + 1] for i in range(d)]
    L = {(i, j): row(3 + d + i * d + j) + (pot_p[:, i:i + 1] if i == j else 0.0)
         for i in range(d) for j in range(i + 1)}
    for i in range(d):
        acc = L[i, i]
        for m in range(i):
            acc = acc - L[i, m] * L[i, m]
        L[i, i] = torch.sqrt(acc)
        inv = 1.0 / L[i, i]
        for r in range(i + 1, d):
            a = L[r, i]
            for m in range(i):
                a = a - L[r, m] * L[i, m]
            L[r, i] = a * inv
    y = []
    for i in range(d):
        acc = ht[i]
        for j in range(i):
            acc = acc - L[i, j] * y[j]
        y.append(acc / L[i, i])
    mu = [None] * d
    for i in reversed(range(d)):
        acc = y[i]
        for j in range(i + 1, d):
            acc = acc - L[j, i] * mu[j]
        mu[i] = acc / L[i, i]
    logdet = sum(2.0 * torch.log(L[i, i]) for i in range(d))
    dot = sum(mu[i] * ht[i] for i in range(d))
    return row(0) + 0.5 * row(1) - 0.5 * row(2) + 0.5 * dot - 0.5 * logdet


CASES = [(7, 3, 2), (37, 5, 2), (13, 4, 10), (41, 7, 10)]


@pytest.mark.parametrize("n,k,d", CASES)
def test_kernel_order_matches_autograds_function_in_f64(n, k, d):
    rng = np.random.default_rng(n + d)
    f64 = torch.float64
    pot_h = torch.tensor(rng.standard_normal((n, d)), dtype=f64)
    pot_p = torch.tensor(0.3 + rng.random((n, d)), dtype=f64)
    nat = gmm.init_variational(torch.Generator().manual_seed(n), gmm.make_prior(k, d, dtype=f64))
    exp = gmm.expected_params(nat)
    got = kernel_order_log_rho(pot_h, pot_p, combine.pack_expected(exp))
    want = combine.log_rho_plain(pot_h, pot_p, exp)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-10 * float(want.abs().max()))


@pytest.mark.parametrize("n,k,d", CASES)
def test_kernel_order_matches_the_interpreted_kernel(n, k, d):
    rng = np.random.default_rng(n * k + d)
    pot_h = rng.standard_normal((n, d)).astype(np.float32)
    pot_p = (0.3 + rng.random((n, d))).astype(np.float32)
    nat = jax.tree.map(lambda a: a.astype(jnp.float32),
                       jgmm.init_variational(jax.random.PRNGKey(n), jgmm.make_prior(k, d)))
    jexp = jgmm.expected_params(nat)
    exp = gmm.GmmExpected(**{f: torch.tensor(np.asarray(getattr(jexp, f)))
                             for f in gmm.GmmExpected._fields})
    got = kernel_order_log_rho(torch.tensor(pot_h), torch.tensor(pot_p),
                               combine.pack_expected(exp))
    want = cp.log_rho_fused(pot_h, pot_p, jexp, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("k", [1, 10, 64, 128])
@pytest.mark.parametrize("n", [1, 31, 400, 16384])
def test_plan_at_the_shape_class_edges(n, k):
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
    assert combine.rho_fwd_smem_bytes(k, d, rows) <= SMEM_LIMIT


@pytest.mark.parametrize("d", combine.LATENT_DIMS)
@pytest.mark.parametrize("k", [1, 10, 64, 128])
def test_copy_covers_w_once(k, d):
    count = k * combine.slot_width(d)
    body, tail = combine.rho_fwd_copies(k, d)
    # The bulk copy: from w's start (16-byte aligned), whole 16-byte pieces,
    # nothing past w's end; the threads copy the rest, once.
    assert body.start == 0 and len(body) % 4 == 0 and len(body) > 0 and body.stop <= count
    seen = np.zeros(count, dtype=int)
    seen[body.start:body.stop] += 1
    seen[tail.start:tail.stop] += 1
    assert (seen == 1).all() and len(tail) <= 3
    # w's rows, the mbarrier 16-byte aligned after them, the potentials.
    rows = combine.rows_per_block(16384, k, combine.BLOCK_THREADS, 132)
    barrier = 4 * (-(-count // 4) * 4)
    assert barrier % 16 == 0 and barrier >= 4 * count
    assert combine.rho_fwd_smem_bytes(k, d, rows) == barrier + 16 + 16 * d * rows <= SMEM_LIMIT
