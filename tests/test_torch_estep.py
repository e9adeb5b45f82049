"""The port's fused E-step against the JAX reference.

* the plain version (``e_step_stats_reference``, which
  ``e_step_stats_fused`` runs on CPU tensors) against the JAX twin
  ``estep_pallas.e_step_stats_reference`` in float64 at rtol 1e-9, d = 2
  and d = 3; its packing helpers to the last bits;
* against the TPU kernel's own body, ``e_step_stats_fused(interpret=True)``,
  in float32 at a non-aligned N, at benchmarks/bench_estep.py's bars
  (statistics: max error over max |reference| < 5e-5; evidence: max
  absolute error < 1e-3);
* the wrapper's routing, launch counter and rejections;
* the kernel's design, through Python mirrors, at N ∈ {1, 63, 65, 400,
  4097}, K ∈ {1, 10, 128}, d ∈ {1, 2, 3, 10} (and one shape of each
  kernel instantiation): the folded features (Φ′W′ = ΦW in float64, the
  mirrored triangle = unpack_stats'), an emulation of its f32 arithmetic
  (three-part bf16 products of six terms, 16-deep steps added in f32, the
  block plan's order of sums) at the kernel's bars against the JAX
  reference, its in-kernel packing order against the JAX pack_coeffs, and
  its block plan. The CUDA kernel itself is held to the plain version on
  the card by tests/test_torch_cuda_mixture.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.data import make_pinwheel_data
from svax.ops import estep_pallas
from svax.pgm import gmm as jgmm
from svax_torch import convert
from svax_torch.ops import estep
from svax_torch.pgm import gmm

torch.set_num_threads(1)


def _setup(n, k, d, seed=0, dtype=jnp.float64):
    if d == 2:
        x = make_pinwheel_data(num_classes=5, num_per_class=-(-n // 5), seed=seed)[:n]
    else:
        x = np.random.default_rng(seed).standard_normal((n, d))
    x = np.asarray(x, np.float64 if dtype == jnp.float64 else np.float32)
    jprior = jgmm.make_prior(k, d, dtype=dtype)
    jnat = jgmm.init_variational(jax.random.PRNGKey(seed), jprior, jnp.asarray(x))
    nat = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jnat))
    return x, jgmm.expected_params(jnat), gmm.expected_params(nat)


# (N, K, d): every N, K and d of the kernel's shape list at least once, and
# one shape of each instantiation (component pairs 1, 2, 4, 8; feature tiles
# 1-5). tests/test_torch_cuda_mixture.py runs the kernel at the same shapes.
SHAPES = [(1, 1, 1), (63, 10, 2), (65, 128, 3), (400, 10, 2), (4097, 128, 10),
          (400, 1, 10), (63, 128, 10), (4097, 10, 1), (130, 20, 5), (300, 40, 7),
          (200, 70, 9)]


@functools.lru_cache(maxsize=None)
def _case(n, k, d, dtype=jnp.float64):
    """x (N, d) and q's expected parameters (JAX and port) from max(N, K)
    seeded points, the first N of them the data."""
    x, jexp, exp = _setup(max(n, k), k, d, seed=n + k + d, dtype=dtype)
    return x[:n], jexp, exp


@pytest.mark.parametrize("n,k,d", SHAPES)
def test_folded_layout_matches_unfolded_float64(n, k, d):
    """Φ′W′ = ΦW, and the lower-triangle statistics Φ′ᵀR, mirrored, equal
    unpack_stats(ΦᵀR) (whose ½(S + Sᵀ) only averages equal entries)."""
    x, jexp, exp = _case(n, k, d)
    xt = torch.tensor(x)
    phi, phi_f = estep._features(xt), estep.folded_features(xt)
    assert phi_f.shape == (n, 1 + d + d * (d + 1) // 2)
    logits = phi @ estep.pack_coeffs(exp)
    folded = phi_f @ estep.fold_coeffs(exp)
    np.testing.assert_allclose(folded.numpy(), logits.numpy(), rtol=1e-12,
                               atol=1e-12 * float(logits.abs().max()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(
        estep_pallas._features(jnp.asarray(x)) @ estep_pallas.pack_coeffs(jexp, jnp.float64)),
        rtol=1e-9, atol=1e-9 * float(logits.abs().max()))
    resp = torch.softmax(logits, dim=-1)
    for got, want in zip(estep.unfold_stats(phi_f.T @ resp, d),
                         estep.unpack_stats(phi.T @ resp, d)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))


def _parts(v: torch.Tensor) -> list:
    """The exact three-part bf16 split (lastlayer.cuh: split<3>)."""
    out = []
    for _ in range(3):
        out.append(v.to(torch.bfloat16).float())
        v = v - out[-1]
    return out


def _tc_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(S, M, 16) × (S, 16, N) → (S, M, N): each 16-deep step's product as
    warp_mma forms it, the six terms of order < 3 of the parts, smallest
    first, into a zeroed f32 tile (each term's 16 products of bf16 values
    summed exactly and rounded to f32, as the tensor cores' sum is)."""
    pa, pb = _parts(a), _parts(b)
    t = torch.zeros(a.shape[0], a.shape[1], b.shape[2])
    for order in (2, 1, 0):
        for i in range(order, -1, -1):
            t = (t.double() + (pa[i].double() @ pb[order - i].double())).float()
    return t


def _steps(m: torch.Tensor, axis_len: int) -> torch.Tensor:
    """Zero-pad the last axis of m to a multiple of 16 and cut it in steps."""
    pad = -axis_len % 16
    return torch.nn.functional.pad(m, (0, pad)).unflatten(-1, (-1, 16))


def _kernel_mirror(x: torch.Tensor, exp, scale: float, capacity: int):
    """The kernel's f32 arithmetic in torch: W′ packed in f32, Φ′ in f32,
    logits Φ′W′ over 16-feature steps added in f32, the softmax (max, e =
    exp(l − max) — the kernel's special-function exp is within a few 1e-7 of
    it —, Σe, R = e · (1 / Σe), evidence max + log Σe), then per block of
    the plan its 16-point steps of Φ′ᵀR added in order, the partials in the
    kernel's order, times scale."""
    n, d = x.shape
    w, phi = estep.fold_coeffs(exp, torch.float32), estep.folded_features(x)
    f = phi.shape[1]
    ps = _steps(phi, f).permute(1, 0, 2)                      # (S, N, 16)
    ws = _steps(w.T, f).permute(1, 2, 0)                      # (S, 16, K)
    logits = torch.zeros(n, w.shape[1])
    for t in _tc_steps(ps, ws):
        logits = logits + t
    m = logits.max(dim=-1, keepdim=True).values
    e = torch.exp(logits - m)
    tot = e.sum(dim=-1, keepdim=True)
    evidence = (m + torch.log(tot))[:, 0]
    resp = e * (1.0 / tot)
    tiles, blocks = estep.plan(n, capacity)
    pad = tiles * estep.TILE_POINTS - n
    phi_t = torch.nn.functional.pad(phi.T, (0, pad)).unflatten(1, (-1, 16)).permute(1, 0, 2)
    r_t = torch.nn.functional.pad(resp.T, (0, pad)).unflatten(1, (-1, 16)).permute(1, 2, 0)
    terms = _tc_steps(phi_t, r_t)                             # (steps, F′, K)
    steps = estep.TILE_POINTS // 16
    partials = []
    for b in range(blocks):
        acc = torch.zeros(f, w.shape[1])
        for s in range(estep.run_begin(b, tiles, blocks) * steps,
                       estep.run_begin(b + 1, tiles, blocks) * steps):
            acc = acc + terms[s]
        partials.append(acc)
    # the ticket's last block adds them in block order; the reduce launch in
    # REDUCE_RUNS contiguous runs of blocks, each in order, then the runs
    runs = estep.REDUCE_RUNS if estep.launches_per_call(n, d, w.shape[1], capacity) == 2 else 1
    per = -(-blocks // runs)
    total = torch.zeros(f, w.shape[1])
    for r in range(runs):
        run = torch.zeros_like(total)
        for acc in partials[r * per:(r + 1) * per]:
            run = run + acc
        total = total + run
    return estep.unfold_stats(torch.tensor(scale, dtype=torch.float32) * total, d), evidence


@pytest.mark.parametrize("n,k,d", SHAPES)
def test_kernel_arithmetic_meets_the_bars_against_jax(n, k, d):
    """The emulated kernel against the JAX reference in float32, at the
    kernel's bars (statistics 5e-5 of max |value|, evidence 1e-3)."""
    x, jexp, exp = _case(n, k, d, jnp.float32)
    stats, ev = _kernel_mirror(torch.tensor(x), exp, 2.5, capacity=132)
    jstats, jev = estep_pallas.e_step_stats_reference(jnp.asarray(x), jexp, scale=2.5)
    for got, want, name in zip(stats, jstats, jstats._fields):
        want = np.asarray(want, np.float64)
        err = np.abs(got.double().numpy() - want).max() / (np.abs(want).max() + 1e-30)
        assert err < 5e-5, (name, err)
    assert np.abs(ev.double().numpy() - np.asarray(jev, np.float64)).max() < 1e-3
    assert torch.equal(stats.scatter_stat, stats.scatter_stat.mT)


@pytest.mark.parametrize("n,k,d", SHAPES)
def test_in_kernel_packing_matches_jax_pack_coeffs(n, k, d):
    """W′ in the kernel's f32 order of operations (fold_coeffs) against the
    JAX pack_coeffs, folded, at 1e-6."""
    _, jexp, exp = _case(n, k, d, jnp.float32)
    w = estep.fold_coeffs(exp, torch.float32).numpy()
    jw = np.asarray(estep_pallas.pack_coeffs(jexp, jnp.float32), np.float64)
    rows = [jw[:1 + d]] + [
        (jw[1 + d + i * d + j] + (jw[1 + d + j * d + i] if i != j else 0.0))[None]
        for i, j in estep.tri_pairs(d)]
    np.testing.assert_allclose(w, np.concatenate(rows), rtol=1e-6,
                               atol=1e-6 * float(np.abs(jw).max()))


@pytest.mark.parametrize("n", [1, 63, 64, 65, 400, 4097, 65536])
@pytest.mark.parametrize("sms,per_sm", [(1, 1), (3, 2), (132, 1), (132, 2)])
def test_block_plan_covers_each_tile_once_in_contiguous_runs(n, sms, per_sm):
    tiles, blocks = estep.plan(n, sms * per_sm)
    assert tiles == -(-n // estep.TILE_POINTS)
    assert blocks == min(tiles, sms * per_sm)
    runs = [range(estep.run_begin(b, tiles, blocks), estep.run_begin(b + 1, tiles, blocks))
            for b in range(blocks)]
    assert [t for run in runs for t in run] == list(range(tiles))
    lengths = {len(run) for run in runs}
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
    # one launch where the ticket's last block adds the partials
    fk = (1 + 10 + 55) * 128
    assert estep.launches_per_call(n, 10, 128, sms * per_sm) == (
        2 if blocks > 1 and blocks * fk > estep.TICKET_FLOATS else 1)
    assert estep.launches_per_call(n, 2, 10, sms * per_sm) == 1


@pytest.mark.parametrize("d", [2, 3])
def test_plain_matches_jax_twin_float64(d):
    x, jexp, exp = _setup(100, 7, d, seed=d)
    before = estep.launches
    stats, ev = estep.e_step_stats_fused(torch.tensor(x), exp, scale=3.0)
    assert estep.launches == before  # CPU tensors take the plain version
    jstats, jev = estep_pallas.e_step_stats_reference(jnp.asarray(x), jexp, scale=3.0)
    np.testing.assert_allclose(ev.numpy(), np.asarray(jev), rtol=1e-9)
    for got, want in zip(stats, jstats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)
    # ... and the einsum path of pgm.gmm, which the GMM step uses unfused
    resp, ev2 = gmm.e_step_obs(torch.tensor(x), exp)
    np.testing.assert_allclose(ev.numpy(), ev2.numpy(), rtol=1e-12)
    for got, want in zip(stats, gmm.suff_stats_obs(torch.tensor(x), resp, scale=3.0)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-12)


def test_packing_helpers_match_jax():
    x, jexp, exp = _setup(20, 4, 3, seed=1)
    # the expected params differ from the JAX ones in the last bits only
    np.testing.assert_allclose(estep.pack_coeffs(exp).numpy(),
                               np.asarray(estep_pallas.pack_coeffs(jexp, jnp.float64)),
                               rtol=1e-12)
    np.testing.assert_array_equal(estep._features(torch.tensor(x)).numpy(),
                                  np.asarray(estep_pallas._features(jnp.asarray(x))))
    raw = np.random.default_rng(0).standard_normal((13, 4))
    for got, want in zip(estep.unpack_stats(torch.tensor(raw), 3),
                         estep_pallas.unpack_stats(jnp.asarray(raw), 3)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)


@pytest.mark.parametrize("n,k,d", [(300, 10, 2), (700, 6, 3)])
def test_plain_matches_pallas_interpret_float32(n, k, d):
    """N = 300 and 700 are not multiples of the 128-point tile."""
    x, jexp, exp = _setup(n, k, d, seed=4, dtype=jnp.float32)
    stats, ev = estep.e_step_stats_fused(torch.tensor(x), exp, scale=2.0)
    jstats, jev = estep_pallas.e_step_stats_fused(jnp.asarray(x), jexp, scale=2.0,
                                                  tile_n=128, interpret=True)
    for got, want, name in zip(stats, jstats, jstats._fields):
        want = np.asarray(want, np.float64)
        err = np.abs(got.double().numpy() - want).max() / (np.abs(want).max() + 1e-30)
        assert err < 5e-5, (name, err)
    assert np.abs(ev.double().numpy() - np.asarray(jev, np.float64)).max() < 1e-3


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, _, exp = _setup(30, 4, 2)
    x32 = torch.zeros((30, 2))
    assert estep.unsupported_reason(x32, exp) is None
    assert "float32" in estep.unsupported_reason(x32.double(), exp)
    assert "contiguous" in estep.unsupported_reason(torch.zeros((2, 30)).T, exp)
    _, _, wide = _setup(30, 4, estep.MAX_DIM + 1)
    assert "d = 11" in estep.unsupported_reason(torch.zeros((30, 11)), wide)
    _, _, many = _setup(200, estep.MAX_COMPONENTS + 1, 2)
    assert "K = 129" in estep.unsupported_reason(x32, many)
    assert "expected params" in estep.unsupported_reason(torch.zeros((30, 3)), exp)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        estep.e_step_stats_fused(torch.zeros((30, 2), device="meta"), exp)
