"""The port's fused combine (its plain version, on the CPU) against the JAX
reference, and its hand-written backward against autograd.

* ``combine_fused`` on CPU tensors against ``combine_pallas.combine_fused``
  run by the Pallas interpreter and against the reference's oracle, at
  tests/test_combine_kernel.py's cases plus d = 8 and d = 10, at its bars:
  2e-5 for z, log r̃ and μ̃, 2e-4 for the local row and the statistics;
* gradients w.r.t. the potentials and the expected parameters through
  that test's ``_scalar_through`` functional, at its 5e-4;
* ``combine_grads_manual`` (the formulas the CUDA backward transcribes)
  against autograd in float64 at d = 2, 3, 4, 8, 10, at 1e-10;
* the mirrors of the redesigned kernels' formulas in float64:
  ``combine_grads_lean`` (the train step's backward, h̃̄ and diag G only)
  against autograd at d = 2, 8, 10, and ``combine_grads_split`` (the two
  halves of the backward with dw) adding up to ``combine_grads_manual``;
* the Python mirror of the kernels' block plan: every row owned once, the
  partial counts the wrapper allocates, and the forward's statistics summed
  in the plan's order from the kernel's per-pair terms (the lower triangle,
  mirrored) equal to the plain version's;
* ``svae.forward``'s fused branch against the JAX forward with the kernel
  bodies interpreted: values, NN gradients and the descriptive error;
* ``eps=None`` without a seed raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.models import svae as jsvae
from svax.models.svae import SvaeConfig as JConfig
from svax.ops import batched_linalg as jbl
from svax.ops import combine_pallas as cp
from svax.pgm import gmm as jgmm
from svax_torch import convert
from svax_torch.models import svae
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import combine
from svax_torch.pgm import gmm

torch.set_num_threads(1)

VALUE_TOL = (2e-5, 2e-4)  # (z, log r̃, μ̃), (local, statistics)
GRAD_TOL = 5e-4
CASES = [(40, 5, 2, 2), (130, 10, 3, 1), (64, 7, 4, 3), (48, 5, 11, 2), (32, 4, 12, 1),
         (40, 6, 8, 2), (32, 5, 10, 1)]


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


def _joracle(pot_h, pot_p, exp, eps, scale=1.0):
    """tests/test_combine_kernel.py:_oracle."""
    post = jsvae.sin_combine(pot_h, pot_p, exp)
    resp = jnp.exp(post.log_resp)
    s = eps.shape[0]
    z = post.mean[None] + jbl.solve_triu_vec(
        jnp.broadcast_to(post.prec_chol, (s,) + post.prec_chol.shape), eps)
    local = jsvae.local_kl_term(post, exp)
    ezz = post.cov + post.mean[..., :, None] * post.mean[..., None, :]
    stats = jgmm.suff_stats_from_moments(resp, post.mean, ezz, scale=scale)
    return z, post.log_resp, post.mean, local, stats


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("n,k,d,s", CASES)
def test_plain_matches_the_interpreted_kernel_and_the_oracle(n, k, d, s):
    pot_h, pot_p, jexp, exp, eps = _inputs(n, k, d, s)
    z, lr, mean, local, st = combine.combine_fused(
        torch.tensor(pot_h), torch.tensor(pot_p), exp, torch.tensor(eps), s, scale=2.5)
    assert combine.launches == 0  # CPU tensors: the plain version
    refs = {"interpreted kernel": cp.combine_fused(pot_h, pot_p, jexp, eps, s, scale=2.5,
                                                   tile=128, interpret=True),
            "oracle": _joracle(pot_h, pot_p, jexp, eps, scale=2.5)}
    for who, (jz, jlr, jmean, jlocal, jst) in refs.items():
        _close(z, jz, VALUE_TOL[0], f"z vs {who}")
        _close(lr, jlr, VALUE_TOL[0], f"log_resp vs {who}")
        _close(mean, jmean, VALUE_TOL[0], f"mean vs {who}")
        _close(local, jlocal, VALUE_TOL[1], f"local vs {who}")
        for f in ("counts", "mean_stat", "scatter_stat"):
            _close(getattr(st, f), getattr(jst, f), VALUE_TOL[1], f"{f} vs {who}")


def _scalar(out):
    """tests/test_combine_kernel.py:_scalar_through's functional, on
    (z, log_resp, ·, local, stats) of either package."""
    z, lr, _, local, st = out
    if isinstance(z, torch.Tensor):
        resp = torch.exp(lr)
        return ((resp * torch.tanh(z).sum(dim=(0, -1))).sum() - local.sum()
                + 0.01 * st.scatter_stat.sum())
    resp = jnp.exp(lr)
    return (jnp.sum(resp * jnp.sum(jnp.tanh(z), axis=(0, -1))) - jnp.sum(local)
            + 0.01 * jnp.sum(st.scatter_stat))


@pytest.mark.parametrize("d,interpreted", [(3, True), (3, False), (8, False), (11, False)])
def test_gradients_match_jax(d, interpreted):
    """Gradients w.r.t. the potentials and every expected-parameter field,
    against the reference's gradients (through its interpreted kernel at
    d = 3, through its oracle elsewhere; the interpreter's gradient costs
    10–20 s at d ≥ 8)."""
    n, k, s = 48, 5, 2
    pot_h, pot_p, jexp, exp, eps = _inputs(n, k, d, s, seed=3)
    if interpreted:
        jfun = lambda a, b, e: _scalar(cp.combine_fused(a, b, e, eps, s, tile=128,  # noqa: E731
                                                        interpret=True))
    else:
        jfun = lambda a, b, e: _scalar(_joracle(a, b, e, eps))  # noqa: E731
    jg_h, jg_p, jg_e = jax.grad(jfun, argnums=(0, 1, 2))(pot_h, pot_p, jexp)
    leaves = [torch.tensor(pot_h, requires_grad=True), torch.tensor(pot_p, requires_grad=True),
              *(t.clone().requires_grad_(True) for t in exp)]
    loss = _scalar(combine.combine_fused(leaves[0], leaves[1],
                                         gmm.GmmExpected(*leaves[2:]), torch.tensor(eps), s))
    grads = torch.autograd.grad(loss, leaves)
    _close(grads[0], jg_h, GRAD_TOL, "pot_h")
    _close(grads[1], jg_p, GRAD_TOL, "pot_p")
    for f, g in zip(gmm.GmmExpected._fields, grads[2:]):
        _close(g, getattr(jg_e, f), GRAD_TOL, f)


@pytest.mark.parametrize("n,k,d,s", [(7, 3, 2, 2), (5, 4, 3, 1), (6, 5, 4, 3),
                                     (4, 3, 8, 1), (3, 4, 10, 2)])
def test_manual_backward_matches_autograd(n, k, d, s):
    """combine_grads_manual against autograd of combine_raw_plain in float64,
    for the five cotangent paths alone and together."""
    rng = np.random.default_rng(d)
    f64 = torch.float64
    pot_h = torch.tensor(rng.standard_normal((n, d)), dtype=f64)
    pot_p = torch.tensor(0.3 + rng.random((n, d)), dtype=f64)
    prior = gmm.make_prior(k, d, dtype=f64)
    nat = gmm.init_variational(torch.Generator().manual_seed(d), prior)
    w = combine.pack_expected(gmm.expected_params(nat))
    eps = torch.tensor(rng.standard_normal((s, n, k, d)), dtype=f64)
    shapes = [(s, n, k, d), (n, k), (n, k, d), (n,), (k, combine.stats_width(d))]
    cts = [torch.tensor(rng.standard_normal(sh), dtype=f64) for sh in shapes]
    for paths in [range(5)] + [[j] for j in range(5)]:
        c = [cts[j] if j in paths else None for j in range(5)]
        leaves = [t.clone().requires_grad_(True) for t in (pot_h, pot_p, w)]
        outs = combine.combine_raw_plain(*leaves, eps)
        loss = sum((o * ct).sum() for o, ct in zip(outs, c) if ct is not None)
        want = torch.autograd.grad(loss, leaves)
        got = combine.combine_grads_manual(pot_h, pot_p, w, eps, *c)
        for g, ref, what in zip(got, want, ("pot_h", "pot_p", "w")):
            np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-10,
                                       atol=1e-10 * float(ref.abs().max()),
                                       err_msg=f"{what} through paths {list(paths)}")


def _f64_case(n, k, d, s, seed):
    rng = np.random.default_rng(seed)
    f64 = torch.float64
    pot_h = torch.tensor(rng.standard_normal((n, d)), dtype=f64)
    pot_p = torch.tensor(0.3 + rng.random((n, d)), dtype=f64)
    prior = gmm.make_prior(k, d, dtype=f64)
    nat = gmm.init_variational(torch.Generator().manual_seed(seed), prior)
    w = combine.pack_expected(gmm.expected_params(nat))
    eps = torch.tensor(rng.standard_normal((s, n, k, d)), dtype=f64)
    shapes = [(s, n, k, d), (n, k), (n, k, d), (n,), (k, combine.stats_width(d))]
    cts = [torch.tensor(rng.standard_normal(sh), dtype=f64) for sh in shapes]
    return pot_h, pot_p, w, eps, cts


@pytest.mark.parametrize("n,k,d,s", [(7, 3, 2, 2), (4, 3, 8, 1), (3, 4, 10, 2)])
def test_lean_backward_mirror_matches_autograd(n, k, d, s):
    """combine_grads_lean (combine_bwd_lean's formulas: h̃̄ and diag G, the
    Cholesky term from ε and L̃⁻¹z̄ alone) against autograd of
    combine_fused_plain in float64, with the train step's cotangents (z,
    log r̃, the local row), with μ̃'s added, and each alone."""
    pot_h, pot_p, w, eps, cts = _f64_case(n, k, d, s, d + 10)
    exp = combine.unpack_expected(w, d)
    for paths in ([0, 1, 3], [0, 1, 2, 3], [0], [1], [2], [3]):
        c = [cts[j] if j in paths else None for j in range(4)]
        leaves = [t.clone().requires_grad_(True) for t in (pot_h, pot_p)]
        z, lr, mean, local, _ = combine.combine_fused_plain(leaves[0], leaves[1], exp, eps, s)
        loss = sum((o * ct).sum() for o, ct in zip((z, lr, mean, local), c) if ct is not None)
        want = torch.autograd.grad(loss, leaves)
        got = combine.combine_grads_lean(pot_h, pot_p, w, eps, *c)
        for g, ref, what in zip(got, want, ("pot_h", "pot_p")):
            np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-10,
                                       atol=1e-10 * float(ref.abs().max()),
                                       err_msg=f"{what} through paths {paths}")


@pytest.mark.parametrize("n,k,d,s", [(7, 3, 2, 2), (4, 3, 8, 1), (3, 4, 10, 2)])
def test_split_backward_halves_add_up_to_the_manual_backward(n, k, d, s):
    """combine_grads_split's sampling half (z̄, lr̄, μ̄; its Cholesky term as
    −AᵀP) and local/statistics half (local̄, s̄; Σ̃Σ̄Σ̃ with Σ̄ = ½ω sym(E[Λ])
    + r̃ sym(s̄₂)) add up to combine_grads_manual, every path and all
    together, in float64."""
    pot_h, pot_p, w, eps, cts = _f64_case(n, k, d, s, d + 20)
    for paths in [range(5)] + [[j] for j in range(5)]:
        c = [cts[j] if j in paths else None for j in range(5)]
        sample, local = combine.combine_grads_split(pot_h, pot_p, w, eps, *c)
        want = combine.combine_grads_manual(pot_h, pot_p, w, eps, *c)
        for a, b, ref, what in zip(sample, local, want, ("pot_h", "pot_p", "w")):
            np.testing.assert_allclose((a + b).numpy(), ref.numpy(), rtol=1e-10,
                                       atol=1e-10 * float(ref.abs().max()),
                                       err_msg=f"{what} through paths {list(paths)}")


@pytest.mark.parametrize("threads", [combine.BLOCK_THREADS, combine.FULL_THREADS])
def test_block_plan_owns_every_row_once(threads):
    """Every row is walked by exactly one thread row of one block, each
    block's rows are one contiguous run of row groups in order, R·K fits
    the block and fills four warps where K allows, the grid is the row
    groups capped by the card's capacity, and the last group's padding
    (rows past N) is left out."""
    for n, k, sms, cap in [(1024, 100, 132, 132), (1024, 100, 132, 2000), (256, 10, 132, 264),
                           (512, 100, 132, 132), (1024, 50, 132, 264), (77, 13, 3, 6),
                           (5, 128, 2, 3), (400, 5, 132, 1), (1, 1, 1, 10), (5000, 3, 8, 16)]:
        blocks = combine.grid_blocks(n, k, threads, sms, cap)
        r_count = combine.rows_per_block(n, k, threads, sms)
        assert r_count * k <= max(threads, k) and (r_count * k >= 128 or k * (r_count + 1) > 128)
        assert blocks == min(-(-n // r_count), cap)
        owned = []
        for b in range(blocks):
            rows = combine.block_rows(b, n, k, threads, sms, blocks)
            assert len(rows) == r_count
            groups = sorted({row // r_count for rr in rows for row in rr})
            assert groups == list(range(groups[0], groups[-1] + 1))
            for rr in rows:
                assert rr == sorted(rr)
                owned += rr
        assert sorted(owned) == list(range(n))


@pytest.mark.parametrize("d", [2, 8, 10])
def test_forward_statistics_in_the_plans_order(d):
    """The forward's partial holds [count, μ̃, the lower triangle of Σ̃ +
    μ̃μ̃ᵀ] per component (partial_planes rows; the wrapper allocates grid ×
    partial_planes(d) × K floats); those per-pair terms, summed in the plan's
    order and the triangle mirrored, give the plain version's raw
    statistics (float64), and the order's sum is deterministic in float32."""
    n, k, s = 45, 7, 1
    pot_h, pot_p, w, eps, _ = _f64_case(n, k, d, s, d)
    raw = combine.combine_raw_plain(pot_h, pot_p, w, eps)[4]
    post = svae.sin_combine(pot_h, pot_p, combine.unpack_expected(w, d))
    resp = torch.exp(post.log_resp)
    ezz = post.cov + post.mean[..., :, None] * post.mean[..., None, :]
    rows, cols = torch.tril_indices(d, d)
    terms = torch.cat([resp[..., None], resp[..., None] * post.mean,
                       resp[..., None] * ezz[..., rows, cols]], dim=-1)  # (N, K, planes)
    assert terms.shape[-1] == combine.partial_planes(d) == 1 + d + d * (d + 1) // 2
    for sms, cap in ((1, 1), (2, 3), (132, 264)):
        blocks = combine.grid_blocks(n, k, combine.BLOCK_THREADS, sms, cap)
        summed = combine.plan_sum(terms, k, combine.BLOCK_THREADS, sms, blocks)  # (K, planes)
        scatter = torch.zeros((k, d, d), dtype=torch.float64)
        scatter[:, rows, cols] = summed[:, 1 + d:]
        scatter[:, cols, rows] = summed[:, 1 + d:]
        got = torch.cat([summed[:, :1 + d], scatter.flatten(1)], dim=1)
        np.testing.assert_allclose(got.numpy(), raw.numpy(), rtol=1e-12, atol=1e-12)
        t32 = terms.float()
        assert torch.equal(combine.plan_sum(t32, k, combine.BLOCK_THREADS, sms, blocks),
                           combine.plan_sum(t32, k, combine.BLOCK_THREADS, sms, blocks))


def test_kernel_resources_reads_each_instantiation():
    """measure_mnist.kernel_resources (what chip_smoke.py's ptxas checks
    read) names each instantiation with its integer and boolean template
    arguments and pairs it with its own spill and register lines."""
    from svax_torch.measure_mnist import kernel_resources

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__1_10_combine_cu_2"
        "16combine_bwd_leanILi10ELb1EEEvN4svax4comb7BwdArgsE' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 221 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111combine_fwdILi8ELb0EEEvN4s"
        "vax4comb7FwdArgsE' for 'sm_90a'",
        "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110rowsum_fwdIN9lastlayer4CfgFI"
        "Li32ELi16EEELi3EEEvPKf' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 52 registers, used 1 barriers"])
    assert kernel_resources(log, "combine_bwd") == [
        "combine_bwd_lean<10, 1>: 221 registers, 32 bytes stack frame, 0 bytes spill stores, "
        "0 bytes spill loads"]
    assert kernel_resources(log, "combine_fwd") == [
        "combine_fwd<8, 0>: 128 registers, 0 bytes stack frame, 4 bytes spill stores, "
        "8 bytes spill loads"]
    assert kernel_resources(log, "rowsum_fwd") == [
        "rowsum_fwd<32, 16, 3>: 52 registers, 0 bytes stack frame, 0 bytes spill stores, "
        "0 bytes spill loads"]


def test_raw_statistics_and_packing():
    """The kernel's packed block and raw (K, F) statistics map back to the
    GmmExpected fields and the scaled, symmetrised GmmSuffStats."""
    pot_h, pot_p, _, exp, eps = _inputs(20, 4, 3, 1, seed=5)
    w = combine.pack_expected(exp)
    assert w.shape == (4, combine.slot_width(3))
    for f in gmm.GmmExpected._fields:
        assert torch.equal(getattr(combine.unpack_expected(w, 3), f), getattr(exp, f))
    raw = combine.combine_raw_plain(torch.tensor(pot_h), torch.tensor(pot_p), w,
                                    torch.tensor(eps))[4]
    st = combine.stats_from_raw(raw, 3, scale=2.0)
    want = combine.combine_fused_plain(torch.tensor(pot_h), torch.tensor(pot_p), exp,
                                       torch.tensor(eps), 1, scale=2.0)[4]
    for f in ("counts", "mean_stat", "scatter_stat"):
        _close(getattr(st, f), getattr(want, f).numpy(), 1e-6, f)


def test_seed_mode_needs_a_seed_and_draws_from_it():
    pot_h, pot_p, _, exp, _ = _inputs(16, 3, 2, 1, seed=3)
    ph, pp = torch.tensor(pot_h), torch.tensor(pot_p)
    with pytest.raises(ValueError, match="requires a seed"):
        combine.combine_fused(ph, pp, exp, None, 1)
    a = combine.combine_fused(ph, pp, exp, None, 2, seed=4, step=1)[0]
    b = combine.combine_fused(ph, pp, exp, None, 2, seed=4, step=1)[0]
    c = combine.combine_fused(ph, pp, exp, None, 2, seed=4, step=2)[0]
    assert a.shape == (2, 16, 3, 2) and torch.equal(a, b) and not torch.equal(a, c)


def test_forward_fused_branch_matches_jax(monkeypatch):
    """svae.forward(fused_combine=True) against the JAX forward with the
    kernel bodies interpreted (tests/test_combine_kernel.py:132-184)."""
    monkeypatch.setattr(jsvae, "_COMBINE_INTERPRET", True)
    n, k, d, s, d_in = 40, 5, 2, 2, 2
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    jconfig = JConfig(latent_dim=d, num_components=k, num_samples=s, num_total=n,
                      nn_precision=jax.lax.Precision.HIGHEST)
    key = jax.random.PRNGKey(0)
    f32 = lambda t: jax.tree.map(lambda p: p.astype(jnp.float32), t)  # noqa: E731
    prior = f32(jgmm.make_prior(k, d))
    nn = f32(jsvae.init_params(key, d_in, jconfig, (16,), (16,)))
    nat = f32(jgmm.init_variational(key, prior))
    eps = rng.standard_normal((s, n, k, d)).astype(np.float32)

    jcfg = jconfig._replace(fused_combine=True)
    jout = jsvae.forward(nn, nat, prior, x, key, jcfg, eps=eps)
    jgrad = jax.grad(lambda p: -jsvae.forward(p, nat, prior, x, key, jcfg, eps=eps).elbo)(nn)

    tree = jax.tree.map(np.asarray, {"nn": nn, "nat": nat, "prior": prior})
    params = {side: [{name: torch.tensor(ly[name], requires_grad=True) for name in ("w", "b")}
                     for ly in tree["nn"][side]] for side in ("encoder", "decoder")}
    tnat = convert.gmm_nat_from_numpy(tree["nat"])
    tprior = convert.gmm_nat_from_numpy(tree["prior"])
    config = SvaeConfig(latent_dim=d, num_components=k, num_samples=s, num_total=n,
                        fused_combine=True)
    out = svae.forward(params, tnat, tprior, torch.tensor(x), config, eps=torch.tensor(eps))
    np.testing.assert_allclose(float(out.elbo.detach()), float(jout.elbo), rtol=1e-5)
    _close(out.suff_stats.scatter_stat, jout.suff_stats.scatter_stat, 1e-4, "scatter")
    _close(out.posterior.mean, jout.posterior.mean, 1e-5, "posterior mean")
    leaves = [t for side in params.values() for ly in side for t in ly.values()]
    grads = torch.autograd.grad(-out.elbo, leaves)
    want = [jgrad[side][i][name] for side in ("encoder", "decoder")
            for i in range(len(jgrad[side])) for name in ("w", "b")]
    for g, w in zip(grads, want):
        _close(g, w, 2e-4, "NN gradient")

    # The fused posterior omits chol/cov/logdet; consumers that need them
    # fail with the descriptive message.
    assert out.posterior.prec_chol is None and out.posterior.cov is None
    with pytest.raises(ValueError, match="fused combine kernel"):
        svae.sample_posterior(out.posterior, 2)
    with pytest.raises(ValueError, match="fused combine kernel"):
        svae.local_kl_term(out.posterior, gmm.expected_params(tnat))
