"""Fused SIN combine: wrapper, plain version, hand-derived backward.

Port of ``svax/ops/combine_pallas.py: combine_fused``. Per (n, k), with no
N·K·d·d tensor in device memory: J̃ = diag(Pₙ) + E[Λ_k], its Cholesky L̃,
μ̃ = J̃⁻¹(hₙ + E[Λμ]_k), log|J̃|, log ρ and the softmax over K giving log r̃,
Σ̃ = J̃⁻¹, the closed-form local-KL row, S samples z = μ̃ + L̃⁻ᵀε and the
(K, 1 + d + d²) statistics Σ_n r̃·[1, μ̃, Σ̃ + μ̃μ̃ᵀ]. The forward and its
recompute backward are the CUDA kernels of ``csrc/combine.cu``.

* On CUDA tensors ``combine_fused`` launches the kernels, or raises; there
  is no fallback.
* On CPU tensors it runs ``combine_fused_plain``: the composition
  ``sin_combine`` → ``sample_posterior`` → ``local_kl_term`` →
  ``suff_stats_from_moments`` (the reference's oracle,
  tests/test_combine_kernel.py:38-48), differentiated by autograd.
* ``combine_grads_manual`` is the backward written out in plain PyTorch —
  the formulas the kernel transcribes, tested on the CPU against autograd.

Component parallelism (the K-shard of one rank; ``log_rho_fused``, the
reference's :722, and ``combine_fused(log_norm=)``): ``log_rho_fused``
gives the shard's pre-softmax log ρ (N, K) and its VJP (the ρ-kernels of
``csrc/combine.cu`` on CUDA tensors, ``log_rho_plain`` on CPU tensors); the
caller's logsumexp across the shards is ``log_norm`` (N,), and
``combine_fused(log_norm=)`` weights by log r̃ = log ρ − log_norm instead of
the softmax over its own K, returning the normaliser's cotangent through
autograd. ``log_rho_grads_manual`` and ``combine_grads_manual(log_norm=)``
are the backwards written out; ``log_rho_grads_lean`` is the ρ-kernel's
backward for the train step's call (no dw) as the kernel forms it, and
``log_rho_dw_planes`` with ``rho_dw_from_planes`` its dw as the kernel
sums and expands it.

Expected parameters reach the kernel packed one row per component as
``pack_expected`` lays them out: [log π, E[log|Λ|], E[μᵀΛμ], E[Λμ] (d),
E[Λ] (d×d row-major)] (combine_pallas.pack_expected, without padding).
Gradients flow to that block, and through it to the GmmExpected fields.

Noise: ``eps`` (S, N, K, d) injects it (the parity mode); with ``eps=None``
and a ``seed`` the kernel draws it from an in-kernel Philox4x32-10 +
Box–Muller keyed ``seed`` on stream ``step``, normal ((s·N + n)·K + k)·d + i,
and the backward regenerates the same numbers; ε is not returned (recover
it as L̃ᵀ(z − μ̃)). The kernels read (seed, step) from a device word, an
int64 (2,) tensor {seed, step} (``key_word``): a CUDA graph that replays the
train step advances its step on the device, where a launch argument would
be frozen at the capture. The plain version draws seed-mode noise from a
``torch.Generator`` seeded ``seed + step``: the same distribution, not the
same numbers.
"""

from __future__ import annotations

import ctypes
import math

import torch

from svax_torch.models import svae
from svax_torch.pgm import gmm
from svax_torch.pgm.gmm import GmmExpected, GmmSuffStats

_LOG_2PI = math.log(2.0 * math.pi)

# The kernel's shape class: latent d is a template parameter; one block
# holds whole rows of K (softmax over K in shared memory) in at most
# MAX_THREADS threads, so K ≤ MAX_COMPONENTS (bigk-dp needs K = 100).
LATENT_DIMS = (2, 3, 4, 6, 8, 10)
MAX_COMPONENTS = 128

# Kernel launches (plain ints), each counted where its kernel is launched.
launches = 0  # combine forward, softmax over K
backward_launches = 0  # combine backward, softmax over K (either variant)
lean_backward_launches = 0  # of those, combine_bwd_lean's (no dstats, no dw)
norm_launches = 0  # combine forward with log_norm
norm_backward_launches = 0  # combine backward with log_norm (either variant)
norm_lean_backward_launches = 0  # of those, combine_bwd_lean's
rho_launches = 0  # log_rho forward
rho_backward_launches = 0  # log_rho backward (either configuration)
# What each combine backward was asked for, counted by key: the cotangents
# it received (of "dz", "dlr", "dmu", "dlocal", "dstats") and the gradients
# it had to give beyond the potentials' ("dw", "dn"), joined by "+".
backward_paths: dict[str, int] = {}
# What each ρ-kernel backward had to give, counted by key: "dpot" (the
# potentials' cotangents only: configuration (a), the train step's call,
# one launch) and "dw" (the expected parameters' cotangent: configuration
# (b)), joined by "+".
rho_backward_paths: dict[str, int] = {}


def stats_width(d: int) -> int:
    """F = 1 + d + d²: [count, μ̃ (d), Σ̃ + μ̃μ̃ᵀ (d×d)] per component."""
    return 1 + d + d * d


# ------------------------------------------------ the kernels' block plan
#
# A mirror of csrc/combine_core.cuh's plan, which the CPU tests hold to its
# contract: a block holds R rows of K, one thread per (n, k); the row groups
# are dealt to the blocks in contiguous runs; each block adds its rows'
# terms in row order into one partial, and the partials are added in a
# fixed two-level order (reduce_planes: REDUCE_GROUPS contiguous runs of
# partials, each in order, then the runs in order).

BLOCK_THREADS = 256  # the forward, the train step's backward, the ρ-backward
FULL_THREADS = 128  # the backward with dw
REDUCE_GROUPS = 16


def rows_per_block(n: int, k: int, threads: int, sms: int) -> int:
    """R for N points and K components on a card of ``sms`` SMs: at least
    128 // K rows (four warps, one for each of an SM's schedulers), more
    where N would leave blocks queueing for SMs (ceil(N / SMs)), at most
    threads // K."""
    most = 1 if k >= threads else threads // k
    least = 1 if k >= 128 else 128 // k
    return min(most, max(least, -(-n // sms)))


def row_groups(n: int, k: int, threads: int, sms: int) -> int:
    return -(-n // rows_per_block(n, k, threads, sms))


def run_begin(b: int, groups: int, blocks: int) -> int:
    """Block b of ``blocks`` owns the row groups [run_begin(b), run_begin(b + 1))."""
    return (b * groups) // blocks


def grid_blocks(n: int, k: int, threads: int, sms: int, capacity: int) -> int:
    """The grid (and partial count): the row groups, at most the blocks that
    fit on the card at once (``capacity``: SMs × blocks an SM)."""
    return min(row_groups(n, k, threads, sms), capacity)


def block_rows(b: int, n: int, k: int, threads: int, sms: int, blocks: int) -> list[list[int]]:
    """The rows each thread row r of block b walks, in order: [[n, ...] for
    r in range(R)]; rows past N (the last group's padding) are left out."""
    r_count = rows_per_block(n, k, threads, sms)
    groups = row_groups(n, k, threads, sms)
    runs = range(run_begin(b, groups, blocks), run_begin(b + 1, groups, blocks))
    return [[g * r_count + r for g in runs if g * r_count + r < n] for r in range(r_count)]


def rho_fwd_smem_bytes(k: int, d: int, rows: int) -> int:
    """log_rho_fwd's shared memory (csrc/combine.cu: rho_fwd_bytes): w's K
    rows padded to 16 bytes, its mbarrier (16 bytes), then two row groups of
    ``rows`` rows' potentials (2d floats a row)."""
    return 4 * (-(-k * slot_width(d) // 4) * 4 + 4 + 4 * d * rows)


def rho_fwd_copies(k: int, d: int) -> tuple[range, range]:
    """w's copy into log_rho_fwd's shared memory (combine_core.cuh:
    bulk_body): the floats of its one TMA bulk copy (whole 16-byte pieces
    from w's start) and those of the tail that the threads copy."""
    count = k * slot_width(d)
    return range(0, count & ~3), range(count & ~3, count)


def plan_sum(terms: torch.Tensor, k: int, threads: int, sms: int, blocks: int) -> torch.Tensor:
    """Σ_n terms[n] in the kernels' order: per block, each thread row adds
    its rows in order, the block adds its R thread rows in order; then
    REDUCE_GROUPS contiguous runs of blocks, each in order, and the runs in
    order. ``terms`` (N, ...)."""
    n = terms.shape[0]
    partials = []
    for b in range(blocks):
        acc = torch.zeros_like(terms[0])
        for rows in block_rows(b, n, k, threads, sms, blocks):
            own = torch.zeros_like(terms[0])
            for row in rows:
                own = own + terms[row]
            acc = acc + own
        partials.append(acc)
    total = torch.zeros_like(terms[0])
    for grp in range(REDUCE_GROUPS):
        part = torch.zeros_like(terms[0])
        for b in range(run_begin(grp, blocks, REDUCE_GROUPS),
                       run_begin(grp + 1, blocks, REDUCE_GROUPS)):
            part = part + partials[b]
        total = total + part
    return total


def partial_planes(d: int) -> int:
    """The forward's partial rows per component: [count, μ̃ (d), the lower
    triangle of Σ̃ + μ̃μ̃ᵀ (d(d+1)/2)]."""
    return 1 + d + d * (d + 1) // 2


def backward_variant(has_dstats: bool, need_w: bool) -> str:
    """The backward kernel a call runs: "lean" (combine_bwd_lean: h̃̄ and
    diag G only) for the train step's call, which passes no statistics'
    cotangent and needs no dw; "full" (combine_bwd_full.cu's two halves)
    for any other."""
    return "full" if has_dstats or need_w else "lean"


def slot_width(d: int) -> int:
    """3 + d + d²: one component's packed expected parameters."""
    return 3 + d + d * d


def pack_expected(exp: GmmExpected) -> torch.Tensor:
    """(K, 3 + d + d²): [log π | E[log|Λ|] | E[μᵀΛμ] | E[Λμ] | E[Λ]]."""
    k, d = exp.prec_mean.shape
    return torch.cat([exp.log_pi[:, None], exp.logdet[:, None], exp.quad[:, None],
                      exp.prec_mean, exp.prec.reshape(k, d * d)], dim=1).contiguous()


def unpack_expected(w: torch.Tensor, d: int) -> GmmExpected:
    k = w.shape[0]
    return GmmExpected(log_pi=w[:, 0], logdet=w[:, 1], quad=w[:, 2],
                       prec_mean=w[:, 3:3 + d], prec=w[:, 3 + d:].reshape(k, d, d))


def stats_from_raw(raw: torch.Tensor, d: int, scale: float = 1.0) -> GmmSuffStats:
    """(K, F) raw sums → GmmSuffStats × scale, the scatter symmetrised
    (combine_pallas.py:844-852)."""
    k = raw.shape[0]
    scatter = raw[:, 1 + d:].reshape(k, d, d)
    return GmmSuffStats(counts=scale * raw[:, 0], mean_stat=scale * raw[:, 1:1 + d],
                        scatter_stat=scale * 0.5 * (scatter + scatter.mT))


# ------------------------------------------------------------ plain version


def key_word(seed: int, step: int, device) -> torch.Tensor:
    """The kernels' Philox key as their device word: int64 {seed, step}
    (seed's 64 bits; the kernels take the step's low 32 as the stream),
    written by fills on the device, since a copy from the host would
    synchronise."""
    seed &= 0xFFFFFFFFFFFFFFFF
    word = torch.full((2,), seed - (1 << 64) if seed >= 1 << 63 else seed,
                      dtype=torch.int64, device=device)
    word[1].fill_(step & 0xFFFFFFFF)
    return word


def _draw_eps(shape, seed: int, step: int, like: torch.Tensor) -> torch.Tensor:
    gen = torch.Generator(device=like.device).manual_seed(seed + step)
    return torch.randn(shape, generator=gen, device=like.device, dtype=like.dtype)


def log_rho_plain(pot_h: torch.Tensor, pot_p: torch.Tensor, exp: GmmExpected
                  ) -> torch.Tensor:
    """The ρ-kernel's function in plain PyTorch: the pre-softmax log ρ (N, K)
    of ``svae.sin_combine``."""
    return svae.sin_log_rho(pot_h, pot_p, exp)


def combine_raw_plain(pot_h: torch.Tensor, pot_p: torch.Tensor, w: torch.Tensor,
                      eps: torch.Tensor, log_norm: torch.Tensor | None = None):
    """The kernel's function in plain PyTorch, on the packed block ``w``:
    (z (S, N, K, d), log_resp (N, K), mean (N, K, d), local (N,), raw
    (K, 1 + d + d²) unscaled, unsymmetrised statistics) — the composition
    ``sin_combine`` → ``sample_posterior`` → ``local_kl_term`` →
    ``suff_stats_from_moments`` (the reference's oracle,
    tests/test_combine_kernel.py:38-48). ``log_norm`` (N,) replaces the
    softmax's normaliser: log r̃ = log ρ − log_norm."""
    d = pot_h.shape[-1]
    exp = unpack_expected(w, d)
    post = svae.sin_combine(pot_h, pot_p, exp, log_norm=log_norm)
    z = svae.sample_posterior(post, eps.shape[0], eps=eps)
    local = svae.local_kl_term(post, exp)
    ezz = post.cov + post.mean[..., :, None] * post.mean[..., None, :]
    st = gmm.suff_stats_from_moments(torch.exp(post.log_resp), post.mean, ezz)
    raw = torch.cat([st.counts[:, None], st.mean_stat, st.scatter_stat.flatten(1)], dim=1)
    return z, post.log_resp, post.mean, local, raw


def combine_fused_plain(pot_h: torch.Tensor, pot_p: torch.Tensor, exp: GmmExpected,
                        eps: torch.Tensor | None, num_samples: int, scale: float = 1.0,
                        *, seed: int | None = None, step: int = 0,
                        log_norm: torch.Tensor | None = None):
    """``combine_raw_plain`` with ``combine_fused``'s packing, scaling and
    symmetrisation; returns what ``combine_fused`` returns. Seed mode draws
    ε from a generator seeded ``seed + step``."""
    k, d = exp.prec_mean.shape
    if eps is None:
        if seed is None:
            raise ValueError("combine_fused: eps=None requires a seed")
        eps = _draw_eps((num_samples, pot_h.shape[0], k, d), seed, step, pot_h)
    z, log_resp, mean, local, raw = combine_raw_plain(pot_h, pot_p, pack_expected(exp), eps,
                                                      log_norm)
    return z, log_resp, mean, local, stats_from_raw(raw, d, scale)


# ------------------------------------------------------ hand-written backward


def _sym(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.mT)


def _tril_half(a: torch.Tensor) -> torch.Tensor:
    """Φ(A): the lower triangle of A with its diagonal halved (Murray 2016)."""
    return torch.tril(a) - 0.5 * torch.diag_embed(torch.diagonal(a, dim1=-2, dim2=-1))


def combine_grads_manual(pot_h, pot_p, w, eps, dz=None, dlr=None, dmu=None,
                         dlocal=None, dstats=None, log_norm=None):
    """The backward of ``combine_raw_plain`` written out by hand.

    Cotangents of z (S, N, K, d), log r̃ (N, K), μ̃ (N, K, d), the local row
    (N,) and the raw statistics (K, 1 + d + d²); None is zero. Returns the
    cotangents of pot_h (N, d), pot_p (N, d) and w (K, 3 + d + d²), and with
    ``log_norm`` (N,) that of the normaliser, dn (N,): log r̃ = log ρ −
    log_norm has no softmax Jacobian, so ρ̄ = lr̄ and dn = −Σ_k lr̄.

    Per (n, k), with local_n = Σ_k r̃ A_k, A = log r̃ − (d/2)(1 + log 2π)
    + ½log|J̃| − E_q[log p̄], and ω = local̄ₙ·r̃:
      r̄ = local̄ₙ A + s̄₀ + s̄₁ᵀμ̃ + ⟨s̄₂, Σ̃ + μ̃μ̃ᵀ⟩,
      lr̄ = lr̄_out + ω + r̄ r̃,   ρ̄ = lr̄ − r̃ Σ_k lr̄  (softmax),
      μ̄ = μ̄_out + Σ_s z̄_s + ω(sym(E[Λ])μ̃ − E[Λμ]) + r̃(s̄₁ + (s̄₂ + s̄₂ᵀ)μ̃)
          + ½ρ̄ h̃,
      Σ̄ = ½ω sym(E[Λ]) + r̃ sym(s̄₂),  log|J̃|‾ = ½ω − ½ρ̄,
      h̃̄ = Σ̃μ̄ + ½ρ̄ μ̃,  L̄ = −Σ_s tril(u_s (L̃⁻¹z̄_s)ᵀ), u_s = L̃⁻ᵀε_s;
    the symmetric derivative in J̃ (d log|J̃| = tr(Σ̃dJ̃), dμ̃ = Σ̃(dh̃ − dJ̃μ̃),
    dΣ̃ = −Σ̃dJ̃Σ̃, Murray's Cholesky backward)
      G = log|J̃|‾ Σ̃ − sym(Σ̃μ̄ μ̃ᵀ) − Σ̃Σ̄Σ̃ + sym(L̃⁻ᵀΦ(L̃ᵀL̄)L̃⁻¹),
    read back through the Cholesky's lower triangle: P̄ₙ += diag G,
    E[Λ]‾ += tril(2G, −1) + diag G + ½ω(Σ̃ + μ̃μ̃ᵀ); and E[log π]‾ = ρ̄ − ω,
    E[log|Λ|]‾ = ½(ρ̄ − ω), E[μᵀΛμ]‾ = ½(ω − ρ̄), E[Λμ]‾ = h̃̄ − ωμ̃.
    """
    n, d = pot_h.shape
    k = w.shape[0]
    s = eps.shape[0]
    exp = unpack_expected(w, d)
    zeros = lambda *shape: torch.zeros(shape, dtype=w.dtype, device=w.device)  # noqa: E731
    dz = zeros(s, n, k, d) if dz is None else dz
    dlr = zeros(n, k) if dlr is None else dlr
    dmu = zeros(n, k, d) if dmu is None else dmu
    dlocal = zeros(n) if dlocal is None else dlocal
    dstats = zeros(k, stats_width(d)) if dstats is None else dstats
    ds0, ds1 = dstats[:, 0], dstats[:, 1:1 + d]
    ds2 = dstats[:, 1 + d:].reshape(k, d, d)
    prec, pm = exp.prec[None], exp.prec_mean[None]  # (1, K, d, d), (1, K, d)
    eye = torch.eye(d, dtype=w.dtype, device=w.device)

    # Forward, recomputed.
    jt = prec + torch.diag_embed(pot_p)[:, None]
    ht = pm + pot_h[:, None]
    chol = torch.linalg.cholesky(jt)
    li = torch.linalg.solve_triangular(chol, eye.expand_as(jt), upper=False)  # L̃⁻¹
    cov = li.mT @ li
    mu = (cov @ ht[..., None])[..., 0]
    logdet_j = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    log_rho = (exp.log_pi + 0.5 * exp.logdet - 0.5 * exp.quad
               + 0.5 * (mu * ht).sum(-1) - 0.5 * logdet_j)
    log_resp = (torch.log_softmax(log_rho, dim=-1) if log_norm is None
                else log_rho - log_norm[:, None])
    resp = torch.exp(log_resp)
    ezz = cov + mu[..., :, None] * mu[..., None, :]
    g_k = 0.5 * exp.logdet - 0.5 * d * _LOG_2PI - 0.5 * exp.quad
    e_log_pbar = (exp.log_pi + g_k + (pm * mu).sum(-1) - 0.5 * (prec * ezz).sum((-2, -1)))
    a_nk = log_resp - 0.5 * d * (1.0 + _LOG_2PI) + 0.5 * logdet_j - e_log_pbar
    u = (li.mT @ eps[..., None])[..., 0]  # (S, N, K, d) = L̃⁻ᵀε

    # Softmax and the responsibilities.
    omega = dlocal[:, None] * resp
    rbar = (dlocal[:, None] * a_nk + ds0 + (ds1 * mu).sum(-1) + (ds2 * ezz).sum((-2, -1)))
    lrbar = dlr + omega + rbar * resp
    if log_norm is None:
        rhobar = lrbar - resp * lrbar.sum(-1, keepdim=True)
    else:
        rhobar = lrbar

    # μ̃, Σ̃, log|J̃|, h̃.
    sprec = _sym(prec)
    mubar = (dmu + dz.sum(0) + omega[..., None] * ((sprec @ mu[..., None])[..., 0] - pm)
             + resp[..., None] * (ds1 + ((ds2 + ds2.mT) @ mu[..., None])[..., 0])
             + 0.5 * rhobar[..., None] * ht)
    covbar = 0.5 * omega[..., None, None] * sprec + resp[..., None, None] * _sym(ds2)
    ldbar = 0.5 * omega - 0.5 * rhobar
    cmb = (cov @ mubar[..., None])[..., 0]
    htbar = cmb + 0.5 * rhobar[..., None] * mu

    # Samples: L̄ = −tril(Σ_s u vᵀ), v = L̃⁻¹z̄.
    v = (li @ dz[..., None])[..., 0]
    lbar = -torch.tril((u[..., :, None] * v[..., None, :]).sum(0))
    g = (ldbar[..., None, None] * cov - _sym(cmb[..., :, None] * mu[..., None, :])
         - cov @ covbar @ cov + _sym(li.mT @ _tril_half(chol.mT @ lbar) @ li))

    diag_g = torch.diagonal(g, dim1=-2, dim2=-1)
    dph = htbar.sum(1)
    dpp = diag_g.sum(1)
    jbar = torch.tril(2.0 * g, diagonal=-1) + torch.diag_embed(diag_g)
    dprec = (jbar + 0.5 * omega[..., None, None] * ezz).sum(0)
    dw = torch.cat([(rhobar - omega).sum(0)[:, None],
                    (0.5 * (rhobar - omega)).sum(0)[:, None],
                    (0.5 * (omega - rhobar)).sum(0)[:, None],
                    (htbar - omega[..., None] * mu).sum(0),
                    dprec.reshape(k, d * d)], dim=1)
    if log_norm is None:
        return dph, dpp, dw
    return dph, dpp, dw, -lrbar.sum(-1)


def _forward_parts(pot_h, pot_p, w, log_norm=None) -> dict:
    """The forward per (n, k) as the kernels recompute it: L̃⁻¹, Σ̃ =
    L̃⁻ᵀL̃⁻¹, μ̃, h̃, log r̃, r̃ and a_nk (the local-KL term's per-pair part),
    for the mirrors below."""
    n, d = pot_h.shape
    exp = unpack_expected(w, d)
    prec, pm = exp.prec[None], exp.prec_mean[None]
    eye = torch.eye(d, dtype=w.dtype, device=w.device)
    jt = prec + torch.diag_embed(pot_p)[:, None]
    ht = pm + pot_h[:, None]
    chol = torch.linalg.cholesky(jt)
    li = torch.linalg.solve_triangular(chol, eye.expand_as(jt), upper=False)
    cov = li.mT @ li
    mu = (cov @ ht[..., None])[..., 0]
    logdet_j = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    log_rho = (exp.log_pi + 0.5 * exp.logdet - 0.5 * exp.quad
               + 0.5 * (mu * ht).sum(-1) - 0.5 * logdet_j)
    log_resp = (torch.log_softmax(log_rho, dim=-1) if log_norm is None
                else log_rho - log_norm[:, None])
    ezz = cov + mu[..., :, None] * mu[..., None, :]
    g_k = 0.5 * exp.logdet - 0.5 * d * _LOG_2PI - 0.5 * exp.quad
    e_log_pbar = (exp.log_pi + g_k + (pm * mu).sum(-1) - 0.5 * (prec * ezz).sum((-2, -1)))
    a_nk = log_resp - 0.5 * d * (1.0 + _LOG_2PI) + 0.5 * logdet_j - e_log_pbar
    return {"li": li, "cov": cov, "mu": mu, "ht": ht, "resp": torch.exp(log_resp),
            "a": a_nk, "ezz": ezz, "sprec": _sym(prec), "pm": pm}


def _rhobar(lrbar, resp, log_norm):
    """ρ̄ from lr̄: the softmax's Jacobian, or none under log_norm."""
    return lrbar if log_norm is not None else lrbar - resp * lrbar.sum(-1, keepdim=True)


def _chol_term(li, eps, v) -> torch.Tensor:
    """M = L̃⁻ᵀΦ(L̃ᵀL̄)L̃⁻¹ for L̄ = −Σ_s tril(u vᵀ), u = L̃⁻ᵀε, as the
    kernels form it: L̃ᵀu = ε makes Φ(L̃ᵀL̄)_ab = −Σ_s φ_ab ε_a v_b, so M =
    −Σ_s Aᵀ P with A_ai = L̃⁻¹_ai ε_a and P_aj = Σ_{b < a} v_b L̃⁻¹_bj +
    ½ v_a L̃⁻¹_aj (a prefix sum down each column of L̃⁻¹). eps, v (S, N, K, d)."""
    vy = v[..., :, None] * li  # (S, N, K, a, j)
    pre = torch.cumsum(vy, dim=-2) - 0.5 * vy
    amat = li * eps[..., :, None]
    return -(amat.mT @ pre).sum(0)


def combine_grads_lean(pot_h, pot_p, w, eps, dz=None, dlr=None, dmu=None, dlocal=None,
                       log_norm=None):
    """The train step's backward (no statistics' cotangent, no dw) as
    csrc/combine_bwd.cu computes it: per (n, k) only h̃̄ and diag G, with
    diag(Σ̃ sym(E[Λ]) Σ̃) as a quadratic form in each column of Σ̃ and the
    Cholesky term's diagonal from ``_chol_term``'s construction, never
    through L̃. Cotangents as ``combine_grads_manual`` takes them (None is
    zero); returns (dpot_h, dpot_p) and, with ``log_norm``, dn."""
    n, d = pot_h.shape
    k, s = w.shape[0], eps.shape[0]
    f = _forward_parts(pot_h, pot_p, w, log_norm)
    zeros = lambda *shape: torch.zeros(shape, dtype=w.dtype, device=w.device)  # noqa: E731
    dz = zeros(s, n, k, d) if dz is None else dz
    dlr = zeros(n, k) if dlr is None else dlr
    dmu = zeros(n, k, d) if dmu is None else dmu
    dlocal = zeros(n) if dlocal is None else dlocal
    li, cov, mu, resp = f["li"], f["cov"], f["mu"], f["resp"]
    omega = dlocal[:, None] * resp
    lrbar = dlr + omega + dlocal[:, None] * f["a"] * resp
    rhobar = _rhobar(lrbar, resp, log_norm)
    mubar = (dmu + dz.sum(0) + omega[..., None] * ((f["sprec"] @ mu[..., None])[..., 0] - f["pm"])
             + 0.5 * rhobar[..., None] * f["ht"])
    cmb = (li.mT @ (li @ mubar[..., None]))[..., 0]
    v = (li @ dz[..., None])[..., 0]
    mdiag = torch.diagonal(_chol_term(li, eps, v), dim1=-2, dim2=-1)
    quad = torch.einsum("nkai,nkab,nkbi->nki", cov, f["sprec"].expand_as(cov), cov)
    gdiag = ((0.5 * omega - 0.5 * rhobar)[..., None] * torch.diagonal(cov, dim1=-2, dim2=-1)
             - cmb * mu - 0.5 * omega[..., None] * quad + mdiag)
    dph = (cmb + 0.5 * rhobar[..., None] * mu).sum(1)
    if log_norm is None:
        return dph, gdiag.sum(1)
    return dph, gdiag.sum(1), -lrbar.sum(-1)


def combine_grads_split(pot_h, pot_p, w, eps, dz=None, dlr=None, dmu=None, dlocal=None,
                        dstats=None, log_norm=None):
    """The backward with dw as csrc/combine_bwd_full.cu splits it: (the
    sampling half's grads from the cotangents of z, log r̃ and μ̃ — its
    Cholesky term ``_chol_term`` — , the local/statistics half's from those
    of the local row and the statistics — Σ̃Σ̄Σ̃ with Σ̄ = ½ω sym(E[Λ]) +
    r̃ sym(s̄₂)), each (dpot_h, dpot_p, dw[, dn]) as ``combine_grads_manual``
    returns them; the two add up to it."""
    n, d = pot_h.shape
    k, s = w.shape[0], eps.shape[0]
    f = _forward_parts(pot_h, pot_p, w, log_norm)
    zeros = lambda *shape: torch.zeros(shape, dtype=w.dtype, device=w.device)  # noqa: E731
    dz = zeros(s, n, k, d) if dz is None else dz
    dlr = zeros(n, k) if dlr is None else dlr
    dmu = zeros(n, k, d) if dmu is None else dmu
    dlocal = zeros(n) if dlocal is None else dlocal
    dstats = zeros(k, stats_width(d)) if dstats is None else dstats
    li, cov, mu, resp, ezz = f["li"], f["cov"], f["mu"], f["resp"], f["ezz"]

    def half(lrbar, omega, mubar, g_extra):
        rhobar = _rhobar(lrbar, resp, log_norm)
        mubar = mubar + 0.5 * rhobar[..., None] * f["ht"]
        cmb = (cov @ mubar[..., None])[..., 0]
        htbar = cmb + 0.5 * rhobar[..., None] * mu
        g = ((0.5 * omega - 0.5 * rhobar)[..., None, None] * cov
             - _sym(cmb[..., :, None] * mu[..., None, :]) + g_extra)
        diag_g = torch.diagonal(g, dim1=-2, dim2=-1)
        jbar = torch.tril(2.0 * g, diagonal=-1) + torch.diag_embed(diag_g)
        dprec = (jbar + 0.5 * omega[..., None, None] * ezz).sum(0)
        dw = torch.cat([(rhobar - omega).sum(0)[:, None],
                        (0.5 * (rhobar - omega)).sum(0)[:, None],
                        (0.5 * (omega - rhobar)).sum(0)[:, None],
                        (htbar - omega[..., None] * mu).sum(0),
                        dprec.reshape(k, d * d)], dim=1)
        out = (htbar.sum(1), diag_g.sum(1), dw)
        return out if log_norm is None else (*out, -lrbar.sum(-1))

    v = (li @ dz[..., None])[..., 0]
    sample = half(dlr, zeros(n, k), dmu + dz.sum(0), _sym(_chol_term(li, eps, v)))
    ds0, ds1 = dstats[:, 0], dstats[:, 1:1 + d]
    ds2 = _sym(dstats[:, 1 + d:].reshape(k, d, d))
    omega = dlocal[:, None] * resp
    rbar = (dlocal[:, None] * f["a"] + ds0 + (ds1 * mu).sum(-1) + (ds2 * ezz).sum((-2, -1)))
    mubar = (omega[..., None] * ((f["sprec"] @ mu[..., None])[..., 0] - f["pm"])
             + resp[..., None] * (ds1 + 2.0 * (ds2 @ mu[..., None])[..., 0]))
    covbar = 0.5 * omega[..., None, None] * f["sprec"] + resp[..., None, None] * ds2
    local = half(omega + rbar * resp, omega, mubar, -cov @ covbar @ cov)
    return sample, local


def log_rho_grads_lean(pot_h, pot_p, w, drho):
    """The ρ-kernel's backward without dw (the train step's call) as
    csrc/combine.cu's log_rho_bwd forms it: per (n, k) only h̃̄ = ρ̄μ̃ and
    diag G = −½ρ̄(diag Σ̃ + μ̃²), diag Σ̃ the column sums of squares of L̃⁻¹
    (no full Σ̃), each summed over k in order. Returns the cotangents of
    pot_h, pot_p (N, d)."""
    d = pot_h.shape[-1]
    exp = unpack_expected(w, d)
    jt = exp.prec[None] + torch.diag_embed(pot_p)[:, None]
    ht = exp.prec_mean[None] + pot_h[:, None]
    chol = torch.linalg.cholesky(jt)
    li = torch.linalg.solve_triangular(chol, torch.eye(d, dtype=w.dtype, device=w.device),
                                       upper=False)
    mu = torch.cholesky_solve(ht[..., None], chol)[..., 0]
    diag_cov = (li * li).sum(-2)
    hbar = drho[..., None] * mu
    gdiag = -0.5 * drho[..., None] * (diag_cov + mu * mu)

    dph, dpp = hbar[:, 0], gdiag[:, 0]
    for c in range(1, w.shape[0]):
        dph, dpp = dph + hbar[:, c], dpp + gdiag[:, c]
    return dph, dpp


def log_rho_dw_planes(pot_h, pot_p, w, drho):
    """Per (n, k) the ρ-kernel's dw terms as its backward with dw adds them
    (N, K, 1 + d + d(d+1)/2): [ρ̄, ρ̄μ̃, G's lower triangle, row-major], G =
    −½ρ̄(Σ̃ + μ̃μ̃ᵀ)."""
    d = pot_h.shape[-1]
    exp = unpack_expected(w, d)
    jt = exp.prec[None] + torch.diag_embed(pot_p)[:, None]
    ht = exp.prec_mean[None] + pot_h[:, None]
    cov = torch.cholesky_inverse(torch.linalg.cholesky(jt))
    mu = (cov @ ht[..., None])[..., 0]
    g = -0.5 * drho[..., None, None] * (cov + mu[..., :, None] * mu[..., None, :])
    rows, cols = torch.tril_indices(d, d)
    return torch.cat([drho[..., None], drho[..., None] * mu, g[..., rows, cols]], dim=-1)


def rho_dw_from_planes(planes: torch.Tensor, d: int) -> torch.Tensor:
    """The reduce's kRhoDw layout: summed planes (K, 1 + d + d(d+1)/2) → dw
    (K, 3 + d + d²): [Σρ̄, ½Σρ̄, −½Σρ̄, Σρ̄μ̃, E[Λ]'s cotangent as the
    Cholesky reads it: 2G below the diagonal, G on it, 0 above]."""
    k = planes.shape[0]
    rows, cols = torch.tril_indices(d, d)
    g = torch.zeros((k, d, d), dtype=planes.dtype, device=planes.device)
    g[:, rows, cols] = planes[:, 1 + d:]
    jbar = torch.tril(2.0 * g, diagonal=-1) + torch.diag_embed(torch.diagonal(g, dim1=-2,
                                                                              dim2=-1))
    s = planes[:, :1]
    return torch.cat([s, 0.5 * s, -0.5 * s, planes[:, 1:1 + d], jbar.reshape(k, d * d)], dim=1)


def log_rho_grads_manual(pot_h, pot_p, w, drho):
    """The backward of ``log_rho_plain`` (on the packed ``w``) written out
    by hand, as the ρ-kernel's backward transcribes it: per (n, k), log ρ =
    E[log π] + ½E[log|Λ|] − ½E[μᵀΛμ] + ½μ̃ᵀh̃ − ½log|J̃| with μ̃ = J̃⁻¹h̃ gives
    h̃̄ = ρ̄μ̃ and the symmetric derivative in J̃, G = −½ρ̄(Σ̃ + μ̃μ̃ᵀ), read
    back through the Cholesky's lower triangle as ``combine_grads_manual``
    reads its G. Returns the cotangents of pot_h, pot_p (N, d) and w
    (K, 3 + d + d²)."""
    d = pot_h.shape[-1]
    exp = unpack_expected(w, d)
    jt = exp.prec[None] + torch.diag_embed(pot_p)[:, None]
    ht = exp.prec_mean[None] + pot_h[:, None]
    cov = torch.cholesky_inverse(torch.linalg.cholesky(jt))
    mu = (cov @ ht[..., None])[..., 0]
    g = -0.5 * drho[..., None, None] * (cov + mu[..., :, None] * mu[..., None, :])
    diag_g = torch.diagonal(g, dim1=-2, dim2=-1)
    htbar = drho[..., None] * mu
    jbar = torch.tril(2.0 * g, diagonal=-1) + torch.diag_embed(diag_g)
    k = w.shape[0]
    dw = torch.cat([drho.sum(0)[:, None], 0.5 * drho.sum(0)[:, None],
                    -0.5 * drho.sum(0)[:, None], htbar.sum(0),
                    jbar.sum(0).reshape(k, d * d)], dim=1)
    return htbar.sum(1), diag_g.sum(1), dw


# ------------------------------------------------------------- the wrapper


def unsupported_reason(n: int, k: int, d: int, num_samples: int) -> str | None:
    """Why the CUDA kernels cannot take these shapes (None = they can)."""
    if d not in LATENT_DIMS:
        return f"latent d = {d}: the kernel is built for d in {LATENT_DIMS}"
    if not 1 <= k <= MAX_COMPONENTS:
        return (f"K = {k}: one block holds a whole row of K for the softmax, "
                f"K <= {MAX_COMPONENTS}")
    if n < 1 or num_samples < 1:
        return "N and num_samples must be >= 1"
    if num_samples * n * k * d >= 2**32:
        return "S·N·K·d normals overflow the Philox counter"
    return None


def _f32(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.to(torch.float32).contiguous()


def _grid(lib, n: int, k: int, d: int, kind: int) -> int:
    """The kernels' partial count (``combine_grid``; kind 0/1 the forward,
    2/3 the backward with dw, odd kinds the log_norm mode), on the current
    device."""
    from svax_torch.ops import _build

    blocks = lib.combine_grid(n, k, d, kind)
    if blocks < 1:
        _build.check(lib, -blocks, "combine_grid")
    return blocks


class _CombineKernel(torch.autograd.Function):
    """The forward and recompute-backward kernels as one differentiable
    function of (pot_h, pot_p, w) and, in the log_norm mode, of the
    normaliser; ε (or its seed) is a constant."""

    @staticmethod
    def forward(ctx, ph, pp, w, norm, eps, word, num_samples):
        global launches, norm_launches
        from svax_torch.ops import _build
        ptr = _build.ptr

        lib = _build.load()
        n, d = ph.shape
        k = w.shape[0]
        kw = dict(device=ph.device, dtype=torch.float32)
        z = torch.empty((num_samples, n, k, d), **kw)
        log_resp = torch.empty((n, k), **kw)
        mean = torch.empty((n, k, d), **kw)
        local = torch.empty((n,), **kw)
        raw = torch.empty((k, stats_width(d)), **kw)
        stream = torch.cuda.current_stream(ph.device).cuda_stream
        with torch.cuda.device(ph.device):
            blocks = _grid(lib, n, k, d, 0 if norm is None else 1)
            partial = torch.empty((blocks, partial_planes(d), k), **kw)
            err = lib.combine_forward(
                ptr(ph), ptr(pp), ptr(w), ptr(eps), ptr(norm), n, k, d, num_samples,
                ptr(word), ptr(z), ptr(log_resp), ptr(mean), ptr(local), ptr(partial),
                ptr(raw), ctypes.c_void_p(stream))
        _build.check(lib, err, "combine_forward")
        if norm is None:
            launches += 1
        else:
            norm_launches += 1
        ctx.save_for_backward(ph, pp, w, norm, eps)
        # The word, not saved for backward: a graphed step advances it in
        # place after its backward has read it.
        ctx.word, ctx.num_samples = word, num_samples
        ctx.set_materialize_grads(False)
        return z, log_resp, mean, local, raw

    @staticmethod
    def backward(ctx, dz, dlr, dmu, dlocal, dstats):
        global backward_launches, norm_backward_launches
        global lean_backward_launches, norm_lean_backward_launches
        from svax_torch.ops import _build
        ptr = _build.ptr

        ph, pp, w, norm, eps = ctx.saved_tensors
        need_pot = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        need_w = ctx.needs_input_grad[2]
        need_norm = ctx.needs_input_grad[3]
        cts = [_f32(t) for t in (dz, dlr, dmu, dlocal, dstats)]
        if all(t is None for t in cts) or not (need_pot or need_w or need_norm):
            return (None,) * 7
        key = "+".join([name for name, t in zip(("dz", "dlr", "dmu", "dlocal", "dstats"), cts)
                        if t is not None] + ["dw"] * need_w + ["dn"] * need_norm)
        backward_paths[key] = backward_paths.get(key, 0) + 1
        lib = _build.load()
        n, d = ph.shape
        k = w.shape[0]
        kw = dict(device=ph.device, dtype=torch.float32)
        dph = torch.empty((n, d), **kw)
        dpp = torch.empty((n, d), **kw)
        dn = None if norm is None else torch.empty((n,), **kw)
        dw = partial = None
        lean = backward_variant(dstats is not None, need_w) == "lean"
        stream = torch.cuda.current_stream(ph.device).cuda_stream
        with torch.cuda.device(ph.device):
            if need_w:
                blocks = _grid(lib, n, k, d, 2 if norm is None else 3)
                partial = torch.empty((2, blocks, slot_width(d), k), **kw)
                dw = torch.empty((k, slot_width(d)), **kw)
            err = lib.combine_backward(
                ptr(ph), ptr(pp), ptr(w), ptr(eps), ptr(norm), n, k, d, ctx.num_samples,
                ptr(ctx.word), *(ptr(t) for t in cts), ptr(dph), ptr(dpp), ptr(dn),
                ptr(partial), ptr(dw), ctypes.c_void_p(stream))
        _build.check(lib, err, "combine_backward")
        if norm is None:
            backward_launches += 1
            lean_backward_launches += lean
        else:
            norm_backward_launches += 1
            norm_lean_backward_launches += lean
        return dph, dpp, dw, dn, None, None, None


class _RhoKernel(torch.autograd.Function):
    """The ρ-kernel and its recompute backward: log ρ (N, K) as a
    differentiable function of (pot_h, pot_p, w)."""

    @staticmethod
    def forward(ctx, ph, pp, w):
        global rho_launches
        from svax_torch.ops import _build
        ptr = _build.ptr

        lib = _build.load()
        n, d = ph.shape
        k = w.shape[0]
        log_rho = torch.empty((n, k), device=ph.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(ph.device).cuda_stream
        with torch.cuda.device(ph.device):
            err = lib.rho_forward(ptr(ph), ptr(pp), ptr(w), n, k, d, ptr(log_rho),
                                  ctypes.c_void_p(stream))
        _build.check(lib, err, "rho_forward")
        rho_launches += 1
        ctx.save_for_backward(ph, pp, w)
        return log_rho

    @staticmethod
    def backward(ctx, drho):
        global rho_backward_launches
        from svax_torch.ops import _build
        ptr = _build.ptr

        ph, pp, w = ctx.saved_tensors
        need_pot = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        need_w = ctx.needs_input_grad[2]
        if not (need_pot or need_w):
            return None, None, None
        key = "+".join(["dpot"] * need_pot + ["dw"] * need_w)
        rho_backward_paths[key] = rho_backward_paths.get(key, 0) + 1
        lib = _build.load()
        n, d = ph.shape
        k = w.shape[0]
        kw = dict(device=ph.device, dtype=torch.float32)
        dph = torch.empty((n, d), **kw)
        dpp = torch.empty((n, d), **kw)
        dw = partial = None
        stream = torch.cuda.current_stream(ph.device).cuda_stream
        with torch.cuda.device(ph.device):
            if need_w:
                blocks = lib.rho_blocks(n, k)
                if blocks < 1:
                    _build.check(lib, -blocks, "rho_blocks")
                partial = torch.empty((blocks, k, slot_width(d)), **kw)
                dw = torch.empty((k, slot_width(d)), **kw)
            err = lib.rho_backward(ptr(ph), ptr(pp), ptr(w), ptr(_f32(drho)), n, k, d,
                                   ptr(dph), ptr(dpp), ptr(partial), ptr(dw),
                                   ctypes.c_void_p(stream))
        _build.check(lib, err, "rho_backward")
        rho_backward_launches += 1
        return dph, dpp, dw


def _check_cuda(what: str, pot_h: torch.Tensor, k: int, s: int, tensors) -> None:
    """Raise unless the kernels take these CUDA tensors and shapes."""
    if pot_h.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {pot_h.device}")
    n, d = pot_h.shape
    reason = unsupported_reason(n, k, d, s)
    if reason is not None:
        raise ValueError(f"{what}: {reason}")
    for t in tensors:
        if t.dtype != torch.float32 or t.device != pot_h.device:
            raise ValueError(f"{what}: every tensor must be float32 on "
                             f"{pot_h.device} (got {t.dtype} on {t.device})")


def log_rho_fused(pot_h: torch.Tensor, pot_p: torch.Tensor, exp: GmmExpected
                  ) -> torch.Tensor:
    """This K-shard's pre-softmax log ρ (N, K), differentiable in pot_h,
    pot_p and ``exp``: the component-parallel companion of
    ``combine_fused`` (combine_pallas.log_rho_fused). Its logsumexp across
    the shards (``gmm.lse_over_components``) is ``combine_fused``'s
    ``log_norm``.

    CUDA tensors: the ρ-kernels of ``csrc/combine.cu`` (float32, latent d
    in LATENT_DIMS, K ≤ MAX_COMPONENTS); anything else raises. CPU tensors:
    ``log_rho_plain``."""
    if pot_h.device.type == "cpu":
        return log_rho_plain(pot_h, pot_p, exp)
    w = pack_expected(exp)
    _check_cuda("log_rho_fused", pot_h, w.shape[0], 1, [pot_h, pot_p, w])
    return _RhoKernel.apply(pot_h.contiguous(), pot_p.contiguous(), w)


def combine_fused(pot_h: torch.Tensor, pot_p: torch.Tensor, exp: GmmExpected,
                  eps: torch.Tensor | None, num_samples: int, scale: float = 1.0,
                  *, seed: int | torch.Tensor | None = None, step: int = 0,
                  log_norm: torch.Tensor | None = None):
    """Fused combine + local KL + sampling + statistics, differentiable in
    pot_h, pot_p, ``exp`` and ``log_norm``.

    pot_h, pot_p (N, d): the encoder's diagonal potentials; eps (S, N, K, d)
    standard normals, or None with ``seed`` (and the step folded into the
    Philox counter). ``seed`` is an int with ``step`` an int, or the device
    word itself (``key_word``'s int64 {seed, step} on pot_h's device, which
    a graphed runner fills per chunk and its captured step advances; ``step``
    is then not read). Returns (z (S, N, K, d), log_resp (N, K), mean
    (N, K, d), local (N,), GmmSuffStats × ``scale``). ``log_norm`` (N,):
    the log-normaliser of the responsibilities across every K-shard
    (component parallelism); log r̃ = log ρ − log_norm, and ``local`` and the
    statistics cover this shard's components only.

    CUDA tensors: the kernels of ``csrc/combine.cu`` (float32, latent d in
    LATENT_DIMS, K ≤ MAX_COMPONENTS); anything else raises. CPU tensors:
    ``combine_fused_plain``."""
    if eps is None and seed is None:
        raise ValueError("combine_fused: eps=None requires a seed")
    if pot_h.device.type == "cpu":
        if torch.is_tensor(seed):
            seed, step = int(seed[0]), int(seed[1])
        return combine_fused_plain(pot_h, pot_p, exp, eps, num_samples, scale,
                                   seed=seed, step=step, log_norm=log_norm)
    n, d = pot_h.shape
    k = exp.log_pi.shape[0]
    s = num_samples if eps is None else eps.shape[0]
    w = pack_expected(exp)
    _check_cuda("combine_fused", pot_h, k, s,
                [pot_h, pot_p, w] + [t for t in (eps, log_norm) if t is not None])
    if eps is not None:
        if tuple(eps.shape) != (s, n, k, d):
            raise ValueError(f"combine_fused: eps shape {tuple(eps.shape)} != {(s, n, k, d)}")
        eps = eps.contiguous()
    if log_norm is not None:
        if tuple(log_norm.shape) != (n,):
            raise ValueError(f"combine_fused: log_norm shape {tuple(log_norm.shape)} != {(n,)}")
        log_norm = log_norm.contiguous()
    word = None
    if eps is None:
        word = seed if torch.is_tensor(seed) else key_word(int(seed), int(step), pot_h.device)
        if word.dtype != torch.int64 or tuple(word.shape) != (2,) or word.device != pot_h.device:
            raise ValueError("combine_fused: the device word is int64 (2,) on "
                             f"{pot_h.device} (got {word.dtype} {tuple(word.shape)} on "
                             f"{word.device})")
    z, log_resp, mean, local, raw = _CombineKernel.apply(
        pot_h.contiguous(), pot_p.contiguous(), w, log_norm, eps, word, s)
    return z, log_resp, mean, local, stats_from_raw(raw, d, scale)
