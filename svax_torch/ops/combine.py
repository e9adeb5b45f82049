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
are the backwards the kernels transcribe.

Expected parameters reach the kernel packed one row per component as
``pack_expected`` lays them out: [log π, E[log|Λ|], E[μᵀΛμ], E[Λμ] (d),
E[Λ] (d×d row-major)] (combine_pallas.pack_expected, without padding).
Gradients flow to that block, and through it to the GmmExpected fields.

Noise: ``eps`` (S, N, K, d) injects it (the parity mode); with ``eps=None``
and a ``seed`` the kernel draws it from an in-kernel Philox4x32-10 +
Box–Muller keyed ``seed`` on stream ``step``, normal ((s·N + n)·K + k)·d + i,
and the backward regenerates the same numbers; ε is not returned (recover
it as L̃ᵀ(z − μ̃)). The plain version draws seed-mode noise from a
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
backward_launches = 0  # combine backward, softmax over K
norm_launches = 0  # combine forward with log_norm
norm_backward_launches = 0  # combine backward with log_norm
rho_launches = 0  # log_rho forward
rho_backward_launches = 0  # log_rho backward


def stats_width(d: int) -> int:
    """F = 1 + d + d²: [count, μ̃ (d), Σ̃ + μ̃μ̃ᵀ (d×d)] per component."""
    return 1 + d + d * d


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


class _CombineKernel(torch.autograd.Function):
    """The forward and recompute-backward kernels as one differentiable
    function of (pot_h, pot_p, w) and, in the log_norm mode, of the
    normaliser; ε (or its seed) is a constant."""

    @staticmethod
    def forward(ctx, ph, pp, w, norm, eps, seed, step, num_samples):
        global launches, norm_launches
        from svax_torch.ops import _build
        ptr = _build.ptr

        lib = _build.load()
        n, d = ph.shape
        k = w.shape[0]
        f = stats_width(d)
        blocks = lib.combine_blocks(n, k)
        kw = dict(device=ph.device, dtype=torch.float32)
        z = torch.empty((num_samples, n, k, d), **kw)
        log_resp = torch.empty((n, k), **kw)
        mean = torch.empty((n, k, d), **kw)
        local = torch.empty((n,), **kw)
        partial = torch.empty((blocks, k, f), **kw)
        raw = torch.empty((k, f), **kw)
        stream = torch.cuda.current_stream(ph.device).cuda_stream
        with torch.cuda.device(ph.device):
            err = lib.combine_forward(
                ptr(ph), ptr(pp), ptr(w), ptr(eps), ptr(norm), n, k, d, num_samples,
                seed & 0xFFFFFFFFFFFFFFFF, step & 0xFFFFFFFF,
                ptr(z), ptr(log_resp), ptr(mean), ptr(local), ptr(partial), ptr(raw),
                ctypes.c_void_p(stream))
        _build.check(lib, err, "combine_forward")
        if norm is None:
            launches += 1
        else:
            norm_launches += 1
        ctx.save_for_backward(ph, pp, w, norm, eps)
        ctx.seed, ctx.step, ctx.num_samples = seed, step, num_samples
        ctx.set_materialize_grads(False)
        return z, log_resp, mean, local, raw

    @staticmethod
    def backward(ctx, dz, dlr, dmu, dlocal, dstats):
        global backward_launches, norm_backward_launches
        from svax_torch.ops import _build
        ptr = _build.ptr

        ph, pp, w, norm, eps = ctx.saved_tensors
        need_pot = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        need_w = ctx.needs_input_grad[2]
        need_norm = ctx.needs_input_grad[3]
        cts = [_f32(t) for t in (dz, dlr, dmu, dlocal, dstats)]
        if all(t is None for t in cts) or not (need_pot or need_w or need_norm):
            return (None,) * 8
        lib = _build.load()
        n, d = ph.shape
        k = w.shape[0]
        kw = dict(device=ph.device, dtype=torch.float32)
        dph = torch.empty((n, d), **kw)
        dpp = torch.empty((n, d), **kw)
        dn = None if norm is None else torch.empty((n,), **kw)
        dw = partial = None
        if need_w:
            partial = torch.empty((lib.combine_blocks(n, k), k, slot_width(d)), **kw)
            dw = torch.empty((k, slot_width(d)), **kw)
        stream = torch.cuda.current_stream(ph.device).cuda_stream
        with torch.cuda.device(ph.device):
            err = lib.combine_backward(
                ptr(ph), ptr(pp), ptr(w), ptr(eps), ptr(norm), n, k, d, ctx.num_samples,
                ctx.seed & 0xFFFFFFFFFFFFFFFF, ctx.step & 0xFFFFFFFF,
                *(ptr(t) for t in cts), ptr(dph), ptr(dpp), ptr(dn), ptr(partial), ptr(dw),
                ctypes.c_void_p(stream))
        _build.check(lib, err, "combine_backward")
        if norm is None:
            backward_launches += 1
        else:
            norm_backward_launches += 1
        return dph, dpp, dw, dn, None, None, None, None


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
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1] or ctx.needs_input_grad[2]):
            return None, None, None
        lib = _build.load()
        n, d = ph.shape
        k = w.shape[0]
        kw = dict(device=ph.device, dtype=torch.float32)
        dph = torch.empty((n, d), **kw)
        dpp = torch.empty((n, d), **kw)
        dw = partial = None
        if ctx.needs_input_grad[2]:
            partial = torch.empty((lib.combine_blocks(n, k), k, slot_width(d)), **kw)
            dw = torch.empty((k, slot_width(d)), **kw)
        stream = torch.cuda.current_stream(ph.device).cuda_stream
        with torch.cuda.device(ph.device):
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
                  *, seed: int | None = None, step: int = 0,
                  log_norm: torch.Tensor | None = None):
    """Fused combine + local KL + sampling + statistics, differentiable in
    pot_h, pot_p, ``exp`` and ``log_norm``.

    pot_h, pot_p (N, d): the encoder's diagonal potentials; eps (S, N, K, d)
    standard normals, or None with ``seed`` (and the step folded into the
    Philox counter). Returns (z (S, N, K, d), log_resp (N, K), mean
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
    z, log_resp, mean, local, raw = _CombineKernel.apply(
        pot_h.contiguous(), pot_p.contiguous(), w, log_norm, eps,
        0 if seed is None else int(seed), int(step), s)
    return z, log_resp, mean, local, stats_from_raw(raw, d, scale)
