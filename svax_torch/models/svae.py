"""Structured VAE: SIN combine, mixture reparam sampling, structured ELBO
(``svax/models/svae.py``: Gaussian and Bernoulli likelihoods, the
diagonal and full recognition heads, the weighted and sampled
reconstruction estimators, the fused combine).

One forward pass computes, in closed form except the reconstruction Monte
Carlo: encoder potentials (h, P); the SIN combine with the expected GMM
naturals, J̃_nk = Pₙ + E[Λ_k] (+ jitter·I), μ̃_nk = J̃⁻¹(hₙ + E[Λμ]_k); the
mixture responsibilities r̃; the reconstruction term — S reparameterised
samples per (n, k) through the decoder, weighted by r̃ ("weighted"), or S
samples per n of one component k̂ ~ Cat(r̃) each with a REINFORCE term for
r̃'s gradient ("sampled"); the local KL; the global KL; and the CVI
sufficient statistics.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from svax_torch.nets import mlp as nets
from svax_torch.ops import batched_linalg as bl
from svax_torch.parallel import mesh
from svax_torch.pgm import gmm
from svax_torch.pgm.gmm import GmmExpected, GmmNat, GmmSuffStats

_LOG_2PI = math.log(2.0 * math.pi)


class SvaeConfig(NamedTuple):
    """The SVAE configuration, with the reference's fields and defaults
    (``svax/models/svae.py:SvaeConfig``). ``activation`` and
    ``nn_precision`` are names here, not a callable and a
    ``jax.lax.Precision`` (``nets.mlp``: ACTIVATIONS, PRECISIONS), so that
    configs and bundles stay plain data; component sharding is
    ``forward(comp_group=)``."""

    latent_dim: int
    num_components: int
    num_samples: int = 1
    num_total: int = 1  # dataset size N for minibatch scaling
    likelihood: str = "gaussian"  # or "bernoulli"
    # "bfloat16" runs the Bernoulli decoder body in bf16 with f32
    # accumulation of every (n, k) reduction (nets.bernoulli_loglik_decomposed).
    nn_compute_dtype: str = "float32"
    # Route the combine, local KL, sampling and statistics through
    # ops.combine.combine_fused: the CUDA kernels on CUDA tensors, their
    # plain version on CPU tensors.
    fused_combine: bool = False
    # With fused_combine and a seed (no injected eps): ε is drawn inside the
    # kernel from Philox keyed (seed, step) instead of torch.randn.
    kernel_rng: bool = False
    # Route a Bernoulli decoder with two tanh hidden layers through
    # ops.decoder_mlp.bernoulli_mlp_loglik_fused: the CUDA kernels on CUDA
    # tensors, their plain version on CPU tensors (bf16 products, f32
    # activations, whatever nn_compute_dtype says).
    fused_mlp_decoder: bool = False
    # Route the Bernoulli decoder's x-free row sum through
    # ops.decoder.rowsum_logsig_neg so the (S·N·K, D) logits never reach
    # device memory (forward and backward). Acts at f32 decoder compute
    # only; no-op for Gaussian likelihoods, and the fused MLP decoder takes
    # precedence when it applies.
    fused_decoder: bool = False
    # Rematerialise the decoder in the backward pass
    # (torch.utils.checkpoint): drops the (S·N·K, hidden) activation
    # residuals and recomputes the decoder instead.
    remat_decoder: bool = False
    # Student-t mixture (SMM) latent prior: dof > 0 selects models.svae_smm
    # with smm_iters u–z coordinate rounds; smm_envelope_grads stops the
    # gradient through the converged q(u) (the envelope theorem).
    dof: float = 0.0
    smm_iters: int = 2
    smm_envelope_grads: bool = False
    # Reconstruction estimator: "weighted" decodes S samples of every
    # component, Σ_k r̃·E[log p(x|z_k)] (S·N·K decoder rows); "sampled"
    # draws k̂ ~ Cat(r̃) per (s, n) and decodes that component's sample
    # (S·N rows), r̃'s gradient restored by a REINFORCE term with a
    # leave-one-out baseline (_recon_sampled).
    recon_mode: str = "weighted"
    # Added to J̃'s diagonal when > 0 (the fused combine then steps aside).
    jitter: float = 0.0
    # Hidden-layer activation of both nets: "tanh", "relu" or "softplus".
    activation: str = "tanh"
    # Precision of the MLP products (nets.mlp's table): "highest" and
    # "high" f32, "default" bf16-rounded operands with f32 sums; the
    # whole-step kernels take "default" as their bf16-product mode and the
    # fused row sum "high" and "default" as its bf16-operand mode.
    nn_precision: str = "high"
    # Recompute the SIN combine in the backward pass
    # (torch.utils.checkpoint) instead of keeping its N×K×d×d residuals.
    remat_combine: bool = False
    # Recognition potential: "diag" (per-point diagonal precision) or
    # "full" (a Cholesky-parameterised (d, d) precision per point, whose
    # zero off-diagonals give "diag"); the fused combine and the whole-step
    # kernels take "diag" only.
    encoder_head: str = "diag"

    @property
    def decoder_compute_dtype(self) -> torch.dtype | None:
        return None if self.nn_compute_dtype == "float32" else getattr(
            torch, self.nn_compute_dtype)


_FUSED_OMITTED_MSG = (
    "this SinPosterior came from the fused combine kernel "
    "(SvaeConfig.fused_combine=True), which keeps prec_chol/cov/logdet_prec "
    "inside the kernel and does not return them (they are None); rerun with "
    "fused_combine=False (the sin_combine path) to get them."
)


def _require_full_posterior(post: "SinPosterior", caller: str) -> None:
    if post.prec_chol is None or post.cov is None or post.logdet_prec is None:
        raise ValueError(f"{caller}: {_FUSED_OMITTED_MSG}")


class SinPosterior(NamedTuple):
    """Per-(n,k) structured posterior q(z|x,k) and mixture weights."""

    mean: torch.Tensor  # (N, K, d) μ̃
    prec_chol: torch.Tensor  # (N, K, d, d) chol(J̃)
    cov: torch.Tensor  # (N, K, d, d) Σ̃ = J̃⁻¹
    log_resp: torch.Tensor  # (N, K) normalized log r̃
    logdet_prec: torch.Tensor  # (N, K) log|J̃|


class SvaeOutputs(NamedTuple):
    elbo: torch.Tensor
    recon: torch.Tensor
    local_kl: torch.Tensor
    global_kl: torch.Tensor
    suff_stats: GmmSuffStats
    posterior: SinPosterior


def _sin_core(pot_h: torch.Tensor, pot_p: torch.Tensor, exp: GmmExpected,
              jitter: float = 0.0):
    """(μ̃, chol J̃, Σ̃, log|J̃|, pre-softmax log ρ) of the SIN combine;
    ``pot_p`` diagonal (N, d) or full (N, d, d)."""
    d = pot_h.shape[-1]
    eye = torch.eye(d, dtype=pot_h.dtype, device=pot_h.device)
    pot_prec = pot_p if pot_p.ndim == pot_h.ndim + 1 else pot_p[:, :, None] * eye
    prec = pot_prec[:, None] + exp.prec[None]  # (N, K, d, d)
    if jitter > 0.0:
        prec = prec + jitter * eye
    h = pot_h[:, None, :] + exp.prec_mean[None]  # (N, K, d)
    chol = bl.cholesky(prec)
    mean = bl.cho_solve_vec(chol, h)
    logdet_prec = bl.logdet_from_chol(chol)
    cov = bl.inv_psd(chol)
    log_rho = (
        exp.log_pi[None, :]
        + 0.5 * exp.logdet[None, :]
        - 0.5 * exp.quad[None, :]
        + 0.5 * (mean * h).sum(dim=-1)
        - 0.5 * logdet_prec
    )
    return mean, chol, cov, logdet_prec, log_rho


def sin_log_rho(pot_h: torch.Tensor, pot_p: torch.Tensor, exp: GmmExpected
                ) -> torch.Tensor:
    """The SIN combine's pre-softmax log ρ (N, K)."""
    return _sin_core(pot_h, pot_p, exp)[4]


def sin_combine(
    pot_h: torch.Tensor, pot_p: torch.Tensor, exp: GmmExpected,
    comp_group=None, log_norm: torch.Tensor | None = None, *, jitter: float = 0.0,
) -> SinPosterior:
    """Conjugate combine of the encoder potential — diagonal (N, d) or full
    (N, d, d) ``pot_p`` — with the expected GMM naturals (§9.4), ``jitter``
    added to J̃'s diagonal when > 0. The responsibility formula drops per-n
    constants, which cancel in the softmax over k, for both shapes.

    With ``comp_group`` (component parallelism), ``exp`` holds this rank's
    K-shard and the softmax normalises across the group's shards
    (``gmm.lse_over_components``: one MAX and one SUM all-reduce).
    ``log_norm`` (N,) gives that normaliser directly (the fused combine's
    log_norm mode; ``ops.combine.combine_raw_plain`` passes it)."""
    mean, chol, cov, logdet_prec, log_rho = _sin_core(pot_h, pot_p, exp, jitter)
    if log_norm is None and comp_group is not None:
        log_norm = gmm.lse_over_components(log_rho, comp_group)
    if log_norm is None:
        log_resp = torch.log_softmax(log_rho, dim=-1)
    else:
        log_resp = log_rho - log_norm[:, None]
    return SinPosterior(
        mean=mean, prec_chol=chol, cov=cov, log_resp=log_resp,
        logdet_prec=logdet_prec,
    )


def sample_posterior(
    post: SinPosterior,
    num_samples: int,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """S reparameterised draws z = μ̃ + L̃⁻ᵀε per (n, k): (S, N, K, d).

    ``eps`` (S, N, K, d) overrides the draw from ``generator``."""
    _require_full_posterior(post, "sample_posterior")
    shape = (num_samples,) + tuple(post.mean.shape)
    if eps is None:
        eps = torch.randn(
            shape, generator=generator, device=post.mean.device,
            dtype=post.mean.dtype,
        )
    else:
        eps = eps.to(post.mean.dtype)
    chol = post.prec_chol.expand((num_samples,) + tuple(post.prec_chol.shape))
    return post.mean[None] + bl.solve_triu_vec(chol, eps)


def _weighted_loglik_fn(config: SvaeConfig):
    """The decoder log-likelihood callable, checkpointed under
    ``remat_decoder`` (svax/models/svae.py:248-252)."""
    if not config.remat_decoder:
        return _weighted_loglik

    def remat(dec_params, z, x, cfg):
        # The decoder draws no random numbers: no RNG state to replay.
        return checkpoint(_weighted_loglik, dec_params, z, x, cfg, use_reentrant=False,
                          preserve_rng_state=False)

    return remat


def _weighted_loglik(dec_params: list, z: torch.Tensor, x: torch.Tensor,
                     config: SvaeConfig) -> torch.Tensor:
    """Decoder log-likelihood batched over (S, N, K): the fused MLP decoder
    under the reference's conditions (svax/models/svae.py:258-269: the
    switch, a Bernoulli likelihood, three decoder layers, tanh), else the
    Bernoulli head in its x-free decomposed form (in ``nn_compute_dtype``;
    with ``fused_decoder`` at f32, its row sum in ``ops.decoder``), else
    Gaussian; the nets at ``activation`` and ``nn_precision``."""
    if (config.fused_mlp_decoder and config.likelihood == "bernoulli"
            and len(dec_params) == 3 and config.activation == "tanh"):
        from svax_torch.ops import decoder_mlp

        return decoder_mlp.bernoulli_mlp_loglik_fused(dec_params, z, x)
    if config.likelihood == "bernoulli":
        return nets.bernoulli_loglik_decomposed(
            dec_params, z, x, compute_dtype=config.decoder_compute_dtype,
            fused=config.fused_decoder, precision=config.nn_precision,
            activation=config.activation)
    return nets.log_likelihood(dec_params, z, x[None, :, None, :], config.likelihood,
                               config.activation, config.nn_precision,
                               config.decoder_compute_dtype)


def gumbel_draws(shape, generator: torch.Generator | None, *, device, dtype
                 ) -> torch.Tensor:
    """Standard Gumbel draws −log(−log u), u uniform from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def _recon_sampled(dec_params: list, post: SinPosterior, x: torch.Tensor,
                   config: SvaeConfig, generator: torch.Generator | None = None,
                   draws: tuple | None = None) -> torch.Tensor:
    """Sampled-component reconstruction estimator: per-point (N,) values
    (svax/models/svae.py:288-360).

    Unbiased for Σ_k r̃_nk E_q(z|n,k)[log p(x|z)]: k̂_sn ~ Cat(r̃_n) by
    Gumbel-max on the detached log r̃, z = μ̃ + L̃⁻ᵀε of that component
    alone, so the decoder sees S·N rows instead of S·N·K. The REINFORCE
    surrogate sg(ll − b)·(log r̃_k̂ − sg(log r̃_k̂)) adds 0 to the value and
    the missing E[ll·∇log r̃] to the gradient. The baseline b leaves each
    draw out: the mean over the other S − 1 samples of the point when
    S > 1, else over the other points of the batch.

    The Gumbel (S, N, K) and then the ε (S, N, d) draws come from
    ``generator``, or ``draws`` = (gumbel, eps) injects them."""
    _require_full_posterior(post, "_recon_sampled")
    s = config.num_samples
    n, k, d = post.mean.shape
    kw = dict(device=post.mean.device, dtype=post.mean.dtype)
    if draws is None:
        gumbel = gumbel_draws((s, n, k), generator, **kw)
        eps = torch.randn((s, n, d), generator=generator, **kw)
    else:
        gumbel, eps = (t.to(**kw) for t in draws)
    khat = torch.argmax(post.log_resp.detach()[None] + gumbel, dim=-1)  # (S, N)
    rows = torch.arange(n, device=khat.device)[None, :]
    z = post.mean[rows, khat] + bl.solve_triu_vec(post.prec_chol[rows, khat], eps)
    ll = nets.log_likelihood(dec_params, z, x[None], config.likelihood, config.activation,
                             config.nn_precision, config.decoder_compute_dtype)  # (S, N)
    logr_sel = post.log_resp[rows, khat]  # (S, N), with its gradient
    if s > 1:
        baseline = (ll.sum(dim=0, keepdim=True) - ll) / (s - 1)
    else:
        baseline = (ll.sum() - ll) / max(ll.numel() - 1, 1)
    reinforce = (ll - baseline).detach() * (logr_sel - logr_sel.detach())
    return (ll + reinforce).mean(dim=0)


def local_kl_term(post: SinPosterior, exp: GmmExpected) -> torch.Tensor:
    """KL(q(z,k|x) ‖ p̄(z,k)) per datapoint, closed form (§9.6): (N,).

    With ḡ_k = ½E[log|Λ|] − (d/2)log2π − ½E[μᵀΛμ]:
      E_q[log p̄(z,k)] = E[logπ_k] + ḡ_k + h̄_kᵀμ̃ − ½(tr(J̄Σ̃) + μ̃ᵀJ̄μ̃)
      E_q[log q(z|n,k)] = −(d/2)(1+log2π) + ½log|J̃|
    """
    _require_full_posterior(post, "local_kl_term")
    d = post.mean.shape[-1]
    resp = torch.exp(post.log_resp)
    g_k = 0.5 * exp.logdet - 0.5 * d * _LOG_2PI - 0.5 * exp.quad
    cross = torch.einsum("ki,nki->nk", exp.prec_mean, post.mean)
    tr_term = torch.einsum("kij,nkij->nk", exp.prec, post.cov)
    quad_mu = torch.einsum("nki,kij,nkj->nk", post.mean, exp.prec, post.mean)
    e_log_pbar = exp.log_pi[None, :] + g_k[None, :] + cross - 0.5 * (tr_term + quad_mu)
    e_log_q = post.log_resp - 0.5 * d * (1.0 + _LOG_2PI) + 0.5 * post.logdet_prec
    return -(resp * (e_log_pbar - e_log_q)).sum(dim=-1)


def check_recon_mode(config: SvaeConfig, comp_group=None) -> None:
    """Raise for an unknown reconstruction estimator and, as the reference
    asserts (svax/models/svae.py:399-404), for the sampled one under
    component parallelism: it needs the full responsibility row."""
    if config.recon_mode not in ("weighted", "sampled"):
        raise ValueError(f"unknown recon_mode {config.recon_mode!r} (weighted|sampled)")
    if config.recon_mode == "sampled" and comp_group is not None:
        raise ValueError("recon_mode='sampled' needs the full responsibility row; it does "
                         "not compose with component parallelism — use 'weighted'.")


def forward(
    nn_params: dict,
    pgm_nat: GmmNat,
    prior_nat: GmmNat,
    x: torch.Tensor,
    config: SvaeConfig,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    *,
    seed: int | None = None,
    step: int = 0,
    comp_group=None,
    sampled_draws: tuple | None = None,
) -> SvaeOutputs:
    """Full SVAE forward pass → structured ELBO + CVI payload.

    ``eps`` (S, N, K, d) injects the weighted estimator's reparameterisation
    noise; otherwise it is drawn from ``generator``, or — with
    ``fused_combine`` and ``kernel_rng`` — inside the combine kernel from
    Philox keyed (``seed``, ``step``) when a seed is given. The sampled
    estimator draws its Gumbel and ε noise from ``generator``
    (``_recon_sampled``; ``sampled_draws`` injects them) and refuses
    ``eps``, as the reference asserts.

    With ``config.fused_combine`` — and, as in the reference
    (svax/models/svae.py:412-418), weighted reconstruction, zero jitter and
    the diagonal head — the combine, local KL, sampling and statistics run
    in ``ops.combine.combine_fused`` (its CUDA kernels on CUDA tensors, the
    plain composition on CPU tensors), and the returned posterior carries
    ``mean`` and ``log_resp`` only; otherwise the plain ``sin_combine``
    runs, under ``remat_combine`` recomputed in the backward pass.

    With ``comp_group`` the PGM naturals, ``eps`` and the statistics are
    this rank's K-shard (component parallelism): the softmax normalises
    across the group, recon and the local KL are summed over it (an
    autograd SUM all-reduce, ``parallel.mesh.psum``) and the global KL is
    the whole mixture's, so the returned terms are the comp-global values
    on every rank. The fused branch then runs the ρ-kernel
    (``combine.log_rho_fused``), the cross-shard logsumexp, and the combine
    in its ``log_norm`` mode."""
    check_recon_mode(config, comp_group)
    sampled = config.recon_mode == "sampled"
    if sampled and eps is not None:
        raise ValueError("eps injection is a weighted-mode parity hook; the sampled "
                         "estimator takes sampled_draws")
    n = x.shape[0]
    scale = config.num_total / n
    exp = gmm.expected_params(pgm_nat, comp_group)
    pot_h, pot_p = nets.encoder_apply(nn_params["encoder"], x, config.activation,
                                      config.nn_precision, config.encoder_head)
    use_fused_combine = (config.fused_combine and not sampled and config.jitter == 0.0
                         and pot_p.ndim == 2)
    if use_fused_combine:
        from svax_torch.ops import combine

        k, d = exp.prec_mean.shape
        if eps is None and not (config.kernel_rng and seed is not None):
            eps = torch.randn((config.num_samples, n, k, d), generator=generator,
                              device=x.device, dtype=pot_h.dtype)
        log_norm = None
        if comp_group is not None:
            # The flash-softmax decomposition: this shard's log ρ, its
            # logsumexp across the shards, then the combine weighted by it.
            log_norm = gmm.lse_over_components(
                combine.log_rho_fused(pot_h, pot_p, exp), comp_group)
        z, log_resp, mean, local_n, stats = combine.combine_fused(
            pot_h, pot_p, exp, eps, config.num_samples, scale=scale,
            seed=None if eps is not None else seed, step=step, log_norm=log_norm)
        post = SinPosterior(mean=mean, prec_chol=None, cov=None, log_resp=log_resp,
                            logdet_prec=None)
        local = scale * local_n.sum()
    else:
        if config.remat_combine:
            # The combine draws no random numbers: no RNG state to replay.
            post = checkpoint(lambda h, p, e: sin_combine(h, p, e, comp_group,
                                                          jitter=config.jitter),
                              pot_h, pot_p, exp, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            post = sin_combine(pot_h, pot_p, exp, comp_group, jitter=config.jitter)
        if not sampled:
            z = sample_posterior(post, config.num_samples, eps=eps, generator=generator)
        local = scale * local_kl_term(post, exp).sum()
        ezz = post.cov + post.mean[..., :, None] * post.mean[..., None, :]
        stats = gmm.suff_stats_from_moments(torch.exp(post.log_resp), post.mean, ezz,
                                            scale=scale)
    if sampled:
        recon = scale * _recon_sampled(nn_params["decoder"], post, x, config, generator,
                                       sampled_draws).sum()
    else:
        resp = torch.exp(post.log_resp)
        loglik = _weighted_loglik_fn(config)(nn_params["decoder"], z, x, config)  # (S, N, K)
        recon = scale * (resp * loglik.mean(dim=0)).sum()
    if comp_group is not None:
        recon, local = mesh.psum(torch.stack([recon, local]), comp_group).unbind()
    global_kl = gmm.kl_global(pgm_nat, prior_nat, comp_group)
    return SvaeOutputs(
        elbo=recon - local - global_kl,
        recon=recon,
        local_kl=local,
        global_kl=global_kl,
        suff_stats=stats,
        posterior=post,
    )


def generate(nn_params: dict, pgm_nat: GmmNat, generator: torch.Generator,
             num_samples: int, config: SvaeConfig, sample_params: bool = False):
    """Generate data from the learned model: (z, k) from the mixture
    (``gmm.sample_generative``), x from the decoder at z. Returns (x, z,
    labels); x is the Gaussian decoder's mean or, for a Bernoulli head, the
    pixel probability map."""
    z, labels = gmm.sample_generative(generator, pgm_nat, num_samples,
                                      sample_params=sample_params)
    out = nets.decoder_apply(nn_params["decoder"], z, config.likelihood,
                             config.activation, config.nn_precision)
    if config.likelihood == "gaussian":
        return out[0], z, labels
    return torch.sigmoid(out), z, labels


def init_params(
    generator: torch.Generator,
    input_dim: int,
    config: SvaeConfig,
    encoder_hidden=(50, 50),
    decoder_hidden=(50, 50),
    *,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Encoder (input → ``nets.encoder_out_dim(d, config.encoder_head)``)
    and a decoder for ``config.likelihood``: Gaussian (d → 2·input) or
    Bernoulli (d → input logits)."""
    kw = dict(device=device, dtype=dtype)
    d = config.latent_dim
    return {
        "encoder": nets.encoder_init(generator, input_dim, encoder_hidden, d,
                                     config.encoder_head, **kw),
        "decoder": nets.decoder_init(generator, d, decoder_hidden, input_dim,
                                     config.likelihood, **kw),
    }
