"""Training loops (``svax/train/loop.py``, the pinwheel-SVAE and
pure-mixture subset).

``augment_step`` wraps a step with input-noise augmentation;
``make_runner`` is the chunk runner that drives T full-batch steps per
call through the tinystep CUDA kernel (or its plain version), taking the
place of the reference's ``make_scan_runner`` and of the tinystep branch
of ``make_megakernel_runner``; ``make_mixture_runner`` does the same for
the GMM/SMM through the mixstep kernel (the reference's
``make_mixture_megakernel_runner``).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from svax_torch.ops import mixstep, tinystep
from svax_torch.pgm import gmm


def augment_step(step: Callable, sigma: float) -> Callable:
    """Wrap ``step(state, xb, eps=None, generator=None)`` with input-noise
    augmentation: the step trains on ``xb + sigma·ξ``, so the noise perturbs
    both the encoder input and the reconstruction target. ξ is ``aug_eps``
    when given, else drawn from ``generator`` BEFORE the step draws its ε
    (the reference's split-first key discipline). ``sigma <= 0`` returns
    ``step`` unchanged."""
    if sigma <= 0.0:
        return step

    def wrapped(state, xb, eps=None, aug_eps=None, generator=None):
        if aug_eps is None:
            aug_eps = torch.randn(xb.shape, generator=generator,
                                  device=xb.device, dtype=xb.dtype)
        return step(state, xb + sigma * aug_eps, eps=eps, generator=generator)

    return wrapped


def kernel_unsupported_reason(config, *, batch_full: bool, encoder_hidden,
                              decoder_hidden, rho, rho_decay: float = 0.0,
                              likelihood: str = "gaussian") -> str | None:
    """Why the tinystep kernel cannot run this workload (None = it can).

    The shape class: latent d = 2, Gaussian likelihood, two matched
    hidden layers of a width the kernel is built for, full batch,
    constant ρ, K up to tinystep.MAX_COMPONENTS. A workload outside it is
    rejected with this reason; nothing changes semantics quietly."""
    encoder_hidden, decoder_hidden = tuple(encoder_hidden), tuple(decoder_hidden)
    if config.latent_dim != 2:
        return f"the tinystep kernel needs latent d = 2 (got {config.latent_dim})"
    if likelihood != "gaussian":
        return f"the tinystep kernel needs a Gaussian likelihood (got {likelihood})"
    if encoder_hidden != decoder_hidden or encoder_hidden not in tinystep.SUPPORTED_HIDDEN:
        return (f"the tinystep kernel needs matched hidden widths in "
                f"{tinystep.SUPPORTED_HIDDEN} (got {encoder_hidden} / "
                f"{decoder_hidden})")
    if not batch_full:
        return "the tinystep kernel trains on the full batch only"
    if callable(rho) or rho_decay != 0.0:
        return "the tinystep kernel needs a constant rho"
    if not 1 <= config.num_components <= tinystep.MAX_COMPONENTS:
        return f"the tinystep kernel takes K <= {tinystep.MAX_COMPONENTS}"
    return None


def make_runner(config, prior, *, lr: float, rho: float,
                aug_noise: float = 0.0, engine: str = "kernel") -> Callable:
    """Chunk runner ``runner(state, x, t_steps, seed, eps=None,
    aug_eps=None) → (state, metrics)``: T full-batch steps per call.

    ``engine="kernel"`` goes through ``tinystep.train_chunk`` (the CUDA
    kernel on CUDA tensors, its plain version on CPU tensors);
    ``engine="plain"`` runs ``tinystep.train_chunk_plain`` on any device.
    Metrics are (T,) tensors: recon, local_kl, global_kl, elbo, rho. The
    global KL is evaluated once, at the post-chunk naturals, and
    broadcast, so ``elbo`` is exact on the last row and one chunk stale
    in its global term on earlier rows.
    """
    if engine not in ("kernel", "plain"):
        raise ValueError(f"unknown engine {engine!r} (kernel|plain)")
    chunk = tinystep.train_chunk if engine == "kernel" else tinystep.train_chunk_plain

    def finish(state, mets, t_steps):
        gkl = gmm.kl_global(state.pgm_nat, prior)
        mets = dict(mets)
        mets["global_kl"] = gkl.expand(t_steps)
        mets["elbo"] = mets["recon"] - mets["local_kl"] - mets["global_kl"]
        mets["rho"] = torch.full((t_steps,), rho, device=gkl.device)
        del mets["neg_loss"]
        return state, mets

    def runner(state, x, t_steps: int, seed: int = 0, eps=None, aug_eps=None):
        state, mets = chunk(
            state, prior, x, lr=lr, rho=rho, t_steps=t_steps, seed=seed,
            aug_noise=aug_noise, num_samples=config.num_samples, eps=eps,
            aug_eps=aug_eps,
        )
        return finish(state, mets, t_steps)

    return runner


def make_mixture_runner(prior, *, rho: float, dof: float = 0.0,
                        unroll: int = 1) -> Callable:
    """Chunk runner ``runner(state, x, t_steps) → (state, metrics)``: T
    full-batch GMM (dof = 0) or SMM steps per call through
    ``mixstep.train_chunk`` (the CUDA kernel on CUDA tensors, its plain
    version on CPU tensors).

    Metrics: the (T,) tensors local_evidence (exact per step), elbo =
    local_evidence − KL_global at the POST-chunk naturals (the per-step
    engine logs its KL at each step's pre-update naturals; the two agree on
    the last row's global term at convergence) and rho, and the int
    ``unroll``, the U the chunk ran with. ``unroll`` must be in
    ``mixstep.UNROLLS`` and divide every chunk's T: anything else raises.
    """
    mixstep.check_unroll(unroll)

    def runner(state, x, t_steps: int):
        state, mets = mixstep.train_chunk(state, prior, x, rho=rho, t_steps=t_steps,
                                          dof=dof, unroll=unroll)
        gkl = gmm.kl_global(state.nat, prior)
        local = mets["local_evidence"]
        return state, {
            "local_evidence": local,
            "elbo": local - gkl,
            "rho": torch.full((t_steps,), rho, device=local.device),
            "unroll": unroll,
        }

    return runner


def run_mixture(state, x, *, steps: int, eval_every: int, emit: Callable,
                step: Callable | None = None, runner: Callable | None = None):
    """Train a pure mixture for ``steps`` full-batch steps.

    With ``step`` (one step per call, the plain engine) ``emit(t, state,
    elbo)`` follows step 1 and every ``eval_every``-th step, ``elbo`` being
    that step's bound at its pre-update naturals; with ``runner`` (chunks
    of ``eval_every`` steps) it follows every chunk, with the chunk's last
    ``elbo``. Returns (state, seconds), timed to a device synchronise."""
    t0 = time.perf_counter()
    t = 0
    while t < steps:
        if runner is not None:
            todo = min(eval_every, steps - t)
            state, mets = runner(state, x, todo)
            t += todo
            emit(t, state, float(mets["elbo"][-1]))
        else:
            state, mets = step(state, x)
            t += 1
            if t % eval_every == 0 or t == 1:
                emit(t, state, float(mets["elbo"]))
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return state, time.perf_counter() - t0
