"""One SVAE train step: Adam on the NN params + CVI on the PGM naturals
(``svax/train/svae_step.py``, single device).

Adam is a plain function over (param, m, v, count) with optax.adam's
semantics (b1=0.9, b2=0.999, eps=1e-8, bias correction from the global
count), so ``AdamState`` maps one to one onto optax's ``ScaleByAdamState``
(svax_torch.convert).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from svax_torch.models import svae
from svax_torch.models.svae import SvaeConfig
from svax_torch.pgm import gmm, natgrad
from svax_torch.pgm.gmm import GmmNat

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    count: int  # steps taken so far
    mu: dict  # first moments, the nn_params layout
    nu: dict  # second moments


class SvaeTrainState(NamedTuple):
    nn_params: dict
    opt_state: AdamState
    pgm_nat: GmmNat
    step: int


def map_params(fn: Callable, *trees: dict) -> dict:
    """Apply ``fn`` leaf-wise over matching {side: [{"w","b"}, ...]} trees."""
    return {
        side: [
            {name: fn(*(t[side][i][name] for t in trees)) for name in layer}
            for i, layer in enumerate(trees[0][side])
        ]
        for side in trees[0]
    }


def nat_to(nat: GmmNat, device=None, dtype=None) -> GmmNat:
    """Copy of a GmmNat on another device and/or dtype."""
    return GmmNat(nat.dir_nat.to(device=device, dtype=dtype),
                  type(nat.niw_nat)(*(t.to(device=device, dtype=dtype)
                                      for t in nat.niw_nat)))


def state_to(state: "SvaeTrainState", device=None, dtype=None) -> "SvaeTrainState":
    """Copy of a train state on another device and/or dtype."""
    move = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
    opt = state.opt_state
    return SvaeTrainState(
        nn_params=map_params(move, state.nn_params),
        opt_state=AdamState(opt.count, map_params(move, opt.mu),
                            map_params(move, opt.nu)),
        pgm_nat=nat_to(state.pgm_nat, device, dtype),
        step=state.step,
    )


def adam_init(params: dict) -> AdamState:
    zeros = map_params(torch.zeros_like, params)
    return AdamState(count=0, mu=zeros, nu=map_params(torch.zeros_like, params))


def adam_update(
    grads: dict, opt: AdamState, params: dict, lr: float
) -> tuple[dict, AdamState]:
    """optax.adam(lr): moments, bias correction at count+1, then p − lr·m̂/(√v̂+ε).

    The same elementwise operations, in the same order, as one ``_foreach``
    call per operation over all the leaves (a dozen kernels a step, not a
    hundred)."""
    count = opt.count + 1
    flat = lambda tree: [t for side in tree.values() for ly in side for t in ly.values()]  # noqa: E731
    g, m, v, p = flat(grads), flat(opt.mu), flat(opt.nu), flat(params)
    mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - B1), torch._foreach_mul(m, B1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, 1.0 - B2), g),
                            torch._foreach_mul(v, B2))
    bc1 = 1.0 - B1**count
    bc2 = 1.0 - B2**count
    step = torch._foreach_div(mu, bc1)
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), ADAM_EPS)
    step = torch._foreach_mul(torch._foreach_div(step, denom), lr)
    new = torch._foreach_sub(p, step)

    def tree(leaves):
        it = iter(leaves)
        return map_params(lambda _: next(it), params)

    return tree(new), AdamState(count=count, mu=tree(mu), nu=tree(nu))


def init_state(
    generator: torch.Generator,
    input_dim: int,
    config: SvaeConfig,
    prior: GmmNat,
    encoder_hidden=(50, 50),
    decoder_hidden=(50, 50),
    init_pseudo_counts: float = 2.0,
    data: torch.Tensor | None = None,
) -> SvaeTrainState:
    """Random NN params, zero Adam moments, and q's naturals at the prior
    plus pseudo-counts. Tensors land on the prior's device and dtype;
    ``generator`` must live on that device."""
    ref = prior.dir_nat
    nn_params = svae.init_params(
        generator, input_dim, config, encoder_hidden, decoder_hidden,
        device=ref.device, dtype=ref.dtype,
    )
    # Component locations live in latent space; data can seed them only
    # when the dimensions coincide.
    if data is not None and data.shape[-1] != config.latent_dim:
        data = None
    pgm_nat = gmm.init_variational(
        generator, prior, data, pseudo_counts=init_pseudo_counts
    )
    return SvaeTrainState(
        nn_params=nn_params, opt_state=adam_init(nn_params), pgm_nat=pgm_nat,
        step=0,
    )


def make_train_step(
    config: SvaeConfig, prior: GmmNat, lr: float, rho: float | Callable
) -> Callable:
    """Build step(state, batch, eps=None, generator=None, seed=None) →
    (state, metrics).

    The noise is ``eps`` when given, else drawn from ``generator`` — or,
    with ``config.fused_combine`` and ``kernel_rng``, inside the combine
    kernel from Philox keyed ``seed`` on stream ``state.step`` (no host
    sync). Adam first, from the gradient of −ELBO/num_total; then CVI from the
    sufficient statistics of the pre-update naturals. ``rho`` is a float or
    a schedule ``rho(step)`` evaluated at the pre-update ``state.step``
    (``rho_schedule`` builds the Trainer's inverse decay); the ``rho``
    metric reports the value used."""

    def step(state: SvaeTrainState, batch: torch.Tensor,
             eps: torch.Tensor | None = None,
             generator: torch.Generator | None = None, seed: int | None = None):
        params = map_params(
            lambda p: p.detach().requires_grad_(True), state.nn_params
        )
        out = svae.forward(
            params, state.pgm_nat, prior, batch, config, eps=eps,
            generator=generator, seed=seed, step=state.step,
        )
        loss = -out.elbo / config.num_total
        leaves = [t for side in params.values() for ly in side for t in ly.values()]
        grads_flat = torch.autograd.grad(loss, leaves)
        it = iter(grads_flat)
        grads = map_params(lambda _: next(it), params)
        with torch.no_grad():
            nn_params, opt_state = adam_update(
                grads, state.opt_state, state.nn_params, lr
            )
            inc = gmm.stats_to_nat(
                gmm.GmmSuffStats(*(s.detach() for s in out.suff_stats))
            )
            rho_t = float(rho(state.step)) if callable(rho) else float(rho)
            pgm_nat = natgrad.cvi_update(state.pgm_nat, prior, inc, rho_t)
        metrics = {
            "elbo": -loss.detach() * config.num_total,
            "recon": out.recon.detach(),
            "local_kl": out.local_kl.detach(),
            "global_kl": out.global_kl.detach(),
            "neg_loss": (-(out.recon - out.local_kl) / config.num_total).detach(),
            # A fill on the device: a tensor copied from the host would sync.
            "rho": torch.full((), rho_t, dtype=loss.dtype, device=loss.device),
        }
        new_state = SvaeTrainState(
            nn_params=nn_params, opt_state=opt_state, pgm_nat=pgm_nat,
            step=state.step + 1,
        )
        return new_state, metrics

    return step


def rho_schedule(rho0: float, decay: float = 0.0) -> float | Callable:
    """The Trainer's CVI step size (``svax/train/trainer.py: _rho_schedule``):
    the constant ρ₀ when ``decay`` is 0, else ρ_t = ρ₀/(1 + decay·t)."""
    if decay == 0.0:
        return rho0
    return lambda t: rho0 / (1.0 + decay * t)


def make_eval_fn(config: SvaeConfig, prior: GmmNat) -> Callable:
    """Held-out ELBO decomposition at fixed parameters (SURVEY.md §4.4);
    ``evaluate(state, x, eps=None, generator=None, seed=None)`` takes its
    noise as the train step does."""

    @torch.no_grad()
    def evaluate(state: SvaeTrainState, x: torch.Tensor,
                 eps: torch.Tensor | None = None,
                 generator: torch.Generator | None = None, seed: int | None = None):
        cfg = config._replace(num_total=x.shape[0])
        out = svae.forward(
            state.nn_params, state.pgm_nat, prior, x, cfg, eps=eps,
            generator=generator, seed=seed, step=state.step,
        )
        n = x.shape[0]
        return {
            "elbo_per_point": out.elbo / n,
            "recon_per_point": out.recon / n,
            "local_kl_per_point": out.local_kl / n,
            "global_kl": out.global_kl,
        }

    return evaluate
