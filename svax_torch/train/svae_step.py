"""One SVAE train step: Adam on the NN params + CVI on the PGM naturals
(``svax/train/svae_step.py``), on one process or sharded over data and
mixture components (``parallel.mesh``).

Adam is a plain function over (param, m, v, count) with optax.adam's
semantics (b1=0.9, b2=0.999, eps=1e-8, bias correction from the global
count), so ``AdamState`` maps one to one onto optax's ``ScaleByAdamState``
(svax_torch.convert). A ``weight_decay`` > 0 makes it optax.adamw's: the
decoupled term wd·p joins the Adam direction before the learning rate, on
every NN leaf and never on the PGM naturals.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from svax_torch.models import svae, svae_smm
from svax_torch.models.svae import SvaeConfig
from svax_torch.parallel import mesh
from svax_torch.pgm import gmm, natgrad
from svax_torch.pgm.gmm import GmmNat
from svax_torch.train import graph

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
    grads: dict, opt: AdamState, params: dict, lr: float, weight_decay: float = 0.0
) -> tuple[dict, AdamState]:
    """optax.adam(lr): moments, bias correction at count+1, then p − lr·m̂/(√v̂+ε);
    with ``weight_decay`` > 0 optax.adamw(lr, weight_decay):
    p − lr·(m̂/(√v̂+ε) + wd·p).

    The same elementwise operations, in the same order, as one ``_foreach``
    call per operation over all the leaves (a dozen kernels a step, not a
    hundred). The bias corrections are per-step scalars (``graph.divide``):
    Python floats, or table rows inside a graphed chunk."""
    count = opt.count + 1
    flat = lambda tree: [t for side in tree.values() for ly in side for t in ly.values()]  # noqa: E731
    g, m, v, p = flat(grads), flat(opt.mu), flat(opt.nu), flat(params)
    mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - B1), torch._foreach_mul(m, B1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, 1.0 - B2), g),
                            torch._foreach_mul(v, B2))
    step = graph.divide(mu, "adam_bias1", lambda c: 1.0 - B1**(c + 1), opt.count, p[0])
    denom = torch._foreach_add(torch._foreach_sqrt(graph.divide(
        nu, "adam_bias2", lambda c: 1.0 - B2**(c + 1), opt.count, p[0])), ADAM_EPS)
    step = torch._foreach_div(step, denom)
    if weight_decay > 0.0:  # optax.add_decayed_weights, before the lr
        step = torch._foreach_add(step, torch._foreach_mul(p, weight_decay))
    step = torch._foreach_mul(step, lr)
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


def model_for(config: SvaeConfig):
    """The SVAE-variant module for ``config``: ``models.svae_smm`` when
    ``config.dof`` > 0 (the Student-t mixture prior), else ``models.svae``
    (the reference entry's ``svae_mod_select``)."""
    return svae_smm if config.dof > 0.0 else svae


def make_train_step(
    config: SvaeConfig, prior: GmmNat, lr: float, rho: float | Callable,
    data_group=None, comp_group=None, weight_decay: float = 0.0,
) -> Callable:
    """Build step(state, batch, eps=None, generator=None, seed=None) →
    (state, metrics).

    The model is ``model_for(config)``: with ``config.dof`` > 0 the
    Student-t prior's ``svae_smm.forward`` and its ``stats_to_nat`` (the
    ``counts ≠ u_counts`` split), else ``svae.forward`` and
    ``gmm.stats_to_nat``.

    The noise is ``eps`` when given, else drawn from ``generator`` — or,
    with ``config.fused_combine`` and ``kernel_rng``, inside the combine
    kernel from Philox keyed ``seed`` on stream ``state.step`` (no host
    sync); ``seed`` may be the combine's device word {seed, step}
    (``combine.key_word``), which a graphed runner passes. The per-step
    scalars (Adam's bias corrections, a scheduled ρ_t) come from
    ``graph.scalar``. Adam first (AdamW with ``weight_decay`` > 0, the reference entry's
    ``optax.adamw(lr, weight_decay=wd)``), from the gradient of
    −ELBO/num_total; then CVI from the sufficient statistics of the
    pre-update naturals. ``rho`` is a float or
    a schedule ``rho(step)`` evaluated at the pre-update ``state.step``
    (``rho_schedule`` builds the Trainer's inverse decay); the ``rho``
    metric reports the value used.

    Sharded (``parallel.mesh``; svax/train/svae_step.py:64-160): with
    ``data_group`` the batch is this rank's shard, and the ELBO in the loss
    is divided by the data size so that the gradients summed over the group
    are the full batch's; with ``comp_group``, ``prior`` and the naturals
    are this rank's K-shard and the forward reduces over the group inside
    the loss. The NN gradients are SUM-reduced over every sharded axis and
    divided by the comp size (the forward's psum makes every comp rank's
    loss the global one, so the summed gradient is comp-size times the
    true one); the statistics are divided by the data size and summed over
    the data group, as are the loss, recon and local metrics. The CVI
    update is then K-local. The state's NN params and Adam moments are
    replicated; each rank holds its own K-shard of the naturals."""
    model = model_for(config)
    stats_to_nat = getattr(model, "stats_to_nat", gmm.stats_to_nat)
    ndata = mesh.size(data_group)
    ncomp = mesh.size(comp_group)

    def step(state: SvaeTrainState, batch: torch.Tensor,
             eps: torch.Tensor | None = None,
             generator: torch.Generator | None = None, seed: int | None = None):
        params = map_params(
            lambda p: p.detach().requires_grad_(True), state.nn_params
        )
        out = model.forward(
            params, state.pgm_nat, prior, batch, config, eps=eps,
            generator=generator, seed=seed, step=state.step, comp_group=comp_group,
        )
        loss = -out.elbo / (ndata * config.num_total)
        leaves = [t for side in params.values() for ly in side for t in ly.values()]
        grads_flat = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for group in (data_group, comp_group):
                grads_flat = mesh.psum_tensors(grads_flat, group)
            if comp_group is not None:
                grads_flat = [g / ncomp for g in grads_flat]
            it = iter(grads_flat)
            grads = map_params(lambda _: next(it), params)
            nn_params, opt_state = adam_update(
                grads, state.opt_state, state.nn_params, lr, weight_decay
            )
            shares = [t.detach() if ndata == 1 else t.detach() / ndata
                      for t in (*out.suff_stats, out.recon, out.local_kl)]
            *fields, recon, local, loss_sum = mesh.psum_tensors(
                shares + [loss.detach()], data_group)
            stats = type(out.suff_stats)(*fields)
            inc = stats_to_nat(stats)
            rho_t, keep = graph.step_size(rho, state.step, state.pgm_nat.dir_nat)
            pgm_nat = natgrad.cvi_update(state.pgm_nat, prior, inc, rho_t, keep)
            rho_m = graph.scalar("rho", lambda s: float(rho(s)), state.step,
                                 loss) if callable(rho) else rho_t
        metrics = {
            "elbo": -loss_sum * config.num_total,
            "recon": recon,
            "local_kl": local,
            "global_kl": out.global_kl.detach(),
            "neg_loss": -(recon - local) / config.num_total,
            # A fill on the device: a tensor copied from the host would sync.
            "rho": rho_m if torch.is_tensor(rho_m) else torch.full(
                (), rho_m, dtype=loss.dtype, device=loss.device),
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
    noise as the train step does, through ``model_for(config).forward``."""
    model = model_for(config)

    @torch.no_grad()
    def evaluate(state: SvaeTrainState, x: torch.Tensor,
                 eps: torch.Tensor | None = None,
                 generator: torch.Generator | None = None, seed: int | None = None):
        cfg = config._replace(num_total=x.shape[0])
        out = model.forward(
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
