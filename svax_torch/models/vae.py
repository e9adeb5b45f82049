"""Plain VAE baseline (``svax/models/vae.py``): the comparison's second
model. The SVAE's encoder and decoder nets, an N(0, I) latent prior, the
reparameterised ELBO, and Adam on everything.

The nets run at "highest" (f32 products), as the reference's calls
default to; ``activation`` is a name (``nets.mlp.ACTIVATIONS``), as in
``SvaeConfig``. The Bernoulli head scores with ``nets.log_likelihood``,
the broadcast form, as the reference does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from svax_torch.nets import mlp as nets
from svax_torch.parallel import mesh
from svax_torch.train import svae_step
from svax_torch.train.svae_step import AdamState, map_params


class VaeConfig(NamedTuple):
    latent_dim: int
    num_samples: int = 1
    likelihood: str = "gaussian"
    activation: str = "tanh"


class VaeTrainState(NamedTuple):
    params: dict
    opt_state: AdamState
    step: int


def init_params(generator: torch.Generator, input_dim: int, config: VaeConfig,
                encoder_hidden=(50, 50), decoder_hidden=(50, 50), *,
                device: torch.device | str = "cpu",
                dtype: torch.dtype = torch.float32) -> dict:
    """Encoder (input → 2d) and decoder (d → 2·input, or input logits), from
    ``generator`` (on ``device``) in that order."""
    kw = dict(device=device, dtype=dtype)
    d = config.latent_dim
    return {
        "encoder": nets.encoder_init(generator, input_dim, encoder_hidden, d, **kw),
        "decoder": nets.decoder_init(generator, d, decoder_hidden, input_dim,
                                     config.likelihood, **kw),
    }


def init_state(generator: torch.Generator, input_dim: int, config: VaeConfig,
               encoder_hidden=(50, 50), decoder_hidden=(50, 50), *,
               device: torch.device | str = "cpu",
               dtype: torch.dtype = torch.float32) -> VaeTrainState:
    """Random params, zero Adam moments, step 0."""
    params = init_params(generator, input_dim, config, encoder_hidden, decoder_hidden,
                         device=device, dtype=dtype)
    return VaeTrainState(params=params, opt_state=svae_step.adam_init(params), step=0)


def posterior(params: dict, x: torch.Tensor, config: VaeConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """q(z|x)'s mean and variance (N, d) from the encoder's potential."""
    pot_h, pot_p = nets.encoder_apply(params["encoder"], x, config.activation)
    var = 1.0 / pot_p
    return pot_h * var, var


def elbo(params: dict, x: torch.Tensor, generator: torch.Generator | None,
         config: VaeConfig, eps: torch.Tensor | None = None):
    """Per-batch mean ELBO: E_q[log p(x|z)] − KL(q(z|x) ‖ N(0, I)); returns
    (value, {"recon", "kl"}). ε (S, N, d) is ``eps`` when given, else drawn
    from ``generator``."""
    mean, var = posterior(params, x, config)
    if eps is None:
        eps = torch.randn((config.num_samples,) + tuple(mean.shape), generator=generator,
                          device=mean.device, dtype=mean.dtype)
    z = mean[None] + torch.sqrt(var)[None] * eps
    loglik = nets.log_likelihood(params["decoder"], z, x[None], config.likelihood,
                                 config.activation)  # (S, N)
    recon = loglik.mean(dim=0)
    kl = 0.5 * (mean**2 + var - torch.log(var) - 1.0).sum(dim=-1)
    return (recon - kl).mean(), {"recon": recon.mean(), "kl": kl.mean()}


def make_train_step(config: VaeConfig, lr: float, data_group=None) -> Callable:
    """``step(state, batch, generator=None, eps=None) → (state, metrics)``:
    the gradient of −ELBO, then Adam (``svae_step.adam_update``, optax.adam's
    semantics). With ``data_group`` the batch is this rank's shard, and the
    gradients, the loss and the parts are averaged over the group (the
    reference's ``pmean``), so every rank takes the same update. Metrics:
    elbo_per_point, recon, kl."""
    ndata = mesh.size(data_group)

    def step(state: VaeTrainState, batch: torch.Tensor,
             generator: torch.Generator | None = None, eps: torch.Tensor | None = None):
        params = map_params(lambda p: p.detach().requires_grad_(True), state.params)
        value, parts = elbo(params, batch, generator, config, eps=eps)
        leaves = [t for side in params.values() for ly in side for t in ly.values()]
        grads_flat = torch.autograd.grad(-value, leaves)
        with torch.no_grad():
            scalars = [value.detach(), parts["recon"].detach(), parts["kl"].detach()]
            if data_group is not None:
                *grads_flat, v, r, k = [t / ndata for t in mesh.psum_tensors(
                    [*grads_flat, *scalars], data_group)]
                scalars = [v, r, k]
            it = iter(grads_flat)
            grads = map_params(lambda _: next(it), params)
            new_params, opt_state = svae_step.adam_update(grads, state.opt_state,
                                                          state.params, lr)
        metrics = dict(zip(("elbo_per_point", "recon", "kl"), scalars))
        return VaeTrainState(new_params, opt_state, state.step + 1), metrics

    return step
