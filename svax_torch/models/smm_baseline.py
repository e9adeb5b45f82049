"""Pure Student-t mixture baseline trained by natural-gradient VMP
(``svax/models/smm_baseline.py``).

Mirror of ``gmm_baseline`` for the heavy-tailed SMM (``pgm.smm``): one step
= scale-augmented E-step → u-weighted statistics → (a SUM all-reduce
over the data group) → CVI update. ``dof`` is
the Student-t degrees of freedom (u ~ Gamma(dof/2, dof/2)).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from svax_torch.parallel import mesh
from svax_torch.pgm import gmm, natgrad, smm
from svax_torch.pgm.gmm import GmmNat
from svax_torch.train import graph


class SmmTrainState(NamedTuple):
    nat: GmmNat
    step: int


def init_state(generator: torch.Generator, prior: GmmNat, data=None,
               pseudo_counts: float = 2.0) -> SmmTrainState:
    nat = gmm.init_variational(generator, prior, data, pseudo_counts=pseudo_counts)
    return SmmTrainState(nat=nat, step=0)


def make_train_step(prior: GmmNat, rho: float | Callable, num_total: int,
                    dof: float = 4.0, data_group=None) -> Callable:
    """The SMM CVI step; metrics as in ``gmm_baseline`` (both ELBO terms at
    the pre-update naturals), and ``data_group`` as there
    (svax/models/smm_baseline.py:35-48)."""
    ndata = mesh.size(data_group)

    def step(state: SmmTrainState, batch: torch.Tensor):
        exp = gmm.expected_params(state.nat)
        resp, e_u, evidence = smm.e_step_obs(batch, exp, dof)
        scale = num_total / (batch.shape[0] * ndata)
        stats = smm.suff_stats_obs(batch, resp, e_u, scale=scale)
        local = scale * evidence.sum()
        if data_group is not None:
            *fields, local = mesh.psum_tensors([*stats, local], data_group)
            stats = type(stats)(*fields)
        rho_t, keep = graph.step_size(rho, state.step, state.nat.dir_nat)
        new_nat = natgrad.cvi_update(state.nat, prior, smm.stats_to_nat(stats), rho_t, keep)
        rho_m = graph.scalar("rho", lambda s: float(rho(s)), state.step,
                             local) if callable(rho) else rho_t
        metrics = {
            "local_evidence": local,
            "elbo": local - gmm.kl_global(state.nat, prior),
            "rho": rho_m if torch.is_tensor(rho_m) else torch.full(
                (), rho_m, dtype=local.dtype, device=local.device),
        }
        return SmmTrainState(nat=new_nat, step=state.step + 1), metrics

    return step
