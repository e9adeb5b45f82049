"""Pure-GMM baseline trained by natural-gradient VMP
(``svax/models/gmm_baseline.py``, BASELINE config #2).

One step: E-step → scaled sufficient statistics → (a SUM all-reduce over
the data group) → CVI update.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from svax_torch.parallel import mesh
from svax_torch.pgm import gmm, natgrad
from svax_torch.pgm.gmm import GmmNat


class GmmTrainState(NamedTuple):
    nat: GmmNat
    step: int


def init_state(generator: torch.Generator | None, prior: GmmNat, data=None,
               pseudo_counts: float = 2.0, rows: torch.Tensor | None = None
               ) -> GmmTrainState:
    """``gmm.init_variational``'s naturals at step 0 (``rows`` injects the K
    data rows)."""
    nat = gmm.init_variational(generator, prior, data, pseudo_counts=pseudo_counts,
                               rows=rows)
    return GmmTrainState(nat=nat, step=0)


def make_train_step(prior: GmmNat, rho: float | Callable, num_total: int,
                    fused: bool = False, data_group=None) -> Callable:
    """The GMM CVI step ``step(state, batch) → (state, metrics)``.

    The batch's statistics are scaled by ``num_total / M`` (§9.5). With
    ``fused=True`` the E-step and statistics run through
    ``ops.estep.e_step_stats_fused`` (the CUDA kernel on CUDA tensors).
    Both ELBO terms are taken at the pre-update naturals, so ``elbo`` is
    the bound of the parameters the step consumed. With ``data_group``
    (``parallel.mesh``) the batch is this rank's shard, M is the global
    batch (the local one times the group's size), and the statistics and
    the local evidence are summed over the group (svax/models/
    gmm_baseline.py:35-71), so every rank takes the same update.
    """
    ndata = mesh.size(data_group)

    def step(state: GmmTrainState, batch: torch.Tensor):
        exp = gmm.expected_params(state.nat)
        scale = num_total / (batch.shape[0] * ndata)
        if fused:
            from svax_torch.ops import estep

            stats, evidence = estep.e_step_stats_fused(batch, exp, scale=scale)
        else:
            resp, evidence = gmm.e_step_obs(batch, exp)
            stats = gmm.suff_stats_obs(batch, resp, scale=scale)
        local = scale * evidence.sum()
        if data_group is not None:
            *fields, local = mesh.psum_tensors([*stats, local], data_group)
            stats = type(stats)(*fields)
        rho_t = rho(state.step) if callable(rho) else rho
        new_nat = natgrad.cvi_update(state.nat, prior, gmm.stats_to_nat(stats), rho_t)
        metrics = {
            "local_evidence": local,
            "elbo": local - gmm.kl_global(state.nat, prior),
            "rho": torch.tensor(rho_t, dtype=local.dtype, device=local.device),
        }
        return GmmTrainState(nat=new_nat, step=state.step + 1), metrics

    return step


def evaluate(nat: GmmNat, prior: GmmNat, x: torch.Tensor, num_total: int) -> dict:
    """Held-out per-point evidence and full ELBO at fixed naturals."""
    _, evidence = gmm.e_step_obs(x, gmm.expected_params(nat))
    elbo, parts = gmm.elbo_obs(x, nat, prior, scale=num_total / x.shape[0])
    return {"evidence_per_point": evidence.mean(), "elbo": elbo, **parts}
