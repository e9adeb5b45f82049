"""Bernoulli-mixture baseline trained by natural-gradient VMP
(``svax/models/bmm_baseline.py``): the mnist row's third model.

One step, as ``gmm_baseline``'s: E-step → scaled sufficient statistics →
(a SUM all-reduce over the data group) → CVI update.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from svax_torch.parallel import mesh
from svax_torch.pgm import bmm, natgrad
from svax_torch.pgm.bmm import BmmNat


class BmmTrainState(NamedTuple):
    nat: BmmNat
    step: int


def init_state(generator: torch.Generator | None, prior: BmmNat, data=None,
               pseudo_counts: float = 2.0, rows: torch.Tensor | None = None
               ) -> BmmTrainState:
    """``bmm.init_variational``'s naturals at step 0 (``rows`` injects the K
    data rows)."""
    nat = bmm.init_variational(generator, prior, data, pseudo_counts=pseudo_counts,
                               rows=rows)
    return BmmTrainState(nat=nat, step=0)


def make_train_step(prior: BmmNat, rho: float | Callable, num_total: int,
                    data_group=None) -> Callable:
    """The Bernoulli-mixture CVI step ``step(state, batch) → (state,
    metrics)``, with ``gmm_baseline.make_train_step``'s contract: the
    batch's statistics scaled by num_total / M (M the global batch),
    summed with the local evidence over ``data_group``, and both ELBO terms
    taken at the pre-update naturals."""
    ndata = mesh.size(data_group)

    def step(state: BmmTrainState, batch: torch.Tensor):
        exp = bmm.expected_params(state.nat)
        scale = num_total / (batch.shape[0] * ndata)
        resp, evidence = bmm.e_step(batch, exp)
        stats = bmm.suff_stats(batch, resp, scale=scale)
        local = scale * evidence.sum()
        if data_group is not None:
            *fields, local = mesh.psum_tensors([*stats, local], data_group)
            stats = bmm.BmmSuffStats(*fields)
        rho_t = rho(state.step) if callable(rho) else rho
        new_nat = natgrad.cvi_update(state.nat, prior, bmm.stats_to_nat(stats), rho_t)
        metrics = {
            "local_evidence": local,
            "elbo": local - bmm.kl_global(state.nat, prior),
            "rho": torch.tensor(rho_t, dtype=local.dtype, device=local.device),
        }
        return BmmTrainState(nat=new_nat, step=state.step + 1), metrics

    return step


@torch.no_grad()
def evaluate(nat: BmmNat, prior: BmmNat, x: torch.Tensor, num_total: int) -> dict:
    """Held-out per-point evidence, exact predictive log-mass, and ELBO."""
    _, evidence = bmm.e_step(x, bmm.expected_params(nat))
    scale = num_total / x.shape[0]
    return {
        "evidence_per_point": evidence.mean(),
        "predictive_log_mass_per_point": bmm.predictive_log_prob(nat, x).mean(),
        "elbo": scale * evidence.sum() - bmm.kl_global(nat, prior),
    }
