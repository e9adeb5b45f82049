"""Training state between the JAX package (as numpy arrays) and the port.

The JAX package's ``SvaeTrainState`` holds ``nn_params`` (a list of
``{"w", "b"}`` per side), optax's Adam state in ``opt_state[0]`` (``count``,
``mu``, ``nu``), ``pgm_nat = GmmNat(dir_nat, NiwNat(eta1..eta4))`` and
``step``. ``state_from_numpy`` takes that structure with numpy leaves (for
example ``jax.tree.map(np.asarray, state)``; only attribute and index
access is used, so neither JAX nor optax is imported) and builds the
port's ``SvaeTrainState``. ``state_to_numpy`` goes back to a plain nested
dict of numpy arrays with the same field names. Layouts are identical on
both sides (the full recognition head's final width 2d + d(d−1)/2
included), so both directions are exact copies. ``mixture_state_from_numpy``
and ``mixture_state_to_numpy`` do the same for the pure mixtures'
``GmmTrainState``/``SmmTrainState`` (``nat``, ``step``).

Under component parallelism a rank holds a K-slice of the naturals (and of
the prior): ``shard_nat`` cuts rank i's contiguous slice of K, as the
reference's ``P("comp")`` places it, ``unshard_nat`` concatenates slices
in rank order, and ``gather_nat`` does that across a process group.
``bundle_from_numpy`` writes the JAX package's trained state as the port's
serving bundle.
"""

from __future__ import annotations

import numpy as np
import torch

from svax_torch.expfam.niw import NiwNat
from svax_torch.models.gmm_baseline import GmmTrainState
from svax_torch.parallel import mesh
from svax_torch.pgm.gmm import GmmNat
from svax_torch.train.svae_step import AdamState, SvaeTrainState


def _tensor(a, device, dtype):
    t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def _params_from(tree, device, dtype) -> dict:
    return {
        side: [{name: _tensor(ly[name], device, dtype) for name in ("w", "b")}
               for ly in tree[side]]
        for side in ("encoder", "decoder")
    }


def _params_to(tree: dict) -> dict:
    return {
        side: [{name: t.detach().cpu().numpy() for name, t in ly.items()}
               for ly in layers]
        for side, layers in tree.items()
    }


def gmm_nat_from_numpy(nat, *, device="cpu", dtype=None) -> GmmNat:
    """GmmNat with numpy leaves (attribute access) → the port's GmmNat."""
    niw = nat.niw_nat
    return GmmNat(
        dir_nat=_tensor(nat.dir_nat, device, dtype),
        niw_nat=NiwNat(*(_tensor(getattr(niw, f), device, dtype)
                         for f in ("eta1", "eta2", "eta3", "eta4"))),
    )


def gmm_nat_to_numpy(nat: GmmNat) -> dict:
    out = {"dir_nat": nat.dir_nat.detach().cpu().numpy()}
    for f in ("eta1", "eta2", "eta3", "eta4"):
        out[f] = getattr(nat.niw_nat, f).detach().cpu().numpy()
    return out


def state_from_numpy(state, *, device="cpu", dtype=None) -> SvaeTrainState:
    """The JAX package's SvaeTrainState with numpy leaves → the port's.

    ``dtype=None`` keeps each array's own float dtype."""
    adam = state.opt_state[0]
    return SvaeTrainState(
        nn_params=_params_from(state.nn_params, device, dtype),
        opt_state=AdamState(
            count=int(np.asarray(adam.count)),
            mu=_params_from(adam.mu, device, dtype),
            nu=_params_from(adam.nu, device, dtype),
        ),
        pgm_nat=gmm_nat_from_numpy(state.pgm_nat, device=device, dtype=dtype),
        step=int(np.asarray(state.step)),
    )


def state_to_numpy(state: SvaeTrainState) -> dict:
    """The port's state → {"nn_params", "adam": {"count", "mu", "nu"},
    "pgm_nat": {"dir_nat", "eta1".."eta4"}, "step"} of numpy arrays."""
    return {
        "nn_params": _params_to(state.nn_params),
        "adam": {
            "count": np.asarray(state.opt_state.count, np.int32),
            "mu": _params_to(state.opt_state.mu),
            "nu": _params_to(state.opt_state.nu),
        },
        "pgm_nat": gmm_nat_to_numpy(state.pgm_nat),
        "step": np.asarray(state.step, np.int32),
    }


def mixture_state_from_numpy(state, *, device="cpu", dtype=None, cls=GmmTrainState):
    """The JAX package's GmmTrainState or SmmTrainState with numpy leaves
    → the port's ``cls`` (GmmTrainState or SmmTrainState)."""
    return cls(nat=gmm_nat_from_numpy(state.nat, device=device, dtype=dtype),
               step=int(np.asarray(state.step)))


def mixture_state_to_numpy(state) -> dict:
    """The port's mixture state → {"nat": {"dir_nat", "eta1".."eta4"}, "step"}."""
    return {"nat": gmm_nat_to_numpy(state.nat), "step": np.asarray(state.step, np.int32)}


def _nat_leaves(nat: GmmNat) -> list[torch.Tensor]:
    return [nat.dir_nat, *nat.niw_nat]


def _nat_of(leaves) -> GmmNat:
    return GmmNat(dir_nat=leaves[0], niw_nat=NiwNat(*leaves[1:]))


def shard_nat(nat: GmmNat, index: int, count: int) -> GmmNat:
    """Rank ``index``'s slice of K out of ``count`` equal slices."""
    k = nat.dir_nat.shape[0]
    if k % count:
        raise ValueError(f"K = {k} does not split into {count} equal component shards")
    part = k // count
    return _nat_of([t[index * part:(index + 1) * part] for t in _nat_leaves(nat)])


def unshard_nat(shards: list[GmmNat]) -> GmmNat:
    """The full K from the slices in rank order."""
    return _nat_of([torch.cat(ts) for ts in zip(*(_nat_leaves(s) for s in shards))])


def gather_nat(nat: GmmNat, group) -> GmmNat:
    """Every rank's slice of ``group`` gathered into the full K, on every
    rank (``nat`` itself for None)."""
    return _nat_of(mesh.all_gather_rows(_nat_leaves(nat), group))


def bundle_from_numpy(directory, state_np, spec_dict: dict) -> None:
    """A serving bundle (``serve.save_bundle``) in ``directory`` from the JAX
    package's SvaeTrainState with numpy leaves (as ``state_from_numpy``
    takes it; float32, as the server runs) and its ``ModelSpec`` as a dict
    (``dataclasses.asdict`` or its ``spec.json``)."""
    from svax_torch import serve

    spec = dict(spec_dict)
    spec["encoder_hidden"] = tuple(spec["encoder_hidden"])
    spec["decoder_hidden"] = tuple(spec["decoder_hidden"])
    serve.save_bundle(directory, state_from_numpy(state_np, dtype=torch.float32),
                      serve.ModelSpec(**spec))
