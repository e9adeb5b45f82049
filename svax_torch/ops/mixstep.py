"""Whole-train-step kernel for the pure mixtures: wrapper and plain version.

Port of ``svax/ops/mixstep_pallas.py``. ``train_chunk`` runs T complete
GMM (``dof = 0``) or Student-t-mixture (``dof > 0``) CVI steps — E-step,
statistics, CVI update — on the full batch of d = 2 data, with constant ρ,
in ONE launch of the CUDA kernel in ``csrc/mixstep.cu``.

* On CUDA tensors it launches the kernel, or raises; there is no fallback.
* On CPU tensors it runs ``train_chunk_plain``: T iterations of
  ``gmm_baseline.make_train_step`` or ``smm_baseline.make_train_step``.

``unroll`` = U ∈ {1, 2, 4, 8} steps per loop trip inside the kernel. U
must divide T: a request outside the set or that does not divide T
raises (nothing is clamped). The step math is the same at every U.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from svax_torch.models import gmm_baseline, smm_baseline
from svax_torch.ops.tinystep import pack_nat, unpack_nat
from svax_torch.pgm import smm
from svax_torch.pgm.gmm import GmmNat

UNROLLS = (1, 2, 4, 8)
# The kernel's built limits (csrc/mixstep.cu): x and the per-point
# logsumexps stay in one block's shared memory.
MAX_POINTS = 16384
MAX_COMPONENTS = 64

launches = 0  # kernel launches made by train_chunk (plain int)


def check_unroll(unroll: int, *t_steps: int) -> None:
    """Raise unless U is one the kernel is built for and divides every
    chunk length T given."""
    if unroll not in UNROLLS:
        raise ValueError(f"unroll {unroll} is not one of {UNROLLS}")
    for t in t_steps:
        if t % unroll:
            raise ValueError(f"unroll {unroll} does not divide a chunk of {t} steps")


def unsupported_reason(*, data_dim: int, batch_full: bool, rho, num_points: int,
                       num_components: int, data_parallel: bool = False) -> str | None:
    """The gate: why the kernel cannot run this workload (None = it can);
    as the reference's (svax/train/loop.py:327-345), it is single-device."""
    if data_parallel:
        return "the mixstep kernel is single-device (no data sharding)"
    if data_dim != 2:
        return f"the mixstep kernel takes 2-D data (got d = {data_dim})"
    if not batch_full:
        return "the mixstep kernel trains on the full batch only"
    if callable(rho):
        return "the mixstep kernel needs a constant rho"
    if not 1 <= num_points <= MAX_POINTS:
        return f"N = {num_points} outside the kernel's 1..{MAX_POINTS}"
    if not 1 <= num_components <= MAX_COMPONENTS:
        return f"K = {num_components} outside the kernel's 1..{MAX_COMPONENTS}"
    return None


def _make_step(prior: GmmNat, rho: float, num_total: int, dof: float) -> Callable:
    if dof > 0.0:
        return smm_baseline.make_train_step(prior, rho, num_total, dof=dof)
    return gmm_baseline.make_train_step(prior, rho, num_total)


def train_chunk_plain(state, prior: GmmNat, x: torch.Tensor, *, rho: float,
                      t_steps: int, num_total: int | None = None,
                      dof: float = 0.0, unroll: int = 1):
    """T iterations of the GMM (dof = 0) or SMM step in plain PyTorch.

    Returns (state, {"local_evidence": (T,)}); ``unroll`` is checked as
    the kernel checks it and changes nothing else."""
    check_unroll(unroll, t_steps)
    step = _make_step(prior, rho, x.shape[0] if num_total is None else num_total, dof)
    evidence = []
    for _ in range(t_steps):
        state, mets = step(state, x)
        evidence.append(mets["local_evidence"])
    return state, {"local_evidence": torch.stack(evidence)}


def train_chunk(state, prior: GmmNat, x: torch.Tensor, *, rho: float, t_steps: int,
                num_total: int | None = None, dof: float = 0.0, unroll: int = 1):
    """Run T complete mixture CVI steps; returns (state, {"local_evidence":
    (T,)}), where ``state`` is a GmmTrainState or SmmTrainState (anything
    with ``nat``, ``step`` and ``_replace``).

    Semantics of T iterations of ``gmm_baseline.make_train_step(prior, rho,
    num_total)`` (dof = 0) or ``smm_baseline.make_train_step(...,
    dof=dof)`` on the full batch, with scale = num_total / N. The ELBO
    needs the global KL, added outside (``loop.make_mixture_runner``).

    CUDA tensors: one launch of the CUDA kernel; float32, contiguous, one
    device, the kernel's shape class — anything else raises. The returned
    naturals are views of a fresh packed buffer; the input state is not
    modified. CPU tensors: ``train_chunk_plain``.
    """
    global launches
    if x.device.type == "cpu":
        return train_chunk_plain(state, prior, x, rho=rho, t_steps=t_steps,
                                 num_total=num_total, dof=dof, unroll=unroll)
    if x.device.type != "cuda":
        raise ValueError(f"mixstep.train_chunk: no kernel for device {x.device}")
    check_unroll(unroll, t_steps)
    n = x.shape[0]
    k = prior.dir_nat.shape[0]
    reason = unsupported_reason(data_dim=x.shape[-1] if x.ndim == 2 else -1,
                                batch_full=True, rho=rho, num_points=n,
                                num_components=k)
    if reason is not None:
        raise ValueError(f"mixstep.train_chunk: {reason}")
    tensors = [x, prior.dir_nat, *prior.niw_nat, state.nat.dir_nat, *state.nat.niw_nat]
    for t in tensors:
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError("mixstep.train_chunk: every tensor must be float32 on "
                             f"{x.device} (got {t.dtype} on {t.device})")
    if not x.is_contiguous():
        raise ValueError("mixstep.train_chunk: x must be contiguous")
    if tuple(state.nat.dir_nat.shape) != (k,):
        raise ValueError("mixstep.train_chunk: the state and the prior differ in K")

    from svax_torch.ops import _build

    lib = _build.load()
    num_total = n if num_total is None else num_total
    nat = pack_nat(state.nat)
    prior_b = pack_nat(prior)
    metrics = torch.empty((t_steps,), device=x.device, dtype=torch.float32)
    smm_const = smm.log_rho_constant(dof, 2) if dof > 0.0 else 0.0
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.mixstep_train_chunk(
            ptr(x), n, k, ptr(prior_b), ptr(nat), ptr(metrics), t_steps,
            float(rho), float(num_total) / float(n), float(dof), smm_const,
            unroll, ctypes.c_void_p(stream))
    _build.check(lib, err, "mixstep_train_chunk")
    launches += 1
    return (state._replace(nat=unpack_nat(nat), step=state.step + t_steps),
            {"local_evidence": metrics})
