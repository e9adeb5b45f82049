"""Whole-train-step kernel for the pure mixtures: wrapper and plain version.

Port of ``svax/ops/mixstep_pallas.py``. ``train_chunk`` runs T complete
GMM (``dof = 0``) or Student-t-mixture (``dof > 0``) CVI steps — E-step,
statistics, CVI update — on the full batch of d = 2 data, with constant ρ,
in ONE launch of the CUDA kernel in ``csrc/mixstep.cu``.

* On CUDA tensors it launches the kernel, or raises; there is no fallback.
* On CPU tensors it runs ``train_chunk_plain``: T iterations of
  ``gmm_baseline.make_train_step`` or ``smm_baseline.make_train_step``.
* ``train_chunk_mirror`` is the kernel's step in float32 in the kernel's
  own order, and ``stat_slots``, ``stat_slot``, ``point_owner``,
  ``component_lanes`` and ``smem_bytes`` its plan: the CPU tests hold them
  to the reference.

``unroll`` = U ∈ {1, 2, 4, 8} steps per loop trip inside the kernel. U
must divide T: a request outside the set or that does not divide T
raises (nothing is clamped). The step math is the same at every U.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable

import torch

from svax_torch.models import gmm_baseline, smm_baseline
from svax_torch.ops.tinystep import pack_nat, unpack_nat
from svax_torch.pgm import smm
from svax_torch.pgm.gmm import GmmNat

_LOG_2PI = math.log(2.0 * math.pi)

UNROLLS = (1, 2, 4, 8)
# The kernel's built limits (csrc/mixstep.cu): each thread's K log ρ and the
# warps' partials stay in one block's shared memory (smem_bytes).
MAX_POINTS = 16384
MAX_COMPONENTS = 64

launches = 0  # kernel launches made by train_chunk (plain int)

# ------------------------------------------------------- the kernel's plan
#
# A mirror of csrc/mixstep.cu's plan and arithmetic order, which the CPU
# tests hold to the reference: one block of THREADS threads; point n = j·
# THREADS + warp·32 + lane of batch j; each warp adds its points'
# statistics, 32 values (CPG components × C statistics) at a time, by a
# shuffle tree over its lanes (lanes differing in bit 4, then 3, …, 0),
# batch after batch into its own partial; the statistics are the WARPS
# partials added in warp order; component k is updated by the 8 lanes
# 8(k // WARPS)… of warp k % WARPS.

THREADS = 512
WARPS = THREADS // 32
COEFFS = 8  # log-ρ coefficients a component


def stat_slots(dof: float) -> tuple[int, int]:
    """(C, CPG): the statistics a component keeps in a warp partial — GMM
    [r, r·x₁, r·x₂, r·x₁², r·x₁x₂, r·x₂²], SMM [r, w·x₁, w·x₂, w, w·x₁²,
    w·x₁x₂, w·x₂²] — and the components a group of 32 values."""
    return (7, 4) if dof > 0.0 else (6, 5)


def stat_groups(k: int, dof: float) -> int:
    """G: the groups of 32 values a warp partial holds."""
    return -(-k // stat_slots(dof)[1])


def stat_slot(k: int, c: int, dof: float) -> int:
    """Component k's statistic c in a warp partial (G·32 floats)."""
    cs, cpg = stat_slots(dof)
    return (k // cpg) * 32 + (k % cpg) * cs + c


def point_owner(n: int) -> tuple[int, int, int]:
    """(batch, warp, lane) of point n."""
    return n // THREADS, (n % THREADS) // 32, n % 32


def component_lanes(k: int) -> tuple[int, range]:
    """(warp, lanes) that update component k."""
    return k % WARPS, range(8 * (k // WARPS), 8 * (k // WARPS) + 8)


def smem_bytes(k: int, dof: float) -> int:
    """The kernel's shared memory: the coefficients, the double-buffered
    naturals, the prior, the warp partials and evidence, and each thread's
    K log ρ."""
    return 4 * (k * (COEFFS + 27) + WARPS * stat_groups(k, dof) * 32 + WARPS + THREADS * k)


def _lane_tree(v: torch.Tensor) -> torch.Tensor:
    """Σ over a (…, 32, V) lane axis by the kernel's shuffle tree."""
    for half in (16, 8, 4, 2, 1):
        v = v.reshape(*v.shape[:-2], 2, half, v.shape[-1])
        v = v[..., 0, :, :] + v[..., 1, :, :]
    return v[..., 0, :]


def _digamma_f32(x: torch.Tensor) -> torch.Tensor:
    """csrc/mixstep.cu's digamma_mix in float32: the recurrence's Σ_i
    1/(x + i) as one fraction, the asymptotic series at x + 8."""
    num, den = torch.zeros_like(x), torch.ones_like(x)
    for i in range(8):
        xi = x + float(i)
        num = _fma(num, xi, den)
        den = den * xi
    y = x + 8.0
    inv = 1.0 / y
    inv2 = inv * inv
    return (torch.log(y) - 0.5 * inv
            - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0)) - num / den)


def _fma(a, b, c):
    """fmaf in float32 (the exact product and sum, rounded once)."""
    return (a.double() * b.double() + c.double()).float()


def _cvi(old, p0, delta, rho: float, scale: float):
    return (1.0 - torch.tensor(rho, dtype=torch.float32)) * old + rho * (p0 + scale * delta)


def _coefficients(nt: torch.Tensor, sum_alpha, smm_const: float, smm_flag: bool):
    """(K, COEFFS) log-ρ coefficients from the naturals (K, 9)."""
    alpha, kappa = nt[:, 0] + 1.0, nt[:, 3]
    inv_kappa = 1.0 / kappa
    m1, m2 = nt[:, 1] * inv_kappa, nt[:, 2] * inv_kappa
    phi11 = nt[:, 4] - kappa * m1 * m1
    phi12 = nt[:, 5] - kappa * m1 * m2
    phi22 = nt[:, 7] - kappa * m2 * m2
    nu = nt[:, 8] - 4.0
    det = phi11 * phi22 - phi12 * phi12
    inv_det = 1.0 / det
    i11, i12, i22 = phi22 * inv_det, -phi12 * inv_det, phi11 * inv_det
    pim1, pim2 = i11 * m1 + i12 * m2, i12 * m1 + i22 * m2
    e_logpi = _digamma_f32(alpha) - _digamma_f32(sum_alpha.expand_as(alpha))
    e_logdet = (_digamma_f32(nu / 2.0) + _digamma_f32((nu - 1.0) / 2.0) + 2.0 * math.log(2.0)
                - torch.log(det))
    base = e_logpi + 0.5 * e_logdet - _LOG_2PI
    if smm_flag:
        base = base + smm_const
    e_quad = 2.0 * inv_kappa + nu * (m1 * pim1 + m2 * pim2)
    return torch.stack([base, nu * i11, 2.0 * (nu * i12), nu * i22, -2.0 * (nu * pim1),
                        -2.0 * (nu * pim2), e_quad, torch.zeros_like(base)], dim=1)


def _sum_alpha(alpha: torch.Tensor) -> torch.Tensor:
    """Σ_k α_k as every warp forms it: lane l holds α_l (+ α_{l+32}; 0 past
    K), then the shuffle tree."""
    lanes = torch.zeros((2 * 32,), dtype=alpha.dtype)
    lanes[:alpha.shape[0]] = alpha
    per_lane = lanes[:32] + lanes[32:]
    return _lane_tree(per_lane[:, None])[0]


def train_chunk_mirror(state, prior: GmmNat, x: torch.Tensor, *, rho: float, t_steps: int,
                       num_total: int | None = None, dof: float = 0.0):
    """T steps of the GMM (dof = 0) or SMM step in float32 as the kernel
    takes them, in its order: per point its K log ρ once, their logsumexp
    and the weighted statistics; each warp's statistics by its shuffle
    tree, batch after batch; the warps' partials in warp order; the CVI
    update and the next log-ρ coefficients. CPU tensors; returns (state,
    {"local_evidence": (T,)}) as ``train_chunk``."""
    smm_flag = dof > 0.0
    n, k = x.shape[0], prior.dir_nat.shape[0]
    f32 = lambda t: t.detach().to(torch.float32).cpu()  # noqa: E731
    xs = f32(x)
    scale = float(n if num_total is None else num_total) / float(n)
    a0 = 0.5 * dof
    a = a0 + 1.0
    smm_const = smm.log_rho_constant(dof, 2) if smm_flag else 0.0
    pb = f32(pack_nat(prior))
    nat = f32(pack_nat(state.nat))
    c_count, cpg = stat_slots(dof)
    batches = -(-n // THREADS)
    pad = torch.zeros((batches * THREADS, 2))
    pad[:n] = xs
    valid = torch.arange(batches * THREADS) < n
    x1, x2 = pad[:, 0], pad[:, 1]
    xx11, xx12, xx22 = x1 * x1, x1 * x2, x2 * x2

    def coeffs_of(nt):
        return _coefficients(nt, _sum_alpha(nt[:, 0] + 1.0), smm_const, smm_flag)

    co = coeffs_of(nat)
    evidence = []
    for _ in range(t_steps):
        quad = _fma(co[None, :, 1], xx11[:, None], _fma(co[None, :, 2], xx12[:, None], _fma(
            co[None, :, 3], xx22[:, None], _fma(co[None, :, 4], x1[:, None], _fma(
                co[None, :, 5], x2[:, None], co[None, :, 6].expand(len(x1), k))))))
        b = a0 + 0.5 * quad
        lr = co[None, :, 0] - (a * torch.log(b) if smm_flag else 0.5 * quad)
        m = lr.max(dim=1).values
        e = torch.exp(lr - m[:, None])
        tot = e[:, 0]
        for c in range(1, k):
            tot = tot + e[:, c]
        lse = m + torch.log(tot)
        r = torch.where(valid[:, None], e * (1.0 / tot)[:, None], 0.0)
        w = r * (a / b) if smm_flag else r
        wx1, wx2 = w * x1[:, None], w * x2[:, None]
        cols = [r, wx1, wx2] + ([w] if smm_flag else []) + [wx1 * x1[:, None],
                                                             wx1 * x2[:, None], wx2 * x2[:, None]]
        vals = torch.stack(cols, dim=-1)  # (points, K, C)
        per_batch = _lane_tree(vals.reshape(batches, WARPS, 32, k * c_count))
        part = per_batch[0]
        for j in range(1, batches):
            part = part + per_batch[j]
        st = part[0]
        for wi in range(1, WARPS):
            st = st + part[wi]
        st = st.reshape(k, c_count)
        ev_lane = torch.where(valid, lse, 0.0).reshape(batches, WARPS, 32)
        acc = ev_lane[0]
        for j in range(1, batches):
            acc = acc + ev_lane[j]
        wev = _lane_tree(acc[..., None])[..., 0]
        tot_ev = wev[0]
        for wi in range(1, WARPS):
            tot_ev = tot_ev + wev[wi]
        evidence.append(scale * tot_ev)
        s7 = st if smm_flag else st[:, [0, 1, 2, 0, 3, 4, 5]]
        delta = s7[:, [0, 1, 2, 3, 4, 5, 5, 6, 0]]
        nat = _cvi(nat, pb, delta, rho, scale)
        co = coeffs_of(nat)
    new = unpack_nat(nat.to(x.device))
    return (state._replace(nat=new, step=state.step + t_steps),
            {"local_evidence": torch.stack(evidence).to(x.device)})


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
