"""Fused GMM E-step and sufficient statistics: wrapper and plain version.

Port of ``svax/ops/estep_pallas.py``. With the packed coefficients

    W[:, k] = [ E[logπ_k] + ½E[log|Λ_k|] − ½E[μᵀΛμ]_k − (d/2)log 2π,
                E[Λμ]_k,
                −½ vec(E[Λ_k]) ]

the log responsibilities are the product log ρ = Φ(x) W with
Φ(x) = [1, x, vec(xxᵀ)] (N, F), F = 1 + d + d², and the statistics are
S = Φᵀ R with R = softmax_k(log ρ): S[0] = counts, S[1:1+d] = Σ r x,
S[1+d:] = Σ r vec(xxᵀ).

* On CUDA tensors ``e_step_stats_fused`` launches the CUDA kernel in
  ``csrc/estep.cu`` (both products in the kernel's body), or raises;
  there is no fallback.
* On CPU tensors it runs ``e_step_stats_reference``, the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from svax_torch.pgm.gmm import GmmExpected, GmmSuffStats

_LOG_2PI = math.log(2.0 * math.pi)

# The kernel's built limits (csrc/estep.cu): F = 1 + d + d² ≤ 111.
MAX_DIM = 10
MAX_COMPONENTS = 128

launches = 0  # kernel launches made by stats_kernel (plain int)


def pack_coeffs(exp: GmmExpected, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Pack expected params into the (F, K) coefficient matrix W."""
    k, d = exp.prec_mean.shape
    c0 = exp.log_pi + 0.5 * exp.logdet - 0.5 * exp.quad - 0.5 * d * _LOG_2PI
    w = torch.cat([c0[None, :], exp.prec_mean.T,
                   -0.5 * exp.prec.reshape(k, d * d).T], dim=0)
    return w if dtype is None else w.to(dtype)


def _features(x: torch.Tensor) -> torch.Tensor:
    """Φ(x) = [1, x, vec(xxᵀ)] along the trailing axis."""
    n, d = x.shape
    outer = (x[:, :, None] * x[:, None, :]).reshape(n, d * d)
    return torch.cat([torch.ones((n, 1), dtype=x.dtype, device=x.device), x, outer], dim=-1)


def unpack_stats(stats: torch.Tensor, d: int) -> GmmSuffStats:
    """(F, K) accumulated Φᵀ R → GmmSuffStats, scatter symmetrised."""
    scatter = stats[1 + d:].T.reshape(-1, d, d)
    return GmmSuffStats(counts=stats[0], mean_stat=stats[1:1 + d].T,
                        scatter_stat=0.5 * (scatter + scatter.mT))


def _scaled(stats: GmmSuffStats, scale: float) -> GmmSuffStats:
    return GmmSuffStats(*(scale * s for s in stats))


def e_step_stats_reference(x: torch.Tensor, exp: GmmExpected,
                           scale: float = 1.0) -> tuple[GmmSuffStats, torch.Tensor]:
    """The plain version: (statistics × scale, per-point evidence (N,))."""
    phi = _features(x)
    logits = phi @ pack_coeffs(exp, dtype=x.dtype)
    evidence = torch.logsumexp(logits, dim=-1)
    resp = torch.exp(logits - evidence[:, None])
    return _scaled(unpack_stats(phi.T @ resp, x.shape[-1]), scale), evidence


def unsupported_reason(x: torch.Tensor, exp: GmmExpected) -> str | None:
    """Why the CUDA kernel cannot take these inputs (None = it can)."""
    if x.ndim != 2 or x.shape[0] < 1:
        return f"x must be (N, d) with N >= 1 (got {tuple(x.shape)})"
    n, d = x.shape
    k = exp.log_pi.shape[0]
    if not 1 <= d <= MAX_DIM:
        return f"d = {d} outside the kernel's 1..{MAX_DIM}"
    if not 1 <= k <= MAX_COMPONENTS:
        return f"K = {k} outside the kernel's 1..{MAX_COMPONENTS}"
    if tuple(exp.prec_mean.shape) != (k, d):
        return f"expected params are for d = {exp.prec_mean.shape[1]}, x has d = {d}"
    if x.dtype != torch.float32:
        return f"the kernel takes float32 x (got {x.dtype})"
    if not x.is_contiguous():
        return "x must be contiguous"
    return None


def stats_kernel(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One call of the CUDA kernel (its tile pass and its ordered reduction
    of the per-block partial sums) on the current stream: x (N, d) and W
    (F, K), both float32, contiguous, on one CUDA device → (Φᵀ R (F, K),
    evidence (N,)). The caller checks the shapes (``unsupported_reason``)."""
    global launches
    from svax_torch.ops import _build

    lib = _build.load()
    n, d = x.shape
    f, k = w.shape
    kw = dict(device=x.device, dtype=torch.float32)
    partial = torch.empty(lib.estep_blocks(n) * f * k, **kw)
    stats = torch.empty((f, k), **kw)
    evidence = torch.empty((n,), **kw)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.estep_stats(ptr(x), n, d, k, ptr(w), ptr(partial), ptr(stats),
                              ptr(evidence), ctypes.c_void_p(stream))
    _build.check(lib, err, "estep_stats")
    launches += 1
    return stats, evidence


def e_step_stats_fused(x: torch.Tensor, exp: GmmExpected,
                       scale: float = 1.0) -> tuple[GmmSuffStats, torch.Tensor]:
    """Fused E-step and statistics; the same contract as the plain version.

    CUDA tensors: W is packed here in float32, then one ``stats_kernel``
    call. CPU tensors: ``e_step_stats_reference``.
    """
    if x.device.type == "cpu":
        return e_step_stats_reference(x, exp, scale)
    if x.device.type != "cuda":
        raise ValueError(f"estep.e_step_stats_fused: no kernel for device {x.device}")
    reason = unsupported_reason(x, exp)
    if reason is not None:
        raise ValueError(f"estep.e_step_stats_fused: {reason}")
    if any(t.device != x.device for t in exp):
        raise ValueError("estep.e_step_stats_fused: x and the expected params "
                         "must be on one device")
    stats, evidence = stats_kernel(x, pack_coeffs(exp, dtype=torch.float32).contiguous())
    return _scaled(unpack_stats(stats, x.shape[1]), scale), evidence
