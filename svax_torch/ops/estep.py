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
  ``csrc/estep.cu``, or raises; there is no fallback. The kernel works on
  the folded features Φ′ = [1, x, x_i x_j for i ≥ j] (F′ = 1 + d +
  d(d+1)/2), packs their coefficients W′ from the expected parameters
  itself, and writes the scaled statistics and the evidence: one launch a
  call, two where the per-block partials pass TICKET_FLOATS.
  ``folded_features``, ``fold_coeffs``, ``unfold_stats`` and ``plan`` mirror
  its layout, its packing and its block plan for the tests.
* On CPU tensors it runs ``e_step_stats_reference``, the plain version.
"""

from __future__ import annotations

import functools
import math

import torch

from svax_torch.pgm.gmm import GmmExpected, GmmSuffStats

_LOG_2PI = math.log(2.0 * math.pi)

# The kernel's built limits (csrc/estep.cu: kMaxD, kMaxK), its sub-tile of
# points (TN) and the partial floats its last block adds itself (kTicketFloats).
MAX_DIM = 10
MAX_COMPONENTS = 128
TILE_POINTS = 64
TICKET_FLOATS = 1 << 15
REDUCE_RUNS = 4  # the reduce launch adds the partials in this many ordered runs (kSegs)

launches = 0  # calls of the kernel made by stats_kernel (plain int)


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


# ------------------------------------------- mirrors of the kernel's layout


def tri_pairs(d: int) -> list[tuple[int, int]]:
    """The folded features' (i, j), j ≤ i, in the kernel's row order."""
    return [(i, j) for i in range(d) for j in range(i + 1)]


def folded_features(x: torch.Tensor) -> torch.Tensor:
    """Φ′(x) = [1, x, x_i x_j for i ≥ j] (N, F′), F′ = 1 + d + d(d+1)/2."""
    n, d = x.shape
    i, j = (torch.tensor(v, dtype=torch.long) for v in zip(*tri_pairs(d)))
    return torch.cat([torch.ones((n, 1), dtype=x.dtype, device=x.device), x,
                      x[:, i] * x[:, j]], dim=-1)


def fold_coeffs(exp: GmmExpected, dtype: torch.dtype | None = None) -> torch.Tensor:
    """W′ (F′, K) as the kernel packs it: pack_coeffs' rows, the row (i, j)
    of an off-diagonal pair the sum of its rows (i, j) and (j, i), in that
    order, so that Φ′W′ = ΦW."""
    w = pack_coeffs(exp, dtype)
    d = exp.prec_mean.shape[1]
    rows = [w[:1 + d]]
    for i, j in tri_pairs(d):
        row = w[1 + d + i * d + j]
        rows.append((row if i == j else row + w[1 + d + j * d + i])[None])
    return torch.cat(rows, dim=0)


def unfold_stats(stats: torch.Tensor, d: int) -> GmmSuffStats:
    """(F′, K) Φ′ᵀR → GmmSuffStats, each triangle entry written to (i, j)
    and (j, i) as the kernel writes it."""
    k = stats.shape[1]
    scatter = stats.new_zeros((k, d, d))
    for q, (i, j) in enumerate(tri_pairs(d)):
        scatter[:, i, j] = stats[1 + d + q]
        scatter[:, j, i] = stats[1 + d + q]
    return GmmSuffStats(counts=stats[0], mean_stat=stats[1:1 + d].T, scatter_stat=scatter)


def plan(n: int, capacity: int) -> tuple[int, int]:
    """(sub-tiles, blocks): ⌈N / TILE_POINTS⌉ sub-tiles dealt to at most
    ``capacity`` blocks (the card's SMs × blocks an SM)."""
    tiles = -(-n // TILE_POINTS)
    return tiles, min(tiles, capacity)


def run_begin(b: int, tiles: int, blocks: int) -> int:
    """Block b of ``blocks`` owns the sub-tiles [run_begin(b), run_begin(b + 1))."""
    return b * tiles // blocks


def launches_per_call(n: int, d: int, k: int, capacity: int) -> int:
    """Kernel launches of one call: the tile kernel, and the ordered reduce
    where several blocks' partials pass TICKET_FLOATS."""
    blocks = plan(n, capacity)[1]
    return 2 if blocks > 1 and blocks * (1 + d + d * (d + 1) // 2) * k > TICKET_FLOATS else 1


# ------------------------------------------------------------- the kernel


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


@functools.cache
def card_capacity(device_index: int, d: int, k: int) -> int:
    """Blocks of the tile kernel for d, K that the card ``device_index``
    holds at once (SMs × blocks an SM; the C entry's answer, kept)."""
    from svax_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(device_index):
        cap = lib.estep_capacity(d, k)
    if cap < 0:
        _build.check(lib, -cap, "estep_capacity")
    return cap


def stats_kernel(x: torch.Tensor, exp: GmmExpected,
                 scale: float = 1.0) -> tuple[GmmSuffStats, torch.Tensor]:
    """One call of the CUDA kernel on the current stream: x (N, d) float32
    contiguous and the expected parameters on x's CUDA device → (statistics
    × scale, evidence (N,)). The caller checks the shapes
    (``unsupported_reason``)."""
    global launches
    from svax_torch.ops import _build

    lib = _build.load()
    n, d = x.shape
    k = exp.log_pi.shape[0]
    fields = [t if t.dtype == torch.float32 and t.is_contiguous()
              else t.to(torch.float32).contiguous()
              for t in (exp.log_pi, exp.logdet, exp.quad, exp.prec_mean, exp.prec)]
    dev = x.device
    with torch.cuda.device(dev):
        blocks = plan(n, card_capacity(dev.index, d, k))[1]
        kd = k * d
        out = torch.empty(k + kd + kd * d + n, device=dev, dtype=torch.float32)
        partial = (torch.empty(blocks * (1 + d + d * (d + 1) // 2) * k, device=dev,
                               dtype=torch.float32) if blocks > 1 else None)
        base = out.data_ptr()
        err = lib.estep_stats(
            x.data_ptr(), n, d, k, *(t.data_ptr() for t in fields), scale, blocks,
            base, base + 4 * k, base + 4 * (k + kd), base + 4 * (k + kd + kd * d),
            None if partial is None else partial.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "estep_stats")
    launches += 1
    counts, mean, scatter, evidence = out.split_with_sizes((k, kd, kd * d, n))
    return GmmSuffStats(counts, mean.view(k, d), scatter.view(k, d, d)), evidence


def e_step_stats_fused(x: torch.Tensor, exp: GmmExpected,
                       scale: float = 1.0) -> tuple[GmmSuffStats, torch.Tensor]:
    """Fused E-step and statistics; the same contract as the plain version.

    CUDA tensors: one ``stats_kernel`` call. CPU tensors:
    ``e_step_stats_reference``.
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
    return stats_kernel(x, exp, scale)
