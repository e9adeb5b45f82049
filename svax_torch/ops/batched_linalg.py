"""Unrolled small-d batched PSD linear algebra (``svax/ops/batched_linalg.py``).

Everything here operates on tensors whose trailing one or two axes are the
tiny latent dimension ``d`` and whose leading axes are a batch (K
components, or N×K posterior combines). For ``d <= UNROLL_MAX`` the
Cholesky factorization and the triangular solves are unrolled in Python
over ``d``, each scalar of the recurrence one elementwise op over the whole
batch; above it they defer to ``torch.linalg``. Gradients come from plain
autograd through the recurrences (the reference's custom VJPs exist only
for TPU fusion).
"""

from __future__ import annotations

import torch

# Above this dimension the unrolled recurrences defer to torch.linalg.
UNROLL_MAX = 16


def add_jitter(a: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Add ``eps * I`` to the trailing (d, d) axes (Cholesky safety)."""
    return a + eps * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)


def _cholesky_unrolled(a: torch.Tensor) -> torch.Tensor:
    """Cholesky–Banachiewicz unrolled over d; a: (..., d, d) PSD."""
    d = a.shape[-1]
    low = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - low[i][k] * low[j][k]
            if i == j:
                low[i][j] = torch.sqrt(s)
            else:
                low[i][j] = s / low[j][j]
    zero = torch.zeros_like(a[..., 0, 0])
    rows = [
        torch.stack([low[i][j] if j <= i else zero for j in range(d)], dim=-1)
        for i in range(d)
    ]
    return torch.stack(rows, dim=-2)


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky of PSD matrices with trailing (d, d) axes.

    Reads the lower triangle only; a non-PSD input gives NaN (no jitter)."""
    if a.shape[-1] <= UNROLL_MAX:
        return _cholesky_unrolled(a)
    return torch.linalg.cholesky(a)


def solve_tril_vec(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b with L lower-triangular (..., d, d), b (..., d)."""
    d = chol.shape[-1]
    if d > UNROLL_MAX:
        return torch.linalg.solve_triangular(
            chol, b.unsqueeze(-1), upper=False
        ).squeeze(-1)
    y: list = []
    for i in range(d):
        s = b[..., i]
        for k in range(i):
            s = s - chol[..., i, k] * y[k]
        y.append(s / chol[..., i, i])
    return torch.stack(y, dim=-1)


def solve_triu_vec(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve Lᵀ x = b with L lower-triangular (..., d, d), b (..., d)."""
    d = chol.shape[-1]
    if d > UNROLL_MAX:
        return torch.linalg.solve_triangular(
            chol.mT, b.unsqueeze(-1), upper=True
        ).squeeze(-1)
    x: list = [None] * d
    for i in reversed(range(d)):
        s = b[..., i]
        for k in range(i + 1, d):
            s = s - chol[..., k, i] * x[k]
        x[i] = s / chol[..., i, i]
    return torch.stack(x, dim=-1)


def cho_solve_vec(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given L = chol(A); b has shape (..., d)."""
    return solve_triu_vec(chol, solve_tril_vec(chol, b))


def inv_psd(chol: torch.Tensor) -> torch.Tensor:
    """Inverse of a PSD matrix from its Cholesky factor; (..., d, d)."""
    d = chol.shape[-1]
    eye = torch.eye(d, dtype=chol.dtype, device=chol.device).expand(chol.shape)
    cols = [cho_solve_vec(chol, eye[..., j]) for j in range(d)]
    return torch.stack(cols, dim=-1)


def logdet_from_chol(chol: torch.Tensor) -> torch.Tensor:
    """log|A| = 2 Σ log diag(L) for L = chol(A); returns (...)."""
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(dim=-1)
