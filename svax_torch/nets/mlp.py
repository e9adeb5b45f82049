"""MLP constructors and likelihood heads (``svax/nets/mlp.py``, the subset
the Gaussian SVAE uses).

An MLP is a list of ``{"w": (in, out), "b": (out,)}`` dicts — the JAX
package's layout, so converted state lines up one to one — with tanh
hidden layers and a linear final layer. The encoder's diagonal head and
the Gaussian decoder's variance both use softplus plus a 1e-6 floor.
Products run in the tensors' own dtype; callers keep TF32 off.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

_LOG_2PI = math.log(2.0 * math.pi)
_VAR_FLOOR = 1e-6


def mlp_init(
    generator: torch.Generator,
    sizes: Sequence[int],
    *,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
    scale: float = 1.0,
) -> list[dict]:
    """Glorot-normal init for layer sizes [in, h1, ..., out]."""
    params = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        std = scale * math.sqrt(2.0 / (n_in + n_out))
        w = torch.randn(
            (n_in, n_out), generator=generator, device=device, dtype=dtype
        )
        params.append(
            {"w": std * w, "b": torch.zeros((n_out,), device=device, dtype=dtype)}
        )
    return params


def mlp_apply(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    """tanh hidden layers, linear final layer."""
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.tanh(h)
    return h


def encoder_apply(
    params: list[dict], x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, D) → diagonal Gaussian natural potential (h, P), each (N, d):
    P = 1/(softplus(raw) + floor), h = mean · P."""
    out = mlp_apply(params, x)
    mean, raw = torch.chunk(out, 2, dim=-1)
    p = 1.0 / (F.softplus(raw) + _VAR_FLOOR)
    return mean * p, p


def decoder_apply(
    params: list[dict], z: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """z (..., d) → Gaussian likelihood params (mean, var), each (..., D)."""
    out = mlp_apply(params, z)
    mean, raw = torch.chunk(out, 2, dim=-1)
    return mean, F.softplus(raw) + _VAR_FLOOR


def gaussian_loglik(
    x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor
) -> torch.Tensor:
    """Σ_D log N(x | mean, var), diagonal; broadcasts x against mean/var."""
    return -0.5 * (torch.log(var) + (x - mean) ** 2 / var + _LOG_2PI).sum(dim=-1)
