"""MLP constructors and likelihood heads (``svax/nets/mlp.py``, the
diagonal-head subset: Gaussian and Bernoulli decoders).

An MLP is a list of ``{"w": (in, out), "b": (out,)}`` dicts — the JAX
package's layout, so converted state lines up one to one — with tanh
hidden layers and a linear final layer. The encoder's diagonal head and
the Gaussian decoder's variance both use softplus plus a 1e-6 floor; the
Bernoulli decoder emits D logits. Products run in the tensors' own dtype;
callers keep TF32 and bf16 reduced-precision reductions off. Under
``compute_dtype=torch.bfloat16`` the Bernoulli decoder body runs in bf16
and every (n, k) reduction accumulates in f32, as the reference's
``preferred_element_type`` does (``bernoulli_loglik_decomposed``).
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


def decoder_init(generator: torch.Generator, latent_dim: int, hidden: Sequence[int],
                 output_dim: int, likelihood: str = "gaussian", *,
                 device: torch.device | str = "cpu",
                 dtype: torch.dtype = torch.float32) -> list[dict]:
    """Decoder MLP d → hidden → 2·D (Gaussian: mean, raw variance) or D
    (Bernoulli logits)."""
    mult = 2 if likelihood == "gaussian" else 1
    return mlp_init(generator, [latent_dim, *hidden, mult * output_dim],
                    device=device, dtype=dtype)


def decoder_apply(params: list[dict], z: torch.Tensor, likelihood: str = "gaussian"):
    """z (..., d) → likelihood params: (mean, var), each (..., D), or the
    (..., D) Bernoulli logits."""
    out = mlp_apply(params, z)
    if likelihood == "bernoulli":
        return out
    mean, raw = torch.chunk(out, 2, dim=-1)
    return mean, F.softplus(raw) + _VAR_FLOOR


def gaussian_loglik(
    x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor
) -> torch.Tensor:
    """Σ_D log N(x | mean, var), diagonal; broadcasts x against mean/var."""
    return -0.5 * (torch.log(var) + (x - mean) ** 2 / var + _LOG_2PI).sum(dim=-1)


def bernoulli_loglik(x: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Σ_D log Bernoulli(x | σ(logits)); x in [0, 1] (binarized or soft)."""
    return (x * F.logsigmoid(logits) + (1.0 - x) * F.logsigmoid(-logits)).sum(dim=-1)


def bernoulli_loglik_decomposed(params: list[dict], z: torch.Tensor, x: torch.Tensor,
                                compute_dtype: torch.dtype | None = None,
                                fused: bool = False) -> torch.Tensor:
    """Bernoulli log-lik as ll = ⟨x, o⟩ + Σ_D logσ(−o) (logσ(o) − logσ(−o) =
    o): the x-dependent part reduces to small products with the last layer's
    weights and the large logits term is x-free. z (..., N, K, d); x (N, D)
    unbroadcast. Returns (..., N, K).

    ``compute_dtype=torch.bfloat16`` runs the hidden activations and the
    logits in bf16 (operands rounded to bf16, products accumulated in f32
    and rounded to bf16 at each output, as an XLA bf16 dot does). The (n, k)
    reductions stay in f32: ⟨h, y⟩ and x·b are formed from the bf16-rounded
    operands upcast to f32 (a bf16 ``matmul`` would round its output to
    bf16), and the logσ(−o) row sum accumulates in f32. The result is f32.

    ``fused=True`` is the reference's x-free row-sum kernel
    (``svax/ops/decoder_pallas.py``), not ported yet (ROADMAP.md, kernel C):
    it raises."""
    if fused:
        raise NotImplementedError(
            "the fused Bernoulli row-sum kernel (svax/ops/decoder_pallas.py) is not "
            "ported to svax_torch yet (ROADMAP.md, kernel C)")
    out_dtype = z.dtype
    if compute_dtype is not None:
        z = z.to(compute_dtype)
        x = x.to(compute_dtype)
        params = [{name: t.to(compute_dtype) for name, t in ly.items()} for ly in params]
    acc = torch.float32 if compute_dtype is not None else x.dtype
    h = z
    for layer in params[:-1]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    last = params[-1]
    y = x @ last["w"].T  # (N, Dh), in the compute dtype
    c = x.to(acc) @ last["b"].to(acc)  # (N,)
    t = torch.einsum("...nkh,nh->...nk", h.to(acc), y.to(acc)) + c[:, None]
    o = h @ last["w"] + last["b"]
    rowsum = F.logsigmoid(-o).sum(dim=-1, dtype=acc)
    return (t + rowsum).to(out_dtype)


def log_likelihood(params: list[dict], z: torch.Tensor, x: torch.Tensor,
                   likelihood: str = "gaussian") -> torch.Tensor:
    """log p(x | z) under the configured head; broadcasts over sample axes."""
    if likelihood == "gaussian":
        mean, var = decoder_apply(params, z, likelihood)
        return gaussian_loglik(x, mean, var)
    return bernoulli_loglik(x, decoder_apply(params, z, likelihood))
