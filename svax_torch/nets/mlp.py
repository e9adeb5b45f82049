"""MLP constructors and likelihood heads (``svax/nets/mlp.py``: the
diagonal and full encoder heads, Gaussian and Bernoulli decoders).

An MLP is a list of ``{"w": (in, out), "b": (out,)}`` dicts — the JAX
package's layout, so converted state lines up one to one — with hidden
layers of a named activation (``ACTIVATIONS``: tanh, relu, softplus; a
name, not a callable, so that configs and bundles stay plain data) and a
linear final layer. The encoder's heads and the Gaussian decoder's
variance use softplus plus a 1e-6 floor; the Bernoulli decoder emits D
logits. Under ``compute_dtype=torch.bfloat16`` the Bernoulli decoder body
runs in bf16 and every (n, k) reduction accumulates in f32, as the
reference's ``preferred_element_type`` does (``bernoulli_loglik_decomposed``).

The nn precision, the reference's ``jax.lax.Precision`` of the MLP
products, is a name here. TF32 stays off everywhere (the entries set it):
it keeps 10 mantissa bits, which is neither of the reference's modes.

====================  ===============================================
reference             this module's products (``dot``)
====================  ===============================================
HIGHEST ("highest")   f32
HIGH ("high")         f32 (bf16×3 is ~1e-7 relative of f32)
DEFAULT ("default")   bf16-rounded operands (round to nearest even),
                      f32 products and sums, forward and backward
====================  ===============================================

The whole-step kernels follow the same names (``ops.tinystep``,
``ops.flexstep``: "default" is their bf16-product mode, anything else
f32), and the Bernoulli row sum under ``fused`` maps "high" and "default"
to its bf16-operand mode and "highest" to f32, as the reference's
``_kernel_precision`` does (``ops.decoder``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

_LOG_2PI = math.log(2.0 * math.pi)
_VAR_FLOOR = 1e-6
ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu, "softplus": F.softplus}
PRECISIONS = ("highest", "high", "default")


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


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (round to nearest even) and back to its dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


class _Bf16Product(torch.autograd.Function):
    """y = round(a) @ round(b), f32 products and sums: a matmul at the
    reference's Precision.DEFAULT (one bf16 pass). The backward rounds the
    cotangent too before each transposed product, ā = round(ȳ)·round(b)ᵀ and
    b̄ = round(a)ᵀ·round(ȳ), as the transposed dots of the reference's
    ``jax.vjp`` do; autograd through casts would round the products'
    results instead. Operands broadcast as ``torch.matmul``'s (at least 2-D)."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = bf16_round(a), bf16_round(b)
        ctx.save_for_backward(ar, br)
        return ar @ br

    @staticmethod
    def backward(ctx, ybar):
        ar, br = ctx.saved_tensors
        yr = bf16_round(ybar)
        abar = bbar = None
        if ctx.needs_input_grad[0]:
            abar = (yr @ br.mT).sum_to_size(ar.shape)
        if ctx.needs_input_grad[1]:
            if br.ndim == 2:  # flatten the batch: no per-row (in, out) partials
                bbar = ar.reshape(-1, ar.shape[-1]).mT @ yr.reshape(-1, yr.shape[-1])
            else:
                bbar = (ar.mT @ yr).sum_to_size(br.shape)
        return abar, bbar


def dot(a: torch.Tensor, b: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """``a @ b`` at an nn precision (module docstring): "highest" and "high"
    in the operands' dtype, "default" on bf16-rounded operands with f32 sums
    (``_Bf16Product``). 1-D operands act as ``torch.matmul``'s."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    if precision != "default" or a.dtype == torch.bfloat16:
        return a @ b
    if b.ndim == 1:
        return _Bf16Product.apply(a, b[:, None])[..., 0]
    if a.ndim == 1:
        return _Bf16Product.apply(a[None], b)[..., 0, :]
    return _Bf16Product.apply(a, b)


def activation_fn(name: str):
    """The hidden-layer activation called ``name`` (tanh, relu, softplus)."""
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"activation {name!r}: one of {tuple(ACTIVATIONS)}") from None


def mlp_apply(params: list[dict], x: torch.Tensor, activation: str = "tanh",
              precision: str = "highest") -> torch.Tensor:
    """Hidden layers with ``activation``, linear final layer."""
    act = activation_fn(activation)
    h = x
    for i, layer in enumerate(params):
        h = dot(h, layer["w"], precision) + layer["b"]
        if i < len(params) - 1:
            h = act(h)
    return h


def encoder_out_dim(latent_dim: int, head: str = "diag") -> int:
    """Final-layer width for a recognition head: 2d (diag) or 2d + d(d−1)/2
    (full: mean, Cholesky diagonal, strict lower triangle)."""
    if head == "diag":
        return 2 * latent_dim
    if head == "full":
        return 2 * latent_dim + latent_dim * (latent_dim - 1) // 2
    raise ValueError(f"unknown encoder head {head!r} (diag|full)")


def _latent_dim_from_width(width: int, head: str) -> int:
    """Invert encoder_out_dim (both maps are strictly increasing in d)."""
    if head == "diag":
        d = width // 2
    else:  # w = d²/2 + 3d/2  →  d = (−3 + √(9 + 8w))/2
        d = int(round((-3.0 + (9.0 + 8.0 * width) ** 0.5) / 2.0))
    if encoder_out_dim(d, head) != width:
        raise ValueError(f"encoder final-layer width {width} is not a {head!r}-head width "
                         f"(expected {encoder_out_dim(d, head)} for d={d})")
    return d


def encoder_init(generator: torch.Generator, input_dim: int, hidden: Sequence[int],
                 latent_dim: int, head: str = "diag", *,
                 device: torch.device | str = "cpu",
                 dtype: torch.dtype = torch.float32) -> list[dict]:
    """Encoder MLP input → hidden → ``encoder_out_dim(latent_dim, head)``."""
    return mlp_init(generator, [input_dim, *hidden, encoder_out_dim(latent_dim, head)],
                    device=device, dtype=dtype)


def encoder_apply(params: list[dict], x: torch.Tensor, activation: str = "tanh",
                  precision: str = "highest", head: str = "diag"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, D) → Gaussian natural potential (h, P).

    ``head="diag"``: P is the (N, d) diagonal precision 1/(softplus(raw) +
    floor), h = mean · P. ``head="full"``: P = L·Lᵀ (N, d, d), L lower
    triangular with diagonal 1/√(softplus(raw) + floor) and its strict lower
    triangle from the last d(d−1)/2 outputs (numpy's ``tril_indices(d, −1)``
    order), h = P · mean; zero off-diagonal outputs give the diagonal head's
    P on the diagonal. The head's own products are f32 at every precision."""
    out = mlp_apply(params, x, activation, precision)
    if head == "diag":
        mean, raw = torch.chunk(out, 2, dim=-1)
        p = 1.0 / (F.softplus(raw) + _VAR_FLOOR)
        return mean * p, p
    d = _latent_dim_from_width(out.shape[-1], head)
    mean, raw, off = out[..., :d], out[..., d:2 * d], out[..., 2 * d:]
    ell = torch.diag_embed(1.0 / torch.sqrt(F.softplus(raw) + _VAR_FLOOR))
    if d > 1:
        rr, cc = torch.tril_indices(d, d, -1, device=out.device)
        lower = torch.zeros_like(ell)
        lower[..., rr, cc] = off
        ell = ell + lower
    p_full = ell @ ell.mT
    return (p_full @ mean[..., None])[..., 0], p_full


def decoder_init(generator: torch.Generator, latent_dim: int, hidden: Sequence[int],
                 output_dim: int, likelihood: str = "gaussian", *,
                 device: torch.device | str = "cpu",
                 dtype: torch.dtype = torch.float32) -> list[dict]:
    """Decoder MLP d → hidden → 2·D (Gaussian: mean, raw variance) or D
    (Bernoulli logits)."""
    mult = 2 if likelihood == "gaussian" else 1
    return mlp_init(generator, [latent_dim, *hidden, mult * output_dim],
                    device=device, dtype=dtype)


def decoder_apply(params: list[dict], z: torch.Tensor, likelihood: str = "gaussian",
                  activation: str = "tanh", precision: str = "highest",
                  compute_dtype: torch.dtype | None = None):
    """z (..., d) → likelihood params: (mean, var), each (..., D), or the
    (..., D) Bernoulli logits. ``compute_dtype=torch.bfloat16`` runs the MLP
    body in bf16 and returns f32 head parameters, as the reference does."""
    if compute_dtype is not None:
        z = z.to(compute_dtype)
        params = [{name: t.to(compute_dtype) for name, t in ly.items()} for ly in params]
        out = mlp_apply(params, z, activation).float()
    else:
        out = mlp_apply(params, z, activation, precision)
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
                                fused: bool = False, precision: str = "highest",
                                activation: str = "tanh") -> torch.Tensor:
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
    ``precision`` is then moot, as in the reference, which sets DEFAULT.

    At f32 compute every product runs at ``precision`` (``dot``), and
    ``fused=True`` takes the row sum from ``ops.decoder.rowsum_logsig_neg``
    (its CUDA kernels on CUDA tensors, its plain version on CPU tensors), so
    the logits never reach device memory, in the mode ``precision`` maps to
    ("high" and "default": bf16 operands; "highest": f32). Under bf16 compute
    ``fused`` has no effect, as in the reference (svax/nets/mlp.py:268-274,
    whose other condition, the TPU backend, holds here always)."""
    out_dtype = z.dtype
    act = activation_fn(activation)
    if compute_dtype is not None:
        z = z.to(compute_dtype)
        x = x.to(compute_dtype)
        params = [{name: t.to(compute_dtype) for name, t in ly.items()} for ly in params]
        precision = "highest"
    acc = torch.float32 if compute_dtype is not None else x.dtype
    h = z
    for layer in params[:-1]:
        h = act(dot(h, layer["w"], precision) + layer["b"])
    last = params[-1]
    y = dot(x, last["w"].T, precision)  # (N, Dh), in the compute dtype
    c = dot(x.to(acc), last["b"].to(acc), precision)  # (N,)
    if precision == "default":
        t = dot(h, y[:, :, None], precision)[..., 0] + c[:, None]
    else:
        t = torch.einsum("...nkh,nh->...nk", h.to(acc), y.to(acc)) + c[:, None]
    if fused and compute_dtype is None:
        from svax_torch.ops import decoder

        return t + decoder.rowsum_logsig_neg(h, last["w"], last["b"], precision)
    o = dot(h, last["w"], precision) + last["b"]
    rowsum = F.logsigmoid(-o).sum(dim=-1, dtype=acc)
    return (t + rowsum).to(out_dtype)


def log_likelihood(params: list[dict], z: torch.Tensor, x: torch.Tensor,
                   likelihood: str = "gaussian", activation: str = "tanh",
                   precision: str = "highest",
                   compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """log p(x | z) under the configured head; broadcasts over sample axes."""
    out = decoder_apply(params, z, likelihood, activation, precision, compute_dtype)
    if likelihood == "gaussian":
        return gaussian_loglik(x, *out)
    return bernoulli_loglik(x, out)
