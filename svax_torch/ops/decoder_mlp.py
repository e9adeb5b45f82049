"""Fused Bernoulli MLP decoder: wrapper, plain version, launch counters.

Port of ``svax/ops/decoder_mlp_pallas.py: bernoulli_mlp_loglik_fused``. Per
row r = (s·N + n)·K + k of z (S, N, K, d), the two-hidden-layer tanh
decoder and its x-free Bernoulli log-likelihood

    h1 = tanh(z W1 + b1);  h2 = tanh(h1 W2 + b2);  o = h2 W3 + b3
    ll = ⟨h2, y_n⟩ + c_n + Σ_D logσ(−o),   y = x W3ᵀ, c = x·b3

with h1, h2 and o never leaving the kernel. The forward and its recompute
backward are the CUDA kernels of ``csrc/decoder_mlp.cu``.

Numerics (the reference kernel's own, ``_tile_ll`` and the wrapper's y, c):
every product rounds its two operands to bf16 and accumulates in f32; h1,
h2 and o stay f32 between layers; the t-term ⟨h2, y⟩ uses the f32 h2; y and
c are products of bf16(x) with bf16(W3), bf16(b3), formed in f32 outside
the kernel, so their gradients reach W3 and b3 through autograd.

Where the backward rounds (found on the CPU against the reference kernel in
interpret mode, PERF.md): JAX's transpose of a bf16 dot with f32
accumulation does NOT round the f32 cotangent before the product; only the
product's result is rounded, at the cast (dz, the cotangents of h1 and of
h2's product path, and the weight cotangents come back bf16-valued). That
is plain autograd over ``a.to(bf16).float() @ w.to(bf16).float()``. The
reference rounds each tile's dW before adding it across its sequential
grid; the plain version (and the kernel) round dW once, over the whole
batch: the two differ by ~3e-3 of max|dW| at the test shapes, inside the
reference's own 2e-2 bar.

* On CUDA tensors ``bernoulli_mlp_loglik_fused`` launches the kernels, or
  raises; there is no fallback.
* On CPU tensors it runs ``bernoulli_mlp_loglik_plain``, differentiated by
  autograd.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16

# The kernel's shape class: three layers (two tanh hidden layers), latent
# d ≤ MAX_LATENT (one 16-wide product step), hidden widths ≤ MAX_HIDDEN.
MAX_LATENT = 16
MAX_HIDDEN = 256

launches = 0  # forward kernel launches made by bernoulli_mlp_loglik_fused (plain int)
backward_launches = 0  # backward kernel launches (plain int)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _bf16_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with both operands rounded to bf16 and the sum in f32."""
    return a.to(BF16).float() @ w.to(BF16).float()


def x_terms(params: list, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """y = bf16(x)·bf16(W3)ᵀ (N, Dh2) and c = bf16(x)·bf16(b3) (N,), in f32
    (decoder_mlp_pallas.py:326-333)."""
    xb = x.to(BF16).float()
    return xb @ params[2]["w"].to(BF16).float().T, xb @ params[2]["b"].to(BF16).float()


def core_plain(z, w1, b1, w2, b2, w3, b3, y, c) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ll (S, N, K) from z (S, N, K,
    d), the f32 weights and biases, y (N, Dh2) and c (N,)."""
    h1 = torch.tanh(_bf16_mm(z, w1) + b1)
    h2 = torch.tanh(_bf16_mm(h1, w2) + b2)
    o = _bf16_mm(h2, w3) + b3
    rowsum = F.logsigmoid(-o).sum(dim=-1)
    return torch.einsum("...nkh,nh->...nk", h2, y) + c[:, None] + rowsum


def bernoulli_mlp_loglik_plain(params: list, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``bernoulli_mlp_loglik_fused`` in plain PyTorch: (S, N, K)."""
    y, c = x_terms(params, x)
    return core_plain(z, params[0]["w"], params[0]["b"], params[1]["w"], params[1]["b"],
                      params[2]["w"], params[2]["b"], y, c)


def unsupported_reason(params: list, latent_dim: int, activation: str = "tanh") -> str | None:
    """Why the CUDA kernels cannot take this decoder (None = they can)."""
    if len(params) != 3:
        return f"the fused MLP decoder takes 2 hidden layers (got {len(params) - 1})"
    if activation != "tanh":
        return f"the fused MLP decoder takes tanh hidden layers (got {activation})"
    if not 1 <= latent_dim <= MAX_LATENT:
        return f"latent d = {latent_dim}: the kernel takes 1 <= d <= {MAX_LATENT}"
    hidden = (params[0]["w"].shape[1], params[1]["w"].shape[1])
    if not all(1 <= h <= MAX_HIDDEN for h in hidden):
        return f"hidden widths {hidden}: the kernel takes widths 1..{MAX_HIDDEN}"
    return None


# ------------------------------------------------------------- the kernels


def _padded(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """w rounded to bf16 in a zero (rows, cols) block."""
    out = torch.zeros((rows, cols), dtype=BF16, device=w.device)
    out[:w.shape[0], :w.shape[1]] = w.to(BF16)
    return out


def _bf16_weights(w1, w2, w3) -> list[torch.Tensor]:
    """The bf16 operands the kernels read, zero-padded (d, the hidden widths
    and D to multiples of 16): each matrix in its (in, out) layout and
    transposed, so every fragment load reads two neighbouring bf16."""
    d, h1 = w1.shape
    h2, dd = w3.shape
    dp, h1p, h2p, ddp = MAX_LATENT, _round_up(h1, 16), _round_up(h2, 16), _round_up(dd, 16)
    return [_padded(w1, dp, h1p), _padded(w1.T, h1p, dp), _padded(w2, h1p, h2p),
            _padded(w2.T, h2p, h1p), _padded(w3, h2p, ddp), _padded(w3.T, ddp, h2p)]


class _DecoderKernel(torch.autograd.Function):
    """The forward and recompute-backward kernels as one differentiable
    function of (z, W1, b1, W2, b2, W3, b3, y, c)."""

    @staticmethod
    def forward(ctx, z, w1, b1, w2, b2, w3, b3, y, c):
        global launches
        from svax_torch.ops import _build
        ptr = _build.ptr

        lib = _build.load()
        s, n, k, d = z.shape
        h1, h2, dd = w1.shape[1], w2.shape[1], w3.shape[1]
        wb = _bf16_weights(w1, w2, w3)
        ll = torch.empty((s, n, k), device=z.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(z.device).cuda_stream
        with torch.cuda.device(z.device):
            err = lib.decoder_mlp_forward(
                ptr(z), n, k, s, d, h1, h2, dd, *(ptr(t) for t in wb),
                ptr(b1), ptr(b2), ptr(b3), ptr(y), ptr(c), ptr(ll), ctypes.c_void_p(stream))
        _build.check(lib, err, "decoder_mlp_forward")
        launches += 1
        ctx.save_for_backward(z, w1, b1, w2, b2, w3, b3, y, *wb)
        return ll

    @staticmethod
    def backward(ctx, dll):
        global backward_launches
        from svax_torch.ops import _build

        z, w1, b1, w2, b2, w3, b3, y, *wb = ctx.saved_tensors
        grads = backward_call(_build.load(), z, (w1, b1, w2, b2, w3, b3), y, wb,
                              dll.to(torch.float32).contiguous())
        backward_launches += 1
        return grads


def backward_call(lib, z, params, y, wb, dll):
    """(dz, dW1, db1, dW2, db2, dW3, db3, dy, dc) from ``lib``'s C entry
    ``decoder_mlp_backward`` (the kernel library, or another build of
    ``decoder_mlp.cu``): params (w1, b1, w2, b2, w3, b3), y (N, H2), wb
    ``_bf16_weights(w1, w2, w3)``, dll (S, N, K); contiguous float32 CUDA
    tensors."""
    from svax_torch.ops import _build
    ptr = _build.ptr

    w1, b1, w2, b2, w3, b3 = params
    s, n, k, d = z.shape
    h1, h2, dd = w1.shape[1], w2.shape[1], w3.shape[1]
    kw = dict(device=z.device, dtype=torch.float32)
    dz = torch.empty(z.shape, **kw)
    dy = torch.empty((n, h2), **kw)
    dc = torch.empty((n,), **kw)
    dw1, db1 = torch.empty((d, h1), **kw), torch.empty((h1,), **kw)
    dw2, db2 = torch.empty((h1, h2), **kw), torch.empty((h2,), **kw)
    dw3, db3 = torch.empty((h2, dd), **kw), torch.empty((dd,), **kw)
    scratch = torch.empty((lib.decoder_mlp_scratch_floats(n, k, s, d, h1, h2, dd),), **kw)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        err = lib.decoder_mlp_backward(
            ptr(z), ptr(dll), n, k, s, d, h1, h2, dd, *(ptr(t) for t in wb),
            ptr(b1), ptr(b2), ptr(b3), ptr(y), ptr(dz), ptr(dy), ptr(dc), ptr(scratch),
            ptr(dw1), ptr(db1), ptr(dw2), ptr(db2), ptr(dw3), ptr(db3),
            ctypes.c_void_p(stream))
    _build.check(lib, err, "decoder_mlp_backward")
    return dz, dw1, db1, dw2, db2, dw3, db3, dy, dc


def core_fused(z, w1, b1, w2, b2, w3, b3, y, c) -> torch.Tensor:
    """``core_plain`` through the CUDA kernels: ll (S, N, K), differentiable
    in every argument. Every tensor float32 on one CUDA device, the shapes
    in ``unsupported_reason``'s class; anything else raises."""
    if z.device.type != "cuda":
        raise ValueError(f"decoder_mlp.core_fused: no kernel for device {z.device}")
    if z.dim() != 4:
        raise ValueError(f"decoder_mlp: z must be (S, N, K, d), got {tuple(z.shape)}")
    params = [{"w": w1, "b": b1}, {"w": w2, "b": b2}, {"w": w3, "b": b3}]
    reason = unsupported_reason(params, z.shape[-1])
    if reason is not None:
        raise ValueError(f"decoder_mlp: {reason}")
    n, h2, dd = z.shape[1], w2.shape[1], w3.shape[1]
    want = {"w1": (z.shape[-1], w1.shape[1]), "b1": (w1.shape[1],), "w2": (w1.shape[1], h2),
            "b2": (h2,), "w3": (h2, dd), "b3": (dd,), "y": (n, h2), "c": (n,)}
    for name, t in zip(["z", *want], (z, w1, b1, w2, b2, w3, b3, y, c)):
        if t.dtype != torch.float32 or t.device != z.device:
            raise ValueError(f"decoder_mlp: every tensor must be float32 on {z.device} "
                             f"({name}: {t.dtype} on {t.device})")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"decoder_mlp: {name} shape {tuple(t.shape)} != {want[name]}")
    return _DecoderKernel.apply(*(t.contiguous() for t in (z, w1, b1, w2, b2, w3, b3, y, c)))


def bernoulli_mlp_loglik_fused(params: list, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Fused Bernoulli decoder log-likelihood (S, N, K) from z (S, N, K, d)
    and x (N, D), differentiable in z and every parameter.

    CUDA tensors: ``core_fused``, the kernels of ``csrc/decoder_mlp.cu``
    (float32, the shape class of ``unsupported_reason``); anything else
    raises. CPU tensors: ``bernoulli_mlp_loglik_plain``."""
    if z.device.type == "cpu":
        return bernoulli_mlp_loglik_plain(params, z, x)
    reason = unsupported_reason(params, z.shape[-1])
    if reason is not None:
        raise ValueError(f"bernoulli_mlp_loglik_fused: {reason}")
    if x.device != z.device or tuple(x.shape) != (z.shape[1], params[2]["w"].shape[1]):
        raise ValueError(f"bernoulli_mlp_loglik_fused: x ({tuple(x.shape)} on {x.device}) "
                         f"must be (N, D) = {(z.shape[1], params[2]['w'].shape[1])} on {z.device}")
    y, c = x_terms(params, x)
    return core_fused(z, params[0]["w"], params[0]["b"], params[1]["w"], params[1]["b"],
                      params[2]["w"], params[2]["b"], y, c)
