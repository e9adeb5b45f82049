"""The x-free Bernoulli row sum: wrapper, plain version, launch counters.

Port of ``svax/ops/decoder_pallas.py``. With logits o = h W + b, the
Bernoulli log-likelihood decomposes (logσ(o) − logσ(−o) = o) as

    ll = ⟨h, x Wᵀ⟩ + x·b + Σ_D logσ(−o),

and only the x-free row sum s(H) = Σ_D logσ(−(H W + b)) touches the large
(rows, D) logits. ``rowsum_logsig_neg`` computes it over flat rows H (M,
Dh) in the CUDA kernels of ``csrc/decoder.cu``, forward and recompute
backward (H̄ = do Wᵀ, W̄ = Hᵀ do, b̄ = Σ_m do with do = −σ(o)·s̄), so
neither direction writes the logits to device memory.

Precision, as the reference kernel's ``precision`` argument
(``_kernel_precision``): "highest" is f32 (the plain version, and the
forward kernel, in f32 FMAs; the backward kernels on the tensor cores,
each operand split exactly into three bf16 parts and the six terms of
order < 3 summed: f32-accurate products); "default" rounds H, W and, in the backward, do to bf16 before
each product and sums in f32 (a Mosaic dot at DEFAULT; b̄ sums the f32 do);
"high" maps to "default".

* On CUDA tensors ``rowsum_logsig_neg`` launches the kernels, or raises;
  there is no fallback.
* On CPU tensors it runs ``rowsum_logsig_neg_plain``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16
PRECISIONS = ("highest", "high", "default")
MAX_HIDDEN = 512  # Dh: the kernels keep a 64 × Dh H̄ tile and a Dh × 64 W̄ chunk on chip

launches = 0  # forward kernel launches made by rowsum_logsig_neg (plain int)
backward_launches = 0  # backward launches (each runs decoder.cu's three kernels)


def bernoulli_loglik_reference(h, w, b, x):
    """The unfused twin: h (N, R, Dh), w (Dh, D), b (D,), x (N, D) → ll (N, R)."""
    logits = torch.einsum("nrh,hd->nrd", h, w) + b
    xe = x[:, None, :]
    return (xe * F.logsigmoid(logits) + (1.0 - xe) * F.logsigmoid(-logits)).sum(dim=-1)


def _bf16_mode(precision: str) -> bool:
    """True for the bf16-operand mode ("default", and "high" mapped to it)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    return precision != "highest"


def _round(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    return t.to(BF16).float() if bf16 else t


class _RowsumPlain(torch.autograd.Function):
    """The kernels' function in plain PyTorch. The backward is written out
    because the bf16 mode rounds the cotangent do before its products, as
    the reference kernel's DEFAULT dots do, which autograd over rounded
    operands would not."""

    @staticmethod
    def forward(ctx, h2, w, b, bf16):
        ctx.save_for_backward(h2, w, b)
        ctx.bf16 = bf16
        o = _round(h2, bf16) @ _round(w, bf16) + b
        return F.logsigmoid(-o).sum(dim=-1)

    @staticmethod
    def backward(ctx, sbar):
        h2, w, b = ctx.saved_tensors
        hr, wr = _round(h2, ctx.bf16), _round(w, ctx.bf16)
        do = -torch.sigmoid(hr @ wr + b) * sbar[:, None]
        dr = _round(do, ctx.bf16)
        return dr @ wr.T, hr.T @ dr, do.sum(dim=0), None


def rowsum_logsig_neg_plain(h2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            precision: str = "highest") -> torch.Tensor:
    """s (M,) = Σ_D logσ(−(h2 W + b)) for flat rows h2 (M, Dh), in plain
    PyTorch with the kernels' rounding in the "default" mode."""
    return _RowsumPlain.apply(h2, w, b, _bf16_mode(precision))


class _RowsumKernel(torch.autograd.Function):
    """The forward and recompute-backward kernels as one differentiable
    function of (h2, w, b)."""

    @staticmethod
    def forward(ctx, h2, w, b, bf16):
        global launches
        from svax_torch.ops import _build
        ptr = _build.ptr

        lib = _build.load()
        m, dh = h2.shape
        d = w.shape[1]
        s = torch.empty((m,), device=h2.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(h2.device).cuda_stream
        with torch.cuda.device(h2.device):
            err = lib.rowsum_forward(ptr(h2), ptr(w), ptr(b), m, dh, d, int(bf16), ptr(s),
                                     ctypes.c_void_p(stream))
        _build.check(lib, err, "rowsum_forward")
        launches += 1
        ctx.save_for_backward(h2, w, b)
        ctx.bf16 = bf16
        return s

    @staticmethod
    def backward(ctx, sbar):
        global backward_launches
        from svax_torch.ops import _build

        h2, w, b = ctx.saved_tensors
        grads = backward_call(_build.load(), h2, w, b, sbar.to(torch.float32).contiguous(),
                              ctx.bf16)
        backward_launches += 1
        return (*grads, None)


def backward_call(lib, h2, w, b, sbar, bf16: bool):
    """(H̄, W̄, b̄) from ``lib``'s C entry ``rowsum_backward`` (the kernel
    library, or another build of ``decoder.cu``): contiguous float32 CUDA
    tensors h2 (M, Dh), w (Dh, D), b (D,), sbar (M,)."""
    from svax_torch.ops import _build
    ptr = _build.ptr

    m, dh = h2.shape
    d = w.shape[1]
    kw = dict(device=h2.device, dtype=torch.float32)
    hbar, wbar, bbar = (torch.empty(shape, **kw) for shape in ((m, dh), (dh, d), (d,)))
    scratch = torch.empty((lib.rowsum_scratch_floats(m, dh, d, int(bf16)),), **kw)
    stream = torch.cuda.current_stream(h2.device).cuda_stream
    with torch.cuda.device(h2.device):
        err = lib.rowsum_backward(ptr(h2), ptr(w), ptr(b), ptr(sbar), m, dh, d, int(bf16),
                                  ptr(hbar), ptr(wbar), ptr(bbar), ptr(scratch),
                                  ctypes.c_void_p(stream))
    _build.check(lib, err, "rowsum_backward")
    return hbar, wbar, bbar


def rowsum_logsig_neg(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      precision: str = "highest") -> torch.Tensor:
    """s = Σ_D logσ(−(h W + b)) over h's trailing axis: h (..., Dh), w
    (Dh, D), b (D,) → (...), differentiable in all three. Leading axes are
    flattened (the row sum does not depend on the rows' order).

    CUDA tensors: the kernels of ``csrc/decoder.cu`` (every tensor float32
    on one device, 1 ≤ Dh ≤ MAX_HIDDEN); anything else raises. CPU
    tensors: ``rowsum_logsig_neg_plain``."""
    bf16 = _bf16_mode(precision)
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    if h.device.type == "cpu":
        return rowsum_logsig_neg_plain(h2, w, b, precision).reshape(lead)
    if h.device.type != "cuda":
        raise ValueError(f"rowsum_logsig_neg: no kernel for device {h.device}")
    m, dh = h2.shape
    for name, t in (("h", h2), ("w", w), ("b", b)):
        if t.dtype != torch.float32 or t.device != h.device:
            raise ValueError(f"rowsum_logsig_neg: every tensor must be float32 on {h.device} "
                             f"({name}: {t.dtype} on {t.device})")
    if w.dim() != 2 or w.shape[0] != dh or tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"rowsum_logsig_neg: w {tuple(w.shape)} and b {tuple(b.shape)} do not "
                         f"fit rows of width {dh}")
    if not 1 <= dh <= MAX_HIDDEN or m < 1 or w.shape[1] < 1:
        raise ValueError(f"rowsum_logsig_neg: the kernels take 1 <= Dh <= {MAX_HIDDEN} and "
                         f"nonempty M and D (got M={m}, Dh={dh}, D={w.shape[1]})")
    return _RowsumKernel.apply(h2.contiguous(), w.contiguous(), b.contiguous(), bf16
                               ).reshape(lead)


def fused_bernoulli_loglik(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """The last decoder layer and its Bernoulli log-likelihood, (N, R, Dh)
    against x (N, D) → (N, R): the x terms y = x Wᵀ, c = x·b and ⟨h, y⟩ + c
    as plain products, the row sum in ``rowsum_logsig_neg`` at "highest"
    (decoder_pallas.py:211-229)."""
    y = x @ w.T
    c = x @ b
    t = torch.einsum("nrh,nh->nr", h, y) + c[:, None]
    return t + rowsum_logsig_neg(h, w, b, "highest")
