"""Measure the mnist-svae and bigk-dp paths on one CUDA card: the numbers
behind PERF.md's mnist-svae and bigk-dp breakdowns.

    python -m svax_torch.measure_mnist [--config mnist-svae|bigk-dp] [--fused-decoder] > measure.txt
    python -m svax_torch.measure_mnist --combine [--parent DIR] > combine.txt

Run from the root of a checkout; needs one CUDA device and nvcc.
``--config bigk-dp`` measures the decoder kernels and the bigk entry
(``measure_bigk``); ``--fused-decoder`` the row-sum kernels and the big-K
f32 step with and without them (``measure_fused_decoder``); ``--combine``
the combine kernels alone at COMBINE_SHAPES and the ρ-kernel at RHO_SHAPES,
each in both configurations of the backward, this tree against another
checkout in turns (``measure_combine``). The default prints the card, then two parts (every
time a median of 3):

1. the combine kernels at the mnist shape (N=256, K=10, d=8, S=1) and the
   bigk shape (N=1024, K=100, d=10, S=1): ms per call of the forward (in-
   kernel ε, as the main path runs it) and of the backward alone (autograd's
   backward over a retained graph) in both COMBINE_CONFIGS, as device time
   under the profiler (split into the combine kernels' own and the
   cross-block sums') and as CUDA-event time per call, beside the plain
   version's (injected ε), and each beside its bound (``combine_bound``);
2. ``train_svae --config mnist-svae`` without the warmup: 1000 steps on
   the kernel engine and 40 on the plain engine for their rates, then 200
   and 10 steps under ``torch.profiler``: wall time, device time (the sum
   of the card's kernel times), the idle share 1 − device/wall, the
   combine kernels' device time and share, and the ten kernels with the
   most device time. The profiler's own cost is in the wall time.
"""

from __future__ import annotations

import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from svax_torch.measure_mixture import device_ms, device_us, profiled

# One H100 SXM (data sheet): f32 outside the tensor cores, device memory.
F32_FLOPS = 67e12
MEM_BYTES_PER_S = 3.35e12


def combine_bound(n: int, k: int, d: int, s: int, backward: bool,
                  norm: bool = False, main_path: bool = False) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time for the combine forward
    (or its backward) at these shapes — each input read once, each output
    written once, in float32; operations per (n, k) counted from the
    algorithm: Cholesky, L̃⁻¹ and Σ̃ ~d³/3 each, the two solves for μ̃ and
    one per sample 2d² each, the local KL and the statistics ~4d²; the
    backward recomputes the forward (without writing it) and adds ~2d³ +
    (2S + 8)d² for the Cholesky backward, Σ̃Σ̄Σ̃ and the dw row. ``norm``:
    the log_norm mode, which also reads the (N,) normaliser (and, backward,
    writes its cotangent). ``main_path``: the backward of the train step's
    call (COMBINE_CONFIGS "a"), which reads the cotangents of z, log r̃ and
    the local row only and writes no dw; it needs only diag G and h̃̄: ~d³
    for diag(Σ̃Σ̄Σ̃) and (3S + 6)d² for the samples' term, μ̄ and Σ̃μ̄."""
    f, w = 1 + d + d * d, 3 + d + d * d
    fwd_ops = d ** 3 + (2 * s + 8) * d * d + 20 * d
    if backward and main_path:
        ops = n * k * (fwd_ops + d ** 3 + (3 * s + 6) * d * d)
        nbytes = 4 * (2 * n * d + k * w                     # pot_h, pot_p, w
                      + s * n * k * d + n * k + n           # dz, dlr, dlocal
                      + 2 * n * d)                          # dpot_h, dpot_p
    elif backward:
        ops = n * k * (fwd_ops + 2 * d ** 3 + (2 * s + 8) * d * d)
        nbytes = 4 * (2 * n * d + k * w                     # pot_h, pot_p, w
                      + s * n * k * d + n * k + n * k * d + n + k * f  # cotangents
                      + 2 * n * d + k * w)                  # dpot_h, dpot_p, dw
    else:
        ops = n * k * fwd_ops
        nbytes = 4 * (2 * n * d + k * w
                      + s * n * k * d + n * k + n * k * d + n + k * f)  # z, log r̃, μ̃, local, stats
    if norm:
        nbytes += 4 * n * (2 if backward else 1)
    return _bound(ops, nbytes)


def rho_bound(n: int, k: int, d: int, backward: bool,
              main_path: bool = False) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time for the ρ-kernel (or its
    backward) — per (n, k) the Cholesky ~d³/3, the two solves for μ̃ 2d² and
    the logs and dot ~10d; the backward with dw (RHO_CONFIGS "b") recomputes
    that and adds L̃⁻¹ and Σ̃ (~d³/3 each) and the G and dw row (~3d²).
    ``main_path``: the train step's backward (RHO_CONFIGS "a"), counted from
    what it must compute — μ̃ (the Cholesky and two solves), diag Σ̃ (L̃⁻¹
    ~d³/3 and its columns' squares d²), h̃̄ = ρ̄μ̃ and diag G = −½ρ̄(diag Σ̃ +
    μ̃²) (4d), and their sums over K (2d): no logs, no dw. Bytes: the
    potentials and w read, log ρ written (backward: its cotangent read,
    dpot_h, dpot_p and, with dw, dw written)."""
    w = 3 + d + d * d
    if backward and main_path:
        ops = n * k * (2 * d ** 3 / 3 + 3 * d * d + 6 * d)
        nbytes = 4 * (2 * n * d + k * w + n * k + 2 * n * d)
        return _bound(ops, nbytes)
    ops = n * k * (d ** 3 / 3 + 2 * d * d + 10 * d)
    nbytes = 4 * (2 * n * d + k * w + n * k)
    if backward:
        ops += n * k * (2 * d ** 3 / 3 + 3 * d * d)
        nbytes += 4 * (2 * n * d + k * w)
    return _bound(ops, nbytes)


def launched_us(prof, name: str) -> float:
    """``device_us(prof, name)`` for a kernel the profiled calls launched:
    raises if the profiler recorded no device time for it (it has dropped
    device events late in a long process, PERF.md), rather than report 0."""
    us = device_us(prof, name)
    if us <= 0.0:
        raise RuntimeError(f"torch.profiler recorded no device time for {name}, which the "
                           "profiled calls launched: time it in a fresh process")
    return us


def _bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / F32_FLOPS, nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def combine_inputs(dev, n: int, k: int, d: int, s: int, seed: int = 0):
    """Seeded potentials, expected parameters from a random posterior
    (tests/test_combine_kernel.py's recipe) and ε, on ``dev``."""
    from svax_torch.pgm import gmm

    rng = np.random.default_rng(seed)
    pot_h = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32, device=dev)
    pot_p = torch.tensor(0.3 + rng.random((n, d)), dtype=torch.float32, device=dev)
    nat = gmm.init_variational(torch.Generator().manual_seed(seed), gmm.make_prior(k, d))
    exp = gmm.GmmExpected(*(t.to(dev) for t in gmm.expected_params(nat)))
    eps = torch.tensor(rng.standard_normal((s, n, k, d)), dtype=torch.float32, device=dev)
    return pot_h, pot_p, exp, eps


# The two calls of the combine backward that are timed: "a", the train
# step's — it differentiates the network's parameters only, so the backward
# receives the cotangents of z, log r̃ and the local row and owes no dw (the
# statistics go to the CVI update detached); "b", every output's cotangent
# and every input's gradient, dw and (log_norm mode) dn included.
COMBINE_CONFIGS = ("a", "b")


def _combine_case(dev, n: int, k: int, d: int, s: int, log_norm: bool):
    """Seeded inputs and, per configuration and side ("kernel" with the
    in-kernel ε, "plain" with injected ε), the leaves to differentiate and
    a function of them returning the scalar whose backward is timed."""
    from svax_torch.ops import combine

    pot_h, pot_p, exp, eps = combine_inputs(dev, n, k, d, s)
    norm = (torch.logsumexp(combine.log_rho_plain(pot_h, pot_p, exp), dim=-1) + 0.5
            if log_norm else None)

    def make(side: str, config: str):
        leaves = [t.clone().requires_grad_(True) for t in (pot_h, pot_p)]
        e = exp
        if config == "b":
            e = type(exp)(*(t.clone().requires_grad_(True) for t in exp))
            leaves += list(e)
        nrm = None if norm is None else norm.clone().requires_grad_(True)
        if nrm is not None:
            leaves.append(nrm)

        def run():
            if side == "kernel":
                return combine.combine_fused(leaves[0], leaves[1], e, None, s, seed=1, step=0,
                                             log_norm=nrm)
            return combine.combine_fused_plain(leaves[0], leaves[1], e, eps, s, log_norm=nrm)

        def loss_of(out):
            z, lr, mean, local, st = out
            loss = z.sum() + lr.sum() + local.sum()
            if config == "b":
                loss = (loss + mean.sum() + st.counts.sum() + st.mean_stat.sum()
                        + st.scatter_stat.sum())
            return loss

        return leaves, run, loss_of

    return make


def time_combine(dev, n: int, k: int, d: int, s: int, reps: int = 20,
                 log_norm: bool = False, plain: bool = True) -> dict:
    """ms per call of the combine forward (``log_norm``: its log_norm mode)
    and of its backward alone (autograd over a retained graph) in each of
    COMBINE_CONFIGS, for the kernels (in-kernel ε) and the plain version
    (injected ε). Keys ``{kernel,plain}_fwd_{device,call}`` and
    ``{kernel,plain}_bwd_{a,b}_{device,call}``: ``*_device`` is the card's
    kernel time per call under ``torch.profiler``, ``*_call`` the
    CUDA-event time per call (the host's gaps between launches included).
    For the kernels the device time is split as well: ``*_kernel`` the
    combine kernels' own (names holding combine_fwd or combine_bwd),
    ``*_reduce`` the cross-block sums (names holding "reduce"). The plain
    version, thousands of small kernels a call, runs a quarter of the
    repetitions (``plain=False``: not at all)."""
    make = _combine_case(dev, n, k, d, s, log_norm)
    out = {}
    sides = (("kernel", reps), ("plain", max(1, reps // 4)))
    for side, n_rep in sides if plain else sides[:1]:
        calls = {}
        for config in COMBINE_CONFIGS:
            leaves, run, loss_of = make(side, config)
            loss = loss_of(run())
            if config == "a":
                def forward(run=run):
                    with torch.no_grad():
                        run()
                calls["fwd"] = (forward, "combine_fwd")

            def backward(loss=loss, leaves=leaves):
                torch.autograd.grad(loss, leaves, retain_graph=True)
            calls[f"bwd_{config}"] = (backward, "combine_bwd")
        for part, (call, kernel_name) in calls.items():
            out[f"{side}_{part}_call"] = device_ms(call, n_rep)
            _, prof = profiled(lambda: [call() for _ in range(n_rep)])
            if side == "kernel":
                own = launched_us(prof, kernel_name) / 1e3 / n_rep
                red = device_us(prof, "reduce") / 1e3 / n_rep
                out[f"kernel_{part}_kernel"], out[f"kernel_{part}_reduce"] = own, red
                out[f"kernel_{part}_device"] = own + red
            else:
                out[f"plain_{part}_device"] = device_us(prof) / 1e3 / n_rep
    return out


# The two calls of the ρ-kernel's backward that are timed: "a", the train
# step's — the expected parameters are constants of the step, so it owes
# the potentials' cotangents only; "b", every input's gradient, dw included.
RHO_CONFIGS = ("a", "b")


def time_rho(dev, n: int, k: int, d: int, reps: int = 20) -> dict:
    """ms per call of the ρ-kernel's forward and of its backward alone
    (autograd over a retained graph, a seeded cotangent of log ρ) in each of
    RHO_CONFIGS, for the kernels (``log_rho_fused``) and the plain version
    (``log_rho_plain``). Keys ``{kernel,plain}_rho_fwd_{device,call}`` and
    ``{kernel,plain}_rho_bwd_{a,b}_{device,call}``: ``*_device`` the card's
    kernel time per call under ``torch.profiler``, ``*_call`` CUDA events;
    for the kernels the backward's device time is split as well
    (``*_kernel``: log_rho_bwd's own, ``*_reduce``: the cross-block sum's)
    and ``kernel_rho_{fwd,bwd_a,bwd_b}_launches`` counts the device kernels of
    the ρ-kernels (and their cross-block sum) a call runs. Uses only the
    entries every tree has."""
    from svax_torch.ops import combine

    pot_h, pot_p, exp, _ = combine_inputs(dev, n, k, d, 1)
    drho = torch.tensor(np.random.default_rng(1).standard_normal((n, k)), dtype=torch.float32,
                        device=dev)
    out = {}
    for side, fn, n_rep in (("kernel", combine.log_rho_fused, reps),
                            ("plain", combine.log_rho_plain, max(1, reps // 4))):
        def forward(fn=fn):
            with torch.no_grad():
                fn(pot_h, pot_p, exp)

        calls = {"fwd": forward}
        for config in RHO_CONFIGS:
            leaves = [t.clone().requires_grad_(True) for t in (pot_h, pot_p)]
            e = exp
            if config == "b":
                e = type(exp)(*(t.clone().requires_grad_(True) for t in exp))
                leaves += list(e)
            rho = fn(leaves[0], leaves[1], e)
            calls[f"bwd_{config}"] = (lambda rho=rho, leaves=leaves: torch.autograd.grad(
                rho, leaves, grad_outputs=drho, retain_graph=True))
        for part, call in calls.items():
            out[f"{side}_rho_{part}_call"] = device_ms(call, n_rep)
            _, prof = profiled(lambda: [call() for _ in range(n_rep)])
            if side == "plain":
                out[f"plain_rho_{part}_device"] = device_us(prof) / 1e3 / n_rep
                continue
            own = launched_us(prof, f"log_rho_{part[:3]}")
            out[f"kernel_rho_{part}_device"] = (own + device_us(prof, "reduce")) / 1e3 / n_rep
            events = [ev for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA
                      and ("log_rho" in ev.name or "reduce" in ev.name)]
            out[f"kernel_rho_{part}_launches"] = len(events) / n_rep
            if part != "fwd":
                out[f"kernel_rho_{part}_kernel"] = own / 1e3 / n_rep
                out[f"kernel_rho_{part}_reduce"] = device_us(prof, "reduce") / 1e3 / n_rep
    return out


def time_comp(dev, n: int, k: int, d: int, s: int, reps: int = 20) -> dict:
    """ms per call of the component-parallel kernels at one K-shard: the
    ρ-kernel's forward and its backward in both RHO_CONFIGS (``time_rho``'s
    keys) and the combine's log_norm mode (``time_combine(log_norm=True)``'s
    keys with ``norm_`` after the side, e.g. ``kernel_norm_bwd_a_device``),
    against their plain versions."""
    out = time_rho(dev, n, k, d, reps)
    for key, val in time_combine(dev, n, k, d, s, reps, log_norm=True).items():
        side, rest = key.split("_", 1)
        out[f"{side}_norm_{rest}"] = val
    return out


# The shapes at which the combine is timed (N, K, d, S):
# the two configs' batches, one rank's batch on bigk-dp's 2x1 data mesh and
# one rank's K-shard on its 1x2 comp mesh (log_norm mode).
COMBINE_SHAPES = {"bigk": (1024, 100, 10, 1), "mnist": (256, 10, 8, 1),
                  "bigk data shard": (512, 100, 10, 1), "bigk K-shard": (1024, 50, 10, 1)}


# The ρ-kernel is timed at one rank's K-shard on bigk-dp's 1x2 comp mesh
# and at bigk-dp's whole K (N, K, d).
RHO_SHAPES = {"bigk K-shard": (1024, 50, 10), "bigk": (1024, 100, 10)}


def combine_times() -> dict:
    """``time_combine`` at COMBINE_SHAPES (the K-shard in its log_norm mode)
    and ``time_rho`` at RHO_SHAPES (as "rho <label>") with the svax_torch this
    process imports, and the combine and ρ-kernels' ptxas lines from its
    build log: {"times": {shape: {...}}, "ptxas": [...]}. ``--combine`` runs
    it in a child process per tree."""
    from svax_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    times = {label: time_combine(dev, *shape, log_norm=label == "bigk K-shard", plain=False)
             for label, shape in COMBINE_SHAPES.items()}
    for label, shape in RHO_SHAPES.items():
        times[f"rho {label}"] = time_rho(dev, *shape)
    return {"times": times, "ptxas": [line for name in COMBINE_KERNELS
                                      for line in kernel_resources(_build.build_log, name)]}


def kernel_resources(log: str, name: str) -> list[str]:
    """ptxas's registers and spill bytes for each instantiation of the
    kernels whose names begin with ``name`` in an nvcc -Xptxas -v log (such
    as ``_build.build_log``), one string each: "kernel<its integer and
    boolean template arguments>: N registers, <the spill line>". Kept here,
    not in ``_build``, so that ``combine_times`` can read another tree's
    log."""
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(rf"\d+({name}\w*?)I", line)
            entry = None
            if m:
                args = re.findall(r"L[ib](\d+)E", line[m.start(1):].split("Ev")[0])
                entry = f"{m.group(1)}<{', '.join(args)}>"
        elif entry and "spill stores" in line:
            spill = line.strip()
        elif entry and "Used" in line and "registers" in line:
            out.append(f"{entry}: {line.split('Used')[1].split(',')[0].strip()}, {spill}")
            entry = None
    return out


COMBINE_KERNELS = ("combine_fwd", "combine_bwd", "log_rho_fwd", "log_rho_bwd")


def combine_paths(steps: int = 3) -> dict:
    """The cotangents the combine backward receives on the mnist-svae and
    bigk-dp train steps (``ops.combine.backward_paths`` after ``steps``
    steps of each entry on the card, without the warmup)."""
    from svax_torch import train_svae
    from svax_torch.ops import combine

    out = {}
    for config in ("mnist-svae", "bigk-dp"):
        combine.backward_paths.clear()
        train_svae.main(["--config", config, "--steps", str(steps), "--warmup-steps", "0",
                         "--device", "cuda", "--iw-samples", "0"])
        out[config] = dict(combine.backward_paths)
    return out


# One H100 SXM (data sheet): dense bf16 tensor-core peak; special-function
# units: 16 results per clock per SM on 132 SMs.
BF16_FLOPS = 989e12
SFU_PER_CLOCK = 16 * 132

# The kernels against their plain version, from the reference kernel test's
# bars (tests/test_decoder_mlp_kernel.py), carried to the mnist and bigk
# widths. Both sides round the same operands to bf16 and sum in f32 in other
# orders, so an activation or cotangent whose f32 value lies within an ulp
# of a bf16 rounding tie rounds the other way on one side: its row's ll then
# moves by up to ~2e-5 of it, a dz entry by one bf16 ulp (2⁻⁸..2⁻⁷ of it).
# With H1·H2 = 40,000 such rounding points a row (the reference's test: 256)
# that happens in a few rows in a thousand. So: ll at rtol = atol = 1e-5
# (reported as |Δ| / (1 + |ref|)) in all but 0.5% of rows and at 1e-4 in
# all; dz within 5e-3 of max(1, max |dz|) (one ulp of the largest entry is
# 2⁻⁸..2⁻⁷ of it) with under 2% of entries beyond 1e-5 (measured: 0.34% at
# the mnist shape, 0.71% at bigk; the port's plain version against the
# reference kernel on the CPU at the mnist width: 0.37%); every other
# gradient within 2e-2 of max(1, max |ref|) (sums over rows of bf16-valued
# products, rounded to bf16 for the weights).
DECODER_TOL = {"ll": 1e-4, "ll share > 1e-5": 5e-3, "dz max": 5e-3, "dz share > 1e-5": 2e-2,
               "grad": 2e-2}
DECODER_FIELDS = ("z", "w1", "b1", "w2", "b2", "w3", "b3", "y", "c")


def decoder_inputs(dev, s: int, n: int, k: int, d: int, h1: int, h2: int, dd: int,
                   seed: int = 0):
    """Seeded (params, z (S, N, K, d), binarised x (N, D), a cotangent dll
    (S, N, K)) on ``dev``: Glorot-scaled weights, biases of scale 0.1."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    params = [{"w": torch.tensor(rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b)), **f32),
               "b": torch.tensor(0.1 * rng.standard_normal(b), **f32)}
              for a, b in ((d, h1), (h1, h2), (h2, dd))]
    z = torch.tensor(rng.standard_normal((s, n, k, d)), **f32)
    x = torch.tensor(rng.random((n, dd)) < 0.3, **f32)
    dll = torch.tensor(rng.standard_normal((s, n, k)), **f32)
    return params, z, x, dll


def decoder_grads(core, params, z, x, dll):
    """ll and the gradients of ⟨ll, dll⟩ through ``core`` (``core_fused`` or
    ``core_plain``) w.r.t. DECODER_FIELDS; those of w3 and b3 include the
    x-path through y and c."""
    from svax_torch.ops import decoder_mlp

    leaves = [z.detach().clone().requires_grad_(True)] + [
        t.detach().clone().requires_grad_(True) for ly in params for t in (ly["w"], ly["b"])]
    ps = [{"w": leaves[1 + 2 * i], "b": leaves[2 + 2 * i]} for i in range(3)]
    y, c = decoder_mlp.x_terms(ps, x)
    ll = core(*leaves, y, c)
    grads = torch.autograd.grad((ll * dll).sum(), [*leaves, y, c])
    return ll.detach(), dict(zip(DECODER_FIELDS, grads))


def decoder_errors(params, z, x, dll) -> dict:
    """The kernels against the plain version on the same inputs, in the
    measures of DECODER_TOL (plus "ll max abs", the largest |Δll|)."""
    from svax_torch.ops import decoder_mlp

    ll_k, g_k = decoder_grads(decoder_mlp.core_fused, params, z, x, dll)
    torch.cuda.synchronize()
    ll_p, g_p = decoder_grads(decoder_mlp.core_plain, params, z, x, dll)
    diff = (ll_k.double() - ll_p.double()).abs()
    rel = diff / (1.0 + ll_p.double().abs())
    errs = {"ll": float(rel.max()), "ll share > 1e-5": float((rel > 1e-5).double().mean()),
            "ll max abs": float(diff.max())}
    dz = (g_k["z"].double() - g_p["z"].double()).abs()
    errs["dz max"] = float(dz.max()) / max(1.0, float(g_p["z"].abs().max()))
    errs["dz share > 1e-5"] = float((dz > 1e-5).double().mean())
    errs["grad max abs"] = max(float((g_k[name].double() - g_p[name].double()).abs().max())
                               for name in DECODER_FIELDS)
    for name in DECODER_FIELDS[1:]:
        ref = g_p[name].double()
        errs[name] = float((g_k[name].double() - ref).abs().max()
                           / max(1.0, float(ref.abs().max())))
    finite = all(bool(torch.isfinite(t).all()) for t in (ll_k, *g_k.values()))
    errs["finite"] = finite
    return errs


def decoder_bound(s: int, n: int, k: int, d: int, h1: int, h2: int, dd: int,
                  backward: bool, sm_clock_hz: float) -> dict:
    """The least time for the decoder forward (or its backward) at these
    shapes, as the largest of three: its bf16 products (2 FLOP per
    multiply-add) over the tensor-core peak; its special functions (tanh;
    logσ as an exp and a log; σ as an exp and a reciprocal) over the
    special-function units at ``sm_clock_hz``; its bytes (each input read
    once, each output written once, f32) over the memory rate. The backward
    recomputes the forward and adds the two transposed products of every
    layer. Returns {"ms", "by", "products_ms", "special_ms", "bytes_ms"}."""
    rows = s * n * k
    macs = rows * (d * h1 + h1 * h2 + h2 * dd)
    weights = d * h1 + h1 + h1 * h2 + h2 + h2 * dd + dd
    if backward:
        flops, special = 2 * 3 * macs, rows * (h1 + h2 + 2 * dd)
        nbytes = 4 * (2 * rows * d + 2 * rows + 2 * n * h2 + n + 2 * weights)
    else:
        flops, special = 2 * macs, rows * (h1 + h2 + 2 * dd)
        nbytes = 4 * (rows * d + n * h2 + n + rows + weights)
    times = {"products_ms": flops / BF16_FLOPS * 1e3,
             "special_ms": special / (SFU_PER_CLOCK * sm_clock_hz) * 1e3,
             "bytes_ms": nbytes / MEM_BYTES_PER_S * 1e3}
    by = max(times, key=times.get)
    return {"ms": times[by], "by": "bytes" if by == "bytes_ms" else "operations", **times}


def time_decoder(dev, s: int, n: int, k: int, d: int, h1: int, h2: int, dd: int,
                 reps: int = 10) -> dict:
    """CUDA-event ms per call at these shapes (``device_ms``):
    ``{kernel,plain}_{fwd,bwd}`` for the kernels (forward; the backward
    alone, autograd over a retained graph) and the plain version, and
    ``unfused_{fwd,fwdbwd}`` for the unfused bf16 decoder the kernels
    replace (``nets.bernoulli_loglik_decomposed`` with
    ``compute_dtype=torch.bfloat16``, cuBLAS products; forward, and forward
    + backward). At the bigk shape each call keeps the card busy for
    milliseconds, so the event time is its device time; ``torch.profiler``
    is not used here, as it has dropped device events late in a long
    process (PERF.md)."""
    from svax_torch.nets import mlp as nets
    from svax_torch.ops import decoder_mlp

    params, z, x, dll = decoder_inputs(dev, s, n, k, d, h1, h2, dd)
    leaves = [z.clone().requires_grad_(True)] + [
        t.clone().requires_grad_(True) for ly in params for t in (ly["w"], ly["b"])]
    ps = [{"w": leaves[1 + 2 * i], "b": leaves[2 + 2 * i]} for i in range(3)]
    out = {}
    for name, fn in (
            ("kernel", lambda: decoder_mlp.bernoulli_mlp_loglik_fused(ps, leaves[0], x)),
            ("plain", lambda: decoder_mlp.bernoulli_mlp_loglik_plain(ps, leaves[0], x)),
            ("unfused", lambda: nets.bernoulli_loglik_decomposed(
                ps, leaves[0], x, compute_dtype=torch.bfloat16))):
        loss = (fn() * dll).sum()

        def forward(fn=fn):
            with torch.no_grad():
                fn()

        def backward(loss=loss):
            torch.autograd.grad(loss, leaves, retain_graph=True)

        def both(fn=fn):
            torch.autograd.grad((fn() * dll).sum(), leaves)

        out[f"{name}_fwd"] = device_ms(forward, reps)
        if name == "unfused":
            out[f"{name}_fwdbwd"] = device_ms(both, reps)
        else:
            out[f"{name}_bwd"] = device_ms(backward, reps)
    return out


# The row-sum kernels against their plain version, at the reference kernel
# test's bars (tests/test_kernel_interpret.py:82, :101): s at rtol = atol =
# 2e-5 (reported as |Δ| / (1 + |ref|)), and each gradient within 5e-5 of its
# largest entry. In the "default" mode both sides round do = −σ(o)·s̄ to bf16
# after forming o in other orders (the kernel's FMA chain, cuBLAS), so a do
# entry within an ulp of a rounding tie rounds the other way on one side,
# which moves its row of H̄ by one bf16 ulp of one term of its D-long sum:
# H̄ is then held within 5e-3 of its largest entry (2⁻⁸ of a term's size),
# with under 20% of its entries beyond 5e-5; W̄ and b̄ (b̄ sums the f32 do) keep
# the f32 bar.
ROWSUM_TOL = {"s": 2e-5, "grad": 5e-5, "hbar max bf16": 5e-3, "hbar share bf16": 0.2}


def rowsum_inputs(dev, m: int, dh: int, d: int, seed: int = 0):
    """Seeded decoder-like operands on ``dev``: rows h = tanh(N(0, 1)) (M,
    Dh), a Glorot-scaled last layer w (Dh, D), a bias of scale 0.1 and a
    non-uniform cotangent s̄ = sin(3·N(0, 1)) (M,)."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    h = torch.tensor(np.tanh(rng.standard_normal((m, dh))), **f32)
    w = torch.tensor(rng.standard_normal((dh, d)) * np.sqrt(2.0 / (dh + d)), **f32)
    b = torch.tensor(0.1 * rng.standard_normal(d), **f32)
    sbar = torch.tensor(np.sin(3.0 * rng.standard_normal(m)), **f32)
    return h, w, b, sbar


def rowsum_grads(fn, h, w, b, sbar, precision: str):
    """s and the gradients (H̄, W̄, b̄) of ⟨s, s̄⟩ through ``fn``
    (``rowsum_logsig_neg`` or ``rowsum_logsig_neg_plain``)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (h, w, b)]
    s = fn(*leaves, precision)
    return s.detach(), torch.autograd.grad((s * sbar).sum(), leaves)


def rowsum_errors(h, w, b, sbar, precision: str) -> dict:
    """The kernels against the plain version on the same inputs, in the
    measures of ROWSUM_TOL: "s", and per gradient ("hbar", "wbar", "bbar")
    its largest |Δ| over its largest entry and the share of entries beyond
    5e-5 of that; plus "s max abs" and "grad max abs"."""
    from svax_torch.ops import decoder

    s_k, g_k = rowsum_grads(decoder.rowsum_logsig_neg, h, w, b, sbar, precision)
    torch.cuda.synchronize()
    s_p, g_p = rowsum_grads(decoder.rowsum_logsig_neg_plain, h, w, b, sbar, precision)
    diff = (s_k.double() - s_p.double()).abs()
    errs = {"s": float((diff / (1.0 + s_p.double().abs())).max()), "s max abs": float(diff.max())}
    errs["grad max abs"] = 0.0
    for name, got, ref in zip(("hbar", "wbar", "bbar"), g_k, g_p):
        delta = (got.double() - ref.double()).abs()
        scale = float(ref.abs().max())
        errs[name] = float(delta.max()) / scale
        errs[f"{name} share > 5e-5"] = float((delta > 5e-5 * scale).double().mean())
        errs["grad max abs"] = max(errs["grad max abs"], float(delta.max()))
    errs["finite"] = all(bool(torch.isfinite(t).all()) for t in (s_k, *g_k))
    return errs


# The f32 mode's products against the plain version evaluated in f64: H̄
# and W̄ each within 2e-6 of its largest entry. f32-accurate products meet
# it (the kernels' six-term three-part products 1.5e-7–7.6e-7, cuBLAS's f32
# 1.9e-6 at the bigk shape, on an H100); products of two-part bf16 splits
# (three terms, within ~2⁻¹⁶) do not (~5e-6). b̄, a sum of the f32 do over
# the M rows, is left to ROWSUM_TOL.
ROWSUM_F64_TOL = 2e-6


# The f32 mode's row sums s against the plain version in f64: |Δs| within
# 1e-7 of 1 + |s|, about two half-ulps of an f32 s at the decoder's sizes
# (|s| ~ 550 at D = 784). f32-accurate products with an exact row sum of the
# f32 logσ values meet it (an emulation of the kernel's three-part products
# on the CPU: 5.7e-8 at M = 1,000, Dh = 200, D = 784); two-part products do
# not (1.6e-7), nor the plain version's f32 row sum on the CPU (1.6e-7). On
# the card the kernel is held to twice the plain f32 version's error.
ROWSUM_S_F64_TOL = 1e-7


def rowsum_s_f64_error(s, h, w, b) -> float:
    """max |s − s_f64| / (1 + |s_f64|) over the rows, s_f64 the plain
    version in f64 on the same inputs."""
    from svax_torch.ops import decoder

    ref = decoder.rowsum_logsig_neg_plain(*(t.double() for t in (h, w, b)), "highest")
    return float(((s.double() - ref).abs() / (1.0 + ref.abs())).max())


def rowsum_f64_errors(grads, h, w, b, sbar) -> dict:
    """H̄ and W̄ of ``grads`` (``rowsum_grads``' gradients at "highest")
    against the plain version in f64 on the same inputs: the largest |Δ|
    over the largest entry, by name."""
    from svax_torch.ops import decoder

    ref = rowsum_grads(decoder.rowsum_logsig_neg_plain, *(t.double() for t in (h, w, b, sbar)),
                       "highest")[1]
    return {name: float((got.double() - want).abs().max()) / float(want.abs().max())
            for name, got, want in zip(("hbar", "wbar"), grads, ref)}


def rowsum_failures(errs: dict, precision: str) -> list:
    """The measures of ``rowsum_errors`` outside ROWSUM_TOL."""
    bars = [("s", ROWSUM_TOL["s"]), ("wbar", ROWSUM_TOL["grad"]), ("bbar", ROWSUM_TOL["grad"])]
    if precision == "highest":
        bars.append(("hbar", ROWSUM_TOL["grad"]))
    else:
        bars += [("hbar", ROWSUM_TOL["hbar max bf16"]),
                 ("hbar share > 5e-5", ROWSUM_TOL["hbar share bf16"])]
    bad = [(name, errs[name], bar) for name, bar in bars if not errs[name] <= bar]
    return bad + ([("finite", False, True)] if not errs["finite"] else [])


# One H100 SXM (data sheet): the dense TF32 tensor-core peak. An f32-accurate
# product on the tensor cores takes three TF32 passes (hi·hi + hi·lo +
# lo·hi) or six bf16 passes (a three-part split's terms of order < 3).
TF32_FLOPS = 495e12


def rowsum_bound(m: int, dh: int, d: int, backward: bool, bf16: bool,
                 sm_clock_hz: float) -> dict:
    """The least time for the row sum (or its backward) at these shapes, as
    the largest of three: its products (2 FLOP per multiply-add; the
    backward recomputes o and adds H̄ and W̄: three products) at the fastest
    way the card has to form them — the bf16 tensor-core peak in the bf16
    mode; in the f32 mode the least of the 67 TFLOP/s f32 peak, three TF32
    passes and six bf16 passes (``products_by`` names it); its special
    functions (logσ as an exp and a log; σ as an exp and a reciprocal) over
    the special-function units at ``sm_clock_hz``; its bytes (H, W, b read
    and s written; backward: H, W, b, s̄ read and H̄, W̄, b̄ written; f32)
    over the memory rate. Returns {"ms", "by", "products_by", "products_ms",
    "special_ms", "bytes_ms"}."""
    flops = 2 * m * dh * d * (3 if backward else 1)
    special = 2 * m * d
    nbytes = 4 * ((2 * m * dh + 2 * dh * d + 2 * d + m) if backward
                  else (m * dh + dh * d + d + m))
    ways = ({"bf16": flops / BF16_FLOPS} if bf16 else
            {"f32": flops / F32_FLOPS, "tf32x3": 3 * flops / TF32_FLOPS,
             "bf16x6": 6 * flops / BF16_FLOPS})
    way = min(ways, key=ways.get)
    times = {"products_ms": ways[way] * 1e3,
             "special_ms": special / (SFU_PER_CLOCK * sm_clock_hz) * 1e3,
             "bytes_ms": nbytes / MEM_BYTES_PER_S * 1e3}
    by = max(times, key=times.get)
    return {"ms": times[by], "by": "bytes" if by == "bytes_ms" else "operations",
            "products_by": way, **times}


def unfused_rowsum(h, w, b):
    """The row sum the kernels replace: the f32 logits through cuBLAS and
    ``F.logsigmoid``, differentiated by autograd."""
    return torch.nn.functional.logsigmoid(-(h @ w + b)).sum(dim=-1)


def time_rowsum(dev, m: int, dh: int, d: int, precision: str, reps: int = 10) -> dict:
    """CUDA-event ms per call at these shapes in this mode (``device_ms``):
    ``{kernel,plain,unfused}_{fwd,bwd}`` for the kernels (forward; the
    backward alone, autograd over a retained graph), the plain version and
    the unfused f32 row sum (``unfused_rowsum``). At the bigk shape each
    call keeps the card busy for milliseconds, so the event time is its
    device time; ``torch.profiler`` is not used here, as it has dropped
    device events late in a long process (PERF.md, PR 8)."""
    from svax_torch.ops import decoder

    h, w, b, sbar = rowsum_inputs(dev, m, dh, d)
    leaves = [t.clone().requires_grad_(True) for t in (h, w, b)]
    out = {}
    for name, fn in (("kernel", lambda *a: decoder.rowsum_logsig_neg(*a, precision)),
                     ("plain", lambda *a: decoder.rowsum_logsig_neg_plain(*a, precision)),
                     ("unfused", unfused_rowsum)):
        loss = (fn(*leaves) * sbar).sum()

        def forward(fn=fn):
            with torch.no_grad():
                fn(*leaves)

        out[f"{name}_fwd"] = device_ms(forward, reps)
        out[f"{name}_bwd"] = device_ms(
            lambda loss=loss: torch.autograd.grad(loss, leaves, retain_graph=True), reps)
    return out


def bigk_f32_setup(dev, fused_decoder: bool, seed: int = 0, nn_precision: str = "high",
                   graph: bool | None = None):
    """The big-K f32 step at benchmarks/mfu.py's bigk-single-chip shape:
    bigk-dp's widths and recipe (K = 100, d = 10, S = 1, 200-200,
    minibatches of 1024 without replacement, the fused combine with
    in-kernel ε) with an f32 decoder, the fused MLP decoder off and the row
    sum in the kernels or not, at ``nn_precision`` (the default "high" runs
    the row sum's bf16-operand mode, "highest" its f32 mode); returns
    (runner, state, x_train) on ``dev`` (``loop.make_step_runner``, kernel
    engine, ``graph`` its route: None a CUDA graph, False the eager loop)."""
    from svax_torch.configs import CONFIGS
    from svax_torch.data import load_dataset
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import loop, svae_step

    cfg = CONFIGS["bigk-dp"]
    train, _, meta = load_dataset(cfg["dataset"], seed=seed)
    x = torch.tensor(train, dtype=torch.float32, device=dev)
    config = SvaeConfig(latent_dim=cfg["latent_dim"], num_components=cfg["num_components"],
                        num_samples=cfg["num_samples"], num_total=x.shape[0],
                        likelihood=meta["likelihood"], nn_compute_dtype="float32",
                        fused_combine=cfg["fused_combine"], kernel_rng=cfg["kernel_rng"],
                        fused_decoder=fused_decoder, nn_precision=nn_precision)
    prior = gmm.make_prior(config.num_components, config.latent_dim, alpha=cfg["alpha"],
                           kappa=cfg["kappa"], device=dev)
    state = svae_step.init_state(torch.Generator(device=dev).manual_seed(seed), x.shape[1],
                                 config, prior, tuple(cfg["encoder_hidden"]),
                                 tuple(cfg["decoder_hidden"]))
    runner = loop.make_step_runner(config, prior, lr=cfg["lr"], rho=cfg["rho"],
                                   rho_decay=cfg["rho_decay"], batch_size=cfg["batch_size"],
                                   replace=False, graph=graph)
    return runner, state, x


def bigk_f32_rates(dev, steps: int = 100, profiled_steps: int = 20) -> dict:
    """Steps/s of the big-K f32 step with the row sum unfused and fused, in
    turns (unfused, fused, fused, unfused; ``steps`` each, timed to a
    synchronise after 5 warm steps), then ``profiled_steps`` of each under
    ``torch.profiler``: wall and device ms a step, the idle share and the
    row-sum kernels' device ms a step. Returns {"unfused": {...}, "fused":
    {...}} with "rates" (both turns), "wall_ms", "device_ms", "idle",
    "rowsum_ms"."""
    import time

    out = {"unfused": {"rates": []}, "fused": {"rates": []}}
    setups = {name: bigk_f32_setup(dev, name == "fused") for name in out}
    for name in ("unfused", "fused", "fused", "unfused"):
        runner, state, x = setups[name]
        state, _ = runner(state, x, 5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner(state, x, steps)
        torch.cuda.synchronize()
        out[name]["rates"].append(steps / (time.perf_counter() - t0))
    for name, r in out.items():
        runner, state, x = setups[name]
        wall, prof = profiled(lambda: runner(state, x, profiled_steps))
        busy = device_us(prof) / 1e3
        r.update(wall_ms=wall / profiled_steps, device_ms=busy / profiled_steps,
                 idle=1.0 - busy / wall,
                 rowsum_ms=device_us(prof, "rowsum_") / 1e3 / profiled_steps)
    return out


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def profile_entry(argv: list[str]) -> dict:
    """Run ``train_svae.main`` once to warm (5 steps), then ``argv`` once
    under the profiler: wall ms, device ms, idle share, the combine kernels'
    device ms, steps/s of the profiled run, and the profile. Building the
    profile costs host time per event: keep ``--steps`` to tens of steps
    on the plain engine (thousands of kernels a step)."""
    from svax_torch import train_svae

    train_svae.main([*argv, "--steps", "5"])
    result = {}

    def run():
        result["out"] = train_svae.main(argv)

    wall, prof = profiled(run)
    busy = device_us(prof) / 1e3
    # The combine's kernels: combine_fwd, combine_bwd_* and their
    # reduce_planes; decoder_mlp.cu's: decoder_fwd, the backward's mlp_*
    # kernels and reduce_partials.
    comb = (device_us(prof, "combine_") + device_us(prof, "reduce_planes")) / 1e3
    dec = (device_us(prof, "decoder_") + device_us(prof, "mlp_")
           + device_us(prof, "reduce_partials")) / 1e3
    return {"wall_ms": wall, "device_ms": busy, "idle": 1.0 - busy / wall,
            "combine_ms": comb, "decoder_ms": dec,
            "steps_per_s": result["out"]["steps_per_s"], "prof": prof}


def quality(out: dict, seed: int, head: str = "diag") -> tuple[float, int]:
    """Cluster purity of the test set (argmax of r̃ under the trained
    naturals against the labels) and the components in use by argmax, for
    a ``train_svae.main`` result on the mnist data at ``seed`` whose
    encoder has the recognition head ``head``."""
    from svax_torch.data import load_mnist
    from svax_torch.models import evaluation
    from svax_torch.models.svae import sin_combine
    from svax_torch.nets import mlp as nets
    from svax_torch.pgm import gmm

    labels = load_mnist(seed=seed, return_labels=True)[4]
    state, x_test = out["state"], out["x_test"]
    with torch.no_grad():
        pot_h, pot_p = nets.encoder_apply(state.nn_params["encoder"], x_test, head=head)
        post = sin_combine(pot_h, pot_p, gmm.expected_params(state.pgm_nat))
    purity = evaluation.cluster_purity(torch.exp(post.log_resp), labels)
    return purity, int(torch.unique(post.log_resp.argmax(-1)).numel())


def _entry_profiles(config: str, runs) -> None:
    """Steps/s of ``train_svae --config config`` without the warmup, then the
    profiled runs: (engine, steps, profiled steps) per entry of ``runs``."""
    from svax_torch import train_svae

    for engine, steps, profiled_steps in runs:
        argv = ["--config", config, "--warmup-steps", "0", "--device", "cuda",
                "--engine", engine, "--iw-samples", "0"]
        rate = train_svae.main([*argv, "--steps", str(steps)])["steps_per_s"]
        print(f"== train_svae {config} {engine}, {steps} steps: {rate:.1f} steps/s",
              flush=True)
        r = profile_entry([*argv, "--steps", str(profiled_steps)])
        print(f"== train_svae {config} {engine}, {profiled_steps} steps: "
              f"{r['steps_per_s']:.1f} "
              f"steps/s under the profiler, wall {r['wall_ms']:.1f} ms, device "
              f"{r['device_ms']:.3f} ms, idle share {100 * r['idle']:.1f}%, combine "
              f"{r['combine_ms']:.3f} ms ({100 * r['combine_ms'] / r['device_ms']:.1f}% of "
              f"device time), decoder kernels {r['decoder_ms']:.3f} ms "
              f"({100 * r['decoder_ms'] / r['device_ms']:.1f}%)", flush=True)
        print(r["prof"].key_averages().table(sort_by="self_cuda_time_total", row_limit=12),
              flush=True)


COMBINE_CHILD = f"""
import json, runpy
mod = runpy.run_path({str(Path(__file__).resolve())!r}, run_name="measure_mnist_child")
print("RESULT " + json.dumps(mod["combine_times"]()), flush=True)
"""


def measure_combine(card: str, parent: Path | None) -> int:
    """``--combine``: the combine kernels at COMBINE_SHAPES and the ρ-kernel
    at RHO_SHAPES in both configurations, each tree in a child process of its
    own through its own wrappers (``combine_times``), in turns parent, this
    tree, this tree, parent (this tree twice without ``--parent``); each
    number beside its bound. Then the ptxas lines of each tree's combine and
    ρ-kernels and the cotangents the train steps pass (``combine_paths``,
    this tree)."""
    from svax_torch.measure_steps import run_child

    root = Path(__file__).resolve().parents[1]
    trees = [("new", root), ("new", root)]
    if parent is not None:
        trees = [("parent", parent.resolve()), *trees, ("parent", parent.resolve())]
    per: dict = {}
    ptxas: dict = {}
    for who, tree in trees:
        res = run_child(tree, COMBINE_CHILD, [])
        ptxas.setdefault(who, res["ptxas"])
        for label, t in res["times"].items():
            for key, val in t.items():
                per.setdefault(label, {}).setdefault(key, {}).setdefault(who, []).append(val)
    for label, keys in per.items():
        if label.startswith("rho "):
            n, k, d = RHO_SHAPES[label[len("rho "):]]
            bounds = {"fwd": rho_bound(n, k, d, False),
                      "bwd_a": rho_bound(n, k, d, True, main_path=True),
                      "bwd_b": rho_bound(n, k, d, True)}
            print(json.dumps({"rho": label[len("rho "):], "shape": [n, k, d], "ms": keys,
                              "bound_ms": {p: b[0] for p, b in bounds.items()},
                              "bound_by": {p: b[1] for p, b in bounds.items()}, "card": card}),
                  flush=True)
            continue
        n, k, d, s = COMBINE_SHAPES[label]
        norm = label == "bigk K-shard"
        bounds = {"fwd": combine_bound(n, k, d, s, False, norm),
                  "bwd_a": combine_bound(n, k, d, s, True, norm, main_path=True),
                  "bwd_b": combine_bound(n, k, d, s, True, norm)}
        print(json.dumps({"combine": label, "shape": [n, k, d, s], "log_norm": norm,
                          "ms": keys, "bound_ms": {p: b[0] for p, b in bounds.items()},
                          "bound_by": {p: b[1] for p, b in bounds.items()}, "card": card}),
              flush=True)
    for who, lines in ptxas.items():
        for line in lines:
            print(f"ptxas ({who}): {line}", flush=True)
    print(json.dumps({"backward_paths": combine_paths(), "card": card}), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", choices=["mnist-svae", "bigk-dp"], default="mnist-svae")
    p.add_argument("--fused-decoder", action="store_true",
                   help="the row-sum kernels and the big-K f32 step with and without "
                        "them (measure_fused_decoder)")
    p.add_argument("--combine", action="store_true",
                   help="the combine kernels alone, in both configurations "
                        "(measure_combine)")
    p.add_argument("--parent", type=Path, default=None,
                   help="with --combine: another checkout, timed in turns with this one")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure_mnist: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    if args.combine:
        return measure_combine(card, args.parent)
    if args.fused_decoder:
        return measure_fused_decoder(dev)
    if args.config == "bigk-dp":
        return measure_bigk(dev)
    for label, shape in (("mnist", (256, 10, 8, 1)), ("bigk", (1024, 100, 10, 1)),
                         ("mnist again", (256, 10, 8, 1))):
        t = time_combine(dev, *shape)
        fb = combine_bound(*shape, backward=False)
        ba = combine_bound(*shape, backward=True, main_path=True)
        bb = combine_bound(*shape, backward=True)
        print(f"combine {label} N,K,d,S={shape}: " + ", ".join(
            f"{key} {val:.4f} ms" for key, val in t.items())
            + f"; bound fwd {fb[0] * 1e3:.3f} us ({fb[1]}), bwd (a) {ba[0] * 1e3:.3f} us "
            f"({ba[1]}), bwd (b) {bb[0] * 1e3:.3f} us ({bb[1]})", flush=True)
    _entry_profiles("mnist-svae", (("kernel", 1000, 200), ("plain", 40, 10)))
    return 0


def measure_bigk(dev) -> int:
    """``--config bigk-dp``: the decoder kernels at the bigk and mnist
    shapes against their plain version, the unfused bf16 decoder and their
    bound; the entry's steps/s and profile without the warmup (200 and 50
    steps on the kernel engine, 10 and 5 on the plain one); then the full
    horizon once at seed 0 (the config's 1000 warmup and 5000 joint steps,
    the 100-sample IW bound) with its purity and components in use."""
    from svax_torch import train_svae

    clock = sm_clock_hz()
    for label, shape in (("bigk", (1, 1024, 100, 10, 200, 200, 784)),
                         ("mnist", (1, 256, 10, 8, 200, 200, 784))):
        t = time_decoder(dev, *shape)
        fb, bb = (decoder_bound(*shape, backward=b, sm_clock_hz=clock) for b in (False, True))
        print(f"decoder_mlp {label} S,N,K,d,H1,H2,D={shape}: " + ", ".join(
            f"{key} {val:.4f} ms" for key, val in t.items())
            + f"; bound fwd {fb['ms'] * 1e3:.2f} us ({fb['by']}; products "
            f"{fb['products_ms'] * 1e3:.2f}, special functions {fb['special_ms'] * 1e3:.2f}, "
            f"bytes {fb['bytes_ms'] * 1e3:.2f} us), bwd {bb['ms'] * 1e3:.2f} us ({bb['by']}; "
            f"products {bb['products_ms'] * 1e3:.2f}, special functions "
            f"{bb['special_ms'] * 1e3:.2f}, bytes {bb['bytes_ms'] * 1e3:.2f} us) at "
            f"{clock / 1e6:.0f} MHz", flush=True)
    _entry_profiles("bigk-dp", (("kernel", 200, 50), ("plain", 10, 5)))
    out = train_svae.main(["--config", "bigk-dp", "--device", "cuda", "--seed", "0"])
    purity, used = quality(out, 0)
    rows = out["rows"]
    print(f"== bigk-dp full horizon, seed 0: warmup {out['warmup']['seconds']:.1f} s (seed "
          f"occupancy {out['warmup']['seed_occupancy']}), {len(rows)} rows, "
          f"{out['steps_per_s']:.1f} steps/s, test ELBO/pt "
          f"{out['init_test_elbo_per_point']:.4f} -> {rows[-1]['test_elbo_per_point']:.4f}, "
          f"IW/pt {out['final_test_iw_loglik_per_point']:.4f}, purity {purity:.4f}, "
          f"{used} of 100 components in use", flush=True)
    return 0


def measure_fused_decoder(dev) -> int:
    """``--fused-decoder``: the row-sum kernels in both modes at the bigk (M
    = 102,400) and mnist (M = 2,560) shapes (Dh = 200, D = 784) against
    their plain version, the unfused f32 row sum and their bound; then the
    big-K f32 step (``bigk_f32_rates``) with the row sum unfused and fused."""
    clock = sm_clock_hz()
    for label, m in (("bigk", 102400), ("mnist", 2560)):
        for precision in ("highest", "default"):
            t = time_rowsum(dev, m, 200, 784, precision)
            fb, bb = (rowsum_bound(m, 200, 784, backward=b_, bf16=precision != "highest",
                                   sm_clock_hz=clock) for b_ in (False, True))
            print(f"rowsum {label} M,Dh,D={(m, 200, 784)} {precision}, CUDA-event ms per "
                  "call: " + ", ".join(
                f"{key} {val:.4f} ms" for key, val in t.items())
                + f"; bound fwd {fb['ms'] * 1e3:.2f} us ({fb['by']}; products "
                f"{fb['products_ms'] * 1e3:.2f} as {fb['products_by']}, special functions "
                f"{fb['special_ms'] * 1e3:.2f}, bytes {fb['bytes_ms'] * 1e3:.2f} us), bwd "
                f"{bb['ms'] * 1e3:.2f} us ({bb['by']}; products {bb['products_ms'] * 1e3:.2f} as "
                f"{bb['products_by']}, special functions "
                f"{bb['special_ms'] * 1e3:.2f}, bytes {bb['bytes_ms'] * 1e3:.2f} us) at "
                f"{clock / 1e6:.0f} MHz", flush=True)
    rates = bigk_f32_rates(dev)
    for name, r in rates.items():
        print(f"== big-K f32 step, row sum {name}: "
              + " / ".join(f"{v:.1f}" for v in r["rates"]) + " steps/s (100 steps, two "
              f"turns); 20 profiled steps: wall {r['wall_ms']:.3f} ms, device "
              f"{r['device_ms']:.3f} ms a step, idle share {100 * r['idle']:.1f}%, row-sum "
              f"kernels {r['rowsum_ms']:.3f} ms a step", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
