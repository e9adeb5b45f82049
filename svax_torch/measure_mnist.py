"""Measure the mnist-svae path on one CUDA card: the numbers behind
PERF.md's mnist-svae breakdown.

    python -m svax_torch.measure_mnist > measure_mnist.txt

Run from the root of a checkout; needs one CUDA device and nvcc. Prints
the card, then two parts (every time a median of 3):

1. the combine kernels at the mnist shape (N=256, K=10, d=8, S=1) and the
   bigk shape (N=1024, K=100, d=10, S=1): ms per call of the forward (in-
   kernel ε, as the main path runs it) and of the backward alone (autograd's
   backward over a retained graph), as device time under the profiler and
   as CUDA-event time per call, beside the plain version's (injected ε),
   and each beside its bound (``combine_bound``);
2. ``train_svae --config mnist-svae`` without the warmup: 1000 steps on
   the kernel engine and 40 on the plain engine for their rates, then 200
   and 10 steps under ``torch.profiler``: wall time, device time (the sum
   of the card's kernel times), the idle share 1 − device/wall, the
   combine kernels' device time and share, and the ten kernels with the
   most device time. The profiler's own cost is in the wall time.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from svax_torch.measure_mixture import device_ms, device_us, profiled

# One H100 SXM (data sheet): f32 outside the tensor cores, device memory.
F32_FLOPS = 67e12
MEM_BYTES_PER_S = 3.35e12


def combine_bound(n: int, k: int, d: int, s: int, backward: bool) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time for the combine forward
    (or its backward) at these shapes — each input read once, each output
    written once, in float32; operations per (n, k) counted from the
    algorithm: Cholesky, L̃⁻¹ and Σ̃ ~d³/3 each, the two solves for μ̃ and
    one per sample 2d² each, the local KL and the statistics ~4d²; the
    backward recomputes the forward (without writing it) and adds ~2d³ +
    (2S + 8)d² for the Cholesky backward, Σ̃Σ̄Σ̃ and the dw row."""
    f, w = 1 + d + d * d, 3 + d + d * d
    fwd_ops = d ** 3 + (2 * s + 8) * d * d + 20 * d
    if backward:
        ops = n * k * (fwd_ops + 2 * d ** 3 + (2 * s + 8) * d * d)
        nbytes = 4 * (2 * n * d + k * w                     # pot_h, pot_p, w
                      + s * n * k * d + n * k + n * k * d + n + k * f  # cotangents
                      + 2 * n * d + k * w)                  # dpot_h, dpot_p, dw
    else:
        ops = n * k * fwd_ops
        nbytes = 4 * (2 * n * d + k * w
                      + s * n * k * d + n * k + n * k * d + n + k * f)  # z, log r̃, μ̃, local, stats
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


def time_combine(dev, n: int, k: int, d: int, s: int, reps: int = 20) -> dict:
    """ms per call of the forward and of the backward alone (autograd over a
    retained graph), for the kernels (in-kernel ε) and the plain version
    (injected ε): ``*_device`` is the card's kernel time per call under
    ``torch.profiler`` (for the kernels, combine.cu's own: combine_fwd or
    combine_bwd and its reduce_blocks), ``*_call`` the CUDA-event time per
    call, which includes the host's gaps between launches. The plain
    version, thousands of small kernels a call, runs a quarter of the
    repetitions."""
    from svax_torch.ops import combine

    pot_h, pot_p, exp, eps = combine_inputs(dev, n, k, d, s)
    leaves = [t.clone().requires_grad_(True) for t in (pot_h, pot_p, *exp)]
    out = {}
    for name, fn, n_rep in (
            ("kernel", lambda a, b, e: combine.combine_fused(a, b, e, None, s, seed=1, step=0),
             reps),
            ("plain", lambda a, b, e: combine.combine_fused_plain(a, b, e, eps, s),
             max(1, reps // 4))):
        args = (leaves[0], leaves[1], type(exp)(*leaves[2:]))
        z, lr, mean, local, st = fn(*args)
        loss = (z.sum() + lr.sum() + mean.sum() + local.sum() + st.counts.sum()
                + st.mean_stat.sum() + st.scatter_stat.sum())

        def forward():
            with torch.no_grad():
                fn(*args)

        def backward():
            torch.autograd.grad(loss, leaves, retain_graph=True)

        for part, call, kernel_name in (("fwd", forward, "combine_fwd"),
                                        ("bwd", backward, "combine_bwd")):
            out[f"{name}_{part}_call"] = device_ms(call, n_rep)
            _, prof = profiled(lambda: [call() for _ in range(n_rep)])
            if name == "kernel":
                busy = device_us(prof, kernel_name) + device_us(prof, "reduce_blocks")
            else:
                busy = device_us(prof)
            out[f"{name}_{part}_device"] = busy / 1e3 / n_rep
    return out


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
    # combine.cu's kernels: combine_fwd, combine_bwd and their reduce_blocks.
    comb = (device_us(prof, "combine_") + device_us(prof, "reduce_blocks")) / 1e3
    return {"wall_ms": wall, "device_ms": busy, "idle": 1.0 - busy / wall,
            "combine_ms": comb, "steps_per_s": result["out"]["steps_per_s"], "prof": prof}


def main() -> int:
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
    for label, shape in (("mnist", (256, 10, 8, 1)), ("bigk", (1024, 100, 10, 1)),
                         ("mnist again", (256, 10, 8, 1))):
        t = time_combine(dev, *shape)
        fb, bb = combine_bound(*shape, backward=False), combine_bound(*shape, backward=True)
        print(f"combine {label} N,K,d,S={shape}: " + ", ".join(
            f"{key} {val:.4f} ms" for key, val in t.items())
            + f"; bound fwd {fb[0] * 1e3:.3f} us ({fb[1]}), bwd {bb[0] * 1e3:.3f} us "
            f"({bb[1]})", flush=True)
    from svax_torch import train_svae

    for engine, steps, profiled_steps in (("kernel", 1000, 200), ("plain", 40, 10)):
        argv = ["--config", "mnist-svae", "--warmup-steps", "0", "--device", "cuda",
                "--engine", engine, "--iw-samples", "0"]
        rate = train_svae.main([*argv, "--steps", str(steps)])["steps_per_s"]
        print(f"== train_svae mnist-svae {engine}, {steps} steps: {rate:.1f} steps/s",
              flush=True)
        r = profile_entry([*argv, "--steps", str(profiled_steps)])
        print(f"== train_svae mnist-svae {engine}, {profiled_steps} steps: "
              f"{r['steps_per_s']:.1f} "
              f"steps/s under the profiler, wall {r['wall_ms']:.1f} ms, device "
              f"{r['device_ms']:.3f} ms, idle share {100 * r['idle']:.1f}%, combine "
              f"{r['combine_ms']:.3f} ms ({100 * r['combine_ms'] / r['device_ms']:.1f}% of "
              f"device time)", flush=True)
        print(r["prof"].key_averages().table(sort_by="self_cuda_time_total", row_limit=10),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
