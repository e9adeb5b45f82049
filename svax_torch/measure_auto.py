"""Measure the auto-svae path on one CUDA card: the numbers behind
PERF.md's auto-svae breakdown.

    python -m svax_torch.measure_auto > measure_auto.txt

Run from the root of a checkout; needs one CUDA device and nvcc. Prints
the card, then three parts:

1. flexstep ms/step (median of 3 chunks of 200 steps, in-kernel noise) at
   the auto shape (M=64, d_in=8, d=4, K=10, S=4, 100-100) and with one
   size changed at a time — S, the hidden widths, K, M — each beside its
   FMA count per step, so the time can be split into a part that scales
   with the decoder rows K·S·M and one that does not;
2. ``train_svae --config auto-svae`` (1000 steps, kernel engine) run once
   to warm and once under ``torch.profiler``: wall time, device time, the
   device's idle share 1 − device/wall, and the flexstep kernel's time;
3. the quality over seeds: the test ELBO/pt of the initial state and after
   1000 steps for seeds 0–7 on the kernel engine and 0–1 on the plain
   engine (tests/test_auto_quality_pin.py's bar is −12.3, and a rise of
   more than 4 nats).
"""

from __future__ import annotations

import subprocess

import torch

from svax_torch.measure_mixture import device_ms, device_us, profiled


def mlp_fmas(widths, rows: int, input_grad: bool) -> int:
    """FMAs of a dense MLP's forward, activation backward and weight (and
    bias) gradients over ``rows`` rows; ``widths`` [in, h1, ..., out];
    ``input_grad``: the backward also reaches the input."""
    layers = list(zip(widths[:-1], widths[1:]))
    fwd = sum(i * o for i, o in layers)
    bwd = sum(i * o for i, o in layers[1:]) + (widths[0] * widths[1] if input_grad else 0)
    wgrad = sum((i + 1) * o for i, o in layers)
    return rows * (fwd + bwd + wgrad)


def step_fmas(d, d_in, k, s, m, h) -> int:
    """The MLP FMAs of one flexstep step: the decoder over K·S·M rows with
    its backward to z, the encoder over M rows."""
    return (mlp_fmas([d, h, h, 2 * d_in], k * s * m, True)
            + mlp_fmas([d_in, h, h, 2 * d], m, False))


def measure_kernel(dev) -> None:
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.ops import flexstep
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step

    base = dict(d=4, d_in=8, k=10, s=4, m=64, h=100)
    variants = [("auto shape", {}), ("S=1", {"s": 1}), ("S=8", {"s": 8}),
                ("hidden 50-50", {"h": 50}), ("K=5", {"k": 5}), ("M=32", {"m": 32}),
                ("auto shape again", {})]
    t_steps = 200
    for label, change in variants:
        c = {**base, **change}
        gen = torch.Generator().manual_seed(0)
        config = SvaeConfig(latent_dim=c["d"], num_components=c["k"], num_samples=c["s"],
                            num_total=352)
        prior = gmm.make_prior(c["k"], c["d"], kappa=0.05)
        state = svae_step.init_state(gen, c["d_in"], config, prior, (c["h"],) * 2,
                                     (c["h"],) * 2)
        state, prior = svae_step.state_to(state, dev), svae_step.nat_to(prior, dev)
        batches = torch.randn((t_steps, c["m"], c["d_in"]), generator=gen).to(dev)
        ms = device_ms(lambda: flexstep.train_chunk(
            state, prior, batches, lr=1e-3, rho=0.2, rho_decay=1e-3, num_total=352,
            num_samples=c["s"]), reps=1) / t_steps
        fma = step_fmas(c["d"], c["d_in"], c["k"], c["s"], c["m"], c["h"])
        print(f"flexstep {label} {c}: {ms:.4f} ms/step, {fma / 1e6:.1f} M FMA/step, "
              f"{fma / ms / 1e6:.1f} G FMA/s", flush=True)


def measure_entry() -> None:
    from svax_torch import train_svae

    argv = ["--config", "auto-svae", "--steps", "1000", "--device", "cuda",
            "--iw-samples", "0"]
    train_svae.main(argv)  # warm: build, caches
    wall, prof = profiled(lambda: train_svae.main(argv))
    busy = device_us(prof) / 1e3
    print(f"== train_svae auto-svae kernel, 1000 steps: wall {wall:.1f} ms under the "
          f"profiler, device time {busy:.3f} ms, idle share {100 * (1 - busy / wall):.1f}%, "
          f"flexstep {device_us(prof, 'flexstep_kernel') / 1e3:.3f} ms", flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=8),
          flush=True)


def measure_seeds() -> None:
    from svax_torch import train_svae

    for engine, seeds in (("kernel", range(8)), ("plain", range(2))):
        for seed in seeds:
            out = train_svae.main(["--config", "auto-svae", "--steps", "1000", "--device",
                                   "cuda", "--engine", engine, "--seed", str(seed),
                                   "--iw-samples", "0"])
            start = out["init_test_elbo_per_point"]
            end = out["rows"][-1]["test_elbo_per_point"]
            print(f"== seed {seed} {engine}: test ELBO/pt {start:.4f} -> {end:.4f} "
                  f"(rise {end - start:.4f}), {out['steps_per_s']:.1f} steps/s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("measure_auto: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    measure_kernel(torch.device("cuda", 0))
    measure_entry()
    measure_seeds()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
