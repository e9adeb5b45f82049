"""Measure the pure-mixture path on one CUDA card: the numbers behind
PERF.md's pinwheel-gmm breakdown.

    python -m svax_torch.measure_mixture > measure_mixture.txt

Run from the root of a checkout; needs one CUDA device and nvcc. Prints
the card, then three parts (every time is the median of 3, each part
measured twice in a row):

1. estep at N=400, K=10, d=2 and at N=65,536, K=128, d=10 (seeded numpy
   data as in chip_smoke.py phase 7): ms per call of the raw C entry on
   preallocated buffers, of ``stats_kernel`` (with its allocations), of
   the wrapper ``e_step_stats_fused`` and of the plain version; then the
   plain version's device time per call under ``torch.profiler``;
2. mixstep µs/step by unroll, in chunks of 10,000 steps, in the order
   1 2 4 8 8 4 2 1, for the GMM and the SMM (dof 4);
3. the entries (``train_gmm`` kernel engine, 300 steps; ``--engine plain
   --fused-kernel`` and ``--engine plain``, 100 steps; ``train_smm``
   kernel engine, 200 steps), each run once to warm and once under
   ``torch.profiler``: wall time, device time (the sum of the card's
   kernel times), the device's idle share 1 − device/wall, and the time
   in the mixstep and estep kernels. The profiler's own cost is in the
   wall time, so the rates here are below the entries' own.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch


def device_ms(fn, reps: int = 20) -> float:
    """Median device ms per call of fn() over 3 timed runs of ``reps``."""
    fn()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[1]


def device_us(prof, name: str = "") -> float:
    """Total device µs of the card's kernels in a profile (those whose name
    holds ``name``)."""
    total = 0.0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and name in evt.name:
            total += evt.time_range.elapsed_us()
    return total


def profiled(fn) -> tuple[float, torch.profiler.profile]:
    """Wall ms of one fn() under the profiler (to a synchronise), and the profile."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, prof


def measure_estep(dev) -> None:
    from svax_torch.ops import _build, estep
    from svax_torch.pgm import gmm

    lib = _build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for n, k, d in ((400, 10, 2), (65536, 128, 10)):
        rng = np.random.default_rng(0)
        x = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32, device=dev)
        prior = gmm.make_prior(k, d, device=dev)
        exp = gmm.expected_params(gmm.init_variational(
            torch.Generator(device=dev).manual_seed(0), prior, x))
        w = estep.pack_coeffs(exp, dtype=torch.float32).contiguous()
        f = w.shape[0]
        kw = dict(device=dev, dtype=torch.float32)
        bufs = [torch.empty(lib.estep_blocks(n) * f * k, **kw), torch.empty((f, k), **kw),
                torch.empty((n,), **kw)]
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, w, *bufs)]

        def raw():
            _build.check(lib, lib.estep_stats(ptrs[0], n, d, k, ptrs[1], *ptrs[2:],
                                              stream), "estep_stats")

        for label, fn in (("raw C entry", raw),
                          ("stats_kernel", lambda: estep.stats_kernel(x, w)),
                          ("e_step_stats_fused", lambda: estep.e_step_stats_fused(x, exp)),
                          ("plain", lambda: estep.e_step_stats_reference(x, exp))):
            print(f"estep N={n} K={k} d={d}: {label} ms/call "
                  f"{[round(device_ms(fn), 5) for _ in range(2)]}", flush=True)
        reps = 10
        _, prof = profiled(lambda: [estep.e_step_stats_reference(x, exp)
                                     for _ in range(reps)])
        flops = 2 * 2 * n * f * k
        print(f"estep N={n} K={k} d={d}: plain version's kernels "
              f"{device_us(prof) / reps / 1e3:.4f} ms/call of device time; "
              f"{flops / 1e9:.3f} GFLOP per call (both products)", flush=True)


def measure_unroll(dev) -> None:
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.models.gmm_baseline import GmmTrainState
    from svax_torch.ops import mixstep
    from svax_torch.pgm import gmm
    from svax_torch.pgm.init import init_variational_kmeanspp

    train, _ = load_pinwheel(seed=0)
    x = torch.tensor(train, dtype=torch.float32, device=dev)
    prior_cpu = gmm.make_prior(10, 2, alpha=1.0, kappa=0.05)
    nat = init_variational_kmeanspp(prior_cpu, train, seed=0)
    to = lambda t: t.to(dev)  # noqa: E731
    nat = type(nat)(to(nat.dir_nat), type(nat.niw_nat)(*map(to, nat.niw_nat)))
    prior = type(prior_cpu)(to(prior_cpu.dir_nat),
                            type(prior_cpu.niw_nat)(*map(to, prior_cpu.niw_nat)))
    state, t_steps = GmmTrainState(nat=nat, step=0), 10_000
    for dof in (0.0, 4.0):
        out = [(u, round(device_ms(lambda: mixstep.train_chunk(
                    state, prior, x, rho=0.3, t_steps=t_steps, dof=dof, unroll=u),
                    reps=1) / t_steps * 1e3, 4))
               for u in (1, 2, 4, 8, 8, 4, 2, 1)]
        print(f"mixstep dof={dof} us/step by unroll (chunks of {t_steps}): {out}", flush=True)


def measure_entries() -> None:
    from svax_torch import train_gmm, train_smm

    gmm_argv = ["--config", "pinwheel-gmm", "--init", "kmeanspp", "--device", "cuda"]
    runs = [("train_gmm kernel, 300 steps", train_gmm.main, gmm_argv),
            ("train_gmm plain --fused-kernel, 100 steps", train_gmm.main,
             [*gmm_argv, "--engine", "plain", "--fused-kernel", "--steps", "100"]),
            ("train_gmm plain, 100 steps", train_gmm.main,
             [*gmm_argv, "--engine", "plain", "--steps", "100"]),
            ("train_smm kernel, 200 steps", train_smm.main,
             ["--init", "kmeanspp", "--device", "cuda", "--engine", "kernel"])]
    for label, main, argv in runs:
        main(argv)  # warm: build, caches
        wall, prof = profiled(lambda: main(argv))
        busy = device_us(prof) / 1e3
        print(f"== {label}: wall {wall:.1f} ms under the profiler, device time "
              f"{busy:.3f} ms, idle share {100 * (1 - busy / wall):.1f}%, mixstep "
              f"{device_us(prof, 'mixstep_kernel') / 1e3:.3f} ms, estep "
              f"{device_us(prof, 'estep') / 1e3:.3f} ms", flush=True)
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=8),
              flush=True)


def main() -> int:
    import subprocess

    if not torch.cuda.is_available():
        raise SystemExit("measure_mixture: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    measure_estep(dev)
    measure_unroll(dev)
    measure_entries()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
