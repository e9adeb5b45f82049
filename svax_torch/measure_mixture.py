"""Measure the pure-mixture path on one CUDA card: the numbers behind
PERF.md's pinwheel-gmm breakdown.

    python -m svax_torch.measure_mixture > measure_mixture.txt
    python -m svax_torch.measure_mixture --parent DIR > mixture.txt

Run from the root of a checkout; needs one CUDA device and nvcc. Prints
the card, then three parts (every time is the median of 3, each part
measured twice in a row):

1. estep at N=400, K=10, d=2 and at N=65,536, K=128, d=10 (seeded numpy
   data as in chip_smoke.py phase 7; ``time_estep``): the kernel alone
   (the card's time in the estep kernels per call, ``torch.profiler``), the
   kernels a call launches, the wrapper ``e_step_stats_fused`` back to back
   (CUDA events, the host's work between launches included) and the plain
   version (events and profiler), beside the bound (``estep_bound``);
2. mixstep µs/step by unroll, in chunks of 10,000 steps, in the order
   1 2 4 8 8 4 2 1, for the GMM and the SMM (dof 4);
3. the entries (``train_gmm`` kernel engine, 300 steps; ``--engine plain
   --fused-kernel`` and ``--engine plain``, 100 steps; ``train_smm``
   kernel engine, 200 steps), each run once to warm and once under
   ``torch.profiler``: wall time, device time (the sum of the card's
   kernel times), the device's idle share 1 − device/wall, and the time
   in the mixstep and estep kernels. The profiler's own cost is in the
   wall time, so the rates here are below the entries' own.

With ``--parent DIR`` it times mixstep µs a step (U = 1, GMM and SMM, at
N = 400 and N = 16,384, K = 10; ``mixstep_times``), part 1
(``estep_times``) and the steps/s of ``train_gmm --engine plain
--fused-kernel`` for this checkout and another one in turns (parent, this,
this, parent), each in a fresh process of its own through its own wrappers,
then prints each tree's ptxas lines for the mixstep kernels.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

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


# One H100 SXM (data sheet): f32 outside the tensor cores, dense TF32 on
# them, and device memory.
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
MEM_BYTES_PER_S = 3.35e12

# The shapes estep is timed at: the pinwheel-gmm batch (the main path's)
# and the design shape of benchmarks/bench_estep.py.
ESTEP_SHAPES = {"pinwheel": (400, 10, 2), "design": (65536, 128, 10)}


def estep_inputs(dev, n: int, k: int, d: int, seed: int = 0):
    """Seeded numpy data and a prior-plus-pseudo-points q on ``dev``."""
    from svax_torch.pgm import gmm

    x = torch.tensor(np.random.default_rng(seed).standard_normal((n, d)),
                     dtype=torch.float32, device=dev)
    prior = gmm.make_prior(k, d, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return x, gmm.expected_params(gmm.init_variational(gen, prior, x))


def estep_bound(n: int, k: int, d: int) -> dict:
    """The least time for one estep call: its two products over the folded
    features (2·2·N·F′·K, F′ = 1 + d + d(d+1)/2) as three TF32 passes on
    the tensor cores (the fastest f32-accurate product the card has), the
    softmax's ~5 operations per (n, k) beside them at the f32 rate, or its
    bytes (x and the expected parameters read, the statistics and the
    evidence written), whichever is longer. ``f32_fma_ms``: the same
    products over the unfolded F = 1 + d + d² as f32 FMAs, the earlier
    count."""
    f_fold, f_full = 1 + d + d * (d + 1) // 2, 1 + d + d * d
    ops_ms = (3 * 4 * n * f_fold * k / TF32_FLOPS + 5 * n * k / F32_FLOPS) * 1e3
    nbytes = 4 * (n * d + k * (3 + d + d * d) + k * (1 + d + d * d) + n)
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    return {"ms": max(ops_ms, bytes_ms), "by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "f32_fma_ms": 4 * n * f_full * k / F32_FLOPS * 1e3}


def time_estep(dev, n: int, k: int, d: int, reps: int = 20) -> dict:
    """One shape: ``kernel_ms``, the card's time in the kernels whose names
    hold "estep" per call (profiler: every launch of a call); ``kernels``,
    the device kernels a call runs, and ``estep_kernels``, those of estep
    (profiler, per call); ``wrapper_ms``, ``e_step_stats_fused`` back to
    back (CUDA events); ``plain_ms`` and ``plain_device_ms``, the plain
    version (events; profiler). Uses only the entries every tree has."""
    from svax_torch.ops import estep

    x, exp = estep_inputs(dev, n, k, d)
    fused = lambda: estep.e_step_stats_fused(x, exp)  # noqa: E731
    plain = lambda: estep.e_step_stats_reference(x, exp)  # noqa: E731
    out = {"wrapper_ms": device_ms(fused, reps), "plain_ms": device_ms(plain, reps)}
    # torch.profiler has dropped some of a profile's device events (a count
    # of estep launches that is not a multiple of the calls): profile again.
    for _ in range(3):
        _, prof = profiled(lambda: [fused() for _ in range(reps)])
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        launched = sum("estep" in e.name for e in events)
        if launched > 0 and launched % reps == 0:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded {launched} estep kernels for {reps} calls "
                           "three times: it recorded no device time for some")
    out["kernel_ms"] = device_us(prof, "estep") / 1e3 / reps
    out["kernels"] = len(events) / reps
    out["estep_kernels"] = launched / reps
    _, prof = profiled(lambda: [plain() for _ in range(reps)])
    out["plain_device_ms"] = device_us(prof) / 1e3 / reps
    return out


def estep_times() -> dict:
    """``time_estep`` at ESTEP_SHAPES with the svax_torch this process
    imports; ``--parent`` runs it in a child process per tree."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    return {label: time_estep(dev, *shape) for label, shape in ESTEP_SHAPES.items()}


def fused_entry_rate() -> dict:
    """Steps/s of ``train_gmm --engine plain --fused-kernel`` (300 steps,
    after one warm run) with the svax_torch this process imports."""
    from svax_torch import train_gmm

    argv = ["--config", "pinwheel-gmm", "--init", "kmeanspp", "--device", "cuda",
            "--engine", "plain", "--fused-kernel"]
    train_gmm.main(argv)
    return {"steps_per_s": train_gmm.main(argv)["steps_per_s"]}


def measure_estep(dev) -> None:
    for label, (n, k, d) in ESTEP_SHAPES.items():
        runs = [time_estep(dev, n, k, d) for _ in range(2)]
        print(json.dumps({"estep": label, "shape": [n, k, d],
                          "times": {key: [r[key] for r in runs] for key in runs[0]},
                          "bound": estep_bound(n, k, d)}), flush=True)


CHILD = f"""
import json, runpy, sys
mod = runpy.run_path({str(Path(__file__).resolve())!r}, run_name="measure_mixture_child")
print("RESULT " + json.dumps(mod[sys.argv[1]]()), flush=True)
"""


# mixstep is timed at the pinwheel-gmm batch (N=400, K=10) and at the
# kernel's largest N (16,384 pinwheel points), GMM and SMM (dof 4), U = 1:
# (N, dof, steps a chunk).
MIXSTEP_CASES = {"gmm N=400": (400, 0.0, 10_000), "smm N=400": (400, 4.0, 10_000),
                 "gmm N=16384": (16384, 0.0, 500), "smm N=16384": (16384, 4.0, 500)}


def mixstep_inputs(dev, n: int, k: int = 10, seed: int = 0):
    """pinwheel-gmm's prior and k-means++ naturals on N pinwheel points
    (the config's 400 training points at N = 400), on ``dev``."""
    from svax_torch.data.pinwheel import load_pinwheel, make_pinwheel_data
    from svax_torch.pgm import gmm
    from svax_torch.pgm.init import init_variational_kmeanspp

    x = (load_pinwheel(seed=seed)[0] if n == 400 else
         make_pinwheel_data(num_classes=5, num_per_class=-(-n // 5), seed=seed)[:n])
    prior = gmm.make_prior(k, 2, alpha=1.0, kappa=0.05)
    nat = init_variational_kmeanspp(prior, x, seed=seed)
    to = lambda nt: type(nt)(nt.dir_nat.to(dev), type(nt.niw_nat)(  # noqa: E731
        *(t.to(dev) for t in nt.niw_nat)))
    return torch.tensor(x, dtype=torch.float32, device=dev), to(prior), to(nat)


def mixstep_times() -> dict:
    """µs per step of mixstep (U = 1, CUDA events around one chunk, the
    median of 3) at MIXSTEP_CASES with the svax_torch this process imports,
    and the ptxas lines of its mixstep kernels: {"us_per_step": {case: µs},
    "ptxas": [...]}. Uses only the entries every tree has."""
    from svax_torch.measure_mnist import kernel_resources
    from svax_torch.models.gmm_baseline import GmmTrainState
    from svax_torch.ops import _build, mixstep

    dev = torch.device("cuda", 0)
    out = {}
    for label, (n, dof, steps) in MIXSTEP_CASES.items():
        x, prior, nat = mixstep_inputs(dev, n)
        state = GmmTrainState(nat=nat, step=0)
        out[label] = device_ms(lambda: mixstep.train_chunk(
            state, prior, x, rho=0.3, t_steps=steps, dof=dof), reps=1) / steps * 1e3
    return {"us_per_step": out, "ptxas": kernel_resources(_build.build_log, "mixstep_kernel")}


def measure_parent(card: str, parent: Path) -> int:
    """``--parent``: mixstep at MIXSTEP_CASES (``mixstep_times``), estep at
    ESTEP_SHAPES and the ``--fused-kernel`` entry's rate, each tree in a
    fresh process through its own wrappers, in turns parent, this tree,
    this tree, parent; then each tree's ptxas lines for mixstep."""
    from svax_torch.measure_steps import run_child

    root = Path(__file__).resolve().parents[1]
    trees = [("parent", parent.resolve()), ("new", root), ("new", root),
             ("parent", parent.resolve())]
    ptxas: dict = {}
    for func in ("mixstep_times", "estep_times", "fused_entry_rate"):
        per: dict = {}
        for who, tree in trees:
            res = run_child(tree, CHILD, [func])
            if func == "fused_entry_rate":
                res = {"train_gmm --engine plain --fused-kernel": res}
            if func == "mixstep_times":
                ptxas.setdefault(who, res["ptxas"])
                res = {f"mixstep {case}": {"us_per_step": us}
                       for case, us in res["us_per_step"].items()}
            for label, t in res.items():
                for key, val in t.items():
                    per.setdefault(label, {}).setdefault(key, {}).setdefault(who, []).append(val)
        for label, keys in per.items():
            if label in ESTEP_SHAPES:
                row = {"estep": label, "shape": list(ESTEP_SHAPES[label]),
                       "bound": estep_bound(*ESTEP_SHAPES[label])}
            else:
                row = {"mixstep" if func == "mixstep_times" else "entry": label}
            print(json.dumps({**row, "in_turns": keys, "card": card}), flush=True)
    for who, lines in ptxas.items():
        for line in lines:
            print(f"ptxas ({who}): {line}", flush=True)
    return 0


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


def main(argv: list[str] | None = None) -> int:
    import argparse
    import subprocess

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--parent", type=Path, default=None,
                   help="another checkout: mixstep, estep and the --fused-kernel entry in "
                        "turns with it")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure_mixture: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if args.parent is not None:
        return measure_parent(card, args.parent)
    dev = torch.device("cuda", 0)
    measure_estep(dev)
    measure_unroll(dev)
    measure_entries()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
