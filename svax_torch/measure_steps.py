"""Time and split the whole-step kernels (tinystep, flexstep) on one CUDA card.

    python -m svax_torch.measure_steps [--parent DIR] [--split] [--entries] > steps.txt

Run from the root of a checkout; needs one CUDA device and nvcc. Prints the
card line, then JSON lines:

1. ``times``: ms per step (CUDA events around one launch, the median of 3)
   of tinystep at the pinwheel shape (N=400, K=10, S=4, 50-50, σ=0.4,
   T=200) on its GMM branch and its SMM branch (dof 4, 2 rounds, full chain
   and envelope), and of flexstep at the auto shape (M=64, d_in=8, d=4,
   K=10, S=4, 100-100, T=500), for each cluster size the wrappers
   instantiate (``tinystep.CLUSTER_SIZES``). Each tree is timed in a child
   process of its own that imports that tree's ``svax_torch`` and calls its
   wrappers (``train_chunk``; with no cluster argument where the tree's
   wrappers take none), so any checkout can be DIR; in turns parent, this
   tree, this tree, parent;
2. ``--split``: this tree's kernels built with ``-DSVAX_PHASE_CLOCKS``
   (``ops/csrc/phase_clock.cuh``: thread 0 of each CTA adds the clocks
   between marks to its phase's slot) — each phase's share of the CTAs'
   clocks, the cluster barriers' share included;
3. ``--entries``: ``train_svae --config pinwheel-svae``, ``--config
   auto-svae`` and ``--config pinwheel-svae --smm-dof 4`` (``--iw-samples
   0``), each run once to warm, once for its steps/s (its own clock, the
   per-chunk evaluation included) and once under ``torch.profiler`` for the
   device's idle share (1 − kernel time / wall), in a fresh process from
   each tree's root (parent, this tree, this tree, parent);
4. nvcc's register, spill and shared-memory lines of the two kernels
   (this tree's; with ``--split``, of the clock build too).
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("tinystep.cu", "tinystep_c8.cu", "tinystep_bf16.cu", "flexstep.cu",
           "flexstep_c8.cu", "flexstep_bf16.cu", "errors.cu")

# Phase-clock slots of the kernels (tinystep.cu: TinyPhase; flexstep.cu:
# 0–10 its phases, FlexPhase the rest).
PHASES = {
    "tinystep": {0: "A: expected params, W2 copies", 1: "B: encoder (per point)",
                 10: "B': combine (per record)", 11: "B'': softmax, local KL (per point)",
                 2: "C: decoder rows", 3: "C': rows' terms over s",
                 4: "D: softmax backward sums (per point)",
                 12: "D': combine backward (per record)",
                 13: "D'': head and encoder backward (per point)",
                 5: "E: partials (statistics, weight gradients)", 6: "cluster barrier 1",
                 7: "F: reduce-scatter, Adam, broadcast, CVI", 8: "cluster barrier 2",
                 9: "chunk loads and stores"},
    "flexstep": {0: "0: batch, expected params", 1: "1: encoder forward",
                 2: "2: combine, samples", 3: "3: softmax", 4: "4: decoder forward",
                 5: "5: decoder backward, weight gradients", 6: "6: softmax backward",
                 7: "7: combine backward", 8: "8: head backward",
                 9: "9: encoder backward, weight gradients, statistics",
                 11: "cluster barrier 1", 10: "10: reduce-scatter, Adam, broadcast, CVI",
                 12: "cluster barrier 2", 13: "chunk loads and stores"},
}

ENTRY = r"""
import json, sys
from svax_torch import train_svae
from svax_torch.measure_mixture import device_us, profiled
argv = sys.argv[1:]
train_svae.main(argv)
rate = train_svae.main(argv)["steps_per_s"]
wall, prof = profiled(lambda: train_svae.main(argv))
dev = device_us(prof) / 1e3
print("RESULT " + json.dumps({"steps_per_s": rate, "profiled_wall_ms": wall,
                              "device_ms": dev, "idle": 1.0 - dev / wall}), flush=True)
"""
ENTRIES = {
    "pinwheel-svae": ["--config", "pinwheel-svae", "--steps", "2000"],
    "auto-svae": ["--config", "auto-svae", "--steps", "1000"],
    "pinwheel-svae --smm-dof 4": ["--config", "pinwheel-svae", "--smm-dof", "4",
                                  "--steps", "2000"],
}


def time_per_step(fn, steps: int, repeats: int = 3) -> float:
    """Median device milliseconds per train step of fn() (CUDA events)."""
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / steps)
    return sorted(times)[len(times) // 2]


def _clocks(lib, kernel: str) -> list[int]:
    """The kernel's phase-clock slots, read and zeroed, summed over the
    sources its instantiations compile in (the f32 C = 16 one, and the
    ``_c8`` and ``_bf16`` parts where the library has them)."""
    from svax_torch.measure_phases import PHASE_SLOTS

    total = [0] * PHASE_SLOTS
    for part in ("", "_c8", "_bf16"):
        entry = getattr(lib, f"{kernel}{part}_phase_clocks", None)
        if entry is None:
            continue
        entry.argtypes = [ctypes.c_void_p]
        entry.restype = ctypes.c_int
        buf = (ctypes.c_ulonglong * PHASE_SLOTS)()
        err = entry(ctypes.cast(buf, ctypes.c_void_p))
        if err != 0:
            raise RuntimeError(f"{kernel}{part}_phase_clocks: CUDA error {err}")
        total = [a + b for a, b in zip(total, buf)]
    return total


def step_kernel_lines(log: str) -> list[str]:
    """The lines of an nvcc -Xptxas -v log about the two step kernels'
    instantiations: each entry's name, stack and spill bytes, registers."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "tinystep_kernel" in line or "flexstep_kernel" in line
        if keep and ("Compiling entry" in line or "spill" in line or "registers" in line):
            out.append(line.strip())
    return out


def cases(dev):
    """The timed calls, by name: (kernel, steps, fn(cluster)); cluster None
    calls the wrapper without one."""
    from svax_torch.data import load_dataset
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.ops import flexstep, tinystep
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step

    train, _ = load_pinwheel(seed=0)
    x = torch.tensor(train, dtype=torch.float32, device=dev)
    n = x.shape[0]
    config = SvaeConfig(latent_dim=2, num_components=10, num_samples=4, num_total=n)
    prior = gmm.make_prior(10, 2, kappa=0.05)
    state = svae_step.init_state(torch.Generator().manual_seed(0), 2, config, prior,
                                 (50, 50), (50, 50))
    state, prior = svae_step.state_to(state, dev), svae_step.nat_to(prior, dev)
    base = dict(lr=1e-3, rho=0.05, aug_noise=0.4, t_steps=200)

    auto, _, _ = load_dataset("auto", seed=0)
    xa = torch.tensor(auto, dtype=torch.float32)
    aconf = SvaeConfig(latent_dim=4, num_components=10, num_samples=4, num_total=xa.shape[0])
    aprior = gmm.make_prior(10, 4, kappa=0.05)
    astate = svae_step.init_state(torch.Generator().manual_seed(0), 8, aconf, aprior,
                                  (100, 100), (100, 100))
    astate, aprior = svae_step.state_to(astate, dev), svae_step.nat_to(aprior, dev)
    rng = np.random.default_rng(3)
    batches = xa[torch.tensor(rng.integers(0, xa.shape[0], (500, 64)))].contiguous().to(dev)
    akw = dict(lr=1e-3, rho=0.2, rho_decay=1e-3, num_total=xa.shape[0], num_samples=4)

    def tiny(c, **kw):
        return tinystep.train_chunk(state, prior, x, **base, **kw,
                                    **({} if c is None else {"cluster": c}))

    def flex(c):
        return flexstep.train_chunk(astate, aprior, batches, **akw,
                                    **({} if c is None else {"cluster": c}))

    return {
        "tinystep gmm": ("tinystep", 200, tiny),
        "tinystep smm full chain": ("tinystep", 200,
                                    lambda c: tiny(c, dof=4.0, smm_iters=2)),
        "tinystep smm envelope": ("tinystep", 200, lambda c: tiny(
            c, dof=4.0, smm_iters=2, smm_envelope_grads=True)),
        "flexstep": ("flexstep", 500, flex),
    }


def clusters() -> list:
    """The cluster sizes this process's wrappers take ([None]: no argument)."""
    from svax_torch.ops import tinystep

    if "cluster" not in inspect.signature(tinystep.train_chunk).parameters:
        return [None]
    return list(tinystep.CLUSTER_SIZES)


def time_tree() -> dict:
    """{case: {"C=c": ms per step}} of the svax_torch this process imports."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, (_, steps, fn) in cases(dev).items():
        out[name] = {f"C={c}": time_per_step(lambda: fn(c), steps) for c in clusters()}
    return out


def run_child(root: Path, code: str, argv: list[str]) -> dict:
    """Run ``code`` in a fresh process from ``root`` (its svax_torch first on
    the path); returns the JSON of its RESULT line."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    out = subprocess.run([sys.executable, "-c", code, *argv], cwd=root, env=env,
                         capture_output=True, text=True, timeout=1200)
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{argv} in {root} failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")


TIMES = f"""
import json, runpy
mod = runpy.run_path({str(Path(__file__).resolve())!r}, run_name="measure_steps_child")
print("RESULT " + json.dumps(mod["time_tree"]()), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout, timed in turns with this one")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--entries", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_steps: needs a CUDA card", file=sys.stderr)
        return 1
    from svax_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    trees = [("new", ROOT), ("new", ROOT)]
    if args.parent is not None:
        parent = args.parent.resolve()
        trees = [("parent", parent), *trees, ("parent", parent)]
    times: dict = {}
    for who, root in trees:
        for name, per_c in run_child(root, TIMES, []).items():
            for c, ms in per_c.items():
                key = who if c == "C=None" else f"{who} {c}"
                times.setdefault(name, {}).setdefault(key, []).append(ms)
    for name, per in times.items():
        print(json.dumps({"times": name, "ms_per_step": per, "card": card}), flush=True)

    _build.build()  # the kernel library the timing children built
    logs = {"new": _build.build_log}
    if args.split:
        lib = ctypes.CDLL(str(_build.build([_build._CSRC / s for s in SOURCES],
                                           ["-DSVAX_PHASE_CLOCKS"], tag="libsvax_steps_clk")))
        logs["new clocks"] = _build.build_log
        _build.declare_steps(lib)
        lib.svax_cuda_error_string.argtypes = [ctypes.c_int]
        lib.svax_cuda_error_string.restype = ctypes.c_char_p
        _build._lib = lib
        try:
            for name, (kernel, steps, fn) in cases(torch.device("cuda", 0)).items():
                for c in clusters():
                    fn(c)
                    torch.cuda.synchronize()
                    ms = time_per_step(lambda: fn(c), steps, repeats=1)
                    _clocks(lib, kernel)
                    fn(c)
                    torch.cuda.synchronize()
                    clk = _clocks(lib, kernel)
                    total = sum(clk)
                    print(json.dumps({
                        "split": name, "cluster": c, "ms_per_step_with_marks": ms,
                        "phases": {PHASES[kernel].get(i, f"slot {i}"): clk[i] / total
                                   for i in range(len(clk)) if clk[i]}}), flush=True)
        finally:
            _build._lib = None
    if args.entries:
        entry_trees = [("new", ROOT)] if args.parent is None else trees
        for name, argv_ in ENTRIES.items():
            for who, root in entry_trees:
                result = run_child(root, ENTRY, [*argv_, "--device", "cuda",
                                                 "--iw-samples", "0"])
                print(json.dumps({"entry": name, "tree": who, **result, "card": card}),
                      flush=True)
    for who, text in logs.items():
        for line in step_kernel_lines(text):
            print(f"ptxas ({who}): {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
