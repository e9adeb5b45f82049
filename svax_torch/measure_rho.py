"""Time the ρ-kernel's forward (``csrc/combine.cu: log_rho_fwd``) against
other checkouts, and split it by phase, on one CUDA card.

    python -m svax_torch.measure_rho [--parent DIR] [--other NAME=DIR ...] > rho.txt

Run from the root of a checkout; needs one CUDA device and nvcc. Builds
this tree's ``combine.cu``, also with ``-DSVAX_PHASE_CLOCKS``, and that of
each other checkout (``--parent``, ``--other``: each under its own name; a
variant of the kernel is a copy of ``svax_torch/ops/csrc`` under
``DIR/svax_torch/ops/``), all at once (one nvcc each; the backwards are
stubbed out, this script calls only ``rho_forward`` and
``combine_forward``). Then at each of RHO_SHAPES, in a fresh process, in
turns (the builds in order, then in reverse): each build's kernel time per
launch under
``torch.profiler`` (``log_rho_fwd``'s device time over 50 launches); each
output within 2e-5 of ``log_rho_plain``, rerun bit-equal, and compared bit
for bit with this tree's and with ``combine_forward``'s log r̃ at a zero
normaliser (the combine's log_norm mode); then this tree's phase clocks
(thread 0's clocks of a block: the copy of w with the first row group's
potentials, the Cholesky-and-solves chain, the store and the next group's
potentials; ``rho_phase_clocks`` slots 16–18) beside the clock build's
device time, whose ratio is the SM clock the kernel ran at; and each
build's ptxas line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import threading
from pathlib import Path

import torch

from svax_torch.measure_mixture import profiled
from svax_torch.measure_mnist import (RHO_SHAPES, combine_inputs, kernel_resources, launched_us,
                                      rho_bound)

THIS = "this tree"
REPS = 50

# The combine backwards' entries, stubbed: combine.cu links against them.
STUB = """#include "combine_core.cuh"
namespace svax {
namespace comb {
cudaError_t backward_lean(const BwdArgs&, int, cudaStream_t) { return cudaErrorNotSupported; }
cudaError_t backward_full(BwdArgs, int, float*, cudaStream_t) { return cudaErrorNotSupported; }
cudaError_t full_grid(int, int, int, bool, int&) { return cudaErrorNotSupported; }
}  // namespace comb
}  // namespace svax
"""


def build_all(others: dict) -> dict:
    """{name: (library path, nvcc log)} for this tree (under THIS, and with
    the phase clocks under THIS + " clocks") and each of ``others`` ({name:
    checkout})."""
    from svax_torch.ops import _build

    root = Path(__file__).resolve().parents[1]
    stub = root / "build" / "measure_rho" / "stub.cu"
    stub.parent.mkdir(parents=True, exist_ok=True)
    stub.write_text(STUB)
    jobs = {}
    trees = {THIS: root, **{who: tree.resolve() for who, tree in others.items()}}
    for who, tree in trees.items():
        csrc = tree / "svax_torch" / "ops" / "csrc"
        sources = [csrc / "combine.cu", csrc / "errors.cu", stub]
        jobs[who] = (sources, [f"-I{csrc}"])
        if who == THIS:
            jobs[who + " clocks"] = (sources, [f"-I{csrc}", "-DSVAX_PHASE_CLOCKS"])
    out, errors = {}, []

    def one(name, sources, flags):
        try:
            path = _build.build(sources, flags, tag="measure-rho-" + name.replace(" ", "_"))
            out[name] = (path, path.with_suffix(".log").read_text())
        except Exception as exc:  # noqa: BLE001 — reported below, with the others
            errors.append(f"{name}: {exc}")

    threads = [threading.Thread(target=one, args=(name, *job)) for name, job in jobs.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise RuntimeError("builds failed:\n" + "\n".join(errors))
    return out


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rho_forward.argtypes = [p, p, p, i, i, i, p, p]
    lib.combine_grid.argtypes = [i, i, i, i]
    # The combine's Philox key is a device word since the graphed runners
    # (null here: ε is injected); a checkout before them took (seed, step)
    # by value and cannot be compared through this entry.
    lib.combine_forward.argtypes = [p, p, p, p, p, i, i, i, i, p, p, p, p, p, p, p, p]
    lib.svax_cuda_error_string.argtypes = [i]
    lib.svax_cuda_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "rho_phase_clocks"):
        lib.rho_phase_clocks.argtypes = [p]
    return lib


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: {lib.svax_cuda_error_string(err).decode()}")


class Case:
    """One shape's seeded inputs (``measure_mnist.combine_inputs``) and the
    plain version's log ρ."""

    def __init__(self, dev, n: int, k: int, d: int):
        from svax_torch.ops import combine

        self.n, self.k, self.d = n, k, d
        self.pot_h, self.pot_p, exp, self.eps = combine_inputs(dev, n, k, d, 1)
        self.w = combine.pack_expected(exp)
        self.plain = combine.log_rho_plain(self.pot_h, self.pot_p, exp)
        self.stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def forward(self, lib) -> torch.Tensor:
        out = torch.empty((self.n, self.k), device=self.w.device)
        _check(lib, lib.rho_forward(_ptr(self.pot_h), _ptr(self.pot_p), _ptr(self.w), self.n,
                                    self.k, self.d, _ptr(out), self.stream), "rho_forward")
        return out

    def norm_combine(self, lib) -> torch.Tensor:
        """combine_forward's log r̃ at a zero normaliser (log_norm mode)."""
        n, k, d = self.n, self.k, self.d
        kw = dict(device=self.w.device, dtype=torch.float32)
        blocks = lib.combine_grid(n, k, d, 1)
        if blocks < 1:
            _check(lib, -blocks, "combine_grid")
        z, lr = torch.empty((1, n, k, d), **kw), torch.empty((n, k), **kw)
        mean, local = torch.empty((n, k, d), **kw), torch.empty((n,), **kw)
        partial = torch.empty((blocks, 1 + d + d * (d + 1) // 2, k), **kw)
        stats, zero = torch.empty((k, 1 + d + d * d), **kw), torch.zeros(n, **kw)
        _check(lib, lib.combine_forward(
            _ptr(self.pot_h), _ptr(self.pot_p), _ptr(self.w), _ptr(self.eps), _ptr(zero), n, k, d,
            1, None, _ptr(z), _ptr(lr), _ptr(mean), _ptr(local), _ptr(partial), _ptr(stats),
            self.stream), "combine_forward")
        return lr


def time_forward(lib, case: Case) -> float:
    """ms per launch: log_rho_fwd's device time over REPS launches."""
    case.forward(lib)
    torch.cuda.synchronize()
    _, prof = profiled(lambda: [case.forward(lib) for _ in range(REPS)])
    return launched_us(prof, "log_rho_fwd") / 1e3 / REPS


def phase_clocks(lib, case: Case, sms: int) -> dict:
    """Thread 0's clocks a block in log_rho_fwd's phases (slots 16–18), the
    grid taken as the row groups, at most two blocks an SM (its launch
    bounds), and the build's device ms a launch."""
    from svax_torch.ops import combine

    out = (ctypes.c_ulonglong * 32)()
    case.forward(lib)
    torch.cuda.synchronize()
    lib.rho_phase_clocks(out)
    case.forward(lib)
    torch.cuda.synchronize()
    _check(lib, lib.rho_phase_clocks(out), "rho_phase_clocks")
    groups = combine.row_groups(case.n, case.k, combine.BLOCK_THREADS, sms)
    blocks = min(groups, 2 * sms)
    return {"blocks": blocks, "copy": out[16] / blocks, "chain": out[17] / blocks,
            "store": out[18] / blocks, "ms": time_forward(lib, case)}


def shape_results(label: str, paths: dict) -> dict:
    """At RHO_SHAPES[label], with the libraries ``paths`` ({name: path}, this
    tree's last, its clock build apart): each build's checks and its times
    in turns, and this tree's phase clocks."""
    n, k, d = RHO_SHAPES[label]
    libs = {name: load(Path(path)) for name, path in paths.items()}
    order = [name for name in paths if name != THIS + " clocks"]
    dev = torch.device("cuda", 0)
    case = Case(dev, n, k, d)
    ref = case.forward(libs[THIS])
    checks = {}
    for name in order:
        got = case.forward(libs[name])
        torch.cuda.synchronize()
        err = float((got - case.plain).abs().max())
        if not torch.isfinite(got).all() or err > 2e-5 * (1 + float(case.plain.abs().max())):
            raise AssertionError(f"{label} {name}: log ρ off the plain version by {err:.3e}")
        if not torch.equal(got, case.forward(libs[name])):
            raise AssertionError(f"{label} {name}: reruns differ")
        checks[name] = {"max_abs_err": err, "equals_this": bool(torch.equal(got, ref)),
                        "equals_norm_combine": bool(torch.equal(got,
                                                                case.norm_combine(libs[name])))}
    ms: dict = {name: [] for name in order}
    for name in order + order[::-1]:
        ms[name].append(time_forward(libs[name], case))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"ms": ms, "checks": checks,
            "clocks": phase_clocks(libs[THIS + " clocks"], case, sms)}


# Each shape is measured in a fresh process: torch.profiler has dropped a
# short profile's device events late in a long process (PERF.md).
CHILD = f"""
import json, runpy, sys
mod = runpy.run_path({str(Path(__file__).resolve())!r}, run_name="measure_rho_child")
print("RESULT " + json.dumps(mod["shape_results"](sys.argv[1], json.loads(sys.argv[2]))),
      flush=True)
"""


def main(argv: list[str] | None = None) -> int:
    from svax_torch.measure_steps import run_child

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--parent", type=Path, default=None,
                   help="another checkout, whose log_rho_fwd is timed in turns with these")
    p.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                   help="one more checkout to time in turns, under NAME")
    args = p.parse_args(argv)
    others = dict(o.split("=", 1) for o in args.other)
    others = {name: Path(tree) for name, tree in others.items()}
    if args.parent is not None:
        others = {"parent": args.parent, **others}
    if not torch.cuda.is_available():
        raise SystemExit("measure_rho: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    built = build_all(others)
    paths = {name: str(built[name][0]) for name in [*others, THIS, THIS + " clocks"]}
    root = Path(__file__).resolve().parents[1]
    for label, (n, k, d) in RHO_SHAPES.items():
        res = run_child(root, CHILD, [label, json.dumps(paths)])
        bound = rho_bound(n, k, d, False)
        print(json.dumps({"rho_fwd": label, "shape": [n, k, d], "ms": res["ms"],
                          "checks": res["checks"], "bound_ms": bound[0], "bound_by": bound[1],
                          "card": card}), flush=True)
        print(json.dumps({"rho_fwd clocks": label, **res["clocks"]}), flush=True)
    for name, (_, log) in built.items():
        for line in kernel_resources(log, "log_rho_fwd"):
            print(f"ptxas ({name}): {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
