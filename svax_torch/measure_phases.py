"""Split the decoder kernels' time by phase on one CUDA card, and time the
two last-layer forwards against another checkout's.

    python -m svax_torch.measure_phases [--reps N] [--parent DIR] > phases.txt

Builds ``decoder_mlp.cu``, ``decoder.cu`` and ``errors.cu`` with
``-DSVAX_PHASE_CLOCKS`` into a library of their own
(``ops/csrc/phase_clock.cuh``: thread 0 of every block adds the clocks
between marks to the phase's slot) and calls its C entries directly
(``decoder_mlp.forward_call``/``backward_call``,
``decoder.forward_call``/``backward_call``) at the bigk shape: the
decoder_mlp forward and backward (S, N, K, d, H1, H2, D = 1, 1024, 100, 10,
200, 200, 784) and the row sum's in both modes (M, Dh, D = 102,400, 200,
784), ``N`` times each. For every kernel of a call it prints its device
time per call under ``torch.profiler`` (a fresh, short process: the
profiler has dropped device events late in long ones, so a kernel that
launched and reads nothing fails the run) beside the CUDA-event time, and
each phase's share of the block clocks; then nvcc's register, spill and
shared memory lines of the two sources' kernels. The marks add a few
instructions per phase; the times are for the split, the kernels line of
``chip_smoke.py`` and ``--parent`` for the speed.

``--parent DIR`` (another checkout, e.g. the parent commit unpacked into a
gitignored directory) first times both trees' forwards — decoder_mlp at the
bigk and mnist shapes (1, 256, 10, 8, 200, 200, 784), the row sum in both
modes at M = 102,400 and 2,560 — by CUDA events, each tree in a child
process of its own that imports that tree's ``svax_torch`` and calls its
wrappers, in turns parent, this tree, this tree, parent, and the forward
kernels' own device time under ``torch.profiler``; the children also time
the unfused f32 row sum (``measure_mnist.unfused_rowsum``). Each child
also hashes, at the bigk shape, both backwards' outputs and the decoder_mlp
backward's whole scratch (mlp_rows' stores of bf16(h1), bf16(h2), h2 and
dpre2's parts, and the partials), and the run fails unless they are
bit-equal between the trees and between runs.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from svax_torch.measure_mixture import device_ms, profiled

ROOT = Path(__file__).resolve().parents[1]
PHASE_SLOTS = 32  # phase_clock.cuh: kPhaseSlots

# Phase slots of each source (phase_clock.cuh: 0–7 the backward kernels',
# 8–15 the engine's backward blocks, 16–23 the forward kernels', 24–31 the
# engine's forward block), by name; a slot without one prints as "slot N".
_FWD_BLOCK = {24: "(f): W slab wait", 25: "(f): o", 26: "(f): logsig epilogue",
              27: "(f): slab barrier", 28: "(f): row totals"}
PHASES = {
    "decoder_mlp": {0: "mlp_rows: W1/W2 staging, h1", 1: "mlp_rows: h1 W2, h2, stores",
                    13: "(a): W3 slab wait", 14: "(a): o", 8: "(a): do", 9: "(a): dh2 += do W3^T",
                    2: "mlp_rows: after the slabs",
                    3: "mlp_rows: dpre2", 4: "mlp_tail: h1, dh1", 5: "mlp_tail: dpre1, dW1, dz",
                    10: "(b): tile wait", 15: "(b): o", 11: "(b): do / dpre2 sum",
                    12: "(b): W-bar product",
                    6: "mlp_wbar dW3: partial", 7: "mlp_wbar dW2: partial",
                    16: "fwd: z/W1/W2 staging, h1", 17: "fwd: h1 W2", 18: "fwd: h2 tanh, t-term",
                    **_FWD_BLOCK, 19: "fwd: ll store"},
    "rowsum": {13: "(a): W slab wait", 14: "(a): o", 8: "(a): do", 9: "(a): H-bar += do W^T",
               0: "hbar: after the slabs", 1: "hbar: store", 10: "(b): tile wait", 15: "(b): o",
               11: "(b): do (formed, with the bf16 mode's tie repair; or loaded)",
               12: "(b): W-bar += H^T do",
               2: "wbar: partial",
               16: "fwd: H staging (f32 loads, split into parts)", **_FWD_BLOCK,
               17: "fwd: s store"},
}

DECODER_SHAPES = {"bigk": (1, 1024, 100, 10, 200, 200, 784),
                  "mnist": (1, 256, 10, 8, 200, 200, 784)}
ROWSUM_ROWS = {"bigk": 102400, "mnist": 2560}


def _load():
    from svax_torch.ops import _build

    csrc = _build._CSRC
    path = _build.build([csrc / "decoder_mlp.cu", csrc / "decoder.cu", csrc / "errors.cu"],
                        ["-DSVAX_PHASE_CLOCKS"], tag="libsvax_phases")
    lib = ctypes.CDLL(str(path))
    _build.declare_decoders(lib)
    for name in ("decoder_mlp_phase_clocks", "rowsum_phase_clocks"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    return lib, _build.build_log


def _clocks(lib, entry: str) -> list[int]:
    buf = (ctypes.c_ulonglong * PHASE_SLOTS)()
    err = getattr(lib, entry)(ctypes.cast(buf, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    return list(buf)


def split(lib, source: str, entry: str, call, reps: int) -> dict:
    """Run ``call`` (one forward or backward) ``reps`` times under the
    profiler: the device ms per call of each kernel it launched (by name),
    their sum beside the CUDA-event ms per call, and the phase split of the
    block clocks."""
    event_ms = device_ms(call, reps)
    _clocks(lib, entry)
    _, prof = profiled(lambda: [call() for _ in range(reps)])
    clocks = _clocks(lib, entry)
    ms = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = evt.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0]
            ms[name] = ms.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3 / reps
    if not ms or sum(ms.values()) <= 0.0:
        raise RuntimeError(f"torch.profiler recorded no device time for {source} "
                           f"({event_ms:.4f} ms a call by CUDA events)")
    total = sum(clocks)
    return {"kernel_ms": ms, "sum_ms": sum(ms.values()), "event_ms": event_ms,
            "phases": {PHASES[source].get(i, f"slot {i}"): clocks[i] / total
                       for i in range(len(clocks)) if clocks[i]}}


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:20]


def launched_ms(fn, names: tuple, reps: int) -> float:
    """Device ms per call of fn() in the kernels whose names hold one of
    ``names`` (torch.profiler over ``reps`` calls)."""
    _, prof = profiled(lambda: [fn() for _ in range(reps)])
    us = sum(evt.time_range.elapsed_us() for evt in prof.events()
             if evt.device_type == torch.autograd.DeviceType.CUDA
             and any(n in evt.name for n in names))
    if us <= 0.0:
        raise RuntimeError(f"torch.profiler recorded no device time for {names}")
    return us / 1e3 / reps


def time_tree(reps: int) -> dict:
    """Run in a child process from one tree: {"ms": {case: CUDA-event ms per
    forward call through the tree's wrappers}, "kernel_ms": {case: the
    forward kernels' own device ms per call (torch.profiler; without the
    wrappers' operand copies)}, "digests": {output: hash}}."""
    from svax_torch.measure_mnist import (decoder_inputs, rowsum_inputs, unfused_rowsum)
    from svax_torch.ops import _build, decoder, decoder_mlp

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ptr = _build.ptr
    ms, kernel_ms, digests = {}, {}, {}
    with torch.no_grad():
        for label, shape in DECODER_SHAPES.items():
            params, z, x, _ = decoder_inputs(dev, *shape)
            flat = [t.contiguous() for ly in params for t in (ly["w"], ly["b"])]
            y, c = (t.contiguous() for t in decoder_mlp.x_terms(params, x))
            case = f"decoder_mlp forward {label}"
            ms[case] = device_ms(lambda: decoder_mlp.core_fused(z, *flat, y, c), reps)
            kernel_ms[case] = launched_ms(lambda: decoder_mlp.core_fused(z, *flat, y, c),
                                          ("decoder_fwd",), reps)
        for label, m in ROWSUM_ROWS.items():
            h, w, b, _ = rowsum_inputs(dev, m, 200, 784)
            for precision in ("highest", "default"):
                case = f"rowsum forward {label} {precision}"
                ms[case] = device_ms(lambda: decoder.rowsum_logsig_neg(h, w, b, precision), reps)
                kernel_ms[case] = launched_ms(
                    lambda: decoder.rowsum_logsig_neg(h, w, b, precision),
                    ("rowsum_fwd", "rowsum_split"), reps)
            ms[f"unfused f32 row sum forward {label}"] = device_ms(
                lambda: unfused_rowsum(h, w, b), reps)

    lib = _build.load()
    h, w, b, sbar = rowsum_inputs(dev, ROWSUM_ROWS["bigk"], 200, 784)
    for precision in ("highest", "default"):
        grads = decoder.backward_call(lib, h, w, b, sbar, precision != "highest")
        for name, t in zip(("hbar", "wbar", "bbar"), grads):
            digests[f"rowsum backward {precision} {name}"] = _digest(t)
    shape = DECODER_SHAPES["bigk"]
    params, z, x, dll = decoder_inputs(dev, *shape)
    flat = [t.contiguous() for ly in params for t in (ly["w"], ly["b"])]
    y = decoder_mlp.x_terms(params, x)[0].contiguous()
    wb = decoder_mlp._bf16_weights(flat[0], flat[2], flat[4])
    s, n, k, d, h1, h2, dd = shape
    kw = dict(device=dev, dtype=torch.float32)
    outs = {"dz": torch.empty(z.shape, **kw), "dy": torch.empty((n, h2), **kw),
            "dc": torch.empty((n,), **kw), "dw1": torch.empty((d, h1), **kw),
            "db1": torch.empty((h1,), **kw), "dw2": torch.empty((h1, h2), **kw),
            "db2": torch.empty((h2,), **kw), "dw3": torch.empty((h2, dd), **kw),
            "db3": torch.empty((dd,), **kw)}
    scratch = torch.zeros((lib.decoder_mlp_scratch_floats(n, k, s, d, h1, h2, dd),), **kw)
    o = outs
    err = lib.decoder_mlp_backward(
        ptr(z), ptr(dll), n, k, s, d, h1, h2, dd, *(ptr(t) for t in wb), ptr(flat[1]),
        ptr(flat[3]), ptr(flat[5]), ptr(y), ptr(o["dz"]), ptr(o["dy"]), ptr(o["dc"]),
        ptr(scratch), ptr(o["dw1"]), ptr(o["db1"]), ptr(o["dw2"]), ptr(o["db2"]), ptr(o["dw3"]),
        ptr(o["db3"]), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, err, "decoder_mlp_backward")
    for name, t in outs.items():
        digests[f"decoder_mlp backward {name}"] = _digest(t)
    digests["decoder_mlp backward scratch (mlp_rows' stores, partials)"] = _digest(scratch)
    torch.cuda.synchronize()
    return {"ms": ms, "kernel_ms": kernel_ms, "digests": digests}


CHILD = f"""
import json, runpy, sys
mod = runpy.run_path({str(Path(__file__).resolve())!r}, run_name="measure_phases_child")
print("RESULT " + json.dumps(mod["time_tree"](int(sys.argv[1]))), flush=True)
"""


def run_child(root: Path, reps: int) -> dict:
    """``time_tree`` in a fresh process from ``root`` (its svax_torch first on
    the path); returns its result."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    out = subprocess.run([sys.executable, "-c", CHILD, str(reps)], cwd=root, env=env,
                         capture_output=True, text=True, timeout=1200)
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"time_tree in {root} failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")


def compare_trees(parent: Path, reps: int, card: str) -> None:
    """The forwards' times in turns (parent, this tree, this tree, parent)
    and the backwards' bit-equality between the trees; raises if any
    output differs."""
    turns = [("parent", parent), ("new", ROOT), ("new", ROOT), ("parent", parent)]
    results = [(who, run_child(root, reps)) for who, root in turns]
    for key, what in (("ms", "CUDA events through the wrappers"),
                      ("kernel_ms", "the forward kernels' device time (profiler)")):
        times: dict = {}
        for who, res in results:
            for case, v in res[key].items():
                times.setdefault(case, {}).setdefault(who, []).append(v)
        for case, per in times.items():
            print(json.dumps({"times": case, "of": what, "ms_per_call": per, "card": card}),
                  flush=True)
    first = results[0][1]["digests"]
    bad = [(name, who) for who, res in results for name, v in res["digests"].items()
           if first.get(name) != v]
    print(json.dumps({"backward bit-equal between trees and runs": not bad,
                      "outputs": sorted(first), "differ": bad}), flush=True)
    if bad:
        raise RuntimeError(f"backward outputs differ: {bad}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout, whose forwards are timed in turns with this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_phases: needs a CUDA card", file=sys.stderr)
        return 1
    from svax_torch.measure_mnist import decoder_inputs, rowsum_inputs
    from svax_torch.ops import decoder, decoder_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    if args.parent is not None:
        compare_trees(args.parent.resolve(), args.reps, card)
    lib, log = _load()

    params, z, x, dll = decoder_inputs(dev, *DECODER_SHAPES["bigk"])
    y, c = (t.contiguous() for t in decoder_mlp.x_terms(params, x))
    flat = [t.contiguous() for ly in params for t in (ly["w"], ly["b"])]
    wb = decoder_mlp._bf16_weights(flat[0], flat[2], flat[4])
    out = split(lib, "decoder_mlp", "decoder_mlp_phase_clocks",
                lambda: decoder_mlp.forward_call(lib, z, flat, y, c, wb), args.reps)
    print(json.dumps({"forward": "decoder_mlp bigk", **out}), flush=True)
    out = split(lib, "decoder_mlp", "decoder_mlp_phase_clocks",
                lambda: decoder_mlp.backward_call(lib, z, flat, y, wb, dll), args.reps)
    print(json.dumps({"backward": "decoder_mlp bigk", **out}), flush=True)

    h, w, b, sbar = rowsum_inputs(dev, ROWSUM_ROWS["bigk"], 200, 784)
    for precision in ("highest", "default"):
        out = split(lib, "rowsum", "rowsum_phase_clocks",
                    lambda: decoder.forward_call(lib, h, w, b, precision != "highest"),
                    args.reps)
        print(json.dumps({"forward": f"rowsum bigk {precision}", **out}), flush=True)
        out = split(lib, "rowsum", "rowsum_phase_clocks",
                    lambda: decoder.backward_call(lib, h, w, b, sbar, precision != "highest"),
                    args.reps)
        print(json.dumps({"backward": f"rowsum bigk {precision}", **out}), flush=True)
    from svax_torch.ops import _build

    _build.build()  # the kernel library (the children's, with --parent): its ptxas lines
    for who, text in (("clocks", log), ("shipped", _build.build_log)):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas ({who}): {line.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
