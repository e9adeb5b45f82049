"""Split the decoder backward kernels' time by phase on one CUDA card.

    python -m svax_torch.measure_phases [--reps N] > phases.txt

Builds ``decoder_mlp.cu``, ``decoder.cu`` and ``errors.cu`` with
``-DSVAX_PHASE_CLOCKS`` into a library of their own
(``ops/csrc/phase_clock.cuh``: thread 0 of every block adds the clocks
between marks to the phase's slot) and calls its backward entries directly
(``decoder_mlp.backward_call``, ``decoder.backward_call``) at the bigk
shape: the decoder_mlp backward (S, N, K, d, H1, H2, D = 1, 1024, 100, 10,
200, 200, 784) and the row-sum backward in both modes (M, Dh, D = 102,400,
200, 784), ``N`` times each. For every kernel of a backward it prints its
device time per call under ``torch.profiler`` (a fresh, short process: the
profiler has dropped device events late in long ones, so a kernel that
launched and reads nothing fails the run) beside the CUDA-event time, and
each phase's share of the block clocks; then nvcc's register, spill and
shared memory lines for those kernels. The marks add a few instructions per
phase; the times are for the split, the kernels line of ``chip_smoke.py``
for the speed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from svax_torch.measure_mixture import device_ms, profiled

# Phase slots of each source (phase_clock.cuh: 0–7 the kernels', 8–15 the
# engine's), by name; a slot without one prints as "slot N".
PHASES = {
    "decoder_mlp": {0: "mlp_rows: W1/W2 staging, h1", 1: "mlp_rows: h2, stores",
                    13: "(a): W3 slab wait", 14: "(a): o", 8: "(a): do", 9: "(a): dh2 += do W3^T",
                    2: "mlp_rows: after the slabs",
                    3: "mlp_rows: dpre2", 4: "mlp_tail: h1, dh1", 5: "mlp_tail: dpre1, dW1, dz",
                    10: "(b): tile wait", 15: "(b): o", 11: "(b): do / dpre2 sum",
                    12: "(b): W-bar product",
                    6: "mlp_wbar dW3: partial", 7: "mlp_wbar dW2: partial"},
    "rowsum": {13: "(a): W slab wait", 14: "(a): o", 8: "(a): do", 9: "(a): H-bar += do W^T",
               0: "hbar: after the slabs", 1: "hbar: store", 10: "(b): tile wait", 15: "(b): o",
               11: "(b): do (formed, with the bf16 mode's tie repair; or loaded)",
               12: "(b): W-bar += H^T do",
               2: "wbar: partial"},
}


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
    buf = (ctypes.c_ulonglong * 16)()
    err = getattr(lib, entry)(ctypes.cast(buf, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    return list(buf)


def split(lib, source: str, entry: str, call, reps: int) -> dict:
    """Run ``call`` (one backward) ``reps`` times under the profiler: the
    device ms per call of each kernel it launched (by name), their sum beside
    the CUDA-event ms per call, and the phase split of the block clocks."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
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
    lib, log = _load()
    print(json.dumps({"card": card}), flush=True)

    params, z, x, dll = decoder_inputs(dev, 1, 1024, 100, 10, 200, 200, 784)
    y = decoder_mlp.x_terms(params, x)[0].contiguous()
    flat = [t.contiguous() for ly in params for t in (ly["w"], ly["b"])]
    wb = decoder_mlp._bf16_weights(flat[0], flat[2], flat[4])
    out = split(lib, "decoder_mlp", "decoder_mlp_phase_clocks",
                lambda: decoder_mlp.backward_call(lib, z, flat, y, wb, dll), args.reps)
    print(json.dumps({"backward": "decoder_mlp bigk", **out}), flush=True)

    h, w, b, sbar = rowsum_inputs(dev, 102400, 200, 784)
    for precision in ("highest", "default"):
        out = split(lib, "rowsum", "rowsum_phase_clocks",
                    lambda: decoder.backward_call(lib, h, w, b, sbar, precision != "highest"),
                    args.reps)
        print(json.dumps({"backward": f"rowsum bigk {precision}", **out}), flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
