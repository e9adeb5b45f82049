"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` — one nvcc
process per source, all started together — and linked into one shared
library with a plain C interface, under ``build/svax_torch/`` at the root
of the checkout, at first use, and loaded with ``ctypes``. The library's
name carries a hash of the sources, so an edited source is rebuilt. A
failed build raises with nvcc's output. Nothing happens at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "svax_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (register and shared-memory use per kernel)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build "
                       "the svax_torch CUDA kernels")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tinystep_scratch_floats.argtypes = [i, i, i, i, i]
    lib.tinystep_scratch_floats.restype = ctypes.c_longlong
    lib.tinystep_train_chunk.argtypes = [
        p, i, i, i, i, i,  # x, n, k, s, h1, h2
        p, p, p, p, p,  # prior, nat, params, m, v
        p, p, p, p,  # metrics, scratch, eps, aug_eps
        i, i, ctypes.c_ulonglong, f, f, f,  # t_steps, count, seed, lr, rho, aug
        f, i, i, f, f,  # dof, smm_iters, smm_env, psi_a, k_u
        p,  # stream
    ]
    lib.tinystep_train_chunk.restype = i
    lib.philox_normals.argtypes = [ctypes.c_ulonglong, ctypes.c_uint, p, i, p]
    lib.philox_normals.restype = i
    lib.mixstep_train_chunk.argtypes = [
        p, i, i, p, p, p,  # x, n, k, prior, nat, metrics
        i, f, f, f, f, i,  # t_steps, rho, scale, dof, smm_const, unroll
        p,  # stream
    ]
    lib.mixstep_train_chunk.restype = i
    lib.estep_blocks.argtypes = [i]
    lib.estep_blocks.restype = i
    lib.estep_stats.argtypes = [
        p, i, i, i, p,  # x, n, d, k, w
        p, p, p,  # partial, stats, evidence
        p,  # stream
    ]
    lib.estep_stats.restype = i
    lib.flexstep_scratch_floats.argtypes = [i] * 9
    lib.flexstep_scratch_floats.restype = ctypes.c_longlong
    lib.flexstep_train_chunk.argtypes = [
        p, i, i, i, i, i, i, i, i, i,  # batches, m, d_in, d, k, s, h1e, h2e, h1d, h2d
        p, p, p, p, p,  # prior, nat, params, m1, m2
        p, p, p,  # metrics, scratch, eps
        i, i, i, ctypes.c_ulonglong,  # t_steps, adam count, step0, seed
        f, ctypes.c_double, ctypes.c_double, f,  # lr, rho0, rho_decay, num_total
        p,  # stream
    ]
    lib.flexstep_train_chunk.restype = i
    lib.combine_blocks.argtypes = [i, i]
    lib.combine_blocks.restype = i
    lib.combine_forward.argtypes = [
        p, p, p, p, p, i, i, i, i,  # pot_h, pot_p, w, eps, norm, n, k, d, s
        ctypes.c_ulonglong, ctypes.c_uint,  # seed, step (the Philox stream)
        p, p, p, p, p, p,  # z, log_resp, mean, local, partial, stats
        p,  # stream
    ]
    lib.combine_forward.restype = i
    lib.combine_backward.argtypes = [
        p, p, p, p, p, i, i, i, i,  # pot_h, pot_p, w, eps, norm, n, k, d, s
        ctypes.c_ulonglong, ctypes.c_uint,  # seed, step
        p, p, p, p, p,  # dz, dlr, dmu, dlocal, dstats (each may be null)
        p, p, p, p, p,  # dph, dpp, dn (null without norm), partial, dw (both null: no dw)
        p,  # stream
    ]
    lib.combine_backward.restype = i
    lib.rho_forward.argtypes = [p, p, p, i, i, i, p, p]  # pot_h, pot_p, w, n, k, d, log_rho
    lib.rho_forward.restype = i
    lib.rho_backward.argtypes = [
        p, p, p, p, i, i, i,  # pot_h, pot_p, w, drho, n, k, d
        p, p, p, p,  # dph, dpp, partial, dw (both null: no dw)
        p,  # stream
    ]
    lib.rho_backward.restype = i
    lib.decoder_mlp_partial_floats.argtypes = [i, i, i, i]  # n, h1, h2, D
    lib.decoder_mlp_partial_floats.restype = ctypes.c_longlong
    dims = [i] * 7  # n, k, s, d, h1, h2, D
    weights = [p] * 9  # w1, w1t, w2, w2t, w3, w3t (bf16), b1, b2, b3
    lib.decoder_mlp_forward.argtypes = [
        p, *dims, *weights,  # z
        p, p, p,  # y, c, ll
        p,  # stream
    ]
    lib.decoder_mlp_forward.restype = i
    lib.decoder_mlp_backward.argtypes = [
        p, p, *dims, *weights,  # z, dll
        p, p, p, p, p,  # y, dz, dy, dc, partial
        p, p, p, p, p, p,  # dw1, db1, dw2, db2, dw3, db3
        p,  # stream
    ]
    lib.decoder_mlp_backward.restype = i
    lib.rowsum_partial_floats.argtypes = [i, i, i]  # m, dh, d
    lib.rowsum_partial_floats.restype = ctypes.c_longlong
    lib.rowsum_forward.argtypes = [p, p, p, i, i, i, i, p, p]  # h, w, b, m, dh, d, bf16, s
    lib.rowsum_forward.restype = i
    lib.rowsum_backward.argtypes = [
        p, p, p, p, i, i, i, i,  # h, w, b, sbar, m, dh, d, bf16
        p, p, p, p,  # hbar, wbar, bbar, partial
        p,  # stream
    ]
    lib.rowsum_backward.restype = i
    lib.svax_cuda_error_string.argtypes = [i]
    lib.svax_cuda_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the CDLL."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = _BUILD_DIR / f"libsvax_kernels-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
        jobs.append([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in jobs[:-1]]
        logs = []
        for cmd, proc in zip(jobs, procs):
            output, _ = proc.communicate()
            logs.append((cmd, proc.returncode, output))
        if all(rc == 0 for _, rc, _ in logs):
            link = subprocess.run(jobs[-1], capture_output=True, text=True)
            logs.append((jobs[-1], link.returncode, link.stdout + link.stderr))
        build_log = "".join(output for _, _, output in logs)
        for obj in objs:
            obj.unlink(missing_ok=True)
        for cmd, rc, output in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{output}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    _lib = lib
    return lib


def ptr(t) -> ctypes.c_void_p | None:
    """A tensor's device pointer for a C entry (None for an absent tensor)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code (launch refused, bad
    configuration); faults during the run surface at the next synchronise."""
    if err != 0:
        msg = lib.svax_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
