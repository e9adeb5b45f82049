#!/usr/bin/env python3
"""Smoke test of the svax_torch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA device, nvcc and nothing
else. Phases (any failure raises and the exit code is non-zero):

1. the card: CUDA available; prints nvidia-smi's name/power limit and the
   torch version;
2. builds the CUDA kernels from svax_torch/ops/csrc (prints the time and
   nvcc's register/spill report);
3. the in-kernel Philox normals: 2^20 draws, |mean| < 0.005,
   |var − 1| < 0.01, same seed bit-equal, seed + 1 different;
4. the tinystep kernel against its plain PyTorch version at full pinwheel
   width (N=400, K=10, S=4, 50-50, σ=0.4), T=3 steps from one seeded state
   with injected numpy noise, at tests/test_tinystep_kernel.py's
   tolerances; then both timed per step;
5. the main path: ``svax_torch.train_svae --config pinwheel-svae`` for
   2 chunks of 1000 steps on the kernel with in-kernel noise, twice: every
   value finite, the kernel launched, the training ELBO improved, the two
   runs bit-equal; then 50 steps on the plain engine for its rate;
6. prints the kernels line, the card line, and last
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import time


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def flat(tree: dict) -> list:
    """The tensors of an nn_params-layout tree, in a fixed order."""
    return [t for side in tree.values() for ly in side for t in ly.values()]


def leaves(state) -> list:
    """Every tensor of a train state, in a fixed order."""
    return (flat(state.nn_params) + flat(state.opt_state.mu)
            + flat(state.opt_state.nu)
            + [state.pgm_nat.dir_nat, *state.pgm_nat.niw_nat])


def close(name, got, ref, rtol, atol) -> float:
    """Assert |got − ref| ≤ atol + rtol·|ref| elementwise; returns max |got − ref|."""
    import torch

    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} entries outside "
            f"rtol={rtol} atol={atol}; max abs err {float(err.max()):.3e}"
        )
    return float(err.max())


def time_per_step(fn, steps: int, repeats: int = 3) -> float:
    """Median device milliseconds per train step of fn() (CUDA events)."""
    import torch

    fn()  # warm
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    from svax_torch import train_svae
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.ops import _build, tinystep
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()

    # 1. the card
    print(f"phase 1: {card}")
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"phase 2: built the kernels in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"phase 2: ptxas: {line.strip()}")

    # 3. Philox normals
    n_draws = 1 << 20
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def draws(seed: int) -> torch.Tensor:
        out = torch.empty(n_draws, device=dev, dtype=torch.float32)
        _build.check(lib, lib.philox_normals(seed, 0, ctypes.c_void_p(out.data_ptr()),
                                             n_draws, stream), "philox_normals")
        torch.cuda.synchronize()
        return out

    a, b, c = draws(1234), draws(1234), draws(1235)
    mean, var = float(a.double().mean()), float(a.double().var())
    print(f"phase 3: philox normals mean {mean:.5f} var {var:.5f} "
          f"(|mean| < 0.005, |var - 1| < 0.01)")
    assert abs(mean) < 0.005 and abs(var - 1.0) < 0.01, (mean, var)
    assert torch.equal(a, b), "same seed gave different draws"
    assert not torch.equal(a, c), "seed + 1 gave the same draws"

    # 4. kernel against plain at full width, injected noise
    cfg = {"k": 10, "s": 4, "hidden": (50, 50), "lr": 1e-3, "rho": 0.05,
           "aug": 0.4, "t": 3}
    train, _ = load_pinwheel(seed=0)
    n = train.shape[0]
    config = SvaeConfig(latent_dim=2, num_components=cfg["k"],
                        num_samples=cfg["s"], num_total=n)
    prior = gmm.make_prior(cfg["k"], 2, kappa=0.05)
    state = svae_step.init_state(torch.Generator().manual_seed(0), 2, config,
                                 prior, cfg["hidden"], cfg["hidden"])
    state = svae_step.state_to(state, dev)
    prior = svae_step.nat_to(prior, dev)
    x = torch.tensor(train, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(100)
    eps = torch.tensor(rng.standard_normal((cfg["t"], cfg["s"], n, cfg["k"], 2)),
                       dtype=torch.float32, device=dev)
    aug_eps = torch.tensor(rng.standard_normal((cfg["t"], n, 2)),
                           dtype=torch.float32, device=dev)
    kw = dict(lr=cfg["lr"], rho=cfg["rho"], t_steps=cfg["t"],
              aug_noise=cfg["aug"], eps=eps, aug_eps=aug_eps)
    st_k, met_k = tinystep.train_chunk(state, prior, x, **kw)
    torch.cuda.synchronize()
    st_p, met_p = tinystep.train_chunk_plain(state, prior, x, **kw)
    errs = {}
    groups = [("params", st_k.nn_params, st_p.nn_params, 5e-4, 5e-5),
              ("adam m", st_k.opt_state.mu, st_p.opt_state.mu, 5e-4, 5e-6),
              ("adam v", st_k.opt_state.nu, st_p.opt_state.nu, 5e-4, 1e-8)]
    for name, tk, tp, rtol, atol in groups:
        errs[name] = max(close(name, a_, b_, rtol, atol)
                         for a_, b_ in zip(flat(tk), flat(tp)))
    nat_pairs = [(st_k.pgm_nat.dir_nat, st_p.pgm_nat.dir_nat),
                 *zip(st_k.pgm_nat.niw_nat, st_p.pgm_nat.niw_nat)]
    errs["naturals"] = max(close("naturals", a_, b_, 2e-5, 2e-5)
                           for a_, b_ in nat_pairs)
    errs["recon"] = close("recon", met_k["recon"], met_p["recon"], 2e-4, 0.0)
    errs["local_kl"] = close("local_kl", met_k["local_kl"], met_p["local_kl"],
                             2e-4, 2e-4)
    assert st_k.opt_state.count == st_p.opt_state.count == cfg["t"]
    assert st_k.step == st_p.step == cfg["t"]
    max_abs_err = max(errs[g] for g in ("params", "adam m", "adam v", "naturals"))
    print("phase 4: kernel vs plain, T=3 at N=400 K=10 S=4 50-50 sigma=0.4: "
          + ", ".join(f"{k} max abs err {v:.3e}" for k, v in errs.items())
          + " (params rtol 5e-4 atol 5e-5; m 5e-4/5e-6; v 5e-4/1e-8; "
          "naturals 2e-5/2e-5; recon rtol 2e-4; local_kl 2e-4/2e-4)")

    t_kernel = 200
    kernel_ms = time_per_step(
        lambda: tinystep.train_chunk(state, prior, x, lr=cfg["lr"], rho=cfg["rho"],
                                     t_steps=t_kernel, aug_noise=cfg["aug"]),
        t_kernel)
    t_plain = 20
    plain_ms = time_per_step(
        lambda: tinystep.train_chunk_plain(state, prior, x, lr=cfg["lr"],
                                           rho=cfg["rho"], t_steps=t_plain,
                                           aug_noise=cfg["aug"]),
        t_plain)
    print(f"phase 4: per step on the card: kernel {kernel_ms:.4f} ms "
          f"(chunks of {t_kernel}), plain {plain_ms:.4f} ms "
          f"(chunks of {t_plain}); {card}")

    # 5. the main path
    argv = ["--config", "pinwheel-svae", "--steps", "2000", "--device", "cuda",
            "--seed", "0"]
    tinystep.launches = 0
    run1 = train_svae.main(argv)
    launches = tinystep.launches
    assert launches >= 2, f"tinystep launched {launches} times on the main path"
    rows = run1["rows"]
    assert len(rows) == 2 and all(
        math.isfinite(v) for r in rows for v in r.values()), rows
    assert all(bool(torch.isfinite(t).all()) for t in leaves(run1["state"]))
    assert rows[-1]["elbo"] > rows[0]["elbo"], "training ELBO did not improve"
    run2 = train_svae.main(argv)
    assert all(torch.equal(p, q) for p, q in
               zip(leaves(run1["state"]), leaves(run2["state"]))), \
        "two runs at one seed differ"
    plain = train_svae.main(["--config", "pinwheel-svae", "--steps", "50",
                             "--device", "cuda", "--engine", "plain"])
    print(f"phase 5: main path: {launches} kernel launches, kernel "
          f"{run1['steps_per_s']:.1f} steps/s, plain {plain['steps_per_s']:.1f} "
          f"steps/s (50 steps), runs bit-equal; {card}")

    # 6. result
    print(json.dumps({"kernels": [{
        "name": "tinystep", "route": "cuda",
        "source": "svax_torch/ops/csrc/tinystep.cu",
        "replaces": "svax/ops/tinystep_pallas.py:621",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
