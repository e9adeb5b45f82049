"""Slice K's studies on the card: the seed sweep's kernel engine and the
weight-decay routing.

* a sweep's rerun is bit-equal (tinystep's bf16-product mode, in-kernel
  noise, two restarts);
* a tinystep chunk at full pinwheel width (σ = 0.4, injected ε and
  augmentation noise) matches the plain engine: over 3 steps element by
  element, the bf16-product mode at chip_smoke.py's ``BF16_TINY_TOL`` and the
  f32 mode at phase 4's bars; over 200 steps each tensor's largest
  difference relative to its largest value, at ``DRIFT_200`` (the two
  paths' f32 sums differ in order, and the difference grows with the
  steps, past the elementwise bars);
* ``--weight-decay`` (the entry) and a ``wd`` variant (the sweep) never
  launch a whole-step kernel.

Every test needs a CUDA device and skips without one. The file imports no
JAX. Run as a script, it prints the drift readings behind ``DRIFT_200`` (both
modes, 3 and 200 steps) with the card's name and power limit:

    python -m pytest tests/test_torch_cuda_sweep.py -m requires_cuda --noconftest
    PYTHONPATH=. python tests/test_torch_cuda_sweep.py
"""

import json

import numpy as np
import pytest
import torch

from svax_torch import seed_sweep, train_svae
from svax_torch.data.pinwheel import load_pinwheel
from svax_torch.ops import flexstep, tinystep
from svax_torch.pgm import gmm
from svax_torch.train import loop, svae_step

pytestmark = pytest.mark.requires_cuda
# chip_smoke.py's BF16_TINY_TOL and phase 4's f32 bars: (rtol, atol) per group.
BF16_TOL = {"params": (5e-4, 5e-5), "adam m": (5e-4, 5e-4), "adam v": (5e-3, 1e-6),
            "naturals": (2e-4, 2e-4)}
F32_TOL = {"params": (5e-4, 5e-5), "adam m": (5e-4, 5e-6), "adam v": (5e-4, 1e-8),
           "naturals": (2e-5, 2e-5)}
# After 200 steps: max |kernel − plain| / max |plain| per tensor, about three
# times the larger of the two modes' readings on an H100 (this file run as a
# script; bf16 / f32: params 1.6e-4 / 2.7e-4, adam m 2.2e-3 / 4.5e-4, adam v
# 6.8e-5 / 2.6e-5, naturals 6.6e-5 / 1.7e-4).
DRIFT_200 = {"params": 8e-4, "adam m": 6e-3, "adam v": 2e-4, "naturals": 5e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flat(tree):
    return [t for side in tree.values() for ly in side for t in ly.values()]


def test_sweep_rerun_is_bit_equal(dev, tmp_path):
    argv = ["--engine", "kernel", "--variants", "aug0.4+rs2+steps2000", "--seed-list", "3",
            "--iw-samples", "100", "--nn-precision", "default", "--device", "cuda"]
    tinystep.launches = tinystep.launches_bf16 = 0
    a = seed_sweep.main([*argv, "--json", str(tmp_path / "a_torch.json")])
    assert tinystep.launches_bf16 == 4 and tinystep.launches == 0
    b = seed_sweep.main(argv)
    ra, rb = (r["results"]["aug0.4+rs2+steps2000"]["rows"][0] for r in (a, b))
    assert {k: v for k, v in ra.items() if k != "wall_s"} == \
        {k: v for k, v in rb.items() if k != "wall_s"}
    assert np.isfinite(ra["iw_per_point"])
    assert json.loads((tmp_path / "a_torch.json").read_text())["config"]["engine"] == "kernel"


def chunk_pair(dev, precision: str, t: int):
    """tinystep's kernel and its plain engine, ``t`` steps each from one
    full-width pinwheel state with injected ε and augmentation noise (σ =
    0.4): (kernel state, plain state). Checks each engine's launches."""
    train, _ = load_pinwheel(seed=0)
    n, k, s = train.shape[0], 10, 4
    x = torch.tensor(train, dtype=torch.float32, device=dev)
    config = seed_sweep.make_config(n, precision)
    prior = gmm.make_prior(k, 2, kappa=0.05, device=dev)
    state = svae_step.init_state(torch.Generator(device=dev).manual_seed(0), 2, config, prior,
                                 (50, 50), (50, 50), data=x)
    rng = np.random.default_rng(17)
    eps = torch.tensor(rng.standard_normal((t, s, n, k, 2)), dtype=torch.float32, device=dev)
    aug = torch.tensor(rng.standard_normal((t, n, 2)), dtype=torch.float32, device=dev)
    out = {}
    for engine in ("kernel", "plain"):
        runner = loop.make_runner(config, prior, lr=1e-3, rho=0.05, aug_noise=0.4,
                                  engine=engine, kernel="tinystep")
        before = (tinystep.launches, tinystep.launches_bf16)
        out[engine], _ = runner(state, x, t, seed=0, eps=eps, aug_eps=aug)
        launched = (tinystep.launches - before[0], tinystep.launches_bf16 - before[1])
        want = (0, 0) if engine == "plain" else ((0, 1) if precision == "default" else (1, 0))
        assert launched == want, (engine, launched)
    return out["kernel"], out["plain"]


def groups(st_k, st_p) -> dict:
    """{group: (the kernel's tensors, the plain engine's)}."""
    return {"params": (_flat(st_k.nn_params), _flat(st_p.nn_params)),
            "adam m": (_flat(st_k.opt_state.mu), _flat(st_p.opt_state.mu)),
            "adam v": (_flat(st_k.opt_state.nu), _flat(st_p.opt_state.nu)),
            "naturals": ([st_k.pgm_nat.dir_nat, *st_k.pgm_nat.niw_nat],
                         [st_p.pgm_nat.dir_nat, *st_p.pgm_nat.niw_nat])}


def drift(st_k, st_p) -> dict:
    """{group: the largest, over its tensors, of max |kernel − plain| / max |plain|}."""
    return {name: max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(*pair))
            for name, pair in groups(st_k, st_p).items()}


@pytest.mark.parametrize("precision,tol", [("default", BF16_TOL), ("high", F32_TOL)])
@pytest.mark.parametrize("t", [3, 200])
def test_kernel_chunk_matches_the_plain_engine(dev, precision, tol, t):
    st_k, st_p = chunk_pair(dev, precision, t)
    if t == 3:
        for name, (got, want) in groups(st_k, st_p).items():
            rtol, atol = tol[name]
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=name)
    else:
        for name, value in drift(st_k, st_p).items():
            assert value <= DRIFT_200[name], (name, value)


def test_weight_decay_never_launches_a_whole_step_kernel(dev):
    tinystep.launches = tinystep.launches_bf16 = 0
    flexstep.launches = flexstep.launches_bf16 = 0
    out = train_svae.main(["--device", "cuda", "--steps", "20", "--eval-every", "10",
                           "--iw-samples", "0", "--weight-decay", "1e-3"])
    assert out["kernel"] == loop.PER_STEP and out["why"] == loop.PLAIN_ADAM
    auto = train_svae.main(["--config", "auto-svae", "--device", "cuda", "--steps", "20",
                            "--iw-samples", "0", "--weight-decay", "1e-3"])
    assert auto["kernel"] == loop.PER_STEP
    sweep = seed_sweep.main(["--variants", "wd0.001+aug0.4+steps20", "--chunk", "10",
                             "--seed-list", "0", "--iw-samples", "10", "--device", "cuda"])
    assert np.isfinite(sweep["results"]["wd0.001+aug0.4+steps20"]["rows"][0]["iw_per_point"])
    assert (tinystep.launches, tinystep.launches_bf16, flexstep.launches,
            flexstep.launches_bf16) == (0, 0, 0, 0)
    with pytest.raises(SystemExit):
        seed_sweep.main(["--variants", "wd0.001", "--engine", "kernel", "--device", "cuda"])


if __name__ == "__main__":
    # The drift readings behind DRIFT_200, both modes, one JSON line each.
    import subprocess
    import sys

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    torch.backends.cuda.matmul.allow_tf32 = False
    for precision in ("default", "high"):
        for t in (3, 200):
            reading = drift(*chunk_pair(torch.device("cuda"), precision, t))
            print(json.dumps({"nn_precision": precision, "steps": t, "drift": reading,
                              "card": card.strip()}), flush=True)
    sys.exit(0)
