"""The port's pin for the paper's central claim on its flagship dataset
(the counterpart of tests/test_pinwheel_crossing_pin.py): the port's
pinwheel recipe holds the JAX package's on the same protocol.

The recipe is the JAX pin's: input-noise augmentation σ = 0.4, 12,000
full-batch steps at constant ρ 0.05, one restart, scored by IW(500) on the
canonical seed-0 draw with draws keyed ``seed + 999``. The bar is the pure
conjugate GMM's exact posterior predictive, computed in the test from the
reference's own initial rows (``seed_sweep.gmm_bar``: 300 ρ = 1 steps,
then the exact Student-t predictive) and guarded, so that a broken mixture
leg shows. Both packages train model seeds 0–15, fixed before any run:
the port on tinystep's plain version, the JAX package as its pin does,
each run in a process of its own (32 runs of about 7 minutes a core:
27 minutes on 8 cores).

A single restart crosses the bar in a minority of seeds in both packages,
so a count of crossings cannot tell a sound port from a broken one at a
CPU run's size (ROADMAP.md §3). The pin asserts instead that the port's
mean IW over the 16 seeds lies within 3 standard errors of the JAX
recipe's mean over the same seeds, and reports both crossing counts. The
per-seed numbers come from this file run as a script, one process a run:

    python tests/test_torch_crossing_pin.py port SEED [RESTART]   # the port, plain
    JAX_PLATFORMS=cpu python tests/test_torch_crossing_pin.py reference SEED

``reference`` trains the JAX package's recipe exactly as
tests/test_pinwheel_crossing_pin.py does at its pinned seed (one restart,
PRNGKey(seed), IW(500) keyed seed + 999), at any seed. Each prints one
JSON line: seed, restart, IW/pt, last training ELBO/pt, seconds.
"""

import json
import math
import multiprocessing as mp
import os
import sys
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow
SEEDS = tuple(range(16))
STEPS, CHUNK, AUG, IW_SAMPLES = 12000, 1000, 0.4, 500
K_SE = 3.0  # the parity bar, in standard errors of the difference of means


def _train_one(job: tuple[int, int]) -> tuple[float, float]:
    """Restart ``r`` of the recipe at model seed ``seed`` with the port (its
    generators seeded ``seed + 1000·r``): (last training ELBO, IW(500)/pt)."""
    seed, r = job
    torch.set_num_threads(1)
    from svax_torch import seed_sweep
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.pgm import gmm

    train, test = load_pinwheel(seed=0)
    x = torch.tensor(train, dtype=torch.float32)
    xt = torch.tensor(test, dtype=torch.float32)
    config = seed_sweep.make_config(x.shape[0])
    prior = gmm.make_prior(10, 2, kappa=0.05)
    spec = seed_sweep.parse_variant(f"aug{AUG}+steps{STEPS}", steps=STEPS, chunk=CHUNK,
                                    engine="plain")
    runner = seed_sweep.make_variant_runner(config, prior, spec, engine="plain", rho=0.05)
    elbo, state, _ = seed_sweep.train_restarts(x, train, config, prior, runner, spec,
                                               seed + 1000 * r)
    return elbo, seed_sweep.iw_bound(state, xt, IW_SAMPLES, seed + 999)


def _run(job: tuple[str, int]) -> tuple[float, float]:
    """One run of the pin: ("port" or "reference", model seed)."""
    which, seed = job
    return _train_one((seed, 0)) if which == "port" else _reference_one(seed)


def test_port_recipe_matches_the_jax_recipe_on_pinwheel():
    from svax_torch import seed_sweep
    from svax_torch.data.pinwheel import load_pinwheel

    train, test = load_pinwheel(seed=0)
    bar = seed_sweep.gmm_bar(torch.tensor(train, dtype=torch.float32),
                             torch.tensor(test, dtype=torch.float32))
    assert -5.47 < bar < -5.35, f"GMM bar moved: {bar}"
    jobs = [(which, seed) for which in ("port", "reference") for seed in SEEDS]
    with mp.get_context("spawn").Pool(8) as pool:
        runs = dict(zip(jobs, pool.map(_run, jobs)))
    iw = {which: np.array([runs[(which, seed)][1] for seed in SEEDS])
          for which in ("port", "reference")}
    assert all(np.isfinite(v).all() for v in iw.values()), iw
    diff = iw["port"].mean() - iw["reference"].mean()
    se = math.sqrt(sum(v.var(ddof=1) / len(v) for v in iw.values()))
    crossed = {which: int((v > bar).sum()) for which, v in iw.items()}
    assert abs(diff) <= K_SE * se, (
        f"the port's mean IW/pt {iw['port'].mean():.4f} is {diff:+.4f} from the JAX "
        f"recipe's {iw['reference'].mean():.4f}, past {K_SE} standard errors ({se:.4f}); "
        f"crossings of {bar:.4f}: {crossed}; port {iw['port']}, JAX {iw['reference']}")


def _reference_one(seed: int) -> tuple[float, float]:
    """tests/test_pinwheel_crossing_pin.py's recipe at model seed ``seed``
    with the JAX package: (last training ELBO, IW(500)/pt)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import optax

    from svax.data import load_pinwheel
    from svax.models import evaluation
    from svax.models.svae import SvaeConfig
    from svax.pgm import gmm
    from svax.train import svae_step
    from svax.train.loop import augment_step, make_scan_runner

    train, test = load_pinwheel(seed=0)
    x, xt = jnp.asarray(train, jnp.float32), jnp.asarray(test, jnp.float32)
    prior = gmm.make_prior(10, 2, kappa=0.05)
    config = SvaeConfig(latent_dim=2, num_components=10, num_samples=4, num_total=x.shape[0])
    opt = optax.adam(1e-3)
    runner = make_scan_runner(augment_step(
        svae_step.make_train_step(config, prior, opt, rho=0.05), AUG), CHUNK)
    key = jax.random.PRNGKey(seed)
    state = svae_step.init_state(key, 2, config, prior, opt, (50, 50), (50, 50), data=x)
    kk = key
    for c in range(STEPS // CHUNK):
        kk = jax.random.fold_in(kk, c)
        state, mets = runner(state, x, kk)
    iw = jnp.mean(evaluation.svae_iw_loglik(state.nn_params, state.pgm_nat, xt,
                                            jax.random.PRNGKey(seed + 999), config,
                                            num_samples=IW_SAMPLES))
    return float(mets["elbo"][-1]), float(iw)


if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the repository
    which, seed = sys.argv[1], int(sys.argv[2])
    restart = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    t0 = time.perf_counter()
    elbo, iw = (_train_one((seed, restart)) if which == "port" else _reference_one(seed))
    print(json.dumps({"package": which, "seed": seed, "restart": restart, "iw": iw,
                      "train_elbo_per_point": elbo / 400,
                      "seconds": time.perf_counter() - t0}))
