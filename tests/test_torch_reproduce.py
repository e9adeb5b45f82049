"""``svax_torch.reproduce`` against ``experiments/reproduce.py``.

* ``--quick --stages gmm serve`` on the CPU (steps cut through ``main``'s
  ``steps``) writes a summary with the reference's keys;
* the ``gmm`` stage's exact predictive equals the reference's ``run_gmm``
  (60 ρ = 1 steps from ``gmm_baseline.init_state(PRNGKey(0))``) within
  1e-4: the port starts from the same K rows;
* the ``svae`` stage routes each row as ``choose_kernel`` does (tinystep,
  flexstep, the per-step engine) and ``auto-tt`` writes the trainer's
  summary, both cut short.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.data import load_pinwheel as jload_pinwheel
from svax.models import evaluation as jevaluation
from svax.models import gmm_baseline as jgmm_baseline
from svax.pgm import gmm as jgmm
from svax_torch import reproduce
from svax_torch.train import loop

torch.set_num_threads(1)
# The reference's row keys (experiments/reproduce.py run_gmm, run_svae,
# run_serve, run_auto_time_to_target with the trainer's summary).
GMM_KEYS = {"steps", "steps_per_sec", "elbo", "test_predictive_loglik", "cluster_purity"}
SVAE_KEYS = {"steps", "data_parallel", "steps_per_sec", "elbo", "test_elbo_per_point",
             "synthetic_data"}
SERVE_KEYS = {"bundle_roundtrip", "components_used", "mean_iw_loglik", "finite"}
TT_KEYS = {"metric", "best_value", "best_step", "best_wall_s", "target", "target_step",
           "target_wall_s", "stopped_early", "steps_run", "total_wall_s", "synthetic_data",
           "artifact"}


def _reference_run_gmm(steps: int) -> float:
    """experiments/reproduce.py's run_gmm, line for line: the predictive."""
    train, test, _, _ = jload_pinwheel(seed=0, return_labels=True)
    x = jnp.asarray(train, jnp.float32)
    prior = jgmm.make_prior(10, 2, alpha=1.0, kappa=0.05)
    state = jgmm_baseline.init_state(jax.random.PRNGKey(0), prior, x)
    step = jax.jit(jgmm_baseline.make_train_step(prior, 1.0, x.shape[0]))
    for _ in range(steps):
        state, _m = step(state, x)
    return float(jevaluation.gmm_predictive_log_prob(state.nat,
                                                     jnp.asarray(test, jnp.float32)).mean())


def test_quick_gmm_and_serve_summary(tmp_path):
    out = tmp_path / "summary_torch.json"
    res = reproduce.main(["--quick", "--stages", "gmm", "serve", "--device", "cpu",
                          "--out", str(out)], steps={"serve": 5})
    got = json.loads(out.read_text())
    assert set(got) == {"devices", "pinwheel-gmm", "serving"} and got["devices"] == "cpu"
    assert GMM_KEYS <= set(got["pinwheel-gmm"]) and SERVE_KEYS <= set(got["serving"])
    assert got["pinwheel-gmm"]["steps"] == 60 and got["pinwheel-gmm"]["components_used"] >= 6
    assert got["serving"]["finite"] and got["serving"]["bundle_roundtrip"]
    assert got["serving"]["kernel"] == "tinystep"
    assert set(res["seconds"]) == {"gmm", "serve"}
    pred = got["pinwheel-gmm"]["test_predictive_loglik"]
    assert abs(pred - _reference_run_gmm(60)) < 1e-4, pred
    with pytest.raises(ValueError, match="reference's artifacts"):
        reproduce.main(["--quick", "--stages", "gmm", "--device", "cpu", "--out",
                        "runs/reproduce_summary.json"])


def test_svae_stage_routes_each_row_and_auto_tt_writes_its_artifact(tmp_path):
    cut = {name: 2 for name, _, _ in reproduce.SVAE_ROWS}
    res = reproduce.main(["--quick", "--stages", "svae", "auto-tt", "--device", "cpu",
                          "--out", str(tmp_path / "s_torch.json"), "--auto-tt-out",
                          str(tmp_path / "tt_torch.json")], steps={**cut, "auto-tt": 100})
    rows = res["results"]
    want = {"pinwheel-svae": "tinystep", "auto-svae": "flexstep", "mnist-svae": loop.PER_STEP,
            "bigk-dp": loop.PER_STEP, "pinwheel-svae-smm": "tinystep"}
    for name, kernel in want.items():
        assert SVAE_KEYS <= set(rows[name]), name
        assert rows[name]["kernel"] == kernel and rows[name]["steps"] == 2
        assert np.isfinite(rows[name]["elbo"]) and np.isfinite(rows[name]["test_elbo_per_point"])
    tt = rows["auto-time-to-target"]
    assert TT_KEYS <= set(tt) and tt["kernel"] == "flexstep" and tt["steps_run"] == 100
    assert json.loads((tmp_path / "tt_torch.json").read_text())["best_step"] == 100
    step_rows = reproduce.run_svae("auto", True, torch.device("cpu"), engine="step", d=4,
                                   hidden=(100, 100), batch=64, steps=2)
    assert step_rows["kernel"] == loop.PER_STEP


def test_reproduce_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reproduce.main(["--quick"])
