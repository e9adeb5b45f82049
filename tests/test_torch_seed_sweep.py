"""``svax_torch.seed_sweep`` against ``experiments/seed_sweep.py``.

* the warmup ρ ramp equals the reference's ``make_rho`` ramp (its three
  lines, in JAX) at steps across and past the ramp;
* the per-draw bar: the reference's ``gmm_init`` rows depend on the key and
  N alone (``compare.REFERENCE_INIT_ROWS["pinwheel"]`` on every N = 400
  draw), and ``gmm_bar`` on draws 0–2 equals the reference's ``gmm_bar``
  procedure (300 ρ = 1 steps from ``gmm_baseline.init_state(PRNGKey(0))``,
  then the exact predictive) within 1e-4;
* k-means++ init equals the reference's, restart selection keeps the best
  last training ELBO, and the variant parser refuses what the reference's
  refuses, with its messages;
* a tiny sweep (2 seeds × ``aug0.4+rs2+steps20``, chunk 10, IW 20) on
  ``plain`` (tinystep's plain version) and on ``step`` writes the reference
  artifact's JSON keys.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.data import load_pinwheel as jload_pinwheel
from svax.models import evaluation as jevaluation
from svax.models import gmm_baseline as jgmm_baseline
from svax.pgm import gmm as jgmm
from svax.pgm.init import init_variational_kmeanspp as jkmeanspp
from svax_torch import compare, seed_sweep
from svax_torch.data.pinwheel import load_pinwheel
from svax_torch.pgm import gmm
from svax_torch.pgm.init import init_variational_kmeanspp

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _reference_ramp(step, lo=1e-3, hi=0.05, t_ramp=3000):
    """experiments/seed_sweep.py's make_rho(warm=True), line for line."""
    frac = jnp.minimum(jnp.asarray(step, jnp.int32).astype(jnp.float32) / t_ramp, 1.0)
    return lo + (hi - lo) * frac


def test_warmup_ramp_equals_the_reference():
    rho = seed_sweep.warmup_rho(1e-3, 0.05, 3000)
    for step in (0, 1, 7, 1499, 2999, 3000, 3001, 15000):
        want = float(_reference_ramp(step))
        assert rho(step) == pytest.approx(want, rel=1e-7, abs=0.0), step
    assert rho(0) == pytest.approx(1e-3) and rho(10**6) == pytest.approx(0.05)


def test_reference_init_rows_depend_on_the_key_and_n_only():
    rows = np.asarray(compare.REFERENCE_INIT_ROWS["pinwheel"])
    _, kpt = jax.random.split(jax.random.PRNGKey(0))
    assert (np.asarray(jax.random.choice(kpt, 400, (10,), replace=False)) == rows).all()
    jprior = jgmm.make_prior(10, 2, kappa=0.05)
    for seed in (0, 3):
        train, _ = jload_pinwheel(seed=seed)
        assert train.shape == (400, 2)
        x = jnp.asarray(train, jnp.float32)
        nat = jgmm_baseline.init_state(jax.random.PRNGKey(0), jprior, x).nat
        locs = (np.asarray(nat.niw_nat.eta1) - np.asarray(jprior.niw_nat.eta1)) / 2.0
        np.testing.assert_allclose(locs, np.asarray(train, np.float32)[rows], rtol=1e-6)


def _reference_bar(train, test):
    """experiments/seed_sweep.py's gmm_bar, line for line."""
    prior = jgmm.make_prior(10, 2, kappa=0.05)
    st = jgmm_baseline.init_state(jax.random.PRNGKey(0), prior,
                                  jnp.asarray(train, jnp.float32))
    step_g = jax.jit(jgmm_baseline.make_train_step(prior, 1.0, len(train)))
    for _ in range(300):
        st, _m = step_g(st, jnp.asarray(train, jnp.float32))
    return float(jevaluation.gmm_predictive_log_prob(st.nat, jnp.asarray(test, jnp.float32))
                 .mean())


@pytest.mark.parametrize("draw", [0, 1, 2])
def test_per_draw_bar_equals_the_reference(draw):
    train, test = load_pinwheel(seed=draw)
    got = seed_sweep.gmm_bar(torch.tensor(train, dtype=torch.float32),
                             torch.tensor(test, dtype=torch.float32))
    want = _reference_bar(*jload_pinwheel(seed=draw))
    assert abs(got - want) < 1e-4, (got, want)
    if draw == 0:
        assert abs(got - seed_sweep.GMM_PREDICTIVE_BAR) < 0.01


def test_kpp_init_and_restart_selection():
    train, _ = load_pinwheel(seed=0)
    x = torch.tensor(train, dtype=torch.float32)
    prior = gmm.make_prior(10, 2, kappa=0.05)
    config = seed_sweep.make_config(400)
    seen = []

    def runner(state, x_, t_steps, seed):
        seen.append((seed, state.pgm_nat))
        # A last training ELBO that peaks at the second restart.
        return state, {"elbo": torch.tensor([-abs(seed - 1005.0)])}

    spec = seed_sweep.parse_variant("kpp+rs3+steps20", steps=15000, chunk=10, engine="step")
    assert (spec["restarts"], spec["steps"], spec["chunk"], spec["kpp"]) == (3, 20, 10, True)
    elbo, state, _ = seed_sweep.train_restarts(x, train, config, prior, runner, spec, seed=5)
    assert [s for s, _ in seen] == [5, 5, 1005, 1005, 2005, 2005]
    assert elbo == -0.0 and state.pgm_nat is seen[2][1]
    # The naturals each restart starts from: the reference's k-means++ at
    # seed + 1000·r (both in float32).
    jprior = jax.tree.map(lambda a: a.astype(jnp.float32), jgmm.make_prior(10, 2, kappa=0.05))
    for r, (_, nat) in zip(range(3), seen[::2]):
        want = jkmeanspp(jprior, np.asarray(train), seed=5 + 1000 * r)
        np.testing.assert_allclose(nat.niw_nat.eta1.numpy(), np.asarray(want.niw_nat.eta1),
                                   rtol=1e-6)
        np.testing.assert_allclose(nat.dir_nat.numpy(), np.asarray(want.dir_nat), rtol=1e-6)
        assert torch.equal(nat.niw_nat.eta3, init_variational_kmeanspp(
            prior, train, seed=5 + 1000 * r).niw_nat.eta3)


def _reference_exit(argv, monkeypatch) -> str:
    """The reference sweep's SystemExit message for ``argv`` (it refuses
    before training)."""
    monkeypatch.setattr(sys, "argv", ["seed_sweep.py", *argv])
    spec = importlib.util.spec_from_file_location("_ref_seed_sweep",
                                                  ROOT / "experiments" / "seed_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(SystemExit) as got:
        mod.main()
    return str(got.value)


@pytest.mark.parametrize("variant,engine", [("steps1500", "step"), ("steps1500", "kernel"),
                                            ("warmup", "kernel"), ("wd0.01+aug0.4", "kernel"),
                                            ("kpp+warmup", "plain")])
def test_variant_errors_match_the_reference(variant, engine, monkeypatch):
    with pytest.raises(SystemExit) as got:
        seed_sweep.parse_variant(variant, steps=15000, chunk=1000, engine=engine)
    ref_engine = {"step": "xla", "kernel": "mega", "plain": "mega"}[engine]
    want = _reference_exit(["--variants", variant, "--engine", ref_engine], monkeypatch)
    want = want.replace("--engine mega", f"--engine {engine}").replace(
        "--engine xla", "--engine step")
    assert str(got.value) == want
    # What the reference accepts, the port accepts.
    seed_sweep.parse_variant("kpp+warmup+wd0.01+steps2000+aug0.4+rs2", steps=15000,
                             chunk=1000, engine="step")


@pytest.mark.parametrize("engine", ["plain", "step"])
def test_tiny_sweep_writes_the_reference_schema(engine, tmp_path, capsys):
    out = tmp_path / "sweep_torch.json"
    res = seed_sweep.main(["--device", "cpu", "--variants", "aug0.4+rs2+steps20", "--chunk",
                           "10", "--num-seeds", "2", "--iw-samples", "20", "--engine", engine,
                           "--json", str(out)])
    ref = json.loads((ROOT / "runs" / "seed_sweep_r5_mega_default32.json").read_text())
    got = json.loads(out.read_text())
    assert set(got) == set(ref) == {"config", "results"}
    assert set(ref["config"]) - {"platform"} <= set(got["config"])
    ref_v, got_v = ref["results"]["aug0.4+rs2"], got["results"]["aug0.4+rs2+steps20"]
    assert set(got_v) == set(ref_v)
    assert set(got_v["summary"]) == set(ref_v["summary"])
    assert [set(r) for r in got_v["rows"]] == [set(ref_v["rows"][0])] * 2
    assert [r["seed"] for r in got_v["rows"]] == [0, 1]
    for r in got_v["rows"]:
        assert all(np.isfinite(r[k]) for k in ("iw_per_point", "final_elbo_per_point",
                                               "test_elbo_per_point"))
        assert r["gmm_bar"] == seed_sweep.GMM_PREDICTIVE_BAR
    assert got_v["summary"]["crossing"].endswith("/2") and res["engine"] == engine
    printed = capsys.readouterr().out
    assert "[aug0.4+rs2+steps20] seed 1: IW/pt" in printed and "== aug0.4+rs2+steps20" in printed
    with pytest.raises(ValueError, match="reference's artifacts"):
        seed_sweep.main(["--device", "cpu", "--json", str(ROOT / "runs" / "sweep.json")])


def test_full_head_runs_on_the_step_engine(capsys):
    res = seed_sweep.main(["--device", "cpu", "--variants", "steps4", "--chunk", "2",
                           "--seed-list", "3", "--iw-samples", "4", "--engine", "kernel",
                           "--encoder-head", "full"])
    assert res["engine"] == "step"
    assert np.isfinite(res["results"]["steps4"]["rows"][0]["iw_per_point"])
    assert "--encoder-head full runs on the step engine" in capsys.readouterr().out


def test_sweep_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seed_sweep.main(["--variants", "base"])
