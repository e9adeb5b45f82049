"""The port's comparison entry (``svax_torch.compare``) against the
reference's ``run_comparison`` (experiments/reproduce.py:122-448) and its
artifact ``runs/comparison.json``:

* a row built from two seeds has the reference row's keys for each
  dataset, and its budget the reference's keys and values, plus the
  port's kernel fields; the SVAE leg's routing under ``--engine kernel``;
* the GMM leg's prior at the data width, and 3 of its steps equal to the
  reference leg's from converted naturals (float64, rtol 1e-9); 3
  Bernoulli-mixture steps on the mnist surrogate likewise;
* the paired delta against a hand computation;
* a cut pinwheel row on the CPU, merged into ``--out`` beside the rows
  already there, with ``runs/comparison.json`` untouched and refused.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax_torch import compare, convert
from svax_torch.data import load_dataset
from svax_torch.models.gmm_baseline import GmmTrainState

torch.set_num_threads(1)
REFERENCE = Path(__file__).resolve().parent.parent / "runs" / "comparison.json"
PORT_BUDGET_KEYS = {"svae_kernel", "svae_kernel_mode", "svae_engine_reason"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _seed_row(best: float) -> dict:
    return {"iw_final": best - 0.01, "iw_best": best, "iw_best_step": 100}


@pytest.mark.parametrize("ds", ["pinwheel", "auto", "mnist"])
def test_row_keys_and_budget_match_the_reference(ds):
    ref = json.loads(REFERENCE.read_text())[ds]
    sp = compare.SPECS[ds]
    _, _, meta = load_dataset(ds, seed=0)
    from svax_torch.models.svae import SvaeConfig

    config = SvaeConfig(latent_dim=sp["d"], num_components=10, num_samples=sp["s"],
                        likelihood=meta["likelihood"])
    route = compare.route_svae(config, sp, "kernel", 784 if ds == "mnist" else
                               (2 if ds == "pinwheel" else 8))
    per = {"svae": [_seed_row(-5.0), _seed_row(-5.2)], "vae": [_seed_row(-5.1),
                                                               _seed_row(-5.3)]}
    mixture = ({"bernoulli_mixture_exact_predictive": -227.9, "note": compare.BMM_NOTE}
               if ds == "mnist" else {"exact_predictive": -5.4})
    row = json.loads(json.dumps(compare.build_row(sp, compare.summarize_seeds(per), route,
                                                  meta["synthetic"], mixture)))
    assert set(row) == set(ref)
    assert set(row["svae"]) == set(ref["svae"]) and set(row["paired_delta"]) == set(
        ref["paired_delta"])
    assert set(row["gmm"]) == set(ref["gmm"])
    assert set(row["budget"]) - PORT_BUDGET_KEYS == set(ref["budget"])
    for key, value in ref["budget"].items():
        if key not in ("svae_engine", "vae_engine"):
            assert row["budget"][key] == value, key
    assert row["budget"]["vae_engine"] == "step"
    assert row["synthetic_data"] == ref["synthetic_data"]
    assert row["seeds"] == 2
    # The reference ran its kernel engine ("mega") exactly where the port's
    # routing picks a kernel, in its f32 mode; mnist says why not.
    want = {"pinwheel": ("kernel", "tinystep"), "auto": ("kernel", "flexstep"),
            "mnist": ("step", None)}[ds]
    assert (row["budget"]["svae_engine"], row["budget"]["svae_kernel"]) == want
    assert (ref["budget"]["svae_engine"] == "mega") == (want[0] == "kernel")
    if want[0] == "kernel":
        assert row["budget"]["svae_kernel_mode"] == "f32"
        assert "svae_engine_reason" not in row["budget"]
    else:
        assert row["budget"]["svae_engine_reason"] == compare.WARMUP_REASON
    step_route = compare.route_svae(config, sp, "step", 2)
    assert step_route == {"engine": "step", "kernel": None, "mode": None, "reason": None}


def test_route_reports_why_a_kernel_does_not_fit():
    from svax_torch.models.svae import SvaeConfig

    sp = dict(compare.SPECS["pinwheel"], hidden=(32, 32, 32))
    route = compare.route_svae(SvaeConfig(latent_dim=2, num_components=10), sp, "kernel", 2)
    assert route["engine"] == "step" and "fits neither kernel" in route["reason"]
    bf16 = compare.route_svae(SvaeConfig(latent_dim=2, num_components=10,
                                         nn_precision="default"),
                              compare.SPECS["pinwheel"], "kernel", 2)
    assert bf16["mode"] == "bf16-products"


def test_paired_delta_by_hand():
    svae, vae = [-8.90, -8.95, -8.80], [-9.10, -9.00, -9.05]
    deltas = [0.20, 0.05, 0.25]
    mean = sum(deltas) / 3
    sd = math.sqrt(sum((d - mean) ** 2 for d in deltas) / 2)
    got = compare.paired_delta(svae, vae)
    assert got == {"mean": round(mean, 4), "sd": round(sd, 4),
                   "sem": round(sd / math.sqrt(3), 4), "wins": "3/3",
                   "mean_over_sem": round(mean / (sd / math.sqrt(3)), 2)}
    assert compare.paired_delta([1.0, 2.0], [1.0, 2.0])["mean_over_sem"] is None
    one = compare.summarize_seeds({"svae": [_seed_row(-1.0)], "vae": [_seed_row(-2.0)]})
    assert one == {"svae": _seed_row(-1.0), "vae": _seed_row(-2.0)}


def test_gmm_leg_at_data_width_matches_jax():
    """auto's GMM leg clusters the 8-D data, not the 4-D latents; 3 steps
    from the reference leg's converted naturals equal its steps."""
    from svax.models import evaluation as jevaluation
    from svax.models import gmm_baseline as jgmm_baseline
    from svax.pgm import gmm as jgmm

    train, test, _ = load_dataset("auto", seed=0)
    jprior = jgmm.make_prior(10, train.shape[1], alpha=1.0, kappa=0.05, dtype=jnp.float64)
    jstate = jgmm_baseline.init_state(jax.random.PRNGKey(0), jprior, jnp.asarray(train))
    state = convert.mixture_state_from_numpy(_np(jstate))
    row, got = compare.gmm_leg(torch.tensor(train), torch.tensor(test), 3, state=state)
    assert got.nat.niw_nat.eta1.shape == (10, 8)
    jstep = jax.jit(jgmm_baseline.make_train_step(jprior, 1.0, train.shape[0]))
    for _ in range(3):
        jstate, _ = jstep(jstate, jnp.asarray(train))
    for a, b in zip(convert.mixture_state_to_numpy(got)["nat"].values(),
                    (jstate.nat.dir_nat, *jstate.nat.niw_nat)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9)
    want = float(jevaluation.gmm_predictive_log_prob(jstate.nat, jnp.asarray(test)).mean())
    assert row == {"exact_predictive": round(want, 3)}
    drawn, st = compare.gmm_leg(torch.tensor(train, dtype=torch.float32),
                                torch.tensor(test, dtype=torch.float32), 2)
    assert isinstance(st, GmmTrainState) and math.isfinite(drawn["exact_predictive"])


def test_bmm_leg_on_the_mnist_surrogate_matches_jax():
    """3 Bernoulli-mixture steps at rho = 1 from the reference leg's
    converted naturals (float64): naturals at rtol 1e-9, the predictive row
    equal."""
    from svax.models import bmm_baseline as jbmm_baseline
    from svax.pgm import bmm as jbmm

    train, test, meta = load_dataset("mnist", seed=0)
    assert meta["synthetic"]
    x = jnp.asarray(train)
    jprior = jbmm.make_prior(10, train.shape[1], dtype=jnp.float64)
    jstate = jbmm_baseline.init_state(jax.random.PRNGKey(0), jprior, x)
    state = convert.bmm_state_from_numpy(_np(jstate))
    row, got = compare.bmm_leg(torch.tensor(train), torch.tensor(test), 3, state=state)
    jstep = jax.jit(jbmm_baseline.make_train_step(jprior, 1.0, train.shape[0]))
    for _ in range(3):
        jstate, _ = jstep(jstate, x)
    np.testing.assert_allclose(got.nat.dir_nat.numpy(), np.asarray(jstate.nat.dir_nat),
                               rtol=1e-9)
    np.testing.assert_allclose(got.nat.beta_nat.numpy(), np.asarray(jstate.nat.beta_nat),
                               rtol=1e-9)
    want = float(jbmm.predictive_log_prob(jstate.nat, jnp.asarray(test)).mean())
    assert row["bernoulli_mixture_exact_predictive"] == round(want, 3)
    assert row["note"] == json.loads(REFERENCE.read_text())["mnist"]["gmm"]["note"]


def test_cut_pinwheel_row_merges_into_out(tmp_path):
    """``compare --quick --device cpu --datasets pinwheel``: a finite row
    with the reference's one-seed keys, merged beside the rows already in
    --out; the reference's artifact is refused and left as it was."""
    before = REFERENCE.read_bytes()
    out = tmp_path / "cmp.json"
    out.write_text(json.dumps({"auto": {"kept": True}}))
    res = compare.main(["--quick", "--device", "cpu", "--datasets", "pinwheel",
                        "--out", str(out)])
    merged = json.loads(out.read_text())
    assert merged["auto"] == {"kept": True}
    row = merged["pinwheel"]
    assert row == json.loads(json.dumps(res["pinwheel"]["row"]))
    assert set(row) == set(json.loads(before)["pinwheel"]) - {
        "paired_delta", "svae_beats_vae_significant"}
    assert row["budget"]["steps"] == 200 and row["budget"]["iw"] == 20
    assert row["budget"]["svae_engine"] == "step" and row["seeds"] == 1
    for kind in ("svae", "vae"):
        assert math.isfinite(row[kind]["iw_best"]) and row[kind]["iw_best_step"] in (100, 200)
    assert row["svae_beats_vae"] == (row["svae"]["iw_best"] > row["vae"]["iw_best"])
    assert [leg["leg"] for leg in res["pinwheel"]["legs"]] == ["svae", "vae", "gmm"]
    for bad in ("runs/comparison.json", str(REFERENCE)):
        with pytest.raises(ValueError, match="reference's artifact"):
            compare.main(["--quick", "--device", "cpu", "--out", bad])
    assert REFERENCE.read_bytes() == before
    assert compare.DEFAULT_OUT == "runs/comparison_torch.json"


@pytest.mark.parametrize("ds", ["pinwheel", "auto", "mnist"])
def test_reference_init_rows_land_the_reference_rows(ds):
    """``REFERENCE_INIT_ROWS`` are the rows the reference's legs draw under
    PRNGKey(0); from them the port's leg (float32, the leg's step count)
    lands within 0.02 nat of the reference artifact's mixture figure."""
    train, test, _ = load_dataset(ds, seed=0)
    key = jax.random.PRNGKey(0)
    if ds != "mnist":
        key = jax.random.split(key)[1]  # gmm.init_variational's kpt
    want_rows = np.asarray(jax.random.choice(key, train.shape[0], (10,), replace=False))
    assert compare.REFERENCE_INIT_ROWS[ds] == want_rows.tolist()
    ref = json.loads(REFERENCE.read_text())[ds]["gmm"]
    x, xt = torch.tensor(train, dtype=torch.float32), torch.tensor(test, dtype=torch.float32)
    rows = compare.REFERENCE_INIT_ROWS[ds]
    if ds == "mnist":
        row, _ = compare.bmm_leg(x, xt, compare.SPECS[ds]["bmm_steps"], rows=rows)
        got, want = (row["bernoulli_mixture_exact_predictive"],
                     ref["bernoulli_mixture_exact_predictive"])
    else:
        row, _ = compare.gmm_leg(x, xt, compare.SPECS[ds]["gmm_steps"], rows=rows)
        got, want = row["exact_predictive"], ref["exact_predictive"]
    assert abs(got - want) < 0.02, (got, want)


def test_mixture_seeds_prints_the_legs_fixed_points(capsys):
    """``mixture_seeds`` runs the leg at its full steps per generator seed,
    as the leg itself does (the source of chip_smoke.py's floors)."""
    got = compare.mixture_seeds("auto", 2, "cpu")
    train, test, _ = load_dataset("auto", seed=0)
    x, xt = torch.tensor(train, dtype=torch.float32), torch.tensor(test, dtype=torch.float32)
    assert got == [compare.gmm_leg(x, xt, 300, seed=s)[0]["exact_predictive"] for s in (0, 1)]
    assert "mixture leg, generator seed 1" in capsys.readouterr().out
