"""The port's training harness (``svax_torch.train.trainer``, ``metrics``,
``utils.guards``, the entries' harness flags and ``svax_torch.evaluate``)
against the JAX package and against its own runners:

* ``GmmTrainer.fit`` from a converted JAX state equals the JAX
  ``GmmTrainer.fit``'s naturals and logged ``test_evidence_per_point``
  (float32, rtol 1e-5; both deterministic);
* ``SvaeTrainer.fit`` equals the same runner driven by hand, bit for bit,
  on both engines (the trainer adds no arithmetic);
* best tracking, time-to-target and patience (tests/test_trainer.py:83-140),
  the loud gates (:170, :365, :406), auto's fallback off CUDA (:216, :418),
  resume skipping the warmup (:430), and one two-rank gloo data-parallel fit;
* ``train_svae --checkpoint-dir/--resume/--logfile/--debug-nans/--bundle-dir``
  and ``evaluate`` on the CPU, ``train_gmm --logfile``.

JAX is imported inside the tests that use it: the spawned ranks import this
module to find their function and stay free of it.
"""

import json

import numpy as np
import pytest
import torch

from svax_torch.data.pinwheel import make_pinwheel_data
from svax_torch.models.svae import SvaeConfig
from svax_torch.train import loop, svae_step
from svax_torch.train.checkpoint import Checkpointer
from svax_torch.train.metrics import JsonlLogger, read_jsonl
from svax_torch.train.trainer import GmmTrainer, SmmTrainer, SvaeTrainer, TrainerConfig
from svax_torch.utils import guards
from svax_torch.utils.tree import flatten

torch.set_num_threads(1)


def _data(dtype=np.float32):
    x = make_pinwheel_data(num_classes=3, num_per_class=30, seed=0).astype(dtype)
    return x[:72], x[72:]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for (_, x), (_, y) in zip(flatten(a), flatten(b)))


def _tc(**kw) -> TrainerConfig:
    base = dict(device="cpu", encoder_hidden=(8, 8), decoder_hidden=(8, 8), lr=3e-3,
                rho=0.2)
    base.update(kw)
    return TrainerConfig(**base)


def _mc(latent=2, k=4, s=1, n=72):
    return SvaeConfig(latent_dim=latent, num_components=k, num_samples=s, num_total=n)


# ------------------------------------------------------------ against JAX


def test_gmm_trainer_matches_jax_trainer(tmp_path):
    import jax
    import jax.numpy as jnp

    from svax.models import gmm_baseline as jbase
    from svax.pgm import gmm as jgmm
    from svax.train.metrics import read_jsonl as jread
    from svax.train.trainer import GmmTrainer as JGmmTrainer
    from svax.train.trainer import TrainerConfig as JTrainerConfig
    from svax_torch import convert

    x_train, x_test = _data()
    kw = dict(steps=30, eval_every=10, rho=0.8)
    jprior = jgmm.make_prior(5, 2, dtype=jnp.float32)
    jstate = jbase.init_state(jax.random.PRNGKey(0), jprior, jnp.asarray(x_train))
    jlog = tmp_path / "j.jsonl"
    jfinal = JGmmTrainer(JTrainerConfig(logfile=str(jlog), **kw), num_components=5,
                         data_dim=2).fit(jnp.asarray(x_train), jnp.asarray(x_test),
                                         state=jstate)
    state0 = convert.mixture_state_from_numpy(jax.tree.map(np.asarray, jstate))
    plog = tmp_path / "p.jsonl"
    final = GmmTrainer(TrainerConfig(device="cpu", logfile=str(plog), **kw),
                       num_components=5, data_dim=2).fit(x_train, x_test, state=state0)
    assert final.step == int(jfinal.step) == 30
    got, want = convert.mixture_state_to_numpy(final)["nat"], jfinal.nat
    np.testing.assert_allclose(got["dir_nat"], np.asarray(want.dir_nat), rtol=1e-5)
    for f in ("eta1", "eta2", "eta3", "eta4"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(want.niw_nat, f)), rtol=1e-5,
                                   atol=1e-5)
    prow, jrow = read_jsonl(plog), jread(jlog)
    assert [r["step"] for r in prow] == [r["step"] for r in jrow] == [10, 20, 30]
    np.testing.assert_allclose([r["test_evidence_per_point"] for r in prow],
                               [r["test_evidence_per_point"] for r in jrow], rtol=1e-5)
    np.testing.assert_allclose([r["elbo"] for r in prow], [r["elbo"] for r in jrow],
                               rtol=1e-5)


# ------------------------------------------------- the trainer adds nothing


@pytest.mark.parametrize("engine,batch,kernel", [("step", 0, None), ("step", 24, None),
                                                 ("kernel", 0, "tinystep"),
                                                 ("kernel", 24, "flexstep")])
def test_svae_fit_equals_runner_by_hand(engine, batch, kernel):
    x_train, _ = _data()
    x = torch.tensor(x_train)
    hidden = (16, 16) if kernel == "tinystep" else (8, 8)
    mc = _mc(s=2, latent=3 if kernel == "flexstep" else 2)
    tc = _tc(steps=12, eval_every=4, batch_size=batch, engine=engine, seed=3,
             rho_decay=0.01 if kernel == "flexstep" else 0.0, encoder_hidden=hidden,
             decoder_hidden=hidden)
    trainer = SvaeTrainer(mc, tc, input_dim=2)
    got = trainer.fit(x_train)
    assert trainer.engine == engine and trainer.kernel == (kernel or loop.PER_STEP)
    prior = trainer.prior
    state = svae_step.init_state(torch.Generator().manual_seed(3), 2, mc, prior, hidden,
                                 hidden, data=x)
    kw = dict(lr=3e-3, rho=0.2, rho_decay=tc.rho_decay, batch_size=batch)
    if kernel:
        runner = loop.make_runner(mc, prior, kernel=kernel, **kw)
    else:
        runner = loop.make_step_runner(mc, prior, **kw)
    for _ in range(3):
        state, _ = runner(state, x, 4, seed=3)
    assert got.step == state.step == 12
    assert _equal(got, state)


def test_fit_logs_jsonl_rows(tmp_path):
    x_train, x_test = _data()
    log = tmp_path / "log.jsonl"
    trainer = SvaeTrainer(_mc(), _tc(steps=40, eval_every=20, logfile=str(log)), 2)
    state = trainer.fit(x_train, x_test)
    assert state.step == 40
    rows = read_jsonl(log)
    assert [r["step"] for r in rows] == [20, 40]
    for key in ("wall_s", "elbo", "recon", "local_kl", "global_kl", "rho",
                "test_elbo_per_point"):
        assert np.isfinite(rows[-1][key]), key
    assert rows[-1]["elbo"] > rows[0]["elbo"]


def test_best_tracking_and_time_to_target(tmp_path):
    x_train, x_test = _data()
    art = tmp_path / "tt.json"
    tc = _tc(steps=60, eval_every=10, scan_chunk=10, checkpoint_dir=str(tmp_path / "ck"),
             target_value=-1e6, best_artifact=str(art))
    trainer = SvaeTrainer(_mc(), tc, input_dim=2)
    trainer.fit(x_train, x_test)
    best = trainer.best
    assert set(best) == {"metric", "best_value", "best_step", "best_wall_s", "target",
                         "target_step", "target_wall_s", "stopped_early", "steps_run",
                         "total_wall_s"}
    assert best["metric"] == "test_elbo_per_point"
    assert np.isfinite(best["best_value"])
    assert 0 < best["best_step"] <= 60
    assert best["target_step"] == 10  # the first eval
    assert best["target_wall_s"] is not None
    assert best["stopped_early"] is False and best["steps_run"] == 60
    assert json.loads(art.read_text()) == best
    assert trainer.best_state is not None and trainer.best_state.step == best["best_step"]
    assert trainer.best_state.pgm_nat.dir_nat.device.type == "cpu"
    best_ckpt = Checkpointer(tmp_path / "ck" / "best")
    assert best_ckpt.all_steps() == [best["best_step"]]
    assert Checkpointer(tmp_path / "ck").all_steps() == [40, 50, 60]


def test_early_stop_at_patience():
    x_train, x_test = _data()
    tc = _tc(steps=500, eval_every=10, scan_chunk=10, patience=1, min_delta=1e9)
    trainer = SvaeTrainer(_mc(), tc, input_dim=2)
    state = trainer.fit(x_train, x_test)
    assert trainer.best["stopped_early"] is True
    assert trainer.best["steps_run"] == 20  # eval 1 sets best, eval 2 stops
    assert state.step == 20


# --------------------------------------------------------------- the gates


def test_kernel_engine_refuses_outside_its_class():
    x_train, _ = _data()
    trainer = SvaeTrainer(_mc(latent=7), _tc(steps=2, engine="kernel"), input_dim=2)
    with pytest.raises(ValueError, match="engine='kernel': fits neither kernel"):
        trainer.fit(x_train)


def test_svae_kernel_engine_refuses_an_unroll():
    x_train, _ = _data()
    trainer = SvaeTrainer(_mc(), _tc(steps=2, engine="kernel", megakernel_unroll=4), 2)
    with pytest.raises(ValueError, match="megakernel_unroll"):
        trainer.fit(x_train)


def test_gmm_kernel_engine_refuses_minibatches():
    x_train, _ = _data()
    trainer = GmmTrainer(_tc(steps=2, batch_size=16, engine="kernel"), 4, 2)
    with pytest.raises(ValueError, match="full batch"):
        trainer.fit(x_train)


def test_warmup_on_mixture_trainer_raises():
    x_train, _ = _data()
    with pytest.raises(NotImplementedError, match="warmup"):
        GmmTrainer(_tc(steps=4, rho=0.5, warmup_steps=5), 4, 2).fit(x_train)


def test_unknown_engine_and_missing_card_raise():
    with pytest.raises(ValueError, match="unknown engine"):
        SvaeTrainer(_mc(), _tc(engine="xla"), 2)
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SvaeTrainer(_mc(), TrainerConfig(), 2)


def test_auto_engine_falls_back_off_cuda():
    x_train, x_test = _data()
    trainer = SvaeTrainer(_mc(), _tc(steps=4, eval_every=2, engine="auto"), 2)
    assert trainer.make_kernel_runner() is None  # CPU: no kernel
    state = trainer.fit(x_train, x_test)
    assert state.step == 4 and trainer.engine == "step"
    gmm = GmmTrainer(_tc(steps=4, eval_every=2, rho=0.5, engine="auto"), 4, 2)
    assert gmm.make_kernel_runner() is None
    assert gmm.fit(x_train).step == 4 and gmm.engine == "step"


# ------------------------------------------------------ resume and warmup


def test_resume_bitexact_and_skips_warmup(tmp_path):
    """Interrupt at a chunk boundary, resume with a fresh trainer: the final
    state equals the uninterrupted run's bit for bit, and the warmup does
    not run again past step 0."""
    x_train, _ = _data()
    calls = []

    class SpyTrainer(SvaeTrainer):
        def warmup(self, state, x):
            calls.append(self.tc.steps)
            return super().warmup(state, x)

    def tc(steps, ck):
        return _tc(steps=steps, eval_every=4, scan_chunk=4, engine="kernel",
                   warmup_steps=4, checkpoint_dir=str(ck), encoder_hidden=(16, 16),
                   decoder_hidden=(16, 16))

    mc = _mc(s=2)
    ref = SpyTrainer(mc, tc(8, tmp_path / "ref"), 2).fit(x_train)
    assert calls == [8]
    SpyTrainer(mc, tc(4, tmp_path / "cut"), 2).fit(x_train)
    assert calls == [8, 4]
    trainer = SpyTrainer(mc, tc(8, tmp_path / "cut"), 2)
    resumed = trainer.fit(x_train)
    assert calls == [8, 4]  # restored step 4 > 0: no second warmup
    assert trainer.kernel == "tinystep" and resumed.step == 8
    assert _equal(ref, resumed)


@pytest.mark.parametrize("cls,kw", [(GmmTrainer, {}), (SmmTrainer, {"dof": 4.0})])
def test_mixture_kernel_engine_resume(tmp_path, cls, kw):
    """mixstep's plain version through the trainer: resume equals the
    uninterrupted fit, and the kernel engine equals the per-step engine's
    naturals (one step's arithmetic, two routes)."""
    x_train, x_test = _data()

    def fit(steps, ck, engine="kernel"):
        tc = _tc(steps=steps, eval_every=4, rho=0.5, engine=engine, checkpoint_dir=ck)
        return cls(tc, 4, 2, **kw).fit(x_train, x_test)

    ref = fit(12, str(tmp_path / "a"))
    fit(8, str(tmp_path / "b"))
    resumed = fit(12, str(tmp_path / "b"))
    assert resumed.step == 12 and _equal(ref, resumed)
    step = fit(12, "", engine="step")
    np.testing.assert_allclose(ref.nat.niw_nat.eta1.numpy(), step.nat.niw_nat.eta1.numpy(),
                               rtol=3e-4, atol=3e-4)


def test_warmup_reseed_through_trainer():
    x_train, x_test = _data()
    mc = _mc(latent=3)
    tc = _tc(steps=20, eval_every=10, scan_chunk=10, warmup_steps=20,
             encoder_hidden=(16,), decoder_hidden=(16,))
    trainer = SvaeTrainer(mc, tc, input_dim=2)
    state = trainer.fit(x_train, x_test)
    assert state.step == 20  # the reseed resets the step counter
    info = trainer.warmup_info
    assert info["seed_occupancy"] >= 2 and info["cov_scale"] > 0
    assert bool((state.pgm_nat.niw_nat.eta2 > 0).all())


# -------------------------------------------------------- data parallelism


def _tensors(state) -> list:
    return [t.numpy() for _, t in flatten(state) if isinstance(t, torch.Tensor)]


def _dp_ranks(rank: int, world: int, dev, x_train, x_test) -> dict:
    """One rank of a two-rank group: a data-parallel SVAE fit (full batch), a
    component-sharded one (a 1x2 mesh, K = 4 in two shards), and a
    data-parallel GMM fit (float64)."""
    svae = SvaeTrainer(_mc(k=3), _tc(steps=6, eval_every=3, data_parallel=True), 2)
    s = svae.fit(x_train, x_test)
    comp = SvaeTrainer(_mc(k=4), _tc(steps=4, eval_every=2, data_parallel=True,
                                     component_shards=2), 2)
    c = comp.fit(x_train, x_test)
    g = GmmTrainer(_tc(steps=15, eval_every=5, rho=0.7, data_parallel=True), 4, 2)
    gs = g.fit(x_train.astype(np.float64))
    return {"svae": _tensors(s), "comp": _tensors(c), "k": c.pgm_nat.dir_nat.shape[0],
            "mesh": (comp.mesh.data, comp.mesh.comp), "comp_best": comp.best,
            "gmm": [t.numpy() for t in (gs.nat.dir_nat, *gs.nat.niw_nat)],
            "best": svae.best, "data": svae.mesh.data, "step": s.step}


def test_data_parallel_fit_on_two_ranks():
    """Two gloo ranks on the CPU: every rank ends with the same state (the
    component-sharded fit's naturals gathered to the whole K after every
    chunk); the GMM's full-batch statistics summed over the ranks equal one
    process's (float64, rtol 1e-10)."""
    from svax_torch.parallel import mesh

    x_train, x_test = _data()
    out = mesh.spawn(_dp_ranks, 2, "cpu", "gloo", args=(x_train, x_test), timeout=120.0)
    assert out[0]["data"] == 2 and out[0]["step"] == 6
    for a, b in zip(out[0]["svae"], out[1]["svae"]):
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(a).all() for a in out[0]["svae"])
    assert out[0]["mesh"] == (1, 2) and out[0]["k"] == 4
    for a, b in zip(out[0]["comp"], out[1]["comp"]):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(out[0]["comp_best"]["best_value"])
    assert out[0]["best"] == {**out[1]["best"], "best_wall_s": out[0]["best"]["best_wall_s"],
                              "total_wall_s": out[0]["best"]["total_wall_s"]}
    one = GmmTrainer(_tc(steps=15, eval_every=5, rho=0.7), 4, 2).fit(
        x_train.astype(np.float64))
    for got, want in zip(out[0]["gmm"], (one.nat.dir_nat, *one.nat.niw_nat)):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-10)


def test_data_parallel_needs_ranks():
    x_train, _ = _data()
    with pytest.raises(ValueError, match="torch.distributed"):
        SvaeTrainer(_mc(), _tc(steps=2, data_parallel=True), 2).fit(x_train)
    with pytest.raises(ValueError, match="component_shards"):
        SvaeTrainer(_mc(), _tc(steps=2, component_shards=2), 2).fit(x_train)


# ---------------------------------------------------- metrics and guards


def test_jsonl_logger_rows_and_echo(tmp_path, capsys):
    path = tmp_path / "sub" / "m.jsonl"
    with JsonlLogger(path) as log:
        row = log.log(3, loss=torch.tensor(1.5), name="x")
        log.log(4, loss=2.0)
    assert list(row)[:2] == ["step", "wall_s"] and row["loss"] == 1.5 and row["name"] == "x"
    rows = read_jsonl(path)
    assert [r["step"] for r in rows] == [3, 4]
    assert capsys.readouterr().out.count('"step"') == 2
    JsonlLogger(path, echo=False).log(5, loss=3.0)
    assert capsys.readouterr().out == "" and len(read_jsonl(path)) == 3


def test_guards_name_the_leaf():
    x_train, _ = _data()
    state = svae_step.init_state(torch.Generator().manual_seed(0), 2, _mc(),
                                 svae_step.gmm.make_prior(4, 2), (8,), (8,))
    guards.assert_finite(state, "state")
    assert int(guards.count_nonfinite(state)) == 0
    bad = state.nn_params["encoder"][0]["w"].clone()
    bad[0, 1] = float("nan")
    bad[1, 1] = float("inf")
    state = state._replace(nn_params={**state.nn_params, "encoder": [
        {**state.nn_params["encoder"][0], "w": bad}, *state.nn_params["encoder"][1:]]})
    with pytest.raises(FloatingPointError, match=r"state\.nn_params\.encoder\.0\.w"):
        guards.assert_finite(state, "state")
    count = guards.count_nonfinite(state)
    assert isinstance(count, torch.Tensor) and int(count) == 2
    with pytest.raises(FloatingPointError, match=r"metrics\.elbo"):
        guards.assert_finite({"elbo": float("nan"), "step": 3}, "metrics")


# --------------------------------------------------------------- entries


@pytest.fixture
def small_pinwheel(monkeypatch):
    """pinwheel-svae with chunks of 10 steps, so a resume lands on a chunk
    boundary within a few CPU seconds; anomaly mode is undone after."""
    from svax_torch.configs import CONFIGS

    monkeypatch.setitem(CONFIGS, "pinwheel-svae", {**CONFIGS["pinwheel-svae"],
                                                   "scan_chunk": 10})
    yield
    torch.autograd.set_detect_anomaly(False)
    monkeypatch.setattr(guards, "_debug_nans", False)


def test_train_svae_resume_is_bitexact(tmp_path, small_pinwheel):
    from svax_torch import evaluate, serve, train_svae

    base = ["--config", "pinwheel-svae", "--device", "cpu", "--iw-samples", "0"]
    a = train_svae.main(base + ["--steps", "20", "--checkpoint-dir", str(tmp_path / "a"),
                                "--iw-samples", "5", "--bundle-dir", str(tmp_path / "bund")])
    train_svae.main(base + ["--steps", "10", "--checkpoint-dir", str(tmp_path / "b")])
    log = tmp_path / "rows.jsonl"
    b = train_svae.main(base + ["--steps", "20", "--checkpoint-dir", str(tmp_path / "b"),
                                "--resume", "--logfile", str(log), "--debug-nans"])
    assert guards.nan_debugging()
    assert [r["step"] for r in a["rows"]] == [10, 20] and [r["step"] for r in b["rows"]] == [20]
    assert read_jsonl(log) == b["rows"]
    assert b["rows"][0]["test_elbo_per_point"] == a["rows"][1]["test_elbo_per_point"]
    assert _equal(a["state"], b["state"])
    fa = torch.load(tmp_path / "a" / "step_20.pt", weights_only=True)["state"]
    fb = torch.load(tmp_path / "b" / "step_20.pt", weights_only=True)["state"]
    assert fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)
    assert Checkpointer(tmp_path / "a").all_steps() == [10, 20]
    # The checkpoint reproduces the entry's last test ELBO and its IW bound.
    ev = evaluate.main(["--checkpoint-dir", str(tmp_path / "a"), "--config", "pinwheel-svae",
                        "--device", "cpu", "--iw-samples", "5"])
    assert ev["checkpoint_step"] == 20
    assert ev["test_elbo_per_point"] == a["rows"][-1]["test_elbo_per_point"]
    assert ev["test_iw_loglik_per_point"] == a["final_test_iw_loglik_per_point"]
    # The bundle serves the trained state.
    server = serve.load_bundle(tmp_path / "bund", buckets=(8,), device="cpu")
    assert server.spec.num_components == 10 and server.spec.num_samples == 4
    assert torch.equal(server._nat.dir_nat, a["state"].pgm_nat.dir_nat)


def test_train_svae_resume_flag_needs_a_directory():
    from svax_torch import train_svae

    with pytest.raises(SystemExit):
        train_svae.main(["--config", "pinwheel-svae", "--device", "cpu", "--resume"])


def test_train_gmm_logfile(tmp_path):
    from svax_torch import train_gmm

    log = tmp_path / "g.jsonl"
    out = train_gmm.main(["--config", "pinwheel-gmm", "--device", "cpu", "--steps", "40",
                          "--logfile", str(log)])
    rows = read_jsonl(log)
    assert rows == out["rows"] and [r["step"] for r in rows] == [20, 40]
    assert set(rows[0]) == {"step", "wall_s", "elbo", "test_evidence_per_point"}
