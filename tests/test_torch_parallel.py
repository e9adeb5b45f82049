"""The port's data × component parallelism (``svax_torch.parallel``) on the
CPU, over gloo, against the JAX reference's shard_map mesh and against the
port's own single-process step.

One group of four spawned ranks (``mesh.spawn``, a 120 s timeout) computes
every sharded quantity at once; the tests below each hold one of them:

* ``expected_params``, ``lse_over_components`` and ``kl_global`` under a
  4-way component group against the unsharded values at rtol 1e-12 in
  float64 (tests/test_comp_parallel.py:28-70);
* one 2×2 data × comp SVAE step, GMM and SMM prior, against the reference's
  ``data_comp_parallel_step`` on a 2×2 virtual mesh and against the port's
  single-process step on the whole batch: the naturals at rtol 1e-9, atol
  1e-10, the local and global KL at 1e-9 (the recipe of
  tests/test_comp_parallel.py:72-175; four ranks, not eight);
* the 4-way comp-sharded forward and NN gradient with injected per-shard ε,
  fused (the ρ-kernel and log_norm combine's plain versions) and unfused,
  against the reference's single-device forward at 2e-4 and 5e-4
  (tests/test_combine_kernel.py:265-338);
* ten GMM DP steps on a 4-rank data mesh against the single-process
  trajectory of both packages at 1e-10 (tests/test_parallel.py:53-80);
* the autograd semantics of ``mesh.psum`` and the seeds ``fold_seed``
  makes.

A second group runs ``dryrun_multichip(4, "cpu", "gloo")``. This module
imports neither JAX nor the JAX package at its top: the spawned ranks
import it to find their function, and they must stay free of both.
"""

import sys

import numpy as np
import pytest
import torch

from svax_torch import convert
from svax_torch.parallel import mesh

torch.set_num_threads(1)

K, D, N = 8, 2, 64  # the comp tests' mixture and batch
LR, RHO = 1e-3, 0.4


def _loaded_reference_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "svax", "configs"))


def _ranks(rank: int, world: int, dev, p: dict) -> dict:
    """Everything the tests hold, computed on one of four ranks."""
    import torch.distributed as dist

    from svax_torch.models import gmm_baseline, svae
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step

    m14, m22, m41 = (mesh.make_data_comp_mesh(a, b) for a, b in ((1, 4), (2, 2), (4, 1)))
    out = {}

    # Expected parameters, the cross-shard logsumexp, the global KL.
    g = m14.comp_group
    nat = convert.shard_nat(p["nat"], m14.comp_idx, 4)
    prior = convert.shard_nat(p["prior"], m14.comp_idx, 4)
    exp = gmm.expected_params(nat, g)
    out["exp"] = gmm.GmmExpected(*mesh.all_gather_rows(list(exp), g))
    out["kl"] = gmm.kl_global(nat, prior, g)
    cols = slice(m14.comp_idx * 2, (m14.comp_idx + 1) * 2)
    out["lse"] = gmm.lse_over_components(p["log_rho"][:, cols], g)

    # One 2x2 data x comp step, GMM and SMM prior.
    for name in ("gmm", "smm"):
        config = SvaeConfig(latent_dim=D, num_components=K, num_samples=1, num_total=N,
                            dof=4.0 if name == "smm" else 0.0)
        prior_l = convert.shard_nat(p["prior"], m22.comp_idx, 2)
        state = p[f"state_{name}"]
        state = state._replace(pgm_nat=convert.shard_nat(state.pgm_nat, m22.comp_idx, 2))
        step = svae_step.make_train_step(config, prior_l, LR, RHO, data_group=m22.data_group,
                                         comp_group=m22.comp_group)
        gen = torch.Generator().manual_seed(mesh.fold_seed(0, m22.data_idx, m22.comp_idx))
        half = N // 2
        new, mets = step(state, p["x"][m22.data_idx * half:(m22.data_idx + 1) * half],
                         generator=gen)
        out[f"step_{name}"] = {"nat": convert.gather_nat(new.pgm_nat, m22.comp_group),
                               "local_kl": float(mets["local_kl"]),
                               "global_kl": float(mets["global_kl"]),
                               "nn": new.nn_params}

    # The comp-sharded forward and its NN gradient, with injected ε.
    f = p["fwd"]
    nat = convert.shard_nat(f["nat"], m14.comp_idx, 4)
    prior = convert.shard_nat(f["prior"], m14.comp_idx, 4)
    eps = f["eps"][:, :, m14.comp_idx * 2:(m14.comp_idx + 1) * 2]
    for fused in (True, False):
        config = SvaeConfig(latent_dim=D, num_components=K, num_samples=2,
                            num_total=f["x"].shape[0], fused_combine=fused)
        params = svae_step.map_params(lambda t: t.clone().requires_grad_(True), f["nn"])
        o = svae.forward(params, nat, prior, f["x"], config, eps=eps, comp_group=m14.comp_group)
        leaves = [t for side in params.values() for ly in side for t in ly.values()]
        grads = mesh.psum_tensors(list(torch.autograd.grad(-o.elbo, leaves)), m14.comp_group)
        stats = mesh.all_gather_rows([t.detach() for t in o.suff_stats], m14.comp_group)
        out[f"fwd_fused_{fused}"] = {
            "elbo": float(o.elbo.detach()), "recon": float(o.recon.detach()),
            "local_kl": float(o.local_kl.detach()), "global_kl": float(o.global_kl.detach()),
            "stats": stats, "grads": [t / 4 for t in grads]}

    # Ten GMM steps on a 4-rank data mesh.
    t = p["traj"]
    quarter = t["x"].shape[0] // 4
    step = gmm_baseline.make_train_step(t["prior"], 0.7, num_total=t["x"].shape[0],
                                        data_group=m41.data_group)
    state = gmm_baseline.GmmTrainState(nat=t["nat"], step=0)
    for _ in range(10):
        state, mets = step(state, t["x"][m41.data_idx * quarter:(m41.data_idx + 1) * quarter])
    out["traj"] = {"nat": state.nat, "elbo": float(mets["elbo"])}

    # psum's backward sums the cotangents over the group.
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    mesh.psum(x * (rank + 1), dist.group.WORLD).sum().backward()
    out["psum_grad"] = x.grad
    out["seed"] = mesh.fold_seed(7, m22.data_idx, m22.comp_idx)
    out["loaded"] = _loaded_reference_modules()
    return out


def _nat_np(nat) -> list[np.ndarray]:
    return [np.asarray(t) for t in (nat.dir_nat, *nat.niw_nat)]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's inputs and states, and the port's copies of them."""
    import jax
    import jax.numpy as jnp
    import optax

    from svax.data import make_pinwheel_data
    from svax.models.svae import SvaeConfig as JConfig
    from svax.pgm import gmm as jgmm
    from svax.train import svae_step as jstep

    key = jax.random.PRNGKey(0)
    f64 = jnp.float64
    x = jnp.asarray(make_pinwheel_data(num_classes=4, num_per_class=16, seed=0), f64)
    prior = jgmm.make_prior(K, D, dtype=f64)
    opt = optax.adam(LR)
    states = {}
    for name, dof in (("gmm", 0.0), ("smm", 4.0)):
        config = JConfig(latent_dim=D, num_components=K, num_samples=1, num_total=N, dof=dof)
        states[name] = jstep.init_state(key, 2, config, prior, opt, (8,), (8,), data=x,
                                        dtype=f64)
    rng = np.random.default_rng(0)
    nat = jgmm.init_variational(key, prior)

    # The comp-sharded forward's inputs (tests/test_combine_kernel.py:273-287).
    from svax.models import svae as jsvae
    fconfig = JConfig(latent_dim=D, num_components=K, num_samples=2, num_total=32)
    f32 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32), t)  # noqa: E731
    fprior = f32(jgmm.make_prior(K, D))
    fnn = f32(jsvae.init_params(key, 2, fconfig, (8,), (8,)))
    fnat = f32(jgmm.init_variational(key, fprior))
    frng = np.random.default_rng(13)
    fx = frng.standard_normal((32, 2)).astype(np.float32)
    feps = frng.standard_normal((2, 32, K, D)).astype(np.float32)

    tx = np.asarray(make_pinwheel_data(num_classes=5, num_per_class=48, seed=1))
    tprior = jgmm.make_prior(5, 2, dtype=f64)
    from svax.models import gmm_baseline as jbase
    tstate = jbase.init_state(jax.random.PRNGKey(1), tprior, jnp.asarray(tx))

    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    nat_t = lambda t: convert.gmm_nat_from_numpy(tree(t))  # noqa: E731
    port = {
        "nat": nat_t(nat), "prior": nat_t(prior),
        "log_rho": torch.tensor(rng.standard_normal((16, K)) * 5.0),
        "x": torch.tensor(np.asarray(x)),
        "state_gmm": convert.state_from_numpy(tree(states["gmm"])),
        "state_smm": convert.state_from_numpy(tree(states["smm"])),
        "fwd": {"nn": convert.state_from_numpy(tree(jstep.SvaeTrainState(
                    fnn, opt.init(fnn), fnat, jnp.zeros((), jnp.int32)))).nn_params,
                "nat": nat_t(fnat), "prior": nat_t(fprior), "x": torch.tensor(fx),
                "eps": torch.tensor(feps)},
        "traj": {"x": torch.tensor(tx), "prior": nat_t(tprior), "nat": nat_t(tstate.nat)},
    }
    return {"key": key, "x": x, "prior": prior, "opt": opt, "states": states, "nat": nat,
            "port": port, "fwd": (fconfig, fnn, fnat, fprior, fx, feps),
            "traj": (tx, tprior, tstate)}


@pytest.fixture(scope="module")
def ranks(ref):
    return mesh.spawn(_ranks, 4, "cpu", "gloo", args=(ref["port"],), timeout=120.0)


def test_ranks_load_neither_jax_nor_the_reference(ranks):
    assert all(r["loaded"] == [] for r in ranks)


def test_sharded_expected_params_and_kl_match(ref, ranks):
    from svax.pgm import gmm as jgmm

    want_exp = jgmm.expected_params(ref["nat"])
    want_kl = float(jgmm.kl_global(ref["nat"], ref["prior"]))
    for r in ranks:
        np.testing.assert_allclose(float(r["kl"]), want_kl, rtol=1e-12)
        for f in want_exp._fields:
            np.testing.assert_allclose(getattr(r["exp"], f).numpy(),
                                       np.asarray(getattr(want_exp, f)), rtol=1e-12,
                                       err_msg=f)


def test_lse_over_components_matches(ref, ranks):
    want = torch.logsumexp(ref["port"]["log_rho"], dim=-1).numpy()
    for r in ranks:
        np.testing.assert_allclose(r["lse"].numpy(), want, rtol=1e-12)


def _reference_2x2_step(ref, name):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from svax.models import svae as jsvae, svae_smm
    from svax.models.svae import SvaeConfig as JConfig
    from svax.parallel import mesh as pmesh
    from svax.train import svae_step as jstep

    model = svae_smm if name == "smm" else jsvae
    config = JConfig(latent_dim=D, num_components=K, num_samples=1, num_total=N,
                     dof=4.0 if name == "smm" else 0.0)
    m = pmesh.make_data_comp_mesh(2, 2)
    step_for = lambda prior_l: jstep.make_train_step(  # noqa: E731
        config, prior_l, ref["opt"], rho=RHO, axis_name="data", axis_comp="comp",
        model=model)
    dp = pmesh.data_comp_parallel_step(step_for, ref["prior"], m)
    x_sharded = jax.device_put(ref["x"], NamedSharding(m, P("data")))
    return dp(ref["states"][name], x_sharded, ref["key"])


@pytest.mark.parametrize("name", ["gmm", "smm"])
def test_2x2_step_matches_the_reference_and_the_single_process_step(ref, ranks, name):
    """The naturals after one 2×2 step are MC-free closed forms: equal to
    the reference's data_comp_parallel_step and to the port's own step on
    the whole batch; so are the local and global KL."""
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.train import svae_step

    want_state, want_mets = _reference_2x2_step(ref, name)
    config = SvaeConfig(latent_dim=D, num_components=K, num_samples=1, num_total=N,
                        dof=4.0 if name == "smm" else 0.0)
    single, single_mets = svae_step.make_train_step(config, ref["port"]["prior"], LR, RHO)(
        ref["port"][f"state_{name}"], ref["port"]["x"],
        generator=torch.Generator().manual_seed(0))
    for r in ranks:
        got = r[f"step_{name}"]
        for a, b, c in zip(_nat_np(got["nat"]), _nat_np(want_state.pgm_nat),
                           _nat_np(single.pgm_nat)):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-10)
            np.testing.assert_allclose(a, c, rtol=1e-9, atol=1e-10)
        for what in ("local_kl", "global_kl"):
            np.testing.assert_allclose(got[what], float(want_mets[what]), rtol=1e-9)
            np.testing.assert_allclose(got[what], float(single_mets[what]), rtol=1e-9)
        leaves = [t for side in got["nn"].values() for ly in side for t in ly.values()]
        assert all(bool(torch.isfinite(t).all()) for t in leaves)
    # The NN params are replicated: every rank took the same Adam step.
    first = ranks[0][f"step_{name}"]["nn"]
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(
            svae_step.map_params(lambda t: t, first)["encoder"][0].values(),
            r[f"step_{name}"]["nn"]["encoder"][0].values()))


@pytest.mark.parametrize("fused", [True, False])
def test_comp_sharded_forward_and_gradient_match_the_reference(ref, ranks, fused):
    """The 4-way comp-sharded forward (fused: the ρ-kernel, the cross-shard
    lse and the log_norm combine, their plain versions here; unfused:
    sin_combine across the group) against the reference's single-device
    forward at matched ε: ELBO pieces, statistics, NN gradients."""
    import jax

    from svax.models import svae as jsvae

    config, nn, nat, prior, x, eps = ref["fwd"]
    cfg = config._replace(fused_combine=False)
    key = ref["key"]
    want = jsvae.forward(nn, nat, prior, x, key, cfg, eps=eps)
    want_g = jax.grad(lambda p: -jsvae.forward(p, nat, prior, x, key, cfg, eps=eps).elbo)(nn)
    want_g = [np.asarray(want_g[side][i][name]) for side in ("encoder", "decoder")
              for i in range(len(want_g[side])) for name in ("w", "b")]
    for r in ranks:
        got = r[f"fwd_fused_{fused}"]
        np.testing.assert_allclose(got["recon"], float(want.recon), rtol=2e-4)
        np.testing.assert_allclose(got["local_kl"], float(want.local_kl), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got["global_kl"], float(want.global_kl), rtol=1e-5)
        np.testing.assert_allclose(got["elbo"], float(want.elbo), rtol=2e-4)
        for a, b in zip(got["stats"], want.suff_stats):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)
        for a, b in zip(got["grads"], want_g):
            np.testing.assert_allclose(a.numpy(), b, rtol=5e-4, atol=5e-4)


def test_gmm_dp_trajectory_is_mesh_invariant(ref, ranks):
    """Ten GMM CVI steps on a 4-rank data mesh equal ten single-process
    steps on the whole batch, the port's and the reference's."""
    import jax

    from svax.models import gmm_baseline as jbase
    from svax_torch.models import gmm_baseline

    tx, tprior, tstate = ref["traj"]
    jstep = jax.jit(jbase.make_train_step(tprior, 0.7, num_total=tx.shape[0]))
    p = ref["port"]["traj"]
    step = gmm_baseline.make_train_step(p["prior"], 0.7, num_total=tx.shape[0])
    jst, st = tstate, gmm_baseline.GmmTrainState(nat=p["nat"], step=0)
    for _ in range(10):
        jst, jmets = jstep(jst, tx)
        st, mets = step(st, p["x"])
    for r in ranks:
        for a, b, c in zip(_nat_np(r["traj"]["nat"]), _nat_np(jst.nat), _nat_np(st.nat)):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)
            np.testing.assert_allclose(a, c, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(r["traj"]["elbo"], float(jmets["elbo"]), rtol=1e-10)


def test_psum_backward_sums_the_cotangents(ranks):
    """transpose(psum) = psum: a replicated loss's gradient comes out
    group-size times each rank's own share (the step divides it out)."""
    for rank, r in enumerate(ranks):
        assert r["psum_grad"].tolist() == [4.0 * (rank + 1)] * 2


def test_fold_seed_gives_each_rank_its_own_seed(ranks):
    seeds = [r["seed"] for r in ranks]
    assert len(set(seeds)) == 4 and all(0 <= s < 2**63 for s in seeds)
    assert seeds[0] == mesh.fold_seed(7, 0, 0) != mesh.fold_seed(8, 0, 0)


def test_shard_and_unshard_round_trip(ref):
    nat = ref["port"]["nat"]
    shards = [convert.shard_nat(nat, i, 4) for i in range(4)]
    assert shards[1].dir_nat.shape == (2,) and shards[1].niw_nat.eta3.shape == (2, D, D)
    back = convert.unshard_nat(shards)
    assert all(np.array_equal(a, b) for a, b in zip(_nat_np(back), _nat_np(nat)))
    with pytest.raises(ValueError, match="equal component shards"):
        convert.shard_nat(nat, 0, 3)


def test_dryrun_multichip_prints_three_ok_lines(capsys):
    from svax_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, "cpu", "gloo")
    lines = capsys.readouterr().out.splitlines()
    ok = [ln for ln in lines if ln.startswith("dryrun_multichip(4): ") and " ok " in ln]
    assert len(ok) == 3 and all("2x2 data x comp mesh" in ln for ln in ok), lines
    assert (out["data"], out["comp"]) == (2, 2)
    for name in ("toy", "bigk", "smm"):
        assert np.isfinite(out[name]["elbo"]) and out[name]["nat_err"] < 1e-5


def test_dryrun_runs_on_the_card_unless_asked(monkeypatch):
    """The dry run defaults to the card (rank r on cuda:r over NCCL) and
    raises where there is none; the CPU is asked for by name."""
    from svax_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)


def test_init_distributed_never_stacks_ranks_on_one_card(monkeypatch):
    """Device "cuda" puts rank r on cuda:LOCAL_RANK and raises past the
    host's card count before joining any group."""
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(RuntimeError, match="name the device"):
        mesh.init_distributed("cuda")


def _local_rank(rank, world, dev):
    import os

    return int(os.environ["LOCAL_RANK"]), str(dev)


def test_spawn_gives_each_rank_its_local_rank():
    assert mesh.spawn(_local_rank, 2, "cpu", timeout=60.0) == [(0, "cpu"), (1, "cpu")]


def test_whole_step_kernels_are_refused_under_sharding():
    """tinystep, flexstep and mixstep are single-device (svax/train/loop.py:
    117-118, :336-337): under sharding the auto engine runs per step and an
    explicit kernel request raises."""
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.ops import mixstep
    from svax_torch.train import loop

    config = SvaeConfig(latent_dim=2, num_components=10, num_samples=4, num_total=400)
    gate = dict(batch_full=True, encoder_hidden=(50, 50), decoder_hidden=(50, 50), rho=0.05)
    assert loop.choose_kernel(config, engine="auto", **gate) == "tinystep"
    assert loop.choose_kernel(config, engine="auto", **gate, data_parallel=True) == loop.PER_STEP
    with pytest.raises(ValueError, match="single-device"):
        loop.choose_kernel(config, **gate, data_parallel=True)
    ok = dict(data_dim=2, batch_full=True, rho=1.0, num_points=400, num_components=10)
    assert mixstep.unsupported_reason(**ok) is None
    assert "single-device" in mixstep.unsupported_reason(**ok, data_parallel=True)


def test_train_gmm_dp_refuses_the_mixstep_engine():
    from svax_torch import train_gmm

    with pytest.raises(ValueError, match="single-device"):
        train_gmm.main(["--config", "pinwheel-gmm", "--device", "cpu", "--dp", "--steps", "2"])


def test_train_gmm_dp_on_two_ranks_matches_one_process(tmp_path):
    """train_gmm --dp --engine plain on two ranks (torch.distributed.run,
    gloo): rank 0 alone prints, and the run ends where the one-process run
    ends, up to float32 sums taken in another order."""
    import json
    import os
    import subprocess

    from svax_torch import train_gmm

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["--config", "pinwheel-gmm", "--engine", "plain", "--device", "cpu",
            "--steps", "30", "--eval-every", "10"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "svax_torch.train_gmm", *argv, "--dp"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": root}, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert sum("dp world_size=2" in ln for ln in lines) == 1, lines
    assert [json.loads(ln)["step"] for ln in lines if ln.startswith('{"step"')] == [1, 10, 20, 30]
    got = json.loads(lines[-1])
    want = train_gmm.main(argv)
    np.testing.assert_allclose(got["test_predictive_loglik_per_point"],
                               want["test_predictive_loglik_per_point"], rtol=1e-5)
    assert got["train_cluster_purity"] == want["train_cluster_purity"]


def test_sampled_recon_is_refused_with_the_reference_reason():
    """recon_mode="sampled" needs the full responsibility row
    (svax/models/svae.py:399-404): refused under component parallelism,
    run without it; an unknown estimator is refused."""
    from svax_torch.models import svae
    from svax_torch.models.svae import SvaeConfig

    config = SvaeConfig(latent_dim=2, num_components=4, recon_mode="sampled")
    with pytest.raises(ValueError, match="does not compose with component parallelism"):
        svae.check_recon_mode(config, comp_group=object())
    svae.check_recon_mode(config)
    with pytest.raises(ValueError, match="unknown recon_mode"):
        svae.check_recon_mode(config._replace(recon_mode="stratified"))
    svae.check_recon_mode(config._replace(recon_mode="weighted"), comp_group=object())
