"""Run the workloads end to end with the port and write a summary table
(``experiments/reproduce.py``).

    python -m svax_torch.reproduce [--quick] [--stages all|gmm|svae|comparison|auto-tt|serve ...]
        [--comparison-seeds N]
        [--comparison-datasets pinwheel auto mnist] [--comparison-engine step|kernel]
        [--out reproduce_summary_torch.json] [--auto-tt-out runs/auto_tt_torch.json]
        [--comparison-out runs/comparison_torch.json] [--device cuda|cpu]

The stages run with the reference's own settings (not the named configs'):

* ``gmm`` — the pure GMM on pinwheel (K = 10, ρ = 1, 300 full-batch steps,
  60 under ``--quick``) on mixstep, one launch, from the K data rows the
  reference's ``gmm_baseline.init_state(PRNGKey(0), ...)`` draws
  (``compare.REFERENCE_INIT_ROWS``): the row's test predictive is the
  reference's. Its ``elbo`` is the last step's bound at the post-chunk
  naturals (the runner's); the reference logs it at the last step's
  pre-update naturals.
* ``svae`` — five SVAE rows at the reference's shapes (``SVAE_ROWS``:
  pinwheel-svae, auto-svae, mnist-svae, bigk-dp and pinwheel-svae-smm, the
  Student-t prior at dof 4), Adam at 1e-3, constant ρ, nn_precision "high",
  the initial state from a generator seeded 0. Each runs through
  ``loop.choose_kernel``: tinystep for the pinwheel rows (chunks of at most
  1000 steps), flexstep for auto-svae (minibatches of 64 drawn with
  replacement), and the per-step engine for mnist-svae and bigk-dp
  (minibatches drawn without replacement, the plain combine: the
  reference's stage runs no fused switch). bigk-dp runs on one process here.
  ``--quick`` caps the steps at 100, and a batch above 128 at 128 with 20
  steps, as the reference's.
* ``comparison`` — ``svax_torch.compare`` with ``--comparison-seeds``,
  ``--comparison-datasets`` and ``--comparison-engine``, its rows merged
  into ``--comparison-out``.
* ``auto-tt`` — auto-svae's time to the target test ELBO −12.40 through
  ``train.trainer.SvaeTrainer`` on flexstep (10,000 steps of 64, ρ 0.2 /
  (1 + 0.001·t), evaluations every 250 steps, patience 8; ``--quick``: 200
  steps, evaluations every 100, no target or patience), writing the
  trainer's summary to ``--auto-tt-out``.
* ``serve`` — trains the pinwheel model (400 points, 200 steps at ρ 0.1, 20
  under ``--quick``) on tinystep, writes a bundle, reloads it
  (``serve.load_bundle``) and encodes and scores 100 points.

Prints one line a workload and writes them all, with ``"devices"`` the
card's name, to ``--out``. On CPU tensors every kernel runs its plain
version; ``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

STAGES = ("gmm", "svae", "comparison", "auto-tt", "serve")
# The reference's svae stage (experiments/reproduce.py:508-516): name,
# dataset and run_svae's keywords.
SVAE_ROWS = (
    ("pinwheel-svae", "pinwheel", {}),
    ("auto-svae", "auto", dict(d=4, hidden=(100, 100), batch=64, steps_full=5000, rho=0.2)),
    ("mnist-svae", "mnist", dict(d=8, s=1, hidden=(200, 200), batch=256, steps_full=5000,
                                 rho=0.1)),
    ("bigk-dp", "mnist", dict(k=100, d=10, s=1, hidden=(200, 200), batch=512,
                              steps_full=1000, rho=0.1)),
    ("pinwheel-svae-smm", "pinwheel", dict(dof=4.0)),
)
LR = 1e-3
KERNEL_CHUNK, STEP_CHUNK = 1000, 200


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_gmm(quick: bool, device: torch.device, steps: int | None = None) -> dict:
    """The pure-GMM row: {"steps", "steps_per_sec", "elbo",
    "test_predictive_loglik", "cluster_purity"} and the port's
    "components_used" (the hard assignment's distinct components)."""
    from svax_torch.compare import REFERENCE_INIT_ROWS
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.models import evaluation, gmm_baseline
    from svax_torch.pgm import gmm
    from svax_torch.train import loop

    train, test, labels, _ = load_pinwheel(seed=0, return_labels=True)
    x = torch.tensor(train, dtype=torch.float32, device=device)
    xt = torch.tensor(test, dtype=torch.float32, device=device)
    steps = steps or (60 if quick else 300)
    prior = gmm.make_prior(10, 2, alpha=1.0, kappa=0.05, device=device)
    state = gmm_baseline.init_state(None, prior, x, rows=torch.as_tensor(
        REFERENCE_INIT_ROWS["pinwheel"], device=device))
    runner = loop.make_mixture_runner(prior, rho=1.0)
    t0 = time.perf_counter()
    state, mets = runner(state, x, steps)
    _sync(device)
    rate = steps / (time.perf_counter() - t0)
    with torch.no_grad():
        resp, _ = gmm.e_step_obs(x, gmm.expected_params(state.nat))
        pred = evaluation.gmm_predictive_log_prob(state.nat, xt)
    return {"steps": steps, "steps_per_sec": round(rate, 1),
            "elbo": float(mets["elbo"][-1]),
            "test_predictive_loglik": float(pred.mean()),
            "cluster_purity": evaluation.cluster_purity(resp, labels),
            "components_used": int(torch.unique(resp.argmax(-1)).numel())}


def run_svae(dataset: str, quick: bool, device: torch.device, *, engine: str = "kernel",
             k: int = 10, d: int = 2, s: int = 4, hidden=(50, 50), batch: int = 0,
             steps_full: int = 2000, rho: float = 0.05, dof: float = 0.0,
             steps: int | None = None) -> dict:
    """One SVAE row at the reference's ``run_svae`` settings: {"steps",
    "data_parallel", "steps_per_sec", "elbo", "test_elbo_per_point",
    "synthetic_data", "kernel"}; ``steps`` overrides the step count and
    ``engine="step"`` skips ``choose_kernel`` for the per-step engine."""
    from svax_torch.data import load_dataset
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import loop, svae_step

    train, test, meta = load_dataset(dataset, seed=0)
    x = torch.tensor(train, dtype=torch.float32, device=device)
    xt = torch.tensor(test, dtype=torch.float32, device=device)
    n = x.shape[0]
    n_steps = min(100 if quick else steps_full, steps_full)
    if quick and batch > 128:
        batch, n_steps = 128, 20
    n_steps = steps or n_steps
    batch = batch or n
    config = SvaeConfig(latent_dim=d, num_components=k, num_samples=s,
                        likelihood=meta["likelihood"], num_total=n, dof=dof)
    prior = gmm.make_prior(k, d, alpha=1.0, kappa=0.05, device=device)
    state = svae_step.init_state(torch.Generator(device=device).manual_seed(0), x.shape[1],
                                 config, prior, hidden, hidden, data=x)
    kernel = loop.PER_STEP
    if engine == "kernel":
        kernel = loop.choose_kernel(config, engine="auto", batch_full=batch >= n,
                                    encoder_hidden=hidden, decoder_hidden=hidden, rho=rho,
                                    likelihood=config.likelihood, input_dim=x.shape[1])
    if kernel == loop.PER_STEP:
        runner = loop.make_step_runner(config, prior, lr=LR, rho=rho, batch_size=batch,
                                       replace=False)
        chunk = STEP_CHUNK
    else:
        runner = loop.make_runner(config, prior, lr=LR, rho=rho, batch_size=batch,
                                  kernel=kernel)
        chunk = KERNEL_CHUNK
    t0 = time.perf_counter()
    t = 0
    while t < n_steps:
        todo = min(chunk, n_steps - t)
        state, mets = runner(state, x, todo, seed=0)
        t += todo
    _sync(device)
    rate = n_steps / (time.perf_counter() - t0)
    ev = svae_step.make_eval_fn(config, prior)(
        state, xt, generator=torch.Generator(device=device).manual_seed(1))
    return {"steps": n_steps, "data_parallel": False, "steps_per_sec": round(rate, 1),
            "elbo": float(mets["elbo"][-1]),
            "test_elbo_per_point": float(ev["elbo_per_point"]),
            "synthetic_data": bool(meta.get("synthetic", False)), "kernel": kernel}


def run_auto_time_to_target(quick: bool, device: torch.device, artifact: str,
                            steps: int | None = None) -> dict:
    """auto-svae's time to −12.40 through ``SvaeTrainer`` on flexstep: the
    trainer's summary plus "synthetic_data" and "artifact"."""
    from svax_torch.data import load_dataset
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.train.trainer import SvaeTrainer, TrainerConfig

    train, test, meta = load_dataset("auto", seed=0)
    mc = SvaeConfig(latent_dim=4, num_components=10, num_samples=4,
                    likelihood=meta["likelihood"], num_total=train.shape[0])
    tc = TrainerConfig(
        steps=steps or (200 if quick else 10000), batch_size=64,
        eval_every=100 if quick else 250, scan_chunk=100 if quick else 250,
        lr=LR, rho=0.2, rho_decay=0.001,
        encoder_hidden=(100, 100), decoder_hidden=(100, 100),
        patience=0 if quick else 8, target_value=None if quick else -12.40,
        best_artifact=artifact, engine="kernel", device=str(device))
    trainer = SvaeTrainer(mc, tc, input_dim=train.shape[1])
    trainer.fit(train.astype(np.float32), test.astype(np.float32))
    row = dict(trainer.best)
    row["synthetic_data"] = bool(meta.get("synthetic", False))
    row["artifact"] = artifact
    row["kernel"] = trainer.kernel
    return row


def run_serve(quick: bool, device: torch.device, steps: int | None = None) -> dict:
    """Train briefly on tinystep, bundle, reload, encode and score: {
    "bundle_roundtrip", "components_used", "mean_iw_loglik", "finite"}."""
    from svax_torch import serve
    from svax_torch.data.pinwheel import make_pinwheel_data
    from svax_torch.train import loop, svae_step

    spec = serve.ModelSpec(input_dim=2, latent_dim=2, num_components=10,
                           likelihood="gaussian", encoder_hidden=(50, 50),
                           decoder_hidden=(50, 50), num_samples=4, num_total=400)
    x = torch.tensor(make_pinwheel_data(num_per_class=80, seed=0), dtype=torch.float32,
                     device=device)
    config = spec.to_config()._replace(num_total=x.shape[0])
    prior = spec.make_prior(device)
    state = svae_step.init_state(torch.Generator(device=device).manual_seed(0), 2, config,
                                 prior, spec.encoder_hidden, spec.decoder_hidden, data=x)
    kernel = loop.choose_kernel(config, engine="megakernel", batch_full=True,
                                encoder_hidden=spec.encoder_hidden,
                                decoder_hidden=spec.decoder_hidden, rho=0.1, input_dim=2)
    runner = loop.make_runner(config, prior, lr=LR, rho=0.1, kernel=kernel)
    state, _ = runner(state, x, steps or (20 if quick else 200), seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        serve.save_bundle(tmp, state, spec)
        server = serve.load_bundle(tmp, buckets=(64, 512), device=device)
        enc = server.encode(x[:100].cpu().numpy())
        score = server.score(x[:100].cpu().numpy(), num_samples=20)
    return {"bundle_roundtrip": True,
            "components_used": int(np.unique(enc["component"]).size),
            "mean_iw_loglik": round(float(score.mean()), 3),
            "finite": bool(np.isfinite(score).all()), "kernel": kernel}


def main(argv: list[str] | None = None, steps: dict | None = None) -> dict:
    """Run the stages; returns {"results", "seconds"}: the written summary
    and each stage's seconds. ``steps`` ({stage or svae row name: steps})
    cuts a stage's step count (a test's smaller run)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--quick", action="store_true", help="smoke-scale steps")
    p.add_argument("--stages", nargs="+", default=["all"], choices=["all", *STAGES])
    p.add_argument("--comparison-seeds", type=int, default=1)
    p.add_argument("--comparison-datasets", nargs="+", default=["pinwheel", "auto", "mnist"],
                   choices=["pinwheel", "auto", "mnist"])
    p.add_argument("--comparison-engine", choices=["step", "kernel"], default="step")
    p.add_argument("--out", default="reproduce_summary_torch.json")
    p.add_argument("--auto-tt-out", default="runs/auto_tt_torch.json")
    p.add_argument("--comparison-out", default="runs/comparison_torch.json")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")
    from svax_torch.utils.runs import port_artifact, write_json

    on = lambda s: "all" in args.stages or s in args.stages  # noqa: E731
    for path in (args.out, args.auto_tt_out, args.comparison_out):
        port_artifact(path)  # before any training
    steps = steps or {}
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        from svax_torch.ops import _build

        _build.load()  # build outside the timed stages
    results: dict = {"devices": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                 else "cpu")}
    seconds: dict = {}

    def stage(name: str, fn) -> None:
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0
        print(f"[reproduce] stage {name} in {seconds[name]:.1f} s", flush=True)

    if on("gmm"):
        stage("gmm", lambda: results.__setitem__(
            "pinwheel-gmm", run_gmm(args.quick, device, steps.get("gmm"))))
    if on("svae"):
        def svae():
            for name, dataset, kw in SVAE_ROWS:
                results[name] = run_svae(dataset, args.quick, device, steps=steps.get(name),
                                         **kw)
                print(name, json.dumps(results[name]), flush=True)
        stage("svae", svae)
    if on("comparison"):
        def comparison():
            from svax_torch import compare

            argv_c = ["--seeds", str(args.comparison_seeds), "--datasets",
                      *args.comparison_datasets, "--engine", args.comparison_engine,
                      "--device", args.device, "--out", args.comparison_out]
            out = compare.main(argv_c + (["--quick"] if args.quick else []))
            results["comparison"] = {ds: r["row"] for ds, r in out.items()}
        stage("comparison", comparison)
    if on("auto-tt"):
        stage("auto-tt", lambda: results.__setitem__(
            "auto-time-to-target", run_auto_time_to_target(args.quick, device,
                                                           args.auto_tt_out,
                                                           steps.get("auto-tt"))))
    if on("serve"):
        stage("serve", lambda: results.__setitem__(
            "serving", run_serve(args.quick, device, steps.get("serve"))))
    for name, row in results.items():
        if isinstance(row, dict):
            print(name, json.dumps(row), flush=True)
    print(f"wrote {write_json(Path(args.out), results)}")
    return {"results": results, "seconds": seconds}


if __name__ == "__main__":
    main()
