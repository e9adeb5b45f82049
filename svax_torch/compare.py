"""The paper's three-model comparison with the port
(``experiments/reproduce.py --stages comparison``, ``run_comparison``).

    python -m svax_torch.compare [--datasets pinwheel auto mnist] [--seeds N]
        [--engine step|kernel] [--quick] [--device cuda|cpu]
        [--out runs/comparison_torch.json]

For each dataset it trains the structured SVAE, the plain VAE
(``models.vae``) and a conjugate mixture under the reference's budgets
(``SPECS``; ``--quick`` cuts them as the reference's ``--quick`` does), and
scores them on the held-out split: the SVAE and the VAE by their IW bounds
at the spec's sample count, the mixture by its exact posterior predictive
(the data-space GMM for pinwheel and auto, the Bernoulli mixture for
mnist). SVAE and VAE share seed bases (``37·seed``, ``+ 1000·restart``),
the best of the restarts is the one with the highest last training ELBO,
and with several seeds the row carries the paired per-seed SVAE − VAE
delta (``paired_delta``).

``--engine kernel`` runs the SVAE leg on the whole-train-step kernel that
``train.loop.choose_kernel`` picks (pinwheel: tinystep, auto: flexstep), at
the comparison's own ``SvaeConfig`` (nn_precision "high": the kernels' f32
mode); a leg outside both kernels (mnist's, whose warmup runs outside them)
runs the per-step engine, says why, and the budget records it.
``--engine step`` (the default, the reference's "xla") runs every SVAE leg
on the per-step engine with the plain combine. The VAE and the mixtures
always run their per-step steps. On CPU tensors a kernel runs its plain
version.

Each dataset's row has the reference row's keys; its ``budget`` adds
``svae_kernel`` and ``svae_kernel_mode`` (and ``svae_engine_reason`` when a
kernel request fell back). The rows merge into ``--out``; the reference's
own artifact ``runs/comparison.json`` is never written. Each leg's wall
seconds and engine are printed and returned, not written into the row.
``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time
from pathlib import Path

import torch

# The reference's table (experiments/reproduce.py:166-186).
SPECS = {
    "pinwheel": dict(steps=15000, batch=0, d=2, s=4, hidden=(50, 50),
                     rho=0.05, rho_decay=0.0, aug=0.4, restarts=5,
                     iw=1000, eval_every=0, gmm_steps=300),
    "auto": dict(steps=3000, batch=64, d=4, s=4, hidden=(100, 100),
                 rho=0.2, rho_decay=0.001, aug=0.0, restarts=1,
                 iw=1000, eval_every=250, gmm_steps=300),
    "mnist": dict(steps=5000, batch=256, d=8, s=1, hidden=(200, 200),
                  rho=0.1, rho_decay=0.001, aug=0.0, restarts=1,
                  iw=100, eval_every=500, gmm_steps=0, warmup=1000,
                  bmm_steps=300),
}
K, LR = 10, 1e-3
BUDGET_KEYS = ("steps", "batch", "d", "s", "hidden", "iw", "rho", "rho_decay", "aug",
               "restarts", "eval_every", "gmm_steps")
DEFAULT_OUT = "runs/comparison_torch.json"
WARMUP_REASON = "warmup phase runs outside the kernels"
# The K = 10 data rows the reference's mixture legs start from: what
# jax.random.choice draws under PRNGKey(0) in gmm.init_variational (its
# second split) and bmm.init_variational (the key itself), without
# replacement. A leg given them (``rows=``) lands the reference's fixed
# point; the port's own generator lands others.
REFERENCE_INIT_ROWS = {
    "pinwheel": [322, 250, 216, 223, 98, 105, 364, 103, 254, 140],
    "auto": [322, 250, 216, 223, 98, 105, 103, 254, 140, 277],
    "mnist": [4125, 2365, 809, 5763, 4352, 3753, 3314, 5457, 5355, 1138],
}
BMM_NOTE = ("conjugate Bernoulli mixture (data-space Gaussian GMM density is not "
            "commensurable with Bernoulli log-mass; this exact log-mass predictive is)")


def quick_spec(sp: dict) -> dict:
    """The reference's ``--quick`` cut (reproduce.py:192-197)."""
    return dict(sp, steps=200, eval_every=100, iw=20, restarts=1,
                gmm_steps=min(sp["gmm_steps"], 60),
                bmm_steps=min(sp.get("bmm_steps", 0), 60),
                warmup=min(sp.get("warmup", 0), 100))


def _fold(seed: int, tag: int) -> int:
    from svax_torch.parallel import mesh

    return mesh.fold_seed(seed, tag)


def paired_delta(svae_bests: list[float], vae_bests: list[float]) -> dict:
    """Paired per-seed SVAE − VAE deltas of the best IW bounds: mean, sd,
    its standard error, the wins and mean/sem (None when sem is 0)."""
    deltas = [s - v for s, v in zip(svae_bests, vae_bests)]
    mean_d = statistics.mean(deltas)
    sd_d = statistics.stdev(deltas)
    sem = sd_d / math.sqrt(len(deltas))
    return {
        "mean": round(mean_d, 4),
        "sd": round(sd_d, 4),
        "sem": round(sem, 4),
        "wins": f"{sum(d > 0 for d in deltas)}/{len(deltas)}",
        "mean_over_sem": round(mean_d / sem, 2) if sem > 0 else None,
    }


def summarize_seeds(per: dict) -> dict:
    """{"svae", "vae"[, "paired_delta"]} from each kind's per-seed rows, as
    the reference's ``run_seeds`` (one seed: that seed's row)."""
    n_seeds = len(per["svae"])
    out = {}
    for kind in ("svae", "vae"):
        if n_seeds == 1:
            out[kind] = per[kind][0]
            continue
        bests = [r["iw_best"] for r in per[kind]]
        out[kind] = {"iw_best": round(statistics.mean(bests), 3),
                     "iw_best_sd": round(statistics.stdev(bests), 3),
                     "per_seed": per[kind]}
    if n_seeds > 1:
        out["paired_delta"] = paired_delta([r["iw_best"] for r in per["svae"]],
                                           [r["iw_best"] for r in per["vae"]])
    return out


def build_row(sp: dict, res: dict, route: dict, synthetic: bool, mixture: dict) -> dict:
    """A dataset's row with the reference's keys: the two models, the
    budget (with each leg's engine), seeds, the data's provenance, the
    paired delta, the mixture and the three verdicts. ``mixture`` is
    ``gmm_leg``'s or ``bmm_leg``'s row, or {} where neither ran."""
    n_seeds = len(res["svae"].get("per_seed", [None]))
    row = {
        "svae": res["svae"],
        "vae": res["vae"],
        "budget": {**{k: sp[k] for k in BUDGET_KEYS}, "warmup": sp.get("warmup", 0),
                   "lr": LR, "k": K, "svae_engine": route["engine"], "vae_engine": "step",
                   "svae_kernel": route["kernel"], "svae_kernel_mode": route["mode"],
                   **({"svae_engine_reason": route["reason"]} if route["reason"] else {})},
        "seeds": n_seeds,
        "synthetic_data": bool(synthetic),
    }
    if "paired_delta" in res:
        row["paired_delta"] = res["paired_delta"]
    best = row["svae"]["iw_best"]
    if "exact_predictive" in mixture:
        row["gmm"] = mixture
        row["svae_beats_gmm"] = bool(best > mixture["exact_predictive"])
    elif "bernoulli_mixture_exact_predictive" in mixture:
        row["gmm"] = mixture
        row["svae_beats_gmm"] = bool(best > mixture["bernoulli_mixture_exact_predictive"])
    else:
        row["gmm"] = {"not_comparable": "Gaussian-mixture density on binarized pixels is "
                                        "not commensurable with Bernoulli log-mass"}
        row["svae_beats_gmm"] = None
    row["svae_beats_vae"] = bool(best > row["vae"]["iw_best"])
    if "paired_delta" in row:
        pd = row["paired_delta"]
        row["svae_beats_vae_significant"] = bool(
            pd["mean_over_sem"] is not None and pd["mean_over_sem"] > 2.0)
    return row


def _rows(rows, x: torch.Tensor) -> torch.Tensor | None:
    return None if rows is None else torch.as_tensor(rows, device=x.device)


def gmm_leg(x: torch.Tensor, xt: torch.Tensor, steps: int, *, seed: int = 0, state=None,
            rows=None):
    """The data-space GMM leg: the prior at d = x.shape[1] (not the latent
    d), the naturals from ``gmm_baseline.init_state`` (its K data rows drawn
    by a generator seeded ``seed``, or ``rows``) unless ``state`` is given,
    ``steps`` full-batch steps at ρ = 1, scored by the exact predictive.
    Returns (row, state)."""
    from svax_torch.models import evaluation, gmm_baseline
    from svax_torch.pgm import gmm

    prior = gmm.make_prior(K, int(x.shape[1]), alpha=1.0, kappa=0.05, device=x.device,
                           dtype=x.dtype)
    if state is None:
        state = gmm_baseline.init_state(torch.Generator(device=x.device).manual_seed(seed),
                                        prior, x, rows=_rows(rows, x))
    step = gmm_baseline.make_train_step(prior, 1.0, x.shape[0])
    with torch.no_grad():
        for _ in range(steps):
            state, _m = step(state, x)
        pred = evaluation.gmm_predictive_log_prob(state.nat, xt)
    return {"exact_predictive": round(float(pred.mean()), 3)}, state


def bmm_leg(x: torch.Tensor, xt: torch.Tensor, steps: int, *, seed: int = 0, state=None,
            rows=None):
    """The Bernoulli-mixture leg (mnist's third model): ``steps`` full-batch
    steps at ρ = 1 from ``bmm_baseline.init_state`` (generator seeded
    ``seed``, or the K data ``rows``) or ``state``, scored by the exact
    predictive log-mass. Returns (row, state)."""
    from svax_torch.models import bmm_baseline
    from svax_torch.pgm import bmm

    prior = bmm.make_prior(K, int(x.shape[1]), device=x.device, dtype=x.dtype)
    if state is None:
        state = bmm_baseline.init_state(torch.Generator(device=x.device).manual_seed(seed),
                                        prior, x, rows=_rows(rows, x))
    step = bmm_baseline.make_train_step(prior, 1.0, x.shape[0])
    with torch.no_grad():
        for _ in range(steps):
            state, _m = step(state, x)
        pred = bmm.predictive_log_prob(state.nat, xt)
    return {"bernoulli_mixture_exact_predictive": round(float(pred.mean()), 3),
            "note": BMM_NOTE}, state


def route_svae(config, sp: dict, engine: str, input_dim: int) -> dict:
    """The SVAE leg's engine: {"engine": "kernel" | "step", "kernel":
    "tinystep" | "flexstep" | None, "mode": "f32" | "bf16-products" | None,
    "reason": why a kernel request fell back, or None}."""
    from svax_torch.train import loop

    route = {"engine": "step", "kernel": None, "mode": None, "reason": None}
    if engine != "kernel":
        return route
    if sp.get("warmup", 0):
        route["reason"] = WARMUP_REASON
        return route
    gate = dict(batch_full=sp["batch"] == 0, encoder_hidden=tuple(sp["hidden"]),
                decoder_hidden=tuple(sp["hidden"]), rho=sp["rho"],
                rho_decay=sp["rho_decay"], likelihood=config.likelihood,
                input_dim=input_dim)
    kernel = loop.choose_kernel(config, engine="auto", **gate)
    if kernel == loop.PER_STEP:
        route["reason"] = loop.kernel_unsupported_reason(config, engine="megakernel", **gate)
        return route
    mode = "bf16-products" if config.nn_precision == "default" else "f32"
    return {"engine": "kernel", "kernel": kernel, "mode": mode, "reason": None}


class _Dataset:
    """One dataset's data, configs and scorers, as ``run_comparison``'s
    loop body builds them."""

    def __init__(self, ds: str, sp: dict, device: torch.device):
        from svax_torch.data import load_dataset
        from svax_torch.models import vae
        from svax_torch.models.svae import SvaeConfig
        from svax_torch.pgm import gmm

        train, test, meta = load_dataset(ds, seed=0)
        self.name, self.sp, self.meta = ds, sp, meta
        self.x = torch.tensor(train, dtype=torch.float32, device=device)
        self.xt = torch.tensor(test, dtype=torch.float32, device=device)
        self.n = self.x.shape[0]
        self.chunk = sp["eval_every"] or sp["steps"]
        self.n_chunks = sp["steps"] // self.chunk
        self.config = SvaeConfig(latent_dim=sp["d"], num_components=K, num_samples=sp["s"],
                                 likelihood=meta["likelihood"], num_total=self.n)
        self.vconfig = vae.VaeConfig(latent_dim=sp["d"], num_samples=sp["s"],
                                     likelihood=meta["likelihood"])
        self.prior = gmm.make_prior(K, sp["d"], alpha=1.0, kappa=0.05, device=device)

    def score(self, kind: str, st, seed: int) -> float:
        from svax_torch.models import evaluation

        gen = torch.Generator(device=self.xt.device).manual_seed(seed)
        if kind == "svae":
            iw = evaluation.svae_iw_loglik(st.nn_params, st.pgm_nat, self.xt, self.sp["iw"],
                                           generator=gen, likelihood=self.config.likelihood)
        else:
            iw = evaluation.vae_iw_loglik(st.params, self.xt, self.vconfig, self.sp["iw"],
                                          generator=gen)
        return float(iw.mean())

    def _restart(self, kind: str, base: int, route: dict):
        """One restart from seed ``base``: (last training ELBO, state, IW
        trajectory)."""
        from svax_torch.models import vae
        from svax_torch.train import loop, svae_step

        sp, x = self.sp, self.x
        gen = torch.Generator(device=x.device).manual_seed(base)
        hidden = tuple(sp["hidden"])
        if kind == "svae":
            st = svae_step.init_state(gen, x.shape[1], self.config, self.prior, hidden,
                                      hidden, data=x)
            if sp.get("warmup", 0):
                from svax_torch.train.warmup import vae_warmup_reseed

                st, _info = vae_warmup_reseed(st, x, self.config, self.prior, lr=LR,
                                              steps=sp["warmup"], batch_size=sp["batch"],
                                              scan_chunk=self.chunk, seed=_fold(base, 17))
            kw = dict(lr=LR, rho=sp["rho"], rho_decay=sp["rho_decay"],
                      batch_size=sp["batch"], aug_noise=sp["aug"])
            if route["engine"] == "kernel":
                run = loop.make_runner(self.config, self.prior, engine="kernel",
                                       kernel=route["kernel"], **kw)
            else:
                run = loop.make_step_runner(self.config, self.prior, engine="kernel", **kw)
            runner = lambda s, t: run(s, x, t, seed=base)  # noqa: E731
            elbo_key = "elbo"
        else:
            st = vae.init_state(gen, x.shape[1], self.vconfig, hidden, hidden,
                                device=x.device)
            step = loop.augment_step(vae.make_train_step(self.vconfig, LR), sp["aug"])
            run = loop.make_batch_runner(lambda s, xb, g: step(s, xb, generator=g),
                                         batch_size=sp["batch"], seed=base, noise=True)
            runner = lambda s, t: run(s, x, t)  # noqa: E731
            elbo_key = "elbo_per_point"
        traj = []
        for c in range(self.n_chunks):
            st, mets = runner(st, self.chunk)
            if sp["eval_every"]:
                traj.append(self.score(kind, st, _fold(base, 7000 + c)))
        return float(mets[elbo_key][-1]), st, traj

    def train_model(self, kind: str, seed_base: int, route: dict) -> tuple[dict, float]:
        """The shared SVAE/VAE harness: the best of the restarts by the last
        training ELBO, scored by the IW bound; returns (row, seconds)."""
        t0 = time.perf_counter()
        best = None
        for r in range(self.sp["restarts"]):
            got = self._restart(kind, seed_base + 1000 * r, route)
            if best is None or got[0] > best[0]:
                best = got
        _, st, traj = best
        row = {"iw_final": round(self.score(kind, st, seed_base + 999), 3)}
        if traj:
            best_c = int(max(range(len(traj)), key=traj.__getitem__))
            row["iw_best"] = round(traj[best_c], 3)
            row["iw_best_step"] = (best_c + 1) * self.chunk
        else:
            row["iw_best"] = row["iw_final"]
        if self.x.device.type == "cuda":
            torch.cuda.synchronize(self.x.device)
        return row, time.perf_counter() - t0


def run_dataset(ds: str, *, seeds: int = 1, engine: str = "step", quick: bool = False,
                device: str = "cuda", spec: dict | None = None,
                svae_cut: dict | None = None) -> dict:
    """One dataset's comparison; returns {"row", "legs", "route"}: the row,
    and each leg's {"leg", "seed", "engine", "seconds"}. ``spec`` replaces
    the dataset's spec (``SPECS``, or its ``quick_spec`` cut); ``svae_cut``
    overrides spec fields for the SVAE leg alone (a shorter smoke run; the
    row's budget still states the spec)."""
    device = torch.device(device)
    if spec is not None:
        sp = dict(spec)
    else:
        sp = quick_spec(SPECS[ds]) if quick else dict(SPECS[ds])
    data = _Dataset(ds, sp, device)
    svae_data = _Dataset(ds, dict(sp, **svae_cut), device) if svae_cut else data
    route = route_svae(data.config, sp, engine, int(data.x.shape[1]))
    if route["reason"]:
        print(f"[compare/{ds}] svae leg stays on the per-step engine: {route['reason']}",
              flush=True)
    svae_label = (f"kernel ({route['kernel']}, {route['mode']})"
                  if route["engine"] == "kernel" else "step")
    per, legs = {"svae": [], "vae": []}, []
    for sd in range(seeds):
        for kind, src, label in (("svae", svae_data, svae_label), ("vae", data, "step")):
            row, secs = src.train_model(kind, 37 * sd, route)
            per[kind].append(row)
            legs.append({"leg": kind, "seed": sd, "engine": label, "seconds": secs})
            print(f"[compare/{ds}] {kind} seed {sd}: iw_best {row['iw_best']} in "
                  f"{secs:.1f} s on {label}", flush=True)
    t0 = time.perf_counter()
    mixture = {}
    if sp["gmm_steps"]:
        mixture, _ = gmm_leg(data.x, data.xt, sp["gmm_steps"])
        legs.append({"leg": "gmm", "seed": 0, "engine": "step",
                     "seconds": time.perf_counter() - t0})
    elif sp.get("bmm_steps"):
        mixture, _ = bmm_leg(data.x, data.xt, sp["bmm_steps"])
        legs.append({"leg": "bmm", "seed": 0, "engine": "step",
                     "seconds": time.perf_counter() - t0})
    if mixture:
        print(f"[compare/{ds}] {legs[-1]['leg']}: {mixture} in {legs[-1]['seconds']:.1f} s "
              "on step", flush=True)
    row = build_row(sp, summarize_seeds(per), route, data.meta.get("synthetic", False),
                    mixture)
    print(f"[compare/{ds}] svae {row['svae'].get('iw_best')}  vae {row['vae'].get('iw_best')}"
          f"  gmm {row['gmm']}  paired {row.get('paired_delta')}", flush=True)
    return {"row": row, "legs": legs, "route": route}


def mixture_seeds(ds: str, seeds: int, device: str = "cuda") -> list[float]:
    """The dataset's mixture leg (its full spec's steps) at generator seeds
    0..seeds-1, printed one a line: the fixed points its initial rows land
    (``python -c "from svax_torch.compare import mixture_seeds;
    mixture_seeds('mnist', 16, 'cpu')"``)."""
    from svax_torch.data import load_dataset

    sp = SPECS[ds]
    train, test, _ = load_dataset(ds, seed=0)
    x = torch.tensor(train, dtype=torch.float32, device=device)
    xt = torch.tensor(test, dtype=torch.float32, device=device)
    out = []
    for seed in range(seeds):
        if sp["gmm_steps"]:
            got = gmm_leg(x, xt, sp["gmm_steps"], seed=seed)[0]["exact_predictive"]
        else:
            got = bmm_leg(x, xt, sp["bmm_steps"], seed=seed)[0][
                "bernoulli_mixture_exact_predictive"]
        print(f"[compare/{ds}] mixture leg, generator seed {seed}: {got}", flush=True)
        out.append(got)
    return out


def check_out(out: str) -> Path:
    """``out`` as a path; refuses the reference's artifacts in ``runs/``, its
    ``runs/comparison.json`` among them (``utils.runs.port_artifact``)."""
    from svax_torch.utils.runs import port_artifact

    return port_artifact(out)


def write_rows(rows: dict, out: str) -> Path:
    """Merge ``rows`` into the JSON file ``out`` (other datasets' rows stay)."""
    path = check_out(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    merged = json.loads(path.read_text()) if path.exists() else {}
    merged.update(rows)
    path.write_text(json.dumps(merged, indent=1))
    return path


def main(argv: list[str] | None = None) -> dict:
    """Run the comparison; returns {dataset: run_dataset's dict}."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--datasets", nargs="+", choices=list(SPECS), default=list(SPECS))
    p.add_argument("--seeds", type=int, default=1, help="seeds per model (paired)")
    p.add_argument("--engine", choices=["step", "kernel"], default="step",
                   help="the SVAE leg's engine: step = the per-step engine, kernel = "
                        "the whole-step kernel where the workload fits one")
    p.add_argument("--quick", action="store_true", help="the reference's --quick cut")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT, help="merge the rows into this JSON file")
    args = p.parse_args(argv)
    if args.seeds < 1:
        p.error("--seeds must be >= 1")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_out(args.out)  # before any training
    results = {}
    for ds in [d for d in SPECS if d in args.datasets]:
        results[ds] = run_dataset(ds, seeds=args.seeds, engine=args.engine,
                                  quick=args.quick, device=args.device)
    path = write_rows({ds: r["row"] for ds, r in results.items()}, args.out)
    print(f"wrote {path}", flush=True)
    return results


if __name__ == "__main__":
    main()
