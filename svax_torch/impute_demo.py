"""The quality of the serving ``impute`` endpoint
(``experiments/impute_demo.py``).

    python -m svax_torch.impute_demo [--quick] [--impute-iters 10]
        [--json runs/impute_quality_torch.json] [--device cuda|cpu]

``serve.SvaeServer.impute`` (iterated encode → posterior decode) against
the two baselines a user would compare it with:

* **mean-fill**: the missing features filled with the train-set feature
  means;
* **VAE impute**: the same fixed-point iteration through a plain VAE
  trained at the matched budget (same nets, steps, batch, lr;
  ``vae_fill``).

Protocols (``SPECS``, the reference's table):

* **pinwheel** (Gaussian, d = 2; 15,000 full-batch steps, 50-50, S = 4,
  σ = 0.4): hide one coordinate per test point, both patterns. Metrics:
  the RMSE over hidden coordinates, and the held-out Gaussian NLL of the
  true hidden value under each model's decoder at the imputation fixed
  point (``hidden_coord_nll``; mean-fill's under the train marginal).
* **mnist surrogate** (Bernoulli, 784-d; minibatches of 256, d = 8, S = 1,
  200-200, 1,000 VAE warmup steps and the k-means++ reseed, then 5,000
  steps): a random 50% pixel mask per test point (numpy seed 0). Metrics:
  the masked-pixel Bernoulli NLL of the decoder's probabilities at the
  fixed point and the masked-pixel 0/1 error at 0.5 (mean-fill: the train
  pixel means). Surrogate data, flagged in the row.

The SVAE fills four ways: the live server's mean and MAP decode rules, and
the same two through the exported tier (``serve.export_serving`` of the
``impute`` endpoint at the bucket the requests fill, then
``serve.load_exported``), which must agree with the live tier to float
tolerance. ``--quick`` cuts both legs to 500 steps
and the warmup to 100. Each leg is ``run_leg(dataset, steps=, warmup=)``.

The SVAE trains through ``train.loop.train_chosen``: pinwheel on
tinystep's f32 mode with in-kernel augmentation, mnist on the per-step
engine with the plain combine (the reference's spec turns no fused
switch on). The VAE trains on ``loop.make_batch_runner``. Prints each
leg's row (the reference artifact's keys; ``budget.svae_engine`` names the
port's engine) and writes them to ``--json`` (never a reference artifact
in ``runs/``). On CPU tensors every kernel runs its plain version;
``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import tempfile
import time

import numpy as np
import torch

SPECS = {
    "pinwheel": dict(steps=15000, batch=0, d=2, s=4, hidden=(50, 50), rho=0.05, aug=0.4,
                     warmup=0),
    "mnist": dict(steps=5000, batch=256, d=8, s=1, hidden=(200, 200), rho=0.1, aug=0.0,
                  warmup=1000),
}
K, LR, CHUNK = 10, 1e-3, 1000
DEFAULT_JSON = "runs/impute_quality_torch.json"


def quick_spec(sp: dict) -> dict:
    """The reference's ``--quick`` cut."""
    return dict(sp, steps=500, warmup=min(sp["warmup"], 100))


def masks(ds: str, xt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(x_true, mask): pinwheel hides each coordinate in turn (2·N problems),
    mnist a random half of the pixels (``np.random.default_rng(0)``); the
    mask is 1 where observed."""
    if ds == "pinwheel":
        x_true = np.concatenate([xt, xt])
        mask = np.ones_like(x_true)
        mask[: len(xt), 0] = 0.0
        mask[len(xt):, 1] = 0.0
        return x_true, mask
    rng = np.random.default_rng(0)
    return xt, (rng.uniform(size=xt.shape) > 0.5).astype(np.float32)


def _like(params: dict) -> dict:
    """The device and dtype of the nets' parameters."""
    w = params["encoder"][0]["w"]
    return {"device": w.device, "dtype": w.dtype}


@torch.no_grad()
def vae_fill(params: dict, x_true: np.ndarray, mask: np.ndarray, iters: int,
             likelihood: str, activation: str = "tanh") -> np.ndarray:
    """The VAE's fixed-point fill: ``iters`` rounds of encode → decode at the
    posterior mean (z = h/P), written into the missing coordinates only,
    from zeros there; on the parameters' device, in their dtype."""
    from svax_torch.nets import mlp as nets

    hidden = mask == 0.0
    xv = torch.tensor(np.where(hidden, 0.0, x_true), **_like(params))
    m = torch.tensor(mask, **_like(params))
    cur = xv
    for _ in range(iters):
        pot_h, pot_p = nets.encoder_apply(params["encoder"], cur, activation)
        out = nets.decoder_apply(params["decoder"], pot_h / pot_p, likelihood, activation)
        recon = out[0] if likelihood == "gaussian" else torch.sigmoid(out)
        cur = m * xv + (1.0 - m) * recon
    return cur.cpu().numpy()


@torch.no_grad()
def hidden_coord_nll(fill: np.ndarray, params: dict, activation: str, x_true: np.ndarray,
                     hidden: np.ndarray, pgm_nat=None) -> float:
    """The mean Gaussian NLL of the true hidden coordinates under the
    decoder at the fill: z is the SIN posterior's responsibility-weighted
    mean under ``pgm_nat`` (the SVAE), else the encoder's mean h/P (the
    VAE); on the parameters' device, in their dtype."""
    from svax_torch.models import svae
    from svax_torch.nets import mlp as nets
    from svax_torch.pgm import gmm

    like = _like(params)
    pot_h, pot_p = nets.encoder_apply(params["encoder"], torch.tensor(fill, **like),
                                      activation)
    if pgm_nat is not None:
        post = svae.sin_combine(pot_h, pot_p, gmm.expected_params(pgm_nat))
        z = torch.einsum("nk,nkd->nd", torch.exp(post.log_resp), post.mean)
    else:
        z = pot_h / pot_p
    mean, var = nets.decoder_apply(params["decoder"], z, "gaussian", activation)
    xt = torch.tensor(x_true, **like)
    nll = 0.5 * ((xt - mean) ** 2 / var + torch.log(var) + math.log(2 * math.pi))
    return float(nll[torch.tensor(hidden, device=like["device"])].mean())


def _train_svae(sp, x, n, d_in, meta, device):
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.parallel.mesh import fold_seed
    from svax_torch.pgm import gmm
    from svax_torch.train import loop, svae_step
    from svax_torch.train.warmup import vae_warmup_reseed

    config = SvaeConfig(latent_dim=sp["d"], num_components=K, num_samples=sp["s"],
                        likelihood=meta["likelihood"], num_total=n)
    prior = gmm.make_prior(K, sp["d"], alpha=1.0, kappa=0.05, device=device)
    st = svae_step.init_state(torch.Generator(device=device).manual_seed(0), d_in, config,
                              prior, sp["hidden"], sp["hidden"], data=x)
    if sp["warmup"]:
        st, _ = vae_warmup_reseed(st, x, config, prior, lr=LR, steps=sp["warmup"],
                                  batch_size=sp["batch"], scan_chunk=500,
                                  seed=fold_seed(0, 17))
    st, _, kernel = loop.train_chosen(st, config, prior, x, sp["steps"], lr=LR,
                                      rho=sp["rho"], hidden=sp["hidden"],
                                      batch_size=sp["batch"], aug_noise=sp["aug"], seed=0,
                                      chunk=CHUNK)
    return st, config, kernel


def _train_vae(sp, x, d_in, meta, device):
    from svax_torch.models import vae
    from svax_torch.parallel.mesh import fold_seed
    from svax_torch.train import loop

    vconfig = vae.VaeConfig(latent_dim=sp["d"], num_samples=sp["s"],
                            likelihood=meta["likelihood"])
    vst = vae.init_state(torch.Generator(device=device).manual_seed(0), d_in, vconfig,
                         sp["hidden"], sp["hidden"], device=device)
    step = loop.augment_step(vae.make_train_step(vconfig, LR), sp["aug"])
    run = loop.make_batch_runner(lambda s, xb, g: step(s, xb, generator=g),
                                 batch_size=sp["batch"], seed=fold_seed(0, 1), noise=True)
    done = 0
    while done < sp["steps"]:
        todo = min(CHUNK, sp["steps"] - done)
        vst, _ = run(vst, x, todo)
        done += todo
    return vst, vconfig


def run_leg(ds: str, *, steps: int | None = None, warmup: int | None = None,
            quick: bool = False, impute_iters: int = 10, device="cuda") -> dict:
    """One dataset's leg: trains the SVAE and the VAE at ``SPECS[ds]`` (cut
    by ``quick``; ``steps`` and ``warmup`` override it), fills, scores.
    Returns {"row", "kernel": the SVAE's engine, "seconds": the wall
    seconds of each part (train_svae, train_vae, live, exported, rest)}."""
    from svax_torch import serve
    from svax_torch.data import load_dataset

    device = torch.device(device)
    sp = quick_spec(SPECS[ds]) if quick else dict(SPECS[ds])
    if steps is not None:
        sp["steps"] = steps
    if warmup is not None:
        sp["warmup"] = warmup
    seconds, t0 = {}, time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    train, test, meta = load_dataset(ds, seed=0)
    x = torch.tensor(train, dtype=torch.float32, device=device)
    n, d_in = x.shape
    st, config, kernel = _train_svae(sp, x, n, d_in, meta, device)
    lap("train_svae")
    vst, vconfig = _train_vae(sp, x, d_in, meta, device)
    lap("train_vae")

    x_true, mask = masks(ds, np.asarray(test, np.float32))
    hidden = mask == 0.0
    x_masked = np.where(hidden, np.nan, x_true).astype(np.float32)

    # The SVAE's four fills: live and exported, mean and MAP decode rules.
    buckets = (1024, 4096) if ds == "pinwheel" else (1024,)
    server = serve.SvaeServer(
        st.nn_params, st.pgm_nat,
        serve.ModelSpec(input_dim=d_in, latent_dim=sp["d"], num_components=K,
                        likelihood=meta["likelihood"], encoder_hidden=sp["hidden"],
                        decoder_hidden=sp["hidden"], num_samples=sp["s"], num_total=n),
        buckets=buckets)
    fill_live = server.impute(x_masked, mask, num_iters=impute_iters)
    fill_map = server.impute(x_masked, mask, num_iters=impute_iters, mode="map")
    lap("live")
    # The exported tier traces the one bucket these requests fill.
    used = min((b for b in buckets if b >= len(x_true)), default=buckets[-1])
    aot = {}
    for mode in ("mean", "map"):
        with tempfile.TemporaryDirectory() as tmp:
            serve.export_serving(server, tmp, buckets=(used,), score_samples=5,
                                 impute_iters=impute_iters, impute_mode=mode,
                                 endpoints=("impute",))
            aot[mode] = serve.load_exported(tmp).impute(x_masked, mask)
    fill_aot, fill_aot_map = aot["mean"], aot["map"]
    lap("exported")
    fill_vae = vae_fill(vst.params, x_true, mask, impute_iters, vconfig.likelihood,
                        vconfig.activation)
    x_f32 = np.asarray(train, np.float32)
    feat_mean = x_f32.mean(0)
    fill_mean = np.where(hidden, feat_mean[None, :], x_true)

    def rmse(fill):
        return float(np.sqrt(np.mean((fill[hidden] - x_true[hidden]) ** 2)))

    row = {
        "protocol": ("hide-one-coordinate (both patterns)" if ds == "pinwheel"
                     else "random 50% pixel mask"),
        "n_problems": int(x_true.shape[0]),
        "hidden_frac": round(float(hidden.mean()), 3),
        "impute_iters": impute_iters,
        "budget": {"steps": sp["steps"], "batch": sp["batch"], "hidden": list(sp["hidden"]),
                   "lr": LR, "k": K, "d": sp["d"], "rho": sp["rho"], "aug": sp["aug"],
                   "warmup": sp["warmup"], "svae_engine": kernel},
        "train_wall_s": {"svae": round(seconds["train_svae"], 1),
                         "vae": round(seconds["train_vae"], 1)},
        "synthetic_data": bool(meta.get("synthetic", False)),
    }
    if ds == "pinwheel":
        mu, sd2 = feat_mean, x_f32.var(0)
        nll_mean = float(np.mean(
            (0.5 * ((x_true - mu[None]) ** 2 / sd2[None] + np.log(sd2[None])
                    + np.log(2 * np.pi)))[hidden]))
        act = config.activation
        row["rmse"] = {
            "svae_live": round(rmse(fill_live), 4),
            "svae_map": round(rmse(fill_map), 4),
            "svae_aot": round(rmse(fill_aot), 4),
            "svae_aot_map": round(rmse(fill_aot_map), 4),
            "vae": round(rmse(fill_vae), 4),
            "mean_fill": round(rmse(fill_mean), 4),
        }
        row["hidden_coord_nll"] = {
            "svae": round(hidden_coord_nll(fill_live, st.nn_params, act, x_true, hidden,
                                           st.pgm_nat), 4),
            "svae_map": round(hidden_coord_nll(fill_map, st.nn_params, act, x_true, hidden,
                                               st.pgm_nat), 4),
            "vae": round(hidden_coord_nll(fill_vae, vst.params, vconfig.activation, x_true,
                                          hidden), 4),
            "mean_fill_marginal": round(nll_mean, 4),
        }
    else:
        # The decoder's probabilities at the fixed point are the predictive
        # of the hidden pixels: the fills hold them.
        def bern_nll(p):
            p = np.clip(p, 1e-6, 1 - 1e-6)
            ll = x_true * np.log(p) + (1 - x_true) * np.log1p(-p)
            return float(-ll[hidden].mean())

        def bit_err(p):
            return float(np.mean((p[hidden] > 0.5) != (x_true[hidden] > 0.5)))

        p_mean = np.broadcast_to(np.clip(feat_mean, 1e-6, 1 - 1e-6), x_true.shape)
        fills = {"svae_live": fill_live, "svae_map": fill_map, "svae_aot": fill_aot,
                 "vae": fill_vae, "mean_fill": p_mean}
        row["masked_pixel_nll"] = {k: round(bern_nll(v), 4) for k, v in fills.items()}
        row["masked_pixel_err"] = {k: round(bit_err(v), 4) for k, v in fills.items()}
    # The exported tier must reproduce the live one (both decode rules).
    row["aot_max_abs_diff"] = round(float(np.max(np.abs(fill_live - fill_aot))), 6)
    row["aot_map_max_abs_diff"] = round(float(np.max(np.abs(fill_map - fill_aot_map))), 6)
    lap("rest")
    return {"row": row, "kernel": kernel, "seconds": seconds}


def main(argv: list[str] | None = None) -> dict:
    """Run both legs; returns the rows plus "kernels" (each leg's SVAE
    engine)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--impute-iters", type=int, default=10)
    ap.add_argument("--json", default=DEFAULT_JSON)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (use --device cpu)")
    from svax_torch.utils.runs import port_artifact, write_json

    port_artifact(args.json)  # refuse a reference artifact before any work
    torch.backends.cuda.matmul.allow_tf32 = False
    out, kernels = {}, {}
    for ds in SPECS:
        leg = run_leg(ds, quick=args.quick, impute_iters=args.impute_iters,
                      device=args.device)
        out[ds], kernels[ds] = leg["row"], leg["kernel"]
        print(f"[impute/{ds}] {json.dumps(out[ds])}", flush=True)
        print(f"[impute/{ds}] seconds: " + ", ".join(
            f"{k} {v:.2f}" for k, v in leg["seconds"].items()), flush=True)
    path = write_json(args.json, out)
    print(f"wrote {path}")
    return {**out, "kernels": kernels}


if __name__ == "__main__":
    main()
