"""Anomaly detection with a served SVAE: train clean, score contaminated
(``experiments/anomaly_demo.py``).

    python -m svax_torch.anomaly_demo [--steps 3000] [--outlier-fraction 0.15]
        [--outlier-scale 15] [--dof 4] [-K 10] [--iw-samples 100] [--seed 0]
        [--scan-chunk 500] [--json PATH] [--device cuda|cpu]

The model trains on a clean pinwheel (400 points), and the serving layer's
per-point importance-weighted log-likelihood (``serve.SvaeServer.score``)
scores a held-out set with injected uniform-box outliers
(``data.pinwheel.make_pinwheel_with_outliers``, 300 clean points). Prints
the ROC-AUC of "low score ⇒ anomaly" and the mean scores of the clean and
the outlier points, for the GMM-prior SVAE and (``--dof`` > 0) the
Student-t-prior one. The pinwheel spans about ±17, so the default box
(±15) overlaps its support and caps the AUC well below 1; ``--outlier-scale
30`` is the separated regime.

Each model trains through ``train.loop.train_chosen`` (``choose_kernel``'s
rule): at these shapes tinystep's f32 mode, its SMM branch for the
Student-t prior, in chunks of ``--scan-chunk`` steps. ``--json PATH`` also
writes the summary, with the flags, the engines and each model's wall
seconds (training and scoring), to PATH (never a reference artifact in
``runs/``). On CPU tensors the kernel runs its plain version; ``--device
cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

LR, RHO, HIDDEN = 1e-3, 0.05, (50, 50)


def _auc(scores_pos: np.ndarray, scores_neg: np.ndarray) -> float:
    """ROC-AUC of 'low score ⇒ anomaly' via the rank statistic (exact)."""
    all_scores = np.concatenate([scores_pos, scores_neg])
    ranks = all_scores.argsort().argsort().astype(np.float64)
    n_pos, n_neg = len(scores_pos), len(scores_neg)
    # P(clean point scores higher than outlier) with tie-free ranks.
    r_pos = ranks[:n_pos].sum()
    return float((r_pos - n_pos * (n_pos - 1) / 2.0) / (n_pos * n_neg))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--outlier-fraction", type=float, default=0.15)
    p.add_argument("--outlier-scale", type=float, default=15.0,
                   help="half-width of the uniform outlier box; the pinwheel spans "
                        "~±17, so the default box overlaps its support (the AUC is "
                        "capped well below 1); 30+ separates the outliers")
    p.add_argument("--dof", type=float, default=4.0,
                   help="also evaluate an SMM-prior model (0 = GMM only)")
    p.add_argument("--num-components", "-K", type=int, default=10)
    p.add_argument("--iw-samples", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scan-chunk", type=int, default=500)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--json", default="",
                   help="also write the printed summary here (not a reference artifact "
                        "in runs/)")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Run the demo; returns the printed dict plus "kernels" (the engine
    each model trained on)."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (use --device cpu)")
    from svax_torch.utils.runs import port_artifact, write_json

    if args.json:
        port_artifact(args.json)  # refuse a reference artifact before any work
    from svax_torch import serve
    from svax_torch.data.pinwheel import make_pinwheel_data, make_pinwheel_with_outliers
    from svax_torch.train import loop, svae_step

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    x_train = torch.tensor(make_pinwheel_data(num_per_class=80, seed=args.seed),
                           dtype=torch.float32, device=device)
    # The held-out set WITH outliers; labels < 0 mark the contamination.
    test_np, test_labels = make_pinwheel_with_outliers(
        outlier_fraction=args.outlier_fraction, num_per_class=60,
        outlier_scale=args.outlier_scale, seed=args.seed + 13)
    is_out = np.asarray(test_labels) < 0
    n = x_train.shape[0]

    results = {"outlier_fraction": args.outlier_fraction,
               "outlier_scale": args.outlier_scale,
               "n_test": int(len(test_np)), "n_outliers": int(is_out.sum())}
    kernels, seconds = {}, {}
    variants = [("gmm", 0.0)] + ([("smm", args.dof)] if args.dof > 0 else [])
    for name, dof in variants:
        t0 = time.perf_counter()
        spec = serve.ModelSpec(input_dim=2, latent_dim=2, num_components=args.num_components,
                               likelihood="gaussian", encoder_hidden=HIDDEN,
                               decoder_hidden=HIDDEN, num_samples=2, dof=dof, num_total=n)
        config = spec.to_config()
        prior = spec.make_prior(device)
        state = svae_step.init_state(torch.Generator(device=device).manual_seed(args.seed),
                                     2, config, prior, HIDDEN, HIDDEN, data=x_train)
        state, _, kernels[name] = loop.train_chosen(
            state, config, prior, x_train, args.steps, lr=LR, rho=RHO, hidden=HIDDEN,
            seed=args.seed, chunk=args.scan_chunk)
        server = serve.SvaeServer(state.nn_params, state.pgm_nat, spec, buckets=(1024,))
        scores = server.score(test_np, seed=args.seed + 1, num_samples=args.iw_samples)
        results[name] = {
            "roc_auc": round(_auc(scores[~is_out], scores[is_out]), 4),
            "mean_score_clean": round(float(scores[~is_out].mean()), 3),
            "mean_score_outlier": round(float(scores[is_out].mean()), 3),
        }
        seconds[name] = time.perf_counter() - t0  # the scores are on the host
    print(json.dumps(results, indent=2), flush=True)
    if args.json:
        write_json(args.json, {**results, "config": vars(args), "kernels": kernels,
                               "seconds": seconds})
    return {**results, "kernels": kernels, "seconds": seconds}


if __name__ == "__main__":
    main()
