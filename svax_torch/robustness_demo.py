"""Robustness demo: the GMM-prior against the SMM-prior SVAE on a
contaminated pinwheel (``experiments/robustness_demo.py``).

    python -m svax_torch.robustness_demo [--steps 3000] [--outlier-fraction 0.15]
        [--dof 4] [-K 10] [--seed 0] [--scan-chunk 500] [--activation tanh|relu]
        [--plot PATH] [--json PATH] [--device cuda|cpu]

Both variants train on a pinwheel (400 points) with a uniform-box outlier
contamination (``data.pinwheel.make_pinwheel_with_outliers``) and are
scored on a CLEAN held-out pinwheel (200 points). Prints, per variant, the
clean-test and the contaminated-train ELBO per point and the last training
ELBO, and for the SMM variant the mean E[u] (responsibility-weighted) on
the outlier rows and on the clean rows of the training set.

Each variant trains through ``train.loop.train_chosen`` (``choose_kernel``'s
rule): tanh nets on tinystep's f32 mode (its SMM branch for the Student-t
prior), relu nets on the per-step engine (neither whole-step kernel takes
relu). ``--json PATH`` also writes the summary, with the flags, the engines
and each variant's wall seconds, to PATH (never a reference artifact in
``runs/``). ``--plot PATH`` writes the two latent spaces side by side (it
needs matplotlib). On CPU tensors every kernel runs its plain version;
``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

LR, RHO, HIDDEN = 1e-3, 0.05, (50, 50)


def point_e_u(state, prior, x: torch.Tensor, config, eps=None, generator=None) -> np.ndarray:
    """Per-point E[u] = Σₖ r̃ₙₖ·E[uₙₖ] under the SMM-prior model's forward
    pass with one sample (``svae_smm.forward``; ``eps`` (1, N, K, d)
    injects its noise, which E[u] does not depend on)."""
    from svax_torch.models import svae_smm

    with torch.no_grad():
        out = svae_smm.forward(state.nn_params, state.pgm_nat, prior, x,
                               config._replace(num_samples=1), eps=eps, generator=generator)
    post = out.posterior
    return (torch.exp(post.log_resp) * post.e_u).sum(dim=-1).cpu().numpy()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--outlier-fraction", type=float, default=0.15)
    p.add_argument("--dof", type=float, default=4.0)
    p.add_argument("--num-components", "-K", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scan-chunk", type=int, default=500)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--plot", type=str, default="")
    p.add_argument("--activation", choices=["tanh", "relu"], default="tanh",
                   help="hidden activation of both nets: tanh saturates large inputs, "
                        "so box outliers reach the latent space at ordinary radii; relu "
                        "passes them through")
    p.add_argument("--json", default="",
                   help="also write the printed summary here (not a reference artifact "
                        "in runs/)")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Run the demo; returns the printed dict plus "kernels" (the engine
    each variant trained on)."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (use --device cpu)")
    from svax_torch.utils import viz
    from svax_torch.utils.runs import port_artifact, write_json

    if args.json:
        port_artifact(args.json)  # refuse a reference artifact before any work
    viz.check_available(args.plot)
    from svax_torch.data.pinwheel import make_pinwheel_data, make_pinwheel_with_outliers
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import loop, svae_step

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    train_np, train_labels = make_pinwheel_with_outliers(
        outlier_fraction=args.outlier_fraction, num_per_class=80, seed=args.seed)
    test_np = make_pinwheel_data(num_per_class=40, seed=args.seed + 7)
    x_train = torch.tensor(train_np, dtype=torch.float32, device=device)
    x_test = torch.tensor(test_np, dtype=torch.float32, device=device)
    n = x_train.shape[0]
    is_out = np.asarray(train_labels) < 0

    results, kernels, latents, seconds = {}, {}, {}, {}
    for name, dof in (("gmm", 0.0), ("smm", args.dof)):
        t0 = time.perf_counter()
        config = SvaeConfig(latent_dim=2, num_components=args.num_components, num_samples=2,
                            num_total=n, dof=dof, activation=args.activation)
        prior = gmm.make_prior(args.num_components, 2, kappa=0.05, device=device)
        state = svae_step.init_state(torch.Generator(device=device).manual_seed(args.seed),
                                     2, config, prior, HIDDEN, HIDDEN, data=x_train)
        state, metrics, kernels[name] = loop.train_chosen(
            state, config, prior, x_train, args.steps, lr=LR, rho=RHO, hidden=HIDDEN,
            seed=args.seed, chunk=args.scan_chunk)
        evaluate = svae_step.make_eval_fn(config, prior)

        def elbo(x):
            gen = torch.Generator(device=device).manual_seed(args.seed + 1)
            return float(evaluate(state, x, generator=gen)["elbo_per_point"])

        results[name] = {
            "clean_test_elbo_per_point": elbo(x_test),
            "contaminated_train_elbo_per_point": elbo(x_train),
            "final_train_elbo": float(metrics["elbo"][-1]),
        }
        if name == "smm":
            e_u = point_e_u(state, prior, x_train, config,
                            generator=torch.Generator(device=device).manual_seed(args.seed))
            results["smm"]["mean_Eu_outliers"] = float(e_u[is_out].mean())
            results["smm"]["mean_Eu_clean"] = float(e_u[~is_out].mean())
        seconds[name] = time.perf_counter() - t0  # the results are on the host
        if args.plot:
            latents[name] = (*viz.svae_latent(
                state, config, prior, x_train,
                torch.Generator(device=device).manual_seed(args.seed)), state.pgm_nat)

    results["dof"] = args.dof
    results["outlier_fraction"] = args.outlier_fraction
    results["activation"] = args.activation
    print(json.dumps(results, indent=2), flush=True)
    if args.json:
        write_json(args.json, {**results, "config": vars(args), "kernels": kernels,
                               "seconds": seconds})

    if args.plot:
        plt = viz.pyplot()
        fig, axes = plt.subplots(1, 2, figsize=(11, 5))
        for ax, name in zip(axes, ("gmm", "smm")):
            z_mean, resp, nat = latents[name]
            viz.plot_latent_space(z_mean, resp, nat, None, ax=ax)
            ax.set_title(f"{name.upper()}-prior SVAE latent (train incl. outliers)")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        plt.close(fig)
        print(f"wrote {args.plot}")
    return {**results, "kernels": kernels, "seconds": seconds}


if __name__ == "__main__":
    main()
