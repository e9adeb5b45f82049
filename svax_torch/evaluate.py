"""Standalone evaluation (``experiments/evaluate.py``): restore a
checkpoint and report held-out metrics.

    python -m svax_torch.evaluate --checkpoint-dir DIR [--config NAME]
        [--dataset pinwheel|auto|mnist] [-K K] [-L L] [-S S]
        [--encoder-hidden W ...] [--decoder-hidden W ...] [--alpha A] [--kappa KAPPA]
        [--iw-samples S] [--smm-dof DOF [--smm-iters R]] [--seed S]
        [--encoder-head diag|full] [--recon-mode weighted|sampled]
        [--nn-precision highest|high|default] [--nn-compute-dtype float32|bfloat16]
        [--device cuda|cpu] [--plot PATH]

Restores the latest checkpoint that ``svax_torch.train_svae`` wrote to
``--checkpoint-dir`` and prints one JSON line: the checkpoint's step, the
test ELBO and reconstruction per point, and the importance-weighted test
log-likelihood bound with ``--iw-samples`` samples (the SMM bound with
``--smm-dof``). The architecture comes from the reference entry's flags,
with its defaults (pinwheel, K = 10, latent d = 2, S = 4, 50-50), and
``--config`` overlays a named config as ``train_svae`` does (flags typed
on the command line win), so the flags that trained a free-form
checkpoint score it. The noise comes from generators seeded ``seed + 1``
(the ELBO) and ``seed + 2`` (the bound), as the training entry draws its
own, so a checkpoint of a finished run reproduces that run's last test
ELBO and its bound. The plain PyTorch model evaluates (no kernel), in the
decoder compute dtype; ``--encoder-head``, ``--recon-mode``,
``--nn-precision`` and ``--nn-compute-dtype`` are the training run's.
``--device cuda`` without a CUDA device raises. ``--plot PATH`` writes the
latent space of the test split (``utils.viz``, as ``train_svae --plot``;
it needs matplotlib).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from svax_torch.utils import viz


def main(argv: list[str] | None = None) -> dict:
    """Evaluate; returns the printed dict."""
    from svax_torch.train_svae import add_workload_flags, apply_named_config

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", required=True)
    add_workload_flags(p)
    p.add_argument("--iw-samples", type=int, default=200)
    args = p.parse_args(argv)
    apply_named_config(p, args, sys.argv[1:] if argv is None else argv)
    viz.check_available(args.plot)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu)")

    from svax_torch.data import load_dataset
    from svax_torch.models import evaluation
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step
    from svax_torch.train.checkpoint import Checkpointer

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    train, test, meta = load_dataset(args.dataset, seed=args.seed)
    x_test = torch.tensor(test, dtype=torch.float32, device=device)
    n, input_dim = train.shape
    config = SvaeConfig(latent_dim=args.latent_dim, num_components=args.num_components,
                        num_samples=args.num_samples, num_total=n,
                        likelihood=meta["likelihood"],
                        nn_compute_dtype=args.nn_compute_dtype,
                        dof=args.smm_dof, smm_iters=args.smm_iters,
                        nn_precision=args.nn_precision,
                        encoder_head=args.encoder_head, recon_mode=args.recon_mode)
    prior = gmm.make_prior(config.num_components, config.latent_dim, alpha=args.alpha,
                           kappa=args.kappa, device=device)
    template = svae_step.init_state(
        torch.Generator(device=device).manual_seed(args.seed), input_dim, config, prior,
        tuple(args.encoder_hidden), tuple(args.decoder_hidden))
    state, _, step = Checkpointer(args.checkpoint_dir).restore_or(template)
    if step == 0:
        raise SystemExit(f"no checkpoint found in {args.checkpoint_dir}")

    ev = svae_step.make_eval_fn(config, prior)(
        state, x_test, generator=torch.Generator(device=device).manual_seed(args.seed + 1))
    iw_gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    iw_kw = dict(likelihood=config.likelihood, encoder_head=config.encoder_head,
                 activation=config.activation)
    if config.dof > 0.0:
        iw = evaluation.svae_smm_iw_loglik(
            state.nn_params, state.pgm_nat, x_test, args.iw_samples, dof=config.dof,
            smm_iters=config.smm_iters, generator=iw_gen, **iw_kw)
    else:
        iw = evaluation.svae_iw_loglik(state.nn_params, state.pgm_nat, x_test,
                                       args.iw_samples, generator=iw_gen, **iw_kw)
    out = {
        "checkpoint_step": step,
        "test_elbo_per_point": float(ev["elbo_per_point"]),
        "test_recon_per_point": float(ev["recon_per_point"]),
        "test_iw_loglik_per_point": float(iw.mean()),
        "iw_samples": args.iw_samples,
    }
    print(json.dumps(out), flush=True)
    if args.plot:
        z_mean, resp = viz.svae_latent(state, config, prior, x_test,
                                       torch.Generator(device=device).manual_seed(args.seed))
        viz.plot_latent_space(z_mean, resp, state.pgm_nat, args.plot)
        print(f"wrote {args.plot}")
    return out


if __name__ == "__main__":
    main()
