"""Standalone evaluation (``experiments/evaluate.py``): restore a
checkpoint and report held-out metrics.

    python -m svax_torch.evaluate --checkpoint-dir DIR [--config NAME]
        [--iw-samples S] [--smm-dof DOF [--smm-iters R]] [--seed S]
        [--encoder-head diag|full] [--recon-mode weighted|sampled]
        [--nn-precision highest|high|default] [--device cuda|cpu]

Restores the latest checkpoint that ``svax_torch.train_svae --config NAME
--checkpoint-dir DIR`` wrote (the architecture is the config's) and prints
one JSON line: the checkpoint's step, the test ELBO and reconstruction per
point, and the importance-weighted test log-likelihood bound with
``--iw-samples`` samples (the SMM bound with ``--smm-dof``). The noise comes
from generators seeded ``seed + 1`` (the ELBO) and ``seed + 2`` (the
bound), as the training entry draws its own, so a checkpoint of a finished
run reproduces that run's last test ELBO and its bound. The plain PyTorch
model evaluates (no kernel), in the config's decoder compute dtype;
``--encoder-head``, ``--recon-mode`` and ``--nn-precision`` (default the
config's) are the training run's.
``--device cuda`` without a CUDA device raises. ``--plot`` (the latent
space) waits for the plotting module (ROADMAP.md slice H).
"""

from __future__ import annotations

import argparse
import json

import torch


def main(argv: list[str] | None = None) -> dict:
    """Evaluate; returns the printed dict."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--config", default="pinwheel-svae")
    p.add_argument("--iw-samples", type=int, default=200)
    p.add_argument("--smm-dof", type=float, default=0.0,
                   help="evaluate an SMM-prior checkpoint (Student-t dof; 0 = GMM)")
    p.add_argument("--smm-iters", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--encoder-head", choices=["diag", "full"], default="diag")
    p.add_argument("--recon-mode", choices=["weighted", "sampled"], default="weighted")
    p.add_argument("--nn-precision", choices=["highest", "high", "default"], default=None,
                   help="default: the config's, else high")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--plot", default="")
    args = p.parse_args(argv)

    from svax_torch.configs import CONFIGS
    from svax_torch.train_svae import PORTED

    if args.config not in PORTED:
        p.error(f"--config {args.config}: svax_torch runs {', '.join(PORTED)} so far")
    if args.plot:
        p.error("--plot: the latent-space plot waits for the port's plotting module "
                "(ROADMAP.md slice H)")
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
    cfg = CONFIGS[args.config]
    device = torch.device(args.device)
    train, test, meta = load_dataset(cfg["dataset"], seed=args.seed)
    x_test = torch.tensor(test, dtype=torch.float32, device=device)
    n, input_dim = train.shape
    config = SvaeConfig(latent_dim=cfg["latent_dim"], num_components=cfg["num_components"],
                        num_samples=cfg["num_samples"], num_total=n,
                        likelihood=meta["likelihood"],
                        nn_compute_dtype=cfg.get("nn_compute_dtype", "float32"),
                        dof=args.smm_dof, smm_iters=args.smm_iters,
                        nn_precision=args.nn_precision or cfg.get("nn_precision", "high"),
                        encoder_head=args.encoder_head, recon_mode=args.recon_mode)
    prior = gmm.make_prior(config.num_components, config.latent_dim, alpha=cfg["alpha"],
                           kappa=cfg["kappa"], device=device)
    template = svae_step.init_state(
        torch.Generator(device=device).manual_seed(args.seed), input_dim, config, prior,
        tuple(cfg["encoder_hidden"]), tuple(cfg["decoder_hidden"]))
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
    return out


if __name__ == "__main__":
    main()
