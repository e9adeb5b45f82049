"""Train an SVAE with the port (PyTorch + the tinystep and flexstep CUDA kernels).

    python -m svax_torch.train_svae --config pinwheel-svae|auto-svae
        [--steps N] [--device cuda|cpu] [--engine kernel|plain] [--seed S]
        [--iw-samples S]

Mirrors the megakernel branch of experiments/train_svae.py: chunks of the
config's ``scan_chunk`` steps, each one kernel launch on CUDA —
tinystep for ``pinwheel-svae`` (full batch, d = 2, constant ρ), flexstep
for ``auto-svae`` (minibatches of 64 drawn with replacement, latent d = 4,
ρ₀/(1 + decay·t)); ``loop.choose_kernel`` picks as the reference does.
``--engine plain`` runs the plain PyTorch step instead; on the CPU both run
the plain step. Prints the test ELBO of the initial state, one JSON row
per chunk — step, elbo, recon, local_kl, global_kl, test_elbo_per_point,
wall_s — then steps/sec, then the importance-weighted test log-likelihood
with ``--iw-samples`` samples (0 = off). ``--device cuda`` without a CUDA
device raises; nothing falls back. The configs the port runs are
``pinwheel-svae`` and ``auto-svae``; ROADMAP.md lists the rest.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parents[1]
PORTED = ("pinwheel-svae", "auto-svae")


def main(argv: list[str] | None = None) -> dict:
    """Run the trainer; returns {"state", "rows", "steps_per_s", "kernel",
    "init_test_elbo_per_point", "final_test_iw_loglik_per_point", "meta"}."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="pinwheel-svae")
    p.add_argument("--steps", type=int, default=0,
                   help="training steps (0 = the config's)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--engine", choices=["kernel", "plain"], default="kernel")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iw-samples", type=int, default=100,
                   help="importance-weighted final test log-lik samples (0 = off)")
    args = p.parse_args(argv)
    if args.config not in PORTED:
        p.error(f"--config {args.config}: svax_torch runs {', '.join(PORTED)} so far; "
                "ROADMAP.md lists the remaining configs")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")

    if str(_ROOT) not in sys.path:
        sys.path.insert(0, str(_ROOT))
    from configs import CONFIGS

    from svax_torch.data import load_dataset
    from svax_torch.models import evaluation
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step
    from svax_torch.train.loop import choose_kernel, make_runner

    cfg = CONFIGS[args.config]
    steps = args.steps or cfg["steps"]
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32

    train, test, meta = load_dataset(cfg["dataset"], seed=args.seed)
    x_train = torch.tensor(train, dtype=f32, device=device)
    x_test = torch.tensor(test, dtype=f32, device=device)
    n, input_dim = x_train.shape
    batch = cfg["batch_size"] if 0 < cfg["batch_size"] < n else n
    rho_decay = cfg.get("rho_decay", 0.0)
    config = SvaeConfig(latent_dim=cfg["latent_dim"],
                        num_components=cfg["num_components"],
                        num_samples=cfg["num_samples"], num_total=n)
    kernel = choose_kernel(
        config, batch_full=batch >= n, encoder_hidden=cfg["encoder_hidden"],
        decoder_hidden=cfg["decoder_hidden"], rho=cfg["rho"], rho_decay=rho_decay,
        likelihood=meta["likelihood"], input_dim=input_dim,
    )

    prior = gmm.make_prior(config.num_components, config.latent_dim,
                           alpha=cfg["alpha"], kappa=cfg["kappa"],
                           device=device, dtype=f32)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = svae_step.init_state(
        gen, input_dim, config, prior,
        encoder_hidden=tuple(cfg["encoder_hidden"]),
        decoder_hidden=tuple(cfg["decoder_hidden"]),
    )
    runner = make_runner(config, prior, lr=cfg["lr"], rho=cfg["rho"],
                         rho_decay=rho_decay, batch_size=batch,
                         aug_noise=cfg.get("aug_noise", 0.0), engine=args.engine,
                         kernel=kernel)
    evaluate = svae_step.make_eval_fn(config, prior)
    if args.engine == "kernel" and device.type == "cuda":
        from svax_torch.ops import _build

        _build.load()  # build outside the timed region

    def test_elbo() -> float:
        ev_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        return float(evaluate(state, x_test, generator=ev_gen)["elbo_per_point"])

    init_elbo = test_elbo()
    print(json.dumps({"config": args.config, "kernel": kernel, "engine": args.engine,
                      "n": n, "d_in": input_dim, "batch": batch,
                      "synthetic": meta.get("synthetic", False),
                      "init_test_elbo_per_point": init_elbo}), flush=True)
    rows = []

    def emit(t, metrics):
        row = {
            "step": t,
            "elbo": float(metrics["elbo"]),
            "recon": float(metrics["recon"]),
            "local_kl": float(metrics["local_kl"]),
            "global_kl": float(metrics["global_kl"]),
            "test_elbo_per_point": test_elbo(),
            "wall_s": round(time.perf_counter() - t0, 3),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    chunk = cfg.get("scan_chunk") or 1000
    t0 = time.perf_counter()
    t = 0
    while t < steps:
        todo = min(chunk, steps - t)
        state, metrics = runner(state, x_train, todo, seed=args.seed)
        t += todo
        emit(t, {k: v[-1] for k, v in metrics.items()})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rate = steps / (time.perf_counter() - t0)
    print(f"steps/sec: {rate:.1f} (device={args.device}, engine={args.engine}, "
          f"kernel={kernel})")
    out = {"state": state, "rows": rows, "steps_per_s": rate, "kernel": kernel,
           "init_test_elbo_per_point": init_elbo, "meta": meta}
    if args.iw_samples > 0:
        iw_gen = torch.Generator(device=device).manual_seed(args.seed + 2)
        iw = evaluation.svae_iw_loglik(state.nn_params, state.pgm_nat, x_test,
                                       args.iw_samples, generator=iw_gen)
        out["final_test_iw_loglik_per_point"] = float(iw.mean())
        print(json.dumps({"final_test_iw_loglik_per_point": float(iw.mean()),
                          "iw_samples": args.iw_samples}), flush=True)
    return out


if __name__ == "__main__":
    main()
