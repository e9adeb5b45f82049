"""Train the pinwheel SVAE with the port (PyTorch + the tinystep CUDA kernel).

    python -m svax_torch.train_svae --config pinwheel-svae [--steps N]
        [--device cuda|cpu] [--engine kernel|plain] [--seed S]

Mirrors the megakernel branch of experiments/train_svae.py: full-batch
chunks of ``scan_chunk`` steps, each one launch of the tinystep kernel on
CUDA (``--engine plain`` runs the plain PyTorch step instead; on the CPU
both run the plain step). Prints one JSON row per chunk — step, elbo,
recon, local_kl, global_kl, test_elbo_per_point, wall_s — then steps/sec.
``--device cuda`` without a CUDA device raises; nothing falls back.
Only ``pinwheel-svae`` is ported (ROADMAP.md lists the rest).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> dict:
    """Run the trainer; returns {"state", "rows", "steps_per_s"}."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="pinwheel-svae")
    p.add_argument("--steps", type=int, default=0,
                   help="training steps (0 = the config's)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--engine", choices=["kernel", "plain"], default="kernel")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.config != "pinwheel-svae":
        p.error(f"--config {args.config}: only pinwheel-svae is ported to "
                "svax_torch so far; ROADMAP.md lists the remaining configs")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")

    if str(_ROOT) not in sys.path:
        sys.path.insert(0, str(_ROOT))
    from configs import CONFIGS

    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step
    from svax_torch.train.loop import kernel_unsupported_reason, make_runner

    cfg = CONFIGS[args.config]
    steps = args.steps or cfg["steps"]
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32

    train, test = load_pinwheel(seed=args.seed)
    x_train = torch.tensor(train, dtype=f32, device=device)
    x_test = torch.tensor(test, dtype=f32, device=device)
    n, input_dim = x_train.shape
    config = SvaeConfig(latent_dim=cfg["latent_dim"],
                        num_components=cfg["num_components"],
                        num_samples=cfg["num_samples"], num_total=n)
    reason = kernel_unsupported_reason(
        config, batch_full=cfg["batch_size"] == 0,
        encoder_hidden=cfg["encoder_hidden"],
        decoder_hidden=cfg["decoder_hidden"], rho=cfg["rho"],
        rho_decay=cfg.get("rho_decay", 0.0),
    )
    if reason is not None:
        raise ValueError(f"{args.config}: {reason}")

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
                         aug_noise=cfg["aug_noise"], engine=args.engine)
    evaluate = svae_step.make_eval_fn(config, prior)
    if args.engine == "kernel" and device.type == "cuda":
        from svax_torch.ops import _build

        _build.load()  # build outside the timed region

    rows = []

    def emit(t, metrics):
        ev_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        ev = evaluate(state, x_test, generator=ev_gen)
        row = {
            "step": t,
            "elbo": float(metrics["elbo"]),
            "recon": float(metrics["recon"]),
            "local_kl": float(metrics["local_kl"]),
            "global_kl": float(metrics["global_kl"]),
            "test_elbo_per_point": float(ev["elbo_per_point"]),
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
    print(f"steps/sec: {rate:.1f} (device={args.device}, engine={args.engine})")
    return {"state": state, "rows": rows, "steps_per_s": rate}


if __name__ == "__main__":
    main()
