"""Train the plain-VAE baseline with the port (``experiments/train_vae.py``).

    python -m svax_torch.train_vae [--dataset pinwheel|auto|mnist]
        [--latent-dim L] [--num-samples S] [--encoder-hidden H ...]
        [--decoder-hidden H ...] [--steps N] [--batch-size M] [--lr LR]
        [--seed S] [--eval-every E] [--device cuda|cpu] [--logfile PATH]

The reference entry's flags and metric lines, with ``--device`` in place
of ``--platform``: a first line naming the device and the data, then one
JSON row {"step", "elbo_per_point", "test_elbo_per_point"} after step 1
and every ``--eval-every`` steps (also appended to ``--logfile``), then
``steps/sec``. Each step trains on the full batch, or on ``--batch-size``
distinct rows drawn afresh, as the reference's ``choice(...,
replace=False)``. One ``torch.Generator`` on the device seeded ``--seed``
makes the initial params, then each step's rows and ε; the test ELBO's ε
comes from a second one seeded ``--seed + 1``. ``--device cuda`` (the
default) raises without a card; the VAE runs no kernel of its own.
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv: list[str] | None = None) -> dict:
    """Run the trainer; returns {"state", "rows", "steps_per_s"}."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=["pinwheel", "auto", "mnist"], default="pinwheel")
    p.add_argument("--latent-dim", "-L", type=int, default=2)
    p.add_argument("--num-samples", "-S", type=int, default=1)
    p.add_argument("--encoder-hidden", type=int, nargs="+", default=[50, 50])
    p.add_argument("--decoder-hidden", type=int, nargs="+", default=[50, 50])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=200)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--logfile", type=str, default="")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")

    from svax_torch.data import load_dataset
    from svax_torch.models import vae
    from svax_torch.train.loop import minibatch_indices
    from svax_torch.train.metrics import JsonlLogger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    train, test, meta = load_dataset(args.dataset, seed=args.seed)
    x_train = torch.tensor(train, dtype=torch.float32, device=device)
    x_test = torch.tensor(test, dtype=torch.float32, device=device)
    n, input_dim = x_train.shape
    batch = args.batch_size if 0 < args.batch_size < n else n
    config = vae.VaeConfig(latent_dim=args.latent_dim, num_samples=args.num_samples,
                           likelihood=meta["likelihood"])
    gen = torch.Generator(device=device).manual_seed(args.seed)
    eval_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    state = vae.init_state(gen, input_dim, config, tuple(args.encoder_hidden),
                           tuple(args.decoder_hidden), device=device)
    step = vae.make_train_step(config, args.lr)
    print(f"device={device} dataset={args.dataset} n={n} D={input_dim}", flush=True)

    # One throwaway step first, as the reference's compile step.
    step(state, x_train[:batch], torch.Generator(device=device).manual_seed(args.seed))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    logger = JsonlLogger(args.logfile or None)
    rows = []
    t0 = time.perf_counter()
    for t in range(args.steps):
        xb = x_train[minibatch_indices(gen, n, batch, 1, replace=False)[0]] \
            if batch < n else x_train
        state, metrics = step(state, xb, gen)
        if (t + 1) % args.eval_every == 0 or t == 0:
            with torch.no_grad():
                test_elbo = vae.elbo(state.params, x_test, eval_gen, config)[0]
            rows.append(logger.log(t + 1, elbo_per_point=float(metrics["elbo_per_point"]),
                                   test_elbo_per_point=float(test_elbo)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rate = args.steps / (time.perf_counter() - t0)
    logger.close()
    print(f"steps/sec: {rate:.1f}")
    return {"state": state, "rows": rows, "steps_per_s": rate}


if __name__ == "__main__":
    main()
