"""Quality of the Bernoulli, high-d configs with the port
(``experiments/mnist_quality.py``).

    python -m svax_torch.mnist_quality [--quick] [--configs mnist-svae bigk-dp]
        [--iw-samples S] [--out runs/mnist_quality_torch.json] [--device cuda|cpu]

Trains each config with its pinned kernel defaults on one card — the
per-step engine, each step's SIN combine in the combine kernels with the
ε drawn inside them (``fused_combine``, ``kernel_rng``), the decoder in the
fused MLP decoder kernel on bigk-dp (``fused_mlp_decoder``), the bf16
decoder body, the config's ρ = 0 warmup and k-means++ reseed — as the
reference does: the initial state from a generator seeded 0, the warmup's
reseed seeded 0, minibatches of the config's size drawn with replacement
in chunks of its ``scan_chunk``, ρ₀/(1 + decay·t). Then it scores the
held-out split with the reference's plain evaluation config (the fused
switches off, an f32 decoder): the test ELBO per point (generator seeded
99), IW(``--iw-samples``) (seeded 999), the cluster purity of the hard SIN
assignment against the labels and the number of components in use.
``--quick`` cuts each config to 400 steps, its warmup to at most 400 and
the IW bound to 20 samples, as the reference's. Writes one row a config,
with the reference's keys, to ``--out`` (never over the reference's
``runs/mnist_quality.json``). On CPU tensors every kernel runs its plain
version; ``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

DEFAULT_OUT = "runs/mnist_quality_torch.json"
QUICK_STEPS, QUICK_IW = 400, 20


def run_config(name: str, *, quick: bool = False, iw_samples: int = 100,
               device: str = "cuda", cfg: dict | None = None) -> dict:
    """Train and score one config (``cfg`` replaces the named config's
    dict, for a cut run); returns the reference's row."""
    from svax_torch.configs import CONFIGS
    from svax_torch.data.mnist import load_mnist
    from svax_torch.models import evaluation
    from svax_torch.models import svae as svae_mod
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.nets import mlp as nets
    from svax_torch.pgm import gmm
    from svax_torch.train import loop, svae_step
    from svax_torch.train.warmup import vae_warmup_reseed

    cfg = dict(CONFIGS[name] if cfg is None else cfg)
    device = torch.device(device)
    x_train, x_test, meta, _y_train, y_test = load_mnist(seed=0, return_labels=True)
    x = torch.tensor(x_train, dtype=torch.float32, device=device)
    xt = torch.tensor(x_test, dtype=torch.float32, device=device)
    n = x.shape[0]
    steps = QUICK_STEPS if quick else cfg["steps"]
    batch = cfg["batch_size"]
    chunk = min(cfg.get("scan_chunk", 100), steps)
    config = SvaeConfig(
        latent_dim=cfg["latent_dim"], num_components=cfg["num_components"],
        num_samples=cfg["num_samples"], likelihood="bernoulli", num_total=n,
        nn_compute_dtype=cfg.get("nn_compute_dtype", "float32"),
        fused_combine=cfg.get("fused_combine", False),
        fused_mlp_decoder=cfg.get("fused_mlp_decoder", False),
        kernel_rng=cfg.get("kernel_rng", False))
    prior = gmm.make_prior(config.num_components, config.latent_dim,
                           alpha=cfg.get("alpha", 1.0), kappa=cfg.get("kappa", 0.05),
                           device=device)
    state = svae_step.init_state(torch.Generator(device=device).manual_seed(0), x.shape[1],
                                 config, prior, tuple(cfg["encoder_hidden"]),
                                 tuple(cfg["decoder_hidden"]), data=x)
    runner = loop.make_step_runner(config, prior, lr=cfg["lr"], rho=cfg["rho"],
                                   rho_decay=cfg.get("rho_decay", 0.0), batch_size=batch)
    if device.type == "cuda":
        from svax_torch.ops import _build

        _build.load()  # build outside the timed region
    t0 = time.perf_counter()
    warmup = cfg.get("warmup_steps", 0)
    if quick:
        warmup = min(warmup, QUICK_STEPS)
    if warmup:
        state, winfo = vae_warmup_reseed(state, x, config, prior, lr=cfg["lr"],
                                         steps=warmup, batch_size=batch, scan_chunk=chunk)
        print(f"[{name}] warmup {warmup} steps, reseed occupancy "
              f"{winfo['seed_occupancy']}", flush=True)
    for _ in range(steps // chunk):
        state, mets = runner(state, x, chunk, seed=0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    eval_config = config._replace(fused_combine=False, fused_mlp_decoder=False,
                                  kernel_rng=False, nn_compute_dtype="float32")
    ev = svae_step.make_eval_fn(eval_config, prior)(
        state, xt, generator=torch.Generator(device=device).manual_seed(99))
    iw = evaluation.svae_iw_loglik(state.nn_params, state.pgm_nat, xt, iw_samples,
                                   generator=torch.Generator(device=device).manual_seed(999),
                                   likelihood="bernoulli")
    row = {
        "steps": steps,
        "train_wall_s": round(wall, 1),
        "final_train_elbo_per_point": round(float(mets["elbo"][-1]) / n, 4),
        "test_elbo_per_point": round(float(ev["elbo_per_point"]), 4),
        "test_iw_per_point": round(float(iw.mean()), 4),
        "iw_samples": iw_samples,
        "synthetic_data": bool(meta.get("synthetic", False)),
    }
    if y_test is not None:
        with torch.no_grad():
            exp = gmm.expected_params(state.pgm_nat)
            pot_h, pot_p = nets.encoder_apply(state.nn_params["encoder"], xt)
            post = svae_mod.sin_combine(pot_h, pot_p, exp)
        row["test_cluster_purity"] = round(
            evaluation.cluster_purity(torch.exp(post.log_resp), np.asarray(y_test)), 4)
        row["components_used"] = int(torch.unique(post.log_resp.argmax(-1)).numel())
    else:
        row["test_cluster_purity"] = None
    return row


def main(argv: list[str] | None = None) -> dict:
    """Run the configs; returns {config: row}."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--configs", nargs="+", choices=["mnist-svae", "bigk-dp"],
                    default=["mnist-svae", "bigk-dp"])
    ap.add_argument("--iw-samples", type=int, default=100)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")
    from svax_torch.utils.runs import port_artifact, write_json

    port_artifact(args.out)  # before any training
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    for name in args.configs:
        out[name] = run_config(name, quick=args.quick,
                               iw_samples=QUICK_IW if args.quick else args.iw_samples,
                               device=args.device)
        print(f"[{name}] {json.dumps(out[name])}", flush=True)
    print(f"wrote {write_json(args.out, out)}")
    return out


if __name__ == "__main__":
    main()
