"""Train an SVAE with the port (PyTorch + the tinystep, flexstep, combine
and decoder_mlp CUDA kernels).

    python -m svax_torch.train_svae --config pinwheel-svae|auto-svae|mnist-svae|bigk-dp
        [--steps N] [--warmup-steps N] [--device cuda|cpu]
        [--engine kernel|plain] [--seed S] [--iw-samples S]
        [--fused-mlp-decoder] [--eval-every N] [--dp]
        [--smm-dof DOF [--smm-iters R] [--smm-envelope-grads]]

Mirrors experiments/train_svae.py with its ``--engine auto`` rule
(``loop.choose_kernel``): chunks of the config's ``scan_chunk`` steps.
``pinwheel-svae`` (full batch, d = 2, constant ρ) runs each chunk as one
launch of the tinystep kernel; ``auto-svae`` (minibatches of 64 drawn with
replacement, latent d = 4, ρ₀/(1 + decay·t)) as one launch of flexstep;
``mnist-svae`` (Bernoulli decoder with a bf16 body, latent d = 8, 200-200,
minibatches of 256) fits neither, so it runs on the per-step engine
(``loop.make_step_runner``), each step's SIN combine in the combine kernel
with in-kernel ε, after the config's ρ = 0 warmup and k-means++ reseed
(``train.warmup``). ``bigk-dp`` (K = 100, latent d = 10, minibatches of
1024) runs the same way on one card, with the decoder in the fused MLP
decoder kernel (``fused_mlp_decoder``), each step's minibatch drawn
without replacement, and a row after step 1 and every ``--eval-every``
steps (and after the last), as the reference's data-parallel loop.
``--dp`` (on in bigk-dp's config) is that loop: on one process it is the
per-step engine as it stands; under ``torchrun`` with ``WORLD_SIZE`` > 1
it shards each minibatch over the ranks (``parallel.mesh``: every rank
draws the same global indices and keeps its contiguous slice, the batch
rounded down to a multiple of the world size), sums the gradients and
statistics over them, and rank 0 alone evaluates and prints; the warmup
runs on every rank alike, replicated, as the reference runs it before its
sharded loop. ``--device cuda`` puts rank r on ``cuda:LOCAL_RANK``; on the
CPU the ranks join over gloo:

    torchrun --standalone --nproc-per-node 2 -m svax_torch.train_svae \
        --config bigk-dp --device cpu --steps 2

More than one process without ``--dp`` is refused. ``--fused-mlp-decoder`` turns the decoder
kernel on for the other Bernoulli config, mnist-svae, and is refused for a
Gaussian one. ``--engine plain`` runs the plain PyTorch step instead (for
the Bernoulli configs: ``sin_combine``, ``torch.randn`` ε and the
decomposed decoder); on the CPU every kernel runs its plain version.
``--smm-dof DOF`` (> 0) trains the Student-t mixture prior
(``models.svae_smm``) with ``--smm-iters`` u–z rounds and, with
``--smm-envelope-grads``, q(u) held constant in the backward: pinwheel-svae
keeps tinystep (its SMM branch), the other configs run the per-step engine
(flexstep takes the GMM prior only), and as in the reference the SMM
forward runs the plain combine and decoder, so the first line reports
``fused_combine`` and ``fused_mlp_decoder`` off; the IW line is the SMM
bound (``evaluation.svae_smm_iw_loglik``).
Prints one JSON line with the engine, its reason, the world size and mesh
(``world_size``, ``data``, ``comp``) and the initial test ELBO, the warmup
line, one JSON row per chunk — step, elbo, recon,
local_kl, global_kl, test_elbo_per_point, wall_s — then steps/sec, then
the importance-weighted test log-likelihood with ``--iw-samples`` samples
(0 = off). ``--device cuda`` without a CUDA device raises; nothing falls
back. The configs the port runs are pinwheel-svae, auto-svae, mnist-svae
and bigk-dp; ROADMAP.md lists the rest.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

PORTED = ("pinwheel-svae", "auto-svae", "mnist-svae", "bigk-dp")


def main(argv: list[str] | None = None) -> dict:
    """Run the trainer; returns {"state", "rows", "steps_per_s", "kernel",
    "why", "init_test_elbo_per_point", "final_test_iw_loglik_per_point",
    "meta", "warmup", "x_test"}."""
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
    p.add_argument("--warmup-steps", type=int, default=None,
                   help="rho = 0 warmup steps before the k-means++ reseed "
                        "(default: the config's; 0 = none)")
    p.add_argument("--fused-mlp-decoder", action="store_true",
                   help="the Bernoulli decoder in the fused MLP decoder kernel "
                        "(on in bigk-dp's config; refused for a Gaussian config)")
    p.add_argument("--eval-every", type=int, default=200,
                   help="data-parallel configs (bigk-dp): a row after step 1, every "
                        "N steps and after the last")
    p.add_argument("--smm-dof", type=float, default=0.0,
                   help="Student-t mixture latent prior with this many degrees of "
                        "freedom (0 = Gaussian mixture prior)")
    p.add_argument("--smm-iters", type=int, default=2,
                   help="u-z coordinate rounds in the SMM combine")
    p.add_argument("--smm-envelope-grads", action="store_true",
                   help="envelope-theorem gradients for the SMM u-rounds: the "
                        "converged q(u) is held constant in the backward pass")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over the WORLD_SIZE ranks torchrun starts "
                        "(on in bigk-dp's config)")
    args = p.parse_args(argv)
    if args.config not in PORTED:
        p.error(f"--config {args.config}: svax_torch runs {', '.join(PORTED)} so far; "
                "ROADMAP.md lists the remaining configs")
    if args.eval_every < 1:
        p.error("--eval-every must be >= 1")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")

    from svax_torch.configs import CONFIGS
    from svax_torch.parallel import mesh

    cfg = CONFIGS[args.config]
    data_parallel = args.dp or bool(cfg.get("dp", False))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not data_parallel:
        p.error(f"WORLD_SIZE={world}: more than one process needs --dp")
    device = torch.device(args.device)
    data_group, rank, joined = None, 0, False
    if world > 1:
        import torch.distributed as dist

        joined = not dist.is_initialized()
        device = mesh.init_distributed(args.device)
        data_group, rank = mesh.make_data_mesh().data_group, dist.get_rank()
    try:
        return _train(args, p, cfg, device, data_parallel, world, data_group, rank)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, p, cfg, device, data_parallel, world, data_group, rank) -> dict:
    """The training run of ``main`` on this rank; rank 0 prints."""
    from svax_torch.data import load_dataset
    from svax_torch.models import evaluation
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step, warmup
    from svax_torch.train.loop import (PER_STEP, choose_kernel, kernel_unsupported_reason,
                                       make_runner, make_step_runner)

    steps = args.steps or cfg["steps"]
    warmup_steps = (cfg.get("warmup_steps", 0) if args.warmup_steps is None
                    else args.warmup_steps)

    def show(*a, **kw) -> None:
        if rank == 0:
            print(*a, **kw)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # A bf16 matmul may otherwise reduce split-K partial sums in bf16; the
    # reference accumulates its bf16 decoder products in f32.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    f32 = torch.float32

    train, test, meta = load_dataset(cfg["dataset"], seed=args.seed)
    if args.fused_mlp_decoder and meta["likelihood"] != "bernoulli":
        p.error(f"--fused-mlp-decoder: the fused MLP decoder is a Bernoulli head, and "
                f"{args.config} has a {meta['likelihood']} likelihood")
    x_train = torch.tensor(train, dtype=f32, device=device)
    x_test = torch.tensor(test, dtype=f32, device=device)
    n, input_dim = x_train.shape
    batch = cfg["batch_size"] if 0 < cfg["batch_size"] < n else n
    if batch % world:  # experiments/train_svae.py:278-280
        batch = (batch // world) * world or world
        show(f"rounding batch to {batch} for {world} data ranks", flush=True)
    rho_decay = cfg.get("rho_decay", 0.0)
    config = SvaeConfig(latent_dim=cfg["latent_dim"],
                        num_components=cfg["num_components"],
                        num_samples=cfg["num_samples"], num_total=n,
                        likelihood=meta["likelihood"],
                        nn_compute_dtype=cfg.get("nn_compute_dtype", "float32"),
                        fused_combine=cfg.get("fused_combine", False),
                        kernel_rng=cfg.get("kernel_rng", False),
                        fused_mlp_decoder=(cfg.get("fused_mlp_decoder", False)
                                           or args.fused_mlp_decoder),
                        dof=args.smm_dof, smm_iters=args.smm_iters,
                        smm_envelope_grads=args.smm_envelope_grads)
    if config.dof > 0.0:
        # The SMM forward runs the plain combine and decoder (the reference's
        # svae_smm.forward): the fused switches do not act on it.
        config = config._replace(fused_combine=False, kernel_rng=False,
                                 fused_mlp_decoder=False)
    gate = dict(batch_full=batch >= n, encoder_hidden=cfg["encoder_hidden"],
                decoder_hidden=cfg["decoder_hidden"], rho=cfg["rho"],
                rho_decay=rho_decay, likelihood=meta["likelihood"], input_dim=input_dim,
                data_parallel=data_parallel)
    kernel = choose_kernel(config, engine="auto", **gate)
    why = kernel_unsupported_reason(config, **gate) if kernel == PER_STEP else None

    prior = gmm.make_prior(config.num_components, config.latent_dim,
                           alpha=cfg["alpha"], kappa=cfg["kappa"],
                           device=device, dtype=f32)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = svae_step.init_state(
        gen, input_dim, config, prior,
        encoder_hidden=tuple(cfg["encoder_hidden"]),
        decoder_hidden=tuple(cfg["decoder_hidden"]),
    )
    if kernel == PER_STEP:
        runner = make_step_runner(config, prior, lr=cfg["lr"], rho=cfg["rho"],
                                  rho_decay=rho_decay, batch_size=batch, engine=args.engine,
                                  replace=not data_parallel, data_group=data_group)
    else:
        runner = make_runner(config, prior, lr=cfg["lr"], rho=cfg["rho"],
                             rho_decay=rho_decay, batch_size=batch,
                             aug_noise=cfg.get("aug_noise", 0.0), engine=args.engine,
                             kernel=kernel)
    # The evaluation runs the training path's combine and decoder: on the
    # plain engine with fused_combine and fused_mlp_decoder off, on the
    # kernel engine with the kernels and the in-kernel ε.
    eval_config = (config if args.engine == "kernel"
                   else config._replace(fused_combine=False, kernel_rng=False,
                                        fused_mlp_decoder=False))
    evaluate = svae_step.make_eval_fn(eval_config, prior)
    if args.engine == "kernel" and device.type == "cuda":
        from svax_torch.ops import _build

        _build.load()  # build outside the timed region

    def test_elbo() -> float:
        if eval_config.fused_combine and eval_config.kernel_rng:
            out = evaluate(state, x_test, seed=args.seed + 1)
        else:
            ev_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
            out = evaluate(state, x_test, generator=ev_gen)
        return float(out["elbo_per_point"])

    init_elbo = test_elbo() if rank == 0 else None
    show(json.dumps({"config": args.config, "kernel": kernel, "engine": args.engine,
                      "why": why, "fused_combine": kernel == PER_STEP and
                      args.engine == "kernel" and config.fused_combine,
                      "fused_mlp_decoder": args.engine == "kernel" and
                      config.fused_mlp_decoder and config.likelihood == "bernoulli",
                      "prior": "smm" if config.dof > 0.0 else "gmm", "dof": config.dof,
                      "smm_iters": config.smm_iters,
                      "smm_envelope_grads": config.smm_envelope_grads,
                      "world_size": world, "data": world, "comp": 1,
                      "n": n, "d_in": input_dim, "batch": batch,
                      "synthetic": meta.get("synthetic", False),
                      "init_test_elbo_per_point": init_elbo}), flush=True)
    warm_info = None
    if warmup_steps > 0:  # on the per-step engine, whatever the main engine
        t_warm = time.perf_counter()
        state, warm_info = warmup.vae_warmup_reseed(
            state, x_train, config, prior, lr=cfg["lr"], steps=warmup_steps,
            batch_size=batch, scan_chunk=cfg.get("scan_chunk") or 100, seed=args.seed,
            engine=args.engine)
        warm_info["seconds"] = time.perf_counter() - t_warm
        show(f"warmup {warmup_steps} steps + k-means++ reseed "
              f"({warm_info['seconds']:.1f}s): seed occupancy "
              f"{warm_info['seed_occupancy']}, cov_scale {warm_info['cov_scale']:.4g}",
              flush=True)
    rows = []

    def emit(t, metrics):
        if rank != 0:
            return
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
        # The data-parallel loop's rows: after step 1, then every eval_every.
        todo = (min(1 if t == 0 else args.eval_every - t % args.eval_every, steps - t)
                if data_parallel else min(chunk, steps - t))
        state, metrics = runner(state, x_train, todo, seed=args.seed)
        t += todo
        emit(t, {k: v[-1] for k, v in metrics.items()})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rate = steps / (time.perf_counter() - t0)
    show(f"steps/sec: {rate:.1f} (device={device}, engine={args.engine}, "
         f"kernel={kernel})")
    out = {"state": state, "rows": rows, "steps_per_s": rate, "kernel": kernel,
           "why": why, "init_test_elbo_per_point": init_elbo, "meta": meta,
           "warmup": warm_info, "x_test": x_test}
    if args.iw_samples > 0 and rank == 0:
        iw_gen = torch.Generator(device=device).manual_seed(args.seed + 2)
        if config.dof > 0.0:
            # The SMM bound, as experiments/evaluate.py and svax/serve.py
            # score an SMM model (the reference entry scores the GMM one).
            iw = evaluation.svae_smm_iw_loglik(
                state.nn_params, state.pgm_nat, x_test, args.iw_samples, dof=config.dof,
                smm_iters=config.smm_iters, generator=iw_gen, likelihood=config.likelihood)
        else:
            iw = evaluation.svae_iw_loglik(state.nn_params, state.pgm_nat, x_test,
                                           args.iw_samples, generator=iw_gen,
                                           likelihood=config.likelihood)
        out["final_test_iw_loglik_per_point"] = float(iw.mean())
        print(json.dumps({"final_test_iw_loglik_per_point": float(iw.mean()),
                          "iw_samples": args.iw_samples}), flush=True)
    return out


if __name__ == "__main__":
    main()
