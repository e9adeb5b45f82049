"""Train the pure-GMM baseline on pinwheel with the port (PyTorch + the
mixstep and estep CUDA kernels). BASELINE config #2.

    python -m svax_torch.train_gmm --config pinwheel-gmm [--init kmeanspp]
        [--device cuda|cpu] [--engine kernel|plain] [--fused-kernel]
        [--unroll U] [--eval-every E] [--steps N] [--seed S] [--dp]
        [--logfile PATH]

Mirrors experiments/train_gmm.py on the full batch with constant ρ.
``--engine kernel`` (the default) runs chunks of ``--eval-every`` steps,
each one launch of the mixstep kernel on CUDA, and logs each chunk's elbo
with the global KL at the post-chunk naturals. ``--engine plain`` runs the
plain PyTorch step one step at a time and logs each step's elbo at its
pre-update naturals; ``--fused-kernel`` routes its E-step through the estep
kernel (CUDA) and is refused with ``--engine kernel``. On the CPU both
engines run plain PyTorch. ``--unroll`` U ∈ {1, 2, 4, 8} must divide every
chunk and needs the kernel engine. Prints one JSON row per evaluation (step,
wall_s, elbo, test_evidence_per_point; ``train.metrics.JsonlLogger``, also
appended to ``--logfile``), then steps/sec, the component counts and
{"test_predictive_loglik_per_point", "train_cluster_purity"}. ``--device
cuda`` without a CUDA device raises; nothing falls back. Tensors are made
in torch's default dtype: float32 unless the caller changed it (the
kernels take float32 only).

``--dp`` is the reference's data-parallel step (experiments/train_gmm.py
:106-113): under ``torchrun`` each of the ``WORLD_SIZE`` ranks keeps its
contiguous slice of the batch, the statistics are summed over the ranks
(``models.gmm_baseline``, ``parallel.mesh``), and rank 0 alone evaluates
and prints. It runs the per-step engine, so it needs ``--engine plain``
(with or without ``--fused-kernel``); the mixstep kernel is single-device
and refused under it:

    torchrun --standalone --nproc-per-node 2 -m svax_torch.train_gmm \
        --config pinwheel-gmm --engine plain --device cpu --dp
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def add_common_flags(p: argparse.ArgumentParser) -> None:
    """Flags the GMM and SMM entries share."""
    p.add_argument("--num-components", "-K", type=int, default=10)
    p.add_argument("--num-classes", type=int, default=5, help="pinwheel arms")
    p.add_argument("--num-per-class", type=int, default=100)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--rho", type=float, default=1.0, help="CVI step size")
    p.add_argument("--alpha", type=float, default=1.0, help="Dirichlet prior")
    p.add_argument("--kappa", type=float, default=0.05, help="NIW prior scale")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=20)
    p.add_argument("--init", choices=["random", "kmeanspp"], default="random")
    p.add_argument("--unroll", type=int, default=1,
                   help="kernel engine: steps per loop trip in the mixstep "
                        "kernel, one of 1, 2, 4, 8, dividing every chunk")
    p.add_argument("--engine", choices=["kernel", "plain"], default="kernel")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")


def setup(args, x_train_np: np.ndarray, *, fused: bool = False):
    """Device, prior and initial naturals for either entry; checks the
    device, the engine and the unroll before anything runs."""
    from svax_torch.models import gmm_baseline
    from svax_torch.ops import mixstep
    from svax_torch.pgm import gmm
    from svax_torch.pgm.init import init_variational_kmeanspp

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")
    if args.engine == "kernel" and fused:
        raise ValueError("--fused-kernel selects the plain engine's E-step "
                         "(use --engine plain)")
    if args.engine == "kernel":
        last = args.steps % args.eval_every  # a short last chunk
        mixstep.check_unroll(args.unroll, args.eval_every, last or args.eval_every)
        reason = mixstep.unsupported_reason(
            data_dim=x_train_np.shape[1], batch_full=True, rho=args.rho,
            num_points=x_train_np.shape[0], num_components=args.num_components,
            data_parallel=getattr(args, "dp", False))
        if reason is not None:
            raise ValueError(f"--engine kernel: {reason}")
    elif args.unroll != 1:
        raise ValueError(f"--unroll {args.unroll} needs the kernel engine (the plain "
                         "engine runs one step at a time)")

    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.get_default_dtype()
    prior = gmm.make_prior(args.num_components, 2, alpha=args.alpha,
                           kappa=args.kappa, device=device, dtype=dtype)
    x_train = torch.tensor(x_train_np, dtype=dtype, device=device)
    if args.init == "kmeanspp":
        nat = init_variational_kmeanspp(prior, x_train_np, seed=args.seed)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        nat = gmm_baseline.init_state(gen, prior, x_train).nat
    if device.type == "cuda" and (args.engine == "kernel" or fused):
        from svax_torch.ops import _build

        _build.load()  # build outside the timed region
    return device, dtype, prior, x_train, nat


def main(argv: list[str] | None = None) -> dict:
    """Run the trainer; returns {"state", "rows", "steps_per_s", "counts",
    "test_predictive_loglik_per_point", "train_cluster_purity"}."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", choices=["pinwheel-gmm"], default="")
    add_common_flags(p)
    p.add_argument("--fused-kernel", action="store_true",
                   help="plain engine: the E-step through the estep kernel")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over the WORLD_SIZE ranks torchrun starts "
                        "(plain engine)")
    p.add_argument("--logfile", default="", help="append the JSON rows to this file")
    args = p.parse_args(argv)
    from svax_torch.configs import apply_config

    apply_config(args, p, sys.argv[1:] if argv is None else argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not args.dp:
        p.error(f"WORLD_SIZE={world}: more than one process needs --dp")
    if world == 1:
        return _train(args, None, 0)
    import torch.distributed as dist

    from svax_torch.parallel import mesh

    joined = not dist.is_initialized()
    args.device = str(mesh.init_distributed(args.device))
    try:
        return _train(args, mesh.make_data_mesh(), dist.get_rank())
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, dmesh, rank: int) -> dict:
    """The training run of ``main`` on this rank (``dmesh``: the data mesh
    when ``--dp`` runs on several ranks); rank 0 prints."""
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.models import evaluation, gmm_baseline
    from svax_torch.pgm import gmm
    from svax_torch.train.loop import make_mixture_runner, run_mixture
    from svax_torch.train.metrics import JsonlLogger

    train, test, train_labels, _ = load_pinwheel(
        num_classes=args.num_classes, num_per_class=args.num_per_class,
        seed=args.seed, return_labels=True)
    device, dtype, prior, x_train, nat = setup(args, train, fused=args.fused_kernel)
    x_test = torch.tensor(test, dtype=dtype, device=device)
    n = x_train.shape[0]
    state = gmm_baseline.GmmTrainState(nat=nat, step=0)
    world, x_mine = 1, x_train
    if dmesh is not None:
        world = dmesh.data
        if n % world:
            raise ValueError(f"--dp: N = {n} does not split over {world} ranks")
        x_mine = x_train[dmesh.data_idx * (n // world):(dmesh.data_idx + 1) * (n // world)]
    if rank == 0:
        print(f"device={device} n={n} K={args.num_components} engine={args.engine}"
              f"{' fused-kernel' if args.fused_kernel else ''} unroll={args.unroll}"
              f"{f' dp world_size={world}' if args.dp else ''}")

    rows = []
    logger = JsonlLogger((args.logfile or None) if rank == 0 else None, echo=rank == 0)

    def emit(t, st, elbo):
        if rank != 0:
            return
        ev = gmm_baseline.evaluate(st.nat, prior, x_test, num_total=n)
        rows.append(logger.log(t, elbo=elbo,
                               test_evidence_per_point=float(ev["evidence_per_point"])))

    if args.engine == "kernel":
        runner = make_mixture_runner(prior, rho=args.rho, unroll=args.unroll)
        kw = {"runner": runner}
    else:
        kw = {"step": gmm_baseline.make_train_step(
            prior, args.rho, num_total=n, fused=args.fused_kernel,
            data_group=None if dmesh is None else dmesh.data_group)}
    state, seconds = run_mixture(state, x_mine, steps=args.steps,
                                 eval_every=args.eval_every, emit=emit, **kw)
    rate = args.steps / seconds
    logger.close()
    if rank != 0:
        return {"state": state, "rows": rows, "steps_per_s": rate}
    resp, _ = gmm.e_step_obs(x_train, gmm.expected_params(state.nat))
    counts = resp.sum(0).cpu().numpy()
    print(f"steps/sec: {rate:.1f}")
    print(f"component counts: {np.round(counts, 1).tolist()}")
    final = {
        "test_predictive_loglik_per_point": float(
            evaluation.gmm_predictive_log_prob(state.nat, x_test).mean()),
        "train_cluster_purity": evaluation.cluster_purity(resp, train_labels),
    }
    print(json.dumps(final))
    return {"state": state, "rows": rows, "steps_per_s": rate, "counts": counts, **final}


if __name__ == "__main__":
    main()
