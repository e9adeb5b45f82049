"""Train the pure-GMM baseline on pinwheel with the port (PyTorch + the
mixstep and estep CUDA kernels). BASELINE config #2.

    python -m svax_torch.train_gmm --config pinwheel-gmm [--init kmeanspp]
        [--device cuda|cpu] [--engine kernel|plain] [--fused-kernel]
        [--unroll U] [--eval-every E] [--steps N] [--seed S] [--dp]
        [--batch-size M] [--rho-decay D] [--logfile PATH] [--plot PATH]

Mirrors experiments/train_gmm.py. ``--batch-size M`` (0, the default, is
the full batch) trains each step on M distinct rows drawn afresh, as the
reference's ``choice(..., replace=False)``, from a ``torch.Generator`` on
the device seeded ``--seed + 1`` (``minibatch_step``); ``--rho-decay D``
steps with ρ_t = ρ/(1 + D·t). Both need the plain engine: the mixstep
kernel trains on the full batch with a constant ρ, and ``--engine kernel``
refuses either with its gate's reason.
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
cuda`` without a CUDA device raises; nothing falls back. ``--plot PATH``
writes the training data coloured by cluster with the components' ellipses
(``utils.viz.plot_gmm_clusters``; it needs matplotlib, which ``train_smm
--plot`` needs too). Tensors are made
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
from typing import Callable

import numpy as np
import torch

from svax_torch.utils import viz


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
    p.add_argument("--plot", default="", help="write the cluster plot (PNG) here")
    p.add_argument("--graph", action=argparse.BooleanOptionalAction, default=True,
                   help="plain engine on CUDA: replay the steps between two rows as one "
                        "captured step (a CUDA graph); --no-graph runs them eagerly "
                        "(bit-equal)")


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
        from svax_torch.train.svae_step import rho_schedule

        last = args.steps % args.eval_every  # a short last chunk
        mixstep.check_unroll(args.unroll, args.eval_every, last or args.eval_every)
        batch = getattr(args, "batch_size", 0)
        reason = mixstep.unsupported_reason(
            data_dim=x_train_np.shape[1],
            batch_full=not 0 < batch < x_train_np.shape[0],
            rho=rho_schedule(args.rho, getattr(args, "rho_decay", 0.0)),
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
    p.add_argument("--batch-size", type=int, default=0,
                   help="rows a step, drawn without replacement (0 = full batch; "
                        "plain engine)")
    p.add_argument("--rho-decay", type=float, default=0.0,
                   help="rho_t = rho / (1 + decay * t) (plain engine)")
    p.add_argument("--logfile", default="", help="append the JSON rows to this file")
    args = p.parse_args(argv)
    from svax_torch.configs import apply_config

    apply_config(args, p, sys.argv[1:] if argv is None else argv)
    viz.check_available(args.plot)
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


def minibatch_step(step: Callable, x: torch.Tensor, batch: int,
                   generator: torch.Generator | None = None, *, part: slice = slice(None),
                   indices=None) -> Callable:
    """``step(state, batch)`` as ``fn(state, _) → step(state, x[idx][part])``:
    each call trains on ``batch`` distinct rows of ``x``, drawn from
    ``generator`` (``loop.minibatch_indices`` without replacement) or taken
    in turn from ``indices`` (an injected (T, M) stack); ``part`` is this
    rank's slice of the batch under ``--dp``. The second argument, the data
    ``run_mixture`` passes, is ignored."""
    from svax_torch.train.loop import minibatch_indices

    stack = None if indices is None else iter(indices)

    def fn(state, _unused=None):
        idx = (next(stack) if stack is not None
               else minibatch_indices(generator, x.shape[0], batch, 1, replace=False)[0])
        return step(state, x[torch.as_tensor(idx, device=x.device)][part])

    return fn


def _train(args, dmesh, rank: int) -> dict:
    """The training run of ``main`` on this rank (``dmesh``: the data mesh
    when ``--dp`` runs on several ranks); rank 0 prints."""
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.models import evaluation, gmm_baseline
    from svax_torch.pgm import gmm
    from svax_torch.train import graph as cuda_graph
    from svax_torch.train.loop import make_mixture_runner, run_mixture
    from svax_torch.train.metrics import JsonlLogger

    train, test, train_labels, _ = load_pinwheel(
        num_classes=args.num_classes, num_per_class=args.num_per_class,
        seed=args.seed, return_labels=True)
    device, dtype, prior, x_train, nat = setup(args, train, fused=args.fused_kernel)
    x_test = torch.tensor(test, dtype=dtype, device=device)
    n = x_train.shape[0]
    state = gmm_baseline.GmmTrainState(nat=nat, step=0)
    batch = args.batch_size if 0 < args.batch_size < n else n
    world, x_mine, mine = 1, x_train, slice(None)
    if dmesh is not None:
        world = dmesh.data
        if batch % world:
            raise ValueError(f"--dp: a batch of {batch} does not split over {world} ranks")
        mine = slice(dmesh.data_idx * (batch // world), (dmesh.data_idx + 1) * (batch // world))
        x_mine = x_train[mine] if batch == n else x_train
    graph = (cuda_graph.route(device, dmesh is not None, None if args.graph else False)
             if args.engine == "plain" else cuda_graph.KERNEL_CHUNK)
    if rank == 0:
        print(f"device={device} n={n} batch={batch} K={args.num_components} "
              f"engine={args.engine}{' fused-kernel' if args.fused_kernel else ''} "
              f"unroll={args.unroll}{f' dp world_size={world}' if args.dp else ''} "
              f"graph={graph}")

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
        from svax_torch.train.svae_step import rho_schedule

        step = gmm_baseline.make_train_step(
            prior, rho_schedule(args.rho, args.rho_decay), num_total=n,
            fused=args.fused_kernel, data_group=None if dmesh is None else dmesh.data_group)
        gen = None
        if batch < n:
            gen = torch.Generator(device=device).manual_seed(args.seed + 1)
            step = minibatch_step(step, x_train, batch, gen, part=mine)
        kw = {"step": step, "generator": gen,
              "graph": False if dmesh is not None or not args.graph else None}
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
    if args.plot:
        viz.plot_gmm_clusters(x_train, resp, state.nat, args.plot,
                              title=f"pinwheel GMM K={args.num_components}")
        print(f"wrote {args.plot}")
    return {"state": state, "rows": rows, "steps_per_s": rate, "counts": counts, **final}


if __name__ == "__main__":
    main()
