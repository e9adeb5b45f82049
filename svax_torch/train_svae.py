"""Train an SVAE with the port (PyTorch + the tinystep, flexstep, combine,
decoder_mlp and row-sum CUDA kernels).

    python -m svax_torch.train_svae [--config pinwheel-svae|auto-svae|mnist-svae|bigk-dp]
        [--dataset pinwheel|auto|mnist] [-K K] [-L L] [-S S]
        [--encoder-hidden W ...] [--decoder-hidden W ...] [--steps N]
        [--batch-size M] [--lr LR] [--aug-noise SIGMA] [--weight-decay WD]
        [--warmup-steps N] [--rho RHO] [--rho-decay DECAY] [--alpha A]
        [--kappa KAPPA] [--scan-chunk T] [--fused-combine] [--kernel-rng]
        [--device cuda|cpu] [--engine kernel|megakernel|plain] [--seed S]
        [--iw-samples S] [--encoder-head diag|full] [--recon-mode weighted|sampled]
        [--nn-precision highest|high|default] [--remat]
        [--[no-]fused-mlp-decoder] [--nn-compute-dtype float32|bfloat16]
        [--fused-decoder] [--remat-decoder] [--eval-every N] [--dp]
        [--smm-dof DOF [--smm-iters R] [--smm-envelope-grads]]
        [--checkpoint-dir DIR [--resume]] [--logfile PATH] [--debug-nans]
        [--bundle-dir DIR] [--[no-]graph]

Mirrors experiments/train_svae.py: the workload flags take the reference
entry's defaults (pinwheel, K = 10, latent d = 2, S = 4, 50-50, 2,000 full-
batch steps, Adam at 1e-3, constant ρ 0.05, no augmentation), and
``--config`` overlays a named config (``configs.apply_config``), a flag
typed on the command line winning over it. With the ``--engine kernel``
rule (``loop.choose_kernel``; the configs' engine "auto" is this rule)
every chunk of ``--scan-chunk`` steps (1000 when 0) runs as one launch of a
whole-train-step kernel where the workload fits one, else on the per-step
engine (``loop.make_step_runner``), and the first line says why.
``pinwheel-svae`` (full batch, d = 2, constant ρ) runs each chunk as one
launch of the tinystep kernel; ``auto-svae`` (minibatches of 64 drawn with
replacement, latent d = 4, ρ₀/(1 + decay·t)) as one launch of flexstep;
``mnist-svae`` (Bernoulli decoder with a bf16 body, latent d = 8, 200-200,
minibatches of 256) fits neither, so it runs on the per-step engine, each
step's SIN combine in the combine kernel with in-kernel ε
(``--fused-combine --kernel-rng``), after the config's ρ = 0 warmup and
k-means++ reseed (``train.warmup``). ``bigk-dp`` (K = 100, latent d = 10,
minibatches of 1024) runs the same way on one card, with the decoder in the
fused MLP decoder kernel (``fused_mlp_decoder``). A free-form workload
outside the kernels' classes (tinystep: d = 2, full batch, constant ρ,
K ≤ 32, matched hidden widths 16-16 or 50-50; flexstep: the GMM prior,
d_in ≤ 8, 2 ≤ d ≤ 6, two hidden layers a side of width ≤ 128, K ≤ 64) takes
the per-step engine the same way. ``--weight-decay WD`` trains the nets
with AdamW (the reference's ``optax.adamw(lr, weight_decay=WD)``; never the
PGM naturals), which neither kernel implements: such a run takes the
per-step engine with the reason ``loop.PLAIN_ADAM``. On the per-step
engine with ``--scan-chunk 0`` (the free-form default), as on the
data-parallel path, each step's minibatch is drawn without replacement and
a row follows step 1, every ``--eval-every`` steps and the last, as the
reference's per-step loop; with a chunk, minibatches are drawn with
replacement and a row follows every chunk. ``--aug-noise`` trains every
step on x + σ·ξ (in-kernel on tinystep, on the batch stack for flexstep,
``loop.augment_step`` on the per-step engine).
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

More than one process without ``--dp`` is refused.

``--nn-precision`` is the nets' product precision (``nets.mlp``'s table;
default "high"; pinwheel-svae and auto-svae ship "default"): "default"
runs tinystep and flexstep in their bf16-product mode
and the plain nets on bf16-rounded operands, "high" and "highest" in f32;
under ``--fused-decoder`` "high" and "default" run the row sum's
bf16-operand mode and "highest" its f32 mode. ``--encoder-head full``
trains the full-covariance recognition head, ``--recon-mode sampled`` the
sampled-component reconstruction estimator (S·N decoder rows a step
instead of S·N·K), and ``--remat`` recomputes the SIN combine in the
backward pass. Neither whole-step kernel takes a full head or sampled
reconstruction, nor does the fused combine (nor, under sampled, the fused
MLP decoder): such a run takes the per-step engine, and ``--engine
megakernel`` — a whole-step kernel or nothing — refuses it with both
kernels' reasons. ``--fused-mlp-decoder`` turns the decoder
kernel on for a Bernoulli workload (mnist-svae), and is refused for a
Gaussian one; ``--no-fused-mlp-decoder`` turns it off for bigk-dp.
``--nn-compute-dtype`` sets the decoder compute dtype (the
Bernoulli configs ship bfloat16). ``--fused-decoder`` (the reference's
``benchmarks/mfu.py`` flag) takes the f32 Bernoulli decoder's x-free row
sum from the row-sum kernels (``ops.decoder``), so the (rows, D) logits
never reach device memory; it is refused where it could not act: a
Gaussian likelihood, bf16 decoder compute, or the fused MLP decoder on
(which takes precedence). The big-K f32 path is

    python -m svax_torch.train_svae --config bigk-dp --nn-compute-dtype float32 \
        --no-fused-mlp-decoder --fused-decoder

``--remat-decoder`` recomputes the decoder in the backward pass
(``torch.utils.checkpoint``) instead of keeping its activations.
``--engine plain`` runs the plain PyTorch step instead (for the Bernoulli
configs: ``sin_combine``, ``torch.randn`` ε and the
decomposed decoder); on the CPU every kernel runs its plain version.
``--smm-dof DOF`` (> 0) trains the Student-t mixture prior
(``models.svae_smm``) with ``--smm-iters`` u–z rounds and, with
``--smm-envelope-grads``, q(u) held constant in the backward: pinwheel-svae
keeps tinystep (its SMM branch), the other configs run the per-step engine
(flexstep takes the GMM prior only), and as in the reference the SMM
forward runs the plain combine and decoder, so the first line reports
``fused_combine`` and ``fused_mlp_decoder`` off; the IW line is the SMM
bound (``evaluation.svae_smm_iw_loglik``).
Prints one JSON line with the config (null for a free-form run), the
engine, its reason, the world size and mesh (``world_size``, ``data``,
``comp``) and the initial test ELBO, the warmup
line, one JSON row per chunk — step, wall_s, elbo, recon,
local_kl, global_kl, test_elbo_per_point (``train.metrics.JsonlLogger``,
also appended to ``--logfile``) — then steps/sec, then
the importance-weighted test log-likelihood with ``--iw-samples`` samples
(0 = off).

``--checkpoint-dir`` saves the state (``train.checkpoint``) at every row
and after the last step; ``--resume`` restores the latest step there and
trains from it to ``--steps``, skipping the warmup when that step is past
0 (every runner keys its noise on the step, so a resumed run ends
bit-equal to an uninterrupted one). ``--bundle-dir`` writes a serving
bundle (``serve.save_bundle``) at the end. ``--debug-nans`` turns on
autograd's anomaly mode and checks the state and the row after every
chunk for NaN and infinity (``utils.guards``). ``--device cuda`` without a
CUDA device raises; nothing falls back. ``--plot PATH`` writes the latent
space of the training data after the last step (``utils.viz``: the
responsibility-weighted posterior means of a one-sample forward pass,
``svae_smm.forward`` for the SMM prior, with the components' ellipses);
it needs matplotlib, and raises an error naming it where matplotlib is
not installed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from svax_torch.utils import viz

SVAE_CONFIGS = ("pinwheel-svae", "auto-svae", "mnist-svae", "bigk-dp")


def add_workload_flags(p: argparse.ArgumentParser) -> None:
    """The reference entry's workload and architecture flags, with its
    defaults (experiments/train_svae.py:28-60); ``evaluate`` shares the
    architecture's."""
    p.add_argument("--config", default="", metavar="{" + ",".join(SVAE_CONFIGS) + "}",
                   help="overlay this named config; flags typed on the command line "
                        "win over it")
    p.add_argument("--dataset", choices=["pinwheel", "auto", "mnist"], default="pinwheel")
    p.add_argument("--num-components", "-K", type=int, default=10)
    p.add_argument("--latent-dim", "-L", type=int, default=2)
    p.add_argument("--num-samples", "-S", type=int, default=4)
    p.add_argument("--encoder-hidden", type=int, nargs="+", default=[50, 50])
    p.add_argument("--decoder-hidden", type=int, nargs="+", default=[50, 50])
    p.add_argument("--alpha", type=float, default=1.0, help="Dirichlet concentration")
    p.add_argument("--kappa", type=float, default=0.05, help="NIW mean precision")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--encoder-head", choices=["diag", "full"], default="diag",
                   help="recognition potential: diagonal, or a full per-point "
                        "precision (per-step engine)")
    p.add_argument("--recon-mode", choices=["weighted", "sampled"], default="weighted",
                   help="reconstruction estimator: every component's samples, or one "
                        "component drawn per sample with a REINFORCE term (per-step "
                        "engine)")
    p.add_argument("--nn-precision", choices=["highest", "high", "default"], default="high",
                   help="the nets' product precision: default = bf16-rounded operands "
                        "with f32 sums")
    p.add_argument("--nn-compute-dtype", choices=["float32", "bfloat16"], default="float32",
                   help="decoder compute dtype (bfloat16 runs the Bernoulli decoder body "
                        "in bf16 with f32 sums)")
    p.add_argument("--smm-dof", type=float, default=0.0,
                   help="Student-t mixture latent prior with this many degrees of "
                        "freedom (0 = Gaussian mixture prior)")
    p.add_argument("--smm-iters", type=int, default=2,
                   help="u-z coordinate rounds in the SMM combine")
    p.add_argument("--plot", default="", help="write the latent-space plot (PNG) here")


def apply_named_config(p: argparse.ArgumentParser, args, argv) -> None:
    """Overlay ``--config`` onto ``args`` (explicit flags win); refuses a
    name that is not an SVAE config."""
    from svax_torch.configs import apply_config

    if args.config and args.config not in SVAE_CONFIGS:
        p.error(f"--config {args.config}: not an SVAE config (one of "
                f"{', '.join(SVAE_CONFIGS)}; the pure mixtures train with "
                "svax_torch.train_gmm and svax_torch.train_smm; ROADMAP.md lists what "
                "the port runs)")
    apply_config(args, p, argv)


def parse_args(argv: list[str] | None = None):
    """(parser, args): the entry's flags parsed from ``argv`` (default
    ``sys.argv[1:]``) with ``--config`` overlaid, the configs' engine
    "auto" read as the kernel rule."""
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_workload_flags(p)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=0, help="0 = full batch")
    p.add_argument("--lr", type=float, default=1e-3, help="Adam lr for the nets")
    p.add_argument("--aug-noise", type=float, default=0.0,
                   help="input-noise augmentation: each step trains on x + sigma*N(0, I) "
                        "(0 = off)")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="AdamW decoupled weight decay on the nets (per-step engine)")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="rho = 0 warmup steps before the k-means++ reseed (0 = none)")
    p.add_argument("--rho", type=float, default=0.05, help="CVI step size")
    p.add_argument("--rho-decay", type=float, default=0.0,
                   help="rho_t = rho / (1 + decay * t)")
    p.add_argument("--scan-chunk", type=int, default=0,
                   help="steps a chunk (0: 1000 on a whole-step kernel; per-step rows "
                        "every --eval-every on the per-step engine)")
    p.add_argument("--fused-combine", action="store_true",
                   help="the SIN combine, local KL, sampling and statistics in the "
                        "combine kernel (per-step engine)")
    p.add_argument("--kernel-rng", action="store_true",
                   help="with --fused-combine: epsilon drawn inside the combine kernel")
    p.add_argument("--engine", choices=["kernel", "megakernel", "plain"], default="kernel",
                   help="kernel: the whole-step kernel that fits, else the per-step "
                        "engine with its kernels; megakernel: a whole-step kernel or a "
                        "refusal; plain: the plain PyTorch step")
    p.add_argument("--iw-samples", type=int, default=100,
                   help="importance-weighted final test log-lik samples (0 = off)")
    p.add_argument("--fused-mlp-decoder", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="the Bernoulli decoder in the fused MLP decoder kernel (on in "
                        "bigk-dp's config; refused for a Gaussian likelihood)")
    p.add_argument("--fused-decoder", action="store_true",
                   help="the f32 Bernoulli decoder's x-free row sum in the row-sum "
                        "kernels: the (rows, D) logits never reach device memory "
                        "(refused where it cannot act)")
    p.add_argument("--remat-decoder", action="store_true",
                   help="recompute the decoder in the backward pass instead of "
                        "storing its activations")
    p.add_argument("--eval-every", type=int, default=200,
                   help="per-step rows (data-parallel, or --scan-chunk 0 on the "
                        "per-step engine): after step 1, every N steps and the last")
    p.add_argument("--smm-envelope-grads", action="store_true",
                   help="envelope-theorem gradients for the SMM u-rounds: the "
                        "converged q(u) is held constant in the backward pass")
    p.add_argument("--remat", action="store_true",
                   help="recompute the SIN combine in the backward pass")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over the WORLD_SIZE ranks torchrun starts "
                        "(on in bigk-dp's config)")
    p.add_argument("--checkpoint-dir", default="",
                   help="save the state here at every row and after the last step")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint of --checkpoint-dir and train "
                        "on from it to --steps")
    p.add_argument("--logfile", default="", help="append the JSON rows to this file")
    p.add_argument("--debug-nans", action="store_true",
                   help="anomaly mode, and a finite check of the state and the row "
                        "after every chunk")
    p.add_argument("--graph", action=argparse.BooleanOptionalAction, default=True,
                   help="on CUDA, replay each chunk of the per-step engine as one "
                        "captured train step (a CUDA graph); --no-graph runs the eager "
                        "loop (graphed and eager are bit-equal)")
    p.add_argument("--bundle-dir", default="",
                   help="write a serving bundle here at the end of training "
                        "(svax_torch.serve.load_bundle restores it with no flags)")
    args = p.parse_args(argv)
    apply_named_config(p, args, argv)
    if args.engine == "auto":  # the configs' engine: the kernel rule
        args.engine = "kernel"
    return p, args


def main(argv: list[str] | None = None) -> dict:
    """Run the trainer; returns {"state", "rows", "steps_per_s", "kernel",
    "why", "init_test_elbo_per_point", "final_test_iw_loglik_per_point",
    "meta", "warmup", "x_test"}."""
    p, args = parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        p.error("--resume needs --checkpoint-dir")
    viz.check_available(args.plot)
    if args.eval_every < 1:
        p.error("--eval-every must be >= 1")
    if args.weight_decay < 0.0:
        p.error("--weight-decay must be >= 0")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")
    if args.debug_nans:
        from svax_torch.utils.guards import enable_nan_debugging

        enable_nan_debugging()

    from svax_torch.parallel import mesh

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not args.dp:
        p.error(f"WORLD_SIZE={world}: more than one process needs --dp")
    device = torch.device(args.device)
    data_group, rank, joined = None, 0, False
    if world > 1:
        import torch.distributed as dist

        joined = not dist.is_initialized()
        device = mesh.init_distributed(args.device)
        data_group, rank = mesh.make_data_mesh().data_group, dist.get_rank()
    try:
        return _train(args, p, device, world, data_group, rank)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, p, device, world, data_group, rank) -> dict:
    """The training run of ``main`` on this rank; rank 0 prints."""
    from svax_torch.data import load_dataset
    from svax_torch.models import evaluation
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import graph as cuda_graph
    from svax_torch.train import svae_step, warmup
    from svax_torch.train.checkpoint import Checkpointer
    from svax_torch.train.loop import (PER_STEP, choose_kernel, kernel_unsupported_reason,
                                       make_runner, make_step_runner)
    from svax_torch.train.metrics import JsonlLogger
    from svax_torch.utils import guards

    steps, warmup_steps, data_parallel = args.steps, args.warmup_steps, args.dp
    name = args.config or args.dataset

    def show(*a, **kw) -> None:
        if rank == 0:
            print(*a, **kw)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # A bf16 matmul may otherwise reduce split-K partial sums in bf16; the
    # reference accumulates its bf16 decoder products in f32.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    f32 = torch.float32

    train, test, meta = load_dataset(args.dataset, seed=args.seed)
    if args.fused_mlp_decoder and meta["likelihood"] != "bernoulli":
        p.error(f"--fused-mlp-decoder: the fused MLP decoder is a Bernoulli head, and "
                f"{name} has a {meta['likelihood']} likelihood")
    x_train = torch.tensor(train, dtype=f32, device=device)
    x_test = torch.tensor(test, dtype=f32, device=device)
    n, input_dim = x_train.shape
    batch = args.batch_size if 0 < args.batch_size < n else n
    if batch % world:  # experiments/train_svae.py:278-280
        batch = (batch // world) * world or world
        show(f"rounding batch to {batch} for {world} data ranks", flush=True)
    rho_decay = args.rho_decay
    engine = "kernel" if args.engine == "megakernel" else args.engine
    config = SvaeConfig(latent_dim=args.latent_dim,
                        num_components=args.num_components,
                        num_samples=args.num_samples, num_total=n,
                        likelihood=meta["likelihood"],
                        nn_compute_dtype=args.nn_compute_dtype,
                        fused_combine=args.fused_combine,
                        kernel_rng=args.kernel_rng,
                        fused_mlp_decoder=args.fused_mlp_decoder,
                        fused_decoder=args.fused_decoder,
                        remat_decoder=args.remat_decoder,
                        dof=args.smm_dof, smm_iters=args.smm_iters,
                        smm_envelope_grads=args.smm_envelope_grads,
                        nn_precision=args.nn_precision,
                        encoder_head=args.encoder_head, recon_mode=args.recon_mode,
                        remat_combine=args.remat)
    if config.dof > 0.0:
        # The SMM forward runs the plain combine and decoder (the reference's
        # svae_smm.forward): the fused switches do not act on it, but for the
        # row sum, which svae_smm takes under fused_decoder.
        if config.recon_mode != "weighted":
            p.error("--recon-mode sampled: the SMM-prior SVAE implements the weighted "
                    "estimator only")
        config = config._replace(fused_combine=False, kernel_rng=False,
                                 fused_mlp_decoder=False)
    if args.fused_decoder:
        # SvaeConfig's fused_decoder is a silent no-op where it cannot act, as
        # the reference's; the entry refuses it there.
        if config.likelihood != "bernoulli":
            p.error(f"--fused-decoder: the row sum is a Bernoulli head's, and "
                    f"{name} has a {config.likelihood} likelihood")
        if config.nn_compute_dtype != "float32":
            p.error(f"--fused-decoder: the row-sum kernels run an f32 decoder, and "
                    f"{name} computes it in {config.nn_compute_dtype} (add "
                    f"--nn-compute-dtype float32)")
        if config.fused_mlp_decoder:
            p.error(f"--fused-decoder: {name} runs the fused MLP decoder, which "
                    f"takes precedence (add --no-fused-mlp-decoder)")
    gate = dict(batch_full=batch >= n, encoder_hidden=args.encoder_hidden,
                decoder_hidden=args.decoder_hidden, rho=args.rho,
                rho_decay=rho_decay, likelihood=meta["likelihood"], input_dim=input_dim,
                data_parallel=data_parallel, weight_decay=args.weight_decay)
    if args.engine == "megakernel":
        try:
            choose_kernel(config, engine="megakernel", **gate)
        except ValueError as err:
            p.error(f"--engine megakernel: {err}")
    kernel = choose_kernel(config, engine="auto", **gate)
    why = kernel_unsupported_reason(config, **gate) if kernel == PER_STEP else None

    prior = gmm.make_prior(config.num_components, config.latent_dim,
                           alpha=args.alpha, kappa=args.kappa,
                           device=device, dtype=f32)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = svae_step.init_state(
        gen, input_dim, config, prior,
        encoder_hidden=tuple(args.encoder_hidden),
        decoder_hidden=tuple(args.decoder_hidden),
    )
    start, ckpt = 0, None
    if args.checkpoint_dir:
        ckpt = Checkpointer(args.checkpoint_dir)
        if args.resume:
            state, _, start = ckpt.restore_or(state)
    # The reference's per-step loop (data-parallel, or no scan chunk): a row
    # after step 1 and every eval_every, minibatches without replacement.
    per_step_rows = data_parallel or (kernel == PER_STEP and args.scan_chunk <= 0)
    if kernel == PER_STEP:
        runner = make_step_runner(config, prior, lr=args.lr, rho=args.rho,
                                  rho_decay=rho_decay, batch_size=batch, engine=engine,
                                  replace=not per_step_rows, data_group=data_group,
                                  aug_noise=args.aug_noise, weight_decay=args.weight_decay,
                                  graph=None if args.graph else False)
    else:
        runner = make_runner(config, prior, lr=args.lr, rho=args.rho,
                             rho_decay=rho_decay, batch_size=batch,
                             aug_noise=args.aug_noise, engine=engine, kernel=kernel)
    # The evaluation runs the training path's combine and decoder: on the
    # plain engine with fused_combine, fused_mlp_decoder and fused_decoder
    # off, on the kernel engine with the kernels and the in-kernel ε.
    eval_config = (config if engine == "kernel"
                   else config._replace(fused_combine=False, kernel_rng=False,
                                        fused_mlp_decoder=False, fused_decoder=False))
    evaluate = svae_step.make_eval_fn(eval_config, prior)
    if engine == "kernel" and device.type == "cuda":
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
    # The fused combine and the fused MLP decoder act on the weighted
    # estimator (the combine also needs the diagonal head and zero jitter,
    # the decoder tanh nets: models.svae.forward).
    weighted = config.recon_mode == "weighted"
    graphed = (cuda_graph.route(device, data_group is not None, None if args.graph else False)
               if kernel == PER_STEP else cuda_graph.KERNEL_CHUNK)
    show(json.dumps({"config": args.config or None, "kernel": kernel, "engine": args.engine,
                      "why": why, "graph": graphed, "fused_combine": kernel == PER_STEP and
                      engine == "kernel" and config.fused_combine and weighted
                      and config.encoder_head == "diag" and config.jitter == 0.0,
                      "fused_mlp_decoder": engine == "kernel" and weighted and
                      config.fused_mlp_decoder and config.likelihood == "bernoulli"
                      and config.activation == "tanh",
                      "fused_decoder": engine == "kernel" and config.fused_decoder,
                      "nn_precision": config.nn_precision,
                      "encoder_head": config.encoder_head, "recon_mode": config.recon_mode,
                      "remat_combine": config.remat_combine,
                      "nn_compute_dtype": config.nn_compute_dtype,
                      "remat_decoder": config.remat_decoder,
                      "prior": "smm" if config.dof > 0.0 else "gmm", "dof": config.dof,
                      "smm_iters": config.smm_iters,
                      "smm_envelope_grads": config.smm_envelope_grads,
                      "world_size": world, "data": world, "comp": 1,
                      "n": n, "d_in": input_dim, "batch": batch,
                      "synthetic": meta.get("synthetic", False),
                      "init_test_elbo_per_point": init_elbo}), flush=True)
    warm_info = None
    if warmup_steps > 0 and start == 0:  # on the per-step engine, whatever the main engine
        t_warm = time.perf_counter()
        state, warm_info = warmup.vae_warmup_reseed(
            state, x_train, config, prior, lr=args.lr, steps=warmup_steps,
            batch_size=batch, scan_chunk=args.scan_chunk or 100, seed=args.seed,
            engine=engine, graph=None if args.graph else False)
        warm_info["seconds"] = time.perf_counter() - t_warm
        show(f"warmup {warmup_steps} steps + k-means++ reseed "
              f"({warm_info['seconds']:.1f}s): seed occupancy "
              f"{warm_info['seed_occupancy']}, cov_scale {warm_info['cov_scale']:.4g}",
              flush=True)
    rows = []

    def emit(t, metrics):
        if rank != 0:
            return
        rows.append(logger.log(
            t, elbo=float(metrics["elbo"]), recon=float(metrics["recon"]),
            local_kl=float(metrics["local_kl"]), global_kl=float(metrics["global_kl"]),
            test_elbo_per_point=test_elbo()))
        if ckpt is not None:
            ckpt.save(t, state)

    chunk = args.scan_chunk or 1000
    logger = JsonlLogger((args.logfile or None) if rank == 0 else None, echo=rank == 0)
    t0 = time.perf_counter()
    t = start
    while t < steps:
        # The data-parallel loop's rows: after step 1, then every eval_every.
        todo = (min(1 if t == 0 else args.eval_every - t % args.eval_every, steps - t)
                if per_step_rows else min(chunk, steps - t))
        state, metrics = runner(state, x_train, todo, seed=args.seed)
        t += todo
        last = {k: v[-1] for k, v in metrics.items()}
        if guards.nan_debugging():
            guards.assert_finite(state, "state")
            guards.assert_finite(last, "metrics")
        emit(t, last)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rate = (steps - start) / (time.perf_counter() - t0)
    logger.close()
    show(f"steps/sec: {rate:.1f} (device={device}, engine={engine}, "
         f"kernel={kernel})")
    out = {"state": state, "rows": rows, "steps_per_s": rate, "kernel": kernel,
           "why": why, "init_test_elbo_per_point": init_elbo, "meta": meta,
           "warmup": warm_info, "x_test": x_test}
    if args.iw_samples > 0 and rank == 0:
        iw_gen = torch.Generator(device=device).manual_seed(args.seed + 2)
        iw_kw = dict(likelihood=config.likelihood, encoder_head=config.encoder_head,
                     jitter=config.jitter, activation=config.activation)
        if config.dof > 0.0:
            # The SMM bound, as experiments/evaluate.py and svax/serve.py
            # score an SMM model (the reference entry scores the GMM one).
            iw = evaluation.svae_smm_iw_loglik(
                state.nn_params, state.pgm_nat, x_test, args.iw_samples, dof=config.dof,
                smm_iters=config.smm_iters, generator=iw_gen, **iw_kw)
        else:
            iw = evaluation.svae_iw_loglik(state.nn_params, state.pgm_nat, x_test,
                                           args.iw_samples, generator=iw_gen, **iw_kw)
        out["final_test_iw_loglik_per_point"] = float(iw.mean())
        print(json.dumps({"final_test_iw_loglik_per_point": float(iw.mean()),
                          "iw_samples": args.iw_samples}), flush=True)
    if args.plot and rank == 0:
        z_mean, resp = viz.svae_latent(state, eval_config, prior, x_train,
                                       torch.Generator(device=device).manual_seed(args.seed))
        viz.plot_latent_space(z_mean, resp, state.pgm_nat, args.plot,
                              title=f"SVAE latent ({args.dataset})")
        show(f"wrote {args.plot}")
    if ckpt is not None and rank == 0:
        ckpt.save(steps, state)
    if args.bundle_dir and rank == 0:
        from svax_torch import serve

        serve.save_bundle(args.bundle_dir, state, serve.ModelSpec(
            input_dim=input_dim, latent_dim=config.latent_dim,
            num_components=config.num_components, likelihood=config.likelihood,
            encoder_hidden=tuple(args.encoder_hidden),
            decoder_hidden=tuple(args.decoder_hidden), num_samples=config.num_samples,
            alpha=args.alpha, kappa=args.kappa, dof=config.dof,
            smm_iters=config.smm_iters, activation=config.activation, num_total=n,
            encoder_head=config.encoder_head))
        show(f"wrote serving bundle to {args.bundle_dir}")
    return out


if __name__ == "__main__":
    main()
