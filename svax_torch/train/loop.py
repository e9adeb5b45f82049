"""Training loops (``svax/train/loop.py``, the SVAE and pure-mixture
subset).

``augment_step`` wraps a step with input-noise augmentation;
``choose_kernel`` is the gate between the two whole-train-step kernels
and, with ``engine="auto"``, the per-step engine (the reference's
``megakernel_unsupported_reason`` and its entry's auto rule);
``make_runner`` is the chunk runner that drives T steps per call through
the tinystep kernel (full batch) or the flexstep kernel (a minibatch
stack), or their plain versions, taking the place of the reference's
``make_scan_runner`` and ``make_megakernel_runner``; ``make_step_runner``
runs T calls of the per-step train step over a minibatch stack (the
reference's ``make_minibatch_scan_runner``), the combine kernel inside
when ``fused_combine`` is set, and ``make_batch_runner`` does the same for
the steps of the pure mixtures and the plain VAE; ``make_mixture_runner``
runs the GMM/SMM through the mixstep kernel (the reference's
``make_mixture_megakernel_runner``); ``train_chosen`` trains on whichever
SVAE runner ``choose_kernel`` picks (the demos' rule).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from svax_torch.models.svae import check_recon_mode
from svax_torch.ops import flexstep, mixstep, tinystep
from svax_torch.parallel import mesh
from svax_torch.pgm import gmm
from svax_torch.train import graph as cuda_graph
from svax_torch.train import svae_step

PER_STEP = "per-step"
# make_step_runner's / make_batch_runner's graph="body": the captured step
# run T times a chunk without a graph (the CPU tests' check on a replay).
BODY = "body"
FLEXSTEP_GMM_ONLY = ("the flexstep kernel implements the GMM prior only "
                     "(dof > 0 is the Student-t mixture prior)")
SINGLE_DEVICE = "the whole-train-step kernels are single-device (no data/component sharding)"
PLAIN_ADAM = "the whole-train-step kernels implement plain Adam only (no weight decay)"
FULL_HEAD = ("the whole-train-step kernels implement the diagonal recognition head only "
             "(encoder_head='diag'); the full head runs on the per-step engine")


def _switches_reason(config, kernel: str) -> str | None:
    """Why ``kernel`` cannot run ``config``'s switches (None = it can): both
    whole-step kernels train the weighted estimator, the diagonal head, zero
    jitter and tanh nets (tinystep_pallas.py:838-852, flexstep_pallas.py:
    573-585; the reference's tinystep gate omits the activation, yet its
    _mlp3 is tanh only)."""
    if config.recon_mode != "weighted":
        return f"the {kernel} kernel needs recon_mode='weighted' (got {config.recon_mode!r})"
    if config.encoder_head != "diag":
        return f"the {kernel} kernel needs encoder_head='diag' (got {config.encoder_head!r})"
    if config.jitter != 0.0:
        return f"the {kernel} kernel needs jitter = 0 (got {config.jitter})"
    if config.activation != "tanh":
        return f"the {kernel} kernel needs tanh nets (got {config.activation!r})"
    return None



def augment_step(step: Callable, sigma: float) -> Callable:
    """Wrap ``step(state, xb, eps=None, generator=None)`` with input-noise
    augmentation: the step trains on ``xb + sigma·ξ``, so the noise perturbs
    both the encoder input and the reconstruction target. ξ is ``aug_eps``
    when given, else drawn from ``generator`` BEFORE the step draws its ε
    (the reference's split-first key discipline). ``sigma <= 0`` returns
    ``step`` unchanged."""
    if sigma <= 0.0:
        return step

    def wrapped(state, xb, eps=None, aug_eps=None, generator=None, **kw):
        if aug_eps is None:
            aug_eps = torch.randn(xb.shape, generator=generator,
                                  device=xb.device, dtype=xb.dtype)
        return step(state, xb + sigma * aug_eps, eps=eps, generator=generator, **kw)

    return wrapped


def tinystep_unsupported_reason(config, *, batch_full: bool, encoder_hidden,
                                decoder_hidden, rho, rho_decay: float = 0.0,
                                likelihood: str = "gaussian") -> str | None:
    """Why the tinystep kernel cannot run this workload (None = it can).

    The shape class: latent d = 2, Gaussian likelihood, two matched
    hidden layers of a width the kernel is built for, full batch,
    constant ρ, K up to tinystep.MAX_COMPONENTS; the GMM or the SMM prior
    (``config.dof``); weighted reconstruction, the diagonal head, zero
    jitter and tanh nets (``_switches_reason``)."""
    encoder_hidden, decoder_hidden = tuple(encoder_hidden), tuple(decoder_hidden)
    switches = _switches_reason(config, "tinystep")
    if switches is not None:
        return switches
    if config.latent_dim != 2:
        return f"the tinystep kernel needs latent d = 2 (got {config.latent_dim})"
    if likelihood != "gaussian":
        return f"the tinystep kernel needs a Gaussian likelihood (got {likelihood})"
    if encoder_hidden != decoder_hidden or encoder_hidden not in tinystep.SUPPORTED_HIDDEN:
        return (f"the tinystep kernel needs matched hidden widths in "
                f"{tinystep.SUPPORTED_HIDDEN} (got {encoder_hidden} / "
                f"{decoder_hidden})")
    if not batch_full:
        return "the tinystep kernel trains on the full batch only"
    if callable(rho) or rho_decay != 0.0:
        return "the tinystep kernel needs a constant rho"
    if not 1 <= config.num_components <= tinystep.MAX_COMPONENTS:
        return f"the tinystep kernel takes K <= {tinystep.MAX_COMPONENTS}"
    return None


def flexstep_unsupported_reason(config, *, input_dim: int, encoder_hidden,
                                decoder_hidden, rho, likelihood: str = "gaussian"
                                ) -> str | None:
    """Why the flexstep kernel cannot run this workload (None = it can).

    The shape class (flexstep_pallas.supported): the GMM prior, Gaussian
    likelihood, two tanh hidden layers a side of width
    1..flexstep.MAX_HIDDEN, d_in ≤ 8, 2 ≤ d ≤ 6, K up to
    flexstep.MAX_COMPONENTS, a constant ρ or the Trainer's ρ₀/(1 + decay·t)
    (given as ``rho_decay``, not a callable); minibatch or full batch;
    weighted reconstruction, the diagonal head, zero jitter
    (``_switches_reason``)."""
    widths = tuple(encoder_hidden) + tuple(decoder_hidden)
    switches = _switches_reason(config, "flexstep")
    if switches is not None:
        return switches
    if config.dof > 0.0:
        # tinystep owns the Student-t prior's u–z rounds; flexstep does not
        # (svax/train/loop.py:129-141).
        return FLEXSTEP_GMM_ONLY
    if config.latent_dim not in flexstep.LATENT_DIMS:
        return (f"the flexstep kernel needs 2 <= latent d <= 6 "
                f"(got {config.latent_dim})")
    if not 1 <= input_dim <= flexstep.MAX_INPUT:
        return (f"the flexstep kernel needs 1 <= d_in <= {flexstep.MAX_INPUT} "
                f"(got {input_dim})")
    if likelihood != "gaussian":
        return f"the flexstep kernel needs a Gaussian likelihood (got {likelihood})"
    if len(encoder_hidden) != 2 or len(decoder_hidden) != 2:
        return (f"the flexstep kernel needs two hidden layers a side (got "
                f"{tuple(encoder_hidden)} / {tuple(decoder_hidden)})")
    if not all(1 <= w <= flexstep.MAX_HIDDEN for w in widths):
        return f"the flexstep kernel takes hidden widths 1..{flexstep.MAX_HIDDEN}"
    if callable(rho):
        return "the flexstep kernel takes rho as a float and its decay as rho_decay"
    if not 1 <= config.num_components <= flexstep.MAX_COMPONENTS:
        return f"the flexstep kernel takes K <= {flexstep.MAX_COMPONENTS}"
    return None


def choose_kernel(config, *, batch_full: bool, encoder_hidden, decoder_hidden,
                  rho, rho_decay: float = 0.0, likelihood: str = "gaussian",
                  input_dim: int = 0, engine: str = "megakernel",
                  data_parallel: bool = False, weight_decay: float = 0.0) -> str:
    """The whole-train-step kernel for this workload, as the reference's
    ``make_megakernel_runner`` picks it (svax/train/loop.py:218-232):
    "tinystep" for full-batch d = 2 constant-ρ work in its shape class, else
    "flexstep". When neither fits, ``engine="megakernel"`` raises with both
    kernels' reasons and ``engine="auto"`` returns ``PER_STEP``, the
    per-step engine (the reference entry's auto rule,
    experiments/train_svae.py:251-271): a choice by shape, made before any
    kernel runs. Under data sharding neither kernel runs (``SINGLE_DEVICE``),
    nor with AdamW's ``weight_decay`` > 0 (``PLAIN_ADAM``): the reference's
    first two checks, in its order (svax/train/loop.py:115-118). A Bernoulli likelihood fits neither kernel
    (both train a Gaussian decoder), so the Bernoulli decoder's switches
    (``fused_mlp_decoder``, ``fused_decoder``, ``remat_decoder``) always
    run on the per-step engine."""
    if engine not in ("megakernel", "auto"):
        raise ValueError(f"unknown engine {engine!r} (megakernel|auto)")
    if data_parallel:
        if engine == "auto":
            return PER_STEP
        raise ValueError(SINGLE_DEVICE)
    if weight_decay > 0.0:
        if engine == "auto":
            return PER_STEP
        raise ValueError(PLAIN_ADAM)
    kw = dict(encoder_hidden=encoder_hidden, decoder_hidden=decoder_hidden, rho=rho,
              likelihood=likelihood)
    tiny = tinystep_unsupported_reason(config, batch_full=batch_full,
                                       rho_decay=rho_decay, **kw)
    if tiny is None:
        return "tinystep"
    flex = (flexstep_unsupported_reason(config, input_dim=input_dim, **kw)
            if input_dim > 0 else "the flexstep kernel needs the data width d_in")
    if flex is None:
        return "flexstep"
    if engine == "auto":
        return PER_STEP
    raise ValueError(f"fits neither kernel: {tiny}; {flex}")


def kernel_unsupported_reason(config, **kw) -> str | None:
    """Why no whole-train-step kernel can run this workload (None = one can);
    the arguments of ``choose_kernel``."""
    try:
        choose_kernel(config, **kw)
    except ValueError as err:
        return str(err)
    return None


def make_runner(config, prior, *, lr: float, rho: float, rho_decay: float = 0.0,
                batch_size: int = 0, aug_noise: float = 0.0, engine: str = "kernel",
                kernel: str = "tinystep") -> Callable:
    """Chunk runner ``runner(state, x, t_steps, seed, eps=None,
    aug_eps=None) → (state, metrics)``: T steps per call.

    ``kernel="tinystep"`` (``choose_kernel`` picks it) trains on the full
    batch through ``tinystep.train_chunk``. ``kernel="flexstep"`` draws the
    (T, M, d_in) minibatch stack first — indices with replacement, then the
    augmentation noise, then the seed of the chunk's ε, all from one
    ``torch.Generator`` on x's device keyed ``seed + state.step`` (the
    reference's fold_in(seed, step) → split discipline, ``loop.py:286-303``)
    — and runs ``flexstep.train_chunk``; ``batch_size`` 0 or ≥ N is the full
    batch. Either kernel runs its CUDA kernel on CUDA tensors and its plain
    version on CPU tensors; ``engine="plain"`` runs the plain version on any
    device. ``eps`` injects the ε noise, ``aug_eps`` tinystep's augmentation
    noise (flexstep: ``eps`` only). tinystep takes ``config``'s ``dof``,
    ``smm_iters`` and ``smm_envelope_grads`` (the SMM prior when dof > 0);
    flexstep refuses dof > 0. Both take ``config.nn_precision``: "default"
    is their bf16-product mode, anything else f32, as the reference maps it
    where Mosaic has no HIGH (svax/train/loop.py:209-215). A full
    recognition head is refused (svax/train/loop.py:200-206):
    ``choose_kernel`` gates the rest.

    Metrics are (T,) tensors: recon, local_kl, global_kl, elbo, rho. The
    global KL is evaluated once, at the post-chunk naturals, and broadcast,
    so ``elbo`` is exact on the last row and one chunk stale in its global
    term on earlier rows.
    """
    if engine not in ("kernel", "plain"):
        raise ValueError(f"unknown engine {engine!r} (kernel|plain)")
    if kernel not in ("tinystep", "flexstep"):
        raise ValueError(f"unknown kernel {kernel!r} (tinystep|flexstep)")
    if config.encoder_head != "diag":
        raise ValueError(FULL_HEAD)
    precision = config.nn_precision

    def finish(state, mets, t_steps):
        gkl = gmm.kl_global(state.pgm_nat, prior)
        mets = dict(mets)
        mets["global_kl"] = gkl.expand(t_steps)
        mets["elbo"] = mets["recon"] - mets["local_kl"] - mets["global_kl"]
        mets.setdefault("rho", torch.full((t_steps,), rho, device=gkl.device))
        del mets["neg_loss"]
        return state, mets

    if kernel == "tinystep":
        if rho_decay != 0.0:
            raise ValueError("the tinystep kernel needs a constant rho")
        chunk = tinystep.train_chunk if engine == "kernel" else tinystep.train_chunk_plain
        smm = dict(dof=config.dof, smm_iters=config.smm_iters,
                   smm_envelope_grads=config.smm_envelope_grads)

        def runner(state, x, t_steps: int, seed: int = 0, eps=None, aug_eps=None):
            state, mets = chunk(
                state, prior, x, lr=lr, rho=rho, t_steps=t_steps, seed=seed,
                aug_noise=aug_noise, num_samples=config.num_samples, eps=eps,
                aug_eps=aug_eps, nn_precision=precision, **smm,
            )
            return finish(state, mets, t_steps)

        return runner

    if config.dof > 0.0:
        raise ValueError(FLEXSTEP_GMM_ONLY)

    def runner(state, x, t_steps: int, seed: int = 0, eps=None, aug_eps=None):
        if aug_eps is not None:
            raise ValueError("flexstep draws its augmentation noise on the batch "
                             "stack; aug_eps is tinystep's")
        n = x.shape[0]
        m = min(batch_size or n, n)
        gen = torch.Generator(device=x.device).manual_seed(seed + state.step)
        if m >= n:
            batches = x.expand((t_steps,) + tuple(x.shape)).contiguous()
        else:
            idx = torch.randint(0, n, (t_steps, m), generator=gen, device=x.device)
            batches = x[idx]
        if aug_noise > 0.0:
            batches = batches + aug_noise * torch.randn(
                batches.shape, generator=gen, device=x.device, dtype=batches.dtype)
        chunk_seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=x.device))
        kw = dict(lr=lr, rho=rho, rho_decay=rho_decay, num_total=n,
                  num_samples=config.num_samples, seed=chunk_seed, eps=eps,
                  nn_precision=precision)
        if engine == "kernel":
            state, mets = flexstep.train_chunk(state, prior, batches, **kw)
        else:
            state, mets = flexstep.train_chunk_plain(state, prior, batches, **kw)
        return finish(state, mets, t_steps)

    return runner


def train_chosen(state, config, prior, x: torch.Tensor, steps: int, *, lr: float, rho: float,
                 hidden=(50, 50), batch_size: int = 0, aug_noise: float = 0.0, seed: int = 0,
                 chunk: int = 1000):
    """Train ``steps`` steps on the engine ``choose_kernel(engine="auto")``
    picks for this workload (matched ``hidden`` widths, constant ``rho``):
    ``make_runner`` on tinystep or flexstep, else ``make_step_runner`` (the
    per-step engine, minibatches drawn with replacement), in chunks of
    ``chunk`` steps, each chunk's noise keyed ``seed + state.step``.
    Returns (state, the last chunk's metrics, the kernel or ``PER_STEP``)."""
    n = x.shape[0]
    batch = batch_size if 0 < batch_size < n else 0
    kernel = choose_kernel(config, engine="auto", batch_full=batch == 0,
                           encoder_hidden=hidden, decoder_hidden=hidden, rho=rho,
                           likelihood=config.likelihood, input_dim=int(x.shape[1]))
    kw = dict(lr=lr, rho=rho, batch_size=batch, aug_noise=aug_noise)
    if kernel == PER_STEP:
        runner = make_step_runner(config, prior, **kw)
    else:
        runner = make_runner(config, prior, kernel=kernel, **kw)
    mets, done = None, 0
    while done < steps:
        todo = min(chunk, steps - done)
        state, mets = runner(state, x, todo, seed=seed)
        done += todo
    return state, mets, kernel


def minibatch_indices(gen: torch.Generator, n: int, m: int, t_steps: int,
                      replace: bool = True) -> torch.Tensor:
    """A (T, M) stack of minibatch indices into N rows from ``gen`` (on its
    device): uniform with replacement, or each row M distinct indices (the
    first M of a random permutation: an argsort of uniform keys)."""
    if replace:
        return torch.randint(0, n, (t_steps, m), generator=gen, device=gen.device)
    keys = torch.rand((t_steps, n), generator=gen, device=gen.device)
    return torch.argsort(keys, dim=1, stable=True)[:, :m]


def _graph_engine(graph, sharded: bool):
    """The runner's ``graph.ChunkGraph`` for its ``graph`` argument, or None
    for the eager loop: None (the default) is a graph on CUDA tensors of an
    unsharded step, ``BODY`` the captured callable run without a graph,
    False the eager loop. Returns a function of x's device."""
    if graph not in (None, False, BODY):
        raise ValueError(f"unknown graph {graph!r} (None|False|{BODY!r})")
    engines: dict = {}

    def engine(device) -> cuda_graph.ChunkGraph | None:
        if graph is False:
            return None
        replay = graph is None
        if replay and cuda_graph.route(device, sharded) != cuda_graph.GRAPHED:
            return None
        key = str(device)
        if key not in engines:
            engines[key] = cuda_graph.ChunkGraph(graphed=replay)
        return engines[key]

    return engine


def _x_key(x: torch.Tensor) -> tuple:
    """What a graph froze of the data it indexes: its storage and layout."""
    return (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)


def _generator(eng, device, seed: int) -> torch.Generator:
    """The chunk's generator keyed ``seed``: a fresh one on the eager loop,
    the graph's own (re-seeded: a graph replays the draws of the generator
    it registered) on a graphed one."""
    if eng is None:
        return torch.Generator(device=device).manual_seed(seed)
    if getattr(eng, "generator", None) is None:
        eng.generator = torch.Generator(device=device)
    return eng.generator.manual_seed(seed)


def make_batch_runner(step: Callable, *, batch_size: int = 0, seed: int = 0,
                      replace: bool = True, data_group=None,
                      noise: bool = False, graph: bool | str | None = None) -> Callable:
    """Chunk runner ``runner(state, x, t_steps) → (state, metrics)`` for a
    step that is not the SVAE's (the pure mixtures', the plain VAE's): T
    calls of ``step(state, batch)`` over the full batch or a (T, M) index
    stack from ``minibatch_indices`` (with or without replacement), drawn
    from a ``torch.Generator`` on x's device keyed ``seed + state.step``, so
    a resumed chunk draws what the uninterrupted run drew. ``noise=True``
    passes that generator on, ``step(state, batch, generator)``, for the
    step's own draws after the indices; under ``data_group`` each rank keeps
    its contiguous slice of every batch and, with ``noise``, draws from its
    own generator (one number more from the shared one, folded with the
    rank's place, ``mesh.fold_seed``). Metrics are each step's, stacked to
    (T,) tensors.

    On CUDA tensors of an unsharded step the chunk replays one captured
    step as a CUDA graph (``graph.ChunkGraph``; ``graph`` as
    ``make_step_runner``'s), equal to the eager loop bit for bit; the
    runner's ``engine(device)`` is its graph engine (None: eager)."""
    ndata, data_idx = mesh.size(data_group), mesh.index(data_group)
    engine = _graph_engine(graph, data_group is not None)

    def runner(state, x, t_steps: int):
        n = x.shape[0]
        m = min(batch_size or n, n)
        eng = engine(x.device)
        gen = _generator(eng, x.device, seed + state.step)
        idx = minibatch_indices(gen, n, m, t_steps, replace) if m < n else None
        if eng is not None:
            def call(st, rows, g, word):
                xb = x if idx is None else x.index_select(0, rows["idx"])
                return step(st, xb, *((g,) if noise else ()))

            return eng.run(state, t_steps, {"idx": idx}, call, generator=gen,
                           key=(*_x_key(x), m))
        if noise and data_group is not None:
            gen = torch.Generator(device=x.device).manual_seed(mesh.fold_seed(
                int(torch.randint(0, 2**62, (1,), generator=gen, device=x.device)),
                data_idx))
        mine = slice(data_idx * (m // ndata), (data_idx + 1) * (m // ndata))
        extra = (gen,) if noise else ()
        rows = []
        for t in range(t_steps):
            xb = x if idx is None else x[idx[t]]
            state, mets = step(state, xb[mine], *extra)
            rows.append(mets)
        return state, {name: torch.stack([r[name] for r in rows]) for name in rows[0]}

    runner.engine = engine
    return runner


def make_step_runner(config, prior, *, lr: float, rho: float, rho_decay: float = 0.0,
                     batch_size: int = 0, engine: str = "kernel",
                     replace: bool = True, data_group=None, comp_group=None,
                     aug_noise: float = 0.0, weight_decay: float = 0.0,
                     graph: bool | str | None = None) -> Callable:
    """Chunk runner ``runner(state, x, t_steps, seed=0, eps=None) → (state,
    metrics)`` on the per-step engine: T calls of
    ``svae_step.make_train_step`` (ρ_t = ρ₀/(1 + decay·t) at the pre-update
    step, or ``rho(step)`` for a callable ``rho``) over a (T, M) index stack drawn with replacement (the reference's
    scan runner and warmup), or, with ``replace=False``, each step's M
    indices distinct (the reference's data-parallel loop,
    ``jax.random.choice(..., replace=False)``): the first M of a random
    permutation per step.

    One ``torch.Generator`` on x's device keyed ``seed + state.step`` draws
    the index stack, then the chunk's seed, then (plain engine) every
    step's ε (the reference's fold_in/split discipline, as ``make_runner``'s
    flexstep branch). ``engine="kernel"`` keeps ``config``'s fused_combine
    and kernel_rng: the combine kernel runs inside each step and draws ε
    from Philox keyed (chunk seed, state.step), one host read of the seed
    per chunk. ``engine="plain"`` turns both off: ``sin_combine`` and
    ``torch.randn`` ε, the reference's path with fused_combine off; it turns
    fused_mlp_decoder and fused_decoder off with them (the bf16 or f32
    decomposed decoder, its row sum unfused). Either engine carries
    ``remat_decoder`` as it is.
    ``batch_size`` 0 or ≥ N is the full batch; ``eps`` (T, S, M, K, d)
    injects the noise. With ``config.dof`` > 0 the step is the Student-t
    prior's (``svae_step.model_for``), whose forward runs no kernel.

    Metrics are (T,) tensors of each step's elbo, recon, local_kl,
    global_kl (at its pre-update naturals), neg_loss and rho.

    Sharded (``data_group``, ``comp_group``: ``parallel.mesh``): ``prior``
    and the state's naturals are this rank's K-shard under ``comp_group``;
    every rank draws the same global indices from the shared generator and
    keeps its contiguous slice of each minibatch along ``data_group`` (the
    reference's ``P("data")``), so the global batch must divide by the data
    size; then one number more from the shared generator, folded with the
    rank's (data, comp) place (``mesh.fold_seed``), seeds the rank's own
    generator for ε and the chunk seed, so the ranks' noise differs. ``eps``
    is then this rank's (T, S, M / data, K_shard, d). ``aug_noise`` > 0
    wraps the step in ``augment_step``: each step's batch noise comes from
    the generator before the step's own draws. ``weight_decay`` > 0 trains
    the nets with AdamW (``svae_step.make_train_step``).

    The reference compiles the T steps into one jitted scan; here, on CUDA
    tensors of an unsharded step, the chunk replays one captured train
    step as a CUDA graph (``graph.ChunkGraph``): the index stack, injected
    ε, Adam's bias corrections, a scheduled ρ_t and the combine's Philox
    word {chunk seed, step} are device buffers the captured step reads at
    its row, and the generator the step draws from is registered with the
    graph, so a graphed chunk equals the eager loop bit for bit. CPU
    tensors and a sharded step (its all-reduces are host calls) run the
    eager loop; ``graph=False`` asks for it on the card, and
    ``graph=BODY`` runs the captured callable T times without a graph (the
    CPU tests' check). A capture or replay that fails raises. The runner's
    ``engine(device)`` is its graph engine (None: eager)."""
    if engine not in ("kernel", "plain"):
        raise ValueError(f"unknown engine {engine!r} (kernel|plain)")
    check_recon_mode(config, comp_group)
    if engine == "plain":
        config = config._replace(fused_combine=False, kernel_rng=False,
                                 fused_mlp_decoder=False, fused_decoder=False)
    use_seed = config.fused_combine and config.kernel_rng
    schedule = rho if callable(rho) else svae_step.rho_schedule(rho, rho_decay)
    step = augment_step(svae_step.make_train_step(config, prior, lr, schedule,
                                                  data_group=data_group,
                                                  comp_group=comp_group,
                                                  weight_decay=weight_decay), aug_noise)
    sharded = data_group is not None or comp_group is not None
    ndata, data_idx = mesh.size(data_group), mesh.index(data_group)
    engine = _graph_engine(graph, sharded)

    def runner(state, x, t_steps: int, seed: int = 0, eps=None):
        n = x.shape[0]
        m = min(batch_size or n, n)
        if m % ndata:
            raise ValueError(f"a batch of {m} does not split over {ndata} data ranks")
        eng = engine(x.device)
        gen = _generator(eng, x.device, seed + state.step)
        idx = minibatch_indices(gen, n, m, t_steps, replace) if m < n else None
        if sharded:
            folded = mesh.fold_seed(int(torch.randint(0, 2**62, (1,), generator=gen,
                                                      device=x.device)),
                                    data_idx, mesh.index(comp_group))
            gen = torch.Generator(device=x.device).manual_seed(folded)
        chunk_seed = (int(torch.randint(0, 2**62, (1,), generator=gen, device=x.device))
                      if use_seed and eps is None else None)
        if eng is not None:
            def call(st, rows, g, word):
                xb = x if idx is None else x.index_select(0, rows["idx"])
                return step(st, xb, eps=rows.get("eps"), generator=g, seed=word)

            return eng.run(state, t_steps, {"idx": idx, "eps": eps}, call, generator=gen,
                           key=(*_x_key(x), m),
                           word=None if chunk_seed is None else (chunk_seed, state.step))
        mine = slice(data_idx * (m // ndata), (data_idx + 1) * (m // ndata))
        rows = []
        for t in range(t_steps):
            xb = x if idx is None else x[idx[t]]
            state, mets = step(state, xb[mine],
                               eps=None if eps is None else eps[t],
                               generator=gen, seed=chunk_seed)
            rows.append(mets)
        return state, {name: torch.stack([r[name] for r in rows]) for name in rows[0]}

    runner.engine = engine
    return runner


def make_mixture_runner(prior, *, rho: float, dof: float = 0.0,
                        unroll: int = 1) -> Callable:
    """Chunk runner ``runner(state, x, t_steps) → (state, metrics)``: T
    full-batch GMM (dof = 0) or SMM steps per call through
    ``mixstep.train_chunk`` (the CUDA kernel on CUDA tensors, its plain
    version on CPU tensors).

    Metrics: the (T,) tensors local_evidence (exact per step), elbo =
    local_evidence − KL_global at the POST-chunk naturals (the per-step
    engine logs its KL at each step's pre-update naturals; the two agree on
    the last row's global term at convergence) and rho, and the int
    ``unroll``, the U the chunk ran with. ``unroll`` must be in
    ``mixstep.UNROLLS`` and divide every chunk's T: anything else raises.
    """
    mixstep.check_unroll(unroll)

    def runner(state, x, t_steps: int):
        state, mets = mixstep.train_chunk(state, prior, x, rho=rho, t_steps=t_steps,
                                          dof=dof, unroll=unroll)
        gkl = gmm.kl_global(state.nat, prior)
        local = mets["local_evidence"]
        return state, {
            "local_evidence": local,
            "elbo": local - gkl,
            "rho": torch.full((t_steps,), rho, device=local.device),
            "unroll": unroll,
        }

    return runner


def run_mixture(state, x, *, steps: int, eval_every: int, emit: Callable,
                step: Callable | None = None, runner: Callable | None = None,
                generator: torch.Generator | None = None, graph: bool | None = None):
    """Train a pure mixture for ``steps`` full-batch steps.

    With ``step`` (one step per call, the plain engine) ``emit(t, state,
    elbo)`` follows step 1 and every ``eval_every``-th step, ``elbo`` being
    that step's bound at its pre-update naturals; the steps between two
    rows replay one captured step as a CUDA graph on CUDA tensors
    (``graph.ChunkGraph``; ``graph`` as ``make_step_runner``'s, False for a
    sharded step), ``generator`` being the one the step draws its
    minibatches from (registered with the graph). With ``runner`` (chunks
    of ``eval_every`` steps) it follows every chunk, with the chunk's last
    ``elbo``. Returns (state, seconds), timed to a device synchronise."""
    eng = None if runner is not None else _graph_engine(graph, False)(x.device)
    t0 = time.perf_counter()
    t = 0
    while t < steps:
        if runner is not None:
            todo = min(eval_every, steps - t)
            state, mets = runner(state, x, todo)
            t += todo
            emit(t, state, float(mets["elbo"][-1]))
        elif eng is not None:
            todo = 1 if t == 0 else min(eval_every - t % eval_every, steps - t)
            state, mets = eng.run(state, todo, {}, lambda st, rows, g, w: step(st, x),
                                  key=_x_key(x), generator=generator)
            t += todo
            if t % eval_every == 0 or t == 1:
                emit(t, state, float(mets["elbo"][-1]))
        else:
            state, mets = step(state, x)
            t += 1
            if t % eval_every == 0 or t == 1:
                emit(t, state, float(mets["elbo"]))
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return state, time.perf_counter() - t0
