"""High-level Trainer (``svax/train/trainer.py``): config → data → chunked
loop → checkpoint → metrics.

ONE engine (``Trainer``) owns the loop mechanics — chunking, restore or
start, warmup, the per-chunk evaluation with best tracking, patience and
time-to-target, checkpoints and JSONL rows — and each workload (SVAE, GMM,
SMM, the plain VAE) plugs in through a few hooks. The hot loop runs T steps a call
through the port's chunk runners (``train.loop``), on one of three
engines (``TrainerConfig.engine``):

* ``"step"`` — the per-step engine (the reference's ``"xla"``): T eager
  steps a chunk, the model config's fused kernels inside as it sets them
  (``loop.make_step_runner``; the mixtures' ``make_train_step``, with the
  estep kernel under ``fused=True``);
* ``"kernel"`` — the whole-train-step kernels (the reference's
  ``"megakernel"``): tinystep, flexstep or mixstep, one launch a chunk;
  raises with the gate's reason for a workload outside the kernel's class;
* ``"auto"`` — the kernel where the gate allows it AND the data is on
  CUDA, else the per-step engine.

Every runner keys its random numbers on ``seed + state.step``, so a
resumed chunk draws what the uninterrupted run drew at that step and
resume is bit-exact. The trainer's own generator (``rng``, on the CPU,
seeded ``seed``) draws one seed a chunk for the evaluation's noise, and
its state is checkpointed beside the train state (the reference's
``k_run``); the initial state comes from a generator on the device seeded
``seed``, as the entries make theirs.

Data-parallel and component-sharded fits (``data_parallel``,
``component_shards``) run inside ``torch.distributed`` ranks
(``parallel.mesh.spawn`` or ``torchrun``): the per-step engine reduces
over the mesh's groups, each rank holding its K-shard of the naturals
under component sharding; the naturals are gathered after every chunk, so
every rank evaluates the same whole state and takes the same early-stop
decision, and rank 0 alone writes rows and checkpoints. The whole-step
kernels are single-device and refuse sharding (``loop.SINGLE_DEVICE``).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from svax_torch.models.svae import SvaeConfig
from svax_torch.pgm import gmm
from svax_torch.pgm.gmm import GmmNat
from svax_torch.train import graph as cuda_graph
from svax_torch.train import loop, svae_step
from svax_torch.train.checkpoint import Checkpointer
from svax_torch.train.metrics import JsonlLogger
from svax_torch.utils import guards
from svax_torch.utils.tree import map_leaves

ENGINES = ("step", "kernel", "auto")


@dataclass
class TrainerConfig:
    """Everything the training harness needs beyond the model config."""

    steps: int = 2000
    batch_size: int = 0  # 0 = full batch
    lr: float = 1e-3
    rho: float = 0.05
    rho_decay: float = 0.0  # rho_t = rho / (1 + decay·t)
    eval_every: int = 200
    scan_chunk: int = 0  # steps a chunk; 0 = eval_every, capped at 100
    seed: int = 0
    data_parallel: bool = False
    component_shards: int = 1  # >1: shard K over a second mesh axis
    checkpoint_dir: str = ""
    logfile: str = ""
    encoder_hidden: tuple = (50, 50)
    decoder_hidden: tuple = (50, 50)
    prior_alpha: float = 1.0
    prior_kappa: float = 0.05
    # --- best-held-out tracking / time-to-target ---
    # Metric key to MAXIMIZE from the eval hook's dict ("" = the first key
    # the hook returns, e.g. test_elbo_per_point). Tracking is on whenever
    # an eval hook and a test set are present.
    track_metric: str = ""
    # Stop after this many consecutive evals without ≥ min_delta
    # improvement (0 = never stop early). Evals happen once per chunk.
    patience: int = 0
    min_delta: float = 0.0
    # The first eval whose metric reaches this is recorded as
    # {target_step, target_wall_s}.
    target_value: float | None = None
    # Where to write the summary JSON ("" = nowhere; it is always in
    # trainer.best after fit()).
    best_artifact: str = ""
    # "step" | "kernel" | "auto" (module docstring).
    engine: str = "step"
    # Mixture kernel only: complete steps per trip of mixstep's loop (one
    # of mixstep.UNROLLS, dividing every chunk). The SVAE kernels have none
    # and refuse anything but 1.
    megakernel_unroll: int = 1
    # --- ρ = 0 warmup + k-means++ reseed (train.warmup) ---
    # Skipped when resuming from a checkpoint past step 0.
    warmup_steps: int = 0
    reseed_pseudo_counts: float = 5.0
    reseed_cov_scale: float = 0.0  # 0 = auto (within-cluster variance)
    # Where the state and the data live; "cuda" raises without a card.
    device: str = "cuda"


def _host(state):
    return map_leaves(lambda t: t.detach().cpu().clone() if isinstance(t, torch.Tensor)
                      else t, state)


class Trainer:
    """The chunked training engine.

    Subclass hooks:
      * ``init(generator, data) → state`` — the initial train state;
      * ``make_step_runner() → runner(state, x, t_steps) → (state, metrics)``
        — the per-step engine, reducing over ``self.mesh``'s groups when
        the fit is sharded;
      * ``make_kernel_runner() → runner | None`` — the whole-step kernel
        for ``engine != "step"``: None for "auto" when the workload or the
        device does not allow it, a raise for an explicit "kernel";
      * ``make_eval() → fn(state, x_test, seed) → dict`` — optional
        held-out metrics, merged into each logged row;
      * ``warmup(state, x_train) → state`` and ``sync_dtype(data)``;
      * ``shard(state)`` / ``gather(state)`` — the rank's local state and
        the whole one (component sharding; identity otherwise).

    Metrics are dicts of (T,) tensors (ints pass through), of which each
    row logs the last.
    """

    def __init__(self, trainer_config: TrainerConfig):
        tc = trainer_config
        if tc.engine not in ENGINES:
            raise ValueError(f"unknown engine {tc.engine!r} ({'|'.join(ENGINES)})")
        self.device = torch.device(tc.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device={tc.device!r}: no CUDA device is available "
                               "(use device='cpu' for the plain PyTorch path)")
        self.tc = tc
        self._num_total = 0  # set by fit() from the training set
        self._batch = 0
        self._chunk = 1
        self._start = 0
        self.mesh = None  # parallel.mesh.Mesh of a sharded fit
        self.rank = 0
        self.engine: str | None = None  # the engine fit() ran: "step" or "kernel"
        # How fit() ran the step engine's chunks: graph.route's "graphed" or
        # "eager (reason)"; a kernel engine's chunk is one launch already.
        self.graph: str | None = None
        # Filled by fit() when an eval hook and a test set are present: the
        # time-to-target summary and a host snapshot of the best state.
        self.best: dict | None = None
        self.best_state = None

    # -- hooks ------------------------------------------------------------
    def init(self, generator: torch.Generator, data: torch.Tensor):
        raise NotImplementedError

    def make_step_runner(self) -> Callable:
        raise NotImplementedError

    def make_kernel_runner(self) -> Callable | None:
        if self.tc.engine == "kernel":
            raise ValueError(f"{type(self).__name__} has no whole-step kernel engine")
        return None

    def make_eval(self) -> Callable | None:
        return None

    def sync_dtype(self, data: torch.Tensor) -> None:
        """Align the model-side dtypes (the conjugate prior) to the data."""

    def warmup(self, state, x_train: torch.Tensor):
        raise NotImplementedError(
            f"{type(self).__name__} has no warmup path (warmup_steps="
            f"{self.tc.warmup_steps} requires an encoder to reseed from)")

    def shard(self, state):
        return state

    def gather(self, state):
        return state

    # -- engine -----------------------------------------------------------
    def _join_mesh(self) -> None:
        tc = self.tc
        if tc.component_shards > 1 and not tc.data_parallel:
            raise ValueError("component_shards > 1 needs data_parallel=True "
                             "(a data x comp mesh over the torch.distributed ranks)")
        if not tc.data_parallel:
            return
        import torch.distributed as dist

        from svax_torch.parallel import mesh

        if not dist.is_initialized():
            raise ValueError("data_parallel: run the fit in torch.distributed ranks "
                             "(parallel.mesh.spawn or torchrun)")
        world, comp = dist.get_world_size(), tc.component_shards
        if world % comp:
            raise ValueError(f"{world} ranks do not split into component_shards={comp}")
        self.mesh = mesh.make_data_comp_mesh(world // comp, comp)
        self.rank = dist.get_rank()

    def _as_data(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def fit(self, x_train, x_test=None, state=None):
        """Train ``steps`` steps from ``state`` (None: ``init``), or from the
        latest checkpoint in ``checkpoint_dir``; returns the final state.
        ``x_train`` and ``x_test`` (numpy or tensors) move to the device."""
        tc = self.tc
        self._join_mesh()
        x_train = self._as_data(x_train)
        x_test = None if x_test is None else self._as_data(x_test)
        n = x_train.shape[0]
        batch = min(tc.batch_size or n, n)
        if self.mesh is not None:
            ndata = self.mesh.data
            if batch % ndata:
                batch = (batch // ndata) * ndata or ndata
            if tc.batch_size == 0 and n % ndata:
                # Full-batch data parallelism: trim to a multiple of the mesh.
                n = (n // ndata) * ndata
                x_train = x_train[:n]
                batch = n
        self._num_total, self._batch = n, batch
        self.sync_dtype(x_train)
        rng = torch.Generator().manual_seed(tc.seed)
        if state is None:
            state = self.init(torch.Generator(device=self.device).manual_seed(tc.seed),
                              x_train)
        start = 0
        rank0 = self.rank == 0
        ckpt = None
        if tc.checkpoint_dir:
            ckpt = Checkpointer(tc.checkpoint_dir)
            state, rng, start = ckpt.restore_or(state, rng)
        if tc.warmup_steps > 0 and start == 0:
            state = self.warmup(state, x_train)
        self._start = start
        self._chunk = chunk = tc.scan_chunk or min(max(tc.eval_every, 1), 100)
        runner = self.make_kernel_runner() if tc.engine != "step" else None
        self.engine = "step" if runner is None else "kernel"
        self.graph = (cuda_graph.route(x_train.device, self.mesh is not None)
                      if runner is None else cuda_graph.KERNEL_CHUNK)
        if runner is None:
            runner = self.make_step_runner()
        evaluate = self.make_eval()

        logger = JsonlLogger((tc.logfile or None) if rank0 else None, echo=rank0)
        tracking = evaluate is not None and x_test is not None
        self.best = None
        self.best_state = None
        best_ckpt = None
        if ckpt is not None and tracking and rank0:
            best_ckpt = Checkpointer(Path(tc.checkpoint_dir) / "best", max_to_keep=1)
        best_val = float("-inf")
        best_step = -1
        best_wall = 0.0
        since_improve = 0
        stopped_early = False
        target_step = None
        target_wall = None
        metric_key = tc.track_metric or None
        wall_t0 = time.perf_counter()
        local = self.shard(state)
        t = start
        while t < tc.steps:
            todo = min(chunk, tc.steps - t)
            local, metrics = runner(local, x_train, todo)
            t += todo
            state = self.gather(local)
            row = {k: float(v[-1]) if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
            eval_seed = int(torch.randint(0, 2**62, (1,), generator=rng))
            if tracking:
                ev = evaluate(state, x_test, eval_seed)
                row.update({k: float(v) for k, v in ev.items()})
                if metric_key is None:
                    metric_key = next(iter(ev))
                val = float(ev[metric_key])
                wall = time.perf_counter() - wall_t0
                if val > best_val + tc.min_delta:
                    best_val, best_step, best_wall = val, t, wall
                    since_improve = 0
                    # A host snapshot of the best state, so callers get the
                    # best-step model even without checkpointing.
                    self.best_state = _host(state)
                    if best_ckpt is not None:
                        best_ckpt.save(t, state, rng)
                else:
                    since_improve += 1
                if (tc.target_value is not None and target_step is None
                        and val >= tc.target_value):
                    target_step, target_wall = t, wall
            if guards.nan_debugging():
                guards.assert_finite(state, "state")
                guards.assert_finite(row, "metrics")
            logger.log(t, **row)
            if ckpt is not None and rank0:
                ckpt.save(t, state, rng)
            if tracking and tc.patience and since_improve >= tc.patience:
                stopped_early = True
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        logger.close()
        if tracking:
            self.best = {
                "metric": metric_key,
                "best_value": best_val,
                "best_step": best_step,
                "best_wall_s": round(best_wall, 3),
                "target": tc.target_value,
                "target_step": target_step,
                "target_wall_s": None if target_wall is None else round(target_wall, 3),
                "stopped_early": stopped_early,
                "steps_run": t,
                "total_wall_s": round(time.perf_counter() - wall_t0, 3),
            }
            if tc.best_artifact and rank0:
                path = Path(tc.best_artifact)
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(json.dumps(self.best, indent=1))
        return state


def _prior_to(prior: GmmNat, data: torch.Tensor) -> GmmNat:
    if prior.dir_nat.dtype == data.dtype and prior.dir_nat.device == data.device:
        return prior
    return svae_step.nat_to(prior, data.device, data.dtype)


class SvaeTrainer(Trainer):
    """End-to-end SVAE training through the port's chunk runners."""

    def __init__(self, model_config: SvaeConfig, trainer_config: TrainerConfig,
                 input_dim: int, prior: GmmNat | None = None):
        super().__init__(trainer_config)
        tc = trainer_config
        self.mc = model_config
        self.input_dim = input_dim
        self.prior = prior if prior is not None else gmm.make_prior(
            model_config.num_components, model_config.latent_dim, alpha=tc.prior_alpha,
            kappa=tc.prior_kappa, device=self.device)
        self.kernel = loop.PER_STEP
        self.warmup_info = None

    def sync_dtype(self, data: torch.Tensor) -> None:
        # Keep the whole state in the data's dtype (e.g. float64 oracle runs).
        self.prior = _prior_to(self.prior, data)

    def init(self, generator: torch.Generator, data: torch.Tensor | None = None):
        if data is not None:
            self.sync_dtype(data)
        return svae_step.init_state(generator, self.input_dim, self.mc, self.prior,
                                    encoder_hidden=tuple(self.tc.encoder_hidden),
                                    decoder_hidden=tuple(self.tc.decoder_hidden),
                                    data=data)

    def _comp_sharded(self) -> bool:
        return self.mesh is not None and self.mesh.comp > 1

    def make_step_runner(self) -> Callable:
        tc = self.tc
        prior, groups = self.prior, {}
        if self.mesh is not None:
            from svax_torch import convert

            groups = dict(data_group=self.mesh.data_group, comp_group=self.mesh.comp_group)
            if self._comp_sharded():
                prior = convert.shard_nat(prior, self.mesh.comp_idx, self.mesh.comp)
        run = loop.make_step_runner(self.mc, prior, lr=tc.lr, rho=tc.rho,
                                    rho_decay=tc.rho_decay, batch_size=self._batch,
                                    engine="kernel", replace=not tc.data_parallel, **groups)
        return lambda state, x, t_steps: run(state, x, t_steps, seed=tc.seed)

    def make_kernel_runner(self) -> Callable | None:
        tc = self.tc
        if tc.megakernel_unroll != 1:
            # Loud, not ignored: the unroll exists on the mixture kernel only.
            raise ValueError(
                "megakernel_unroll applies only to the mixture kernel engine (GmmTrainer/"
                "SmmTrainer); the SVAE tinystep/flexstep kernels have no unroll")
        gate = dict(batch_full=tc.batch_size == 0, encoder_hidden=tuple(tc.encoder_hidden),
                    decoder_hidden=tuple(tc.decoder_hidden), rho=tc.rho,
                    rho_decay=tc.rho_decay, likelihood=self.mc.likelihood,
                    input_dim=self.input_dim, data_parallel=tc.data_parallel)
        if tc.engine == "auto":
            # The kernel only where it runs as a kernel: supported AND on CUDA.
            kernel = loop.choose_kernel(self.mc, engine="auto", **gate)
            if kernel == loop.PER_STEP or self.device.type != "cuda":
                return None
        else:
            try:
                kernel = loop.choose_kernel(self.mc, engine="megakernel", **gate)
            except ValueError as err:
                raise ValueError(f"engine='kernel': {err}") from None
        self.kernel = kernel
        run = loop.make_runner(self.mc, self.prior, lr=tc.lr, rho=tc.rho,
                               rho_decay=tc.rho_decay, batch_size=tc.batch_size,
                               engine="kernel", kernel=kernel)
        return lambda state, x, t_steps: run(state, x, t_steps, seed=tc.seed)

    def warmup(self, state, x_train: torch.Tensor):
        from svax_torch.train import warmup

        tc = self.tc
        state, info = warmup.vae_warmup_reseed(
            state, x_train, self.mc, self.prior, lr=tc.lr, steps=tc.warmup_steps,
            batch_size=tc.batch_size, scan_chunk=tc.scan_chunk or 100, seed=tc.seed,
            pseudo_counts=tc.reseed_pseudo_counts, cov_scale=tc.reseed_cov_scale)
        self.warmup_info = info
        return state

    def shard(self, state):
        if not self._comp_sharded():
            return state
        from svax_torch import convert

        return state._replace(pgm_nat=convert.shard_nat(state.pgm_nat, self.mesh.comp_idx,
                                                        self.mesh.comp))

    def gather(self, state):
        if not self._comp_sharded():
            return state
        from svax_torch import convert

        return state._replace(pgm_nat=convert.gather_nat(state.pgm_nat,
                                                         self.mesh.comp_group))

    def make_eval(self) -> Callable:
        inner = svae_step.make_eval_fn(self.mc, self.prior)
        kernel_rng = self.mc.fused_combine and self.mc.kernel_rng

        def evaluate(state, x_test, seed: int):
            if kernel_rng:
                ev = inner(state, x_test, seed=seed)
            else:
                ev = inner(state, x_test,
                           generator=torch.Generator(device=x_test.device).manual_seed(seed))
            return {"test_elbo_per_point": ev["elbo_per_point"]}

        return evaluate


class _ConjugateMixtureTrainer(Trainer):
    """Shared engine for the pure-mixture baselines (GMM, SMM)."""

    dof = 0.0

    def __init__(self, trainer_config: TrainerConfig, num_components: int, data_dim: int,
                 prior: GmmNat | None = None, fused: bool = False):
        super().__init__(trainer_config)
        tc = trainer_config
        self.prior = prior if prior is not None else gmm.make_prior(
            num_components, data_dim, alpha=tc.prior_alpha, kappa=tc.prior_kappa,
            device=self.device)
        self.fused = fused
        self.rho = svae_step.rho_schedule(tc.rho, tc.rho_decay)

    def sync_dtype(self, data: torch.Tensor) -> None:
        self.prior = _prior_to(self.prior, data)

    def _make_raw_step(self, data_group) -> Callable:
        raise NotImplementedError

    def make_step_runner(self) -> Callable:
        """T steps a call (``loop.make_batch_runner``): the full batch, or a
        (T, M) index stack drawn with replacement (without under data
        parallelism) from a generator keyed ``seed + state.step``; under
        data parallelism each rank keeps its contiguous slice of every
        batch."""
        data_group = None if self.mesh is None else self.mesh.data_group
        return loop.make_batch_runner(self._make_raw_step(data_group), batch_size=self._batch,
                                      seed=self.tc.seed, replace=not self.tc.data_parallel,
                                      data_group=data_group)

    def make_kernel_runner(self) -> Callable | None:
        from svax_torch.ops import mixstep

        tc = self.tc
        reason = mixstep.unsupported_reason(
            data_dim=self.prior.niw_nat.eta1.shape[-1], batch_full=tc.batch_size == 0,
            rho=self.rho, num_points=self._num_total,
            num_components=self.prior.dir_nat.shape[0], data_parallel=tc.data_parallel)
        if tc.engine == "auto":
            if reason is not None or self.device.type != "cuda":
                return None
        elif reason is not None:
            raise ValueError(f"engine='kernel': {reason}")
        last = (tc.steps - self._start) % self._chunk
        mixstep.check_unroll(tc.megakernel_unroll, self._chunk, last or self._chunk)
        return loop.make_mixture_runner(self.prior, rho=tc.rho, dof=self.dof,
                                        unroll=tc.megakernel_unroll)


class GmmTrainer(_ConjugateMixtureTrainer):
    """Pure-GMM natural-gradient VMP through the shared engine (BASELINE
    config #2); ``fused=True`` runs the per-step engine's E-step in the
    estep kernel on CUDA."""

    def init(self, generator: torch.Generator, data: torch.Tensor | None = None):
        from svax_torch.models import gmm_baseline

        if data is not None:
            self.sync_dtype(data)
        return gmm_baseline.init_state(generator, self.prior, data)

    def _make_raw_step(self, data_group) -> Callable:
        from svax_torch.models import gmm_baseline

        return gmm_baseline.make_train_step(self.prior, self.rho, num_total=self._num_total,
                                            fused=self.fused, data_group=data_group)

    def make_eval(self) -> Callable:
        from svax_torch.models import gmm_baseline

        def evaluate(state, x_test, seed: int):
            ev = gmm_baseline.evaluate(state.nat, self.prior, x_test,
                                       num_total=self._num_total)
            return {"test_evidence_per_point": ev["evidence_per_point"]}

        return evaluate


class SmmTrainer(_ConjugateMixtureTrainer):
    """Student-t mixture (Gamma scale augmentation) through the engine."""

    def __init__(self, trainer_config: TrainerConfig, num_components: int, data_dim: int,
                 prior: GmmNat | None = None, dof: float = 4.0):
        super().__init__(trainer_config, num_components, data_dim, prior)
        self.dof = dof

    def init(self, generator: torch.Generator, data: torch.Tensor | None = None):
        from svax_torch.models import smm_baseline

        if data is not None:
            self.sync_dtype(data)
        return smm_baseline.init_state(generator, self.prior, data)

    def _make_raw_step(self, data_group) -> Callable:
        from svax_torch.models import smm_baseline

        return smm_baseline.make_train_step(self.prior, self.rho, num_total=self._num_total,
                                            dof=self.dof, data_group=data_group)


class VaeTrainer(Trainer):
    """The plain-VAE baseline through the engine (``models.vae``): the
    per-step engine only, a ``"kernel"`` request refused and ``"auto"``
    falling back, as the reference's."""

    def __init__(self, model_config, trainer_config: TrainerConfig, input_dim: int):
        super().__init__(trainer_config)
        self.mc = model_config
        self.input_dim = input_dim

    def init(self, generator: torch.Generator, data: torch.Tensor | None = None):
        from svax_torch.models import vae

        dtype = data.dtype if data is not None else torch.float32
        return vae.init_state(generator, self.input_dim, self.mc,
                              tuple(self.tc.encoder_hidden), tuple(self.tc.decoder_hidden),
                              device=self.device, dtype=dtype)

    def make_step_runner(self) -> Callable:
        from svax_torch.models import vae

        tc = self.tc
        data_group = None if self.mesh is None else self.mesh.data_group
        step = vae.make_train_step(self.mc, tc.lr, data_group=data_group)
        return loop.make_batch_runner(step, batch_size=self._batch, seed=tc.seed,
                                      replace=not tc.data_parallel, data_group=data_group,
                                      noise=True)

    def make_eval(self) -> Callable:
        from svax_torch.models import vae

        @torch.no_grad()
        def evaluate(state, x_test, seed: int):
            gen = torch.Generator(device=x_test.device).manual_seed(seed)
            return {"test_elbo_per_point": vae.elbo(state.params, x_test, gen, self.mc)[0]}

        return evaluate
