"""Pinwheel SVAE seed sweep with the port (``experiments/seed_sweep.py``).

    python -m svax_torch.seed_sweep [--variants base kpp warmup kpp+warmup ...]
        [--num-seeds N | --seed-list S ...] [--steps N] [--chunk T]
        [--iw-samples S] [--warmup-steps N] [--warmup-floor RHO] [--rho RHO]
        [--engine step|kernel|plain] [--nn-precision high|highest|default]
        [--encoder-head diag|full] [--redraw-data] [--json PATH]
        [--device cuda|cpu]

Trains the pinwheel SVAE (K = 10, latent d = 2, S = 4, 50-50, Adam at 1e-3,
full batch) over seeds, once per variant, and reports each seed's
importance-weighted test bound against the pure GMM's exact predictive,
then the variant's mean ± sd and how many seeds cross it. A variant is
``+``-joined tokens, as the reference's:

  base        constant ρ (``--rho``), the SVAE's random-data-point init
  kpp         k-means++ initial naturals (``pgm.init``; latent d equals the
              data's, so data-space seeds are latent seeds)
  warmup      ρ ramps linearly from ``--warmup-floor`` to ``--rho`` over
              ``--warmup-steps`` steps (``warmup_rho``)
  wd<f>       AdamW with weight decay f
  steps<n>    n steps instead of ``--steps``
  aug<σ>      input-noise augmentation σ (each step trains on x + σ·ξ)
  rs<r>       best of r restarts, seeded ``seed + 1000·r``, chosen by the
              last training ELBO alone (no test data)

``--engine kernel`` (the reference's ``mega``) runs every chunk of
``--chunk`` steps as one launch of the tinystep kernel, with the
augmentation drawn in the kernel (``loop.make_runner``, as ``compare`` runs
its pinwheel leg): its bf16-product mode under ``--nn-precision default``,
its f32 mode otherwise. ``--engine plain`` runs tinystep's plain version
through the same runner, and ``--engine step`` (the reference's ``xla``,
the default) the per-step engine (``loop.make_step_runner``). The kernel
and its plain version take neither the warmup ramp nor weight decay, and
refuse such a variant as the reference's ``mega`` does; a full recognition
head (``--encoder-head full``) runs on the step engine whatever
``--engine`` says, as the reference's does. On CPU tensors the kernel runs
its plain version.

The bound is IW(``--iw-samples``) from a generator seeded ``seed + 999``
and the test ELBO from one seeded ``seed + 1999``. The bar is the
reference's constant −5.41 on the canonical protocol (the data fixed at
the seed-0 draw, the seeds varying the model); ``--redraw-data`` draws the
pinwheel anew per seed and computes each draw's exact GMM predictive
(``gmm_bar``: 300 ρ = 1 mixstep steps from the K data rows the reference's
``gmm_baseline.init_state(PRNGKey(0), ...)`` starts from — those depend on
the key and N alone, so every N = 400 draw shares them — then the exact
Student-t predictive). Prints the reference's per-seed and per-variant
lines; ``--json`` writes the reference's schema ({"config", "results"}),
never over a reference artifact in ``runs/``. ``--device cuda`` (the
default) raises without a card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

# The pure GMM's exact Student-t predictive on the seed-0 split (the
# reference's constant bar).
GMM_PREDICTIVE_BAR = -5.41
K, S, LR, HIDDEN = 10, 4, 1e-3, (50, 50)
KERNEL_ONLY = ("--engine {engine} supports constant or inverse-decay rho and plain Adam "
               "only (no warmup ramp, no weight decay) — run these on --engine step")


def parse_variant(variant: str, *, steps: int, chunk: int, engine: str) -> dict:
    """A variant's settings: {"kpp", "warmup", "wd", "steps", "aug",
    "restarts", "chunk"}. Raises SystemExit, as the reference does, for a
    step budget that is not a multiple of the chunk (the chunk clamped to
    the budget) and for warmup or weight decay on the kernel engines."""
    tokens = variant.split("+")
    spec = {
        "kpp": "kpp" in tokens,
        "warmup": "warmup" in tokens,
        "wd": next((float(t[2:]) for t in tokens if t.startswith("wd")), 0.0),
        "steps": next((int(t[5:]) for t in tokens if t.startswith("steps")), steps),
        "aug": next((float(t[3:]) for t in tokens if t.startswith("aug")), 0.0),
        "restarts": next((int(t[2:]) for t in tokens if t.startswith("rs")), 1),
    }
    spec["chunk"] = min(chunk, spec["steps"])
    if spec["steps"] % spec["chunk"]:
        raise SystemExit(f"variant {variant!r}: steps {spec['steps']} is not a multiple "
                         f"of chunk {spec['chunk']} — the remainder would be dropped")
    if engine != "step" and (spec["warmup"] or spec["wd"] > 0.0):
        raise SystemExit(f"variant {variant!r}: " + KERNEL_ONLY.format(engine=engine))
    return spec


def warmup_rho(floor: float, rho: float, t_ramp: int):
    """ρ(step) = floor + (ρ − floor)·min(step / t_ramp, 1), in float32 as
    the reference's ramp computes it."""
    lo, span, ramp, one = np.float32(floor), np.float32(rho - floor), np.float32(t_ramp), \
        np.float32(1.0)

    def rho_fn(step: int) -> float:
        return float(lo + span * np.minimum(np.float32(step) / ramp, one))

    return rho_fn


def gmm_bar(x: torch.Tensor, xt: torch.Tensor, steps: int = 300) -> float:
    """The pure GMM's exact predictive on a pinwheel draw: ``steps`` full-
    batch ρ = 1 steps on mixstep from the reference's K initial rows
    (``compare.REFERENCE_INIT_ROWS["pinwheel"]``, N = 400), scored by
    ``evaluation.gmm_predictive_log_prob``."""
    from svax_torch.compare import REFERENCE_INIT_ROWS
    from svax_torch.models import evaluation, gmm_baseline
    from svax_torch.pgm import gmm
    from svax_torch.train import loop

    rows = REFERENCE_INIT_ROWS["pinwheel"]
    if x.shape[0] <= max(rows):
        raise ValueError(f"the reference's initial rows index N = 400 points (got {x.shape[0]})")
    prior = gmm.make_prior(K, x.shape[1], kappa=0.05, device=x.device, dtype=x.dtype)
    state = gmm_baseline.init_state(None, prior, x, rows=torch.as_tensor(rows,
                                                                         device=x.device))
    state, _ = loop.make_mixture_runner(prior, rho=1.0)(state, x, steps)
    with torch.no_grad():
        return float(evaluation.gmm_predictive_log_prob(state.nat, xt).mean())


def make_config(n: int, nn_precision: str = "high", encoder_head: str = "diag"):
    """The sweep's SvaeConfig at N training points."""
    from svax_torch.models.svae import SvaeConfig

    return SvaeConfig(latent_dim=2, num_components=K, num_samples=S, num_total=n,
                      nn_precision=nn_precision, encoder_head=encoder_head)


def make_variant_runner(config, prior, spec: dict, *, engine: str, rho: float,
                        warmup_steps: int = 3000, warmup_floor: float = 1e-3):
    """``runner(state, x, t_steps, seed)`` for one variant: tinystep (or its
    plain version) through ``loop.make_runner``, or the per-step engine with
    the variant's ρ schedule, augmentation and AdamW."""
    from svax_torch.train import loop

    if engine in ("kernel", "plain"):
        return loop.make_runner(config, prior, lr=LR, rho=rho, batch_size=0,
                                aug_noise=spec["aug"], engine=engine, kernel="tinystep")
    rho_t = warmup_rho(warmup_floor, rho, warmup_steps) if spec["warmup"] else rho
    return loop.make_step_runner(config, prior, lr=LR, rho=rho_t, batch_size=0,
                                 aug_noise=spec["aug"], weight_decay=spec["wd"])


def train_restarts(x: torch.Tensor, train_np: np.ndarray, config, prior, runner,
                   spec: dict, seed: int):
    """The best of ``spec["restarts"]`` runs from seeds ``seed + 1000·r`` by
    the last training ELBO: (train elbo, state, metrics)."""
    from svax_torch.pgm.init import init_variational_kmeanspp
    from svax_torch.train import svae_step

    best = None
    for r in range(spec["restarts"]):
        base = seed + 1000 * r
        gen = torch.Generator(device=x.device).manual_seed(base)
        state = svae_step.init_state(gen, 2, config, prior, HIDDEN, HIDDEN, data=x)
        if spec["kpp"]:
            state = state._replace(pgm_nat=init_variational_kmeanspp(prior, train_np,
                                                                     seed=base))
        for _ in range(spec["steps"] // spec["chunk"]):
            state, metrics = runner(state, x, spec["chunk"], seed=base)
        tr_elbo = float(metrics["elbo"][-1])
        if best is None or tr_elbo > best[0]:
            best = (tr_elbo, state, metrics)
    return best


def iw_bound(state, xt: torch.Tensor, num_samples: int, seed: int,
             encoder_head: str = "diag") -> float:
    """The mean IW(num_samples) test bound, its draws from a generator
    seeded ``seed``."""
    from svax_torch.models import evaluation

    gen = torch.Generator(device=xt.device).manual_seed(seed)
    return float(evaluation.svae_iw_loglik(state.nn_params, state.pgm_nat, xt, num_samples,
                                           generator=gen, encoder_head=encoder_head).mean())


def summarize(rows: list[dict], redraw: bool) -> dict:
    """The reference's per-variant summary of the rows."""
    iws = np.asarray([r["iw_per_point"] for r in rows])
    crossing = int(np.sum([r["crossed"] for r in rows]))
    return {
        "mean": round(float(iws.mean()), 3),
        "sd": round(float(iws.std(ddof=1)), 3) if len(iws) > 1 else float("nan"),
        "min": round(float(iws.min()), 3),
        "max": round(float(iws.max()), 3),
        "crossing": f"{crossing}/{len(iws)}",
        "bar": "per-draw gmm predictive" if redraw else GMM_PREDICTIVE_BAR,
    }


def main(argv: list[str] | None = None) -> dict:
    """Run the sweep; returns {"config", "results", "engine", "seconds"}:
    the JSON payload, the engine that ran and each variant's seconds."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variants", nargs="+", default=["base", "kpp", "warmup", "kpp+warmup"])
    ap.add_argument("--num-seeds", type=int, default=8)
    ap.add_argument("--seed-list", type=int, nargs="+", default=None,
                    help="explicit seeds to run (overrides --num-seeds)")
    ap.add_argument("--steps", type=int, default=15000)
    ap.add_argument("--chunk", type=int, default=1000)
    ap.add_argument("--iw-samples", type=int, default=1000)
    ap.add_argument("--warmup-steps", type=int, default=3000)
    ap.add_argument("--warmup-floor", type=float, default=1e-3)
    ap.add_argument("--rho", type=float, default=0.05)
    ap.add_argument("--json", type=str, default="")
    ap.add_argument("--engine", choices=["step", "kernel", "plain"], default="step",
                    help="step: the per-step engine; kernel: tinystep, one launch a "
                         "chunk, augmentation in the kernel; plain: tinystep's plain "
                         "version")
    ap.add_argument("--nn-precision", choices=["high", "highest", "default"], default="high",
                    help="the nets' products: default runs tinystep's bf16-product mode")
    ap.add_argument("--encoder-head", choices=["diag", "full"], default="diag",
                    help="recognition head; full runs on the step engine")
    ap.add_argument("--redraw-data", action="store_true",
                    help="redraw the pinwheel per seed, with each draw's exact GMM "
                         "predictive as the bar")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step
    from svax_torch.utils.runs import port_artifact, write_json

    if args.json:
        port_artifact(args.json)  # before any training
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = args.engine
    if args.encoder_head == "full" and engine != "step":
        print(f"[seed_sweep] --encoder-head full runs on the step engine, not {engine}",
              flush=True)
        engine = "step"
    specs = {v: parse_variant(v, steps=args.steps, chunk=args.chunk, engine=engine)
             for v in args.variants}
    device = torch.device(args.device)

    def draw(seed: int):
        train, test = load_pinwheel(seed=seed)
        return (train, torch.tensor(train, dtype=torch.float32, device=device),
                torch.tensor(test, dtype=torch.float32, device=device))

    train, x, xt = draw(0)
    config = make_config(x.shape[0], args.nn_precision, args.encoder_head)
    prior = gmm.make_prior(K, 2, kappa=0.05, device=device)
    evaluate = svae_step.make_eval_fn(config, prior)
    if engine == "kernel" and device.type == "cuda":
        from svax_torch.ops import _build

        _build.load()  # build outside the timed region
    mode = "bf16-products" if args.nn_precision == "default" else "f32"
    print(f"[seed_sweep] engine {engine}"
          + (f" (tinystep, {mode})" if engine != "step" else "") + f" on {device}",
          flush=True)
    results, seconds = {}, {}
    seeds = args.seed_list if args.seed_list is not None else range(args.num_seeds)
    for variant, spec in specs.items():
        t_variant = time.perf_counter()
        runner = make_variant_runner(config, prior, spec, engine=engine, rho=args.rho,
                                     warmup_steps=args.warmup_steps,
                                     warmup_floor=args.warmup_floor)
        rows = []
        for seed in seeds:
            if args.redraw_data:
                train, x, xt = draw(seed)
            bar = gmm_bar(x, xt) if args.redraw_data else GMM_PREDICTIVE_BAR
            t0 = time.perf_counter()
            tr_elbo, state, metrics = train_restarts(x, train, config, prior, runner, spec,
                                                     seed)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            iw = iw_bound(state, xt, args.iw_samples, seed + 999, args.encoder_head)
            elbo = tr_elbo / x.shape[0]
            te = float(evaluate(state, xt, generator=torch.Generator(
                device=device).manual_seed(seed + 1999))["elbo_per_point"])
            rows.append({"seed": seed, "iw_per_point": round(iw, 3),
                         "final_elbo_per_point": round(elbo, 3),
                         "test_elbo_per_point": round(te, 3),
                         "gmm_bar": round(bar, 3),
                         "crossed": bool(iw > bar),
                         "wall_s": round(wall, 1)})
            print(f"[{variant}] seed {seed}: IW/pt {iw:.3f}  ELBO/pt {elbo:.3f}  "
                  f"testELBO/pt {te:.3f}  bar {bar:.3f} "
                  f"{'CROSS' if iw > bar else 'below'}  ({wall:.1f}s)", flush=True)
        summary = summarize(rows, args.redraw_data)
        results[variant] = {"rows": rows, "summary": summary}
        seconds[variant] = time.perf_counter() - t_variant
        print(f"== {variant}: mean {summary['mean']} ± {summary['sd']}  "
              f"crossing {summary['crossing']}", flush=True)
    payload = {"config": vars(args), "results": results}
    if args.json:
        print(f"wrote {write_json(args.json, payload)}")
    return {**payload, "engine": engine, "seconds": seconds}


if __name__ == "__main__":
    main()
