"""The graphed runners against the eager loop on one CUDA card.

    python -m svax_torch.measure_graphs [--steps N] [--paths P ...] [--no-entries]
        [--parent DIR] > chiprun_out/graphs.txt

For each path of ``PATHS`` at its config's full width (seeded weights and
data): the final state and every metric of a graphed chunk against the
eager loop's (``loop.make_step_runner`` / ``make_batch_runner`` with
``graph=False``), bit for bit; steps/s of both routes in turns (eager,
graphed, graphed, eager), each timed over one chunk to a synchronise after
a warm chunk; the graph's capture seconds (warm-up included) and the device
memory its capture reserved; then, each in a fresh process of its own
(torch.profiler has read no device events late in a long process), one
profile of each route: wall and device ms a step and the device's idle
share. Then the mnist-svae and bigk-dp entries (``train_svae`` at their
configs, no warmup) and ``train_gmm --engine plain --fused-kernel`` on
both routes. With ``--parent DIR`` (an older checkout, e.g. ``git archive``
of the parent commit under the gitignored ``build/``) it first holds the
mnist-svae and bigk-dp entries' final states, run in fresh processes on the
parent's eager loop and on this tree's eager loop and graph, to one digest.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

# The paths a graph replays: the per-step engine at mnist-svae's and
# bigk-dp's configs, the big-K f32 step (row sum fused), the full
# recognition head at mnist width (the plain combine), sampled
# reconstruction at bigk width, the comparison's pinwheel VAE step and the
# pinwheel GMM's plain step with the estep kernel.
PATHS = ("mnist-svae", "bigk-dp", "bigk-f32", "full-head", "sampled", "vae", "gmm-fused")


def _svae_setup(dev, name: str, graph, **switches):
    from svax_torch.configs import CONFIGS
    from svax_torch.data import load_dataset
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import loop, svae_step

    cfg = CONFIGS[name]
    train, _, meta = load_dataset(cfg["dataset"], seed=0)
    x = torch.tensor(train, dtype=torch.float32, device=dev)
    config = SvaeConfig(latent_dim=cfg["latent_dim"], num_components=cfg["num_components"],
                        num_samples=cfg["num_samples"], num_total=x.shape[0],
                        likelihood=meta["likelihood"],
                        nn_compute_dtype=cfg["nn_compute_dtype"],
                        fused_combine=cfg["fused_combine"], kernel_rng=cfg["kernel_rng"],
                        fused_mlp_decoder=cfg.get("fused_mlp_decoder", False))
    config = config._replace(**switches)
    prior = gmm.make_prior(config.num_components, config.latent_dim, alpha=cfg["alpha"],
                           kappa=cfg["kappa"], device=dev)
    state = svae_step.init_state(torch.Generator(device=dev).manual_seed(0), x.shape[1],
                                 config, prior, tuple(cfg["encoder_hidden"]),
                                 tuple(cfg["decoder_hidden"]))
    run = loop.make_step_runner(config, prior, lr=cfg["lr"], rho=cfg["rho"],
                                rho_decay=cfg["rho_decay"], batch_size=cfg["batch_size"],
                                replace=not cfg.get("dp", False), graph=graph)
    return (lambda st, t: run(st, x, t, seed=0)), state, run.engine(x.device)


def setup(dev, path: str, graph):
    """(chunk, state, engine) for ``path`` on ``dev``: ``chunk(state, T) →
    (state, metrics)`` runs T steps through the runner with ``graph`` (None:
    the default, a CUDA graph; False: the eager loop); ``engine`` is the
    runner's graph engine (None when eager)."""
    if path in ("mnist-svae", "bigk-dp"):
        return _svae_setup(dev, path, graph)
    if path == "full-head":
        return _svae_setup(dev, "mnist-svae", graph, encoder_head="full")
    if path == "sampled":
        return _svae_setup(dev, "bigk-dp", graph, recon_mode="sampled")
    if path == "bigk-f32":
        from svax_torch.measure_mnist import bigk_f32_setup

        run, state, x = bigk_f32_setup(dev, True, graph=graph)
        return (lambda st, t: run(st, x, t, seed=0)), state, run.engine(x.device)
    from svax_torch.data import load_dataset
    from svax_torch.train import loop

    if path == "vae":
        from svax_torch.compare import LR, SPECS
        from svax_torch.models import vae

        sp = SPECS["pinwheel"]
        train, _, meta = load_dataset("pinwheel", seed=0)
        x = torch.tensor(train, dtype=torch.float32, device=dev)
        vconfig = vae.VaeConfig(latent_dim=sp["d"], num_samples=sp["s"],
                                likelihood=meta["likelihood"])
        state = vae.init_state(torch.Generator(device=dev).manual_seed(0), x.shape[1],
                               vconfig, sp["hidden"], sp["hidden"], device=dev)
        step = loop.augment_step(vae.make_train_step(vconfig, LR), sp["aug"])
        run = loop.make_batch_runner(lambda s, xb, g: step(s, xb, generator=g),
                                     batch_size=sp["batch"], seed=0, noise=True, graph=graph)
        return (lambda st, t: run(st, x, t)), state, run.engine(x.device)
    if path == "gmm-fused":
        from svax_torch.models import gmm_baseline
        from svax_torch.pgm import gmm

        train, _, _ = load_dataset("pinwheel", seed=0)
        x = torch.tensor(train, dtype=torch.float32, device=dev)
        prior = gmm.make_prior(10, 2, kappa=0.05, device=dev)
        state = gmm_baseline.init_state(torch.Generator(device=dev).manual_seed(0), prior, x)
        step = gmm_baseline.make_train_step(prior, 1.0, num_total=x.shape[0], fused=True)
        run = loop.make_batch_runner(step, graph=graph)
        return (lambda st, t: run(st, x, t)), state, run.engine(x.device)
    raise ValueError(f"unknown path {path!r} ({', '.join(PATHS)})")


def leaves(tree) -> list:
    from svax_torch.train.graph import flatten

    return flatten(tree)[0]


def same(a, b) -> bool:
    """Bit-equal trees: every tensor ``torch.equal``, every other leaf ==."""
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(p, q) if torch.is_tensor(p) else p == q for p, q in zip(la, lb))


def equal_routes(dev, path: str, chunks) -> dict:
    """Chunks of ``chunks`` steps (e.g. (150, 50): a later, shorter chunk
    replays the same graph) on both routes from one state, in turns (eager
    chunk, graphed chunk, ...), each timed to a synchronise: whether the
    states and every chunk's metrics are bit-equal, the graph's captures,
    its capture seconds and pool bytes, and steps/s of each route — the
    graph's over the chunks after its first, which holds the capture."""
    runs = {graph: setup(dev, path, graph) for graph in (False, None)}
    states = {graph: run[1] for graph, run in runs.items()}
    mets = {False: [], None: []}
    timed = {False: [0, 0.0], None: [0, 0.0]}
    for i, steps in enumerate(chunks):
        for graph in (False, None):
            t0 = time.perf_counter()
            states[graph], m = runs[graph][0](states[graph], steps)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if graph is False or i > 0:
                timed[graph][0] += steps
                timed[graph][1] += time.perf_counter() - t0
            mets[graph].append(m)
    eng = runs[None][2]
    rate = {g: n / s if s > 0 else None for g, (n, s) in timed.items()}
    return {"equal": same(states[False], states[None]) and same(mets[False], mets[None]),
            "captures": None if eng is None else eng.captures,
            "capture_s": None if eng is None else eng.capture_seconds,
            "pool_bytes": None if eng is None else eng.pool_bytes,
            "eager": rate[False], "graphed": rate[None]}


def rates(dev, path: str, steps: int) -> dict:
    """Steps/s of the eager loop and the graph in turns (eager, graphed,
    graphed, eager): each a chunk of ``steps`` after a warm chunk of 5 (for
    the graph: its capture), timed to a synchronise; and the graph's capture
    seconds and the device memory its capture reserved."""
    setups = {graph: setup(dev, path, graph) for graph in (False, None)}
    for chunk, state, _ in setups.values():
        chunk(state, 5)
    torch.cuda.synchronize(dev)
    got = {False: [], None: []}
    for graph in (False, None, None, False):
        chunk, state, _ = setups[graph]
        t0 = time.perf_counter()
        chunk(state, steps)
        torch.cuda.synchronize(dev)
        got[graph].append(steps / (time.perf_counter() - t0))
    eng = setups[None][2]
    return {"eager": got[False], "graphed": got[None], "capture_s": eng.capture_seconds,
            "pool_bytes": eng.pool_bytes}


def profile_path(dev, index: int, graphed: int, steps: int) -> dict:
    """PATHS[index] on one route (``graphed`` 1: the graph; 0: the eager
    loop) under torch.profiler: a warm chunk of 2, then ``steps`` steps
    profiled; wall and device ms a step and the idle share."""
    from svax_torch.measure_mixture import device_us, profiled

    chunk, state, _ = setup(dev, PATHS[index], None if graphed else False)
    state, _ = chunk(state, 2)
    torch.cuda.synchronize(dev)
    wall, prof = profiled(lambda: chunk(state, steps))
    busy = device_us(prof) / 1e3
    if busy <= 0.0:
        raise RuntimeError(f"{PATHS[index]}: the profile recorded no device time")
    return {"wall_ms": wall / steps, "device_ms": busy / steps, "idle": 1.0 - busy / wall,
            "steps_per_s": 1e3 * steps / wall}


# chip_smoke phase Q's paths and the steps of each profile (an eager
# profile's thousands of events a step cost host seconds to read back).
SMOKE = {"mnist-svae": 10, "bigk-dp": 10, "full-head": 1, "vae": 20}


def profile_smoke(dev=None) -> dict:
    """``profile_path`` for each of ``SMOKE``'s paths on both routes, in one
    short process (``dev`` cuda:0 by default): {"eager" | "graphed": {path:
    profile}}."""
    dev = torch.device("cuda", 0) if dev is None else dev
    return {route: {path: profile_path(dev, PATHS.index(path), graphed, steps)
                    for path, steps in SMOKE.items()}
            for graphed, route in ((0, "eager"), (1, "graphed"))}


def fresh(func: str, *args: int) -> dict:
    """``svax_torch.measure_graphs.<func>(cuda:0, *args)`` in a fresh
    process from this checkout, its result read from its last RESULT line."""
    code = ("import json, sys, torch\n"
            "from svax_torch import measure_graphs as mod\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False\n"
            "a = [int(v) for v in sys.argv[2:]]\n"
            "print('RESULT ' + json.dumps(getattr(mod, sys.argv[1])("
            "torch.device('cuda', 0), *a)))\n")
    out = subprocess.run([sys.executable, "-c", code, func, *map(str, args)],
                         cwd=Path(__file__).resolve().parents[1], capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{func}{args} in a fresh process exited {out.returncode}:\n"
                           f"{out.stderr[-4000:]}")
    return json.loads([ln for ln in out.stdout.splitlines()
                       if ln.startswith("RESULT ")][-1][len("RESULT "):])


# A train_svae run in a fresh process from the checkout ``sys.argv[1]``,
# printing the sha256 of its final state's bytes (each tensor's, then each
# int's): the same text runs against this tree's package and an older one's.
DIGEST = """
import hashlib, json, sys, torch
sys.path.insert(0, sys.argv[1])
from svax_torch import train_svae
out = train_svae.main(json.loads(sys.argv[2]))
h = hashlib.sha256()
def walk(v):
    if isinstance(v, dict):
        for k in v:
            walk(v[k])
    elif isinstance(v, (tuple, list)):
        for u in v:
            walk(u)
    elif torch.is_tensor(v):
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    else:
        h.update(repr(v).encode())
walk(out["state"])
print("RESULT " + json.dumps(h.hexdigest()))
"""


def state_digest(tree: Path, argv: list[str]) -> str:
    """``train_svae.main(argv)`` run from ``tree`` in a fresh process: the
    sha256 of its final state."""
    out = subprocess.run([sys.executable, "-c", DIGEST, str(tree.resolve()), json.dumps(argv)],
                         cwd=tree, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: {argv} exited {out.returncode}:\n{out.stderr[-4000:]}")
    return json.loads([ln for ln in out.stdout.splitlines()
                       if ln.startswith("RESULT ")][-1][len("RESULT "):])


def parent_digests(parent: Path, card: str) -> None:
    """mnist-svae and bigk-dp (100 steps, a 50-step warmup: the combine's
    in-kernel ε, the fused MLP decoder) through ``train_svae`` on the
    parent's eager loop and on this tree's eager loop and graph: the final
    states' digests, which the device word must leave equal."""
    here = Path(__file__).resolve().parents[1]
    for config in ("mnist-svae", "bigk-dp"):
        argv = ["--config", config, "--steps", "100", "--warmup-steps", "50",
                "--iw-samples", "0", "--device", "cuda"]
        got = {"parent eager": state_digest(parent, argv),
               "eager": state_digest(here, [*argv, "--no-graph"]),
               "graphed": state_digest(here, argv)}
        print(f"{config} final state sha256 (100 steps after a 50-step warmup): "
              + ", ".join(f"{k} {v[:16]}" for k, v in got.items())
              + f"; all equal {len(set(got.values())) == 1}; {card}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def entry_rates(card: str) -> None:
    """The entries on both routes, in turns: train_svae at mnist-svae and
    bigk-dp (200 steps, no warmup) and train_gmm --engine plain
    --fused-kernel (pinwheel-gmm, 2,000 steps)."""
    from svax_torch import train_gmm, train_svae

    runs = {
        "mnist-svae": lambda g: train_svae.main(
            ["--config", "mnist-svae", "--steps", "200", "--warmup-steps", "0",
             "--iw-samples", "0", "--device", "cuda", *g])["steps_per_s"],
        "bigk-dp": lambda g: train_svae.main(
            ["--config", "bigk-dp", "--steps", "200", "--warmup-steps", "0",
             "--iw-samples", "0", "--device", "cuda", *g])["steps_per_s"],
        "gmm-fused": lambda g: train_gmm.main(
            ["--config", "pinwheel-gmm", "--engine", "plain", "--fused-kernel",
             "--steps", "2000", "--eval-every", "500", "--device", "cuda", *g])["steps_per_s"],
    }
    for name, run in runs.items():
        got = {"eager": [], "graphed": []}
        for route in ("eager", "graphed", "graphed", "eager"):
            got[route].append(run(["--no-graph"] if route == "eager" else []))
        print(f"entry {name}: steps/s eager {got['eager']}, graphed {got['graphed']}; "
              f"{card}", flush=True)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=200, help="steps a timed chunk")
    p.add_argument("--paths", nargs="+", default=list(PATHS), choices=PATHS)
    p.add_argument("--no-entries", action="store_true", help="skip the entries' rates")
    p.add_argument("--parent", type=Path, default=None,
                   help="an older checkout: its eager train_svae runs' final states "
                        "against this tree's eager and graphed runs (digests)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("measure_graphs needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if args.parent is not None:
        parent_digests(args.parent, card)
    for path in args.paths:
        # The slow eager paths get fewer steps.
        steps = max(10, args.steps // 10) if path in ("full-head", "sampled") else args.steps
        eq = equal_routes(dev, path, (steps - steps // 4, steps // 4))
        r = rates(dev, path, steps)
        print(f"{path}: graphed == eager bit for bit over {steps} steps in two chunks "
              f"{eq['equal']} ({eq['captures']} capture); steps/s eager "
              f"{r['eager']}, graphed {r['graphed']}; capture {r['capture_s']:.3f} s, "
              f"{r['pool_bytes']} bytes reserved; {card}", flush=True)
        i = PATHS.index(path)
        for graphed in (0, 1):
            prof = fresh("profile_path", i, graphed, steps)
            print(f"{path} {'graphed' if graphed else 'eager'} profile ({steps} steps, "
                  f"fresh process): {prof['steps_per_s']:.2f} steps/s, wall "
                  f"{prof['wall_ms']:.4f} ms, device {prof['device_ms']:.4f} ms a step, idle "
                  f"{100 * prof['idle']:.2f}%; {card}", flush=True)
    if not args.no_entries:
        entry_rates(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
