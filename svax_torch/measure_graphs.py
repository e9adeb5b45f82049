"""The graphed runners against the eager loop on one CUDA card.

    python -m svax_torch.measure_graphs [--steps N] [--paths P ...] [--no-entries]
        [--parent DIR] > chiprun_out/graphs.txt
    python -m svax_torch.measure_graphs --calls [eval serve online entries] > chiprun_out/calls.txt

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

``--calls`` measures the one-call graphs (``train.graph.CallGraph``)
instead: for each of ``EVAL_PATHS`` the held-out evaluation eager and
graphed in turns over 5 calls with the state moving between them (four
terms bit-equal, launch counts equal, ms a call, capture seconds, pool
bytes; one profile a route in a fresh process); the serving endpoints at
mnist-svae's width, GMM and Student-t priors, live and exported, at
buckets 32 and 512 and a request of two 512-row pieces (bit-equal; ms a
request in turns); the latent demo's online rules over 500 steps
(bit-equal, ms a step); and the mnist-svae and bigk-dp entries' steps/s
with each row's evaluation, ``--no-graph`` against the default.
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


def _svae_parts(dev, name: str, **switches) -> tuple:
    """(config, prior, state, x_train, the config's dict) for the named
    config at its full width, seeded weights and data."""
    from svax_torch.configs import CONFIGS
    from svax_torch.data import load_dataset
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step

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
    return config, prior, state, x, cfg


def _svae_setup(dev, name: str, graph, **switches):
    from svax_torch.train import loop

    config, prior, state, x, cfg = _svae_parts(dev, name, **switches)
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


# The held-out evaluation's paths (``svae_step.make_eval_fn`` as
# ``train_svae`` builds it): the kernel engine at mnist-svae (the combine
# forward, in-kernel ε keyed {seed, step}), at bigk-dp (and the fused MLP
# decoder), at the big-K f32 config (the row sum under --fused-decoder),
# and the plain engine at mnist-svae (the plain combine, ε drawn from a
# fresh generator each call, as the entry's rows do).
EVAL_PATHS = ("mnist-svae", "bigk-dp", "bigk-f32", "mnist-plain")


def eval_setup(dev, path: str) -> tuple:
    """(evaluators {graph: evaluate}, noise() → one call's keyword
    arguments, state, chunk(state, T) → state, x_test) for ``path``: the
    evaluation eager (graph False) and graphed (None), the entry's noise
    (``seed=1``, or a generator seeded 1), and the path's graphed runner."""
    from svax_torch.data import load_dataset
    from svax_torch.train import loop, svae_step

    name = "mnist-svae" if path.startswith("mnist") else "bigk-dp"
    switches = (dict(nn_compute_dtype="float32", fused_mlp_decoder=False, fused_decoder=True)
                if path == "bigk-f32" else {})
    config, prior, state, x, cfg = _svae_parts(dev, name, **switches)
    _, test, _ = load_dataset(cfg["dataset"], seed=0)
    x_test = torch.tensor(test, dtype=torch.float32, device=dev)
    run = loop.make_step_runner(config, prior, lr=cfg["lr"], rho=cfg["rho"],
                                rho_decay=cfg["rho_decay"], batch_size=cfg["batch_size"],
                                replace=not cfg.get("dp", False))
    if path == "mnist-plain":
        config = config._replace(fused_combine=False, kernel_rng=False,
                                 fused_mlp_decoder=False, fused_decoder=False)
    evaluators = {g: svae_step.make_eval_fn(config, prior, graph=g) for g in (False, None)}
    if svae_step.kernel_draws_eps(config):
        def noise():
            return {"seed": 1}
    else:
        def noise():
            return {"generator": torch.Generator(device=dev).manual_seed(1)}
    return evaluators, noise, state, (lambda st, t: run(st, x, t, seed=0)[0]), x_test


def eval_routes(dev, path: str, calls: int = 5) -> dict:
    """``calls`` evaluations of ``path`` on both routes in turns (eager,
    graphed), the state moved 10 graphed train steps between calls (its
    tensors and its step change): whether every call's four terms are
    bit-equal, whether each call's kernel launch counts are the same on
    both routes, the graphed route's launches summed over its calls
    ({"module.counter": n}), ms a call of each route (median; the host read
    of the ELBO included, as the entry reads it; the graph's calls after
    its capture), the captures, capture seconds and pool bytes."""
    from svax_torch.train import graph as cuda_graph

    evaluators, noise, state, chunk, x_test = eval_setup(dev, path)
    equal, counts_equal, total = True, True, {}
    times = {False: [], None: []}
    for i in range(calls):
        state = chunk(state, 10)
        outs, counts = {}, {}
        for g in (False, None):
            torch.cuda.synchronize(dev)
            before = cuda_graph.launch_counts()
            t0 = time.perf_counter()
            outs[g] = evaluators[g](state, x_test, **noise())
            float(outs[g]["elbo_per_point"])
            if g is False or i > 0:
                times[g].append(time.perf_counter() - t0)
            counts[g] = cuda_graph.count_increase(before, cuda_graph.launch_counts())
        equal = equal and same(outs[False], outs[None])
        counts_equal = counts_equal and counts[False] == counts[None]
        for (m, n), v in counts[None].items():
            if not isinstance(v, dict):
                total[f"{m}.{n}"] = total.get(f"{m}.{n}", 0) + v
    eng = evaluators[None].engine(dev)
    ms = {g: 1e3 * sorted(v)[len(v) // 2] for g, v in times.items()}
    return {"equal": equal, "counts_equal": counts_equal, "launches": total,
            "route": evaluators[None].route(dev), "captures": eng.captures,
            "capture_s": eng.capture_seconds, "pool_bytes": eng.pool_bytes,
            "eager_ms": ms[False], "graphed_ms": ms[None]}


def median_ms(call, repeats: int = 5) -> float:
    """Median wall ms of ``call()`` after a warm call (a server's endpoints
    return host arrays, so the time includes the device's work and the copy
    back)."""
    call()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return 1e3 * sorted(times)[len(times) // 2]


def _served_calls(srv, x, mask, exported: bool) -> dict:
    return {"encode": lambda: srv.encode(x), "reconstruct": lambda: srv.reconstruct(x),
            "impute": lambda: srv.impute(x, mask),
            "score": (lambda: srv.score(x, seed=3)) if exported else (
                lambda: srv.score(x, seed=3, num_samples=100))}


def serve_routes(dev, buckets=(32, 512), repeats: int = 5, work: Path | None = None,
                 dof: float = 0.0, exported: bool = True) -> dict:
    """The serving endpoints at mnist-svae's width (seeded weights; the
    Student-t prior with ``dof`` > 0), live and, with ``exported``, exported
    (``export_serving`` at ``buckets`` into ``work``, 100 score samples, 10
    impute rounds), eager (graph False) and graphed: whether each endpoint's answers are
    bit-equal at each bucket and on a request of two top-bucket pieces;
    with ``repeats`` > 0 each endpoint's wall ms a request at each bucket
    (median of ``repeats`` after a warm call, which captures); the graphs'
    captures, last capture seconds and pool bytes per tier."""
    import tempfile

    from svax_torch import serve
    from svax_torch.configs import CONFIGS
    from svax_torch.data import load_dataset
    from svax_torch.train import svae_step

    cfg = CONFIGS["mnist-svae"]
    train, _, meta = load_dataset(cfg["dataset"], seed=0)
    spec = serve.ModelSpec(input_dim=train.shape[1], latent_dim=cfg["latent_dim"],
                           num_components=cfg["num_components"], likelihood=meta["likelihood"],
                           encoder_hidden=tuple(cfg["encoder_hidden"]),
                           decoder_hidden=tuple(cfg["decoder_hidden"]),
                           num_samples=cfg["num_samples"], alpha=cfg["alpha"],
                           kappa=cfg["kappa"], num_total=train.shape[0], dof=dof)
    state = svae_step.init_state(torch.Generator(device=dev).manual_seed(0), spec.input_dim,
                                 spec.to_config(), spec.make_prior(dev), spec.encoder_hidden,
                                 spec.decoder_hidden)
    live = {g: serve.SvaeServer(state.nn_params, state.pgm_nat, spec, buckets=buckets,
                                device=dev, graph=g) for g in (False, None)}
    x = train.astype("float32")
    x = x[:2 * buckets[-1]] if x.shape[0] >= 2 * buckets[-1] else x[
        torch.arange(2 * buckets[-1]).remainder(x.shape[0]).numpy()]
    mask = (torch.arange(x.shape[1]) < x.shape[1] // 2).float().numpy()  # bottom half missing
    out = {"equal": {}, "ms": {}, "graphs": {}}
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        tiers = {"live": live}
        if exported:
            serve.export_serving(live[False], tmp, buckets=buckets)
            tiers["exported"] = {g: serve.load_exported(tmp, device=dev, graph=g)
                                 for g in (False, None)}
        for tier, servers in tiers.items():
            for n in (*buckets, 2 * buckets[-1]):
                rows = x[:n]
                calls = {g: _served_calls(srv, rows, mask, tier == "exported")
                         for g, srv in servers.items()}
                for name in calls[None]:
                    got = {g: c[name]() for g, c in calls.items()}
                    out["equal"][f"{tier} {name} {n}"] = _host_same(got[False], got[None])
                    if n in buckets and repeats > 0:  # in turns
                        ms = out["ms"][f"{tier} {name} {n}"] = {"eager": [], "graphed": []}
                        for g in (False, None, None, False):
                            ms["graphed" if g is None else "eager"].append(
                                median_ms(calls[g][name], repeats))
            eng = servers[None].graphs
            out["graphs"][tier] = {"route": servers[None].route, "captures": eng.captures,
                                   "capture_s": eng.capture_seconds,
                                   "pool_bytes": eng.pool_bytes}
    return out


def _host_same(a, b) -> bool:
    import numpy as np

    from svax_torch.utils.tree import flatten

    la, lb = [t for _, t in flatten(a)], [t for _, t in flatten(b)]
    return len(la) == len(lb) and all(np.array_equal(p, q) for p, q in zip(la, lb))


def online_routes(dev, steps: int = 500) -> dict:
    """The latent demo's online rules (``latent_contamination_demo``'s
    GMM and SMM rules at its defaults: K = 10, d = 2, 50-50 nets at seeded
    weights, batches of 400 of the contaminated stream, ρ = 0.05, dof 4,
    2 rounds) over ``steps`` steps, eager and through a ``ChunkGraph``, in
    turns (eager, graphed, graphed, eager; the graph's first run, its
    capture, untimed): whether the final naturals and the stacked outputs
    are bit-equal, ms a step of each route, capture seconds, pool bytes."""
    from functools import partial

    from svax_torch import latent_contamination_demo as lc
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import graph as cuda_graph
    from svax_torch.train import svae_step

    train, _ = load_pinwheel(seed=0)
    x = torch.tensor(train, dtype=torch.float32, device=dev)
    config = SvaeConfig(latent_dim=2, num_components=lc.K, num_samples=4, num_total=x.shape[0])
    prior = gmm.make_prior(lc.K, 2, kappa=0.05, device=dev)
    state = svae_step.init_state(torch.Generator(device=dev).manual_seed(0), 2, config, prior,
                                 lc.HIDDEN, lc.HIDDEN, data=x)
    _, contam, _ = lc.make_streams(0, steps, 400, 0.25, 30.0)
    stream = torch.tensor(contam, device=dev)
    common = dict(nn=state.nn_params, prior=prior, config=config, rho=0.05,
                  scale=float(x.shape[0]) / 400)
    rules = {"gmm": partial(lc.gmm_online, **common),
             "smm": partial(lc.smm_online, **common, dof=4.0, smm_iters=2)}
    out = {}
    for name, rule in rules.items():
        eng = cuda_graph.ChunkGraph()
        got = {None: lc.run_online(rule, state.pgm_nat, stream, eng)}  # the capture
        times = {False: [], None: []}
        for g in (False, None, None, False):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            got[g] = lc.run_online(rule, state.pgm_nat, stream, eng if g is None else None)
            torch.cuda.synchronize(dev)
            times[g].append(1e3 * (time.perf_counter() - t0) / steps)
        out[name] = {"equal": same(got[False], got[None]), "eager_ms": times[False],
                     "graphed_ms": times[None], "captures": eng.captures,
                     "capture_s": eng.capture_seconds, "pool_bytes": eng.pool_bytes}
    return out


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


def profile_eval(dev, index: int, graphed: int, calls: int = 5) -> dict:
    """EVAL_PATHS[index]'s evaluation on one route (``graphed`` 1: the
    graph; 0: eager) under torch.profiler: a warm call (the capture), then
    ``calls`` calls profiled, each read on the host as the entry reads its
    row; wall and device ms a call and the idle share."""
    from svax_torch.measure_mixture import device_us, profiled

    evaluators, noise, state, _, x_test = eval_setup(dev, EVAL_PATHS[index])
    evaluate = evaluators[None if graphed else False]
    float(evaluate(state, x_test, **noise())["elbo_per_point"])
    torch.cuda.synchronize(dev)

    def run():
        for _ in range(calls):
            float(evaluate(state, x_test, **noise())["elbo_per_point"])

    wall, prof = profiled(run)
    busy = device_us(prof) / 1e3
    if busy <= 0.0:
        raise RuntimeError(f"{EVAL_PATHS[index]}: the profile recorded no device time")
    return {"wall_ms": wall / calls, "device_ms": busy / calls, "idle": 1.0 - busy / wall}


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
    p.add_argument("--calls", nargs="*", choices=CALL_PARTS, default=None,
                   help="the one-call graphs instead of the runners: the evaluation, the "
                        "served endpoints, the online rules, the entries with evaluation "
                        "(all four without a value)")
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
    if args.calls is not None:
        calls_report(dev, card, args.calls or CALL_PARTS)
        return 0
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


CALL_PARTS = ("eval", "serve", "online", "entries")


def calls_report(dev, card: str, parts=CALL_PARTS) -> None:
    """The one-call graphs (``--calls``), each of ``parts``: the
    evaluation's paths, the served endpoints live and exported, the latent
    demo's online rules, the mnist-svae and bigk-dp entries with their
    evaluation."""
    from svax_torch import train_svae

    for i, path in enumerate(EVAL_PATHS if "eval" in parts else ()):
        r = eval_routes(dev, path)
        profs = {g: fresh("profile_eval", i, g) for g in (0, 1)}
        print(f"eval {path} ({r['route']}): graphed == eager bit for bit over 5 calls (the "
              f"state 10 steps on between calls) {r['equal']}, launch counts equal "
              f"{r['counts_equal']} (graphed, 5 calls: {r['launches']}); ms a call eager "
              f"{r['eager_ms']:.4f}, graphed {r['graphed_ms']:.4f}; {r['captures']} capture, "
              f"{r['capture_s']:.3f} s, {r['pool_bytes']} bytes reserved; profiled (5 calls, fresh process) eager "
              f"wall {profs[0]['wall_ms']:.4f} device {profs[0]['device_ms']:.4f} idle "
              f"{100 * profs[0]['idle']:.2f}%, graphed wall {profs[1]['wall_ms']:.4f} device "
              f"{profs[1]['device_ms']:.4f} idle {100 * profs[1]['idle']:.2f}%; {card}",
              flush=True)
    # The Student-t prior live only: its posterior's unrolled d = 8 solves
    # make tens of thousands of nodes an exported program, minutes to trace.
    for dof in (0.0, 4.0) if "serve" in parts else ():
        got = serve_routes(dev, dof=dof, exported=dof == 0.0)
        bad = [k for k, v in got["equal"].items() if not v]
        print(f"serve (mnist-svae width, dof {dof}): graphed == eager bit for bit at every "
              f"endpoint, tier and request (32, 512, 2 x 512) {not bad} {bad}; graphs "
              f"{json.dumps(got['graphs'])}; {card}", flush=True)
        for key, ms in got["ms"].items():
            print(f"serve dof {dof} {key}: ms a request (median of 5, host arrays back, in "
                  f"turns) eager {[round(v, 4) for v in ms['eager']]}, graphed "
                  f"{[round(v, 4) for v in ms['graphed']]}; {card}", flush=True)
    for rule, r in (online_routes(dev) if "online" in parts else {}).items():
        print(f"online {rule} rule (500 steps): graphed == eager bit for bit {r['equal']}; ms "
              f"a step eager {[round(v, 4) for v in r['eager_ms']]}, graphed "
              f"{[round(v, 4) for v in r['graphed_ms']]}; capture {r['capture_s']:.3f} s, "
              f"{r['pool_bytes']} bytes reserved; {card}", flush=True)
    for config in ("mnist-svae", "bigk-dp") if "entries" in parts else ():
        got = {"eager": [], "graphed": []}
        for route in ("eager", "graphed", "graphed", "eager"):
            out = train_svae.main(["--config", config, "--steps", "200", "--warmup-steps", "0",
                                   "--iw-samples", "0", "--device", "cuda",
                                   *(["--no-graph"] if route == "eager" else [])])
            got[route].append(out["steps_per_s"])
        print(f"entry {config} (200 steps, rows after steps 1 and 200, each row's test "
              f"evaluation): steps/s eager {got['eager']}, graphed {got['graphed']}; {card}",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
