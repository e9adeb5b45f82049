"""Latent-contamination demo: the SMM update rule's end-to-end win case
(``experiments/latent_contamination_demo.py``).

    python -m svax_torch.latent_contamination_demo [--pretrain-steps 15000]
        [--online-steps 500] [--batch 400] [--rho 0.05] [--outlier-fraction 0.25]
        [--box 30] [--dof 4] [--smm-iters 2] [--aug-noise 0.4] [--iw-samples 1000]
        [--seed 0] [--scan-chunk 1000] [--activation tanh|relu]
        [--json runs/latent_contamination_torch.json] [--device cuda|cpu]

1. Pretrain the GMM-prior SVAE on the clean pinwheel (the shipped recipe:
   400 points, K = 10, S = 4, 50-50, σ = 0.4 augmentation) and freeze the
   nets, as a deployed encoder and decoder are.
2. Build two streams of ``--online-steps`` batches: fresh pinwheel draws,
   and the same draws with their last ``--outlier-fraction`` rows replaced
   by uniform-box outliers (±``--box``; the pinwheel spans about ±17), from
   one numpy generator consumed in the reference's order, so both streams
   equal the reference's bit for bit (``make_streams``).
3. Adapt the PGM online with CVI-only steps from the same initial naturals
   under two update rules: the GMM rule (``gmm_online``: the SIN combine's
   responsibilities and latent moments) and the SMM rule (``smm_online``:
   the u–z combine with u-weighted moments, dof ``--dof``; E[u] =
   (a₀ + d/2)/(b₀ + Q/2) downweights a large latent quadratic Q). The
   online loop runs on the device — on the card one captured step replayed
   as a CUDA graph (``run_online``) — and the SMM rule's per-step E[u] is
   stacked there and read once.
4. Score the CLEAN held-out set under each adapted PGM with the same frozen
   nets and the same importance-weighted bound (``--iw-samples``, one
   generator seed for every row): the pretrained naturals, both rules on
   the contaminated stream, and both on the clean stream (the controls).

Prints one JSON summary, the reference artifact's keys, then the wall
seconds of the pretraining, the online phase and the IW bounds, and writes
the summary to ``--json`` (never a reference artifact in ``runs/``:
``utils.runs.port_artifact``). The pretraining goes through
``train.loop.train_chosen``: tinystep's f32 mode with in-kernel
augmentation for tanh nets, the per-step engine for relu. On CPU tensors
the kernel runs its plain version; ``--device cuda`` (the default) raises
without a card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

LR, HIDDEN, K = 1e-3, (50, 50), 10
DEFAULT_JSON = "runs/latent_contamination_torch.json"


def make_streams(seed: int, online_steps: int, batch: int, outlier_fraction: float,
                 box: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(clean, contaminated, outlier mask): the (T, batch, 2) float32 clean
    stream of fresh pinwheel draws, the same with its last rows replaced by
    Uniform([−box, box]²) outliers, and the (batch,) float32 mask of those
    rows, from ``np.random.default_rng(seed + 1)`` drawn in the reference's
    order (latent_contamination_demo.py:126-146)."""
    from svax_torch.data.pinwheel import make_pinwheel_data

    rng = np.random.default_rng(seed + 1)
    n_out = int(round(outlier_fraction * batch))
    n_clean = batch - n_out

    def fresh_clean(count):
        per = count // 5 + 1
        d_ = make_pinwheel_data(num_per_class=per, seed=int(rng.integers(1 << 31)))
        idx = rng.permutation(d_.shape[0])[:count]
        return d_[idx]

    clean = np.stack([fresh_clean(batch) for _ in range(online_steps)]).astype(np.float32)
    contam = clean.copy()
    contam[:, n_clean:, :] = rng.uniform(-box, box,
                                         size=(online_steps, n_out, 2)).astype(np.float32)
    mask = np.zeros((batch,), np.float32)
    mask[n_clean:] = 1.0
    return clean, contam, mask


def _encode(nn: dict, xb: torch.Tensor, config):
    from svax_torch.nets import mlp as nets

    return nets.encoder_apply(nn["encoder"], xb, config.activation, config.nn_precision)


def gmm_online(nat, xb: torch.Tensor, *, nn: dict, prior, config, rho: float,
               scale: float):
    """One CVI step of the GMM rule on batch ``xb`` with the frozen nets
    ``nn``: the SIN combine's responsibilities and latent moments
    (``gmm.suff_stats_from_moments``, scaled by ``scale``) into
    ``natgrad.cvi_update``. Returns (naturals, 1): the responsibility-
    weighted E[u] is 1 by definition under this rule."""
    from svax_torch.models import svae
    from svax_torch.pgm import gmm, natgrad

    pot_h, pot_p = _encode(nn, xb, config)
    post = svae.sin_combine(pot_h, pot_p, gmm.expected_params(nat), jitter=config.jitter)
    resp = torch.exp(post.log_resp)
    ezz = post.cov + post.mean[..., :, None] * post.mean[..., None, :]
    stats = gmm.suff_stats_from_moments(resp, post.mean, ezz, scale)
    nat = natgrad.cvi_update(nat, prior, gmm.stats_to_nat(stats), rho)
    return nat, torch.ones((), device=xb.device, dtype=xb.dtype)


def smm_online(nat, xb: torch.Tensor, *, nn: dict, prior, config, rho: float,
               scale: float, dof: float, smm_iters: int):
    """One CVI step of the SMM rule: the u–z combine
    (``svae_smm.smm_combine``, ``smm_iters`` rounds at ``dof``) and its
    u-weighted latent moments (``svae_smm.suff_stats_latent``) into
    ``natgrad.cvi_update``. Returns (naturals, the (N,) per-point E[u] =
    Σₖ r̃ₙₖ·E[uₙₖ])."""
    from svax_torch.models import svae_smm
    from svax_torch.pgm import gmm, natgrad, smm

    pot_h, pot_p = _encode(nn, xb, config)
    post, _ = svae_smm.smm_combine(pot_h, pot_p, gmm.expected_params(nat), dof, smm_iters,
                                   jitter=config.jitter)
    stats = svae_smm.suff_stats_latent(post, scale)
    nat = natgrad.cvi_update(nat, prior, smm.stats_to_nat(stats), rho)
    return nat, (torch.exp(post.log_resp) * post.e_u).sum(dim=-1)


@torch.no_grad()
def run_online(rule, nat0, stream: torch.Tensor, engine=None):
    """``rule(nat, xb)`` over the (T, batch, 2) ``stream`` from ``nat0``:
    (final naturals, the T rule outputs stacked on the device).

    ``engine`` (a ``train.graph.ChunkGraph``) captures
    one step — the naturals the state, the stream the stacked input, the
    rule's output the metric — and replays it T times, as the reference's
    ``jax.jit(lax.scan)`` runs the rule (latent_contamination_demo.py:182);
    None runs the eager loop."""
    if engine is not None:
        nat, mets = engine.run(nat0, stream.shape[0], {"xb": stream},
                               lambda st, rows, g, w: _metric(rule(st, rows["xb"])),
                               key=(rule,))
        return nat, mets["aux"]
    nat, aux = nat0, []
    for xb in stream:
        nat, a = rule(nat, xb)
        aux.append(a)
    return nat, torch.stack(aux)


def _metric(out):
    nat, aux = out
    return nat, {"aux": aux}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pretrain-steps", type=int, default=15000)
    p.add_argument("--online-steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=400)
    p.add_argument("--rho", type=float, default=0.05)
    p.add_argument("--outlier-fraction", type=float, default=0.25)
    p.add_argument("--box", type=float, default=30.0,
                   help="outliers ~ Uniform([-box, box]^2); the pinwheel spans ~±17")
    p.add_argument("--dof", type=float, default=4.0)
    p.add_argument("--smm-iters", type=int, default=2)
    p.add_argument("--aug-noise", type=float, default=0.4)
    p.add_argument("--iw-samples", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scan-chunk", type=int, default=1000)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--activation", choices=["tanh", "relu"], default="tanh",
                   help="hidden activation of both nets: tanh saturates, so far "
                        "outliers reach the latent space compressed; relu passes "
                        "magnitudes through")
    p.add_argument("--json", type=str, default=DEFAULT_JSON)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Run the demo; returns the printed dict plus "kernel" (the
    pretraining's engine) and "seconds" (pretraining, online, IW)."""
    import time
    from functools import partial

    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (use --device cpu)")
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.models import evaluation
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import graph as cuda_graph
    from svax_torch.train import loop, svae_step
    from svax_torch.utils.runs import port_artifact, write_json

    if args.json:
        port_artifact(args.json)  # refuse a reference artifact before any work
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    seconds = {}  # each part ends in a host read, so its wall time is its own

    # 1. Pretrain on the clean pinwheel, then freeze the nets.
    t0 = time.perf_counter()
    train, test = load_pinwheel(seed=args.seed)
    x = torch.tensor(train, dtype=torch.float32, device=device)
    x_test = torch.tensor(test, dtype=torch.float32, device=device)
    n = x.shape[0]
    config = SvaeConfig(latent_dim=2, num_components=K, num_samples=4, num_total=n,
                        activation=args.activation)
    prior = gmm.make_prior(K, 2, kappa=0.05, device=device)
    state = svae_step.init_state(torch.Generator(device=device).manual_seed(args.seed), 2,
                                 config, prior, HIDDEN, HIDDEN, data=x)
    steps = max(args.pretrain_steps // args.scan_chunk, 1) * args.scan_chunk
    state, metrics, kernel = loop.train_chosen(
        state, config, prior, x, steps, lr=LR, rho=args.rho, hidden=HIDDEN,
        aug_noise=args.aug_noise, seed=args.seed, chunk=args.scan_chunk)
    elbo0 = float(metrics["elbo"][-1]) / n
    nn, nat0 = state.nn_params, state.pgm_nat
    seconds["pretrain"] = time.perf_counter() - t0

    # 2. The streams.
    clean_np, contam_np, mask_np = make_streams(args.seed, args.online_steps, args.batch,
                                                args.outlier_fraction, args.box)
    clean = torch.tensor(clean_np, device=device)
    contam = torch.tensor(contam_np, device=device)

    # 3. Online CVI-only adaptation with the frozen nets.
    t0 = time.perf_counter()
    common = dict(nn=nn, prior=prior, config=config, rho=args.rho,
                  scale=float(config.num_total) / args.batch)
    gmm_rule = partial(gmm_online, **common)
    smm_rule = partial(smm_online, **common, dof=args.dof, smm_iters=args.smm_iters)
    # One engine a rule (a CUDA graph on the card): the clean stream replays
    # the contaminated one's graph.
    online_route = cuda_graph.route(device)
    engines = {rule: cuda_graph.engines(None)(device) for rule in (gmm_rule, smm_rule)}
    nat_gmm, _ = run_online(gmm_rule, nat0, contam, engines[gmm_rule])
    nat_smm, e_u_tr = run_online(smm_rule, nat0, contam, engines[smm_rule])
    nat_gmm_clean, _ = run_online(gmm_rule, nat0, clean, engines[gmm_rule])
    nat_smm_clean, _ = run_online(smm_rule, nat0, clean, engines[smm_rule])
    # Mechanism: mean E[u] on clean and outlier stream rows over the second
    # half of the online phase (one host read).
    e_u_tr = e_u_tr.cpu().numpy()[args.online_steps // 2:]
    seconds["online"] = time.perf_counter() - t0
    n_out = int(mask_np.sum())
    e_u_clean = float((e_u_tr * (1 - mask_np)).sum()
                      / ((1 - mask_np).sum() * e_u_tr.shape[0]))
    e_u_out = float((e_u_tr * mask_np).sum() / (mask_np.sum() * e_u_tr.shape[0])) \
        if n_out else float("nan")

    # 4. The clean test set under each adapted PGM.
    t0 = time.perf_counter()

    def iw(nat) -> float:
        gen = torch.Generator(device=device).manual_seed(args.seed + 2)
        return float(evaluation.svae_iw_loglik(
            nn, nat, x_test, args.iw_samples, generator=gen, likelihood=config.likelihood,
            activation=config.activation).mean())

    rows = {
        "pretrained": iw(nat0),
        "gmm_rule_contaminated": iw(nat_gmm),
        "smm_rule_contaminated": iw(nat_smm),
        "gmm_rule_clean_control": iw(nat_gmm_clean),
        "smm_rule_clean_control": iw(nat_smm_clean),
    }
    seconds["iw"] = time.perf_counter() - t0
    results = {
        "config": vars(args),
        "pretrain_final_train_elbo_per_point": elbo0,
        "clean_test_iw_per_point": rows,
        "smm_win_nats": rows["smm_rule_contaminated"] - rows["gmm_rule_contaminated"],
        "mean_e_u_second_half": {"clean_rows": e_u_clean, "outlier_rows": e_u_out},
    }
    print(json.dumps(results, indent=1), flush=True)
    print("seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()), flush=True)
    print(f"online route: {online_route}", flush=True)
    if args.json:
        write_json(args.json, results)
    return {**results, "kernel": kernel, "seconds": seconds, "online_graph": online_route}


if __name__ == "__main__":
    main()
