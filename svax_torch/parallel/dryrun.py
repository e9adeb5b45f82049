"""The multi-process dry run: one sharded SVAE train step at three
geometries (``__graft_entry__._dryrun_impl``, :135-260).

    python -m svax_torch.parallel.dryrun [N] [--device cuda|cuda:0|cpu] [--backend nccl|gloo]

``dryrun_multichip(n, device, backend)`` spawns ``n`` ranks
(``mesh.spawn``) on a data × comp mesh — 2-way component sharding when n
is even and at least 4, else n-way data sharding — and takes one step of
each geometry. By default rank r runs on ``cuda:r`` over NCCL, so n ranks
need n cards; ``--device cuda:0 --backend gloo`` puts every rank on one
card, and ``--device cpu`` runs the plain versions on the CPU.

The geometries:

* toy: pinwheel, K = 4, latent d = 2, 8 points a data rank, (8,) MLPs;
* bigk: BASELINE config #5's widths, K = 100, latent d = 10, a Bernoulli
  decoder with a bf16 body on 64 random binary inputs, 16 points a data
  rank, (32, 32) MLPs; its combine is the fused one (``fused_combine``),
  so under component sharding it runs the ρ-kernel and the combine's
  log_norm mode (their CUDA kernels on CUDA, their plain versions on the
  CPU);
* smm: the toy geometry with the Student-t mixture prior (dof 4, 2 u–z
  rounds).

Every rank checks that its ELBO is finite; rank 0 gathers the K-shards of
the updated naturals and holds them to the single-process step on the
whole batch (the CVI update depends on no Monte-Carlo draw), to 1e-5 of
each leaf's largest entry in float32. It prints the reference's three
``ok`` lines. The fourth pass of the reference (the full-covariance
recognition head) waits for that head (ROADMAP.md slice J).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from svax_torch.parallel import mesh

NAT_TOL = 1e-5


def geometry(name: str, data: int, dev: torch.device):
    """(config, prior, state, x, hidden) of one geometry at the full K, on
    ``dev``, made from fixed seeds."""
    from svax_torch.data.pinwheel import make_pinwheel_data
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step

    gen = torch.Generator(device=dev).manual_seed(0 if name != "bigk" else 1)
    if name == "bigk":
        n, k, d, d_in, hidden = 16 * data, 100, 10, 64, (32, 32)
        config = SvaeConfig(latent_dim=d, num_components=k, num_samples=1, num_total=n,
                            likelihood="bernoulli", nn_compute_dtype="bfloat16",
                            fused_combine=True)
        prior = gmm.make_prior(k, d, alpha=0.5, kappa=0.05, device=dev)
        x = (torch.rand((n, d_in), generator=gen, device=dev) > 0.5).float()
        data_init = None
    else:
        n, k, d, hidden = 8 * data, 4, 2, (8,)
        config = SvaeConfig(latent_dim=d, num_components=k, num_samples=1, num_total=n,
                            dof=4.0 if name == "smm" else 0.0)
        prior = gmm.make_prior(k, d, device=dev)
        x = torch.tensor(make_pinwheel_data(num_classes=4, num_per_class=max(n // 4, 1),
                                            seed=0)[:n], dtype=torch.float32, device=dev)
        data_init = x
    state = svae_step.init_state(gen, x.shape[1], config, prior, hidden, hidden,
                                 data=data_init)
    return config, prior, state, x


def _nat_error(got, want) -> float:
    """max over leaves of max |got − want| / max |want|."""
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip([got.dir_nat, *got.niw_nat], [want.dir_nat, *want.niw_nat]))


def _rank(rank: int, world: int, dev: torch.device, data: int, comp: int) -> dict:
    from svax_torch import convert
    from svax_torch.ops import combine
    from svax_torch.train import svae_step

    m = mesh.make_data_comp_mesh(data, comp)
    out = {}
    for name in ("toy", "bigk", "smm"):
        config, prior, state, x = geometry(name, data, dev)
        prior_l = convert.shard_nat(prior, m.comp_idx, comp)
        state_l = state._replace(pgm_nat=convert.shard_nat(state.pgm_nat, m.comp_idx, comp))
        step = svae_step.make_train_step(config, prior_l, 1e-3, 0.1,
                                         data_group=m.data_group, comp_group=m.comp_group)
        per = x.shape[0] // data
        gen = torch.Generator(device=dev).manual_seed(mesh.fold_seed(0, m.data_idx, m.comp_idx))
        combine.rho_launches = combine.norm_launches = 0
        new, metrics = step(state_l, x[m.data_idx * per:(m.data_idx + 1) * per], generator=gen)
        launches = {"log_rho": combine.rho_launches, "combine_norm": combine.norm_launches}
        elbo = float(metrics["elbo"])
        if not np.isfinite(elbo):
            raise RuntimeError(f"non-finite {name} ELBO {elbo} in the dry run (rank {rank})")
        nat = convert.gather_nat(new.pgm_nat, m.comp_group)
        row = {"elbo": elbo, "batch": x.shape[0], "launches": launches}
        if rank == 0:
            single = svae_step.make_train_step(config, prior, 1e-3, 0.1)
            want, _ = single(state, x, generator=torch.Generator(device=dev).manual_seed(0))
            err = _nat_error(nat, want.pgm_nat)
            if not err < NAT_TOL:
                raise RuntimeError(f"{name}: sharded naturals differ from the single-process "
                                   f"step by {err:.3e} (> {NAT_TOL})")
            row["nat_err"] = err
        out[name] = row
    return out


def dryrun_multichip(n: int, device: str = "cuda", backend: str | None = None,
                     timeout: float = 120.0) -> dict:
    """Spawn ``n`` ranks, take one step of each geometry, print the three
    ``ok`` lines; returns rank 0's results per geometry (elbo, batch, the
    ρ-kernel and log_norm-combine launches, nat_err) and the mesh."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")
    comp = 2 if n % 2 == 0 and n >= 4 else 1
    data = n // comp
    results = mesh.spawn(_rank, n, device, backend, args=(data, comp), timeout=timeout)
    mode = f"{data}x{comp} data x comp" if comp > 1 else f"{n} data"
    r = results[0]
    print(f"dryrun_multichip({n}): ok ({mode} mesh), elbo={r['toy']['elbo']:.3f}")
    print(f"dryrun_multichip({n}): bigk ok (K=100, d=10, batch {r['bigk']['batch']}, "
          f"{mode} mesh), elbo={r['bigk']['elbo']:.3f}")
    print(f"dryrun_multichip({n}): smm ok (dof=4, {mode} mesh), elbo={r['smm']['elbo']:.3f}")
    return {"data": data, "comp": comp, "ranks": results, **r}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n", type=int, nargs="?", default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.backend)


if __name__ == "__main__":
    main()
