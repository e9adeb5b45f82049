"""Train the Student-t mixture (SMM) baseline on pinwheel with the port
(PyTorch + the mixstep CUDA kernel).

    python -m svax_torch.train_smm [--dof 4] [--outliers M] [--init kmeanspp]
        [--device cuda|cpu] [--engine kernel|plain] [--unroll U]
        [--eval-every E] [--steps N] [--seed S] [--batch-size M] [--plot PATH]

Mirrors experiments/train_smm.py with constant ρ; the engines, ``--unroll``
and the dtype are as in ``svax_torch.train_gmm``. ``--batch-size M`` (0 =
the full batch) trains the plain engine on M rows a step drawn without
replacement from a generator seeded ``--seed + 1``, as ``train_gmm``
draws them; mixstep, the kernel engine, trains on the full batch and
refuses a minibatch with its reason.
``--outliers M`` appends M gross outliers (50·N(0, I), numpy-seeded as the
reference does). Prints one JSON row per evaluation (step, elbo), then
steps/sec. ``--plot PATH`` writes the training data coloured by the
Student-t E-step's cluster with the components' ellipses (it needs
matplotlib). ``--device cuda`` without a CUDA device raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from svax_torch.train_gmm import add_common_flags, setup
from svax_torch.utils import viz


def main(argv: list[str] | None = None) -> dict:
    """Run the trainer; returns {"state", "rows", "steps_per_s"}."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(p)
    p.add_argument("--outliers", type=int, default=0, help="inject M gross outliers")
    p.add_argument("--dof", type=float, default=4.0,
                   help="Student-t degrees of freedom")
    p.add_argument("--batch-size", type=int, default=0,
                   help="rows a step, drawn without replacement (0 = full batch; "
                        "plain engine)")
    args = p.parse_args(argv)
    if args.dof <= 0.0:
        p.error("--dof must be > 0")
    viz.check_available(args.plot)

    from svax_torch.data.pinwheel import load_pinwheel
    import torch

    from svax_torch.models import smm_baseline
    from svax_torch.train.loop import make_mixture_runner, run_mixture
    from svax_torch.train_gmm import minibatch_step

    train, _ = load_pinwheel(num_classes=args.num_classes,
                             num_per_class=args.num_per_class, seed=args.seed)
    if args.outliers:
        rng = np.random.default_rng(args.seed)
        train = np.concatenate([train, rng.standard_normal((args.outliers, 2)) * 50.0])
    device, _, prior, x_train, nat = setup(args, train)
    n = x_train.shape[0]
    batch = args.batch_size if 0 < args.batch_size < n else n
    state = smm_baseline.SmmTrainState(nat=nat, step=0)
    print(f"device={device} n={n} batch={batch} K={args.num_components} dof={args.dof} "
          f"engine={args.engine} unroll={args.unroll}")

    rows = []

    def emit(t, st, elbo):
        rows.append({"step": t, "elbo": elbo})
        print(json.dumps(rows[-1]), flush=True)

    if args.engine == "kernel":
        kw = {"runner": make_mixture_runner(prior, rho=args.rho, dof=args.dof,
                                            unroll=args.unroll)}
    else:
        step = smm_baseline.make_train_step(prior, args.rho, num_total=n, dof=args.dof)
        if batch < n:
            gen = torch.Generator(device=device).manual_seed(args.seed + 1)
            step = minibatch_step(step, x_train, batch, gen)
        kw = {"step": step}
    state, seconds = run_mixture(state, x_train, steps=args.steps,
                                 eval_every=args.eval_every, emit=emit, **kw)
    rate = args.steps / seconds
    print(f"steps/sec: {rate:.1f}")
    if args.plot:
        from svax_torch.pgm import gmm, smm

        resp, _, _ = smm.e_step_obs(x_train, gmm.expected_params(state.nat), args.dof)
        viz.plot_gmm_clusters(x_train, resp, state.nat, args.plot,
                              title=f"pinwheel SMM K={args.num_components} dof={args.dof}")
        print(f"wrote {args.plot}")
    return {"state": state, "rows": rows, "steps_per_s": rate}


if __name__ == "__main__":
    main()
