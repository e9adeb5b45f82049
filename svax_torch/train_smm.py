"""Train the Student-t mixture (SMM) baseline on pinwheel with the port
(PyTorch + the mixstep CUDA kernel).

    python -m svax_torch.train_smm [--dof 4] [--outliers M] [--init kmeanspp]
        [--device cuda|cpu] [--engine kernel|plain] [--unroll U]
        [--eval-every E] [--steps N] [--seed S]

Mirrors experiments/train_smm.py on the full batch with constant ρ; the
engines, ``--unroll`` and the dtype are as in ``svax_torch.train_gmm``.
``--outliers M`` appends M gross outliers (50·N(0, I), numpy-seeded as the
reference does). Prints one JSON row per evaluation (step, elbo), then
steps/sec. ``--device cuda`` without a CUDA device raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from svax_torch.train_gmm import add_common_flags, setup


def main(argv: list[str] | None = None) -> dict:
    """Run the trainer; returns {"state", "rows", "steps_per_s"}."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(p)
    p.add_argument("--outliers", type=int, default=0, help="inject M gross outliers")
    p.add_argument("--dof", type=float, default=4.0,
                   help="Student-t degrees of freedom")
    args = p.parse_args(argv)
    if args.dof <= 0.0:
        p.error("--dof must be > 0")

    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.models import smm_baseline
    from svax_torch.train.loop import make_mixture_runner, run_mixture

    train, _ = load_pinwheel(num_classes=args.num_classes,
                             num_per_class=args.num_per_class, seed=args.seed)
    if args.outliers:
        rng = np.random.default_rng(args.seed)
        train = np.concatenate([train, rng.standard_normal((args.outliers, 2)) * 50.0])
    device, _, prior, x_train, nat = setup(args, train)
    n = x_train.shape[0]
    state = smm_baseline.SmmTrainState(nat=nat, step=0)
    print(f"device={device} n={n} K={args.num_components} dof={args.dof} "
          f"engine={args.engine} unroll={args.unroll}")

    rows = []

    def emit(t, st, elbo):
        rows.append({"step": t, "elbo": elbo})
        print(json.dumps(rows[-1]), flush=True)

    if args.engine == "kernel":
        kw = {"runner": make_mixture_runner(prior, rho=args.rho, dof=args.dof,
                                            unroll=args.unroll)}
    else:
        kw = {"step": smm_baseline.make_train_step(prior, args.rho, num_total=n,
                                                   dof=args.dof)}
    state, seconds = run_mixture(state, x_train, steps=args.steps,
                                 eval_every=args.eval_every, emit=emit, **kw)
    rate = args.steps / seconds
    print(f"steps/sec: {rate:.1f}")
    return {"state": state, "rows": rows, "steps_per_s": rate}


if __name__ == "__main__":
    main()
