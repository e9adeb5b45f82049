"""Named experiment configs — the port's copy of ``configs/__init__.py``.

The five configs the port runs (BASELINE configs #1–#5), each a plain dict
of CLI-flag defaults, and ``apply_config``, which overlays one onto parsed
arguments with explicit flags winning. The entries read these and never the
reference's module; tests/test_torch_data.py pins every entry equal to the
original. The values' provenance (measured chunk sizes, precision A/Bs,
the anti-collapse warmup) is documented beside the original.
"""

from __future__ import annotations

import argparse
import sys

CONFIGS: dict[str, dict] = {
    "pinwheel-svae": dict(
        dataset="pinwheel",
        num_components=10,
        latent_dim=2,
        num_samples=4,
        encoder_hidden=[50, 50],
        decoder_hidden=[50, 50],
        steps=15000,
        batch_size=0,
        lr=1e-3,
        rho=0.05,
        alpha=1.0,
        kappa=0.05,
        aug_noise=0.4,
        scan_chunk=1000,
        engine="auto",
        nn_precision="default",
    ),
    "pinwheel-gmm": dict(
        num_components=10,
        steps=300,
        batch_size=0,
        rho=1.0,
        alpha=1.0,
        kappa=0.05,
    ),
    "auto-svae": dict(
        dataset="auto",
        num_components=10,
        latent_dim=4,
        num_samples=4,
        encoder_hidden=[100, 100],
        decoder_hidden=[100, 100],
        steps=10000,
        batch_size=64,
        lr=1e-3,
        rho=0.2,
        rho_decay=0.001,
        alpha=1.0,
        kappa=0.05,
        scan_chunk=500,
        engine="auto",
        nn_precision="default",
    ),
    "mnist-svae": dict(
        dataset="mnist",
        num_components=10,
        latent_dim=8,
        num_samples=1,
        encoder_hidden=[200, 200],
        decoder_hidden=[200, 200],
        steps=20000,
        batch_size=256,
        lr=1e-3,
        rho=0.1,
        rho_decay=0.001,
        alpha=1.0,
        kappa=0.05,
        warmup_steps=1000,
        scan_chunk=200,
        nn_compute_dtype="bfloat16",
        fused_combine=True,
        kernel_rng=True,
    ),
    "bigk-dp": dict(
        dataset="mnist",
        num_components=100,
        latent_dim=10,
        num_samples=1,
        encoder_hidden=[200, 200],
        decoder_hidden=[200, 200],
        steps=5000,
        batch_size=1024,
        lr=1e-3,
        warmup_steps=1000,
        rho=0.1,
        rho_decay=0.001,
        alpha=0.5,
        kappa=0.05,
        dp=True,
        scan_chunk=100,
        nn_compute_dtype="bfloat16",
        fused_combine=True,
        fused_mlp_decoder=True,
        kernel_rng=True,
    ),
}


def _explicit_dests(parser: argparse.ArgumentParser, argv) -> set[str]:
    """Dests the user actually typed: a re-parse with every default set to
    ``argparse.SUPPRESS`` leaves only the explicit flags in the namespace."""
    saved = [(a, a.default) for a in parser._actions]
    try:
        for a in parser._actions:
            a.default = argparse.SUPPRESS
        ns, _ = parser.parse_known_args(argv)
        return set(vars(ns))
    finally:
        for a, d in saved:
            a.default = d


def apply_config(args, parser: argparse.ArgumentParser, argv=None) -> None:
    """Overlay the named config onto argparse results, CLI flags winning.

    ``argv`` must be the argument list ``args`` was parsed from (defaults
    to ``sys.argv[1:]``)."""
    if not getattr(args, "config", None):
        return
    explicit = _explicit_dests(parser, sys.argv[1:] if argv is None else argv)
    for key, value in CONFIGS[args.config].items():
        dest = key.replace("-", "_")
        if hasattr(args, dest) and dest not in explicit:
            setattr(args, dest, value)
