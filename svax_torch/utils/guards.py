"""Numerical guards: NaN/Inf detection for the Cholesky-heavy paths
(``svax/utils/guards.py``).

Near-singular Σ̃ early in SVAE training is the classic failure. Three tools:

* ``enable_nan_debugging()`` — turns on autograd's anomaly mode (the first
  backward that makes a NaN raises, with the forward's traceback) and the
  flag ``nan_debugging()`` that the trainer and the entries read. Anomaly
  mode does not see a NaN that a CUDA kernel writes, so under the flag the
  trainer and the entries also call ``assert_finite`` on the state and the
  metrics after every chunk: one host sync a chunk, for debug runs only.
* ``assert_finite(tree, name)`` — a host-side check that names the first
  non-finite leaf by its path.
* ``count_nonfinite(tree)`` — the count of non-finite elements as a tensor
  on the leaves' device, with no host sync.
"""

from __future__ import annotations

import math

import torch

from svax_torch.utils.tree import flatten

_debug_nans = False


def enable_nan_debugging() -> None:
    global _debug_nans
    torch.autograd.set_detect_anomaly(True)
    _debug_nans = True


def nan_debugging() -> bool:
    """Whether ``enable_nan_debugging`` was called in this process."""
    return _debug_nans


def assert_finite(tree, name: str = "tree") -> None:
    """Raise FloatingPointError naming the first leaf of ``tree`` with a
    NaN or an infinity (blocks; for debug cadences only)."""
    for path, leaf in flatten(tree):
        if isinstance(leaf, torch.Tensor):
            ok = not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
        elif isinstance(leaf, float):
            ok = math.isfinite(leaf)
        else:
            continue
        if not ok:
            raise FloatingPointError(f"non-finite values in {name}.{path}")


def count_nonfinite(tree) -> torch.Tensor:
    """Non-finite elements across the floating-point tensor leaves of
    ``tree``: a 0-d int64 tensor on their device (no host sync)."""
    counts = [(~torch.isfinite(t)).sum() for _, t in flatten(tree)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not counts:
        return torch.zeros((), dtype=torch.int64)
    return torch.stack(counts).sum()
