"""Datasets (numpy only): numpy copies of ``svax/data``'s pinwheel, UCI
Auto and MNIST loaders, and ``load_dataset`` over the workloads the port
runs."""

from __future__ import annotations

import numpy as np

from svax_torch.data.auto import load_auto
from svax_torch.data.mnist import load_mnist
from svax_torch.data.pinwheel import load_pinwheel


def load_dataset(name: str, seed: int = 0) -> tuple[np.ndarray, np.ndarray, dict]:
    """Uniform (train, test, meta) loader (``svax/data/__init__.py``)."""
    if name == "pinwheel":
        train, test = load_pinwheel(seed=seed)
        return train, test, {"likelihood": "gaussian", "synthetic": False}
    if name == "auto":
        return load_auto(seed=seed)
    if name == "mnist":
        return load_mnist(seed=seed)
    raise ValueError(f"unknown dataset {name!r}")
