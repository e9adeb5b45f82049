"""Pinwheel synthetic dataset — a numpy copy of ``svax/data/pinwheel.py``.

``import svax.data`` imports JAX through ``svax/__init__.py``, so the port
keeps its own copy; tests/test_torch_data.py pins it bit-equal to the
original.
"""

from __future__ import annotations

import numpy as np


def make_pinwheel_data(
    radial_std: float = 0.3,
    tangential_std: float = 0.05,
    num_classes: int = 5,
    num_per_class: int = 100,
    rate: float = 0.25,
    seed: int = 0,
    return_labels: bool = False,
):
    """Generate ((num_classes * num_per_class), 2) float64 pinwheel points.

    With ``return_labels=True`` also returns the ground-truth arm index per
    point.
    """
    rng = np.random.default_rng(seed)
    rads = np.linspace(0.0, 2.0 * np.pi, num_classes, endpoint=False)

    features = rng.standard_normal((num_classes * num_per_class, 2)) * np.array(
        [radial_std, tangential_std]
    )
    features[:, 0] += 1.0
    labels = np.repeat(np.arange(num_classes), num_per_class)

    angles = rads[labels] + rate * np.exp(features[:, 0])
    rotations = np.stack(
        [
            np.stack([np.cos(angles), -np.sin(angles)], axis=-1),
            np.stack([np.sin(angles), np.cos(angles)], axis=-1),
        ],
        axis=-2,
    )
    data = np.einsum("nij,nj->ni", rotations, features)
    perm = rng.permutation(len(data))
    if return_labels:
        return 10.0 * data[perm], labels[perm]
    return 10.0 * data[perm]


def make_pinwheel_with_outliers(
    outlier_fraction: float = 0.1,
    outlier_scale: float = 15.0,
    num_classes: int = 5,
    num_per_class: int = 100,
    seed: int = 0,
):
    """Pinwheel plus a uniform-box outlier contamination (robustness demo).

    Returns (data, labels) where outliers carry label −1.
    """
    rng = np.random.default_rng(seed + 1000)
    clean, labels = make_pinwheel_data(
        num_classes=num_classes, num_per_class=num_per_class, seed=seed,
        return_labels=True,
    )
    n_out = int(round(len(clean) * outlier_fraction))
    outliers = rng.uniform(-outlier_scale, outlier_scale, size=(n_out, 2))
    data = np.concatenate([clean, outliers], axis=0)
    labels = np.concatenate([labels, -np.ones(n_out, dtype=labels.dtype)])
    perm = rng.permutation(len(data))
    return data[perm], labels[perm]


def load_pinwheel(
    num_classes: int = 5,
    num_per_class: int = 100,
    seed: int = 0,
    test_fraction: float = 0.2,
    return_labels: bool = False,
):
    """Train/test split of a standard pinwheel draw.

    With ``return_labels=True`` returns (train, test, train_labels,
    test_labels).
    """
    data, labels = make_pinwheel_data(
        num_classes=num_classes,
        num_per_class=num_per_class,
        seed=seed,
        return_labels=True,
    )
    n_test = int(len(data) * test_fraction)
    if return_labels:
        return data[n_test:], data[:n_test], labels[n_test:], labels[:n_test]
    return data[n_test:], data[:n_test]
