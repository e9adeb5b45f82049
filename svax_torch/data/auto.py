"""UCI Auto (MPG) dataset — a numpy copy of ``svax/data/auto.py``.

``import svax.data`` imports JAX through ``svax/__init__.py``, so the port
keeps its own copy; tests/test_torch_auto.py pins it bit-equal to the
original, on the surrogate and on a UCI-format file.

The loader reads the standard ``auto-mpg.data`` UCI file from a local path
(``$SVAX_DATA_DIR`` or ``<repo>/data/``). When the file is absent it falls
back to a clearly-flagged synthetic surrogate with the same shape and
standardization (a seeded full-covariance GMM in feature space);
``meta["synthetic"]`` records which path was taken.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

_FILENAMES = ("auto-mpg.data", "auto-mpg.csv", "auto.data")


def _candidate_dirs() -> list[Path]:
    dirs = []
    env = os.environ.get("SVAX_DATA_DIR")
    if env:
        dirs.append(Path(env))
    dirs.append(Path(__file__).resolve().parents[2] / "data")
    dirs.append(Path.cwd() / "data")
    return dirs


def _parse_uci_file(path: Path) -> np.ndarray:
    """Parse the UCI auto-mpg format: 8 numeric fields then the car name.

    Rows with missing horsepower ('?') are dropped, as is conventional.
    """
    rows = []
    for line in path.read_text().splitlines():
        if not line.strip():
            continue
        fields = line.split()
        numeric = fields[:8]
        if "?" in numeric:
            continue
        rows.append([float(v) for v in numeric])
    return np.asarray(rows, dtype=np.float64)


def _synthetic_surrogate(num_rows: int = 392, dim: int = 8, seed: int = 7) -> np.ndarray:
    """Seeded 3-component full-covariance GMM surrogate (documented fallback)."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((3, dim)) * 2.0
    data = []
    for c, w in enumerate([0.45, 0.35, 0.20]):
        n_c = int(round(num_rows * w))
        a = rng.standard_normal((dim, dim)) * 0.4
        cov = a @ a.T + 0.3 * np.eye(dim)
        data.append(rng.multivariate_normal(means[c], cov, size=n_c))
    x = np.concatenate(data, axis=0)
    return x[rng.permutation(len(x))]


def load_auto(
    seed: int = 0, test_fraction: float = 0.1
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Standardized train/test arrays + meta. Gaussian likelihood."""
    source = None
    for directory in _candidate_dirs():
        for name in _FILENAMES:
            path = directory / name
            if path.exists():
                source = path
                break
        if source:
            break
    if source is not None:
        x = _parse_uci_file(source)
        synthetic = False
    else:
        x = _synthetic_surrogate()
        synthetic = True

    x = (x - x.mean(0)) / (x.std(0) + 1e-8)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    x = x[perm]
    n_test = max(1, int(len(x) * test_fraction))
    meta = {
        "likelihood": "gaussian",
        "synthetic": synthetic,
        "source": str(source) if source else "surrogate-gmm",
    }
    return x[n_test:], x[:n_test], meta
