"""MNIST loader, local files only — a numpy copy of ``svax/data/mnist.py``.

``import svax.data`` imports JAX through ``svax/__init__.py``, so the port
keeps its own copy; tests/test_torch_data.py pins it bit-equal to the
original on the surrogate.

The loader looks for MNIST in the standard offline formats — ``mnist.npz``
(keras layout) or the raw ``*-idx3-ubyte``/``*-idx1-ubyte`` files
(optionally ``.gz``) — under ``$SVAX_DATA_DIR``, ``<repo>/data/``,
``./data/`` or ``~/.keras/datasets``, the original's search path in its
order; nothing is fetched. Absent those, it generates a seeded *synthetic
surrogate*: 10 random 28×28 prototype patterns with Bernoulli pixel noise,
binarized — same shapes, same likelihood head, flagged via
``meta["synthetic"]``.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np


def _candidate_dirs() -> list[Path]:
    dirs = []
    env = os.environ.get("SVAX_DATA_DIR")
    if env:
        dirs.append(Path(env))
    dirs.append(Path(__file__).resolve().parents[2] / "data")
    dirs.append(Path.cwd() / "data")
    dirs.append(Path.home() / ".keras" / "datasets")
    return dirs


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">H", f.read(2) or b"\x00\x00")
        # idx magic: 0x0000 then dtype byte then ndim byte
        dtype_byte, ndim = struct.unpack(">BB", f.read(2))
        if magic != 0 or dtype_byte != 0x08:
            raise ValueError(f"unsupported idx file {path}")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_real_mnist():
    """(x_train, x_test, y_train, y_test) — labels None when absent."""
    for directory in _candidate_dirs():
        npz = directory / "mnist.npz"
        if npz.exists():
            with np.load(npz) as z:
                y_tr = z["y_train"] if "y_train" in z.files else None
                y_te = z["y_test"] if "y_test" in z.files else None
                return z["x_train"], z["x_test"], y_tr, y_te
        for suffix in ("", ".gz"):
            tr = directory / f"train-images-idx3-ubyte{suffix}"
            te = directory / f"t10k-images-idx3-ubyte{suffix}"
            if tr.exists() and te.exists():
                y_tr = y_te = None
                trl = directory / f"train-labels-idx1-ubyte{suffix}"
                tel = directory / f"t10k-labels-idx1-ubyte{suffix}"
                if trl.exists() and tel.exists():
                    y_tr, y_te = _read_idx(trl), _read_idx(tel)
                return _read_idx(tr), _read_idx(te), y_tr, y_te
    return None


def _synthetic_surrogate(n_train: int = 6000, n_test: int = 1000, seed: int = 11):
    """10 seeded prototype patterns + Bernoulli pixel noise, 28×28."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(size=(10, 28, 28)) < 0.25
    # Smooth prototypes into blobby strokes so classes are learnable.
    kernel = np.ones((3, 3)) / 9.0
    smooth = np.stack([
        np.clip(
            sum(np.roll(np.roll(p.astype(float), i, 0), j, 1) * kernel[i + 1, j + 1]
                for i in (-1, 0, 1) for j in (-1, 0, 1)),
            0, 1,
        )
        for p in protos
    ])
    smooth = (smooth > 0.2).astype(float) * 0.85 + 0.05

    def draw(n):
        labels = rng.integers(0, 10, size=n)
        probs = smooth[labels]
        imgs = (rng.uniform(size=probs.shape) < probs).astype(np.uint8) * 255
        return imgs, labels

    (x_tr, y_tr), (x_te, y_te) = draw(n_train), draw(n_test)
    return x_tr, x_te, y_tr, y_te


def load_mnist(seed: int = 0, binarize: bool = True, max_train: int | None = None,
               return_labels: bool = False):
    """Flattened (N, 784) arrays in [0,1] (binarized by default) + meta.

    With ``return_labels=True`` returns (x_train, x_test, meta, y_train,
    y_test) for cluster-purity evaluation; label arrays are None when a
    real image file is found without its label file.
    """
    real = _find_real_mnist()
    if real is not None:
        x_train, x_test, y_train, y_test = real
        synthetic = False
    else:
        x_train, x_test, y_train, y_test = _synthetic_surrogate(seed=seed + 11)
        synthetic = True
    x_train = x_train.reshape(len(x_train), -1).astype(np.float64) / 255.0
    x_test = x_test.reshape(len(x_test), -1).astype(np.float64) / 255.0
    if binarize:
        rng = np.random.default_rng(seed)
        x_train = (x_train > rng.uniform(size=x_train.shape)).astype(np.float64)
        x_test = (x_test > 0.5).astype(np.float64)
    if max_train is not None:
        x_train = x_train[:max_train]
        if y_train is not None:
            y_train = y_train[:max_train]
    meta = {"likelihood": "bernoulli", "synthetic": synthetic}
    if return_labels:
        return x_train, x_test, meta, y_train, y_test
    return x_train, x_test, meta
