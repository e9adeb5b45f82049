"""The port's pinwheel and MNIST copies are bit-equal to svax.data's, and
the port's import graph never reaches JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svax.data import mnist as ref_mnist
from svax.data import pinwheel as ref
from svax_torch.data import load_dataset
from svax_torch.data import mnist as port_mnist
from svax_torch.data import pinwheel as port

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_pinwheel_bit_equal(seed):
    a, la = port.make_pinwheel_data(seed=seed, return_labels=True)
    b, lb = ref.make_pinwheel_data(seed=seed, return_labels=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(
        port.make_pinwheel_data(num_classes=3, num_per_class=24, rate=0.4, seed=seed),
        ref.make_pinwheel_data(num_classes=3, num_per_class=24, rate=0.4, seed=seed),
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_load_pinwheel_bit_equal(seed):
    for got, want in zip(port.load_pinwheel(seed=seed, return_labels=True),
                         ref.load_pinwheel(seed=seed, return_labels=True)):
        np.testing.assert_array_equal(got, want)
    train, test = port.load_pinwheel(seed=seed)
    assert train.shape == (400, 2) and test.shape == (100, 2)


@pytest.mark.parametrize("seed", [0, 2])
def test_load_mnist_bit_equal(seed, monkeypatch, tmp_path):
    """The seeded surrogate (no MNIST files under the search path), with
    max_train and return_labels; load_dataset routes to it."""
    monkeypatch.setenv("SVAX_DATA_DIR", str(tmp_path))  # an empty directory
    got = port_mnist.load_mnist(seed=seed, max_train=700, return_labels=True)
    want = ref_mnist.load_mnist(seed=seed, max_train=700, return_labels=True)
    assert got[2] == want[2] == {"likelihood": "bernoulli", "synthetic": True}
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (700, 784) and got[1].shape == (1000, 784)
    assert got[3].shape == (700,) and got[4].shape == (1000,)
    full = port_mnist.load_mnist(seed=seed)
    for a, b in zip(full[:2], ref_mnist.load_mnist(seed=seed)[:2]):
        np.testing.assert_array_equal(a, b)
    assert full[0].shape == (6000, 784) and set(np.unique(full[0])) == {0.0, 1.0}
    train, test, meta = load_dataset("mnist", seed=seed)
    np.testing.assert_array_equal(train, full[0])
    assert meta["synthetic"] is True


def test_load_mnist_reads_idx_files(monkeypatch, tmp_path):
    """Raw idx files under $SVAX_DATA_DIR are read as the original reads
    them (a tiny hand-made pair, with labels)."""
    rng = np.random.default_rng(4)

    def write_idx(name, arr):
        head = bytes([0, 0, 0x08, arr.ndim]) + b"".join(
            int(v).to_bytes(4, "big") for v in arr.shape)
        (tmp_path / name).write_bytes(head + arr.astype(np.uint8).tobytes())

    write_idx("train-images-idx3-ubyte", rng.integers(0, 256, (6, 28, 28)))
    write_idx("t10k-images-idx3-ubyte", rng.integers(0, 256, (3, 28, 28)))
    write_idx("train-labels-idx1-ubyte", rng.integers(0, 10, (6,)))
    write_idx("t10k-labels-idx1-ubyte", rng.integers(0, 10, (3,)))
    monkeypatch.setenv("SVAX_DATA_DIR", str(tmp_path))
    got = port_mnist.load_mnist(seed=1, return_labels=True)
    want = ref_mnist.load_mnist(seed=1, return_labels=True)
    assert got[2]["synthetic"] is False and want[2]["synthetic"] is False
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        np.testing.assert_array_equal(a, b)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import svax_torch, svax_torch.train_svae, svax_torch.ops.tinystep\n"
        "import svax_torch.convert, svax_torch.train.loop\n"
        "import svax_torch.train_gmm, svax_torch.train_smm, svax_torch.ops.mixstep\n"
        "import svax_torch.ops.estep, svax_torch.models.evaluation, svax_torch.pgm.init\n"
        "import svax_torch.ops.combine, svax_torch.train.warmup, svax_torch.data.mnist\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'svax' or m.startswith('svax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
