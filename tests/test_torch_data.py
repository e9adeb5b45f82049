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


def test_port_imports_no_jax(tmp_path):
    """Importing every module of the port (``pkgutil.walk_packages``) and
    running its entries (two CPU steps of pinwheel-svae, with and without
    the SMM prior, of the GMM mixture, and of two demos) loads neither jax,
    svax, the reference's experiments nor its configs."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import svax_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(svax_torch.__path__, 'svax_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) > 70, names\n"
        "from svax_torch import anomaly_demo, latent_contamination_demo, train_gmm, train_svae\n"
        "for extra in ([], ['--smm-dof', '4']):\n"
        "    train_svae.main(['--device', 'cpu', '--steps', '2', '--iw-samples', '2', *extra])\n"
        "train_gmm.main(['--config', 'pinwheel-gmm', '--device', 'cpu', '--steps', '2'])\n"
        "anomaly_demo.main(['--device', 'cpu', '--steps', '2', '--iw-samples', '2'])\n"
        "latent_contamination_demo.main(['--device', 'cpu', '--pretrain-steps', '2',"
        " '--scan-chunk', '2', '--online-steps', '2', '--batch', '20', '--iw-samples', '2',"
        f" '--json', {str(tmp_path / 'lc_torch.json')!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'svax', 'configs', 'experiments'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_mnist_search_path_matches_the_reference(env_dir, monkeypatch, tmp_path):
    """The port looks for MNIST where the original does, in its order:
    $SVAX_DATA_DIR, <repo>/data, ./data, ~/.keras/datasets."""
    if env_dir is None:
        monkeypatch.delenv("SVAX_DATA_DIR", raising=False)
    else:
        monkeypatch.setenv("SVAX_DATA_DIR", str(tmp_path))
    got = port_mnist._candidate_dirs()
    assert got == ref_mnist._candidate_dirs()
    assert got[-1] == Path.home() / ".keras" / "datasets"
    assert len(got) == (3 if env_dir is None else 4)


@pytest.mark.parametrize("name", ["pinwheel-svae", "pinwheel-gmm", "auto-svae",
                                  "mnist-svae", "bigk-dp"])
def test_port_configs_equal_the_reference(name):
    """svax_torch.configs carries the reference's entries for the configs
    the port runs, unchanged."""
    import configs as ref_configs

    from svax_torch import configs

    assert configs.CONFIGS[name] == ref_configs.CONFIGS[name]


def test_apply_config_matches_the_reference():
    """Explicit flags win over the config, as configs.apply_config does."""
    import argparse

    import configs as ref_configs

    from svax_torch import configs

    def parse(mod, argv):
        p = argparse.ArgumentParser()
        p.add_argument("--config", default="")
        p.add_argument("--steps", type=int, default=7)
        p.add_argument("--rho", type=float, default=0.5)
        p.add_argument("--aug-noise", type=float, default=0.0)
        args = p.parse_args(argv)
        mod.apply_config(args, p, argv)
        return vars(args)

    for argv in (["--config", "pinwheel-svae"], ["--config", "pinwheel-svae", "--steps", "3"],
                 ["--steps", "3"], ["--config", "auto-svae", "--rho", "0.9"]):
        assert parse(configs, argv) == parse(ref_configs, argv), argv
